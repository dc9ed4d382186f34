"""GF(2^p) arithmetic as precomputed tables.

Design (SURVEY.md §2.1 C1): on device, field math never executes —
all GF(q) multiplication/division in the decode loop is precompiled into
int32 *permutation tables* that become XLA gathers. This module builds the
tables once on host (numpy) and exposes them as jnp arrays.

Supported fields: GF(2^p) for p = 1..8 (q = 2..256). Addition is XOR.
Multiplication uses exp/log (Zech) tables over a primitive polynomial.

Reference parity: replaces the C++ reference's gf_mul/gf_add/gf_inv + table
init (SURVEY.md L1 layer; reference unavailable — spec from BASELINE.json
north-star: "GF(q) symbol mapping").
"""

from __future__ import annotations

import functools

import numpy as np

# Primitive polynomials for GF(2^p), LSB-first bitmask including the x^p term.
# e.g. GF(16): x^4 + x + 1 -> 0b10011. All verified primitive (full-order
# generator) in tests/test_gf.py.
PRIM_POLY = {
    2: 0b11,          # x + 1
    4: 0b111,         # x^2 + x + 1
    8: 0b1011,        # x^3 + x + 1
    16: 0b10011,      # x^4 + x + 1
    32: 0b100101,     # x^5 + x^2 + 1
    64: 0b1000011,    # x^6 + x + 1
    128: 0b10001001,  # x^7 + x^3 + 1
    256: 0b100011101, # x^8 + x^4 + x^3 + x^2 + 1 (0x11D)
}


class GF:
    """Tables for one field GF(q), q = 2^p.

    Host-side numpy tables; `.device()` returns a dict of jnp arrays for use
    inside jitted code (gathers only).

    Attributes
    ----------
    q : field order (2^p)
    p : extension degree (bits per symbol)
    exp : np.ndarray [2*(q-1)] — alpha^i (doubled to avoid mod in lookups)
    log : np.ndarray [q] — discrete log; log[0] is a sentinel (unused)
    mul : np.ndarray [q, q] — full multiplication table
    inv : np.ndarray [q] — multiplicative inverse; inv[0] = 0 sentinel
    bits : np.ndarray [q, p] — binary image of each symbol (LSB first)
    """

    def __init__(self, q: int):
        if q not in PRIM_POLY:
            raise ValueError(f"q={q} unsupported; need a power of two in 2..256")
        self.q = q
        self.p = q.bit_length() - 1
        poly = PRIM_POLY[q]

        # exp/log via LFSR: alpha^0 .. alpha^(q-2)
        exp = np.zeros(2 * (q - 1), dtype=np.int32)
        log = np.zeros(q, dtype=np.int32)
        x = 1
        for i in range(q - 1):
            exp[i] = x
            log[x] = i
            x <<= 1
            if x & q:
                x ^= poly
        if x != 1:  # LFSR must return to 1 iff poly is primitive
            raise ValueError(f"polynomial {poly:#b} is not primitive for q={q}")
        exp[q - 1:] = exp[: q - 1]
        self.exp = exp
        self.log = log

        # full q x q multiplication table (q <= 256 -> at most 64 KiB of int32)
        a = np.arange(q)
        la, lb = log[a][:, None], log[a][None, :]
        mul = exp[(la + lb) % (q - 1)].copy()
        mul[0, :] = 0
        mul[:, 0] = 0
        self.mul = mul.astype(np.int32)

        inv = np.zeros(q, dtype=np.int32)
        inv[1:] = exp[(q - 1 - log[1:q]) % (q - 1)]
        self.inv = inv

        # binary image: symbol -> p bits, LSB first (polynomial basis coeffs)
        self.bits = ((a[:, None] >> np.arange(self.p)[None, :]) & 1).astype(np.int32)

        # XOR (addition) table is implicit: a ^ b.

    # ---- host-side scalar/array ops (used by encoder GE, codegen, oracle) ----

    def gmul(self, a, b):
        """Elementwise GF multiply of integer arrays/scalars."""
        a = np.asarray(a, dtype=np.int64)
        b = np.asarray(b, dtype=np.int64)
        return self.mul[a, b]

    def gdiv(self, a, b):
        return self.mul[np.asarray(a, dtype=np.int64), self.inv[np.asarray(b, dtype=np.int64)]]

    def ginv(self, a):
        return self.inv[np.asarray(a, dtype=np.int64)]

    def matmul(self, A, B):
        """GF matrix product: (A @ B) with + = XOR, * = field mul. Host-side."""
        A = np.asarray(A, dtype=np.int64)
        B = np.asarray(B, dtype=np.int64)
        out = np.zeros((A.shape[0], B.shape[1]), dtype=np.int64)
        for k in range(A.shape[1]):
            out ^= self.mul[A[:, k][:, None], B[k, :][None, :]]
        return out.astype(np.int32)

    def matvec(self, A, x):
        return self.matmul(A, np.asarray(x).reshape(-1, 1)).ravel()

    # ---- device tables ----

    def device(self):
        """jnp versions of the tables (int32), for use inside jit."""
        import jax.numpy as jnp

        return {
            "mul": jnp.asarray(self.mul),
            "inv": jnp.asarray(self.inv),
            "bits": jnp.asarray(self.bits),
        }


@functools.lru_cache(maxsize=None)
def get_field(q: int) -> GF:
    """Cached field tables (tables are immutable; safe to share)."""
    return GF(q)
