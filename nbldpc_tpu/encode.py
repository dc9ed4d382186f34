"""Systematic encoder over GF(q).

Design (SURVEY.md §2.1 C4): Gaussian elimination runs ONCE on host
(numpy over the GF tables — a Python stand-in is idiomatic for one-time
setup); the per-frame encode is a device computation of
    parity[j] = XOR_k mul[info[k], P[k, j]]
expressed as table gathers + an XOR reduction inside jit. For symmetric-channel
throughput runs the all-zero-codeword shortcut in sim.py bypasses this.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from nbldpc_tpu.code import CodeSpec
from nbldpc_tpu.gf import GF, get_field


def gf_row_reduce(H: np.ndarray, gf: GF):
    """Row-reduce H over GF(q) with column pivoting.

    Returns (R, rank, pivot_cols): R is the reduced matrix (rows scaled so
    pivots are 1, eliminated above and below), pivot_cols the pivot column of
    each of the first `rank` rows.
    """
    # Native C++ path (same pivoting order; tests/test_native.py pins
    # equality). Falls back to the numpy loop below when unavailable.
    from nbldpc_tpu import native

    if native.available():
        out = native.gf_row_reduce(np.asarray(H), gf.q, gf.mul, gf.inv)
        if out is not None:
            return out

    R = np.asarray(H, dtype=np.int64).copy()
    m, n = R.shape
    pivot_cols = []
    r = 0
    for c in range(n):
        if r == m:
            break
        nz = np.nonzero(R[r:, c])[0]
        if len(nz) == 0:
            continue
        pr = r + int(nz[0])
        if pr != r:
            R[[r, pr]] = R[[pr, r]]
        # scale row r so pivot = 1
        R[r] = gf.gmul(R[r], gf.ginv(R[r, c]))
        # eliminate all other rows
        rows = np.nonzero(R[:, c])[0]
        rows = rows[rows != r]
        if len(rows):
            R[rows] ^= gf.gmul(R[rows, c][:, None], R[r][None, :])
        pivot_cols.append(c)
        r += 1
    return R.astype(np.int32), r, np.array(pivot_cols, dtype=np.int32)


class Encoder:
    """Systematic GF(q) encoder derived from H by one-time host GE.

    Column permutation puts pivot columns last, so the codeword is
    c_perm = [u | parity] in the permuted order; `self.col_perm` maps permuted
    position -> original position (c_original[col_perm] = c_perm).

    encode(): device fn, info [B, K] int32 -> codeword [B, N] int32 in the
    ORIGINAL column order, satisfying H @ c = 0 over GF(q).
    """

    def __init__(self, spec: CodeSpec):
        gf = get_field(spec.q)
        self.spec = spec
        self.gf = gf
        H = spec.dense_h()
        R, rank, piv = gf_row_reduce(H, gf)
        if rank != spec.m:
            raise ValueError(f"H is rank-deficient ({rank} < {spec.m}); cannot encode")
        n, m, k = spec.n, spec.m, spec.n - spec.m
        info_cols = np.setdiff1d(np.arange(n), piv)
        # In reduced form: R[:, piv] = I, so parity(piv) = sum over info cols:
        #   c[piv[r]] = XOR_j mul(R[r, info_cols[j]], u[j])
        self.P = gf.gmul(np.ones((1,), np.int64), R[:m, info_cols]).astype(np.int32)  # [M, K]
        self.info_cols = info_cols.astype(np.int32)
        self.piv_cols = piv.astype(np.int32)
        self.k = k
        # device constants
        self._mul = jnp.asarray(gf.mul)
        self._P = jnp.asarray(self.P)
        self._info_cols = jnp.asarray(self.info_cols)
        self._piv_cols = jnp.asarray(self.piv_cols)

    def encode(self, info: jnp.ndarray) -> jnp.ndarray:
        """info [..., K] int32 -> codeword [..., N] int32 with H c = 0."""
        mul, P = self._mul, self._P

        def body(carry, pk):
            p_row, u_k = pk  # P[:, k] [M], info[..., k] [...]
            return carry ^ mul[u_k[..., None], p_row[None, :]].reshape(carry.shape), None

        parity0 = jnp.zeros(info.shape[:-1] + (self.spec.m,), dtype=jnp.int32)
        # scan over K info symbols; mul gather per step keeps memory at [B, M]
        parity, _ = jax.lax.scan(
            body, parity0, (P.T, jnp.moveaxis(info, -1, 0))
        )
        cw = jnp.zeros(info.shape[:-1] + (self.spec.n,), dtype=jnp.int32)
        cw = cw.at[..., self._info_cols].set(info)
        cw = cw.at[..., self._piv_cols].set(parity)
        return cw
