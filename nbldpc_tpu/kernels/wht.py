"""Fast Walsh–Hadamard transform along the GF(q) axis (pure-XLA path).

The QSPA check-node update is a convolution over the group (GF(2^p), +) =
(Z_2)^p, which diagonalizes under the Walsh–Hadamard transform:
    WHT(x *xor* y) = WHT(x) . WHT(y)
with H[a, b] = (-1)^popcount(a & b). The butterfly below computes exactly
this H in p stages of shape-static reshapes — XLA fuses it into a handful of
vector adds (SURVEY.md C8 "FFT/Hadamard-domain check-node convolution").

W(W(x)) = q * x (involution up to scale); tests/test_wht.py checks both
properties against a dense numpy H.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp


def wht(x: jnp.ndarray) -> jnp.ndarray:
    """Unnormalized WHT along the last axis (length q = 2^p, static)."""
    q = x.shape[-1]
    p = q.bit_length() - 1
    assert 1 << p == q, "q must be a power of two"
    shape = x.shape
    for i in range(p):
        h = 1 << i
        y = x.reshape(shape[:-1] + (q // (2 * h), 2, h))
        a = y[..., 0, :]
        b = y[..., 1, :]
        x = jnp.stack([a + b, a - b], axis=-2).reshape(shape)
    return x


def iwht(x: jnp.ndarray) -> jnp.ndarray:
    """Inverse WHT: wht(x) / q."""
    return wht(x) / x.shape[-1]


def wht_axis(x: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Unnormalized WHT along `axis` (length q = 2^p, static).

    Same butterfly as `wht`, with trailing axes kept intact — used by the
    batch-last decode path where messages are [..., q, B] and the last axis
    stays the Monte-Carlo batch.
    """
    axis = axis % x.ndim
    if axis == x.ndim - 1:
        return wht(x)
    q = x.shape[axis]
    p = q.bit_length() - 1
    assert 1 << p == q, "q must be a power of two"
    shape = x.shape
    lead, tail = shape[:axis], shape[axis + 1 :]
    sel = (slice(None),) * (len(lead) + 1)  # lead dims + the q//2h dim
    for i in range(p):
        h = 1 << i
        y = x.reshape(lead + (q // (2 * h), 2, h) + tail)
        a = y[sel + (0,)]
        b = y[sel + (1,)]
        x = jnp.stack([a + b, a - b], axis=len(lead) + 1).reshape(shape)
    return x


def wht_matrix(q: int) -> np.ndarray:
    """Dense [q, q] Hadamard matrix H[a,b] = (-1)^popcount(a & b) (for tests)."""
    a = np.arange(q)
    pc = np.zeros((q, q), dtype=np.int64)
    ab = a[:, None] & a[None, :]
    for bit in range(q.bit_length() - 1):
        pc += (ab >> bit) & 1
    return np.where(pc % 2 == 0, 1.0, -1.0)
