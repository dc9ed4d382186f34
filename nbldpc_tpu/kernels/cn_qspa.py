"""Fused QSPA check-node update for NVIDIA GPUs (Pallas, Triton route).

Same function as decoders/qspa.py::qspa_cn_update_bl — softmax over q ->
WHT -> leave-one-out sign/log-magnitude product over the check's dc slots ->
inverse WHT -> floor -> log -> renormalize — in ONE kernel, so each
iteration reads the message tensor U once and writes Chat once instead of
round-tripping intermediates through HBM between XLA's reductions.

Layout: batch-last U [M, dc, q, B] (graph.gather_cn_x_bl). Pad CN slots
arrive as log-delta0, whose spectrum is all-ones and contributes exactly 0
to the leave-one-out log-sum, so the kernel is maskless.

One program per (check, frame tile of TB frames; frame_tile). Each dc slot is a
[q, TB] tile with the frames contiguous (coalesced loads). The program
makes two passes over its slots: the first accumulates the leave-one-out
log-sum and sign product, the second recomputes each slot's spectrum from
U (an L2 hit) instead of holding dc spectra in registers, which would
spill at large q.

The WHT is a dot with the [r, r] Hadamard matrix: for q = r it is one
[r, r] x [r, TB] product; for q = r*r (GF(256), r = 16) it is the
Kronecker form H_q = H_r (x) H_r — a product over the high index, a
transpose, a product over the low index. The spectrum then comes out with
its two index halves swapped; every spectral-domain step is elementwise or
a reduction over dc, and the inverse transform undoes the swap, so the
result is in natural order. The dots run at Precision.HIGHEST (IEEE f32):
a TF32 Hadamard product loses the spectra's low bits, and reduced-precision
spectra cost FER (see PERF.md).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from nbldpc_tpu.kernels.wht import wht_matrix

# Must match decoders/qspa.py so the kernel and the XLA path agree.
PROB_FLOOR = 1e-12
MAG_TINY = 1e-30

# Hadamard factor r for each supported q: one dot (q = r) or the Kronecker
# pair (q = r*r). Triton's dot needs every dimension >= 16, so GF(4)/GF(8)
# stay on the XLA update.
_WHT_FACTOR = {16: 16, 32: 32, 64: 64, 256: 16}


def supports(q: int) -> bool:
    """True when the kernel handles GF(q)."""
    return q in _WHT_FACTOR


def frame_tile(q: int, batch: int) -> int:
    """Frames per program: the largest power of two TB >= 16 that divides
    the batch with a [q, TB] tile of at most 1024 elements (TB = 64 at
    GF(16)), else 16; 0 if no tile divides the batch.

    Measured on an H100 (PERF.md): at GF(16) B=4096 a 64-frame tile
    decodes in 29.6 ms where 128 frames take 45.0 ms; at GF(256) B=512
    a 32-frame tile is no faster than 16."""
    tb = max(16, 1024 // q)
    while tb >= 16:
        if batch % tb == 0:
            return tb
        tb //= 2
    return 0


def _wht(x, h, q: int, r: int):
    """Unnormalized WHT of a [q, TB] tile along q (see module docstring)."""
    dot = functools.partial(jnp.dot, precision=jax.lax.Precision.HIGHEST,
                            preferred_element_type=jnp.float32)
    if q == r:
        return dot(h, x)
    tb = x.shape[1]
    y = dot(h, x.reshape(r, r * tb))                 # over the high index
    y = jnp.transpose(y.reshape(r, r, tb), (1, 0, 2))
    return dot(h, y.reshape(r, r * tb)).reshape(q, tb)   # over the low index


def _kernel(u_ref, h_ref, o_ref, *, dc: int, q: int, r: int):
    h = h_ref[...]

    def spectrum(j):
        u = u_ref[j]                                 # [q, TB]
        e = jnp.exp(u - jnp.max(u, axis=0, keepdims=True))
        return _wht(e / jnp.sum(e, axis=0, keepdims=True), h, q, r)

    lsum = None
    neg = None                                       # parity of minus signs
    for j in range(dc):
        f = spectrum(j)
        lm = jnp.log(jnp.abs(f) + MAG_TINY)
        nj = (f < 0).astype(jnp.int32)
        lsum = lm if lsum is None else lsum + lm
        neg = nj if neg is None else neg ^ nj
    for j in range(dc):
        f = spectrum(j)
        lm = jnp.log(jnp.abs(f) + MAG_TINY)
        s = jnp.where((neg ^ (f < 0).astype(jnp.int32)) != 0, -1.0, 1.0)
        g = s * jnp.exp(lsum - lm)                   # leave-one-out product
        qv = jnp.maximum(_wht(g, h, q, r) / q, PROB_FLOOR)
        c = jnp.log(qv)
        o_ref[j] = c - jnp.max(c, axis=0, keepdims=True)


@functools.partial(jax.jit, static_argnames=("interpret",))
def cn_update(U: jnp.ndarray, interpret: bool = False) -> jnp.ndarray:
    """Fused CN update. U [M, dc, q, B] f32 log-domain x-domain -> same.

    Requires supports(q) and frame_tile(q, B) > 0 (qspa.cn_update_bl_for
    checks both)."""
    M, dc, q, B = U.shape
    tb = frame_tile(q, B)
    if not tb:
        raise ValueError(f"no frame tile divides batch {B}")
    r = _WHT_FACTOR[q]
    h = jnp.asarray(wht_matrix(r), jnp.float32)
    spec = pl.BlockSpec((None, dc, q, tb), lambda i, j: (i, 0, 0, j))
    return pl.pallas_call(
        functools.partial(_kernel, dc=dc, q=q, r=r),
        out_shape=jax.ShapeDtypeStruct(U.shape, U.dtype),
        grid=(M, B // tb),
        in_specs=[spec, pl.BlockSpec((r, r), lambda i, j: (0, 0))],
        out_specs=spec,
        # 8 warps at GF(256): measured equal to XLA there, 4 warps 2% slower
        compiler_params=pltriton.CompilerParams(
            num_warps=8 if q > 64 else 4, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="qspa_cn_update",
    )(U, h)
