"""QSPA: q-ary sum-product decoder with Hadamard-domain check-node update.

SURVEY.md C8 / §3.2: the CN update is a circular convolution over
(GF(2^p), +), computed in the Walsh–Hadamard domain:

    permute by edge weight -> softmax to prob domain -> WHT ->
    leave-one-out product over the check's dc edges -> inverse WHT ->
    clip -> log -> inverse permute

Numerics (SURVEY.md §7 hard part 2): the WHT needs prob-domain inputs but
raw products underflow over 50 iterations, so the leave-one-out product is
done in sign/log-magnitude form: per-edge WHT spectra F satisfy |F| <= 1
(F of a normalized pmf), the product over dc-1 edges is
exp(sum log|F| - log|F_e|) with an XOR-style sign product. Messages stay
log-domain between phases; each phase renormalizes.

The XLA path below is the semantic reference; kernels/cn_qspa.py holds the
fused GPU kernel with the same semantics.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from nbldpc_tpu.decoders import common
from nbldpc_tpu.graph import TannerGraph
from nbldpc_tpu.kernels.wht import wht, wht_axis

# Floor for prob-domain extrinsics before re-entering log domain. Shared with
# the numpy oracle (tests/reference_model.py) so hard decisions match.
PROB_FLOOR = 1e-12
MAG_TINY = 1e-30


def qspa_cn_update(U: jnp.ndarray, graph: TannerGraph) -> jnp.ndarray:
    """Check-node update, x-domain in and out: [B, M, dc_max, q] log-domain.

    The GF weight permutations live in the routing gathers (graph.gather_*_x),
    so this update is pure elementwise/WHT/reduction — no gathers.
    """
    q = graph.q
    P = jax.nn.softmax(U, axis=-1)                  # prob domain, sums to 1
    # Padding slots must be the convolution identity: delta at symbol 0
    # (WHT(delta_0) = all-ones -> multiplicative identity).
    delta0 = jnp.zeros((q,), P.dtype).at[0].set(1.0)
    P = jnp.where(graph.cn_mask[None, :, :, None], P, delta0)
    F = wht(P)                                      # [B, M, dc, q], |F| <= 1
    sign = jnp.where(F < 0, -1.0, 1.0).astype(P.dtype)
    logmag = jnp.log(jnp.abs(F) + MAG_TINY)
    # leave-one-out across the dc axis
    lsum = jnp.sum(logmag, axis=2, keepdims=True)
    ssum = jnp.prod(sign, axis=2, keepdims=True)
    G = (ssum * sign) * jnp.exp(lsum - logmag)      # sign^2 = 1 removes self
    Q = wht(G) / q                                  # inverse WHT
    Q = jnp.maximum(Q, PROB_FLOOR)
    Chat = jnp.log(Q)
    Chat = Chat - jnp.max(Chat, axis=-1, keepdims=True)
    return jnp.where(graph.cn_mask[None, :, :, None], Chat, 0.0)


def qspa_cn_update_bl(U: jnp.ndarray, graph: TannerGraph) -> jnp.ndarray:
    """Batch-last CN update: U [M, dc_max, q, B] log-domain x-domain.

    q on axis 2, frame batch last (axis 3).
    Identical math to qspa_cn_update — but maskless: pad CN slots arrive as
    log-delta0 (graph.gather_cn_x_bl), whose spectrum is all-ones and
    contributes exactly 0 to the leave-one-out log-sum, and pad OUTPUT values
    are never read (the VN gather routes only real slots). Pure
    elementwise + WHT + dc-reduction — the contract of kernels/cn_qspa.py.
    """
    q = graph.q
    P = jax.nn.softmax(U, axis=2)
    F = wht_axis(P, axis=2)                                # [M, dc, q, B]
    sign = jnp.where(F < 0, -1.0, 1.0).astype(P.dtype)
    logmag = jnp.log(jnp.abs(F) + MAG_TINY)
    lsum = jnp.sum(logmag, axis=1, keepdims=True)          # over dc
    ssum = jnp.prod(sign, axis=1, keepdims=True)
    G = (ssum * sign) * jnp.exp(lsum - logmag)
    Q = wht_axis(G, axis=2) / q
    Q = jnp.maximum(Q, PROB_FLOOR)
    Chat = jnp.log(Q)
    return Chat - jnp.max(Chat, axis=2, keepdims=True)


def cn_update_bl_for(graph: TannerGraph, batch: int):
    """The batch-last CN update for the default backend: the fused Pallas
    kernel (kernels/cn_qspa.py) on a GPU when it handles GF(q) and a frame
    tile divides the batch, the XLA update everywhere else."""
    from nbldpc_tpu.kernels import cn_qspa

    if (jax.default_backend() == "gpu" and cn_qspa.supports(graph.q)
            and cn_qspa.frame_tile(graph.q, batch)):
        return lambda U, _graph: cn_qspa.cn_update(U)
    return qspa_cn_update_bl


def decode(
    graph: TannerGraph,
    llr: jnp.ndarray,
    max_iters: int = 20,
    early_term: bool = True,
    batch_last: bool = True,
    stats_each_iter: bool = True,
) -> common.DecodeResult:
    """QSPA decode of a batch: llr [B, N, q] -> DecodeResult.

    batch_last=True runs the [.., q, B] layout of common.decode_bl with the
    backend's CN update (cn_update_bl_for); batch_last=False runs the
    q-last reference loop. Both implement the same BP update equations.
    """
    if batch_last:
        cn = cn_update_bl_for(graph, llr.shape[0])
        return common.decode_bl(graph, llr, cn, max_iters, early_term,
                                stats_each_iter=stats_each_iter)
    return common.decode(graph, llr, qspa_cn_update, max_iters, early_term)
