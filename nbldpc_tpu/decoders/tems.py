"""T-EMS: Trellis Extended Min-Sum decoder (delta-domain check-node update).

SURVEY.md C10 (algorithm family: Li/Declercq/Gunnam trellis-EMS): messages
are re-expressed relative to each edge's most reliable symbol z_j; the check
constraint reduces to finding, per output (column j, row a), the best
deviation path with at most two deviations:

    dW_j(eta) = max( m1x_j(eta),                                 # 1 deviation
                     max_{e1 ^ e2 = eta} dev(e1) + dev(e2) )     # 2 deviations
    C_j(a)    = dW_j(a ^ beta ^ z_j)        beta = XOR_i z_i  (syndrome symbol)

where m1x/m2x are the per-row best/second-best deviations over columns != j,
derived from a per-row top-3 (value, column) table; two-deviation column
collisions are fixed by substituting the second-best side (the standard
hardware-friendly approximation — identical in the numpy oracle, so golden
tests are exact).

Formulation: everything is batched over the dc axis and dense over q — no trellis
pointers, no sorts, no gathers, no data-dependent loop bodies:
  - the delta transform and the final output rotation are data-dependent XOR
    permutes done batched over dc (p conditional STATIC permutes each,
    ems._xor_perm_dyn with a broadcast shift);
  - the per-row top-3 over columns is an unrolled compare/shift cascade of
    dc static slices (ties -> lower column, = stable-sort order);
  - the two-deviation max-convolution walks e1 = 1..q-1 in GRAY-CODE order:
    each step advances the three shifted operands (m1x, m2x, c1x at
    [eta ^ e1]) by ONE single-bit static XOR permute and adds the row-e1
    scalars (static q-axis slices) — ~7 full-tensor VPU passes per step,
    O(q) steps, O(q) compile. (A fori_loop with three O(p)-stage
    data-dependent permutes per column costs dc x q steps x ~45 passes and
    compiled for minutes.)
Both the q-last [B, M, dc, q] and batch-last [M, dc, q, B] layouts share the
same stacked core.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from nbldpc_tpu.decoders import common
from nbldpc_tpu.decoders.ems import _bitrev, _iota, _xor_perm_dyn, _xor_take
from nbldpc_tpu.graph import TannerGraph

NEG = -1e30


def _two_deviation_dense(m1x, c1x, m2x, q: int, axis: int):
    """dw(eta) = max over e1 ^ e2 = eta (e1, e2 != 0) of the two-deviation
    sum, with the equal-column collision fix.

    Gray-code walk over e1: the three shifted operands x[eta ^ e1] advance
    by one single-bit static permute per step; the row-e1 side is a static
    q-axis slice. All tensors carry the dc axis (batched over columns)."""
    iota = _iota(q, m1x.ndim, axis)
    dw = jnp.full_like(m1x, NEG)
    # The three shifted operands advance by the SAME single-bit permute
    # every Gray step — stack them on a new leading axis so each step is
    # ONE permute instead of three.
    S = jnp.stack([m1x, m2x, c1x])
    saxis = axis % m1x.ndim + 1
    p = q.bit_length() - 1
    prev = 0
    for g in range(1, q):
        # bit-reversed reflected Gray walk: single-bit steps, flipping the
        # HIGHEST (cheapest-to-permute) bit most often — see ems._merge_dense
        e1 = _bitrev(g ^ (g >> 1), p)                      # != 0
        S = _xor_take(S, e1 ^ prev, q, saxis)
        prev = e1
        mp, sp, cp = S[0], S[1], S[2]
        v1 = jax.lax.index_in_dim(m1x, e1, axis, keepdims=True)
        v2 = jax.lax.index_in_dim(m2x, e1, axis, keepdims=True)
        ce = jax.lax.index_in_dim(c1x, e1, axis, keepdims=True)
        cand = jnp.where(ce == cp, jnp.maximum(v1 + sp, v2 + mp), v1 + mp)
        cand = jnp.where(iota == e1, NEG, cand)            # e2 = 0 forbidden
        dw = jnp.maximum(dw, cand)
    return dw


def _two_deviation_bubble(m1x, c1x, m2x, q: int, axis: int, n_r: int):
    """TRUNCATED two-deviation search: the
    FIRST deviation e1 is restricted to the n_r most reliable rows
    (ranked by the column-excluded one-deviation metric m1x, ties ->
    lower row index) while e2 = eta ^ e1 stays FREE — the classic
    one-sided reduced-deviation scheme (Li et al.). Every output row
    still sees n_r two-deviation candidates; since the pair metric is
    symmetric, only pairs whose BOTH endpoints fall outside the top-n_r
    are lost.

    (A cheaper both-endpoints-in-top-n_r pair enumeration was built and
    FER-validated first: it collapsed on the (576,480) code — FER 0.94
    at 4 dB where the exact scan reaches 0.0 — and was replaced by this
    scheme.)

    Per kept row: one data-dependent XOR permute (p conditional static
    permutes); the candidate row values come from the shifted stack's
    row 0 (S[eta ^ e1] at eta = 0 IS S[e1] — static slices only). The
    one-deviation term stays EXACT (dense m1x). Co-designed numpy
    oracle: tests/reference_model.py kind="tems" with n_r."""
    iota = _iota(q, m1x.ndim, axis)
    # rank rows by m1x with row 0 excluded (a zero deviation is not a
    # deviation); 2*NEG sentinel so all-NEG pad rows cannot re-select
    # row 0. The picked rows' (m1x, m2x, c1x) scalars are collected with
    # one-hot reduces during extraction.
    run = jnp.where(iota == 0, 2.0 * NEG, m1x)
    v1s, v2s, cs, idxs = [], [], [], []
    for _ in range(n_r):
        mx = jnp.max(run, axis=axis, keepdims=True)
        idx = jnp.min(jnp.where(run >= mx, iota, q), axis=axis,
                      keepdims=True).astype(jnp.int32)
        sel = iota == idx
        run = jnp.where(sel, 2.0 * NEG, run)
        v1s.append(mx)
        v2s.append(jnp.sum(jnp.where(sel, m2x, 0.0), axis=axis,
                           keepdims=True))
        cs.append(jnp.sum(jnp.where(sel, c1x, 0.0), axis=axis,
                          keepdims=True))
        idxs.append(idx)
    dw = m1x                                           # one deviation: exact
    for t in range(n_r):
        # candidates in the SHIFTED domain (indexed by e2 = eta ^ e1):
        # every operand is unshifted, so only the finished candidate row
        # needs the data-dependent XOR permute — one tensor through
        # p conditional permutes per kept row instead of the stacked
        # (m1x, m2x, c1x) triple (3x less permute traffic).
        cand = jnp.where(cs[t] == c1x,
                         jnp.maximum(v1s[t] + m2x, v2s[t] + m1x),
                         v1s[t] + m1x)
        cand = jnp.where(iota == 0, NEG, cand)         # e2 = 0 forbidden
        dw = jnp.maximum(dw, _xor_perm_dyn(cand, idxs[t], q, axis))
    return dw


def _top3_stacked(dU, dc_axis: int):
    """Per-row top-3 (value, column) over the dc axis (compare/shift cascade
    of static slices; ties keep the earlier = lower column, matching a
    stable sort). Returns (m1, c1, m2, c2, m3), each size-1 at dc_axis."""
    dc = dU.shape[dc_axis]
    first = jax.lax.index_in_dim(dU, 0, dc_axis, keepdims=True)
    m1 = jnp.full_like(first, NEG)
    m2, m3 = m1, m1
    c1 = jnp.zeros_like(first)
    c2 = c1
    for j in range(dc):
        v = jax.lax.index_in_dim(dU, j, dc_axis, keepdims=True)
        b1 = v > m1
        b2 = (v > m2) & ~b1
        b3 = (v > m3) & ~b1 & ~b2
        jf = jnp.float32(j)
        m3 = jnp.where(b1 | b2, m2, jnp.where(b3, v, m3))
        m2 = jnp.where(b1, m1, jnp.where(b2, v, m2))
        c2 = jnp.where(b1, c1, jnp.where(b2, jf, c2))
        m1 = jnp.where(b1, v, m1)
        c1 = jnp.where(b1, jf, c1)
    return m1, c1, m2, c2, m3


def _cn_tems_core(U, q: int, dc_axis: int, q_axis: int,
                  n_r: int = 0) -> jnp.ndarray:
    """Stacked T-EMS check-node core, batched over the dc axis.

    U: [..., dc at dc_axis, ..., q at q_axis, ...], log-domain x-domain,
    normalized (max over q = 0), pad slots = log-delta0 (argmax 0, NEG
    deviation rows — they never win the top-3 and add 0 to beta; pad
    OUTPUTS are never routed by the VN gather). Returns the extrinsics in
    the same stacked shape (before offset/normalize)."""
    dc = U.shape[dc_axis]
    assert dc >= 3, "T-EMS top-3 scheme needs dc_max >= 3"
    iota_q = _iota(q, U.ndim, q_axis)

    # delta domain relative to the most reliable symbol per edge (batched)
    z = jnp.argmax(U, axis=q_axis, keepdims=True).astype(jnp.int32)
    dU = _xor_perm_dyn(U, z, q, q_axis)
    beta = functools.reduce(
        jnp.bitwise_xor,
        [jax.lax.index_in_dim(z, j, dc_axis, keepdims=True)
         for j in range(dc)],
    )                                                       # size-1 dc axis

    m1, c1, m2, c2, m3 = _top3_stacked(dU, dc_axis)

    # per-column exclusion, batched: column index along the dc axis
    jcol = _iota(dc, U.ndim, dc_axis).astype(jnp.float32)
    is_j0 = c1 == jcol
    is_j1 = c2 == jcol
    m1x = jnp.where(is_j0, m2, m1)
    c1x = jnp.where(is_j0, c2, c1)
    m2x = jnp.where(is_j0 | is_j1, m3, m2)

    if n_r:
        dw = _two_deviation_bubble(m1x, c1x, m2x, q, q_axis, n_r)
    else:
        dw = _two_deviation_dense(m1x, c1x, m2x, q, q_axis)
        dw = jnp.maximum(dw, m1x)                           # one deviation
    dw = jnp.where(iota_q == 0, 0.0, dw)                    # zero deviations
    # back to the normal domain: C_j(a) = dW(a ^ beta ^ z_j)
    return _xor_perm_dyn(dw, beta ^ z, q, q_axis)


def tems_cn_update(U: jnp.ndarray, graph: TannerGraph, offset: float = 0.0,
                   n_r: int = 0) -> jnp.ndarray:
    """Check-node update, x-domain in/out: [B, M, dc_max, q] log-domain.
    GF permutations live in the routing gathers (graph.gather_*_x).
    n_r > 0 selects the truncated-deviation search."""
    q = graph.q
    mask = graph.cn_mask[None, :, :, None]                # [1, M, dc, 1]
    U = U - jnp.max(U, axis=-1, keepdims=True)
    d0 = jnp.full((q,), NEG, U.dtype).at[0].set(0.0)
    U = jnp.where(mask, U, d0)                            # pads: identity
    out = _cn_tems_core(U, q, dc_axis=2, q_axis=3, n_r=n_r)
    out = jnp.minimum(out - jnp.max(out, axis=-1, keepdims=True) + offset, 0.0)
    return jnp.where(mask, jnp.maximum(out, NEG), 0.0)


def tems_cn_update_bl(U: jnp.ndarray, graph: TannerGraph, offset: float = 0.0,
                      n_r: int = 0) -> jnp.ndarray:
    """Batch-last CN update: U [M, dc_max, q, B] log-domain x-domain.

    Maskless: pad CN slots arrive as log-delta0 (graph.gather_cn_x_bl) —
    argmax 0, NEG deviation rows, 0 contribution to beta — and pad outputs
    are never routed by the VN gather."""
    q = graph.q
    U = U - jnp.max(U, axis=2, keepdims=True)
    out = _cn_tems_core(U, q, dc_axis=1, q_axis=2, n_r=n_r)
    return jnp.minimum(out - jnp.max(out, axis=2, keepdims=True) + offset, 0.0)


def decode(
    graph: TannerGraph,
    llr: jnp.ndarray,
    max_iters: int = 20,
    offset: float = 0.0,
    early_term: bool = True,
    batch_last: bool = True,
    stats_each_iter: bool = True,
    n_r: int = 0,
) -> common.DecodeResult:
    """T-EMS decode of a batch: llr [B, N, q] -> DecodeResult.

    stats_each_iter=False is the fixed-budget throughput mode (see
    common.decode_bl). n_r > 0 truncates the two-deviation search to the
    n_r most reliable rows (own oracle semantics + FER validation)."""
    if batch_last:
        cn = functools.partial(tems_cn_update_bl, offset=offset, n_r=n_r)
        return common.decode_bl(graph, llr, cn, max_iters, early_term,
                                stats_each_iter=stats_each_iter)
    cn = functools.partial(tems_cn_update, offset=offset, n_r=n_r)
    return common.decode(graph, llr, cn, max_iters, early_term)
