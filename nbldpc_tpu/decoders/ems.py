"""EMS: Extended Min-Sum decoder with nm-truncated configuration sets.

SURVEY.md C9: log-domain max-sum check-node update restricted to the nm most
reliable entries of each message (Declercq–Fossorier / Voicila EMS), with
forward/backward elementary merges and offset correction.

Semantics (round 2 — the CLASSIC truncated-list scheme, de-circularized per
round-1 verdict): every elementary merge combines two nm-truncated operands,

    out[a] = max over (t1, t2) with idx_t1 ^ idx_t2 = a of val_t1 + val_t2,

where each operand contributes only its top-nm entries (ties at equal value
broken toward the LOWER GF index, the deterministic tie-break of a stable
sort). Forward/backward partials are re-truncated to their top-nm after
every merge — exactly the classic sorted-list algorithm, with lists
represented as NEG-masked dense q-vectors. Final extrinsic outputs keep all
computed configuration values (no output truncation; common in software EMS
and never worse). The numpy oracle (tests/reference_model.py::_cn_ems)
implements the identical scheme independently.

Formulation — static shapes, no dynamic gathers, no sorts:
  - top-nm extraction: nm unrolled steps of (max over q, first-occurrence
    argmax via masked-iota min, remove-one) — exact stable-sort tie-break;
  - merges for q <= 64: scan ALL q symbols of the masked operand with
    STATIC XOR lane permutations (masked entries lose every max), q*O(1);
  - merges for q > 64: scan only the nm extracted (value, index) pairs,
    gathering the other operand through a DATA-DEPENDENT XOR permutation
    decomposed into p conditional static permutes, nm*O(p) — this is what
    makes GF(256) nm=16 tractable (the round-1 per-element gather path was
    judged unusable there).
Both strategies compute the same function.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from nbldpc_tpu.decoders import common
from nbldpc_tpu.graph import TannerGraph

NEG = -1e30

# Merge strategy cutover: scan-all-q with static permutes costs ~5q vector
# ops, the top-nm dynamic-XOR scan ~nm*(4p+2); by that op count the static
# variant wins up to q=64. The cutover was chosen from op counts on the
# first target and has not been measured on the GPU.
DENSE_MERGE_MAX_Q = 64


def _delta0(q: int, dtype=jnp.float32):
    """Identity element of max-xor-convolution: 0 at symbol 0, -inf else."""
    return jnp.full((q,), NEG, dtype).at[0].set(0.0)


def _xor_take(x: jnp.ndarray, h: int, q: int, axis: int) -> jnp.ndarray:
    """Static XOR permute along `axis`: out[.., a, ..] = x[.., a ^ h, ..]."""
    idx = np.arange(q) ^ h
    return jnp.take(x, idx, axis=axis)


def _xor_perm_dyn(x: jnp.ndarray, z: jnp.ndarray, q: int,
                  axis: int) -> jnp.ndarray:
    """Data-dependent XOR permute along `axis`: out[a] = x[a ^ z].

    z: int32 with size-1 `axis` (broadcasts). Decomposes into p conditional
    STATIC permutes (one per bit of z) — no dynamic gathers."""
    for t in range(q.bit_length() - 1):
        xp = _xor_take(x, 1 << t, q, axis)
        x = jnp.where(((z >> t) & 1) != 0, xp, x)
    return x


def _iota(q: int, ndim: int, axis: int):
    shape = [1] * ndim
    shape[axis % ndim] = q
    return jax.lax.broadcasted_iota(jnp.int32, tuple(shape), axis % ndim)


def _top_extract(x: jnp.ndarray, nm: int, q: int, axis: int):
    """Exact stable top-nm of x along `axis` (ties -> lower GF index).

    Returns (lst, dense, vals, idxs): `lst` equals x on the top-nm entries
    and NEG elsewhere (the scan-side form — tail entries can never win a
    merge max); `dense` fills the tail with the COMPENSATION value — the
    smallest kept value, vals[nm-1] — the classic Voicila/Declercq
    truncated-list semantics (a -inf tail annihilates every configuration
    not reachable through kept entries; measured round 3 on GF(256) nm=16:
    FER 1.0 at an SNR where QSPA reaches 4e-5). vals/idxs are nm arrays
    with size-1 `axis` (broadcastable), in descending order."""
    iota = _iota(q, x.ndim, axis)
    run = x
    removed = jnp.zeros(x.shape, bool)
    vals, idxs = [], []
    for _ in range(nm):
        mx = jnp.max(run, axis=axis, keepdims=True)
        idx = jnp.min(
            jnp.where(run >= mx, iota, q), axis=axis, keepdims=True
        ).astype(jnp.int32)
        sel = iota == idx
        removed = removed | sel
        run = jnp.where(sel, NEG, run)
        vals.append(mx)
        idxs.append(idx)
    lst = jnp.where(removed, x, NEG)
    dense = jnp.where(removed, x, vals[-1])
    return lst, dense, vals, idxs


def _bitrev(x: int, p: int) -> int:
    """Reverse the low p bits of x."""
    r = 0
    for i in range(p):
        r |= ((x >> i) & 1) << (p - 1 - i)
    return r


def _merge_dense(accM: jnp.ndarray, opM: jnp.ndarray, q: int, axis: int):
    """out[a] = max_b opM[b] + accM[a ^ b], all-q scan with static permutes.

    The scan walks b in BIT-REVERSED GRAY-CODE order, so each step's accM
    permutation differs from the previous by a SINGLE bit — one static
    single-bit XOR permute per step instead of popcount(b) — and the bit
    that flips most often is the HIGHEST one, whose permute is the cheapest
    lowering (a 2-slice concat; a plain Gray walk flips bit 0 half the
    time, the q-slice worst case). Max is order-independent, so any
    Hamiltonian walk computes the same function. Truncation lives in the
    NEG masking of the operands (a NEG entry can never produce the max);
    with unmasked operands this is the exact untruncated
    max-xor-convolution (the nm >= q path)."""
    out = None
    acc_g = accM
    p = q.bit_length() - 1
    prev = 0
    for g in range(q):
        b = _bitrev(g ^ (g >> 1), p)                       # reflected Gray
        if b ^ prev:
            acc_g = _xor_take(acc_g, b ^ prev, q, axis)
        prev = b
        opb = jax.lax.index_in_dim(opM, b, axis % opM.ndim, keepdims=True)
        cand = opb + acc_g
        out = cand if out is None else jnp.maximum(out, cand)
    return out


def _merge_scan(accM: jnp.ndarray, vals, idxs, q: int, axis: int):
    """out[a] = max_t vals[t] + accM[a ^ idxs[t]] over the nm list entries."""
    out = None
    for v, i in zip(vals, idxs):
        cand = v + _xor_perm_dyn(accM, i, q, axis)
        out = cand if out is None else jnp.maximum(out, cand)
    return out


def _cn_ems_core(Ujs: list, nm: int, q: int, axis: int) -> list:
    """Classic truncated forward/backward EMS over one check's dc operands.

    Ujs: dc arrays [..., q at `axis`, ...], log-domain x-domain, normalized,
    pad slots already replaced by delta0. Returns dc extrinsic outputs."""
    dc = len(Ujs)
    assert dc >= 2, "EMS check-node update needs dc >= 2 edges per check"
    trunc = nm < q

    # Merge convention (shared verbatim with the numpy oracle,
    # tests/reference_model.py::_ems_merge_classic): the ACC operand
    # contributes its COMPENSATED dense form (tail = smallest kept value),
    # the scanned operand only its kept list entries.
    if not trunc:
        merge = lambda acc, op: _merge_dense(acc[1], op[0], q, axis)
        extract = lambda x: (x, x, None, None)
    elif q <= DENSE_MERGE_MAX_Q:
        merge = lambda acc, op: _merge_dense(acc[1], op[0], q, axis)
        extract = lambda x: _top_extract(x, nm, q, axis)
    else:
        merge = lambda acc, op: _merge_scan(acc[1], op[2], op[3], q, axis)
        extract = lambda x: _top_extract(x, nm, q, axis)

    quads = [extract(u) for u in Ujs]

    # F[j] = truncated merge of U[0..j-1]; F[1] is U[0] itself (merge with
    # the delta0 identity), so the first merge+extract is skipped.
    F = [None] * dc
    F[1] = quads[0]
    for j in range(2, dc):
        F[j] = extract(merge(F[j - 1], quads[j - 1]))
    # B[j] = truncated merge of U[j+1..dc-1]
    B = [None] * dc
    B[dc - 2] = quads[dc - 1]
    for j in range(dc - 3, -1, -1):
        B[j] = extract(merge(B[j + 1], quads[j + 1]))

    # Edge outputs emit the compensated dense form (a -inf extrinsic at
    # uncovered symbols would annihilate the posterior); middle outputs are
    # fully covered through the acc side's dense form already.
    outs = []
    for j in range(dc):
        if j == 0:
            outs.append(B[0][1])
        elif j == dc - 1:
            outs.append(F[dc - 1][1])
        else:
            outs.append(merge(F[j], B[j]))
    return outs


# ---------------------------------------------------------------------------
# Bubble EMS: list-based merges for large q.
#
# The classic q>64 path above scans nm list entries against a DENSE
# compensated operand, paying nm * p conditional static permutes of a dense
# [.., q, ..] tensor per merge (~200 dense passes at GF(256) nm=16). Bubble
# EMS (Boutillon & Conde-Canencia's bubble-check idea, adapted to static
# shapes) merges two SORTED nm-lists directly: for sorted descending
# operands, every candidate pair (t, s) with (t+1)*(s+1) > nm is dominated
# by more than nm larger pairs and can never reach the top-nm, so the
# merge enumerates only a STATIC staircase set (bubble_pairs: |S| = 103
# for nm = 16 at budget 2) plus min(2nm, q) floor-valued fill candidates,
# and extracts its top-nm — all ops on [.., 135, ..] tensors instead of
# [.., q, ..]. Lists convert to dense only at the CN boundary (scatter with
# compensation fill), keeping the VN/posterior machinery unchanged.
#
# SEMANTICS DIFFER from the classic compensated-dense scheme (pairs outside
# the staircase are dropped; the tail is filled with fresh indices at the
# compensation floor, see _merge_bubble), so this is a separate decoder
# variant with its own co-designed numpy oracle
# (tests/reference_model.py kind="ems_bubble") and its own FER
# validation (GF(256) nm=16: FER 1.26x classic at 3.0 dB, PERF.md) — the
# classic paths and their golden tests are untouched. Deterministic
# tie-breaks: input
# extraction ties -> lower GF index; candidate extraction ties -> first in
# the lexicographic (t, s) enumeration; duplicate-index scatter -> the
# larger value wins.
# ---------------------------------------------------------------------------


def bubble_pairs(nm: int, budget: int = 2):
    """Static staircase candidate set: (t+1)*(s+1) <= budget*nm, lex order.

    A budget of nm (budget=1, |S| = 50 for nm = 16) suffices for the
    top-nm BY VALUE of sorted operands, but the index-DEDUP in
    _merge_bubble reaches deeper than nm raw candidates when top values
    collide on GF indices. FER finding (GF(256) (255,175) nm=16, 10 it,
    fresh-fill merges, 3.0 dB): budget=1 reaches 1.21e-2 against
    budget=2's 7.46e-3 (classic 5.93e-3) — staircase depth carries real
    coding gain even with the fresh-fill tail fix, so budget=2 stays the
    default."""
    return [(t, s) for t in range(nm) for s in range(nm)
            if (t + 1) * (s + 1) <= budget * nm]


def _take_static(x: jnp.ndarray, T, axis: int) -> jnp.ndarray:
    """Gather STATIC indices T along `axis` as a concat of unit slices;
    XLA folds it into the consumer."""
    ax = axis % x.ndim
    return jnp.concatenate(
        [jax.lax.index_in_dim(x, int(t), ax, keepdims=True) for t in T],
        axis=ax)


def _top_list(x: jnp.ndarray, nm: int, q: int, axis: int):
    """Top-nm (vals, idxs) of dense x along `axis`, descending, ties ->
    lower GF index (stable-sort order). vals/idxs have nm at `axis`.

    Unrolled masked-iota max/argmax/remove steps (a lax.top_k + gather
    form is the alternative; it has not been timed on the GPU).
    """
    iota = _iota(q, x.ndim, axis)
    run = x
    vals, idxs = [], []
    for _ in range(nm):
        mx = jnp.max(run, axis=axis, keepdims=True)
        idx = jnp.min(
            jnp.where(run >= mx, iota, q), axis=axis, keepdims=True
        ).astype(jnp.int32)
        run = jnp.where(iota == idx, NEG, run)
        vals.append(mx)
        idxs.append(idx)
    return jnp.concatenate(vals, axis), jnp.concatenate(idxs, axis)


def _merge_bubble(acc, op, TS, nm: int, q: int, axis: int):
    """Merge two sorted nm-lists: top-nm of the staircase candidates
    (values a_t + b_s at GF indices ai_t ^ bi_s) AUGMENTED with
    fresh-index fill candidates at the classic compensation floor
    f = opv_0 + acc_comp. Ties -> first candidate in the enumeration
    (staircase in lex (t, s) order, then fills in ascending GF index).
    Returns (vals, idxs, comp) sorted desc.

    The fill candidates reproduce the classic compensated-dense merge's
    partial-list semantics exactly: there, partials are top-nm of a dense
    merge whose every entry is >= f = opv_0 + acc_comp, so when fewer
    than nm pair candidates beat the floor, the tail slots anchor FRESH
    f-valued indices (ties -> lowest GF index) instead of reusing
    dominated pair indices. min(2*nm, q) fill candidates at indices
    0..min(2*nm,q)-1 suffice: at most nm distinct real picks can dedup
    away fills, leaving >= nm fresh ones. Below-floor pair candidates
    are dropped outright (the fills dominate them). Without fresh-index
    fills, GF(256) nm=16 FER sat 5.6x off classic at 3 dB (round-5
    fer_curves_r5); without any floor, tail configurations annihilate
    and FER degrades ~30x (first-pass round-5 measurement).

    All ops on [.., P=|staircase|+min(2nm,q), ..] tensors (P = 135 for
    nm = 16) — the point of the bubble scheme: no dense-q work inside
    merges."""
    accV, accI, accC = acc
    opV, opI, _opC = op
    T, S = TS
    av = _take_static(accV, T, axis)
    ai = _take_static(accI, T, axis)
    bv = _take_static(opV, S, axis)
    bi = _take_static(opI, S, axis)
    f = jax.lax.index_in_dim(opV, 0, axis % opV.ndim, keepdims=True) + accC
    cv = av + bv                                       # [.., Ps, ..]
    ci = ai ^ bi
    nf = min(2 * nm, q)
    # Fill candidates: value exactly f at GF indices 0..nf-1, appended
    # AFTER the staircase so above-floor pairs win value ties.
    fshape = list(cv.shape)
    fshape[axis % cv.ndim] = nf
    cv = jnp.concatenate(
        [jnp.where(cv > f, cv, NEG), jnp.broadcast_to(f, fshape)], axis)
    ci = jnp.concatenate(
        [ci, jnp.broadcast_to(_iota(nf, ci.ndim, axis), fshape)], axis)
    P = len(T) + nf
    iota = _iota(P, cv.ndim, axis)
    vals, idxs = [], []
    run = cv
    for _ in range(nm):
        mx = jnp.max(run, axis=axis, keepdims=True)
        pos = jnp.min(jnp.where(run >= mx, iota, P), axis=axis,
                      keepdims=True)
        sel = iota == pos
        pick = jnp.sum(jnp.where(sel, ci, 0), axis=axis, keepdims=True)
        # DEDUP: kill every candidate landing on the picked GF index, not
        # just the picked position — the classic scheme extracts from a
        # DENSE merge and therefore always returns nm DISTINCT symbols;
        # without this, duplicate-index pairs waste list slots and GF(256)
        # nm=16 FER degrades ~30x at 3 dB (measured, fer_curves_r5 first
        # pass). Killing by index also retires fill candidates whose
        # index a real pick already claimed.
        run = jnp.where(ci == pick, NEG, run)
        vals.append(mx)
        idxs.append(pick.astype(jnp.int32))
    vals = [jnp.maximum(v, f) for v in vals]
    return (jnp.concatenate(vals, axis),
            jnp.concatenate(idxs, axis).astype(jnp.int32),
            vals[-1])


def _merge_bubble_dense(acc, op, TS, q: int, axis: int):
    """FINAL-output merge: dense q-vector out[a] = max over the staircase
    candidates landing on a, floored at the classic compensation
    f = opv_0 + acc_comp — the exact per-index structure of the classic
    scheme's (untruncated) final merge restricted to the staircase pairs.
    Keeping only the top-nm + a comp fill here (the first round-5 bubble)
    was measured to cost ~27x FER at GF(256) 3 dB: final extrinsics need
    per-index variation, not a flat tail."""
    accV, accI, accC = acc
    opV, opI, _opC = op
    T, S = TS
    ax = axis % accV.ndim
    av = _take_static(accV, T, axis)
    ai = _take_static(accI, T, axis)
    bv = _take_static(opV, S, axis)
    bi = _take_static(opI, S, axis)
    cv = av + bv
    ci = ai ^ bi
    f = jax.lax.index_in_dim(opV, 0, ax, keepdims=True) + accC
    iota = _iota(q, accV.ndim, axis)
    out = jnp.broadcast_to(
        f, f.shape[:ax] + (q,) + f.shape[ax + 1:])
    P = len(T)
    for p in range(P):
        v = jax.lax.index_in_dim(cv, p, ax, keepdims=True)
        i = jax.lax.index_in_dim(ci, p, ax, keepdims=True)
        out = jnp.maximum(out, jnp.where(iota == i, v, NEG))
    return out


def _scatter_list(lst, q: int, axis: int):
    """List -> dense q-vector: kept entries at their GF indices, every
    other symbol filled with the COMPENSATION value (smallest kept value,
    the classic truncated-list tail semantics). Written largest-last so
    the larger value wins at duplicate indices."""
    vals, idxs, comp = lst
    nm = vals.shape[axis % vals.ndim]
    iota = _iota(q, vals.ndim, axis)
    out = jnp.broadcast_to(
        comp, comp.shape[: axis % vals.ndim] + (q,)
        + comp.shape[axis % vals.ndim + 1:])
    for t in reversed(range(nm)):
        v = jax.lax.index_in_dim(vals, t, axis % vals.ndim, keepdims=True)
        i = jax.lax.index_in_dim(idxs, t, axis % vals.ndim, keepdims=True)
        out = jnp.where(iota == i, v, out)
    return out


def _cn_ems_bubble_core(Ujs: list, nm: int, q: int, axis: int,
                        stacked=None, dc_axis: int = 0) -> list:
    """Bubble forward/backward EMS over one check's dc operands.

    Same F/B recursion shape as _cn_ems_core; operands live as sorted
    nm-lists throughout, densified only for the final edge outputs.

    If `stacked` is given (the dense operands still carrying their dc axis
    at `dc_axis`), the input extraction runs ONCE batched over dc instead
    of per slot — identical per-element semantics, ~dc x fewer ops (the
    extraction loop dominates the bubble CN update)."""
    dc = len(Ujs)
    assert dc >= 2
    pairs = bubble_pairs(nm)
    TS = (np.array([t for t, _ in pairs]), np.array([s for _, s in pairs]))

    def with_comp(vi):
        v, i = vi
        return (v, i, jax.lax.index_in_dim(v, nm - 1, axis % v.ndim,
                                           keepdims=True))

    if stacked is not None:
        sv, si = _top_list(stacked, nm, q, axis + (dc_axis <= axis))
        dax = dc_axis % stacked.ndim
        quads = [
            with_comp((jnp.squeeze(jax.lax.index_in_dim(sv, j, dax), dax),
                       jnp.squeeze(jax.lax.index_in_dim(si, j, dax), dax)))
            for j in range(dc)
        ]
    else:
        quads = [with_comp(_top_list(u, nm, q, axis)) for u in Ujs]
    F = [None] * dc
    F[1] = quads[0]
    for j in range(2, dc):
        F[j] = _merge_bubble(F[j - 1], quads[j - 1], TS, nm, q, axis)
    B = [None] * dc
    B[dc - 2] = quads[dc - 1]
    for j in range(dc - 3, -1, -1):
        B[j] = _merge_bubble(B[j + 1], quads[j + 1], TS, nm, q, axis)

    outs = []
    for j in range(dc):
        if j == 0:
            outs.append(_scatter_list(B[0], q, axis))
        elif j == dc - 1:
            outs.append(_scatter_list(F[dc - 1], q, axis))
        else:
            outs.append(_merge_bubble_dense(F[j], B[j], TS, q, axis))
    return outs


def _postprocess(O: jnp.ndarray, offset: float, axis: int) -> jnp.ndarray:
    O = O - jnp.max(O, axis=axis, keepdims=True)
    return jnp.maximum(jnp.minimum(O + offset, 0.0), NEG)


def ems_cn_update(
    U: jnp.ndarray, graph: TannerGraph, nm: int = 16, offset: float = 0.0
) -> jnp.ndarray:
    """Check-node update, x-domain in/out: [B, M, dc_max, q] log-domain.
    GF permutations live in the routing gathers (graph.gather_*_x)."""
    q = graph.q
    U = U - jnp.max(U, axis=-1, keepdims=True)
    d0 = _delta0(q, U.dtype)
    U = jnp.where(graph.cn_mask[None, :, :, None], U, d0)  # pads: merge identity
    Ujs = [U[:, :, j, :] for j in range(graph.dc_max)]
    outs = _cn_ems_core(Ujs, min(nm, q), q, axis=-1)
    O = _postprocess(jnp.stack(outs, axis=2), offset, axis=-1)
    return jnp.where(graph.cn_mask[None, :, :, None], O, 0.0)


def ems_cn_update_bl(
    U: jnp.ndarray, graph: TannerGraph, nm: int = 16, offset: float = 0.0,
    merge: str = "classic",
) -> jnp.ndarray:
    """Batch-last CN update: U [M, dc_max, q, B] log-domain x-domain.

    Identical math to ems_cn_update with q on axis 2 and the Monte-Carlo
    batch last. Pad CN slots arrive as log-delta0 — exactly
    the merge identity — from graph.gather_cn_x_bl, so no masking is needed
    (pad OUTPUT slots are never routed by the VN gather).

    merge="bubble" selects the list-based staircase merges (the fast
    large-q variant — see the Bubble EMS block above; different truncation
    semantics, own oracle/goldens)."""
    q = graph.q
    U = U - jnp.max(U, axis=2, keepdims=True)
    Ujs = [U[:, j] for j in range(graph.dc_max)]              # [M, q, B]
    if merge == "bubble":
        outs = _cn_ems_bubble_core(Ujs, min(nm, q), q, axis=1,
                                   stacked=U, dc_axis=1)
    else:
        outs = _cn_ems_core(Ujs, min(nm, q), q, axis=1)
    return _postprocess(jnp.stack(outs, axis=1), offset, axis=2)


def decode(
    graph: TannerGraph,
    llr: jnp.ndarray,
    max_iters: int = 20,
    nm: int = 16,
    offset: float = 0.0,
    early_term: bool = True,
    batch_last: bool = True,
    stats_each_iter: bool = True,
    merge: str = "classic",
) -> common.DecodeResult:
    """EMS decode of a batch: llr [B, N, q] -> DecodeResult.

    batch_last=True runs the [.., q, B] layout of common.decode_bl;
    merge="bubble" selects the list-based large-q CN variant (batch-last
    only)."""
    if batch_last:
        cn = functools.partial(ems_cn_update_bl, nm=nm, offset=offset,
                               merge=merge)
        return common.decode_bl(graph, llr, cn, max_iters, early_term,
                                stats_each_iter=stats_each_iter)
    cn = functools.partial(ems_cn_update, nm=nm, offset=offset)
    return common.decode(graph, llr, cn, max_iters, early_term)
