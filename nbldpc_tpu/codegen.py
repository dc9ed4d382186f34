"""Deterministic seeded NB-LDPC code construction (PEG).

The five BASELINE.json config codes — GF(4) (96,48), GF(16) (204,102),
GF(64) (576,480), GF(256) (255,175) — are NOT copied from anywhere: the
reference repo was unavailable (SURVEY.md §0), so these shapes are
*regenerated* here with a Progressive-Edge-Growth construction (Hu, Eleftheriou
& Arnold 2005, public algorithm) and seeded random GF(q)* edge weights.
Generation is deterministic given (n, m, q, dv, seed); the generated files are
checked into codes/ and the generator kept so they are reproducible
(SURVEY.md §7 risk item 5).

PEG greedily places each edge at the check node farthest from the variable
node in the current subgraph (maximizing local girth), tie-breaking by lowest
current check degree then seeded choice. With the min-degree tie-break, row
degrees self-balance to ceil/floor(E/M).
"""

from __future__ import annotations

from collections import deque

import numpy as np

from nbldpc_tpu.code import CodeSpec
from nbldpc_tpu.encode import gf_row_reduce
from nbldpc_tpu.gf import get_field


def _peg_structure(n: int, m: int, dv: np.ndarray, rng: np.random.Generator):
    """Binary Tanner-graph structure via PEG. Returns per-row column lists."""
    vn_checks = [[] for _ in range(n)]   # checks adjacent to each vn
    cn_vars = [[] for _ in range(m)]     # vars adjacent to each cn
    cn_deg = np.zeros(m, dtype=np.int64)

    from nbldpc_tpu import native

    use_native = native.available()

    def _bfs_dist(v: int) -> np.ndarray:
        """Distance from variable v to every check in the current subgraph."""
        if use_native:
            vn_ptr = np.cumsum([0] + [len(x) for x in vn_checks]).astype(np.int32)
            vn_adj = np.fromiter(
                (c for x in vn_checks for c in x), np.int32, count=vn_ptr[-1]
            )
            cn_ptr = np.cumsum([0] + [len(x) for x in cn_vars]).astype(np.int32)
            cn_adj = np.fromiter(
                (u for x in cn_vars for u in x), np.int32, count=cn_ptr[-1]
            )
            d = native.peg_bfs(vn_ptr, vn_adj, cn_ptr, cn_adj, n, m, v)
            if d is not None:
                d = d.astype(np.int64)
                d[d == np.iinfo(np.int32).max] = np.iinfo(np.int64).max
                return d
        dist = np.full(m, np.iinfo(np.int64).max, dtype=np.int64)
        seen_v = np.zeros(n, dtype=bool)
        seen_c = np.zeros(m, dtype=bool)
        seen_v[v] = True
        frontier = deque([("v", v, 0)])
        while frontier:
            kind, node, d = frontier.popleft()
            if kind == "v":
                for c in vn_checks[node]:
                    if not seen_c[c]:
                        seen_c[c] = True
                        dist[c] = d + 1
                        frontier.append(("c", c, d + 1))
            else:
                for u in cn_vars[node]:
                    if not seen_v[u]:
                        seen_v[u] = True
                        frontier.append(("v", u, d + 1))
        return dist

    for v in range(n):
        for _k in range(int(dv[v])):
            dist = _bfs_dist(v)
            # degree-constrained PEG: restrict to minimum-degree checks first
            # (keeps row degrees balanced to ceil/floor(E/M) — dense padded
            # compute pays for dc_max, so balance beats a little girth),
            # then among those pick the farthest (girth), then seeded choice.
            cand = np.arange(m)[~np.asarray([c in vn_checks[v] for c in range(m)])]
            if len(cand) == 0:
                raise ValueError("dv exceeds number of checks")
            degmin = cn_deg[cand].min()
            cand = cand[cn_deg[cand] == degmin]
            dmax = dist[cand].max()
            cand = cand[dist[cand] == dmax]
            c = int(cand[rng.integers(len(cand))])
            vn_checks[v].append(c)
            cn_vars[c].append(v)
            cn_deg[c] += 1
    return cn_vars


def make_peg_code(
    n: int, m: int, q: int, dv: int = 2, seed: int = 0,
    require_full_rank: bool = True, weight_mode: str = "random",
) -> CodeSpec:
    """Generate a (n, n-m) NB-LDPC code over GF(q) with column degree dv.

    Retries GF-weight assignment (and then structure) until H has rank m over
    GF(q), so the systematic encoder always exists.

    weight_mode: "random" = independent seeded GF(q)* weight per edge;
    "chunk8" = one seeded weight TUPLE per aligned 8-row group, shared by
    the group's rows (slot j of every row in group g carries the same
    weight). Check-row indices are arbitrary labels, so this costs nothing
    structurally (PEG graph unchanged) — but it makes per-edge GF rotation
    amounts uniform over aligned 8-row chunks, which a kernel that rotates
    messages per edge can turn into static shifts, with ZERO row
    inflation, unlike the per-slot-uniform QC mode (which showed a ~0.5 dB
    FER loss). ceil(m/8) * dc independent tuples keep the edge-label
    diversity high; its FER matched "random" at the one SNR point tried.
    The decoders here fold the permutations into the routing gathers and
    gain nothing from it (ROADMAP: design debts).
    """
    gf = get_field(q)
    dv_arr = np.full(n, dv, dtype=np.int64)
    for attempt in range(32):
        rng = np.random.default_rng([seed, attempt, n, m, q])
        cn_vars = _peg_structure(n, m, dv_arr, rng)
        dc_max = max(len(x) for x in cn_vars)
        for val_try in range(8):
            vrng = np.random.default_rng([seed, attempt, val_try, 0xBEEF])
            chunk_w = None
            if weight_mode == "chunk8":
                chunk_w = vrng.integers(
                    1, q, size=(-(-m // 8), dc_max)).astype(np.int32)
            row_cols, row_vals = [], []
            for mi in range(m):
                cols = np.array(sorted(cn_vars[mi]), dtype=np.int32)
                if chunk_w is not None:
                    vals = chunk_w[mi // 8, : len(cols)].copy()
                else:
                    vals = vrng.integers(1, q, size=len(cols)).astype(np.int32)
                row_cols.append(cols)
                row_vals.append(vals)
            spec = CodeSpec(q=q, n=n, m=m, row_cols=tuple(row_cols), row_vals=tuple(row_vals))
            if not require_full_rank:
                return spec
            H = spec.dense_h()
            _, rank, _ = gf_row_reduce(H, gf)
            if rank == m:
                return spec
    raise RuntimeError(f"could not build full-rank code ({n},{n - m}) over GF({q})")


def make_qc_code(
    n: int, m: int, q: int, z: int, dv: int = 2, seed: int = 0,
    require_full_rank: bool = True, weight_mode: str = "circulant",
) -> CodeSpec:
    """Quasi-cyclic NB-LDPC code: H is an (m/z) x (n/z) array of z x z
    circulant blocks (identity shifted by a seeded exponent), each circulant
    carrying ONE uniform GF(q)* weight (SURVEY.md C2).

    Why: per-circulant-uniform weights make the per-edge GF rotation amount
    constant over aligned row blocks, which a kernel that rotates messages
    per edge can turn into STATIC shifts. FER must be re-validated against
    the PEG codes (benchmarks/fer_curves.py --qc).

    The z x z macro structure is built with the same degree-balanced PEG
    greedy on the base graph (macro-girth maximization lifts to girth
    lower bounds on the expanded graph); shifts and weights are seeded.

    weight_mode: "circulant" = one weight per circulant (rotation amounts
    uniform over z-row blocks); "slot" = one weight per sorted slot
    position shared by ALL circulants in that column position (rotation
    amounts uniform over each entire slot block, whatever z is). "slot"
    trades edge-label diversity for static rotations and must clear FER
    validation.
    """
    if n % z or m % z:
        raise ValueError(f"z={z} must divide n={n} and m={m}")
    gf = get_field(q)
    nb, mb = n // z, m // z
    if mb < dv:
        raise ValueError("base graph needs at least dv check blocks")
    dv_arr = np.full(nb, dv, dtype=np.int64)
    for attempt in range(32):
        rng = np.random.default_rng([seed, attempt, n, m, q, z, 0x9C])
        base = _peg_structure(nb, mb, dv_arr, rng)     # per-base-row cols
        for val_try in range(8):
            vrng = np.random.default_rng([seed, attempt, val_try, z, 0xC1])
            row_cols = [[] for _ in range(m)]
            row_vals = [[] for _ in range(m)]
            slot_w = [int(vrng.integers(1, q)) for _ in range(max(
                len(b) for b in base))]
            for bi in range(mb):
                for sj, bj in enumerate(sorted(base[bi])):
                    shift = int(vrng.integers(z))
                    if weight_mode == "slot":
                        w = slot_w[sj]
                    else:
                        w = int(vrng.integers(1, q))
                    for r in range(z):
                        row_cols[bi * z + r].append(bj * z + (r + shift) % z)
                        row_vals[bi * z + r].append(w)
            rc, rv = [], []
            for mi in range(m):
                order = np.argsort(row_cols[mi], kind="stable")
                rc.append(np.asarray(row_cols[mi], np.int32)[order])
                rv.append(np.asarray(row_vals[mi], np.int32)[order])
            spec = CodeSpec(q=q, n=n, m=m, row_cols=tuple(rc),
                            row_vals=tuple(rv))
            if not require_full_rank:
                return spec
            H = spec.dense_h()
            _, rank, _ = gf_row_reduce(H, gf)
            if rank == m:
                return spec
    raise RuntimeError(
        f"could not build full-rank QC code ({n},{n - m}) over GF({q})")


# The BASELINE.json config code shapes (SURVEY.md §6), regenerated:
STANDARD_CODES = {
    # name: (n, m, q, dv, seed)
    "gf4_n96_k48": (96, 48, 4, 2, 1),
    "gf16_n204_k102": (204, 102, 16, 2, 1),
    "gf64_n576_k480": (576, 96, 64, 2, 1),
    "gf256_n255_k175": (255, 80, 256, 2, 1),
}

# QC twins of the BASELINE shapes: same (n, k, q), quasi-cyclic structure.
# "slot" weight mode where it reaches full rank (GF(16): z=34 — z=17 and
# per-slot GF(4) weights are rank-blocked, the diversity cost of slot
# uniformity is real); "circulant" mode with z=8 for GF(4).
STANDARD_CODES_QC = {
    # name: (n, m, q, z, dv, seed, weight_mode)
    "gf4_n96_k48_qc": (96, 48, 4, 8, 2, 1, "circulant"),
    "gf16_n204_k102_qc": (204, 102, 16, 34, 2, 1, "slot"),
}

# chunk8 PEG twins: the SAME PEG Tanner graph as the baseline codes, with
# per-8-row-group weight tuples (zero structural change — see
# make_peg_code weight_mode).
STANDARD_CODES_C8 = {
    "gf4_n96_k48_c8": (96, 48, 4, 2, 1),
    "gf16_n204_k102_c8": (204, 102, 16, 2, 1),
}


def build_standard_code(name: str) -> CodeSpec:
    if name in STANDARD_CODES_QC:
        n, m, q, z, dv, seed, wm = STANDARD_CODES_QC[name]
        return make_qc_code(n, m, q, z, dv=dv, seed=seed, weight_mode=wm)
    if name in STANDARD_CODES_C8:
        n, m, q, dv, seed = STANDARD_CODES_C8[name]
        return make_peg_code(n, m, q, dv=dv, seed=seed, weight_mode="chunk8")
    n, m, q, dv, seed = STANDARD_CODES[name]
    return make_peg_code(n, m, q, dv=dv, seed=seed)
