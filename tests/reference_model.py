"""Slow, loop-based numpy reference decoders (the in-repo test oracle).

IMPORTANT PROVENANCE NOTE: the upstream C++ reference (YongonY/NBLDPC) was
NOT available in any session (/root/reference is empty — SURVEY.md §0), so
this module is the executable stand-in oracle demanded by SURVEY.md §4.2:
written directly from the textbook QSPA/EMS/T-EMS equations (Davey–MacKay;
Declercq–Fossorier; Li et al.), deliberately loop-based and independent of
the JAX implementation's vectorization choices. In particular the QSPA
check-node convolution here is computed DIRECTLY over GF(q) configurations
(O(q^2) xor-convolution), not via the Walsh–Hadamard transform — so a WHT
bug in the framework cannot cancel out in the golden tests.

Numerics shared with the framework (so hard decisions match frame-for-frame):
prob-domain floor PROB_FLOOR, log-domain normalization by max.
"""

from __future__ import annotations

import numpy as np

from nbldpc_tpu.gf import get_field

PROB_FLOOR = 1e-12


def _softmax(v):
    v = v - v.max()
    e = np.exp(v)
    return e / e.sum()


def _xor_conv(p1, p2):
    """Convolution over (GF(2^p), +): out[a] = sum_b p1[b] p2[a ^ b]."""
    q = len(p1)
    out = np.zeros(q)
    for b in range(q):
        for c in range(q):
            out[b ^ c] += p1[b] * p2[c]
    return out


class OracleDecoder:
    """Flooding-schedule BP with pluggable CN update, one frame at a time."""

    def __init__(self, spec, kind="qspa", nm=None, offset=0.0, n_r=0):
        self.spec = spec
        self.gf = get_field(spec.q)
        self.kind = kind
        self.nm = nm
        self.offset = offset
        # T-EMS truncated-deviation rows (0 = exact all-row scan) — the
        # co-designed oracle for decoders/tems.py _two_deviation_bubble
        self.n_r = n_r

    # --- shared pieces -------------------------------------------------
    def syndrome_ok(self, hard):
        gf = self.gf
        for cols, vals in zip(self.spec.row_cols, self.spec.row_vals):
            s = 0
            for c, w in zip(cols, vals):
                s ^= int(gf.mul[w, hard[c]])
            if s != 0:
                return False
        return True

    def decode(self, llr, max_iters, early_term=True, return_messages=False):
        """llr: [N, q] float. Returns (hard [N], done, iters[, C messages])."""
        spec, gf = self.spec, self.gf
        q = spec.q
        llr = np.asarray(llr, dtype=np.float64)
        llr = llr - llr.max(axis=-1, keepdims=True)
        # messages keyed by (check index, slot) — C[m][j] is a length-q array
        C = [
            [np.zeros(q) for _ in range(len(spec.row_cols[m]))]
            for m in range(spec.m)
        ]
        hard = np.argmax(llr, axis=-1).astype(np.int64)
        if early_term and self.syndrome_ok(hard):
            return (hard, True, 0) + ((C,) if return_messages else ())
        done = False
        iters = 0
        for _ in range(max_iters):
            if early_term and done:
                break
            iters += 1
            # VN phase: V[m][j] = llr[v] + sum_{other checks} C - own C
            totals = llr.copy()
            for m in range(spec.m):
                for j, v in enumerate(spec.row_cols[m]):
                    totals[v] += C[m][j]
            V = [
                [None] * len(spec.row_cols[m]) for m in range(spec.m)
            ]
            for m in range(spec.m):
                for j, v in enumerate(spec.row_cols[m]):
                    msg = totals[v] - C[m][j]
                    V[m][j] = msg - msg.max()
            # CN phase
            if self.kind == "qspa":
                C = self._cn_qspa(V)
            elif self.kind == "ems":
                C = self._cn_ems(V)
            elif self.kind == "ems_bubble":
                C = self._cn_ems_bubble(V)
            elif self.kind == "ems_legacy":
                C = self._cn_ems_legacy(V)
            elif self.kind == "tems":
                C = self._cn_tems(V)
            else:
                raise ValueError(self.kind)
            # decision
            totals = llr.copy()
            for m in range(spec.m):
                for j, v in enumerate(spec.row_cols[m]):
                    totals[v] += C[m][j]
            hard = np.argmax(totals, axis=-1).astype(np.int64)
            done = self.syndrome_ok(hard)
            if done and early_term:
                break
        out = (hard, done, iters)
        return out + ((C,) if return_messages else ())

    # --- QSPA: direct xor-convolution in the prob domain ----------------
    def _cn_qspa(self, V):
        spec, gf = self.spec, self.gf
        q = spec.q
        C = []
        for m in range(spec.m):
            vals = spec.row_vals[m]
            dc = len(vals)
            # permute into the "x = h*c" domain: U(a) = P(h^{-1} a)
            U = []
            for j in range(dc):
                P = _softmax(V[m][j])
                hinv = gf.inv[vals[j]]
                perm = gf.mul[hinv, np.arange(q)]
                U.append(P[perm])
            row = []
            for j in range(dc):
                # direct conv of all other edges' pmfs
                acc = np.zeros(q)
                acc[0] = 1.0
                for j2 in range(dc):
                    if j2 != j:
                        acc = _xor_conv(acc, U[j2])
                acc = np.maximum(acc, PROB_FLOOR)
                chat = np.log(acc)
                # inverse permute: C(a) = chat(h a)
                perm = gf.mul[vals[j], np.arange(q)]
                c = chat[perm]
                c = c - c.max()
                row.append(c)
            C.append(row)
        return C

    # --- EMS: nm-truncated max-sum xor-convolution -----------------------
    @staticmethod
    def _topnm_mask(u, nm):
        """Truncate to the stable top-nm (ties -> lower GF index).

        Returns (list_form, dense_form): entries outside the top-nm set
        become NEG in the LIST form (they can never win a merge max) and
        become the COMPENSATION value — the smallest kept value — in the
        DENSE form. The compensation is what makes nm << q viable (the
        classic Voicila/Declercq scheme): with a -inf tail instead, any
        configuration not reachable through kept entries is annihilated
        and nm=16-of-256 decoding collapses (measured round 3: FER 1.0 at
        an SNR where QSPA reaches 4e-5)."""
        order = np.argsort(-u, kind="stable")[:nm]
        lst = np.full(len(u), -1e30)
        lst[order] = u[order]
        dense = np.full(len(u), u[order[-1]])
        dense[order] = u[order]
        return lst, dense

    @staticmethod
    def _ems_merge_classic(acc, uM):
        """Classic elementary EMS merge: the ACC side contributes its
        compensated dense form, the scanned operand only its kept list
        entries: out[a] = max over t in u's list of uM[t] + acc_dense[a^t].
        (Loop over t with a vectorized inner max so GF(256) oracle runs stay
        tractable; semantics identical to the scalar double loop.)"""
        acc_dense = acc[1]
        q = len(acc_dense)
        a = np.arange(q)
        out = np.full(q, -1e30)
        for t in range(q):
            np.maximum(out, uM[0][t] + acc_dense[a ^ t], out)
        return out

    @staticmethod
    def _ems_merge_dense_fwd(acc, u, nm):
        """LEGACY round-1 variant (kept only to quantify its deviation from
        the classic scheme — see test_ems_variants): scanned operand
        truncated to stable top-nm, accumulator gathered DENSELY
        (untruncated partials on one side — a superset of the classic
        configuration sets)."""
        q = len(acc)
        order = np.argsort(-u, kind="stable")[:nm]
        out = np.full(q, -1e30)
        for t in order:
            for a in range(q):
                cand = u[t] + acc[a ^ t]
                if cand > out[a]:
                    out[a] = cand
        return out

    def _cn_ems(self, V):
        """CLASSIC truncated-list Extended Min-Sum (Voicila/Declercq):
        incoming messages AND forward/backward partials truncated to their
        stable top-nm after every elementary merge; final outputs keep all
        computed configuration values. Matches nbldpc_tpu.decoders.ems
        (which implements the same scheme with masked dense vectors)."""
        spec, gf = self.spec, self.gf
        q = spec.q
        nm = min(self.nm or q, q)
        NEG = -1e30
        C = []
        for m in range(spec.m):
            vals = spec.row_vals[m]
            dc = len(vals)
            U = []
            for j in range(dc):
                msg = V[m][j] - V[m][j].max()
                hinv = gf.inv[vals[j]]
                perm = gf.mul[hinv, np.arange(q)]
                U.append(self._topnm_mask(msg[perm], nm))
            # F[j] = truncated merge of U[0..j-1]; F[1] = U[0] itself
            # (merge with the delta0 identity). B[j] likewise from the right.
            F = [None] * dc
            F[1] = U[0]
            for j in range(2, dc):
                F[j] = self._topnm_mask(
                    self._ems_merge_classic(F[j - 1], U[j - 1]), nm
                )
            B = [None] * dc
            B[dc - 2] = U[dc - 1]
            for j in range(dc - 3, -1, -1):
                B[j] = self._topnm_mask(
                    self._ems_merge_classic(B[j + 1], U[j + 1]), nm
                )
            row = []
            for j in range(dc):
                # edge outputs emit the COMPENSATED dense form (an
                # extrinsic of -inf at uncovered symbols would annihilate
                # the posterior); middle outputs are fully covered via the
                # acc side's dense form already
                if j == 0:
                    acc = B[0][1]
                elif j == dc - 1:
                    acc = F[dc - 1][1]
                else:
                    acc = self._ems_merge_classic(F[j], B[j])
                acc = np.minimum(acc - acc.max() + self.offset, 0.0)
                acc = np.maximum(acc, NEG)
                perm = gf.mul[vals[j], np.arange(q)]
                row.append(acc[perm])
            C.append(row)
        return C

    @staticmethod
    def _top_list_bubble(u, nm):
        """Sorted top-nm (vals desc, GF idxs, comp) — mirrors
        nbldpc_tpu.decoders.ems._top_list (+comp) exactly."""
        order = np.argsort(-u, kind="stable")[:nm]
        return u[order].copy(), order.astype(np.int64), u[order[-1]]

    @staticmethod
    def _merge_bubble(acc, op, pairs, nm, q):
        """Staircase candidate merge — mirrors ems._merge_bubble exactly:
        staircase candidates in lex (t, s) order AUGMENTED with
        min(2*nm, q) fresh-index fill candidates (value = the classic
        compensation f = opv_0 + acc_comp, GF indices 0..min(2nm,q)-1,
        appended after the staircase); below-floor pair candidates are
        dropped; top-nm by value with ties -> first enumeration
        position, dedup by GF index. This reproduces the classic
        scheme's partial-list tail: fewer-than-nm above-floor pairs ->
        fill with f at the LOWEST GF indices not already kept."""
        av, ai, acomp = acc
        bv, bi, _bcomp = op
        f = bv[0] + acomp
        nf = min(2 * nm, q)
        cv = np.array([av[t] + bv[s] for t, s in pairs], dtype=np.float64)
        cv[cv <= f] = -1e30
        cv = np.concatenate([cv, np.full(nf, f)])
        ci = np.array([ai[t] ^ bi[s] for t, s in pairs])
        ci = np.concatenate([ci, np.arange(nf)])
        vals, idxs = [], []
        run = cv.copy()
        for _ in range(nm):
            k = int(np.argmax(run))          # ties -> first enum position
            vals.append(run[k])
            idxs.append(int(ci[k]))
            run[ci == ci[k]] = -1e30         # dedup by GF index
        vals = np.maximum(np.array(vals), f)
        return vals, np.array(idxs, dtype=np.int64), vals[-1]

    @staticmethod
    def _scatter_bubble(lst, q):
        """List -> compensated dense — mirrors ems._scatter_list exactly
        (fill = the list's comp; largest wins at duplicate indices)."""
        vals, idxs, comp = lst
        out = np.full(q, comp)
        for t in reversed(range(len(vals))):
            out[idxs[t]] = vals[t]
        return out

    def _cn_ems_bubble(self, V):
        """BUBBLE EMS: list-based staircase merges — the co-designed
        oracle for nbldpc_tpu.decoders.ems merge="bubble". Sorted
        nm-lists merge via the static staircase candidate set
        {(t, s): (t+1)(s+1) <= 2 nm} (bubble_pairs, budget 2), augmented
        inside every merge with fresh-index fill candidates at the classic
        compensation floor (acc's compensation + op's best value); pairs
        outside the staircase are dropped, and the final outputs are dense
        scatters with the compensation fill."""
        from nbldpc_tpu.decoders.ems import bubble_pairs

        spec, gf = self.spec, self.gf
        q = spec.q
        nm = min(self.nm or q, q)
        NEG = -1e30
        pairs = bubble_pairs(nm)
        C = []
        for m in range(spec.m):
            vals = spec.row_vals[m]
            dc = len(vals)
            U = []
            for j in range(dc):
                msg = V[m][j] - V[m][j].max()
                hinv = gf.inv[vals[j]]
                perm = gf.mul[hinv, np.arange(q)]
                U.append(self._top_list_bubble(msg[perm], nm))
            F = [None] * dc
            F[1] = U[0]
            for j in range(2, dc):
                F[j] = self._merge_bubble(F[j - 1], U[j - 1], pairs, nm, q)
            B = [None] * dc
            B[dc - 2] = U[dc - 1]
            for j in range(dc - 3, -1, -1):
                B[j] = self._merge_bubble(B[j + 1], U[j + 1], pairs, nm, q)
            row = []
            for j in range(dc):
                if j == 0:
                    acc = self._scatter_bubble(B[0], q)
                elif j == dc - 1:
                    acc = self._scatter_bubble(F[dc - 1], q)
                else:
                    # FINAL merge: dense all-candidate scatter with the
                    # classic comp floor — mirrors ems._merge_bubble_dense
                    av, ai, acomp = F[j]
                    bv, bi, _ = B[j]
                    f = bv[0] + acomp
                    acc = np.full(q, f)
                    for t, s in pairs:
                        idx = int(ai[t] ^ bi[s])
                        val = av[t] + bv[s]
                        if val > acc[idx]:
                            acc[idx] = val
                acc = np.minimum(acc - acc.max() + self.offset, 0.0)
                acc = np.maximum(acc, NEG)
                perm = gf.mul[vals[j], np.arange(q)]
                row.append(acc[perm])
            C.append(row)
        return C

    def _cn_ems_legacy(self, V):
        """LEGACY round-1 EMS variant (dense-forward partials): kept ONLY to
        quantify its deviation from the classic truncated scheme
        (benchmarks/ems_variants.py). Do not use as a parity oracle."""
        spec, gf = self.spec, self.gf
        q = spec.q
        nm = min(self.nm or q, q)
        NEG = -1e30
        C = []
        for m in range(spec.m):
            vals = spec.row_vals[m]
            dc = len(vals)
            U = []
            for j in range(dc):
                msg = V[m][j] - V[m][j].max()
                hinv = gf.inv[vals[j]]
                perm = gf.mul[hinv, np.arange(q)]
                U.append(msg[perm])
            d0 = np.full(q, NEG)
            d0[0] = 0.0
            F = [d0]
            for j in range(dc - 1):
                F.append(self._ems_merge_dense_fwd(F[-1], U[j], nm))
            B = [d0]
            for j in range(dc - 1, 0, -1):
                B.append(self._ems_merge_dense_fwd(B[-1], U[j], nm))
            B = B[::-1]
            row = []
            for j in range(dc):
                acc = self._ems_merge_dense_fwd(F[j], B[j], nm)
                acc = np.minimum(acc - acc.max() + self.offset, 0.0)
                acc = np.maximum(acc, NEG)
                perm = gf.mul[vals[j], np.arange(q)]
                row.append(acc[perm])
            C.append(row)
        return C

    # --- T-EMS: delta-domain trellis with <=2 deviations ------------------
    def _cn_tems(self, V):
        """Trellis-EMS (Li/Declercq/Gunnam): delta-domain, one- and
        two-deviation paths from per-row (min1, argmin, min2); two-deviation
        column collisions fixed with min2 substitution. Matches
        nbldpc_tpu.decoders.tems exactly (same approximation)."""
        spec, gf = self.spec, self.gf
        q = spec.q
        NEG = -1e30
        C = []
        for m in range(spec.m):
            vals = spec.row_vals[m]
            dc = len(vals)
            U = np.zeros((dc, q))
            z = np.zeros(dc, dtype=np.int64)
            for j in range(dc):
                msg = V[m][j] - V[m][j].max()
                hinv = gf.inv[vals[j]]
                perm = gf.mul[hinv, np.arange(q)]
                u = msg[perm]
                z[j] = int(np.argmax(u))
                U[j] = u[np.arange(q) ^ z[j]] - u[z[j]]   # delta domain, <= 0
            beta = 0
            for j in range(dc):
                beta ^= int(z[j])
            # per-row top-3 (value, column) over the dc columns. Padding the
            # column axis to >= 3 with NEG keeps the scheme well-defined for
            # tiny dc; the framework does the same.
            Upad = np.concatenate([U, np.full((max(0, 3 - dc), q), NEG)], axis=0)
            order = np.argsort(-Upad, axis=0, kind="stable")
            t_col = order[:3]                        # [3, q]
            t_val = np.take_along_axis(Upad, t_col, axis=0)  # [3, q]
            # extrinsic for each column j and each total deviation eta
            row = []
            for j in range(dc):
                # best / second-best per row with column j excluded
                is_j = t_col == j                    # [3, q]
                m1x = np.where(is_j[0], t_val[1], t_val[0])
                c1x = np.where(is_j[0], t_col[1], t_col[0])
                m2x = np.where(
                    is_j[0], t_val[2], np.where(is_j[1], t_val[2], t_val[1])
                )
                if self.n_r:
                    # TRUNCATED one-sided search (mirrors
                    # tems._two_deviation_bubble exactly): e1 restricted
                    # to the n_r most reliable rows (by m1x, row 0
                    # excluded, ties -> lower row), e2 = eta ^ e1 free;
                    # one-deviation term stays exact.
                    run = m1x.copy()
                    run[0] = 2.0 * NEG
                    rows = np.argsort(-run, kind="stable")[: self.n_r]
                    dw = m1x.copy()
                    for e1 in (int(r) for r in rows):
                        for eta in range(1, q):
                            e2 = eta ^ e1
                            if e2 == 0:
                                continue
                            if c1x[e1] != c1x[e2]:
                                cand = m1x[e1] + m1x[e2]
                            else:
                                cand = max(m1x[e1] + m2x[e2],
                                           m2x[e1] + m1x[e2])
                            if cand > dw[eta]:
                                dw[eta] = cand
                    dw[0] = 0.0
                else:
                    dw = np.full(q, NEG)
                    dw[0] = 0.0
                    for eta in range(1, q):
                        best = m1x[eta]              # one deviation
                        for e1 in range(1, q):
                            e2 = eta ^ e1
                            if e2 == 0 or e1 > e2:
                                continue
                            if c1x[e1] != c1x[e2]:
                                cand = m1x[e1] + m1x[e2]
                            else:  # column collision: second-best substitute
                                cand = max(m1x[e1] + m2x[e2],
                                           m2x[e1] + m1x[e2])
                            if cand > best:
                                best = cand
                        dw[eta] = best
                # back to normal domain: C_j(a) = dW(a ^ beta ^ z_j)
                out = dw[np.arange(q) ^ (beta ^ z[j])]
                out = np.minimum(out - out.max() + self.offset, 0.0)
                perm = gf.mul[vals[j], np.arange(q)]
                row.append(np.maximum(out[perm], NEG))
            C.append(row)
        return C
