"""Tanner graph as dense padded index arrays for XLA gather/scatter decoding.

Design (SURVEY.md §2.1 C3, §2.2 K4): instead of the C++
reference's per-node pointer/edge lists, the graph is compiled into dense
[M, dc_max] / [N, dv_max] index matrices (padded + masked for irregular
codes) so every check-node and variable-node phase is a reshape + gather —
static shapes, no ragged ops, XLA-tileable.

Edge ordering is CN-major: edge slot (m, j) has flat id m * dc_max + j.
Messages live as [B, M, dc_max, q]; the VN phase gathers them into
[B, N, dv_max, q] via `vn_edge` and scatters back via the inverse
permutation `cn_slot_of_vn_slot` (a bijection between real slots, so the
scatter is itself a gather).

GF edge weights are precompiled into *permutation tables* (SURVEY.md K4):
  perm_down[m, j, a] = h_mj^{-1} * a   (variable->check: U(a) = V[perm_down])
  perm_up[m, j, a]   = h_mj * a        (check->variable: C(a) = Chat[perm_up])
so no field arithmetic runs in the decode loop — only index gathers.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from nbldpc_tpu.code import CodeSpec
from nbldpc_tpu.gf import get_field

# Log-domain "minus infinity" written into pad CN slots; exp(PAD_NEG) == 0.0
# exactly in f32, so softmax of a pad slot is exactly delta0.
PAD_NEG = -1e30


class TannerGraph:
    """Device-resident padded array form of a CodeSpec's Tanner graph."""

    def __init__(self, spec: CodeSpec):
        self.spec = spec
        gf = get_field(spec.q)
        self.gf = gf
        q, n, m = spec.q, spec.n, spec.m
        dc = spec.dc
        dv = spec.dv
        dc_max = int(dc.max())
        dv_max = int(dv.max())
        self.q, self.n, self.m = q, n, m
        self.dc_max, self.dv_max = dc_max, dv_max
        self.num_edges = spec.num_edges

        cn_vn = np.zeros((m, dc_max), dtype=np.int32)          # pad -> vn 0
        cn_w = np.ones((m, dc_max), dtype=np.int32)            # pad -> weight 1
        cn_mask = np.zeros((m, dc_max), dtype=bool)
        for mi, (cols, vals) in enumerate(zip(spec.row_cols, spec.row_vals)):
            cn_vn[mi, : len(cols)] = cols
            cn_w[mi, : len(cols)] = vals
            cn_mask[mi, : len(cols)] = True

        # VN-side slots: for each variable, the flat CN-major edge ids of its
        # incident edges; pad slots point at the appended dummy row (id m*dc_max).
        vn_edge = np.full((n, dv_max), m * dc_max, dtype=np.int32)
        vn_fill = np.zeros(n, dtype=np.int32)
        cn_slot_of_vn_slot = np.full((m, dc_max), n * dv_max, dtype=np.int32)
        for mi in range(m):
            for j in range(int(dc[mi])):
                v = int(cn_vn[mi, j])
                s = int(vn_fill[v])
                vn_edge[v, s] = mi * dc_max + j
                cn_slot_of_vn_slot[mi, j] = v * dv_max + s
                vn_fill[v] += 1
        assert np.array_equal(vn_fill, dv), "edge bookkeeping mismatch"
        vn_mask = np.arange(dv_max)[None, :] < dv[:, None]

        # GF-weight permutation tables [M, dc_max, q] (K4)
        a = np.arange(q, dtype=np.int64)
        w = cn_w.astype(np.int64)
        perm_down = gf.mul[gf.inv[w][:, :, None], a[None, None, :]]
        perm_up = gf.mul[w[:, :, None], a[None, None, :]]

        # Combined routing + permutation tables: fold the per-edge GF weight
        # permutation INTO the message-routing gather, so check-node updates
        # see messages already in the "x = h*c" domain and never gather.
        # One XLA gather per phase replaces routing gather + q-permutation.
        #   down_idx: (VN-major V, c-domain) -> (CN-major U, x-domain)
        #   up_idx:   (CN-major Chat, x-domain) -> (VN-major C, c-domain)
        # Pad slots point at one appended zero scalar (index = size of flat).
        # Pad CN slots read an appended q-row log-delta0 block (0 at symbol 0,
        # -BIG elsewhere): softmax of a pad slot is then the WHT-convolution
        # identity delta0, its log-magnitude spectrum contributes exactly 0 to
        # the leave-one-out sum, and the CN update needs NO masks — pure
        # elementwise + WHT + reduction (the Pallas K1 contract).
        vn_flat_size = n * dv_max * q
        cn_flat_size = m * dc_max * q
        down_idx = np.where(
            cn_mask[:, :, None],
            cn_slot_of_vn_slot[:, :, None].astype(np.int64) * q + perm_down,
            vn_flat_size + a[None, None, :],
        ).astype(np.int32)
        pu_flat = perm_up.reshape(m * dc_max, q)
        ve = vn_edge.astype(np.int64)
        up_idx = np.where(
            vn_mask[:, :, None],
            ve[:, :, None] * q + pu_flat[np.minimum(ve, m * dc_max - 1)],
            cn_flat_size,
        ).astype(np.int32)

        # Degree-regularity flags: regular codes skip pad fixups entirely.
        self.has_cn_pads = not bool(cn_mask.all())
        self.has_vn_pads = not bool(vn_mask.all())

        # Syndrome bit-decomposition tables: syn_k[m, j, t] = h_mj * alpha-
        # basis element 2^t (0 on pad slots), so h*c = XOR_t bit_t(c)*syn_k.
        pows = (1 << np.arange(gf.p)).astype(np.int64)
        syn_k = gf.mul[cn_w.astype(np.int64)[:, :, None], pows[None, None, :]]
        syn_k = np.where(cn_mask[:, :, None], syn_k, 0).astype(np.int32)
        self.syn_k = jnp.asarray(syn_k)

        # host copies
        self.cn_vn_np = cn_vn
        self.cn_w_np = cn_w
        self.cn_mask_np = cn_mask
        self.vn_edge_np = vn_edge
        self.vn_mask_np = vn_mask

        # device constants
        self.cn_vn = jnp.asarray(cn_vn)
        self.cn_w = jnp.asarray(cn_w)
        self.cn_mask = jnp.asarray(cn_mask)
        self.vn_edge = jnp.asarray(vn_edge)
        self.vn_mask = jnp.asarray(vn_mask)
        self.cn_slot_of_vn_slot = jnp.asarray(cn_slot_of_vn_slot)
        self.perm_down = jnp.asarray(perm_down.astype(np.int32))
        self.perm_up = jnp.asarray(perm_up.astype(np.int32))
        self.down_idx = jnp.asarray(down_idx)
        self.up_idx = jnp.asarray(up_idx)
        self.mul = jnp.asarray(gf.mul)

    # ---- message routing (pure gathers; batch dims lead) ----

    def gather_vn(self, C: jnp.ndarray) -> jnp.ndarray:
        """CN-major messages [B, M, dc_max, q] -> VN-major [B, N, dv_max, q].

        Pad VN slots read an appended all-zero dummy row (log-domain identity).
        """
        B = C.shape[0]
        flat = C.reshape(B, self.m * self.dc_max, self.q)
        flat = jnp.concatenate([flat, jnp.zeros((B, 1, self.q), C.dtype)], axis=1)
        out = jnp.take(flat, self.vn_edge.reshape(-1), axis=1)
        return out.reshape(B, self.n, self.dv_max, self.q)

    def gather_cn(self, Vv: jnp.ndarray) -> jnp.ndarray:
        """VN-major messages [B, N, dv_max, q] -> CN-major [B, M, dc_max, q].

        Pad CN slots read an appended all-zero dummy row; CN updates must mask
        them anyway (cn_mask).
        """
        B = Vv.shape[0]
        flat = Vv.reshape(B, self.n * self.dv_max, self.q)
        flat = jnp.concatenate([flat, jnp.zeros((B, 1, self.q), Vv.dtype)], axis=1)
        out = jnp.take(flat, self.cn_slot_of_vn_slot.reshape(-1), axis=1)
        return out.reshape(B, self.m, self.dc_max, self.q)

    def _pad_block(self, dtype) -> jnp.ndarray:
        """Log-domain delta0 read by pad CN slots: [q] = (0, -BIG, ..., -BIG).

        softmax(pad slot) == delta0 == the WHT-convolution identity, so CN
        updates need no pad masking (see down_idx construction)."""
        return jnp.full((self.q,), PAD_NEG, dtype).at[0].set(0.0)

    def gather_cn_x(self, Vv: jnp.ndarray) -> jnp.ndarray:
        """VN-major c-domain messages [B, N, dv_max, q] -> CN-major x-domain
        U [B, M, dc_max, q] with U_e(a) = V_e(h_e^{-1} a): routing and GF
        permutation in ONE gather. Pad slots become log-delta0 via a fused
        `where` (no full-array concat copy); skipped for CN-regular codes."""
        B = Vv.shape[0]
        flat = Vv.reshape(B, -1)
        out = jnp.take(flat, self.down_idx.reshape(-1), axis=1, mode="clip")
        out = out.reshape(B, self.m, self.dc_max, self.q)
        if self.has_cn_pads:
            out = jnp.where(
                self.cn_mask[None, :, :, None], out, self._pad_block(Vv.dtype)
            )
        return out

    def gather_vn_x(self, Chat: jnp.ndarray) -> jnp.ndarray:
        """CN-major x-domain messages [B, M, dc_max, q] -> VN-major c-domain
        C [B, N, dv_max, q] with C_e(a) = Chat_e(h_e a): routing and GF
        permutation in ONE gather. Pad slots -> 0 (additive identity) via a
        fused `where`; skipped for VN-regular codes."""
        B = Chat.shape[0]
        flat = Chat.reshape(B, -1)
        out = jnp.take(flat, self.up_idx.reshape(-1), axis=1, mode="clip")
        out = out.reshape(B, self.n, self.dv_max, self.q)
        if self.has_vn_pads:
            out = jnp.where(self.vn_mask[None, :, :, None], out, 0.0)
        return out

    # ---- batch-last routing (the simulator's layout: frame batch last) ----
    #
    # Messages are [M, dc_max, q, B] / [N, dv_max, q, B]: routing gathers
    # move contiguous length-B rows of the Monte-Carlo batch.

    def gather_vn_x_bl(self, Chat: jnp.ndarray) -> jnp.ndarray:
        """[M, dc_max, q, B] x-domain -> [N, dv_max, q, B] c-domain.

        No pad-row concat (that would copy the whole array): pad indices are
        clipped by jnp.take and fixed up with a fused `where` -> 0 (the
        additive identity for the posterior sum) — skipped entirely for
        VN-regular codes."""
        flat = Chat.reshape(-1, Chat.shape[-1])
        out = jnp.take(flat, self.up_idx.reshape(-1), axis=0, mode="clip")
        out = out.reshape(self.n, self.dv_max, self.q, -1)
        if self.has_vn_pads:
            out = jnp.where(self.vn_mask[:, :, None, None], out, 0.0)
        return out

    def gather_cn_x_bl(self, Vv: jnp.ndarray) -> jnp.ndarray:
        """[N, dv_max, q, B] c-domain -> [M, dc_max, q, B] x-domain.

        Pad slots become log-delta0 via a fused `where` (no concat copy);
        skipped entirely for CN-regular codes."""
        flat = Vv.reshape(-1, Vv.shape[-1])
        out = jnp.take(flat, self.down_idx.reshape(-1), axis=0, mode="clip")
        out = out.reshape(self.m, self.dc_max, self.q, -1)
        if self.has_cn_pads:
            out = jnp.where(
                self.cn_mask[:, :, None, None],
                out,
                self._pad_block(Vv.dtype)[:, None],
            )
        return out

    def syndrome_bl(self, hard: jnp.ndarray) -> jnp.ndarray:
        """hard [N, B] int32 -> syndrome [M, B] int32 (0 == satisfied).

        GF-multiply by the (static) edge weight via bit decomposition:
        h*c = XOR_t ((c >> t) & 1) * mul[h, 2^t] — the per-edge tables
        syn_k [M, dc, p] are precomputed (0 on pad slots), so the whole
        syndrome is shifts/ands/multiplies + an XOR reduce: no per-element
        table gathers."""
        sym = jnp.take(hard, self.cn_vn.reshape(-1), axis=0).reshape(
            self.m, self.dc_max, -1
        )
        x = jnp.zeros_like(sym)
        for t in range(self.gf.p):
            x = x ^ (((sym >> t) & 1) * self.syn_k[:, :, t : t + 1])
        return jax_xor_reduce(x, axis=1)

    def permute_down(self, V: jnp.ndarray) -> jnp.ndarray:
        """Apply per-edge GF weight: U(a) = V(h^{-1} a). V: [B, M, dc_max, q]."""
        return jnp.take_along_axis(V, self.perm_down[None], axis=-1)

    def permute_up(self, Chat: jnp.ndarray) -> jnp.ndarray:
        """Inverse weight map: C(a) = Chat(h a). Chat: [B, M, dc_max, q]."""
        return jnp.take_along_axis(Chat, self.perm_up[None], axis=-1)

    def syndrome(self, hard: jnp.ndarray) -> jnp.ndarray:
        """hard [B, N] int32 -> syndrome [B, M] int32 (0 == satisfied).

        s_m = XOR_j mul[h_mj, hard[vn_mj]] over real slots (SURVEY.md C12).
        """
        sym = jnp.take(hard, self.cn_vn.reshape(-1), axis=-1).reshape(
            hard.shape[0], self.m, self.dc_max
        )
        # bit-decomposed GF multiply by the static edge weight (see
        # syndrome_bl): no per-element table gathers; pads have syn_k == 0.
        x = jnp.zeros_like(sym)
        for t in range(self.gf.p):
            x = x ^ (((sym >> t) & 1) * self.syn_k[None, :, :, t])
        return jax_xor_reduce(x, axis=-1)


def jax_xor_reduce(x: jnp.ndarray, axis: int) -> jnp.ndarray:
    import jax

    return jax.lax.reduce(
        x, np.int32(0), jax.lax.bitwise_xor, dimensions=(axis % x.ndim,)
    )
