"""Edge-dimension-sharded decoding — the sequence-parallel analog
(SURVEY.md §2.3 SP/CP row, §5.7).

For very long codes (N >> 1e4) a single frame's messages no longer amortize
on one chip; here the *code* dimensions shard across the mesh axis 'edge':
check-node messages [M, dc, q, B] split over M, variable-node state
[N, dv|q, B] split over N. The CN and VN updates are local to their shards;
the two routing gathers are the only cross-shard exchanges, and XLA/GSPMD
lowers them to all-to-alls between the CN-major and VN-major layouts —
exactly the Ulysses-style resharding the survey prefers for small dv.

Implementation: the standard batch-last loop annotated with
`with_sharding_constraint` at the layout switch points; the compiler
chooses collective schedules (explicit ppermute halo exchange would fight
GSPMD, not help it).

Same update equations as decoders/common.py::decode_bl — tests pin
hard/done/iters equality against the unsharded path on a virtual mesh.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from nbldpc_tpu.decoders import common
from nbldpc_tpu.graph import TannerGraph


def decode_edge_sharded(
    graph: TannerGraph,
    llr: jnp.ndarray,
    mesh: Mesh,
    cn_update_bl: common.CnUpdateFn,
    max_iters: int,
    early_term: bool = True,
    axis: str = "edge",
) -> common.DecodeResult:
    """llr [B, N, q] -> DecodeResult, with the code graph sharded over
    `axis` of `mesh` (checks over M, variables over N)."""
    cn_sh = NamedSharding(mesh, P(axis))          # leading M axis
    vn_sh = NamedSharding(mesh, P(axis))          # leading N axis
    rep = NamedSharding(mesh, P())

    def cs(x, sh):
        return jax.lax.with_sharding_constraint(x, sh)

    B = llr.shape[0]
    llr_t = jnp.transpose(llr, (1, 2, 0))                     # [N, q, B]
    llr_t = cs(llr_t - jnp.max(llr_t, axis=1, keepdims=True), vn_sh)
    Cv0 = cs(jnp.zeros((graph.n, graph.dv_max, graph.q, B), llr_t.dtype), vn_sh)
    hard0 = jnp.argmax(llr_t, axis=1).astype(jnp.int32)
    done0 = jnp.all(cs(graph.syndrome_bl(hard0), cn_sh) == 0, axis=0)

    st = common._StateBL(
        Cv=Cv0, posterior=llr_t, hard=hard0,
        done=done0, iters=jnp.zeros((B,), jnp.int32),
        it=jnp.asarray(0, jnp.int32),
    )

    def body(st):
        Vv = st.posterior[:, None] - st.Cv
        Vv = cs(Vv - jnp.max(Vv, axis=2, keepdims=True), vn_sh)
        U = cs(graph.gather_cn_x_bl(Vv), cn_sh)     # VN-major -> CN-major: a2a
        Chat = cs(cn_update_bl(U, graph), cn_sh)    # local to CN shards
        Cv = cs(graph.gather_vn_x_bl(Chat), vn_sh)  # CN-major -> VN-major: a2a
        posterior = cs(llr_t + jnp.sum(Cv, axis=1), vn_sh)
        hard_new = jnp.argmax(posterior, axis=1).astype(jnp.int32)
        done_new = jnp.all(cs(graph.syndrome_bl(hard_new), cn_sh) == 0, axis=0)
        return common._StateBL(
            Cv=Cv, posterior=posterior,
            hard=jnp.where(st.done[None, :], st.hard, hard_new),
            done=st.done | done_new,
            iters=st.iters + (~st.done).astype(jnp.int32),
            it=st.it + 1,
        )

    if early_term:
        st = jax.lax.while_loop(
            lambda s: (s.it < max_iters) & ~jnp.all(s.done), body, st
        )
    else:
        st = jax.lax.fori_loop(0, max_iters, lambda _, s: body(s), st)
    hard = jax.lax.with_sharding_constraint(st.hard.T, rep)
    return common.DecodeResult(hard=hard, done=st.done, iters=st.iters)
