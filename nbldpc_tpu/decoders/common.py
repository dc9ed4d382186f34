"""Shared decoder skeleton: VN update, tentative decision, syndrome loop.

SURVEY.md C11/C12 + §3.2: all three decoders (QSPA/EMS/T-EMS) share
    init V = prior -> [CN update -> VN update -> decision -> syndrome] x iters
with early termination on zero syndrome. This module implements the loop as a
`lax.fori_loop` (fixed budget — the BASELINE.json throughput metric) or
`lax.while_loop` (early termination) over a per-frame done-mask; converged
frames are frozen with `where` so their hard decisions are preserved while
the rest of the batch keeps iterating (no dynamic shapes — XLA-friendly).

Message convention: log-domain, CN-major [B, M, dc_max, q], normalized so
max over q = 0. Prior llr: [B, N, q] log-likelihoods (any normalization).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from nbldpc_tpu.graph import TannerGraph


class DecodeResult(NamedTuple):
    hard: jnp.ndarray    # [B, N] int32 tentative symbol decisions
    done: jnp.ndarray    # [B] bool — syndrome satisfied
    iters: jnp.ndarray   # [B] int32 — iterations run until convergence/budget


class _State(NamedTuple):
    Cv: jnp.ndarray        # [B, N, dv_max, q] check->var extrinsic, VN-major
    posterior: jnp.ndarray # [B, N, q]
    hard: jnp.ndarray      # [B, N]
    done: jnp.ndarray      # [B]
    iters: jnp.ndarray     # [B]
    it: jnp.ndarray        # () loop counter


CnUpdateFn = Callable[[jnp.ndarray, TannerGraph], jnp.ndarray]


def vn_update(
    graph: TannerGraph, llr: jnp.ndarray, C: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Variable-node phase.

    C is the check->var extrinsic in the x-domain (x = h*c); both gathers
    fold the GF weight permutation into the routing (graph.down_idx/up_idx),
    so CN updates are gather-free.

    Returns (U, posterior, hard):
      U [B, M, dc_max, q] — var->check messages in the x-domain
                            (leave-one-out, normalized)
      posterior [B, N, q] — prior + sum of all extrinsics (c-domain)
      hard [B, N] — argmax of posterior
    """
    Cv = graph.gather_vn_x(C)                                 # [B, N, dv, q]
    posterior = llr + jnp.sum(Cv, axis=2)                     # pad rows are 0
    Vv = posterior[:, :, None, :] - Cv                        # leave-one-out
    Vv = Vv - jnp.max(Vv, axis=-1, keepdims=True)             # normalize
    U = graph.gather_cn_x(Vv)                                 # [B, M, dc, q]
    hard = jnp.argmax(posterior, axis=-1).astype(jnp.int32)
    return U, posterior, hard


def decode(
    graph: TannerGraph,
    llr: jnp.ndarray,
    cn_update: CnUpdateFn,
    max_iters: int,
    early_term: bool = True,
) -> DecodeResult:
    """Run iterative BP decoding. Pure and jittable; vmap-free batched.

    Same traffic-minimizing structure as decode_bl: the state carries the
    VN-major (already-gathered) extrinsics + posterior, so each iteration
    does exactly one down-gather and one up-gather; only the small
    hard/done/iters outputs are frozen for converged frames.
    """
    B = llr.shape[0]
    llr = llr - jnp.max(llr, axis=-1, keepdims=True)
    Cv0 = jnp.zeros((B, graph.n, graph.dv_max, graph.q), llr.dtype)
    hard0 = jnp.argmax(llr, axis=-1).astype(jnp.int32)
    done0 = jnp.all(graph.syndrome(hard0) == 0, axis=-1)
    st = _State(
        Cv=Cv0,
        posterior=llr,
        hard=hard0,
        done=done0,
        iters=jnp.zeros((B,), jnp.int32),
        it=jnp.asarray(0, jnp.int32),
    )

    def body(st: _State) -> _State:
        with jax.named_scope("vn_update"):
            Vv = st.posterior[:, :, None, :] - st.Cv          # leave-one-out
            Vv = Vv - jnp.max(Vv, axis=-1, keepdims=True)
            U = graph.gather_cn_x(Vv)
        with jax.named_scope("cn_update"):
            C_new = cn_update(U, graph)
        with jax.named_scope("posterior"):
            Cv = graph.gather_vn_x(C_new)
            posterior = llr + jnp.sum(Cv, axis=2)
            hard_new = jnp.argmax(posterior, axis=-1).astype(jnp.int32)
        with jax.named_scope("syndrome"):
            done_new = jnp.all(graph.syndrome(hard_new) == 0, axis=-1)
        active = ~st.done
        hard = jnp.where(st.done[:, None], st.hard, hard_new)
        return _State(
            Cv=Cv,
            posterior=posterior,
            hard=hard,
            done=st.done | done_new,
            iters=st.iters + active.astype(jnp.int32),
            it=st.it + 1,
        )

    if early_term:
        st = jax.lax.while_loop(
            lambda s: (s.it < max_iters) & ~jnp.all(s.done), body, st
        )
    else:
        st = jax.lax.fori_loop(0, max_iters, lambda _, s: body(s), st)
    return DecodeResult(hard=st.hard, done=st.done, iters=st.iters)


def _decision(graph: TannerGraph, llr, C):
    Cv = graph.gather_vn_x(C)
    posterior = llr + jnp.sum(Cv, axis=2)
    hard = jnp.argmax(posterior, axis=-1).astype(jnp.int32)
    return Cv, posterior, hard


# ---------------------------------------------------------------------------
# Batch-last path (the one the simulator runs: Monte-Carlo batch last)
#
# Messages: [M, dc_max, q, B]; priors: [N, q, B]; hard: [N, B]. Elementwise
# ops run over contiguous frames, routing gathers move contiguous length-B
# rows, and reductions are over small leading axes.
# Semantics are identical to the q-last path above (same update equations).
# ---------------------------------------------------------------------------


def vn_update_bl(
    graph: TannerGraph, llr: jnp.ndarray, C: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Batch-last VN phase. llr [N, q, B]; C [M, dc_max, q, B] (x-domain).

    Returns (U [M, dc, q, B], posterior [N, q, B], hard [N, B])."""
    Cv = graph.gather_vn_x_bl(C)                              # [N, dv, q, B]
    posterior = llr + jnp.sum(Cv, axis=1)                     # pad rows are 0
    Vv = posterior[:, None] - Cv                              # leave-one-out
    Vv = Vv - jnp.max(Vv, axis=2, keepdims=True)              # normalize (q)
    U = graph.gather_cn_x_bl(Vv)                              # [M, dc, q, B]
    hard = jnp.argmax(posterior, axis=1).astype(jnp.int32)    # [N, B]
    return U, posterior, hard


def _decision_bl(graph: TannerGraph, llr, C):
    Cv = graph.gather_vn_x_bl(C)
    posterior = llr + jnp.sum(Cv, axis=1)
    hard = jnp.argmax(posterior, axis=1).astype(jnp.int32)
    return posterior, hard


class _StateBL(NamedTuple):
    Cv: jnp.ndarray        # [N, dv_max, q, B] check->var extrinsic, VN-major
    posterior: jnp.ndarray # [N, q, B] llr + sum(Cv)
    hard: jnp.ndarray      # [N, B]
    done: jnp.ndarray      # [B]
    iters: jnp.ndarray     # [B]
    it: jnp.ndarray


def decode_bl(
    graph: TannerGraph,
    llr: jnp.ndarray,
    cn_update_bl: CnUpdateFn,
    max_iters: int,
    early_term: bool = True,
    stats_each_iter: bool = True,
) -> DecodeResult:
    """Batch-last decode. llr [B, N, q] public layout; transposed once at
    entry/exit (amortized over max_iters iterations).

    Traffic-minimizing loop structure: the state carries the extrinsics in
    VN-major (already-gathered) form plus the posterior, so each iteration
    does exactly ONE down-gather and ONE up-gather; messages are never
    frozen for converged frames (only the tiny hard/done/iters outputs are —
    messages don't affect outputs once a frame's hard decision is frozen).

    stats_each_iter=False (fixed-budget throughput mode, forced True when
    early_term is set) skips the per-iteration argmax + syndrome — at large
    q those cost a meaningful slice of the iteration, and only the post-loop decision affects the outputs; iters then reports
    max_iters (0 for frames already satisfied at initialization)."""
    B = llr.shape[0]
    stats_each_iter = bool(stats_each_iter) or early_term
    llr = jnp.transpose(llr, (1, 2, 0))                       # [N, q, B]
    llr = llr - jnp.max(llr, axis=1, keepdims=True)
    Cv0 = jnp.zeros((graph.n, graph.dv_max, graph.q, B), llr.dtype)
    hard0 = jnp.argmax(llr, axis=1).astype(jnp.int32)         # [N, B]
    done0 = jnp.all(graph.syndrome_bl(hard0) == 0, axis=0)    # [B]
    st = _StateBL(
        Cv=Cv0,
        posterior=llr,
        hard=hard0,
        done=done0,
        iters=jnp.zeros((B,), jnp.int32),
        it=jnp.asarray(0, jnp.int32),
    )

    def body(st: _StateBL) -> _StateBL:
        with jax.named_scope("vn_update"):
            Vv = st.posterior[:, None] - st.Cv                # leave-one-out
            Vv = Vv - jnp.max(Vv, axis=2, keepdims=True)      # normalize (q)
            U = graph.gather_cn_x_bl(Vv)                      # [M, dc, q, B]
        with jax.named_scope("cn_update"):
            Chat = cn_update_bl(U, graph)
        with jax.named_scope("posterior"):
            Cv = graph.gather_vn_x_bl(Chat)                   # [N, dv, q, B]
            posterior = llr + jnp.sum(Cv, axis=1)
        if not stats_each_iter:
            # st.done is frozen at its init value in this mode, so frames
            # whose syndrome was already satisfied at initialization report
            # 0 iterations (iters = max_iters * (1 - done0)); everyone
            # else reports
            # max_iters.
            return st._replace(
                Cv=Cv,
                posterior=posterior,
                iters=st.iters + (~st.done).astype(jnp.int32),
                it=st.it + 1,
            )
        hard_new = jnp.argmax(posterior, axis=1).astype(jnp.int32)
        with jax.named_scope("syndrome"):
            done_new = jnp.all(graph.syndrome_bl(hard_new) == 0, axis=0)
        active = ~st.done
        hard = jnp.where(st.done[None, :], st.hard, hard_new)
        return _StateBL(
            Cv=Cv,
            posterior=posterior,
            hard=hard,
            done=st.done | done_new,
            iters=st.iters + active.astype(jnp.int32),
            it=st.it + 1,
        )

    if early_term:
        st = jax.lax.while_loop(
            lambda s: (s.it < max_iters) & ~jnp.all(s.done), body, st
        )
    else:
        st = jax.lax.fori_loop(0, max_iters, lambda _, s: body(s), st)
    if not stats_each_iter:
        hard = jnp.argmax(st.posterior, axis=1).astype(jnp.int32)
        done = jnp.all(graph.syndrome_bl(hard) == 0, axis=0)
        return DecodeResult(hard=hard.T, done=done, iters=st.iters)
    return DecodeResult(hard=st.hard.T, done=st.done, iters=st.iters)
