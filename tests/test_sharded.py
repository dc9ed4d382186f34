"""Edge-dimension (sequence-parallel analog) sharded decoding tests
(SURVEY.md §2.3 SP row): GSPMD-sharded decode over an 8-device 'edge' mesh
must equal the unsharded batch-last decode exactly."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from nbldpc_tpu.codegen import make_peg_code
from nbldpc_tpu.decoders import qspa, sharded
from nbldpc_tpu.graph import TannerGraph
from nbldpc_tpu.channel import ebn0_to_sigma, transmit
from nbldpc_tpu.encode import Encoder


def _edge_mesh():
    return Mesh(np.asarray(jax.devices()).reshape(-1), ("edge",))


def test_edge_sharded_matches_unsharded():
    spec = make_peg_code(64, 32, 16, dv=2, seed=2)  # M=32, N=64: /8 shards
    g = TannerGraph(spec)
    enc = Encoder(spec)
    u = jax.random.randint(jax.random.PRNGKey(0), (8, enc.k), 0, spec.q, jnp.int32)
    cw = enc.encode(u)
    sigma = float(ebn0_to_sigma(2.0, spec.k / spec.n))
    llr = transmit(jax.random.PRNGKey(1), cw, sigma, spec.q)

    ref = qspa.decode(g, llr, max_iters=6, early_term=True)
    mesh = _edge_mesh()
    with mesh:
        out = jax.jit(
            lambda x: sharded.decode_edge_sharded(
                g, x, mesh, qspa.qspa_cn_update_bl, 6, early_term=True
            )
        )(llr)
    np.testing.assert_array_equal(np.array(ref.hard), np.array(out.hard))
    np.testing.assert_array_equal(np.array(ref.done), np.array(out.done))
    np.testing.assert_array_equal(np.array(ref.iters), np.array(out.iters))


def test_edge_sharded_fixed_budget():
    spec = make_peg_code(32, 16, 4, dv=2, seed=3)
    g = TannerGraph(spec)
    llr = jax.random.normal(jax.random.PRNGKey(4), (4, spec.n, spec.q)) * 3.0
    ref = qspa.decode(g, llr, max_iters=4, early_term=False)
    mesh = _edge_mesh()
    with mesh:
        out = jax.jit(
            lambda x: sharded.decode_edge_sharded(
                g, x, mesh, qspa.qspa_cn_update_bl, 4, early_term=False
            )
        )(llr)
    np.testing.assert_array_equal(np.array(ref.hard), np.array(out.hard))
