"""Fused QSPA check-node kernel (kernels/cn_qspa.py) and the backend
dispatch that chooses it.

On the CPU the kernel runs in Pallas interpret mode against the XLA update
(qspa.qspa_cn_update_bl), itself golden-tested against the numpy oracle.
The `gpu`-marked test runs the compiled kernel on the card.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from nbldpc_tpu.codegen import make_peg_code
from nbldpc_tpu.decoders import common, qspa
from nbldpc_tpu.graph import TannerGraph
from nbldpc_tpu.kernels import cn_qspa


def _random_u(graph, B, seed=0):
    """x-domain CN inputs with the real pad structure (via the real gather)."""
    Vv = jax.random.normal(
        jax.random.PRNGKey(seed), (graph.n, graph.dv_max, graph.q, B),
        jnp.float32) * 3.0
    return jax.jit(graph.gather_cn_x_bl)(Vv)


def _real_slots(graph, x):
    return np.where(np.asarray(graph.cn_mask_np)[:, :, None, None],
                    np.asarray(x), 0.0)


# Log-domain messages near the probability floor come out of a cancelling
# +/-1 sum, so a different summation order (dot against butterflies) moves
# them in the 4th decimal; 1e-3 absolute is the golden tests' oracle
# tolerance for log-domain messages.
@pytest.mark.parametrize("q,n,m,B", [(16, 16, 8, 32), (32, 24, 12, 32),
                                     (64, 12, 6, 32), (256, 20, 6, 16)])
def test_cn_kernel_interpret_matches_xla(q, n, m, B):
    g = TannerGraph(make_peg_code(n, m, q, dv=2, seed=3))
    U = _random_u(g, B)
    ref = jax.jit(lambda u: qspa.qspa_cn_update_bl(u, g))(U)
    out = cn_qspa.cn_update(U, interpret=True)
    np.testing.assert_allclose(_real_slots(g, out), _real_slots(g, ref),
                               rtol=0, atol=1e-3)


def test_cn_kernel_irregular_decode_interpret(small_codes):
    """Whole decode with the kernel in interpret mode on the dc-irregular
    code (pad slots arrive as log-delta0): same decisions as XLA."""
    from nbldpc_tpu.channel import ebn0_to_sigma, transmit

    spec = small_codes["gf16_irr"]
    g = TannerGraph(spec)
    assert g.has_cn_pads
    cw = jnp.zeros((16, spec.n), jnp.int32)
    llr = transmit(jax.random.PRNGKey(5), cw,
                   float(ebn0_to_sigma(2.0, spec.k / spec.n)), spec.q)
    ref = common.decode_bl(g, llr, qspa.qspa_cn_update_bl, 6)
    out = common.decode_bl(
        g, llr, lambda U, _g: cn_qspa.cn_update(U, interpret=True), 6)
    np.testing.assert_array_equal(np.asarray(ref.hard), np.asarray(out.hard))
    np.testing.assert_array_equal(np.asarray(ref.done), np.asarray(out.done))
    np.testing.assert_array_equal(np.asarray(ref.iters), np.asarray(out.iters))


@pytest.mark.parametrize("q,batch,tile", [(16, 4096, 64), (16, 20480, 64),
                                          (256, 4096, 16), (32, 96, 32),
                                          (16, 24, 0)])
def test_frame_tile(q, batch, tile):
    assert cn_qspa.frame_tile(q, batch) == tile


@pytest.mark.parametrize("backend,q,batch,kernel", [
    ("cpu", 16, 256, False),
    ("gpu", 16, 256, True),
    ("gpu", 256, 512, True),
    ("gpu", 4, 256, False),      # Triton's dot needs q >= 16
    ("gpu", 16, 24, False),      # no power-of-two frame tile divides 24
])
def test_backend_dispatch(monkeypatch, backend, q, batch, kernel):
    g = TannerGraph(make_peg_code(12, 6, q, dv=2, seed=3))
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    cn = qspa.cn_update_bl_for(g, batch)
    assert (cn is not qspa.qspa_cn_update_bl) == kernel


@pytest.mark.gpu
def test_cn_kernel_on_device_matches_xla():
    """Compiled kernel on the card against XLA at the flagship widths,
    with chip_smoke's log-domain message criterion."""
    from chip_smoke import LOG_TOL, QSPA_LOG_FLOOR, message_error
    from nbldpc_tpu.codegen import build_standard_code

    for name, B in (("gf16_n204_k102", 4096), ("gf256_n255_k175", 512)):
        g = TannerGraph(build_standard_code(name))
        U = _random_u(g, B, seed=2)
        ref = jax.jit(lambda u: qspa.qspa_cn_update_bl(u, g))(U)
        out = cn_qspa.cn_update(U)
        mask = np.asarray(g.cn_mask_np)[:, :, None, None]
        err = message_error(np.asarray(out), np.where(mask, ref, -np.inf),
                            QSPA_LOG_FLOOR)
        assert err <= LOG_TOL, (name, err)
