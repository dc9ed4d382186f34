"""The XLA decode path on code shapes the golden tests do not otherwise
reach: irregular check degree, variable degree 3, GF(32) and truncated
nm < q; the fixed-budget throughput mode; and what the CPU compiles.

Each decoder runs batch-last (common.decode_bl), as the simulator does, and
is compared frame for frame with the numpy oracle (tests/reference_model.py).
"""

import numpy as np
import pytest
import jax
import jax.extend
import jax.numpy as jnp

from nbldpc_tpu.decoders import ems, qspa, tems
from nbldpc_tpu.graph import TannerGraph

from tests.reference_model import OracleDecoder
from tests.test_golden import _noisy_llrs

CODES = ["gf16_irr", "gf4_dv3", "gf32_small"]


def _decoders(spec):
    """(decoder fn, oracle kwargs) per decoder, with nm < q for EMS."""
    nm = max(2, spec.q // 4)
    return {
        "qspa": (lambda g, x, it: qspa.decode(g, x, it),
                 dict(kind="qspa")),
        "ems": (lambda g, x, it: ems.decode(g, x, it, nm=nm, offset=0.2),
                dict(kind="ems", nm=nm, offset=0.2)),
        "ems_bubble": (lambda g, x, it: ems.decode(g, x, it, nm=nm,
                                                   merge="bubble"),
                       dict(kind="ems_bubble", nm=nm)),
        "tems": (lambda g, x, it: tems.decode(g, x, it, offset=0.5),
                 dict(kind="tems", offset=0.5)),
    }


@pytest.mark.parametrize("decoder", ["qspa", "ems", "ems_bubble", "tems"])
@pytest.mark.parametrize("code_name", CODES)
def test_xla_path_matches_oracle(small_codes, code_name, decoder):
    spec = small_codes[code_name]
    if code_name == "gf16_irr":
        assert TannerGraph(spec).has_cn_pads, "fixture must be dc-irregular"
    g, cw, llr = _noisy_llrs(spec, 8, 2.5, seed=51)
    fn, okw = _decoders(spec)[decoder]
    res = jax.jit(lambda x: fn(g, x, 6))(jnp.asarray(llr))
    oracle = OracleDecoder(spec, **okw)
    for b in range(llr.shape[0]):
        hard_o, done_o, iters_o = oracle.decode(llr[b], max_iters=6)
        np.testing.assert_array_equal(np.asarray(res.hard)[b], hard_o,
                                      err_msg=f"frame {b}")
        assert bool(np.asarray(res.done)[b]) == done_o, f"frame {b}"
        assert int(np.asarray(res.iters)[b]) == iters_o, f"frame {b}"


THROUGHPUT = {
    "ems": lambda g, x, s: ems.decode(g, x, 6, nm=8, early_term=False,
                                      stats_each_iter=s),
    "ems_bubble": lambda g, x, s: ems.decode(g, x, 6, nm=8, merge="bubble",
                                             early_term=False,
                                             stats_each_iter=s),
    "tems": lambda g, x, s: tems.decode(g, x, 6, n_r=4, early_term=False,
                                        stats_each_iter=s),
}


@pytest.mark.parametrize("decoder", sorted(THROUGHPUT))
def test_throughput_mode_contract(small_codes, decoder):
    """stats_each_iter=False (fixed budget, no per-iteration bookkeeping)
    keeps the done flags and, for converged frames, the hard decisions of
    the bookkeeping mode (converged frames stay at their fixed point);
    iters reports the budget, or 0 for frames already satisfied at
    initialization."""
    spec = small_codes["gf16_tiny"]
    g, cw, llr = _noisy_llrs(spec, 16, 3.5, seed=52)
    x = jnp.asarray(llr)
    full = jax.jit(lambda v: THROUGHPUT[decoder](g, v, True))(x)
    thru = jax.jit(lambda v: THROUGHPUT[decoder](g, v, False))(x)
    done = np.asarray(full.done)
    assert done.any(), "some frames must converge at this SNR"
    np.testing.assert_array_equal(done, np.asarray(thru.done))
    np.testing.assert_array_equal(np.asarray(full.hard)[done],
                                  np.asarray(thru.hard)[done])
    init_ok = np.all(np.asarray(g.syndrome(jnp.asarray(
        np.argmax(llr, axis=-1).astype(np.int32)))) == 0, axis=-1)
    np.testing.assert_array_equal(np.asarray(thru.iters),
                                  np.where(init_ok, 0, 6))


def _primitives(jaxpr):
    """Names of every primitive in a jaxpr, sub-jaxprs included."""
    out = set()
    for eqn in jaxpr.eqns:
        out.add(eqn.primitive.name)
        for v in eqn.params.values():
            for j in (v if isinstance(v, (list, tuple)) else [v]):
                if isinstance(j, jax.extend.core.ClosedJaxpr):
                    out |= _primitives(j.jaxpr)
                elif isinstance(j, jax.extend.core.Jaxpr):
                    out |= _primitives(j)
    return out


@pytest.mark.parametrize("kind", ["qspa", "ems", "tems"])
def test_cpu_decode_has_no_pallas_call(small_codes, kind):
    """On the CPU every decoder is plain XLA: no pallas_call anywhere in
    the traced decode (the fused kernel is chosen only on a GPU)."""
    from nbldpc_tpu.sim import get_decode_fn
    from nbldpc_tpu.utils.config import DecoderConfig

    assert jax.default_backend() == "cpu"
    spec = small_codes["gf16_tiny"]
    g = TannerGraph(spec)
    fn = get_decode_fn(DecoderConfig(kind=kind, max_iters=3, nm=8))
    llr = jnp.zeros((64, spec.n, spec.q), jnp.float32)
    prims = _primitives(jax.make_jaxpr(lambda x: fn(g, x).hard)(llr).jaxpr)
    assert "while" in prims          # the walk reaches the decode loop body
    assert "pallas_call" not in prims
