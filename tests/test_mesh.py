"""Mesh/sharding tests on 8 virtual CPU devices (SURVEY.md §4.6).

Determinism contract: counters must be identical for any mesh shape and for
the unsharded run — this replaces "race detection" for the device runtime
(SURVEY.md §5.2).
"""

import dataclasses

import numpy as np
import pytest
import jax

from nbldpc_tpu import sim
from nbldpc_tpu.parallel.mesh import make_mesh


@pytest.fixture(scope="module")
def cfg8(tmp_path_factory):
    from nbldpc_tpu.code import save_alist
    from nbldpc_tpu.codegen import make_peg_code
    from nbldpc_tpu.utils.config import (
        ChannelConfig, CodeConfig, DecoderConfig, RunConfig, SimConfig,
    )

    path = tmp_path_factory.mktemp("codes") / "tiny8.alist"
    save_alist(make_peg_code(16, 8, 4, dv=2, seed=5), path)
    return RunConfig(
        code=CodeConfig(path=str(path)),
        decoder=DecoderConfig(kind="qspa", max_iters=4),
        channel=ChannelConfig(ebn0_db=(1.0, 3.0)),  # S=2 shards over 'snr'
        sim=SimConfig(frames_per_step=32, max_frames=64, max_frame_errors=10**9, seed=3),
    )


def test_eight_devices_available():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"


def test_make_mesh_shapes():
    m = make_mesh(snr=2, data=4)
    assert m.shape == {"snr": 2, "data": 4}
    m2 = make_mesh(snr=1)
    assert m2.shape == {"snr": 1, "data": 8}
    with pytest.raises(ValueError):
        make_mesh(snr=3)


@pytest.mark.parametrize("shape", [(1, 8), (2, 4), (2, 2)])
def test_sharded_equals_unsharded(cfg8, shape):
    """psum-reduced counters == single-device counters on the same frames,
    invariant to mesh shape."""
    base = sim.run_sweep(cfg8, mesh=None)
    mesh = make_mesh(snr=shape[0], data=shape[1])
    sharded = sim.run_sweep(cfg8, mesh=mesh)
    for f in ("frames", "bit_errors", "symbol_errors", "frame_errors",
              "iter_sum", "converged"):
        np.testing.assert_array_equal(
            getattr(base.counters, f), getattr(sharded.counters, f), err_msg=f
        )


def test_batch_axis_sharding_is_compiled(cfg8):
    """The internal [S, B, ...] frame tensors must ACTUALLY shard over
    ('snr', 'data') in the compiled program — not silently replicate
    (round-4 verdict item 4: the DP contract must hold by construction).

    Uses the sim step's sharding probe (jax.debug.inspect_array_sharding),
    which reports the sharding XLA compiled for the constrained tensors."""
    from nbldpc_tpu.code import CodeSpec  # noqa: F401 (import check)
    from nbldpc_tpu.graph import TannerGraph
    from nbldpc_tpu.parallel.mesh import sim_shardings
    from nbldpc_tpu.utils.config import DecoderConfig

    mesh = make_mesh(snr=2, data=4)
    sh = sim_shardings(mesh)
    spec = cfg8.code.load()
    graph = TannerGraph(spec)
    seen = []
    step = sim.make_sim_step(
        graph, DecoderConfig(kind="qspa", max_iters=2), 32, 2,
        batch_sharding=sh["batch"], sharding_probe=seen.append,
    )
    step = jax.jit(step, in_shardings=(sh["replicated"], sh["per_snr"]),
                   out_shardings=sh["per_snr"])
    sigmas = jax.numpy.asarray([0.8, 0.6])
    out = step(jax.random.PRNGKey(0), sigmas)
    jax.block_until_ready(out)
    assert len(seen) >= 2, "sharding probe saw no constrained tensors"
    for s in seen:
        spec_axes = tuple(s.spec)
        assert spec_axes[:2] == ("snr", "data"), (
            f"frame tensors must shard P('snr','data'), got {s.spec}"
        )


def test_dryrun_multichip_entrypoint():
    """The driver-facing multi-chip dry run must compile and execute."""
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_entry_compiles():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
