"""Entry points: compile-cache placement, GPU-only scripts refusing the CPU,
chip_smoke's comparison helpers, multi-process init and the CLI's mesh."""

import argparse
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax

import chip_smoke
from nbldpc_tpu import cli
from nbldpc_tpu.parallel import dist
from nbldpc_tpu.utils import device
from nbldpc_tpu.utils.config import MeshConfig, RunConfig

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_from_env(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compile_cache_default_in_repo(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = device.enable_compile_cache()
    assert path == str(REPO / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def _cpu_env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **extra)
    env.pop("XLA_FLAGS", None)
    return env


def test_cli_run_fills_compile_cache(tmp_path):
    """One `python -m nbldpc_tpu run` leaves the cache directory non-empty
    (the cache is applied through jax.config, after jax is imported)."""
    from nbldpc_tpu.code import save_alist
    from nbldpc_tpu.codegen import make_peg_code

    code = tmp_path / "tiny.alist"
    save_alist(make_peg_code(12, 6, 4, dv=2, seed=7), code)
    cache = tmp_path / "cache"
    proc = subprocess.run(
        [sys.executable, "-m", "nbldpc_tpu", "run", "--code", str(code),
         "--snr", "3.0", "--iters", "2", "--frames", "8",
         "--set", "sim.frames_per_step=8"],
        cwd=REPO, env=_cpu_env(JAX_COMPILATION_CACHE_DIR=str(cache)),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "FER" in proc.stdout
    assert cache.is_dir() and any(cache.iterdir())


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_scripts_refuse_cpu(script):
    proc = subprocess.run([sys.executable, script], cwd=REPO, env=_cpu_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "needs an NVIDIA GPU" in proc.stderr
    assert "{" not in proc.stdout          # no result line


def test_smoke_cpu_agreement_passes():
    a = np.zeros((256, 10), np.int32)
    b = a.copy()
    b[3, 4] = 1                            # one fp-tie frame is allowed
    n_bad = chip_smoke.frames_differing(a, b)
    assert n_bad == 1
    chip_smoke.check_cpu_agreement("case", n_bad, 256)


def test_smoke_cpu_agreement_fails():
    a = np.zeros((256, 10), np.int32)
    b = a.copy()
    b[3, 4] = b[7, 0] = 1
    n_bad = chip_smoke.frames_differing(a, b)
    assert n_bad == 2
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check_cpu_agreement("case", n_bad, 256)


def test_smoke_message_error_floor():
    ref = np.array([0.0, -1.0, -20.0, -1e30])
    got = ref + np.array([5e-4, -2e-4, 3.0, 0.0])
    # the -20 entry lies below the QSPA floor and is not compared
    assert chip_smoke.message_error(got, ref, chip_smoke.QSPA_LOG_FLOOR) \
        == pytest.approx(5e-4)
    # max-sum messages are compared everywhere above the NEG clamp
    assert chip_smoke.message_error(got, ref, chip_smoke.MAXSUM_LOG_FLOOR) \
        == pytest.approx(3.0)


@pytest.fixture
def init_calls(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: calls.append(kw))
    for var in ("NBLDPC_COORDINATOR", "NBLDPC_NUM_PROCS", "NBLDPC_PROC_ID"):
        monkeypatch.delenv(var, raising=False)
    return calls


def test_dist_single_process_is_noop(init_calls):
    dist.initialize()
    assert init_calls == []


def test_dist_reads_env(init_calls, monkeypatch):
    monkeypatch.setenv("NBLDPC_COORDINATOR", "localhost:12345")
    monkeypatch.setenv("NBLDPC_NUM_PROCS", "2")
    monkeypatch.setenv("NBLDPC_PROC_ID", "1")
    dist.initialize()
    assert init_calls == [{"coordinator_address": "localhost:12345",
                           "num_processes": 2, "process_id": 1}]


def test_dist_failure_propagates(monkeypatch):
    def boom(**kw):
        raise RuntimeError("coordinator unreachable")

    monkeypatch.setattr(jax.distributed, "initialize", boom)
    with pytest.raises(RuntimeError, match="unreachable"):
        dist.initialize("localhost:1", 2, 0)


def _args(**kw):
    base = dict(no_mesh=False, mesh_snr=None, mesh_data=None)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("args,shape", [
    (_args(), {"snr": 2, "data": 4}),                # config wins
    (_args(mesh_snr=4), {"snr": 4, "data": 2}),      # a flag overrides
    (_args(mesh_data=2), {"snr": 2, "data": 2}),
])
def test_cli_mesh_from_config(args, shape):
    assert len(jax.devices()) == 8
    cfg = RunConfig(mesh=MeshConfig(snr=2, data=0))
    assert dict(cli.build_mesh(cfg, args).shape) == shape


def test_cli_no_mesh():
    cfg = RunConfig(mesh=MeshConfig(snr=2, data=2))
    assert cli.build_mesh(cfg, _args(no_mesh=True)) is None


def test_four_card_config_mesh():
    from nbldpc_tpu.utils.config import load_config

    cfg = load_config(REPO / "configs" / "gf256_sweep_4card.json")
    assert cfg.mesh == MeshConfig(snr=2, data=2)
    assert len(cfg.channel.ebn0_db) % cfg.mesh.snr == 0
    assert cfg.sim.frames_per_step % cfg.mesh.data == 0
