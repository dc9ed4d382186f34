"""True multi-process test: 2 local processes over jax.distributed
(SURVEY.md §4.6 / §2.4 — the NCCL/MPI-layer equivalent). The psum-reduced
counters from the 2-host mesh must equal a single-process run over the same
total frame set (the determinism contract, §5.2)."""

import json
import os
import socket
import subprocess
import sys
import tempfile
import uuid
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_counters_match_single():
    tag = uuid.uuid4().hex[:8]
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["NBLDPC_MH_TAG"] = tag
    env.pop("XLA_FLAGS", None)  # worker sets its own device count
    env["JAX_PLATFORMS"] = "cpu"

    procs = [
        subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "multihost_worker.py"),
             coord, "2", str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True,
            cwd=str(REPO),
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        outs.append(out)

    counters = []
    for out in outs:
        line = [l for l in out.splitlines() if l.startswith("COUNTERS ")][-1]
        counters.append(json.loads(line[len("COUNTERS "):]))
    # both processes see the same replicated reduced counters
    assert counters[0] == counters[1]

    # single-process reference on the same total frame set
    from nbldpc_tpu import sim
    from nbldpc_tpu.code import save_alist
    from nbldpc_tpu.codegen import make_peg_code
    from nbldpc_tpu.utils.config import (
        ChannelConfig, CodeConfig, DecoderConfig, RunConfig, SimConfig,
    )

    path = os.path.join(tempfile.gettempdir(), f"nbldpc_mh_ref_{tag}.alist")
    save_alist(make_peg_code(16, 8, 4, dv=2, seed=5), path)
    cfg = RunConfig(
        code=CodeConfig(path=path),
        decoder=DecoderConfig(kind="qspa", max_iters=4),
        channel=ChannelConfig(ebn0_db=(1.0, 3.0)),
        sim=SimConfig(frames_per_step=32, max_frames=64,
                      max_frame_errors=10**9, seed=3),
    )
    ref = sim.run_sweep(cfg, mesh=None)
    for k, v in ref.counters.asdict().items():
        np.testing.assert_array_equal(np.asarray(counters[0][k]),
                                      np.asarray(v), err_msg=k)
