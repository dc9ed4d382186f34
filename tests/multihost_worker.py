"""Worker process for the 2-process multi-host test (SURVEY.md §4.6).

Each process gets 4 virtual CPU devices; the ('snr','data') mesh spans both
processes (8 global devices) over local TCP. Runs a short fixed
sweep and prints the final counters as JSON (identical on every process —
the counters are replicated after the psum).

Usage: python tests/multihost_worker.py <coordinator> <num_procs> <proc_id>
"""

import json
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root

coordinator, num_procs, proc_id = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(
    coordinator_address=coordinator, num_processes=num_procs, process_id=proc_id
)

from nbldpc_tpu import sim  # noqa: E402
from nbldpc_tpu.codegen import make_peg_code  # noqa: E402
from nbldpc_tpu.code import save_alist  # noqa: E402
from nbldpc_tpu.parallel.mesh import make_mesh  # noqa: E402
from nbldpc_tpu.utils.config import (  # noqa: E402
    ChannelConfig, CodeConfig, DecoderConfig, RunConfig, SimConfig,
)

path = os.path.join(tempfile.gettempdir(),
                    f"nbldpc_mh_{os.environ.get('NBLDPC_MH_TAG', 'x')}.alist")
if proc_id == 0:
    save_alist(make_peg_code(16, 8, 4, dv=2, seed=5), path)
# both processes regenerate deterministically if needed
if not os.path.exists(path):
    save_alist(make_peg_code(16, 8, 4, dv=2, seed=5), path)

cfg = RunConfig(
    code=CodeConfig(path=path),
    decoder=DecoderConfig(kind="qspa", max_iters=4),
    channel=ChannelConfig(ebn0_db=(1.0, 3.0)),
    sim=SimConfig(frames_per_step=32, max_frames=64, max_frame_errors=10**9, seed=3),
)

assert len(jax.devices()) == 4 * num_procs, jax.devices()
mesh = make_mesh(snr=2)  # 2 x (2*num_procs) over both hosts
res = sim.run_sweep(cfg, mesh=mesh)
print("COUNTERS " + json.dumps(res.counters.asdict()), flush=True)
