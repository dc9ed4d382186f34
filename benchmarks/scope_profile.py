"""Per-scope device time of the sim step on a GPU, for every decoder variant.

    python benchmarks/scope_profile.py [--only gf256] [--out traces/scopes]

For each BASELINE config and decoder variant it builds the full jitted sim
step at the config's widths (all SNR points x frames_per_step), times it
untraced (warm-up, then block_until_ready, median of 5), then traces two
steps with jax.profiler and attributes every kernel the step ran on the
device to the decoder's named scopes (decoders/common.py): vn_update,
cn_update, posterior, syndrome; everything else (channel, LLR init, loop
control, counters) is "other". A kernel is mapped to its scope through the
op_name metadata of its instruction in the compiled HLO.

XLA's CUDA-graph command buffers hide the per-kernel HLO names from the
profiler, so this script turns them off (--xla_gpu_enable_command_buffer=)
before JAX starts; the untraced step time is taken with the same setting.
Prints one JSON line per variant. Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SCOPES = ("vn_update", "cn_update", "posterior", "syndrome")

VARIANTS = [
    # config file, label, overrides for DecoderConfig
    ("gf4_qspa_pr1.json", "gf4_qspa", {}),
    ("gf16_qspa_batch4k.json", "gf16_qspa", {}),
    ("gf16_ems_nm16.json", "gf16_ems_nm16", {}),
    ("gf64_tems_earlyterm.json", "gf64_tems_nr8", {}),
    ("gf64_tems_earlyterm.json", "gf64_tems_exact", {"tems_nr": 0}),
    ("gf256_sweep_4card.json", "gf256_qspa", {}),
    ("gf256_sweep_4card.json", "gf256_ems_nm16", {"kind": "ems", "nm": 16}),
    ("gf256_sweep_4card.json", "gf256_ems_bubble",
     {"kind": "ems", "nm": 16, "ems_merge": "bubble"}),
]


def scope_of(op_name: str) -> str:
    for s in SCOPES:
        if f"/{s}/" in op_name or op_name.endswith(f"/{s}"):
            return s
    return "other"


def hlo_scopes(hlo_text: str) -> dict:
    """Instruction name -> scope, from `metadata={op_name="..."}`."""
    out = {}
    pat = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name="([^"]*)"')
    for line in hlo_text.splitlines():
        m = pat.match(line)
        if m:
            out[m.group(1)] = scope_of(m.group(2))
    return out


def device_times(xplane: str, names: dict, module: str) -> dict:
    """Sum device durations (ns) per scope for kernels of `module`."""
    import jax

    pd = jax.profiler.ProfileData.from_file(xplane)
    tot = {s: 0 for s in (*SCOPES, "other")}
    spans = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                st = dict(ev.stats)
                if st.get("hlo_module") != module:
                    continue
                if str(st.get("tf_op", "")).startswith("XlaCompile"):
                    continue
                op = str(st.get("hlo_op", ""))
                tot[names.get(op, "other")] += ev.duration_ns
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    spans.sort()
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    window = (spans[-1][1] - spans[0][0]) if spans else 0
    return {"scope_ns": tot, "busy_ns": busy, "window_ns": window}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None, help="label substring filter")
    ap.add_argument("--out", default="traces/scopes",
                    help="profiler trace directory")
    args = ap.parse_args()
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_gpu_enable_command_buffer=").strip()

    from nbldpc_tpu.utils.device import card_info, enable_compile_cache, require_gpu

    enable_compile_cache()
    devices = require_gpu("scope_profile")

    import dataclasses

    import numpy as np

    import jax
    import jax.numpy as jnp

    from nbldpc_tpu.channel import ebn0_to_sigma
    from nbldpc_tpu.graph import TannerGraph
    from nbldpc_tpu.sim import make_sim_step
    from nbldpc_tpu.utils.config import load_config

    print(f"jax {jax.__version__}, {devices[0].device_kind} x{len(devices)}")
    print(f"card: {card_info()}", flush=True)
    repo = Path(__file__).resolve().parents[1]
    for cfg_file, label, over in VARIANTS:
        if args.only and args.only not in label:
            continue
        cfg = load_config(repo / "configs" / cfg_file)
        dec = dataclasses.replace(cfg.decoder, **over)
        spec = cfg.code.load()
        graph = TannerGraph(spec)
        snrs = list(cfg.channel.ebn0_db)
        S, B = len(snrs), cfg.sim.frames_per_step
        sigmas = jnp.asarray([float(ebn0_to_sigma(s, spec.k / spec.n))
                              for s in snrs])
        step = jax.jit(make_sim_step(graph, dec, B, S))
        key = jax.random.PRNGKey(0)
        compiled = step.lower(key, sigmas).compile()
        names = hlo_scopes(compiled.as_text())
        jax.block_until_ready(step(key, sigmas))
        times = []
        for r in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(step(jax.random.fold_in(key, r + 1), sigmas))
            times.append(time.perf_counter() - t0)
        tdir = os.path.join(args.out, label)
        with jax.profiler.trace(tdir):
            for r in range(2):
                jax.block_until_ready(
                    step(jax.random.fold_in(key, 10 + r), sigmas))
        xplane = sorted(glob.glob(f"{tdir}/**/*.xplane.pb", recursive=True))[-1]
        dt = device_times(xplane, names, "jit_step")
        steps = 2
        rec = {
            "variant": label,
            "frames_per_step": S * B,
            "iters_budget": dec.max_iters,
            "early_term": dec.early_term,
            "step_ms_median": float(np.median(times)) * 1e3,
            "device_ms_per_step": {k: v / steps / 1e6
                                   for k, v in dt["scope_ns"].items()},
            "device_busy_share_of_kernel_window":
                dt["busy_ns"] / max(dt["window_ns"], 1),
        }
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
