"""Throughput regression harness over the BASELINE.json configs
(SURVEY.md §4.7). Writes benchmarks/results/<tag>.json, one record per
config. Needs a GPU: without one it exits non-zero and writes nothing.

Usage (from the repo root or anywhere): python benchmarks/run_all.py
  [--tag local] [--quick] [--only gf16]

Fixed-iteration budget, stats_each_iter=False (the BASELINE.json throughput
metric mode). The multi-SNR sweep entry covers BASELINE config 5 (codewords
x SNR points in one compiled step). Each config is warmed up, then timed
rep by rep with block_until_ready; the record keeps the median.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp

CONFIGS = [
    # name, code, decoder kwargs, iters, batch, n_snr
    ("gf4_qspa_20it", "gf4_n96_k48", dict(kind="qspa"), 20, 4096, 1),
    ("gf16_qspa_50it", "gf16_n204_k102", dict(kind="qspa"), 50, 4096, 1),
    ("gf16_ems_nm16_20it", "gf16_n204_k102", dict(kind="ems", nm=16), 20, 8192, 1),
    ("gf64_tems_20it", "gf64_n576_k480", dict(kind="tems"), 20, 256, 1),
    ("gf256_qspa_10it", "gf256_n255_k175", dict(kind="qspa"), 10, 128, 1),
    ("gf256_ems_nm16_10it", "gf256_n255_k175", dict(kind="ems", nm=16), 10, 128, 1),
    # BASELINE config 5: multi-SNR sweep, all SNR points in one compiled step
    ("gf256_qspa_10it_4snr", "gf256_n255_k175", dict(kind="qspa"), 10, 128, 4),
    ("gf256_ems_nm16_10it_4snr", "gf256_n255_k175", dict(kind="ems", nm=16), 10, 128, 4),
    # --- decoder variants ---
    # bubble EMS (list-based staircase merges)
    ("gf256_ems_bubble_10it", "gf256_n255_k175",
     dict(kind="ems", nm=16, offset=0.0, ems_merge="bubble"), 10, 128, 1),
    # truncated-deviation T-EMS
    ("gf64_tems_nr8_20it", "gf64_n576_k480",
     dict(kind="tems", tems_nr=8), 20, 256, 1),
    ("gf64_tems_nr4_20it", "gf64_n576_k480",
     dict(kind="tems", tems_nr=4), 20, 256, 1),
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="local")
    ap.add_argument("--quick", action="store_true", help="small batches")
    ap.add_argument("--only", default=None, help="substring filter")
    args = ap.parse_args()

    from nbldpc_tpu.codegen import build_standard_code
    from nbldpc_tpu.graph import TannerGraph
    from nbldpc_tpu.sim import make_sim_step
    from nbldpc_tpu.utils.config import DecoderConfig

    from nbldpc_tpu.utils.device import card_info, enable_compile_cache, require_gpu

    enable_compile_cache()
    devices = require_gpu("run_all.py")
    print(f"jax {jax.__version__}, {devices[0].device_kind} x{len(devices)}")
    print(f"card: {card_info()}", flush=True)
    reps = 10
    records = []
    for name, code, deckw, iters, batch, n_snr in CONFIGS:
        if args.only and args.only not in name:
            continue
        if args.quick:
            batch = min(batch, 32)
        spec = build_standard_code(code)
        graph = TannerGraph(spec)
        dec = DecoderConfig(max_iters=iters, early_term=False,
                            stats_each_iter=False, **deckw)
        step = jax.jit(make_sim_step(graph, dec, batch_per_snr=batch,
                                     n_snr=n_snr))
        sigmas = jnp.asarray([0.7 + 0.05 * i for i in range(n_snr)])
        key = jax.random.PRNGKey(0)
        t_c0 = time.perf_counter()
        jax.block_until_ready(step(key, sigmas))
        compile_s = time.perf_counter() - t_c0
        times = []
        for r in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(step(jax.random.fold_in(key, r + 1), sigmas))
            times.append(time.perf_counter() - t0)
        dt = statistics.median(times)
        frames = batch * n_snr
        rec = {
            "config": name,
            "code": code,
            "iters": iters,
            "batch": batch,
            "n_snr": n_snr,
            "symbols_per_s": round(frames * spec.n / dt, 1),
            "frames_per_s": round(frames / dt, 2),
            "compile_s": round(compile_s, 2),
            "device": devices[0].device_kind,
        }
        records.append(rec)
        print(json.dumps(rec), flush=True)

    outdir = Path(__file__).parent / "results"
    outdir.mkdir(exist_ok=True)
    out = outdir / f"{args.tag}.json"
    # merge by config name so --only reruns update records in place
    merged = {}
    if out.exists():
        merged = {r["config"]: r for r in json.loads(out.read_text())}
    merged.update({r["config"]: r for r in records})
    # write in CONFIGS order (then any extras) so record order is stable
    # across partial --only reruns, matching fer_curves.py's behavior
    order = {name: i for i, (name, *_rest) in enumerate(CONFIGS)}
    ordered = sorted(merged.values(),
                     key=lambda r: (order.get(r["config"], len(order)),
                                    r["config"]))
    out.write_text(json.dumps(ordered, indent=2))


if __name__ == "__main__":
    main()
