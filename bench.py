"""Headline benchmark: decoded coded symbols/s on one GPU, QSPA over GF(16).

    python bench.py [--batch 8192] [--reps 10] [--code gf16_n204_k102]

Times the full jitted sim step (channel -> LLR init -> QSPA decode ->
error counters) on the (204,102) GF(16) PEG code at a fixed 50-iteration
budget with no per-iteration bookkeeping (the BASELINE.json throughput
mode). Warm-up first, then each rep ends in block_until_ready; reports the
median and quartiles of the step time.

Prints the device and the card's name and power limit, then ONE JSON line.
Without a GPU it exits non-zero and prints no result: a CPU number is not a
measurement of the card.
"""

from __future__ import annotations

import argparse
import json
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--code", default="gf16_n204_k102")
    args = ap.parse_args()

    from nbldpc_tpu.utils.device import card_info, enable_compile_cache, require_gpu

    enable_compile_cache()
    devices = require_gpu("bench.py")

    import numpy as np

    import jax
    import jax.numpy as jnp

    from nbldpc_tpu.codegen import build_standard_code
    from nbldpc_tpu.graph import TannerGraph
    from nbldpc_tpu.sim import make_sim_step
    from nbldpc_tpu.utils.config import DecoderConfig

    print(f"jax {jax.__version__}, {devices[0].device_kind} x{len(devices)}")
    print(f"card: {card_info()}", flush=True)
    iters = 50
    spec = build_standard_code(args.code)
    graph = TannerGraph(spec)
    dec = DecoderConfig(kind="qspa", max_iters=iters, early_term=False,
                        stats_each_iter=False)
    step = jax.jit(make_sim_step(graph, dec, batch_per_snr=args.batch, n_snr=1))
    sigmas = jnp.asarray([0.63])  # ~2 dB at rate 1/2 — mid-waterfall load
    key = jax.random.PRNGKey(0)

    t0 = time.perf_counter()
    jax.block_until_ready(step(key, sigmas))
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(step(jax.random.fold_in(key, 1), sigmas))
    times = []
    for r in range(args.reps):
        t0 = time.perf_counter()
        jax.block_until_ready(step(jax.random.fold_in(key, 100 + r), sigmas))
        times.append(time.perf_counter() - t0)
    q1, med, q3 = np.percentile(times, [25, 50, 75])
    sym_per_s = args.batch * spec.n / med
    print(json.dumps({
        "metric": "decoded_coded_symbols_per_s_qspa_gf16_50it",
        "value": sym_per_s,
        "unit": "symbols/s",
        "frames_per_s": args.batch / med,
        "step_s": {"median": med, "q1": q1, "q3": q3},
        "compile_s": compile_s,
        "device": {"platform": devices[0].platform,
                   "kind": devices[0].device_kind, "count": len(devices)},
        "batch": args.batch,
        "iters": iters,
        "code": args.code,
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
