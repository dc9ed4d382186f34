"""Fused QSPA check-node kernel against the XLA update, end to end, on a GPU.

    python benchmarks/cn_kernel_bench.py [--reps 7]

For each case it runs common.decode_bl once with the XLA update
(qspa.qspa_cn_update_bl) and once with the kernel (kernels/cn_qspa.py), at a
fixed iteration budget with no per-iteration bookkeeping, on the same noisy
frames. It checks the kernel against XLA (one CN update at full width, and
the hard decisions after the whole decode), then times both in turns (xla,
kernel, kernel, xla, ...) with block_until_ready after a warm-up, and prints
one JSON line per case with the median and quartiles in ms.

Cases: GF(16) (204,102) B=4096 at 50 iterations; GF(256) (255,175) B=512 at
10 iterations. Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CASES = [
    # code, frames, iterations, Eb/N0 (dB)
    ("gf16_n204_k102", 4096, 50, 2.0),
    ("gf256_n255_k175", 512, 10, 3.0),
]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()

    from nbldpc_tpu.utils.device import card_info, enable_compile_cache, require_gpu

    enable_compile_cache()
    devices = require_gpu("cn_kernel_bench")

    import numpy as np

    import jax
    import jax.numpy as jnp

    from nbldpc_tpu.channel import ebn0_to_sigma, transmit
    from nbldpc_tpu.codegen import build_standard_code
    from nbldpc_tpu.decoders import common, qspa
    from nbldpc_tpu.graph import TannerGraph
    from nbldpc_tpu.kernels import cn_qspa

    print(f"jax {jax.__version__} {devices[0].device_kind} x{len(devices)}")
    print(f"card: {card_info()}")
    for code, frames, iters, ebn0 in CASES:
        spec = build_standard_code(code)
        graph = TannerGraph(spec)
        sigma = float(ebn0_to_sigma(ebn0, spec.k / spec.n))
        cw = jnp.zeros((frames, spec.n), jnp.int32)
        llr = jax.jit(lambda k: transmit(k, cw, sigma, spec.q))(
            jax.random.PRNGKey(0))
        fns = {
            "xla": qspa.qspa_cn_update_bl,
            "kernel": lambda U, _g: cn_qspa.cn_update(U),
        }
        decode = {
            name: jax.jit(lambda x, cn=cn: common.decode_bl(
                graph, x, cn, iters, early_term=False, stats_each_iter=False))
            for name, cn in fns.items()
        }
        # one CN update at full width: kernel against XLA on real slots
        Vv = jax.random.normal(jax.random.PRNGKey(1),
                               (graph.n, graph.dv_max, graph.q, frames)) * 3.0
        U = jax.jit(graph.gather_cn_x_bl)(Vv)
        mask = np.asarray(graph.cn_mask_np)[:, :, None, None]
        ref = np.asarray(jax.jit(qspa.qspa_cn_update_bl, static_argnums=1)(U, graph))
        out = np.asarray(cn_qspa.cn_update(U))
        cn_err = float(np.max(np.abs(np.where(mask, out - ref, 0.0))))

        compile_s, res = {}, {}
        for name, f in decode.items():
            t0 = time.perf_counter()
            res[name] = jax.block_until_ready(f(llr))
            compile_s[name] = time.perf_counter() - t0
        hard_eq = float(np.mean(np.asarray(res["xla"].hard)
                                == np.asarray(res["kernel"].hard)))
        times = {"xla": [], "kernel": []}
        for r in range(args.reps):
            order = ("xla", "kernel") if r % 2 == 0 else ("kernel", "xla")
            for name in order:
                t0 = time.perf_counter()
                jax.block_until_ready(decode[name](llr))
                times[name].append((time.perf_counter() - t0) * 1e3)
        rec = {
            "case": f"{code} B={frames} {iters}it",
            "cn_max_abs_err": cn_err,
            "hard_agreement": hard_eq,
            "compile_s": compile_s,
        }
        for name, t in times.items():
            q1, med, q3 = np.percentile(t, [25, 50, 75])
            rec[f"{name}_ms"] = {"median": med, "q1": q1, "q3": q3}
        rec["kernel_over_xla"] = rec["kernel_ms"]["median"] / rec["xla_ms"]["median"]
        print(json.dumps(rec), flush=True)
        if hard_eq < 0.999:
            print(f"kernel decisions disagree with XLA on {code}",
                  file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
