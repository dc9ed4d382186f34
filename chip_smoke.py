"""Chip check: the simulator's main path on an NVIDIA GPU, checked for
correctness against the plain references.

    python chip_smoke.py                # one GPU
    python chip_smoke.py --four-cards   # BASELINE config 5 on 4 GPUs vs 1

One GPU, all phases in this process:
  1. device: JAX version, device kind and count; the card's name and power
     limit from nvidia-smi.
  2. main path: `nbldpc_tpu.cli.main(["run", ...])` on each BASELINE config
     at its own widths (all SNR points x frames_per_step), every decoder
     variant the CLI offers, with only sim.max_frames cut so each SNR point
     takes one step. Prints each FER table and the step's
     compiled.memory_analysis().
  3. correctness, per decoder variant at its config's code and highest SNR,
     on 256 seeded random-codeword frames decoded on the GPU:
       - numpy oracle (tests/reference_model.py) on the first 4 frames:
         messages after one iteration within LOG_TOL in the log domain
         (see message_error), and hard decisions (and done flags, and
         iteration counts under early termination) equal after the whole
         budget;
       - CPU backend: the same decode of all 256 frames on the CPU; at most
         MAX_BAD_FRAMES frames may differ (f32 ties), and the count is
         printed.
  4. the `gpu`-marked tests, through pytest.main in this process (a second
     JAX process could not reserve the card's memory).
The last line is one JSON object; it is printed only if every phase passed.

--four-cards runs only BASELINE config 5 (GF(256) (255,175), 8 SNR points,
QSPA and EMS nm=16) through cli.main on a ('snr'=2, 'data'=2) mesh from the
config's mesh section, then the same seed and frames on one card
(--no-mesh), and requires equal per-SNR counters.

Precision: float32 throughout. Dots run at precision="highest" (the
channel's LLR einsum, the fused QSPA kernel's Hadamard products), because a
default float32 dot may run in TF32 on this card.

Exits non-zero, printing no result, when JAX's default device is not a GPU.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# Log-domain message tolerance of the CPU golden tests.
LOG_TOL = 1e-3
# QSPA messages are compared where the oracle's message is within a factor
# 1e3 of the symbol's most likely value. Below that a QSPA message is the log
# of a float32 Hadamard sum of order-one terms that cancel to a small
# probability, whose rounding error (~1e-7 absolute) is no longer small
# against the probability itself. EMS/T-EMS messages are sums and maxima of
# their inputs, so they are compared everywhere above the NEG clamp.
QSPA_LOG_FLOOR = math.log(1e-3)
MAXSUM_LOG_FLOOR = -1e29
ORACLE_FRAMES = 4
CPU_FRAMES = 256
MAX_BAD_FRAMES = 1      # per CPU_FRAMES

# (config file, label, --set overrides). Every decoder variant the CLI offers.
VARIANTS = [
    ("gf4_qspa_pr1.json", "gf4_qspa", []),
    ("gf16_qspa_batch4k.json", "gf16_qspa", []),
    ("gf16_ems_nm16.json", "gf16_ems_nm16", []),
    ("gf64_tems_earlyterm.json", "gf64_tems_nr8", []),
    ("gf64_tems_earlyterm.json", "gf64_tems_exact", ["decoder.tems_nr=0"]),
    ("gf256_sweep_4card.json", "gf256_qspa", []),
    ("gf256_sweep_4card.json", "gf256_ems_nm16",
     ["decoder.kind=ems", "decoder.nm=16"]),
    ("gf256_sweep_4card.json", "gf256_ems_bubble",
     ["decoder.kind=ems", "decoder.nm=16", "decoder.ems_merge=bubble"]),
]
FOUR_CARD = [
    ("gf256_sweep_4card.json", "gf256_qspa", []),
    ("gf256_sweep_4card.json", "gf256_ems_nm16",
     ["decoder.kind=ems", "decoder.nm=16"]),
]


class SmokeFailure(Exception):
    pass


def message_error(got, ref, floor: float) -> float:
    """Largest |got - ref| over log-domain messages where ref >= floor."""
    import numpy as np

    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    sel = ref >= floor
    return float(np.max(np.abs(got - ref)[sel], initial=0.0))


def frames_differing(a, b) -> int:
    """Number of frames (rows) whose hard decisions differ anywhere."""
    import numpy as np

    return int(np.sum(np.any(np.asarray(a) != np.asarray(b), axis=-1)))


def check_cpu_agreement(label: str, n_bad: int, frames: int) -> None:
    print(f"  {label}: GPU vs CPU backend: {n_bad} of {frames} frames differ "
          f"(allowed {MAX_BAD_FRAMES})", flush=True)
    if n_bad > MAX_BAD_FRAMES:
        raise SmokeFailure(f"{label}: {n_bad} frames differ between the GPU "
                           "and the CPU backend")


def _config(cfg_file: str, sets: list):
    from nbldpc_tpu.utils.config import apply_overrides, load_config

    cfg = load_config(REPO / "configs" / cfg_file)
    return apply_overrides(cfg, sets) if sets else cfg


def _oracle_task(code_name, kind, kw, llr, max_iters, early_term):
    """Oracle for one frame (runs in a worker process, on numpy only)."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, str(REPO))
    from nbldpc_tpu.codegen import build_standard_code
    from tests.reference_model import OracleDecoder

    dec = OracleDecoder(build_standard_code(code_name), kind=kind, **kw)
    _, _, _, msgs = dec.decode(llr, 1, early_term=False, return_messages=True)
    hard, done, iters = dec.decode(llr, max_iters, early_term=early_term)
    return msgs, hard, done, iters


def _oracle_args(dec):
    if dec.kind == "qspa":
        return "qspa", {}
    if dec.kind == "ems":
        kind = "ems_bubble" if dec.ems_merge == "bubble" else "ems"
        return kind, {"nm": dec.nm, "offset": dec.offset}
    return "tems", {"offset": dec.offset, "n_r": dec.tems_nr}


def run_main_path(variants) -> None:
    import jax
    import jax.numpy as jnp

    from nbldpc_tpu import cli, sim
    from nbldpc_tpu.graph import TannerGraph

    for cfg_file, label, sets in variants:
        cfg = _config(cfg_file, sets)
        S, B = len(cfg.channel.ebn0_db), cfg.sim.frames_per_step
        graph = TannerGraph(cfg.code.load())
        step = jax.jit(sim.make_sim_step(graph, cfg.decoder, B, S))
        t0 = time.perf_counter()
        compiled = step.lower(jax.random.PRNGKey(0),
                              jnp.zeros((S,), jnp.float32)).compile()
        mem = compiled.memory_analysis()
        print(f"== main path {label}: {cfg_file} {' '.join(sets)} "
              f"({S} SNR x {B} frames, {cfg.decoder.max_iters} it); "
              f"compile {time.perf_counter() - t0:.1f} s", flush=True)
        print("  memory_analysis: " + json.dumps({
            k: getattr(mem, k) for k in (
                "argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes", "generated_code_size_in_bytes")}),
            flush=True)
        argv = ["run", "--config", str(REPO / "configs" / cfg_file),
                "--set", f"sim.max_frames={B}"]
        for s in sets:
            argv += ["--set", s]
        t0 = time.perf_counter()
        rc = cli.main(argv)
        print(f"  cli rc={rc}, {time.perf_counter() - t0:.1f} s", flush=True)
        if rc != 0:
            raise SmokeFailure(f"{label}: cli.main returned {rc}")


def _one_iter_fn(graph, cn):
    """llr [B, N, q] -> c-domain CN messages [B, M, dc, q] after one
    iteration of the batch-last decoder."""
    import jax
    import jax.numpy as jnp

    from nbldpc_tpu.decoders import common

    def f(llr):
        lb = jnp.transpose(llr, (1, 2, 0))
        lb = lb - jnp.max(lb, axis=1, keepdims=True)
        C0 = jnp.zeros((graph.m, graph.dc_max, graph.q, llr.shape[0]),
                       llr.dtype)
        U, _, _ = common.vn_update_bl(graph, lb, C0)
        return graph.permute_up(jnp.transpose(cn(U, graph), (3, 0, 1, 2)))

    return jax.jit(f)


def _cn_update(dec, graph, batch):
    import functools

    from nbldpc_tpu.decoders import ems, qspa, tems

    if dec.kind == "qspa":
        return qspa.cn_update_bl_for(graph, batch)
    if dec.kind == "ems":
        return functools.partial(ems.ems_cn_update_bl, nm=dec.nm,
                                 offset=dec.offset, merge=dec.ems_merge)
    return functools.partial(tems.tems_cn_update_bl, offset=dec.offset,
                             n_r=dec.tems_nr)


def _cpu_decode_fn(dec):
    """The decode as the CPU backend runs it. The fused QSPA kernel runs on
    the GPU only; on the CPU, QSPA takes XLA's CN update."""
    from nbldpc_tpu import sim
    from nbldpc_tpu.decoders import common, qspa

    if dec.kind == "qspa":
        return lambda g, x: common.decode_bl(
            g, x, qspa.qspa_cn_update_bl, dec.max_iters, dec.early_term,
            stats_each_iter=dec.stats_each_iter)
    return sim.get_decode_fn(dec)


def run_correctness(variants, pool, meanwhile) -> None:
    """Start the oracle (in `pool`) and the CPU-backend decodes (in a
    thread), decode on the GPU, call `meanwhile()`, then compare."""
    import threading

    import numpy as np

    import jax
    import jax.numpy as jnp

    from nbldpc_tpu import sim
    from nbldpc_tpu.channel import ebn0_to_sigma, transmit
    from nbldpc_tpu.encode import Encoder
    from nbldpc_tpu.graph import TannerGraph

    cpu = jax.devices("cpu")[0]
    cases = []
    for cfg_file, label, sets in variants:
        cfg = _config(cfg_file, sets)
        spec = cfg.code.load()
        graph = TannerGraph(spec)
        enc = Encoder(spec)
        snr = max(cfg.channel.ebn0_db)
        sigma = float(ebn0_to_sigma(snr, spec.k / spec.n))
        k1, k2 = jax.random.split(jax.random.PRNGKey(7))
        u = jax.random.randint(k1, (CPU_FRAMES, enc.k), 0, spec.q, jnp.int32)
        llr = np.asarray(transmit(k2, enc.encode(u), sigma, spec.q))
        dec = cfg.decoder
        kind, kw = _oracle_args(dec)
        futures = [pool.submit(_oracle_task, cfg.code.name, kind, kw, llr[b],
                               dec.max_iters, dec.early_term)
                   for b in range(ORACLE_FRAMES)]
        cases.append((label, cfg, spec, graph, llr, futures))

    cpu_hard = {}

    def cpu_runs():
        with jax.default_device(cpu):
            for label, cfg, spec, _graph, llr, _f in cases:
                g_cpu = TannerGraph(spec)
                fn = _cpu_decode_fn(cfg.decoder)
                x = jax.device_put(llr, cpu)
                cpu_hard[label] = np.asarray(
                    jax.jit(lambda v, g=g_cpu, f=fn: f(g, v).hard)(x))

    # The CPU decodes run beside the GPU work; XLA releases the GIL.
    cpu_thread = threading.Thread(target=cpu_runs, daemon=True)
    cpu_thread.start()

    gpu = {}
    for label, cfg, spec, graph, llr, _f in cases:
        dec = cfg.decoder
        res = jax.jit(lambda v, g=graph, f=sim.get_decode_fn(dec): f(g, v))(
            jnp.asarray(llr))
        msgs = _one_iter_fn(graph, _cn_update(dec, graph, CPU_FRAMES))(
            jnp.asarray(llr))
        gpu[label] = (np.asarray(res.hard), np.asarray(res.done),
                      np.asarray(res.iters), np.asarray(msgs))
        print(f"  {label}: GPU decode of {CPU_FRAMES} frames at "
              f"{max(cfg.channel.ebn0_db)} dB: "
              f"{int(gpu[label][1].sum())} converged", flush=True)

    meanwhile()
    failures = []
    for label, cfg, spec, graph, llr, futures in cases:
        dec = cfg.decoder
        hard, done, iters, msgs = gpu[label]
        floor = QSPA_LOG_FLOOR if dec.kind == "qspa" else MAXSUM_LOG_FLOOR
        worst, bad = 0.0, []
        for b, fut in enumerate(futures):
            m_o, hard_o, done_o, iters_o = fut.result()
            for m in range(spec.m):
                for j in range(len(spec.row_cols[m])):
                    worst = max(worst, message_error(msgs[b, m, j],
                                                     m_o[m][j], floor))
            same = (np.array_equal(hard[b], hard_o) and bool(done[b]) == done_o
                    and (not dec.early_term or int(iters[b]) == iters_o))
            if not same:
                bad.append(b)
        print(f"  {label}: oracle, {ORACLE_FRAMES} frames: max one-iteration "
              f"message error {worst:.3e} (tol {LOG_TOL}); frames whose "
              f"decisions differ: {bad}", flush=True)
        if worst > LOG_TOL or bad:
            failures.append(f"{label}: oracle mismatch")

    cpu_thread.join()
    for label, *_ in cases:
        if label not in cpu_hard:
            raise SmokeFailure(f"{label}: CPU-backend decode did not finish")
        try:
            check_cpu_agreement(label, frames_differing(gpu[label][0],
                                                        cpu_hard[label]),
                                CPU_FRAMES)
        except SmokeFailure as e:
            failures.append(str(e))
    if failures:
        raise SmokeFailure("; ".join(failures))


def run_gpu_tests() -> None:
    import pytest

    os.environ["NBLDPC_TESTS_ON_DEVICE"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      str(REPO / "tests")])
    print(f"== gpu-marked tests: pytest rc={rc}", flush=True)
    if rc != 0:
        raise SmokeFailure(f"gpu-marked tests failed (pytest rc={rc})")


def run_four_cards() -> None:
    import numpy as np

    from nbldpc_tpu import cli

    with tempfile.TemporaryDirectory() as tmp:
        for cfg_file, label, sets in FOUR_CARD:
            cfg = _config(cfg_file, sets)
            counters = {}
            for name, extra in (("4 cards", []), ("1 card", ["--no-mesh"])):
                report = os.path.join(tmp, f"{label}_{name[0]}.json")
                argv = ["run", "--config", str(REPO / "configs" / cfg_file),
                        "--set", f"sim.max_frames={cfg.sim.frames_per_step}",
                        "--report", report, *extra]
                for s in sets:
                    argv += ["--set", s]
                print(f"== {label} on {name}: mesh {cfg.mesh}", flush=True)
                t0 = time.perf_counter()
                rc = cli.main(argv)
                print(f"  cli rc={rc}, {time.perf_counter() - t0:.1f} s",
                      flush=True)
                if rc != 0:
                    raise SmokeFailure(f"{label} on {name}: rc={rc}")
                counters[name] = json.loads(Path(report).read_text())["counters"]
            diff = {f: (np.asarray(counters["4 cards"][f])
                        - np.asarray(counters["1 card"][f])).tolist()
                    for f in counters["1 card"]}
            equal = all(not any(d) for d in diff.values())
            print(f"  {label}: 4-card counters == 1-card counters: {equal}"
                  + ("" if equal else f"; 4-card minus 1-card: {diff}"),
                  flush=True)
            if not equal:
                raise SmokeFailure(f"{label}: counters differ across meshes")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--four-cards", action="store_true",
                    help="only BASELINE config 5 on 4 GPUs against 1 GPU")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    from nbldpc_tpu.utils.device import (
        card_info, enable_compile_cache, require_gpu)

    enable_compile_cache()
    devices = require_gpu("chip_smoke.py")
    import jax

    want = 4 if args.four_cards else 1
    if len(devices) < want:
        print(f"chip_smoke.py: needs {want} GPUs, JAX sees {len(devices)}",
              file=sys.stderr)
        return 2
    print(f"jax {jax.__version__}; {devices[0].device_kind}; "
          f"{len(devices)} device(s)")
    print(card_info(), flush=True)
    print("precision: float32; dots at precision='highest' (no TF32)")
    t_start = time.perf_counter()
    try:
        if args.four_cards:
            run_four_cards()
        else:
            import concurrent.futures
            import multiprocessing

            workers = max(1, min(16, (os.cpu_count() or 2) - 2))
            with concurrent.futures.ProcessPoolExecutor(
                    workers, mp_context=multiprocessing.get_context("spawn")
            ) as pool:
                print("== correctness (references start first)", flush=True)
                run_correctness(VARIANTS, pool,
                                lambda: run_main_path(VARIANTS))
            run_gpu_tests()
    except SmokeFailure as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"all phases passed in {time.perf_counter() - t_start:.0f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
