"""CLI / sim driver (SURVEY.md L6 / C15).

    python -m nbldpc_tpu run --config configs/gf16_qspa.json \\
        --set decoder.max_iters=50 --set "channel.ebn0_db=[1.0,1.5,2.0]"
    python -m nbldpc_tpu run --code gf4_n96_k48 --decoder qspa --snr 2.5
    python -m nbldpc_tpu gen-codes         # regenerate codes/*.alist
    python -m nbldpc_tpu bench             # one-GPU throughput benchmark
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def _add_run_parser(sub):
    p = sub.add_parser("run", help="run a BER/FER Monte-Carlo sweep")
    p.add_argument("--config", help="JSON/TOML RunConfig file")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   help="dotted config override, e.g. decoder.max_iters=50")
    p.add_argument("--code", help="standard code name or alist path")
    p.add_argument("--decoder", choices=["qspa", "ems", "tems"])
    p.add_argument("--snr", type=float, nargs="+", help="Eb/N0 points (dB)")
    p.add_argument("--iters", type=int)
    p.add_argument("--frames", type=int, help="max frames per SNR")
    p.add_argument("--report", help="write JSON report to this path")
    p.add_argument("--mesh-snr", type=int,
                   help="devices along 'snr' (overrides the config's mesh)")
    p.add_argument("--mesh-data", type=int,
                   help="devices along 'data'; 0 = all remaining "
                        "(overrides the config's mesh)")
    p.add_argument("--no-mesh", action="store_true")
    p.add_argument("--profile", help="jax.profiler trace dir")
    p.add_argument("--random-codewords", action="store_true")


def build_mesh(cfg, args):
    """The ('snr', 'data') mesh for a run, or None on one device or with
    --no-mesh. The config's mesh section sets the shape; a --mesh-snr or
    --mesh-data flag overrides its axis."""
    import jax

    from nbldpc_tpu.parallel import mesh as meshmod

    if args.no_mesh or len(jax.devices()) == 1:
        return None
    snr = cfg.mesh.snr if args.mesh_snr is None else args.mesh_snr
    data = cfg.mesh.data if args.mesh_data is None else args.mesh_data
    return meshmod.make_mesh(snr=snr, data=data)


def cmd_run(args) -> int:
    from nbldpc_tpu.utils.config import (
        ChannelConfig, CodeConfig, DecoderConfig, MeshConfig, RunConfig,
        SimConfig, apply_overrides, load_config,
    )

    cfg = load_config(args.config) if args.config else RunConfig()
    if args.code:
        is_path = "/" in args.code or args.code.endswith(".alist")
        cfg = dataclasses.replace(
            cfg, code=CodeConfig(path=args.code if is_path else None,
                                 name=None if is_path else args.code))
    if args.decoder:
        cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, kind=args.decoder))
    if args.iters:
        cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, max_iters=args.iters))
    if args.snr:
        cfg = dataclasses.replace(cfg, channel=dataclasses.replace(cfg.channel, ebn0_db=tuple(args.snr)))
    if args.frames:
        cfg = dataclasses.replace(cfg, sim=dataclasses.replace(cfg.sim, max_frames=args.frames))
    if args.random_codewords:
        cfg = dataclasses.replace(cfg, channel=dataclasses.replace(cfg.channel, zero_codeword=False))
    if args.overrides:
        cfg = apply_overrides(cfg, args.overrides)

    import jax
    from nbldpc_tpu import sim
    from nbldpc_tpu.parallel import dist
    from nbldpc_tpu.utils import report as rep

    rep.setup_logging()
    dist.initialize()
    mesh = build_mesh(cfg, args)

    def progress(t, counters):
        rep.emit_step_record(t, counters)

    if args.profile:
        with jax.profiler.trace(args.profile):
            result = sim.run_sweep(cfg, mesh=mesh, progress=progress)
    else:
        result = sim.run_sweep(cfg, mesh=mesh, progress=progress)

    print(result.table())
    print(f"throughput: {result.throughput_syms_per_s:.3e} coded symbols/s")
    if args.report:
        rep.save_report(result, args.report, cfg)
    return 0


def cmd_gen_codes(_args) -> int:
    from pathlib import Path

    from nbldpc_tpu.code import save_alist
    from nbldpc_tpu.codegen import (
        STANDARD_CODES, STANDARD_CODES_C8, STANDARD_CODES_QC,
        build_standard_code,
    )

    out = Path(__file__).resolve().parents[1] / "codes"
    out.mkdir(exist_ok=True)
    for name in (*STANDARD_CODES, *STANDARD_CODES_C8, *STANDARD_CODES_QC):
        spec = build_standard_code(name)
        save_alist(spec, out / f"{name}.alist")
        print(f"wrote {out / (name + '.alist')}  (n={spec.n} m={spec.m} q={spec.q})")
    return 0


def cmd_bench(_args) -> int:
    import subprocess
    from pathlib import Path

    return subprocess.call(
        [sys.executable, str(Path(__file__).resolve().parents[1] / "bench.py")]
    )


def main(argv=None) -> int:
    from nbldpc_tpu.utils.device import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser(prog="nbldpc")
    sub = ap.add_subparsers(dest="cmd", required=True)
    _add_run_parser(sub)
    sub.add_parser("gen-codes", help="regenerate the standard code files")
    sub.add_parser("bench", help="run the throughput benchmark")
    args = ap.parse_args(argv)
    if args.cmd == "run":
        return cmd_run(args)
    if args.cmd == "gen-codes":
        return cmd_gen_codes(args)
    if args.cmd == "bench":
        return cmd_bench(args)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
