"""Accelerator checks shared by the entry points that must run on a GPU.

A measurement or a chip check that finds no GPU stops with a message: it
never falls back to the CPU, whose numbers would be read as the card's.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory:
    $JAX_COMPILATION_CACHE_DIR when set, else <repo>/.jax_cache.

    JAX reads the environment variable only when it is imported, so setting
    it afterwards has no effect; this applies the setting through
    jax.config instead. Call it before the first compilation."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(REPO / ".jax_cache")
    if jax.config.jax_compilation_cache_dir != path:
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path


def require_gpu(what: str):
    """Return jax.devices() if the default backend is a GPU; otherwise print
    why `what` cannot run and exit with status 2."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"{what}: needs an NVIDIA GPU, but JAX's default device is "
              f"{devices[0].platform!r} ({devices[0].device_kind}); "
              "no result is reported.", file=sys.stderr)
        raise SystemExit(2)
    return devices


def card_info() -> str:
    """The cards' name and power limit as nvidia-smi reports them (one line
    per card). Runs nvidia-smi as a child process, which does not use JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
