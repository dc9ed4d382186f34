"""Structured results: JSONL metrics stream + final report (SURVEY.md §5.5).

Counters live on device during a macro-batch; the host fetches them once per
step (no per-frame sync stalls). This module only formats/persists.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import sys
import time
from pathlib import Path
from typing import Optional

logger = logging.getLogger("nbldpc")


def setup_logging(level=logging.INFO, jsonl_path: Optional[str] = None):
    logger.setLevel(level)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(h)
    if jsonl_path:
        jh = logging.FileHandler(jsonl_path)
        jh.setFormatter(logging.Formatter("%(message)s"))
        jh.addFilter(lambda r: isinstance(r.msg, str) and r.msg.startswith("{"))
        logger.addHandler(jh)
    return logger


def emit_step_record(step: int, counters, extra: Optional[dict] = None):
    rec = {"t": time.time(), "step": step, **counters.asdict()}
    if extra:
        rec.update(extra)
    logger.info(json.dumps(rec))


def sweep_report(result, cfg=None) -> dict:
    """Serializable summary of a SweepResult."""
    rep = {
        "config_hash": result.config_hash,
        "ebn0_db": list(result.ebn0_db),
        "ber": [float(x) for x in result.ber],
        "ser": [float(x) for x in result.ser],
        "fer": [float(x) for x in result.fer],
        "avg_iters": [float(x) for x in result.avg_iters],
        "frames": result.counters.frames.tolist(),
        "frame_errors": result.counters.frame_errors.tolist(),
        "counters": result.counters.asdict(),
        "wall_seconds": result.wall_seconds,
        "throughput_syms_per_s": float(result.throughput_syms_per_s),
        "steps": result.steps,
    }
    if cfg is not None:
        rep["config"] = dataclasses.asdict(cfg)
    return rep


def save_report(result, path, cfg=None) -> None:
    Path(path).write_text(json.dumps(sweep_report(result, cfg), indent=2, default=list))
