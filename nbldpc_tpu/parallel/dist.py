"""Multi-process initialization for runs that span processes.

SURVEY.md §2.4: equivalent of the reference genre's (absent) NCCL/MPI layer.
jax.distributed.initialize() joins the processes into one JAX runtime; the
('snr','data') mesh then spans them, and the only cross-device traffic is
the per-step counter reduction, which XLA lowers to a psum (NCCL on GPUs).
One process can also drive every card of a host, which needs no
initialization at all.

Determinism contract (SURVEY.md §5.2): results must be invariant to mesh
shape and process count. That is achieved by deriving frame batches from a
*global* key by (snr index, macro-batch index) — never from process index —
so the same total frame set is simulated regardless of layout.
"""

from __future__ import annotations

import os
from typing import Optional

import jax


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize the JAX process group (no-op for single-process runs).

    Arguments fall back to NBLDPC_COORDINATOR (host:port), NBLDPC_NUM_PROCS
    and NBLDPC_PROC_ID. When none of them is given the run is one process
    and nothing is initialized. A failure of jax.distributed.initialize()
    propagates: a run that asked for several processes must not quietly
    continue as one.
    """
    coordinator_address = coordinator_address or os.environ.get("NBLDPC_COORDINATOR")
    if num_processes is None and "NBLDPC_NUM_PROCS" in os.environ:
        num_processes = int(os.environ["NBLDPC_NUM_PROCS"])
    if process_id is None and "NBLDPC_PROC_ID" in os.environ:
        process_id = int(os.environ["NBLDPC_PROC_ID"])
    if coordinator_address is None and num_processes is None and process_id is None:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def process_info() -> tuple[int, int]:
    return jax.process_index(), jax.process_count()
