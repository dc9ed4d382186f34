"""Distributed runtime: device mesh, shardings, multi-host init, collectives.

SURVEY.md §2.3/§2.4: the equivalent of a hand-written NCCL/MPI layer is the
XLA collective stack reached through jax.distributed + Mesh + shardings. The
dominant parallel axes for NB-LDPC Monte-Carlo are ('snr', 'data'): each SNR
point and each frame is independent; only error counters cross devices.
"""

from nbldpc_tpu.parallel.mesh import make_mesh, sim_shardings
