"""nbldpc_tpu — non-binary LDPC decode-and-simulate framework in JAX.

A from-scratch JAX/XLA/Pallas implementation of the full NB-LDPC pipeline
(capability target: YongonY/NBLDPC, per SURVEY.md; the reference repo was
unavailable, so component parity is tracked against SURVEY.md §2):

  - GF(2^p) arithmetic as device-resident tables        (gf.py)
  - parity-check code I/O + deterministic code generator (code.py, codegen.py)
  - Tanner-graph array form for gather/scatter decoding  (graph.py)
  - systematic encoder over GF(q)                        (encode.py)
  - BPSK binary-image modulation, AWGN, LLR-vector init  (channel.py)
  - QSPA / EMS / T-EMS iterative decoders                (decoders/)
  - WHT + fused GPU QSPA check-node kernel              (kernels/)
  - mesh sharding (codewords x SNR points) + collectives (parallel/)
  - Monte-Carlo BER/FER simulation engine                (sim.py)
"""

__version__ = "0.1.0"

from nbldpc_tpu.gf import GF
from nbldpc_tpu.code import CodeSpec, load_alist, save_alist
from nbldpc_tpu.graph import TannerGraph
