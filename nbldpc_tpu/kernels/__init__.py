"""Device kernels: the WHT used by the XLA path, and the fused GPU QSPA
check-node update (cn_qspa)."""
