"""Binary-image BPSK modulation, AWGN channel, q-ary LLR-vector init.

SURVEY.md C5–C7. Fully vectorized, counter-based PRNG (jax.random) so results
are reproducible across sharding layouts — keys are split per
(snr, macro-batch) by the sim engine, never per scalar draw.

Conventions:
  - GF(2^p) symbol -> p bits LSB-first (gf.GF.bits) -> BPSK x = 1 - 2b.
  - Eb/N0 in dB with code rate R: sigma^2 = 1 / (2 R 10^(EbN0/10)) per
    coded BPSK dimension (symbol rate == bit rate under the binary image).
  - llr[a] = log P(y | symbol a) up to an additive constant:
        llr[..., a] = -(2/sigma^2) * sum_i y_i * bits(a)_i
    one einsum over the precomputed [q, p] bit-pattern matrix.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from nbldpc_tpu.gf import get_field


def ebn0_to_sigma(ebn0_db, rate: float):
    """Noise std-dev per BPSK dimension for Eb/N0 (dB) at code rate R.

    Host-side numpy: this is setup math, and a jnp scalar here would make
    every sweep pay a device dispatch (and first-op claim latency) just to
    read back one float.
    """
    ebn0 = 10.0 ** (np.asarray(ebn0_db, dtype=np.float64) / 10.0)
    return np.sqrt(1.0 / (2.0 * rate * ebn0))


def modulate(symbols: jnp.ndarray, q: int) -> jnp.ndarray:
    """GF(q) symbols [..., N] int32 -> BPSK [..., N, p] float32 (bit 0 -> +1)."""
    bits = jnp.asarray(get_field(q).bits)              # [q, p]
    b = bits[symbols]                                  # [..., N, p]
    return (1.0 - 2.0 * b).astype(jnp.float32)


def awgn(key, x: jnp.ndarray, sigma) -> jnp.ndarray:
    """y = x + sigma * n. sigma may broadcast (e.g. per-SNR leading axis)."""
    return x + jnp.asarray(sigma) * jax.random.normal(key, x.shape, x.dtype)


def llr_init(y: jnp.ndarray, sigma, q: int) -> jnp.ndarray:
    """Channel observations [..., N, p] -> symbol log-likelihoods [..., N, q].

    `sigma` must be a scalar or broadcastable against y's batch dims with
    trailing singleton [..., 1, 1] (e.g. per-SNR shape [S, 1, 1, 1]).
    """
    bits = jnp.asarray(get_field(q).bits, dtype=y.dtype)   # [q, p]
    scale = 2.0 / (jnp.asarray(sigma) ** 2)
    # highest precision: the [.., p] x [q, p] contraction is tiny, and a
    # default-precision f32 dot may run in TF32 or bf16 on an accelerator,
    # which would quantize the channel LLRs that every decoder and the f64
    # oracle consume.
    llr = -jnp.einsum("...np,qp->...nq", y, bits, precision="highest")
    return scale * llr


def transmit(key, codeword: jnp.ndarray, sigma, q: int) -> jnp.ndarray:
    """codeword [..., N] -> llr [..., N, q]: modulate + AWGN + LLR init."""
    x = modulate(codeword, q)
    y = awgn(key, x, sigma)
    return llr_init(y, sigma, q)


def inject_errors(codeword: jnp.ndarray, positions, values, q: int) -> jnp.ndarray:
    """Deterministic symbol corruption (fault injection for decoder tests,
    SURVEY.md §5.3): XOR-add GF error values at given positions."""
    err = jnp.zeros_like(codeword).at[..., jnp.asarray(positions)].set(
        jnp.asarray(values, dtype=codeword.dtype)
    )
    return codeword ^ err


def perfect_llr(codeword: jnp.ndarray, q: int, confidence: float = 40.0) -> jnp.ndarray:
    """Noiseless LLRs for a codeword (metamorphic tests): delta-like vectors."""
    onehot = jax.nn.one_hot(codeword, q, dtype=jnp.float32)
    return confidence * (onehot - 1.0)
