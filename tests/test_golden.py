"""Golden tests: JAX decoders vs the loop-based numpy oracle (SURVEY.md §4.2).

The oracle computes the QSPA CN convolution directly over GF configurations
(no WHT), so these tests cross-check the Hadamard-domain implementation
end-to-end: message tensors after 1 iteration, then hard decisions
frame-for-frame over noisy batches (BASELINE.json north-star contract).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from nbldpc_tpu import decoders
from nbldpc_tpu.channel import ebn0_to_sigma, perfect_llr, transmit
from nbldpc_tpu.decoders import qspa
from nbldpc_tpu.encode import Encoder
from nbldpc_tpu.graph import TannerGraph

from tests.reference_model import OracleDecoder


def _noisy_llrs(spec, n_frames, ebn0_db, seed=0):
    enc = Encoder(spec)
    g = TannerGraph(spec)
    sigma = float(ebn0_to_sigma(ebn0_db, spec.k / spec.n))

    @jax.jit
    def gen(key):
        k1, k2 = jax.random.split(key)
        u = jax.random.randint(k1, (n_frames, enc.k), 0, spec.q, dtype=jnp.int32)
        cw = enc.encode(u)
        return cw, transmit(k2, cw, sigma, spec.q)

    cw, llr = gen(jax.random.PRNGKey(seed))
    return g, np.array(cw), np.array(llr)


@pytest.mark.parametrize("code_name", ["gf4_tiny", "gf16_tiny"])
def test_qspa_messages_one_iter(small_codes, code_name):
    """C messages after exactly 1 iteration match the direct-conv oracle."""
    spec = small_codes[code_name]
    g, cw, llr = _noisy_llrs(spec, 3, 2.0, seed=1)
    oracle = OracleDecoder(spec, kind="qspa")

    # run jax decoder for 1 iter, no early term, and extract C by reusing the
    # internal pieces (jitted: eager op-by-op compiles dominate on this box)
    @jax.jit
    def one_iter(llr_j):
        llr_n = llr_j - jnp.max(llr_j, axis=-1, keepdims=True)
        C0 = jnp.zeros((llr_j.shape[0], g.m, g.dc_max, g.q), jnp.float32)
        U, _, _ = decoders.common.vn_update(g, llr_n, C0)
        # CN output is x-domain; permute back to c-domain to compare with
        # the oracle, which reports C messages in the codeword domain.
        return g.permute_up(qspa.qspa_cn_update(U, g))

    C1 = np.array(one_iter(jnp.asarray(llr)))

    for b in range(llr.shape[0]):
        _, _, _, C_o = oracle.decode(
            llr[b], max_iters=1, early_term=False, return_messages=True
        )
        for m in range(spec.m):
            for j in range(len(spec.row_cols[m])):
                np.testing.assert_allclose(
                    C1[b, m, j],
                    C_o[m][j],
                    rtol=2e-3,
                    atol=2e-3,
                    err_msg=f"frame {b} check {m} slot {j}",
                )


@pytest.mark.parametrize("code_name", ["gf4_tiny", "gf16_tiny", "gf4_dv3"])
def test_qspa_hard_decisions_match(small_codes, code_name):
    """Hard decisions match the oracle frame-for-frame on noisy frames."""
    spec = small_codes[code_name]
    g, cw, llr = _noisy_llrs(spec, 24, 2.0, seed=2)
    oracle = OracleDecoder(spec, kind="qspa")
    res = qspa.decode(g, jnp.asarray(llr), max_iters=8, early_term=True)
    hard_j = np.array(res.hard)
    done_j = np.array(res.done)
    iters_j = np.array(res.iters)
    for b in range(llr.shape[0]):
        hard_o, done_o, iters_o = oracle.decode(llr[b], max_iters=8)
        np.testing.assert_array_equal(hard_j[b], hard_o, err_msg=f"frame {b}")
        assert done_j[b] == done_o, f"frame {b} done mismatch"
        assert iters_j[b] == iters_o, f"frame {b} iters mismatch"


def test_qspa_noiseless_converges_immediately(small_codes):
    """Metamorphic (SURVEY.md §4.3): noiseless codeword -> done at iter 0."""
    spec = small_codes["gf16_tiny"]
    g = TannerGraph(spec)
    enc = Encoder(spec)
    u = jnp.zeros((4, enc.k), jnp.int32).at[:, 0].set(jnp.arange(4))
    cw = enc.encode(u)
    llr = perfect_llr(cw, spec.q)
    res = qspa.decode(g, llr, max_iters=5)
    assert np.all(np.array(res.done))
    assert np.all(np.array(res.iters) == 0)
    np.testing.assert_array_equal(np.array(res.hard), np.array(cw))


def test_qspa_corrects_single_error(small_codes):
    """Single-symbol error at high confidence is corrected."""
    spec = small_codes["gf4_n96"]
    g = TannerGraph(spec)
    enc = Encoder(spec)
    key = jax.random.PRNGKey(5)
    u = jax.random.randint(key, (4, enc.k), 0, spec.q, dtype=jnp.int32)
    cw = enc.encode(u)
    # flip one symbol, then add mild noise via moderate-confidence LLRs
    bad = cw.at[:, 10].set(cw[:, 10] ^ 2)
    llr = perfect_llr(bad, spec.q, confidence=6.0)
    res = qspa.decode(g, llr, max_iters=10)
    assert np.all(np.array(res.done))
    np.testing.assert_array_equal(np.array(res.hard), np.array(cw))


@pytest.mark.parametrize("code_name", ["gf4_tiny", "gf16_tiny", "gf4_n96", "gf4_dv3"])
def test_qspa_layouts_agree(small_codes, code_name):
    """Batch-last and q-last paths implement identical updates:
    hard decisions, done flags and iteration counts must match exactly."""
    spec = small_codes[code_name]
    g, cw, llr = _noisy_llrs(spec, 16, 2.0, seed=7)
    r_bl = qspa.decode(g, jnp.asarray(llr), max_iters=8, batch_last=True)
    r_ql = qspa.decode(g, jnp.asarray(llr), max_iters=8, batch_last=False)
    np.testing.assert_array_equal(np.array(r_bl.hard), np.array(r_ql.hard))
    np.testing.assert_array_equal(np.array(r_bl.done), np.array(r_ql.done))
    np.testing.assert_array_equal(np.array(r_bl.iters), np.array(r_ql.iters))


def test_qspa_fixed_budget_mode(small_codes):
    """fori_loop mode must give the same answers as while_loop mode."""
    spec = small_codes["gf16_tiny"]
    g, cw, llr = _noisy_llrs(spec, 8, 2.5, seed=3)
    r1 = qspa.decode(g, jnp.asarray(llr), max_iters=6, early_term=True)
    r2 = qspa.decode(g, jnp.asarray(llr), max_iters=6, early_term=False)
    np.testing.assert_array_equal(np.array(r1.hard), np.array(r2.hard))
    np.testing.assert_array_equal(np.array(r1.done), np.array(r2.done))
    np.testing.assert_array_equal(np.array(r1.iters), np.array(r2.iters))
