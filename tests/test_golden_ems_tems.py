"""Golden tests: EMS and T-EMS vs the numpy oracle (SURVEY.md §4.2)."""

import numpy as np
import pytest
import jax.numpy as jnp

from nbldpc_tpu import decoders
from nbldpc_tpu.decoders import common, ems, tems

from tests.reference_model import OracleDecoder
from nbldpc_tpu.graph import TannerGraph
from tests.test_golden import _noisy_llrs


def _one_iter_messages(g, llr, cn_update):
    import jax

    @jax.jit
    def one_iter(llr_j):
        llr_n = llr_j - jnp.max(llr_j, axis=-1, keepdims=True)
        C0 = jnp.zeros((llr_j.shape[0], g.m, g.dc_max, g.q), jnp.float32)
        U, _, _ = common.vn_update(g, llr_n, C0)
        # CN output is x-domain; permute back to c-domain for the oracle.
        return g.permute_up(cn_update(U, g))

    return np.array(one_iter(jnp.asarray(llr)))


@pytest.mark.parametrize("nm", [4, 8, 16])
def test_ems_messages_one_iter(small_codes, nm):
    spec = small_codes["gf16_tiny"]
    g, cw, llr = _noisy_llrs(spec, 3, 2.0, seed=11)
    oracle = OracleDecoder(spec, kind="ems", nm=nm)
    C1 = _one_iter_messages(
        g, llr, lambda V, gg: ems.ems_cn_update(V, gg, nm=nm, offset=0.0)
    )
    for b in range(llr.shape[0]):
        _, _, _, C_o = oracle.decode(
            llr[b], max_iters=1, early_term=False, return_messages=True
        )
        for m in range(spec.m):
            for j in range(len(spec.row_cols[m])):
                np.testing.assert_allclose(
                    C1[b, m, j], C_o[m][j], rtol=2e-3, atol=2e-3,
                    err_msg=f"nm={nm} frame {b} check {m} slot {j}",
                )


def test_ems_hard_decisions_match(small_codes):
    spec = small_codes["gf16_tiny"]
    g, cw, llr = _noisy_llrs(spec, 16, 2.5, seed=12)
    oracle = OracleDecoder(spec, kind="ems", nm=8)
    res = ems.decode(g, jnp.asarray(llr), max_iters=6, nm=8)
    hard_j = np.array(res.hard)
    for b in range(llr.shape[0]):
        hard_o, done_o, iters_o = oracle.decode(llr[b], max_iters=6)
        np.testing.assert_array_equal(hard_j[b], hard_o, err_msg=f"frame {b}")
        assert bool(np.array(res.done)[b]) == done_o
        assert int(np.array(res.iters)[b]) == iters_o


def test_ems_offset_matches(small_codes):
    spec = small_codes["gf4_tiny"]
    g, cw, llr = _noisy_llrs(spec, 4, 2.0, seed=13)
    oracle = OracleDecoder(spec, kind="ems", nm=4, offset=0.3)
    C1 = _one_iter_messages(
        g, llr, lambda V, gg: ems.ems_cn_update(V, gg, nm=4, offset=0.3)
    )
    for b in range(llr.shape[0]):
        _, _, _, C_o = oracle.decode(
            llr[b], max_iters=1, early_term=False, return_messages=True
        )
        for m in range(spec.m):
            for j in range(len(spec.row_cols[m])):
                np.testing.assert_allclose(
                    C1[b, m, j], C_o[m][j], rtol=2e-3, atol=2e-3
                )


def test_tems_messages_one_iter(small_codes):
    spec = small_codes["gf16_tiny"]
    g, cw, llr = _noisy_llrs(spec, 3, 2.0, seed=14)
    oracle = OracleDecoder(spec, kind="tems")
    C1 = _one_iter_messages(g, llr, tems.tems_cn_update)
    for b in range(llr.shape[0]):
        _, _, _, C_o = oracle.decode(
            llr[b], max_iters=1, early_term=False, return_messages=True
        )
        for m in range(spec.m):
            for j in range(len(spec.row_cols[m])):
                np.testing.assert_allclose(
                    C1[b, m, j], C_o[m][j], rtol=2e-3, atol=2e-3,
                    err_msg=f"frame {b} check {m} slot {j}",
                )


def test_tems_hard_decisions_match(small_codes):
    spec = small_codes["gf16_tiny"]
    g, cw, llr = _noisy_llrs(spec, 12, 3.0, seed=15)
    oracle = OracleDecoder(spec, kind="tems")
    res = tems.decode(g, jnp.asarray(llr), max_iters=6)
    hard_j = np.array(res.hard)
    for b in range(llr.shape[0]):
        hard_o, done_o, iters_o = oracle.decode(llr[b], max_iters=6)
        np.testing.assert_array_equal(hard_j[b], hard_o, err_msg=f"frame {b}")
        assert bool(np.array(res.done)[b]) == done_o


def test_ems_nm_full_equals_maxsum(small_codes):
    """EMS with nm=q on noiseless input behaves like exact max-sum: decodes
    a clean codeword immediately (SURVEY.md §4.3 sanity)."""
    from nbldpc_tpu.channel import perfect_llr
    from nbldpc_tpu.encode import Encoder
    from nbldpc_tpu.graph import TannerGraph

    spec = small_codes["gf16_tiny"]
    g = TannerGraph(spec)
    enc = Encoder(spec)
    u = jnp.arange(4, dtype=jnp.int32)[:, None] * jnp.ones((1, enc.k), jnp.int32)
    u = u % spec.q
    cw = enc.encode(u)
    llr = perfect_llr(cw, spec.q)
    res = ems.decode(g, llr, max_iters=4, nm=spec.q)
    assert np.all(np.array(res.done))
    np.testing.assert_array_equal(np.array(res.hard), np.array(cw))


def test_tems_noiseless(small_codes):
    from nbldpc_tpu.channel import perfect_llr
    from nbldpc_tpu.encode import Encoder
    from nbldpc_tpu.graph import TannerGraph

    spec = small_codes["gf4_tiny"]
    g = TannerGraph(spec)
    enc = Encoder(spec)
    cw = enc.encode(jnp.zeros((2, enc.k), jnp.int32).at[1, 0].set(1))
    llr = perfect_llr(cw, spec.q)
    res = tems.decode(g, llr, max_iters=4)
    assert np.all(np.array(res.done))
    np.testing.assert_array_equal(np.array(res.hard), np.array(cw))


# ---------------------------------------------------------------------------
# High-q truncated EMS (nm < q) and batch-last layouts
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def highq_codes():
    from nbldpc_tpu.codegen import make_peg_code

    return {
        64: make_peg_code(12, 6, 64, dv=2, seed=5),
        256: make_peg_code(12, 6, 256, dv=2, seed=5),
    }


@pytest.mark.parametrize("q,nm", [(64, 8), (256, 16)])
def test_ems_highq_messages_one_iter(highq_codes, q, nm):
    """Truncated EMS (nm < q) on GF(64)/GF(256): messages match the classic
    numpy oracle after one iteration (the round-1 gap: q > nm was unusable)."""
    spec = highq_codes[q]
    g, cw, llr = _noisy_llrs(spec, 2, 3.0, seed=21)
    oracle = OracleDecoder(spec, kind="ems", nm=nm)
    C1 = _one_iter_messages(
        g, llr, lambda V, gg: ems.ems_cn_update(V, gg, nm=nm, offset=0.0)
    )
    for b in range(llr.shape[0]):
        _, _, _, C_o = oracle.decode(
            llr[b], max_iters=1, early_term=False, return_messages=True
        )
        for m in range(spec.m):
            for j in range(len(spec.row_cols[m])):
                np.testing.assert_allclose(
                    C1[b, m, j], C_o[m][j], rtol=2e-3, atol=2e-3,
                    err_msg=f"q={q} nm={nm} frame {b} check {m} slot {j}",
                )


@pytest.mark.parametrize("q,nm", [(64, 8), (256, 16)])
def test_ems_highq_hard_decisions(highq_codes, q, nm):
    spec = highq_codes[q]
    g, cw, llr = _noisy_llrs(spec, 4, 4.0, seed=22)
    oracle = OracleDecoder(spec, kind="ems", nm=nm)
    res = ems.decode(g, jnp.asarray(llr), max_iters=4, nm=nm,
                     batch_last=False)
    hard_j = np.array(res.hard)
    for b in range(llr.shape[0]):
        hard_o, done_o, iters_o = oracle.decode(llr[b], max_iters=4)
        np.testing.assert_array_equal(hard_j[b], hard_o, err_msg=f"frame {b}")
        assert bool(np.array(res.done)[b]) == done_o


@pytest.mark.parametrize("q,nm", [(16, 8), (64, 8), (256, 16)])
def test_ems_batch_last_matches_q_last(highq_codes, small_codes, q, nm):
    """decode_bl (batch-last layout) == q-last decode, frame-for-frame."""
    spec = small_codes["gf16_tiny"] if q == 16 else highq_codes[q]
    g, cw, llr = _noisy_llrs(spec, 4, 2.5, seed=23)
    r1 = ems.decode(g, jnp.asarray(llr), max_iters=4, nm=nm, batch_last=False)
    r2 = ems.decode(g, jnp.asarray(llr), max_iters=4, nm=nm, batch_last=True)
    np.testing.assert_array_equal(np.array(r1.hard), np.array(r2.hard))
    np.testing.assert_array_equal(np.array(r1.done), np.array(r2.done))
    np.testing.assert_array_equal(np.array(r1.iters), np.array(r2.iters))


def test_tems_batch_last_matches_q_last(small_codes):
    spec = small_codes["gf16_tiny"]
    g, cw, llr = _noisy_llrs(spec, 6, 2.5, seed=24)
    r1 = tems.decode(g, jnp.asarray(llr), max_iters=4, batch_last=False)
    r2 = tems.decode(g, jnp.asarray(llr), max_iters=4, batch_last=True)
    np.testing.assert_array_equal(np.array(r1.hard), np.array(r2.hard))
    np.testing.assert_array_equal(np.array(r1.done), np.array(r2.done))
    np.testing.assert_array_equal(np.array(r1.iters), np.array(r2.iters))


# ---------------------------------------------------------------------------
# Round 5: bubble EMS (list-based staircase merges — the fast large-q
# variant) vs its co-designed oracle (reference_model kind="ems_bubble").
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q,nm", [(64, 8), (256, 16)])
def test_ems_bubble_messages_one_iter(highq_codes, q, nm):
    spec = highq_codes[q]
    g, cw, llr = _noisy_llrs(spec, 2, 3.0, seed=31)
    oracle = OracleDecoder(spec, kind="ems_bubble", nm=nm)
    C1 = _one_iter_messages(
        g, llr,
        lambda V, gg: ems.ems_cn_update_bl(
            jnp.transpose(V, (1, 2, 3, 0)), gg, nm=nm, merge="bubble"
        ).transpose(3, 0, 1, 2),
    )
    for b in range(llr.shape[0]):
        _, _, _, C_o = oracle.decode(
            llr[b], max_iters=1, early_term=False, return_messages=True
        )
        for m in range(spec.m):
            for j in range(len(spec.row_cols[m])):
                np.testing.assert_allclose(
                    C1[b, m, j], C_o[m][j], rtol=2e-3, atol=2e-3,
                    err_msg=f"bubble q={q} frame {b} check {m} slot {j}",
                )


@pytest.mark.parametrize("q,nm", [(256, 16)])
def test_ems_bubble_hard_decisions(highq_codes, q, nm):
    spec = highq_codes[q]
    g, cw, llr = _noisy_llrs(spec, 6, 4.0, seed=32)
    oracle = OracleDecoder(spec, kind="ems_bubble", nm=nm)
    res = ems.decode(g, jnp.asarray(llr), max_iters=5, nm=nm,
                     merge="bubble")
    for b in range(llr.shape[0]):
        hard_o, done_o, iters_o = oracle.decode(llr[b], max_iters=5)
        np.testing.assert_array_equal(
            np.array(res.hard)[b], hard_o, err_msg=f"frame {b}")
        assert bool(np.array(res.done)[b]) == done_o, f"frame {b}"
        assert int(np.array(res.iters)[b]) == iters_o, f"frame {b}"


# ---------------------------------------------------------------------------
# Round 5: truncated-deviation T-EMS (n_r most reliable rows) vs its
# co-designed oracle (reference_model n_r=...). Semantics differ from the
# exact scan; FER validation lives in benchmarks/results/ (fer_curves_r5).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q,n_r", [(16, 4), (64, 8)])
def test_tems_truncated_messages_one_iter(highq_codes, small_codes, q, n_r):
    spec = small_codes["gf16_tiny"] if q == 16 else highq_codes[64]
    g, cw, llr = _noisy_llrs(spec, 2, 3.0, seed=41)
    oracle = OracleDecoder(spec, kind="tems", n_r=n_r)
    C1 = _one_iter_messages(
        g, llr, lambda V, gg: tems.tems_cn_update(V, gg, n_r=n_r))
    for b in range(llr.shape[0]):
        _, _, _, C_o = oracle.decode(
            llr[b], max_iters=1, early_term=False, return_messages=True
        )
        for m in range(spec.m):
            for j in range(len(spec.row_cols[m])):
                np.testing.assert_allclose(
                    C1[b, m, j], C_o[m][j], rtol=2e-3, atol=2e-3,
                    err_msg=f"trunc q={q} frame {b} check {m} slot {j}",
                )


def test_tems_truncated_hard_decisions(small_codes):
    spec = small_codes["gf16_tiny"]
    g, cw, llr = _noisy_llrs(spec, 12, 3.0, seed=42)
    oracle = OracleDecoder(spec, kind="tems", n_r=4)
    res = tems.decode(g, jnp.asarray(llr), max_iters=5, n_r=4)
    for b in range(llr.shape[0]):
        hard_o, done_o, iters_o = oracle.decode(llr[b], max_iters=5)
        np.testing.assert_array_equal(
            np.array(res.hard)[b], hard_o, err_msg=f"frame {b}")
        assert bool(np.array(res.done)[b]) == done_o, f"frame {b}"
