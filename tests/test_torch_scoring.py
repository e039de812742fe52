"""The port's scoring ops against ``fastforward_tpu.ops.scoring``.

Same numpy inputs through both packages: the streamed candidate layout,
streamed and bounded scoring, and the fused serve tails (including ties).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastforward_tpu.ops import scoring as jscoring
from fastforward_tpu_torch.ops import scoring
from fastforward_tpu_torch.ops import stream_kernel as sk
from fastforward_tpu_torch.runtime import idmap

N_PAD, DIM, QB = 8192, 256, 32


def _pairs(seed: int, p: int):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((N_PAD, DIM), dtype=np.float32)
    q = rng.standard_normal((QB, DIM), dtype=np.float32)
    q[QB - 1] = 0.0
    rows = rng.integers(0, N_PAD, size=p).astype(np.int64)
    qno = np.sort(rng.integers(0, QB - 1, size=p)).astype(np.int64)
    return table, q, rows, qno


def _assert_tier_close(got, want, precision):
    """exact/high: atol 1e-4, rtol 1e-5 (``tests/test_stream_kernel.py:84``).
    fast: the port rounds operands to bf16 as the TPU did, while JAX's CPU
    default is fp32 — held to the repo's fast-tier check (mean error below
    2% of the scale, correlation above 0.999, ``:86-90``)."""
    if precision == "fast":
        scale = np.abs(want).mean()
        assert np.abs(got - want).mean() < 0.02 * scale
        assert np.corrcoef(got, want)[0, 1] > 0.999
    else:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("builder", ["native", "numpy"])
def test_streamed_layout_identical_to_jax(builder, monkeypatch):
    _, _, rows, qno = _pairs(0, 20_000)
    if builder == "numpy":
        monkeypatch.setattr(idmap, "native_stream_layout", lambda *a: None)
    for cap in (128, 512):
        got = scoring.build_streamed_layout(rows, qno, N_PAD, QB, r=512, cap=cap)
        want = jscoring.build_streamed_layout(rows, qno, N_PAD, QB, r=512, cap=cap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert scoring.build_streamed_layout(rows, qno, N_PAD, 2**22 + 1, r=1024) is None


def test_adaptive_cap_and_bucket_match_jax():
    for p, tiles in [(1, 1), (5000, 16), (512_000, 3907), (10**7, 10)]:
        assert scoring._adaptive_cap(p, tiles) == jscoring._adaptive_cap(p, tiles)
    for n in (0, 1, 255, 256, 257, 5000, 512_000):
        assert scoring.bucket(n) == jscoring.bucket(n)


@pytest.mark.parametrize("precision", ["exact", "high", "fast"])
def test_streamed_scores_match_jax(precision):
    table, q, rows, qno = _pairs(1, 6000)
    want = jscoring.streamed_scores(jnp.asarray(table), q, rows, qno, precision=precision)
    plan = {}
    got = scoring.streamed_scores(
        torch.from_numpy(table), q, rows, qno, precision=precision, plan=plan
    )
    assert got.shape == (rows.shape[0],)
    _assert_tier_close(got, want, precision)
    # a warm call reuses the cached layout and query upload
    layout, q_dev = plan["stream"], plan["q_dev"][1]
    again = scoring.streamed_scores(
        torch.from_numpy(table), q, rows, qno, precision=precision, plan=plan, fetch=False
    )
    assert plan["stream"] is layout and plan["q_dev"][1] is q_dev
    np.testing.assert_array_equal(again.numpy(), got)


def test_streamed_scores_bf16_table_matches_jax():
    table, q, rows, qno = _pairs(2, 6000)
    want = jscoring.streamed_scores(jnp.asarray(table, dtype=jnp.bfloat16), q, rows, qno)
    got = scoring.streamed_scores(torch.from_numpy(table).to(torch.bfloat16), q, rows, qno)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("precision", ["exact", "high", "fast"])
def test_score_pairs_bounded_matches_jax(precision):
    table, q, rows, qno = _pairs(3, 300)
    s = scoring.bucket(rows.shape[0])
    rows_p = np.zeros(s, dtype=np.int32)
    rows_p[: rows.shape[0]] = rows
    bounds = np.searchsorted(qno, np.arange(QB), side="right").astype(np.int32)
    want = np.asarray(
        jscoring.score_pairs_bounded(jnp.asarray(table), q, rows_p, bounds, precision=precision)
    )
    got = scoring.score_pairs_bounded(
        torch.from_numpy(table), torch.from_numpy(q), torch.from_numpy(rows_p),
        torch.from_numpy(bounds), precision=precision,
    ).numpy()
    assert got.shape == (s,)
    n = rows.shape[0]
    _assert_tier_close(got[:n], want[:n], precision)
    # padding pairs fall past the last bound onto the zero padding query
    np.testing.assert_array_equal(got[n:], 0.0)


def _serve_inputs(seed: int, n_q: int = 12, depth: int = 40, ties: bool = False):
    rng = np.random.default_rng(seed)
    n_pairs = n_q * depth
    s = scoring.bucket(n_pairs)
    sem = np.zeros(s, dtype=np.float32)
    lex = np.zeros(s, dtype=np.float32)
    sem[:n_pairs] = rng.standard_normal(n_pairs).astype(np.float32)
    lex[:n_pairs] = rng.integers(0, 50, n_pairs).astype(np.float32)
    if ties:
        # whole blocks of equal interpolated scores: the lower slot wins
        sem[:n_pairs] = np.round(sem[:n_pairs])
        lex[:n_pairs] = np.float32(3.0)
    d_max = 64
    slot = np.full((n_q, d_max), -1, dtype=np.int32)
    for qi in range(n_q):
        d = depth - (qi % 5)  # ragged depths leave -1 padding
        slot[qi, :d] = qi * depth + np.arange(d)
    slot = slot[rng.permutation(n_q)]
    return sem, lex, slot


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("cutoff", [1, 10, 64])
def test_serve_topk_matches_jax(cutoff, ties):
    sem, lex, slot = _serve_inputs(4, ties=ties)
    want = np.asarray(jscoring.serve_topk(sem, lex, slot, np.float32(0.2), cutoff))
    got = scoring.serve_topk(
        torch.from_numpy(sem), torch.from_numpy(lex), torch.from_numpy(slot), 0.2, cutoff
    ).numpy()
    assert got.shape == (2, slot.shape[0], cutoff) and got.dtype == np.int32
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0].view(np.float32), want[0].view(np.float32), rtol=1e-6)
    # the host twin selects the same slots
    vals, idx = scoring.serve_topk_host(sem, lex, slot, 0.2, cutoff)
    np.testing.assert_array_equal(idx, got[1])
    dec_vals, dec_idx = scoring.decode_serve_topk(got)
    np.testing.assert_array_equal(dec_idx, idx)
    np.testing.assert_allclose(dec_vals, vals, rtol=1e-6)


def test_serve_topk_ties_go_to_the_lower_slot():
    sem = np.zeros(256, dtype=np.float32)
    lex = np.zeros(256, dtype=np.float32)
    sem[:6] = [1.0, 2.0, 2.0, 1.0, 2.0, 0.5]
    slot = np.array([[0, 1, 2, 3, 4, 5, -1, -1]], dtype=np.int32)
    got = scoring.serve_topk(
        torch.from_numpy(sem), torch.from_numpy(lex), torch.from_numpy(slot), 0.0, 4
    ).numpy()
    np.testing.assert_array_equal(got[1, 0], [1, 2, 4, 0])
    want = np.asarray(jscoring.serve_topk(sem, lex, slot, np.float32(0.0), 4))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_serve_topk_refine_matches_jax(ties):
    table, q, _, _ = _pairs(5, 1)
    sem, lex, slot = _serve_inputs(6, ties=ties)
    rng = np.random.default_rng(7)
    n_q = slot.shape[0]
    rows_pad = rng.integers(0, N_PAD, size=sem.shape[0]).astype(np.int32)
    if ties:
        rows_pad[:] = 17  # every candidate scores the same row: exact ties
    q_perm = rng.permutation(n_q).astype(np.int32)
    # fast-tier preselection scores, as the fused serve passes them
    fast = np.einsum(
        "pd,pd->p",
        table[rows_pad].astype(jnp.bfloat16).astype(np.float32),
        q[np.arange(sem.shape[0]) % n_q].astype(jnp.bfloat16).astype(np.float32),
    ).astype(np.float32)
    want = np.asarray(
        jscoring.serve_topk_refine(
            fast, lex, slot, np.float32(0.2), 10, 22, jnp.asarray(table), rows_pad, q, q_perm
        )
    )
    got = scoring.serve_topk_refine(
        torch.from_numpy(fast), torch.from_numpy(lex), torch.from_numpy(slot), 0.2, 10, 22,
        torch.from_numpy(table), torch.from_numpy(rows_pad), torch.from_numpy(q),
        torch.from_numpy(q_perm),
    ).numpy()
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0].view(np.float32), want[0].view(np.float32), atol=1e-4, rtol=1e-5)


def test_masked_reduce_and_interpolate_match():
    rng = np.random.default_rng(8)
    mat = rng.standard_normal((50, 4)).astype(np.float32)
    counts = rng.integers(1, 5, size=50).astype(np.int32)
    for op in ("first", "max", "mean"):
        want = np.asarray(jscoring._masked_reduce(jnp.asarray(mat), jnp.asarray(counts), op))
        np.testing.assert_allclose(scoring.masked_reduce_host(mat, counts, op), want, rtol=1e-6)
        got = scoring._masked_reduce(torch.from_numpy(mat), torch.from_numpy(counts), op)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    lex, sem = mat[:, 0], mat[:, 1]
    np.testing.assert_allclose(
        scoring.interpolate_scores(torch.from_numpy(lex), torch.from_numpy(sem), 0.3).numpy(),
        np.asarray(jscoring.interpolate_scores(jnp.asarray(lex), jnp.asarray(sem), 0.3)),
        rtol=1e-6,
    )


def test_fetch_np_overlapped_reports_every_row():
    x = torch.arange(1000, dtype=torch.float32)
    seen = []
    out = scoring.fetch_np_overlapped(x, on_chunk=lambda lo, hi: seen.append((lo, hi)))
    np.testing.assert_array_equal(out, x.numpy())
    assert seen == [(0, 1000)]
    assert np.array_equal(scoring.fetch_np_async(x)(), x.numpy())


def test_plain_kernel_chunks_agree():
    """The plain version's slot chunking does not change a result."""
    table, q, rows, qno = _pairs(9, 3000)
    cand, tile_idx, _ = scoring.build_streamed_layout(rows, qno, N_PAD, QB, cap=128)
    args = (torch.from_numpy(table), torch.from_numpy(q),
            torch.from_numpy(cand.reshape(cand.shape[0], 1, 128)), torch.from_numpy(tile_idx))
    whole = sk.stream_select_pairwise_plain(*args)
    old = sk._PLAIN_CHUNK_SLOTS
    try:
        sk._PLAIN_CHUNK_SLOTS = 100
        chunked = sk.stream_select_pairwise_plain(*args)
    finally:
        sk._PLAIN_CHUNK_SLOTS = old
    np.testing.assert_array_equal(chunked.numpy(), whole.numpy())
