"""Document ranking: the port's MAXP, AVEP and multi-passage FIRSTP against
``fastforward_tpu``'s.

Both packages hold the same vectors (``convert.index_from_triples``) or the
same codes (``convert.index_from_codes``) of a corpus of documents with 1-7
passages each, plus three documents of 70 passages that only the ragged run
reaches (more than 64 rows per pair: the flat segment path), and score the
same runs with the same fixed query vectors.  The port runs on the CPU, so
its kernels run their plain versions.  Scores agree within atol 1e-4, rtol
1e-5 (fp32 sums in another order) unless a test states otherwise.
"""

import numpy as np
import pytest
import torch

import fastforward_tpu as fj
import fastforward_tpu_torch as ft
from fastforward_tpu.encoder import LambdaEncoder as JaxLambdaEncoder
from fastforward_tpu.index import InMemoryIndex as JaxInMemoryIndex
from fastforward_tpu.index import Mode as JaxMode
from fastforward_tpu.ops import scoring as jscoring
from fastforward_tpu.quantizer import OPQ as JaxOPQ
from fastforward_tpu.quantizer import PQ as JaxPQ
from fastforward_tpu.quantizer import ScalarQuantizer as JaxScalarQuantizer
from fastforward_tpu_torch import convert, ops
from fastforward_tpu_torch.encoder import LambdaEncoder
from fastforward_tpu_torch.index import ScoreFuture
from fastforward_tpu_torch.index import base as index_base
from fastforward_tpu_torch.index.util import expand_pairs
from fastforward_tpu_torch.ops import scoring
from fastforward_tpu_torch.ops import stream_kernel as sk
from fastforward_tpu_torch.ops import stream_kernel_pq as skpq

N, DIM, QUERIES = 8192, 256, 24
RAGGED_DOCS, RAGGED_PSGS = 3, 70
DOC_MODES = ["MAXP", "AVEP", "FIRSTP"]

#: queries x depth (documents) per run: "doc" at 1,920 pairs x K = 8 over 16
#: tiles of 512 rows streams at cap 1024 > r (K2 / K4); "shallow" at cap 512
#: <= r (K1 / K3); "sparse" (2 pairs x K <= 8: 16 * 500 <= N) takes the
#: grouped gather
RUNS = {"doc": (QUERIES, 80), "shallow": (QUERIES, 30), "sparse": (2, 1)}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    n_regular = N - RAGGED_DOCS * RAGGED_PSGS
    counts = rng.integers(1, 8, size=n_regular)
    counts = counts[: int(np.searchsorted(np.cumsum(counts), n_regular)) + 1]
    counts[-1] -= counts.sum() - n_regular  # the last run cut to fit
    counts = np.concatenate([counts, np.full(RAGGED_DOCS, RAGGED_PSGS)])
    doc_ids = [f"d{d}" for d, c in enumerate(counts) for _ in range(c)]
    n_docs = len(counts)
    corpus = rng.standard_normal((N, DIM), dtype=np.float32)
    qvecs = rng.standard_normal((QUERIES, DIM), dtype=np.float32)
    by_text = {f"query {i}": qvecs[i] for i in range(QUERIES)}
    regular = n_docs - RAGGED_DOCS
    runs = {
        name: {
            f"q{qi}": {
                f"d{c}": float(depth - i)
                for i, c in enumerate(rng.choice(regular, size=depth, replace=False))
            }
            for qi in range(nq)
        }
        for name, (nq, depth) in RUNS.items()
    }
    # every query also ranks one of the 70-passage documents
    runs["ragged"] = {
        q: {**dict(list(cands.items())[:20]), f"d{regular + qi % RAGGED_DOCS}": 0.5}
        for qi, (q, cands) in enumerate(runs["shallow"].items())
    }
    return corpus, doc_ids, by_text, runs, counts


def _encoders(data):
    _, _, by_text, _, _ = data
    return JaxLambdaEncoder(by_text.__getitem__), LambdaEncoder(by_text.__getitem__)


def _dense_indexes(data, device_dtype="float32", precision="exact"):
    corpus, doc_ids, _, _, _ = data
    jenc, tenc = _encoders(data)
    jax_index = JaxInMemoryIndex(
        query_encoder=jenc, mode=JaxMode.MAXP, device_dtype=device_dtype, precision=precision
    )
    jax_index.add(corpus, doc_ids=doc_ids, psg_ids=[f"p{i}" for i in range(N)])
    index = convert.index_from_triples(
        iter(jax_index), JaxMode.MAXP, query_encoder=tenc, device_dtype=device_dtype,
        precision=precision, device="cpu",
    )
    return jax_index, index


_QUANTIZERS = {
    "int8": lambda: JaxScalarQuantizer(),
    "PQ": lambda: JaxPQ(16, 16),
    "OPQ": lambda: JaxOPQ(16, 16, opq_iters=2),
}


def _quantized_indexes(data, kind):
    corpus, doc_ids, _, _, _ = data
    jenc, tenc = _encoders(data)
    jq = _QUANTIZERS[kind]()
    jq.fit(corpus[:1024])
    psg_ids = [f"p{i}" for i in range(N)]
    jax_index = JaxInMemoryIndex(query_encoder=jenc, quantizer=jq, mode=JaxMode.MAXP)
    jax_index.add(corpus, doc_ids=doc_ids, psg_ids=psg_ids)
    index = convert.index_from_codes(
        jax_index._store[:N], doc_ids, psg_ids, JaxMode.MAXP,
        convert.quantizer_from_state(*jq.serialize(), device="cpu"),
        query_encoder=tenc, device="cpu",
    )
    return jax_index, index


@pytest.fixture(scope="module")
def dense(data):
    """(JAX index, port index) of fp32 vectors, exact tier."""
    return _dense_indexes(data)


def _set_mode(indexes, mode):
    jax_index, index = indexes
    jax_index.mode = JaxMode[mode]
    index.mode = ft.Mode[mode]
    return jax_index, index


def _rankings(data, name):
    _, _, _, runs, _ = data
    run = runs[name]
    queries = {q: f"query {q[1:]}" for q in run}
    return fj.Ranking.from_run(run, queries=queries), ft.Ranking.from_run(run, queries=queries)


def _cols(ranking):
    df = ranking._df
    return (
        df["q_id"].astype(str).to_numpy(),
        df["id"].astype(str).to_numpy(),
        df["score"].to_numpy(dtype=np.float64),
    )


def _assert_same(got, want, precision="exact"):
    """exact/high: the same pairs in the same order, scores at atol 1e-4,
    rtol 1e-5.  fast (bf16 operands here, fp32 in JAX on the CPU): the
    repo's fast-tier check on the scores aligned by pair (mean error under
    2% of the scale, correlation above 0.999), the same queries in order."""
    gq, gi, gs = _cols(got)
    wq, wi, ws = _cols(want)
    assert len(gs) == len(ws)
    np.testing.assert_array_equal(gq, wq)
    if precision == "fast":
        key = {(q, i): s for q, i, s in zip(wq, wi, ws)}
        aligned = np.array([key[(q, i)] for q, i in zip(gq, gi)])
        assert np.abs(gs - aligned).mean() < 0.02 * np.abs(aligned).mean()
        assert np.corrcoef(gs, aligned)[0, 1] > 0.999
    else:
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gs, ws, atol=1e-4, rtol=1e-5)


def _spy_kernels(monkeypatch):
    """Record the kernel wrappers the routers call (by name)."""
    calls = []
    for module, names in (
        (sk, ("stream_select_pairwise", "stream_select")),
        (skpq, ("stream_select_pq_pairwise", "stream_select_pq")),
    ):
        for name in names:
            real = getattr(module, name)

            def spy(*args, _real=real, _name=name, **kw):
                calls.append(_name)
                return _real(*args, **kw)

            monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("precision", ["exact", "high", "fast"])
@pytest.mark.parametrize("device_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", DOC_MODES)
def test_doc_modes_match_jax(data, mode, device_dtype, precision):
    """Re-rank, fused serve and their futures, cold and warm, through the
    streamed branch with the K-reduce on the device."""
    jax_index, index = _set_mode(_dense_indexes(data, device_dtype, precision), mode)
    jr, tr = _rankings(data, "doc")
    scored = index(tr)
    _assert_same(scored, jax_index(jr), precision)
    plan = index._get_plan(tr)
    assert plan["ready"] and "stream" in plan
    assert plan["cands"].k == (1 if mode == "FIRSTP" else 8)
    assert ("counts_dev" in plan) == (mode != "FIRSTP")

    served = index.serve(tr, 0.2, 10)
    want = jax_index.serve(jr, 0.2, 10)
    if precision == "fast":
        # bf16 operands vs JAX's fp32 CPU default: the cut may differ at the edge
        got_pairs = set(zip(*_cols(served)[:2]))
        assert len(got_pairs & set(zip(*_cols(want)[:2]))) >= 0.9 * len(got_pairs)
    else:
        _assert_same(served, want)
    # refine is live only for one row per pair, as in the JAX package
    _assert_same(index.serve(tr, 0.2, 10, refine=22), jax_index.serve(jr, 0.2, 10, refine=22),
                 precision)

    # warm calls reuse the plan and agree with the cold call
    layout = plan["stream"]
    assert index(tr) == scored
    assert index._get_plan(tr) is plan and plan["stream"] is layout
    fut = index.submit(tr)
    assert isinstance(fut, ScoreFuture) and fut.pipelined and fut.result() == scored
    assert index.submit_serve(tr, 0.2, 10).result() == served


@pytest.mark.parametrize("run", ["shallow", "doc"], ids=["cap_le_r", "cap_gt_r"])
@pytest.mark.parametrize("mode", ["MAXP", "AVEP"])
@pytest.mark.parametrize("kind", list(_QUANTIZERS))
def test_quantized_doc_modes_match_jax(monkeypatch, data, kind, mode, run):
    """int8, PQ and OPQ codes in MAXP and AVEP: re-rank and serve, through
    the kernel the router picks (K1 / K3 at cap <= r, K2 / K4 above)."""
    jax_index, index = _set_mode(_quantized_indexes(data, kind), mode)
    jr, tr = _rankings(data, run)
    calls = _spy_kernels(monkeypatch)
    _assert_same(index(tr), jax_index(jr))
    _assert_same(index.serve(tr, 0.2, 10), jax_index.serve(jr, 0.2, 10))
    dense_tiles = run == "doc"
    if kind == "int8":
        want = "stream_select" if dense_tiles else "stream_select_pairwise"
    else:
        want = "stream_select_pq" if dense_tiles else "stream_select_pq_pairwise"
    assert calls == [want, want]


@pytest.mark.parametrize("kind", ["dense", "int8", "PQ"])
@pytest.mark.parametrize("mode", DOC_MODES)
def test_gather_branch_matches_jax(monkeypatch, data, mode, kind):
    """The grouped gather (sparse candidate sets): a run of 2 pairs takes it
    in both packages; with streaming switched off in the port, the full run
    takes it too and agrees with the JAX package's streamed scores."""
    indexes = _dense_indexes(data) if kind == "dense" else _quantized_indexes(data, kind)
    jax_index, index = _set_mode(indexes, mode)
    jr, tr = _rankings(data, "sparse")
    calls = _spy_kernels(monkeypatch)
    _assert_same(index(tr), jax_index(jr))
    plan = index._get_plan(tr)
    assert "stream" not in plan and "stream_pq" not in plan
    assert ("grouped_idx" in plan) == (mode != "FIRSTP" or kind == "PQ")
    monkeypatch.setattr(ops, "STREAM_DENSITY", 0)
    monkeypatch.setattr(ops, "STREAM_DENSITY_PQ", 0)
    jr, tr = _rankings(data, "doc")
    _assert_same(index(tr), jax_index(jr))
    _assert_same(index.serve(tr, 0.2, 10), jax_index.serve(jr, 0.2, 10))
    assert calls == []


@pytest.mark.parametrize("stream", [True, False], ids=["streamed", "gather"])
@pytest.mark.parametrize("mode", ["PASSAGE", "MAXP"])
def test_ungrouped_ranking_matches_jax(monkeypatch, data, dense, mode, stream):
    """Pairs not grouped by query (a trusted frame in shuffled row order):
    streamed, or through the grouped gather instead of the bounded one."""
    corpus, _, _, runs, _ = data
    jax_index, index = _set_mode(dense, mode)
    run = runs["shallow"]
    if mode == "PASSAGE":
        run = {q: {f"p{int(d[1:])}": s for d, s in c.items()} for q, c in run.items()}
    queries = {q: f"query {q[1:]}" for q in run}
    frame = ft.Ranking.from_run(run, queries=queries)._df
    shuffled = frame.iloc[np.random.default_rng(3).permutation(len(frame))].reset_index(drop=True)
    tr = ft.Ranking._from_trusted_frame(shuffled.copy(), "run")
    jr = fj.Ranking._from_trusted_frame(shuffled.copy(), "run")
    if not stream:
        monkeypatch.setattr(ops, "STREAM_DENSITY", 0)
    _assert_same(index(tr), jax_index(jr))
    _assert_same(index.serve(tr, 0.2, 10), jax_index.serve(jr, 0.2, 10))
    plan = index._get_plan(tr)
    assert ("stream" in plan) == stream
    assert "bounded" not in plan
    assert ("grouped_idx" in plan) == (not stream)


@pytest.mark.parametrize("batch_size", [1, 3, 7])
def test_batch_size_invariance(data, dense, batch_size):
    """Scoring in query batches gives the same ranking as one call
    (``tests/test_index.py:299-312``), in every document mode."""
    for mode in DOC_MODES:
        jax_index, index = _set_mode(dense, mode)
        jr, tr = _rankings(data, "shallow")
        whole = index(tr)
        batched = index(tr, batch_size=batch_size)
        assert batched == whole
        _assert_same(batched, jax_index(jr, batch_size=batch_size))


@pytest.mark.parametrize("mode", DOC_MODES)
def test_ragged_docs_take_the_flat_path(data, dense, mode):
    """Documents of 70 passages (over 64 rows per pair): re-rank through the
    flat segment path and serve through the unfused flow, eagerly."""
    jax_index, index = _set_mode(dense, mode)
    jr, tr = _rankings(data, "ragged")
    flat = []
    real = index._device_score_flat
    index._device_score_flat = lambda *a, **kw: flat.append(1) or real(*a, **kw)
    try:
        _assert_same(index(tr), jax_index(jr))
        _assert_same(index.serve(tr, 0.3, 5), jax_index.serve(jr, 0.3, 5))
        # FIRSTP resolves one row per pair: its futures stay pipelined
        fut = index.submit(tr)
        assert fut.pipelined == (mode == "FIRSTP")
        _assert_same(fut.result(), jax_index(jr))
        assert index.submit_serve(tr, 0.3, 5).pipelined == (mode == "FIRSTP")
    finally:
        del index._device_score_flat
    assert (len(flat) > 0) == (mode != "FIRSTP")
    assert bool(index._get_plan(tr).get("ready")) == (mode == "FIRSTP")


@pytest.mark.parametrize("kind", ["dense", "int8", "PQ"])
@pytest.mark.parametrize("mode", DOC_MODES)
def test_device_score_flat_matches_jax(data, mode, kind):
    """``_device_score_flat`` called directly on both packages with the same
    flat ``(rows, qno, seg)`` layout (the more-than-2^22-queries branch
    reaches it; that many queries do not fit a test)."""
    corpus, doc_ids, by_text, runs, counts = data
    indexes = _dense_indexes(data) if kind == "dense" else _quantized_indexes(data, kind)
    jax_index, index = _set_mode(indexes, mode)
    rng = np.random.default_rng(5)
    n_pairs = 300
    offsets = np.concatenate([[0], np.cumsum(counts)])
    docs = rng.integers(0, len(counts), size=n_pairs)
    if mode == "FIRSTP":
        rows_concat, per = offsets[docs], np.ones(n_pairs, dtype=np.int64)
    else:
        rows_concat = np.concatenate([np.arange(offsets[d], offsets[d + 1]) for d in docs])
        per = counts[docs]
    pair_qno = np.sort(rng.integers(0, QUERIES, size=n_pairs))
    rows, qno, seg = expand_pairs(np.arange(n_pairs), pair_qno, rows_concat, per)
    qv = np.stack([by_text[f"query {i}"] for i in range(QUERIES)])
    want = jax_index._device_score_flat(jax_index._active_view(), qv, rows, qno, seg, n_pairs)
    got = index._device_score_flat(index._device_view(), qv, rows, qno, seg, n_pairs)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)
    dev = index._device_score_flat(index._device_view(), qv, rows, qno, seg, n_pairs, fetch=False)
    assert isinstance(dev, torch.Tensor) and dev.shape[0] == ops.bucket(n_pairs)
    np.testing.assert_array_equal(dev.numpy()[:n_pairs], got)


@pytest.mark.parametrize("mode", ["PASSAGE", "MAXP", "AVEP"])
def test_more_queries_than_the_packing_take_the_flat_path(monkeypatch, data, dense, mode):
    """More queries than the grouped packing's 22 bits hold go through the
    flat segment path (here with the limit lowered to 8 queries), for
    re-rank and the fused serve, with the JAX package's results."""
    jax_index, index = _set_mode(dense, mode)
    _, _, _, runs, _ = data
    run = runs["shallow"]
    if mode == "PASSAGE":
        run = {q: {f"p{int(d[1:])}": s for d, s in c.items()} for q, c in run.items()}
    queries = {q: f"query {q[1:]}" for q in run}
    jr, tr = fj.Ranking.from_run(run, queries=queries), ft.Ranking.from_run(run, queries=queries)
    monkeypatch.setattr(index_base, "_MAX_PACKED_QUERIES", 8)
    flat = []
    real = index._device_score_flat
    monkeypatch.setattr(index, "_device_score_flat", lambda *a, **kw: flat.append(1) or real(*a, **kw))
    _assert_same(index(tr), jax_index(jr))
    _assert_same(index.serve(tr, 0.2, 10), jax_index.serve(jr, 0.2, 10))
    assert len(flat) == 2
    assert "stream" not in index._get_plan(tr)


def test_host_k_reduce_branch(monkeypatch, data, dense):
    """A streamed scorer that returns one score per row, not per pair, is
    reduced on the host (``masked_reduce_host``) with the same result."""
    jax_index, index = _set_mode(dense, "AVEP")
    jr, tr = _rankings(data, "shallow")
    real = ops.streamed_scores
    monkeypatch.setattr(ops, "streamed_scores", lambda *a, reduce=None, **kw: real(*a, **kw))
    _assert_same(index(tr), jax_index(jr))


def test_mode_switch_keeps_plans_apart(data, dense):
    """Changing ``index.mode`` never reuses another mode's plan for the same
    ranking: each mode's warm call equals a fresh index's."""
    _, index = dense
    _, tr = _rankings(data, "shallow")
    first = {}
    for mode in ("MAXP", "AVEP", "FIRSTP", "MAXP", "AVEP"):
        index.mode = ft.Mode[mode]
        out = index(tr)
        assert out == first.setdefault(mode, out)
    _, fresh = _dense_indexes(data)
    fresh.mode = ft.Mode.AVEP
    assert fresh(tr) == first["AVEP"]
    keys = {k for k in index._plans if k[0] == id(tr._df)}
    assert {k[1] for k in keys} >= {ft.Mode.MAXP, ft.Mode.AVEP}


# -- the ops of the gather and flat paths -------------------------------------


def _op_inputs(seed, k, s, table_kind="fp32"):
    rng = np.random.default_rng(seed)
    if table_kind == "int8":
        table = rng.integers(-127, 128, size=(512, 2, 128)).astype(np.int8)
    else:
        table = rng.standard_normal((512, 256), dtype=np.float32)
    q = rng.standard_normal((16, 256), dtype=np.float32)
    idx = np.zeros((k + 1, s), dtype=np.int32)
    n = s - 40  # the tail pads (count 0)
    counts = rng.integers(1, k + 1, size=n)
    idx[:k, :n] = rng.integers(0, 512, size=(k, n))
    idx[k, :n] = (rng.integers(0, 15, size=n) << 8) | counts
    return table, q, idx, n


@pytest.mark.parametrize("precision", ["exact", "high", "fast"])
@pytest.mark.parametrize("op", ["max", "mean", "first"])
@pytest.mark.parametrize("table_kind", ["fp32", "int8"])
def test_score_pairs_grouped_matches_jax(table_kind, op, precision):
    table, q, idx, n = _op_inputs(1, 8, 256, table_kind)
    want = np.asarray(jscoring.score_pairs_grouped(table, q, idx, op, precision=precision))
    got = scoring.score_pairs_grouped(
        torch.from_numpy(table), torch.from_numpy(q), torch.from_numpy(idx), op, precision
    ).numpy()
    if precision == "fast":
        # bf16 operands here, fp32 in JAX on the CPU: the fast-tier check
        assert np.abs(got[:n] - want[:n]).mean() < 0.02 * np.abs(want[:n]).mean()
    else:
        np.testing.assert_allclose(got[:n], want[:n], atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("op", ["max", "mean", "sum"])
def test_score_pairs_dense_and_pq_match_jax(op):
    """The flat layout's dense and PQ scorers and the segment reduce (pairs
    with no rows, and the padding sentinel, included)."""
    rng = np.random.default_rng(2)
    table = rng.standard_normal((512, 256), dtype=np.float32)
    q = rng.standard_normal((16, 256), dtype=np.float32)
    p, num_out = 600, 256
    idx = np.stack([
        rng.integers(0, 512, size=p), rng.integers(0, 16, size=p),
        np.sort(rng.integers(0, num_out - 10, size=p)),
    ]).astype(np.int32)
    idx[2, -30:] = num_out  # padding rows
    want = np.asarray(jscoring.score_pairs_dense(table, q, idx, num_out, op))
    t_idx = torch.from_numpy(idx)
    got = scoring.score_pairs_dense(torch.from_numpy(table), torch.from_numpy(q), t_idx, num_out, op)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)

    codes = rng.integers(0, 16, size=(512, 8)).astype(np.uint8)
    cb = rng.standard_normal((8, 16, 32), dtype=np.float32)
    want = np.asarray(jscoring.score_pairs_pq(codes, cb, q, idx, num_out, op))
    got = scoring.score_pairs_pq(
        torch.from_numpy(codes), torch.from_numpy(cb), torch.from_numpy(q), t_idx, num_out, op
    )
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)

    row_scores = rng.standard_normal(p).astype(np.float32)
    seg = idx[2].astype(np.int64)
    want = np.asarray(jscoring._segment_reduce(row_scores, idx[2], num_out, op))
    got = scoring._segment_reduce(torch.from_numpy(row_scores), torch.from_numpy(seg), num_out, op)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    if op != "mean":
        host = scoring.host_segment_reduce(row_scores, seg, num_out + 1, op)[:num_out]
        np.testing.assert_allclose(
            host, np.asarray(jscoring.host_segment_reduce(row_scores, seg, num_out + 1, op))[:num_out],
            rtol=1e-6, atol=1e-6,
        )
        np.testing.assert_allclose(host, want, rtol=1e-5, atol=1e-5)


def test_fetch_np_passes_host_arrays_through():
    a = np.arange(4, dtype=np.float32)
    assert ops.fetch_np(a) is a
    np.testing.assert_array_equal(ops.fetch_np(torch.ones(2)), np.ones(2, dtype=np.float32))
