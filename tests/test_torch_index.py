"""The whole slice: the port's index against ``fastforward_tpu``'s.

Both indexes hold the same vectors — the port's is rebuilt from the JAX
index's ``(vector, doc_id, psg_id)`` triples through
``convert.index_from_triples`` — and score the same runs with the same
fixed query vectors (``LambdaEncoder``).  The port runs on the CPU here,
so its kernels run their plain versions.
"""

import numpy as np
import pytest

import fastforward_tpu as fj
import fastforward_tpu_torch as ft
from fastforward_tpu.encoder import LambdaEncoder as JaxLambdaEncoder
from fastforward_tpu.index import InMemoryIndex as JaxInMemoryIndex
from fastforward_tpu.index import Mode as JaxMode
from fastforward_tpu_torch import convert
from fastforward_tpu_torch.encoder import LambdaEncoder
from fastforward_tpu_torch.index import InMemoryIndex, Mode, ScoreFuture
from fastforward_tpu_torch.parallel import MeshConfig
from fastforward_tpu_torch.ops import stream_kernel as sk
from fastforward_tpu_torch.quantizer import ScalarQuantizer

N, DIM, QUERIES, DEPTH = 8192, 256, 24, 80
PSG_PER_DOC = 2


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    corpus = rng.standard_normal((N, DIM), dtype=np.float32)
    qvecs = rng.standard_normal((QUERIES, DIM), dtype=np.float32)
    by_text = {f"query {i}": qvecs[i] for i in range(QUERIES)}
    queries = {f"q{i}": f"query {i}" for i in range(QUERIES)}
    runs = {}
    for mode, n_ids, prefix in (("PASSAGE", N, "p"), ("FIRSTP", N // PSG_PER_DOC, "d")):
        run = {}
        for qi in range(QUERIES):
            cand = rng.choice(n_ids, size=DEPTH, replace=False)
            run[f"q{qi}"] = {f"{prefix}{c}": float(DEPTH - i) for i, c in enumerate(cand)}
        runs[mode] = run
    return corpus, by_text, queries, runs


def _indexes(data, mode: str, device_dtype: str, precision: str):
    corpus, by_text, _, _ = data
    jax_index = JaxInMemoryIndex(
        query_encoder=JaxLambdaEncoder(by_text.__getitem__),
        mode=JaxMode[mode],
        device_dtype=device_dtype,
        precision=precision,
    )
    jax_index.add(
        corpus,
        doc_ids=[f"d{i // PSG_PER_DOC}" for i in range(N)],
        psg_ids=[f"p{i}" for i in range(N)],
    )
    index = convert.index_from_triples(
        iter(jax_index),
        JaxMode[mode],
        query_encoder=LambdaEncoder(by_text.__getitem__),
        device_dtype=device_dtype,
        precision=precision,
        device="cpu",
    )
    return jax_index, index


def _rankings(data, mode: str, run=None):
    _, _, queries, runs = data
    run = runs[mode] if run is None else run
    qs = {q: queries[q] for q in run}
    return fj.Ranking.from_run(run, queries=qs), ft.Ranking.from_run(run, queries=qs)


def _cols(ranking):
    df = ranking._df
    return (
        df["q_id"].astype(str).to_numpy(),
        df["id"].astype(str).to_numpy(),
        df["score"].to_numpy(dtype=np.float64),
    )


def _assert_scores(got, want, precision):
    """exact/high: atol 1e-4, rtol 1e-5 per pair, same row order; fast (bf16
    operands here, fp32 in JAX on the CPU): the repo's fast-tier check."""
    gq, gi, gs = _cols(got)
    wq, wi, ws = _cols(want)
    assert len(gs) == len(ws)
    if precision == "fast":
        key = {(q, i): s for q, i, s in zip(wq, wi, ws)}
        aligned = np.array([key[(q, i)] for q, i in zip(gq, gi)])
        scale = np.abs(aligned).mean()
        assert np.abs(gs - aligned).mean() < 0.02 * scale
        assert np.corrcoef(gs, aligned)[0, 1] > 0.999
        np.testing.assert_array_equal(gq, wq)
    else:
        np.testing.assert_array_equal(gq, wq)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gs, ws, atol=1e-4, rtol=1e-5)


def _assert_same_topk(got, want):
    gq, gi, gs = _cols(got)
    wq, wi, ws = _cols(want)
    np.testing.assert_array_equal(gq, wq)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, ws, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("precision", ["exact", "high", "fast"])
@pytest.mark.parametrize("device_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["PASSAGE", "FIRSTP"])
def test_slice_matches_jax(data, mode, device_dtype, precision):
    jax_index, index = _indexes(data, mode, device_dtype, precision)
    jr, tr = _rankings(data, mode)

    before = sk.stream_select_pairwise.launches
    scored = index(tr)
    _assert_scores(scored, jax_index(jr), precision)
    assert sk.stream_select_pairwise.launches == before  # CPU: plain version
    plan = index._get_plan(tr)
    assert plan["ready"] and "stream" in plan  # dense: the streamed branch

    # fused serve, with and without the two-phase refine
    refined = index.serve(tr, 0.2, 10, refine=22)
    _assert_same_topk(refined, jax_index.serve(jr, 0.2, 10, refine=22))
    served = index.serve(tr, 0.2, 10)
    want = jax_index.serve(jr, 0.2, 10)
    if precision == "fast":
        # bf16 operands vs JAX's fp32 CPU default: the cut may differ at the edge
        got_pairs = set(zip(*_cols(served)[:2]))
        assert len(got_pairs & set(zip(*_cols(want)[:2]))) >= 0.9 * len(got_pairs)
    else:
        _assert_same_topk(served, want)

    # warm calls reuse the plan and agree with the cold call
    layout = plan["stream"]
    assert index(tr) == scored
    assert index._get_plan(tr) is plan and plan["stream"] is layout

    # futures equal their eager forms
    fut = index.submit(tr)
    assert isinstance(fut, ScoreFuture) and fut.pipelined
    assert fut.result() == scored and fut.result() is fut.result()
    assert index.submit_serve(tr, 0.2, 10, refine=22).result() == refined


@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_sparse_ranking_takes_the_gather_dot(data, precision):
    """Sparse candidate sets (n_pairs * 500 <= N) score through the bounded
    gather-dot, in both packages, with the same results."""
    _, _, _, runs = data
    run = {f"q{i}": dict(list(runs["PASSAGE"][f"q{i}"].items())[:4]) for i in range(4)}
    jax_index, index = _indexes(data, "PASSAGE", "float32", precision)
    jr, tr = _rankings(data, "PASSAGE", run)
    assert len(tr._df) * 500 <= N
    _assert_scores(index(tr), jax_index(jr), precision)
    plan = index._get_plan(tr)
    assert "bounded" in plan and "stream" not in plan
    _assert_same_topk(index.serve(tr, 0.5, 3, refine=2), jax_index.serve(jr, 0.5, 3, refine=2))


def test_missing_id_raises(data):
    _, index = _indexes(data, "PASSAGE", "float32", "exact")
    _, _, queries, _ = data
    bad = ft.Ranking.from_run({"q0": {"p1": 1.0, "nope": 0.5}}, queries={"q0": queries["q0"]})
    with pytest.raises(IndexError):
        index(bad)
    with pytest.raises(IndexError):
        index.serve(bad, 0.2, 1)


def test_convert_carries_rows_and_ids(data):
    corpus, _, _, _ = data
    jax_index, index = _indexes(data, "PASSAGE", "float32", "exact")
    assert len(index) == len(jax_index) == N and index.dim == DIM
    assert index.psg_ids == jax_index.psg_ids and index.doc_ids == jax_index.doc_ids
    assert index.mode is Mode.PASSAGE
    again = convert.index_from_arrays(
        corpus, None, [f"p{i}" for i in range(N)], "PASSAGE", device="cpu"
    )
    np.testing.assert_array_equal(index._store[:N], corpus)
    np.testing.assert_array_equal(again._store[:N], corpus)
    rows, _ = index._ids.resolve([f"p{i}" for i in (0, 5, N - 1)], Mode.PASSAGE)
    np.testing.assert_array_equal(rows, [0, 5, N - 1])
    with pytest.raises(ValueError):
        convert.index_from_triples(iter(()), "PASSAGE", device="cpu")


@pytest.mark.parametrize(
    "kwargs, err",
    [
        ({"store": "device"}, None),
        ({"hbm_budget": 4 << 20}, None),
        ({"mesh_config": MeshConfig(data=2, shard=4)}, None),
        ({"hbm_budget": 4 << 20, "stream_chunk_rows": 1024}, None),
        ({"score_transport": "u16"}, None),
        ({"score_transport": "f16"}, ValueError),
        ({"store": "disk"}, ValueError),
        ({"device_dtype": "float16"}, ValueError),
        ({"precision": "bf16"}, ValueError),
    ],
)
def test_unported_options_raise(data, kwargs, err):
    """Bad option values raise; every option the port has (``err`` is
    ``None``: the device store, the hybrid tier at a budget of half the
    table, a table sharded over a ``(2, 4)`` mesh of CPU slots, the u16
    score transport) constructs and scores within the u16 transport's bound,
    ``(max - min) / 131070`` of the f32 port's scores (the other options
    score exactly)."""
    if err is not None:
        with pytest.raises(err):
            InMemoryIndex(device="cpu", **kwargs)
        return
    corpus, by_text, queries, runs = data
    indexes = []
    for extra in (kwargs, {}):
        index = InMemoryIndex(
            query_encoder=LambdaEncoder(by_text.__getitem__), mode=Mode.PASSAGE, device="cpu", **extra
        )
        index.add(corpus, psg_ids=[f"p{i}" for i in range(N)])
        indexes.append(index)
    ranking = ft.Ranking.from_run(runs["PASSAGE"], queries=queries)
    got, want = (dict(zip(zip(*_cols(ix(ranking))[:2]), _cols(ix(ranking))[2])) for ix in indexes)
    assert got.keys() == want.keys()
    span = max(want.values()) - min(want.values())
    err_max = max(abs(got[key] - s) for key, s in want.items())
    assert err_max <= span / 131070 * (1 + 1e-3) + 1e-5
    if "score_transport" not in kwargs:
        assert err_max == 0.0
        view = indexes[0]._device_view()
        assert (view.kind == "hybrid") == ("hbm_budget" in kwargs)
        assert (indexes[0]._store is None) == ("store" in kwargs)


def test_quantizer_must_be_a_trained_quantizer():
    with pytest.raises(TypeError):
        InMemoryIndex(device="cpu", quantizer=object())
    with pytest.raises(RuntimeError):  # untrained
        InMemoryIndex(device="cpu", quantizer=ScalarQuantizer())


def test_unported_scoring_paths_raise(data, monkeypatch):
    """The scoring paths that once raised, naming their ROADMAP items, now
    score: the u16 score transport (item 5), the document modes, early
    stopping, query batches, and scoring without a device table (item 7:
    the host gather of on-disk indexes, which reads the rows through
    ``_get_vectors`` and scores them as the device table does)."""
    corpus, by_text, _, _ = data
    u16 = InMemoryIndex(
        query_encoder=LambdaEncoder(by_text.__getitem__), mode=Mode.MAXP, device="cpu",
        score_transport="u16",
    )
    u16.add(corpus[:8], doc_ids=[f"d{i // 2}" for i in range(8)])
    r16 = ft.Ranking.from_run({"q0": {"d1": 1.0, "d2": 0.5}}, queries={"q0": "query 0"})
    want = {d: float(np.max(corpus[2 * int(d[1:]) : 2 * int(d[1:]) + 2] @ by_text["query 0"]))
            for d in ("d1", "d2")}
    got = u16(r16)["q0"]
    assert got.keys() == want.keys()
    bound = abs(want["d1"] - want["d2"]) / 131070 + 1e-5
    assert all(abs(got[d] - want[d]) <= bound for d in want)
    index = InMemoryIndex(
        query_encoder=LambdaEncoder(by_text.__getitem__), mode=Mode.MAXP, device="cpu"
    )
    index.add(corpus[:8], doc_ids=[f"d{i // 2}" for i in range(8)])
    r = ft.Ranking.from_run({"q0": {"d1": 1.0, "d2": 0.5}}, queries={"q0": "query 0"})
    assert len(index(r)._df) == 2
    assert len(index(r, early_stopping=1, early_stopping_alpha=0.2, early_stopping_depths=[1, 2])._df) >= 1
    assert len(index.serve(r, 0.2, 1, early_stopping_depths=[1, 2])._df) == 1
    assert index(r, batch_size=1) == index(r)
    r3 = ft.Ranking.from_run({"q0": {"d3": 1.0, "d0": 0.5}}, queries={"q0": "query 0"})
    with_table = index(r3)["q0"]
    monkeypatch.setattr(index, "_device_view", lambda: None)
    gathered = index(r3)["q0"]
    assert gathered.keys() == with_table.keys()
    assert all(abs(gathered[d] - with_table[d]) <= 1e-5 for d in gathered)
    assert index.serve(r3, 0.2, 1) == r3.interpolate(index(r3), 0.2).cut(1)
