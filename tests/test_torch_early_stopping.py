"""Early stopping: the port against ``fastforward_tpu`` on the contract of
``tests/test_index.py:253-297`` and ``tests/test_early_stopping_extra.py``.

Both packages hold the same vectors and score the same runs with the same
fixed query vectors; the port runs on the CPU (its kernels' plain
versions).  Early stopping must return the same rows as the JAX package's,
with scores at atol 1e-4, rtol 1e-5 (fp32 sums in another order); its stop
decisions compare scores, so a decision could flip only where a margin is
under that tolerance, which the seeds here do not reach.
"""

import numpy as np
import pandas as pd
import pytest

import fastforward_tpu as fj
import fastforward_tpu_torch as ft
from fastforward_tpu.encoder import LambdaEncoder as JaxLambdaEncoder
from fastforward_tpu.index import InMemoryIndex as JaxInMemoryIndex
from fastforward_tpu.index import Mode as JaxMode
from fastforward_tpu_torch import convert
from fastforward_tpu_torch.encoder import LambdaEncoder
from fastforward_tpu_torch.index import InMemoryIndex, Mode

N, DIM, QUERIES, DEPTH = 8192, 64, 24, 200
ES = dict(early_stopping=10, early_stopping_alpha=0.3, early_stopping_depths=(20, 50, 100, 200))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(4)
    corpus = rng.standard_normal((N, DIM), dtype=np.float32)
    # semantic scores of about the lexical scores' spread, and lexical
    # scores that fall with depth, with noise: queries stop at different
    # depths
    qvecs = 0.1 * rng.standard_normal((QUERIES, DIM), dtype=np.float32)
    by_text = {f"query {i}": qvecs[i] for i in range(QUERIES)}
    run = {
        f"q{qi}": {
            f"p{c}": float(10.0 * (DEPTH - i) / DEPTH + rng.normal())
            for i, c in enumerate(rng.choice(N, size=DEPTH, replace=False))
        }
        for qi in range(QUERIES)
    }
    doc_run = {q: {f"d{int(p[1:]) // 4}": s for p, s in c.items()} for q, c in run.items()}
    return corpus, by_text, {"PASSAGE": run, "MAXP": doc_run, "AVEP": doc_run}


@pytest.fixture(scope="module")
def indexes(data):
    """(JAX index, port index) over the same vectors: 4 passages a doc."""
    corpus, by_text, _ = data
    jax_index = JaxInMemoryIndex(query_encoder=JaxLambdaEncoder(by_text.__getitem__))
    jax_index.add(
        corpus, doc_ids=[f"d{i // 4}" for i in range(N)], psg_ids=[f"p{i}" for i in range(N)]
    )
    index = convert.index_from_triples(
        iter(jax_index), "PASSAGE", query_encoder=LambdaEncoder(by_text.__getitem__), device="cpu"
    )
    return jax_index, index


def _set_mode(indexes, mode):
    jax_index, index = indexes
    jax_index.mode = JaxMode[mode]
    index.mode = Mode[mode]
    return jax_index, index


def _rankings(data, mode):
    _, _, runs = data
    queries = {q: f"query {q[1:]}" for q in runs[mode]}
    return (
        fj.Ranking.from_run(runs[mode], queries=queries),
        ft.Ranking.from_run(runs[mode], queries=queries),
    )


def _assert_same(got, want):
    """The same rows in the same order; scores at atol 1e-4, rtol 1e-5."""
    g, w = got._df, want._df
    assert len(g) == len(w)
    for col in ("q_id", "id"):
        np.testing.assert_array_equal(g[col].astype(str).to_numpy(), w[col].astype(str).to_numpy())
    np.testing.assert_allclose(g["score"].to_numpy(), w["score"].to_numpy(), atol=1e-4, rtol=1e-5)


def _contract_index(index_cls, encoder_cls, mode, **kw):
    index = index_cls(encoder_cls(lambda _: np.array([10, 10])), mode=mode.PASSAGE, **kw)
    index.add(np.stack([[1, 0], [1, 1]] * 10).astype(np.float32), psg_ids=[f"p{i}" for i in range(20)])
    return index


def _contract_frame():
    return pd.DataFrame(
        [{"q_id": q, "query": q, "id": f"p{i}", "score": i} for i in range(20) for q in ("q1", "q2")]
    )


@pytest.mark.parametrize("depths", [(2, 5, 10, 20), (5, 2, 20, 10)])
def test_es_contract(depths):
    """``tests/test_index.py:253-297``: the exact result, whatever the
    order of the depths, and the JAX package's."""
    expected = ft.Ranking(
        pd.DataFrame(
            [
                {"q_id": q, "id": f"p{i}", "score": s}
                for q in ("q2", "q1")
                for i, s in [(19, 20.0), (17, 20.0), (15, 20.0), (13, 20.0), (11, 20.0),
                             (18, 10.0), (16, 10.0), (14, 10.0), (12, 10.0), (10, 10.0)]
            ]
        )
    )
    kw = dict(early_stopping=5, early_stopping_alpha=0.5, early_stopping_depths=depths)
    got = _contract_index(InMemoryIndex, LambdaEncoder, Mode, device="cpu")(ft.Ranking(_contract_frame()), **kw)
    assert got == expected
    want = _contract_index(JaxInMemoryIndex, JaxLambdaEncoder, JaxMode)(fj.Ranking(_contract_frame()), **kw)
    _assert_same(got, want)


@pytest.mark.parametrize("mode", ["PASSAGE", "MAXP", "AVEP", "FIRSTP"])
def test_es_matches_jax(data, indexes, mode):
    """Re-rank and serve with early stopping, cold and from the cached ES
    state, in every mode; every returned row carries its full-scoring
    score."""
    run_mode = "MAXP" if mode == "FIRSTP" else mode
    jax_index, index = _set_mode(indexes, mode)
    jr, tr = _rankings(data, run_mode)
    got = index(tr, **ES)
    _assert_same(got, jax_index(jr, **ES))
    assert len(got._df) < len(tr._df)  # some queries stopped early
    assert index(tr, **ES) == got  # warm: from the ES state
    full = index(tr)
    for q_id in got.q_ids:
        ref = full[q_id]
        for pid, score in got[q_id].items():
            assert abs(ref[pid] - score) <= 1e-4 + 1e-5 * abs(score)

    depths = ES["early_stopping_depths"]
    served = index.serve(tr, 0.3, 10, early_stopping_depths=depths)
    _assert_same(served, jax_index.serve(jr, 0.3, 10, early_stopping_depths=depths))
    fut = index.submit_serve(tr, 0.3, 10, early_stopping_depths=depths)
    assert not fut.pipelined and fut.result() == served


def test_es_top_k_is_exact():
    """``test_early_stopping_extra.py``'s setup (60 passages of dim 2, three
    queries of one run): the ``cutoff`` best interpolated candidates are
    exactly those of full scoring, with the JAX package's rows."""
    rng = np.random.default_rng(77)
    n, cutoff, alpha = 60, 5, 0.5
    vectors = rng.normal(size=(n, 2)).astype(np.float32)
    qvec = np.array([1.0, 1.0], dtype=np.float32)
    run = {q: {f"p{i}": float(n - i) for i in range(n)} for q in ("q1", "q2", "q3")}
    kw = dict(early_stopping=cutoff, early_stopping_alpha=alpha, early_stopping_depths=(10, 30, 60))
    got = want = None
    for pkg, index_cls, enc_cls, mode, extra in (
        (ft, InMemoryIndex, LambdaEncoder, Mode, {"device": "cpu"}),
        (fj, JaxInMemoryIndex, JaxLambdaEncoder, JaxMode, {}),
    ):
        index = index_cls(enc_cls(lambda _: qvec), mode=mode.PASSAGE, **extra)
        index.add(vectors, psg_ids=[f"p{i}" for i in range(n)])
        out = index(pkg.Ranking.from_run(run, queries={q: q for q in run}), **kw)
        got, want = (out, want) if pkg is ft else (got, out)
    _assert_same(got, want)
    lex = run["q1"]
    exact = {p: alpha * lex[p] + (1 - alpha) * float(vectors[int(p[1:])] @ qvec) for p in lex}
    es = {p: alpha * lex[p] + (1 - alpha) * s for p, s in got["q1"].items()}
    top = sorted(exact, key=exact.get, reverse=True)[:cutoff]
    assert set(top) == set(sorted(es, key=es.get, reverse=True)[:cutoff])


@pytest.mark.parametrize("batch_size", [1, 5, 7])
@pytest.mark.parametrize("mode", ["PASSAGE", "MAXP"])
def test_es_with_batch_size_matches_unbatched(data, indexes, mode, batch_size):
    jax_index, index = _set_mode(indexes, mode)
    jr, tr = _rankings(data, mode)
    batched = index(tr, batch_size=batch_size, **ES)
    assert batched == index(tr, **ES)
    _assert_same(batched, jax_index(jr, batch_size=batch_size, **ES))


def test_alpha_sweep_served_from_the_state_cache(monkeypatch, data, indexes):
    """An alpha sweep over one ranking scores only rows no earlier alpha
    scored (a repeated alpha scores nothing) and matches a fresh ranking of
    the same run, in both packages."""
    jax_index, index = _set_mode(indexes, "PASSAGE")
    jr, tr = _rankings(data, "PASSAGE")
    scored = []
    real = index._device_score_grouped

    def counting(view, qv, rows_mat, *a, **kw):
        scored.append(rows_mat.shape[0])
        return real(view, qv, rows_mat, *a, **kw)

    monkeypatch.setattr(index, "_device_score_grouped", counting)
    rows_scored = []
    for alpha in (0.1, 0.5, 0.9, 0.5):
        kw = dict(ES, early_stopping_alpha=alpha)
        scored.clear()
        cached = index(tr, **kw)
        rows_scored.append(sum(scored))
        _, fresh = _rankings(data, "PASSAGE")
        assert cached == index(fresh, **kw)
        _assert_same(cached, jax_index(jr, **kw))
    assert rows_scored[0] > 0 and rows_scored[-1] == 0
    state = index._get_plan(tr)["es_state"]
    assert sum(rows_scored) == state["have"].sum() <= len(tr._df)


def test_changed_encoder_output_invalidates_the_state(data, indexes):
    """The ES state is checked against the query vectors' content: an
    encoder whose output changes rescores, and swapping back restores the
    first result (``test_early_stopping_extra.py``)."""
    corpus, by_text, _ = data
    _, index = _set_mode(indexes, "PASSAGE")
    _, tr = _rankings(data, "PASSAGE")
    first = index(tr, **ES)
    state = {"scale": 1.0}
    index._query_encoder = LambdaEncoder(lambda q: by_text[q] * np.float32(state["scale"]))
    try:
        assert index(tr, **ES) == first
        state["scale"] = -2.0
        changed = index(tr, **ES)
        assert changed != first
        state["scale"] = 1.0
        assert index(tr, **ES) == first
    finally:
        index._query_encoder = LambdaEncoder(by_text.__getitem__)


def test_es_then_full_scoring_same_ranking(data, indexes):
    """ES and full scoring of one ranking share a plan without crossing
    state."""
    _, index = _set_mode(indexes, "MAXP")
    _, tr = _rankings(data, "MAXP")
    es1 = index(tr, **ES)
    full = index(tr)
    assert index(tr, **ES) == es1 and index(tr) == full
    assert len(full._df) == len(tr._df) > len(es1._df)


def test_es_arguments_are_required():
    index = _contract_index(InMemoryIndex, LambdaEncoder, Mode, device="cpu")
    r = ft.Ranking(_contract_frame())
    with pytest.raises(ValueError):
        index(r, early_stopping=10, early_stopping_alpha=None, early_stopping_depths=(5,))
    with pytest.raises(ValueError):
        index(r, early_stopping=10, early_stopping_alpha=0.5, early_stopping_depths=None)
