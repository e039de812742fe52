"""``preload`` and ``preload_join`` of the port on the CPU.

The preload contract cases of the JAX package's tests run on the port:
``tests/test_serve.py`` (the serve and refine warms, ``serve`` without
``warm``), ``tests/test_scoring_paths.py::TestPreloadWarm`` (all but the
XLA compile-cache case, which has no counterpart: the kernels' build
directory is keyed by source hash) and
``tests/test_preload_overlap.py::test_preload_stats_phases_recorded`` (with
``overlap`` False: the port uploads before it warms).  Beside them:
``preload_join`` is a no-op without a pending upload, ``progressive=True``
on a table below its 512 MiB size gate warns and takes the standard upload
(the split-plane upload itself: ``tests/test_torch_preload_progressive.py``),
the warms run K1's wrapper in both tiers, the stats carry
the JAX package's keys, and a preloaded index serves what a fresh one does.
"""

import logging
import unittest

import numpy as np
import pytest

from fastforward_tpu.encoder import LambdaEncoder as JaxLambdaEncoder
from fastforward_tpu.index import InMemoryIndex as JaxInMemoryIndex
from fastforward_tpu.index import Mode as JaxMode
from fastforward_tpu_torch import ops
from fastforward_tpu_torch.encoder import LambdaEncoder
from fastforward_tpu_torch.index import InMemoryIndex, Mode
from fastforward_tpu_torch.ops import stream_kernel as sk
from fastforward_tpu_torch.ranking import Ranking


def _index(*args, **kwargs) -> InMemoryIndex:
    return InMemoryIndex(*args, device="cpu", **kwargs)


# -- tests/test_serve.py ---------------------------------------------------------


def _build(n=2048, dim=16, num_q=4, depth=32, mode=Mode.PASSAGE, seed=0, **index_kwargs):
    rng = np.random.default_rng(seed)
    corpus = rng.standard_normal((n, dim)).astype(np.float32)
    qvecs = rng.standard_normal((num_q, dim)).astype(np.float32)
    by_text = {f"query {i}": qvecs[i] for i in range(num_q)}
    index = _index(LambdaEncoder(lambda t: by_text[t]), mode=mode, **index_kwargs)
    index.add(corpus, psg_ids=[f"p{i}" for i in range(n)])
    run = {
        f"q{i}": {f"p{j}": float(rng.standard_normal()) for j in rng.choice(n, size=depth, replace=False)}
        for i in range(num_q)
    }
    queries = {f"q{i}": f"query {i}" for i in range(num_q)}
    return index, Ranking.from_run(run, queries=queries)


def _reference_serve(index, ranking, alpha, cutoff):
    return ranking.interpolate(index(ranking), alpha).cut(cutoff)


def _assert_equivalent(test, got: Ranking, want: Ranking, num_q: int):
    """Same (q_id, id) sets per query with near-identical scores."""
    test.assertEqual(got.q_ids, want.q_ids)
    for q in want.q_ids:
        g, w = got[q], want[q]
        test.assertEqual(set(g), set(w), f"doc set differs for {q}")
        for doc, score in w.items():
            test.assertAlmostEqual(g[doc], score, places=4)


class TestServePreload(unittest.TestCase):
    def test_preload_serve_refine_warm(self):
        index, ranking = _build(seed=17)
        self.assertTrue(index.preload(warm=(4, 32), serve=(0.2, 10, 16)))
        want = _reference_serve(index, ranking, 0.2, 10)
        got = index.serve(ranking, 0.2, 10, refine=16)
        _assert_equivalent(self, got, want, 4)

    def test_preload_serve_warm(self):
        index, ranking = _build(seed=14, depth=16)
        self.assertTrue(index.preload(warm=(4, 16), serve=(0.2, 5)))
        want = _reference_serve(index, ranking, 0.2, 5)
        got = index.serve(ranking, 0.2, 5)
        _assert_equivalent(self, got, want, 4)

    def test_preload_serve_requires_warm(self):
        index, _ = _build()
        with self.assertRaises(ValueError):
            index.preload(serve=(0.2, 10))


# -- tests/test_scoring_paths.py::TestPreloadWarm --------------------------------


class TestPreloadWarm(unittest.TestCase):
    def test_warm_compiles_and_leaves_no_plan(self):
        rng = np.random.default_rng(9)
        n, dim = 3000, 128
        corpus = rng.normal(size=(n, dim)).astype(np.float32)
        qvec = rng.normal(size=dim).astype(np.float32)
        index = _index(LambdaEncoder(lambda _: qvec), mode=Mode.PASSAGE)
        index.add(corpus, psg_ids=[f"p{i}" for i in range(n)])
        self.assertTrue(index.preload(warm=(4, 100)))
        self.assertEqual(0, len(index._plans))  # synthetic plan dropped
        run = {"q1": {f"p{i}": float(i) for i in range(100)}}
        result = index(Ranking.from_run(run, queries={"q1": "x"}))
        self.assertAlmostEqual(result["q1"]["p0"], float(corpus[0] @ qvec), places=3)

    def test_warm_bypasses_user_encoder(self):
        # an encoder that only accepts known corpus queries must never see
        # the synthetic warm queries
        rng = np.random.default_rng(11)
        corpus = rng.normal(size=(400, 128)).astype(np.float32)
        qvec = rng.normal(size=128).astype(np.float32)
        strict = {"real query": qvec}
        index = _index(LambdaEncoder(lambda t: strict[t]), mode=Mode.PASSAGE)
        index.add(corpus, psg_ids=[f"p{i}" for i in range(400)])
        self.assertTrue(index.preload(warm=(3, 40)))
        self.assertIs(index.query_encoder._f("real query"), qvec)  # restored
        run = {"q1": {f"p{i}": float(i) for i in range(40)}}
        result = index(Ranking.from_run(run, queries={"q1": "real query"}))
        self.assertAlmostEqual(result["q1"]["p0"], float(corpus[0] @ qvec), places=3)

    def test_warm_without_encoder(self):
        rng = np.random.default_rng(10)
        corpus = rng.normal(size=(500, 128)).astype(np.float32)
        index = _index(mode=Mode.MAXP)
        index.add(corpus, doc_ids=[f"d{i // 2}" for i in range(500)])
        self.assertTrue(index.preload(warm=(2, 50)))
        self.assertIsNone(index.query_encoder)  # restored

    def test_warm_empty_index(self):
        self.assertFalse(_index().preload(warm=(2, 10)))


# -- tests/test_preload_overlap.py -----------------------------------------------

DIM, N = 256, 300


def _vecs(seed=0, n=N):
    return np.random.default_rng(seed).standard_normal((n, DIM)).astype(np.float32)


def _encoder():
    rng = np.random.default_rng(7)
    return LambdaEncoder(lambda _t: rng.standard_normal(DIM).astype(np.float32))


def _add(index, vecs):
    index.add(vecs, doc_ids=None, psg_ids=[f"p{i}" for i in range(len(vecs))])


def test_preload_stats_phases_recorded():
    index = _index(_encoder(), mode=Mode.PASSAGE)
    _add(index, _vecs(4))
    index.preload(warm=(2, 8), serve=(0.3, 3))
    stats = index._preload_stats
    assert "warm_rerank_s" in stats
    assert "warm_serve_s" in stats
    assert "upload_s" in stats
    assert stats["overlap"] is False  # the port warms after the upload


def test_stats_carry_the_jax_keys():
    """The port records the JAX package's stats keys, without the overlap's
    ``upload_tail_s`` (the port does not overlap; ``build_s`` is recorded
    only for a table on the card)."""
    vecs = _vecs(6)
    jax_index = JaxInMemoryIndex(JaxLambdaEncoder(lambda _t: vecs[0]), mode=JaxMode.PASSAGE)
    jax_index.add(vecs, psg_ids=[f"p{i}" for i in range(N)])
    jax_index.preload(warm=(2, 8), serve=(0.3, 3))
    index = _index(LambdaEncoder(lambda _t: vecs[0]), mode=Mode.PASSAGE)
    _add(index, vecs)
    index.preload(warm=(2, 8), serve=(0.3, 3))
    assert set(index._preload_stats) == set(jax_index._preload_stats) - {"upload_tail_s"}
    assert all(v >= 0 for k, v in index._preload_stats.items() if k != "overlap")


def test_preload_join_is_a_noop():
    index = _index(_encoder(), mode=Mode.PASSAGE)
    assert index.preload_join() is True
    _add(index, _vecs(1))
    assert index.preload(warm=(2, 8))
    assert index.preload_join(timeout=0.0) is True
    assert index.preload_join() is True


def test_progressive_warns_and_takes_the_standard_upload(caplog):
    vecs = _vecs(2)
    index = _index(_encoder(), mode=Mode.PASSAGE)
    _add(index, vecs)
    with caplog.at_level(logging.WARNING):
        assert index.preload(warm=(2, 8), progressive=True)
    assert "using the standard upload" in caplog.text
    assert not index._preload_stats.get("progressive", False)
    table = index._device_view().table
    np.testing.assert_array_equal(table[:N].numpy(), vecs)  # the exact table
    assert index.preload_join() is True


def test_warm_runs_k1_in_both_tiers(monkeypatch):
    """The rerank warm runs K1's wrapper exact, the refine serve warm fast
    (the plain version here: the table is on the CPU), and no kernel is
    built for a CPU table."""
    tiers = []
    orig = sk.stream_select_pairwise

    def recording(*args, exact=True, **kwargs):
        tiers.append(exact)
        return orig(*args, exact=exact, **kwargs)

    monkeypatch.setattr(sk, "stream_select_pairwise", recording)
    monkeypatch.setattr(ops, "load_kernels", lambda kind: pytest.fail("built a kernel"))
    index, _ = _build(n=4096, dim=128, seed=3)
    assert index.preload(warm=(8, 64), serve=(0.2, 10, 8))
    assert sorted(set(tiers)) == [False, True]
    assert index._plans == {}
    assert "build_s" not in index._preload_stats


@pytest.mark.parametrize("mode", ["PASSAGE", "MAXP", "FIRSTP"])
def test_preloaded_index_serves_like_a_fresh_one(mode):
    """Preloading changes no result: a preloaded index and a fresh one on
    the same vectors give equal re-ranks and serves."""
    rng = np.random.default_rng(21)
    n, dim, num_q = 1024, 128, 3
    corpus = rng.standard_normal((n, dim)).astype(np.float32)
    qvecs = rng.standard_normal((num_q, dim)).astype(np.float32)
    by_text = {f"query {i}": qvecs[i] for i in range(num_q)}
    doc_ids = [f"d{i // 3}" for i in range(n)]
    psg_ids = [f"p{i}" for i in range(n)]
    indexes = []
    for _ in range(2):
        index = _index(LambdaEncoder(by_text.__getitem__), mode=Mode[mode])
        index.add(corpus, doc_ids=doc_ids, psg_ids=psg_ids)
        indexes.append(index)
    assert indexes[0].preload(warm=(4, 30), serve=(0.3, 5, 4))
    ids = psg_ids if mode == "PASSAGE" else sorted(set(doc_ids))
    run = {f"q{i}": {c: float(r) for r, c in enumerate(rng.choice(ids, 30, replace=False))}
           for i in range(num_q)}
    ranking = Ranking.from_run(run, queries={f"q{i}": f"query {i}" for i in range(num_q)})
    warm, fresh = indexes
    assert warm(ranking) == fresh(ranking)
    assert warm.serve(ranking, 0.3, 5) == fresh.serve(ranking, 0.3, 5)
    assert warm.serve(ranking, 0.3, 5, refine=4) == fresh.serve(ranking, 0.3, 5, refine=4)
