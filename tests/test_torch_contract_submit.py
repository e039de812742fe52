"""``tests/test_submit.py`` on the port: ``Index.submit`` /
``ScoreFuture.result``.

All 8 cases are copied with the same data and assertions (results equal
to the synchronous ``index(ranking)`` bit for bit): cold and warm
``submit``, an idempotent ``result``, two futures in flight, a pipeline
over distinct rankings, a MAXP ranking, the eager flat path of a document
with more than ``_MAX_GROUP_K`` passages, and a ranking without queries.
None is left out.  The class runs on ``device="cpu"``;
``TestSubmitCuda`` (marker ``gpu``) runs the same cases on the card and
skips without one.  The file imports neither JAX nor ``fastforward_tpu``.
"""

import unittest

import numpy as np
import pytest
import torch

from fastforward_tpu_torch.encoder import LambdaEncoder
from fastforward_tpu_torch.index import InMemoryIndex, Mode, ScoreFuture
from fastforward_tpu_torch.ranking import Ranking


def _needs_card(cls):
    if not torch.cuda.is_available():
        raise unittest.SkipTest("needs an NVIDIA GPU")


def _build(n=2048, dim=16, num_q=4, depth=32, mode=Mode.PASSAGE, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    corpus = rng.standard_normal((n, dim)).astype(np.float32)
    qvecs = rng.standard_normal((num_q, dim)).astype(np.float32)
    by_text = {f"query {i}": qvecs[i] for i in range(num_q)}
    index = InMemoryIndex(LambdaEncoder(lambda t: by_text[t]), mode=mode, device=device)
    index.add(corpus, psg_ids=[f"p{i}" for i in range(n)])
    run = {
        f"q{i}": {
            f"p{j}": float(depth - r)
            for r, j in enumerate(rng.choice(n, size=depth, replace=False))
        }
        for i in range(num_q)
    }
    queries = {f"q{i}": f"query {i}" for i in range(num_q)}
    return index, Ranking.from_run(run, queries=queries)


def _assert_same(test, a: Ranking, b: Ranking):
    test.assertEqual(list(a._df["q_id"]), list(b._df["q_id"]))
    test.assertEqual(list(a._df["id"]), list(b._df["id"]))
    np.testing.assert_array_equal(
        a._df["score"].to_numpy(), b._df["score"].to_numpy()
    )
    test.assertEqual(a.q_ids, b.q_ids)


class TestSubmit(unittest.TestCase):
    device = "cpu"

    def test_cold_submit_matches_sync_call(self):
        index, ranking = _build(device=self.device)
        fut = index.submit(ranking)
        self.assertIsInstance(fut, ScoreFuture)
        self.assertTrue(fut.pipelined)
        got = fut.result()
        index2, ranking2 = _build(device=self.device)
        _assert_same(self, got, index2(ranking2))

    def test_warm_submit_uses_the_plan(self):
        index, ranking = _build(device=self.device)
        baseline = index(ranking)  # builds the plan
        fut = index.submit(ranking)
        self.assertTrue(fut.pipelined)
        _assert_same(self, fut.result(), baseline)

    def test_result_is_idempotent(self):
        index, ranking = _build(device=self.device)
        fut = index.submit(ranking)
        self.assertIs(fut.result(), fut.result())

    def test_two_in_flight_futures(self):
        index, ranking_a = _build(seed=1, device=self.device)
        _, ranking_b = _build(seed=2, device=self.device)
        sync_a = index(ranking_a)
        sync_b = index(ranking_b)
        fut_a = index.submit(ranking_a)
        fut_b = index.submit(ranking_b)  # dispatched before a's result
        _assert_same(self, fut_b.result(), sync_b)
        _assert_same(self, fut_a.result(), sync_a)

    def test_pipeline_loop_over_distinct_rankings(self):
        index, _ = _build(seed=3, device=self.device)
        rankings = [_build(seed=10 + i, device=self.device)[1] for i in range(4)]
        sync = [index(r) for r in rankings]
        results = []
        pending = None
        for r in rankings:
            fut = index.submit(r)
            if pending is not None:
                results.append(pending.result())
            pending = fut
        results.append(pending.result())
        for got, want in zip(results, sync):
            _assert_same(self, got, want)

    def test_doc_mode_submit(self):
        # MAXP with multi-passage documents goes through the grouped layout
        rng = np.random.default_rng(5)
        dim, num_q = 8, 3
        qvecs = rng.standard_normal((num_q, dim)).astype(np.float32)
        by_text = {f"query {i}": qvecs[i] for i in range(num_q)}
        index = InMemoryIndex(LambdaEncoder(lambda t: by_text[t]), mode=Mode.MAXP, device=self.device)
        vecs, doc_ids = [], []
        for d in range(64):
            for _ in range(1 + d % 5):
                vecs.append(rng.standard_normal(dim).astype(np.float32))
                doc_ids.append(f"d{d}")
        index.add(np.stack(vecs), doc_ids=doc_ids)
        run = {
            f"q{i}": {f"d{d}": float(20 - r) for r, d in enumerate(range(20))}
            for i in range(num_q)
        }
        ranking = Ranking.from_run(
            run, queries={f"q{i}": f"query {i}" for i in range(num_q)}
        )
        sync = index(ranking)
        fut = index.submit(ranking)
        _assert_same(self, fut.result(), sync)

    def test_ragged_fallback_is_eager_but_correct(self):
        # one document with > _MAX_GROUP_K passages forces the flat
        # segment fallback, which has no deferred-fetch seam
        rng = np.random.default_rng(6)
        dim = 8
        qvec = rng.standard_normal(dim).astype(np.float32)
        index = InMemoryIndex(LambdaEncoder(lambda t: qvec), mode=Mode.MAXP, device=self.device)
        vecs, doc_ids = [], []
        for _ in range(100):  # one very ragged doc
            vecs.append(rng.standard_normal(dim).astype(np.float32))
            doc_ids.append("big")
        for d in range(8):
            vecs.append(rng.standard_normal(dim).astype(np.float32))
            doc_ids.append(f"d{d}")
        index.add(np.stack(vecs), doc_ids=doc_ids)
        run = {"q0": {"big": 9.0, **{f"d{d}": float(d) for d in range(8)}}}
        ranking = Ranking.from_run(run, queries={"q0": "anything"})
        sync = index(ranking)
        fut = index.submit(ranking)
        self.assertFalse(fut.pipelined)
        _assert_same(self, fut.result(), sync)

    def test_submit_requires_queries(self):
        index, ranking = _build(device=self.device)
        bare = Ranking(ranking._df.drop(columns=["query"]))
        with self.assertRaises(ValueError):
            index.submit(bare)


@pytest.mark.gpu
class TestSubmitCuda(TestSubmit):
    device = "cuda"
    setUpClass = classmethod(_needs_card)
