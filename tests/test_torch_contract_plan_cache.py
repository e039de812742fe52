"""``tests/test_plan_cache.py`` on the port: repeat calls reuse their
prepared plan and stay correct.

All 8 cases are copied with the same data, assertions and tolerances
(``places=3``): identical repeat calls in every mode, rescoring when the
query vectors change, ``add`` invalidating plans, eviction when the frame
dies, the LRU bound, distinct rankings, scored-ranking algebra with extra
pairs, and a mode switch taking a fresh plan.  None is left out.  The
class runs on ``device="cpu"``; ``TestPlanCacheCuda`` (marker ``gpu``)
runs the same cases on the card and skips without one.  The file imports
neither JAX nor ``fastforward_tpu``.
"""

import unittest

import numpy as np
import pytest
import torch

from fastforward_tpu_torch.encoder import LambdaEncoder
from fastforward_tpu_torch.index import InMemoryIndex, Mode
from fastforward_tpu_torch.ranking import Ranking


def _needs_card(cls):
    if not torch.cuda.is_available():
        raise unittest.SkipTest("needs an NVIDIA GPU")

RNG = np.random.default_rng(7)


def _result_map(result):
    return {q: dict(result[q]) for q in ("q1", "q2")}


class TestPlanCache(unittest.TestCase):
    device = "cpu"

    def _new(self, *args, **kwargs) -> InMemoryIndex:
        return InMemoryIndex(*args, device=self.device, **kwargs)

    def _build(self, mode, dim=128, n=512):
        corpus = RNG.normal(size=(n, dim)).astype(np.float32)
        qvec = RNG.normal(size=dim).astype(np.float32)
        index = self._new(LambdaEncoder(lambda _: qvec), mode=mode)
        if mode == Mode.PASSAGE:
            index.add(corpus, psg_ids=[f"p{i}" for i in range(n)])
            ids = [f"p{i}" for i in range(n)]
        else:
            index.add(corpus, doc_ids=[f"d{i // 2}" for i in range(n)])
            ids = [f"d{i}" for i in range(n // 2)]
        run = {
            "q1": {i: float(j) for j, i in enumerate(ids[:64])},
            "q2": {i: float(j) for j, i in enumerate(ids[32:96])},
        }
        ranking = Ranking.from_run(run, queries={"q1": "a", "q2": "b"})
        return index, ranking, corpus, qvec

    def test_repeat_calls_identical(self):
        for mode in (Mode.PASSAGE, Mode.MAXP, Mode.AVEP, Mode.FIRSTP):
            index, ranking, _, _ = self._build(mode)
            first = _result_map(index(ranking))
            # second call takes the prepared path
            plan = index._plans[(id(ranking._df), mode)]
            self.assertTrue(plan.get("ready"), mode)
            second = _result_map(index(ranking))
            third = _result_map(index(ranking))
            self.assertEqual(first, second, mode)
            self.assertEqual(first, third, mode)

    def test_changed_query_vectors_rescored(self):
        """The plan caches the device query upload keyed on content; an
        encoder returning different vectors for the same ranking must
        produce different scores (no stale device queries)."""
        dim, n = 128, 2048
        corpus = RNG.normal(size=(n, dim)).astype(np.float32)
        state = {"qvec": RNG.normal(size=dim).astype(np.float32)}
        index = self._new(
            LambdaEncoder(lambda _: state["qvec"]), mode=Mode.PASSAGE
        )
        index.add(corpus, psg_ids=[f"p{i}" for i in range(n)])
        ids = [f"p{i}" for i in range(n)]
        # dense candidate set -> streamed path (where the q cache lives)
        run = {"q1": {i: float(j) for j, i in enumerate(ids)}}
        ranking = Ranking.from_run(run, queries={"q1": "a"})

        first = dict(index(ranking)["q1"])
        second = dict(index(ranking)["q1"])  # warm plan, same queries
        self.assertEqual(first, second)

        state["qvec"] = RNG.normal(size=dim).astype(np.float32)
        changed = dict(index(ranking)["q1"])
        expected = {
            f"p{i}": float(corpus[i] @ state["qvec"]) for i in range(n)
        }
        for pid, score in changed.items():
            self.assertAlmostEqual(expected[pid], score, places=3, msg=pid)
        self.assertNotEqual(first, changed)

    def test_add_invalidates_plans(self):
        index, ranking, corpus, qvec = self._build(Mode.PASSAGE)
        index(ranking)
        self.assertEqual(1, len(index._plans))
        extra = RNG.normal(size=(4, 128)).astype(np.float32)
        index.add(extra, psg_ids=[f"x{i}" for i in range(4)])
        self.assertEqual(0, len(index._plans))
        # scores still correct against ground truth after re-planning
        result = index(ranking)["q1"]
        for pid in list(result)[:5]:
            expected = float(corpus[int(pid[1:])] @ qvec)
            self.assertAlmostEqual(expected, result[pid], places=3)

    def test_plan_evicted_when_frame_dies(self):
        import gc

        index, ranking, _, _ = self._build(Mode.PASSAGE)
        index(ranking)
        self.assertEqual(1, len(index._plans))
        del ranking
        gc.collect()
        self.assertEqual(0, len(index._plans))

    def test_lru_bound(self):
        index, ranking, _, _ = self._build(Mode.PASSAGE)
        rankings = []
        for s in range(6):
            run = {"q1": {f"p{i}": float(i) for i in range(s + 2)}}
            rankings.append(Ranking.from_run(run, queries={"q1": "a"}))
            index(rankings[-1])
        self.assertLessEqual(len(index._plans), index._MAX_PLANS)

    def test_distinct_rankings_not_confused(self):
        index, ranking, corpus, qvec = self._build(Mode.PASSAGE)
        index(ranking)
        run2 = {"q9": {f"p{i}": 1.0 for i in range(100, 120)}}
        r2 = Ranking.from_run(run2, queries={"q9": "z"})
        result = index(r2)["q9"]
        for pid in result:
            expected = float(corpus[int(pid[1:])] @ qvec)
            self.assertAlmostEqual(expected, result[pid], places=3)

    def test_scored_ranking_algebra_with_extra_pairs(self):
        """Scored rankings (whose fast path emits categorical columns) must
        survive merge-then-fillna algebra against rankings holding ID pairs
        the scored ranking lacks (regression: 'Cannot setitem on a
        Categorical with a new category')."""
        index, ranking, corpus, qvec = self._build(Mode.PASSAGE)
        index(ranking)
        scored = index(ranking)  # second call -> prepared (categorical) path
        extra = Ranking.from_run(
            {"q1": {"p500": 1.0}, "q3": {"p1": 2.0}},
            queries={"q1": "a", "q3": "c"},
        )
        combined = 0.1 * scored + extra
        self.assertAlmostEqual(combined["q1"]["p500"], 1.0, places=5)
        self.assertAlmostEqual(combined["q3"]["p1"], 2.0, places=5)
        self.assertAlmostEqual(
            combined["q1"]["p0"],
            0.1 * float(corpus[0] @ qvec),
            places=3,
        )
        interp = scored.interpolate(extra, 0.5)
        self.assertAlmostEqual(interp["q3"]["p1"], 1.0, places=5)
        fused = scored.rr_scores() + extra.rr_scores()
        self.assertIn("q3", fused.q_ids)

    def test_mode_switch_uses_fresh_plan(self):
        index, ranking, corpus, qvec = self._build(Mode.MAXP)
        maxp = index(ranking)["q1"]
        index.mode = Mode.AVEP
        avep = index(ranking)["q1"]
        # the two modes genuinely differ on multi-passage docs
        self.assertNotEqual(dict(maxp), dict(avep))
        doc_rows = {d: [] for d in maxp}
        for row in range(512):
            doc_rows.setdefault(f"d{row // 2}", []).append(row)
        for doc in list(avep)[:5]:
            rows = doc_rows[doc]
            expected = float(np.mean(corpus[rows] @ qvec))
            self.assertAlmostEqual(expected, avep[doc], places=3)


@pytest.mark.gpu
class TestPlanCacheCuda(TestPlanCache):
    device = "cuda"
    setUpClass = classmethod(_needs_card)
