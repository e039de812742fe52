"""``tests/test_early_stopping_extra.py`` on the port: early stopping's
edge cases.

All 6 cases are copied with the same data, assertions and tolerances
(``places=4``): ES rows scored as full scoring scores them, batching,
the exact top-k, an alpha sweep over the cross-call state against a fresh
index, an encoder swap invalidating the cached semantic scores, and ES and
full scoring of one ranking.  None is left out (the port against the JAX
index on the same contract: ``tests/test_torch_early_stopping.py``).
Each class runs on ``device="cpu"``; its ``...Cuda`` subclass (marker
``gpu``) runs the same cases on the card and skips without one.  The file
imports neither JAX nor ``fastforward_tpu``.
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

RNG = np.random.default_rng(77)


def _setup(n=60, device="cpu"):
    qvec = np.array([1.0, 1.0], dtype=np.float32)
    index = InMemoryIndex(LambdaEncoder(lambda _: qvec), mode=Mode.PASSAGE, device=device)
    vectors = RNG.normal(size=(n, 2)).astype(np.float32)
    index.add(vectors, psg_ids=[f"p{i}" for i in range(n)])
    run = {
        q: {f"p{i}": float(n - i) for i in range(n)} for q in ("q1", "q2", "q3")
    }
    ranking = Ranking.from_run(run, queries={q: q for q in ("q1", "q2", "q3")})
    return index, ranking, vectors, qvec


class TestEarlyStoppingExtra(unittest.TestCase):
    device = "cpu"

    def test_scored_rows_match_full_scoring(self):
        """Every row ES returns carries the same score as full scoring."""
        index, ranking, vectors, qvec = _setup(device=self.device)
        full = index(ranking)
        es = index(
            ranking,
            early_stopping=5,
            early_stopping_alpha=0.5,
            early_stopping_depths=(10, 30, 60),
        )
        for q_id in es.q_ids:
            got = es[q_id]
            reference = full[q_id]
            self.assertLessEqual(len(got), len(reference))
            for pid, score in got.items():
                self.assertAlmostEqual(reference[pid], score, places=4)

    def test_es_with_batching_matches_unbatched(self):
        index, ranking, *_ = _setup(device=self.device)
        kwargs = dict(
            early_stopping=5,
            early_stopping_alpha=0.5,
            early_stopping_depths=(10, 30, 60),
        )
        unbatched = index(ranking, **kwargs)
        batched = index(ranking, batch_size=2, **kwargs)
        self.assertEqual(unbatched, batched)

    def test_es_top_k_correct(self):
        """The k best interpolated docs must be exactly identified."""
        index, ranking, vectors, qvec = _setup(device=self.device)
        cutoff, alpha = 5, 0.5
        es = index(
            ranking,
            early_stopping=cutoff,
            early_stopping_alpha=alpha,
            early_stopping_depths=(10, 30, 60),
        )
        lex = ranking["q1"]
        semantic_full = {f"p{i}": float(vectors[i] @ qvec) for i in range(60)}
        interp = {
            p: alpha * lex[p] + (1 - alpha) * semantic_full[p] for p in lex
        }
        expected_top = sorted(interp, key=interp.get, reverse=True)[:cutoff]

        es_scores = es["q1"]
        es_interp = {
            p: alpha * lex[p] + (1 - alpha) * es_scores[p] for p in es_scores
        }
        got_top = sorted(es_interp, key=es_interp.get, reverse=True)[:cutoff]
        self.assertEqual(set(expected_top), set(got_top))


class TestESCrossCallCache(unittest.TestCase):
    """Alpha sweeps over the same ranking reuse cached semantic scores;
    the cached state must not change any result."""

    device = "cpu"

    @staticmethod
    def _fixed_setup(n=60, device="cpu"):
        rng = np.random.default_rng(99)
        qvec = np.array([1.0, 1.0], dtype=np.float32)
        index = InMemoryIndex(LambdaEncoder(lambda _: qvec), mode=Mode.PASSAGE, device=device)
        vectors = rng.normal(size=(n, 2)).astype(np.float32)
        index.add(vectors, psg_ids=[f"p{i}" for i in range(n)])
        run = {
            q: {f"p{i}": float(n - i) for i in range(n)}
            for q in ("q1", "q2", "q3")
        }
        ranking = Ranking.from_run(
            run, queries={q: q for q in ("q1", "q2", "q3")}
        )
        return index, ranking

    def test_alpha_sweep_matches_fresh_index(self):
        index, ranking = self._fixed_setup(device=self.device)
        for alpha in (0.1, 0.5, 0.9, 0.5):  # repeat an alpha too
            kwargs = dict(
                early_stopping=5,
                early_stopping_alpha=alpha,
                early_stopping_depths=(10, 30, 60),
            )
            cached = index(ranking, **kwargs)  # warm ES state across alphas
            cold_index, cold_ranking = self._fixed_setup(device=self.device)  # identical data
            cold = cold_index(cold_ranking, **kwargs)
            self.assertEqual(cold, cached, f"alpha={alpha}")

    def test_encoder_swap_invalidates_cached_semantic_scores(self):
        """Replacing the query encoder (or an in-place output change of the
        same encoder object) between ES calls on the same ranking must
        re-score — the ES state is validated on query-vector content, not
        encoder identity (regression: recycled ``id()`` / mutated encoder
        silently served stale cached scores)."""
        index, ranking = self._fixed_setup(device=self.device)
        kwargs = dict(
            early_stopping=5,
            early_stopping_alpha=0.5,
            early_stopping_depths=(10, 30, 60),
        )
        first = index(ranking, **kwargs)

        # in-place output change of the SAME encoder object
        state = {"qvec": np.array([1.0, 1.0], dtype=np.float32)}
        index._query_encoder = LambdaEncoder(lambda _: state["qvec"])
        same_obj = index(ranking, **kwargs)
        self.assertEqual(first, same_obj)
        state["qvec"] = np.array([-2.0, 3.0], dtype=np.float32)
        mutated = index(ranking, **kwargs)
        self.assertNotEqual(first, mutated)

        # swap in a NEW encoder object returning the original vectors:
        # results must go back to the first outcome (fresh, correct scores)
        index._query_encoder = LambdaEncoder(
            lambda _: np.array([1.0, 1.0], dtype=np.float32)
        )
        swapped_back = index(ranking, **kwargs)
        self.assertEqual(first, swapped_back)

    def test_es_then_full_scoring_same_ranking(self):
        """A non-ES call after ES calls (and vice versa) on the same
        ranking must not cross plan state."""
        index, ranking, vectors, qvec = _setup(device=self.device)
        es1 = index(
            ranking,
            early_stopping=5,
            early_stopping_alpha=0.5,
            early_stopping_depths=(10, 60),
        )
        full = index(ranking)
        es2 = index(
            ranking,
            early_stopping=5,
            early_stopping_alpha=0.5,
            early_stopping_depths=(10, 60),
        )
        full2 = index(ranking)
        self.assertEqual(es1, es2)
        self.assertEqual(full, full2)
        # the full run scores every candidate; ES returns a subset
        self.assertGreaterEqual(
            len(full._df), len(es1._df)
        )


@pytest.mark.gpu
class TestEarlyStoppingExtraCuda(TestEarlyStoppingExtra):
    device = "cuda"
    setUpClass = classmethod(_needs_card)


@pytest.mark.gpu
class TestESCrossCallCacheCuda(TestESCrossCallCache):
    device = "cuda"
    setUpClass = classmethod(_needs_card)
