"""``tests/test_adversarial.py`` on the port: ties, near-duplicates,
pathological shapes.

All 9 cases are copied with the same data, assertions and tolerances:
``TestTiedScores`` (lexical ties decided by the semantic scores, semantic
ties decided by the lexical ones, early stopping on fully tied scores),
``TestNearDuplicateVectors`` (vectors ~1e-3 apart at ``"exact"`` and
``"high"``), ``TestPathologicalShapes`` (a 300-passage document among
singletons, depth-1 runs, skewed depths, nDCG/RR on tied scores).  None is
left out.  Each class runs on ``device="cpu"``; its ``...Cuda`` subclass
(marker ``gpu``) runs the same cases on the card and skips without one.
The file imports neither JAX nor ``fastforward_tpu``.
"""

import unittest

import numpy as np
import pandas as pd
import pytest
import torch

from fastforward_tpu_torch.encoder import LambdaEncoder
from fastforward_tpu_torch.index import InMemoryIndex, Mode
from fastforward_tpu_torch.ranking import Ranking


def _needs_card(cls):
    if not torch.cuda.is_available():
        raise unittest.SkipTest("needs an NVIDIA GPU")


def _index(corpus, qvecs, mode=Mode.PASSAGE, doc_ids=None, device="cpu", **kw):
    by_text = {f"query {i}": qvecs[i] for i in range(len(qvecs))}
    index = InMemoryIndex(
        LambdaEncoder(lambda t: by_text[t]), mode=mode, device=device, **kw
    )
    if doc_ids is None:
        index.add(
            corpus, psg_ids=[f"p{i}" for i in range(len(corpus))]
        )
    else:
        index.add(corpus, doc_ids=doc_ids)
    return index


def _ranking(run, num_q):
    return Ranking.from_run(
        run, queries={f"q{i}": f"query {i}" for i in range(num_q)}
    )


class TestTiedScores(unittest.TestCase):
    device = "cpu"

    def test_all_lexical_scores_tied_semantic_breaks_ties(self):
        # every candidate ties lexically: the interpolated order (and the
        # serve cut) must be decided purely by the semantic scores
        rng = np.random.default_rng(0)
        n, dim = 256, 32
        corpus = rng.standard_normal((n, dim)).astype(np.float32)
        qvecs = rng.standard_normal((2, dim)).astype(np.float32)
        index = _index(corpus, qvecs, device=self.device)
        run = {
            f"q{i}": {f"p{j}": 7.0 for j in range(64)} for i in range(2)
        }
        ranking = _ranking(run, 2)
        got = index.serve(ranking, 0.4, 10)
        for qi in range(2):
            sem = corpus[:64] @ qvecs[qi]
            want_rows = np.argsort(-sem)[:10]
            got_q = got[f"q{qi}"]
            self.assertEqual(
                set(got_q), {f"p{j}" for j in want_rows}
            )
            for j in want_rows:
                self.assertAlmostEqual(
                    got_q[f"p{j}"],
                    0.4 * 7.0 + 0.6 * float(sem[j]),
                    places=4,
                )

    def test_all_semantic_scores_tied_lexical_breaks_ties(self):
        # identical vectors: every semantic score ties; interpolation must
        # reproduce the lexical order exactly
        dim = 16
        corpus = np.ones((128, dim), dtype=np.float32)
        qvecs = np.ones((1, dim), dtype=np.float32)
        index = _index(corpus, qvecs, device=self.device)
        run = {"q0": {f"p{j}": float(j) for j in range(64)}}
        got = index.serve(_ranking(run, 1), 0.5, 5)["q0"]
        want_ids = [f"p{j}" for j in range(63, 58, -1)]
        self.assertEqual(set(got), set(want_ids))

    def test_early_stopping_with_tied_scores_terminates(self):
        # ES stop criterion with fully tied lexical+semantic scores must
        # not loop or drop queries
        dim = 8
        corpus = np.ones((512, dim), dtype=np.float32)
        qvecs = np.ones((2, dim), dtype=np.float32)
        index = _index(corpus, qvecs, device=self.device)
        run = {
            f"q{i}": {f"p{j}": 1.0 for j in range(256)} for i in range(2)
        }
        ranking = _ranking(run, 2)
        out = index.serve(
            ranking, 0.2, 10, early_stopping_depths=(16, 64, 256)
        )
        for qi in range(2):
            self.assertEqual(len(out[f"q{qi}"]), 10)


class TestNearDuplicateVectors(unittest.TestCase):
    device = "cpu"

    def test_epsilon_separated_vectors_rank_exactly(self):
        # pairs of vectors separated by ~1e-3 relative: far below bf16
        # resolution (~2^-8) at this magnitude, so the 'high'/two-phase
        # tiers must rely on their fp32 rescue to order them; 'exact'
        # must order them outright
        rng = np.random.default_rng(1)
        dim = 64
        base = rng.standard_normal((64, dim)).astype(np.float32)
        eps = rng.standard_normal((64, dim)).astype(np.float32) * 1e-3
        corpus = np.empty((128, dim), dtype=np.float32)
        corpus[0::2] = base
        corpus[1::2] = base + eps
        qvec = rng.standard_normal(dim).astype(np.float32)
        exact_scores = corpus @ qvec
        for precision in ("exact", "high"):
            index = _index(corpus, qvec[None, :], precision=precision, device=self.device)
            run = {"q0": {f"p{j}": 0.0 for j in range(128)}}
            got = index.serve(
                _ranking(run, 1), 0.0, 10, refine=16
            )["q0"]
            want_rows = np.argsort(-exact_scores)[:10]
            self.assertEqual(
                set(got),
                {f"p{j}" for j in want_rows},
                f"precision={precision}",
            )

    def test_rerank_scores_near_duplicates_exact(self):
        rng = np.random.default_rng(2)
        dim = 32
        v = rng.standard_normal(dim).astype(np.float32)
        corpus = np.stack([v, v + 1e-3, v - 1e-3]).astype(np.float32)
        qvec = rng.standard_normal(dim).astype(np.float32)
        index = _index(corpus, qvec[None, :], precision="exact", device=self.device)
        run = {"q0": {"p0": 0.0, "p1": 0.0, "p2": 0.0}}
        out = index(_ranking(run, 1))["q0"]
        for j in range(3):
            self.assertAlmostEqual(
                out[f"p{j}"], float(corpus[j] @ qvec), places=3
            )


class TestPathologicalShapes(unittest.TestCase):
    device = "cpu"

    def test_one_mega_document_among_singletons(self):
        # MAXP over one 300-passage document next to single-passage docs:
        # the grouped/bounded formulations must reduce the ragged K
        rng = np.random.default_rng(3)
        dim = 16
        vecs, doc_ids = [], []
        for j in range(300):
            vecs.append(rng.standard_normal(dim).astype(np.float32))
            doc_ids.append("dBIG")
        for d in range(32):
            vecs.append(rng.standard_normal(dim).astype(np.float32))
            doc_ids.append(f"d{d}")
        corpus = np.stack(vecs)
        qvec = rng.standard_normal(dim).astype(np.float32)
        index = _index(corpus, qvec[None, :], mode=Mode.MAXP, doc_ids=doc_ids, device=self.device)
        run = {"q0": {"dBIG": 1.0, **{f"d{d}": 0.5 for d in range(32)}}}
        out = index(_ranking(run, 1))["q0"]
        want_big = float(np.max(corpus[:300] @ qvec))
        self.assertAlmostEqual(out["dBIG"], want_big, places=3)
        for d in range(32):
            self.assertAlmostEqual(
                out[f"d{d}"], float(corpus[300 + d] @ qvec), places=3
            )

    def test_depth_one_run(self):
        # degenerate depth: one candidate per query; serve cutoff > depth
        rng = np.random.default_rng(4)
        dim = 16
        corpus = rng.standard_normal((32, dim)).astype(np.float32)
        qvecs = rng.standard_normal((3, dim)).astype(np.float32)
        index = _index(corpus, qvecs, device=self.device)
        run = {f"q{i}": {f"p{i}": 2.0} for i in range(3)}
        got = index.serve(_ranking(run, 3), 0.3, 10)
        for i in range(3):
            q = got[f"q{i}"]
            self.assertEqual(len(q), 1)
            want = 0.3 * 2.0 + 0.7 * float(corpus[i] @ qvecs[i])
            self.assertAlmostEqual(q[f"p{i}"], want, places=4)

    def test_wildly_skewed_depths_per_query(self):
        # one query at depth 500, one at depth 2 in the same batch
        rng = np.random.default_rng(5)
        dim = 16
        corpus = rng.standard_normal((1024, dim)).astype(np.float32)
        qvecs = rng.standard_normal((2, dim)).astype(np.float32)
        index = _index(corpus, qvecs, device=self.device)
        run = {
            "q0": {f"p{j}": float(j % 7) for j in range(500)},
            "q1": {"p3": 1.0, "p9": 0.5},
        }
        ranking = _ranking(run, 2)
        got = index.serve(ranking, 0.25, 10)
        want = ranking.interpolate(index(ranking), 0.25).cut(10)
        for q in ("q0", "q1"):
            self.assertEqual(set(got[q]), set(want[q]))
            for d, s in want[q].items():
                self.assertAlmostEqual(got[q][d], s, places=4)

    def test_quality_metrics_with_tied_scores(self):
        # our own nDCG/RR on a run where every score ties: must not crash
        # and must stay within [0, 1]
        from fastforward_tpu_torch.utils.evaluate import ndcg_at_k, rr_at_k

        run_df = pd.DataFrame(
            {
                "q_id": ["q0"] * 8,
                "id": [f"p{j}" for j in range(8)],
                "score": [1.0] * 8,
            }
        )
        ranking = Ranking(
            run_df,
            queries={"q0": "query 0"},
            copy=False,
            is_sorted=True,
        )
        qrels = {"q0": {"p3": 1}}
        for v in (ndcg_at_k(ranking, qrels, 10), rr_at_k(ranking, qrels, 10)):
            self.assertGreaterEqual(v, 0.0)
            self.assertLessEqual(v, 1.0)


@pytest.mark.gpu
class TestTiedScoresCuda(TestTiedScores):
    device = "cuda"
    setUpClass = classmethod(_needs_card)


@pytest.mark.gpu
class TestNearDuplicateVectorsCuda(TestNearDuplicateVectors):
    device = "cuda"
    setUpClass = classmethod(_needs_card)


@pytest.mark.gpu
class TestPathologicalShapesCuda(TestPathologicalShapes):
    device = "cuda"
    setUpClass = classmethod(_needs_card)
