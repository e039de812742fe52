"""The port's ``utils`` on the CPU: evaluation, indexing, coalescing, PyTerrier.

The cases of ``tests/test_util.py``, ``tests/test_indexer.py`` and
``tests/test_pyterrier.py`` (its stub ``pyterrier``) run on the port with
the same data.  Beside them: the metrics and the coalesced index equal the
JAX package's on the same inputs, and ``utils`` imports with ``tqdm``,
``pyarrow``, ``jax`` and ``fastforward_tpu`` unavailable.
"""

import importlib
import importlib.util
import math
import subprocess
import sys
import types
import unittest
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from fastforward_tpu.index import InMemoryIndex as JaxInMemoryIndex
from fastforward_tpu.index import Mode as JaxMode
from fastforward_tpu.ranking import Ranking as JaxRanking
from fastforward_tpu.utils import create_coalesced_index as jax_create_coalesced_index
from fastforward_tpu.utils import evaluate as jax_evaluate
from fastforward_tpu_torch import ops
from fastforward_tpu_torch.encoder import LambdaEncoder
from fastforward_tpu_torch.index import InMemoryIndex as _InMemoryIndex
from fastforward_tpu_torch.index import Mode
from fastforward_tpu_torch.quantizer import PQ as _PQ
from fastforward_tpu_torch.ranking import Ranking
from fastforward_tpu_torch.utils import (
    Indexer,
    cos_dist,
    create_coalesced_index,
    evaluate,
    to_ir_measures,
)

from .test_ranking import DUMMY_QUERIES, RUN

REPO = Path(__file__).resolve().parent.parent


def InMemoryIndex(*args, **kwargs):  # noqa: N802 - the contract tests' name
    return _InMemoryIndex(*args, device="cpu", **kwargs)


def PQ(*args, **kwargs):  # noqa: N802 - the contract tests' name
    return _PQ(*args, device="cpu", **kwargs)


# -- tests/test_util.py ------------------------------------------------------------


class TestUtil(unittest.TestCase):
    def test_ir_measures_df(self):
        r = Ranking.from_run(RUN, queries=DUMMY_QUERIES)
        df = to_ir_measures(r)
        self.assertTrue(df["query_id"].equals(r._df["q_id"]))
        self.assertTrue(df["doc_id"].equals(r._df["id"]))
        self.assertTrue(df["score"].equals(r._df["score"]))
        self.assertEqual({"query_id", "doc_id", "score"}, set(df.columns))

    def test_cos_dist(self):
        a = np.array([1.0, 0.0])
        self.assertAlmostEqual(0.0, cos_dist(a, a))
        self.assertAlmostEqual(1.0, cos_dist(a, np.array([0.0, 1.0])))
        self.assertAlmostEqual(2.0, cos_dist(a, -a))


class TestOps(unittest.TestCase):
    def test_bucket(self):
        self.assertEqual(256, ops.bucket(1))
        self.assertEqual(256, ops.bucket(256))
        self.assertEqual(512, ops.bucket(257))
        self.assertEqual(1024, ops.bucket(1000))

    def test_interpolate(self):
        lex = np.array([1.0, 2.0], dtype=np.float32)
        sem = np.array([3.0, 4.0], dtype=np.float32)
        np.testing.assert_allclose(
            ops.interpolate_scores(torch.from_numpy(lex), torch.from_numpy(sem), 0.25).numpy(),
            0.25 * lex + 0.75 * sem,
        )

    def test_score_pairs_dense_matches_numpy(self):
        rng = np.random.default_rng(0)
        table = rng.normal(size=(64, 16)).astype(np.float32)
        qvecs = rng.normal(size=(4, 16)).astype(np.float32)
        rows = rng.integers(0, 64, size=40).astype(np.int32)
        qno = rng.integers(0, 4, size=40).astype(np.int32)
        seg = np.repeat(np.arange(8, dtype=np.int32), 5)

        expected = np.einsum("pd,pd->p", qvecs[qno], table[rows]).reshape(8, 5)

        p_bucket = ops.bucket(40)
        idx = torch.from_numpy(
            np.stack(
                [
                    ops.pad_i32(rows, p_bucket, 0),
                    ops.pad_i32(qno, p_bucket, 0),
                    ops.pad_i32(seg, p_bucket, 8),
                ]
            )
        )
        t, q = torch.from_numpy(table), torch.from_numpy(qvecs)
        got_max = ops.score_pairs_dense(t, q, idx, 8, "max").numpy()
        np.testing.assert_allclose(got_max, expected.max(axis=1), rtol=1e-5)
        got_mean = ops.score_pairs_dense(t, q, idx, 8, "mean").numpy()
        np.testing.assert_allclose(got_mean, expected.mean(axis=1), rtol=1e-5)


class TestEvaluate(unittest.TestCase):
    def setUp(self):
        self.ranking = Ranking.from_run(
            {
                "q1": {"a": 3.0, "b": 2.0, "c": 1.0},
                "q2": {"a": 3.0, "b": 2.0, "c": 1.0},
            }
        )
        self.qrels = {"q1": {"a": 1}, "q2": {"c": 1}}

    def test_rr(self):
        # q1: relevant at rank 1 -> 1.0; q2: rank 3 -> 1/3
        self.assertAlmostEqual((1.0 + 1 / 3) / 2, evaluate.rr_at_k(self.ranking, self.qrels))

    def test_ndcg_perfect(self):
        self.assertAlmostEqual(1.0, evaluate.ndcg_at_k(self.ranking, {"q1": {"a": 2}}))

    def test_ndcg_worst_position(self):
        got = evaluate.ndcg_at_k(self.ranking, {"q1": {"c": 1}})
        self.assertAlmostEqual(1.0 / math.log2(4), got)

    def test_recall(self):
        self.assertAlmostEqual(1.0, evaluate.recall_at_k(self.ranking, self.qrels, k=3))
        self.assertAlmostEqual(0.5, evaluate.recall_at_k(self.ranking, self.qrels, k=1))


@pytest.mark.parametrize("metric, k", [("ndcg_at_k", 10), ("rr_at_k", 3), ("recall_at_k", 20)])
def test_metrics_match_jax(metric, k):
    """Random runs and graded qrels from one seed: each metric equals the
    JAX package's."""
    rng = np.random.default_rng(5)
    run = {f"q{q}": {f"d{d}": float(rng.standard_normal()) for d in rng.choice(50, 30, replace=False)}
           for q in range(20)}
    qrels = {f"q{q}": {f"d{d}": int(rng.integers(0, 4)) for d in rng.choice(50, 8, replace=False)}
             for q in range(18)}
    got = getattr(evaluate, metric)(Ranking.from_run(run), qrels, k)
    want = getattr(jax_evaluate, metric)(JaxRanking.from_run(run), qrels, k)
    assert got == pytest.approx(want, abs=1e-12)


# -- tests/test_indexer.py ---------------------------------------------------------

RNG = np.random.default_rng(7)


class TestIndexer(unittest.TestCase):
    def setUp(self):
        self.target_index = InMemoryIndex()
        self.indexer = Indexer(
            self.target_index,
            LambdaEncoder(lambda q: np.zeros(shape=(16,))),
            encoder_batch_size=2,
            batch_size=4,
        )

    def test_from_dicts(self):
        dicts = [
            {"text": "123", "doc_id": "d1", "psg_id": "d1_p1"},
            {"text": "234", "doc_id": "d1", "psg_id": "d1_p2"},
            {"text": "456", "doc_id": "d1", "psg_id": "d1_p3"},
            {"text": "567", "doc_id": "d2", "psg_id": "d2_p1"},
            {"text": "678", "doc_id": "d3", "psg_id": "d3_p1"},
            {"text": "890", "doc_id": "d4"},
            {"text": "901", "psg_id": "d5_p1"},
        ]
        self.indexer.from_dicts(dicts)
        self.assertEqual(7, len(self.target_index))
        self.assertEqual({"d1", "d2", "d3", "d4"}, self.target_index.doc_ids)
        self.assertEqual(
            {"d1_p1", "d1_p2", "d1_p3", "d2_p1", "d3_p1", "d5_p1"},
            self.target_index.psg_ids,
        )

        with self.assertRaises(RuntimeError):
            Indexer(self.target_index, encoder=None).from_dicts(dicts)

    def test_from_index(self):
        source_index = InMemoryIndex()
        source_index.add(
            np.zeros((16, 16), dtype=np.float32), doc_ids=[f"d{i}" for i in range(16)]
        )
        self.indexer.from_index(source_index)
        self.assertEqual(source_index.doc_ids, self.target_index.doc_ids)
        self.assertEqual(16, len(self.target_index))

    def test_inline_quantizer_fitting(self):
        for quantizer_fit_batches in (1, 2):
            target_index = InMemoryIndex()
            indexer = Indexer(
                target_index,
                encoder=LambdaEncoder(lambda q: RNG.normal(size=(32,)).astype(np.float32)),
                quantizer=PQ(4, 8),
                batch_size=16,
                quantizer_fit_batches=quantizer_fit_batches,
            )
            indexer.from_dicts([{"text": f"text_{i}", "doc_id": f"d{i}"} for i in range(64)])
            self.assertTrue(target_index.quantizer._trained)
            self.assertEqual(64, len(target_index))

    def test_quantizer_guards(self):
        with self.assertRaises(ValueError):
            quantizer = PQ(4, 8)
            quantizer.fit(RNG.normal(size=(64, 64)).astype(np.float32))
            Indexer(self.target_index, quantizer=quantizer)

        with self.assertRaises(ValueError):
            self.target_index.add(np.zeros(shape=(8, 16), dtype=np.float32))
            Indexer(self.target_index, quantizer=PQ(4, 8))


def test_coalesced_index_matches_jax():
    """Random documents of 1-6 passages, coalesced by both packages at the
    same threshold: the same documents keep the same merged vectors."""
    rng = np.random.default_rng(9)
    sizes = rng.integers(1, 7, size=40)
    doc_ids = [f"d{d}" for d, c in enumerate(sizes) for _ in range(c)]
    base = rng.standard_normal((sizes.shape[0], 8)).astype(np.float32)
    vecs = base[np.repeat(np.arange(sizes.shape[0]), sizes)] + 0.4 * rng.standard_normal(
        (len(doc_ids), 8)
    ).astype(np.float32)
    source, target = InMemoryIndex(mode=Mode.MAXP), InMemoryIndex(mode=Mode.MAXP)
    jax_source, jax_target = JaxInMemoryIndex(mode=JaxMode.MAXP), JaxInMemoryIndex(mode=JaxMode.MAXP)
    source.add(vecs, doc_ids=doc_ids)
    jax_source.add(vecs, doc_ids=doc_ids)
    create_coalesced_index(source, target, 0.05, batch_size=7)
    jax_create_coalesced_index(jax_source, jax_target, 0.05, batch_size=7)
    assert len(target) == len(jax_target) < len(source)
    for doc in sorted(source.doc_ids):
        got, _ = target._get_vectors([doc])
        want, _ = jax_target._get_vectors([doc])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_utils_import_without_optional_packages():
    """``utils`` (and ``utils.serving``) import in an interpreter where
    ``tqdm``, ``pyarrow``, ``jax`` and ``fastforward_tpu`` cannot be
    imported, and create a coalesced index there without a progress bar."""
    code = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("tqdm", "pyarrow", "jax", "jaxlib", "fastforward_tpu"):
            raise ImportError("blocked " + name)
sys.meta_path.insert(0, Block())
import numpy as np
import fastforward_tpu_torch.utils.serving
from fastforward_tpu_torch import InMemoryIndex
from fastforward_tpu_torch.utils import BatchingServer, create_coalesced_index
a, b = InMemoryIndex(device="cpu"), InMemoryIndex(device="cpu")
a.add(np.eye(4, dtype=np.float32), doc_ids=["d0", "d0", "d1", "d1"])
create_coalesced_index(a, b, 2.0)
assert len(b) == 2, len(b)
print("ok")
"""
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


# -- tests/test_pyterrier.py ---------------------------------------------------------

HAVE_REAL_PT = importlib.util.find_spec("pyterrier") is not None
ADAPTER = "fastforward_tpu_torch.utils.pyterrier"


class TestPyTerrierGating(unittest.TestCase):
    def test_import_behavior(self):
        if HAVE_REAL_PT:  # pragma: no cover - environment-dependent
            from fastforward_tpu_torch.utils.pyterrier import FFInterpolate, FFScore

            self.assertTrue(callable(FFScore))
            self.assertEqual(0.3, FFInterpolate(0.3).alpha)
        else:
            sys.modules.pop(ADAPTER, None)
            with self.assertRaises(ImportError):
                importlib.import_module(ADAPTER)


def _make_stub_pt():
    """Minimal python-terrier stand-in: Transformer base + add_ranks."""
    pt = types.ModuleType("pyterrier")

    class Transformer:
        def __init__(self, *args, **kwargs):
            pass

    def add_ranks(df, single_query=False):
        out = df.copy()
        out["rank"] = (
            out.groupby("qid")["score"].rank(ascending=False, method="first") - 1
        ).astype(int)
        return out.sort_values(["qid", "rank"]).reset_index(drop=True)

    model = types.ModuleType("pyterrier.model")
    model.add_ranks = add_ranks
    pt.Transformer = Transformer
    pt.model = model
    return pt, model


@unittest.skipIf(HAVE_REAL_PT, "real python-terrier present; stub not needed")
class TestPyTerrierTransforms(unittest.TestCase):
    """Drive FFScore.transform / FFInterpolate.transform end to end."""

    @classmethod
    def setUpClass(cls):
        pt, model = _make_stub_pt()
        sys.modules["pyterrier"] = pt
        sys.modules["pyterrier.model"] = model
        sys.modules.pop(ADAPTER, None)
        cls._adapter = importlib.import_module(ADAPTER)

        cls.index = InMemoryIndex(query_encoder=LambdaEncoder(lambda _: np.ones(5)), mode=Mode.MAXP)
        cls.index.add(
            vectors=np.array(
                [
                    [1, 0, 0, 0, 0],
                    [1, 1, 0, 0, 0],
                    [1, 1, 1, 0, 0],
                    [1, 1, 1, 1, 0],
                ],
                dtype=np.float32,
            ),
            doc_ids=["d0", "d0", "d1", "d2"],
        )

    @classmethod
    def tearDownClass(cls):
        sys.modules.pop("pyterrier", None)
        sys.modules.pop("pyterrier.model", None)
        sys.modules.pop(ADAPTER, None)

    def _input_frame(self):
        return pd.DataFrame(
            {
                "qid": ["q1", "q1", "q1", "q2", "q2"],
                "docno": ["d0", "d1", "d2", "d0", "d2"],
                "query": ["query one"] * 3 + ["query two"] * 2,
                "score": [10.0, 5.0, 1.0, 7.0, 2.0],
            }
        )

    def test_ffscore_transform(self):
        out = self._adapter.FFScore(self.index).transform(self._input_frame())

        # lexical scores moved to score_0, semantic scores in score
        self.assertIn("score_0", out.columns)
        self.assertIn("rank", out.columns)
        by_key = out.set_index(["qid", "docno"])
        # all-ones query vector dots: d0 = max(1, 2) = 2, d1 = 3, d2 = 4
        expected_sem = {"d0": 2.0, "d1": 3.0, "d2": 4.0}
        expected_lex = {
            ("q1", "d0"): 10.0,
            ("q1", "d1"): 5.0,
            ("q1", "d2"): 1.0,
            ("q2", "d0"): 7.0,
            ("q2", "d2"): 2.0,
        }
        for (qid, docno), lex in expected_lex.items():
            row = by_key.loc[(qid, docno)]
            self.assertAlmostEqual(lex, row["score_0"], places=5)
            self.assertAlmostEqual(expected_sem[docno], row["score"], places=5)
        # ranks follow the semantic score ordering (0-based per query)
        q1 = out[out["qid"] == "q1"].sort_values("rank")
        self.assertEqual(["d2", "d1", "d0"], list(q1["docno"]))
        self.assertEqual([0, 1, 2], list(q1["rank"]))

    def test_ffscore_repr_unique_per_index(self):
        FFScore = self._adapter.FFScore
        other = InMemoryIndex(query_encoder=LambdaEncoder(lambda _: np.ones(5)), mode=Mode.MAXP)
        self.assertNotEqual(repr(FFScore(self.index)), repr(FFScore(other)))

    def test_ffinterpolate_transform(self):
        inp = pd.DataFrame(
            {
                "qid": ["q1", "q1", "q2"],
                "docno": ["d0", "d1", "d0"],
                "query": ["query one", "query one", "query two"],
                "score_0": [10.0, 4.0, 8.0],
                "score": [2.0, 3.0, 1.0],
            }
        )
        tf = self._adapter.FFInterpolate(0.25)
        self.assertEqual(0.25, tf.alpha)  # attr name required by GridScan
        out = tf.transform(inp)
        by_key = out.set_index(["qid", "docno"])["score"]
        self.assertAlmostEqual(0.25 * 10 + 0.75 * 2, by_key[("q1", "d0")])
        self.assertAlmostEqual(0.25 * 4 + 0.75 * 3, by_key[("q1", "d1")])
        self.assertAlmostEqual(0.25 * 8 + 0.75 * 1, by_key[("q2", "d0")])
        # interpolated ordering: q1 d0 (4.0) above d1 (3.25)
        q1 = out[out["qid"] == "q1"].sort_values("rank")
        self.assertEqual(["d0", "d1"], list(q1["docno"]))

    def test_pipeline_ffscore_then_interpolate(self):
        scored = self._adapter.FFScore(self.index).transform(self._input_frame())
        out = self._adapter.FFInterpolate(0.5).transform(scored)
        # q1 d0: 0.5*10 + 0.5*2 = 6; d1: 0.5*5 + 0.5*3 = 4; d2: 0.5*1+0.5*4=2.5
        q1 = out[out["qid"] == "q1"].sort_values("rank")
        self.assertEqual(["d0", "d1", "d2"], list(q1["docno"]))
        np.testing.assert_allclose([6.0, 4.0, 2.5], q1["score"].to_numpy())

    def test_ffrerank_fused_matches_pipeline(self):
        # FFRerank == FFScore >> FFInterpolate >> top-cutoff, in one call
        out = self._adapter.FFRerank(self.index, 0.5, 2).transform(self._input_frame())
        self.assertEqual(["query", "rank"], sorted(set(out.columns) - {"qid", "docno", "score"}))
        q1 = out[out["qid"] == "q1"].sort_values("rank")
        # q1 interpolated: d0=6, d1=4, d2=2.5 -> top-2 is d0, d1
        self.assertEqual(["d0", "d1"], list(q1["docno"]))
        np.testing.assert_allclose([6.0, 4.0], q1["score"].to_numpy())
        self.assertEqual(["query one", "query one"], list(q1["query"]))
        q2 = out[out["qid"] == "q2"].sort_values("rank")
        # q2 interpolated: d0 = 0.5*7+0.5*2 = 4.5, d2 = 0.5*2+0.5*4 = 3
        self.assertEqual(["d0", "d2"], list(q2["docno"]))
        np.testing.assert_allclose([4.5, 3.0], q2["score"].to_numpy())

    def test_ffrerank_repr_unique(self):
        FFRerank = self._adapter.FFRerank
        a = FFRerank(self.index, 0.5, 10)
        b = FFRerank(self.index, 0.2, 10)
        self.assertNotEqual(repr(a), repr(b))
