"""The port's ``OnDiskIndex`` on the CPU: the contract of
``tests/test_index.py::TestOnDiskIndex`` (with every ``TestIndex`` case it
inherits), HDF5 files shared with the JAX package in both directions, and
the host gather of an index without a device table.

The contract cases are copied with the same dummy data and run with the
port's ``Mode``, ``LambdaEncoder``, ``NanoPQ(2, 8)``, ``Ranking`` and
``create_coalesced_index``, each index on ``device="cpu"``.  Rankings the
two packages compute from one file agree within
``tests/test_stream_kernel.py:84``'s tolerance (atol 1e-4, rtol 1e-5).
"""

import itertools
import json
import shutil
import subprocess
import sys
import tempfile
import unittest
from collections import defaultdict
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from fastforward_tpu.encoder import LambdaEncoder as JaxLambdaEncoder
from fastforward_tpu.index import Mode as JaxMode
from fastforward_tpu.index import OnDiskIndex as JaxOnDiskIndex
from fastforward_tpu.quantizer import NanoPQ as JaxNanoPQ
from fastforward_tpu.ranking import Ranking as JaxRanking
from fastforward_tpu_torch.encoder import LambdaEncoder
from fastforward_tpu_torch.index import InMemoryIndex, Mode, OnDiskIndex
from fastforward_tpu_torch.parallel import MeshConfig
from fastforward_tpu_torch.quantizer import NanoPQ, ScalarQuantizer
from fastforward_tpu_torch.ranking import Ranking
from fastforward_tpu_torch.utils import create_coalesced_index

REPO = Path(__file__).resolve().parent.parent

DUMMY_QUERIES = {"q1": "query 1", "q2": "query 2"}
DUMMY_DOC_IDS = ["d0", "d0", "d1", "d2", "d3"]
UNIQUE_DUMMY_DOC_IDS = list(set(DUMMY_DOC_IDS))
DUMMY_PSG_IDS = ["p0", "p1", "p2", "p3", "p4"]
DUMMY_VECTORS = np.array(
    [
        [1, 0, 0, 0, 0],
        [1, 1, 0, 0, 0],
        [1, 1, 1, 0, 0],
        [1, 1, 1, 1, 0],
        [1, 1, 1, 1, 1],
    ]
)
DUMMY_NUM, DUMMY_DIM = DUMMY_VECTORS.shape
DUMMY_DOC_RUN = {
    "q1": {"d0": 100, "d1": 2, "d2": 3, "d3": 200},
    "q2": {"d0": 400, "d1": 5, "d2": 6, "d3": 800},
}
DUMMY_DOC_RANKING = Ranking.from_run(DUMMY_DOC_RUN, queries=DUMMY_QUERIES)
DUMMY_PSG_RUN = {
    "q1": {"p0": 100, "p1": 2, "p2": 3, "p3": 4, "p4": 5},
    "q2": {"p0": 500, "p1": 6, "p2": 7, "p3": 8, "p4": 9},
}
DUMMY_PSG_RANKING = Ranking.from_run(DUMMY_PSG_RUN, queries=DUMMY_QUERIES)
DUMMY_ENCODER = LambdaEncoder(lambda _: np.array([1, 1, 1, 1, 1]))

DUMMY_QUANTIZER = NanoPQ(2, 8, device="cpu")
DUMMY_QUANTIZER.fit(np.random.default_rng(0).normal(size=(16, 16)).astype(np.float32))

#: tests/test_stream_kernel.py:84
SCORE_TOL = {"atol": 1e-4, "rtol": 1e-5}


def _disk(path, *args, **kwargs) -> OnDiskIndex:
    return OnDiskIndex(path, *args, device="cpu", **kwargs)


def _load(path, **kwargs) -> OnDiskIndex:
    return OnDiskIndex.load(path, device="cpu", **kwargs)


def _assert_get_vectors_equal(index_1, index_2, ids):
    vecs_1, ids_1 = index_1._get_vectors(ids)
    vecs_2, ids_2 = index_2._get_vectors(ids)
    _assert_vectors_match(vecs_1, ids_1, vecs_2, ids_2)


def _assert_vectors_match(vecs_1, ids_1, vecs_2, ids_2):
    """Order-insensitive comparison of (vectors, ids) pairs."""
    assert vecs_1.shape == vecs_2.shape
    assert len(ids_1) == len(ids_2)

    positions_1 = defaultdict(list)
    for pos, i in enumerate(ids_1):
        positions_1[i].append(pos)
    positions_2 = defaultdict(list)
    for pos, i in enumerate(ids_2):
        positions_2[i].append(pos)

    for i in positions_1:
        for p1, p2 in zip(positions_1[i], positions_2[i]):
            np.testing.assert_almost_equal(vecs_1[p1], vecs_2[p2], decimal=6)


class TestTorchOnDiskIndex(unittest.TestCase):
    """``tests/test_index.py``'s ``TestOnDiskIndex``, with the ``TestIndex``
    cases it inherits, on the port."""

    @classmethod
    def setUpClass(cls):
        cls.temp_dir = Path(tempfile.mkdtemp())
        cls.index = _disk(cls.temp_dir / "index.h5", init_size=32, chunk_size=32)
        cls.doc_psg_index = _disk(cls.temp_dir / "doc_psg_index.h5", DUMMY_ENCODER)
        cls.index_partial_ids = _disk(cls.temp_dir / "index_partial_ids.h5", DUMMY_ENCODER)
        cls.doc_index = _disk(cls.temp_dir / "doc_index.h5", DUMMY_ENCODER)
        cls.psg_index = _disk(cls.temp_dir / "psg_index.h5", DUMMY_ENCODER)
        cls.index_no_enc = _disk(cls.temp_dir / "index_no_enc.h5", query_encoder=None)
        cls.index_wrong_dim = _disk(cls.temp_dir / "index_wrong_dim.h5", query_encoder=None)
        cls.early_stopping_index = _disk(
            cls.temp_dir / "early_stopping_index.h5",
            LambdaEncoder(lambda q: np.array([10, 10])),
            mode=Mode.PASSAGE,
        )
        cls.coalesced_indexes = [
            _disk(cls.temp_dir / "coalesced_index_1.h5", mode=Mode.MAXP),
            _disk(cls.temp_dir / "coalesced_index_2.h5", mode=Mode.MAXP),
        ]
        cls.iter_indexes = [
            _disk(cls.temp_dir / "iter_index_1.h5", init_size=2, chunk_size=2),
            _disk(cls.temp_dir / "iter_index_2.h5", init_size=5),
        ]
        cls.quantized_index = _disk(cls.temp_dir / "quantized_index.h5", quantizer=DUMMY_QUANTIZER)

        cls.doc_psg_index.add(vectors=DUMMY_VECTORS, doc_ids=DUMMY_DOC_IDS, psg_ids=DUMMY_PSG_IDS)
        # mixed: doc-only, psg-only, and both IDs per vector
        cls.index_partial_ids.add(
            vectors=DUMMY_VECTORS,
            doc_ids=[None, None] + DUMMY_DOC_IDS[2:],
            psg_ids=DUMMY_PSG_IDS[:-2] + [None, None],
        )
        cls.index_partial_ids.add(vectors=DUMMY_VECTORS[:2], doc_ids=DUMMY_DOC_IDS[:2])
        cls.index_partial_ids.add(vectors=DUMMY_VECTORS[-2:], psg_ids=DUMMY_PSG_IDS[-2:])
        cls.doc_index.add(vectors=DUMMY_VECTORS, doc_ids=DUMMY_DOC_IDS)
        cls.psg_index.add(vectors=DUMMY_VECTORS, psg_ids=DUMMY_PSG_IDS)
        cls.quantized_index.add(
            vectors=np.random.default_rng(1)
            .normal(size=(5, DUMMY_QUANTIZER.dims[0]))
            .astype(np.float32),
            doc_ids=DUMMY_DOC_IDS,
        )

    @classmethod
    def tearDownClass(cls):
        shutil.rmtree(cls.temp_dir)

    # -- the TestIndex cases ---------------------------------------------------

    def test_properties(self):
        self.assertEqual(set(DUMMY_DOC_IDS), self.doc_psg_index.doc_ids)
        self.assertEqual(set(DUMMY_PSG_IDS), self.doc_psg_index.psg_ids)
        self.assertEqual(DUMMY_NUM, len(self.doc_psg_index))
        self.assertEqual(DUMMY_DIM, self.doc_psg_index.dim)

        self.assertEqual(set(DUMMY_DOC_IDS), self.index_partial_ids.doc_ids)
        self.assertEqual(set(DUMMY_PSG_IDS), self.index_partial_ids.psg_ids)
        self.assertEqual(DUMMY_NUM + 4, len(self.index_partial_ids))
        self.assertEqual(DUMMY_DIM, self.index_partial_ids.dim)

        self.assertEqual(set(DUMMY_DOC_IDS), self.doc_index.doc_ids)
        self.assertEqual(0, len(self.doc_index.psg_ids))
        self.assertEqual(DUMMY_NUM, len(self.doc_index))
        self.assertEqual(DUMMY_DIM, self.doc_index.dim)

        self.assertEqual(set(DUMMY_PSG_IDS), self.psg_index.psg_ids)
        self.assertEqual(0, len(self.psg_index.doc_ids))
        self.assertEqual(DUMMY_NUM, len(self.psg_index))
        self.assertEqual(DUMMY_DIM, self.psg_index.dim)

        self.assertEqual(16, self.quantized_index.dim)

    def test_add_retrieve(self):
        self.assertEqual(0, len(self.index))

        data = np.random.default_rng(2).normal(size=(80, 16))
        doc_ids = [f"doc_{i // 2}" for i in range(data.shape[0])]
        psg_ids = [f"psg_{i}" for i in range(data.shape[0])]

        # incremental adds across growth boundaries
        for lower, upper in [(0, 8), (8, 24), (24, 80)]:
            self.index.add(
                data[lower:upper],
                doc_ids=doc_ids[lower:upper],
                psg_ids=psg_ids[lower:upper],
            )
            self.assertEqual(upper, len(self.index))

            self.index.mode = Mode.PASSAGE
            vecs, ids = self.index._get_vectors(psg_ids[lower:upper])
            _assert_vectors_match(vecs, ids, data[lower:upper], psg_ids[lower:upper])

            self.index.mode = Mode.MAXP
            vecs, ids = self.index._get_vectors(
                [f"doc_{i}" for i in range(lower // 2, upper // 2)]
            )
            _assert_vectors_match(vecs, ids, data[lower:upper], doc_ids[lower:upper])

    def test_queries_attached(self):
        self.doc_psg_index.mode = Mode.MAXP
        self.assertTrue(self.doc_psg_index(DUMMY_DOC_RANKING).has_queries)

    def test_maxp(self):
        self.doc_psg_index.mode = Mode.MAXP
        self.assertEqual(
            self.doc_psg_index(DUMMY_DOC_RANKING),
            Ranking.from_run(
                {
                    "q1": {"d0": 2, "d1": 3, "d2": 4, "d3": 5},
                    "q2": {"d0": 2, "d1": 3, "d2": 4, "d3": 5},
                }
            ),
        )

    def test_firstp(self):
        expected = Ranking.from_run(
            {
                "q1": {"d0": 1, "d1": 3, "d2": 4, "d3": 5},
                "q2": {"d0": 1, "d1": 3, "d2": 4, "d3": 5},
            }
        )
        self.doc_psg_index.mode = Mode.FIRSTP
        self.assertEqual(self.doc_psg_index(DUMMY_DOC_RANKING), expected)
        self.index_partial_ids.mode = Mode.FIRSTP
        self.assertEqual(self.doc_psg_index(DUMMY_DOC_RANKING), expected)

    def test_avep(self):
        expected = Ranking.from_run(
            {
                "q1": {"d0": 1.5, "d1": 3, "d2": 4, "d3": 5},
                "q2": {"d0": 1.5, "d1": 3, "d2": 4, "d3": 5},
            }
        )
        self.doc_psg_index.mode = Mode.AVEP
        self.assertEqual(self.doc_psg_index(DUMMY_DOC_RANKING), expected)
        self.index_partial_ids.mode = Mode.AVEP
        self.assertEqual(self.index_partial_ids(DUMMY_DOC_RANKING), expected)

    def test_passage(self):
        expected = Ranking.from_run(
            {
                "q1": {"p0": 1, "p1": 2, "p2": 3, "p3": 4, "p4": 5},
                "q2": {"p0": 1, "p1": 2, "p2": 3, "p3": 4, "p4": 5},
            }
        )
        self.doc_psg_index.mode = Mode.PASSAGE
        self.assertEqual(self.doc_psg_index(DUMMY_PSG_RANKING), expected)
        self.index_partial_ids.mode = Mode.PASSAGE
        self.assertEqual(self.index_partial_ids(DUMMY_PSG_RANKING), expected)

    def test_errors(self):
        # no IDs at all
        with self.assertRaises(ValueError):
            self.index_no_enc.add(DUMMY_VECTORS, doc_ids=None, psg_ids=None)

        # too few IDs
        with self.assertRaises(ValueError):
            self.index_no_enc.add(DUMMY_VECTORS, doc_ids=DUMMY_DOC_IDS[:-2], psg_ids=None)
        with self.assertRaises(ValueError):
            self.index_no_enc.add(DUMMY_VECTORS, doc_ids=None, psg_ids=DUMMY_PSG_IDS[:-2])

        # a vector with neither ID
        with self.assertRaises(ValueError):
            self.index_no_enc.add(
                DUMMY_VECTORS,
                doc_ids=[None] + DUMMY_DOC_IDS[1:],
                psg_ids=[None] + DUMMY_PSG_IDS[1:],
            )

        # duplicate passage ID
        with self.assertRaises(RuntimeError):
            self.index_no_enc.add(DUMMY_VECTORS[:1], psg_ids=DUMMY_PSG_IDS[:1])
            self.index_no_enc.add(DUMMY_VECTORS[:1], psg_ids=DUMMY_PSG_IDS[:1])

        # encoding without an encoder
        with self.assertRaises(RuntimeError):
            self.index_no_enc.encode_queries(["test"])

        # dimension mismatch
        self.index_wrong_dim.add(np.array([[0, 0], [1, 1]]), doc_ids=["d1", "d2"])
        with self.assertRaises(ValueError):
            self.index_wrong_dim.add(np.array([[0, 0, 0], [1, 1, 1]]), doc_ids=["d3", "d4"])

        # ranking without queries
        with self.assertRaises(ValueError):
            self.doc_psg_index(Ranking.from_run(DUMMY_DOC_RUN))

        # early stopping without its parameters
        with self.assertRaises(ValueError):
            self.doc_psg_index(DUMMY_DOC_RANKING, early_stopping=10, early_stopping_alpha=None)
        with self.assertRaises(ValueError):
            self.doc_psg_index(DUMMY_DOC_RANKING, early_stopping=10, early_stopping_depths=None)

        # quantizer on a non-empty index
        with self.assertRaises(RuntimeError):
            self.doc_psg_index.quantizer = DUMMY_QUANTIZER

        # ID missing from the index
        ranking_missing = Ranking.from_run({"q1": {"d0": 100, "dx": 2}}, queries=DUMMY_QUERIES)
        with self.assertRaises(IndexError):
            self.doc_psg_index(ranking_missing)

    def test_early_stopping(self):
        self.early_stopping_index.add(
            np.stack([[1, 0], [1, 1]] * 10), psg_ids=[f"p{i}" for i in range(20)]
        )
        r = Ranking(
            pd.DataFrame(
                [
                    {"q_id": q, "query": q, "id": f"p{i}", "score": i}
                    for i in range(20)
                    for q in ("q1", "q2")
                ]
            )
        )

        expected = Ranking(
            pd.DataFrame(
                [
                    {"q_id": q, "id": f"p{i}", "score": s}
                    for q in ("q2", "q1")
                    for i, s in [
                        (19, 20.0),
                        (17, 20.0),
                        (15, 20.0),
                        (13, 20.0),
                        (11, 20.0),
                        (18, 10.0),
                        (16, 10.0),
                        (14, 10.0),
                        (12, 10.0),
                        (10, 10.0),
                    ]
                ]
            )
        )

        for depths in ((2, 5, 10, 20), (5, 2, 20, 10)):  # order must not matter
            self.assertEqual(
                self.early_stopping_index(
                    r,
                    early_stopping=5,
                    early_stopping_alpha=0.5,
                    early_stopping_depths=depths,
                ),
                expected,
            )

    def test_batch_size_invariance(self):
        r = Ranking.from_run(
            {
                "q1": {"d0": 2, "d1": 3, "d2": 4, "d3": 10},
                "q2": {"d0": 5, "d1": 4, "d2": 3, "d3": 12},
                "q3": {"d0": 8, "d1": 5, "d2": 2, "d3": 1},
                "q4": {"d0": 11, "d1": 6, "d2": 1, "d3": 2},
                "q5": {"d0": 14, "d1": 7, "d2": 0, "d3": 3},
            },
            queries={f"q{n}": f"query {n}" for n in range(1, 6)},
        )
        expected = self.doc_psg_index(r)
        for batch_size in (2, 5, 10):
            self.assertEqual(expected, self.doc_psg_index(r, batch_size=batch_size))

    def test_coalescing(self):
        # delta = 0.3: d0's two vectors merge into their average
        create_coalesced_index(self.doc_index, self.coalesced_indexes[0], 0.3)
        self.assertEqual(self.doc_index.doc_ids, self.coalesced_indexes[0].doc_ids)
        d0_expected = np.average([DUMMY_VECTORS[0], DUMMY_VECTORS[1]], axis=0)
        d0_vectors, _ = self.coalesced_indexes[0]._get_vectors(["d0"])
        self.assertEqual(1, len(d0_vectors))
        self.assertTrue(np.array_equal(d0_expected, d0_vectors[0]))

        # delta = 0.2: nothing merges
        create_coalesced_index(self.doc_index, self.coalesced_indexes[1], 0.2, batch_size=2)
        self.assertEqual(self.doc_index.doc_ids, self.coalesced_indexes[1].doc_ids)
        for doc_id in self.doc_index.doc_ids:
            vectors_1, _ = self.doc_index._get_vectors([doc_id])
            vectors_2, _ = self.coalesced_indexes[1]._get_vectors([doc_id])
            self.assertEqual(len(vectors_1), len(vectors_2))
            for v1, v2 in zip(vectors_1, vectors_2):
                self.assertTrue(np.array_equal(v1, v2))

        # non-empty target rejected
        with self.assertRaises(ValueError):
            create_coalesced_index(self.doc_index, self.coalesced_indexes[0], 0.3)

    def test_iter(self):
        for index in self.iter_indexes:
            index.add(DUMMY_VECTORS, doc_ids=DUMMY_DOC_IDS, psg_ids=DUMMY_PSG_IDS)
            for batch_size in (1, 3, 5, 10):
                vectors, doc_ids, psg_ids = zip(*index.batch_iter(batch_size))
                np.testing.assert_equal(DUMMY_VECTORS, np.concatenate(vectors))
                self.assertEqual(DUMMY_DOC_IDS, list(itertools.chain.from_iterable(doc_ids)))
                self.assertEqual(DUMMY_PSG_IDS, list(itertools.chain.from_iterable(psg_ids)))

    def test_quantization(self):
        self.assertEqual(2, self.quantized_index._get_internal_dim())

        # iteration yields decoded (original-dimension) vectors
        for vec, _, _ in self.quantized_index:
            self.assertEqual(16, vec.shape[0])

        # _get_vectors yields stored codes
        self.quantized_index.mode = Mode.MAXP
        self.assertEqual(
            self.quantized_index._get_vectors(UNIQUE_DUMMY_DOC_IDS)[0].shape, (5, 2)
        )

    def test_quantized_scoring_matches_decode(self):
        """Scoring the gathered, decoded rows == decode-then-dot."""
        self.quantized_index.mode = Mode.MAXP
        self.quantized_index.query_encoder = LambdaEncoder(lambda _: np.ones(16, dtype=np.float32))
        ranking = Ranking.from_run(
            {"q1": {d: 1.0 for d in UNIQUE_DUMMY_DOC_IDS}},
            queries={"q1": "query 1"},
        )
        result = self.quantized_index(ranking)

        qvec = np.ones(16, dtype=np.float32)
        codes, ids = self.quantized_index._get_vectors(UNIQUE_DUMMY_DOC_IDS)
        decoded = DUMMY_QUANTIZER.decode(codes)
        expected = defaultdict(lambda: -np.inf)
        for vec, i in zip(decoded, ids):
            expected[i] = max(expected[i], float(np.dot(qvec, vec)))
        got = result["q1"]
        for i in UNIQUE_DUMMY_DOC_IDS:
            self.assertAlmostEqual(expected[i], got[i], places=4)

    # -- the TestOnDiskIndex cases ----------------------------------------------

    def test_load(self):
        # vectors survive a save/load round-trip
        shutil.copy(self.temp_dir / "doc_psg_index.h5", self.temp_dir / "doc_psg_index_copy.h5")
        index_copied = _load(self.temp_dir / "doc_psg_index_copy.h5")
        self.assertEqual(index_copied.doc_ids, self.doc_psg_index.doc_ids)
        self.assertEqual(index_copied.psg_ids, self.doc_psg_index.psg_ids)
        for mode, ids in [(Mode.PASSAGE, DUMMY_PSG_IDS), (Mode.MAXP, UNIQUE_DUMMY_DOC_IDS)]:
            self.doc_psg_index.mode = mode
            index_copied.mode = mode
            _assert_get_vectors_equal(index_copied, self.doc_psg_index, ids)

        shutil.copy(self.temp_dir / "doc_index.h5", self.temp_dir / "doc_index_copy.h5")
        index_copied = _load(self.temp_dir / "doc_index_copy.h5")
        self.assertEqual(index_copied.doc_ids, self.doc_index.doc_ids)
        self.assertEqual(index_copied.psg_ids, self.doc_index.psg_ids)
        self.doc_index.mode = Mode.MAXP
        index_copied.mode = Mode.MAXP
        _assert_get_vectors_equal(index_copied, self.doc_index, UNIQUE_DUMMY_DOC_IDS)

        shutil.copy(self.temp_dir / "psg_index.h5", self.temp_dir / "psg_index_copy.h5")
        index_copied = _load(self.temp_dir / "psg_index_copy.h5")
        self.assertEqual(index_copied.doc_ids, self.psg_index.doc_ids)
        self.assertEqual(index_copied.psg_ids, self.psg_index.psg_ids)
        self.psg_index.mode = Mode.PASSAGE
        index_copied.mode = Mode.PASSAGE
        _assert_get_vectors_equal(index_copied, self.psg_index, DUMMY_PSG_IDS)

        # quantizer state survives the round-trip
        shutil.copy(
            self.temp_dir / "quantized_index.h5", self.temp_dir / "quantized_index_copy.h5"
        )
        quantized_copied = _load(self.temp_dir / "quantized_index_copy.h5")
        self.assertEqual(quantized_copied.quantizer, self.quantized_index.quantizer)

        # empty index loads
        _disk(self.temp_dir / "empty_index.h5")
        empty_loaded = _load(self.temp_dir / "empty_index.h5")
        self.assertEqual(0, len(empty_loaded.doc_ids))
        self.assertEqual(0, len(empty_loaded.psg_ids))

    def test_store_quantizer(self):
        index_with_quantizer = _disk(self.temp_dir / "index_with_quantizer.h5")
        index_with_quantizer.quantizer = DUMMY_QUANTIZER
        new_quantizer = NanoPQ(2, 8, device="cpu")
        new_quantizer.fit(np.random.default_rng(4).normal(size=(16, 16)).astype(np.float32))
        index_with_quantizer.quantizer = new_quantizer

        del index_with_quantizer
        reloaded = _load(self.temp_dir / "index_with_quantizer.h5")
        self.assertEqual(new_quantizer, reloaded.quantizer)

    def test_to_memory(self):
        for index, params in [
            (self.doc_index, [(Mode.MAXP, UNIQUE_DUMMY_DOC_IDS)]),
            (self.psg_index, [(Mode.PASSAGE, DUMMY_PSG_IDS)]),
            (
                self.doc_psg_index,
                [(Mode.MAXP, UNIQUE_DUMMY_DOC_IDS), (Mode.PASSAGE, DUMMY_PSG_IDS)],
            ),
        ]:
            mem_index = index.to_memory()
            mem_index_batched = index.to_memory(batch_size=2)
            self.assertIsInstance(mem_index, InMemoryIndex)
            self.assertEqual(index.device, mem_index.device)
            for mode, ids in params:
                index.mode = mode
                mem_index.mode = mode
                mem_index_batched.mode = mode

                self.assertEqual(mem_index.doc_ids, index.doc_ids)
                self.assertEqual(mem_index.psg_ids, index.psg_ids)
                self.assertEqual(mem_index_batched.doc_ids, index.doc_ids)
                self.assertEqual(mem_index_batched.psg_ids, index.psg_ids)

                _assert_get_vectors_equal(mem_index, index, ids)
                _assert_get_vectors_equal(mem_index_batched, index, ids)

        mem_quantized = self.quantized_index.to_memory()
        self.assertEqual(mem_quantized.quantizer, self.quantized_index.quantizer)

    def test_max_id_length(self):
        index = _disk(self.temp_dir / "max_id_length_index.h5", max_id_length=3)
        vectors = np.zeros(shape=(16, 16))
        doc_ids_ok = ["d1"] * 16
        psg_ids_ok = [f"p{i}" for i in range(16)]
        index.add(vectors, doc_ids=doc_ids_ok, psg_ids=psg_ids_ok)

        with self.assertRaises(RuntimeError):
            index.add(vectors, doc_ids=[d + "-long" for d in doc_ids_ok])
        with self.assertRaises(RuntimeError):
            index.add(vectors, psg_ids=[p + "-long" for p in psg_ids_ok])

        # the failed adds left the index unchanged
        self.assertEqual(index.doc_ids, set(doc_ids_ok))
        self.assertEqual(index.psg_ids, set(psg_ids_ok))
        self.assertEqual(16, len(index))

    def test_max_id_length_bytes(self):
        """IDs are bounded by encoded UTF-8 bytes, not characters."""
        index = _disk(self.temp_dir / "max_id_bytes_index.h5", max_id_length=4)
        vectors = np.zeros(shape=(2, 16))
        # "docé" is 4 characters but 5 UTF-8 bytes
        with self.assertRaises(RuntimeError):
            index.add(vectors, doc_ids=["docé", "d2"])
        with self.assertRaises(RuntimeError):
            index.add(vectors, psg_ids=["pé1é", "p2"])
        self.assertEqual(0, len(index))

        # exactly-fitting multi-byte IDs round-trip
        index.add(vectors, doc_ids=["dé1", "d2"], psg_ids=["p1", "p2"])
        reloaded = _load(self.temp_dir / "max_id_bytes_index.h5")
        self.assertEqual({"dé1", "d2"}, reloaded.doc_ids)

    def test_max_indexing_size(self):
        index = _disk(
            self.temp_dir / "max_indexing_size_index.h5", mode=Mode.PASSAGE, max_indexing_size=5
        )
        psg_reps = np.random.default_rng(5).normal(size=(16, 16))
        psg_ids = [f"p{i}" for i in range(16)]
        index.add(psg_reps, psg_ids=psg_ids)
        vecs, ids = index._get_vectors(psg_ids)
        _assert_vectors_match(vecs, ids, psg_reps, psg_ids)

    def test_memory_mapped(self):
        index = _disk(
            self.temp_dir / "mmap_index.h5",
            mode=Mode.PASSAGE,
            init_size=8,
            chunk_size=4,
            memory_mapped=True,
        )
        psg_reps = np.random.default_rng(6).normal(size=(16, 16))
        psg_ids = [f"p{i}" for i in range(16)]
        index.add(psg_reps, psg_ids=psg_ids)
        vecs, ids = index._get_vectors(psg_ids)
        _assert_vectors_match(vecs, ids, psg_reps, psg_ids)
        # the rows are copies: the memory maps are read-only
        self.assertTrue(vecs.flags.writeable)

    def test_hbm_cache(self):
        """hbm_cache=True scores via the device table, same results."""
        index = _disk(self.temp_dir / "hbm_cache_index.h5", DUMMY_ENCODER, hbm_cache=True)
        index.add(DUMMY_VECTORS, doc_ids=DUMMY_DOC_IDS, psg_ids=DUMMY_PSG_IDS)
        index.mode = Mode.MAXP
        self.doc_psg_index.mode = Mode.MAXP
        self.assertEqual(index(DUMMY_DOC_RANKING), self.doc_psg_index(DUMMY_DOC_RANKING))
        self.assertIsNotNone(index._device_view())


# -- the port and the JAX package on one file ----------------------------------

N_ROWS, DIM = 300, 16


def _rows():
    """Vectors, 1-4 passages a document, a run over documents and one over
    passages (12 queries x 20 candidates)."""
    rng = np.random.default_rng(11)
    vectors = rng.standard_normal((N_ROWS, DIM), dtype=np.float32)
    per_doc = rng.integers(1, 5, size=N_ROWS)
    doc_ids = [f"d{i}" for i, n in enumerate(per_doc) for _ in range(n)][:N_ROWS]
    psg_ids = [f"p{i}" for i in range(N_ROWS)]
    docs = sorted(set(doc_ids))
    queries = {f"q{q}": f"query {q}" for q in range(12)}
    doc_run = {
        q: {docs[j]: float(-r) for r, j in enumerate(rng.choice(len(docs), 20, replace=False))}
        for q in queries
    }
    psg_run = {
        q: {psg_ids[j]: float(-r) for r, j in enumerate(rng.choice(N_ROWS, 20, replace=False))}
        for q in queries
    }
    qvecs = {text: rng.standard_normal(DIM, dtype=np.float32) for text in queries.values()}
    return vectors, doc_ids, psg_ids, queries, doc_run, psg_run, qvecs


def _assert_rankings_close(got, want):
    got_df = got._df.sort_values(["q_id", "id"]).reset_index(drop=True)
    want_df = want._df.sort_values(["q_id", "id"]).reset_index(drop=True)
    assert got_df["q_id"].astype(str).tolist() == want_df["q_id"].astype(str).tolist()
    assert got_df["id"].astype(str).tolist() == want_df["id"].astype(str).tolist()
    np.testing.assert_allclose(
        got_df["score"].to_numpy(np.float64), want_df["score"].to_numpy(np.float64), **SCORE_TOL
    )


def _jax_quantizer(vectors):
    q = JaxNanoPQ(4, 16)
    q.fit(vectors)
    return q


def _port_quantizer(vectors):
    q = NanoPQ(4, 16, device="cpu")
    q.fit(vectors)
    return q


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "pq"])
@pytest.mark.parametrize("hbm_cache", [False, True], ids=["host_gather", "hbm_cache"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_file_written_by_one_package_ranks_the_same_in_the_other(tmp_path, writer, hbm_cache, quantized):
    """One package writes the file (adds in three steps across chunk
    growth); both open it and re-rank the passage and the document run in
    every mode: the rankings agree within the kernel tolerance, and the
    port's stored rows and codes equal the JAX package's."""
    vectors, doc_ids, psg_ids, queries, doc_run, psg_run, qvecs = _rows()
    path = tmp_path / "index.h5"
    if writer == "jax":
        quantizer = _jax_quantizer(vectors) if quantized else None
        writing = JaxOnDiskIndex(path, quantizer=quantizer, init_size=64, chunk_size=64)
    else:
        quantizer = _port_quantizer(vectors) if quantized else None
        writing = _disk(path, quantizer=quantizer, init_size=64, chunk_size=64)
    for lo, hi in ((0, 50), (50, 130), (130, N_ROWS)):
        writing.add(vectors[lo:hi], doc_ids=doc_ids[lo:hi], psg_ids=psg_ids[lo:hi])
    del writing

    jax_index = JaxOnDiskIndex.load(path, JaxLambdaEncoder(qvecs.__getitem__))
    port_index = _load(path, query_encoder=LambdaEncoder(qvecs.__getitem__), hbm_cache=hbm_cache)
    assert len(port_index) == N_ROWS and port_index.doc_ids == set(doc_ids)
    if quantized:
        (_, got_attrs, got_data), (_, want_attrs, want_data) = (
            port_index.quantizer.serialize(),
            jax_index.quantizer.serialize(),
        )
        assert got_attrs == want_attrs and got_data.keys() == want_data.keys()
        for key in want_data:
            np.testing.assert_array_equal(got_data[key], np.asarray(want_data[key]))
    for mode, run in (("PASSAGE", psg_run), ("MAXP", doc_run), ("AVEP", doc_run), ("FIRSTP", doc_run)):
        jax_index.mode, port_index.mode = JaxMode[mode], Mode[mode]
        ids = list(run["q0"])
        np.testing.assert_array_equal(port_index._get_vectors(ids)[0], jax_index._get_vectors(ids)[0])
        want = jax_index(JaxRanking.from_run(run, queries=queries))
        got = port_index(Ranking.from_run(run, queries=queries))
        _assert_rankings_close(got, want)
    assert (port_index._device_view() is not None) == hbm_cache


def test_hbm_cache_views_and_invalidation(tmp_path):
    """``hbm_cache=True`` builds ``InMemoryIndex``'s views on the index's
    device (fp32 rows, 3D int8 codes, compact PQ codes) and ``add`` drops
    the view."""
    rng = np.random.default_rng(3)
    vectors = rng.standard_normal((40, 256), dtype=np.float32)
    psg_ids = [f"p{i}" for i in range(40)]
    scalar = ScalarQuantizer()
    scalar.fit(vectors)
    pq = NanoPQ(8, 16, device="cpu")
    pq.fit(vectors)
    for name, quantizer, kind, shape, dtype in (
        ("dense", None, "dense", (4096, 256), torch.float32),
        ("int8", scalar, "scalar", (4096, 2, 128), torch.int8),
        ("pq", pq, "pq", (4096, 8), torch.uint8),
    ):
        index = _disk(tmp_path / f"{name}.h5", quantizer=quantizer, hbm_cache=True, mode=Mode.PASSAGE)
        assert index._device_view() is None  # empty
        index.add(vectors[:30], psg_ids=psg_ids[:30])
        view = index._device_view()
        assert view.kind == kind and tuple(view.table.shape) == shape and view.table.dtype == dtype
        assert view.table.device == index.device
        assert index._device_view() is view
        index.add(vectors[30:], psg_ids=psg_ids[30:])
        assert index._device_view() is not view


def test_host_gather_scores_on_the_index_device(tmp_path):
    """Without ``hbm_cache`` there is no device table: ``_gather_view``
    uploads the IDs' decoded rows as a dense fp32 view on the index's
    device, the fused and array-path serves step aside, and re-rank, serve
    and early stopping equal an ``InMemoryIndex`` of the same rows."""
    vectors, doc_ids, psg_ids, queries, doc_run, psg_run, qvecs = _rows()
    encoder = LambdaEncoder(qvecs.__getitem__)
    disk = _disk(tmp_path / "gather.h5", encoder, init_size=64, chunk_size=64)
    memory = InMemoryIndex(encoder, device="cpu")
    for index in (disk, memory):
        index.add(vectors, doc_ids=doc_ids, psg_ids=psg_ids)
    assert disk._device_view() is None

    disk.mode = Mode.MAXP
    ids = list(doc_run["q0"])
    view, rows, counts = disk._gather_view(ids)
    assert view.kind == "dense" and view.table.device == disk.device
    assert view.table.dtype == torch.float32 and view.table.shape[0] == counts.sum()
    want_vecs, _ = disk._get_vectors(ids)
    np.testing.assert_array_equal(view.table.numpy()[rows], want_vecs)

    for mode, run in (("PASSAGE", psg_run), ("MAXP", doc_run), ("AVEP", doc_run)):
        disk.mode = memory.mode = Mode[mode]
        ranking = Ranking.from_run(run, queries=queries)
        _assert_rankings_close(disk(ranking), memory(ranking))
        _assert_rankings_close(disk(ranking), disk(ranking))  # no plan is kept
        assert disk._serve_prep(ranking) is None
        plan = disk._get_plan(ranking)
        cands = disk._candidates(ranking, plan)
        assert disk._serve_fused(cands, None, plan, 0.5, 3, None, np.float32) is None
        _assert_rankings_close(disk.serve(ranking, 0.5, 3), memory.serve(ranking, 0.5, 3))
        es = {"early_stopping": 3, "early_stopping_alpha": 0.5, "early_stopping_depths": (5, 20)}
        _assert_rankings_close(disk(ranking, **es), memory(ranking, **es))
    assert disk.preload(warm=(4, 10)) is False


def test_unported_options_and_no_card(tmp_path):
    """``mesh_config``, ``hbm_budget`` and ``stream_chunk_rows`` (ported
    since) build the views they name over the file's table: a hybrid view,
    for a new index and a loaded one, and a table sharded over two CPU
    slots; their scores equal the whole table's.  A mesh of more cards than
    exist raises ``ValueError``."""
    with pytest.raises(ValueError):
        MeshConfig(data=16, shard=16).build()
    rng = np.random.default_rng(11)
    vectors = rng.standard_normal((6000, 128), dtype=np.float32)
    q = rng.standard_normal(128, dtype=np.float32)
    encoder = LambdaEncoder(lambda _t: q)
    hybrid_kw = {"hbm_cache": True, "hbm_budget": 1 << 20, "stream_chunk_rows": 1024}
    new = _disk(tmp_path / "b.h5", encoder, mode=Mode.PASSAGE, **hybrid_kw)
    new.add(vectors, psg_ids=[f"p{i}" for i in range(6000)])
    loaded = _load(tmp_path / "b.h5", query_encoder=encoder, mode=Mode.PASSAGE, **hybrid_kw)
    plain = _load(tmp_path / "b.h5", query_encoder=encoder, mode=Mode.PASSAGE, hbm_cache=True)
    ranking = Ranking.from_run({"q0": {f"p{i}": float(i) for i in range(0, 6000, 3)}}, queries={"q0": "x"})
    want = plain(ranking)
    for index in (new, loaded):
        view = index._device_view()
        assert view.kind == "hybrid" and view.tail_start == 1024 and view.chunk_rows == 1024
        assert index(ranking) == want
    sharded = _load(
        tmp_path / "b.h5", query_encoder=encoder, mode=Mode.PASSAGE, hbm_cache=True,
        mesh_config=MeshConfig(data=1, shard=2),
    )
    assert sharded._device_view().mesh is not None
    got = sharded(ranking)
    assert list(got["q0"]) == list(want["q0"])
    np.testing.assert_allclose(list(got["q0"].values()), list(want["q0"].values()), rtol=1e-6)
    with pytest.raises(ValueError, match="exists"):
        _disk(tmp_path / "c.h5")
        _disk(tmp_path / "c.h5")
    if not torch.cuda.is_available():
        # no fallback: the card is the default device
        with pytest.raises(RuntimeError, match="device='cpu'"):
            OnDiskIndex(tmp_path / "d.h5", hbm_cache=True)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            OnDiskIndex.load(tmp_path / "c.h5")


def test_without_h5py_the_index_writes_loads_and_ranks(tmp_path):
    """A fresh interpreter with h5py blocked writes an ``OnDiskIndex`` (adds
    in three steps across chunk growth), loads it, copies it to memory,
    reads rows through the chunk memory maps and re-ranks, on the CPU; h5py
    and the JAX package's ``OnDiskIndex.load`` then open the same file:
    equal rows and ids, and the same ranking."""
    vectors, doc_ids, psg_ids, queries, doc_run, _, qvecs = _rows()
    data = tmp_path / "rows.npz"
    np.savez(data, vectors=vectors, qvecs=np.stack(list(qvecs.values())))
    (tmp_path / "ids.json").write_text(json.dumps(
        {"doc_ids": doc_ids, "psg_ids": psg_ids, "queries": queries, "run": doc_run,
         "texts": list(qvecs)}))
    path, out_path = tmp_path / "index.h5", tmp_path / "ranking.json"
    code = f"""
import json, sys
sys.modules["h5py"] = None
import numpy as np
from fastforward_tpu_torch.encoder import LambdaEncoder
from fastforward_tpu_torch.index import Mode, OnDiskIndex
from fastforward_tpu_torch.ranking import Ranking
arrays = np.load({str(data)!r})
meta = json.loads(open({str(tmp_path / "ids.json")!r}).read())
vectors, doc_ids, psg_ids = arrays["vectors"], meta["doc_ids"], meta["psg_ids"]
qvecs = dict(zip(meta["texts"], arrays["qvecs"]))
index = OnDiskIndex({str(path)!r}, init_size=64, chunk_size=64, device="cpu")
for lo, hi in ((0, 50), (50, 130), (130, len(vectors))):
    index.add(vectors[lo:hi], doc_ids=doc_ids[lo:hi], psg_ids=psg_ids[lo:hi])
loaded = OnDiskIndex.load({str(path)!r}, LambdaEncoder(qvecs.__getitem__), mode=Mode.MAXP,
                          device="cpu")
mapped = OnDiskIndex.load({str(path)!r}, mode=Mode.PASSAGE, memory_mapped=True, device="cpu")
assert len(loaded) == len(vectors) and loaded.doc_ids == set(doc_ids)
rows = np.random.default_rng(0).permutation(len(vectors))[:64]
got, ids = mapped._get_vectors([psg_ids[r] for r in rows])
assert np.array_equal(got, vectors[rows]) and ids == [psg_ids[r] for r in rows]
memory = loaded.to_memory(batch_size=100)
assert np.array_equal(np.concatenate([v for v, _, _ in memory._batch_iter(1000)]), vectors)
ranking = Ranking.from_run(meta["run"], queries=meta["queries"])
result = loaded(ranking)
assert result == memory(ranking)
out = [[str(q), str(i), float(s)] for q, i, s in result._df[["q_id", "id", "score"]].itertuples(index=False)]
open({str(out_path)!r}, "w").write(json.dumps(out))
print("h5py imported" if sys.modules.get("h5py") is not None else "ok")
"""
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok"), out.stdout

    import h5py

    with h5py.File(path, "r") as fp:
        assert int(fp.attrs["num_vectors"]) == N_ROWS
        np.testing.assert_array_equal(fp["vectors"][:N_ROWS], vectors)
        assert fp["doc_ids"].asstr()[:N_ROWS].tolist() == doc_ids
        assert fp["psg_ids"].asstr()[:N_ROWS].tolist() == psg_ids
    jax_index = JaxOnDiskIndex.load(path, JaxLambdaEncoder(qvecs.__getitem__), mode=JaxMode.MAXP)
    want = jax_index(JaxRanking.from_run(doc_run, queries=queries))
    got = Ranking(pd.DataFrame(json.loads(out_path.read_text()), columns=["q_id", "id", "score"]))
    _assert_rankings_close(got, want)
