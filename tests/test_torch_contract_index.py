"""The scoring cases of ``tests/test_index.py``'s ``TestIndex`` on the
port's ``InMemoryIndex`` (host store and ``store="device"``), and
``TestChunkIndexer``.

Copied with the same dummy data, assertions and tolerances:
``test_queries_attached``, ``test_maxp``, ``test_firstp``, ``test_avep``,
``test_passage``, ``test_errors``, ``test_early_stopping``,
``test_batch_size_invariance`` and ``test_quantized_scoring_matches_decode``
on the host store (``TestInMemoryIndex``, ``tests/test_index.py:389``) and
on the device store (``TestInMemoryIndexDeviceStore``, ``:431``), and all 7
cases of ``TestChunkIndexer`` (``:713``; host code, so not on the card).

Not copied a second time: the host-read cases ``test_properties``,
``test_add_retrieve``, ``test_coalescing``, ``test_iter``,
``test_quantization`` and ``test_consolidate``, and the device store's
``test_growth_across_row_pad``, ``test_device_store_option_validation`` and
``test_bad_store_rejected``, run in ``tests/test_torch_index_contract.py``;
``TestOnDiskIndex`` with every ``TestIndex`` case runs in
``tests/test_torch_disk_index.py``.  Each index class runs on
``device="cpu"``; its ``...Cuda`` subclass (marker ``gpu``) runs the same
cases on the card and skips without one.  The file imports neither JAX
nor ``fastforward_tpu``.
"""

import unittest
from collections import defaultdict

import numpy as np
import pandas as pd
import pytest
import torch

from fastforward_tpu_torch.encoder import LambdaEncoder
from fastforward_tpu_torch.index import InMemoryIndex, Mode
from fastforward_tpu_torch.quantizer import NanoPQ
from fastforward_tpu_torch.ranking import Ranking

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

#: fitted on the CPU; an index on the card uploads its codebooks
DUMMY_QUANTIZER = NanoPQ(2, 8, device="cpu")
DUMMY_QUANTIZER.fit(
    np.random.default_rng(0).normal(size=(16, 16)).astype(np.float32)
)


class TestIndex(unittest.TestCase):
    """``TestIndex``'s scoring cases over the indexes
    ``TestInMemoryIndex.setUpClass`` builds, on the class's device and
    store."""

    __test__ = False
    device = "cpu"
    store = "host"

    @classmethod
    def _new(cls, *args, **kwargs) -> InMemoryIndex:
        return InMemoryIndex(*args, device=cls.device, store=cls.store, **kwargs)

    @classmethod
    def setUpClass(cls):
        if cls.device == "cuda" and not torch.cuda.is_available():
            raise unittest.SkipTest("needs an NVIDIA GPU")
        cls.doc_psg_index = cls._new(DUMMY_ENCODER)
        cls.index_partial_ids = cls._new(DUMMY_ENCODER)
        cls.index_no_enc = cls._new(query_encoder=None)
        cls.index_wrong_dim = cls._new(query_encoder=None)
        cls.early_stopping_index = cls._new(
            LambdaEncoder(lambda q: np.array([10, 10])), mode=Mode.PASSAGE
        )
        cls.quantized_index = cls._new(quantizer=DUMMY_QUANTIZER)

        cls.doc_psg_index.add(
            vectors=DUMMY_VECTORS, doc_ids=DUMMY_DOC_IDS, psg_ids=DUMMY_PSG_IDS
        )

        # mixed: doc-only, psg-only, and both IDs per vector
        cls.index_partial_ids.add(
            vectors=DUMMY_VECTORS,
            doc_ids=[None, None] + DUMMY_DOC_IDS[2:],
            psg_ids=DUMMY_PSG_IDS[:-2] + [None, None],
        )
        cls.index_partial_ids.add(vectors=DUMMY_VECTORS[:2], doc_ids=DUMMY_DOC_IDS[:2])
        cls.index_partial_ids.add(
            vectors=DUMMY_VECTORS[-2:], psg_ids=DUMMY_PSG_IDS[-2:]
        )

        cls.quantized_index.add(
            vectors=np.random.default_rng(1)
            .normal(size=(5, DUMMY_QUANTIZER.dims[0]))
            .astype(np.float32),
            doc_ids=DUMMY_DOC_IDS,
        )

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
            self.index_no_enc.add(
                DUMMY_VECTORS, doc_ids=DUMMY_DOC_IDS[:-2], psg_ids=None
            )
        with self.assertRaises(ValueError):
            self.index_no_enc.add(
                DUMMY_VECTORS, doc_ids=None, psg_ids=DUMMY_PSG_IDS[:-2]
            )

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
            self.index_wrong_dim.add(
                np.array([[0, 0, 0], [1, 1, 1]]), doc_ids=["d3", "d4"]
            )

        # ranking without queries
        with self.assertRaises(ValueError):
            self.doc_psg_index(Ranking.from_run(DUMMY_DOC_RUN))

        # early stopping without its parameters
        with self.assertRaises(ValueError):
            self.doc_psg_index(
                DUMMY_DOC_RANKING, early_stopping=10, early_stopping_alpha=None
            )
        with self.assertRaises(ValueError):
            self.doc_psg_index(
                DUMMY_DOC_RANKING, early_stopping=10, early_stopping_depths=None
            )

        # quantizer on a non-empty index
        with self.assertRaises(RuntimeError):
            self.doc_psg_index.quantizer = DUMMY_QUANTIZER

        # ID missing from the index
        ranking_missing = Ranking.from_run(
            {"q1": {"d0": 100, "dx": 2}}, queries=DUMMY_QUERIES
        )
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


    def test_quantized_scoring_matches_decode(self):
        """ADC in-kernel scoring == decode-then-dot within fp32 tolerance."""
        self.quantized_index.mode = Mode.MAXP
        self.quantized_index.query_encoder = LambdaEncoder(
            lambda _: np.ones(16, dtype=np.float32)
        )
        ranking = Ranking.from_run(
            {"q1": {d: 1.0 for d in UNIQUE_DUMMY_DOC_IDS}},
            queries={"q1": "query 1"},
        )
        result = self.quantized_index(ranking)

        # manual: decode codes on host, dot with the (constant) query vector
        qvec = np.ones(16, dtype=np.float32)
        codes, ids = self.quantized_index._get_vectors(UNIQUE_DUMMY_DOC_IDS)
        decoded = DUMMY_QUANTIZER.decode(codes)
        expected = defaultdict(lambda: -np.inf)
        for vec, i in zip(decoded, ids):
            expected[i] = max(expected[i], float(np.dot(qvec, vec)))
        got = result["q1"]
        for i in UNIQUE_DUMMY_DOC_IDS:
            self.assertAlmostEqual(expected[i], got[i], places=4)


class TestInMemoryIndex(TestIndex):
    __test__ = True


class TestInMemoryIndexDeviceStore(TestIndex):
    """The same contract against the device-resident store."""

    __test__ = True
    store = "device"


@pytest.mark.gpu
class TestInMemoryIndexCuda(TestIndex):
    __test__ = True
    device = "cuda"


@pytest.mark.gpu
class TestInMemoryIndexDeviceStoreCuda(TestIndex):
    __test__ = True
    device = "cuda"
    store = "device"


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


class TestChunkIndexer(unittest.TestCase):
    """Contract of the chunked-vector retrieval utility.

    Mirrors the reference's ``index.util.ChunkIndexer`` semantics
    (reference: ``index/util.py:45-113``): resolve IDs per mode, fetch
    rows out of a list of chunks whose first chunk may be larger, return
    consistently paired (vectors, ids).
    """

    def setUp(self):
        from fastforward_tpu_torch.index.util import ChunkIndexer

        rng = np.random.default_rng(7)
        self.table = rng.normal(size=(11, 4)).astype(np.float32)
        # first chunk larger than the rest (5 + 3 + 3)
        self.chunks = [self.table[:5], self.table[5:8], self.table[8:]]
        self.doc_id_to_idx = {
            "d0": [0, 1, 6],
            "d1": [2],
            "d2": [5, 9, 10],
            "d3": [4],
        }
        self.psg_id_to_idx = {f"p{i}": i for i in range(11)}
        self.indexer = ChunkIndexer(
            self.chunks, self.doc_id_to_idx, self.psg_id_to_idx
        )

    def test_get_chunk_indices(self):
        for global_row in range(11):
            c, w = self.indexer._get_chunk_indices(global_row)
            np.testing.assert_array_equal(
                self.chunks[c][w], self.table[global_row]
            )

    def test_passage_mode(self):
        vecs, ids = self.indexer(["p3", "p8", "p5"], Mode.PASSAGE)
        _assert_vectors_match(
            vecs, ids, self.table[[3, 8, 5]], ["p3", "p8", "p5"]
        )

    def test_doc_modes(self):
        for mode in (Mode.MAXP, Mode.AVEP):
            vecs, ids = self.indexer(["d2", "d0"], mode)
            _assert_vectors_match(
                vecs,
                ids,
                self.table[[5, 9, 10, 0, 1, 6]],
                ["d2", "d2", "d2", "d0", "d0", "d0"],
            )

    def test_firstp_mode(self):
        vecs, ids = self.indexer(["d2", "d0", "d3"], Mode.FIRSTP)
        _assert_vectors_match(
            vecs, ids, self.table[[5, 0, 4]], ["d2", "d0", "d3"]
        )

    def test_single_chunk(self):
        from fastforward_tpu_torch.index.util import ChunkIndexer

        one = ChunkIndexer(
            [self.table], self.doc_id_to_idx, self.psg_id_to_idx
        )
        vecs, ids = one(["p10", "p0"], Mode.PASSAGE)
        _assert_vectors_match(vecs, ids, self.table[[10, 0]], ["p10", "p0"])

    def test_unknown_id_raises(self):
        with self.assertRaises(IndexError):
            self.indexer(["nope"], Mode.PASSAGE)

    def test_pairing_is_consistent(self):
        # every returned vector must equal the table row its ID resolves to
        vecs, ids = self.indexer(["p7", "p1", "p0", "p9"], Mode.PASSAGE)
        for v, i in zip(vecs, ids):
            np.testing.assert_array_equal(v, self.table[int(i[1:])])
