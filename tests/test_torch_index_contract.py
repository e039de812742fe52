"""The ``TestIndex`` host-read contract of ``tests/test_index.py`` against
the port's ``InMemoryIndex`` on the CPU.

The case bodies of ``test_properties``, ``test_add_retrieve``,
``test_coalescing``, ``test_iter``, ``test_quantization`` and
``TestInMemoryIndex.test_consolidate`` are copied with the same dummy data,
and run with the port's ``Mode``, ``LambdaEncoder``, ``NanoPQ(2, 8)`` and
``create_coalesced_index``.

Beside them, two cases hold the port against ``fastforward_tpu`` itself:
``_get_vectors`` and ``batch_iter`` return the JAX index's vectors and IDs,
in the same order, for the same adds (plain and quantized), and
``convert.index_from_triples(iter(index))`` rebuilds a port index row for
row.
"""

import itertools
import unittest
from collections import defaultdict

import numpy as np
import pytest

from fastforward_tpu.index import InMemoryIndex as JaxInMemoryIndex
from fastforward_tpu.index import Mode as JaxMode
from fastforward_tpu.quantizer import NanoPQ as JaxNanoPQ
from fastforward_tpu_torch import convert
from fastforward_tpu_torch.encoder import LambdaEncoder
from fastforward_tpu_torch.index import InMemoryIndex, Mode
from fastforward_tpu_torch.parallel import MeshConfig
from fastforward_tpu_torch.quantizer import NanoPQ
from fastforward_tpu_torch.utils import create_coalesced_index

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
DUMMY_ENCODER = LambdaEncoder(lambda _: np.array([1, 1, 1, 1, 1]))

DUMMY_QUANTIZER = NanoPQ(2, 8, device="cpu")
DUMMY_QUANTIZER.fit(np.random.default_rng(0).normal(size=(16, 16)).astype(np.float32))


def _index(*args, **kwargs) -> InMemoryIndex:
    return InMemoryIndex(*args, device="cpu", **kwargs)


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


class TestTorchInMemoryIndex(unittest.TestCase):
    """``tests/test_index.py``'s ``TestIndex`` host-read cases and
    ``TestInMemoryIndex.test_consolidate``, on the port."""

    #: the index factory of the cases (the device store's class overrides it)
    _new = staticmethod(_index)

    @classmethod
    def setUpClass(cls):
        cls.index = cls._new(init_size=32, alloc_size=32)
        cls.doc_psg_index = cls._new(DUMMY_ENCODER)
        cls.index_partial_ids = cls._new(DUMMY_ENCODER)
        cls.doc_index = cls._new(DUMMY_ENCODER)
        cls.psg_index = cls._new(DUMMY_ENCODER)
        cls.iter_indexes = [cls._new(init_size=2, alloc_size=2), cls._new(init_size=5)]
        cls.quantized_index = cls._new(quantizer=DUMMY_QUANTIZER)
        cls.coalesced_indexes = [cls._new(mode=Mode.MAXP), cls._new(mode=Mode.MAXP)]

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

    def test_consolidate(self):
        index = self._new(init_size=8, alloc_size=4, mode=Mode.PASSAGE)
        data = np.random.default_rng(3).normal(size=(32, 16))
        psg_ids = [f"psg_{i}" for i in range(32)]

        index.add(data[:14], psg_ids=psg_ids[:14])
        index.consolidate()
        vecs, ids = index._get_vectors(psg_ids[:14])
        _assert_vectors_match(vecs, ids, data[:14], psg_ids[:14])

        index.add(data[14:32], psg_ids=psg_ids[14:32])
        index.consolidate()
        vecs, ids = index._get_vectors(psg_ids)
        _assert_vectors_match(vecs, ids, data, psg_ids)


class TestTorchInMemoryIndexDeviceStore(TestTorchInMemoryIndex):
    """The same contract with ``store="device"`` (``tests/test_index.py``'s
    ``TestInMemoryIndexDeviceStore``): adds append straight into the
    growable device buffer (a CPU tensor here) and host reads fetch rows
    back from it; ``consolidate`` leaves the buffer as it is."""

    @staticmethod
    def _new(*args, **kwargs) -> InMemoryIndex:
        return _index(*args, store="device", **kwargs)

    def test_growth_across_row_pad(self):
        """Appends crossing the buffer's growth boundary stay intact."""
        index = self._new(init_size=8, alloc_size=4, mode=Mode.PASSAGE)
        data = np.random.default_rng(4).normal(size=(48, 16)).astype(np.float32)
        psg_ids = [f"psg_{i}" for i in range(48)]
        index.add(data[:20], psg_ids=psg_ids[:20])
        index.add(data[20:], psg_ids=psg_ids[20:])
        vecs, ids = index._get_vectors(psg_ids)
        _assert_vectors_match(vecs, ids, data, psg_ids)
        assert index._store is None and index._dev_table.shape[0] % 4096 == 0

    def test_device_store_option_validation(self):
        """``hbm_budget`` with the device store raises; a mesh is taken (the
        buffer is row-sharded over two CPU slots and its rows read back),
        and a mesh of more cards than exist raises ``ValueError``."""
        with self.assertRaises(ValueError):
            self._new(hbm_budget=1 << 20)
        index = self._new(mesh_config=MeshConfig(data=1, shard=2), mode=Mode.PASSAGE)
        data = np.random.default_rng(6).normal(size=(40, 128)).astype(np.float32)
        psg_ids = [f"psg_{i}" for i in range(40)]
        index.add(data[:20], psg_ids=psg_ids[:20])
        index.add(data[20:], psg_ids=psg_ids[20:])
        vecs, ids = index._get_vectors(psg_ids)
        _assert_vectors_match(vecs, ids, data, psg_ids)
        assert index._store is None and index._device_view().mesh is not None
        with self.assertRaises(ValueError):
            MeshConfig(data=16, shard=16).build()

    def test_bad_store_rejected(self):
        with self.assertRaises(ValueError):
            _index(store="hbm")


#: rows of the differential cases: 2-4 passages a document, a few rows with
#: no passage ID, adds of uneven sizes across the stores' growth steps
N_ROWS, DIM = 60, 16


def _rows():
    rng = np.random.default_rng(7)
    vectors = rng.standard_normal((N_ROWS, DIM), dtype=np.float32)
    per_doc = rng.integers(2, 5, size=N_ROWS)
    doc_ids = [f"d{i}" for i, n in enumerate(per_doc) for _ in range(n)][:N_ROWS]
    psg_ids = [None if i % 11 == 3 else f"p{i}" for i in range(N_ROWS)]
    return vectors, doc_ids, psg_ids


def _pair(quantized: bool):
    """A JAX and a port ``InMemoryIndex`` given the same adds; the quantized
    pair holds one PQ state (the port's quantizer rebuilt from the JAX
    one's ``serialize()`` triple)."""
    vectors, doc_ids, psg_ids = _rows()
    if quantized:
        jq = JaxNanoPQ(4, 8)
        jq.fit(vectors)
        jax_index = JaxInMemoryIndex(quantizer=jq, init_size=8, alloc_size=8)
        port_index = _index(
            quantizer=convert.quantizer_from_state(*jq.serialize(), device="cpu"),
            init_size=8,
            alloc_size=8,
        )
    else:
        jax_index = JaxInMemoryIndex(init_size=8, alloc_size=8)
        port_index = _index(init_size=8, alloc_size=8)
    for lo, hi in ((0, 5), (5, 29), (29, N_ROWS)):
        for index in (jax_index, port_index):
            index.add(vectors[lo:hi], doc_ids=doc_ids[lo:hi], psg_ids=psg_ids[lo:hi])
    return jax_index, port_index, doc_ids, psg_ids


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "pq"])
def test_host_reads_match_jax(quantized):
    """``_get_vectors`` in every mode and ``batch_iter`` at several batch
    sizes return what ``fastforward_tpu``'s index returns: equal vectors
    (codes, when quantized; decoded vectors from ``batch_iter``) and IDs in
    the same order; so do ``__iter__`` and ``consolidate``."""
    jax_index, port_index, doc_ids, psg_ids = _pair(quantized)
    docs = list(dict.fromkeys(doc_ids))[::-1]
    psgs = [p for p in psg_ids if p is not None][::2]
    for mode, ids in (("PASSAGE", psgs), ("MAXP", docs), ("FIRSTP", docs), ("AVEP", docs)):
        jax_index.mode, port_index.mode = JaxMode[mode], Mode[mode]
        want_vecs, want_ids = jax_index._get_vectors(ids)
        got_vecs, got_ids = port_index._get_vectors(ids)
        assert got_ids == want_ids, mode
        np.testing.assert_array_equal(got_vecs, want_vecs, err_msg=mode)
    for batch_size in (1, 7, 2**9):
        want = list(jax_index.batch_iter(batch_size))
        got = list(port_index.batch_iter(batch_size))
        assert len(got) == len(want)
        for (gv, gd, gp), (wv, wd, wp) in zip(got, want):
            assert list(gd) == list(wd) and list(gp) == list(wp)
            np.testing.assert_allclose(gv, wv, rtol=1e-6, atol=1e-6)
    for (gv, gd, gp), (wv, wd, wp) in zip(port_index, jax_index, strict=True):
        assert (gd, gp) == (wd, wp)
        np.testing.assert_allclose(gv, wv, rtol=1e-6, atol=1e-6)
    for index in (jax_index, port_index):
        index.consolidate()
    assert port_index._store.shape[0] == N_ROWS
    port_index.mode, jax_index.mode = Mode.MAXP, JaxMode.MAXP
    np.testing.assert_array_equal(port_index._get_vectors(docs)[0], jax_index._get_vectors(docs)[0])


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "pq"])
def test_device_store_reads_match_jax(quantized):
    """``store="device"`` in both packages, the same adds: the port's host
    reads equal the JAX device store's (vectors as fp32 of the device
    buffer, codes as stored), and its own host store's bit for bit."""
    vectors, doc_ids, psg_ids = _rows()
    indexes = {}
    for name, cls, kw in (
        ("jax", JaxInMemoryIndex, {}), ("port", InMemoryIndex, {"device": "cpu"}),
        ("host", InMemoryIndex, {"device": "cpu", "store": "host"}),
    ):
        kw = {"store": "device", **kw}
        if quantized:
            jq = JaxNanoPQ(4, 8)
            jq.fit(vectors)
            kw["quantizer"] = jq if name == "jax" else convert.quantizer_from_state(*jq.serialize(), device="cpu")
        indexes[name] = cls(init_size=8, alloc_size=8, **kw)
        for lo, hi in ((0, 5), (5, 29), (29, N_ROWS)):
            indexes[name].add(vectors[lo:hi], doc_ids=doc_ids[lo:hi], psg_ids=psg_ids[lo:hi])
    jax_index, port_index, host_index = indexes["jax"], indexes["port"], indexes["host"]
    assert port_index._store is None
    docs = list(dict.fromkeys(doc_ids))[::-1]
    psgs = [p for p in psg_ids if p is not None][::2]
    for mode, ids in (("PASSAGE", psgs), ("MAXP", docs), ("FIRSTP", docs)):
        jax_index.mode, port_index.mode, host_index.mode = JaxMode[mode], Mode[mode], Mode[mode]
        want_vecs, want_ids = jax_index._get_vectors(ids)
        got_vecs, got_ids = port_index._get_vectors(ids)
        assert got_ids == want_ids, mode
        np.testing.assert_array_equal(got_vecs, want_vecs, err_msg=mode)
        np.testing.assert_array_equal(got_vecs, host_index._get_vectors(ids)[0], err_msg=mode)
    for (gv, gd, gp), (wv, wd, wp) in zip(port_index, jax_index, strict=True):
        assert (gd, gp) == (wd, wp)
        np.testing.assert_allclose(gv, wv, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "pq"])
def test_triples_round_trip(quantized):
    """``convert.index_from_triples(iter(index))`` rebuilds a port index row
    for row: the same IDs in the same order and the same (decoded)
    vectors."""
    _, index, _, _ = _pair(quantized)
    rebuilt = convert.index_from_triples(iter(index), Mode.MAXP, device="cpu")
    assert len(rebuilt) == len(index)
    assert rebuilt.doc_ids == index.doc_ids and rebuilt.psg_ids == index.psg_ids
    for (gv, gd, gp), (wv, wd, wp) in zip(rebuilt, index, strict=True):
        assert (gd, gp) == (wd, wp)
        np.testing.assert_array_equal(gv, wv)
