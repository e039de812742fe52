"""``tests/test_scoring_paths.py`` on the port: the grouped, flat, host,
streamed and quantized scoring paths against ground truth and each other.

Copied with the same data, assertions and tolerances: ``TestRaggedDocs``
(5), ``TestMissingIdPassageMode`` (1), ``TestStreamedPath`` (1),
``TestStreamedKReduction`` (4), ``TestBf16Table`` (1),
``TestFlatVsGroupedParity`` (1), ``TestStreamedPQ`` (3),
``TestDiskHbmCacheQuantized`` (1; the port's own HDF5 codec, so it runs
on the card too) and ``TestPrecisionTiers``'
``test_index_precision_reaches_device_view`` and
``test_sharded_views_carry_precision`` (the latter as
``TestShardedPrecision``: its 8-shard mesh runs on 8 CPU slots only).

Left out: ``TestPrecisionTiers::test_gather_programs_accept_precision``
(it calls the ops with ``jnp`` arrays; the port's gather programs take
each tier in ``tests/test_torch_doc_modes.py::
test_score_pairs_grouped_matches_jax``), and ``TestPreloadWarm``, whose
cases run in ``tests/test_torch_preload.py::TestPreloadWarm`` but for
``test_preload_enables_persistent_compile_cache`` (``_ensure_compile_cache``:
the port compiles nothing at call time).  Each class runs on
``device="cpu"``; its ``...Cuda`` subclass (marker ``gpu``) runs the same
cases on the card and skips without one.  The file imports neither JAX
nor ``fastforward_tpu``.
"""

import unittest

import numpy as np
import pytest
import torch

from fastforward_tpu_torch.encoder import LambdaEncoder
from fastforward_tpu_torch.index import InMemoryIndex, Mode
from fastforward_tpu_torch.quantizer import PQ, ScalarQuantizer
from fastforward_tpu_torch.ranking import Ranking


def _needs_card(cls):
    if not torch.cuda.is_available():
        raise unittest.SkipTest("needs an NVIDIA GPU")

RNG = np.random.default_rng(31)
DIM = 32


def _index_with(doc_sizes, mode, quantizer=None, device="cpu"):
    """Index where doc i has doc_sizes[i] passages; returns ground truth."""
    qvec = RNG.normal(size=DIM).astype(np.float32)
    vectors = []
    doc_ids = []
    for d, size in enumerate(doc_sizes):
        for _ in range(size):
            vectors.append(RNG.normal(size=DIM).astype(np.float32))
            doc_ids.append(f"d{d}")
    vectors = np.stack(vectors)
    index = InMemoryIndex(
        LambdaEncoder(lambda _: qvec), mode=mode, quantizer=quantizer, device=device
    )
    index.add(vectors, doc_ids=doc_ids)
    if quantizer is not None:
        vectors = quantizer.decode(quantizer.encode(vectors))
    per_row = vectors @ qvec
    truth = {}
    pos = 0
    for d, size in enumerate(doc_sizes):
        rows = per_row[pos : pos + size]
        pos += size
        if mode == Mode.MAXP:
            truth[f"d{d}"] = float(rows.max())
        elif mode == Mode.AVEP:
            truth[f"d{d}"] = float(rows.mean())
        else:
            truth[f"d{d}"] = float(rows[0])
    return index, truth


class TestRaggedDocs(unittest.TestCase):
    device = "cpu"

    def _check(self, doc_sizes, mode, places=3, quantizer=None):
        index, truth = _index_with(doc_sizes, mode, quantizer, device=self.device)
        run = {"q1": {d: 1.0 for d in truth}}
        result = index(Ranking.from_run(run, queries={"q1": "x"}))["q1"]
        for doc, expected in truth.items():
            self.assertAlmostEqual(expected, result[doc], places=places, msg=doc)

    def test_grouped_path_ragged(self):
        """Varying passage counts within the grouped-K limit."""
        for mode in (Mode.MAXP, Mode.AVEP, Mode.FIRSTP):
            self._check([1, 3, 7, 2, 5, 1, 8], mode)

    def test_flat_fallback_large_doc(self):
        """A >64-passage document forces the segment fallback path."""
        for mode in (Mode.MAXP, Mode.AVEP, Mode.FIRSTP):
            self._check([2, 100, 5], mode)

    def test_grouped_pq_ragged(self):
        quantizer = PQ(4, 16, device=self.device)
        quantizer.fit(RNG.normal(size=(64, DIM)).astype(np.float32))
        for mode in (Mode.MAXP, Mode.AVEP):
            self._check([1, 3, 6, 2], mode, places=3, quantizer=quantizer)

    def test_scalar_quantizer_scoring(self):
        quantizer = ScalarQuantizer()
        quantizer.fit(RNG.normal(size=(64, DIM)).astype(np.float32))
        self._check([2, 4, 1], Mode.MAXP, places=2, quantizer=quantizer)

    def test_scalar_quantizer_3d_streamed(self):
        """128-dim int8 codes use the 3D layout and the streamed path."""
        dim = 128
        quantizer = ScalarQuantizer()
        data = RNG.normal(size=(64, dim)).astype(np.float32)
        quantizer.fit(data)
        qvec = RNG.normal(size=dim).astype(np.float32)
        index = InMemoryIndex(
            LambdaEncoder(lambda _: qvec), mode=Mode.PASSAGE, quantizer=quantizer,
            device=self.device,
        )
        index.add(data, psg_ids=[f"p{i}" for i in range(64)])
        decoded = quantizer.decode(quantizer.encode(data))
        run = {"q1": {f"p{i}": 1.0 for i in range(64)}}
        got = index(Ranking.from_run(run, queries={"q1": "x"}))["q1"]
        self.assertEqual(3, index._device_view().table.ndim)
        for i in range(64):
            self.assertAlmostEqual(
                float(decoded[i] @ qvec), got[f"p{i}"], places=2
            )


class TestMissingIdPassageMode(unittest.TestCase):
    device = "cpu"

    def test_missing_passage_id_raises(self):
        index = InMemoryIndex(
            LambdaEncoder(lambda _: np.ones(DIM, np.float32)), mode=Mode.PASSAGE,
            device=self.device,
        )
        index.add(
            RNG.normal(size=(4, DIM)).astype(np.float32),
            psg_ids=[f"p{i}" for i in range(4)],
        )
        ranking = Ranking.from_run(
            {"q1": {"p0": 1.0, "missing": 2.0}}, queries={"q1": "x"}
        )
        with self.assertRaises(IndexError):
            index(ranking)


class TestStreamedPath(unittest.TestCase):
    device = "cpu"

    def test_streamed_matches_gather(self):
        """Dense candidate sets route through the streaming matmul-select
        kernel and must match the gather path exactly enough."""
        n, dim, n_q, depth = 2000, 128, 8, 800
        qvecs = RNG.normal(size=(n_q, dim)).astype(np.float32)
        by_text = {f"q{i}": qvecs[i] for i in range(n_q)}
        vectors = RNG.normal(size=(n, dim)).astype(np.float32)
        index = InMemoryIndex(
            LambdaEncoder(lambda t: by_text[t]), mode=Mode.PASSAGE,
            device=self.device,
        )
        index.add(vectors, psg_ids=[f"p{i}" for i in range(n)])

        run = {}
        queries = {}
        for qi in range(n_q):
            cand = RNG.choice(n, size=depth, replace=False)
            run[f"q{qi}"] = {f"p{c}": float(i) for i, c in enumerate(cand)}
            queries[f"q{qi}"] = f"q{qi}"
        ranking = Ranking.from_run(run, queries=queries)

        # dense: P=6400 * 500 >> 4096 padded rows -> streamed path
        result = index(ranking)
        for qi in range(n_q):
            got = result[f"q{qi}"]
            for pid in list(got)[:50]:
                expected = float(vectors[int(pid[1:])] @ qvecs[qi])
                self.assertAlmostEqual(expected, got[pid], places=3)


class TestStreamedKReduction(unittest.TestCase):
    device = "cpu"

    def _run_mode(self, mode, quantizer=None, places=3):
        """Dense multi-passage workload: streamed path with K > 1; the
        K-axis ranking reduction runs on device (fetch P floats, not P*K)
        and must match the exact per-doc host aggregation."""
        n_docs, dim, n_q = 500, 128, 4
        doc_sizes = RNG.integers(1, 5, size=n_docs)
        vectors = []
        doc_ids = []
        for d in range(n_docs):
            for _ in range(doc_sizes[d]):
                vectors.append(RNG.normal(size=dim).astype(np.float32))
                doc_ids.append(f"d{d}")
        vectors = np.stack(vectors)
        qvecs = RNG.normal(size=(n_q, dim)).astype(np.float32)
        by_text = {f"q{i}": qvecs[i] for i in range(n_q)}
        index = InMemoryIndex(
            LambdaEncoder(lambda t: by_text[t]), mode=mode, quantizer=quantizer,
            device=self.device,
        )
        index.add(vectors, doc_ids=doc_ids)
        if quantizer is not None:
            vectors = quantizer.decode(quantizer.encode(vectors))

        run = {
            f"q{qi}": {f"d{d}": 1.0 for d in range(n_docs)}
            for qi in range(n_q)
        }
        queries = {f"q{qi}": f"q{qi}" for qi in range(n_q)}
        ranking = Ranking.from_run(run, queries=queries)
        # P*K*500 = 500*4*4*500 >> padded rows -> streamed grouped layout
        result = index(ranking)      # builds the plan
        result = index(ranking)      # exercises the cached device reduce

        starts = np.zeros(n_docs + 1, dtype=np.int64)
        np.cumsum(doc_sizes, out=starts[1:])
        for qi in range(n_q):
            got = result[f"q{qi}"]
            per_row = vectors @ qvecs[qi]
            for d in range(0, n_docs, 37):
                rows = per_row[starts[d] : starts[d + 1]]
                if mode == Mode.MAXP:
                    expected = float(rows.max())
                elif mode == Mode.AVEP:
                    expected = float(rows.mean())
                else:
                    expected = float(rows[0])
                self.assertAlmostEqual(
                    expected, got[f"d{d}"], places=places, msg=(qi, d)
                )

    def test_maxp(self):
        self._run_mode(Mode.MAXP)

    def test_avep(self):
        self._run_mode(Mode.AVEP)

    def test_firstp(self):
        self._run_mode(Mode.FIRSTP)

    def test_maxp_pq(self):
        quantizer = PQ(16, 16, device=self.device)
        quantizer.fit(RNG.normal(size=(512, 128)).astype(np.float32))
        self._run_mode(Mode.MAXP, quantizer=quantizer)


class TestBf16Table(unittest.TestCase):
    device = "cpu"

    def test_bf16_close_to_fp32(self):
        qvec = RNG.normal(size=128).astype(np.float32)
        vectors = RNG.normal(size=(64, 128)).astype(np.float32)
        run = {"q1": {f"p{i}": 1.0 for i in range(64)}}
        queries = {"q1": "x"}
        results = {}
        for dtype in ("float32", "bfloat16"):
            index = InMemoryIndex(
                LambdaEncoder(lambda _: qvec),
                mode=Mode.PASSAGE,
                device_dtype=dtype,
                device=self.device,
            )
            index.add(vectors, psg_ids=[f"p{i}" for i in range(64)])
            results[dtype] = index(Ranking.from_run(run, queries=queries))["q1"]
        for pid, fp32_score in results["float32"].items():
            scale = max(1.0, abs(fp32_score))
            self.assertLess(
                abs(fp32_score - results["bfloat16"][pid]) / scale, 0.05
            )


class TestFlatVsGroupedParity(unittest.TestCase):
    device = "cpu"

    def test_same_scores(self):
        """Force the flat path and compare against grouped on the same data."""
        index, truth = _index_with([1, 3, 7, 2], Mode.MAXP, device=self.device)
        run = {"q1": {d: 1.0 for d in truth}}
        ranking = Ranking.from_run(run, queries={"q1": "x"})
        grouped = index(ranking)["q1"]
        index._MAX_GROUP_K = 0  # force the segment fallback
        flat = index(ranking)["q1"]
        for doc in truth:
            self.assertAlmostEqual(grouped[doc], flat[doc], places=4)

class TestStreamedPQ(unittest.TestCase):
    device = "cpu"

    def test_streamed_pq_matches_decode_dot(self):
        """Dense PQ candidate sets stream the code table; scores must equal
        decode-then-dot like the gather ADC path does."""
        n, dim, n_q, depth = 3000, 128, 4, 1000
        data = RNG.normal(size=(n, dim)).astype(np.float32)
        quantizer = PQ(8, 16, device=self.device)
        quantizer.fit(data[:1024])
        qvecs = RNG.normal(size=(n_q, dim)).astype(np.float32)
        by_text = {f"q{i}": qvecs[i] for i in range(n_q)}
        index = InMemoryIndex(
            LambdaEncoder(lambda t: by_text[t]),
            quantizer=quantizer,
            mode=Mode.PASSAGE,
            device=self.device,
        )
        index.add(data, psg_ids=[f"p{i}" for i in range(n)])
        decoded = quantizer.decode(quantizer.encode(data))

        run, queries = {}, {}
        for qi in range(n_q):
            cand = RNG.choice(n, size=depth, replace=False)
            run[f"q{qi}"] = {f"p{c}": float(i) for i, c in enumerate(cand)}
            queries[f"q{qi}"] = f"q{qi}"
        # P*k*200 = 4000*200 >> 4096 padded rows -> streamed PQ path
        result = index(Ranking.from_run(run, queries=queries))
        for qi in range(n_q):
            got = result[f"q{qi}"]
            for pid in list(got)[:100]:
                expected = float(decoded[int(pid[1:])] @ qvecs[qi])
                self.assertAlmostEqual(expected, got[pid], places=3, msg=pid)

    def test_streamed_pq_fast_tier_close_to_exact(self):
        """precision='fast'/'high' PQ streaming uses bf16 one-hots (half
        the scan's HBM traffic); scores must stay within bf16 rounding of
        the exact decode-then-dot — far below PQ's own quantization error."""
        n, dim, n_q, depth = 3000, 128, 4, 1000
        data = RNG.normal(size=(n, dim)).astype(np.float32)
        quantizer = PQ(8, 16, device=self.device)
        quantizer.fit(data[:1024])
        qvecs = RNG.normal(size=(n_q, dim)).astype(np.float32)
        by_text = {f"q{i}": qvecs[i] for i in range(n_q)}
        decoded = quantizer.decode(quantizer.encode(data))

        run, queries = {}, {}
        for qi in range(n_q):
            cand = RNG.choice(n, size=depth, replace=False)
            run[f"q{qi}"] = {f"p{c}": float(i) for i, c in enumerate(cand)}
            queries[f"q{qi}"] = f"q{qi}"

        for precision in ("high", "fast"):
            index = InMemoryIndex(
                LambdaEncoder(lambda t: by_text[t]),
                quantizer=quantizer,
                mode=Mode.PASSAGE,
                precision=precision,
                device=self.device,
            )
            index.add(data, psg_ids=[f"p{i}" for i in range(n)])
            result = index(Ranking.from_run(run, queries=queries))
            for qi in range(n_q):
                got = result[f"q{qi}"]
                for pid in list(got)[:50]:
                    expected = float(decoded[int(pid[1:])] @ qvecs[qi])
                    self.assertAlmostEqual(
                        expected,
                        got[pid],
                        delta=max(0.05, 0.01 * abs(expected)),
                        msg=(precision, pid),
                    )

    def test_streamed_pq_sparse_uses_gather(self):
        """Sparse candidates stay on the gather ADC path (same scores)."""
        n, dim = 5000, 64
        data = RNG.normal(size=(n, dim)).astype(np.float32)
        quantizer = PQ(4, 16, device=self.device)
        quantizer.fit(data[:512])
        qvec = RNG.normal(size=dim).astype(np.float32)
        index = InMemoryIndex(
            LambdaEncoder(lambda _: qvec), quantizer=quantizer, mode=Mode.PASSAGE,
            device=self.device,
        )
        index.add(data, psg_ids=[f"p{i}" for i in range(n)])
        decoded = quantizer.decode(quantizer.encode(data))
        # 20 pairs * 200 = 4000 < 8192 padded rows -> grouped gather path
        run = {"q1": {f"p{i * 200}": 1.0 for i in range(20)}}
        got = index(Ranking.from_run(run, queries={"q1": "x"}))["q1"]
        for pid in got:
            expected = float(decoded[int(pid[1:])] @ qvec)
            self.assertAlmostEqual(expected, got[pid], places=3, msg=pid)


class TestDiskHbmCacheQuantized(unittest.TestCase):
    device = "cpu"

    def test_pq_and_scalar_hbm_cache(self):
        import shutil
        import tempfile
        from pathlib import Path

        from fastforward_tpu_torch.index import OnDiskIndex

        tmp = Path(tempfile.mkdtemp())
        try:
            dim = 128
            data = RNG.normal(size=(40, dim)).astype(np.float32)
            qvec = RNG.normal(size=dim).astype(np.float32)
            run = {"q1": {f"p{i}": 1.0 for i in range(40)}}
            queries = {"q1": "x"}

            for name, quantizer in [
                ("pq", PQ(8, 16, device=self.device)),
                ("scalar", ScalarQuantizer()),
            ]:
                quantizer.fit(data)
                decoded = quantizer.decode(quantizer.encode(data))
                index = OnDiskIndex(
                    tmp / f"{name}.h5",
                    LambdaEncoder(lambda _: qvec),
                    quantizer=quantizer,
                    mode=Mode.PASSAGE,
                    hbm_cache=True,
                    device=self.device,
                )
                index.add(data, psg_ids=[f"p{i}" for i in range(40)])
                got = index(Ranking.from_run(run, queries=queries))["q1"]
                self.assertIsNotNone(index._device_view())
                for i in range(40):
                    self.assertAlmostEqual(
                        float(decoded[i] @ qvec), got[f"p{i}"], places=2, msg=name
                    )
        finally:
            shutil.rmtree(tmp)



class TestPrecisionTiers(unittest.TestCase):
    """Precision plumbs through every scoring program (ADVICE r1).

    On CPU all tiers compute in fp32, so each tier must agree with "exact";
    the point is exercising the precision-parameterized program variants
    (gather, grouped, bounded, streamed) end-to-end.
    """

    device = "cpu"

    def test_index_precision_reaches_device_view(self):
        """The ctor knob lands on the DeviceView for every table kind."""
        qvec = RNG.normal(size=128).astype(np.float32)
        vectors = RNG.normal(size=(8, 128)).astype(np.float32)

        for precision in ("high", "fast"):
            index = InMemoryIndex(
                LambdaEncoder(lambda _: qvec),
                mode=Mode.PASSAGE,
                precision=precision,
                device=self.device,
            )
            index.add(vectors, psg_ids=[f"p{i}" for i in range(8)])
            self.assertEqual(precision, index._device_view().precision)

        sq = ScalarQuantizer()
        sq.fit(vectors)
        index = InMemoryIndex(
            LambdaEncoder(lambda _: qvec),
            mode=Mode.PASSAGE,
            quantizer=sq,
            precision="high",
            device=self.device,
        )
        index.add(vectors, psg_ids=[f"p{i}" for i in range(8)])
        self.assertEqual("high", index._device_view().precision)


class TestShardedPrecision(unittest.TestCase):
    """``TestPrecisionTiers::test_sharded_views_carry_precision``: a mesh of
    8 shards, on 8 CPU slots (one card cannot hold it)."""

    def test_sharded_views_carry_precision(self):
        from fastforward_tpu_torch.parallel import MeshConfig

        qvec = RNG.normal(size=128).astype(np.float32)
        vectors = RNG.normal(size=(8, 128)).astype(np.float32)
        for quantizer in (None, "scalar"):
            q = None
            if quantizer == "scalar":
                q = ScalarQuantizer()
                q.fit(vectors)
            index = InMemoryIndex(
                LambdaEncoder(lambda _: qvec),
                mode=Mode.PASSAGE,
                quantizer=q,
                mesh_config=MeshConfig(data=1, shard=8),
                precision="high",
                device="cpu",
            )
            index.add(vectors, psg_ids=[f"p{i}" for i in range(8)])
            view = index._device_view()
            self.assertEqual("high", view.precision)
            # and sharded scoring still matches ground truth
            run = {"q1": {f"p{i}": 1.0 for i in range(8)}}
            result = index(Ranking.from_run(run, queries={"q1": "x"}))["q1"]
            dec = vectors if q is None else q.decode(q.encode(vectors))
            truth = dec @ qvec
            for i in range(8):
                self.assertAlmostEqual(float(truth[i]), result[f"p{i}"], places=3)


@pytest.mark.gpu
class TestRaggedDocsCuda(TestRaggedDocs):
    device = "cuda"
    setUpClass = classmethod(_needs_card)


@pytest.mark.gpu
class TestMissingIdPassageModeCuda(TestMissingIdPassageMode):
    device = "cuda"
    setUpClass = classmethod(_needs_card)


@pytest.mark.gpu
class TestStreamedPathCuda(TestStreamedPath):
    device = "cuda"
    setUpClass = classmethod(_needs_card)


@pytest.mark.gpu
class TestStreamedKReductionCuda(TestStreamedKReduction):
    device = "cuda"
    setUpClass = classmethod(_needs_card)


@pytest.mark.gpu
class TestBf16TableCuda(TestBf16Table):
    device = "cuda"
    setUpClass = classmethod(_needs_card)


@pytest.mark.gpu
class TestFlatVsGroupedParityCuda(TestFlatVsGroupedParity):
    device = "cuda"
    setUpClass = classmethod(_needs_card)


@pytest.mark.gpu
class TestStreamedPQCuda(TestStreamedPQ):
    device = "cuda"
    setUpClass = classmethod(_needs_card)


@pytest.mark.gpu
class TestDiskHbmCacheQuantizedCuda(TestDiskHbmCacheQuantized):
    device = "cuda"
    setUpClass = classmethod(_needs_card)


@pytest.mark.gpu
class TestPrecisionTiersCuda(TestPrecisionTiers):
    device = "cuda"
    setUpClass = classmethod(_needs_card)
