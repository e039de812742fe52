"""``tests/test_serve.py`` on the port: fused serving (``Index.serve`` /
``Index.submit_serve``) against the unfused
``ranking.interpolate(index(ranking), alpha).cut(cutoff)``.

Copied with the same data, assertions and tolerances (``places=4``): 25
of the 30 cases, on ``TestServe`` and ``TestServeOnDisk::
test_ondisk_hbm_cache_serve`` (the port's own HDF5 codec: it runs on the
card too).
``test_refine_ignores_stale_query_upload`` injects its stale upload as
the port's cached query block, ``plan["q_dev"]`` ``(Qb, dim)``, where the
JAX package caches the transposed ``plan["q_t_dev"]``.

Not copied a second time: ``test_preload_serve_refine_warm``,
``test_preload_serve_warm`` and ``test_preload_serve_requires_warm`` run in
``tests/test_torch_preload.py::TestServePreload``; the two mesh cases,
``test_sharded_mesh_serve`` and ``test_sharded_mesh_serve_stays_fused``,
run in ``tests/test_torch_parallel.py::test_sharded_mesh_serve`` on CPU
slots (on one card a ``MeshConfig(data=2, shard=4)`` would need the card
named eight times).  Each class runs on ``device="cpu"``; its ``...Cuda``
subclass (marker ``gpu``) runs the same cases on the card and skips
without one.  The file imports neither JAX nor ``fastforward_tpu``.
"""

import unittest

import numpy as np
import pytest
import torch

from fastforward_tpu_torch.encoder import LambdaEncoder
from fastforward_tpu_torch.index import InMemoryIndex, Mode, ScoreFuture
from fastforward_tpu_torch.quantizer import PQ
from fastforward_tpu_torch.ranking import Ranking


def _needs_card(cls):
    if not torch.cuda.is_available():
        raise unittest.SkipTest("needs an NVIDIA GPU")


def _build(
    n=2048,
    dim=16,
    num_q=4,
    depth=32,
    mode=Mode.PASSAGE,
    seed=0,
    **index_kwargs,
):
    rng = np.random.default_rng(seed)
    corpus = rng.standard_normal((n, dim)).astype(np.float32)
    qvecs = rng.standard_normal((num_q, dim)).astype(np.float32)
    by_text = {f"query {i}": qvecs[i] for i in range(num_q)}
    index = InMemoryIndex(
        LambdaEncoder(lambda t: by_text[t]), mode=mode, **index_kwargs
    )
    index.add(corpus, psg_ids=[f"p{i}" for i in range(n)])
    run = {
        f"q{i}": {
            f"p{j}": float(rng.standard_normal())
            for j in rng.choice(n, size=depth, replace=False)
        }
        for i in range(num_q)
    }
    queries = {f"q{i}": f"query {i}" for i in range(num_q)}
    return index, Ranking.from_run(run, queries=queries)


def _build_docs(mode=Mode.MAXP, seed=5, num_q=3, dim=8, **index_kwargs):
    rng = np.random.default_rng(seed)
    qvecs = rng.standard_normal((num_q, dim)).astype(np.float32)
    by_text = {f"query {i}": qvecs[i] for i in range(num_q)}
    index = InMemoryIndex(
        LambdaEncoder(lambda t: by_text[t]), mode=mode, **index_kwargs
    )
    vecs, doc_ids = [], []
    for d in range(64):
        for _ in range(1 + d % 5):
            vecs.append(rng.standard_normal(dim).astype(np.float32))
            doc_ids.append(f"d{d}")
    index.add(np.stack(vecs), doc_ids=doc_ids)
    run = {
        f"q{i}": {
            f"d{d}": float(rng.standard_normal())
            for d in rng.choice(64, size=20, replace=False)
        }
        for i in range(num_q)
    }
    ranking = Ranking.from_run(
        run, queries={f"q{i}": f"query {i}" for i in range(num_q)}
    )
    return index, ranking


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


class TestServe(unittest.TestCase):
    device = "cpu"

    def test_passage_mode_matches_unfused(self):
        index, ranking = _build(device=self.device)
        want = _reference_serve(index, ranking, 0.3, 10)
        got = index.serve(ranking, 0.3, 10)
        _assert_equivalent(self, got, want, 4)
        # fused result is (q_id desc, score desc)-ordered and cut to 10
        self.assertEqual(len(got._df), 4 * 10)
        scores = got._df["score"].to_numpy()
        qids = got._df["q_id"].to_numpy()
        for lo in range(0, 40, 10):
            self.assertEqual(len(set(qids[lo : lo + 10])), 1)
            self.assertTrue((np.diff(scores[lo : lo + 10]) <= 1e-6).all())

    def test_refine_matches_standard_serve(self):
        # two-phase (fast preselect + exact rescore): with a margin
        # covering every candidate, results must equal the exact flow
        index, ranking = _build(seed=11, device=self.device)
        want = _reference_serve(index, ranking, 0.3, 10)
        got = index.serve(ranking, 0.3, 10, refine=64)
        _assert_equivalent(self, got, want, 4)

    def test_refine_warm_and_alpha_sweep(self):
        index, ranking = _build(seed=12, device=self.device)
        index.serve(ranking, 0.2, 10, refine=20)  # build plan + artifacts
        for alpha in (0.0, 0.5, 1.0):
            want = _reference_serve(index, ranking, alpha, 10)
            got = index.serve(ranking, alpha, 10, refine=20)
            _assert_equivalent(self, got, want, 4)
        # refine and standard serve share the plan; both stay correct
        got_std = index.serve(ranking, 0.5, 10)
        _assert_equivalent(self, got_std, _reference_serve(index, ranking, 0.5, 10), 4)

    def test_refine_scores_exact_fp32(self):
        # the refined top-k scores are full-fp32 dots of the stored rows
        index, ranking = _build(seed=13, n=512, dim=32, device=self.device)
        got = index.serve(ranking, 0.0, 5, refine=27)
        vecs = {f"p{i}": i for i in range(512)}
        corpus = index._get_vectors([f"p{i}" for i in range(512)])[0]
        for q in got.q_ids:
            qv = index.encode_queries([f"query {q[1:]}"])[0]
            for pid, score in got[q].items():
                want = float(corpus[vecs[pid]] @ qv)
                self.assertAlmostEqual(score, want, places=4)

    def test_refine_falls_back_on_doc_modes_and_quantized(self):
        index, ranking = _build_docs(mode=Mode.MAXP, device=self.device)
        want = _reference_serve(index, ranking, 0.5, 5)
        got = index.serve(ranking, 0.5, 5, refine=8)  # ignored, still right
        _assert_equivalent(self, got, want, 3)

        rng = np.random.default_rng(14)
        n, dim, num_q = 1024, 16, 4
        corpus = rng.standard_normal((n, dim)).astype(np.float32)
        qvecs = rng.standard_normal((num_q, dim)).astype(np.float32)
        by_text = {f"query {i}": qvecs[i] for i in range(num_q)}
        pq = PQ(M=4, Ks=16, device=self.device)
        pq.fit(corpus[:512])
        index2 = InMemoryIndex(
            LambdaEncoder(lambda t: by_text[t]),
            quantizer=pq,
            mode=Mode.PASSAGE,
            device=self.device,
        )
        index2.add(corpus, psg_ids=[f"p{i}" for i in range(n)])
        run = {
            f"q{i}": {
                f"p{j}": float(rng.standard_normal())
                for j in rng.choice(n, size=32, replace=False)
            }
            for i in range(num_q)
        }
        ranking2 = Ranking.from_run(
            run, queries={f"q{i}": f"query {i}" for i in range(num_q)}
        )
        want2 = _reference_serve(index2, ranking2, 0.3, 10)
        got2 = index2.serve(ranking2, 0.3, 10, refine=8)
        _assert_equivalent(self, got2, want2, 4)

    def test_refine_validation(self):
        index, ranking = _build(seed=15, device=self.device)
        with self.assertRaises(ValueError):
            index.serve(ranking, 0.3, 10, refine=-1)

    def test_refine_submit_serve_pipelined(self):
        index, ranking = _build(seed=16, device=self.device)
        want = index.serve(ranking, 0.3, 10, refine=16)
        fut = index.submit_serve(ranking, 0.3, 10, refine=16)
        self.assertTrue(fut.pipelined)
        got = fut.result()
        _assert_equivalent(self, got, want, 4)

    def test_doc_modes_match_unfused(self):
        for mode in (Mode.MAXP, Mode.AVEP, Mode.FIRSTP):
            with self.subTest(mode=mode):
                index, ranking = _build_docs(mode=mode, device=self.device)
                want = _reference_serve(index, ranking, 0.5, 5)
                got = index.serve(ranking, 0.5, 5)
                _assert_equivalent(self, got, want, 3)

    def test_warm_serve_reuses_plan_and_new_alpha(self):
        index, ranking = _build(seed=2, device=self.device)
        index.serve(ranking, 0.2, 10)  # builds the plan + serve artifacts
        for alpha in (0.0, 0.5, 1.0):
            want = _reference_serve(index, ranking, alpha, 10)
            got = index.serve(ranking, alpha, 10)
            _assert_equivalent(self, got, want, 4)

    def test_serve_after_call_shares_candidates(self):
        index, ranking = _build(seed=3, device=self.device)
        index(ranking)  # __call__ first: plan is ready
        want = _reference_serve(index, ranking, 0.4, 7)
        got = index.serve(ranking, 0.4, 7)
        _assert_equivalent(self, got, want, 4)

    def test_call_after_serve_shares_candidates(self):
        index, ranking = _build(seed=4, device=self.device)
        want = index(ranking)
        index2, ranking2 = _build(seed=4, device=self.device)
        index2.serve(ranking2, 0.4, 7)  # serve first: cand_ready only
        got = index2(ranking2)
        self.assertEqual(list(got._df["id"]), list(want._df["id"]))
        np.testing.assert_allclose(
            got._df["score"].to_numpy(), want._df["score"].to_numpy()
        )

    def test_cutoff_larger_than_depth(self):
        index, ranking = _build(depth=8, device=self.device)
        want = _reference_serve(index, ranking, 0.3, 100)
        got = index.serve(ranking, 0.3, 100)
        self.assertEqual(len(got._df), len(want._df))
        _assert_equivalent(self, got, want, 4)

    def test_ragged_depths_across_queries(self):
        # queries with different candidate counts: padding slots must
        # never surface
        rng = np.random.default_rng(7)
        index, _ = _build(seed=7, device=self.device)
        run = {
            f"q{i}": {
                f"p{j}": float(rng.standard_normal())
                for j in rng.choice(2048, size=4 + 13 * i, replace=False)
            }
            for i in range(4)
        }
        ranking = Ranking.from_run(
            run, queries={f"q{i}": f"query {i}" for i in range(4)}
        )
        want = _reference_serve(index, ranking, 0.6, 9)
        got = index.serve(ranking, 0.6, 9)
        _assert_equivalent(self, got, want, 4)

    def test_submit_serve_pipelined(self):
        index, ranking_a = _build(seed=8, device=self.device)
        _, ranking_b = _build(seed=9, device=self.device)
        want_a = _reference_serve(index, ranking_a, 0.3, 10)
        want_b = _reference_serve(index, ranking_b, 0.3, 10)
        fut_a = index.submit_serve(ranking_a, 0.3, 10)
        fut_b = index.submit_serve(ranking_b, 0.3, 10)
        self.assertIsInstance(fut_a, ScoreFuture)
        self.assertTrue(fut_a.pipelined)
        _assert_equivalent(self, fut_b.result(), want_b, 4)
        _assert_equivalent(self, fut_a.result(), want_a, 4)
        self.assertIs(fut_a.result(), fut_a.result())

    def test_very_ragged_doc_falls_back(self):
        # one document with > _MAX_GROUP_K passages forces the unfused
        # fallback; results must still match
        rng = np.random.default_rng(6)
        dim = 8
        qvec = rng.standard_normal(dim).astype(np.float32)
        index = InMemoryIndex(LambdaEncoder(lambda t: qvec), mode=Mode.MAXP, device=self.device)
        vecs, doc_ids = [], []
        for _ in range(100):
            vecs.append(rng.standard_normal(dim).astype(np.float32))
            doc_ids.append("big")
        for d in range(8):
            vecs.append(rng.standard_normal(dim).astype(np.float32))
            doc_ids.append(f"d{d}")
        index.add(np.stack(vecs), doc_ids=doc_ids)
        run = {"q0": {"big": 9.0, **{f"d{d}": float(d) for d in range(8)}}}
        ranking = Ranking.from_run(run, queries={"q0": "anything"})
        want = _reference_serve(index, ranking, 0.5, 4)
        got = index.serve(ranking, 0.5, 4)
        _assert_equivalent(self, got, want, 1)
        fut = index.submit_serve(ranking, 0.5, 4)
        self.assertFalse(fut.pipelined)
        _assert_equivalent(self, fut.result(), want, 1)

    def test_quantized_serve(self):
        rng = np.random.default_rng(12)
        n, dim, num_q = 2048, 16, 4
        corpus = rng.standard_normal((n, dim)).astype(np.float32)
        qvecs = rng.standard_normal((num_q, dim)).astype(np.float32)
        by_text = {f"query {i}": qvecs[i] for i in range(num_q)}
        pq = PQ(M=4, Ks=16, device=self.device)
        pq.fit(corpus[:1024])
        index = InMemoryIndex(
            LambdaEncoder(lambda t: by_text[t]),
            quantizer=pq,
            mode=Mode.PASSAGE,
            device=self.device,
        )
        index.add(corpus, psg_ids=[f"p{i}" for i in range(n)])
        run = {
            f"q{i}": {
                f"p{j}": float(rng.standard_normal())
                for j in rng.choice(n, size=32, replace=False)
            }
            for i in range(num_q)
        }
        ranking = Ranking.from_run(
            run, queries={f"q{i}": f"query {i}" for i in range(num_q)}
        )
        want = _reference_serve(index, ranking, 0.3, 10)
        got = index.serve(ranking, 0.3, 10)
        _assert_equivalent(self, got, want, num_q)

    def test_alpha_extremes(self):
        index, ranking = _build(seed=13, device=self.device)
        # alpha=1: pure lexical — serve returns the run's own top-k
        got = index.serve(ranking, 1.0, 5)
        want = ranking.cut(5)
        self.assertEqual(got.q_ids, want.q_ids)
        for q in want.q_ids:
            self.assertEqual(set(got[q]), set(want[q]))

    def test_early_stopping_serve_full_depth_equals_fused(self):
        # a single schedule depth >= the run depth scores everything, so
        # ES serve must equal the fused serve exactly (same candidates)
        index, ranking = _build(seed=15, depth=32, device=self.device)
        want = index.serve(ranking, 0.2, 10)
        got = index.serve(ranking, 0.2, 10, early_stopping_depths=(32,))
        _assert_equivalent(self, got, want, 4)

    def test_early_stopping_serve_matches_composed_flow(self):
        # multi-round schedule: must equal the user-composed flow —
        # ES scoring, interpolation RESTRICTED to the scored subset, cut
        index, ranking = _build(seed=16, depth=64, device=self.device)
        ff = index(
            ranking,
            early_stopping=5,
            early_stopping_alpha=0.3,
            early_stopping_depths=(8, 64),
        )
        got = index.serve(ranking, 0.3, 5, early_stopping_depths=(8, 64))
        for q in got.q_ids:
            lex, sem = ranking[q], ff[q]
            interp = {
                d: 0.3 * lex[d] + 0.7 * s for d, s in sem.items()
            }
            want_top = sorted(interp.items(), key=lambda kv: -kv[1])[:5]
            g = got[q]
            self.assertEqual({d for d, _ in want_top}, set(g))
            for d, s in want_top:
                self.assertAlmostEqual(g[d], s, places=4)

    def test_early_stopping_submit_serve_is_eager(self):
        index, ranking = _build(seed=17, depth=32, device=self.device)
        fut = index.submit_serve(
            ranking, 0.2, 5, early_stopping_depths=(8, 32)
        )
        self.assertFalse(fut.pipelined)
        want = index.serve(ranking, 0.2, 5, early_stopping_depths=(8, 32))
        _assert_equivalent(self, fut.result(), want, 4)

    def test_serve_requires_queries_and_valid_cutoff(self):
        index, ranking = _build(device=self.device)
        bare = Ranking(ranking._df.drop(columns=["query"]))
        with self.assertRaises(ValueError):
            index.serve(bare, 0.5, 10)
        with self.assertRaises(ValueError):
            index.serve(ranking, 0.5, 0)

    def test_missing_id_raises(self):
        index, ranking = _build(device=self.device)
        run = {"q0": {"nonexistent": 1.0}}
        bad = Ranking.from_run(run, queries={"q0": "query 0"})
        with self.assertRaises(IndexError):
            index.serve(bad, 0.5, 10)

    def test_serve_keeps_query_column(self):
        # the fused path must produce the same schema as the host fallback
        # (which goes through interpolate and retains the query column)
        index, ranking = _build(device=self.device)
        got = index.serve(ranking, 0.3, 10)
        self.assertTrue(got.has_queries)
        df = got._df
        for q_id, query in zip(df["q_id"], df["query"]):
            self.assertEqual(str(query), f"query {str(q_id)[1:]}")
        # pipelined flavor too
        got2 = index.submit_serve(ranking, 0.3, 10).result()
        self.assertTrue(got2.has_queries)

    def test_refine_ignores_stale_query_upload(self):
        # a cached query upload (plan['q_dev'], written by the streamed
        # scoring path; the port's counterpart of the JAX package's
        # transposed plan['q_t_dev']) must be content-validated before the
        # exact rescore phase reuses it: after an encoder swap the cache is
        # stale and the refine phase would otherwise dot the new candidates
        # against the OLD query vectors
        index, ranking = _build(device=self.device)
        index.serve(ranking, 0.3, 10, refine=8)
        plan = index._plans.get((id(ranking._df), index._mode))
        self.assertIsNotNone(plan)
        # inject a wrong-content (right-shape) query upload, as if an
        # earlier call with different queries had cached it
        view = index._device_view()
        q_texts = [f"query {i}" for i in range(4)]
        q_vecs = np.stack([index.query_encoder([t])[0] for t in q_texts])
        q_pad = index._pad_queries(q_vecs, view)
        stale = np.ascontiguousarray(q_pad + 1.0)
        plan["q_dev"] = (stale, torch.from_numpy(stale).to(view.table.device))
        want = _reference_serve(index, ranking, 0.3, 10)
        got = index.serve(ranking, 0.3, 10, refine=8)
        _assert_equivalent(self, got, want, 4)


class TestServeOnDisk(unittest.TestCase):
    """``TestServe::test_ondisk_hbm_cache_serve`` on the port's
    ``OnDiskIndex``."""

    device = "cpu"

    def test_ondisk_hbm_cache_serve(self):
        import tempfile
        from pathlib import Path

        from fastforward_tpu_torch.index import OnDiskIndex

        rng = np.random.default_rng(20)
        n, dim, num_q = 1024, 16, 3
        corpus = rng.standard_normal((n, dim)).astype(np.float32)
        qvecs = rng.standard_normal((num_q, dim)).astype(np.float32)
        by_text = {f"query {i}": qvecs[i] for i in range(num_q)}
        with tempfile.TemporaryDirectory() as tmp:
            index = OnDiskIndex(
                Path(tmp) / "idx.h5",
                LambdaEncoder(lambda t: by_text[t]),
                mode=Mode.PASSAGE,
                hbm_cache=True,
                device=self.device,
            )
            index.add(corpus, psg_ids=[f"p{i}" for i in range(n)])
            run = {
                f"q{i}": {
                    f"p{j}": float(rng.standard_normal())
                    for j in rng.choice(n, size=24, replace=False)
                }
                for i in range(num_q)
            }
            ranking = Ranking.from_run(
                run, queries={f"q{i}": f"query {i}" for i in range(num_q)}
            )
            want = _reference_serve(index, ranking, 0.3, 8)
            got = index.serve(ranking, 0.3, 8)
            _assert_equivalent(self, got, want, num_q)


@pytest.mark.gpu
class TestServeCuda(TestServe):
    device = "cuda"
    setUpClass = classmethod(_needs_card)


@pytest.mark.gpu
class TestServeOnDiskCuda(TestServeOnDisk):
    device = "cuda"
    setUpClass = classmethod(_needs_card)
