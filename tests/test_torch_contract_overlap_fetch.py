"""``tests/test_overlap_fetch.py`` on the port: the chunked device->host
score copy overlapped with the windowed rank sort.

All 10 cases are copied with the same data and assertions (bit for bit
against the one-shot path), on torch tensors in place of ``jnp`` arrays:
``TestFetchNpOverlapped`` (4: ``fetch_np_overlapped(x, on_chunk, chunks,
out)``), ``TestSegmentedArgsortInto`` (1), ``TestOverlapSinks`` (3:
``_overlap_fetch_sort`` with result sinks) and ``TestOverlappedServing``
(2: forced chunking on warm calls, the query-id set through the plan
cache).  None is left out.  On the CPU ``fetch_np_overlapped`` takes one
copy (the cases still hold: one chunk covers every row); on the card
``test_on_chunk_covers_every_row_once`` must also see its 4 chunks in
order.  Each class that fetches a tensor or builds an index runs on
``device="cpu"``, and its ``...Cuda`` subclass (marker ``gpu``) runs the
same cases on the card and skips without one.  The file imports neither
JAX nor ``fastforward_tpu``.
"""

import unittest

import numpy as np
import pytest
import torch

from fastforward_tpu_torch import ops
from fastforward_tpu_torch.encoder import LambdaEncoder
from fastforward_tpu_torch.index import InMemoryIndex, Mode
from fastforward_tpu_torch.ops import scoring
from fastforward_tpu_torch.ranking import Ranking
from fastforward_tpu_torch.runtime.idmap import (
    segmented_rank_argsort,
    segmented_rank_argsort_into,
)


def _needs_card(cls):
    if not torch.cuda.is_available():
        raise unittest.SkipTest("needs an NVIDIA GPU")


class TestFetchNpOverlapped(unittest.TestCase):
    device = "cpu"

    def test_matches_blocking_fetch(self):
        x = torch.arange(1000, dtype=torch.float32, device=self.device) * 0.5
        got = ops.fetch_np_overlapped(x, chunks=4)
        np.testing.assert_array_equal(got, x.cpu().numpy())

    def test_on_chunk_covers_every_row_once(self):
        old = scoring._FETCH_CHUNK_MIN
        scoring._FETCH_CHUNK_MIN = 1
        try:
            x = torch.arange(103, dtype=torch.float32, device=self.device)
            seen = []
            out = ops.fetch_np_overlapped(
                x, on_chunk=lambda lo, hi: seen.append((lo, hi)), chunks=4
            )
        finally:
            scoring._FETCH_CHUNK_MIN = old
        np.testing.assert_array_equal(out, np.arange(103, dtype=np.float32))
        # chunks tile [0, n) exactly, in order, no overlap
        self.assertEqual(seen[0][0], 0)
        self.assertEqual(seen[-1][1], 103)
        for (_, hi), (lo, _) in zip(seen, seen[1:]):
            self.assertEqual(hi, lo)
        if self.device == "cuda":  # the CPU takes one copy
            self.assertEqual(seen, [(0, 26), (26, 52), (52, 78), (78, 103)])

    def test_small_arrays_fall_back_to_one_chunk(self):
        x = torch.arange(10, dtype=torch.float32, device=self.device)
        seen = []
        ops.fetch_np_overlapped(
            x, on_chunk=lambda lo, hi: seen.append((lo, hi)), chunks=4
        )
        self.assertEqual(seen, [(0, 10)])

    def test_caller_buffer_is_used(self):
        x = torch.arange(50, dtype=torch.float32, device=self.device)
        buf = np.empty(50, dtype=np.float32)
        out = ops.fetch_np_overlapped(x, out=buf)
        self.assertIs(out, buf)
        np.testing.assert_array_equal(buf, np.arange(50, dtype=np.float32))


class TestSegmentedArgsortInto(unittest.TestCase):
    def test_windowed_matches_one_shot(self):
        rng = np.random.default_rng(3)
        num_q, depth = 7, 40
        scores = rng.standard_normal(num_q * depth).astype(np.float32)
        seg_starts = np.arange(0, num_q * depth + 1, depth, dtype=np.int64)
        out_starts = seg_starts[:-1].copy()
        want = segmented_rank_argsort(scores, seg_starts, out_starts)
        if want is None:
            self.skipTest("native runtime unavailable")
        got = np.empty_like(want)
        # sort queries in two windows (0..2) and (3..6)
        self.assertTrue(
            segmented_rank_argsort_into(
                scores, seg_starts[0:4], out_starts[0:3], got
            )
        )
        self.assertTrue(
            segmented_rank_argsort_into(
                scores, seg_starts[3:], out_starts[3:], got
            )
        )
        np.testing.assert_array_equal(got, want)


class TestOverlapSinks(unittest.TestCase):
    """Result-assembly gathers riding the overlapped fetch."""

    device = "cpu"

    def _run(self, out_order):
        """Sort 6 segments of mixed lengths whose result blocks are laid
        out in ``out_order`` (a permutation of segment numbers)."""
        from fastforward_tpu_torch.index.base import _overlap_fetch_sort

        rng = np.random.default_rng(11)
        lengths = np.array([5, 9, 3, 8, 1, 6], dtype=np.int64)
        n = int(lengths.sum())
        seg_starts = np.zeros(7, dtype=np.int64)
        np.cumsum(lengths, out=seg_starts[1:])
        out_starts = np.empty(6, dtype=np.int64)
        pos = 0
        for q in out_order:
            out_starts[q] = pos
            pos += lengths[q]
        scores = rng.standard_normal(n).astype(np.float32)
        codes = rng.integers(0, 100, size=n).astype(np.int32)
        dst_scores = np.full(n, np.nan, dtype=np.float32)
        dst_codes = np.full(n, -1, dtype=np.int32)
        x = torch.from_numpy(scores).to(self.device)
        old = scoring._FETCH_CHUNK_MIN
        scoring._FETCH_CHUNK_MIN = 1
        try:
            fetched = _overlap_fetch_sort(
                x,
                (seg_starts, out_starts),
                n,
                sinks=((None, codes), (dst_scores, dst_codes)),
            )
        finally:
            scoring._FETCH_CHUNK_MIN = old
        if fetched is None:
            self.skipTest("native runtime unavailable")
        got_scores, take, materialized = fetched
        self.assertTrue(materialized)
        np.testing.assert_array_equal(got_scores, scores)
        np.testing.assert_array_equal(dst_scores, scores[take])
        np.testing.assert_array_equal(dst_codes, codes[take])
        # per-segment descending order in the result blocks
        for q in range(6):
            blk = dst_scores[out_starts[q] : out_starts[q] + lengths[q]]
            self.assertTrue((np.diff(blk) <= 0).all())

    def test_reverse_layout_materializes_during_fetch(self):
        # input-ascending segments filling the result from the end — the
        # serving path's layout (q_id desc result order)
        self._run(out_order=[5, 4, 3, 2, 1, 0])

    def test_identity_layout(self):
        self._run(out_order=[0, 1, 2, 3, 4, 5])

    def test_shuffled_layout_falls_back_to_final_remainder(self):
        self._run(out_order=[2, 0, 4, 1, 5, 3])


class TestOverlappedServing(unittest.TestCase):
    """End-to-end: chunk-forced warm calls match the one-shot results."""

    device = "cpu"

    def _build(self, n=4096, dim=32, num_q=6, depth=64):
        rng = np.random.default_rng(7)
        corpus = rng.standard_normal((n, dim)).astype(np.float32)
        qvecs = rng.standard_normal((num_q, dim)).astype(np.float32)
        by_text = {f"query {i}": qvecs[i] for i in range(num_q)}
        index = InMemoryIndex(
            LambdaEncoder(lambda t: by_text[t]), mode=Mode.PASSAGE, device=self.device
        )
        index.add(corpus, psg_ids=[f"p{i}" for i in range(n)])
        run = {
            f"q{i}": {
                f"p{j}": float(depth - r)
                for r, j in enumerate(
                    rng.choice(n, size=depth, replace=False)
                )
            }
            for i in range(num_q)
        }
        queries = {f"q{i}": f"query {i}" for i in range(num_q)}
        return index, Ranking.from_run(run, queries=queries), corpus, qvecs

    def test_warm_call_parity_under_forced_chunking(self):
        index, ranking, corpus, qvecs = self._build()
        baseline = index(ranking)  # builds the plan (one-shot fetch path)
        old = scoring._FETCH_CHUNK_MIN
        scoring._FETCH_CHUNK_MIN = 1
        try:
            chunked = index(ranking)  # warm call: overlapped fetch engages
        finally:
            scoring._FETCH_CHUNK_MIN = old
        pd_b, pd_c = baseline._df, chunked._df
        self.assertEqual(list(pd_b["id"]), list(pd_c["id"]))
        self.assertEqual(list(pd_b["q_id"]), list(pd_c["q_id"]))
        np.testing.assert_array_equal(
            pd_b["score"].to_numpy(), pd_c["score"].to_numpy()
        )
        # and the scores are the true dot products
        got = chunked["q0"]
        for pid in list(got)[:5]:
            want = float(corpus[int(pid[1:])] @ qvecs[0])
            self.assertAlmostEqual(want, got[pid], places=3)

    def test_query_id_set_survives_the_plan_cache(self):
        index, ranking, _, _ = self._build(n=1024, num_q=3, depth=32)
        first = index(ranking)
        second = index(ranking)
        self.assertEqual(first.q_ids, second.q_ids)
        self.assertEqual(first.q_ids, {"q0", "q1", "q2"})
        # mutating one result's set must not leak into the next call's
        second.q_ids.add("rogue")
        third = index(ranking)
        self.assertEqual(third.q_ids, {"q0", "q1", "q2"})


@pytest.mark.gpu
class TestFetchNpOverlappedCuda(TestFetchNpOverlapped):
    device = "cuda"
    setUpClass = classmethod(_needs_card)


@pytest.mark.gpu
class TestOverlapSinksCuda(TestOverlapSinks):
    device = "cuda"
    setUpClass = classmethod(_needs_card)


@pytest.mark.gpu
class TestOverlappedServingCuda(TestOverlappedServing):
    device = "cuda"
    setUpClass = classmethod(_needs_card)
