"""``tests/test_runtime.py`` on the port: the native runtime's radix and
segmented argsorts, the streamed layout builder, and the composite-key rank
order.

All 7 cases are copied with the same data and assertions.  The two layout
cases read the port's layout constants, ``ops.KERNEL_TILE_ROWS`` and
``ops.KERNEL_CAP`` (512; the JAX package's ``STREAM_TILE_ROWS`` and
``STREAM_CAP`` are 1024), in place of the JAX names.  None is left out.
These are host code: no case builds an index or calls a kernel, so none
runs on the card.  The file imports neither JAX nor ``fastforward_tpu``.
"""

import unittest

import numpy as np

from fastforward_tpu_torch import ops
from fastforward_tpu_torch.runtime.idmap import radix_argsort


class TestRadixArgsort(unittest.TestCase):
    def test_matches_numpy(self):
        rng = np.random.default_rng(1)
        for n in (0, 1, 7, 1000, 100_000):
            keys = rng.integers(0, 2**63, size=n, dtype=np.uint64)
            got = radix_argsort(keys)
            if got is None:  # no native lib in this environment
                self.skipTest("native runtime unavailable")
            np.testing.assert_array_equal(np.argsort(keys, kind="stable"), got)

    def test_stability(self):
        keys = np.array([3, 1, 1, 3, 1], dtype=np.uint64)
        got = radix_argsort(keys)
        if got is None:
            self.skipTest("native runtime unavailable")
        np.testing.assert_array_equal([1, 2, 4, 0, 3], got)


class TestSegmentedRankArgsort(unittest.TestCase):
    def test_matches_composite_key_sort(self):
        from fastforward_tpu_torch.runtime.idmap import segmented_rank_argsort

        rng = np.random.default_rng(7)
        n_q, depth = 13, 57
        p = n_q * depth
        scores = rng.standard_normal(p).astype(np.float32)
        # a few exact ties and specials
        scores[3] = scores[4] = scores[5]
        scores[10] = np.inf
        scores[11] = -np.inf
        scores[12] = np.nan
        seg_starts = np.arange(0, p + 1, depth, dtype=np.int64)
        rank_of_q = rng.permutation(n_q).astype(np.uint64)
        lengths = np.diff(seg_starts)
        by_rank = np.empty(n_q, dtype=np.int64)
        by_rank[rank_of_q.astype(np.int64)] = np.arange(n_q)
        cum = np.zeros(n_q + 1, dtype=np.int64)
        np.cumsum(lengths[by_rank], out=cum[1:])
        out_starts = np.empty(n_q, dtype=np.int64)
        out_starts[by_rank] = cum[:-1]

        got = segmented_rank_argsort(scores, seg_starts, out_starts)
        if got is None:
            self.skipTest("native runtime unavailable")

        qno = np.repeat(np.arange(n_q), depth)
        bits = scores.view(np.uint32)
        asc = np.where(bits >> 31 != 0, ~bits, bits | np.uint32(0x80000000))
        key = (rank_of_q[qno] << np.uint64(32)) | (
            np.uint32(0xFFFFFFFF) - asc
        ).astype(np.uint64)
        np.testing.assert_array_equal(np.argsort(key, kind="stable"), got)

    def test_ragged_segments(self):
        from fastforward_tpu_torch.runtime.idmap import segmented_rank_argsort

        scores = np.array([3.0, 1.0, 2.0, 9.0, 0.5, 0.25, 0.75], np.float32)
        seg_starts = np.array([0, 3, 4, 7], dtype=np.int64)  # sizes 3, 1, 3
        # output order: q2, q0, q1
        out_starts = np.array([3, 6, 0], dtype=np.int64)
        got = segmented_rank_argsort(scores, seg_starts, out_starts)
        if got is None:
            self.skipTest("native runtime unavailable")
        np.testing.assert_array_equal([6, 4, 5, 0, 2, 1, 3], got)


class TestStreamedLayout(unittest.TestCase):
    def test_skewed_tiles_spill_to_virtual_tiles(self):
        """More candidates than CAP in one tile -> repeated tile index."""
        cap = ops.KERNEL_CAP
        n_pad = ops.KERNEL_TILE_ROWS * 4
        qb = 4
        # all candidates in tile 0
        rows = np.zeros(cap + 10, dtype=np.int64)
        qno = np.zeros(cap + 10, dtype=np.int64)
        cand, tile_idx, slot = ops.build_streamed_layout(rows, qno, n_pad, qb)
        self.assertGreaterEqual((tile_idx == 0).sum(), 2)
        self.assertEqual(len(np.unique(slot)), cap + 10)

    def test_empty(self):
        self.assertIsNone(
            ops.build_streamed_layout(
                np.array([], dtype=np.int64),
                np.array([], dtype=np.int64),
                ops.KERNEL_TILE_ROWS,
                4,
            )
        )



class TestDescRankOrder(unittest.TestCase):
    def test_matches_lexsort(self):
        """The composite-key order (shared by the dense fast path and ES
        assembly) must equal a plain lexsort on (rank asc, score desc),
        including negative/zero scores and ties."""
        from fastforward_tpu_torch.index.base import _desc_rank_order

        rng = np.random.default_rng(7)
        n = 5000
        rank = rng.integers(0, 40, size=n).astype(np.uint64)
        scores = rng.normal(size=n).astype(np.float32)
        scores[:50] = 0.0  # ties at zero
        scores[50:100] = scores[0]  # more ties
        order = _desc_rank_order(rank << np.uint64(32), scores)
        expected = np.lexsort((-scores.astype(np.float64), rank))
        # same (rank, score) sequence; tie order may differ between the
        # two stable sorts only if keys differ — assert key equality
        np.testing.assert_array_equal(rank[order], rank[expected])
        np.testing.assert_array_equal(scores[order], scores[expected])
        # within ties both sorts are stable -> identical permutations
        np.testing.assert_array_equal(order, expected)
