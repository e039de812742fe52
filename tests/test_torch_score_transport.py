"""The u16 score transport of the port against ``fastforward_tpu``'s.

``TestEncodeScoresU16`` and ``TestU16Transport`` of
``tests/test_score_transport.py`` run on the port (CPU, same data); the
mesh case waits for ROADMAP item 14.  Beside them: the port's packed buffer
on the same scores as ``fastforward_tpu.ops.encode_scores_u16`` (header
bit for bit, codes within 1), a re-rank whose copy arrives in chunks of a
few codes (the header lands in pieces), and the port's u16 index against
the JAX package's u16 index (within twice the transport bound).
"""

import unittest

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastforward_tpu import ops as jax_ops
from fastforward_tpu.encoder import LambdaEncoder as JaxLambdaEncoder
from fastforward_tpu.index import InMemoryIndex as JaxInMemoryIndex
from fastforward_tpu.index import Mode as JaxMode
from fastforward_tpu.ranking import Ranking as JaxRanking
from fastforward_tpu_torch import ops
from fastforward_tpu_torch.encoder import LambdaEncoder
from fastforward_tpu_torch.index import InMemoryIndex, Mode
from fastforward_tpu_torch.index import base as base_mod
from fastforward_tpu_torch.ops import scoring
from fastforward_tpu_torch.ranking import Ranking


def _encode(scores: np.ndarray) -> np.ndarray:
    """The port's packed buffer for host scores, read as uint16."""
    packed = ops.encode_scores_u16(torch.from_numpy(scores)).numpy()
    assert packed.dtype == np.int16
    return packed.view(np.uint16)


class TestEncodeScoresU16(unittest.TestCase):
    def test_round_trip_error_bound(self):
        rng = np.random.default_rng(0)
        scores = (rng.standard_normal(5000) * 30).astype(np.float32)
        packed = _encode(scores)
        self.assertEqual(packed.dtype, np.uint16)
        self.assertEqual(packed.shape, (5004,))  # 4-lane in-band header
        decoded = ops.decode_scores_u16(packed)
        bound = (scores.max() - scores.min()) / 131070 + 1e-4
        self.assertLess(np.abs(decoded - scores).max(), bound)

    def test_header_floats_survive_the_u16_bit_split(self):
        scores = np.array([-1234.5678, 0.125, 98765.4], np.float32)
        packed = _encode(scores)
        mn, scale = ops.decode_u16_header(packed[:4])
        # header floats are exact bit round-trips, not quantized
        self.assertEqual(np.float32(mn), np.float32(-1234.5678))
        self.assertAlmostEqual(scale, (98765.4 - -1234.5678) / 65535.0, places=2)

    def test_inf_padding_is_masked_from_calibration(self):
        scores = np.array([-np.inf, 1.0, 2.0, 3.0, -np.inf], np.float32)
        decoded = ops.decode_scores_u16(_encode(scores))
        self.assertTrue(np.isfinite(decoded).all())
        np.testing.assert_allclose(decoded[1:4], [1.0, 2.0, 3.0], atol=1e-3)

    def test_constant_scores(self):
        scores = np.full(100, 7.25, np.float32)
        np.testing.assert_allclose(ops.decode_scores_u16(_encode(scores)), scores, atol=1e-5)


def _scores(case: str) -> np.ndarray:
    rng = np.random.default_rng(11)
    if case == "normal":
        return (rng.standard_normal(4099) * 30).astype(np.float32)
    if case == "inf_padded":
        s = rng.standard_normal(1000).astype(np.float32) * 5 + 100
        s[rng.choice(1000, 300, replace=False)] = -np.inf
        return s
    if case == "negative":
        return -np.abs(rng.standard_normal(777) * 1e4).astype(np.float32)
    if case == "tiny_range":
        return (1.0 + rng.standard_normal(513) * 1e-6).astype(np.float32)
    if case == "constant":
        return np.full(64, -3.5, np.float32)
    return np.array([2.5], np.float32)  # one score


@pytest.mark.parametrize(
    "case", ["normal", "inf_padded", "negative", "tiny_range", "constant", "single"]
)
def test_packed_buffer_matches_jax(case):
    """Same scores: the header equals JAX's bit for bit, the codes are
    within 1 of JAX's (the division may round differently), and both
    decode within the transport bound."""
    scores = _scores(case)
    got = _encode(scores)
    want = np.asarray(jax_ops.encode_scores_u16(jnp.asarray(scores)))
    assert want.dtype == np.uint16 and got.shape == want.shape
    np.testing.assert_array_equal(got[:4], want[:4])
    assert np.abs(got[4:].astype(np.int64) - want[4:].astype(np.int64)).max() <= 1
    assert ops.decode_u16_header(got[:4]) == jax_ops.decode_u16_header(want[:4])
    finite = np.isfinite(scores)
    _, scale = ops.decode_u16_header(got[:4])
    err = np.abs(ops.decode_scores_u16(got)[finite] - scores[finite])
    assert err.max() <= scale / 2 * (1 + 1e-3) + np.abs(scores[finite]).max() * 2.0**-22
    np.testing.assert_array_equal(got[4:][~finite], 0)


def _build(mode=Mode.PASSAGE, n=4096, dim=24, num_q=5, depth=48, seed=0, **kw):
    rng = np.random.default_rng(seed)
    qvecs = rng.standard_normal((num_q, dim)).astype(np.float32)
    by_text = {f"query {i}": qvecs[i] for i in range(num_q)}
    enc = LambdaEncoder(lambda t: by_text[t])
    index = InMemoryIndex(enc, mode=mode, device="cpu", **kw)
    if mode is Mode.PASSAGE:
        corpus = rng.standard_normal((n, dim)).astype(np.float32)
        index.add(corpus, psg_ids=[f"p{i}" for i in range(n)])
        ids = [f"p{i}" for i in range(n)]
    else:
        vecs, doc_ids = [], []
        for d in range(n // 4):
            for _ in range(1 + d % 4):
                vecs.append(rng.standard_normal(dim).astype(np.float32))
                doc_ids.append(f"d{d}")
        index.add(np.stack(vecs), doc_ids=doc_ids)
        ids = sorted(set(doc_ids))
    run = {
        f"q{i}": {
            pid: float(depth - r)
            for r, pid in enumerate(rng.choice(ids, size=depth, replace=False))
        }
        for i in range(num_q)
    }
    queries = {f"q{i}": f"query {i}" for i in range(num_q)}
    return index, Ranking.from_run(run, queries=queries)


def _assert_close(test, got: Ranking, want: Ranking):
    """Same structure; scores within the u16 transport bound."""
    w = want._df
    rng_span = float(w["score"].max() - w["score"].min())
    tol = rng_span / 131070 * 2 + 1e-3
    g = got._df
    test.assertEqual(len(g), len(w))
    # compare per (q_id, id): near-tie orders may legitimately differ
    gm = dict(zip(zip(g["q_id"], g["id"]), g["score"]))
    for q, i, s in zip(w["q_id"], w["id"], w["score"]):
        test.assertAlmostEqual(gm[(q, i)], s, delta=tol)
    # per-query result blocks are sorted by the (dequantized) score desc
    scores = g["score"].to_numpy()
    qids = g["q_id"].to_numpy()
    breaks = np.flatnonzero(qids[1:] != qids[:-1]) + 1
    for blk in np.split(scores, breaks):
        test.assertTrue((np.diff(blk) <= 1e-9).all())


class TestU16Transport(unittest.TestCase):
    def test_passage_mode_close_to_f32(self):
        index, ranking = _build(score_transport="u16")
        index_f32, ranking_f32 = _build()
        _assert_close(self, index(ranking), index_f32(ranking_f32))

    def test_warm_call_and_forced_chunking(self):
        index, ranking = _build(score_transport="u16", seed=1)
        index_f32, ranking_f32 = _build(seed=1)
        want = index_f32(ranking_f32)
        index(ranking)  # builds the plan
        old = scoring._FETCH_CHUNK_MIN
        scoring._FETCH_CHUNK_MIN = 1
        try:
            got = index(ranking)  # warm: overlapped u16 dequant + sinks
        finally:
            scoring._FETCH_CHUNK_MIN = old
        _assert_close(self, got, want)

    def test_maxp_with_inf_padding(self):
        # grouped layout with K > 1: padded K-slots reduce to -inf scores
        # for padded pairs; calibration must ignore them
        index, ranking = _build(mode=Mode.MAXP, score_transport="u16", seed=2)
        index_f32, ranking_f32 = _build(mode=Mode.MAXP, seed=2)
        _assert_close(self, index(ranking), index_f32(ranking_f32))

    def test_submit_pipeline(self):
        index, ranking = _build(score_transport="u16", seed=3)
        want = index(ranking)
        fut = index.submit(ranking)
        self.assertTrue(fut.pipelined)
        got = fut.result()
        self.assertEqual(list(got._df["id"]), list(want._df["id"]))
        np.testing.assert_array_equal(got._df["score"].to_numpy(), want._df["score"].to_numpy())

    def test_invalid_transport_rejected(self):
        with self.assertRaises(ValueError):
            InMemoryIndex(score_transport="u8", device="cpu")


@pytest.mark.parametrize("chunk", [1, 3, 64])
def test_chunked_copy_dequantizes_each_chunk(monkeypatch, chunk):
    """The copy lands a few codes at a time (the CPU copy is one chunk): the
    header is read once its 4 lanes have landed, each chunk decodes with
    it, and the result equals the one-chunk u16 result."""
    index, ranking = _build(score_transport="u16", seed=5)
    want = index(ranking)
    calls = []

    def chunked(arr, on_chunk=None, out=None):
        n = int(arr.shape[0])
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            out[lo:hi] = arr[lo:hi].numpy()
            calls.append(hi)
            on_chunk(lo, hi)
        return out

    monkeypatch.setattr(base_mod.ops, "fetch_np_overlapped", chunked)
    got = index(ranking)
    assert len(calls) > 1
    np.testing.assert_array_equal(got._df["id"].astype(str), want._df["id"].astype(str))
    np.testing.assert_array_equal(got._df["score"].to_numpy(), want._df["score"].to_numpy())


@pytest.mark.parametrize("mode", ["PASSAGE", "MAXP"])
def test_port_matches_jax_u16_index(mode):
    """The port's u16 index and the JAX package's on the same vectors and
    run: scores within twice the transport bound (each side adds at most
    one), same rows."""
    rng = np.random.default_rng(7)
    n, dim, num_q, depth = 2048, 128, 4, 40
    corpus = rng.standard_normal((n, dim)).astype(np.float32)
    qvecs = rng.standard_normal((num_q, dim)).astype(np.float32)
    by_text = {f"query {i}": qvecs[i] for i in range(num_q)}
    doc_ids = [f"d{i // 3}" for i in range(n)]
    psg_ids = [f"p{i}" for i in range(n)]
    jax_index = JaxInMemoryIndex(
        JaxLambdaEncoder(by_text.__getitem__), mode=JaxMode[mode], score_transport="u16"
    )
    jax_index.add(corpus, doc_ids=doc_ids, psg_ids=psg_ids)
    index = InMemoryIndex(
        LambdaEncoder(by_text.__getitem__), mode=Mode[mode], score_transport="u16", device="cpu"
    )
    index.add(corpus, doc_ids=doc_ids, psg_ids=psg_ids)
    ids = psg_ids if mode == "PASSAGE" else sorted(set(doc_ids))
    run = {
        f"q{i}": {c: float(depth - r) for r, c in enumerate(rng.choice(ids, depth, replace=False))}
        for i in range(num_q)
    }
    queries = {f"q{i}": f"query {i}" for i in range(num_q)}
    got = index(Ranking.from_run(run, queries=queries))._df
    want = jax_index(JaxRanking.from_run(run, queries=queries))._df
    span = float(want["score"].max() - want["score"].min())
    g = dict(zip(zip(got["q_id"].astype(str), got["id"].astype(str)), got["score"]))
    w = dict(zip(zip(want["q_id"].astype(str), want["id"].astype(str)), want["score"]))
    assert g.keys() == w.keys()
    assert max(abs(g[k] - w[k]) for k in w) <= 2 * span / 131070 + 1e-4
