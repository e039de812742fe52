"""The seeded generators: the same seed gives the same inputs."""

import numpy as np
import pytest
import torch

from bench_port import data

BIG_SEED = 2**31 + 12345


def test_same_seed_same_corpus_and_chunks_equal_one_shot():
    n, dim = 2 * data.BLOCK_ROWS + 1000, 4
    whole = data.corpus_rows(BIG_SEED, 0, n, n, dim, "cpu")
    again = data.corpus_rows(BIG_SEED, 0, n, n, dim, "cpu")
    assert torch.equal(whole, again)
    cuts = [0, 5, data.BLOCK_ROWS - 1, data.BLOCK_ROWS + 7, 2 * data.BLOCK_ROWS, n]
    chunks = torch.cat([data.corpus_rows(BIG_SEED, a, b, n, dim, "cpu") for a, b in zip(cuts, cuts[1:])])
    assert torch.equal(chunks, whole)
    rows = np.array([n - 1, 0, data.BLOCK_ROWS, 17, 17])
    assert torch.equal(data.gather_corpus(BIG_SEED, rows, n, dim, "cpu"), whole[torch.from_numpy(rows)])
    assert not torch.equal(data.corpus_rows(BIG_SEED + 1, 0, 10, n, dim, "cpu"), whole[:10])


def test_stream_seeds_take_large_and_distinct_seeds():
    assert data.stream_seed(2**40, 1) == data.stream_seed(2**40, 1)
    assert data.stream_seed(2**40, 1) != data.stream_seed(2**40 + 1, 1)
    assert 0 <= data.stream_seed(2**40, 1) < 2**63


def test_queries_pools_are_distinct_and_repeatable():
    pools = [data.queries(BIG_SEED, k, 64, (2, 15), 512, 20_000, 100) for k in range(4)]
    again = data.queries(BIG_SEED, 2, 64, (2, 15), 512, 20_000, 100)
    assert again.texts == pools[2].texts and np.array_equal(again.candidates, pools[2].candidates)
    ids = [q for p in pools for q in p.q_ids]
    assert len(set(ids)) == len(ids)
    assert len({t for p in pools for t in p.texts}) > 0.99 * len(ids)
    for p in pools:
        assert all(2 <= len(t.split()) <= 15 for t in p.texts)
        assert all(np.unique(row).size == row.size for row in p.candidates)
        assert p.candidates.min() >= 0 and p.candidates.max() < 20_000


def test_candidate_sets_are_distinct_where_repeats_are_likely():
    cand = data.candidate_sets(BIG_SEED, 0, 50, 1200, 1000)
    assert all(np.unique(row).size == 1000 for row in cand)
    with pytest.raises(ValueError):
        data.candidate_sets(BIG_SEED, 0, 1, 10, 11)


def test_documents_hold_the_total_and_their_rows():
    docs = data.documents(BIG_SEED, 1000, 6393)
    assert docs.counts.min() >= 1 and docs.n_rows == 6393 == docs.counts.sum()
    assert np.array_equal(docs.counts, data.documents(BIG_SEED, 1000, 6393).counts)
    rows, counts = docs.rows_of(np.array([3, 0, 999]))
    want = np.concatenate([np.arange(docs.starts[d], docs.starts[d] + docs.counts[d]) for d in (3, 0, 999)])
    assert np.array_equal(rows, want) and counts.sum() == rows.size
    assert docs.n_rows == docs.starts[-1] + docs.counts[-1]
    # the counts' shape: geometric from 1 with the mean, whatever the draw's
    # own total was
    big = data.documents(BIG_SEED, 200_000, 1_278_577)
    assert big.n_rows == 1_278_577 and big.counts.min() == 1
    p = 200_000 / 1_278_577
    for k in (1, 2, 5, 10):
        assert abs(np.mean(big.counts == k) - p * (1 - p) ** (k - 1)) < 0.003
    assert data.documents(BIG_SEED, 5, 5).counts.tolist() == [1] * 5
    with pytest.raises(ValueError):
        data.documents(BIG_SEED, 6, 5)


def test_tower_weights_and_vectors_repeat():
    from bench_port.tests.conftest import TINY_TOWER

    a = data.tower_weights(BIG_SEED, TINY_TOWER, "cpu")
    b = data.tower_weights(BIG_SEED, TINY_TOWER, "cpu")
    assert a.keys() == data.tower_shapes(TINY_TOWER).keys()
    assert all(torch.equal(a[k], b[k]) and tuple(a[k].shape) == s
               for k, s in data.tower_shapes(TINY_TOWER).items())
    assert abs(float(a["embeddings.LayerNorm.weight"].mean()) - 1.0) < 0.05
    vecs = data.query_vectors(BIG_SEED, ["w1 w2", "w3"], 8)
    assert np.array_equal(vecs["w3"], data.query_vectors(BIG_SEED, ["w3", "w1 w2"], 8)["w3"])
    assert data.vocabulary(600)[:9] == list(data.SPECIAL_TOKENS) and len(data.vocabulary(600)) == 600
