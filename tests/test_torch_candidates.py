"""A ranking's candidates, numbered and resolved once for every entry point
(``index/base.py`` ``Index._candidates``).

A ``Mode.MAXP`` ranking with a document of more than ``_MAX_GROUP_K``
passages takes the flat layout: ``__call__``, ``submit`` and ``serve``
each encode its queries once and resolve its ids once, and a second call
on the same ranking takes the plan's record without resolving again.  The
results are those of the unfused flow.  The file runs on the CPU and
imports neither JAX nor ``fastforward_tpu``.
"""

import numpy as np
import pytest

from fastforward_tpu_torch.encoder import LambdaEncoder
from fastforward_tpu_torch.index import InMemoryIndex, Mode
from fastforward_tpu_torch.ranking import Ranking

DIM = 8
ALPHA, CUTOFF = 0.3, 4


def _ragged_index():
    """A MAXP index whose document ``big`` has 100 passages, beside eight of
    one to three, and a two-query ranking of them all."""
    rng = np.random.default_rng(6)
    qvecs = {f"query {i}": rng.standard_normal(DIM).astype(np.float32) for i in range(2)}
    index = InMemoryIndex(LambdaEncoder(lambda t: qvecs[t]), mode=Mode.MAXP, device="cpu")
    doc_ids = ["big"] * 100 + [f"d{d}" for d in range(8) for _ in range(1 + d % 3)]
    index.add(rng.standard_normal((len(doc_ids), DIM)).astype(np.float32), doc_ids=doc_ids)
    run = {
        "q0": {"big": 9.0, **{f"d{d}": float(d) for d in range(8)}},
        "q1": {f"d{d}": float(8 - d) for d in range(6)},
    }
    return index, Ranking.from_run(run, queries={"q0": "query 0", "q1": "query 1"})


def _entry(index, ranking, entry: str) -> Ranking:
    if entry == "call":
        return index(ranking)
    if entry == "submit":
        future = index.submit(ranking)
        assert not future.pipelined  # the flat layout has no deferred fetch
        return future.result()
    return index.serve(ranking, ALPHA, CUTOFF)


@pytest.mark.parametrize("entry", ["call", "submit", "serve"])
def test_a_flat_document_ranking_is_encoded_and_resolved_once(entry, monkeypatch):
    index, ranking = _ragged_index()
    ref_index, ref_ranking = _ragged_index()
    encodes, resolves = [], []
    encode, resolve = index.encode_queries, index._ids.resolve
    monkeypatch.setattr(index, "encode_queries", lambda q: encodes.append(len(q)) or encode(q))
    monkeypatch.setattr(index._ids, "resolve", lambda *a: resolves.append(1) or resolve(*a))

    got = _entry(index, ranking, entry)
    assert encodes == [2] and len(resolves) == 1
    assert index._get_plan(ranking)["cands"].flat is not None
    again = _entry(index, ranking, entry)
    assert encodes == [2, 2] and len(resolves) == 1  # the plan's record

    want = ref_index(ref_ranking)
    if entry == "serve":
        want = ref_ranking.interpolate(want, ALPHA).cut(CUTOFF)
    for out in (got, again):
        assert out.name == "fast-forward"
        assert list(out._df.columns) == list(want._df.columns)
        for col in out._df.columns:
            np.testing.assert_array_equal(
                out._df[col].to_numpy(dtype=object), want._df[col].to_numpy(dtype=object), col
            )
