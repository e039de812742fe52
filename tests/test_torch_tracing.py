"""The ``ff.*`` ranges of the port's calls, read on the CPU.

Each case runs a call under ``torch.profiler`` (CPU activity) and reads
the ranges from ``prof.events()``, as the benchmark's trace reader does:
a call on a fresh frame names its host phases inside ``ff.call``, a call
on a ready plan skips the frame and candidate work, the flat MaxP path is
resolved and scored under its own ranges, the transformer encoder names
each micro-batch's tokenization and tower, and no range opens inside a
range of its own name on any path.  The file imports neither JAX nor
``fastforward_tpu``.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fastforward_tpu_torch.encoder import LambdaEncoder
from fastforward_tpu_torch.index import InMemoryIndex, Mode
from fastforward_tpu_torch.ranking import Ranking

DIM = 16
HOST_PHASES = ("ff.frame", "ff.resolve", "ff.columns", "ff.assemble")


def _traced(fn):
    """``fn()``'s result and the ``ff.*`` ranges it opened, as ``(name,
    start, end)`` in microseconds."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ranges = [
        (ev.name, float(ev.time_range.start), float(ev.time_range.end))
        for ev in prof.events()
        if ev.name.startswith("ff.")
    ]
    return out, ranges


def _names(ranges) -> set:
    return {n for n, _, _ in ranges}


def _count(ranges, name: str) -> int:
    return sum(n == name for n, _, _ in ranges)


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _self_nested(ranges) -> list:
    """The ranges that lie inside another range of the same name."""
    return [
        a for i, a in enumerate(ranges)
        if any(j != i and b[0] == a[0] and _inside(a, b) for j, b in enumerate(ranges))
    ]


def _passage_index(n=256, n_q=4, depth=32, seed=0):
    rng = np.random.default_rng(seed)
    corpus = rng.normal(size=(n, DIM)).astype(np.float32)
    qvecs = {f"text {q}": rng.normal(size=DIM).astype(np.float32) for q in range(n_q)}
    index = InMemoryIndex(
        LambdaEncoder(qvecs.__getitem__), mode=Mode.PASSAGE, device="cpu"
    )
    index.add(corpus, psg_ids=[f"p{i}" for i in range(n)])
    run = {
        f"q{q}": {f"p{int(i)}": float(depth - j)
                  for j, i in enumerate(rng.choice(n, depth, replace=False))}
        for q in range(n_q)
    }
    ranking = Ranking.from_run(run, queries={f"q{q}": f"text {q}" for q in range(n_q)})
    return index, ranking


def _document_index(big=70, seed=1):
    """A MaxP index whose document ``d0`` has ``big`` passages (more than
    the grouped layout's 64) and 40 documents of 1-3 passages."""
    rng = np.random.default_rng(seed)
    doc_ids = ["d0"] * big + [f"d{1 + i // 3}" for i in range(120)]
    corpus = rng.normal(size=(len(doc_ids), DIM)).astype(np.float32)
    qvec = rng.normal(size=DIM).astype(np.float32)
    index = InMemoryIndex(LambdaEncoder(lambda _: qvec), mode=Mode.MAXP, device="cpu")
    index.add(corpus, doc_ids=doc_ids)
    docs = sorted(set(doc_ids))
    run = {"q1": {d: float(len(docs) - j) for j, d in enumerate(docs)},
           "q2": {d: float(j) for j, d in enumerate(docs[:20])}}
    return index, Ranking.from_run(run, queries={"q1": "a", "q2": "b"})


def test_a_fresh_frame_names_its_host_phases_inside_the_call():
    index, ranking = _passage_index()
    _, ranges = _traced(lambda: index(ranking))
    calls = [r for r in ranges if r[0] == "ff.call"]
    assert len(calls) == 1
    for name in HOST_PHASES + ("ff.score", "ff.fetch_sort"):
        mine = [r for r in ranges if r[0] == name]
        assert mine, name
        assert all(_inside(r, calls[0]) for r in mine), name
    assert not _self_nested(ranges)


def test_a_ready_plan_skips_the_frame_and_the_candidates():
    index, ranking = _passage_index()
    first = index(ranking)
    second, ranges = _traced(lambda: index(ranking))
    assert not _names(ranges) & {"ff.frame", "ff.resolve", "ff.columns"}
    assert {"ff.call", "ff.score", "ff.assemble"} <= _names(ranges)
    assert first._df.equals(second._df)


def test_the_flat_maxp_path_is_resolved_and_scored_under_its_ranges():
    index, ranking = _document_index()
    out, ranges = _traced(lambda: index(ranking))
    # the ids are resolved once, into the flat layout the call scores
    assert _count(ranges, "ff.resolve") == 1
    assert _count(ranges, "ff.score") == 1
    assert {"ff.call", "ff.frame", "ff.assemble"} <= _names(ranges)
    assert not _self_nested(ranges)
    assert len(out) == len(ranking)


def _tiny_checkpoint(target):
    """A two-layer BERT checkpoint with a hand-written vocabulary
    (``tests/test_torch_encoder.py``'s recipe, no download)."""
    from transformers import BertConfig, BertModel, BertTokenizer

    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "[Q]", "[D]", "ab", "abc", "cab"]
    target.mkdir(parents=True, exist_ok=True)
    (target / "vocab.txt").write_text("\n".join(vocab))
    BertTokenizer(str(target / "vocab.txt")).save_pretrained(target)
    torch.manual_seed(5)
    BertModel(
        BertConfig(
            vocab_size=len(vocab), hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64, max_position_embeddings=64,
        )
    ).eval().save_pretrained(target)
    return target


def test_the_encoder_names_each_micro_batch(tmp_path):
    from fastforward_tpu_torch.encoder import TCTColBERTQueryEncoder

    encoder = TCTColBERTQueryEncoder(
        str(_tiny_checkpoint(tmp_path / "bert")), device="cpu", max_length=12
    )
    index = InMemoryIndex(encoder, mode=Mode.PASSAGE, encoder_batch_size=2, device="cpu")
    texts = ["ab", "abc cab", "cab", "ab ab", "abc"]
    vectors, ranges = _traced(lambda: index.encode_queries(texts))
    assert vectors.shape == (5, 32)
    encodes = [r for r in ranges if r[0] == "ff.encode"]
    assert len(encodes) == 1
    for name in ("ff.tokenize", "ff.tower"):
        mine = sorted(r for r in ranges if r[0] == name)
        assert len(mine) == 3, name  # micro-batches of 2, 2 and 1
        assert all(_inside(r, encodes[0]) for r in mine), name
    # each micro-batch tokenizes, then runs the tower
    tok = sorted(r[1:] for r in ranges if r[0] == "ff.tokenize")
    tower = sorted(r[1:] for r in ranges if r[0] == "ff.tower")
    assert all(t[1] <= w[0] for t, w in zip(tok, tower))
    np.testing.assert_array_equal(vectors, index.encode_queries(texts))


def _es_call(index, ranking):
    return index(ranking, early_stopping=5, early_stopping_alpha=0.5,
                 early_stopping_depths=(8, 16, 32))


#: every path of a re-rank or serve call, on a fresh frame
PATHS = {
    "passage": (_passage_index, lambda i, r: i(r)),
    "passage-batches": (_passage_index, lambda i, r: i(r, batch_size=3)),
    "passage-early-stopping": (_passage_index, _es_call),
    "passage-serve": (_passage_index, lambda i, r: i.serve(r, alpha=0.5, cutoff=5)),
    "passage-submit": (_passage_index, lambda i, r: i.submit(r).result()),
    "maxp-flat": (_document_index, lambda i, r: i(r)),
    "maxp-flat-batches": (_document_index, lambda i, r: i(r, batch_size=1)),
    "maxp-flat-early-stopping": (_document_index, _es_call),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_no_range_opens_inside_a_range_of_its_own_name(path):
    build, call = PATHS[path]
    index, ranking = build()
    for _ in range(2):  # a fresh frame, then its plan
        _, ranges = _traced(lambda: call(index, ranking))
        assert ranges, path
        assert not _self_nested(ranges), path


def test_an_environment_trace_directory_writes_nothing(tmp_path, monkeypatch):
    out = tmp_path / "traces"
    out.mkdir()
    monkeypatch.setenv("FFTPU_TRACE_DIR", str(out))
    index, ranking = _passage_index()
    index(ranking)
    index(ranking)
    assert not any(out.iterdir())
