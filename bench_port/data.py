"""Seeded inputs of the benchmark: corpus rows, documents, query texts and
vectors, candidate runs and the query tower's weights.

Everything here is a function of ``--seed`` and of the configuration's and
the traffic's numbers, and imports nothing of the program, so that the
plain reference (``reference.py``) can make the same inputs again.

Corpus rows come in fixed blocks of :data:`BLOCK_ROWS`, each from a
generator of its own, so any range of rows can be made again on demand and
a chunked build equals a one-shot one.
"""

from dataclasses import dataclass

import numpy as np
import torch

#: rows of one corpus block (one generator each)
BLOCK_ROWS = 1 << 16

#: the query tower's vocabulary: BERT's special tokens, the pieces the
#: TCT-ColBERT template ``[CLS] [Q] <query>`` splits into, then plain words
SPECIAL_TOKENS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "[", "]", "q", "d")

# stream tags: each kind of input draws from its own generator
_CORPUS, _DOCS, _QUERIES, _CANDIDATES, _QVECS, _TOWER = range(6)
_SAMPLE = 7


def stream_seed(seed: int, *key: int) -> int:
    """A 63-bit generator seed for one stream of inputs of ``seed``."""
    entropy = [int(seed) % (1 << 64), *(int(k) for k in key)]
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]) >> 1


def numpy_rng(seed: int, *key: int) -> np.random.Generator:
    """A numpy generator for one stream of inputs of ``seed``."""
    return np.random.default_rng(stream_seed(seed, *key))


def sample_rng(seed: int) -> np.random.Generator:
    """The generator that draws the answers the check compares."""
    return numpy_rng(seed, _SAMPLE)


# -- corpus --------------------------------------------------------------------


def corpus_block(seed: int, block: int, n_rows: int, dim: int, device) -> torch.Tensor:
    """Rows ``[block * BLOCK_ROWS, ...)`` of the corpus, standard normal fp32."""
    lo = block * BLOCK_ROWS
    hi = min(n_rows, lo + BLOCK_ROWS)
    if not 0 <= lo < hi:
        raise ValueError(f"block {block} lies outside a corpus of {n_rows} rows")
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, _CORPUS, block))
    return torch.randn((hi - lo, dim), generator=gen, device=device, dtype=torch.float32)


def corpus_rows(seed: int, lo: int, hi: int, n_rows: int, dim: int, device) -> torch.Tensor:
    """Corpus rows ``[lo, hi)``, made again from their blocks."""
    if not 0 <= lo <= hi <= n_rows:
        raise ValueError(f"rows [{lo}, {hi}) lie outside a corpus of {n_rows} rows")
    if lo == hi:
        return torch.empty((0, dim), device=device)
    first, last = lo // BLOCK_ROWS, (hi - 1) // BLOCK_ROWS
    parts = [corpus_block(seed, b, n_rows, dim, device) for b in range(first, last + 1)]
    whole = parts[0] if len(parts) == 1 else torch.cat(parts)
    start = first * BLOCK_ROWS
    return whole[lo - start : hi - start]


def gather_corpus(seed: int, rows: np.ndarray, n_rows: int, dim: int, device) -> torch.Tensor:
    """The corpus rows at ``rows`` (any order, repeats allowed), each block
    that holds one of them made once."""
    rows = np.asarray(rows, dtype=np.int64)
    if rows.size and (rows.min() < 0 or rows.max() >= n_rows):
        raise ValueError("a row lies outside the corpus")
    out = torch.empty((rows.size, dim), device=device)
    blocks = rows // BLOCK_ROWS
    for block in np.unique(blocks):
        where = np.flatnonzero(blocks == block)
        local = torch.from_numpy(rows[where] - block * BLOCK_ROWS).to(device)
        out[torch.from_numpy(where).to(device)] = corpus_block(seed, int(block), n_rows, dim, device)[local]
    return out


# -- documents -----------------------------------------------------------------


@dataclass(frozen=True)
class Documents:
    """Passages per document (documents hold consecutive corpus rows)."""

    counts: np.ndarray  # passages of each document
    starts: np.ndarray  # first corpus row of each document

    @property
    def n_rows(self) -> int:
        return int(self.counts.sum())

    def rows_of(self, docs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """The corpus rows of ``docs`` concatenated, and each document's count."""
        counts = self.counts[docs]
        starts = self.starts[docs]
        offsets = np.arange(counts.sum()) - np.repeat(np.cumsum(counts) - counts, counts)
        return np.repeat(starts, counts) + offsets, counts


def documents(seed: int, n_docs: int, n_rows: int) -> Documents:
    """``n_docs`` documents of ``n_rows`` passages in all: each document's
    count drawn geometric (at least 1) with the mean ``n_rows / n_docs``,
    then moved by one passage in documents drawn at random until the counts
    add up to ``n_rows`` exactly."""
    if not 0 < n_docs <= n_rows:
        raise ValueError(f"{n_rows} passages cannot fill {n_docs} documents")
    rng = numpy_rng(seed, _DOCS)
    counts = rng.geometric(n_docs / n_rows, size=n_docs).astype(np.int64)
    gap = n_rows - int(counts.sum())
    while gap:
        # a passage more in ``gap`` documents, or one less in documents of
        # more than one passage, without repeats in one round
        pick = np.flatnonzero(counts > 1) if gap < 0 else np.arange(n_docs)
        pick = rng.choice(pick, size=min(abs(gap), pick.size), replace=False)
        counts[pick] += 1 if gap > 0 else -1
        gap = n_rows - int(counts.sum())
    starts = np.cumsum(counts) - counts
    return Documents(counts, starts)


def corpus_layout(seed: int, config: dict) -> "Documents | None":
    """The configuration's documents (``None`` for a passage corpus)."""
    if config["mode"] == "passage":
        return None
    return documents(seed, config["documents"], config["passages"])


def id_prefix(config: dict) -> str:
    """The first letter of the configuration's IDs: ``p<row>``, ``d<doc>``."""
    return "p" if config["mode"] == "passage" else "d"


def n_targets(config: dict) -> int:
    """What a candidate names: passages, or documents."""
    return config["passages"] if config["mode"] == "passage" else config["documents"]


def id_strings(prefix: str, numbers: np.ndarray) -> np.ndarray:
    """IDs ``<prefix><n>`` as a fixed-width bytes array."""
    return np.char.add(prefix.encode(), np.asarray(numbers).astype("S"))


# -- queries and candidates ----------------------------------------------------


def vocabulary(size: int) -> list[str]:
    """The tower's vocabulary: the special tokens, then words ``w<n>``."""
    return list(SPECIAL_TOKENS) + [f"w{i}" for i in range(size - len(SPECIAL_TOKENS))]


@dataclass(frozen=True)
class Queries:
    """A pool of distinct queries: IDs, texts and candidate numbers."""

    q_ids: list  # str, distinct over the pool
    texts: list  # str
    candidates: np.ndarray  # (queries, depth) int64: corpus rows or documents, distinct per query


def queries(seed: int, stream: int, n_queries: int, words: tuple, vocab_size: int,
            n_targets: int, depth: int) -> Queries:
    """``n_queries`` queries of ``words[0]..words[1]`` words drawn from the
    vocabulary, each with ``depth`` distinct candidates out of ``n_targets``
    drawn uniformly; ``stream`` keeps pools of one seed apart."""
    rng = numpy_rng(seed, _QUERIES, stream)
    n_words = rng.integers(words[0], words[1] + 1, size=n_queries)
    picks = rng.integers(0, vocab_size - len(SPECIAL_TOKENS), size=(n_queries, words[1]))
    texts = [" ".join(f"w{w}" for w in row[:n]) for row, n in zip(picks, n_words)]
    q_ids = [f"{stream}.{i}" for i in range(n_queries)]
    return Queries(q_ids, texts, candidate_sets(seed, stream, n_queries, n_targets, depth))


def candidate_sets(seed: int, stream: int, n_queries: int, n_targets: int, depth: int) -> np.ndarray:
    """``depth`` distinct targets a query, uniform over ``n_targets``: one
    bulk draw, and only the rare query with a repeat drawn again."""
    if depth > n_targets:
        raise ValueError(f"depth {depth} exceeds the {n_targets} candidates")
    rng = numpy_rng(seed, _CANDIDATES, stream)
    cand = rng.integers(0, n_targets, size=(n_queries, depth))
    ordered = np.sort(cand, axis=1)
    for q in np.flatnonzero((ordered[:, 1:] == ordered[:, :-1]).any(axis=1)):
        cand[q] = rng.choice(n_targets, size=depth, replace=False)
    return cand


def query_vectors(seed: int, texts: list, dim: int) -> dict:
    """Pre-encoded queries: one standard normal fp32 vector per distinct text."""
    unique = sorted(set(texts))
    vecs = numpy_rng(seed, _QVECS).standard_normal((len(unique), dim), dtype=np.float32)
    return dict(zip(unique, vecs))


# -- the query tower -----------------------------------------------------------


def tower_shapes(tower: dict) -> dict:
    """Parameter name -> shape of a BERT tower, in transformers' names."""
    h, i, n = tower["hidden_size"], tower["intermediate_size"], tower["num_hidden_layers"]
    shapes = {
        "embeddings.word_embeddings.weight": (tower["vocab_size"], h),
        "embeddings.position_embeddings.weight": (tower["max_position_embeddings"], h),
        "embeddings.token_type_embeddings.weight": (tower["type_vocab_size"], h),
        "embeddings.LayerNorm.weight": (h,),
        "embeddings.LayerNorm.bias": (h,),
    }
    layer = {
        "attention.self.query": (h, h), "attention.self.key": (h, h),
        "attention.self.value": (h, h), "attention.output.dense": (h, h),
        "intermediate.dense": (i, h), "output.dense": (h, i),
    }  # fmt: skip
    for j in range(n):
        pre = f"encoder.layer.{j}."
        for name, (out, inp) in layer.items():
            shapes[f"{pre}{name}.weight"] = (out, inp)
            shapes[f"{pre}{name}.bias"] = (out,)
        for norm in ("attention.output.LayerNorm", "output.LayerNorm"):
            shapes[f"{pre}{norm}.weight"] = (h,)
            shapes[f"{pre}{norm}.bias"] = (h,)
    return shapes


def tower_weights(seed: int, tower: dict, device) -> dict:
    """The tower's weights from the seed, made in one call on ``device``:
    every matrix, bias and embedding N(0, 0.02^2) (BERT's initializer
    range), layer-norm scales 1 + N(0, 0.02^2), biases N(0, 0.02^2)."""
    shapes = tower_shapes(tower)
    total = sum(int(np.prod(s)) for s in shapes.values())
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, _TOWER))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32).mul_(0.02)
    out, at = {}, 0
    for name, shape in shapes.items():
        size = int(np.prod(shape))
        out[name] = flat[at : at + size].view(shape)
        if "LayerNorm.weight" in name:
            out[name].add_(1.0)
        at += size
    return out
