"""The plain reference: what a re-rank must give.

Plain PyTorch, written from the published description of the pieces:
BERT's forward pass (Devlin et al., 2019) with TCT-ColBERT's query template
and mean pooling over tokens 4 and on (Lin et al., 2021), dot-product
semantic scores and MaxP over a document's passages (Leonhardt et al.,
2022).  It imports nothing of the
program: it takes the seeded weights the harness made and makes the corpus
rows again itself (``data.py``).

``precision`` picks the arithmetic: ``"float64"`` is the reference proper;
``"tf32"`` is the control, fp32 with every matmul's operands rounded to
TF32 (10-bit mantissa), the precision just below the configuration's fp32.
The rounding is done by hand on every device (cuBLAS keeps a
matrix-vector product in fp32 even with TF32 allowed), and on the card
cuBLAS may use TF32 as well, which rounds the same operands again to the
same values.
"""

import contextlib
import math

import numpy as np
import torch

from bench_port import data


@contextlib.contextmanager
def matmul_precision(precision: str, device: torch.device):
    """TF32 on for the control on the card, off for everything else."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    tf32 = precision == "tf32" and device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _dtype(precision: str) -> torch.dtype:
    if precision not in ("float64", "tf32"):
        raise ValueError(f"precision must be 'float64' or 'tf32', got {precision!r}")
    return torch.float64 if precision == "float64" else torch.float32


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to TF32's 10-bit mantissa (to nearest, ties away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` in the reference's precision."""
    if precision == "tf32":
        a, b = round_tf32(a), round_tf32(b)
    return a @ b


# -- the query tower -----------------------------------------------------------


def tokenize(texts: list, vocab: list, length: int) -> torch.Tensor:
    """Token ids of TCT-ColBERT's query template ``[CLS] [Q] <query>
    [MASK]*length`` cut to ``length``: ``[Q]`` splits into ``[``, ``q``,
    ``]`` as BERT's tokenizer splits punctuation, and each query word is a
    whole vocabulary entry."""
    index = {tok: i for i, tok in enumerate(vocab)}
    head = [index["[CLS]"], index["["], index["q"], index["]"]]
    out = np.full((len(texts), length), index["[MASK]"], dtype=np.int64)
    for row, text in enumerate(texts):
        ids = (head + [index[w] for w in text.split()])[:length]
        out[row, : len(ids)] = ids
    return torch.from_numpy(out)


def _layer_norm(x, w, b, eps):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def bert_hidden(ids: torch.Tensor, weights: dict, tower: dict, precision: str) -> torch.Tensor:
    """BERT's last hidden state for token ids with no padding, ``(B, L, H)``."""
    dt = _dtype(precision)
    device = ids.device
    w = {k: v.to(device=device, dtype=dt) for k, v in weights.items()}
    h, heads = tower["hidden_size"], tower["num_attention_heads"]
    d = h // heads
    eps = tower["layer_norm_eps"]
    b, length = ids.shape

    def linear(x, name):
        return _mm(x, w[name + ".weight"].T, precision) + w[name + ".bias"]

    x = (w["embeddings.word_embeddings.weight"][ids]
         + w["embeddings.position_embeddings.weight"][:length][None]
         + w["embeddings.token_type_embeddings.weight"][0])
    x = _layer_norm(x, w["embeddings.LayerNorm.weight"], w["embeddings.LayerNorm.bias"], eps)
    for j in range(tower["num_hidden_layers"]):
        pre = f"encoder.layer.{j}."

        def split(t):
            return t.view(b, length, heads, d).transpose(1, 2)

        q = split(linear(x, pre + "attention.self.query"))
        k = split(linear(x, pre + "attention.self.key"))
        v = split(linear(x, pre + "attention.self.value"))
        att = torch.softmax(_mm(q, k.transpose(-1, -2), precision) / math.sqrt(d), dim=-1)
        ctx = _mm(att, v, precision).transpose(1, 2).reshape(b, length, h)
        x = _layer_norm(x + linear(ctx, pre + "attention.output.dense"),
                        w[pre + "attention.output.LayerNorm.weight"],
                        w[pre + "attention.output.LayerNorm.bias"], eps)
        inner = linear(x, pre + "intermediate.dense")
        inner = 0.5 * inner * (1.0 + torch.erf(inner / math.sqrt(2.0)))
        x = _layer_norm(x + linear(inner, pre + "output.dense"),
                        w[pre + "output.LayerNorm.weight"], w[pre + "output.LayerNorm.bias"], eps)
    return x


def encode_queries(texts: list, weights: dict, tower: dict, vocab: list, length: int,
                   precision: str, device, block: int = 64) -> torch.Tensor:
    """TCT-ColBERT query vectors: mean of the last hidden state over tokens
    4 and on, in blocks of ``block`` queries."""
    parts = []
    with matmul_precision(precision, torch.device(device)):
        for i in range(0, len(texts), block):
            ids = tokenize(texts[i : i + block], vocab, length).to(device)
            parts.append(bert_hidden(ids, weights, tower, precision)[:, 4:].mean(dim=1))
    return torch.cat(parts)


# -- scores --------------------------------------------------------------------


def semantic_scores(qvecs: torch.Tensor, rows: torch.Tensor, owner: np.ndarray,
                    precision: str) -> torch.Tensor:
    """``qvecs[owner[i]] . rows[i]`` for every row, in the precision."""
    dt = _dtype(precision)
    q = qvecs.to(dt)
    r = rows.to(dt)
    own = torch.from_numpy(np.asarray(owner, dtype=np.int64)).to(rows.device)
    with matmul_precision(precision, rows.device):
        if precision == "float64":
            return (q[own] * r).sum(dim=1)
        out = torch.empty(r.shape[0], dtype=dt, device=rows.device)
        for qi in torch.unique(own).tolist():
            where = own == qi
            out[where] = _mm(r[where], q[qi][:, None], precision)[:, 0]
        return out


def max_per_document(scores: torch.Tensor, counts: np.ndarray) -> torch.Tensor:
    """MaxP: each document's score is its best passage's."""
    seg = torch.from_numpy(np.repeat(np.arange(counts.size), counts)).to(scores.device)
    out = torch.full((counts.size,), -math.inf, dtype=scores.dtype, device=scores.device)
    return out.scatter_reduce(0, seg, scores, reduce="amax")


def candidate_scores(seed: int, config: dict, qvecs: torch.Tensor, cands: list,
                     precision: str, device) -> list:
    """Each query's semantic score of each of its candidates (MaxP for
    documents), ``float64`` numpy; ``cands[i]`` belongs to ``qvecs[i]``.
    The rows of all queries are made again in one pass over the corpus."""
    docs = data.corpus_layout(seed, config)
    parts = []
    for c in cands:
        if docs is None:
            parts.append((np.asarray(c, dtype=np.int64), np.ones(len(c), dtype=np.int64)))
        else:
            parts.append(docs.rows_of(np.asarray(c, dtype=np.int64)))
    n_rows = int(config["passages"])
    all_rows = np.concatenate([p[0] for p in parts])
    query_of = np.concatenate([np.full(p[0].size, i) for i, p in enumerate(parts)])
    rows = data.gather_corpus(seed, all_rows, n_rows, config["dim"], device)
    sem = semantic_scores(qvecs.to(device), rows, query_of, precision)
    out, at = [], 0
    for rows_i, counts_i in parts:
        piece = sem[at : at + rows_i.size]
        at += rows_i.size
        if docs is not None:
            piece = max_per_document(piece, counts_i)
        out.append(piece.double().cpu().numpy())
    return out
