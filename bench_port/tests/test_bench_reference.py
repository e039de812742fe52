"""The plain reference against brute force in float64 at a tiny size."""

import math

import numpy as np
import torch

from bench_port import data, reference
from bench_port.tests.conftest import TINY_TOWER

SEED = 987654321


def _gelu(x):
    return 0.5 * x * (1.0 + np.vectorize(math.erf)(x / math.sqrt(2.0)))


def _ln(x, w, b, eps):
    mu = x.mean(-1, keepdims=True)
    return (x - mu) / np.sqrt(((x - mu) ** 2).mean(-1, keepdims=True) + eps) * w + b


def _bert_loops(ids: np.ndarray, w: dict, t: dict) -> np.ndarray:
    """BERT's forward pass one sequence, one head at a time, in float64 numpy."""
    w = {k: v.double().numpy() for k, v in w.items()}
    h, nh = t["hidden_size"], t["num_attention_heads"]
    d, eps = h // nh, t["layer_norm_eps"]
    out = []
    for seq in ids:
        x = np.stack([w["embeddings.word_embeddings.weight"][i] + w["embeddings.position_embeddings.weight"][p]
                      + w["embeddings.token_type_embeddings.weight"][0] for p, i in enumerate(seq)])
        x = _ln(x, w["embeddings.LayerNorm.weight"], w["embeddings.LayerNorm.bias"], eps)
        for j in range(t["num_hidden_layers"]):
            p = f"encoder.layer.{j}."

            def lin(v, n):
                return v @ w[p + n + ".weight"].T + w[p + n + ".bias"]

            q, k, v = (lin(x, "attention.self." + n) for n in ("query", "key", "value"))
            ctx = np.zeros_like(x)
            for head in range(nh):
                s = slice(head * d, (head + 1) * d)
                logits = q[:, s] @ k[:, s].T / math.sqrt(d)
                att = np.exp(logits - logits.max(-1, keepdims=True))
                ctx[:, s] = (att / att.sum(-1, keepdims=True)) @ v[:, s]
            x = _ln(x + lin(ctx, "attention.output.dense"), w[p + "attention.output.LayerNorm.weight"],
                    w[p + "attention.output.LayerNorm.bias"], eps)
            x = _ln(x + lin(_gelu(lin(x, "intermediate.dense")), "output.dense"),
                    w[p + "output.LayerNorm.weight"], w[p + "output.LayerNorm.bias"], eps)
        out.append(x)
    return np.stack(out)


def test_query_tower_against_loops():
    weights = data.tower_weights(SEED, TINY_TOWER, "cpu")
    vocab = data.vocabulary(TINY_TOWER["vocab_size"])
    texts = ["w1 w2 w3", "w400 w9 w9 w9 w17 w23 w100 w200 w300 w5 w6 w7 w8 w10 w11"]
    ids = reference.tokenize(texts, vocab, 36)
    want = _bert_loops(ids.numpy(), weights, TINY_TOWER)[:, 4:].mean(axis=1)
    got = reference.encode_queries(texts, weights, TINY_TOWER, vocab, 36, "float64", "cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    control = reference.encode_queries(texts, weights, TINY_TOWER, vocab, 36, "tf32", "cpu").numpy()
    gap = np.abs(control - want).max() / np.abs(want).max()
    assert 1e-5 < gap < 1e-1  # TF32's 10-bit mantissa, not fp32's


def test_tokenizer_matches_berts():
    from transformers import BertTokenizer

    vocab = data.vocabulary(TINY_TOWER["vocab_size"])
    texts = ["w1 w2", "w3 w4 w5 w6 w7 w8 w9 w10 w11 w12 w13 w14 w15 w16 w17", "w500"]
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / "vocab.txt").write_text("\n".join(vocab))
        tok = BertTokenizer(str(Path(tmp) / "vocab.txt"))
        got = tok(["[CLS] [Q] " + t + "[MASK]" * 36 for t in texts], max_length=36, truncation=True,
                  add_special_tokens=False, padding=True, return_tensors="np")["input_ids"]
    assert np.array_equal(got, reference.tokenize(texts, vocab, 36).numpy())


def test_scores_and_maxp_against_brute_force():
    n, dim = 3000, 16
    docs = data.documents(SEED, 700, 2800)
    config = {"mode": "maxp", "documents": 700, "passages": 2800, "dim": dim}
    q = torch.randn(2, dim, dtype=torch.float64)
    cands = [np.array([5, 0, 699]), np.array([10, 11])]
    got = reference.candidate_scores(SEED, config, q, cands, "float64", "cpu")
    corpus = data.corpus_rows(SEED, 0, docs.n_rows, docs.n_rows, dim, "cpu").double().numpy()
    for qi, cs in enumerate(cands):
        want = [max(corpus[r] @ q[qi].numpy() for r in range(docs.starts[c], docs.starts[c] + docs.counts[c]))
                for c in cs]
        np.testing.assert_allclose(got[qi], want, rtol=1e-12)
    pconfig = {"mode": "passage", "passages": n, "dim": dim}
    got = reference.candidate_scores(SEED, pconfig, q, [np.array([2999, 4])], "float64", "cpu")[0]
    rows = data.corpus_rows(SEED, 0, n, n, dim, "cpu").double().numpy()
    np.testing.assert_allclose(got, [rows[2999] @ q[0].numpy(), rows[4] @ q[0].numpy()], rtol=1e-12)


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-12, 1.0 + 2**-11 + 2**-13, -3.0])
    assert reference.round_tf32(x).tolist() == [1.0 + 2**-10, 1.0, 1.0 + 2**-10, -3.0]
