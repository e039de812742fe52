"""The port's transformer encoders against the JAX package's on the CPU.

A tiny BERT checkpoint and a tiny DistilBERT checkpoint are built in a
temporary directory (``tests/test_encoder.py``'s recipe; no download), and
each of the five encoders of either package reads the same files.  The
same texts go through both; the outputs agree within the JAX package's
own fp32 tolerance against torch (atol 2e-4, rtol 1e-3,
``tests/test_encoder.py``), and in bf16 within eight bf16 steps at the
outputs' largest magnitude (see ``tests/test_torch_models.py``).

The golden test runs the published checkpoints only when they are already
in the local Hugging Face cache and ``HF_HUB_OFFLINE=1`` is set; it skips
otherwise and never opens a connection.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from fastforward_tpu.encoder import transformer as jax_transformer
from fastforward_tpu_torch.encoder import transformer

from ._golden_constants import (
    BGE_ENCODER_EXPECTED,
    CONTRIEVER_EXPECTED,
    TAS_B_EXPECTED,
    TCT_COLBERT_DOCUMENT_EXPECTED,
    TCT_COLBERT_QUERY_EXPECTED,
)

TEST_INPUTS = ["ab", "abc cab", "ba " * 40]
TOL = {"atol": 2e-4, "rtol": 1e-3}
VOCAB = (
    ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "[Q]", "[D]"]
    + ["ab", "abc", "cab", "ba", "a", "b", "c"]
    + ["##a", "##b", "##c"]
)


def _build_checkpoint(target: Path, distil: bool) -> Path:
    from transformers import (
        BertConfig,
        BertModel,
        BertTokenizer,
        DistilBertConfig,
        DistilBertModel,
    )

    target.mkdir(parents=True, exist_ok=True)
    (target / "vocab.txt").write_text("\n".join(VOCAB))
    BertTokenizer(str(target / "vocab.txt")).save_pretrained(target)
    torch.manual_seed(5)
    if distil:
        model = DistilBertModel(
            DistilBertConfig(
                vocab_size=len(VOCAB), dim=32, n_layers=2, n_heads=2, hidden_dim=64,
                max_position_embeddings=128,
            )
        )
    else:
        model = BertModel(
            BertConfig(
                vocab_size=len(VOCAB), hidden_size=32, num_hidden_layers=2,
                num_attention_heads=2, intermediate_size=64, max_position_embeddings=128,
            )
        )
    model.eval().save_pretrained(target)
    return target


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny")
    return {
        "bert": _build_checkpoint(root / "bert", distil=False),
        "distilbert": _build_checkpoint(root / "distilbert", distil=True),
    }


#: (class name, checkpoint, constructor arguments) of every encoder
CASES = [
    ("TransformerEncoder", "bert", {}),
    ("TransformerEncoder", "bert", {"normalize": True}),
    ("TCTColBERTQueryEncoder", "bert", {"max_length": 12}),
    ("TCTColBERTDocumentEncoder", "bert", {"max_length": 32}),
    ("TASBEncoder", "distilbert", {}),
    ("ContrieverEncoder", "bert", {}),
    ("BGEEncoder", "bert", {}),
]


def _ids(case):
    name, ckpt, kwargs = case
    return "-".join([name, ckpt, *(f"{k}={v}" for k, v in kwargs.items())])


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_encoder_matches_jax(checkpoints, case):
    name, ckpt, kwargs = case
    want = getattr(jax_transformer, name)(checkpoints[ckpt], **kwargs)(TEST_INPUTS)
    encoder = getattr(transformer, name)(checkpoints[ckpt], device="cpu", **kwargs)
    got = encoder(TEST_INPUTS)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == want.shape == (3, 32)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("ckpt", ["bert", "distilbert"])
def test_bf16_encoder_matches_jax(checkpoints, ckpt):
    want = jax_transformer.TransformerEncoder(
        checkpoints[ckpt], compute_dtype="bfloat16"
    )(TEST_INPUTS)
    encoder = transformer.TransformerEncoder(
        checkpoints[ckpt], device="cpu", compute_dtype="bfloat16"
    )
    assert encoder.config.dtype == "bfloat16"
    np.testing.assert_allclose(
        encoder(TEST_INPUTS), want, atol=8 * 2.0**-8 * np.abs(want).max(), rtol=0
    )


def test_tct_query_matches_transformers(checkpoints):
    """``tests/test_encoder.py``'s TCT query check, on the port: the
    template, the exact tokenizer length and the unmasked mean from token
    4 against transformers' own forward."""
    from transformers import AutoModel, AutoTokenizer

    encoder = transformer.TCTColBERTQueryEncoder(checkpoints["bert"], device="cpu", max_length=12)
    tokenizer = AutoTokenizer.from_pretrained(checkpoints["bert"])
    model = AutoModel.from_pretrained(checkpoints["bert"]).eval()
    templated = ["[CLS] [Q] " + q + "[MASK]" * 12 for q in TEST_INPUTS]
    inputs = tokenizer(
        templated, return_tensors="pt", max_length=12, truncation=True, add_special_tokens=False
    )
    with torch.no_grad():
        hidden = model(**inputs).last_hidden_state.numpy()
    np.testing.assert_allclose(encoder(TEST_INPUTS), hidden[:, 4:].mean(axis=1), **TOL)


@pytest.mark.parametrize(
    "name", ["TCTColBERTQueryEncoder", "TCTColBERTDocumentEncoder", "TransformerEncoder"]
)
def test_templates_match_jax(checkpoints, name):
    port = getattr(transformer, name)(checkpoints["bert"], device="cpu")
    jax_enc = getattr(jax_transformer, name)(checkpoints["bert"])
    texts = ["a query", "ba"]
    assert port._get_tokenizer_inputs(texts) == jax_enc._get_tokenizer_inputs(texts)
    assert port._tokenizer_call_args == jax_enc._tokenizer_call_args
    assert port._pooling == jax_enc._pooling


@pytest.mark.parametrize("name", ["TransformerEncoder", "ContrieverEncoder", "TCTColBERTDocumentEncoder"])
def test_bucketing_invariance(checkpoints, name):
    """The same embeddings whether texts are batched together (padded to
    the longest) or one by one."""
    encoder = getattr(transformer, name)(checkpoints["bert"], device="cpu")
    together = encoder(TEST_INPUTS)
    separate = np.concatenate([encoder([t]) for t in TEST_INPUTS])
    np.testing.assert_allclose(together, separate, **TOL)


def test_index_encodes_queries_with_the_tower(checkpoints):
    """A port index re-ranks with a transformer encoder as its query
    encoder: its scores are the dots of the encoder's own vectors."""
    from fastforward_tpu_torch.index import InMemoryIndex, Mode
    from fastforward_tpu_torch.ranking import Ranking

    encoder = transformer.TCTColBERTQueryEncoder(checkpoints["bert"], device="cpu", max_length=12)
    rng = np.random.default_rng(0)
    vectors = rng.standard_normal((40, 32), dtype=np.float32)
    index = InMemoryIndex(encoder, mode=Mode.PASSAGE, device="cpu", encoder_batch_size=2)
    index.add(vectors, psg_ids=[f"p{i}" for i in range(40)])
    queries = {"q1": "ab", "q2": "abc cab", "q3": "ba ba"}
    run = {q: {f"p{j}": float(-j) for j in rng.choice(40, 10, replace=False)} for q in queries}
    result = index(Ranking.from_run(run, queries=queries))
    qvecs = dict(zip(queries, encoder(list(queries.values()))))
    for q, cands in run.items():
        for pid in cands:
            want = float(vectors[int(pid[1:])] @ qvecs[q])
            assert result[q][pid] == pytest.approx(want, rel=1e-5, abs=1e-5)


def test_encoder_runs_on_the_card_unless_asked_otherwise(checkpoints):
    if torch.cuda.is_available():
        assert transformer.TransformerEncoder(checkpoints["bert"]).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            transformer.TransformerEncoder(checkpoints["bert"])
    with pytest.raises(ValueError, match="compute_dtype"):
        transformer.TransformerEncoder(checkpoints["bert"], device="cpu", compute_dtype="fp16")


def test_lazy_exports():
    import fastforward_tpu_torch.encoder as enc

    assert enc.TCTColBERTQueryEncoder is transformer.TCTColBERTQueryEncoder
    with pytest.raises(AttributeError):
        enc.NoSuchEncoder  # noqa: B018


GOLDEN = {
    "TCTColBERTQueryEncoder": ("castorini/tct_colbert-msmarco", TCT_COLBERT_QUERY_EXPECTED),
    "TCTColBERTDocumentEncoder": ("castorini/tct_colbert-msmarco", TCT_COLBERT_DOCUMENT_EXPECTED),
    "TASBEncoder": ("sebastian-hofstaetter/distilbert-dot-tas_b-b256-msmarco", TAS_B_EXPECTED),
    "ContrieverEncoder": ("facebook/contriever", CONTRIEVER_EXPECTED),
    "BGEEncoder": ("BAAI/bge-base-en-v1.5", BGE_ENCODER_EXPECTED),
}


@pytest.mark.parametrize("name", list(GOLDEN))
def test_golden_checkpoint(name):
    """The reference's golden vectors (``tests/_golden_constants.py``,
    decimal 4 as ``tests/test_encoder_golden.py``) from the published
    checkpoint, when it is already cached locally."""
    if os.environ.get("HF_HUB_OFFLINE") != "1":
        pytest.skip("set HF_HUB_OFFLINE=1 with the checkpoint in the local cache")
    from huggingface_hub import try_to_load_from_cache

    repo, expected = GOLDEN[name]
    if not isinstance(try_to_load_from_cache(repo, "config.json"), str):
        pytest.skip(f"{repo} is not in the local Hugging Face cache")
    encoder = getattr(transformer, name)(repo, device="cpu")
    np.testing.assert_almost_equal(
        encoder(["input 1", "second input", "3rd input " * 100]), expected, decimal=4
    )
