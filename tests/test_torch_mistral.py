"""The port's Mistral decoder tower and ``E5MistralEncoder`` on the CPU.

At ``MistralConfig.tiny()`` sizes (hidden 64, 2 layers, 4 query and 2
key/value heads of 16, FFN 128, window 8) on seeded weights, the tower is
compared with the plain reference (``tests/plain_mistral.py``, float64,
one unpadded sequence at a time) and with transformers' own
``MistralModel`` (fp32, eager attention) on the same weights, under right
padding of mixed lengths, sequences longer than the window and several
key/value groupings.  The encoder is checked for its template, BOS and
EOS, last-token pooling and normalization, and through
``InMemoryIndex``'s ``Index.__call__``.  No JAX: the JAX package has no
decoder.
"""

import math

import numpy as np
import pytest
import torch

from fastforward_tpu_torch.encoder import transformer
from fastforward_tpu_torch.encoder.transformer import E5_WEB_SEARCH_TASK, E5MistralEncoder
from fastforward_tpu_torch.models import mistral

from . import plain_mistral

#: fp32 against float64: a few fp32 roundings (2^-24) a product, summed
#: over 64-128 terms and two layers, stay under 1e-6 of the outputs'
#: largest magnitude; 1e-5 leaves ten times that
FP32_TOL = 1e-5
#: bf16 against float64: bf16 keeps 8 significant bits (a step of 2^-8,
#: 0.39%), and the residual stream and every projection round to it once a
#: block (1.4% of the largest magnitude here); 4% is ten such steps.  fp8
#: e4m3 operands keep 4 bits (a step of 6.25%) and land at 13%
BF16_TOL = 0.04

LENGTHS = [20, 5, 13]  # right-padded to 20; 20 and 13 pass the window of 8
TEMPLATE = f"Instruct: {E5_WEB_SEARCH_TASK}\nQuery: "
SPECIALS = ["<unk>", "<s>", "</s>"]


def _hf_config(cfg: mistral.MistralConfig):
    from transformers import MistralConfig as HFMistralConfig

    return HFMistralConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size, intermediate_size=cfg.intermediate_size,
        num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
        num_key_value_heads=cfg.num_kv_heads, head_dim=cfg.head_dim, rms_norm_eps=cfg.rms_norm_eps,
        rope_theta=cfg.rope_theta, sliding_window=cfg.sliding_window, attn_implementation="eager",
    )


def _plain_config(cfg: mistral.MistralConfig) -> dict:
    return {"num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
            "rms_norm_eps": cfg.rms_norm_eps, "rope_theta": cfg.rope_theta,
            "sliding_window": cfg.sliding_window}


def _hf_model(cfg: mistral.MistralConfig, seed: int = 3):
    """transformers' ``MistralModel`` on seeded weights: embeddings N(0, 1),
    matrices N(0, 0.15^2) (so the attention is far from uniform), norm
    gains 1 + N(0, 0.1^2)."""
    from transformers import MistralModel

    model = MistralModel(_hf_config(cfg)).eval()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.randn(p.shape, generator=gen)
            if name.endswith("norm.weight"):
                p.copy_(1 + 0.1 * noise)
            else:
                p.copy_(noise if name.startswith("embed") else 0.15 * noise)
    return model


def _batch(cfg, lengths=LENGTHS, seed=4):
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, cfg.vocab_size, (len(lengths), max(lengths)), generator=gen)
    mask = torch.zeros_like(ids)
    for row, n in enumerate(lengths):
        mask[row, :n] = 1
    return ids, mask


def _plain(model, cfg, ids, mask, operands=None):
    return [plain_mistral.hidden(ids[r, : int(mask[r].sum())], model.state_dict(), _plain_config(cfg),
                                 operands=operands) for r in range(ids.shape[0])]


def _worst(got, want) -> float:
    """The largest gap over the real positions, over the largest magnitude."""
    return max(float((g[: w.shape[0]].double() - w).abs().max() / w.abs().max()) for g, w in zip(got, want))


@pytest.mark.parametrize("kv_heads", [1, 2, 4], ids=lambda k: f"kv{k}")
@pytest.mark.parametrize("against", ["plain", "transformers"])
def test_the_tower_matches_the_references_in_fp32(kv_heads, against):
    """Mixed lengths under right padding, the window of 8 passed, query
    heads grouped 4, 2 and 1 to a key/value head."""
    cfg = mistral.MistralConfig.tiny()
    cfg = mistral.MistralConfig(**{**cfg.__dict__, "num_kv_heads": kv_heads})
    model = _hf_model(cfg)
    ids, mask = _batch(cfg)
    tower = mistral.from_hf_torch(model, "float32")
    with torch.no_grad():
        got = tower(ids, mask)
        if against == "plain":
            want = _plain(model, cfg, ids, mask)
        else:
            hidden = model(input_ids=ids, attention_mask=mask).last_hidden_state
            want = [hidden[r, : int(mask[r].sum())].double() for r in range(ids.shape[0])]
    assert got.dtype == torch.float32 and got.shape == (3, max(LENGTHS), cfg.hidden_size)
    assert _worst(got, want) < FP32_TOL


def test_the_window_bounds_what_a_query_sees():
    """Positions under the window read the same as without it; the last
    position of a sequence of 20 does not, and each matches the reference."""
    cfg = mistral.MistralConfig.tiny()
    unbounded = mistral.MistralConfig(**{**cfg.__dict__, "sliding_window": None})
    model = _hf_model(cfg)
    ids, mask = _batch(cfg, lengths=[20])
    with torch.no_grad():
        windowed = mistral.from_hf_torch(model, "float32")(ids, mask)[0]
        full = mistral.MistralTower.from_arrays(unbounded, model.state_dict())(ids, mask)[0]
    w = cfg.sliding_window
    assert torch.allclose(windowed[:w], full[:w], atol=1e-6)
    assert (windowed[-1] - full[-1]).abs().max() > 100 * FP32_TOL * full.abs().max()
    ref = plain_mistral.hidden(ids[0], model.state_dict(), _plain_config(unbounded))
    assert float((full.double() - ref).abs().max() / ref.abs().max()) < FP32_TOL


def test_bf16_sits_within_a_bound_that_fp8_operands_exceed():
    cfg = mistral.MistralConfig.tiny()
    model = _hf_model(cfg)
    ids, mask = _batch(cfg)
    want = _plain(model, cfg, ids, mask)
    with torch.no_grad():
        got = mistral.from_hf_torch(model, "bfloat16")(ids, mask)
    fp8 = _plain(model, cfg, ids, mask, operands=plain_mistral.fp8_operand)
    assert _worst(got, want) < BF16_TOL < _worst(fp8, want)


def test_a_tower_shares_the_tensors_it_is_given():
    """bf16 weights handed over in bf16 are held, not copied (a 7B tower is
    never held twice); the norms' gains are held in fp32."""
    cfg = mistral.MistralConfig(**{**mistral.MistralConfig.tiny().__dict__, "dtype": "bfloat16"})
    state = {k: v.to(torch.bfloat16) for k, v in _hf_model(cfg).state_dict().items()}
    tower = mistral.MistralTower.from_arrays(cfg, state)
    assert tower.layers[1].gate.data_ptr() == state["layers.1.mlp.gate_proj.weight"].data_ptr()
    assert tower.embed.data_ptr() == state["embed_tokens.weight"].data_ptr()
    assert tower.layers[0].attn_norm.dtype == torch.float32
    with pytest.raises(ValueError, match="does not fit"):
        mistral.MistralTower.from_arrays(cfg, {**state, "layers.0.self_attn.k_proj.weight": state[
            "layers.0.self_attn.q_proj.weight"]})


def test_last_token_pooling_reads_each_rows_last_real_position():
    hidden = torch.arange(2 * 5 * 3, dtype=torch.float32).view(2, 5, 3)
    mask = torch.tensor([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]])
    assert torch.equal(mistral.pool_last_token(hidden, mask), hidden[[0, 1], [2, 4]])


# -- the fp32 chains between the GEMMs ----------------------------------------------


def _rope_attention_f64(q, k, v, cos, sin, mask, window):
    """The attention of :func:`mistral.rope_attention` as a float64 loop over
    sequences, query heads and positions: RoPE with the given tables, the
    keys a position sees (causal, within the window, not padding), logits
    over ``sqrt(d)``, softmax, context.  A position that sees no key gets
    the mean of v over all keys (the softmax of logits that all read the
    same masked value)."""
    q, k, v, cos, sin = (t.double() for t in (q, k, v, cos, sin))
    b, length, heads, d = q.shape
    group = heads // k.shape[2]

    def rope(t, p):
        return t * cos[p] + torch.cat([-t[d // 2 :], t[: d // 2]]) * sin[p]

    out = torch.zeros(b, length, heads, d, dtype=torch.float64)
    for s in range(b):
        for j in range(heads):
            for p in range(length):
                keys = [t for t in range(p + 1) if mask[s, t] and (window is None or p - t < window)]
                if not keys:
                    out[s, p, j] = v[s, :, j // group].mean(0)
                    continue
                qr = rope(q[s, p, j], p)
                logits = torch.stack([qr @ rope(k[s, t, j // group], t) for t in keys]) / math.sqrt(d)
                out[s, p, j] = torch.softmax(logits, 0) @ v[s, keys, j // group]
    return out.reshape(b, length, heads * d)


@pytest.mark.parametrize("group", [2, 4], ids=lambda g: f"group{g}")
@pytest.mark.parametrize("window", [5, None], ids=lambda w: f"window{w}")
def test_rope_attention_matches_a_float64_loop(group, window):
    """Right padding (lengths 12, 7 and a row of one real token), a window
    shorter than L, 2 and 4 query heads a key/value head: the plain version
    within 1e-5 of float64 (fp32 against float64 on the same tables)."""
    gen = torch.Generator().manual_seed(11)
    b, length, kv, d = 3, 12, 2, 16
    q = torch.randn(b, length, kv * group, d, generator=gen)
    k, v = torch.randn(b, length, kv, d, generator=gen), torch.randn(b, length, kv, d, generator=gen)
    mask = torch.zeros(b, length, dtype=torch.int32)
    for row, n in enumerate([12, 7, 1]):
        mask[row, :n] = 1
    cos, sin = mistral.rope_tables(length, d, 10000.0, "cpu")
    got = mistral.rope_attention(q, k, v, cos, sin, mask, window)
    want = _rope_attention_f64(q, k, v, cos, sin, mask, window)
    assert got.dtype == torch.float32 and got.shape == (b, length, kv * group * d)
    assert float((got.double() - want).abs().max() / want.abs().max()) < FP32_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_swiglu_and_rms_norm_match_float64(dtype):
    """fp32 within 1e-6 of float64; bf16 inputs within one bf16 step of the
    float64 result of the same inputs (the one rounding to bf16)."""
    gen = torch.Generator().manual_seed(12)
    x = (3 * torch.randn(4, 5, 64, generator=gen)).to(dtype)
    gain = 1 + 0.1 * torch.randn(64, generator=gen)
    gate, up = (torch.randn(4, 5, 128, generator=gen).to(dtype) for _ in range(2))
    xd, gd, ud = x.double(), gate.double(), up.double()
    norm = xd / torch.sqrt((xd * xd).mean(-1, keepdim=True) + 1e-5) * gain.double()
    for got, want in ((mistral.swiglu(gate, up), gd * torch.sigmoid(gd) * ud),
                      (mistral.rms_norm(x, gain, 1e-5), norm),
                      (mistral.rms_norm(x, gain, 1e-5, torch.float32), norm)):
        tol = 1e-6 if got.dtype == torch.float32 else 2.0**-8
        assert float((got.double() - want).abs().max() / want.abs().max()) < tol, got.dtype
    assert mistral.swiglu(gate, up).dtype == dtype and mistral.rms_norm(x, gain, 1e-5).dtype == dtype


# -- the encoder -------------------------------------------------------------------


def _vocab(size: int) -> list:
    head = SPECIALS + TEMPLATE.split()
    return head + [f"w{i}" for i in range(size - len(head))]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A tiny E5-Mistral checkpoint: the seeded ``MistralModel`` and a
    word-level tokenizer (the specials at Mistral's ids 0-2)."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    path = tmp_path_factory.mktemp("e5-mistral")
    cfg = mistral.MistralConfig.tiny()
    model = _hf_model(cfg)
    model.save_pretrained(path)
    words = Tokenizer(models.WordLevel({w: i for i, w in enumerate(_vocab(cfg.vocab_size))}, unk_token="<unk>"))
    words.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    PreTrainedTokenizerFast(tokenizer_object=words, unk_token="<unk>", bos_token="<s>",
                            eos_token="</s>").save_pretrained(path)
    return path, model, cfg


TEXTS = ["w1 w2", "w3 w4 w5 w6 w7 w8 w9 w10 w11", "w12 zz"]  # zz is out of the vocabulary


def _want(model, cfg, texts=TEXTS) -> np.ndarray:
    index = {w: i for i, w in enumerate(_vocab(cfg.vocab_size))}
    out = []
    for text in texts:
        ids = [1] + [index.get(w, 0) for w in (TEMPLATE + text).split()] + [2]
        out.append(plain_mistral.embed_last_token(ids, model.state_dict(), _plain_config(cfg)).numpy())
    return np.stack(out)


@pytest.mark.parametrize("dtype, tol", [("float32", FP32_TOL), ("bfloat16", BF16_TOL)])
def test_e5_encoder_templates_pools_and_normalizes(checkpoint, dtype, tol):
    path, model, cfg = checkpoint
    encoder = E5MistralEncoder(str(path), device="cpu", compute_dtype=dtype)
    assert isinstance(encoder._tower, mistral.MistralTower) and encoder.config.dtype == dtype
    ids, mask = encoder._tokenize(TEXTS)
    lengths = [16 + len(t.split()) for t in TEXTS]  # BOS, the template's 14 words, EOS
    assert mask.sum(1).tolist() == lengths and ids.shape == (3, max(lengths))
    assert (ids[:, 0] == 1).all() and [ids[r, n - 1] for r, n in enumerate(lengths)] == [2, 2, 2]
    assert ids[2, lengths[2] - 2] == 0  # zz: <unk>
    got = encoder(TEXTS)
    assert got.dtype == np.float32 and got.shape == (3, cfg.hidden_size)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    assert np.abs(got - _want(model, cfg)).max() < tol


def test_the_checkpoints_model_type_picks_the_tower(checkpoint, monkeypatch):
    path, _, _ = checkpoint
    assert isinstance(transformer.TransformerEncoder(str(path), device="cpu")._tower, mistral.MistralTower)
    import transformers

    class Other:
        class config:  # noqa: N801 - stands for a model's config
            model_type = "gpt2"

    monkeypatch.setattr(transformers.AutoModel, "from_pretrained", lambda *a, **k: Other())
    with pytest.raises(ValueError, match="gpt2"):
        transformer.TransformerEncoder(str(path), device="cpu")


def test_an_index_reranks_with_the_e5_encoder(checkpoint):
    """``InMemoryIndex`` through ``Index.__call__`` against the plain
    reference's query vectors dotted with the rows (fp32 tower and fp32
    scoring: 1e-4 of the rows' dot magnitudes)."""
    import fastforward_tpu_torch as ft
    from fastforward_tpu_torch.index import InMemoryIndex, Mode

    path, model, cfg = checkpoint
    rng = np.random.default_rng(6)
    corpus = rng.standard_normal((512, cfg.hidden_size), dtype=np.float32)
    index = InMemoryIndex(query_encoder=E5MistralEncoder(str(path), device="cpu", compute_dtype="float32"),
                          mode=Mode.PASSAGE, device="cpu")
    index.add(corpus, psg_ids=[f"p{i}" for i in range(512)])
    run = {f"q{q}": {f"p{c}": float(20 - i) for i, c in enumerate(rng.choice(512, 20, replace=False))}
           for q in range(3)}
    ranking = ft.Ranking.from_run(run, queries={f"q{q}": t for q, t in enumerate(TEXTS)})
    got = index(ranking)
    qvecs = _want(model, cfg)
    for q in range(3):
        scores = got[f"q{q}"]
        assert scores.keys() == run[f"q{q}"].keys()
        for pid, score in scores.items():
            assert abs(score - float(corpus[int(pid[1:])] @ qvecs[q])) < 1e-4 * np.sqrt(cfg.hidden_size)
