"""The port's DeepSeek-V3 decoder tower (Moonlight-16B-A3B's block) on the CPU.

At ``DeepseekConfig.tiny()`` sizes (hidden 64, 3 layers of which the
first is dense, 4 heads of 8 + 8 RoPE dims and v 8, a latent of 16, 8
experts of 32, top 2, one shared) on seeded weights, the tower is compared
with the plain reference (``tests/plain_deepseek.py``, float64, one
unpadded sequence at a time, RoPE on pairs as published) and with
transformers' own ``DeepseekV3Model`` (fp32, eager attention) on the same
weights, under right padding of mixed lengths.  The expert layer is held
against a dense formulation, the router's weights against its unbiased
scores, the counts against tokens x K, the RoPE row permutation against
``q . k``, the wrappers' refusals on ``meta`` tensors (the kernels run on
the card only: ``tests/test_torch_gpu.py``), and ``E5MistralEncoder`` on
a ``deepseek_v3`` checkpoint through ``InMemoryIndex``'s
``Index.__call__``.  No JAX: the JAX package has no decoder.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fastforward_tpu_torch.encoder import transformer
from fastforward_tpu_torch.encoder.transformer import E5_WEB_SEARCH_TASK, E5MistralEncoder
from fastforward_tpu_torch.models import deepseek, mistral

from . import plain_deepseek

#: fp32 against float64: a few fp32 roundings (2^-24) a product, summed
#: over up to 96 terms through three layers of attention, a latent norm and
#: the experts' weighted sum, stay near 1e-6 of the outputs' largest
#: magnitude; 1e-5 leaves ten times that.  The router's choices are the
#: same in both: at these widths the gap between the K-th and the next
#: biased score is ~1e-1, a million times fp32's rounding
FP32_TOL = 1e-5

LENGTHS = [20, 5, 13]  # right-padded to 20
TEMPLATE = f"Instruct: {E5_WEB_SEARCH_TASK}\nQuery: "
SPECIALS = ["<unk>", "<s>", "</s>"]


def _plain_config(cfg: deepseek.DeepseekConfig) -> dict:
    return {"num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
            "qk_nope_head_dim": cfg.qk_nope_head_dim, "qk_rope_head_dim": cfg.qk_rope_head_dim,
            "v_head_dim": cfg.v_head_dim, "kv_lora_rank": cfg.kv_lora_rank,
            "first_k_dense_replace": cfg.first_k_dense_replace, "num_experts_per_tok": cfg.num_experts_per_tok,
            "routed_scaling_factor": cfg.routed_scaling_factor, "rms_norm_eps": cfg.rms_norm_eps,
            "rope_theta": cfg.rope_theta}


def _hf_model(cfg: deepseek.DeepseekConfig, seed: int = 3):
    """transformers' ``DeepseekV3Model`` on seeded weights: embeddings
    N(0, 1), matrices N(0, 0.15^2) (so the attention is far from uniform),
    norm gains 1 + N(0, 0.1^2), the routers' correction bias N(0, 0.1^2)."""
    from transformers import DeepseekV3Config, DeepseekV3Model

    hf = DeepseekV3Config(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size, intermediate_size=cfg.intermediate_size,
        moe_intermediate_size=cfg.moe_intermediate_size, num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads, num_key_value_heads=cfg.num_heads,
        n_shared_experts=cfg.n_shared_experts, n_routed_experts=cfg.n_routed_experts,
        routed_scaling_factor=cfg.routed_scaling_factor, kv_lora_rank=cfg.kv_lora_rank, q_lora_rank=None,
        qk_rope_head_dim=cfg.qk_rope_head_dim, v_head_dim=cfg.v_head_dim,
        qk_nope_head_dim=cfg.qk_nope_head_dim, n_group=1, topk_group=1,
        num_experts_per_tok=cfg.num_experts_per_tok, first_k_dense_replace=cfg.first_k_dense_replace,
        norm_topk_prob=True, rms_norm_eps=cfg.rms_norm_eps, rope_theta=cfg.rope_theta,
        attn_implementation="eager",
    )  # fmt: skip
    model = DeepseekV3Model(hf).eval()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in list(model.named_parameters()) + list(model.named_buffers()):
            if "rotary_emb" in name:
                continue
            noise = torch.randn(p.shape, generator=gen)
            if name.endswith("norm.weight"):
                p.copy_(1 + 0.1 * noise)
            elif name.endswith("e_score_correction_bias"):
                p.copy_(0.1 * noise)
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


def _worst(got, want) -> float:
    """The largest gap over the real positions, over the largest magnitude."""
    return max(float((g[: w.shape[0]].double() - w).abs().max() / w.abs().max()) for g, w in zip(got, want))


@pytest.fixture(scope="module")
def model():
    return _hf_model(deepseek.DeepseekConfig.tiny())


@pytest.mark.parametrize("against", ["plain", "transformers"])
def test_the_tower_matches_the_references_in_fp32(model, against):
    cfg = deepseek.DeepseekConfig.tiny()
    ids, mask = _batch(cfg)
    tower = deepseek.from_hf_torch(model, "float32")
    with torch.no_grad():
        got = tower(ids, mask)
        if against == "plain":
            want = [plain_deepseek.hidden(ids[r, : int(mask[r].sum())], model.state_dict(), _plain_config(cfg))
                    for r in range(ids.shape[0])]
        else:
            hidden = model(input_ids=ids, attention_mask=mask).last_hidden_state
            want = [hidden[r, : int(mask[r].sum())].double() for r in range(ids.shape[0])]
    assert got.dtype == torch.float32 and got.shape == (3, max(LENGTHS), cfg.hidden_size)
    assert _worst(got, want) < FP32_TOL


def test_the_expert_layer_matches_a_dense_formulation(model):
    """``x + sum_e mask_e w_e E_e(h) + S(h)`` over all experts in float64,
    ``mask`` the top-K of the biased scores, ``w`` the unbiased ones
    normalized and scaled; padded tokens take ``x + S(h)``."""
    cfg = deepseek.DeepseekConfig.tiny()
    tower = deepseek.from_hf_torch(model, "float32")
    layer = tower.layers[2]
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(2, 7, cfg.hidden_size, generator=gen)
    keys = torch.ones(2, 7, dtype=torch.int32)
    keys[1, 4:] = 0
    counts = torch.zeros(cfg.n_routed_experts, dtype=torch.int32)
    got = tower._moe(x, layer, keys, counts)

    def swiglu(h, gate, up, down):
        g, u = h @ gate.double().T, h @ up.double().T
        return (g * torch.sigmoid(g) * u) @ down.double().T

    xd = x.double().view(-1, cfg.hidden_size)
    h = plain_deepseek._rms(xd, layer.mlp_norm.double(), cfg.rms_norm_eps)
    scores = torch.sigmoid(h @ layer.router.double().T)
    chosen = torch.topk(scores + layer.router_bias.double(), cfg.num_experts_per_tok).indices
    hot = torch.zeros_like(scores).scatter_(1, chosen, 1.0) * keys.view(-1, 1)
    weights = scores * hot / (scores * hot).sum(1, keepdim=True).clamp(min=1e-300) * cfg.routed_scaling_factor
    want = xd + swiglu(h, layer.shared_gate, layer.shared_up, layer.shared_down)
    for e in range(cfg.n_routed_experts):
        want = want + weights[:, e, None] * swiglu(h, layer.experts_gate[e], layer.experts_up[e],
                                                   layer.experts_down[e])
    assert got.shape == x.shape
    assert float((got.double().view(-1, cfg.hidden_size) - want).abs().max() / want.abs().max()) < FP32_TOL
    assert counts.sum().item() == 11 * cfg.num_experts_per_tok  # 7 + 4 real tokens


def test_the_weights_are_taken_from_the_unbiased_scores():
    """The bias picks experts 0 and 2 (its scores 10.5 and 0.88 lead), the
    weights are their sigmoid scores 0.5 and 0.88, normalized and scaled;
    a padded token routes nowhere."""
    logits = torch.tensor([[0.0, 1.0, 2.0, 3.0], [0.0, 1.0, 2.0, 3.0]])
    bias = torch.tensor([10.0, 0.0, 0.0, -10.0])
    counts = torch.zeros(4, dtype=torch.int32)
    ids, weights, slots = deepseek.moe_route(logits, bias, torch.tensor([1, 0], dtype=torch.int32), 2, 2.5,
                                             True, counts)
    s = torch.sigmoid(torch.tensor([0.0, 2.0]))
    assert ids.tolist() == [[0, 2], [-1, -1]] and slots.tolist() == [[0, 0], [-1, -1]]
    torch.testing.assert_close(weights[0], s / s.sum() * 2.5, rtol=0, atol=1e-7)
    assert weights[1].tolist() == [0.0, 0.0] and counts.tolist() == [1, 0, 1, 0]
    ids, weights, _ = deepseek.moe_route(logits[:1], bias, torch.ones(1, dtype=torch.int32), 2, 2.5, False,
                                         torch.zeros(4, dtype=torch.int32))
    torch.testing.assert_close(weights[0], s * 2.5, rtol=0, atol=1e-7)


def test_no_pair_is_dropped_and_the_counts_are_kept(model):
    """Every real token goes to K experts: the counts sum to tokens x K in
    every expert layer of every micro-batch, each expert's rows are its
    pairs, and the tower's ring keeps the last micro-batches' counts."""
    cfg = deepseek.DeepseekConfig.tiny()
    tower = deepseek.from_hf_torch(model, "float32")
    ids, mask = _batch(cfg)
    with torch.no_grad():
        tower(ids, mask)
        tower(ids[:1], mask[:1])
    stats = tower.moe_stats()
    k = cfg.num_experts_per_tok
    assert stats["micro_batches"] == 2 and len(stats["recent"]) == 2
    for got, tokens in zip(stats["recent"], (sum(LENGTHS), LENGTHS[0])):
        assert got["routed"] == [tokens * k] * cfg.n_moe_layers
        assert got["expert_mean"] == [tokens * k / cfg.n_routed_experts] * cfg.n_moe_layers
        assert all(m >= tokens * k / cfg.n_routed_experts for m in got["expert_max"])
    logits = torch.randn(50, cfg.n_routed_experts, generator=torch.Generator().manual_seed(2))
    counts = torch.zeros(cfg.n_routed_experts, dtype=torch.int32)
    real = torch.ones(50, dtype=torch.int32)
    real[45:] = 0
    ids, _, slots = deepseek.moe_route(logits, torch.zeros(cfg.n_routed_experts), real, k, 1.0, True, counts)
    offsets, rows, pos = deepseek.moe_permute(ids, slots, counts)
    assert counts.sum().item() == 45 * k and offsets[-1].item() == 45 * k
    for e in range(cfg.n_routed_experts):
        seg = rows[offsets[e] : offsets[e + 1]]
        assert sorted(seg.tolist()) == sorted(torch.nonzero(ids == e)[:, 0].tolist())
    assert (pos[45:] == -1).all() and (rows[pos[:45].long()] == torch.arange(45)[:, None]).all()


def test_the_rope_row_permutation_leaves_q_dot_k_unchanged():
    """DeepSeek's RoPE on pairs over the checkpoint's rows, against the
    rotate-half RoPE over the rows :func:`deepseek.rope_row_order` puts
    first: the same ``q . k`` at every pair of positions (float64)."""
    gen = torch.Generator().manual_seed(5)
    length, hidden, dr = 9, 32, 64
    h = torch.randn(length, hidden, generator=gen, dtype=torch.float64)
    wq, wk = (torch.randn(dr, hidden, generator=gen, dtype=torch.float64) for _ in range(2))
    pairs = plain_deepseek.rope_pairs(h @ wq.T, 50000.0) @ plain_deepseek.rope_pairs(h @ wk.T, 50000.0).T
    order = deepseek.rope_row_order(dr)
    assert sorted(order.tolist()) == list(range(dr)) and order[:3].tolist() == [0, 2, 4]
    # mistral.rope_tables' angles, in float64
    angles = torch.arange(length, dtype=torch.float64)[:, None] * 50000.0 ** (
        -torch.arange(0, dr, 2, dtype=torch.float64) / dr)
    cos, sin = torch.cat([angles, angles], -1).cos(), torch.cat([angles, angles], -1).sin()
    half = [mistral.apply_rope((h @ w[order].T)[:, None], cos, sin)[:, 0] for w in (wq, wk)]
    torch.testing.assert_close(half[0] @ half[1].T, pairs, rtol=0, atol=1e-12 * pairs.abs().max().item())
    unpermuted = [mistral.apply_rope((h @ w.T)[:, None], cos, sin)[:, 0] for w in (wq, wk)]
    assert (unpermuted[0] @ unpermuted[1].T - pairs).abs().max() > 1e-3 * pairs.abs().max()


def test_a_tower_shares_the_tensors_it_is_given(model):
    """bf16 weights handed over in bf16 are held, not copied (a 16B tower is
    never held twice), the experts too; the norms and the router are held
    in fp32; only the RoPE rows of W_q are a copy."""
    cfg = dataclasses.replace(deepseek.DeepseekConfig.tiny(), dtype="bfloat16")
    state = {k: v.to(torch.bfloat16) for k, v in model.state_dict().items()}
    tower = deepseek.DeepseekTower.from_arrays(cfg, state)
    assert tower.layers[2].experts_down[5].data_ptr() == state["layers.2.mlp.experts.5.down_proj.weight"].data_ptr()
    assert tower.layers[0].gate.data_ptr() == state["layers.0.mlp.gate_proj.weight"].data_ptr()
    assert tower.layers[1].kv_latent.data_ptr() == state["layers.1.self_attn.kv_a_proj_with_mqa.weight"].data_ptr()
    assert tower.embed.data_ptr() == state["embed_tokens.weight"].data_ptr()
    assert tower.layers[1].router.dtype == tower.layers[1].kv_norm.dtype == torch.float32
    with pytest.raises(ValueError, match="does not fit"):
        deepseek.DeepseekTower.from_arrays(cfg, {**state, "layers.0.self_attn.o_proj.weight": state[
            "layers.0.self_attn.kv_b_proj.weight"]})


def test_the_config_refuses_what_the_tower_does_not_run(model):
    hf = model.config
    assert deepseek.config_from_hf(hf, "float32") == deepseek.DeepseekConfig.tiny()
    for key, value in (("q_lora_rank", 16), ("scoring_func", "softmax"), ("topk_group", 2),
                       ("rope_scaling", {"type": "yarn", "factor": 4.0}), ("rope_interleave", False)):
        bad = type(hf).from_dict({**hf.to_dict(), key: value, "n_group": 4 if key == "topk_group" else 1})
        with pytest.raises(ValueError):
            deepseek.config_from_hf(bad)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_each_wrapper_refuses_what_its_kernel_does_not_take():
    """Shapes and types are checked before anything touches a card (``meta``
    tensors stand for CUDA ones); a call the kernel takes then fails only
    for want of a card."""
    b, length, heads = 2, 5, 16
    q, kn, kr, v = _meta(b, length, heads, 192), _meta(b, length, heads, 128), _meta(b, length, 64), \
        _meta(b, length, heads, 128)
    cos, sin, mask = _meta(length, 64, dtype=torch.float32), _meta(length, 64, dtype=torch.float32), \
        _meta(b, length, dtype=torch.int32)
    with pytest.raises(ValueError, match="head sizes"):
        deepseek.latent_attention(_meta(b, length, heads, 96), _meta(b, length, heads, 64), _meta(b, length, 32),
                                  _meta(b, length, heads, 64), cos[:, :32], sin[:, :32], mask)
    with pytest.raises(TypeError):
        deepseek.latent_attention(q.half(), kn, kr, v, cos, sin, mask)
    with pytest.raises(ValueError, match="heads"):
        deepseek.latent_attention(q, kn[:, :, :8], kr, v, cos, sin, mask)
    with pytest.raises(ValueError, match="cos"):
        deepseek.latent_attention(q, kn, kr, v, cos[:3], sin, mask)
    with pytest.raises(ValueError, match="unsupported device"):
        deepseek.latent_attention(q, kn, kr, v, cos, sin, mask)
    logits, bias = _meta(10, 64, dtype=torch.float32), _meta(64, dtype=torch.float32)
    counts, real = _meta(64, dtype=torch.int32), _meta(10, dtype=torch.int32)
    with pytest.raises(ValueError, match="top_k"):
        deepseek.moe_route(logits, bias, real, 9, 1.0, True, counts)
    with pytest.raises(ValueError, match="256 experts"):
        deepseek.moe_route(_meta(10, 300, dtype=torch.float32), _meta(300, dtype=torch.float32), real, 6, 1.0,
                           True, _meta(300, dtype=torch.int32))
    with pytest.raises(ValueError, match="mask"):
        deepseek.moe_route(logits, bias, real.long(), 6, 1.0, True, counts)
    ids = _meta(10, 6, dtype=torch.int32)
    with pytest.raises(ValueError, match="slots"):
        deepseek.moe_permute(ids, _meta(10, 5, dtype=torch.int32), counts)
    bank = deepseek.ExpertBank([[_meta(128, 64) for _ in range(4)]])
    offsets = _meta(5, dtype=torch.int32)
    with pytest.raises(TypeError):
        deepseek.grouped_gemm(_meta(30, 64, dtype=torch.float32), None, bank, offsets)
    with pytest.raises(ValueError, match="K % 32"):
        deepseek.grouped_gemm(_meta(30, 48), None, deepseek.ExpertBank([[_meta(128, 48)] * 4]), offsets)
    with pytest.raises(ValueError, match="offsets"):
        deepseek.grouped_gemm(_meta(30, 64), None, bank, _meta(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="unsupported device"):
        deepseek.grouped_gemm(_meta(30, 64), _meta(30, dtype=torch.int32), bank, offsets)
    pos, w = _meta(10, 6, dtype=torch.int32), _meta(10, 6, dtype=torch.float32)
    with pytest.raises(TypeError):
        deepseek.moe_combine(_meta(60, 64, dtype=torch.float32), pos, w, _meta(10, 64), _meta(10, 64))
    with pytest.raises(ValueError, match="multiple of 8"):
        deepseek.moe_combine(_meta(60, 12), pos, w, _meta(10, 12), _meta(10, 12))
    with pytest.raises(ValueError, match="unsupported device"):
        deepseek.moe_combine(_meta(60, 64), pos, w, _meta(10, 64), _meta(10, 64))


# -- the encoder -------------------------------------------------------------------


def _vocab(size: int) -> list:
    head = SPECIALS + TEMPLATE.split()
    return head + [f"w{i}" for i in range(size - len(head))]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory, model):
    """A tiny ``deepseek_v3`` checkpoint: the seeded ``DeepseekV3Model``
    and a word-level tokenizer (the specials at ids 0-2)."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    path = tmp_path_factory.mktemp("deepseek")
    cfg = deepseek.DeepseekConfig.tiny()
    model.save_pretrained(path)
    words = Tokenizer(models.WordLevel({w: i for i, w in enumerate(_vocab(cfg.vocab_size))}, unk_token="<unk>"))
    words.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    PreTrainedTokenizerFast(tokenizer_object=words, unk_token="<unk>", bos_token="<s>",
                            eos_token="</s>").save_pretrained(path)
    return path, cfg


TEXTS = ["w1 w2", "w3 w4 w5 w6 w7 w8 w9 w10 w11", "w12 zz"]  # zz is out of the vocabulary


def _want(model, cfg, texts=TEXTS) -> np.ndarray:
    index = {w: i for i, w in enumerate(_vocab(cfg.vocab_size))}
    out = []
    for text in texts:
        ids = [1] + [index.get(w, 0) for w in (TEMPLATE + text).split()] + [2]
        out.append(plain_deepseek.embed_last_token(ids, model.state_dict(), _plain_config(cfg)).numpy())
    return np.stack(out)


def test_the_deepseek_v3_model_type_picks_the_tower(checkpoint):
    path, _ = checkpoint
    assert isinstance(transformer.TransformerEncoder(str(path), device="cpu")._tower, deepseek.DeepseekTower)


def test_an_index_reranks_with_the_e5_recipe_on_a_deepseek_checkpoint(checkpoint, model):
    """``E5MistralEncoder`` on the ``deepseek_v3`` checkpoint in
    ``InMemoryIndex`` through ``Index.__call__``, against the plain
    reference's query vectors dotted with the rows (fp32 tower and fp32
    scoring: 1e-4 of the rows' dot magnitudes)."""
    import fastforward_tpu_torch as ft
    from fastforward_tpu_torch.index import InMemoryIndex, Mode

    path, cfg = checkpoint
    encoder = E5MistralEncoder(str(path), device="cpu", compute_dtype="float32")
    assert isinstance(encoder._tower, deepseek.DeepseekTower)
    qvecs = _want(model, cfg)
    np.testing.assert_allclose(encoder(TEXTS), qvecs, atol=FP32_TOL, rtol=0)
    rng = np.random.default_rng(6)
    corpus = rng.standard_normal((512, cfg.hidden_size), dtype=np.float32)
    index = InMemoryIndex(query_encoder=encoder, mode=Mode.PASSAGE, device="cpu")
    index.add(corpus, psg_ids=[f"p{i}" for i in range(512)])
    run = {f"q{q}": {f"p{c}": float(20 - i) for i, c in enumerate(rng.choice(512, 20, replace=False))}
           for q in range(3)}
    got = index(ft.Ranking.from_run(run, queries={f"q{q}": t for q, t in enumerate(TEXTS)}))
    for q in range(3):
        scores = got[f"q{q}"]
        assert scores.keys() == run[f"q{q}"].keys()
        for pid, score in scores.items():
            assert abs(score - float(corpus[int(pid[1:])] @ qvecs[q])) < 1e-4 * np.sqrt(cfg.hidden_size)
