"""The Moonlight cell at a tiny size on the CPU: correct as the program
stands, not correct with the control in its place or with a fault planted
in the tower (weights from the biased scores, no routed scaling, no shared
expert, RoPE on the wrong dims) or in the timed path underneath, or failing
where the fault sends a routing choice out of the reference's reach; its
traced run's ranges; and the yardstick's operations and bytes, counted by
hand."""

import dataclasses
import json
import math
import time

import pytest
import torch

from bench_port import control, harness, spec
from bench_port.tests.conftest import REPO, tiny_copy
from bench_port.tests.test_bench_run import FAULTS
from fastforward_tpu_torch.index.base import Index
from fastforward_tpu_torch.models import deepseek, mistral

CELL = "moonlight.batch-encode"
SEED = 2**33 + 23

#: Moonlight's block cut to the CPU: a dense layer and two expert layers, 8
#: experts top 2 with one shared, a latent of 16, heads of 8 + 8 RoPE dims;
#: weights N(0, 0.2^2) so the attention is far from uniform (RoPE on the
#: wrong dims shows), and a correction bias N(0, 0.5^2) so weights taken
#: from the biased scores differ from the unbiased ones by tens of percent
TINY_MOONLIGHT = {
    "vocab_size": 512, "hidden_size": 64, "intermediate_size": 96, "moe_intermediate_size": 32,
    "num_hidden_layers": 3, "num_attention_heads": 4, "num_key_value_heads": 4, "n_shared_experts": 1,
    "n_routed_experts": 8, "num_experts_per_tok": 2, "routed_scaling_factor": 2.446, "kv_lora_rank": 16,
    "q_lora_rank": None, "qk_nope_head_dim": 8, "qk_rope_head_dim": 8, "v_head_dim": 8, "n_group": 1,
    "topk_group": 1, "topk_method": "noaux_tc", "scoring_func": "sigmoid", "norm_topk_prob": True,
    "first_k_dense_replace": 1, "moe_layer_freq": 1, "hidden_act": "silu", "rms_norm_eps": 1e-5,
    "rope_theta": 50000, "model_type": "deepseek_v3", "initializer_range": 0.2,
    "e_score_correction_bias_std": 0.5, "bos_token_id": 1, "eos_token_id": 2,
}  # fmt: skip


@pytest.fixture(scope="module")
def tiny_moonlight(tmp_path_factory):
    """The tiny benchmark with the Moonlight configuration's own tiny copy:
    the block above, 64-wide vectors, 20,000 passages, computed in fp32
    (the committed limits are set for bf16 at 2,048 wide)."""
    root = tiny_copy(tmp_path_factory.mktemp("tiny-moonlight"))
    entry = next(c for c in json.loads((root / "BENCHMARK.json").read_text())["configs"]
                 if c["name"] == "msmarco-passage-moonlight")
    cfg = json.loads((REPO / entry["file"]).read_text())
    cfg.update(tower=TINY_MOONLIGHT, dim=TINY_MOONLIGHT["hidden_size"], passages=20_000, compute_dtype="float32",
               encoder_batch_size=8)
    (root / entry["file"]).write_text(json.dumps(cfg))
    return root


def _run(root, seconds=0.5, traced=False):
    c = spec.find_cell(root, CELL)
    out = harness.run_cell(c, SEED, seconds, traced, time.perf_counter(), "cpu")
    return c, out, harness.line_of(c, out, traced, "cpu")


def _caught(root) -> bool:
    """Whether a run shows the fault planted in it: its answers not
    correct, or a routing choice of the program out of the float64
    reference's reach (the reference raises, and the run fails)."""
    try:
        _c, _out, line = _run(root)
    except RuntimeError as error:
        assert "routed wrongly" in str(error)
        return True
    return not line["correct"]


def test_the_tiny_cell_is_correct_and_the_control_is_not(tiny_moonlight):
    c, out, line = _run(tiny_moonlight)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {m["name"] for m in c.end_to_end}
    values = control.control_values(c, SEED, out, torch.device("cpu"))
    ok, shown = harness.check.judge(values, c.limits)
    assert not ok, shown


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_a_broken_rerank_is_not_correct(tiny_moonlight, monkeypatch, fault):
    call = Index.__call__

    def broken(self, ranking, *args, **kwargs):
        return fault(ranking, call(self, ranking, *args, **kwargs))

    monkeypatch.setattr(Index, "__call__", broken)
    _c, _out, line = _run(tiny_moonlight)
    assert not line["correct"], line["checks"]


def _biased_weights(logits, bias, mask, top_k, scale, norm, counts):
    """The router with its weights taken from the biased scores."""
    ids, weights, slots = plain_route(logits, bias, mask, top_k, scale, norm, counts)
    picked = (torch.sigmoid(logits) + bias).gather(1, ids.long().clamp(min=0))
    return ids, torch.where(ids >= 0, picked / picked.sum(1, keepdim=True) * scale, 0.0), slots


def _no_scaling(cfg, dtype="bfloat16"):
    return dataclasses.replace(plain_config(cfg, dtype), routed_scaling_factor=1.0)


def _rope_on_the_wrong_dims(q, k_nope, k_rope, v, cos, sin, attention_mask):
    """The latent attention with RoPE on each head's first ``dr`` no-RoPE
    dims, the RoPE dims left unturned."""
    dr = k_rope.shape[-1]

    def turned(t):
        return torch.cat([mistral.apply_rope(t[..., :dr], cos, sin), t[..., dr:]], -1)

    b, length, heads, dq = q.shape
    qf = torch.cat([turned(q.float()[..., : dq - dr]), q.float()[..., dq - dr :]], -1).permute(0, 2, 1, 3)
    kf = torch.cat([turned(k_nope.float()), k_rope.float()[:, :, None].expand(b, length, heads, dr)], -1)
    logits = torch.matmul(qf, kf.permute(0, 2, 3, 1)) / math.sqrt(dq)
    allowed = mistral.allowed_keys(attention_mask, None)[:, :, 0]
    logits = logits.masked_fill(~allowed, torch.finfo(torch.float32).min)
    ctx = torch.matmul(torch.softmax(logits, -1), v.float().permute(0, 2, 1, 3))
    return ctx.permute(0, 2, 1, 3).reshape(b, length, -1).to(q.dtype)


def _choices_without_the_bias(logits, bias, mask, top_k, scale, norm, counts):
    """The router picking its experts by the unbiased scores."""
    return plain_route(logits, torch.zeros_like(bias), mask, top_k, scale, norm, counts)


plain_route, plain_config = deepseek.moe_route_plain, deepseek.config_from_hf

TOWER_FAULTS = {
    "weights_from_biased_scores": ("moe_route_plain", _biased_weights),
    "choices_without_the_bias": ("moe_route_plain", _choices_without_the_bias),
    "no_routed_scaling": ("config_from_hf", _no_scaling),
    "no_shared_expert": ("DeepseekTower._shared_expert", lambda self, h, p: torch.zeros_like(h)),
    "rope_on_the_wrong_dims": ("latent_attention_plain", _rope_on_the_wrong_dims),
}


@pytest.mark.parametrize("fault", list(TOWER_FAULTS))
def test_a_fault_in_the_tower_is_not_correct(tiny_moonlight, monkeypatch, fault):
    name, replacement = TOWER_FAULTS[fault]
    owner, _, attr = name.rpartition(".")
    monkeypatch.setattr(getattr(deepseek, owner) if owner else deepseek, attr, replacement)
    assert _caught(tiny_moonlight)


def test_the_float64_reference_fails_a_choice_out_of_reach_and_the_control_does_not():
    """Given the reference's own choices as the program's, the float64
    reference follows them all; given in every expert layer two experts
    the reference did not choose, it raises, and the control (whose fp8
    rounding moves the scores by far more) takes its own there instead."""
    encoder = spec.plugin(REPO, "encoders", "E5MoonlightEncoder")
    config = {"tower": TINY_MOONLIGHT, "compute_dtype": "float32", "encoder_batch_size": 1}
    vocab = encoder._E5.vocabulary(TINY_MOONLIGHT["vocab_size"])
    texts = ["w3 w14 w159 w92"]
    cpu = torch.device("cpu")
    own = []
    alone = encoder.reference(texts, {"vocab": vocab, "seed": SEED}, config, "float64", cpu, choices=own)
    own = torch.stack(own)  # (expert layers, tokens, 2)

    def given(choices):
        return {"vocab": vocab, "seed": SEED, "encoder": None, "texts": texts, "choices": {texts[0]: choices}}

    followed = encoder.reference(texts, given(own), config, "float64", cpu)
    torch.testing.assert_close(followed, alone, atol=0, rtol=0)
    experts = torch.arange(TINY_MOONLIGHT["n_routed_experts"])
    others = torch.stack([torch.stack([experts[~torch.isin(experts, row)][:2] for row in layer]) for layer in own])
    with pytest.raises(RuntimeError, match="routed wrongly"):
        encoder.reference(texts, given(others), config, "float64", cpu)
    assert torch.isfinite(encoder.reference(texts, given(others), config, "tf32", cpu)).all()


def test_the_reference_follows_the_programs_choices_within_reach_only():
    """Of two tokens whose program choices are not the reference's own top
    2, the first's differ by a near-tie (scores 1e-4 apart in the logits,
    well within the reach of a bf16 rounding of the router's input) and are
    followed; the second's pick an expert far below and are replaced by the
    reference's own."""
    encoder = spec.plugin(REPO, "encoders", "E5MoonlightEncoder")
    tower = {"num_experts_per_tok": 2, "norm_topk_prob": True, "routed_scaling_factor": 2.446}
    gen = torch.Generator().manual_seed(3)
    w = {"mlp.gate.weight": torch.eye(4, dtype=torch.float64),
         "mlp.gate.e_score_correction_bias": torch.zeros(4, dtype=torch.float64)}
    for pre in ["mlp.shared_experts."] + [f"mlp.experts.{e}." for e in range(4)]:
        for name, shape in (("gate_proj", (2, 4)), ("up_proj", (2, 4)), ("down_proj", (4, 2))):
            w[f"{pre}{name}.weight"] = torch.randn(shape, generator=gen, dtype=torch.float64)
    h = torch.tensor([[2.0, 1.9, 1.9 - 1e-4, -3.0], [2.0, 1.9, 0.5, -3.0]], dtype=torch.float64)
    forced = torch.tensor([[0, 2], [0, 3]])
    choices, routing = [], {"pairs": 0, "differ": 0, "out_of_reach": 0, "reach_used": 0.0}
    out = encoder._experts(h, w, tower, torch.matmul, choices, forced, routing)
    assert choices[0].tolist() == [[0, 2], [0, 1]]
    assert {k: routing[k] for k in ("pairs", "differ", "out_of_reach")} == {"pairs": 4, "differ": 2, "out_of_reach": 1}
    s = torch.sigmoid(h)
    near = encoder.reach(h, w["mlp.gate.weight"], s)
    assert near[0, 2] == pytest.approx(2.0**-8 * (1.9 - 1e-4) * math.exp(-(1.9 - 1e-4)) / (1 + math.exp(-(1.9 - 1e-4))) ** 2)
    assert routing["reach_used"] == pytest.approx(float((s[0, 1] - s[0, 2]) / (near[0, 1] + near[0, 2])))
    assert 0 < routing["reach_used"] < 0.05
    own = encoder._experts(h, w, tower, torch.matmul, [], None, None)
    assert torch.equal(out[1], own[1]) and not torch.equal(out[0], own[0])


def test_a_traced_run_holds_the_tower_ranges_inside_the_tower(tiny_moonlight):
    c, out, line = _run(tiny_moonlight, traced=True)
    assert line["correct"], line["checks"]
    host = out["run"].profile.host
    towers = [(s, e) for n, s, e in host if n == "ff.tower"]
    tower = c.config["tower"]
    dense = tower["first_k_dense_replace"]
    for name, per_tower in (("ff.attn", tower["num_hidden_layers"]), ("ff.mlp", dense),
                            ("ff.moe", tower["num_hidden_layers"] - dense)):
        spans = [(s, e) for n, s, e in host if n == name]
        assert len(spans) == per_tower * len(towers), name
        assert all(any(ts <= s and e <= te for ts, te in towers) for s, e in spans), name
    assert {"moe_roofline.rerank", "attn_roofline.rerank", "mlp_roofline.rerank"} <= {
        m["name"] for m in c.per_layer}


def test_the_yardstick_counts_moonlights_work_by_hand():
    """Per token at the published widths: the expert layers 3.61 GFLOP, the
    latent attention's projections 0.74, the dense layer 0.14 (4.49 in
    all); an expert layer reads 1.14 GB of bf16 weights once."""
    config = json.loads((REPO / "bench_port/configs/msmarco-passage-moonlight.json").read_text())
    tower = config["tower"]
    encoder = spec.plugin(REPO, "encoders", config["encoder"])
    # q 2,048 x 3,072, kv_a 2,048 x 576, kv_b 512 x 4,096, o 2,048 x 2,048;
    # one (query, key) pair: 16 heads x 2 x (192 + 128)
    proj = 2 * (2048 * 3072 + 2048 * 576 + 512 * 4096 + 2048 * 2048)
    assert encoder.attn_flops(tower, 1) == 27 * (proj + 16 * 2 * 320)
    assert encoder.attn_flops(tower, 3) == 27 * (3 * proj + 6 * 16 * 2 * 320)
    assert encoder.mlp_flops(tower, 5) == 5 * 6 * 2048 * 11264
    # router 2 x 2,048 x 64; 6 routed + 2 shared experts of 1,408: 6 x 2,048 x 1,408 each
    per_token = 2 * 2048 * 64 + 8 * 6 * 2048 * 1408
    assert encoder.moe_flops(tower, 7) == 7 * per_token
    assert encoder.moe_bytes(tower, 2) == 2 * (3 * 2048 * 1408 * 66 + 64 * 2048)
    assert 26 * per_token / 1e9 == pytest.approx(3.61, abs=0.005)
    assert proj * 27 / 1e9 == pytest.approx(0.74, abs=0.005)
    parts = encoder.least_parts_s(config, 512)
    # 4 micro-batches of 128 queries of 24.5 real tokens on average: the
    # operations (0.440 ms a layer) outrun the weights' read (0.341 ms)
    moe = 26 * 4 * max(128 * 24.5 * per_token / 989e12, 2 * (3 * 2048 * 1408 * 66 + 64 * 2048) / 3.35e12)
    assert parts["moe"] == pytest.approx(moe, rel=1e-12)
    assert moe == pytest.approx(26 * 4 * 0.4398e-3, rel=1e-3)
    lengths = range(18, 32)
    assert parts["attn"] == pytest.approx(512 * sum(encoder.attn_flops(tower, n) for n in lengths) / 14 / 989e12)
    assert parts["mlp"] == pytest.approx(512 * 24.5 * 6 * 2048 * 11264 / 989e12)
    assert encoder.least_s(config, 512) == pytest.approx(sum(parts.values()))
    # a last micro-batch of 2 queries is bound by the weights' read
    small = encoder.least_parts_s(config, 130)["moe"]
    assert small == pytest.approx(26 * (128 * 24.5 * per_token / 989e12 + 1.142161408e9 / 3.35e12))


def test_the_configuration_holds_the_catalogs_numbers():
    """Every key of Moonlight-16B-A3B's config.json at the top level and
    in the tower the benchmark reads, as published."""
    config = json.loads((REPO / "bench_port/configs/msmarco-passage-moonlight.json").read_text())
    published = {"hidden_size": 2048, "num_hidden_layers": 27, "vocab_size": 163840, "n_routed_experts": 64,
                 "num_experts_per_tok": 6, "n_shared_experts": 2, "moe_intermediate_size": 1408,
                 "intermediate_size": 11264, "kv_lora_rank": 512, "q_lora_rank": None, "qk_nope_head_dim": 128,
                 "qk_rope_head_dim": 64, "v_head_dim": 128, "num_attention_heads": 16,
                 "routed_scaling_factor": 2.446, "rope_theta": 50000, "first_k_dense_replace": 1}
    for key, value in published.items():
        assert config[key] == config["tower"][key] == value, key
    tower = deepseek.config_from_hf(type("C", (), config["tower"]))
    assert tower == deepseek.DeepseekConfig(rope_theta=50000.0)
    assert config["encoder_batch_size"] == 128 and config["passages"] == 64 * 2**16
