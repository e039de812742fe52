"""Moonlight-16B-A3B's DeepSeek-V3 decoder as a query tower, by E5's recipe
(``E5MistralEncoder`` on a ``deepseek_v3`` checkpoint), on weights made
from the seed, with its plain reference.

The program gets the port's encoder, opened on a checkpoint directory that
holds only a tokenizer: transformers' model loader hands back the seeded
weights, made tensor by tensor straight in the configuration's compute type
on the device, instead of reading a weight file, and the tower takes those
tensors as they are (one copy of the 16B weights on the card).  The
tokenizer is word-level, as ``E5MistralEncoder.py``'s (whose
``vocabulary``, ``token_ids`` and fp8 rounding this module uses).

The reference is plain PyTorch written from DeepSeek-V3's published forward
(``tests/plain_deepseek.py``'s equations, a second copy): the query
template, BOS and EOS; multi-head latent attention with RoPE on pairs
``(2i, 2i + 1)`` as published; the first layer's dense SwiGLU; in every
later layer the sigmoid router (the top 6 of the scores plus the
correction bias, weighted by the unbiased scores, normalized, times
``routed_scaling_factor``), the 6 chosen experts and the shared ones; the
EOS token's final hidden state L2-normalized; all in float64.  It goes
layer by layer, making each layer's weights again from the seed, so no
copy of the whole tower is held, and keeps ``matmul.allow_tf32`` and
``cudnn.allow_tf32`` off.  Its control (``precision="tf32"``, the step
below the configuration's bf16) rounds both operands of every matmul, the
router's included, to fp8 e4m3 with one per-tensor scale and accumulates
in fp32.

Routing is discontinuous: on random weights a bf16 rounding that swaps two
near-tied experts sends a token down another path, and the swaps multiply
down the 26 expert layers (nearly half of the choices of a bf16 tower
differ from a float64 one's).  So the reference follows the program's own
choices: after the window, with the program's state other than its encoder
freed, :func:`program_choices` encodes each checked query's micro-batch
again through the encoder the index called, recording the experts each
token took.  The reference takes them where each lies within reach of its
own 6th biased score (:func:`reach`: what a bf16 rounding of the router's
input can move the two scores).  A choice out of reach is a wrong answer:
the float64 reference raises on it, so the run fails.  The control, whose
fp8 rounding moves scores by far more, takes its own top 6 there instead.
Each reference run prints how many choices differed and how many were out
of reach.
"""

import contextlib
import math
import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from bench_port import data, roofline, spec

#: E5-Mistral's plug-in: the word-level vocabulary, the template's token
#: ids and the control's fp8 rounding are the same here
_E5 = spec.plugin(Path(__file__).resolve().parents[2], "encoders", "E5MistralEncoder")

#: the stream tag of the tower's tensors (``data.py``'s tags are 0-7,
#: ``E5MistralEncoder.py``'s 8)
TOWER_STREAM = 9

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


# -- inputs made from the seed ---------------------------------------------------


def layer_shapes(tower: dict, layer: int) -> dict:
    """Layer ``layer``'s tensors in ``DeepseekV3Model``'s names under
    ``layers.<layer>.``, and their shapes (the routed experts' under
    ``mlp.experts.<e>.``)."""
    h, heads, r = tower["hidden_size"], tower["num_attention_heads"], tower["kv_lora_rank"]
    dn, dr, dv = tower["qk_nope_head_dim"], tower["qk_rope_head_dim"], tower["v_head_dim"]
    out = {
        "input_layernorm.weight": (h,),
        "self_attn.q_proj.weight": (heads * (dn + dr), h),
        "self_attn.kv_a_proj_with_mqa.weight": (r + dr, h),
        "self_attn.kv_a_layernorm.weight": (r,),
        "self_attn.kv_b_proj.weight": (heads * (dn + dv), r),
        "self_attn.o_proj.weight": (h, heads * dv),
        "post_attention_layernorm.weight": (h,),
    }
    if layer < tower["first_k_dense_replace"]:
        i = tower["intermediate_size"]
        return {**out, "mlp.gate_proj.weight": (i, h), "mlp.up_proj.weight": (i, h), "mlp.down_proj.weight": (h, i)}
    s, i, e = tower["moe_intermediate_size"] * tower["n_shared_experts"], tower["moe_intermediate_size"], \
        tower["n_routed_experts"]
    out.update({"mlp.gate.weight": (e, h), "mlp.gate.e_score_correction_bias": (e,),
                "mlp.shared_experts.gate_proj.weight": (s, h), "mlp.shared_experts.up_proj.weight": (s, h),
                "mlp.shared_experts.down_proj.weight": (h, s)})
    for x in range(e):
        out.update({f"mlp.experts.{x}.gate_proj.weight": (i, h), f"mlp.experts.{x}.up_proj.weight": (i, h),
                    f"mlp.experts.{x}.down_proj.weight": (h, i)})
    return out


def _made(seed: int, key: tuple, name: str, shape: tuple, tower: dict, dtype, device) -> torch.Tensor:
    """One tensor, drawn in fp32 from its own generator: a norm's gain 1 +
    N(0, range^2), the router's correction bias N(0, bias_std^2) kept in
    fp32, any other N(0, range^2) rounded to ``dtype`` (``range`` the
    tower's ``initializer_range``)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(data.stream_seed(seed, TOWER_STREAM, *key))
    out = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    if name.endswith("e_score_correction_bias"):
        return out.mul_(tower["e_score_correction_bias_std"])
    out.mul_(tower["initializer_range"])
    return (out.add_(1.0) if name.endswith("norm.weight") else out).to(dtype)


def embedding(seed: int, tower: dict, dtype, device) -> torch.Tensor:
    return _made(seed, (0,), "embed", (tower["vocab_size"], tower["hidden_size"]), tower, dtype, device)


def final_norm(seed: int, tower: dict, dtype, device) -> torch.Tensor:
    return _made(seed, (1,), "norm.weight", (tower["hidden_size"],), tower, dtype, device)


def layer_weights(seed: int, tower: dict, layer: int, dtype, device) -> dict:
    """Layer ``layer``'s tensors, in ``DeepseekV3Model``'s names under
    ``layers.<layer>.``."""
    return {name: _made(seed, (2, layer, j), name, shape, tower, dtype, device)
            for j, (name, shape) in enumerate(layer_shapes(tower, layer).items())}


def state_dict(seed: int, tower: dict, dtype, device) -> dict:
    """The whole tower as a ``DeepseekV3Model`` state dict."""
    out = {"embed_tokens.weight": embedding(seed, tower, dtype, device),
           "norm.weight": final_norm(seed, tower, dtype, device)}
    for i in range(tower["num_hidden_layers"]):
        out.update({f"layers.{i}.{k}": v for k, v in layer_weights(seed, tower, i, dtype, device).items()})
    return out


@contextlib.contextmanager
def seeded_checkpoint(seed: int, tower: dict, dtype, device, vocab: list):
    """A checkpoint directory ``E5MistralEncoder`` opens: a word-level
    tokenizer on disk, and the seeded weights handed to the encoder by
    transformers' model loader (made when it asks, dropped after)."""
    import transformers
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    loader = transformers.AutoModel.from_pretrained
    hf_config = SimpleNamespace(**tower)

    class Seeded:
        config = hf_config

        @staticmethod
        def state_dict():
            return state_dict(seed, tower, dtype, device)

    with tempfile.TemporaryDirectory(prefix="bench-port-moonlight-") as tmp:
        path = Path(tmp)
        specials = _E5.SPECIALS
        words = Tokenizer(models.WordLevel({w: i for i, w in enumerate(vocab)}, unk_token=specials[0]))
        words.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
        PreTrainedTokenizerFast(tokenizer_object=words, unk_token=specials[0], bos_token=specials[1],
                                eos_token=specials[2]).save_pretrained(path)

        def load(name, *args, **kwargs):
            if Path(name) == path:
                return Seeded()
            return loader(name, *args, **kwargs)

        transformers.AutoModel.from_pretrained = staticmethod(load)
        try:
            yield path
        finally:
            transformers.AutoModel.from_pretrained = loader


def make(config: dict, seed: int, texts: list, device) -> tuple:
    """The program's encoder, and what the reference takes: the vocabulary
    and the seed (no weights), and, for :func:`program_choices`, the
    encoder and the pools' texts in the order the loop gives them."""
    from fastforward_tpu_torch.encoder import E5MistralEncoder

    tower = config["tower"]
    vocab = _E5.vocabulary(tower["vocab_size"])
    dtype = _DTYPES[config["compute_dtype"]]
    with seeded_checkpoint(seed, tower, dtype, device, vocab) as path:
        encoder = E5MistralEncoder(str(path), device=device, compute_dtype=config["compute_dtype"])
    return encoder, {"vocab": vocab, "seed": seed, "encoder": encoder, "texts": list(texts)}


def program_choices(texts: list, inputs: dict, config: dict) -> list:
    """The experts the program chose for each token of ``texts`` in each
    expert layer, as its timed calls chose them: each text's micro-batch is
    encoded again, after the window, through the same encoder call the
    index makes, with the tower's ``recording_choices`` open.

    The loop gives ``make`` its pools' texts one pool after another, and the
    index encodes a call's queries in that order in micro-batches of
    ``encoder_batch_size`` (which divides the queries of a call), so the
    window's micro-batches are the chunks of that list.  Every operation of
    the tower computes a token's row from that row and the chunk's shape
    alone, so the same chunk gives the same bits, and the same choices.

    :return: For each text, ``(layers, len, K)`` int64 on the host.
    """
    encoder, pooled, batch = inputs["encoder"], inputs["texts"], config["encoder_batch_size"]
    if len(pooled) % batch:
        raise ValueError(f"{len(pooled)} pooled texts are not whole micro-batches of {batch}")
    first = {}
    for i, t in enumerate(pooled):
        first.setdefault(t, i)
    index = {w: i for i, w in enumerate(inputs["vocab"])}
    kept = inputs.setdefault("choices", {})
    for start in sorted({first[t] // batch * batch for t in texts if t not in kept}):
        part = pooled[start:start + batch]
        with encoder.tower.recording_choices() as record:
            encoder(part)
        ids = torch.stack(record).cpu().long()  # (layers, B * L, K)
        length = ids.shape[1] // len(part)
        for row, t in enumerate(part):
            n = len(_E5.token_ids(t, index))
            kept.setdefault(t, ids.view(ids.shape[0], len(part), length, -1)[:, row, :n])
    return [kept[t] for t in texts]


# -- the reference -----------------------------------------------------------------


def _rope_pairs(x, cos, sin):
    """DeepSeek's RoPE on ``x`` ``(L, ..., dr)``: each pair ``(2i, 2i + 1)``
    turned by the angle of frequency ``i`` (``cos``, ``sin`` ``(L, dr /
    2)``, broadcast over the middle axes)."""
    pairs = x.unflatten(-1, (-1, 2))
    c, s = (t.view(t.shape[0], *([1] * (x.ndim - 2)), t.shape[1]) for t in (cos, sin))
    even, odd = pairs[..., 0], pairs[..., 1]
    return torch.stack([even * c - odd * s, even * s + odd * c], -1).flatten(-2)


def _swiglu(h, w, pre, mm):
    gate, up = mm(h, w[pre + "gate_proj.weight"].T), mm(h, w[pre + "up_proj.weight"].T)
    return mm(gate * torch.sigmoid(gate) * up, w[pre + "down_proj.weight"].T)


def _experts(h, w, tower, mm, choices, forced, routing):
    """The expert layer over every token: the shared experts plus the 6
    chosen, weighted by their unbiased scores.  With ``forced`` (``(tokens,
    6)``, the program's choices) a token takes the program's 6 where each
    lies within reach of the 6th biased score (:func:`reach`), else its
    own top 6."""
    router = w["mlp.gate.weight"]
    scores = torch.sigmoid(mm(h, router.T))
    biased = scores + w["mlp.gate.e_score_correction_bias"]
    chosen = torch.topk(biased, tower["num_experts_per_tok"], dim=-1).indices
    if forced is not None:
        near = reach(h, router, scores)
        forced = forced.to(h.device)
        sixth = chosen[:, -1:]
        below = biased.gather(1, sixth) - biased.gather(1, forced)  # > 0: under the 6th
        room = near.gather(1, forced) + near.gather(1, sixth)
        used = torch.where(below > 0, below / room, 0.0).amax(1)  # share of the reach a token's choices take
        ok = used <= 1
        routing["pairs"] += forced.numel()
        routing["differ"] += int((forced[:, :, None] != chosen[:, None, :]).all(2).sum())
        routing["out_of_reach"] += int((~ok).sum())
        routing["reach_used"] = max(routing["reach_used"], float(used[ok].max()) if bool(ok.any()) else 0.0)
        chosen = torch.where(ok[:, None], forced, chosen)
    if choices is not None:
        choices.append(chosen.cpu())
    weights = scores.gather(1, chosen)
    if tower["norm_topk_prob"]:
        weights = weights / weights.sum(-1, keepdim=True)
    weights = weights * tower["routed_scaling_factor"]
    out = _swiglu(h, w, "mlp.shared_experts.", mm)
    for e in torch.unique(chosen).tolist():
        tok, k = torch.nonzero(chosen == e, as_tuple=True)
        out = out.index_add(0, tok, weights[tok, k, None] * _swiglu(h[tok], w, f"mlp.experts.{e}.", mm))
    return out


def reach(h, router, scores) -> torch.Tensor:
    """How far each score ``sigmoid(W_r h)`` may move when the router's
    input ``h`` is rounded to bf16, as the program's router reads it: each
    element by at most 2^-8 of itself, so a logit by at most 2^-8 sum_i
    |W_r[e, i] h_i| and its sigmoid by that times ``s (1 - s)``.  A choice
    the program made by a bf16 rounding of a near-tie lies within the two
    scores' reach of the reference's 6th; a router that weighs or picks by
    anything else does not, once its choices differ from the reference's."""
    return 2.0**-8 * scores * (1 - scores) * (h.abs() @ router.abs().T)


def _layer(x, w, layer, spans, tables, tower, mm, choices, forced, routing):
    """One decoder layer over the tokens of every sequence (``x`` their
    rows one after another; ``spans`` each sequence's ``(start, end)``)."""
    heads, r = tower["num_attention_heads"], tower["kv_lora_rank"]
    dn, dr, dv = tower["qk_nope_head_dim"], tower["qk_rope_head_dim"], tower["v_head_dim"]
    eps = tower["rms_norm_eps"]
    h = _E5._rms(x, w["input_layernorm.weight"], eps)
    q = mm(h, w["self_attn.q_proj.weight"].T).view(-1, heads, dn + dr)
    kv_a = mm(h, w["self_attn.kv_a_proj_with_mqa.weight"].T)
    kv = mm(_E5._rms(kv_a[:, :r], w["self_attn.kv_a_layernorm.weight"], eps), w["self_attn.kv_b_proj.weight"].T)
    kv = kv.view(-1, heads, dn + dv)
    ctx = torch.empty((x.shape[0], heads, dv), dtype=x.dtype, device=x.device)
    for s, e in spans:
        cos, sin, allowed = tables[e - s]
        q_pe = _rope_pairs(q[s:e, :, dn:], cos, sin).transpose(0, 1)  # (heads, L, dr)
        k_pe = _rope_pairs(kv_a[s:e, r:], cos, sin)  # (L, dr): one head for all
        logits = mm(q[s:e, :, :dn].transpose(0, 1), kv[s:e, :, :dn].permute(1, 2, 0)) + mm(q_pe, k_pe.T)
        probs = torch.softmax((logits / math.sqrt(dn + dr)).masked_fill(~allowed, -math.inf), -1)
        ctx[s:e] = mm(probs, kv[s:e, :, dn:].transpose(0, 1)).transpose(0, 1)
    x = x + mm(ctx.view(x.shape[0], heads * dv), w["self_attn.o_proj.weight"].T)
    h = _E5._rms(x, w["post_attention_layernorm.weight"], eps)
    if layer < tower["first_k_dense_replace"]:
        return x + _swiglu(h, w, "mlp.", mm)
    return x + _experts(h, w, tower, mm, choices, forced, routing)


def reference(texts: list, inputs: dict, config: dict, precision: str, device, choices: "list | None" = None):
    """The reference's query vectors of ``texts``: float64, or the control's
    fp8 operands with fp32 accumulation (``"tf32"``).  Where ``inputs``
    holds the program's encoder (``make``'s), each token follows the
    program's choices (:func:`program_choices`) where they lie within
    reach of its own 6th score, and the control takes its own top 6 where
    they do not; without it, its own.  ``choices``, when given, receives
    each expert layer's chosen experts ``(tokens, 6)`` (the texts' tokens
    one after another).

    :raises RuntimeError: In float64, when a choice of the program lies out
        of reach: no bf16 rounding explains it, so the program routed wrongly.
    """
    if precision not in ("float64", "tf32"):
        raise ValueError(f"precision must be 'float64' or 'tf32', got {precision!r}")
    program = None
    if "encoder" in inputs:
        program = [torch.cat(c) for c in zip(*program_choices(texts, inputs, config))]
    routing = {"pairs": 0, "differ": 0, "out_of_reach": 0, "reach_used": 0.0}
    dt = torch.float64 if precision == "float64" else torch.float32

    def mm(a, b):
        if precision == "tf32":
            a, b = _E5.fp8_operand(a), _E5.fp8_operand(b)
        return a @ b

    tower, seed = config["tower"], inputs["seed"]
    wdt = _DTYPES[config["compute_dtype"]]
    index = {w: i for i, w in enumerate(inputs["vocab"])}
    seqs = [_E5.token_ids(t, index) for t in texts]
    ends = np.cumsum([len(s) for s in seqs])
    spans = list(zip((ends - [len(s) for s in seqs]).tolist(), ends.tolist()))
    dr, theta = tower["qk_rope_head_dim"], tower["rope_theta"]
    tables = {}
    for n in {len(s) for s in seqs}:
        pos = torch.arange(n, device=device, dtype=dt)
        angles = pos[:, None] * theta ** (-torch.arange(0, dr, 2, device=device, dtype=dt) / dr)
        tables[n] = (angles.cos(), angles.sin(), pos[None, :] <= pos[:, None])
    with _E5._no_tf32():
        ids = torch.tensor([i for s in seqs for i in s], device=device)
        x = embedding(seed, tower, wdt, device)[ids].to(dt)
        dense = tower["first_k_dense_replace"]
        for layer in range(tower["num_hidden_layers"]):
            w = {k: v.to(dt) for k, v in layer_weights(seed, tower, layer, wdt, device).items()}
            forced = None if program is None or layer < dense else program[layer - dense]
            x = _layer(x, w, layer, spans, tables, tower, mm, choices, forced, routing)
            del w
        last = _E5._rms(x[torch.as_tensor(ends - 1, device=device)],
                        final_norm(seed, tower, wdt, device).to(dt), tower["rms_norm_eps"])
    if program is not None:
        print(f"[reference] {precision}: of the program's {routing['pairs']} (token, layer, expert) choices, "
              f"{routing['differ']} differ from the reference's own top 6; {routing['out_of_reach']} of "
              f"{program[0].shape[0] * len(program)} (token, layer) choices out of reach, routed by the "
              f"reference's own; the followed ones take at most {routing['reach_used']:.4f} of their reach",
              file=sys.stderr, flush=True)
        if precision == "float64" and routing["out_of_reach"]:
            raise RuntimeError(f"{routing['out_of_reach']} of the program's (token, layer) routing choices lie out "
                               f"of reach of a bf16 rounding of the router's input: the program routed wrongly")
    return last / last.norm(dim=1, keepdim=True)


# -- the yardstick -----------------------------------------------------------------


def attn_flops(tower: dict, n: int) -> float:
    """Matmul operations of one sequence of ``n`` real tokens through every
    layer's latent attention: the projections (``2 n`` times q's ``H heads
    (dn + dr)``, kv_a's ``H (r + dr)``, kv_b's ``r heads (dn + dv)`` and o's
    ``heads dv H``) and, for each of the ``n (n + 1) / 2`` causal (query,
    key) pairs and head, ``2 (dn + dr)`` for the logit and ``2 dv`` for the
    context."""
    h, heads, r = tower["hidden_size"], tower["num_attention_heads"], tower["kv_lora_rank"]
    dn, dr, dv = tower["qk_nope_head_dim"], tower["qk_rope_head_dim"], tower["v_head_dim"]
    proj = 2.0 * n * (h * heads * (dn + dr) + h * (r + dr) + r * heads * (dn + dv) + heads * dv * h)
    pairs = n * (n + 1) / 2
    return tower["num_hidden_layers"] * (proj + 2.0 * pairs * heads * (dn + dr + dv))


def mlp_flops(tower: dict, n: int) -> float:
    """Matmul operations of ``n`` tokens through the dense layers' SwiGLU
    (``6 n H I`` a layer)."""
    return tower["first_k_dense_replace"] * 6.0 * n * tower["hidden_size"] * tower["intermediate_size"]


def moe_flops(tower: dict, tokens: float) -> float:
    """Matmul operations of ``tokens`` real tokens through one expert layer:
    the router (``2 H E``), the 6 chosen experts and the shared ones (``6 H
    I`` an expert of width ``I``) a token."""
    h, i, e = tower["hidden_size"], tower["moe_intermediate_size"], tower["n_routed_experts"]
    per_token = 2.0 * h * e + 6.0 * h * i * (tower["num_experts_per_tok"] + tower["n_shared_experts"])
    return tokens * per_token


def moe_bytes(tower: dict, value_bytes: int) -> float:
    """Bytes one expert layer must read: every routed expert, the shared
    experts and the router, once, ``value_bytes`` a weight."""
    h, i, e = tower["hidden_size"], tower["moe_intermediate_size"], tower["n_routed_experts"]
    return float(value_bytes) * (3 * h * i * (e + tower["n_shared_experts"]) + e * h)


def least_parts_s(config: dict, n_queries: int) -> dict:
    """Least time of each part of encoding ``n_queries`` queries, on each
    query's real tokens (their number uniform over the configuration's
    ``query_tokens`` range: the template, BOS and EOS, and 2-15 words):
    ``attn`` and ``mlp``, their matmul operations at the bf16 peak; ``moe``,
    for each micro-batch of ``encoder_batch_size`` queries and expert layer,
    the slower of its operations at the bf16 peak and its weights read once
    at the memory's rate."""
    tower = config["tower"]
    lo, hi = config["query_tokens"]
    lengths = range(lo, hi + 1)
    rate, mem = roofline.PEAKS["bf16_flops_per_s"], roofline.PEAKS["hbm_bytes_per_s"]
    attn = np.mean([attn_flops(tower, n) for n in lengths])
    mlp = np.mean([mlp_flops(tower, n) for n in lengths])
    batch = config["encoder_batch_size"]
    sizes = [batch] * (n_queries // batch) + ([n_queries % batch] if n_queries % batch else [])
    read = moe_bytes(tower, 2 if config["compute_dtype"] == "bfloat16" else 4) / mem
    moe = sum(max(moe_flops(tower, size * np.mean(lengths)) / rate, read) for size in sizes)
    layers = tower["num_hidden_layers"] - tower["first_k_dense_replace"]
    return {"attn": n_queries * attn / rate, "mlp": n_queries * mlp / rate, "moe": layers * moe}


def least_s(config: dict, n_queries: int) -> float:
    """Least time of encoding ``n_queries`` queries (all parts)."""
    return sum(least_parts_s(config, n_queries).values())
