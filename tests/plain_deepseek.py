"""A plain DeepSeek-V3 decoder forward pass, the reference the port's
``models/deepseek.py`` is tested against.

Plain ``torch`` in the caller's float type (float32 or float64), written
from DeepSeek-V3's published forward (DeepSeek-AI, 2024, arXiv:2412.19437,
and its ``inference/model.py``: ``MLA`` in its plain form, ``Gate``,
``MoE``, ``apply_rotary_emb``), with Moonlight-16B-A3B's choices (``q`` as
one projection, sigmoid scores, no group limit) and E5's pooling (Wang et
al., 2024, arXiv:2401.00368), one sequence at a time: no padding, no
batching, no cache, no kernel of the port, and neither the port nor JAX
imported.  With ``n(.)`` RMSNorm ``x / sqrt(mean(x^2) + eps) * g``::

    x_0 = E[ids]
    h   = x + W_o MLA(n_1(x))
    x'  = h + FFN(n_2(h))          (dense SwiGLU, or the expert layer)
    out = n_f(x_L)

MLA: ``q = W_q h`` split per head into ``q_nope`` and ``q_pe``; ``W_kv_a
h`` split into the latent ``c`` (RMSNorm'd) and ``k_pe`` (one head for
all); ``W_kv_b c`` split per head into ``k_nope`` and ``v``; RoPE on
``q_pe`` and ``k_pe`` as published, on pairs ``(2i, 2i + 1)`` as complex
numbers with the frequencies ``theta^(-2i / dr)``; causal softmax of
``(q_nope . k_nope + q_pe . k_pe) / sqrt(dn + dr)``.  The expert layer:
``s = sigmoid(W_r h)``, the top ``K`` of ``s + bias``, weights ``s_k /
sum s_k * routed_scaling_factor``, ``sum_k w_k E_k(h) + S(h)``.  Departures
from the published code: none in the arithmetic (the published code adds
no epsilon to the sum of the chosen scores, nor does this); the weights
are a ``DeepseekV3Model`` state dict's, and ``operands`` may round every
matmul's two operands first (the tests' lower-precision control).
"""

import contextlib
import math

import torch


@contextlib.contextmanager
def no_tf32():
    """``matmul.allow_tf32`` and ``cudnn.allow_tf32`` off inside the block."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _mm(a, b, operands):
    if operands is not None:
        a, b = operands(a), operands(b)
    return a @ b


def _rms(x, g, eps):
    return x / torch.sqrt((x * x).mean(-1, keepdim=True) + eps) * g


def rope_pairs(x: torch.Tensor, theta: float) -> torch.Tensor:
    """DeepSeek's RoPE on ``x`` ``(L, ..., dr)``: dims ``(2i, 2i + 1)`` as
    one complex number turned by ``pos * theta^(-2i / dr)``."""
    length, dr = x.shape[0], x.shape[-1]
    freqs = theta ** (-torch.arange(0, dr, 2, dtype=x.dtype) / dr)
    angles = torch.arange(length, dtype=x.dtype)[:, None] * freqs[None]
    turn = torch.polar(torch.ones_like(angles), angles).view(length, *([1] * (x.ndim - 2)), dr // 2)
    as_complex = torch.view_as_complex(x.reshape(*x.shape[:-1], dr // 2, 2).contiguous())
    return torch.view_as_real(as_complex * turn).reshape(x.shape)


def swiglu_mlp(h, w, pre, operands):
    """``W_down (silu(W_gate h) * W_up h)`` of the three ``<pre>*_proj.weight``."""
    gate = _mm(h, w[pre + "gate_proj.weight"].T, operands)
    up = _mm(h, w[pre + "up_proj.weight"].T, operands)
    return _mm(gate * torch.sigmoid(gate) * up, w[pre + "down_proj.weight"].T, operands)


def expert_layer(h, w, pre, config, operands=None) -> torch.Tensor:
    """``sum_k w_k E_k(h) + S(h)`` of the expert layer ``<pre>`` (``pre``
    ends in ``mlp.``): the top ``K`` experts of ``s + bias``, weighted by
    their unbiased scores ``s``."""
    scores = torch.sigmoid(_mm(h, w[pre + "gate.weight"].T, operands))
    chosen = torch.topk(scores + w[pre + "gate.e_score_correction_bias"], config["num_experts_per_tok"],
                        dim=-1).indices
    weights = scores.gather(1, chosen)
    if config.get("norm_topk_prob", True):
        weights = weights / weights.sum(-1, keepdim=True)
    weights = weights * config["routed_scaling_factor"]
    out = swiglu_mlp(h, w, pre + "shared_experts.", operands)
    for e in torch.unique(chosen).tolist():
        tok, k = torch.nonzero(chosen == e, as_tuple=True)
        out = out.index_add(0, tok, weights[tok, k, None] * swiglu_mlp(h[tok], w, f"{pre}experts.{e}.", operands))
    return out


def hidden(ids, weights: dict, config: dict, dtype=torch.float64, operands=None) -> torch.Tensor:
    """The final-normed hidden state ``(L, H)`` of one unpadded sequence.

    :param ids: Token ids ``(L,)``.
    :param weights: A ``DeepseekV3Model`` state dict (any float type).
    :param config: ``num_hidden_layers``, ``num_attention_heads``,
        ``qk_nope_head_dim``, ``qk_rope_head_dim``, ``v_head_dim``,
        ``kv_lora_rank``, ``first_k_dense_replace``,
        ``num_experts_per_tok``, ``routed_scaling_factor``,
        ``rms_norm_eps``, ``rope_theta`` (and ``norm_topk_prob``).
    :param operands: ``None``, or a function applied to both operands of
        every matmul.
    """
    with no_tf32():
        w = {k: v.detach().to(dtype) for k, v in weights.items()}
        return _hidden(torch.as_tensor(ids), w, config, operands)


def _hidden(ids, w, config, operands):
    heads, dn, dr = config["num_attention_heads"], config["qk_nope_head_dim"], config["qk_rope_head_dim"]
    dv, r, eps = config["v_head_dim"], config["kv_lora_rank"], config["rms_norm_eps"]
    length = len(ids)
    allowed = torch.ones(length, length, dtype=torch.bool).tril()
    x = w["embed_tokens.weight"][ids]
    for i in range(config["num_hidden_layers"]):
        p = f"layers.{i}."
        h = _rms(x, w[p + "input_layernorm.weight"], eps)
        q = _mm(h, w[p + "self_attn.q_proj.weight"].T, operands).view(length, heads, dn + dr)
        kv_a = _mm(h, w[p + "self_attn.kv_a_proj_with_mqa.weight"].T, operands)
        latent = _rms(kv_a[:, :r], w[p + "self_attn.kv_a_layernorm.weight"], eps)
        kv = _mm(latent, w[p + "self_attn.kv_b_proj.weight"].T, operands).view(length, heads, dn + dv)
        q_pe = rope_pairs(q[..., dn:], config["rope_theta"])
        k_pe = rope_pairs(kv_a[:, r:], config["rope_theta"])
        ctx = []
        for j in range(heads):
            logits = (_mm(q[:, j, :dn], kv[:, j, :dn].T, operands) + _mm(q_pe[:, j], k_pe.T, operands))
            logits = (logits / math.sqrt(dn + dr)).masked_fill(~allowed, -math.inf)
            ctx.append(_mm(torch.softmax(logits, -1), kv[:, j, dn:], operands))
        x = x + _mm(torch.cat(ctx, -1), w[p + "self_attn.o_proj.weight"].T, operands)
        h = _rms(x, w[p + "post_attention_layernorm.weight"], eps)
        if i < config["first_k_dense_replace"]:
            x = x + swiglu_mlp(h, w, p + "mlp.", operands)
        else:
            x = x + expert_layer(h, w, p + "mlp.", config, operands)
    return _rms(x, w["norm.weight"], eps)


def embed_last_token(ids, weights, config, dtype=torch.float64, operands=None) -> torch.Tensor:
    """E5's vector of one sequence: the final hidden state at its last token
    (its EOS), L2-normalized."""
    out = hidden(ids, weights, config, dtype, operands)[-1]
    return out / out.norm()
