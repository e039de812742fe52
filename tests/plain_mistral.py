"""A plain Mistral decoder forward pass, the reference the port's
``models/mistral.py`` is tested against.

Plain ``torch`` in the caller's float type (float32 or float64), written
from the published description (Jiang et al., 2023, arXiv:2310.06825;
E5-Mistral's pooling, Wang et al., 2024, arXiv:2401.00368), one sequence
at a time: no padding, no batching, no cache, no kernel of the port, and
neither the port nor JAX imported.  With ``n(.)`` RMSNorm ``x /
sqrt(mean(x^2) + eps) * g``::

    x_0 = E[ids]
    h   = x + W_o Attn(RoPE(W_q n_1(x)), RoPE(W_k n_1(x)), W_v n_1(x))
    x'  = h + W_down (silu(W_gate n_2(h)) * W_up n_2(h))
    out = n_f(x_L)

Attention is causal within the window (a query at ``p`` sees the keys at
``p - window < k <= p``), head by head, query head ``j`` on key/value
head ``j // (heads / kv_heads)``; RoPE rotates half of each head with the
frequencies ``theta^(-2i / d)`` at positions ``0..L-1``.  Departures from
the published description: none in the arithmetic; the weights are a
``MistralModel`` state dict's, and ``operands`` may round every matmul's
two operands first (the tests' lower-precision control).
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


def fp8_operand(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to fp8 e4m3 with one per-tensor scale (the largest
    magnitude to 448, e4m3's largest), back in ``x``'s type."""
    scale = x.abs().max().clamp(min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def _mm(a, b, operands):
    if operands is not None:
        a, b = operands(a), operands(b)
    return a @ b


def _rms(x, g, eps):
    return x / torch.sqrt((x * x).mean(-1, keepdim=True) + eps) * g


def hidden(ids, weights: dict, config: dict, dtype=torch.float64, operands=None) -> torch.Tensor:
    """The final-normed hidden state ``(L, H)`` of one unpadded sequence.

    :param ids: Token ids ``(L,)``.
    :param weights: A ``MistralModel`` state dict (any float type).
    :param config: ``num_hidden_layers``, ``num_attention_heads``,
        ``num_key_value_heads``, ``head_dim``, ``rms_norm_eps``,
        ``rope_theta``, ``sliding_window`` (``None``: no window).
    :param operands: ``None``, or a function applied to both operands of
        every matmul.
    """
    with no_tf32():
        return _hidden(ids, weights, config, dtype, operands)


def _hidden(ids, weights, config, dtype, operands):
    w = {k: v.detach().to(dtype) for k, v in weights.items()}
    heads, kv, d = config["num_attention_heads"], config["num_key_value_heads"], config["head_dim"]
    eps, window = config["rms_norm_eps"], config["sliding_window"]
    length = len(ids)
    pos = torch.arange(length, dtype=dtype)
    inv_freq = config["rope_theta"] ** (-torch.arange(0, d, 2, dtype=dtype) / d)
    angles = pos[:, None] * inv_freq[None]
    cos, sin = torch.cat([angles.cos()] * 2, -1), torch.cat([angles.sin()] * 2, -1)

    def rope(t):  # (L, d)
        return t * cos + torch.cat([-t[:, d // 2 :], t[:, : d // 2]], -1) * sin

    allowed = torch.ones(length, length, dtype=torch.bool).tril()
    if window is not None:
        allowed &= (pos[:, None] - pos[None, :]) < window
    x = w["embed_tokens.weight"][torch.as_tensor(ids)]
    for i in range(config["num_hidden_layers"]):
        p = f"layers.{i}."

        def lin(t, name):
            return _mm(t, w[p + name + ".weight"].T, operands)

        h = _rms(x, w[p + "input_layernorm.weight"], eps)
        q, k, v = lin(h, "self_attn.q_proj"), lin(h, "self_attn.k_proj"), lin(h, "self_attn.v_proj")
        ctx = []
        for j in range(heads):
            g = j // (heads // kv)
            qj = rope(q[:, j * d : (j + 1) * d])
            kj = rope(k[:, g * d : (g + 1) * d])
            logits = _mm(qj, kj.T, operands) / math.sqrt(d)
            logits = logits.masked_fill(~allowed, -math.inf)
            ctx.append(_mm(torch.softmax(logits, -1), v[:, g * d : (g + 1) * d], operands))
        x = x + lin(torch.cat(ctx, -1), "self_attn.o_proj")
        h = _rms(x, w[p + "post_attention_layernorm.weight"], eps)
        gate, up = lin(h, "mlp.gate_proj"), lin(h, "mlp.up_proj")
        x = x + lin(gate * torch.sigmoid(gate) * up, "mlp.down_proj")
    return _rms(x, w["norm.weight"], eps)


def embed_last_token(ids, weights, config, dtype=torch.float64, operands=None) -> torch.Tensor:
    """E5-Mistral's vector of one sequence: the final hidden state at its
    last token (its EOS), L2-normalized."""
    out = hidden(ids, weights, config, dtype, operands)[-1]
    return out / out.norm()
