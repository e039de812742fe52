"""A Mistral decoder tower in PyTorch (E5-Mistral-7B-instruct's).

A port-only tower: the JAX package has no decoder.  One ``nn.Module``
runs Mistral's decoder stack (Jiang et al., 2023, arXiv:2310.06825) as an
embedder (Wang et al., 2024, arXiv:2401.00368), with ``n(.)`` RMSNorm
``x / sqrt(mean(x^2) + eps) * g``::

    x_0 = E[ids]
    h   = x + W_o Attn(RoPE(W_q n_1(x)), RoPE(W_k n_1(x)), W_v n_1(x))
    x'  = h + W_down (silu(W_gate n_2(h)) * W_up n_2(h))
    out = n_f(x_L)

- attention is causal and windowed: a query at position ``p`` sees the
  keys at ``p - window < k <= p`` (transformers' sliding window), and
  padded keys (``mask == 0``) never; the logits are divided by
  ``sqrt(head_dim)`` and softmaxed in fp32;
- grouped-query attention: query head ``j`` reads key/value head
  ``j // (heads / kv_heads)``;
- RoPE rotates half of each head (``x cos + rotate_half(x) sin``) with the
  frequencies ``theta^(-2i / head_dim)``, in fp32, at positions ``0..L-1``
  (right padding);
- every RMSNorm, RoPE, the softmax and SiLU run in fp32; with
  ``dtype="bfloat16"`` the weights and the activations between the blocks
  (the residual stream, the projections' outputs) are bf16, the
  projections accumulate in fp32, and q, k, the softmax weights and the
  context stay fp32 inside the attention; with ``"float32"`` everything is
  IEEE fp32.  TF32 is off inside :meth:`MistralTower.forward` either way
  (the attention's fp32 products do not hold bf16 values only).

The matmuls are plain ``torch.nn.functional.linear``/``torch.matmul``, as
in ``models/bert.py``; attention is written out (no
``scaled_dot_product_attention``), so its numerics do not depend on the
installed PyTorch.  Each layer's attention block runs in an ``ff.attn``
range and its MLP block in an ``ff.mlp`` range (``utils/tracing.py``).

Weights load from a transformers ``MistralModel`` state dict
(:func:`from_hf_torch`, :meth:`MistralTower.from_arrays`), whose tensors
the tower takes as they are where they already have the tower's dtype: a
7B tower is never held twice.
"""

import math
from collections.abc import Mapping
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from fastforward_tpu_torch.device import fp32_matmul
from fastforward_tpu_torch.utils.tracing import annotate

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

#: one layer's tensors: the tower's name -> the ``MistralModel`` state-dict
#: name under ``layers.<i>.``
LAYER_NAMES = {
    "q": "self_attn.q_proj.weight",
    "k": "self_attn.k_proj.weight",
    "v": "self_attn.v_proj.weight",
    "o": "self_attn.o_proj.weight",
    "gate": "mlp.gate_proj.weight",
    "up": "mlp.up_proj.weight",
    "down": "mlp.down_proj.weight",
    "attn_norm": "input_layernorm.weight",
    "mlp_norm": "post_attention_layernorm.weight",
}

#: the norms' gains, held in fp32 (their values are the checkpoint's)
NORMS = ("attn_norm", "mlp_norm")


@dataclass(frozen=True)
class MistralConfig:
    """Shape configuration of a Mistral decoder tower (defaults:
    Mistral-7B-v0.1's, which E5-Mistral-7B-instruct keeps)."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    intermediate_size: int = 14336
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    sliding_window: "int | None" = 4096  # None: plain causal attention
    # "bfloat16": bf16 weights and activations between the blocks (fp32
    # accumulation; norms, RoPE, softmax and SiLU in fp32); "float32": IEEE fp32
    dtype: str = "bfloat16"

    @classmethod
    def tiny(cls) -> "MistralConfig":
        """A small config for tests: two layers, two query heads a key/value
        head, a window of 8."""
        return cls(
            vocab_size=256,
            hidden_size=64,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            head_dim=16,
            intermediate_size=128,
            sliding_window=8,
            dtype="float32",
        )

    def shapes(self) -> dict:
        """One layer's weight shapes, ``(out, in)`` for the projections."""
        h, d, i = self.hidden_size, self.head_dim, self.intermediate_size
        return {
            "q": (self.num_heads * d, h), "k": (self.num_kv_heads * d, h),
            "v": (self.num_kv_heads * d, h), "o": (h, self.num_heads * d),
            "gate": (i, h), "up": (i, h), "down": (h, i),
            "attn_norm": (h,), "mlp_norm": (h,),
        }  # fmt: skip


def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in fp32 (``gain`` fp32), returned in ``x``'s dtype."""
    return F.rms_norm(x.float(), (x.shape[-1],), gain, eps).to(x.dtype)


def rope_tables(length: int, head_dim: int, theta: float, device) -> tuple:
    """``cos`` and ``sin`` of RoPE's angles at positions ``0..length-1``,
    ``(length, head_dim)`` fp32, each frequency twice (rotate-half form)."""
    inv_freq = theta ** (-torch.arange(0, head_dim, 2, device=device, dtype=torch.float32) / head_dim)
    angles = torch.arange(length, device=device, dtype=torch.float32)[:, None] * inv_freq[None]
    angles = torch.cat([angles, angles], dim=-1)
    return angles.cos(), angles.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``x cos + rotate_half(x) sin`` over the last axis; ``x`` is
    ``(..., L, heads, d)`` fp32, the tables ``(L, d)``."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, None] + rotated * sin[:, None]


def allowed_keys(attention_mask: torch.Tensor, window: "int | None") -> torch.Tensor:
    """Which keys each query sees, ``(B, 1, 1, L, L)`` bool: causal, within
    the window (``q - k < window``), and no padded key."""
    length = attention_mask.shape[1]
    pos = torch.arange(length, device=attention_mask.device)
    ok = pos[None, :] <= pos[:, None]
    if window is not None:
        ok = ok & (pos[:, None] - pos[None, :] < window)
    return ok[None, None, None] & attention_mask[:, None, None, None, :].bool()


class MistralTower(nn.Module):
    """A Mistral decoder stack: ids in, the final-normed hidden state out.

    The weights are frozen tensors (inference only); build a tower with
    :meth:`from_arrays` or :func:`from_hf_torch`, and move it with
    ``.to(device)``.
    """

    def __init__(self, config: MistralConfig, device: "str | torch.device | None" = None) -> None:
        """Create a tower with zero weights.

        :param config: The shape configuration (``dtype`` sets the weights'
            type; the norms' gains are fp32).
        :param device: Where the zero weights are made (``"meta"`` makes
            none, for a tower whose weights are handed over after).
        """
        super().__init__()
        if config.dtype not in _DTYPES:
            raise ValueError(f"dtype must be 'float32' or 'bfloat16', got {config.dtype!r}")
        if config.num_heads % config.num_kv_heads:
            raise ValueError("num_heads must be a multiple of num_kv_heads")
        self.config = config
        dt = _DTYPES[config.dtype]

        def frozen(shape, dtype):
            return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device), requires_grad=False)

        self.embed = frozen((config.vocab_size, config.hidden_size), dt)
        self.norm = frozen((config.hidden_size,), torch.float32)
        self.layers = nn.ModuleList()
        for _ in range(config.num_layers):
            layer = nn.Module()
            for key, shape in config.shapes().items():
                setattr(layer, key, frozen(shape, torch.float32 if key in NORMS else dt))
            self.layers.append(layer)

    @classmethod
    def from_arrays(cls, config: MistralConfig, state: Mapping[str, torch.Tensor]) -> "MistralTower":
        """A tower holding the tensors of a ``MistralModel`` state dict
        (``embed_tokens.weight``, ``layers.<i>.<name>`` of
        :data:`LAYER_NAMES`, ``norm.weight``), each cast to the tower's type:
        a tensor that already has it is taken as it is, on its device (no
        copy), so a tower built from bf16 tensors on the card holds those.

        :raises ValueError: When a tensor's shape does not fit the config.
        """
        tower = cls(config, device="meta")

        def take(owner: nn.Module, attr: str, value: torch.Tensor) -> None:
            want = getattr(owner, attr)
            if tuple(value.shape) != tuple(want.shape):
                raise ValueError(f"{attr}: shape {tuple(value.shape)} does not fit the config {tuple(want.shape)}")
            setattr(owner, attr, nn.Parameter(value.detach().to(want.dtype), requires_grad=False))

        take(tower, "embed", state["embed_tokens.weight"])
        take(tower, "norm", state["norm.weight"])
        for i, layer in enumerate(tower.layers):
            for key, name in LAYER_NAMES.items():
                take(layer, key, state[f"layers.{i}.{name}"])
        return tower

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """Run the tower; returns the final-normed hidden state ``(B, L, H)``
        fp32 (padded positions hold values that no pooling should read).

        :param input_ids: Token ids, ``(B, L)``, right-padded.
        :param attention_mask: 1 for real tokens, 0 for padding, ``(B, L)``.
        """
        cfg = self.config
        with fp32_matmul(input_ids.device):
            cos, sin = rope_tables(input_ids.shape[1], cfg.head_dim, cfg.rope_theta, input_ids.device)
            allowed = allowed_keys(attention_mask, cfg.sliding_window)
            x = self.embed[input_ids]
            for layer in self.layers:
                with annotate("ff.attn"):
                    x = self._attention(x, layer, cos, sin, allowed)
                with annotate("ff.mlp"):
                    x = self._mlp(x, layer)
            return F.rms_norm(x.float(), (x.shape[-1],), self.norm, cfg.rms_norm_eps)

    def _attention(self, x, p, cos, sin, allowed) -> torch.Tensor:
        cfg = self.config
        b, length, _ = x.shape
        kv, d = cfg.num_kv_heads, cfg.head_dim
        group = cfg.num_heads // kv
        h = rms_norm(x, p.attn_norm, cfg.rms_norm_eps)
        # (B, L, heads, d) -> (B, kv, group, L, d): query head j = (j // group, j % group)
        q = apply_rope(F.linear(h, p.q).view(b, length, kv * group, d).float(), cos, sin)
        k = apply_rope(F.linear(h, p.k).view(b, length, kv, d).float(), cos, sin)
        q = q.view(b, length, kv, group, d).permute(0, 2, 3, 1, 4)
        k = k.permute(0, 2, 1, 3)[:, :, None]
        v = F.linear(h, p.v).view(b, length, kv, d).permute(0, 2, 1, 3)[:, :, None].float()
        logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
        logits = logits.masked_fill(~allowed, torch.finfo(torch.float32).min)
        ctx = torch.matmul(torch.softmax(logits, dim=-1), v)  # (B, kv, group, L, d)
        ctx = ctx.permute(0, 3, 1, 2, 4).reshape(b, length, kv * group * d).to(x.dtype)
        return x + F.linear(ctx, p.o)

    def _mlp(self, x, p) -> torch.Tensor:
        h = rms_norm(x, p.mlp_norm, self.config.rms_norm_eps)
        act = F.silu(F.linear(h, p.gate).float()) * F.linear(h, p.up).float()
        return x + F.linear(act.to(x.dtype), p.down)


def pool_last_token(hidden: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """Each row's hidden state at its last real position (``mask == 1``; the
    EOS under right padding), ``(B, H)``."""
    pos = torch.arange(attention_mask.shape[1], device=attention_mask.device)
    last = (attention_mask.to(pos.dtype) * pos).argmax(dim=1)
    return hidden[torch.arange(hidden.shape[0], device=hidden.device), last]


def config_from_hf(cfg, dtype: str = "bfloat16") -> MistralConfig:
    """The tower's config of a transformers ``MistralConfig`` (or any object
    with its attributes).  RoPE's base is ``rope_theta`` (transformers 4) or
    ``rope_parameters["rope_theta"]`` (5).

    :raises ValueError: For another activation than SiLU or a RoPE scaling.
    """
    if getattr(cfg, "hidden_act", "silu") != "silu":
        raise ValueError(f"a Mistral tower runs SiLU, not {cfg.hidden_act!r}")
    rope = getattr(cfg, "rope_parameters", None) or {}
    if rope.get("rope_type", "default") != "default" or getattr(cfg, "rope_scaling", None):
        raise ValueError("a Mistral tower runs plain RoPE (no scaling)")
    theta = getattr(cfg, "rope_theta", None) or rope.get("rope_theta", 10000.0)
    heads = cfg.num_attention_heads
    return MistralConfig(
        vocab_size=cfg.vocab_size,
        hidden_size=cfg.hidden_size,
        num_layers=cfg.num_hidden_layers,
        num_heads=heads,
        num_kv_heads=getattr(cfg, "num_key_value_heads", None) or heads,
        head_dim=getattr(cfg, "head_dim", None) or cfg.hidden_size // heads,
        intermediate_size=cfg.intermediate_size,
        rms_norm_eps=cfg.rms_norm_eps,
        rope_theta=float(theta),
        sliding_window=getattr(cfg, "sliding_window", None),
        dtype=dtype,
    )


def from_hf_torch(model, dtype: str = "bfloat16") -> MistralTower:
    """A tower holding the weights of a transformers ``MistralModel`` (read
    from its state dict; transformers is only the weight source).  The
    tensors stay on their device; those already of ``dtype`` are shared,
    not copied.

    :param model: The model, or any object with ``config`` and
        ``state_dict()`` in ``MistralModel``'s names.
    :param dtype: The tower's compute type, ``"float32"`` or ``"bfloat16"``.
    """
    return MistralTower.from_arrays(config_from_hf(model.config, dtype), model.state_dict())
