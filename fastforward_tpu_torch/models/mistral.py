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
  (the fp32 tower's projections, and the plain attention's fp32 products,
  which do not hold bf16 values only).

The projections are plain ``torch.nn.functional.linear`` (cuBLAS on the
card).  Each fp32 chain between two of them is one function:
:func:`rms_norm` (the two norms of a layer and the final one),
:func:`rope_attention` (RoPE, the mask, the logits, the softmax and the
context) and :func:`swiglu`.  For CUDA tensors each launches its kernel
written by hand in ``ops/csrc/decoder.cu`` (built by ``ops/_build.py`` at
the first call), which reads its inputs once in the activation type,
computes in fp32 on CUDA cores and writes its output once, rounded where
the plain version rounds; for CPU tensors each runs its plain PyTorch
version (``*_plain``: the tower's arithmetic written out, the attention
with ``torch.matmul``).  The tensors' device picks the path.  Neither
path uses ``scaled_dot_product_attention``, and the card's path no fused
operator of PyTorch at all, so its numerics do not depend on the
installed PyTorch.  Each layer's attention block (norm, q/k/v, attention,
o, residual) runs in an ``ff.attn`` range and its MLP block (norm,
gate/up, SwiGLU, down, residual) in an ``ff.mlp`` range
(``utils/tracing.py``), kernels included.

Weights load from a transformers ``MistralModel`` state dict
(:func:`from_hf_torch`, :meth:`MistralTower.from_arrays`), whose tensors
the tower takes as they are where they already have the tower's dtype: a
7B tower is never held twice.
"""

import ctypes
import math
from collections.abc import Mapping
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from fastforward_tpu_torch.device import fp32_matmul
from fastforward_tpu_torch.ops import _build
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


# -- the fp32 chains between the GEMMs: plain versions and kernel wrappers ---------
#
# Each function below launches its kernel of ``ops/csrc/decoder.cu`` for
# CUDA tensors and runs its plain version (``*_plain``, the tower's PyTorch
# code) only for CPU tensors; a CUDA call the kernel does not take raises.


def rms_norm_plain(x: torch.Tensor, gain: torch.Tensor, eps: float,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """RMSNorm over the last axis in fp32 (``gain`` fp32), in ``out_dtype``."""
    return F.rms_norm(x.float(), (x.shape[-1],), gain, eps).to(out_dtype)


def rope_attention_plain(q, k, v, cos, sin, attention_mask, window) -> torch.Tensor:
    """RoPE on ``q`` and ``k``, then causal windowed grouped-query attention
    in fp32: :func:`rope_attention`'s arguments and result, written out."""
    b, length, heads, d = q.shape
    kv = k.shape[2]
    allowed = allowed_keys(attention_mask, window)
    # (B, L, heads, d) -> (B, kv, group, L, d): query head j = (j // group, j % group)
    qr = apply_rope(q.float(), cos, sin).view(b, length, kv, heads // kv, d).permute(0, 2, 3, 1, 4)
    kr = apply_rope(k.float(), cos, sin).permute(0, 2, 1, 3)[:, :, None]
    vr = v.permute(0, 2, 1, 3)[:, :, None].float()
    logits = torch.matmul(qr, kr.transpose(-1, -2)) / math.sqrt(d)
    logits = logits.masked_fill(~allowed, torch.finfo(torch.float32).min)
    ctx = torch.matmul(torch.softmax(logits, dim=-1), vr)  # (B, kv, group, L, d)
    return ctx.permute(0, 3, 1, 2, 4).reshape(b, length, heads * d).to(q.dtype)


def swiglu_plain(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``silu(gate) * up`` in fp32, in ``gate``'s dtype."""
    return (F.silu(gate.float()) * up.float()).to(gate.dtype)


#: the kernels' activation types (the C interface's codes)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: the head sizes the attention kernel is built for: E5-Mistral-7B's and
#: :meth:`MistralConfig.tiny`'s
KERNEL_HEAD_DIMS = (16, 128)

#: threads a block of the attention kernel (``kAttnWarps``); a query row
#: takes ``d / 16`` of them
_ATTN_BLOCK_THREADS = 256

_P, _I = ctypes.c_void_p, ctypes.c_int
_NORM_ARGS = (_P, _I, _P, _P, _I, ctypes.c_longlong, _I, ctypes.c_float, _I, _P)
_ATTN_ARGS = (_P,) * 7 + (_I,) * 7 + (ctypes.c_float, _I, _P)
_SWIGLU_ARGS = (_P, _P, _P, _I, ctypes.c_longlong, _I, _P)


def _target(named) -> tuple[int, int]:
    """The CUDA device index and stream of the named tensors, after checking
    that they share one CUDA device and are contiguous and 16-byte aligned.

    :raises ValueError: When they are not.
    """
    devices = {t.device for _, t in named}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {sorted(map(str, devices))}")
    target = _build.cuda_target(named)
    for name, t in named:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return target


def _activation(name: str, t: torch.Tensor) -> int:
    if t.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    return _DTYPE_CODE[t.dtype]


def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float,
             out_dtype: "torch.dtype | None" = None) -> torch.Tensor:
    """RMSNorm ``x / sqrt(mean(x^2) + eps) * gain`` over the last axis in
    fp32: the kernel on the card, :func:`rms_norm_plain` on the CPU.

    :param x: Activations ``(..., H)``, fp32 or bf16.
    :param gain: ``(H,)`` fp32.
    :param out_dtype: The result's type (``x``'s when ``None``); the card
        takes fp32 to fp32 and bf16 to bf16 or fp32.
    :raises TypeError: On a type the kernel does not take.
    :raises ValueError: On a shape, layout or device it does not take
        (``H % 8 != 0`` on the card).
    """
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if x.device.type == "cpu":
        return rms_norm_plain(x, gain, eps, out_dtype)
    code = _activation("x", x)
    if out_dtype not in _DTYPE_CODE or (code == 0 and out_dtype != torch.float32):
        raise TypeError("the card's RMSNorm takes fp32 to fp32 and bf16 to bf16 or fp32, "
                        f"not {x.dtype} to {out_dtype}")
    hidden = x.shape[-1]
    if gain.dtype != torch.float32 or tuple(gain.shape) != (hidden,):
        raise ValueError(f"gain must be float32 ({hidden},), got {gain.dtype} {tuple(gain.shape)}")
    if hidden % 8:
        raise ValueError(f"the card's RMSNorm needs H % 8 == 0, got {hidden}")
    device, stream = _target((("x", x), ("gain", gain)))
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    _build.bind("decoder", _NORM_ARGS, "decoder_rms_norm")(
        x.data_ptr(), code, gain.data_ptr(), out.data_ptr(), _DTYPE_CODE[out_dtype],
        x.numel() // hidden, hidden, eps, device, stream)
    _build.count_launch(rms_norm)
    return out


def rope_attention(q, k, v, cos, sin, attention_mask, window) -> torch.Tensor:
    """RoPE on ``q`` and ``k`` (fp32, from :func:`rope_tables`), then causal
    windowed grouped-query attention (:func:`allowed_keys`; query head ``j``
    on key/value head ``j // (heads / kv_heads)``), logits over
    ``sqrt(d)``, softmax and context in fp32: the kernel on the card,
    :func:`rope_attention_plain` on the CPU.

    :param q: ``(B, L, heads, d)``, fp32 or bf16, as the q GEMM wrote it.
    :param k: ``(B, L, kv_heads, d)``, as ``q``; ``v`` the same.
    :param cos: ``(L, d)`` fp32; ``sin`` the same.
    :param attention_mask: ``(B, L)``, 1 for real tokens (int32 on the card
        saves a conversion).
    :param window: Keys within ``q - k < window``, or ``None``.
    :return: The context ``(B, L, heads * d)`` in ``q``'s type, as the o
        GEMM reads it.
    :raises TypeError: On a type the kernel does not take.
    :raises ValueError: On a shape, layout or device it does not take.
    """
    if q.device.type == "cpu":
        return rope_attention_plain(q, k, v, cos, sin, attention_mask, window)
    code = _activation("q", q)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share a type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or tuple(k.shape) != tuple(v.shape) or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[3] or q.shape[2] % k.shape[2]:
        raise ValueError(f"q must be (B, L, heads, d) and k, v (B, L, kv_heads, d) with kv_heads "
                         f"dividing heads, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, length, heads, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the card's attention takes head sizes {KERNEL_HEAD_DIMS}, got {d}")
    for name, t in (("cos", cos), ("sin", sin)):
        if t.dtype != torch.float32 or tuple(t.shape) != (length, d):
            raise ValueError(f"{name} must be float32 ({length}, {d}), got {t.dtype} {tuple(t.shape)}")
    if tuple(attention_mask.shape) != (b, length):
        raise ValueError(f"attention_mask must be ({b}, {length}), got {tuple(attention_mask.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or positive, got {window}")
    if -(-length * (heads // k.shape[2]) // (_ATTN_BLOCK_THREADS * 16 // d)) > 65535:
        raise ValueError(f"{length} positions x {heads // k.shape[2]} query heads a key/value head "
                         "exceed the attention kernel's grid")
    mask = attention_mask if attention_mask.dtype == torch.int32 else attention_mask.to(torch.int32)
    device, stream = _target((("q", q), ("k", k), ("v", v), ("cos", cos), ("sin", sin),
                              ("attention_mask", mask)))
    out = torch.empty((b, length, heads * d), dtype=q.dtype, device=q.device)
    _build.bind("decoder", _ATTN_ARGS, "decoder_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(), sin.data_ptr(), mask.data_ptr(),
        out.data_ptr(), code, b, length, heads, k.shape[2], d, window or 0, 1 / math.sqrt(d),
        device, stream)
    _build.count_launch(rope_attention)
    return out


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``silu(gate) * up`` in fp32, in ``gate``'s type: the kernel on the
    card, :func:`swiglu_plain` on the CPU.

    :raises TypeError: On a type the kernel does not take.
    :raises ValueError: On a shape, layout or device it does not take.
    """
    if gate.device.type == "cpu":
        return swiglu_plain(gate, up)
    code = _activation("gate", gate)
    if up.dtype != gate.dtype or up.shape != gate.shape:
        raise ValueError(f"up must match gate, got {up.dtype} {tuple(up.shape)} and "
                         f"{gate.dtype} {tuple(gate.shape)}")
    device, stream = _target((("gate", gate), ("up", up)))
    out = torch.empty_like(gate)
    _build.bind("decoder", _SWIGLU_ARGS, "decoder_swiglu")(
        gate.data_ptr(), up.data_ptr(), out.data_ptr(), code, gate.numel(), device, stream)
    _build.count_launch(swiglu)
    return out


#: launches of each kernel (the plain versions do not count)
rms_norm.launches = rope_attention.launches = swiglu.launches = 0

#: the decoder kernels' wrappers, each counting its ``.launches``
KERNELS = (rms_norm, rope_attention, swiglu)


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
            keys = attention_mask.to(torch.int32)
            x = self.embed[input_ids]
            for layer in self.layers:
                with annotate("ff.attn"):
                    x = self._attention(x, layer, cos, sin, keys)
                with annotate("ff.mlp"):
                    x = self._mlp(x, layer)
            return rms_norm(x, self.norm, cfg.rms_norm_eps, torch.float32)

    def _attention(self, x, p, cos, sin, keys) -> torch.Tensor:
        cfg = self.config
        b, length, _ = x.shape
        h = rms_norm(x, p.attn_norm, cfg.rms_norm_eps)
        q = F.linear(h, p.q).view(b, length, cfg.num_heads, cfg.head_dim)
        k = F.linear(h, p.k).view(b, length, cfg.num_kv_heads, cfg.head_dim)
        v = F.linear(h, p.v).view(b, length, cfg.num_kv_heads, cfg.head_dim)
        ctx = rope_attention(q, k, v, cos, sin, keys, cfg.sliding_window)
        return x + F.linear(ctx, p.o)

    def _mlp(self, x, p) -> torch.Tensor:
        h = rms_norm(x, p.mlp_norm, self.config.rms_norm_eps)
        return x + F.linear(swiglu(F.linear(h, p.gate), F.linear(h, p.up)), p.down)


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
