"""A DeepSeek-V3 decoder tower in PyTorch (Moonlight-16B-A3B's).

A port-only tower: the JAX package has no decoder.  One ``nn.Module``
runs the DeepSeek-V3 block (DeepSeek-AI, 2024, arXiv:2412.19437) as an
embedder by E5's recipe (Wang et al., 2024, arXiv:2401.00368), with
``n(.)`` RMSNorm ``x / sqrt(mean(x^2) + eps) * g``::

    x_0 = E[ids]
    h   = x + W_o MLA(n_1(x))
    x'  = h + FFN(n_2(h))
    out = n_f(x_L)

- multi-head latent attention (``q_lora_rank`` null): ``q = W_q n_1(x)``,
  each head ``dn`` dims without RoPE and ``dr`` with it; ``c = n_kv(W_kv_a
  n_1(x))``, the latent of ``kv_lora_rank`` dims with its own RMSNorm, and
  ``k_pe``, ``dr`` dims of RoPE key that every head shares; ``W_kv_b c``
  gives each head ``dn`` dims of key and ``dv`` of value.  The logits are
  ``(q_nope . k_nope + RoPE(q_pe) . RoPE(k_pe)) / sqrt(dn + dr)``, causal,
  padded keys (``mask == 0``) never seen, softmaxed in fp32;
- RoPE rotates pairs ``(2i, 2i + 1)`` with the frequencies ``theta^(-2i /
  dr)`` (DeepSeek's layout).  The tower permutes the RoPE rows of ``W_q``
  (each head's) and of ``W_kv_a``'s ``k_pe`` once at load, evens first, so
  that the rotate-half form of ``models/mistral.py`` applies; ``q . k``
  is unchanged, each pair moving together in q and in k;
- the FFN of the first ``first_k_dense_replace`` layers is a dense SwiGLU;
  every later one is the expert layer: the router's scores ``s =
  sigmoid(W_r h)`` (fp32), its choice the top ``K`` of ``s +
  e_score_correction_bias`` (the bias picks, it does not weigh), the
  weights ``s_k / sum s_k * routed_scaling_factor`` over the ``K`` chosen
  (``norm_topk_prob``), and ``sum_k w_k E_k(h) + S(h)`` with ``E_k`` the
  routed SwiGLU experts and ``S`` the shared one (``n_shared_experts``
  experts as one SwiGLU of that many times the width).  No token is
  dropped; padded positions route to no expert (no pooling reads them);
- with ``dtype="bfloat16"`` the weights and the activations between the
  blocks are bf16, the projections accumulate in fp32, and every norm,
  RoPE, the softmax, SiLU, the router (logits, sigmoid, bias, top ``K``,
  weights) and the experts' weighted sum run in fp32; ``"float32"`` is
  IEEE fp32 throughout (TF32 off inside :meth:`DeepseekTower.forward`).

The projections, the router's logits and the shared expert are plain
``torch.nn.functional.linear`` (cuBLAS on the card); the norms and SwiGLU
are ``models/mistral.py``'s kernels, and the attention is the latent
instance of its attention kernel (``ops/csrc/decoder.cu``,
:func:`latent_attention`).  The expert layer's own kernels are in
``ops/csrc/moe.cu`` (:func:`moe_route`, :func:`moe_permute`,
:func:`grouped_gemm`, :func:`moe_combine`): the routing and the
expert-sorted order of the pairs stay on the card, so a forward never
waits for the host.  For CPU tensors each wrapper runs its plain PyTorch
version (``*_plain``); a CUDA call a kernel does not take raises.  Each
layer's attention block runs in an ``ff.attn`` range, a dense FFN block
in ``ff.mlp`` and an expert block (norm, router, dispatch, experts, shared
expert, combine, residual) in ``ff.moe`` (``utils/tracing.py``).
:meth:`DeepseekTower.moe_stats` reads the expert counts the card keeps
for the last micro-batches; :meth:`DeepseekTower.recording_choices` keeps
the choices themselves, for a check of the routing outside a timed path.

Weights load from a transformers ``DeepseekV3Model`` state dict
(:func:`from_hf_torch`, :meth:`DeepseekTower.from_arrays`), whose tensors
the tower takes as they are where they already have its dtype; the
experts stay separate tensors, read by the grouped GEMM through a table
of their addresses, so a 16B tower is never held twice.
"""

import contextlib
import ctypes
import math
import threading
from collections.abc import Mapping, Sequence
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from fastforward_tpu_torch.device import fp32_matmul
from fastforward_tpu_torch.models import mistral
from fastforward_tpu_torch.models.mistral import allowed_keys, apply_rope, rope_tables
from fastforward_tpu_torch.ops import _build
from fastforward_tpu_torch.utils.tracing import annotate

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

#: every layer's tensors: the tower's name -> the ``DeepseekV3Model``
#: state-dict name under ``layers.<i>.`` (``kv_a`` is split into the
#: latent's rows and ``k_rope``'s at load)
ATTN_NAMES = {
    "attn_norm": "input_layernorm.weight",
    "q": "self_attn.q_proj.weight",
    "kv_a": "self_attn.kv_a_proj_with_mqa.weight",
    "kv_norm": "self_attn.kv_a_layernorm.weight",
    "kv_b": "self_attn.kv_b_proj.weight",
    "o": "self_attn.o_proj.weight",
    "mlp_norm": "post_attention_layernorm.weight",
}
#: a dense layer's FFN
DENSE_NAMES = {"gate": "mlp.gate_proj.weight", "up": "mlp.up_proj.weight", "down": "mlp.down_proj.weight"}
#: an expert layer's router and shared expert
MOE_NAMES = {
    "router": "mlp.gate.weight",
    "router_bias": "mlp.gate.e_score_correction_bias",
    "shared_gate": "mlp.shared_experts.gate_proj.weight",
    "shared_up": "mlp.shared_experts.up_proj.weight",
    "shared_down": "mlp.shared_experts.down_proj.weight",
}
#: each routed expert's, under ``mlp.experts.<e>.``
EXPERT_NAMES = {"gate": "gate_proj.weight", "up": "up_proj.weight", "down": "down_proj.weight"}

#: tensors held in fp32 whatever the tower's dtype (their values are the
#: checkpoint's): the norms' gains and the router
FP32 = ("attn_norm", "kv_norm", "mlp_norm", "router", "router_bias")

#: micro-batches whose expert counts :meth:`DeepseekTower.moe_stats` keeps
MOE_STATS_SLOTS = 64


@dataclass(frozen=True)
class DeepseekConfig:
    """Shape configuration of a DeepSeek-V3 decoder tower (defaults:
    Moonlight-16B-A3B's ``config.json``)."""

    vocab_size: int = 163840
    hidden_size: int = 2048
    num_layers: int = 27
    num_heads: int = 16
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    kv_lora_rank: int = 512
    intermediate_size: int = 11264  # the dense layers' FFN
    moe_intermediate_size: int = 1408  # a routed expert's
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    rms_norm_eps: float = 1e-5
    rope_theta: float = 50000.0
    # "bfloat16": bf16 weights and activations between the blocks (fp32
    # accumulation; norms, RoPE, softmax, SiLU and the router in fp32);
    # "float32": IEEE fp32
    dtype: str = "bfloat16"

    @classmethod
    def tiny(cls) -> "DeepseekConfig":
        """A small config for tests: three layers, the first dense; 8
        experts, top 2, one shared; a latent of 16; q/k heads of 8 + 8 RoPE
        dims, v heads of 8."""
        return cls(
            vocab_size=256, hidden_size=64, num_layers=3, num_heads=4, qk_nope_head_dim=8,
            qk_rope_head_dim=8, v_head_dim=8, kv_lora_rank=16, intermediate_size=96,
            moe_intermediate_size=32, n_routed_experts=8, n_shared_experts=1, num_experts_per_tok=2,
            rope_theta=10000.0, dtype="float32",
        )  # fmt: skip

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def n_moe_layers(self) -> int:
        return self.num_layers - self.first_k_dense_replace

    def shapes(self, sparse: bool) -> dict:
        """One layer's weight shapes, ``(out, in)`` for the projections
        (``sparse``: an expert layer's router and shared expert; its routed
        experts' are :meth:`expert_shapes`)."""
        h, heads, r = self.hidden_size, self.num_heads, self.kv_lora_rank
        out = {
            "attn_norm": (h,), "q": (heads * self.qk_head_dim, h),
            "kv_latent": (r, h), "k_rope": (self.qk_rope_head_dim, h), "kv_norm": (r,),
            "kv_b": (heads * (self.qk_nope_head_dim + self.v_head_dim), r),
            "o": (h, heads * self.v_head_dim), "mlp_norm": (h,),
        }  # fmt: skip
        if not sparse:
            i = self.intermediate_size
            return {**out, "gate": (i, h), "up": (i, h), "down": (h, i)}
        s, e = self.moe_intermediate_size * self.n_shared_experts, self.n_routed_experts
        return {**out, "router": (e, h), "router_bias": (e,), "shared_gate": (s, h), "shared_up": (s, h),
                "shared_down": (h, s)}

    def expert_shapes(self) -> dict:
        h, i = self.hidden_size, self.moe_intermediate_size
        return {"gate": (i, h), "up": (i, h), "down": (h, i)}


def rope_row_order(rope_dim: int) -> torch.Tensor:
    """The RoPE rows in rotate-half order: DeepSeek's pairs ``(2i, 2i + 1)``
    become ``(i, i + rope_dim / 2)``, evens first."""
    return torch.cat([torch.arange(0, rope_dim, 2), torch.arange(1, rope_dim, 2)])


# -- the attention: plain version and kernel wrapper -------------------------------


def latent_attention_plain(q, k_nope, k_rope, v, cos, sin, attention_mask) -> torch.Tensor:
    """RoPE on the last ``dr`` dims of ``q`` and on ``k_rope``, then causal
    attention in fp32 with ``k_rope`` shared by every head:
    :func:`latent_attention`'s arguments and result, written out."""
    b, length, heads, dq = q.shape
    dn, dv = k_nope.shape[-1], v.shape[-1]
    allowed = allowed_keys(attention_mask, None)[:, :, 0]  # (B, 1, L, L)
    qf = q.float()
    qr = torch.cat([qf[..., :dn], apply_rope(qf[..., dn:], cos, sin)], -1).permute(0, 2, 1, 3)
    kr = apply_rope(k_rope.float()[:, :, None], cos, sin).expand(b, length, heads, dq - dn)
    kf = torch.cat([k_nope.float(), kr], -1).permute(0, 2, 1, 3)
    logits = torch.matmul(qr, kf.transpose(-1, -2)) / math.sqrt(dq)
    logits = logits.masked_fill(~allowed, torch.finfo(torch.float32).min)
    ctx = torch.matmul(torch.softmax(logits, dim=-1), v.float().permute(0, 2, 1, 3))
    return ctx.permute(0, 2, 1, 3).reshape(b, length, heads * dv).to(q.dtype)


#: the head sizes the latent attention kernel is built for (no-RoPE, RoPE,
#: v): DeepSeek-V3's and Moonlight's
LATENT_HEAD_DIMS = (128, 64, 128)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_LATENT_ARGS = (_P,) * 8 + (_I,) * 4 + (_LL,) * 5 + (_I, ctypes.c_float, _I, _P)


def _rows_of(name: str, t: torch.Tensor, b: int, length: int) -> tuple[int, int]:
    """Token and head strides of a ``(B, L, heads, d)`` (or ``(B, L, d)``)
    view whose rows the kernel reads where they lie.

    :raises ValueError: When its rows are not unit-stride, its tokens not
        evenly spaced, or a row not 16-byte aligned.
    """
    strides = t.stride()
    if strides[-1] != 1 or strides[0] != length * strides[1] or tuple(t.shape[:2]) != (b, length):
        raise ValueError(f"{name} must be ({b}, {length}, ...) rows of unit stride, evenly spaced, "
                         f"got {tuple(t.shape)} with strides {strides}")
    head = strides[2] if t.ndim == 4 else 0
    if t.data_ptr() % 16 or strides[1] * t.element_size() % 16 or head * t.element_size() % 16:
        raise ValueError(f"{name}'s rows must be 16-byte aligned")
    return strides[1], head


def latent_attention(q, k_nope, k_rope, v, cos, sin, attention_mask) -> torch.Tensor:
    """RoPE on the last ``dr`` dims of each head of ``q`` and on
    ``k_rope`` (fp32, from :func:`~fastforward_tpu_torch.models.mistral.
    rope_tables` of ``dr``), then causal attention with no window (padded
    keys never seen): logits over ``sqrt(dn + dr)``, softmax and context in
    fp32.  The kernel on the card (``decoder.cu``'s attention at
    :data:`LATENT_HEAD_DIMS`), :func:`latent_attention_plain` on the CPU.

    :param q: ``(B, L, heads, dn + dr)``, fp32 or bf16, contiguous.
    :param k_nope: ``(B, L, heads, dn)``, as ``q``; rows of unit stride
        (the kv_b GEMM's output, sliced); ``v`` ``(B, L, heads, dv)`` the same.
    :param k_rope: ``(B, L, dr)``, one RoPE key head for all heads.
    :param cos: ``(L, dr)`` fp32; ``sin`` the same.
    :param attention_mask: ``(B, L)``, 1 for real tokens (int32 on the card
        saves a conversion).
    :return: The context ``(B, L, heads * dv)`` in ``q``'s type.
    :raises TypeError: On a type the kernel does not take.
    :raises ValueError: On a shape, layout or device it does not take.
    """
    if q.device.type == "cpu":
        return latent_attention_plain(q, k_nope, k_rope, v, cos, sin, attention_mask)
    code = mistral._activation("q", q)
    if any(t.dtype != q.dtype for t in (k_nope, k_rope, v)):
        raise TypeError(f"q, k and v must share a type, got {q.dtype}, {k_nope.dtype}, {k_rope.dtype}, {v.dtype}")
    if q.ndim != 4 or k_nope.ndim != 4 or v.ndim != 4 or k_rope.ndim != 3:
        raise ValueError("q, k_nope and v must be (B, L, heads, d) and k_rope (B, L, d)")
    b, length, heads, dq = q.shape
    dn, dr, dv = k_nope.shape[3], k_rope.shape[2], v.shape[3]
    if (dn, dr, dv) != LATENT_HEAD_DIMS or dq != dn + dr:
        raise ValueError(f"the card's latent attention takes head sizes {LATENT_HEAD_DIMS} (no RoPE, "
                         f"RoPE, v), got q {dq}, k {dn} + {dr}, v {dv}")
    if k_nope.shape[2] != heads or v.shape[2] != heads:
        raise ValueError(f"k_nope and v must have q's {heads} heads")
    for name, t in (("cos", cos), ("sin", sin)):
        if t.dtype != torch.float32 or tuple(t.shape) != (length, dr):
            raise ValueError(f"{name} must be float32 ({length}, {dr}), got {t.dtype} {tuple(t.shape)}")
    if tuple(attention_mask.shape) != (b, length):
        raise ValueError(f"attention_mask must be ({b}, {length}), got {tuple(attention_mask.shape)}")
    if -(-length // 32) > 65535:
        raise ValueError(f"{length} positions exceed the attention kernel's grid")
    mask = attention_mask if attention_mask.dtype == torch.int32 else attention_mask.to(torch.int32)
    devices = {t.device for t in (q, k_nope, k_rope, v, cos, sin, mask)}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {sorted(map(str, devices))}")
    device, stream = mistral._target((("q", q), ("cos", cos), ("sin", sin), ("attention_mask", mask)))
    kn_tok, kn_head = _rows_of("k_nope", k_nope, b, length)
    kr_tok, _ = _rows_of("k_rope", k_rope, b, length)
    v_tok, v_head = _rows_of("v", v, b, length)
    out = torch.empty((b, length, heads * dv), dtype=q.dtype, device=q.device)
    _build.bind("decoder", _LATENT_ARGS, "decoder_latent_attention")(
        q.data_ptr(), k_nope.data_ptr(), k_rope.data_ptr(), v.data_ptr(), cos.data_ptr(), sin.data_ptr(),
        mask.data_ptr(), out.data_ptr(), code, b, length, heads, kn_tok, kn_head, kr_tok, v_tok, v_head,
        0, 1 / math.sqrt(dq), device, stream)
    _build.count_launch(latent_attention)
    return out


# -- the expert layer: plain versions and kernel wrappers ---------------------------


def moe_route_plain(logits, bias, mask, top_k: int, scale: float, norm: bool, counts) -> tuple:
    """:func:`moe_route` written out: the slots in (token, choice) order."""
    scores = torch.sigmoid(logits.float())
    order = torch.sort(scores + bias, dim=-1, descending=True, stable=True).indices[:, :top_k]
    picked = scores.gather(1, order)
    if norm:
        total = picked[:, 0]
        for k in range(1, top_k):
            total = total + picked[:, k]
        weights = picked / total[:, None] * scale
    else:
        weights = picked * scale
    real = (mask.reshape(-1) != 0)[:, None]
    ids = torch.where(real, order, -1).to(torch.int32)
    weights = torch.where(real, weights, 0.0)
    flat = ids.reshape(-1).long()
    hot = F.one_hot(flat.clamp(min=0), counts.numel()) * (flat >= 0)[:, None]
    slots = (hot.cumsum(0) - hot).gather(1, flat.clamp(min=0)[:, None])[:, 0]
    counts += hot.sum(0).to(counts.dtype)
    return ids, weights, torch.where(flat >= 0, slots, -1).to(torch.int32).view(ids.shape)


def moe_permute_plain(ids, slots, counts) -> tuple:
    """:func:`moe_permute` written out (the rows past the last segment 0)."""
    offsets = torch.zeros(counts.numel() + 1, dtype=torch.int64, device=counts.device)
    offsets[1:] = counts.long().cumsum(0)
    flat = ids.reshape(-1).long()
    real = flat >= 0
    pos = torch.where(real, offsets[flat.clamp(min=0)] + slots.reshape(-1).long(), -1)
    rows = torch.zeros(flat.numel(), dtype=torch.int32, device=ids.device)
    token = torch.arange(flat.numel(), device=ids.device) // ids.shape[1]
    rows[pos[real]] = token[real].to(torch.int32)
    return offsets.to(torch.int32), rows, pos.to(torch.int32).view(ids.shape)


def grouped_gemm_plain(a, rows, sets: Sequence[Sequence[torch.Tensor]], offsets) -> tuple:
    """:func:`grouped_gemm` written out: each segment's rows through its
    expert's matrix in fp32, in ``a``'s type (rows past the last segment
    0)."""
    bounds = offsets.tolist()
    src = a[: bounds[-1]] if rows is None else a[rows[: bounds[-1]].long()]
    outs = []
    for weights in sets:
        out = torch.zeros((a.shape[0] if rows is None else rows.numel(), weights[0].shape[0]), dtype=a.dtype,
                          device=a.device)
        for e, w in enumerate(weights):
            lo, hi = bounds[e], bounds[e + 1]
            if hi > lo:
                out[lo:hi] = F.linear(src[lo:hi].float(), w.float()).to(a.dtype)
        outs.append(out)
    return tuple(outs)


def moe_combine_plain(y, pos, weights, shared, residual) -> torch.Tensor:
    """:func:`moe_combine` written out."""
    real = pos >= 0
    rows = pos.long().clamp(min=0)
    acc = torch.zeros(residual.shape, dtype=torch.float32, device=residual.device)
    for k in range(pos.shape[1]):
        part = weights[:, k, None] * y[rows[:, k]].float()
        acc = acc + torch.where(real[:, k, None], part, 0.0)
    return ((acc + shared.float()) + residual.float()).to(residual.dtype)


_ROUTE_ARGS = (_P, _P, _P, _LL, _I, _I, _I, ctypes.c_float, _P, _P, _P, _P, _I, _P)
_PERMUTE_ARGS = (_P, _P, _P, _LL, _I, _I, _P, _P, _P, _I, _P)
_GEMM_ARGS = (_P, _P, _LL, _P, _I, _P, _I, _LL, _I, _I, _P, _P, _I, _P)
_COMBINE_ARGS = (_P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _P)

#: the router's limits on the card (``moe.cu``'s ``kMaxExperts``, ``kMaxTopK``)
KERNEL_MAX_EXPERTS, KERNEL_MAX_TOP_K = 256, 8


def _expect(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {dtype} {tuple(shape)}, got {t.dtype} {tuple(t.shape)}")


def moe_route(logits, bias, mask, top_k: int, scale: float, norm: bool, counts) -> tuple:
    """The router after its logits: ``s = sigmoid(logits)``, the ``top_k``
    experts of ``s + bias`` (ties to the lower expert), in that order, their
    weights ``s_k / sum s_k * scale`` (``norm``; else ``s_k * scale``), and
    each pair's slot among its expert's pairs, counted into ``counts``.  A
    token with ``mask == 0`` routes to no expert (id and slot -1, weight 0).
    The kernel on the card, :func:`moe_route_plain` on the CPU (slots in
    token order there; on the card in the order the pairs arrive).

    :param logits: ``(T, E)`` fp32.
    :param bias: ``(E,)`` fp32.
    :param mask: ``(T,)`` int32 (any integer type on the CPU).
    :param counts: ``(E,)`` int32, zeroed by the caller; added to.
    :return: ``ids`` ``(T, top_k)`` int32, ``weights`` fp32, ``slots`` int32.
    :raises ValueError: On a shape, type or device the kernel does not take.
    """
    if logits.device.type == "cpu":
        return moe_route_plain(logits, bias, mask, top_k, scale, norm, counts)
    if logits.ndim != 2:
        raise ValueError(f"logits must be (T, E), got {tuple(logits.shape)}")
    tokens, experts = logits.shape
    _expect("logits", logits, torch.float32, (tokens, experts))
    _expect("bias", bias, torch.float32, (experts,))
    _expect("mask", mask, torch.int32, (tokens,))
    _expect("counts", counts, torch.int32, (experts,))
    if experts > KERNEL_MAX_EXPERTS or not 0 < top_k <= min(experts, KERNEL_MAX_TOP_K):
        raise ValueError(f"the card's router takes up to {KERNEL_MAX_EXPERTS} experts and top_k up to "
                         f"{KERNEL_MAX_TOP_K}, got {experts} and {top_k}")
    device, stream = mistral._target((("logits", logits), ("bias", bias), ("mask", mask), ("counts", counts)))
    ids = torch.empty((tokens, top_k), dtype=torch.int32, device=logits.device)
    weights = torch.empty((tokens, top_k), dtype=torch.float32, device=logits.device)
    slots = torch.empty_like(ids)
    _build.bind("moe", _ROUTE_ARGS, "moe_route")(
        logits.data_ptr(), bias.data_ptr(), mask.data_ptr(), tokens, experts, top_k, int(norm), scale,
        ids.data_ptr(), weights.data_ptr(), slots.data_ptr(), counts.data_ptr(), device, stream)
    _build.count_launch(moe_route)
    return ids, weights, slots


def moe_permute(ids, slots, counts) -> tuple:
    """The pairs in expert order: ``offsets`` ``(E + 1,)`` (expert ``e``'s
    rows are ``offsets[e]:offsets[e + 1]``), ``rows`` ``(T * K,)`` (the
    token of each row; only the first ``offsets[E]`` are set) and ``pos``
    ``(T, K)`` (each pair's row, -1 for a padded token), all int32.  The
    kernel on the card, :func:`moe_permute_plain` on the CPU.

    :raises ValueError: On a shape, type or device the kernel does not take.
    """
    if ids.device.type == "cpu":
        return moe_permute_plain(ids, slots, counts)
    if ids.ndim != 2:
        raise ValueError(f"ids must be (T, K), got {tuple(ids.shape)}")
    experts = counts.numel()
    _expect("ids", ids, torch.int32, ids.shape)
    _expect("slots", slots, torch.int32, ids.shape)
    _expect("counts", counts, torch.int32, (experts,))
    if experts > KERNEL_MAX_EXPERTS:
        raise ValueError(f"the card's permutation takes up to {KERNEL_MAX_EXPERTS} experts, got {experts}")
    device, stream = mistral._target((("ids", ids), ("slots", slots), ("counts", counts)))
    offsets = torch.empty(experts + 1, dtype=torch.int32, device=ids.device)
    rows = torch.empty(ids.numel(), dtype=torch.int32, device=ids.device)
    pos = torch.empty_like(ids)
    _build.bind("moe", _PERMUTE_ARGS, "moe_permute")(
        ids.data_ptr(), slots.data_ptr(), counts.data_ptr(), ids.numel(), ids.shape[1], experts,
        offsets.data_ptr(), rows.data_ptr(), pos.data_ptr(), device, stream)
    _build.count_launch(moe_permute)
    return offsets, rows, pos


class ExpertBank:
    """One or two sets of ``E`` expert matrices ``(N, K)`` of one shape
    (gate and up, or down), kept as the tensors they are, and on the card a
    table of their addresses for :func:`grouped_gemm` (built at its first
    call on a device; the bank is built again when the weights move)."""

    def __init__(self, sets: Sequence[Sequence[torch.Tensor]]) -> None:
        self.sets = tuple(tuple(s) for s in sets)
        shape = tuple(self.sets[0][0].shape)
        if any(tuple(w.shape) != shape for s in self.sets for w in s) or len({len(s) for s in self.sets}) != 1:
            raise ValueError("an expert bank's sets hold the same number of matrices of one shape")
        self.shape = shape
        self._table = None

    def table(self) -> torch.Tensor:
        """``(sets * E,)`` int64 device addresses, set after set."""
        if self._table is None:
            first = self.sets[0][0]
            ptrs = [w.data_ptr() for s in self.sets for w in s]
            self._table = torch.tensor(ptrs, dtype=torch.int64).to(first.device)
        return self._table


def grouped_gemm(a, rows, bank: ExpertBank, offsets) -> tuple:
    """For each set of ``bank``, ``C[r] = A[rows[r]] W_e^T`` over the rows
    ``r`` of each expert ``e``'s segment ``offsets[e]:offsets[e + 1]``
    (``rows`` ``None``: ``A``'s row ``r``), fp32 sums, in ``a``'s type; one
    ``C`` of ``rows.numel()`` (or ``a``'s) rows a set, the rows past the last
    segment not written on the card.  The kernel on the card (bf16 only),
    :func:`grouped_gemm_plain` on the CPU.

    :param a: ``(M, K)``, contiguous.
    :param rows: ``(R,)`` int32 row numbers of ``a``, or ``None``.
    :param offsets: ``(E + 1,)`` int32, on the device.
    :raises TypeError: On a type the kernel does not take.
    :raises ValueError: On a shape, layout or device it does not take.
    """
    if a.device.type == "cpu":
        return grouped_gemm_plain(a, rows, bank.sets, offsets)
    n, k = bank.shape
    experts = len(bank.sets[0])
    if a.dtype != torch.bfloat16 or bank.sets[0][0].dtype != torch.bfloat16:
        raise TypeError(f"the card's grouped GEMM takes bf16, got {a.dtype} and {bank.sets[0][0].dtype}")
    if a.ndim != 2 or a.shape[1] != k:
        raise ValueError(f"a must be (M, {k}), got {tuple(a.shape)}")
    if n % 64 or k % 32 or len(bank.sets) > 2:
        raise ValueError(f"the card's grouped GEMM takes N % 64 == 0, K % 32 == 0 and one or two sets, "
                         f"got ({n}, {k}) x {len(bank.sets)}")
    _expect("offsets", offsets, torch.int32, (experts + 1,))
    named = [("a", a), ("offsets", offsets)]
    if rows is not None:
        _expect("rows", rows, torch.int32, rows.shape)
        named.append(("rows", rows))
    total = a.shape[0] if rows is None else rows.numel()
    if -(-total // 64) + experts > 65535:
        raise ValueError(f"{total} rows exceed the grouped GEMM's grid")
    device, stream = mistral._target(named)
    table = bank.table()
    if table.device != a.device:
        raise ValueError(f"the experts are on {table.device}, a on {a.device}")
    outs = [torch.empty((total, n), dtype=a.dtype, device=a.device) for _ in bank.sets]
    _build.bind("moe", _GEMM_ARGS, "moe_grouped_gemm")(
        a.data_ptr(), 0 if rows is None else rows.data_ptr(), k, table.data_ptr(), len(outs),
        offsets.data_ptr(), experts, total, n, k, outs[0].data_ptr(), outs[-1].data_ptr(), device, stream)
    _build.count_launch(grouped_gemm)
    return tuple(outs)


def moe_combine(y, pos, weights, shared, residual) -> torch.Tensor:
    """``residual + shared + sum_k weights[t, k] y[pos[t, k]]`` a token, in
    fp32 (the pairs summed in choice order, then the shared expert's row,
    then the residual), rounded to ``residual``'s type once.  The kernel on
    the card (bf16 only), :func:`moe_combine_plain` on the CPU.

    :param y: ``(R, H)`` expert outputs in expert order.
    :param pos: ``(T, K)`` int32 rows of ``y`` (-1: none); ``weights``
        ``(T, K)`` fp32.
    :param shared: ``(T, H)``; ``residual`` the same.
    :raises TypeError: On a type the kernel does not take.
    :raises ValueError: On a shape, layout or device it does not take.
    """
    if residual.device.type == "cpu":
        return moe_combine_plain(y, pos, weights, shared, residual)
    if any(t.dtype != torch.bfloat16 for t in (y, shared, residual)):
        raise TypeError("the card's combine takes bf16 rows")
    tokens, hidden = residual.shape
    _expect("shared", shared, torch.bfloat16, (tokens, hidden))
    _expect("pos", pos, torch.int32, (tokens, pos.shape[1]))
    _expect("weights", weights, torch.float32, tuple(pos.shape))
    if y.ndim != 2 or y.shape[1] != hidden or hidden % 8:
        raise ValueError(f"y must be (R, {hidden}) with the width a multiple of 8, got {tuple(y.shape)}")
    device, stream = mistral._target((("y", y), ("pos", pos), ("weights", weights), ("shared", shared),
                                      ("residual", residual)))
    out = torch.empty_like(residual)
    _build.bind("moe", _COMBINE_ARGS, "moe_combine")(
        y.data_ptr(), pos.data_ptr(), weights.data_ptr(), shared.data_ptr(), residual.data_ptr(),
        out.data_ptr(), tokens, pos.shape[1], hidden, device, stream)
    _build.count_launch(moe_combine)
    return out


#: launches of each kernel (the plain versions do not count)
latent_attention.launches = moe_route.launches = moe_permute.launches = 0
grouped_gemm.launches = moe_combine.launches = 0

#: the tower's own kernels' wrappers, each counting its ``.launches`` (it
#: also launches ``mistral.rms_norm`` and ``mistral.swiglu``)
KERNELS = (latent_attention, moe_route, moe_permute, grouped_gemm, moe_combine)


class DeepseekTower(nn.Module):
    """A DeepSeek-V3 decoder stack: ids in, the final-normed hidden state out.

    The weights are frozen tensors (inference only); build a tower with
    :meth:`from_arrays` or :func:`from_hf_torch`, and move it with
    ``.to(device)``.
    """

    def __init__(self, config: DeepseekConfig, device: "str | torch.device | None" = None) -> None:
        """Create a tower with zero weights.

        :param config: The shape configuration (``dtype`` sets the weights'
            type; the norms' gains and the router are fp32).
        :param device: Where the zero weights are made (``"meta"`` makes
            none, for a tower whose weights are handed over after).
        """
        super().__init__()
        if config.dtype not in _DTYPES:
            raise ValueError(f"dtype must be 'float32' or 'bfloat16', got {config.dtype!r}")
        self.config = config
        dt = _DTYPES[config.dtype]

        def frozen(shape, key):
            return nn.Parameter(torch.zeros(shape, dtype=torch.float32 if key in FP32 else dt, device=device),
                                requires_grad=False)

        self.embed = frozen((config.vocab_size, config.hidden_size), "embed")
        self.norm = frozen((config.hidden_size,), "attn_norm")
        self.layers = nn.ModuleList()
        for i in range(config.num_layers):
            layer = nn.Module()
            sparse = i >= config.first_k_dense_replace
            for key, shape in config.shapes(sparse).items():
                setattr(layer, key, frozen(shape, key))
            if sparse:
                for key, shape in config.expert_shapes().items():
                    setattr(layer, f"experts_{key}",
                            nn.ParameterList(frozen(shape, key) for _ in range(config.n_routed_experts)))
            self.layers.append(layer)
        self._banks: dict = {}
        self._stats = None  # (MOE_STATS_SLOTS, n_moe_layers, E) int32 counts, on the card
        self._micro_batches = 0
        self._stats_lock = threading.Lock()
        self._choices = None  # a list while recording_choices() is open

    def _apply(self, fn, *args, **kwargs):
        self._banks, self._stats, self._micro_batches = {}, None, 0
        return super()._apply(fn, *args, **kwargs)

    @classmethod
    def from_arrays(cls, config: DeepseekConfig, state: Mapping[str, torch.Tensor]) -> "DeepseekTower":
        """A tower holding the tensors of a ``DeepseekV3Model`` state dict
        (``embed_tokens.weight``, ``layers.<i>.<name>`` of
        :data:`ATTN_NAMES`, :data:`DENSE_NAMES` or :data:`MOE_NAMES` and
        ``layers.<i>.mlp.experts.<e>.<name>`` of :data:`EXPERT_NAMES`,
        ``norm.weight``), each cast to its type in the tower: a tensor that
        already has it is taken as it is, on its device (no copy).  Only the
        rows of ``W_q`` and ``W_kv_a`` that RoPE reads are copied, from
        DeepSeek's pairs into rotate-half order (:func:`rope_row_order`).

        :raises ValueError: When a tensor's shape does not fit the config.
        """
        tower = cls(config, device="meta")
        cfg = config
        order = rope_row_order(cfg.qk_rope_head_dim)

        def take(owner, attr, value, index=None) -> None:
            want = owner[index] if index is not None else getattr(owner, attr)
            if tuple(value.shape) != tuple(want.shape):
                raise ValueError(f"{attr}: shape {tuple(value.shape)} does not fit the config {tuple(want.shape)}")
            param = nn.Parameter(value.detach().to(want.dtype), requires_grad=False)
            if index is not None:
                owner[index] = param
            else:
                setattr(owner, attr, param)

        take(tower, "embed", state["embed_tokens.weight"])
        take(tower, "norm", state["norm.weight"])
        r, dn, dr = cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        for i, layer in enumerate(tower.layers):
            pre = f"layers.{i}."
            sparse = i >= cfg.first_k_dense_replace
            names = {**ATTN_NAMES, **(MOE_NAMES if sparse else DENSE_NAMES)}
            for key, name in names.items():
                value = state[pre + name]
                if key == "q":
                    heads = value.detach().view(cfg.num_heads, cfg.qk_head_dim, -1)
                    value = torch.cat([heads[:, :dn], heads[:, dn:][:, order.to(value.device)]], 1).flatten(0, 1)
                if key == "kv_a":
                    if tuple(value.shape) != (r + dr, cfg.hidden_size):
                        raise ValueError(f"kv_a: shape {tuple(value.shape)} does not fit the config "
                                         f"{(r + dr, cfg.hidden_size)}")
                    take(layer, "kv_latent", value[:r])
                    take(layer, "k_rope", value[r:][order.to(value.device)])
                    continue
                take(layer, key, value)
            if sparse:
                for key, name in EXPERT_NAMES.items():
                    bank = getattr(layer, f"experts_{key}")
                    for e in range(cfg.n_routed_experts):
                        take(bank, key, state[f"{pre}mlp.experts.{e}.{name}"], e)
        return tower

    def _bank(self, layer: nn.Module, kind: str) -> ExpertBank:
        key = (id(layer), kind)
        bank = self._banks.get(key)
        if bank is None:
            sets = [layer.experts_gate, layer.experts_up] if kind == "gate_up" else [layer.experts_down]
            bank = self._banks[key] = ExpertBank([list(s) for s in sets])
        return bank

    def _stats_counts(self, device: torch.device) -> torch.Tensor:
        """This micro-batch's zeroed ``(n_moe_layers, E)`` counts: the next
        slot of the ring :meth:`moe_stats` reads."""
        cfg = self.config
        with self._stats_lock:
            if self._stats is None:
                self._stats = torch.zeros((MOE_STATS_SLOTS, cfg.n_moe_layers, cfg.n_routed_experts),
                                          dtype=torch.int32, device=device)
            counts = self._stats[self._micro_batches % MOE_STATS_SLOTS]
            self._micro_batches += 1
        return counts.zero_()

    def moe_stats(self) -> dict:
        """The expert counts of the last micro-batches (up to
        :data:`MOE_STATS_SLOTS`, oldest first), read from the card in one
        copy: for each micro-batch and expert layer, ``routed`` (token-expert
        pairs routed: the real tokens times ``num_experts_per_tok``),
        ``expert_max`` and ``expert_mean`` (pairs an expert took)."""
        with self._stats_lock:
            done, ring = self._micro_batches, self._stats
            kept = min(done, MOE_STATS_SLOTS)
            counts = [] if ring is None else ring.cpu()
        experts = self.config.n_routed_experts
        recent = []
        for j in range(done - kept, done):
            c = counts[j % MOE_STATS_SLOTS].long()
            recent.append({"routed": c.sum(1).tolist(), "expert_max": c.max(1).values.tolist(),
                           "expert_mean": (c.sum(1).double() / experts).tolist()})
        return {"micro_batches": done, "recent": recent}

    @contextlib.contextmanager
    def recording_choices(self):
        """Inside the block, each expert layer of each forward appends its
        chosen experts, ``(B * L, num_experts_per_tok)`` int32 on the
        tower's device (-1 at padded positions), to the list the block
        yields, in the order the layers run.  For checking the routing
        after the fact: one forward at a time, outside any timed path (the
        forward computes the same bits with or without it)."""
        record = []
        self._choices = record
        try:
            yield record
        finally:
            self._choices = None

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """Run the tower; returns the final-normed hidden state ``(B, L, H)``
        fp32 (padded positions hold values that no pooling should read).

        :param input_ids: Token ids, ``(B, L)``, right-padded.
        :param attention_mask: 1 for real tokens, 0 for padding, ``(B, L)``.
        """
        cfg = self.config
        dev = input_ids.device
        with fp32_matmul(dev):
            cos, sin = rope_tables(input_ids.shape[1], cfg.qk_rope_head_dim, cfg.rope_theta, dev)
            keys = attention_mask.to(torch.int32)
            counts = self._stats_counts(dev)
            x = self.embed[input_ids]
            for i, layer in enumerate(self.layers):
                with annotate("ff.attn"):
                    x = self._attention(x, layer, cos, sin, keys)
                if i < cfg.first_k_dense_replace:
                    with annotate("ff.mlp"):
                        x = self._mlp(x, layer)
                else:
                    with annotate("ff.moe"):
                        x = self._moe(x, layer, keys, counts[i - cfg.first_k_dense_replace])
            return mistral.rms_norm(x, self.norm, cfg.rms_norm_eps, torch.float32)

    def _attention(self, x, p, cos, sin, keys) -> torch.Tensor:
        cfg = self.config
        b, length, _ = x.shape
        dn, heads = cfg.qk_nope_head_dim, cfg.num_heads
        h = mistral.rms_norm(x, p.attn_norm, cfg.rms_norm_eps)
        q = F.linear(h, p.q).view(b, length, heads, cfg.qk_head_dim)
        latent = mistral.rms_norm(F.linear(h, p.kv_latent), p.kv_norm, cfg.rms_norm_eps)
        kv = F.linear(latent, p.kv_b).view(b, length, heads, dn + cfg.v_head_dim)
        ctx = latent_attention(q, kv[..., :dn], F.linear(h, p.k_rope), kv[..., dn:], cos, sin, keys)
        return x + F.linear(ctx, p.o)

    def _mlp(self, x, p) -> torch.Tensor:
        h = mistral.rms_norm(x, p.mlp_norm, self.config.rms_norm_eps)
        return x + F.linear(mistral.swiglu(F.linear(h, p.gate), F.linear(h, p.up)), p.down)

    def _shared_expert(self, h, p) -> torch.Tensor:
        return F.linear(mistral.swiglu(F.linear(h, p.shared_gate), F.linear(h, p.shared_up)), p.shared_down)

    def _moe(self, x, p, keys, counts) -> torch.Tensor:
        cfg = self.config
        shape = x.shape
        x = x.reshape(-1, cfg.hidden_size)
        h = mistral.rms_norm(x, p.mlp_norm, cfg.rms_norm_eps)
        ids, weights, slots = moe_route(F.linear(h.float(), p.router), p.router_bias, keys.view(-1),
                                        cfg.num_experts_per_tok, cfg.routed_scaling_factor,
                                        cfg.norm_topk_prob, counts)
        if self._choices is not None:
            self._choices.append(ids)
        offsets, rows, pos = moe_permute(ids, slots, counts)
        gate, up = grouped_gemm(h, rows, self._bank(p, "gate_up"), offsets)
        (y,) = grouped_gemm(mistral.swiglu(gate, up), None, self._bank(p, "down"), offsets)
        return moe_combine(y, pos, weights, self._shared_expert(h, p), x).view(shape)


def config_from_hf(cfg, dtype: str = "bfloat16") -> DeepseekConfig:
    """The tower's config of a transformers ``DeepseekV3Config`` (or any
    object with its attributes).  RoPE's base is ``rope_theta``
    (transformers 4) or ``rope_parameters["rope_theta"]`` (5).

    :raises ValueError: For what the tower does not run: another activation
        than SiLU, a RoPE scaling or RoPE not in pairs (``rope_interleave``
        false), a low-rank q (``q_lora_rank``), another
        scoring than sigmoid, group-limited routing, or expert layers not in
        every layer after the dense ones.
    """
    if getattr(cfg, "hidden_act", "silu") != "silu":
        raise ValueError(f"a DeepSeek-V3 tower runs SiLU, not {cfg.hidden_act!r}")
    rope = getattr(cfg, "rope_parameters", None) or {}
    if rope.get("rope_type", "default") != "default" or getattr(cfg, "rope_scaling", None):
        raise ValueError("a DeepSeek-V3 tower runs plain RoPE (no scaling)")
    if not getattr(cfg, "rope_interleave", True):
        raise ValueError("a DeepSeek-V3 tower runs RoPE in pairs (rope_interleave true)")
    if getattr(cfg, "q_lora_rank", None) is not None:
        raise ValueError("a DeepSeek-V3 tower runs q as one projection (q_lora_rank null)")
    if getattr(cfg, "scoring_func", "sigmoid") != "sigmoid":
        raise ValueError(f"a DeepSeek-V3 tower routes by sigmoid scores, not {cfg.scoring_func!r}")
    if getattr(cfg, "n_group", 1) != getattr(cfg, "topk_group", 1):
        raise ValueError("a DeepSeek-V3 tower routes over all experts (topk_group == n_group)")
    if getattr(cfg, "moe_layer_freq", 1) != 1:
        raise ValueError("a DeepSeek-V3 tower has an expert layer in every layer after the dense ones")
    theta = getattr(cfg, "rope_theta", None) or rope.get("rope_theta", 10000.0)
    return DeepseekConfig(
        vocab_size=cfg.vocab_size,
        hidden_size=cfg.hidden_size,
        num_layers=cfg.num_hidden_layers,
        num_heads=cfg.num_attention_heads,
        qk_nope_head_dim=cfg.qk_nope_head_dim,
        qk_rope_head_dim=cfg.qk_rope_head_dim,
        v_head_dim=cfg.v_head_dim,
        kv_lora_rank=cfg.kv_lora_rank,
        intermediate_size=cfg.intermediate_size,
        moe_intermediate_size=cfg.moe_intermediate_size,
        n_routed_experts=cfg.n_routed_experts,
        n_shared_experts=cfg.n_shared_experts,
        num_experts_per_tok=cfg.num_experts_per_tok,
        first_k_dense_replace=cfg.first_k_dense_replace,
        routed_scaling_factor=float(cfg.routed_scaling_factor),
        norm_topk_prob=bool(cfg.norm_topk_prob),
        rms_norm_eps=cfg.rms_norm_eps,
        rope_theta=float(theta),
        dtype=dtype,
    )


def from_hf_torch(model, dtype: str = "bfloat16") -> DeepseekTower:
    """A tower holding the weights of a transformers ``DeepseekV3Model``
    (read from its state dict; transformers is only the weight source).  The
    tensors stay on their device; those already of ``dtype`` are shared,
    not copied.

    :param model: The model, or any object with ``config`` and
        ``state_dict()`` in ``DeepseekV3Model``'s names.
    :param dtype: The tower's compute type, ``"float32"`` or ``"bfloat16"``.
    """
    return DeepseekTower.from_arrays(config_from_hf(model.config, dtype), model.state_dict())
