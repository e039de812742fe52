"""BERT-family towers in PyTorch (BERT and DistilBERT).

The port of ``fastforward_tpu/models/bert.py``.  One ``nn.Module`` runs both
architectures (``type_vocab_size=0`` drops the token-type embedding, as
DistilBERT has none) and keeps the JAX tower's arithmetic operation for
operation:

- the embeddings are summed and layer-normalized in fp32;
- padded keys get the additive bias ``(1 - mask) * finfo(float32).min``;
- attention logits and the context product accumulate in fp32, the
  logits are divided by ``sqrt(d)`` and softmaxed over the keys in fp32;
- GELU is the exact (erf) form, in fp32;
- every layer norm runs in fp32;
- with ``dtype="bfloat16"`` the layer weights and the activations between
  the blocks are bf16 (the weights rounded once, as the JAX tower casts
  them); with ``"float32"`` every matmul runs in IEEE fp32 on the card
  (TF32 off inside :meth:`BertTower.forward`, whatever the process set).

The matmuls are plain ``torch.nn.functional.linear``/``torch.matmul``, as
the JAX package leaves them to XLA: no kernel of the port is on this path.
Attention is written out (no ``scaled_dot_product_attention``), so its
numerics do not depend on the installed PyTorch or transformers.

Weights load from a transformers ``BertModel``/``DistilBertModel``
(:func:`from_hf_torch`; its ``(out, in)`` Linear layout is kept as it is),
or from the JAX package's parameter layout (:func:`init_params`, and
``convert.bert_from_params``), so one set of weights runs in both packages.
"""

import contextlib
import math
from collections.abc import Mapping
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fastforward_tpu_torch.device import fp32_matmul

#: per-layer tensors, stacked along a leading layer axis; the Linear
#: weights are ``(layers, out, in)``
LAYER_KEYS = (
    "q_w", "q_b", "k_w", "k_b", "v_w", "v_b", "o_w", "o_b",
    "attn_ln_s", "attn_ln_b",
    "ffn_in_w", "ffn_in_b", "ffn_out_w", "ffn_out_b",
    "ffn_ln_s", "ffn_ln_b",
)  # fmt: skip

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class BertConfig:
    """Shape configuration of a BERT-family tower."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2  # 0: no token-type embeddings (DistilBERT)
    layer_norm_eps: float = 1e-12
    # "bfloat16" runs the matmul-heavy blocks in bf16 (fp32 accumulation,
    # layer norms, softmax and GELU in fp32); "float32" is IEEE fp32
    dtype: str = "float32"

    @classmethod
    def tiny(cls) -> "BertConfig":
        """A small config for tests."""
        return cls(
            vocab_size=1024,
            hidden_size=128,
            num_layers=2,
            num_heads=2,
            intermediate_size=256,
            max_position_embeddings=128,
        )


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float):
    """Layer norm in fp32, returned in ``x``'s dtype."""
    out = F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(), eps)
    return out.to(x.dtype)


class BertTower(nn.Module):
    """A BERT/DistilBERT encoder stack: ids in, the last hidden state out.

    The weights are frozen tensors (inference only); build a tower with
    :meth:`from_arrays`, :func:`from_hf_torch` or
    ``convert.bert_from_params``, and move it with ``.to(device)``.
    """

    def __init__(self, config: BertConfig) -> None:
        """Create a tower with zero weights.

        :param config: The shape configuration (``dtype`` sets the layer
            weights' type).
        """
        super().__init__()
        if config.dtype not in _DTYPES:
            raise ValueError(
                f"dtype must be 'float32' or 'bfloat16', got {config.dtype!r}"
            )
        self.config = config
        h, i, n = config.hidden_size, config.intermediate_size, config.num_layers
        dt = _DTYPES[config.dtype]

        def frozen(*shape, dtype=torch.float32):
            return nn.Parameter(torch.zeros(shape, dtype=dtype), requires_grad=False)

        self.word = frozen(config.vocab_size, h)
        self.position = frozen(config.max_position_embeddings, h)
        self.token_type = (
            frozen(config.type_vocab_size, h) if config.type_vocab_size > 0 else None
        )
        self.ln_scale = frozen(h)
        self.ln_bias = frozen(h)
        shapes = {
            "q_w": (h, h), "k_w": (h, h), "v_w": (h, h), "o_w": (h, h),
            "ffn_in_w": (i, h), "ffn_in_b": (i,), "ffn_out_w": (h, i),
        }  # fmt: skip
        for key in LAYER_KEYS:
            setattr(self, key, frozen(n, *shapes.get(key, (h,)), dtype=dt))

    @classmethod
    def from_arrays(
        cls,
        config: BertConfig,
        embeddings: Mapping[str, "np.ndarray | torch.Tensor"],
        layers: Mapping[str, "np.ndarray | torch.Tensor"],
    ) -> "BertTower":
        """A tower holding the given weights (copied, cast to the tower's
        types: embeddings fp32, layers ``config.dtype``).

        :param config: The shape configuration.
        :param embeddings: ``word``, ``position``, ``ln_scale``,
            ``ln_bias`` and, with token types, ``token_type``.
        :param layers: Every key of :data:`LAYER_KEYS`, stacked along the
            layer axis; Linear weights ``(layers, out, in)``.
        :raises ValueError: When a tensor's shape does not fit the config.
        """
        tower = cls(config)
        names = ["word", "position", "ln_scale", "ln_bias"]
        if config.type_vocab_size > 0:
            names.append("token_type")
        for name, source in [(k, embeddings) for k in names] + [(k, layers) for k in LAYER_KEYS]:
            param = getattr(tower, name)
            value = torch.as_tensor(np.asarray(source[name]))
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(
                    f"{name}: shape {tuple(value.shape)} does not fit the config "
                    f"{tuple(param.shape)}"
                )
            param.data.copy_(value.to(param.dtype))
        return tower

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        token_type_ids: "torch.Tensor | None" = None,
    ) -> torch.Tensor:
        """Run the tower; returns the last hidden state ``(B, L, H)`` fp32.

        :param input_ids: Token ids, ``(B, L)``.
        :param attention_mask: 1 for real tokens, 0 for padding, ``(B, L)``.
        :param token_type_ids: Optional segment ids, ``(B, L)`` (zeros when
            ``None``; ignored without token-type embeddings).
        """
        cfg = self.config
        guard = (
            fp32_matmul(input_ids.device)
            if cfg.dtype == "float32"
            # bf16 mode: the fp32 products of the attention multiply bf16
            # values, which TF32 holds exactly
            else contextlib.nullcontext()
        )
        with guard:
            x = self._embed(input_ids, token_type_ids)
            # additive attention bias: (1 - mask) * finfo.min, in fp32
            mask_bias = (1.0 - attention_mask[:, None, None, :].float()) * torch.finfo(
                torch.float32
            ).min
            for layer in range(cfg.num_layers):
                x = self._layer(x, mask_bias, {k: getattr(self, k)[layer] for k in LAYER_KEYS})
            return x.float()

    def _embed(self, input_ids: torch.Tensor, token_type_ids) -> torch.Tensor:
        cfg = self.config
        x = self.word[input_ids] + self.position[: input_ids.shape[1]][None]
        if self.token_type is not None:
            if token_type_ids is None:
                token_type_ids = torch.zeros_like(input_ids)
            x = x + self.token_type[token_type_ids]
        x = _layer_norm(x, self.ln_scale, self.ln_bias, cfg.layer_norm_eps)
        return x.to(_DTYPES[cfg.dtype])

    def _layer(self, x: torch.Tensor, mask_bias: torch.Tensor, p: dict) -> torch.Tensor:
        cfg = self.config
        b, l, h = x.shape
        nh = cfg.num_heads
        d = h // nh

        def split(t):
            return t.view(b, l, nh, d).transpose(1, 2)

        q = split(F.linear(x, p["q_w"], p["q_b"]))
        k = split(F.linear(x, p["k_w"], p["k_b"]))
        v = split(F.linear(x, p["v_w"], p["v_b"]))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(d)
        weights = torch.softmax(logits + mask_bias, dim=-1).to(x.dtype)
        ctx = torch.matmul(weights.float(), v.float()).to(x.dtype)
        ctx = ctx.transpose(1, 2).reshape(b, l, h)
        attn = F.linear(ctx, p["o_w"], p["o_b"])
        x = _layer_norm(x + attn, p["attn_ln_s"], p["attn_ln_b"], cfg.layer_norm_eps)
        ffn = F.gelu(F.linear(x, p["ffn_in_w"], p["ffn_in_b"]).float()).to(x.dtype)
        ffn = F.linear(ffn, p["ffn_out_w"], p["ffn_out_b"])
        return _layer_norm(x + ffn, p["ffn_ln_s"], p["ffn_ln_b"], cfg.layer_norm_eps)


# -- pooling variants (reference: encoder/transformer.py:62-261) --------------


def pool_cls(hidden: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """CLS-token pooling (TransformerEncoder default / TAS-B / BGE)."""
    del attention_mask
    return hidden[:, 0]


def pool_mean_from(
    hidden: torch.Tensor, attention_mask: torch.Tensor, start: int = 4
) -> torch.Tensor:
    """Unmasked mean over tokens ``start:`` (TCT-ColBERT queries)."""
    del attention_mask
    return hidden[:, start:].mean(dim=1)


def pool_masked_mean_from(
    hidden: torch.Tensor, attention_mask: torch.Tensor, start: int = 4
) -> torch.Tensor:
    """Attention-mask-weighted mean over tokens ``start:`` (TCT-ColBERT docs)."""
    tokens = hidden[:, start:]
    mask = attention_mask[:, start:, None].to(hidden.dtype)
    total = (tokens * mask).sum(dim=1)
    return total / mask.sum(dim=1).clamp(min=1e-9)


def pool_masked_mean(hidden: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over all tokens (Contriever)."""
    mask = attention_mask[..., None].to(hidden.dtype)
    return (hidden * mask).sum(dim=1) / mask.sum(dim=1)


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """Row-wise L2 normalization (BGE)."""
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-12)


# -- parameter construction ---------------------------------------------------


def init_params(config: BertConfig, seed: int = 0) -> dict:
    """Random parameters in the JAX package's layout, as numpy arrays: the
    same draws as ``fastforward_tpu.models.bert.init_params`` for the same
    seed (Linear weights ``(layers, in, out)``; see
    ``convert.bert_from_params``)."""
    rng = np.random.default_rng(seed)
    h, i = config.hidden_size, config.intermediate_size

    def mat(*shape):
        return rng.normal(0, 0.02, size=shape).astype(np.float32)

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    def ones(*shape):
        return np.ones(shape, np.float32)

    n = config.num_layers
    # the draws run in the JAX package's order: word, position, the six
    # layer matrices, then the token types
    params = {
        "embeddings": {
            "word": mat(config.vocab_size, h),
            "position": mat(config.max_position_embeddings, h),
            "ln_scale": ones(h),
            "ln_bias": zeros(h),
        },
        "layers": {
            "q_w": mat(n, h, h),
            "q_b": zeros(n, h),
            "k_w": mat(n, h, h),
            "k_b": zeros(n, h),
            "v_w": mat(n, h, h),
            "v_b": zeros(n, h),
            "o_w": mat(n, h, h),
            "o_b": zeros(n, h),
            "attn_ln_s": ones(n, h),
            "attn_ln_b": zeros(n, h),
            "ffn_in_w": mat(n, h, i),
            "ffn_in_b": zeros(n, i),
            "ffn_out_w": mat(n, i, h),
            "ffn_out_b": zeros(n, h),
            "ffn_ln_s": ones(n, h),
            "ffn_ln_b": zeros(n, h),
        },
    }
    if config.type_vocab_size > 0:
        params["embeddings"]["token_type"] = mat(config.type_vocab_size, h)
    return params


def from_hf_torch(model, dtype: str = "float32") -> BertTower:
    """A tower holding the weights of a transformers ``BertModel`` or
    ``DistilBertModel`` (read from its state dict; transformers is only the
    weight source).

    :param model: The torch model instance (weights already loaded).
    :param dtype: The tower's compute type, ``"float32"`` or
        ``"bfloat16"``.
    :return: The tower, on the CPU (its config is ``tower.config``).
    """
    sd = {k: v.detach().cpu().float() for k, v in model.state_dict().items()}
    cfg = model.config
    if cfg.model_type == "distilbert":
        config = BertConfig(
            vocab_size=cfg.vocab_size,
            hidden_size=cfg.dim,
            num_layers=cfg.n_layers,
            num_heads=cfg.n_heads,
            intermediate_size=cfg.hidden_dim,
            max_position_embeddings=cfg.max_position_embeddings,
            type_vocab_size=0,
            layer_norm_eps=1e-12,
            dtype=dtype,
        )
        prefix = "transformer.layer"
        names = {
            "q": "attention.q_lin",
            "k": "attention.k_lin",
            "v": "attention.v_lin",
            "o": "attention.out_lin",
            "attn_ln": "sa_layer_norm",
            "ffn_in": "ffn.lin1",
            "ffn_out": "ffn.lin2",
            "ffn_ln": "output_layer_norm",
        }
    else:
        config = BertConfig(
            vocab_size=cfg.vocab_size,
            hidden_size=cfg.hidden_size,
            num_layers=cfg.num_hidden_layers,
            num_heads=cfg.num_attention_heads,
            intermediate_size=cfg.intermediate_size,
            max_position_embeddings=cfg.max_position_embeddings,
            type_vocab_size=cfg.type_vocab_size,
            layer_norm_eps=cfg.layer_norm_eps,
            dtype=dtype,
        )
        prefix = "encoder.layer"
        names = {
            "q": "attention.self.query",
            "k": "attention.self.key",
            "v": "attention.self.value",
            "o": "attention.output.dense",
            "attn_ln": "attention.output.LayerNorm",
            "ffn_in": "intermediate.dense",
            "ffn_out": "output.dense",
            "ffn_ln": "output.LayerNorm",
        }
    layers = {}
    for key, hf_name in names.items():
        # Linear weights stay (out, in); layer norms are weight/bias too
        suffixes = ("_s", "_b") if key.endswith("_ln") else ("_w", "_b")
        for suffix, part in zip(suffixes, ("weight", "bias")):
            layers[key + suffix] = torch.stack(
                [sd[f"{prefix}.{i}.{hf_name}.{part}"] for i in range(config.num_layers)]
            )
    embeddings = {
        "word": sd["embeddings.word_embeddings.weight"],
        "position": sd["embeddings.position_embeddings.weight"],
        "ln_scale": sd["embeddings.LayerNorm.weight"],
        "ln_bias": sd["embeddings.LayerNorm.bias"],
    }
    if config.type_vocab_size > 0:
        embeddings["token_type"] = sd["embeddings.token_type_embeddings.weight"]
    return BertTower.from_arrays(config, embeddings, layers)
