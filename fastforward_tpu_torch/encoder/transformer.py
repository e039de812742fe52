"""Transformer encoders: transformers checkpoints run as the port's towers.

The port of ``fastforward_tpu/encoder/transformer.py``: the same five
pretrained dual-encoder variants (TCT-ColBERT query/document, TAS-B,
Contriever, BGE) with their input templates, lengths and pooling rules.
Texts are tokenized on the host with the checkpoint's ``AutoTokenizer``;
the tower (``fastforward_tpu_torch.models.bert``), the pooling and the
normalization run on the encoder's device: the card unless the caller
passes ``device="cpu"``.  Batches keep the tokenizer's own length (no
length buckets: eager PyTorch needs no stable shapes, and the unmasked
``mean_from_4`` pooling must see no padding beyond the tokenizer's).

transformers is imported when an encoder is built, never when this module
is: it reads the checkpoint's weights and tokenizer, and its model is
dropped once the tower holds the weights.
"""

import threading
from collections.abc import Mapping, Sequence
from pathlib import Path
from typing import Any

import numpy as np
import torch

from fastforward_tpu_torch.device import resolve_device
from fastforward_tpu_torch.encoder.base import Encoder
from fastforward_tpu_torch.models import bert

_POOLING = {
    "cls": bert.pool_cls,
    "mean_from_4": bert.pool_mean_from,
    "masked_mean_from_4": bert.pool_masked_mean_from,
    "masked_mean": bert.pool_masked_mean,
}


class TransformerEncoder(Encoder):
    """Encoder backed by a pre-trained BERT-family Transformer.

    By default the CLS-token output of the last hidden layer is used.
    """

    _pooling = "cls"

    def __init__(
        self,
        model: "str | Path",
        device: "str | torch.device | None" = None,
        model_args: Mapping[str, Any] = {},
        tokenizer_args: Mapping[str, Any] = {},
        tokenizer_call_args: Mapping[str, Any] = {
            "padding": True,
            "truncation": True,
        },
        normalize: bool = False,
        compute_dtype: str = "float32",
    ) -> None:
        """Create a Transformer encoder.

        :param model: Pre-trained model (transformers name or path).
        :param device: Torch device of the tower; ``None`` means ``"cuda"``.
        :param model_args: Extra arguments for ``AutoModel.from_pretrained``.
        :param tokenizer_args: Extra arguments for the tokenizer.
        :param tokenizer_call_args: Extra arguments for tokenizer calls.
        :param normalize: L2-normalize the output embeddings.
        :param compute_dtype: ``"float32"`` (IEEE fp32 matmuls) or
            ``"bfloat16"`` (bf16 weights and activations, fp32 accumulation).
        :raises RuntimeError: When the device is CUDA and none is available.
        """
        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"compute_dtype must be 'float32' or 'bfloat16', got {compute_dtype!r}"
            )
        self._device = resolve_device(device)
        from transformers import AutoModel, AutoTokenizer

        torch_model = AutoModel.from_pretrained(model, **model_args)
        tower = bert.from_hf_torch(torch_model, dtype=compute_dtype)
        del torch_model
        self._tower = tower.to(self._device).eval()
        self._tokenizer = AutoTokenizer.from_pretrained(model, **tokenizer_args)
        self._tokenizer_call_args = dict(tokenizer_call_args)
        self._normalize = normalize
        # a fast tokenizer sets its truncation state on every call: threads
        # (a server's pool) take turns with it
        self._tokenizer_lock = threading.Lock()

    @property
    def device(self) -> torch.device:
        """The torch device of the tower."""
        return self._device

    @property
    def config(self) -> bert.BertConfig:
        """The tower's configuration (``dtype`` is the compute type)."""
        return self._tower.config

    def _get_tokenizer_inputs(self, texts: Sequence[str]) -> list[str]:
        """Hook: prepare raw texts for tokenization (template insertion)."""
        return list(texts)

    def _encode(self, texts: Sequence[str]) -> np.ndarray:
        call_args = dict(self._tokenizer_call_args)
        call_args.setdefault("padding", True)
        with self._tokenizer_lock:
            tokenized = self._tokenizer(
                self._get_tokenizer_inputs(texts), return_tensors="np", **call_args
            )
        ids = torch.from_numpy(tokenized["input_ids"]).to(self._device)
        mask = torch.from_numpy(tokenized["attention_mask"]).to(self._device)
        with torch.inference_mode():
            hidden = self._tower(ids, mask)
            pooled = _POOLING[self._pooling](hidden, mask)
            if self._normalize:
                pooled = bert.l2_normalize(pooled)
            return pooled.cpu().numpy()


class TCTColBERTQueryEncoder(TransformerEncoder):
    """TCT-ColBERT query tower (paper: https://aclanthology.org/2021.repl4nlp-1.17/).

    Template ``[CLS] [Q] <query> [MASK]*n`` with mean pooling over tokens 4+
    (reference: ``encoder/transformer.py:93-134``).
    """

    _pooling = "mean_from_4"

    def __init__(
        self,
        model: "str | Path" = "castorini/tct_colbert-msmarco",
        device: "str | torch.device | None" = None,
        max_length: int = 36,
        compute_dtype: str = "float32",
    ) -> None:
        """Create a TCT-ColBERT query encoder.

        :param model: Pre-trained TCT-ColBERT model (name or path).
        :param device: Torch device of the tower; ``None`` means ``"cuda"``.
        :param max_length: Maximum number of query tokens.
        :param compute_dtype: ``"float32"`` or ``"bfloat16"``.
        """
        self._max_length = max_length
        super().__init__(
            model,
            device=device,
            tokenizer_call_args={
                "max_length": max_length,
                "truncation": True,
                "add_special_tokens": False,
            },
            compute_dtype=compute_dtype,
        )

    def _get_tokenizer_inputs(self, texts: Sequence[str]) -> list[str]:
        return ["[CLS] [Q] " + q + "[MASK]" * self._max_length for q in texts]


class TCTColBERTDocumentEncoder(TransformerEncoder):
    """TCT-ColBERT document tower.

    Template ``[CLS] [D] <doc>`` with attention-masked mean pooling over
    tokens 4+ (reference: ``encoder/transformer.py:137-188``).
    """

    _pooling = "masked_mean_from_4"

    def __init__(
        self,
        model: "str | Path" = "castorini/tct_colbert-msmarco",
        device: "str | torch.device | None" = None,
        max_length: int = 512,
        compute_dtype: str = "float32",
    ) -> None:
        """Create a TCT-ColBERT document encoder.

        :param model: Pre-trained TCT-ColBERT model (name or path).
        :param device: Torch device of the tower; ``None`` means ``"cuda"``.
        :param max_length: Maximum number of document tokens.
        :param compute_dtype: ``"float32"`` or ``"bfloat16"``.
        """
        self._max_length = max_length
        super().__init__(
            model,
            device=device,
            tokenizer_call_args={
                "max_length": max_length,
                "padding": True,
                "truncation": True,
                "add_special_tokens": False,
            },
            compute_dtype=compute_dtype,
        )

    def _get_tokenizer_inputs(self, texts: Sequence[str]) -> list[str]:
        return ["[CLS] [D] " + d for d in texts]


class TASBEncoder(TransformerEncoder):
    """TAS-B (topic-aware sampling) DistilBERT encoder, CLS pooling.

    Paper: https://dl.acm.org/doi/10.1145/3404835.3462891.
    """

    def __init__(
        self,
        model: "str | Path" = "sebastian-hofstaetter/distilbert-dot-tas_b-b256-msmarco",
        device: "str | torch.device | None" = None,
        compute_dtype: str = "float32",
    ) -> None:
        """Create a TAS-B encoder.

        :param model: Pre-trained TAS-B model (name or path).
        :param device: Torch device of the tower; ``None`` means ``"cuda"``.
        :param compute_dtype: ``"float32"`` or ``"bfloat16"``.
        """
        super().__init__(model, device=device, compute_dtype=compute_dtype)


class ContrieverEncoder(TransformerEncoder):
    """Contriever encoder, masked mean pooling over all tokens.

    Paper: https://openreview.net/forum?id=jKN1pXi7b0.
    """

    _pooling = "masked_mean"

    def __init__(
        self,
        model: "str | Path" = "facebook/contriever",
        device: "str | torch.device | None" = None,
        compute_dtype: str = "float32",
    ) -> None:
        """Create a Contriever encoder.

        :param model: Pre-trained Contriever model (name or path).
        :param device: Torch device of the tower; ``None`` means ``"cuda"``.
        :param compute_dtype: ``"float32"`` or ``"bfloat16"``.
        """
        super().__init__(model, device=device, compute_dtype=compute_dtype)


class BGEEncoder(TransformerEncoder):
    """BGE encoder, CLS pooling with L2 normalization.

    Paper: https://dl.acm.org/doi/10.1145/3626772.3657878.
    """

    def __init__(
        self,
        model: "str | Path" = "BAAI/bge-base-en-v1.5",
        device: "str | torch.device | None" = None,
        compute_dtype: str = "float32",
    ) -> None:
        """Create a BGE encoder.

        :param model: Pre-trained BGE model (name or path).
        :param device: Torch device of the tower; ``None`` means ``"cuda"``.
        :param compute_dtype: ``"float32"`` or ``"bfloat16"``.
        """
        super().__init__(
            model, device=device, normalize=True, compute_dtype=compute_dtype
        )
