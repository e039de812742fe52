"""Symmetric int8 scalar quantization (per-dimension scales).

The port of ``fastforward_tpu/quantizer/scalar.py`` (numpy only).  With
per-dimension scales ``s``, ``q . (c * s) == (q * s) . c``, so the scales
are folded into the query vectors and the stored int8 codes are scored
directly.
"""

from typing import Any

import numpy as np

from fastforward_tpu_torch.quantizer.base import (
    Quantizer,
    QuantizerAttributes,
    QuantizerData,
)


class ScalarQuantizer(Quantizer):
    """Int8 quantizer with one symmetric scale per dimension."""

    # the same serialized name as fastforward_tpu's class
    _compat_name = ("fastforward_tpu.quantizer.scalar", "ScalarQuantizer")

    def __init__(self) -> None:
        """Create an (untrained) int8 scalar quantizer."""
        self.scales: np.ndarray | None = None  # (dim,) float32

    def _fit(self, vectors: np.ndarray, **kwargs: Any) -> None:
        abs_max = np.abs(np.asarray(vectors, dtype=np.float32)).max(axis=0)
        self.scales = np.maximum(abs_max, 1e-12) / 127.0

    def _get_dtype(self) -> np.dtype:
        return np.dtype(np.int8)

    def _get_dims(self) -> tuple[int | None, int | None]:
        if self.scales is None:
            return None, None
        return self.scales.shape[0], self.scales.shape[0]

    def _encode(self, vectors: np.ndarray) -> np.ndarray:
        assert self.scales is not None
        scaled = np.asarray(vectors, dtype=np.float32) / self.scales
        return np.clip(np.rint(scaled), -127, 127).astype(np.int8)

    def _decode(self, codes: np.ndarray) -> np.ndarray:
        assert self.scales is not None
        return codes.astype(np.float32) * self.scales

    def _get_state(self) -> tuple[QuantizerAttributes, QuantizerData]:
        data = {}
        if self.scales is not None:
            data["scales"] = self.scales
        return {}, data

    @classmethod
    def _from_state(
        cls, attributes: QuantizerAttributes, data: QuantizerData
    ) -> "ScalarQuantizer":
        quantizer = cls()
        if "scales" in data:
            quantizer.scales = np.asarray(data["scales"])
        return quantizer
