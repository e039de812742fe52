"""Quantizer contract: vectors <-> compact codes, with index-embedded state.

The port of ``fastforward_tpu/quantizer/base.py``: ``fit`` is only allowed
before the quantizer is attached to an index; ``encode``/``decode`` require
a trained quantizer; ``serialize`` returns a ``(meta, attributes, data)``
triple.  The triple names the same classes as ``fastforward_tpu`` writes, so
a triple from either package loads in the other; ``deserialize`` maps those
names to the port's own classes through a fixed table (it never imports the
module a triple names).
"""

import abc
import logging
from collections.abc import Mapping
from typing import Any

import numpy as np

LOGGER = logging.getLogger(__name__)

QuantizerAttributes = Mapping[str, "str | bool | float"]
QuantizerData = Mapping[str, np.ndarray]

#: serialized ``(__module__, __name__)`` -> (port module, port class).  The
#: reference package's nanopq names, ``fastforward_tpu``'s own names and the
#: port's own names all resolve to the port's classes.
_CLASSES = {
    ("fast_forward.quantizer.nanopq", "NanoPQ"): ("pq", "PQ"),
    ("fast_forward.quantizer.nanopq", "NanoOPQ"): ("pq", "OPQ"),
    ("fastforward_tpu.quantizer.pq", "PQ"): ("pq", "PQ"),
    ("fastforward_tpu.quantizer.pq", "OPQ"): ("pq", "OPQ"),
    ("fastforward_tpu.quantizer.scalar", "ScalarQuantizer"): ("scalar", "ScalarQuantizer"),
    ("fastforward_tpu_torch.quantizer.pq", "PQ"): ("pq", "PQ"),
    ("fastforward_tpu_torch.quantizer.pq", "OPQ"): ("pq", "OPQ"),
    ("fastforward_tpu_torch.quantizer.scalar", "ScalarQuantizer"): ("scalar", "ScalarQuantizer"),
}


def _port_class(module: str, name: str) -> type:
    """The port's quantizer class for a serialized class name."""
    from fastforward_tpu_torch.quantizer import pq, scalar

    try:
        mod, cls = _CLASSES[(module, name)]
    except KeyError:
        raise ValueError(f"unknown quantizer class {module}.{name}") from None
    return getattr({"pq": pq, "scalar": scalar}[mod], cls)


class Quantizer(abc.ABC):
    """Base class for quantizers."""

    _attached: bool = False
    _trained: bool = False
    #: ``(module, class)`` written into serialized meta, so the triple loads
    #: in ``fastforward_tpu`` (and, for PQ/OPQ, in the reference package).
    #: Only honored when declared directly on the concrete class.
    _compat_name: tuple[str, str] | None = None

    def __eq__(self, o: object) -> bool:
        """Deep state comparison via the serialized representation."""
        if not isinstance(o, Quantizer):
            return False
        meta_a, attrs_a, data_a = self.serialize()
        meta_b, attrs_b, data_b = o.serialize()
        if meta_a != meta_b or attrs_a != attrs_b or data_a.keys() != data_b.keys():
            return False
        return all(np.array_equal(v, data_b[k]) for k, v in data_a.items())

    def set_attached(self) -> None:
        """Mark the quantizer as attached to an index (freezes training).

        :raises RuntimeError: When the quantizer has not been fit.
        """
        if not self._trained:
            raise RuntimeError(
                f"Call {type(self).__name__}.fit before attaching the quantizer "
                "to an index."
            )
        self._attached = True

    @abc.abstractmethod
    def _fit(self, vectors: np.ndarray, **kwargs: Any) -> None:
        pass

    def fit(self, vectors: np.ndarray, **kwargs: Any) -> None:
        """Fit (train) the quantizer.

        :param vectors: The training vectors.
        :param **kwargs: Implementation-specific options.
        :raises RuntimeError: When the quantizer is already attached.
        """
        if self._attached:
            raise RuntimeError(
                "Quantizers can only be fitted before they are attached to an index."
            )
        self._fit(vectors, **kwargs)
        self._trained = True

    @abc.abstractmethod
    def _get_dtype(self) -> np.dtype:
        pass

    @property
    def dtype(self) -> np.dtype:
        """Dtype of the codes produced by this quantizer."""
        return self._get_dtype()

    @abc.abstractmethod
    def _get_dims(self) -> tuple[int | None, int | None]:
        pass

    @property
    def dims(self) -> tuple[int | None, int | None]:
        """(original dimension, code dimension); ``None`` before training."""
        return self._get_dims()

    @abc.abstractmethod
    def _encode(self, vectors: np.ndarray) -> np.ndarray:
        pass

    def encode(self, vectors: np.ndarray) -> np.ndarray:
        """Encode a batch of vectors into codes.

        :param vectors: The vectors, shape ``(n, dim)``.
        :raises RuntimeError: When the quantizer has not been fit.
        :return: The codes, shape ``(n, code_dim)``.
        """
        if not self._trained:
            raise RuntimeError(f"Call {type(self).__name__}.fit first.")
        return self._encode(vectors)

    @abc.abstractmethod
    def _decode(self, codes: np.ndarray) -> np.ndarray:
        pass

    def decode(self, codes: np.ndarray) -> np.ndarray:
        """Reconstruct (approximate) vectors from codes.

        :param codes: The codes, shape ``(n, code_dim)``.
        :raises RuntimeError: When the quantizer has not been fit.
        :return: The approximate vectors, shape ``(n, dim)``.
        """
        if not self._trained:
            raise RuntimeError(f"Call {type(self).__name__}.fit first.")
        return self._decode(codes)

    @abc.abstractmethod
    def _get_state(self) -> tuple[QuantizerAttributes, QuantizerData]:
        """Return (attributes, arrays) fully describing this quantizer."""
        pass

    def serialize(
        self,
    ) -> tuple[QuantizerAttributes, QuantizerAttributes, QuantizerData]:
        """Serialize into a ``(meta, attributes, data)`` triple.

        :return: The serialized quantizer.
        """
        module, name = type(self).__module__, type(self).__name__
        compat = type(self).__dict__.get("_compat_name")
        if compat is not None:
            module, name = compat
        meta = {
            "__module__": module,
            "__name__": name,
            "_trained": self._trained,
        }
        attributes, data = self._get_state()
        return meta, attributes, data

    @classmethod
    @abc.abstractmethod
    def _from_state(
        cls, attributes: QuantizerAttributes, data: QuantizerData
    ) -> "Quantizer":
        """Instantiate a quantizer from its serialized state."""
        pass

    @classmethod
    def deserialize(
        cls,
        meta: QuantizerAttributes,
        attributes: QuantizerAttributes,
        data: QuantizerData,
    ) -> "Quantizer":
        """Reconstruct a serialized quantizer as the port's own class.

        :param meta: The quantizer metadata.
        :param attributes: The quantizer attributes.
        :param data: The quantizer data arrays.
        :raises ValueError: When the triple names a class the port lacks.
        :return: The loaded quantizer.
        """
        module, name = str(meta["__module__"]), str(meta["__name__"])
        LOGGER.debug("reconstructing %s.%s", module, name)
        quantizer = _port_class(module, name)._from_state(attributes, data)
        quantizer._trained = bool(meta["_trained"])
        return quantizer
