"""Encoders: text -> dense vectors.

``Encoder`` is the abstract contract, ``LambdaEncoder`` adapts arbitrary
per-text functions (reference: ``encoder/__init__.py:32-44``), and the
Transformer encoders (the port's BERT towers on the card) live in
``fastforward_tpu_torch.encoder.transformer``, imported on first use.
"""

from collections.abc import Callable, Sequence

import numpy as np

from fastforward_tpu_torch.encoder.base import Encoder

__all__ = [
    "Encoder",
    "LambdaEncoder",
    "TransformerEncoder",
    "TCTColBERTQueryEncoder",
    "TCTColBERTDocumentEncoder",
    "TASBEncoder",
    "ContrieverEncoder",
    "BGEEncoder",
]


class LambdaEncoder(Encoder):
    """Adapter turning a per-text function into an encoder."""

    def __init__(self, f: Callable[[str], np.ndarray]) -> None:
        """Create a lambda encoder.

        :param f: Function mapping one piece of text to a vector.
        """
        self._f = f

    def _encode(self, texts: Sequence[str]) -> np.ndarray:
        return np.array([self._f(t) for t in texts])


def __getattr__(name: str):
    # lazy import: the transformer encoders need transformers when one is
    # built, which host-only use of the package does not
    if name in __all__[2:]:
        from fastforward_tpu_torch.encoder import transformer

        return getattr(transformer, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
