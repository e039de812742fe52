"""Encoders: text -> dense vectors.

``Encoder`` is the abstract contract and ``LambdaEncoder`` adapts arbitrary
per-text functions (reference: ``encoder/__init__.py:32-44``).  The
transformer encoders are ROADMAP Queue 1 item 9.
"""

from collections.abc import Callable, Sequence

import numpy as np

from fastforward_tpu_torch.encoder.base import Encoder

__all__ = ["Encoder", "LambdaEncoder"]


class LambdaEncoder(Encoder):
    """Adapter turning a per-text function into an encoder."""

    def __init__(self, f: Callable[[str], np.ndarray]) -> None:
        """Create a lambda encoder.

        :param f: Function mapping one piece of text to a vector.
        """
        self._f = f

    def _encode(self, texts: Sequence[str]) -> np.ndarray:
        return np.array([self._f(t) for t in texts])
