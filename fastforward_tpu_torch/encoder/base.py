"""Encoder contract: a batch of texts in, a matrix of embeddings out.

Mirrors the reference contract (reference: ``encoder/base.py:10-23``).
Every encoder returns plain numpy, whatever device it computes on.
"""

import abc
from collections.abc import Sequence

import numpy as np


class Encoder(abc.ABC):
    """Base class for encoders."""

    @abc.abstractmethod
    def _encode(self, texts: Sequence[str]) -> np.ndarray:
        pass

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        """Encode a batch of texts.

        :param texts: The texts to encode.
        :return: The embeddings, shape ``(len(texts), dim)``.
        """
        return self._encode(texts)
