"""Corpus indexing: stream documents through an encoder into an index.

The port of ``fastforward_tpu/utils/indexer.py`` (reference:
``util/indexer.py:28-178``).  Batches are encoded by any ``Encoder`` and
added to the target index, whose device table is rebuilt on the next
scoring call.  A quantizer can be fit inline on the first batch(es) before
anything is added.  The index layer is imported for type hints only (it
imports ``utils.tracing``); ``tqdm`` is used only where it is installed.
"""

import logging
from collections.abc import Iterable, Sequence
from typing import TYPE_CHECKING, TypedDict

import numpy as np

if TYPE_CHECKING:
    from fastforward_tpu_torch.encoder.base import Encoder
    from fastforward_tpu_torch.index.base import IDSequence, Index
    from fastforward_tpu_torch.quantizer import Quantizer

LOGGER = logging.getLogger(__name__)


def progress(iterable: Iterable) -> Iterable:
    """``iterable`` under a ``tqdm`` progress bar where tqdm is installed."""
    try:
        from tqdm import tqdm
    except ImportError:
        return iterable
    return tqdm(iterable)


class IndexingDict(TypedDict):
    """One document/passage for ``Indexer.from_dicts``."""

    text: str
    doc_id: str | None
    psg_id: str | None


class Indexer:
    """Utility for indexing collections."""

    def __init__(
        self,
        index: "Index",
        encoder: "Encoder | None" = None,
        encoder_batch_size: int = 128,
        batch_size: int = 2**16,
        quantizer: "Quantizer | None" = None,
        quantizer_fit_batches: int = 1,
    ) -> None:
        """Create an indexer.

        If a quantizer is given, the first ``quantizer_fit_batches`` batches
        are buffered, used to fit it, and then flushed into the (necessarily
        empty) index with the quantizer attached.

        :param index: The target index.
        :param encoder: Document/passage encoder.
        :param encoder_batch_size: Encoder micro-batch size.
        :param batch_size: Vectors added to the index per batch.
        :param quantizer: Quantizer to fit inline and attach.
        :param quantizer_fit_batches: Batches used to fit the quantizer.
        :raises ValueError: When the quantizer is already fit.
        :raises ValueError: When a quantizer is given for a non-empty index.
        """
        self._index = index
        self._encoder = encoder
        self._encoder_batch_size = encoder_batch_size
        self._batch_size = batch_size
        self._quantizer = quantizer
        self._quantizer_fit_batches = quantizer_fit_batches

        if quantizer is not None:
            if quantizer._trained:
                raise ValueError(
                    "The quantizer is already fit. "
                    "It should be attached to the index directly."
                )
            if len(index) > 0:
                raise ValueError(
                    "The index must be empty for a quantizer to be attached."
                )
            self._buffer: "list[tuple[np.ndarray, IDSequence, IDSequence]]" = []
            if quantizer_fit_batches > 1:
                LOGGER.warning(
                    "buffering the first %s batches to fit the quantizer; "
                    "nothing reaches the index before the fit completes",
                    quantizer_fit_batches,
                )

    def _index_batch(
        self,
        vectors: np.ndarray,
        doc_ids: "IDSequence | None" = None,
        psg_ids: "IDSequence | None" = None,
    ) -> None:
        """Add one batch, handling inline quantizer fitting."""
        if self._quantizer is None:
            self._index.add(vectors, doc_ids, psg_ids)
            return

        self._buffer.append((vectors, doc_ids, psg_ids))
        if len(self._buffer) < self._quantizer_fit_batches:
            return

        last = self._buffer[-1][0].shape[0]
        total = sum(b[0].shape[0] for b in self._buffer)
        LOGGER.info(
            "fitting quantizer on %s buffered vectors (%s batches)",
            total,
            len(self._buffer),
        )
        if last < self._batch_size:
            LOGGER.warning(
                "final fit batch holds %s vectors (configured batch size: "
                "%s) — the quantizer sees fewer samples than expected",
                last,
                self._batch_size,
            )
        self._quantizer.fit(np.concatenate([b[0] for b in self._buffer]))
        self._index.quantizer = self._quantizer
        self._quantizer = None

        LOGGER.info("flushing %s buffered batches into the index", len(self._buffer))
        for b_vectors, b_doc_ids, b_psg_ids in self._buffer:
            self._index.add(b_vectors, b_doc_ids, b_psg_ids)
        del self._buffer

    def _encode(self, texts: Sequence[str]) -> np.ndarray:
        """Encode texts in encoder micro-batches.

        :param texts: The texts to encode.
        :raises RuntimeError: When no encoder exists.
        :return: The vectors.
        """
        if self._encoder is None:
            raise RuntimeError("An encoder is required.")
        parts = [
            self._encoder(texts[i : i + self._encoder_batch_size])
            for i in range(0, len(texts), self._encoder_batch_size)
        ]
        return np.concatenate(parts)

    def from_dicts(self, data: Iterable[IndexingDict]) -> None:
        """Index documents given as dictionaries.

        :param data: Iterable of ``{text, doc_id?, psg_id?}`` dicts.
        """
        texts: list[str] = []
        doc_ids: list[str | None] = []
        psg_ids: list[str | None] = []
        for item in progress(data):
            texts.append(item["text"])
            doc_ids.append(item.get("doc_id"))
            psg_ids.append(item.get("psg_id"))
            if len(texts) == self._batch_size:
                self._index_batch(self._encode(texts), doc_ids, psg_ids)
                texts, doc_ids, psg_ids = [], [], []
        if texts:
            self._index_batch(self._encode(texts), doc_ids, psg_ids)

    def from_index(self, index: "Index") -> None:
        """Transfer all vectors and IDs from another index.

        Quantized source vectors are reconstructed first.

        :param index: The source index.
        """
        for vectors, doc_ids, psg_ids in progress(index.batch_iter(self._batch_size)):
            self._index_batch(vectors, doc_ids, psg_ids)
