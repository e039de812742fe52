"""Carry an index's state into the port from plain arrays.

Each function takes numpy arrays, plain lists or an iterable of
``(vector, doc_id, psg_id)`` triples — what ``fastforward_tpu``'s
``Index.__iter__`` yields — and never an object of another framework, so an
index built elsewhere can be rebuilt here row for row.
"""

from collections.abc import Iterable, Sequence

import numpy as np

from fastforward_tpu_torch.index.memory import InMemoryIndex
from fastforward_tpu_torch.index.mode import Mode


def _port_mode(mode) -> Mode:
    """The port's ``Mode`` for a ``Mode`` of either package or its name."""
    if isinstance(mode, Mode):
        return mode
    return Mode[mode if isinstance(mode, str) else mode.name]


def index_from_arrays(
    vectors: np.ndarray,
    doc_ids: "Sequence[str | None] | None",
    psg_ids: "Sequence[str | None] | None",
    mode,
    **index_kwargs,
) -> InMemoryIndex:
    """Build an :class:`InMemoryIndex` from row-aligned vectors and IDs.

    :param vectors: The vectors, ``(N, dim)``.
    :param doc_ids: Document ID per row (or ``None``).
    :param psg_ids: Passage ID per row (or ``None``).
    :param mode: Ranking mode (a ``Mode`` of either package, or its name).
    :param index_kwargs: Further :class:`InMemoryIndex` arguments
        (``device``, ``device_dtype``, ``precision``, ``query_encoder``, ...).
    :return: The index, holding the rows in the given order.
    """
    index = InMemoryIndex(mode=_port_mode(mode), **index_kwargs)
    index.add(np.asarray(vectors), doc_ids=doc_ids, psg_ids=psg_ids)
    return index


def index_from_triples(
    triples: Iterable[tuple[np.ndarray, "str | None", "str | None"]],
    mode,
    **kw,
) -> InMemoryIndex:
    """Build an :class:`InMemoryIndex` from ``(vector, doc_id, psg_id)``
    triples, e.g. ``iter(index)`` of a ``fastforward_tpu`` index.

    :raises ValueError: When ``triples`` is empty.
    """
    vectors, doc_ids, psg_ids = [], [], []
    for vec, doc_id, psg_id in triples:
        vectors.append(np.asarray(vec))
        doc_ids.append(doc_id)
        psg_ids.append(psg_id)
    if not vectors:
        raise ValueError("no triples to build an index from")
    return index_from_arrays(np.stack(vectors), doc_ids, psg_ids, mode, **kw)
