"""Carry an index's state into the port from plain arrays.

Each function takes numpy arrays, plain lists, an iterable of
``(vector, doc_id, psg_id)`` triples — what ``fastforward_tpu``'s
``Index.__iter__`` yields — or a quantizer's ``serialize()`` triple, and
never an object of another framework, so an index built elsewhere can be
rebuilt here row for row.  A quantized index is rebuilt from its codes and
its quantizer's state (:func:`index_from_codes`,
:func:`quantizer_from_state`), so both hold the same codes and codebooks.
A query tower is rebuilt from the JAX package's parameter pytree, given as
numpy arrays (:func:`bert_from_params`), so both compute the same function.
"""

from collections.abc import Iterable, Mapping, Sequence

import numpy as np
import torch

from fastforward_tpu_torch.index.base import check_ids
from fastforward_tpu_torch.index.memory import InMemoryIndex
from fastforward_tpu_torch.index.mode import Mode
from fastforward_tpu_torch.models.bert import LAYER_KEYS, BertConfig, BertTower
from fastforward_tpu_torch.quantizer import PQ, Quantizer


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


def quantizer_from_state(
    meta: Mapping,
    attributes: Mapping,
    data: Mapping[str, np.ndarray],
    device: "str | torch.device | None" = None,
) -> Quantizer:
    """The port's quantizer for a ``serialize()`` triple, e.g. one written by
    ``fastforward_tpu`` (its ``PQ``, ``OPQ`` and ``ScalarQuantizer``, or the
    reference package's ``NanoPQ``/``NanoOPQ``).

    :param meta: The triple's metadata (class name, trained flag).
    :param attributes: The triple's attributes.
    :param data: The triple's arrays (codewords, rotation, scales).
    :param device: Device of a PQ/OPQ quantizer's k-means and encoder
        (``None``: the card).
    :raises ValueError: When the triple names a class the port lacks.
    :return: The quantizer, with the same arrays as the triple.
    """
    quantizer = Quantizer.deserialize(
        dict(meta), dict(attributes), {k: np.asarray(v) for k, v in data.items()}
    )
    if isinstance(quantizer, PQ):
        quantizer.device = device
    return quantizer


def index_from_codes(
    codes: np.ndarray,
    doc_ids: "Sequence[str | None] | None",
    psg_ids: "Sequence[str | None] | None",
    mode,
    quantizer: Quantizer,
    **index_kwargs,
) -> InMemoryIndex:
    """Build a quantized :class:`InMemoryIndex` from already-encoded codes.

    The codes are stored row for row as given (nothing is re-encoded), so
    the index holds exactly the codes of the index they came from.

    :param codes: The codes, ``(N, code_dim)`` of the quantizer's dtype.
    :param doc_ids: Document ID per row (or ``None``).
    :param psg_ids: Passage ID per row (or ``None``).
    :param mode: Ranking mode (a ``Mode`` of either package, or its name).
    :param quantizer: The trained quantizer the codes belong to.
    :param index_kwargs: Further :class:`InMemoryIndex` arguments.
    :raises ValueError: When the codes do not fit the quantizer.
    :return: The index.
    """
    codes = np.asarray(codes)
    if codes.ndim != 2 or codes.dtype != quantizer.dtype or codes.shape[1] != quantizer.dims[1]:
        raise ValueError(
            f"codes {codes.dtype} {codes.shape} do not fit the quantizer "
            f"({quantizer.dtype}, width {quantizer.dims[1]})"
        )
    doc_ids, psg_ids = check_ids(codes.shape[0], doc_ids, psg_ids)
    index = InMemoryIndex(mode=_port_mode(mode), quantizer=quantizer, **index_kwargs)
    index._add(codes, doc_ids, psg_ids)
    return index


def bert_from_params(params: Mapping, config: BertConfig) -> BertTower:
    """The port's tower for a parameter pytree in the JAX package's layout
    (``fastforward_tpu.models.bert.init_params``/``from_hf_torch``: an
    ``embeddings`` dict and a ``layers`` dict stacked along the layer axis,
    Linear weights ``(layers, in, out)``), given as numpy arrays.

    :param params: The parameters (``np.asarray`` of each leaf).
    :param config: The tower's configuration (the port's ``BertConfig``;
        its ``dtype`` sets the compute type).
    :return: The tower, on the CPU, with the Linear weights transposed to
        ``(layers, out, in)``.
    """
    layers = {}
    for key in LAYER_KEYS:
        value = np.asarray(params["layers"][key])
        layers[key] = np.swapaxes(value, 1, 2) if key.endswith("_w") else value
    return BertTower.from_arrays(config, params["embeddings"], layers)
