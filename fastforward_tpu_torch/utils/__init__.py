"""Utilities: evaluation export, coalescing, corpus indexing, serving.

The port of ``fastforward_tpu/utils/__init__.py`` (reference:
``util/__init__.py:29-101``).  ``tqdm`` progress bars show only where it is
installed; the PyTerrier adapters live in ``utils.pyterrier`` (they need
``python-terrier``).  Nothing here imports the index layer at module level:
the index imports ``utils.tracing``.
"""

from collections.abc import Callable
from typing import TYPE_CHECKING

import numpy as np
import pandas as pd

from fastforward_tpu_torch.ranking import Ranking
from fastforward_tpu_torch.utils.evaluate import ndcg_at_k, recall_at_k, rr_at_k
from fastforward_tpu_torch.utils.indexer import Indexer, IndexingDict, progress
from fastforward_tpu_torch.utils.serving import BatchingServer

if TYPE_CHECKING:
    from fastforward_tpu_torch.index.base import Index

__all__ = [
    "Indexer",
    "IndexingDict",
    "BatchingServer",
    "to_ir_measures",
    "cos_dist",
    "create_coalesced_index",
    "ndcg_at_k",
    "rr_at_k",
    "recall_at_k",
]


def to_ir_measures(ranking: Ranking) -> pd.DataFrame:
    """Export a ranking as a data frame for the ir-measures library.

    :param ranking: The input ranking.
    :return: Frame with ``query_id``, ``doc_id``, ``score`` columns.
    """
    return ranking._df[["q_id", "id", "score"]].rename(
        columns={"q_id": "query_id", "id": "doc_id"}
    )


def cos_dist(a: np.ndarray, b: np.ndarray) -> float:
    """Cosine distance of two vectors.

    :param a: First vector.
    :param b: Second vector.
    :return: The cosine distance.
    """
    assert a.ndim == b.ndim == 1
    return float(1 - np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))


def create_coalesced_index(
    source_index: "Index",
    target_index: "Index",
    delta: float,
    distance_function: Callable[[np.ndarray, np.ndarray], float] = cos_dist,
    batch_size: int | None = None,
) -> None:
    """Compress an index by sequential coalescing of consecutive passages.

    Walks each document's passage vectors in storage order, merging
    consecutive vectors into a running average while the distance to the
    running average stays below ``delta`` (reference:
    ``util/__init__.py:51-101``).  Vectors come from the source's host
    store (``_get_vectors``), so no device work runs.

    :param source_index: Source index (multiple vectors per document).
    :param target_index: Target index (must be empty).
    :param delta: The coalescing threshold.
    :param distance_function: The distance function.
    :param batch_size: Add to the target in batches of this many vectors.
    :raises ValueError: When the target index is not empty.
    """
    if len(target_index) > 0:
        raise ValueError("Target index is not empty.")

    def _coalesce(passages: np.ndarray) -> list[np.ndarray]:
        merged: list[np.ndarray] = []
        group: list[np.ndarray] = []
        group_avg = np.empty(())
        for vector in passages:
            if group and distance_function(vector, group_avg) >= delta:
                merged.append(group_avg)
                group = []
            group.append(vector)
            group_avg = np.mean(group, axis=0)
        merged.append(group_avg)
        return merged

    all_docs = list(source_index.doc_ids)
    batch_size = batch_size or len(all_docs)
    pending_vectors: list[np.ndarray] = []
    pending_ids: list[str] = []
    # fetch documents in bulk (one resolve + gather per chunk, not per doc)
    doc_chunk = 1024
    for i in progress(range(0, len(all_docs), doc_chunk)):
        chunk = all_docs[i : i + doc_chunk]
        vectors, out_ids = source_index._get_vectors(chunk)
        rows_of: dict[str, list[int]] = {}
        for row, d in enumerate(out_ids):
            rows_of.setdefault(d, []).append(row)
        for doc_id in chunk:
            if len(pending_vectors) >= batch_size:
                target_index.add(np.array(pending_vectors), doc_ids=pending_ids)
                pending_vectors, pending_ids = [], []
            coalesced = _coalesce(vectors[rows_of[doc_id]])
            pending_vectors.extend(coalesced)
            pending_ids.extend([doc_id] * len(coalesced))
    if pending_vectors:
        target_index.add(np.array(pending_vectors), doc_ids=pending_ids)

    assert source_index.doc_ids == target_index.doc_ids
