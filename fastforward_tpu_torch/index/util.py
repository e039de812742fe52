"""Host-side helpers: string IDs -> integer rows -> flat scoring arrays.

All correctness of the device scoring program rests on this mapping
(SURVEY.md §7): the host maps document/passage IDs to int32 row indices once,
and per call builds the flat ``(rows, qno, seg)`` arrays the device consumes.
The reference's equivalents are the pandas merges and the chunk indexer
(reference: ``index/util.py:12-113``, ``index/base.py:296-298``); here the
table is one logical array, so no chunk bookkeeping is needed.
"""

from collections.abc import Iterable, Mapping, Sequence

import numpy as np

from fastforward_tpu_torch.index.mode import Mode


def resolve_rows(
    ids: Iterable[str],
    mode: Mode,
    doc_id_to_rows: Mapping[str, Sequence[int]],
    psg_id_to_row: Mapping[str, int],
) -> tuple[np.ndarray, np.ndarray]:
    """Resolve IDs to table rows according to the ranking mode.

    Document modes (MAXP/AVEP) map an ID to all of its passage rows, FIRSTP
    to the first row only, PASSAGE to the single passage row.

    :param ids: The document/passage IDs, in output order.
    :param mode: The ranking mode.
    :param doc_id_to_rows: Document ID -> list of row indices.
    :param psg_id_to_row: Passage ID -> row index.
    :raises IndexError: When an ID is not present in the index.
    :return: ``(rows, counts)``: the concatenated row indices (int32) and the
        number of rows per input ID (int32).
    """
    rows: list[int] = []
    counts = []
    if mode in (Mode.MAXP, Mode.AVEP):
        for i in ids:
            r = doc_id_to_rows.get(i)
            if not r:
                raise IndexError(f"ID {i} not found in the index.")
            rows.extend(r)
            counts.append(len(r))
    elif mode == Mode.FIRSTP:
        for i in ids:
            r = doc_id_to_rows.get(i)
            if not r:
                raise IndexError(f"ID {i} not found in the index.")
            rows.append(r[0])
            counts.append(1)
    else:  # Mode.PASSAGE
        for i in ids:
            r = psg_id_to_row.get(i)
            if r is None:
                raise IndexError(f"ID {i} not found in the index.")
            rows.append(r)
            counts.append(1)
    return np.asarray(rows, dtype=np.int32), np.asarray(counts, dtype=np.int32)


def expand_pairs(
    pair_id_pos: np.ndarray,
    pair_qno: np.ndarray,
    rows_concat: np.ndarray,
    counts: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Expand (query, doc) pairs into flat per-candidate-vector arrays.

    Pure integer numpy; O(total rows).

    :param pair_id_pos: For each pair, the position of its ID among the
        unique IDs (indexes ``counts``/offsets), shape ``(n_pairs,)``.
    :param pair_qno: For each pair, its query number, shape ``(n_pairs,)``.
    :param rows_concat: Concatenated row indices per unique ID.
    :param counts: Rows per unique ID.
    :return: ``(rows, qno, seg)`` flat arrays, one entry per (pair, row).
    """
    offsets = np.zeros(counts.shape[0] + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])

    counts_per_pair = counts[pair_id_pos]
    n_pairs = pair_id_pos.shape[0]
    seg = np.repeat(np.arange(n_pairs, dtype=np.int32), counts_per_pair)
    # position of each flat entry within its pair's row block
    pair_ends = np.cumsum(counts_per_pair)
    within = np.arange(pair_ends[-1] if n_pairs else 0, dtype=np.int64) - np.repeat(
        pair_ends - counts_per_pair, counts_per_pair
    )
    rows = rows_concat[offsets[pair_id_pos][seg] + within].astype(np.int32)
    qno = pair_qno[seg].astype(np.int32)
    return rows, qno, seg


def expand_pairs_grouped(
    pair_id_pos: np.ndarray,
    rows_concat: np.ndarray,
    counts: np.ndarray,
    k: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Expand pairs into a dense ``(n_pairs, k)`` row matrix + count vector.

    The scatter-free device layout: pair ``p`` scores rows
    ``rows_mat[p, :counts_per_pair[p]]``; columns beyond the count repeat the
    last valid row (masked out by the device reduction).

    :param pair_id_pos: Unique-ID position per pair, ``(n_pairs,)``.
    :param rows_concat: Concatenated row indices per unique ID.
    :param counts: Rows per unique ID.
    :param k: Column count (>= ``counts.max()``).
    :return: ``(rows_mat (n_pairs, k) int32, counts_per_pair (n_pairs,) int32)``.
    """
    offsets = np.zeros(counts.shape[0] + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    counts_per_pair = counts[pair_id_pos]
    col = np.arange(k, dtype=np.int64)[None, :]
    clamped = np.minimum(col, (counts_per_pair[:, None] - 1).astype(np.int64))
    rows_mat = rows_concat[offsets[pair_id_pos][:, None] + clamped]
    return rows_mat.astype(np.int32), counts_per_pair.astype(np.int32)


class ChunkIndexer:
    """Retrieve vectors for IDs from a list of chunk arrays/memmaps.

    Reference-compatible utility (reference: ``index/util.py:45-113``) for
    users whose vectors live in a list of chunks — e.g. memmapped HDF5
    datasets read chunk-by-chunk — rather than in one logical array.  The
    first chunk may be larger than the rest; all later chunks share one
    size (the reference's chunk layout).

    Unlike the reference's per-ID Python loop, resolution is vectorized:
    chunk indices come from integer arithmetic over the whole row array,
    rows are grouped per chunk with one stable argsort, and each touched
    chunk is read with a single fancy index.  Output pairs ``(vectors[i],
    ids[i])`` always correspond; rows are grouped by ascending chunk (the
    reference groups by first appearance — both orders are "grouped by
    chunk", and no consumer depends on group order).
    """

    def __init__(
        self,
        chunks: "Sequence[np.ndarray]",
        doc_id_to_idx: Mapping[str, Sequence[int]],
        psg_id_to_idx: Mapping[str, int],
    ) -> None:
        """Create a chunk indexer.

        :param chunks: The chunk arrays (the first may be a different size).
        :param doc_id_to_idx: Document IDs mapped to non-chunked indices.
        :param psg_id_to_idx: Passage IDs mapped to non-chunked indices.
        """
        self._chunks = list(chunks)
        self._doc_id_to_idx = doc_id_to_idx
        self._psg_id_to_idx = psg_id_to_idx

    def _get_chunk_indices(self, idx: int) -> tuple[int, int]:
        """Map a global row index to ``(chunk index, index within chunk)``.

        Kept name-compatible with the reference helper, which its
        ``InMemoryIndex`` calls from other modules.
        """
        first = int(self._chunks[0].shape[0])
        if idx < first:
            return 0, int(idx)
        rest = int(self._chunks[1].shape[0])
        return int((idx - first) // rest) + 1, int((idx - first) % rest)

    def __call__(
        self, ids: Iterable[str], mode: Mode
    ) -> tuple[np.ndarray, list[str]]:
        """Retrieve vectors (and their repeated IDs) for the given IDs.

        :param ids: IDs to return vectors for.
        :param mode: The ranking mode (drives doc/passage resolution).
        :raises IndexError: When an ID cannot be found in the index.
        :return: The vectors and corresponding IDs, grouped by chunk.
        """
        ids = list(ids)
        rows, counts = resolve_rows(
            ids, mode, self._doc_id_to_idx, self._psg_id_to_idx
        )
        if rows.shape[0] == 0:
            return np.array([]), []
        rows64 = rows.astype(np.int64)
        first = int(self._chunks[0].shape[0])
        if len(self._chunks) == 1:
            chunk_no = np.zeros_like(rows64)
            within = rows64
        else:
            rest = int(self._chunks[1].shape[0])
            tail = rows64 - first
            in_first = rows64 < first
            chunk_no = np.where(in_first, 0, tail // rest + 1)
            within = np.where(in_first, rows64, tail % rest)
        id_per_row = np.repeat(np.arange(len(ids), dtype=np.int64), counts)
        order = np.argsort(chunk_no, kind="stable")
        chunk_no = chunk_no[order]
        within = within[order]
        out_ids = [ids[i] for i in id_per_row[order]]
        bounds = np.searchsorted(
            chunk_no, np.arange(len(self._chunks) + 1, dtype=np.int64)
        )
        parts = [
            self._chunks[c][within[lo:hi]]
            for c, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:]))
            if hi > lo
        ]
        return np.concatenate(parts), out_ids


def get_indices(
    ids: Iterable[str],
    mode: Mode,
    doc_id_to_idx: Mapping[str, Sequence[int]],
    psg_id_to_idx: Mapping[str, int],
) -> tuple[list[int], list[str]]:
    """Reference-compatible ID resolution (one repeated ID per row).

    Same contract as the reference helper of the same name
    (reference: ``index/util.py:12-42``) for users migrating call sites:
    returns ``(indices, ids)`` with each input ID repeated once per
    resolved row.  New code should prefer :func:`resolve_rows`, whose
    ``(rows, counts)`` form feeds the device layouts without building
    per-row string lists.
    """
    ids = list(ids)
    rows, counts = resolve_rows(ids, mode, doc_id_to_idx, psg_id_to_idx)
    out_ids = [i for i, c in zip(ids, counts) for _ in range(int(c))]
    return rows.tolist(), out_ids
