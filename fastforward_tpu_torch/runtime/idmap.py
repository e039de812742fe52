"""Host ID-map runtime: ctypes binding + pure-python fallback.

One interface, two implementations: ``NativeIdMap`` binds the C++ hash map
(GIL-free batch resolution over fixed-width numpy ``S`` arrays) and
``PyIdMap`` keeps plain dicts.  ``create_idmap()`` picks the native one when
the shared object builds.
"""

import ctypes
import logging
from collections import defaultdict
from collections.abc import Sequence

import numpy as np

from fastforward_tpu_torch.index.mode import Mode
from fastforward_tpu_torch.runtime.build import build_idmap

LOGGER = logging.getLogger(__name__)

_MODE_CODE = {Mode.PASSAGE: 0, Mode.MAXP: 1, Mode.AVEP: 1, Mode.FIRSTP: 2}

_lib = None
_lib_failed = False


def _get_lib():
    global _lib, _lib_failed
    if _lib is None and not _lib_failed:
        path = build_idmap()
        if path is None:
            _lib_failed = True
            return None
        lib = ctypes.CDLL(str(path))
        lib.idmap_create.restype = ctypes.c_void_p
        lib.idmap_destroy.argtypes = [ctypes.c_void_p]
        lib.idmap_add.restype = ctypes.c_int64
        lib.idmap_add.argtypes = [ctypes.c_void_p] + [ctypes.c_char_p] * 2 + [
            ctypes.c_int64
        ] * 3
        lib.idmap_check_new.restype = ctypes.c_int64
        lib.idmap_check_new.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_int64,
        ]
        lib.idmap_num_docs.restype = ctypes.c_int64
        lib.idmap_num_docs.argtypes = [ctypes.c_void_p]
        lib.idmap_num_psgs.restype = ctypes.c_int64
        lib.idmap_num_psgs.argtypes = [ctypes.c_void_p]
        lib.idmap_doc_ids.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_int64,
        ]
        lib.idmap_psg_ids.argtypes = lib.idmap_doc_ids.argtypes
        lib.idmap_resolve.restype = ctypes.c_int64
        lib.idmap_resolve.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_void_p),
        ]
        lib.idmap_fill_cached.restype = ctypes.c_int64
        lib.idmap_fill_cached.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.stream_count.restype = ctypes.c_int64
        lib.stream_count.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.stream_fill.restype = None
        lib.stream_fill.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.radix_argsort_u64.restype = None
        lib.radix_argsort_u64.argtypes = [
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.segmented_rank_argsort_f32.restype = None
        lib.segmented_rank_argsort_f32.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        for name in ("idmap_resolve_offsets32", "idmap_resolve_offsets64"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [
                ctypes.c_void_p,
                ctypes.c_void_p,  # utf8 data buffer
                ctypes.c_void_p,  # offsets buffer
                ctypes.c_int64,
                ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_void_p),
            ]
        lib.idmap_bulk_load.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_int64,
        ]
        _lib = lib
    return _lib


def _to_fixed_width(
    ids: Sequence[str | None] | np.ndarray, width: int | None = None
) -> np.ndarray:
    """Encode ids as a fixed-width ``S`` array (None -> empty field)."""
    if hasattr(ids, "to_numpy") and not isinstance(ids, np.ndarray):
        ids = ids.to_numpy()  # pd.Index from factorize
    if isinstance(ids, np.ndarray):
        if ids.dtype.kind == "S":
            return ids
        if ids.dtype.kind == "U":
            return ids.astype("S")
        if ids.dtype.kind == "O" and (len(ids) == 0 or isinstance(ids[0], str)):
            # vectorized C conversion (factorize output: str-only, no Nones;
            # np.asarray would silently stringify None as b'None')
            return np.asarray(ids, dtype="S")
    encoded = [(i or "").encode() for i in ids]
    width = width or max((len(e) for e in encoded), default=1)
    return np.array(encoded, dtype=f"S{max(width, 1)}")


def _arrow_view(ids):
    """Zero-copy (data_addr, offsets_addr, n, is_large) view of an
    arrow-backed pandas string array/Index, or ``None``."""
    array = getattr(ids, "array", ids)  # pd.Index / pd.Series -> array
    chunked = getattr(array, "_pa_array", None)
    if chunked is None:
        return None
    try:
        import pyarrow as pa

        combined = (
            chunked.combine_chunks()
            if isinstance(chunked, pa.ChunkedArray)
            else chunked
        )
        if combined.null_count:
            return None
        if pa.types.is_string(combined.type):
            is_large, width = False, 4
        elif pa.types.is_large_string(combined.type):
            is_large, width = True, 8
        else:
            return None
        buffers = combined.buffers()  # [validity, offsets, data]
        offsets_addr = buffers[1].address + combined.offset * width
        return combined, buffers[2].address, offsets_addr, len(combined), is_large
    except Exception:  # pragma: no cover - fall back to the copy path
        return None


class NativeIdMap:
    """C++-backed ID map (see ``idmap.cc``)."""

    def __init__(self) -> None:
        self._lib = _get_lib()
        self._handle = ctypes.c_void_p(self._lib.idmap_create())
        self._max_width = 1

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.idmap_destroy(self._handle)
            self._handle = None

    def _buf(self, arr: np.ndarray) -> ctypes.c_char_p:
        return ctypes.c_char_p(arr.tobytes())

    def add(
        self,
        doc_ids: Sequence[str | None] | None,
        psg_ids: Sequence[str | None] | None,
        start_row: int,
    ) -> None:
        """Register a batch of ids for rows ``start_row..``.

        :raises RuntimeError: When a passage ID already exists.
        """
        n = len(doc_ids) if doc_ids is not None else len(psg_ids)
        width = self._max_width
        doc_arr = _to_fixed_width(doc_ids) if doc_ids is not None else None
        psg_arr = _to_fixed_width(psg_ids) if psg_ids is not None else None
        for arr in (doc_arr, psg_arr):
            if arr is not None:
                width = max(width, arr.dtype.itemsize)
        self._max_width = width
        doc_buf = (
            self._buf(doc_arr.astype(f"S{width}")) if doc_arr is not None else None
        )
        psg_buf = (
            self._buf(psg_arr.astype(f"S{width}")) if psg_arr is not None else None
        )
        if psg_buf is not None:
            rc = self._lib.idmap_check_new(self._handle, psg_buf, n, width)
            if rc < 0:
                bad = psg_ids[-rc - 1]
                raise RuntimeError(f"Passage ID {bad} already exists.")
        rc = self._lib.idmap_add(self._handle, doc_buf, psg_buf, n, width, start_row)
        if rc < 0:  # pragma: no cover - pre-validated above
            raise RuntimeError(f"Passage ID {psg_ids[-rc - 1]} already exists.")

    def check_new_psgs(self, psg_ids: Sequence[str | None]) -> None:
        """Raise ``RuntimeError`` if any passage ID already exists."""
        width = max(self._max_width, 1)
        arr = _to_fixed_width(psg_ids)
        width = max(width, arr.dtype.itemsize)
        rc = self._lib.idmap_check_new(
            self._handle, self._buf(arr.astype(f"S{width}")), len(psg_ids), width
        )
        if rc < 0:
            raise RuntimeError(f"Passage ID {psg_ids[-rc - 1]} already exists.")

    def bulk_load(
        self, doc_ids: np.ndarray | None, psg_ids: np.ndarray | None
    ) -> None:
        """Load parallel fixed-width ``S`` arrays (row i -> ids[i])."""
        n = len(doc_ids) if doc_ids is not None else len(psg_ids)
        width = max(
            arr.dtype.itemsize for arr in (doc_ids, psg_ids) if arr is not None
        )
        self._max_width = max(self._max_width, width)
        doc_buf = (
            self._buf(np.ascontiguousarray(doc_ids.astype(f"S{width}")))
            if doc_ids is not None
            else None
        )
        psg_buf = (
            self._buf(np.ascontiguousarray(psg_ids.astype(f"S{width}")))
            if psg_ids is not None
            else None
        )
        self._lib.idmap_bulk_load(self._handle, doc_buf, psg_buf, n, width)

    @property
    def num_docs(self) -> int:
        return self._lib.idmap_num_docs(self._handle)

    @property
    def num_psgs(self) -> int:
        return self._lib.idmap_num_psgs(self._handle)

    def _id_array(self, kind: str) -> np.ndarray:
        count = self.num_docs if kind == "doc" else self.num_psgs
        width = max(self._max_width, 1)
        out = np.zeros(count, dtype=f"S{width}")
        fn = self._lib.idmap_doc_ids if kind == "doc" else self._lib.idmap_psg_ids
        if count:
            fn(self._handle, out.ctypes.data_as(ctypes.c_char_p), width)
        return out

    def doc_id_set(self) -> set[str]:
        return {i.decode() for i in self._id_array("doc")}

    def psg_id_set(self) -> set[str]:
        return {i.decode() for i in self._id_array("psg")}

    def resolve(
        self, ids: Sequence[str], mode: Mode
    ) -> tuple[np.ndarray, np.ndarray]:
        """Resolve ids to (flat rows, per-id counts).

        :raises IndexError: When an ID is missing.
        """
        code = _MODE_CODE[mode]
        n = len(ids)
        counts = np.zeros(n, dtype=np.int32)
        cache = np.zeros(n, dtype=np.uintp)
        counts_ptr = counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        cache_ptr = cache.ctypes.data_as(ctypes.POINTER(ctypes.c_void_p))

        arrow = _arrow_view(ids)
        if arrow is not None:
            keepalive, data_addr, offsets_addr, n, is_large = arrow
            fn = (
                self._lib.idmap_resolve_offsets64
                if is_large
                else self._lib.idmap_resolve_offsets32
            )
            total = fn(
                self._handle, data_addr, offsets_addr, n, code, counts_ptr, cache_ptr
            )
            del keepalive
        else:
            arr = np.ascontiguousarray(_to_fixed_width(ids))
            width = arr.dtype.itemsize
            buf = arr.ctypes.data_as(ctypes.c_char_p)
            total = self._lib.idmap_resolve(
                self._handle, buf, n, width, code, counts_ptr, cache_ptr
            )
        if total < 0:
            pos = int(-total - 1)
            bad = ids.iloc[pos] if hasattr(ids, "iloc") else ids[pos]
            raise IndexError(f"ID {bad} not found in the index.")
        rows = np.zeros(int(total), dtype=np.int32)
        self._lib.idmap_fill_cached(
            self._handle,
            cache.ctypes.data_as(ctypes.POINTER(ctypes.c_void_p)),
            n,
            code,
            rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return rows, counts

    def inverse(self, n_rows: int) -> tuple[list[str | None], list[str | None]]:
        """Row -> (doc id, psg id) lists for rows ``0..n_rows``."""
        doc_out: list[str | None] = [None] * n_rows
        psg_out: list[str | None] = [None] * n_rows
        doc_ids = [i.decode() for i in self._id_array("doc")]
        if doc_ids:
            rows, counts = self.resolve(doc_ids, Mode.MAXP)
            pos = 0
            for i, c in zip(doc_ids, counts):
                for r in rows[pos : pos + c]:
                    if r < n_rows:
                        doc_out[r] = i
                pos += c
        psg_ids = [i.decode() for i in self._id_array("psg")]
        if psg_ids:
            rows, _ = self.resolve(psg_ids, Mode.PASSAGE)
            for i, r in zip(psg_ids, rows):
                if r < n_rows:
                    psg_out[r] = i
        return doc_out, psg_out


class PyIdMap:
    """Pure-python fallback with the same interface."""

    def __init__(self) -> None:
        self._doc_rows: dict[str, list[int]] = defaultdict(list)
        self._psg_row: dict[str, int] = {}

    def add(self, doc_ids, psg_ids, start_row: int) -> None:
        if psg_ids is not None:
            self.check_new_psgs(psg_ids)
            for offset, psg_id in enumerate(psg_ids):
                if psg_id is not None:
                    self._psg_row[psg_id] = start_row + offset
        if doc_ids is not None:
            for offset, doc_id in enumerate(doc_ids):
                if doc_id is not None:
                    self._doc_rows[doc_id].append(start_row + offset)

    def check_new_psgs(self, psg_ids) -> None:
        seen = set()
        for psg_id in psg_ids:
            if psg_id is None:
                continue
            if psg_id in self._psg_row or psg_id in seen:
                raise RuntimeError(f"Passage ID {psg_id} already exists.")
            seen.add(psg_id)

    def bulk_load(self, doc_ids, psg_ids) -> None:
        n = len(doc_ids) if doc_ids is not None else len(psg_ids)
        for row in range(n):
            if doc_ids is not None:
                d = doc_ids[row].decode() if doc_ids[row] else None
                if d:
                    self._doc_rows[d].append(row)
            if psg_ids is not None:
                p = psg_ids[row].decode() if psg_ids[row] else None
                if p:
                    self._psg_row[p] = row

    @property
    def num_docs(self) -> int:
        return len(self._doc_rows)

    @property
    def num_psgs(self) -> int:
        return len(self._psg_row)

    def doc_id_set(self) -> set[str]:
        return set(self._doc_rows.keys())

    def psg_id_set(self) -> set[str]:
        return set(self._psg_row.keys())

    def resolve(self, ids, mode: Mode) -> tuple[np.ndarray, np.ndarray]:
        rows: list[int] = []
        counts = []
        if mode == Mode.PASSAGE:
            for i in ids:
                r = self._psg_row.get(i)
                if r is None:
                    raise IndexError(f"ID {i} not found in the index.")
                rows.append(r)
                counts.append(1)
        else:
            first_only = mode == Mode.FIRSTP
            for i in ids:
                r = self._doc_rows.get(i)
                if not r:
                    raise IndexError(f"ID {i} not found in the index.")
                if first_only:
                    rows.append(r[0])
                    counts.append(1)
                else:
                    rows.extend(r)
                    counts.append(len(r))
        return (
            np.asarray(rows, dtype=np.int32),
            np.asarray(counts, dtype=np.int32),
        )

    def inverse(self, n_rows: int):
        doc_out: list[str | None] = [None] * n_rows
        psg_out: list[str | None] = [None] * n_rows
        for doc_id, rows in self._doc_rows.items():
            for r in rows:
                if r < n_rows:
                    doc_out[r] = doc_id
        for psg_id, r in self._psg_row.items():
            if r < n_rows:
                psg_out[r] = psg_id
        return doc_out, psg_out


def create_idmap():
    """Return a native ID map when available, else the python fallback."""
    if _get_lib() is not None:
        return NativeIdMap()
    return PyIdMap()


def _i32ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i64ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def native_stream_layout(
    rows: np.ndarray,
    qno: np.ndarray,
    n_pad: int,
    qb: int,
    tile_rows: int,
    cap: int,
    pad_value: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Single-pass C++ builder for the streamed candidate layout.

    Returns ``(cand, tile_idx, slot_of_pair)`` (see
    ``ops.build_streamed_layout``), or ``None`` when the native runtime is
    unavailable.
    """
    lib = _get_lib()
    if lib is None:
        return None
    num_tiles = n_pad // tile_rows
    p = rows.shape[0]
    rows32 = np.ascontiguousarray(rows, dtype=np.int32)
    qno32 = np.ascontiguousarray(qno, dtype=np.int32)
    tile_counts = np.empty(num_tiles, dtype=np.int64)
    t_virtual = lib.stream_count(
        _i32ptr(rows32), p, tile_rows, num_tiles, cap, _i64ptr(tile_counts)
    )
    if t_virtual == 0:
        return None
    t_bucket = max(8, 1 << (int(t_virtual) - 1).bit_length())
    cand = np.full((t_bucket, cap), pad_value, dtype=np.int32)
    tile_idx = np.zeros(t_bucket, dtype=np.int32)
    slot_of_pair = np.empty(p, dtype=np.int64)
    lib.stream_fill(
        _i32ptr(rows32),
        _i32ptr(qno32),
        p,
        tile_rows,
        num_tiles,
        cap,
        qb,
        _i64ptr(tile_counts),
        _i32ptr(cand.reshape(-1)),
        _i32ptr(tile_idx),
        _i64ptr(slot_of_pair),
    )
    return cand, tile_idx, slot_of_pair


def radix_argsort(keys: np.ndarray) -> np.ndarray | None:
    """Native LSD radix argsort over uint64 keys (ascending), or ``None``."""
    lib = _get_lib()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    out = np.empty(keys.shape[0], dtype=np.int64)
    lib.radix_argsort_u64(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        keys.shape[0],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out


def segmented_rank_argsort(
    scores: np.ndarray, seg_starts: np.ndarray, out_starts: np.ndarray
) -> np.ndarray | None:
    """Per-segment descending stable argsort of fp32 scores, or ``None``.

    Segment ``q`` (rows ``seg_starts[q]:seg_starts[q+1]``) is sorted by
    score descending (ties keep input order) and written at
    ``out_starts[q]`` in the returned take array — the segmented version of
    the (q_rank << 32 | score) composite-key sort, ~10x faster because each
    per-query block radixes 32-bit keys in cache.
    """
    lib = _get_lib()
    if lib is None:
        return None
    scores = np.ascontiguousarray(scores, dtype=np.float32)
    seg_starts = np.ascontiguousarray(seg_starts, dtype=np.int64)
    out_starts = np.ascontiguousarray(out_starts, dtype=np.int64)
    num_q = seg_starts.shape[0] - 1
    out = np.empty(scores.shape[0], dtype=np.int64)
    lib.segmented_rank_argsort_f32(
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        seg_starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out_starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        num_q,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out


def segmented_rank_argsort_into(
    scores: np.ndarray,
    seg_starts: np.ndarray,
    out_starts: np.ndarray,
    out: np.ndarray,
) -> bool:
    """Windowed twin of :func:`segmented_rank_argsort` for overlapped
    fetches: sorts only the segments described by ``seg_starts`` /
    ``out_starts`` (which may be sub-slices covering a query range), writing
    ABSOLUTE input indices into the caller's full ``out`` buffer.

    ``scores`` must be the FULL contiguous fp32 score buffer — valid at
    least up to the last segment end in this window — and ``out`` the full
    int64 take buffer.  Returns ``False`` when the native library is
    unavailable (caller falls back to the one-shot sort).
    """
    lib = _get_lib()
    if lib is None:
        return False
    assert scores.dtype == np.float32 and scores.flags.c_contiguous
    assert out.dtype == np.int64 and out.flags.c_contiguous
    seg_starts = np.ascontiguousarray(seg_starts, dtype=np.int64)
    out_starts = np.ascontiguousarray(out_starts, dtype=np.int64)
    lib.segmented_rank_argsort_f32(
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        seg_starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out_starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        seg_starts.shape[0] - 1,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return True
