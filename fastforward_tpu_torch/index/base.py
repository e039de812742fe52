"""The index layer: vector store + scoring engine.

The port of ``fastforward_tpu/index/base.py``:
re-rank (``__call__``, ``submit``, with ``batch_size`` and early stopping),
fused serve (``serve``, ``submit_serve``, with early stopping), the merged
array path a ``BatchingServer`` drives (``_serve_prep``, ``_serve_arrays``)
and ``preload`` in every ranking mode (``Mode.PASSAGE``, ``Mode.FIRSTP``, ``Mode.MAXP``,
``Mode.AVEP``) against a device table of fp32/bf16 vectors, int8 codes
(``ScalarQuantizer``) or PQ codes (``PQ``/``OPQ``).  The host resolves
string IDs to int rows (natively) into a ``(pairs, K)`` layout (K rows per
pair, a power of two up to 64); dense candidate sets stream through the
kernels (K1/K2 for vectors and int8 codes, K3/K4 for PQ codes) with the
mode's K-reduce on the device, sparse or ungrouped ones take a gather-dot,
and documents with more than 64 passages (or more than 2^22 queries) take
the flat segment path.  Results are ordered on the host with the native
segmented sort while the score copy is still in flight; with
``score_transport="u16"`` that copy carries 16-bit codes (half the bytes).

A table beyond the index's ``hbm_budget`` is served from a hybrid view
(:func:`build_hybrid_view`: a device-resident prefix and a host tail
streamed in candidate blocks through the same kernels, ``ops.host_stream``);
its scores come back to the host, and the serve tail runs on them on the
device.  ``preload(progressive=True)`` installs a truncated table first and
the exact one from a background thread (``preload_join``).

A table row-sharded over a mesh of devices (``mesh_config``) scores
through the sharded programs (``parallel.sharded``): the streamed path one
kernel launch per shard, the gather path per position, documents with more
than 64 passages in chunks of 64; a mesh serves fused, without the refine
rescore (single device only), and under several processes the server's
array path steps aside.

Everything runs on the device of the index's table: the card by default,
the CPU when the caller asks for it (the plain versions of the kernels
then run).
"""

import abc
import dataclasses
import logging
import threading
import weakref
from collections import OrderedDict
from collections.abc import Callable, Iterable, Iterator, Sequence
from dataclasses import dataclass
from time import perf_counter
from typing import NamedTuple

import numpy as np
import pandas as pd
import torch

from fastforward_tpu_torch import ops
from fastforward_tpu_torch.encoder import LambdaEncoder
from fastforward_tpu_torch.encoder.base import Encoder
from fastforward_tpu_torch.index.mode import GROUPED_OP, REDUCE_OP, Mode
from fastforward_tpu_torch.index.util import expand_pairs, expand_pairs_grouped
from fastforward_tpu_torch.ops.scoring import _cached_q_upload
from fastforward_tpu_torch.parallel import sharded
from fastforward_tpu_torch.parallel.mesh import Mesh
from fastforward_tpu_torch.parallel.sharded import Replicated, ShardedTable
from fastforward_tpu_torch.quantizer import OPQ, Quantizer
from fastforward_tpu_torch.ranking import Ranking
from fastforward_tpu_torch.utils.tracing import annotate

LOGGER = logging.getLogger(__name__)

IDSequence = Sequence[str | None]

#: the grouped gather packs a query number into 22 bits (``qno << 8 |
#: count``); more queries than this take the flat segment path
_MAX_PACKED_QUERIES = 1 << 22


def check_ids(
    num_vectors: int, doc_ids: "IDSequence | None", psg_ids: "IDSequence | None"
) -> tuple[IDSequence, IDSequence]:
    """Validate the IDs of ``num_vectors`` new rows (``None`` lists become
    all-``None``).

    :raises ValueError: When ID counts don't match the vector count.
    :raises ValueError: When a vector has neither ID.
    """
    if doc_ids is None:
        doc_ids = [None] * num_vectors
    if psg_ids is None:
        psg_ids = [None] * num_vectors
    if not len(doc_ids) == len(psg_ids) == num_vectors:
        raise ValueError("Number of IDs does not match number of vectors.")
    for doc_id, psg_id in zip(doc_ids, psg_ids):
        if doc_id is None and psg_id is None:
            raise ValueError("Vector has neither document nor passage ID.")
    return doc_ids, psg_ids


@dataclass
class DeviceView:
    """Device-resident scoring arrays for an index backend.

    ``kind`` selects the scoring path: ``"dense"`` scores against a
    zero-padded ``(N_pad, dim)`` fp32 or bf16 table; ``"scalar"`` against
    int8 codes (``(N_pad, dim/128, 128)`` when ``dim % 128 == 0``, else
    ``(N_pad, dim)``) with the per-dimension ``scales`` folded into the
    queries; ``"pq"`` against ``(N_pad, M)`` PQ codes (uint8, or uint16 and
    uint32 for Ks > 256) and their fp32
    ``codebooks`` ``(M, Ks, Ds)`` (ADC; OPQ's rotation is folded into the
    queries); ``"hybrid"`` against a device-resident prefix (``table``, laid
    out as the ``hybrid_kind`` table is) and a host-RAM tail streamed in
    candidate blocks (``ops.host_stream``: the tier beyond device memory).
    When ``mesh`` is set the table (for ``"hybrid"``, its prefix) is a
    ``parallel.sharded.ShardedTable`` row-sharded over the mesh's ``shard``
    axis, the codebooks are replicated, and scoring runs the sharded
    programs (``fastforward_tpu_torch.parallel.sharded``).
    """

    kind: str
    table: "torch.Tensor | ShardedTable"
    precision: str = "exact"
    codebooks: "torch.Tensor | Replicated | None" = None
    scales: np.ndarray | None = None
    mesh: "Mesh | None" = None
    #: hybrid tier: the host tail ``(N - tail_start, width)``, the global
    #: row where it starts, the rows of a streamed block, and the device
    #: bytes that may keep tail blocks resident across calls
    host_tail: np.ndarray | None = None
    tail_start: int = 0
    chunk_rows: int = 0
    tail_cache_budget: int = 0
    #: what the hybrid tier streams: ``"dense"`` fp32/bf16 rows,
    #: ``"scalar"`` int8 code rows (scales fold into the queries) or
    #: ``"pq"`` PQ code rows (ADC against ``codebooks``)
    hybrid_kind: str = "dense"
    #: view-lifetime cache of table-derived state (the hybrid tier's
    #: device block cache, its copy stream and the tail as a tensor)
    aux: dict = dataclasses.field(default_factory=dict)


def build_hybrid_view(
    data: np.ndarray,
    num: int,
    dim: int,
    hbm_budget: int,
    precision: str,
    device: torch.device,
    chunk_rows: int | None = None,
    bf16: bool = False,
    kind: str = "dense",
    codebooks: np.ndarray | None = None,
    scales: np.ndarray | None = None,
    mesh: "Mesh | None" = None,
) -> "DeviceView | None":
    """Build a hybrid view beyond device memory, or ``None`` when the table
    fits ``hbm_budget``.

    70% of the budget holds a device-resident prefix of ``data`` (in steps of
    1,024 rows); the other rows stay in host RAM (a zero-copy view when
    ``data`` is contiguous in the staged dtype) and stream per call as
    candidate blocks; what is left of the budget caches tail blocks on the
    device across calls (``ops.host_stream``).

    The budget is charged only for what the view holds for its lifetime:
    the prefix, the cached blocks and, for PQ, the fp32 codebooks (the
    kernels read compact ``(N, M)`` codes, so no lane padding or codebook
    splits are charged).  Each scoring call adds scratch on top of it: two
    tail blocks in flight (``2 x chunk_rows x row_bytes``), the kernels'
    grouping scratch and, for K3/K4, their lookup tables (up to
    ``ops.stream_kernel_pq.ADC_TABLE_BYTES``).

    :param data: Host rows, ``(num, width)``: vectors, int8 codes or PQ
        codes (uint8, uint16 or uint32: a row costs ``M * itemsize``).
    :param num: Number of real rows.
    :param dim: Vector dimensionality (for ``kind="pq"`` the code width is
        ``data.shape[1]``).
    :param hbm_budget: Scoring-memory budget in bytes.
    :param precision: Dot precision tier.
    :param device: Device of the resident prefix.
    :param chunk_rows: Rows of a streamed block (default
        ``ops.host_stream.HOST_CHUNK_ROWS``).
    :param bf16: Keep the resident prefix and the streamed blocks in bf16
        (``kind="dense"`` only).
    :param kind: ``"dense"``, ``"scalar"`` (int8 codes, ``dim % 128 == 0``)
        or ``"pq"``.
    :param codebooks: PQ codebooks ``(M, Ks, Ds)`` fp32 (``kind="pq"``).
    :param scales: Per-dimension scales (``kind="scalar"``; folded into the
        queries).
    :param mesh: When set, ``hbm_budget`` is per physical device (a device
        that holds several shards splits it between them): the resident
        prefix is row-sharded over the mesh's ``shard`` axis (capacity:
        shards x budget on distinct devices) and scored by the sharded
        programs; only a table beyond the whole mesh's budget streams a host
        tail (single process).
    """
    from fastforward_tpu_torch.ops import host_stream
    from fastforward_tpu_torch.ops.upload import upload_table

    budget = hbm_budget
    if kind == "pq":
        width = data.shape[1]
        row_bytes = width * data.dtype.itemsize
        stage_dtype = data.dtype
        mm, ks, ds = codebooks.shape
        budget = max(0, budget - mm * ks * ds * 4)
        row_shape: tuple = (width,)
        table_dtype = torch.from_numpy(np.empty(0, data.dtype)).dtype
    elif kind == "scalar":
        row_bytes = dim
        stage_dtype = np.dtype(np.int8)
        row_shape = (dim // 128, 128)
        table_dtype = torch.int8
    else:
        row_bytes = dim * (2 if bf16 else 4)
        stage_dtype = np.dtype(np.float32)
        row_shape = (dim,)
        table_dtype = torch.bfloat16 if bf16 else torch.float32
    num_shards = mesh.shape["shard"] if mesh is not None else 1
    # the budget is per physical device: a mesh that names a device twice
    # holds two shards there, each charged its share
    held = mesh.shards_per_device if mesh is not None else 1
    n_pad = -(-num // 4096) * 4096
    if n_pad * row_bytes * held <= budget * num_shards:
        return None  # fits: the plain (possibly sharded) table
    per_shard = (int(budget * 0.7) // held // row_bytes) // 1024 * 1024
    resident = per_shard * num_shards
    if resident >= num:
        return None
    if resident == 0:
        mesh = None  # nothing to shard: an all-tail view is single-device
    if mesh is not None:
        from fastforward_tpu_torch.parallel.multihost import put_replicated, put_row_sharded

        res_dev = put_row_sharded(
            mesh, data[:resident], shape=(resident, *row_shape), dtype=table_dtype,
            stage_dtype=stage_dtype,
        )
    else:
        res_dev = upload_table(
            data[:resident], device, shape=(resident, *row_shape), dtype=table_dtype,
            stage_dtype=stage_dtype,
        )
    tail = data[resident:num]
    if tail.dtype != stage_dtype or not tail.flags["C_CONTIGUOUS"]:
        tail = np.ascontiguousarray(tail, dtype=stage_dtype)
    LOGGER.info(
        "%s table (%d rows x %d B) exceeds the %d-byte budget: serving from the "
        "hybrid tier (%d resident rows, %d host-streamed)",
        kind, num, row_bytes, hbm_budget, resident, tail.shape[0],
    )
    cb_dev = None
    if kind == "pq":
        cb_np = np.array(codebooks, dtype=np.float32)
        cb_dev = put_replicated(mesh, cb_np) if mesh is not None else torch.from_numpy(cb_np).to(device)
    return DeviceView(
        kind="hybrid",
        table=res_dev,
        precision=precision,
        codebooks=cb_dev,
        scales=scales,
        mesh=mesh,
        host_tail=tail,
        tail_start=resident,
        chunk_rows=chunk_rows or host_stream.HOST_CHUNK_ROWS,
        # the leftover budget caches tail blocks: per device, as the budget is
        tail_cache_budget=max(0, budget - held * per_shard * row_bytes),
        hybrid_kind=kind,
    )


def _multiprocess(view: DeviceView) -> bool:
    """Whether the view's mesh spans several processes (their calls must
    then run in one order, each through the collectives)."""
    return view.mesh is not None and view.mesh.multiprocess


def _synchronize(view: DeviceView) -> None:
    """Wait for the work queued on the view's cards (each local device of
    its mesh)."""
    devices = view.mesh.local_devices if view.mesh is not None else [view.table.device]
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _cat_from_codes(codes: np.ndarray, like: "pd.Categorical") -> "pd.Categorical":
    """Wrap already-gathered codes in ``like``'s categorical dtype.

    ``validate=False`` skips the O(n) code-range scan — the codes are takes
    of ``like.codes`` so they are valid by construction.
    """
    try:
        return pd.Categorical.from_codes(codes, dtype=like.dtype, validate=False)
    except TypeError:  # pragma: no cover - pandas < 2.1
        return pd.Categorical.from_codes(codes, dtype=like.dtype)


class _PackedScores(NamedTuple):
    """u16-transport score buffer: in-band header + codes (one copy)."""

    packed: torch.Tensor  # (4 + S,) int16, see ops.encode_scores_u16


def _fetch_scores_np(scores_dev) -> np.ndarray:
    """One-shot score fetch; decodes the u16 transport when present."""
    if isinstance(scores_dev, _PackedScores):
        return ops.decode_scores_u16(ops.fetch_np(scores_dev.packed))
    return ops.fetch_np(scores_dev)


def _overlap_fetch_sort(
    scores_dev: "torch.Tensor | _PackedScores",
    segments: tuple,
    n_pairs: int,
    sinks: "tuple[tuple, tuple] | None" = None,
) -> "tuple[np.ndarray, np.ndarray, bool] | None":
    """Chunked device->host score fetch overlapped with result ordering.

    The native per-query rank sort runs on the queries whose scores have
    landed while later chunks are still in flight.

    ``sinks = (srcs, dsts)``: aligned tuples of 1-d arrays — ``srcs`` in
    candidate (input) order, ``dsts`` in result order; the fetched score
    buffer itself is an implicit first src whose dst must be passed as
    ``dsts[0]`` with ``srcs[0] is None``.  As soon as a contiguous result
    region's take entries are final, ``dst[region] = src[take[region]]``
    runs under the still-in-flight later chunks.

    ``scores_dev`` may also be a u16-transport ``_PackedScores`` buffer
    (see ``ops.encode_scores_u16``): its header arrives with the first
    chunk, and each landed chunk of codes is dequantized into the fp32
    buffer before its queries are sorted.

    Returns ``(scores, take, materialized)`` — ``materialized`` reports
    that every sink row was written — or ``None`` when the scores are not
    an fp32 tensor or the native segmented sort is unavailable (the caller
    then runs the one-shot path).
    """
    raw = None
    if isinstance(scores_dev, _PackedScores):
        fetch_arr = scores_dev.packed
        raw = np.empty(int(fetch_arr.shape[0]), dtype=np.int16)
        codes = raw.view(np.uint16)
        n_scores = int(fetch_arr.shape[0]) - 4
    elif isinstance(scores_dev, torch.Tensor) and scores_dev.dtype == torch.float32:
        fetch_arr = scores_dev
        n_scores = int(scores_dev.shape[0])
    else:
        return None
    from fastforward_tpu_torch.runtime.idmap import segmented_rank_argsort_into

    seg_starts, out_starts = segments
    seg_starts = np.ascontiguousarray(seg_starts, dtype=np.int64)
    out_starts = np.ascontiguousarray(out_starts, dtype=np.int64)
    num_q = out_starts.shape[0]
    seg_ends = seg_starts[1:]
    # the device buffer may carry bucket padding past n_pairs
    buf = np.empty(n_scores, dtype=np.float32)
    take = np.empty(n_pairs, dtype=np.int64)
    pairs = ()
    if sinks is not None:
        srcs, dsts = sinks
        pairs = tuple((buf if src is None else src, dst) for src, dst in zip(srcs, dsts))
    # mat_lo: result rows [mat_lo, n_pairs) are materialized into the sinks.
    # Sorted blocks land in input order; their result positions tile a
    # suffix exactly when the covered length matches (blocks are disjoint
    # and all end <= n_pairs), so the suffix check is also the hole check.
    state = {"q": 0, "ok": True, "covered": 0, "lo_min": n_pairs, "mat_lo": n_pairs, "deq": 0}

    def on_chunk(lo: int, hi: int) -> None:
        if not state["ok"]:
            return
        if raw is not None:  # u16 transport: dequantize the landed prefix
            if hi < 4:
                return  # the in-band header has not landed yet
            hdr = state.get("hdr")
            if hdr is None:
                hdr = state["hdr"] = ops.decode_u16_header(raw[:4])
            a, b = state["deq"], hi - 4  # score coordinates (codes sit 4 on)
            if b > a:
                t = codes[a + 4 : hi].astype(np.float32)
                t *= hdr[1]
                t += hdr[0]
                buf[a:b] = t
                state["deq"] = b
            hi = b
        q0 = state["q"]
        # queries whose candidate block ends at or before the landed prefix
        q1 = int(np.searchsorted(seg_ends, min(hi, n_pairs), side="right"))
        if q1 <= q0:
            return
        if not segmented_rank_argsort_into(
            buf, seg_starts[q0 : q1 + 1], out_starts[q0:q1], take
        ):
            state["ok"] = False
            return
        state["q"] = q1
        if not pairs:
            return
        state["covered"] += int(seg_starts[q1] - seg_starts[q0])
        state["lo_min"] = min(state["lo_min"], int(out_starts[q0:q1].min()))
        if (
            state["covered"] == n_pairs - state["lo_min"]
            and state["lo_min"] < state["mat_lo"]
        ):
            region = slice(state["lo_min"], state["mat_lo"])
            sl = take[region]
            for src, dst in pairs:
                dst[region] = src[sl]
            state["mat_lo"] = state["lo_min"]

    ops.fetch_np_overlapped(fetch_arr, on_chunk=on_chunk, out=buf if raw is None else raw)
    if not state["ok"] or state["q"] < num_q:
        return None
    materialized = False
    if pairs:
        if state["mat_lo"] > 0:  # remainder (or non-suffix tiling orders)
            region = slice(0, state["mat_lo"])
            sl = take[region]
            for src, dst in pairs:
                dst[region] = src[sl]
        materialized = True
    return buf[:n_pairs], take, materialized


def _run_heads(col: pd.Series) -> np.ndarray:
    """Boolean mask of run heads (``col[i] != col[i-1]``; ``[0]`` is True).

    Vectorized per backing storage (categorical codes, an arrow
    neighbor-compare, or object numpy), so per-request serving prep never
    hashes the column just to find the query-run boundaries.
    """
    n = len(col)
    first = np.empty(n, dtype=bool)
    if not n:
        return first
    first[0] = True
    if n == 1:
        return first
    if isinstance(col.dtype, pd.CategoricalDtype):
        codes = col.cat.codes.to_numpy()
        np.not_equal(codes[1:], codes[:-1], out=first[1:])
        return first
    pa_arr = getattr(col.array, "_pa_array", None)
    if pa_arr is not None:  # arrow-backed strings
        import pyarrow.compute as pc

        comb = pa_arr.combine_chunks()
        ne = pc.fill_null(pc.not_equal(comb.slice(1), comb.slice(0, n - 1)), True)
        first[1:] = ne.to_numpy(zero_copy_only=False)
        return first
    vals = col.to_numpy(dtype=object)
    np.not_equal(vals[1:], vals[:-1], out=first[1:])
    return first


def _slot_matrix(
    pair_qno: np.ndarray, n_q: int, row_query: np.ndarray, n_rows: int
) -> np.ndarray:
    """A serve tail's ``(n_rows, D)`` int32 slot matrix, built on the host:
    row ``r`` lists the flat pair positions of query ``row_query[r]`` in
    input order, then ``-1`` (rows past ``row_query`` are all ``-1``).  The
    depth axis is padded to a power of two (at least 8); padding slots
    become ``-inf`` and are never selected ahead of real candidates."""
    n_pairs = pair_qno.shape[0]
    d_max = int(np.bincount(pair_qno, minlength=n_q).max()) if n_pairs else 1
    d_max = 1 << max(3, (d_max - 1).bit_length())
    slot = np.full((n_q, d_max), -1, dtype=np.int32)
    if n_pairs:
        if (np.diff(pair_qno) >= 0).all():
            spq, order = pair_qno, np.arange(n_pairs)
        else:
            order = np.argsort(pair_qno, kind="stable")
            spq = pair_qno[order]
        pos = np.arange(n_pairs, dtype=np.int64) - np.searchsorted(spq, np.arange(n_q))[spq]
        slot[spq, pos] = order.astype(np.int32)
    out = np.full((n_rows, d_max), -1, dtype=np.int32)
    out[: row_query.shape[0]] = slot[row_query]
    return out


def _numbered_frame(ranking: Ranking) -> "tuple[pd.DataFrame, list, pd.Index]":
    """A copy of the ranking's frame with dense query numbers ``q_no``
    (``pd.factorize`` numbers queries by first appearance), the query
    strings in that order and the unique ``q_id`` values."""
    df = ranking._df.copy()
    q_codes, q_uniques = pd.factorize(df["q_id"], sort=False)
    df["q_no"] = q_codes
    queries = df.loc[~df["q_id"].duplicated(), "query"].tolist()
    return df, queries, q_uniques


def _query_ranks(q_uniques) -> np.ndarray:
    """Each query's rank in the result order (``q_id`` descending), uint64."""
    n_q = len(q_uniques)
    ranks = np.empty(n_q, dtype=np.uint64)
    ranks[np.argsort(np.asarray(q_uniques, dtype=object))[::-1]] = np.arange(n_q, dtype=np.uint64)
    return ranks


def _desc_rank_order(qhi: np.ndarray, scores: np.ndarray) -> np.ndarray:
    """Stable result order for (q_id desc, score desc) in ONE pass.

    ``qhi`` holds the per-row query rank pre-shifted into the high 32 bits
    of a uint64; the low 32 bits get the bit-twiddled descending float32
    score (sign-flip trick: negatives map below positives, larger scores
    to smaller keys).  Sorted by the native radix argsort with a stable
    numpy argsort fallback.
    """
    from fastforward_tpu_torch.runtime.idmap import radix_argsort

    bits = np.ascontiguousarray(scores, dtype=np.float32).view(np.uint32)
    score_asc = np.where(bits >> 31 != 0, ~bits, bits | np.uint32(0x80000000))
    key = qhi | (np.uint32(0xFFFFFFFF) - score_asc).astype(np.uint64)
    order = radix_argsort(key)
    if order is None:
        order = np.argsort(key, kind="stable")
    return order


class ScoreFuture:
    """Handle for an in-flight :meth:`Index.submit` call.

    ``result()`` completes the call — the score fetch plus the result
    assembly — and returns the scored ranking; it is idempotent.
    """

    __slots__ = ("_finish", "_result", "_pipelined")

    def __init__(
        self,
        finish: "Callable[[], Ranking] | None" = None,
        result: "Ranking | None" = None,
    ) -> None:
        self._finish = finish
        self._result = result
        self._pipelined = finish is not None

    @property
    def pipelined(self) -> bool:
        """Whether the call actually deferred its fetch (vs eager)."""
        return self._pipelined

    def result(self) -> Ranking:
        """Fetch scores, assemble and return the ranking (idempotent)."""
        if self._result is None:
            assert self._finish is not None
            self._result = self._finish()
            self._finish = None
        return self._result


class Index(abc.ABC):
    """Abstract base class for Fast-Forward indexes on one torch device."""

    _query_encoder: Encoder | None = None
    _quantizer: Quantizer | None = None
    #: the torch device the index scores on (set by the backend)
    _device: torch.device

    #: score transport of the re-rank path: "f32" copies exact fp32 scores;
    #: "u16" quantizes them on the device and dequantizes them on the host,
    #: halving the per-call device->host copy (adds at most
    #: score_range / 131070 per score)
    _score_transport = "f32"

    #: per-phase wall times of the last :meth:`preload` (seconds)
    _preload_stats: "dict | None" = None

    #: the background thread of a progressive preload's exact table
    _progressive_thread: "threading.Thread | None" = None

    def __init__(
        self,
        query_encoder: Encoder | None = None,
        quantizer=None,
        mode: Mode = Mode.MAXP,
        encoder_batch_size: int = 32,
        score_transport: str = "f32",
    ) -> None:
        """Create an index.

        :param query_encoder: The query encoder to use.
        :param quantizer: The quantizer to use (attached to the empty
            index; vectors are encoded as they are added).
        :param mode: The ranking mode.
        :param encoder_batch_size: The query-encoder batch size.
        :param score_transport: ``"f32"`` (exact) or ``"u16"`` (the re-rank
            path's score copy in 16-bit codes: half the bytes, at most
            ``score_range / 131070`` added to each score).
        """
        if score_transport not in ("f32", "u16"):
            raise ValueError(
                f"score_transport must be 'f32' or 'u16', got {score_transport!r}"
            )
        self._score_transport = score_transport
        if query_encoder is not None:
            self.query_encoder = query_encoder
        self.mode = mode
        if quantizer is not None:
            self.quantizer = quantizer
        self._encoder_batch_size = encoder_batch_size
        # host string-ID -> int-row map (native C++ when available); the
        # device only ever sees int rows
        from fastforward_tpu_torch.runtime import create_idmap

        self._ids = create_idmap()
        # prepared-run plans: per-(ranking frame, mode) caches of everything
        # that depends only on the candidate set and the table — resolved
        # rows, streamed layouts with device-resident grids, sort keys.
        self._plans: OrderedDict[tuple, dict] = OrderedDict()
        self._plans_lock = threading.Lock()

    _MAX_PLANS = 4

    def _get_plan(self, ranking: Ranking) -> dict:
        """Return (creating if needed) the prepared-run plan for a ranking.

        Keyed on the ranking frame's object identity + ranking mode; a
        weakref callback evicts the entry when the frame is garbage
        collected (so a recycled ``id()`` can never alias), and ``add``
        clears all plans (the table changed).  Rankings are treated as
        immutable throughout, so identity implies an identical candidate
        set.
        """
        key = (id(ranking._df), self._mode)
        with self._plans_lock:
            plan = self._plans.get(key)
            if plan is None:
                plans = self._plans

                def _evict(_ref, _key=key, _plans=plans):
                    _plans.pop(_key, None)

                plan = {"_frame_ref": weakref.ref(ranking._df, _evict)}
                plans[key] = plan
                while len(plans) > self._MAX_PLANS:
                    plans.popitem(last=False)
            else:
                self._plans.move_to_end(key)
        return plan

    @property
    def device(self) -> torch.device:
        """The torch device the index scores on."""
        return self._device

    # -- encoders ------------------------------------------------------------

    def encode_queries(self, queries: Sequence[str]) -> np.ndarray:
        """Encode queries with the query encoder (micro-batched).

        :param queries: The queries to encode.
        :raises RuntimeError: When no query encoder exists.
        :return: The query vectors, shape ``(len(queries), dim)``.
        """
        if self.query_encoder is None:
            raise RuntimeError("Index does not have a query encoder.")
        with annotate("ff.encode"):
            parts = [
                self.query_encoder(queries[i : i + self._encoder_batch_size])
                for i in range(0, len(queries), self._encoder_batch_size)
            ]
            return np.concatenate(parts)

    @property
    def query_encoder(self) -> Encoder | None:
        """The query encoder (if any)."""
        return self._query_encoder

    @query_encoder.setter
    def query_encoder(self, encoder: Encoder) -> None:
        assert isinstance(encoder, Encoder)
        self._query_encoder = encoder

    @property
    def quantizer(self) -> Quantizer | None:
        """The quantizer (if any)."""
        return self._quantizer

    @quantizer.setter
    def quantizer(self, quantizer: Quantizer) -> None:
        if not isinstance(quantizer, Quantizer):
            raise TypeError(f"expected a Quantizer, got {type(quantizer).__name__}")
        if len(self) > 0:
            raise RuntimeError("Quantizers can only be attached to empty indexes.")
        self._quantizer = quantizer
        self._on_quantizer_set()
        quantizer.set_attached()

    def _on_quantizer_set(self) -> None:
        """Backend hook: a quantizer was attached to this index."""

    # -- mode / shape properties ---------------------------------------------

    @property
    def mode(self) -> Mode:
        """The ranking mode."""
        return self._mode

    @mode.setter
    def mode(self, mode: Mode) -> None:
        assert isinstance(mode, Mode)
        self._mode = mode

    @abc.abstractmethod
    def _get_internal_dim(self) -> int | None:
        pass

    @property
    def dim(self) -> int | None:
        """Dimensionality of the (decoded) vectors; ``None`` if empty."""
        if self._quantizer is not None:
            return self._quantizer.dims[0]
        return self._get_internal_dim()

    @property
    def doc_ids(self) -> set[str]:
        """All unique document IDs."""
        return self._ids.doc_id_set()

    @property
    def psg_ids(self) -> set[str]:
        """All unique passage IDs."""
        return self._ids.psg_id_set()

    @abc.abstractmethod
    def _get_num_vectors(self) -> int:
        pass

    def __len__(self) -> int:
        """Number of vectors in the index."""
        return self._get_num_vectors()

    # -- adding vectors ------------------------------------------------------

    @abc.abstractmethod
    def _add(
        self, vectors: np.ndarray, doc_ids: IDSequence, psg_ids: IDSequence
    ) -> None:
        """Store vectors and their IDs (backend)."""
        pass

    def add(
        self,
        vectors: np.ndarray,
        doc_ids: IDSequence | None = None,
        psg_ids: IDSequence | None = None,
    ) -> None:
        """Add vectors and their document/passage IDs to the index.

        Only one of ``doc_ids`` / ``psg_ids`` may be ``None``; individual IDs
        may be ``None`` but every vector needs at least one ID.  Document IDs
        may repeat (multi-passage documents); passage IDs must be unique.

        :param vectors: The vectors, shape ``(num_vectors, dim)``.
        :param doc_ids: Corresponding document IDs.
        :param psg_ids: Corresponding passage IDs.
        :raises ValueError: When ID counts don't match the vector count.
        :raises ValueError: When the dimensionality doesn't match the index.
        :raises ValueError: When a vector has neither ID.
        :raises RuntimeError: When the backend rejects the add.
        """
        num_vectors, dim = vectors.shape
        doc_ids, psg_ids = check_ids(num_vectors, doc_ids, psg_ids)
        if self.dim is not None and dim != self.dim:
            raise ValueError(
                f"Input vector dimensionality ({dim}) does not match "
                f"index dimensionality ({self.dim})."
            )
        if self._quantizer is not None:
            vectors = self._quantizer.encode(vectors)
        self._add(vectors, doc_ids, psg_ids)
        # prepared plans hold row indices into the (now stale) table
        self._plans.clear()

    # -- host reads ----------------------------------------------------------

    @abc.abstractmethod
    def _get_vectors(self, ids: Iterable[str]) -> tuple[np.ndarray, list[str]]:
        """Return stored (possibly quantized) vectors for IDs (backend, host).

        Each vector is paired with its ID in the returned list (an ID once
        per row it resolves to in the current mode).

        :param ids: The document/passage IDs.
        :raises IndexError: When an ID is not found.
        :return: The vectors and the corresponding IDs.
        """

    @abc.abstractmethod
    def _batch_iter(
        self, batch_size: int
    ) -> Iterator[tuple[np.ndarray, IDSequence, IDSequence]]:
        """Yield (stored vectors, doc IDs, psg IDs) batches (backend)."""

    def batch_iter(
        self, batch_size: int
    ) -> Iterator[tuple[np.ndarray, IDSequence, IDSequence]]:
        """Iterate over all vectors and IDs in batches (decoded if quantized).

        :param batch_size: The batch size.
        :return: Iterator of (vectors, doc IDs, psg IDs) tuples.
        """
        if self._quantizer is None:
            yield from self._batch_iter(batch_size)
        else:
            for vectors, doc_ids, psg_ids in self._batch_iter(batch_size):
                yield self._quantizer.decode(vectors), doc_ids, psg_ids

    def __iter__(self) -> Iterator[tuple[np.ndarray, str | None, str | None]]:
        """Iterate over all (vector, doc ID, psg ID) triples."""
        for vectors, doc_ids, psg_ids in self.batch_iter(2**9):
            yield from zip(vectors, doc_ids, psg_ids)

    # -- preload -------------------------------------------------------------

    def _progressive_job(self):
        """Backend hook: the split-plane upload job of
        ``preload(progressive=True)``, or ``None`` when this configuration
        has none (see ``index.memory._ProgressiveUpload``)."""
        return None

    def preload_join(self, timeout: "float | None" = None) -> bool:
        """Wait for a progressive preload's exact table to land.

        After ``preload(..., progressive=True)`` returns, scoring runs
        against the truncated fp32 table (bf16-magnitude error) while the
        low 16-bit planes upload on a background thread; this waits until
        the exact table is installed.  Returns ``True`` at once when nothing
        is pending.

        :param timeout: Seconds to wait (``None`` = forever).
        :return: Whether nothing is pending any more.
        """
        thread = self._progressive_thread
        if thread is None:
            return True
        thread.join(timeout)
        if thread.is_alive():
            return False
        self._progressive_thread = None
        return True

    def preload(
        self,
        warm: "tuple[int, int] | None" = None,
        serve: "tuple[float, int] | None" = None,
        progressive: bool = False,
    ) -> bool:
        """Eagerly upload the device table and prepare the scoring path.

        Normally the upload, the ``nvcc`` build and load of the kernels and
        their first launches happen on the first scoring call; call this to
        move them off the serving path.  The kernels the table's kind can
        stream through are built and loaded, and the table upload is
        synchronized.

        With ``warm=(num_queries, depth)`` one synthetic re-rank of that
        workload shape runs through the production path, its candidates
        spread over the whole table, with a zeros query encoder standing in
        for the user's (restored after).  With ``serve=(alpha, cutoff)``
        (requires ``warm``) the same workload also runs through
        :meth:`serve` in a thread of its own, on a ranking of its own; an
        optional third element warms the two-phase path
        (``serve=(alpha, cutoff, refine_margin)``).  Both synthetic plans
        are dropped.  Per-phase wall times land in ``self._preload_stats``
        (``upload_s``, ``build_s``, ``warm_rerank_s``, ``warm_serve_s``;
        ``overlap`` is ``False``: the warm runs after the upload).

        With ``progressive=True`` (dense fp32 tables above 512 MiB, host
        store, no budget) the upload ships the table's high 16-bit planes
        only, half the bytes, and installs the truncated fp32 table they
        make (``activate_s``; ``progressive`` says whether it was
        installed); the low planes fold in on a background thread, which
        swaps in the exact table (``progressive_exact``).  Until
        :meth:`preload_join` returns ``True`` scores carry bf16-magnitude
        error (about 0.4% relative).  Other configurations log a warning
        and take the standard upload.

        :param warm: Optional ``(num_queries, depth)`` workload shape.
        :param serve: Optional ``(alpha, cutoff[, refine])`` to warm
            :meth:`serve`.
        :param progressive: Split-plane upload.
        :raises ValueError: When ``serve`` is given without ``warm``.
        :return: Whether a device table exists (``False`` when empty).
        """
        if serve is not None and warm is None:
            raise ValueError(
                "preload(serve=...) requires warm=(num_queries, depth): the "
                "fused serve program is warmed by running the synthetic "
                "workload through serve()."
            )
        stats: dict = {"overlap": False}
        self._preload_stats = stats
        job = self._progressive_job() if progressive else None
        if progressive and job is None:
            LOGGER.warning(
                "progressive preload is not supported for this configuration "
                "(it needs a dense fp32 host-store table above 512 MiB, no "
                "hbm_budget and no table on the device yet); using the "
                "standard upload"
            )
        t0 = perf_counter()
        if job is not None:
            job.upload_hi()
            stats["upload_s"] = perf_counter() - t0
            t0 = perf_counter()
            stats["progressive"] = job.activate()
            stats["activate_s"] = perf_counter() - t0
            view = self._device_view()
        else:
            view = self._device_view()
            if view is not None:
                _synchronize(view)
            stats["upload_s"] = perf_counter() - t0
        if view is None:
            return False
        table = view.table
        kind = view.hybrid_kind if view.kind == "hybrid" else view.kind
        if table.device.type == "cuda" and (
            kind == "pq" or table.ndim == 3 or table.shape[1] % 128 == 0
        ):
            t0 = perf_counter()
            ops.load_kernels(kind)
            stats["build_s"] = perf_counter() - t0
        if warm is None:
            return True
        num_q, depth = warm
        n = len(self)
        if num_q <= 0 or depth <= 0:
            return True
        # candidates spread over the whole table, as a production run's do
        doc_ids, psg_ids = self._ids.inverse(n)
        pool = np.asarray(psg_ids if self._mode == Mode.PASSAGE else doc_ids, dtype=object)
        total = num_q * depth
        cands = pool[(np.arange(total, dtype=np.int64) * n) // total]
        # descending query names and scores: the frame is born sorted
        q_names = np.asarray(
            [f"ff-warm-q{i:06d}" for i in range(num_q - 1, -1, -1)], dtype=object
        )
        frame = pd.DataFrame(
            {
                "q_id": np.repeat(q_names, depth),
                "id": cands,
                "score": np.tile(np.arange(depth, 0, -1, dtype=np.float32), num_q),
            }
        )
        # doc modes sample repeated ids; keep one score per (q, id) pair
        frame = frame[frame["id"].notna() & ~frame.duplicated(["q_id", "id"])]
        if not len(frame):
            return True
        queries = {q: f"ff warm query {q}" for q in q_names}
        ranking = Ranking(frame, queries=queries, copy=False, is_sorted=True)
        serve_ranking: Ranking | None = None
        encoder = self._query_encoder
        try:
            # the user's encoder may reject texts outside its corpus, and
            # the warm scores are dropped anyway
            dim = self.dim
            self._query_encoder = LambdaEncoder(lambda _t: np.zeros(dim, dtype=np.float32))
            LOGGER.info("warming the scoring path for Q=%d depth=%d", num_q, depth)
            serve_thread: "threading.Thread | None" = None
            serve_err: list[BaseException] = []
            # several processes run their collectives in one order: the
            # serve warm then follows the re-rank warm instead of overlapping
            concurrent = not _multiprocess(view)
            if serve is not None:
                # a ranking of its own (a fresh frame, so a fresh plan key):
                # the two warms never share a plan
                serve_ranking = Ranking(frame.copy(), queries=queries, copy=False, is_sorted=True)

                def _serve_warm() -> None:
                    t0 = perf_counter()
                    try:
                        self.serve(
                            serve_ranking,
                            serve[0],
                            serve[1],
                            refine=serve[2] if len(serve) > 2 else None,
                        )
                    except Exception as exc:  # re-raised after the join
                        serve_err.append(exc)
                    finally:
                        stats["warm_serve_s"] = perf_counter() - t0

                serve_thread = threading.Thread(target=_serve_warm, name="ff-preload-serve-warm")
                if concurrent:
                    serve_thread.start()
            t0 = perf_counter()
            try:
                self(ranking)
            finally:
                stats["warm_rerank_s"] = perf_counter() - t0
                if serve_thread is not None:
                    if not concurrent:
                        serve_thread.start()
                    serve_thread.join()
            if serve_err:
                raise serve_err[0]
            _synchronize(view)
        finally:
            self._query_encoder = encoder
            self._plans.pop((id(ranking._df), self._mode), None)
            if serve_ranking is not None:
                self._plans.pop((id(serve_ranking._df), self._mode), None)
        return True

    # -- scoring -------------------------------------------------------------

    def _device_view(self) -> DeviceView | None:
        """Backend hook: device-resident arrays for the scoring path
        (``None`` while the index is empty)."""
        return None

    def _prepare_queries(self, query_vectors: np.ndarray, view: DeviceView) -> np.ndarray:
        """Fold quantizer-specific transforms into the query vectors (numpy
        fp32): OPQ's rotation for PQ codes, the scales for int8 codes."""
        q = np.asarray(query_vectors, dtype=np.float32)
        kind = view.hybrid_kind if view.kind == "hybrid" else view.kind
        if kind == "pq" and isinstance(self._quantizer, OPQ):
            q = self._quantizer.rotate(q)
        elif kind == "scalar":
            q = q * view.scales
        return q

    def _pad_queries(self, query_vectors: np.ndarray, view: DeviceView) -> np.ndarray:
        q = self._prepare_queries(query_vectors, view)
        q_pad = np.zeros((ops.bucket(q.shape[0]), q.shape[1]), dtype=np.float32)
        q_pad[: q.shape[0]] = q
        return q_pad

    def _device_score_grouped(
        self,
        view: DeviceView,
        query_vectors: np.ndarray,
        rows_mat: np.ndarray,
        pair_qno: np.ndarray,
        counts_pp: np.ndarray,
        k: int,
        fetch: bool = True,
        plan: dict | None = None,
    ) -> "np.ndarray | torch.Tensor":
        """Score the ``(pairs, K)`` candidate layout on the device, reduced
        along K by the mode (max / mean / first).

        Dense candidate sets stream through the kernels: vectors and int8
        codes (2D with ``dim % 128 == 0``, or 3D) when ``n_pairs * K * 500 >
        N``, PQ codes when ``n_pairs * K * 200 > N``; the K-reduce runs on the
        device, so only one score per pair is fetched.  Sparse ones take a
        gather-dot: the bounded gather (one row per pair, pairs grouped by
        query, vectors and int8 codes) or the grouped gather (any K, any pair
        order).  More than 2^22 queries take the flat segment path (the
        grouped gather packs the query number into 22 bits).  With
        ``fetch=False`` the device tensor is returned (its length may carry
        bucket padding past ``n_pairs``).  ``plan`` optionally caches the
        candidate-dependent device arrays across calls.
        """
        op = GROUPED_OP[self.mode]
        n_pairs = rows_mat.shape[0]
        q_pad = self._pad_queries(query_vectors, view)
        if q_pad.shape[0] > _MAX_PACKED_QUERIES:
            valid = np.arange(k)[None, :] < counts_pp[:, None]
            rows, qno, seg = expand_pairs(
                np.arange(n_pairs, dtype=np.int64),
                pair_qno,
                rows_mat[valid].astype(np.int64),
                counts_pp,
            )
            return self._device_score_flat(
                view, query_vectors, rows, qno, seg, n_pairs, fetch=fetch
            )
        if view.kind == "hybrid":
            # the tier beyond device memory: the resident prefix plus tail
            # blocks streamed from host RAM (ops.host_stream); document modes
            # take the ragged layout (no K-padding) and reduce on the device
            # per side, so 2 x n_pairs floats come back
            if k == 1:
                rows_flat = rows_mat[:, 0].astype(np.int64)
                qno_flat = pair_qno.astype(np.int64)
                reduce_spec = None
            else:
                ragged = plan.get("hybrid_ragged") if plan is not None else None
                if ragged is None:
                    valid = np.arange(k)[None, :] < counts_pp[:, None]
                    seg_flat = np.repeat(np.arange(n_pairs, dtype=np.int64), counts_pp)
                    ragged = (rows_mat[valid].astype(np.int64), pair_qno[seg_flat], seg_flat)
                    if plan is not None:
                        plan["hybrid_ragged"] = ragged
                rows_flat, qno_flat, seg_flat = ragged
                reduce_spec = (op, seg_flat, n_pairs, counts_pp)
            return self._hybrid_scores(view, q_pad, rows_flat, qno_flat, plan, reduce_spec)
        table = view.table
        streamable_dense = (
            view.kind in ("dense", "scalar")
            and (table.ndim == 3 or (table.ndim == 2 and table.shape[1] % 128 == 0))
            and n_pairs * k * ops.STREAM_DENSITY > table.shape[0]
        )
        streamable_pq = (
            view.kind == "pq" and n_pairs * k * ops.STREAM_DENSITY_PQ > table.shape[0]
        )
        if (streamable_dense or streamable_pq) and table.shape[0] % ops.KERNEL_TILE_ROWS == 0:
            layout_key = "stream_pq" if streamable_pq else "stream"
            if view.mesh is not None:
                layout_key = "stream_sharded_pq" if streamable_pq else "stream_sharded"
            reduce = None
            if plan is not None and layout_key in plan:
                # the plan holds the layout: the flat candidate arrays are
                # not needed again
                rows_flat = qno_flat = None
            elif k == 1:
                rows_flat, qno_flat = rows_mat[:, 0].astype(np.int64), pair_qno
            else:
                rows_flat = rows_mat.reshape(-1).astype(np.int64)
                qno_flat = np.repeat(pair_qno, k)
            if k > 1:
                counts_dev = plan.get("counts_dev") if plan is not None else None
                if counts_dev is None:
                    counts_dev = torch.from_numpy(counts_pp.astype(np.int32)).to(table.device)
                    if plan is not None:
                        plan["counts_dev"] = counts_dev
                reduce = (op, k, counts_dev)
            if streamable_pq and view.mesh is not None:
                row_scores = sharded.streamed_scores_sharded_pq(
                    view.mesh, table, view.codebooks, q_pad, rows_flat, qno_flat, plan=plan,
                    reduce=reduce, precision=view.precision, fetch=fetch,
                )
            elif view.mesh is not None:
                row_scores = sharded.streamed_scores_sharded(
                    view.mesh, table, q_pad, rows_flat, qno_flat, precision=view.precision,
                    plan=plan, reduce=reduce, fetch=fetch,
                )
            elif streamable_pq:
                row_scores = ops.streamed_scores_pq(
                    table,
                    view.codebooks,
                    q_pad,
                    rows_flat,
                    qno_flat,
                    precision=view.precision,
                    plan=plan,
                    reduce=reduce,
                    fetch=fetch,
                )
            else:
                row_scores = ops.streamed_scores(
                    table,
                    q_pad,
                    rows_flat,
                    qno_flat,
                    precision=view.precision,
                    plan=plan,
                    reduce=reduce,
                    fetch=fetch,
                )
            if row_scores is not None:
                if k == 1 or row_scores.shape[0] == n_pairs:
                    # k == 1, or the K-reduce already ran on the device
                    return row_scores
                # a scorer that returned one score per row: reduce on the host
                return ops.masked_reduce_host(
                    ops.fetch_np(row_scores).reshape(n_pairs, k), counts_pp, op
                )

        if (
            k == 1
            and view.mesh is None
            and view.kind in ("dense", "scalar")
            and (n_pairs == 0 or (np.diff(pair_qno) >= 0).all())
        ):
            # single row per pair, pairs grouped by query: send only the row
            # array; the device recovers qno from per-query boundaries
            cached = plan.get("bounded") if plan is not None else None
            if cached is None:
                rows_p = np.zeros(ops.bucket(n_pairs), dtype=np.int32)
                rows_p[:n_pairs] = rows_mat[:, 0]
                # cumulative end of each query's pair run (padding pairs fall
                # past the last bound, clipping to the padding query)
                bounds = np.searchsorted(
                    pair_qno, np.arange(q_pad.shape[0]), side="right"
                ).astype(np.int32)
                cached = (
                    torch.from_numpy(rows_p).to(table.device),
                    torch.from_numpy(bounds).to(table.device),
                )
                if plan is not None:
                    plan["bounded"] = cached
            q_dev = _cached_q_upload(q_pad, plan, "q_dev", table.device)
            scores = ops.score_pairs_bounded(
                table, q_dev, cached[0], cached[1], precision=view.precision
            )
        else:
            # the grouped gather: one stacked transfer of the K row columns
            # and the packed (qno, count) row; pairs need not be grouped by
            # query
            idx_dev = plan.get("grouped_idx") if plan is not None else None
            if idx_dev is None:
                idx = np.zeros((k + 1, ops.bucket(n_pairs)), dtype=np.int32)
                idx[:k, :n_pairs] = rows_mat.T
                idx[k, :n_pairs] = (pair_qno.astype(np.int32) << 8) | counts_pp
                # a sharded table's positions each take their own rows:
                # the host array stays in the plan
                idx_dev = idx if view.mesh is not None else torch.from_numpy(idx).to(table.device)
                if plan is not None:
                    plan["grouped_idx"] = idx_dev
            if view.mesh is not None:
                if view.kind == "pq":
                    scores = sharded.score_pairs_sharded_pq(
                        view.mesh, table, view.codebooks, q_pad, idx_dev, op
                    )
                else:
                    scores = sharded.score_pairs_sharded(
                        view.mesh, table, q_pad, idx_dev, op, precision=view.precision
                    )
                return scores if not fetch else ops.fetch_np(scores)[:n_pairs]
            q_dev = _cached_q_upload(q_pad, plan, "q_dev", table.device)
            if view.kind == "pq":
                scores = ops.score_pairs_grouped_pq(table, view.codebooks, q_dev, idx_dev, op)
            else:
                scores = ops.score_pairs_grouped(
                    table, q_dev, idx_dev, op, precision=view.precision
                )
        if not fetch:
            return scores
        return ops.fetch_np(scores)[:n_pairs]

    def _device_score_flat(
        self,
        view: DeviceView,
        query_vectors: np.ndarray,
        rows: np.ndarray,
        qno: np.ndarray,
        seg: np.ndarray,
        n_pairs: int,
        fetch: bool = True,
    ) -> "np.ndarray | torch.Tensor":
        """Score the flat per-row layout ``(rows, qno, seg)`` on the device and
        reduce each pair's rows with the mode's segment op: the path for
        documents with more than ``_MAX_GROUP_K`` passages and for more
        queries than the grouped packing holds.  With ``fetch=False`` the
        device tensor is returned (with bucket padding past ``n_pairs``)."""
        op = REDUCE_OP[self.mode]
        if view.kind == "hybrid":
            # the resident prefix holds only the first rows: score every row
            # through the hybrid engine, then reduce on the host (the rare
            # path of documents with very many passages)
            row_scores = self._hybrid_scores(
                view, self._pad_queries(query_vectors, view), rows.astype(np.int64),
                qno.astype(np.int64), None, None,
            )
            seg = np.asarray(seg, dtype=np.int64)
            if op == "max":
                out = np.full(n_pairs, -np.inf, dtype=np.float32)
                np.maximum.at(out, seg, row_scores)
                return out
            total = np.zeros(n_pairs, dtype=np.float64)
            np.add.at(total, seg, row_scores)
            if op == "mean":
                total /= np.maximum(np.bincount(seg, minlength=n_pairs), 1)
            return total.astype(np.float32)
        s_bucket = ops.bucket(n_pairs)
        if view.mesh is not None:
            # per-row scores over the shards, then the segment reduce
            row_scores = sharded.row_scores_sharded(
                view.mesh, view.table, self._pad_queries(query_vectors, view), rows, qno,
                view.precision, codebooks=view.codebooks if view.kind == "pq" else None,
            )
            seg_dev = torch.from_numpy(np.asarray(seg, dtype=np.int64)).to(row_scores.device)
            scores = ops.scoring._segment_reduce(row_scores, seg_dev, s_bucket, op)
            return scores if not fetch else ops.fetch_np(scores)[:n_pairs]
        idx = np.zeros((3, ops.bucket(rows.shape[0])), dtype=np.int32)
        idx[0, : rows.shape[0]] = rows
        idx[1, : qno.shape[0]] = qno
        idx[2] = s_bucket  # segment sentinel for padding
        idx[2, : seg.shape[0]] = seg
        device = view.table.device
        idx_dev = torch.from_numpy(idx).to(device)
        q_dev = torch.from_numpy(self._pad_queries(query_vectors, view)).to(device)
        if view.kind == "pq":
            scores = ops.score_pairs_pq(view.table, view.codebooks, q_dev, idx_dev, s_bucket, op)
        else:
            scores = ops.score_pairs_dense(
                view.table, q_dev, idx_dev, s_bucket, op, precision=view.precision
            )
        if not fetch:
            return scores
        return ops.fetch_np(scores)[:n_pairs]

    @staticmethod
    def _hybrid_scores(view, q_pad, rows, qno, plan, reduce_spec) -> np.ndarray:
        """Scores of a hybrid view's candidates (``ops.host_stream``), on the
        host: one per row, or one per pair with ``reduce_spec``."""
        from fastforward_tpu_torch.ops.host_stream import hybrid_scores

        return hybrid_scores(
            view.table,
            view.host_tail,
            view.tail_start,
            view.chunk_rows,
            q_pad,
            rows,
            qno,
            precision=view.precision,
            plan=plan,
            cache_device_blocks_budget=view.tail_cache_budget,
            cache_store=view.aux,
            reduce=reduce_spec,
            kind=view.hybrid_kind,
            codebooks=view.codebooks,
            mesh=view.mesh,
        )

    @staticmethod
    def _scores_on(scores: "np.ndarray | torch.Tensor", n_pairs: int, device) -> torch.Tensor:
        """The per-pair scores as a device tensor for the serve tail (the
        hybrid tier scores on the host side of the copy)."""
        if isinstance(scores, torch.Tensor):
            return scores
        padded = np.zeros(ops.bucket(n_pairs), dtype=np.float32)
        padded[:n_pairs] = scores[:n_pairs]
        return torch.from_numpy(padded).to(device)

    # documents with more passages than this take the flat segment path
    # (grouped K-padding would waste too much gather bandwidth)
    _MAX_GROUP_K = 64

    def _gather_view(self, ids) -> "tuple[DeviceView, np.ndarray, np.ndarray]":
        """Return ``(device view, per-ID row indices, per-ID row counts)``.

        With a device table: that table and the host ID map's rows.
        Without one (an ``OnDiskIndex`` without ``hbm_cache``): the IDs'
        vectors are read (and decoded) on the host and uploaded as a dense
        fp32 table on the index's device for this call only; the rows index
        that table.  The scoring then runs on the device as for any table.

        :raises IndexError: When an ID is missing from the index.
        """
        view = self._device_view()
        if view is not None:
            rows, counts = self._ids.resolve(ids, self.mode)
            return view, rows, counts
        ids = list(ids)
        vectors, vec_ids = self._get_vectors(ids)
        if self._quantizer is not None and len(vec_ids):
            vectors = self._quantizer.decode(vectors)
        vectors = np.asarray(vectors, dtype=np.float32).reshape(len(vec_ids), self.dim)
        # each ID's rows are the positions of its vectors, in order
        vec_codes, uniques = pd.factorize(pd.Index(vec_ids, dtype=object))
        order = np.argsort(vec_codes, kind="stable")
        per_code = np.bincount(vec_codes, minlength=len(uniques))
        code_start = np.cumsum(per_code) - per_code
        id_codes = uniques.get_indexer(pd.Index(ids, dtype=object))
        counts = np.where(id_codes >= 0, per_code[id_codes], 0)
        starts = np.repeat(code_start[id_codes], counts)
        within = np.arange(counts.sum()) - np.repeat(np.cumsum(counts) - counts, counts)
        rows = order[starts + within].astype(np.int32)
        table = torch.from_numpy(vectors).to(self._device)
        view = DeviceView("dense", table, precision=getattr(self, "_precision", "exact"))
        return view, rows, counts.astype(np.int32)

    def _candidate_arrays(
        self, df: pd.DataFrame
    ) -> "tuple[DeviceView, np.ndarray, np.ndarray, int] | None":
        """Resolve every row of ``df`` to the grouped candidate arrays
        ``(view, rows_mat, counts_pp, k)`` — the ``(pairs, K)`` layout of
        :meth:`_device_score_grouped`, K a power of two — or ``None`` when a
        document has more than ``_MAX_GROUP_K`` passages.

        :raises IndexError: When an ID is missing from the index.
        """
        view = self._device_view()
        if view is not None and self.mode in (Mode.PASSAGE, Mode.FIRSTP):
            # exactly one row per pair: resolve the whole id column directly
            # (zero-copy from the arrow buffers)
            rows, _ = self._ids.resolve(df["id"], self.mode)
            return view, rows[:, None], np.ones(len(df), dtype=np.int32), 1
        pair_id_pos, ids_unique = pd.factorize(df["id"], sort=False)
        view, rows_concat, counts = self._gather_view(ids_unique)
        k_max = int(counts.max()) if counts.size else 1
        if k_max > self._MAX_GROUP_K:
            return None
        k = max(1, 1 << (k_max - 1).bit_length())
        rows_mat, counts_pp = expand_pairs_grouped(
            pair_id_pos.astype(np.int64), rows_concat, counts, k
        )
        return view, rows_mat, counts_pp, k

    def _compute_scores(self, data: pd.DataFrame, query_vectors: np.ndarray) -> np.ndarray:
        """Semantic scores for the (query, ID) pairs of ``data`` (columns
        ``id`` and ``q_no``; ``query_vectors`` is indexed by ``q_no``), one
        per row in row order: the grouped layout when every document has at
        most ``_MAX_GROUP_K`` passages, the flat segment path otherwise."""
        if len(data) == 0:
            return np.zeros((0,), dtype=np.float32)
        pair_qno = data["q_no"].to_numpy(dtype=np.int64)
        prep = self._candidate_arrays(data)
        if prep is not None:
            view, rows_mat, counts_pp, k = prep
            return self._device_score_grouped(view, query_vectors, rows_mat, pair_qno, counts_pp, k)
        pair_id_pos, ids_unique = pd.factorize(data["id"], sort=False)
        view, rows_concat, counts = self._gather_view(ids_unique)
        rows, qno, seg = expand_pairs(pair_id_pos.astype(np.int64), pair_qno, rows_concat, counts)
        return self._device_score_flat(view, query_vectors, rows, qno, seg, len(data))

    def _score_and_sort(
        self,
        df: pd.DataFrame | None,
        query_vectors: np.ndarray,
        q_uniques,
        score_dtype,
        plan: dict | None = None,
        defer: bool = False,
    ) -> "Ranking | Callable[[], Ranking] | None":
        """Fused fast path: device scoring + host result ordering.

        Returns ``None`` when the candidates need the flat segment path
        (documents with more than ``_MAX_GROUP_K`` passages), or when a
        ready plan's device table is gone.  With a
        *ready* ``plan`` (a previous call on the same ranking succeeded),
        ``df`` may be ``None`` — every candidate-derived artifact comes from
        the plan and only queries are live.

        With ``defer=True`` the device work is launched now but the zero-arg
        *finish* callable is returned instead of the ranking: the score
        fetch + result assembly run when it is called (the seam used by
        :meth:`Index.submit`).
        """
        if plan is not None and self._device_view() is None:
            if plan.get("ready"):  # the table went away under a ready plan
                return None
            # plans hold rows of a persistent device table; the host gather
            # builds its table anew on every call
            plan = None
        if plan is not None and plan.get("cand_ready"):
            # candidate resolution already done (by an earlier call or a
            # serve() call on the same ranking)
            n_pairs = plan["n_pairs"]
            pair_qno = plan["pair_qno"]
            rows_mat = plan["rows_mat"]
            counts_pp = plan["counts_pp"]
            k = plan["k"]
            view = self._device_view()
        else:
            n_pairs = len(df)
            pair_qno = df["q_no"].to_numpy(dtype=np.int64)
            prep = self._candidate_arrays(df)
            if prep is None:
                return None
            view, rows_mat, counts_pp, k = prep
        with annotate("ff.score"):
            scores_dev = self._device_score_grouped(
                view,
                query_vectors,
                rows_mat,
                pair_qno,
                counts_pp,
                k,
                fetch=False,
                plan=plan,
            )
        if (
            self._score_transport == "u16"
            and isinstance(scores_dev, torch.Tensor)
            and scores_dev.dtype == torch.float32
        ):
            scores_dev = _PackedScores(ops.encode_scores_u16(scores_dev))

        def finish() -> Ranking:
            return self._finish_score_and_sort(
                scores_dev,
                df,
                q_uniques,
                score_dtype,
                plan,
                n_pairs,
                pair_qno,
                rows_mat,
                counts_pp,
                k,
            )

        if defer:
            return finish
        return finish()

    def _finish_score_and_sort(
        self,
        scores_dev: "torch.Tensor | _PackedScores",
        df: pd.DataFrame | None,
        q_uniques,
        score_dtype,
        plan: dict | None,
        n_pairs: int,
        pair_qno: np.ndarray,
        rows_mat: np.ndarray,
        counts_pp: np.ndarray,
        k: int,
    ) -> Ranking:
        """Fetch + order + assemble the result of a launched fast path."""
        # result order: q_id desc (via per-query rank), then score desc
        if plan is not None and plan.get("ready"):
            q_rank = plan["q_rank"]
            qkey = plan["qkey"]
            segments = plan["segments"]
            qid_arr, id_arr, query_arr = plan["out_arrays"]
        else:
            n_q = len(q_uniques)
            q_rank = _query_ranks(q_uniques)
            if plan is not None:
                # categorical columns: reordering is then a take on int
                # codes instead of on string arrays; the dictionary build
                # amortizes over the plan
                qid_arr = pd.Categorical(df["q_id"])
                id_arr = pd.Categorical(df["id"])
                query_arr = pd.Categorical(df["query"])
            else:
                qid_arr = df["q_id"].array
                id_arr = df["id"].array
                query_arr = df["query"].array
            # the high 32 key bits depend only on the candidate layout
            qkey = q_rank[pair_qno] << np.uint64(32)
            # per-query segment bounds: the input frame is (q_id, score)-
            # sorted so each query's rows are contiguous; the output block
            # of query rank r starts where the ranks before it end
            segments = None
            if n_pairs == 0 or (np.diff(pair_qno) >= 0).all():
                seg_starts = np.searchsorted(pair_qno, np.arange(n_q + 1)).astype(
                    np.int64
                )
                lengths = np.diff(seg_starts)
                by_rank = np.empty(n_q, dtype=np.int64)
                by_rank[q_rank.astype(np.int64)] = np.arange(n_q)
                cum = np.zeros(n_q + 1, dtype=np.int64)
                np.cumsum(lengths[by_rank], out=cum[1:])
                out_starts = np.empty(n_q, dtype=np.int64)
                out_starts[by_rank] = cum[:-1]
                segments = (seg_starts, out_starts)
        scores_np = take = None
        materialized = False
        cats = (qid_arr, id_arr, query_arr)
        dst_cols: tuple = ()
        if segments is not None:
            # overlapped fetch: rank-sort each query's block while later
            # chunks of the score copy are still in flight
            sinks = None
            if all(isinstance(a, pd.Categorical) for a in cats):
                # result assembly rides the overlap too
                dst_cols = (
                    np.empty(n_pairs, dtype=np.float32),
                    *(np.empty(n_pairs, dtype=a.codes.dtype) for a in cats),
                )
                sinks = ((None, *(a.codes for a in cats)), dst_cols)
            with annotate("ff.fetch_sort"):
                fetched = _overlap_fetch_sort(scores_dev, segments, n_pairs, sinks)
            if fetched is not None:
                scores_np, take, materialized = fetched
        if scores_np is None:
            scores_np = _fetch_scores_np(scores_dev)[:n_pairs]
            from fastforward_tpu_torch.runtime.idmap import segmented_rank_argsort

            if segments is not None:
                take = segmented_rank_argsort(scores_np, *segments)
            if take is None:
                take = _desc_rank_order(qkey, scores_np)
        with annotate("ff.assemble"):
            if materialized:
                score_col, qid_col, id_col, query_col = dst_cols
                out = pd.DataFrame(
                    {
                        "q_id": _cat_from_codes(qid_col, qid_arr),
                        "id": _cat_from_codes(id_col, id_arr),
                        "score": score_col.astype(score_dtype, copy=False),
                        "query": _cat_from_codes(query_col, query_arr),
                    }
                )
            else:
                out = pd.DataFrame(
                    {
                        "q_id": qid_arr.take(take),
                        "id": id_arr.take(take),
                        "score": scores_np[take].astype(score_dtype, copy=False),
                        "query": query_arr.take(take),
                    }
                )
        if plan is not None and not plan.get("ready"):
            plan.update(
                n_pairs=n_pairs,
                pair_qno=pair_qno,
                rows_mat=rows_mat,
                counts_pp=counts_pp,
                k=k,
                q_rank=q_rank,
                qkey=qkey,
                segments=segments,
                out_arrays=(qid_arr, id_arr, query_arr),
                cand_ready=True,
                ready=True,
            )
        q_ids = None
        if plan is not None:
            q_ids = plan.get("q_ids_set")
            if q_ids is None:
                q_ids = set(np.asarray(q_uniques, dtype=object))
                plan["q_ids_set"] = q_ids
            q_ids = q_ids.copy()  # rankings must not share the mutable set
        return Ranking._from_trusted_frame(out, "fast-forward", q_ids=q_ids)

    def _early_stopping(
        self,
        df: pd.DataFrame,
        query_vectors: np.ndarray,
        cutoff: int,
        alpha: float,
        depths: Iterable[int],
        plan: dict | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Score progressively deeper chunks, dropping queries that stopped.

        Returns ``(take, ff)``: positional indices of the scored rows of
        ``df`` (in depth-round order) and their semantic scores; callers
        assemble the result frame.

        A query stops once its ``cutoff``-th best interpolated score can no
        longer be beaten by unscored candidates (lexical bound = last scored
        lexical score, semantic bound = best semantic score seen); only
        scored rows are returned.  The frame is (q_id, score)-sorted, so
        each query's rows form one contiguous run: depth chunks are integer
        ranges over its run offsets, and each round scores only the rows not
        scored before on the device (one-row-per-pair modes resolve their
        IDs per round, so stopped queries never resolve deep candidates).

        ``plan`` keeps the per-ranking ES state across calls: candidate
        resolution, run offsets and the alpha-independent semantic scores
        (an alpha sweep re-scores nothing it scored before), checked against
        the query vectors' content, so a changed encoder output rescores.
        """
        n = len(df)
        if n == 0:
            return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.float32)

        state = plan.get("es_state") if plan is not None else None
        if state is not None and (
            state["n"] != n
            or state["qv"].shape != query_vectors.shape
            or not np.array_equal(state["qv"], query_vectors)
        ):
            state = None
        if plan is not None:
            # tells _assemble_es this plan is hot (a repeat call): only then
            # is building cached categorical ID columns worth it
            plan["es_hot"] = state is not None
        if state is None:
            q_no = df["q_no"].to_numpy(dtype=np.int64)
            change = np.flatnonzero(np.diff(q_no)) + 1
            view = self._device_view()
            lazy = view is not None and self.mode in (Mode.PASSAGE, Mode.FIRSTP)
            state = {
                "n": n,
                "qv": np.array(query_vectors, copy=True),
                "q_no": q_no,
                "lex": df["score"].to_numpy(dtype=np.float32),
                # contiguous run per query
                "starts": np.concatenate(([0], change)),
                "ends": np.concatenate((change, [n])),
                "prep": None if lazy else self._candidate_arrays(df),
                "view": view if lazy else None,
                "lazy_rows": np.full(n, -1, dtype=np.int64) if lazy else None,
                "ff": np.empty(n, dtype=np.float32),
                "have": np.zeros(n, dtype=bool),
            }
            if plan is not None:
                plan["es_state"] = state
        q_no, lex = state["q_no"], state["lex"]
        starts, ends = state["starts"], state["ends"]
        nq = starts.shape[0]
        prep = state["prep"]
        ff_cache, have = state["ff"], state["have"]

        # per-query state: top-`cutoff` interpolated scores (desc, -inf
        # padded), number of rows scored, best semantic score
        topk = np.full((nq, cutoff), -np.inf, dtype=np.float64)
        scored_n = np.zeros(nq, dtype=np.int64)
        best_sem = np.full(nq, -np.inf, dtype=np.float64)

        sels: list[np.ndarray] = []
        ffs: list[np.ndarray] = []
        a = 0
        for b in sorted(depths):
            if b < cutoff:
                continue
            if a == 0:
                act_idx = np.arange(nq)
            else:
                kth = topk[np.arange(nq), np.minimum(scored_n, cutoff) - 1]
                last_lex = lex[np.minimum(starts + np.maximum(scored_n, 1), ends) - 1]
                bound = alpha * last_lex + (1 - alpha) * best_sem
                act_idx = np.flatnonzero((kth < bound) & (scored_n > 0))
            LOGGER.info("depth %s: %s queries left", b, len(act_idx))

            # chunk = rows a..b of each active query's run, clamped
            lo = starts[act_idx] + a
            hi = np.minimum(starts[act_idx] + b, ends[act_idx])
            lens = np.maximum(hi - lo, 0)
            nonempty = lens > 0
            lo, lens, act_rows = lo[nonempty], lens[nonempty], act_idx[nonempty]
            total = int(lens.sum())
            if total == 0:
                break
            offsets = np.concatenate(([0], np.cumsum(lens)[:-1]))
            within = np.arange(total, dtype=np.int64) - np.repeat(offsets, lens)
            sel = within + np.repeat(lo, lens)

            need = sel[~have[sel]]
            if need.size:
                with annotate("ff.es_score"):
                    if state["lazy_rows"] is not None:
                        lazy_rows = state["lazy_rows"]
                        missing = need[lazy_rows[need] < 0]
                        if missing.size:
                            resolved, _ = self._ids.resolve(df["id"].iloc[missing], self.mode)
                            lazy_rows[missing] = resolved
                        scored = self._device_score_grouped(
                            state["view"],
                            query_vectors,
                            lazy_rows[need][:, None],
                            q_no[need],
                            np.ones(need.size, dtype=np.int32),
                            1,
                        )
                    elif prep is not None:
                        view, rows_mat, counts_pp, k = prep
                        scored = self._device_score_grouped(
                            view, query_vectors, rows_mat[need], q_no[need], counts_pp[need], k
                        )
                    else:  # documents with more than _MAX_GROUP_K passages
                        scored = self._compute_scores(df.iloc[need], query_vectors)
                ff_cache[need] = scored
                have[need] = True
            ff = ff_cache[sel]
            # interpolate on the host: the inputs are host arrays and the
            # result feeds the host criterion
            int_score = (alpha * lex[sel] + (1.0 - alpha) * ff).astype(np.float32)

            # per-query state updates (reduceat over contiguous segments)
            best_sem[act_rows] = np.maximum(best_sem[act_rows], np.maximum.reduceat(ff, offsets))
            scored_n[act_rows] += lens
            # top-k maintenance, vectorized over active queries: each
            # query's (old top-k ++ new chunk) in one -inf-padded row, the
            # best `cutoff` partitioned into the tail columns, then sorted
            n_act = act_rows.shape[0]
            width = cutoff + int(lens.max())
            mat = np.full((n_act, width), -np.inf)
            mat[:, :cutoff] = topk[act_rows]
            mat[np.repeat(np.arange(n_act), lens), cutoff + within] = int_score
            best = np.partition(mat, width - cutoff, axis=1)[:, width - cutoff :]
            topk[act_rows] = -np.sort(-best, axis=1)

            sels.append(sel)
            ffs.append(ff)
            a = b

        if not sels:
            return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.float32)
        return np.concatenate(sels), np.concatenate(ffs)

    def _assemble_es(
        self,
        df: pd.DataFrame,
        take: np.ndarray,
        ff: np.ndarray,
        q_uniques,
        score_dtype,
        plan: dict | None,
        cut: "int | None" = None,
    ) -> Ranking:
        """Assemble the ES result ranking from scored-row indices: ordered by
        (q_id desc, score desc) through the composite-key radix argsort and,
        with ``cut``, only the top ``cut`` rows of each query kept.

        Categorical ID columns are built (and kept in the plan) only on a
        repeat call of the same plan; a one-shot ranking takes the frame's
        own arrays.
        """
        arrs = plan.get("es_arrays") if plan is not None else None
        if arrs is None:
            # per-row high key bits (query rank): candidate layout only
            qhi = _query_ranks(q_uniques)[df["q_no"].to_numpy()] << np.uint64(32)
            if plan is not None and plan.get("es_hot"):
                qid_arr = pd.Categorical(df["q_id"])
                id_arr = pd.Categorical(df["id"])
                query_arr = pd.Categorical(df["query"])
                plan["es_arrays"] = (qhi, qid_arr, id_arr, query_arr)
            else:
                qid_arr = df["q_id"].array
                id_arr = df["id"].array
                query_arr = df["query"].array
        else:
            qhi, qid_arr, id_arr, query_arr = arrs
        qhi_take = qhi[take]
        order = _desc_rank_order(qhi_take, ff)
        if cut is not None and order.size:
            # ES-serve tail: keep the top `cut` rows per query directly in
            # the sorted order — queries are contiguous runs of equal qhi
            keys = qhi_take[order]
            run_start = np.empty(keys.size, dtype=bool)
            run_start[0] = True
            np.not_equal(keys[1:], keys[:-1], out=run_start[1:])
            starts = np.flatnonzero(run_start)
            lens = np.diff(np.concatenate((starts, [keys.size])))
            pos = np.arange(keys.size, dtype=np.int64) - np.repeat(starts, lens)
            order = order[pos < cut]
        final = take[order]
        out = pd.DataFrame(
            {
                "q_id": qid_arr.take(final),
                "id": id_arr.take(final),
                "score": ff[order].astype(score_dtype),
                "query": query_arr.take(final),
            }
        )
        return Ranking._from_trusted_frame(out, "fast-forward")

    def __call__(
        self,
        ranking: Ranking,
        early_stopping: int | None = None,
        early_stopping_alpha: float | None = None,
        early_stopping_depths: Iterable[int] | None = None,
        batch_size: int | None = None,
    ) -> Ranking:
        """Compute semantic scores for a ranking.

        :param ranking: The ranking (queries must be attached).
        :param early_stopping: Early-stopping cut-off depth.
        :param early_stopping_alpha: Early-stopping interpolation parameter.
        :param early_stopping_depths: Early-stopping depth schedule.
        :param batch_size: Queries per device batch (``None``: all at once).
        :raises ValueError: When the ranking has no queries attached.
        :raises ValueError: When early-stopping arguments are missing.
        :raises IndexError: When an ID is missing from the index.
        :return: A ranking with the computed scores.
        """
        if not ranking.has_queries:
            raise ValueError("Input ranking has no queries attached.")
        if early_stopping is not None and (
            early_stopping_alpha is None or early_stopping_depths is None
        ):
            raise ValueError("Early stopping requires alpha and depths.")
        from fastforward_tpu_torch.utils.tracing import maybe_trace

        with maybe_trace():
            return self._call(
                ranking, early_stopping, early_stopping_alpha, early_stopping_depths, batch_size
            )

    def _call(
        self,
        ranking: Ranking,
        early_stopping: int | None,
        early_stopping_alpha: float | None,
        early_stopping_depths: Iterable[int] | None,
        batch_size: int | None,
    ) -> Ranking:
        t0 = perf_counter()
        score_dtype = ranking._df.dtypes["score"]
        # prepared-run fast path: the same ranking was scored before against
        # the current table — skip all frame work and candidate resolution
        plan = self._get_plan(ranking)
        if early_stopping is None and plan.get("ready"):
            queries = plan["queries"]
            if batch_size is None or batch_size >= len(queries):
                query_vectors = self.encode_queries(queries)
                out = self._score_and_sort(
                    None, query_vectors, plan["q_uniques"], score_dtype, plan=plan
                )
                if out is not None:
                    LOGGER.info("computed scores in %s seconds (prepared)", perf_counter() - t0)
                    return out

        # unique queries -> dense query numbers (device batch indices):
        # factorize numbers queries by first appearance, and the
        # first-occurrence rows carry the matching query strings
        es_prep = plan.get("es_prep")
        if es_prep is not None:
            df, queries, q_uniques = es_prep
        else:
            df, queries, q_uniques = _numbered_frame(ranking)
            if early_stopping is not None:
                # warm ES calls (alpha sweeps, re-evaluation) reuse the
                # prepared frame: the plan is keyed on the ranking's frame
                plan["es_prep"] = (df, queries, q_uniques)
        query_vectors = self.encode_queries(queries)
        whole = batch_size is None or batch_size >= len(queries)

        if early_stopping is None and whole:
            plan["queries"] = queries
            plan["q_uniques"] = q_uniques
            out = self._score_and_sort(df, query_vectors, q_uniques, score_dtype, plan=plan)
            if out is not None:
                LOGGER.info("computed scores in %s seconds", perf_counter() - t0)
                return out

        if early_stopping is not None and whole:
            take, ff = self._early_stopping(
                df, query_vectors, early_stopping, early_stopping_alpha,
                early_stopping_depths, plan=plan,
            )
            out = self._assemble_es(df, take, ff, q_uniques, score_dtype, plan)
            LOGGER.info("computed scores in %s seconds", perf_counter() - t0)
            return out

        def _get_result(frame: pd.DataFrame) -> pd.DataFrame:
            if early_stopping is None:
                return frame.assign(ff_score=self._compute_scores(frame, query_vectors))
            # the ES state is frame-aligned: never plan-cached for a batch
            take, ff = self._early_stopping(
                frame, query_vectors, early_stopping, early_stopping_alpha,
                early_stopping_depths, plan=None,
            )
            return frame.iloc[take].assign(ff_score=ff)

        if whole:
            result = _get_result(df)
        else:
            result = pd.concat(
                [
                    _get_result(df[(df["q_no"] >= start) & (df["q_no"] < start + batch_size)])
                    for start in range(0, len(queries), batch_size)
                ]
            )
        result["score"] = result["ff_score"]

        # order rows by (q_id desc, score desc) with an integer lexsort over
        # query codes instead of a string sort
        order = np.lexsort(
            (
                -result["score"].to_numpy(dtype=np.float64),
                _query_ranks(q_uniques)[result["q_no"].to_numpy()],
            )
        )
        LOGGER.info("computed scores in %s seconds", perf_counter() - t0)
        return Ranking(
            result.iloc[order], name="fast-forward", dtype=score_dtype, copy=False, is_sorted=True
        )

    def submit(self, ranking: Ranking) -> ScoreFuture:
        """Launch scoring for a ranking and return a future (pipelined
        serving).

        The query encode and the device work happen now; the score fetch
        and the result assembly run inside ``future.result()``, so
        back-to-back submits overlap call *i+1*'s encode and device work
        with call *i*'s fetch::

            pending = None
            for r in rankings:
                fut = index.submit(r)
                if pending is not None:
                    results.append(pending.result())
                pending = fut
            results.append(pending.result())

        Rankings outside the deferred fast path (documents with more than
        ``_MAX_GROUP_K`` passages) are scored eagerly here; the future then
        hands back the finished ranking (``future.pipelined`` is ``False``).

        :param ranking: The ranking (queries must be attached).
        :raises ValueError: When the ranking has no queries attached.
        :raises IndexError: When an ID is missing from the index.
        :return: A :class:`ScoreFuture` whose ``result()`` is the scored
            ranking (identical to ``self(ranking)``).
        """
        if not ranking.has_queries:
            raise ValueError("Input ranking has no queries attached.")
        score_dtype = ranking._df.dtypes["score"]
        plan = self._get_plan(ranking)
        if plan.get("ready"):
            query_vectors = self.encode_queries(plan["queries"])
            deferred = self._score_and_sort(
                None, query_vectors, plan["q_uniques"], score_dtype, plan=plan, defer=True
            )
        else:
            df, queries, q_uniques = _numbered_frame(ranking)
            plan["queries"] = queries
            plan["q_uniques"] = q_uniques
            query_vectors = self.encode_queries(queries)
            deferred = self._score_and_sort(
                df, query_vectors, q_uniques, score_dtype, plan=plan, defer=True
            )
        if deferred is None:
            return ScoreFuture(result=self(ranking))
        return ScoreFuture(finish=deferred)

    def serve(
        self,
        ranking: Ranking,
        alpha: float,
        cutoff: int,
        early_stopping_depths: "Iterable[int] | None" = None,
        refine: "int | None" = None,
    ) -> Ranking:
        """One fused production re-rank call: semantic scoring + score
        interpolation + per-query top-``cutoff`` cut.

        Equivalent to ``ranking.interpolate(self(ranking), alpha).cut(cutoff)``
        (reference: interpolation ``ranking.py:293-326``, cut
        ``ranking.py:279-291``), but the interpolation and the top-k run on
        the device, so only ``num_queries x cutoff`` (score, index) pairs
        come back to the host.  Ties at the cutoff go to the candidate that
        comes first in the ranking.  Documents with more than
        ``_MAX_GROUP_K`` passages, and an index without a device table, take
        that unfused flow itself (its scoring still runs on the device).

        With ``early_stopping_depths`` the semantic scores come from the
        early-stopping schedule (cutoff ``cutoff``, alpha ``alpha``) and the
        interpolation covers only the scored subset: a never-scored
        candidate is not surfaced on its lexical score alone.

        With ``refine=margin`` the call runs two-phase: the bf16 ``"fast"``
        tier preselects the top ``cutoff + margin`` candidates per query,
        whose dots are then recomputed in full fp32 on the device before the
        final cut — the returned scores are exact, and a true top-``cutoff``
        candidate is lost only if the bf16 error pushes it below ``margin``
        others.  Only dense tables with one row per pair refine; quantized
        indexes and the document modes serve in their own precision tier.

        :param ranking: The ranking (queries must be attached).
        :param alpha: Interpolation parameter (lexical weight).
        :param cutoff: Top-k depth per query to return.
        :param early_stopping_depths: Optional early-stopping depth schedule.
        :param refine: Optional two-phase margin (see above).
        :raises ValueError: When the ranking has no queries attached.
        :raises ValueError: When the cutoff is not positive.
        :raises ValueError: When ``refine`` is negative.
        :raises IndexError: When an ID is missing from the index.
        :return: The interpolated, cut ranking.
        """
        out = self._serve(ranking, alpha, cutoff, False, early_stopping_depths, refine)
        return out if isinstance(out, Ranking) else out()

    def submit_serve(
        self,
        ranking: Ranking,
        alpha: float,
        cutoff: int,
        early_stopping_depths: "Iterable[int] | None" = None,
        refine: "int | None" = None,
    ) -> ScoreFuture:
        """Pipelined :meth:`serve`: launch now, fetch in ``result()``.

        Early stopping and the unfused flow run eagerly (the future's
        ``pipelined`` is then ``False``).

        :return: A :class:`ScoreFuture` whose ``result()`` equals
            ``self.serve(ranking, alpha, cutoff, early_stopping_depths,
            refine)``.
        """
        out = self._serve(ranking, alpha, cutoff, True, early_stopping_depths, refine)
        if isinstance(out, Ranking):
            return ScoreFuture(result=out)
        return ScoreFuture(finish=out)

    def _serve(
        self,
        ranking: Ranking,
        alpha: float,
        cutoff: int,
        defer: bool,
        early_stopping_depths: "Iterable[int] | None" = None,
        refine: "int | None" = None,
    ) -> "Ranking | Callable[[], Ranking]":
        if not ranking.has_queries:
            raise ValueError("Input ranking has no queries attached.")
        if cutoff < 1:
            raise ValueError("cutoff must be positive.")
        if refine is not None and refine < 0:
            raise ValueError("refine margin must be non-negative.")
        if early_stopping_depths is not None:
            return self._serve_early_stopping(ranking, alpha, cutoff, early_stopping_depths)
        t0 = perf_counter()
        plan = self._get_plan(ranking)
        if plan.get("cand_ready") and plan.get("queries") is not None:
            queries = plan["queries"]
            q_uniques = plan["q_uniques"]
            q_codes = None
        else:
            q_codes, q_uniques = pd.factorize(ranking._df["q_id"], sort=False)
            first = ~ranking._df["q_id"].duplicated()
            queries = ranking._df.loc[first, "query"].tolist()
            plan["queries"] = queries
            plan["q_uniques"] = q_uniques
        query_vectors = self.encode_queries(queries)
        finish = self._serve_fused(
            ranking, query_vectors, q_uniques, q_codes, plan, alpha, cutoff, refine
        )
        if finish is None:
            # the unfused flow (documents with more than _MAX_GROUP_K
            # passages, or no device table)
            out = ranking.interpolate(self(ranking), alpha).cut(cutoff)
            out.name = "fast-forward"
            return out
        if not defer:
            LOGGER.info("served interpolated top-%d in %s seconds", cutoff, perf_counter() - t0)
        return finish

    def _call_queries(
        self, query_vectors: np.ndarray, view: DeviceView, plan: dict
    ) -> torch.Tensor:
        """The device query block of this call (``plan["_call_tok"]``): the
        upload the streamed scoring stamped with it, else a new one (the
        gather-dots upload none)."""
        cached_q = plan.get("q_dev")
        if cached_q is not None and plan.get("q_dev_tok") == plan["_call_tok"]:
            return cached_q[1]
        return _cached_q_upload(
            self._pad_queries(query_vectors, view), plan, "q_dev", view.table.device
        )

    def _serve_early_stopping(
        self, ranking: Ranking, alpha: float, cutoff: int, depths: Iterable[int]
    ) -> Ranking:
        """Early-stopping serve: schedule-scored subset -> interpolate -> cut.

        The interpolation covers only the scored subset (an outer-merge
        ``interpolate`` would give never-scored candidates a semantic score
        of 0) and runs on the host over the ES loop's own ``(take, ff)``
        arrays; the cut happens inside the result sort
        (``_assemble_es(cut=...)``).
        """
        plan = self._get_plan(ranking)
        if "es_prep" not in plan:
            plan["es_prep"] = _numbered_frame(ranking)
        df, queries, q_uniques = plan["es_prep"]
        query_vectors = self.encode_queries(queries)
        take, ff = self._early_stopping(df, query_vectors, cutoff, alpha, depths, plan=plan)
        lex = plan["es_state"]["lex"] if "es_state" in plan else df["score"].to_numpy(np.float32)
        interp = (alpha * lex[take] + (1.0 - alpha) * ff).astype(np.float32)
        return self._assemble_es(
            df, take, interp, q_uniques, ranking._df.dtypes["score"], plan, cut=cutoff
        )

    def _serve_fused(
        self,
        ranking: Ranking,
        query_vectors: np.ndarray,
        q_uniques,
        q_codes: "np.ndarray | None",
        plan: dict,
        alpha: float,
        cutoff: int,
        refine: "int | None" = None,
    ) -> "Callable[[], Ranking] | None":
        """Launch the fused serve program; return the finish callable, or
        ``None`` when the candidates need the unfused flow.

        Static artifacts (candidate arrays, the per-query slot layout, the
        lexical score upload, output id arrays) are plan-cached: warm calls
        pay only encode + device work + the ``(2, Q, cutoff)`` fetch, whose
        copy starts as soon as it is launched.  An index without a device
        table takes the unfused flow.
        """
        if self._device_view() is None:
            # no device table (the host gather): the unfused flow
            return None
        score_dtype = ranking._df.dtypes["score"]
        if plan.get("cand_ready"):
            n_pairs = plan["n_pairs"]
            pair_qno = plan["pair_qno"]
            rows_mat = plan["rows_mat"]
            counts_pp = plan["counts_pp"]
            k = plan["k"]
            view = self._device_view()
        else:
            n_pairs = len(ranking._df)
            pair_qno = q_codes.astype(np.int64)
            prep = self._candidate_arrays(ranking._df)
            if prep is None:
                return None
            view, rows_mat, counts_pp, k = prep
            plan.update(
                n_pairs=n_pairs,
                pair_qno=pair_qno,
                rows_mat=rows_mat,
                counts_pp=counts_pp,
                k=k,
                cand_ready=True,
            )
        device = view.table.device
        # two-phase refine: bf16 preselect + exact rescore of the top
        # (cutoff + margin) per query (fast-tier indexes still get exact
        # final scores) -- dense tables only; quantized tables serve without
        # it, as in fastforward_tpu
        # (single device only: a mesh serves without it, as fastforward_tpu)
        refine_live = refine is not None and k == 1 and view.kind == "dense" and view.mesh is None
        scoring_view = (
            dataclasses.replace(view, precision="fast") if refine_live else view
        )
        # per-call token: the query upload validated during THIS call's
        # scoring stamps itself with it, so the refine tail reuses it
        # without a second content compare
        plan["_call_tok"] = plan.get("_call_tok", 0) + 1
        with annotate("ff.score"):
            scores_dev = self._device_score_grouped(
                scoring_view,
                query_vectors,
                rows_mat,
                pair_qno,
                counts_pp,
                k,
                fetch=False,
                plan=plan,
            )
        scores_dev = self._scores_on(scores_dev, n_pairs, device)
        sv = plan.get("serve")
        if sv is None:
            n_q = len(q_uniques)
            # output query order: q_id descending (the ranking sort
            # convention) — baked into the slot rows so the device result is
            # already in final row order
            by_rank = np.argsort(np.asarray(q_uniques, dtype=object))[::-1].astype(
                np.int64
            )
            slot = _slot_matrix(pair_qno, n_q, by_rank, n_q)
            lex = np.zeros(ops.bucket(n_pairs), dtype=np.float32)
            lex[:n_pairs] = ranking._df["score"].to_numpy(dtype=np.float32)
            sv = {
                "slot": slot,
                "slot_dev": torch.from_numpy(slot).to(device),
                "lex_dev": torch.from_numpy(lex).to(device),
                "qid_arr": ranking._df["q_id"].array,
                "id_arr": ranking._df["id"].array,
                # keep the query column so serve() output has the same
                # schema as the unfused interpolate().cut() flow
                "query_arr": (
                    ranking._df["query"].array
                    if "query" in ranking._df.columns
                    else None
                ),
                "by_rank": by_rank,
            }
            plan["serve"] = sv
        kc = min(cutoff, sv["slot"].shape[1])
        with annotate("ff.serve_tail"):
            if refine_live:
                rows_dev = sv.get("rows_dev")
                if rows_dev is None:
                    rows_pad = np.zeros(ops.bucket(n_pairs), dtype=np.int32)
                    rows_pad[:n_pairs] = rows_mat[:, 0]
                    rows_dev = torch.from_numpy(rows_pad).to(device)
                    sv["rows_dev"] = rows_dev
                    # slot-row -> query-index permutation (slot rows are in
                    # output order, queries in first-appearance order)
                    sv["q_perm_dev"] = torch.from_numpy(sv["by_rank"]).to(device)
                q_dev = self._call_queries(query_vectors, view, plan)
                packed = ops.serve_topk_refine(
                    scores_dev,
                    sv["lex_dev"],
                    sv["slot_dev"],
                    alpha,
                    kc,
                    int(refine),
                    view.table,
                    rows_dev,
                    q_dev,
                    sv["q_perm_dev"],
                )
            else:
                packed = ops.serve_topk(scores_dev, sv["lex_dev"], sv["slot_dev"], alpha, kc)
        # start the (tiny) result copy the moment the device finishes;
        # finish() then only waits
        fetch = ops.fetch_np_async(packed)

        def finish() -> Ranking:
            with annotate("ff.fetch"):
                vals, pair_idx = ops.decode_serve_topk(fetch())
            flat_idx = pair_idx.reshape(-1)
            mask = flat_idx >= 0
            take = flat_idx[mask]
            scores = vals.reshape(-1)[mask]
            cols = {
                "q_id": sv["qid_arr"].take(take),
                "id": sv["id_arr"].take(take),
                "score": scores.astype(score_dtype, copy=False),
            }
            if sv.get("query_arr") is not None:
                cols["query"] = sv["query_arr"].take(take)
            out = pd.DataFrame(cols)
            q_ids = plan.get("q_ids_set")
            if q_ids is None:
                q_ids = set(np.asarray(q_uniques, dtype=object))
                plan["q_ids_set"] = q_ids
            return Ranking._from_trusted_frame(out, "fast-forward", q_ids=q_ids.copy())

        return finish

    # -- array-path serving (BatchingServer) ---------------------------------

    def _serve_prep(self, ranking: Ranking) -> "dict | None":
        """Resolve ONE request into merge-ready arrays (array-path serving).

        :class:`~fastforward_tpu_torch.utils.serving.BatchingServer` calls
        this from its resolver pool as soon as a request is submitted, so
        per-request candidate resolution overlaps the batching wait and the
        merged batch needs no frame concat and no re-resolution.  Returns
        ``None`` when the request cannot take the array path (empty
        ranking, no device table, documents with more than
        ``_MAX_GROUP_K`` passages): the server then serves it through
        :meth:`submit_serve`.
        """
        df = ranking._df
        view = self._device_view() if len(df) else None
        if view is None or _multiprocess(view):
            # several processes must run every call in the same order: the
            # server serves such requests through submit_serve
            return None
        with annotate("ff.prep"):
            prep = self._candidate_arrays(df)
        if prep is None:
            return None
        _view, rows_mat, counts_pp, k = prep
        # query codes from run boundaries: the Ranking ctor sorts frames by
        # (q_id desc, score desc), so each query's pairs are one contiguous
        # run.  A repeated run head means a foreign frame that is not
        # run-contiguous: factorize instead.
        first = _run_heads(df["q_id"])
        uniq_idx = np.flatnonzero(first)
        uniq = df["q_id"].iloc[uniq_idx].to_numpy(dtype=object)
        sorted_codes = True
        if len(uniq) != len(set(uniq)):
            q_codes, q_uniques = pd.factorize(df["q_id"], sort=False)
            pair_qno = q_codes.astype(np.int64)
            uniq = np.asarray(q_uniques, dtype=object)
            sorted_codes = bool((np.diff(pair_qno) >= 0).all())
        else:
            pair_qno = np.cumsum(first, dtype=np.int64) - 1
        q_counts = np.bincount(pair_qno, minlength=len(uniq)).astype(np.int64)
        queries = (
            df["query"].iloc[uniq_idx].tolist()
            if sorted_codes
            else df.loc[~df["q_id"].duplicated(), "query"].tolist()
        )
        return {
            "rows_mat": rows_mat,
            "counts_pp": counts_pp,
            "k": k,
            "pair_qno": pair_qno,
            "sorted": sorted_codes,
            "q_counts": q_counts,
            "lex": df["score"].to_numpy(dtype=np.float32),
            "queries": queries,
            "q_uniques": uniq,
            # per-request output row order: q_id descending (the Ranking
            # sort invariant), baked into the merged slot layout
            "by_rank": np.argsort(uniq)[::-1].astype(np.int64),
            "id_arr": df["id"].array,
            "n_pairs": len(df),
            "score_dtype": df.dtypes["score"],
        }

    def _serve_arrays(
        self,
        preps: "list[dict]",
        alpha: float,
        cutoff: int,
        refine: "int | None" = None,
    ) -> "Callable[[], tuple[np.ndarray, np.ndarray]] | None":
        """Merged array-path serve over per-request :meth:`_serve_prep` dicts.

        Merges the resolved arrays (numpy concats), launches the scoring and
        one serve tail, starts the copy of the packed result and returns a
        zero-arg ``finish() -> (vals, pair_idx)``: row ``q_offset[r] + i``
        holds request ``r``'s ``i``-th output query (its queries in
        ``by_rank``, q_id-descending, order), ``pair_idx`` indexes the merged
        flat pair space (request ``r``'s pairs start at ``pair_offset[r]``,
        ``-1`` marks below-depth padding), and ``vals`` are the interpolated
        top-``cutoff`` scores, descending per row.  The copy is ordered after
        the batch's own work on the stream, so ``finish`` returns only its
        results.  Returns ``None`` when the merged workload cannot run
        through the array path (the caller then serves per request).
        """
        view = self._device_view()
        if view is None or _multiprocess(view):
            return None
        device = view.table.device
        k = max(p["k"] for p in preps)
        n_pairs = sum(p["n_pairs"] for p in preps)
        rows_parts = [
            p["rows_mat"] if p["k"] == k else np.pad(p["rows_mat"], ((0, 0), (0, k - p["k"])))
            for p in preps
        ]
        rows_mat = rows_parts[0] if len(rows_parts) == 1 else np.concatenate(rows_parts)
        counts_pp = np.concatenate([p["counts_pp"] for p in preps])
        lex = np.concatenate([p["lex"] for p in preps])
        q_offs = np.zeros(len(preps) + 1, dtype=np.int64)
        q_offs[1:] = np.cumsum([len(p["q_uniques"]) for p in preps])
        n_q = int(q_offs[-1])
        pair_qno = np.concatenate([p["pair_qno"] + off for p, off in zip(preps, q_offs)])
        query_vectors = self.encode_queries([q for p in preps for q in p["queries"]])

        refine_live = refine is not None and view.kind == "dense" and k == 1 and view.mesh is None
        scoring_view = dataclasses.replace(view, precision="fast") if refine_live else view
        # a plan of the batch's own: concurrent batches share nothing
        plan: dict = {"_call_tok": 1}
        with annotate("ff.score"):
            scores_dev = self._device_score_grouped(
                scoring_view, query_vectors, rows_mat, pair_qno, counts_pp, k,
                fetch=False, plan=plan,
            )
        scores_dev = self._scores_on(scores_dev, n_pairs, device)

        # slot rows padded to a power of two too: stable shapes across
        # batches with varying request mixes
        n_rows = 1 << max(3, (n_q - 1).bit_length())
        perm = np.concatenate([p["by_rank"] + off for p, off in zip(preps, q_offs)])
        lex_pad = np.zeros(ops.bucket(n_pairs), dtype=np.float32)
        lex_pad[:n_pairs] = lex
        lex_dev = torch.from_numpy(lex_pad).to(device)
        if all(p["sorted"] for p in preps):
            # contiguous per-query pair ranges (every Ranking-sorted frame):
            # two (n_rows,) vectors go up and the device builds the slots
            counts_q = np.concatenate([p["q_counts"] for p in preps])
            d_max = 1 << max(3, (int(counts_q.max()) - 1).bit_length())
            starts_q = np.zeros(n_q, dtype=np.int64)
            np.cumsum(counts_q[:-1], out=starts_q[1:])
            starts_perm = np.zeros(n_rows, dtype=np.int32)
            starts_perm[:n_q] = starts_q[perm]
            counts_perm = np.zeros(n_rows, dtype=np.int32)
            counts_perm[:n_q] = counts_q[perm]
            seg = (torch.from_numpy(starts_perm).to(device), torch.from_numpy(counts_perm).to(device))
            slot_dev = None
        else:  # a foreign frame whose queries are not contiguous
            slot = _slot_matrix(pair_qno, n_q, perm, n_rows)
            d_max = slot.shape[1]
            seg = None
            slot_dev = torch.from_numpy(slot).to(device)
        kc = min(cutoff, d_max)
        with annotate("ff.serve_tail"):
            if refine_live:
                rows_pad = np.zeros(ops.bucket(n_pairs), dtype=np.int32)
                rows_pad[:n_pairs] = rows_mat[:, 0]
                q_perm = np.zeros(n_rows, dtype=np.int32)
                q_perm[:n_q] = perm.astype(np.int32)
                q_dev = self._call_queries(query_vectors, view, plan)
                rows_dev = torch.from_numpy(rows_pad).to(device)
                q_perm_dev = torch.from_numpy(q_perm).to(device)
                if seg is not None:
                    packed = ops.serve_topk_refine_seg(
                        scores_dev, lex_dev, *seg, alpha, kc, int(refine), d_max,
                        view.table, rows_dev, q_dev, q_perm_dev,
                    )
                else:
                    packed = ops.serve_topk_refine(
                        scores_dev, lex_dev, slot_dev, alpha, kc, int(refine),
                        view.table, rows_dev, q_dev, q_perm_dev,
                    )
            elif seg is not None:
                packed = ops.serve_topk_seg(scores_dev, lex_dev, *seg, alpha, kc, d_max)
            else:
                packed = ops.serve_topk(scores_dev, lex_dev, slot_dev, alpha, kc)
        # the copy starts now, on the stream that ran this batch's work
        fetch = ops.fetch_np_async(packed)

        def finish() -> "tuple[np.ndarray, np.ndarray]":
            with annotate("ff.fetch"):
                return ops.decode_serve_topk(fetch())

        return finish
