"""Scoring ops on the re-rank and serve path: candidate layout, kernels, top-k.

The port of the ``fastforward_tpu/ops/scoring.py`` single-device subset.
Dense candidate sets stream through the kernels (:func:`streamed_scores`:
K1 or K2 for fp32/bf16/int8 tables; :func:`streamed_scores_pq`: K3 or K4
for PQ codes; both fuse the slot gather and the document modes' K-reduce
after the kernel); sparse or ungrouped sets take the plain gather-dots
:func:`score_pairs_bounded`, :func:`score_pairs_grouped` and
:func:`score_pairs_grouped_pq`; ragged documents take the flat layout's
:func:`score_pairs_dense` and :func:`score_pairs_pq` with a segment
reduce; the fused serve tail interpolates and cuts per query
(:func:`serve_topk`, :func:`serve_topk_refine`, and their ``_seg`` forms,
which build the slot matrix on the device); :func:`encode_scores_u16`
packs the per-pair scores into 16-bit codes for the host copy.  Everything
runs on the
device of the table; the hand-written kernel runs for CUDA tensors, its
plain version for CPU tensors, and nothing falls back from one to the
other.

No matmul appears on the exact path: every fp32 dot is an elementwise
multiply and an fp32 sum, so TF32 settings cannot change a result.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from fastforward_tpu_torch.ops import _build, stream_kernel, stream_kernel_pq
from fastforward_tpu_torch.utils.tracing import annotate

_BUCKET_MIN = 256

#: Chunks the per-call score fetch is split into, so the device->host copy
#: overlaps with the per-chunk result ordering on the host.
FETCH_CHUNKS = 8

#: Below this many elements one copy is cheaper than chunked copies.
_FETCH_CHUNK_MIN = 1 << 17

#: candidate sets denser than one pair per this many table rows stream
#: through K1/K2; sparser ones take the gather-dot (``index/base.py:1277``)
STREAM_DENSITY = 500

#: the same for PQ code tables, whose rows are M bytes: streaming pays off
#: at lower density (``index/base.py:1282-1286``)
STREAM_DENSITY_PQ = 200

#: bound on the ``(queries, M, Ks, Ds)`` product block of the PQ LUT
_LUT_ELEMS = 1 << 26


def bucket(n: int) -> int:
    """Round up to the next power of two (>= 256)."""
    return max(_BUCKET_MIN, 1 << max(0, int(n - 1)).bit_length())


def pad_i32(arr: np.ndarray, size: int, fill: int) -> np.ndarray:
    """Pad a 1-d int array to ``size`` with ``fill``."""
    out = np.full((size,), fill, dtype=np.int32)
    out[: arr.shape[0]] = arr
    return out


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to bf16 (nearest even), kept in fp32."""
    return x.to(torch.bfloat16).float()


# -- host transfers ----------------------------------------------------------


def fetch_np(arr: "torch.Tensor | np.ndarray") -> np.ndarray:
    """Copy a tensor to a host numpy array (waits for the device); host
    arrays pass through.  A row-sharded table is gathered whole from every
    process (``parallel.multihost.fetch_np``); the port's scores are whole
    tensors on each process, so their fetch needs no collective."""
    if isinstance(arr, np.ndarray):
        return arr
    if not isinstance(arr, torch.Tensor):
        from fastforward_tpu_torch.parallel import multihost

        return multihost.fetch_np(arr)
    return arr.detach().cpu().numpy()


def fetch_np_async(arr: torch.Tensor):
    """Start the device->host copy of ``arr`` now; return a zero-arg callable
    that waits for it and returns the numpy array.

    On the card the copy goes into pinned memory on the current stream and a
    CUDA event marks its end, so the wait covers only this copy.
    """
    if arr.device.type != "cuda":
        host = arr.detach()
        return lambda: host.numpy()
    host = torch.empty(arr.shape, dtype=arr.dtype, pin_memory=True)
    host.copy_(arr, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def wait() -> np.ndarray:
        done.synchronize()
        return host.numpy()

    return wait


def fetch_np_overlapped(
    arr: torch.Tensor, on_chunk=None, chunks: int | None = None, out: np.ndarray | None = None
) -> np.ndarray:
    """Fetch a 1-d tensor, overlapping the copy with host work.

    The copy is split into ``chunks`` chunks (``FETCH_CHUNKS`` by default)
    whose copies all start at once (one pinned buffer, current stream, one
    event per chunk); ``on_chunk(lo, hi)`` runs as soon as rows ``[lo, hi)``
    have landed in ``out`` (allocated here unless passed in), while later
    chunks are still in flight.  ``chunks <= 1``, fewer than
    ``_FETCH_CHUNK_MIN`` rows, or a CPU tensor take one copy.
    """
    if chunks is None:
        chunks = FETCH_CHUNKS
    n = int(arr.shape[0])
    if out is None:
        out = np.empty(n, dtype=torch.empty(0, dtype=arr.dtype).numpy().dtype)
    if arr.device.type != "cuda":
        out[:n] = arr.detach().numpy()
        if on_chunk is not None and n:
            on_chunk(0, n)
        return out
    if chunks <= 1 or n < _FETCH_CHUNK_MIN:
        chunks = 1
    step = max(1, -(-n // chunks))
    bounds = [(lo, min(lo + step, n)) for lo in range(0, n, step)]
    host = torch.empty(n, dtype=arr.dtype, pin_memory=True)
    events = []
    for lo, hi in bounds:
        host[lo:hi].copy_(arr[lo:hi], non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        events.append(ev)
    host_np = host.numpy()
    for (lo, hi), ev in zip(bounds, events):
        ev.synchronize()
        out[lo:hi] = host_np[lo:hi]
        if on_chunk is not None:
            on_chunk(lo, hi)
    return out


# -- the u16 score transport ---------------------------------------------------


def encode_scores_u16(scores: torch.Tensor) -> torch.Tensor:
    """Affine-quantize fp32 scores to 16-bit codes for the host copy.

    Calibration is per call over the finite entries (``-inf`` padding of
    the document modes' K-reduce encodes as 0 and is never read back):
    ``scale = max(max - min, 1e-30) / 65535``, codes ``round((s - min) /
    scale)`` (half to even) clipped to ``[0, 65535]``.  The ``[min,
    scale]`` header rides in front as 4 lanes, each fp32 split into its low
    and high 16 bits, so one copy carries both.  The error of a decoded
    score is at most ``(max - min) / 131070`` plus fp32 rounding.  The
    buffer is ``int16`` (CUDA's ``uint16`` support is partial): the host
    reads it as ``uint16`` (:func:`decode_scores_u16`).

    :param scores: Per-pair scores, ``(S,)`` fp32 (may hold ``-inf``).
    :return: ``(4 + S,)`` int16 holding the uint16 header and codes;
        ``score ~= min + scale * code``.
    """
    finite = torch.isfinite(scores)
    big = torch.tensor(3.4e38, dtype=torch.float32, device=scores.device)
    mn = torch.where(finite, scores, big).min()
    mx = torch.where(finite, scores, -big).max()
    scale = torch.clamp(mx - mn, min=1e-30) / 65535.0
    codes = torch.round((scores - mn) / scale)
    codes = torch.where(finite, codes, 0.0).clamp(0.0, 65535.0).to(torch.int32)
    # the header's halves from the fp32 bits, masked in int64 (no unsigned
    # 32-bit type on the card)
    bits = torch.stack([mn, scale]).view(torch.int32).long() & 0xFFFFFFFF
    header = torch.stack([bits[0] & 0xFFFF, bits[0] >> 16, bits[1] & 0xFFFF, bits[1] >> 16])
    packed = torch.cat([header.to(torch.int32), codes])
    # uint16 bit patterns as int16: values past 32767 wrap explicitly
    return torch.where(packed > 32767, packed - 65536, packed).to(torch.int16)


def decode_u16_header(raw4: np.ndarray) -> tuple[float, float]:
    """Reassemble the ``[min, scale]`` floats from the 4 header lanes
    (``uint16``, or the ``int16`` buffer :func:`encode_scores_u16` ships)."""
    u = np.asarray(raw4).view(np.uint16).astype(np.uint32)
    mn = np.array([u[0] | (u[1] << 16)], dtype=np.uint32).view(np.float32)[0]
    scale = np.array([u[2] | (u[3] << 16)], dtype=np.uint32).view(np.float32)[0]
    return float(mn), float(scale)


def decode_scores_u16(packed: np.ndarray) -> np.ndarray:
    """One-shot host decode of a fetched :func:`encode_scores_u16` buffer."""
    mn, scale = decode_u16_header(packed[:4])
    out = np.asarray(packed[4:]).view(np.uint16).astype(np.float32)
    out *= scale
    out += mn
    return out


def _cached_q_upload(
    q_host: np.ndarray, plan: dict | None, key: str, device: torch.device
) -> torch.Tensor:
    """Device copy of the query block, reused across calls when unchanged.

    Re-ranking the same run re-encodes the same queries to identical
    vectors; a host compare then saves the per-call upload.  The cache entry
    is stamped with the plan's call token, so a later phase of the same call
    can reuse it without comparing again.
    """
    cached = plan.get(key) if plan is not None else None
    if cached is not None and np.array_equal(cached[0], q_host):
        q_dev = cached[1]
    else:
        q_dev = torch.from_numpy(np.ascontiguousarray(q_host, dtype=np.float32)).to(device)
        if plan is not None:
            plan[key] = (q_host, q_dev)
    if plan is not None:
        plan[key + "_tok"] = plan.get("_call_tok")
    return q_dev


# -- streamed scoring (K1-K4) -------------------------------------------------

#: the kernels each device-view kind can stream through (``stream_select_auto``
#: sends 2D tables to K1, int8 codes to K1 or K2 by cap, PQ codes to K3 or
#: K4 by cap)
VIEW_KERNELS = {
    "dense": ("stream_select_pairwise",),
    "scalar": ("stream_select_pairwise", "stream_select"),
    "pq": ("stream_select_pq_pairwise", "stream_select_pq"),
}


def load_kernels(kind: str) -> None:
    """Build (one ``nvcc`` per source, all at once) and load the kernels a
    device view of ``kind`` can stream through, so that no scoring call
    pays for it."""
    names = VIEW_KERNELS[kind]
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.load_kernel, names))



def _adaptive_cap(p: int, num_tiles: int) -> int:
    """Slot capacity matched to the mean candidates per tile (128..1024).

    Small caps waste less padding on sparse tiles; skewed tiles spill into
    extra virtual tiles either way.
    """
    mean = max(1, p // max(1, num_tiles))
    return min(1024, max(128, 1 << (mean - 1).bit_length()))


def build_streamed_layout(
    rows: np.ndarray,
    qno: np.ndarray,
    n_pad: int,
    qb: int,
    r: int = stream_kernel.KERNEL_TILE_ROWS,
    cap: int = stream_kernel.KERNEL_CAP,
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Bucket candidates into the kernel's (virtual tile, slot) grid.

    Returns ``(cand, tile_idx, slot_of_pair)``: ``cand`` is ``(Tv, cap)``
    int32 packing ``local_row * qb + qno`` (padding slots ``qb - 1``, i.e.
    local row 0 and query ``qb - 1``), ``tile_idx`` the base tile of each
    virtual tile, and ``slot_of_pair`` each pair's flat output slot.
    ``Tv`` is a power of two (>= 8).  ``None`` when the layout does not
    apply (packing overflow, or no pairs).

    :param rows: Table row per pair, ``(P,)``.
    :param qno: Query per pair, ``(P,)``.
    :param n_pad: Padded table rows (multiple of ``r``).
    :param qb: Padded query count (pack modulus).
    :param r: Rows per table tile.
    :param cap: Candidate slots per virtual tile.
    """
    if qb * r > 2**31 - 1 or n_pad % r != 0:
        return None
    num_tiles = n_pad // r
    p = rows.shape[0]
    if p == 0:
        return None

    # single-pass native builder (no sorting); numpy below when it is absent
    from fastforward_tpu_torch.runtime.idmap import native_stream_layout

    native = native_stream_layout(rows, qno, n_pad, qb, r, cap, qb - 1)
    if native is not None:
        return native

    tile_of = rows // r
    order = np.argsort(tile_of, kind="stable")
    counts = np.bincount(tile_of[order], minlength=num_tiles)
    starts = np.zeros(num_tiles + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])

    vt_per_tile = -(-counts // cap)  # ceil; 0 for empty tiles
    vt_base = np.zeros(num_tiles + 1, dtype=np.int64)
    np.cumsum(vt_per_tile, out=vt_base[1:])
    t_virtual = int(vt_base[-1])
    if t_virtual == 0:
        return None
    t_bucket = max(8, 1 << (t_virtual - 1).bit_length())

    within = np.arange(p, dtype=np.int64) - starts[tile_of[order]]
    vtile = vt_base[tile_of[order]] + within // cap
    slot = within % cap

    pad_value = qb - 1  # local row 0, padding query
    cand = np.full((t_bucket, cap), pad_value, dtype=np.int32)
    local = (rows[order] - tile_of[order] * r).astype(np.int64)
    cand[vtile, slot] = (local * qb + qno[order]).astype(np.int32)

    tile_idx = np.zeros(t_bucket, dtype=np.int32)
    tile_idx[:t_virtual] = np.repeat(np.arange(num_tiles, dtype=np.int32), vt_per_tile)

    slot_of_pair = np.empty(p, dtype=np.int64)
    slot_of_pair[order] = vtile * cap + slot
    return cand, tile_idx, slot_of_pair


def _cached_layout(
    key: str,
    n_pad: int,
    q_pad: np.ndarray,
    rows: "np.ndarray | None",
    qno: "np.ndarray | None",
    r: int,
    plan: dict | None,
    device: torch.device,
) -> "tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None":
    """The streamed layout's device grid ``(cand3, tile_idx, slot_of_pair)``,
    built once and kept in ``plan[key]`` (``rows`` and ``qno`` may then be
    ``None``); ``None`` when no layout applies."""
    cached = plan.get(key) if plan is not None else None
    if cached is None:
        cap = _adaptive_cap(rows.shape[0], n_pad // r)
        with annotate("ff.layout"):
            layout = build_streamed_layout(rows, qno, n_pad, q_pad.shape[0], r=r, cap=cap)
        if layout is None:
            return None
        cand, tile_idx, slot_of_pair = layout
        cached = (
            torch.from_numpy(cand.reshape(cand.shape[0], cap // 128, 128)).to(device),
            torch.from_numpy(tile_idx).to(device),
            torch.from_numpy(slot_of_pair).to(device),
        )
        if plan is not None:
            plan[key] = cached
    return cached


def _pick_slots(outs, slot_dev, reduce, fetch):
    """Each pair's slot score in input order (+ the optional K reduce)."""
    picked = torch.take(outs, slot_dev)
    if reduce is not None:
        op, k, counts = reduce
        picked = _masked_reduce(picked.view(-1, k), counts.to(picked.device), op)
    return picked if not fetch else fetch_np(picked)


def _finalize_streamed(
    outs: torch.Tensor,
    slot_of_pair: np.ndarray,
    reduce: "tuple | None",
    plan: "dict | None",
    key: str,
    seg_reduce: "tuple | None" = None,
    fetch: bool = True,
) -> "np.ndarray | torch.Tensor":
    """The slot gather over concatenated kernel outputs (the sharded
    layouts' ``(shards * Tv * cap,)``) on their device, with the K-reduce
    (``reduce=(op, k, counts)``) or, for a ragged layout, the segment
    reduce (``seg_reduce=(op, seg, n_out)``); the slot indices (and the
    segments) stay on the device in ``plan[key]``."""
    slot_dev = plan.get(key) if plan is not None else None
    if slot_dev is None:
        slot_dev = torch.from_numpy(np.ascontiguousarray(slot_of_pair, dtype=np.int64)).to(outs.device)
        if plan is not None:
            plan[key] = slot_dev
    if seg_reduce is None:
        return _pick_slots(outs, slot_dev, reduce, fetch)
    op, seg, n_out = seg_reduce
    seg_dev = plan.get(key + "_seg") if plan is not None else None
    if seg_dev is None:
        seg_dev = torch.from_numpy(np.ascontiguousarray(seg, dtype=np.int64)).to(outs.device)
        if plan is not None:
            plan[key + "_seg"] = seg_dev
    red = _segment_reduce(torch.take(outs, slot_dev), seg_dev, n_out, op)
    return red if not fetch else fetch_np(red)


def streamed_scores(
    table: torch.Tensor,
    q_pad: np.ndarray,
    rows: "np.ndarray | None",
    qno: "np.ndarray | None",
    precision: str = "exact",
    plan: dict | None = None,
    reduce: "tuple[str, int, torch.Tensor] | None" = None,
    fetch: bool = True,
) -> "np.ndarray | torch.Tensor | None":
    """Score ``table[rows[i]] . q_pad[qno[i]]`` through K1 or K2.

    Builds the candidate layout (cached in ``plan`` with its device grid),
    launches the kernel that ``stream_select_auto`` picks over every virtual
    tile (K1 for 2D tables and for int8 tables at ``cap <= r``, K2 for int8
    tables at ``cap > r``) and gathers each pair's slot on the device.  With
    ``reduce=(op, k, counts)`` the rows are a flattened ``(P, K)`` grouped
    layout reduced along K on the device.  ``rows`` and ``qno`` may be
    ``None`` when ``plan`` already holds the layout.

    :param table: ``(N_pad, dim)`` fp32/bf16, or int8 ``(N_pad, dim/128,
        128)`` codes (scales folded into ``q_pad``).
    :return: Per-pair scores in input order (numpy, or the device tensor with
        ``fetch=False``), or ``None`` when the layout does not apply.
    """
    r = stream_kernel.KERNEL_TILE_ROWS
    cached = _cached_layout("stream", table.shape[0], q_pad, rows, qno, r, plan, table.device)
    if cached is None:
        return None
    cand_dev, tile_dev, slot_dev = cached
    q_dev = _cached_q_upload(q_pad, plan, "q_dev", table.device)
    # the transposed view of the row-major query block: K2 reads it as
    # q^T, K1 gets the block itself back
    outs = stream_kernel.stream_select_auto(
        table, q_dev.t(), cand_dev, tile_dev, r=r, precision=precision
    )
    return _pick_slots(outs, slot_dev, reduce, fetch)


def streamed_scores_pq(
    codes: torch.Tensor,
    codebooks: torch.Tensor,
    q_pad: np.ndarray,
    rows: "np.ndarray | None",
    qno: "np.ndarray | None",
    precision: str = "exact",
    plan: dict | None = None,
    reduce: "tuple[str, int, torch.Tensor] | None" = None,
    fetch: bool = True,
) -> "np.ndarray | torch.Tensor | None":
    """ADC-score ``codes[rows[i]]`` against ``q_pad[qno[i]]`` through K3 or K4.

    The same layout (at ``r = 512``), plan cache, slot gather and optional K
    reduce as :func:`streamed_scores`; ``stream_select_pq_auto`` picks K3 at
    ``cap <= r`` and K4 at ``cap > r``.  Scores are decode-then-dot values
    (OPQ queries arrive rotated).

    :param codes: PQ codes, ``(N_pad, M)`` uint8, uint16 or uint32.
    :param codebooks: ``(M, Ks, Ds)`` fp32.
    :return: As :func:`streamed_scores`.
    """
    r = stream_kernel_pq.KERNEL_PQ_TILE_ROWS
    cached = _cached_layout("stream_pq", codes.shape[0], q_pad, rows, qno, r, plan, codes.device)
    if cached is None:
        return None
    cand_dev, tile_dev, slot_dev = cached
    q_dev = _cached_q_upload(q_pad, plan, "q_dev", codes.device)
    outs = stream_kernel_pq.stream_select_pq_auto(
        codes, codebooks, q_dev.t(), cand_dev, tile_dev, r=r, precision=precision
    )
    return _pick_slots(outs, slot_dev, reduce, fetch)


def _segment_reduce(
    row_scores: torch.Tensor, seg: torch.Tensor, num_out: int, op: str
) -> torch.Tensor:
    """Reduce per-row scores into per-pair scores (the flat layout).

    Padding rows carry ``seg == num_out`` (a sentinel slot that is dropped);
    a pair with no rows gets ``-inf`` under ``"max"`` and 0 otherwise.
    """
    n = num_out + 1
    seg = seg.long()
    if op == "max":
        out = torch.full((n,), -torch.inf, dtype=torch.float32, device=row_scores.device)
        out = out.scatter_reduce(0, seg, row_scores, "amax")
    else:
        out = torch.zeros(n, dtype=torch.float32, device=row_scores.device)
        out.index_add_(0, seg, row_scores)
        if op == "mean":
            counts = torch.zeros_like(out).index_add_(0, seg, torch.ones_like(row_scores))
            out = out / counts.clamp(min=1.0)
    return out[:num_out]


def host_segment_reduce(
    scores: np.ndarray, seg: np.ndarray, n_out: int, op: str
) -> np.ndarray:
    """Numpy segment reduction (``max``/``sum``): the host twin of
    :func:`_segment_reduce` for already-fetched per-row scores."""
    if op == "max":
        out = np.full(n_out, -np.inf, dtype=np.float32)
        np.maximum.at(out, seg, scores)
        return out
    out = np.zeros(n_out, dtype=np.float64)
    np.add.at(out, seg, scores)
    return out.astype(np.float32)


def masked_reduce_host(mat: np.ndarray, counts: np.ndarray, op: str) -> np.ndarray:
    """Numpy twin of :func:`_masked_reduce` for host-side K reductions."""
    k = mat.shape[1]
    if op == "first" or k == 1:
        return mat[:, 0]
    valid = np.arange(k)[None, :] < counts[:, None]
    if op == "max":
        return np.where(valid, mat, np.float32(-np.inf)).max(axis=1)
    sums = np.where(valid, mat, np.float32(0.0)).sum(axis=1)
    return (sums / np.maximum(counts, 1)).astype(np.float32)


def _masked_reduce(scores: torch.Tensor, counts: torch.Tensor, op: str) -> torch.Tensor:
    """Reduce ``(S, K)`` scores along K, honoring per-pair counts."""
    k = scores.shape[1]
    if op == "first" or k == 1:
        return scores[:, 0]
    valid = torch.arange(k, device=scores.device)[None, :] < counts[:, None]
    if op == "max":
        return torch.where(valid, scores, -torch.inf).amax(dim=1)
    total = torch.where(valid, scores, 0.0).sum(dim=1)
    return total / counts.clamp(min=1).float()


# -- sparse candidate sets: plain gather-dot ---------------------------------


def score_pairs_bounded(
    table: torch.Tensor,
    qvecs: torch.Tensor,
    rows: torch.Tensor,
    bounds: torch.Tensor,
    precision: str = "exact",
) -> torch.Tensor:
    """Single-row-per-pair scoring with boundary-encoded query assignment.

    Pairs arrive grouped by query, so the query of pair ``i`` is recovered
    on the device from the cumulative per-query pair counts
    (``qno[i] = searchsorted(bounds, i, 'right')``) and only the row array is
    uploaded.  The dot is an elementwise multiply and an fp32 sum; the
    ``"fast"`` tier rounds both operands to bf16 first, as the TPU did.

    :param table: Embedding table, ``(N, dim)`` or int8 codes ``(N,
        dim/128, 128)``.
    :param qvecs: Query vectors, ``(Q, dim)`` fp32.
    :param rows: Table row per pair, ``(S,)`` int32.
    :param bounds: Cumulative pair counts per query (padded with ``S``),
        ``(Q,)`` int32.
    :param precision: ``"exact"``, ``"high"`` or ``"fast"``.
    :return: Per-pair scores, ``(S,)`` fp32.
    """
    iota = torch.arange(rows.shape[0], device=rows.device, dtype=torch.int32)
    qno = torch.searchsorted(bounds, iota, right=True).clamp(0, qvecs.shape[0] - 1)
    return _gathered_dots(table, qvecs, rows, qno, precision)


def _gathered_dots(
    table: torch.Tensor,
    qvecs: torch.Tensor,
    rows: torch.Tensor,
    qno: torch.Tensor,
    precision: str,
) -> torch.Tensor:
    """``table[rows[i]] . qvecs[qno[i]]`` per row as an elementwise multiply
    and an fp32 sum (bf16-rounded operands for ``"fast"``), in chunks that
    bound the gathered temporaries."""
    out = torch.empty(rows.shape[0], dtype=torch.float32, device=table.device)
    step = stream_kernel._PLAIN_CHUNK_SLOTS
    for lo in range(0, rows.shape[0], step):
        d = table[rows[lo : lo + step].long()].reshape(-1, qvecs.shape[1]).float()
        q = qvecs[qno[lo : lo + step].long()].float()
        if precision == "fast":
            d, q = _round_bf16(d), _round_bf16(q)
        out[lo : lo + step] = (d * q).sum(-1)
    return out


def score_pairs_grouped(
    table: torch.Tensor,
    qvecs: torch.Tensor,
    idx: torch.Tensor,
    op: str,
    precision: str = "exact",
) -> torch.Tensor:
    """Scoring over the dense ``(pairs, K)`` candidate layout (sparse or
    ungrouped candidate sets).

    Each (query, doc) pair scores up to ``K`` rows; the ranking ``Mode``
    becomes the masked reduction along K (max / mean / first).

    :param table: Embedding table, ``(N, dim)`` or int8 codes ``(N,
        dim/128, 128)``.
    :param qvecs: Query vectors, ``(Q, dim)`` fp32.
    :param idx: Stacked int32 ``(K + 1, S)``: the row matrix (first ``K``
        rows, transposed) and a packed last row ``qno * 256 + counts``
        (counts <= 255; 0 for padding pairs).
    :param op: ``"max"`` | ``"mean"`` | ``"first"``.
    :param precision: ``"exact"``, ``"high"`` or ``"fast"``.
    :return: Per-pair scores, ``(S,)`` fp32.
    """
    k = idx.shape[0] - 1
    s = idx.shape[1]
    qno = idx[k] >> 8
    row_scores = _gathered_dots(
        table, qvecs, idx[:k].T.reshape(-1), qno.repeat_interleave(k), precision
    )
    return _masked_reduce(row_scores.view(s, k), idx[k] & 0xFF, op)


def score_pairs_dense(
    table: torch.Tensor,
    qvecs: torch.Tensor,
    idx: torch.Tensor,
    num_out: int,
    op: str,
    precision: str = "exact",
) -> torch.Tensor:
    """Score (query, doc) pairs over the flat per-row layout (ragged
    documents, or more queries than the grouped packing holds).

    :param table: Embedding table, ``(N, dim)`` or int8 codes ``(N,
        dim/128, 128)``.
    :param qvecs: Query vectors, ``(Q, dim)`` fp32.
    :param idx: Stacked int32 ``(3, P)``: table row, query row and output
        pair per candidate row (padding rows carry ``num_out``).
    :param num_out: Number of output pairs.
    :param op: ``"max"`` | ``"mean"`` | ``"sum"``.
    :param precision: ``"exact"``, ``"high"`` or ``"fast"``.
    :return: Per-pair scores, ``(num_out,)`` fp32.
    """
    row_scores = _gathered_dots(table, qvecs, idx[0], idx[1], precision)
    return _segment_reduce(row_scores, idx[2], num_out, op)


def pq_lut(qvecs: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Per-query ADC lookup tables ``lut[q, m, k] = q_m . codeword[m, k]``.

    An elementwise product and an fp32 sum over ``Ds``, chunked over
    queries: no matmul, so no TF32 (``fastforward_tpu`` runs this
    contraction at ``HIGHEST``).

    :param qvecs: ``(Q, M * Ds)`` fp32.
    :param codebooks: ``(M, Ks, Ds)`` fp32.
    :return: ``(Q, M, Ks)`` fp32.
    """
    num_q = qvecs.shape[0]
    m, ks, ds = codebooks.shape
    qsub = qvecs.float().reshape(num_q, m, 1, ds)
    cb = codebooks.float()[None]
    lut = torch.empty((num_q, m, ks), dtype=torch.float32, device=qvecs.device)
    step = max(1, _LUT_ELEMS // (m * ks * ds))
    for lo in range(0, num_q, step):
        lut[lo : lo + step] = (qsub[lo : lo + step] * cb).sum(-1)
    return lut


def score_pairs_grouped_pq(
    codes: torch.Tensor,
    codebooks: torch.Tensor,
    qvecs: torch.Tensor,
    idx: torch.Tensor,
    op: str,
) -> torch.Tensor:
    """Grouped-layout ADC scoring against PQ codes (sparse candidate sets).

    Each pair's score is the sum over subspaces of its query's LUT entry
    at the row's code (:func:`pq_lut`), then the mode's masked reduce along
    the K axis.

    :param codes: PQ codes, ``(N, M)``.
    :param codebooks: Codebooks, ``(M, Ks, Ds)`` fp32.
    :param qvecs: (OPQ-rotated) query vectors, ``(Q, M * Ds)`` fp32.
    :param idx: Stacked int32 ``(K + 1, S)``: the row matrix (first ``K``
        rows, transposed) and a packed last row ``qno * 256 + counts``.
    :param op: ``"max"`` | ``"mean"`` | ``"first"``.
    :return: Per-pair scores, ``(S,)`` fp32.
    """
    k = idx.shape[0] - 1
    s = idx.shape[1]
    qno = idx[k] >> 8
    row_scores = _adc_rows(
        codes, pq_lut(qvecs, codebooks), idx[:k].T.reshape(-1), qno.repeat_interleave(k)
    )
    return _masked_reduce(row_scores.view(s, k), idx[k] & 0xFF, op)


def _adc_rows(
    codes: torch.Tensor, lut: torch.Tensor, rows: torch.Tensor, qno: torch.Tensor
) -> torch.Tensor:
    """Per row, the sum over subspaces of its query's LUT entry at the
    row's code (``lut`` from :func:`pq_lut`)."""
    m = lut.shape[1]
    c = stream_kernel_pq.gather_codes(codes, rows.long())[:, :m]
    subspace = torch.arange(m, device=codes.device)[None, :]
    return lut[qno.long()[:, None], subspace, c].sum(-1)


def score_pairs_pq(
    codes: torch.Tensor,
    codebooks: torch.Tensor,
    qvecs: torch.Tensor,
    idx: torch.Tensor,
    num_out: int,
    op: str,
) -> torch.Tensor:
    """ADC-score (query, doc) pairs against PQ codes over the flat per-row
    layout (:func:`score_pairs_dense`'s ``idx`` and ``op``).

    :param codes: PQ codes, ``(N, M)``.
    :param codebooks: Codebooks, ``(M, Ks, Ds)`` fp32.
    :param qvecs: (OPQ-rotated) query vectors, ``(Q, M * Ds)`` fp32.
    :return: Per-pair scores, ``(num_out,)`` fp32.
    """
    row_scores = _adc_rows(codes, pq_lut(qvecs, codebooks), idx[0], idx[1])
    return _segment_reduce(row_scores, idx[2], num_out, op)


# -- fused serve tail --------------------------------------------------------


def _interp_weights(alpha) -> tuple[float, float]:
    """fp32 ``alpha`` and ``1 - alpha`` (as the device computes them)."""
    a = np.float32(alpha)
    return float(a), float(np.float32(1.0) - a)


def interpolate_scores(lexical: torch.Tensor, semantic: torch.Tensor, alpha: float) -> torch.Tensor:
    """On-device score interpolation ``alpha * lexical + (1-alpha) * semantic``.

    (Reference host equivalent: ``ranking.py:293-326``.)
    """
    a, b = _interp_weights(alpha)
    return a * lexical + b * semantic


def _topk_desc(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` along the last axis; ties go to the lower position first
    (``lax.top_k``'s order, which ``torch.topk`` does not promise)."""
    vals, pos = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], pos[..., :k]


def _pack_topk(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``(2, Q, k)`` int32: the fp32 score bits, then the flat pair index."""
    return torch.stack([vals.float().contiguous().view(torch.int32), idx.to(torch.int32)])


def _slot_from_segments(starts: torch.Tensor, counts: torch.Tensor, d_max: int) -> torch.Tensor:
    """The ``(Q, d_max)`` slot matrix built on the device from per-row
    segments: row ``q`` holds ``starts[q] .. starts[q] + counts[q] - 1``
    then ``-1`` (pair query numbers must be non-decreasing, so each query's
    pairs are one contiguous range; two ``(Q,)`` vectors go up instead of
    the matrix)."""
    d = torch.arange(d_max, dtype=torch.int32, device=starts.device)[None, :]
    return torch.where(d < counts[:, None], starts[:, None] + d, -1).to(torch.int32)


def _interp_slots(scores, lex_pad, slot_mat, alpha):
    valid = slot_mat >= 0
    safe = torch.where(valid, slot_mat, 0).long()
    interp = interpolate_scores(lex_pad[safe], scores[safe], alpha)
    return torch.where(valid, interp, -torch.inf)


def serve_topk(
    scores_pad: torch.Tensor,
    lex_pad: torch.Tensor,
    slot_mat: torch.Tensor,
    alpha,
    cutoff: int,
) -> torch.Tensor:
    """Fused serving tail: interpolate + per-query top-k, on the device.

    Only ``(2, Q, cutoff)`` int32 cross back to the host instead of the full
    per-pair score array.  Row order of ``slot_mat`` is the caller's output
    query order; invalid slots are ``-1`` (selected only when a query has
    fewer than ``cutoff`` candidates; they come back as ``-inf`` scores and
    ``-1`` indices for the host to drop).

    :param scores_pad: Per-pair semantic scores, ``(S,)`` fp32 (padded).
    :param lex_pad: Per-pair lexical (first-stage) scores, ``(S,)`` fp32.
    :param slot_mat: ``(Q, D)`` int32 flat pair positions, ``-1`` padding.
    :param alpha: Interpolation parameter.
    :param cutoff: Top-k per query.
    :return: ``(2, Q, cutoff)`` int32: ``[0]`` the selected interpolated
        scores (fp32 bit pattern), ``[1]`` the selected flat pair indices.
    """
    gathered = _interp_slots(scores_pad, lex_pad, slot_mat, alpha)
    vals, pos = _topk_desc(gathered, cutoff)
    return _pack_topk(vals, torch.gather(slot_mat, 1, pos))


def serve_topk_seg(
    scores_pad: torch.Tensor,
    lex_pad: torch.Tensor,
    starts: torch.Tensor,
    counts: torch.Tensor,
    alpha,
    cutoff: int,
    d_max: int,
) -> torch.Tensor:
    """:func:`serve_topk` with the slot matrix built on the device.

    ``starts``/``counts`` are ``(Q,)`` int32 in output-row order (rows past
    the live queries carry ``counts == 0``); each query's pairs must be one
    contiguous range of the flat pair space.  The packed result equals
    :func:`serve_topk` on the materialized matrix.
    """
    slot_mat = _slot_from_segments(starts, counts, d_max)
    return serve_topk(scores_pad, lex_pad, slot_mat, alpha, cutoff)


def serve_topk_refine(
    scores_fast: torch.Tensor,
    lex_pad: torch.Tensor,
    slot_mat: torch.Tensor,
    alpha,
    cutoff: int,
    margin: int,
    table: torch.Tensor,
    rows_pad: torch.Tensor,
    q_dev: torch.Tensor,
    q_perm: torch.Tensor,
) -> torch.Tensor:
    """Two-phase fused serving tail: fast preselect, exact rescore, cut.

    Phase 1 interpolates the bf16 ``"fast"`` semantic scores and keeps the
    top ``cutoff + margin`` candidates per query; phase 2 gathers just those
    rows, recomputes their dots in full fp32 (elementwise multiply and fp32
    sum), re-interpolates and cuts to ``cutoff``.  Same packed transport as
    :func:`serve_topk`.

    :param scores_fast: Per-pair ``"fast"``-tier scores, ``(S,)`` fp32.
    :param lex_pad: Per-pair lexical scores, ``(S,)`` fp32.
    :param slot_mat: ``(Q, D)`` int32 flat pair positions, ``-1`` padding.
    :param alpha: Interpolation parameter.
    :param cutoff: Top-k per query.
    :param margin: Extra fast-pass candidates to rescore.
    :param table: Dense embedding table, ``(N_pad, dim)``.
    :param rows_pad: Table row per flat pair, ``(S,)`` int32.
    :param q_dev: Query block, ``(Qb, dim)`` fp32.
    :param q_perm: Slot-row -> query-index permutation, ``(Q,)`` int32.
    :return: ``(2, Q, cutoff)`` int32, packed like :func:`serve_topk`.
    """
    gathered = _interp_slots(scores_fast, lex_pad, slot_mat, alpha)
    kc2 = min(cutoff + margin, slot_mat.shape[1])
    _, pos = _topk_desc(gathered, kc2)
    pair_idx = torch.gather(slot_mat, 1, pos)  # (Q, kc2)
    pvalid = pair_idx >= 0
    psafe = torch.where(pvalid, pair_idx, 0).long()
    vecs = table[rows_pad[psafe].long()].float()  # (Q, kc2, dim)
    q_sel = q_dev[q_perm.long()].float()  # (Q, dim)
    exact = (vecs * q_sel[:, None, :]).sum(-1)
    interp2 = interpolate_scores(lex_pad[psafe], exact, alpha)
    interp2 = torch.where(pvalid, interp2, -torch.inf)
    vals, pos2 = _topk_desc(interp2, cutoff)
    return _pack_topk(vals, torch.gather(pair_idx, 1, pos2))


def serve_topk_refine_seg(
    scores_fast: torch.Tensor,
    lex_pad: torch.Tensor,
    starts: torch.Tensor,
    counts: torch.Tensor,
    alpha,
    cutoff: int,
    margin: int,
    d_max: int,
    table: torch.Tensor,
    rows_pad: torch.Tensor,
    q_dev: torch.Tensor,
    q_perm: torch.Tensor,
) -> torch.Tensor:
    """:func:`serve_topk_refine` with the slot matrix built on the device
    (the segment contract of :func:`serve_topk_seg`)."""
    slot_mat = _slot_from_segments(starts, counts, d_max)
    return serve_topk_refine(
        scores_fast, lex_pad, slot_mat, alpha, cutoff, margin, table, rows_pad, q_dev, q_perm
    )


def serve_topk_host(
    scores: np.ndarray,
    lex: np.ndarray,
    slot_mat: np.ndarray,
    alpha: float,
    cutoff: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Host twin of :func:`serve_topk` for already-fetched scores.

    Same selection semantics (ties resolved toward the lower slot
    position).

    :return: ``(vals, pair_idx)`` float32/int32 arrays of ``(Q, cutoff)``.
    """
    valid = slot_mat >= 0
    taken = slot_mat[valid]
    interp = np.float32(alpha) * lex[taken].astype(np.float32, copy=False) + np.float32(
        1.0 - alpha
    ) * scores[taken].astype(np.float32, copy=False)
    gathered = np.full(slot_mat.shape, -np.inf, dtype=np.float32)
    gathered[valid] = interp
    pos = np.argsort(-gathered, axis=1, kind="stable")[:, :cutoff]
    vals = np.take_along_axis(gathered, pos, axis=1)
    pair_idx = np.take_along_axis(slot_mat, pos, axis=1)
    return vals, pair_idx.astype(np.int32, copy=False)


def decode_serve_topk(packed: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split a fetched :func:`serve_topk` result into scores + indices."""
    vals = np.ascontiguousarray(packed[0]).view(np.float32)
    return vals, packed[1]
