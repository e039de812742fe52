"""The tier beyond device memory: host-RAM tables streamed through K1-K4.

The port of ``fastforward_tpu/ops/host_stream.py``.  A table larger than the
memory an index may use on the card is served from a **hybrid** view
(``index.base.build_hybrid_view``): dense fp32/bf16 rows, int8 code rows
(scales folded into the queries) or PQ code rows (ADC against the
codebooks), split into

- a device-resident **prefix**, scored as a whole-table index scores
  (streamed through the kernels when the candidates are dense, a gather-dot
  when they are sparse), and
- a host-RAM **tail**, scored by *candidate-block streaming*: the tail
  candidates are compacted to unique rows, gathered on the host into blocks
  of up to ``chunk_rows`` rows, copied to the card and scored by the same
  kernel the prefix runs (``stream_select_auto``: K1/K2;
  ``stream_select_pq_auto``: K3/K4), each block's scores written into one
  device accumulator, so a call fetches its scores once.

On the card the copies run on a stream of the view's own, one block ahead
of the kernels: block ``c + 1`` is gathered on the host into one of two pinned
staging buffers used in turn (``upload.PinnedStager``: a buffer is refilled
only after the copy that last read it has landed) and copied while block
``c``'s kernel runs; the kernel's stream waits on the copy's event, and each
block records the stream that read it, so the allocator never hands its
memory to the copy stream while a kernel may still read it.  A tail block
whose rows are one contiguous run is a view of the tail, copied into a
staging buffer like a gathered one: page-locking the tail instead
(``cudaHostRegister``) copies such blocks at the link's rate, but costs a
registration of the whole tail and locks that much host memory.

Gathered blocks are kept on the host per plan (in pinned memory, within
``HOST_BLOCK_CACHE_BUDGET``) and on the card across plans: the view's
device cache is a least-recently-used map bounded by the view's
``tail_cache_budget`` in all, whose blocks of the call in hand are never
evicted for each other (a tail larger than the budget, scanned in the same
order every call, would otherwise evict each block just before its next
use).  Warm calls then ship only the blocks the budget cannot hold.

Document modes take a ragged flat layout (no K-padding) and segment-reduce
each side, prefix and tail, on the device: ``2 x n_pairs`` floats come back,
not one per row.

Everything runs on the device of the resident prefix: the kernels on the
card, their plain versions for CPU tensors, and nothing falls back from one
to the other.  On a mesh (the sharded hybrid tier) the prefix is
row-sharded and scored by the sharded programs (``parallel.sharded``), and
in one process the tail's chunks go to the mesh's devices in contiguous
ranges, each device with its own copy stream and block cache (the budget
bounds each device's blocks); the scores gather on the mesh's first
device.
"""

import logging
import threading

import numpy as np
import torch

from fastforward_tpu_torch.ops import scoring, stream_kernel, stream_kernel_pq
from fastforward_tpu_torch.ops.upload import PinnedStager
from fastforward_tpu_torch.utils.tracing import annotate

LOGGER = logging.getLogger(__name__)

#: default unique rows of a streamed tail block (32,768 rows x 768 x 4 B =
#: 100.7 MB); the device cache keeps whole blocks, so a block must be small
#: next to the budget left for it, or caching becomes all-or-nothing
HOST_CHUNK_ROWS = 1 << 15

#: per-plan cap on the host memory (pinned on the card) that keeps gathered
#: tail blocks across calls; blocks that are views of the tail are never kept
HOST_BLOCK_CACHE_BUDGET = 2 << 30

#: cumulative counters of the hybrid tier: blocks copied to the device and
#: their bytes, device cache hits, and score floats fetched to the host
#: (document modes fetch ``2 x n_pairs``); reset with :func:`reset_stats`
STATS = {"uploads": 0, "upload_bytes": 0, "block_cache_hits": 0, "fetch_floats": 0}
_STATS_LOCK = threading.Lock()


def reset_stats() -> None:
    """Zero the hybrid tier's counters."""
    with _STATS_LOCK:
        STATS.update(uploads=0, upload_bytes=0, block_cache_hits=0, fetch_floats=0)


def _count(**deltas: int) -> None:
    with _STATS_LOCK:
        for key, value in deltas.items():
            STATS[key] += value


def _kernel_tile_rows(kind: str) -> int:
    return stream_kernel_pq.KERNEL_PQ_TILE_ROWS if kind == "pq" else stream_kernel.KERNEL_TILE_ROWS


# -- the resident prefix -------------------------------------------------------


def _index_dev(plan: dict, key: str, arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """``arr`` on ``device`` as int64, kept in ``plan[key]``."""
    dev = plan.get(key)
    if dev is None:
        dev = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int64)).to(device)
        plan[key] = dev
    return dev


def _score_resident(
    table,
    codebooks,
    q_pad: np.ndarray,
    rows: np.ndarray,
    qno: np.ndarray,
    precision: str,
    plan: dict,
    kind: str,
    mesh=None,
) -> torch.Tensor:
    """Per-row scores of resident-prefix candidates, on the device.

    Dense candidate sets stream through the kernels (K1/K2 for vectors and
    int8 codes, K3/K4 for PQ codes), sparse ones take the gather-dot (the
    gather-ADC for PQ), with the density thresholds of a whole-table index.
    A prefix row-sharded over ``mesh`` runs the sharded programs.
    """
    p = rows.shape[0]
    n = table.shape[0]
    r = _kernel_tile_rows(kind)
    scores = None
    if mesh is not None:
        from fastforward_tpu_torch.parallel import sharded

        if kind == "pq" and p * scoring.STREAM_DENSITY_PQ > n:
            scores = sharded.streamed_scores_sharded_pq(
                mesh, table, codebooks, q_pad, rows, qno, plan=plan, precision=precision,
                fetch=False,
            )
        elif kind != "pq" and p * scoring.STREAM_DENSITY > n:
            scores = sharded.streamed_scores_sharded(
                mesh, table, q_pad, rows, qno, precision=precision, plan=plan, fetch=False
            )
        if scores is None:
            scores = sharded.row_scores_sharded(
                mesh, table, q_pad, rows, qno, precision,
                codebooks=codebooks if kind == "pq" else None, plan=plan,
            )
        return scores[:p]
    if n % r == 0:
        if kind == "pq" and p * scoring.STREAM_DENSITY_PQ > n:
            scores = scoring.streamed_scores_pq(
                table, codebooks, q_pad, rows, qno, precision=precision, plan=plan, fetch=False
            )
        elif (
            kind != "pq"
            and p * scoring.STREAM_DENSITY > n
            and (table.ndim == 3 or table.shape[1] % 128 == 0)
        ):
            scores = scoring.streamed_scores(
                table, q_pad, rows, qno, precision=precision, plan=plan, fetch=False
            )
    if scores is not None:
        return scores[:p]
    q_dev = scoring._cached_q_upload(q_pad, plan, "q_dev", table.device)
    rows_d = _index_dev(plan, "gather_rows", rows, table.device)
    qno_d = _index_dev(plan, "gather_qno", qno, table.device)
    if kind == "pq":
        return scoring._adc_rows(table, scoring.pq_lut(q_dev, codebooks), rows_d, qno_d)
    return scoring._gathered_dots(table, q_dev, rows_d, qno_d, precision)


# -- the streamed tail ---------------------------------------------------------


def _build_tail_chunks(
    u_rows: np.ndarray,
    u_of_pair: np.ndarray,
    qno: np.ndarray,
    qb: int,
    chunk_rows: int,
    r: int,
    devices: "list[torch.device]",
) -> "tuple[list[dict], np.ndarray]":
    """Cut the unique tail rows into chunks and lay out each chunk's
    candidates for the kernels, chunk ``c`` on ``devices[chunk["dev"]]``
    (the devices take contiguous, near-equal ranges of chunks).

    Returns ``(chunks, order)``: ``order`` permutes the tail pairs into
    chunk-major order (each chunk's scores land contiguously in the
    accumulator at ``chunk["start"]``).  A chunk's block covers its unique
    rows only, rounded up to a power of two and to whole tiles (at most
    ``chunk_rows``), so sparse chunks copy and cache at their real size.

    :raises RuntimeError: When ``qb x r`` overflows the int32 candidate
        packing.
    """
    chunk_of = u_of_pair // chunk_rows
    order = np.argsort(chunk_of, kind="stable")
    n_chunks = -(-u_rows.shape[0] // chunk_rows)
    counts = np.bincount(chunk_of, minlength=n_chunks)
    starts = np.zeros(n_chunks + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    chunks: list[dict] = []
    for c in range(n_chunks):
        dev_no = (c * len(devices)) // n_chunks
        device = devices[dev_no]
        lo, hi = int(starts[c]), int(starts[c + 1])
        sel = order[lo:hi]
        local = (u_of_pair[sel] - c * chunk_rows).astype(np.int64)
        u_count = int(min(chunk_rows, u_rows.shape[0] - c * chunk_rows))
        block_rows = min(chunk_rows, -(-max(r, 1 << (u_count - 1).bit_length()) // r) * r)
        cap = scoring._adaptive_cap(max(1, hi - lo), chunk_rows // r)
        layout = scoring.build_streamed_layout(
            local, qno[sel].astype(np.int64), chunk_rows, qb, r=r, cap=cap
        )
        if layout is None:
            raise RuntimeError(f"the streamed layout cannot pack {qb} queries x {r} tile rows")
        cand, tile_idx, slot_of_pair = layout
        chunks.append(
            {
                "rows": u_rows[c * chunk_rows : (c + 1) * chunk_rows],
                "block_rows": block_rows,
                "cand": torch.from_numpy(cand.reshape(cand.shape[0], cap // 128, 128)).to(device),
                "tile": torch.from_numpy(tile_idx).to(device),
                "slot": torch.from_numpy(slot_of_pair).to(device),
                "start": lo,
                "n": hi - lo,
                "dev": dev_no,
            }
        )
    return chunks, order


def _chunk_contiguous(chunk: dict) -> bool:
    """Whether the chunk's unique rows (sorted) are one contiguous run."""
    rows = chunk["rows"]
    return bool(rows.shape[0]) and int(rows[-1]) - int(rows[0]) == rows.shape[0] - 1


def _block_cache_key(chunk: dict, dtype: torch.dtype) -> tuple:
    """Content key of a chunk's block: plans whose candidate sets share a
    chunk's unique rows share its cached device block."""
    key = chunk.get("cache_key")
    if key is None:
        key = (str(dtype), chunk["block_rows"], chunk["rows"].tobytes())
        chunk["cache_key"] = key
    return key


class _TailCopier:
    """How one call's tail blocks reach the device: the host tail as a
    tensor, the blocks' device dtype and row shape, and on the card the copy
    stream and the pinned staging buffers."""

    def __init__(self, host_tail, store, chunk_rows, dtype, row_shape, device) -> None:
        self.tail = store.get("tail_t")
        if self.tail is None:
            self.tail = torch.from_numpy(host_tail)
            store["tail_t"] = self.tail
        self.store = store
        self.dtype = dtype
        self.row_shape = tuple(row_shape)
        self.device = device
        self.width = int(np.prod(self.row_shape))
        self.row_bytes = self.width * self.tail.element_size()
        self.cuda = device.type == "cuda"
        if self.cuda:
            # one copy stream a view: the caching allocator keeps freed
            # blocks per stream, so a stream of each call's own would find
            # none to reuse and allocate (and synchronize) anew every call
            with store["lock"]:
                self.stream = store.get("copy_stream")
                if self.stream is None:
                    self.stream = store["copy_stream"] = torch.cuda.Stream(device=device)
            self.stager = PinnedStager(chunk_rows, (host_tail.shape[1],), self.tail.dtype)

    def source(self, chunk: dict, host_acct: dict) -> "tuple[torch.Tensor, bool]":
        """The chunk's rows on the host, ``(n, width)``, and whether they
        sit in a staging buffer (whose copy must then be marked sent).

        A contiguous run is a view of the tail (on the card, copied into a
        staging buffer); scattered rows are gathered, into a pinned block
        kept on the chunk while the plan's host budget allows, else into a
        staging buffer.
        """
        rows = chunk["rows"]
        n = rows.shape[0]
        kept = chunk.get("block_host")
        if kept is not None:
            return kept, False
        if _chunk_contiguous(chunk):
            lo = int(rows[0])
            view = self.tail[lo : lo + n]
            if not self.cuda:
                return view, False
            slot = self.stager.slot(n)
            slot.copy_(view)
            return slot, True
        rows_t = torch.from_numpy(rows)
        nbytes = n * self.row_bytes
        with self.store["lock"]:
            cached = host_acct.get("host_cached_bytes", 0)
            keep = cached + nbytes <= HOST_BLOCK_CACHE_BUDGET
            if keep:
                host_acct["host_cached_bytes"] = cached + nbytes
        if keep or not self.cuda:
            dst = torch.empty((n, self.tail.shape[1]), dtype=self.tail.dtype, pin_memory=self.cuda)
        else:
            dst = self.stager.slot(n)
        with annotate("ff.tail_gather"):
            torch.index_select(self.tail, 0, rows_t, out=dst)
        if keep:
            chunk["block_host"] = dst
        return dst, not keep and self.cuda

    def to_device(self, src: torch.Tensor, staged: bool, block_rows: int):
        """The device block of ``src``'s rows, zero rows up to
        ``block_rows``; on the card copied on the copy stream, with the
        event the kernel's stream waits on."""
        n = src.shape[0]
        shape = (block_rows, *self.row_shape)
        if not self.cuda:
            if n == block_rows and src.dtype == self.dtype:
                return src.view(shape), None
            block = torch.zeros((block_rows, self.width), dtype=self.dtype)
            block[:n] = src
            return block.view(shape), None
        with torch.cuda.stream(self.stream):
            block = torch.empty(shape, dtype=self.dtype, device=self.device)
            flat = block.view(block_rows, -1)
            if src.dtype == self.dtype:
                flat[:n].copy_(src, non_blocking=True)
            else:  # fp32 rows of a bf16 table: cast on the device
                flat[:n].copy_(src.to(self.device, non_blocking=True))
            if n < block_rows:
                flat[n:].zero_()
            ready = torch.cuda.Event()
            ready.record(self.stream)
            if staged:
                self.stager.sent(self.stream)
        return block, ready


def _upload_block(
    chunk: dict,
    copier: _TailCopier,
    store: dict,
    budget: int,
    host_acct: dict,
    keep_keys: "set | frozenset" = frozenset(),
) -> "tuple[torch.Tensor, torch.cuda.Event | None]":
    """The chunk's device block and the event its copy records (``None``
    when nothing is in flight), from the view's device cache when it is
    there.

    The cache (``store["tail_blocks"]``, shared by every plan of the view)
    is an LRU bounded by ``budget`` bytes in all.  Blocks of ``keep_keys``
    (the call in hand) are never evicted to make room; when only they
    remain, the new block is not cached.  A block that enters the cache
    drops the chunk's host copy.
    """
    key = _block_cache_key(chunk, copier.dtype)
    blocks = store.setdefault("tail_blocks", {})
    with store["lock"]:
        ent = blocks.pop(key, None)
        if ent is not None:
            blocks[key] = ent  # touched: now the most recent
    if ent is not None:
        _count(block_cache_hits=1)
        return ent[0], ent[2]
    src, staged = copier.source(chunk, host_acct)
    with annotate("ff.tail_copy"):
        block, ready = copier.to_device(src, staged, chunk["block_rows"])
    nbytes = src.shape[0] * copier.row_bytes
    _count(uploads=1, upload_bytes=nbytes)
    dev_bytes = block.numel() * block.element_size()
    if dev_bytes > budget:
        return block, ready
    with store["lock"]:
        used = store.get("tail_bytes", 0)
        if used + dev_bytes > budget:
            for old in [k for k in blocks if k not in keep_keys]:
                used -= blocks.pop(old)[1]
                if used + dev_bytes <= budget:
                    break
        if used + dev_bytes <= budget:
            blocks[key] = (block, dev_bytes, ready)
            used += dev_bytes
            kept = chunk.pop("block_host", None)
            if kept is not None:
                host_acct["host_cached_bytes"] = max(
                    0, host_acct.get("host_cached_bytes", 0) - kept.shape[0] * copier.row_bytes
                )
        store["tail_bytes"] = used
    return block, ready


def _stream_tail(
    state: dict,
    lo: int,
    hi: int,
    copier: _TailCopier,
    q_dev: torch.Tensor,
    codebooks: "torch.Tensor | None",
    kind: str,
    precision: str,
    store: dict,
    budget: int,
    acc: torch.Tensor,
) -> None:
    """Score the tail chunks ``[lo, hi)`` (all on ``copier.device``) into
    the accumulator (chunk-major pair order, on the first device), one
    block copy ahead of the kernels."""
    chunks = state["chunks"][lo:hi]
    r = state["r"]
    keep = state.get(("keys", lo))
    if keep is None:
        keep = state[("keys", lo)] = frozenset(_block_cache_key(c, copier.dtype) for c in chunks)
    compute = torch.cuda.current_stream(copier.device) if copier.cuda else None
    q_t = q_dev.t()
    pending = _upload_block(chunks[0], copier, store, budget, state, keep)
    for c, chunk in enumerate(chunks):
        block, ready = pending
        if ready is not None:
            compute.wait_event(ready)
        if kind == "pq":
            outs = stream_kernel_pq.stream_select_pq_auto(
                block, codebooks, q_t, chunk["cand"], chunk["tile"], r=r, precision=precision
            )
        else:
            outs = stream_kernel.stream_select_auto(
                block, q_t, chunk["cand"], chunk["tile"], r=r, precision=precision
            )
        if compute is not None:
            block.record_stream(compute)
        start = chunk["start"]
        acc[start : start + chunk["n"]] = torch.take(outs, chunk["slot"]).to(acc.device)
        if c + 1 < len(chunks):
            # the next block's gather and copy run under this block's kernel
            pending = _upload_block(chunks[c + 1], copier, store, budget, state, keep)


def hybrid_scores(
    resident: torch.Tensor,
    host_tail: np.ndarray,
    tail_start: int,
    chunk_rows: int,
    q_pad: np.ndarray,
    rows: np.ndarray,
    qno: np.ndarray,
    precision: str = "exact",
    plan: dict | None = None,
    cache_device_blocks_budget: int = 0,
    cache_store: dict | None = None,
    reduce: "tuple[str, np.ndarray, int, np.ndarray] | None" = None,
    kind: str = "dense",
    codebooks=None,
    mesh=None,
) -> np.ndarray:
    """Score ``table[rows[i]] . q_pad[qno[i]]`` against a hybrid table.

    :param resident: The device-resident prefix (rows ``< tail_start``; may
        hold 0 rows): ``(R, dim)`` fp32/bf16 for ``kind="dense"``, ``(R,
        dim/128, 128)`` int8 codes for ``"scalar"`` (scales folded into
        ``q_pad``), ``(R, M)`` PQ codes for ``"pq"`` (uint8, uint16 or
        uint32).
    :param host_tail: The host tail, ``(N - tail_start, width)``: fp32 rows,
        int8 codes or PQ codes (2- or 4-byte rows for Ks > 256).
    :param tail_start: First global row of ``host_tail``.
    :param chunk_rows: Unique tail rows a streamed block holds at most.
    :param q_pad: Padded query vectors, ``(Qb, dim)`` fp32.
    :param rows: Global table row per candidate row, ``(P,)``.
    :param qno: Query per candidate row, ``(P,)``.
    :param precision: Dot precision tier.
    :param plan: Optional prepared-run cache: holds the chunk layouts on the
        device and the gathered host blocks.
    :param cache_device_blocks_budget: Device bytes that may keep tail
        blocks resident across calls (0: every call copies its blocks).
    :param cache_store: The view-lifetime dict holding the device block
        cache (the budget bounds the total over every plan of the view).
    :param reduce: ``(op, seg, n_pairs, counts)`` of a document mode:
        ``seg[i]`` is the output pair of row ``i`` (a ragged layout, no
        padding rows); each side reduces on the device (``"max"``, or a sum
        for ``"mean"``) and the host combines the two.
    :param kind: ``"dense"``, ``"scalar"`` or ``"pq"``.
    :param codebooks: Device PQ codebooks ``(M, Ks, Ds)`` fp32 (``"pq"``;
        OPQ queries arrive rotated; replicated on a mesh).
    :param mesh: The mesh ``resident`` is row-sharded over (the sharded
        hybrid tier): in one process the tail chunks then spread over the
        mesh's devices in contiguous ranges.
    :return: Scores in input order ``(P,)``, or per pair ``(n_pairs,)``
        with ``reduce`` (fp32 numpy).
    """
    from fastforward_tpu_torch.parallel.sharded import on_device

    store = cache_store if cache_store is not None else {}
    store.setdefault("lock", threading.Lock())
    device = resident.device
    p = rows.shape[0]
    qb = q_pad.shape[0]
    state = plan.get("hybrid") if plan is not None else None
    if state is None:
        res_mask = rows < tail_start
        res_pos = np.flatnonzero(res_mask)
        tail_pos = np.flatnonzero(~res_mask)
        u_rows, u_of_pair = np.unique(rows[tail_pos] - tail_start, return_inverse=True)
        r = _kernel_tile_rows(kind)
        chunk_rows_eff = max(r, (chunk_rows // r) * r)
        # one process over a mesh: the tail's chunks spread over its
        # devices, a card named twice taking one range (one block cache a
        # card, bounded by its budget)
        devices = [device]
        if mesh is not None and not mesh.multiprocess:
            devices = mesh.memory_devices
        with annotate("ff.layout"):
            chunks, order = _build_tail_chunks(
                u_rows.astype(np.int64), u_of_pair.reshape(-1).astype(np.int64),
                qno[tail_pos], qb, chunk_rows_eff, r, devices,
            )
        # each device's contiguous range of chunks, (lo, hi)
        bounds = [0] + [c for c in range(1, len(chunks)) if chunks[c]["dev"] != chunks[c - 1]["dev"]]
        state = {
            "res_pos": res_pos,
            "res_rows": rows[res_pos].astype(np.int64),
            "res_qno": qno[res_pos].astype(np.int64),
            "res_plan": {},
            "tail_pos_ordered": tail_pos[order],
            "p_tail": tail_pos.shape[0],
            "chunks": chunks,
            "devices": devices,
            "dev_ranges": list(zip(bounds, bounds[1:] + [len(chunks)])) if chunks else [],
            "r": r,
            "chunk_rows": chunk_rows_eff,
        }
        if plan is not None:
            plan["hybrid"] = state

    n_out = 0
    op2 = None
    if reduce is not None:
        red_op, seg, n_out, red_counts = reduce
        op2 = "max" if red_op == "max" else "sum"
        if "seg_res_dev" not in state:
            state["seg_res_dev"] = torch.from_numpy(seg[state["res_pos"]].astype(np.int64)).to(device)
            state["seg_tail_dev"] = torch.from_numpy(
                seg[state["tail_pos_ordered"]].astype(np.int64)
            ).to(device)

    res_plan = state["res_plan"]
    q_dev = scoring._cached_q_upload(q_pad, res_plan, "q_dev", device)
    res_dev = tail_dev = None
    if state["res_pos"].shape[0]:
        with annotate("ff.hybrid_resident"):
            res_dev = _score_resident(
                resident, codebooks, q_pad, state["res_rows"], state["res_qno"], precision,
                res_plan, kind, mesh=mesh,
            )
            if reduce is not None:
                res_dev = scoring._segment_reduce(res_dev, state["seg_res_dev"], n_out, op2)
    if state["chunks"]:
        tail_dev = torch.empty(state["p_tail"], dtype=torch.float32, device=device)
        with annotate("ff.hybrid_tail"):
            for lo, hi in state["dev_ranges"]:
                d = state["chunks"][lo]["dev"]
                dev = state["devices"][d]
                # one block cache a device, each bounded by the budget
                store_d = store if len(state["devices"]) == 1 else store.setdefault(
                    f"dev{d}", {"lock": threading.Lock()}
                )
                # tail blocks take the resident prefix's dtype and row layout
                copier = _TailCopier(
                    host_tail, store_d, state["chunk_rows"], resident.dtype, resident.shape[1:],
                    dev,
                )
                q_d = q_dev if dev == device else scoring._cached_q_upload(
                    q_pad, res_plan, f"q_dev@{d}", dev
                )
                cb_d = on_device(codebooks, dev) if codebooks is not None else None
                _stream_tail(
                    state, lo, hi, copier, q_d, cb_d, kind, precision, store_d,
                    cache_device_blocks_budget, tail_dev,
                )
            if reduce is not None:
                tail_dev = scoring._segment_reduce(tail_dev, state["seg_tail_dev"], n_out, op2)

    res_part = tail_part = None
    with annotate("ff.fetch"):
        if res_dev is not None:
            res_part = scoring.fetch_np(res_dev)
            _count(fetch_floats=int(res_part.shape[0]))
        if tail_dev is not None:
            tail_part = scoring.fetch_np(tail_dev)
            _count(fetch_floats=int(tail_part.shape[0]))
    if reduce is None:
        out = np.empty(p, dtype=np.float32)
        if res_part is not None:
            out[state["res_pos"]] = res_part
        if tail_part is not None:
            out[state["tail_pos_ordered"]] = tail_part
        return out
    # combine the two sides on the host: the max of the maxima, or the sum
    # of the sums over the (host-known) pair counts
    if red_op == "max":
        parts = [x for x in (res_part, tail_part) if x is not None]
        return np.maximum.reduce(parts).astype(np.float32)
    total = np.zeros(n_out, dtype=np.float64)
    for part in (res_part, tail_part):
        if part is not None:
            total += part
    return (total / np.maximum(red_counts, 1)).astype(np.float32)
