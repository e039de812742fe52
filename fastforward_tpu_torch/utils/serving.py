"""Micro-batching serving front-end over :meth:`Index.submit_serve`.

The port of ``fastforward_tpu/utils/serving.py``.  Interpolation
re-ranking is dominated by the fixed per-call cost (host preparation,
kernel launches, one device->host result copy), not by per-query compute:
one fused serve call over 512 queries costs little more than one over 8.
The reference
leaves request handling entirely to the caller (its serving story is the
one-call ``Ranking`` flow, reference ``index/base.py:227-273``); this
module adds the piece a deployment actually needs on top of that flow —
a :class:`BatchingServer` that coalesces concurrent small requests into
one fused device call and fans the per-request rankings back out.

Requests take the ARRAY path by default: each request resolves its
candidates to row/score arrays in a resolver pool the moment it is
submitted (``Index._serve_prep``, overlapping the batching wait — the
submit call itself stays instant so simultaneous requests coalesce into
full batches), merged batches are numpy concats feeding ONE fused
device program (``Index._serve_arrays``), and results split back per
request by query ranges — no frame concat, no q_id namespacing, no
string splits (requests may reuse the same ``q_id`` strings; separation
is positional).  Requests that cannot pre-resolve (no device view,
multi-process meshes, too-ragged documents) send their batch down the
frame path: query IDs
namespaced with an opaque per-request prefix, one merged ``submit_serve``
dispatch, tag-based split.  Either way only ``(2, Q, cutoff)`` packed
values are copied back per batch, and batches are pipelined: while batch
*i*'s result fetch is in flight, later batches are collected and
dispatched.  Batches prepared in several threads launch on one CUDA
stream, so each batch's result copy is ordered after its own work.
"""

import logging
import queue
import sys
import threading
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from time import monotonic

import numpy as np
import pandas as pd
from pandas.api.types import union_categoricals

from fastforward_tpu_torch.ranking import Ranking, _plain_ids

LOGGER = logging.getLogger(__name__)

#: Separator between the per-request namespace tag and the original q_id.
#: U+001F (unit separator) never appears in TREC query IDs.
_SEP = "\x1f"


def _concat_col(parts: list) -> "pd.Series | pd.Categorical":
    """Concatenate one column across request frames, keeping categoricals
    categorical (``pd.concat`` would silently widen mismatched-category
    columns to object, materializing every string)."""
    if all(isinstance(p.dtype, pd.CategoricalDtype) for p in parts):
        return union_categoricals([p.array for p in parts])
    return pd.concat(parts, ignore_index=True)


class _Request:
    __slots__ = ("ranking", "future", "tag", "prep", "prep_future")

    def __init__(self, ranking: Ranking, tag: str, prep_future=None) -> None:
        self.ranking = ranking
        self.future: "Future[Ranking]" = Future()
        self.tag = tag
        # per-request resolved arrays (Index._serve_prep), built in the
        # resolver pool concurrently with batching; None -> frame fallback
        self.prep = None
        self.prep_future = prep_future


class BatchingServer:
    """Coalesce concurrent re-ranking requests into fused device calls.

    Usage::

        with BatchingServer(index, alpha=0.2, cutoff=10) as server:
            future = server.submit(ranking)   # thread-safe, non-blocking
            topk = future.result()            # == index.serve(ranking, ...)

    :param index: The index to serve from (its device table should be
        :meth:`~fastforward_tpu_torch.index.Index.preload`-ed).
    :param alpha: Interpolation parameter (lexical weight).
    :param cutoff: Top-k depth per query to return.
    :param max_batch_queries: Dispatch a batch once it holds at least this
        many unique queries (requests are never split across batches, so a
        batch may exceed this by one request's query count).
    :param max_wait_ms: Dispatch a non-empty batch after waiting this long
        for more requests, even if it is below ``max_batch_queries``.
    :param refine: Optional two-phase margin forwarded to
        :meth:`Index.submit_serve` (bf16 fast preselect of the top
        ``cutoff + refine`` per query, exact fp32 rescore on device).
    :param pipeline_depth: Max in-flight dispatched batches before the
        oldest result is fetched: under continuous load a deeper pipeline
        hides the fetch latency of every batch but the last; an idle server
        still resolves immediately.
    :param prep_workers: Threads merging + dispatching batches
        concurrently.  On the array path the per-batch work is the numpy
        merge, the streamed-layout build, and the device uploads; on the
        frame fallback it is the full cold plan build (candidate
        resolution included).  Batch builds are independent (per-batch
        plans; the index's plan-cache map and launch counters are
        lock-guarded), so overlapping them raises aggregate throughput;
        results still resolve in dispatch order.
    :param gil_switch_interval: While the server is open, set Python's
        thread switch interval (``sys.setswitchinterval``) to this many
        seconds; ``close()`` restores the previous value.  A thread that
        hands work to the device in many small GIL-interleaved steps waits
        out the full switch interval behind the CPU-bound request-prep
        threads at each step.  ``None`` leaves the interpreter default
        untouched.  Process-global, like the GIL.
    """

    def __init__(
        self,
        index,
        alpha: float,
        cutoff: int,
        *,
        max_batch_queries: int = 512,
        max_wait_ms: float = 2.0,
        refine: "int | None" = None,
        pipeline_depth: int = 4,
        prep_workers: int = 2,
        gil_switch_interval: "float | None" = 0.0005,
    ) -> None:
        if cutoff < 1:
            raise ValueError("cutoff must be positive.")
        if max_batch_queries < 1:
            raise ValueError("max_batch_queries must be positive.")
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be positive.")
        if prep_workers < 1:
            raise ValueError("prep_workers must be positive.")
        self._index = index
        self._alpha = alpha
        self._cutoff = cutoff
        self._refine = refine
        self._depth = pipeline_depth
        self._max_q = max_batch_queries
        self._max_wait_s = max_wait_ms / 1000.0
        self._queue: "queue.SimpleQueue[_Request | None]" = queue.SimpleQueue()
        self._prev_switch_interval: "float | None" = None
        if gil_switch_interval is not None:
            self._prev_switch_interval = sys.getswitchinterval()
            sys.setswitchinterval(gil_switch_interval)
        self._seq = 0
        self._seq_lock = threading.Lock()
        self._closed = False
        self._prep = ThreadPoolExecutor(
            max_workers=prep_workers, thread_name_prefix="ff-batch-prep"
        )
        # separate pool for per-request resolution: batch dispatches (in
        # self._prep) BLOCK on these futures, so sharing one pool could
        # deadlock with every worker stuck in a dispatch waiting on a
        # prep task queued behind it
        self._resolve_pool = ThreadPoolExecutor(
            max_workers=max(2, prep_workers),
            thread_name_prefix="ff-request-prep",
        )
        self._worker = threading.Thread(
            target=self._serve_loop, name="ff-batching-server", daemon=True
        )
        self._worker.start()

    # -- client API ----------------------------------------------------------

    def submit(self, ranking: Ranking) -> "Future[Ranking]":
        """Enqueue one request; its future resolves to the served ranking.

        :param ranking: The ranking to re-rank (queries must be attached).
        :raises ValueError: When the ranking has no queries attached.
        :raises RuntimeError: When the server is closed.
        :return: A future yielding ``index.serve(ranking, alpha, cutoff)``.
        """
        if not ranking.has_queries:
            raise ValueError("Input ranking has no queries attached.")
        # the closed-check and the put are atomic vs close() (which flips
        # _closed under the same lock before enqueuing the sentinel), so a
        # request is either enqueued ahead of the sentinel — and served by
        # the drain — or rejected here; no future can be left pending
        with self._seq_lock:
            if self._closed:
                raise RuntimeError("BatchingServer is closed.")
            tag = f"{self._seq:012d}"
            self._seq += 1
            # per-request candidate resolution runs in the resolver pool,
            # overlapping the batching wait — submit() itself stays
            # instant so simultaneous requests coalesce into FULL batches
            # (prep on the submit path stretched the arrival window past
            # max_wait_ms and fragmented batches).  Resolution failures
            # (e.g. unknown IDs) fall back to the frame path, which
            # surfaces the same exception on the future.
            req = _Request(
                ranking,
                tag,
                self._resolve_pool.submit(self._safe_prep, ranking),
            )
            self._queue.put(req)
        return req.future

    def _safe_prep(self, ranking: Ranking):
        try:
            return self._index._serve_prep(ranking)
        except Exception:  # noqa: BLE001 - frame fallback raises it properly
            return None

    def serve(self, ranking: Ranking) -> Ranking:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(ranking).result()

    def close(self) -> None:
        """Drain pending requests, then stop the worker thread."""
        with self._seq_lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)
        self._worker.join()
        if self._prev_switch_interval is not None:
            sys.setswitchinterval(self._prev_switch_interval)
        # defense in depth: the lock above makes submit-vs-close atomic
        # (no request can land after the sentinel), but fail anything
        # unexpected rather than leaving a future forever pending
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is not None and req.future.set_running_or_notify_cancel():
                req.future.set_exception(
                    RuntimeError("BatchingServer is closed.")
                )

    def __enter__(self) -> "BatchingServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- worker --------------------------------------------------------------

    def _collect_batch(self, first: "_Request | None") -> "list[_Request] | None":
        """Block for the first request, then gather more until the batch is
        full or ``max_wait_ms`` elapses.  ``None`` -> shutdown."""
        if first is None:
            first = self._queue.get()
            if first is None:
                return None
        batch = [first]
        n_q = len(first.ranking.q_ids)
        deadline = monotonic() + self._max_wait_s
        while n_q < self._max_q:
            timeout = deadline - monotonic()
            if timeout <= 0:
                break
            try:
                req = self._queue.get(timeout=timeout)
            except queue.Empty:
                break
            if req is None:  # propagate shutdown after this batch
                self._queue.put(None)
                break
            batch.append(req)
            n_q += len(req.ranking.q_ids)
        return batch

    def _serve_loop(self) -> None:
        # pending holds (batch, prep_future); the prep pool merges the
        # batch and builds/dispatches its serve plan off this thread, so
        # batch i+1's (cold, host-dominated) plan build overlaps batch
        # i's device execution and result fetch
        pending: "deque[tuple[list[_Request], Future]]" = deque()
        carry: "_Request | None" = None
        while True:
            batch = self._collect_batch(carry)
            carry = None
            if batch is None:
                while pending:
                    self._resolve(*pending.popleft())
                self._prep.shutdown(wait=False)
                self._resolve_pool.shutdown(wait=False)
                return
            pending.append((batch, self._prep.submit(self._dispatch, batch)))
            while len(pending) >= self._depth:
                self._resolve(*pending.popleft())
            # opportunistic immediate drain when no request is waiting:
            # latency matters more than pipeline depth on an idle server
            while pending:
                try:
                    carry = self._queue.get_nowait()
                except queue.Empty:
                    self._resolve(*pending.popleft())
                    continue
                if carry is None:  # propagate shutdown after the drain
                    while pending:
                        self._resolve(*pending.popleft())
                    self._queue.put(None)
                    carry = None
                break

    def _dispatch(self, batch: "list[_Request]"):
        """Dispatch one batch: array path when every request pre-resolved,
        else the namespaced frame-merge path."""
        try:
            for req in batch:
                req.prep = req.prep_future.result()
            if all(req.prep is not None for req in batch):
                preps = [req.prep for req in batch]
                finish = self._index._serve_arrays(
                    preps, self._alpha, self._cutoff, refine=self._refine
                )
                if finish is not None:
                    return ("arrays", finish)
            return ("frames", self._dispatch_merged(batch))
        except Exception as exc:  # noqa: BLE001 - fan the failure out
            for req in batch:
                if not req.future.set_running_or_notify_cancel():
                    continue
                req.future.set_exception(exc)
            return None

    def _dispatch_merged(self, batch: "list[_Request]"):
        """Merge the batch into one namespaced ranking and dispatch it."""
        try:
            # request frames are individually (q_id desc, score desc)-sorted
            # (the Ranking ctor invariant) and the fixed-width tag prefix
            # dominates the namespaced q_id sort — so concatenating in
            # tag-DESCENDING order yields an already-sorted merged frame and
            # the trusted ctor skips the O(B log B) re-sort.  Namespacing
            # renames CATEGORIES (a handful of strings per request), never
            # rows, so the merge is O(pairs) pointer/code copies
            qid_parts, col_parts = [], {"id": [], "score": [], "query": []}
            for req in sorted(batch, key=lambda r: r.tag, reverse=True):
                df = req.ranking._df
                qid = df["q_id"]
                cat = (
                    qid.array
                    if isinstance(qid.dtype, pd.CategoricalDtype)
                    else pd.Categorical(qid)
                )
                qid_parts.append(
                    cat.rename_categories(
                        req.tag + _SEP + cat.categories.astype(str)
                    )
                )
                for col, parts in col_parts.items():
                    parts.append(df[col])
            merged = Ranking._from_trusted_frame(
                pd.DataFrame(
                    {
                        "q_id": union_categoricals(qid_parts),
                        **{c: _concat_col(p) for c, p in col_parts.items()},
                    }
                ),
                None,
            )
            LOGGER.debug(
                "dispatching batch: %d requests, %d queries, %d pairs",
                len(batch),
                len(merged.q_ids),
                len(merged),
            )
            return self._index.submit_serve(
                merged, self._alpha, self._cutoff, refine=self._refine
            )
        except Exception as exc:  # noqa: BLE001 - fan the failure out
            for req in batch:
                if not req.future.set_running_or_notify_cancel():
                    continue
                req.future.set_exception(exc)
            return None

    def _resolve(self, batch: "list[_Request]", prep_future) -> None:
        """Fetch the batch result and split it back per request."""
        try:
            dispatched = prep_future.result()
            if dispatched is None:  # _dispatch already errored the batch
                return
            kind, payload = dispatched
            if payload is None:  # inner dispatch already errored the batch
                return
            if kind == "arrays":
                self._fanout_arrays(batch, payload())
                return
            served = payload.result()
            df = _plain_ids(served._df)
            if len(df):
                parts = df["q_id"].str.split(_SEP, n=1, expand=True)
                tags = parts[0].to_numpy()
                out = df.assign(q_id=parts[1])
            else:
                tags = np.empty(0, dtype=object)
                out = df
            # the served frame is q_id-descending over the namespaced IDs,
            # so each request's rows are contiguous: slice, don't groupby
            by_tag: dict[str, pd.DataFrame] = {}
            if len(tags):
                change = np.empty(len(tags), dtype=bool)
                change[0] = True
                np.not_equal(tags[1:], tags[:-1], out=change[1:])
                starts = np.flatnonzero(change)
                bounds = np.append(starts, len(tags))
                for i, start in enumerate(starts):
                    by_tag[tags[start]] = out.iloc[start : bounds[i + 1]]
            for req in batch:
                if not req.future.set_running_or_notify_cancel():
                    continue
                part = by_tag.get(req.tag)
                if part is None:
                    part = out.iloc[0:0]
                req.future.set_result(
                    Ranking._from_trusted_frame(
                        part.reset_index(drop=True), "fast-forward"
                    )
                )
        except Exception as exc:  # noqa: BLE001 - fan the failure out
            for req in batch:
                if not req.future.set_running_or_notify_cancel():
                    continue
                req.future.set_exception(exc)

    @staticmethod
    def _fanout_arrays(
        batch: "list[_Request]", packed: "tuple[np.ndarray, np.ndarray]"
    ) -> None:
        """Split an array-path result back per request.

        ``packed`` is ``Index._serve_arrays``'s ``(vals, pair_idx)``: row
        blocks follow the batch's request order (each request's queries
        q_id-descending), so the split is pure slicing — no namespace
        tags, no string splits, no groupby.  The result frame is built
        ONCE for the whole batch (the per-request numpy parts are tiny —
        ``cutoff`` rows per query) and sliced back out: one pandas ctor
        per batch instead of one per request.
        """
        vals, pair_idx = packed
        q_off = p_off = 0
        qid_parts, id_parts, score_parts, query_parts = [], [], [], []
        spans: "list[tuple[_Request, int, object]]" = []
        for req in batch:
            p = req.prep
            nq = len(p["q_uniques"])
            v = vals[q_off : q_off + nq]
            idx = pair_idx[q_off : q_off + nq]
            q_off += nq
            pair_base = p_off
            p_off += p["n_pairs"]
            valid = idx >= 0
            take = (idx[valid] - pair_base).astype(np.int64)
            n_per_row = valid.sum(axis=1)
            order = p["by_rank"]
            qid_parts.append(np.repeat(p["q_uniques"][order], n_per_row))
            id_parts.append(
                np.asarray(p["id_arr"].take(take), dtype=object)
            )
            score_parts.append(v[valid])
            query_parts.append(
                np.repeat(
                    np.asarray(p["queries"], dtype=object)[order],
                    n_per_row,
                )
            )
            spans.append((req, int(len(take)), p["score_dtype"]))
        big = pd.DataFrame(
            {
                "q_id": np.concatenate(qid_parts),
                "id": np.concatenate(id_parts),
                "score": np.concatenate(score_parts),
                "query": np.concatenate(query_parts),
            }
        )
        off = 0
        for req, n_rows, score_dtype in spans:
            part = big.iloc[off : off + n_rows]
            off += n_rows
            if not req.future.set_running_or_notify_cancel():
                continue
            df = part.reset_index(drop=True)
            if df.dtypes["score"] != score_dtype:
                df["score"] = df["score"].astype(score_dtype, copy=False)
            req.future.set_result(
                Ranking._from_trusted_frame(df, "fast-forward")
            )
