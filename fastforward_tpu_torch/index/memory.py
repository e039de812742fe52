"""In-memory index: a canonical store and a scoring table on the device.

The port of ``fastforward_tpu/index/memory.py``.  With ``store="host"`` the
canonical copy is one growable host array (vectors as added, or the
quantizer's codes), and the scoring copy is a zero-padded table on the
index's device, uploaded lazily in row chunks (``ops.upload``) and
invalidated on ``add``: ``(N_pad, dim)`` fp32 or bf16 vectors; int8 codes,
``(N_pad, dim/128, 128)`` when ``dim % 128 == 0``; or ``(N_pad, M)`` PQ
codes (uint8, or uint16/uint32 for Ks > 256) with their fp32 codebooks beside
them.  With ``hbm_budget`` a table
larger than the budget is served from the hybrid tier (a resident prefix
and a host tail streamed in blocks, ``ops.host_stream``).

With ``store="device"`` each ``add`` ships only its own rows into a growable
buffer on the device, which is the canonical copy and the scoring table at
once: nothing is mirrored on the host, and host reads fetch rows back.

With ``mesh_config`` the table is row-sharded over a mesh of devices
(``parallel``): the device store grows shard by shard, the hybrid tier's
budget is per device, and under several processes each process uploads
only its shards' rows; :meth:`InMemoryIndex.narrow_to_shard` then frees the
host rows outside them.

``preload(progressive=True)`` uploads a large dense fp32 table as two 16-bit
planes (:class:`_ProgressiveUpload`).
"""

import logging
import math
import threading
from collections.abc import Iterable, Iterator

import numpy as np
import torch

from fastforward_tpu_torch.device import resolve_device
from fastforward_tpu_torch.encoder.base import Encoder
from fastforward_tpu_torch.index.base import (
    DeviceView,
    IDSequence,
    Index,
    build_hybrid_view,
)
from fastforward_tpu_torch.index.mode import Mode
from fastforward_tpu_torch.ops.upload import (
    combine_lo,
    expand_hi,
    upload_into,
    upload_plane,
    upload_table,
)
from fastforward_tpu_torch.parallel.mesh import Mesh, MeshConfig, process_count
from fastforward_tpu_torch.parallel.multihost import put_replicated, put_row_sharded
from fastforward_tpu_torch.parallel.sharded import ShardedTable
from fastforward_tpu_torch.quantizer import PQ, Quantizer, ScalarQuantizer

LOGGER = logging.getLogger(__name__)

# device tables are padded to a multiple of this many rows (a multiple of
# the kernel's tile rows), so the layout changes only on growth
_ROW_PAD = 4096

# tables at or below this skip the progressive (split-plane) preload: the
# split pays only when the upload dominates the cold start
_MIN_PROGRESSIVE_BYTES = 512 << 20

_DEVICE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _padded_rows(num: int, mesh: "Mesh | None" = None) -> int:
    """Rows of a table of ``num`` rows: a multiple of ``_ROW_PAD`` (and of
    the shard count on a mesh)."""
    step = _ROW_PAD if mesh is None else math.lcm(_ROW_PAD, mesh.shape["shard"])
    return -(-num // step) * step


def _check_sharded_width(width: int, quantizer) -> None:
    """Sharded vector and int8 tables need whole 128-lane rows.

    :raises ValueError: Otherwise (as ``fastforward_tpu`` does).
    """
    if not isinstance(quantizer, PQ) and width % 128:
        raise ValueError(f"Sharded tables require dim % 128 == 0 (got {width}); pad the embeddings.")


def _sync(device: torch.device) -> None:
    """Wait for the work queued on ``device``'s current stream."""
    if device.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        done.synchronize()


class _ProgressiveUpload:
    """One split-plane upload of a dense fp32 host-store table.

    :meth:`upload_hi` ships the high 16-bit planes (half the table's bytes);
    :meth:`activate` expands them into the truncated fp32 table, installs it
    as the serving view and starts a daemon thread that ships the low
    planes and swaps in the exact table (``ops.upload.combine_lo``; on an
    out-of-memory error, a fresh ``upload_table`` of the exact rows).

    Each swap checks the index's generation under its view lock, which
    ``add`` takes to bump it, so a table of rows an ``add`` has changed is
    never installed.  The table being replaced is never written: calls in
    flight keep reading it.
    """

    def __init__(self, index: "InMemoryIndex") -> None:
        self._index = index
        self._gen = index._table_gen
        self._host = index._store[: index._num]  # no padded host copy
        self._n_pad = -(-index._num // _ROW_PAD) * _ROW_PAD
        self._hi: "torch.Tensor | None" = None

    def upload_hi(self) -> None:
        """Ship the hi planes and wait for them to land."""
        device = self._index._device
        self._hi = upload_plane(self._host, "hi", device, total_rows=self._n_pad)
        _sync(device)

    def activate(self) -> bool:
        """Install the truncated fp32 table and start the exact tail.

        :return: Whether the interim table was installed (``False`` when an
            ``add`` overlapped the upload, or the hi planes are missing).
        """
        index = self._index
        if self._hi is None:
            return False
        trunc = expand_hi(self._hi)
        self._hi = None  # the truncated table holds the plane's bits
        _sync(index._device)
        with index._view_lock:
            if index._table_gen != self._gen:
                LOGGER.warning("progressive preload overlapped an add(); discarding")
                self._host = None
                return False
            index._dev_view = DeviceView("dense", trunc, precision=index._precision)
            thread = threading.Thread(
                target=self._exact_tail, args=(trunc,), name="ff-progressive-lo", daemon=True
            )
            index._progressive_thread = thread
        thread.start()
        return True

    def _exact_tail(self, trunc: torch.Tensor) -> None:
        """Fold the lo planes in and swap the exact table into the view."""
        index = self._index
        device = index._device
        try:
            try:
                lo = upload_plane(self._host, "lo", device, total_rows=self._n_pad)
                full = combine_lo(trunc, lo)
                del lo
            except torch.OutOfMemoryError:
                LOGGER.warning(
                    "no device memory for the split-plane exact table; uploading "
                    "the exact fp32 table instead", exc_info=True,
                )
                del trunc  # the serving view still holds it: old + new table
                full = upload_table(
                    self._host, device, shape=(self._n_pad, self._host.shape[1]),
                    dtype=torch.float32,
                )
            _sync(device)
            with index._view_lock:
                if index._table_gen != self._gen:
                    LOGGER.warning("progressive exact table overlapped an add(); discarding")
                    return
                index._dev_view = DeviceView("dense", full, precision=index._precision)
                stats = index._preload_stats
                if stats is not None:
                    stats["progressive_exact"] = True
            LOGGER.info("progressive preload: exact fp32 table installed")
        finally:
            self._host = None


class InMemoryIndex(Index):
    """Fast-Forward index held in memory (canonical store on the host or the
    device, scoring table on the device)."""

    def __init__(
        self,
        query_encoder: Encoder | None = None,
        quantizer: Quantizer | None = None,
        mode: Mode = Mode.MAXP,
        encoder_batch_size: int = 32,
        init_size: int = 2**16,
        alloc_size: int = 2**16,
        device_dtype: str = "float32",
        mesh_config: "MeshConfig | None" = None,
        precision: str = "exact",
        store: str = "host",
        hbm_budget: int | None = None,
        stream_chunk_rows: int | None = None,
        score_transport: str = "f32",
        device: "str | torch.device | None" = None,
    ) -> None:
        """Create an in-memory index.

        :param query_encoder: The query encoder to use.
        :param quantizer: ``ScalarQuantizer``, ``PQ`` or ``OPQ`` (trained);
            vectors are stored as its codes.
        :param mode: The ranking mode.
        :param encoder_batch_size: Batch size for the query encoder.
        :param init_size: Initially allocated capacity (number of vectors).
        :param alloc_size: Capacity growth granularity (number of vectors).
        :param device_dtype: Dtype of the device scoring table
            (``"float32"`` or ``"bfloat16"``; ignored for quantized indexes).
            With ``store="device"`` the device buffer is the canonical copy,
            so bf16 rounds the stored vectors themselves.
        :param mesh_config: When set, the table is row-sharded over a mesh
            of devices (``parallel.MeshConfig``; its default devices follow
            ``device``: the cards, or CPU slots) and scoring runs the
            sharded programs; dense and int8 tables need ``dim % 128 ==
            0``.
        :param precision: ``"exact"`` or ``"high"`` (true fp32 dots) or
            ``"fast"`` (bf16-rounded operands, fp32 accumulation); PQ
            tables at dense tiles take K4's tiers (``"high"`` rounds the
            codewords to bf16).
        :param store: ``"host"`` keeps the canonical copy in host RAM and
            uploads a scoring copy; ``"device"`` appends each ``add``
            straight into a growable device buffer (host memory O(batch));
            pre-size it with ``init_size`` to avoid regrowth copies.
        :param hbm_budget: Scoring-memory budget in bytes (``store="host"``;
            dense, int8 or PQ tables).  A table larger than it is served
            from the hybrid tier: 70% of the budget holds a device-resident
            prefix, the rest caches tail blocks streamed from host RAM, and
            each call adds two blocks in flight and the kernels' scratch
            (``build_hybrid_view``).  ``None``: the whole table goes to the
            device.
        :param stream_chunk_rows: Rows of a streamed tail block (default
            ``ops.host_stream.HOST_CHUNK_ROWS``).
        :param score_transport: ``"f32"`` (exact scores) or ``"u16"``
            (the re-rank path copies 16-bit codes of the scores: half the
            bytes, at most ``score_range / 131070`` added to each score).
        :param device: Torch device of the scoring table; ``None`` means
            ``"cuda"``.
        :raises ValueError: On ``store="device"`` with ``hbm_budget``; on a
            mesh with more devices than exist; under several processes, on
            ``store="device"`` or ``hbm_budget`` with ``mesh_config``.
        :raises RuntimeError: When the device is CUDA and none is available.
        """
        if store not in ("host", "device"):
            raise ValueError(f"store must be 'host' or 'device', got {store!r}")
        if store == "device" and mesh_config is not None and process_count() > 1:
            raise ValueError(
                "store='device' is not supported under several processes: the "
                "growable device buffer is process-local.  Use store='host' (each "
                "process uploads its shards' rows when the view is built)."
            )
        if hbm_budget is not None and mesh_config is not None and process_count() > 1:
            raise ValueError(
                "hbm_budget + mesh_config (the sharded hybrid tier) is single-process: "
                "the tail beyond device memory streams host->device per call, and "
                "every process would stream the same tail rows in lockstep.  Shard "
                "the whole table instead (quantize it to fit the devices, then "
                "narrow_to_shard() frees each host's other rows), or use an "
                "OnDiskIndex with mesh_config (per-shard HDF5 reads)."
            )
        if hbm_budget is not None and store == "device":
            raise ValueError(
                "hbm_budget requires store='host' (the hybrid tier streams from "
                "the host canonical copy)"
            )
        if device_dtype not in _DEVICE_DTYPES:
            raise ValueError(
                f"device_dtype must be 'float32' or 'bfloat16', got {device_dtype!r}"
            )
        if precision not in ("exact", "high", "fast"):
            raise ValueError(
                f"precision must be 'exact', 'high' or 'fast', got {precision!r}"
            )
        if store == "device" and device_dtype == "bfloat16":
            LOGGER.warning(
                "store='device' with device_dtype='bfloat16' stores the canonical "
                "vectors in bf16: reads, iteration and quantizer fits see rounded "
                "values (store='host' keeps an fp32 canonical copy)"
            )
        self._device = resolve_device(device)
        self._mesh_config = mesh_config
        # the mesh, built once (its default devices follow self._device)
        self._mesh: "Mesh | None" = mesh_config.build(device=self._device) if mesh_config else None
        # the canonical row band kept after narrow_to_shard (None: all rows)
        self._narrow: "tuple[int, int] | None" = None
        self._store_mode = store
        self._hbm_budget = hbm_budget
        self._stream_chunk_rows = stream_chunk_rows
        self._store: np.ndarray | None = None
        self._dev_table: torch.Tensor | None = None  # growable buffer (store="device")
        self._dev_width: int | None = None
        self._num = 0
        self._init_size = init_size
        self._alloc_size = alloc_size
        self._device_dtype = device_dtype
        self._precision = precision
        self._dev_view: DeviceView | None = None
        # one upload when several threads (a server's resolver pool, the
        # preload warms) ask for the table at once; add() takes it too, so a
        # progressive swap never installs a table of rows an add changed
        self._view_lock = threading.Lock()
        # bumped by every add(): in-flight progressive uploads compare it
        self._table_gen = 0
        super().__init__(
            query_encoder=query_encoder,
            quantizer=quantizer,
            mode=mode,
            encoder_batch_size=encoder_batch_size,
            score_transport=score_transport,
        )

    # -- storage -------------------------------------------------------------

    def _get_num_vectors(self) -> int:
        return self._num

    def _get_internal_dim(self) -> int | None:
        if self._store_mode == "device":
            return self._dev_width if self._dev_table is not None else None
        if self._store is None:
            return None
        return self._store.shape[1]

    def _grow_to(self, capacity: int, dim: int, dtype: np.dtype) -> None:
        """Ensure the host store has room for ``capacity`` vectors."""
        if self._store is None:
            cap = max(self._init_size, capacity)
            self._store = np.zeros((cap, dim), dtype=dtype)
            return
        cur = self._store.shape[0]
        if capacity <= cur:
            return
        extra = -(-(capacity - cur) // self._alloc_size) * self._alloc_size
        LOGGER.debug("growing host store from %s to %s rows", cur, cur + extra)
        grown = np.zeros((cur + extra, self._store.shape[1]), self._store.dtype)
        grown[: self._num] = self._store[: self._num]
        self._store = grown

    def _add(
        self, vectors: np.ndarray, doc_ids: IDSequence, psg_ids: IDSequence
    ) -> None:
        num_new = vectors.shape[0]
        if self._narrow is not None:
            raise RuntimeError(
                "cannot add to a narrowed index: shard row boundaries move with N "
                "(narrow_to_shard is a step after the build)"
            )
        with self._view_lock:
            start = self._num
            self._ids.add(doc_ids, psg_ids, start)
            if self._store_mode == "device":
                self._append_device(vectors, start)
            else:
                self._grow_to(start + num_new, vectors.shape[1], vectors.dtype)
                self._store[start : start + num_new] = vectors
            self._num += num_new
            self._dev_view = None  # the device table is stale
            self._table_gen += 1  # and so is any progressive upload in flight

    def consolidate(self) -> None:
        """Trim the host store to exactly the used capacity (no-op for
        ``store="device"``: the device buffer stays padded to the scoring
        row granularity) and after :meth:`narrow_to_shard` (the store is the
        shard band already)."""
        if self._store is not None and self._narrow is None:
            self._store = self._store[: self._num].copy()

    def narrow_to_shard(self) -> tuple[int, int]:
        """Free the host rows outside this process's shards.

        Under several processes every process ``add``s the whole corpus, so
        each host holds the whole canonical table while its devices score
        only their shards.  Once the sharded view is built (``preload()``),
        this drops the other rows: each host then keeps about ``1 /
        processes`` of the table.  Host reads (:meth:`_get_vectors`)
        serve only the kept rows and raise for others, iteration and
        ``add`` raise; device scoring is unaffected.

        :raises ValueError: Without a mesh-sharded resident view (the
            hybrid tier streams from the whole host copy).
        :return: The kept row range ``(start, stop)``.
        """
        if self._store_mode != "host" or self._store is None:
            raise ValueError("narrow_to_shard requires store='host' with vectors added")
        view = self._device_view()
        if view is None or view.mesh is None or view.kind == "hybrid":
            raise ValueError(
                "narrow_to_shard requires a mesh-sharded resident device view "
                "(configure mesh_config and call preload() first); the hybrid tier "
                "streams from the whole host copy and cannot narrow"
            )
        if self._narrow is not None:
            return self._narrow
        lo, hi = view.table.row_band()
        start, stop = min(lo, self._num), min(hi, self._num)
        before = self._store.nbytes
        self._store = np.ascontiguousarray(self._store[start:stop])
        self._narrow = (start, stop)
        LOGGER.info(
            "narrowed the host store to rows [%d, %d): %.1f -> %.1f MiB",
            start, stop, before / 2**20, self._store.nbytes / 2**20,
        )
        return self._narrow

    # -- the device store (store="device") -------------------------------------

    def _device_layout(self, width: int) -> tuple[tuple[int, ...], torch.dtype]:
        """Row shape and dtype of the growable device buffer (the scoring
        table's layout)."""
        if isinstance(self._quantizer, PQ):
            # the quantizer's code type: uint8, uint16 or uint32 by Ks
            return (width,), torch.from_numpy(np.empty(0, self._quantizer.dtype)).dtype
        if self._mesh is not None:
            _check_sharded_width(width, self._quantizer)
        if isinstance(self._quantizer, ScalarQuantizer):
            return ((width // 128, 128) if width % 128 == 0 else (width,)), torch.int8
        return (width,), _DEVICE_DTYPES[self._device_dtype]

    def _append_device(self, data: np.ndarray, start: int) -> None:
        """Write the new rows straight into the growable device buffer.

        Only these rows cross the link; growth reallocates on the device
        (transiently both buffers).
        """
        n_new, width = data.shape
        row_shape, dtype = self._device_layout(width)
        self._dev_width = width
        need = start + n_new
        host_dtype = np.float32 if self._quantizer is None else None
        if self._mesh is not None:
            self._append_sharded(data, start, need, row_shape, dtype, host_dtype)
            return
        if self._dev_table is None:
            cap = -(-max(self._init_size, need) // _ROW_PAD) * _ROW_PAD
            self._dev_table = torch.zeros((cap, *row_shape), dtype=dtype, device=self._device)
        elif need > self._dev_table.shape[0]:
            cur = self._dev_table.shape[0]
            extra = -(-(need - cur) // self._alloc_size) * self._alloc_size
            cap = -(-(cur + extra) // _ROW_PAD) * _ROW_PAD
            LOGGER.debug("growing device store from %s to %s rows", cur, cap)
            grown = torch.zeros((cap, *row_shape), dtype=dtype, device=self._device)
            grown[:cur] = self._dev_table
            self._dev_table = grown
        upload_into(self._dev_table, data, start, stage_dtype=host_dtype)

    def _append_sharded(self, data, start, need, row_shape, dtype, host_dtype) -> None:
        """The device store on a mesh: a row-sharded buffer; growth moves
        the rows to their new shards device to device."""
        table = self._dev_table
        if table is None or need > table.shape[0]:
            cur = 0 if table is None else table.shape[0]
            if table is None:
                cap = max(self._init_size, need)
            else:
                cap = cur + -(-(need - cur) // self._alloc_size) * self._alloc_size
            grown = ShardedTable.zeros(self._mesh, (_padded_rows(cap, self._mesh), *row_shape), dtype)
            if table is not None:
                LOGGER.debug("growing the sharded device store from %s to %s rows", cur, grown.shape[0])
                for s in table.local_shards():
                    grown.write_rows(s * table.n_local, table.shard(s))
            self._dev_table = table = grown
        table.write_rows(start, data, stage_dtype=host_dtype)

    def _fetch_device_rows(self, rows: np.ndarray) -> np.ndarray:
        """Rows of the device store on the host, ``(n, width)`` (bf16 as
        fp32)."""
        if isinstance(self._dev_table, ShardedTable):
            sub = self._dev_table.take_rows(rows)
        else:
            idx = torch.from_numpy(np.ascontiguousarray(rows, dtype=np.int64)).to(self._device)
            sub = self._dev_table[idx]
        if sub.dtype == torch.bfloat16:
            sub = sub.float()
        return sub.cpu().numpy().reshape(rows.shape[0], -1)

    # -- host reads ----------------------------------------------------------

    def _get_vectors(self, ids: Iterable[str]) -> tuple[np.ndarray, list[str]]:
        ids = list(ids)
        rows, counts = self._ids.resolve(ids, self.mode)
        if rows.shape[0] == 0:
            return np.array([]), []
        out_ids = [i for i, c in zip(ids, counts) for _ in range(c)]
        if self._store_mode == "device":
            return self._fetch_device_rows(rows), out_ids
        if self._narrow is not None:
            start, stop = self._narrow
            if rows.size and (rows.min() < start or rows.max() >= stop):
                raise IndexError(
                    f"host row read outside this process's shard band [{start}, {stop}): "
                    "the host store was narrowed by narrow_to_shard(); only device "
                    "scoring covers the whole corpus"
                )
            return self._store[rows - start], out_ids
        return self._store[rows], out_ids

    def _batch_iter(
        self, batch_size: int
    ) -> Iterator[tuple[np.ndarray, IDSequence, IDSequence]]:
        if self._narrow is not None:
            raise RuntimeError(
                "cannot iterate a narrowed index: the host store holds only this "
                "process's shard band (narrow_to_shard)"
            )
        doc_list, psg_list = self._ids.inverse(self._num)
        for i in range(0, self._num, batch_size):
            j = min(i + batch_size, self._num)
            if self._store_mode == "device":
                batch = self._fetch_device_rows(np.arange(i, j))
            else:
                batch = self._store[i:j]
            yield batch, doc_list[i:j], psg_list[i:j]

    # -- device table --------------------------------------------------------

    def _device_view(self) -> DeviceView | None:
        if self._num == 0:
            return None
        view = self._dev_view
        if view is not None:
            return view
        with self._view_lock:
            if self._dev_view is None:
                self._dev_view = self._build_view()
            return self._dev_view

    def _build_view(self) -> DeviceView:
        """The device view of the store: the device buffer itself
        (``store="device"``), a hybrid view when the table exceeds
        ``hbm_budget``, else an upload of the host store."""
        if self._store_mode == "device":
            return device_view(self._dev_table, self._quantizer, self._precision, mesh=self._mesh)
        data = self._store[: self._num]
        if self._hbm_budget is not None:
            view = self._hybrid_view(data)
            if view is not None:
                return view
        return build_view(
            data,
            self._quantizer,
            self._device,
            precision=self._precision,
            device_dtype=self._device_dtype,
            mesh=self._mesh,
        )

    def _hybrid_view(self, data: np.ndarray) -> DeviceView | None:
        """The hybrid tier's view of ``data``, or ``None`` when the table fits
        the budget (``build_hybrid_view``)."""
        return hybrid_view(
            data, self._quantizer, self._device, self._hbm_budget, self._precision,
            self._stream_chunk_rows, self._device_dtype, mesh=self._mesh,
        )

    def _progressive_job(self) -> "_ProgressiveUpload | None":
        """The split-plane upload job, for dense fp32 host-store tables above
        ``_MIN_PROGRESSIVE_BYTES`` without a budget and not yet uploaded;
        ``None`` otherwise."""
        if (
            self._num == 0
            or self._dev_view is not None
            or self._store_mode != "host"
            or self._mesh is not None
            or self._hbm_budget is not None
            or self._quantizer is not None
            or self._device_dtype != "float32"
            or self._store.dtype != np.float32
            or self._store[: self._num].nbytes <= _MIN_PROGRESSIVE_BYTES
        ):
            return None
        return _ProgressiveUpload(self)


def hybrid_view(
    data: np.ndarray,
    quantizer: "Quantizer | None",
    device: torch.device,
    hbm_budget: int,
    precision: str,
    chunk_rows: "int | None" = None,
    device_dtype: str = "float32",
    mesh: "Mesh | None" = None,
) -> DeviceView | None:
    """The hybrid view of stored rows (vectors or the quantizer's codes), or
    ``None`` when the table fits ``hbm_budget`` or its dimensionality is not
    a multiple of 128 (vectors and int8 codes; a warning says so).  With
    ``mesh`` the budget is per device and the prefix row-shards.
    """
    num, width = data.shape
    kwargs = dict(chunk_rows=chunk_rows, mesh=mesh)
    if isinstance(quantizer, PQ):
        kwargs.update(kind="pq", codebooks=np.asarray(quantizer.codewords, dtype=np.float32))
        dim = quantizer.dims[0]
    else:
        dim = width
        if mesh is not None:
            _check_sharded_width(dim, quantizer)
        if dim % 128:
            LOGGER.warning(
                "hbm_budget is ignored: the hybrid tier needs dim %% 128 == 0 (got %d); "
                "the whole table goes to the device", dim,
            )
            return None
        if isinstance(quantizer, ScalarQuantizer):
            kwargs.update(kind="scalar", scales=quantizer.scales)
        else:
            kwargs.update(bf16=device_dtype == "bfloat16")
    return build_hybrid_view(data, num, dim, hbm_budget, precision, device, **kwargs)


def device_view(
    table: "torch.Tensor | ShardedTable",
    quantizer: "Quantizer | None",
    precision: str,
    mesh: "Mesh | None" = None,
) -> DeviceView:
    """The view of a device buffer already laid out as a scoring table
    (row-sharded over ``mesh`` when it is set; PQ codebooks are then
    replicated)."""
    if isinstance(quantizer, PQ):
        codebooks = np.array(quantizer.codewords, dtype=np.float32)
        cb = put_replicated(mesh, codebooks) if mesh is not None else torch.from_numpy(codebooks).to(table.device)
        return DeviceView("pq", table, precision=precision, codebooks=cb, mesh=mesh)
    if isinstance(quantizer, ScalarQuantizer):
        return DeviceView("scalar", table, precision=precision, scales=quantizer.scales, mesh=mesh)
    return DeviceView("dense", table, precision=precision, mesh=mesh)


def build_view(
    data: np.ndarray,
    quantizer: "Quantizer | None",
    device: torch.device,
    precision: str = "exact",
    device_dtype: str = "float32",
    mesh: "Mesh | None" = None,
) -> DeviceView:
    """The device view of stored rows (vectors as added, or the
    quantizer's codes), zero-padded to a multiple of ``_ROW_PAD`` rows (and
    row-sharded over ``mesh`` when it is set):
    ``(N_pad, M)`` PQ codes of the quantizer's type (uint8, uint16 or
    uint32) with their fp32 codebooks; int8 codes, ``(N_pad, dim/128, 128)``
    when the lanes divide; or ``(N_pad, dim)`` vectors in ``device_dtype``.

    :raises ValueError: On a mesh, for vectors or int8 codes whose
        dimensionality is not a multiple of 128.
    """
    n_pad = _padded_rows(data.shape[0], mesh)
    width = data.shape[1]
    if mesh is not None:
        _check_sharded_width(width, quantizer)

        def place(shape, dtype=None, stage_dtype=None):
            return put_row_sharded(mesh, data, shape=shape, dtype=dtype, stage_dtype=stage_dtype)
    else:

        def place(shape, dtype=None, stage_dtype=None):
            return upload_table(data, device, shape=shape, dtype=dtype, stage_dtype=stage_dtype)

    if isinstance(quantizer, PQ):
        # compact (N_pad, M) codes; the fp32 codebooks stay in L2
        table = place((n_pad, width))
    elif isinstance(quantizer, ScalarQuantizer):
        # 3D int8 layout when the lanes divide (the streamed kernels'
        # table form); the scales fold into the queries
        shape = (n_pad, width // 128, 128) if width % 128 == 0 else (n_pad, width)
        table = place(shape, dtype=torch.int8)
    else:
        table = place((n_pad, width), dtype=_DEVICE_DTYPES[device_dtype], stage_dtype=np.float32)
    return device_view(table, quantizer, precision, mesh=mesh)
