"""On-disk index tier: an HDF5 store, format-compatible with the JAX package.

The port of ``fastforward_tpu/index/disk.py``.  The file layout is the JAX
package's, which is the reference's (datasets ``vectors``/``doc_ids``/
``psg_ids``, attrs ``num_vectors``/``ff_version``, the quantizer's state
under ``quantizer/{meta,attributes,data}``), so a file written by either
package loads in the other.

Scoring without ``hbm_cache`` reads the candidates' rows on the host per
call (sorted HDF5 fancy indexing, or per-chunk memory maps) and uploads
them to the index's device for that call (``Index._gather_view``); the
scoring itself runs there.  ``hbm_cache=True`` uploads the whole table to
the index's device once (as ``InMemoryIndex`` lays it out), or with
``hbm_budget`` its hybrid view (a resident prefix and a host tail streamed
in blocks), while the HDF5 file stays canonical; ``to_memory()`` copies the
index into an ``InMemoryIndex``.

The file is read and written by the port's own codec (``h5file``), which
handles the part of HDF5 this layout uses as h5py writes it; the port
never imports h5py.
"""

import logging
import threading
from collections.abc import Iterable, Iterator
from pathlib import Path

import numpy as np
import torch

import fastforward_tpu_torch
from fastforward_tpu_torch.device import resolve_device
from fastforward_tpu_torch.encoder.base import Encoder
from fastforward_tpu_torch.index import h5file
from fastforward_tpu_torch.index.base import DeviceView, IDSequence, Index
from fastforward_tpu_torch.index.memory import (
    InMemoryIndex,
    _padded_rows,
    build_view,
    device_view,
    hybrid_view,
)
from fastforward_tpu_torch.index.mode import Mode
from fastforward_tpu_torch.parallel.mesh import MeshConfig, process_count
from fastforward_tpu_torch.quantizer import PQ, Quantizer, ScalarQuantizer

LOGGER = logging.getLogger(__name__)


def _check_options(precision: str, mesh_config, hbm_budget) -> None:
    if precision not in ("exact", "high", "fast"):
        raise ValueError(f"precision must be 'exact', 'high' or 'fast', got {precision!r}")
    if hbm_budget is not None and mesh_config is not None and process_count() > 1:
        raise ValueError(
            "hbm_budget + mesh_config (the sharded hybrid tier) is single-process "
            "only: the host tail streams through this process's devices.  Several "
            "processes shard the whole table instead (each reads its shards' rows "
            "from HDF5)."
        )


class OnDiskIndex(Index):
    """Fast-Forward index backed by an HDF5 file on disk."""

    def __init__(
        self,
        index_file: Path,
        query_encoder: Encoder | None = None,
        quantizer: Quantizer | None = None,
        mode: Mode = Mode.MAXP,
        encoder_batch_size: int = 32,
        init_size: int = 2**16,
        chunk_size: int = 2**16,
        max_id_length: int = 8,
        overwrite: bool = False,
        memory_mapped: bool = False,
        max_indexing_size: int = 2**10,
        hbm_cache: bool = False,
        precision: str = "exact",
        mesh_config: "MeshConfig | None" = None,
        hbm_budget: int | None = None,
        stream_chunk_rows: int | None = None,
        score_transport: str = "f32",
        device: "str | torch.device | None" = None,
    ) -> None:
        """Create an index on disk.

        :param index_file: The index file to create (or overwrite).
        :param query_encoder: The query encoder.
        :param quantizer: The quantizer to use.
        :param mode: The ranking mode.
        :param encoder_batch_size: Batch size for the query encoder.
        :param init_size: Initial allocation (number of vectors).
        :param chunk_size: HDF5 chunk size (number of vectors).
        :param max_id_length: Maximum ID length in bytes (UTF-8).
        :param overwrite: Overwrite an existing file.
        :param memory_mapped: Read vectors through per-chunk memory maps.
        :param max_indexing_size: Maximum rows per HDF5 fancy-indexing read.
        :param hbm_cache: Upload the full table to the index's device on
            the first scoring call (invalidated by ``add``).
        :param precision: Scoring precision tier (see ``InMemoryIndex``).
        :param mesh_config: With ``hbm_cache``, row-shard the table over a
            mesh of devices (see ``InMemoryIndex``); under several processes
            each reads only its shards' rows from the file.
        :param hbm_budget: With ``hbm_cache``, the scoring-memory budget in
            bytes: a larger table is served from the hybrid tier (a
            resident prefix and a host tail streamed in blocks, see
            ``InMemoryIndex``).
        :param stream_chunk_rows: Rows of a streamed tail block.
        :param score_transport: ``"f32"`` or ``"u16"`` (see
            ``InMemoryIndex``).
        :param device: Torch device the index scores on; ``None`` means
            ``"cuda"``.
        :raises ValueError: When the file exists and ``overwrite=False``.
        :raises RuntimeError: When the device is CUDA and none is available.
        """
        _check_options(precision, mesh_config, hbm_budget)
        index_file = Path(index_file)
        if index_file.exists() and not overwrite:
            raise ValueError(f"File {index_file} exists.")
        self._device = resolve_device(device)
        self._mesh = mesh_config.build(device=self._device) if mesh_config else None
        self._index_file = index_file.absolute()
        self._init_size = init_size
        self._chunk_size = chunk_size
        self._max_id_length = max_id_length
        self._memory_mapped = memory_mapped
        self._max_indexing_size = max_indexing_size
        self._hbm_cache = hbm_cache
        self._hbm_budget = hbm_budget
        self._stream_chunk_rows = stream_chunk_rows
        self._precision = precision
        self._dev_view: DeviceView | None = None
        self._view_lock = threading.Lock()
        self._mmap_chunks: list[np.memmap] | None = None

        LOGGER.debug("creating file %s", self._index_file)
        with h5file.File(self._index_file, "w") as fp:
            fp.attrs["num_vectors"] = 0
            fp.attrs["ff_version"] = fastforward_tpu_torch.__version__

        super().__init__(
            query_encoder=query_encoder,
            quantizer=quantizer,
            mode=mode,
            encoder_batch_size=encoder_batch_size,
            score_transport=score_transport,
        )

    # -- file layout ---------------------------------------------------------

    def _create_datasets(self, fp, dim: int, dtype: np.dtype) -> None:
        fp.create_dataset(
            "vectors",
            (self._init_size, dim),
            dtype,
            maxshape=(None, dim),
            chunks=(self._chunk_size, dim),
        )
        for name in ("doc_ids", "psg_ids"):
            fp.create_dataset(
                name,
                (self._init_size,),
                f"S{self._max_id_length}",
                maxshape=(None,),
                chunks=True,
            )

    def _on_quantizer_set(self) -> None:
        with h5file.File(self._index_file, "a") as fp:
            if "quantizer" in fp:
                del fp["quantizer"]
            meta, attributes, data = self._quantizer.serialize()
            fp.create_group("quantizer/meta").attrs.update(meta)
            fp.create_group("quantizer/attributes").attrs.update(
                {k: v for k, v in attributes.items() if v is not None}
            )
            group = fp.create_group("quantizer/data")
            for key, value in data.items():
                group.create_dataset(key, data=value)

    def _get_num_vectors(self) -> int:
        with h5file.File(self._index_file, "r") as fp:
            return int(fp.attrs["num_vectors"])

    def _get_internal_dim(self) -> int | None:
        with h5file.File(self._index_file, "r") as fp:
            if "vectors" in fp:
                return fp["vectors"].shape[1]
        return None

    # -- adding --------------------------------------------------------------

    def _validate_new_ids(self, doc_ids: IDSequence, psg_ids: IDSequence) -> None:
        """Check lengths and uniqueness of all IDs before mutating anything.

        A failed add leaves the index unchanged.  Lengths are counted in
        encoded *bytes*: the file stores fixed-width ``S{max_id_length}``
        byte strings, and numpy would otherwise cut a multi-byte UTF-8 ID
        mid-sequence (the file then fails to decode on reload).
        """
        for kind, ids in (("Document", doc_ids), ("Passage", psg_ids)):
            for id_ in ids:
                if id_ is not None and len(id_.encode()) > self._max_id_length:
                    raise RuntimeError(
                        f"{kind} ID {id_} is longer than the maximum "
                        f"({self._max_id_length} bytes encoded)."
                    )
        self._ids.check_new_psgs(psg_ids)

    def _add(
        self, vectors: np.ndarray, doc_ids: IDSequence, psg_ids: IDSequence
    ) -> None:
        with h5file.File(self._index_file, "a") as fp:
            if "vectors" not in fp:
                self._create_datasets(fp, vectors.shape[-1], vectors.dtype)
            # id lengths are bounded by the stored string width
            self._max_id_length = fp["doc_ids"].dtype.itemsize
            self._validate_new_ids(doc_ids, psg_ids)

            start = int(fp.attrs["num_vectors"])
            num_new = vectors.shape[0]
            capacity = fp["vectors"].shape[0]
            if start + num_new > capacity:
                # grow by whole chunks
                new_size = -(-(start + num_new) // self._chunk_size) * self._chunk_size
                LOGGER.debug("resizing index from %s to %s", capacity, new_size)
                for name in ("vectors", "doc_ids", "psg_ids"):
                    fp[name].resize(new_size, axis=0)
                self._mmap_chunks = None

            self._ids.add(doc_ids, psg_ids, start)
            width = self._max_id_length
            fp["doc_ids"][start : start + num_new] = np.array(
                [(d or "").encode() for d in doc_ids], dtype=f"S{width}"
            )
            fp["psg_ids"][start : start + num_new] = np.array(
                [(p or "").encode() for p in psg_ids], dtype=f"S{width}"
            )
            fp["vectors"][start : start + num_new] = vectors
            fp.attrs["num_vectors"] = start + num_new
        with self._view_lock:
            self._dev_view = None  # the device table is stale

    # -- host reads ----------------------------------------------------------

    def _read_rows_h5(self, rows: np.ndarray) -> np.ndarray:
        """Read rows by (sorted) HDF5 fancy indexing, in bounded batches."""
        order = np.argsort(rows, kind="stable")
        sorted_rows = rows[order]
        with h5file.File(self._index_file, "r") as fp:
            ds = fp["vectors"]
            parts = [
                ds[sorted_rows[i : i + self._max_indexing_size].tolist()]
                for i in range(0, len(sorted_rows), self._max_indexing_size)
            ]
        data = np.concatenate(parts)
        out = np.empty_like(data)
        out[order] = data  # undo the sort
        return out

    def _get_mmap_chunks(self) -> list[np.memmap]:
        """Per-HDF5-chunk read-only memory maps over the raw vector bytes.

        :raises RuntimeError: When the dataset's chunks do not cover whole
            rows (the chunk width must equal the vector dimension).
        """
        if self._mmap_chunks is None:
            with h5file.File(self._index_file, "r") as fp:
                ds = fp["vectors"]
                if ds.chunks is None or ds.chunks[1] != ds.shape[1]:
                    raise RuntimeError("This index does not support memory maps.")
                self._mmap_chunks = [
                    np.memmap(self._index_file, mode="r", shape=ds.chunks, offset=offset,
                              dtype=ds.dtype)
                    for offset in ds.chunk_offsets()
                ]
            LOGGER.debug("created %s chunk memory maps", len(self._mmap_chunks))
        return self._mmap_chunks

    def _read_rows_mmap(self, rows: np.ndarray) -> np.ndarray:
        """Read rows through the chunk maps (a copy: the maps are
        read-only)."""
        chunks = self._get_mmap_chunks()
        chunk_rows = chunks[0].shape[0]
        out = np.empty((len(rows), chunks[0].shape[1]), dtype=chunks[0].dtype)
        for pos, row in enumerate(rows):
            out[pos] = chunks[row // chunk_rows][row % chunk_rows]
        return out

    def _get_vectors(self, ids: Iterable[str]) -> tuple[np.ndarray, list[str]]:
        ids = list(ids)
        rows, counts = self._ids.resolve(ids, self.mode)
        if rows.shape[0] == 0:
            return np.array([]), []
        out_ids = [i for i, c in zip(ids, counts) for _ in range(c)]
        if self._memory_mapped:
            return self._read_rows_mmap(rows), out_ids
        return self._read_rows_h5(rows), out_ids

    def _batch_iter(
        self, batch_size: int
    ) -> Iterator[tuple[np.ndarray, IDSequence, IDSequence]]:
        with h5file.File(self._index_file, "r") as fp:
            num_vectors = int(fp.attrs["num_vectors"])
            for i in range(0, num_vectors, batch_size):
                j = min(i + batch_size, num_vectors)
                doc_ids = fp["doc_ids"].asstr()[i:j]
                psg_ids = fp["psg_ids"].asstr()[i:j]
                yield (
                    fp["vectors"][i:j],
                    [d if d else None for d in doc_ids],
                    [p if p else None for p in psg_ids],
                )

    # -- device cache --------------------------------------------------------

    def _device_view(self) -> DeviceView | None:
        """The whole table on the index's device (``hbm_cache=True``), laid
        out as ``InMemoryIndex`` lays it out, or its hybrid view when it
        exceeds ``hbm_budget`` (the tail stays in host RAM, read from the
        file once); ``None`` without ``hbm_cache`` or while the index is
        empty."""
        if not self._hbm_cache:
            return None
        view = self._dev_view
        if view is not None:
            return view
        with self._view_lock:
            if self._dev_view is None:
                num = len(self)
                if num == 0:
                    return None
                view = self._lazy_sharded_view(num)
                if view is None:
                    with h5file.File(self._index_file, "r") as fp:
                        raw = fp["vectors"][:num]
                    if self._hbm_budget is not None:
                        view = hybrid_view(
                            raw, self._quantizer, self._device, self._hbm_budget,
                            self._precision, self._stream_chunk_rows, mesh=self._mesh,
                        )
                if view is None:
                    view = build_view(
                        raw, self._quantizer, self._device, precision=self._precision,
                        mesh=self._mesh,
                    )
                self._dev_view = view
            return self._dev_view

    def _lazy_sharded_view(self, num: int) -> "DeviceView | None":
        """Under several processes, the sharded table read straight from
        the file, shard by shard: each process reads only its shards' rows,
        so the whole table never sits in one host's memory (dense vectors,
        int8 codes, PQ codes; the codebooks replicate).  ``None`` in one
        process, with ``hbm_budget``, for another quantizer, or where the
        rows are not whole 128-lane rows."""
        from fastforward_tpu_torch.parallel.multihost import put_row_sharded_lazy

        mesh = self._mesh
        if mesh is None or not mesh.multiprocess or self._hbm_budget is not None:
            return None
        is_pq = isinstance(self._quantizer, PQ)
        is_scalar = isinstance(self._quantizer, ScalarQuantizer)
        if self._quantizer is not None and not (is_pq or is_scalar):
            return None
        with h5file.File(self._index_file, "r") as fp:
            width = fp["vectors"].shape[1]
            stored = fp["vectors"].dtype
        if not is_pq and width % 128:
            return None
        n_pad = _padded_rows(num, mesh)
        if is_pq:
            shape, dtype = (n_pad, width), stored
        elif is_scalar:
            shape, dtype = (n_pad, width // 128, 128), np.dtype(np.int8)
        else:
            shape, dtype = (n_pad, width), np.dtype(np.float32)
        path = self._index_file

        def read_rows(start: int, stop: int) -> np.ndarray:
            hi = min(stop, num)
            if hi <= start:
                return np.zeros((0, width), dtype=dtype)
            with h5file.File(path, "r") as fp:
                return np.asarray(fp["vectors"][start:hi], dtype=dtype)

        table = put_row_sharded_lazy(mesh, shape, dtype, read_rows)
        return device_view(table, self._quantizer, self._precision, mesh=mesh)

    # -- conversion / loading ------------------------------------------------

    def to_memory(self, batch_size: int | None = None) -> InMemoryIndex:
        """Copy the index into an ``InMemoryIndex`` on the same device.

        :param batch_size: Copy in batches instead of all at once.
        :return: The in-memory index.
        """
        index = InMemoryIndex(
            query_encoder=self._query_encoder,
            quantizer=self._quantizer,
            mode=self.mode,
            encoder_batch_size=self._encoder_batch_size,
            init_size=max(len(self), 1),
            precision=self._precision,
            score_transport=self._score_transport,
            device=self._device,
        )
        with h5file.File(self._index_file, "r") as fp:
            num_vectors = int(fp.attrs["num_vectors"])
            step = batch_size or max(num_vectors, 1)
            for i in range(0, num_vectors, step):
                j = min(i + step, num_vectors)
                doc_ids = fp["doc_ids"].asstr()[i:j]
                psg_ids = fp["psg_ids"].asstr()[i:j]
                index._add(
                    fp["vectors"][i:j],
                    doc_ids=[d if d else None for d in doc_ids],
                    psg_ids=[p if p else None for p in psg_ids],
                )
        return index

    @classmethod
    def load(
        cls,
        index_file: Path,
        query_encoder: Encoder | None = None,
        mode: Mode = Mode.MAXP,
        encoder_batch_size: int = 32,
        memory_mapped: bool = False,
        max_indexing_size: int = 2**10,
        hbm_cache: bool = False,
        precision: str = "exact",
        mesh_config: "MeshConfig | None" = None,
        hbm_budget: int | None = None,
        stream_chunk_rows: int | None = None,
        score_transport: str = "f32",
        device: "str | torch.device | None" = None,
    ) -> "OnDiskIndex":
        """Open an existing index file (written by this package, the JAX
        package or the reference).

        :param index_file: The index file.
        :param query_encoder: The query encoder.
        :param mode: The ranking mode.
        :param encoder_batch_size: Batch size for the query encoder.
        :param memory_mapped: Read vectors through per-chunk memory maps.
        :param max_indexing_size: Maximum rows per HDF5 fancy-indexing read.
        :param hbm_cache: Upload the table to the index's device for
            scoring.
        :param precision: Scoring precision tier (see ``InMemoryIndex``).
        :param mesh_config: With ``hbm_cache``, row-shard the table over a
            mesh of devices (see ``InMemoryIndex``); under several processes
            each reads only its shards' rows from the file.
        :param hbm_budget: With ``hbm_cache``, the scoring-memory budget in
            bytes (the hybrid tier beyond it).
        :param stream_chunk_rows: Rows of a streamed tail block.
        :param score_transport: ``"f32"`` or ``"u16"``.
        :param device: Torch device the index scores on (and a loaded PQ
            quantizer encodes on); ``None`` means ``"cuda"``.
        :raises h5file.UnsupportedHDF5: When the file holds a structure outside
            the part of HDF5 the codec reads.
        :raises RuntimeError: When the device is CUDA and none is available.
        :return: The index.
        """
        _check_options(precision, mesh_config, hbm_budget)
        index_file = Path(index_file)
        LOGGER.debug("reading file %s", index_file)
        index = cls.__new__(cls)
        index._device = resolve_device(device)
        index._mesh = mesh_config.build(device=index._device) if mesh_config else None
        super(OnDiskIndex, index).__init__(
            query_encoder=query_encoder,
            quantizer=None,
            mode=mode,
            encoder_batch_size=encoder_batch_size,
            score_transport=score_transport,
        )
        index._index_file = index_file.absolute()
        index._memory_mapped = memory_mapped
        index._max_indexing_size = max_indexing_size
        index._hbm_cache = hbm_cache
        index._hbm_budget = hbm_budget
        index._stream_chunk_rows = stream_chunk_rows
        index._precision = precision
        index._dev_view = None
        index._view_lock = threading.Lock()
        index._mmap_chunks = None

        with h5file.File(index_file, "r") as fp:
            if "quantizer" in fp:
                index._quantizer = Quantizer.deserialize(
                    dict(fp["quantizer/meta"].attrs),
                    dict(fp["quantizer/attributes"].attrs),
                    {k: v[:] for k, v in fp["quantizer/data"].items()},
                )
                if isinstance(index._quantizer, PQ):
                    index._quantizer.device = index._device
            index._max_id_length = fp["doc_ids"].dtype.itemsize if "doc_ids" in fp else 8
            index._chunk_size = (
                fp["vectors"].chunks[0]
                if "vectors" in fp and fp["vectors"].chunks
                else 2**16
            )
            index._init_size = fp["vectors"].shape[0] if "vectors" in fp else 2**16

            num_vectors = int(fp.attrs["num_vectors"])
            if num_vectors == 0:
                return index
            # the row maps come back natively from the raw fixed-width arrays
            index._ids.bulk_load(fp["doc_ids"][:num_vectors], fp["psg_ids"][:num_vectors])
        return index
