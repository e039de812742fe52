"""In-memory index: host-canonical store + device scoring table.

The port of ``fastforward_tpu/index/memory.py`` with ``store="host"``: the
canonical copy is one growable host array (vectors as added, or the
quantizer's codes), and the scoring copy is a zero-padded table on the
index's device, uploaded lazily in row chunks and invalidated on ``add``:
``(N_pad, dim)`` fp32 or bf16 vectors; int8 codes, ``(N_pad, dim/128, 128)``
when ``dim % 128 == 0``; or ``(N_pad, M)`` uint8 PQ codes with their fp32
codebooks beside them.
"""

import logging
import threading
from collections.abc import Iterable, Iterator

import numpy as np
import torch

from fastforward_tpu_torch.device import resolve_device
from fastforward_tpu_torch.encoder.base import Encoder
from fastforward_tpu_torch.index.base import DeviceView, IDSequence, Index, not_ported
from fastforward_tpu_torch.index.mode import Mode
from fastforward_tpu_torch.quantizer import PQ, Quantizer, ScalarQuantizer

LOGGER = logging.getLogger(__name__)

# device tables are padded to a multiple of this many rows (a multiple of
# the kernel's tile rows), so the layout changes only on growth
_ROW_PAD = 4096

# rows per host->device upload step (bounds the staging copies)
_UPLOAD_ROWS = 1 << 16

_DEVICE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class InMemoryIndex(Index):
    """Fast-Forward index held in memory (host canonical, device for scoring)."""

    def __init__(
        self,
        query_encoder: Encoder | None = None,
        quantizer: Quantizer | None = None,
        mode: Mode = Mode.MAXP,
        encoder_batch_size: int = 32,
        init_size: int = 2**16,
        alloc_size: int = 2**16,
        device_dtype: str = "float32",
        mesh_config=None,
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
            (``"float32"`` or ``"bfloat16"``; the host copy stays as added;
            ignored for quantized indexes).
        :param mesh_config: Must be ``None`` (not ported yet).
        :param precision: ``"exact"`` or ``"high"`` (true fp32 dots) or
            ``"fast"`` (bf16-rounded operands, fp32 accumulation); PQ
            tables at dense tiles take K4's tiers (``"high"`` rounds the
            codewords to bf16).
        :param store: Must be ``"host"`` (``"device"`` is not ported yet).
        :param hbm_budget: Must be ``None`` (not ported yet).
        :param stream_chunk_rows: Must be ``None`` (not ported yet).
        :param score_transport: ``"f32"`` (exact scores) or ``"u16"``
            (the re-rank path copies 16-bit codes of the scores: half the
            bytes, at most ``score_range / 131070`` added to each score).
        :param device: Torch device of the scoring table; ``None`` means
            ``"cuda"``.
        :raises RuntimeError: When the device is CUDA and none is available.
        """
        if store not in ("host", "device"):
            raise ValueError(f"store must be 'host' or 'device', got {store!r}")
        if store == "device":
            raise not_ported("store='device'", "12b")
        if mesh_config is not None:
            raise not_ported("mesh_config (multi-device tables)", "14")
        if hbm_budget is not None or stream_chunk_rows is not None:
            raise not_ported("hbm_budget / stream_chunk_rows (the hybrid tier)", "13")
        if device_dtype not in _DEVICE_DTYPES:
            raise ValueError(
                f"device_dtype must be 'float32' or 'bfloat16', got {device_dtype!r}"
            )
        if precision not in ("exact", "high", "fast"):
            raise ValueError(
                f"precision must be 'exact', 'high' or 'fast', got {precision!r}"
            )
        self._device = resolve_device(device)
        self._store: np.ndarray | None = None
        self._num = 0
        self._init_size = init_size
        self._alloc_size = alloc_size
        self._device_dtype = device_dtype
        self._precision = precision
        self._dev_view: DeviceView | None = None
        # one upload when several threads (a server's resolver pool, the
        # preload warms) ask for the table at once
        self._view_lock = threading.Lock()
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
        start = self._num
        self._ids.add(doc_ids, psg_ids, start)
        self._grow_to(start + num_new, vectors.shape[1], vectors.dtype)
        self._store[start : start + num_new] = vectors
        self._num += num_new
        self._dev_view = None  # device table is stale

    def consolidate(self) -> None:
        """Trim the host store to exactly the used capacity."""
        if self._store is not None:
            self._store = self._store[: self._num].copy()

    # -- host reads ----------------------------------------------------------

    def _get_vectors(self, ids: Iterable[str]) -> tuple[np.ndarray, list[str]]:
        ids = list(ids)
        rows, counts = self._ids.resolve(ids, self.mode)
        if rows.shape[0] == 0:
            return np.array([]), []
        out_ids = [i for i, c in zip(ids, counts) for _ in range(c)]
        return self._store[rows], out_ids

    def _batch_iter(
        self, batch_size: int
    ) -> Iterator[tuple[np.ndarray, IDSequence, IDSequence]]:
        doc_list, psg_list = self._ids.inverse(self._num)
        for i in range(0, self._num, batch_size):
            j = min(i + batch_size, self._num)
            yield self._store[i:j], doc_list[i:j], psg_list[i:j]

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
        """Upload the host store into a new device view."""
        return build_view(
            self._store[: self._num],
            self._quantizer,
            self._device,
            precision=self._precision,
            device_dtype=self._device_dtype,
        )


def upload_rows(
    rows: np.ndarray, shape: tuple, dtype: torch.dtype, device: torch.device, host_dtype=None
) -> torch.Tensor:
    """Zero-padded device copy of host rows, uploaded in row chunks (each
    chunk converted to ``host_dtype`` on the host, then cast on the device;
    bf16 rounds to nearest even).  No padded host copy is made."""
    table = torch.zeros(shape, dtype=dtype, device=device)
    flat = table.view(shape[0], -1)
    for lo in range(0, rows.shape[0], _UPLOAD_ROWS):
        chunk = np.ascontiguousarray(rows[lo : lo + _UPLOAD_ROWS], dtype=host_dtype)
        flat[lo : lo + chunk.shape[0]] = torch.from_numpy(chunk).to(device)
    return table


def build_view(
    data: np.ndarray,
    quantizer: "Quantizer | None",
    device: torch.device,
    precision: str = "exact",
    device_dtype: str = "float32",
) -> DeviceView:
    """The device view of stored rows (vectors as added, or the
    quantizer's codes), zero-padded to a multiple of ``_ROW_PAD`` rows:
    ``(N_pad, M)`` uint8 PQ codes with their fp32 codebooks; int8 codes,
    ``(N_pad, dim/128, 128)`` when the lanes divide; or ``(N_pad, dim)``
    vectors in ``device_dtype``.

    :raises NotImplementedError: For PQ codes wider than uint8.
    """
    n_pad = -(-data.shape[0] // _ROW_PAD) * _ROW_PAD
    width = data.shape[1]
    if isinstance(quantizer, PQ):
        if data.dtype != np.uint8:
            raise not_ported("PQ codes wider than uint8 (Ks > 256)", "10")
        # compact (N_pad, M) codes; the fp32 codebooks stay in L2
        codebooks = np.array(quantizer.codewords, dtype=np.float32)
        return DeviceView(
            kind="pq",
            table=upload_rows(data, (n_pad, width), torch.uint8, device),
            precision=precision,
            codebooks=torch.from_numpy(codebooks).to(device),
        )
    if isinstance(quantizer, ScalarQuantizer):
        # 3D int8 layout when the lanes divide (the streamed kernels'
        # table form); the scales fold into the queries
        shape = (n_pad, width // 128, 128) if width % 128 == 0 else (n_pad, width)
        return DeviceView(
            kind="scalar",
            table=upload_rows(data, shape, torch.int8, device),
            precision=precision,
            scales=quantizer.scales,
        )
    return DeviceView(
        kind="dense",
        table=upload_rows(
            data, (n_pad, width), _DEVICE_DTYPES[device_dtype], device, np.float32
        ),
        precision=precision,
    )
