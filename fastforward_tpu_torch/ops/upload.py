"""Chunked host->device table upload, and the 16-bit planes of an fp32 table.

The port of ``fastforward_tpu/ops/upload.py``.  A table goes to the index's
device in row chunks of about ``CHUNK_BYTES``; on the card each chunk is
copied into one of two pinned host buffers used in turn
(:class:`PinnedStager`), and its copy to the card runs while the host fills
the other buffer.  A copy from pageable memory would be synchronous, and
one host buffer would serialize the host's copy with the transfer.

:func:`upload_table` copies each chunk straight into its rows of a
preallocated device table (peak device memory: the table; concatenating
chunk tensors instead would hold the table twice and copy it once more on
the device); :func:`upload_into` writes rows into an existing buffer at an
offset (the device store's ``add``).

:func:`upload_plane` ships the high or the low 16 bits of every fp32 value
as an ``int16`` plane (half the bytes each); :func:`expand_hi` turns a hi
plane into the truncated fp32 table and :func:`combine_lo` ORs the lo plane
back in for the exact table: the progressive preload's split-plane upload.
The plane arithmetic runs in ``int32`` with masks, since the card's
``uint16``/``uint32`` bitwise operations are incomplete in PyTorch.
"""

import logging
import sys
from collections.abc import Callable

import numpy as np
import torch

LOGGER = logging.getLogger(__name__)

#: target bytes per transfer chunk (also the size of each pinned buffer)
CHUNK_BYTES = 128 << 20


class PinnedStager:
    """Two pinned host buffers of ``(rows, *row_shape)`` used in turn.

    :meth:`slot` waits until the copy that last read the next buffer has
    landed (its event) and returns the buffer's first ``n`` rows for the
    host to fill; :meth:`sent` records, on ``stream``, the event of the copy
    just issued from it.  The buffers come from PyTorch's caching host
    allocator, so repeated uploads of one shape reuse them.
    """

    def __init__(self, rows: int, row_shape: tuple, dtype: torch.dtype) -> None:
        self._rows = rows
        self._row_shape = tuple(row_shape)
        self._dtype = dtype
        self._bufs: list = [None, None]
        self._events: list = [None, None]
        self._k = 1

    def slot(self, n: int) -> torch.Tensor:
        """The next buffer's first ``n`` rows (``n <= rows``), free to fill."""
        self._k ^= 1
        ev = self._events[self._k]
        if ev is not None:
            ev.synchronize()
            self._events[self._k] = None
        if self._bufs[self._k] is None:
            self._bufs[self._k] = torch.empty(
                (self._rows, *self._row_shape), dtype=self._dtype, pin_memory=True
            )
        return self._bufs[self._k][:n]

    def sent(self, stream: "torch.cuda.Stream | None" = None) -> None:
        """Mark the copy just issued from the current buffer (on ``stream``,
        default the current stream)."""
        ev = torch.cuda.Event()
        ev.record(stream)
        self._events[self._k] = ev


def _chunk_rows(row_bytes: int, chunk_bytes: int) -> int:
    return max(1, chunk_bytes // max(1, row_bytes))


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


def _place_chunks(
    dst2: torch.Tensor,
    n: int,
    cs: int,
    chunk_of: Callable[[int, int], np.ndarray],
    stage_dtype: np.dtype,
) -> None:
    """``dst2[b:e] = chunk_of(b, e)`` for the chunks ``[b, e)`` of ``[0, n)``
    (``dst2``: 2D rows; ``chunk_of`` may return a strided view).  Each chunk
    is cast to ``stage_dtype`` on the host, by PyTorch's copy on all host
    threads (into a pinned staging buffer on the card), and to ``dst2``'s
    dtype on the device."""
    stage_t = _torch_dtype(stage_dtype)
    width = dst2.shape[1]
    if dst2.device.type != "cuda":
        for b in range(0, n, cs):
            e = min(b + cs, n)
            src = torch.from_numpy(np.asarray(chunk_of(b, e))).reshape(e - b, width)
            dst2[b:e].copy_(src.to(stage_t))
        return
    stager = PinnedStager(min(cs, n), (width,), stage_t)
    for b in range(0, n, cs):
        e = min(b + cs, n)
        stage = stager.slot(e - b)
        stage.copy_(torch.from_numpy(np.asarray(chunk_of(b, e))).reshape(e - b, width))
        dst2[b:e].copy_(stage, non_blocking=True)
        stager.sent()


def upload_into(
    dst: torch.Tensor,
    host: np.ndarray,
    start: int = 0,
    *,
    stage_dtype=None,
    chunk_bytes: int = CHUNK_BYTES,
) -> None:
    """Write ``host``'s rows into ``dst[start : start + len(host)]`` in place.

    :param dst: Device buffer, ``(rows, ...)``; a row holds as many elements
        as a host row.
    :param host: Host rows, ``(n, ...)`` (C-contiguous rows).
    :param start: First row of ``dst`` written.
    :param stage_dtype: Host dtype the rows cross the link in (default
        ``host.dtype``); the device casts them to ``dst``'s dtype.
    :param chunk_bytes: Target bytes per transfer chunk.
    """
    n = host.shape[0]
    if start < 0 or start + n > dst.shape[0]:
        raise ValueError(f"rows [{start}, {start + n}) do not fit {dst.shape[0]} device rows")
    if n == 0:
        return
    stage_dtype = np.dtype(host.dtype if stage_dtype is None else stage_dtype)
    dst2 = dst.view(dst.shape[0], -1)[start : start + n]
    flat = host.reshape(n, -1)
    if flat.shape[1] != dst2.shape[1]:
        raise ValueError(f"host rows of {flat.shape[1]} values do not fit device rows of {dst2.shape[1]}")
    cs = _chunk_rows(flat.shape[1] * stage_dtype.itemsize, chunk_bytes)
    _place_chunks(dst2, n, cs, lambda b, e: flat[b:e], stage_dtype)


def upload_table(
    host: np.ndarray,
    device: "torch.device | str",
    *,
    shape: "tuple | None" = None,
    dtype: "torch.dtype | None" = None,
    stage_dtype=None,
    chunk_bytes: int = CHUNK_BYTES,
) -> torch.Tensor:
    """Ship ``host`` to ``device`` in row chunks, each copied into its rows
    of a zero table of ``shape`` (nothing padded is built on the host).

    :param host: Host rows, ``(n, ...)`` (C-contiguous rows).
    :param device: Target device.
    :param shape: Device shape, ``(rows, ...)`` with ``rows >= n`` and as
        many elements a row as a host row (default ``host.shape``); rows past
        ``n`` are zero.
    :param dtype: Device dtype (default ``host``'s); fp32 rows cast to bf16
        on the device round to nearest even.
    :param stage_dtype: Host dtype the rows cross the link in (default
        ``host.dtype``).
    :param chunk_bytes: Target bytes per transfer chunk.
    :return: The device table.
    """
    n = host.shape[0]
    shape = tuple(host.shape) if shape is None else tuple(shape)
    stage_dtype = np.dtype(host.dtype if stage_dtype is None else stage_dtype)
    if shape[0] < n:
        raise ValueError(f"shape {shape} holds fewer rows than the host's {n}")
    table = torch.zeros(
        shape, dtype=_torch_dtype(stage_dtype) if dtype is None else dtype, device=torch.device(device)
    )
    LOGGER.debug("table upload: %s rows into %s %s", n, shape, table.dtype)
    upload_into(table, host, stage_dtype=stage_dtype, chunk_bytes=chunk_bytes)
    return table


def upload_plane(
    host_f32: np.ndarray,
    which: str,
    device: "torch.device | str",
    *,
    total_rows: "int | None" = None,
    chunk_bytes: int = CHUNK_BYTES,
) -> torch.Tensor:
    """Ship one 16-bit plane of an fp32 table as an ``int16`` device tensor.

    ``which="hi"`` ships bits 31..16 of every value (its value truncated to
    bf16), ``which="lo"`` bits 15..0: together a lossless split of the table
    at half the bytes a plane.  Each chunk's plane is a strided copy of the
    table's 16-bit halves straight into the staging buffer (no temporary).

    :param host_f32: The fp32 table, ``(rows, ...)``.
    :param which: ``"hi"`` or ``"lo"``.
    :param device: Target device.
    :param total_rows: Device rows (``>= rows``; the extra rows are zero, so
        fp32 ``0.0`` once recombined).
    :param chunk_bytes: Target bytes per transfer chunk of the plane.
    :return: ``int16`` plane ``(total_rows, ...)`` holding the uint16 bits.
    """
    if host_f32.dtype != np.float32:
        raise ValueError(f"plane upload needs float32, got {host_f32.dtype}")
    if which not in ("hi", "lo"):
        raise ValueError(f"which must be 'hi' or 'lo', got {which!r}")
    n = host_f32.shape[0]
    rows = n if total_rows is None else total_rows
    if rows < n:
        raise ValueError(f"total_rows ({rows}) < host rows ({n})")
    plane = torch.zeros((rows, *host_f32.shape[1:]), dtype=torch.int16, device=torch.device(device))
    if n == 0:
        return plane
    # an fp32 value is two 16-bit halves in memory: the plane is every
    # other int16 of the table, taken by a strided copy (no temporary)
    halves = host_f32.reshape(n, -1).view(np.int16)
    high = 1 if sys.byteorder == "little" else 0
    plane_view = halves[:, high::2] if which == "hi" else halves[:, 1 - high :: 2]
    cs = _chunk_rows(plane_view.shape[1] * 2, chunk_bytes)
    _place_chunks(plane.view(rows, -1), n, cs, lambda b, e: plane_view[b:e], np.dtype(np.int16))
    return plane


def expand_hi(hi: torch.Tensor) -> torch.Tensor:
    """The truncated fp32 table of a hi plane: each value with its low 16
    mantissa bits zeroed (bf16 magnitude, under 2^-7 relative error), in the
    final table's shape and dtype.  Peak memory: the plane and the table."""
    bits = hi.to(torch.int32)
    bits.bitwise_and_(0xFFFF)
    bits.bitwise_left_shift_(16)
    return bits.view(torch.float32)


def combine_lo(trunc: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """OR the lo plane into a truncated fp32 table: the exact table, in a
    new tensor.  ``trunc`` is left as it is (it may be the table in-flight
    calls are reading), so peak memory is both tables and the plane."""
    bits = lo.to(torch.int32)
    bits.bitwise_and_(0xFFFF)
    bits.bitwise_or_(trunc.view(torch.int32))
    return bits.view(torch.float32)
