"""K1 and K2, stream-select scoring: CUDA kernel wrappers and plain versions.

The port of ``fastforward_tpu/ops/stream_kernel.py``: K1,
``stream_select_pairwise`` (Pallas body ``_pairwise_kernel``), and K2,
``stream_select`` (Pallas body ``_select_kernel``), with
``stream_select_auto`` routing between them as the JAX package does.
Contract, shared with the TPU kernels: for each slot ``s`` of virtual tile
``t``, unpack ``c = cand3[t, s]`` into ``local = c // Qb`` and
``qno = c % Qb`` and compute

    out[t, s] = table[tile_idx[t] * r + local] . qvecs[qno]

K1 takes ``exact``: ``True`` is a true fp32 dot; ``False`` rounds the row
and the query to bf16 and accumulates the products in fp32.  K2 takes the
transposed query block and a ``precision`` tier: ``"exact"`` and
``"high"`` are true fp32 dots, ``"fast"`` is K1's bf16 tier.  Padding slots
carry ``local 0`` and ``qno Qb - 1`` and are computed like any other slot.

Each wrapper launches its hand-written CUDA kernel (``csrc/*.cu``) for CUDA
tensors and runs its plain PyTorch version only for CPU tensors.  On the
card K2, and K1 for bf16 and int8 tables, are query-major
(``csrc/dense_dot.cuh``): one call groups the slots by query
(``csrc/query_groups.cuh``, shared with K3 and K4), cuts each query's slots
into work items of at most ``DENSE_ITEM_SLOTS`` slots, and a block holds
one item's query while it dots the item's rows.  The wrapper allocates the
grouping's scratch and bounds the number of items (:func:`dense_max_items`).
K1 scores fp32 tables one warp per slot, which measured faster there.
"""

import ctypes

import torch

from fastforward_tpu_torch.ops import _build, query_groups

#: rows per table tile (the layout's tile granularity)
KERNEL_TILE_ROWS = 512
#: candidate slots per virtual tile (default; ``_adaptive_cap`` picks 128..1024)
KERNEL_CAP = 512

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

#: slots per step of the plain version (bounds its gathered temporaries)
_PLAIN_CHUNK_SLOTS = 1 << 17

#: slots per work item of the query-major kernels
DENSE_ITEM_SLOTS = 1024


def dense_max_items(qb: int, n_slots: int) -> int:
    """A bound on the work items of ``n_slots`` slots over ``qb`` queries
    at ``DENSE_ITEM_SLOTS`` slots an item (:func:`query_groups.max_items`)."""
    return query_groups.max_items(qb, n_slots, DENSE_ITEM_SLOTS)


#: argument types of ``ff_stream_select_pairwise``
_PAIRWISE_ARGS = (
    ctypes.c_void_p,  # table
    ctypes.c_int,  # dtype code
    ctypes.c_void_p,  # qvecs
    ctypes.c_void_p,  # cand3
    ctypes.c_void_p,  # tile_idx
    ctypes.c_void_p,  # out
    ctypes.c_longlong,  # slots
    ctypes.c_int,  # cap
    ctypes.c_int,  # qb
    ctypes.c_int,  # r
    ctypes.c_int,  # dim
    ctypes.c_int,  # exact
    ctypes.c_void_p,  # grouping scratch
    ctypes.c_int,  # slots per work item
    ctypes.c_longlong,  # work-item bound
    ctypes.c_int,  # device
    ctypes.c_void_p,  # stream
)


def _check(table, qvecs, cand3, tile_idx, r) -> int:
    """Validate the kernel contract; return ``dim``."""
    if table.dtype not in _DTYPE_CODE:
        raise TypeError(f"table dtype must be fp32, bf16 or int8, got {table.dtype}")
    if table.ndim == 3:
        if table.dtype != torch.int8:
            raise ValueError("3D tables must be int8 code tables (N_pad, dim/128, 128)")
        if table.shape[2] != 128:
            raise ValueError(f"3D tables need 128 lanes, got {tuple(table.shape)}")
        dim = table.shape[1] * 128
    elif table.ndim == 2:
        dim = table.shape[1]
    else:
        raise ValueError(f"table must be 2D or 3D, got {tuple(table.shape)}")
    if dim % 128 or table.shape[0] % r:
        raise ValueError(
            f"need dim % 128 == 0 and N_pad % r == 0, got dim={dim}, "
            f"N_pad={table.shape[0]}, r={r}"
        )
    if qvecs.dtype != torch.float32 or qvecs.ndim != 2 or qvecs.shape[1] != dim:
        raise ValueError(f"qvecs must be fp32 (Qb, {dim}), got {qvecs.dtype} {tuple(qvecs.shape)}")
    if cand3.dtype != torch.int32 or cand3.ndim != 3 or cand3.shape[2] != 128:
        raise ValueError(f"cand3 must be int32 (Tv, CAP/128, 128), got {cand3.dtype} {tuple(cand3.shape)}")
    if tile_idx.dtype != torch.int32 or tuple(tile_idx.shape) != (cand3.shape[0],):
        raise ValueError(f"tile_idx must be int32 ({cand3.shape[0]},), got {tile_idx.dtype} {tuple(tile_idx.shape)}")
    if qvecs.shape[0] * r > 2**31 - 1:
        raise ValueError("Qb * r must fit the int32 packing")
    devices = {t.device for t in (table, qvecs, cand3, tile_idx)}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {devices}")
    return dim


def stream_select_pairwise(
    table: torch.Tensor,
    qvecs: torch.Tensor,
    cand3: torch.Tensor,
    tile_idx: torch.Tensor,
    r: int = KERNEL_TILE_ROWS,
    exact: bool = True,
) -> torch.Tensor:
    """Score every candidate slot: K1 on the card, the plain version on CPU.

    :param table: ``(N_pad, dim)`` fp32/bf16, or int8 ``(N_pad, dim/128,
        128)`` codes (scales folded into the queries); ``N_pad % r == 0``.
    :param qvecs: Query vectors, ``(Qb, dim)`` fp32.
    :param cand3: Packed candidates ``local * Qb + qno``, ``(Tv, CAP/128,
        128)`` int32 (from ``ops.scoring.build_streamed_layout``; values
        are not range-checked on the card).
    :param tile_idx: Base table tile per virtual tile, ``(Tv,)`` int32.
    :param r: Rows per table tile.
    :param exact: True fp32 dots vs bf16-rounded operands.
    :raises ValueError: On shapes, layouts or devices the kernel does not take.
    :raises TypeError: On a table dtype the kernel does not take.
    :raises RuntimeError: When the launch fails (with the CUDA error).
    :return: Scores per slot, ``(Tv, CAP/128, 128)`` fp32.
    """
    dim = _check(table, qvecs, cand3, tile_idx, r)
    if table.device.type == "cpu":
        return stream_select_pairwise_plain(table, qvecs, cand3, tile_idx, r, exact)
    device, stream = _build.cuda_target(
        (("table", table), ("qvecs", qvecs), ("cand3", cand3), ("tile_idx", tile_idx))
    )
    if table.data_ptr() % 16 or qvecs.data_ptr() % 16:
        raise ValueError("table and qvecs must be 16-byte aligned")
    out = torch.empty_like(cand3, dtype=torch.float32)
    # fp32 tables are scored slot by slot, without grouping (csrc/stream_select_pairwise.cu)
    grouped = table.dtype != torch.float32
    scratch = query_groups.scratch(qvecs.shape[0], out.numel(), table.device) if grouped else None
    _build.bind("stream_select_pairwise", _PAIRWISE_ARGS)(
        table.data_ptr(),
        _DTYPE_CODE[table.dtype],
        qvecs.data_ptr(),
        cand3.data_ptr(),
        tile_idx.data_ptr(),
        out.data_ptr(),
        out.numel(),
        cand3.shape[1] * 128,
        qvecs.shape[0],
        r,
        dim,
        int(exact),
        scratch.data_ptr() if grouped else None,
        DENSE_ITEM_SLOTS,
        dense_max_items(qvecs.shape[0], out.numel()),
        device,
        stream,
    )
    stream_select_pairwise.launches += 1
    return out


#: launches of the CUDA kernel (the plain version does not count)
stream_select_pairwise.launches = 0


def stream_select_pairwise_plain(
    table: torch.Tensor,
    qvecs: torch.Tensor,
    cand3: torch.Tensor,
    tile_idx: torch.Tensor,
    r: int = KERNEL_TILE_ROWS,
    exact: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version of K1 (same arguments and result).

    Unpacks the slots, indexes the rows and queries, rounds both to bf16
    for ``exact=False``, multiplies elementwise and sums in fp32 (no matmul,
    so no TF32 either).
    """
    qb = qvecs.shape[0]
    rows2 = table.reshape(table.shape[0], -1)
    cand = cand3.reshape(-1).long()
    tiles = tile_idx.long().repeat_interleave(cand3.shape[1] * 128)
    row = tiles * r + cand // qb
    qno = cand % qb
    q = qvecs.float() if exact else qvecs.to(torch.bfloat16).float()
    out = torch.empty(cand.shape[0], dtype=torch.float32, device=table.device)
    for lo in range(0, cand.shape[0], _PLAIN_CHUNK_SLOTS):
        hi = lo + _PLAIN_CHUNK_SLOTS
        x = rows2[row[lo:hi]].float()
        if not exact:
            x = x.to(torch.bfloat16).float()
        out[lo:hi] = (x * q[qno[lo:hi]]).sum(-1)
    return out.view(cand3.shape)


# -- K2: stream_select ----------------------------------------------------------

#: precision tiers of K2 (``"exact"`` and ``"high"`` are both true fp32 dots)
SELECT_TIERS = ("exact", "high", "fast")


#: argument types of ``ff_stream_select``
_SELECT_ARGS = (
    ctypes.c_void_p,  # table
    ctypes.c_int,  # dtype code
    ctypes.c_void_p,  # qvecs_t
    ctypes.c_longlong,  # qvecs_t stride along dim
    ctypes.c_longlong,  # qvecs_t stride along queries
    ctypes.c_void_p,  # cand3
    ctypes.c_void_p,  # tile_idx
    ctypes.c_void_p,  # out
    ctypes.c_int,  # virtual tiles
    ctypes.c_int,  # cap
    ctypes.c_int,  # qb
    ctypes.c_int,  # r
    ctypes.c_int,  # dim
    ctypes.c_int,  # fast
    ctypes.c_void_p,  # grouping scratch
    ctypes.c_int,  # slots per work item
    ctypes.c_longlong,  # work-item bound
    ctypes.c_int,  # device
    ctypes.c_void_p,  # stream
)


def _check_select(table, qvecs_t, cand3, tile_idx, r, precision) -> int:
    """Validate K2's contract; return ``dim``."""
    if precision not in SELECT_TIERS:
        raise ValueError(f"precision must be one of {SELECT_TIERS}, got {precision!r}")
    if table.dtype not in _DTYPE_CODE:
        raise TypeError(f"table dtype must be fp32, bf16 or int8, got {table.dtype}")
    if table.ndim == 3 and table.shape[2] == 128:
        dim = table.shape[1] * 128
    elif table.ndim == 2:
        dim = table.shape[1]
    else:
        raise ValueError(f"table must be (N_pad, dim) or (N_pad, dim/128, 128), got {tuple(table.shape)}")
    if dim % 128 or table.shape[0] % r:
        raise ValueError(
            f"need dim % 128 == 0 and N_pad % r == 0, got dim={dim}, N_pad={table.shape[0]}, r={r}"
        )
    if qvecs_t.dtype != torch.float32 or qvecs_t.ndim != 2 or qvecs_t.shape[0] != dim:
        raise ValueError(f"qvecs_t must be fp32 ({dim}, Qb), got {qvecs_t.dtype} {tuple(qvecs_t.shape)}")
    if cand3.dtype != torch.int32 or cand3.ndim != 3 or cand3.shape[2] != 128:
        raise ValueError(f"cand3 must be int32 (Tv, CAP/128, 128), got {cand3.dtype} {tuple(cand3.shape)}")
    if tile_idx.dtype != torch.int32 or tuple(tile_idx.shape) != (cand3.shape[0],):
        raise ValueError(f"tile_idx must be int32 ({cand3.shape[0]},), got {tile_idx.dtype} {tuple(tile_idx.shape)}")
    if qvecs_t.shape[1] * r > 2**31 - 1:
        raise ValueError("Qb * r must fit the int32 packing")
    devices = {t.device for t in (table, qvecs_t, cand3, tile_idx)}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {devices}")
    return dim


def stream_select(
    table: torch.Tensor,
    qvecs_t: torch.Tensor,
    cand3: torch.Tensor,
    tile_idx: torch.Tensor,
    r: int = KERNEL_TILE_ROWS,
    precision: str = "exact",
) -> torch.Tensor:
    """Score every candidate slot of dense tiles: K2 on the card, the plain
    version on CPU.

    :param table: ``(N_pad, dim)`` or ``(N_pad, dim/128, 128)``, fp32, bf16
        or int8 (codes; scales folded into the queries); ``N_pad % r == 0``.
    :param qvecs_t: Transposed query vectors, ``(dim, Qb)`` fp32, any
        strides (the transposed view ``q.t()`` of a row-major ``(Qb, dim)``
        block reads fastest).
    :param cand3: Packed candidates ``local * Qb + qno``, ``(Tv, CAP/128,
        128)`` int32 (values are not range-checked on the card).
    :param tile_idx: Base table tile per virtual tile, ``(Tv,)`` int32.
    :param r: Rows per table tile.
    :param precision: ``"exact"`` or ``"high"`` (true fp32 dots) or
        ``"fast"`` (bf16-rounded operands, fp32 accumulation).
    :raises ValueError: On shapes, layouts, tiers or devices the kernel does
        not take.
    :raises TypeError: On a table dtype the kernel does not take.
    :raises RuntimeError: When the launch fails (with the CUDA error).
    :return: Scores per slot, ``(Tv, CAP/128, 128)`` fp32.
    """
    dim = _check_select(table, qvecs_t, cand3, tile_idx, r, precision)
    if table.device.type == "cpu":
        return stream_select_plain(table, qvecs_t, cand3, tile_idx, r, precision)
    device, stream = _build.cuda_target(
        (("table", table), ("cand3", cand3), ("tile_idx", tile_idx))
    )
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned")
    out = torch.empty_like(cand3, dtype=torch.float32)
    scratch = query_groups.scratch(qvecs_t.shape[1], out.numel(), table.device)
    _build.bind("stream_select", _SELECT_ARGS)(
        table.data_ptr(),
        _DTYPE_CODE[table.dtype],
        qvecs_t.data_ptr(),
        qvecs_t.stride(0),
        qvecs_t.stride(1),
        cand3.data_ptr(),
        tile_idx.data_ptr(),
        out.data_ptr(),
        cand3.shape[0],
        cand3.shape[1] * 128,
        qvecs_t.shape[1],
        r,
        dim,
        int(precision == "fast"),
        scratch.data_ptr(),
        DENSE_ITEM_SLOTS,
        dense_max_items(qvecs_t.shape[1], out.numel()),
        device,
        stream,
    )
    stream_select.launches += 1
    return out


#: launches of the CUDA kernel (the plain version does not count)
stream_select.launches = 0


def stream_select_plain(
    table: torch.Tensor,
    qvecs_t: torch.Tensor,
    cand3: torch.Tensor,
    tile_idx: torch.Tensor,
    r: int = KERNEL_TILE_ROWS,
    precision: str = "exact",
) -> torch.Tensor:
    """Plain PyTorch version of K2 (same arguments and result).

    Each slot is the same dot as in K1's plain version: ``"exact"`` and
    ``"high"`` fp32, ``"fast"`` bf16-rounded operands (elementwise multiply
    and fp32 sum, no matmul).
    """
    return stream_select_pairwise_plain(
        table, qvecs_t.t(), cand3, tile_idx, r, exact=precision != "fast"
    )


def stream_select_auto(
    table: torch.Tensor,
    qvecs_t: torch.Tensor,
    cand3: torch.Tensor,
    tile_idx: torch.Tensor,
    r: int = KERNEL_TILE_ROWS,
    precision: str = "exact",
) -> torch.Tensor:
    """Route a streamed layout to K1 or K2 as ``fastforward_tpu`` does
    (``ops/stream_kernel.py:242-253``).

    2D tables, and integer (int8 code) tables whose slot capacity fits the
    tile rows, go to K1 (``exact`` for the ``"exact"`` and ``"high"``
    tiers); other 3D tables, and int8 tables with ``cap > r`` (dense tiles),
    go to K2.  Arguments as :func:`stream_select`; for K1 the queries are
    ``qvecs_t.t()``, copied only if that is not contiguous.
    """
    if precision not in SELECT_TIERS:
        raise ValueError(f"precision must be one of {SELECT_TIERS}, got {precision!r}")
    if table.ndim == 2 or (
        not table.dtype.is_floating_point and cand3.shape[1] * 128 <= r
    ):
        return stream_select_pairwise(
            table, qvecs_t.t().contiguous(), cand3, tile_idx, r=r,
            exact=precision != "fast",
        )
    return stream_select(table, qvecs_t, cand3, tile_idx, r=r, precision=precision)
