"""K3 and K4, streamed ADC over PQ codes: CUDA kernel wrappers and plain versions.

The port of ``fastforward_tpu/ops/stream_kernel_pq.py``: K3,
``stream_select_pq_pairwise`` (Pallas body ``_adc_pairwise_kernel``), and
K4, ``stream_select_pq`` (Pallas body ``_adc_kernel``), with
``stream_select_pq_auto`` routing between them as the JAX package does.
ADC (asymmetric distance computation) scores a query against PQ codes
without decoding the row first.  Contract: for each slot ``s`` of virtual
tile ``t``, with ``c = cand3[t, s]``, ``local = c // Qb``, ``qno = c % Qb``
and ``row = tile_idx[t] * r + local``,

    out[t, s] = sum_m codebooks[m, codes[row, m]] . q[qno, m*Ds:(m+1)*Ds]

Codes are compact ``(N_pad, M)`` uint8 (Ks <= 256) and the codebooks fp32
``(M, Ks, Ds)``; the TPU kernels' 128-lane code padding and block-diagonal
bf16 codebooks are artifacts of the TPU's layout and are not carried over.
Tiers follow each TPU kernel: K3 ``exact=True`` (the ``"exact"`` and
``"high"`` tiers) is a true fp32 dot, ``exact=False`` rounds codeword and
query to bf16; K4 ``"exact"`` is fp32, ``"high"`` rounds the codewords to
bf16, ``"fast"`` rounds codewords and query.  Padding slots carry
``local 0`` and ``qno Qb - 1`` and are computed like any other slot.

Each wrapper launches its hand-written CUDA kernel (``csrc/*.cu``) for CUDA
tensors and runs its plain PyTorch version only for CPU tensors.  On the
card both kernels are query-major (``csrc/adc_lut.cuh``): one call groups
the slots by query (``csrc/query_groups.cuh``, shared with K1 and K2),
cuts each query's slots into work items of at most ``ADC_ITEM_SLOTS``
slots, builds each query's lookup table once, and scores every item from
its query's table staged in shared memory.  The wrapper sizes the
grouping's scratch (:func:`adc_scratch_words`) and the tables'
(:func:`adc_table_queries`), and bounds the number of items
(:func:`adc_max_items`).
"""

import ctypes

import torch

from fastforward_tpu_torch.ops import _build, query_groups

#: rows per code tile (the layout's tile granularity)
KERNEL_PQ_TILE_ROWS = 512

#: precision tiers of K4
PQ_TIERS = ("exact", "high", "fast")

#: largest codebook size the uint8 codes address
_MAX_KS = 256

#: slots per work item of the query-major kernels (at most 512 threads x 4)
ADC_ITEM_SLOTS = 2048

#: most bytes of lookup tables one launch of the table kernel writes (the
#: queries' tables come in groups of this size)
ADC_TABLE_BYTES = 64 << 20

#: entries per subspace of a lookup table (any uint8 code addresses one)
_TABLE_WIDTH = 256

#: slots per step of the plain versions (bounds their gathered temporaries)
_PLAIN_CHUNK_SLOTS = 1 << 17


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

#: argument types of ``ff_stream_select_pq_pairwise``: codes, m, codebooks,
#: ks, ds, q, cand, tile_idx, out, slots, cap, qb, r, exact, scratch, item
#: slots, max items, table scratch, table queries, device, stream
_PAIRWISE_ARGS = (
    _P, _I, _P, _I, _I, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _P, _I, _LL, _P, _I, _I, _P,
)

#: argument types of ``ff_stream_select_pq``: codes, m, codebooks, ks, ds,
#: q, q stride along dim, q stride along queries, cand, tile_idx, out,
#: virtual tiles, cap, qb, r, tier, scratch, item slots, max items, table
#: scratch, table queries, device, stream
_SELECT_ARGS = (
    _P, _I, _P, _I, _I, _P, _LL, _LL, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _LL, _P, _I,
    _I, _P,
)


#: 64-bit words of the grouping scratch (:func:`query_groups.scratch_words`)
adc_scratch_words = query_groups.scratch_words


def adc_max_items(qb: int, n_slots: int) -> int:
    """A bound on the work items of ``n_slots`` slots over ``qb`` queries
    at ``ADC_ITEM_SLOTS`` slots an item (:func:`query_groups.max_items`)."""
    return query_groups.max_items(qb, n_slots, ADC_ITEM_SLOTS)


def adc_table_queries(qb: int, m: int) -> int:
    """Queries whose lookup tables (``m * 256`` fp32 each) one group holds:
    all ``qb`` where they fit ``ADC_TABLE_BYTES``, else as many as fit (at
    least one)."""
    return max(1, min(qb, ADC_TABLE_BYTES // (m * _TABLE_WIDTH * 4)))


def _launch_adc(name, argtypes, head, qb, m, n_slots, device, stream) -> None:
    """Allocate the query-major kernels' scratch (grouping words and lookup
    tables) and call ``ff_<name>`` with ``(*head, scratch, item slots, item
    bound, tables, table queries, device, stream)``."""
    scratch = query_groups.scratch(qb, n_slots, device)
    groups = adc_table_queries(qb, m)
    tables = torch.empty(groups * m * _TABLE_WIDTH, dtype=torch.float32, device=device)
    _build.bind(name, argtypes)(
        *head, scratch.data_ptr(), ADC_ITEM_SLOTS, adc_max_items(qb, n_slots),
        tables.data_ptr(), groups, device, stream,
    )


def _check(codes, codebooks, q, cand3, tile_idx, r, transposed) -> int:
    """Validate the PQ kernels' contract; return ``Qb``."""
    if codes.dtype != torch.uint8:
        raise TypeError(
            f"codes must be uint8 (Ks <= 256; wider codes are not ported), got {codes.dtype}"
        )
    if codes.ndim != 2 or codes.shape[0] % r:
        raise ValueError(f"codes must be (N_pad, M) with N_pad % r == 0, got {tuple(codes.shape)}, r={r}")
    m = codes.shape[1]
    if codebooks.dtype != torch.float32 or codebooks.ndim != 3 or codebooks.shape[0] != m:
        raise ValueError(f"codebooks must be fp32 ({m}, Ks, Ds), got {codebooks.dtype} {tuple(codebooks.shape)}")
    if codebooks.shape[1] > _MAX_KS:
        raise ValueError(f"uint8 codes address at most {_MAX_KS} codewords, got Ks={codebooks.shape[1]}")
    dim = m * codebooks.shape[2]
    want = f"({dim}, Qb)" if transposed else f"(Qb, {dim})"
    if q.dtype != torch.float32 or q.ndim != 2 or q.shape[0 if transposed else 1] != dim:
        raise ValueError(f"queries must be fp32 {want}, got {q.dtype} {tuple(q.shape)}")
    if cand3.dtype != torch.int32 or cand3.ndim != 3 or cand3.shape[2] != 128:
        raise ValueError(f"cand3 must be int32 (Tv, CAP/128, 128), got {cand3.dtype} {tuple(cand3.shape)}")
    if tile_idx.dtype != torch.int32 or tuple(tile_idx.shape) != (cand3.shape[0],):
        raise ValueError(f"tile_idx must be int32 ({cand3.shape[0]},), got {tile_idx.dtype} {tuple(tile_idx.shape)}")
    qb = q.shape[1 if transposed else 0]
    if qb * r > 2**31 - 1:
        raise ValueError("Qb * r must fit the int32 packing")
    devices = {t.device for t in (codes, codebooks, q, cand3, tile_idx)}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {devices}")
    return qb


def stream_select_pq_pairwise(
    codes: torch.Tensor,
    codebooks: torch.Tensor,
    qvecs: torch.Tensor,
    cand3: torch.Tensor,
    tile_idx: torch.Tensor,
    r: int = KERNEL_PQ_TILE_ROWS,
    exact: bool = True,
) -> torch.Tensor:
    """ADC-score every candidate slot: K3 on the card, the plain version on
    CPU.

    :param codes: PQ codes, ``(N_pad, M)`` uint8, ``N_pad % r == 0``.
    :param codebooks: Codebooks, ``(M, Ks, Ds)`` fp32, ``Ks <= 256``.
    :param qvecs: Query vectors (OPQ-rotated where applicable),
        ``(Qb, M * Ds)`` fp32.
    :param cand3: Packed candidates ``local * Qb + qno``, ``(Tv, CAP/128,
        128)`` int32 (values are not range-checked on the card).
    :param tile_idx: Base code tile per virtual tile, ``(Tv,)`` int32.
    :param r: Rows per code tile.
    :param exact: True fp32 ADC dots vs bf16-rounded codewords and queries.
    :raises ValueError: On shapes, layouts or devices the kernel does not take.
    :raises TypeError: On codes wider than uint8.
    :raises RuntimeError: When the launch fails (with the CUDA error).
    :return: Scores per slot, ``(Tv, CAP/128, 128)`` fp32.
    """
    qb = _check(codes, codebooks, qvecs, cand3, tile_idx, r, transposed=False)
    if codes.device.type == "cpu":
        return stream_select_pq_pairwise_plain(codes, codebooks, qvecs, cand3, tile_idx, r, exact)
    device, stream = _build.cuda_target(
        (("codes", codes), ("codebooks", codebooks), ("qvecs", qvecs), ("cand3", cand3),
         ("tile_idx", tile_idx))
    )
    out = torch.empty_like(cand3, dtype=torch.float32)
    m, ks, ds = codebooks.shape
    head = (
        codes.data_ptr(), m, codebooks.data_ptr(), ks, ds, qvecs.data_ptr(), cand3.data_ptr(),
        tile_idx.data_ptr(), out.data_ptr(), out.numel(), cand3.shape[1] * 128, qb, r, int(exact),
    )
    _launch_adc("stream_select_pq_pairwise", _PAIRWISE_ARGS, head, qb, m, out.numel(), device,
                stream)
    stream_select_pq_pairwise.launches += 1
    return out


#: launches of the CUDA kernel (the plain version does not count)
stream_select_pq_pairwise.launches = 0


def stream_select_pq(
    codes: torch.Tensor,
    codebooks: torch.Tensor,
    qvecs_t: torch.Tensor,
    cand3: torch.Tensor,
    tile_idx: torch.Tensor,
    r: int = KERNEL_PQ_TILE_ROWS,
    precision: str = "exact",
) -> torch.Tensor:
    """ADC-score every candidate slot of dense tiles: K4 on the card, the
    plain version on CPU.

    Arguments as :func:`stream_select_pq_pairwise`, except that the queries
    arrive transposed, ``(M * Ds, Qb)`` fp32 with any strides (the
    transposed view ``q.t()`` of a row-major block reads fastest), and the
    tier is ``precision``: ``"exact"`` (fp32), ``"high"`` (bf16-rounded
    codewords, fp32 query) or ``"fast"`` (both rounded to bf16).

    :raises ValueError: On shapes, layouts, tiers or devices the kernel does
        not take.
    :raises TypeError: On codes wider than uint8.
    :raises RuntimeError: When the launch fails (with the CUDA error).
    :return: Scores per slot, ``(Tv, CAP/128, 128)`` fp32.
    """
    if precision not in PQ_TIERS:
        raise ValueError(f"precision must be one of {PQ_TIERS}, got {precision!r}")
    qb = _check(codes, codebooks, qvecs_t, cand3, tile_idx, r, transposed=True)
    if codes.device.type == "cpu":
        return stream_select_pq_plain(codes, codebooks, qvecs_t, cand3, tile_idx, r, precision)
    device, stream = _build.cuda_target(
        (("codes", codes), ("codebooks", codebooks), ("cand3", cand3), ("tile_idx", tile_idx))
    )
    out = torch.empty_like(cand3, dtype=torch.float32)
    m, ks, ds = codebooks.shape
    head = (
        codes.data_ptr(), m, codebooks.data_ptr(), ks, ds, qvecs_t.data_ptr(),
        qvecs_t.stride(0), qvecs_t.stride(1), cand3.data_ptr(), tile_idx.data_ptr(),
        out.data_ptr(), cand3.shape[0], cand3.shape[1] * 128, qb, r, PQ_TIERS.index(precision),
    )
    _launch_adc("stream_select_pq", _SELECT_ARGS, head, qb, m, out.numel(), device, stream)
    stream_select_pq.launches += 1
    return out


#: launches of the CUDA kernel (the plain version does not count)
stream_select_pq.launches = 0


def _adc_plain(codes, codebooks, q, cand3, tile_idx, r, round_codewords, round_query):
    """Slot-wise ADC: gather each slot's codewords and query, multiply
    elementwise and sum in fp32 (no matmul, so no TF32 either)."""
    qb = q.shape[0]
    m, _, ds = codebooks.shape
    cand = cand3.reshape(-1).long()
    tiles = tile_idx.long().repeat_interleave(cand3.shape[1] * 128)
    row = tiles * r + cand // qb
    qno = cand % qb
    cb = _round_bf16(codebooks) if round_codewords else codebooks.float()
    qq = _round_bf16(q) if round_query else q.float()
    qq = qq.reshape(qb, m, ds)
    sub = torch.arange(m, device=codes.device)[None, :]
    out = torch.empty(cand.shape[0], dtype=torch.float32, device=codes.device)
    for lo in range(0, cand.shape[0], _PLAIN_CHUNK_SLOTS):
        hi = lo + _PLAIN_CHUNK_SLOTS
        words = cb[sub, codes[row[lo:hi]].long()]  # (S, M, Ds)
        out[lo:hi] = (words * qq[qno[lo:hi]]).sum((1, 2))
    return out.view(cand3.shape)


def stream_select_pq_pairwise_plain(
    codes: torch.Tensor,
    codebooks: torch.Tensor,
    qvecs: torch.Tensor,
    cand3: torch.Tensor,
    tile_idx: torch.Tensor,
    r: int = KERNEL_PQ_TILE_ROWS,
    exact: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version of K3 (same arguments and result)."""
    return _adc_plain(codes, codebooks, qvecs, cand3, tile_idx, r, not exact, not exact)


def stream_select_pq_plain(
    codes: torch.Tensor,
    codebooks: torch.Tensor,
    qvecs_t: torch.Tensor,
    cand3: torch.Tensor,
    tile_idx: torch.Tensor,
    r: int = KERNEL_PQ_TILE_ROWS,
    precision: str = "exact",
) -> torch.Tensor:
    """Plain PyTorch version of K4 (same arguments and result)."""
    return _adc_plain(
        codes, codebooks, qvecs_t.t(), cand3, tile_idx, r,
        round_codewords=precision != "exact", round_query=precision == "fast",
    )


def stream_select_pq_auto(
    codes: torch.Tensor,
    codebooks: torch.Tensor,
    qvecs_t: torch.Tensor,
    cand3: torch.Tensor,
    tile_idx: torch.Tensor,
    r: int = KERNEL_PQ_TILE_ROWS,
    precision: str = "exact",
) -> torch.Tensor:
    """Route a streamed PQ layout to K3 or K4 as ``fastforward_tpu`` does
    (``ops/stream_kernel_pq.py:506-515``): ``cap <= r`` goes to K3
    (``exact`` for the ``"exact"`` and ``"high"`` tiers), ``cap > r`` to K4.
    Arguments as :func:`stream_select_pq`; for K3 the queries are
    ``qvecs_t.t()``, copied only if that is not contiguous.
    """
    if precision not in PQ_TIERS:
        raise ValueError(f"precision must be one of {PQ_TIERS}, got {precision!r}")
    if cand3.shape[1] * 128 <= r:
        return stream_select_pq_pairwise(
            codes, codebooks, qvecs_t.t().contiguous(), cand3, tile_idx, r=r,
            exact=precision != "fast",
        )
    return stream_select_pq(codes, codebooks, qvecs_t, cand3, tile_idx, r=r, precision=precision)
