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

Codes are compact ``(N_pad, M)`` uint8 (Ks <= 256), uint16 or uint32 (any
Ks the type addresses: the TPU kernels cast any code type to int32) and the
codebooks fp32 ``(M, Ks, Ds)``; the TPU kernels' 128-lane code padding and block-diagonal
bf16 codebooks are artifacts of the TPU's layout and are not carried over.
Tiers follow each TPU kernel: K3 ``exact=True`` (the ``"exact"`` and
``"high"`` tiers) is a true fp32 dot, ``exact=False`` rounds codeword and
query to bf16; K4 ``"exact"`` is fp32, ``"high"`` rounds the codewords to
bf16, ``"fast"`` rounds codewords and query.  Padding slots carry
``local 0`` and ``qno Qb - 1`` and are computed like any other slot.

Each wrapper launches its hand-written CUDA kernel (``csrc/*.cu``) for CUDA
tensors and runs its plain PyTorch version only for CPU tensors.  On the
card both kernels are query-major (``csrc/adc_lut.cuh``): one call groups
the slots by query (``csrc/query_groups.cuh``, shared with K1 and K2) and
then scores each query by one of two routes, chosen on the card from the
query's slot count:

- the table route, for a query with at least :func:`adc_slot_limit` slots:
  its lookup table (its subvector dotted with every codeword) is built
  once, its slots are cut into work items of at most ``ADC_ITEM_SLOTS``
  slots, and each item scores its slots from the table staged in shared
  memory (read from global memory where one subspace's table exceeds what
  a block stages, Ks > 24,576);
- the slot-wise route, for a query with fewer slots: each slot reads its
  ``M`` codewords and computes its entries itself, and no table is built.

A table costs the same whatever the query's slot count (built, written and
staged by every work item), a slot-wise slot costs ``M`` codeword reads, so
the table route pays where a query has many slots against ``Ks`` (the
flagship layouts, about 1,000 slots a query over Ks = 256) and the
slot-wise route where it has few (the hybrid tier's tail blocks, about 70
slots a query, and tables too wide to stage).  :func:`adc_slot_limit` is
that cost model, calibrated on the H100 (``scripts/torch_kernel_variants.py
--routes``, PERF.md); :func:`adc_query_routes_plain` predicts each query's
route from a layout and :func:`adc_routes` reads it from the card.  Both
routes compute every entry with the same FMA chain and add the entries in
subspace order, so they give the same bits; the route is a function of the
geometry only, never a recovery from an error.  The wrappers take a
keyword-only ``_route`` (``"auto"``, ``"table"`` or ``"slots"``) that
forces one route for tests and measurements; the plain versions have no
routes.  The wrapper sizes the grouping's scratch
(:func:`adc_scratch_words`) and the tables' (:func:`adc_table_width`,
:func:`adc_table_queries`), and bounds the number of items
(:func:`adc_max_items`).
"""

import ctypes
import math

import torch

from fastforward_tpu_torch.ops import _build, query_groups

#: rows per code tile (the layout's tile granularity)
KERNEL_PQ_TILE_ROWS = 512

#: precision tiers of K4
PQ_TIERS = ("exact", "high", "fast")

#: the code types the kernels read, with the bits of a code
CODE_BITS = {torch.uint8: 8, torch.uint16: 16, torch.uint32: 32}

#: slots per work item of the query-major kernels (at most 512 threads x 4)
ADC_ITEM_SLOTS = 2048

#: most bytes of lookup tables one launch of the table kernel writes (the
#: queries' tables come in groups of this size)
ADC_TABLE_BYTES = 64 << 20

#: entries per subspace of a uint8 code's lookup table (any uint8 code
#: addresses one)
_U8_TABLE_WIDTH = 256

#: the routes a call's queries may take: chosen per query (``"auto"``), or
#: every query forced to one
ADC_ROUTES = ("auto", "table", "slots")

#: a query's route as :func:`adc_routes` reports it
ROUTE_NONE, ROUTE_TABLE, ROUTE_SLOTS = (
    query_groups.ROUTE_NONE, query_groups.ROUTE_LONG, query_groups.ROUTE_SHORT)

#: the cost model of the route choice (:func:`adc_slot_limit`), in bytes a
#: subspace: a query's lookup table costs about ``ADC_TABLE_PASSES`` passes
#: over its ``width * 4`` bytes (built and written, then staged by its work
#: items) and ``ADC_TABLE_FIXED_BYTES`` more (a work item's start) whatever
#: its slot count; both fitted to the crossovers that
#: ``scripts/torch_kernel_variants.py --routes`` measured on the H100
#: (about 300 slots a query at PQ(96, 256), 700 at PQ(96, 1024); PERF.md)
ADC_TABLE_PASSES = 3.5
ADC_TABLE_FIXED_BYTES = 4864

#: bytes a block stages of a query's table (``kLutBytes`` of
#: ``csrc/adc_lut.cuh``); a subspace's table wider than that is read from
#: global memory
_STAGED_TABLE_BYTES = 96 * 1024

#: bytes one random read through L2 moves (a sector), and what a staged
#: table entry's read costs beside it (one shared-memory word)
_SECTOR_BYTES, _STAGED_ENTRY_BYTES = 32, 4

#: the slot limit of a call whose queries are all scored slot-wise (above
#: any slot count)
_NO_TABLES = 1 << 62

#: widest table the table kernel's grid covers (65,535 blocks of 256)
_MAX_TABLE_WIDTH = 65535 * 256

#: slots per step of the plain versions (bounds their gathered temporaries)
_PLAIN_CHUNK_SLOTS = 1 << 17


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

#: argument types of ``ff_stream_select_pq_pairwise``: codes, m, codebooks,
#: ks, ds, q, cand, tile_idx, out, slots, cap, qb, r, exact, scratch, item
#: slots, max items, table scratch, table queries, code bytes, table width,
#: slot limit, device, stream
_PAIRWISE_ARGS = (
    _P, _I, _P, _I, _I, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _P, _I, _LL, _P, _I, _I, _I,
    _LL, _I, _P,
)

#: argument types of ``ff_stream_select_pq``: codes, m, codebooks, ks, ds,
#: q, q stride along dim, q stride along queries, cand, tile_idx, out,
#: virtual tiles, cap, qb, r, tier, scratch, item slots, max items, table
#: scratch, table queries, code bytes, table width, slot limit, device,
#: stream
_SELECT_ARGS = (
    _P, _I, _P, _I, _I, _P, _LL, _LL, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _LL, _P, _I,
    _I, _I, _LL, _I, _P,
)


#: 64-bit words of the grouping scratch (:func:`query_groups.scratch_words`)
adc_scratch_words = query_groups.scratch_words


def adc_max_items(qb: int, n_slots: int) -> int:
    """A bound on the work items of ``n_slots`` slots over ``qb`` queries
    at ``ADC_ITEM_SLOTS`` slots an item (:func:`query_groups.max_items`)."""
    return query_groups.max_items(qb, n_slots, ADC_ITEM_SLOTS)


def adc_table_width(ks: int, code_dtype: torch.dtype = torch.uint8) -> int:
    """Entries of one subspace's lookup table: 256 for uint8 codes (any
    code addresses one), else ``Ks`` rounded up to a multiple of 4 (the
    float4 staging)."""
    return _U8_TABLE_WIDTH if code_dtype == torch.uint8 else -(-ks // 4) * 4


def adc_table_queries(qb: int, m: int, width: int = _U8_TABLE_WIDTH) -> int:
    """Queries whose lookup tables (``m * width`` fp32 each) one group
    holds: all ``qb`` where they fit ``ADC_TABLE_BYTES``, else as many as
    fit (at least one)."""
    return max(1, min(qb, ADC_TABLE_BYTES // (m * width * 4)))


def adc_slot_limit(ks: int, ds: int, code_dtype: torch.dtype = torch.uint8) -> int:
    """The slot count below which a query is scored slot-wise (the table
    route from this many slots on), a function of the geometry.

    A subspace of the table route costs a query about
    ``ADC_TABLE_FIXED_BYTES + ADC_TABLE_PASSES * width * 4`` bytes, then
    each slot one table read (a shared-memory word, or a sector through L2
    where the table is too wide to stage); the slot-wise route costs each
    slot one codeword read a subspace (``Ds * 4`` bytes in whole sectors)
    and nothing per query.  The two meet at ``(fixed + passes * width * 4)
    / (codeword - entry)`` slots (``M`` cancels); where a codeword read
    costs no more than a table read, every query is scored slot-wise.
    """
    width = adc_table_width(ks, code_dtype)
    codeword = -(-ds * 4 // _SECTOR_BYTES) * _SECTOR_BYTES
    entry = _SECTOR_BYTES if width * 4 > _STAGED_TABLE_BYTES else _STAGED_ENTRY_BYTES
    if codeword <= entry:
        return _NO_TABLES
    return math.ceil((ADC_TABLE_FIXED_BYTES + ADC_TABLE_PASSES * width * 4) / (codeword - entry))


def _check_route(route: str) -> None:
    if route not in ADC_ROUTES:
        raise ValueError(f"_route must be one of {ADC_ROUTES}, got {route!r}")


def adc_route_limit(route: str, ks: int, ds: int, code_dtype: torch.dtype = torch.uint8) -> int:
    """The slot limit the kernels get for ``route`` (one of
    ``ADC_ROUTES``): :func:`adc_slot_limit` for ``"auto"``, 0 (every query
    takes a table) for ``"table"``, above any count for ``"slots"``.

    :raises ValueError: On another route.
    """
    _check_route(route)
    if route == "table":
        return 0
    return _NO_TABLES if route == "slots" else adc_slot_limit(ks, ds, code_dtype)


#: each query's route for packed candidates at a slot limit, in PyTorch
#: (the kernels' rule; ``ROUTE_TABLE`` long, ``ROUTE_SLOTS`` short)
adc_query_routes_plain = query_groups.routes_plain


def adc_routes(cand3: torch.Tensor, qb: int, slot_limit: int) -> torch.Tensor:
    """Each query's route as K3 and K4 decide it on the card (the grouping
    and the rule of ``csrc/adc_lut.cuh``), or :func:`adc_query_routes_plain`
    for CPU tensors (:func:`query_groups.routes`; ``slot_limit`` as
    :func:`adc_route_limit` returns it)."""
    return query_groups.routes("stream_select_pq", cand3, qb, slot_limit)


def _launch_adc(name, argtypes, head, qb, codes, codebooks, n_slots, route, device, stream) -> None:
    """Allocate the query-major kernels' scratch (grouping words and lookup
    tables) and call ``ff_<name>`` with ``(*head, scratch, item slots, item
    bound, tables, table queries, code bytes, table width, slot limit,
    device, stream)``."""
    m, ks, ds = codebooks.shape
    width = adc_table_width(ks, codes.dtype)
    if width > _MAX_TABLE_WIDTH or m * width > 2**31 - 1:
        raise ValueError(f"the lookup tables of PQ({m}, {ks}) exceed the kernels' indexing")
    scratch = query_groups.scratch(qb, n_slots, device)
    groups = adc_table_queries(qb, m, width)
    tables = torch.empty(groups * m * width, dtype=torch.float32, device=device)
    _build.bind(name, argtypes)(
        *head, scratch.data_ptr(), ADC_ITEM_SLOTS, adc_max_items(qb, n_slots),
        tables.data_ptr(), groups, codes.element_size(), width,
        adc_route_limit(route, ks, ds, codes.dtype), device, stream,
    )


def _check(codes, codebooks, q, cand3, tile_idx, r, transposed) -> int:
    """Validate the PQ kernels' contract; return ``Qb``."""
    bits = CODE_BITS.get(codes.dtype)
    if bits is None:
        raise TypeError(f"codes must be uint8, uint16 or uint32, got {codes.dtype}")
    if codes.ndim != 2 or codes.shape[0] % r:
        raise ValueError(f"codes must be (N_pad, M) with N_pad % r == 0, got {tuple(codes.shape)}, r={r}")
    m = codes.shape[1]
    if codebooks.dtype != torch.float32 or codebooks.ndim != 3 or codebooks.shape[0] != m:
        raise ValueError(f"codebooks must be fp32 ({m}, Ks, Ds), got {codebooks.dtype} {tuple(codebooks.shape)}")
    if codebooks.shape[1] > 1 << bits:
        raise ValueError(
            f"{codes.dtype} codes address at most {1 << bits} codewords, got Ks={codebooks.shape[1]}"
        )
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
    *,
    _route: str = "auto",
) -> torch.Tensor:
    """ADC-score every candidate slot: K3 on the card, the plain version on
    CPU.

    :param codes: PQ codes, ``(N_pad, M)`` uint8, uint16 or uint32,
        ``N_pad % r == 0``.
    :param codebooks: Codebooks, ``(M, Ks, Ds)`` fp32, ``Ks`` at most what
        the code type addresses.
    :param qvecs: Query vectors (OPQ-rotated where applicable),
        ``(Qb, M * Ds)`` fp32.
    :param cand3: Packed candidates ``local * Qb + qno``, ``(Tv, CAP/128,
        128)`` int32 (values are not range-checked on the card).
    :param tile_idx: Base code tile per virtual tile, ``(Tv,)`` int32.
    :param r: Rows per code tile.
    :param exact: True fp32 ADC dots vs bf16-rounded codewords and queries.
    :param _route: Each query's route on the card: chosen from its slot
        count (``"auto"``), or forced (``"table"``, ``"slots"``; for tests
        and measurements: the scores are the same bits).
    :raises ValueError: On shapes, layouts, routes or devices the kernel
        does not take.
    :raises TypeError: On codes of another type than uint8, uint16 or
        uint32.
    :raises RuntimeError: When the launch fails (with the CUDA error).
    :return: Scores per slot, ``(Tv, CAP/128, 128)`` fp32.
    """
    qb = _check(codes, codebooks, qvecs, cand3, tile_idx, r, transposed=False)
    _check_route(_route)
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
    _launch_adc("stream_select_pq_pairwise", _PAIRWISE_ARGS, head, qb, codes, codebooks,
                out.numel(), _route, device, stream)
    _build.count_launch(stream_select_pq_pairwise)
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
    *,
    _route: str = "auto",
) -> torch.Tensor:
    """ADC-score every candidate slot of dense tiles: K4 on the card, the
    plain version on CPU.

    Arguments as :func:`stream_select_pq_pairwise`, except that the queries
    arrive transposed, ``(M * Ds, Qb)`` fp32 with any strides (the
    transposed view ``q.t()`` of a row-major block reads fastest), and the
    tier is ``precision``: ``"exact"`` (fp32), ``"high"`` (bf16-rounded
    codewords, fp32 query) or ``"fast"`` (both rounded to bf16).

    :raises ValueError: On shapes, layouts, tiers, routes or devices the
        kernel does not take.
    :raises TypeError: On codes of another type than uint8, uint16 or
        uint32.
    :raises RuntimeError: When the launch fails (with the CUDA error).
    :return: Scores per slot, ``(Tv, CAP/128, 128)`` fp32.
    """
    if precision not in PQ_TIERS:
        raise ValueError(f"precision must be one of {PQ_TIERS}, got {precision!r}")
    qb = _check(codes, codebooks, qvecs_t, cand3, tile_idx, r, transposed=True)
    _check_route(_route)
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
    _launch_adc("stream_select_pq", _SELECT_ARGS, head, qb, codes, codebooks, out.numel(),
                _route, device, stream)
    _build.count_launch(stream_select_pq)
    return out


#: launches of the CUDA kernel (the plain version does not count)
stream_select_pq.launches = 0


#: the signed type of each code type's width (gathers run on the signed view:
#: it indexes on every device)
_SIGNED_VIEW = {torch.uint16: (torch.int16, 0xFFFF), torch.uint32: (torch.int32, 0xFFFFFFFF)}


def take_rows(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``table[rows]`` in the table's own dtype (uint16 and uint32 rows are
    gathered through their signed view)."""
    signed = _SIGNED_VIEW.get(table.dtype)
    if signed is None:
        return table[rows]
    return table.view(signed[0])[rows].view(table.dtype)


def gather_codes(codes: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The code rows ``codes[rows]`` as int64 (uint16 and uint32 codes are
    gathered through their signed view and masked back)."""
    signed = _SIGNED_VIEW.get(codes.dtype)
    if signed is None:
        return codes[rows].long()
    dtype, mask = signed
    return codes.view(dtype)[rows].long() & mask


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
        words = cb[sub, gather_codes(codes, row[lo:hi])]  # (S, M, Ds)
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
