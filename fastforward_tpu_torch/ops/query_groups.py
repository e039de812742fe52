"""Sizing of the query grouping that the query-major kernels share.

On the card, K1 and K2 (``csrc/dense_dot.cuh``) and K3 and K4
(``csrc/adc_lut.cuh``) group a streamed layout's slots by query
(``csrc/query_groups.cuh``) and cut each query's slots into work items of
at most ``item_slots`` slots, one block per item; a query with fewer slots
than the call's limit is short and gets no item (K3/K4 score it slot by
slot, K1/K2 pack it with other short queries).  The wrappers allocate the
grouping's scratch here and bound the number of items, which is the number
of blocks the scoring kernel launches; :func:`routes_plain` and
:func:`routes` give each query's route.
"""

import ctypes

import torch

from fastforward_tpu_torch.ops import _build

#: a query's route as the grouping's scan decides it on the card
#: (``csrc/query_groups.cuh``): no slots, a long query (its own work
#: items), a short one (fewer slots than the call's limit)
ROUTE_NONE, ROUTE_LONG, ROUTE_SHORT = 0, 1, 2

#: argument types of a kernel object's ``ff_routes``: cand, slots, qb,
#: slot limit, scratch, routes, device, stream
_ROUTES_ARGS = (
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
)


def scratch_words(qb: int, n_slots: int) -> int:
    """64-bit words of the grouping scratch: a cursor per query, the slot
    and work-item offsets (``qb + 1`` each), the span of the short queries'
    lists (2) and the slots in query order."""
    return 3 * qb + 4 + n_slots


def max_items(qb: int, n_slots: int, item_slots: int) -> int:
    """A bound on the work items of ``n_slots`` slots over ``qb`` queries:
    a query with ``c`` slots takes ``ceil(c / item_slots)``, at most
    ``c // item_slots + 1`` items, and at most ``min(qb, n_slots)`` queries
    own slots.  The scoring kernel launches this many blocks; those past the
    last item leave at once."""
    return n_slots // item_slots + min(qb, n_slots)


def scratch(qb: int, n_slots: int, device) -> torch.Tensor:
    """The grouping scratch for one call (uninitialised: the kernels clear
    what they read)."""
    return torch.empty(scratch_words(qb, n_slots), dtype=torch.int64, device=device)


def routes_plain(cand3: torch.Tensor, qb: int, slot_limit: int) -> torch.Tensor:
    """Each query's route for the packed candidates ``cand3`` at
    ``slot_limit``: ``ROUTE_NONE`` without slots, ``ROUTE_SHORT`` with
    fewer than ``slot_limit``, else ``ROUTE_LONG`` (``(qb,)`` int32, on
    ``cand3``'s device): the kernels' rule, in PyTorch."""
    counts = torch.bincount(cand3.reshape(-1).long() % qb, minlength=qb)
    routes = torch.where(counts < slot_limit, ROUTE_SHORT, ROUTE_LONG)
    return torch.where(counts == 0, ROUTE_NONE, routes).to(torch.int32)


def routes(kernel: str, cand3: torch.Tensor, qb: int, slot_limit: int) -> torch.Tensor:
    """Each query's route as the kernels of ``csrc/<kernel>.cu`` take it on
    the card (the grouping and the rule they run, through the object's
    ``ff_routes``), or :func:`routes_plain` for CPU tensors.

    :param kernel: The kernel source's stem.
    :param cand3: Packed candidates ``local * Qb + qno``, int32, contiguous.
    :param qb: Queries of the block.
    :param slot_limit: Queries with fewer slots are short.
    :raises ValueError: On a tensor the card cannot take.
    :raises RuntimeError: When the launch fails (with the CUDA error).
    :return: ``(qb,)`` int32 of ``ROUTE_NONE``, ``ROUTE_LONG`` and ``ROUTE_SHORT``.
    """
    if cand3.dtype != torch.int32:
        raise ValueError(f"cand3 must be int32, got {cand3.dtype}")
    if cand3.device.type == "cpu":
        return routes_plain(cand3, qb, slot_limit)
    device, stream = _build.cuda_target((("cand3", cand3),))
    out = torch.empty(qb, dtype=torch.int32, device=cand3.device)
    work = scratch(qb, cand3.numel(), cand3.device)
    _build.bind(kernel, _ROUTES_ARGS, "routes")(
        cand3.data_ptr(), cand3.numel(), qb, slot_limit, work.data_ptr(), out.data_ptr(), device,
        stream,
    )
    return out
