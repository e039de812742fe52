"""Sizing of the query grouping that the query-major kernels share.

On the card, K1 and K2 (``csrc/dense_dot.cuh``) and K3 and K4
(``csrc/adc_lut.cuh``) group a streamed layout's slots by query
(``csrc/query_groups.cuh``) and cut each query's slots into work items of
at most ``item_slots`` slots, one block per item.  The wrappers allocate
the grouping's scratch here and bound the number of items, which is the
number of blocks the scoring kernel launches.
"""

import torch


def scratch_words(qb: int, n_slots: int) -> int:
    """64-bit words of the grouping scratch: a cursor per query, the slot
    and work-item offsets (``qb + 1`` each) and the slots in query order."""
    return 3 * qb + 2 + n_slots


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
