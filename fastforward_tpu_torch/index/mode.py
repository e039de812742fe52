"""Ranking mode: ID space + on-device aggregation variant.

(Reference: ``index/base.py:18-24``.)  On device the mode selects the segment
reduction applied to per-row dot products: MAXP -> segment max, AVEP ->
segment mean, FIRSTP/PASSAGE -> identity (one row per pair).
"""

from enum import Enum


class Mode(Enum):
    """Ranking mode of an index."""

    PASSAGE = 1
    MAXP = 2
    FIRSTP = 3
    AVEP = 4


#: Segment-reduction op per mode (flat layout, ``score_pairs_dense``).
REDUCE_OP = {
    Mode.MAXP: "max",
    Mode.AVEP: "mean",
    Mode.FIRSTP: "sum",
    Mode.PASSAGE: "sum",
}

#: Masked K-axis reduction per mode (grouped layout, the default path).
GROUPED_OP = {
    Mode.MAXP: "max",
    Mode.AVEP: "mean",
    Mode.FIRSTP: "first",
    Mode.PASSAGE: "first",
}
