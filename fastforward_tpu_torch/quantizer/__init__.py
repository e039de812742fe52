"""Quantizers: vector <-> compact code, scored without decoding on the card."""

from fastforward_tpu_torch.quantizer.base import Quantizer
from fastforward_tpu_torch.quantizer.pq import OPQ, PQ, NanoOPQ, NanoPQ
from fastforward_tpu_torch.quantizer.scalar import ScalarQuantizer

__all__ = ["Quantizer", "PQ", "OPQ", "NanoPQ", "NanoOPQ", "ScalarQuantizer"]
