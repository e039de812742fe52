"""Indexes: the vector store + scoring engine on one torch device."""

from fastforward_tpu_torch.index.base import Index, ScoreFuture
from fastforward_tpu_torch.index.disk import OnDiskIndex
from fastforward_tpu_torch.index.memory import InMemoryIndex
from fastforward_tpu_torch.index.mode import Mode

__all__ = ["Index", "Mode", "InMemoryIndex", "OnDiskIndex", "ScoreFuture"]
