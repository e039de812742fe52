"""Multi-device tables: the mesh configuration and the sharded scoring.

The port of ``fastforward_tpu/parallel``.  A table is row-sharded over the
mesh's ``shard`` axis and candidate pairs split over its ``data`` axis
(:mod:`~fastforward_tpu_torch.parallel.sharded`); only scores cross devices,
never rows.  :mod:`~fastforward_tpu_torch.parallel.multihost` extends the
same programs to several processes over ``torch.distributed``, each process
holding the rows of its own shards.
"""

from fastforward_tpu_torch.parallel.mesh import Mesh, MeshConfig

__all__ = ["Mesh", "MeshConfig"]
