"""Several processes serving one index over ``torch.distributed``.

The port of ``fastforward_tpu/parallel/multihost.py``.  Every process runs
the same host code over the same ranking (the contract of the JAX
package's multi-controller programs: the collectives must line up), and
lays the table out over the same ``(data, shard)`` mesh of the job's
devices.  ``MeshConfig`` lays the ``shard`` axis across processes, so each
process uploads only the rows of its own shards (:func:`put_row_sharded`;
:func:`put_row_sharded_lazy` reads only those rows, e.g. from HDF5).

The combine of scores is one ``all_reduce`` SUM: each pair is owned by
exactly one shard, and every other process contributes zeros, so the sum is
the score (the JAX package's ``psum``).  The gloo backend takes CUDA tensors
for ``all_reduce`` and ``broadcast`` only, so anything gathered goes
through host tensors (:func:`fetch_np`).

Single process: every helper places on the mesh's local devices directly.
"""

import logging

import numpy as np
import torch

from fastforward_tpu_torch.ops.upload import _torch_dtype
from fastforward_tpu_torch.parallel.mesh import Mesh, process_count, process_index

LOGGER = logging.getLogger(__name__)


def initialize(
    coordinator_address: "str | None" = None,
    num_processes: "int | None" = None,
    process_id: "int | None" = None,
    **kwargs,
) -> None:
    """Join a ``torch.distributed`` job (call before building a mesh).

    :param coordinator_address: ``host:port`` of process 0 (``None``: the
        ``MASTER_ADDR``/``MASTER_PORT`` environment).
    :param num_processes: Processes in the job.
    :param process_id: This process's rank in ``[0, num_processes)``.
    :param kwargs: Forwarded to ``torch.distributed.init_process_group``
        (``backend``, ``timeout``, ...).
    """
    import torch.distributed as dist

    init = f"tcp://{coordinator_address}" if coordinator_address is not None else "env://"
    dist.init_process_group(init_method=init, world_size=num_processes, rank=process_id, **kwargs)
    LOGGER.info(
        "joined distributed job: process %d/%d (%s)",
        dist.get_rank(), dist.get_world_size(), dist.get_backend(),
    )


def is_multiprocess() -> bool:
    """Whether this process is one of several in a ``torch.distributed`` job."""
    return process_count() > 1


def all_reduce_sum(tensor: torch.Tensor) -> torch.Tensor:
    """Sum ``tensor`` over the job's processes in place (a no-op in one
    process) and return it."""
    if process_count() > 1:
        import torch.distributed as dist

        dist.all_reduce(tensor, op=dist.ReduceOp.SUM)
    return tensor


def put_row_sharded(
    mesh: Mesh,
    host_array: np.ndarray,
    shape: "tuple | None" = None,
    dtype: "torch.dtype | None" = None,
    stage_dtype=None,
):
    """Place host rows row-sharded over the mesh's ``shard`` axis; this
    process uploads only the rows of its own shards.

    :param mesh: The mesh.
    :param host_array: Host rows ``(n, ...)``; rows past ``n`` up to
        ``shape[0]`` are zeros.
    :param shape: The table's shape (default ``host_array.shape``);
        ``shape[0]`` must divide by the shard count.
    :param dtype: Device dtype (default the host's).
    :param stage_dtype: Host dtype the rows cross the link in.
    :return: A :class:`~fastforward_tpu_torch.parallel.sharded.ShardedTable`.
    """
    from fastforward_tpu_torch.parallel.sharded import ShardedTable

    shape = tuple(host_array.shape) if shape is None else tuple(shape)
    return ShardedTable.from_reader(
        mesh, shape, lambda start, stop: host_array[start : min(stop, host_array.shape[0])],
        dtype=dtype, stage_dtype=stage_dtype,
    )


def put_row_sharded_lazy(mesh: Mesh, shape: tuple, dtype, read_rows):
    """Row-sharded placement fed by a lazy row reader: the table never
    exists as one host array.

    Each of this process's shards asks ``read_rows(start, stop)`` for its
    row range (``(stop - start, ...)`` numpy); the shard's other data
    replicas are served from a one-slot memo.
    """
    from fastforward_tpu_torch.parallel.sharded import ShardedTable

    if not isinstance(dtype, torch.dtype):
        dtype = _torch_dtype(np.dtype(dtype))
    return ShardedTable.from_reader(mesh, tuple(shape), read_rows, dtype=dtype)


def put_replicated(mesh: Mesh, host_array: np.ndarray):
    """Place a host array on every local device of the mesh (a
    :class:`~fastforward_tpu_torch.parallel.sharded.Replicated`)."""
    from fastforward_tpu_torch.parallel.sharded import Replicated

    host = torch.from_numpy(np.ascontiguousarray(host_array))
    return Replicated({dev: host.to(dev) for dev in mesh.local_devices})


def fetch_np(arr) -> np.ndarray:
    """A tensor, or a sharded table gathered whole, on the host.

    A sharded table's shards are gathered from every process (through
    host memory: each process sends the shards it holds).
    """
    from fastforward_tpu_torch.parallel.sharded import ShardedTable

    if not isinstance(arr, ShardedTable):
        return arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
    mine = {s: arr.shard(s).cpu().numpy() for s in arr.local_shards()}
    parts = [mine]
    if process_count() > 1:
        import torch.distributed as dist

        parts = [None] * process_count()
        dist.all_gather_object(parts, mine)
    shards: dict = {}
    for part in parts:
        shards.update(part)
    return np.concatenate([shards[s] for s in range(arr.num_shards)])


__all__ = [
    "all_reduce_sum",
    "fetch_np",
    "initialize",
    "is_multiprocess",
    "process_count",
    "process_index",
    "put_replicated",
    "put_row_sharded",
    "put_row_sharded_lazy",
]
