"""Mesh configuration of multi-device tables.

The port of ``fastforward_tpu/parallel/mesh.py``.  The table is sharded
along its row axis over the ``shard`` axis; pair arrays are split over the
``data`` axis.  A :class:`Mesh` is a ``(data, shard)`` grid of torch
devices, each with the process that owns it: one process over several
cards (or several CPU slots, or one card named more than once), or several
processes joined by ``torch.distributed`` (``parallel.multihost``), each
with its local devices.
"""

from dataclasses import dataclass

import numpy as np
import torch


def process_index() -> int:
    """This process's rank in a ``torch.distributed`` job (0 outside one)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """Processes of the ``torch.distributed`` job (1 outside one)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


class Mesh:
    """A ``(data, shard)`` grid of devices.

    ``devices[d, s]`` is the torch device of grid position ``(d, s)`` as its
    own process sees it, and ``processes[d, s]`` that process's rank.  A
    process scores on its local positions only.
    """

    axis_names = ("data", "shard")

    def __init__(self, devices: np.ndarray, processes: np.ndarray, process: int = 0) -> None:
        self.devices = devices
        self.processes = processes
        self.process = process
        self.shape = {"data": int(devices.shape[0]), "shard": int(devices.shape[1])}

    @property
    def multiprocess(self) -> bool:
        """Whether the grid spans more than one process."""
        return bool((self.processes != self.processes.flat[0]).any())

    def is_local(self, d: int, s: int) -> bool:
        """Whether position ``(d, s)`` belongs to this process."""
        return int(self.processes[d, s]) == self.process

    def local_positions(self) -> "list[tuple[int, int]]":
        """This process's positions, data-major."""
        return [
            (d, s)
            for d in range(self.shape["data"])
            for s in range(self.shape["shard"])
            if self.is_local(d, s)
        ]

    @property
    def local_devices(self) -> "list[torch.device]":
        """The distinct devices of this process's positions, in grid order."""
        out: list[torch.device] = []
        for d, s in self.local_positions():
            dev = self.devices[d, s]
            if dev not in out:
                out.append(dev)
        return out

    def memory_of(self, d: int, s: int) -> object:
        """What position ``(d, s)``'s shard occupies: its card, or for a CPU
        slot the slot itself (the counterpart of one of the JAX package's
        virtual CPU devices: each slot counts as a device of its own)."""
        dev = self.devices[d, s]
        return dev if dev.type == "cuda" else (d, s)

    @property
    def memory_devices(self) -> "list[torch.device]":
        """One device for each memory of this process's positions, in grid
        order: each distinct card once, each CPU slot."""
        seen: dict = {}
        for d, s in self.local_positions():
            seen.setdefault(self.memory_of(d, s), self.devices[d, s])
        return list(seen.values())

    @property
    def shards_per_device(self) -> int:
        """The most distinct shards one memory of this process holds (1
        unless the mesh names a card more than once): what a per-device
        memory budget is divided by."""
        held: dict = {}
        for d, s in self.local_positions():
            held.setdefault(self.memory_of(d, s), set()).add(s)
        return max(len(shards) for shards in held.values())

    @property
    def first_device(self) -> torch.device:
        """Where this process gathers partial results: its first device."""
        return self.local_devices[0]

    def shard_home(self, s: int) -> "tuple[int, torch.device] | None":
        """The one position that scores shard ``s`` in the streamed path:
        the first data row holding it on this process, as ``(d, device)``;
        ``None`` when shard ``s`` is scored by another process (the
        process of its first data row owns it)."""
        if not self.is_local(0, s):
            return None
        return 0, self.devices[0, s]

    def __repr__(self) -> str:
        return f"Mesh(shape={self.shape}, process={self.process}, devices={self.devices.tolist()})"


@dataclass(frozen=True)
class MeshConfig:
    """Topology of a multi-device index.

    :param data: Devices along the pair (data-parallel) axis.
    :param shard: Devices the table's rows are sharded across.
    """

    data: int = 1
    shard: int = 1

    @property
    def num_devices(self) -> int:
        """Total devices required."""
        return self.data * self.shard

    def build(self, devices: "list | None" = None, device: "str | torch.device | None" = None) -> Mesh:
        """The ``(data, shard)`` mesh.

        Single process: consecutive devices fill the ``shard`` axis.
        Several processes: consecutive devices fill the ``data`` axis, so
        the ``shard`` axis crosses processes and each process holds only its
        shards' rows; the combine of scores then crosses processes, but it
        moves only scores.

        :param devices: Devices to use: torch devices (or their names) of
            this process, or ``(process, device)`` pairs.  Repeats are
            allowed (two shards on one card).  Default: for a CUDA index the
            visible cards of every process, for a CPU index ``num_devices``
            CPU slots (each holds its shard in host memory).
        :param device: The index's device, which picks the default devices
            (``None``: the card).
        :raises ValueError: When fewer devices exist than the mesh needs
            (it never falls back to fewer devices).
        """
        rank, world = process_index(), process_count()
        if devices is None:
            if torch.device("cuda" if device is None else device).type == "cuda":
                local = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            else:
                local = [torch.device("cpu")] * max(1, -(-self.num_devices // world))
            entries = [(r, dev) for r in range(world) for dev in local]
        else:
            entries = [
                (int(e[0]), torch.device(e[1])) if isinstance(e, tuple) else (rank, torch.device(e))
                for e in devices
            ]
        if len(entries) < self.num_devices:
            raise ValueError(f"Mesh needs {self.num_devices} devices, found {len(entries)}.")
        entries = entries[: self.num_devices]
        for r, dev in entries:
            if r == rank and dev.type == "cuda" and (dev.index or 0) >= torch.cuda.device_count():
                raise ValueError(f"Mesh device {dev} does not exist on this machine.")
        devs = np.empty(self.num_devices, dtype=object)
        devs[:] = [torch.device(dev.type, dev.index or 0) if dev.type == "cuda" else dev for _, dev in entries]
        procs = np.array([r for r, _ in entries], dtype=np.int64)
        if world > 1:
            devs = devs.reshape(self.shard, self.data).T
            procs = procs.reshape(self.shard, self.data).T
        else:
            devs = devs.reshape(self.data, self.shard)
            procs = procs.reshape(self.data, self.shard)
        mesh = Mesh(devs, procs, rank)
        if not mesh.local_positions():
            raise ValueError(f"process {rank} holds no device of the mesh {self}")
        return mesh
