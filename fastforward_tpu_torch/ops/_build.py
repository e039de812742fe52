"""Build the CUDA kernels with ``nvcc`` at first use, load and launch them.

Each ``csrc/<name>.cu`` source exposes a plain C interface, ``ff_<name>``
plus ``ff_cuda_error_string``, and is compiled on its own into a shared
object in the port's gitignored build directory, named after the hash of
the source and the shared ``csrc/*.cuh`` headers (an edit rebuilds).  The
object is loaded with ``ctypes``; nothing here includes PyTorch's headers.
Nothing is built when the module is imported.
"""

import ctypes
import functools
import os
import shutil
import subprocess
import threading
from collections.abc import Callable, Sequence
from pathlib import Path

import torch

from fastforward_tpu_torch.runtime.build import build_object

CSRC = Path(__file__).resolve().parent / "csrc"

#: target Hopper exactly: ``sm_90a`` also admits wgmma/setmaxnreg
NVCC_FLAGS = [
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
]

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_count_lock = threading.Lock()


def nvcc_path() -> str:
    """The ``nvcc`` to use: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``.

    :raises RuntimeError: When no ``nvcc`` is found.
    """
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [str(Path(home) / "bin" / "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_kernel(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` (if not built yet) and return the object.

    :raises RuntimeError: When ``nvcc`` fails, with its stderr.
    """
    try:
        return build_object(
            CSRC / f"{name}.cu", [nvcc_path(), *NVCC_FLAGS], 900, sorted(CSRC.glob("*.cuh"))
        )
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{e.stderr}") from e


def load_kernel(name: str) -> ctypes.CDLL:
    """Build (once per process) and ``ctypes``-load ``csrc/<name>.cu``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_kernel(name)))
            _libs[name] = lib
        return lib


@functools.cache
def bind(name: str, argtypes: tuple, entry_name: "str | None" = None) -> Callable[..., None]:
    """Build (once per process) and load ``csrc/<name>.cu``; return a caller
    of its entry ``ff_<entry_name or name>`` that raises when the launch
    fails.

    :param name: The kernel source's stem.
    :param argtypes: ``ctypes`` types of the entry's arguments.
    :param entry_name: Another entry of the same object.
    """
    lib = load_kernel(name)
    entry = getattr(lib, f"ff_{entry_name or name}")
    entry.argtypes = list(argtypes)
    entry.restype = ctypes.c_int
    lib.ff_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ff_cuda_error_string.restype = ctypes.c_char_p

    def launch(*args) -> None:
        rc = entry(*args)
        if rc != 0:
            msg = lib.ff_cuda_error_string(rc).decode()
            raise RuntimeError(f"{name} launch failed: {msg} ({rc})")

    return launch


def count_launch(wrapper: Callable) -> None:
    """Add one to ``wrapper.launches`` (kernels launch from several threads
    when a server prepares batches concurrently, and ``+=`` on an attribute
    is not atomic)."""
    with _count_lock:
        wrapper.launches += 1


def cuda_target(named: "Sequence[tuple[str, torch.Tensor]]") -> tuple[int, int]:
    """Where a kernel launches: the CUDA device index of the named tensors
    and the handle of its current stream.

    :raises ValueError: When the tensors are not on a CUDA device, or one of
        them is not contiguous.
    """
    dev = named[0][1].device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(index).cuda_stream
