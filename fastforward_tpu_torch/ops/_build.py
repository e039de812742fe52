"""Build the CUDA kernels with ``nvcc`` at first use and load them.

Each ``csrc/*.cu`` source exposes a plain C interface and is compiled on its
own into a shared object in the port's gitignored build directory, named
after the source's hash (an edited source rebuilds).  The object is loaded
with ``ctypes``; nothing here includes PyTorch's headers.  Nothing is built
when the module is imported.
"""

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

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
        return build_object(CSRC / f"{name}.cu", [nvcc_path(), *NVCC_FLAGS], 900)
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
