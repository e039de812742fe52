"""The device the port runs on: the card unless the caller names another,
and the guard that keeps fp32 matmuls in IEEE fp32 on it."""

import contextlib
import threading

import torch

# the TF32 switch is one flag of the process: blocks of several threads
# (a server's pool encoding queries, a k-means fit) take turns with it
_FP32_LOCK = threading.RLock()


def resolve_device(device: "str | torch.device | None") -> torch.device:
    """The device an index, a quantizer or an encoder runs on: the card
    unless the caller names another.

    :raises RuntimeError: When a CUDA device is asked for (or implied by
        ``None``) and none is available.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


@contextlib.contextmanager
def fp32_matmul(device: torch.device):
    """Run CUDA matmuls in IEEE fp32 (TF32 off) inside the block, whatever
    the process has set.

    The switch is process-global, so the block holds a lock for its whole
    length: two threads' blocks cannot restore each other's flag, and a
    thread nested in its own block re-enters.  A thread outside any block
    may see TF32 off while another thread's block runs, which only makes its
    matmuls more precise.  Nothing changes for other devices.
    """
    if device.type != "cuda":
        yield
        return
    with _FP32_LOCK:
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
