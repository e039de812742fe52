"""The device the port runs on: the card unless the caller names another."""

import torch


def resolve_device(device: "str | torch.device | None") -> torch.device:
    """The device an index or a quantizer runs on: the card unless the
    caller names another.

    :raises RuntimeError: When a CUDA device is asked for (or implied by
        ``None``) and none is available.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the index "
            "on the CPU"
        )
    return dev
