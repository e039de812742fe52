"""Native host runtime: C++ ID maps and batch array construction."""

from fastforward_tpu_torch.runtime.idmap import NativeIdMap, PyIdMap, create_idmap

__all__ = ["create_idmap", "NativeIdMap", "PyIdMap"]
