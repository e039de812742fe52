"""Profiling hooks around the scoring hot path.

Set ``FFTPU_TRACE_DIR=/path`` to capture a ``torch.profiler`` trace (host
and CUDA activity) of every ``Index.__call__``; each call writes one Chrome
trace file into that directory (viewable with Perfetto).  :func:`annotate`
names the host phases of a call (``ff.*`` ranges) in any such trace.
"""

import os
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path


@contextmanager
def _torch_trace(trace_dir: str):
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    Path(trace_dir).mkdir(parents=True, exist_ok=True)
    name = f"ff_call_{os.getpid()}_{time.time_ns()}.json"
    prof.export_chrome_trace(str(Path(trace_dir) / name))


def maybe_trace():
    """Context manager: a torch profiler trace when ``FFTPU_TRACE_DIR`` is set."""
    trace_dir = os.environ.get("FFTPU_TRACE_DIR")
    if trace_dir:
        return _torch_trace(trace_dir)
    return nullcontext()


def annotate(name: str):
    """Named range for a host-side phase (``torch.profiler.record_function``;
    a few microseconds when no profiler is running)."""
    import torch

    return torch.profiler.record_function(name)
