"""A tower part's share of its least time: the encoder plug-in's
``least_parts_s`` of the part over the device time of the kernels launched
inside the part's ranges (``ff.attn``, ``ff.mlp``: one a layer and
micro-batch).

:func:`kernels_inside_s` is ``trace.kernels_inside_s`` for ranges by the
thousand: it finds each kernel's range by bisection over the merged
device-side twins instead of trying every twin.
"""

import bisect

from bench_port import spec, trace


def kernels_inside_s(profile: trace.Profile, name: str) -> float:
    """Seconds in which kernels launched inside ``name`` ranges ran (the
    union of the kernels that lie within one merged device-side twin)."""
    twins = trace.merged((s, e) for n, s, e in profile.annotations if n == name)
    starts = [s for s, _ in twins]
    inside = []
    for kname, s, e in profile.device:
        at = bisect.bisect_right(starts, s) - 1
        if at >= 0 and e <= twins[at][1] and trace.is_kernel(kname):
            inside.append((s, e))
    return sum(e - s for s, e in trace.merged(inside)) / 1e6


def roofline(run, part: str, span: str):
    """``least_parts_s(...)[part]`` of the traced calls over the kernels
    inside ``span``, in percent; ``None`` where the cell's encoder has no
    parts or the trace no such range."""
    if run.profile is None or not run.traced_calls:
        return None
    cell = run.cell
    encoder = spec.plugin(cell.root, "encoders", spec.encoder_name(cell))
    if not hasattr(encoder, "least_parts_s"):
        return None
    busy = kernels_inside_s(run.profile, span)
    if busy <= 0:
        return None
    least = encoder.least_parts_s(cell.config, cell.traffic["queries_per_call"])[part]
    return 100.0 * least * run.traced_calls / busy
