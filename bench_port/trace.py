"""Reading a traced window: device busy time, idle gaps and the program's
``ff.*`` ranges.

A trace is reduced to plain intervals (microseconds on the profiler's
clock) so that the arithmetic below can be checked on synthetic traces:
``host`` holds the ``ff.*`` ranges the program records and the harness's
own window range, ``device`` every kernel, copy and memset the card ran,
and ``annotations`` the device-side twins of the ``ff.*`` ranges, each of
which spans the device work launched inside its range.
"""

from dataclasses import dataclass, field

#: the harness's range around a traced window
WINDOW = "bench.window"


@dataclass
class Profile:
    host: list = field(default_factory=list)  # (name, start_us, end_us)
    device: list = field(default_factory=list)  # (name, start_us, end_us)
    annotations: list = field(default_factory=list)  # (name, start_us, end_us)

    @property
    def window(self) -> tuple[float, float]:
        """The traced window: the harness's range, else the trace's extent."""
        marks = [(s, e) for n, s, e in self.host if n == WINDOW]
        if marks:
            return min(s for s, _ in marks), max(e for _, e in marks)
        spans = self.host + self.device
        return min(s for _, s, _ in spans), max(e for _, _, e in spans)

    @property
    def window_s(self) -> float:
        lo, hi = self.window
        return (hi - lo) / 1e6


def from_torch(prof) -> Profile:
    """The intervals of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    out = Profile()
    for ev in prof.events():
        item = (ev.name, float(ev.time_range.start), float(ev.time_range.end))
        named = ev.name.startswith("ff.") or ev.name == WINDOW
        if ev.device_type != DeviceType.CUDA:
            if named:
                out.host.append(item)
        elif named or getattr(ev, "is_user_annotation", False):
            # a range's device-side twin spans the work launched inside it;
            # it is no work of its own (the window's twin spans nearly all)
            if ev.name.startswith("ff."):
                out.annotations.append(item)
        else:
            out.device.append(item)
    return out


def merged(intervals) -> list:
    """Union of ``(start, end)`` intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _clip(intervals, lo, hi) -> list:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def busy_intervals(profile: Profile) -> list:
    """Where any kernel, copy or memset ran, inside the window."""
    lo, hi = profile.window
    return merged(_clip([(s, e) for _, s, e in profile.device], lo, hi))


def busy_s(profile: Profile) -> float:
    """Seconds of the window in which the card ran something."""
    return sum(e - s for s, e in busy_intervals(profile)) / 1e6


def idle_share(profile: Profile) -> float:
    """Share of the window in which the card ran nothing, in percent."""
    return 100.0 * (1.0 - busy_s(profile) / profile.window_s)


def span_s(profile: Profile, name: str) -> float:
    """Total seconds of the program's host ranges called ``name``."""
    return sum(e - s for n, s, e in profile.host if n == name) / 1e6


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset", "cudaMemcpy", "cudaMemset"))


def kernels_inside_s(profile: Profile, name: str) -> float:
    """Seconds in which kernels launched inside ``name`` ranges ran: the
    union of the kernels that lie within the range's device-side twins."""
    twins = merged((s, e) for n, s, e in profile.annotations if n == name)
    inside = []
    for kname, s, e in profile.device:
        if is_kernel(kname) and any(ts <= s and e <= te for ts, te in twins):
            inside.append((s, e))
    return sum(e - s for s, e in merged(inside)) / 1e6


def breakdown(profile: Profile, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps by the innermost ``ff.*`` range the host was in (``host`` where it
    was in none), each in seconds."""
    ops: dict = {}
    for name, s, e in profile.device:
        key = name[:160]
        ops[key] = ops.get(key, 0.0) + (e - s) / 1e6
    lo, hi = profile.window
    gaps, at = [], lo
    for s, e in busy_intervals(profile):
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    ranges = sorted(((e - s, n, s, e) for n, s, e in profile.host if n != WINDOW))
    idle: dict = {}
    for s, e in gaps:
        mid = 0.5 * (s + e)
        label = next((n for _, n, rs, re in ranges if rs <= mid <= re), "host")
        idle[label] = idle.get(label, 0.0) + (e - s) / 1e6
    return {
        "device_ops": [[n, v] for n, v in sorted(ops.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[n, v] for n, v in sorted(idle.items(), key=lambda kv: -kv[1])[:top]],
    }
