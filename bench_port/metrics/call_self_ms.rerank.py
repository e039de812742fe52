"""call_self_ms.rerank: the mean per traced call of ``ff.call``'s self time
(``index/base.py`` ``Index.__call__``): each call's range less the union
of the other ``ff.*`` host ranges inside it, the part of a call no finer
range names."""

from bench_port import trace


def self_s(profile) -> float:
    """Seconds of the ``ff.call`` ranges that no other ``ff.*`` range covers."""
    calls = [(s, e) for n, s, e in profile.host if n == "ff.call"]
    inner = [(s, e) for n, s, e in profile.host if n.startswith("ff.") and n != "ff.call"]
    total = 0.0
    for lo, hi in calls:
        covered = trace.merged((max(s, lo), min(e, hi)) for s, e in inner if e > lo and s < hi)
        total += (hi - lo) - sum(e - s for s, e in covered)
    return total / 1e6


def read(run):
    if run.profile is None or not run.traced_calls:
        return None
    if not any(n == "ff.call" for n, _, _ in run.profile.host):
        return None
    return self_s(run.profile) / run.traced_calls * 1e3
