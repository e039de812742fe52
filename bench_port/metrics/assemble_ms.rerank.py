"""assemble_ms.rerank: the mean per traced call of the ``ff.assemble`` ranges
(the result frame, the plan's update and the ranking, ``index/base.py``)."""

from bench_port import trace


def read(run):
    if run.profile is None or not run.traced_calls:
        return None
    if not any(n == "ff.assemble" for n, _, _ in run.profile.host):
        return None
    return trace.span_s(run.profile, "ff.assemble") / run.traced_calls * 1e3
