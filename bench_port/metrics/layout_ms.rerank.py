"""layout_ms.rerank: the mean per traced call of the ``ff.layout`` ranges
(the streamed layout's build on the host, ``ops/scoring.py``)."""

from bench_port import trace


def read(run):
    if run.profile is None or not run.traced_calls:
        return None
    if not any(n == "ff.layout" for n, _, _ in run.profile.host):
        return None
    return trace.span_s(run.profile, "ff.layout") / run.traced_calls * 1e3
