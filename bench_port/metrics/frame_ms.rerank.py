"""frame_ms.rerank: the mean per traced call of the ``ff.frame`` ranges (the
frame's copy, the query factorize and the query list, ``index/base.py``
``_numbered_frame``)."""

from bench_port import trace


def read(run):
    if run.profile is None or not run.traced_calls:
        return None
    if not any(n == "ff.frame" for n, _, _ in run.profile.host):
        return None
    return trace.span_s(run.profile, "ff.frame") / run.traced_calls * 1e3
