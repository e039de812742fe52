"""encode_ms.rerank: the mean per traced call of the ``ff.encode`` ranges
(the query encoder, ``index/base.py`` ``encode_queries``)."""

from bench_port import trace


def read(run):
    if run.profile is None or not run.traced_calls:
        return None
    if not any(n == "ff.encode" for n, _, _ in run.profile.host):
        return None
    return trace.span_s(run.profile, "ff.encode") / run.traced_calls * 1e3
