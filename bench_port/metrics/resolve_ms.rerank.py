"""resolve_ms.rerank: the mean per traced call of the ``ff.resolve`` ranges
(string ids to table rows, ``index/base.py`` ``_candidate_arrays`` and the
flat path's resolution)."""

from bench_port import trace


def read(run):
    if run.profile is None or not run.traced_calls:
        return None
    if not any(n == "ff.resolve" for n, _, _ in run.profile.host):
        return None
    return trace.span_s(run.profile, "ff.resolve") / run.traced_calls * 1e3
