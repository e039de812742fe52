"""fetch_sort_ms.rerank: the mean per traced call of the ``ff.fetch_sort``
ranges (the score copy overlapped with the per-query sort,
``index/base.py`` ``_overlap_fetch_sort``)."""

from bench_port import trace


def read(run):
    if run.profile is None or not run.traced_calls:
        return None
    if not any(n == "ff.fetch_sort" for n, _, _ in run.profile.host):
        return None
    return trace.span_s(run.profile, "ff.fetch_sort") / run.traced_calls * 1e3
