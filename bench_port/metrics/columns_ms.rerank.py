"""columns_ms.rerank: the mean per traced call of the ``ff.columns`` ranges (a
new plan's result columns, query ranks, sort keys and segments,
``index/base.py`` ``_finish_score_and_sort``)."""

from bench_port import trace


def read(run):
    if run.profile is None or not run.traced_calls:
        return None
    if not any(n == "ff.columns" for n, _, _ in run.profile.host):
        return None
    return trace.span_s(run.profile, "ff.columns") / run.traced_calls * 1e3
