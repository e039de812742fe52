"""tokenize_ms.rerank: the mean per traced call of the ``ff.tokenize`` ranges
(each micro-batch's tokenization on the host, ``encoder/transformer.py``)."""

from bench_port import trace


def read(run):
    if run.profile is None or not run.traced_calls:
        return None
    if not any(n == "ff.tokenize" for n, _, _ in run.profile.host):
        return None
    return trace.span_s(run.profile, "ff.tokenize") / run.traced_calls * 1e3
