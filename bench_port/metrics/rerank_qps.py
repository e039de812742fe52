"""rerank_qps: queries of the ``Index.__call__`` calls completed in the
window over the window's seconds (closed loop)."""


def read(run):
    if run.loop != "closed" or run.window_s <= 0:
        return None
    return run.queries_done / run.window_s
