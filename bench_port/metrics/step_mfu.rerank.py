"""step_mfu.rerank: a call's least time at the chip's peaks (the tower's
matmul operations at the fp32 peak plus the scoring's least time) over the
mean wall time of the run's calls outside the traced window, in percent."""


def read(run):
    if run.loop != "closed" or not run.call_s or not run.call_bound_s:
        return None
    return 100.0 * run.call_bound_s / (sum(run.call_s) / len(run.call_s))
