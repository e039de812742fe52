"""score_roofline.rerank: the traced calls' scoring work at the chip's
peaks (``roofline.scoring_work`` from the cell's rankings) over the device
time of the kernels launched inside ``ff.score`` ranges, in percent."""

from bench_port import trace


def read(run):
    if run.profile is None or not run.traced_scoring_bound_s:
        return None
    busy = trace.kernels_inside_s(run.profile, "ff.score")
    if busy <= 0:
        return None
    return 100.0 * run.traced_scoring_bound_s / busy
