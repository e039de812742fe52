"""encoder_roofline.rerank: the traced calls' encoding at the chip's peak
(the cell's encoder plug-in's ``least_s``, the tower's matmul operations)
over the device time of the kernels launched inside ``ff.tower`` ranges
(``encoder/transformer.py``; copies left out), in percent."""

from bench_port import spec, trace


def read(run):
    if run.profile is None or not run.traced_calls:
        return None
    busy = trace.kernels_inside_s(run.profile, "ff.tower")
    if busy <= 0:
        return None
    cell = run.cell
    encoder = spec.plugin(cell.root, "encoders", spec.encoder_name(cell))
    least = encoder.least_s(cell.config, cell.traffic["queries_per_call"]) * run.traced_calls
    if least <= 0:
        return None
    return 100.0 * least / busy
