"""mlp_roofline.rerank: the traced calls' MLP blocks at the bf16 peak (the
encoder plug-in's ``least_parts_s``: the gate, up and down projections on
each query's real tokens) over the device time of the kernels launched
inside ``ff.mlp`` ranges (``models/mistral.py``), in percent."""

from bench_port import tower_parts


def read(run):
    return tower_parts.roofline(run, "mlp", "ff.mlp")
