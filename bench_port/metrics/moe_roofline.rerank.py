"""moe_roofline.rerank: the traced calls' expert blocks at their least time
(the encoder plug-in's ``least_parts_s``: for each micro-batch and expert
layer, the router, the chosen and the shared experts on each query's real
tokens at the bf16 peak, or every expert's weights read once at the
memory's rate, whichever is slower) over the device time of the kernels
launched inside ``ff.moe`` ranges (``models/deepseek.py``), in percent."""

from bench_port import tower_parts


def read(run):
    return tower_parts.roofline(run, "moe", "ff.moe")
