"""attn_roofline.rerank: the traced calls' attention blocks at the bf16 peak
(the encoder plug-in's ``least_parts_s``: the q/k/v/o projections and the
attention's logits and context on each query's real tokens) over the
device time of the kernels launched inside ``ff.attn`` ranges
(``models/mistral.py``), in percent."""

from bench_port import tower_parts


def read(run):
    return tower_parts.roofline(run, "attn", "ff.attn")
