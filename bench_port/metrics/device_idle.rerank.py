"""device_idle.rerank: the share of the traced window of re-rank calls in
which no kernel, copy or memset ran on the card, in percent."""

from bench_port import trace


def read(run):
    if run.profile is None or run.loop != "closed" or not run.profile.device:
        return None
    return trace.idle_share(run.profile)
