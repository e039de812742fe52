"""The benchmark of ``fastforward_tpu_torch``: ``python3 bench_port/run.py --workload <cell> ...``."""
