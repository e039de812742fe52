"""The control and the program's readings over many seeds, in one process.

    python3 bench_port/control.py --workload <cell> --seeds 1,2,3 --seconds <s>

For each seed: one run of the cell (set-up, a window of ``--seconds``, the
check), then the control: the plain reference in TF32 (the precision just
below the configuration's fp32) put in the program's place, its answers to
the same sampled queries compared with the float64 reference by the same
numbers.  One JSON line a seed: the program's numbers and the control's.
A cell's limits are set between the two (PERF.md).  The benchmark's own
runs do not run the control.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def control_values(cell, seed: int, out: dict, device) -> dict:
    """The numbers of the control's answers to the run's sampled queries."""
    from bench_port import check

    ctrl = check.reference_data(cell.config, seed, out["answers"], out["encoder"], out["ref_inputs"],
                                "tf32", device)
    answers = check.control_answers(out["answers"], ctrl)
    return check.readings(cell.config, seed, answers, out["ref"], device)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, default=3.0)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from bench_port import harness, run, spec

    run.environment(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.find_cell(ROOT, args.workload)
    harness.log(f"[card] {run.card_line()}")
    harness.log(f"[host] {run.host_line()}")
    start = T_PROCESS
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.run_cell(cell, seed, args.seconds, False, start, "cuda")
        line = harness.line_of(cell, out, False)
        ctrl = control_values(cell, seed, out, torch.device("cuda"))
        print(json.dumps({"seed": seed, "correct": line["correct"], "program": out["values"],
                          "control": ctrl, "metrics": line["metrics"]}), flush=True)
        del out
        start = time.perf_counter()
    bad = run.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
