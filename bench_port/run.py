"""Runs one cell of the benchmark of ``fastforward_tpu_torch`` once.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell is an entry of ``workloads`` in
``BENCHMARK.json``; its configuration, traffic mix, loop, encoder, index
builder, limits and metric readers are files under ``bench_port/`` found
by name (``spec.py``).  Standard error names the card and the host first.
The last line of standard output is the run's result as one JSON object,
the last lines of standard error the numbers compared beside their limits.
Without a CUDA card, or with fewer than the cell asks for, the run prints
no result and exits with 2; if a module named ``jax``, ``jaxlib``,
``flax`` or ``fastforward_tpu`` was loaded, it exits with 3.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

#: top-level module names no run may load (compared whole: the port's
#: own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "fastforward_tpu")


def environment(root: Path) -> None:
    """Build caches inside the checkout at fixed paths; transformers offline
    and without JAX or TensorFlow."""
    build = root / "fastforward_tpu_torch" / "_build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    for key, value in (("USE_FLAX", "0"), ("USE_JAX", "0"), ("USE_TF", "0"), ("USE_TORCH", "1"),
                       ("HF_HUB_OFFLINE", "1"), ("TRANSFORMERS_OFFLINE", "1"),
                       ("TOKENIZERS_PARALLELISM", "false")):
        os.environ[key] = value


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among the loaded modules."""
    names = {m.split(".")[0] for m in list(sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def _smi(query: str) -> str:
    import subprocess

    try:
        done = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=20, check=False)
        return done.stdout.strip() or done.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi: {err}"


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    return _smi("name,power.limit")


def _read(path: str) -> str:
    try:
        return Path(path).read_text()
    except OSError:
        return ""


def host_line() -> str:
    """The host the run shares: its name, CPU model and clock, the cores it
    has and those this process may use, its load, its free memory, and the
    NUMA node of the card (first card) against the process's CPUs."""
    info = _read("/proc/cpuinfo")
    model = next((ln.split(":", 1)[1].strip() for ln in info.splitlines() if ln.startswith("model name")), "?")
    mhz = [float(ln.split(":", 1)[1]) for ln in info.splitlines() if ln.startswith("cpu MHz")]
    free = next((ln.split()[1] for ln in _read("/proc/meminfo").splitlines()
                 if ln.startswith("MemAvailable")), "?")
    bus = (_smi("pci.bus_id").splitlines() or [""])[0].strip().lower()
    node = _read(f"/sys/bus/pci/devices/{bus[-12:]}/numa_node").strip() if bus else ""
    cpus = sorted(os.sched_getaffinity(0))
    return (f"{os.uname().nodename}; {model}; cpu MHz mean {sum(mhz) / max(1, len(mhz)):.0f}; "
            f"{os.cpu_count()} cores, {len(cpus)} usable ({cpus[0]}-{cpus[-1]}); "
            f"load {' '.join(f'{v:.2f}' for v in os.getloadavg())}; MemAvailable {free} kB; "
            f"card NUMA node {node or '?'}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    environment(ROOT)
    sys.path.insert(0, str(ROOT))
    from bench_port import spec

    cell = spec.find_cell(ROOT, args.workload)
    import torch

    print(f"[setup] torch imported {time.perf_counter() - T_PROCESS:.2f} s since the process started",
          file=sys.stderr)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        import fastforward_tpu_torch  # noqa: F401
    except ImportError as err:
        print(f"the program is not in this checkout: {err}", file=sys.stderr)
        return 2
    from bench_port import harness, roofline

    harness.log(f"[card] {card_line()}; peaks {json.dumps(roofline.PEAKS)}; "
                f"{time.perf_counter() - T_PROCESS:.2f} s since the process started")
    harness.log(f"[host] {host_line()}")
    line = harness.result_line(cell, args.seed, args.seconds, bool(args.trace), T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
