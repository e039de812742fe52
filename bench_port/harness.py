"""One run of one cell: set-up, the measured window, the traced window and
the check against the plain reference.

The program is driven only by the cell's plug-ins (``spec.py``): its
encoder (``encoders/``), its index (``indexes/``) and its loop
(``loops/``), each through the program's public API.  The program receives
the generated inputs only.
"""

import gc
import os
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np
import torch

from bench_port import check, data, spec
from bench_port import trace as tr

#: traced windows taken again when the trace holds no device work
TRACE_TRIES = 3


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


@dataclass
class Run:
    """What a run measured, for the metric readers."""

    cell: spec.Cell
    loop: str
    seed: int
    setup_s: float = 0.0
    window_s: float = 0.0
    queries_done: int = 0
    call_s: list = field(default_factory=list)  # each call's wall time
    attempted: int = 0
    failed: int = 0
    profile: "tr.Profile | None" = None
    traced_calls: int = 0
    traced_scoring_bound_s: float = 0.0  # least time of the traced calls' scoring
    call_bound_s: float = 0.0  # least time of one call: encoder and scoring


# -- pieces the loops share ------------------------------------------------------


def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def profiled(fn):
    """Runs ``fn`` under the profiler, inside the harness's window range;
    taken again when the trace holds no kernel."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    for tries in range(1, TRACE_TRIES + 1):
        sync()
        with profile(activities=activities) as prof:
            with record_function(tr.WINDOW):
                fn()
                sync()
        got = tr.from_torch(prof)
        if not torch.cuda.is_available() or any(tr.is_kernel(n) for n, _, _ in got.device):
            return got
        log(f"trace try {tries}: no kernel in the profile; tracing again")
    raise RuntimeError(f"no kernel in any of {TRACE_TRIES} traced windows")


@contextmanager
def gc_pauses(what: str):
    """Logs the interpreter's collections inside the block: their count,
    the full ones, and the longest pause."""
    pauses = []

    def timer(phase, info, _start=[0.0]):
        if phase == "start":
            _start[0] = time.perf_counter()
        else:
            pauses.append((info["generation"], time.perf_counter() - _start[0]))

    gc.callbacks.append(timer)
    try:
        yield
    finally:
        gc.callbacks.remove(timer)
        full = [p for g, p in pauses if g == 2]
        log(f"[gc] {what}: {len(pauses)} collections, {sum(p for _, p in pauses):.4f} s; "
            f"{len(full)} full, longest {max(full, default=0.0):.4f} s")


def log_calls(call_s: list) -> None:
    """The window's calls (the first three, and the spread of all of them)
    and the host's load after it."""
    if not call_s:
        return
    ms = np.asarray(call_s) * 1e3
    q = np.percentile(ms, [0, 25, 50, 75, 100])
    log(f"[window] {ms.size} calls; first {', '.join(f'{v:.1f}' for v in ms[:3])} ms; "
        f"min/q1/median/q3/max {'/'.join(f'{v:.1f}' for v in q)} ms; "
        f"host load {' '.join(f'{v:.2f}' for v in os.getloadavg())}")


def host_speed() -> str:
    """The host's speed at the kinds of work a call does on it, each the
    best of three single-threaded tries: a sort of 4M floats, a factorize
    of 512k ID strings, and an interpreter loop.  Where the sandbox hides
    the CPU's model and load, this tells two hosts apart."""
    import pandas as pd

    rng = np.random.default_rng(0)
    floats = rng.standard_normal(1 << 22)
    ids = pd.array(np.char.add(b"d", rng.integers(0, 3_213_835, 1 << 19).astype("S")).astype(str),
                   dtype="string[pyarrow]")

    def best(fn) -> float:
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return min(times) * 1e3

    return (f"sort {best(lambda: np.sort(floats)):.1f} ms, factorize {best(lambda: pd.factorize(ids)):.1f} ms, "
            f"loop {best(lambda: sum(range(3_000_000))):.1f} ms")


# -- one run ---------------------------------------------------------------------


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, t_process: float,
             device: "str | torch.device" = "cuda") -> dict:
    """Runs ``cell`` once and returns the result line's fields (the harness
    prints them); ``t_process`` is when the process started."""
    config, traffic = cell.config, cell.traffic
    device = torch.device(device)
    loop = spec.plugin(cell.root, "loops", traffic["loop"])
    encoder_mod = spec.plugin(cell.root, "encoders", spec.encoder_name(cell))
    run = Run(cell=cell, loop=traffic["loop"], seed=seed)

    pools = loop.pools(cell, seed)
    texts = [t for p in pools for t in p.texts]
    log(f"[setup] queries drawn {time.perf_counter() - t_process:.2f} s since the process started")
    mark = time.perf_counter()
    encoder, ref_inputs = encoder_mod.make(config, seed, texts, device)
    log(f"[setup] encoder {time.perf_counter() - mark:.2f} s")
    mark = time.perf_counter()
    index, n_rows = spec.plugin(cell.root, "indexes", config["index"]).build(
        config, seed, encoder, device, log=log)
    log(f"[setup] index of {n_rows} rows {time.perf_counter() - mark:.2f} s")

    rng = data.sample_rng(seed)
    kept = loop.measure(run, index, pools, seconds, traced, t_process, rng, encoder_mod)

    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    # the program's state goes before the reference runs
    del index, encoder
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    log(f"[host] speed after the window: {host_speed()}")

    answers = loop.answers(kept, pools, traffic, rng)
    ref = check.reference_data(config, seed, answers, encoder_mod, ref_inputs, "float64", device)
    values = check.readings(config, seed, answers, ref, device)
    return {"run": run, "values": values, "memory_peak": int(memory_peak), "answers": answers,
            "encoder": encoder_mod, "ref_inputs": ref_inputs, "ref": ref}


def result_line(cell: spec.Cell, seed: int, seconds: float, traced: bool, t_process: float,
                device: str = "cuda") -> dict:
    """Runs the cell and returns its result line: ``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device`` (and with a trace ``breakdown``),
    then ``checks``, each number compared beside its limit.  Writes the
    numbers compared, each beside its limit, as the last lines on
    standard error."""
    return line_of(cell, run_cell(cell, seed, seconds, traced, t_process, device), traced, device)


def line_of(cell: spec.Cell, out: dict, traced: bool, device: str = "cuda") -> dict:
    """The result line of a finished :func:`run_cell`."""
    run = out["run"]
    wanted = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = spec.reader(cell.root, m["name"])(run)
        if value is None:
            if not traced:
                raise RuntimeError(f"end-to-end metric {m['name']} has no value in {cell.name}")
            log(f"[metric] {m['name']}: nothing to read in this run")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = torch.device(device)
    info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": int(cell.entry["chips"]),
        "memory_peak_bytes": out["memory_peak"],
    }
    line = {"correct": False, "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "device": info}
    if traced and run.profile is not None:
        info["busy_s"] = tr.busy_s(run.profile)
        info["window_s"] = run.profile.window_s
        line["breakdown"] = tr.breakdown(run.profile)
    ok, shown = check.judge(out["values"], cell.limits)
    line["correct"] = bool(ok and run.failed == 0 and run.attempted > 0)
    line["checks"] = shown
    for name, item in shown.items():
        log(f"check {name} {item['value']!r} limit {item['limit']!r}")
    return line
