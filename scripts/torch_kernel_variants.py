#!/usr/bin/env python3
"""Time variants of the kernels K1-K4 on one NVIDIA GPU.

Each variant is a JSON object of overrides: a key starting with ``k`` sets
a ``constexpr int`` constant of the kernel headers
(``fastforward_tpu_torch/ops/csrc/*.cuh``) in a private copy of the kernel
sources, from which the kernels are built; an upper-case key sets a
wrapper constant (``DENSE_ITEM_SLOTS`` or ``DENSE_PACK_LIMIT`` of ``ops/stream_kernel.py``,
``ADC_ITEM_SLOTS`` of ``ops/stream_kernel_pq.py``).  Each variant times one
wrapper call (CUDA events: the median of 25 single calls, and 25 calls back
to back) on layouts like ``chip_smoke.py``'s, 512 queries x 1000 random
rows from seed 0 at dim 768:

- K1: fp32, bf16 and int8 tables of 2,000,384 rows (cap 256), exact and
  fast tiers, and K2's entry on the fp32 table viewed 3D (K2's body on
  K1's layout); and the fp32 table, both tiers, on a ``Mode.MAXP`` layout:
  512 queries x 1000 random documents of 1-7 consecutive rows, each pair
  padded to 8 rows by repeating its last row (cap 1024);
- K2: an int8 table of 262,144 rows (dense tiles, cap 1024), high and fast;
- K3: PQ(96, 256) codes of 2,000,384 rows (cap 256);
- K4: PQ(96, 256) codes of 262,144 rows (cap 1024), and a staged tail
  block of the hybrid tier at PQ(96, 256) (uint8) and PQ(96, 1024)
  (uint16): 512 queries of 35-105 random rows of 32,768, the rest of its
  64 x 1024 slots padding;
- K1 and K2 on the same tail-block layout: K1 on fp32 (both tiers), bf16
  and int8 rows, K2 on int8 and fp32 rows (3D, as the hybrid tier hands
  them over).

``--split`` adds one traced call of each case, its device time split by
kernel (``torch.profiler``), and the host time of one call with and
without its kernel entry (the entry's time is its launches').

``--dense-routes`` adds the sweep that calibrates the dense-dot body's
route choice (``stream_kernel.DENSE_PACK_LIMIT``): K2 on int8 rows, 512
queries of n random rows each (n in ``ROUTE_SLOTS``, about
``ROUTE_TILE_PAIRS`` pairs a 512-row tile, cap 1024), with every query on
work items, every query packed, and as the wrapper sets it (``auto``).
``--tile-split`` adds the sweep that calibrates K1's fp32 split
(``stream_kernel.tile_split``): fp32 rows at a tail block's density
(about ``SPLIT_TILE_SLOTS`` real slots a 512-row tile, 512 queries, cap
1024) over n tiles (n in ``SPLIT_TILES``), each tile split over S blocks
(S in ``SPLIT_BLOCKS``) and as the wrapper sets it.  In both sweeps every
route or split must give the same bits as the first.

``--routes`` adds the sweep that calibrates K3/K4's route choice
(``stream_kernel_pq.adc_slot_limit``): K4 at PQ(96, Ks), Ks in
``ROUTE_KS``, on 512 queries of n random rows each (n in ``ROUTE_SLOTS``,
about ``ROUTE_TILE_PAIRS`` pairs a 512-row tile, cap 1024), timed with the
slot limit at 0 (every query takes a table), at n + 1 (every real query
scored slot-wise; the padding query keeps its table) and as the wrapper
sets it (``auto``).  The three must give the same bits.

Each result also holds the largest difference from the plain version and
the device bytes one call allocates (output and scratch).
``--root`` times the kernels of another checkout (for example the parent
commit unpacked beside this one) with the same layouts; only its wrapper
names are assumed.  Run from the repository root::

    python3 scripts/torch_kernel_variants.py --kernels K1,K2 '[{}, {"kRowsInFlight": 2}]'
    python3 scripts/torch_kernel_variants.py --root _parent --kernels K1 '[{}]'
    python3 scripts/torch_kernel_variants.py --kernels K4 --routes '[{}, {"kSlotSlots": 1}]'
    python3 scripts/torch_kernel_variants.py --kernels K1,K2 --split '[{}]'

Prints one JSON line per variant.  Needs ``nvcc`` and a CUDA device.
"""

import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

CALLS = 25
DIM, QUERIES, DEPTH = 768, 512, 1000
LARGE_N, DENSE_N = 2_000_384, 262_144
KERNELS = ("K1", "K2", "K3", "K4")
#: the staged tail block: rows, and the least and most random rows a query
TAIL_ROWS, TAIL_SLOTS = 32_768, (35, 105)
#: the route sweep: codewords a subspace, slots a query, pairs a tile
ROUTE_KS = (256, 1024, 32_768)
ROUTE_SLOTS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
ROUTE_TILE_PAIRS = 900
#: the dense-dot route sweep's slots a query
DENSE_ROUTE_SLOTS = (16, 32, 48, 64, 96, 128, 192, 256, 512, 1024)
#: the fp32 split sweep: tiles, real slots a tile, blocks a tile
SPLIT_TILES = (16, 32, 64, 128, 256, 512, 1024)
SPLIT_TILE_SLOTS = 560
SPLIT_BLOCKS = (1, 2, 4, 8, 16)


def layout(scoring, rng, n: int, r: int = 512):
    """A streamed layout of ``QUERIES`` queries x ``DEPTH`` random rows of
    ``n``, packed over ``bucket(QUERIES)`` query slots as the index packs
    them."""
    rows = np.concatenate([rng.choice(n, DEPTH, replace=False) for _ in range(QUERIES)])
    qno = np.repeat(np.arange(QUERIES), DEPTH)
    cap = scoring._adaptive_cap(rows.size, n // r)
    cand, tidx, _ = scoring.build_streamed_layout(rows, qno, n, scoring.bucket(QUERIES), r=r, cap=cap)
    return (
        torch.from_numpy(cand.reshape(cand.shape[0], cap // 128, 128)).cuda(),
        torch.from_numpy(tidx).cuda(),
    )


def doc_layout(scoring, rng, n: int, r: int = 512, k: int = 8):
    """A ``Mode.MAXP`` streamed layout, as the index builds it
    (``index/util.py`` ``expand_pairs_grouped``): ``QUERIES`` queries x
    ``DEPTH`` random documents of 1-7 consecutive rows of ``n``, each pair
    ``k`` rows, the last row repeated past a document's end."""
    counts = rng.integers(1, 8, size=n)
    counts = counts[: int(np.searchsorted(np.cumsum(counts), n)) + 1]
    counts[-1] -= counts.sum() - n
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    docs = np.concatenate([rng.choice(counts.size, DEPTH, replace=False) for _ in range(QUERIES)])
    rows = starts[docs][:, None] + np.minimum(np.arange(k), counts[docs][:, None] - 1)
    qno = np.repeat(np.arange(QUERIES), DEPTH * k)
    cap = scoring._adaptive_cap(rows.size, n // r)
    cand, tidx, _ = scoring.build_streamed_layout(rows.ravel(), qno, n, scoring.bucket(QUERIES), r=r,
                                                  cap=cap)
    return (
        torch.from_numpy(cand.reshape(cand.shape[0], cap // 128, 128)).cuda(),
        torch.from_numpy(tidx).cuda(),
    )


def count_layout(scoring, rng, n: int, counts, r: int = 512, cap: int = 1024):
    """A streamed layout of ``counts[q]`` random rows of ``n`` for each
    query ``q`` (``len(counts)`` queries, the last one also the padding
    query)."""
    qno = np.repeat(np.arange(len(counts)), counts)
    rows = rng.integers(0, n, size=qno.size)
    cand, tidx, _ = scoring.build_streamed_layout(rows, qno, n, len(counts), r=r, cap=cap)
    return (
        torch.from_numpy(cand.reshape(cand.shape[0], cap // 128, 128)).cuda(),
        torch.from_numpy(tidx).cuda(),
    )


def with_slot_limit(skpq, limit, fn):
    """``fn()`` with K3/K4's slot limit set to ``limit`` (``None``: as the
    wrapper sets it)."""
    if limit is None:
        return fn()
    saved = skpq.adc_route_limit
    skpq.adc_route_limit = lambda *args, **kwargs: limit
    try:
        return fn()
    finally:
        skpq.adc_route_limit = saved


def median_ms(fn) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(CALLS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def back_to_back_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(CALLS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / CALLS


def call_memory(fn) -> int:
    """Device bytes one call of ``fn`` allocates at its peak (its output
    and scratch) above what was held before it."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - held


def host_ms(fn, stub_entries: bool = False) -> float:
    """Median host time of one call (its checks, allocations and launches;
    the card is drained between calls, so no launch waits on a queue); with
    ``stub_entries``, of the call with its kernel entry replaced by a no-op
    (the wrapper's Python side alone)."""
    from fastforward_tpu_torch.ops import _build

    bind = _build.bind
    if stub_entries:
        _build.bind = lambda *args, **kwargs: (lambda *call_args: None)
    try:
        return _host_ms(fn)
    finally:
        _build.bind = bind


def _host_ms(fn) -> float:
    times = []
    for _ in range(CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def traced_ms_by_kernel(fn) -> dict:
    """Device time (ms) of each kernel and copy one traced call of ``fn``
    launches, by name (a device item ahead of the call keeps the profiler
    from dropping the call's first item)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda")
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            name = re.sub(r"\(.*", "", ev.name)[:60]
            out[name] = out.get(name, 0.0) + ev.time_range.elapsed_us() / 1e3
    return out


def use_variant(root: Path, modules: dict, consts: dict) -> None:
    """Point the kernel build at a copy of ``root``'s ``csrc`` with the
    header constants of ``consts`` set, and set its wrapper constants."""
    from fastforward_tpu_torch.ops import _build

    build_dir = root / "fastforward_tpu_torch" / "_build"
    build_dir.mkdir(exist_ok=True)
    src = Path(tempfile.mkdtemp(prefix="variant_", dir=build_dir))
    for f in (root / "fastforward_tpu_torch" / "ops" / "csrc").iterdir():
        shutil.copy(f, src / f.name)
    for name, value in consts.items():
        if not name.startswith("k"):
            owner = next((m for m in modules.values() if hasattr(m, name)), None)
            if owner is None:
                raise ValueError(f"no wrapper constant {name}")
            setattr(owner, name, int(value))
            continue
        hits = 0
        for header in src.glob("*.cuh"):
            text, n = re.subn(rf"(constexpr int {name} = )[^;]+;", rf"\g<1>{int(value)};",
                              header.read_text())
            header.write_text(text)
            hits += n
        if hits != 1:
            raise ValueError(f"constant {name} is defined {hits} times in the kernel headers")
    _build.CSRC = src
    _build._libs.clear()
    _build.bind.cache_clear()


def cases(kernels, modules, rng, routes=False, sweeps=None) -> dict:
    """name -> (kernel call, plain call) on the card (``sweeps``: the
    names of the K1/K2 sweeps to add, ``dense_routes`` and
    ``tile_split``)."""
    sweeps = sweeps or {}
    sk, skpq, scoring = modules["sk"], modules["skpq"], modules["scoring"]
    gen = torch.Generator("cuda").manual_seed(0)
    q = torch.randn(QUERIES, DIM, device="cuda", generator=gen)
    out = {}
    if "K1" in kernels:
        cand3, tidx = layout(scoring, rng, LARGE_N)
        t32 = torch.randn(LARGE_N, DIM, device="cuda", generator=gen)
        t8 = torch.randint(-127, 128, (LARGE_N, DIM // 128, 128), dtype=torch.int8, device="cuda",
                           generator=gen)
        for name, table in (("fp32", t32), ("bf16", t32.to(torch.bfloat16)), ("int8", t8)):
            for exact in (True, False):
                out[f"K1 {name} {'exact' if exact else 'fast'}"] = (
                    lambda t=table, e=exact, c=cand3, ti=tidx: sk.stream_select_pairwise(t, q, c, ti, exact=e),
                    lambda t=table, e=exact, c=cand3, ti=tidx: sk.stream_select_pairwise_plain(t, q, c, ti, exact=e),
                )
        cand_d, tidx_d = doc_layout(scoring, rng, LARGE_N)
        for exact in (True, False):
            out[f"K1 fp32 {'exact' if exact else 'fast'}, MAXP layout"] = (
                lambda e=exact: sk.stream_select_pairwise(t32, q, cand_d, tidx_d, exact=e),
                lambda e=exact: sk.stream_select_pairwise_plain(t32, q, cand_d, tidx_d, exact=e),
            )
        # K2's entry takes a 3D fp32 table: its body on K1's fp32 layout
        t32_3d = t32.view(LARGE_N, DIM // 128, 128)
        out["K2 fp32 exact, K1's layout"] = (
            lambda c=cand3, ti=tidx: sk.stream_select(t32_3d, q.t(), c, ti),
            lambda c=cand3, ti=tidx: sk.stream_select_plain(t32_3d, q.t(), c, ti),
        )
    if "K2" in kernels:
        cand3, tidx = layout(scoring, rng, DENSE_N)
        t8 = torch.randint(-127, 128, (DENSE_N, DIM // 128, 128), dtype=torch.int8, device="cuda",
                           generator=gen)
        for tier in ("high", "fast"):
            out[f"K2 int8 {tier}"] = (
                lambda p=tier, c=cand3, ti=tidx: sk.stream_select(t8, q.t(), c, ti, precision=p),
                lambda p=tier, c=cand3, ti=tidx: sk.stream_select_plain(t8, q.t(), c, ti, precision=p),
            )
    cb = torch.randn(96, 256, 8, device="cuda", generator=gen)
    for kernel, n in (("K3", LARGE_N), ("K4", DENSE_N)):
        if kernel not in kernels:
            continue
        codes = torch.randint(0, 256, (n, 96), dtype=torch.uint8, device="cuda", generator=gen)
        cand3, tidx = layout(scoring, rng, n)
        if kernel == "K3":
            out["K3 pq exact"] = (
                lambda c=codes, cd=cand3, ti=tidx: skpq.stream_select_pq_pairwise(c, cb, q, cd, ti),
                lambda c=codes, cd=cand3, ti=tidx: skpq.stream_select_pq_pairwise_plain(c, cb, q, cd, ti),
            )
        else:
            out["K4 pq exact"] = (
                lambda c=codes, cd=cand3, ti=tidx: skpq.stream_select_pq(c, cb, q.t(), cd, ti),
                lambda c=codes, cd=cand3, ti=tidx: skpq.stream_select_pq_plain(c, cb, q.t(), cd, ti),
            )
    if "K1" in kernels or "K2" in kernels:
        cand3, tidx = count_layout(scoring, rng, TAIL_ROWS,
                                   rng.integers(TAIL_SLOTS[0], TAIL_SLOTS[1] + 1, size=QUERIES))
        tail32 = torch.randn(TAIL_ROWS, DIM, device="cuda", generator=gen)
        tail8 = torch.randint(-127, 128, (TAIL_ROWS, DIM // 128, 128), dtype=torch.int8,
                              device="cuda", generator=gen)
        if "K1" in kernels:
            for name, table, exact in (("fp32 exact", tail32, True), ("fp32 fast", tail32, False),
                                       ("bf16 exact", tail32.to(torch.bfloat16), True),
                                       ("int8 exact", tail8, True)):
                out[f"K1 tail block {name}"] = (
                    lambda t=table, e=exact, c=cand3, ti=tidx: sk.stream_select_pairwise(
                        t, q, c, ti, exact=e),
                    lambda t=table, e=exact, c=cand3, ti=tidx: sk.stream_select_pairwise_plain(
                        t, q, c, ti, exact=e),
                )
        if "K2" in kernels:
            for name, table in (("int8", tail8), ("fp32", tail32.view(TAIL_ROWS, DIM // 128, 128))):
                out[f"K2 tail block {name} high"] = (
                    lambda t=table, c=cand3, ti=tidx: sk.stream_select(t, q.t(), c, ti, precision="high"),
                    lambda t=table, c=cand3, ti=tidx: sk.stream_select_plain(
                        t, q.t(), c, ti, precision="high"),
                )
    if "K4" in kernels:
        cand3, tidx = count_layout(scoring, rng, TAIL_ROWS,
                                   rng.integers(TAIL_SLOTS[0], TAIL_SLOTS[1] + 1, size=QUERIES))
        for ks, dtype, label in ((256, np.uint8, "uint8"), (1024, np.uint16, "uint16")):
            codes = torch.from_numpy(rng.integers(0, ks, size=(TAIL_ROWS, 96)).astype(dtype)).cuda()
            cb_t = torch.randn(96, ks, 8, device="cuda", generator=gen)
            out[f"K4 tail block {label}"] = (
                lambda c=codes, b=cb_t, cd=cand3, ti=tidx: skpq.stream_select_pq(c, b, q.t(), cd, ti),
                lambda c=codes, b=cb_t, cd=cand3, ti=tidx: skpq.stream_select_pq_plain(
                    c, b, q.t(), cd, ti),
            )
    if sweeps.get("dense_routes"):
        sweep_rows = max(8, -(-QUERIES * max(DENSE_ROUTE_SLOTS) // ROUTE_TILE_PAIRS)) * 512
        sweep8 = torch.randint(-127, 128, (sweep_rows, DIM // 128, 128), dtype=torch.int8,
                               device="cuda", generator=gen)
        for n in DENSE_ROUTE_SLOTS:
            n_rows = max(8, -(-QUERIES * n // ROUTE_TILE_PAIRS)) * 512
            cand3, tidx = count_layout(scoring, rng, n_rows, np.full(QUERIES, n))
            plain = (lambda cd=cand3, ti=tidx: sk.stream_select_plain(
                sweep8, q.t(), cd, ti, precision="high"))
            for route in ("items", "packed", "auto"):
                out[f"dense routes n{n} {route}"] = (
                    lambda cd=cand3, ti=tidx, rt=route: sk.stream_select(
                        sweep8, q.t(), cd, ti, precision="high", _route=rt),
                    plain,
                )
    if sweeps.get("tile_split"):
        sweep32 = torch.randn(max(SPLIT_TILES) * 512, DIM, device="cuda", generator=gen)
        for n in SPLIT_TILES:
            per_query = SPLIT_TILE_SLOTS * n // QUERIES
            cand3, tidx = count_layout(scoring, rng, n * 512, np.full(QUERIES, per_query))
            plain = (lambda cd=cand3, ti=tidx: sk.stream_select_pairwise_plain(sweep32, q, cd, ti))
            for split in (*SPLIT_BLOCKS, None):
                out[f"tile split n{n} S{split or 'auto'}"] = (
                    lambda cd=cand3, ti=tidx, sp=split: sk.stream_select_pairwise(
                        sweep32, q, cd, ti, _split=sp),
                    plain,
                )
    if routes:
        for ks in ROUTE_KS:
            dtype = np.uint8 if ks <= 256 else np.uint16
            cb_r = torch.randn(96, ks, 8, device="cuda", generator=gen)
            for n in ROUTE_SLOTS:
                n_rows = max(8, -(-QUERIES * n // ROUTE_TILE_PAIRS)) * 512
                codes = torch.from_numpy(rng.integers(0, ks, size=(n_rows, 96)).astype(dtype)).cuda()
                cand3, tidx = count_layout(scoring, rng, n_rows, np.full(QUERIES, n))
                plain = (lambda c=codes, b=cb_r, cd=cand3, ti=tidx:
                         skpq.stream_select_pq_plain(c, b, q.t(), cd, ti))
                for name, limit in (("table", 0), ("slots", n + 1), ("auto", None)):
                    out[f"routes ks{ks} n{n} {name}"] = (
                        lambda c=codes, b=cb_r, cd=cand3, ti=tidx, lim=limit: with_slot_limit(
                            skpq, lim, lambda: skpq.stream_select_pq(c, b, q.t(), cd, ti)),
                        plain,
                    )
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("variants", nargs="?", default="[{}]", help="JSON list of overrides")
    parser.add_argument("--kernels", default=",".join(KERNELS), help="comma-separated, of K1-K4")
    parser.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1],
                        help="checkout whose kernels are timed")
    parser.add_argument("--routes", action="store_true",
                        help="add the sweep of K3/K4's two routes over Ks and slots a query")
    parser.add_argument("--split", action="store_true",
                        help="add one traced call of each case, split by kernel")
    parser.add_argument("--verbose", action="store_true",
                        help="name each case on stderr before it runs")
    parser.add_argument("--dense-routes", action="store_true",
                        help="add the sweep of the dense-dot body's two routes over slots a query")
    parser.add_argument("--tile-split", action="store_true",
                        help="add the sweep of K1's fp32 split over tiles and blocks a tile")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device is available", file=sys.stderr)
        return 2
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    from fastforward_tpu_torch.ops import scoring
    from fastforward_tpu_torch.ops import stream_kernel as sk
    from fastforward_tpu_torch.ops import stream_kernel_pq as skpq

    modules = {"sk": sk, "skpq": skpq, "scoring": scoring}
    kernels = [k for k in args.kernels.split(",") if k]
    if set(kernels) - set(KERNELS):
        parser.error(f"unknown kernels {set(kernels) - set(KERNELS)}")
    calls = cases(kernels, modules, np.random.default_rng(0), args.routes,
                  {"dense_routes": args.dense_routes, "tile_split": args.tile_split})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "root": str(root), "cases": list(calls)}), flush=True)
    defaults = {name: getattr(m, name) for m in (sk, skpq) for name in dir(m)
                if name.endswith(("ITEM_SLOTS", "PACK_LIMIT"))}
    for consts in json.loads(args.variants):
        for name, value in defaults.items():  # each variant starts from the wrappers' own
            setattr(sk if hasattr(sk, name) else skpq, name, value)
        use_variant(root, modules, consts)
        result = {"variant": consts}
        for name, (fn, plain) in calls.items():
            if args.verbose:
                print(f"{json.dumps(consts)} {name}", file=sys.stderr, flush=True)
            got = fn()
            for prefix, first in (("routes ", " table"), ("dense routes ", " items"),
                                  ("tile split ", " S1")):
                if name.startswith(prefix) and not name.endswith(first):
                    want = calls[name.rsplit(" ", 1)[0] + first][0]()
                    if not torch.equal(got, want):
                        raise RuntimeError(f"{name}: not the{first} bits")
            result[name] = {
                "max_abs_err": (got - plain()).abs().max().item(),
                "ms": median_ms(fn),
                "back_to_back_ms": back_to_back_ms(fn),
                "peak_bytes_above_held": call_memory(fn),
            }
            if args.split:
                result[name]["traced_ms_by_kernel"] = traced_ms_by_kernel(fn)
                result[name]["host_ms"] = host_ms(fn)
                result[name]["host_ms_without_entry"] = host_ms(fn, stub_entries=True)
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
