#!/usr/bin/env python3
"""Time variants of the query-major kernels (K1-K4) on one NVIDIA GPU.

Each variant is a JSON object of overrides: a key starting with ``k`` sets
a ``constexpr int`` constant of the kernel headers
(``fastforward_tpu_torch/ops/csrc/*.cuh``) in a private copy of the kernel
sources, from which the kernels are built; an upper-case key sets a
wrapper constant (``DENSE_ITEM_SLOTS`` of ``ops/stream_kernel.py``,
``ADC_ITEM_SLOTS`` of ``ops/stream_kernel_pq.py``).  Each variant times one
wrapper call (CUDA events: the median of 25 single calls, and 25 calls back
to back) on layouts like ``chip_smoke.py``'s, 512 queries x 1000 random
rows from seed 0 at dim 768:

- K1: fp32, bf16 and int8 tables of 2,000,384 rows (cap 256), exact and
  fast tiers, and K2's entry on the fp32 table viewed 3D (K2's body on
  K1's layout);
- K2: an int8 table of 262,144 rows (dense tiles, cap 1024), high and fast;
- K3: PQ(96, 256) codes of 2,000,384 rows (cap 256);
- K4: PQ(96, 256) codes of 262,144 rows (cap 1024).

Each result also holds the largest difference from the plain version and
the device bytes one call allocates (output and scratch).
``--root`` times the kernels of another checkout (for example the parent
commit unpacked beside this one) with the same layouts; only its wrapper
names are assumed.  Run from the repository root::

    python3 scripts/torch_kernel_variants.py --kernels K1,K2 '[{}, {"kRowsInFlight": 2}]'
    python3 scripts/torch_kernel_variants.py --root _parent --kernels K1 '[{}]'

Prints one JSON line per variant.  Needs ``nvcc`` and a CUDA device.
"""

import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

CALLS = 25
DIM, QUERIES, DEPTH = 768, 512, 1000
LARGE_N, DENSE_N = 2_000_384, 262_144
KERNELS = ("K1", "K2", "K3", "K4")


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


def cases(kernels, modules, rng) -> dict:
    """name -> (kernel call, plain call) on the card."""
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
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("variants", nargs="?", default="[{}]", help="JSON list of overrides")
    parser.add_argument("--kernels", default=",".join(KERNELS), help="comma-separated, of K1-K4")
    parser.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1],
                        help="checkout whose kernels are timed")
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
    calls = cases(kernels, modules, np.random.default_rng(0))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "root": str(root), "cases": list(calls)}), flush=True)
    defaults = {name: getattr(m, name) for m in (sk, skpq) for name in dir(m)
                if name.endswith("ITEM_SLOTS")}
    for consts in json.loads(args.variants):
        for name, value in defaults.items():  # each variant starts from the wrappers' own
            setattr(sk if hasattr(sk, name) else skpq, name, value)
        use_variant(root, modules, consts)
        result = {"variant": consts}
        for name, (fn, plain) in calls.items():
            result[name] = {
                "max_abs_err": (fn() - plain()).abs().max().item(),
                "ms": median_ms(fn),
                "back_to_back_ms": back_to_back_ms(fn),
                "peak_bytes_above_held": call_memory(fn),
            }
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
