#!/usr/bin/env python3
"""Time variants of the query-major ADC kernels (K3, K4) on one NVIDIA GPU.

Each variant overrides ``constexpr int`` constants of
``fastforward_tpu_torch/ops/csrc/adc_lut.cuh`` in a private copy of the
kernel sources, builds K3 and K4 from it, and times one wrapper call
(CUDA events: the median of 25 single calls, and 25 calls back to back) on
layouts like ``chip_smoke.py``'s: PQ(96, 256) codes of 2,000,384 rows with
512 queries x 1000 random rows (K3, cap 256) and of 262,144 rows (K4, dense
tiles, cap 1024), random codebooks and queries from seed 0.  Each result
also holds the largest difference from the plain version.  Run from the
repository root::

    python3 scripts/torch_adc_variants.py '[{}, {"kTableQueries": 8}]'

Prints one JSON line per variant.  Needs ``nvcc`` and a CUDA device.
"""

import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from fastforward_tpu_torch.ops import _build, scoring  # noqa: E402
from fastforward_tpu_torch.ops import stream_kernel_pq as skpq  # noqa: E402

CALLS = 25


def layout(rng, n: int, queries: int, depth: int, r: int = 512):
    rows = np.concatenate([rng.choice(n, depth, replace=False) for _ in range(queries)])
    qno = np.repeat(np.arange(queries), depth)
    cap = scoring._adaptive_cap(rows.size, n // r)
    cand, tidx, _ = scoring.build_streamed_layout(rows, qno, n, scoring.bucket(queries), r=r, cap=cap)
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


def use_variant(consts: dict) -> None:
    """Point the kernel build at a copy of ``csrc`` with ``consts`` set."""
    build_dir = ROOT / "fastforward_tpu_torch" / "_build"
    build_dir.mkdir(exist_ok=True)
    src = Path(tempfile.mkdtemp(prefix="adc_variant_", dir=build_dir))
    for f in (ROOT / "fastforward_tpu_torch" / "ops" / "csrc").iterdir():
        shutil.copy(f, src / f.name)
    header = (src / "adc_lut.cuh").read_text()
    for name, value in consts.items():
        header, n = re.subn(rf"(constexpr int {name} = )[^;]+;", rf"\g<1>{int(value)};", header)
        if n != 1:
            raise ValueError(f"no constant {name} in adc_lut.cuh")
    (src / "adc_lut.cuh").write_text(header)
    _build.CSRC = src
    _build._libs.clear()
    _build.bind.cache_clear()


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_adc_variants: no CUDA device is available", file=sys.stderr)
        return 2
    variants = json.loads(sys.argv[1]) if len(sys.argv) > 1 else [{}]
    rng = np.random.default_rng(0)
    cb = torch.from_numpy(rng.standard_normal((96, 256, 8), dtype=np.float32)).cuda()
    q = torch.from_numpy(rng.standard_normal((512, 768), dtype=np.float32)).cuda()
    cases = {}
    for kernel, n in (("K3", 2_000_384), ("K4", 262_144)):
        codes = torch.from_numpy(rng.integers(0, 256, size=(n, 96), dtype=np.uint8)).cuda()
        cases[kernel] = (codes, *layout(rng, n, 512, 1000))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "layouts": {k: list(v[1].shape) for k, v in cases.items()}}),
          flush=True)
    for consts in variants:
        use_variant(consts)
        result = {"variant": consts}
        for kernel, (codes, cand3, tidx) in cases.items():
            if kernel == "K3":
                fn = lambda: skpq.stream_select_pq_pairwise(codes, cb, q, cand3, tidx)  # noqa: E731
                plain = skpq.stream_select_pq_pairwise_plain(codes, cb, q, cand3, tidx)
            else:
                fn = lambda: skpq.stream_select_pq(codes, cb, q.t(), cand3, tidx)  # noqa: E731
                plain = skpq.stream_select_pq_plain(codes, cb, q.t(), cand3, tidx)
            result[kernel] = {
                "max_abs_err": (fn() - plain).abs().max().item(),
                "ms": median_ms(fn),
                "back_to_back_ms": back_to_back_ms(fn),
            }
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
