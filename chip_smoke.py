#!/usr/bin/env python3
"""GPU smoke run of fastforward_tpu_torch: kernels, re-rank and fused serve.

Run from the repository root on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. header: the card's name and power limit; K1 built with ``nvcc`` from
   ``fastforward_tpu_torch/ops/csrc``;
2. K1 (``stream_select_pairwise``) against its plain PyTorch version at a
   small shape, for fp32, bf16 and int8 tables, exact and fast tiers;
3. re-rank at the flagship shape (N = 2,000,000 passages, dim 768, fp32,
   Q = 512 queries x depth 1000, ``Mode.PASSAGE``, precision ``"high"``):
   one cold and several warm ``index(ranking)`` calls, 32 queries checked
   against float64 dots;
4. fused serve at the same shape: ``serve(ranking, 0.2, 10, refine=22)``
   and ``serve(ranking, 0.2, 10)``, top-10 ids and scores checked against
   the exact interpolated top-10 of 32 queries;
5. a sparse ranking (the gather-dot branch) and a bf16 table at
   N = 262,144, checked the same way;
6. K1 against its plain version on the main path's own inputs, timed.

After phase 4, one warm call of each flow runs under ``torch.profiler``
(device busy time, idle share, largest device items); those launches are
outside the counted phases.

K1's launch counter is set to 0 just before each main-path phase and read
just after it; a phase that ran no K1 launch fails.  Every exact-tier check
runs with TF32 matmuls allowed, to show that no result depends on it.
The last lines are the flows' timings (``flows: {...}``), the card's name
and power limit, the ``{"kernels": [...]}`` summary and, last,
``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
N, DIM, QUERIES, DEPTH = 2_000_000, 768, 512, 1000
ALPHA, CUTOFF, REFINE = 0.2, 10, 22
CHECK_QUERIES = 32
WARM_CALLS = 5
TIMED_LAUNCHES = 25
BF16_N = 262_144
SPARSE_QUERIES, SPARSE_DEPTH = 32, 100  # 3,200 pairs: n_pairs * 500 <= N

#: published H100 rates by part (NVIDIA data sheets): memory bytes/s and
#: fp32 (non-tensor) flop/s
CARD_RATES = {
    "pcie": (2.0e12, 51e12),
    "nvl": (3.9e12, 60e12),
    "sxm": (3.35e12, 67e12),
}

K1_SOURCE = "fastforward_tpu_torch/ops/csrc/stream_select_pairwise.cu"
K1_REPLACES = "fastforward_tpu/ops/stream_kernel.py:397"


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(*args) -> None:
    print(*args, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def card_rates(name: str) -> tuple[float, float]:
    low = name.lower()
    if "pcie" in low:
        return CARD_RATES["pcie"]
    if "nvl" in low:
        return CARD_RATES["nvl"]
    return CARD_RATES["sxm"]


def median_ms(fn, n: int, warmup: int = 3) -> float:
    """Median device time of ``fn()`` over ``n`` runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def sum_order_tol(absdot: torch.Tensor, dim: int) -> torch.Tensor:
    """Tolerance for two fp32 sums of the same ``dim`` products in different
    orders: the reordering error grows like ``sqrt(dim) * u * sum|terms|``
    (u = 2^-24), with a factor 8 of headroom."""
    return 8.0 * dim**0.5 * 2.0**-24 * absdot


def make_workload(n: int, num_queries: int, depth: int, seed: int):
    """Corpus, query vectors and a TREC-style run, as ``bench.py`` makes them."""
    rng = np.random.default_rng(seed)
    corpus = rng.standard_normal(size=(n, DIM), dtype=np.float32)
    qvecs = rng.standard_normal(size=(num_queries, DIM), dtype=np.float32)
    run, queries = {}, {}
    for q in range(num_queries):
        cand = rng.choice(n, size=depth, replace=False)
        run[f"q{q}"] = {f"p{c}": float(depth - i) for i, c in enumerate(cand)}
        queries[f"q{q}"] = f"query {q}"
    return corpus, qvecs, run, queries


def kernel_variants(sk, tables, q, cand3, tile_idx, dim, timed: bool, rates):
    """K1 against its plain version for every table type and tier."""
    results = []
    for name, table in tables:
        for exact in (True, False):
            out = sk.stream_select_pairwise(table, q, cand3, tile_idx, exact=exact)
            plain = sk.stream_select_pairwise_plain(table, q, cand3, tile_idx, exact=exact)
            # sum |row_k * q_k| per slot (bf16 rounding commutes with abs)
            absdot = sk.stream_select_pairwise_plain(
                table.abs(), q.abs(), cand3, tile_idx, exact=exact
            )
            torch.cuda.synchronize()
            err = (out - plain).abs()
            tol = sum_order_tol(absdot, dim)
            worst = int(err.argmax())
            check(
                bool(torch.isfinite(out).all()) and bool((err <= tol).all()),
                f"K1 {name} exact={exact} disagrees with its plain version: max err "
                f"{err.max().item()} (tolerance there {tol.view(-1)[worst].item()})",
            )
            row = {
                "table": name,
                "exact": exact,
                "shape": [int(s) for s in cand3.shape],
                "max_abs_err": err.max().item(),
                "max_rel_to_tol": (err / tol.clamp(min=1e-30)).max().item(),
            }
            if timed:
                row["ms"] = median_ms(
                    lambda: sk.stream_select_pairwise(table, q, cand3, tile_idx, exact=exact),
                    TIMED_LAUNCHES,
                )
                row["plain_ms"] = median_ms(
                    lambda: sk.stream_select_pairwise_plain(
                        table, q, cand3, tile_idx, exact=exact
                    ),
                    TIMED_LAUNCHES,
                )
                row.update(k1_bound(table, q, cand3, tile_idx, dim, sk.KERNEL_TILE_ROWS, rates))
            log("  K1", json.dumps(row))
            results.append(row)
    return results


def k1_bound(table, q, cand3, tile_idx, dim, r, rates) -> dict:
    """Least time for K1's work on these inputs: the rows the slots need,
    the queries, slots, tile indices and outputs each moved once, against
    the fp32 rate for its multiply-adds."""
    bw, fp32_rate = rates
    qb = q.shape[0]
    cand = cand3.reshape(cand3.shape[0], -1).long()
    rows = tile_idx.long()[:, None] * r + cand // qb
    n_rows = torch.unique(rows).numel()
    row_bytes = dim * table.element_size()
    nbytes = (
        n_rows * row_bytes
        + q.numel() * 4
        + cand3.numel() * 4
        + tile_idx.numel() * 4
        + cand3.numel() * 4
    )
    flops = 2.0 * cand3.numel() * dim
    t_bytes, t_ops = nbytes / bw * 1e3, flops / fp32_rate * 1e3
    return {
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": int(nbytes),
        "rows_read": int(n_rows),
    }


def check_rerank(result, corpus_dev, qvecs_dev, q_index, dim, what):
    """Scores of ``CHECK_QUERIES`` queries against float64 dots on the card."""
    df = result._df
    check(len(df) > 0, f"{what}: empty result")
    scores = df["score"].to_numpy(dtype=np.float64)
    check(bool(np.isfinite(scores).all()), f"{what}: non-finite scores")
    qid = df["q_id"].astype(str).to_numpy()
    ids = df["id"].astype(str).to_numpy()
    sel = np.isin(qid, [f"q{i}" for i in range(CHECK_QUERIES)])
    rows = torch.from_numpy(np.array([int(p[1:]) for p in ids[sel]])).cuda()
    qn = torch.from_numpy(np.array([q_index[q] for q in qid[sel]])).cuda()
    a = corpus_dev[rows].double()
    b = qvecs_dev[qn].double()
    ref = (a * b).sum(-1)
    tol = sum_order_tol((a * b).abs().sum(-1), dim)
    got = torch.from_numpy(scores[sel]).cuda()
    err = (got - ref).abs()
    check(bool((err <= tol).all()), f"{what}: max err {err.max().item()} vs float64 dots")
    log(f"  {what}: {int(sel.sum())} pairs of {CHECK_QUERIES} queries match float64 dots "
        f"(max err {err.max().item():.3e})")


def check_serve(result, rows_dev, qvecs_dev, q_index, run, dim, what):
    """Top-``CUTOFF`` ids and exact fp32 scores, for the first
    ``CHECK_QUERIES`` queries of ``run``, against float64 interpolation."""
    df = result._df
    want_rows = sum(min(CUTOFF, len(c)) for c in run.values())
    check(len(df) == want_rows, f"{what}: {len(df)} rows, want {want_rows}")
    by_q = {}
    for q, i, s in zip(df["q_id"].astype(str), df["id"].astype(str), df["score"]):
        by_q.setdefault(q, []).append((i, float(s)))
    worst = 0.0
    for q in list(run)[:CHECK_QUERIES]:
        cand = list(run[q].items())
        rows = torch.tensor([int(p[1:]) for p, _ in cand], device="cuda")
        lex = torch.tensor([s for _, s in cand], device="cuda", dtype=torch.float64)
        prods = rows_dev[rows].double() * qvecs_dev[q_index[q]].double()
        interp = ALPHA * lex + (1 - ALPHA) * prods.sum(-1)
        # the dot's reordering error, plus the fp32 interpolation's rounding
        tol = (1 - ALPHA) * sum_order_tol(prods.abs().sum(-1), dim) + interp.abs() * 2.0**-22
        exact = dict(zip((p for p, _ in cand), interp.tolist()))
        tol_of = dict(zip((p for p, _ in cand), tol.tolist()))
        got = by_q.get(q, [])
        check(len(got) == min(CUTOFF, len(cand)), f"{what}: {q} has {len(got)} results")
        for pid, score in got:
            worst = max(worst, abs(score - exact[pid]))
            check(abs(score - exact[pid]) <= tol_of[pid],
                  f"{what}: {q} {pid} score {score} vs exact {exact[pid]}")
        want = sorted(exact, key=exact.get, reverse=True)[:CUTOFF]
        floor = min(exact[p] for p, _ in got)
        for pid in set(want) - {p for p, _ in got}:
            # a miss is allowed only within rounding of the cut
            check(exact[pid] - floor <= 2 * tol_of[pid],
                  f"{what}: {q} lost true top-{CUTOFF} candidate {pid}")
    log(f"  {what}: top-{CUTOFF} of {min(CHECK_QUERIES, len(run))} queries match the "
        f"exact ranking (max score err {worst:.3e})")


def timed_calls(fn, n: int) -> tuple[float, list]:
    """Median host time (ms) of ``n`` calls that end in a synchronize."""
    times, out = [], None
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), out


def profile_flow(fn) -> dict:
    """One warm call under ``torch.profiler``: host wall time, the time the
    card spent in kernels and copies, the largest device items, and the
    host phases the index names (``ff.*`` ranges)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, spans = {}, {}
    for ev in prof.events():
        ms = ev.time_range.elapsed_us() / 1e3
        if ev.name.startswith("ff."):
            # the host range; its device-side twin only spans the kernels
            if ev.device_type != DeviceType.CUDA:
                spans[ev.name] = spans.get(ev.name, 0.0) + ms
        elif ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ms
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {
        "wall_ms": wall_ms,
        "device_ms": device_ms,
        "device_idle_share": 1.0 - device_ms / wall_ms,
        "top_device_ms": [[name[:80], ms] for name, ms in top],
        "host_span_ms": spans,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from fastforward_tpu_torch import InMemoryIndex, Mode, Ranking
    from fastforward_tpu_torch.encoder import LambdaEncoder
    from fastforward_tpu_torch.ops import _build, scoring
    from fastforward_tpu_torch.ops import stream_kernel as sk

    # TF32 on: the exact path must not depend on it
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    t_start = time.perf_counter()
    card = smi_line()
    name = torch.cuda.get_device_name(0)
    rates = card_rates(name)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"rates used for bounds: {rates[0] / 1e12} TB/s, {rates[1] / 1e12} fp32 TFLOP/s")

    # -- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build_kernel("stream_select_pairwise")
    log(f"[build] K1 built in {time.perf_counter() - t0:.2f} s: {lib_path.name}")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "Used" in line or "spill" in line:
            log("  ptxas:", line.strip())

    # -- 2. K1 vs plain, small shape ----------------------------------------
    log("[kernel-small] K1 vs plain at n_pad 8192, dim 256, Qb 64, 5000 pairs")
    rng = np.random.default_rng(SEED)
    n_pad, dim_s, qb, p = 8192, 256, 64, 5000
    rows = rng.integers(0, n_pad, size=p)
    qno = rng.integers(0, qb, size=p)
    cap = scoring._adaptive_cap(p, n_pad // sk.KERNEL_TILE_ROWS)
    cand, tidx, _ = scoring.build_streamed_layout(rows, qno, n_pad, qb, cap=cap)
    cand3 = torch.from_numpy(cand.reshape(cand.shape[0], cap // 128, 128)).cuda()
    tile_idx = torch.from_numpy(tidx).cuda()
    q_s = torch.from_numpy(rng.standard_normal((qb, dim_s), dtype=np.float32)).cuda()
    t32 = torch.from_numpy(rng.standard_normal((n_pad, dim_s), dtype=np.float32)).cuda()
    t8 = torch.from_numpy(rng.integers(-127, 128, size=(n_pad, dim_s // 128, 128), dtype=np.int8)).cuda()
    tables = [("fp32", t32), ("bf16", t32.to(torch.bfloat16)), ("int8", t8)]
    kernel_variants(sk, tables, q_s, cand3, tile_idx, dim_s, False, rates)

    # -- 3. re-rank at the flagship shape ------------------------------------
    t0 = time.perf_counter()
    corpus, qvecs, run, queries = make_workload(N, QUERIES, DEPTH, SEED)
    by_text = {f"query {i}": qvecs[i] for i in range(QUERIES)}
    q_index = {f"q{i}": i for i in range(QUERIES)}
    ranking = Ranking.from_run(run, queries=queries)
    index = InMemoryIndex(
        query_encoder=LambdaEncoder(by_text.__getitem__),
        mode=Mode.PASSAGE,
        precision="high",
    )
    index.add(corpus, psg_ids=[f"p{i}" for i in range(N)])
    log(f"[setup] corpus {corpus.shape} fp32 + {len(ranking._df)} pairs built in "
        f"{time.perf_counter() - t0:.1f} s")
    corpus_dev = torch.from_numpy(corpus).cuda()
    qvecs_dev = torch.from_numpy(qvecs).cuda()
    launches = {}

    sk.stream_select_pairwise.launches = 0
    t0 = time.perf_counter()
    cold = index(ranking)
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    warm_ms, warm = timed_calls(lambda: index(ranking), WARM_CALLS)
    launches["rerank"] = sk.stream_select_pairwise.launches
    check(launches["rerank"] == 1 + WARM_CALLS, f"re-rank ran K1 {launches['rerank']} times")
    check(len(warm._df) == len(ranking._df), "re-rank lost pairs")
    check_rerank(warm, corpus_dev, qvecs_dev, q_index, DIM, "re-rank")
    check(cold == warm, "cold and warm re-rank disagree")
    flows = {
        "rerank": {"cold_ms": cold_ms, "warm_ms": warm_ms, "qps": QUERIES / warm_ms * 1e3}
    }
    log(f"[rerank] cold {cold_ms:.1f} ms, warm median {warm_ms:.2f} ms, "
        f"{flows['rerank']['qps']:.1f} QPS, K1 launches {launches['rerank']}")
    plan = index._get_plan(ranking)
    main_inputs = (plan["stream"][0], plan["stream"][1], plan["q_dev"][1])

    # -- 4. fused serve --------------------------------------------------
    for label, refine in (("serve_refine", REFINE), ("serve", None)):
        sk.stream_select_pairwise.launches = 0
        t0 = time.perf_counter()
        index.serve(ranking, ALPHA, CUTOFF, refine=refine)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        ms, served = timed_calls(
            lambda: index.serve(ranking, ALPHA, CUTOFF, refine=refine), WARM_CALLS
        )
        launches[label] = sk.stream_select_pairwise.launches
        check(launches[label] == 1 + WARM_CALLS, f"{label} ran K1 {launches[label]} times")
        check_serve(served, corpus_dev, qvecs_dev, q_index, run, DIM, label)
        flows[label] = {"first_ms": first_ms, "warm_ms": ms, "qps": QUERIES / ms * 1e3}
        log(f"[{label}] first {first_ms:.1f} ms, warm median {ms:.2f} ms, "
            f"{flows[label]['qps']:.1f} QPS, K1 launches {launches[label]}")

    for label, fn in (
        ("rerank", lambda: index(ranking)),
        ("serve_refine", lambda: index.serve(ranking, ALPHA, CUTOFF, refine=REFINE)),
        ("serve", lambda: index.serve(ranking, ALPHA, CUTOFF)),
    ):
        flows[label]["profile"] = profile_flow(fn)
        log(f"[profile {label}]", json.dumps(flows[label]["profile"]))

    # -- 5. sparse ranking and a bf16 table ----------------------------------
    sparse_run = {f"q{i}": dict(list(run[f"q{i}"].items())[:SPARSE_DEPTH]) for i in range(SPARSE_QUERIES)}
    sparse = Ranking.from_run(sparse_run, queries={q: queries[q] for q in sparse_run})
    check(len(sparse._df) * scoring.STREAM_DENSITY <= index._device_view().table.shape[0],
          "the sparse ranking would stream")
    sk.stream_select_pairwise.launches = 0
    check_rerank(index(sparse), corpus_dev, qvecs_dev, q_index, DIM, "sparse re-rank")
    launches["sparse"] = sk.stream_select_pairwise.launches
    check(launches["sparse"] == 0, "the sparse ranking ran K1")

    bf16_corpus = corpus[:BF16_N]
    bf16_run = {q: {p: s for p, s in run[q].items() if int(p[1:]) < BF16_N} for q in run}
    bf16_run = {q: d for q, d in bf16_run.items() if d}
    bf16_rank = Ranking.from_run(bf16_run, queries={q: queries[q] for q in bf16_run})
    bf16_index = InMemoryIndex(
        query_encoder=LambdaEncoder(by_text.__getitem__),
        mode=Mode.PASSAGE,
        precision="high",
        device_dtype="bfloat16",
    )
    bf16_index.add(bf16_corpus, psg_ids=[f"p{i}" for i in range(BF16_N)])
    # the table holds bf16-rounded rows: check against those
    bf16_rows = torch.from_numpy(bf16_corpus).cuda().to(torch.bfloat16).float()
    sk.stream_select_pairwise.launches = 0
    check_rerank(bf16_index(bf16_rank), bf16_rows, qvecs_dev, q_index, DIM, "bf16 re-rank")
    launches["bf16_rerank"] = sk.stream_select_pairwise.launches
    check(launches["bf16_rerank"] >= 1, "bf16 re-rank ran no K1 launch")
    sk.stream_select_pairwise.launches = 0
    bf16_served = bf16_index.serve(bf16_rank, ALPHA, CUTOFF, refine=REFINE)
    launches["bf16_serve_refine"] = sk.stream_select_pairwise.launches
    check(launches["bf16_serve_refine"] == 1, "bf16 serve ran no K1 launch")
    check_serve(bf16_served, bf16_rows, qvecs_dev, q_index, bf16_run, DIM, "bf16 serve_refine")
    del bf16_index, bf16_rows

    # -- 6. K1 vs plain on the main path's inputs, timed ---------------------
    cand3, tile_idx, q_dev = main_inputs
    table = index._device_view().table
    log(f"[kernel-flagship] K1 vs plain on the re-rank's own layout {tuple(cand3.shape)}")
    t8 = torch.randint(-127, 128, (table.shape[0], DIM // 128, 128), dtype=torch.int8,
                       device="cuda", generator=torch.Generator("cuda").manual_seed(SEED))
    tables = [("fp32", table), ("bf16", table.to(torch.bfloat16)), ("int8", t8)]
    variants = kernel_variants(sk, tables, q_dev, cand3, tile_idx, DIM, True, rates)
    main = variants[0]  # fp32 table, exact: the re-rank's variant
    kernels = {
        "kernels": [
            {
                "name": "stream_select_pairwise",
                "route": "cuda",
                "source": K1_SOURCE,
                "replaces": K1_REPLACES,
                "launches": launches["rerank"] + launches["serve_refine"] + launches["serve"],
                "max_abs_err": max(v["max_abs_err"] for v in variants),
                "ms": main["ms"],
                "plain_ms": main["plain_ms"],
                "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"],
                "library_ms": None,
                "checks": ["small shape x 3 tables x 2 tiers", "flagship x 3 tables x 2 tiers",
                           "re-rank vs float64", "serve top-10 vs exact", "bf16 table vs float64"],
                "launches_by_phase": launches,
                "variants": variants,
            }
        ]
    }
    forbidden = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "fastforward_tpu."))
                 or m == "fastforward_tpu"]
    check(not forbidden, f"JAX or the JAX package was imported: {forbidden[:5]}")
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    log("flows:", json.dumps(flows))
    log(smi_line())
    print(json.dumps(kernels), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
