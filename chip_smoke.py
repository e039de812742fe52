#!/usr/bin/env python3
"""GPU smoke run of fastforward_tpu_torch: kernels, re-rank and fused serve.

Run from the repository root on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. header: the card's name and power limit; K1-K4 built with ``nvcc`` from
   ``fastforward_tpu_torch/ops/csrc`` (one compiler per source, all at once);
2. K1 (``stream_select_pairwise``) against its plain PyTorch version at a
   small shape, for fp32, bf16 and int8 tables, exact and fast tiers; K2
   (``stream_select``, fp32/bf16/int8 tables) and K4 (``stream_select_pq``)
   at ``cap > r``, K3 (``stream_select_pq_pairwise``) at ``cap <= r``, every
   tier;
3. re-rank at the flagship shape (N = 2,000,000 passages, dim 768, fp32,
   Q = 512 queries x depth 1000, ``Mode.PASSAGE``, precision ``"high"``):
   one cold and several warm ``index(ranking)`` calls, 32 queries checked
   against float64 dots;
4. fused serve at the same shape: ``serve(ranking, 0.2, 10, refine=22)``
   and ``serve(ranking, 0.2, 10)``, top-10 ids and scores checked against
   the exact interpolated top-10 of 32 queries;
5. a sparse ranking (the gather-dot branch) and a bf16 table at
   N = 262,144, checked the same way;
6. K1 against its plain version on the main path's own inputs, timed;
7. int8 at full width: ``ScalarQuantizer`` fitted on the first 2^16
   vectors of the same corpus, precision ``"high"``: a cold and 5 warm
   re-ranks and the fused serve, checked against float64 dots of the
   decoded rows; must launch K1 and no K2;
8. int8 with dense tiles: the first 262,144 rows with their own 512 x 1000
   run (cap 1024 > r = 512); must launch K2 and no K1;
9. PQ at full width: ``PQ(96, 256)`` fitted on the card on 2^16 vectors,
   precision ``"exact"``, checked against float64 decode-then-dot; must
   launch K3.  Before it, ``PQ(96, 256)`` is fitted on the card and on the
   CPU on clustered data and their codes compared, and after the encode
   4,096 of the card's codes are compared with a CPU encode (the float64
   references are built from the card's codes, so they alone would not
   catch a wrong fit or encode);
10. OPQ with dense tiles: ``OPQ(96, 256)`` on the 262,144 rows and their
    run, checked against float64 ``(q @ R) . decode`` and, like PQ, 4,096
    of its codes against a CPU encode; must launch K4;
11. K2, K3 and K4 against their plain versions on the layouts of phases 8,
    9 and 10, timed, with their bounds.

After phases 4 and 7-10, one warm call of each flow runs under
``torch.profiler`` (device busy time, idle share, largest device items;
``None`` where no complete trace was taken, or where the traced kernel took
under half its CUDA-event time of phases 6 and 11); those launches are
outside the counted phases.  ``ScalarQuantizer`` fits and encodes in numpy on the host,
so the int8 phases have no on-card quantizer to check.

Every kernel's launch counter is set to 0 just before each main-path phase
and read just after it; a phase that did not launch its kernel, or launched
one it must not, fails.  Every exact-tier check runs with TF32 matmuls
allowed, to show that no result depends on it.
The last lines are the flows' timings (``flows: {...}``), the card's name
and power limit, the ``{"kernels": [...]}`` summary and, last,
``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
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

QUANT_FIT = 1 << 16  # training vectors of the quantizers
DENSE_N = 262_144  # rows of the dense-tile phases: ~1,000 pairs per 512-row tile
PQ_M, PQ_KS = 96, 256
PROFILE_TRIES = 8  # traces per profiled flow until one is complete
ENCODE_CHECK_ROWS = 4096  # rows the card's PQ/OPQ codes are checked on against the CPU's
ENCODE_AGREE = 0.999  # least share of those codes that must agree
FIT_CHECK_N = 1 << 14  # clustered rows of the on-card k-means check (half train, half held out)
FIT_AGREE = 0.99  # least share of held-out codes the card's and the CPU's fits agree on
#: how the profiler names the port's kernels (K1-K4)
PORT_KERNEL_NAMES = tuple(
    f"void (anonymous namespace)::{k}<"
    for k in ("pairwise_kernel", "select_kernel", "adc_pairwise_kernel", "adc_kernel")
)

#: kernel -> (source, the Pallas call it replaces)
KERNELS = {
    "stream_select_pairwise": (
        "fastforward_tpu_torch/ops/csrc/stream_select_pairwise.cu",
        "fastforward_tpu/ops/stream_kernel.py:397",
    ),
    "stream_select": (
        "fastforward_tpu_torch/ops/csrc/stream_select.cu",
        "fastforward_tpu/ops/stream_kernel.py:197",
    ),
    "stream_select_pq_pairwise": (
        "fastforward_tpu_torch/ops/csrc/stream_select_pq_pairwise.cu",
        "fastforward_tpu/ops/stream_kernel_pq.py:351",
    ),
    "stream_select_pq": (
        "fastforward_tpu_torch/ops/csrc/stream_select_pq.cu",
        "fastforward_tpu/ops/stream_kernel_pq.py:454",
    ),
}


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
    """Least time for K1's (or K2's) work on these inputs: the rows the
    slots need, the queries, slots, tile indices and outputs each moved
    once, against the fp32 rate for one ``dim``-long dot per slot (each
    slot is a distinct (row, query) pair: no product is shared)."""
    return stream_bound(
        dim * table.element_size(), 0, q, cand3, tile_idx, r, lambda slots, _: 2.0 * dim * slots,
        rates,
    )


def pq_bound(codes, codebooks, q, cand3, tile_idx, r, rates) -> dict:
    """The same for K3/K4: each needed code row (M bytes) and the codebooks
    moved once, against the least ADC arithmetic.  Slots of one query share
    its lookup table (the query's subvector dotted with every codeword:
    2 * Ds flops for each of M * Ks entries), so a slot costs only its M
    table entries' adds; the tables are counted once per query the slots
    use."""
    m, ks, ds = codebooks.shape
    return stream_bound(
        m * codes.element_size(), codebooks.numel() * 4, q, cand3, tile_idx, r,
        lambda slots, n_queries: n_queries * m * ks * 2.0 * ds + slots * m, rates,
    )


def stream_bound(row_bytes, extra_bytes, q, cand3, tile_idx, r, flops_of, rates) -> dict:
    """Least time for a streamed kernel's work: the distinct rows its slots
    read (``row_bytes`` each), ``extra_bytes``, the query block, slots, tile
    indices and outputs each moved once, or its flops
    (``flops_of(slots, distinct queries)``) at the fp32 rate.  ``q`` is the
    row-major ``(Qb, dim)`` block."""
    bw, fp32_rate = rates
    qb = q.shape[0]
    cand = cand3.reshape(cand3.shape[0], -1).long()
    rows = tile_idx.long()[:, None] * r + cand // qb
    n_rows = torch.unique(rows).numel()
    n_queries = torch.unique(cand % qb).numel()
    nbytes = (
        n_rows * row_bytes
        + extra_bytes
        + q.numel() * 4
        + cand3.numel() * 4
        + tile_idx.numel() * 4
        + cand3.numel() * 4
    )
    flops = flops_of(cand3.numel(), n_queries)
    t_bytes, t_ops = nbytes / bw * 1e3, flops / fp32_rate * 1e3
    return {
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": int(nbytes),
        "flops": float(flops),
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
    host phases the index names (``ff.*`` ranges).

    On the H100 machine the profiler drops device items of some traced
    calls once the process has traced before (from ~30 s after its first
    traced window, for some windows and not others; padding the window with
    idle pauses did not stop it).  Every profiled flow launches one of the
    port's kernels and ends in a device-to-host copy of its result, so a
    trace that lacks either is incomplete and is taken again, up to
    ``PROFILE_TRIES`` times; ``tries`` says how many it took.  When no try
    gives a complete trace, ``complete`` is false and the card's busy time
    and idle share are ``None`` (not measured): an incomplete trace would
    understate the one and overstate the other.  ``vet_profiles`` later
    holds the traced kernel time against CUDA events.  A complete trace can
    still miss an item that is neither, such as a gather; section 7 of
    PERF.md keeps that open."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for tries in range(1, PROFILE_TRIES + 1):
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
        port_ms = sum(ms for n, ms in by_name.items() if n.startswith(PORT_KERNEL_NAMES))
        complete = port_ms > 0 and any(n.startswith("Memcpy DtoH") for n in by_name)
        if complete:
            break
    device_ms = sum(by_name.values()) if complete else None
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {
        "wall_ms": wall_ms,
        "complete": complete,
        "device_ms": device_ms,
        "device_idle_share": None if device_ms is None else 1.0 - device_ms / wall_ms,
        "port_kernel_ms": port_ms,
        "tries": tries,
        "top_device_ms": [[name[:80], ms] for name, ms in top],
        "host_span_ms": spans,
    }


def vet_profiles(flows: dict, variants: dict) -> None:
    """Hold each complete trace's port-kernel time against the CUDA-event
    time of the same kernel, tier and layout (phases 6 and 11).  The
    profiler has kept a kernel item with a fraction of its time; a trace
    whose port kernel took under half the event time is marked incomplete,
    and its busy time and idle share become ``None``."""
    k1 = {(v["table"], v["exact"]): v["ms"] for v in variants["stream_select_pairwise"]}
    event_ms = {
        "rerank": k1["fp32", True],
        "serve_refine": k1["fp32", False],
        "serve": k1["fp32", True],
        "int8_rerank": k1["int8", True],
        "int8_serve": k1["int8", True],
    }
    for label, kname in (("int8_dense", "stream_select"), ("pq", "stream_select_pq_pairwise"),
                         ("opq_dense", "stream_select_pq")):
        event_ms[f"{label}_rerank"] = event_ms[f"{label}_serve"] = variants[kname][0]["ms"]
    for flow, ms in event_ms.items():
        prof = flows[flow]["profile"]
        prof["kernel_event_ms"] = ms
        if prof["complete"] and prof["port_kernel_ms"] < 0.5 * ms:
            prof.update(complete=False, device_ms=None, device_idle_share=None)
        log(f"[profile-check {flow}] traced port kernel {prof['port_kernel_ms']:.4f} ms, "
            f"CUDA events {ms:.4f} ms; complete {prof['complete']}")


def reset_counts(wrappers) -> None:
    for fn in wrappers.values():
        fn.launches = 0


def read_counts(wrappers) -> dict:
    return {name: fn.launches for name, fn in wrappers.items()}


def hold(what, fn, plain_fn, abs_fn, dim, timed, bound_fn):
    """One kernel call against its plain version on the same card tensors,
    within the fp32 sum-order tolerance; timed beside its plain version and
    bound when ``timed``."""
    out = fn()
    plain = plain_fn()
    absdot = abs_fn()  # sum |terms| per slot (bf16 rounding commutes with abs)
    torch.cuda.synchronize()
    err = (out - plain).abs()
    tol = sum_order_tol(absdot, dim)
    worst = int(err.argmax())
    check(
        bool(torch.isfinite(out).all()) and bool((err <= tol).all()),
        f"{what} disagrees with its plain version: max err {err.max().item()} "
        f"(tolerance there {tol.view(-1)[worst].item()})",
    )
    row = {
        "variant": what,
        "shape": [int(s) for s in out.shape],
        "max_abs_err": err.max().item(),
        "max_rel_to_tol": (err / tol.clamp(min=1e-30)).max().item(),
    }
    if timed:
        row["ms"] = median_ms(fn, TIMED_LAUNCHES)
        row["plain_ms"] = median_ms(plain_fn, TIMED_LAUNCHES)
        row.update(bound_fn())
    log("  ", json.dumps(row))
    return row


def select_variants(sk, table, q, cand3, tile_idx, dim, tiers, timed, rates, label):
    """K2 against its plain version (``q`` row-major; K2 takes ``q.t()``)."""
    return [
        hold(
            f"K2 {label} {p}",
            lambda p=p: sk.stream_select(table, q.t(), cand3, tile_idx, precision=p),
            lambda p=p: sk.stream_select_plain(table, q.t(), cand3, tile_idx, precision=p),
            lambda p=p: sk.stream_select_plain(table.abs(), q.abs().t(), cand3, tile_idx, precision=p),
            dim,
            timed,
            lambda: k1_bound(table, q, cand3, tile_idx, dim, sk.KERNEL_TILE_ROWS, rates),
        )
        for p in tiers
    ]


def pq_variants(skpq, kernel, codes, cb, q, cand3, tile_idx, tiers, timed, rates, label):
    """K3 (``kernel="K3"``) or K4 against its plain version (``q`` row-major;
    K4 takes ``q.t()``)."""
    dim = cb.shape[0] * cb.shape[2]

    def call(plain, tier, c=cb, qq=q):
        if kernel == "K3":
            fn = skpq.stream_select_pq_pairwise_plain if plain else skpq.stream_select_pq_pairwise
            return fn(codes, c, qq, cand3, tile_idx, exact=tier != "fast")
        fn = skpq.stream_select_pq_plain if plain else skpq.stream_select_pq
        return fn(codes, c, qq.t(), cand3, tile_idx, precision=tier)

    return [
        hold(
            f"{kernel} {label} {p}",
            lambda p=p: call(False, p),
            lambda p=p: call(True, p),
            lambda p=p: call(True, p, cb.abs(), q.abs()),
            dim,
            timed,
            lambda: pq_bound(codes, cb, q, cand3, tile_idx, skpq.KERNEL_PQ_TILE_ROWS, rates),
        )
        for p in tiers
    ]


def small_layout(rng, n_pad, qb, p, r):
    """A random streamed layout on the card (cap from the pair density)."""
    from fastforward_tpu_torch.ops import scoring

    rows = rng.integers(0, n_pad, size=p)
    qno = rng.integers(0, qb, size=p)
    cap = scoring._adaptive_cap(p, n_pad // r)
    cand, tidx, _ = scoring.build_streamed_layout(rows, qno, n_pad, qb, r=r, cap=cap)
    return (
        torch.from_numpy(cand.reshape(cand.shape[0], cap // 128, 128)).cuda(),
        torch.from_numpy(tidx).cuda(),
    )


class DecodedRows:
    """Rows of a quantized table decoded on the card in float64, indexed
    like a tensor of rows (``decoded[rows]``)."""

    def __init__(self, decode):
        self._decode = decode

    def __getitem__(self, rows):
        return self._decode(rows)


def scalar_rows(codes: np.ndarray, scales: np.ndarray) -> DecodedRows:
    codes_dev = torch.from_numpy(codes).cuda()
    scales_dev = torch.from_numpy(scales).cuda().double()
    return DecodedRows(lambda rows: codes_dev[rows].double() * scales_dev)


def pq_rows(codes: np.ndarray, codewords: np.ndarray) -> DecodedRows:
    """PQ decode without OPQ's inverse rotation (the queries get ``R``)."""
    codes_dev = torch.from_numpy(codes).cuda()
    cb = torch.from_numpy(codewords).cuda().double()
    sub = torch.arange(cb.shape[0], device="cuda")[None, :]
    return DecodedRows(lambda rows: cb[sub, codes_dev[rows].long()].reshape(rows.shape[0], -1))


def check_encode(label: str, quantizer, codes: np.ndarray, vectors: np.ndarray) -> float:
    """The codes the card gave ``ENCODE_CHECK_ROWS`` rows spread over
    ``vectors`` against the same quantizer's encode on the CPU.  With the
    same codebooks both are fp32 nearest-centroid searches that differ only
    in summation order, so only exact near-ties may differ; a TF32 product
    or a wrong encode would flip far more than ``1 - ENCODE_AGREE``."""
    on_cpu = type(quantizer).deserialize(*quantizer.serialize())
    on_cpu.device = "cpu"
    rows = np.linspace(0, vectors.shape[0] - 1, ENCODE_CHECK_ROWS).astype(np.int64)
    agree = float((codes[rows] == on_cpu.encode(vectors[rows])).mean())
    check(agree >= ENCODE_AGREE, f"{label}: the card's codes agree with the CPU's on {agree:.5f}")
    log(f"  {label}: the card's codes of {ENCODE_CHECK_ROWS} rows agree with a CPU encode on "
        f"{agree:.5f} of them")
    return agree


def check_fit(cls, m: int, ks: int) -> float:
    """``cls(m, ks)`` fitted on the card and on the CPU, from the same seed
    (the same initial rows), on clustered data at dim ``DIM``: the two
    k-means encode at least ``FIT_AGREE`` of the held-out codes alike (not
    all: a near-tie that the two sums break differently moves a centroid
    slightly in every later iteration)."""
    rng = np.random.default_rng(SEED + 2)
    centers = rng.standard_normal((m, ks, DIM // m), dtype=np.float32) * 3
    pick = rng.integers(0, ks, size=(FIT_CHECK_N, m))
    data = centers[np.arange(m)[None, :], pick].reshape(FIT_CHECK_N, DIM)
    data = (data + 0.3 * rng.standard_normal(data.shape, dtype=np.float32)).astype(np.float32)
    train, held_out = data[: FIT_CHECK_N // 2], data[FIT_CHECK_N // 2 :]
    card, host = cls(m, ks), cls(m, ks, device="cpu")
    card.fit(train)
    host.fit(train)
    agree = float((card.encode(held_out) == host.encode(held_out)).mean())
    check(agree >= FIT_AGREE, f"{cls.__name__}({m}, {ks}) fitted on the card and on the CPU "
          f"agree on {agree:.5f} of the codes")
    log(f"  {cls.__name__}({m}, {ks}) fitted on the card and on the CPU from one seed: "
        f"{agree:.5f} of {held_out.shape[0]} x {m} held-out codes agree")
    return agree


def add_in_chunks(index, vectors: np.ndarray, psg_ids: list, chunk: int = 1 << 18) -> None:
    """Add (and so encode) the vectors in chunks, bounding the temporaries."""
    for lo in range(0, vectors.shape[0], chunk):
        part = vectors[lo : lo + chunk]
        index.add(part, psg_ids=psg_ids[lo : lo + part.shape[0]])


def quantized_phase(label, index, ranking, run, rows_ref, q_ref, q_index, wrappers, want, forbid):
    """Cold + warm re-ranks and the fused serve of a quantized index, each
    checked against float64; the phase must launch ``want`` and no
    ``forbid``.  Returns (flows, launches)."""
    reset_counts(wrappers)
    t0 = time.perf_counter()
    cold = index(ranking)
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    warm_ms, warm = timed_calls(lambda: index(ranking), WARM_CALLS)
    check(len(warm._df) == len(ranking._df), f"{label} re-rank lost pairs")
    check_rerank(warm, rows_ref, q_ref, q_index, DIM, f"{label} re-rank")
    check(cold == warm, f"{label}: cold and warm re-rank disagree")
    t0 = time.perf_counter()
    index.serve(ranking, ALPHA, CUTOFF)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    serve_ms, served = timed_calls(lambda: index.serve(ranking, ALPHA, CUTOFF), WARM_CALLS)
    launches = read_counts(wrappers)
    check_serve(served, rows_ref, q_ref, q_index, run, DIM, f"{label} serve")
    check(launches[want] == 2 * (1 + WARM_CALLS),
          f"{label} launched {want} {launches[want]} times: {launches}")
    for name in forbid:
        check(launches[name] == 0, f"{label} launched {name}: {launches}")
    flows = {
        f"{label}_rerank": {"cold_ms": cold_ms, "warm_ms": warm_ms, "qps": QUERIES / warm_ms * 1e3},
        f"{label}_serve": {"first_ms": first_ms, "warm_ms": serve_ms, "qps": QUERIES / serve_ms * 1e3},
    }
    log(f"[{label}] re-rank cold {cold_ms:.1f} ms, warm median {warm_ms:.2f} ms; serve first "
        f"{first_ms:.1f} ms, warm median {serve_ms:.2f} ms; launches {launches}")
    for key, fn in (
        (f"{label}_rerank", lambda: index(ranking)),
        (f"{label}_serve", lambda: index.serve(ranking, ALPHA, CUTOFF)),
    ):
        flows[key]["profile"] = profile_flow(fn)
        log(f"[profile {key}]", json.dumps(flows[key]["profile"]))
    return flows, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from fastforward_tpu_torch import InMemoryIndex, Mode, Ranking
    from fastforward_tpu_torch.encoder import LambdaEncoder
    from fastforward_tpu_torch.ops import _build, scoring
    from fastforward_tpu_torch.ops import stream_kernel as sk
    from fastforward_tpu_torch.ops import stream_kernel_pq as skpq
    from fastforward_tpu_torch.quantizer import OPQ, PQ, ScalarQuantizer

    wrappers = {
        "stream_select_pairwise": sk.stream_select_pairwise,
        "stream_select": sk.stream_select,
        "stream_select_pq_pairwise": skpq.stream_select_pq_pairwise,
        "stream_select_pq": skpq.stream_select_pq,
    }
    # TF32 on: the exact path must not depend on it
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    t_start = time.perf_counter()
    card = smi_line()
    name = torch.cuda.get_device_name(0)
    rates = card_rates(name)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"rates used for bounds: {rates[0] / 1e12} TB/s, {rates[1] / 1e12} fp32 TFLOP/s")

    # -- 1. build: one nvcc per source, all at once ------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        built = dict(zip(KERNELS, pool.map(_build.build_kernel, KERNELS)))
    log(f"[build] K1-K4 built in {time.perf_counter() - t0:.2f} s")
    for kname, lib_path in built.items():
        log(f"  {kname}: {lib_path.name}")
        for line in lib_path.with_suffix(".log").read_text().splitlines():
            if "Used" in line or "spill" in line:
                log("  ptxas:", line.strip())

    # -- 2. kernels vs plain, small shapes ---------------------------------------
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

    log("[kernel-small] K2 vs plain at n_pad 4096, dim 768, Qb 64, 6000 pairs (cap > r)")
    n_pad = 4096
    cand3, tile_idx = small_layout(rng, n_pad, qb, 6000, sk.KERNEL_TILE_ROWS)
    check(cand3.shape[1] * 128 > sk.KERNEL_TILE_ROWS, "K2's small layout has cap <= r")
    q_s = torch.from_numpy(rng.standard_normal((qb, DIM), dtype=np.float32)).cuda()
    t32 = torch.from_numpy(rng.standard_normal((n_pad, DIM // 128, 128), dtype=np.float32)).cuda()
    t8 = torch.from_numpy(rng.integers(-127, 128, size=(n_pad, DIM // 128, 128), dtype=np.int8)).cuda()
    small = []
    for label, table in (("fp32", t32), ("bf16", t32.view(n_pad, DIM).to(torch.bfloat16)), ("int8", t8)):
        small += select_variants(sk, table, q_s, cand3, tile_idx, DIM, ("exact", "high", "fast"),
                                 False, rates, label)
    log(f"[kernel-small] K3 (cap <= r) and K4 (cap > r) vs plain at n_pad 4096, PQ({PQ_M}, {PQ_KS})")
    codes_s = torch.from_numpy(rng.integers(0, PQ_KS, size=(n_pad, PQ_M), dtype=np.uint8)).cuda()
    cb_s = torch.from_numpy(rng.standard_normal((PQ_M, PQ_KS, DIM // PQ_M), dtype=np.float32)).cuda()
    lay3 = small_layout(rng, n_pad, qb, 3000, skpq.KERNEL_PQ_TILE_ROWS)
    check(lay3[0].shape[1] * 128 <= skpq.KERNEL_PQ_TILE_ROWS, "K3's small layout has cap > r")
    small += pq_variants(skpq, "K3", codes_s, cb_s, q_s, *lay3, ("exact", "fast"), False, rates, "pq")
    small += pq_variants(skpq, "K4", codes_s, cb_s, q_s, cand3, tile_idx, ("exact", "high", "fast"),
                         False, rates, "pq")

    # -- 3. re-rank at the flagship shape ------------------------------------
    t0 = time.perf_counter()
    corpus, qvecs, run, queries = make_workload(N, QUERIES, DEPTH, SEED)
    by_text = {f"query {i}": qvecs[i] for i in range(QUERIES)}
    q_index = {f"q{i}": i for i in range(QUERIES)}
    psg_ids = [f"p{i}" for i in range(N)]
    ranking = Ranking.from_run(run, queries=queries)
    index = InMemoryIndex(
        query_encoder=LambdaEncoder(by_text.__getitem__),
        mode=Mode.PASSAGE,
        precision="high",
    )
    index.add(corpus, psg_ids=psg_ids)
    log(f"[setup] corpus {corpus.shape} fp32 + {len(ranking._df)} pairs built in "
        f"{time.perf_counter() - t0:.1f} s")
    corpus_dev = torch.from_numpy(corpus).cuda()
    qvecs_dev = torch.from_numpy(qvecs).cuda()
    launches = {}

    def k1_phase_launches(phase: str) -> int:
        counts = read_counts(wrappers)
        launches[phase] = counts
        others = {k: v for k, v in counts.items() if k != "stream_select_pairwise" and v}
        check(not others, f"{phase} launched other kernels than K1: {others}")
        return counts["stream_select_pairwise"]

    reset_counts(wrappers)
    t0 = time.perf_counter()
    cold = index(ranking)
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    warm_ms, warm = timed_calls(lambda: index(ranking), WARM_CALLS)
    n_k1 = k1_phase_launches("rerank")
    check(n_k1 == 1 + WARM_CALLS, f"re-rank ran K1 {n_k1} times")
    check(len(warm._df) == len(ranking._df), "re-rank lost pairs")
    check_rerank(warm, corpus_dev, qvecs_dev, q_index, DIM, "re-rank")
    check(cold == warm, "cold and warm re-rank disagree")
    flows = {
        "rerank": {"cold_ms": cold_ms, "warm_ms": warm_ms, "qps": QUERIES / warm_ms * 1e3}
    }
    log(f"[rerank] cold {cold_ms:.1f} ms, warm median {warm_ms:.2f} ms, "
        f"{flows['rerank']['qps']:.1f} QPS, K1 launches {n_k1}")
    plan = index._get_plan(ranking)
    main_inputs = (plan["stream"][0], plan["stream"][1], plan["q_dev"][1])

    # -- 4. fused serve --------------------------------------------------
    for label, refine in (("serve_refine", REFINE), ("serve", None)):
        reset_counts(wrappers)
        t0 = time.perf_counter()
        index.serve(ranking, ALPHA, CUTOFF, refine=refine)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        ms, served = timed_calls(
            lambda: index.serve(ranking, ALPHA, CUTOFF, refine=refine), WARM_CALLS
        )
        n_k1 = k1_phase_launches(label)
        check(n_k1 == 1 + WARM_CALLS, f"{label} ran K1 {n_k1} times")
        check_serve(served, corpus_dev, qvecs_dev, q_index, run, DIM, label)
        flows[label] = {"first_ms": first_ms, "warm_ms": ms, "qps": QUERIES / ms * 1e3}
        log(f"[{label}] first {first_ms:.1f} ms, warm median {ms:.2f} ms, "
            f"{flows[label]['qps']:.1f} QPS, K1 launches {n_k1}")

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
    reset_counts(wrappers)
    check_rerank(index(sparse), corpus_dev, qvecs_dev, q_index, DIM, "sparse re-rank")
    check(k1_phase_launches("sparse") == 0, "the sparse ranking ran K1")

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
    bf16_index.add(bf16_corpus, psg_ids=psg_ids[:BF16_N])
    # the table holds bf16-rounded rows: check against those
    bf16_rows = torch.from_numpy(bf16_corpus).cuda().to(torch.bfloat16).float()
    reset_counts(wrappers)
    check_rerank(bf16_index(bf16_rank), bf16_rows, qvecs_dev, q_index, DIM, "bf16 re-rank")
    check(k1_phase_launches("bf16_rerank") >= 1, "bf16 re-rank ran no K1 launch")
    reset_counts(wrappers)
    bf16_served = bf16_index.serve(bf16_rank, ALPHA, CUTOFF, refine=REFINE)
    check(k1_phase_launches("bf16_serve_refine") == 1, "bf16 serve ran no K1 launch")
    check_serve(bf16_served, bf16_rows, qvecs_dev, q_index, bf16_run, DIM, "bf16 serve_refine")
    del bf16_index, bf16_rows

    # -- 6. K1 vs plain on the main path's inputs, timed ---------------------
    cand3, tile_idx, q_dev = main_inputs
    table = index._device_view().table
    log(f"[kernel-flagship] K1 vs plain on the re-rank's own layout {tuple(cand3.shape)}")
    t8 = torch.randint(-127, 128, (table.shape[0], DIM // 128, 128), dtype=torch.int8,
                       device="cuda", generator=torch.Generator("cuda").manual_seed(SEED))
    tables = [("fp32", table), ("bf16", table.to(torch.bfloat16)), ("int8", t8)]
    variants = {"stream_select_pairwise": kernel_variants(sk, tables, q_dev, cand3, tile_idx, DIM,
                                                          True, rates)}
    del index, table, tables, t8, corpus_dev, main_inputs, cand3, tile_idx, q_dev, plan
    torch.cuda.empty_cache()

    # -- 7. int8 at full width (K1) ------------------------------------------
    t0 = time.perf_counter()
    sq = ScalarQuantizer()
    sq.fit(corpus[:QUANT_FIT])
    int8_index = InMemoryIndex(
        query_encoder=LambdaEncoder(by_text.__getitem__),
        quantizer=sq,
        mode=Mode.PASSAGE,
        precision="high",
        init_size=N,
    )
    add_in_chunks(int8_index, corpus, psg_ids)
    int8_rows = scalar_rows(int8_index._store[:N], sq.scales)
    log(f"[setup] int8 index of {N} rows built in {time.perf_counter() - t0:.1f} s")
    phase, launches["int8"] = quantized_phase(
        "int8", int8_index, ranking, run, int8_rows, qvecs_dev, q_index, wrappers,
        want="stream_select_pairwise", forbid=("stream_select",),
    )
    flows.update(phase)
    del int8_index, int8_rows

    # -- 8. int8 with dense tiles (K2) ----------------------------------------
    t0 = time.perf_counter()
    dense_corpus = corpus[:DENSE_N]
    drng = np.random.default_rng(SEED + 1)
    dense_run = {
        f"q{q}": {f"p{c}": float(DEPTH - i)
                  for i, c in enumerate(drng.choice(DENSE_N, size=DEPTH, replace=False))}
        for q in range(QUERIES)
    }
    dense_rank = Ranking.from_run(dense_run, queries=queries)
    dense_int8 = InMemoryIndex(
        query_encoder=LambdaEncoder(by_text.__getitem__),
        quantizer=sq,
        mode=Mode.PASSAGE,
        precision="high",
        init_size=DENSE_N,
    )
    add_in_chunks(dense_int8, dense_corpus, psg_ids)
    dense_int8_rows = scalar_rows(dense_int8._store[:DENSE_N], sq.scales)
    log(f"[setup] dense-tile run and int8 index of {DENSE_N} rows in "
        f"{time.perf_counter() - t0:.1f} s")
    phase, launches["int8_dense"] = quantized_phase(
        "int8_dense", dense_int8, dense_rank, dense_run, dense_int8_rows, qvecs_dev, q_index,
        wrappers, want="stream_select", forbid=("stream_select_pairwise",),
    )
    flows.update(phase)
    k2_plan = dense_int8._get_plan(dense_rank)
    k2_inputs = (dense_int8._device_view().table, k2_plan["q_dev"][1], *k2_plan["stream"][:2])
    del dense_int8_rows

    # -- 9. PQ at full width (K3) ----------------------------------------------
    t0 = time.perf_counter()
    check_fit(PQ, PQ_M, PQ_KS)
    log(f"[fit-check] in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pq = PQ(PQ_M, PQ_KS)
    pq.fit(corpus[:QUANT_FIT])
    fit_s = time.perf_counter() - t0
    pq_index = InMemoryIndex(
        query_encoder=LambdaEncoder(by_text.__getitem__),
        quantizer=pq,
        mode=Mode.PASSAGE,
        precision="exact",
        init_size=N,
    )
    add_in_chunks(pq_index, corpus, psg_ids)
    pq_ref = pq_rows(pq_index._store[:N], pq.codewords)
    log(f"[setup] PQ({PQ_M}, {PQ_KS}) fitted on the card in {fit_s:.1f} s; {N} rows encoded "
        f"in {time.perf_counter() - t0 - fit_s:.1f} s")
    check_encode("PQ", pq, pq_index._store[:N], corpus)
    phase, launches["pq"] = quantized_phase(
        "pq", pq_index, ranking, run, pq_ref, qvecs_dev, q_index, wrappers,
        want="stream_select_pq_pairwise", forbid=("stream_select_pq",),
    )
    flows.update(phase)
    view = pq_index._device_view()
    k3_plan = pq_index._get_plan(ranking)
    k3_inputs = (view.table, view.codebooks, k3_plan["q_dev"][1], *k3_plan["stream_pq"][:2])
    del pq_ref

    # -- 10. OPQ with dense tiles (K4) -----------------------------------------
    t0 = time.perf_counter()
    opq = OPQ(PQ_M, PQ_KS)
    opq.fit(dense_corpus[:QUANT_FIT])
    fit_s = time.perf_counter() - t0
    opq_index = InMemoryIndex(
        query_encoder=LambdaEncoder(by_text.__getitem__),
        quantizer=opq,
        mode=Mode.PASSAGE,
        precision="exact",
        init_size=DENSE_N,
    )
    add_in_chunks(opq_index, dense_corpus, psg_ids)
    opq_ref = pq_rows(opq_index._store[:DENSE_N], opq.codewords)
    # float64 (q @ R): the reference does not reuse the index's fp32 rotation
    rotated_dev = qvecs_dev.double() @ torch.from_numpy(opq.R).cuda().double()
    log(f"[setup] OPQ({PQ_M}, {PQ_KS}, {opq._opq_iters} iterations) fitted in {fit_s:.1f} s; "
        f"{DENSE_N} rows encoded in {time.perf_counter() - t0 - fit_s:.1f} s")
    check_encode("OPQ", opq, opq_index._store[:DENSE_N], dense_corpus)
    phase, launches["opq_dense"] = quantized_phase(
        "opq_dense", opq_index, dense_rank, dense_run, opq_ref, rotated_dev, q_index, wrappers,
        want="stream_select_pq", forbid=("stream_select_pq_pairwise",),
    )
    flows.update(phase)
    view = opq_index._device_view()
    k4_plan = opq_index._get_plan(dense_rank)
    k4_inputs = (view.table, view.codebooks, k4_plan["q_dev"][1], *k4_plan["stream_pq"][:2])
    del opq_ref

    # -- 11. K2, K3, K4 vs plain on the main path's layouts, timed ------------------
    log(f"[kernel-flagship] K2 on the int8 dense-tile layout {tuple(k2_inputs[2].shape)}, "
        f"K3 on the PQ layout {tuple(k3_inputs[3].shape)}, "
        f"K4 on the OPQ layout {tuple(k4_inputs[3].shape)}")
    variants["stream_select"] = select_variants(sk, *k2_inputs, DIM, ("high",), True, rates, "int8")
    variants["stream_select_pq_pairwise"] = pq_variants(skpq, "K3", *k3_inputs, ("exact",), True,
                                                        rates, "pq")
    variants["stream_select_pq"] = pq_variants(skpq, "K4", *k4_inputs, ("exact",), True, rates,
                                               "opq")
    small_by_kernel = {"stream_select": "K2", "stream_select_pq_pairwise": "K3",
                       "stream_select_pq": "K4"}
    vet_profiles(flows, variants)

    summary = []
    for kname, (source, replaces) in KERNELS.items():
        rows_k = variants[kname]
        main = rows_k[0]  # the main path's table and tier
        errs = [v["max_abs_err"] for v in rows_k]
        if kname in small_by_kernel:
            errs += [v["max_abs_err"] for v in small if v["variant"].startswith(small_by_kernel[kname])]
        summary.append({
            "name": kname,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": sum(counts[kname] for counts in launches.values()),
            "max_abs_err": max(errs),
            "tolerance": "8 * sqrt(dim) * 2^-24 * sum|terms| per slot",
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            # no single PyTorch call computes a per-slot gathered dot / ADC
            "library_ms": None,
            "launches_by_phase": {ph: counts[kname] for ph, counts in launches.items()},
            "variants": rows_k,
        })
    forbidden = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "fastforward_tpu."))
                 or m == "fastforward_tpu"]
    check(not forbidden, f"JAX or the JAX package was imported: {forbidden[:5]}")
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    log("flows:", json.dumps(flows))
    log(smi_line())
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
