"""The closed loop: one client calls ``index(ranking)`` on pooled frames, one
after another, each call on a frame the index has not seen in its last
``pool - 1`` calls, its result on the host before the next call starts.

The mix's numbers: ``queries_per_call`` queries of ``query_words`` words
with ``depth`` distinct candidates each, ``pool`` frames in turn,
``warm_calls`` calls of set-up on the last frames, ``trace_calls`` traced
calls after the window, ``check_queries`` queries the check compares.
"""

import gc
import math
import time
import traceback

import numpy as np
import pandas as pd

from bench_port import check, data, harness, roofline

#: results the loop keeps for the check (a reservoir over its calls)
KEPT_RESULTS = 8


def pools(cell, seed: int) -> list:
    """``pool`` pools of distinct queries, one stream each."""
    config, traffic = cell.config, cell.traffic
    return [data.queries(seed, k, traffic["queries_per_call"], tuple(traffic["query_words"]),
                         config["tower"]["vocab_size"], data.n_targets(config), traffic["depth"])
            for k in range(traffic["pool"])]


def ranking_of(pool: data.Queries, config: dict, depth: int):
    """The ranking of a pool: lexical scores ``depth`` down to 1 in
    candidate order, queries attached; the string columns are built as
    arrow arrays, as a reader of a TREC run file gives them."""
    import pyarrow as pa
    import pyarrow.compute as pc

    from fastforward_tpu_torch import Ranking

    n = len(pool.q_ids)
    rep = pa.array(np.repeat(np.arange(n), depth))
    ids = pc.binary_join_element_wise(
        data.id_prefix(config), pc.cast(pa.array(pool.candidates.ravel()), pa.string()), "")
    text = pd.StringDtype("pyarrow", na_value=np.nan)
    frame = pd.DataFrame({
        "q_id": pd.array(pa.array(pool.q_ids).take(rep), dtype=text),
        "id": pd.array(ids, dtype=text),
        "score": np.tile(np.arange(depth, 0, -1, dtype=np.float32), n),
        "query": pd.array(pa.array(pool.texts).take(rep), dtype=text),
    })
    return Ranking(frame, copy=False)


class Reservoir:
    """A uniform sample of ``size`` items of a stream, drawn from the seed."""

    def __init__(self, size: int, rng: np.random.Generator) -> None:
        self.size, self.rng, self.items, self.seen = size, rng, [], 0

    def offer(self, item) -> None:
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.items[j] = item
        self.seen += 1


def closed_loop(index, rankings: list, seconds: float, start: int, keep: "Reservoir | None"):
    """Calls ``index(ranking)`` one after another over the pool from
    ``start`` until ``seconds`` have passed; the window ends with the call
    that crosses that mark.  Returns each call's wall time, the window's
    length, the queries completed, the failures, and the last result."""
    call_s, failed, last, done = [], 0, None, 0
    t_start = time.perf_counter()
    t_end = t_start + seconds
    i = start
    while True:
        r = i % len(rankings)
        t0 = time.perf_counter()
        try:
            out = index(rankings[r][0])
            ok = True
        except Exception:  # noqa: BLE001 - a failed call is counted, the run goes on
            failed += 1
            ok = False
            if failed == 1:
                traceback.print_exc()
        t1 = time.perf_counter()
        call_s.append(t1 - t0)
        if ok:
            done += len(rankings[r][1])
            last = (i, r, out)
            if keep is not None:
                keep.offer(last)
        i += 1
        if t1 >= t_end:
            break
    return call_s, t1 - t_start, done, failed, last


def _calls(index, rankings: list, start: int, n: int) -> None:
    """``n`` calls, one a pooled ranking from ``start`` on, outside any window."""
    for j in range(n):
        closed_loop(index, rankings, 0.0, start + j, None)


def _work_of(pool: data.Queries, config: dict, docs) -> dict:
    """:func:`roofline.scoring_work` of one pooled ranking, from its candidates."""
    cand = pool.candidates
    if docs is None:
        rows, scored = np.unique(cand).size, cand.size
    else:
        rows = docs.counts[np.unique(cand)].sum()
        scored = int(docs.counts[cand].sum())
    return roofline.scoring_work(int(rows), int(scored), cand.shape[0], cand.size, config["dim"])


def measure(run, index, pools: list, seconds: float, traced: bool, t_process: float,
            rng: np.random.Generator, encoder) -> list:
    """Set-up's last part (the frames, the warm-up), the window and the
    traced calls; fills ``run`` and returns the kept results."""
    config, traffic = run.cell.config, run.cell.traffic
    depth = traffic["depth"]
    mark = time.perf_counter()
    rankings = [(ranking_of(p, config, depth), p.q_ids) for p in pools]
    harness.log(f"[setup] {len(rankings)} pooled rankings {time.perf_counter() - mark:.2f} s; "
                f"{time.perf_counter() - t_process:.2f} s since the process started")

    # least time of a call: the encoder's operations at the peak and the
    # scoring's bytes or operations, from the cell's own rankings
    docs = data.corpus_layout(run.seed, config)
    works = [_work_of(p, config, docs) for p in pools]
    run.call_bound_s = (encoder.least_s(config, traffic["queries_per_call"])
                        + float(np.mean([roofline.scoring_bound_s(w) for w in works])))

    # warm the cell's one shape on the last pooled frames; the window then
    # starts at the first, so no frame repeats within the program's plan cache
    warm = traffic["warm_calls"]
    _calls(index, rankings[-warm:], 0, warm)
    harness.sync()
    gc.collect()  # set-up's garbage goes with set-up
    harness.log(f"[setup] warm-up done {time.perf_counter() - t_process:.2f} s since the process started")
    run.setup_s = time.perf_counter() - t_process
    keep = Reservoir(KEPT_RESULTS, rng)
    with harness.gc_pauses("window"):
        run.call_s, run.window_s, run.queries_done, run.failed, last = closed_loop(
            index, rankings, seconds, 0, keep)
    kept = list(keep.items)
    if last is not None and all(k[0] != last[0] for k in kept):
        kept.append(last)
    run.attempted = len(run.call_s)
    harness.log_calls(run.call_s)
    if traced:
        n = traffic["trace_calls"]
        start = len(run.call_s)
        run.profile = harness.profiled(lambda: _calls(index, rankings, start, n))
        run.traced_calls = n
        run.traced_scoring_bound_s = sum(
            roofline.scoring_bound_s(works[(start + j) % len(works)]) for j in range(n))
    return kept


def answers(kept: list, pools: list, traffic: dict, rng: np.random.Generator) -> list:
    """A sample of the queries of the kept calls' results."""
    n_check = traffic["check_queries"]
    per = math.ceil(n_check / max(1, len(kept)))
    out = []
    for _call, r, result in kept:
        pool = pools[r]
        for qi in np.sort(rng.choice(len(pool.q_ids), size=min(per, len(pool.q_ids)), replace=False)):
            out.append(check.answer(pool, int(qi), result))
    return out
