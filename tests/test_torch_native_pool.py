"""The native worker pool of the host's per-pair passes (``runtime/idmap.cc``).

Above a grain of 2^15 items, the id resolve and its row fill, the id
numbering, the string gather, the streamed layout and the per-query sort
split their items over one pool of the process's CPUs.  These tests hold
each pass, at sizes above the grain, bit for bit against:

- the same pass in a forked child whose CPU affinity is cut to 1, 2 or 3
  CPUs (width 1 is the serial loop; a child's pool takes its own width);
- the pure-Python or numpy fallback where one exists: ``PyIdMap`` for the
  resolve, ``pd.Categorical`` for the numbering, arrow's ``take`` for the
  gather, ``build_streamed_layout``'s numpy branch, numpy's stable argsort.

They also hold the missing-id report (the first missing id, wherever the
parts split), the serial path below the grain, four Python threads calling
at once, and a pass in a forked child of a process whose pool is running.
The file runs on the CPU and imports neither JAX nor ``fastforward_tpu``.
"""

import multiprocessing
import os
import threading
import warnings

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

from fastforward_tpu_torch.index.mode import Mode
from fastforward_tpu_torch.ops import scoring
from fastforward_tpu_torch.runtime import idmap

GRAIN = 1 << 15
N_ROWS = 300_000
N_PAIRS = 262_144
CPUS = sorted(os.sched_getaffinity(0))
#: the pool widths a forked child is cut to, besides this process's own
WIDTHS = [w for w in (1, 2, 3) if w < len(CPUS)]

STRING_FORMS = {
    "string": pd.ArrowDtype(pa.string()),
    "large_string": pd.ArrowDtype(pa.large_string()),
}


def _psg_id(i: int) -> str:
    # every seventh id is longer than 8 bytes: the string map, not the u64 one
    return f"passage-{i}" if i % 7 == 0 else f"p{i}"


def _doc_id(j: int) -> str:
    return f"document-{j}" if j % 5 == 0 else f"d{j}"


@pytest.fixture(scope="module")
def maps():
    """A native and a Python id map over the same rows: one passage id a
    row, documents of 1-6 passages."""
    rng = np.random.default_rng(22)
    sizes = rng.integers(1, 7, N_ROWS)
    doc_of_row = np.repeat(np.arange(N_ROWS), sizes)[:N_ROWS]
    psg_ids = [_psg_id(i) for i in range(N_ROWS)]
    doc_ids = [_doc_id(j) for j in doc_of_row]
    native, python = idmap.create_idmap(), idmap.PyIdMap()
    assert isinstance(native, idmap.NativeIdMap), "the native library did not build"
    for m in (native, python):
        m.add(doc_ids, psg_ids, 0)
    return native, python, psg_ids, sorted(set(doc_ids))


def _at_width(width: int, fn):
    """``fn()`` in a forked child cut to ``width`` CPUs, and the child's
    ``pool_stats()`` after it; an exception's text instead of the result.
    Forked, not spawned: the child shares the parent's id map, and a fork
    of a process whose pool runs is itself under test."""
    ctx = multiprocessing.get_context("fork")
    recv, send = ctx.Pipe(duplex=False)

    def child():
        os.sched_setaffinity(0, CPUS[:width])
        try:
            out = fn()
        except Exception as e:  # reported to the parent
            out = f"{type(e).__name__}: {e}"
        send.send((out, idmap.pool_stats()))

    proc = ctx.Process(target=child)
    with warnings.catch_warnings():  # fork() of a process with threads
        warnings.simplefilter("ignore", DeprecationWarning)
        # a worker that ran the JAX tests first: the child touches no JAX
        warnings.filterwarnings("ignore", "os.fork", RuntimeWarning)
        proc.start()
    try:
        assert recv.poll(120), "the child gave no result"
        return recv.recv()
    finally:
        proc.join(60)
        assert proc.exitcode == 0


def _assert_same(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def _assert_every_width(fn, want):
    """``fn()`` gives ``want`` in this process (full width) and in a child at
    each of ``WIDTHS``, whose pool has that width."""
    _assert_same(fn(), want)
    for width in WIDTHS:
        got, stats = _at_width(width, fn)
        assert stats["width"] == width
        _assert_same(got, want)


def _pairs(ids: "list[str]", form: str, seed: int, n: int = N_PAIRS):
    rng = np.random.default_rng(seed)
    picked = [ids[i] for i in rng.integers(0, len(ids), n)]
    return picked, _id_column(picked, form)


def _id_column(picked: "list[str]", form: str):
    """The ids as an arrow string column, or (``fixed_width``) the list the
    map encodes into a fixed-width array."""
    if form == "fixed_width":
        return picked
    return pd.array(pa.array(picked), dtype=STRING_FORMS[form])


def _resolved(m, ids, mode):
    rows, counts = m.resolve(ids, mode)
    return rows.astype(np.int32), counts.astype(np.int32)


@pytest.mark.parametrize("form", ["string", "large_string", "fixed_width"])
@pytest.mark.parametrize("mode", [Mode.PASSAGE, Mode.MAXP, Mode.FIRSTP])
def test_resolve_every_width_against_python(maps, mode, form):
    native, python, psg_ids, doc_ids = maps
    picked, ids = _pairs(psg_ids if mode == Mode.PASSAGE else doc_ids, form, seed=1)
    want = _resolved(python, picked, mode)
    assert want[0].shape[0] >= N_PAIRS
    _assert_every_width(lambda: _resolved(native, ids, mode), want)


@pytest.mark.parametrize("form", ["string", "large_string", "fixed_width"])
@pytest.mark.parametrize("mode", [Mode.PASSAGE, Mode.MAXP, Mode.FIRSTP])
def test_resolve_names_the_first_missing_id(maps, mode, form):
    native, _, psg_ids, doc_ids = maps
    picked, _ = _pairs(psg_ids if mode == Mode.PASSAGE else doc_ids, form, seed=2)
    # one missing id in the middle part, one in the last, at every width
    picked[N_PAIRS // 2 + 7] = "missing-middle"
    picked[N_PAIRS - 3] = "missing-last"
    ids = _id_column(picked, form)

    def message():
        with pytest.raises(IndexError) as err:
            native.resolve(ids, mode)
        return str(err.value)

    _assert_every_width(message, "ID missing-middle not found in the index.")


def _numbering_rows(seed: int) -> np.ndarray:
    """Pair rows with repeats across the part borders of every width up to
    16, and a row at both ends."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, N_ROWS, N_PAIRS).astype(np.int32)
    for parts in range(2, 17):
        for k in range(1, parts):
            border = N_PAIRS * k // parts
            rows[border - 2 : border + 2] = rows[border - 1]
    rows[-1] = rows[0]
    return rows


def test_number_rows_every_width_against_categorical(maps):
    native, _, psg_ids, _ = maps
    rows = _numbering_rows(3)
    ranks = native.ranks(Mode.PASSAGE)
    cat = pd.Categorical(np.asarray(psg_ids, dtype=object)[rows])
    codes, first = idmap.number_rows(rows, ranks)
    np.testing.assert_array_equal(codes, cat.codes)
    # each code's first position: the least index that bears it
    _, least = np.unique(cat.codes, return_index=True)
    np.testing.assert_array_equal(first, least)
    np.testing.assert_array_equal(rows[first], rows[least])
    _assert_every_width(lambda: idmap.number_rows(rows, ranks), (codes, first))


def test_number_rows_unranked_row_at_every_width(maps):
    native, _, _, _ = maps
    rows = _numbering_rows(4)
    ranks = native.ranks(Mode.PASSAGE).copy()
    ranks[rows[N_PAIRS - 5]] = -1  # a row the ranks do not know, in the last part
    _assert_every_width(lambda: idmap.number_rows(rows, ranks) is None, True)


def _gather_case(form: str, seed: int):
    rng = np.random.default_rng(seed)
    n = N_PAIRS + 1000
    words = np.array(["", "a", "passage-", "p", "", "document-0000"], dtype=object)
    values = [w + (str(i) if w else "") for i, w in enumerate(words[rng.integers(0, 6, n)])]
    col = pd.array(pa.array(values), dtype=STRING_FORMS[form])
    positions = rng.permutation(n)[:N_PAIRS].astype(np.int64)
    return col, positions


def _gathered(col, positions):
    got = idmap.take_strings(col, positions)
    offsets, data = got.buffers()[1:]
    return np.frombuffer(offsets, dtype=np.uint8).copy(), np.frombuffer(data, dtype=np.uint8).copy()


@pytest.mark.parametrize("form", ["string", "large_string"])
def test_take_strings_every_width_against_arrow(form):
    col, positions = _gather_case(form, 5)
    want = col._pa_array.combine_chunks().take(pa.array(positions))
    got = idmap.take_strings(col, positions)
    assert got.equals(want)
    assert sum(1 for s in got.to_pylist() if s == "") > 1000
    _assert_every_width(lambda: _gathered(col, positions), _gathered(col, positions))


LAYOUT_CASES = {
    # (table rows, pair rows drawn below): every pair in one tile
    "one_tile": (1 << 14, 512),
    "many_tiles": (1 << 21, 1 << 21),
}


def _layout_case(case: str, seed: int):
    n_pad, spread = LAYOUT_CASES[case]
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, spread, N_PAIRS).astype(np.int64)
    qno = np.sort(rng.integers(0, 511, N_PAIRS)).astype(np.int64)
    cap = scoring._adaptive_cap(N_PAIRS, n_pad // 512)
    return rows, qno, n_pad, cap


@pytest.mark.parametrize("case", sorted(LAYOUT_CASES))
def test_streamed_layout_every_width_against_numpy(case, monkeypatch):
    rows, qno, n_pad, cap = _layout_case(case, 6)

    def native():
        return tuple(scoring.build_streamed_layout(rows, qno, n_pad, 512, r=512, cap=cap))

    got = native()
    with monkeypatch.context() as m:
        m.setattr(idmap, "native_stream_layout", lambda *a: None)
        want = tuple(scoring.build_streamed_layout(rows, qno, n_pad, 512, r=512, cap=cap))
    _assert_same(got, want)
    _assert_every_width(native, want)


def _sort_case(seed: int):
    """Scores with many ties, segments of 0-1,500 rows (every tenth
    empty), and the segments' output blocks in a shuffled order."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 1500, 400)
    sizes[::10] = 0
    seg_starts = np.zeros(sizes.shape[0] + 1, dtype=np.int64)
    np.cumsum(sizes, out=seg_starts[1:])
    scores = (rng.integers(0, 40, int(seg_starts[-1])) / 8 - 2.5).astype(np.float32)
    scores[scores == 0] = 0.125  # no signed zeros: numpy ranks -0.0 with 0.0
    order = rng.permutation(sizes.shape[0])
    out_starts = np.empty(sizes.shape[0], dtype=np.int64)
    out_starts[order] = np.concatenate([[0], np.cumsum(sizes[order])[:-1]])
    return scores, seg_starts, out_starts


def _sort_reference(scores, seg_starts, out_starts):
    want = np.empty(scores.shape[0], dtype=np.int64)
    for q in range(seg_starts.shape[0] - 1):
        lo, hi = seg_starts[q], seg_starts[q + 1]
        order = np.argsort(-scores[lo:hi], kind="stable")
        want[out_starts[q] : out_starts[q] + hi - lo] = lo + order
    return want


def _sort_in_chunks(scores, seg_starts, out_starts, chunks: int = 8):
    """The sort as ``_overlap_fetch_sort`` calls it: a run of segments at a
    time into one take buffer."""
    out = np.empty(scores.shape[0], dtype=np.int64)
    bounds = np.linspace(0, out_starts.shape[0], chunks + 1).astype(int)
    for q0, q1 in zip(bounds[:-1], bounds[1:]):
        assert idmap.segmented_rank_argsort_into(
            scores, seg_starts[q0 : q1 + 1], out_starts[q0:q1], out
        )
    return out


def test_segmented_sort_every_width_against_numpy():
    scores, seg_starts, out_starts = _sort_case(7)
    assert scores.shape[0] >= 200_000
    want = _sort_reference(scores, seg_starts, out_starts)
    np.testing.assert_array_equal(idmap.segmented_rank_argsort(scores, seg_starts, out_starts), want)
    _assert_every_width(lambda: idmap.segmented_rank_argsort(scores, seg_starts, out_starts), want)
    _assert_every_width(lambda: _sort_in_chunks(scores, seg_starts, out_starts), want)
    empty = np.zeros(0, dtype=np.int64)
    for starts in (empty, np.zeros(1, dtype=np.int64)):  # no segment bounds, or no segment
        got = idmap.segmented_rank_argsort(np.zeros(0, dtype=np.float32), starts, empty)
        assert got.shape == (0,)


def _stats_delta(before: dict, after: dict) -> "tuple[int, int]":
    return after["wide"] - before["wide"], after["serial"] - before["serial"]


def test_below_the_grain_runs_serially(maps):
    native, _, psg_ids, _ = maps
    for n, wide in ((GRAIN - 1, 0), (GRAIN, 1)):
        ids = pd.array(pa.array(psg_ids[:n]), dtype=STRING_FORMS["string"])
        before = idmap.pool_stats()
        rows, _ = native.resolve(ids, Mode.PASSAGE)
        np.testing.assert_array_equal(rows, np.arange(n))
        # the resolve and its fill: two passes
        want = (2, 0) if wide and before["width"] > 1 else (0, 2)
        assert _stats_delta(before, idmap.pool_stats()) == want


def test_four_threads_at_once(maps):
    native, _, psg_ids, _ = maps
    _, ids = _pairs(psg_ids, "large_string", seed=8)
    rows = _numbering_rows(9)
    ranks = native.ranks(Mode.PASSAGE)
    layout = _layout_case("many_tiles", 10)
    scores, seg_starts, out_starts = _sort_case(11)

    def passes():
        return (
            _resolved(native, ids, Mode.PASSAGE),  # two passes
            idmap.number_rows(rows, ranks),  # one
            tuple(scoring.build_streamed_layout(*layout[:3], 512, r=512, cap=layout[3])),  # two
            idmap.segmented_rank_argsort(scores, seg_starts, out_starts),  # one
        )

    want = passes()
    rounds, results, errors = 5, [], []
    start = threading.Barrier(4)

    def client():
        try:
            start.wait()
            for _ in range(rounds):
                results.append(passes())
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)

    before = idmap.pool_stats()
    threads = [threading.Thread(target=client) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
        assert not t.is_alive()
    assert not errors and len(results) == 4 * rounds
    for got in results:
        _assert_same(got, want)
    wide, serial = _stats_delta(before, idmap.pool_stats())
    assert wide + serial == 4 * rounds * 6
    if before["width"] > 1:
        assert wide >= 1


def test_forked_child_runs_a_pass(maps):
    native, _, psg_ids, _ = maps
    _, ids = _pairs(psg_ids, "string", seed=12)
    want = _resolved(native, ids, Mode.PASSAGE)  # the parent's pool is running
    parent = idmap.pool_stats()

    def child():
        before = idmap.pool_stats()
        got = _resolved(native, ids, Mode.PASSAGE)
        return got, _stats_delta(before, idmap.pool_stats())

    (got, delta), stats = _at_width(len(CPUS), child)
    _assert_same(got, want)
    assert stats["width"] == parent["width"]
    assert delta == ((2, 0) if parent["width"] > 1 else (0, 2))
