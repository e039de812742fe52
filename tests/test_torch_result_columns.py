"""A new plan's result columns (``index/base.py`` ``_result_columns``).

A re-rank call on a frame the index has no ready plan for builds the
result's categorical ``q_id``, ``id`` and ``query`` columns from the
numbering the call already has: the query numbers of ``ff.frame``, and the
table rows (``Mode.PASSAGE``, ``Mode.FIRSTP``; numbered natively by
``runtime.idmap.number_rows``) or the ids' factorize (grouped ``Mode.MAXP``,
``Mode.AVEP``) of ``ff.resolve``; the id map's byte-order ranks of the rows
(``NativeIdMap.ranks``) sort ``id``'s categories as ``pd.Categorical``
does.  These tests hold:

- the native numbering against numpy's ``unique`` in first-appearance
  order, the ranks against Python's sort of the encoded ids, and the
  wrappers without the library;
- every mode's result through ``__call__``, ``submit`` and early stopping,
  on a new plan and a ready one, and the re-rank of such a result (whose
  columns are categorical already), against the same calls with the
  columns built by ``pd.Categorical``: every value, the row order, and the
  three columns' dtypes, categories and codes exactly; the route that
  numbered ``id`` (a spy on ``_result_columns`` and
  ``_sorted_id_categorical``);
- that nothing downstream depends on the order of ``id``'s categories.

The file runs on the CPU and imports neither JAX nor ``fastforward_tpu``.
"""

import numpy as np
import pandas as pd
import pytest

from fastforward_tpu_torch.encoder import LambdaEncoder
from fastforward_tpu_torch.index import InMemoryIndex, Mode, base
from fastforward_tpu_torch.ranking import Ranking
from fastforward_tpu_torch.runtime import idmap
from fastforward_tpu_torch.utils.serving import _concat_col

ALL_MODES = (Mode.PASSAGE, Mode.FIRSTP, Mode.MAXP, Mode.AVEP)


def _numbering_reference(rows: np.ndarray, ranks: np.ndarray) -> "tuple[np.ndarray, np.ndarray]":
    """numpy's ``unique`` of the rows' ranks: each row's place among the
    distinct ranks, and each place's first position."""
    _, first, inverse = np.unique(ranks[rows], return_index=True, return_inverse=True)
    return inverse.reshape(-1), first


NUMBERING_CASES = {
    "empty": lambda rng: np.empty(0, dtype=np.int32),
    "one_row": lambda rng: np.array([8_841_822], dtype=np.int32),
    "all_equal": lambda rng: np.full(1000, 17, dtype=np.int32),
    "all_distinct": lambda rng: rng.permutation(100_000).astype(np.int32),
    "random_512k": lambda rng: rng.integers(0, 8_841_823, 512_000).astype(np.int32),
    "random_512k_repeats": lambda rng: rng.integers(0, 50_000, 512_000).astype(np.int32),
}


@pytest.mark.parametrize("case", sorted(NUMBERING_CASES))
def test_native_numbering_matches_numpy(case):
    rng = np.random.default_rng(3)
    rows = NUMBERING_CASES[case](rng)
    # a table of 8,841,823 rows whose ids' ranks are shuffled
    ranks = rng.permutation(8_841_823).astype(np.int32)
    numbered = idmap.number_rows(rows, ranks)
    assert numbered is not None, "the native library did not build"
    codes, first = numbered
    want_codes, want_first = _numbering_reference(rows, ranks)
    assert codes.dtype == np.int32 and first.dtype == np.int64
    np.testing.assert_array_equal(codes, want_codes)
    np.testing.assert_array_equal(first, want_first)


def test_numbering_is_none_where_a_row_has_no_rank():
    ranks = np.array([2, -1, 0, 1], dtype=np.int32)
    assert idmap.number_rows(np.array([0, 2, 3], dtype=np.int32), ranks) is not None
    assert idmap.number_rows(np.array([0, 1], dtype=np.int32), ranks) is None
    assert idmap.number_rows(np.array([0, 4], dtype=np.int32), ranks) is None


@pytest.mark.parametrize("large", [False, True], ids=["string", "large_string"])
def test_take_strings_matches_arrow(large):
    pa = pytest.importorskip("pyarrow")
    rng = np.random.default_rng(4)
    ids = _mixed_ids(rng, 5000) + [""]
    kind = pa.large_string() if large else pa.string()
    # an offset view, in either offset width
    col = pd.array(pa.array(ids, type=kind).slice(7), dtype=pd.ArrowDtype(kind))
    positions = rng.permutation(len(ids) - 7)[:3000]
    got = idmap.take_strings(col, positions)
    assert got.type == kind
    assert got.equals(pa.array(ids, type=kind).slice(7).take(pa.array(positions)))
    assert idmap.take_strings(pd.array(ids, dtype=object), positions) is None


def test_numbering_is_none_without_the_library(monkeypatch):
    monkeypatch.setattr(idmap, "_get_lib", lambda: None)
    assert idmap.number_rows(np.arange(5, dtype=np.int32), np.arange(5, dtype=np.int32)) is None
    assert idmap.create_idmap().ranks(Mode.PASSAGE) is None
    assert idmap.take_strings(pd.array(["a", "b"], dtype="str"), np.arange(2)) is None


def _ranks_reference(ids_by_row: list, n_rows: int) -> np.ndarray:
    """Each row's rank among the distinct ids in the order of their UTF-8
    bytes (Python's sort of the encoded strings), -1 without an id."""
    distinct = sorted({i.encode() for i in ids_by_row if i})
    rank = {i: r for r, i in enumerate(distinct)}
    out = np.full(n_rows, -1, dtype=np.int32)
    for row, i in enumerate(ids_by_row):
        if i:
            out[row] = rank[i.encode()]
    return out


def _mixed_ids(rng, n: int) -> list:
    """Ids of 1-30 bytes: decimal strings, long ones that share their first
    8 bytes, non-ASCII, and an embedded NUL."""
    ids = [str(i) for i in rng.permutation(n)]
    ids += [f"clueweb12-{i:04d}" for i in rng.permutation(40)]
    ids += ["é1", "e", "abÿz", "a" * 20, "a" * 19 + "b", "a\x00b", "a", "Z", "~", "日本"]
    return [ids[i] for i in rng.permutation(len(ids))]


RANK_CASES = {
    "psg_add": Mode.PASSAGE,
    "psg_two_adds": Mode.PASSAGE,
    "psg_bulk_load_repeats": Mode.PASSAGE,
    "psg_rows_without_ids": Mode.PASSAGE,
    "doc_add": Mode.MAXP,
    "doc_firstp": Mode.FIRSTP,
    "doc_bulk_load": Mode.AVEP,
    "empty": Mode.PASSAGE,
}


@pytest.mark.parametrize("case", sorted(RANK_CASES))
def test_id_ranks_match_sorted_ids(case):
    rng = np.random.default_rng(11)
    mode = RANK_CASES[case]
    m = idmap.create_idmap()
    assert isinstance(m, idmap.NativeIdMap), "the native library did not build"
    ids = _mixed_ids(rng, 3000)
    if case == "empty":
        by_row = []
    elif case == "psg_add":
        m.add(None, ids, 0)
        by_row = ids
    elif case == "psg_two_adds":
        m.add(None, ids[:1000], 0)
        assert m.ranks(mode).shape == (1000,)  # kept until the next add
        m.add(None, ids[1000:], 1000)
        by_row = ids
    elif case == "psg_bulk_load_repeats":
        # a repeated passage id keeps its last row
        by_row = ids + ids[:50]
        m.bulk_load(None, np.array([i.encode() for i in by_row], dtype="S"))
        by_row = [None] * 50 + by_row[50:]
    elif case == "psg_rows_without_ids":
        by_row = [i if r % 3 else None for r, i in enumerate(ids)]
        m.add(None, by_row, 0)
    else:
        docs = [ids[d] for d in rng.integers(0, 900, 3000)]
        if case == "doc_bulk_load":
            m.bulk_load(np.array([d.encode() for d in docs], dtype="S"), None)
        else:
            m.add(docs[:1700], None, 0)
            m.add(docs[1700:], None, 1700)
        by_row = docs
    got = m.ranks(mode)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, _ranks_reference(by_row, len(by_row)))
    assert m.ranks(mode) is got


def _build(mode: Mode, seed: int = 0):
    """A CPU index in ``mode`` and a ranking of 6 queries x 40 candidates
    drawn from a shared pool (ids repeat across queries, and appear first
    out of lexicographic order); two queries share one text."""
    rng = np.random.default_rng(seed)
    n, dim = 1024, 16
    corpus = rng.standard_normal((n, dim)).astype(np.float32)
    qvecs = rng.standard_normal((5, dim)).astype(np.float32)
    by_text = {f"query {i}": qvecs[i] for i in range(5)}
    index = InMemoryIndex(
        LambdaEncoder(lambda t: by_text[t]), mode=mode, device="cpu"
    )
    if mode == Mode.PASSAGE:
        index.add(corpus, psg_ids=[f"p{i}" for i in range(n)])
        pool = [f"p{i}" for i in rng.choice(n, 120, replace=False)]
    else:
        # documents of 1-4 passages
        doc_of_row = np.repeat(np.arange(n), rng.integers(1, 5, n))[:n]
        index.add(corpus, doc_ids=[f"d{d}" for d in doc_of_row])
        docs = np.unique(doc_of_row)
        pool = [f"d{d}" for d in rng.choice(docs, 120, replace=False)]
    run = {
        f"q{i}": {c: float(40 - r) for r, c in enumerate(rng.choice(pool, 40, replace=False))}
        for i in range(6)
    }
    queries = {f"q{i}": f"query {min(i, 4)}" for i in range(6)}
    return index, Ranking.from_run(run, queries=queries)


def _categorical_columns(df, *_numbering):
    """The columns as the port built them before: ``pd.Categorical``."""
    return pd.Categorical(df["q_id"]), pd.Categorical(df["id"]), pd.Categorical(df["query"])


def _run(index, ranking, path: str):
    if path == "call":
        return index(ranking)
    if path == "submit":
        return index.submit(ranking).result()
    return index(
        ranking, early_stopping=5, early_stopping_alpha=0.5, early_stopping_depths=(10, 40)
    )


def _spy_routes(m) -> list:
    """The route of each result-column build, recorded through ``m`` (a
    monkeypatch): ``rows`` (each pair's table row, numbered natively),
    ``factorize`` (the grouped modes' factorize from ``ff.resolve``,
    reused) or ``fallback`` (``pd.Categorical`` of the column: no
    numbering, no native library, or an ``id`` column that is categorical
    already)."""
    routes = []
    sorted_id, columns = base._sorted_id_categorical, base._result_columns

    def spy_sorted_id(id_col, numbering, ranks):
        built = sorted_id(id_col, numbering, ranks)
        by_rows = isinstance(numbering, np.ndarray)
        routes.append("fallback" if built is None else "rows" if by_rows else "factorize")
        return built

    def spy_columns(df, *args):
        before = len(routes)
        out = columns(df, *args)
        if len(routes) == before:  # no numbering to build ``id`` from
            routes.append("fallback")
        return out

    m.setattr(base, "_sorted_id_categorical", spy_sorted_id)
    m.setattr(base, "_result_columns", spy_columns)
    return routes


def _assert_same_result(new: Ranking, ref: Ranking) -> None:
    a, b = new._df, ref._df
    assert list(a.columns) == list(b.columns)
    for col in a.columns:
        np.testing.assert_array_equal(
            a[col].to_numpy(dtype=object), b[col].to_numpy(dtype=object), err_msg=col
        )
    for col in ("q_id", "id", "query"):
        assert isinstance(a[col].dtype, pd.CategoricalDtype), col
        assert isinstance(b[col].dtype, pd.CategoricalDtype), col
        assert a[col].cat.categories.dtype == b[col].cat.categories.dtype, col
        assert a[col].cat.codes.dtype == b[col].cat.codes.dtype, col
        assert a[col].cat.ordered == b[col].cat.ordered, col
        pd.testing.assert_index_equal(a[col].cat.categories, b[col].cat.categories, exact=True)
        np.testing.assert_array_equal(a[col].cat.codes, b[col].cat.codes)
    assert new.q_ids == ref.q_ids


@pytest.mark.parametrize("path", ["call", "submit", "early_stopping"])
@pytest.mark.parametrize("mode", ALL_MODES, ids=lambda m: m.name)
def test_columns_equal_pd_categorical(mode, path, monkeypatch):
    index, ranking = _build(mode)
    ref_index, ref_ranking = _build(mode)
    results, refs = [], []
    with monkeypatch.context() as m:
        routes = _spy_routes(m)
        for _ in range(3):  # a new plan, then a ready (or hot) one, twice
            results.append(_run(index, ranking, path))
    with monkeypatch.context() as m:
        m.setattr(base, "_result_columns", _categorical_columns)
        for _ in range(3):
            refs.append(_run(ref_index, ref_ranking, path))

    plan = index._plans[(id(ranking._df), mode)]
    if path == "early_stopping":
        # the first call takes the frame's own arrays; the hot calls build
        # the categoricals once
        checked = zip(results[1:], refs[1:])
        lazy = plan["es_state"]["lazy_rows"]
        if lazy is None:
            route = "factorize"
        else:
            route = "rows" if (lazy >= 0).all() else "fallback"
    else:
        assert plan.get("ready")
        checked = zip(results, refs)
        route = "rows" if mode in (Mode.PASSAGE, Mode.FIRSTP) else "factorize"
    for new, ref in checked:
        _assert_same_result(new, ref)
    assert routes == [route]


@pytest.mark.parametrize("cut", [None, 7], ids=["whole", "cut"])
@pytest.mark.parametrize("path", ["call", "submit", "early_stopping"])
@pytest.mark.parametrize("mode", ALL_MODES, ids=lambda m: m.name)
def test_rerank_a_result(mode, path, cut, monkeypatch):
    """A result re-ranked, whole or cut (its ``q_id``, ``id`` and ``query``
    categorical already; a cut keeps categories no row holds), gives the
    columns of ``pd.Categorical``, new plan and hot."""
    index, ranking = _build(mode)
    ref_index, ref_ranking = _build(mode)

    def again(result):
        return result if cut is None else result.cut(cut)

    first = _run(index, ranking, "call")
    results = [_run(index, again(first), path) for _ in range(3)]
    with monkeypatch.context() as m:
        m.setattr(base, "_result_columns", _categorical_columns)
        ref_first = _run(ref_index, ref_ranking, "call")
        refs = [_run(ref_index, again(ref_first), path) for _ in range(3)]
    _assert_same_result(first, ref_first)
    assert isinstance(first._df["id"].dtype, pd.CategoricalDtype)
    for new, ref in zip(results, refs):
        _assert_same_result(new, ref)


def test_fallback_route_without_the_library(monkeypatch):
    """Without the native library the ids take ``pd.Categorical``: the same
    columns, through the fallback route."""
    index, ranking = _build(Mode.PASSAGE)
    ref_index, ref_ranking = _build(Mode.PASSAGE)
    with monkeypatch.context() as m:
        m.setattr(idmap, "_get_lib", lambda: None)
        routes = _spy_routes(m)
        new = index(ranking)
        assert routes == ["fallback"]
    with monkeypatch.context() as m:
        m.setattr(base, "_result_columns", _categorical_columns)
        ref = ref_index(ref_ranking)
    _assert_same_result(new, ref)


def _frame(q_no, q_ids, queries, ids, dtype) -> pd.DataFrame:
    return pd.DataFrame(
        {
            "q_id": pd.array(q_ids, dtype=dtype),
            "id": pd.array(ids, dtype=dtype),
            "score": np.arange(len(ids), dtype=np.float32),
            "query": pd.array(queries, dtype=dtype),
            "q_no": np.asarray(q_no, dtype=np.intp),
        }
    )


FRAMES = {
    # a query column that is not constant on one query's rows
    "query_varies": lambda d: _frame(
        [0, 0, 1, 1], ["b", "b", "a", "a"], ["x", "y", "z", "z"], ["p2", "p1", "p1", "p3"], d
    ),
    # a query's rows in two runs
    "queries_not_contiguous": lambda d: _frame(
        [0, 1, 0], ["b", "a", "b"], ["x", "y", "x"], ["p2", "p1", "p3"], d
    ),
    "empty": lambda d: _frame([], [], [], [], d),
    "contiguous": lambda d: _frame(
        [0, 0, 1, 2, 2], ["c", "c", "a", "b", "b"], ["y", "y", "x", "y", "y"],
        ["p9", "p10", "p9", "p2", "p10"], d,
    ),
}


def _numbering(df: pd.DataFrame, kind: str):
    """A numbering of ``df``'s ids as ``ff.resolve`` gives it, over a table
    whose rows hold the ids in shuffled order, and that table's ranks."""
    ids = sorted(set(df["id"].astype(str)))
    perm = np.random.default_rng(5).permutation(len(ids))
    rows_of = {i: int(perm[k]) for k, i in enumerate(ids)}
    ranks = np.full(len(ids), -1, dtype=np.int32)
    for rank, i in enumerate(sorted(ids, key=str.encode)):
        ranks[rows_of[i]] = rank
    if kind == "none":
        return None, None
    if kind == "rows":
        return np.array([rows_of[i] for i in df["id"].astype(str)], dtype=np.int32), ranks
    codes, uniques = pd.factorize(df["id"], sort=False)
    return (codes, uniques, np.array([rows_of[str(i)] for i in uniques], dtype=np.int32)), ranks


DTYPES = {
    "str": lambda: "str",
    "object": lambda: "object",
    "category": lambda: "category",
    # categories in reverse order, with some no row holds
    "category_unsorted": lambda: pd.CategoricalDtype(
        ["zz", "z", "y", "x", "p9", "p3", "p2", "p10", "p1", "c", "b", "a", "0"]
    ),
    "string_pyarrow": lambda: "string[pyarrow]",
    "arrow_string": lambda: pd.ArrowDtype(pytest.importorskip("pyarrow").string()),
}


@pytest.mark.parametrize("numbering", ["none", "rows", "factorize"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", sorted(FRAMES))
def test_result_columns_of_any_frame(shape, dtype, numbering):
    """Every frame shape, string storage and numbering of the ids: the
    columns of ``pd.Categorical``, categories and codes exactly."""
    df = FRAMES[shape](DTYPES[dtype]())
    got = base._result_columns(df, *_numbering(df, numbering))
    for col, new in zip(("q_id", "id", "query"), got):
        ref = pd.Categorical(df[col])
        np.testing.assert_array_equal(np.asarray(new, dtype=object), np.asarray(ref, dtype=object))
        assert new.codes.dtype == ref.codes.dtype
        pd.testing.assert_index_equal(new.categories, ref.categories, exact=True)
        np.testing.assert_array_equal(new.codes, ref.codes)


# -- nothing depends on the order of id's categories ---------------------------


@pytest.fixture(scope="module")
def scored():
    """A PASSAGE result (sorted ``id`` categories, as ``pd.Categorical``
    builds them), the same frame with ``id``'s categories in first-appearance
    order (as a frame of the caller's may hold them), and a second result
    over another frame."""
    index, ranking = _build(Mode.PASSAGE, seed=1)
    new = index(ranking)
    ids = new._df["id"]
    assert ids.cat.categories.is_monotonic_increasing
    unsorted = new._df.assign(id=ids.cat.set_categories(pd.unique(ranking._df["id"])))
    assert not unsorted["id"].cat.categories.is_monotonic_increasing
    old = Ranking._from_trusted_frame(unsorted, new.name)
    other_index, other_ranking = _build(Mode.PASSAGE, seed=2)
    return new, old, other_index(other_ranking)


def _rows(df: pd.DataFrame) -> list:
    return [tuple(r) for r in df.astype(object).itertuples(index=False)]


def _extra(r: Ranking) -> Ranking:
    """A ranking with some of ``r``'s pairs and pairs ``r`` lacks."""
    q = sorted(r.q_ids)
    run = {q[0]: {"x1": 3.0, "x2": 2.0, str(r._df["id"].iloc[-1]): 1.0}, "qx": {"x3": 1.0}}
    return Ranking.from_run(run)


def _saved(r: Ranking, tmp_path) -> str:
    target = tmp_path / f"{id(r)}.tsv"
    r.save(target)
    return target.read_text()


ORDER_CASES = {
    "constructor": lambda r, other, tmp: _rows(Ranking(r._df.copy())._df),
    "equals_plain": lambda r, other, tmp: r
    == Ranking(r._df.astype({c: object for c in ("q_id", "id", "query")})),
    "scaled_sum": lambda r, other, tmp: _rows((0.1 * r + _extra(r))._df),
    "interpolate": lambda r, other, tmp: _rows(r.interpolate(_extra(r), 0.3)._df),
    "cut": lambda r, other, tmp: _rows(r.cut(3)._df),
    "rr_scores": lambda r, other, tmp: _rows(r.rr_scores()._df),
    "save": lambda r, other, tmp: _saved(r, tmp),
    "getitem": lambda r, other, tmp: {q: r[q] for q in sorted(r.q_ids)},
    "concat": lambda r, other, tmp: list(_concat_col([r._df["id"], other._df["id"]])),
}


@pytest.mark.parametrize("case", sorted(ORDER_CASES))
def test_nothing_depends_on_id_category_order(case, scored, tmp_path):
    new, old, other = scored
    got = ORDER_CASES[case](new, other, tmp_path)
    want = ORDER_CASES[case](old, other, tmp_path)
    assert got == want
    if case == "equals_plain":
        assert got is True
