"""Host-side ranking data model (TREC runs, scores, interpolation).

This layer is deliberately host-resident: it is I/O and bookkeeping, not
compute (see SURVEY.md §7).  The semantics mirror the reference
``fast_forward.ranking`` (reference: ``ranking.py:64-409``): a ranking is a
table of ``(q_id, id, score[, query])`` rows, sorted by ``(q_id, score)``
descending, with algebra (``+``, ``*``, ``interpolate``, ``rr_scores``,
``normalize``, ``cut``) and TREC runfile I/O.  Batched score math that is hot
at scale (interpolation during re-ranking) additionally runs on device inside
the scoring program, see ``fastforward_tpu_torch.ops``.
"""

import logging
from collections.abc import Iterator, Mapping
from pathlib import Path

import numpy as np
import pandas as pd

LOGGER = logging.getLogger(__name__)

#: A TREC-style run: query IDs mapped to (doc/passage ID -> score) mappings.
Run = Mapping[str, Mapping[str, float]]

_CORE_COLS = ["q_id", "id", "score"]


def _coerce(df: pd.DataFrame, score_dtype: np.dtype) -> pd.DataFrame:
    """Coerce column dtypes in place: string IDs, ``score_dtype`` scores."""
    if df["score"].dtype != score_dtype:
        df["score"] = df["score"].astype(score_dtype)
    for col in ("q_id", "id"):
        if df[col].dtype != str:
            df[col] = df[col].astype(str)
    return df


def _run_positions(q_col: pd.Series) -> "np.ndarray | None":
    """0-based position of each row within its query's contiguous run.

    Ranking frames are (q_id, score)-sorted, so each query's rows form ONE
    run; its per-row positions come from one vectorized pass instead of
    pandas groupby machinery (the scoring fast path emits 512k-row
    categorical frames — ``groupby.cumcount``/``head`` there costs ~100 ms
    per call, this ~2 ms).  Returns ``None`` when some q_id's rows are NOT
    contiguous (never produced by this package; caller-built frames fall
    back to the groupby).
    """
    if isinstance(q_col.dtype, pd.CategoricalDtype):
        codes = q_col.cat.codes.to_numpy()
    else:
        codes = pd.factorize(q_col, use_na_sentinel=False)[0]
    n = codes.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    change = np.empty(n, dtype=bool)
    change[0] = True
    np.not_equal(codes[1:], codes[:-1], out=change[1:])
    if int(change.sum()) != len(pd.unique(codes)):
        return None
    idx = np.arange(n, dtype=np.int64)
    run_start = np.maximum.accumulate(np.where(change, idx, 0))
    return idx - run_start


def _ranks_within_query(df: pd.DataFrame) -> np.ndarray:
    """Per-query 1-based ranks for an already score-sorted frame."""
    pos = _run_positions(df["q_id"])
    if pos is not None:
        return pos + 1
    return (
        df.groupby("q_id", sort=False, observed=True).cumcount().to_numpy() + 1
    )


def _plain_ids(df: pd.DataFrame) -> pd.DataFrame:
    """Return ``df`` with categorical columns decoded to plain arrays.

    The scoring fast path emits categorical ``q_id``/``id``/``query`` columns
    (reordering on integer codes is ~50x cheaper than on string arrays); the
    merge-then-``fillna(0)`` algebra would raise on those whenever the other
    ranking holds a pair this one lacks ("Cannot setitem on a Categorical
    with a new category"), so algebra decodes them first.
    """
    cat = [
        c for c in df.columns if isinstance(df[c].dtype, pd.CategoricalDtype)
    ]
    if not cat:
        return df
    return df.assign(
        **{c: df[c].astype(df[c].cat.categories.dtype) for c in cat}
    )


def _normalized(df: pd.DataFrame) -> pd.DataFrame:
    """Copy of ``df`` with min-max normalized scores (all-equal -> 0)."""
    out = df.copy()
    lo, hi = out["score"].min(), out["score"].max()
    if lo == hi:
        LOGGER.warning("all scores are equal, setting scores to 0")
        out["score"] = 0
    else:
        out["score"] = (out["score"] - lo) / (hi - lo)
    return out


class Ranking:
    """Rankings of documents/passages w.r.t. queries."""

    def __init__(
        self,
        df: pd.DataFrame,
        name: str | None = None,
        queries: Mapping[str, str] | None = None,
        dtype: np.dtype = np.dtype(np.float32),
        copy: bool = True,
        is_sorted: bool = False,
    ) -> None:
        """Create a ranking from a data frame.

        The frame needs columns ``q_id``, ``id``, ``score`` and (optionally)
        ``query``.  Rows with NaN scores are dropped.

        :param df: Data frame of IDs and scores.
        :param name: Method name (used when saving TREC runfiles).
        :param queries: Query IDs mapped to query strings.
        :param dtype: Score representation dtype.
        :param copy: Whether to copy the input frame.
        :param is_sorted: Whether the frame is already (q_id, score)-sorted.
        :raises ValueError: When a (query, doc/passage) pair appears twice.
        :raises ValueError: When ``queries`` is missing some query ID.
        """
        self.name = name

        if df.duplicated(subset=["q_id", "id"]).any():
            raise ValueError(
                "Only one score per query-document/passage pair is allowed."
            )

        cols = _CORE_COLS + (["query"] if "query" in df.columns else [])
        frame = df.loc[:, cols].dropna()
        if copy:
            frame = frame.copy()
        frame = _coerce(frame, dtype)

        if not is_sorted:
            # sort both keys descending: primary q_id, secondary score
            frame.sort_values(["q_id", "score"], ascending=False, inplace=True)
        frame.reset_index(drop=True, inplace=True)
        self._df = frame

        self._q_ids = set(pd.unique(frame["q_id"]))
        self._by_q: dict[str, tuple[np.ndarray, np.ndarray]] | None = None
        if queries is not None:
            self._df = self._with_queries(frame, queries)

    @classmethod
    def _from_trusted_frame(
        cls, df: pd.DataFrame, name: str | None, q_ids: set | None = None
    ) -> "Ranking":
        """Internal fast path: adopt an already-sorted, typed, deduplicated
        frame without the constructor's validation scans.

        ``q_ids`` optionally skips the unique-scan too when the caller
        already knows the query-ID set (prepared-run plans cache it — the
        scan is ~6 ms per call on 512k-row frames)."""
        ranking = cls.__new__(cls)
        ranking.name = name
        ranking._df = df
        ranking._q_ids = (
            set(pd.unique(df["q_id"])) if q_ids is None else q_ids
        )
        ranking._by_q = None
        return ranking

    @staticmethod
    def _with_queries(df: pd.DataFrame, queries: Mapping[str, str]) -> pd.DataFrame:
        """Return ``df`` with a ``query`` column joined in from ``queries``."""
        present = set(pd.unique(df["q_id"]))
        if not present.issubset(queries.keys()):
            raise ValueError("Queries are incomplete.")
        qdf = pd.DataFrame(
            {"q_id": list(queries.keys()), "query": list(queries.values())}
        )
        return df.drop(columns=["query"], errors="ignore").merge(
            qdf, how="left", on="q_id"
        )

    # -- properties ----------------------------------------------------------

    @property
    def has_queries(self) -> bool:
        """Whether query strings are attached."""
        return "query" in self._df.columns

    @property
    def q_ids(self) -> set[str]:
        """The unique query IDs with at least one scored document."""
        return self._q_ids

    def _query_groups(self) -> dict[str, tuple[np.ndarray, np.ndarray]]:
        """Per-query ``(ids, scores)`` arrays, built lazily in ONE groupby.

        The frame is immutable after construction (every operation returns
        a new ranking), so the cache never invalidates.  Per-query lookups
        and the evaluation helpers are then O(rows) total instead of one
        full-frame scan per query (O(Q x rows) — quadratic at Q=512 x
        512k-row re-rank outputs).
        """
        if self._by_q is None:
            ids = self._df["id"].to_numpy()
            scores = self._df["score"].to_numpy()
            groups = self._df.groupby("q_id", sort=False, observed=True).indices
            self._by_q = {
                str(q): (ids[idx], scores[idx]) for q, idx in groups.items()
            }
        return self._by_q

    def __getitem__(self, q_id: str) -> dict[str, float]:
        """Return ``{id: score}`` for one query."""
        group = self._query_groups().get(q_id)
        if group is None:
            return {}
        return dict(zip(*group))

    def __len__(self) -> int:
        """Return the number of queries."""
        return len(self._q_ids)

    def __iter__(self) -> Iterator[str]:
        """Iterate over query IDs."""
        yield from self._q_ids

    def __contains__(self, key: object) -> bool:
        """Whether a query ID has scored documents in this ranking."""
        return key in self._q_ids

    def __eq__(self, o: object) -> bool:
        """Compare IDs and scores (name/queries are ignored)."""
        if not isinstance(o, Ranking):
            return False

        def _core(df: pd.DataFrame) -> pd.DataFrame:
            out = df[_CORE_COLS]
            # ID columns may be object, arrow-string, or categorical
            # (the scoring fast path emits categoricals) — compare values
            for col in ("q_id", "id"):
                if out[col].dtype != object:
                    out = out.assign(**{col: out[col].astype(object)})
            return out.sort_values(["q_id", "id"]).reset_index(drop=True)

        return _core(self._df).equals(_core(o._df))

    def __repr__(self) -> str:
        """Return the underlying frame's representation."""
        return repr(self._df)

    # -- derivation helpers --------------------------------------------------

    def _spawn(self, df: pd.DataFrame, copy: bool = False, is_sorted: bool = True) -> "Ranking":
        """Build a derived ranking, keeping name and score dtype."""
        return Ranking(
            df,
            name=self.name,
            dtype=self._df.dtypes["score"],
            copy=copy,
            is_sorted=is_sorted,
        )

    # -- algebra -------------------------------------------------------------

    def __add__(self, o: "Ranking | float") -> "Ranking":
        """Add a constant or another ranking's scores (missing scores = 0)."""
        if isinstance(o, Ranking):
            merged = _plain_ids(self._df).merge(
                _plain_ids(o._df),
                on=["q_id", "id"],
                suffixes=(None, "_r"),
                how="outer",
            ).fillna(0)
            merged["score"] = merged["score"] + merged["score_r"]
            return self._spawn(merged, is_sorted=False)
        if isinstance(o, int | float):
            out = self._df.copy()
            out["score"] += o
            return self._spawn(out)
        return NotImplemented

    __radd__ = __add__

    def __mul__(self, o: float) -> "Ranking":
        """Scale all scores by a constant."""
        if not isinstance(o, int | float):
            return NotImplemented
        out = self._df.copy()
        out["score"] *= o
        return self._spawn(out)

    __rmul__ = __mul__

    def attach_queries(self, queries: Mapping[str, str]) -> "Ranking":
        """Return a copy with query strings attached.

        :param queries: Query IDs mapped to queries.
        :raises ValueError: When the queries are incomplete.
        :return: The ranking with queries attached.
        """
        return Ranking(
            self._df,
            self.name,
            queries=queries,
            dtype=self._df.dtypes["score"],
            copy=True,
            is_sorted=True,
        )

    def normalize(self) -> "Ranking":
        """Min-max normalize scores into ``[0, 1]`` (all-equal -> 0)."""
        return self._spawn(_normalized(self._df))

    def cut(self, cutoff: int) -> "Ranking":
        """Keep only the top-``cutoff`` scores per query.

        The frame is already (q_id, score)-sorted, so this is a positional
        head per group — one vectorized run-position mask
        (:func:`_run_positions`; a ``cut(10)`` after a 512k-row re-rank
        costs ~2 ms instead of a full ``groupby.head``), with the groupby
        as the fallback for non-contiguous caller-built frames.
        """
        pos = _run_positions(self._df["q_id"])
        if pos is None:
            return self._spawn(
                self._df.groupby("q_id", sort=False, observed=True)
                .head(cutoff)
                .reset_index(drop=True),
                copy=True,
            )
        mask = pos < cutoff
        out = (
            self._df.copy()
            if bool(mask.all())
            else self._df[mask].reset_index(drop=True)
        )
        return Ranking._from_trusted_frame(out, self.name)

    def interpolate(
        self, other: "Ranking", alpha: float, normalize: bool = False
    ) -> "Ranking":
        """Mix scores: ``alpha * self + (1 - alpha) * other`` (missing = 0).

        :param other: Ranking to interpolate with.
        :param alpha: Interpolation parameter.
        :param normalize: Min-max normalize both inputs first.
        :return: The interpolated ranking.
        """
        a = _plain_ids(_normalized(self._df) if normalize else self._df)
        b = _plain_ids(_normalized(other._df) if normalize else other._df)
        merged = a.merge(
            b, on=["q_id", "id"], suffixes=(None, "_r"), how="outer"
        ).fillna(0)
        merged["score"] = alpha * merged["score"] + (1 - alpha) * merged["score_r"]
        return self._spawn(merged, is_sorted=False)

    def rr_scores(self, k: int = 60) -> "Ranking":
        """Replace scores with reciprocal-rank scores ``1 / (rank + k)``.

        Used by RRF (reciprocal rank fusion).

        :param k: RR scoring parameter.
        :return: A ranking with RR scores.
        """
        out = self._df.copy()
        out["score"] = 1.0 / (_ranks_within_query(out) + k)
        return self._spawn(out)

    # -- I/O -----------------------------------------------------------------

    def save(self, target: Path | str) -> None:
        """Write the ranking as a TREC runfile.

        :param target: Output path (parent dirs are created).
        """
        target = Path(target)
        out = self._df.copy()
        out["rank"] = _ranks_within_query(out)
        out["name"] = str(self.name)
        out["q0"] = "Q0"
        target.parent.mkdir(parents=True, exist_ok=True)
        out.to_csv(
            target,
            sep="\t",
            columns=["q_id", "q0", "id", "rank", "score", "name"],
            index=False,
            header=False,
        )

    @classmethod
    def from_run(
        cls,
        run: Run,
        name: str | None = None,
        queries: Mapping[str, str] | None = None,
        dtype: np.dtype = np.dtype(np.float32),
    ) -> "Ranking":
        """Create a ranking from a TREC run mapping.

        :param run: ``{q_id: {id: score}}`` mapping.
        :param name: Method name.
        :param queries: Query IDs mapped to queries.
        :param dtype: Score representation dtype.
        :return: The ranking.
        """
        # columnar build: per-query lengths -> one np.repeat for the q_id
        # column, flat iterators -> np.fromiter for ids/scores.  The
        # row-at-a-time triple-append version cost seconds of pure
        # interpreter time at production shapes (512 queries x depth-5000
        # = 2.56M rows: 7.7M list appends).
        counts = np.fromiter(
            (len(v) for v in run.values()), dtype=np.int64, count=len(run)
        )
        total = int(counts.sum())
        q_col = np.repeat(np.fromiter(run, dtype=object, count=len(run)), counts)
        ids = np.fromiter(
            (d for v in run.values() for d in v), dtype=object, count=total
        )
        scores = np.fromiter(
            (s for v in run.values() for s in v.values()),
            dtype=np.float64,
            count=total,
        )
        df = pd.DataFrame({"q_id": q_col, "id": ids, "score": scores})
        return cls(df, name=name, queries=queries, dtype=dtype, copy=False)

    @classmethod
    def from_file(
        cls,
        f: Path,
        queries: Mapping[str, str] | None = None,
        dtype: np.dtype = np.dtype(np.float32),
    ) -> "Ranking":
        """Read a ranking from a TREC runfile.

        :param f: The runfile.
        :param queries: Query IDs mapped to queries.
        :param dtype: Score representation dtype.
        :return: The ranking.
        """
        df = pd.read_csv(
            f,
            sep=r"\s+",
            skipinitialspace=True,
            header=None,
            names=["q_id", "q0", "id", "rank", "score", "name"],
        )
        name = df["name"][0] if len(df) else None
        return cls(df, name=name, queries=queries, dtype=dtype, copy=False)
