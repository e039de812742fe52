"""PyTerrier pipeline operators backed by the port's index.

The port of ``fastforward_tpu/utils/pyterrier.py``, with the same pipeline
contract as the reference (reference: ``util/pyterrier.py``):
``bm25 % 5000 >> FFScore(index) >> FFInterpolate(alpha)``.  Requires the
optional ``python-terrier`` dependency; importing this module without it
raises ``ImportError``.
"""

import pandas as pd

try:
    import pyterrier as pt
except ImportError as e:  # pragma: no cover - optional dependency
    raise ImportError(
        "python-terrier is required for fastforward_tpu_torch.utils.pyterrier"
    ) from e

from fastforward_tpu_torch.index.base import Index
from fastforward_tpu_torch.ranking import Ranking


class FFScore(pt.Transformer):
    """PyTerrier transformer computing semantic scores with an index."""

    def __init__(self, index: Index) -> None:
        """Create an FFScore transformer.

        :param index: The Fast-Forward index to score with.
        """
        self._index = index
        super().__init__()

    def transform(self, inp: pd.DataFrame) -> pd.DataFrame:
        """Score all (query, document) pairs in the frame.

        Existing retrieval scores move to the ``score_0`` column.

        :param inp: PyTerrier frame with ``qid, docno, query, score``.
        :return: Frame with semantic scores and ranks.
        """
        ranking = Ranking(
            inp.rename(columns={"qid": "q_id", "docno": "id"}),
            copy=False,
            is_sorted=True,  # scoring does not require sorted input
        )
        scored = self._index(ranking)._df.rename(
            columns={"q_id": "qid", "id": "docno"}
        )
        result = scored[["qid", "docno", "score", "query"]].merge(
            inp[["qid", "docno", "score"]],
            on=["qid", "docno"],
            suffixes=(None, "_0"),
        )
        return pt.model.add_ranks(result, single_query=False)

    def __repr__(self) -> str:
        """Unique per (index, encoder) so PyTerrier caching works."""
        return (
            f"{type(self).__name__}"
            f"({id(self._index)}, {id(self._index.query_encoder)})"
        )


class FFInterpolate(pt.Transformer):
    """PyTerrier transformer interpolating lexical and semantic scores."""

    def __init__(self, alpha: float) -> None:
        """Create an FFInterpolate transformer.

        :param alpha: The interpolation parameter.
        """
        # named exactly `alpha` so pyterrier.GridScan can tune it
        self.alpha = alpha
        super().__init__()

    def transform(self, inp: pd.DataFrame) -> pd.DataFrame:
        """Mix scores: ``alpha * score_0 + (1 - alpha) * score``.

        :param inp: Frame with ``score_0`` (lexical) and ``score`` (semantic).
        :return: Frame with interpolated scores and ranks.
        """
        out = inp[["qid", "docno", "query"]].copy()
        out["score"] = self.alpha * inp["score_0"] + (1 - self.alpha) * inp["score"]
        return pt.model.add_ranks(out, single_query=False)


class FFRerank(pt.Transformer):
    """Fused re-rank transformer: ``FFScore >> FFInterpolate >> % cutoff``
    in one call.

    Backed by :meth:`fastforward_tpu_torch.index.Index.serve`: semantic
    scoring, score interpolation and the per-query top-``cutoff`` cut run
    on the device, so only ``num_queries x cutoff`` results are copied
    back (the two-transformer pipeline fetches the full ``num_queries x
    depth`` score matrix first).  Pipeline contract
    matches ``bm25 % 5000 >> FFScore(idx) >> FFInterpolate(a) % cutoff``
    (reference: ``util/pyterrier.py:15-83``).
    """

    def __init__(self, index: Index, alpha: float, cutoff: int) -> None:
        """Create a fused re-rank transformer.

        :param index: The Fast-Forward index to score with.
        :param alpha: The interpolation parameter (lexical weight).
        :param cutoff: Results to keep per query.
        """
        self._index = index
        # named exactly `alpha` so pyterrier.GridScan can tune it
        self.alpha = alpha
        self.cutoff = cutoff
        super().__init__()

    def transform(self, inp: pd.DataFrame) -> pd.DataFrame:
        """Serve interpolated top-``cutoff`` results per query.

        :param inp: PyTerrier frame with ``qid, docno, query, score``.
        :return: Frame with interpolated scores and ranks, ``cutoff``
            rows per query.
        """
        ranking = Ranking(
            inp.rename(columns={"qid": "q_id", "docno": "id"}),
            copy=False,
            is_sorted=True,  # scoring does not require sorted input
        )
        served = self._index.serve(ranking, self.alpha, self.cutoff)
        out = served._df.rename(columns={"q_id": "qid", "id": "docno"})[
            ["qid", "docno", "score"]
        ]
        queries = inp[["qid", "query"]].drop_duplicates("qid")
        out = out.merge(queries, on="qid", how="left")
        return pt.model.add_ranks(out, single_query=False)

    def __repr__(self) -> str:
        """Unique per (index, encoder) so PyTerrier caching works."""
        return (
            f"{type(self).__name__}"
            f"({id(self._index)}, {id(self._index.query_encoder)}, "
            f"{self.alpha}, {self.cutoff})"
        )
