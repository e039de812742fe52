"""Self-contained ranking metrics (nDCG@k, RR@k, recall@k).

The reference delegates evaluation to the external ir-measures library via
``to_ir_measures`` (reference: ``util/__init__.py:29-37``); that export is
kept, and these direct implementations cover the common metrics without the
dependency — used e.g. to validate that ``precision="fast"`` scoring leaves
ranking quality unchanged.
"""

import math
from collections.abc import Mapping

from fastforward_tpu_torch.ranking import Ranking

#: qrels: query ID -> (doc/passage ID -> graded relevance)
Qrels = Mapping[str, Mapping[str, int]]


def _ranked_ids(ranking: Ranking, q_id: str, k: int) -> list[str]:
    # one shared groupby builds per-query (ids, scores) arrays; each lookup
    # is then O(rows of that query) — the metrics are O(rows) total instead
    # of one full-frame scan per query
    group = ranking._query_groups().get(q_id)
    if group is None:
        return []
    return list(group[0][:k])


def ndcg_at_k(ranking: Ranking, qrels: Qrels, k: int = 10) -> float:
    """Mean nDCG@k over the ranking's queries.

    :param ranking: The ranking to evaluate.
    :param qrels: Graded relevance judgments.
    :param k: Rank cut-off.
    :return: Mean nDCG@k (queries without judgments are skipped).
    """
    total, n = 0.0, 0
    for q_id in ranking.q_ids:
        judged = qrels.get(q_id)
        if not judged:
            continue
        gains = [judged.get(d, 0) for d in _ranked_ids(ranking, q_id, k)]
        dcg = sum(
            (2**g - 1) / math.log2(i + 2) for i, g in enumerate(gains)
        )
        ideal = sorted(judged.values(), reverse=True)[:k]
        idcg = sum(
            (2**g - 1) / math.log2(i + 2) for i, g in enumerate(ideal)
        )
        if idcg > 0:
            total += dcg / idcg
            n += 1
    return total / n if n else 0.0


def rr_at_k(ranking: Ranking, qrels: Qrels, k: int = 10) -> float:
    """Mean reciprocal rank at cut-off ``k`` (binary relevance: grade > 0).

    :param ranking: The ranking to evaluate.
    :param qrels: Relevance judgments.
    :param k: Rank cut-off.
    :return: MRR@k.
    """
    total, n = 0.0, 0
    for q_id in ranking.q_ids:
        judged = qrels.get(q_id)
        if not judged:
            continue
        n += 1
        for i, doc in enumerate(_ranked_ids(ranking, q_id, k)):
            if judged.get(doc, 0) > 0:
                total += 1.0 / (i + 1)
                break
    return total / n if n else 0.0


def recall_at_k(ranking: Ranking, qrels: Qrels, k: int = 1000) -> float:
    """Mean recall@k (binary relevance).

    :param ranking: The ranking to evaluate.
    :param qrels: Relevance judgments.
    :param k: Rank cut-off.
    :return: Mean recall@k.
    """
    total, n = 0.0, 0
    for q_id in ranking.q_ids:
        relevant = {d for d, g in qrels.get(q_id, {}).items() if g > 0}
        if not relevant:
            continue
        n += 1
        retrieved = set(_ranked_ids(ranking, q_id, k))
        total += len(retrieved & relevant) / len(relevant)
    return total / n if n else 0.0
