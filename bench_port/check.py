"""Deciding ``correct``: the program's answers against the plain reference.

A sample of the answers due in the window, drawn from the seed (the
cell's loop draws it), is compared once the window has closed.  Each
answer is one query's re-rank: its candidates in the program's order with
their scores.  The numbers compared, each scale-free (divided by ``|q|
sqrt(dim)``, the size of a query's dot with a typical row, ``q`` the
reference's query vector):

- ``answers_bad``: answers that are missing, hold another candidate set,
  or whose scores do not fall down the list;
- ``score_err``: the widest gap between a returned score and the
  reference's for that candidate (semantic, MaxP for documents);
- ``order_err``: the widest rise of the reference's scores down the
  program's order;
- ``qvec_err`` (passages): the query vector the program's scores imply
  (least squares over the query's candidate rows) against the
  reference's, relative to its norm.

The control puts the reference in the program's place, in TF32: its
answers go through the same comparison (``control_answers``).
"""

import math

import numpy as np
import torch

from bench_port import data, reference


def answer(pool: data.Queries, qi: int, result) -> dict:
    """One query's answer as the program gave it (``None`` results: missing)."""
    out = {"q_id": pool.q_ids[qi], "text": pool.texts[qi], "candidates": pool.candidates[qi]}
    got = None if result is None else result[pool.q_ids[qi]]
    out["ids"] = None if got is None else list(got.keys())
    out["scores"] = None if got is None else np.fromiter(got.values(), dtype=np.float64)
    return out


def reference_data(config: dict, seed: int, answers: list, encoder, inputs: dict,
                   precision: str, device) -> list:
    """Each answer's query vector and candidates' semantic scores, worked
    out by the reference in ``precision`` from the seed and the encoder's
    inputs (``encoder`` is the cell's encoder module)."""
    qvecs = encoder.reference([a["text"] for a in answers], inputs, config, precision, device)
    sems = reference.candidate_scores(seed, config, qvecs, [a["candidates"] for a in answers],
                                      precision, device)
    return [(qvecs[i].double().cpu().numpy(), sems[i]) for i in range(len(answers))]


def control_answers(answers: list, control: list) -> list:
    """The control's answers to the same queries: the reference in TF32 in
    the program's place."""
    out = []
    for a, (_q, sem) in zip(answers, control):
        sem32 = sem.astype(np.float32).astype(np.float64)
        order = np.argsort(-sem32, kind="stable")
        out.append({**a, "ids": list(order), "scores": sem32[order], "positions": True})
    return out


def _positions(a: dict, prefix: str) -> "np.ndarray | None":
    """Candidate positions of an answer's ids (``None``: an unknown id)."""
    if a.get("positions"):
        return np.asarray(a["ids"], dtype=np.int64)
    where = {int(c): i for i, c in enumerate(a["candidates"])}
    pos = [where.get(int(i[len(prefix):]), -1) if str(i).startswith(prefix) else -1 for i in a["ids"]]
    pos = np.asarray(pos, dtype=np.int64)
    return None if (pos < 0).any() else pos


def readings(config: dict, seed: int, answers: list, ref: list, device) -> dict:
    """The numbers compared, over all sampled answers."""
    prefix = data.id_prefix(config)
    dim = config["dim"]
    out = {"answers_bad": 0, "score_err": 0.0, "order_err": 0.0}
    fits = []
    for a, (q, sem) in zip(answers, ref):
        scale = float(np.linalg.norm(q)) * math.sqrt(dim)
        pos = None if a["ids"] is None else _positions(a, prefix)
        if (pos is None or pos.size != sem.size or np.unique(pos).size != pos.size
                or (np.diff(a["scores"]) > 0).any()):
            out["answers_bad"] += 1
            continue
        out["order_err"] = max(out["order_err"], float(max(0.0, np.diff(sem[pos]).max())) / scale)
        out["score_err"] = max(out["score_err"], float(np.abs(a["scores"] - sem[pos]).max()) / scale)
        if config["mode"] == "passage":
            got = np.empty(sem.size)
            got[pos] = a["scores"]
            fits.append((a["candidates"], got, q))
    if fits:
        out["qvec_err"] = _qvec_err(config, seed, fits, device)
    return out


def _qvec_err(config: dict, seed: int, fits: list, device) -> float:
    """The widest relative gap between the query vector that least squares
    fits to a query's returned scores over its candidate rows and the
    reference's vector (one pass over the corpus for all queries)."""
    cands = np.stack([c for c, _, _ in fits])
    rows = data.gather_corpus(seed, cands.ravel(), config["passages"], config["dim"], device)
    rows = rows.double().view(len(fits), cands.shape[1], config["dim"])
    got = torch.from_numpy(np.stack([s for _, s, _ in fits])).to(rows.device)[:, :, None]
    fit = torch.linalg.lstsq(rows, got).solution[:, :, 0].cpu().numpy()
    want = np.stack([q for _, _, q in fits])
    return float((np.linalg.norm(fit - want, axis=1) / np.linalg.norm(want, axis=1)).max())


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """Whether every number is within its limit, and each beside it."""
    shown = {k: {"value": values[k], "limit": limits[k]} for k in limits if k in values}
    ok = all(k in values for k in limits) and all(values[k] <= limits[k] for k in limits)
    return ok, shown
