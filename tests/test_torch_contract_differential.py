"""``tests/test_differential.py`` on the port: random configurations
against a numpy oracle.

All 3 cases are copied with the same seeds, oracle and tolerance (``places=3``):
``TestDifferentialQuantized::test_random_quantized_configs`` (random PQ and
int8 configurations over the streamed and gather paths, against
decode-then-dot), and ``TestDifferential``'s random modes, shapes,
passage counts and depths on the host store and on ``store="device"``.
None is left out.  Each class runs on ``device="cpu"``; its ``...Cuda``
subclass (marker ``gpu``) runs the same cases on the card and skips
without one.  The file imports neither JAX nor ``fastforward_tpu``.
"""

import unittest

import numpy as np
import pytest
import torch

from fastforward_tpu_torch.encoder import LambdaEncoder
from fastforward_tpu_torch.index import InMemoryIndex, Mode
from fastforward_tpu_torch.quantizer import PQ, ScalarQuantizer
from fastforward_tpu_torch.ranking import Ranking


def _needs_card(cls):
    if not torch.cuda.is_available():
        raise unittest.SkipTest("needs an NVIDIA GPU")


def _oracle(mode, vectors, doc_rows, qvec, candidate_ids):
    out = {}
    for cid in candidate_ids:
        rows = doc_rows[cid]
        scores = vectors[rows] @ qvec
        if mode == Mode.MAXP:
            out[cid] = float(scores.max())
        elif mode == Mode.AVEP:
            out[cid] = float(scores.mean())
        else:  # FIRSTP / PASSAGE: first (only) row
            out[cid] = float(scores[0])
    return out


class TestDifferentialQuantized(unittest.TestCase):
    device = "cpu"

    def test_random_quantized_configs(self):
        """Random PQ/scalar configs across both the gather and streamed
        paths; scores must match decode-then-dot + per-mode aggregation."""

        rng = np.random.default_rng(77)
        for trial in range(6):
            dim = int(rng.choice([64, 128, 256]))
            mode = rng.choice([Mode.MAXP, Mode.AVEP, Mode.PASSAGE])
            # dense candidate sets force the streamed paths; sparse the
            # gather paths
            dense = bool(rng.integers(0, 2))
            num_docs = 400 if dense else 60
            if trial % 2 == 0:
                quantizer = PQ(dim // 16, 16, device=self.device)
            else:
                quantizer = ScalarQuantizer()
            vectors = rng.standard_normal((num_docs, dim), dtype=np.float32)
            quantizer.fit(vectors)
            decoded = quantizer.decode(quantizer.encode(vectors))

            qvec = rng.standard_normal(dim).astype(np.float32)
            index = InMemoryIndex(
                LambdaEncoder(lambda _, q=qvec: q),
                quantizer=quantizer,
                mode=mode,
                device=self.device,
            )
            ids = [f"d{i}" for i in range(num_docs)]
            index.add(vectors, doc_ids=ids, psg_ids=ids)
            depth = num_docs if dense else 10
            cand = rng.choice(ids, size=depth, replace=False)
            run = {"q1": {c: float(i) for i, c in enumerate(cand)}}
            got = index(Ranking.from_run(run, queries={"q1": "x"}))["q1"]
            per_row = decoded @ qvec
            for cid in cand:
                self.assertAlmostEqual(
                    float(per_row[int(cid[1:])]),
                    got[cid],
                    places=3,
                    msg=(trial, mode, dense, type(quantizer).__name__, cid),
                )


class TestDifferential(unittest.TestCase):
    device = "cpu"

    def test_random_configs(self):
        self._run_random_configs(store="host")

    def test_random_configs_device_store(self):
        """Same randomized sweep against the device-resident store."""
        self._run_random_configs(store="device")

    def _run_random_configs(self, store):
        rng = np.random.default_rng(123)
        for trial in range(8):
            dim = int(rng.choice([16, 64, 128, 256]))
            num_docs = int(rng.integers(20, 120))
            max_psg = int(rng.choice([1, 3, 9]))
            mode = rng.choice([Mode.MAXP, Mode.AVEP, Mode.FIRSTP, Mode.PASSAGE])
            num_q = int(rng.integers(1, 6))

            doc_sizes = rng.integers(1, max_psg + 1, size=num_docs)
            vectors = rng.standard_normal(
                (int(doc_sizes.sum()), dim), dtype=np.float32
            )
            doc_ids, psg_ids, doc_rows = [], [], {}
            row = 0
            for d, size in enumerate(doc_sizes):
                doc_rows[f"d{d}"] = list(range(row, row + size))
                for j in range(size):
                    doc_ids.append(f"d{d}")
                    psg_ids.append(f"d{d}_p{j}")
                    doc_rows[f"d{d}_p{j}"] = [row + j]
                    row += 1

            qvecs = {
                f"q{qi}": rng.standard_normal(dim).astype(np.float32)
                for qi in range(num_q)
            }
            encoder = LambdaEncoder(lambda text, qvecs=qvecs: qvecs[text])
            index = InMemoryIndex(encoder, mode=mode, store=store, device=self.device)
            index.add(vectors, doc_ids=doc_ids, psg_ids=psg_ids)

            id_pool = (
                psg_ids if mode == Mode.PASSAGE else [f"d{d}" for d in range(num_docs)]
            )
            run = {}
            queries = {}
            for qi in range(num_q):
                depth = int(rng.integers(1, len(id_pool) + 1))
                cand = rng.choice(id_pool, size=depth, replace=False)
                run[f"q{qi}"] = {c: float(i) for i, c in enumerate(cand)}
                queries[f"q{qi}"] = f"q{qi}"

            result = index(Ranking.from_run(run, queries=queries))
            for qi in range(num_q):
                expected = _oracle(
                    mode, vectors, doc_rows, qvecs[f"q{qi}"], list(run[f"q{qi}"])
                )
                got = result[f"q{qi}"]
                self.assertEqual(set(expected), set(got), msg=(trial, mode))
                for cid, score in expected.items():
                    self.assertAlmostEqual(
                        score, got[cid], places=3, msg=(trial, mode, cid)
                    )


@pytest.mark.gpu
class TestDifferentialQuantizedCuda(TestDifferentialQuantized):
    device = "cuda"
    setUpClass = classmethod(_needs_card)


@pytest.mark.gpu
class TestDifferentialCuda(TestDifferential):
    device = "cuda"
    setUpClass = classmethod(_needs_card)
