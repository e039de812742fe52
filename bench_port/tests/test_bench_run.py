"""Whole runs of tiny cells on the CPU: correct as the program stands,
not correct with the timed path broken underneath or with the control in
its place, and a cell found by new files alone."""

import json
import time

import numpy as np
import pandas as pd
import pytest
import torch

from bench_port import control, data, harness, spec
from fastforward_tpu_torch import Ranking
from fastforward_tpu_torch.index.base import Index

SEED = 2**31 + 99
BATCH, DOC = "passage.batch-encode", "doc-maxp.batch-preencoded"
CELLS = [BATCH, DOC, "passage.batch-preencoded"]


def _run(root, cell, seconds=0.5, traced=False):
    c = spec.find_cell(root, cell)
    out = harness.run_cell(c, SEED, seconds, traced, time.perf_counter(), "cpu")
    return c, out, harness.line_of(c, out, traced, "cpu")


def _frame(r: Ranking) -> pd.DataFrame:
    return r._df


def unchanged(inp: Ranking, out: Ranking) -> Ranking:
    """The step returns its input: the lexical scores."""
    return inp


def half(inp: Ranking, out: Ranking) -> Ranking:
    """Half of the batch left out: every other query's rows dropped."""
    df = _frame(out)
    keep = sorted(set(df["q_id"].astype(str)))[::2]
    return Ranking(df[df["q_id"].astype(str).isin(keep)].copy())


def altered(inp: Ranking, out: Ranking) -> Ranking:
    """An answer altered where it is produced: each query's best score raised."""
    df = _frame(out).copy()
    first = ~df["q_id"].duplicated()
    df["score"] = df["score"].where(~first, df["score"] + 1.0)
    return Ranking(df)


FAULTS = [unchanged, half, altered]


@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_cell_is_correct_and_reports_its_metrics(tiny, cell):
    c, out, line = _run(tiny, cell, traced=cell == BATCH)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks" and set(line["checks"]) == set(c.limits)
    if cell != BATCH:
        assert set(line["metrics"]) == {m["name"] for m in c.end_to_end}
    json.dumps(line)


def test_every_tiny_document_call_holds_a_document_of_more_than_64_passages(tiny):
    """As at full size, so the tiny runs take the program's MaxP path of the
    full-size cell (documents of more than 64 passages)."""
    c = spec.find_cell(tiny, DOC)
    docs = data.corpus_layout(SEED, c.config)
    loop = spec.plugin(tiny, "loops", c.traffic["loop"])
    assert all(docs.counts[p.candidates].max() > 64 for p in loop.pools(c, SEED))


@pytest.mark.parametrize("cell", [BATCH, DOC])
@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_a_broken_rerank_is_not_correct(tiny, monkeypatch, fault, cell):
    call = Index.__call__

    def broken(self, ranking, *args, **kwargs):
        return fault(ranking, call(self, ranking, *args, **kwargs))

    monkeypatch.setattr(Index, "__call__", broken)
    _c, _out, line = _run(tiny, cell)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(tiny, cell):
    c, out, line = _run(tiny, cell)
    assert line["correct"]
    values = control.control_values(c, SEED, out, torch.device("cpu"))
    ok, shown = harness.check.judge(values, c.limits)
    assert not ok, shown


ENCODER = """import numpy as np
import torch

from bench_port import data


def make(config, seed, texts, device):
    from fastforward_tpu_torch.encoder import LambdaEncoder

    by_text = {t: 2 * v for t, v in data.query_vectors(seed, texts, config["dim"]).items()}
    return LambdaEncoder(by_text.__getitem__), {"vectors": by_text}


def reference(texts, inputs, config, precision, device):
    return torch.from_numpy(np.stack([inputs["vectors"][t] for t in texts])).to(device)


def least_s(config, n_queries):
    return 0.0
"""

INDEX = """from pathlib import Path

from bench_port import spec


def build(config, seed, encoder, device, log=print):
    here = Path(__file__).resolve()
    (here.parent / "host-copy.built").write_text(config["name"])
    base = spec.plugin(here.parents[2], "indexes", "InMemoryIndex")
    return base.build({**config, "store": "host"}, seed, encoder, device, log=log)
"""


def test_a_cell_of_new_files_alone_is_found_and_run(tiny, tmp_path):
    """A configuration with its own index builder, a mix with its own
    encoder, a cell and a metric: new files and new entries only."""
    import shutil

    root = tmp_path / "copy"
    shutil.copytree(tiny, root, symlinks=True)
    here = root / "bench_port"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((here / "configs" / "msmarco-passage-tct.json").read_text())
    cfg.update(name="new-config", passages=9_000, index="host-copy")
    (here / "configs" / "new-config.json").write_text(json.dumps(cfg))
    (here / "indexes" / "host-copy.py").write_text(INDEX)
    mix = json.loads((here / "traffic" / "batch-preencoded.json").read_text())
    mix.update(queries_per_call=8, depth=70, encoder="doubled")
    (here / "traffic" / "new-mix.json").write_text(json.dumps(mix))
    (here / "encoders" / "doubled.py").write_text(ENCODER)
    (here / "limits" / "new.cell.json").write_text(
        (here / "limits" / "passage.batch-preencoded.json").read_text())
    (here / "metrics" / "calls_per_s.new.py").write_text(
        "def read(run):\n    return len(run.call_s) / run.window_s\n")
    bench["configs"].append({"name": "new-config", "source": "a test", "file": "bench_port/configs/new-config.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "new.cell", "config": "new-config", "traffic": "new-mix", "chips": 1,
                               "why": "a test"})
    next(m for m in bench["end_to_end"] if m["name"] == "rerank_qps")["workloads"].append("new.cell")
    bench["per_layer"].append({"name": "calls_per_s.new", "unit": "1/s", "better": "higher",
                               "source": "host_clock", "layer": "entry point", "moves": "rerank_qps",
                               "workloads": ["new.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: p.read_bytes() for p in (tiny / "bench_port").rglob("*") if p.is_file() and "__pycache__" not in str(p)}
    c, out, line = _run(root, "new.cell", traced=True)
    assert line["correct"] and "calls_per_s.new" in line["metrics"]
    assert (here / "indexes" / "host-copy.built").read_text() == "new-config"
    texts = [t for p in spec.plugin(root, "loops", "closed").pools(c, SEED) for t in p.texts]
    text = out["answers"][0]["text"]
    doubled = 2 * data.query_vectors(SEED, texts, cfg["dim"])[text]
    assert np.array_equal(out["ref"][0][0], doubled.astype(np.float64))
    assert all((root / p.relative_to(tiny)).read_bytes() == b for p, b in before.items())
