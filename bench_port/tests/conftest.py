"""Helpers of the benchmark's CPU tests: a tiny copy of the benchmark."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

#: a BERT tower small enough for the CPU
TINY_TOWER = {"vocab_size": 512, "hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 2,
              "intermediate_size": 128, "max_position_embeddings": 64, "type_vocab_size": 2,
              "layer_norm_eps": 1e-12}


#: the document cell, held out of ``BENCHMARK.json`` while its rate spreads
#: between runs wider than any bound holds; its configuration, mix and
#: limits are committed, and the tiny copy runs it
HELD_CELLS = {
    "configs": [{
        "name": "msmarco-doc-maxp-tct",
        "source": "Leonhardt et al., Efficient Neural Ranking using Forward Indexes, WWW 2022: MS MARCO v1 "
                  "document, MaxP over TCT-ColBERT passages; segments: Pyserini msmarco-v1-doc-segmented "
                  "(20,545,677)",
        "file": "bench_port/configs/msmarco-doc-maxp-tct.json",
        "reduced": [],
        "why": "MS MARCO v1's 3,213,835 documents as the segmented corpus's 20,545,677 passages x 768 fp32 "
               "(63.1 GB), scored by MaxP",
    }],
    "workloads": [{
        "name": "doc-maxp.batch-preencoded",
        "config": "msmarco-doc-maxp-tct",
        "traffic": "batch-preencoded",
        "chips": 1,
        "why": "closed loop: 512 pre-encoded queries x 1,000 documents (~3.3M passage rows) a call; documents "
               "over 64 passages send MaxP down the flat segment path: ids resolved 3 times, gather-dot",
    }],
    # the metrics the document cell reports (the flat path has no ff.layout,
    # ff.fetch_sort or ff.score range to read)
    "metrics": ["rerank_qps", "encode_ms.rerank", "device_idle.rerank", "step_mfu.rerank"],
}


def with_held_cells(bench: dict) -> dict:
    """``bench`` with :data:`HELD_CELLS` added, and the document cell in
    the cells of each metric it reports."""
    bench = json.loads(json.dumps(bench))
    for group in ("configs", "workloads"):
        bench[group] += HELD_CELLS[group]
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if metric["name"] in HELD_CELLS["metrics"]:
            metric["workloads"].append(HELD_CELLS["workloads"][0]["name"])
    return bench


def tiny_copy(dst: Path, dim: int = 64) -> Path:
    """The benchmark, with the held cells, and every configuration and mix
    cut to CPU size (the program linked in); the limits are the committed ones.  A query has
    more candidates than the vectors have widths, so that least squares can
    fit its vector (``qvec_err``).  Documents hold 12 passages on average,
    so that, as at full size, every call holds documents of more than 64."""
    depth = max(100, dim + 64)
    shutil.copytree(REPO / "bench_port", dst / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (dst / "fastforward_tpu_torch").symlink_to(REPO / "fastforward_tpu_torch")
    bench = with_held_cells(json.loads((REPO / "BENCHMARK.json").read_text()))
    for entry in bench["configs"]:
        cfg = json.loads((REPO / entry["file"]).read_text())
        cfg.update(tower={**TINY_TOWER, "hidden_size": dim}, dim=dim)
        cfg.update(passages=20_000) if cfg["mode"] == "passage" else cfg.update(documents=5_000, passages=60_000)
        (dst / entry["file"]).write_text(json.dumps(cfg))
    for path in (dst / "bench_port" / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix.update(queries_per_call=16, depth=depth, pool=6, check_queries=8, trace_calls=2)
        path.write_text(json.dumps(mix))
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


@pytest.fixture(scope="session")
def tiny(tmp_path_factory) -> Path:
    return tiny_copy(tmp_path_factory.mktemp("tiny"))
