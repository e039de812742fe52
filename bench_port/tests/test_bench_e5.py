"""The E5-Mistral cell at a tiny size on the CPU: correct as the program
stands, not correct with the control in its place or with the timed path
broken underneath, and its traced run's decoder ranges read."""

import json
import time

import pytest
import torch

from bench_port import control, harness, spec, trace, tower_parts
from bench_port.tests.conftest import REPO, tiny_copy
from bench_port.tests.test_bench_run import FAULTS
from fastforward_tpu_torch.index.base import Index

CELL = "e5mistral.batch-encode"
SEED = 2**33 + 19

#: E5-Mistral's decoder cut to the CPU: every kind of block and the GQA
#: grouping kept, a window of 8 under 18-31-token queries so the window
#: bites
TINY_MISTRAL = {"vocab_size": 512, "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
                "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16, "hidden_act": "silu",
                "max_position_embeddings": 128, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
                "sliding_window": 8, "bos_token_id": 1, "eos_token_id": 2}


@pytest.fixture(scope="module")
def tiny_e5(tmp_path_factory):
    """The tiny benchmark with the E5 configuration's own tiny copy: the
    decoder above, 64-wide vectors, 20,000 passages, computed in fp32 (the
    committed limits are set for bf16 at 4,096 wide; bf16 against its
    bound is ``tests/test_torch_mistral.py``'s)."""
    root = tiny_copy(tmp_path_factory.mktemp("tiny-e5"))
    entry = next(c for c in json.loads((root / "BENCHMARK.json").read_text())["configs"]
                 if c["name"] == "msmarco-passage-e5mistral")
    cfg = json.loads((REPO / entry["file"]).read_text())
    cfg.update(tower=TINY_MISTRAL, dim=TINY_MISTRAL["hidden_size"], passages=20_000, compute_dtype="float32")
    (root / entry["file"]).write_text(json.dumps(cfg))
    return root


def _run(root, seconds=0.5, traced=False):
    c = spec.find_cell(root, CELL)
    out = harness.run_cell(c, SEED, seconds, traced, time.perf_counter(), "cpu")
    return c, out, harness.line_of(c, out, traced, "cpu")


def test_the_tiny_cell_is_correct_and_the_control_is_not(tiny_e5):
    c, out, line = _run(tiny_e5)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {m["name"] for m in c.end_to_end}
    values = control.control_values(c, SEED, out, torch.device("cpu"))
    ok, shown = harness.check.judge(values, c.limits)
    assert not ok, shown


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_a_broken_rerank_is_not_correct(tiny_e5, monkeypatch, fault):
    call = Index.__call__

    def broken(self, ranking, *args, **kwargs):
        return fault(ranking, call(self, ranking, *args, **kwargs))

    monkeypatch.setattr(Index, "__call__", broken)
    _c, _out, line = _run(tiny_e5)
    assert not line["correct"], line["checks"]


def test_a_traced_run_holds_the_decoder_ranges_inside_the_tower(tiny_e5):
    c, out, line = _run(tiny_e5, traced=True)
    assert line["correct"], line["checks"]
    host = out["run"].profile.host
    towers = [(s, e) for n, s, e in host if n == "ff.tower"]
    layers = c.config["tower"]["num_hidden_layers"]
    for name in ("ff.attn", "ff.mlp"):
        spans = [(s, e) for n, s, e in host if n == name]
        assert len(spans) == layers * len(towers), name
        assert all(any(ts <= s and e <= te for ts, te in towers) for s, e in spans), name


def _synthetic() -> trace.Profile:
    """Two layers' ranges in one tower; the kernels of the first attention
    block overlap, one kernel straddles a twin's end, a copy lies inside."""
    p = trace.Profile()
    p.host = [(trace.WINDOW, 0.0, 1000.0), ("ff.tower", 10.0, 500.0)]
    p.annotations = [("ff.attn", 20.0, 100.0), ("ff.mlp", 100.0, 200.0), ("ff.attn", 200.0, 260.0),
                     ("ff.mlp", 260.0, 400.0), ("ff.tower", 15.0, 450.0)]
    p.device = [("gemm", 25.0, 60.0), ("softmax", 50.0, 70.0), ("Memcpy HtoD", 80.0, 90.0),
                ("gemm", 110.0, 190.0), ("gemm", 205.0, 240.0), ("gemm", 250.0, 270.0),
                ("gemm", 300.0, 380.0)]
    return p


@pytest.mark.parametrize("span", ["ff.attn", "ff.mlp", "ff.tower"])
def test_the_bisecting_kernel_sum_equals_the_traces(span):
    p = _synthetic()
    assert tower_parts.kernels_inside_s(p, span) == pytest.approx(trace.kernels_inside_s(p, span))


@pytest.mark.parametrize("metric, part, busy_us", [("attn_roofline.rerank", "attn", 45 + 35),
                                                   ("mlp_roofline.rerank", "mlp", 80 + 80)])
def test_each_part_reader_is_its_least_time_over_its_kernels(tiny_e5, metric, part, busy_us):
    c = spec.find_cell(tiny_e5, CELL)
    run = harness.Run(cell=c, loop="closed", seed=1)
    run.profile, run.traced_calls = _synthetic(), 2
    encoder = spec.plugin(tiny_e5, "encoders", spec.encoder_name(c))
    least = encoder.least_parts_s(c.config, c.traffic["queries_per_call"])[part]
    assert spec.reader(tiny_e5, metric)(run) == pytest.approx(100 * 2 * least / (busy_us / 1e6))
    assert sum(encoder.least_parts_s(c.config, 7).values()) == pytest.approx(encoder.least_s(c.config, 7))
    run.profile = trace.Profile(host=_synthetic().host, device=_synthetic().device)
    assert spec.reader(tiny_e5, metric)(run) is None
