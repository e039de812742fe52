"""The readers of the program's finer ranges on synthetic traces, and on a
tiny traced run of the encode cell on the CPU."""

import time

import pytest

from bench_port import harness, spec, trace
from bench_port.tests.conftest import REPO

ENCODE = "passage.batch-encode"
SPANS = {
    "frame_ms.rerank": "ff.frame",
    "resolve_ms.rerank": "ff.resolve",
    "columns_ms.rerank": "ff.columns",
    "assemble_ms.rerank": "ff.assemble",
    "tokenize_ms.rerank": "ff.tokenize",
}
NEW = ["call_self_ms.rerank", "encoder_roofline.rerank", *SPANS]


def _run(profile, calls=2, cell=ENCODE):
    run = harness.Run(cell=spec.find_cell(REPO, cell), loop="closed", seed=1)
    run.profile, run.traced_calls = profile, calls
    return run


def _read(name, run):
    return spec.reader(REPO, name)(run)


def _synthetic() -> trace.Profile:
    """Two calls of 1,000 and 500 us; the first holds overlapping and nested
    ranges, and a range outside both calls lies in the window."""
    p = trace.Profile()
    p.host = [
        (trace.WINDOW, 0.0, 3000.0),
        ("ff.call", 0.0, 1000.0),
        ("ff.frame", 100.0, 300.0),
        ("ff.resolve", 250.0, 400.0),  # overlaps ff.frame: 100-400 counted once
        ("ff.encode", 500.0, 700.0),
        ("ff.tokenize", 520.0, 540.0),
        ("ff.tower", 550.0, 650.0),  # inside ff.encode
        ("ff.columns", 800.0, 850.0),
        ("ff.assemble", 900.0, 1100.0),  # clipped to the call at 1000
        ("ff.frame", 1500.0, 1600.0),  # in no call
        ("ff.call", 2000.0, 2500.0),
        ("ff.score", 2100.0, 2200.0),
    ]
    # the tower's twins hold 75 us of kernels, a copy and a kernel outside
    p.annotations = [("ff.tower", 555.0, 660.0), ("ff.encode", 505.0, 700.0)]
    p.device = [("gemm", 560.0, 610.0), ("gemm", 600.0, 620.0), ("ln", 630.0, 645.0),
                ("Memcpy HtoD", 556.0, 559.0), ("k1_kernel", 2150.0, 2190.0)]
    return p


def test_call_self_time_counts_each_covered_moment_once():
    p = _synthetic()
    # call 1: 1,000 less 100-400, 500-700, 800-850, 900-1000 (650 us covered);
    # call 2: 500 less 100
    assert _read("call_self_ms.rerank", _run(p)) == pytest.approx((350 + 400) / 2 / 1e3)


def test_each_span_reader_is_the_mean_range_a_traced_call():
    p = _synthetic()
    want = {"ff.frame": 300.0, "ff.resolve": 150.0, "ff.columns": 50.0, "ff.assemble": 200.0,
            "ff.tokenize": 20.0}
    for name, span in SPANS.items():
        assert _read(name, _run(p)) == pytest.approx(want[span] / 2 / 1e3), name


def test_encoder_roofline_is_the_towers_least_time_over_its_kernels():
    p = _synthetic()
    cell = spec.find_cell(REPO, ENCODE)
    encoder = spec.plugin(REPO, "encoders", spec.encoder_name(cell))
    least = encoder.least_s(cell.config, cell.traffic["queries_per_call"])
    assert least * 1e3 == pytest.approx(47.10, abs=0.005)  # BERT-base, 512 x 36 tokens
    # kernels inside the twins: 560-620 and 630-645, 75 us; the copy is left out
    assert trace.kernels_inside_s(p, "ff.tower") == pytest.approx(75 / 1e6)
    assert _read("encoder_roofline.rerank", _run(p)) == pytest.approx(100 * 2 * least / 75e-6)


def test_each_reader_finds_nothing_without_its_range():
    p = _synthetic()
    for name in NEW:
        assert _read(name, _run(None)) is None, name
        assert _read(name, _run(p, calls=0)) is None, name
    gone = {"call_self_ms.rerank": "ff.call", "encoder_roofline.rerank": "ff.tower", **SPANS}
    for name, span in gone.items():
        bare = trace.Profile(host=[r for r in p.host if r[0] != span],
                             device=list(p.device),
                             annotations=[r for r in p.annotations if r[0] != span])
        assert _read(name, _run(bare)) is None, name
    # a pre-encoded cell encodes nothing: no least time, no share
    assert _read("encoder_roofline.rerank", _run(p, cell="passage.batch-preencoded")) is None


def test_a_tiny_traced_encode_run_reads_every_new_range(tiny):
    c = spec.find_cell(tiny, ENCODE)
    out = harness.run_cell(c, 2**31 + 5, 0.5, True, time.perf_counter(), "cpu")
    line = harness.line_of(c, out, True, "cpu")
    assert line["correct"], line["checks"]
    got = line["metrics"]
    # the CPU trace has no device activity: the roofline has nothing to read
    for name in ("call_self_ms.rerank", *SPANS):
        assert got[name]["value"] > 0, name
    assert "encoder_roofline.rerank" not in got
    run = out["run"]
    call_ms = trace.span_s(run.profile, "ff.call") / run.traced_calls * 1e3
    assert got["call_self_ms.rerank"]["value"] < call_ms
    named = sum(got[n]["value"] for n in ("frame_ms.rerank", "resolve_ms.rerank",
                                          "columns_ms.rerank", "assemble_ms.rerank"))
    assert named < call_ms
