"""The yardstick's arithmetic and the reading of a synthetic trace."""

import pytest

from bench_port import roofline, trace

BERT_BASE = {"vocab_size": 30522, "hidden_size": 768, "num_hidden_layers": 12, "num_attention_heads": 12,
             "intermediate_size": 3072, "max_position_embeddings": 512, "type_vocab_size": 2,
             "layer_norm_eps": 1e-12}


def test_tower_bound_of_bert_base_at_512_by_36_tokens():
    bound = roofline.tower_bound(BERT_BASE, 512, 36, 67e12, 3.35e12)
    assert bound["bound_by"] == "operations"
    assert bound["bound_s"] * 1e3 == pytest.approx(47.10, abs=0.005)
    assert roofline.tower_flops(BERT_BASE, 512, 36) == bound["flops"]
    # 12 layers x (2 x 18,432 tokens x 7,077,888 + 4 x 512 x 36^2 x 768)
    assert bound["flops"] == 12 * (2 * 18_432 * 7_077_888 + 4 * 512 * 36 * 36 * 768)


def test_scoring_work_counts_each_row_query_and_score_once():
    work = roofline.scoring_work(distinct_rows=500_000, scored_rows=512_000, n_queries=512,
                                 n_results=512_000, dim=768)
    assert work["bytes"] == (500_000 + 512) * 768 * 4 + 512_000 * 4
    assert work["flops"] == 2 * 768 * 512_000
    assert roofline.scoring_bound_s(work) == pytest.approx(work["bytes"] / 3.35e12)
    # a call's least time in the encode cell: the tower plus ~1.57 GB
    least = roofline.tower_flops(BERT_BASE, 512, 36) / 67e12 + roofline.scoring_bound_s(work)
    assert least * 1e3 == pytest.approx(47.56, abs=0.05)


def _synthetic() -> trace.Profile:
    p = trace.Profile()
    p.host = [(trace.WINDOW, 0.0, 1000.0), ("ff.encode", 0.0, 300.0), ("ff.score", 300.0, 400.0),
              ("ff.layout", 250.0, 300.0), ("ff.fetch_sort", 400.0, 900.0)]
    p.device = [("gemm", 50.0, 150.0), ("gemm", 100.0, 200.0), ("Memcpy HtoD", 355.0, 360.0),
                ("k1_kernel", 360.0, 380.0), ("k1_kernel", 370.0, 390.0), ("reduce", 395.0, 420.0),
                ("Memcpy DtoH", 420.0, 440.0), ("late", 990.0, 1100.0)]
    p.annotations = [("ff.score", 355.0, 420.0), ("ff.encode", 50.0, 200.0)]
    return p


def test_idle_share_and_busy_time_of_a_synthetic_trace():
    p = _synthetic()
    # busy: 50-200, 355-390, 395-440, 990-1000 (clipped to the window)
    assert trace.busy_s(p) == pytest.approx((150 + 35 + 45 + 10) / 1e6)
    assert p.window_s == pytest.approx(1000 / 1e6)
    assert trace.idle_share(p) == pytest.approx(100 * (1 - 240 / 1000))
    assert trace.span_s(p, "ff.fetch_sort") == pytest.approx(500 / 1e6)
    # kernels inside ff.score's twin: 360-390 and 395-420, copies left out
    assert trace.kernels_inside_s(p, "ff.score") == pytest.approx((30 + 25) / 1e6)


def test_breakdown_names_the_host_range_of_each_gap():
    got = trace.breakdown(_synthetic())
    ops = dict(got["device_ops"])
    assert ops["gemm"] == pytest.approx(200 / 1e6) and list(ops)[0] == "gemm"
    gaps = dict(got["idle_gaps"])
    # 440-990 lies in ff.fetch_sort at its middle, 0-50 in ff.encode, 390-395
    # in ff.score; 200-355 in ff.layout, the innermost range at 277.5
    assert gaps == pytest.approx({"ff.fetch_sort": 550 / 1e6, "ff.encode": 50 / 1e6,
                                  "ff.score": 5 / 1e6, "ff.layout": 155 / 1e6})
    assert len(got["device_ops"]) <= 10 and len(got["idle_gaps"]) <= 10


def test_range_twins_on_the_device_are_not_device_work():
    """The profiler puts a device-side twin of each range with device work
    inside it on the card's timeline: the window's spans nearly all of it
    and is no work; the ``ff.*`` twins become annotations."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    def ev(name, s, e, device, user=False):
        return SimpleNamespace(name=name, time_range=SimpleNamespace(start=s, end=e),
                               device_type=DeviceType.CUDA if device else DeviceType.CPU,
                               is_user_annotation=user)

    events = [ev(trace.WINDOW, 0.0, 1000.0, False), ev("ff.score", 100.0, 200.0, False),
              ev("aten::mul", 100.0, 110.0, False), ev(trace.WINDOW, 5.0, 990.0, True, True),
              ev("ff.score", 120.0, 180.0, True, True), ev("other.range", 300.0, 400.0, True, True),
              ev("gather_kernel", 120.0, 150.0, True), ev("Memcpy HtoD", 160.0, 170.0, True)]
    p = trace.from_torch(SimpleNamespace(events=lambda: events))
    assert [n for n, _, _ in p.device] == ["gather_kernel", "Memcpy HtoD"]
    assert p.annotations == [("ff.score", 120.0, 180.0)]
    assert [n for n, _, _ in p.host] == [trace.WINDOW, "ff.score"]
    assert trace.busy_s(p) == pytest.approx(40 / 1e6)
    assert trace.idle_share(p) == pytest.approx(96.0)
