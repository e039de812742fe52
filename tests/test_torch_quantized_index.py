"""The quantized slice: the port's int8, PQ and OPQ indexes against
``fastforward_tpu``'s.

Each pair of indexes holds the same codes and the same quantizer state: the
JAX index encodes the corpus, and the port's is rebuilt from its stored codes
(``convert.index_from_codes``) and its quantizer's ``serialize()`` triple
(``convert.quantizer_from_state``).  Both score the same runs with the same
fixed query vectors, one run per routing branch: a sparse run (the
gather-dot), a streamed run at ``cap <= r`` (K1 / K3) and a streamed run at
``cap > r`` (K2 / K4).  The port runs on the CPU here, so its kernels run
their plain versions; which kernel wrapper the port routed to is recorded.
"""

import numpy as np
import pytest

import fastforward_tpu as fj
import fastforward_tpu_torch as ft
from fastforward_tpu.encoder import LambdaEncoder as JaxLambdaEncoder
from fastforward_tpu.index import InMemoryIndex as JaxInMemoryIndex
from fastforward_tpu.index import Mode as JaxMode
from fastforward_tpu.quantizer import OPQ as JaxOPQ
from fastforward_tpu.quantizer import PQ as JaxPQ
from fastforward_tpu.quantizer import ScalarQuantizer as JaxScalarQuantizer
from fastforward_tpu_torch import convert, ops
from fastforward_tpu_torch.encoder import LambdaEncoder
from fastforward_tpu_torch.ops import stream_kernel as sk
from fastforward_tpu_torch.ops import stream_kernel_pq as skpq

N, DIM, QUERIES = 4096, 256, 48

#: queries x depth per branch: sparse (8 pairs: 8 * 500 <= N), cap <= r
#: (1,920 pairs over 8 tiles of 512 rows: cap 256), cap > r (4,800 pairs:
#: cap 1024)
RUNS = {"sparse": (4, 2), "cap_le_r": (24, 80), "cap_gt_r": (48, 100)}

#: the kernel wrapper each branch reaches, per table kind
KERNELS = {
    "scalar": {"sparse": None, "cap_le_r": "stream_select_pairwise", "cap_gt_r": "stream_select"},
    "pq": {
        "sparse": None,
        "cap_le_r": "stream_select_pq_pairwise",
        "cap_gt_r": "stream_select_pq",
    },
}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    corpus = rng.standard_normal((N, DIM), dtype=np.float32)
    qvecs = rng.standard_normal((QUERIES, DIM), dtype=np.float32)
    by_text = {f"query {i}": qvecs[i] for i in range(QUERIES)}
    runs = {}
    for name, (num_q, depth) in RUNS.items():
        runs[name] = {
            f"q{qi}": {
                f"p{c}": float(depth - i)
                for i, c in enumerate(rng.choice(N, size=depth, replace=False))
            }
            for qi in range(num_q)
        }
    return corpus, by_text, runs


_QUANTIZERS = {
    "int8": lambda: JaxScalarQuantizer(),
    "PQ": lambda: JaxPQ(16, 16),
    "OPQ": lambda: JaxOPQ(16, 16, opq_iters=2),
}


@pytest.fixture(scope="module", params=list(_QUANTIZERS))
def indexes(request, data):
    """(JAX index, port index) holding the same codes and quantizer state."""
    corpus, by_text, _ = data
    jq = _QUANTIZERS[request.param]()
    jq.fit(corpus[:1024])
    psg_ids = [f"p{i}" for i in range(N)]
    jax_index = JaxInMemoryIndex(
        query_encoder=JaxLambdaEncoder(by_text.__getitem__),
        quantizer=jq,
        mode=JaxMode.PASSAGE,
        precision="exact",
    )
    jax_index.add(corpus, psg_ids=psg_ids)
    index = convert.index_from_codes(
        jax_index._store[:N],
        None,
        psg_ids,
        JaxMode.PASSAGE,
        convert.quantizer_from_state(*jq.serialize(), device="cpu"),
        query_encoder=LambdaEncoder(by_text.__getitem__),
        precision="exact",
        device="cpu",
    )
    return request.param, jax_index, index


def _rankings(data, branch):
    _, by_text, runs = data
    run = runs[branch]
    queries = {q: f"query {q[1:]}" for q in run}
    return fj.Ranking.from_run(run, queries=queries), ft.Ranking.from_run(run, queries=queries)


def _cols(ranking):
    df = ranking._df
    return (
        df["q_id"].astype(str).to_numpy(),
        df["id"].astype(str).to_numpy(),
        df["score"].to_numpy(dtype=np.float64),
    )


def _assert_same(got, want):
    """Same pairs in the same order; scores at atol 1e-4 / rtol 1e-5 (fp32
    sums in another order)."""
    gq, gi, gs = _cols(got)
    wq, wi, ws = _cols(want)
    np.testing.assert_array_equal(gq, wq)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, ws, atol=1e-4, rtol=1e-5)


def _spy_kernels(monkeypatch):
    """Record the kernel wrappers the routers call (by name)."""
    calls = []
    for module, names in (
        (sk, ("stream_select_pairwise", "stream_select")),
        (skpq, ("stream_select_pq_pairwise", "stream_select_pq")),
    ):
        for name in names:
            real = getattr(module, name)

            def spy(*args, _real=real, _name=name, **kw):
                calls.append(_name)
                return _real(*args, **kw)

            monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("branch", list(RUNS))
def test_quantized_slice_matches_jax(monkeypatch, data, indexes, branch):
    kind, jax_index, index = indexes
    view = index._device_view()
    assert view.kind == ("scalar" if kind == "int8" else "pq")
    jr, tr = _rankings(data, branch)
    calls = _spy_kernels(monkeypatch)

    scored = index(tr)
    _assert_same(scored, jax_index(jr))
    want_kernel = KERNELS[view.kind][branch]
    assert calls == ([want_kernel] if want_kernel else [])
    plan = index._get_plan(tr)
    stream_key = "stream" if view.kind == "scalar" else "stream_pq"
    assert (stream_key in plan) == (want_kernel is not None)

    _assert_same(index.serve(tr, 0.2, 10), jax_index.serve(jr, 0.2, 10))
    # warm calls reuse the plan and agree with the cold call
    assert index(tr) == scored


def test_fault_3d_int8_table_streams(data, indexes):
    """A 3D ``(N_pad, dim/128, 128)`` int8 table streams on dense candidate
    sets (the 2D-only ``shape[1] % 128`` test never streamed it), while PQ
    codes stream only above one pair per 200 rows."""
    kind, jax_index, index = indexes
    _, tr = _rankings(data, "cap_le_r")
    index(tr)
    view = index._device_view()
    if kind == "int8":
        assert view.table.ndim == 3 and view.table.shape[1:] == (DIM // 128, 128)
    assert "stream" in index._get_plan(tr) or "stream_pq" in index._get_plan(tr)
    # 10 pairs: above one pair per 500 rows, below one per 200
    run = {f"q{i}": {f"p{j}": 1.0 for j in range(5 * i, 5 * i + 5)} for i in range(2)}
    small = ft.Ranking.from_run(run, queries={q: f"query {q[1:]}" for q in run})
    index(small)
    plan = index._get_plan(small)
    if kind == "int8":
        assert "stream" in plan
    else:
        assert "stream_pq" not in plan and "grouped_idx" in plan
    jr = fj.Ranking.from_run(run, queries={q: f"query {q[1:]}" for q in run})
    _assert_same(index(small), jax_index(jr))


@pytest.mark.parametrize("indexes", ["int8"], indirect=True)
def test_fault_dense_int8_tiles_route_to_k2(monkeypatch, data, indexes):
    """An int8 layout with ``cap > r`` goes to K2 (``stream_select``) and not
    to K1, as ``fastforward_tpu/ops/stream_kernel.py:242-253`` routes it."""
    _, _, index = indexes
    calls = _spy_kernels(monkeypatch)
    _, tr = _rankings(data, "cap_gt_r")
    index(tr)
    cand3 = index._get_plan(tr)["stream"][0]
    assert cand3.shape[1] * 128 > sk.KERNEL_TILE_ROWS
    assert calls == ["stream_select"]


def test_fault_quantized_serve_ignores_refine(monkeypatch, data, indexes):
    """A quantized index serves without the bf16 preselect and its exact
    rescore (``tests/test_serve.py:136``): ``refine`` changes nothing."""
    _, jax_index, index = indexes
    jr, tr = _rankings(data, "cap_le_r")
    refine_calls = []
    real = ops.serve_topk_refine
    monkeypatch.setattr(
        ops, "serve_topk_refine", lambda *a, **kw: refine_calls.append(1) or real(*a, **kw)
    )
    got = index.serve(tr, 0.5, 5, refine=8)
    assert refine_calls == []
    _assert_same(got, index.serve(tr, 0.5, 5))
    _assert_same(got, jax_index.serve(jr, 0.5, 5, refine=8))


def test_index_from_codes_rejects_mismatched_codes(indexes):
    kind, jax_index, index = indexes
    codes = jax_index._store[:8]
    with pytest.raises(ValueError):
        convert.index_from_codes(
            codes[:, :-1], None, [f"p{i}" for i in range(8)], "PASSAGE", index.quantizer,
            device="cpu",
        )
    with pytest.raises(ValueError):
        convert.index_from_codes(
            codes.astype(np.float32), None, [f"p{i}" for i in range(8)], "PASSAGE",
            index.quantizer, device="cpu",
        )


@pytest.mark.parametrize("kind", ["int8", "PQ"])
def test_quantized_firstp_matches_jax(data, kind):
    """``Mode.FIRSTP`` (one row per document: its first passage) over the
    same codes, through the streamed branch."""
    corpus, by_text, runs = data
    jq = _QUANTIZERS[kind]()
    jq.fit(corpus[:1024])
    doc_ids = [f"d{i // 2}" for i in range(N)]
    psg_ids = [f"p{i}" for i in range(N)]
    jax_index = JaxInMemoryIndex(
        query_encoder=JaxLambdaEncoder(by_text.__getitem__), quantizer=jq, mode=JaxMode.FIRSTP
    )
    jax_index.add(corpus, doc_ids=doc_ids, psg_ids=psg_ids)
    index = convert.index_from_codes(
        jax_index._store[:N], doc_ids, psg_ids, JaxMode.FIRSTP,
        convert.quantizer_from_state(*jq.serialize(), device="cpu"),
        query_encoder=LambdaEncoder(by_text.__getitem__), device="cpu",
    )
    run = {
        q: {f"d{int(p[1:]) // 2}": s for p, s in cands.items()}
        for q, cands in runs["cap_le_r"].items()
    }
    queries = {q: f"query {q[1:]}" for q in run}
    jr, tr = fj.Ranking.from_run(run, queries=queries), ft.Ranking.from_run(run, queries=queries)
    _assert_same(index(tr), jax_index(jr))
    _assert_same(index.serve(tr, 0.2, 10), jax_index.serve(jr, 0.2, 10))
