"""The port on the card: CUDA kernel and CUDA index path (``-m gpu``).

These tests need an NVIDIA GPU and skip without one.  They import neither
JAX nor ``fastforward_tpu``, so they run on a machine that has only the
port's dependencies (``--noconftest`` skips the JAX test configuration)::

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import fastforward_tpu_torch as ft
from chip_smoke import (MIXED_QUERIES, TAIL_BLOCK_QUERIES, TAIL_BLOCK_ROWS, fp32_edge_tiles,
                        route_layout, tower_vocab, write_checkpoint)
from fastforward_tpu_torch import convert
from fastforward_tpu_torch.encoder import LambdaEncoder
from fastforward_tpu_torch.index import InMemoryIndex, Mode
from fastforward_tpu_torch.models import bert
from fastforward_tpu_torch.ops import scoring
from fastforward_tpu_torch.ops import stream_kernel as sk
from fastforward_tpu_torch.ops import stream_kernel_pq as skpq
from fastforward_tpu_torch.quantizer import OPQ, PQ, ScalarQuantizer

pytestmark = pytest.mark.gpu

REPO = Path(__file__).resolve().parent.parent

N_PAD, DIM, QB, P = 4096, 256, 16, 3000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


#: streamed layouts of the query-major kernels' card tests: random rows and
#: queries; every slot (padding too) on one query (``Qb = 1``); half-full
#: tiles, so that half of the slots pad on query ``Qb - 1`` as in the
#: flagship layouts; random rows over 5,000 queries (the grouping bins them
#: in three windows)
LAYOUTS = ["uniform", "one_query", "half_padding", "many_queries"]


def _layout(rng, layout: str, cap: int):
    """``(qb, cand3, tile_idx)`` of a streamed layout at ``cap`` (numpy)."""
    qb = {"one_query": 1, "many_queries": 5000}.get(layout, QB)
    if layout == "half_padding":
        p = N_PAD // sk.KERNEL_TILE_ROWS * cap // 2
    else:
        p = 6000 if cap > 512 else P
    rows = rng.integers(0, N_PAD, size=p)
    qno = rng.integers(0, qb, size=p)
    cand, tile_idx, _ = scoring.build_streamed_layout(rows, qno, N_PAD, qb, cap=cap)
    return qb, cand.reshape(cand.shape[0], cap // 128, 128), tile_idx


def _kernel_inputs(table_kind: str, seed: int, device, layout="uniform", cap=512):
    """Table, queries and a streamed layout for K1 (``cap <= r``) or K2."""
    rng = np.random.default_rng(seed)
    if table_kind == "int8":
        table = torch.from_numpy(rng.integers(-127, 128, size=(N_PAD, DIM // 128, 128)).astype(np.int8))
    else:
        table = torch.from_numpy(rng.standard_normal((N_PAD, DIM), dtype=np.float32))
        if table_kind == "bf16":
            table = table.to(torch.bfloat16)
    qb, cand3, tile_idx = _layout(rng, layout, cap)
    q = torch.from_numpy(rng.standard_normal((qb, DIM), dtype=np.float32))
    return [t.to(device) for t in (table, q, torch.from_numpy(cand3), torch.from_numpy(tile_idx))]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("table_kind", ["fp32", "bf16", "int8"])
def test_cuda_kernel_matches_plain(cuda, table_kind, exact, layout):
    """The CUDA kernel against the plain version on the same card tensors:
    the same products summed in another fp32 order (atol 1e-4, rtol 1e-5;
    atol 1e-3 for int8, as ``tests/test_stream_kernel.py:84,159``; and
    within the sum-order tolerance)."""
    args = _kernel_inputs(table_kind, 11, cuda, layout)
    before = sk.stream_select_pairwise.launches
    got = sk.stream_select_pairwise(*args, exact=exact)
    assert sk.stream_select_pairwise.launches == before + 1
    want = sk.stream_select_pairwise_plain(*args, exact=exact)
    atol = 1e-3 if table_kind == "int8" else 1e-4
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=atol, rtol=1e-5)
    table, q, cand3, tile_idx = args
    absdot = sk.stream_select_pairwise_plain(table.abs(), q.abs(), cand3, tile_idx, exact=exact)
    _assert_within_sum_order(got, want, absdot, DIM, atol=atol)


def test_cuda_wrapper_rejects_strided_tables(cuda):
    table, q, cand3, tile_idx = _kernel_inputs("fp32", 1, cuda)
    wide = torch.zeros((N_PAD, 2 * DIM), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        sk.stream_select_pairwise(wide[:, :DIM], q, cand3, tile_idx)
    with pytest.raises(ValueError, match="one device"):
        sk.stream_select_pairwise(table.cpu(), q, cand3, tile_idx)


@pytest.mark.parametrize("dim", [256, 896], ids=["dim256", "dim896"])
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("r", [512, 128], ids=["r512", "r128"])
@pytest.mark.parametrize("cap", [128, 256, 512, 1024])
def test_cuda_k1_fp32_edge_tiles(cuda, cap, r, exact, dim):
    """K1's fp32 body against its plain version on tiles that pin its
    shortcuts (``chip_smoke.fp32_edge_tiles``), at every cap from 128 to 1024
    with ``cap <= r`` and ``cap > r``, both tiers, one row chunk (dim 256)
    and two (dim 896); the padding query is not zero.  The same products
    summed in another fp32 order (atol 1e-4, rtol 1e-5, and within the
    sum-order tolerance)."""
    rng = np.random.default_rng(cap + r + dim)
    qb = 37
    table = torch.from_numpy(rng.standard_normal((N_PAD, dim), dtype=np.float32)).to(cuda)
    q = rng.standard_normal((qb, dim), dtype=np.float32)
    q[qb - 1] *= 3.0  # the padding query is a query like any other
    q = torch.from_numpy(q).to(cuda)
    cand, tile_idx = fp32_edge_tiles(rng, cap, r, qb, N_PAD // r)
    cand3 = torch.from_numpy(cand.reshape(8, cap // 128, 128)).to(cuda)
    tile_idx = torch.from_numpy(tile_idx).to(cuda)
    before = sk.stream_select_pairwise.launches
    got = sk.stream_select_pairwise(table, q, cand3, tile_idx, r=r, exact=exact)
    assert sk.stream_select_pairwise.launches == before + 1
    want = sk.stream_select_pairwise_plain(table, q, cand3, tile_idx, r=r, exact=exact)
    assert bool((want[1] != 0).all()), "the padding dot is zero: the case pins nothing"
    absdot = sk.stream_select_pairwise_plain(table.abs(), q.abs(), cand3, tile_idx, r=r, exact=exact)
    _assert_within_sum_order(got, want, absdot, dim)


@pytest.mark.parametrize("precision", ["high", "fast"])
def test_cuda_index_matches_cpu_index(cuda, precision):
    """Re-rank and fused serve on the card agree with the same index on the
    CPU (plain versions), and the card's path launches K1."""
    rng = np.random.default_rng(0)
    n, queries, depth = 8192, 24, 80
    corpus = rng.standard_normal((n, DIM), dtype=np.float32)
    qvecs = rng.standard_normal((queries, DIM), dtype=np.float32)
    by_text = {f"query {i}": qvecs[i] for i in range(queries)}
    run = {
        f"q{i}": {f"p{c}": float(depth - j) for j, c in enumerate(rng.choice(n, depth, replace=False))}
        for i in range(queries)
    }
    ranking = ft.Ranking.from_run(run, queries={f"q{i}": f"query {i}" for i in range(queries)})
    out = {}
    for device in ("cpu", "cuda"):
        index = InMemoryIndex(
            query_encoder=LambdaEncoder(by_text.__getitem__),
            mode=Mode.PASSAGE,
            precision=precision,
            device=device,
        )
        index.add(corpus, psg_ids=[f"p{i}" for i in range(n)])
        before = sk.stream_select_pairwise.launches
        out[device] = (index(ranking), index.serve(ranking, 0.2, 10, refine=22))
        launched = sk.stream_select_pairwise.launches - before
        assert launched == (2 if device == "cuda" else 0)
    for cpu_r, cuda_r in zip(out["cpu"], out["cuda"]):
        a, b = cpu_r._df, cuda_r._df
        np.testing.assert_array_equal(a["q_id"].astype(str), b["q_id"].astype(str))
        np.testing.assert_allclose(b["score"], a["score"], atol=1e-4, rtol=1e-5)
    np.testing.assert_array_equal(
        out["cpu"][1]._df["id"].astype(str), out["cuda"][1]._df["id"].astype(str)
    )


def _doc_workload(seed: int, n=8192, queries=24, depth=80):
    """A corpus of documents with 1-7 passages each, and a document run of
    ``queries`` x ``depth`` (at 8 rows per pair: cap 1024 over 512-row
    tiles, K1 fp32 at ``cap > r``)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 8, size=n)
    counts = counts[: int(np.searchsorted(np.cumsum(counts), n)) + 1]
    counts[-1] -= counts.sum() - n
    doc_ids = [f"d{d}" for d, c in enumerate(counts) for _ in range(c)]
    corpus = rng.standard_normal((n, DIM), dtype=np.float32)
    qvecs = rng.standard_normal((queries, DIM), dtype=np.float32)
    run = {
        f"q{i}": {f"d{c}": float(depth - j) for j, c in enumerate(rng.choice(len(counts), depth, replace=False))}
        for i in range(queries)
    }
    ranking = ft.Ranking.from_run(run, queries={f"q{i}": f"query {i}" for i in range(queries)})
    by_text = {f"query {i}": qvecs[i] for i in range(queries)}
    return corpus, doc_ids, by_text, ranking


def _assert_rankings_close(cpu_r, cuda_r):
    """The same rows in the same order; scores at atol 1e-4, rtol 1e-5 (fp32
    sums in another order)."""
    a, b = cpu_r._df, cuda_r._df
    for col in ("q_id", "id"):
        np.testing.assert_array_equal(a[col].astype(str), b[col].astype(str))
    np.testing.assert_allclose(b["score"], a["score"], atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("mode", ["MAXP", "AVEP"])
def test_cuda_doc_modes_match_cpu(cuda, mode):
    """Document re-rank and serve on the card (K1 fp32 at cap 1024 with the
    K-reduce on the card) against the same index on the CPU."""
    corpus, doc_ids, by_text, ranking = _doc_workload(3)
    out = {}
    for device in ("cpu", "cuda"):
        index = InMemoryIndex(
            query_encoder=LambdaEncoder(by_text.__getitem__), mode=Mode[mode], device=device
        )
        index.add(corpus, doc_ids=doc_ids)
        before = sk.stream_select_pairwise.launches
        out[device] = (index(ranking), index.serve(ranking, 0.2, 10))
        assert sk.stream_select_pairwise.launches - before == (2 if device == "cuda" else 0)
        cand3 = index._get_plan(ranking)["stream"][0]
        assert cand3.shape[1] * 128 > sk.KERNEL_TILE_ROWS
    for cpu_r, cuda_r in zip(out["cpu"], out["cuda"]):
        _assert_rankings_close(cpu_r, cuda_r)


def test_cuda_early_stopping_matches_cpu(cuda):
    """One early-stopping re-rank and serve on the card against the same
    index on the CPU: the same rows, scores within the fp32 tolerance."""
    corpus, doc_ids, by_text, ranking = _doc_workload(4, depth=200)
    kw = dict(early_stopping=10, early_stopping_alpha=0.2, early_stopping_depths=(20, 50, 200))
    out = {}
    for device in ("cpu", "cuda"):
        index = InMemoryIndex(
            query_encoder=LambdaEncoder(by_text.__getitem__), mode=Mode.MAXP, device=device
        )
        index.add(corpus, doc_ids=doc_ids)
        before = sk.stream_select_pairwise.launches
        out[device] = (index(ranking, **kw), index.serve(ranking, 0.2, 10, early_stopping_depths=(20, 200)))
        assert (sk.stream_select_pairwise.launches > before) == (device == "cuda")
    for cpu_r, cuda_r in zip(out["cpu"], out["cuda"]):
        _assert_rankings_close(cpu_r, cuda_r)


# -- K2, K3, K4 and the quantized index --------------------------------------------

M_PQ, KS, DS = 32, 256, 8


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("precision", ["exact", "high", "fast"])
@pytest.mark.parametrize("table_kind", ["fp32", "bf16", "int8"])
def test_cuda_k2_matches_plain(cuda, table_kind, precision, layout):
    """K2 against its plain version at cap > r (1024 slots per 512-row
    tile): the same products summed in another fp32 order (atol 1e-4,
    rtol 1e-5; atol 1e-3 for int8; and within the sum-order tolerance)."""
    table, q, cand3, tile_idx = _kernel_inputs(table_kind, 12, cuda, layout, cap=1024)
    before = sk.stream_select.launches
    got = sk.stream_select(table, q.t(), cand3, tile_idx, precision=precision)
    assert sk.stream_select.launches == before + 1
    want = sk.stream_select_plain(table, q.t(), cand3, tile_idx, precision=precision)
    atol = 1e-3 if table_kind == "int8" else 1e-4
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=atol, rtol=1e-5)
    absdot = sk.stream_select_plain(table.abs(), q.abs().t(), cand3, tile_idx, precision=precision)
    _assert_within_sum_order(got, want, absdot, DIM, atol=atol)


def test_cuda_k2_takes_wide_rows(cuda):
    """K2 holds only its query in shared memory, so rows of any width run:
    here fp32 rows of 16 KB (dim 4096)."""
    rng = np.random.default_rng(17)
    dim = 4096
    table = torch.from_numpy(rng.standard_normal((N_PAD, dim // 128, 128), dtype=np.float32)).to(cuda)
    qb, cand3, tile_idx = _layout(rng, "half_padding", 1024)
    q = torch.from_numpy(rng.standard_normal((qb, dim), dtype=np.float32)).to(cuda)
    cand3, tile_idx = torch.from_numpy(cand3).to(cuda), torch.from_numpy(tile_idx).to(cuda)
    got = sk.stream_select(table, q.t(), cand3, tile_idx)
    want = sk.stream_select_plain(table, q.t(), cand3, tile_idx)
    absdot = sk.stream_select_plain(table.abs(), q.abs().t(), cand3, tile_idx)
    _assert_within_sum_order(got, want, absdot, dim, atol=1e-3)


def _pq_inputs(cap: int, seed: int, device, m=M_PQ, ks=KS, ds=DS, layout="uniform"):
    """Codes, codebooks, queries and a streamed layout (one of ``LAYOUTS``)
    at ``cap``."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, ks, size=(N_PAD, m)).astype(np.uint8)
    cb = rng.standard_normal((m, ks, ds), dtype=np.float32)
    qb, cand3, tile_idx = _layout(rng, layout, cap)
    q = rng.standard_normal((qb, m * ds), dtype=np.float32)
    return [torch.from_numpy(a).to(device) for a in (codes, cb, q, cand3, tile_idx)]


def _assert_within_sum_order(got, want, absdot, dim, atol=1e-4):
    """Two fp32 sums of the same products in different orders: the error
    grows like ``sqrt(dim) * 2^-24 * sum|terms|``, with a factor 8 of
    headroom (``chip_smoke.sum_order_tol``); and within ``atol``, rtol
    1e-5."""
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=atol, rtol=1e-5)
    tol = 8.0 * dim**0.5 * 2.0**-24 * absdot
    err = (got - want).abs()
    assert bool(torch.isfinite(got).all())
    assert bool((err <= tol).all()), f"max err {err.max().item()}, tol there {tol.flatten()[err.argmax()].item()}"


#: (M, Ks, Ds): the first case's dim 256; then dim 768 with Ks 16 and 256,
#: M = 24 (4-byte code loads), 96 (the flagship, one LUT chunk) and 384
#: (the LUT in four chunks of 96 subspaces); M = 6 takes single-byte loads
PQ_SHAPES = [(32, 256, 8), (24, 256, 32), (96, 16, 8), (96, 256, 8), (384, 256, 2), (6, 16, 128)]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape", PQ_SHAPES, ids=lambda s: "m%d_ks%d" % s[:2])
@pytest.mark.parametrize("precision", ["exact", "high", "fast"])
def test_cuda_k3_k4_match_plain(cuda, precision, shape, layout):
    """K3 (cap <= r) and K4 (cap > r) against their plain versions (fp32
    sums in another order), each call one launch of its wrapper."""
    m, ks, ds = shape
    exact = precision != "fast"
    codes, cb, q, cand3, tile_idx = _pq_inputs(512, 13, cuda, m, ks, ds, layout)
    before = skpq.stream_select_pq_pairwise.launches
    got = skpq.stream_select_pq_pairwise(codes, cb, q, cand3, tile_idx, exact=exact)
    assert skpq.stream_select_pq_pairwise.launches == before + 1
    want = skpq.stream_select_pq_pairwise_plain(codes, cb, q, cand3, tile_idx, exact=exact)
    absdot = skpq.stream_select_pq_pairwise_plain(codes, cb.abs(), q.abs(), cand3, tile_idx, exact=exact)
    _assert_within_sum_order(got, want, absdot, m * ds)

    codes, cb, q, cand3, tile_idx = _pq_inputs(1024, 14, cuda, m, ks, ds, layout)
    before = skpq.stream_select_pq.launches
    got = skpq.stream_select_pq(codes, cb, q.t(), cand3, tile_idx, precision=precision)
    assert skpq.stream_select_pq.launches == before + 1
    want = skpq.stream_select_pq_plain(codes, cb, q.t(), cand3, tile_idx, precision=precision)
    absdot = skpq.stream_select_pq_plain(codes, cb.abs(), q.abs().t(), cand3, tile_idx, precision=precision)
    _assert_within_sum_order(got, want, absdot, m * ds)


@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_cuda_k3_k4_table_groups(cuda, monkeypatch, precision):
    """Lookup tables too large for one group (here 3 queries' worth) are
    built and consumed group by group, with the same scores."""
    m, ks, ds = 96, 256, 8
    monkeypatch.setattr(skpq, "ADC_TABLE_BYTES", 3 * m * 256 * 4)
    assert skpq.adc_table_queries(QB, m) == 3
    for cap, seed in ((512, 15), (1024, 16)):
        codes, cb, q, cand3, tile_idx = _pq_inputs(cap, seed, cuda, m, ks, ds, "half_padding")
        got = skpq.stream_select_pq(codes, cb, q.t(), cand3, tile_idx, precision=precision)
        want = skpq.stream_select_pq_plain(codes, cb, q.t(), cand3, tile_idx, precision=precision)
        absdot = skpq.stream_select_pq_plain(codes, cb.abs(), q.abs().t(), cand3, tile_idx,
                                             precision=precision)
        _assert_within_sum_order(got, want, absdot, m * ds)
        exact = precision == "exact"
        got = skpq.stream_select_pq_pairwise(codes, cb, q, cand3, tile_idx, exact=exact)
        want = skpq.stream_select_pq_pairwise_plain(codes, cb, q, cand3, tile_idx, exact=exact)
        _assert_within_sum_order(got, want, absdot, m * ds)


#: (M, Ks, Ds, code type) of wide codes: PQ(96, 1024) at dim 768 (uint16,
#: 24 subspaces a staged chunk, 16-byte loads of 8 codes); 4-byte loads
#: (M = 20) and single-code loads (M = 7, Ks = 1001: a table 1004 wide);
#: uint32 codes with 16-byte and single-code loads; Ks = 4096 (6 subspaces a
#: chunk, so the chunks shrink to whole 4-byte loads); and the global-memory
#: table body (Ks = 32,768 and 40,000: one subspace's table exceeds what a
#: block stages)
WIDE_PQ_SHAPES = [
    (96, 1024, 8, np.uint16), (20, 1000, 8, np.uint16), (7, 1001, 8, np.uint16),
    (16, 300, 8, np.uint32), (5, 300, 8, np.uint32), (48, 4096, 16, np.uint16),
    (8, 32768, 4, np.uint16), (3, 40000, 2, np.uint32),
]


@pytest.mark.parametrize("layout", ["uniform", "half_padding"])
@pytest.mark.parametrize(
    "shape", WIDE_PQ_SHAPES, ids=lambda s: "m%d_ks%d_%s" % (s[0], s[1], np.dtype(s[3]).name)
)
@pytest.mark.parametrize("precision", ["exact", "high", "fast"])
def test_cuda_k3_k4_wide_codes_match_plain(cuda, precision, shape, layout):
    """K3 and K4 on uint16 and uint32 codes (the staged and the global-memory
    table bodies) against their plain versions, one launch each, every code
    of the range in use."""
    m, ks, ds, dtype = shape
    for cap, seed in ((512, 21), (1024, 22)):
        rng = np.random.default_rng(seed)
        codes = rng.integers(0, ks, size=(N_PAD, m)).astype(dtype)
        codes[0] = ks - 1
        cb = rng.standard_normal((m, ks, ds), dtype=np.float32)
        qb, cand3, tile_idx = _layout(rng, layout, cap)
        q = rng.standard_normal((qb, m * ds), dtype=np.float32)
        codes, cb, q, cand3, tile_idx = [
            torch.from_numpy(a).to(cuda) for a in (codes, cb, q, cand3, tile_idx)
        ]
        assert codes.dtype == (torch.uint16 if dtype == np.uint16 else torch.uint32)
        if cap <= sk.KERNEL_TILE_ROWS:
            exact = precision != "fast"
            before = skpq.stream_select_pq_pairwise.launches
            got = skpq.stream_select_pq_pairwise(codes, cb, q, cand3, tile_idx, exact=exact)
            assert skpq.stream_select_pq_pairwise.launches == before + 1
            want = skpq.stream_select_pq_pairwise_plain(codes, cb, q, cand3, tile_idx, exact=exact)
            absdot = skpq.stream_select_pq_pairwise_plain(
                codes, cb.abs(), q.abs(), cand3, tile_idx, exact=exact
            )
        else:
            before = skpq.stream_select_pq.launches
            got = skpq.stream_select_pq(codes, cb, q.t(), cand3, tile_idx, precision=precision)
            assert skpq.stream_select_pq.launches == before + 1
            want = skpq.stream_select_pq_plain(codes, cb, q.t(), cand3, tile_idx, precision=precision)
            absdot = skpq.stream_select_pq_plain(
                codes, cb.abs(), q.abs().t(), cand3, tile_idx, precision=precision
            )
        torch.cuda.synchronize()
        _assert_within_sum_order(got, want, absdot, m * ds)


#: (M, Ks, Ds, code type) of the route cases: PQ(96, 256) and PQ(24, 256)
#: uint8 at dim 768, then every shape of ``WIDE_PQ_SHAPES``
ROUTE_SHAPES = [(96, 256, 8, np.uint8), (24, 256, 32, np.uint8), *WIDE_PQ_SHAPES]
#: the layouts: three of ``LAYOUTS`` (random pairs over 16 queries: a few
#: hundred slots a query; one query; half padding), a staged tail block
#: (512 queries of about 70 slots over 32,768 rows, the rest of 64 x 1024
#: slots padding) and a mixed one (half of the queries above the slot
#: limit, half below)
ROUTE_CASE_LAYOUTS = ["uniform", "half_padding", "one_query", "tail_block", "mixed"]


@pytest.mark.parametrize("layout", ROUTE_CASE_LAYOUTS)
@pytest.mark.parametrize(
    "shape", ROUTE_SHAPES, ids=lambda s: "m%d_ks%d_%s" % (s[0], s[1], np.dtype(s[3]).name)
)
@pytest.mark.parametrize("kernel,tier", [("K3", "exact"), ("K3", "fast"), ("K4", "exact"),
                                         ("K4", "high"), ("K4", "fast")])
def test_cuda_k3_k4_routes(cuda, kernel, tier, shape, layout):
    """K3 and K4 with every query forced to the table route and to the
    slot-wise route give the same bits, and so does each query on its own
    route (``"auto"``), which holds the plain version's tolerance; the
    routes the card takes are the Python mirror's (``adc_routes``)."""
    m, ks, ds, dtype = shape
    cap = 512 if kernel == "K3" else 1024
    limit = skpq.adc_slot_limit(ks, ds, torch.from_numpy(np.zeros(1, dtype)).dtype)
    rng = np.random.default_rng(31)
    n_pad = TAIL_BLOCK_ROWS if layout == "tail_block" else N_PAD
    codes = rng.integers(0, ks, size=(n_pad, m)).astype(dtype)
    codes[0] = ks - 1
    cb = rng.standard_normal((m, ks, ds), dtype=np.float32)
    if layout in ("tail_block", "mixed"):
        qb = TAIL_BLOCK_QUERIES if layout == "tail_block" else MIXED_QUERIES
        cand3, tile_idx = route_layout(rng, layout, n_pad, qb, sk.KERNEL_TILE_ROWS, cap, limit)
    else:
        qb, cand3, tile_idx = _layout(rng, layout, cap)
    q = rng.standard_normal((qb, m * ds), dtype=np.float32)
    codes, cb, q, cand3, tile_idx = [torch.from_numpy(a).to(cuda) for a in (codes, cb, q, cand3, tile_idx)]

    def call(cb_, q_, route=None):
        if kernel == "K3":
            args = (codes, cb_, q_, cand3, tile_idx)
            if route is None:
                return skpq.stream_select_pq_pairwise_plain(*args, exact=tier != "fast")
            return skpq.stream_select_pq_pairwise(*args, exact=tier != "fast", _route=route)
        args = (codes, cb_, q_.t(), cand3, tile_idx)
        if route is None:
            return skpq.stream_select_pq_plain(*args, precision=tier)
        return skpq.stream_select_pq(*args, precision=tier, _route=route)

    wrapper = skpq.stream_select_pq_pairwise if kernel == "K3" else skpq.stream_select_pq
    before = wrapper.launches
    table, slots, auto = call(cb, q, "table"), call(cb, q, "slots"), call(cb, q, "auto")
    assert wrapper.launches == before + 3
    torch.cuda.synchronize()
    assert torch.equal(table, slots)
    assert torch.equal(auto, table)
    _assert_within_sum_order(auto, call(cb, q), call(cb.abs(), q.abs()), m * ds)
    routes = skpq.adc_routes(cand3, qb, limit)
    want = skpq.adc_query_routes_plain(cand3.cpu(), qb, limit)
    assert torch.equal(routes.cpu(), want)
    if layout == "mixed" and limit < n_pad:
        assert {skpq.ROUTE_TABLE, skpq.ROUTE_SLOTS} <= set(want.tolist())


def test_cuda_wide_code_tensors(cuda):
    """The device ops the port runs on uint16 and uint32 code tables: zeros,
    host copies, slices, the signed-view gather."""
    for dtype, top in ((np.uint16, 65535), (np.uint32, 2**32 - 1)):
        host = np.array([[0, top], [top, 7], [5, 6]], dtype=dtype)
        table = torch.zeros((8, 2), dtype=torch.from_numpy(host).dtype, device=cuda)
        table[:3].copy_(torch.from_numpy(host))
        rows = torch.tensor([1, 0, 2, 7], device=cuda)
        got = skpq.gather_codes(table, rows)
        assert got.cpu().tolist() == [[top, 7], [0, top], [5, 6], [0, 0]]
        assert table[1:3].cpu().numpy().tolist() == host[1:].tolist()


def test_cuda_pq_1024_index_matches_cpu(cuda):
    """A PQ(16, 1024) index (uint16 codes) on the card launches K3 and K4 and
    agrees with the same codes scored on the CPU, re-rank and serve."""
    rng = np.random.default_rng(2)
    n, queries = 8192, 48
    corpus = rng.standard_normal((n, DIM), dtype=np.float32)
    qvecs = rng.standard_normal((queries, DIM), dtype=np.float32)
    by_text = {f"query {i}": qvecs[i] for i in range(queries)}
    quantizer = PQ(16, 1024, device="cpu")
    quantizer.fit(corpus[:4096])
    codes = quantizer.encode(corpus)
    assert codes.dtype == np.uint16
    for depth, kernel in ((80, skpq.stream_select_pq_pairwise), (200, skpq.stream_select_pq)):
        run = {
            f"q{i}": {f"p{c}": 1.0 for c in rng.choice(n, depth, replace=False)}
            for i in range(queries)
        }
        ranking = ft.Ranking.from_run(run, queries={f"q{i}": f"query {i}" for i in range(queries)})
        out = {}
        for device in ("cpu", "cuda"):
            index = convert.index_from_codes(
                codes, None, [f"p{i}" for i in range(n)], "PASSAGE", quantizer,
                query_encoder=LambdaEncoder(by_text.__getitem__), device=device,
            )
            before = kernel.launches
            out[device] = (index(ranking), index.serve(ranking, 0.2, 10))
            assert kernel.launches - before == (2 if device == "cuda" else 0)
        for got, want in zip(out["cuda"], out["cpu"]):
            np.testing.assert_array_equal(got._df["id"].astype(str), want._df["id"].astype(str))
            np.testing.assert_allclose(got._df["score"], want._df["score"], atol=1e-4, rtol=1e-5)


def test_cuda_two_shard_mesh_on_one_card(cuda):
    """A ``(1, 2)`` mesh of one card named twice: the streamed path
    launches K1 (and K3 for PQ codes) once per shard, the gather path runs
    per position, and both equal the single-table programs."""
    from fastforward_tpu_torch.parallel import MeshConfig, multihost, sharded

    rng = np.random.default_rng(3)
    n, qb = 8192, 16
    table = rng.standard_normal((n, DIM), dtype=np.float32)
    q = rng.standard_normal((qb, DIM), dtype=np.float32)
    mesh = MeshConfig(data=1, shard=2).build(devices=[cuda, cuda])
    st = sharded.ShardedTable.from_reader(mesh, (n, DIM), lambda a, b: table[a:b])
    whole = torch.from_numpy(table).to(cuda)
    rows = rng.integers(0, n, size=6000)
    qno = rng.integers(0, qb, size=6000)
    before = sk.stream_select_pairwise.launches
    got = sharded.streamed_scores_sharded(mesh, st, q, rows, qno, plan={})
    assert sk.stream_select_pairwise.launches == before + 2
    want = scoring.streamed_scores(whole, q, rows, qno)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)
    k, s_b = 4, 512
    idx = np.zeros((k + 1, s_b), dtype=np.int32)
    idx[:k] = rng.integers(0, n, size=(k, s_b))
    idx[k] = (rng.integers(0, qb, size=s_b) << 8) | rng.integers(1, k + 1, size=s_b)
    got = sharded.score_pairs_sharded(mesh, st, q, idx, "max")
    want = scoring.score_pairs_grouped(whole, torch.from_numpy(q).to(cuda), torch.from_numpy(idx).to(cuda), "max")
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)
    m, ks = 32, 1024
    codes = rng.integers(0, ks, size=(n, m)).astype(np.uint16)
    cb = rng.standard_normal((m, ks, DIM // m), dtype=np.float32)
    sc = sharded.ShardedTable.from_reader(mesh, (n, m), lambda a, b: codes[a:b])
    rep = multihost.put_replicated(mesh, cb)
    before = skpq.stream_select_pq_pairwise.launches
    got = sharded.streamed_scores_sharded_pq(mesh, sc, rep, q, rows, qno, plan={})
    assert skpq.stream_select_pq_pairwise.launches == before + 2
    want = scoring.streamed_scores_pq(
        torch.from_numpy(codes).to(cuda), rep.on(mesh.first_device), q, rows, qno
    )
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


def test_cuda_hybrid_budget_on_a_card_named_twice(cuda):
    """``hbm_budget`` bounds the card's memory when a ``(1, 2)`` mesh names
    it twice: the two shards of the resident prefix and the card's one
    tail-block cache together stay within the budget, and the scores equal
    the whole table's."""
    from fastforward_tpu_torch.index.base import build_hybrid_view
    from fastforward_tpu_torch.parallel import MeshConfig

    rng = np.random.default_rng(4)
    n, dim, qb, budget = 65536, 768, 16, 32 << 20
    table = rng.standard_normal((n, dim), dtype=np.float32)
    q_pad = rng.standard_normal((qb, dim), dtype=np.float32)
    rows = np.arange(n, dtype=np.int64)
    qno = rng.integers(0, qb, size=n)
    want = scoring.streamed_scores(torch.from_numpy(table).to(cuda), q_pad, rows, qno)
    mesh = MeshConfig(data=1, shard=2).build(devices=[cuda, cuda])
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    view = build_hybrid_view(table, n, dim, budget, "high", cuda, chunk_rows=2048, mesh=mesh)
    assert view is not None and view.mesh is mesh and view.tail_start == 2 * 3072
    assert torch.cuda.memory_allocated() - base <= budget
    for _ in range(2):  # the second call fills the card's block cache
        got = InMemoryIndex._hybrid_scores(view, q_pad, rows, qno, None, None)
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-5)
    torch.cuda.synchronize()
    assert view.aux.get("tail_blocks"), "no tail block was cached"
    assert torch.cuda.memory_allocated() - base <= budget
    plan: dict = {}
    InMemoryIndex._hybrid_scores(view, q_pad, rows, qno, plan, None)
    assert plan["hybrid"]["devices"] == [torch.device("cuda", 0)]


@pytest.mark.parametrize("kind", ["int8", "PQ", "OPQ"])
def test_cuda_quantized_index_launches_kernels(cuda, monkeypatch, kind):
    """A quantized index on the card launches its kernels and never a plain
    version, and agrees with the same codes scored on the CPU."""
    for module, name in (
        (sk, "stream_select_pairwise_plain"),
        (sk, "stream_select_plain"),
        (skpq, "stream_select_pq_pairwise_plain"),
        (skpq, "stream_select_pq_plain"),
    ):
        real = getattr(module, name)

        def guarded(*args, _real=real, _name=name, **kw):
            assert args[0].device.type == "cpu", f"{_name} ran on the card"
            return _real(*args, **kw)

        monkeypatch.setattr(module, name, guarded)
    rng = np.random.default_rng(1)
    n, queries = 4096, 48
    corpus = rng.standard_normal((n, DIM), dtype=np.float32)
    qvecs = rng.standard_normal((queries, DIM), dtype=np.float32)
    by_text = {f"query {i}": qvecs[i] for i in range(queries)}
    if kind == "int8":
        quantizer, dense, pairwise = ScalarQuantizer(), sk.stream_select, sk.stream_select_pairwise
    else:
        cls = PQ if kind == "PQ" else OPQ
        quantizer = cls(16, 16, **({"opq_iters": 2} if kind == "OPQ" else {}))
        dense, pairwise = skpq.stream_select_pq, skpq.stream_select_pq_pairwise
    quantizer.fit(corpus[:1024])
    codes = quantizer.encode(corpus)
    for depth, kernel in ((40, pairwise), (100, dense)):  # cap 256, cap 1024
        run = {
            f"q{i}": {f"p{c}": 1.0 for c in rng.choice(n, depth, replace=False)}
            for i in range(queries)
        }
        ranking = ft.Ranking.from_run(run, queries={f"q{i}": f"query {i}" for i in range(queries)})
        out = {}
        for device in ("cpu", "cuda"):
            index = convert.index_from_codes(
                codes, None, [f"p{i}" for i in range(n)], "PASSAGE", quantizer,
                query_encoder=LambdaEncoder(by_text.__getitem__), precision="exact", device=device,
            )
            before = kernel.launches
            out[device] = index(ranking)
            assert kernel.launches - before == (1 if device == "cuda" else 0)
        np.testing.assert_array_equal(
            out["cpu"]._df["id"].astype(str), out["cuda"]._df["id"].astype(str)
        )
        np.testing.assert_allclose(
            out["cuda"]._df["score"], out["cpu"]._df["score"], atol=1e-4, rtol=1e-5
        )


@pytest.mark.parametrize("cls", [PQ, OPQ], ids=["PQ", "OPQ"])
def test_cuda_fit_and_encode_match_cpu(cuda, monkeypatch, cls):
    """The k-means and the encode on the card against the same on the CPU,
    with TF32 matmuls allowed: fitted from the same seed on the same
    clustered data, the two encode at least 99% of held-out codes alike (a
    near-tie the two sums break differently moves a centroid slightly in
    every later iteration); with the same codebooks, at least 99.9%."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    rng = np.random.default_rng(5)
    m, ks, ds, n = 8, 64, 8, 8192
    centers = rng.normal(size=(m, ks, ds)).astype(np.float32) * 3
    pick = rng.integers(0, ks, size=(n, m))
    data = centers[np.arange(m)[None, :], pick].reshape(n, m * ds)
    data = (data + 0.3 * rng.normal(size=data.shape)).astype(np.float32)
    kw = {"opq_iters": 2} if cls is OPQ else {}
    on_card, on_cpu = cls(m, ks, device="cuda", **kw), cls(m, ks, device="cpu", **kw)
    on_card.fit(data[: n // 2])
    on_cpu.fit(data[: n // 2])
    held_out = data[n // 2 :]
    codes = on_card.encode(held_out)
    assert (codes == on_cpu.encode(held_out)).mean() >= 0.99
    same_books = cls.deserialize(*on_card.serialize())
    same_books.device = "cpu"
    assert (codes == same_books.encode(held_out)).mean() >= 0.999


# -- serving: the u16 transport, the BatchingServer, preload -----------------------


@pytest.mark.parametrize("case", ["normal", "inf_padded", "constant"])
def test_cuda_u16_encode_equals_cpu_bits(cuda, case):
    """The packed u16 buffer built on the card equals the CPU's bit for bit
    (header and codes), ``-inf`` padding included."""
    rng = np.random.default_rng(12)
    scores = (rng.standard_normal(300_001) * 40).astype(np.float32)
    if case == "inf_padded":
        scores[rng.choice(scores.shape[0], 50_000, replace=False)] = -np.inf
    elif case == "constant":
        scores[:] = 3.25
    cpu = scoring.encode_scores_u16(torch.from_numpy(scores))
    card = scoring.encode_scores_u16(torch.from_numpy(scores).cuda())
    assert card.dtype == torch.int16 and card.is_cuda
    np.testing.assert_array_equal(card.cpu().numpy(), cpu.numpy())


def test_cuda_batching_server_matches_serve(cuda):
    """A small BatchingServer run on the card: every request's result equals
    ``index.serve`` of it, through the array path, and K1 launched."""
    from fastforward_tpu_torch.utils.serving import BatchingServer

    rng = np.random.default_rng(5)
    n, queries = 8192, 24
    corpus = rng.standard_normal((n, DIM), dtype=np.float32)
    qvecs = rng.standard_normal((queries, DIM), dtype=np.float32)
    by_text = {f"query {i}": qvecs[i] for i in range(queries)}
    index = InMemoryIndex(query_encoder=LambdaEncoder(by_text.__getitem__), mode=Mode.PASSAGE)
    index.add(corpus, psg_ids=[f"p{i}" for i in range(n)])
    requests = []
    for r in range(12):
        q_ids = [f"r{r}-q{j}" for j in range(1 + r % 3)]
        run = {q: {f"p{c}": float(rng.standard_normal()) for c in rng.choice(n, 300, replace=False)}
               for q in q_ids}
        requests.append(ft.Ranking.from_run(run, queries={q: f"query {(r + j) % queries}"
                                                          for j, q in enumerate(q_ids)}))
    for refine in (None, 16):
        want = [index.serve(r, 0.2, 10, refine=refine) for r in requests]
        before = sk.stream_select_pairwise.launches
        with BatchingServer(index, 0.2, 10, max_batch_queries=8, max_wait_ms=5.0,
                            refine=refine) as server:
            server._dispatch_merged = lambda batch: (_ for _ in ()).throw(
                AssertionError("frame path used")
            )
            got = [f.result(timeout=120) for f in [server.submit(r) for r in requests]]
        assert sk.stream_select_pairwise.launches > before
        for g, w in zip(got, want):
            for col in ("q_id", "id"):
                np.testing.assert_array_equal(g._df[col].astype(str), w._df[col].astype(str))
            np.testing.assert_allclose(g._df["score"], w._df["score"], rtol=1e-5, atol=1e-5)


def test_cuda_preload_first_call_loads_k1(cuda):
    """In a fresh process, ``preload`` as the index's first call builds and
    loads K1 before any scoring call launches it; a warm preload launches it
    in both tiers and later calls load nothing new."""
    code = """
import numpy as np
from fastforward_tpu_torch import InMemoryIndex, Mode, Ranking
from fastforward_tpu_torch.encoder import LambdaEncoder
from fastforward_tpu_torch.ops import _build
from fastforward_tpu_torch.ops import stream_kernel as sk
rng = np.random.default_rng(0)
corpus = rng.standard_normal((8192, 256), dtype=np.float32)
q = rng.standard_normal(256, dtype=np.float32)
index = InMemoryIndex(query_encoder=LambdaEncoder(lambda _t: q), mode=Mode.PASSAGE)
index.add(corpus, psg_ids=[f"p{i}" for i in range(8192)])
assert "stream_select_pairwise" not in _build._libs
assert index.preload()
assert "stream_select_pairwise" in _build._libs, sorted(_build._libs)
assert sk.stream_select_pairwise.launches == 0
tiers = []
auto = sk.stream_select_auto
def recording(*args, precision="exact", **kwargs):  # 2D fp32 tables go to K1
    tiers.append(precision != "fast")
    return auto(*args, precision=precision, **kwargs)
sk.stream_select_auto = recording
assert index.preload(warm=(16, 200), serve=(0.2, 10, 8))
assert sorted(set(tiers)) == [False, True], tiers
assert sk.stream_select_pairwise.launches == len(tiers) >= 2 and not index._plans
stats = index._preload_stats
assert {"upload_s", "build_s", "warm_rerank_s", "warm_serve_s"} <= set(stats), stats
loaded = set(_build._libs)
run = {"q0": {f"p{i}": float(i) for i in range(0, 8192, 7)}}
out = index(Ranking.from_run(run, queries={"q0": "x"}))
assert set(_build._libs) == loaded
assert abs(out["q0"]["p0"] - float(corpus[0] @ q)) < 1e-3
print("ok")
"""
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=600
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


# -- the query towers --------------------------------------------------------------


def _tower_inputs(seed: int, batch: int, length: int, vocab: int = 1024):
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(0, vocab, size=(batch, length)))
    mask = torch.ones_like(ids)
    mask[1, length // 2 :] = 0
    return ids, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_tower_equals_cpu_tower(cuda, dtype):
    """The tiny tower on the card against the same weights on the CPU:
    fp32 within 1e-4 (both IEEE fp32, summed in other orders; TF32 would
    miss by ~1e-3), bf16 within eight bf16 steps of the largest output."""
    config = dataclasses.replace(bert.BertConfig.tiny(), dtype=dtype)
    tower = convert.bert_from_params(bert.init_params(config, seed=0), config)
    ids, mask = _tower_inputs(0, 4, 24)
    with torch.inference_mode():
        want = tower(ids, mask)
        got = tower.to(cuda)(ids.to(cuda), mask.to(cuda)).cpu()
    assert got.dtype == torch.float32
    if dtype == "float32":
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    else:
        torch.testing.assert_close(got, want, atol=8 * 2.0**-8 * want.abs().max().item(), rtol=0)


def test_cuda_fp32_tower_ignores_tf32(cuda):
    """With TF32 switched on process-wide, the fp32 tower at BERT-base
    width still runs its matmuls in IEEE fp32: its output equals the run
    with TF32 off and the CPU's within 1e-4, the flag is back on after the
    call, and (the control) an unguarded matmul on this card does change."""
    config = bert.BertConfig(vocab_size=1024, num_layers=2, max_position_embeddings=64)
    tower = convert.bert_from_params(bert.init_params(config, seed=1), config)
    ids, mask = _tower_inputs(1, 8, 36)
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        with torch.inference_mode():
            want = tower(ids, mask)
            tower.to(cuda)
            torch.backends.cuda.matmul.allow_tf32 = True
            on = tower(ids.to(cuda), mask.to(cuda)).cpu()
            assert torch.backends.cuda.matmul.allow_tf32 is True
            torch.backends.cuda.matmul.allow_tf32 = False
            off = tower(ids.to(cuda), mask.to(cuda)).cpu()
            x = torch.randn(1024, 768, device=cuda)
            w = torch.randn(768, 768, device=cuda)
            ref = x.double() @ w.double()
            ieee_err = ((x @ w).double() - ref).abs().max().item()
            torch.backends.cuda.matmul.allow_tf32 = True
            tf32_err = ((x @ w).double() - ref).abs().max().item()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    torch.testing.assert_close(on, off, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(on, want, atol=1e-4, rtol=1e-4)
    assert tf32_err > 10 * ieee_err, (tf32_err, ieee_err)


def test_cuda_tct_encoder_rerank_launches_k1(cuda, tmp_path):
    """A re-rank on the card with ``TCTColBERTQueryEncoder(device="cuda")``
    as the index's query encoder: the tower runs on the card, its vectors
    equal the CPU tower's, and the scoring launches K1 once with the dots
    of those vectors."""
    from transformers import BertConfig, BertModel

    from fastforward_tpu_torch.encoder import TCTColBERTQueryEncoder

    torch.manual_seed(0)
    model = BertModel(BertConfig(
        vocab_size=1024, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=256, max_position_embeddings=64,
    )).eval()
    path = write_checkpoint(tmp_path / "tct", model, tower_vocab(1024))
    encoder = TCTColBERTQueryEncoder(path, device="cuda", max_length=12)
    assert encoder.device.type == "cuda" and encoder._tower.q_w.is_cuda
    rng = np.random.default_rng(2)
    n, queries, depth = 4096, 16, 100
    corpus = rng.standard_normal((n, 128), dtype=np.float32)
    index = InMemoryIndex(query_encoder=encoder, mode=Mode.PASSAGE)
    index.add(corpus, psg_ids=[f"p{i}" for i in range(n)])
    texts = {f"q{i}": f"query {i}" for i in range(queries)}
    run = {q: {f"p{c}": float(-r) for r, c in enumerate(rng.choice(n, depth, replace=False))}
           for q in texts}
    before = sk.stream_select_pairwise.launches
    out = index(ft.Ranking.from_run(run, queries=texts))
    assert sk.stream_select_pairwise.launches - before == 1
    qvecs = encoder(list(texts.values()))
    cpu_vecs = TCTColBERTQueryEncoder(path, device="cpu", max_length=12)(list(texts.values()))
    np.testing.assert_allclose(qvecs, cpu_vecs, atol=1e-4, rtol=1e-4)
    assert len({v.tobytes() for v in qvecs}) == queries  # distinct queries
    for qi, q in enumerate(texts):
        for pid, score in out[q].items():
            want = float(corpus[int(pid[1:])].astype(np.float64) @ qvecs[qi])
            assert abs(score - want) <= 1e-4 * (1 + abs(want)), (q, pid, score, want)


# -- the hybrid tier, the device store and the 16-bit planes ------------------------


def _hybrid_pair(kind: str, mode: str, device, budget: int, chunk_rows: int):
    """A hybrid index of ``kind`` on ``device`` over a 32,768-row
    ``_doc_workload`` corpus (quantizers fitted on the CPU, so both devices
    hold one set of codes), with a run for ``mode``: 24 queries x 1,000
    passages, or x 300 documents."""
    corpus, doc_ids, by_text, ranking = _doc_workload(5, n=HYBRID_N, depth=300)
    quantizer = None
    if kind != "dense":
        quantizer = ScalarQuantizer() if kind == "int8" else PQ(M_PQ, KS, device="cpu")
        quantizer.fit(corpus[:4096])
        if kind == "pq":
            quantizer.device = device
    index = InMemoryIndex(
        query_encoder=LambdaEncoder(by_text.__getitem__), quantizer=quantizer, mode=Mode[mode],
        device=device, hbm_budget=budget, stream_chunk_rows=chunk_rows,
    )
    index.add(corpus, doc_ids=doc_ids, psg_ids=[f"p{i}" for i in range(HYBRID_N)])
    if mode == "PASSAGE":
        rng = np.random.default_rng(6)
        run = {
            q: {f"p{c}": float(1000 - j) for j, c in enumerate(rng.choice(HYBRID_N, 1000, replace=False))}
            for q in ranking.q_ids
        }
        ranking = ft.Ranking.from_run(run, queries={q: f"query {q[1:]}" for q in run})
    return index, ranking


HYBRID_N = 32768

#: per kind, a budget that leaves a resident prefix of 1,024 rows and a
#: device cache of two 512-row blocks
HYBRID_BUDGETS = {"dense": 2 << 20, "int8": 512 << 10, "pq": (256 << 10) + (64 << 10)}


@pytest.mark.parametrize("mode", ["PASSAGE", "MAXP"])
@pytest.mark.parametrize("kind", list(HYBRID_BUDGETS))
def test_cuda_hybrid_tail_blocks_match_cpu(cuda, kind, mode):
    """The hybrid tier on the card at 512-row blocks (dozens of chunks, so a
    staging buffer refilled before its copy landed would show) against the
    same hybrid index on the CPU (the plain versions): cold and warm
    re-ranks, scores at atol 1e-4, rtol 1e-5.  On the card every tail block
    launches the kernel its layout routes to (K1 for fp32 rows; K2 or K4 at
    ``cap > r``, K1 or K3 below), warm calls hit the device cache, and
    further calls reserve no more device memory."""
    from fastforward_tpu_torch.ops import host_stream

    wrappers = {
        "stream_select_pairwise": sk.stream_select_pairwise, "stream_select": sk.stream_select,
        "stream_select_pq_pairwise": skpq.stream_select_pq_pairwise,
        "stream_select_pq": skpq.stream_select_pq,
    }
    out = {}
    for device in ("cpu", "cuda"):
        index, ranking = _hybrid_pair(kind, mode, device, HYBRID_BUDGETS[kind], 512)
        view = index._device_view()
        assert view.kind == "hybrid" and view.tail_start == 1024
        before = {k: w.launches for k, w in wrappers.items()}
        host_stream.reset_stats()
        cold = index(ranking)
        warm = index(ranking)
        launched = {k: w.launches - before[k] for k, w in wrappers.items()}
        chunks = index._get_plan(ranking)["hybrid"]["chunks"]
        assert len(chunks) >= 24
        if device == "cuda":
            wide = [c["cand"].shape[1] * 128 > sk.KERNEL_TILE_ROWS for c in chunks]
            if kind == "dense":
                tail_kernels = {"stream_select_pairwise": len(chunks)}
            else:
                narrow_k, wide_k = (
                    ("stream_select_pairwise", "stream_select") if kind == "int8"
                    else ("stream_select_pq_pairwise", "stream_select_pq")
                )
                tail_kernels = {wide_k: sum(wide), narrow_k: len(chunks) - sum(wide)}
            for name, count in tail_kernels.items():
                assert launched[name] >= 2 * count, (name, launched)
            assert host_stream.STATS["block_cache_hits"] > 0
            # one copy stream for the view: later calls reuse its blocks
            reserved = torch.cuda.memory_reserved()
            for _ in range(3):
                index(ranking)
            assert torch.cuda.memory_reserved() == reserved
        else:
            assert not any(launched.values())
        _assert_pairs_close(cold, warm)
        out[device] = warm
    _assert_pairs_close(out["cpu"], out["cuda"])


#: the layouts of K1's fp32 split and the dense-dot routes: a staged tail
#: block (512 queries of about 70 slots over 32,768 rows, 64 x 1024 slots),
#: a mixed one (half of the queries above the pack limit, half below), the
#: small ``LAYOUTS`` and a flagship-like one (64 queries x depth 1000 over
#: 32,768 rows: every query far above the limit)
SPLIT_ROUTE_LAYOUTS = ["tail_block", "mixed", *LAYOUTS, "flagship_small"]


def _split_route_inputs(table_kind: str, layout: str, cap: int, device, seed: int = 41):
    """Table (fp32, bf16 or 3D int8 rows of ``DIM``), queries and a layout of
    ``SPLIT_ROUTE_LAYOUTS`` at ``cap`` on ``device``."""
    rng = np.random.default_rng(seed)
    n_pad = TAIL_BLOCK_ROWS if layout in ("tail_block", "flagship_small") else N_PAD
    if table_kind == "int8":
        table = torch.from_numpy(rng.integers(-127, 128, size=(n_pad, DIM // 128, 128)).astype(np.int8))
    else:
        table = torch.from_numpy(rng.standard_normal((n_pad, DIM), dtype=np.float32))
        if table_kind == "bf16":
            table = table.to(torch.bfloat16)
    if layout in ("tail_block", "mixed"):
        qb = TAIL_BLOCK_QUERIES if layout == "tail_block" else MIXED_QUERIES
        cand3, tile_idx = route_layout(rng, layout, n_pad, qb, sk.KERNEL_TILE_ROWS, cap,
                                       sk.DENSE_PACK_LIMIT)
    elif layout == "flagship_small":
        qb = 64
        rows = np.concatenate([rng.choice(n_pad, 1000, replace=False) for _ in range(qb)])
        cand, tile_idx, _ = scoring.build_streamed_layout(rows, np.repeat(np.arange(qb), 1000),
                                                          n_pad, qb, cap=cap)
        cand3 = cand.reshape(cand.shape[0], cap // 128, 128)
    else:
        qb, cand3, tile_idx = _layout(rng, layout, cap)
    q = torch.from_numpy(rng.standard_normal((qb, DIM), dtype=np.float32))
    return [t.to(device) for t in (table, q, torch.from_numpy(cand3), torch.from_numpy(tile_idx))]


@pytest.mark.parametrize("layout", SPLIT_ROUTE_LAYOUTS)
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("cap", [512, 1024])
def test_cuda_k1_fp32_splits(cuda, cap, exact, layout):
    """K1's fp32 body with each tile split over 1, 2, 3, 8 and 16 blocks and
    over ``tile_split``'s choice gives the same bits, which hold the plain
    version's tolerance; the tail block is split over 8 blocks on an H100
    SXM (7 on a PCIe card)."""
    table, q, cand3, tile_idx = _split_route_inputs("fp32", layout, cap, cuda)
    outs = {s: sk.stream_select_pairwise(table, q, cand3, tile_idx, exact=exact, _split=s)
            for s in (1, 2, 3, 8, sk.TILE_MAX_SPLIT)}
    before = sk.stream_select_pairwise.launches
    auto = sk.stream_select_pairwise(table, q, cand3, tile_idx, exact=exact)
    assert sk.stream_select_pairwise.launches == before + 1
    torch.cuda.synchronize()
    for split, out in outs.items():
        assert torch.equal(out, outs[1]), split
    assert torch.equal(auto, outs[1])
    want = sk.stream_select_pairwise_plain(table, q, cand3, tile_idx, exact=exact)
    absdot = sk.stream_select_pairwise_plain(table.abs(), q.abs(), cand3, tile_idx, exact=exact)
    _assert_within_sum_order(auto, want, absdot, DIM)
    if layout == "tail_block" and cap == 1024:
        assert sk.tile_split(cand3.shape[0], sk.sm_count(cuda)) > 1


@pytest.mark.parametrize("layout", SPLIT_ROUTE_LAYOUTS)
@pytest.mark.parametrize("kernel,table_kind,tier", [
    ("K1", "bf16", "exact"), ("K1", "bf16", "fast"), ("K1", "int8", "exact"), ("K1", "int8", "fast"),
    ("K2", "fp32", "exact"), ("K2", "fp32", "fast"), ("K2", "bf16", "high"), ("K2", "int8", "high"),
    ("K2", "int8", "fast"),
])
def test_cuda_dense_routes(cuda, kernel, table_kind, tier, layout):
    """The query-major body (K1's bf16 and int8 branches, K2) with every
    query on work items, every query packed, and each query on its own route
    (``"auto"``) gives the same bits, which hold the plain version's
    tolerance; the routes the card takes are the Python mirror's
    (``dense_routes``), and the tail block and mixed layouts take both."""
    cap = 512 if kernel == "K1" else 1024
    table, q, cand3, tile_idx = _split_route_inputs(table_kind, layout, cap, cuda)
    if kernel == "K2" and table_kind == "fp32":
        table = table.view(table.shape[0], DIM // 128, 128)

    def call(route=None, t=table, qq=q):
        if kernel == "K1":
            exact = tier != "fast"
            if route is None:
                return sk.stream_select_pairwise_plain(t, qq, cand3, tile_idx, exact=exact)
            return sk.stream_select_pairwise(t, qq, cand3, tile_idx, exact=exact, _route=route)
        if route is None:
            return sk.stream_select_plain(t, qq.t(), cand3, tile_idx, precision=tier)
        return sk.stream_select(t, qq.t(), cand3, tile_idx, precision=tier, _route=route)

    items, packed, auto = call("items"), call("packed"), call("auto")
    torch.cuda.synchronize()
    assert torch.equal(items, packed)
    assert torch.equal(auto, items)
    atol = 1e-3 if table_kind == "int8" else 1e-4
    _assert_within_sum_order(auto, call(), call(None, table.abs(), q.abs()), DIM, atol=atol)
    qb = q.shape[0]
    routes = sk.dense_routes(cand3, qb, sk.DENSE_PACK_LIMIT)
    want = sk.dense_query_routes_plain(cand3.cpu(), qb, sk.DENSE_PACK_LIMIT)
    assert torch.equal(routes.cpu(), want)
    if layout in ("tail_block", "mixed"):
        assert {sk.ROUTE_ITEMS, sk.ROUTE_PACKED} <= set(want.tolist())


@pytest.mark.parametrize("mode", ["PASSAGE", "MAXP"])
@pytest.mark.parametrize("kind", ["dense", "int8"])
def test_cuda_hybrid_tail_blocks_take_the_new_routes(cuda, kind, mode):
    """A hybrid passage or MAXP re-rank over fp32 or int8 rows on the card
    against the same index on the CPU (atol 1e-4, rtol 1e-5), with its tail
    blocks on the new routes: each fp32 block's few tiles split over
    several blocks, and the short queries of each int8 block packed."""
    from fastforward_tpu_torch.ops import host_stream

    out = {}
    for device in ("cpu", "cuda"):
        index, ranking = _hybrid_pair(kind, mode, device, HYBRID_BUDGETS[kind], 512)
        out[device] = index(ranking)
        if device == "cuda":
            chunks = index._get_plan(ranking)["hybrid"]["chunks"]
            qb = index._get_plan(ranking)["hybrid"]["res_plan"]["q_dev"][1].shape[0]
            if kind == "dense":
                assert all(sk.tile_split(c["cand"].shape[0], sk.sm_count(cuda)) > 1 for c in chunks)
            else:  # K1 (cap <= r) and K2 alike
                packed = [int((sk.dense_routes(c["cand"], qb, sk.DENSE_PACK_LIMIT)
                               == sk.ROUTE_PACKED).sum()) for c in chunks]
                assert all(n > 0 for n in packed), packed
        host_stream.reset_stats()
    _assert_pairs_close(out["cpu"], out["cuda"])


def _assert_pairs_close(cpu_r, cuda_r):
    """The same (query, id) pairs, scores at atol 1e-4, rtol 1e-5, compared
    pair by pair (PQ codes tie often, and fp32 sums in another order may
    swap two tied rows)."""
    a, b = (r._df.sort_values(["q_id", "id"]) for r in (cpu_r, cuda_r))
    for col in ("q_id", "id"):
        np.testing.assert_array_equal(a[col].astype(str), b[col].astype(str))
    np.testing.assert_allclose(b["score"], a["score"], atol=1e-4, rtol=1e-5)


def test_cuda_hybrid_contiguous_tail_blocks(cuda):
    """A candidate set of every row streams contiguous blocks (views of the
    tail, copied through the staging buffers): scores equal the
    whole-table index on the card, cold and warm."""
    from fastforward_tpu_torch.ops import host_stream

    rng = np.random.default_rng(7)
    n = 8192
    corpus = rng.standard_normal((n, DIM), dtype=np.float32)
    q = rng.standard_normal(DIM, dtype=np.float32)
    run = {"q0": {f"p{i}": float(i) for i in range(n)}}
    ranking = ft.Ranking.from_run(run, queries={"q0": "x"})
    results = []
    for kwargs in ({}, {"hbm_budget": 4 << 20, "stream_chunk_rows": 1024}):
        index = InMemoryIndex(query_encoder=LambdaEncoder(lambda _t: q), mode=Mode.PASSAGE, **kwargs)
        index.add(corpus, psg_ids=[f"p{i}" for i in range(n)])
        results.append(index(ranking))
    chunks = index._get_plan(ranking)["hybrid"]["chunks"]
    assert len(chunks) >= 4 and all(host_stream._chunk_contiguous(c) for c in chunks)
    _assert_rankings_close(*results)
    _assert_rankings_close(results[0], index(ranking))


def test_cuda_planes_round_trip(cuda):
    """The 16-bit planes on the card: hi | lo rebuilds every fp32 bit
    pattern (infinities, NaN, signed zeros, subnormals), hi alone is the
    truncation, and padded rows are zero."""
    from fastforward_tpu_torch.ops.upload import combine_lo, expand_hi, upload_plane

    host = np.random.default_rng(8).standard_normal((1000, DIM)).astype(np.float32)
    host[0, :6] = [np.inf, -np.inf, np.nan, 0.0, -0.0, np.float32(1e-42)]
    hi = upload_plane(host, "hi", cuda, total_rows=1024, chunk_bytes=100 * DIM * 2)
    lo = upload_plane(host, "lo", cuda, total_rows=1024, chunk_bytes=100 * DIM * 2)
    trunc = expand_hi(hi)
    full = combine_lo(trunc, lo).cpu().numpy()
    np.testing.assert_array_equal(full[:1000].view(np.uint32), host.view(np.uint32))
    np.testing.assert_array_equal(full[1000:], 0.0)
    want = host.view(np.uint32) & np.uint32(0xFFFF0000)
    np.testing.assert_array_equal(trunc.cpu().numpy()[:1000].view(np.uint32), want)


@pytest.mark.parametrize("kind", ["dense", "int8", "pq"])
def test_cuda_device_store_adds_and_reads_back(cuda, kind):
    """``store="device"``: adds in batches that grow the device buffer; the
    rows read back bit for bit, and re-rank and serve equal the host store's
    index on the card."""
    corpus, doc_ids, by_text, ranking = _doc_workload(9)
    n = corpus.shape[0]
    quantizer = None
    if kind != "dense":
        quantizer = ScalarQuantizer() if kind == "int8" else PQ(M_PQ, KS, device="cpu")
        quantizer.fit(corpus[:4096])
        if kind == "pq":
            quantizer.device = cuda
    out = {}
    for store in ("host", "device"):
        index = InMemoryIndex(
            query_encoder=LambdaEncoder(by_text.__getitem__), quantizer=quantizer, mode=Mode.MAXP,
            store=store, init_size=1000, alloc_size=3000,
        )
        for lo in range(0, n, 1500):
            index.add(corpus[lo : lo + 1500], doc_ids=doc_ids[lo : lo + 1500])
        out[store] = index
    host, dev = out["host"], out["device"]
    assert dev._store is None and dev._dev_table.device.type == "cuda"
    ids = sorted(set(doc_ids))[::7]
    np.testing.assert_array_equal(dev._get_vectors(ids)[0], host._get_vectors(ids)[0])
    _assert_rankings_close(host(ranking), dev(ranking))
    _assert_rankings_close(host.serve(ranking, 0.2, 10), dev.serve(ranking, 0.2, 10))


def test_cuda_progressive_preload(cuda, monkeypatch):
    """``preload(progressive=True)`` on the card: the truncated table serves
    first (within the bf16 tier's error), then ``preload_join`` installs the
    exact table, whose scores equal the standard upload's."""
    import fastforward_tpu_torch.index.memory as memory

    monkeypatch.setattr(memory, "_MIN_PROGRESSIVE_BYTES", 0)
    corpus, doc_ids, by_text, ranking = _doc_workload(10)
    indexes = []
    for _ in range(2):
        index = InMemoryIndex(query_encoder=LambdaEncoder(by_text.__getitem__), mode=Mode.MAXP)
        index.add(corpus, doc_ids=doc_ids)
        indexes.append(index)
    want = indexes[0](ranking)
    index = indexes[1]
    assert index.preload(warm=(8, 50), progressive=True)
    assert index._preload_stats["progressive"] is True
    interim = index(ranking)

    def by_pair(r):
        return r._df.sort_values(["q_id", "id"])["score"].to_numpy()

    np.testing.assert_allclose(by_pair(interim), by_pair(want), rtol=5e-3, atol=5e-2)
    assert index.preload_join(timeout=60)
    assert index._preload_stats["progressive_exact"] is True
    table = index._device_view().table[: corpus.shape[0]].cpu().numpy()
    np.testing.assert_array_equal(table, corpus)
    _assert_rankings_close(want, index(ranking))
