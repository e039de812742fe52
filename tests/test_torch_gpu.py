"""The port on the card: CUDA kernel and CUDA index path (``-m gpu``).

These tests need an NVIDIA GPU and skip without one.  They import neither
JAX nor ``fastforward_tpu``, so they run on a machine that has only the
port's dependencies (``--noconftest`` skips the JAX test configuration)::

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

import fastforward_tpu_torch as ft
from fastforward_tpu_torch import convert
from fastforward_tpu_torch.encoder import LambdaEncoder
from fastforward_tpu_torch.index import InMemoryIndex, Mode
from fastforward_tpu_torch.ops import scoring
from fastforward_tpu_torch.ops import stream_kernel as sk
from fastforward_tpu_torch.ops import stream_kernel_pq as skpq
from fastforward_tpu_torch.quantizer import OPQ, PQ, ScalarQuantizer

pytestmark = pytest.mark.gpu

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
