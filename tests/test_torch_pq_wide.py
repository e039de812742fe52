"""PQ codes wider than uint8 (Ks > 256) in the port against ``fastforward_tpu``.

K3 and K4's plain versions (what the wrappers run for CPU tensors) read
uint16 and uint32 code tables; they are held slot for slot against the
Pallas kernels in ``interpret=True`` on the same numpy inputs (the Pallas
kernels cast any code type to int32), at the tolerance of
``tests/test_stream_kernel.py:322``.  A ``PQ(8, 1024)`` index (10-bit codes,
stored as uint16) on the port is held against the JAX index with the same
codes (``convert.index_from_codes``), on the streamed, gather and hybrid
paths.  The CUDA bodies for wide codes, the global-memory table body
included, are held against the plain versions by ``tests/test_torch_gpu.py``
and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastforward_tpu as fj
import fastforward_tpu_torch as ft
from fastforward_tpu.encoder import LambdaEncoder as JaxLambdaEncoder
from fastforward_tpu.index import InMemoryIndex as JaxInMemoryIndex
from fastforward_tpu.index import Mode as JaxMode
from fastforward_tpu.ops import scoring as jscoring
from fastforward_tpu.ops import stream_kernel_pq as jskpq
from fastforward_tpu.quantizer import PQ as JaxPQ
from fastforward_tpu_torch import convert
from fastforward_tpu_torch.encoder import LambdaEncoder
from fastforward_tpu_torch.index import InMemoryIndex
from fastforward_tpu_torch.ops import scoring
from fastforward_tpu_torch.ops import stream_kernel_pq as skpq

N_PAD, M, KS, DS, QB, P = 2048, 8, 1024, 16, 8, 2000
R = skpq.KERNEL_PQ_TILE_ROWS


def _inputs(cap: int, code_dtype=np.uint16, ks: int = KS, seed: int = 3):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, ks, size=(N_PAD, M)).astype(code_dtype)
    cb = rng.normal(size=(M, ks, DS)).astype(np.float32)
    q = rng.normal(size=(QB, M * DS)).astype(np.float32)
    rows = rng.integers(0, N_PAD, size=P).astype(np.int64)
    qno = rng.integers(0, QB, size=P).astype(np.int64)
    cand, tile_idx, slot = scoring.build_streamed_layout(rows, qno, N_PAD, QB, r=R, cap=cap)
    cand3 = cand.reshape(cand.shape[0], cap // 128, 128)
    deq = cb[np.arange(M)[None, :], codes[rows].astype(np.int64)].astype(np.float64)
    expected = np.einsum("pmd,pmd->p", deq, q.reshape(QB, M, DS)[qno].astype(np.float64))
    return codes, cb, q, cand3, tile_idx, slot, expected


def _jax_args(codes, cb):
    bd_hi, bd_mid, bd_lo = jskpq.build_blockdiag_codebooks(cb)
    codes_p = jscoring._pad_pq_codes(jnp.asarray(codes), jskpq.M_PAD)
    return codes_p, jnp.asarray(bd_hi), jnp.asarray(bd_mid), jnp.asarray(bd_lo)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_k3_uint16_plain_matches_pallas_interpret():
    """K3 at cap <= r on uint16 codes (Ks = 1024): the plain version against
    ``stream_select_pq_pairwise(interpret=True)`` at atol 1e-5 / rtol 1e-6,
    and against the float64 decode-then-dot."""
    codes, cb, q, cand3, tile_idx, slot, expected = _inputs(cap=512)
    want = np.asarray(
        jskpq.stream_select_pq_pairwise(
            *_jax_args(codes, cb), q, cand3, tile_idx, m=M, r=R, interpret=True, exact=True
        )
    )
    tc, tcb, tq, tcand, ttile = _torch(codes, cb, q, cand3, tile_idx)
    assert tc.dtype == torch.uint16
    got = skpq.stream_select_pq_pairwise(tc, tcb, tq, tcand, ttile, r=R).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(got.reshape(-1)[slot], expected, atol=1e-5, rtol=1e-6)


def test_k4_uint16_plain_matches_pallas_interpret():
    """K4 at cap > r on uint16 codes, the exact tier, as K3's test."""
    codes, cb, q, cand3, tile_idx, slot, expected = _inputs(cap=1024, seed=5)
    assert cand3.shape[1] * 128 > R
    q_t = np.ascontiguousarray(q.T)
    want = np.asarray(
        jskpq.stream_select_pq(
            *_jax_args(codes, cb), q_t, cand3, tile_idx, m=M, r=R, interpret=True,
            precision="exact",
        )
    )
    tc, tcb, tq, tcand, ttile = _torch(codes, cb, q, cand3, tile_idx)
    got = skpq.stream_select_pq(tc, tcb, tq.t(), tcand, ttile, r=R).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(got.reshape(-1)[slot], expected, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("ks", [300, 1 << 16], ids=["ks300", "ks65536"])
def test_wide_codes_plain_match_float64(ks):
    """uint32 codes (Ks = 300) and uint16 codes at the top of their range
    (Ks = 65,536, the last codeword used): both plain versions against the
    float64 decode-then-dot at atol 1e-5 / rtol 1e-6."""
    dtype = np.uint32 if ks == 300 else np.uint16
    codes, cb, q, cand3, tile_idx, slot, expected = _inputs(cap=512, code_dtype=dtype, ks=ks)
    if ks == 1 << 16:
        codes[:4] = ks - 1
    tc, tcb, tq, tcand, ttile = _torch(codes, cb, q, cand3, tile_idx)
    rows = np.repeat(tile_idx, cand3.shape[1] * 128)[slot] * R + cand3.reshape(-1)[slot] // QB
    deq = cb[np.arange(M)[None, :], codes[rows].astype(np.int64)].astype(np.float64)
    expected = np.einsum("pmd,pmd->p", deq, q.reshape(QB, M, DS)[cand3.reshape(-1)[slot] % QB])
    k3 = skpq.stream_select_pq_pairwise(tc, tcb, tq, tcand, ttile, r=R).numpy().reshape(-1)
    k4 = skpq.stream_select_pq(tc, tcb, tq.t(), tcand, ttile, r=R).numpy().reshape(-1)
    np.testing.assert_allclose(k3[slot], expected, atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(k4[slot], expected, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize(
    "case", ["codes_int16", "codes_int32", "uint16_ks_over_65536", "codes_fp32"]
)
def test_wrappers_reject_codes_they_cannot_read(case):
    """Signed codes and float codes raise ``TypeError``; a codebook larger
    than the code type addresses raises ``ValueError``."""
    codes, cb, q, cand3, tile_idx, _, _ = _inputs(cap=512)
    c, b, qq, cd, ti = _torch(codes, cb, q, cand3, tile_idx)
    err = TypeError
    if case == "codes_int16":
        c = c.view(torch.int16)
    elif case == "codes_int32":
        c = c.to(torch.int32)
    elif case == "codes_fp32":
        c = c.to(torch.float32)
    else:
        b, err = torch.zeros((M, (1 << 16) + 1, DS)), ValueError
    with pytest.raises(err):
        skpq.stream_select_pq_pairwise(c, b, qq, cd, ti)
    with pytest.raises(err):
        skpq.stream_select_pq(c, b, qq.t(), cd, ti)


def test_gather_codes_reads_unsigned():
    """The plain versions' code gather reads the full unsigned range of each
    type (through the signed view)."""
    for dtype, top in ((np.uint8, 255), (np.uint16, 65535), (np.uint32, 2**32 - 1)):
        codes = torch.from_numpy(np.array([[0, top], [top, 1]], dtype=dtype))
        got = skpq.gather_codes(codes, torch.tensor([1, 0, 1]))
        assert got.dtype == torch.int64
        assert got.tolist() == [[top, 1], [0, top], [top, 1]]


@pytest.mark.parametrize(
    "ks,code_dtype,width,queries",
    [
        (256, torch.uint8, 256, 512),
        (1024, torch.uint16, 1024, 170),
        (1000, torch.uint16, 1000, 174),
        (1001, torch.uint16, 1004, 174),
        (32768, torch.uint16, 32768, 5),
    ],
)
def test_adc_table_width_and_groups(ks, code_dtype, width, queries):
    """A subspace's table is 256 wide for uint8 codes and Ks rounded up to 4
    otherwise; the groups of queries keep the tables within
    ``ADC_TABLE_BYTES`` (PQ(96, 1024): 170 queries of 393 KB a group, so
    512 queries take 4 groups and 67 MB of scratch, not 201 MB)."""
    assert skpq.adc_table_width(ks, code_dtype) == width
    got = skpq.adc_table_queries(512, 96, width)
    assert got == queries
    assert got * 96 * width * 4 <= skpq.ADC_TABLE_BYTES


# -- a PQ(8, 1024) index on the port against the JAX index ----------------------

N, DIM, QUERIES = 4096, 64, 24


@pytest.fixture(scope="module")
def wide_indexes():
    """(corpus, query vectors, JAX index, port index) over the same 10-bit
    codes (uint16) and codebooks, passage mode."""
    rng = np.random.default_rng(7)
    corpus = rng.standard_normal((N, DIM), dtype=np.float32)
    qvecs = rng.standard_normal((QUERIES, DIM), dtype=np.float32)
    by_text = {f"query {i}": qvecs[i] for i in range(QUERIES)}
    jq = JaxPQ(8, 1024)
    jq.fit(corpus[:2048])
    psg_ids = [f"p{i}" for i in range(N)]
    doc_ids = [f"d{i // 4}" for i in range(N)]
    jax_index = JaxInMemoryIndex(
        query_encoder=JaxLambdaEncoder(by_text.__getitem__), quantizer=jq,
        mode=JaxMode.PASSAGE,
    )
    jax_index.add(corpus, doc_ids=doc_ids, psg_ids=psg_ids)
    codes = jax_index._store[:N]
    assert codes.dtype == np.uint16 and int(codes.max()) >= 256
    index = convert.index_from_codes(
        codes, doc_ids, psg_ids, JaxMode.PASSAGE,
        convert.quantizer_from_state(*jq.serialize(), device="cpu"),
        query_encoder=LambdaEncoder(by_text.__getitem__), device="cpu",
    )
    return corpus, by_text, jax_index, index, codes, jq


def _run(rng, num_q, depth, prefix="p", n=N):
    return {
        f"q{qi}": {
            f"{prefix}{c}": float(depth - i)
            for i, c in enumerate(rng.choice(n, size=depth, replace=False))
        }
        for qi in range(num_q)
    }


def _assert_same(got, want):
    """The same pairs in the same order; scores at atol 1e-4 / rtol 1e-5 (fp32
    sums in another order)."""
    g, w = got._df, want._df
    np.testing.assert_array_equal(g["q_id"].astype(str), w["q_id"].astype(str))
    np.testing.assert_array_equal(g["id"].astype(str), w["id"].astype(str))
    np.testing.assert_allclose(
        g["score"].to_numpy(np.float64), w["score"].to_numpy(np.float64), atol=1e-4, rtol=1e-5
    )


@pytest.mark.parametrize(
    "branch,num_q,depth", [("sparse", 2, 3), ("cap_le_r", 24, 80), ("cap_gt_r", 24, 200)]
)
def test_pq_1024_index_matches_jax(wide_indexes, branch, num_q, depth):
    """The port's PQ(8, 1024) index keeps the uint16 codes on its table and
    scores like the JAX index: the gather-ADC, K3 (cap <= r) and K4
    (cap > r); re-rank and serve."""
    _, _, jax_index, index, _, _ = wide_indexes
    view = index._device_view()
    assert view.kind == "pq" and view.table.dtype == torch.uint16
    run = _run(np.random.default_rng(11), num_q, depth)
    queries = {q: f"query {q[1:]}" for q in run}
    jr, tr = fj.Ranking.from_run(run, queries=queries), ft.Ranking.from_run(run, queries=queries)
    _assert_same(index(tr), jax_index(jr))
    plan = index._get_plan(tr)
    assert ("stream_pq" in plan) == (branch != "sparse")
    if branch != "sparse":
        cap = plan["stream_pq"][0].shape[1] * 128
        assert (cap <= R) == (branch == "cap_le_r")
    _assert_same(index.serve(tr, 0.2, 10), jax_index.serve(jr, 0.2, 10))


def test_pq_1024_maxp_and_device_store(wide_indexes):
    """MAXP over the same uint16 codes (K-reduce after K3/K4), and
    ``store="device"`` holding the codes as uint16 on its buffer."""
    corpus, by_text, jax_index, _, codes, jq = wide_indexes
    quantizer = convert.quantizer_from_state(*jq.serialize(), device="cpu")
    doc_ids = [f"d{i // 4}" for i in range(N)]
    index = convert.index_from_codes(
        codes, doc_ids, None, JaxMode.MAXP, quantizer,
        query_encoder=LambdaEncoder(by_text.__getitem__), device="cpu",
    )
    store = InMemoryIndex(
        LambdaEncoder(by_text.__getitem__), quantizer=convert.quantizer_from_state(
            *jq.serialize(), device="cpu"
        ), mode=ft.index.Mode.MAXP, store="device", device="cpu", init_size=1024,
        alloc_size=1024,
    )
    for lo in range(0, N, 1000):
        store._add(codes[lo : lo + 1000], doc_ids[lo : lo + 1000], [None] * len(doc_ids[lo : lo + 1000]))
    assert store._dev_table.dtype == torch.uint16
    run = _run(np.random.default_rng(12), 8, 120, prefix="d", n=N // 4)
    queries = {q: f"query {q[1:]}" for q in run}
    jax_index.mode = JaxMode.MAXP
    try:
        want = jax_index(fj.Ranking.from_run(run, queries=queries))
    finally:
        jax_index.mode = JaxMode.PASSAGE
    tr = ft.Ranking.from_run(run, queries=queries)
    _assert_same(index(tr), want)
    _assert_same(store(tr), want)


def test_pq_1024_hybrid_tier(wide_indexes):
    """The hybrid tier over uint16 codes: the budget charges ``M * 2`` bytes
    a row, the tail stages 2-byte code rows, and the scores equal the whole
    table's."""
    corpus, by_text, _, index, codes, jq = wide_indexes
    budget = 8 * 1024 * 4 * 8 + 20_000  # codebooks + ~1,750 rows of 16 B
    hybrid = convert.index_from_codes(
        codes, None, [f"p{i}" for i in range(N)], JaxMode.PASSAGE,
        convert.quantizer_from_state(*jq.serialize(), device="cpu"),
        query_encoder=LambdaEncoder(by_text.__getitem__), device="cpu", hbm_budget=budget,
        stream_chunk_rows=1024,
    )
    view = hybrid._device_view()
    assert view.kind == "hybrid" and view.hybrid_kind == "pq"
    assert view.host_tail.dtype == np.uint16 and view.table.dtype == torch.uint16
    assert view.tail_start == int((budget - 8 * 1024 * 8 * 4) * 0.7) // 16 // 1024 * 1024
    run = _run(np.random.default_rng(13), 8, 300)
    tr = ft.Ranking.from_run(run, queries={q: f"query {q[1:]}" for q in run})
    _assert_same(hybrid(tr), index(tr))
