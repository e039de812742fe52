"""K3 and K4's two routes (table and slot-wise) on the CPU.

On the card, K3 and K4 score a query with fewer than
``stream_kernel_pq.adc_slot_limit`` slots slot by slot and every other query
through its lookup table (``csrc/adc_lut.cuh``).  The Python mirror of that
rule (``adc_query_routes_plain``) must pick the slot-wise route for the
hybrid tier's tail blocks and the global-table geometry, and the table route
for the flagship layouts and for the padding query of a tail block.  The
plain versions, which the wrappers run for CPU tensors whatever the route,
are held at few slots a query against the Pallas kernels in
``interpret=True``, at the tolerance of ``tests/test_stream_kernel.py:322``.
The routes themselves are held against each other bit for bit on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (MIXED_QUERIES, MIXED_UNLIMITED_COUNTS, TAIL_BLOCK_QUERIES,
                        TAIL_BLOCK_ROWS, TAIL_BLOCK_SLOTS, route_layout)
from fastforward_tpu.ops import scoring as jscoring
from fastforward_tpu.ops import stream_kernel_pq as jskpq
from fastforward_tpu_torch.ops import scoring
from fastforward_tpu_torch.ops import stream_kernel_pq as skpq

R = skpq.KERNEL_PQ_TILE_ROWS
#: (Ks, code type) of the staged geometries: PQ(96, 256) and PQ(96, 1024)
STAGED = [(256, torch.uint8), (1024, torch.uint16)]
#: slots per virtual tile of K3 (cap <= r) and K4 (cap > r)
CAPS = {"K3": 512, "K4": 1024}


def _routes(cand3: np.ndarray, qb: int, limit: int) -> np.ndarray:
    return skpq.adc_query_routes_plain(torch.from_numpy(cand3), qb, limit).numpy()


def _random_layout(rng, n_pad: int, qb: int, pairs: int, cap: int):
    rows = rng.integers(0, n_pad, size=pairs)
    qno = rng.integers(0, qb, size=pairs)
    cand, tidx, _ = scoring.build_streamed_layout(rows, qno, n_pad, qb, r=R, cap=cap)
    return cand.reshape(cand.shape[0], cap // 128, 128), tidx


@pytest.mark.parametrize("kernel", list(CAPS))
@pytest.mark.parametrize("ks,dtype", STAGED, ids=["pq96x256", "pq96x1024"])
def test_tail_block_real_queries_slot_wise(kernel, ks, dtype):
    """A staged tail block (512 queries of about 70 slots over 32,768 rows,
    64 x 1024 slots): every real query below the limit, scored slot-wise;
    the padding query, with tens of thousands of slots, keeps its table."""
    limit = skpq.adc_slot_limit(ks, 8, dtype)
    cand3, _ = route_layout(np.random.default_rng(1), "tail_block", TAIL_BLOCK_ROWS,
                            TAIL_BLOCK_QUERIES, R, CAPS[kernel], limit)
    assert cand3.size == 64 * 1024
    counts = np.bincount(cand3.reshape(-1) % TAIL_BLOCK_QUERIES, minlength=TAIL_BLOCK_QUERIES)
    assert counts[:-1].max() <= TAIL_BLOCK_SLOTS * 3 // 2 < limit
    assert counts[-1] > 20_000
    routes = _routes(cand3, TAIL_BLOCK_QUERIES, limit)
    assert (routes[:-1] == skpq.ROUTE_SLOTS).all()
    assert routes[-1] == skpq.ROUTE_TABLE


@pytest.mark.parametrize("kernel", list(CAPS))
def test_global_table_geometry_slot_wise(kernel):
    """PQ(96, 32768) (a subspace's table past what a block stages): a table
    entry costs a read through L2 like a codeword, so every query with
    slots, the padding query too, is scored slot-wise (64 queries of about
    47 slots over 4,096 rows, ``chip_smoke.py``'s global layout)."""
    limit = skpq.adc_slot_limit(32_768, 8, torch.uint16)
    assert limit > 2**40
    cand3, _ = _random_layout(np.random.default_rng(2), 4096, 64, 3000, CAPS[kernel])
    routes = _routes(cand3, 64, limit)
    assert (routes == skpq.ROUTE_SLOTS).all()


@pytest.mark.parametrize("k", [1, 8], ids=["passage", "maxp"])
def test_flagship_layouts_take_tables(k):
    """The flagship PQ(96, 256) layouts (512 queries x depth 1000, passages
    or MAXP documents of ``k`` slots a pair) put every query at 1,000 slots
    or more, above the limit: every query takes the table route."""
    limit = skpq.adc_slot_limit(256, 8, torch.uint8)
    n_pad = 262_144
    rng = np.random.default_rng(3)
    qno = np.repeat(np.arange(512), 1000 * k)
    rows = rng.integers(0, n_pad, size=qno.size)
    cap = scoring._adaptive_cap(rows.size, n_pad // R)
    cand, _, _ = scoring.build_streamed_layout(rows, qno, n_pad, 512, r=R, cap=cap)
    routes = _routes(cand, 512, limit)
    assert (routes == skpq.ROUTE_TABLE).all()


@pytest.mark.parametrize("ks,dtype", STAGED, ids=["pq96x256", "pq96x1024"])
def test_mixed_layout_takes_both_routes(ks, dtype):
    """The mixed layout of the card tests: the even queries at 1.5 times the
    limit take tables, the odd ones at half of it (and not the padding
    query) are scored slot-wise."""
    limit = skpq.adc_slot_limit(ks, 8, dtype)
    cand3, _ = route_layout(np.random.default_rng(4), "mixed", 4096, MIXED_QUERIES, R, 1024, limit)
    routes = _routes(cand3, MIXED_QUERIES, limit)
    assert (routes[0::2] == skpq.ROUTE_TABLE).all()
    assert (routes[1:-1:2] == skpq.ROUTE_SLOTS).all()
    unlimited = route_layout(np.random.default_rng(4), "mixed", 4096, MIXED_QUERIES, R, 1024, 1 << 62)[0]
    counts = np.bincount(unlimited.reshape(-1) % MIXED_QUERIES, minlength=MIXED_QUERIES)
    assert counts[0] == MIXED_UNLIMITED_COUNTS[0] and counts[1] == MIXED_UNLIMITED_COUNTS[1]


def test_slot_limit_follows_the_cost_model():
    """The limit grows with the table's width and shrinks with the
    codeword's bytes; past what a block stages, or where a codeword is no
    wider than a sector, there is no table route."""
    u8, u16 = torch.uint8, torch.uint16
    assert skpq.adc_slot_limit(16, 8, u8) == skpq.adc_slot_limit(256, 8, u8)  # width 256 either way
    assert skpq.adc_slot_limit(256, 8, u8) < skpq.adc_slot_limit(1024, 8, u16)
    assert skpq.adc_slot_limit(256, 32, u8) < skpq.adc_slot_limit(256, 8, u8)
    assert skpq.adc_slot_limit(24_576, 8, u16) < 2**40 < skpq.adc_slot_limit(24_580, 8, u16)
    assert skpq.adc_slot_limit(40_000, 2, torch.uint32) > 2**40


def test_route_limits_and_checks():
    """``"table"`` sends every query to tables, ``"slots"`` none, ``"auto"``
    takes the model's limit; another route raises."""
    assert skpq.adc_route_limit("table", 256, 8) == 0
    assert skpq.adc_route_limit("slots", 256, 8) > 2**40
    assert skpq.adc_route_limit("auto", 1024, 8, torch.uint16) == skpq.adc_slot_limit(1024, 8, torch.uint16)
    with pytest.raises(ValueError, match="_route"):
        skpq.adc_route_limit("lut", 256, 8)
    codes, cb, q, cand3, tile_idx = _torch(*_inputs(256, np.uint8, "K3")[:5])
    with pytest.raises(ValueError, match="_route"):
        skpq.stream_select_pq_pairwise(codes, cb, q, cand3, tile_idx, _route="lut")
    with pytest.raises(ValueError, match="_route"):
        skpq.stream_select_pq(codes, cb, q.t(), cand3, tile_idx, _route="lut")


# -- the plain versions at few slots a query against the Pallas kernels ------------

M, DS, QB, COUNT = 16, 8, 64, 70


def _inputs(ks: int, code_dtype, kernel: str, seed: int = 5):
    """PQ(16, Ks) codes over 4,096 rows and 64 queries of 35-105 random rows
    each (about half of the slots padding), with the float64 scores."""
    rng = np.random.default_rng(seed)
    n_pad = 4096
    codes = rng.integers(0, ks, size=(n_pad, M)).astype(code_dtype)
    cb = rng.normal(size=(M, ks, DS)).astype(np.float32)
    q = rng.normal(size=(QB, M * DS)).astype(np.float32)
    counts = rng.integers(COUNT // 2, COUNT * 3 // 2 + 1, size=QB)
    qno = np.repeat(np.arange(QB), counts)
    rows = rng.integers(0, n_pad, size=qno.size)
    cap = CAPS[kernel]
    cand, tile_idx, slot = scoring.build_streamed_layout(rows, qno, n_pad, QB, r=R, cap=cap)
    cand3 = cand.reshape(cand.shape[0], cap // 128, 128)
    deq = cb[np.arange(M)[None, :], codes[rows].astype(np.int64)].astype(np.float64)
    expected = np.einsum("pmd,pmd->p", deq, q.reshape(QB, M, DS)[qno].astype(np.float64))
    return codes, cb, q, cand3, tile_idx, slot, expected


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jax_args(codes, cb):
    bd_hi, bd_mid, bd_lo = jskpq.build_blockdiag_codebooks(cb)
    codes_p = jscoring._pad_pq_codes(jnp.asarray(codes), jskpq.M_PAD)
    return codes_p, jnp.asarray(bd_hi), jnp.asarray(bd_mid), jnp.asarray(bd_lo)


@pytest.mark.parametrize("ks,code_dtype", [(256, np.uint8), (1024, np.uint16)], ids=["ks256_u8", "ks1024_u16"])
def test_few_slots_layout_is_half_padding_and_slot_wise(ks, code_dtype):
    """The layouts of the parity cases below: about half of their slots pad,
    and every real query sits below the limit of its geometry."""
    for kernel in CAPS:
        cand3 = _inputs(ks, code_dtype, kernel)[3]
        counts = np.bincount(cand3.reshape(-1) % QB, minlength=QB)
        assert 0.3 < (counts[-1] - COUNT) / cand3.size < 0.7
        limit = skpq.adc_slot_limit(ks, DS, torch.from_numpy(np.zeros(1, code_dtype)).dtype)
        assert (_routes(cand3, QB, limit)[:-1] == skpq.ROUTE_SLOTS).all()


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("ks,code_dtype", [(256, np.uint8), (1024, np.uint16)], ids=["ks256_u8", "ks1024_u16"])
def test_k3_plain_few_slots_matches_pallas_interpret(ks, code_dtype, exact):
    """K3 at about 70 slots a query: the plain version (every ``_route``
    alike on the CPU) against ``stream_select_pq_pairwise(interpret=True)``
    at atol 1e-5 / rtol 1e-6, and (exact) against the float64 scores."""
    codes, cb, q, cand3, tile_idx, slot, expected = _inputs(ks, code_dtype, "K3")
    want = np.asarray(jskpq.stream_select_pq_pairwise(
        *_jax_args(codes, cb), q, cand3, tile_idx, m=M, r=R, interpret=True, exact=exact))
    args = _torch(codes, cb, q, cand3, tile_idx)
    plain = skpq.stream_select_pq_pairwise_plain(*args, r=R, exact=exact)
    for route in skpq.ADC_ROUTES:
        assert torch.equal(skpq.stream_select_pq_pairwise(*args, r=R, exact=exact, _route=route), plain)
    np.testing.assert_allclose(plain.numpy(), want, atol=1e-5, rtol=1e-6)
    if exact:
        np.testing.assert_allclose(plain.numpy().reshape(-1)[slot], expected, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("ks,code_dtype", [(256, np.uint8), (1024, np.uint16)], ids=["ks256_u8", "ks1024_u16"])
def test_k4_plain_few_slots_matches_pallas_interpret(ks, code_dtype):
    """K4 at about 70 slots a query, the exact tier, as K3's case (the TPU
    form of K4's other tiers keeps a 16-bit score:
    ``tests/test_torch_stream_kernel_pq.py`` holds them at their own
    tolerance)."""
    precision = "exact"
    codes, cb, q, cand3, tile_idx, slot, expected = _inputs(ks, code_dtype, "K4", seed=6)
    assert cand3.shape[1] * 128 > R
    want = np.asarray(jskpq.stream_select_pq(
        *_jax_args(codes, cb), np.ascontiguousarray(q.T), cand3, tile_idx, m=M, r=R,
        interpret=True, precision=precision))
    codes_t, cb_t, q_t, cand_t, tile_t = _torch(codes, cb, q, cand3, tile_idx)
    plain = skpq.stream_select_pq_plain(codes_t, cb_t, q_t.t(), cand_t, tile_t, r=R, precision=precision)
    for route in skpq.ADC_ROUTES:
        got = skpq.stream_select_pq(codes_t, cb_t, q_t.t(), cand_t, tile_t, r=R, precision=precision,
                                    _route=route)
        assert torch.equal(got, plain)
    np.testing.assert_allclose(plain.numpy(), want, atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(plain.numpy().reshape(-1)[slot], expected, atol=1e-5, rtol=1e-6)
