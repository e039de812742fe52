"""K1's fp32 split and the dense-dot body's packed route, on the CPU.

On the card, K1 splits each virtual tile of an fp32 table over
``stream_kernel.tile_split`` blocks when the tiles are too few to fill the
card (``csrc/tile_dot.cuh``), and the query-major body of K2 and of K1's
bf16 and int8 branches packs the slots of queries with fewer than
``DENSE_PACK_LIMIT`` slots into shared runs (``csrc/dense_dot.cuh``).  The
Python mirrors of those rules (``tile_split``, ``dense_query_routes_plain``)
must pick the split and the packed route at the hybrid tier's tail blocks
(64 tiles, about 70 slots a query) and keep one block a tile and a work item
a query at the flagship layouts.  The plain versions, which the wrappers run
for CPU tensors whatever ``_route`` or ``_split`` says, are held at the tail
block's geometry against the Pallas kernels in ``interpret=True``, at the
tolerances of ``tests/test_stream_kernel.py:84,159,198``.  The routes and
splits themselves are held against each other bit for bit on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import MIXED_QUERIES, TAIL_BLOCK_QUERIES, TAIL_BLOCK_ROWS, TAIL_BLOCK_SLOTS, route_layout
from fastforward_tpu.ops import stream_kernel as jsk
from fastforward_tpu_torch.ops import scoring
from fastforward_tpu_torch.ops import stream_kernel as sk

R = sk.KERNEL_TILE_ROWS
#: SMs of an H100 SXM (the card the split was measured on) and of an H100 PCIe
H100_SMS = (132, 114)


def _routes(cand3: np.ndarray, qb: int, limit: int = sk.DENSE_PACK_LIMIT) -> np.ndarray:
    return sk.dense_query_routes_plain(torch.from_numpy(cand3), qb, limit).numpy()


def _count_layout(rng, n_pad: int, counts, cap: int):
    qno = np.repeat(np.arange(len(counts)), counts)
    rows = rng.integers(0, n_pad, size=qno.size)
    cand, tidx, slot = scoring.build_streamed_layout(rows, qno, n_pad, len(counts), r=R, cap=cap)
    return cand.reshape(cand.shape[0], cap // 128, 128), tidx, slot, rows, qno


# -- the rules' mirrors ------------------------------------------------------------


def test_tail_block_is_split_and_packed():
    """A staged tail block (512 queries of about 70 slots over 32,768 rows,
    64 x 1024 slots): K1's fp32 body splits each of its 64 tiles over 8
    blocks on an H100 SXM (7 on a PCIe card); every real query is below the
    pack limit and is packed, the padding query, with tens of thousands of
    slots, keeps its work items."""
    cand3, tidx = route_layout(np.random.default_rng(1), "tail_block", TAIL_BLOCK_ROWS,
                               TAIL_BLOCK_QUERIES, R, 1024, sk.DENSE_PACK_LIMIT)
    assert cand3.shape == (64, 8, 128) and tidx.shape == (64,)
    assert [sk.tile_split(cand3.shape[0], sms) for sms in H100_SMS] == [8, 7]
    counts = np.bincount(cand3.reshape(-1) % TAIL_BLOCK_QUERIES, minlength=TAIL_BLOCK_QUERIES)
    assert counts[:-1].max() <= TAIL_BLOCK_SLOTS * 3 // 2 < sk.DENSE_PACK_LIMIT
    assert counts[-1] > 20_000
    routes = _routes(cand3, TAIL_BLOCK_QUERIES)
    assert (routes[:-1] == sk.ROUTE_PACKED).all()
    assert routes[-1] == sk.ROUTE_ITEMS


@pytest.mark.parametrize("k,n_pad,tiles", [(1, 2_000_384, 4096), (8, 2_000_384, 8192),
                                           (1, 262_144, 1024), (8, 262_144, 8192)],
                         ids=["passage", "maxp", "dense_passage", "dense_maxp"])
def test_flagship_layouts_keep_their_design(k, n_pad, tiles):
    """The resident layouts (512 queries x depth 1000, passages or MAXP
    documents of ``k`` slots a pair, over the flagship 2M rows or the dense
    tiles' 262,144) have 1,024-8,192 tiles, one block each, and every query
    at 1,000 slots or more, on work items."""
    rng = np.random.default_rng(3)
    qno = np.repeat(np.arange(512), 1000 * k)
    rows = rng.integers(0, n_pad, size=qno.size)
    cap = scoring._adaptive_cap(rows.size, n_pad // R)
    cand, _, _ = scoring.build_streamed_layout(rows, qno, n_pad, 512, r=R, cap=cap)
    assert cand.shape[0] == tiles
    assert all(sk.tile_split(cand.shape[0], sms) == 1 for sms in H100_SMS)
    assert (_routes(cand, 512) == sk.ROUTE_ITEMS).all()


def test_mixed_layout_takes_both_routes():
    """The mixed layout of the card tests: the even queries at 1.5 times the
    pack limit keep their work items, the odd ones at half of it (and not
    the padding query) are packed."""
    cand3, _ = route_layout(np.random.default_rng(4), "mixed", 4096, MIXED_QUERIES, R, 1024,
                            sk.DENSE_PACK_LIMIT)
    routes = _routes(cand3, MIXED_QUERIES)
    assert (routes[0::2] == sk.ROUTE_ITEMS).all()
    assert (routes[1:-1:2] == sk.ROUTE_PACKED).all()


@pytest.mark.parametrize("limit,want", [(0, sk.ROUTE_ITEMS), (1 << 62, sk.ROUTE_PACKED)],
                         ids=["items", "packed"])
def test_forced_limits_send_every_query_one_way(limit, want):
    """At limit 0 every query with slots keeps work items, above any count
    every one is packed; a query without slots has no route."""
    cand3, _, _, _, _ = _count_layout(np.random.default_rng(5), 4096, [0, 40, 300, 0, 2000], 1024)
    routes = _routes(cand3, 5, limit)
    assert routes[0] == routes[3] == sk.ROUTE_NONE
    assert (routes[[1, 2, 4]] == want).all()


def test_tile_split_rule():
    """S fills the card's block places with one tile's share each, between 1
    and ``TILE_MAX_SPLIT``, and never grows with the tiles."""
    sms = 132
    places = sms * sk.TILE_BLOCKS_PER_SM
    assert sk.tile_split(1, sms) == sk.TILE_MAX_SPLIT
    assert sk.tile_split(places, sms) == sk.tile_split(places // 2 + 1, sms) == 1
    assert sk.tile_split(places // 2, sms) == 2
    splits = [sk.tile_split(n, sms) for n in range(1, 2 * places)]
    assert all(a >= b for a, b in zip(splits, splits[1:]))
    assert all(n * s <= max(places, n) for n, s in zip(range(1, 2 * places), splits)
               if s < sk.TILE_MAX_SPLIT)


def test_mirrors_match_the_kernel_headers():
    """The Python constants of the split are the header's own."""
    header = (Path(sk.__file__).parent / "csrc" / "tile_dot.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", header).group(1))

    assert const("kTileBlocksPerSm") == sk.TILE_BLOCKS_PER_SM
    assert const("kTileMaxSplit") == sk.TILE_MAX_SPLIT


def test_route_limits_and_checks():
    """``"items"`` packs no query, ``"packed"`` every one, ``"auto"`` takes
    ``DENSE_PACK_LIMIT``; another route, or a split out of range, raises."""
    assert sk.dense_route_limit("items") == 0
    assert sk.dense_route_limit("packed") > 2**40
    assert sk.dense_route_limit("auto") == sk.DENSE_PACK_LIMIT
    with pytest.raises(ValueError, match="_route"):
        sk.dense_route_limit("slots")
    table, q, cand3, tile_idx, _, _ = _inputs("int8", seed=6)
    args = [torch.from_numpy(a) for a in (table, q, cand3, tile_idx)]
    with pytest.raises(ValueError, match="_route"):
        sk.stream_select_pairwise(*args, r=R, _route="slots")
    with pytest.raises(ValueError, match="_route"):
        sk.stream_select(args[0], args[1].t(), *args[2:], r=R, _route="slots")
    for split in (0, sk.TILE_MAX_SPLIT + 1):
        with pytest.raises(ValueError, match="_split"):
            sk.stream_select_pairwise(*args, r=R, _split=split)


# -- the plain versions at the tail block's geometry against the Pallas kernels ----

N_PAD, DIM, QB, COUNT, CAP = 4096, 256, 64, 70, 1024


def _inputs(table_kind: str, seed: int):
    """4,096 rows of ``table_kind`` (int8 as 3D codes) and 64 queries of
    35-105 random rows each at cap 1024 (8 tiles, about half of the slots
    padding), with the float64 scores of the real slots."""
    rng = np.random.default_rng(seed)
    if table_kind == "int8":
        table = rng.integers(-127, 128, size=(N_PAD, DIM // 128, 128)).astype(np.int8)
    else:
        table = rng.standard_normal((N_PAD, DIM), dtype=np.float32)
    q = rng.standard_normal((QB, DIM), dtype=np.float32)
    counts = rng.integers(COUNT // 2, COUNT * 3 // 2 + 1, size=QB)
    cand3, tidx, slot, rows, qno = _count_layout(rng, N_PAD, counts, CAP)
    expected = np.einsum("pd,pd->p", table.reshape(N_PAD, DIM)[rows].astype(np.float64),
                         q[qno].astype(np.float64))
    return table, q, cand3, tidx, slot, expected


def test_tail_geometry_is_half_padding_split_and_packed():
    """The layouts of the parity cases below: 8 tiles, about half of their
    slots padding, every real query packed."""
    cand3 = _inputs("fp32", seed=7)[2]
    assert cand3.shape == (8, CAP // 128, 128)
    counts = np.bincount(cand3.reshape(-1) % QB, minlength=QB)
    assert 0.3 < (counts[-1] - COUNT) / cand3.size < 0.7
    assert sk.tile_split(cand3.shape[0], H100_SMS[0]) == sk.TILE_MAX_SPLIT
    assert (_routes(cand3, QB)[:-1] == sk.ROUTE_PACKED).all()


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("table_kind", ["fp32", "bf16", "int8"])
def test_k1_plain_tail_geometry_matches_pallas_interpret(table_kind, exact):
    """K1 at about 70 slots a query over 8 tiles: the plain version (every
    ``_route`` and ``_split`` alike on the CPU) against
    ``stream_select_pairwise(interpret=True)`` at atol 1e-4 / rtol 1e-5
    (``tests/test_stream_kernel.py:84``; atol 1e-3 for int8, ``:159``), and
    (exact) the real slots against float64."""
    table, q, cand3, tile_idx, slot, expected = _inputs(table_kind, seed=8)
    if table_kind == "bf16":
        jtable, ttable = jnp.asarray(table, dtype=jnp.bfloat16), torch.from_numpy(table).to(torch.bfloat16)
    else:
        jtable, ttable = jnp.asarray(table), torch.from_numpy(table)
    want = np.asarray(jsk.stream_select_pairwise(jtable, q, cand3, tile_idx, r=R, interpret=True,
                                                 exact=exact))
    args = (ttable, torch.from_numpy(q), torch.from_numpy(cand3), torch.from_numpy(tile_idx))
    plain = sk.stream_select_pairwise_plain(*args, r=R, exact=exact)
    for kwargs in ({"_route": "items"}, {"_route": "packed"}, {"_split": 1}, {"_split": 8}, {}):
        assert torch.equal(sk.stream_select_pairwise(*args, r=R, exact=exact, **kwargs), plain)
    atol = 1e-3 if table_kind == "int8" else 1e-4
    np.testing.assert_allclose(plain.numpy(), want, atol=atol, rtol=1e-5)
    if exact and table_kind != "bf16":
        np.testing.assert_allclose(plain.numpy().reshape(-1)[slot], expected, atol=atol, rtol=1e-5)


@pytest.mark.parametrize("table_kind", ["fp32", "int8"])
def test_k2_plain_tail_geometry_matches_pallas_interpret(table_kind):
    """K2 on 3D tables (the hybrid tier's fp32 block viewed 3D, int8 codes)
    at about 70 slots a query, the exact tier: the plain version (every
    ``_route`` alike on the CPU) against ``stream_select(interpret=True)``
    at atol 1e-3 / rtol 1e-5 (``tests/test_stream_kernel.py:159,198``), and
    the real slots against float64."""
    table, q, cand3, tile_idx, slot, expected = _inputs(table_kind, seed=9)
    table3 = table.reshape(N_PAD, DIM // 128, 128)
    assert cand3.shape[1] * 128 > R
    want = np.asarray(jsk.stream_select(jnp.asarray(table3), np.ascontiguousarray(q.T), cand3,
                                        tile_idx, r=R, interpret=True, precision="exact"))
    args = (torch.from_numpy(table3), torch.from_numpy(q).t(), torch.from_numpy(cand3),
            torch.from_numpy(tile_idx))
    plain = sk.stream_select_plain(*args, r=R, precision="exact")
    for route in sk.DENSE_ROUTES:
        assert torch.equal(sk.stream_select(*args, r=R, precision="exact", _route=route), plain)
    np.testing.assert_allclose(plain.numpy(), want, atol=1e-3, rtol=1e-5)
    np.testing.assert_allclose(plain.numpy().reshape(-1)[slot], expected, atol=1e-3, rtol=1e-5)
