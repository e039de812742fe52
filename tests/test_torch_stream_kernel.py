"""K1 (pairwise stream-select) in the port against the Pallas kernel.

The port's plain PyTorch version (what the wrapper runs for CPU tensors) is
held slot for slot against ``fastforward_tpu``'s
``stream_select_pairwise(..., interpret=True)`` on the same numpy inputs.
The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastforward_tpu.ops import stream_kernel as jsk
from fastforward_tpu_torch.ops import query_groups, scoring
from fastforward_tpu_torch.ops import stream_kernel as sk

N_PAD, DIM, QB, P = 4096, 256, 16, 3000
R = sk.KERNEL_TILE_ROWS


def _inputs(table_kind: str, seed: int, pad_query_zero: bool = False):
    rng = np.random.default_rng(seed)
    if table_kind == "int8":
        table = rng.integers(-127, 128, size=(N_PAD, DIM // 128, 128)).astype(np.int8)
    else:
        table = rng.standard_normal((N_PAD, DIM), dtype=np.float32)
    q = rng.standard_normal((QB, DIM), dtype=np.float32)
    if pad_query_zero:
        q[QB - 1] = 0.0  # the pack modulus reserves the last query
    rows = rng.integers(0, N_PAD, size=P)
    qno = rng.integers(0, QB - 1 if pad_query_zero else QB, size=P)
    cap = scoring._adaptive_cap(P, N_PAD // R)
    cand, tile_idx, slot = scoring.build_streamed_layout(rows, qno, N_PAD, QB, r=R, cap=cap)
    return table, q, cand.reshape(cand.shape[0], cap // 128, 128), tile_idx, slot


def _both_tables(table: np.ndarray, table_kind: str):
    if table_kind == "bf16":
        return jnp.asarray(table, dtype=jnp.bfloat16), torch.from_numpy(table).to(torch.bfloat16)
    return jnp.asarray(table), torch.from_numpy(table)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("table_kind", ["fp32", "bf16", "int8"])
def test_plain_matches_pallas_interpret(table_kind, exact):
    """Every slot (padding included) agrees with the Pallas kernel run in
    interpret mode: atol 1e-4 / rtol 1e-5 as ``tests/test_stream_kernel.py:84``
    (atol 1e-3 for int8 tables, as ``:159``).  Both tiers compute the same
    products (bf16-rounded operands for the fast tier) and differ only in
    the fp32 summation order."""
    table, q, cand3, tile_idx, _ = _inputs(table_kind, seed=7)
    jtable, ttable = _both_tables(table, table_kind)
    want = np.asarray(
        jsk.stream_select_pairwise(jtable, q, cand3, tile_idx, r=R, interpret=True, exact=exact)
    )
    before = sk.stream_select_pairwise.launches
    got = sk.stream_select_pairwise(
        ttable, torch.from_numpy(q), torch.from_numpy(cand3), torch.from_numpy(tile_idx),
        r=R, exact=exact,
    )
    assert sk.stream_select_pairwise.launches == before  # CPU: no kernel launch
    assert got.dtype == torch.float32 and tuple(got.shape) == cand3.shape
    atol = 1e-3 if table_kind == "int8" else 1e-4
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=1e-5)


def test_padding_slots_score_zero():
    """Unused slots pack (local 0, query Qb-1); with a zero padding query
    their dot is exactly 0, and the real slots still match numpy."""
    table, q, cand3, tile_idx, slot = _inputs("fp32", seed=3, pad_query_zero=True)
    out = sk.stream_select_pairwise(
        torch.from_numpy(table), torch.from_numpy(q), torch.from_numpy(cand3),
        torch.from_numpy(tile_idx),
    ).numpy().reshape(-1)
    mask = np.ones(out.shape[0], dtype=bool)
    mask[slot] = False
    assert mask.any()
    np.testing.assert_array_equal(out[mask], 0.0)
    cand = cand3.reshape(-1)[slot]
    rows = np.repeat(tile_idx, cand3.shape[1] * 128)[slot] * R + cand // QB
    want = np.einsum("pd,pd->p", table[rows], q[cand % QB])
    np.testing.assert_allclose(out[slot], want, atol=1e-4, rtol=1e-5)


def _bad_inputs(case: str):
    table, q, cand3, tile_idx, _ = _inputs("fp32", seed=1)
    t, qq, c, ti = (torch.from_numpy(a) for a in (table, q, cand3, tile_idx))
    if case == "table_fp16":
        return (TypeError, t.half(), qq, c, ti)
    if case == "table_3d_float":
        return (ValueError, t.view(N_PAD, DIM // 128, 128), qq, c, ti)
    if case == "dim_not_128":
        return (ValueError, t[:, :200], qq[:, :200], c, ti)
    if case == "query_fp64":
        return (ValueError, t, qq.double(), c, ti)
    if case == "query_dim":
        return (ValueError, t, qq[:, :128], c, ti)
    if case == "cand_int64":
        return (ValueError, t, qq, c.long(), ti)
    if case == "cand_lanes":
        return (ValueError, t, qq, c.view(c.shape[0], -1, 64), ti)
    if case == "tile_len":
        return (ValueError, t, qq, c, ti[:-1])
    if case == "rows_not_tiles":
        return (ValueError, t[: N_PAD - 8], qq, c, ti)
    raise AssertionError(case)


@pytest.mark.parametrize(
    "case",
    [
        "table_fp16",
        "table_3d_float",
        "dim_not_128",
        "query_fp64",
        "query_dim",
        "cand_int64",
        "cand_lanes",
        "tile_len",
        "rows_not_tiles",
    ],
)
def test_wrapper_rejects_bad_inputs(case):
    err, *args = _bad_inputs(case)
    with pytest.raises(err):
        sk.stream_select_pairwise(*args)


# -- K2: stream_select ----------------------------------------------------------

SELECT_P = 5000  # over 8 tiles: mean 625 pairs per tile, cap 1024 > r


def _select_inputs(table_kind: str, cap: int, seed: int):
    rng = np.random.default_rng(seed)
    if table_kind == "int8":
        table = rng.integers(-127, 128, size=(N_PAD, DIM // 128, 128)).astype(np.int8)
    else:
        table = rng.standard_normal((N_PAD, DIM // 128, 128), dtype=np.float32)
    q = rng.standard_normal((QB, DIM), dtype=np.float32)
    rows = rng.integers(0, N_PAD, size=SELECT_P)
    qno = rng.integers(0, QB, size=SELECT_P)
    cand, tile_idx, slot = scoring.build_streamed_layout(rows, qno, N_PAD, QB, r=R, cap=cap)
    expected = np.einsum(
        "pd,pd->p", table.reshape(N_PAD, DIM)[rows].astype(np.float32), q[qno]
    )
    return table, q, cand.reshape(cand.shape[0], cap // 128, 128), tile_idx, slot, expected


@pytest.mark.parametrize("cap", [512, 1024], ids=["cap_le_r", "cap_gt_r"])
@pytest.mark.parametrize("precision", ["exact", "high", "fast"])
@pytest.mark.parametrize("table_kind", ["fp32", "int8"])
def test_k2_plain_matches_pallas_interpret(table_kind, precision, cap):
    """K2's plain version against ``stream_select(interpret=True)`` on 3D
    tables, at the tolerances of ``tests/test_stream_kernel.py``: exact
    atol 1e-3 / rtol 1e-4 (``:37``; rtol 1e-5 for int8, ``:159``), high
    atol 5e-3 / rtol 1e-3 (``:42``: the TPU's bf16x3 against the port's
    fp32; for int8 rows a bound scaled by the row magnitudes, below), fast
    the coarse check of ``:44-50`` (the port rounds operands to bf16; the
    TPU form's DEFAULT precision is fp32 on the CPU)."""
    table, q, cand3, tile_idx, slot, expected = _select_inputs(table_kind, cap, seed=8)
    want = np.asarray(
        jsk.stream_select(
            jnp.asarray(table), np.ascontiguousarray(q.T), cand3, tile_idx, r=R,
            interpret=True, precision=precision,
        )
    )
    before = sk.stream_select.launches
    got = sk.stream_select(
        torch.from_numpy(table), torch.from_numpy(q).t(), torch.from_numpy(cand3),
        torch.from_numpy(tile_idx), r=R, precision=precision,
    )
    assert sk.stream_select.launches == before  # CPU: no kernel launch
    assert got.dtype == torch.float32 and tuple(got.shape) == cand3.shape
    got = got.numpy()
    if precision == "exact":
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-5 if table_kind == "int8" else 1e-4)
    elif table_kind == "fp32" and precision == "high":
        np.testing.assert_allclose(got, want, atol=5e-3, rtol=1e-3)
    elif precision == "high":
        # int8 rows (|v| <= 127) scale the TPU form's bf16x3 error with them:
        # its two-part query split keeps ~16 bits, so bound the difference
        # by 2^-15 * sum |row_k * q_k| per slot
        absdot = sk.stream_select_plain(
            torch.from_numpy(np.abs(table)), torch.from_numpy(np.abs(q)).t(),
            torch.from_numpy(cand3), torch.from_numpy(tile_idx), r=R,
        ).numpy()
        assert (np.abs(got - want) <= 2.0**-15 * absdot).all()
    else:
        picked, ref = got.reshape(-1)[slot], want.reshape(-1)[slot]
        assert np.abs(picked - ref).mean() < 0.02 * np.abs(expected).mean()
        assert np.corrcoef(picked, ref)[0, 1] > 0.999
    if precision != "fast":  # both fp32 tiers are true fp32 dots
        np.testing.assert_allclose(got.reshape(-1)[slot], expected, atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize(
    "table_kind, ndim, cap, kernel",
    [
        ("int8", 3, 512, "stream_select_pairwise"),
        ("int8", 3, 1024, "stream_select"),
        ("fp32", 3, 512, "stream_select"),
        ("fp32", 2, 1024, "stream_select_pairwise"),
    ],
)
def test_auto_routes_as_jax(monkeypatch, table_kind, ndim, cap, kernel):
    """``stream_select_auto`` routes as ``fastforward_tpu/ops/stream_kernel.py
    :242-253``: 2D tables and int8 tables at cap <= r to K1, other 3D tables
    and int8 tables at cap > r to K2; both give the fp32 dots."""
    table, q, cand3, tile_idx, slot, expected = _select_inputs(table_kind, cap, seed=9)
    if ndim == 2:
        table = table.reshape(N_PAD, DIM)
    calls = []
    for name in ("stream_select_pairwise", "stream_select"):
        real = getattr(sk, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*args, **kw)

        monkeypatch.setattr(sk, name, spy)
    out = sk.stream_select_auto(
        torch.from_numpy(table), torch.from_numpy(q).t(), torch.from_numpy(cand3),
        torch.from_numpy(tile_idx), r=R, precision="high",
    )
    assert calls == [kernel]
    np.testing.assert_allclose(out.numpy().reshape(-1)[slot], expected, atol=1e-3, rtol=1e-5)


def test_k2_padding_slots_score_zero():
    table, q, cand3, tile_idx, slot, _ = _select_inputs("int8", 1024, seed=10)
    q[QB - 1] = 0.0
    out = sk.stream_select(
        torch.from_numpy(table), torch.from_numpy(q).t(), torch.from_numpy(cand3),
        torch.from_numpy(tile_idx),
    ).numpy().reshape(-1)
    mask = np.ones(out.shape[0], dtype=bool)
    mask[slot] = False
    assert mask.any()
    np.testing.assert_array_equal(out[mask], 0.0)


@pytest.mark.parametrize(
    "case", ["tier", "table_fp16", "table_4d", "query_dim", "query_fp64", "cand_lanes", "tile_len"]
)
def test_k2_rejects_bad_inputs(case):
    table, q, cand3, tile_idx, _, _ = _select_inputs("fp32", 512, seed=1)
    t, qt, c, ti = torch.from_numpy(table), torch.from_numpy(q).t(), torch.from_numpy(cand3), torch.from_numpy(tile_idx)
    kw = {}
    err = ValueError
    if case == "tier":
        kw["precision"] = "bf16"
    elif case == "table_fp16":
        t, err = t.half(), TypeError
    elif case == "table_4d":
        t = t.view(N_PAD, 1, DIM // 128, 128)
    elif case == "query_dim":
        qt = qt[:128]
    elif case == "query_fp64":
        qt = qt.double()
    elif case == "cand_lanes":
        c = c.view(c.shape[0], -1, 64)
    elif case == "tile_len":
        ti = ti[:-1]
    with pytest.raises(err):
        sk.stream_select(t, qt, c, ti, **kw)


# -- the query-major kernels' sizing on K1's and K2's layouts -------------------


def _random_slots(rng, shape, qb: int, depth: int) -> np.ndarray:
    """``shape`` slots padding on ``qb - 1``, ``depth`` of them for each
    query at random places (the flagship runs' 1,000 pairs a query)."""
    cand3 = np.full(shape, qb - 1, dtype=np.int32)
    real = np.repeat(np.arange(qb, dtype=np.int32), depth)
    cand3.reshape(-1)[rng.choice(cand3.size, size=real.size, replace=False)] = real
    return cand3


@pytest.mark.parametrize("layout", ["flagship", "dense_tiles", "one_query", "half_padding", "many_queries"])
def test_dense_work_items_fit_the_launch(layout):
    """K1's and K2's query-major kernels launch ``dense_max_items`` blocks
    and need ``query_groups.scratch_words`` words of scratch: the bound holds
    every query's ``ceil(slots / DENSE_ITEM_SLOTS)`` items, the padding
    query's slots are cut into many items rather than one, and a call's
    slots fit the grouping's 32-bit slot indices."""
    rng = np.random.default_rng(8)
    if layout == "flagship":  # K1 at N = 2M: 4096 x 256 slots, 512 x 1000 pairs
        qb, cand3 = 512, _random_slots(rng, (4096, 2, 128), 512, 1000)
    elif layout == "dense_tiles":  # K2 at N = 262,144: 1024 x 1024 slots
        qb, cand3 = 512, _random_slots(rng, (1024, 8, 128), 512, 1000)
    else:
        qb = {"one_query": 1, "many_queries": 5000}.get(layout, QB)
        cap = 1024
        p = N_PAD // R * cap // 2 if layout == "half_padding" else SELECT_P
        rows = rng.integers(0, N_PAD, size=p)
        qno = rng.integers(0, qb, size=p)
        cand, _, _ = scoring.build_streamed_layout(rows, qno, N_PAD, qb, r=R, cap=cap)
        cand3 = cand.reshape(cand.shape[0], cap // 128, 128)
    n = cand3.size
    counts = np.bincount(cand3.reshape(-1) % qb, minlength=qb)
    items = -(-counts // sk.DENSE_ITEM_SLOTS)
    assert items.sum() <= sk.dense_max_items(qb, n) < 2**31
    assert query_groups.scratch_words(qb, n) == 3 * qb + 4 + n
    assert n < 2**32
    pad_slots = int((cand3 % qb == qb - 1).sum())
    assert items[qb - 1] == -(-pad_slots // sk.DENSE_ITEM_SLOTS)
    if layout in ("flagship", "dense_tiles"):
        # over half the slots pad, cut into ~524 items; the 512 real
        # queries' ~1,000 slots take one item each
        assert pad_slots > n // 2 and items[qb - 1] > 256
        assert items[: qb - 1].max() == 1
        assert items.sum() <= 1100 and sk.dense_max_items(qb, n) == 1536
