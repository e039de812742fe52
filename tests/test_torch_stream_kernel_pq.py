"""K3 and K4 (streamed ADC over PQ codes) in the port against the Pallas kernels.

The port's plain PyTorch versions (what the wrappers run for CPU tensors)
are held slot for slot against ``fastforward_tpu``'s
``stream_select_pq_pairwise`` / ``stream_select_pq`` run with
``interpret=True`` on the same numpy inputs (the JAX kernels take
lane-padded codes and block-diagonal codebook splits built from the same
codes and codebooks).  The CUDA kernels themselves are held against the
plain versions on the card by ``tests/test_torch_gpu.py`` and
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastforward_tpu.ops import scoring as jscoring
from fastforward_tpu.ops import stream_kernel_pq as jskpq
from fastforward_tpu_torch.ops import scoring
from fastforward_tpu_torch.ops import stream_kernel_pq as skpq

N_PAD, M, KS, DS, QB, P = 2048, 16, 16, 8, 8, 3000
R = skpq.KERNEL_PQ_TILE_ROWS


def _inputs(cap: int, seed: int = 3):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, KS, size=(N_PAD, M)).astype(np.uint8)
    cb = rng.normal(size=(M, KS, DS)).astype(np.float32)
    q = rng.normal(size=(QB, M * DS)).astype(np.float32)
    rows = rng.integers(0, N_PAD, size=P).astype(np.int64)
    qno = rng.integers(0, QB, size=P).astype(np.int64)
    cand, tile_idx, slot = scoring.build_streamed_layout(rows, qno, N_PAD, QB, r=R, cap=cap)
    cand3 = cand.reshape(cand.shape[0], cap // 128, 128)
    deq = cb[np.arange(M)[None, :], codes[rows]]  # (P, M, Ds)
    expected = np.einsum("pmd,pmd->p", deq, q.reshape(QB, M, DS)[qno])
    return codes, cb, q, cand3, tile_idx, slot, expected


def _jax_args(codes, cb):
    bd_hi, bd_mid, bd_lo = jskpq.build_blockdiag_codebooks(cb)
    codes_p = jscoring._pad_pq_codes(jnp.asarray(codes), jskpq.M_PAD)
    return codes_p, jnp.asarray(bd_hi), jnp.asarray(bd_mid), jnp.asarray(bd_lo)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _assert_fast_tier(got, want, scale_ref):
    """The JAX tests' fast-tier check (``tests/test_stream_kernel.py:375-379``)."""
    scale = np.abs(scale_ref).mean()
    assert np.abs(got - want).mean() < 0.01 * scale
    assert np.corrcoef(got, want)[0, 1] > 0.999


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
def test_k3_plain_matches_pallas_interpret(exact):
    """K3 against ``stream_select_pq_pairwise(interpret=True)`` at cap <= r:
    exact at atol 1e-5 / rtol 1e-6 (``tests/test_stream_kernel.py:328``);
    fast with bf16-rounded codewords and queries on both sides, which differ
    only in the fp32 sum order."""
    codes, cb, q, cand3, tile_idx, slot, expected = _inputs(cap=512)
    want = np.asarray(
        jskpq.stream_select_pq_pairwise(
            *_jax_args(codes, cb), q, cand3, tile_idx, m=M, r=R, interpret=True, exact=exact
        )
    )
    before = skpq.stream_select_pq_pairwise.launches
    got = skpq.stream_select_pq_pairwise(*_torch(codes, cb, q, cand3, tile_idx), r=R, exact=exact)
    assert skpq.stream_select_pq_pairwise.launches == before  # CPU: plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == cand3.shape
    got = got.numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)
    if exact:
        np.testing.assert_allclose(got.reshape(-1)[slot], expected, atol=1e-5, rtol=1e-6)
    else:
        _assert_fast_tier(got.reshape(-1)[slot], expected, expected)


@pytest.mark.parametrize("precision", ["exact", "high", "fast"])
def test_k4_plain_matches_pallas_interpret(precision):
    """K4 against ``stream_select_pq(interpret=True)`` at cap > r.

    exact: atol 1e-5 / rtol 1e-6 (``tests/test_stream_kernel.py:322``).
    high: both round the codewords to bf16 (``stream_kernel_pq.py:143-148``);
    the TPU form then keeps the score to two bf16 parts (16 bits), so the two
    agree to rtol/atol 1e-4, and both pass the JAX test's own check against
    the fp32 decode-then-dot (``:381-389``).  fast: the same check.
    """
    codes, cb, q, cand3, tile_idx, slot, expected = _inputs(cap=1024)
    assert cand3.shape[1] * 128 > R
    q_t = np.ascontiguousarray(q.T)
    want = np.asarray(
        jskpq.stream_select_pq(
            *_jax_args(codes, cb), q_t, cand3, tile_idx, m=M, r=R, interpret=True,
            precision=precision,
        )
    )
    tc, tcb, tq, tcand, ttile = _torch(codes, cb, q, cand3, tile_idx)
    got = skpq.stream_select_pq(tc, tcb, tq.t(), tcand, ttile, r=R, precision=precision).numpy()
    picked = got.reshape(-1)[slot]
    if precision == "exact":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)
        np.testing.assert_allclose(picked, expected, atol=1e-5, rtol=1e-6)
        return
    _assert_fast_tier(picked, want.reshape(-1)[slot], expected)
    _assert_fast_tier(picked, expected, expected)
    if precision == "high":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        # the port's high tier is exactly "bf16 codewords, fp32 dot"
        cb16 = torch.from_numpy(cb).to(torch.bfloat16).float().numpy()
        rows = np.repeat(tile_idx, cand3.shape[1] * 128)[slot] * R + cand3.reshape(-1)[slot] // QB
        deq = cb16[np.arange(M)[None, :], codes[rows]]
        ref = np.einsum("pmd,pmd->p", deq, q.reshape(QB, M, DS)[cand3.reshape(-1)[slot] % QB])
        np.testing.assert_allclose(picked, ref, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("cap", [512, 1024], ids=["cap_le_r", "cap_gt_r"])
@pytest.mark.parametrize("precision", ["exact", "high", "fast"])
def test_auto_routes_as_jax(monkeypatch, cap, precision):
    """``stream_select_pq_auto`` sends cap <= r to K3 (exact for "exact" and
    "high") and cap > r to K4, and agrees with the JAX router's output."""
    codes, cb, q, cand3, tile_idx, slot, expected = _inputs(cap=cap, seed=4)
    calls = []
    for name in ("stream_select_pq_pairwise", "stream_select_pq"):
        real = getattr(skpq, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*args, **kw)

        monkeypatch.setattr(skpq, name, spy)
    tc, tcb, tq, tcand, ttile = _torch(codes, cb, q, cand3, tile_idx)
    got = skpq.stream_select_pq_auto(tc, tcb, tq.t(), tcand, ttile, r=R, precision=precision)
    assert calls == ["stream_select_pq_pairwise" if cap <= R else "stream_select_pq"]
    want = np.asarray(
        jskpq.stream_select_pq_auto(
            *_jax_args(codes, cb), jnp.asarray(np.ascontiguousarray(q.T)), cand3, tile_idx,
            m=M, r=R, interpret=True, precision=precision,
        )
    ).reshape(-1)[slot]
    picked = got.numpy().reshape(-1)[slot]
    if precision == "fast" or (precision == "high" and cap > R):
        _assert_fast_tier(picked, want, expected)
    else:
        np.testing.assert_allclose(picked, want, atol=1e-5, rtol=1e-6)


def test_padding_slots_score_zero():
    """Unused slots pack (local 0, query Qb-1); with a zero padding query
    their ADC score is exactly 0 in both kernels' plain versions."""
    codes, cb, q, cand3, tile_idx, slot, _ = _inputs(cap=1024, seed=6)
    q[QB - 1] = 0.0
    mask = np.ones(cand3.size, dtype=bool)
    mask[slot] = False
    tc, tcb, tq, tcand, ttile = _torch(codes, cb, q, cand3, tile_idx)
    k3 = skpq.stream_select_pq_pairwise(tc, tcb, tq, tcand, ttile).numpy().reshape(-1)
    k4 = skpq.stream_select_pq(tc, tcb, tq.t(), tcand, ttile).numpy().reshape(-1)
    assert mask.any()
    np.testing.assert_array_equal(k3[mask], 0.0)
    np.testing.assert_array_equal(k4[mask], 0.0)


def _bad_inputs(case: str):
    codes, cb, q, cand3, tile_idx, _, _ = _inputs(cap=512, seed=1)
    c, b, qq, cd, ti = _torch(codes, cb, q, cand3, tile_idx)
    if case == "codes_uint16":
        return (TypeError, c.to(torch.int16), b, qq, cd, ti)
    if case == "ks_over_256":
        return (ValueError, c, torch.zeros((M, 300, DS)), qq, cd, ti)
    if case == "codebooks_fp64":
        return (ValueError, c, b.double(), qq, cd, ti)
    if case == "codebooks_m":
        return (ValueError, c, b[:8], qq, cd, ti)
    if case == "query_dim":
        return (ValueError, c, b, qq[:, :64], cd, ti)
    if case == "cand_int64":
        return (ValueError, c, b, qq, cd.long(), ti)
    if case == "tile_len":
        return (ValueError, c, b, qq, cd, ti[:-1])
    if case == "rows_not_tiles":
        return (ValueError, c[: N_PAD - 8], b, qq, cd, ti)
    raise AssertionError(case)


@pytest.mark.parametrize(
    "case",
    ["codes_uint16", "ks_over_256", "codebooks_fp64", "codebooks_m", "query_dim", "cand_int64",
     "tile_len", "rows_not_tiles"],
)
def test_wrappers_reject_bad_inputs(case):
    err, codes, cb, q, cand3, tile_idx = _bad_inputs(case)
    with pytest.raises(err):
        skpq.stream_select_pq_pairwise(codes, cb, q, cand3, tile_idx)
    with pytest.raises(err):
        skpq.stream_select_pq(codes, cb, q.t(), cand3, tile_idx)
    with pytest.raises(ValueError):
        skpq.stream_select_pq(codes, cb, q.t(), cand3, tile_idx, precision="bf16")


def _items_of(cand3: np.ndarray, qb: int) -> np.ndarray:
    """Work items per query as the card's grouping cuts them."""
    counts = np.bincount(cand3.reshape(-1) % qb, minlength=qb)
    return -(-counts // skpq.ADC_ITEM_SLOTS)


@pytest.mark.parametrize("layout", ["uniform", "one_query", "half_padding", "flagship"])
def test_adc_work_items_fit_the_launch(layout):
    """The query-major kernels launch ``adc_max_items`` blocks and need
    ``adc_scratch_words`` words of scratch: the bound holds every query's
    ``ceil(slots / ADC_ITEM_SLOTS)`` items, and the padding query's slots
    are cut into many items rather than one."""
    rng = np.random.default_rng(8)
    if layout == "flagship":
        # 512 queries x ~1,000 real slots in 1,048,576; the rest pads on 511
        qb, n = 512, 1 << 20
        cand3 = np.full((4096, 2, 128), qb - 1, dtype=np.int32)
        real = rng.integers(0, qb, size=512_000)
        cand3.reshape(-1)[rng.choice(n, size=real.size, replace=False)] = real
    else:
        qb = 1 if layout == "one_query" else QB
        cap = 1024
        p = N_PAD // R * cap // 2 if layout == "half_padding" else P
        rows = rng.integers(0, N_PAD, size=p)
        qno = rng.integers(0, qb, size=p)
        cand, _, _ = scoring.build_streamed_layout(rows, qno, N_PAD, qb, r=R, cap=cap)
        cand3 = cand.reshape(cand.shape[0], cap // 128, 128)
        n = cand3.size
    items = _items_of(cand3, qb)
    assert items.sum() <= skpq.adc_max_items(qb, n)
    assert skpq.adc_scratch_words(qb, n) == 3 * qb + 2 + n
    pad_slots = int((cand3 % qb == qb - 1).sum())
    assert items[qb - 1] == -(-pad_slots // skpq.ADC_ITEM_SLOTS)
    if layout == "flagship":
        assert pad_slots > n // 2 and items[qb - 1] > 256
        assert items.sum() <= 775 and skpq.adc_max_items(qb, n) == 1024


def test_adc_max_items_is_tight():
    """Every query one slot past a whole number of items reaches the bound
    when ``qb`` < ``ADC_ITEM_SLOTS``."""
    qb, per = 7, 2 * skpq.ADC_ITEM_SLOTS + 1
    cand3 = np.repeat(np.arange(qb, dtype=np.int32), per)
    cand3 = np.concatenate([cand3, np.full(-cand3.size % 128, 0, np.int32)]).reshape(-1, 1, 128)
    items = _items_of(cand3, qb)
    assert items.sum() == skpq.adc_max_items(qb, cand3.size)


@pytest.mark.parametrize(
    ("qb", "m", "want"),
    [(512, 96, 512), (512, 384, 170), (1, 4096, 1), (8, 1 << 20, 1), (4096, 96, 682)],
)
def test_adc_table_queries_fit_the_budget(qb, m, want):
    """Lookup tables (``m * 256`` fp32 per query) come in groups that fit
    ``ADC_TABLE_BYTES``: the flagship's 512 queries in one, PQ(384, 256) in
    groups of 170, and never fewer than one query."""
    got = skpq.adc_table_queries(qb, m)
    assert got == want
    assert got == 1 or got * m * 256 * 4 <= skpq.ADC_TABLE_BYTES
