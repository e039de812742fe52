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
from fastforward_tpu_torch.ops import scoring
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
