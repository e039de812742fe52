"""The port's chunked upload and 16-bit planes against ``fastforward_tpu.ops.upload``.

``tests/test_upload.py``'s cases (every chunk geometry, ragged last chunks,
3D int8 codes, bf16) and ``tests/test_preload_progressive.py``'s plane algebra
(a lossless split, hi alone as truncation, zero padded rows, bad arguments)
on the port, each result held against the JAX package's on the same numpy
input, bit for bit: an upload copies bytes and the planes are bit
operations, so no tolerance applies.  The port runs on the CPU here (its
pinned staging buffers need the card); ``n == 0`` returns a zero table
instead of dividing by zero.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from fastforward_tpu.ops import upload as jax_upload
from fastforward_tpu_torch.ops import upload

CPU = torch.device("cpu")


def _host(seed: int, shape, dtype=np.float32) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if np.dtype(dtype) == np.int8:
        return rng.integers(-128, 128, size=shape, dtype=np.int8)
    return rng.standard_normal(shape).astype(dtype)


def _jax_table(host: np.ndarray, **kwargs) -> np.ndarray:
    old = jax_upload.MIN_CHUNKED_BYTES
    jax_upload.MIN_CHUNKED_BYTES = 0
    try:
        return np.asarray(jax_upload.upload_table(host, **kwargs))
    finally:
        jax_upload.MIN_CHUNKED_BYTES = old


@pytest.mark.parametrize(
    "rows, chunk_rows",
    [(6, 1000), (1000, 300), (64, 128), (777, 100)],
    ids=["small", "ragged_last_chunk", "one_chunk", "eight_chunks"],
)
def test_upload_table_equals_jax(rows, chunk_rows):
    """The chunk geometries of ``tests/test_upload.py``: one chunk, 4 chunks
    with a last one of 100 rows, 8 chunks with a last one of 77, each
    against the JAX package's chunked upload of the same chunks."""
    host = _host(rows, (rows, 12))
    got = upload.upload_table(host, CPU, chunk_bytes=chunk_rows * 12 * 4)
    want = _jax_table(host, chunk_bytes=chunk_rows * 12 * 4)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_upload_table_pads_rows_with_zeros():
    """``shape`` with more rows than the host: the extra rows are zero and
    nothing padded is built on the host."""
    host = _host(1, (300, 16))
    got = upload.upload_table(host, CPU, shape=(512, 16), chunk_bytes=128 * 16 * 4).numpy()
    np.testing.assert_array_equal(got[:300], _jax_table(host))
    np.testing.assert_array_equal(got[300:], 0.0)


def test_3d_int8_codes():
    """int8 code tables upload in their 3D ``(N, dim/128, 128)`` layout from
    2D host rows; chunks split the leading axis only."""
    host = _host(3, (500, 3 * 128), np.int8)
    got = upload.upload_table(host, CPU, shape=(512, 3, 128), chunk_bytes=128 * 3 * 128)
    assert got.dtype == torch.int8
    want = _jax_table(host.reshape(500, 3, 128), chunk_bytes=128 * 3 * 128)
    np.testing.assert_array_equal(got.numpy()[:500], want)
    np.testing.assert_array_equal(got.numpy()[500:], 0)


def test_bf16_table_rounds_as_jax():
    """An fp32 host table uploaded as bf16 rounds to nearest even, as the
    JAX package's host-side ``ml_dtypes.bfloat16`` cast does."""
    host = _host(4, (300, 8))
    got = upload.upload_table(host, CPU, dtype=torch.bfloat16, chunk_bytes=100 * 8 * 4)
    assert got.dtype == torch.bfloat16
    want = _jax_table(host.astype(ml_dtypes.bfloat16), chunk_bytes=100 * 8 * 2)
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))


def test_stage_dtype_casts_on_the_host():
    """float64 rows cross as fp32 (``stage_dtype``), as the index's host
    store does for vectors added in float64."""
    host = _host(5, (100, 8), np.float64)
    got = upload.upload_table(host, CPU, stage_dtype=np.float32)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), _jax_table(host.astype(np.float32)))


def test_upload_into_an_offset():
    """``upload_into`` writes rows at an offset of an existing buffer (the
    device store's ``add``) and refuses rows past its end."""
    buf = torch.zeros((64, 8))
    host = _host(6, (20, 8))
    upload.upload_into(buf, host, 40, chunk_bytes=7 * 8 * 4)
    np.testing.assert_array_equal(buf[40:60].numpy(), host)
    assert not buf[:40].any() and not buf[60:].any()
    with pytest.raises(ValueError):
        upload.upload_into(buf, host, 50)


def test_empty_tables():
    """``n == 0``: a zero table of the requested rows (the JAX package's
    ``upload_plane`` divides by zero here)."""
    empty = np.zeros((0, 8), np.float32)
    assert upload.upload_table(empty, CPU, shape=(16, 8)).eq(0).all()
    plane = upload.upload_plane(empty, "hi", CPU, total_rows=16)
    assert plane.shape == (16, 8) and plane.dtype == torch.int16 and not plane.any()
    with pytest.raises(ZeroDivisionError):
        jax_upload.upload_plane(empty, "hi", total_rows=16)


def _special(host: np.ndarray) -> np.ndarray:
    host[0, :6] = [np.inf, -np.inf, np.nan, 0.0, -0.0, np.float32(1e-42)]
    return host


def test_split_is_lossless():
    """hi | lo rebuilds every fp32 bit pattern (infinities, NaN, signed
    zeros, subnormals), and each plane and the truncated table equal the
    JAX package's bit for bit."""
    host = _special(_host(7, (40, 256)))
    hi = upload.upload_plane(host, "hi", CPU, chunk_bytes=7 * 256 * 2)
    lo = upload.upload_plane(host, "lo", CPU, chunk_bytes=7 * 256 * 2)
    trunc = upload.expand_hi(hi)
    full = upload.combine_lo(trunc, lo).numpy()
    np.testing.assert_array_equal(full.view(np.uint32), host.view(np.uint32))
    j_hi = jax_upload.upload_plane(host, "hi")
    j_lo = jax_upload.upload_plane(host, "lo")
    np.testing.assert_array_equal(hi.numpy().view(np.uint16), np.asarray(j_hi))
    np.testing.assert_array_equal(lo.numpy().view(np.uint16), np.asarray(j_lo))
    np.testing.assert_array_equal(
        trunc.numpy().view(np.uint32), np.asarray(jax_upload.expand_hi(j_hi)).view(np.uint32)
    )


def test_hi_alone_is_truncation():
    host = _host(8, (16, 256))
    trunc = upload.expand_hi(upload.upload_plane(host, "hi", CPU)).numpy()
    want = (host.view(np.uint32) & 0xFFFF0000).view(np.float32)
    np.testing.assert_array_equal(trunc.view(np.uint32), want.view(np.uint32))
    # truncation toward zero: under 2^-7 relative
    rel = np.abs(trunc - host) / np.maximum(np.abs(host), 1e-6)
    assert float(rel.max()) < 2**-7


def test_padded_rows_are_zero():
    host = _host(9, (10, 256))
    hi = upload.upload_plane(host, "hi", CPU, total_rows=16)
    lo = upload.upload_plane(host, "lo", CPU, total_rows=16)
    full = upload.combine_lo(upload.expand_hi(hi), lo).numpy()
    assert full.shape == (16, 256)
    np.testing.assert_array_equal(full[10:], 0.0)
    np.testing.assert_array_equal(full[:10], host)
    j_full = jax_upload.combine_lo(
        jax_upload.expand_hi(jax_upload.upload_plane(host, "hi", total_rows=16)),
        jax_upload.upload_plane(host, "lo", total_rows=16),
    )
    np.testing.assert_array_equal(full.view(np.uint32), np.asarray(j_full).view(np.uint32))


@pytest.mark.parametrize(
    "args",
    [(np.float64, "hi", None), (np.float32, "mid", None), (np.float32, "hi", 2)],
    ids=["float64", "bad_plane", "too_few_rows"],
)
def test_plane_rejects_bad_args(args):
    dtype, which, total_rows = args
    host = _host(10, (4, 256)).astype(dtype)
    with pytest.raises(ValueError):
        upload.upload_plane(host, which, CPU, total_rows=total_rows)
    with pytest.raises(ValueError):
        jax_upload.upload_plane(host, which, total_rows=total_rows)
