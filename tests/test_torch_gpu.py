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
from fastforward_tpu_torch.encoder import LambdaEncoder
from fastforward_tpu_torch.index import InMemoryIndex, Mode
from fastforward_tpu_torch.ops import scoring
from fastforward_tpu_torch.ops import stream_kernel as sk

pytestmark = pytest.mark.gpu

N_PAD, DIM, QB, P = 4096, 256, 16, 3000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _kernel_inputs(table_kind: str, seed: int, device):
    rng = np.random.default_rng(seed)
    if table_kind == "int8":
        table = torch.from_numpy(rng.integers(-127, 128, size=(N_PAD, DIM // 128, 128)).astype(np.int8))
    else:
        table = torch.from_numpy(rng.standard_normal((N_PAD, DIM), dtype=np.float32))
        if table_kind == "bf16":
            table = table.to(torch.bfloat16)
    q = torch.from_numpy(rng.standard_normal((QB, DIM), dtype=np.float32))
    rows = rng.integers(0, N_PAD, size=P)
    qno = rng.integers(0, QB, size=P)
    cap = scoring._adaptive_cap(P, N_PAD // sk.KERNEL_TILE_ROWS)
    cand, tile_idx, _ = scoring.build_streamed_layout(rows, qno, N_PAD, QB, cap=cap)
    cand3 = torch.from_numpy(cand.reshape(cand.shape[0], cap // 128, 128))
    return [t.to(device) for t in (table, q, cand3, torch.from_numpy(tile_idx))]


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("table_kind", ["fp32", "bf16", "int8"])
def test_cuda_kernel_matches_plain(cuda, table_kind, exact):
    """The CUDA kernel against the plain version on the same card tensors:
    the same products summed in another fp32 order (atol 1e-4, rtol 1e-5;
    atol 1e-3 for int8, as ``tests/test_stream_kernel.py:84,159``)."""
    args = _kernel_inputs(table_kind, 11, cuda)
    before = sk.stream_select_pairwise.launches
    got = sk.stream_select_pairwise(*args, exact=exact)
    assert sk.stream_select_pairwise.launches == before + 1
    want = sk.stream_select_pairwise_plain(*args, exact=exact)
    atol = 1e-3 if table_kind == "int8" else 1e-4
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=atol, rtol=1e-5)


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
