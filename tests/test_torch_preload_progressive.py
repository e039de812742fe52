"""The progressive (split-plane) preload of the port against ``fastforward_tpu``'s.

``tests/test_preload_progressive.py``'s ``TestProgressivePreload`` cases on
the port (its plane algebra is ``tests/test_torch_upload.py``'s): which
configurations take the split, the truncated table serving first and the
exact one after ``preload_join``, a preload without ``warm``, an ``add``
racing the upload (the swap is discarded, and ``stats["progressive"]`` says
so), ``preload_join`` without a pending upload, and configurations that
fall back to the standard upload.  Beside them: the interim and the exact
scores against the JAX package's on the same vectors, and the exact table's
fallback to a fresh upload when the card has no room for the combine.

Tolerances: the interim table is the fp32 table truncated to bf16
(``rtol 5e-3, atol 5e-2`` of the exact scores, the JAX test's; against the
JAX package's interim scores, which use the same truncated values, atol
1e-4, rtol 1e-5); the exact table equals the host rows bit for bit and its
scores equal the standard upload's.
"""

import logging

import numpy as np
import pandas as pd
import pytest

import fastforward_tpu.index.memory as jax_memory
import fastforward_tpu_torch.index.memory as memory
from fastforward_tpu import Ranking as JaxRanking
from fastforward_tpu.encoder import LambdaEncoder as JaxLambdaEncoder
from fastforward_tpu.index import InMemoryIndex as JaxInMemoryIndex
from fastforward_tpu.index import Mode as JaxMode
from fastforward_tpu_torch import Ranking
from fastforward_tpu_torch.encoder import LambdaEncoder
from fastforward_tpu_torch.index import InMemoryIndex, Mode
from fastforward_tpu_torch.quantizer import ScalarQuantizer

DIM = 256
N = 300


def _vecs(seed=0, n=N):
    return np.random.default_rng(seed).standard_normal((n, DIM)).astype(np.float32)


def _query_vector(text) -> np.ndarray:
    """Deterministic per query text, so repeat calls encode identically."""
    seed = int.from_bytes(str(text).encode()[:8].ljust(8, b"\0"), "little")
    return np.random.default_rng(seed % (2**31)).standard_normal(DIM).astype(np.float32)


def _add(index, vecs):
    index.add(vecs, doc_ids=None, psg_ids=[f"p{i}" for i in range(len(vecs))])


def _frame(num_q=4, depth=16) -> pd.DataFrame:
    rows = [
        {"q_id": f"q{q}", "id": f"p{(q * 31 + d) % N}", "score": float(depth - d)}
        for q in range(num_q)
        for d in range(depth)
    ]
    return pd.DataFrame(rows)


QUERIES = {f"q{q}": f"query {q}" for q in range(4)}


def _scores(ranking) -> np.ndarray:
    return ranking._df.sort_values(["q_id", "id"])["score"].to_numpy(dtype=np.float64)


@pytest.fixture(autouse=True)
def no_size_gate(monkeypatch):
    """The 512 MiB gate exists for production (small tables gain nothing);
    the tests run the machinery on tiny tables, in both packages."""
    monkeypatch.setattr(memory, "_MIN_PROGRESSIVE_BYTES", 0)
    monkeypatch.setattr(jax_memory, "_MIN_PROGRESSIVE_BYTES", 0)


def _index(**kwargs) -> InMemoryIndex:
    index = InMemoryIndex(LambdaEncoder(_query_vector), mode=Mode.PASSAGE, device="cpu", **kwargs)
    _add(index, _vecs())
    return index


def _jax_index() -> JaxInMemoryIndex:
    index = JaxInMemoryIndex(JaxLambdaEncoder(_query_vector), mode=JaxMode.PASSAGE)
    _add(index, _vecs())
    return index


@pytest.mark.parametrize(
    "kwargs, eligible",
    [
        ({}, True),
        ({"device_dtype": "bfloat16"}, False),
        ({"hbm_budget": 1 << 30}, False),
        ({"quantizer": "int8"}, False),
        ({"store": "device"}, False),
        ({"gate": 1 << 30}, False),
    ],
    ids=["fp32", "bf16", "budget", "int8", "device_store", "below_size_gate"],
)
def test_eligibility(monkeypatch, kwargs, eligible):
    kwargs = dict(kwargs)
    if "gate" in kwargs:
        monkeypatch.setattr(memory, "_MIN_PROGRESSIVE_BYTES", kwargs.pop("gate"))
    if kwargs.get("quantizer") == "int8":
        sq = ScalarQuantizer()
        sq.fit(_vecs()[:100])
        kwargs["quantizer"] = sq
    assert (_index(**kwargs)._progressive_job() is not None) == eligible


def test_interim_then_exact_scores():
    exact_index = _index()
    ranking = Ranking(_frame(), queries=QUERIES)
    want = exact_index(ranking)
    jax_index = _jax_index()
    jax_ranking = JaxRanking(_frame(), queries=QUERIES)
    assert jax_index.preload(warm=(4, 16), progressive=True)

    index = _index()
    assert index.preload(warm=(4, 16), progressive=True)
    stats = index._preload_stats
    assert stats["progressive"] is True and "activate_s" in stats
    view = index._device_view()
    assert view.kind == "dense" and str(view.table.dtype) == "torch.float32"
    interim = index(ranking)
    np.testing.assert_allclose(_scores(interim), _scores(want), rtol=5e-3, atol=5e-2)
    if not jax_index.preload_join(timeout=0.0):  # still interim there: compare
        np.testing.assert_allclose(_scores(interim), _scores(jax_index(jax_ranking)), atol=1e-4, rtol=1e-5)
    assert index.preload_join(timeout=60.0)
    assert stats["progressive_exact"] is True
    np.testing.assert_array_equal(index._device_view().table[:N].numpy(), exact_index._store[:N])
    after = index(Ranking(_frame(), queries=QUERIES))
    np.testing.assert_array_equal(_scores(after), _scores(want))
    assert jax_index.preload_join(timeout=60.0)
    np.testing.assert_allclose(
        _scores(after), _scores(jax_index(JaxRanking(_frame(), queries=QUERIES))), atol=1e-4, rtol=1e-5
    )


def test_interim_table_is_the_truncation():
    """The interim table holds every value with its low 16 bits zeroed."""
    index = _index()
    job = index._progressive_job()
    job.upload_hi()
    job._exact_tail = lambda trunc: None  # keep the interim table
    assert job.activate()
    index._progressive_thread.join(60.0)
    table = index._device_view().table[:N].numpy()
    want = (_vecs().view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    np.testing.assert_array_equal(table.view(np.uint32), want.view(np.uint32))
    assert not index._device_view().table[N:].any()


def test_without_warm():
    index = _index()
    assert index.preload(progressive=True)
    assert index._preload_stats["progressive"] is True
    assert index._dev_view is not None
    assert index.preload_join(timeout=60.0)
    np.testing.assert_array_equal(index._device_view().table[:N].numpy(), index._store[:N])


def test_add_race_discards_swap():
    index = _index()
    job = index._progressive_job()
    assert job is not None
    job.upload_hi()
    index.add(_vecs(9, 8), psg_ids=[f"race{i}" for i in range(8)])  # bumps the generation
    assert job.activate() is False
    # neither the interim nor the exact table is installed
    assert index._dev_view is None and index._progressive_thread is None


def test_add_race_in_preload_is_reported(monkeypatch, caplog):
    """An ``add`` between the hi planes' upload and the swap: ``preload``
    reports ``progressive`` False and the next call uploads the new rows."""
    index = _index()
    upload_hi = memory._ProgressiveUpload.upload_hi

    def racing(job):
        upload_hi(job)
        index.add(_vecs(9, 8), psg_ids=[f"race{i}" for i in range(8)])

    monkeypatch.setattr(memory._ProgressiveUpload, "upload_hi", racing)
    with caplog.at_level(logging.WARNING):
        assert index.preload(progressive=True)
    assert index._preload_stats["progressive"] is False
    assert "overlapped an add" in caplog.text
    assert index.preload_join(timeout=0.0)
    out = index(Ranking.from_run({"q0": {"race3": 1.0}}, queries={"q0": "query 0"}))
    assert abs(out["q0"]["race3"] - float(_vecs(9, 8)[3] @ _query_vector("query 0"))) < 1e-4


def test_exact_table_after_an_add_is_discarded(monkeypatch):
    """An ``add`` while the lo planes upload: the exact table of the old
    rows is not installed, and the next call serves the new rows."""
    index = _index()
    combine = memory.combine_lo

    def racing(trunc, lo):
        index.add(_vecs(10, 4), psg_ids=[f"late{i}" for i in range(4)])
        return combine(trunc, lo)

    monkeypatch.setattr(memory, "combine_lo", racing)
    assert index.preload(progressive=True)
    assert index.preload_join(timeout=60.0)
    assert "progressive_exact" not in index._preload_stats
    assert index._device_view().table.shape[0] >= N + 4
    out = index(Ranking.from_run({"q0": {"late1": 1.0}}, queries={"q0": "query 0"}))
    assert abs(out["q0"]["late1"] - float(_vecs(10, 4)[1] @ _query_vector("query 0"))) < 1e-4


def test_exact_table_falls_back_to_a_fresh_upload(monkeypatch):
    """No room for the split-plane combine (``torch.OutOfMemoryError``):
    the exact table comes from a fresh upload of the host rows, padded on
    the device only."""
    import torch

    def no_room(trunc, lo):
        raise torch.OutOfMemoryError("no room for the second table")

    shapes = []
    upload_table = memory.upload_table

    def recording(host, device, **kwargs):
        shapes.append((host.shape, kwargs.get("shape")))
        return upload_table(host, device, **kwargs)

    monkeypatch.setattr(memory, "combine_lo", no_room)
    monkeypatch.setattr(memory, "upload_table", recording)
    index = _index()
    assert index.preload(progressive=True)
    assert index.preload_join(timeout=60.0)
    assert index._preload_stats["progressive_exact"] is True
    assert shapes == [((N, DIM), (4096, DIM))]
    np.testing.assert_array_equal(index._device_view().table[:N].numpy(), index._store[:N])


def test_preload_join_noop():
    assert _index().preload_join()


@pytest.mark.parametrize("kwargs", [{"device_dtype": "bfloat16"}, {"hbm_budget": 1 << 30}])
def test_unsupported_config_falls_back(caplog, kwargs):
    index = _index(**kwargs)
    with caplog.at_level(logging.WARNING):
        assert index.preload(warm=(2, 8), progressive=True)
    assert "using the standard upload" in caplog.text
    assert not index._preload_stats.get("progressive", False)
    assert index._device_view() is not None
    assert index.preload_join()
