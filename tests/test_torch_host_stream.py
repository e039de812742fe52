"""The hybrid tier beyond device memory: the port against ``fastforward_tpu``'s.

Every case of ``tests/test_host_stream.py`` that applies runs on the port.
A small ``hbm_budget`` forces a corpus of 6,000 rows at dim 128 through the
hybrid tier (a resident prefix and host-tail blocks of 1,024 rows,
``ops.host_stream``); both packages build their index from the same numpy
corpus (quantized indexes hold the JAX package's codes,
``convert.index_from_codes``) and must split the table at the same row
(``tail_start``).  The port runs on the CPU, so its kernels run their plain
versions.

Tolerances: against the port's own whole-table index, passage scores are
equal (the same dots in the same order) and document-mode scores agree
within 1e-6 (the hybrid tier sums a pair's rows per side in another order);
against the JAX package's hybrid index, within atol 1e-4, rtol 1e-5 (fp32
sums in another order), and quantized tables within atol 5e-4 (the JAX
tests' ``places=3``).

Not applicable to the port: ``TestHybridPallasFallback`` and
``test_scan_state_retries_pallas_after_transient_failure`` (the port has no
scan to fall back to: on a CUDA tensor a wrapper launches its kernel or
raises).  The sharded hybrid tier (``mesh_config`` with ``hbm_budget``)
runs against the JAX package's in ``tests/test_torch_parallel.py``.
"""

import tempfile
from pathlib import Path

import numpy as np
import pytest

import fastforward_tpu_torch as ft
from fastforward_tpu.encoder import LambdaEncoder as JaxLambdaEncoder
from fastforward_tpu.index import InMemoryIndex as JaxInMemoryIndex
from fastforward_tpu.index import Mode as JaxMode
from fastforward_tpu.quantizer import OPQ as JaxOPQ
from fastforward_tpu.quantizer import PQ as JaxPQ
from fastforward_tpu.quantizer import ScalarQuantizer as JaxScalarQuantizer
from fastforward_tpu.ranking import Ranking as JaxRanking
from fastforward_tpu_torch import convert
from fastforward_tpu_torch.encoder import LambdaEncoder
from fastforward_tpu_torch.index import InMemoryIndex, Mode, memory
from fastforward_tpu_torch.ops import host_stream
from fastforward_tpu_torch.parallel import MeshConfig

RNG = np.random.default_rng(123)
N, DIM = 6000, 128
CORPUS = RNG.normal(size=(N, DIM)).astype(np.float32)
QVECS = {q: RNG.normal(size=DIM).astype(np.float32) for q in "abc"}
PSG_IDS = [f"p{i}" for i in range(N)]
DOC_IDS = [f"d{i // 4}" for i in range(N)]
#: 1 MiB: a resident prefix of 1,024 rows at dim 128 fp32, ~5 streamed chunks
BUDGET = 1 << 20
HYBRID = {"hbm_budget": BUDGET, "stream_chunk_rows": 1024}
#: the budgets of ``TestHybridQuantized``: int8 (N x 128 codes, 0.77 MB) and
#: PQ(16, 16) codes (N x 16, 94 KiB)
INT8_BUDGET, PQ_BUDGET = 400_000, 50_000


def _jax_enc():
    return JaxLambdaEncoder(lambda q: QVECS[q])


def _enc():
    return LambdaEncoder(lambda q: QVECS[q])


def _ids(mode: str) -> dict:
    return {"psg_ids": PSG_IDS} if mode == "PASSAGE" else {"doc_ids": DOC_IDS}


def _jax_index(mode: str, quantizer=None, corpus=CORPUS, **kwargs):
    index = JaxInMemoryIndex(_jax_enc(), quantizer=quantizer, mode=JaxMode[mode], **kwargs)
    index.add(corpus, **_ids(mode))
    return index


def _port_index(mode: str, jax_index=None, corpus=CORPUS, **kwargs):
    """The port's index of the corpus; with a quantized ``jax_index``, of
    that index's codes and quantizer."""
    quantizer = getattr(jax_index, "_quantizer", None)
    if quantizer is not None:
        ids = _ids(mode)
        return convert.index_from_codes(
            jax_index._store[:N], ids.get("doc_ids"), ids.get("psg_ids"), mode,
            convert.quantizer_from_state(*quantizer.serialize(), device="cpu"),
            query_encoder=_enc(), device="cpu", **kwargs,
        )
    index = InMemoryIndex(_enc(), mode=Mode[mode], device="cpu", **kwargs)
    index.add(corpus, **_ids(mode))
    return index


def _rankings(run: dict, queries: dict) -> tuple:
    """The same run as a ranking of each package: ``(port, jax)``."""
    return ft.Ranking.from_run(run, queries=queries), JaxRanking.from_run(run, queries=queries)


def _psg_run(step_a=3, step_b=7) -> dict:
    return {
        "q1": {f"p{i}": float(i) for i in range(0, N, step_a)},
        "q2": {f"p{i}": float(i) for i in range(1, N, step_b)},
    }


def _doc_run() -> dict:
    return {
        "q1": {f"d{i}": float(i) for i in range(0, N // 4, 2)},
        "q2": {f"d{i}": float(i) for i in range(0, N // 4, 5)},
    }


QUERIES = {"q1": "a", "q2": "b"}


def _frame(ranking) -> "tuple[np.ndarray, np.ndarray]":
    df = ranking._df.sort_values(["q_id", "id"])
    keys = (df["q_id"].astype(str) + "\0" + df["id"].astype(str)).to_numpy()
    return keys, df["score"].to_numpy(dtype=np.float64)


def _assert_close(got, want, atol: float, rtol: float = 0.0) -> None:
    """The same (query, id) pairs, scores within ``atol + rtol * |want|``."""
    k_got, s_got = _frame(got)
    k_want, s_want = _frame(want)
    np.testing.assert_array_equal(k_got, k_want)
    np.testing.assert_allclose(s_got, s_want, atol=atol, rtol=rtol)


def _assert_parity(port, port_plain, jax, ranking, jax_ranking, plain_atol=0.0, jax_atol=1e-4):
    """Cold and warm: the port's hybrid index against its whole-table index
    and against the JAX package's hybrid index."""
    for _round in ("cold", "warm"):
        got = port(ranking)
        _assert_close(got, port_plain(ranking), atol=plain_atol)
        _assert_close(got, jax(jax_ranking), atol=jax_atol, rtol=1e-5)


@pytest.fixture(scope="module")
def psg():
    """``(port hybrid, port whole-table, JAX hybrid)`` passage indexes."""
    return _port_index("PASSAGE", **HYBRID), _port_index("PASSAGE"), _jax_index("PASSAGE", **HYBRID)


@pytest.fixture(scope="module")
def doc():
    """The same in ``Mode.MAXP`` over documents of 4 passages."""
    return _port_index("MAXP", **HYBRID), _port_index("MAXP"), _jax_index("MAXP", **HYBRID)


def _same_split(port, jax) -> None:
    pv, jv = port._device_view(), jax._device_view()
    assert pv.kind == jv.kind == "hybrid"
    assert pv.tail_start == jv.tail_start
    assert pv.hybrid_kind == jv.hybrid_kind
    assert pv.tail_start + pv.host_tail.shape[0] == N


# -- TestHybridTier ------------------------------------------------------------------


def test_forced_hybrid_view(psg):
    port, _, jax = psg
    _same_split(port, jax)
    view = port._device_view()
    assert view.tail_start == 1024 and view.hybrid_kind == "dense"
    assert view.tail_cache_budget == jax._device_view().tail_cache_budget


def test_passage_parity_cold_and_warm(psg):
    port, plain, jax = psg
    ranking, jax_ranking = _rankings(_psg_run(), QUERIES)
    expected = plain(ranking)
    assert port(ranking) == expected  # cold
    assert port(ranking) == expected  # warm plan
    _assert_close(port(ranking), jax(jax_ranking), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("mode", ["MAXP", "AVEP", "FIRSTP"])
def test_doc_modes_parity(doc, mode):
    port, plain, jax = doc
    port.mode = plain.mode = Mode[mode]
    jax.mode = JaxMode[mode]
    try:
        ranking, jax_ranking = _rankings(_doc_run(), QUERIES)
        _assert_parity(port, plain, jax, ranking, jax_ranking, plain_atol=1e-6)
    finally:
        port.mode = plain.mode = Mode.MAXP
        jax.mode = JaxMode.MAXP


@pytest.mark.parametrize("mode", ["MAXP", "AVEP"])
def test_doc_modes_fetch_pairs_not_rows(doc, mode):
    """Document modes reduce each side on the device: a warm call fetches
    ``2 x n_pairs`` floats (both sides hold rows of every query's pairs
    here), not one per row."""
    port, _, _ = doc
    port.mode = Mode[mode]
    try:
        ranking, _ = _rankings(_doc_run(), QUERIES)
        n_pairs = len(ranking._df)
        port(ranking)  # cold: the plan
        host_stream.reset_stats()
        port(ranking)
        assert host_stream.STATS["fetch_floats"] == 2 * n_pairs
        plan = port._get_plan(ranking)["hybrid"]
        assert plan["res_pos"].shape[0] + plan["p_tail"] > 2 * n_pairs  # rows, not pairs
    finally:
        port.mode = Mode.MAXP


def test_zero_resident_prefix():
    """A budget too small for one resident step streams every row."""
    port = _port_index("PASSAGE", hbm_budget=100_000, stream_chunk_rows=1024)
    jax = _jax_index("PASSAGE", hbm_budget=100_000, stream_chunk_rows=1024)
    _same_split(port, jax)
    assert port._device_view().tail_start == 0
    ranking, jax_ranking = _rankings(_psg_run(), QUERIES)
    assert port(ranking) == _port_index("PASSAGE")(ranking)
    _assert_close(port(ranking), jax(jax_ranking), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("step, streamed", [(500, True), (1500, False)])
def test_sparse_candidates_parity(psg, step, streamed):
    """Few candidates (the early-stopping regime): every 500th row still
    streams the prefix (3 pairs x 500 > 1,024 resident rows), every 1,500th
    takes the gather-dot; scores within the JAX test's ``places=4``."""
    port, plain, jax = psg
    run = {"q1": {f"p{i}": float(i) for i in range(0, N, step)}}
    ranking, jax_ranking = _rankings(run, {"q1": "a"})
    _assert_close(port(ranking), plain(ranking), atol=1e-4)
    _assert_close(port(ranking), jax(jax_ranking), atol=1e-4)
    assert ("stream" in port._get_plan(ranking)["hybrid"]["res_plan"]) == streamed


def test_early_stopping_parity(psg):
    port, plain, jax = psg
    ranking, jax_ranking = _rankings(_psg_run(), QUERIES)
    kwargs = dict(early_stopping=10, early_stopping_alpha=0.5, early_stopping_depths=(50, 500, 2000))
    assert port(ranking, **kwargs) == plain(ranking, **kwargs)
    _assert_close(port(ranking, **kwargs), jax(jax_ranking, **kwargs), atol=1e-4, rtol=1e-5)


def test_batched_queries_parity(psg):
    port, plain, jax = psg
    ranking, jax_ranking = _rankings(_psg_run(), QUERIES)
    assert port(ranking, batch_size=1) == plain(ranking)
    _assert_close(port(ranking, batch_size=1), jax(jax_ranking), atol=1e-4, rtol=1e-5)


def test_device_block_cache_within_budget():
    """Warm plans keep tail blocks on the device within the budget left
    over; the results are the same either way."""
    port = _port_index("PASSAGE", **HYBRID)
    ranking, _ = _rankings(_psg_run(), QUERIES)
    first = port(ranking)
    assert port._get_plan(ranking)["hybrid"]["chunks"]
    view = port._device_view()
    cached = view.aux.get("tail_blocks", {})
    assert cached, "no block was cached despite a budget left over"
    held = sum(ent[1] for ent in cached.values())
    assert held <= view.tail_cache_budget and view.aux["tail_bytes"] == held
    assert port(ranking) == first


def test_sparse_chunks_stage_bucketed_blocks():
    """A sparse candidate set copies (and caches) blocks sized to its unique
    rows, not to ``chunk_rows``, so a warm call copies no table bytes."""
    kwargs = {"hbm_budget": (1 << 20) + (1 << 18), "stream_chunk_rows": 4096}
    port = _port_index("PASSAGE", **kwargs)
    jax = _jax_index("PASSAGE", **kwargs)
    _same_split(port, jax)
    ranking, jax_ranking = _rankings({"q1": {f"p{i}": 1.0 for i in range(0, N, 64)}}, {"q1": "a"})
    want = _port_index("PASSAGE")(ranking)
    assert port(ranking) == want
    for chunk in port._get_plan(ranking)["hybrid"]["chunks"]:
        assert chunk["block_rows"] < 4096
    host_stream.reset_stats()
    assert port(ranking) == want
    assert host_stream.STATS["upload_bytes"] == 0
    _assert_close(port(ranking), jax(jax_ranking), atol=1e-4, rtol=1e-5)


def test_add_invalidates_hybrid_view():
    port = _port_index("PASSAGE", **HYBRID)
    ranking, _ = _rankings(_psg_run(), QUERIES)
    port(ranking)
    extra = np.random.default_rng(5).normal(size=(8, DIM)).astype(np.float32)
    port.add(extra, psg_ids=[f"x{i}" for i in range(8)])
    assert port._dev_view is None
    out = port(ft.Ranking.from_run({"q1": {"x0": 1.0, "p0": 2.0}}, queries={"q1": "a"}))
    assert abs(out["q1"]["x0"] - float(extra[0] @ QVECS["a"])) < 1e-3
    assert port._device_view().host_tail.shape[0] == N + 8 - 1024


def test_rejects_store_device(monkeypatch):
    """``store="device"`` with a budget raises, as in the JAX package; a
    budget with a mesh builds the sharded hybrid tier in one process and
    raises the JAX package's error under several processes."""
    with pytest.raises(ValueError):
        InMemoryIndex(_enc(), store="device", hbm_budget=BUDGET, device="cpu")
    with pytest.raises(ValueError):
        JaxInMemoryIndex(_jax_enc(), store="device", hbm_budget=BUDGET)
    index = InMemoryIndex(
        _enc(), mode=Mode.PASSAGE, mesh_config=MeshConfig(data=1, shard=2), hbm_budget=BUDGET,
        device="cpu",
    )
    index.add(CORPUS, psg_ids=PSG_IDS)
    view = index._device_view()
    assert view.kind == "hybrid" and view.mesh is not None and view.host_tail.shape[0] > 0
    monkeypatch.setattr(memory, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="single-process"):
        InMemoryIndex(_enc(), mesh_config=MeshConfig(data=1, shard=2), hbm_budget=BUDGET, device="cpu")


# -- TestHybridOnDisk ----------------------------------------------------------------


@pytest.fixture(scope="module")
def h5_dir():
    pytest.importorskip("h5py")
    with tempfile.TemporaryDirectory() as tmp:
        yield Path(tmp)


def test_disk_hybrid_parity(h5_dir):
    """``OnDiskIndex.load(hbm_cache=True, hbm_budget=...)`` of a file the JAX
    package wrote: the same split, and scores equal to the port's
    whole-table disk index and close to the JAX package's hybrid one."""
    from fastforward_tpu.index import OnDiskIndex as JaxOnDiskIndex
    from fastforward_tpu_torch.index import OnDiskIndex

    path = h5_dir / "hybrid.h5"
    JaxOnDiskIndex(path, _jax_enc(), mode=JaxMode.PASSAGE).add(CORPUS, psg_ids=PSG_IDS)
    plain = OnDiskIndex.load(path, _enc(), mode=Mode.PASSAGE, hbm_cache=True, device="cpu")
    port = OnDiskIndex.load(path, _enc(), mode=Mode.PASSAGE, hbm_cache=True, device="cpu", **HYBRID)
    jax = JaxOnDiskIndex.load(path, _jax_enc(), mode=JaxMode.PASSAGE, hbm_cache=True, **HYBRID)
    _same_split(port, jax)
    ranking, jax_ranking = _rankings(_psg_run(), QUERIES)
    _assert_parity(port, plain, jax, ranking, jax_ranking)


# -- TestHybridBlockCacheBudget, TestHybridCacheEvictionAndViews ---------------------


def test_budget_bounds_total_across_plans():
    """The device block cache's budget bounds the view's total over every
    plan, and each plan's scores stay right."""
    port = _port_index("PASSAGE", **HYBRID)
    view = port._device_view()
    got = {}
    for start in range(5):
        ranking, _ = _rankings({"q1": {f"p{i}": float(i) for i in range(start, N, 5)}}, {"q1": "a"})
        out = port(ranking)["q1"]
        got.update({pid: out[pid] for pid in list(out)[:3]})
        assert view.aux.get("tail_bytes", 0) <= view.tail_cache_budget
    for pid, score in got.items():
        assert abs(float(CORPUS[int(pid[1:])] @ QVECS["a"]) - score) < 1e-3


def test_lru_eviction_reclaims_stale_blocks():
    """Blocks cached by earlier plans are evicted for later ones (least
    recently used first), and a repeat of the last plan hits without
    growing the cache."""
    port = _port_index("PASSAGE", **HYBRID)
    view = port._device_view()
    for start in range(8):
        port(ft.Ranking.from_run({"q1": {f"p{i}": 1.0 for i in range(start, N, 11)}}, queries={"q1": "a"}))
    blocks = view.aux["tail_blocks"]
    used = view.aux["tail_bytes"]
    assert used <= view.tail_cache_budget and used == sum(ent[1] for ent in blocks.values())
    before = set(blocks)
    host_stream.reset_stats()
    port(ft.Ranking.from_run({"q1": {f"p{i}": 1.0 for i in range(7, N, 11)}}, queries={"q1": "a"}))
    assert set(view.aux["tail_blocks"]) == before
    assert host_stream.STATS["uploads"] == 0 and host_stream.STATS["block_cache_hits"] > 0


def test_warm_calls_ship_no_table_bytes_within_budget():
    """When the budget left over holds a plan's blocks, warm calls copy no
    table bytes at all."""
    port = _port_index("PASSAGE", hbm_budget=(7 << 20) // 2, stream_chunk_rows=256)
    assert port._device_view().kind == "hybrid"
    ranking, _ = _rankings({"q1": {f"p{i}": 1.0 for i in range(0, N, 7)}}, {"q1": "a"})
    port(ranking)
    host_stream.reset_stats()
    port(ranking)
    assert host_stream.STATS["upload_bytes"] == 0
    assert host_stream.STATS["block_cache_hits"] > 0


def test_warm_calls_ship_only_what_the_cache_cannot_hold():
    """A tail larger than the budget, scanned in the same order every call:
    the blocks the cache took on the cold call stay (the blocks of the call
    in hand are never evicted for each other), so each warm call copies only
    the others, and copies the same bytes every time."""
    port = _port_index("PASSAGE", hbm_budget=(3 << 20) // 2, stream_chunk_rows=512)
    view = port._device_view()
    ranking, _ = _rankings({"q1": {f"p{i}": 1.0 for i in range(N)}}, {"q1": "a"})
    port(ranking)
    chunks = port._get_plan(ranking)["hybrid"]["chunks"]
    cached = len(view.aux["tail_blocks"])
    assert 0 < cached < len(chunks)
    for _ in range(2):
        host_stream.reset_stats()
        port(ranking)
        assert host_stream.STATS["block_cache_hits"] == cached
        assert host_stream.STATS["uploads"] == len(chunks) - cached


def test_dense_contiguous_blocks_are_views_not_cached():
    """A candidate set of every row streams contiguous chunks: views of the
    tail, so the plan keeps no host copy of them."""
    port = _port_index("PASSAGE", **HYBRID)
    ranking, _ = _rankings({"q1": {f"p{i}": float(i) for i in range(N)}}, {"q1": "a"})
    port(ranking)
    state = port._get_plan(ranking)["hybrid"]
    assert all(host_stream._chunk_contiguous(c) for c in state["chunks"])
    assert not any(c.get("block_host") is not None for c in state["chunks"])
    assert state.get("host_cached_bytes", 0) == 0


# -- TestHybridVeryRaggedDocs --------------------------------------------------------

RAGGED_IDS = ["dBIG"] * 100 + [f"d{i}" for i in range(100, N)]


@pytest.mark.parametrize(
    "mode, query, docs",
    [
        ("MAXP", "a", ("dBIG", "d5000", "d5999")),
        ("AVEP", "b", ("dBIG", "d4000", "d5999")),
        ("FIRSTP", "b", ("dBIG", "d4000", "d5999")),
    ],
)
def test_flat_segment_fallback_uses_hybrid_engine(mode, query, docs):
    """A document of more than 64 passages takes the flat segment path,
    which scores host-tail rows through the hybrid engine."""
    run = {"q1": {d: float(3 - i) for i, d in enumerate(docs)}}
    ranking, jax_ranking = _rankings(run, {"q1": query})
    out = []
    for kwargs in ({}, HYBRID):
        index = InMemoryIndex(_enc(), mode=Mode[mode], device="cpu", **kwargs)
        index.add(CORPUS, doc_ids=RAGGED_IDS)
        out.append(index(ranking))
    jax = JaxInMemoryIndex(_jax_enc(), mode=JaxMode[mode], **HYBRID)
    jax.add(CORPUS, doc_ids=RAGGED_IDS)
    plain, hybrid = out
    assert set(hybrid["q1"]) == set(docs)
    _assert_close(hybrid, plain, atol=1e-5)
    _assert_close(hybrid, jax(jax_ranking), atol=1e-4, rtol=1e-5)


# -- TestHybridQuantized -------------------------------------------------------------

_JAX_QUANTIZERS = {
    "scalar": (JaxScalarQuantizer, INT8_BUDGET),
    "pq": (lambda: JaxPQ(16, 16), PQ_BUDGET),
    "opq": (lambda: JaxOPQ(16, 16, opq_iters=2), PQ_BUDGET),
}


@pytest.fixture(scope="module")
def quantizers():
    """The JAX package's quantizers fitted on the corpus, once."""
    out = {}
    for name, (make, _) in _JAX_QUANTIZERS.items():
        q = make()
        q.fit(CORPUS)
        out[name] = q
    return out


def _quantized(quantizers, name: str, mode: str, disk_dir: "Path | None" = None):
    """``(port hybrid, port whole-table, JAX hybrid)`` over one set of codes."""
    budget = _JAX_QUANTIZERS[name][1]
    kwargs = {"hbm_budget": budget, "stream_chunk_rows": 1024}
    jax_plain = _jax_index(mode, quantizers[name])
    jax = _jax_index(mode, quantizers[name], **kwargs)
    return _port_index(mode, jax_plain, **kwargs), _port_index(mode, jax_plain), jax


def _assert_quantized_parity(triple, kind, ranking, jax_ranking):
    port, plain, jax = triple
    _same_split(port, jax)
    view = port._device_view()
    assert view.hybrid_kind == kind and view.host_tail.shape[0] > 0
    _assert_parity(port, plain, jax, ranking, jax_ranking, plain_atol=1e-5, jax_atol=5e-4)


@pytest.mark.parametrize("name, kind", [("scalar", "scalar"), ("pq", "pq"), ("opq", "pq")])
def test_quantized_passage_parity(quantizers, name, kind):
    """int8, PQ and OPQ (the rotation folds into the queries before the
    hybrid engine) passage re-ranks."""
    ranking, jax_ranking = _rankings(_psg_run(), QUERIES)
    _assert_quantized_parity(_quantized(quantizers, name, "PASSAGE"), kind, ranking, jax_ranking)


@pytest.mark.parametrize(
    "name, mode", [("scalar", "MAXP"), ("scalar", "AVEP"), ("scalar", "FIRSTP"), ("pq", "MAXP"), ("pq", "AVEP")]
)
def test_quantized_doc_modes_parity(quantizers, name, mode):
    triple = _quantized(quantizers, name, mode)
    ranking, jax_ranking = _rankings(_doc_run(), QUERIES)
    _assert_quantized_parity(triple, name, ranking, jax_ranking)


def test_pq_sparse_candidates_gather_adc(quantizers):
    """Few resident candidates take the gather-ADC."""
    ranking, jax_ranking = _rankings({"q1": {f"p{i}": float(i) for i in range(0, N, 500)}}, {"q1": "a"})
    triple = _quantized(quantizers, "pq", "PASSAGE")
    _assert_quantized_parity(triple, "pq", ranking, jax_ranking)
    assert "stream_pq" not in triple[0]._get_plan(ranking)["hybrid"]["res_plan"]


@pytest.mark.parametrize("name", ["scalar", "pq"])
def test_quantized_doc_modes_fetch_pairs_not_rows(quantizers, name):
    port, _, _ = _quantized(quantizers, name, "MAXP")
    ranking, _ = _rankings(_doc_run(), QUERIES)
    port(ranking)
    host_stream.reset_stats()
    port(ranking)
    assert host_stream.STATS["fetch_floats"] <= 2 * len(ranking._df)


def test_early_stopping_parity_scalar(quantizers):
    port, plain, jax = _quantized(quantizers, "scalar", "PASSAGE")
    ranking, jax_ranking = _rankings(_psg_run(), QUERIES)
    kwargs = dict(early_stopping=10, early_stopping_alpha=0.5, early_stopping_depths=(50, 500, 2000))
    _assert_close(port(ranking, **kwargs), plain(ranking, **kwargs), atol=1e-5)
    _assert_close(port(ranking, **kwargs), jax(jax_ranking, **kwargs), atol=5e-4)


def test_disk_quantized_hybrid(quantizers, h5_dir):
    """``OnDiskIndex(hbm_cache, hbm_budget)`` over a PQ file the JAX package
    wrote."""
    from fastforward_tpu.index import OnDiskIndex as JaxOnDiskIndex
    from fastforward_tpu_torch.index import OnDiskIndex

    path = h5_dir / "pq.h5"
    writer = JaxOnDiskIndex(path, _jax_enc(), quantizer=quantizers["pq"], mode=JaxMode.PASSAGE)
    writer.add(CORPUS, psg_ids=PSG_IDS)
    kwargs = {"hbm_budget": PQ_BUDGET, "stream_chunk_rows": 1024}
    plain = OnDiskIndex.load(path, _enc(), mode=Mode.PASSAGE, hbm_cache=True, device="cpu")
    port = OnDiskIndex.load(path, _enc(), mode=Mode.PASSAGE, hbm_cache=True, device="cpu", **kwargs)
    jax = JaxOnDiskIndex.load(path, _jax_enc(), mode=JaxMode.PASSAGE, hbm_cache=True, **kwargs)
    ranking, jax_ranking = _rankings(_psg_run(), QUERIES)
    _assert_quantized_parity((port, plain, jax), "pq", ranking, jax_ranking)


# -- the port's serving paths on the hybrid tier --------------------------------------


@pytest.mark.parametrize("mode", ["PASSAGE", "MAXP"])
def test_serve_on_hybrid(psg, doc, mode):
    """``serve`` on a hybrid view (its scores come from the host side of
    the copy; the fused tail runs on the device, and ``refine`` applies to
    whole dense tables only) equals the whole-table index's, and the JAX
    package's hybrid serve."""
    port, plain, jax = psg if mode == "PASSAGE" else doc
    run = _psg_run() if mode == "PASSAGE" else _doc_run()
    ranking, jax_ranking = _rankings(run, QUERIES)
    for refine in (None, 8):
        got = port.serve(ranking, 0.2, 10, refine=refine)
        _assert_close(got, plain.serve(ranking, 0.2, 10), atol=1e-6)
        _assert_close(got, jax.serve(jax_ranking, 0.2, 10), atol=1e-4, rtol=1e-5)


def test_batching_server_array_path_on_hybrid(psg):
    """The merged array path a ``BatchingServer`` drives scores a batch of
    requests through the hybrid tier, each request equal to its own
    ``serve``."""
    from fastforward_tpu_torch.utils.serving import BatchingServer

    port, _, _ = psg
    requests = [
        ft.Ranking.from_run({f"r{k}": {f"p{i}": float(i) for i in range(k, N, 13)}}, queries={f"r{k}": q})
        for k, q in enumerate("abc")
    ]
    calls = []
    arrays = port._serve_arrays

    def counted(*args, **kwargs):
        out = arrays(*args, **kwargs)
        calls.append(out is not None)
        return out

    port._serve_arrays = counted
    try:
        with BatchingServer(port, 0.2, 5, max_wait_ms=50.0) as server:
            futures = [server.submit(r) for r in requests]
            results = [f.result(timeout=60) for f in futures]
    finally:
        del port._serve_arrays
    assert calls and all(calls)
    for request, result in zip(requests, results):
        _assert_close(result, port.serve(request, 0.2, 5), atol=1e-6)


def test_bf16_hybrid_equals_bf16_table():
    """``device_dtype="bfloat16"``: the resident prefix and the tail blocks
    round to bf16 as the whole bf16 table does (blocks cross in fp32 and
    are cast on the device)."""
    ranking, _ = _rankings(_psg_run(), QUERIES)
    hybrid = _port_index("PASSAGE", device_dtype="bfloat16", hbm_budget=1 << 19, stream_chunk_rows=1024)
    view = hybrid._device_view()
    assert view.kind == "hybrid" and str(view.table.dtype) == "torch.bfloat16"
    _assert_close(hybrid(ranking), _port_index("PASSAGE", device_dtype="bfloat16")(ranking), atol=0.0)


def test_preload_warms_a_hybrid_view():
    """``preload`` builds the hybrid view and warms it; the warm plans are
    dropped and the blocks they cached stay within the budget."""
    port = _port_index("PASSAGE", **HYBRID)
    assert port.preload(warm=(4, 100), serve=(0.2, 5))
    assert not port._plans
    view = port._device_view()
    assert view.kind == "hybrid" and view.aux.get("tail_bytes", 0) <= view.tail_cache_budget
    ranking, _ = _rankings(_psg_run(), QUERIES)
    assert port(ranking) == _port_index("PASSAGE")(ranking)
