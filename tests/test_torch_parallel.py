"""Multi-device tables in the port against ``fastforward_tpu``.

The cases of ``tests/test_parallel.py`` (and the mesh cases of
``tests/test_score_transport.py`` and ``tests/test_serve.py``) run on the
port with ``device="cpu"`` and a mesh of CPU slots, against the JAX index on
its 8 virtual CPU devices (``tests/conftest.py``) with the same mesh, the
same rows (quantized indexes: the same codes, ``convert.index_from_codes``)
and the same query vectors, all made from a numpy seed.  Scores agree to
``places=3`` as there (``|a - b| < 5e-4``).  On the CPU the kernels run
their plain versions; which sharded program ran is read from the plans.
"""

import shutil
import tempfile

import numpy as np
import pytest
import torch

import fastforward_tpu as fj
import fastforward_tpu_torch as ft
from fastforward_tpu.encoder import LambdaEncoder as JaxLambdaEncoder
from fastforward_tpu.index import InMemoryIndex as JaxInMemoryIndex
from fastforward_tpu.index import Mode as JaxMode
from fastforward_tpu.parallel import MeshConfig as JaxMeshConfig
from fastforward_tpu.quantizer import OPQ as JaxOPQ
from fastforward_tpu.quantizer import PQ as JaxPQ
from fastforward_tpu.quantizer import ScalarQuantizer as JaxScalarQuantizer
from fastforward_tpu_torch import convert
from fastforward_tpu_torch.encoder import LambdaEncoder
from fastforward_tpu_torch.index import InMemoryIndex, Mode
from fastforward_tpu_torch.ops import scoring
from fastforward_tpu_torch.ops import stream_kernel as sk
from fastforward_tpu_torch.parallel import MeshConfig, mesh as mesh_module, sharded
from fastforward_tpu_torch.quantizer import ScalarQuantizer

DIM = 128
#: the JAX tests' tolerance, ``assertAlmostEqual(..., places=3)``
PLACES = 5e-4

MESHES = {"shard8": (1, 8), "data2_shard4": (2, 4), "data8": (8, 1)}


def _encoders(qvecs: dict):
    return (
        JaxLambdaEncoder(lambda t: qvecs[t]),
        LambdaEncoder(lambda t: qvecs[t]),
    )


def _rankings(run: dict, queries: dict):
    return fj.Ranking.from_run(run, queries=queries), ft.Ranking.from_run(run, queries=queries)


def _assert_close(got, want, msg=""):
    """The same pairs per query; scores within ``PLACES``."""
    assert set(got.q_ids) == set(want.q_ids), msg
    for q_id in want.q_ids:
        g, w = got[q_id], want[q_id]
        assert set(g) == set(w), (msg, q_id)
        for key in w:
            assert abs(g[key] - w[key]) < PLACES, (msg, q_id, key, g[key], w[key])


def _pair(cfg, mode, vectors, qvecs, quantizer=None, port_kwargs=None, jax_kwargs=None, **ids):
    """(JAX index, port index) over the same rows (or codes) and mesh."""
    jenc, penc = _encoders(qvecs)
    jkw = dict(jax_kwargs or {})
    pkw = dict(port_kwargs or {})
    if cfg is not None:
        jkw.setdefault("mesh_config", JaxMeshConfig(*cfg))
        pkw.setdefault("mesh_config", MeshConfig(*cfg))
    jidx = JaxInMemoryIndex(jenc, quantizer=quantizer, mode=JaxMode[mode.name], **jkw)
    jidx.add(vectors, **ids)
    if quantizer is None:
        pidx = InMemoryIndex(penc, mode=mode, device="cpu", **pkw)
        pidx.add(vectors, **ids)
    else:
        n = vectors.shape[0]
        pidx = convert.index_from_codes(
            jidx._store[:n], ids.get("doc_ids"), ids.get("psg_ids"), mode.name,
            convert.quantizer_from_state(*quantizer.serialize(), device="cpu"),
            query_encoder=penc, device="cpu", **pkw,
        )
    return jidx, pidx


# -- the mesh -------------------------------------------------------------------------


def test_mesh_layout_single_process():
    """One process: consecutive devices fill the shard axis; an explicit
    list may repeat a device (two shards on one card); too few devices
    raise ``ValueError`` (never fewer shards)."""
    m = MeshConfig(data=2, shard=4).build(device="cpu")
    assert m.shape == {"data": 2, "shard": 4}
    assert len(m.local_positions()) == 8 and not m.multiprocess
    m = MeshConfig(data=1, shard=2).build(devices=["cpu", "cpu"])
    assert m.devices.tolist() == [[torch.device("cpu"), torch.device("cpu")]]
    assert MeshConfig(2, 3).num_devices == 6
    with pytest.raises(ValueError):
        MeshConfig(data=16, shard=16).build()
    with pytest.raises(ValueError):
        JaxMeshConfig(data=16, shard=16).build()
    with pytest.raises(ValueError):
        MeshConfig(data=1, shard=3).build(devices=["cpu", "cpu"])


def test_mesh_memory_per_card():
    """A card named twice holds two shards: a per-device budget splits
    between them and the card takes one block cache; CPU slots (the JAX
    tests' virtual devices) each count as a device of their own."""
    card = torch.device("cuda", 0)
    twice = mesh_module.Mesh(np.array([[card, card]], dtype=object), np.zeros((1, 2), dtype=np.int64))
    assert twice.shards_per_device == 2 and twice.memory_devices == [card]
    grid = np.empty((2, 2), dtype=object)
    grid[:] = [[card, torch.device("cuda", 1)], [card, torch.device("cuda", 1)]]
    replicas = mesh_module.Mesh(grid, np.zeros((2, 2), dtype=np.int64))
    assert replicas.shards_per_device == 1 and len(replicas.memory_devices) == 2
    slots = MeshConfig(data=2, shard=4).build(device="cpu")
    assert slots.shards_per_device == 1 and len(slots.memory_devices) == 8


def test_mesh_layout_multi_process(monkeypatch):
    """Several processes: consecutive devices fill the data axis, so the
    shard axis crosses processes (``fastforward_tpu/parallel/mesh.py``):
    two processes of four slots at ``(2, 4)`` hold shards 0-1 and 2-3."""
    monkeypatch.setattr(mesh_module, "process_count", lambda: 2)
    monkeypatch.setattr(mesh_module, "process_index", lambda: 1)
    m = MeshConfig(data=2, shard=4).build(device="cpu")
    assert m.processes.tolist() == [[0, 0, 1, 1], [0, 0, 1, 1]]
    assert m.multiprocess and m.local_positions() == [(0, 2), (0, 3), (1, 2), (1, 3)]
    assert m.shard_home(1) is None and m.shard_home(2) == (0, torch.device("cpu"))
    m = MeshConfig(data=1, shard=2).build(devices=[(0, "cpu"), (1, "cpu")])
    assert m.processes.tolist() == [[0, 1]] and m.local_positions() == [(0, 1)]


# -- TestShardedScoring -------------------------------------------------------------------


@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(11)
    vectors = rng.normal(size=(200, DIM)).astype(np.float32)
    qvecs = {"a": rng.normal(size=DIM).astype(np.float32), "b": rng.normal(size=DIM).astype(np.float32)}
    return vectors, qvecs


@pytest.mark.parametrize("mode", ["MAXP", "AVEP", "FIRSTP", "PASSAGE"])
@pytest.mark.parametrize("cfg", list(MESHES))
def test_sharded_scoring(small, cfg, mode):
    """Sharded scoring equals the JAX package's sharded scoring and the
    port's single-device scoring in every mode."""
    vectors, qvecs = small
    mode = Mode[mode]
    n = len(vectors)
    ids = dict(doc_ids=[f"d{i // 4}" for i in range(n)], psg_ids=[f"p{i}" for i in range(n)])
    if mode == Mode.PASSAGE:
        run, queries = {"q1": {f"p{i}": float(i) for i in range(60)}}, {"q1": "a"}
    else:
        run = {"q1": {f"d{i}": float(i) for i in range(40)}, "q2": {f"d{i}": float(50 - i) for i in range(10, 50)}}
        queries = {"q1": "a", "q2": "b"}
    jidx, pidx = _pair(MESHES[cfg], mode, vectors, qvecs, **ids)
    plain = InMemoryIndex(_encoders(qvecs)[1], mode=mode, device="cpu")
    plain.add(vectors, **ids)
    jr, pr = _rankings(run, queries)
    got = pidx(pr)
    assert pidx._device_view().mesh is not None
    _assert_close(got, jidx(jr), (cfg, mode))
    _assert_close(got, plain(pr), (cfg, mode))


def test_sharded_ops_against_single_device():
    """The sharded programs themselves: the gather path against
    ``ops.score_pairs_grouped`` (K = 4, MAXP), the streamed path against
    ``ops.streamed_scores``, one kernel call per shard."""
    rng = np.random.default_rng(3)
    n, qb = 8192, 16
    table = rng.normal(size=(n, DIM)).astype(np.float32)
    q = rng.normal(size=(qb, DIM)).astype(np.float32)
    mesh = MeshConfig(data=2, shard=4).build(device="cpu")
    st = sharded.ShardedTable.from_reader(mesh, (n, DIM), lambda a, b: table[a:b])
    whole = torch.from_numpy(table)
    k, s_b = 4, 512
    idx = np.zeros((k + 1, s_b), dtype=np.int32)
    idx[:k] = rng.integers(0, n, size=(k, s_b))
    counts = rng.integers(1, k + 1, size=s_b)
    idx[k] = (rng.integers(0, qb, size=s_b) << 8) | counts
    got = sharded.score_pairs_sharded(mesh, st, q, idx, "max")
    want = scoring.score_pairs_grouped(whole, torch.from_numpy(q), torch.from_numpy(idx), "max")
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-6)
    rows = rng.integers(0, n, size=6000)
    qno = rng.integers(0, qb, size=6000)
    calls = []
    real = sk.stream_select_auto
    try:
        sk.stream_select_auto = lambda *a, **kw: calls.append(a[0].shape[0]) or real(*a, **kw)
        plan: dict = {}
        got = sharded.streamed_scores_sharded(mesh, st, q, rows, qno, plan=plan)
    finally:
        sk.stream_select_auto = real
    assert calls == [n // 4] * 4
    want = scoring.streamed_scores(whole, q, rows, qno)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)
    assert {"stream_sharded", "stream_sharded_dev", "stream_sharded_slot"} <= set(plan)


# -- TestShardedQuantized ----------------------------------------------------------


def test_scalar_quantizer_sharded_parity(small):
    """int8 codes shard row-wise; scores match the JAX package's."""
    vectors, qvecs = small
    sq = JaxScalarQuantizer()
    sq.fit(vectors)
    run = {"q1": {f"p{i}": float(i) for i in range(120)}}
    jidx, pidx = _pair((2, 4), Mode.PASSAGE, vectors, qvecs, quantizer=sq,
                       psg_ids=[f"p{i}" for i in range(200)])
    jr, pr = _rankings(run, {"q1": "a"})
    assert pidx._device_view().mesh is not None and pidx._device_view().kind == "scalar"
    _assert_close(pidx(pr), jidx(jr))


@pytest.mark.parametrize(
    "case", ["streamed", "gather", "maxp", "opq"]
)
def test_pq_sharded_parity(small, case):
    """PQ codes on a (2, 4) mesh with replicated codebooks: the per-shard
    streamed ADC, the gather ADC (sparse), MAXP, OPQ (its rotation folds
    into the queries)."""
    vectors, qvecs = small
    quantizer = JaxOPQ(8, 16, opq_iters=2) if case == "opq" else JaxPQ(8, 16)
    quantizer.fit(vectors)
    if case == "maxp":
        mode, ids, prefix, num = Mode.MAXP, {"doc_ids": [f"d{i // 4}" for i in range(200)]}, "d", 40
    else:
        mode, ids, prefix = Mode.PASSAGE, {"psg_ids": [f"p{i}" for i in range(200)]}, "p"
        num = 3 if case == "gather" else 120
    jidx, pidx = _pair((2, 4), mode, vectors, qvecs, quantizer=quantizer, **ids)
    jr, pr = _rankings({"q1": {f"{prefix}{i}": float(i) for i in range(num)}}, {"q1": "a"})
    got = pidx(pr)
    view = pidx._device_view()
    assert view.mesh is not None and view.kind == "pq"
    plan = next(iter(pidx._plans.values()))
    assert ("stream_sharded_pq" in plan) == (case != "gather")
    _assert_close(got, jidx(jr), case)


def test_dense_sharded_streamed_device_reduce():
    """Large-enough tables take the per-shard streamed path, the slot
    gather and (doc modes) the K-reduce on the device; warm calls reuse
    the grids."""
    rng = np.random.default_rng(12)
    n = 8192
    vectors = rng.normal(size=(n, DIM)).astype(np.float32)
    qvecs = {"a": rng.normal(size=DIM).astype(np.float32), "b": rng.normal(size=DIM).astype(np.float32)}
    ids = dict(doc_ids=[f"d{i // 4}" for i in range(n)], psg_ids=[f"p{i}" for i in range(n)])
    doc_run = {"q1": {f"d{i}": float(i) for i in range(400)}, "q2": {f"d{i}": float(i) for i in range(100, 500)}}
    psg_run = {"q1": {f"p{i}": float(i) for i in range(1200)}}
    for mode, run in ((Mode.MAXP, doc_run), (Mode.AVEP, doc_run), (Mode.PASSAGE, psg_run)):
        queries = {q: "ab"[i] for i, q in enumerate(run)}
        jidx, pidx = _pair((1, 8), mode, vectors, qvecs, **ids)
        jr, pr = _rankings(run, queries)
        got = pidx(pr)
        plan = next(iter(pidx._plans.values()))
        assert "stream_sharded" in plan and "stream_sharded_slot" in plan, mode
        _assert_close(got, jidx(jr), mode)
        assert got == pidx(pr)


@pytest.mark.parametrize("kind", ["dense", "int8"])
def test_device_store_sharded(kind):
    """``store="device"`` on a (2, 4) mesh: the buffer is allocated row
    sharded, grows across its allocation (4,096 rows to 8,192: the rows
    move to their new shards), and no host copy exists; scores match the
    JAX package's sharded device store."""
    rng = np.random.default_rng(13)
    n = 5000
    vectors = rng.normal(size=(n, DIM)).astype(np.float32)
    qvecs = {"a": rng.normal(size=DIM).astype(np.float32)}
    run = {"q1": {f"p{i}": float(i) for i in range(0, n, 25)}}
    quantizer = None
    if kind == "int8":
        quantizer = JaxScalarQuantizer()
        quantizer.fit(vectors)
    jenc, penc = _encoders(qvecs)
    jidx = JaxInMemoryIndex(jenc, quantizer=quantizer, mode=JaxMode.PASSAGE, store="device",
                            mesh_config=JaxMeshConfig(2, 4), init_size=128, alloc_size=128)
    pq = convert.quantizer_from_state(*quantizer.serialize(), device="cpu") if quantizer else None
    pidx = InMemoryIndex(penc, quantizer=pq, mode=Mode.PASSAGE, store="device",
                         mesh_config=MeshConfig(2, 4), init_size=128, alloc_size=128, device="cpu")
    for i in range(0, n, 1000):
        for idx in (jidx, pidx):
            idx.add(vectors[i : i + 1000], psg_ids=[f"p{j}" for j in range(i, i + 1000)])
        if i == 0:
            assert pidx._dev_table.shape[0] == 4096
    assert pidx._dev_table.shape[0] == 8192 and pidx._store is None
    assert pidx._device_view().mesh is not None
    jr, pr = _rankings(run, {"q1": "a"})
    _assert_close(pidx(pr), jidx(jr), kind)
    rows, _ = pidx._get_vectors(["p4999", "p7"])
    want = vectors[[4999, 7]] if quantizer is None else pq.encode(vectors[[4999, 7]])
    np.testing.assert_array_equal(rows.reshape(2, -1), want.reshape(2, -1))


def test_disk_hbm_cache_sharded(tmp_path):
    """``OnDiskIndex(hbm_cache=True, mesh_config=...)`` shards the cached
    table and matches the JAX package's sharded on-disk scores: dense, int8
    and PQ."""
    pytest.importorskip("h5py")
    from fastforward_tpu.index import OnDiskIndex as JaxOnDiskIndex
    from fastforward_tpu_torch.index import OnDiskIndex

    rng = np.random.default_rng(14)
    data = rng.normal(size=(150, DIM)).astype(np.float32)
    qvecs = {"a": rng.normal(size=DIM).astype(np.float32)}
    jenc, penc = _encoders(qvecs)
    run = {"q1": {f"p{i}": float(i) for i in range(100)}}
    jr, pr = _rankings(run, {"q1": "a"})
    for tag, jq in (("dense", None), ("int8", JaxScalarQuantizer()), ("pq", JaxPQ(8, 16))):
        if jq is not None:
            jq.fit(data)
        jdisk = JaxOnDiskIndex(tmp_path / f"j_{tag}.h5", jenc, quantizer=jq, mode=JaxMode.PASSAGE,
                               hbm_cache=True, mesh_config=JaxMeshConfig(1, 8))
        jdisk.add(data, psg_ids=[f"p{i}" for i in range(150)])
        pq = convert.quantizer_from_state(*jq.serialize(), device="cpu") if jq else None
        pdisk = OnDiskIndex(tmp_path / f"p_{tag}.h5", penc, quantizer=pq, mode=Mode.PASSAGE,
                            hbm_cache=True, mesh_config=MeshConfig(1, 8), device="cpu")
        pdisk._add(jdisk._get_vectors([f"p{i}" for i in range(150)])[0] if jq else data,
                   [None] * 150, [f"p{i}" for i in range(150)])
        assert pdisk._device_view().mesh is not None
        _assert_close(pdisk(pr), jdisk(jr), tag)


# -- TestShardedRagged, TestShardedEarlyStopping ------------------------------------------


def test_ragged_documents_over_group_k():
    """Documents with more passages than ``_MAX_GROUP_K`` score on the mesh
    through the flat segment path (per-row scores over the shards, then the
    mode's segment reduce) and match the JAX package's (MAXP, AVEP,
    FIRSTP)."""
    rng = np.random.default_rng(15)
    n, big, mid = 400, 100, 70
    vectors = rng.normal(size=(n, DIM)).astype(np.float32)
    qvecs = {"a": rng.normal(size=DIM).astype(np.float32), "b": rng.normal(size=DIM).astype(np.float32)}
    doc_ids = ["dbig"] * big + ["dmid"] * mid + [f"d{i // 4}" for i in range(n - big - mid)]
    run = {"q1": {"dbig": 9.0, "dmid": 8.0, "d0": 7.0, "d5": 6.0}, "q2": {"dmid": 5.0, "d1": 4.0, "dbig": 3.0}}
    for mode in (Mode.MAXP, Mode.AVEP, Mode.FIRSTP):
        jidx, pidx = _pair((2, 4), mode, vectors, qvecs, doc_ids=doc_ids)
        jr, pr = _rankings(run, {"q1": "a", "q2": "b"})
        _assert_close(pidx(pr), jidx(jr), mode)


def test_early_stopping_sharded_parity(small):
    """Early stopping on a (2, 4) mesh matches the JAX package's, cold and
    warm."""
    vectors, qvecs = small
    kwargs = dict(early_stopping=5, early_stopping_alpha=0.3, early_stopping_depths=(20, 120))
    run = {f"q{j}": {f"p{i}": float(120 - i) for i in range(120)} for j in range(3)}
    queries = {f"q{j}": "ab"[j % 2] for j in range(3)}
    jidx, pidx = _pair((2, 4), Mode.PASSAGE, vectors, qvecs, psg_ids=[f"p{i}" for i in range(200)])
    jr, pr = _rankings(run, queries)
    out = pidx(pr, **kwargs)
    assert out == pidx(pr, **kwargs)
    _assert_close(out, jidx(jr, **kwargs))


# -- TestShardedHybrid -------------------------------------------------------------------

HYB_N = 12288


@pytest.fixture(scope="module")
def hybrid_data():
    rng = np.random.default_rng(16)
    corpus = rng.normal(size=(HYB_N, DIM)).astype(np.float32)
    qvecs = {"a": rng.normal(size=DIM).astype(np.float32), "b": rng.normal(size=DIM).astype(np.float32)}
    return corpus, qvecs


def _hybrid_pair(hybrid_data, make_quantizer, mode, budget):
    corpus, qvecs = hybrid_data
    quantizer = None
    if make_quantizer is not None:
        quantizer = make_quantizer()
        quantizer.fit(corpus[:2048])
    ids = {"psg_ids": [f"p{i}" for i in range(HYB_N)]} if mode == Mode.PASSAGE else {
        "doc_ids": [f"d{i // 4}" for i in range(HYB_N)]
    }
    kw = dict(hbm_budget=budget, stream_chunk_rows=1024)
    jidx, pidx = _pair((2, 4), mode, corpus, qvecs, quantizer=quantizer, port_kwargs=kw,
                       jax_kwargs=kw, **ids)
    view = pidx._device_view()
    assert view.kind == "hybrid" and view.mesh is not None
    assert view.tail_start == jidx._device_view().tail_start > 0
    assert view.host_tail.shape[0] > 0
    return jidx, pidx


@pytest.mark.parametrize(
    "case,quant,mode,budget,step",
    [
        ("dense", None, "PASSAGE", 1 << 20, 3),
        ("dense_maxp", None, "MAXP", 1 << 20, 2),
        ("dense_sparse", None, "PASSAGE", 1 << 20, 700),
        ("scalar", "int8", "PASSAGE", 250_000, 5),
        ("pq", "pq", "PASSAGE", 40_000, 5),
        ("pq_maxp", "pq", "MAXP", 40_000, 3),
    ],
)
def test_sharded_hybrid(hybrid_data, case, quant, mode, budget, step):
    """The sharded hybrid tier: the prefix row-shards over the mesh (a
    per-device budget) and the tail streams; cold and warm calls match the
    JAX package's sharded hybrid index."""
    make = {None: None, "int8": JaxScalarQuantizer, "pq": lambda: JaxPQ(16, 16)}[quant]
    mode = Mode[mode]
    jidx, pidx = _hybrid_pair(hybrid_data, make, mode, budget)
    if mode == Mode.PASSAGE:
        run = {"q1": {f"p{i}": float(i) for i in range(0, HYB_N, step)}}
        if case == "dense":
            run["q2"] = {f"p{i}": float(i) for i in range(1, HYB_N, 7)}
    else:
        run = {"q1": {f"d{i}": float(i) for i in range(0, HYB_N // 4, step)}}
    jr, pr = _rankings(run, {q: "ab"[i] for i, q in enumerate(run)})
    for _round in ("cold", "warm"):
        _assert_close(pidx(pr), jidx(jr), (case, _round))


def test_tail_chunks_spread_across_devices(hybrid_data):
    """With a mesh the tail chunks go to its devices in contiguous ranges
    (one range a device), their grids on their devices, and the scores match
    the JAX package's."""
    jidx, pidx = _hybrid_pair(hybrid_data, None, Mode.PASSAGE, 1 << 20)
    run = {"q1": {f"p{i}": float(i) for i in range(0, HYB_N, 2)}}
    jr, pr = _rankings(run, {"q1": "a"})
    _assert_close(pidx(pr), jidx(jr))
    state = next(iter(pidx._plans.values()))["hybrid"]
    used = {c["dev"] for c in state["chunks"]}
    assert len(used) > 1 and len(state["dev_ranges"]) == len(used)
    for chunk in state["chunks"]:
        assert chunk["cand"].device == state["devices"][chunk["dev"]]


def test_early_stopping_and_ragged_on_sharded_hybrid(hybrid_data):
    """Early stopping, and a 100-passage document (the flat path), on the
    sharded hybrid tier match the JAX package's."""
    corpus, qvecs = hybrid_data
    jidx, pidx = _hybrid_pair(hybrid_data, None, Mode.PASSAGE, 1 << 20)
    kwargs = dict(early_stopping=10, early_stopping_alpha=0.5, early_stopping_depths=(64, 512, 2048))
    jr, pr = _rankings({"q1": {f"p{i}": float(i) for i in range(0, HYB_N, 3)}}, {"q1": "a"})
    _assert_close(pidx(pr, **kwargs), jidx(jr, **kwargs))
    doc_ids = ["dBIG"] * 100 + [f"d{i}" for i in range(100, HYB_N)]
    kw = dict(hbm_budget=1 << 20, stream_chunk_rows=1024)
    jidx, pidx = _pair((2, 4), Mode.MAXP, corpus, qvecs, port_kwargs=kw, jax_kwargs=kw, doc_ids=doc_ids)
    jr, pr = _rankings({"q1": {"dBIG": 3.0, "d5000": 2.0, f"d{HYB_N - 1}": 1.0}}, {"q1": "a"})
    _assert_close(pidx(pr), jidx(jr))


def test_whole_mesh_budget_fits_plain_sharded(hybrid_data):
    """A corpus within shards x budget builds the plain sharded view."""
    corpus, qvecs = hybrid_data
    index = InMemoryIndex(_encoders(qvecs)[1], mode=Mode.PASSAGE, mesh_config=MeshConfig(2, 4),
                          hbm_budget=4 << 20, device="cpu")
    index.add(corpus, psg_ids=[f"p{i}" for i in range(HYB_N)])
    view = index._device_view()
    assert view.kind == "dense" and view.mesh is not None


# -- the mesh cases of test_score_transport.py and test_serve.py ----------------------------


def _serve_build(seed, n, dim, num_q, depth, **kw):
    rng = np.random.default_rng(seed)
    corpus = rng.standard_normal((n, dim)).astype(np.float32)
    qvecs = {f"query {i}": rng.standard_normal(dim).astype(np.float32) for i in range(num_q)}
    index = InMemoryIndex(LambdaEncoder(lambda t: qvecs[t]), mode=Mode.PASSAGE, device="cpu", **kw)
    index.add(corpus, psg_ids=[f"p{i}" for i in range(n)])
    run = {
        f"q{i}": {f"p{j}": float(rng.standard_normal()) for j in rng.choice(n, size=depth, replace=False)}
        for i in range(num_q)
    }
    return index, ft.Ranking.from_run(run, queries={f"q{i}": f"query {i}" for i in range(num_q)})


def test_mesh_sharded_table_u16_transport():
    """The u16 score transport over a table sharded four ways scores within
    its bound of the f32 single-device index."""
    index, ranking = _serve_build(4, 4096, DIM, 5, 48, score_transport="u16",
                                  mesh_config=MeshConfig(shard=4))
    plain, ranking_f32 = _serve_build(4, 4096, DIM, 5, 48)
    got, want = index(ranking), plain(ranking_f32)
    scores = np.concatenate([list(want[q].values()) for q in want.q_ids])
    bound = (scores.max() - scores.min()) / 131070 + 1e-6
    for q in want.q_ids:
        assert set(got[q]) == set(want[q])
        for key in want[q]:
            assert abs(got[q][key] - want[q][key]) <= bound


@pytest.mark.parametrize("fused", [False, True], ids=["serve", "stays_fused"])
def test_sharded_mesh_serve(fused):
    """``serve`` on a (2, 4) mesh equals ``interpolate(...).cut(...)``; with
    the streamed scores on the device the serve tail stays fused:
    ``submit_serve`` defers (``test_sharded_mesh_serve_stays_fused``)."""
    if fused:
        index, ranking = _serve_build(18, 8192, DIM, 4, 64, mesh_config=MeshConfig(2, 4))
    else:
        index, ranking = _serve_build(11, 2048, DIM, 4, 32, mesh_config=MeshConfig(2, 4))
    want = ranking.interpolate(index(ranking), 0.3).cut(10)
    fut = index.submit_serve(ranking, 0.3, 10)
    assert fut.pipelined
    got = fut.result()
    for q in want.q_ids:
        assert list(got[q]) == list(want[q])
        for key in want[q]:
            assert abs(got[q][key] - want[q][key]) < 1e-4
    assert index.serve(ranking, 0.3, 10, refine=8) == got  # no refine on a mesh


def test_scalar_sharded_view_needs_whole_lanes():
    """Sharded vector and int8 tables need ``dim % 128 == 0``, as in the
    JAX package."""
    rng = np.random.default_rng(17)
    vectors = rng.normal(size=(64, 96)).astype(np.float32)
    index = InMemoryIndex(mode=Mode.PASSAGE, mesh_config=MeshConfig(1, 2), device="cpu")
    index.add(vectors, psg_ids=[f"p{i}" for i in range(64)])
    with pytest.raises(ValueError, match="dim % 128"):
        index._device_view()
    sq = ScalarQuantizer()
    sq.fit(vectors)
    index = InMemoryIndex(quantizer=sq, mode=Mode.PASSAGE, mesh_config=MeshConfig(1, 2), device="cpu",
                          store="device")
    with pytest.raises(ValueError, match="dim % 128"):
        index.add(vectors, psg_ids=[f"p{i}" for i in range(64)])
