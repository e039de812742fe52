"""Several processes serving one index: a 2-process CPU job over gloo.

The port of ``tests/test_multihost.py`` / ``tests/_mh_worker.py``: two real
subprocesses, each with four CPU slots, join one ``torch.distributed`` job
(``parallel.multihost.initialize(backend="gloo")``), so the global mesh is
``(data=2, shard=4)`` with the shard axis across the processes.  Each builds
the same sharded ``InMemoryIndex`` (dense, MAXP documents, int8, PQ; the
int8 one narrowed to its shards' host rows) and
``OnDiskIndex(hbm_cache=True, mesh_config=...)`` tables read per shard from
the file; re-ranks, serves and early-stops through the public API, checks
its scores against numpy inside the worker, and prints a digest; the launcher requires both to
exit 0 with equal digests.  The worker is this file run as a script.  Each
worker also builds an index without ``mesh_config`` while it is in the job:
it runs no collective, so ``preload`` warms re-rank and serve side by side and
the server takes its merged array path (``_serve_prep``, ``_serve_arrays``).
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parent.parent

#: seconds one job may take
_JOB_TIMEOUT = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_job(port: int) -> "list[tuple[int, str]]":
    env = dict(os.environ, PYTHONPATH=str(_REPO), OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, str(rank), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=str(_REPO),
        )
        for rank in (0, 1)
    ]
    outputs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=_JOB_TIMEOUT)
            outputs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, out) for p, out in zip(procs, outputs)]


def test_two_process_mesh_parity():
    """Both processes pass their checks and print the same digest; a race
    for the probed port retries the job once on a fresh one."""
    for attempt in range(2):
        results = _run_job(_free_port())
        raced = any(
            rc != 0 and ("Address already in use" in out or "EADDRINUSE" in out)
            for rc, out in results
        )
        if not raced or attempt == 1:
            break
    digests = []
    for rank, (rc, out) in enumerate(results):
        assert rc == 0, f"worker {rank} failed:\n{out[-4000:]}"
        ok = [line for line in out.splitlines() if line.startswith("MH_OK")]
        assert len(ok) == 1, out[-2000:]
        digests.append(ok[0])
    assert digests[0] == digests[1]


# -- the worker -------------------------------------------------------------------------


def _worker(rank: int, port: str) -> None:
    import threading

    import torch

    from fastforward_tpu_torch.encoder import LambdaEncoder
    from fastforward_tpu_torch.index import InMemoryIndex, Mode
    from fastforward_tpu_torch.index.base import _multiprocess
    from fastforward_tpu_torch.ops import stream_kernel as sk
    from fastforward_tpu_torch.parallel import MeshConfig, multihost
    from fastforward_tpu_torch.quantizer import PQ, ScalarQuantizer
    from fastforward_tpu_torch.ranking import Ranking
    from fastforward_tpu_torch.utils.serving import BatchingServer

    torch.set_num_threads(1)
    multihost.initialize(f"localhost:{port}", num_processes=2, process_id=rank, backend="gloo")
    assert multihost.is_multiprocess() and multihost.process_count() == 2
    cfg = MeshConfig(data=2, shard=4)
    mesh = cfg.build(device="cpu")
    assert mesh.multiprocess and len(mesh.local_positions()) == 4

    rng = np.random.default_rng(7)  # the same seed on every process
    n, dim = 4096, 128
    corpus = rng.normal(size=(n, dim)).astype(np.float32)
    qvecs = {"a": rng.normal(size=dim).astype(np.float32), "b": rng.normal(size=dim).astype(np.float32)}
    enc = LambdaEncoder(lambda q: qvecs[q])
    digests = []

    # dense fp32, passages: the per-shard streamed path; each process
    # launches its two shards only
    index = InMemoryIndex(enc, mode=Mode.PASSAGE, mesh_config=cfg, device="cpu")
    index.add(corpus, psg_ids=[f"p{i}" for i in range(n)])
    assert index.preload()
    table = index._device_view().table
    assert table.local_shards() == ([0, 1] if rank == 0 else [2, 3]), table.local_shards()
    run = {"q1": {f"p{i}": float(i) for i in range(0, n, 3)}, "q2": {f"p{i}": float(i) for i in range(1, n, 5)}}
    ranking = Ranking.from_run(run, queries={"q1": "a", "q2": "b"})
    calls = []
    real = sk.stream_select_auto
    sk.stream_select_auto = lambda *a, **kw: calls.append(a[0].shape[0]) or real(*a, **kw)
    try:
        out = index(ranking)
    finally:
        sk.stream_select_auto = real
    assert calls == [n // 4, n // 4], calls
    assert "stream_sharded" in next(iter(index._plans.values()))
    for q_id, qk in (("q1", "a"), ("q2", "b")):
        for pid in list(out[q_id])[:16]:
            truth = float(corpus[int(pid[1:])] @ qvecs[qk])
            assert abs(truth - out[q_id][pid]) < 1e-3, (q_id, pid, truth)
    assert index(ranking) == out  # the warm plan
    digests.append(sum(sorted(out["q1"].values())[:50]))

    # MAXP documents: the K-reduce after the combine
    doc_index = InMemoryIndex(enc, mode=Mode.MAXP, mesh_config=cfg, device="cpu")
    doc_index.add(corpus, doc_ids=[f"d{i // 4}" for i in range(n)])
    doc_run = {"q1": {f"d{i}": float(i) for i in range(0, n // 4, 2)}}
    doc_out = doc_index(Ranking.from_run(doc_run, queries={"q1": "a"}))["q1"]
    for did in list(doc_out)[:16]:
        d = int(did[1:])
        truth = float(max(corpus[4 * d + j] @ qvecs["a"] for j in range(4)))
        assert abs(truth - doc_out[did]) < 1e-3, (did, truth)
    digests.append(sum(sorted(doc_out.values())[:50]))

    # int8 codes, then narrow_to_shard: half the host rows, the same scores
    sq = ScalarQuantizer()
    sq.fit(corpus[:1024])
    q_index = InMemoryIndex(enc, quantizer=sq, mode=Mode.PASSAGE, mesh_config=cfg, device="cpu")
    q_index.add(corpus, psg_ids=[f"p{i}" for i in range(n)])
    q_out = q_index(ranking)["q1"]
    decoded = sq.decode(sq.encode(corpus))
    for pid in list(q_out)[:8]:
        assert abs(float(decoded[int(pid[1:])] @ qvecs["a"]) - q_out[pid]) < 0.05, pid
    before = q_index._store.nbytes
    lo, hi = q_index.narrow_to_shard()
    assert (lo, hi) == ((0, n // 2) if rank == 0 else (n // 2, n)), (lo, hi)
    assert q_index._store.nbytes <= before // 2 + 1
    fresh = Ranking.from_run(run, queries={"q1": "a", "q2": "b"})
    assert q_index(fresh)["q1"] == q_out
    q_index._get_vectors([f"p{lo}"])
    for bad in ("read", "add"):
        try:
            if bad == "read":
                q_index._get_vectors([f"p{hi if hi < n else lo - 1}"])
            else:
                q_index.add(corpus[:1], psg_ids=["extra"])
            raise AssertionError(f"narrowed index allowed a {bad}")
        except (IndexError, RuntimeError):
            pass
    digests.append(sum(sorted(q_out.values())[:50]))

    # PQ codes with replicated codebooks: a sparse run takes the gather ADC
    pq = PQ(16, 16, device="cpu")
    pq.fit(corpus[:2048])
    pq_index = InMemoryIndex(enc, quantizer=pq, mode=Mode.PASSAGE, mesh_config=cfg, device="cpu")
    pq_index.add(corpus, psg_ids=[f"p{i}" for i in range(n)])
    pq_decoded = pq.decode(pq.encode(corpus))
    for name, r in (("dense", ranking), ("sparse", Ranking.from_run({"q1": {"p5": 1.0, "p4000": 2.0}}, queries={"q1": "a"}))):
        pq_out = pq_index(r)["q1"]
        for pid in list(pq_out)[:8]:
            assert abs(float(pq_decoded[int(pid[1:])] @ qvecs["a"]) - pq_out[pid]) < 0.05, (name, pid)
        digests.append(sum(sorted(pq_out.values())[:50]))

    # the lazy reader is asked only for this process's rows, and a sharded
    # table gathers whole through the host
    requested = []
    lazy = multihost.put_row_sharded_lazy(
        mesh, corpus.shape, np.float32, lambda a, b: requested.append((a, b)) or corpus[a:b]
    )
    assert sum(b - a for a, b in set(requested)) <= n // 2, requested
    np.testing.assert_array_equal(multihost.fetch_np(lazy), corpus)

    # OnDiskIndex(hbm_cache=True, mesh_config=...): each process reads only
    # its shards' rows from the file (dense, int8 and PQ tables)
    import tempfile
    from pathlib import Path

    from fastforward_tpu_torch.index import OnDiskIndex

    h5dir = Path(tempfile.mkdtemp())
    reads = []
    real_lazy = multihost.put_row_sharded_lazy

    def recording_lazy(mesh_, shape, dtype, read_rows):
        def recorded(a, b):
            reads.append((a, b))
            return read_rows(a, b)

        return real_lazy(mesh_, shape, dtype, recorded)

    for tag, quantizer, tol in (("dense", None, 1e-3), ("int8", sq, 0.05), ("pq", pq, 0.05)):
        path = h5dir / f"mh_{tag}_{rank}.h5"
        writer = OnDiskIndex(path, enc, quantizer=quantizer, mode=Mode.PASSAGE, device="cpu")
        writer.add(corpus, psg_ids=[f"p{i}" for i in range(n)])
        loaded = OnDiskIndex.load(path, enc, mode=Mode.PASSAGE, hbm_cache=True, mesh_config=cfg,
                                  device="cpu")
        reads.clear()
        multihost.put_row_sharded_lazy = recording_lazy
        try:
            view = loaded._device_view()
        finally:
            multihost.put_row_sharded_lazy = real_lazy
        assert reads and sum(b - a for a, b in reads) <= n // 2, (tag, reads)
        assert view.mesh is not None and view.table.local_shards() == ([0, 1] if rank == 0 else [2, 3])
        out = loaded(ranking)["q1"]
        rows_ref = corpus if quantizer is None else quantizer.decode(quantizer.encode(corpus))
        for pid in list(out)[:8]:
            assert abs(float(rows_ref[int(pid[1:])] @ qvecs["a"]) - out[pid]) < tol, (tag, pid)
        digests.append(sum(sorted(out.values())[:50]))

    # early stopping and the fused serve across processes
    es = dict(early_stopping=8, early_stopping_alpha=0.4, early_stopping_depths=(64, 512, 2048))
    es_out = index(Ranking.from_run(run, queries={"q1": "a", "q2": "b"}), **es)["q1"]
    full = {pid: float(corpus[int(pid[1:])] @ qvecs["a"]) for pid in run["q1"]}
    for pid in sorted(full, key=lambda k: 0.4 * run["q1"][k] + 0.6 * full[k])[-3:]:
        assert abs(es_out[pid] - full[pid]) < 1e-3, pid
    digests.append(sum(sorted(es_out.values())[-20:]))
    served = index.serve(ranking, 0.3, 5)
    want = {pid: 0.3 * run["q1"][pid] + 0.7 * full[pid] for pid in run["q1"]}
    assert set(served["q1"]) == set(sorted(want, key=want.get, reverse=True)[:5])
    assert index._serve_prep(ranking) is None  # the server's per-request path
    assert index.submit_serve(ranking, 0.3, 5).result() == served
    digests.append(sum(sorted(served["q1"].values())))

    # an index without a mesh in the same job runs no collective: the
    # server's merged array path and preload's concurrent warm-up stay on
    solo = InMemoryIndex(enc, mode=Mode.PASSAGE, device="cpu")
    solo.add(corpus, psg_ids=[f"p{i}" for i in range(n)])
    assert not _multiprocess(solo._device_view())
    serve_started, rerank_saw_serve = threading.Event(), []
    real_serve, real_score = solo.serve, solo._device_score_grouped

    def recording_serve(*a, **kw):
        serve_started.set()
        return real_serve(*a, **kw)

    def recording_score(*a, **kw):
        # the re-rank warm runs on this thread: the serve warm must already
        # have started beside it (without it, the wait runs out)
        if threading.current_thread() is threading.main_thread():
            rerank_saw_serve.append(serve_started.wait(timeout=30))
        return real_score(*a, **kw)

    solo.serve, solo._device_score_grouped = recording_serve, recording_score
    try:
        assert solo.preload(warm=(2, 512), serve=(0.3, 5))
    finally:
        del solo.serve, solo._device_score_grouped
    assert rerank_saw_serve and all(rerank_saw_serve), rerank_saw_serve
    prep = solo._serve_prep(ranking)
    assert prep is not None and isinstance(prep["rows_mat"], np.ndarray), prep
    merged = []
    real_arrays = solo._serve_arrays
    solo._serve_arrays = lambda preps, *a, **kw: merged.append(len(preps)) or real_arrays(preps, *a, **kw)
    try:
        with BatchingServer(solo, 0.3, 5, max_batch_queries=4, max_wait_ms=20.0) as server:
            solo_served = server.submit(ranking).result(timeout=60)
    finally:
        del solo._serve_arrays
    assert merged == [1], merged
    assert solo_served == solo.serve(ranking, 0.3, 5)
    digests.append(sum(sorted(solo_served["q1"].values())))

    print(f"MH_OK {np.round(np.asarray(digests), 4).tolist()}", flush=True)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, str(_REPO))
    _worker(int(sys.argv[1]), sys.argv[2])
