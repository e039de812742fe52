"""Sharded scoring: the table split over devices, only scores combined.

The port of ``fastforward_tpu/parallel/sharded.py``.  A table too large for
one device is sharded row-wise over the mesh's ``shard`` axis
(:class:`ShardedTable`) and query pairs are split over its ``data`` axis:

- the streamed path (:func:`streamed_scores_sharded`,
  :func:`streamed_scores_sharded_pq`) partitions the candidates by owning
  shard on the host and builds one streamed layout per shard (padded to a
  common virtual-tile count); each shard is one launch of the port's own
  kernel on that shard's rows (K1/K2 for vectors and int8 codes, K3/K4 for
  PQ codes), the outputs concatenate, and the slot gather and K-reduce run
  after them.  No collective is needed inside one process; across processes
  the concatenation is one ``all_reduce`` of zero-filled buffers;
- the gather path (:func:`score_pairs_sharded`,
  :func:`score_pairs_sharded_pq`) scores each pair's rows on the position
  ``(d, s)`` that holds them (``d`` the pair's data chunk, ``s`` the row's
  shard), and the partial scores are summed over shards (each row is owned
  by exactly one shard: the JAX package's ``psum`` over masked partials)
  before the mode's K-reduce.

Only scores cross devices, never rows.  On one process with many devices
each shard's work runs on its own device and the partial results are
brought to the mesh's first device.  The JAX package runs XLA's
``stream_scan`` per shard; the per-slot values are the same contract as the
kernels'.
"""

from collections import namedtuple

import numpy as np
import torch

from fastforward_tpu_torch.ops import scoring, stream_kernel, stream_kernel_pq
from fastforward_tpu_torch.ops.upload import upload_table
from fastforward_tpu_torch.parallel import multihost
from fastforward_tpu_torch.parallel.mesh import Mesh

#: the row-sharded placement of a table (``fastforward_tpu``'s
#: ``NamedSharding(mesh, P("shard", None, ...))``)
TableSharding = namedtuple("TableSharding", ["mesh", "ndim"])


def table_sharding(mesh: Mesh, ndim: int = 3) -> TableSharding:
    """Row-sharded placement for the embedding table."""
    return TableSharding(mesh, ndim)


class Replicated:
    """One tensor copied onto every local device of a mesh (the codebooks
    of a sharded PQ table)."""

    def __init__(self, copies: "dict[torch.device, torch.Tensor]") -> None:
        self.copies = copies
        first = next(iter(copies.values()))
        self.shape, self.dtype, self.device = first.shape, first.dtype, first.device

    def on(self, device: torch.device) -> torch.Tensor:
        """The copy on ``device``."""
        return self.copies[device]


def on_device(t: "torch.Tensor | Replicated", device: torch.device) -> torch.Tensor:
    """``t`` on ``device``: its replica there, or ``t`` itself."""
    return t.on(device) if isinstance(t, Replicated) else t


class ShardedTable:
    """A table row-sharded over a mesh's ``shard`` axis.

    Shard ``s`` holds rows ``[s * n_local, (s + 1) * n_local)`` at every
    position ``(d, s)`` of this process; positions of one shard on one
    device share one tensor.  ``shape``, ``dtype``, ``ndim`` and ``device``
    (the mesh's first local device, where results gather) read as a
    tensor's do.
    """

    def __init__(self, mesh: Mesh, shape: tuple, dtype: torch.dtype, blocks: dict) -> None:
        self.mesh = mesh
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.blocks = blocks
        self.num_shards = mesh.shape["shard"]
        self.n_local = shape[0] // self.num_shards
        self.device = mesh.first_device

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @classmethod
    def from_reader(
        cls, mesh: Mesh, shape: tuple, read_rows, dtype: "torch.dtype | None" = None,
        stage_dtype=None,
    ) -> "ShardedTable":
        """Upload each local shard from ``read_rows(start, stop)`` (host
        rows, possibly fewer than asked for: the rest are zeros); a shard's
        rows are read once for all its local devices.

        :raises ValueError: When the rows do not divide by the shards.
        """
        num_shards = mesh.shape["shard"]
        if shape[0] % num_shards:
            raise ValueError(f"{shape[0]} table rows do not divide over {num_shards} shards")
        n_local = shape[0] // num_shards
        blocks: dict = {}
        memo: dict = {}
        out_dtype = dtype
        width = int(np.prod(shape[1:], dtype=np.int64))
        for d, s in sorted(mesh.local_positions(), key=lambda pos: (pos[1], pos[0])):
            dev = mesh.devices[d, s]
            if (s, dev) not in memo:
                if memo.get("rows", (None,))[0] != s:  # one-slot memo of host rows
                    memo["rows"] = (s, np.asarray(read_rows(s * n_local, (s + 1) * n_local)))
                host = memo["rows"][1]
                memo[(s, dev)] = upload_table(
                    host.reshape(host.shape[0], width), dev, shape=(n_local, *shape[1:]), dtype=dtype,
                    stage_dtype=stage_dtype,
                )
            blocks[(d, s)] = memo[(s, dev)]
            out_dtype = blocks[(d, s)].dtype
        return cls(mesh, shape, out_dtype, blocks)

    @classmethod
    def zeros(cls, mesh: Mesh, shape: tuple, dtype: torch.dtype) -> "ShardedTable":
        """A zero table, allocated shard by shard."""
        n_local = shape[0] // mesh.shape["shard"]
        made: dict = {}
        blocks = {}
        for d, s in mesh.local_positions():
            key = (s, mesh.devices[d, s])
            if key not in made:
                made[key] = torch.zeros((n_local, *shape[1:]), dtype=dtype, device=key[1])
            blocks[(d, s)] = made[key]
        return cls(mesh, shape, dtype, blocks)

    def block(self, d: int, s: int) -> torch.Tensor:
        """Shard ``s``'s rows at position ``(d, s)`` (a local one)."""
        return self.blocks[(d, s)]

    def local_shards(self) -> "list[int]":
        """The shards this process holds."""
        return sorted({s for _, s in self.blocks})

    def shard(self, s: int) -> torch.Tensor:
        """Shard ``s``'s rows at its first local position."""
        return next(t for (d, ss), t in sorted(self.blocks.items(), key=lambda kv: kv[0]) if ss == s)

    def row_band(self) -> "tuple[int, int]":
        """The rows this process holds, ``(start, stop)``.

        :raises ValueError: When its shards are not one contiguous band.
        """
        local = self.local_shards()
        if local != list(range(local[0], local[-1] + 1)):
            raise ValueError("this process's shards are not one contiguous row band")
        return local[0] * self.n_local, (local[-1] + 1) * self.n_local

    def _distinct(self):
        """``(s, tensor)`` once per distinct local tensor."""
        seen = set()
        for (_, s), t in self.blocks.items():
            if id(t) not in seen:
                seen.add(id(t))
                yield s, t

    def write_rows(self, start: int, rows: "np.ndarray | torch.Tensor", stage_dtype=None) -> None:
        """Write ``rows`` (host numpy, or a tensor on any device) into table
        rows ``[start, start + len(rows))`` of every local shard they
        touch."""
        from fastforward_tpu_torch.ops.upload import upload_into

        n = rows.shape[0]
        for s, t in self._distinct():
            lo = max(start, s * self.n_local)
            hi = min(start + n, (s + 1) * self.n_local)
            if lo >= hi:
                continue
            part = rows[lo - start : hi - start]
            if isinstance(part, torch.Tensor):
                t[lo - s * self.n_local : hi - s * self.n_local].copy_(part.to(t.device).view(-1, *t.shape[1:]))
            else:
                upload_into(t, part, lo - s * self.n_local, stage_dtype=stage_dtype)

    def take_rows(self, rows: np.ndarray) -> torch.Tensor:
        """Table rows ``rows`` gathered on the first device (one process:
        every shard must be local)."""
        rows = np.asarray(rows, dtype=np.int64)
        out = torch.empty((rows.shape[0], *self.shape[1:]), dtype=self.dtype, device=self.device)
        shard_of = rows // self.n_local
        for s in np.unique(shard_of):
            sel = np.flatnonzero(shard_of == s)
            t = self.shard(int(s))
            idx = torch.from_numpy(rows[sel] - int(s) * self.n_local).to(t.device)
            out[torch.from_numpy(sel).to(self.device)] = stream_kernel_pq.take_rows(t, idx).to(self.device)
        return out


class _Queries:
    """One call's query block on each device it is needed on (the first
    device's copy through the plan's upload cache)."""

    def __init__(self, q_pad: "np.ndarray | torch.Tensor", plan: "dict | None", first: torch.device):
        if isinstance(q_pad, torch.Tensor):
            self.host, self.copies = None, {q_pad.device: q_pad.float()}
        else:
            q = np.ascontiguousarray(q_pad, dtype=np.float32)
            self.host = q
            self.copies = {first: scoring._cached_q_upload(q, plan, "q_dev", first)}

    def on(self, device: torch.device) -> torch.Tensor:
        q = self.copies.get(device)
        if q is None:
            src = next(iter(self.copies.values()))
            q = self.copies[device] = src.to(device)
        return q


# -- the streamed path ---------------------------------------------------------


def _sharded_layout(key: str, n_pad: int, num_shards: int, q_pad, rows, qno, r: int, plan):
    """The per-shard streamed layouts ``(cand_all, tile_idx_all,
    slot_of_pair)``, padded to a common virtual-tile count (padding slots
    at ``qb - 1``), cached in ``plan[key]``; ``None`` where ``n_pad`` does
    not divide by the shards, a shard's rows by ``r``, or no rows came."""
    cached = plan.get(key) if plan is not None else None
    if cached is not None:
        return cached
    if n_pad % num_shards or rows is None or rows.shape[0] == 0:
        return None
    n_local = n_pad // num_shards
    if n_local % r:
        return None
    qb = q_pad.shape[0]
    cap = scoring._adaptive_cap(max(1, rows.shape[0] // num_shards), max(1, n_local // r))
    shard_of = rows // n_local
    layouts, masks = [], []
    t_virtual = 1
    for s in range(num_shards):
        mask = shard_of == s
        masks.append(mask)
        local = (rows[mask] - s * n_local).astype(np.int64)
        layout = None
        if local.shape[0]:
            layout = scoring.build_streamed_layout(local, qno[mask].astype(np.int64), n_local, qb, r=r, cap=cap)
            if layout is None:
                return None
            t_virtual = max(t_virtual, layout[1].shape[0])
        layouts.append(layout)
    cand_all = np.full((num_shards, t_virtual, cap), qb - 1, dtype=np.int32)
    tile_idx_all = np.zeros((num_shards, t_virtual), dtype=np.int32)
    slot_of_pair = np.empty(rows.shape[0], dtype=np.int64)
    for s, (layout, mask) in enumerate(zip(layouts, masks)):
        if layout is None:
            continue
        cand, tile_idx, slots = layout
        cand_all[s, : cand.shape[0]] = cand
        tile_idx_all[s, : tile_idx.shape[0]] = tile_idx
        slot_of_pair[mask] = s * (t_virtual * cap) + slots
    cached = (cand_all, tile_idx_all, slot_of_pair)
    if plan is not None:
        plan[key] = cached
    return cached


def _streamed(
    key, launch, mesh, table, q_pad, rows, qno, r, plan, reduce, seg_reduce, fetch
):
    """Each shard's launch on its home device, the outputs concatenated on
    the first device (across processes: an ``all_reduce`` of zero-filled
    buffers), then the slot gather and reduce."""
    cached = _sharded_layout(key, table.shape[0], mesh.shape["shard"], q_pad, rows, qno, r, plan)
    if cached is None:
        return None
    cand_all, tile_idx_all, slot_of_pair = cached
    num_shards, t_virtual, cap = cand_all.shape
    first = mesh.first_device
    grids = plan.get(key + "_dev") if plan is not None else None
    if grids is None:
        grids = {}
        for s in range(num_shards):
            home = mesh.shard_home(s)
            if home is not None:
                grids[s] = (
                    torch.from_numpy(cand_all[s].reshape(t_virtual, cap // 128, 128)).to(home[1]),
                    torch.from_numpy(tile_idx_all[s]).to(home[1]),
                )
        if plan is not None:
            plan[key + "_dev"] = grids
    queries = _Queries(q_pad, plan, first)
    per_shard = t_virtual * cap
    if mesh.multiprocess:
        outs = torch.zeros(num_shards * per_shard, dtype=torch.float32, device=first)
    parts = []
    for s in range(num_shards):
        home = mesh.shard_home(s)
        if home is None:
            continue
        d, dev = home
        cand3, tile = grids[s]
        out_s = launch(table.block(d, s), queries.on(dev), cand3, tile, dev).reshape(-1)
        if mesh.multiprocess:
            outs[s * per_shard : (s + 1) * per_shard] = out_s.to(first)
        else:
            parts.append(out_s.to(first))
    if mesh.multiprocess:
        multihost.all_reduce_sum(outs)
    else:
        outs = torch.cat(parts)
    return scoring._finalize_streamed(
        outs, slot_of_pair, reduce, plan, key + "_slot", seg_reduce=seg_reduce, fetch=fetch
    )


def streamed_scores_sharded(
    mesh: Mesh,
    table: ShardedTable,
    q_pad: np.ndarray,
    rows: "np.ndarray | None",
    qno: "np.ndarray | None",
    precision: str = "exact",
    plan: "dict | None" = None,
    reduce: "tuple | None" = None,
    seg_reduce: "tuple | None" = None,
    fetch: bool = True,
) -> "np.ndarray | torch.Tensor | None":
    """Sharded counterpart of ``ops.streamed_scores``: K1 (or K2 for int8
    tiles at ``cap > r``) once per shard on that shard's rows.

    Returns per-row scores in input order, per-pair scores with
    ``reduce=(op, k, counts_dev)`` (the slot gather and the K-reduce on the
    first device), or, with ``seg_reduce=(op, seg, n_out)``, a ragged
    layout's segment reduce; numpy, or the device tensor with
    ``fetch=False``.  ``None`` when the layout does not apply (``n_pad %
    shards`` or ``n_local % r``).  ``plan`` caches the per-shard grids.
    """
    r = stream_kernel.KERNEL_TILE_ROWS

    def launch(block, q, cand3, tile, _dev):
        return stream_kernel.stream_select_auto(block, q.t(), cand3, tile, r=r, precision=precision)

    return _streamed(
        "stream_sharded", launch, mesh, table, q_pad, rows, qno, r, plan, reduce, seg_reduce, fetch
    )


def streamed_scores_sharded_pq(
    mesh: Mesh,
    codes: ShardedTable,
    codebooks: "Replicated | torch.Tensor",
    q_pad: np.ndarray,
    rows: "np.ndarray | None",
    qno: "np.ndarray | None",
    plan: "dict | None" = None,
    reduce: "tuple | None" = None,
    seg_reduce: "tuple | None" = None,
    precision: str = "exact",
    fetch: bool = True,
) -> "np.ndarray | torch.Tensor | None":
    """Sharded counterpart of ``ops.streamed_scores_pq``: K3 (or K4 at
    ``cap > r``) once per shard on that shard's codes, with the replicated
    codebooks; results as :func:`streamed_scores_sharded`."""
    r = stream_kernel_pq.KERNEL_PQ_TILE_ROWS

    def launch(block, q, cand3, tile, dev):
        return stream_kernel_pq.stream_select_pq_auto(
            block, on_device(codebooks, dev), q.t(), cand3, tile, r=r, precision=precision
        )

    return _streamed(
        "stream_sharded_pq", launch, mesh, codes, q_pad, rows, qno, r, plan, reduce, seg_reduce,
        fetch,
    )


# -- the gather path ---------------------------------------------------------------


def row_scores_sharded(
    mesh: Mesh,
    table: ShardedTable,
    q_pad: "np.ndarray | torch.Tensor",
    rows: np.ndarray,
    qno: np.ndarray,
    precision: str = "exact",
    codebooks: "Replicated | torch.Tensor | None" = None,
    bounds: "np.ndarray | None" = None,
    plan: "dict | None" = None,
) -> torch.Tensor:
    """``table[rows[i]] . q[qno[i]]`` per row (the ADC score against
    ``codebooks`` for PQ codes), on the first device.

    The rows split into ``data`` chunks at ``bounds`` (default: equal
    chunks); position ``(d, s)`` scores the rows of chunk ``d`` that shard
    ``s`` owns, and the partial scores, zero elsewhere, are summed over the
    shards (one ``all_reduce`` across processes).
    """
    rows = np.asarray(rows, dtype=np.int64)
    qno = np.asarray(qno, dtype=np.int64)
    p = rows.shape[0]
    first = mesh.first_device
    out = torch.zeros(p, dtype=torch.float32, device=first)
    if bounds is None:
        n_data = mesh.shape["data"]
        bounds = (np.arange(n_data + 1, dtype=np.int64) * p) // n_data
    shard_of = rows // table.n_local
    queries = _Queries(q_pad, plan, first)
    luts: dict = {}
    for d, s in mesh.local_positions():
        lo, hi = int(bounds[d]), int(bounds[d + 1])
        sel = lo + np.flatnonzero(shard_of[lo:hi] == s)
        if not sel.size:
            continue
        dev = mesh.devices[d, s]
        local = torch.from_numpy(rows[sel] - s * table.n_local).to(dev)
        qn = torch.from_numpy(qno[sel]).to(dev)
        block = table.block(d, s)
        if codebooks is None:
            part = scoring._gathered_dots(block, queries.on(dev), local, qn, precision)
        else:
            lut = luts.get(dev)
            if lut is None:
                lut = luts[dev] = scoring.pq_lut(queries.on(dev), on_device(codebooks, dev))
            part = scoring._adc_rows(block, lut, local, qn)
        out[torch.from_numpy(sel).to(first)] = part.to(first)
    return multihost.all_reduce_sum(out) if mesh.multiprocess else out


def _score_pairs(mesh, table, qvecs, idx, op, precision, codebooks):
    idx = idx.cpu().numpy() if isinstance(idx, torch.Tensor) else np.asarray(idx)
    k = idx.shape[0] - 1
    s_b = idx.shape[1]
    rows = idx[:k].T.reshape(-1).astype(np.int64)
    qno = np.repeat(idx[k].astype(np.int64) >> 8, k)
    n_data = mesh.shape["data"]
    bounds = (np.arange(n_data + 1, dtype=np.int64) * s_b) // n_data * k
    scores = row_scores_sharded(
        mesh, table, qvecs, rows, qno, precision, codebooks=codebooks, bounds=bounds
    )
    counts = torch.from_numpy((idx[k] & 0xFF).astype(np.int64)).to(scores.device)
    return scoring._masked_reduce(scores.view(s_b, k), counts, op)


def score_pairs_sharded(
    mesh: Mesh,
    table: ShardedTable,
    qvecs: "np.ndarray | torch.Tensor",
    idx: "np.ndarray | torch.Tensor",
    op: str,
    precision: str = "exact",
) -> torch.Tensor:
    """Sharded counterpart of ``ops.score_pairs_grouped``.

    :param mesh: Mesh with ``data`` and ``shard`` axes.
    :param table: The row-sharded table (vectors, or int8 codes with the
        scales folded into ``qvecs``).
    :param qvecs: Query vectors, ``(Qb, dim)``.
    :param idx: Stacked int32 ``(K + 1, Sb)``: the row matrix (transposed)
        and the packed ``qno * 256 + count`` row; pairs split over ``data``.
    :param op: ``"max"`` | ``"mean"`` | ``"first"``.
    :param precision: Dot precision tier.
    :return: Per-pair scores ``(Sb,)`` on the first device.
    """
    return _score_pairs(mesh, table, qvecs, idx, op, precision, None)


def score_pairs_sharded_pq(
    mesh: Mesh,
    codes: ShardedTable,
    codebooks: "Replicated | torch.Tensor",
    qvecs: "np.ndarray | torch.Tensor",
    idx: "np.ndarray | torch.Tensor",
    op: str,
) -> torch.Tensor:
    """Sharded counterpart of ``ops.score_pairs_grouped_pq``: each position
    builds its queries' lookup tables from the replicated codebooks and
    ADC-scores the code rows it owns (arguments as
    :func:`score_pairs_sharded`)."""
    return _score_pairs(mesh, codes, qvecs, idx, op, "exact", codebooks)
