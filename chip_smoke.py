#!/usr/bin/env python3
"""GPU smoke run of fastforward_tpu_torch: kernels, re-rank, fused serve,
document ranking, early stopping, preload, the u16 score transport, the
batching server, the transformer query towers, the disk index, the hybrid
tier beyond device memory, the device store, the progressive preload, PQ
codes wider than uint8, multi-device tables (sharded scoring in one
process and across two), and the JAX package's contract suites' hard cases
(ties, near-duplicates, a mega-document, skewed and depth-1 runs).

Run from the repository root on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. header: the card's name and power limit; K1-K4 built with ``nvcc`` from
   ``fastforward_tpu_torch/ops/csrc`` (one compiler per source, all at once);
2. K1 (``stream_select_pairwise``) against its plain PyTorch version at
   dim 256, for fp32, bf16 and int8 tables, exact and fast tiers; then at
   dim 768 on random, one-query, half-padding and 5,000-query layouts
   (``SMALL_LAYOUTS``): K1 at ``cap <= r`` and K2 (``stream_select``) at
   ``cap > r`` for fp32, bf16 and int8 tables, every tier, and K3
   (``stream_select_pq_pairwise``) at ``cap <= r`` and K4
   (``stream_select_pq``) at ``cap > r`` for ``PQ(M, Ks)`` with M 24, 96 and
   384 (the lookup table in chunks) and Ks 16 and 256, every tier; and K1
   on fp32 tables at dim 768 on tiles that pin the shortcuts of its body
   (``fp32_edge_tiles``: padding alone, runs of repeated slots across warp
   and block boundaries, one row wanted by every slot, a padding query that
   is not zero) at every cap from 128 to 1024, r 512 and 128, both tiers;
3. re-rank at the flagship shape (N = 2,000,000 passages, dim 768, fp32,
   Q = 512 queries x depth 1000, ``Mode.PASSAGE``, precision ``"high"``):
   one cold and several warm ``index(ranking)`` calls, 32 queries checked
   against float64 dots.  The index also holds doc ids: runs of 1-7
   passages a document drawn from the seed (about 500,000 documents);
4. fused serve at the same shape: ``serve(ranking, 0.2, 10, refine=22)``
   and ``serve(ranking, 0.2, 10)``, top-10 ids and scores checked against
   the exact interpolated top-10 of 32 queries;
5. a sparse ranking (the gather-dot branch) and a bf16 table at
   N = 262,144, checked the same way;
12. document modes on the same index: Q = 512 x depth 1000 documents
    (512,000 pairs, K = 8, ~2.05M real rows in ~4.1M slots at cap 1024):
    ``Mode.MAXP`` one cold and 5 warm re-ranks, ``serve(ranking, 0.2,
    10)`` and ``serve(..., refine=22)`` (refine is inactive for K > 1);
    ``Mode.AVEP`` and ``Mode.FIRSTP`` a cold and 5 warm re-ranks each; 32
    queries checked against the float64 max, mean or first of each
    document's passages; must launch K1 and no other kernel; then the
    device memory of one warm MAXP serve;
14. early stopping on the passage index and run: ``index(ranking,
    early_stopping=10, early_stopping_alpha=0.2,
    early_stopping_depths=(200, 1000, 5000))`` cold (a fresh ranking per
    call) and warm (the same ranking, served from its cached scores),
    ``serve(ranking, 0.2, 10, early_stopping_depths=(200, 1000))``, and the
    alpha sweep (Q = 64 x depth 5000, depths (500, 5000), alphas
    0.1-0.9, timed after one warm-up pass); every returned score checked
    against float64, and the 32 checked queries' result against the
    port's on a ``device="cpu"`` index of only their candidates' rows (a
    query whose rows differ is printed with its stop margin and fails
    above the tolerance); must launch K1;
15. preload: a second fp32 index of the flagship corpus (and its doc ids)
    with ``score_transport="u16"``, ``preload(warm=(512, 1000),
    serve=(0.2, 10, 22))``: it must return True, launch K1 in the exact
    and the fast tier, leave no plan, restore the encoder and record every
    stats key; then the first real re-rank and warm ones, which must load
    no kernel;
16. the u16 transport on that index: the flagship re-rank, and MAXP on
    phase 12's run, every pair within ``(max - min) / 131070`` (plus fp32
    rounding) of the f32 index's score and 32 queries within that plus the
    K1 tolerance of float64; warm times of u16 and f32 side by side; must
    launch K1 only.  The u16 index is freed after it;
17. ``BatchingServer(index, 0.2, 10, max_batch_queries=512,
    max_wait_ms=5.0, prep_workers=2)`` over the flagship index: the
    512-query run as 64 requests of 8 queries x depth 1000, submitted from
    16 threads in 3 waves and once as a backlog of all 3 waves; every
    request's result must equal its own ``serve`` (ids exact, scores
    within 1e-5), every batch take the array path and K1 launch; the
    same with ``refine=22`` and on phase 12's MAXP run; the server's and
    the sequential per-request ``serve`` QPS, the host time of each step
    of the array path a wave (request prep, the batch's merge and launches,
    its result copy, the fan-out; summed over the threads), and one more
    wave of each under ``torch.profiler``;
18. the query towers at full width: a BERT-base tower (transformers'
    default ``BertConfig``: 12 layers, hidden 768, 12 heads, FFN 3,072;
    TCT-ColBERT's shape) and a DistilBERT-base one (6 layers, 768; TAS-B's),
    random weights from ``torch.manual_seed``, saved with a hand-written
    30,522-entry vocabulary and opened by ``TCTColBERTQueryEncoder`` and
    ``TASBEncoder``; the flagship run's 512 queries (36 tokens each for
    TCT) encoded on the card in fp32 and bf16, the first 64 checked against
    the port's tower on the CPU (fp32 within 1e-4, with TF32 on in this
    process; bf16 within 16 bf16 steps, and no further in rms from the
    CPU's bf16 tower than twice that from its fp32 one) and the CPU tower
    against transformers' eager forward (atol 2e-4, rtol 1e-3); encode
    and tower times against the flop bound, peak activation memory; then
    the flagship re-rank (a cold and 5 warm calls) and serve with the fp32
    TCT encoder as the index's query encoder: must launch K1 alone, every
    score of 32 queries and their top-10 against float64 of the vectors the
    index encoded;
19. the disk index, read and written by the port's own HDF5 codec (h5py
    is never imported): a dense and a ``PQ(96, 256)`` index of 8,192 rows
    go through ``add``, ``load(hbm_cache=True)`` and a re-rank that must
    launch K1 and K3; then ``bench.py`` config #2's disk half at full
    width: phase 12's MAXP corpus written to an ``OnDiskIndex`` in adds of
    2^16 rows (6.1 GB), loaded with ``hbm_cache=True``: a cold and 5 warm
    re-ranks of phase 12's run must launch K1 fp32 alone, match float64
    on all 512 queries with an exact top-10, and equal phase 12's
    ``InMemoryIndex`` scores bit for bit; 4,096 random documents read back
    through the chunk memory maps (and by file reads) equal the corpus's
    rows; loaded with ``hbm_budget=2 GiB`` (the tail read from the file),
    one re-rank has the same top-10.  Its PQ half runs after phase 13, on
    phase 9's quantizer: the same corpus as a PQ disk index, codes equal
    to phase 9's, MAXP must launch K4 alone, checked against float64;
20. the hybrid tier: a second fp32 index of the flagship corpus with
    ``hbm_budget=2 GiB`` must split at 488,448 resident rows (1.50 GB),
    1,511,552 host-tail rows (4.64 GB) and a 646,971,392-byte device
    block cache (6 blocks of 32,768 rows); a cold and 5 warm passage
    re-ranks and ``serve(ranking, 0.2, 10)``, a cold and 5 warm MAXP
    re-ranks (the ragged layout) and early stopping, each checked against
    float64 and the top of 32 queries against phase 3's whole-table index;
    the tier's counters of every call: warm calls copy exactly the blocks
    the cache does not hold, MAXP fetches 2 x n_pairs floats; every call
    launches K1 once for the prefix and once a tail block; K1 and K2 (the
    block as 3D) held against their plain versions on one staged tail
    block of the passage plan, and K1 on one of the MAXP plan, each
    timed and one call split by kernel, with K1's tiles split over 1,
    ``tile_split``'s and the most blocks and K2's queries on work items
    and packed (the same bits; every K1/K2 row does this, and logs its
    split or its queries' routes); the host-to-card GB/s of tail blocks
    (page-locked, staged, gathered) beside the link's generation and
    width;
21. (inside phases 7 and 9) the same for the int8 codes of phase 7 at
    ``hbm_budget=512 MiB`` and the PQ codes of phase 9 at 64 MiB: passage
    and MAXP re-ranks checked as there, each call launching the kernel
    each layout routes to (K1/K2, K3/K4); K2, K3 and K4 held against
    their plain versions on a staged tail block, each call split by
    kernel;
22. ``store="device"``: the flagship corpus in 62 adds of 32,768 rows
    (rows/s), no host copy; its re-rank and ``serve(refine=22)`` equal
    phase 3's index, 4,096 rows read back bit for bit;
23. ``preload(warm=(512, 1000), serve=(0.2, 10, 22), progressive=True)`` of
    a fresh flagship fp32 index: True with ``stats["progressive"]``; a
    serve right after it checked against float64 of whichever table it saw
    (truncated or exact); ``preload_join(timeout=120)`` True with
    ``stats["progressive_exact"]``, the table equal to the corpus and the
    re-rank to phase 3's index; the time to each table beside phase 15's
    ``upload_s``;
6. K1 against its plain version on the main path's own inputs, for fp32,
   bf16 and int8 tables in both tiers, timed, back to back and in one
   traced call split by kernel; beside it, the query-major body (K2's
   entry) on the same fp32 layout, which K1's fp32 branch does not use;
   and K1 fp32 on phase 12's MAXP layout, and on its pairs' real rows
   without the K-padding;
7. int8 at full width: ``ScalarQuantizer`` fitted on the first 2^16
   vectors of the same corpus, precision ``"high"``: a cold and 5 warm
   re-ranks and the fused serve, checked against float64 dots of the
   decoded rows; must launch K1 and no K2; then phase 13 for int8: the
   same in ``Mode.MAXP`` on phase 12's run, checked against float64 of
   the decoded rows; must launch K2 (cap 1024 > r) and no K1;
8. int8 with dense tiles: the first 262,144 rows with their own 512 x 1000
   run (cap 1024 > r = 512); must launch K2 and no K1; then the device
   memory of one warm serve (peak, and K2's grouping scratch);
9. PQ at full width: ``PQ(96, 256)`` fitted on the card on 2^16 vectors,
   precision ``"exact"``, checked against float64 decode-then-dot; must
   launch K3.  Before it, ``PQ(96, 256)`` is fitted on the card and on the
   CPU on clustered data and their codes compared, and after the encode
   4,096 of the card's codes are compared with a CPU encode (the float64
   references are built from the card's codes, so they alone would not
   catch a wrong fit or encode); then phase 13 for PQ: ``Mode.MAXP`` on
   phase 12's run, checked the same way; must launch K4 (cap 1024 > r);
10. OPQ with dense tiles: ``OPQ(96, 256)`` on the 262,144 rows and their
    run, checked against float64 ``(q @ R) . decode`` and, like PQ, 4,096
    of its codes against a CPU encode; must launch K4; then the device
    memory of one warm serve (peak, and K4's grouping scratch);
11. K2, K3 and K4 against their plain versions on the layouts of phases 8,
    9, 10 and 13 (K2 int8 and K4 PQ in ``Mode.MAXP``), timed (every launch
    of one wrapper call), with their bounds; one traced call of each
    splits its time by kernel (memset, grouping, scoring), and each is
    timed back to back;
24. PQ codes wider than uint8: ``PQ(96, 1024)`` (10-bit codes, stored as
    uint16) fitted on the card on the first 2^16 vectors of the flagship
    corpus, 4,096 of its codes against a CPU encode; the passage re-rank
    and serve must launch K3, MAXP K4, each checked against float64
    ``q . decode(codes)``; K3 and K4 held against their plain versions on
    these layouts (timed, traced, back to back, ``pq_bound``) and on one
    small layout of random ``PQ(96, 32768)`` codebooks, whose 128 KB
    tables take the global-memory table body; the hybrid tier over the
    same codes at ``hbm_budget=128 MiB`` (tail blocks of uint16 rows),
    passage and MAXP, as phase 21;
25. sharded scoring on the card in one process: ``MeshConfig(data=1,
    shard=2).build(devices=[cuda:0, cuda:0])``;
    ``parallel.sharded.streamed_scores_sharded`` on the flagship fp32
    table split in two, with the flagship run's rows and with phase 12's
    MAXP layout and its K-reduce (K1 once per shard each),
    ``score_pairs_sharded`` on the 3,200-pair sparse run (no kernel), and
    ``streamed_scores_sharded_pq`` on phase 9's PQ codes (K3 once per
    shard), each against the single-table program and float64, timed
    beside it;
26. two processes on the card through the public API: this script starts
    itself twice (``--multiprocess-child RANK PORT N``, one time limit);
    each joins a gloo job on one free local port
    (``parallel.multihost.initialize(backend="gloo")``), builds
    ``InMemoryIndex(mesh_config=MeshConfig(data=1, shard=2))`` over the
    flagship corpus (its one card is its whole local device set, so the
    mesh has two devices), calls ``preload()`` and ``narrow_to_shard()``,
    re-ranks and serves the flagship run and phase 12's MAXP run, checks
    them against float64, counts its own K1 launches (one a call) and
    prints a digest; both must exit 0 with the same digest (NCCL across
    cards is not run: the machine has one card);
27. the JAX package's contract suites' hard cases at full width
    (``contract_phase``): the first 262,144 flagship rows at dim 768 with
    one document of 4,096 passages, 256 identical rows and 64 pairs of rows
    2^-10 apart (relative) in one coordinate, as fp32 on the host store
    (``"exact"``) and on ``store="device"`` (``"fast"``), int8 (phase 7's
    quantizer), ``PQ(96, 256)`` (phase 9's) and ``PQ(96, 1024)``: 64
    queries of geometric depths 1-1000 (re-rank and ``serve(ranking, 0.2,
    10)``); equal lexical scores over passages and over MAXP documents;
    fully tied scores, whose serve cut and re-rank must keep the ranking's
    order (``lax.top_k``'s lower index first) and whose early-stopping
    serve must return 10 per query; the near-duplicates, which the
    ``"exact"`` table must order as float64 does; the 4,096-passage document
    among singletons in MAXP, AVEP and FIRSTP (the flat path); and 512
    queries of depth 1 (the gather branch, which must launch nothing).
    Every score is checked against float64 (of the decoded rows, or of
    bf16-rounded operands in the fast tier) and every result order against
    the oracle's; K1 must launch for fp32, K2 for int8 MAXP, K3 and K4 for
    PQ.  The phase's seconds are printed beside the card's name and power
    limit;
28. the decoder tower's kernels (``decoder_phase``): ``ops/csrc/decoder.cu``
    built with ``nvcc``; E5-Mistral-7B-instruct's tower at its published
    widths (``MistralConfig()``: 32 layers, bf16, weights drawn as the
    benchmark draws them) runs one call of the ``e5mistral.batch-encode``
    cell, 512 queries of 18-31 tokens in micro-batches of 32 right-padded
    to their longest, and must launch each layer's two RMSNorms, its
    RoPE + attention and its SwiGLU kernel and the final RMSNorm on every
    micro-batch, and no more; on the longest micro-batch each kernel is
    held against its plain version (``*_plain``) on the activations it
    sees at layers 0, 15 and 31 (and the final norm), in bf16 and on the
    same values in fp32 (fp32 within 1e-5 of the largest output, bf16
    within one bf16 step), then timed on layer 0's (CUDA events, a traced
    call, the bytes bound) beside its plain version on the card, and the
    whole tower through the kernels against the plain tower on the card.

29. Moonlight-16B-A3B's DeepSeek-V3 tower (``models/deepseek.py``) at its
    published widths, whole (27 layers, 64 experts, 163,840 ids, bf16),
    drawn as ``bench_port/encoders/E5MoonlightEncoder.py`` draws it: one
    call of the ``moonlight.batch-encode`` cell, 512 queries of 18-31 tokens
    in micro-batches of 128, must launch the latent attention on every
    layer, the router, the permutation, two grouped GEMMs and the combine
    on every expert layer, the RMSNorms and SwiGLUs, and no more, and route
    6 experts a real token (``moe_stats``); on the first micro-batch each
    kernel is held against its plain version on the activations it sees at
    layers 0, 1, 13 and 26 (the attention in bf16 and fp32 within one bf16
    step or 1e-5 of the largest output, the router's choices equal but for
    near-ties, the permutation exact, the grouped GEMMs within one bf16
    step, the combine within one), then timed on layer 1's (CUDA events, a
    traced call, its bound: bytes at the memory's rate, operations at the
    bf16 or fp32 peak); the layers stepped by hand give the tower's own
    output; and the share of the (token, layer) choices of 6 experts that
    differ from the float64 reference's (the benchmark's plug-in), and the
    fp8 control's, with each one's query-vector error.

The phases run in the order 1-5, 12, 14-20, 22, 23, 6-11, 24-29 (phases 13
and 21 inside 7 and 9, while their indexes exist).  After phases 12 (for 4 and 12 together),
14 and 7-10, one warm call of each flow (and one cold early-stopping call)
runs under
``torch.profiler`` (device busy time, idle share, largest device items;
``None`` where no complete trace was taken, or where the traced kernel took
under half its CUDA-event time of phases 6 and 11); those launches are
outside the counted phases.  ``ScalarQuantizer`` fits and encodes in numpy on the host,
so the int8 phases have no on-card quantizer to check.

Every kernel's launch counter is set to 0 just before each main-path phase
and read just after it; a phase that did not launch its kernel, or launched
one it must not, fails.  Every exact-tier check runs with TF32 matmuls
allowed, to show that no result depends on it.
The last lines are the flows' timings (``flows: {...}``), the card's name
and power limit, the ``{"kernels": [...]}`` summary and, last,
``{"ok": true, "device": {...}}``.
"""

import json
import math
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

SEED = 0
N, DIM, QUERIES, DEPTH = 2_000_000, 768, 512, 1000
ALPHA, CUTOFF, REFINE = 0.2, 10, 22
CHECK_QUERIES = 32
WARM_CALLS = 5
TIMED_LAUNCHES = 25
BF16_N = 262_144
SPARSE_QUERIES, SPARSE_DEPTH = 32, 100  # 3,200 pairs: n_pairs * 500 <= N
DOC_MAX_PSGS = 7  # passages per document: 1..7 (bench.py config #2)
#: early stopping on the flagship run (bench.py:1061-1099) and its alpha
#: sweep (bench.py:833-880): Q x depth, depths, alphas
ES_KWARGS = {"early_stopping": CUTOFF, "early_stopping_alpha": ALPHA,
             "early_stopping_depths": (200, 1000, 5000)}
ES_SERVE_DEPTHS = (200, 1000)
ES_COLD_CALLS = 3
SWEEP_QUERIES, SWEEP_DEPTH, SWEEP_DEPTHS = 64, 5000, (500, 5000)
SWEEP_ALPHAS = (0.1, 0.3, 0.5, 0.7, 0.9)
SWEEP_PASSES = 3
#: the server phase (``bench.py --config server``, ``bench.py:363-472``): the
#: 512-query run as requests of 8 queries, submitted from 16 threads
SERVER_REQUEST_QUERIES, SERVER_BATCH_QUERIES, SERVER_WAIT_MS = 8, 512, 5.0
SERVER_CLIENTS, SERVER_WAVES = 16, 3

#: published H100 rates by part (NVIDIA data sheets): memory bytes/s and
#: fp32 (non-tensor) flop/s
CARD_RATES = {
    "pcie": (2.0e12, 51e12),
    "nvl": (3.9e12, 60e12),
    "sxm": (3.35e12, 67e12),
}

#: published dense bf16 tensor-core rates by part (NVIDIA data sheets)
BF16_RATES = {"pcie": 756e12, "nvl": 835e12, "sxm": 989e12}
#: the query towers of phase 18: BERT-base (TCT-ColBERT's shape) and
#: DistilBERT-base (TAS-B's) from transformers' default configs, random
#: weights; a hand-written vocabulary of BERT's size; the flagship run's
#: queries, of which ``TOWER_CHECK_QUERIES`` are also run on the CPU
TOWER_VOCAB = 30_522
TOWER_CHECK_QUERIES = 64
TOWER_TIMED = 5
#: phase 19: a small dense and PQ disk index
DISK_N, DISK_QUERIES, DISK_DEPTH = 8192, 32, 100
#: phase 19's config #2 disk half (bench.py:689-766): rows of the MAXP
#: document corpus written to an ``OnDiskIndex`` (all of them, a 6.3 GB
#: file: the card machine's temporary directory holds 80 GB), rows an
#: ``add`` writes, and random documents read back through the chunk maps
DISK_DOC_N, DISK_ADD_ROWS, DISK_MMAP_IDS = N, 1 << 16, 4096
DISK_TOP = 10  # the top of every query that must equal float64's

#: phases 20-21: the hybrid tier's budgets (bytes): dense fp32, int8 and
#: PQ(96, 256) tables of the flagship corpus
HYBRID_BUDGET, HYBRID_INT8_BUDGET, HYBRID_PQ_BUDGET = 2 << 30, 512 << 20, 64 << 20
#: the dense split phase 20 must find: resident rows (1.50 GB), host-tail
#: rows (4.64 GB) and the device block cache's bytes (about 6 blocks)
HYBRID_DENSE_SPLIT = (488_448, 1_511_552, 646_971_392)
#: tail blocks each variant of the copy-rate probe copies (phase 20)
RATE_BLOCKS = 16
#: phase 22: rows per add of the device store
DEVICE_ADD_ROWS = 32_768
#: phase 23: seconds ``preload_join`` may take for the exact table
PROGRESSIVE_JOIN_S = 120

#: phase 24: PQ codes wider than uint8 (10-bit codes, stored as uint16), the
#: hybrid tier's budget over them, and the (M, Ks) of the random codebooks
#: whose lookup tables exceed what a block stages (the global-memory body)
PQ_WIDE_KS = 1024
HYBRID_PQ_WIDE_BUDGET = 128 << 20
PQ_GLOBAL_SHAPE = (96, 32_768)
#: phase 26: rows of the two processes' corpus (the flagship's unless the
#: time limit forces a cut) and the seconds the job may take
MP_N = N
MP_TIMEOUT_S = 420
#: phase 27: the JAX contract suites' hard cases on ``DENSE_N`` rows: one
#: document of ``CONTRACT_MEGA`` passages, ``CONTRACT_TIE_ROWS`` identical
#: rows, ``CONTRACT_NEAR_PAIRS`` near-duplicate pairs; the queries and depth
#: of the skewed, tied and near-duplicate runs, and the depth-1 run's queries
CONTRACT_MEGA, CONTRACT_TIE_ROWS, CONTRACT_NEAR_PAIRS = 4096, 256, 64
CONTRACT_QUERIES, CONTRACT_DEPTH, CONTRACT_DEPTH1_QUERIES = 64, 1000, 512

#: phase 28: one call of the ``e5mistral.batch-encode`` cell (queries,
#: micro-batch, least and most tokens a query), the layers whose
#: activations the kernels are held on, and each decoder kernel's name in
#: the profiler by its wrapper's
DECODER_QUERIES, DECODER_BATCH, DECODER_TOKENS = 512, 32, (18, 31)
DECODER_CHECK_LAYERS = (0, 15, 31)
DECODER_KERNELS = {"rms_norm": "rms_norm_kernel", "rope_attention": "rope_attention_kernel",
                   "swiglu": "swiglu_kernel"}

#: phase 29: one call of the ``moonlight.batch-encode`` cell (queries and
#: micro-batch; 18-31 tokens a query, as phase 28), the layers whose
#: activations the kernels are held on, and each kernel of
#: ``models/deepseek.py`` by its wrapper's name
MOE_QUERIES, MOE_BATCH = 512, 128
MOE_CHECK_LAYERS = (0, 1, 13, 26)
MOE_KERNELS = {"latent_attention": "rope_attention_kernel", "moe_route": "route_kernel",
               "moe_permute": "permute_kernel", "grouped_gemm": "grouped_gemm_kernel",
               "moe_combine": "combine_kernel"}

QUANT_FIT = 1 << 16  # training vectors of the quantizers
DENSE_N = 262_144  # rows of the dense-tile phases: ~1,000 pairs per 512-row tile
PQ_M, PQ_KS = 96, 256
PROFILE_TRIES = 8  # traces per profiled flow until one is complete
ENCODE_CHECK_ROWS = 4096  # rows the card's PQ/OPQ codes are checked on against the CPU's
ENCODE_AGREE = 0.999  # least share of those codes that must agree
FIT_CHECK_N = 1 << 14  # clustered rows of the on-card k-means check (half train, half held out)
FIT_AGREE = 0.99  # least share of held-out codes the card's and the CPU's fits agree on
#: what one wrapper call launches on the card, as parts of the names the
#: profiler gives them: K1's fp32 body (in the fast tier after rounding the
#: queries); the query-major K1 (bf16, int8) and
#: K2 (a memset, the grouping of query_groups.cuh, the dot of
#: dense_dot.cuh); K3 and K4 (the grouping, then adc_lut.cuh's table and
#: score kernels)
GROUP_KERNEL_NAMES = ("ff::groups::count_kernel", "ff::groups::scatter_kernel")
CALL_KERNELS = {
    "pairwise": ("ff::tile_dot::tile_dot_kernel<",),
    "pairwise_fast": ("ff::tile_dot::round_kernel", "ff::tile_dot::tile_dot_kernel<"),
    "dense": ("Memset", *GROUP_KERNEL_NAMES, "ff::dense::dot_kernel<"),
    "adc": ("Memset", *GROUP_KERNEL_NAMES, "ff::adc::adc_slot_kernel", "ff::adc::adc_table_kernel",
            "ff::adc::adc_score_kernel"),
}
#: the port's own kernels among them
PORT_KERNEL_NAMES = tuple(
    {n: None for names in CALL_KERNELS.values() for n in names if n != "Memset"}
)
#: the small checks' layouts: random rows and queries; every slot (padding
#: too) on one query (Qb = 1); half-full tiles, so that half of the slots pad
#: on query Qb - 1 as in the flagship layouts; random rows over 5,000 queries
#: (the grouping bins them in windows of 2,048)
SMALL_LAYOUTS = ("uniform", "one_query", "half_padding", "many_queries")
#: (M, Ks) of the small K3/K4 checks at dim 768: 4-byte code loads (M 24),
#: Ks 16 and 256 at the flagship M, and the LUT in four chunks (M 384)
PQ_SMALL_SHAPES = ((24, 256), (PQ_M, 16), (PQ_M, PQ_KS), (384, PQ_KS))
#: the layouts of the K3/K4 route checks (:func:`route_layout`): a staged
#: tail block of the hybrid tier (``TAIL_BLOCK_QUERIES`` queries of about
#: ``TAIL_BLOCK_SLOTS`` random rows each over ``TAIL_BLOCK_ROWS`` rows, the
#: rest of its 64 x 1024 slots padding) and a mixed one over
#: ``MIXED_QUERIES`` queries (every other query at 1.5 times the slot
#: limit, the rest at half of it; where every query is scored slot-wise,
#: ``MIXED_UNLIMITED_COUNTS``)
TAIL_BLOCK_ROWS, TAIL_BLOCK_QUERIES, TAIL_BLOCK_SLOTS = 32_768, 512, 70
MIXED_QUERIES, MIXED_UNLIMITED_COUNTS = 16, (600, 30)

#: kernel -> (source, the Pallas call it replaces)
KERNELS = {
    "stream_select_pairwise": (
        "fastforward_tpu_torch/ops/csrc/stream_select_pairwise.cu",
        "fastforward_tpu/ops/stream_kernel.py:397",
    ),
    "stream_select": (
        "fastforward_tpu_torch/ops/csrc/stream_select.cu",
        "fastforward_tpu/ops/stream_kernel.py:197",
    ),
    "stream_select_pq_pairwise": (
        "fastforward_tpu_torch/ops/csrc/stream_select_pq_pairwise.cu",
        "fastforward_tpu/ops/stream_kernel_pq.py:351",
    ),
    "stream_select_pq": (
        "fastforward_tpu_torch/ops/csrc/stream_select_pq.cu",
        "fastforward_tpu/ops/stream_kernel_pq.py:454",
    ),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(*args) -> None:
    print(*args, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def card_rates(name: str) -> tuple[float, float]:
    low = name.lower()
    if "pcie" in low:
        return CARD_RATES["pcie"]
    if "nvl" in low:
        return CARD_RATES["nvl"]
    return CARD_RATES["sxm"]


def card_bf16_rate(name: str) -> float:
    low = name.lower()
    return BF16_RATES["pcie" if "pcie" in low else "nvl" if "nvl" in low else "sxm"]


def median_ms(fn, n: int, warmup: int = 3) -> float:
    """Median device time of ``fn()`` over ``n`` runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def interleaved_ms(fns: dict, n: int, warmup: int = 3) -> dict:
    """Median device time of each of ``fns`` (name -> call) over ``n``
    rounds that call each once in turn (CUDA events), each round starting
    one further along, so that they meet the card in the same states."""
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    names = list(fns)
    for i in range(n):
        for name in names[i % len(names):] + names[:i % len(names)]:
            fn = fns[name]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: float(np.median(t)) for name, t in times.items()}


def sum_order_tol(absdot: torch.Tensor, dim: int) -> torch.Tensor:
    """Tolerance for two fp32 sums of the same ``dim`` products in different
    orders: the reordering error grows like ``sqrt(dim) * u * sum|terms|``
    (u = 2^-24), with a factor 8 of headroom."""
    return 8.0 * dim**0.5 * 2.0**-24 * absdot


def make_workload(n: int, num_queries: int, depth: int, seed: int):
    """Corpus, query vectors and a TREC-style run, as ``bench.py`` makes them."""
    rng = np.random.default_rng(seed)
    corpus = rng.standard_normal(size=(n, DIM), dtype=np.float32)
    qvecs = rng.standard_normal(size=(num_queries, DIM), dtype=np.float32)
    run, queries = {}, {}
    for q in range(num_queries):
        cand = rng.choice(n, size=depth, replace=False)
        run[f"q{q}"] = {f"p{c}": float(depth - i) for i, c in enumerate(cand)}
        queries[f"q{q}"] = f"query {q}"
    return corpus, qvecs, run, queries


def make_doc_ids(n: int, seed: int):
    """Document ids for ``n`` passages: runs of 1-7 passages a document
    drawn from the seed, as ``bench.py:make_doc_workload`` draws them, the
    last run cut to fit.  Returns ``(counts, starts, doc_ids)``."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, DOC_MAX_PSGS + 1, size=n)
    counts = counts[: int(np.searchsorted(np.cumsum(counts), n)) + 1]
    counts[-1] -= counts.sum() - n
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    doc_ids = [f"d{d}" for d, c in enumerate(counts.tolist()) for _ in range(c)]
    return counts, starts, doc_ids


def make_run(n_ids: int, prefix: str, num_queries: int, depth: int, seed: int) -> dict:
    """A TREC-style run: ``depth`` ids (``<prefix><n>``, drawn without
    replacement from ``n_ids``) per query, lexical scores ``depth - rank``."""
    rng = np.random.default_rng(seed)
    return {
        f"q{q}": {f"{prefix}{c}": float(depth - i)
                  for i, c in enumerate(rng.choice(n_ids, size=depth, replace=False))}
        for q in range(num_queries)
    }


def tower_vocab(size: int) -> list[str]:
    """A BERT vocabulary of ``size`` entries written by hand: the special
    tokens and TCT-ColBERT's ``[Q]``/``[D]`` first, then ``query`` and the
    numbers, so that the flagship run's queries (``query <n>``) tokenize to
    distinct ids."""
    head = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "[Q]", "[D]", "query"]
    return head + [str(i) for i in range(size - len(head))]


def write_checkpoint(target: Path, model, vocab: list) -> Path:
    """Save a transformers ``model`` and a ``BertTokenizer`` of ``vocab``
    to ``target``, as a checkpoint ``AutoModel``/``AutoTokenizer`` open."""
    from transformers import BertTokenizer

    target.mkdir(parents=True, exist_ok=True)
    (target / "vocab.txt").write_text("\n".join(vocab))
    BertTokenizer(str(target / "vocab.txt")).save_pretrained(target)
    model.save_pretrained(target)
    return target


def tower_bound(config, batch: int, length: int, rate: float, mem_rate: float) -> dict:
    """Least time of one tower call on ``batch`` sequences of ``length``
    tokens: the matmul operations (per layer and token ``2 (4 H^2 + 2 H I)``
    for the projections and the FFN, per sequence ``4 L^2 H`` for the
    logits and the context) at ``rate``, against the layer weights
    (``config.dtype``), the tokens' embedding rows and the output read or
    written once at ``mem_rate``."""
    h, i, n = config.hidden_size, config.intermediate_size, config.num_layers
    tokens = batch * length
    flops = n * (2.0 * tokens * (4 * h * h + 2 * h * i) + 4.0 * batch * length * length * h)
    weight_bytes = n * (4 * h * h + 2 * h * i + 9 * h + i) * (2 if config.dtype == "bfloat16" else 4)
    moved = weight_bytes + tokens * h * 4 * 2
    flop_ms, byte_ms = flops / rate * 1e3, moved / mem_rate * 1e3
    return {"flops": flops, "bytes": moved, "bound_ms": max(flop_ms, byte_ms),
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes"}


def check_close(got: np.ndarray, want: np.ndarray, atol: float, rtol: float, what: str) -> float:
    """Every element of ``got`` within ``atol + rtol |want|``; the largest
    difference."""
    check(got.shape == want.shape and bool(np.isfinite(got).all()),
          f"{what}: shape {got.shape} vs {want.shape}, or non-finite values")
    err = np.abs(got.astype(np.float64) - want)
    check(bool((err <= atol + rtol * np.abs(want)).all()),
          f"{what}: max err {err.max():.3e} (atol {atol:.1e}, rtol {rtol:.1e})")
    return float(err.max())


def k1_bound(table, q, cand3, tile_idx, dim, r, rates) -> dict:
    """Least time for K1's (or K2's) work on these inputs: the rows the
    slots need, the queries, slots, tile indices and outputs each moved
    once, against the fp32 rate for one ``dim``-long dot per slot (each
    slot is a distinct (row, query) pair: no product is shared)."""
    return stream_bound(
        dim * table.element_size(), lambda _rows: 0, q, cand3, tile_idx, r,
        lambda per_query: 2.0 * dim * float(per_query.sum()), rates,
    )


def pq_bound(codes, codebooks, q, cand3, tile_idx, r, rates) -> dict:
    """The same for K3/K4: each needed code row (``M`` codes) moved once,
    and of the codebooks only the codewords those rows use (at most the
    whole codebooks), against the least ADC arithmetic.  A query with ``n``
    slots needs at most ``min(Ks, n)`` codewords of each subspace dotted
    with its subvector (``2 Ds`` flops each: a full lookup table only pays
    when the query has at least ``Ks`` slots), and each slot adds its
    ``M`` terms."""
    from fastforward_tpu_torch.ops.stream_kernel_pq import gather_codes

    m, ks, ds = codebooks.shape

    def codeword_bytes(rows):
        used = gather_codes(codes, rows) + torch.arange(m, device=codes.device) * ks
        return min(codebooks.numel(), torch.unique(used).numel() * ds) * 4

    def flops(per_query):
        return float(per_query.clamp(max=ks).sum()) * m * 2.0 * ds + float(per_query.sum()) * m

    return stream_bound(m * codes.element_size(), codeword_bytes, q, cand3, tile_idx, r, flops, rates)


def stream_bound(row_bytes, extra_bytes_of, q, cand3, tile_idx, r, flops_of, rates) -> dict:
    """Least time for a streamed kernel's work: the distinct rows its slots
    read (``row_bytes`` each), ``extra_bytes_of(distinct rows)``, the query
    block, slots, tile indices and outputs each moved once, or its flops
    (``flops_of(slots of each query)``) at the fp32 rate.  ``q`` is the
    row-major ``(Qb, dim)`` block."""
    bw, fp32_rate = rates
    qb = q.shape[0]
    cand = cand3.reshape(cand3.shape[0], -1).long()
    rows = torch.unique(tile_idx.long()[:, None] * r + cand // qb)
    per_query = torch.bincount((cand % qb).reshape(-1), minlength=qb)
    n_rows = rows.numel()
    nbytes = (
        n_rows * row_bytes
        + extra_bytes_of(rows)
        + q.numel() * 4
        + cand3.numel() * 4
        + tile_idx.numel() * 4
        + cand3.numel() * 4
    )
    flops = flops_of(per_query)
    t_bytes, t_ops = nbytes / bw * 1e3, flops / fp32_rate * 1e3
    return {
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": int(nbytes),
        "flops": float(flops),
        "rows_read": int(n_rows),
    }


def passage_exact(rows_ref, qvecs_dev, q_index, dim):
    """``exact(q, ids) -> (float64 scores, tolerances)`` of passage ids
    (``p<row>``) against query ``q``: the dots of ``rows_ref`` rows (a card
    tensor, or decoded quantized rows) and the sum-order tolerance."""

    def exact(q, ids):
        rows = torch.from_numpy(np.array([int(p[1:]) for p in ids], dtype=np.int64)).cuda()
        prods = rows_ref[rows].double() * qvecs_dev[q_index[q]].double()
        return prods.sum(-1), sum_order_tol(prods.abs().sum(-1), dim)

    return exact


def doc_exact(rows_ref, qvecs_dev, q_index, counts, starts, op, dim):
    """The same for document ids (``d<doc>``): the float64 max, mean or
    first of the dots of each document's passages (documents are runs of
    ``counts`` rows from ``starts``).  The tolerance is the largest
    passage's sum-order tolerance for max, the first's for first, and for a
    mean of k fp32 scores their mean tolerance plus the fp32 sum and
    division, ``2 (k + 1) 2^-24 mean|score|``."""

    def exact(q, ids):
        docs = np.array([int(d[1:]) for d in ids], dtype=np.int64)
        cnt = np.ones_like(docs) if op == "first" else counts[docs]
        seg = np.repeat(np.arange(docs.shape[0]), cnt)
        rows = np.repeat(starts[docs], cnt) + (np.arange(seg.shape[0]) - np.repeat(np.cumsum(cnt) - cnt, cnt))
        prods = rows_ref[torch.from_numpy(rows).cuda()].double() * qvecs_dev[q_index[q]].double()
        dots, tol_row = prods.sum(-1), sum_order_tol(prods.abs().sum(-1), dim)
        seg_t = torch.from_numpy(seg).cuda()
        n = docs.shape[0]
        if op == "max":
            ref = torch.full((n,), -torch.inf, dtype=torch.float64, device="cuda")
            ref = ref.scatter_reduce(0, seg_t, dots, "amax")
            tol = torch.zeros(n, dtype=torch.float64, device="cuda").scatter_reduce(0, seg_t, tol_row, "amax")
            return ref, tol
        if op == "first":
            return dots, tol_row
        k = torch.from_numpy(cnt).cuda().double()
        total = torch.zeros(n, dtype=torch.float64, device="cuda")
        mean = total.index_add(0, seg_t, dots) / k
        tol = total.index_add(0, seg_t, tol_row) / k
        tol = tol + 2.0 * (k + 1) * 2.0**-24 * total.index_add(0, seg_t, dots.abs()) / k
        return mean, tol

    return exact


def check_rerank(result, exact, what, queries=CHECK_QUERIES):
    """Every score of the first ``queries`` queries (``q0``, ``q1``, ...)
    against ``exact`` (``passage_exact`` / ``doc_exact``)."""
    df = result._df
    check(len(df) > 0, f"{what}: empty result")
    scores = df["score"].to_numpy(dtype=np.float64)
    check(bool(np.isfinite(scores).all()), f"{what}: non-finite scores")
    qid = df["q_id"].astype(str).to_numpy()
    ids = df["id"].astype(str).to_numpy()
    worst, n_pairs = 0.0, 0
    for qi in range(queries):
        sel = qid == f"q{qi}"
        if not sel.any():
            continue
        ref, tol = exact(f"q{qi}", ids[sel])
        err = (torch.from_numpy(scores[sel]).cuda() - ref).abs()
        check(bool((err <= tol).all()), f"{what}: q{qi} max err {err.max().item()} vs float64")
        worst, n_pairs = max(worst, err.max().item()), n_pairs + int(sel.sum())
    log(f"  {what}: {n_pairs} pairs of {queries} queries match float64 (max err {worst:.3e})")


def check_serve(result, run, exact, what, queries=CHECK_QUERIES):
    """Top-``CUTOFF`` ids and scores, for the first ``queries`` queries of
    ``run``, against the float64 interpolation of ``exact``'s scores."""
    df = result._df
    want_rows = sum(min(CUTOFF, len(c)) for c in run.values())
    check(len(df) == want_rows, f"{what}: {len(df)} rows, want {want_rows}")
    by_q = {}
    for q, i, s in zip(df["q_id"].astype(str), df["id"].astype(str), df["score"]):
        by_q.setdefault(q, []).append((i, float(s)))
    worst = 0.0
    for q in list(run)[:queries]:
        cand = list(run[q].items())
        sem, sem_tol = exact(q, [p for p, _ in cand])
        lex = torch.tensor([s for _, s in cand], device="cuda", dtype=torch.float64)
        interp = ALPHA * lex + (1 - ALPHA) * sem
        # the semantic score's error, plus the fp32 interpolation's rounding
        tol = (1 - ALPHA) * sem_tol + interp.abs() * 2.0**-22
        exact_of = dict(zip((p for p, _ in cand), interp.tolist()))
        tol_of = dict(zip((p for p, _ in cand), tol.tolist()))
        got = by_q.get(q, [])
        check(len(got) == min(CUTOFF, len(cand)), f"{what}: {q} has {len(got)} results")
        for pid, score in got:
            worst = max(worst, abs(score - exact_of[pid]))
            check(abs(score - exact_of[pid]) <= tol_of[pid],
                  f"{what}: {q} {pid} score {score} vs exact {exact_of[pid]}")
        want = sorted(exact_of, key=exact_of.get, reverse=True)[:CUTOFF]
        floor = min(exact_of[p] for p, _ in got)
        for pid in set(want) - {p for p, _ in got}:
            # a miss is allowed only within rounding of the cut
            check(exact_of[pid] - floor <= 2 * tol_of[pid],
                  f"{what}: {q} lost true top-{CUTOFF} candidate {pid}")
    log(f"  {what}: top-{CUTOFF} of {min(queries, len(run))} queries match the "
        f"exact ranking (max score err {worst:.3e})")


def es_stop_margin(lex, sem, cutoff, alpha, depths) -> float:
    """The least ``|bound - kth|`` over the stop decisions the early-stopping
    loop takes for one query (``Index._early_stopping``), in float64 on
    exact scores: how far its decisions were from flipping."""
    interp = alpha * lex + (1 - alpha) * sem
    n, a, best, margin = lex.shape[0], 0, -np.inf, np.inf
    for b in sorted(depths):
        if b < cutoff:
            continue
        if a:
            scored = min(a, n)
            kth = np.sort(interp[:scored])[::-1][min(scored, cutoff) - 1]
            bound = alpha * lex[scored - 1] + (1 - alpha) * best
            margin = min(margin, abs(bound - kth))
            if not kth < bound:
                break
        if min(b, n) <= a:
            break
        best = max(best, sem[a : min(b, n)].max())
        a = b
    return margin


def check_es_against_cpu(result, corpus, by_text, run, queries, exact, es_kwargs, what,
                         serve_args=None):
    """The early-stopping result of the first ``CHECK_QUERIES`` queries
    against the port's own on a ``device="cpu"`` index holding only their
    candidates' rows (re-rank, or ``serve(*serve_args)``).  Rows and scores
    must agree; a query whose rows differ is printed with its stop margin,
    and fails when that margin is over twice its largest interpolated score
    tolerance (only a decision closer than the scores' error may flip)."""
    from fastforward_tpu_torch import InMemoryIndex, Mode, Ranking
    from fastforward_tpu_torch.encoder import LambdaEncoder

    sub = {q: run[q] for q in list(run)[:CHECK_QUERIES]}
    rows = np.unique([int(p[1:]) for cands in sub.values() for p in cands])
    cpu = InMemoryIndex(query_encoder=LambdaEncoder(by_text.__getitem__), mode=Mode.PASSAGE,
                        precision="high", device="cpu")
    cpu.add(corpus[rows], psg_ids=[f"p{r}" for r in rows])
    ranking = Ranking.from_run(sub, queries={q: queries[q] for q in sub})
    want = cpu.serve(ranking, *serve_args) if serve_args else cpu(ranking, **es_kwargs)
    alpha, cutoff = es_kwargs["early_stopping_alpha"], es_kwargs["early_stopping"]
    depths = es_kwargs["early_stopping_depths"]
    got_df, want_df = result._df, want._df
    differ = 0
    for q in sub:
        g = dict(zip(got_df.loc[got_df["q_id"] == q, "id"].astype(str), got_df.loc[got_df["q_id"] == q, "score"]))
        w = dict(zip(want_df.loc[want_df["q_id"] == q, "id"].astype(str), want_df.loc[want_df["q_id"] == q, "score"]))
        cand = list(sub[q].items())
        sem, sem_tol = exact(q, [p for p, _ in cand])
        lex = np.array([s for _, s in cand])
        interp_tol = ((1 - alpha) * sem_tol.cpu().numpy()
                      + np.abs(alpha * lex + (1 - alpha) * sem.cpu().numpy()) * 2.0**-22)
        if set(g) != set(w):
            differ += 1
            margin = es_stop_margin(lex, sem.cpu().numpy(), cutoff, alpha, depths)
            log(f"  {what}: {q} rows differ from the CPU's ({len(g)} vs {len(w)}); stop margin "
                f"{margin:.3e}, tolerance {2 * interp_tol.max():.3e}")
            check(margin <= 2 * interp_tol.max(), f"{what}: {q} differs from the CPU with margin {margin}")
            continue
        # the card's and the CPU's scores each lie within tolerance of float64
        score_tol = interp_tol if serve_args else sem_tol.cpu().numpy()
        tol_of = dict(zip((p for p, _ in cand), 2 * score_tol))
        for pid, score in g.items():
            check(abs(score - w[pid]) <= tol_of[pid], f"{what}: {q} {pid} {score} vs CPU {w[pid]}")
    log(f"  {what}: {len(sub) - differ} of {len(sub)} queries equal the CPU index's result")


def timed_calls(fn, n: int) -> tuple[float, list]:
    """Median host time (ms) of ``n`` calls that end in a synchronize."""
    times, out = [], None
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), out


def u16_bound(span: float, score: np.ndarray) -> np.ndarray:
    """The u16 transport's error bound for scores of a call whose scores
    span ``span``: half a code step, ``(max - min) / 131070``, plus the fp32
    rounding of the scale and of the decode."""
    return span / 131070 * (1 + 1e-6) + 2.0**-21 * (span + np.abs(score))


def check_u16_against_f32(got, want, what) -> tuple[float, float]:
    """Every pair of a u16 re-rank against the same pair of the f32 port's
    re-rank: the same pairs, scores within :func:`u16_bound` of the f32
    scores' span.  Returns ``(max error, span / 131070)``."""
    import pandas as pd

    def keyed(df):
        key = df["q_id"].astype(str) + "\x1f" + df["id"].astype(str)
        return pd.Series(df["score"].to_numpy(np.float64), index=key.to_numpy())

    g, w = keyed(got._df), keyed(want._df)
    check(len(g) == len(w), f"{what}: {len(g)} pairs, the f32 re-rank has {len(w)}")
    g = g.reindex(w.index).to_numpy()
    w = w.to_numpy()
    check(not np.isnan(g).any(), f"{what}: pairs differ from the f32 re-rank")
    span = float(w.max() - w.min())
    err = np.abs(g - w)
    bound = u16_bound(span, w)
    worst = int(np.argmax(err - bound))
    check(bool((err <= bound).all()), f"{what}: err {err[worst]} over the u16 bound {bound[worst]}")
    log(f"  {what}: {len(w)} pairs within the u16 bound of the f32 re-rank (max err "
        f"{err.max():.3e}, (max - min) / 131070 = {span / 131070:.3e})")
    return float(err.max()), span / 131070


def u16_exact(exact, span: float):
    """``exact`` (``passage_exact`` / ``doc_exact``) with the u16 bound of a
    call whose scores span ``span`` added to its tolerance."""

    def wrapped(q, ids):
        ref, tol = exact(q, ids)
        return ref, tol + span / 131070 * (1 + 1e-6) + 2.0**-21 * (span + ref.abs())

    return wrapped


def split_requests(run: dict, queries: dict, size: int, ranking_cls) -> list:
    """The run as requests of ``size`` queries each (``bench.py:391-400``)."""
    q_ids = list(run)
    return [
        ranking_cls.from_run({q: run[q] for q in q_ids[i : i + size]},
                             queries={q: queries[q] for q in q_ids[i : i + size]})
        for i in range(0, len(q_ids), size)
    ]


def check_same_served(got: list, want: list, what: str) -> None:
    """Each request's server result against its own ``serve``: ids exact,
    scores within rtol 1e-5 and atol 1e-5 (``tests/test_serving_server.py``)."""
    check(len(got) == len(want), f"{what}: {len(got)} results for {len(want)} requests")
    for i, (g, w) in enumerate(zip(got, want)):
        gd, wd = g._df, w._df
        for col in ("q_id", "id"):
            check(list(gd[col].astype(str)) == list(wd[col].astype(str)),
                  f"{what}: request {i} differs from its serve() in {col}")
        check(bool(np.allclose(gd["score"].to_numpy(), wd["score"].to_numpy(), rtol=1e-5, atol=1e-5)),
              f"{what}: request {i} scores differ from its serve()")
    log(f"  {what}: {len(got)} requests equal their own serve()")


def profile_flow(fn, kernels, needs_copy: bool = True) -> dict:
    """One warm call under ``torch.profiler``: host wall time, the time the
    card spent in kernels and copies, the largest device items, and the
    host phases the index names (``ff.*`` ranges).

    On the H100 machine the profiler drops device items of some traced
    calls once the process has traced before (from ~30 s after its first
    traced window, for some windows and not others; padding the window with
    idle pauses did not stop it).  Every profiled flow launches the kernels
    of one wrapper call (``kernels``, one of ``CALL_KERNELS``; all of which
    must show) and ends in a device-to-host copy of its result
    (``needs_copy``; a warm early-stopping call, served from its cached
    scores, launches nothing and copies nothing), so a trace that lacks
    either is incomplete and is taken again, up to
    ``PROFILE_TRIES`` times; ``tries`` says how many it took.  When no try
    gives a complete trace, ``complete`` is false and the card's busy time
    and idle share are ``None`` (not measured): an incomplete trace would
    understate the one and overstate the other.  ``vet_profiles`` later
    holds the traced kernel time against CUDA events.  A complete trace can
    still miss an item that is neither, such as a gather; section 7 of
    PERF.md keeps that open."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for tries in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_name, spans = {}, {}
        for ev in prof.events():
            ms = ev.time_range.elapsed_us() / 1e3
            if ev.name.startswith("ff."):
                # the host range; its device-side twin only spans the kernels
                if ev.device_type != DeviceType.CUDA:
                    spans[ev.name] = spans.get(ev.name, 0.0) + ms
            elif ev.device_type == DeviceType.CUDA:
                by_name[ev.name] = by_name.get(ev.name, 0.0) + ms
        port_ms = sum(ms for n, ms in by_name.items() if is_port_kernel(n))
        complete = (
            all(any(part in n for n in by_name) for part in kernels)
            and (not needs_copy or any(n.startswith("Memcpy DtoH") for n in by_name))
        )
        if complete:
            break
    device_ms = sum(by_name.values()) if complete else None
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {
        "wall_ms": wall_ms,
        "complete": complete,
        "device_ms": device_ms,
        "device_idle_share": None if device_ms is None else 1.0 - device_ms / wall_ms,
        "port_kernel_ms": port_ms,
        "tries": tries,
        "top_device_ms": [[name[:80], ms] for name, ms in top],
        "host_span_ms": spans,
    }


def is_port_kernel(name: str) -> bool:
    return any(part in name for part in PORT_KERNEL_NAMES)


def traced_kernels(fn, kernels) -> dict:
    """Device time (ms) of each of ``kernels`` (one of ``CALL_KERNELS``) in
    one traced call of ``fn``, traced again up to ``PROFILE_TRIES`` times
    until all show; what the last try kept otherwise (see
    ``profile_flow``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            # a device item ahead of the call's: late in the process the
            # profiler has dropped the first device item of such traces (the
            # memset of a grouped call; K1's fp32 call, one kernel, lost it
            # in all tries)
            torch.zeros(1, device="cuda")
            fn()
            torch.cuda.synchronize()
        out = {}
        for ev in prof.events():
            key = next((part for part in kernels if part in ev.name), None)
            if ev.device_type == DeviceType.CUDA and key:
                out[key] = out.get(key, 0.0) + ev.time_range.elapsed_us() / 1e3
        if len(out) == len(kernels):
            break
    return out


def split_call(row: dict, fn, kernels) -> None:
    """Add one traced call of ``fn`` split by kernel and its back-to-back
    time to ``row``."""
    row["traced_ms_by_kernel"] = traced_kernels(fn, kernels)
    row["back_to_back_ms"] = back_to_back_ms(fn, TIMED_LAUNCHES)
    log(f"  {row['variant']}: one call traced {json.dumps(row['traced_ms_by_kernel'])}; "
        f"{row['back_to_back_ms']:.4f} ms per call back to back")


def back_to_back_ms(fn, n: int) -> float:
    """Device time per call of ``n`` calls issued back to back (CUDA events
    around all of them): where the card, not the host's launch path, sets a
    call's time, this matches ``median_ms``."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


#: the kernel variant (phases 6 and 11) whose CUDA-event time vets each
#: profiled flow's trace
FLOW_VARIANTS = {
    "rerank": "K1 fp32 exact",
    "serve_refine": "K1 fp32 fast",
    "serve": "K1 fp32 exact",
    "int8_rerank": "K1 int8 exact",
    "int8_serve": "K1 int8 exact",
    "int8_dense_rerank": "K2 int8 high",
    "int8_dense_serve": "K2 int8 high",
    "pq_rerank": "K3 pq exact",
    "pq_serve": "K3 pq exact",
    "opq_dense_rerank": "K4 opq exact",
    "opq_dense_serve": "K4 opq exact",
    "doc_maxp_rerank": "K1 fp32 doc exact",
    "doc_maxp_serve": "K1 fp32 doc exact",
    "int8_doc_maxp_rerank": "K2 int8 doc high",
    "int8_doc_maxp_serve": "K2 int8 doc high",
    "pq_doc_maxp_rerank": "K4 pq doc exact",
    "pq_doc_maxp_serve": "K4 pq doc exact",
    "pq1024_rerank": "K3 pq1024 exact",
    "pq1024_serve": "K3 pq1024 exact",
    "pq1024_doc_maxp_rerank": "K4 pq1024 doc exact",
    "pq1024_doc_maxp_serve": "K4 pq1024 doc exact",
}


def vet_profiles(flows: dict, variants: dict) -> None:
    """Hold each complete trace's port-kernel time against the CUDA-event
    time of the same kernel, tier and layout (phases 6 and 11).  The
    profiler has kept a kernel item with a fraction of its time; a trace
    whose port kernel took under half the event time is marked incomplete,
    and its busy time and idle share become ``None``.  The early-stopping
    flows score layouts of their own each round and are not vetted."""
    event = {row["variant"]: row["ms"] for rows in variants.values() for row in rows}
    for flow, variant in FLOW_VARIANTS.items():
        ms = event[variant]
        prof = flows[flow]["profile"]
        prof["kernel_event_ms"] = ms
        if prof["complete"] and prof["port_kernel_ms"] < 0.5 * ms:
            prof.update(complete=False, device_ms=None, device_idle_share=None)
        log(f"[profile-check {flow}] traced port kernel {prof['port_kernel_ms']:.4f} ms, "
            f"CUDA events {ms:.4f} ms; complete {prof['complete']}")


def reset_counts(wrappers) -> None:
    for fn in wrappers.values():
        fn.launches = 0


def read_counts(wrappers) -> dict:
    return {name: fn.launches for name, fn in wrappers.items()}


def hold(what, fn, plain_fn, abs_fn, dim, timed, bound_fn):
    """One kernel call against its plain version on the same card tensors,
    within the fp32 sum-order tolerance; timed beside its plain version and
    bound when ``timed``."""
    out = fn()
    plain = plain_fn()
    absdot = abs_fn()  # sum |terms| per slot (bf16 rounding commutes with abs)
    torch.cuda.synchronize()
    err = (out - plain).abs()
    tol = sum_order_tol(absdot, dim)
    worst = int(err.argmax())
    check(
        bool(torch.isfinite(out).all()) and bool((err <= tol).all()),
        f"{what} disagrees with its plain version: max err {err.max().item()} "
        f"(tolerance there {tol.view(-1)[worst].item()})",
    )
    row = {
        "variant": what,
        "shape": [int(s) for s in out.shape],
        "max_abs_err": err.max().item(),
        "max_rel_to_tol": (err / tol.clamp(min=1e-30)).max().item(),
    }
    if timed:
        row["ms"] = median_ms(fn, TIMED_LAUNCHES)
        row["plain_ms"] = median_ms(plain_fn, TIMED_LAUNCHES)
        row.update(bound_fn())
    log("  ", json.dumps(row))
    return row


def select_variants(sk, table, q, cand3, tile_idx, dim, tiers, timed, rates, label):
    """K2 against its plain version (``q`` row-major; K2 takes ``q.t()``),
    each row with its routes (:func:`hold_dense_routes`)."""
    rows = []
    for p in tiers:
        fn = lambda p=p, **kw: sk.stream_select(table, q.t(), cand3, tile_idx, precision=p, **kw)
        plain = lambda p=p: sk.stream_select_plain(table, q.t(), cand3, tile_idx, precision=p)
        absdot = lambda p=p: sk.stream_select_plain(table.abs(), q.abs().t(), cand3, tile_idx,
                                                    precision=p)
        row = hold(f"K2 {label} {p}", fn, plain, absdot, dim, timed,
                   lambda: k1_bound(table, q, cand3, tile_idx, dim, sk.KERNEL_TILE_ROWS, rates))
        hold_dense_routes(sk, row, fn, plain, absdot, dim, timed, cand3, q.shape[0], tiles=False)
        rows.append(row)
    return rows


def pairwise_variants(sk, table, q, cand3, tile_idx, dim, tiers, timed, rates, label):
    """K1 against its plain version for each tier (``"exact"`` or
    ``"fast"``), each row with its splits (fp32 rows) or routes
    (:func:`hold_dense_routes`)."""
    rows = []
    for t in tiers:
        fn = lambda t=t, **kw: sk.stream_select_pairwise(table, q, cand3, tile_idx,
                                                         exact=t == "exact", **kw)
        plain = lambda t=t: sk.stream_select_pairwise_plain(table, q, cand3, tile_idx,
                                                            exact=t == "exact")
        absdot = lambda t=t: sk.stream_select_pairwise_plain(table.abs(), q.abs(), cand3, tile_idx,
                                                             exact=t == "exact")
        row = hold(f"K1 {label} {t}", fn, plain, absdot, dim, timed,
                   lambda: k1_bound(table, q, cand3, tile_idx, dim, sk.KERNEL_TILE_ROWS, rates))
        hold_dense_routes(sk, row, fn, plain, absdot, dim, timed, cand3, q.shape[0],
                          tiles=table.dtype == torch.float32)
        rows.append(row)
    return rows


def hold_dense_routes(sk, row, fn, plain_fn, abs_fn, dim, timed, cand3, qb, tiles) -> None:
    """The routes of one K1/K2 row (``fn(**kw)`` calls the kernel with
    ``_split`` or ``_route`` forced).  K1's fp32 body (``tiles``): the tiles
    split over one block, over ``tile_split``'s choice and over the most
    blocks give the same bits, each within the plain version's tolerance;
    the row logs the tiles and the split.  The query-major body: every
    query on work items and every one packed give the same bits, each
    within tolerance, and the routes the card takes (``dense_routes``) are
    the mirror's; the row logs the split of queries and slots.  Where
    ``timed``, ``"auto"`` and each forced form are timed in turn."""
    if tiles:
        n_tiles = cand3.shape[0]
        chosen = sk.tile_split(n_tiles, sk.sm_count(cand3.device))
        forced = {f"S{s}": {"_split": s} for s in sorted({1, chosen, sk.TILE_MAX_SPLIT})}
        split = {"tiles": n_tiles, "split": chosen}
    else:
        forced = {route: {"_route": route} for route in ("items", "packed")}
        limit = sk.dense_route_limit("auto")
        routes = sk.dense_routes(cand3, qb, limit).cpu()
        mirror = sk.dense_query_routes_plain(cand3.cpu(), qb, limit)
        check(torch.equal(routes, mirror), f"{row['variant']}: the card's routes "
              f"{routes.bincount().tolist()} are not the mirror's {mirror.bincount().tolist()}")
        counts = torch.bincount(cand3.reshape(-1).long().cpu() % qb, minlength=qb)
        split = {"pack_limit": limit}
        for name, code in (("items", sk.ROUTE_ITEMS), ("packed", sk.ROUTE_PACKED)):
            split[f"{name}_queries"] = int((routes == code).sum())
            split[f"{name}_slots"] = int(counts[routes == code].sum())
    outs = {name: fn(**kw) for name, kw in forced.items()}
    plain = plain_fn()
    tol = sum_order_tol(abs_fn(), dim)
    torch.cuda.synchronize()
    what, first = row["variant"], next(iter(outs.values()))
    for name, out in outs.items():
        check(torch.equal(out, first), f"{what}: {name} differs from {next(iter(outs))}, max "
              f"{(out - first).abs().max().item()}")
        err = (out - plain).abs()
        check(bool(torch.isfinite(out).all()) and bool((err <= tol).all()),
              f"{what}: {name} disagrees with the plain version: max err {err.max().item()}")
    row["routes"] = split
    if timed:
        row["route_ms"] = interleaved_ms(
            {name: lambda kw=kw: fn(**kw) for name, kw in {"auto": {}, **forced}.items()},
            TIMED_LAUNCHES)
    log(f"   routes {json.dumps(split)}; {', '.join(outs)} bit-identical"
        + (f"; ms in turn {json.dumps(row['route_ms'])}" if timed else ""))


def pq_variants(skpq, kernel, codes, cb, q, cand3, tile_idx, tiers, timed, rates, label):
    """K3 (``kernel="K3"``) or K4 against its plain version (``q`` row-major;
    K4 takes ``q.t()``), each row with its routes (:func:`hold_routes`)."""
    dim = cb.shape[0] * cb.shape[2]

    def call(plain, tier, c=cb, qq=q, route="auto"):
        if kernel == "K3":
            if plain:
                return skpq.stream_select_pq_pairwise_plain(codes, c, qq, cand3, tile_idx,
                                                            exact=tier != "fast")
            return skpq.stream_select_pq_pairwise(codes, c, qq, cand3, tile_idx,
                                                  exact=tier != "fast", _route=route)
        if plain:
            return skpq.stream_select_pq_plain(codes, c, qq.t(), cand3, tile_idx, precision=tier)
        return skpq.stream_select_pq(codes, c, qq.t(), cand3, tile_idx, precision=tier,
                                     _route=route)

    rows = []
    for p in tiers:
        row = hold(
            f"{kernel} {label} {p}",
            lambda p=p: call(False, p),
            lambda p=p: call(True, p),
            lambda p=p: call(True, p, cb.abs(), q.abs()),
            dim,
            timed,
            lambda: pq_bound(codes, cb, q, cand3, tile_idx, skpq.KERNEL_PQ_TILE_ROWS, rates),
        )
        hold_routes(skpq, row, lambda route, p=p: call(False, p, route=route),
                    lambda p=p: call(True, p), lambda p=p: call(True, p, cb.abs(), q.abs()), dim,
                    timed, cand3, q.shape[0],
                    skpq.adc_slot_limit(cb.shape[1], cb.shape[2], codes.dtype))
        rows.append(row)
    return rows


def hold_routes(skpq, row, fn, plain_fn, abs_fn, dim, timed, cand3, qb, slot_limit) -> None:
    """The routes of one K3/K4 row (``fn(route)`` calls the kernel): the
    forced table and slot-wise routes give the same bits and each holds the
    plain version's tolerance; the routes the card takes equal the Python
    mirror's (``adc_routes`` against ``adc_query_routes_plain``); the split
    of queries and slots between them, and (``timed``) the times of
    ``"auto"`` and of each forced route, taken in turn."""
    table, slots = fn("table"), fn("slots")
    plain = plain_fn()
    tol = sum_order_tol(abs_fn(), dim)
    torch.cuda.synchronize()
    what = row["variant"]
    check(torch.equal(table, slots), f"{what}: the table and slot-wise routes differ, max "
          f"{(table - slots).abs().max().item()}")
    for route, out in (("table", table), ("slots", slots)):
        err = (out - plain).abs()
        check(bool(torch.isfinite(out).all()) and bool((err <= tol).all()),
              f"{what}: the {route} route disagrees with the plain version: max err "
              f"{err.max().item()}")
    routes = skpq.adc_routes(cand3, qb, slot_limit).cpu()
    mirror = skpq.adc_query_routes_plain(cand3.cpu(), qb, slot_limit)
    check(torch.equal(routes, mirror), f"{what}: the card's routes {routes.bincount().tolist()} "
          f"are not the mirror's {mirror.bincount().tolist()}")
    counts = torch.bincount(cand3.reshape(-1).long().cpu() % qb, minlength=qb)
    split = {"slot_limit": slot_limit}
    for name, code in (("table", skpq.ROUTE_TABLE), ("slots", skpq.ROUTE_SLOTS)):
        split[f"{name}_queries"] = int((routes == code).sum())
        split[f"{name}_slots"] = int(counts[routes == code].sum())
    row["routes"] = split
    if timed:
        row["route_ms"] = interleaved_ms(
            {route: lambda route=route: fn(route) for route in ("auto", "table", "slots")},
            TIMED_LAUNCHES)
    log(f"   routes {json.dumps(split)}; both routes bit-identical"
        + (f"; ms in turn {json.dumps(row['route_ms'])}" if timed else ""))


def small_layout(rng, n_pad, qb, p, r, cap=None):
    """A random streamed layout on the card (cap from the pair density
    unless given)."""
    from fastforward_tpu_torch.ops import scoring

    rows = rng.integers(0, n_pad, size=p)
    qno = rng.integers(0, qb, size=p)
    cap = cap or scoring._adaptive_cap(p, n_pad // r)
    cand, tidx, _ = scoring.build_streamed_layout(rows, qno, n_pad, qb, r=r, cap=cap)
    return (
        torch.from_numpy(cand.reshape(cand.shape[0], cap // 128, 128)).cuda(),
        torch.from_numpy(tidx).cuda(),
    )


def route_layout(rng, kind: str, n_pad: int, qb: int, r: int, cap: int, slot_limit: int):
    """A ``"tail_block"`` or ``"mixed"`` layout at ``cap`` over ``n_pad``
    rows and ``qb`` queries (``slot_limit`` as
    ``stream_kernel_pq.adc_slot_limit`` gives it): ``(cand3 (Tv, cap / 128,
    128), tile_idx)`` int32 numpy arrays."""
    from fastforward_tpu_torch.ops import scoring

    if kind == "tail_block":
        counts = rng.integers(TAIL_BLOCK_SLOTS // 2, TAIL_BLOCK_SLOTS * 3 // 2 + 1, size=qb)
    elif kind == "mixed":
        hi, lo = ((slot_limit * 3 // 2, max(1, slot_limit // 2)) if slot_limit < n_pad
                  else MIXED_UNLIMITED_COUNTS)
        counts = np.where(np.arange(qb) % 2 == 0, hi, lo)
    else:
        raise ValueError(f"unknown route layout {kind!r}")
    qno = np.repeat(np.arange(qb), counts)
    rows = rng.integers(0, n_pad, size=qno.size)
    cand, tidx, _ = scoring.build_streamed_layout(rows, qno, n_pad, qb, r=r, cap=cap)
    return cand.reshape(cand.shape[0], cap // 128, 128), tidx


def small_queries(rng, q_s) -> dict:
    """The queries of each of ``SMALL_LAYOUTS``."""
    q_many = torch.from_numpy(rng.standard_normal((5000, DIM), dtype=np.float32)).cuda()
    return {"uniform": q_s, "one_query": q_s[:1], "half_padding": q_s, "many_queries": q_many}


def small_case_layout(rng, n_pad, qb, layout, kernel, cap, r):
    """One of ``SMALL_LAYOUTS`` for ``kernel`` at ``cap`` (3,000 random pairs
    at cap <= r, 6,000 above, or half-full tiles); fails unless the layout
    has that cap."""
    if layout == "half_padding":
        lay = small_layout(rng, n_pad, qb, n_pad // r * cap // 2, r, cap=cap)
    else:
        lay = small_layout(rng, n_pad, qb, 3000 if cap <= r else 6000, r)
    check(lay[0].shape[1] * 128 == cap, f"{kernel}'s small {layout} layout has cap "
          f"{lay[0].shape[1] * 128}, want {cap}")
    return lay


def dense_small_cases(sk, rng, n_pad, queries, rates) -> list:
    """K1 (cap <= r) and K2 (cap > r) against their plain versions at
    ``n_pad`` rows, dim ``DIM``, fp32, bf16 and int8 tables, every tier, on
    each of ``SMALL_LAYOUTS``."""
    r = sk.KERNEL_TILE_ROWS
    t32 = torch.from_numpy(rng.standard_normal((n_pad, DIM), dtype=np.float32)).cuda()
    t8 = torch.from_numpy(rng.integers(-127, 128, size=(n_pad, DIM // 128, 128), dtype=np.int8)).cuda()
    rows_out = []
    for layout, q in queries.items():
        lay1 = small_case_layout(rng, n_pad, q.shape[0], layout, "K1", 512, r)
        lay2 = small_case_layout(rng, n_pad, q.shape[0], layout, "K2", 1024, r)
        # K1 takes 2D float tables; K2 is routed 3D ones
        for name, t1, t2 in (("fp32", t32, t32.view(n_pad, DIM // 128, 128)),
                             ("bf16", t32.to(torch.bfloat16), t32.to(torch.bfloat16)),
                             ("int8", t8, t8)):
            rows_out += pairwise_variants(sk, t1, q, *lay1, DIM, ("exact", "fast"), False, rates,
                                          f"{name} {layout}")
            rows_out += select_variants(sk, t2, q, *lay2, DIM, ("exact", "high", "fast"), False,
                                        rates, f"{name} {layout}")
    return rows_out


def fp32_edge_tiles(rng, cap: int, r: int, qb: int, n_tiles: int):
    """Virtual tiles that pin each shortcut of K1's fp32 body
    (``csrc/tile_dot.cuh``; the padding value is ``qb - 1``):

    0. runs of one value, the first at slot 0, runs across slots 31/32 (a
       warp's slots) and 255/256 (a block's threads), the last ending at
       slot ``cap - 1``; padding slots scattered between them; slots 33-39
       repeat slots 20-31 after a break (a run of their own);
    1. padding alone, on a tile other than 0;
    2. one local row wanted by every slot, over random queries;
    3. one value in every slot (a single run);
    4. distinct random values, then tail padding (as the layout builder
       leaves a tile);
    5. padding alone on tile 0 (a bucket tile);
    6. pairs of 1-7 rows padded to 8 slots by repeating the last row, one
       query a pair (a document mode's K = 8), then tail padding;
    7. padding first, one real value in slot ``cap - 1``.

    Returns ``(cand (8, cap), tile_idx (8,))`` int32 numpy arrays."""
    pad = qb - 1

    def val():
        return rng.integers(0, r) * qb + rng.integers(0, qb)

    cand = np.full((8, cap), pad, dtype=np.int64)
    bounds = sorted({0, 20, 40, 250, 262, cap - 50, cap})
    for lo, hi in zip(bounds, bounds[1:]):
        cand[0, lo:hi] = val()
    cand[0, rng.choice(np.arange(1, cap - 1), size=cap // 16, replace=False)] = pad
    cand[0, 32] = val()
    cand[2] = rng.integers(0, r) * qb + rng.integers(0, qb, size=cap)
    cand[3] = val()
    cand[4, : cap * 2 // 3] = rng.permutation(r * qb)[: cap * 2 // 3]
    for pos in range(0, cap * 3 // 4 - 7, 8):
        n_rows, local = int(rng.integers(1, 8)), int(rng.integers(0, r - 7))
        cand[6, pos:pos + 8] = (local + np.minimum(np.arange(8), n_rows - 1)) * qb + rng.integers(0, qb)
    cand[7, cap - 1] = val()
    tile_idx = rng.integers(1, n_tiles, size=8)
    tile_idx[5] = 0
    return cand.astype(np.int32), tile_idx.astype(np.int32)


def fp32_edge_cases(sk, rng, n_pad) -> list:
    """K1's fp32 body against its plain version on :func:`fp32_edge_tiles`
    at dim ``DIM``, every cap from 128 to 1024, r 512 and 128 (``cap <= r``
    and ``cap > r``), both tiers; the padding query is not zero."""
    qb = 37
    table = torch.from_numpy(rng.standard_normal((n_pad, DIM), dtype=np.float32)).cuda()
    q = rng.standard_normal((qb, DIM), dtype=np.float32)
    q[qb - 1] *= 3.0
    q = torch.from_numpy(q).cuda()
    rows_out = []
    for r in (512, 128):
        for cap in (128, 256, 512, 1024):
            cand, tidx = fp32_edge_tiles(rng, cap, r, qb, n_pad // r)
            cand3 = torch.from_numpy(cand.reshape(8, cap // 128, 128)).cuda()
            tile_idx = torch.from_numpy(tidx).cuda()
            for exact in (True, False):
                rows_out.append(hold(
                    f"K1 fp32 edge tiles cap {cap} r {r} {'exact' if exact else 'fast'}",
                    lambda c=cand3, t=tile_idx, e=exact, rr=r: sk.stream_select_pairwise(
                        table, q, c, t, r=rr, exact=e),
                    lambda c=cand3, t=tile_idx, e=exact, rr=r: sk.stream_select_pairwise_plain(
                        table, q, c, t, r=rr, exact=e),
                    lambda c=cand3, t=tile_idx, e=exact, rr=r: sk.stream_select_pairwise_plain(
                        table.abs(), q.abs(), c, t, r=rr, exact=e),
                    DIM, False, None,
                ))
    return rows_out


def pq_small_cases(skpq, rng, n_pad, queries, rates) -> list:
    """K3 (cap <= r) and K4 (cap > r) against their plain versions at
    ``n_pad`` rows, dim ``DIM``, every tier, for each ``(M, Ks)`` of
    ``PQ_SMALL_SHAPES`` on each of ``SMALL_LAYOUTS`` and on the mixed
    layout of :func:`route_layout` (both routes in one call)."""
    r = skpq.KERNEL_PQ_TILE_ROWS
    rows_out = []
    for m, ks in PQ_SMALL_SHAPES:
        codes = torch.from_numpy(rng.integers(0, ks, size=(n_pad, m), dtype=np.uint8)).cuda()
        cb = torch.from_numpy(rng.standard_normal((m, ks, DIM // m), dtype=np.float32)).cuda()
        limit = skpq.adc_slot_limit(ks, DIM // m, codes.dtype)
        for layout, q in (*queries.items(), ("mixed", queries["uniform"][:MIXED_QUERIES])):
            for kernel, cap, tiers in (("K3", 512, ("exact", "fast")),
                                       ("K4", 1024, ("exact", "high", "fast"))):
                if layout == "mixed":
                    lay = [torch.from_numpy(a).cuda() for a in route_layout(
                        rng, layout, n_pad, MIXED_QUERIES, r, cap, limit)]
                else:
                    lay = small_case_layout(rng, n_pad, q.shape[0], layout, kernel, cap, r)
                rows_out += pq_variants(skpq, kernel, codes, cb, q, *lay, tiers, False, rates,
                                        f"pq({m},{ks}) {layout}")
    return rows_out


class DecodedRows:
    """Rows of a quantized table decoded on the card in float64, indexed
    like a tensor of rows (``decoded[rows]``)."""

    def __init__(self, decode):
        self._decode = decode

    def __getitem__(self, rows):
        return self._decode(rows)


def scalar_rows(codes: np.ndarray, scales: np.ndarray) -> DecodedRows:
    codes_dev = torch.from_numpy(codes).cuda()
    scales_dev = torch.from_numpy(scales).cuda().double()
    return DecodedRows(lambda rows: codes_dev[rows].double() * scales_dev)


def pq_rows(codes: np.ndarray, codewords: np.ndarray) -> DecodedRows:
    """PQ decode without OPQ's inverse rotation (the queries get ``R``)."""
    from fastforward_tpu_torch.ops.stream_kernel_pq import gather_codes

    codes_dev = torch.from_numpy(codes).cuda()
    cb = torch.from_numpy(codewords).cuda().double()
    sub = torch.arange(cb.shape[0], device="cuda")[None, :]
    return DecodedRows(lambda rows: cb[sub, gather_codes(codes_dev, rows)].reshape(rows.shape[0], -1))


def check_encode(label: str, quantizer, codes: np.ndarray, vectors: np.ndarray) -> float:
    """The codes the card gave ``ENCODE_CHECK_ROWS`` rows spread over
    ``vectors`` against the same quantizer's encode on the CPU.  With the
    same codebooks both are fp32 nearest-centroid searches that differ only
    in summation order, so only exact near-ties may differ; a TF32 product
    or a wrong encode would flip far more than ``1 - ENCODE_AGREE``."""
    on_cpu = type(quantizer).deserialize(*quantizer.serialize())
    on_cpu.device = "cpu"
    rows = np.linspace(0, vectors.shape[0] - 1, ENCODE_CHECK_ROWS).astype(np.int64)
    agree = float((codes[rows] == on_cpu.encode(vectors[rows])).mean())
    check(agree >= ENCODE_AGREE, f"{label}: the card's codes agree with the CPU's on {agree:.5f}")
    log(f"  {label}: the card's codes of {ENCODE_CHECK_ROWS} rows agree with a CPU encode on "
        f"{agree:.5f} of them")
    return agree


def check_fit(cls, m: int, ks: int) -> float:
    """``cls(m, ks)`` fitted on the card and on the CPU, from the same seed
    (the same initial rows), on clustered data at dim ``DIM``: the two
    k-means encode at least ``FIT_AGREE`` of the held-out codes alike (not
    all: a near-tie that the two sums break differently moves a centroid
    slightly in every later iteration)."""
    rng = np.random.default_rng(SEED + 2)
    centers = rng.standard_normal((m, ks, DIM // m), dtype=np.float32) * 3
    pick = rng.integers(0, ks, size=(FIT_CHECK_N, m))
    data = centers[np.arange(m)[None, :], pick].reshape(FIT_CHECK_N, DIM)
    data = (data + 0.3 * rng.standard_normal(data.shape, dtype=np.float32)).astype(np.float32)
    train, held_out = data[: FIT_CHECK_N // 2], data[FIT_CHECK_N // 2 :]
    card, host = cls(m, ks), cls(m, ks, device="cpu")
    card.fit(train)
    host.fit(train)
    agree = float((card.encode(held_out) == host.encode(held_out)).mean())
    check(agree >= FIT_AGREE, f"{cls.__name__}({m}, {ks}) fitted on the card and on the CPU "
          f"agree on {agree:.5f} of the codes")
    log(f"  {cls.__name__}({m}, {ks}) fitted on the card and on the CPU from one seed: "
        f"{agree:.5f} of {held_out.shape[0]} x {m} held-out codes agree")
    return agree


def add_in_chunks(index, vectors: np.ndarray, psg_ids: list, doc_ids: "list | None" = None,
                  chunk: int = 1 << 18) -> None:
    """Add (and so encode) the vectors in chunks, bounding the temporaries."""
    for lo in range(0, vectors.shape[0], chunk):
        part = vectors[lo : lo + chunk]
        hi = lo + part.shape[0]
        index.add(part, psg_ids=psg_ids[lo:hi], doc_ids=None if doc_ids is None else doc_ids[lo:hi])


def index_phase(label, index, ranking, wrappers, want, forbid, kernels, exact, run):
    """Cold + warm re-ranks and the fused serve of ``index`` on ``ranking``,
    each checked against float64 (``exact``, over ``run``); the phase must
    launch ``want`` and no ``forbid``, and a profile counts only with all of
    ``kernels`` (one of ``CALL_KERNELS``).  Returns (flows, launches)."""
    reset_counts(wrappers)
    t0 = time.perf_counter()
    cold = index(ranking)
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    warm_ms, warm = timed_calls(lambda: index(ranking), WARM_CALLS)
    check(len(warm._df) == len(ranking._df), f"{label} re-rank lost pairs")
    check_rerank(warm, exact, f"{label} re-rank")
    check(cold == warm, f"{label}: cold and warm re-rank disagree")
    t0 = time.perf_counter()
    index.serve(ranking, ALPHA, CUTOFF)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    serve_ms, served = timed_calls(lambda: index.serve(ranking, ALPHA, CUTOFF), WARM_CALLS)
    launches = read_counts(wrappers)
    check_serve(served, run, exact, f"{label} serve")
    check(launches[want] == 2 * (1 + WARM_CALLS),
          f"{label} launched {want} {launches[want]} times: {launches}")
    for name in forbid:
        check(launches[name] == 0, f"{label} launched {name}: {launches}")
    flows = {
        f"{label}_rerank": {"cold_ms": cold_ms, "warm_ms": warm_ms, "qps": QUERIES / warm_ms * 1e3},
        f"{label}_serve": {"first_ms": first_ms, "warm_ms": serve_ms, "qps": QUERIES / serve_ms * 1e3},
    }
    log(f"[{label}] re-rank cold {cold_ms:.1f} ms, warm median {warm_ms:.2f} ms; serve first "
        f"{first_ms:.1f} ms, warm median {serve_ms:.2f} ms; launches {launches}")
    for key, fn in (
        (f"{label}_rerank", lambda: index(ranking)),
        (f"{label}_serve", lambda: index.serve(ranking, ALPHA, CUTOFF)),
    ):
        flows[key]["profile"] = profile_flow(fn, kernels)
        log(f"[profile {key}]", json.dumps(flows[key]["profile"]))
    return flows, launches


def serve_memory(index, ranking, scratch: dict) -> dict:
    """Device memory of one warm serve of ``index``: what the index and its
    plan hold, the peak, and the kernel scratch of ``scratch`` (bytes)."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    index.serve(ranking, ALPHA, CUTOFF)
    torch.cuda.synchronize()
    return {"held_bytes": held, "peak_bytes": torch.cuda.max_memory_allocated(), **scratch}


def tower_phase(index, ranking, run, queries, corpus_dev, q_index, wrappers, launches, rates,
                name) -> dict:
    """Phase 18: BERT-base (``TCTColBERTQueryEncoder``) and DistilBERT-base
    (``TASBEncoder``) towers with random weights, saved as checkpoints with
    a hand-written vocabulary and opened by the encoders: the flagship
    run's queries encoded on the card in fp32 and bf16, held against the
    port's tower and transformers' eager forward on the CPU, timed against
    their bounds; then the flagship re-rank and serve with the fp32 TCT
    encoder as the index's query encoder, which must launch K1 alone."""
    from transformers import AutoModel
    from transformers import BertConfig as HFBertConfig
    from transformers import BertModel, DistilBertConfig, DistilBertModel

    from fastforward_tpu_torch.encoder import TASBEncoder, TCTColBERTQueryEncoder, transformer
    from fastforward_tpu_torch.index import Mode

    tmp = Path(tempfile.mkdtemp(prefix="ff-towers-"))
    bf16_rate = card_bf16_rate(name)
    texts = [queries[f"q{i}"] for i in range(len(queries))]
    check_texts = texts[:TOWER_CHECK_QUERIES]
    towers, encoders = {}, {}
    try:
        t0 = time.perf_counter()
        torch.manual_seed(0)
        tct_path = write_checkpoint(tmp / "tct", BertModel(HFBertConfig()).eval(),
                                    tower_vocab(TOWER_VOCAB))
        torch.manual_seed(1)
        tasb_path = write_checkpoint(tmp / "tasb", DistilBertModel(DistilBertConfig()).eval(),
                                     tower_vocab(TOWER_VOCAB))
        log(f"[setup] BERT-base and DistilBERT-base checkpoints (random weights, vocabulary "
            f"{TOWER_VOCAB}) written in {time.perf_counter() - t0:.1f} s")
        for label, cls, path in (("tct", TCTColBERTQueryEncoder, tct_path),
                                 ("tasb", TASBEncoder, tasb_path)):
            # the CPU references on the first queries: the port's tower in
            # fp32 and bf16, and transformers' own eager forward
            cpu32 = cls(path, device="cpu")
            want32 = cpu32(check_texts)
            want16 = cls(path, device="cpu", compute_dtype="bfloat16")(check_texts)
            tokens = cpu32._tokenizer(cpu32._get_tokenizer_inputs(check_texts), return_tensors="pt",
                                      **{"padding": True, **cpu32._tokenizer_call_args})
            eager = AutoModel.from_pretrained(path, attn_implementation="eager").eval()
            with torch.no_grad():
                hidden = eager(input_ids=tokens["input_ids"],
                               attention_mask=tokens["attention_mask"]).last_hidden_state
            want_hf = transformer._POOLING[cls._pooling](hidden, tokens["attention_mask"]).numpy()
            # transformers' tolerance of the JAX tower (tests/test_models.py:63)
            row = {"tokens_per_query": int(tokens["input_ids"].shape[1]),
                   "max_err_cpu_tower_vs_transformers_eager": check_close(
                       want32, want_hf, 2e-4, 1e-3, f"{label} CPU tower vs transformers")}
            del eager, cpu32, hidden
            for dtype in ("float32", "bfloat16"):
                enc = cls(path, compute_dtype=dtype)
                check(enc.device.type == "cuda", f"{label} {dtype}: the tower is not on the card")
                vecs = enc(texts)
                check(vecs.shape == (len(texts), DIM) and vecs.dtype == np.float32,
                      f"{label} {dtype}: vectors {vecs.shape} {vecs.dtype}")
                got = vecs[:TOWER_CHECK_QUERIES]
                if dtype == "float32":
                    # both IEEE fp32, summed in other orders (TF32, on in this
                    # process, would miss by ~1e-2)
                    err = check_close(got, want32, 1e-4, 1e-4, f"{label} fp32 card vs CPU")
                    encoders[label] = enc
                    card32 = vecs
                else:
                    # each layer carries a one-step rounding difference on: 16
                    # bf16 steps at the largest value, and (rms) no further from
                    # the CPU's bf16 tower than that is from the fp32 one, twice
                    err = check_close(got, want16, 16 * 2.0**-8 * np.abs(want16).max(), 0.0,
                                      f"{label} bf16 card vs CPU")
                    rms = float(np.sqrt(np.mean((got - want16) ** 2)))
                    rms_ref = float(np.sqrt(np.mean((want16 - want32) ** 2)))
                    check(rms <= 2 * rms_ref,
                          f"{label} bf16: rms {rms:.3e} vs the CPU's bf16-fp32 {rms_ref:.3e}")
                    row.update(bf16_rms_vs_cpu_bf16=rms, cpu_bf16_rms_vs_fp32=rms_ref,
                               bf16_max_diff_vs_card_fp32=float(np.abs(vecs - card32).max()))
                encode_ms, _ = timed_calls(lambda: enc(texts), TOWER_TIMED)
                tok = enc._tokenizer(enc._get_tokenizer_inputs(texts), return_tensors="np",
                                     **{"padding": True, **enc._tokenizer_call_args})
                ids = torch.from_numpy(tok["input_ids"]).cuda()
                mask = torch.from_numpy(tok["attention_mask"]).cuda()
                with torch.inference_mode():
                    tower_ms = median_ms(lambda: enc._tower(ids, mask), TOWER_TIMED, warmup=1)
                    torch.cuda.synchronize()
                    held = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    enc._tower(ids, mask)
                    torch.cuda.synchronize()
                    peak = torch.cuda.max_memory_allocated() - held
                    # where the tower's device time goes, by kernel
                    traced = profile_flow(lambda: enc._tower(ids, mask), (), needs_copy=False)
                bound = tower_bound(enc.config, ids.shape[0], ids.shape[1],
                                    bf16_rate if dtype == "bfloat16" else rates[1], rates[0])
                row[dtype] = {"encode_ms": encode_ms, "tower_ms": tower_ms,
                              "max_err_vs_cpu": err, "peak_activation_bytes": peak,
                              "weight_bytes": sum(p.numel() * p.element_size()
                                                  for p in enc._tower.parameters()),
                              **bound, "bound_share": bound["bound_ms"] / tower_ms,
                              "traced_device_ms": traced["device_ms"],
                              "top_device_ms": traced["top_device_ms"]}
                log(f"[{label} {dtype}] {len(texts)} queries x {ids.shape[1]} tokens: encode "
                    f"{encode_ms:.2f} ms (median of {TOWER_TIMED}, host, synchronized), tower "
                    f"{tower_ms:.2f} ms (CUDA events) vs bound {bound['bound_ms']:.3f} ms "
                    f"({bound['flops'] / 1e12:.3f} TFLOP, {bound['bound_by']}); peak "
                    f"activations {peak} B; max err vs CPU {err:.3e}")
            towers[label] = row
        towers["card"] = smi_line()
        log(f"[towers] {json.dumps(towers)}")

        # the flagship re-rank and serve with the fp32 TCT tower as the
        # query encoder (the index's own micro-batches of encoder_batch_size)
        index.mode = Mode.PASSAGE
        index.query_encoder = encoders["tct"]
        reset_counts(wrappers)
        t0 = time.perf_counter()
        cold = index(ranking)
        torch.cuda.synchronize()
        cold_ms = (time.perf_counter() - t0) * 1e3
        warm_ms, warm = timed_calls(lambda: index(ranking), WARM_CALLS)
        served = index.serve(ranking, ALPHA, CUTOFF)
        counts = read_counts(wrappers)
        launches["tower_rerank"] = counts
        n_k1 = counts["stream_select_pairwise"]
        check(n_k1 == 2 + WARM_CALLS and sum(counts.values()) == n_k1,
              f"the tower re-rank and serve launched {counts}")
        check(cold == warm, "tower re-rank: cold and warm disagree")
        # float64 of the vectors the index encoded
        tower_q = torch.from_numpy(index.encode_queries(texts)).cuda()
        exact = passage_exact(corpus_dev, tower_q, q_index, DIM)
        check_rerank(warm, exact, "tower re-rank")
        check_serve(served, run, exact, "tower serve")
        encode_ms, _ = timed_calls(lambda: index.encode_queries(texts), TOWER_TIMED)
        profile = profile_flow(lambda: index(ranking), CALL_KERNELS["pairwise"])
        rerank = {"cold_ms": cold_ms, "warm_ms": warm_ms, "qps": len(texts) / warm_ms * 1e3,
                  "k1_launches": n_k1, "encode_queries_ms": encode_ms,
                  "encoder_batch_size": index._encoder_batch_size, "profile": profile}
        log(f"[tower re-rank] on {towers['card']}: cold {cold_ms:.1f} ms, warm median {warm_ms:.2f} ms "
            f"({rerank['qps']:.1f} QPS); encode_queries alone {encode_ms:.2f} ms (batches of "
            f"{index._encoder_batch_size}); K1 launches {n_k1}; traced spans "
            f"{json.dumps(profile['host_span_ms'])}")
    finally:
        encoders.clear()
        shutil.rmtree(tmp, ignore_errors=True)
    return {"towers": towers, "tower_rerank": rerank}


def decoder_phase(rates) -> list:
    """Phase 28: the decoder tower's kernels at E5-Mistral-7B-instruct's
    widths (see the module docstring).  Returns the three kernels' rows of
    the ``{"kernels": [...]}`` summary."""
    import torch.nn.functional as F

    from fastforward_tpu_torch.device import fp32_matmul
    from fastforward_tpu_torch.models import mistral
    from fastforward_tpu_torch.ops import _build

    t_phase = time.perf_counter()
    lib_path = _build.build_kernel("decoder")
    log(f"[decoder] decoder.cu built in {time.perf_counter() - t_phase:.2f} s: {lib_path.name}")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "Used" in line or "spill" in line:
            log("  ptxas:", line.strip())

    # the tower, drawn as bench_port/encoders/E5MistralEncoder.py draws it:
    # N(0, 0.02^2) in fp32, matrices cast to bf16, gains 1 + N(0, 0.02^2)
    t0 = time.perf_counter()
    cfg = mistral.MistralConfig()
    eps, dev = cfg.rms_norm_eps, torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(SEED)

    def drawn(shape, gain):
        t = torch.randn(shape, generator=gen, device=dev).mul_(0.02)
        return t.add_(1) if gain else t.to(torch.bfloat16)

    state = {"embed_tokens.weight": drawn((cfg.vocab_size, cfg.hidden_size), False),
             "norm.weight": drawn((cfg.hidden_size,), True)}
    for i in range(cfg.num_layers):
        for key, name in mistral.LAYER_NAMES.items():
            state[f"layers.{i}.{name}"] = drawn(cfg.shapes()[key], key in mistral.NORMS)
    tower = mistral.MistralTower.from_arrays(cfg, state).eval()
    del state
    rng = np.random.default_rng(SEED)
    lengths = rng.integers(DECODER_TOKENS[0], DECODER_TOKENS[1] + 1, size=DECODER_QUERIES)
    batches = []
    for start in range(0, DECODER_QUERIES, DECODER_BATCH):
        n = lengths[start:start + DECODER_BATCH]
        mask = torch.from_numpy(np.arange(n.max())[None] < n[:, None]).long().to(dev)
        ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=mask.shape)).to(dev)
        batches.append((ids, mask))
    torch.cuda.synchronize()
    log(f"[decoder] tower of {cfg.num_layers} layers ({sum(p.numel() for p in tower.parameters())} "
        f"parameters, bf16) drawn in {time.perf_counter() - t0:.1f} s; {len(batches)} micro-batches "
        f"of {DECODER_BATCH} x {[int(b[0].shape[1]) for b in batches]} tokens")

    # one call of the cell: every micro-batch through the kernels, and no more
    wrappers = {kernel.__name__: kernel for kernel in mistral.KERNELS}
    with torch.inference_mode():
        tower(*batches[0])  # the first forward binds the object
        torch.cuda.synchronize()
        reset_counts(wrappers)
        t0 = time.perf_counter()
        for ids, mask in batches:
            tower(ids, mask)
        torch.cuda.synchronize()
        call_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts(wrappers)
    blocks = len(batches) * cfg.num_layers
    want = {"rms_norm": 2 * blocks + len(batches), "rope_attention": blocks, "swiglu": blocks}
    check(launches == want, f"one call of the cell launched {launches}, not {want}")
    log(f"[decoder] one call ({DECODER_QUERIES} queries) in {call_ms:.1f} ms (host clock, "
        f"synchronized) launched {json.dumps(launches)}")

    # each kernel against its plain version on the activations it sees in
    # the tower: the longest micro-batch, at DECODER_CHECK_LAYERS
    ids, mask = max(batches, key=lambda b: b[0].shape[1])
    b, length = ids.shape
    heads, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cos, sin = mistral.rope_tables(length, d, cfg.rope_theta, dev)
    keys = mask.to(torch.int32)
    errs = {name: [] for name in wrappers}
    timed_inputs = {}

    def hold_kernel(name, got, want, where):
        check(got.dtype == want.dtype and got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"{name} {where}: {got.dtype} {tuple(got.shape)} vs {want.dtype} {tuple(want.shape)}")
        top = want.abs().max().item()
        # fp32: sums in other orders (the attention's online softmax); bf16:
        # both round an fp32 value, which may land one step apart
        tol = (2.0**-8 if want.dtype == torch.bfloat16 else 1e-5) * top
        err = (got.float() - want.float()).abs().max().item()
        check(err <= tol, f"{name} {where}: max err {err:.3e} over {tol:.3e}")
        errs[name].append({"at": where, "max_abs_err": err, "tolerance": tol})

    def calls(x, layer, dtype):
        """name -> (kernel call, plain call) on ``x`` at ``layer``, in ``dtype``."""
        x = x.to(dtype)
        h = mistral.rms_norm_plain(x, layer.attn_norm, eps, dtype)
        q, k, v = (F.linear(h.bfloat16(), w).to(dtype).view(b, length, -1, d)
                   for w in (layer.q, layer.k, layer.v))
        gate, up = (F.linear(h.bfloat16(), w).to(dtype) for w in (layer.gate, layer.up))
        return {
            "rms_norm": (lambda: mistral.rms_norm(x, layer.attn_norm, eps),
                         lambda: mistral.rms_norm_plain(x, layer.attn_norm, eps, dtype)),
            "rope_attention": (lambda: mistral.rope_attention(q, k, v, cos, sin, keys, cfg.sliding_window),
                               lambda: mistral.rope_attention_plain(q, k, v, cos, sin, keys,
                                                                    cfg.sliding_window)),
            "swiglu": (lambda: mistral.swiglu(gate, up), lambda: mistral.swiglu_plain(gate, up)),
        }

    with torch.inference_mode(), fp32_matmul(dev):
        x = tower.embed[ids]
        for i, layer in enumerate(tower.layers):
            if i in DECODER_CHECK_LAYERS:
                for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
                    pairs = calls(x, layer, dtype)
                    for name, (fn, plain) in pairs.items():
                        hold_kernel(name, fn(), plain(), f"layer {i} {tag}")
                    if i == 0:
                        timed_inputs[tag] = pairs
            x = tower._attention(x, layer, cos, sin, keys)
            x = tower._mlp(x, layer)
        hold_kernel("rms_norm", mistral.rms_norm(x, tower.norm, eps, torch.float32),
                    mistral.rms_norm_plain(x, tower.norm, eps, torch.float32), "final norm")
        got = tower(ids, mask)
        torch.cuda.synchronize()

    # the whole tower: through the kernels, then with the plain versions on the card
    chains = {name: getattr(mistral, name) for name in wrappers}
    plains = {"rms_norm": lambda x, g, e, out_dtype=None: mistral.rms_norm_plain(
                  x, g, e, x.dtype if out_dtype is None else out_dtype),
              "rope_attention": mistral.rope_attention_plain, "swiglu": mistral.swiglu_plain}
    with torch.inference_mode():
        tower_ms = median_ms(lambda: tower(ids, mask), 5, warmup=1)
        try:
            for name, fn in plains.items():
                setattr(mistral, name, fn)
            want_out = tower(ids, mask)
            plain_tower_ms = median_ms(lambda: tower(ids, mask), 5, warmup=1)
        finally:
            for name, fn in chains.items():
                setattr(mistral, name, fn)
    real = mask.bool()
    diff = (got[real] - want_out[real]).abs()
    whole = {"tokens": [b, length], "ms": tower_ms, "plain_ms": plain_tower_ms,
             "max_abs_diff_vs_plain": diff.max().item(),
             "max_abs_plain": want_out[real].abs().max().item(),
             "rms_diff_vs_plain": diff.pow(2).mean().sqrt().item()}
    log(f"[decoder] the tower on {b} x {length} tokens: {tower_ms:.2f} ms through the kernels, "
        f"{plain_tower_ms:.2f} ms plain on the card (CUDA events, median of 5); "
        f"{json.dumps(whole)}")

    # each kernel timed on layer 0's activations of that micro-batch
    summary = []
    for name, kname in DECODER_KERNELS.items():
        rows_k = []
        for tag, pairs in timed_inputs.items():
            fn, plain = pairs[name]
            out = fn()
            moved = decoder_bytes(name, out, cfg, b, length)
            row = {"variant": f"{tag} {b} x {length}", "bytes": moved, "bound_ms": moved / rates[0] * 1e3,
                   "ms": median_ms(fn, TIMED_LAUNCHES), "back_to_back_ms": back_to_back_ms(fn, TIMED_LAUNCHES),
                   "traced_ms": traced_kernels(fn, (kname,)).get(kname),
                   "plain_ms": median_ms(plain, TIMED_LAUNCHES)}
            rows_k.append(row)
            log(f"  {name} {row['variant']}: {row['ms']:.4f} ms ({row['back_to_back_ms']:.4f} back to "
                f"back), traced {row['traced_ms']} ms, bound {row['bound_ms']:.5f} ms "
                f"({moved} B), plain {row['plain_ms']:.4f} ms")
        main = rows_k[0]
        summary.append({
            "name": name,
            "route": "cuda",
            "source": "fastforward_tpu_torch/ops/csrc/decoder.cu",
            "replaces": None,  # the JAX package has no decoder tower
            "launches": launches[name],
            "max_abs_err": max(e["max_abs_err"] for e in errs[name]),
            "tolerance": "fp32 1e-5 x max|plain|; bf16 one bf16 step at max|plain|",
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "launches_by_phase": {"decoder": launches[name]},
            "checks": errs[name],
            "variants": rows_k,
        })
    summary[0]["tower"] = whole
    del tower, batches, timed_inputs, got, want_out
    torch.cuda.empty_cache()
    log(f"[decoder] phase 28 passed in {time.perf_counter() - t_phase:.1f} s on {smi_line()}")
    return summary


def moe_phase(rates, bf16_rate: float) -> list:
    """Phase 29: the expert tower's kernels at Moonlight-16B-A3B's widths
    (see the module docstring).  Returns the five kernels' rows of the
    ``{"kernels": [...]}`` summary."""
    from types import SimpleNamespace

    import torch.nn.functional as F

    from bench_port import spec
    from fastforward_tpu_torch.device import fp32_matmul
    from fastforward_tpu_torch.models import deepseek, mistral
    from fastforward_tpu_torch.ops import _build

    t_phase = time.perf_counter()
    for source in ("moe", "decoder"):
        lib_path = _build.build_kernel(source)
        log(f"[moe] {source}.cu built: {lib_path.name}")
        for line in lib_path.with_suffix(".log").read_text().splitlines():
            if "Used" in line or "spill" in line:
                log("  ptxas:", line.strip())

    root = Path(__file__).resolve().parent
    config = json.loads((root / "bench_port/configs/msmarco-passage-moonlight.json").read_text())
    plugin = spec.plugin(root, "encoders", config["encoder"])
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    hf_config = SimpleNamespace(**config["tower"])
    tower = deepseek.DeepseekTower.from_arrays(
        deepseek.config_from_hf(hf_config), plugin.state_dict(SEED, config["tower"], torch.bfloat16, dev)).eval()
    cfg = tower.config
    vocab = plugin._E5.vocabulary(cfg.vocab_size)
    index = {w: i for i, w in enumerate(vocab)}
    rng = np.random.default_rng(SEED)
    texts = [" ".join(f"w{w}" for w in rng.integers(0, cfg.vocab_size - 9, size=n))
             for n in rng.integers(2, 16, size=MOE_QUERIES)]
    seqs = [plugin._E5.token_ids(t, index) for t in texts]
    batches = []
    for start in range(0, MOE_QUERIES, MOE_BATCH):
        part = seqs[start:start + MOE_BATCH]
        ids = np.zeros((len(part), max(map(len, part))), dtype=np.int64)
        mask = np.zeros_like(ids)
        for row, seq in enumerate(part):
            ids[row, :len(seq)], mask[row, :len(seq)] = seq, 1
        batches.append((torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)))
    torch.cuda.synchronize()
    log(f"[moe] tower of {cfg.num_layers} layers ({sum(p.numel() for p in tower.parameters())} parameters, "
        f"bf16) drawn in {time.perf_counter() - t0:.1f} s; {len(batches)} micro-batches of {MOE_BATCH} x "
        f"{[int(b[0].shape[1]) for b in batches]} tokens ({int(sum(b[1].sum() for b in batches))} real)")

    # one call of the cell: every micro-batch through the kernels, and no more
    wrappers = {kernel.__name__: kernel for kernel in deepseek.KERNELS + (mistral.rms_norm, mistral.swiglu)}
    with torch.inference_mode():
        tower(*batches[0])  # the first forward binds the objects and the experts' address tables
        torch.cuda.synchronize()
        reset_counts(wrappers)
        t0 = time.perf_counter()
        for ids, mask in batches:
            tower(ids, mask)
        torch.cuda.synchronize()
        call_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts(wrappers)
    n, layers, dense = len(batches), cfg.num_layers, cfg.first_k_dense_replace
    sparse = layers - dense
    want = {"latent_attention": n * layers, "moe_route": n * sparse, "moe_permute": n * sparse,
            "grouped_gemm": 2 * n * sparse, "moe_combine": n * sparse, "rms_norm": n * (3 * layers + 1),
            "swiglu": n * (dense + 2 * sparse)}
    check(launches == want, f"one call of the cell launched {launches}, not {want}")
    stats = tower.moe_stats()["recent"][-n:]
    for (ids, mask), got in zip(batches, stats):
        real = int(mask.sum())
        check(got["routed"] == [real * cfg.num_experts_per_tok] * sparse,
              f"routed {got['routed'][:3]}... for {real} real tokens")
    log(f"[moe] one call ({MOE_QUERIES} queries) in {call_ms:.1f} ms (host clock, synchronized) launched "
        f"{json.dumps(launches)}; the last micro-batch's experts took at most "
        f"{stats[-1]['expert_max'][:4]}... pairs (mean {stats[-1]['expert_mean'][0]:.1f})")

    # each kernel against its plain version on the first micro-batch's
    # activations at MOE_CHECK_LAYERS, stepping the layers by hand
    ids, mask = batches[0]
    b, length = ids.shape
    dn, heads, k_top, hidden = cfg.qk_nope_head_dim, cfg.num_heads, cfg.num_experts_per_tok, cfg.hidden_size
    cos, sin = mistral.rope_tables(length, cfg.qk_rope_head_dim, cfg.rope_theta, dev)
    keys = mask.to(torch.int32)
    flat_keys = keys.view(-1)
    real = flat_keys.bool()
    errs = {name: [] for name in MOE_KERNELS}
    timed, chosen = {}, []

    def hold_kernel(name, got, want, where):
        check(got.dtype == want.dtype and got.shape == want.shape and bool(torch.isfinite(got.float()).all()),
              f"{name} {where}: {got.dtype} {tuple(got.shape)} vs {want.dtype} {tuple(want.shape)}")
        top = want.float().abs().max().item()
        # fp32: sums in other orders; bf16: both round an fp32 value, which
        # may land one step apart (2^-7 of the largest output's power of two)
        tol = math.ldexp(1.0, math.frexp(top)[1] - 8) if want.dtype == torch.bfloat16 else 1e-5 * top
        err = (got.float() - want.float()).abs().max().item()
        check(err <= tol, f"{name} {where}: max err {err:.3e} over {tol:.3e}")
        errs[name].append({"at": where, "max_abs_err": err, "tolerance": tol})

    with torch.inference_mode(), fp32_matmul(dev):
        x = tower.embed[ids]
        for i, layer in enumerate(tower.layers):
            where = f"layer {i}"
            if i in MOE_CHECK_LAYERS:
                h = mistral.rms_norm(x, layer.attn_norm, cfg.rms_norm_eps)
                q = F.linear(h, layer.q).view(b, length, heads, cfg.qk_head_dim)
                latent = mistral.rms_norm(F.linear(h, layer.kv_latent), layer.kv_norm, cfg.rms_norm_eps)
                kv = F.linear(latent, layer.kv_b).view(b, length, heads, dn + cfg.v_head_dim)
                args = (q, kv[..., :dn], F.linear(h, layer.k_rope), kv[..., dn:], cos, sin, keys)
                for tag, cast in (("bf16", lambda t: t), ("fp32", lambda t: t.float())):
                    typed = tuple(cast(t) for t in args[:4]) + args[4:]
                    hold_kernel("latent_attention", deepseek.latent_attention(*typed),
                                deepseek.latent_attention_plain(*typed), f"{where} {tag}")
                if i == 1:
                    timed["latent_attention"] = (lambda a=args: deepseek.latent_attention(*a),
                                                 lambda a=args: deepseek.latent_attention_plain(*a))
            x = tower._attention(x, layer, cos, sin, keys)
            if i < dense:
                x = tower._mlp(x, layer)
                continue
            xf = x.reshape(-1, hidden)
            h = mistral.rms_norm(xf, layer.mlp_norm, cfg.rms_norm_eps)
            logits = F.linear(h.float(), layer.router)
            counts = torch.zeros(cfg.n_routed_experts, dtype=torch.int32, device=dev)
            route_args = (logits, layer.router_bias, flat_keys, k_top, cfg.routed_scaling_factor, cfg.norm_topk_prob)
            ids_k, weights, slots = deepseek.moe_route(*route_args, counts)
            chosen.append(ids_k[real].cpu())
            offsets, rows, pos = deepseek.moe_permute(ids_k, slots, counts)
            bank_gu, bank_down = tower._bank(layer, "gate_up"), tower._bank(layer, "down")
            gate, up = deepseek.grouped_gemm(h, rows, bank_gu, offsets)
            act = mistral.swiglu(gate, up)
            (y,) = deepseek.grouped_gemm(act, None, bank_down, offsets)
            shared = tower._shared_expert(h, layer)
            out = deepseek.moe_combine(y, pos, weights, shared, xf)
            if i in MOE_CHECK_LAYERS:
                plain_counts = torch.zeros_like(counts)
                ids_p, weights_p, _ = deepseek.moe_route_plain(*route_args, plain_counts)
                # a choice may differ only where the two sigmoids' last bits
                # swap two biased scores closer than 1e-6
                biased = torch.sigmoid(logits) + layer.router_bias
                kth = biased.gather(1, ids_p.long().clamp(min=0))[:, -1:]
                picked = biased.gather(1, ids_k.long().clamp(min=0))
                check(bool(((ids_k == ids_p) | (picked >= kth - 1e-6)).all()), f"moe_route {where}: choices")
                same = (ids_k == ids_p).all(1)
                hold_kernel("moe_route", weights[same], weights_p[same], where)
                check(torch.equal(counts, plain_counts) or not bool(same.all()), f"moe_route {where}: counts")
                offsets_p, rows_p, pos_p = deepseek.moe_permute_plain(ids_k, slots, counts)
                total = int(offsets_p[-1])
                check(torch.equal(offsets, offsets_p) and torch.equal(pos, pos_p)
                      and torch.equal(rows[:total], rows_p[:total]), f"moe_permute {where}")
                errs["moe_permute"].append({"at": where, "max_abs_err": 0.0, "tolerance": 0.0})
                gate_p, up_p = deepseek.grouped_gemm_plain(h, rows, bank_gu.sets, offsets)
                (y_p,) = deepseek.grouped_gemm_plain(act, None, bank_down.sets, offsets)
                for got, plain, part in ((gate, gate_p, "gate"), (up, up_p, "up"), (y, y_p, "down")):
                    hold_kernel("grouped_gemm", got[:total], plain[:total], f"{where} {part}")
                hold_kernel("moe_combine", out, deepseek.moe_combine_plain(y, pos, weights, shared, xf), where)
                if i == 1:
                    timed.update({
                        "moe_route": (lambda a=route_args: deepseek.moe_route(*a, torch.zeros_like(counts)),
                                      lambda a=route_args: deepseek.moe_route_plain(*a, torch.zeros_like(counts))),
                        "moe_permute": (lambda a=(ids_k, slots, counts): deepseek.moe_permute(*a),
                                        lambda a=(ids_k, slots, counts): deepseek.moe_permute_plain(*a)),
                        "grouped_gemm": (lambda a=(h, rows, bank_gu, offsets): deepseek.grouped_gemm(*a),
                                         lambda a=(h, rows, bank_gu.sets, offsets): deepseek.grouped_gemm_plain(*a)),
                        "moe_combine": (lambda a=(y, pos, weights, shared, xf): deepseek.moe_combine(*a),
                                        lambda a=(y, pos, weights, shared, xf): deepseek.moe_combine_plain(*a)),
                    })
                    pairs_1 = total
            x = out.view(b, length, hidden)
        stepped = mistral.rms_norm(x, tower.norm, cfg.rms_norm_eps, torch.float32)
        whole = tower(ids, mask)
        torch.cuda.synchronize()
    check(torch.equal(stepped[mask.bool()], whole[mask.bool()]), "the layers stepped by hand differ from the tower")

    # each kernel timed on layer 1's activations, against its bound
    tokens, pairs = int(real.sum()), pairs_1
    lengths = mask.sum(1).tolist()
    causal = sum(n_ * (n_ + 1) // 2 for n_ in lengths)
    e, i_moe = cfg.n_routed_experts, cfg.moe_intermediate_size
    work = {  # (bytes, operations, peak of the operations)
        "latent_attention": (2 * b * length * heads * (cfg.qk_head_dim + 3 * cfg.v_head_dim)
                             + 2 * b * length * cfg.qk_rope_head_dim + 8 * length * cfg.qk_rope_head_dim,
                             2.0 * causal * heads * (cfg.qk_head_dim + cfg.v_head_dim), rates[1]),
        "moe_route": (4 * b * length * (e + 3 * k_top) + 8 * e, 0.0, rates[1]),
        "moe_permute": (4 * b * length * k_top * 4 + 8 * e, 0.0, rates[1]),
        "grouped_gemm": (2 * (2 * e * i_moe * hidden + pairs * hidden + 2 * pairs * i_moe),
                         2.0 * 2 * pairs * i_moe * hidden, bf16_rate),
        "moe_combine": (2 * (pairs * hidden + 3 * b * length * hidden) + 8 * b * length * k_top, 0.0, rates[1]),
    }
    summary = []
    for name, kname in MOE_KERNELS.items():
        fn, plain = timed[name]
        moved, flops, peak = work[name]
        bound_ms = max(moved / rates[0], flops / peak) * 1e3
        traced = traced_kernels(fn, (kname,)).get(kname)
        row = {"name": name, "route": "cuda",
               "source": "fastforward_tpu_torch/ops/csrc/" + ("decoder.cu" if name == "latent_attention" else "moe.cu"),
               "replaces": None,  # the JAX package has no decoder tower
               "launches": launches[name], "max_abs_err": max(x["max_abs_err"] for x in errs[name]),
               "tolerance": "bf16 one step, fp32 1e-5, at the largest output; the permutation exact",
               "ms": median_ms(fn, TIMED_LAUNCHES), "back_to_back_ms": back_to_back_ms(fn, TIMED_LAUNCHES),
               "traced_ms": traced, "plain_ms": median_ms(plain, 5, warmup=1), "bytes": moved, "flops": flops,
               "bound_ms": bound_ms, "bound_by": "bytes" if moved / rates[0] >= flops / peak else "operations",
               "bound_share": None if not traced else bound_ms / traced, "library_ms": None,
               "launches_by_phase": {"moe": launches[name]}, "checks": errs[name],
               "variant": f"bf16 layer 1, {b} x {length} tokens ({tokens} real, {pairs} pairs)"}
        log(f"  {name} {row['variant']}: {row['ms']:.4f} ms ({row['back_to_back_ms']:.4f} back to back), "
            f"traced {traced} ms, bound {bound_ms:.5f} ms ({row['bound_by']}; share "
            f"{row['bound_share'] if row['bound_share'] is None else round(100 * row['bound_share'], 2)}%), "
            f"plain {row['plain_ms']:.4f} ms")
        summary.append(row)

    # the routing against the float64 reference's on the same queries, and
    # the fp8 control's: the share of (token, layer) choices of 6 that differ
    with torch.inference_mode():
        got = mistral.pool_last_token(whole, mask)
        got = (got / got.norm(dim=1, keepdim=True)).double()
    inputs = {"vocab": vocab, "seed": SEED}
    flips = {}
    ref_choices = []
    want = plugin.reference(texts[:MOE_BATCH], inputs, config, "float64", dev, choices=ref_choices)
    for label, choices, vectors in (("program", chosen, got),
                                    ("fp8 control", None, None)):
        if choices is None:
            choices = []
            vectors = plugin.reference(texts[:MOE_BATCH], inputs, config, "tf32", dev, choices=choices).double()
        differ = [(np.sort(c.numpy(), 1) != np.sort(r.numpy(), 1)).any(1) for c, r in zip(choices, ref_choices)]
        rel = ((vectors - want).norm(dim=1) / want.norm(dim=1)).cpu().numpy()
        flips[label] = {"choice_flip_share": float(np.mean(np.concatenate(differ))),
                        "tokens_flipped_somewhere": float(np.mean(np.any(np.stack(differ), 0))),
                        "qvec_rel_err_median": float(np.median(rel)), "qvec_rel_err_max": float(rel.max())}
    log(f"[moe] routing against float64 on {MOE_BATCH} queries ({tokens} tokens x {sparse} layers): "
        f"{json.dumps(flips)}")
    summary[0]["routing"] = flips
    summary[0]["call_ms"] = call_ms
    del tower, batches, timed, whole, stepped
    torch.cuda.empty_cache()
    log(f"[moe] phase 29 passed in {time.perf_counter() - t_phase:.1f} s on {smi_line()}")
    return summary


def decoder_bytes(name: str, out: torch.Tensor, cfg, batch: int, length: int) -> int:
    """Bytes one decoder kernel call must move: its inputs read once and
    its output written once (the gains, RoPE tables and mask included)."""
    tokens, es = batch * length, out.element_size()
    if name == "rms_norm":
        return 2 * tokens * cfg.hidden_size * es + 4 * cfg.hidden_size
    if name == "rope_attention":
        d = cfg.head_dim
        return (tokens * d * (2 * cfg.num_heads + 2 * cfg.num_kv_heads) * es
                + 2 * 4 * length * d + 4 * tokens)
    return 3 * tokens * cfg.intermediate_size * es


def disk_phase(corpus, qvecs, wrappers, launches) -> dict:
    """Phase 19, the round trip: a dense and a ``PQ(96, 256)``
    ``OnDiskIndex`` of the first ``DISK_N`` rows, written with ``add`` and
    opened with ``load(hbm_cache=True)``, re-rank a run of ``DISK_QUERIES``
    x ``DISK_DEPTH``: the dense index must launch K1 and the PQ index K3,
    each alone, and every score match float64 (of the decoded rows).  The
    port's own codec reads and writes the file: h5py is never imported."""
    from fastforward_tpu_torch.encoder import LambdaEncoder
    from fastforward_tpu_torch.index import Mode, OnDiskIndex
    from fastforward_tpu_torch.quantizer import PQ
    from fastforward_tpu_torch.ranking import Ranking

    tmp = Path(tempfile.mkdtemp(prefix="ff-disk-"))
    try:
        rows = corpus[:DISK_N]
        by_text = {f"query {i}": qvecs[i] for i in range(DISK_QUERIES)}
        q_index = {f"q{i}": i for i in range(DISK_QUERIES)}
        run = make_run(DISK_N, "p", DISK_QUERIES, DISK_DEPTH, SEED + 7)
        ranking = Ranking.from_run(run, queries={f"q{i}": f"query {i}" for i in range(DISK_QUERIES)})
        psg_ids = [f"p{i}" for i in range(DISK_N)]
        qvecs_dev = torch.from_numpy(qvecs[:DISK_QUERIES]).cuda()
        pq = PQ(PQ_M, PQ_KS)
        pq.fit(rows)
        out = {}
        step = DISK_N // 4
        for label, quantizer, want in (("disk_dense", None, "stream_select_pairwise"),
                                       ("disk_pq", pq, "stream_select_pq_pairwise")):
            t0 = time.perf_counter()
            path = tmp / f"{label}.h5"
            writer = OnDiskIndex(path, quantizer=quantizer, mode=Mode.PASSAGE)
            for lo in range(0, DISK_N, step):
                writer.add(rows[lo : lo + step], psg_ids=psg_ids[lo : lo + step])
            index = OnDiskIndex.load(path, LambdaEncoder(by_text.__getitem__), mode=Mode.PASSAGE,
                                     hbm_cache=True)
            reset_counts(wrappers)
            result = index(ranking)
            counts = read_counts(wrappers)
            launches[label] = counts
            check(counts[want] >= 1 and sum(counts.values()) == counts[want],
                  f"{label}: launches {counts}, want {want} alone")
            if quantizer is None:
                ref = torch.from_numpy(rows).cuda()
            else:
                codes = np.concatenate([v for v, _, _ in index._batch_iter(DISK_N)])
                ref = pq_rows(codes, pq.codewords)
            check_rerank(result, passage_exact(ref, qvecs_dev, q_index, DIM), label, DISK_QUERIES)
            out[label] = {"s": time.perf_counter() - t0, "launches": counts}
            log(f"[disk] {label}: add, load(hbm_cache=True) and re-rank in {out[label]['s']:.1f} "
                f"s; launches {counts}")
        check("h5py" not in sys.modules, "the disk round trip imported h5py")
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def write_disk_index(path: Path, rows: np.ndarray, doc_ids: list, quantizer=None) -> dict:
    """``bench.py`` config #2's write (``bench.py:728-739``): an
    ``OnDiskIndex`` in ``Mode.MAXP``, ``add`` in steps of
    ``DISK_ADD_ROWS`` rows with document ids only; returns the seconds, the
    file's GB and the rate."""
    from fastforward_tpu_torch.index import Mode, OnDiskIndex

    t0 = time.perf_counter()
    writer = OnDiskIndex(path, quantizer=quantizer, mode=Mode.MAXP)
    for lo in range(0, rows.shape[0], DISK_ADD_ROWS):
        writer.add(rows[lo : lo + DISK_ADD_ROWS], doc_ids=doc_ids[lo : lo + DISK_ADD_ROWS])
    write_s = time.perf_counter() - t0
    gb = path.stat().st_size / 1e9
    check(len(writer) == rows.shape[0], f"{path.name}: {len(writer)} rows written of {rows.shape[0]}")
    return {"write_s": write_s, "file_gb": gb, "write_gb_s": gb / write_s}


def load_disk_index(path: Path, by_text: dict, **kwargs) -> tuple:
    """``(index, seconds)`` of ``OnDiskIndex.load`` in ``Mode.MAXP`` (the id
    maps' bulk load) with the flagship queries' encoder."""
    from fastforward_tpu_torch.encoder import LambdaEncoder
    from fastforward_tpu_torch.index import Mode, OnDiskIndex

    t0 = time.perf_counter()
    index = OnDiskIndex.load(path, LambdaEncoder(by_text.__getitem__), mode=Mode.MAXP, **kwargs)
    return index, time.perf_counter() - t0


def view_upload_s(index) -> float:
    """Seconds of the first ``_device_view()``: the table read from the
    file and uploaded to the card."""
    t0 = time.perf_counter()
    index._device_view()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def check_exact_top(result, exact, queries: int, k: int, what: str) -> None:
    """Every score of the first ``queries`` queries against ``exact``
    (as ``check_rerank``), and each query's ``k`` best ids by score are the
    ``k`` best by ``exact``'s float64 scores; an id may trade places at the
    boundary only with one whose float64 score lies within the two ids'
    sum-order tolerances of it."""
    df = result._df
    check(len(df) > 0 and bool(np.isfinite(df["score"].to_numpy(np.float64)).all()),
          f"{what}: empty result or non-finite scores")
    worst, n_pairs = 0.0, 0
    by_q = df.groupby(df["q_id"].astype(str)).indices
    all_ids = df["id"].astype(str).to_numpy()
    scores = df["score"].to_numpy(np.float64)
    for qi in range(queries):
        sel = by_q[f"q{qi}"]
        ids = all_ids[sel]
        ref, tol = (t.cpu().numpy() for t in exact(f"q{qi}", ids))
        err = np.abs(scores[sel] - ref)
        check(bool((err <= tol).all()), f"{what}: q{qi} max err {err.max()} vs float64")
        worst, n_pairs = max(worst, float(err.max())), n_pairs + len(sel)
        got = set(ids[np.argsort(-scores[sel], kind="stable")[:k]])
        order = np.argsort(-ref, kind="stable")
        want = set(ids[order[:k]])
        kth = order[k - 1]
        pos = {i: j for j, i in enumerate(ids)}
        for i in got ^ want:
            j = pos[i]
            check(abs(ref[j] - ref[kth]) <= tol[j] + tol[kth],
                  f"{what}: q{qi} top-{k} holds {sorted(got)}, float64's {sorted(want)}")
    log(f"  {what}: {n_pairs} pairs of {queries} queries match float64 (max err {worst:.3e}), "
        f"their top {k} float64's")


def disk_doc_phase(corpus, doc_ids, doc_counts, doc_starts, by_text, doc_rank, exact_max, mem_maxp,
                   mem_figures, wrappers, launches) -> dict:
    """Phase 19, config #2's disk half at full width (``bench.py:689-766``):
    the MAXP document corpus (``DISK_DOC_N`` rows) written to an
    ``OnDiskIndex`` in ``add`` steps of ``DISK_ADD_ROWS`` and opened with
    ``load(hbm_cache=True)`` at phase 12's precision: a cold and
    ``WARM_CALLS`` warm re-ranks of phase 12's run must launch K1 fp32
    alone, match float64 on every query with an exact top ``DISK_TOP``,
    and equal phase 12's ``InMemoryIndex`` scores bit for bit (the same
    kernel on the same layout).  Then the file loaded with
    ``memory_mapped=True`` returns ``DISK_MMAP_IDS`` random documents'
    rows through the chunk maps (and the file reads, without them), equal
    to the corpus's; loaded with ``hbm_budget=HYBRID_BUDGET`` (the hybrid
    tier's tail read from the file), one re-rank has the same top
    ``DISK_TOP``.  ``mem_figures`` are phase 12's ``InMemoryIndex``
    figures printed beside these."""
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="ff-disk-doc-"))
    try:
        rows = corpus[:DISK_DOC_N]
        out = {"rows": DISK_DOC_N, "free_gb_before": shutil.disk_usage(tmp).free / 1e9,
               "tmp_dir": tempfile.gettempdir()}
        path = tmp / "maxp.h5"
        out.update(write_disk_index(path, rows, doc_ids[:DISK_DOC_N]))
        log(f"[disk doc] wrote {DISK_DOC_N} x {DIM} fp32 in {len(set(doc_ids[:DISK_DOC_N]))} "
            f"documents: {out['file_gb']:.3f} GB in {out['write_s']:.2f} s ({out['write_gb_s']:.3f} "
            f"GB/s) to {out['tmp_dir']} ({out['free_gb_before']:.1f} GB free before); "
            f"InMemoryIndex.add {mem_figures['add_s']:.2f} s")

        index, out["load_s"] = load_disk_index(path, by_text, hbm_cache=True, precision="high")
        out["upload_s"] = view_upload_s(index)
        check(index._device_view().kind == "dense", "the disk index's view is not a whole dense table")
        reset_counts(wrappers)
        t0 = time.perf_counter()
        cold = index(doc_rank)
        torch.cuda.synchronize()
        out["cold_ms"] = (time.perf_counter() - t0) * 1e3
        out["warm_ms"], warm = timed_calls(lambda: index(doc_rank), WARM_CALLS)
        counts = read_counts(wrappers)
        launches["disk_doc_maxp"] = counts
        check(counts["stream_select_pairwise"] == 1 + WARM_CALLS
              and sum(counts.values()) == counts["stream_select_pairwise"],
              f"disk MAXP launches {counts}, want K1 alone x {1 + WARM_CALLS}")
        check(cold == warm, "disk MAXP: cold and warm re-rank disagree")
        check(len(warm._df) == len(doc_rank._df), "disk MAXP re-rank lost pairs")
        check_exact_top(warm, exact_max, QUERIES, DISK_TOP, "disk MAXP re-rank")
        got, want = (r._df.sort_values(["q_id", "id"]) for r in (warm, mem_maxp))
        check(got[["q_id", "id"]].astype(str).equals(want[["q_id", "id"]].astype(str))
              and got["score"].to_numpy().tobytes() == want["score"].to_numpy().tobytes(),
              "disk MAXP scores differ from phase 12's InMemoryIndex bit for bit")
        log(f"[disk doc] load {out['load_s']:.2f} s (id bulk load); device view upload "
            f"{out['upload_s']:.2f} s (InMemoryIndex {mem_figures['upload_s']:.2f} s); MAXP re-rank "
            f"cold {out['cold_ms']:.1f} ms, warm median {out['warm_ms']:.2f} ms (phase 12's "
            f"InMemoryIndex {mem_figures['warm_ms']:.2f} ms), bit-equal to it; launches {counts}")
        del index, cold
        torch.cuda.empty_cache()

        rng = np.random.default_rng(SEED + 19)
        docs = rng.choice(doc_counts.shape[0], DISK_MMAP_IDS, replace=False)
        want_rows = np.concatenate([corpus[doc_starts[d] : doc_starts[d] + doc_counts[d]] for d in docs])
        ids = [f"d{d}" for d in docs]
        for label, kwargs in (("mmap", {"memory_mapped": True}), ("pread", {})):
            reader, _ = load_disk_index(path, by_text, **kwargs)
            t0 = time.perf_counter()
            vecs, _ = reader._get_vectors(ids)
            out[f"{label}_ms"] = (time.perf_counter() - t0) * 1e3
            check(np.array_equal(vecs, want_rows), f"disk {label} reads differ from the corpus")
        log(f"[disk doc] {DISK_MMAP_IDS} random documents ({want_rows.shape[0]} rows) read back "
            f"equal: through the chunk memory maps in {out['mmap_ms']:.1f} ms, by file reads in "
            f"{out['pread_ms']:.1f} ms")

        hyb, _ = load_disk_index(path, by_text, hbm_cache=True, precision="high",
                                 hbm_budget=HYBRID_BUDGET)
        out["hybrid_upload_s"] = view_upload_s(hyb)
        view = hyb._device_view()
        split = (view.tail_start, view.host_tail.shape[0]) if view.kind == "hybrid" else None
        check(split is not None and (DISK_DOC_N != N or split == HYBRID_DENSE_SPLIT[:2]),
              f"disk hybrid view {view.kind}, split {split}")
        reset_counts(wrappers)
        t0 = time.perf_counter()
        got = hyb(doc_rank)
        torch.cuda.synchronize()
        out["hybrid_ms"] = (time.perf_counter() - t0) * 1e3
        counts = read_counts(wrappers)
        launches["disk_doc_maxp_hybrid"] = counts
        check(counts["stream_select_pairwise"] >= 1
              and sum(counts.values()) == counts["stream_select_pairwise"],
              f"disk hybrid MAXP launches {counts}")
        check_same_top(got, warm, QUERIES, "disk hybrid MAXP re-rank", k=DISK_TOP)
        log(f"[disk doc] hbm_budget {HYBRID_BUDGET}: tail read from the file and view built in "
            f"{out['hybrid_upload_s']:.2f} s, split {view.tail_start} / {view.host_tail.shape[0]}; "
            f"one MAXP re-rank {out['hybrid_ms']:.1f} ms; launches {counts}")
        del hyb, view, got, warm
        torch.cuda.empty_cache()
        check("h5py" not in sys.modules, "the disk phase imported h5py")
        out["phase_s"] = time.perf_counter() - t_phase
        log(f"[disk doc] phase in {out['phase_s']:.1f} s")
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def disk_pq_phase(corpus, doc_ids, by_text, doc_rank, pq, pq_codes, exact_max, wrappers,
                  launches) -> dict:
    """Phase 19's PQ half (run after phase 13: it needs phase 9's fitted
    ``PQ(96, 256)``): the MAXP document corpus written to a PQ
    ``OnDiskIndex`` as ``disk_doc_phase`` writes it (encoded on the card
    add by add) and loaded with ``hbm_cache=True``: its codes must equal
    phase 9's, and a cold and ``WARM_CALLS`` warm MAXP re-ranks launch K4
    alone and match float64 of the decoded rows."""
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="ff-disk-pq-"))
    try:
        path = tmp / "maxp_pq.h5"
        out = write_disk_index(path, corpus[:DISK_DOC_N], doc_ids[:DISK_DOC_N], quantizer=pq)
        index, out["load_s"] = load_disk_index(path, by_text, hbm_cache=True, precision="exact")
        codes = np.concatenate([v for v, _, _ in index._batch_iter(DISK_ADD_ROWS)])
        check(np.array_equal(codes, pq_codes[:DISK_DOC_N]), "the disk PQ codes differ from phase 9's")
        out["upload_s"] = view_upload_s(index)
        reset_counts(wrappers)
        t0 = time.perf_counter()
        cold = index(doc_rank)
        torch.cuda.synchronize()
        out["cold_ms"] = (time.perf_counter() - t0) * 1e3
        out["warm_ms"], warm = timed_calls(lambda: index(doc_rank), WARM_CALLS)
        counts = read_counts(wrappers)
        launches["disk_pq_doc_maxp"] = counts
        check(counts["stream_select_pq"] == 1 + WARM_CALLS
              and sum(counts.values()) == counts["stream_select_pq"],
              f"disk PQ MAXP launches {counts}, want K4 alone x {1 + WARM_CALLS}")
        check(cold == warm, "disk PQ MAXP: cold and warm re-rank disagree")
        check_rerank(warm, exact_max, "disk PQ MAXP re-rank")
        log(f"[disk pq] PQ({PQ_M}, {PQ_KS}) MAXP: wrote {out['file_gb']:.3f} GB in "
            f"{out['write_s']:.2f} s (encoded on the card), codes equal phase 9's; load "
            f"{out['load_s']:.2f} s, upload {out['upload_s']:.2f} s; re-rank cold "
            f"{out['cold_ms']:.1f} ms, warm median {out['warm_ms']:.2f} ms; launches {counts}")
        del index, cold, warm
        check("h5py" not in sys.modules, "the disk PQ phase imported h5py")
        out["phase_s"] = time.perf_counter() - t_phase
        log(f"[disk pq] phase in {out['phase_s']:.1f} s")
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def hybrid_split(num: int, row_bytes: int, budget: int, lifetime_bytes: int = 0) -> tuple:
    """``(resident rows, tail rows, device cache bytes)`` of a hybrid view
    (``build_hybrid_view``'s arithmetic, the JAX package's): 70% of the
    budget left after ``lifetime_bytes`` (PQ codebooks) in steps of 1,024
    rows, the rest of it for the device block cache."""
    budget = max(0, budget - lifetime_bytes)
    resident = (int(budget * 0.7) // row_bytes) // 1024 * 1024
    return resident, num - resident, max(0, budget - resident * row_bytes)


def hybrid_launches_per_call(state: dict, kind: str) -> dict:
    """The launches one call of a hybrid plan makes: one for the resident
    prefix when it streams, and one per tail chunk, each to the kernel its
    layout routes to (2D fp32 tables to K1; int8 codes to K1 at ``cap <=
    r``, K2 above; PQ codes to K3 at ``cap <= r``, K4 above)."""
    narrow, wide = (
        ("stream_select_pq_pairwise", "stream_select_pq") if kind == "pq"
        else ("stream_select_pairwise", "stream_select")
    )
    res = state["res_plan"].get("stream_pq" if kind == "pq" else "stream")
    out: dict = {}
    for cand in ([res[0]] if res is not None else []) + [c["cand"] for c in state["chunks"]]:
        name = wide if kind != "dense" and cand.shape[1] * 128 > 512 else narrow
        out[name] = out.get(name, 0) + 1
    return out


def hybrid_calls(index, ranking, warm: int) -> tuple:
    """A cold and ``warm`` warm re-ranks of a hybrid index; returns ``(cold
    ms, median warm ms, cold result, last result, the tier's counters of
    each call)``."""
    from fastforward_tpu_torch.ops import host_stream

    times, stats, results = [], [], []
    for _ in range(1 + warm):
        host_stream.reset_stats()
        t0 = time.perf_counter()
        results.append(index(ranking))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        stats.append(dict(host_stream.STATS))
    return times[0], float(np.median(times[1:])), results[0], results[-1], stats


def check_cache_use(view, state, stats: list, what: str) -> dict:
    """Warm calls copy exactly the tail blocks the device cache does not
    hold, and hit the ones it does; returns the counts."""
    from fastforward_tpu_torch.ops import host_stream

    blocks = view.aux.get("tail_blocks", {})
    keys = [host_stream._block_cache_key(c, view.table.dtype) for c in state["chunks"]]
    cached = sum(k in blocks for k in keys)
    for i, st in enumerate(stats[1:], 1):
        check(st["uploads"] == len(keys) - cached and st["block_cache_hits"] == cached,
              f"{what}: warm call {i} copied {st['uploads']} and hit {st['block_cache_hits']} "
              f"of {len(keys)} blocks, {cached} of them cached")
    return {"chunks": len(keys), "cached": cached, "cold": stats[0], "warm": stats[-1]}


def staged_block(view, state) -> tuple:
    """``(device block, chunk)`` of the first tail chunk of ``state`` whose
    staged block is in the view's device cache."""
    from fastforward_tpu_torch.ops import host_stream

    blocks = view.aux["tail_blocks"]
    for chunk in state["chunks"]:
        ent = blocks.get(host_stream._block_cache_key(chunk, view.table.dtype))
        if ent is not None:
            return ent[0], chunk
    raise SmokeFailure("no staged tail block in the device cache")


def check_same_top(got, want, queries: int, what: str, k: "int | None" = None) -> None:
    """The first ``queries`` queries' ids (their top ``k`` by score, or all)
    against another index's, as sets (tied scores may order differently),
    scores within rtol 1e-5 and atol 1e-5."""
    g, w = got._df, want._df
    g_by, w_by = (df.groupby(df["q_id"].astype(str)).indices for df in (g, w))
    for qi in range(queries):
        gq, wq = g.iloc[g_by.get(f"q{qi}", [])], w.iloc[w_by.get(f"q{qi}", [])]
        if k is not None:
            gq, wq = gq.nlargest(k, "score"), wq.nlargest(k, "score")
        gs = dict(zip(gq["id"].astype(str), gq["score"]))
        ws = dict(zip(wq["id"].astype(str), wq["score"]))
        check(gs.keys() == ws.keys(), f"{what}: q{qi} ids {sorted(gs)} vs {sorted(ws)}")
        check(all(abs(gs[k] - ws[k]) <= 1e-5 + 1e-5 * abs(ws[k]) for k in ws),
              f"{what}: q{qi} scores differ")
    log(f"  {what}: the top of {queries} queries equals the whole-table index's")


def tail_copy_rates(view) -> dict:
    """Host-to-card GB/s of tail blocks copied as the hybrid tier copies them
    (``host_stream._TailCopier``, blocks of ``view.chunk_rows`` rows on its
    copy stream), ``RATE_BLOCKS`` blocks each: contiguous runs of the tail
    and scattered rows gathered, each through the pinned staging buffers;
    beside them the link from pinned memory (one staging-sized pinned block
    copied ``RATE_BLOCKS`` times, no host copy) and what page-locking the
    tail in place would cost (``cudaHostRegister``, timed and undone)."""
    from fastforward_tpu_torch.ops import host_stream

    tail, rows = view.host_tail, view.chunk_rows
    n = min(RATE_BLOCKS, tail.shape[0] // rows)
    picked = np.sort(np.random.default_rng(SEED + 9).choice(tail.shape[0], n * rows, replace=False))
    variants = {
        "staged_contiguous": [np.arange(i * rows, (i + 1) * rows, dtype=np.int64) for i in range(n)],
        "gathered": [picked[i * rows : (i + 1) * rows] for i in range(n)],
    }
    copier = host_stream._TailCopier(tail, view.aux, rows, view.table.dtype, view.table.shape[1:],
                                     view.table.device)
    nbytes = n * rows * copier.row_bytes
    out = {}
    for name, row_sets in variants.items():
        # a full plan budget: no host copy is kept, every block is staged anew
        acct = {"host_cached_bytes": host_stream.HOST_BLOCK_CACHE_BUDGET}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for row_set in row_sets:
            src, staged = copier.source({"rows": row_set, "block_rows": rows}, acct)
            copier.to_device(src, staged, rows)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        out[name] = {"gb_s": nbytes / dt / 1e9, "bytes": nbytes, "s": dt}
    pinned = torch.empty((rows, tail.shape[1]), dtype=copier.tail.dtype, pin_memory=True)
    pinned.copy_(copier.tail[:rows])
    block = torch.empty(pinned.shape, dtype=pinned.dtype, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        block.copy_(pinned, non_blocking=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out["pinned_source"] = {"gb_s": nbytes / dt / 1e9, "bytes": nbytes, "s": dt}
    cudart = torch.cuda.cudart()
    t0 = time.perf_counter()
    err = cudart.cudaHostRegister(tail.ctypes.data, tail.nbytes, 0)
    out["register_tail_s"] = time.perf_counter() - t0
    check(err == cudart.cudaError.success, f"cudaHostRegister of the tail failed: {err}")
    cudart.cudaHostUnregister(tail.ctypes.data)
    return out


def pcie_line() -> str:
    """The host link's current and maximum generation and width as
    ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=pcie.link.gen.current,pcie.link.width.current,"
         "pcie.link.gen.max,pcie.link.width.max", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"


def hybrid_dense_phase(corpus, doc_ids, psg_ids, by_text, ranking, doc_rank, run, queries, index,
                       exact_p, exact_doc, wrappers, launches, rates, held) -> dict:
    """Phase 20: the flagship fp32 corpus behind ``hbm_budget=2 GiB``: the
    split, cold and warm passage re-ranks and serve, MAXP (ragged layout)
    and early stopping, each checked against float64 and the whole-table
    index; K1 and K2 held against their plain versions on one staged tail
    block; the host-to-card copy rates of tail blocks."""
    from fastforward_tpu_torch import InMemoryIndex, Mode, Ranking
    from fastforward_tpu_torch.encoder import LambdaEncoder
    from fastforward_tpu_torch.ops import stream_kernel as sk

    t0 = time.perf_counter()
    hyb = InMemoryIndex(query_encoder=LambdaEncoder(by_text.__getitem__), mode=Mode.PASSAGE,
                        precision="high", hbm_budget=HYBRID_BUDGET)
    hyb.add(corpus, doc_ids=doc_ids, psg_ids=psg_ids)
    add_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    view = hyb._device_view()
    torch.cuda.synchronize()
    view_s = time.perf_counter() - t0
    want = hybrid_split(N, DIM * 4, HYBRID_BUDGET)
    got = (view.tail_start, view.host_tail.shape[0], view.tail_cache_budget)
    check(view.kind == "hybrid" and got == want == HYBRID_DENSE_SPLIT,
          f"hybrid split {got}, want {want} and {HYBRID_DENSE_SPLIT}")
    block_bytes = view.chunk_rows * DIM * 4
    split = {"resident_rows": got[0], "resident_gb": got[0] * DIM * 4 / 1e9, "tail_rows": got[1],
             "tail_gb": got[1] * DIM * 4 / 1e9, "cache_bytes": got[2],
             "cache_blocks": got[2] // block_bytes, "block_rows": view.chunk_rows,
             "block_mb": block_bytes / 1e6, "add_s": add_s, "view_s": view_s}
    log(f"[hybrid] {N} x {DIM} fp32 at hbm_budget {HYBRID_BUDGET} B: {json.dumps(split)}")
    flows = {"hybrid_split": split}

    reset_counts(wrappers)
    cold_ms, warm_ms, cold, warm, stats = hybrid_calls(hyb, ranking, WARM_CALLS)
    state = hyb._get_plan(ranking)["hybrid"]
    cache = check_cache_use(view, state, stats, "hybrid re-rank")
    check(cold == warm, "hybrid: cold and warm re-rank disagree")
    check_rerank(warm, exact_p, "hybrid re-rank")
    t0 = time.perf_counter()
    hyb.serve(ranking, ALPHA, CUTOFF)
    torch.cuda.synchronize()
    serve_first_ms = (time.perf_counter() - t0) * 1e3
    serve_ms, served = timed_calls(lambda: hyb.serve(ranking, ALPHA, CUTOFF), WARM_CALLS)
    counts = read_counts(wrappers)
    per_call = hybrid_launches_per_call(state, "dense")
    calls = 2 * (1 + WARM_CALLS)
    check(counts == {k: per_call.get(k, 0) * calls for k in counts},
          f"hybrid passage launches {counts}, want {per_call} x {calls}")
    launches["hybrid_dense"] = counts
    check_serve(served, run, exact_p, "hybrid serve")
    check_same_top(served, index.serve(ranking, ALPHA, CUTOFF), CHECK_QUERIES, "hybrid serve")
    flows["hybrid_rerank"] = {"cold_ms": cold_ms, "warm_ms": warm_ms, "qps": QUERIES / warm_ms * 1e3,
                              "cache": cache, "launches_per_call": per_call}
    flows["hybrid_serve"] = {"first_ms": serve_first_ms, "warm_ms": serve_ms,
                             "qps": QUERIES / serve_ms * 1e3}
    log(f"[hybrid] re-rank cold {cold_ms:.1f} ms, warm median {warm_ms:.2f} ms; serve first "
        f"{serve_first_ms:.1f} ms, warm median {serve_ms:.2f} ms; {cache['chunks']} tail blocks, "
        f"{cache['cached']} cached; launches {counts}; the tier's counters by call "
        f"{json.dumps(stats)}")
    flows["hybrid_rerank"]["profile"] = profile_flow(lambda: hyb(ranking), CALL_KERNELS["pairwise"])
    log("[profile hybrid_rerank]", json.dumps(flows["hybrid_rerank"]["profile"]))

    # K1 and K2 (the fp32 block as 3D, K2's entry) on one staged tail block,
    # each call split by kernel
    hybrid_tail_rows(sk, view, state, rates, held, "fp32 tail block", k2=True)

    hyb.mode = Mode.MAXP
    reset_counts(wrappers)
    cold_ms, warm_ms, cold, warm, stats = hybrid_calls(hyb, doc_rank, WARM_CALLS)
    state = hyb._get_plan(doc_rank)["hybrid"]
    n_pairs = len(doc_rank._df)
    check(all(st["fetch_floats"] == 2 * n_pairs for st in stats),
          f"hybrid MAXP fetched {[st['fetch_floats'] for st in stats]} floats, want 2 x {n_pairs}")
    cache = check_cache_use(view, state, stats, "hybrid MAXP re-rank")
    check(cold == warm, "hybrid MAXP: cold and warm re-rank disagree")
    check_rerank(warm, exact_doc["MAXP"], "hybrid MAXP re-rank")
    counts = read_counts(wrappers)
    per_call = hybrid_launches_per_call(state, "dense")
    check(counts == {k: per_call.get(k, 0) * (1 + WARM_CALLS) for k in counts},
          f"hybrid MAXP launches {counts}, want {per_call} x {1 + WARM_CALLS}")
    launches["hybrid_dense_maxp"] = counts
    flows["hybrid_doc_maxp_rerank"] = {"cold_ms": cold_ms, "warm_ms": warm_ms,
                                       "qps": QUERIES / warm_ms * 1e3, "cache": cache,
                                       "rows": int(state["res_pos"].shape[0] + state["p_tail"]),
                                       "pairs": n_pairs, "launches_per_call": per_call}
    log(f"[hybrid MAXP] cold {cold_ms:.1f} ms, warm median {warm_ms:.2f} ms; "
        f"{flows['hybrid_doc_maxp_rerank']['rows']} rows of {n_pairs} pairs; {cache['chunks']} tail "
        f"blocks, {cache['cached']} cached; the tier's counters by call {json.dumps(stats)}")
    hybrid_tail_rows(sk, view, state, rates, held, "fp32 MAXP tail block", k2=False)

    hyb.mode = Mode.PASSAGE
    reset_counts(wrappers)
    t0 = time.perf_counter()
    es = hyb(Ranking.from_run(run, queries=queries), **ES_KWARGS)
    torch.cuda.synchronize()
    es_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts(wrappers)
    check(counts["stream_select_pairwise"] >= 1 and sum(counts.values()) == counts["stream_select_pairwise"],
          f"hybrid early stopping launches {counts}")
    launches["hybrid_dense_es"] = counts
    check_rerank(es, exact_p, "hybrid early stopping", queries=QUERIES)
    whole_es = index(Ranking.from_run(run, queries=queries), **ES_KWARGS)
    check_same_top(es, whole_es, CHECK_QUERIES, "hybrid early stopping", k=CUTOFF)
    flows["hybrid_es_cold"] = {"cold_ms": es_ms, "rows_scored": len(es._df)}
    log(f"[hybrid ES] {len(es._df)} rows scored in {es_ms:.1f} ms; launches {counts}")

    link = pcie_line()
    copy = tail_copy_rates(view)
    flows["hybrid_tail_copy"] = {"link": link, **copy}
    log(f"[hybrid] tail block copies to the card ({link} gen/width current, max): {json.dumps(copy)}")
    del hyb, view, state, es, whole_es, cold, warm, served
    torch.cuda.empty_cache()
    return flows


def hybrid_tail_rows(sk, view, state, rates, held, label, k2) -> None:
    """K1 (and, ``k2``, K2 on the block viewed 3D) against its plain version
    on one staged fp32 tail block of ``state``'s plan, with its splits or
    routes, timed and one call split by kernel."""
    block, chunk = staged_block(view, state)
    q_dev = state["res_plan"]["q_dev"][1]
    cand3, tile = chunk["cand"], chunk["tile"]
    log(f"[hybrid] K1{' and K2' if k2 else ''} vs plain on a staged tail block "
        f"{tuple(block.shape)}, layout {tuple(cand3.shape)}")
    row = pairwise_variants(sk, block, q_dev, cand3, tile, DIM, ("exact",), True, rates, label)[0]
    split_call(row, lambda: sk.stream_select_pairwise(block, q_dev, cand3, tile), CALL_KERNELS["pairwise"])
    held["stream_select_pairwise"].append(row)
    if k2:
        block3 = block.view(block.shape[0], DIM // 128, 128)
        row = select_variants(sk, block3, q_dev, cand3, tile, DIM, ("high",), True, rates, label)[0]
        split_call(row, lambda: sk.stream_select(block3, q_dev.t(), cand3, tile, precision="high"),
                   CALL_KERNELS["dense"])
        held["stream_select"].append(row)


def hybrid_quantized_phase(label, kind, source, budget, lifetime_bytes, rankings, exacts, wrappers,
                           launches, rates, held, doc_ids, psg_ids, by_text) -> dict:
    """Phase 21 for one quantized index of phases 7 or 9: the same codes
    behind ``budget``; a passage and a MAXP re-rank (a cold and warm ones),
    checked against float64 of the decoded rows as phases 7 and 9 check
    them; the kernels held against their plain versions on one staged tail
    block."""
    from fastforward_tpu_torch import convert
    from fastforward_tpu_torch.encoder import LambdaEncoder
    from fastforward_tpu_torch.index import Mode
    from fastforward_tpu_torch.ops import stream_kernel as sk
    from fastforward_tpu_torch.ops import stream_kernel_pq as skpq

    t0 = time.perf_counter()
    hyb = convert.index_from_codes(
        source._store[:N], doc_ids, psg_ids, "PASSAGE", source.quantizer,
        query_encoder=LambdaEncoder(by_text.__getitem__), precision=source._precision,
        hbm_budget=budget, init_size=N,
    )
    view = hyb._device_view()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    width = source._store.shape[1] * source._store.dtype.itemsize  # bytes a row
    want = hybrid_split(N, width, budget, lifetime_bytes)
    got = (view.tail_start, view.host_tail.shape[0], view.tail_cache_budget)
    check(view.kind == "hybrid" and view.hybrid_kind == kind and got == want,
          f"{label} split {got}, want {want}")
    flows = {f"{label}_split": {"resident_rows": got[0], "tail_rows": got[1], "cache_bytes": got[2],
                                "row_bytes": width, "build_s": build_s}}
    log(f"[{label}] {N} rows of {width} B codes at hbm_budget {budget} B: "
        f"{json.dumps(flows[f'{label}_split'])}")
    for mode, ranking, exact in zip(("PASSAGE", "MAXP"), rankings, exacts):
        hyb.mode = Mode[mode]
        reset_counts(wrappers)
        cold_ms, warm_ms, cold, warm, stats = hybrid_calls(hyb, ranking, WARM_CALLS)
        state = hyb._get_plan(ranking)["hybrid"]
        cache = check_cache_use(view, state, stats, f"{label} {mode}")
        check(cold == warm, f"{label} {mode}: cold and warm re-rank disagree")
        check_rerank(warm, exact, f"{label} {mode} re-rank")
        if mode == "MAXP":
            check(all(st["fetch_floats"] == 2 * len(ranking._df) for st in stats),
                  f"{label} MAXP fetched {[st['fetch_floats'] for st in stats]} floats")
        counts = read_counts(wrappers)
        per_call = hybrid_launches_per_call(state, kind)
        check(counts == {k: per_call.get(k, 0) * (1 + WARM_CALLS) for k in counts},
              f"{label} {mode} launches {counts}, want {per_call} x {1 + WARM_CALLS}")
        key = f"{label}_{mode.lower()}"
        launches[key] = counts
        flows[f"{key}_rerank"] = {"cold_ms": cold_ms, "warm_ms": warm_ms, "qps": QUERIES / warm_ms * 1e3,
                                  "cache": cache, "launches_per_call": per_call}
        log(f"[{label} {mode}] cold {cold_ms:.1f} ms, warm median {warm_ms:.2f} ms; "
            f"{cache['chunks']} tail blocks, {cache['cached']} cached; launches {counts}; the "
            f"tier's counters by call {json.dumps(stats)}")
        if mode == "PASSAGE":
            block, chunk = staged_block(view, state)
            q_dev = state["res_plan"]["q_dev"][1]
            log(f"[{label}] kernels vs plain on a staged tail block {tuple(block.shape)}, layout "
                f"{tuple(chunk['cand'].shape)}")
            if kind == "pq":  # timed, one call traced by kernel (the route split's cost)
                for kernel, kname, q_arg in (("K3", "stream_select_pq_pairwise", q_dev),
                                             ("K4", "stream_select_pq", q_dev.t())):
                    row = pq_variants(skpq, kernel, block, view.codebooks, q_dev, chunk["cand"],
                                      chunk["tile"], ("exact",), True, rates,
                                      f"{label.removeprefix('hybrid_')} tail block")[0]
                    call = getattr(skpq, kname)
                    split_call(row, lambda call=call, q=q_arg: call(
                        block, view.codebooks, q, chunk["cand"], chunk["tile"]), CALL_KERNELS["adc"])
                    held[kname].append(row)
            else:
                row = select_variants(sk, block, q_dev, chunk["cand"], chunk["tile"], DIM, ("high",),
                                      True, rates, "int8 tail block")[0]
                split_call(row, lambda: sk.stream_select(block, q_dev.t(), chunk["cand"], chunk["tile"],
                                                         precision="high"), CALL_KERNELS["dense"])
                held["stream_select"].append(row)
            del block, chunk
    del hyb, view
    torch.cuda.empty_cache()
    return flows


def device_store_phase(corpus, doc_ids, psg_ids, by_text, ranking, index, wrappers, launches) -> dict:
    """Phase 22: the flagship corpus added into ``store="device"`` in adds of
    ``DEVICE_ADD_ROWS`` rows (rows/s); the re-rank and ``serve(refine=22)``
    equal the whole-table index's; 4,096 rows read back bit for bit."""
    from fastforward_tpu_torch import InMemoryIndex, Mode
    from fastforward_tpu_torch.encoder import LambdaEncoder

    dev = InMemoryIndex(query_encoder=LambdaEncoder(by_text.__getitem__), mode=Mode.PASSAGE,
                        precision="high", store="device", init_size=N)
    n_adds = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lo in range(0, N, DEVICE_ADD_ROWS):
        hi = min(lo + DEVICE_ADD_ROWS, N)
        dev.add(corpus[lo:hi], doc_ids=doc_ids[lo:hi], psg_ids=psg_ids[lo:hi])
        n_adds += 1
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    check(dev._store is None and dev._dev_table.device.type == "cuda",
          "the device store kept a host copy")
    reset_counts(wrappers)
    got = dev(ranking)
    torch.cuda.synchronize()
    served = dev.serve(ranking, ALPHA, CUTOFF, refine=REFINE)
    counts = read_counts(wrappers)
    check(counts["stream_select_pairwise"] == 2 and sum(counts.values()) == 2,
          f"device store launches {counts}")
    launches["device_store"] = counts
    check_same_served([got, served], [index(ranking), index.serve(ranking, ALPHA, CUTOFF, refine=REFINE)],
                      "device store re-rank and serve(refine) against the whole-table index")
    rows = np.sort(np.random.default_rng(SEED + 8).choice(N, 4096, replace=False))
    vecs, ids = dev._get_vectors([psg_ids[r] for r in rows])
    check(ids == [psg_ids[r] for r in rows] and np.array_equal(vecs, corpus[rows]),
          "device store rows read back differ from the host rows")
    out = {"adds": n_adds, "rows_per_add": DEVICE_ADD_ROWS, "add_s": add_s, "rows_per_s": N / add_s}
    log(f"[device store] {N} rows in {n_adds} adds: {add_s:.2f} s, {out['rows_per_s']:.0f} rows/s; "
        f"re-rank and serve(refine) equal the whole-table index; 4,096 rows read back bit for bit")
    del dev
    torch.cuda.empty_cache()
    return out


def progressive_phase(corpus, doc_ids, psg_ids, by_text, ranking, run, index, corpus_dev, qvecs_dev,
                      q_index, wrappers, launches, standard_upload_s) -> dict:
    """Phase 23: ``preload(warm, serve, progressive=True)`` of a fresh
    flagship fp32 index: the truncated table serves at once (a serve
    checked against float64 of whichever table it saw), ``preload_join``
    installs the exact table, whose re-rank equals the whole-table index's;
    the time to each table beside phase 15's standard upload."""
    from fastforward_tpu_torch import InMemoryIndex, Mode
    from fastforward_tpu_torch.encoder import LambdaEncoder

    prog = InMemoryIndex(query_encoder=LambdaEncoder(by_text.__getitem__), mode=Mode.PASSAGE,
                         precision="high")
    prog.add(corpus, doc_ids=doc_ids, psg_ids=psg_ids)
    reset_counts(wrappers)
    t0 = time.perf_counter()
    ok = prog.preload(warm=(QUERIES, DEPTH), serve=(ALPHA, CUTOFF, REFINE), progressive=True)
    preload_s = time.perf_counter() - t0
    stats = dict(prog._preload_stats)
    check(ok is True and stats.get("progressive") is True, f"progressive preload: {ok}, {stats}")
    interim_s = stats["upload_s"] + stats["activate_s"]
    for _ in range(3):  # a serve that saw one table throughout
        view = prog._device_view()
        exact_before = "progressive_exact" in prog._preload_stats
        served = prog.serve(ranking, ALPHA, CUTOFF)
        torch.cuda.synchronize()
        if prog._device_view() is view:
            break
    else:
        raise SmokeFailure("the view changed under three serves in a row")
    saw = "exact" if exact_before else "interim"
    if saw == "interim":
        trunc = (corpus_dev.view(torch.int32) & -65536).view(torch.float32)
        check_serve(served, run, passage_exact(trunc, qvecs_dev, q_index, DIM),
                    "progressive serve on the interim table")
        del trunc
    else:
        check_serve(served, run, passage_exact(corpus_dev, qvecs_dev, q_index, DIM),
                    "progressive serve on the exact table")
    joined = prog.preload_join(timeout=PROGRESSIVE_JOIN_S)
    exact_s = time.perf_counter() - t0
    check(joined and prog._preload_stats.get("progressive_exact") is True,
          f"preload_join {joined}, stats {prog._preload_stats}")
    table = prog._device_view().table
    check(bool(torch.equal(table[:N], corpus_dev)), "the exact table differs from the corpus")
    got = prog(ranking)
    counts = read_counts(wrappers)
    check(counts["stream_select_pairwise"] >= 4 and sum(counts.values()) == counts["stream_select_pairwise"],
          f"progressive launches {counts}")
    launches["progressive"] = counts
    check_same_served([got], [index(ranking)], "progressive re-rank after preload_join")
    out = {"preload_s": preload_s, "interim_s": interim_s, "exact_s": exact_s,
           "standard_upload_s": standard_upload_s, "serve_saw": saw, "stats": stats}
    log(f"[progressive] interim table after {interim_s:.2f} s (hi planes {stats['upload_s']:.2f} s, "
        f"expand {stats['activate_s']:.2f} s), exact table after {exact_s:.2f} s, preload returned "
        f"after {preload_s:.2f} s; phase 15's standard upload_s {standard_upload_s:.2f} s; the serve "
        f"right after it saw the {saw} table")
    del prog, table
    torch.cuda.empty_cache()
    return out


def pq_wide_phase(corpus, doc_ids, psg_ids, by_text, ranking, doc_rank, run, doc_run, q_index,
                  qvecs_dev, doc_counts, doc_starts, wrappers, launches, rates, held) -> dict:
    """Phase 24: ``PQ(96, 1024)`` (10-bit codes, stored as uint16) on the
    flagship corpus: fitted on the card on the first 2^16 vectors, 4,096
    codes against a CPU encode; the passage re-rank and serve launch K3,
    MAXP launches K4, each checked against float64 ``q . decode(codes)``;
    K3 and K4 held against their plain versions on these layouts (timed,
    one traced call, back to back) and on one small layout of random
    ``PQ_GLOBAL_SHAPE`` codebooks (the global-memory table body); then the
    hybrid tier over the same codes (2-byte code rows in the tail's
    blocks)."""
    from fastforward_tpu_torch import InMemoryIndex, Mode
    from fastforward_tpu_torch.encoder import LambdaEncoder
    from fastforward_tpu_torch.ops import stream_kernel_pq as skpq
    from fastforward_tpu_torch.quantizer import PQ

    t0 = time.perf_counter()
    pq = PQ(PQ_M, PQ_WIDE_KS)
    pq.fit(corpus[:QUANT_FIT])
    fit_s = time.perf_counter() - t0
    index = InMemoryIndex(
        query_encoder=LambdaEncoder(by_text.__getitem__), quantizer=pq, mode=Mode.PASSAGE,
        precision="exact", init_size=N,
    )
    add_in_chunks(index, corpus, psg_ids, doc_ids)
    codes = index._store[:N]
    encode_s = time.perf_counter() - t0 - fit_s
    check(codes.dtype == np.uint16 and int(codes.max()) >= 256,
          f"PQ({PQ_M}, {PQ_WIDE_KS}) codes are {codes.dtype}, largest {int(codes.max())}")
    log(f"[setup] PQ({PQ_M}, {PQ_WIDE_KS}) fitted on the card in {fit_s:.1f} s; {N} rows encoded "
        f"in {encode_s:.1f} s ({codes.dtype}, {int(np.unique(codes[:4096]).shape[0])} distinct "
        "codes in the first 4,096 rows)")
    flows = {"pq1024_setup": {"fit_s": fit_s, "encode_s": encode_s,
                              "encode_agree": check_encode("PQ(96, 1024)", pq, codes, corpus)}}
    ref = pq_rows(codes, pq.codewords)
    exact_psg = passage_exact(ref, qvecs_dev, q_index, DIM)
    exact_max = doc_exact(ref, qvecs_dev, q_index, doc_counts, doc_starts, "max", DIM)
    phase, launches["pq1024"] = index_phase(
        "pq1024", index, ranking, wrappers, want="stream_select_pq_pairwise",
        forbid=("stream_select_pq",), kernels=CALL_KERNELS["adc"], exact=exact_psg, run=run,
    )
    flows.update(phase)
    view = index._device_view()
    check(view.table.dtype == torch.uint16, f"the PQ(96, 1024) table is {view.table.dtype}")
    plan = index._get_plan(ranking)
    k3_in = (view.table, view.codebooks, plan["q_dev"][1], *plan["stream_pq"][:2])
    index.mode = Mode.MAXP
    phase, launches["pq1024_doc_maxp"] = index_phase(
        "pq1024_doc_maxp", index, doc_rank, wrappers, want="stream_select_pq",
        forbid=("stream_select_pq_pairwise",), kernels=CALL_KERNELS["adc"], exact=exact_max,
        run=doc_run,
    )
    flows.update(phase)
    doc_plan = index._get_plan(doc_rank)
    k4_in = (view.table, view.codebooks, doc_plan["q_dev"][1], *doc_plan["stream_pq"][:2])
    log(f"[kernel-pq1024] K3 on {tuple(k3_in[3].shape)}, K4 on {tuple(k4_in[3].shape)} "
        f"(uint16 codes, {skpq.adc_table_width(PQ_WIDE_KS, torch.uint16)}-entry tables, "
        f"{skpq.adc_table_queries(k3_in[2].shape[0], PQ_M, PQ_WIDE_KS)} queries a table group)")
    for kernel, kname, inputs, label in (("K3", "stream_select_pq_pairwise", k3_in, "pq1024"),
                                         ("K4", "stream_select_pq", k4_in, "pq1024 doc")):
        row = pq_variants(skpq, kernel, *inputs, ("exact",), True, rates, label)[0]
        c, cb, q, cand, tile = inputs
        call = getattr(skpq, kname)
        split_call(row, lambda call=call, c=c, cb=cb, q=q if kernel == "K3" else q.t(), cand=cand,
                   tile=tile: call(c, cb, q, cand, tile), CALL_KERNELS["adc"])
        held[kname].append(row)
    m, ks = PQ_GLOBAL_SHAPE
    rng = np.random.default_rng(SEED + 7)
    n_pad, r = 4096, skpq.KERNEL_PQ_TILE_ROWS
    codes_g = torch.from_numpy(rng.integers(0, ks, size=(n_pad, m)).astype(np.uint16)).cuda()
    cb_g = torch.from_numpy(rng.standard_normal((m, ks, DIM // m), dtype=np.float32)).cuda()
    q_g = torch.from_numpy(rng.standard_normal((64, DIM), dtype=np.float32)).cuda()
    log(f"[kernel-pq-global] K3 and K4 on random PQ({m}, {ks}) codebooks: one subspace's table is "
        f"{ks * 4} B, past the {96 * 1024} B a block stages (the global-memory table body)")
    for kernel, kname, cap in (("K3", "stream_select_pq_pairwise", 512), ("K4", "stream_select_pq", 1024)):
        lay = small_case_layout(rng, n_pad, 64, "uniform", kernel, cap, r)
        held[kname] += pq_variants(skpq, kernel, codes_g, cb_g, q_g, *lay, ("exact",), True, rates,
                                   f"pq({m},{ks}) global table")
    del codes_g, cb_g
    index.mode = Mode.PASSAGE
    flows.update(hybrid_quantized_phase(
        "hybrid_pq1024", "pq", index, HYBRID_PQ_WIDE_BUDGET, view.codebooks.numel() * 4,
        (ranking, doc_rank), (exact_psg, exact_max), wrappers, launches, rates, held, doc_ids,
        psg_ids, by_text,
    ))
    del index, view, ref
    torch.cuda.empty_cache()
    return flows


def pairs_exact(rows_ref, q_dev, rows_mat, counts, qno, op: str, dim: int):
    """Float64 scores of the pairs of the first ``CHECK_QUERIES`` queries of
    a ``(pairs, K)`` layout (``op`` ``max`` over each pair's ``counts`` rows,
    or ``first``), their sum-order tolerance, and the pairs' positions, on
    the card."""
    sel = np.flatnonzero(np.asarray(qno) < CHECK_QUERIES)
    rows_mat, counts, qno = rows_mat[sel], np.asarray(counts)[sel], np.asarray(qno)[sel]
    rows_t = torch.from_numpy(np.ascontiguousarray(rows_mat, dtype=np.int64)).cuda()
    k = rows_t.shape[1]
    q_rows = q_dev[torch.from_numpy(np.asarray(qno, dtype=np.int64)).cuda()].double()
    prods = rows_ref[rows_t.reshape(-1)].double().view(rows_t.shape[0], k, -1) * q_rows[:, None, :]
    dots, tol = prods.sum(-1), sum_order_tol(prods.abs().sum(-1), dim)
    if op == "first" or k == 1:
        return dots[:, 0], tol[:, 0], sel
    valid = torch.arange(k, device="cuda")[None, :] < torch.from_numpy(counts).cuda()[:, None]
    return (torch.where(valid, dots, -torch.inf).amax(1),
            torch.where(valid, tol, 0.0).amax(1), sel)


def check_pairs(got: np.ndarray, ref_tol_sel, what) -> float:
    """The checked pairs' scores against their float64 reference and
    tolerance (``pairs_exact``)."""
    ref, tol, sel = ref_tol_sel
    check(len(sel) > 0 and bool(np.isfinite(got).all()), f"{what}: no checked pairs, or non-finite scores")
    err = (torch.from_numpy(np.asarray(got, dtype=np.float64)[sel]).cuda() - ref).abs()
    check(bool((err <= tol).all()), f"{what}: max err {err.max().item():.3e} against float64")
    return err.max().item()


def sharded_phase(index, pq_index, ranking, doc_rank, sparse, corpus, corpus_dev, qvecs_dev,
                  wrappers, launches, rates) -> dict:
    """Phase 25: sharded scoring on the card in one process, two shards on
    ``cuda:0`` (``MeshConfig(data=1, shard=2).build(devices=[cuda:0,
    cuda:0])``): ``streamed_scores_sharded`` on the flagship fp32 table
    split in two with the flagship run's rows (K1 once per shard) and with
    phase 12's MAXP layout and its K-reduce; ``score_pairs_sharded`` on the
    3,200-pair sparse run (no kernel); ``streamed_scores_sharded_pq`` on
    phase 9's PQ codes (K3 once per shard); each against the single-table
    program and float64, and timed beside it (CUDA events)."""
    from fastforward_tpu_torch import Mode
    from fastforward_tpu_torch.ops import scoring
    from fastforward_tpu_torch.parallel import MeshConfig, multihost, sharded

    mesh = MeshConfig(data=1, shard=2).build(devices=["cuda:0", "cuda:0"])
    view = index._device_view()
    n_pad = view.table.shape[0]
    t0 = time.perf_counter()
    table = multihost.put_row_sharded(mesh, corpus, shape=(n_pad, DIM))
    torch.cuda.synchronize()
    flows = {"sharded_setup": {"upload_s": time.perf_counter() - t0, "n_local": table.n_local}}
    log(f"[sharded] {mesh}; the flagship table in 2 shards of {table.n_local} rows, uploaded in "
        f"{flows['sharded_setup']['upload_s']:.2f} s")

    def run_sharded(label, fn, single, want_counts, ref_tol):
        reset_counts(wrappers)
        got = fn()
        torch.cuda.synchronize()
        counts = read_counts(wrappers)
        launches[f"sharded_{label}"] = counts
        check(counts == {k: want_counts.get(k, 0) for k in counts},
              f"sharded {label} launches {counts}, want {want_counts}")
        want = single()
        torch.cuda.synchronize()
        err_single = float(np.abs(np.asarray(scoring.fetch_np(got), dtype=np.float64)
                                  - np.asarray(scoring.fetch_np(want), dtype=np.float64)).max())
        err = check_pairs(np.asarray(scoring.fetch_np(got)), ref_tol, f"sharded {label}")
        flows[f"sharded_{label}"] = {
            "ms": median_ms(fn, WARM_CALLS), "single_table_ms": median_ms(single, WARM_CALLS),
            "launches": counts, "max_err_float64": err, "max_diff_single_table": err_single,
        }
        log(f"[sharded {label}] {json.dumps(flows[f'sharded_{label}'])}")

    # passage: the flagship run's rows, one K1 launch a shard (the plans of
    # phases 3 and 12 are made again: later phases' plans evict them)
    index.mode = Mode.PASSAGE
    index(ranking)
    cands = index._get_plan(ranking)["cands"]
    q_pad = index._pad_queries(index.encode_queries(cands.queries), view)
    rows, qno = cands.rows_mat[:, 0].astype(np.int64), cands.pair_qno
    # the plan numbers queries by first appearance: its query block is the reference's
    ref = pairs_exact(corpus_dev, torch.from_numpy(q_pad).cuda(), cands.rows_mat, cands.counts_pp,
                      qno, "first", DIM)
    sh_plan: dict = {}
    one_plan: dict = {}  # the single table's layout, kept as the sharded one is
    run_sharded(
        "passage",
        lambda: sharded.streamed_scores_sharded(mesh, table, q_pad, rows, qno, precision="high",
                                                plan=sh_plan, fetch=False),
        lambda: scoring.streamed_scores(view.table, q_pad, rows, qno, precision="high", plan=one_plan,
                                        fetch=False),
        {"stream_select_pairwise": 2}, ref,
    )
    # MAXP: phase 12's layout with the K-reduce after the combine
    index.mode = Mode.MAXP
    index(doc_rank)
    dcands = index._get_plan(doc_rank)["cands"]
    k = dcands.k
    rows_d = dcands.rows_mat.reshape(-1).astype(np.int64)
    qno_d = np.repeat(dcands.pair_qno, k)
    counts_dev = torch.from_numpy(dcands.counts_pp.astype(np.int32)).cuda()
    q_doc = index._pad_queries(index.encode_queries(dcands.queries), view)
    ref_d = pairs_exact(corpus_dev, torch.from_numpy(q_doc).cuda(), dcands.rows_mat,
                        dcands.counts_pp, dcands.pair_qno, "max", DIM)
    sh_doc: dict = {}
    one_doc: dict = {}
    run_sharded(
        "doc_maxp",
        lambda: sharded.streamed_scores_sharded(mesh, table, q_doc, rows_d, qno_d, precision="high",
                                                plan=sh_doc, reduce=("max", k, counts_dev),
                                                fetch=False),
        lambda: scoring.streamed_scores(view.table, q_doc, rows_d, qno_d, precision="high",
                                        plan=one_doc, reduce=("max", k, counts_dev), fetch=False),
        {"stream_select_pairwise": 2}, ref_d,
    )
    index.mode = Mode.PASSAGE
    # the sparse run: the gather path on each shard's rows, no kernel
    sp = index._candidates(sparse, None)
    sp_rows, sp_counts, sp_k = sp.rows_mat, sp.counts_pp, sp.k
    sp_qno = sparse._df["q_id"].map(lambda q: int(q[1:])).to_numpy(dtype=np.int64)
    q_sp = np.zeros((scoring.bucket(QUERIES), DIM), dtype=np.float32)
    q_sp[:QUERIES] = qvecs_dev.cpu().numpy()
    idx = np.zeros((sp_k + 1, scoring.bucket(sp_rows.shape[0])), dtype=np.int32)
    idx[:sp_k, : sp_rows.shape[0]] = sp_rows.T
    idx[sp_k, : sp_rows.shape[0]] = (sp_qno.astype(np.int32) << 8) | sp_counts
    ref_s = pairs_exact(corpus_dev, qvecs_dev, sp_rows, sp_counts, sp_qno, "first", DIM)
    run_sharded(
        "sparse",
        lambda: sharded.score_pairs_sharded(mesh, table, q_sp, idx, "first", precision="high"),
        lambda: scoring.score_pairs_grouped(view.table, torch.from_numpy(q_sp).cuda(),
                                            torch.from_numpy(idx).cuda(), "first", precision="high"),
        {}, ref_s,
    )
    del table, sh_plan, sh_doc
    torch.cuda.empty_cache()
    # phase 9's PQ codes in two shards: one K3 launch a shard
    pq_view = pq_index._device_view()
    codes = pq_index._store[:N]
    pq_table = multihost.put_row_sharded(mesh, codes, shape=(pq_view.table.shape[0], codes.shape[1]))
    pq_cb = multihost.put_replicated(mesh, np.asarray(pq_index.quantizer.codewords, dtype=np.float32))
    pq_index.mode = Mode.PASSAGE
    pq_index(ranking)
    pq_cands = pq_index._get_plan(ranking)["cands"]
    q_pq = pq_index._pad_queries(pq_index.encode_queries(pq_cands.queries), pq_view)
    pq_rows_, pq_qno = pq_cands.rows_mat[:, 0].astype(np.int64), pq_cands.pair_qno
    ref_pq = pairs_exact(pq_rows(codes, pq_index.quantizer.codewords), torch.from_numpy(q_pq).cuda(),
                         pq_cands.rows_mat, pq_cands.counts_pp, pq_qno, "first", DIM)
    sh_pq: dict = {}
    one_pq: dict = {}
    run_sharded(
        "pq",
        lambda: sharded.streamed_scores_sharded_pq(mesh, pq_table, pq_cb, q_pq, pq_rows_, pq_qno,
                                                   plan=sh_pq, fetch=False),
        lambda: scoring.streamed_scores_pq(pq_view.table, pq_view.codebooks, q_pq, pq_rows_, pq_qno,
                                           plan=one_pq, fetch=False),
        {"stream_select_pq_pairwise": 2}, ref_pq,
    )
    del pq_table
    torch.cuda.empty_cache()
    return flows


def multiprocess_child(rank: int, port: int, n: int) -> int:
    """One of phase 26's two processes (``chip_smoke.py --multiprocess-child
    RANK PORT N``): joins the gloo job, builds ``InMemoryIndex(mesh_config=
    MeshConfig(data=1, shard=2))`` over the flagship corpus (its card is its
    whole local device set, so the mesh has two devices, one a process),
    ``preload()`` then ``narrow_to_shard()``, then the passage re-rank,
    ``serve()`` and MAXP, each checked against float64; prints
    ``MP_RESULT {json}`` with its K1 launches, times and digest."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from fastforward_tpu_torch import InMemoryIndex, Mode, Ranking
    from fastforward_tpu_torch.encoder import LambdaEncoder
    from fastforward_tpu_torch.ops import stream_kernel as sk
    from fastforward_tpu_torch.ops import stream_kernel_pq as skpq
    from fastforward_tpu_torch.parallel import MeshConfig, multihost

    wrappers = {"stream_select_pairwise": sk.stream_select_pairwise, "stream_select": sk.stream_select,
                "stream_select_pq_pairwise": skpq.stream_select_pq_pairwise,
                "stream_select_pq": skpq.stream_select_pq}
    torch.backends.cuda.matmul.allow_tf32 = True
    multihost.initialize(f"localhost:{port}", num_processes=2, process_id=rank, backend="gloo")
    t0 = time.perf_counter()
    corpus, qvecs, run, queries = make_workload(n, QUERIES, DEPTH, SEED)
    doc_counts, doc_starts, doc_ids = make_doc_ids(n, SEED + 3)
    doc_run = make_run(doc_counts.shape[0], "d", QUERIES, DEPTH, SEED + 4)
    by_text = {f"query {i}": qvecs[i] for i in range(QUERIES)}
    q_index = {f"q{i}": i for i in range(QUERIES)}
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = InMemoryIndex(query_encoder=LambdaEncoder(by_text.__getitem__), mode=Mode.PASSAGE,
                          precision="high", mesh_config=MeshConfig(data=1, shard=2))
    index.add(corpus, doc_ids=doc_ids, psg_ids=[f"p{i}" for i in range(n)])
    add_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    check(index.preload(), "preload found no table")
    preload_s = time.perf_counter() - t0
    table = index._device_view().table
    check(table.local_shards() == [rank], f"process {rank} holds shards {table.local_shards()}")
    before = index._store.nbytes
    band = index.narrow_to_shard()
    # the host keeps its shard's rows only: rows [rank * n_local, ...) of the padded table
    check(band == (rank * table.n_local, min((rank + 1) * table.n_local, n))
          and index._store.shape[0] == band[1] - band[0],
          f"process {rank} narrowed to rows {band}, {index._store.nbytes} of {before} B")
    # the float64 references read the checked rows from the host corpus
    rows_ref = DecodedRows(lambda rows: torch.from_numpy(corpus[rows.cpu().numpy()]).cuda())
    qvecs_dev = torch.from_numpy(qvecs).cuda()
    exact_p = passage_exact(rows_ref, qvecs_dev, q_index, DIM)
    exact_d = doc_exact(rows_ref, qvecs_dev, q_index, doc_counts, doc_starts, "max", DIM)
    ranking = Ranking.from_run(run, queries=queries)
    doc_rank = Ranking.from_run(doc_run, queries=queries)
    result = {"rank": rank, "band": list(band), "data_s": data_s, "add_s": add_s,
              "preload_s": preload_s, "host_bytes": [before, index._store.nbytes]}
    digest = []
    reset_counts(wrappers)
    for label, mode, rk, rn, exact in (("rerank", Mode.PASSAGE, ranking, run, exact_p),
                                       ("doc_maxp", Mode.MAXP, doc_rank, doc_run, exact_d)):
        index.mode = mode
        t0 = time.perf_counter()
        cold = index(rk)
        torch.cuda.synchronize()
        cold_ms = (time.perf_counter() - t0) * 1e3
        warm_ms, warm = timed_calls(lambda: index(rk), WARM_CALLS)
        check(cold == warm and len(warm._df) == len(rk._df), f"process {rank} {label} re-rank")
        check_rerank(warm, exact, f"process {rank} {label} re-rank")
        serve_ms, served = timed_calls(lambda: index.serve(rk, ALPHA, CUTOFF), WARM_CALLS)
        check_serve(served, rn, exact, f"process {rank} {label} serve")
        result[label] = {"cold_ms": cold_ms, "warm_ms": warm_ms, "serve_ms": serve_ms,
                         "qps": QUERIES / warm_ms * 1e3, "serve_qps": QUERIES / serve_ms * 1e3}
        df = warm._df
        digest.append(round(float(df["score"].to_numpy(np.float64).sum()), 2))
        digest.append(round(float(served._df["score"].to_numpy(np.float64).sum()), 3))
    counts = read_counts(wrappers)
    # one K1 launch a call (this process's shard): 2 flows x (1 + warm) re-ranks
    # and warm serves
    want = 2 * (1 + 2 * WARM_CALLS)
    check(counts["stream_select_pairwise"] == want and sum(counts.values()) == want,
          f"process {rank} launches {counts}, want {want} of K1")
    result["launches"] = counts
    result["digest"] = digest
    import torch.distributed as dist

    dist.barrier()
    print("MP_RESULT " + json.dumps(result), flush=True)
    dist.destroy_process_group()
    return 0


def multiprocess_phase(n: int) -> dict:
    """Phase 26: two processes on the card through the public API (each
    ``multiprocess_child``), started with a time limit on one free local
    port (a race for the port retries once on another); both must exit 0
    with the same digest."""
    import os
    import socket

    if n != N:
        log(f"[multiprocess] N cut to {n} rows (the flagship's is {N}) by the time limit")
    for attempt in range(2):
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        env = dict(os.environ, OMP_NUM_THREADS="4")
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--multiprocess-child",
                                   str(rank), str(port), str(n)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True, env=env) for rank in (0, 1)]
        outs = []
        try:
            for proc in procs:
                outs.append(proc.communicate(timeout=MP_TIMEOUT_S)[0])
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        wall_s = time.perf_counter() - t0
        raced = any(proc.returncode != 0 and ("EADDRINUSE" in out or "Address already in use" in out)
                    for proc, out in zip(procs, outs))
        if not raced or attempt == 1:
            break
    results = []
    for rank, (proc, out) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines() if ln.startswith("MP_RESULT ")]
        if proc.returncode != 0 or len(lines) != 1:
            log(f"[multiprocess] process {rank} output:\n" + "\n".join(out.splitlines()[-40:]))
        check(proc.returncode == 0 and len(lines) == 1,
              f"multiprocess child {rank} exited {proc.returncode}")
        results.append(json.loads(lines[0][len("MP_RESULT "):]))
        for ln in out.splitlines():
            if ln.startswith("  process"):
                log(ln)
    check(results[0]["digest"] == results[1]["digest"],
          f"the two processes' digests differ: {results[0]['digest']} vs {results[1]['digest']}")
    log(f"[multiprocess] both processes exit 0 with digest {results[0]['digest']} in {wall_s:.1f} s: "
        f"{json.dumps(results)}")
    return {"wall_s": wall_s, "n": n, "processes": results}


def by_query(df, column: str) -> dict:
    """``column``'s values of each query, in the frame's order."""
    out = {}
    for q, v in zip(df["q_id"].astype(str), df[column].tolist()):
        out.setdefault(q, []).append(v)
    return out


def check_order(result, exact, what, run=None) -> int:
    """Each query's result order against the float64 oracle's: two results
    in a row may stand in the oracle's reverse order only within the sum of
    their tolerances (``exact``'s; with ``run``, of the interpolation
    ``ALPHA * lex + (1 - ALPHA) * sem`` the serve tail ranks by).  Returns
    the pairs of neighbours checked."""
    df = result._df
    qid = df["q_id"].astype(str).to_numpy()
    ids = df["id"].astype(str).to_numpy()
    pairs = 0
    for q in dict.fromkeys(qid):
        sel = ids[qid == q]
        ref, tol = exact(q, sel)
        if run is not None:
            lex = torch.tensor([run[q][i] for i in sel], dtype=torch.float64, device=ref.device)
            ref = ALPHA * lex + (1 - ALPHA) * ref
            tol = (1 - ALPHA) * tol + ref.abs() * 2.0**-22
        bad = (ref[:-1] - ref[1:] < -(tol[:-1] + tol[1:])).nonzero().flatten()
        check(bad.numel() == 0, f"{what}: {q} ranks {sel[int(bad[0]) if bad.numel() else 0]} above a "
              "better candidate")
        pairs += sel.shape[0] - 1
    return pairs


def contract_workload(corpus: np.ndarray, n: int):
    """Phase 27's table and runs over the first ``n`` flagship rows: one
    document of ``CONTRACT_MEGA`` passages (``d0``, rows ``[0, MEGA)``),
    then documents of 1-7 passages; ``CONTRACT_TIE_ROWS`` identical rows;
    ``CONTRACT_NEAR_PAIRS`` pairs of rows equal but for coordinate 0, 8 and
    ``8 (1 + 2^-10)``; queries whose coordinate 0 is +-4, so each pair's
    dots differ by 2^-5, below bf16's resolution of the rows."""
    rng = np.random.default_rng(SEED + 11)
    data = corpus[:n].copy()
    tie_lo = CONTRACT_MEGA
    data[tie_lo : tie_lo + CONTRACT_TIE_ROWS] = data[tie_lo]
    near_lo = tie_lo + CONTRACT_TIE_ROWS
    near = np.arange(near_lo, near_lo + 2 * CONTRACT_NEAR_PAIRS)
    data[near[1::2]] = data[near[0::2]]
    data[near[0::2], 0] = 8.0
    data[near[1::2], 0] = np.float32(8.0 * (1 + 2.0**-10))
    rest, _, _ = make_doc_ids(n - CONTRACT_MEGA, SEED + 12)
    counts = np.concatenate([[CONTRACT_MEGA], rest])
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    doc_ids = [f"d{d}" for d, c in enumerate(counts.tolist()) for _ in range(c)]
    qvecs = rng.standard_normal((max(CONTRACT_QUERIES, CONTRACT_DEPTH1_QUERIES), DIM), dtype=np.float32)
    qvecs[:, 0] = np.where(qvecs[:, 0] < 0, -4.0, 4.0)
    nq, depth = CONTRACT_QUERIES, CONTRACT_DEPTH
    depths = np.round(np.geomspace(1, depth, nq)).astype(int)
    singles = np.flatnonzero(counts == 1)
    runs = {
        # 64 queries from depth 1 to 1000, geometric
        "skewed": {f"q{q}": {f"p{c}": float(d - i) for i, c in enumerate(rng.choice(n, d, replace=False))}
                   for q, d in enumerate(depths)},
        # every lexical score equal: the semantic scores alone decide
        "lex_ties": {f"q{q}": {f"p{c}": 7.0 for c in rng.choice(n, depth, replace=False)} for q in range(nq)},
        "lex_ties_maxp": {f"q{q}": {f"d{c}": 7.0 for c in 1 + rng.choice(counts.shape[0] - 1, depth, replace=False)}
                          for q in range(nq)},
        # identical rows and equal lexical scores: every score ties
        "full_ties": {f"q{q}": {f"p{c}": 1.0 for c in tie_lo + rng.permutation(CONTRACT_TIE_ROWS)}
                      for q in range(nq)},
        "near_dups": {f"q{q}": {f"p{c}": 0.0 for c in rng.permutation(near)} for q in range(nq)},
        # the mega-document among single-passage documents
        "mega": {f"q{q}": {"d0": 9.0, **{f"d{c}": float(i) for i, c in enumerate(rng.choice(singles, nq - 1, replace=False))}}
                 for q in range(nq)},
        "depth1": {f"q{q}": {f"p{int(rng.integers(n))}": 2.0} for q in range(CONTRACT_DEPTH1_QUERIES)},
    }
    return data, doc_ids, counts, starts, qvecs, runs, near


def contract_phase(corpus, sq, pq, wrappers, launches) -> dict:
    """Phase 27: the JAX package's contract suites' hard cases through the
    public API at dim 768 on ``DENSE_N`` rows, on five tables: fp32 on the
    host store (``"exact"``) and on ``store="device"`` (``"fast"``), int8
    (phase 7's quantizer), ``PQ(96, 256)`` (phase 9's) and ``PQ(96, 1024)``
    (uint16 codes): skewed depths, lexical ties (passages and MAXP
    documents), full ties (held to the lower-index-first order of the
    JAX package's ``lax.top_k``; early stopping on them terminates),
    near-duplicate rows, a mega-document in MAXP/AVEP/FIRSTP (the flat
    path), and a depth-1 run of 512 queries (the gather branch: no kernel).
    Every score is checked against float64 (of the decoded rows, or of the
    bf16-rounded operands in the fast tier), every order against the
    oracle's; K1 must launch for fp32, K2 for int8 MAXP, K3 and K4 for
    PQ."""
    from fastforward_tpu_torch import InMemoryIndex, Mode, Ranking
    from fastforward_tpu_torch.encoder import LambdaEncoder
    from fastforward_tpu_torch.ops import scoring
    from fastforward_tpu_torch.quantizer import PQ

    t_phase = time.perf_counter()
    n = DENSE_N
    data, doc_ids, counts, starts, qvecs, runs, near = contract_workload(corpus, n)
    psg_ids = [f"p{i}" for i in range(n)]
    queries = {f"q{q}": f"query {q}" for q in range(qvecs.shape[0])}
    by_text = {f"query {q}": qvecs[q] for q in range(qvecs.shape[0])}
    q_index = {f"q{q}": q for q in range(qvecs.shape[0])}
    rankings = {k: Ranking.from_run(r, queries={q: queries[q] for q in r}) for k, r in runs.items()}
    q_dev = torch.from_numpy(qvecs).cuda()
    data_dev = torch.from_numpy(data).cuda()
    t0 = time.perf_counter()
    pq_wide = PQ(PQ_M, PQ_WIDE_KS)
    pq_wide.fit(data[:QUANT_FIT])
    fit_s = time.perf_counter() - t0

    def new_index(**kw):
        index = InMemoryIndex(query_encoder=LambdaEncoder(by_text.__getitem__), mode=Mode.PASSAGE,
                              init_size=n, **kw)
        add_in_chunks(index, data, psg_ids, doc_ids)
        return index

    tables = {
        "fp32": (lambda: new_index(precision="exact"), lambda ix: (data_dev, q_dev)),
        "fp32_device_fast": (lambda: new_index(precision="fast", store="device"),
                             lambda ix: (data_dev.bfloat16().double(), q_dev.bfloat16().float())),
        "int8": (lambda: new_index(quantizer=sq, precision="high"),
                 lambda ix: (scalar_rows(ix._store[:n], sq.scales), q_dev)),
        "pq": (lambda: new_index(quantizer=pq, precision="exact"),
               lambda ix: (pq_rows(ix._store[:n], pq.codewords), q_dev)),
        "pq1024": (lambda: new_index(quantizer=pq_wide, precision="exact"),
                   lambda ix: (pq_rows(ix._store[:n], pq_wide.codewords), q_dev)),
    }
    want = {"fp32": ("stream_select_pairwise",), "fp32_device_fast": ("stream_select_pairwise",),
            "int8": ("stream_select",), "pq": ("stream_select_pq_pairwise", "stream_select_pq"),
            "pq1024": ("stream_select_pq_pairwise", "stream_select_pq")}
    allowed = {"fp32": {"stream_select_pairwise"}, "fp32_device_fast": {"stream_select_pairwise"},
               "int8": {"stream_select_pairwise", "stream_select"},
               "pq": {"stream_select_pq_pairwise", "stream_select_pq"},
               "pq1024": {"stream_select_pq_pairwise", "stream_select_pq"}}
    out = {"pq1024_fit_s": fit_s}
    nq = CONTRACT_QUERIES
    for label, (build, reference) in tables.items():
        t0 = time.perf_counter()
        index = build()
        rows_ref, q_ref = reference(index)
        psg = passage_exact(rows_ref, q_ref, q_index, DIM)
        doc = {op: doc_exact(rows_ref, q_ref, q_index, counts, starts, op, DIM)
               for op in ("max", "mean", "first")}
        setup_s = time.perf_counter() - t0
        what = f"contract {label}"

        # 5. depth 1: 512 pairs take the gather branch, as the JAX routing
        # picks it (n_pairs * density <= N); no kernel launches
        density = scoring.STREAM_DENSITY_PQ if label.startswith("pq") else scoring.STREAM_DENSITY
        check(len(rankings["depth1"]._df) * density <= n, f"{what}: the depth-1 run would stream")
        reset_counts(wrappers)
        got = index(rankings["depth1"])
        check_rerank(got, psg, f"{what} depth-1 re-rank", queries=CONTRACT_DEPTH1_QUERIES)
        served = index.serve(rankings["depth1"], ALPHA, CUTOFF)
        check_serve(served, runs["depth1"], psg, f"{what} depth-1 serve", queries=CONTRACT_DEPTH1_QUERIES)
        check(not any(read_counts(wrappers).values()), f"{what}: the depth-1 run launched {read_counts(wrappers)}")

        reset_counts(wrappers)
        # 1. skewed depths
        got = index(rankings["skewed"])
        check_rerank(got, psg, f"{what} skewed re-rank", queries=nq)
        order_pairs = check_order(got, psg, f"{what} skewed re-rank")
        served = index.serve(rankings["skewed"], ALPHA, CUTOFF)
        check_serve(served, runs["skewed"], psg, f"{what} skewed serve", queries=nq)
        order_pairs += check_order(served, psg, f"{what} skewed serve", runs["skewed"])
        # 2. lexical ties (passages, then MAXP documents), then full ties
        got = index(rankings["lex_ties"])
        check_rerank(got, psg, f"{what} lexical-tie re-rank", queries=nq)
        order_pairs += check_order(got, psg, f"{what} lexical-tie re-rank")
        served = index.serve(rankings["lex_ties"], ALPHA, CUTOFF)
        check_serve(served, runs["lex_ties"], psg, f"{what} lexical-tie serve", queries=nq)
        order_pairs += check_order(served, psg, f"{what} lexical-tie serve", runs["lex_ties"])
        full = rankings["full_ties"]
        got, served = index(full), index.serve(full, ALPHA, CUTOFF)
        check_rerank(got, psg, f"{what} full-tie re-rank", queries=nq)
        frame_ids, got_ids, served_ids = (by_query(r._df, "id") for r in (full, got, served))
        served_scores = by_query(served._df, "score")
        for q, ids in frame_ids.items():
            scores = served_scores[q]
            check(len(set(scores)) == 1, f"{what}: {q}'s identical rows scored apart: {scores}")
            check(served_ids[q] == ids[:CUTOFF],
                  f"{what}: {q}'s fully tied serve cut is not the lower-index-first order")
            check(got_ids[q] == ids, f"{what}: {q}'s fully tied re-rank left the frame order")
        es = index.serve(full, ALPHA, CUTOFF, early_stopping_depths=(16, 64, 256))
        es_ids = by_query(es._df, "id")
        check(len(es_ids) == nq and all(len(v) == CUTOFF for v in es_ids.values()),
              f"{what}: early stopping on full ties lost results")
        check_serve(es, runs["full_ties"], psg, f"{what} full-tie ES serve", queries=nq)
        # 3. near-duplicate rows
        got = index(rankings["near_dups"])
        check_rerank(got, psg, f"{what} near-duplicate re-rank", queries=nq)
        order_pairs += check_order(got, psg, f"{what} near-duplicate re-rank")
        if label == "fp32":
            # at "exact" every pair ranks as float64 does: its 2^-5 gap
            # exceeds the two scores' tolerances
            df = got._df
            score = dict(zip(zip(df["q_id"].astype(str), df["id"].astype(str)), df["score"]))
            for q in runs["near_dups"]:
                ids = [f"p{r}" for r in near]
                ref, tol = psg(q, ids)
                d_ref, t_pair = ref[0::2] - ref[1::2], tol[0::2] + tol[1::2]
                check(bool((d_ref.abs() > t_pair).all()), f"{what}: a near-duplicate gap is within tolerance")
                d_got = torch.tensor([score[(q, a)] - score[(q, b)] for a, b in zip(ids[0::2], ids[1::2])],
                                     dtype=torch.float64, device=ref.device)
                check(bool((torch.sign(d_got) == torch.sign(d_ref)).all()),
                      f"{what}: {q} orders a near-duplicate pair against float64")
            served = index.serve(rankings["near_dups"], ALPHA, CUTOFF, refine=REFINE)
            check_serve(served, runs["near_dups"], psg, f"{what} near-duplicate serve(refine)", queries=nq)
        served = index.serve(rankings["near_dups"], ALPHA, CUTOFF)
        check_serve(served, runs["near_dups"], psg, f"{what} near-duplicate serve", queries=nq)
        # 2. lexical ties over MAXP documents (cap 1024 > r: K2 for int8, K4 for PQ)
        index.mode = Mode.MAXP
        got = index(rankings["lex_ties_maxp"])
        check_rerank(got, doc["max"], f"{what} MAXP lexical-tie re-rank", queries=nq)
        order_pairs += check_order(got, doc["max"], f"{what} MAXP lexical-tie re-rank")
        served = index.serve(rankings["lex_ties_maxp"], ALPHA, CUTOFF)
        check_serve(served, runs["lex_ties_maxp"], doc["max"], f"{what} MAXP lexical-tie serve", queries=nq)
        # 4. the mega-document (the flat path) in every document mode
        for mode, op in ((Mode.MAXP, "max"), (Mode.AVEP, "mean"), (Mode.FIRSTP, "first")):
            index.mode = mode
            got = index(rankings["mega"])
            check_rerank(got, doc[op], f"{what} mega-document {mode.name}", queries=nq)
            order_pairs += check_order(got, doc[op], f"{what} mega-document {mode.name}")
        index.mode = Mode.MAXP
        served = index.serve(rankings["mega"], ALPHA, CUTOFF)
        check_serve(served, runs["mega"], doc["max"], f"{what} mega-document MAXP serve", queries=nq)
        counts_t = read_counts(wrappers)
        launches[f"contract_{label}"] = counts_t
        for kname in want[label]:
            check(counts_t[kname] > 0, f"{what} launched no {kname}: {counts_t}")
        others = {k: v for k, v in counts_t.items() if v and k not in allowed[label]}
        check(not others, f"{what} launched {others}")
        out[label] = {"setup_s": setup_s, "s": time.perf_counter() - t0, "order_pairs": order_pairs,
                      "launches": counts_t}
        log(f"[contract {label}] {time.perf_counter() - t0:.1f} s (set-up {setup_s:.1f} s); "
            f"{order_pairs} neighbour pairs in the oracle's order; launches {counts_t}")
        del index, rows_ref, psg, doc
        torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t_phase
    log(f"[contract] phase 27 passed in {out['s']:.1f} s; card: {smi_line()}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from fastforward_tpu_torch import InMemoryIndex, Mode, Ranking
    from fastforward_tpu_torch.encoder import LambdaEncoder
    from fastforward_tpu_torch.ops import _build, query_groups, scoring
    from fastforward_tpu_torch.ops import stream_kernel as sk
    from fastforward_tpu_torch.ops import stream_kernel_pq as skpq
    from fastforward_tpu_torch.quantizer import OPQ, PQ, ScalarQuantizer

    wrappers = {
        "stream_select_pairwise": sk.stream_select_pairwise,
        "stream_select": sk.stream_select,
        "stream_select_pq_pairwise": skpq.stream_select_pq_pairwise,
        "stream_select_pq": skpq.stream_select_pq,
    }
    # TF32 on: the exact path must not depend on it
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    t_start = time.perf_counter()
    card = smi_line()
    name = torch.cuda.get_device_name(0)
    rates = card_rates(name)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"rates used for bounds: {rates[0] / 1e12} TB/s, {rates[1] / 1e12} fp32 TFLOP/s")

    # -- 1. build: one nvcc per source, all at once ------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        built = dict(zip(KERNELS, pool.map(_build.build_kernel, KERNELS)))
    log(f"[build] K1-K4 built in {time.perf_counter() - t0:.2f} s")
    for kname, lib_path in built.items():
        log(f"  {kname}: {lib_path.name}")
        for line in lib_path.with_suffix(".log").read_text().splitlines():
            if "Used" in line or "spill" in line:
                log("  ptxas:", line.strip())

    # -- 2. kernels vs plain, small shapes ---------------------------------------
    log("[kernel-small] K1 vs plain at n_pad 8192, dim 256, Qb 64, 5000 pairs")
    rng = np.random.default_rng(SEED)
    n_pad, dim_s, qb, p = 8192, 256, 64, 5000
    rows = rng.integers(0, n_pad, size=p)
    qno = rng.integers(0, qb, size=p)
    cap = scoring._adaptive_cap(p, n_pad // sk.KERNEL_TILE_ROWS)
    cand, tidx, _ = scoring.build_streamed_layout(rows, qno, n_pad, qb, cap=cap)
    cand3 = torch.from_numpy(cand.reshape(cand.shape[0], cap // 128, 128)).cuda()
    tile_idx = torch.from_numpy(tidx).cuda()
    q_s = torch.from_numpy(rng.standard_normal((qb, dim_s), dtype=np.float32)).cuda()
    t32 = torch.from_numpy(rng.standard_normal((n_pad, dim_s), dtype=np.float32)).cuda()
    t8 = torch.from_numpy(rng.integers(-127, 128, size=(n_pad, dim_s // 128, 128), dtype=np.int8)).cuda()
    small = []
    for label, table in (("fp32", t32), ("bf16", t32.to(torch.bfloat16)), ("int8", t8)):
        small += pairwise_variants(sk, table, q_s, cand3, tile_idx, dim_s, ("exact", "fast"), False,
                                   rates, f"{label} dim {dim_s}")

    n_pad = 4096
    queries_s = small_queries(rng, torch.from_numpy(rng.standard_normal((qb, DIM), dtype=np.float32)).cuda())
    log(f"[kernel-small] K1 (cap 512) and K2 (cap 1024) vs plain at n_pad {n_pad}, dim {DIM}, "
        f"fp32/bf16/int8 tables; layouts {SMALL_LAYOUTS}")
    small += dense_small_cases(sk, rng, n_pad, queries_s, rates)
    log(f"[kernel-small] K1 fp32 vs plain at n_pad {n_pad}, dim {DIM} on tiles that pin its "
        "shortcuts (padding, repeats, one row a tile), caps 128-1024, r 512 and 128")
    small += fp32_edge_cases(sk, rng, n_pad)
    log(f"[kernel-small] K3 (cap 512) and K4 (cap 1024) vs plain at n_pad {n_pad}, dim {DIM}, "
        f"PQ(M, Ks) for (M, Ks) in {PQ_SMALL_SHAPES}; layouts {SMALL_LAYOUTS}")
    small += pq_small_cases(skpq, rng, n_pad, queries_s, rates)

    # -- 3. re-rank at the flagship shape ------------------------------------
    t0 = time.perf_counter()
    corpus, qvecs, run, queries = make_workload(N, QUERIES, DEPTH, SEED)
    doc_counts, doc_starts, doc_ids = make_doc_ids(N, SEED + 3)
    doc_run = make_run(doc_counts.shape[0], "d", QUERIES, DEPTH, SEED + 4)
    by_text = {f"query {i}": qvecs[i] for i in range(QUERIES)}
    q_index = {f"q{i}": i for i in range(QUERIES)}
    psg_ids = [f"p{i}" for i in range(N)]
    ranking = Ranking.from_run(run, queries=queries)
    doc_rank = Ranking.from_run(doc_run, queries=queries)
    index = InMemoryIndex(
        query_encoder=LambdaEncoder(by_text.__getitem__),
        mode=Mode.PASSAGE,
        precision="high",
    )
    t_add = time.perf_counter()
    index.add(corpus, doc_ids=doc_ids, psg_ids=psg_ids)
    mem_add_s = time.perf_counter() - t_add
    log(f"[setup] corpus {corpus.shape} fp32 in {doc_counts.shape[0]} documents of 1-"
        f"{DOC_MAX_PSGS} passages + {len(ranking._df)} passage and {len(doc_rank._df)} document "
        f"pairs built in {time.perf_counter() - t0:.1f} s")
    corpus_dev = torch.from_numpy(corpus).cuda()
    qvecs_dev = torch.from_numpy(qvecs).cuda()
    exact_p = passage_exact(corpus_dev, qvecs_dev, q_index, DIM)
    launches = {}
    # kernel rows held against their plain versions on staged tail blocks (20, 21)
    held = {kname: [] for kname in KERNELS}

    def k1_phase_launches(phase: str) -> int:
        counts = read_counts(wrappers)
        launches[phase] = counts
        others = {k: v for k, v in counts.items() if k != "stream_select_pairwise" and v}
        check(not others, f"{phase} launched other kernels than K1: {others}")
        return counts["stream_select_pairwise"]

    reset_counts(wrappers)
    t0 = time.perf_counter()
    cold = index(ranking)
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    warm_ms, warm = timed_calls(lambda: index(ranking), WARM_CALLS)
    n_k1 = k1_phase_launches("rerank")
    check(n_k1 == 1 + WARM_CALLS, f"re-rank ran K1 {n_k1} times")
    check(len(warm._df) == len(ranking._df), "re-rank lost pairs")
    check_rerank(warm, exact_p, "re-rank")
    check(cold == warm, "cold and warm re-rank disagree")
    flows = {
        "rerank": {"cold_ms": cold_ms, "warm_ms": warm_ms, "qps": QUERIES / warm_ms * 1e3}
    }
    log(f"[rerank] cold {cold_ms:.1f} ms, warm median {warm_ms:.2f} ms, "
        f"{flows['rerank']['qps']:.1f} QPS, K1 launches {n_k1}")
    plan = index._get_plan(ranking)
    main_inputs = (plan["stream"][0], plan["stream"][1], plan["q_dev"][1])

    # -- 4. fused serve --------------------------------------------------
    for label, refine in (("serve_refine", REFINE), ("serve", None)):
        reset_counts(wrappers)
        t0 = time.perf_counter()
        index.serve(ranking, ALPHA, CUTOFF, refine=refine)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        ms, served = timed_calls(
            lambda: index.serve(ranking, ALPHA, CUTOFF, refine=refine), WARM_CALLS
        )
        n_k1 = k1_phase_launches(label)
        check(n_k1 == 1 + WARM_CALLS, f"{label} ran K1 {n_k1} times")
        check_serve(served, run, exact_p, label)
        flows[label] = {"first_ms": first_ms, "warm_ms": ms, "qps": QUERIES / ms * 1e3}
        log(f"[{label}] first {first_ms:.1f} ms, warm median {ms:.2f} ms, "
            f"{flows[label]['qps']:.1f} QPS, K1 launches {n_k1}")

    # -- 5. sparse ranking and a bf16 table ----------------------------------
    sparse_run = {f"q{i}": dict(list(run[f"q{i}"].items())[:SPARSE_DEPTH]) for i in range(SPARSE_QUERIES)}
    sparse = Ranking.from_run(sparse_run, queries={q: queries[q] for q in sparse_run})
    check(len(sparse._df) * scoring.STREAM_DENSITY <= index._device_view().table.shape[0],
          "the sparse ranking would stream")
    reset_counts(wrappers)
    check_rerank(index(sparse), exact_p, "sparse re-rank")
    check(k1_phase_launches("sparse") == 0, "the sparse ranking ran K1")

    bf16_corpus = corpus[:BF16_N]
    bf16_run = {q: {p: s for p, s in run[q].items() if int(p[1:]) < BF16_N} for q in run}
    bf16_run = {q: d for q, d in bf16_run.items() if d}
    bf16_rank = Ranking.from_run(bf16_run, queries={q: queries[q] for q in bf16_run})
    bf16_index = InMemoryIndex(
        query_encoder=LambdaEncoder(by_text.__getitem__),
        mode=Mode.PASSAGE,
        precision="high",
        device_dtype="bfloat16",
    )
    bf16_index.add(bf16_corpus, psg_ids=psg_ids[:BF16_N])
    # the table holds bf16-rounded rows: check against those
    bf16_rows = torch.from_numpy(bf16_corpus).cuda().to(torch.bfloat16).float()
    exact_bf16 = passage_exact(bf16_rows, qvecs_dev, q_index, DIM)
    reset_counts(wrappers)
    check_rerank(bf16_index(bf16_rank), exact_bf16, "bf16 re-rank")
    check(k1_phase_launches("bf16_rerank") >= 1, "bf16 re-rank ran no K1 launch")
    reset_counts(wrappers)
    bf16_served = bf16_index.serve(bf16_rank, ALPHA, CUTOFF, refine=REFINE)
    check(k1_phase_launches("bf16_serve_refine") == 1, "bf16 serve ran no K1 launch")
    check_serve(bf16_served, bf16_run, exact_bf16, "bf16 serve_refine")
    del bf16_index, bf16_rows, exact_bf16

    # -- 12. document modes at full width (K1 fp32, cap 1024) ---------------------
    doc_ops = {"MAXP": "max", "AVEP": "mean", "FIRSTP": "first"}
    exact_doc = {
        mode: doc_exact(corpus_dev, qvecs_dev, q_index, doc_counts, doc_starts, op, DIM)
        for mode, op in doc_ops.items()
    }
    reset_counts(wrappers)
    index.mode = Mode.MAXP
    t0 = time.perf_counter()
    cold = index(doc_rank)
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    warm_ms, warm = timed_calls(lambda: index(doc_rank), WARM_CALLS)
    check(len(warm._df) == len(doc_rank._df), "MAXP re-rank lost pairs")
    check(cold == warm, "cold and warm MAXP re-rank disagree")
    check_rerank(warm, exact_doc["MAXP"], "MAXP re-rank")
    mem_maxp = warm  # phase 19's disk index must equal it bit for bit
    flows["doc_maxp_rerank"] = {"cold_ms": cold_ms, "warm_ms": warm_ms, "qps": QUERIES / warm_ms * 1e3}
    doc_plan = index._get_plan(doc_rank)
    doc_cands = doc_plan["cands"]
    doc_k = doc_cands.k
    doc_inputs = (doc_plan["stream"][0], doc_plan["stream"][1], doc_plan["q_dev"][1])
    # the same rows without the K-padding: each pair's real rows only
    valid = np.arange(doc_k)[None, :] < doc_cands.counts_pp[:, None]
    real_rows = doc_cands.rows_mat[valid].astype(np.int64)
    real_qno = np.repeat(doc_cands.pair_qno, doc_cands.counts_pp)
    log(f"[doc] MAXP: {len(doc_rank._df)} pairs, K {doc_k}, {real_rows.shape[0]} real rows "
        f"({np.unique(real_rows).shape[0]} distinct), {doc_cands.rows_mat.size} slots; "
        f"layout {tuple(doc_inputs[0].shape)}; re-rank cold {cold_ms:.1f} ms, warm median "
        f"{warm_ms:.2f} ms")
    for label, refine in (("doc_maxp_serve", None), ("doc_maxp_serve_refine", REFINE)):
        t0 = time.perf_counter()
        index.serve(doc_rank, ALPHA, CUTOFF, refine=refine)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        ms, served = timed_calls(
            lambda: index.serve(doc_rank, ALPHA, CUTOFF, refine=refine), WARM_CALLS
        )
        check_serve(served, doc_run, exact_doc["MAXP"], label)
        flows[label] = {"first_ms": first_ms, "warm_ms": ms, "qps": QUERIES / ms * 1e3}
        log(f"[{label}] first {first_ms:.1f} ms, warm median {ms:.2f} ms")
    n_k1 = k1_phase_launches("doc_maxp")
    check(n_k1 == 3 * (1 + WARM_CALLS), f"MAXP ran K1 {n_k1} times")
    # the profiles of phases 4 and 12 together: the profiler keeps a call's
    # device items most reliably within the first seconds after its first
    # traced window (profile_flow)
    for label, mode, fn in (
        ("rerank", Mode.PASSAGE, lambda: index(ranking)),
        ("serve_refine", Mode.PASSAGE, lambda: index.serve(ranking, ALPHA, CUTOFF, refine=REFINE)),
        ("serve", Mode.PASSAGE, lambda: index.serve(ranking, ALPHA, CUTOFF)),
        ("doc_maxp_rerank", Mode.MAXP, lambda: index(doc_rank)),
        ("doc_maxp_serve", Mode.MAXP, lambda: index.serve(doc_rank, ALPHA, CUTOFF)),
    ):
        index.mode = mode
        flows[label]["profile"] = profile_flow(
            fn, CALL_KERNELS["pairwise_fast" if label == "serve_refine" else "pairwise"])
        log(f"[profile {label}]", json.dumps(flows[label]["profile"]))
    flows["doc_maxp_serve"]["device_memory"] = serve_memory(index, doc_rank, {})
    log(f"[doc memory] one warm MAXP serve: {json.dumps(flows['doc_maxp_serve']['device_memory'])}")
    reset_counts(wrappers)
    for mode in ("AVEP", "FIRSTP"):
        index.mode = Mode[mode]
        label = f"doc_{mode.lower()}_rerank"
        t0 = time.perf_counter()
        cold = index(doc_rank)
        torch.cuda.synchronize()
        cold_ms = (time.perf_counter() - t0) * 1e3
        warm_ms, warm = timed_calls(lambda: index(doc_rank), WARM_CALLS)
        check(cold == warm, f"cold and warm {mode} re-rank disagree")
        check_rerank(warm, exact_doc[mode], f"{mode} re-rank")
        flows[label] = {"cold_ms": cold_ms, "warm_ms": warm_ms, "qps": QUERIES / warm_ms * 1e3}
        log(f"[{label}] cold {cold_ms:.1f} ms, warm median {warm_ms:.2f} ms")
    n_k1 = k1_phase_launches("doc_avep_firstp")
    check(n_k1 == 2 * (1 + WARM_CALLS), f"AVEP and FIRSTP ran K1 {n_k1} times")
    index.mode = Mode.PASSAGE

    # -- 14. early stopping on the flagship passage index and run (K1) ------------
    es_rankings = [Ranking.from_run(run, queries=queries) for _ in range(ES_COLD_CALLS + 2)]
    reset_counts(wrappers)
    t0 = time.perf_counter()
    es_first = index(es_rankings[0], **ES_KWARGS)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    cold_times = []
    for r in es_rankings[1 : 1 + ES_COLD_CALLS]:  # a fresh ranking per call
        t0 = time.perf_counter()
        es_cold = index(r, **ES_KWARGS)
        torch.cuda.synchronize()
        cold_times.append((time.perf_counter() - t0) * 1e3)
    es_warm_rank = es_rankings[0]
    index(es_warm_rank, **ES_KWARGS)  # builds the plan's categorical columns
    es_warm_ms, es_warm = timed_calls(lambda: index(es_warm_rank, **ES_KWARGS), WARM_CALLS)
    check(es_first == es_cold == es_warm, "early stopping: cold and warm results disagree")
    check_rerank(es_warm, exact_p, "early stopping re-rank", queries=QUERIES)
    check_es_against_cpu(es_warm, corpus, by_text, run, queries, exact_p, ES_KWARGS,
                         "early stopping re-rank")
    t0 = time.perf_counter()
    index.serve(es_rankings[-1], ALPHA, CUTOFF, early_stopping_depths=ES_SERVE_DEPTHS)
    torch.cuda.synchronize()
    serve_first_ms = (time.perf_counter() - t0) * 1e3
    es_serve_ms, es_served = timed_calls(
        lambda: index.serve(es_rankings[-1], ALPHA, CUTOFF, early_stopping_depths=ES_SERVE_DEPTHS),
        WARM_CALLS,
    )
    es_serve_kwargs = dict(ES_KWARGS, early_stopping_depths=ES_SERVE_DEPTHS)
    check_es_against_cpu(es_served, corpus, by_text, run, queries, exact_p, es_serve_kwargs,
                         "early stopping serve", serve_args=(ALPHA, CUTOFF, ES_SERVE_DEPTHS))
    n_es_rows = len(es_warm._df)
    cold_ms = float(np.median(cold_times))
    flows["es_cold"] = {"first_ms": first_ms, "cold_ms": cold_ms, "qps": QUERIES / cold_ms * 1e3,
                        "rows_scored": n_es_rows}
    flows["es_warm"] = {"warm_ms": es_warm_ms, "qps": QUERIES / es_warm_ms * 1e3}
    flows["es_serve"] = {"first_ms": serve_first_ms, "warm_ms": es_serve_ms,
                         "qps": QUERIES / es_serve_ms * 1e3}
    log(f"[early stopping] {n_es_rows} of {len(ranking._df)} pairs scored; first {first_ms:.1f} ms, "
        f"cold median {cold_ms:.1f} ms ({flows['es_cold']['qps']:.1f} QPS), warm median "
        f"{es_warm_ms:.2f} ms; serve first {serve_first_ms:.1f} ms, warm median {es_serve_ms:.2f} ms")

    # the alpha sweep: one warm-up pass, then timed passes
    sweep_run = make_run(N, "p", SWEEP_QUERIES, SWEEP_DEPTH, SEED + 5)
    sweep_queries = {q: queries[q] for q in sweep_run}
    sweep_rank = Ranking.from_run(sweep_run, queries=sweep_queries)

    def sweep():
        return {
            alpha: index(sweep_rank, **dict(ES_KWARGS, early_stopping_alpha=alpha,
                                            early_stopping_depths=SWEEP_DEPTHS))
            for alpha in SWEEP_ALPHAS
        }

    t0 = time.perf_counter()
    sweep()
    torch.cuda.synchronize()
    sweep_first_ms = (time.perf_counter() - t0) * 1e3
    sweep_ms, swept = timed_calls(sweep, SWEEP_PASSES)
    check_rerank(swept[0.5], exact_p, "alpha sweep (alpha 0.5)")
    n_sweep = len(sweep_rank._df)
    flows["alpha_sweep"] = {
        "first_pass_ms": sweep_first_ms, "pass_ms": sweep_ms,
        "qps": SWEEP_QUERIES * len(SWEEP_ALPHAS) / sweep_ms * 1e3,
        "rows_scored": {str(a): len(r._df) for a, r in swept.items()}, "pairs": n_sweep,
    }
    n_k1 = k1_phase_launches("early_stopping")
    check(n_k1 >= 1, "early stopping ran no K1 launch")
    log(f"[alpha sweep] {SWEEP_QUERIES} x {SWEEP_DEPTH}, depths {SWEEP_DEPTHS}: first pass "
        f"{sweep_first_ms:.1f} ms, median pass {sweep_ms:.2f} ms "
        f"({flows['alpha_sweep']['qps']:.1f} QPS); K1 launches in phase 14: {n_k1}")
    # fresh rankings for the cold call's traces (a retried trace after the
    # last of them is a warm call, which launches nothing and stays incomplete)
    fresh = iter([Ranking.from_run(run, queries=queries) for _ in range(3)])
    for label, fn, kernels, copy in (
        ("es_cold", lambda: index(next(fresh, es_warm_rank), **ES_KWARGS),
         CALL_KERNELS["pairwise"], True),
        ("es_warm", lambda: index(es_warm_rank, **ES_KWARGS), (), False),
    ):
        flows[label]["profile"] = profile_flow(fn, kernels, needs_copy=copy)
        log(f"[profile {label}]", json.dumps(flows[label]["profile"]))
    del es_rankings, es_first, es_cold, es_warm, es_served, sweep_rank, swept, fresh

    # -- 15. preload of a second flagship index with the u16 transport --------------
    t0 = time.perf_counter()
    u16_index = InMemoryIndex(
        query_encoder=LambdaEncoder(by_text.__getitem__),
        mode=Mode.PASSAGE,
        precision="high",
        score_transport="u16",
    )
    u16_index.add(corpus, doc_ids=doc_ids, psg_ids=psg_ids)
    log(f"[setup] u16 index of {N} rows in {time.perf_counter() - t0:.1f} s")
    user_encoder = u16_index.query_encoder
    tiers = []
    auto = sk.stream_select_auto

    def auto_tier(*args, precision="exact", **kwargs):
        # a 2D fp32 table goes to K1, exact unless the tier is "fast"
        tiers.append(precision != "fast")
        return auto(*args, precision=precision, **kwargs)

    reset_counts(wrappers)
    sk.stream_select_auto = auto_tier
    try:
        t0 = time.perf_counter()
        preloaded = u16_index.preload(warm=(QUERIES, DEPTH), serve=(ALPHA, CUTOFF, REFINE))
        torch.cuda.synchronize()
        preload_s = time.perf_counter() - t0
    finally:
        sk.stream_select_auto = auto
    n_k1 = k1_phase_launches("preload")
    check(preloaded is True, f"preload returned {preloaded}")
    check(n_k1 == len(tiers) >= 2 and sorted(set(tiers)) == [False, True],
          f"preload launched K1 {n_k1} times in {len(tiers)} calls, exact {sorted(set(tiers))}")
    check(not u16_index._plans, "preload left a plan behind")
    check(u16_index.query_encoder is user_encoder, "preload did not restore the encoder")
    stats = dict(u16_index._preload_stats)
    check({"overlap", "upload_s", "build_s", "warm_rerank_s", "warm_serve_s"} <= set(stats),
          f"preload stats lack a key: {stats}")
    loaded = set(_build._libs)
    reset_counts(wrappers)
    t0 = time.perf_counter()
    u16_first = u16_index(ranking)
    torch.cuda.synchronize()
    u16_first_ms = (time.perf_counter() - t0) * 1e3
    u16_ms, u16_warm = timed_calls(lambda: u16_index(ranking), WARM_CALLS)
    check(set(_build._libs) == loaded, "a call after preload built or loaded a kernel")
    check(u16_first == u16_warm, "u16: the first and the warm re-rank disagree")
    flows["preload"] = {"s": preload_s, "stats": stats, "first_call_ms": u16_first_ms,
                        "warm_ms": u16_ms, "k1_launches": n_k1}
    log(f"[preload] {preload_s:.1f} s, stats {json.dumps(stats)}; K1 launches {n_k1} (tiers "
        f"{sorted(set(tiers))}); first real call {u16_first_ms:.1f} ms, warm median {u16_ms:.2f} ms")

    # -- 16. the u16 score transport: passage and MAXP, beside f32 ------------------
    f32_ms, f32_warm = timed_calls(lambda: index(ranking), WARM_CALLS)
    err, half_step = check_u16_against_f32(u16_warm, f32_warm, "u16 re-rank")
    span = half_step * 131070
    check_rerank(u16_warm, u16_exact(exact_p, span), "u16 re-rank")
    flows["u16_rerank"] = {"first_ms": u16_first_ms, "warm_ms": u16_ms, "f32_warm_ms": f32_ms,
                           "qps": QUERIES / u16_ms * 1e3, "max_err_vs_f32": err,
                           "half_step": half_step}
    u16_index.mode = index.mode = Mode.MAXP
    t0 = time.perf_counter()
    u16_doc_first = u16_index(doc_rank)
    torch.cuda.synchronize()
    u16_doc_first_ms = (time.perf_counter() - t0) * 1e3
    u16_doc_ms, u16_doc = timed_calls(lambda: u16_index(doc_rank), WARM_CALLS)
    f32_doc_ms, f32_doc = timed_calls(lambda: index(doc_rank), WARM_CALLS)
    check(u16_doc_first == u16_doc, "u16 MAXP: the first and the warm re-rank disagree")
    err, half_step = check_u16_against_f32(u16_doc, f32_doc, "u16 MAXP re-rank")
    check_rerank(u16_doc, u16_exact(exact_doc["MAXP"], half_step * 131070), "u16 MAXP re-rank")
    n_k1 = k1_phase_launches("u16")
    check(n_k1 == 2 * (1 + WARM_CALLS) + 2 * WARM_CALLS, f"u16 and f32 re-ranks ran K1 {n_k1} times")
    flows["u16_doc_maxp_rerank"] = {"first_ms": u16_doc_first_ms, "warm_ms": u16_doc_ms,
                                    "f32_warm_ms": f32_doc_ms, "qps": QUERIES / u16_doc_ms * 1e3,
                                    "max_err_vs_f32": err, "half_step": half_step}
    index.mode = Mode.PASSAGE
    log(f"[u16] warm median re-rank u16 {u16_ms:.2f} ms vs f32 {f32_ms:.2f} ms; MAXP u16 "
        f"{u16_doc_ms:.2f} ms vs f32 {f32_doc_ms:.2f} ms (first u16 MAXP call "
        f"{u16_doc_first_ms:.1f} ms)")
    del u16_index, u16_first, u16_warm, u16_doc_first, u16_doc, f32_warm, f32_doc
    torch.cuda.empty_cache()

    # -- 17. BatchingServer over the flagship index (the array path, K1) ------------
    from fastforward_tpu_torch.utils.serving import BatchingServer

    def serve_phase(label, run_s, queries_s, mode, refine):
        """64 requests of 8 queries through a BatchingServer, checked against
        each request's own serve(), beside the sequential serve() loop."""
        index.mode = mode
        requests = split_requests(run_s, queries_s, SERVER_REQUEST_QUERIES, Ranking)
        index.serve(requests[0], ALPHA, CUTOFF, refine=refine)  # the per-request shape, warm
        reset_counts(wrappers)
        t0 = time.perf_counter()
        want = [index.serve(r, ALPHA, CUTOFF, refine=refine) for r in requests]
        seq_s = time.perf_counter() - t0
        n_seq = k1_phase_launches(f"{label}_sequential")
        check(n_seq == len(requests), f"{label}: sequential serve ran K1 {n_seq} times")
        arrays = []
        # host seconds spent in each step of the array path, summed over the
        # threads that run it: per-request prep (resolver pool), the batch's
        # merge + scoring + tail launch, its result copy, the fan-out
        spent = dict.fromkeys(("prep", "arrays", "fetch", "fanout"), 0.0)
        spent_lock = threading.Lock()

        def timed(key, fn):
            def run(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    with spent_lock:
                        spent[key] += time.perf_counter() - t0
            return run

        serve_arrays = timed("arrays", index._serve_arrays)

        def counted(*args, **kwargs):
            arrays.append(1)
            finish = serve_arrays(*args, **kwargs)
            return None if finish is None else timed("fetch", finish)

        index._serve_arrays = counted
        index._serve_prep = timed("prep", index._serve_prep)
        waves, continuous_s = [], None
        try:
            with BatchingServer(index, ALPHA, CUTOFF, max_batch_queries=SERVER_BATCH_QUERIES,
                                max_wait_ms=SERVER_WAIT_MS, prep_workers=2, refine=refine) as server:
                server._dispatch_merged = lambda batch: check(False, f"{label}: frame path taken")
                server._fanout_arrays = timed("fanout", server._fanout_arrays)
                server.serve(requests[0])  # the server path, warm
                reset_counts(wrappers)
                arrays.clear()
                spent.update(dict.fromkeys(spent, 0.0))
                with ThreadPoolExecutor(SERVER_CLIENTS) as pool:
                    for _ in range(SERVER_WAVES):  # round-synchronized waves
                        t0 = time.perf_counter()
                        got = [f.result() for f in list(pool.map(server.submit, requests))]
                        waves.append(time.perf_counter() - t0)
                        check_same_served(got, want, f"{label} wave")
                    wave_host_ms = {k: v / SERVER_WAVES * 1e3 for k, v in spent.items()}
                    wave_batches = len(arrays) / SERVER_WAVES
                    if refine is None and mode is Mode.PASSAGE:  # a backlog: waves in flight
                        t0 = time.perf_counter()
                        futures = list(pool.map(server.submit, requests * SERVER_WAVES))
                        got = [f.result() for f in futures]
                        continuous_s = time.perf_counter() - t0
                        check_same_served(got, want * SERVER_WAVES, f"{label} continuous")
                    # one more wave under the profiler (every thread's spans)
                    wave_profile = profile_flow(
                        lambda: [f.result() for f in list(pool.map(server.submit, requests))],
                        CALL_KERNELS["pairwise_fast" if refine else "pairwise"],
                    )
        finally:
            del index._serve_arrays, index._serve_prep
        n_k1 = k1_phase_launches(label)
        check(n_k1 >= 1 and len(arrays) >= 1, f"{label}: K1 {n_k1} launches, {len(arrays)} "
              "array-path batches")
        n_q = len(run_s)
        row = {"requests": len(requests), "queries": n_q, "batches": len(arrays),
               "k1_launches": n_k1, "wave_s": waves, "qps": n_q / float(np.median(waves)),
               "wave_batches": wave_batches, "wave_host_ms": wave_host_ms,
               "sequential_s": seq_s, "sequential_qps": n_q / seq_s}
        if continuous_s is not None:
            row.update(continuous_s=continuous_s, continuous_qps=n_q * SERVER_WAVES / continuous_s)
        row["profile"] = wave_profile
        log(f"[profile {label} wave]", json.dumps(wave_profile))
        log(f"[{label}] {len(requests)} requests x {SERVER_REQUEST_QUERIES} queries: server "
            f"{row['qps']:.1f} QPS (median of {len(waves)} waves, {len(arrays)} array-path "
            f"batches, K1 {n_k1} launches; host ms a wave, summed over threads: "
            f"{json.dumps(wave_host_ms)})"
            + (f", continuous {row['continuous_qps']:.1f} QPS" if continuous_s else "")
            + f"; sequential serve() {row['sequential_qps']:.1f} QPS")
        index.mode = Mode.PASSAGE
        return row

    flows["server"] = serve_phase("server", run, queries, Mode.PASSAGE, None)
    flows["server_refine"] = serve_phase("server_refine", run, queries, Mode.PASSAGE, REFINE)
    flows["server_doc_maxp"] = serve_phase("server_doc_maxp", doc_run, queries, Mode.MAXP, None)

    # -- 18. the query towers on the card at full width ---------------------------
    flows.update(tower_phase(index, ranking, run, queries, corpus_dev, q_index, wrappers,
                             launches, rates, name))
    index.query_encoder = LambdaEncoder(by_text.__getitem__)
    torch.cuda.empty_cache()

    # -- 19. the disk index: a round trip, and config #2's disk half at full width --------
    flows["disk"] = disk_phase(corpus, qvecs, wrappers, launches)
    mem_figures = {"add_s": mem_add_s, "upload_s": flows["preload"]["stats"]["upload_s"],
                   "warm_ms": flows["doc_maxp_rerank"]["warm_ms"]}
    flows["disk_doc"] = disk_doc_phase(corpus, doc_ids, doc_counts, doc_starts, by_text, doc_rank,
                                       exact_doc["MAXP"], mem_maxp, mem_figures, wrappers, launches)
    flows["disk_doc"]["in_memory"] = mem_figures
    del mem_maxp

    # -- 20. the hybrid tier beyond device memory, dense fp32 (K1) --------------------
    flows.update(hybrid_dense_phase(corpus, doc_ids, psg_ids, by_text, ranking, doc_rank, run, queries,
                                    index, exact_p, exact_doc, wrappers, launches, rates, held))

    # -- 22. the device store -----------------------------------------------------------
    flows["device_store"] = device_store_phase(corpus, doc_ids, psg_ids, by_text, ranking, index,
                                               wrappers, launches)

    # -- 23. the progressive (split-plane) preload ---------------------------------------
    flows["progressive"] = progressive_phase(
        corpus, doc_ids, psg_ids, by_text, ranking, run, index, corpus_dev, qvecs_dev, q_index,
        wrappers, launches, flows["preload"]["stats"]["upload_s"],
    )

    # -- 6. K1 vs plain on the main path's inputs, timed ---------------------
    cand3, tile_idx, q_dev = main_inputs
    table = index._device_view().table
    log(f"[kernel-flagship] K1 vs plain on the re-rank's own layout {tuple(cand3.shape)}")
    t8 = torch.randint(-127, 128, (table.shape[0], DIM // 128, 128), dtype=torch.int8,
                       device="cuda", generator=torch.Generator("cuda").manual_seed(SEED))
    variants = {"stream_select_pairwise": []}
    for label, tab in (("fp32", table), ("bf16", table.to(torch.bfloat16)), ("int8", t8)):
        rows_k1 = pairwise_variants(sk, tab, q_dev, cand3, tile_idx, DIM, ("exact", "fast"), True,
                                    rates, label)
        for row in rows_k1:
            row.update(table=label, exact=row["variant"].endswith("exact"))
            split_call(row, lambda t=tab, e=row["exact"]: sk.stream_select_pairwise(
                t, q_dev, cand3, tile_idx, exact=e),
                CALL_KERNELS["dense" if label != "fp32" else "pairwise" if row["exact"] else "pairwise_fast"])
        variants["stream_select_pairwise"] += rows_k1
    # the query-major body on the same fp32 layout, through K2's entry (3D
    # fp32 tables go to K2), to hold against K1's fp32 body in this run
    log("[kernel-flagship] the query-major body (K2's entry) on the fp32 layout, beside K1's fp32 body")
    table3 = table.view(table.shape[0], DIM // 128, 128)
    fp32_query_major = select_variants(sk, table3, q_dev, cand3, tile_idx, DIM, ("exact",), True,
                                       rates, "fp32 on K1's layout")[0]
    split_call(fp32_query_major, lambda: sk.stream_select(table3, q_dev.t(), cand3, tile_idx),
               CALL_KERNELS["dense"])
    # K1 fp32 on the MAXP layout (cap 1024 > r), and on the same pairs' real
    # rows without the K-padding, to show what the padding costs
    cand_d, tile_d, q_d = doc_inputs
    log(f"[kernel-flagship] K1 fp32 on the MAXP layout {tuple(cand_d.shape)}")
    doc_row = pairwise_variants(sk, table, q_d, cand_d, tile_d, DIM, ("exact",), True, rates,
                                "fp32 doc")[0]
    doc_row.update(table="fp32", exact=True)
    split_call(doc_row, lambda: sk.stream_select_pairwise(table, q_d, cand_d, tile_d),
               CALL_KERNELS["pairwise"])
    real_plan = {}
    real_layout = scoring._cached_layout("stream", table.shape[0], doc_plan["q_dev"][0], real_rows,
                                         real_qno, sk.KERNEL_TILE_ROWS, real_plan, table.device)
    unpadded = pairwise_variants(sk, table, q_d, *real_layout[:2], DIM, ("exact",), True, rates,
                                 "fp32 doc unpadded")[0]
    unpadded.update(table="fp32", exact=True)
    variants["stream_select_pairwise"] += [doc_row, unpadded]
    log(f"  K-padding: {doc_row['ms']:.4f} ms padded ({cand_d.numel()} slots) against "
        f"{unpadded['ms']:.4f} ms for the real rows alone ({real_layout[0].numel()} slots)")
    # the flagship index and the corpus on the card stay for phase 25
    del table, table3, t8, main_inputs, cand3, tile_idx, q_dev, plan
    del doc_plan, doc_inputs, cand_d, tile_d, q_d, real_layout, real_plan, exact_p, exact_doc
    torch.cuda.empty_cache()

    # -- 7. int8 at full width (K1); 13. int8 MAXP (K2) ---------------------------
    t0 = time.perf_counter()
    sq = ScalarQuantizer()
    sq.fit(corpus[:QUANT_FIT])
    int8_index = InMemoryIndex(
        query_encoder=LambdaEncoder(by_text.__getitem__),
        quantizer=sq,
        mode=Mode.PASSAGE,
        precision="high",
        init_size=N,
    )
    add_in_chunks(int8_index, corpus, psg_ids, doc_ids)
    int8_rows = scalar_rows(int8_index._store[:N], sq.scales)
    log(f"[setup] int8 index of {N} rows built in {time.perf_counter() - t0:.1f} s")
    phase, launches["int8"] = index_phase(
        "int8", int8_index, ranking, wrappers, want="stream_select_pairwise",
        forbid=("stream_select",), kernels=CALL_KERNELS["dense"],
        exact=passage_exact(int8_rows, qvecs_dev, q_index, DIM), run=run,
    )
    flows.update(phase)
    int8_index.mode = Mode.MAXP
    phase, launches["int8_doc_maxp"] = index_phase(
        "int8_doc_maxp", int8_index, doc_rank, wrappers, want="stream_select",
        forbid=("stream_select_pairwise",), kernels=CALL_KERNELS["dense"],
        exact=doc_exact(int8_rows, qvecs_dev, q_index, doc_counts, doc_starts, "max", DIM),
        run=doc_run,
    )
    flows.update(phase)
    log(f"[int8 doc] MAXP launched K2 {launches['int8_doc_maxp']['stream_select']} times")
    k2_doc_plan = int8_index._get_plan(doc_rank)
    k2_doc_inputs = (int8_index._device_view().table, k2_doc_plan["q_dev"][1],
                     *k2_doc_plan["stream"][:2])
    # -- 21. the hybrid tier over the same int8 codes (K1, K2) ----------------------
    flows.update(hybrid_quantized_phase(
        "hybrid_int8", "scalar", int8_index, HYBRID_INT8_BUDGET, 0, (ranking, doc_rank),
        (passage_exact(int8_rows, qvecs_dev, q_index, DIM),
         doc_exact(int8_rows, qvecs_dev, q_index, doc_counts, doc_starts, "max", DIM)),
        wrappers, launches, rates, held, doc_ids, psg_ids, by_text,
    ))
    del int8_index, int8_rows, k2_doc_plan

    # -- 8. int8 with dense tiles (K2) ----------------------------------------
    t0 = time.perf_counter()
    dense_corpus = corpus[:DENSE_N]
    dense_run = make_run(DENSE_N, "p", QUERIES, DEPTH, SEED + 1)
    dense_rank = Ranking.from_run(dense_run, queries=queries)
    dense_int8 = InMemoryIndex(
        query_encoder=LambdaEncoder(by_text.__getitem__),
        quantizer=sq,
        mode=Mode.PASSAGE,
        precision="high",
        init_size=DENSE_N,
    )
    add_in_chunks(dense_int8, dense_corpus, psg_ids)
    dense_int8_rows = scalar_rows(dense_int8._store[:DENSE_N], sq.scales)
    log(f"[setup] dense-tile run and int8 index of {DENSE_N} rows in "
        f"{time.perf_counter() - t0:.1f} s")
    phase, launches["int8_dense"] = index_phase(
        "int8_dense", dense_int8, dense_rank, wrappers, want="stream_select",
        forbid=("stream_select_pairwise",), kernels=CALL_KERNELS["dense"],
        exact=passage_exact(dense_int8_rows, qvecs_dev, q_index, DIM), run=dense_run,
    )
    flows.update(phase)
    k2_plan = dense_int8._get_plan(dense_rank)
    k2_inputs = (dense_int8._device_view().table, k2_plan["q_dev"][1], *k2_plan["stream"][:2])
    del dense_int8_rows
    # device memory of one warm int8 dense serve, and K2's grouping scratch within it
    scratch = 8 * query_groups.scratch_words(k2_inputs[1].shape[0], k2_inputs[2].numel())
    memory = serve_memory(dense_int8, dense_rank, {"k2_grouping_scratch_bytes": scratch})
    flows["int8_dense_serve"]["device_memory"] = memory
    log(f"[int8 dense memory] one warm serve: {json.dumps(memory)}")
    del dense_int8

    # -- 9. PQ at full width (K3); 13. PQ MAXP (K4) ---------------------------------
    t0 = time.perf_counter()
    check_fit(PQ, PQ_M, PQ_KS)
    log(f"[fit-check] in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pq = PQ(PQ_M, PQ_KS)
    pq.fit(corpus[:QUANT_FIT])
    fit_s = time.perf_counter() - t0
    pq_index = InMemoryIndex(
        query_encoder=LambdaEncoder(by_text.__getitem__),
        quantizer=pq,
        mode=Mode.PASSAGE,
        precision="exact",
        init_size=N,
    )
    add_in_chunks(pq_index, corpus, psg_ids, doc_ids)
    pq_ref = pq_rows(pq_index._store[:N], pq.codewords)
    log(f"[setup] PQ({PQ_M}, {PQ_KS}) fitted on the card in {fit_s:.1f} s; {N} rows encoded "
        f"in {time.perf_counter() - t0 - fit_s:.1f} s")
    check_encode("PQ", pq, pq_index._store[:N], corpus)
    phase, launches["pq"] = index_phase(
        "pq", pq_index, ranking, wrappers, want="stream_select_pq_pairwise",
        forbid=("stream_select_pq",), kernels=CALL_KERNELS["adc"],
        exact=passage_exact(pq_ref, qvecs_dev, q_index, DIM), run=run,
    )
    flows.update(phase)
    view = pq_index._device_view()
    k3_plan = pq_index._get_plan(ranking)
    k3_inputs = (view.table, view.codebooks, k3_plan["q_dev"][1], *k3_plan["stream_pq"][:2])
    pq_index.mode = Mode.MAXP
    phase, launches["pq_doc_maxp"] = index_phase(
        "pq_doc_maxp", pq_index, doc_rank, wrappers, want="stream_select_pq",
        forbid=("stream_select_pq_pairwise",), kernels=CALL_KERNELS["adc"],
        exact=doc_exact(pq_ref, qvecs_dev, q_index, doc_counts, doc_starts, "max", DIM),
        run=doc_run,
    )
    flows.update(phase)
    log(f"[pq doc] MAXP launched K4 {launches['pq_doc_maxp']['stream_select_pq']} times")
    k4_doc_plan = pq_index._get_plan(doc_rank)
    k4_doc_inputs = (view.table, view.codebooks, k4_doc_plan["q_dev"][1],
                     *k4_doc_plan["stream_pq"][:2])
    # -- 19 (its PQ half, on phase 9's quantizer): a PQ disk index, MAXP (K4) ------------
    flows["disk_pq"] = disk_pq_phase(
        corpus, doc_ids, by_text, doc_rank, pq, pq_index._store[:N],
        doc_exact(pq_ref, qvecs_dev, q_index, doc_counts, doc_starts, "max", DIM), wrappers, launches)
    # -- 21. the hybrid tier over the same PQ codes (K3, K4) ------------------------
    flows.update(hybrid_quantized_phase(
        "hybrid_pq", "pq", pq_index, HYBRID_PQ_BUDGET, view.codebooks.numel() * 4,
        (ranking, doc_rank),
        (passage_exact(pq_ref, qvecs_dev, q_index, DIM),
         doc_exact(pq_ref, qvecs_dev, q_index, doc_counts, doc_starts, "max", DIM)),
        wrappers, launches, rates, held, doc_ids, psg_ids, by_text,
    ))
    del pq_ref, k4_doc_plan

    # -- 10. OPQ with dense tiles (K4) -----------------------------------------
    t0 = time.perf_counter()
    opq = OPQ(PQ_M, PQ_KS)
    opq.fit(dense_corpus[:QUANT_FIT])
    fit_s = time.perf_counter() - t0
    opq_index = InMemoryIndex(
        query_encoder=LambdaEncoder(by_text.__getitem__),
        quantizer=opq,
        mode=Mode.PASSAGE,
        precision="exact",
        init_size=DENSE_N,
    )
    add_in_chunks(opq_index, dense_corpus, psg_ids)
    opq_ref = pq_rows(opq_index._store[:DENSE_N], opq.codewords)
    # float64 (q @ R): the reference does not reuse the index's fp32 rotation
    rotated_dev = qvecs_dev.double() @ torch.from_numpy(opq.R).cuda().double()
    log(f"[setup] OPQ({PQ_M}, {PQ_KS}, {opq._opq_iters} iterations) fitted in {fit_s:.1f} s; "
        f"{DENSE_N} rows encoded in {time.perf_counter() - t0 - fit_s:.1f} s")
    check_encode("OPQ", opq, opq_index._store[:DENSE_N], dense_corpus)
    phase, launches["opq_dense"] = index_phase(
        "opq_dense", opq_index, dense_rank, wrappers, want="stream_select_pq",
        forbid=("stream_select_pq_pairwise",), kernels=CALL_KERNELS["adc"],
        exact=passage_exact(opq_ref, rotated_dev, q_index, DIM), run=dense_run,
    )
    flows.update(phase)
    view = opq_index._device_view()
    k4_plan = opq_index._get_plan(dense_rank)
    k4_inputs = (view.table, view.codebooks, k4_plan["q_dev"][1], *k4_plan["stream_pq"][:2])
    del opq_ref
    # device memory of one warm OPQ serve, and K4's scratch within it
    qb_opq = k4_inputs[2].shape[0]
    memory = serve_memory(opq_index, dense_rank, {
        "k4_grouping_scratch_bytes": 8 * skpq.adc_scratch_words(qb_opq, k4_inputs[3].numel()),
        "k4_lut_scratch_bytes": 4 * 256 * PQ_M * skpq.adc_table_queries(qb_opq, PQ_M),
    })
    flows["opq_dense_serve"]["device_memory"] = memory
    log(f"[opq memory] one warm serve: {json.dumps(memory)}")

    # -- 11. K2, K3, K4 vs plain on the main path's layouts, timed ------------------
    log(f"[kernel-flagship] K2 on the int8 dense-tile layout {tuple(k2_inputs[2].shape)} and the "
        f"int8 MAXP layout {tuple(k2_doc_inputs[2].shape)}, K3 on the PQ layout "
        f"{tuple(k3_inputs[3].shape)}, K4 on the OPQ layout {tuple(k4_inputs[3].shape)} and the "
        f"PQ MAXP layout {tuple(k4_doc_inputs[3].shape)}")
    variants["stream_select"] = (
        select_variants(sk, *k2_inputs, DIM, ("high", "fast"), True, rates, "int8")
        + select_variants(sk, *k2_doc_inputs, DIM, ("high",), True, rates, "int8 doc")
    )
    variants["stream_select_pq_pairwise"] = pq_variants(skpq, "K3", *k3_inputs, ("exact",), True,
                                                        rates, "pq")
    variants["stream_select_pq"] = (
        pq_variants(skpq, "K4", *k4_inputs, ("exact",), True, rates, "opq")
        + pq_variants(skpq, "K4", *k4_doc_inputs, ("exact",), True, rates, "pq doc")
    )
    for row, (table_k2, q_k2, cand_k2, tile_k2), tier in zip(
        variants["stream_select"], (k2_inputs, k2_inputs, k2_doc_inputs), ("high", "fast", "high")
    ):
        split_call(row, lambda t=table_k2, q=q_k2, c=cand_k2, ti=tile_k2, p=tier: sk.stream_select(
            t, q.t(), c, ti, precision=p), CALL_KERNELS["dense"])
    for kname, row, (codes_m, cb_m, q_m, cand_m, tile_m) in (
        ("stream_select_pq_pairwise", variants["stream_select_pq_pairwise"][0], k3_inputs),
        ("stream_select_pq", variants["stream_select_pq"][0], k4_inputs),
        ("stream_select_pq", variants["stream_select_pq"][1], k4_doc_inputs),
    ):
        call = getattr(skpq, kname)
        q_arg = q_m if kname == "stream_select_pq_pairwise" else q_m.t()
        split_call(row, lambda call=call, c=codes_m, cb=cb_m, q=q_arg, cd=cand_m, t=tile_m: call(
            c, cb, q, cd, t), CALL_KERNELS["adc"])

    # -- 24. PQ codes wider than uint8: PQ(96, 1024) (K3, K4), its hybrid tier ------------
    flows.update(pq_wide_phase(corpus, doc_ids, psg_ids, by_text, ranking, doc_rank, run, doc_run,
                               q_index, qvecs_dev, doc_counts, doc_starts, wrappers, launches, rates,
                               held))

    # -- 25. sharded scoring on the card, one process, two shards (K1, K3) -----------------
    flows.update(sharded_phase(index, pq_index, ranking, doc_rank, sparse, corpus, corpus_dev,
                               qvecs_dev, wrappers, launches, rates))
    del index, corpus_dev
    torch.cuda.empty_cache()

    # -- 26. two processes on the card through the public API (K1) ---------------------
    flows["multiprocess"] = multiprocess_phase(MP_N)
    for res in flows["multiprocess"]["processes"]:
        launches[f"multiprocess_rank{res['rank']}"] = res["launches"]

    # -- 27. the contract suites' hard cases at full width (K1-K4) ------------------------
    flows["contract"] = contract_phase(corpus, sq, pq, wrappers, launches)

    # -- 28. the decoder tower's kernels at E5-Mistral-7B's widths -------------------------
    decoder_summary = decoder_phase(rates)

    # -- 29. the expert tower's kernels at Moonlight-16B-A3B's widths ----------------------
    decoder_summary += moe_phase(rates, card_bf16_rate(name))

    small_by_kernel = {"stream_select_pairwise": "K1", "stream_select": "K2",
                       "stream_select_pq_pairwise": "K3", "stream_select_pq": "K4"}
    for kname, rows_k in held.items():
        variants[kname] += rows_k
    vet_profiles(flows, variants)

    summary = []
    for kname, (source, replaces) in KERNELS.items():
        rows_k = variants[kname]
        main = rows_k[0]  # the main path's table and tier
        errs = [v["max_abs_err"] for v in rows_k]
        if kname in small_by_kernel:
            errs += [v["max_abs_err"] for v in small if v["variant"].startswith(small_by_kernel[kname])]
        summary.append({
            "name": kname,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": sum(counts[kname] for counts in launches.values()),
            "max_abs_err": max(errs),
            "tolerance": "8 * sqrt(dim) * 2^-24 * sum|terms| per slot",
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            # no single PyTorch call computes a per-slot gathered dot / ADC
            "library_ms": None,
            "launches_by_phase": {ph: counts[kname] for ph, counts in launches.items()},
            "variants": rows_k,
        })
    summary[0]["fp32_query_major_body"] = fp32_query_major
    summary += decoder_summary
    forbidden = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "fastforward_tpu."))
                 or m == "fastforward_tpu"]
    check(not forbidden, f"JAX or the JAX package was imported: {forbidden[:5]}")
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    log("flows:", json.dumps(flows))
    log(smi_line())
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--multiprocess-child":
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device is available", file=sys.stderr)
            sys.exit(2)
        sys.exit(multiprocess_child(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])))
    sys.exit(main())
