"""Named ranges around the phases of a call.

:func:`annotate` opens a ``torch.profiler.record_function`` range: it costs
a few microseconds when no profiler runs, and under ``torch.profiler``
(host and CUDA activity) it names the host phase and, beside it on the
card, the device work launched inside it.  The ranges of the port:

Re-rank (``Index.__call__``)

- ``ff.call``: the whole call;
- ``ff.frame``: ``_numbered_frame``, the candidate record's numbered
  frame (``Index._candidates``): the frame's copy, the query factorize and
  the query list;
- ``ff.encode``: ``encode_queries``, every micro-batch of the encoder;
- ``ff.tokenize``: one micro-batch's tokenization on the host
  (``TransformerEncoder``);
- ``ff.tower``: one micro-batch on the tower's device, from the token
  upload through the pooled vectors' fetch (``TransformerEncoder``);
- ``ff.attn``: inside ``ff.tower``, one decoder layer's attention block on
  one micro-batch: the input norm, the q/k/v projections, RoPE, the
  attention, the output projection and the residual
  (``models.mistral.MistralTower``; BERT towers open none);
- ``ff.mlp``: inside ``ff.tower``, the same layer's MLP block: the
  post-attention norm, the gate and up projections, the SiLU product, the
  down projection and the residual;
- ``ff.resolve``: string ids to table rows, once a call (``Index._resolve``:
  the id column's resolve, or the factorize, ``_gather_view`` and the
  grouped or flat layout's expansion), with an ``OnDiskIndex``'s host read
  and upload where no table is on the card;
- ``ff.score``: the scoring's device work (grouped and flat);
- ``ff.layout``: the streamed layout's build on the host;
- ``ff.columns``: a new plan's query ranks, sort keys, per-query segments
  and categorical result columns, wrapped around the numbering the call
  already has (the query numbers of ``ff.frame``; the rows or the ids'
  factorize of ``ff.resolve``, numbered here by the id map's byte-order
  ranks, which the first such call after an add builds);
- ``ff.fetch_sort``: the score copy overlapped with the per-query sort;
- ``ff.assemble``: the result frame, the plan's update and the ranking.

Early stopping, serving and the tier beyond device memory

- ``ff.es_score``: one depth round's scoring under early stopping;
- ``ff.prep``: a server request's candidates (``_serve_prep``);
- ``ff.serve_tail``: a serve call's top-k tail on the device;
- ``ff.fetch``: a serve call's result copy, and the hybrid tier's score
  copy;
- ``ff.tail_gather``, ``ff.tail_copy``: a tail block gathered into pinned
  memory, and its copy to the card;
- ``ff.hybrid_resident``, ``ff.hybrid_tail``: the resident prefix's and
  the tail's scoring.

No range opens inside a range of its own name, so the time of a name is the
sum of its ranges.

The native per-pair passes inside four of these ranges run on a worker
pool of the host's cores once a pass has 2^15 items (``runtime/idmap.cc``):
in ``ff.resolve`` the resolve and its row fill, in ``ff.columns`` the id
numbering and the string gather, in ``ff.layout`` the tile count and the
fill, in ``ff.fetch_sort`` the per-query sort (a pass for each fetched
chunk).  ``runtime.idmap.pool_stats()`` counts, for the whole process, the
passes run wide and those run serially (below the grain, or while another
thread's pass holds the pool), with the pool's width: the difference of
two readings around a call splits those ranges' time between the two.
"""


def annotate(name: str):
    """Named range for a phase of a call (``torch.profiler.record_function``;
    a few microseconds when no profiler is running)."""
    import torch

    return torch.profiler.record_function(name)
