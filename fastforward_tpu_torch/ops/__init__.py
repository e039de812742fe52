"""Device ops: the scoring kernels and tensor programs of the index hot path."""

from fastforward_tpu_torch.ops.scoring import (
    STREAM_DENSITY,
    bucket,
    build_streamed_layout,
    decode_serve_topk,
    fetch_np,
    fetch_np_async,
    fetch_np_overlapped,
    interpolate_scores,
    masked_reduce_host,
    pad_i32,
    score_pairs_bounded,
    serve_topk,
    serve_topk_host,
    serve_topk_refine,
    streamed_scores,
)
from fastforward_tpu_torch.ops.stream_kernel import (
    KERNEL_CAP,
    KERNEL_TILE_ROWS,
    stream_select_pairwise,
    stream_select_pairwise_plain,
)

__all__ = [
    "KERNEL_CAP",
    "KERNEL_TILE_ROWS",
    "STREAM_DENSITY",
    "bucket",
    "build_streamed_layout",
    "decode_serve_topk",
    "fetch_np",
    "fetch_np_async",
    "fetch_np_overlapped",
    "interpolate_scores",
    "masked_reduce_host",
    "pad_i32",
    "score_pairs_bounded",
    "serve_topk",
    "serve_topk_host",
    "serve_topk_refine",
    "stream_select_pairwise",
    "stream_select_pairwise_plain",
    "streamed_scores",
]
