"""The yardstick's arithmetic: the chip's peaks and the least work of a call.

The work is counted from the cell's own inputs (its rankings and the
configuration), never from the program's layouts, so a change to how the
program lays out or pads its work does not move the yardstick.
"""

#: one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at its 700 W limit)
PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "fp32_flops_per_s": 67e12,
    "bf16_flops_per_s": 989e12,
}

FP32_BYTES = 4


def tower_flops(tower: dict, batch: int, length: int) -> float:
    """Matmul operations of one BERT tower call on ``batch`` sequences of
    ``length`` tokens: per layer and token ``2 (4 H^2 + 2 H I)`` for the
    projections and the FFN, per sequence ``4 L^2 H`` for the attention's
    logits and context."""
    h, i, n = tower["hidden_size"], tower["intermediate_size"], tower["num_hidden_layers"]
    tokens = batch * length
    return n * (2.0 * tokens * (4 * h * h + 2 * h * i) + 4.0 * batch * length * length * h)


def tower_bound(tower: dict, batch: int, length: int, rate: float, mem_rate: float,
                weight_bytes_per_value: int = FP32_BYTES) -> dict:
    """Least time of one tower call: its operations at ``rate`` against the
    layer weights, the tokens' embedding rows and the output read or
    written once at ``mem_rate``."""
    h, i, n = tower["hidden_size"], tower["intermediate_size"], tower["num_hidden_layers"]
    flops = tower_flops(tower, batch, length)
    weight_bytes = n * (4 * h * h + 2 * h * i + 9 * h + i) * weight_bytes_per_value
    moved = weight_bytes + batch * length * h * FP32_BYTES * 2
    flop_s, byte_s = flops / rate, moved / mem_rate
    return {"flops": flops, "bytes": moved, "bound_s": max(flop_s, byte_s),
            "bound_by": "operations" if flop_s >= byte_s else "bytes"}


def scoring_work(distinct_rows: int, scored_rows: int, n_queries: int, n_results: int,
                 dim: int) -> dict:
    """Least work of scoring a re-rank: each distinct candidate row read
    once, each query vector read once and one fp32 score a (query,
    candidate) written once; ``2 dim`` operations a scored (query, row)."""
    moved = (distinct_rows + n_queries) * dim * FP32_BYTES + n_results * FP32_BYTES
    return {"bytes": float(moved), "flops": 2.0 * dim * scored_rows}


def scoring_bound_s(work: dict, peaks: dict = PEAKS) -> float:
    """The scoring work's least time: bytes or operations, whichever is slower."""
    return max(work["bytes"] / peaks["hbm_bytes_per_s"], work["flops"] / peaks["fp32_flops_per_s"])
