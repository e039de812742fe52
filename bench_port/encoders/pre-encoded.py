"""Pre-encoded queries, as Pyserini ships TCT-ColBERT's MS MARCO topics:
one standard normal fp32 vector a distinct text, made from the seed, which
the program reads through a ``LambdaEncoder`` and the reference takes as
they are."""

import numpy as np
import torch

from bench_port import data


def make(config: dict, seed: int, texts: list, device) -> tuple:
    """The program's encoder, and the vectors the reference takes."""
    from fastforward_tpu_torch.encoder import LambdaEncoder

    by_text = data.query_vectors(seed, texts, config["dim"])
    return LambdaEncoder(by_text.__getitem__), {"vectors": by_text}


def reference(texts: list, inputs: dict, config: dict, precision: str, device):
    """The vectors of ``texts`` as made (the same in every precision)."""
    return torch.from_numpy(np.stack([inputs["vectors"][t] for t in texts])).to(device)


def least_s(config: dict, n_queries: int) -> float:
    """Nothing to encode."""
    return 0.0
