"""The TCT-ColBERT query tower (``TCTColBERTQueryEncoder``) on weights made
from the seed.

The program gets the port's encoder, opened on a checkpoint directory that
holds only the tokenizer's vocabulary: transformers' model loader hands
back the seeded weights for that directory instead of reading a weight
file.  The reference runs its own BERT forward pass on the same weights
(``reference.encode_queries``).
"""

import tempfile
from contextlib import contextmanager
from pathlib import Path
from types import SimpleNamespace

from bench_port import data, roofline
from bench_port import reference as plain


@contextmanager
def seeded_checkpoint(weights: dict, tower: dict, vocab: list):
    """A checkpoint directory the transformer encoders open, whose weights
    are the seeded tensors in memory."""
    import transformers
    from transformers import BertTokenizer

    loader = transformers.AutoModel.from_pretrained
    hf_config = SimpleNamespace(model_type="bert", **tower)

    class Seeded:
        config = hf_config

        @staticmethod
        def state_dict():
            return weights

    with tempfile.TemporaryDirectory(prefix="bench-port-tower-") as tmp:
        path = Path(tmp)
        (path / "vocab.txt").write_text("\n".join(vocab))
        BertTokenizer(str(path / "vocab.txt")).save_pretrained(path)

        def load(name, *args, **kwargs):
            if Path(name) == path:
                return Seeded()
            return loader(name, *args, **kwargs)

        transformers.AutoModel.from_pretrained = staticmethod(load)
        try:
            yield path
        finally:
            transformers.AutoModel.from_pretrained = loader


def make(config: dict, seed: int, texts: list, device) -> tuple:
    """The program's encoder, and the weights and vocabulary the reference
    takes."""
    from fastforward_tpu_torch.encoder import TCTColBERTQueryEncoder

    tower = config["tower"]
    vocab = data.vocabulary(tower["vocab_size"])
    weights = data.tower_weights(seed, tower, device)
    with seeded_checkpoint(weights, tower, vocab) as path:
        encoder = TCTColBERTQueryEncoder(str(path), device=device, max_length=config["query_tokens"])
    return encoder, {"weights": weights, "vocab": vocab}


def reference(texts: list, inputs: dict, config: dict, precision: str, device):
    """The reference's query vectors of ``texts``."""
    return plain.encode_queries(texts, inputs["weights"], config["tower"], inputs["vocab"],
                                    config["query_tokens"], precision, device)


def least_s(config: dict, n_queries: int) -> float:
    """Least time of encoding ``n_queries`` queries: the tower's matmul
    operations at the fp32 peak."""
    return (roofline.tower_flops(config["tower"], n_queries, config["query_tokens"])
            / roofline.PEAKS["fp32_flops_per_s"])
