"""fastforward_tpu_torch — the PyTorch/CUDA port of fastforward_tpu.

Interpolation-based re-ranking (Fast-Forward indexes) on one NVIDIA GPU:
dense passage embeddings live in a device table, each (query, passage)
candidate gets a dot-product semantic score, and lexical and semantic
scores are interpolated as ``alpha * lexical + (1 - alpha) * semantic``.
The scoring kernel is hand-written CUDA for Hopper (``ops/csrc``); indexes
run on the card unless the caller passes ``device="cpu"``.

Subpackages mirror ``fastforward_tpu``:

- ``ranking`` — host-side run I/O and score algebra (``Ranking``).
- ``encoder`` — the encoder contract, ``LambdaEncoder`` and the transformer
  encoders (``TCTColBERTQueryEncoder``, ...; imported on first use).
- ``models`` — the BERT/DistilBERT tower the transformer encoders run.
- ``index`` — the vector store + scoring engine (``InMemoryIndex``,
  ``OnDiskIndex``).
- ``ops`` — kernels and tensor programs of the hot path.
- ``runtime`` — the native id map and layout builder.
- ``convert`` — building indexes from arrays or another index's triples.
"""

from fastforward_tpu_torch import encoder, index
from fastforward_tpu_torch.index import InMemoryIndex, Mode
from fastforward_tpu_torch.ranking import Ranking

__all__ = ["encoder", "index", "InMemoryIndex", "Mode", "Ranking"]
__version__ = "0.1.0"
