"""E5-Mistral-7B-instruct's query tower (``E5MistralEncoder``) on weights
made from the seed, with its plain reference.

The program gets the port's encoder, opened on a checkpoint directory that
holds only a tokenizer: transformers' model loader hands back the seeded
weights, made tensor by tensor straight in the configuration's compute type
on the device, instead of reading a weight file, and the tower takes those
tensors as they are (one copy of the 7B weights on the card).  The
tokenizer is word-level (:func:`vocabulary`): Mistral's SentencePiece files
are not in the repository.

The reference is plain PyTorch written from the published description
(``tests/plain_mistral.py``'s equations, a second copy): the query
template, BOS and EOS, the decoder in float64, the EOS token's final
hidden state L2-normalized.  It goes layer by layer, making each layer's
weights again from the seed, so no copy of the whole tower is held, and
keeps ``matmul.allow_tf32`` and ``cudnn.allow_tf32`` off.  Its control
(``precision="tf32"``, the step below the configuration's bf16) rounds
both operands of every matmul to fp8 e4m3 with one per-tensor scale and
accumulates in fp32.
"""

import contextlib
import math
import tempfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from bench_port import data, roofline

#: the stream tag of the tower's tensors (``data.py``'s tags are 0-7)
TOWER_STREAM = 8

#: E5-Mistral's query template for MS MARCO passage retrieval (the model
#: card's), before the query's words
TEMPLATE = "Instruct: Given a web search query, retrieve relevant passages that answer the query\nQuery: "

#: Mistral's unknown, BOS and EOS tokens, ids 0-2 as in its tokenizer
SPECIALS = ("<unk>", "<s>", "</s>")

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

_LAYER = {
    "self_attn.q_proj.weight": lambda t: (t["num_attention_heads"] * t["head_dim"], t["hidden_size"]),
    "self_attn.k_proj.weight": lambda t: (t["num_key_value_heads"] * t["head_dim"], t["hidden_size"]),
    "self_attn.v_proj.weight": lambda t: (t["num_key_value_heads"] * t["head_dim"], t["hidden_size"]),
    "self_attn.o_proj.weight": lambda t: (t["hidden_size"], t["num_attention_heads"] * t["head_dim"]),
    "mlp.gate_proj.weight": lambda t: (t["intermediate_size"], t["hidden_size"]),
    "mlp.up_proj.weight": lambda t: (t["intermediate_size"], t["hidden_size"]),
    "mlp.down_proj.weight": lambda t: (t["hidden_size"], t["intermediate_size"]),
    "input_layernorm.weight": lambda t: (t["hidden_size"],),
    "post_attention_layernorm.weight": lambda t: (t["hidden_size"],),
}


# -- inputs made from the seed ---------------------------------------------------


def vocabulary(size: int) -> list:
    """The word-level vocabulary of ``size`` ids: the specials, the
    template's 14 words, then the loop's words ``w0, w1, ...`` (the loop
    draws ``w0..w<size - 10>``; the last 8 of those fall outside and read
    as ``<unk>``)."""
    head = list(SPECIALS) + TEMPLATE.split()
    return head + [f"w{i}" for i in range(size - len(head))]


def token_ids(text: str, index: dict) -> list:
    """``<s> <template> <query> </s>`` as ids, a word a token (unknown
    words ``<unk>``)."""
    return [1] + [index.get(w, 0) for w in (TEMPLATE + text).split()] + [2]


def _made(seed: int, key: tuple, shape: tuple, gain: bool, dtype, device) -> torch.Tensor:
    """One tensor: N(0, 0.02^2) (a gain: 1 + N(0, 0.02^2)) drawn in fp32
    from its own generator, rounded to ``dtype``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(data.stream_seed(seed, TOWER_STREAM, *key))
    out = torch.randn(shape, generator=gen, device=device, dtype=torch.float32).mul_(0.02)
    if gain:
        out.add_(1.0)
    return out.to(dtype)


def embedding(seed: int, tower: dict, dtype, device) -> torch.Tensor:
    return _made(seed, (0,), (tower["vocab_size"], tower["hidden_size"]), False, dtype, device)


def final_norm(seed: int, tower: dict, dtype, device) -> torch.Tensor:
    return _made(seed, (1,), (tower["hidden_size"],), True, dtype, device)


def layer_weights(seed: int, tower: dict, layer: int, dtype, device) -> dict:
    """Layer ``layer``'s tensors, in ``MistralModel``'s names under
    ``layers.<layer>.``."""
    return {name: _made(seed, (2, layer, j), shape(tower), name.endswith("norm.weight"), dtype, device)
            for j, (name, shape) in enumerate(_LAYER.items())}


def state_dict(seed: int, tower: dict, dtype, device) -> dict:
    """The whole tower as a ``MistralModel`` state dict."""
    out = {"embed_tokens.weight": embedding(seed, tower, dtype, device),
           "norm.weight": final_norm(seed, tower, dtype, device)}
    for i in range(tower["num_hidden_layers"]):
        out.update({f"layers.{i}.{k}": v for k, v in layer_weights(seed, tower, i, dtype, device).items()})
    return out


@contextlib.contextmanager
def seeded_checkpoint(seed: int, tower: dict, dtype, device, vocab: list):
    """A checkpoint directory ``E5MistralEncoder`` opens: a word-level
    tokenizer on disk, and the seeded weights handed to the encoder by
    transformers' model loader (made when it asks, dropped after)."""
    import transformers
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    loader = transformers.AutoModel.from_pretrained
    hf_config = SimpleNamespace(model_type="mistral", **tower)

    class Seeded:
        config = hf_config

        @staticmethod
        def state_dict():
            return state_dict(seed, tower, dtype, device)

    with tempfile.TemporaryDirectory(prefix="bench-port-e5-") as tmp:
        path = Path(tmp)
        words = Tokenizer(models.WordLevel({w: i for i, w in enumerate(vocab)}, unk_token=SPECIALS[0]))
        words.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
        PreTrainedTokenizerFast(tokenizer_object=words, unk_token=SPECIALS[0], bos_token=SPECIALS[1],
                                eos_token=SPECIALS[2]).save_pretrained(path)

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
    """The program's encoder, and what the reference takes: the vocabulary
    and the seed (no weights)."""
    from fastforward_tpu_torch.encoder import E5MistralEncoder

    tower = config["tower"]
    vocab = vocabulary(tower["vocab_size"])
    dtype = _DTYPES[config["compute_dtype"]]
    with seeded_checkpoint(seed, tower, dtype, device, vocab) as path:
        encoder = E5MistralEncoder(str(path), device=device, compute_dtype=config["compute_dtype"])
    return encoder, {"vocab": vocab, "seed": seed}


# -- the reference -----------------------------------------------------------------


def fp8_operand(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to fp8 e4m3 with one per-tensor scale (the largest
    magnitude to 448, e4m3's largest), back in ``x``'s type."""
    scale = x.abs().max().clamp(min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _rms(x, g, eps):
    return x / torch.sqrt((x * x).mean(-1, keepdim=True) + eps) * g


def _layer(x, w, spans, tables, tower, mm):
    """One decoder layer over the tokens of every sequence (``x`` their
    rows one after another; ``spans`` each sequence's ``(start, end)``)."""
    heads, kv, d = tower["num_attention_heads"], tower["num_key_value_heads"], tower["head_dim"]
    eps = tower["rms_norm_eps"]
    h = _rms(x, w["input_layernorm.weight"], eps)
    q, k, v = (mm(h, w[f"self_attn.{n}_proj.weight"].T) for n in ("q", "k", "v"))
    ctx = torch.empty_like(q)
    for s, e in spans:
        cos, sin, allowed = tables[e - s]

        def rope(t):  # (heads, L, d)
            return t * cos + torch.cat([-t[..., d // 2 :], t[..., : d // 2]], -1) * sin

        qs = rope(q[s:e].view(e - s, heads, d).transpose(0, 1))
        # each kv head serves heads / kv query heads: head j reads kv head j // (heads / kv)
        ks = rope(k[s:e].view(e - s, kv, d).transpose(0, 1)).repeat_interleave(heads // kv, 0)
        vs = v[s:e].view(e - s, kv, d).transpose(0, 1).repeat_interleave(heads // kv, 0)
        logits = mm(qs, ks.transpose(1, 2)) / math.sqrt(d)
        probs = torch.softmax(logits.masked_fill(~allowed, -math.inf), -1)
        ctx[s:e] = mm(probs, vs).transpose(0, 1).reshape(e - s, heads * d)
    x = x + mm(ctx, w["self_attn.o_proj.weight"].T)
    h = _rms(x, w["post_attention_layernorm.weight"], eps)
    gate, up = mm(h, w["mlp.gate_proj.weight"].T), mm(h, w["mlp.up_proj.weight"].T)
    return x + mm(gate * torch.sigmoid(gate) * up, w["mlp.down_proj.weight"].T)


def reference(texts: list, inputs: dict, config: dict, precision: str, device):
    """The reference's query vectors of ``texts``: float64, or the control's
    fp8 operands with fp32 accumulation (``"tf32"``)."""
    if precision not in ("float64", "tf32"):
        raise ValueError(f"precision must be 'float64' or 'tf32', got {precision!r}")
    dt = torch.float64 if precision == "float64" else torch.float32

    def mm(a, b):
        if precision == "tf32":
            a, b = fp8_operand(a), fp8_operand(b)
        return a @ b

    tower, seed = config["tower"], inputs["seed"]
    wdt = _DTYPES[config["compute_dtype"]]
    index = {w: i for i, w in enumerate(inputs["vocab"])}
    seqs = [token_ids(t, index) for t in texts]
    ends = np.cumsum([len(s) for s in seqs])
    spans = list(zip((ends - [len(s) for s in seqs]).tolist(), ends.tolist()))
    d, theta, window = tower["head_dim"], tower["rope_theta"], tower["sliding_window"]
    tables = {}
    for n in {len(s) for s in seqs}:
        pos = torch.arange(n, device=device, dtype=dt)
        angles = pos[:, None] * theta ** (-torch.arange(0, d, 2, device=device, dtype=dt) / d)
        angles = torch.cat([angles, angles], -1)
        allowed = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < window)
        tables[n] = (angles.cos(), angles.sin(), allowed)
    with _no_tf32():
        ids = torch.tensor([i for s in seqs for i in s], device=device)
        x = embedding(seed, tower, wdt, device)[ids].to(dt)
        for layer in range(tower["num_hidden_layers"]):
            w = {k: v.to(dt) for k, v in layer_weights(seed, tower, layer, wdt, device).items()}
            x = _layer(x, w, spans, tables, tower, mm)
            del w
        last = _rms(x[torch.as_tensor(ends - 1, device=device)], final_norm(seed, tower, wdt, device).to(dt),
                    tower["rms_norm_eps"])
    return last / last.norm(dim=1, keepdim=True)


# -- the yardstick -----------------------------------------------------------------


def _part_flops(tower: dict, n: int) -> tuple:
    """Matmul operations of one sequence of ``n`` real tokens through the
    decoder: the attention block's (q/k/v/o projections, ``2 n H (2 heads d
    + 2 kv d)``; logits and context over the keys each token sees, ``4
    heads d`` a pair) and the MLP's (``6 n H I``), all layers."""
    h, i, layers = tower["hidden_size"], tower["intermediate_size"], tower["num_hidden_layers"]
    heads, kv, d = tower["num_attention_heads"], tower["num_key_value_heads"], tower["head_dim"]
    window = tower["sliding_window"] or n
    pairs = sum(min(t, window) for t in range(1, n + 1))
    attn = 2.0 * n * h * (2 * heads * d + 2 * kv * d) + 4.0 * heads * d * pairs
    return layers * attn, layers * 6.0 * n * h * i


def least_parts_s(config: dict, n_queries: int) -> dict:
    """Least time of each part of encoding ``n_queries`` queries: its
    matmul operations at the bf16 peak, on each query's real tokens, their
    number uniform over the configuration's ``query_tokens`` range (the
    template, BOS and EOS, and 2-15 words)."""
    lo, hi = config["query_tokens"]
    parts = np.array([_part_flops(config["tower"], n) for n in range(lo, hi + 1)]).mean(axis=0)
    rate = roofline.PEAKS["bf16_flops_per_s"]
    return {"attn": n_queries * parts[0] / rate, "mlp": n_queries * parts[1] / rate}


def least_s(config: dict, n_queries: int) -> float:
    """Least time of encoding ``n_queries`` queries (both parts)."""
    return sum(least_parts_s(config, n_queries).values())
