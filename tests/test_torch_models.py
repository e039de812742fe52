"""The port's BERT towers against ``fastforward_tpu.models.bert`` on the CPU.

The same numpy weights (``init_params`` of either package, carried into the
port by ``convert.bert_from_params``) and the same ids go through the JAX
tower and the port's.  Tolerances:

- fp32: atol 2e-4, rtol 1e-3, the JAX package's own against torch
  (``tests/test_models.py:63``);
- bf16: the two towers round their bf16 activations at different places
  (XLA fuses the bias adds into its dots; the layer norms compute their
  moments in another order), and each layer norm carries a one-step
  difference on.  So the bound is eight bf16 steps at the output's largest
  magnitude, ``8 * 2^-8 * max|jax|``, and the port's root-mean-square
  difference from JAX at most twice JAX's own bf16 difference from its
  fp32 tower: both are as far from each other as bf16 is from fp32, no
  further.

``from_hf_torch`` is held against transformers' own torch models, as the
JAX package's tests hold its conversion, and the pooling functions against
the JAX package's.
"""

import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch

from fastforward_tpu.models import bert as jbert
from fastforward_tpu_torch import convert
from fastforward_tpu_torch.device import fp32_matmul
from fastforward_tpu_torch.models import bert

FP32_TOL = {"atol": 2e-4, "rtol": 1e-3}

ARCHS = {"bert": 2, "distilbert": 0}  # type_vocab_size


def _inputs(seed: int, batch: int = 4, length: int = 24, vocab: int = 1024):
    """Ids and a ragged mask (rows padded from half length and from 2)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(batch, length))
    mask = np.ones((batch, length), dtype=np.int64)
    mask[1, length // 2 :] = 0
    mask[-1, 2:] = 0
    return ids * mask, mask


def _configs(arch: str, dtype: str = "float32"):
    tv = ARCHS[arch]
    jc = dataclasses.replace(jbert.BertConfig.tiny(), type_vocab_size=tv, dtype=dtype)
    pc = dataclasses.replace(bert.BertConfig.tiny(), type_vocab_size=tv, dtype=dtype)
    return jc, pc


def _jax_hidden(params, ids, mask, config) -> np.ndarray:
    return np.asarray(
        jbert.encode(params, ids.astype(np.int32), mask.astype(np.int32), config)
    )


def _port_hidden(tower, ids, mask) -> np.ndarray:
    with torch.inference_mode():
        return tower(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()


@pytest.mark.parametrize("arch", list(ARCHS))
def test_init_params_match_jax(arch):
    """The port's ``init_params`` draws the JAX package's weights, leaf
    for leaf."""
    jc, pc = _configs(arch)
    want, got = jbert.init_params(jc, seed=3), bert.init_params(pc, seed=3)
    for group in ("embeddings", "layers"):
        assert set(got[group]) == set(want[group])
        for key, value in want[group].items():
            np.testing.assert_array_equal(got[group][key], np.asarray(value), err_msg=key)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_tower_fp32_matches_jax(arch, seed):
    jc, pc = _configs(arch)
    params = bert.init_params(pc, seed=seed)
    ids, mask = _inputs(seed)
    want = _jax_hidden(params, ids, mask, jc)
    got = _port_hidden(convert.bert_from_params(params, pc), ids, mask)
    assert got.dtype == np.float32 and got.shape == (4, 24, pc.hidden_size)
    np.testing.assert_allclose(got, want, **FP32_TOL)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_tower_bf16_matches_jax(arch, seed):
    jc, pc = _configs(arch, "bfloat16")
    params = bert.init_params(pc, seed=seed)
    ids, mask = _inputs(seed)
    want = _jax_hidden(params, ids, mask, jc)
    want32 = _jax_hidden(params, ids, mask, dataclasses.replace(jc, dtype="float32"))
    tower = convert.bert_from_params(params, pc)
    assert tower.q_w.dtype == torch.bfloat16 and tower.word.dtype == torch.float32
    got = _port_hidden(tower, ids, mask)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=8 * 2.0**-8 * np.abs(want).max(), rtol=0)
    rms = np.sqrt(np.mean((got - want) ** 2))
    assert rms <= 2 * np.sqrt(np.mean((want - want32) ** 2)), rms


def test_padded_keys_do_not_change_real_tokens():
    """Masked keys get ``finfo(float32).min``: appending padding leaves the
    real tokens' states as they were (in bf16 too: the bias stays fp32)."""
    for dtype in ("float32", "bfloat16"):
        _, pc = _configs("bert", dtype)
        tower = convert.bert_from_params(bert.init_params(pc, seed=5), pc)
        ids, _ = _inputs(5, batch=2, length=10)
        mask = np.ones_like(ids)
        ids_pad = np.concatenate([ids, np.zeros((2, 6), dtype=ids.dtype)], axis=1)
        mask_pad = np.concatenate([mask, np.zeros((2, 6), dtype=mask.dtype)], axis=1)
        short = _port_hidden(tower, ids, mask)
        long = _port_hidden(tower, ids_pad, mask_pad)[:, :10]
        np.testing.assert_allclose(long, short, atol=1e-5 if dtype == "float32" else 2**-6)


def test_tower_rejects_wrong_shapes_and_dtype():
    _, pc = _configs("bert")
    params = bert.init_params(pc, seed=0)
    params["layers"]["q_w"] = params["layers"]["q_w"][:, :, :-1]
    with pytest.raises(ValueError, match="q_w"):
        convert.bert_from_params(params, pc)
    with pytest.raises(ValueError, match="dtype"):
        bert.BertTower(dataclasses.replace(pc, dtype="float16"))


def _hf_bert():
    from transformers import BertConfig as HFBertConfig
    from transformers import BertModel

    torch.manual_seed(0)
    return BertModel(
        HFBertConfig(
            vocab_size=512,
            hidden_size=64,
            num_hidden_layers=3,
            num_attention_heads=4,
            intermediate_size=128,
            max_position_embeddings=64,
        )
    ).eval()


def _hf_distilbert():
    from transformers import DistilBertConfig as HFDistilBertConfig
    from transformers import DistilBertModel

    torch.manual_seed(1)
    return DistilBertModel(
        HFDistilBertConfig(
            vocab_size=512,
            dim=64,
            n_layers=3,
            n_heads=4,
            hidden_dim=128,
            max_position_embeddings=64,
        )
    ).eval()


@pytest.mark.parametrize("build", [_hf_bert, _hf_distilbert], ids=["bert", "distilbert"])
def test_from_hf_torch_matches_transformers_and_jax(build):
    """``from_hf_torch`` reproduces transformers' forward
    (``tests/test_models.py``'s check), and the JAX package's conversion of
    the same model."""
    model = build()
    tower = bert.from_hf_torch(model)
    assert tower.config.type_vocab_size == (0 if build is _hf_distilbert else 2)
    ids, mask = _inputs(2, batch=4, length=12, vocab=512)
    with torch.no_grad():
        want = model(
            input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask)
        ).last_hidden_state.numpy()
    got = _port_hidden(tower, ids, mask)
    np.testing.assert_allclose(got, want, **FP32_TOL)
    jparams, jconfig = jbert.from_hf_torch(model)
    np.testing.assert_allclose(got, _jax_hidden(jparams, ids, mask, jconfig), **FP32_TOL)
    assert tower.config == dataclasses.replace(
        bert.BertConfig(), **dataclasses.asdict(jconfig)
    )


def test_from_hf_torch_bf16_rounds_layer_weights_once():
    model = _hf_bert()
    tower32, tower16 = bert.from_hf_torch(model), bert.from_hf_torch(model, dtype="bfloat16")
    assert tower16.config.dtype == "bfloat16"
    assert torch.equal(tower16.ffn_in_w, tower32.ffn_in_w.to(torch.bfloat16))
    assert torch.equal(tower16.word, tower32.word)  # embeddings stay fp32


class TestPooling:
    """The five pooling functions against the JAX package's on the same
    hidden states (``tests/test_models.py``'s inputs)."""

    def setup_method(self):
        rng = np.random.default_rng(2)
        self.hidden = rng.normal(size=(3, 10, 8)).astype(np.float32)
        self.mask = np.ones((3, 10), dtype=np.int32)
        self.mask[1, 6:] = 0
        self.mask[2, 3:] = 0

    @pytest.mark.parametrize(
        "name", ["pool_cls", "pool_mean_from", "pool_masked_mean_from", "pool_masked_mean"]
    )
    def test_pool_matches_jax(self, name):
        want = np.asarray(getattr(jbert, name)(self.hidden, self.mask))
        got = getattr(bert, name)(torch.from_numpy(self.hidden), torch.from_numpy(self.mask))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)

    def test_l2_normalize_matches_jax(self):
        x = np.asarray([[3.0, 4.0], [1.0, 0.0], [0.0, 0.0]], dtype=np.float32)
        want = np.asarray(jbert.l2_normalize(x))
        np.testing.assert_allclose(bert.l2_normalize(torch.from_numpy(x)).numpy(), want, rtol=1e-6)


def test_fp32_guard_restores_the_flag_under_concurrent_blocks():
    """Threads entering the fp32 guard at once all see TF32 off inside it,
    and the process's setting is back afterwards: the blocks take turns,
    so none restores another's flag (without the lock, a block entered
    while another held the flag off would restore "off")."""
    prev_flag = torch.backends.cuda.matmul.allow_tf32
    prev_switch = sys.getswitchinterval()
    torch.backends.cuda.matmul.allow_tf32 = True
    sys.setswitchinterval(1e-6)
    seen: list[bool] = []
    try:
        def work():
            for _ in range(200):
                with fp32_matmul(torch.device("cuda")):
                    seen.append(torch.backends.cuda.matmul.allow_tf32)
                    with fp32_matmul(torch.device("cuda")):  # re-entrant
                        seen.append(torch.backends.cuda.matmul.allow_tf32)

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert len(seen) == 16 * 200 * 2 and not any(seen)
        assert torch.backends.cuda.matmul.allow_tf32 is True
        with fp32_matmul(torch.device("cpu")):  # other devices: untouched
            assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        sys.setswitchinterval(prev_switch)
        torch.backends.cuda.matmul.allow_tf32 = prev_flag
