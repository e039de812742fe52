"""The port's quantizers against their contract and against ``fastforward_tpu``.

The contracts of ``tests/test_quantizer.py`` run against the port's classes
(on the CPU: ``device="cpu"``), serialized triples cross between the two
packages in both directions, and the port's torch k-means is held against
the JAX one from the same seed on the same data.
"""

import numpy as np
import pytest

from fastforward_tpu.quantizer import OPQ as JaxOPQ
from fastforward_tpu.quantizer import PQ as JaxPQ
from fastforward_tpu.quantizer import ScalarQuantizer as JaxScalarQuantizer
from fastforward_tpu.quantizer.base import Quantizer as JaxQuantizer
from fastforward_tpu_torch import convert
from fastforward_tpu_torch.quantizer import OPQ, PQ, NanoOPQ, NanoPQ, Quantizer, ScalarQuantizer

RNG = np.random.default_rng(42)


def _pq(cls, **kw):
    return cls(8, 256, device="cpu", **kw)


@pytest.fixture(scope="module", params=["PQ", "OPQ"])
def pq_pair(request):
    """(untrained, trained) port quantizers of one class, as in
    ``tests/test_quantizer.py``."""
    cls, kw = (PQ, {}) if request.param == "PQ" else (OPQ, {"opq_iters": 2})
    trained = _pq(cls, **kw)
    trained.fit(np.random.default_rng(1).normal(size=(2**10, 768)).astype(np.float32))
    return _pq(cls, **kw), trained


def test_eq(pq_pair):
    fresh, trained = pq_pair
    assert fresh == fresh and trained == trained
    assert fresh != trained


def test_properties(pq_pair):
    fresh, trained = pq_pair
    assert (None, 8) == fresh.dims and np.uint8 == fresh.dtype and not fresh._trained
    assert (768, 8) == trained.dims and np.uint8 == trained.dtype and trained._trained


def test_encoding_decoding(pq_pair):
    _, trained = pq_pair
    inputs = RNG.normal(size=(8, 768)).astype(np.float32)
    encoded = trained.encode(inputs)
    assert encoded.shape == (8, 8) and encoded.dtype == np.uint8
    assert trained.decode(encoded).shape == inputs.shape


@pytest.mark.parametrize("cls", [PQ, OPQ])
def test_reconstruction_reduces_error(cls):
    """On structured (low-rank) data the codebooks capture the structure."""
    basis = RNG.normal(size=(8, 768)).astype(np.float32)
    data = (RNG.normal(size=(2**10, 8)).astype(np.float32) @ basis) / 8
    quantizer = cls(8, 256, device="cpu")
    quantizer.fit(data)
    decoded = quantizer.decode(quantizer.encode(data))
    assert np.mean((data - decoded) ** 2) < 0.5 * np.mean(data**2)


def test_serialization(pq_pair):
    fresh, trained = pq_pair
    inputs = RNG.normal(size=(8, 768)).astype(np.float32)
    assert Quantizer.deserialize(*fresh.serialize()) == fresh
    loaded = Quantizer.deserialize(*trained.serialize())
    assert loaded == trained and type(loaded) is type(trained)
    loaded.device = "cpu"
    np.testing.assert_array_equal(trained.encode(inputs), loaded.encode(inputs))


def test_errors(pq_pair):
    fresh, _ = pq_pair
    with pytest.raises(RuntimeError):
        fresh.encode(RNG.normal(size=(8, 768)).astype(np.float32))
    with pytest.raises(RuntimeError):
        fresh.set_attached()
    with pytest.raises(ValueError, match="divisible"):
        PQ(7, 4, device="cpu").fit(np.zeros((16, 768), dtype=np.float32))
    with pytest.raises(ValueError, match="training vectors"):
        PQ(8, 256, device="cpu").fit(np.zeros((16, 768), dtype=np.float32))


@pytest.mark.parametrize("pq_pair", ["OPQ"], indirect=True)
def test_opq_rotation_orthogonal(pq_pair):
    _, trained = pq_pair
    r = trained.R
    np.testing.assert_allclose(r @ r.T, np.eye(r.shape[0]), atol=1e-4)


@pytest.mark.parametrize("pq_pair", ["OPQ"], indirect=True)
def test_opq_rotated_query_scores_match_decode(pq_pair):
    """(q @ R) . codeword == q . decode (the in-kernel scoring identity)."""
    _, trained = pq_pair
    inputs = RNG.normal(size=(4, 768)).astype(np.float32)
    queries = RNG.normal(size=(2, 768)).astype(np.float32)
    codes = trained.encode(inputs)
    raw = PQ._decode(trained, codes)  # without the inverse rotation
    np.testing.assert_allclose(
        queries @ trained.decode(codes).T, trained.rotate(queries) @ raw.T, rtol=1e-3, atol=1e-2
    )


def test_aliases_and_device_default():
    assert NanoPQ is PQ and NanoOPQ is OPQ
    assert PQ(2, 4).device is None  # the card, resolved when fit/encode run


class TestScalarQuantizer:
    data = RNG.normal(size=(256, 64)).astype(np.float32)

    def _fitted(self):
        quantizer = ScalarQuantizer()
        quantizer.fit(self.data)
        return quantizer

    def test_round_trip(self):
        quantizer = self._fitted()
        codes = quantizer.encode(self.data)
        assert codes.dtype == np.int8
        err = np.abs(self.data - quantizer.decode(codes)).max()
        # quantization step is scale = absmax/127; error <= scale/2 per dim
        assert err < np.max(quantizer.scales)

    def test_dims(self):
        assert self._fitted().dims == (64, 64) and ScalarQuantizer().dims == (None, None)

    def test_serialization(self):
        quantizer = self._fitted()
        assert Quantizer.deserialize(*quantizer.serialize()) == quantizer

    def test_untrained_errors(self):
        with pytest.raises(RuntimeError):
            ScalarQuantizer().encode(self.data)
        with pytest.raises(RuntimeError):
            ScalarQuantizer().set_attached()


def test_deserialize_unknown_class_raises():
    with pytest.raises(ValueError, match="unknown quantizer"):
        Quantizer.deserialize({"__module__": "os", "__name__": "system", "_trained": True}, {}, {})


# -- across the two packages -----------------------------------------------------


def _jax_quantizers():
    data = np.random.default_rng(3).normal(size=(512, 64)).astype(np.float32)
    out = []
    for q in (JaxPQ(8, 16), JaxOPQ(8, 16, opq_iters=2), JaxScalarQuantizer()):
        q.fit(data)
        out.append(q)
    return data, out


@pytest.mark.parametrize("which", [0, 1, 2], ids=["PQ", "OPQ", "ScalarQuantizer"])
def test_jax_triple_loads_in_the_port(which):
    """A ``fastforward_tpu`` triple gives identical codewords, R and scales,
    the same serialized names, and the same codes and decodes."""
    data, quantizers = _jax_quantizers()
    jq = quantizers[which]
    meta, attrs, arrays = jq.serialize()
    tq = convert.quantizer_from_state(meta, attrs, arrays, device="cpu")
    assert type(tq).__name__ == type(jq).__name__
    tmeta, tattrs, tarrays = tq.serialize()
    assert tmeta == meta and tattrs == attrs and tarrays.keys() == arrays.keys()
    for key in arrays:
        np.testing.assert_array_equal(tarrays[key], arrays[key])
    np.testing.assert_array_equal(tq.encode(data[:64]), jq.encode(data[:64]))
    codes = jq.encode(data[:64])
    np.testing.assert_allclose(tq.decode(codes), jq.decode(codes), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("which", [0, 1, 2], ids=["PQ", "OPQ", "ScalarQuantizer"])
def test_port_triple_loads_in_jax(which):
    """A triple the port writes loads in ``fastforward_tpu`` as its own class
    with the same arrays."""
    data, quantizers = _jax_quantizers()
    tq = convert.quantizer_from_state(*quantizers[which].serialize(), device="cpu")
    back = JaxQuantizer.deserialize(*tq.serialize())
    assert back == quantizers[which]
    assert type(back).__module__.startswith("fastforward_tpu.quantizer")


@pytest.mark.parametrize("cls_pair", [(PQ, JaxPQ), (OPQ, JaxOPQ)], ids=["PQ", "OPQ"])
def test_kmeans_agrees_with_jax(cls_pair):
    """The torch k-means and the JAX one, from the same seed (the same
    initial rows) on the same data, encode at least 99% of the codes alike.
    Not 100%: the two sum each distance's products in a different order, so
    near-ties in the nearest-centroid argmin can go the other way, and such
    a flip moves a centroid slightly in every later iteration."""
    rng = np.random.default_rng(5)
    m, ks, ds, n = 4, 16, 8, 4096
    centers = rng.normal(size=(m, ks, ds)).astype(np.float32) * 3
    pick = rng.integers(0, ks, size=(n, m))
    data = centers[np.arange(m)[None, :], pick].reshape(n, m * ds)
    data = (data + 0.3 * rng.normal(size=data.shape)).astype(np.float32)
    kw = {"opq_iters": 2} if cls_pair[0] is OPQ else {}
    tq, jq = cls_pair[0](m, ks, device="cpu", **kw), cls_pair[1](m, ks, **kw)
    tq.fit(data[:2048])
    jq.fit(data[:2048])
    held_out = data[2048:]
    agree = (tq.encode(held_out) == jq.encode(held_out)).mean()
    assert agree >= 0.99, agree
