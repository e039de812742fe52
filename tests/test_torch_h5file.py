"""The port's HDF5 codec (``fastforward_tpu_torch/index/h5file.py``) held
against h5py in both directions, at small sizes.

The port writes and h5py reads: attributes of every type of the subset,
chunked datasets of each dtype the index stores (grown across several
chunks, one with a two-level chunk B-tree), ``S{n}`` ids, contiguous
datasets, a group deleted and created again, and the chunk offsets the
memory maps use.  h5py writes (through the JAX package's ``OnDiskIndex``)
and the port reads the same arrays, ids and quantizer state; chunks never
allocated read as zeros.  The two append to each other's files in turns.
Structures outside the subset raise ``UnsupportedHDF5`` naming them, and
no module of the port imports h5py.
"""

import ast
import sys
import threading
from pathlib import Path

import h5py
import numpy as np
import pytest

from fastforward_tpu.index import OnDiskIndex as JaxOnDiskIndex
from fastforward_tpu.quantizer import NanoPQ as JaxNanoPQ
from fastforward_tpu.quantizer import ScalarQuantizer as JaxScalarQuantizer
from fastforward_tpu_torch.index import h5file

ATTRIBUTES = {
    "int8": np.int8(-7),
    "int16": np.int16(-300),
    "int32": np.int32(-70000),
    "int64": np.int64(-(2**40)),
    "uint8": np.uint8(200),
    "uint16": np.uint16(60000),
    "uint32": np.uint32(4_000_000_000),
    "uint64": np.uint64(2**63 + 5),
    "float32": np.float32(1.25),
    "float64": 2.5,
    "python_int": 65536,
    "bool_true": True,
    "bool_false": np.bool_(False),
    "str": "fast_forward.quantizer.nanopq",
    "str_utf8": "größe ✓",
    "str_empty": "",
    "bytes": np.bytes_(b"abc"),
    "int_array": np.arange(5, dtype=np.int32),
    "float_array": np.linspace(0, 1, 7, dtype=np.float32),
    "bool_array": np.array([True, False, True]),
    "str_array": np.array(["a", "bc", "déf"], dtype=object),
}


def _same(got, want) -> None:
    if isinstance(want, str):
        assert isinstance(got, str) and got == want
    elif isinstance(want, np.ndarray) and want.dtype == object:
        assert [str(x) for x in got] == list(want)
    else:
        want = np.asarray(want)
        assert np.asarray(got).dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(ATTRIBUTES))
def test_port_writes_an_attribute_h5py_reads_it(tmp_path, name):
    """Each attribute type, on the root and on a nested group: h5py reads
    the value and dtype the port wrote, and so does the port."""
    path = tmp_path / "a.h5"
    value = ATTRIBUTES[name]
    with h5file.File(path, "w") as fp:
        fp.attrs[name] = value
        fp.create_group("quantizer/meta").attrs.update({name: value, "other": 1})
    with h5py.File(path, "r") as fp:
        _same(fp.attrs[name], value)
        _same(fp["quantizer/meta"].attrs[name], value)
        assert sorted(fp["quantizer/meta"].attrs) == sorted([name, "other"])
    with h5file.File(path, "r") as fp:
        _same(fp.attrs[name], value)
        _same(dict(fp["quantizer/meta"].attrs)[name], value)


def _chunk_offsets_h5py(ds) -> list:
    return [ds.id.get_chunk_info(i).byte_offset for i in range(ds.id.get_num_chunks())]


@pytest.mark.parametrize("dtype", ["float32", "int8", "uint8", "uint16", "uint32"])
def test_port_writes_vectors_h5py_reads_them(tmp_path, dtype):
    """A chunked ``vectors`` dataset as the index writes it: created at 64
    rows, written in part, resized across several chunks and written again;
    h5py reads every row (unwritten rows as zeros), the same chunks and
    chunk offsets, and the port reads the same by slice and by list."""
    rng = np.random.default_rng(1)
    info = np.iinfo(dtype) if dtype != "float32" else None
    table = (rng.standard_normal((300, 24)).astype(dtype) if info is None
             else rng.integers(info.min, info.max, (300, 24), endpoint=True).astype(dtype))
    path = tmp_path / "v.h5"
    with h5file.File(path, "w") as fp:
        fp.create_dataset("vectors", (64, 24), dtype, maxshape=(None, 24), chunks=(32, 24))
        fp["vectors"][:40] = table[:40]
    with h5file.File(path, "a") as fp:
        fp["vectors"].resize(320, axis=0)
        fp["vectors"][40:300] = table[40:]
    want = np.concatenate([table, np.zeros((20, 24), dtype)])
    with h5py.File(path, "r") as fp:
        ds = fp["vectors"]
        assert ds.dtype == np.dtype(dtype) and ds.shape == (320, 24) and ds.chunks == (32, 24)
        assert ds.maxshape == (None, 24)
        np.testing.assert_array_equal(ds[:], want)
        offsets = _chunk_offsets_h5py(ds)
    with h5file.File(path, "r") as fp:
        ds = fp["vectors"]
        assert ds.chunk_offsets() == offsets and len(offsets) == 10
        np.testing.assert_array_equal(ds[:], want)
        rows = [0, 1, 2, 31, 32, 33, 200, 299, 310]
        np.testing.assert_array_equal(ds[rows], want[rows])
        for offset, lo in zip(offsets, range(0, 320, 32)):  # chunk i holds rows i * 32...
            chunk = np.memmap(path, mode="r", shape=ds.chunks, offset=offset, dtype=ds.dtype)
            np.testing.assert_array_equal(chunk, want[lo : lo + 32])


@pytest.mark.parametrize("width", [8, 16])
def test_port_writes_ids_h5py_reads_them(tmp_path, width):
    """``S{n}`` ids with ``chunks=True`` (h5py's chunk guess), written over
    two resizes: h5py reads the same bytes (its ``asstr`` the ASCII ones)
    and the port's ``asstr`` decodes every id from UTF-8."""
    ids = [f"d{i}".encode() for i in range(5000)] + ["ü".encode() * (width // 2)]
    path = tmp_path / "ids.h5"
    with h5file.File(path, "w") as fp:
        fp.create_dataset("doc_ids", (1024,), f"S{width}", maxshape=(None,), chunks=True)
        fp["doc_ids"][:1000] = np.array(ids[:1000], dtype=f"S{width}")
    with h5file.File(path, "a") as fp:
        fp["doc_ids"].resize(6144, axis=0)
        fp["doc_ids"][1000 : len(ids)] = np.array(ids[1000:], dtype=f"S{width}")
    with h5py.File(path, "r") as fp, h5file.File(path, "r") as mine:
        ds = fp["doc_ids"]
        with h5py.File(tmp_path / "guess.h5", "w") as ref:
            assert ds.chunks == ref.create_dataset("x", (1024,), f"S{width}", maxshape=(None,),
                                                    chunks=True).chunks
        want = ids + [b""] * (6144 - len(ids))
        assert ds[:].tolist() == want and ds.asstr()[:5000].tolist() == [i.decode() for i in ids[:5000]]
        assert mine["doc_ids"][:].tolist() == want
        assert mine["doc_ids"].asstr()[:].tolist() == [i.decode() for i in want]
        assert mine["doc_ids"].chunk_offsets() == _chunk_offsets_h5py(ds)


def test_contiguous_datasets_and_a_group_made_again(tmp_path):
    """``create_dataset(data=)`` is contiguous; deleting a group and making
    it again (``_on_quantizer_set``) leaves only the new one; h5py then
    links a group into the port's symbol tables and the port reads it."""
    path = tmp_path / "q.h5"
    codewords = np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4)
    with h5file.File(path, "w") as fp:
        fp.attrs["num_vectors"] = 0
        fp.create_group("quantizer/meta").attrs["__name__"] = "NanoPQ"
        fp.create_group("quantizer/data").create_dataset("codewords", data=codewords)
    with h5file.File(path, "a") as fp:
        del fp["quantizer"]
        assert "quantizer" not in fp
        fp.create_group("quantizer/meta").attrs.update({"__name__": "ScalarQuantizer", "_trained": True})
        fp.create_group("quantizer/attributes")
        fp.create_group("quantizer/data").create_dataset("scales", data=np.ones(4, np.float32))
    with h5py.File(path, "r") as fp:
        assert sorted(fp["quantizer"]) == ["attributes", "data", "meta"]
        assert sorted(fp["quantizer/data"]) == ["scales"]
        assert fp["quantizer/meta"].attrs["__name__"] == "ScalarQuantizer"
        assert fp["quantizer/data/scales"].chunks is None
        np.testing.assert_array_equal(fp["quantizer/data/scales"][:], np.ones(4, np.float32))
    with h5py.File(path, "a") as fp:  # h5py links into the port's symbol tables
        fp.create_group("quantizer/extra").attrs["metric"] = "dot"
    with h5file.File(path, "r") as fp:
        assert dict(fp["quantizer/attributes"].attrs) == {}
        assert [k for k, _ in fp["quantizer/data"].items()] == ["scales"]
        assert fp["quantizer"].keys() == ["attributes", "data", "extra", "meta"]
        assert fp["quantizer/extra"].attrs["metric"] == "dot"


def test_two_level_chunk_btree(tmp_path):
    """16-row chunks over 1,100 rows: 69 chunks, more than one B-tree node
    holds (64), so the tree has two levels; h5py reads it and appends to
    it, and the port reads h5py's tree back."""
    rng = np.random.default_rng(2)
    table = rng.standard_normal((1100, 8)).astype(np.float32)
    path = tmp_path / "t.h5"
    with h5file.File(path, "w") as fp:
        fp.create_dataset("vectors", (16, 8), np.float32, maxshape=(None, 8), chunks=(16, 8))
        fp["vectors"].resize(1100, axis=0)
        fp["vectors"][:] = table
    more = rng.standard_normal((1000, 8)).astype(np.float32)
    with h5py.File(path, "a") as fp:
        ds = fp["vectors"]
        assert ds.id.get_num_chunks() == 69
        np.testing.assert_array_equal(ds[:], table)
        ds.resize(2100, axis=0)
        ds[1100:] = more
        offsets = _chunk_offsets_h5py(ds)
    with h5file.File(path, "r") as fp:
        assert fp["vectors"].chunk_offsets() == offsets and len(offsets) == 132
        np.testing.assert_array_equal(fp["vectors"][:], np.concatenate([table, more]))


@pytest.mark.parametrize("quantizer", [None, "pq", "scalar"])
def test_jax_package_writes_the_port_reads(tmp_path, quantizer):
    """The JAX package's ``OnDiskIndex`` writes through h5py (adds across
    chunk growth); the port reads the same rows, ids, attributes and
    quantizer state, and the rows never written (up to the allocated
    ``init_size``) read as zeros."""
    rng = np.random.default_rng(3)
    vectors = rng.standard_normal((150, 16)).astype(np.float32)
    quant = {"pq": JaxNanoPQ(4, 8), "scalar": JaxScalarQuantizer()}.get(quantizer)
    if quant is not None:
        quant.fit(vectors)
    path = tmp_path / "jax.h5"
    index = JaxOnDiskIndex(path, quantizer=quant, init_size=64, chunk_size=64, max_id_length=12)
    doc_ids = [f"doc-{i // 2}" for i in range(150)]
    for lo, hi in ((0, 40), (40, 150)):
        index.add(vectors[lo:hi], doc_ids=doc_ids[lo:hi], psg_ids=[f"p{i}" for i in range(lo, hi)])
    with h5py.File(path, "r") as want, h5file.File(path, "r") as got:
        assert sorted(got.keys()) == sorted(want.keys())
        assert dict(got.attrs).keys() == dict(want.attrs).keys()
        for key, value in want.attrs.items():
            _same(got.attrs[key], value)
        for name in ("vectors", "doc_ids", "psg_ids"):
            assert got[name].shape == want[name].shape == (192,) + want[name].shape[1:]
            assert got[name].dtype == want[name].dtype and got[name].chunks == want[name].chunks
            np.testing.assert_array_equal(got[name][:], want[name][:])
            assert not np.any(got[name][150:].astype(bool) if name == "vectors" else got[name][150:])
        assert got["doc_ids"].asstr()[:150].tolist() == doc_ids
        assert got["vectors"].chunk_offsets() == _chunk_offsets_h5py(want["vectors"])
        if quant is not None:
            for group in ("meta", "attributes"):
                want_attrs = dict(want[f"quantizer/{group}"].attrs)
                got_attrs = dict(got[f"quantizer/{group}"].attrs)
                assert got_attrs.keys() == want_attrs.keys()
                for key, value in want_attrs.items():
                    _same(got_attrs[key], value)
            for key, value in want["quantizer/data"].items():
                np.testing.assert_array_equal(got[f"quantizer/data/{key}"][:], value[:])


def test_interleaved_appends(tmp_path):
    """Three rounds: the port appends rows to h5py's file and h5py to the
    port's (resize, write, ``num_vectors``); each reads everything back."""
    rng = np.random.default_rng(4)
    paths = {"h5py": tmp_path / "h.h5", "port": tmp_path / "p.h5"}
    opener = {"h5py": h5py.File, "port": h5file.File}
    for name, path in paths.items():
        with opener[name](path, "w") as fp:
            fp.attrs["num_vectors"] = 0
            fp.create_dataset("vectors", (48, 8), np.float32, maxshape=(None, 8), chunks=(48, 8))
            fp.create_dataset("doc_ids", (48,), "S8", maxshape=(None,), chunks=True)
    want = {name: [] for name in paths}
    for step in range(3):
        for name, path in paths.items():
            writer = opener["port" if name == "h5py" else "h5py"]  # the other one appends
            rows = rng.standard_normal((70, 8)).astype(np.float32)
            ids = np.array([f"r{step}-{i}".encode() for i in range(70)], dtype="S8")
            with writer(path, "a") as fp:
                start = int(fp.attrs["num_vectors"])
                for ds in ("vectors", "doc_ids"):
                    fp[ds].resize(-(-(start + 70) // 48) * 48, axis=0)
                fp["vectors"][start : start + 70] = rows
                fp["doc_ids"][start : start + 70] = ids
                fp.attrs["num_vectors"] = start + 70
            want[name].append((rows, ids))
            for reader in opener.values():
                with reader(path, "r") as fp:
                    n = int(fp.attrs["num_vectors"])
                    assert n == 70 * (step + 1)
                    np.testing.assert_array_equal(fp["vectors"][:n], np.concatenate([r for r, _ in want[name]]))
                    np.testing.assert_array_equal(fp["doc_ids"][:n], np.concatenate([i for _, i in want[name]]))


def test_threads_read_at_once(tmp_path):
    """16 threads (more than the cores here), each through a ``File`` of
    its own and one through a shared ``File``, read random rows by list
    and by slice at a short switch interval: every read equals the table
    (the hybrid tier's and the sharded view's readers run in threads)."""
    rng = np.random.default_rng(6)
    table = rng.standard_normal((4096, 16)).astype(np.float32)
    path = tmp_path / "t.h5"
    with h5file.File(path, "w") as fp:
        fp.create_dataset("vectors", (4096, 16), np.float32, maxshape=(None, 16), chunks=(256, 16))
        fp["vectors"][:] = table
    shared = h5file.File(path, "r")
    bad, done = [], []

    def read(seed: int) -> None:
        local = np.random.default_rng(seed)
        with h5file.File(path, "r") as own:
            for fp in (own, shared) * 20:
                rows = np.sort(local.choice(4096, 64, replace=False))
                lo = int(local.integers(0, 4000))
                if not (np.array_equal(fp["vectors"][rows.tolist()], table[rows])
                        and np.array_equal(fp["vectors"][lo : lo + 96], table[lo : lo + 96])):
                    bad.append(seed)
        done.append(seed)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=read, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
        shared.close()
    assert not any(t.is_alive() for t in threads) and sorted(done) == list(range(16)) and not bad


def _gzip(path):
    with h5py.File(path, "w") as fp:
        fp.create_dataset("vectors", data=np.ones((64, 4), np.float32), compression="gzip")
    return "vectors", "filter pipeline"


def _latest(path):
    with h5py.File(path, "w", libver="latest") as fp:
        fp.create_dataset("vectors", data=np.ones((4, 4), np.float32))
    return None, "superblock version"


def _tracked_order(path):
    with h5py.File(path, "w") as fp:
        fp.create_group("quantizer", track_order=True)
    return "quantizer", "version-2 object header"


def _compound(path):
    with h5py.File(path, "w") as fp:
        fp.attrs["pair"] = np.array((1, 2.0), dtype=[("a", "<i4"), ("b", "<f8")])
    return "attrs", "compound datatype"


def _big_endian(path):
    with h5py.File(path, "w") as fp:
        fp.create_dataset("vectors", data=np.ones((4, 4), ">f4"))
    return "vectors", "floating-point datatype"


@pytest.mark.parametrize("make", [_gzip, _latest, _tracked_order, _compound, _big_endian],
                         ids=["gzip", "libver_latest", "track_order", "compound", "big_endian"])
def test_outside_the_subset_raises_naming_it(tmp_path, make):
    """A structure the codec does not read raises ``UnsupportedHDF5`` that
    names it; no read returns data."""
    path = tmp_path / "x.h5"
    target, words = make(path)
    with pytest.raises(h5file.UnsupportedHDF5, match=words):
        with h5file.File(path, "r") as fp:
            if target == "attrs":
                dict(fp.attrs)
            else:
                fp[target][:]


def test_no_module_of_the_port_imports_h5py():
    """The port's sources (and ``chip_smoke.py``) import h5py nowhere, at
    the top of a module or inside a function."""
    root = Path(__file__).resolve().parent.parent
    sources = sorted((root / "fastforward_tpu_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    found = []
    for path in sources:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            found += [f"{path.name}:{node.lineno}" for n in names if n.split(".")[0] == "h5py"]
    assert len(sources) > 40 and not found, found
