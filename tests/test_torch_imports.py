"""The port stands alone: no JAX, no fastforward_tpu, and the card by default."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from fastforward_tpu_torch import InMemoryIndex

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "fastforward_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    """A fresh interpreter imports every module of the port and parses and
    loads ``chip_smoke.py``; neither JAX nor ``fastforward_tpu`` appears.
    ``utils.pyterrier`` needs python-terrier: where it is not installed, a
    stub module stands in for it, so that module is imported too."""
    code = """
import ast, importlib, importlib.util, pkgutil, sys, types
if importlib.util.find_spec("pyterrier") is None:
    pt = types.ModuleType("pyterrier")
    pt.Transformer = object
    sys.modules["pyterrier"] = pt
import fastforward_tpu_torch
for m in pkgutil.walk_packages(fastforward_tpu_torch.__path__, "fastforward_tpu_torch."):
    importlib.import_module(m.name)
src = open("chip_smoke.py").read()
ast.parse(src)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "fastforward_tpu")]
assert not bad, bad
print("ok")
"""
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_every_module_imports_without_h5py_and_transformers():
    """A fresh interpreter in which h5py and transformers cannot be
    imported still imports every module of the port (the disk index and
    the transformer encoders import them only when an index or an encoder
    is built), and neither JAX nor ``fastforward_tpu`` appears."""
    code = """
import importlib, importlib.util, pkgutil, sys, types
for blocked in ("h5py", "transformers"):
    sys.modules[blocked] = None
if importlib.util.find_spec("pyterrier") is None:
    pt = types.ModuleType("pyterrier")
    pt.Transformer = object
    sys.modules["pyterrier"] = pt
import fastforward_tpu_torch
names = [m.name for m in pkgutil.walk_packages(fastforward_tpu_torch.__path__, "fastforward_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert {"fastforward_tpu_torch.index.disk", "fastforward_tpu_torch.encoder.transformer",
        "fastforward_tpu_torch.models.bert"} <= set(names)
from fastforward_tpu_torch.encoder import TCTColBERTQueryEncoder
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "fastforward_tpu")]
assert not bad, bad
print("ok")
"""
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


#: the test files the card runs with ``--noconftest`` (no JAX there)
CARD_TEST_FILES = sorted((REPO / "tests").glob("test_torch_contract_*.py")) + [
    REPO / "tests" / "test_torch_api_parity.py",
    REPO / "tests" / "test_torch_gpu.py",
]


def _jax_imports(path: Path) -> list:
    """The modules of JAX or of ``fastforward_tpu`` that ``path`` imports,
    anywhere in the file."""
    found = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        found += [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "fastforward_tpu")]
    return found


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not _jax_imports(path), path


@pytest.mark.parametrize("path", CARD_TEST_FILES, ids=lambda p: p.name)
def test_card_test_files_import_neither_jax_nor_the_jax_package(path):
    """The contract copies, the API sweep and the card tests run on the
    card's machine with ``--noconftest``, where neither is installed."""
    assert len(CARD_TEST_FILES) > 3 and path.exists(), path
    assert not _jax_imports(path), (path, _jax_imports(path))


def test_index_runs_on_the_card_unless_asked_otherwise():
    if torch.cuda.is_available():
        assert InMemoryIndex().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            InMemoryIndex()
    assert InMemoryIndex(device="cpu").device.type == "cpu"


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Alone in a directory (no package beside it) or without CUDA, the
    smoke run exits non-zero and prints no result."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    out = subprocess.run(
        [sys.executable, str(lone)], cwd=tmp_path, capture_output=True, text=True, timeout=120
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
