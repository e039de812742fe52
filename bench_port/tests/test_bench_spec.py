"""BENCHMARK.json against the contract's characters, and the import check."""

import ast
import json
import subprocess
import sys

from bench_port import run, spec
from bench_port.tests.conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


def _names():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[key]:
            yield entry["name"]
    for w in BENCH["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in BENCH["configs"]:
        yield from c["reduced"]


def test_names_units_and_lines_use_the_allowed_characters():
    assert all(spec.NAME.fullmatch(n) for n in _names())
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert all(spec.UNIT.fullmatch(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    lines = [w["why"] for w in BENCH["workloads"]] + [c["source"] for c in BENCH["configs"]]
    lines += [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"]
    assert all(0 < len(s) <= 200 and "\n" not in s and "\t" not in s for s in lines)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for cell in m.get("workloads", cells):
            assert cell in cells and spec.reports(e2e[m["moves"]], cell), (m["name"], cell)
    for cell in cells:
        reported = [m for m in BENCH["end_to_end"] if spec.reports(m, cell)]
        assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
        assert any(spec.reports(m, cell) for m in BENCH["per_layer"])


def test_every_piece_of_every_cell_is_found():
    for w in BENCH["workloads"]:
        cell = spec.find_cell(REPO, w["name"])
        assert cell.limits and cell.config["name"] == w["config"]
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.reader(REPO, m["name"]))


def test_the_import_check_compares_whole_top_level_names():
    assert run.forbidden_modules(["fastforward_tpu_torch", "fastforward_tpu_torch.index", "numpy"]) == []
    assert run.forbidden_modules(["jax.numpy", "numpy"]) == ["jax"]
    assert run.forbidden_modules(["fastforward_tpu.ops.scoring"]) == ["fastforward_tpu"]
    assert run.forbidden_modules(["flax", "jaxlib.xla_client"]) == ["flax", "jaxlib"]


def _imports(nodes):
    for node in nodes:
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def _program(mods):
    return [m for m in mods if m.split(".")[0] in ("jax", "fastforward_tpu", "fastforward_tpu_torch")]


def test_the_reference_and_the_yardstick_import_nothing_of_the_program():
    for name in ("reference", "data", "roofline", "trace", "check", "spec"):
        tree = ast.parse((REPO / "bench_port" / f"{name}.py").read_text())
        assert not _program(_imports(ast.walk(tree))), name
    # a plug-in imports the program only inside the functions that drive it:
    # never at its top level, and never in an encoder's ``reference`` or
    # ``least_s``
    for folder in ("encoders", "indexes", "loops", "metrics"):
        for path in (REPO / "bench_port" / folder).glob("*.py"):
            tree = ast.parse(path.read_text())
            assert not _program(_imports(tree.body)), path.name
            for fn in tree.body:
                if isinstance(fn, ast.FunctionDef) and fn.name in ("reference", "least_s"):
                    assert not _program(_imports(ast.walk(fn))), (path.name, fn.name)
    code = ("import sys; import bench_port.reference, bench_port.check, bench_port.trace; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'fastforward_tpu', 'fastforward_tpu_torch', 'transformers'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def _command(root, cwd):
    cell = BENCH["workloads"][0]["name"]
    return subprocess.run([sys.executable, str(root / "bench_port" / "run.py"), "--workload", cell,
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_the_command_refuses_without_a_card_and_prints_no_result():
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = _command(REPO, REPO)
    assert out.returncode == 2 and out.stdout.strip() == ""


def test_the_command_fails_with_the_benchmark_alone(tmp_path):
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path, tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
