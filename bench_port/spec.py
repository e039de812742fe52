"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the root of the checkout lists the cells; each piece
of a cell lives in a file of its own under this folder, found by name:

- ``configs/<config>.json``: the configuration (the file the entry names);
- ``traffic/<traffic>.json``: the traffic mix's parameters;
- ``limits/<cell>.json``: the limit of each number the check compares;
- ``metrics/<metric>.py``: the reader of one metric, a ``read(run)``
  function that returns the value or ``None`` where it finds nothing;
- ``loops/<loop>.py``: the driver of the mixes whose ``loop`` names it
  (``pools``, ``measure``, ``answers``);
- ``encoders/<encoder>.py``: a query encoder, named by the configuration's
  ``encoder`` or by the mix's where the mix brings its own (``make`` for
  the program, ``reference`` and ``least_s`` for the yardstick);
- ``indexes/<index>.py``: the builder of the configuration's ``index``
  (``build``).

A new configuration, mix, cell or metric is therefore new files and new
entries in ``BENCHMARK.json``; no file here changes.  A module of
``loops/``, ``encoders/`` or ``indexes/`` imports the program only inside
the functions that drive it, so the reference can use its other parts.
"""

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


@dataclass
class Cell:
    name: str
    entry: dict  # the workloads entry
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # metric entries this cell reports with --trace 0
    per_layer: list  # ... and with --trace 1
    root: Path


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric`` (every cell, without a list)."""
    return cell in metric.get("workloads", [cell])


def find_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with all its pieces.

    :raises KeyError: When no cell has that name.
    :raises FileNotFoundError: When a piece's file is missing.
    """
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    here = root / HERE.name
    return Cell(
        name=name,
        entry=entry,
        config=load_json(root / cfg_entry["file"]),
        traffic=load_json(here / "traffic" / f"{entry['traffic']}.json"),
        limits=load_json(here / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if reports(m, name)],
        root=root,
    )


def plugin(root: Path, folder: str, name: str):
    """The module ``<folder>/<name>.py`` of the benchmark under ``root``.

    :raises FileNotFoundError: When there is no such file.
    """
    path = root / HERE.name / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder[:-1]} {name!r}: {path} is missing")
    key = f"bench_{folder}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}"
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(root: Path, metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    return plugin(root, "metrics", metric).read


def encoder_name(cell: Cell) -> str:
    """The cell's query encoder: the mix's own, else the configuration's."""
    return cell.traffic.get("encoder") or cell.config["encoder"]
