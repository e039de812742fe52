"""The port's public API against ``fastforward_tpu``'s, by an AST sweep.

Every public class, method (and the dunders the reference API exposes),
module-level function, upper-case module constant and parameter of
``fastforward_tpu/`` must exist at the same module path in
``fastforward_tpu_torch/``, or stand in the table of differences of
``fastforward_tpu_torch/docs/port.md``, which says where the capability
lives in the port or why it does not apply.  A table row the port no
longer needs fails too, so the page cannot drift from the code.  The
sweep parses the sources (the logic of ``scripts/parity_sweep.py``) and
imports neither package.
"""

import ast
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX_ROOT, PORT_ROOT = REPO / "fastforward_tpu", REPO / "fastforward_tpu_torch"
DOCS_PAGE = PORT_ROOT / "docs" / "port.md"
TABLE_HEADING = "## Differences from `fastforward_tpu`"

DUNDERS = {
    "__init__", "__call__", "__len__", "__getitem__", "__eq__", "__repr__",
    "__contains__", "__iter__", "__add__", "__mul__",
}
CONSTANT = re.compile(r"^[A-Z][A-Z0-9_]*$")


def _params(fn) -> list:
    a = fn.args
    return [
        p.arg for p in a.posonlyargs + a.args + a.kwonlyargs
        if p.arg not in ("self", "cls") and not p.arg.startswith("_")
    ]


def symbols_of_source(source: str) -> dict:
    """``{name: params or None}`` of one module's source: classes and their
    public methods (``Class.method``), functions, upper-case constants."""
    out = {}
    for node in ast.parse(source).body:
        if isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            out[node.name] = None
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
                    not item.name.startswith("_") or item.name in DUNDERS
                ):
                    out.setdefault(f"{node.name}.{item.name}", _params(item))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and not node.name.startswith("_"):
            out[node.name] = _params(node)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            out.update({t.id: None for t in targets if isinstance(t, ast.Name) and CONSTANT.match(t.id)})
    return out


def collect(root: Path) -> dict:
    """``{module path: symbols}`` of every module of a package (``ops/
    scoring.py`` is ``ops.scoring``, ``ops/__init__.py`` is ``ops``)."""
    out = {}
    for path in sorted(root.rglob("*.py")):
        parts = path.relative_to(root).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out[".".join(parts) or "."] = symbols_of_source(path.read_text())
    return out


def missing(jax: dict, port: dict) -> set:
    """The JAX names without a counterpart at the same path in the port:
    ``module:*``, ``module:name`` or ``module:name(parameter)``."""
    out = set()
    for mod, syms in jax.items():
        theirs = port.get(mod)
        if theirs is None:
            out.add(f"{mod}:*")
            continue
        for name, params in syms.items():
            if name not in theirs:
                out.add(f"{mod}:{name}")
            elif params is not None:
                out.update(f"{mod}:{name}({p})" for p in params if p not in (theirs[name] or []))
    return out


def differences_table() -> dict:
    """``{name: where it lives in the port}`` from the docs page's table."""
    text = DOCS_PAGE.read_text()
    assert TABLE_HEADING in text, f"{DOCS_PAGE} has no '{TABLE_HEADING}' section"
    rows = {}
    for line in text.split(TABLE_HEADING, 1)[1].splitlines():
        m = re.match(r"^\| `([^`]+)` \| (.*) \|$", line.strip())
        if m:
            assert m.group(1) not in rows, f"{m.group(1)} stands twice in the table"
            rows[m.group(1)] = m.group(2).strip()
    return rows


def unaccounted(jax: dict, port: dict, table: dict) -> tuple:
    """(missing names the table does not list, table rows the port does
    not need)."""
    gaps = missing(jax, port)
    return sorted(gaps - set(table)), sorted(set(table) - gaps)


def test_every_jax_name_is_ported_or_listed():
    table = differences_table()
    assert table, "the docs page's table of differences is empty"
    assert all(table.values()), [k for k, v in table.items() if not v]
    unlisted, stale = unaccounted(collect(JAX_ROOT), collect(PORT_ROOT), table)
    assert not unlisted, f"names of fastforward_tpu missing from the port and from {DOCS_PAGE.name}: {unlisted}"
    assert not stale, f"rows of {DOCS_PAGE.name} that name what the port has: {stale}"


#: invented JAX sources, one per kind of name the sweep covers, and what the
#: guard must report for each (module ``ops.scoring`` unless it is new)
INVENTED = {
    "function": ("def invented_topk(scores, k):\n    pass\n", ["ops.scoring:invented_topk"]),
    "constant": ("INVENTED_TILE_ROWS = 4096\n", ["ops.scoring:INVENTED_TILE_ROWS"]),
    "class": (
        "class InventedTable:\n    def gather(self, rows):\n        pass\n",
        ["ops.scoring:InventedTable", "ops.scoring:InventedTable.gather"],
    ),
    "parameter": (
        "def streamed_scores(invented_knob=None):\n    pass\n",
        ["ops.scoring:streamed_scores(invented_knob)"],
    ),
    "module": ("def anything():\n    pass\n", ["ops.invented_module:*"]),
}


@pytest.mark.parametrize("kind", sorted(INVENTED))
def test_the_guard_bites_on_an_invented_jax_name(kind):
    """A JAX name the port lacks and the table does not list fails the
    sweep, for each kind of name; the real packages alone pass it."""
    source, want = INVENTED[kind]
    jax, port, table = collect(JAX_ROOT), collect(PORT_ROOT), differences_table()
    mod = "ops.invented_module" if kind == "module" else "ops.scoring"
    syms = jax.setdefault(mod, {})
    for name, params in symbols_of_source(source).items():
        # an invented parameter joins the function's own
        syms[name] = None if params is None else (syms.get(name) or []) + params
    unlisted, stale = unaccounted(jax, port, table)
    assert unlisted == sorted(want) and not stale
    # listing the invented names in the table accounts for them
    assert unaccounted(jax, port, {**table, **{w: "invented" for w in want}}) == ([], [])
