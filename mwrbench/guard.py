"""The import guard: nothing the benchmark runs may load JAX or the JAX
package, and the reference may not import the program it judges.

Module names are compared by their top-level name (the part before the
first dot), whole: the port's name begins with the JAX package's name, and
the port is allowed.
"""

import ast
import sys
from pathlib import Path

JAX_PACKAGE = "mwr_fast_forward_operators_and_lbls_tpu"
PORT = JAX_PACKAGE + "_torch"
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", JAX_PACKAGE})
REFERENCE_DIR = Path(__file__).resolve().parent / "reference"


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules=None) -> list:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if top_level(n) in FORBIDDEN)


def _imported_names(path: Path) -> set:
    """The modules a source file imports, by their full dotted name
    (relative imports are left out: they stay inside this folder)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


def reference_imports_program(directory: Path = REFERENCE_DIR) -> list:
    """(file, module) pairs where the reference imports the port or a
    forbidden module."""
    bad = FORBIDDEN | {PORT}
    return sorted((p.name, m) for p in directory.glob("*.py")
                  for m in _imported_names(p) if top_level(m) in bad)


def check(stage: str) -> None:
    """Raise with the names found where a forbidden module is loaded, or
    the reference imports the program."""
    found = forbidden_loaded()
    if found:
        raise RuntimeError(f"{stage}: forbidden modules loaded: "
                           f"{', '.join(found)}")
    refs = reference_imports_program()
    if refs:
        raise RuntimeError(f"{stage}: the reference imports "
                           f"{', '.join(f'{m} ({f})' for f, m in refs)}")
