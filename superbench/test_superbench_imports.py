"""Nothing the benchmark runs loads JAX or the JAX package (names compared
whole: ``repro_torch`` begins with ``repro``), the reference loads
nothing of the program, and no file reads the old benchmark's folders."""
import ast
import importlib
import sys
from pathlib import Path

import pytest

from superbench import run, spec

HERE = Path(spec.__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in HERE.rglob("*.py")
                 if not p.name.startswith("test_"))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_forbidden_import(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & FORBIDDEN, tops & FORBIDDEN
    text = path.read_text()
    assert "benchmarks/" not in text and "tools/bench_diff" not in text


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not {m.split(".")[0] for m in _imports(path)} & {"repro_torch"}


class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError(f"blocked: {name}")
        return None


def test_harness_imports_with_jax_blocked():
    saved = {k: v for k, v in sys.modules.items()
             if k.split(".")[0] == "superbench"}
    for k in saved:
        del sys.modules[k]
    block = _Block()
    sys.meta_path.insert(0, block)
    try:
        for mod in ("superbench.run", "superbench.sweep",
                    "superbench.calibrate", "superbench.reference.lm"):
            importlib.import_module(mod)
        for m in spec.benchmark()["end_to_end"] + \
                spec.benchmark()["per_layer"]:
            spec.reader(m["name"])
    finally:
        sys.meta_path.remove(block)
        sys.modules.update(saved)


def test_forbidden_names_compared_whole():
    assert run.forbidden_modules(["repro_torch", "repro_torch.models",
                                  "jaxtyping", "numpy"]) == []
    assert run.forbidden_modules(["repro_torch", "repro.models", "jax",
                                  "jaxlib.xla"]) == ["jax", "jaxlib",
                                                     "repro"]
