"""Nothing under benchmark/ imports JAX or the JAX package (compared by
whole top-level name: the port's name begins with the JAX package's), and
the reference imports nothing of the port."""

import ast
import pathlib

import pytest

HERE = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "tfhe_aes2_tpu"}
SOURCES = sorted(HERE.rglob("*.py"))


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_plain(path):
    assert set(top_level_imports(path)) <= {"__future__", "numpy",
                                            "benchmark"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module.startswith(
                "benchmark"):
            assert node.module == "benchmark.reference"


def test_run_refuses_jax_by_whole_name(monkeypatch):
    import sys
    import types

    from benchmark import run
    monkeypatch.setitem(sys.modules, "tfhe_aes2_tpu_torch_x",
                        types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tfhe_aes2_tpu.ops",
                        types.ModuleType("y"))
    assert run.forbidden_modules() == ["tfhe_aes2_tpu"]
