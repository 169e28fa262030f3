"""No module of the benchmark imports JAX or the JAX package, and the
plain reference imports nothing of the program under test.  Top-level
names are compared whole: ``repro_torch`` is not ``repro``."""

import ast

import pytest

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported_top_levels(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    bad = imported_top_levels(path) & FORBIDDEN
    if path.is_relative_to(BENCH / "reference"):
        bad |= imported_top_levels(path) & {"repro_torch"}
    assert not bad, f"{path.name} imports {sorted(bad)}"


def test_the_guard_reads_whole_top_level_names(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import repro_torch.serving\nfrom repro.core import x\n"
                     "import jaxtyping\nimportlib.import_module('jax.numpy')\n")
    assert imported_top_levels(probe) == {"repro_torch", "repro", "jaxtyping", "jax"}


def test_a_run_checks_the_loaded_modules():
    import harness

    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "repro")
    assert "repro" not in harness.forbidden_modules()
