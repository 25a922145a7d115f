"""Nothing the benchmark runs imports JAX or the JAX package (compared by
whole top-level names: the port's name begins with the JAX package's),
and the plain references import nothing of the port."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "sparkucx_tpu"}


def imported_tops(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            yield node.args[0].value.split(".")[0]


def run_files():
    return sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", run_files(),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not set(imported_tops(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "sparkucx_tpu_torch" not in set(imported_tops(path))


def test_the_scan_compares_whole_top_level_names(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import sparkucx_tpu_torch.models\n"
                     "from sparkucx_tpu_torch import connect\n"
                     "import importlib\n"
                     "importlib.import_module('jax.numpy')\n"
                     "from sparkucx_tpu.ops import x\n")
    assert set(imported_tops(probe)) == {"sparkucx_tpu_torch", "importlib",
                                         "jax", "sparkucx_tpu"}
