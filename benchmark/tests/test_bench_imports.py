"""No module of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the port: every import statement of every module
under benchmark/, its top-level name compared whole (`pytorch3dunet_tpu_torch`
begins with `pytorch3dunet_tpu`, and is not it)."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REFUSED_EVERYWHERE = {"jax", "jaxlib", "flax", "pytorch3dunet_tpu"}
REFUSED_IN_REFERENCE = REFUSED_EVERYWHERE | {"pytorch3dunet_tpu_torch"}


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", None)) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


MODULES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_module_imports_no_jax(path):
    refused = REFUSED_IN_REFERENCE if "reference" in path.relative_to(BENCH).parts else REFUSED_EVERYWHERE
    assert not top_level_imports(path) & refused, f"{path} imports {top_level_imports(path) & refused}"


def test_names_are_compared_whole(tmp_path):
    source = tmp_path / "m.py"
    source.write_text("import pytorch3dunet_tpu_torch.ops\nfrom jax import numpy\nimport jaxlib_free\n")
    found = top_level_imports(source)
    assert found == {"pytorch3dunet_tpu_torch", "jax", "jaxlib_free"}
    assert found & REFUSED_EVERYWHERE == {"jax"}
    assert found & REFUSED_IN_REFERENCE == {"jax", "pytorch3dunet_tpu_torch"}
