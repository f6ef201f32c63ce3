"""The import fence: nothing of the benchmark imports JAX or the JAX package
``repro`` (top-level names compared whole: ``repro_torch`` is the port, not
``repro``), and the yardstick (``reference/``, ``counts/``) imports nothing
of the port either."""

import ast

import pytest

from arches_bench import cells

MODULES = sorted(p for p in cells.BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(cells.BENCH)))
def test_no_jax_or_reference_package(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", [p for p in MODULES
                                  if p.relative_to(cells.BENCH).parts[0] in ("reference", "counts")],
                         ids=lambda p: str(p.relative_to(cells.BENCH)))
def test_yardstick_imports_nothing_of_the_port(path):
    assert "repro_torch" not in top_level_imports(path)


def test_fence_sees_whole_names(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import repro_torch.core\nfrom repro.phy import nr\nimport jaxlib\n")
    assert top_level_imports(src) == {"repro_torch", "repro", "jaxlib"}
