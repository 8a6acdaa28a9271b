"""The import guard: no module of the benchmark imports JAX or the JAX
package, and no module of its plain reference imports the program.
Names are compared by their top-level part, whole: the program's name
begins with the JAX package's."""

import ast
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "bmsparse_tpu"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


MODULES = sorted(PB.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(PB)) for p in MODULES])
def test_no_jax(path):
    assert not top_level_imports(path) & BANNED


@pytest.mark.parametrize("path", sorted((PB / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_independent_of_the_program(path):
    assert "bmsparse_tpu_torch" not in top_level_imports(path)


def test_the_guard_reads_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import bmsparse_tpu_torch.ops\nfrom jax.numpy import x\n"
                 "import jaxtyping\n")
    assert top_level_imports(f) == {"bmsparse_tpu_torch", "jax",
                                    "jaxtyping"}
    assert top_level_imports(f) & BANNED == {"jax"}
