"""Nothing in portbench imports JAX or the JAX package, and the plain
reference imports nothing of the program. Module names are compared by
their top-level name (the part before the first dot) as a whole, so
txt2vid_tpu_torch is not taken for txt2vid_tpu."""

import ast

import pytest

from portbench.manifest import HERE

FORBIDDEN = {"jax", "jaxlib", "flax", "txt2vid_tpu"}


def imported_tops(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(HERE)) for p in SOURCES])
def test_no_jax(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = imported_tops(path)
    assert "txt2vid_tpu_torch" not in tops
    assert tops <= {"contextlib", "contextvars", "math", "numpy", "torch", "portbench"}


def test_top_level_names_are_compared_whole():
    from portbench.run import FORBIDDEN as RUN_FORBIDDEN
    assert "txt2vid_tpu_torch".split(".")[0] not in RUN_FORBIDDEN
    assert "txt2vid_tpu.models".split(".")[0] in RUN_FORBIDDEN
