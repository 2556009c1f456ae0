"""Static checks of what the benchmark's modules import and read: no
module loads JAX or the JAX package (top-level names compared whole),
the yardstick imports nothing of the program, and nothing reads the
older benchmark folder."""

import ast

import pytest

from pbench_tiny import BENCH_DIR

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
# the yardstick: the reference, the generator and its kinds, the
# comparison and each hierarchy's reference, the work count and the span
# arithmetic
YARDSTICK = ("pbench/ref/", "pbench/gen.py", "pbench/traffic.py",
             "pbench/judge.py", "pbench/cost.py", "pbench/trace.py",
             "pbench/spec.py", "kinds/", "refs/")
# kind and reference files build on numpy and the harness alone
FOUND_BY_NAME = ("kinds/", "refs/")
OLD_FOLDER = "bench" + "marks"
SOURCES = sorted(p for p in BENCH_DIR.rglob("*.py")
                 if "__pycache__" not in p.parts)


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def rel(path) -> str:
    return path.relative_to(BENCH_DIR).as_posix()


@pytest.mark.parametrize("path", SOURCES, ids=rel)
def test_no_jax_and_no_old_folder(path):
    names = top_level_imports(path)
    assert not names & FORBIDDEN
    assert OLD_FOLDER not in names
    if path.name != "test_portbench_imports.py":
        assert OLD_FOLDER + "/" not in path.read_text()


@pytest.mark.parametrize("path", [p for p in SOURCES
                                  if rel(p).startswith(YARDSTICK)], ids=rel)
def test_yardstick_imports_nothing_of_the_program(path):
    assert "repro_torch" not in top_level_imports(path)


@pytest.mark.parametrize("path", [p for p in SOURCES
                                  if rel(p).startswith(FOUND_BY_NAME)],
                         ids=rel)
def test_kinds_and_references_import_numpy_and_pbench_only(path):
    assert top_level_imports(path) <= {"numpy", "pbench", "__future__"}


def test_kinds_and_references_are_scanned():
    scanned = {rel(p) for p in SOURCES}
    assert {"kinds/graph/stencil.py", "kinds/graph/cube_sphere.py",
            "kinds/machine/gemini-torus.py",
            "kinds/allocation/hilbert-sfc.py", "refs/flat.py",
            "refs/node.py"} <= scanned


def test_the_run_check_compares_names_whole():
    from pbench.cell import forbidden_modules
    assert forbidden_modules(["repro_torch", "repro_torch.serve", "jaxtyping",
                              "reprolib", "numpy"]) == []
    assert forbidden_modules(["repro.core", "jax", "jaxlib.xla_client",
                              "flax"]) == ["flax", "jax", "jaxlib", "repro"]
