"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names; the reference imports the program neither."""
import ast
import subprocess
import sys

import pytest

from benchmark.harness import files, imports

FORBIDDEN = {"jax", "jaxlib", "flax", "stark_verifier_tpu"}


def imported_top_levels(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def sources(sub=""):
    return sorted((files.BENCH / sub).rglob("*.py"))


def test_no_source_imports_jax_or_the_jax_package():
    for path in sources():
        assert not imported_top_levels(path) & FORBIDDEN, path


def test_the_reference_imports_no_program():
    for path in sources("reference"):
        names = imported_top_levels(path)
        assert names <= {"__future__", "copy", "json", "re", "abc", "dataclasses",
                         "typing", "numpy", "torch"}, (path, names)


def test_whole_names_are_compared():
    assert imports.forbidden_loaded(["stark_verifier_tpu_torch", "stark_verifier_tpu_torch.ops",
                                     "jaxtyping", "flaxen"]) == []
    assert imports.forbidden_loaded(["stark_verifier_tpu.core", "jax.numpy", "numpy"]) == [
        "jax", "stark_verifier_tpu"]


@pytest.mark.parametrize("modules,also", [
    ("benchmark.reference.verify", {"stark_verifier_tpu_torch"}),
    ("benchmark.runners.verify_batches, benchmark.control", set()),
])
def test_importing_loads_none(modules, also):
    code = (f"import sys; sys.path.insert(0, {str(files.ROOT)!r}); import {modules}; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=files.ROOT)
    loaded = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & (FORBIDDEN | also)
