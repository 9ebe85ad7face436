"""Nothing of the benchmark imports JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), the
reference imports nothing of the program, and nothing reads the JAX
package's records."""
from __future__ import annotations

import ast
import os

import pytest

from conftest import BENCH_DIR
from harness import guard

FORBIDDEN = {"jax", "jaxlib", "flax", "slr_tpu"}
RECORDS = ("bench.py", "BASELINE.json", "BENCH_r0", "MULTICHIP_r0")


def sources():
    for d, _, files in os.walk(BENCH_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, BENCH_DIR))
def test_no_jax(path):
    assert not FORBIDDEN & set(imported(path))
    if path == os.path.abspath(__file__):
        return                  # this file names the records it looks for
    text = open(path, encoding="utf-8").read()
    assert not any(r in text for r in RECORDS if r != "bench.py")
    assert "bench.py\"" not in text and "'bench.py'" not in text


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH_DIR, "reference")
    for d, _, files in os.walk(ref):
        for f in files:
            if f.endswith(".py"):
                assert "slr_tpu_torch" not in set(imported(os.path.join(d, f)))


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_modules(["slr_tpu_torch", "slr_tpu_torch.x",
                                    "jaxtyping", "opt_einsum.backends.jax"]
                                   ) == []
    assert guard.forbidden_modules(["slr_tpu.render", "jax.numpy",
                                    "flax"]) == ["flax", "jax.numpy",
                                                 "slr_tpu.render"]
