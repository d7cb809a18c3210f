"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference, the traffic generator and the bounds import nothing of the
program."""

import ast
import os
import subprocess
import sys

import pytest

from vinsbench import harness as H

ROOT = os.path.dirname(H.BENCH_DIR)
PROGRAM = "vins_rgbd_fast_torch"
YARDSTICK = ("reference", "traffic", "bounds.py", "trace.py", "check.py")


def _modules():
    for d, _, files in os.walk(H.BENCH_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imported(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_modules()), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_module_imports_jax(path):
    assert not set(_imported(path)) & set(H.FORBIDDEN)


def test_the_yardstick_imports_nothing_of_the_program():
    for path in _modules():
        rel = os.path.relpath(path, H.BENCH_DIR)
        if rel.split(os.sep)[0] in YARDSTICK:
            assert PROGRAM not in set(_imported(path)), rel


def test_a_loaded_reference_brings_no_program_module():
    code = ("import sys, vinsbench.check, vinsbench.bounds, vinsbench.trace, "
            "vinsbench.reference.frontend, vinsbench.reference.estimator, "
            "vinsbench.traffic.synthetic; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            f"{{'{PROGRAM}', 'jax', 'jaxlib', 'flax', 'vins_rgbd_fast_tpu'}}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 0 and p.stdout.strip() == "[]", p.stderr


def test_forbidden_names_are_compared_whole():
    assert H.forbidden_modules(["vins_rgbd_fast_torch.ops.lk", "vins_rgbd_fast_tpux",
                                "jaxtyping"]) == []
    assert H.forbidden_modules(["jax.numpy", "vins_rgbd_fast_tpu.ops", "flax"]) == [
        "flax", "jax", "vins_rgbd_fast_tpu"]
