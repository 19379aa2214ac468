"""Nothing under portbench/ imports JAX or the JAX package, and the plain
reference imports nothing of the measured program."""

import ast
import os
import subprocess
import sys

import pytest

from portbench import harness

REPO = os.path.dirname(harness.ROOT)
FORBIDDEN = {"jax", "jaxlib", "flax", "mcpilco_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value


def _files(root):
    for d, _, fs in os.walk(root):
        yield from (os.path.join(d, f) for f in fs if f.endswith(".py"))


def test_top_level_names_are_compared_whole():
    assert "mcpilco_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "mcpilco_tpu.models".split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", sorted(_files(harness.ROOT)),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_module_imports_jax(path):
    assert not {m.split(".")[0] for m in _imports(path)} & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in _files(os.path.join(harness.ROOT, "reference")):
        assert not any(m.split(".")[0] == "mcpilco_tpu_torch" for m in _imports(path)), path
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference.common, portbench.reference.cartpole, "
            "portbench.reference.furuta; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'mcpilco_tpu_torch', 'mcpilco_tpu', 'jax'}))") % REPO
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


def test_a_run_loads_no_jax():
    code = ("import sys, time; sys.path.insert(0, %r); import torch; torch.set_num_threads(2); "
            "from portbench import harness; from portbench.tests import tiny; "
            "tiny.run('cartpole.opt'); print(harness.forbidden_modules())") % REPO
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
