"""The import guard: top-level module names compared whole; no `jax`,
`jaxlib`, `flax` or `kme_tpu` in a run; nothing of the program in the
reference; no torch in the generator and consumer children."""

import ast
import os
import subprocess
import sys

from kmebench import spec as S
from kmebench.run import FORBIDDEN, forbidden_modules


def test_names_compare_whole():
    assert forbidden_modules(["kme_tpu_torch", "kme_tpu_torch.bridge",
                              "torch", "jaxtyping", "kme_tpux"]) == []
    assert forbidden_modules(["kme_tpu.wire", "jax.numpy", "flax",
                              "jaxlib.xla_client"]) == [
        "flax", "jax", "jaxlib", "kme_tpu"]
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "kme_tpu"}


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(S.HERE, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            tops = set(_imports(os.path.join(ref, f)))
            assert not tops & {"kme_tpu_torch", "kme_tpu", "jax", "jaxlib",
                               "flax", "torch"}, f


def test_no_file_of_the_harness_imports_jax_or_the_jax_package():
    for d, _, files in os.walk(S.HERE):
        for f in files:
            if f.endswith(".py"):
                tops = set(_imports(os.path.join(d, f)))
                assert not tops & {"kme_tpu", "jax", "jaxlib", "flax"}, f


def test_the_children_load_no_torch():
    code = ("import sys, kmebench.gen, kmebench.consumer, kmebench.client;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'kme_tpu_torch', 'kme_tpu', 'jax')];"
            "assert not bad, bad")
    r = subprocess.run([sys.executable, "-c", code], cwd=S.ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
