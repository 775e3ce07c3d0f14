"""The port stands alone: every module of ``repro_torch``, the port's
examples' imports and ``chip_smoke.py`` load with ``jax`` made unimportable,
and no file of the port names the JAX package ``repro`` as a module."""

import ast
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")
EXAMPLES = [os.path.join(REPO, "examples", n)
            for n in ("quickstart_torch.py", "cold_start_comparison_torch.py", "train_e2e_torch.py")]
STANDALONE = EXAMPLES + [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "kernel_ab.py")]


def _port_files():
    for dirpath, _, names in os.walk(PORT):
        yield from (os.path.join(dirpath, n) for n in names if n.endswith(".py"))


def _imported_modules(path: str) -> set:
    mods = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
    return mods


def test_every_port_module_imports_without_jax():
    example_imports = sorted(set().union(*(_imported_modules(p) for p in EXAMPLES)))
    code = f"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any "import jax" now raises ImportError
sys.path.insert(0, {os.path.join(REPO, "src")!r})
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names + {example_imports!r}:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m == "repro" or m.startswith(("repro.", "jax.")))
assert not bad, bad
print(len(names))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 40  # the whole package was walked


def test_no_port_file_names_the_jax_package():
    pattern = re.compile(r"^\s*(?:from|import)\s+(?:repro|jax)(?:\.|\s|,|$)", re.M)
    offenders = {}
    for path in list(_port_files()) + STANDALONE:
        mods = _imported_modules(path)
        hits = sorted(m for m in mods if m.split(".")[0] in ("repro", "jax"))
        if hits or pattern.search(open(path).read()):
            offenders[os.path.relpath(path, REPO)] = hits
    assert not offenders, offenders
