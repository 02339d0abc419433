"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import with
JAX blocked, and neither names the JAX package ``repro`` or ``jax`` in an
import statement."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import REPO

PORT = Path(REPO) / "src" / "repro_torch"
SMOKE = Path(REPO) / "chip_smoke.py"
SOURCES = sorted(PORT.rglob("*.py")) + [SMOKE]


def test_port_imports_with_jax_blocked():
    code = f"""
import importlib, pkgutil, sys
sys.modules["jax"] = None            # any `import jax` now raises
sys.path[:0] = [{str(Path(REPO) / "src")!r}, {REPO!r}]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not bad, bad
print(len(names))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[-1]) >= 15     # every module was imported


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("banned", ["repro", "jax"])
def test_no_import_of_reference_or_jax(banned):
    hits = [str(p.relative_to(REPO)) for p in SOURCES
            if banned in set(_imported_roots(p))]
    assert not hits, f"{banned} imported by {hits}"


def test_every_port_module_names_its_reference():
    """Layout mirrors src/repro: each port module's docstring names the
    reference file it follows (or says it is a copy)."""
    missing = []
    for p in PORT.rglob("*.py"):
        if p.name == "__init__.py" or p.name == "build.py":
            continue
        doc = ast.get_docstring(ast.parse(p.read_text())) or ""
        if "repro/" not in doc:
            missing.append(str(p.relative_to(REPO)))
    assert not missing, missing
