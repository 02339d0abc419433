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
    assert int(r.stdout.split()[-1]) >= 28     # every module was imported


@pytest.mark.parametrize("module", ["repro_torch.launch.serve",
                                    "repro_torch.euler.autotune",
                                    "repro_torch.models.transformer",
                                    "repro_torch.kernels.ops",
                                    "repro_torch.configs.registry"])
def test_serving_slice_imports_with_jax_blocked(module):
    """The serving slices' entry points (LM and Euler) stand alone, each
    imported first in a fresh process."""
    code = f"""
import importlib, sys
sys.modules["jax"] = None
sys.path[:0] = [{str(Path(REPO) / "src")!r}]
importlib.import_module({module!r})
bad = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not bad, bad
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("module", ["repro_torch.obs", "repro_torch.euler",
                                    "repro_torch.analysis",
                                    "repro_torch.analysis.audit"])
def test_session_slice_imports_with_jax_blocked(module):
    """The solver session and its observability layer (the port's copy of
    ``repro/obs``, stdlib only) stand alone, each imported first in a
    fresh process."""
    code = f"""
import importlib, sys
sys.modules["jax"] = None
sys.path[:0] = [{str(Path(REPO) / "src")!r}]
importlib.import_module({module!r})
bad = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not bad, bad
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_host_engine_imports_and_solves_with_jax_blocked():
    """The host backend stands alone: ``repro_torch.core.host_engine``
    imported first in a fresh process with JAX blocked, then a host solve
    through the facade."""
    code = f"""
import importlib, sys
sys.modules["jax"] = None
sys.path[:0] = [{str(Path(REPO) / "src")!r}]
importlib.import_module("repro_torch.core.host_engine")
from repro_torch.euler import solve
from repro_torch.graphgen.eulerize import eulerian_rmat
res = solve(eulerian_rmat(6, avg_degree=4, seed=0), backend="host")
assert res.validate().valid and res.backend == "host"
bad = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not bad, bad
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_autotuner_imports_and_serves_with_jax_blocked():
    """The autotuner stands alone: ``repro_torch.euler.autotune`` imported
    first in a fresh process with JAX blocked, a ``plan`` step, then
    ``main_euler --adaptive`` on the CPU at scale 5 (its compile thread
    records the B = 2 program and stops)."""
    code = f"""
import importlib, sys, threading
sys.modules["jax"] = None
sys.path[:0] = [{str(Path(REPO) / "src")!r}]
at = importlib.import_module("repro_torch.euler.autotune")
dec = at.plan(at.TunerSnapshot(
    buckets={{(128, 8): at.BucketStats(4.0, {{8: 2.0}})}},
    warmed={{(128, 8): [1]}}, pinned=[]))
assert [(k, w) for k, w, _ in dec.prewarm] == [((128, 8), 8)], dec
from repro_torch.launch import serve
serve.main_euler(["--device", "cpu", "--scale", "5", "--parts", "2",
                  "--same-bucket", "--pool", "2", "--max-batch", "2",
                  "--requests", "6", "--adaptive"])
assert not any(t.name == "compile-service" for t in threading.enumerate())
bad = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not bad, bad
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "adaptive: first wide flush" in r.stdout


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
