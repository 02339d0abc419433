"""Shared test helpers."""
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Property tests run everywhere: with the real Hypothesis we register a
# derandomized profile (examples are a function of the test, not the
# clock — CI and local runs see identical draws); without it the tests
# fall back to the seeded tests/_hypofallback.py shim.
try:
    from hypothesis import HealthCheck as _HealthCheck
    from hypothesis import settings as _hsettings

    _hsettings.register_profile(
        "repro",
        derandomize=True,
        deadline=None,
        max_examples=int(os.environ.get("HYPOTHESIS_MAX_EXAMPLES", "25")),
        suppress_health_check=list(_HealthCheck),
    )
    _hsettings.load_profile(os.environ.get("HYPOTHESIS_PROFILE", "repro"))
except ImportError:  # the shim needs no profile — it is always seeded
    pass


def run_with_devices(code: str, n: int = 8, timeout: int = 900) -> str:
    """Run ``code`` in a subprocess with ``n`` fake CPU devices (the main
    test process must keep the default single device)."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n}"
    src = os.path.join(REPO, "src")
    env["PYTHONPATH"] = src + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
    )
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, env=env,
                       timeout=timeout)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips where there is none")
