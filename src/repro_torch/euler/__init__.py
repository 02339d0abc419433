"""`repro_torch.euler` — the port's public API (mirrors ``repro.euler``).

    from repro_torch.euler import solve, EulerSolver

``solve(graph, n_parts=P)`` finds and returns an Euler circuit on the
CUDA device; pass ``device="cpu"`` to run the plain-torch path instead.
"""
from .result import EulerResult
from .solver import EulerSolver, resolve_device, solve

__all__ = ["solve", "EulerSolver", "EulerResult", "resolve_device"]
