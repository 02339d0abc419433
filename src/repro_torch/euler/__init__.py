"""`repro_torch.euler` — the port's public API (mirrors ``repro.euler``).

    from repro_torch.euler import solve, solve_many, solve_batch, EulerSolver

``solve(graph, n_parts=P)`` finds and returns an Euler circuit on the
CUDA device; pass ``device="cpu"`` to run the plain-torch path instead.
``EulerSolver(...)`` is a serving session: ``solve_many`` and repeat
solves reuse its prep memo, resident states and recorded graphs, and
every result carries its :class:`CacheStats`.  ``solve_async`` returns a
:class:`PendingSolve` (over the engine's :class:`PendingRun`) without
waiting for the card, so the host can prepare the next graph meanwhile.
``solve_batch`` (``EulerSolver.solve_batch``, ``solve_batch_async``,
``solve_many(batch=B)``) runs B same-bucket graphs as one program;
``EulerSolver.prewarm`` records a bucket's width ladder ahead of traffic
(``prewarm_async`` on the session's :class:`CompileService` thread), and
:func:`modal_bucket_pool` picks a serving pool of one bucket.
:class:`AutoTuner` drives the compile thread, the program pins and the
tight cap profile from what the serving loop observes.
"""
from ..core.engine import PendingRun
from .autotune import (AutoTuner, CompileService, CompileTicket, FlushLog,
                       TunerParams)
from .bucket import (ceil_pow2, ladder_caps, ladder_floors, ladder_levels,
                     ladder_rounds, ladder_waste, modal_bucket_pool,
                     pad_graph, round_caps, strip_circuit)
from .result import CacheStats, EulerResult
from .solver import (EulerSolver, PendingSolve, resolve_device, solve,
                     solve_batch, solve_many)

__all__ = ["solve", "solve_many", "solve_batch", "EulerSolver",
           "EulerResult", "CacheStats", "PendingSolve", "PendingRun",
           "resolve_device", "ceil_pow2", "modal_bucket_pool", "pad_graph",
           "round_caps", "strip_circuit",
           "ladder_caps", "ladder_floors", "ladder_levels", "ladder_rounds",
           "ladder_waste",
           "AutoTuner", "CompileService", "CompileTicket", "FlushLog",
           "TunerParams"]
