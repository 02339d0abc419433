"""Program audit of the fused Euler programs (mirrors ``repro/analysis``).

  ``repro_torch.analysis.graph_audit``  audits each ``(bucket, B)``
                                        program the solver would cache
                                        against the engine's published
                                        schedule: the recording's calls at
                                        the port's stand-ins for the
                                        reference's collectives and
                                        kernels, and on a card the node
                                        census of the recorded CUDA graph;
                                        plus the static per-program byte
                                        cost of the solver's budget.
                                        ``python -m repro_torch.analysis.audit``

The reference's second pass, the AST lint of ``repro/analysis/lint.py``,
stays the JAX package's: it lints the whole of ``src/``, the port
included, and this package does not run it.
"""
from .graph_audit import (COLLECTIVES, ENGINE_STATE_LANES, ProgramAudit,
                          audit_graph, audit_program, census,
                          engine_state_bytes, expected_kernel_launches,
                          kernel_cost_model, program_cost_bytes)

__all__ = [
    "COLLECTIVES", "ENGINE_STATE_LANES", "ProgramAudit", "audit_graph",
    "audit_program", "census", "engine_state_bytes",
    "expected_kernel_launches", "kernel_cost_model", "program_cost_bytes",
]
