"""The result types of the port's Euler API (mirrors
``repro/euler/result.py``): :class:`EulerResult`, and the solver
session's program-cache accounting :class:`CacheStats`, where the
port's program is a recorded CUDA graph (``core/engine.py::FusedRun``)
and a trace is its recording."""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..core.graph import Graph
from ..core.memory import LevelStats, PartitionState
from ..core.phase2 import MergeTree


@dataclasses.dataclass
class CacheStats:
    """Program-cache accounting of a solver session (the reference's
    ``CacheStats``).

    ``bucket``/``hit``/``batch`` describe the solve that produced this
    snapshot; the counters are cumulative over the owning
    :class:`~repro_torch.euler.solver.EulerSolver`.  Programs are cached
    per ``(bucket, batch)``: ``batch`` None for the one-graph program, B
    for a batched one (``solve_batch``).  ``traces`` counts what the
    reference's retrace events count: on a card a fused run's recording,
    on the CPU its first (uncaptured) run, and an engine's first eager
    superstep.

    >>> CacheStats(hits=3, misses=1, traces=1).compiles
    1
    """

    bucket: Optional[Tuple] = None   # shape-bucket key of this solve
    hit: bool = False                # this solve reused a cached program
    batch: int = 1                   # batch width B of this solve's program
    hits: int = 0                    # cumulative (bucket, B) cache hits
    misses: int = 0                  # cumulative (bucket, B) cache misses
    traces: int = 0                  # times a whole-run program was traced
    evictions: int = 0               # (bucket, B) programs dropped by LRU
    prewarms: int = 0                # programs compiled by prewarm()
    state_uploads: int = 0           # host→device EngineState transfers

    @property
    def compiles(self) -> int:
        """Programs actually built (= traces)."""
        return self.traces


@dataclasses.dataclass
class EulerResult:
    """Everything a solve produces.

    ``circuit`` is the Euler circuit of ``graph`` as arrival stubs in walk
    order (stub ``2e`` = edge ``e`` traversed u→v, ``2e+1`` = v→u),
    already stripped of the bucket's dummy edges; ``mate`` still covers
    the padded stub space.
    """

    circuit: np.ndarray              # [E] arrival stubs in walk order
    mate: np.ndarray                 # [2E′] post-splice mate permutation
    tree: MergeTree
    levels: List[LevelStats]         # per-level Int64 state
    supersteps: int
    backend: str = "device"          # the port has the device backend only
    fused: bool = False              # one recorded graph vs eager steps
    device: str = "cuda"             # where the engine ran
    graph: Optional[Graph] = None    # the (unpadded) input graph
    padded_edges: int = 0            # dummy edges added for shape bucketing
    phase3_converged: bool = True
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)
    cache: CacheStats = dataclasses.field(default_factory=CacheStats)
    valid: Optional[bool] = None     # set by validate(); None = unchecked

    def validate(self) -> "EulerResult":
        """Raise ``InvalidCircuitError`` unless ``circuit`` is an Euler
        circuit of ``graph``; returns self so ``solve(g).validate()``
        chains."""
        from ..core.hierholzer import InvalidCircuitError, validate_circuit

        if self.graph is None:
            raise ValueError("result carries no graph to validate")
        try:
            validate_circuit(self.graph, np.asarray(self.circuit,
                                                    dtype=np.int64))
        except InvalidCircuitError:
            self.valid = False
            raise
        self.valid = True
        return self

    @staticmethod
    def levels_from_metrics(metrics_per_level: Iterable[np.ndarray],
                            ) -> List[LevelStats]:
        """Normalize the engine's per-level ``[n, 4]`` Int64-count arrays
        (``[2·parked, 3·opens, 4·touch, 4·components]`` per partition)
        into :class:`LevelStats`."""
        out: List[LevelStats] = []
        for lvl, m in enumerate(metrics_per_level):
            m = np.asarray(m)
            states = [
                PartitionState(
                    pid=pid, level=lvl,
                    remote_copies=int(row[0]) // 2,
                    boundary=0,
                    open_stubs=int(row[1]) // 3,
                    touch=int(row[2]) // 4,
                    components=int(row[3]) // 4,
                )
                for pid, row in enumerate(m)
            ]
            out.append(LevelStats(level=lvl, states=states, phase1_cost={},
                                  phase1_seconds={}, comm_longs={}))
        return out
