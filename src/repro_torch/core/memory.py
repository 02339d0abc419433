"""Memory-state accounting in Int64 counts (paper Fig. 8/9) + §5 model.

The paper reports "the number of Int64 (8-byte Long) values maintained as
part of the partitions' state at different levels ... a platform-independent
metric of the algorithm's memory use".  We reproduce that metric exactly:

  per active partition after its Phase 1 at a level:
    remote edges held   : 2 longs per *directed copy* (src, dst)
                          (baseline: each side of a cut edge holds one copy;
                           remote_dedup: only the heavier side holds it)
    boundary vertices   : 1 long per vertex id
    open path endpoints : 3 longs (stub, vertex, component)
    touch entries       : 4 longs (component, vertex, stub-pair)
    pathMap components  : 4 longs (id, type, src, sink)

Local edges and internal vertices are consumed by Phase 1 ("persisted to
disk") and hence do not appear in the in-memory state — the same accounting
the paper uses.  The *ideal* curve holds the level-0 average constant; the
*proposed* curves apply §5's two heuristics.

Port copy of ``repro/core/memory.py``: numpy only and unchanged, so the port
imports no JAX and the same seeds give the same outputs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class PartitionState:
    """Int64-count breakdown for one active partition at one level."""

    pid: int
    level: int
    remote_copies: int      # directed remote-edge copies held in memory
    boundary: int
    open_stubs: int
    touch: int
    components: int
    deferred_remote: int = 0  # copies parked on this (inactive) leaf host

    @property
    def longs(self) -> int:
        return (
            2 * self.remote_copies
            + self.boundary
            + 3 * self.open_stubs
            + 4 * self.touch
            + 4 * self.components
        )

    @property
    def longs_with_deferred(self) -> int:
        return self.longs + 2 * self.deferred_remote


@dataclasses.dataclass
class LevelStats:
    level: int
    states: List[PartitionState]
    phase1_cost: Dict[int, int]        # pid -> |B| + |I| + |L| (paper §3.5)
    phase1_seconds: Dict[int, float]   # observed wall time per partition
    comm_longs: Dict[int, int]         # pid -> Int64s shipped at this merge

    @property
    def cumulative(self) -> int:
        return sum(s.longs for s in self.states)

    @property
    def average(self) -> float:
        return self.cumulative / max(1, len(self.states))


def ideal_curve(level0: LevelStats, parts_per_level: List[int]) -> List[float]:
    """Paper's ideal: average stays at the level-0 value."""
    avg0 = level0.average
    return [avg0 * n for n in parts_per_level]
