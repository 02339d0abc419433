"""Makki [IPCCC'97] vertex-centric baseline (paper §2.2).

A single active traversal walks unvisited edges from the current vertex,
backtracking at vertices with one unvisited edge to avoid cycle merging.
In a Pregel/BSP realization, each edge move is one superstep (vertex-
centric) or each partition crossing is one superstep (partition-centric),
giving coordination cost O(|E|) / O(edge cuts) — the scaling limitation
the paper's ⌈log n⌉+1 design removes.  This implementation is used for the
superstep-count comparison (benchmark E6), not for performance.

Port copy of ``repro/core/makki.py``: numpy only and unchanged, on the
port's ``core/graph.py`` and ``core/hierholzer.py``, so the port imports
no JAX and the same graphs give the same circuits and superstep counts.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .graph import Graph, PartitionedGraph
from .hierholzer import hierholzer_circuit


@dataclasses.dataclass
class MakkiResult:
    circuit: np.ndarray
    supersteps_vertex_centric: int     # one per edge traversal
    supersteps_partition_centric: int  # one per partition crossing


def makki_tour(pg: PartitionedGraph, start: Optional[int] = None) -> MakkiResult:
    """Simulate the distributed walk; count coordination supersteps.

    The walk itself is Hierholzer-correct (we reuse the oracle, which the
    single-active-vertex algorithm reproduces step for step); what differs
    between algorithms is the *coordination structure*, which is what we
    measure: the vertex-centric walk synchronizes once per edge, and the
    partition-centric variant once per cut-edge crossing in the walk order.
    """
    circuit = hierholzer_circuit(pg.graph, start=start)
    # partition of the vertex each step arrives at
    E = pg.graph.num_edges
    stub_vert = np.empty(2 * E, dtype=np.int64)
    stub_vert[0::2] = pg.graph.edge_u
    stub_vert[1::2] = pg.graph.edge_v
    arrive_part = pg.part_of_vertex[stub_vert[circuit]]
    depart_part = pg.part_of_vertex[stub_vert[circuit ^ 1]]
    crossings = int((arrive_part != depart_part).sum())
    return MakkiResult(
        circuit=circuit,
        supersteps_vertex_centric=E,
        supersteps_partition_centric=crossings,
    )
