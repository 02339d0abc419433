"""Partitioned-graph data structures for the partition-centric Euler engine.

Mirrors §3.1 of the paper: a graph ``G`` partitioned into ``n`` parts
``P_i = <I_i, B_i, L_i, R_i>`` (internal/boundary vertices, local/remote
edges), plus the meta-graph ``Ḡ`` whose meta-edge weights ``ω(m_ij)`` count
cut edges between partition pairs.

Edges are undirected and identified by a single global edge id; each edge
contributes two *stubs* (edge-endpoint incidences), ``2*eid`` at ``u`` and
``2*eid + 1`` at ``v``.  The paper's doubled directed-edge representation is
modelled in the *memory accounting* (``core.memory``), not in the storage —
see DESIGN.md §2 for the mapping.

Port copy of ``repro/core/graph.py``: numpy only and unchanged, so the port
imports no JAX and the same seeds give the same outputs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

INVALID = np.int64(-1)


@dataclasses.dataclass
class Graph:
    """A host-side undirected multigraph with global vertex/edge ids."""

    num_vertices: int
    edge_u: np.ndarray  # [E] int64
    edge_v: np.ndarray  # [E] int64

    @property
    def num_edges(self) -> int:
        return int(self.edge_u.shape[0])

    def degrees(self) -> np.ndarray:
        deg = np.zeros(self.num_vertices, dtype=np.int64)
        np.add.at(deg, self.edge_u, 1)
        np.add.at(deg, self.edge_v, 1)
        return deg

    def is_eulerian(self) -> bool:
        return bool(np.all(self.degrees() % 2 == 0))

    def validate(self) -> None:
        if self.edge_u.shape != self.edge_v.shape:
            raise ValueError(
                f"edge endpoint arrays disagree: {self.edge_u.shape} vs "
                f"{self.edge_v.shape}")
        if self.edge_u.min(initial=0) < 0:
            raise ValueError("negative vertex id in edge_u")
        if max(self.edge_u.max(initial=0),
               self.edge_v.max(initial=0)) >= self.num_vertices:
            raise ValueError(
                f"edge endpoint exceeds num_vertices={self.num_vertices}")


@dataclasses.dataclass
class Partition:
    """One partition ``P_i`` = <I, B, L, R> (paper §3.1), host-side."""

    pid: int
    internal: np.ndarray        # [|I|] vertex ids
    boundary: np.ndarray        # [|B|] vertex ids
    local_eids: np.ndarray      # [|L|] global edge ids (both endpoints in partition)
    remote_eids: np.ndarray     # [|R|] global edge ids (exactly one endpoint here)
    odd_boundary: np.ndarray    # [|OB|] boundary vertices with odd local degree
    even_boundary: np.ndarray   # [|EB|] boundary vertices with even local degree

    @property
    def num_vertices(self) -> int:
        return len(self.internal) + len(self.boundary)


@dataclasses.dataclass
class MetaGraph:
    """Meta-graph Ḡ: partitions as meta-vertices, ω = cut-edge counts."""

    num_parts: int
    weights: np.ndarray  # [n, n] int64, symmetric, zero diagonal

    def edges(self) -> List[Tuple[int, int, int]]:
        out = []
        for i in range(self.num_parts):
            for j in range(i + 1, self.num_parts):
                if self.weights[i, j] > 0:
                    out.append((i, j, int(self.weights[i, j])))
        return out


@dataclasses.dataclass
class PartitionedGraph:
    """The fully-annotated partitioned graph (host-side master copy)."""

    graph: Graph
    part_of_vertex: np.ndarray   # [V] partition id per vertex
    parts: List[Partition]
    meta: MetaGraph
    edge_part_u: np.ndarray      # [E] partition of edge_u endpoint
    edge_part_v: np.ndarray      # [E] partition of edge_v endpoint

    @property
    def num_parts(self) -> int:
        return len(self.parts)

    def cut_fraction(self) -> float:
        cut = int((self.edge_part_u != self.edge_part_v).sum())
        return cut / max(1, self.graph.num_edges)

    def vertex_imbalance(self) -> float:
        """Peak vertex imbalance, Table 1:  max_i |(|V| - n*|V_i|)| / |V|."""
        v = self.graph.num_vertices
        n = self.num_parts
        sizes = np.array([p.num_vertices for p in self.parts], dtype=np.float64)
        return float(np.max(np.abs(v - n * sizes)) / v)


def partition_graph(graph: Graph, part_of_vertex: np.ndarray) -> PartitionedGraph:
    """Annotate a graph with the partition structure of §3.1."""
    graph.validate()
    n = int(part_of_vertex.max()) + 1 if part_of_vertex.size else 1
    pu = part_of_vertex[graph.edge_u]
    pv = part_of_vertex[graph.edge_v]
    is_cut = pu != pv

    # Local degree per vertex (only local edges count toward δ_L).
    local_deg = np.zeros(graph.num_vertices, dtype=np.int64)
    np.add.at(local_deg, graph.edge_u[~is_cut], 1)
    np.add.at(local_deg, graph.edge_v[~is_cut], 1)
    remote_deg = np.zeros(graph.num_vertices, dtype=np.int64)
    np.add.at(remote_deg, graph.edge_u[is_cut], 1)
    np.add.at(remote_deg, graph.edge_v[is_cut], 1)

    eids = np.arange(graph.num_edges, dtype=np.int64)
    parts: List[Partition] = []
    weights = np.zeros((n, n), dtype=np.int64)
    if is_cut.any():
        np.add.at(weights, (pu[is_cut], pv[is_cut]), 1)
        np.add.at(weights, (pv[is_cut], pu[is_cut]), 1)

    all_vertices = np.arange(graph.num_vertices, dtype=np.int64)
    for pid in range(n):
        mine = part_of_vertex == pid
        vids = all_vertices[mine]
        is_boundary = remote_deg[vids] > 0
        boundary = vids[is_boundary]
        internal = vids[~is_boundary]
        local_mask = (~is_cut) & (pu == pid)
        remote_mask = is_cut & ((pu == pid) | (pv == pid))
        odd = boundary[local_deg[boundary] % 2 == 1]
        even = boundary[local_deg[boundary] % 2 == 0]
        parts.append(
            Partition(
                pid=pid,
                internal=internal,
                boundary=boundary,
                local_eids=eids[local_mask],
                remote_eids=eids[remote_mask],
                odd_boundary=odd,
                even_boundary=even,
            )
        )

    return PartitionedGraph(
        graph=graph,
        part_of_vertex=part_of_vertex.astype(np.int64),
        parts=parts,
        meta=MetaGraph(num_parts=n, weights=weights),
        edge_part_u=pu.astype(np.int64),
        edge_part_v=pv.astype(np.int64),
    )


# ---------------------------------------------------------------------------
# Stub helpers (shared by host and JAX engines)
# ---------------------------------------------------------------------------

def stub_ids(eids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(stub at u, stub at v) for a vector of edge ids."""
    return 2 * eids, 2 * eids + 1


def sibling(stubs: np.ndarray) -> np.ndarray:
    """The other stub of the same edge (works for np and jnp arrays)."""
    return stubs ^ 1


def stub_vertex(stubs: np.ndarray, edge_u: np.ndarray, edge_v: np.ndarray) -> np.ndarray:
    """Vertex a stub is incident on."""
    eid = stubs >> 1
    return np.where(stubs & 1 == 0, edge_u[eid], edge_v[eid])
