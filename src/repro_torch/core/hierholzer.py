"""Sequential Hierholzer oracle (paper §2.2) + circuit validation.

This is the paper-faithful *sequential* algorithm: O(|E|), single machine.
It is the correctness oracle for every parallel/distributed path in this
repo, and the "1-partition" data point in the scaling benchmarks.

Port copy of ``repro/core/hierholzer.py``: numpy only and unchanged, so the port
imports no JAX and the same seeds give the same outputs.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .graph import Graph


class InvalidCircuitError(AssertionError):
    """A claimed Euler circuit failed validation.

    Subclasses ``AssertionError`` for back-compat with callers that catch
    validation failures from the historical ``assert``-based checker, but
    is raised explicitly so validation survives ``python -O``.
    """


def hierholzer_circuit(graph: Graph, start: Optional[int] = None) -> np.ndarray:
    """Return an Euler circuit as an array of *stub* ids.

    Stub ``2e`` means edge ``e`` traversed u→v, ``2e+1`` means v→u.  The
    walk enters edge ``e`` at the *returned* stub's opposite endpoint; i.e.
    the circuit vertex sequence is ``vertex(sibling(s_0)), vertex(s_0) ...``.
    Raises ``ValueError`` if the touched component is not Eulerian.
    """
    E = graph.num_edges
    if E == 0:
        return np.zeros((0,), dtype=np.int64)
    deg = graph.degrees()
    if np.any(deg % 2 != 0):
        raise ValueError("graph is not Eulerian (odd-degree vertex present)")

    # CSR-ish incidence: for each vertex, the list of incident stubs.
    V = graph.num_vertices
    stub_vert = np.empty(2 * E, dtype=np.int64)
    stub_vert[0::2] = graph.edge_u
    stub_vert[1::2] = graph.edge_v
    order = np.argsort(stub_vert, kind="stable")
    offsets = np.zeros(V + 1, dtype=np.int64)
    np.add.at(offsets, stub_vert + 1, 1)
    offsets = np.cumsum(offsets)

    ptr = offsets[:-1].copy()          # next unexplored incidence per vertex
    used = np.zeros(E, dtype=bool)
    if start is None:
        start = int(stub_vert[order[0]])

    # Iterative Hierholzer: stack of (vertex, arrival_stub); emit the
    # arrival stub when a vertex pops (the classic splice-on-return
    # formulation); the reversed emission is the forward circuit.
    stack: List[tuple] = [(start, -1)]
    out_stubs: List[int] = []
    while stack:
        v, arr = stack[-1]
        advanced = False
        while ptr[v] < offsets[v + 1]:
            s = int(order[ptr[v]])
            ptr[v] += 1
            e = s >> 1
            if used[e]:
                continue
            used[e] = True
            w = int(stub_vert[s ^ 1])
            stack.append((w, s ^ 1))   # arrive at w via stub s^1
            advanced = True
            break
        if not advanced:
            stack.pop()
            if arr >= 0:
                out_stubs.append(arr)

    if len(out_stubs) != E:
        raise ValueError(
            f"graph is disconnected: circuit covers {len(out_stubs)}/{E} edges"
        )
    return np.array(out_stubs[::-1], dtype=np.int64)


def validate_circuit(graph: Graph, circuit_stubs: np.ndarray) -> None:
    """Check that ``circuit_stubs`` is an Euler circuit of ``graph``;
    raises :class:`InvalidCircuitError` otherwise.

    Checks: every edge exactly once; consecutive edges share the junction
    vertex; the walk is closed.
    """
    E = graph.num_edges
    if circuit_stubs.shape != (E,):
        raise InvalidCircuitError(
            f"circuit has shape {circuit_stubs.shape}, expected ({E},)")
    eids = circuit_stubs >> 1
    if len(np.unique(eids)) != E:
        raise InvalidCircuitError("an edge repeats or is missing")

    stub_vert = np.empty(2 * E, dtype=np.int64)
    stub_vert[0::2] = graph.edge_u
    stub_vert[1::2] = graph.edge_v
    arrive = stub_vert[circuit_stubs]            # vertex the walk arrives at
    depart = stub_vert[circuit_stubs ^ 1]        # vertex the walk departs from
    # consecutive link: arrival vertex of step t == departure vertex of t+1
    ok = arrive[:-1] == depart[1:]
    if not bool(np.all(ok)):
        raise InvalidCircuitError(
            f"walk breaks at steps {np.nonzero(~ok)[0][:5]}")
    if arrive[-1] != depart[0]:
        raise InvalidCircuitError("walk is not closed")
