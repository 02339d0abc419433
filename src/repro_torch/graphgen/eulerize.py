"""Eulerization tool (paper §4.2): add edges so every vertex has even degree.

The paper built "a custom tool to add additional edges between vertices that
have an odd degree ... the edge degree distribution of the modified graph
closely matches the original" and reports ~5% extra edges.  We do the same:
pair odd-degree vertices (preferring pairs that are not already adjacent to
avoid multi-edges) and add one edge per pair.  Handshake lemma guarantees an
even number of odd vertices, so a perfect pairing always exists.

Optionally restrict to (or extract) the largest connected component first —
the paper's circuits span one connected component.

Port copy of ``repro/graphgen/eulerize.py``: numpy only and unchanged, so the port
imports no JAX and the same seeds give the same outputs.
"""
from __future__ import annotations

import numpy as np

from ..core.graph import Graph


def largest_component(graph: Graph) -> Graph:
    """Return the subgraph induced on the largest connected component,
    with vertices relabelled densely."""
    V, E = graph.num_vertices, graph.num_edges
    label = np.arange(V, dtype=np.int64)
    # Iterated min-label propagation with early exit (hooking-style).
    for _ in range(64):
        lu = label[graph.edge_u]
        lv = label[graph.edge_v]
        m = np.minimum(lu, lv)
        new = label.copy()
        np.minimum.at(new, graph.edge_u, m)
        np.minimum.at(new, graph.edge_v, m)
        # pointer-jump compress
        new = new[new]
        if np.array_equal(new, label):
            break
        label = new
    roots, counts = np.unique(label, return_counts=True)
    big = roots[np.argmax(counts)]
    keep_v = label == big
    remap = -np.ones(V, dtype=np.int64)
    remap[keep_v] = np.arange(keep_v.sum(), dtype=np.int64)
    keep_e = keep_v[graph.edge_u] & keep_v[graph.edge_v]
    return Graph(
        num_vertices=int(keep_v.sum()),
        edge_u=remap[graph.edge_u[keep_e]],
        edge_v=remap[graph.edge_v[keep_e]],
    )


def eulerize(graph: Graph, seed: int = 0) -> Graph:
    """Add a matching over odd-degree vertices so all degrees become even."""
    rng = np.random.default_rng(seed)
    deg = graph.degrees()
    odd = np.nonzero(deg % 2 == 1)[0]
    assert len(odd) % 2 == 0, "handshake lemma violated?!"
    if len(odd) == 0:
        return graph

    # Existing adjacency set for duplicate avoidance.
    n = graph.num_vertices
    existing = set(
        (int(a), int(b))
        for a, b in zip(
            np.minimum(graph.edge_u, graph.edge_v),
            np.maximum(graph.edge_u, graph.edge_v),
        )
    )

    odd = rng.permutation(odd)
    new_u, new_v = [], []
    stack = list(odd)
    spare = []
    while stack:
        x = stack.pop()
        matched = False
        for _ in range(min(len(stack), 8)):  # few attempts to avoid duplicates
            y = stack.pop()
            key = (min(int(x), int(y)), max(int(x), int(y)))
            if key not in existing and x != y:
                existing.add(key)
                new_u.append(key[0])
                new_v.append(key[1])
                matched = True
                break
            spare.append(y)
        stack.extend(spare)
        spare.clear()
        if not matched and stack:
            # Forced multi-edge fallback: connect to any remaining odd vertex.
            y = stack.pop()
            new_u.append(min(int(x), int(y)))
            new_v.append(max(int(x), int(y)))
        elif not matched:
            raise AssertionError("odd vertex left unpaired")

    eu = np.concatenate([graph.edge_u, np.array(new_u, dtype=np.int64)])
    ev = np.concatenate([graph.edge_v, np.array(new_v, dtype=np.int64)])
    out = Graph(num_vertices=n, edge_u=eu, edge_v=ev)
    assert out.is_eulerian()
    return out


def eulerian_rmat(scale: int, avg_degree: int = 5, seed: int = 0) -> Graph:
    """The paper's full pipeline: RMAT → largest component → eulerize."""
    from .rmat import rmat_graph

    g = rmat_graph(scale, avg_degree=avg_degree, seed=seed)
    g = largest_component(g)
    return eulerize(g, seed=seed + 1)
