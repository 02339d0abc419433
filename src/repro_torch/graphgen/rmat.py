"""R-MAT powerlaw graph generator (paper §4.2 uses parallel RMAT [35]).

Recursive-quadrant sampling with the standard (a,b,c,d) probabilities;
vectorized over all edges at once (one bit-level per recursion depth).
Self-loops and duplicate undirected edges are removed, matching the paper's
use of RMAT output as a simple undirected graph.

Port copy of ``repro/graphgen/rmat.py``: numpy only and unchanged, so the port
imports no JAX and the same seeds give the same outputs.
"""
from __future__ import annotations

import numpy as np

from ..core.graph import Graph


def rmat_graph(
    scale: int,
    avg_degree: int = 5,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
) -> Graph:
    """Generate an undirected R-MAT graph with 2**scale vertices.

    ``avg_degree`` is the average *undirected* degree (paper uses 5).
    """
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * avg_degree // 2
    # Oversample to survive dedup/self-loop removal.
    m_try = int(m * 1.35) + 16

    u = np.zeros(m_try, dtype=np.int64)
    v = np.zeros(m_try, dtype=np.int64)
    d = 1.0 - a - b - c
    p_right = b + d      # probability column-bit is 1 given row-bit 0 ... (see below)
    for _ in range(scale):
        u <<= 1
        v <<= 1
        r1 = rng.random(m_try)
        r2 = rng.random(m_try)
        # Quadrant probabilities: (0,0)=a, (0,1)=b, (1,0)=c, (1,1)=d.
        row = r1 < (c + d)                       # P(row-bit = 1) = c + d
        col_p = np.where(row, d / max(c + d, 1e-12), b / max(a + b, 1e-12))
        col = r2 < col_p
        u |= row.astype(np.int64)
        v |= col.astype(np.int64)

    # Canonicalize, drop self-loops + duplicates.
    lo = np.minimum(u, v)
    hi = np.maximum(u, v)
    keep = lo != hi
    lo, hi = lo[keep], hi[keep]
    key = lo * n + hi
    _, idx = np.unique(key, return_index=True)
    lo, hi = lo[idx], hi[idx]
    if len(lo) > m:
        sel = rng.permutation(len(lo))[:m]
        lo, hi = lo[sel], hi[sel]

    return Graph(num_vertices=n, edge_u=lo.astype(np.int64), edge_v=hi.astype(np.int64))
