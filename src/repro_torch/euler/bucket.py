"""Geometric shape buckets (mirrors ``repro/euler/bucket.py``).

A graph is padded into the smallest bucket that fits it:

  · ``E`` rounds up to the next power of two (``e_cap``) by appending a
    dummy edge cycle anchored at one real vertex — degrees stay even, the
    graph stays connected, and the dummy section of the circuit is
    contiguous, so stripping it leaves a valid Euler circuit;
  · every table capacity from ``size_caps`` is quantized onto a shared cap
    ladder keyed off ``e_cap`` (:func:`ladder_caps`);
  · the scan length rounds up to a power of two (:func:`ladder_levels`);
    the extra supersteps are no-ops.

The port keys its recorded CUDA graphs on the bucket, and pads and
sizes exactly as the reference does, so both packages run the same
tables and return the same circuits.  :func:`modal_bucket_pool` picks
the serving pool of one bucket.  The autotuner re-keys a bucket scale
whose members all fit it onto the tight profile (:data:`TIGHT_DIVISORS`,
``ladder_floors``/``ladder_caps`` with ``tight=True``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

from ..core.engine import EngineCaps
from ..core.graph import Graph


def ceil_pow2(x: int, lo: int = 1) -> int:
    """Smallest power of two ≥ max(x, lo).

    >>> [ceil_pow2(x) for x in (1, 3, 8, 9)]
    [1, 4, 8, 16]
    >>> ceil_pow2(3, lo=64)
    64
    """
    v = max(int(x), int(lo), 1)
    return 1 << (v - 1).bit_length()


def round_caps(caps: EngineCaps, lo: int = 16) -> EngineCaps:
    """Round every table capacity up to a power of two.  Round budgets and
    flags are kept verbatim; zero lane overrides stay zero."""

    def r(v: int) -> int:
        return ceil_pow2(v, lo) if v else 0

    return dataclasses.replace(
        caps,
        edge_cap=r(caps.edge_cap),
        park_cap=r(caps.park_cap),
        ship_cap=r(caps.ship_cap),
        new_cap=r(caps.new_cap),
        open_cap=r(caps.open_cap),
        touch_cap=r(caps.touch_cap),
        open_ship_cap=r(caps.open_ship_cap),
        touch_ship_cap=r(caps.touch_ship_cap),
        mate_ship_cap=r(caps.mate_ship_cap),
        p3v_cap=r(caps.p3v_cap),
    )


#: Ladder floor rungs as divisors of the bucket scale ``e_cap`` (the
#: reference's calibration: park/ship/open at ``e_cap/4``, touch and the
#: sharded Phase 3 vertex table at their ``e_cap`` worst case).
LADDER_DIVISORS = {
    "park_cap": 4,
    "ship_cap": 4,
    "open_cap": 4,
    "open_ship_cap": 4,
    "touch_cap": 1,
    "touch_ship_cap": 1,
    "p3v_cap": 1,
}

#: Tight-profile divisors, the autotuner's feedback rung: a bucket scale
#: whose measured per-field needs sit under half the default floors is
#: re-keyed onto these halved floors.  Correctness never depends on the
#: profile: a field above its floor still rounds up to a power of two.
TIGHT_DIVISORS = {
    "park_cap": 8,
    "ship_cap": 8,
    "open_cap": 8,
    "open_ship_cap": 8,
    "touch_cap": 2,
    "touch_ship_cap": 2,
    "p3v_cap": 2,
}

#: Cap fields the ladder sizes (and the autotuner observes a solve).
LADDER_FIELDS = ("edge_cap", "park_cap", "ship_cap", "new_cap", "open_cap",
                 "touch_cap", "open_ship_cap", "touch_ship_cap", "p3v_cap")


def _edge_floor(e_cap: int, n_parts: int, slack: float) -> int:
    """Worst-case padded local-edge table width over a bucket, rounded up
    to an ``e_cap/8`` rung (the dummy pad cycle lands entirely in the
    anchor's partition)."""
    rung = max(1, e_cap // 8)
    need = math.ceil((e_cap / (2 * n_parts) + e_cap / 2) * slack)
    return min(e_cap, rung * math.ceil(need / rung))


def ladder_floors(e_cap: int, n_parts: int, slack: float = 1.3,
                  lo: int = 16, tight: bool = False) -> dict:
    """Per-field cap floors for one bucket scale, under the default
    profile (:data:`LADDER_DIVISORS`) or the ``tight`` one
    (:data:`TIGHT_DIVISORS`); edge/new share the worst-case
    padded-partition rung under both.

    >>> f = ladder_floors(128, 8)
    >>> f["park_cap"], f["touch_cap"]
    (32, 128)
    >>> t = ladder_floors(128, 8, tight=True)
    >>> t["park_cap"], t["touch_cap"]
    (16, 64)
    """
    div = TIGHT_DIVISORS if tight else LADDER_DIVISORS
    ef = max(_edge_floor(e_cap, n_parts, slack), lo)
    floors = {"edge_cap": ef, "new_cap": ef}
    for f, d in div.items():
        floors[f] = max(e_cap // d, lo)
    return floors


def ladder_caps(caps: EngineCaps, e_cap: int, n_parts: int,
                slack: float = 1.3, lo: int = 16,
                tight: bool = False) -> EngineCaps:
    """Quantize every table capacity onto the bucket's shared cap ladder
    (the ``tight`` profile's floors if asked): a field at or under its
    floor takes the floor, an outlier above it rounds up to a power of
    two."""
    floors = ladder_floors(e_cap, n_parts, slack=slack, lo=lo, tight=tight)

    def q(v: int, floor: int) -> int:
        if not v:
            return 0
        return floor if v <= floor else ceil_pow2(v, lo)

    return dataclasses.replace(
        caps, **{f: q(getattr(caps, f), fl) for f, fl in floors.items()})


def ladder_rounds(caps: EngineCaps, e_cap: int) -> EngineCaps:
    """Round budgets of the two convergence loops from the bucket: the
    Phase 1 splice from the stub pool, the Phase 3 splice from the stub
    space ``2·e_cap``.

    >>> c = EngineCaps(edge_cap=96, park_cap=32, ship_cap=32, new_cap=96,
    ...                open_cap=32, touch_cap=64)
    >>> r = ladder_rounds(c, 128)
    >>> r.splice_rounds, r.phase3_rounds
    (11, 24)
    """
    pool = 2 * caps.new_cap + caps.open_cap + caps.touch_cap
    splice = min(16, max(10, math.ceil(math.log2(max(2, pool))) + 2))
    p3 = min(64, max(24, 2 * math.ceil(math.log2(max(2, 2 * e_cap))) + 8))
    return dataclasses.replace(caps, splice_rounds=splice, phase3_rounds=p3)


def ladder_levels(n_levels: int) -> int:
    """Quantize the scan length onto the pow2 ladder; supersteps past the
    real merge-tree height are no-ops.

    >>> [ladder_levels(x) for x in (1, 4, 5, 7, 9)]
    [1, 4, 8, 8, 16]
    """
    return ceil_pow2(n_levels)


def ladder_waste(exact: EngineCaps, quantized: EngineCaps) -> float:
    """Padded-compute waste of the quantized caps: quantized / exact
    per-partition table area over the sizing fields (1.0 = none)."""
    fields = ("edge_cap", "park_cap", "ship_cap", "new_cap", "open_cap",
              "touch_cap", "open_ship_cap", "touch_ship_cap", "p3v_cap")
    num = sum(getattr(quantized, f) for f in fields)
    den = max(1, sum(getattr(exact, f) for f in fields))
    return num / den


def pad_graph(graph: Graph, part_of_vertex: np.ndarray,
              e_cap: int) -> Tuple[Graph, np.ndarray]:
    """Pad ``graph`` to exactly ``e_cap`` edges with a dummy cycle through
    ``k-1`` fresh vertices anchored at one real vertex (a self-loop when
    k == 1), all in the anchor's partition — no cut edges are added and
    the merge tree is untouched.  Returns the padded graph and the padded
    partition assignment.

    >>> tri = Graph(3, np.array([0, 1, 2]), np.array([1, 2, 0]))
    >>> g2, part2 = pad_graph(tri, np.zeros(3, dtype=np.int64), 8)
    >>> g2.num_edges, g2.is_eulerian(), len(part2)
    (8, True, 7)
    """
    E = graph.num_edges
    k = int(e_cap) - E
    if k < 0:
        raise ValueError(f"e_cap {e_cap} smaller than the graph's {E} edges")
    if k == 0:
        return graph, part_of_vertex
    if E == 0:
        raise ValueError("cannot pad an empty graph")
    anchor = int(graph.edge_u[0])
    V = graph.num_vertices
    if k == 1:
        eu = np.array([anchor], dtype=np.int64)
        ev = np.array([anchor], dtype=np.int64)
        n_new = 0
    else:
        dummies = V + np.arange(k - 1, dtype=np.int64)
        walk = np.concatenate([[anchor], dummies, [anchor]])
        eu, ev = walk[:-1], walk[1:]
        n_new = k - 1
    g2 = Graph(
        num_vertices=V + n_new,
        edge_u=np.concatenate([graph.edge_u, eu]).astype(np.int64),
        edge_v=np.concatenate([graph.edge_v, ev]).astype(np.int64),
    )
    part2 = np.concatenate([
        np.asarray(part_of_vertex, dtype=np.int64),
        np.full(n_new, int(part_of_vertex[anchor]), dtype=np.int64),
    ])
    return g2, part2


def modal_bucket_pool(solver, graphs, n: int) -> list:
    """The ≤ ``n`` graphs sharing the most common shape bucket.

    Batched solving (DESIGN.md §8) needs same-bucket graphs; this groups
    candidates by ``solver.bucket_of`` — skipping graphs too small or
    sparse for the solver's partition count — and returns the modal
    bucket's members in input order (may hold fewer than ``n``; empty if
    no candidate partitions cleanly).  Used by the serving loop's
    ``--same-bucket`` pool.
    """
    buckets: dict = {}
    for g in graphs:
        try:
            buckets.setdefault(solver.bucket_of(g), []).append(g)
        except ValueError:
            continue  # partitioner can't fill n_parts for this graph
    if not buckets:
        return []
    return max(buckets.values(), key=len)[:n]


def strip_circuit(circuit: np.ndarray, num_edges: int) -> np.ndarray:
    """Drop the dummy-edge arrivals from a padded-graph circuit (one
    contiguous closed sub-walk through the anchor).

    >>> strip_circuit(np.array([0, 2, 4, 7, 9, 5]), 3)  # edges ≥ 3 dummy
    array([0, 2, 4, 5])
    """
    c = np.asarray(circuit, dtype=np.int64)
    return c[(c >> 1) < num_edges]
