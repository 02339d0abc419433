"""Phase 2: merge-tree construction (paper Alg. 2).

Greedy max-weight *maximal matching* over the meta-graph, one matching per
level, parent = larger partition id (paper §3.3.2), repeated until a single
partition remains.  Runs host-side on the meta-graph only — O(n²) state,
exactly as the paper builds it "statically on 1 machine".

Port copy of ``repro/core/phase2.py``: numpy only and unchanged, so the port
imports no JAX and the same seeds give the same outputs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np

from .graph import MetaGraph


@dataclasses.dataclass
class MergeLevel:
    """One level of the merge tree: (child, parent) pairs + passthroughs."""

    level: int
    pairs: List[Tuple[int, int]]       # (child pid, parent pid) merged this level
    passthrough: List[int]             # partitions not matched this level
    active_after: List[int]            # partition ids alive after this level


@dataclasses.dataclass
class MergeTree:
    levels: List[MergeLevel]
    root: int

    @property
    def height(self) -> int:
        return len(self.levels)

    def supersteps(self) -> int:
        """Coordination cost (§3.5): one Phase-1 superstep per level plus the
        initial level-0 Phase 1 = height + 1 ... the paper counts
        ⌈log n⌉ + 1 total (level-0 phase 1 included)."""
        return self.height + 1


def maximal_matching(weights: np.ndarray, alive: List[int]) -> List[Tuple[int, int]]:
    """Greedy max-weight maximal matching (paper's MAXIMALMATCHING):
    sort meta-edges by descending ω, greedily select disjoint pairs."""
    edges = []
    for ii, i in enumerate(alive):
        for j in alive[ii + 1 :]:
            w = int(weights[i, j])
            if w > 0:
                edges.append((w, i, j))
    edges.sort(key=lambda t: (-t[0], t[1], t[2]))
    used = set()
    out = []
    for w, i, j in edges:
        if i in used or j in used:
            continue
        used.add(i)
        used.add(j)
        out.append((i, j))
    # If the meta-graph is disconnected (no edges between survivors), pair
    # arbitrary leftovers so the tree still reaches a single root.
    left = [p for p in alive if p not in used]
    while len(left) >= 2 and len(out) == 0:
        i, j = left.pop(), left.pop()
        out.append((min(i, j), max(i, j)))
    return out


def generate_merge_tree(meta: MetaGraph) -> MergeTree:
    """Alg. 2: build the full merge tree from the level-0 meta-graph."""
    weights = meta.weights.astype(np.int64).copy()
    alive = list(range(meta.num_parts))
    levels: List[MergeLevel] = []
    lvl = 0
    while len(alive) > 1:
        pairs_ij = maximal_matching(weights, alive)
        pairs: List[Tuple[int, int]] = []
        merged_away = set()
        for i, j in pairs_ij:
            child, parent = (i, j) if j > i else (j, i)   # parent = larger pid
            pairs.append((child, parent))
            merged_away.add(child)
        passthrough = [p for p in alive if p not in merged_away and
                       p not in [q for _, q in pairs]]
        alive = sorted(set(alive) - merged_away)
        # REBUILDMETAGRAPH: fold child rows/cols into the parent.
        for child, parent in pairs:
            weights[parent, :] += weights[child, :]
            weights[:, parent] += weights[:, child]
            weights[child, :] = 0
            weights[:, child] = 0
            weights[parent, parent] = 0
        levels.append(
            MergeLevel(level=lvl, pairs=pairs, passthrough=passthrough,
                       active_after=list(alive))
        )
        lvl += 1
        if lvl > 4 * math.ceil(math.log2(max(2, meta.num_parts))) + 4:
            raise RuntimeError("merge tree failed to converge")
    return MergeTree(levels=levels, root=alive[0] if alive else 0)


def ancestor_at_level(tree: MergeTree, pid: int, level: int) -> int:
    """The partition that hosts ``pid``'s state *after* ``level`` merges."""
    cur = pid
    for lv in tree.levels[: level + 1]:
        for child, parent in lv.pairs:
            if cur == child:
                cur = parent
                break
    return cur


def merge_level_of(tree: MergeTree, a: int, b: int) -> int:
    """First level after which partitions a and b share an ancestor."""
    for lv in range(tree.height):
        if ancestor_at_level(tree, a, lv) == ancestor_at_level(tree, b, lv):
            return lv
    return tree.height - 1
