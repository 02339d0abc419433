"""Exact host-side BSP execution of the partition-centric algorithm
(mirrors ``repro/core/host_engine.py``).

This is the *reference* engine: it executes the paper's three phases over a
``PartitionedGraph`` with explicit per-level pathMap transfers, the paper's
Int64 memory-state accounting (Fig. 8/9), the §3.5 cost model, and the two
§5 heuristics behind flags:

  ``remote_dedup``       — only one side of a cut edge holds it in memory
  ``deferred_transfer``  — a child parks remote edges for higher ancestors
                           on its own (idle) host until the level they
                           localize

The intra-partition algorithm is the vectorized stub-pairing + splice
described in DESIGN.md §2 — semantically equivalent to the paper's
sequential Hierholzer Phase 1 (same paths-between-OBs / cycles-at-EBs
output, Lemmas 1–3), and validated against the ``hierholzer`` oracle in
tests.

Level indexing: Phase 1 runs at level 0 on the input partitions; the merge
recorded in ``tree.levels[k]`` happens before Phase 1 at level ``k+1``.  A
cut edge whose two sides first share an ancestor after ``tree.levels[k]``
has activation level ``k`` and localizes into that ancestor's level-``k+1``
Phase 1.

The port keeps it a numpy + scipy host engine: the same ``mate`` bytes,
circuit, merge tree and ``LevelStats`` as the reference on the same
partitioned graph.  Only the per-cut-edge Python loops of the accounting
(``_remote_copies``, ``_merge``) are vectorized, over a table of each
partition's ancestor after every level, and ``_splice`` slices its
contiguous vertex segments instead of searching for them; every count and
every mate rotation is the reference's, in its order.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, List, Tuple

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

from .graph import PartitionedGraph
from .memory import LevelStats, PartitionState
from .phase2 import ancestor_at_level, generate_merge_tree, merge_level_of
from .phase3 import circuit_from_mate_np, splice_components_np


def __getattr__(name):
    # Deprecation shim: ``EulerResult`` lives in ``repro_torch.euler.result``
    # (one result type for both backends).  Lazy to avoid an import cycle
    # through the facade package.
    if name == "EulerResult":
        from ..euler.result import EulerResult

        return EulerResult
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


@dataclasses.dataclass
class PartState:
    """In-memory pathMap state of one active partition (host mirror)."""

    pid: int
    vertices: np.ndarray            # owned vertex ids
    open_stubs: np.ndarray          # unpaired path-endpoint stubs
    touch_stubs: np.ndarray         # representative paired stubs at boundary
    n_components: int = 0


class HostEngine:
    def __init__(
        self,
        pg: PartitionedGraph,
        remote_dedup: bool = False,
        deferred_transfer: bool = False,
    ):
        self.pg = pg
        self.remote_dedup = remote_dedup
        self.deferred_transfer = deferred_transfer
        g = pg.graph
        self.E = g.num_edges
        self.n_stubs = 2 * self.E
        self.mate = np.full(self.n_stubs, -1, dtype=np.int64)
        self.stub_vertex = np.empty(self.n_stubs, dtype=np.int64)
        self.stub_vertex[0::2] = g.edge_u
        self.stub_vertex[1::2] = g.edge_v
        self.tree = generate_merge_tree(pg.meta)
        self.level_stats: List[LevelStats] = []

        # Localization schedule for every cut edge, derived once from the
        # merge tree (the paper derives the same from the tree at load time
        # for §5's heuristics).
        is_cut = pg.edge_part_u != pg.edge_part_v
        self.cut_eids = np.nonzero(is_cut)[0]
        self.act_level = np.full(self.E, -1, dtype=np.int64)
        self.act_dest = np.full(self.E, -1, dtype=np.int64)
        pair_cache: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for e in self.cut_eids:
            a = int(pg.edge_part_u[e])
            b = int(pg.edge_part_v[e])
            key = (min(a, b), max(a, b))
            if key not in pair_cache:
                lvl = merge_level_of(self.tree, a, b)
                pair_cache[key] = (lvl, ancestor_at_level(self.tree, a, lvl))
            self.act_level[e], self.act_dest[e] = pair_cache[key]

        # anc_tab[l + 1][p] == _anc(p, l) for l in -1 .. height, and, per
        # cut edge, whether its u side keeps it under remote_dedup (the
        # lighter level-0 partition; ties to the smaller pid)
        pids = np.arange(pg.num_parts, dtype=np.int64)
        self.anc_tab = np.stack(
            [pids] + [np.array([self._anc(int(p), lvl) for p in pids],
                               dtype=np.int64)
                      for lvl in range(self.tree.height + 1)])
        loads = np.array([len(p.remote_eids) for p in pg.parts])
        a, b = pg.edge_part_u, pg.edge_part_v
        self.keep_u = (loads[a] < loads[b]) | ((loads[a] == loads[b])
                                              & (a <= b))

    # ------------------------------------------------------------------
    def _run(self):
        """Execute the full host BSP run; returns the unified
        :class:`repro_torch.euler.result.EulerResult` (internal — call
        sites go through :class:`repro_torch.euler.EulerSolver`)."""
        from ..euler.result import EulerResult

        t0 = time.perf_counter()   # lint: ok — oracle path reports its
        #                            wall time via EulerResult.timings
        states = self._init_states()
        new_local = {p.pid: p.local_eids for p in self.pg.parts}
        self._run_level(states, level=0, new_local=new_local, comm={})
        for lv in self.tree.levels:
            new_local, comm = self._merge(states, lv)
            self._run_level(states, level=lv.level + 1, new_local=new_local,
                            comm=comm)
        # Phase 3: final pivot splice from disk bookkeeping, then list-rank.
        valid = self.mate >= 0
        n_unmated = int((~valid).sum())
        if n_unmated:
            raise RuntimeError(f"{n_unmated} stubs left unmated at root")
        self.mate = splice_components_np(self.mate, self.stub_vertex, valid)
        circuit = circuit_from_mate_np(self.mate)
        return EulerResult(
            circuit=circuit,
            mate=self.mate,
            tree=self.tree,
            levels=self.level_stats,
            supersteps=self.tree.supersteps(),
            backend="host",
            fused=False,
            device="cpu",
            graph=self.pg.graph,
            timings={"run_s": time.perf_counter() - t0},  # lint: ok
        )

    def run(self, validate: bool = True):
        """Deprecated: use ``repro_torch.euler.solve(graph,
        backend="host")``.

        Thin back-compat shim; the returned object is the unified
        :class:`EulerResult` (a superset of the old fields)."""
        warnings.warn(
            'HostEngine.run is deprecated; use repro_torch.euler.solve('
            'graph, backend="host") / EulerSolver',
            DeprecationWarning, stacklevel=2,
        )
        res = self._run()
        if validate:
            res.validate()
        return res

    # ------------------------------------------------------------------
    def _init_states(self) -> Dict[int, PartState]:
        return {
            part.pid: PartState(
                pid=part.pid,
                vertices=np.concatenate([part.internal, part.boundary]),
                open_stubs=np.zeros(0, dtype=np.int64),
                touch_stubs=np.zeros(0, dtype=np.int64),
            )
            for part in self.pg.parts
        }

    # ------------------------------------------------------------------
    # Accounting helpers
    # ------------------------------------------------------------------
    def _live(self, level: int) -> np.ndarray:
        """Cut edges not yet localized before ``level``'s Phase 1."""
        return self.cut_eids[self.act_level[self.cut_eids] >= level]

    def _sides(self, eids: np.ndarray, level: int, pid: int):
        """Whether ``pid`` hosts the u side, and the v side, of each edge
        after ``level`` merges (``_anc`` of both ends)."""
        anc = self.anc_tab[level + 1]
        return (anc[self.pg.edge_part_u[eids]] == pid,
                anc[self.pg.edge_part_v[eids]] == pid)

    def _remote_copies(self, pid: int, level: int, states) -> Tuple[int, int]:
        """(in-memory directed copies at active partition, deferred copies
        parked by leaf hosts that merged into this partition)."""
        live = self._live(level)
        mine_u, mine_v = self._sides(live, level - 1, pid)
        if self.remote_dedup:
            # one copy per cut edge, charged to the side that keeps it
            # (lighter level-0 partition; ties to smaller pid)
            keep_u = self.keep_u[live]
            copies = int((mine_u & keep_u).sum() + (mine_v & ~keep_u).sum())
        else:
            copies = int(mine_u.sum() + mine_v.sum())
        deferred = 0
        if self.deferred_transfer:
            # §5b: edges not localizing at the *next* level stay parked on
            # their original leaf host, not in the active partition state.
            far = self.act_level[live] > level
            deferred = int(((mine_u | mine_v) & far).sum())
            near_mask = ~far
            if self.remote_dedup:
                copies = int(
                    ((mine_u & keep_u) | (mine_v & ~keep_u))[near_mask].sum()
                )
            else:
                copies = int((mine_u & near_mask).sum() +
                             (mine_v & near_mask).sum())
        return copies, deferred

    def _anc(self, pid: int, level: int) -> int:
        if level < 0:
            return pid
        return ancestor_at_level(self.tree, pid, level)

    def _boundary_internal(self, st: PartState, level: int) -> Tuple[int, int]:
        live = self._live(level)
        if len(live) == 0:
            return 0, len(st.vertices)
        ends = np.concatenate(
            [self.pg.graph.edge_u[live], self.pg.graph.edge_v[live]]
        )
        mine = np.zeros(self.pg.graph.num_vertices, dtype=bool)
        mine[st.vertices] = True
        boundary = np.unique(ends[mine[ends]])
        return len(boundary), len(st.vertices) - len(boundary)

    # ------------------------------------------------------------------
    def _run_level(self, states, level, new_local, comm) -> None:
        stats = LevelStats(level=level, states=[], phase1_cost={},
                           phase1_seconds={}, comm_longs=comm or {})
        for pid, st in sorted(states.items()):
            eids = new_local.get(pid, np.zeros(0, dtype=np.int64))
            nb, ni = self._boundary_internal(st, level)
            stats.phase1_cost[pid] = int(nb + ni + len(eids))
            t0 = time.perf_counter()   # lint: ok — per-partition Phase 1
            self._phase1(st, eids, level)  # timing lands in LevelStats
            stats.phase1_seconds[pid] = time.perf_counter() - t0  # lint: ok
            copies, deferred = self._remote_copies(pid, level, states)
            stats.states.append(
                PartitionState(
                    pid=pid,
                    level=level,
                    remote_copies=copies,
                    boundary=nb,
                    open_stubs=len(st.open_stubs),
                    touch=len(st.touch_stubs),
                    components=st.n_components,
                    deferred_remote=deferred,
                )
            )
        self.level_stats.append(stats)

    # ------------------------------------------------------------------
    # Phase 1 (vectorized; same recipe as the device engine)
    # ------------------------------------------------------------------
    def _phase1(self, st: PartState, new_eids: np.ndarray, level: int) -> None:
        new_stubs = np.concatenate([2 * new_eids, 2 * new_eids + 1])
        pool = np.concatenate([new_stubs, st.open_stubs])
        if len(pool):
            verts = self.stub_vertex[pool]
            order = np.lexsort((pool, verts))
            sp = pool[order]
            vp = verts[order]
            idx = np.arange(len(sp))
            blk = np.where(np.r_[True, vp[1:] != vp[:-1]], idx, 0)
            blk = np.maximum.accumulate(blk)
            pos = idx - blk
            first = (pos % 2 == 0)
            partner_ok = np.zeros(len(sp), dtype=bool)
            partner_ok[:-1] = first[:-1] & (vp[1:] == vp[:-1])
            a = sp[partner_ok]
            b = sp[np.r_[False, partner_ok[:-1]]]
            self.mate[a] = b
            self.mate[b] = a
            paired = np.zeros(len(sp), dtype=bool)
            paired[partner_ok] = True
            paired[np.r_[False, partner_ok[:-1]]] = True
            st.open_stubs = sp[~paired]
        self._splice(st)
        self._refresh_touch(st, level)
        st.n_components = self._count_components(st)

    def _labels(self) -> np.ndarray:
        idx = np.nonzero(self.mate >= 0)[0]
        rows = np.concatenate([idx, idx])
        cols = np.concatenate([idx ^ 1, self.mate[idx]])
        un = np.nonzero(self.mate < 0)[0]
        rows = np.concatenate([rows, un])
        cols = np.concatenate([cols, un ^ 1])
        g = coo_matrix((np.ones(len(rows), np.int8), (rows, cols)),
                       shape=(self.n_stubs, self.n_stubs))
        _, labels = connected_components(g, directed=False)
        return labels

    def _splice(self, st: PartState) -> None:
        """Merge components sharing an owned vertex; cycles merge into
        anything, ≤1 path per rotation (the paper keeps OB paths apart)."""
        vert_set = np.zeros(self.pg.graph.num_vertices, dtype=bool)
        vert_set[st.vertices] = True
        for _ in range(64):
            labels = self._labels()
            idx = np.nonzero(self.mate >= 0)[0]
            s = idx[self.mate[idx] > idx]          # canonical stub per pair
            s = s[vert_set[self.stub_vertex[s]]]
            if len(s) == 0:
                return
            v = self.stub_vertex[s]
            comp = labels[s]
            open_comps = np.unique(labels[self.mate < 0])
            is_path = np.isin(comp, open_comps)
            order = np.lexsort((s, comp, v))
            s, v, comp, is_path = s[order], v[order], comp[order], is_path[order]
            keep = np.r_[True, (v[1:] != v[:-1]) | (comp[1:] != comp[:-1])]
            s, v, comp, is_path = s[keep], v[keep], comp[keep], is_path[keep]
            seg = np.cumsum(np.r_[True, v[1:] != v[:-1]]) - 1
            # seg is 0, 1, 2, … in runs: segment g0 is one slice
            sizes = np.bincount(seg)
            starts = np.cumsum(sizes) - sizes
            merged_any = False
            used: set = set()
            for g0 in np.nonzero(sizes >= 2)[0]:
                members = np.arange(starts[g0], starts[g0] + sizes[g0])
                paths = is_path[members]
                pick = ~paths
                ppos = np.nonzero(paths)[0]
                if len(ppos) and pick.sum() >= 1:
                    pick[ppos[0]] = True
                members = members[pick]
                comps = comp[members]
                if len(members) < 2 or any(int(c) in used for c in comps):
                    continue
                used.update(int(c) for c in comps)
                reps = s[members]
                mates = self.mate[reps]
                k = len(reps)
                for i in range(k):
                    a_, b_ = reps[i], mates[(i + 1) % k]
                    self.mate[a_] = b_
                    self.mate[b_] = a_
                merged_any = True
            if not merged_any:
                return

    def _refresh_touch(self, st: PartState, level: int) -> None:
        live = self._live(level)
        if len(live) == 0:
            st.touch_stubs = np.zeros(0, dtype=np.int64)
            return
        mine = np.zeros(self.pg.graph.num_vertices, dtype=bool)
        mine[st.vertices] = True
        ends = np.concatenate(
            [self.pg.graph.edge_u[live], self.pg.graph.edge_v[live]]
        )
        bset = np.zeros(self.pg.graph.num_vertices, dtype=bool)
        bset[ends[mine[ends]]] = True
        labels = self._labels()
        idx = np.nonzero(self.mate >= 0)[0]
        s = idx[self.mate[idx] > idx]
        s = s[bset[self.stub_vertex[s]]]
        if len(s) == 0:
            st.touch_stubs = np.zeros(0, dtype=np.int64)
            return
        v = self.stub_vertex[s]
        comp = labels[s]
        order = np.lexsort((s, comp, v))
        s, v, comp = s[order], v[order], comp[order]
        keep = np.r_[True, (v[1:] != v[:-1]) | (comp[1:] != comp[:-1])]
        st.touch_stubs = s[keep]

    def _count_components(self, st: PartState) -> int:
        stubs = np.concatenate([st.open_stubs, st.touch_stubs])
        if len(stubs) == 0:
            return 0
        labels = self._labels()
        return len(np.unique(labels[stubs]))

    # ------------------------------------------------------------------
    # Phase 2 merging
    # ------------------------------------------------------------------
    def _merge(self, states, lv) -> Tuple[Dict[int, np.ndarray], Dict[int, int]]:
        new_local: Dict[int, np.ndarray] = {}
        comm: Dict[int, int] = {}
        # edges localizing after this level's merges
        act = self.cut_eids[self.act_level[self.cut_eids] == lv.level]
        for child, parent in lv.pairs:
            c, p = states[child], states[parent]
            shipped = (3 * len(c.open_stubs) + 4 * len(c.touch_stubs)
                       + 4 * c.n_components)
            # deferred_transfer: only edges localizing *now* ship from the
            # child's side; else every live one does (one copy ships
            # either way, remote_dedup or not)
            ship = act if self.deferred_transfer else self._live(lv.level)
            side_u, side_v = self._sides(ship, lv.level - 1, child)
            shipped += 2 * int((side_u | side_v).sum())
            p.vertices = np.concatenate([p.vertices, c.vertices])
            p.open_stubs = np.concatenate([p.open_stubs, c.open_stubs])
            p.touch_stubs = np.concatenate([p.touch_stubs, c.touch_stubs])
            comm[child] = comm.get(child, 0) + shipped
            del states[child]
        for pid in list(states.keys()):
            mine = act[self.act_dest[act] == pid]
            new_local[pid] = mine
        return new_local, comm
