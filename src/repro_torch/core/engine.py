"""BSP engine on one device: partitions as a leading tensor dimension,
supersteps as a Python loop (mirrors ``repro/core/engine.py``).

The reference maps each partition to a mesh device and runs the whole
level scan in one ``shard_map`` program.  Here all partitions live on one
device and each superstep loops over them:

  * ``axis_index`` is the partition's index in the loop;
  * the tiled ``all_to_all`` of each partition's ``[n, lane]`` send
    buffers is a transpose ``[n_src, n_dst, lane] → [n_dst, n_src, lane]``
    (:func:`_receive`), so every receiver sees its lanes source-major, as
    on the mesh;
  * the post-scan ``all_gather`` of mate shards disappears: one
    ``[2E + 1]`` int32 mate tensor (pad slot at ``2E``) takes each level's
    logged pairs in level order, so later levels win; within a level the
    pairs are disjoint, so the scatter is deterministic.

Host-side planning (:meth:`Engine.plan`, :meth:`Engine.size_caps`,
:meth:`Engine.load`) is the reference's numpy, unchanged.

For the sharded Phase 3 the reference routes each mate write to the
shard ``ws // S`` that owns the stub, so its shards are the flat mate cut
into ``[n, S]``.  Here :func:`stub_shards` does that cut on the
accumulated mate (pad −1) and on the stub-vertex map (pad vertex 0, the
reference's ``_pad_sv``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .graph import PartitionedGraph
from .phase1 import (BIG, I32, NewEdges, OpenTable, Phase1Caps, TouchTable,
                     _compact, _seg_starts, _valid_first, pair_table_cap,
                     phase1_local)
from .phase2 import MergeTree, generate_merge_tree
from .phase3 import shard_width


@dataclasses.dataclass(frozen=True)
class EngineCaps:
    """Static capacities of the per-partition tables (see loader sizing).
    The fields and their values are the reference's, so bucket keys
    compare equal across the two packages."""

    edge_cap: int        # level-0 local edges per partition
    park_cap: int        # parked remote edges per partition
    ship_cap: int        # per (src,dst) lane width, edges
    new_cap: int         # activated edges entering one Phase 1
    open_cap: int
    touch_cap: int
    open_ship_cap: int = 0    # per (src,dst) lane for opens (0 → open_cap)
    touch_ship_cap: int = 0   # per (src,dst) lane for touch (0 → touch_cap)
    mate_ship_cap: int = 0    # mesh-only lane for mate writes: on one
                              # device nothing ships, so it sizes nothing
    hook_rounds: int = 0
    splice_rounds: int = 12
    phase3_rounds: int = 64   # pivot-splice round budget of Phase 3
    static_splice: bool = False
    p3v_cap: int = 0          # sharded Phase 3's per-shard vertex-record
                              # table width (0 → num_edges)

    def phase1(self) -> Phase1Caps:
        return Phase1Caps(
            open_cap=self.open_cap,
            touch_cap=self.touch_cap,
            hook_rounds=self.hook_rounds,
            splice_rounds=self.splice_rounds,
            static_splice=self.static_splice,
        )

    def pair_cap(self) -> int:
        """Width of Phase 1's compacted pair table (its mate-log width)."""
        return pair_table_cap(2 * self.new_cap + self.open_cap,
                              self.touch_cap)


class EngineState(NamedTuple):
    """BSP state; leading axis = partition."""

    # parked remote edges (on the leaf partition that owns them)
    pk_eid: torch.Tensor   # [n, PK]
    pk_u: torch.Tensor
    pk_v: torch.Tensor
    pk_lau: torch.Tensor
    pk_lav: torch.Tensor
    pk_act: torch.Tensor   # activation level
    pk_own0: torch.Tensor  # level-0 partition of endpoint u (dest key)
    pk_mask: torch.Tensor
    # open path endpoints
    op_stub: torch.Tensor  # [n, OC]
    op_vert: torch.Tensor
    op_la: torch.Tensor
    op_comp: torch.Tensor
    op_own0: torch.Tensor
    op_mask: torch.Tensor
    # boundary touch pairs
    tc_s1: torch.Tensor    # [n, TC]
    tc_s2: torch.Tensor
    tc_vert: torch.Tensor
    tc_la: torch.Tensor
    tc_comp: torch.Tensor
    tc_own0: torch.Tensor
    tc_mask: torch.Tensor
    # level-0 local edges (consumed at superstep 0)
    le_eid: torch.Tensor   # [n, EC]
    le_u: torch.Tensor
    le_v: torch.Tensor
    le_lau: torch.Tensor
    le_lav: torch.Tensor
    le_mask: torch.Tensor


class RunOut(NamedTuple):
    """What the level loop leaves on the device."""

    mate: torch.Tensor     # [2E] int32 accumulated mate (-1 = unmated)
    flags: torch.Tensor    # [n, L, 4] bool: cc, splice, p1-overflow, ship
    metrics: torch.Tensor  # [n, L, 4] int32 longs: remote, opens, touch, comps
    level_s: Tuple[float, ...]  # wall seconds of each superstep


def drained_clock(device: torch.device) -> float:
    """Host clock read after ``device`` has drained its queue."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def state_from_numpy(state_np, anc: np.ndarray, sv: np.ndarray,
                     device) -> Tuple[EngineState, torch.Tensor, torch.Tensor]:
    """Upload a numpy ``EngineState`` (the field layout of
    ``repro.core.engine.EngineState``, as ``DistributedEngine.load(pg,
    device=False)`` or :meth:`Engine.load` return it), the ancestor table
    and the stub-vertex map.  Returns ``(state, anc, sv)`` on ``device``."""
    fields = [torch.as_tensor(np.ascontiguousarray(getattr(state_np, f)),
                              device=device)
              for f in EngineState._fields]
    return (EngineState(*fields),
            torch.as_tensor(np.asarray(anc, dtype=np.int32), device=device),
            torch.as_tensor(np.asarray(sv, dtype=np.int32), device=device))


def build_anc_table(tree: MergeTree, n: int) -> np.ndarray:
    """``anc[level, part0] → active partition after that level's merges``
    for every level at once."""
    anc = np.empty((max(1, tree.height), n), dtype=np.int32)
    cur = np.arange(n)
    for lv in tree.levels:
        pmap = np.arange(n)
        for child, parent in lv.pairs:
            pmap[child] = parent
        cur = pmap[cur]
        anc[lv.level] = cur
    if tree.height == 0:
        anc[0] = cur
    return anc


def stub_vertex(pg: PartitionedGraph) -> np.ndarray:
    """``[2E]`` vertex of every stub (stub 2e at u, 2e+1 at v)."""
    E = pg.graph.num_edges
    sv = np.empty(2 * E, dtype=np.int64)
    sv[0::2] = pg.graph.edge_u
    sv[1::2] = pg.graph.edge_v
    return sv


def stub_shards(x: torch.Tensor, n: int, fill: int) -> torch.Tensor:
    """A ``[2E]`` stub array padded with ``fill`` to the sharded Phase 3's
    ``n·S`` stub space and viewed as ``[n, S]``, ``S = shard_width(E, n)``.
    The mate pads with −1 (unmated); the stub-vertex map with vertex 0,
    which Phase 3 never reads for an unmated stub."""
    total = n * shard_width(x.shape[0] // 2, n)
    pad = torch.full((total - x.shape[0],), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad]).view(n, -1)


def _route(dest: torch.Tensor, mask: torch.Tensor, fields, n: int,
           lane: int):
    """Scatter entries into an [n, lane] send buffer keyed by dest
    partition.  Returns (buffers..., buf_mask, overflow)."""
    dev = dest.device
    key = torch.where(mask, dest, n)          # pads route to virtual slot n
    order = torch.argsort(key, stable=True)
    kd = key[order]
    idx = torch.arange(kd.shape[0], dtype=I32, device=dev)
    lane_pos = idx - _seg_starts(kd)
    ok = (kd < n) & (lane_pos < lane)
    overflow = ((kd < n) & (lane_pos >= lane)).any()
    flat = torch.where(ok, kd * lane + lane_pos, n * lane).to(torch.int64)
    outs = []
    for f in fields:
        buf = torch.full((n * lane + 1,), BIG, dtype=f.dtype, device=dev)
        buf[flat] = torch.where(ok, f[order], BIG)   # pads all write BIG
        outs.append(buf[:-1].reshape(n, lane))
    bm = torch.zeros(n * lane + 1, dtype=torch.bool, device=dev)
    bm[flat] = ok
    return outs, bm[:-1].reshape(n, lane), overflow


def _receive(sent, dst: int):
    """Destination ``dst``'s side of the tiled ``all_to_all``: lane
    ``dst`` of every source's ``[n_dst, lane]`` send buffers, concatenated
    source-major — row ``dst`` of the transpose ``[n_src, n_dst, lane] →
    [n_dst, n_src, lane]``, built one destination at a time so the full
    transpose is never held.  ``sent[src]`` is source src's ``_route``
    output; returns (flat fields, flat mask)."""
    fields = [torch.cat([x[0][i][dst] for x in sent])
              for i in range(len(sent[0][0]))]
    return fields, torch.cat([x[1][dst] for x in sent])


def _fit(x: torch.Tensor, cap: int, fill=None):
    """Pad/trim a 1-D tensor to ``cap``."""
    if fill is None:
        fill = False if x.dtype == torch.bool else BIG
    if x.shape[0] >= cap:
        return x[:cap]
    pad = torch.full((cap - x.shape[0],), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad])


class Engine:
    """Drives the supersteps of one partitioned graph on one device
    (counterpart of ``repro.core.engine.DistributedEngine``; Phase 3 is
    left to the solver, which runs :mod:`repro_torch.core.phase3` on
    :attr:`RunOut.mate` or on its :func:`stub_shards`)."""

    def __init__(self, n_parts: int, caps: EngineCaps, n_levels: int):
        self.n = int(n_parts)
        self.caps = caps
        self.n_levels = n_levels  # supersteps ≥ tree height + 1 (ladder)

    # ------------------------------------------------------------------
    # loading (host numpy, as in the reference)
    # ------------------------------------------------------------------
    @staticmethod
    def plan(pg: PartitionedGraph) -> Tuple[
        MergeTree, np.ndarray, np.ndarray, np.ndarray, np.ndarray
    ]:
        """Merge tree + per-edge activation schedule + per-vertex last
        activation level + the full ancestor table."""
        tree = generate_merge_tree(pg.meta)
        n = pg.num_parts
        anc = build_anc_table(tree, n)
        E = pg.graph.num_edges
        act = np.full(E, -1, dtype=np.int64)
        is_cut = pg.edge_part_u != pg.edge_part_v
        cut_ids = np.nonzero(is_cut)[0]
        if len(cut_ids):
            cu = pg.edge_part_u[cut_ids].astype(np.int64)
            cv = pg.edge_part_v[cut_ids].astype(np.int64)
            # merge level, batched: first level where ancestors agree
            eq = anc[:, cu] == anc[:, cv]
            hit = eq.any(axis=0)
            act[cut_ids] = np.where(hit, np.argmax(eq, axis=0),
                                    tree.height - 1)
        # last activation level per vertex (for touch-retention)
        V = pg.graph.num_vertices
        la = np.zeros(V, dtype=np.int64)
        np.maximum.at(la, pg.graph.edge_u[cut_ids], act[cut_ids] + 1)
        np.maximum.at(la, pg.graph.edge_v[cut_ids], act[cut_ids] + 1)
        return tree, act, la, cut_ids, anc

    @staticmethod
    def _keepers(pg: PartitionedGraph, cu: np.ndarray,
                 cv: np.ndarray) -> np.ndarray:
        """§5a: the lighter partition keeps (parks) each cut edge (ties to
        the smaller pid)."""
        loads = np.array([len(p.remote_eids) for p in pg.parts],
                         dtype=np.int64)
        keep_u = (loads[cu] < loads[cv]) | (
            (loads[cu] == loads[cv]) & (cu <= cv)
        )
        return np.where(keep_u, cu, cv)

    @classmethod
    def size_caps(cls, pg: PartitionedGraph, slack: float = 1.3,
                  open_cap: Optional[int] = None,
                  touch_cap: Optional[int] = None) -> EngineCaps:
        """Exact capacity sizing from the activation schedule."""
        tree, act, la, cut_ids, anc = cls.plan(pg)
        n = pg.num_parts
        edge_cap = max(len(p.local_eids) for p in pg.parts)
        if len(cut_ids):
            cu = pg.edge_part_u[cut_ids].astype(np.int64)
            cv = pg.edge_part_v[cut_ids].astype(np.int64)
            keeper = cls._keepers(pg, cu, cv)
            park_max = int(np.bincount(keeper, minlength=n).max())
            lvl = act[cut_ids]
            dest = anc[lvl, cu].astype(np.int64)
            hh = max(1, tree.height)
            new_cap_v = int(np.bincount(dest * hh + lvl).max())
            _, ship_cnt = np.unique((keeper * n + dest) * hh + lvl,
                                    return_counts=True)
            ship_cap_v = int(ship_cnt.max())
        else:
            park_max, new_cap_v, ship_cap_v = 0, 1, 1
        # opens bounded by odd-degree vertex counts; touch by boundary counts
        deg = pg.graph.degrees()
        V = pg.graph.num_vertices
        ob = 0
        bmax = 0
        for lvl in range(tree.height + 1):
            live = cut_ids[act[cut_ids] >= lvl]
            future = np.zeros(V, dtype=np.int64)
            np.add.at(future, pg.graph.edge_u[live], 1)
            np.add.at(future, pg.graph.edge_v[live], 1)
            odd = (deg - future) % 2 == 1
            anc_row = anc[lvl - 1] if lvl > 0 else np.arange(n)
            owner = anc_row[pg.part_of_vertex]
            if odd.any():
                ob = max(ob, int(np.bincount(owner[odd]).max()))
            busy = future > 0
            if busy.any():
                bmax = max(bmax, int(np.bincount(owner[busy]).max()))
        oc = open_cap or max(16, int(2 * ob * slack))
        tc = touch_cap or max(16, int(bmax * 4 * slack))
        # the sharded Phase 3's vertex-record bound: the largest degree
        # sum a partition owns (owner(v) = v mod n)
        owner_v = np.arange(V) % n
        p3v = int(np.bincount(owner_v, weights=deg, minlength=n).max())
        return EngineCaps(
            edge_cap=int(edge_cap * slack),
            park_cap=max(8, int(park_max * slack)),
            ship_cap=max(8, int(ship_cap_v * slack)),
            # the level-0 pool holds the initial local edges too
            new_cap=max(8, int(new_cap_v * slack), int(edge_cap * slack)),
            open_cap=oc,
            touch_cap=tc,
            open_ship_cap=oc,
            touch_ship_cap=tc,
            p3v_cap=max(16, int(p3v * slack)),
        )

    def load(self, pg: PartitionedGraph) -> Tuple[EngineState, np.ndarray]:
        """Build the initial state as host numpy arrays (the reference's
        ``load(pg, device=False)``).  Returns (state, anc_table); upload
        with :func:`state_from_numpy`."""
        if pg.num_parts != self.n:
            raise ValueError(
                f"graph partitioned into {pg.num_parts} parts, but this "
                f"engine runs {self.n} partitions"
            )
        tree, act, la, cut_ids, anc_table = self.plan(pg)
        # level ladder: extra supersteps past the tree's height repeat its
        # last (fully merged) ancestor row — byte-transparent no-ops
        rows = max(1, self.n_levels - 1)
        if self.n_levels < tree.height + 1:
            raise ValueError(
                f"engine built for {self.n_levels} supersteps but the "
                f"merge tree needs {tree.height + 1}"
            )
        if anc_table.shape[0] < rows:
            anc_table = np.concatenate([
                anc_table,
                np.repeat(anc_table[-1:], rows - anc_table.shape[0], axis=0),
            ])
        n, c = self.n, self.caps
        g = pg.graph

        def full(shape, fill=BIG):
            return np.full(shape, fill, dtype=np.int32)

        pk = {k: full((n, c.park_cap)) for k in
              ("eid", "u", "v", "lau", "lav", "act", "own0")}
        pk_mask = np.zeros((n, c.park_cap), dtype=bool)
        le = {k: full((n, c.edge_cap)) for k in ("eid", "u", "v", "lau", "lav")}
        le_mask = np.zeros((n, c.edge_cap), dtype=bool)

        for p in pg.parts:
            eids = p.local_eids
            k = len(eids)
            if k > c.edge_cap:
                raise ValueError(
                    f"partition {p.pid} holds {k} local edges, over the "
                    f"edge_cap of {c.edge_cap}; resize the caps"
                )
            le["eid"][p.pid, :k] = eids
            le["u"][p.pid, :k] = g.edge_u[eids]
            le["v"][p.pid, :k] = g.edge_v[eids]
            le["lau"][p.pid, :k] = la[g.edge_u[eids]]
            le["lav"][p.pid, :k] = la[g.edge_v[eids]]
            le_mask[p.pid, :k] = True

        if len(cut_ids):
            cu = pg.edge_part_u[cut_ids].astype(np.int64)
            cv = pg.edge_part_v[cut_ids].astype(np.int64)
            keeper = self._keepers(pg, cu, cv)
            order = np.argsort(keeper, kind="stable")
            ks, es = keeper[order], cut_ids[order]
            idx = np.arange(len(ks))
            seg0 = np.where(np.r_[True, ks[1:] != ks[:-1]], idx, 0)
            pos = idx - np.maximum.accumulate(seg0)
            if int(pos.max(initial=0)) >= c.park_cap:
                raise ValueError("park_cap overflow at load")
            pk["eid"][ks, pos] = es
            pk["u"][ks, pos] = g.edge_u[es]
            pk["v"][ks, pos] = g.edge_v[es]
            pk["lau"][ks, pos] = la[g.edge_u[es]]
            pk["lav"][ks, pos] = la[g.edge_v[es]]
            pk["act"][ks, pos] = act[es]
            pk["own0"][ks, pos] = pg.edge_part_u[es]
            pk_mask[ks, pos] = True

        oc, tc = c.open_cap, c.touch_cap
        z_o = np.full((n, oc), BIG, dtype=np.int32)
        z_t = np.full((n, tc), BIG, dtype=np.int32)
        state = EngineState(
            pk_eid=pk["eid"], pk_u=pk["u"], pk_v=pk["v"], pk_lau=pk["lau"],
            pk_lav=pk["lav"], pk_act=pk["act"], pk_own0=pk["own0"],
            pk_mask=pk_mask,
            op_stub=z_o, op_vert=z_o.copy(), op_la=z_o.copy(),
            op_comp=z_o.copy(), op_own0=z_o.copy(),
            op_mask=np.zeros((n, oc), dtype=bool),
            tc_s1=z_t, tc_s2=z_t.copy(), tc_vert=z_t.copy(),
            tc_la=z_t.copy(), tc_comp=z_t.copy(), tc_own0=z_t.copy(),
            tc_mask=np.zeros((n, tc), dtype=bool),
            le_eid=le["eid"], le_u=le["u"], le_v=le["v"],
            le_lau=le["lau"], le_lav=le["lav"], le_mask=le_mask,
        )
        return state, anc_table

    # ------------------------------------------------------------------
    # the superstep
    # ------------------------------------------------------------------
    def superstep(self, lvl: int, anc: torch.Tensor, state: EngineState):
        """One level over every partition: ship parked edges, opens and
        touch pairs to their active partition, run Phase 1 there, refresh
        the tables.  Returns ``(state', log_s1, log_s2, log_mask, flags,
        metrics)``, the per-partition outputs stacked on a leading axis
        (logs ``[n, PC]``, flags ``[n, 4]`` bool, metrics ``[n, 4]``)."""
        n, c = self.n, self.caps
        osc = c.open_ship_cap or c.open_cap
        tsc = c.touch_ship_cap or c.touch_cap
        dest_row = anc[max(lvl - 1, 0)]              # [n] part0 → active pid
        st = [EngineState(*(x[p] for x in state)) for p in range(n)]

        # ---- 1. route parked edges, opens, touch pairs (per source) ----
        sends, pk_sent, op_sent, tc_sent = [], [], [], []
        for me, s in enumerate(st):
            # deferred transfer (§5): parked edges ship at their level only
            send = s.pk_mask & (s.pk_act == lvl - 1)
            sends.append(send)
            e_dest = torch.where(send, dest_row[s.pk_own0.clamp(0, n - 1)], n)
            pk_sent.append(_route(
                e_dest, send,
                (s.pk_eid, s.pk_u, s.pk_v, s.pk_lau, s.pk_lav, s.pk_act,
                 s.pk_own0),
                n, c.ship_cap))
            o_dest = dest_row[s.op_own0.clamp(0, n - 1)] if lvl > 0 \
                else torch.full_like(s.op_own0, me)
            op_sent.append(_route(
                torch.where(s.op_mask, o_dest, n), s.op_mask,
                (s.op_stub, s.op_vert, s.op_la, s.op_comp, s.op_own0),
                n, osc))
            t_dest = dest_row[s.tc_own0.clamp(0, n - 1)] if lvl > 0 \
                else torch.full_like(s.tc_own0, me)
            tc_sent.append(_route(
                torch.where(s.tc_mask, t_dest, n), s.tc_mask,
                (s.tc_s1, s.tc_s2, s.tc_vert, s.tc_la, s.tc_comp,
                 s.tc_own0),
                n, tsc))

        # ---- 2. per destination: receive, Phase 1, table refresh ----
        p1caps = c.phase1()
        outs = []
        for me, s in enumerate(st):
            (r_eid, r_u, r_v, r_lau, r_lav, r_act, _), r_mask = \
                _receive(pk_sent, me)
            arrived_now = r_mask & (r_act == lvl - 1)
            if lvl == 0:       # level 0 consumes the initial local edges
                ne = NewEdges(*(_fit(x, c.new_cap) for x in
                                (s.le_eid, s.le_u, s.le_v, s.le_lau,
                                 s.le_lav, s.le_mask)))
                of_new = s.le_mask.sum() > c.new_cap
            else:
                order = _valid_first(arrived_now)
                ne = NewEdges(*(_fit(x[order], c.new_cap) for x in
                                (r_eid, r_u, r_v, r_lau, r_lav,
                                 arrived_now)))
                of_new = arrived_now.sum() > c.new_cap
            (os_, ov_, ol_, oc_, _oo), om_, of3 = _compact(
                *_receive(op_sent, me), c.open_cap)
            opens = OpenTable(os_, ov_, ol_, oc_, om_)
            (ts1, ts2, tv_, tl_, tc_, _to), tm_, of5 = _compact(
                *_receive(tc_sent, me), c.touch_cap)
            touch = TouchTable(ts1, ts2, tv_, tl_, tc_, tm_)

            out = phase1_local(ne, opens, touch, lvl, p1caps)

            (pe, pu, pv, plau, plav, pact, pown), pm, of6 = _compact(
                (s.pk_eid, s.pk_u, s.pk_v, s.pk_lau, s.pk_lav, s.pk_act,
                 s.pk_own0), s.pk_mask & ~sends[me], c.park_cap)
            # own0 of new opens/touch: the current active pid routes them
            # to every future ancestor (anc rows are constant per subtree)
            new_oo = torch.where(out.opens.mask, me, BIG)
            new_to = torch.where(out.touch.mask, me, BIG)
            nstate = EngineState(
                pk_eid=pe, pk_u=pu, pk_v=pv, pk_lau=plau, pk_lav=plav,
                pk_act=pact, pk_own0=pown, pk_mask=pm,
                op_stub=out.opens.stub, op_vert=out.opens.vert,
                op_la=out.opens.la, op_comp=out.opens.comp,
                op_own0=new_oo, op_mask=out.opens.mask,
                tc_s1=out.touch.s1, tc_s2=out.touch.s2,
                tc_vert=out.touch.vert, tc_la=out.touch.la,
                tc_comp=out.touch.comp, tc_own0=new_to,
                tc_mask=out.touch.mask,
                le_eid=s.le_eid, le_u=s.le_u, le_v=s.le_v,
                le_lau=s.le_lau, le_lav=s.le_lav,
                le_mask=torch.zeros_like(s.le_mask),
            )
            ship_of = (pk_sent[me][2] | op_sent[me][2] | of3
                       | tc_sent[me][2] | of5 | of6 | of_new)
            flags = torch.cat([out.flags, (~ship_of).reshape(1)])
            metrics = torch.stack(
                [2 * pm.sum().to(I32),
                 3 * out.opens.mask.sum().to(I32),
                 4 * out.touch.mask.sum().to(I32),
                 4 * out.n_components])
            outs.append((nstate, out.log_s1, out.log_s2, out.log_mask,
                         flags, metrics))

        nstate = EngineState(*(torch.stack([o[0][i] for o in outs])
                               for i in range(len(EngineState._fields))))
        return (nstate,) + tuple(torch.stack([o[k] for o in outs])
                                 for k in range(1, 6))

    def run_levels(self, state: EngineState, anc: torch.Tensor,
                   num_edges: int) -> RunOut:
        """Every superstep in level order, accumulating the mate logs
        into one ``[2E + 1]`` tensor (pad slot ``2E`` takes the masked
        writes, all −1).  The mesh's mate-lane overflow flag has no
        counterpart on one device: flag 3 carries only the table lanes.
        Each level is clocked after the device drained; Phase 1 reads a
        flag on the host every round, so the drain costs little."""
        n_stubs = 2 * num_edges
        dev = state.pk_eid.device
        mate = torch.full((n_stubs + 1,), -1, dtype=I32, device=dev)
        flags, metrics, marks = [], [], [drained_clock(dev)]
        for lvl in range(self.n_levels):
            state, s1, s2, lm, fl, mt = self.superstep(lvl, anc, state)
            ws = torch.cat([s1.reshape(-1), s2.reshape(-1)])
            wv = torch.cat([s2.reshape(-1), s1.reshape(-1)])
            wm = torch.cat([lm.reshape(-1), lm.reshape(-1)])
            # disjoint within a level; later levels overwrite earlier ones
            mate[torch.where(wm, ws, n_stubs).to(torch.int64)] = \
                torch.where(wm, wv, -1)
            flags.append(fl)
            metrics.append(mt)
            marks.append(drained_clock(dev))
        return RunOut(mate=mate[:n_stubs],
                      flags=torch.stack(flags, dim=1),
                      metrics=torch.stack(metrics, dim=1),
                      level_s=tuple(b - a for a, b in zip(marks, marks[1:])))
