"""BSP engine on one device: partitions as a leading tensor dimension,
every superstep over all of them at once (mirrors
``repro/core/engine.py``).

The reference maps each partition to a mesh device and runs the level
scan in one ``shard_map`` program.  Here all partitions live on one
device as the rows of ``[n, ·]`` tensors, and each superstep runs them
all in one pass (:meth:`Engine.superstep`, the counterpart of the
reference's ``_make_superstep_core``):

  * ``axis_index`` is the row index;
  * the tiled ``all_to_all`` of each source's ``[n_dst, lane]`` send
    lanes is the transpose ``[n_src, n_dst, lane] → [n_dst,
    n_src·lane]``, so every receiver sees its lanes source-major, as on
    the mesh.  Only the receive-side mask is materialised (a bool copy);
    the fields a receiver keeps are gathered through flat indices
    straight from the send buffers (:func:`_gather_received`), so the
    wide touch lanes are never held twice;
  * the post-scan ``all_gather`` of mate shards disappears: one
    ``[2E + 1]`` int32 mate tensor (pad slot at ``2E``) takes each level's
    logged pairs in level order, so later levels win; within a level the
    pairs are disjoint, so the scatter is deterministic.

Two execution modes, as in the reference (DESIGN.md §4):

  * **eager** (``fused=False``): :meth:`Engine.run_levels` steps the
    levels in Python and clocks each; the solver then runs and clocks
    Phase 3's steps;
  * **fused** (``fused=True``, the default): :meth:`Engine.fused_program`
    returns the bucket's :class:`FusedRun`, which records the whole solve
    — every level, the mate accumulation and Phase 3 in the engine's
    mode — once as one CUDA graph and replays it for every solve of the
    bucket.  :meth:`FusedRun.launch` only enqueues a replay, on the run's
    side stream, and returns a :class:`PendingRun` whose ``wait`` is the
    run's one device→host synchronization, so the host can prepare the
    next graph meanwhile.  Each splice loop in the graph is one CUDA
    while node (``core/capture.py``), so a replay runs the rounds its
    graph needs.  Both modes run the same superstep and Phase 3
    functions, so their bits are equal; on the CPU the fused body runs
    uncaptured and synchronously.

Host-side planning (:meth:`Engine.plan`, :meth:`Engine.size_caps`,
:meth:`Engine.load`) is the reference's numpy, unchanged.

Across ranks (``Engine(mesh=…)``, a :class:`~repro_torch.launch.mesh.
PartMesh`): each rank holds ``m`` of the ``n`` partitions as its rows and
the exchanges are ``torch.distributed`` calls, the reference's schedule
(:func:`fused_collective_budget`), made whatever the world's size:

  * ``axis_index`` is each row's global partition index;
  * each table group ships every field the reference ships, and its lane
    mask, by one ``all_to_all`` a field (:func:`_exchange`), its send
    lanes laid out by destination rank so that every receiver sees them
    source-major; the receiver compacts with :func:`_receive_compact`'s
    rule, so the bits are the one-device engine's;
  * the fused run routes each level's mate writes to the rank owning the
    stub's shard (``ws // S``, lane ``mate_ship_cap or 2·pair_cap()``,
    its overflow clearing flag 3), and each rank holds only its ``[m,
    S]`` mate shards (:meth:`Engine._route_mates`); the eager run
    all-gathers each level's logs and builds the whole mate on every
    rank (the reference's host replay);
  * Phase 3 runs over the mesh (``core/phase3.py``), and the outputs'
    per-rank rows (flags, metrics, the rank shards) are gathered, so
    every rank returns the same bytes.

For the sharded Phase 3 the reference routes each mate write to the
shard ``ws // S`` that owns the stub, so its shards are the flat mate cut
into ``[n, S]``.  Here :func:`stub_shards` does that cut on the
accumulated mate (pad −1) and on the stub-vertex map (pad vertex 0, the
reference's ``_pad_sv``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import weakref
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import obs
from . import capture
from .graph import PartitionedGraph
from .phase1 import (BIG, I32, NewEdges, OpenTable, Phase1Caps, TouchTable,
                     _compact, _seg_starts, _valid_first, pair_table_cap,
                     phase1_local, take)
from .phase2 import MergeTree, generate_merge_tree
from .phase3 import (phase3_device, phase3_sharded, shard_width,
                     sharded_phase3_schedule, unshard)


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
    mate_ship_cap: int = 0    # per (src,dst) lane of the mesh's mate
                              # route (0 → 2·pair_cap); the one-device
                              # engine scatters mates locally
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


class FusedOut(NamedTuple):
    """Everything the fused run leaves on the device, fetched with one
    synchronization (the reference's ``FusedOut``).  Under
    ``gather_circuit=False`` ``circuit`` is the still-sharded rank triple
    ``(mate, dist, reach)`` as ``[n·S, 3]`` and ``mate`` its first column
    cut to ``2E``; the host emits the circuit from them."""

    circuit: torch.Tensor    # [E] int32 arrival stubs in walk order
    mate: torch.Tensor       # [2E] int32 post-splice mate
    flags: torch.Tensor      # [n, L, 4] bool
    metrics: torch.Tensor    # [n, L, 4] int32
    phase3_ok: torch.Tensor  # [] bool


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
    ``n·S`` stub space and viewed as ``[n, S]``, ``S = shard_width(E, n)``;
    a batch's ``[B, 2E]`` becomes ``[n, B, S]`` (the batch axis after the
    partition axis).  The mate pads with −1 (unmated); the stub-vertex
    map with vertex 0, which Phase 3 never reads for an unmated stub."""
    total = n * shard_width(x.shape[-1] // 2, n)
    pad = torch.full((*x.shape[:-1], total - x.shape[-1]), fill,
                     dtype=x.dtype, device=x.device)
    y = torch.cat([x, pad], -1)
    if x.dim() == 1:
        return y.view(n, -1)
    return y.view(x.shape[0], n, -1).transpose(0, 1).contiguous()


def require_batch_fits(num_edges: int, batch: int) -> None:
    """A batched program numbers its graphs' stubs in one int32 space
    (``B·(2E + 1)`` mate slots, ``B·2E`` component labels), which must
    stay below int32 max (the tables' mask value)."""
    if batch < 1 or batch * (2 * num_edges + 1) > BIG:
        raise ValueError(
            f"a batch of {batch} graphs of {num_edges} edges does not fit "
            f"the batched program's int32 stub ids (B·(2E + 1) ≤ {BIG}); "
            f"use a smaller batch")


#: Field counts behind the fused program's collective schedule (the
#: reference's ``_SHIP_GROUPS``): on the mesh each table group ships every
#: field plus its lane mask through an ``all_to_all`` of its own a
#: superstep, and the mate route adds (s, v, mask).  Derived from
#: ``EngineState`` so the budget tracks the state layout.  Here a group's
#: exchange (:func:`_route`, :func:`_log_mates`) stands for all of them.
_SHIP_GROUPS = {
    "park": sum(f.startswith("pk_") for f in EngineState._fields),   # 8
    "open": sum(f.startswith("op_") for f in EngineState._fields),   # 6
    "touch": sum(f.startswith("tc_") for f in EngineState._fields),  # 7
    "mate": 3,                                                       # s, v, m
}


def fused_collective_budget(n_levels: int, num_edges: Optional[int] = None,
                            n_parts: Optional[int] = None,
                            sharded_phase3: bool = False,
                            gather_circuit: bool = True) -> dict:
    """The fused program's static collective schedule, the reference's
    (``repro/core/engine.py::fused_collective_budget``), counted as its
    traced eqns: per level, one ``all_to_all`` per shipped field per
    table group (``_SHIP_GROUPS``); after the levels, one ``all_gather``
    for the replicated Phase 3, or for the sharded one
    (``sharded_phase3=True``, needs ``num_edges`` and ``n_parts``) the
    ring schedule of :func:`~repro_torch.core.phase3.sharded_phase3_schedule`.
    ``dynamic_all_to_all`` is the per-run total over the ``n_levels``
    levels.  On one device each is a stand-in (module docstring), and
    ``repro_torch.analysis.graph_audit`` holds a recording's calls at
    them to this schedule."""
    per_level = sum(_SHIP_GROUPS.values())
    out = {
        "all_to_all": per_level,          # eqns inside the level-scan body
        "all_gather": 1,                  # eqns outside the scan
        "psum": 0,
        "ppermute": 0,
        "scan_length": n_levels,
        "dynamic_all_to_all": per_level * n_levels,
    }
    if sharded_phase3:
        if num_edges is None or n_parts is None:
            raise ValueError(
                "sharded_phase3 budget needs num_edges and n_parts")
        sched = sharded_phase3_schedule(num_edges, n_parts,
                                        gather_circuit=gather_circuit)
        out["all_gather"] = sched["all_gather"]
        out["ppermute"] = sched["ppermute"]
        out["psum"] = sched["psum"]
        out["phase3"] = sched
    return out


def _lane_slots(dest: torch.Tensor, mask: torch.Tensor, n: int,
                lane: int):
    """Each row's entries sorted by destination partition (a per-row
    stable argsort of the ``[rows, X]`` keys; pads key ``n``): ``(order,
    destination, slot in its lane, ships, per-row overflow)``, the middle
    three in sorted order."""
    key = torch.where(mask, dest, n)          # pads route to virtual slot n
    order = torch.argsort(key, dim=-1, stable=True)
    kd = take(key, order)
    idx = torch.arange(kd.shape[-1], device=kd.device)
    lane_pos = idx - _seg_starts(kd)
    ok = (kd < n) & (lane_pos < lane)
    overflow = ((kd < n) & (lane_pos >= lane)).any(-1)
    return order, kd, lane_pos, ok, overflow


def _route(dest: torch.Tensor, mask: torch.Tensor, fields, n: int,
           lane: int, group: str):
    """Every source row's entries into its ``n`` send lanes of width
    ``lane``, keyed by destination partition (:func:`_lane_slots`), one
    scatter per field into ``[n_src, n·lane + 1]`` buffers (BIG-filled;
    the last column is the pad slot that takes every entry that does not
    ship).  Returns (buffers, mask buffer, per-source overflow [n_src]).
    ``group`` (a key of ``_SHIP_GROUPS``) is the table group shipped: the
    reference's ``all_to_all`` of each of its fields (:mod:`.capture`'s
    census)."""
    capture.note("all_to_all", _SHIP_GROUPS[group])
    order, kd, lane_pos, ok, overflow = _lane_slots(dest, mask, n, lane)
    flat = torch.where(ok, kd * lane + lane_pos, n * lane)
    width = (kd.shape[0], n * lane + 1)
    outs = []
    for f in fields:                          # pads all write BIG
        buf = torch.full(width, BIG, dtype=f.dtype, device=f.device)
        outs.append(buf.scatter_(-1, flat, torch.where(ok, take(f, order),
                                                       BIG)))
    bm = torch.zeros(width, dtype=torch.bool, device=kd.device)
    return outs, bm.scatter_(-1, flat, ok), overflow


def _exchange(dest: torch.Tensor, mask: torch.Tensor, fields, n: int,
              lane: int, group: str, mesh, keep: Optional[int] = None):
    """:func:`_route` across the ranks of ``mesh``: the local rows'
    entries into their send lanes, laid out ``[world (destination rank),
    m·B (source row), m (destination partition), lane]``, one field at a
    time, each shipped by one ``all_to_all`` (the mask last, as uint8)
    and its send buffer dropped before the next is built.  The rows are
    the ``m`` local partitions, or for a batch of B graphs ``m·B``
    (partition, graph) pairs, partition major, and a row's entries go to
    its own graph's row of the destination partition, as in
    :func:`_received_mask`.  Every rank receives ``[n_src, B, m, lane]``:
    source-major lanes for each of its rows, so :func:`_gather_received`
    reads them as the ``[n_src·B, m·lane]`` buffers it is given.
    ``keep`` (default all): the fields whose received copies are
    returned; the rest are shipped, as the reference ships them, and
    dropped.  Returns (received fields, received mask ``[n_src·B,
    m·lane]``, per-source-row overflow [m·B])."""
    capture.note("all_to_all", _SHIP_GROUPS[group])
    order, kd, lane_pos, ok, overflow = _lane_slots(dest, mask, n, lane)
    rows, m = kd.shape[0], mesh.m
    src = torch.arange(rows, device=kd.device)[:, None]
    size = rows * n * lane
    flat = torch.where(ok, ((kd // m * rows + src) * m + kd % m) * lane +
                       lane_pos, size).view(-1)
    del kd, lane_pos
    out = []
    for i, f in enumerate(fields):
        buf = torch.full((size + 1,), BIG, dtype=f.dtype, device=f.device)
        buf.scatter_(0, flat, torch.where(ok, take(f, order), BIG).view(-1))
        got = mesh.all_to_all(buf[:size])
        del buf
        if keep is None or i < keep:
            out.append(got.view(-1, m * lane))
        del got
    bm = torch.zeros(size + 1, dtype=torch.bool, device=ok.device)
    rm = mesh.all_to_all(bm.scatter_(0, flat, ok.view(-1))[:size])
    return out, rm.view(-1, m * lane), overflow


def _received_rows(rm: torch.Tensor, lane: int, n: int) -> torch.Tensor:
    """:func:`_exchange`'s received mask ``[n_src·B, m·lane]`` as each
    destination row's ``[m·B, n_src·lane]``, source-major, rows
    (partition, graph) pairs, partition major (a bool copy, the
    counterpart of :func:`_received_mask`)."""
    batch = rm.shape[0] // n
    return rm.view(n, batch, -1, lane).permute(2, 1, 0, 3).reshape(
        -1, n * lane)


def _received_mask(bm: torch.Tensor, lane: int,
                   batch: int = 1) -> torch.Tensor:
    """Destination side of the tiled ``all_to_all`` of the mask lanes:
    row ``dst`` holds lane ``dst`` of every source, source-major —
    ``[n_src, n_dst, lane] → [n_dst, n_src·lane]``, a bool copy.  Rows
    are (partition, graph) pairs of a batch of ``batch`` graphs,
    partition major, and the exchange stays within each graph: ``[n_src,
    B, n_dst, lane] → [n_dst, B, n_src·lane]``."""
    n = bm.shape[0] // batch
    return bm[:, :n * lane].view(n, batch, n, lane).permute(
        2, 1, 0, 3).reshape(n * batch, -1)


def _gather_received(buf: torch.Tensor, pos: torch.Tensor, lane: int,
                     batch: int = 1) -> torch.Tensor:
    """Destination ``dst``'s received entries at positions ``pos[dst]``
    (received position ``j`` is lane slot ``j % lane`` of source
    ``j // lane``, of the same graph), read through flat indices from the
    ``[n_src·B, n·lane + 1]`` send buffer ``buf``, so the receive side is
    never materialised."""
    width = buf.shape[1]
    row = torch.arange(pos.shape[0], device=pos.device)[:, None]
    # source partition j // lane of this row's graph b is send row
    # (j // lane)·B + b.  Keep this order of [n, cap] int64 temporaries:
    # a recorded graph's pool is sized by it, and the same sum built in
    # place reserved 0.64 GiB more at scale 20 (H100, one graph)
    here = (row % batch) * width + (row // batch) * lane
    return buf.reshape(-1)[(pos // lane) * (batch * width) + here +
                           pos % lane]


def _receive_compact(bufs, rmask: torch.Tensor, lane: int, cap: int,
                     batch: int = 1):
    """Each destination's received entries where ``rmask`` holds, moved
    to the front and cut to ``cap`` (``_compact`` of the received rows).
    Returns (fields, mask, per-destination overflow)."""
    order = _valid_first(rmask)[:, :cap]
    return (tuple(_gather_received(b, order, lane, batch) for b in bufs),
            take(rmask, order), rmask.sum(-1) > cap)


class _OneDevice:
    """The superstep's exchange on one device: the send lanes stay where
    :func:`_route` built them, each receiver reads its own in place
    (:func:`_received_mask`, :func:`_gather_received`), and the fields the
    reference ships only for its schedule (``extra``) are not built."""

    def __init__(self, n: int, batch: int):
        self.n, self.batch = n, batch

    def ship(self, dest, mask, fields, extra, lane: int, group: str):
        return _route(dest, mask, fields, self.n, lane, group)

    def received(self, bm: torch.Tensor, lane: int) -> torch.Tensor:
        return _received_mask(bm, lane, self.batch)


class _AcrossRanks:
    """The superstep's exchange across the ranks of a mesh: every field,
    ``extra`` too, by one ``all_to_all`` each (:func:`_exchange`), the
    ``extra`` ones dropped on arrival; a batch's graphs stay apart."""

    def __init__(self, n: int, mesh, batch: int):
        self.n, self.mesh, self.batch = n, mesh, batch

    def ship(self, dest, mask, fields, extra, lane: int, group: str):
        return _exchange(dest, mask, (*fields, *extra), self.n, lane, group,
                         self.mesh, keep=len(fields))

    def received(self, rm: torch.Tensor, lane: int) -> torch.Tensor:
        return _received_rows(rm, lane, self.n)


def _ship(ex, dest, mask, fields, extra, lane: int, cap: int, group: str):
    """Route, exchange (``ex``, :class:`_OneDevice` or
    :class:`_AcrossRanks`) and compact one table group (opens or touch
    pairs): ``(fields, mask, route overflow, compaction overflow)``, the
    first three per destination, the route overflow per source."""
    bufs, bm, of_route = ex.ship(dest, mask, fields, extra, lane, group)
    out, om, of_cap = _receive_compact(bufs, ex.received(bm, lane), lane,
                                       cap, ex.batch)
    return out, om, of_route, of_cap


def _fit(x: torch.Tensor, cap: int, fill=None):
    """Pad/trim the last dimension to ``cap``."""
    if fill is None:
        fill = False if x.dtype == torch.bool else BIG
    if x.shape[-1] >= cap:
        return x[..., :cap]
    pad = torch.full((*x.shape[:-1], cap - x.shape[-1]), fill,
                     dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], -1)


def _log_mates(mate: torch.Tensor, s1, s2, lm, n_stubs: int) -> None:
    """Scatter one level's logged pairs, both directions, into ``mate``
    ``[B, 2E + 1]``, row b taking the pairs of the rows of graph b
    (masked writes all put −1 into their graph's pad slot ``2E``).  It
    stands for the reference's mate route and its ``all_to_all``s."""
    capture.note("all_to_all", _SHIP_GROUPS["mate"])
    batch = mate.shape[0]
    row = torch.arange(s1.shape[0], device=mate.device)[:, None]
    ws = torch.cat([s1, s2], -1)
    wv = torch.cat([s2, s1], -1)
    wm = torch.cat([lm, lm], -1)
    at = torch.where(wm, ws, n_stubs).to(torch.int64)
    at += (row % batch) * (n_stubs + 1)   # in place: a level's largest
    #                                       temporary (1 GiB at scale 20)
    # disjoint within a level; later levels overwrite earlier ones
    mate.view(-1)[at.reshape(-1)] = torch.where(wm, wv, -1).reshape(-1)


def require_deferred_transfer(deferred_transfer: bool) -> None:
    """``deferred_transfer=False`` (the paper's baseline without the §5
    heuristic) is not ported: the reference's ``size_caps`` sizes the
    park table for deferred transfer only, so its own baseline fails its
    capacity flags (ROADMAP queue 3)."""
    if not deferred_transfer:
        raise ValueError(
            "deferred_transfer=False is not ported: the reference sizes "
            "the park table for deferred transfer only and its baseline "
            "fails its own capacity flags (ROADMAP queue 3)")


class Engine:
    """Drives the supersteps and Phase 3 of one bucket's graphs on one
    device (counterpart of ``repro.core.engine.DistributedEngine``).

    ``sharded_phase3`` and ``gather_circuit`` pick the fused run's Phase 3
    (the solver resolves the reference's defaults); the eager path leaves
    Phase 3 to the solver, which runs :mod:`repro_torch.core.phase3` on
    :attr:`RunOut.mate` or on its :func:`stub_shards`.

    As the reference's, an engine holds its programs, one
    :class:`FusedRun` per ``(num_edges, batch)`` (:meth:`fused_program`,
    :meth:`evict_program`), a FIFO of 32 loaded graphs keyed by
    ``id(pg)`` (:meth:`load_cached`), each with its uploaded state once a
    solve kept it on the device (:meth:`device_state`), and an LRU of 8
    batches' stacked device inputs (:meth:`stage_batch`).
    ``remote_dedup`` is stored and never read, as in the reference's
    device engine: :meth:`_keepers` parks each cut edge on one side
    either way.  ``on_trace`` is called at each trace (a fused run's
    recording, on the CPU its first run, and the first eager superstep),
    ``on_upload`` at each host→device state upload; ``trace`` takes the
    spans (default: the process-wide ``repro_torch.obs`` log), and
    ``timed_probe`` adds one ``level`` span a level to eager runs.

    ``mesh`` (a :class:`~repro_torch.launch.mesh.PartMesh` of ``n_parts``
    partitions) runs the engine across its ranks (module docstring): the
    uploaded state is this rank's rows, a batch's too."""

    def __init__(self, n_parts: int, caps: EngineCaps, n_levels: int,
                 sharded_phase3: bool = False, gather_circuit: bool = True,
                 remote_dedup: bool = True, deferred_transfer: bool = True,
                 on_trace: Optional[Callable[[], None]] = None,
                 on_upload: Optional[Callable[[], None]] = None,
                 trace: Optional[obs.TraceLog] = None,
                 timed_probe: bool = False, mesh=None):
        require_deferred_transfer(deferred_transfer)
        if mesh is not None and mesh.n_parts != int(n_parts):
            raise ValueError(f"the mesh holds {mesh.n_parts} partitions, "
                             f"the engine runs {n_parts}")
        self.mesh = mesh
        self.n = int(n_parts)
        self.caps = caps
        self.n_levels = n_levels  # supersteps ≥ tree height + 1 (ladder)
        self.sharded_phase3 = bool(sharded_phase3)
        self.gather_circuit = bool(gather_circuit)
        self.remote_dedup = bool(remote_dedup)
        self.on_trace = on_trace
        self.on_upload = on_upload
        self.trace = trace if trace is not None else obs.default_tracelog()
        self.timed_probe = bool(timed_probe)
        self._stepped = False     # the eager superstep has run (a trace)
        self._fused: Dict[Tuple[int, Optional[int]], FusedRun] = {}
        self._load_cache: Dict[int, dict] = {}
        self._load_cache_max = 32
        # tuple(id(pg)…) → a batch's stacked device inputs; an LRU, so a
        # steady micro-batch over one pool uploads nothing
        self._batch_cache: Dict[tuple, dict] = {}
        self._batch_cache_max = 8

    def _traced(self, program: str, **attrs) -> None:
        """The reference's retrace event and ``on_trace`` call."""
        self.trace.event("retrace", program=program, **attrs)
        if self.on_trace is not None:
            self.on_trace()

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

    def load_cached(self, pg: PartitionedGraph) -> dict:
        """Memoized :meth:`load` and stub-vertex map of ``pg`` (the
        reference's ``_load_cached``): ``{"pg", "state", "anc", "sv",
        "dev"}``, where ``dev`` keeps the uploaded ``(state, anc, sv)``
        once :meth:`device_state` made it resident.  Keyed by ``id(pg)``
        with ``pg`` kept alive by the entry, so an id is never reused
        while its entry lives; a FIFO of 32."""
        ent = self._load_cache.get(id(pg))
        if ent is not None and ent["pg"] is pg:
            return ent
        state, anc = self.load(pg)
        ent = {"pg": pg, "state": state, "anc": anc, "sv": stub_vertex(pg),
               "dev": None}
        if len(self._load_cache) >= self._load_cache_max:
            self._load_cache.pop(next(iter(self._load_cache)))
        self._load_cache[id(pg)] = ent
        return ent

    def device_state(self, ent: dict, device: torch.device,
                     resident: bool = True):
        """``(state, anc, sv)`` of a :meth:`load_cached` entry on
        ``device``: uploaded now (an ``upload`` span and one
        ``on_upload`` call), and with ``resident`` kept on the entry so
        that later solves of the graph upload nothing."""
        if resident and ent["dev"] is not None:
            return ent["dev"]
        state = ent["state"]
        if self.mesh is not None:       # this rank's rows only
            state = EngineState(*(x[self.mesh.rows] for x in state))
        with self.trace.span("upload", edges=len(ent["sv"]) // 2):
            dev = state_from_numpy(state, ent["anc"], ent["sv"], device)
        if self.on_upload is not None:
            self.on_upload()
        if resident:
            ent["dev"] = dev
        return dev

    def stage_batch(self, pgs: List[PartitionedGraph],
                    device: torch.device):
        """The stacked device inputs ``(state [n, B, ·], anc [B, H, n],
        sv [B, 2E])`` of a batch of same-bucket graphs (the reference's
        ``_stage_batch``): each member's memoized host tables
        (:meth:`load_cached`) stacked on the host along the batch axis,
        after the partition axis, and uploaded once a field in one
        ``upload`` span, with one ``on_upload`` call.  Kept in an LRU of
        8 keyed by the members' identities, so a repeat batch uploads
        nothing.  Mixed edge counts raise ``ValueError``; so does a
        replicated batch whose vertex keys would pass int32 max
        (:func:`~repro_torch.core.phase3.splice_components`).  Over a
        mesh only this rank's rows ``[m, B, ·]`` are uploaded, as for
        one graph (:meth:`device_state`)."""
        E = pgs[0].graph.num_edges
        for pg in pgs:
            if pg.graph.num_edges != E:
                raise ValueError(f"mixed edge counts in batch: "
                                 f"{pg.graph.num_edges} != {E}")
        bkey = tuple(id(pg) for pg in pgs)
        bent = self._batch_cache.pop(bkey, None)
        if bent is None or any(a is not b for a, b in zip(bent["pgs"], pgs)):
            ents = [self.load_cached(pg) for pg in pgs]
            B = len(pgs)
            span = max(int(e["sv"].max()) for e in ents) + 1
            if not self.sharded_phase3 and B * span > BIG:
                raise ValueError(
                    f"a replicated batch of {B} graphs with vertex ids "
                    f"below {span} passes int32 max in its vertex keys; "
                    f"use a smaller batch")
            rows = slice(None) if self.mesh is None else self.mesh.rows
            with self.trace.span("upload", edges=E, width=B):
                stacked = EngineState(*(
                    np.stack([getattr(e["state"], f)[rows] for e in ents],
                             axis=1)
                    for f in EngineState._fields))
                dev = state_from_numpy(stacked,
                                       np.stack([e["anc"] for e in ents]),
                                       np.stack([e["sv"] for e in ents]),
                                       device)
            if self.on_upload is not None:
                self.on_upload()
            if len(self._batch_cache) >= self._batch_cache_max:
                self._batch_cache.pop(next(iter(self._batch_cache)))
            bent = {"pgs": list(pgs), "dev": dev}
        self._batch_cache[bkey] = bent          # most recently used last
        return bent["dev"]

    # ------------------------------------------------------------------
    # the superstep
    # ------------------------------------------------------------------
    def superstep(self, lvl: int, anc: torch.Tensor, state: EngineState):
        """One level over every partition at once: ship parked edges,
        opens and touch pairs to their active partition, run Phase 1
        there, refresh the tables.  Returns ``(state', log_s1, log_s2,
        log_mask, flags, metrics)``, every field ``[n, ·]`` (logs
        ``[n, PC]``, flags ``[n, 4]`` bool, metrics ``[n, 4]``).

        A batch of B graphs (``anc`` ``[B, H, n]``) runs as ``n·B`` rows,
        (partition, graph) pairs, partition major: Phase 1 and the table
        refresh are local to a row, and each exchange stays within its
        graph (:func:`_received_mask`).  Over a mesh the rows are this
        rank's ``m`` partitions and each group crosses the ranks
        (:class:`_AcrossRanks`), own0 shipped too as the reference ships
        it (the deferred transfer never reads it on arrival), and level
        0's empty parked lanes as well."""
        n, c = self.n, self.caps
        osc = c.open_ship_cap or c.open_cap
        tsc = c.touch_ship_cap or c.touch_cap
        dev = state.pk_eid.device
        anc = anc if anc.dim() == 3 else anc[None]
        batch = anc.shape[0]
        row = torch.arange(state.pk_eid.shape[0], dtype=I32,
                           device=dev)[:, None]
        if self.mesh is None:
            ex = _OneDevice(n, batch)
            me = row // batch                        # each row's partition
        else:
            ex = _AcrossRanks(n, self.mesh, batch)
            me = row // batch + self.mesh.first
        # [B·n] part0 → active pid, each row reading its own graph's row
        dest_row = anc[:, max(lvl - 1, 0)].reshape(-1)
        graph0 = (row % batch) * n

        def dest_of(own0):
            at = own0.clamp(0, n - 1)
            at += graph0
            return dest_row[at]

        # ---- 1. ship activated parked edges (deferred transfer, §5) ----
        send = state.pk_mask & (state.pk_act == lvl - 1)
        e_dest = torch.where(send, dest_of(state.pk_own0), n)
        parked = (state.pk_eid, state.pk_u, state.pk_v, state.pk_lau,
                  state.pk_lav, state.pk_act)
        if lvl == 0:       # level 0 consumes the initial local edges
            _, _, of1 = ex.ship(e_dest, send, (), (*parked, state.pk_own0),
                                c.ship_cap, "park")
            ne = NewEdges(*(_fit(x, c.new_cap) for x in
                            (state.le_eid, state.le_u, state.le_v,
                             state.le_lau, state.le_lav, state.le_mask)))
            of_new = state.le_mask.sum(-1) > c.new_cap
        else:
            bufs, bm, of1 = ex.ship(e_dest, send, parked, (state.pk_own0,),
                                    c.ship_cap, "park")
            arrived = ex.received(bm & (bufs[5] == lvl - 1), c.ship_cap)
            del bm
            fields, am, of_new = _receive_compact(bufs[:5], arrived,
                                                  c.ship_cap, c.new_cap,
                                                  ex.batch)
            del bufs, arrived
            ne = NewEdges(*(_fit(x, c.new_cap) for x in (*fields, am)))

        # ---- 2. ship opens + touch pairs to their active partition ----
        o_dest = dest_of(state.op_own0) if lvl > 0 \
            else me.expand_as(state.op_own0)
        (os_, ov_, ol_, oc_), om_, of2, of3 = _ship(
            ex, torch.where(state.op_mask, o_dest, n), state.op_mask,
            (state.op_stub, state.op_vert, state.op_la, state.op_comp),
            (state.op_own0,), osc, c.open_cap, "open")
        opens = OpenTable(os_, ov_, ol_, oc_, om_)
        t_dest = dest_of(state.tc_own0) if lvl > 0 \
            else me.expand_as(state.tc_own0)
        (ts1, ts2, tv_, tl_, tc_), tm_, of4, of5 = _ship(
            ex, torch.where(state.tc_mask, t_dest, n), state.tc_mask,
            (state.tc_s1, state.tc_s2, state.tc_vert, state.tc_la,
             state.tc_comp), (state.tc_own0,), tsc, c.touch_cap, "touch")
        touch = TouchTable(ts1, ts2, tv_, tl_, tc_, tm_)

        # ---- 3. Phase 1 ----
        out = phase1_local(ne, opens, touch, lvl, c.phase1())
        del ne, opens, touch

        # ---- 4. refresh the parked table ----
        (pe, pu, pv, plau, plav, pact, pown), pm, of6 = _compact(
            (state.pk_eid, state.pk_u, state.pk_v, state.pk_lau,
             state.pk_lav, state.pk_act, state.pk_own0),
            state.pk_mask & ~send, c.park_cap)
        # own0 of new opens/touch: the current active pid routes them
        # to every future ancestor (anc rows are constant per subtree)
        nstate = EngineState(
            pk_eid=pe, pk_u=pu, pk_v=pv, pk_lau=plau, pk_lav=plav,
            pk_act=pact, pk_own0=pown, pk_mask=pm,
            op_stub=out.opens.stub, op_vert=out.opens.vert,
            op_la=out.opens.la, op_comp=out.opens.comp,
            op_own0=torch.where(out.opens.mask, me, BIG),
            op_mask=out.opens.mask,
            tc_s1=out.touch.s1, tc_s2=out.touch.s2,
            tc_vert=out.touch.vert, tc_la=out.touch.la,
            tc_comp=out.touch.comp,
            tc_own0=torch.where(out.touch.mask, me, BIG),
            tc_mask=out.touch.mask,
            le_eid=state.le_eid, le_u=state.le_u, le_v=state.le_v,
            le_lau=state.le_lau, le_lav=state.le_lav,
            le_mask=torch.zeros_like(state.le_mask),
        )
        ship_of = of1 | of2 | of3 | of4 | of5 | of6 | of_new
        flags = torch.cat([out.flags, (~ship_of)[:, None]], -1)
        metrics = torch.stack(
            [2 * pm.sum(-1).to(I32),
             3 * out.opens.mask.sum(-1).to(I32),
             4 * out.touch.mask.sum(-1).to(I32),
             4 * out.n_components], -1)
        return nstate, out.log_s1, out.log_s2, out.log_mask, flags, metrics

    def run_levels(self, state: EngineState, anc: torch.Tensor,
                   num_edges: int, clock: bool = True,
                   route_mates: bool = False) -> RunOut:
        """Every superstep in level order, accumulating the mate logs
        into one ``[2E + 1]`` tensor (pad slot ``2E`` takes the masked
        writes, all −1).  The mesh's mate-lane overflow flag has no
        counterpart on one device: flag 3 carries only the table lanes.
        Over a mesh each level's logs are all-gathered and scattered into
        the whole mate on every rank (the reference's eager replay), or
        with ``route_mates`` (the fused run) routed to the ranks owning
        their stubs (:meth:`_route_mates`): ``mate`` is then this rank's
        ``[m, S]`` shards, and the route's overflow clears flag 3; the
        flags and metrics are gathered, ``[n, L, 4]`` on every rank.
        A batch (``state`` ``[n·B, ·]`` rows, over a mesh this rank's
        ``[m·B, ·]``, ``anc`` ``[B, H, n]``) returns the reference's
        batched layouts: mate ``[B, 2E]`` (routed: ``[m·B, S]`` shards),
        flags and metrics ``[n, B, L, 4]``.
        The eager path clocks each level after the device drained (Phase
        1 reads a flag on the host every splice round, so the drain costs
        little), counts its engine's first run as a trace and, under
        ``timed_probe``, wraps each level in a ``level`` span; the fused
        run passes ``clock=False``, drains nothing and gets no
        ``level_s``."""
        n_stubs = 2 * num_edges
        dev = state.pk_eid.device
        batch = anc.shape[0] if anc.dim() == 3 else None
        mesh = self.mesh
        S = shard_width(num_edges, self.n)
        if mesh is not None and route_mates:
            mate = torch.full((mesh.m * (batch or 1), S + 1), -1, dtype=I32,
                              device=dev)
        else:
            mate = torch.full((batch or 1, n_stubs + 1), -1, dtype=I32,
                              device=dev)
        flags, metrics = [], []
        marks = [drained_clock(dev)] if clock else []
        for lvl in range(self.n_levels):
            probe = (self.trace.span("level", level=lvl, edges=num_edges)
                     if clock and self.timed_probe
                     else contextlib.nullcontext())
            with probe, capture.scope("level"):
                if clock and not self._stepped:
                    self._stepped = True
                    self._traced("superstep")
                state, s1, s2, lm, fl, mt = self.superstep(lvl, anc, state)
                if mesh is None:
                    _log_mates(mate, s1, s2, lm, n_stubs)
                elif route_mates:
                    fl[:, 3] &= ~self._route_mates(mate, s1, s2, lm, S)
                else:
                    _log_mates(mate, *(mesh.fetch(x) for x in (s1, s2, lm)),
                               n_stubs)
                flags.append(fl)
                metrics.append(mt)
                if clock:
                    marks.append(drained_clock(dev))
        flags, metrics = (torch.stack(x, dim=1) for x in (flags, metrics))
        if batch is not None:
            flags, metrics = (x.view(-1, batch, *x.shape[1:])
                              for x in (flags, metrics))
        if mesh is not None:
            flags, metrics = mesh.fetch(flags), mesh.fetch(metrics)
        level_s = tuple(b - a for a, b in zip(marks, marks[1:]))
        if mesh is not None and route_mates:
            return RunOut(mate[:, :S].contiguous(), flags, metrics, level_s)
        return RunOut(mate=mate[:, :n_stubs] if batch else mate[0, :n_stubs],
                      flags=flags, metrics=metrics, level_s=level_s)

    def _route_mates(self, mate_sh: torch.Tensor, s1: torch.Tensor,
                     s2: torch.Tensor, lm: torch.Tensor, S: int
                     ) -> torch.Tensor:
        """The fused run's mate route across the mesh (the reference's
        ``make_fused`` body): both directions of every logged pair,
        routed by :func:`_exchange` to the rank owning the stub's shard
        (``ws // S``), lane ``mate_ship_cap or 2·pair_cap()``, then
        scattered into this rank's ``[m, S + 1]`` shards (a batch's ``[m·B,
        S + 1]``, each graph's writes into its own rows; masked entries
        into each row's pad slot ``S``, all −1), one source partition at
        a time to bound the offsets' memory.  Within a level the pairs
        are disjoint, and later levels overwrite earlier ones.  Returns
        the per-source-row lane overflow ``[m·B]``."""
        n, c, mesh = self.n, self.caps, self.mesh
        rows, m = mate_sh.shape[0], mesh.m
        batch = rows // m
        ws = torch.cat([s1, s2], -1)
        wv = torch.cat([s2, s1], -1)
        wm = torch.cat([lm, lm], -1)
        (r_s, r_v), r_m, of_m = _exchange(
            torch.where(wm, ws // S, n), wm, (ws, wv), n,
            c.mate_ship_cap or 2 * c.pair_cap(), "mate", mesh)
        del ws, wv, wm
        row = torch.arange(rows, device=mate_sh.device)[:, None]
        lo = (mesh.part_ids(batch=batch)[:, None] * S).to(torch.int64)
        flat = mate_sh.view(-1)

        def received(x, src):
            # source partition src's lanes [B, m, lane] as rows [m·B, lane]
            return x.view(n, batch, m, -1)[src].transpose(0, 1).reshape(
                rows, -1)

        for src in range(n):
            got, at = received(r_m, src), received(r_s, src)
            at = torch.where(got, at - lo, S) + row * (S + 1)
            flat[at.view(-1)] = torch.where(got, received(r_v, src),
                                            -1).view(-1)
        return of_m

    # ------------------------------------------------------------------
    # the fused whole run
    # ------------------------------------------------------------------
    def whole_run(self, state: EngineState, anc: torch.Tensor,
                  sv: torch.Tensor, num_edges: int) -> FusedOut:
        """The fused run's body (the reference's ``one_graph``): the
        levels unrolled over the static ``n_levels``, each level's logs
        scattered into one mate, then Phase 3 in the engine's mode.
        ``sv`` is the stub-vertex map, ``[2E]`` for the replicated Phase
        3 or :func:`stub_shards` ``[n, S]`` for the sharded one.  A batch
        of B graphs (the reference's ``vmap(one_graph)``) has the batch
        axis after the partition axis: ``state`` ``[n, B, ·]``, ``anc``
        ``[B, H, n]``, ``sv`` ``[B, 2E]`` or ``[n, B, S]``; every kernel
        launch then covers the whole batch, and the outputs are the
        reference's batched :class:`FusedOut`.  Reads nothing on the host
        (apart from the eager splice loops' flags when it runs
        uncaptured), so a CUDA graph can hold it."""
        c, n_stubs = self.caps, 2 * num_edges
        batch = anc.shape[0] if anc.dim() == 3 else None
        if batch is not None:
            state = EngineState(*(x.flatten(0, 1) for x in state))
        if self.mesh is not None:
            return self._whole_run_mesh(state, anc, sv, num_edges, batch)
        mate, flags, metrics, _ = self.run_levels(state, anc, num_edges,
                                                  clock=False)
        if not self.sharded_phase3:
            capture.note("all_gather")    # the mate shards': here a view
            circuit, mate2, ok = phase3_device(
                mate, sv, splice_rounds=c.phase3_rounds)
            return FusedOut(circuit, mate2, flags, metrics, ok)
        S = shard_width(num_edges, self.n)
        res = phase3_sharded(stub_shards(mate, self.n, -1).view(-1, S),
                             sv.view(-1, S), n_stubs,
                             c.p3v_cap or num_edges,
                             splice_rounds=c.phase3_rounds,
                             gather_circuit=self.gather_circuit,
                             batch=batch)
        if self.gather_circuit:
            return FusedOut(*res[:2], flags, metrics, res[2])
        mate_sh, dist_sh, reach_sh, ok = res
        packed = unshard(torch.stack([mate_sh, dist_sh, reach_sh], -1),
                         batch)
        return FusedOut(packed, unshard(mate_sh, batch)[..., :n_stubs],
                        flags, metrics, ok)

    def _whole_run_mesh(self, state: EngineState, anc: torch.Tensor,
                        sv: torch.Tensor, num_edges: int,
                        batch: Optional[int]) -> FusedOut:
        """:meth:`whole_run` across the mesh: the levels with the mate
        route, then Phase 3 on this rank's ``[m, S]`` mate shards (a
        batch's ``[m·B, S]`` rows) — replicated: the shards all-gathered
        and K1/K2 run on every rank (``sv`` whole), sharded:
        ``phase3_sharded`` over the mesh (``sv`` this rank's shards).
        Every output is whole on every rank, a batch's in the reference's
        batched layouts."""
        c, n_stubs, mesh = self.caps, 2 * num_edges, self.mesh
        mate_sh, flags, metrics, _ = self.run_levels(
            state, anc, num_edges, clock=False, route_mates=True)
        if not self.sharded_phase3:
            capture.note("all_gather")
            mate = unshard(mesh.all_gather(mate_sh), batch)[..., :n_stubs]
            circuit, mate2, ok = phase3_device(
                mate.contiguous(), sv, splice_rounds=c.phase3_rounds)
            return FusedOut(circuit, mate2, flags, metrics, ok)
        res = phase3_sharded(mate_sh, sv.reshape(mate_sh.shape), n_stubs,
                             c.p3v_cap or num_edges,
                             splice_rounds=c.phase3_rounds,
                             gather_circuit=self.gather_circuit,
                             batch=batch, mesh=mesh)
        if self.gather_circuit:
            return FusedOut(*res[:2], flags, metrics, res[2])
        mate_sh, dist_sh, reach_sh, ok = res
        packed = unshard(mesh.fetch(torch.stack([mate_sh, dist_sh,
                                                 reach_sh], -1)), batch)
        return FusedOut(packed, packed[..., :n_stubs, 0].contiguous(),
                        flags, metrics, ok)

    def phase3_sv(self, sv: torch.Tensor) -> torch.Tensor:
        """The stub-vertex map as Phase 3 reads it: whole for the
        replicated Phase 3, :func:`stub_shards` ``[n, S]`` for the sharded
        one, of which a mesh's rank reads its rows."""
        if not self.sharded_phase3:
            return sv
        shards = stub_shards(sv, self.n, 0)
        if self.mesh is None:
            return shards
        return shards[self.mesh.rows].contiguous()

    def fused_program(self, num_edges: int,
                      batch: Optional[int] = None) -> "FusedRun":
        """Get or create the bucket's :class:`FusedRun` for ``(num_edges,
        batch)`` without running it (the reference's ``fused_program``):
        its first run records.  ``batch=None`` is the one-graph program;
        ``batch=B`` runs B graphs of the bucket at once
        (:meth:`whole_run`), a program of its own."""
        if batch is not None:
            require_batch_fits(num_edges, batch)
        key = (int(num_edges), batch)
        run = self._fused.get(key)
        if run is None:
            run = self._fused[key] = FusedRun(self, num_edges, batch)
        return run

    def reserved_bytes(self) -> int:
        """What the card reserved for this engine's live programs."""
        return sum(run.reserved_bytes for run in self._fused.values())

    def evict_program(self, num_edges: int, batch: Optional[int]) -> int:
        """Drop the program of ``(num_edges, batch)`` and free what it
        holds (:meth:`FusedRun.retire`): at once, its pools going back to
        the card, unless a launch holds the run (a recording in another
        thread), whose fetch frees it.  Returns how many programs were
        dropped."""
        run = self._fused.pop((int(num_edges), batch), None)
        if run is None:
            return 0
        run.retire()
        return 1


class PendingRun:
    """A dispatched fused run (the reference's ``PendingRun``): enqueued,
    not yet waited for.

    It owns what its run leaves: the :class:`FusedOut` fields and the
    splice loops' round counters.  On a card they are pinned host
    buffers, filled by the run's side stream right after its replay
    (``copy_(non_blocking=True)``), so a later launch of the same
    :class:`FusedRun` may overwrite the graph's static outputs and
    counters without touching them; on the CPU they are the tensors the
    launch's uncaptured run returned.  :meth:`ready` asks the card
    without blocking (always true on the CPU); :meth:`wait` is the run's
    one device→host synchronization (a ``wait`` span) and returns the
    outputs as numpy with the run's timings, the same objects at every
    call.

    Timings: ``load_s`` (the copies into the graph's static inputs),
    ``warmup_s`` and ``capture_s`` (0.0 unless this launch recorded),
    ``run_s`` and ``fetch_s``.  On a card the device intervals come from
    CUDA events on the side stream: ``run_s`` is the replay's event time
    plus ``fetch_s``, which is the copy-out's event time plus the host
    work after the synchronization; on the CPU ``run_s`` is the
    uncaptured run's wall time plus ``fetch_s``.  ``replay_s`` keeps the
    replay's (on the CPU the run's) time alone."""

    def __init__(self, run: "FusedRun", marks: dict,
                 events: Optional[dict], recorded: bool,
                 device: torch.device, trace):
        self.batch = run.batch        # None: the one-graph program
        self._run: Optional[FusedRun] = run
        self._out: Optional[FusedOut] = None
        self._counters = None
        self._marks = marks
        self._events = events
        self.recorded = recorded      # this launch recorded the graph
        self.device = device
        self._trace = trace
        self._enqueued: Optional[Future] = None   # the launcher's task
        self._host: Optional[Tuple[FusedOut, dict]] = None
        self._rounds: Optional[List[int]] = None
        self.replay_s: Optional[float] = None

    def _own(self, out: FusedOut, counters) -> None:
        """Take the outputs and counters this run's copy-out fills."""
        self._out, self._counters = out, counters

    @property
    def marks(self) -> dict:
        """What the launch measured on the host: ``warmup_s`` and
        ``capture_s``."""
        return {k: self._marks[k] for k in ("warmup_s", "capture_s")}

    def ready(self) -> bool:
        """Non-blocking: has the run's copy-out finished?  False while
        another thread records a graph (the card cannot be asked then)."""
        if self._host is not None or self._events is None:
            return True
        if self._enqueued is not None and not self._enqueued.done():
            return False
        with capture.CARD.try_shared(self.device) as free:
            return free and self._events["done"].query()

    def wait(self) -> Tuple[FusedOut, dict]:
        """Block until the run's outputs are on the host; returns
        ``(outputs as numpy, timings)``, a batch's in the reference's
        batched layouts (circuit ``[B, E]`` or ``[B, n·S, 3]``, mate
        ``[B, 2E]``, flags and metrics ``[n, B, L, 4]``, ok ``[B]``)."""
        if self._host is not None:
            return self._host
        with self._trace.span("wait", width=self.batch or 1):
            if self._enqueued is not None:
                self._enqueued.result()       # a failed enqueue raises here
            ev = self._events
            if ev is not None:
                with capture.CARD.shared(self.device):
                    ev["done"].synchronize()
                    load_ms = ev["load0"].elapsed_time(ev["load1"])
                    replay_ms = ev["run0"].elapsed_time(ev["run1"])
                    copy_ms = ev["run1"].elapsed_time(ev["done"])
                marks = {"load_s": load_ms / 1e3, "replay_s": replay_ms / 1e3,
                         "copy_s": copy_ms / 1e3}
            else:
                marks = {**self._marks, "copy_s": 0.0}
            t0 = time.perf_counter()
            host = FusedOut(*(x.numpy() for x in self._out))
            rounds = [int(c) for c in self._counters]
            fetch_s = marks["copy_s"] + time.perf_counter() - t0
        self.replay_s = marks["replay_s"]
        self._rounds = rounds
        run = self._run
        run.fetched(rounds)
        self._host = (host, {"load_s": marks["load_s"],
                             **self.marks,
                             "run_s": marks["replay_s"] + fetch_s,
                             "fetch_s": fetch_s})
        self._run = self._out = self._counters = self._events = None
        self._enqueued = None
        if run.retired:
            run.release()       # evicted while this launch held it
        return self._host

    def rounds_run(self) -> List[int]:
        """Rounds each splice loop ran in this run, in recording order
        (waits for the run); a batch's loops ran until every graph
        converged, so each is the most any of its graphs needed."""
        self.wait()
        return list(self._rounds)


def _pinned_copy(x: torch.Tensor) -> torch.Tensor:
    """``x`` copied into a new pinned host tensor on the current stream,
    without waiting."""
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    return host


class FusedRun:
    """One bucket's whole solve, recorded once as a CUDA graph and
    replayed for every solve of the bucket (the reference's jitted
    ``make_fused`` program); with ``batch=B`` the solve of B graphs of
    the bucket at once, one program per ``(bucket, B)``.

    It holds static input buffers (the :class:`EngineState` fields, the
    ancestor table and the stub-vertex map, whole or as ``[n, S]``
    shards; a batch's with the batch axis after the partition axis), one
    ``torch.cuda.CUDAGraph``, its static :class:`FusedOut` and one side
    stream.  :meth:`launch` enqueues one solve on that
    stream and returns its :class:`PendingRun` without waiting: the
    stream first waits for the caller's stream (where the graph's tables
    were uploaded), then copies them into the inputs (device to device:
    a graph reads fixed addresses), replays, and copies the outputs and
    the round counters out into buffers the pending run owns.  One
    stream orders the launches of one run, so a launch's copies cannot
    overwrite inputs that an earlier replay still reads, nor its replay
    outputs not yet copied out; a lock keeps two threads from
    interleaving their launches.  A replay's ``cudaGraphLaunch`` holds
    its calling thread while the driver submits the graph (0.81 s of a
    3.76 s replay at scale 20 on an H100, PERF.md §6), so a replay's
    enqueue runs on one launcher thread of the run's own, in launch
    order, as JAX's runtime dispatches a call; the caller goes on at
    once.

    The first launch on a card builds the kernel libraries, warms the
    body up once eagerly on another stream (as torch's graph rules ask)
    and records it, synchronously and holding the card gate alone
    (``capture.CARD``); ``reserved_bytes`` is what the card reserved for
    the recording (``memory_reserved()`` after an ``empty_cache()``,
    read before the warm-up and after the recording; 0 on the CPU).  A
    host read inside the recorded region makes the capture raise;
    nothing catches it.  On the CPU the same body runs uncaptured on the
    inputs at each launch, synchronously.

    Every splice loop of the body (one a level in Phase 1, one in Phase
    3) is recorded as a CUDA while node with an int32 round counter
    (:class:`~repro_torch.core.capture.Loops`, kept with the graph, since
    the nodes' bodies run on its stream's memory pool);
    :meth:`rounds_run` gives the rounds of the last run fetched.

    Each recording (on the CPU: the first run) also keeps ``census``,
    the :class:`~repro_torch.core.capture.Census` of the recorded body's
    calls at the port's stand-ins for the reference's collectives and
    kernels, which the program's audit reads
    (``repro_torch.analysis.graph_audit``).  A run made for the audit
    (``audit=True``) also keeps, on a card, ``graph_census``: the node
    counts of the recorded graph (``kernels/graph_loop.py::census``),
    for which the capture keeps its ``cudaGraph_t`` and instantiates it
    after the census; the recording raises if the census cannot be
    read.  Runs the solver caches record a plain graph.  A replay pays
    nothing for either census.

    :meth:`free` waits for the side stream, then drops the graph and
    everything it holds.  An eviction (:meth:`retire`) frees the run at
    once unless a launch holds it, say a recording in another thread:
    then the fetch of that launch's pending frees it, as it does for a
    launch that began after the eviction, so a run the engine no longer
    lists never keeps its graph.

    The run refers to its engine weakly: the engine holds its runs, and
    a cycle would keep a dropped engine's graphs alive until the next
    garbage collection.
    """

    def __init__(self, engine: Engine, num_edges: int,
                 batch: Optional[int] = None, audit: bool = False):
        self.engine = weakref.proxy(engine)
        self.num_edges = int(num_edges)
        self.batch = batch
        self.audit = audit
        self.inputs: Optional[Tuple[EngineState, torch.Tensor,
                                    torch.Tensor]] = None
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self.loops: Optional[capture.Loops] = None
        self.out: Optional[FusedOut] = None
        self.stream: Optional["torch.cuda.Stream"] = None
        self._launcher: Optional[ThreadPoolExecutor] = None
        self.captures = 0
        self.reserved_bytes = 0
        self.census: Optional[capture.Census] = None
        self.graph_census: Optional[Dict[str, int]] = None
        self._ran = False         # its first (CPU) run was counted a trace
        self._rounds: Optional[List[int]] = None
        self._lock = threading.Lock()     # one launch at a time
        self.retired = False      # evicted: its pendings' fetches free it

    @property
    def device(self) -> Optional[torch.device]:
        """Where the static inputs live (None before the first launch
        and after :meth:`free`)."""
        return None if self.inputs is None else self.inputs[1].device

    def _load(self, state: EngineState, anc: torch.Tensor,
              sv: torch.Tensor) -> None:
        """Copy one graph's (a batch's stacked) uploaded tables into the
        static inputs (allocated from the first launch's)."""
        sv = self.engine.phase3_sv(sv)
        if self.inputs is None:
            self.inputs = (EngineState(*(x.clone() for x in state)),
                           anc.clone(), sv.clone())
            return
        for dst, src in zip((*self.inputs[0], *self.inputs[1:]),
                            (*state, anc, sv)):
            if dst.shape != src.shape or dst.dtype != src.dtype:
                raise ValueError(
                    f"the fused run of {self.num_edges} edges, batch "
                    f"{self.batch}, holds {tuple(dst.shape)} {dst.dtype} "
                    f"tables, got {tuple(src.shape)} {src.dtype}: not "
                    f"the same bucket")
            dst.copy_(src)

    def _capture(self) -> Tuple[float, float]:
        """Build the kernel libraries, warm the body up once, then record
        it, and set ``reserved_bytes``.  Returns (warm-up s, capture s),
        each read after the device drained."""
        from ..kernels import build

        dev = self.inputs[1].device
        build.build_all()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved(dev)
        t0 = drained_clock(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.engine.whole_run(*self.inputs, self.num_edges)
        torch.cuda.current_stream(dev).wait_stream(side)
        t1 = drained_clock(dev)
        self._record()
        t2 = drained_clock(dev)
        torch.cuda.empty_cache()
        self.reserved_bytes = torch.cuda.memory_reserved(dev) - before
        return t1 - t0, t2 - t1

    def _record(self) -> None:
        """Record the body into a new graph (a host read in it raises,
        and so does a while node that cannot be made or instantiated),
        with its census, and for an audit its graph's; a recording is a
        trace."""
        dev = self.inputs[1].device
        graph = torch.cuda.CUDAGraph(keep_graph=self.audit)
        loops = capture.Loops(dev)
        census = capture.Census()
        mesh = self.engine.mesh
        try:
            with capture.recording(graph, loops), capture.censusing(census):
                self.out = self.engine.whole_run(*self.inputs,
                                                 self.num_edges)
        except RuntimeError as e:
            if mesh is None:
                raise
            raise RuntimeError(
                f"the fused run over the partition mesh cannot be recorded "
                f"into a CUDA graph; the last collective called was "
                f"{mesh.last_call} (launch/mesh.py: NCCL records its "
                f"point-to-point kernel inside a CUDA while node only "
                f"under NCCL_GRAPH_MIXING_SUPPORT=0; ROADMAP item 9a): "
                f"{e}") from e
        if self.audit:
            self.graph_census = capture.graph_census(graph, loops, dev)
        self.graph, self.loops, self.census = graph, loops, census
        self.captures += 1
        self.engine._traced("fused", edges=self.num_edges, batch=self.batch)

    def fetched(self, rounds: List[int]) -> None:
        """Note the rounds of a run just fetched (:meth:`rounds_run`)."""
        self._rounds = list(rounds)

    def rounds_run(self) -> List[int]:
        """Rounds each splice loop ran in the last run fetched, in
        recording order: Phase 1's, one a level, then Phase 3's (a
        batch's: the most any of its graphs needed)."""
        if self._rounds is None:
            raise RuntimeError("no run of this fused program was fetched")
        return list(self._rounds)

    def launch(self, state: EngineState, anc: torch.Tensor,
               sv: torch.Tensor) -> PendingRun:
        """Enqueue the solve of one graph of the bucket (a batched run: of
        one stacked batch, :meth:`Engine.stage_batch`; on the CPU: run
        it) and return its :class:`PendingRun`.  On a card the first
        launch loads, warms up, records and enqueues the replay in this
        thread; a later one hands the enqueue to the run's launcher."""
        dev = anc.device
        with self._lock:
            if dev.type != "cuda":
                return self._launch_cpu(state, anc, sv)
            ev = {k: torch.cuda.Event(enable_timing=True)
                  for k in ("staged", "load0", "load1", "run0", "run1",
                            "done")}
            if self.graph is None:
                with capture.CARD.exclusive(dev):
                    if self.stream is None:
                        self.stream = torch.cuda.Stream(dev)
                    ev["staged"].record()
                    return self._enqueue(state, anc, sv, ev)
            with capture.CARD.shared(dev):
                ev["staged"].record()       # the upload, on this stream
            if self._launcher is None:
                # thread-contract: one worker, joined by free(); otherwise
                # it exits once this run (its only owner) is collected
                self._launcher = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="fused-launch")
            pending = PendingRun(self, {"warmup_s": 0.0, "capture_s": 0.0},
                                 ev, False, dev, self.engine.trace)
            pending._enqueued = self._launcher.submit(
                self._enqueue_shared, state, anc, sv, ev, pending)
            return pending

    def _enqueue_shared(self, state, anc, sv, ev: dict,
                        pending: PendingRun) -> None:
        """The launcher's task: :meth:`_enqueue` under the shared gate."""
        with capture.CARD.shared(anc.device):
            self._enqueue(state, anc, sv, ev, pending)

    def _enqueue(self, state: EngineState, anc: torch.Tensor,
                 sv: torch.Tensor, ev: dict,
                 pending: Optional[PendingRun] = None) -> PendingRun:
        """On the side stream, after ``ev["staged"]``: load the tables,
        record the graph first if there is none, replay, copy the
        outputs and the counters out into pinned buffers, and record
        ``ev["done"]``.  Fills ``pending`` (or a new one on a
        recording)."""
        dev, side = anc.device, self.stream
        side.wait_event(ev["staged"])
        with torch.cuda.stream(side):
            ev["load0"].record()
            self._load(state, anc, sv)
            ev["load1"].record()
        for t in (*state, anc, sv):   # the caller may drop them: the
            t.record_stream(side)     # allocator waits for this stream
        warm_s = cap_s = 0.0
        if self.graph is None:
            warm_s, cap_s = self._capture()
            pending = PendingRun(self, {"warmup_s": warm_s,
                                        "capture_s": cap_s},
                                 ev, True, dev, self.engine.trace)
        with torch.cuda.stream(side):
            ev["run0"].record()
            self.graph.replay()
            ev["run1"].record()
            out = FusedOut(*(_pinned_copy(x) for x in self.out))
            counters = _pinned_copy(torch.stack(self.loops.counters)) \
                if self.loops.counters else torch.empty(0, dtype=torch.int32)
            ev["done"].record()
        pending._own(out, counters)
        return pending

    def _launch_cpu(self, state: EngineState, anc: torch.Tensor,
                    sv: torch.Tensor) -> PendingRun:
        """Load and run the body uncaptured, now."""
        dev = anc.device
        t0 = time.perf_counter()
        self._load(state, anc, sv)
        t1 = time.perf_counter()
        census = None
        if not self._ran:
            self._ran = True
            self.engine._traced("fused", edges=self.num_edges,
                                batch=self.batch)
            census = self.census = capture.Census()
        loops = capture.Loops(dev)
        with capture.counting(loops), (
                contextlib.nullcontext() if census is None
                else capture.censusing(census)):
            out = self.engine.whole_run(*self.inputs, self.num_edges)
        self.loops, self.out = loops, out
        pending = PendingRun(self, {"load_s": t1 - t0,
                                    "replay_s": time.perf_counter() - t1,
                                    "warmup_s": 0.0, "capture_s": 0.0},
                             None, False, dev, self.engine.trace)
        pending._own(out, loops.counters)
        return pending

    def retire(self) -> bool:
        """Mark the run evicted and :meth:`release` it now unless a launch
        holds it; returns whether it was released now.  A launch holding
        it, or one that begins later, leaves a pending whose fetch
        releases it (:meth:`PendingRun.wait`)."""
        self.retired = True
        if not self._lock.acquire(blocking=False):
            return False
        self._lock.release()
        self.release()
        return True

    def release(self) -> None:
        """:meth:`free`, then give the freed pools back to the card."""
        device = self.device
        self.free()
        if device is not None and device.type == "cuda":
            with capture.CARD.shared(device):
                torch.cuda.empty_cache()

    def free(self) -> None:
        """Wait for the launcher's enqueues and the side stream, then
        drop the graph, its loops' pool, the static inputs and outputs,
        so their memory can go back to the allocator (a replay after
        this would have nothing to run).  Pending runs keep their
        outputs."""
        with self._lock:
            if self._launcher is not None:
                self._launcher.shutdown(wait=True)
                self._launcher = None
            dev = self.stream.device if self.stream is not None \
                else torch.device("cpu")
            with capture.CARD.shared(dev):
                if self.stream is not None:
                    self.stream.synchronize()
                if self.graph is not None:
                    self.graph.reset()
                self.graph = self.loops = self.out = self.inputs = None
