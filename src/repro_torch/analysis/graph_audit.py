"""Audit the fused Euler programs against the engine's published schedule
(the counterpart of ``repro/analysis/jaxpr_audit.py``; there is no jaxpr
to walk).

The engine publishes its collective schedule statically
(:func:`repro_torch.core.engine.fused_collective_budget`, the
reference's): per level, one ``all_to_all`` per shipped field per table
group; after the levels, one ``all_gather`` for the replicated Phase 3,
or the sharded Phase 3's ring schedule
(:func:`repro_torch.core.phase3.sharded_phase3_schedule`: ``2R+7``
``ppermute``, 2 ``psum``, one emission ``all_gather`` unless
``gather_circuit=False``).  On one card each collective is a stand-in (a
transpose, a roll, a row sum, a view), and a recording runs every level
and ring step where a JAX trace reads a loop body once.  So this module
records each ``(bucket, B)`` program the solver would cache, with the
census of :mod:`repro_torch.core.capture` open, and holds the calls made
at the stand-ins to the schedule times the loop lengths:

  * ``all_to_all`` = the budget's ``dynamic_all_to_all``, the budget's
    per-level count in every level, none outside the level loop, and as
    many levels as the bucket's ``n_levels``;
  * ``ppermute`` (ring loops) = the budget's, and their ``_ring`` steps
    = ``ppermute × (n − 1)`` plus one for each of the
    :data:`RETURN_RINGS` loops whose queries travel home, every step
    inside a ring loop; ``psum`` and ``all_gather`` = the budget's, no
    ``all_gather`` inside any loop;
  * K1–K4 calls (``pallas_call``, kernel or twin) = the round formulas
    of :func:`kernel_cost_model`: ``rounds`` a Phase 3 loop, times the
    ``n`` ring steps of a round when sharded;
  * the reference's donation check becomes its reason: after a launch
    the run's static inputs, the tables its graph reads, are bit-equal
    to the upload (the launch warms the body up on them before the
    recording and its replay).

On a card the recorded CUDA graph's node census
(``kernels/graph_loop.py::census``) is checked too: its K1–K4 kernel
nodes equal the expected launches, two loop-test nodes a splice loop and
one while node each, no host node and no device→host memcpy (the
copy-out runs on the side stream, after the replay).  If that census
cannot be read, the audit raises: it never reports a program ``ok``
without it.  On the CPU only the seam census is checked.

The reference's VMEM fields and checks have no counterpart (a Hopper
kernel has no resident-table gate), and its host-callback primitives
become the recording's sync-debug mode (a host read raises) and the
graph's host nodes.  :func:`program_cost_bytes` is the reference's
static byte model, the unit of ``EulerSolver(program_cache_bytes=...)``:
the solver scales it by the reserved/model ratio measured this session
to predict a bucket's first recording.

Entry points: :func:`audit_program` (one program), :func:`audit_graph`
(every width of a graph's bucket), and ``python -m
repro_torch.analysis.audit``.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

COLLECTIVES = ("all_to_all", "all_gather", "psum", "ppermute")

#: The K1–K4 wrapper of each Phase 3 doubling loop, by ``sharded``.
LOOP_KERNELS = {
    False: {"cc": "pointer_double", "rank": "pointer_double_rank"},
    True: {"cc": "pointer_double_shard", "rank": "pointer_double_rank_shard"},
}

#: The splice loops' test kernel (``csrc/graph_loop.cu``): two nodes a
#: loop in a recorded graph, the first test and the body's last node.
LOOP_TEST = "loop_condition_kernel"

#: Ring loops of the sharded Phase 3 whose queries travel home with their
#: answers, so they take all ``n`` steps (the splice's vote and label
#: readbacks, the rank's ring-min); every other ring loop stops after
#: ``n − 1``, its last rotation carrying nothing back.
RETURN_RINGS = 3

#: The reference's Phase 3 kernel block (``block=1024`` of its
#: ``phase3_device`` and ``phase3_sharded``): its table padding is part
#: of the byte model.
PHASE3_BLOCK = 1024


def census(run) -> Dict[str, int]:
    """Name → calls of one :class:`~repro_torch.core.engine.FusedRun`'s
    recording (its first run on the CPU) at the stand-ins: the
    counterpart of the reference's eqn census of a jaxpr."""
    if run.census is None:
        raise ValueError("this fused run has not recorded yet")
    return dict(run.census.counts)


# ----------------------------------------------------------------------
# static Phase 3 cost model (the reference's ``pallas_cost_model``)
# ----------------------------------------------------------------------
def _doubling_rounds(n: int) -> int:
    """Pointer-doubling rounds both loops run on an n-entry table."""
    return int(math.ceil(math.log2(max(2, n)))) + 1


def kernel_cost_model(e_cap: int, batch: Optional[int],
                      n_parts: Optional[int] = None, sharded: bool = False,
                      p3v_cap: int = 0) -> Dict[str, Any]:
    """Static kernel cost of one fused run: the fields of the reference's
    ``pallas_cost_model`` that mean something on the card, with its
    arithmetic (the replicated tables padded to :data:`PHASE3_BLOCK`,
    as its Pallas grid needed, because :func:`program_cost_bytes` is
    built on them).  Each doubling loop runs ``rounds`` rounds, one
    kernel launch a round replicated and one a ring step (``n_parts`` a
    round) sharded; ``launches`` is what a recording calls, and
    ``expected_kernel_launches`` their sum.  ``phase3_state_bytes`` is
    the per-partition Phase 3 working set (six int32 arrays of the
    table width, plus the sharded splice's vertex-record table)."""
    b = int(batch or 1)
    n_stubs = 2 * e_cap
    block = PHASE3_BLOCK
    if sharded:
        if not n_parts:
            raise ValueError("sharded cost model needs n_parts")
        from ..core.phase3 import shard_width

        width = shard_width(e_cap, n_parts)
        n_pad = width                    # shard tables are exactly S wide
        rounds = _doubling_rounds(n_parts * width)
        per_round = int(n_parts)
    else:
        n_pad = n_stubs + (-n_stubs) % block
        width = n_pad
        rounds = _doubling_rounds(n_stubs)
        per_round = 1
    loops = {}
    for name, n_tables in (("cc", 2), ("rank", 3)):
        loops[name] = {
            "n_tables": n_tables,
            "rounds": rounds,
            "kernel": LOOP_KERNELS[bool(sharded)][name],
            "launches": rounds * per_round,
            "gather_flops": int(rounds * width * n_tables * b),
        }
    state_bytes = 6 * width * 4 * b
    if sharded:
        state_bytes += 4 * (int(p3v_cap) + 1) * 4 * b
    return {
        "n_stubs": n_stubs,
        "padded": n_pad,
        "block": block,
        "sharded": bool(sharded),
        "n_parts": int(n_parts) if n_parts else None,
        "phase3_table_width": int(width),
        "phase3_state_bytes": int(state_bytes),
        "loops": loops,
        "expected_kernel_launches": sum(lp["launches"]
                                        for lp in loops.values()),
    }


def expected_kernel_launches(e_cap: int, batch: Optional[int] = None,
                             n_parts: Optional[int] = None,
                             sharded: bool = False) -> int:
    return kernel_cost_model(e_cap, batch, n_parts=n_parts,
                             sharded=sharded)["expected_kernel_launches"]


# ----------------------------------------------------------------------
# static per-program byte cost (the solver's program_cache_bytes unit)
# ----------------------------------------------------------------------

#: int32 lanes per ``EngineState`` table group (parked edges pk_* [7 +
#: mask], open paths op_* [5 + mask], touch pairs tc_* [6 + mask],
#: level-0 local edges le_* [5 + mask]); each group also carries one
#: bool mask lane.
ENGINE_STATE_LANES = {
    "park_cap": 7,
    "open_cap": 5,
    "touch_cap": 6,
    "edge_cap": 5,
}


def engine_state_bytes(caps) -> int:
    """Per-partition ``EngineState`` bytes for one bucket's caps: the
    int32 table lanes plus one bool mask lane per table group.

    >>> from repro_torch.core.engine import EngineCaps
    >>> engine_state_bytes(EngineCaps(edge_cap=0, park_cap=1, ship_cap=0,
    ...     new_cap=0, open_cap=0, touch_cap=0))      # 7 int32 + 1 bool
    29
    """
    total = 0
    for field, lanes in ENGINE_STATE_LANES.items():
        width = int(getattr(caps, field))
        total += (4 * lanes + 1) * width
    return total


def program_cost_bytes(key, batch: Optional[int] = None,
                       sharded: bool = False) -> int:
    """The reference's modelled footprint of one cached ``(bucket, B)``
    program: per-partition state tables times the batch width, plus the
    Phase 3 working set, times ``n_parts``.  ``key`` is a solver bucket
    key ``(e_cap, n_parts, n_levels, caps)``.  A recorded graph's pool
    is larger (its temporaries); the solver scales this by the ratio it
    measured (``EulerSolver._program_cost``)."""
    e_cap, n_parts, _n_levels, caps = key[0], key[1], key[2], key[3]
    b = int(batch or 1)
    cost = kernel_cost_model(
        int(e_cap), b, n_parts=int(n_parts), sharded=bool(sharded),
        p3v_cap=(getattr(caps, "p3v_cap", 0) or int(e_cap)))
    per_device = engine_state_bytes(caps) * b + cost["phase3_state_bytes"]
    return int(per_device) * int(n_parts)


# ----------------------------------------------------------------------
# the recorded graph's census
# ----------------------------------------------------------------------
def _symbol_count(gcen: Dict[str, int], symbol: str) -> int:
    """Kernel nodes of the CUDA function ``symbol`` (mangled as the
    driver names it, or plain)."""
    plain = re.compile(rf"(?<![A-Za-z0-9_]){symbol}(?![A-Za-z0-9_])")
    mangled = f"{len(symbol)}{symbol}"
    return sum(n for k, n in gcen.items() if k.startswith("kernel:")
               and (mangled in k or plain.search(k[len("kernel:"):])))


def graph_kernel_nodes(gcen: Dict[str, int]) -> Dict[str, int]:
    """K1–K4 and loop-test kernel nodes of a graph census, by wrapper
    (K1–K4) and by :data:`LOOP_TEST`."""
    names = [*LOOP_KERNELS[False].values(), *LOOP_KERNELS[True].values()]
    out = {name: _symbol_count(gcen, f"{name}_kernel") for name in names}
    out[LOOP_TEST] = _symbol_count(gcen, LOOP_TEST)
    return out


def graph_violations(gcen: Dict[str, int], cost: Dict[str, Any],
                     whiles: int) -> List[str]:
    """What a recorded graph's node census breaks: K1–K4 kernel nodes
    against the cost model's launches, two loop-test nodes and one while
    node (and its body) a splice loop, no host node, no device→host
    memcpy."""
    v: List[str] = []
    nodes = graph_kernel_nodes(gcen)
    want = {name: 0 for name in nodes if name != LOOP_TEST}
    for lp in cost["loops"].values():
        want[lp["kernel"]] = lp["launches"]
    for name, n in want.items():
        if nodes[name] != n:
            v.append(f"graph: {nodes[name]} {name} kernel node(s), cost "
                     f"model expects {n}")
    if nodes[LOOP_TEST] != 2 * whiles:
        v.append(f"graph: {nodes[LOOP_TEST]} {LOOP_TEST} node(s), expected "
                 f"2 a splice loop ({2 * whiles})")
    failed = {k: n for k, n in gcen.items()
              if k.startswith("error:") or k == "kernel:?"}
    if failed:
        v.append(f"graph: census queries failed or left kernels unnamed: "
                 f"{failed}")
    for key, n in (("conditional", whiles), ("while_body", whiles),
                   ("host", 0), ("memcpy_dtoh", 0)):
        if gcen.get(key, 0) != n:
            v.append(f"graph: {gcen.get(key, 0)} {key} node(s), expected "
                     f"{n}")
    return v


# ----------------------------------------------------------------------
# per-program audit
# ----------------------------------------------------------------------
@dataclasses.dataclass
class ProgramAudit:
    """Audit verdict for one recorded ``(bucket, width)`` fused
    program (the reference's layout: ``census`` holds the calls at the
    stand-ins, ``scans`` the loops as ``(length, body census)``: the
    level loop first, then each ring loop by its steps)."""

    e_cap: int
    n_levels: int
    n_parts: int
    batch: Optional[int]
    census: Dict[str, int]
    budget: Dict[str, Any]
    scans: List[Tuple[int, Dict[str, int]]]
    cost: Dict[str, Any]
    violations: List[str]
    graph_census: Optional[Dict[str, int]] = None   # on a card
    resident_intact: Optional[bool] = None   # the launch kept its inputs

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["ok"] = self.ok
        return d


def _example_args(eng, pg, batch: Optional[int], device: torch.device):
    """Device inputs shaped exactly like the serving path's (state
    [n,·] / anc [H,n] / sv [2E]; batched: state [n,B,·], anc [B,H,n],
    sv [B,2E])."""
    from ..core.engine import EngineState, state_from_numpy, stub_vertex

    state, anc = eng.load(pg)
    sv = stub_vertex(pg)
    if batch is not None:
        b = int(batch)
        state = EngineState(*(np.stack([x] * b, axis=1) for x in state))
        anc, sv = np.stack([anc] * b), np.stack([sv] * b)
    return state_from_numpy(state, anc, sv, device)


def audit_program(eng, pg, e_cap: int, batch: Optional[int] = None,
                  device=None) -> ProgramAudit:
    """Record one fused program and audit it against the schedule.

    ``eng`` must be a bare :class:`~repro_torch.core.engine.Engine` for
    the bucket (no solver accounting hooks: the recording is a trace).
    The program is a :class:`~repro_torch.core.engine.FusedRun` of its
    own (``audit=True``), launched once on ``device`` (default: the
    card) and freed; on a card it records a CUDA graph, on the CPU its
    first run is the recording.  Raises ``RuntimeError`` on a card when
    the graph's census cannot be read.

    ``resident_intact``: after the launch the run's static inputs, the
    tables its graph reads, still equal what was uploaded.  The launch
    warms the body up on them, then records and replays it, and a
    cached program replays on them until its next load: a body that
    writes them would make its own replay read changed tables."""
    from ..core.engine import (FusedRun, fused_collective_budget,
                               stub_shards)

    dev = torch.device("cuda" if device is None else device)
    sharded = bool(eng.sharded_phase3)
    if sharded:
        budget = fused_collective_budget(
            eng.n_levels, num_edges=e_cap, n_parts=eng.n,
            sharded_phase3=True, gather_circuit=eng.gather_circuit)
    else:
        budget = fused_collective_budget(eng.n_levels)
    state, anc, sv = _example_args(eng, pg, batch, dev)
    uploaded = (*state, anc, stub_shards(sv, eng.n, 0) if sharded else sv)
    uploaded = [t.clone() for t in uploaded]
    run = FusedRun(eng, e_cap, batch, audit=True)
    try:
        run.launch(state, anc, sv).wait()
        static = (*run.inputs[0], *run.inputs[1:])
        intact = all(torch.equal(a, b) for a, b in zip(uploaded, static))
        cen, gcen, reserved = run.census, run.graph_census, run.reserved_bytes
    finally:
        run.release()
    counts = cen.counts
    cost = kernel_cost_model(e_cap, batch, n_parts=eng.n, sharded=sharded,
                             p3v_cap=(eng.caps.p3v_cap or e_cap))
    v: List[str] = []

    def want(name: str, n: int, what: str = "schedule budgets") -> None:
        got = counts.get(name, 0)
        if got != n:
            v.append(f"{name}: recorded {got} call(s), {what} {n}")

    # every level exchanges the budget's all_to_all, inside the level
    # loop, and the loop runs the bucket's n_levels
    want("all_to_all", budget["dynamic_all_to_all"],
         "schedule budgets (per level × levels)")
    levels = [c for kind, c in cen.scopes if kind == "level"]
    if len(levels) != budget["scan_length"]:
        v.append(f"level loop ran {len(levels)} level(s), bucket n_levels "
                 f"{budget['scan_length']}")
    for i, c in enumerate(levels):
        if c.get("all_to_all", 0) != budget["all_to_all"]:
            v.append(f"level {i} has {c.get('all_to_all', 0)} all_to_all, "
                     f"budget {budget['all_to_all']}")
    outside = counts.get("all_to_all", 0) - \
        cen.inside.get("level", {}).get("all_to_all", 0)
    if outside:
        v.append(f"{outside} all_to_all outside the level loop")
    for prim in COLLECTIVES[1:]:           # all_to_all: per level, above
        want(prim, budget.get(prim, 0))
    for kind, ctr in cen.inside.items():
        if ctr.get("all_gather", 0):
            v.append(f"all_gather inside a {kind} loop (emission gathers at "
                     f"most once, after the levels)")

    # each ring loop's steps: n − 1, or n for a loop whose queries
    # travel home; every step inside a loop
    rings = budget.get("ppermute", 0)
    want("ring_step", rings * (eng.n - 1) + (RETURN_RINGS if rings else 0),
         "the ring schedule implies")
    stray = counts.get("ring_step", 0) - \
        cen.inside.get("ring", {}).get("ring_step", 0)
    if stray:
        v.append(f"{stray} ring step(s) outside a ring loop")

    want("pallas_call", cost["expected_kernel_launches"],
         "cost model expects (rounds × launches a round)")
    for lp in cost["loops"].values():
        want(f"kernel:{lp['kernel']}", lp["launches"], "cost model expects")

    whiles = counts.get("while", 0)
    graph_v = [] if gcen is None else graph_violations(gcen, cost, whiles)
    v.extend(graph_v)
    if not intact:
        v.append("a launch changed the static inputs its graph reads (its "
                 "replay after the warm-up would read changed tables)")

    scans: List[Tuple[int, Dict[str, int]]] = [
        (len(levels), dict(levels[0]) if levels else {})]
    scans += [(c.get("ring_step", 0), dict(c))
              for kind, c in cen.scopes if kind == "ring"]
    cost["round_budgets"] = {
        "splice_rounds": eng.caps.splice_rounds,
        "phase3_rounds": eng.caps.phase3_rounds,
        "while_recorded": whiles,
    }
    cost["reserved_bytes"] = int(reserved)
    return ProgramAudit(
        e_cap=e_cap, n_levels=eng.n_levels, n_parts=eng.n, batch=batch,
        census=dict(counts), budget=budget, scans=scans, cost=cost,
        violations=v, graph_census=gcen, resident_intact=intact,
    )


# ----------------------------------------------------------------------
# whole-bucket audit (what prewarm would record)
# ----------------------------------------------------------------------
def audit_graph(solver, graph, widths=None) -> Dict[str, Any]:
    """Audit every ``(bucket, width)`` program of ``graph``'s bucket.

    ``widths`` defaults to the solver's ``width_ladder``, the set
    :meth:`EulerSolver.prewarm` records.  ``"warmed"`` audits the
    adaptive program set instead: the widths with a live program
    (``solver.warmed_widths``; width 1 when there is none yet).  The
    programs are recorded on the solver's device by a bare engine for
    the bucket (the solver's caps, levels and flags, no accounting
    hooks, no trace), so auditing never perturbs ``cache_stats``.

    ``cache_budget`` prices each audited program with
    :func:`program_cost_bytes` and totals them against the solver's
    ``program_cache_bytes`` (``within_budget`` is None when no budget
    is set)."""
    from .. import obs
    from ..core.engine import Engine

    if solver.backend != "device":
        raise ValueError("audit_graph audits the device backend's fused "
                         "programs")
    pg, tree, key = solver._prepare(graph, None)
    e_cap, n_parts, n_levels, caps = key
    sharded = bool(solver.sharded_phase3)
    eng = Engine(n_parts, caps, n_levels, sharded_phase3=sharded,
                 gather_circuit=solver.gather_circuit,
                 remote_dedup=solver.remote_dedup,
                 deferred_transfer=solver.deferred_transfer,
                 trace=obs.NullTraceLog())  # audits must not perturb it
    if widths is None:
        widths = solver.width_ladder
    elif isinstance(widths, str):
        if widths != "warmed":
            raise ValueError(f"widths must be a sequence or 'warmed': "
                             f"{widths!r}")
        widths = solver.warmed_widths(key) or [1]
    dev = solver.device
    programs = []
    per_program_bytes: Dict[str, int] = {}
    total_bytes = 0
    for w in sorted({int(w) for w in widths}):
        batch = None if w == 1 else w
        p = audit_program(eng, pg, e_cap, batch=batch, device=dev)
        cost = program_cost_bytes(key, batch, sharded=sharded)
        p.cost["program_bytes"] = cost
        per_program_bytes[f"B{w}"] = cost
        total_bytes += cost
        programs.append(p)
    budget = solver.program_cache_bytes
    return {
        "torch": torch.__version__,
        "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "bucket": {
            "e_cap": e_cap, "n_parts": n_parts, "n_levels": n_levels,
            "caps": dataclasses.asdict(caps),
            "tree_height": tree.height,
            "sharded_phase3": sharded,
            "gather_circuit": bool(solver.gather_circuit),
        },
        "programs": [p.to_dict() for p in programs],
        "cache_budget": {
            "per_program_bytes": per_program_bytes,
            "total_bytes": total_bytes,
            "budget_bytes": budget,
            "program_cache_max": solver.program_cache_max,
            "within_budget": (None if budget is None
                              else total_bytes <= budget),
        },
        "ok": all(p.ok for p in programs),
        # point-in-time cut of the solver's metrics registry
        "metrics": solver.registry.snapshot(),
    }
