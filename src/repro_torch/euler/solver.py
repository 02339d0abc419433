"""`EulerSolver` — the port's entry point (mirrors
``repro/euler/solver.py``).

One solve runs the reference's device path:

  partition → pad into the pow2 bucket → merge tree → ``size_caps`` →
  ladder caps → ``Engine.load`` → upload → every superstep (mate logs
  accumulated on the device) → Phase 3 → one fetch → the reference's
  error checks → strip the bucket's dummy edges.

Two execution modes, as in the reference.  ``fused=True`` (the default)
runs everything from the supersteps through Phase 3 as one recorded
CUDA graph per bucket (:class:`~repro_torch.core.engine.FusedRun`):
the first solve of a bucket records it, later solves of the bucket copy
their tables in and replay it, and the outputs come back with one
drain.  The solver keeps one bucket's graph alive at a time: a solve in
another bucket frees it before recording its own.  ``fused=False`` is
the eager oracle: the levels and Phase 3's steps run one by one, each
clocked.  Both give the same bits.

Phase 3 is sharded over the partitions by default when ``n_parts > 1``
(the CC, splice and rank steps over ``[n, S]`` stub shards, K3/K4) and
replicated for ``n_parts = 1`` (K1/K2), as in the reference;
``sharded_phase3`` overrides either way.  ``gather_circuit=False`` (sharded
only) fetches the rank shards and emits the circuit on the host.

It runs on ``"cuda"`` unless the caller passes ``device="cpu"``; with no
card it raises instead of falling back.  The paper's two §5 heuristics
are always on, as in the reference's defaults.  Not ported yet: batching,
``solve_many``/``solve_async``, the host backend, the byte-aware program
LRU, the autotuner, the observability hooks and the
``deferred_transfer=False`` baseline.

    >>> from repro_torch.euler import solve                 # doctest: +SKIP
    >>> res = solve(graph, n_parts=8).validate()            # doctest: +SKIP
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.engine import (Engine, EngineCaps, FusedOut, FusedRun,
                           drained_clock, state_from_numpy, stub_shards,
                           stub_vertex)
from ..core.graph import Graph, PartitionedGraph, partition_graph
from ..core.phase2 import MergeTree, generate_merge_tree
from ..core.phase3 import (_cc_labels_sharded, _rank_sharded,
                           circuit_from_mate, emit_circuit_np, first_valid,
                           gather_circuit_sharded, splice_components,
                           splice_components_sharded)
from ..graphgen.partition import partition_vertices
from .bucket import (ceil_pow2, ladder_caps, ladder_levels, ladder_rounds,
                     ladder_waste, pad_graph, round_caps, strip_circuit)
from .result import EulerResult

BucketKey = Tuple[int, int, int, EngineCaps]   # (e_cap, n_parts, n_levels, caps)

# the reference solver's defaults (repro/euler/solver.py)
SLACK = 1.3                 # capacity sizing headroom for size_caps
PARTITION_SEED = 0          # seed of the built-in BFS partitioner
MIN_BUCKET_EDGES = 64       # smallest edge bucket
LADDER_WASTE_CAP = 4.0      # quantized/exact table area beyond which the
                            # cap ladder falls back to round_caps


def resolve_device(device=None) -> torch.device:
    """``None`` → ``"cuda"``.  Raises ``RuntimeError`` for a CUDA device
    when no card is present: the port never carries on on the CPU unless
    the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; repro_torch runs on the card "
            "unless the caller passes device='cpu'")
    return dev


class EulerSolver:
    """Facade over the partition-centric Euler pipeline on one device.

    ``n_parts`` partitions all live on the one device; ``device=None``
    means ``"cuda"``, and ``"cpu"`` runs the plain torch path (the tests'
    setting).  Sizing and bucketing use the reference's defaults
    (``slack=1.3``, partition seed 0, 64-edge minimum bucket, the cap,
    level and round ladders, waste cap 4), so both packages pad, size and
    solve identically.

    ``sharded_phase3=None`` shards Phase 3 over the partitions when
    ``n_parts > 1``; ``gather_circuit=False`` (sharded only) leaves the
    rank shards unreduced on the device and emits on the host;
    ``fused=True`` runs each solve as one recorded graph per bucket,
    ``fused=False`` eagerly (overridable per :meth:`solve`).  All three
    are the reference's options with its defaults.  ``captures`` counts
    the graphs this solver recorded.
    """

    def __init__(self, n_parts: int = 1, device=None,
                 sharded_phase3: Optional[bool] = None,
                 gather_circuit: bool = True, fused: bool = True):
        self.n_parts = int(n_parts)
        self.device = resolve_device(device)
        self.fused = bool(fused)
        self.captures = 0
        self._fused: Optional[Tuple[BucketKey, FusedRun]] = None
        if sharded_phase3 is None:
            sharded_phase3 = self.n_parts > 1
        self.sharded_phase3 = bool(sharded_phase3)
        self.gather_circuit = bool(gather_circuit)
        if not self.gather_circuit and not self.sharded_phase3:
            raise ValueError(
                "gather_circuit=False requires sharded_phase3 (the "
                "replicated Phase 3 always materializes the circuit)")

    def _partition(self, graph: Graph,
                   part_of_vertex: Optional[np.ndarray]) -> np.ndarray:
        if part_of_vertex is not None:
            return np.asarray(part_of_vertex, dtype=np.int64)
        if graph.num_vertices < self.n_parts:
            raise ValueError(
                f"graph has {graph.num_vertices} vertices, fewer than "
                f"n_parts={self.n_parts}; construct the solver with fewer "
                f"partitions (n_parts ≤ |V|)"
            )
        if self.n_parts == 1:
            return np.zeros(graph.num_vertices, dtype=np.int64)
        return partition_vertices(graph, self.n_parts, seed=PARTITION_SEED)

    def prepare(self, graph: Graph,
                part_of_vertex: Optional[np.ndarray] = None,
                ) -> Tuple[PartitionedGraph, MergeTree, BucketKey]:
        """Partition, pad into the bucket, plan the merge tree, size and
        quantize the caps.  Returns (padded pg, tree, bucket key)."""
        part = self._partition(graph, part_of_vertex)
        e_cap = ceil_pow2(graph.num_edges, MIN_BUCKET_EDGES)
        g_pad, part_pad = pad_graph(graph, part, e_cap)
        pg = partition_graph(g_pad, part_pad)
        if pg.num_parts != self.n_parts:
            raise ValueError(
                f"partitioner produced {pg.num_parts} non-empty parts "
                f"for n_parts={self.n_parts}; the graph is too small or "
                f"sparse for this partition count"
            )
        tree = generate_merge_tree(pg.meta)
        n_levels = ladder_levels(tree.height + 1)
        raw = Engine.size_caps(pg, slack=SLACK)
        caps = round_caps(raw)
        quant = ladder_caps(raw, e_cap, self.n_parts, slack=SLACK)
        if ladder_waste(caps, quant) <= LADDER_WASTE_CAP:
            caps = quant            # outlier shapes keep pow2 keying
        caps = ladder_rounds(caps, e_cap)
        return pg, tree, (e_cap, self.n_parts, n_levels, caps)

    def solve(self, graph: Graph,
              part_of_vertex: Optional[np.ndarray] = None,
              fused: Optional[bool] = None) -> EulerResult:
        """Find an Euler circuit of ``graph``; returns :class:`EulerResult`.

        ``fused`` overrides the solver's execution mode for this call.
        ``timings`` holds wall seconds per phase, each read after the
        device drained: ``prepare_s`` (host partition, plan, caps, table
        build), ``upload_s``, then

          * fused: ``warmup_s`` and ``capture_s`` (the eager warm-up and
            the recording, both 0.0 on a replay), ``run_s`` (replay
            through fetch) and its ``fetch_s``;
          * eager: ``supersteps_s`` and each level's ``superstep_<L>_s``,
            ``phase3_s``, ``fetch_s``.  ``phase3_s`` splits into
            ``splice_s`` (CC labels included) and ``emit_s`` on the
            replicated path, and into ``cc_s``, ``splice_s``, ``rank_s``
            and ``emit_s`` on the sharded one, where ``emit_s`` is the
            gather and emission, or under ``gather_circuit=False`` only
            the packing of the rank shards.  The Phase 3 functions' steps
            run one by one to clock each;

        and ``total_s``.  Under ``gather_circuit=False`` the host emission
        that follows the fetch is ``host_emit_s``.
        """
        fused = self.fused if fused is None else bool(fused)
        dev = self.device
        t0 = time.perf_counter()
        pg, tree, key = self.prepare(graph, part_of_vertex)
        e_cap, n_parts, n_levels, caps = key
        eng = Engine(n_parts, caps, n_levels,
                     sharded_phase3=self.sharded_phase3,
                     gather_circuit=self.gather_circuit)
        state_np, anc = eng.load(pg)
        t1 = drained_clock(dev)
        state, anc_t, sv = state_from_numpy(state_np, anc, stub_vertex(pg),
                                            dev)
        t2 = drained_clock(dev)
        timings = {"prepare_s": t1 - t0, "upload_s": t2 - t1}
        if fused:
            run = self._fused_run(key, eng)
            before = run.captures
            out, marks = run.run(state, anc_t, sv)
            self.captures += run.captures - before
            timings["upload_s"] += marks.pop("load_s")
            timings.update(marks)
        else:
            out = self._eager(eng, state, anc_t, sv, timings)
        return self._result(graph, tree, key, out, timings, fused, t0)

    def _fused_run(self, key: BucketKey, eng: Engine) -> FusedRun:
        """The bucket's fused run, reused for every solve of the bucket.
        At most one is alive: another bucket's is dropped, and its graph
        and memory pool freed, before the new one records."""
        if self._fused is not None and self._fused[0] == key:
            return self._fused[1]
        if self._fused is not None:
            self._fused = None
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
        run = eng.make_fused(key[0])
        self._fused = (key, run)
        return run

    def _eager(self, eng: Engine, state, anc: torch.Tensor,
               sv: torch.Tensor, timings: dict) -> FusedOut:
        """The eager oracle: the levels, then Phase 3's steps, each
        clocked into ``timings``; returns the fetched outputs."""
        dev, caps = self.device, eng.caps
        t2 = drained_clock(dev)
        run = eng.run_levels(state, anc, sv.shape[0] // 2)
        t3 = drained_clock(dev)
        if self.sharded_phase3:
            circuit, mate, ok3, marks = self._phase3_sharded(
                run.mate, sv, caps, sv.shape[0], t3)
            names = ("cc_s", "splice_s", "rank_s", "emit_s")
        else:
            valid = run.mate >= 0
            mate, ok3 = splice_components(run.mate, sv, valid,
                                          rounds=caps.phase3_rounds)
            t3b = drained_clock(dev)
            circuit = circuit_from_mate(mate, first_valid(valid))
            marks = (t3, t3b, drained_clock(dev))
            names = ("splice_s", "emit_s")
        t4 = marks[-1]
        out = FusedOut(*(x.cpu().numpy() for x in
                         (circuit, mate, run.flags, run.metrics, ok3)))
        timings.update({"supersteps_s": t3 - t2,
                        **{f"superstep_{lvl}_s": sec
                           for lvl, sec in enumerate(run.level_s)},
                        "phase3_s": t4 - t3,
                        **{k: b - a for k, a, b in
                           zip(names, marks, marks[1:])},
                        "fetch_s": time.perf_counter() - t4})
        return out

    def _result(self, graph: Graph, tree: MergeTree, key: BucketKey,
                out: FusedOut, timings: dict, fused: bool,
                t0: float) -> EulerResult:
        """The reference's checks on the fetched run (``PendingRun.wait``)
        and the result."""
        e_cap, n_levels = key[0], key[2]
        circuit, mate, flags, metrics, ok3 = out
        if not self.gather_circuit:
            # the rank triple [n·S, 3] came back still sharded; emit
            # host-side with the device path's ordering
            t = time.perf_counter()
            packed = circuit[:2 * e_cap]
            circuit = emit_circuit_np(mate >= 0, packed[:, 1], packed[:, 2])
            timings["host_emit_s"] = time.perf_counter() - t
        if not flags.all():
            raise RuntimeError(
                f"convergence/capacity flags failed: {flags.all((0, 1))}")
        if not ok3.all():
            raise RuntimeError("Phase 3 pivot splice failed to converge")
        if not (mate >= 0).all():
            raise RuntimeError(f"{(mate < 0).sum()} stubs unmated")
        circuit = circuit.astype(np.int64)
        if not (circuit >= 0).all():
            raise RuntimeError("circuit emission left gaps")
        timings["total_s"] = time.perf_counter() - t0
        return EulerResult(
            circuit=strip_circuit(circuit, graph.num_edges),
            mate=mate.astype(np.int64),
            tree=tree,
            levels=EulerResult.levels_from_metrics(
                [metrics[:, lvl] for lvl in range(n_levels)]),
            supersteps=n_levels,
            backend="device",
            fused=fused,
            device=str(self.device),
            graph=graph,
            padded_edges=e_cap - graph.num_edges,
            phase3_converged=bool(ok3),
            timings=timings,
        )

    def _phase3_sharded(self, mate: torch.Tensor, sv: torch.Tensor,
                        caps: EngineCaps, n_stubs: int, t_start: float):
        """:func:`~repro_torch.core.phase3.phase3_sharded`'s steps on the
        accumulated mate cut into shards, clocked after each.  Returns
        ``(circuit, mate, ok, clock marks from t_start)``; under
        ``gather_circuit=False`` ``circuit`` is the still-sharded rank
        triple ``[n·S, 3]`` and ``mate`` its first column cut to
        ``n_stubs``."""
        dev, n = mate.device, self.n_parts
        marks = [t_start]
        mate_sh = stub_shards(mate, n, -1)
        lab = _cc_labels_sharded(mate_sh)
        marks.append(drained_clock(dev))
        mate_sh, ok = splice_components_sharded(
            mate_sh, stub_shards(sv, n, 0), caps.p3v_cap or n_stubs // 2,
            rounds=caps.phase3_rounds, lab=lab)
        marks.append(drained_clock(dev))
        dist_sh, reach_sh = _rank_sharded(mate_sh)
        marks.append(drained_clock(dev))
        if self.gather_circuit:
            circuit, mate = gather_circuit_sharded(mate_sh, dist_sh,
                                                   reach_sh, n_stubs)
        else:
            circuit = torch.stack([mate_sh, dist_sh, reach_sh],
                                  dim=-1).reshape(-1, 3)
            mate = mate_sh.reshape(-1)[:n_stubs]
        marks.append(drained_clock(dev))
        return circuit, mate, ok, marks


def solve(graph: Graph, part_of_vertex: Optional[np.ndarray] = None,
          **opts) -> EulerResult:
    """One-shot ``EulerSolver(**opts).solve(graph)``."""
    return EulerSolver(**opts).solve(graph, part_of_vertex=part_of_vertex)
