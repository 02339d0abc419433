"""`EulerSolver` — the port's entry point (mirrors
``repro/euler/solver.py``).

One solve runs the reference's device path with the replicated Phase 3:

  partition → pad into the pow2 bucket → merge tree → ``size_caps`` →
  ladder caps → ``Engine.load`` → upload → every superstep (mate logs
  accumulated on the device) → Phase 3 (pivot splice, list-rank
  emission) → one fetch → the reference's error checks → strip the
  bucket's dummy edges.

It runs on ``"cuda"`` unless the caller passes ``device="cpu"``; with no
card it raises instead of falling back.  The paper's two §5 heuristics
are always on, as in the reference's defaults.  Not ported yet: the
sharded Phase 3, batching, the host backend, the program LRU, the
autotuner, the observability hooks and the ``deferred_transfer=False``
baseline.

    >>> from repro_torch.euler import solve                 # doctest: +SKIP
    >>> res = solve(graph, n_parts=8).validate()            # doctest: +SKIP
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.engine import (Engine, EngineCaps, drained_clock,
                           state_from_numpy, stub_vertex)
from ..core.graph import Graph, PartitionedGraph, partition_graph
from ..core.phase2 import MergeTree, generate_merge_tree
from ..core.phase3 import circuit_from_mate, first_valid, splice_components
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
    """

    def __init__(self, n_parts: int = 1, device=None):
        self.n_parts = int(n_parts)
        self.device = resolve_device(device)

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
              part_of_vertex: Optional[np.ndarray] = None) -> EulerResult:
        """Find an Euler circuit of ``graph``; returns :class:`EulerResult`.

        ``timings`` holds wall seconds per phase, each read after the
        device drained: ``prepare_s`` (host partition, plan, caps, table
        build), ``upload_s``, ``supersteps_s`` and each level's
        ``superstep_<L>_s``, ``phase3_s`` split into ``splice_s`` and
        ``emit_s``, ``fetch_s`` and ``total_s``.  Phase 3 is
        :func:`~repro_torch.core.phase3.phase3_device`'s two steps, run
        one by one to clock each.
        """
        dev = self.device
        t0 = time.perf_counter()
        pg, tree, key = self.prepare(graph, part_of_vertex)
        e_cap, n_parts, n_levels, caps = key
        eng = Engine(n_parts, caps, n_levels)
        state_np, anc = eng.load(pg)
        t1 = drained_clock(dev)
        state, anc_t, sv = state_from_numpy(state_np, anc, stub_vertex(pg),
                                            dev)
        t2 = drained_clock(dev)
        run = eng.run_levels(state, anc_t, e_cap)
        del state
        t3 = drained_clock(dev)
        valid = run.mate >= 0
        mate, ok3 = splice_components(run.mate, sv, valid,
                                      rounds=caps.phase3_rounds)
        t3b = drained_clock(dev)
        circuit = circuit_from_mate(mate, first_valid(valid))
        t4 = drained_clock(dev)
        circuit, mate, flags, metrics, ok3 = (
            x.cpu().numpy() for x in (circuit, mate, run.flags, run.metrics,
                                      ok3))
        t5 = time.perf_counter()
        # the reference's checks on the fetched run (PendingRun.wait)
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
        return EulerResult(
            circuit=strip_circuit(circuit, graph.num_edges),
            mate=mate.astype(np.int64),
            tree=tree,
            levels=EulerResult.levels_from_metrics(
                [metrics[:, lvl] for lvl in range(n_levels)]),
            supersteps=n_levels,
            device=str(dev),
            graph=graph,
            padded_edges=e_cap - graph.num_edges,
            phase3_converged=bool(ok3),
            timings={"prepare_s": t1 - t0, "upload_s": t2 - t1,
                     "supersteps_s": t3 - t2,
                     **{f"superstep_{lvl}_s": sec
                        for lvl, sec in enumerate(run.level_s)},
                     "phase3_s": t4 - t3, "splice_s": t3b - t3,
                     "emit_s": t4 - t3b, "fetch_s": t5 - t4,
                     "total_s": time.perf_counter() - t0},
        )


def solve(graph: Graph, part_of_vertex: Optional[np.ndarray] = None,
          **opts) -> EulerResult:
    """One-shot ``EulerSolver(**opts).solve(graph)``."""
    return EulerSolver(**opts).solve(graph, part_of_vertex=part_of_vertex)
