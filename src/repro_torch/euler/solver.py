"""`EulerSolver` — the port's entry point and serving session (mirrors
``repro/euler/solver.py``).

One solve runs the reference's device path:

  partition → pad into the pow2 bucket → merge tree → ``size_caps`` →
  ladder caps → ``Engine.load`` → upload → every superstep (mate logs
  accumulated on the device) → Phase 3 → one fetch → the reference's
  error checks → strip the bucket's dummy edges.

A solver is a persistent session, as the reference's is:

  * a per-``Graph`` prep memo (partition, pad, plan, caps; a FIFO of 64,
    identity-keyed, built-in partitioner only), so a repeat solve of a
    pooled graph skips the host prep;
  * one :class:`~repro_torch.core.engine.Engine` per bucket key (a FIFO
    of 16), which keeps each loaded graph's initial state on the device
    (``device_resident=True``), so a repeat solve uploads nothing;
  * a counted LRU of programs per ``(bucket, batch)``
    (``program_cache_max``, default 32), where the port's program is the
    bucket's recorded CUDA graph; an eviction frees the graph and its
    pools before another records.  With ``program_cache_bytes`` it is
    also held to a byte budget: a miss is charged a predicted cost
    before it records (:meth:`EulerSolver._program_cost`), trued up to
    the recording's measured reserved pool after, and pinned programs
    (:meth:`EulerSolver.pin_program`) are never evicted;
  * a width ladder (``width_ladder``): :meth:`EulerSolver.prewarm`
    records a bucket's batched programs ahead of traffic, and
    :meth:`EulerSolver.warmed_widths` tells the serving loop
    (``launch/serve.py::MicroBatcher``) which widths it may dispatch;
    :meth:`EulerSolver.prewarm_async` queues them on the session's
    compile thread (``euler/autotune.py::CompileService``), which the
    autotuner drives;
  * the autotuner's feedback rung: ``_prepare`` keeps the largest raw
    cap need seen per field and bucket scale
    (:meth:`EulerSolver.cap_observations`); :meth:`EulerSolver.tighten`
    moves a scale onto the tight cap profile and
    :meth:`EulerSolver.rekey` purges its prep memos, so its graphs
    re-bucket under tighter caps (a new engine and new recordings);
  * the accounting in :class:`~repro_torch.euler.result.CacheStats` on
    every result and in ``cache_stats``, read through
    :mod:`repro_torch.obs` counters under the reference's family names
    and a ``{session="sN"}`` label, and the reference's spans.

Two execution modes, as in the reference.  ``fused=True`` (the default)
runs everything from the supersteps through Phase 3 as one recorded
CUDA graph per bucket (:class:`~repro_torch.core.engine.FusedRun`):
the first solve of a bucket records it, later solves of the bucket copy
their tables in and replay it.  A fused solve is
``solve_async(graph).result()``: :meth:`EulerSolver.solve_async` only
enqueues the replay on the run's side stream and returns a
:class:`PendingSolve`, whose ``result()`` is the one synchronization,
so the host can prepare the next graph while the card runs this one
(DESIGN.md §9).  ``fused=False`` is the eager oracle: the levels and
Phase 3's steps run one by one, each clocked after a drain.  Both give
the same bits.

Same-bucket graphs can also run together: :meth:`EulerSolver.solve_batch`
(and ``solve_batch_async``, ``solve_many(batch=B)``) runs B graphs of one
bucket as one batched program, recorded once per ``(bucket, B)``, the
batch axis after the partition axis (DESIGN.md §8); each result is
byte-identical to the graph's own solve.  A batch's program holds B
times the bucket's tables.

Phase 3 is sharded over the partitions by default when ``n_parts > 1``
(the CC, splice and rank steps over ``[n, S]`` stub shards, K3/K4) and
replicated for ``n_parts = 1`` (K1/K2), as in the reference;
``sharded_phase3`` overrides either way.  ``gather_circuit=False`` (sharded
only) fetches the rank shards and emits the circuit on the host.

It runs on ``"cuda"`` unless the caller passes ``device="cpu"``; with no
card it raises instead of falling back.  ``backend="host"`` runs the
reference's exact host BSP engine instead
(:class:`~repro_torch.core.host_engine.HostEngine`: numpy and scipy, the
paper's Int64 memory-state accounting and both §5 heuristics, one graph
at a time, no device).  Not ported yet (ROADMAP queue 1): a
multi-device mesh (item 9) and, on the device backend, the
``deferred_transfer=False`` baseline (raises; queue 3).

    >>> from repro_torch.euler import solve                 # doctest: +SKIP
    >>> res = solve(graph, n_parts=8).validate()            # doctest: +SKIP
    >>> res = solve(graph, backend="host", n_parts=8).validate()  # doctest: +SKIP
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import OrderedDict
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..analysis.graph_audit import program_cost_bytes
from ..core import capture
from ..core.engine import (Engine, EngineCaps, FusedOut, FusedRun,
                           PendingRun, drained_clock, require_batch_fits,
                           require_deferred_transfer, stub_shards)
from ..core.graph import Graph, partition_graph
from ..core.phase2 import MergeTree, generate_merge_tree
from ..core.phase3 import (_cc_labels_sharded, _rank_sharded,
                           circuit_from_mate, emit_circuit_np, first_valid,
                           gather_circuit_sharded, splice_components,
                           splice_components_sharded)
from ..graphgen.partition import partition_vertices
from .autotune import CompileService
from .bucket import (LADDER_FIELDS, ceil_pow2, ladder_caps, ladder_levels,
                     ladder_rounds, ladder_waste, pad_graph, round_caps,
                     strip_circuit)
from .result import CacheStats, EulerResult

BucketKey = Tuple[int, int, int, EngineCaps]   # (e_cap, n_parts, n_levels, caps)

# Sessions label their metric-family children in the (shared) registry,
# so per-solver counters stay apart while one scrape sees them all.
_SESSION_SEQ = itertools.count()


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


class PendingSolve:
    """An in-flight fused solve (the reference's ``PendingSolve``):
    dispatched to the device, its result not fetched yet.

    ``ready()`` polls completion without blocking; ``results()`` (one
    result a graph, in input order; ``result()`` for a one-graph solve)
    performs the run's one device→host synchronization in a ``fetch``
    span, runs the reference's checks on each graph, strips the bucket's
    padding and stamps the session's cache stats as they are at fetch
    time, byte-identical to what :meth:`EulerSolver.solve` returns.  A
    run that failed raises here, and again at every call.  The pending
    owns its run's outputs, so it can be fetched in any order, and after
    its program was evicted.  Hold one per in-flight solve, so the host
    prepares the next graph while the device runs this one (DESIGN.md
    §9)."""

    def __init__(self, solver: "EulerSolver", run: PendingRun,
                 graphs: List[Graph], trees: List[MergeTree],
                 key: BucketKey, hit: bool, t0: float, timings: dict):
        self._solver = solver
        self._run = run
        self._graphs = graphs
        self._trees = trees
        self._key = key
        self._hit = hit
        self._t0 = t0
        self._timings = timings       # prepare_s and upload_s of the stage
        self._out: Optional[List[EulerResult]] = None

    @property
    def bucket(self) -> BucketKey:
        return self._key

    def __len__(self) -> int:
        return len(self._graphs)

    def ready(self) -> bool:
        """Non-blocking: has the device run finished?"""
        return self._out is not None or self._run.ready()

    def results(self) -> List[EulerResult]:
        """Block for the device run; one result a graph, in input order.
        A batch's results each carry ``timings["batch"]`` and
        ``cache.batch``, its width."""
        if self._out is not None:
            return self._out
        solver = self._solver
        B = len(self._graphs)
        with solver.trace.span("fetch", bucket=self._key[0], width=B):
            out, fetched = self._run.wait()
            timings = dict(self._timings)
            timings["upload_s"] += fetched["load_s"]
            timings.update((k, v) for k, v in fetched.items()
                           if k != "load_s")
            if self._run.batch is None:
                members = [out]
            else:
                timings["batch"] = float(B)
                members = [FusedOut(out.circuit[b], out.mate[b],
                                    out.flags[:, b], out.metrics[:, b],
                                    out.phase3_ok[b]) for b in range(B)]
            self._out = [
                solver._result(g, tree, self._key, m, dict(timings), True,
                               self._t0, self._hit)
                for g, tree, m in zip(self._graphs, self._trees, members)]
        return self._out

    def result(self) -> EulerResult:
        """The result of a one-graph solve."""
        if len(self._graphs) != 1:
            raise ValueError("batched solve: use results()")
        return self.results()[0]


class EulerSolver:
    """Facade over the partition-centric Euler pipeline on one device,
    and a serving session over many graphs.

    ``backend="device"`` (the default) runs the engine on one device:
    ``n_parts`` partitions (default 1) all live on it; ``device=None``
    means ``"cuda"``, and ``"cpu"`` runs the plain torch path (the tests'
    setting).  ``backend="host"`` runs the reference's exact host BSP
    engine on numpy and scipy, ``n_parts`` defaulting to 4 as in the
    reference; it touches no device, so passing ``device=`` raises, and
    ``solve_async``/``solve_batch``/``solve_batch_async`` raise too (one
    graph at a time, synchronously; ``solve_many`` ignores ``batch``).
    Any other backend raises ``ValueError``.  The other options are the
    reference's, with its defaults and meanings:

    fused:              one recorded graph a bucket (default) or the
                        eager oracle; overridable per :meth:`solve`
                        (:meth:`solve_async` is always fused).  The host
                        backend has no such mode: ``solve(fused=...)``
                        raises there.
    remote_dedup:       §5a on the host backend: one side of a cut edge
                        holds it in the state accounting.  On the device
                        backend stored, and as in the reference's device
                        engine it changes nothing (every cut edge is
                        parked on one side either way).
    deferred_transfer:  §5b on the host backend, either value.  On the
                        device backend it must stay True: the reference
                        mis-sizes its ``False`` baseline (ROADMAP queue 3).
    slack:              capacity sizing headroom passed to ``size_caps``.
    partition_seed:     seed of the built-in BFS partitioner.
    min_bucket_edges:   smallest edge bucket.
    cap_ladder:         quantize the table caps onto the shared ladder
                        (``ladder_caps``) instead of a pow2 per field.
    level_ladder:       quantize the merge-tree height onto the pow2
                        ladder (``ladder_levels``).
    straggler_cap:      derive the Phase 1/Phase 3 splice round budgets
                        from the bucket (``ladder_rounds``) instead of
                        the fixed 12/64.
    ladder_waste_cap:   buckets whose quantized/exact table area exceeds
                        this keep plain ``round_caps`` keying.
    width_ladder:       batch widths :meth:`prewarm` records by default
                        (stored sorted, without repeats).
    program_cache_max:  count cap of the ``(bucket, B)`` program LRU; an
                        eviction frees the recorded graph and its pools
                        and counts in ``cache_stats.evictions``.
    program_cache_bytes: byte budget of the same LRU (None: count cap
                        only).  A program costs its recording's reserved
                        pool (``FusedRun.reserved_bytes``); a miss is
                        charged a prediction from this session's
                        recordings and the static model before it
                        records and trued up after,
                        each followed by LRU-first eviction that spares
                        pinned programs and the one being charged.
    device_resident:    keep each prepared graph's uploaded initial state
                        on the device, so repeat solves upload nothing;
                        off = a fresh upload a fused solve.
    sharded_phase3:     ``None`` = sharded for ``n_parts > 1``.
    gather_circuit:     ``False`` (sharded only) emits on the host.
    registry / trace:   the :class:`repro_torch.obs.Registry` and
                        :class:`repro_torch.obs.TraceLog` this session
                        reports into (default: the process-wide ones).
    timed_probe:        one ``level`` span a level on the eager path.

    ``captures`` counts the CUDA graphs this solver recorded.

    Threads may share a solver: the session's state changes under its
    lock, launches on one program are serialized by the program's own,
    and a recording holds the card alone (``capture.CARD``).
    """

    def __init__(self, n_parts: Optional[int] = None,
                 backend: str = "device", device=None, fused: bool = True,
                 remote_dedup: bool = True, deferred_transfer: bool = True,
                 slack: float = 1.3, partition_seed: int = 0,
                 min_bucket_edges: int = 64, cap_ladder: bool = True,
                 level_ladder: bool = True, straggler_cap: bool = True,
                 ladder_waste_cap: float = 4.0,
                 width_ladder: Sequence[int] = (1, 2, 4),
                 program_cache_max: int = 32,
                 program_cache_bytes: Optional[int] = None,
                 device_resident: bool = True,
                 sharded_phase3: Optional[bool] = None,
                 gather_circuit: bool = True,
                 registry: Optional[obs.Registry] = None,
                 trace: Optional[obs.TraceLog] = None,
                 timed_probe: bool = False):
        if backend not in ("device", "host"):
            raise ValueError(f"backend must be 'device' or 'host': {backend}")
        self.backend = backend
        if backend == "host":
            if device is not None:
                raise ValueError(
                    f"backend='host' runs on no device; got device={device!r}")
            self.device = None
        else:
            require_deferred_transfer(deferred_transfer)
            self.device = resolve_device(device)
        if n_parts is None:
            n_parts = 4 if backend == "host" else 1
        self.n_parts = int(n_parts)
        self.fused = bool(fused)
        self.remote_dedup = bool(remote_dedup)
        self.deferred_transfer = bool(deferred_transfer)
        self.slack = slack
        self.partition_seed = partition_seed
        self.min_bucket_edges = min_bucket_edges
        self.cap_ladder = cap_ladder
        self.level_ladder = level_ladder
        self.straggler_cap = straggler_cap
        self.ladder_waste_cap = float(ladder_waste_cap)
        self.width_ladder = tuple(sorted({int(w) for w in width_ladder}))
        self.program_cache_max = int(program_cache_max)
        self.program_cache_bytes = (None if program_cache_bytes is None
                                    else int(program_cache_bytes))
        self.device_resident = bool(device_resident)
        if sharded_phase3 is None:
            sharded_phase3 = self.n_parts > 1
        self.sharded_phase3 = bool(sharded_phase3)
        self.gather_circuit = bool(gather_circuit)
        if not self.gather_circuit and not self.sharded_phase3:
            raise ValueError(
                "gather_circuit=False requires sharded_phase3 (the "
                "replicated Phase 3 always materializes the circuit)")
        self.captures = 0
        # bucket → engine (its programs and resident states); a FIFO
        self._engines: dict = {}
        self._engines_max = 16
        # (bucket, B-or-None) → True for every live program, an LRU
        # bounded by program_cache_max; dropping an entry frees the
        # engine's recorded graph too
        self._programs: OrderedDict = OrderedDict()
        # id(graph) → (graph, (pg, tree, key)); a FIFO, the graph kept
        # alive by its entry so that an id is never reused while it lives
        self._prep_cache: dict = {}
        self._prep_cache_max = 64
        # measured quantized/exact table-area ratio per bucket key
        self.bucket_waste: dict = {}
        # the byte budget's books: the bytes charged to each live
        # (bucket, B) program and their total, the pinned programs, and
        # the reserved bytes measured per (e_cap, B) this session, from
        # which a miss's cost is predicted before it records
        self._program_bytes: dict = {}
        self._bytes_total = 0
        self._pinned: set = set()
        self._measured: dict = {}
        # the largest reserved/model ratio measured (None: none yet)
        self._ratio: Optional[float] = None
        # the autotuner's feedback rung: bucket scales moved onto the
        # tight cap profile, and the largest raw (pre-quantization,
        # slack-inclusive) cap need seen per field at each scale
        self._tight_scales: set = set()
        self._field_max: dict = {}
        # the compile thread of prewarm_async, made at its first use
        self._compile_service = None
        reg = registry if registry is not None else obs.default_registry()
        self.registry = reg
        self.trace = trace if trace is not None else obs.default_tracelog()
        self.timed_probe = bool(timed_probe)
        self.session = f"s{next(_SESSION_SEQ)}"
        lab = {"session": self.session}
        self._c_hits = reg.counter(
            "euler_cache_hits", "program-cache hits").labels(**lab)
        self._c_misses = reg.counter(
            "euler_cache_misses", "program-cache misses").labels(**lab)
        self._c_traces = reg.counter(
            "euler_traces", "whole-run program traces (= compiles)"
        ).labels(**lab)
        self._c_evictions = reg.counter(
            "euler_cache_evictions", "programs dropped by LRU/budget"
        ).labels(**lab)
        self._c_prewarms = reg.counter(
            "euler_cache_prewarms", "widths compiled by prewarm"
        ).labels(**lab)
        self._c_uploads = reg.counter(
            "euler_state_uploads", "host->device initial-state transfers"
        ).labels(**lab)
        self._g_bytes = reg.gauge(
            "euler_cache_bytes",
            "bytes charged to live programs (reserved pools, predicted "
            "until recorded)").labels(**lab)
        self._h_compile = reg.histogram(
            "euler_compile_seconds",
            "cold (bucket, B) program warm-up+recording seconds",
            lo_exp=-10, hi_exp=10).labels(**lab)
        # serializes the host-side session state (prep memo, engines,
        # program accounting); replays and fetches run outside it
        self._lock = threading.RLock()

    # ------------------------------------------------------------------
    @property
    def cache_stats(self) -> CacheStats:
        """Cumulative cache accounting, read through the metrics
        registry; a fresh :class:`CacheStats` snapshot each call."""
        return CacheStats(
            hits=self._c_hits.value, misses=self._c_misses.value,
            traces=self._c_traces.value, evictions=self._c_evictions.value,
            prewarms=self._c_prewarms.value,
            state_uploads=self._c_uploads.value)

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
        return partition_vertices(graph, self.n_parts,
                                  seed=self.partition_seed)

    def _prepare(self, graph: Graph, part_of_vertex: Optional[np.ndarray]):
        """Partition, pad into the bucket, plan the merge tree, size and
        quantize the caps.  Returns (padded pg, tree, bucket key).
        Memoized per ``Graph`` object (built-in partitioner only), so a
        repeat solve of a pooled graph skips the host prep and gets the
        same ``pg`` back."""
        memo = part_of_vertex is None
        with self._lock:
            if memo:
                hit = self._prep_cache.get(id(graph))
                if hit is not None and hit[0] is graph:
                    return hit[1]
            part = self._partition(graph, part_of_vertex)
            e_cap = ceil_pow2(graph.num_edges, self.min_bucket_edges)
            g_pad, part_pad = pad_graph(graph, part, e_cap)
            pg = partition_graph(g_pad, part_pad)
            if pg.num_parts != self.n_parts:
                raise ValueError(
                    f"partitioner produced {pg.num_parts} non-empty parts "
                    f"for n_parts={self.n_parts}; the graph is too small or "
                    f"sparse for this partition count"
                )
            tree = generate_merge_tree(pg.meta)
            n_levels = tree.height + 1
            if self.level_ladder:
                n_levels = ladder_levels(n_levels)
            raw = Engine.size_caps(pg, slack=self.slack)
            caps = round_caps(raw)
            # the autotuner's evidence that a scale's members all fit
            # the tight profile's floors
            seen = self._field_max.setdefault(e_cap, {})
            for f in LADDER_FIELDS:
                v = int(getattr(raw, f))
                if v > seen.get(f, 0):
                    seen[f] = v
            waste = 1.0
            if self.cap_ladder:
                quant = ladder_caps(raw, e_cap, self.n_parts,
                                    slack=self.slack,
                                    tight=e_cap in self._tight_scales)
                waste = ladder_waste(caps, quant)
                if waste <= self.ladder_waste_cap:
                    caps = quant        # outlier shapes keep pow2 keying
                else:
                    waste = 1.0
            if self.straggler_cap:
                caps = ladder_rounds(caps, e_cap)
            key: BucketKey = (e_cap, self.n_parts, n_levels, caps)
            self.bucket_waste[key] = max(self.bucket_waste.get(key, 0.0),
                                         waste)
            out = (pg, tree, key)
            if memo:
                if len(self._prep_cache) >= self._prep_cache_max:
                    self._prep_cache.pop(next(iter(self._prep_cache)))
                self._prep_cache[id(graph)] = (graph, out)
            return out

    def bucket_of(self, graph: Graph,
                  part_of_vertex: Optional[np.ndarray] = None) -> BucketKey:
        """The bucket key ``(e_cap, n_parts, n_levels, caps)`` this graph
        solves under; graphs sharing a key share one recorded graph."""
        return self._prepare(graph, part_of_vertex)[2]

    def _engine_for(self, key: BucketKey) -> Engine:
        """The (cached) engine owning this bucket's programs and resident
        states.  Evicting a bucket's engine evicts its programs first."""
        with self._lock:
            eng = self._engines.get(key)
            if eng is None:
                e_cap, n_parts, n_levels, caps = key
                eng = Engine(n_parts, caps, n_levels,
                             sharded_phase3=self.sharded_phase3,
                             gather_circuit=self.gather_circuit,
                             remote_dedup=self.remote_dedup,
                             on_trace=self._c_traces.inc,
                             on_upload=self._c_uploads.inc,
                             trace=self.trace,
                             timed_probe=self.timed_probe)
                if len(self._engines) >= self._engines_max:
                    evicted = next(iter(self._engines))
                    for p in [p for p in self._programs if p[0] == evicted]:
                        self._evict_entry(p)
                    self._engines.pop(evicted)
                self._engines[key] = eng
            return eng

    def _model_cost(self, key: BucketKey, batch: Optional[int]) -> int:
        """The reference's static cost of the program
        (``analysis/graph_audit.py::program_cost_bytes``); 0 when the
        key is not a real bucket key (unit-test fakes), as there."""
        try:
            return int(program_cost_bytes(key, batch,
                                          sharded=self.sharded_phase3))
        except (AttributeError, IndexError, TypeError, ValueError):
            return 0

    def _program_cost(self, key: BucketKey, batch: Optional[int]) -> int:
        """Predicted bytes of the ``(bucket, B)`` program about to record:
        the reserved bytes measured this session for the same ``(e_cap,
        B)``, else those of the same ``e_cap`` at the nearest other width
        scaled by B over that width, else the static model
        (:meth:`_model_cost`) times the largest reserved/model ratio a
        recording of this session measured (1 before any: the
        reference's charge).  Nothing is recorded on the CPU, so there a
        miss stays charged the model, as in the reference."""
        e_cap, width = key[0], batch or 1
        with self._lock:
            if (e_cap, width) in self._measured:
                return self._measured[(e_cap, width)]
            seen = [w for (e, w) in self._measured if e == e_cap]
            if seen:
                near = min(seen, key=lambda w: (abs(w - width), -w))
                return self._measured[(e_cap, near)] * width // near
            ratio = 1.0 if self._ratio is None else self._ratio
        return int(self._model_cost(key, batch) * ratio)

    def _charge(self, pkey, nbytes: int) -> None:
        """Set the bytes charged to a live program, and the total."""
        with self._lock:
            self._bytes_total += nbytes - self._program_bytes.get(pkey, 0)
            self._program_bytes[pkey] = nbytes
            self._g_bytes.set(self._bytes_total)

    def _true_up(self, key: BucketKey, batch: Optional[int],
                 nbytes: int) -> None:
        """After a recording: keep its measured reserved bytes and their
        ratio to the static model for later predictions, charge them in
        place of the prediction if the program is still live, and evict
        to the budget again, the new program exempt."""
        pkey = (key, batch)
        model = self._model_cost(key, batch)
        with self._lock:
            self._measured[(key[0], batch or 1)] = int(nbytes)
            if model > 0:
                self._ratio = max(self._ratio or 0.0, nbytes / model)
            if pkey in self._programs:
                self._charge(pkey, int(nbytes))
                self._evict_to_budget(keep=pkey)

    def _evict_entry(self, pkey) -> None:
        """Drop one ``(bucket, B)`` program: its LRU entry, its charged
        bytes, its pin and the engine's recorded graph, whose pools go
        back to the card."""
        with self._lock:
            self._programs.pop(pkey, None)
            self._bytes_total -= self._program_bytes.pop(pkey, 0)
            self._pinned.discard(pkey)
            k_old, b_old = pkey
            old_eng = self._engines.get(k_old)
            if old_eng is not None:
                old_eng.evict_program(k_old[0], b_old)
            self._c_evictions.inc()
            self._g_bytes.set(self._bytes_total)

    def _evict_to_budget(self, keep=None) -> None:
        """Evict least recently used programs until the count cap and
        (when set) the byte budget hold; pinned programs and ``keep``
        are exempt."""
        with self._lock:
            def victims():
                return [p for p in self._programs
                        if p != keep and p not in self._pinned]

            while len(self._programs) > self.program_cache_max:
                vs = victims()
                if not vs:
                    break
                self._evict_entry(vs[0])
            if self.program_cache_bytes is not None:
                while self._bytes_total > self.program_cache_bytes:
                    vs = victims()
                    if not vs:
                        break
                    self._evict_entry(vs[0])

    def _account(self, key: BucketKey, batch: Optional[int]) -> bool:
        """Record a solve against the ``(bucket, B)`` program LRU; returns
        whether the program was live (a hit).  A miss is charged its
        predicted cost (:meth:`_program_cost`) and evicts until the count
        cap and the byte budget hold, so the old graphs' pools are freed
        before the new one records."""
        with self._lock:
            pkey = (key, batch)
            hit = pkey in self._programs
            if hit:
                self._c_hits.inc()
                self._programs.move_to_end(pkey)
            else:
                self._c_misses.inc()
                self._programs[pkey] = True
                self._charge(pkey, self._program_cost(key, batch))
                self._evict_to_budget(keep=pkey)
            return hit

    # ------------------------------------------------------------------
    # the width ladder: batched programs recorded ahead of traffic
    # ------------------------------------------------------------------
    def warmed_widths(self, key: BucketKey) -> List[int]:
        """Batch widths with a live program for this bucket (1 = the
        one-graph program).  The serving loop's micro-batcher splits a
        partial flush over exactly these, so it never records inline."""
        with self._lock:
            return sorted({1 if b is None else b
                           for (k, b) in self._programs if k == key})

    def prewarm(self, graph: Graph,
                widths: Optional[Sequence[int]] = None) -> List[int]:
        """Record the bucket's programs for ``widths`` (default: the
        session's ``width_ladder``) ahead of arrivals, by solving
        ``graph`` through the normal path: width 1 by :meth:`solve`, a
        wider one by :meth:`solve_batch` of ``graph`` repeated (one prep,
        one table build).  One ``prewarm`` span a width newly recorded,
        each counted in ``cache_stats.prewarms``; already-live widths are
        skipped.  Returns the widths recorded here.  Runs on a background
        thread beside serving: a recording holds the card gate alone
        (``capture.CARD``), so the serving thread's CUDA work waits for
        it."""
        widths = self.width_ladder if widths is None else widths
        key = self.bucket_of(graph)
        recorded: List[int] = []
        for w in sorted({max(1, int(w)) for w in widths}):
            with self._lock:
                if (key, None if w == 1 else w) in self._programs:
                    continue
            with self.trace.span("prewarm", bucket=key[0], width=w):
                if w == 1:
                    self.solve(graph)
                else:
                    self.solve_batch([graph] * w)
            self._c_prewarms.inc()
            recorded.append(w)
        return recorded

    def prewarm_async(self, graph: Graph,
                      widths: Optional[Sequence[int]] = None,
                      priority: float = 0.0) -> list:
        """Queue :meth:`prewarm` of ``widths`` (default: the session's
        ``width_ladder``) on the session's compile thread
        (:class:`~repro_torch.euler.autotune.CompileService`), one job a
        width; returns a ``CompileTicket`` a width.  Each width lands in
        :meth:`warmed_widths` as its job starts recording, so the
        micro-batcher widens its flushes mid-session.  A recording holds
        the card gate alone, so the serving thread's CUDA work waits for
        it.  Already-live widths return finished tickets."""
        svc = self._ensure_compile_service()
        widths = self.width_ladder if widths is None else widths
        return [svc.submit(graph, w, priority=priority)
                for w in sorted({max(1, int(w)) for w in widths})]

    def _ensure_compile_service(self):
        """The session's compile service, made (and started) at its
        first use."""
        with self._lock:
            if self._compile_service is None:
                self._compile_service = CompileService(self)
            return self._compile_service

    @property
    def compile_service(self):
        """The session's compile service, or None if never used."""
        with self._lock:
            return self._compile_service

    # ------------------------------------------------------------------
    # the byte budget: usage, pins, explicit drops
    # ------------------------------------------------------------------
    def cache_bytes_used(self) -> int:
        """Bytes charged to the live programs."""
        with self._lock:
            return self._bytes_total

    def pin_program(self, key: BucketKey, width: int) -> bool:
        """Keep a live ``(bucket, width)`` program from LRU and byte
        eviction; False if no such program is live."""
        pkey = (key, None if int(width) <= 1 else int(width))
        with self._lock:
            if pkey not in self._programs:
                return False
            self._pinned.add(pkey)
            return True

    def unpin_program(self, key: BucketKey, width: int) -> bool:
        """Release a pin; returns whether it was pinned."""
        pkey = (key, None if int(width) <= 1 else int(width))
        with self._lock:
            was = pkey in self._pinned
            self._pinned.discard(pkey)
            return was

    def pinned_programs(self) -> List[Tuple[BucketKey, int]]:
        """Live pinned programs as ``(bucket, width)`` pairs."""
        with self._lock:
            return sorted(((k, 1 if b is None else b)
                           for (k, b) in self._pinned), key=str)

    def drop_program(self, key: BucketKey, width: int) -> bool:
        """Evict one ``(bucket, width)`` program now; a pinned or absent
        one is left alone (returns False)."""
        pkey = (key, None if int(width) <= 1 else int(width))
        with self._lock:
            if pkey not in self._programs or pkey in self._pinned:
                return False
            self._evict_entry(pkey)
            return True

    # ------------------------------------------------------------------
    # the ladder's feedback rung: tighten buckets whose members fit
    # ------------------------------------------------------------------
    def cap_observations(self, e_cap: int) -> dict:
        """The largest raw (pre-quantization, slack-inclusive) cap need
        seen per ladder field at this bucket scale: the autotuner's
        evidence for a tighten."""
        with self._lock:
            return dict(self._field_max.get(int(e_cap), {}))

    def tighten(self, e_cap: int) -> bool:
        """Move a bucket scale onto the tight cap profile
        (:data:`~repro_torch.euler.bucket.TIGHT_DIVISORS`) for later
        preps.  Memoized graphs keep their bucket until :meth:`rekey`
        purges the scale, so the tight bucket can record on the compile
        thread before a serving flush re-keys onto it.  False if the
        scale was tight already."""
        with self._lock:
            e = int(e_cap)
            if e in self._tight_scales:
                return False
            self._tight_scales.add(e)
            return True

    def tightened_scales(self) -> List[int]:
        """Bucket scales on the tight profile, sorted."""
        with self._lock:
            return sorted(self._tight_scales)

    def rekey(self, e_cap: int) -> int:
        """Purge the prep memos of every graph at this scale, so its next
        solve re-buckets under the scale's current profile; returns how
        many were purged.  A dispatch staged before keeps its old bucket,
        engine and program."""
        with self._lock:
            e = int(e_cap)
            stale = [gid for gid, (_g, out) in self._prep_cache.items()
                     if out[2][0] == e]
            for gid in stale:
                self._prep_cache.pop(gid)
            return len(stale)

    # ------------------------------------------------------------------
    def solve(self, graph: Graph,
              part_of_vertex: Optional[np.ndarray] = None,
              fused: Optional[bool] = None) -> EulerResult:
        """Find an Euler circuit of ``graph``; returns :class:`EulerResult`
        with the session's :class:`CacheStats` in ``cache``.

        ``fused`` overrides the solver's execution mode for this call; a
        fused solve is ``solve_async(graph).result()``.  ``timings``
        holds seconds per phase: ``prepare_s`` (host partition, plan,
        caps, table build; a memo hit on a repeat solve), ``upload_s``
        (host→device, none for a resident repeat solve, plus the fused
        run's device→device copy into its static inputs), then

          * fused: ``warmup_s`` and ``capture_s`` (the eager warm-up and
            the recording, both 0.0 on a replay), ``run_s`` (the
            replay's device time plus ``fetch_s``) and ``fetch_s`` (the
            copy-out's device time plus the host's work after the
            synchronization); the device intervals are CUDA events on
            the run's side stream, the rest the host's clock
            (:class:`~repro_torch.core.engine.PendingRun`);
          * eager: each read after the device drained: ``supersteps_s``
            and each level's ``superstep_<L>_s``, ``phase3_s``,
            ``fetch_s``.  ``phase3_s`` splits into ``splice_s`` (CC
            labels included) and ``emit_s`` on the replicated path, and
            into ``cc_s``, ``splice_s``, ``rank_s`` and ``emit_s`` on the
            sharded one, where ``emit_s`` is the gather and emission, or
            under ``gather_circuit=False`` only the packing of the rank
            shards.  The Phase 3 functions' steps run one by one to
            clock each;

        and ``total_s``.  Under ``gather_circuit=False`` the host emission
        that follows the fetch is ``host_emit_s``.

        On the host backend (``fused`` must be None) the result has
        ``backend="host"``, the engine's ``LevelStats`` (boundary counts,
        ``phase1_cost``, ``comm_longs`` and all), no bucket padding, and
        ``timings`` ``run_s`` and ``total_s``.
        """
        if self.backend == "host":
            if fused is not None:
                raise ValueError(
                    "fused= is a device-backend execution mode; the host "
                    "backend has no fused/eager distinction")
            return self._solve_host(graph, part_of_vertex,
                                    time.perf_counter())
        fused = self.fused if fused is None else bool(fused)
        if fused:
            return self.solve_async(graph, part_of_vertex).result()
        t0 = time.perf_counter()
        with self._lock:
            pg, tree, key = self._prepare(graph, part_of_vertex)
            eng = self._engine_for(key)
            hit = self._account(key, None)
        with self.trace.span("solve_eager", bucket=key[0], hit=hit):
            out, timings = self._solve_eager(eng, pg, t0)
        return self._result(graph, tree, key, out, timings, False, t0, hit)

    def solve_async(self, graph: Graph,
                    part_of_vertex: Optional[np.ndarray] = None,
                    ) -> PendingSolve:
        """Dispatch a fused solve without waiting for it; returns a
        :class:`PendingSolve` whose ``result()`` performs the run's one
        host synchronization.  Always fused, whatever ``fused`` is.  The
        host prep, the program accounting and the upload run under the
        session lock (a ``stage`` span); the launch runs outside it (a
        ``launch`` span): a replay is only enqueued, a miss warms up and
        records first.  So the host can prepare the next graph while the
        card runs this one.  Device backend only."""
        if self.backend != "device":
            raise ValueError("solve_async is a device-backend path; the "
                             "host engine runs synchronously via solve()")
        t0 = time.perf_counter()
        with self._lock:
            pg, tree, key = self._prepare(graph, part_of_vertex)
            eng = self._engine_for(key)
            hit = self._account(key, None)
            with self.trace.span("stage", resident=self.device_resident,
                                 edges=key[0]):
                staged, timings = self._staged(eng, pg, self.device_resident,
                                               t0, drain=False)
                run = eng.fused_program(key[0])
        pending = self._launch(run, staged, key, hit)
        return PendingSolve(self, pending, [graph], [tree], key, hit, t0,
                            timings)

    def _launch(self, run: FusedRun, staged, key: BucketKey,
                hit: bool) -> PendingRun:
        """Launch a staged run outside the session lock (a ``launch``
        span): a replay is only enqueued, a miss warms up and records
        first, is counted, and has its charge trued up to the bytes the
        recording reserved (:meth:`_true_up`)."""
        with self.trace.span("launch", bucket=key[0], width=run.batch or 1,
                             hit=hit):
            pending = run.launch(*staged)
        if pending.recorded:
            with self._lock:
                self.captures += 1
            self._true_up(key, run.batch, run.reserved_bytes)
        if not hit:
            marks = pending.marks
            self._h_compile.observe(marks["warmup_s"] + marks["capture_s"])
        return pending

    def solve_batch(self, graphs: Iterable[Graph],
                    fused: Optional[bool] = None) -> List[EulerResult]:
        """Solve B same-bucket graphs as one batched fused program
        (DESIGN.md §8); results in input order, each byte-identical to
        the graph's own :meth:`solve`.

        The graphs must share a bucket (:meth:`bucket_of`): mixed buckets
        raise ``ValueError`` rather than padding to the largest member.
        The program is recorded once per ``(bucket, B)`` and replayed
        after; it holds B times the bucket's tables.  An empty list
        returns ``[]``; one graph goes through :meth:`solve` (no program
        of its own).  Fused mode only: the eager oracle solves one graph
        at a time.  Device backend only."""
        graphs = list(graphs)
        if not graphs:
            return []
        if self.backend != "device":
            raise ValueError(
                "solve_batch is a device-backend path (the host reference "
                "engine solves one graph at a time); use solve_many")
        fused = self.fused if fused is None else bool(fused)
        if not fused:
            raise ValueError(
                "solve_batch requires the fused execution mode; the eager "
                "per-level oracle is single-graph by design")
        if len(graphs) == 1:
            return [self.solve(graphs[0], fused=True)]
        return self.solve_batch_async(graphs).results()

    def solve_batch_async(self, graphs: Iterable[Graph]) -> PendingSolve:
        """Dispatch B same-bucket graphs as one batched fused program
        without waiting (the async form of :meth:`solve_batch`, with its
        rules; ``results()`` gives its results).  The prep, the program
        accounting and the staging of the stacked inputs
        (:meth:`~repro_torch.core.engine.Engine.stage_batch`, which
        uploads a batch once) run under the session lock; the launch runs
        outside it, in a ``launch`` span of width B."""
        graphs = list(graphs)
        if not graphs:
            raise ValueError("empty batch")
        if self.backend != "device":
            raise ValueError("solve_batch_async is a device-backend path")
        if len(graphs) == 1:
            return self.solve_async(graphs[0])
        t0 = time.perf_counter()
        B = len(graphs)
        with self._lock:
            preps = [self._prepare(g, None) for g in graphs]
            keys = {p[2] for p in preps}
            if len(keys) > 1:
                raise ValueError(
                    f"solve_batch needs same-bucket graphs, got {len(keys)} "
                    f"distinct buckets; group with bucket_of() or use "
                    f"solve_many(batch=...)")
            key = preps[0][2]
            require_batch_fits(key[0], B)
            eng = self._engine_for(key)
            hit = self._account(key, B)
            t1 = time.perf_counter()
            with capture.CARD.shared(self.device):
                staged = eng.stage_batch([p[0] for p in preps], self.device)
            timings = {"prepare_s": t1 - t0,
                       "upload_s": time.perf_counter() - t1}
            run = eng.fused_program(key[0], B)
        pending = self._launch(run, staged, key, hit)
        return PendingSolve(self, pending, graphs, [p[1] for p in preps],
                            key, hit, t0, timings)

    def _staged(self, eng: Engine, pg, resident: bool, t0: float,
                drain: bool):
        """The table build (memoized) and the upload (or the resident
        state): ``((state, anc, sv) on the device, timings)``.  With
        ``drain`` each clock is read after the device drained (the eager
        path); without, on the host alone (the upload's copies from
        pageable memory return when they are done)."""
        dev = self.device
        with self._lock:
            ent = eng.load_cached(pg)
            t1 = time.perf_counter()
            with capture.CARD.shared(dev):
                if drain:
                    t1 = drained_clock(dev)
                staged = eng.device_state(ent, dev, resident)
                t2 = drained_clock(dev) if drain else time.perf_counter()
        return staged, {"prepare_s": t1 - t0, "upload_s": t2 - t1}

    def _solve_eager(self, eng: Engine, pg, t0: float):
        """The eager oracle on the graph's resident state (the
        reference's eager path always keeps it): the levels, then Phase
        3's steps, each clocked; returns the fetched outputs."""
        (state, anc, sv), timings = self._staged(eng, pg, True, t0,
                                                 drain=True)
        with capture.CARD.shared(self.device):
            return self._eager_run(eng, state, anc, sv, timings)

    def _eager_run(self, eng: Engine, state, anc, sv, timings: dict):
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
        return out, timings

    def solve_many(self, graphs: Iterable[Graph],
                   fused: Optional[bool] = None,
                   batch: Optional[int] = None) -> List[EulerResult]:
        """Solve a stream of graphs through the session: every
        same-bucket graph after the first replays the bucket's recorded
        graph.  With ``batch=B > 1`` the graphs are grouped by bucket and
        each group runs through :meth:`solve_batch` in full chunks of B,
        one program launch a chunk; a group's leftover graphs run one at
        a time on the bucket's one-graph program rather than recording a
        one-off width (DESIGN.md §8).  Results come back in input order,
        byte-identical to the sequential path.  The host backend ignores
        ``batch`` (it has no programs to share)."""
        graphs = list(graphs)
        if batch is None or batch <= 1 or self.backend == "host":
            return [self.solve(g, fused=fused) for g in graphs]
        by_bucket: dict = {}
        for i, g in enumerate(graphs):
            by_bucket.setdefault(self.bucket_of(g), []).append(i)
        out: List[Optional[EulerResult]] = [None] * len(graphs)
        for idxs in by_bucket.values():
            for j in range(0, len(idxs), batch):
                chunk = idxs[j:j + batch]
                if len(chunk) == batch:
                    solved = self.solve_batch([graphs[i] for i in chunk],
                                              fused=fused)
                else:
                    solved = [self.solve(graphs[i], fused=fused)
                              for i in chunk]
                for i, res in zip(chunk, solved):
                    out[i] = res
        return out

    def _solve_host(self, graph: Graph,
                    part_of_vertex: Optional[np.ndarray],
                    t0: float) -> EulerResult:
        """The reference's host solve: the session's partitioner, then
        :class:`~repro_torch.core.host_engine.HostEngine` in a
        ``solve_host`` span.  No session state changes."""
        from ..core.host_engine import HostEngine

        part = self._partition(graph, part_of_vertex)
        pg = partition_graph(graph, part)
        eng = HostEngine(pg, remote_dedup=self.remote_dedup,
                         deferred_transfer=self.deferred_transfer)
        with self.trace.span("solve_host", edges=graph.num_edges):
            res = eng._run()
        res.timings["total_s"] = time.perf_counter() - t0
        return res

    # ------------------------------------------------------------------
    def _result(self, graph: Graph, tree: MergeTree, key: BucketKey,
                out: FusedOut, timings: dict, fused: bool, t0: float,
                hit: bool) -> EulerResult:
        """The reference's checks on one graph's fetched outputs
        (``PendingRun.wait``) and its result, with the session's cache
        stats after it; a batched program's width is
        ``timings["batch"]``."""
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
            cache=dataclasses.replace(self.cache_stats, bucket=key, hit=hit,
                                      batch=int(timings.get("batch", 1))),
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


def solve_many(graphs: Iterable[Graph], batch: Optional[int] = None,
               **opts) -> List[EulerResult]:
    """One-shot session over a stream of graphs (one program cache);
    ``batch=B`` runs same-bucket graphs B at a time as one batched
    program (see :meth:`EulerSolver.solve_many`)."""
    return EulerSolver(**opts).solve_many(graphs, batch=batch)


def solve_batch(graphs: Iterable[Graph], **opts) -> List[EulerResult]:
    """One-shot ``EulerSolver(**opts).solve_batch(graphs)``: B same-bucket
    graphs as one batched program (DESIGN.md §8)."""
    return EulerSolver(**opts).solve_batch(graphs)
