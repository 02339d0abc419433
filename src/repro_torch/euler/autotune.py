"""The serving loop's autotuner (mirrors ``repro/euler/autotune.py``):
a compile thread, the pure ladder policy, and bounded flush accounting.

:class:`CompileService`
    One compile thread draining a priority queue.
    ``EulerSolver.prewarm_async`` queues ``(bucket, width)`` jobs here;
    a job is ``EulerSolver.prewarm`` of one width, on the card a
    program's warm-up and CUDA-graph recording.  A width counts as warm
    (``EulerSolver.warmed_widths``) as soon as its job accounts it, so
    ``MicroBatcher``, which dispatches exactly those widths, widens its
    flushes mid-session.  Unlike the reference's, the port's compile
    thread does stall serving: a recording holds the card gate alone
    (``core/capture.py::CARD``), so the serving thread's uploads,
    launches and fetches wait for it.

:class:`AutoTuner`
    An online policy over EWMA-decayed arrival and flush-size histograms
    a bucket (fed by ``MicroBatcher``).  Each rate-limited ``step()``
    snapshots them with the solver's cache state and runs the pure
    :func:`plan`, which decides

      · which ``(bucket, width)`` programs to record next (priority = the
        decayed flush mass the greedy ladder routes to that width, times
        the dispatch amortization ``(w-1)/w``),
      · which live programs to pin against LRU and byte eviction, and
        which cold ones to drop under byte pressure,
      · which bucket scales to move onto the tight cap profile
        (:data:`~repro_torch.euler.bucket.TIGHT_DIVISORS`): those whose
        measured ``bucket_waste`` is high while every observed cap need
        fits the tight floors; the rekey and the re-recording run on the
        compile thread.

:class:`FlushLog`
    Bounded dispatch-width accounting for ``MicroBatcher``.

Cross-thread state keeps the repo lint's contracts: R005 (every deep
mutation of lock-guarded attributes under ``self._lock``) and R006
(``daemon=`` and a ``thread-contract:`` comment on every thread).
"""
from __future__ import annotations

import dataclasses
import math
import queue
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from .. import obs
from .bucket import TIGHT_DIVISORS, ladder_floors

__all__ = [
    "FlushLog", "CompileTicket", "CompileService", "AutoTuner",
    "TunerParams", "TunerSnapshot", "BucketStats", "Decision",
    "ladder_decompose", "plan",
]


class FlushLog:
    """Bounded dispatch-width log for long-lived servers.

    Keeps a total histogram (``hist``: width → dispatch count, at most one
    entry per distinct width), a rolling window of the most recent
    dispatch widths (``recent``), and the timestamp of the first wide
    (B>1) dispatch — O(#widths + recent_max) memory for any session
    length.

    >>> log = FlushLog(recent_max=2, clock=lambda: 7.0)
    >>> for w in (1, 1, 4, 1):
    ...     log.observe(w)
    >>> log.hist, list(log.recent), log.total, log.first_wide_t
    ({1: 3, 4: 1}, [4, 1], 4, 7.0)
    >>> log.mean_width(), log.widths(), log.narrow_before_wide
    (1.75, [1, 4], 2)
    """

    def __init__(self, recent_max: int = 256,
                 clock: Callable[[], float] = time.perf_counter,
                 metric=None):
        self.hist: Dict[int, int] = {}
        self.total = 0           # dispatches observed
        self.requests = 0        # requests covered (sum of widths)
        self.recent: deque = deque(maxlen=int(recent_max))
        self.first_wide_t: Optional[float] = None
        self.narrow_before_wide = 0   # dispatches before the first wide one
        self.clock = clock
        # optional registry write-through (an obs.Histogram): the exact
        # per-width dict above stays the source of truth for --json
        # width_hist; the metric is what /metrics and snapshots see
        self.metric = metric

    def observe(self, width: int) -> None:
        w = int(width)
        if self.metric is not None:
            self.metric.observe(w)
        self.hist[w] = self.hist.get(w, 0) + 1
        self.total += 1
        self.requests += w
        self.recent.append(w)
        if self.first_wide_t is None:
            if w > 1:
                self.first_wide_t = self.clock()
            else:
                self.narrow_before_wide += 1

    def mean_width(self) -> float:
        return self.requests / self.total if self.total else 0.0

    def widths(self) -> List[int]:
        """Sorted distinct dispatch widths seen this session."""
        return sorted(self.hist)

    def __len__(self) -> int:
        return self.total

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"FlushLog(total={self.total}, hist={self.hist})"


# ---------------------------------------------------------------------------
# the compile thread
# ---------------------------------------------------------------------------


class CompileTicket:
    """Completion handle for one queued compile job (``error`` holds what
    the job raised, ``widths`` the widths it recorded)."""

    def __init__(self, label: str):
        self.label = label
        self.widths: List[int] = []   # widths this job newly compiled
        self.error: Optional[BaseException] = None
        self._done = threading.Event()

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        state = "done" if self.done() else "pending"
        return f"CompileTicket({self.label}, {state})"


class CompileService:
    """One compile thread and its priority queue (the reference's).

    Jobs run in ``(priority, seq)`` order: higher priority first, FIFO
    among equal priorities.  A prewarm job records exactly one
    ``(bucket, width)`` program through ``solver.prewarm(graph, [w])``,
    so ``warmed_widths`` grows a width at a time and the micro-batcher
    widens its flushes as soon as the first one is accounted.  A
    duplicate of a still-queued job returns that job's ticket; an
    already-warm width returns a finished ticket without queueing.

    With ``start=False`` the thread is not started: jobs queue up and
    run in priority order once :meth:`start` is called (the tests'
    deterministic drains).

    A job's error stays on its ticket (``ticket.error``); the thread
    goes on to the next job.  Spans ``compile_job``; metric families
    ``euler_compile_jobs{state}`` and ``euler_compile_queue_depth``.
    """

    def __init__(self, solver, start: bool = True):
        self.solver = solver
        self._q: "queue.PriorityQueue" = queue.PriorityQueue()
        self._lock = threading.Lock()
        self._seq = 0
        self._pending: Dict[object, CompileTicket] = {}
        self._busy = 0                  # queued + running jobs
        self._idle = threading.Event()  # set ⇔ _busy == 0
        self._idle.set()
        self._thread: Optional[threading.Thread] = None
        self._stopped = False
        self.prewarms = 0               # programs recorded here
        # a job's life (queued → landed or failed): spans into the
        # solver's trace log, state-labelled counters into its registry;
        # the tests' stand-in solvers fall back to the process defaults
        self._trace = getattr(solver, "trace", None) or obs.default_tracelog()
        reg = getattr(solver, "registry", None) or obs.default_registry()
        self._c_jobs = reg.counter(
            "euler_compile_jobs", "compile-service jobs by lifecycle state")
        self._g_queue = reg.gauge(
            "euler_compile_queue_depth", "compile-service pending jobs")
        if start:
            self.start()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Launch the worker thread (idempotent)."""
        with self._lock:
            if self._thread is not None or self._stopped:
                return
            # thread-contract: daemon (a job holds nothing of its own: the
            # programs it records are the solver's to free, and a job
            # abandoned at exit is queued again by the next session); the
            # serving loop never joins it — join() waits on the
            # drained-idle event instead, and stop() enqueues a sentinel
            # and then joins it at shutdown.
            t = threading.Thread(target=self._worker,
                                 name="compile-service", daemon=True)
            self._thread = t
        t.start()

    def stop(self, timeout: Optional[float] = 10.0) -> None:
        """Drain queued jobs, then stop and join the worker thread."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            self._seq += 1
            seq = self._seq
            t = self._thread
        # +inf sorts after every real job: the sentinel drains last
        self._q.put((math.inf, seq, None, None, None))
        if t is not None:
            t.join(timeout)

    def idle(self) -> bool:
        """True when no job is queued or running."""
        return self._idle.is_set()

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait until the queue is drained (not for thread exit)."""
        return self._idle.wait(timeout)

    def pending_jobs(self) -> int:
        with self._lock:
            return len(self._pending)

    # -- submission --------------------------------------------------------

    def submit(self, graph, width: int, priority: float = 0.0) -> CompileTicket:
        """Enqueue one ``(bucket(graph), width)`` recording; returns a
        ticket.

        Already-warm widths return an immediately-completed ticket;
        a duplicate of a still-queued job returns that job's ticket.
        """
        w = max(1, int(width))
        key = self.solver.bucket_of(graph)
        if w in self.solver.warmed_widths(key):
            t = CompileTicket(f"prewarm[B{w}] (warm)")
            t._done.set()
            return t
        jkey = (key, w)

        def fn():
            return self.solver.prewarm(graph, [w])

        return self._enqueue(jkey, fn, priority, f"prewarm[B{w}]")

    def submit_retune(self, graph, e_cap: int, widths: Sequence[int],
                      priority: float = 1e9) -> CompileTicket:
        """Enqueue a tighten-rekey job: purge the scale's prep memos, then
        record ``widths`` (and 1) of the (now tight) bucket, all on the
        compile thread, so the rekey's re-preps and recordings stay off
        the serving thread.  High default priority: until the tight B=1
        program is accounted, a flush of that bucket would record inline
        on the serving thread.
        """
        ws = sorted({max(1, int(w)) for w in widths} | {1})
        jkey = ("retune", int(e_cap))

        def fn():
            self.solver.rekey(e_cap)
            out: List[int] = []
            for w in ws:
                out.extend(self.solver.prewarm(graph, [w]))
            return out

        return self._enqueue(jkey, fn, priority, f"retune[{e_cap}]")

    def _enqueue(self, jkey, fn, priority: float, label: str) -> CompileTicket:
        with self._lock:
            if self._stopped:
                raise RuntimeError("compile service is stopped")
            existing = self._pending.get(jkey)
            if existing is not None:
                return existing
            ticket = CompileTicket(label)
            self._pending[jkey] = ticket
            self._seq += 1
            seq = self._seq
            self._busy += 1
            self._idle.clear()
            depth = len(self._pending)
        self._c_jobs.labels(state="queued").inc()
        self._g_queue.set(depth)
        self._q.put((-float(priority), seq, jkey, fn, ticket))
        return ticket

    # -- worker ------------------------------------------------------------

    def _worker(self) -> None:
        while True:
            _, _, jkey, fn, ticket = self._q.get()
            if fn is None:          # stop sentinel (drains last)
                break
            with self._trace.span("compile_job", label=ticket.label) as sp:
                try:
                    ticket.widths = list(fn() or [])
                except BaseException as exc:  # noqa: BLE001 - per-job
                    ticket.error = exc
                    sp.set(error=type(exc).__name__)
                sp.set(widths=list(ticket.widths),
                       state="failed" if ticket.error else "landed")
            self._c_jobs.labels(
                state="failed" if ticket.error else "landed").inc()
            with self._lock:
                self._pending.pop(jkey, None)
                self.prewarms += len(ticket.widths)
                self._busy -= 1
                if self._busy == 0:
                    self._idle.set()
                depth = len(self._pending)
            self._g_queue.set(depth)
            ticket._done.set()


# ---------------------------------------------------------------------------
# the pure ladder policy
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BucketStats:
    """EWMA-decayed observations for one bucket."""
    mass: float = 0.0                                    # arrival mass
    flushes: Dict[int, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class TunerParams:
    """Policy knobs (see :func:`plan` for how each is used)."""
    min_mass: float = 0.5        # buckets below this mass are ignored
    evict_mass: float = 0.05     # ... below this are eviction candidates
    pin_budget: int = 4          # max (bucket, width) programs pinned
    max_prewarms: int = 4        # max prewarm orders per step
    tighten_waste: float = 1.5   # min measured bucket_waste to tighten
    hi_water: float = 0.9        # byte-budget fraction that triggers evicts
    decay_tau: float = 30.0      # EWMA time constant (seconds)
    min_interval: float = 0.25   # min seconds between policy steps


@dataclasses.dataclass
class TunerSnapshot:
    """Everything :func:`plan` sees — fabricable in tests.

    Bucket keys only need ``key[0] == e_cap`` and ``key[1] == n_parts``;
    the policy never looks past the first two slots, so test fixtures can
    use plain tuples.
    """
    buckets: Dict[object, BucketStats]
    warmed: Dict[object, List[int]]          # key -> live widths (incl. 1)
    pinned: List[Tuple[object, int]]
    bytes_used: int = 0
    bytes_budget: Optional[int] = None
    max_batch: int = 8
    waste: Dict[object, float] = dataclasses.field(default_factory=dict)
    field_max: Dict[int, Dict[str, int]] = dataclasses.field(
        default_factory=dict)                # e_cap -> observed raw caps
    tightened: Set[int] = dataclasses.field(default_factory=set)
    slack: float = 1.3


@dataclasses.dataclass
class Decision:
    """One policy step's orders, applied by :class:`AutoTuner`."""
    prewarm: List[Tuple[object, int, float]] = dataclasses.field(
        default_factory=list)                # (key, width, priority)
    pin: List[Tuple[object, int]] = dataclasses.field(default_factory=list)
    unpin: List[Tuple[object, int]] = dataclasses.field(default_factory=list)
    evict: List[Tuple[object, int]] = dataclasses.field(default_factory=list)
    tighten: List[int] = dataclasses.field(default_factory=list)  # e_caps

    def empty(self) -> bool:
        return not (self.prewarm or self.pin or self.unpin or
                    self.evict or self.tighten)


def ladder_decompose(n: int, max_batch: int) -> List[int]:
    """Greedy pow2 ladder decomposition of an n-request flush — the width
    sequence ``MicroBatcher`` would dispatch if the whole ladder were warm.

    >>> ladder_decompose(5, 8)
    [4, 1]
    >>> ladder_decompose(13, 8)
    [8, 4, 1]
    >>> ladder_decompose(4, 4)
    [4]
    """
    out: List[int] = []
    n = int(n)
    w = 1
    while w * 2 <= int(max_batch):
        w *= 2
    while n > 0:
        while w > n:
            w //= 2
        out.append(w)
        n -= w
    return out


def plan(snap: TunerSnapshot, params: TunerParams = TunerParams()) -> Decision:
    """The pure ladder policy: snapshot → orders.  Deterministic (ties
    break on stable sort order), side-effect free, unit-testable from
    fabricated histograms.

    Rules:

    * **benefit** of ``(bucket, w>1)`` = EWMA flush mass the greedy ladder
      routes to width ``w``, times the dispatch amortization ``(w-1)/w``;
      the hot bucket's B=1 fallback gets a small mass-proportional benefit
      so it pins behind the wide widths.
    * **prewarm**: the highest-benefit un-warmed widths of buckets with
      mass ≥ ``min_mass``, at most ``max_prewarms`` per step, priority =
      benefit.
    * **pin**: the top ``pin_budget`` warmed programs by benefit; anything
      currently pinned but no longer in that set is unpinned.
    * **evict**: when a byte budget is set and usage exceeds
      ``hi_water × budget``, the warmed widths of buckets whose mass
      decayed below ``evict_mass`` are dropped (widest first).
    * **tighten**: a hot bucket whose measured ``bucket_waste`` is ≥
      ``tighten_waste`` while every observed raw cap need fits the tight
      floor profile is re-keyed onto :data:`TIGHT_DIVISORS` — the tight
      caps still cover every member seen, so the tightened bucket's waste
      lands under threshold on recompile.
    """
    dec = Decision()
    benefit: Dict[Tuple[object, int], float] = {}
    hot = [(key, st) for key, st in snap.buckets.items()
           if st.mass >= params.min_mass]
    for key, st in hot:
        for n, m in st.flushes.items():
            for w in ladder_decompose(n, snap.max_batch):
                if w > 1:
                    k = (key, w)
                    benefit[k] = benefit.get(k, 0.0) + m * (w - 1.0) / w
        # the hot bucket's B=1 fallback program: small benefit so it pins
        # after the wide widths but ahead of cold buckets' entries
        k1 = (key, 1)
        benefit[k1] = benefit.get(k1, 0.0) + 0.01 * st.mass
    ranked = sorted(benefit.items(), key=lambda kv: (-kv[1], -kv[0][1]))

    warmed = {key: set(ws) for key, ws in snap.warmed.items()}
    for (key, w), b in ranked:
        if len(dec.prewarm) >= params.max_prewarms:
            break
        if w > 1 and b > 0 and w not in warmed.get(key, set()):
            dec.prewarm.append((key, w, b))

    pin_set = {(key, w) for (key, w), b in ranked[:params.pin_budget]
               if b > 0 and w in warmed.get(key, set())}
    already = set(snap.pinned)
    dec.pin = sorted(pin_set - already, key=str)
    dec.unpin = sorted(already - pin_set, key=str)

    pressured = (snap.bytes_budget is not None and
                 snap.bytes_used > params.hi_water * snap.bytes_budget)
    if pressured:
        for key, st in snap.buckets.items():
            if st.mass >= params.evict_mass:
                continue
            for w in sorted(warmed.get(key, set()), reverse=True):
                if (key, w) not in pin_set:
                    dec.evict.append((key, w))

    for key, _st in hot:
        e_cap, n_parts = int(key[0]), int(key[1])
        waste = snap.waste.get(key, 0.0)
        if e_cap in snap.tightened or waste < params.tighten_waste:
            continue
        seen = snap.field_max.get(e_cap)
        if not seen:
            continue
        floors = ladder_floors(e_cap, n_parts, slack=snap.slack, tight=True)
        fields = [f for f in TIGHT_DIVISORS if seen.get(f)]
        if fields and all(seen[f] <= floors[f] for f in fields):
            dec.tighten.append(e_cap)
    return dec


# ---------------------------------------------------------------------------
# the online tuner
# ---------------------------------------------------------------------------


class AutoTuner:
    """The ladder policy, run online (the reference's).

    The serving thread feeds it (``MicroBatcher`` calls
    :meth:`observe_arrival` / :meth:`observe_flush`) and calls
    :meth:`step` once per loop iteration; ``step`` rate-limits itself
    (``params.min_interval``), EWMA-decays the histograms, snapshots the
    solver's cache state, runs :func:`plan`, and applies the orders —
    prewarm/retune jobs go to the shared :class:`CompileService`, pin /
    unpin / drop act on the solver's program LRU directly.
    """

    #: bound on tracked buckets: coldest are dropped past this
    MAX_BUCKETS = 64

    def __init__(self, solver, service: Optional[CompileService] = None,
                 max_batch: int = 8, params: TunerParams = TunerParams(),
                 clock: Callable[[], float] = time.perf_counter):
        self.solver = solver
        self.service = service if service is not None \
            else solver._ensure_compile_service()
        self.max_batch = int(max_batch)
        self.params = params
        self.clock = clock
        self._lock = threading.RLock()   # re-entered by the _*_locked helpers
        self._buckets: Dict[object, BucketStats] = {}
        self._rep: Dict[object, object] = {}   # key -> representative graph
        self._last_decay: Optional[float] = None
        self._last_step: Optional[float] = None
        self.steps = 0                 # policy evaluations
        self.last_decision: Optional[Decision] = None

    # -- observations (serving thread) ------------------------------------

    def observe_arrival(self, key, graph=None) -> None:
        with self._lock:
            st = self._buckets.get(key)
            if st is None:
                st = self._buckets[key] = BucketStats()
            st.mass += 1.0
            if graph is not None and key not in self._rep:
                self._rep[key] = graph

    def observe_flush(self, key, n: int) -> None:
        if n <= 0:
            return
        with self._lock:
            st = self._buckets.get(key)
            if st is None:
                st = self._buckets[key] = BucketStats()
            st.flushes[int(n)] = st.flushes.get(int(n), 0.0) + 1.0

    # -- policy step -------------------------------------------------------

    def step(self, force: bool = False) -> Optional[Decision]:
        """Run one rate-limited policy step; returns the applied
        :class:`Decision` (or None when skipped by the rate limit)."""
        now = self.clock()
        with self._lock:
            if not force and self._last_step is not None and \
                    now - self._last_step < self.params.min_interval:
                return None
            self._last_step = now
            self._decay_locked(now)
            snap = self._snapshot_locked()
            reps = dict(self._rep)
        trace = getattr(self.solver, "trace", None) or obs.default_tracelog()
        with trace.span("tuner_step") as sp:
            dec = plan(snap, self.params)
            self._apply(dec, reps)
            sp.set(prewarm=len(dec.prewarm), pin=len(dec.pin),
                   evict=len(dec.evict), tighten=len(dec.tighten))
        self.steps += 1
        self.last_decision = dec
        return dec

    def _decay_locked(self, now: float) -> None:
        # called with the (reentrant) lock held; re-enters for R005
        with self._lock:
            last = self._last_decay
            self._last_decay = now
            if last is None:
                return
            f = math.exp(-max(0.0, now - last) / self.params.decay_tau)
            for st in self._buckets.values():
                st.mass *= f
                for n in list(st.flushes):
                    st.flushes[n] *= f
            if len(self._buckets) > self.MAX_BUCKETS:
                keep = sorted(self._buckets.items(),
                              key=lambda kv: -kv[1].mass)[:self.MAX_BUCKETS]
                dropped = set(self._buckets) - {k for k, _ in keep}
                for k in dropped:
                    self._buckets.pop(k)
                    self._rep.pop(k, None)

    def _snapshot_locked(self) -> TunerSnapshot:
        s = self.solver
        with self._lock:
            buckets = {k: BucketStats(st.mass, dict(st.flushes))
                       for k, st in self._buckets.items()}
        return TunerSnapshot(
            buckets=buckets,
            warmed={k: s.warmed_widths(k) for k in buckets},
            pinned=s.pinned_programs(),
            bytes_used=s.cache_bytes_used(),
            bytes_budget=s.program_cache_bytes,
            max_batch=self.max_batch,
            waste=dict(s.bucket_waste),
            field_max={e: s.cap_observations(e)
                       for e in {int(k[0]) for k in buckets}},
            tightened=set(s.tightened_scales()),
            slack=s.slack,
        )

    def _apply(self, dec: Decision, reps: Dict[object, object]) -> None:
        s = self.solver
        for key, w in dec.unpin:
            s.unpin_program(key, w)
        for key, w in dec.pin:
            s.pin_program(key, w)
        for key, w in dec.evict:
            s.drop_program(key, w)
        for key, w, pr in dec.prewarm:
            g = reps.get(key)
            if g is not None:
                self.service.submit(g, w, priority=pr)
        for e_cap in dec.tighten:
            if not s.tighten(e_cap):
                continue
            key = next((k for k in reps if int(k[0]) == int(e_cap)), None)
            if key is not None:
                widths = sorted(set(s.warmed_widths(key)) | {1})
                self.service.submit_retune(reps[key], e_cap, widths)

    # -- introspection / shutdown -----------------------------------------

    def stats(self) -> dict:
        """Session counters for ``--json`` / benchmark reporting."""
        s = self.solver
        with self._lock:
            n_buckets = len(self._buckets)
        return {
            "tuner_steps": self.steps,
            "tuner_buckets": n_buckets,
            "async_prewarms": self.service.prewarms,
            "prewarm_queue": self.service.pending_jobs(),
            "pinned": len(s.pinned_programs()),
            "tightened_scales": s.tightened_scales(),
            "cache_bytes": s.cache_bytes_used(),
            "cache_bytes_budget": s.program_cache_bytes,
        }

    def close(self, timeout: Optional[float] = 10.0) -> None:
        self.service.stop(timeout)
