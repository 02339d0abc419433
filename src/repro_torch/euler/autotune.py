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
    launches and fetches wait for it.  Over a partition mesh there is no
    thread: a recording makes collectives, which every rank must make in
    the same order, so each job runs on the serving thread when rank 0's
    order for it is carried out (``launch/serve.py::MicroBatcher``).

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

    Over a mesh it decides on rank 0 alone, and each action becomes an
    order of rank 0's stream, which every rank carries out at the same
    point of it.

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
    "FlushLog", "CompileTicket", "CompileJob", "CompileService", "AutoTuner",
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


@dataclasses.dataclass(eq=False)
class CompileJob:
    """One queued job: its body's ``kind`` and arguments
    (:meth:`CompileService.call`) on ``graph``, its dedupe key, its
    ticket, and ``seq``, the id of the request whose graph it records
    (None: no request's; over a mesh the serving loop names the graph to
    the other ranks by it)."""
    kind: str
    graph: object
    args: tuple
    jkey: object
    ticket: CompileTicket
    seq: Optional[int] = None


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
    deterministic drains), or on the calling thread (:meth:`drain`).

    A job's error stays on its ticket (``ticket.error``); the thread
    goes on to the next job.  Spans ``compile_job``; metric families
    ``euler_compile_jobs{state}`` and ``euler_compile_queue_depth``.

    Over a partition mesh (``solver.mesh``) the service has no thread
    and :meth:`start` raises: a recording's eager warm-up makes
    collectives, which would interleave with a serving dispatch's in a
    different order on each rank.  Jobs run on the calling thread, in
    the same order: rank 0 takes its next job (:meth:`next_job`),
    announces it and runs it (:meth:`run`); a follower runs the same
    body on the same request's graph when the announcement reaches it
    (:meth:`run_now`, no queue); with no serving loop every rank calls
    :meth:`drain` at the same point.  There a retune job tightens its
    scale first (:meth:`call`).  On the calling thread a job's error
    raises there instead of staying on its ticket: a rank that skipped
    a recording would leave the others' collectives waiting.
    """

    def __init__(self, solver, start: bool = True):
        self.solver = solver
        self.mesh = getattr(solver, "mesh", None)
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
        if start and self.mesh is None:
            self.start()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Launch the worker thread (idempotent).  Over a mesh it
        raises: jobs run on the serving thread there."""
        if self.mesh is not None:
            raise RuntimeError(
                "over a partition mesh the compile jobs run on the serving "
                "thread, in rank 0's order (MicroBatcher), or on every rank "
                "through drain(); there is no compile thread")
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
        """Drain queued jobs, then stop and join the worker thread.  With
        no thread (not started, or over a mesh) queued jobs stay unrun:
        :meth:`drain` runs them first."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            self._seq += 1
            seq = self._seq
            t = self._thread
        if t is not None:
            # +inf sorts after every real job: the sentinel drains last
            self._q.put((math.inf, seq, None))
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

    def submit(self, graph, width: int, priority: float = 0.0,
               seq: Optional[int] = None) -> CompileTicket:
        """Enqueue one ``(bucket(graph), width)`` recording; returns a
        ticket.  ``seq``: the id of the request whose graph this is (a
        job over a mesh is named to the other ranks by it).

        Already-warm widths return an immediately-completed ticket;
        a duplicate of a still-queued job returns that job's ticket.
        """
        w = max(1, int(width))
        key = self.solver.bucket_of(graph)
        if w in self.solver.warmed_widths(key):
            t = CompileTicket(f"prewarm[B{w}] (warm)")
            t._done.set()
            return t
        return self._enqueue(CompileJob("prewarm", graph, (w,), (key, w),
                                        self._ticket("prewarm", (w,)), seq),
                             priority)

    def submit_retune(self, graph, e_cap: int, widths: Sequence[int],
                      priority: float = 1e9,
                      seq: Optional[int] = None) -> CompileTicket:
        """Enqueue a tighten-rekey job: purge the scale's prep memos, then
        record ``widths`` (and 1) of the (now tight) bucket, all on the
        compile thread, so the rekey's re-preps and recordings stay off
        the serving thread.  High default priority: until the tight B=1
        program is accounted, a flush of that bucket would record inline
        on the serving thread.  Over a mesh the job also tightens the
        scale (:meth:`call`).  ``seq`` as for :meth:`submit`.
        """
        ws = tuple(sorted({max(1, int(w)) for w in widths} | {1}))
        args = (int(e_cap), ws)
        return self._enqueue(CompileJob("retune", graph, args,
                                        ("retune", int(e_cap)),
                                        self._ticket("retune", args), seq),
                             priority)

    @staticmethod
    def _ticket(kind: str, args: tuple) -> CompileTicket:
        return CompileTicket(f"prewarm[B{args[0]}]" if kind == "prewarm"
                             else f"retune[{args[0]}]")

    def call(self, kind: str, graph, *args) -> List[int]:
        """A job's body on ``graph``; returns the widths it recorded.
        ``"prewarm", width``: ``solver.prewarm(graph, [width])``.
        ``"retune", e_cap, widths``: purge the scale's prep memos, then
        record each width.  Over a mesh a retune tightens the scale
        first, so the tighten, the rekey and the recordings are carried
        out at one point of rank 0's order stream on every rank: no rank
        then holds a prep memo that a fresh prep would bucket otherwise
        (without a mesh ``AutoTuner`` tightens when it submits the job).
        """
        s = self.solver
        if kind == "prewarm":
            return s.prewarm(graph, [args[0]])
        e_cap, widths = args
        if self.mesh is not None:
            s.tighten(e_cap)
        s.rekey(e_cap)
        out: List[int] = []
        for w in widths:
            out.extend(s.prewarm(graph, [w]))
        return out

    def _enqueue(self, job: CompileJob, priority: float) -> CompileTicket:
        with self._lock:
            if self._stopped:
                raise RuntimeError("compile service is stopped")
            existing = self._pending.get(job.jkey)
            if existing is not None:
                return existing
            ticket = job.ticket
            self._pending[job.jkey] = ticket
            self._seq += 1
            seq = self._seq
            self._busy += 1
            self._idle.clear()
            depth = len(self._pending)
        self._c_jobs.labels(state="queued").inc()
        self._g_queue.set(depth)
        self._q.put((-float(priority), seq, job))
        return ticket

    # -- running jobs --------------------------------------------------------

    def _worker(self) -> None:
        while True:
            _, _, job = self._q.get()
            if job is None:         # stop sentinel (drains last)
                break
            self._run(job, keep_error=True)

    def _execute(self, job: CompileJob) -> Optional[BaseException]:
        """Run one job's body here (a ``compile_job`` span, its state's
        counter); returns what it raised."""
        ticket, error = job.ticket, None
        with self._trace.span("compile_job", label=ticket.label) as sp:
            try:
                ticket.widths = list(
                    self.call(job.kind, job.graph, *job.args) or [])
            except BaseException as exc:  # noqa: BLE001 - per-job
                error = exc
                sp.set(error=type(exc).__name__)
            sp.set(widths=list(ticket.widths),
                   state="failed" if error else "landed")
        self._c_jobs.labels(state="failed" if error else "landed").inc()
        return error

    def _run(self, job: CompileJob,
             keep_error: bool) -> Optional[BaseException]:
        """Run one queued job here and finish its ticket; returns what it
        raised, kept on the ticket with ``keep_error``."""
        error = self._execute(job)
        ticket = job.ticket
        if keep_error:
            ticket.error = error
        with self._lock:
            self._pending.pop(job.jkey, None)
            self.prewarms += len(ticket.widths)
            self._busy -= 1
            if self._busy == 0:
                self._idle.set()
            depth = len(self._pending)
        self._g_queue.set(depth)
        ticket._done.set()
        return error

    def next_job(self) -> Optional[CompileJob]:
        """Take the next queued job (priority, then FIFO) to run on the
        calling thread with :meth:`run`; None when none is queued.  Not
        while the compile thread runs."""
        with self._lock:
            if self._thread is not None:
                raise RuntimeError("the compile thread runs this service's "
                                   "jobs")
        try:
            return self._q.get_nowait()[2]
        except queue.Empty:
            return None

    def run(self, job: CompileJob) -> CompileTicket:
        """Run a job taken by :meth:`next_job` on the calling thread; its
        error raises here."""
        error = self._run(job, keep_error=False)
        if error is not None:
            raise error
        return job.ticket

    def run_now(self, kind: str, graph, *args) -> CompileTicket:
        """Run one job's body (:meth:`call`) on the calling thread at
        once, queueing nothing: a mesh follower's part of an order that
        rank 0 announced for the job it runs (:meth:`run`).  Its error
        raises here."""
        job = CompileJob(kind, graph, args, None, self._ticket(kind, args))
        self._c_jobs.labels(state="queued").inc()
        error = self._execute(job)
        if error is not None:
            raise error
        with self._lock:
            self.prewarms += len(job.ticket.widths)
        job.ticket._done.set()
        return job.ticket

    def run_next(self) -> Optional[CompileTicket]:
        """Run the next queued job on the calling thread; returns its
        ticket, or None when none is queued."""
        job = self.next_job()
        return None if job is None else self.run(job)

    def drain(self) -> int:
        """Run every queued job on the calling thread, in order; returns
        how many ran.  Over a mesh every rank calls it at the same point:
        the recordings make collectives."""
        n = 0
        while self.run_next() is not None:
            n += 1
        return n


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

    Over a partition mesh (``solver.mesh``) the tuner lives on rank 0
    alone (elsewhere it raises: the other ranks carry out rank 0's
    orders through ``MicroBatcher.follow``).  A ``MicroBatcher`` made
    with it becomes its :attr:`stream`: pins, unpins and drops go to
    every rank as orders of that stream, in the reference's order, and
    prewarm and retune jobs queue on the mesh's thread-less service,
    each named by the request id of its bucket's representative graph
    (``observe_arrival``'s ``seq``), so a follower records the same
    graph.  A tighten waits for its retune job there: the job tightens,
    rekeys and records as one order (:meth:`CompileService.call`).
    """

    #: bound on tracked buckets: coldest are dropped past this
    MAX_BUCKETS = 64

    def __init__(self, solver, service: Optional[CompileService] = None,
                 max_batch: int = 8, params: TunerParams = TunerParams(),
                 clock: Callable[[], float] = time.perf_counter):
        self._mesh = getattr(solver, "mesh", None)
        if self._mesh is not None and self._mesh.rank != 0:
            raise RuntimeError(
                f"the autotuner decides on rank 0 of a mesh; rank "
                f"{self._mesh.rank} carries out rank 0's orders: call "
                f"MicroBatcher.follow() there")
        self.solver = solver
        self.service = service if service is not None \
            else solver._ensure_compile_service()
        self.max_batch = int(max_batch)
        self.params = params
        self.clock = clock
        #: over a mesh, the ``MicroBatcher`` whose orders carry this
        #: tuner's actions to every rank (set when one is made with it)
        self.stream = None
        self._lock = threading.RLock()   # re-entered by the _*_locked helpers
        self._buckets: Dict[object, BucketStats] = {}
        self._rep: Dict[object, object] = {}   # key -> representative graph
        self._rep_seq: Dict[object, Optional[int]] = {}   # ... its request id
        self._last_decay: Optional[float] = None
        self._last_step: Optional[float] = None
        self.steps = 0                 # policy evaluations
        self.last_decision: Optional[Decision] = None

    # -- observations (serving thread) ------------------------------------

    def observe_arrival(self, key, graph=None,
                        seq: Optional[int] = None) -> None:
        """One arrival in bucket ``key``; the bucket's first ``graph``
        (and over a mesh its request id ``seq``) is its representative,
        which its recordings use."""
        with self._lock:
            st = self._buckets.get(key)
            if st is None:
                st = self._buckets[key] = BucketStats()
            st.mass += 1.0
            if graph is not None and key not in self._rep:
                self._rep[key] = graph
                self._rep_seq[key] = seq

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
            seqs = dict(self._rep_seq)
        trace = getattr(self.solver, "trace", None) or obs.default_tracelog()
        with trace.span("tuner_step") as sp:
            dec = plan(snap, self.params)
            self._apply(dec, reps, seqs)
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
                    self._rep_seq.pop(k, None)

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

    def _act(self, kind: str, key, width: int) -> None:
        """One ``pin``, ``unpin`` or ``drop`` of a program: the solver's
        ``<kind>_program``, or over a mesh an order of the stream,
        carried out on every rank."""
        if self._mesh is None:
            getattr(self.solver, f"{kind}_program")(key, width)
            return
        if self.stream is None:
            raise RuntimeError(
                "over a mesh the tuner's actions are orders of a "
                "MicroBatcher's stream: make one with autotuner= this tuner")
        self.stream.order(kind, key, width)

    def _apply(self, dec: Decision, reps: Dict[object, object],
               seqs: Dict[object, Optional[int]]) -> None:
        s = self.solver
        for key, w in dec.unpin:
            self._act("unpin", key, w)
        for key, w in dec.pin:
            self._act("pin", key, w)
        for key, w in dec.evict:
            self._act("drop", key, w)
        for key, w, pr in dec.prewarm:
            g = reps.get(key)
            if g is not None:
                self.service.submit(g, w, priority=pr, seq=seqs.get(key))
        for e_cap in dec.tighten:
            # over a mesh the retune job tightens the scale when it runs,
            # at one point of the order stream on every rank
            if self._mesh is None and not s.tighten(e_cap):
                continue
            key = next((k for k in reps if int(k[0]) == int(e_cap)), None)
            if key is not None:
                widths = sorted(set(s.warmed_widths(key)) | {1})
                self.service.submit_retune(reps[key], e_cap, widths,
                                           seq=seqs.get(key))

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
        self.stream = None      # the batcher refers back to this tuner
