"""Bounded convergence loops, eager or inside a CUDA graph.

The reference runs its three splice loops (Phase 1's in
``repro/core/phase1.py``, the replicated and sharded Phase 3's in
``repro/core/phase3.py``) as ``lax.while_loop`` inside one jitted
program: a round repeats while its ``changed`` flag holds, at most a
fixed budget of rounds.  It has no file for this; here it is
:func:`converge`, used by all three loops:

  * eagerly (any CPU run, and a CUDA run outside a capture) it reads the
    flag on the host once per round and stops at convergence, as the
    ``while_loop`` does;
  * while the current CUDA stream is being captured into a graph it
    records the loop as one CUDA while node (:func:`device_while`,
    ``kernels/graph_loop.py``): one round's work is recorded once as the
    node's body, and a kernel on the device tests the flag and the
    budget before every round, so each replay runs the rounds its data
    needs, as the eager loop does, and no more.

The carried values live in buffers allocated before the first round, and
every round writes its results back into them with ``copy_``: the node
repeats one recorded body, so the body has to read and write the same
memory in every round.

Round counts.  Inside :func:`counting` every loop appends an int32 0-d
round counter to the active :class:`Loops` of the calling thread:
eagerly the rounds it ran, in a graph the counter its while node writes
at every replay.  The fused run (``core/engine.py::FusedRun``) copies
them out with each run's outputs (``PendingRun.rounds_run``).

The census.  The reference audits its programs by walking their jaxprs
(``repro/analysis/jaxpr_audit.py``), where a scan or ``fori_loop`` body
is traced once.  A recording here runs Python instead: every level and
every ring step runs.  Inside :func:`censusing` the port's stand-ins for
the reference's collectives and kernel calls (``core/engine.py``'s
``_route`` and ``_log_mates`` for ``all_to_all``, ``core/phase3.py``'s
``_ring`` for ``ppermute``, its partition sums for ``psum`` and its
gathers for ``all_gather``, and the K1–K4 wrappers for ``pallas_call``)
count their calls into the thread's :class:`Census`, each tagged with
the loops open around it (:func:`scope`).  A splice loop's body counts
once, as the reference's ``while_loop`` body: inside a recording it runs
once, and eagerly only its first round counts.  With no census open a
hook costs one lookup and a ``None`` check.

The card gate.  ``torch.cuda.graph`` records in CUDA's ``"global"``
capture mode: while one thread records, a call that may synchronize
(an allocation, a copy, an event or stream synchronization) from any
other thread fails or invalidates the recording.  The port's CUDA work
therefore goes through :data:`CARD`, one gate a process (the capture
mode is process-wide): a recording holds it alone
(:meth:`CardGate.exclusive`), every other piece of the port's CUDA work
(uploads, launches, fetches, evictions, eager solves) holds it shared
(:meth:`CardGate.shared`), and many share it at once.
"""
from __future__ import annotations

import contextlib
import threading
from collections import Counter
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import torch

from ..kernels import graph_loop


def capturing(device: torch.device) -> bool:
    """Whether work on ``device`` is being recorded into a CUDA graph
    (then nothing may be read on the host)."""
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


class Loops:
    """The splice loops run under :func:`counting`, in order: each one's
    int32 round counter.  On a card it also holds the stream and the
    memory pool that the while nodes record their bodies on; both are
    made here, before a capture starts, and must live as long as the
    graph that holds the nodes.  ``bodies`` are the addresses of the
    while nodes' body graphs (for :func:`graph_census`; valid while
    the graph that holds the nodes is)."""

    def __init__(self, device: torch.device):
        self.counters: List[torch.Tensor] = []
        self.bodies: List[int] = []
        self.stream: Optional[torch.cuda.Stream] = None
        self.pool: Optional[torch.cuda.MemPool] = None
        if device.type == "cuda":
            graph_loop.load(device)
            self.stream = torch.cuda.Stream(device)
            self.pool = torch.cuda.MemPool()

    def rounds_run(self) -> List[int]:
        """Rounds each loop ran (read on the host: after a graph's
        replay, the rounds of that replay)."""
        return [int(c) for c in self.counters]


class CardGate:
    """Shared/exclusive gate over the port's CUDA work in one process.

    :meth:`shared` may be held by many threads at once, and again by a
    thread that holds it (shared or exclusive); :meth:`exclusive` waits
    until no other thread holds it, and a thread asking for it keeps
    newer shared holders out until it has had its turn.  A thread that
    holds it shared may not ask for it exclusively (it would wait for
    itself): that raises.  On a CPU device both are no-ops."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0             # shared holds, all threads
        self._writer: Optional[int] = None   # ident of the exclusive holder
        self._writers_waiting = 0
        self._mine = threading.local()       # this thread's shared holds

    def _held(self) -> int:
        return getattr(self._mine, "n", 0)

    @contextlib.contextmanager
    def shared(self, device: torch.device) -> Iterator[None]:
        if device.type != "cuda" or self._writer == threading.get_ident():
            yield
            return
        with self._cond:
            if not self._held():
                while self._writer is not None or self._writers_waiting:
                    self._cond.wait()
            self._readers += 1
            self._mine.n = self._held() + 1
        try:
            yield
        finally:
            with self._cond:
                self._readers -= 1
                self._mine.n -= 1
                self._cond.notify_all()

    @contextlib.contextmanager
    def try_shared(self, device: torch.device) -> Iterator[bool]:
        """:meth:`shared` if it is free now; yields whether it was."""
        if device.type == "cuda" and not self._held() \
                and self._writer != threading.get_ident():
            with self._cond:
                free = self._writer is None and not self._writers_waiting
            if not free:
                yield False
                return
        with self.shared(device):
            yield True

    @contextlib.contextmanager
    def exclusive(self, device: torch.device) -> Iterator[None]:
        me = threading.get_ident()
        if device.type != "cuda" or self._writer == me:
            yield
            return
        if self._held():
            raise RuntimeError("a thread that holds the card gate shared "
                               "asked for it exclusively")
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer is not None or self._readers:
                    self._cond.wait()
            finally:
                self._writers_waiting -= 1
            self._writer = me
        try:
            yield
        finally:
            with self._cond:
                self._writer = None
                self._cond.notify_all()


#: the process's gate (module docstring)
CARD = CardGate()

_local = threading.local()      # .loops: this thread's active Loops


def _active() -> Optional[Loops]:
    return getattr(_local, "loops", None)


@contextlib.contextmanager
def counting(loops: Optional[Loops]) -> Iterator[Optional[Loops]]:
    """Append the round counter of every loop this thread runs inside to
    ``loops`` (``None``: to nothing; a loop recorded inside then
    raises)."""
    outer, _local.loops = _active(), loops
    try:
        yield loops
    finally:
        _local.loops = outer


@contextlib.contextmanager
def recording(graph: "torch.cuda.CUDAGraph",
              loops: Optional[Loops] = None) -> Iterator[None]:
    """Capture the work of the ``with`` body into ``graph``
    (``torch.cuda.graph``, in a pool of its own, on a stream apart from
    ``loops``'), counting its loops into ``loops`` (:func:`counting`).
    ``loops=None`` is for a body without splice loops (the LM serving
    steps): one that records a loop all the same raises
    (:func:`device_while`).

    A host read inside is an error raised before it reaches the card
    (torch's sync debug mode ``error``): one that reached it would
    invalidate the capture, and ending an invalidated capture that holds
    a half-recorded while node crashes the process.  If the
    capture fails all the same, this undoes what torch's failed
    ``capture_end`` leaves behind: the capture's stream as the current
    one, and this thread's allocations routed to the graph's pool (a
    routing entry left behind fails the next release of cached memory,
    such as the destruction of ``loops``' pool)."""
    pool = torch.cuda.graph_pool_handle()
    stream = torch.cuda.current_stream()
    on = torch.cuda.Stream()       # PyTorch's pool hands streams out in turn,
    if loops is not None and on == loops.stream:   # so the next one
        on = torch.cuda.Stream()                   # differs from the bodies'
    try:
        with counting(loops), torch.cuda.graph(graph, pool=pool, stream=on):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode(mode)
    except BaseException:
        torch.cuda.set_stream(stream)
        try:
            torch._C._cuda_endAllocateToPool(stream.device.index, pool)
        except RuntimeError:
            pass                  # torch's capture_end stopped it itself
        raise


class Census:
    """What one recording (on the CPU: one run) called at the port's
    stand-ins for the reference's collectives and kernels (module
    docstring).  ``counts`` maps a name to its calls: ``all_to_all`` (a
    table group's exchange counts the reference's eqns for the group,
    one a field shipped plus the mask), ``ppermute`` (one a ring loop,
    the reference's one eqn a ``fori_loop``), ``ring_step`` (one a
    ``_ring`` call), ``psum``, ``all_gather``, ``pallas_call`` (one a
    K1–K4 wrapper call, kernel or twin) and ``kernel:<wrapper>``, and
    ``while`` (one a splice loop).  ``scopes`` lists every loop opened,
    in order, as ``(kind, counts inside it)``, kinds ``level``, ``ring``
    and ``while``; ``inside[kind]`` counts what was called inside any
    loop of that kind."""

    def __init__(self):
        self.counts: Counter = Counter()
        self.inside: Dict[str, Counter] = {}
        self.scopes: List[Tuple[str, Counter]] = []
        self._open: List[Tuple[str, Counter]] = []
        self._muted = 0

    def add(self, name: str, k: int = 1) -> None:
        if self._muted:
            return
        self.counts[name] += k
        for kind in {kind for kind, _ in self._open}:
            self.inside.setdefault(kind, Counter())[name] += k
        for _, ctr in self._open:
            ctr[name] += k

    @contextlib.contextmanager
    def scope(self, kind: str) -> Iterator[None]:
        """A loop of ``kind`` around the ``with`` body; a ring loop also
        counts its ``ppermute`` and a splice loop its ``while``, where
        the loop opens."""
        if kind in ("ring", "while"):
            self.add("ppermute" if kind == "ring" else "while")
        ctr: Counter = Counter()
        if not self._muted:
            self.scopes.append((kind, ctr))
        self._open.append((kind, ctr))
        try:
            yield
        finally:
            self._open.pop()

    @contextlib.contextmanager
    def muted(self) -> Iterator[None]:
        """Count nothing inside (a splice loop's later eager rounds)."""
        self._muted += 1
        try:
            yield
        finally:
            self._muted -= 1


_NULL = contextlib.nullcontext()
_census = threading.local()     # .open: this thread's open Census


def open_census() -> Optional[Census]:
    """The census open on this thread, if any."""
    return getattr(_census, "open", None)


@contextlib.contextmanager
def censusing(census: Census) -> Iterator[Census]:
    """Count this thread's calls at the hooks into ``census``."""
    outer, _census.open = open_census(), census
    try:
        yield census
    finally:
        _census.open = outer


def note(name: str, k: int = 1) -> None:
    """A hook: ``k`` calls of ``name``, if a census is open."""
    c = getattr(_census, "open", None)
    if c is not None:
        c.add(name, k)


def note_kernel(name: str) -> None:
    """A hook in a K1–K4 wrapper: one ``pallas_call`` of ``name``."""
    c = getattr(_census, "open", None)
    if c is not None:
        c.add("pallas_call")
        c.add(f"kernel:{name}")


def scope(kind: str):
    """:meth:`Census.scope` of the open census, else a no-op."""
    c = getattr(_census, "open", None)
    return _NULL if c is None else c.scope(kind)


def graph_census(graph: "torch.cuda.CUDAGraph", loops: Loops,
                 device: torch.device) -> Dict[str, int]:
    """The node census (``graph_loop.census``) of a graph just recorded
    by :func:`recording` with ``keep_graph=True``, its while bodies
    (``loops.bodies``) included; then the graph is instantiated.
    Raises ``RuntimeError`` when the census cannot be read."""
    try:
        counts = graph_loop.census(graph.raw_cuda_graph(), loops.bodies,
                                   device)
    except RuntimeError as e:
        raise RuntimeError(f"the recorded graph's census cannot be read: "
                           f"{e}") from e
    graph.instantiate()
    return counts


def device_while(body: Callable[[], None], changed: torch.Tensor,
                 rounds: int) -> None:
    """Record ``body`` (one round, written in place) as one while node of
    the graph being captured, its round counter appended to the active
    :class:`Loops` (:func:`counting`), on whose stream and pool the body
    records.  On CPU tensors (the tests' stand-in for a capture) the
    rounds run now on the host, under the same trip rule."""
    loops = _active()
    if loops is None:
        raise RuntimeError("a splice loop recorded outside "
                           "capture.counting(): nothing would hold its "
                           "while node's stream, pool and counter")
    ctr = torch.empty((), dtype=torch.int32, device=changed.device)
    body_graph = graph_loop.while_loop(body, changed, ctr, rounds,
                                       loops.stream, loops.pool)
    loops.counters.append(ctr)
    if body_graph is not None:
        loops.bodies.append(body_graph)


def converge(step: Callable[..., Sequence[torch.Tensor]],
             carry: Sequence[torch.Tensor],
             rounds: int) -> Tuple[torch.Tensor, ...]:
    """Run ``step`` over ``carry`` while the carry's last element (a bool
    ``changed`` flag of any shape) holds anywhere, at most ``rounds``
    times: eagerly, or as a while node when the device is capturing.

    ``step(*carry)`` returns the next carry: fresh tensors of the same
    shapes and types, none of them a view of its inputs.  The carry is
    copied once into new buffers, and each round is written back into
    them, so the returned tensors are those buffers."""
    bufs = tuple(x.clone() for x in carry)

    def one_round() -> None:
        for buf, new in zip(bufs, step(*bufs)):
            buf.copy_(new)

    cen = open_census()
    if capturing(bufs[0].device):
        with scope("while"):
            device_while(one_round, bufs[-1], rounds)
        return bufs
    ran = 0
    with scope("while"):
        while ran < rounds and bool(bufs[-1].any()):  # one host read a round
            with cen.muted() if cen is not None and ran else _NULL:
                one_round()
            ran += 1
    loops = _active()
    if loops is not None:
        loops.counters.append(torch.tensor(ran, dtype=torch.int32))
    return bufs
