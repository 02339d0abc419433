"""Span tracing: context-manager spans into a bounded in-process ring.

A copy of ``repro/obs/trace.py``, unchanged in behaviour.

A ``TraceLog`` is the collector: spans open with ``log.span(name)``,
nest via a thread-local parent stack (so concurrent serving / compile
threads interleave without cross-linking), and close into a bounded
ring (``collections.deque``) plus an optional JSONL sink.  Span ids
are sequential ints assigned under the log's lock — with an injected
clock the whole span tree is deterministic, which is what the tests
pin down.

A span can also feed a histogram: ``log.span("launch", metric=h)``
observes the span's duration into ``h`` on exit, so one seam yields
both the trace tree and the latency distribution.

>>> t = [0.0]
>>> log = TraceLog(capacity=8, clock=lambda: t[0])
>>> with log.span("flush", bucket="(16,2,4)") as outer:
...     t[0] = 1.0
...     with log.span("launch"):
...         t[0] = 3.0
>>> [(s["name"], s["dur_s"], s["parent"]) for s in log.spans()]
[('launch', 2.0, 1), ('flush', 3.0, None)]
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import IO, Dict, List, Optional, Union


class Span:
    """One timed section.  Use as a context manager; attributes passed
    at creation plus any added via ``set(...)`` land in the record."""

    __slots__ = ("log", "name", "attrs", "id", "parent", "t0", "dur_s",
                 "status", "_metric")

    def __init__(self, log: "TraceLog", name: str, metric=None,
                 **attrs):
        self.log = log
        self.name = name
        self.attrs: Dict[str, object] = dict(attrs)
        self.id: Optional[int] = None
        self.parent: Optional[int] = None
        self.t0 = 0.0
        self.dur_s = 0.0
        self.status = "ok"
        self._metric = metric

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self.log._open(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self.status = "error"
            self.attrs.setdefault("error", exc_type.__name__)
        self.log._close(self)
        if self._metric is not None:
            self._metric.observe(self.dur_s)
        return False


class _NullSpan:
    """No-op stand-in so call sites never branch on 'tracing enabled'."""

    __slots__ = ()

    def set(self, **attrs) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


NULL_SPAN = _NullSpan()


class TraceLog:
    """Bounded collector of closed spans (newest-last ring).

    ``capacity`` bounds memory; ``sink`` (a path or writable file
    object) additionally streams every closed span as one JSON line.
    The per-thread open-span stack lives in ``threading.local`` so
    parentage never crosses threads.
    """

    def __init__(self, capacity: int = 2048, clock=time.monotonic,
                 sink: Union[None, str, IO[str]] = None):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        self._next_id = 1
        self._tls = threading.local()
        self.clock = clock
        self._sink: Optional[IO[str]] = None
        self._sink_owned = False
        if isinstance(sink, str):
            self._sink = open(sink, "a")
            self._sink_owned = True
        elif sink is not None:
            self._sink = sink

    # ------------------------------------------------------------ spans
    def span(self, name: str, metric=None, **attrs) -> Span:
        return Span(self, name, metric=metric, **attrs)

    def event(self, name: str, **attrs) -> None:
        """Record an instantaneous (zero-duration) span — for point
        occurrences like a jit retrace, where the surrounding timing
        belongs to whoever triggered it."""
        with self.span(name, **attrs):
            pass

    def _stack(self) -> List[int]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _open(self, span: Span) -> None:
        st = self._stack()
        with self._lock:
            span.id = self._next_id
            self._next_id += 1
        span.parent = st[-1] if st else None
        st.append(span.id)
        span.t0 = self.clock()

    def _close(self, span: Span) -> None:
        span.dur_s = self.clock() - span.t0
        st = self._stack()
        if st and st[-1] == span.id:
            st.pop()
        rec = {"id": span.id, "parent": span.parent, "name": span.name,
               "t0": span.t0, "dur_s": span.dur_s, "status": span.status,
               "thread": threading.current_thread().name}
        if span.attrs:
            rec["attrs"] = dict(span.attrs)
        with self._lock:
            self._ring.append(rec)
            if self._sink is not None:
                self._sink.write(json.dumps(rec, default=str) + "\n")
                self._sink.flush()

    # ------------------------------------------------------------ reads
    def spans(self) -> List[dict]:
        """Closed spans, oldest first (bounded by ``capacity``)."""
        with self._lock:
            return [dict(r) for r in self._ring]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def close(self) -> None:
        with self._lock:
            if self._sink is not None and self._sink_owned:
                self._sink.close()
            self._sink = None


class NullTraceLog(TraceLog):
    """Tracing disabled: ``span()`` returns a shared no-op span and
    nothing is recorded.  Engine/solver default to the process trace
    log; pass one of these to switch instrumentation off wholesale."""

    def __init__(self):
        super().__init__(capacity=1)

    def span(self, name: str, metric=None, **attrs) -> _NullSpan:  # type: ignore[override]
        return NULL_SPAN


# Process-default trace log, mirroring metrics.DEFAULT.
DEFAULT = TraceLog()


def default_tracelog() -> TraceLog:
    return DEFAULT
