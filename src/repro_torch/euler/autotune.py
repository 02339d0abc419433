"""Bounded flush accounting for the serving loop (mirrors
``repro/euler/autotune.py``; only :class:`FlushLog` is ported).

``launch/serve.py::MicroBatcher`` logs every dispatch's width here.  The
rest of the reference module — the background ``CompileService`` and
``CompileTicket``, the ``AutoTuner`` policy (``plan``,
``ladder_decompose``, the tuner's dataclasses) that warms ladder widths
behind live traffic — is ROADMAP queue 1 item 6b, the next slice.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, List, Optional

__all__ = ["FlushLog"]


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
