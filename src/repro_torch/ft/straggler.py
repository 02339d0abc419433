"""Straggler detection & mitigation hooks (the port's own copy of
``repro/ft/straggler.py``).

A per-step wall-time EMA + variance tracker flags steps slower than
``mean + k·σ``.  On flag, the registered mitigation runs — in production
that re-dispatches the slow host's shard (for the Euler engine this is
cheap by design: only pathMap state, the paper's O(|B|+|R|) communication
bound, must move); in tests it is a recorded no-op.

The BSP structure makes straggler *damage* visible directly: a superstep
is a barrier, so `worst_step / median_step` is the utilization loss the
paper attributes to idle machines in Makki-style traversals (§2.2).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional


@dataclasses.dataclass
class StragglerStats:
    mean: float = 0.0
    var: float = 0.0
    n: int = 0
    flagged: int = 0
    events: List[int] = dataclasses.field(default_factory=list)


class StragglerMonitor:
    def __init__(self, k_sigma: float = 3.0, warmup: int = 5,
                 decay: float = 0.9,
                 on_straggler: Optional[Callable[[int, float], None]] = None):
        self.k = k_sigma
        self.warmup = warmup
        self.decay = decay
        self.on_straggler = on_straggler
        self.stats = StragglerStats()

    def observe(self, step: int, seconds: float) -> bool:
        s = self.stats
        if s.n >= self.warmup:
            thresh = s.mean + self.k * (s.var ** 0.5)
            if seconds > thresh:
                s.flagged += 1
                s.events.append(step)
                if self.on_straggler:
                    self.on_straggler(step, seconds)
                s.n += 1
                return True
        if s.n == 0:
            s.mean, s.var = seconds, 0.0
        else:
            d = seconds - s.mean
            s.mean += (1 - self.decay) * d
            s.var = self.decay * (s.var + (1 - self.decay) * d * d)
        s.n += 1
        return False

    def timed(self, fn, step: int):
        t0 = time.perf_counter()
        out = fn()
        self.observe(step, time.perf_counter() - t0)
        return out
