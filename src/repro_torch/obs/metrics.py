"""Thread-safe metrics registry: counters, gauges, log2 histograms.

A copy of ``repro/obs/metrics.py``, unchanged in behaviour.

One ``Registry`` owns every metric *family*; a family is a named,
typed group of instruments fanned out by label sets (Prometheus
style).  All mutation and all reads go through the registry's single
lock, so a ``snapshot()`` is a consistent point-in-time cut: counters
are monotone across snapshots and histogram bucket counts always sum
to the histogram's total count (no torn writes).

Design choices, in order of importance for this repo:

* **Determinism** — the registry takes an injectable monotonic clock
  (tests drive a fake clock; nothing here calls ``time`` directly
  except the default).
* **Fixed log2 buckets** — ``Histogram`` buckets are powers of two
  over a fixed exponent range chosen at family creation.  Log2 is the
  natural scale for this codebase: batch widths are a power-of-two
  ladder and latencies span ~1e-4 s (a warm replay's launch) to tens
  of seconds (a cold recording at scale 20).
* **Low ceremony** — a family with no labels acts as its own
  instrument (``reg.counter("x").inc()``), so call sites stay terse.

>>> reg = Registry(clock=lambda: 0.0)
>>> c = reg.counter("euler_cache_hits", "program-cache hits")
>>> c.inc(); c.inc(3)
>>> c.value
4
>>> h = reg.histogram("euler_flush_width", "flush widths", lo_exp=0,
...                   hi_exp=6)
>>> for w in (1, 1, 4):
...     h.observe(w)
>>> h.count, h.sum
(3, 6.0)
>>> h.percentile(0.5) <= 2.0
True
"""
from __future__ import annotations

import math
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

LabelKV = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> LabelKV:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Instrument:
    """Base: one metric point (a family child for one label set)."""

    def __init__(self, family: "Family", labels: LabelKV):
        self._family = family
        self._lock = family._registry._lock
        self.labels_kv = labels


class Counter(_Instrument):
    """Monotonically increasing count."""

    def __init__(self, family: "Family", labels: LabelKV):
        super().__init__(family, labels)
        self._value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge(_Instrument):
    """Point-in-time value (may go up or down)."""

    def __init__(self, family: "Family", labels: LabelKV):
        super().__init__(family, labels)
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, dv: float) -> None:
        with self._lock:
            self._value += float(dv)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram(_Instrument):
    """Fixed log2-bucket histogram with interpolated percentiles.

    Bucket upper bounds are ``2**e`` for ``e`` in ``[lo_exp, hi_exp]``
    plus a final +inf bucket; an observation lands in the first bucket
    whose upper bound is >= the value.  ``percentile(p)`` linearly
    interpolates within the bucket where the cumulative count crosses
    ``p * count`` — cheap, bounded-error quantiles without retaining
    raw samples.
    """

    def __init__(self, family: "Family", labels: LabelKV):
        super().__init__(family, labels)
        self.bounds: List[float] = [
            float(2.0 ** e)
            for e in range(family.lo_exp, family.hi_exp + 1)
        ] + [math.inf]
        self.counts = [0] * len(self.bounds)
        self._count = 0
        self._sum = 0.0

    def _bucket(self, v: float) -> int:
        lo, hi = 0, len(self.bounds) - 1
        while lo < hi:
            mid = (lo + hi) // 2
            if v <= self.bounds[mid]:
                hi = mid
            else:
                lo = mid + 1
        return lo

    def observe(self, v: float) -> None:
        v = float(v)
        i = self._bucket(v)
        with self._lock:
            self.counts[i] += 1
            self._count += 1
            self._sum += v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, p: float) -> float:
        """Interpolated p-quantile (``p`` in [0, 1]); 0.0 when empty."""
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"percentile wants p in [0, 1], got {p}")
        with self._lock:
            total = self._count
            counts = list(self.counts)
        if total == 0:
            return 0.0
        rank = p * total
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i]
                if math.isinf(hi):     # overflow bucket: no upper bound
                    return lo
                frac = (rank - cum) / c
                return lo + (hi - lo) * min(1.0, max(0.0, frac))
            cum += c
        return self.bounds[-2] if len(self.bounds) > 1 else 0.0


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Family:
    """A named metric family; children are keyed by label set.

    The no-label child is created lazily on first instrument-style use,
    so ``reg.counter("x").inc()`` works without an explicit
    ``.labels()`` hop.
    """

    def __init__(self, registry: "Registry", name: str, kind: str,
                 help: str = "", lo_exp: int = -20, hi_exp: int = 8):
        self._registry = registry
        self.name = name
        self.kind = kind
        self.help = help
        self.lo_exp = lo_exp
        self.hi_exp = hi_exp
        self._children: Dict[LabelKV, _Instrument] = {}

    def labels(self, **labels: str) -> "_Instrument":
        key = _label_key(labels)
        with self._registry._lock:
            child = self._children.get(key)
            if child is None:
                child = _KINDS[self.kind](self, key)
                self._children[key] = child
        return child

    # ---- no-label convenience: the family doubles as its own child
    def inc(self, n: int = 1) -> None:
        self.labels().inc(n)

    def set(self, v: float) -> None:
        self.labels().set(v)

    def add(self, dv: float) -> None:
        self.labels().add(dv)

    def observe(self, v: float) -> None:
        self.labels().observe(v)

    @property
    def value(self):
        return self.labels().value

    @property
    def count(self) -> int:
        return self.labels().count

    @property
    def sum(self) -> float:
        return self.labels().sum

    def percentile(self, p: float) -> float:
        return self.labels().percentile(p)

    def children(self) -> Iterable[Tuple[LabelKV, _Instrument]]:
        with self._registry._lock:
            return list(self._children.items())


class Registry:
    """Owner of every family; one lock covers all reads and writes."""

    def __init__(self, clock=time.monotonic):
        self._lock = threading.RLock()
        self._families: Dict[str, Family] = {}
        self.clock = clock

    def _family(self, name: str, kind: str, help: str,
                **kw) -> Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = Family(self, name, kind, help, **kw)
                self._families[name] = fam
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}, "
                    f"requested {kind}")
        return fam

    def counter(self, name: str, help: str = "") -> Family:
        return self._family(name, "counter", help)

    def gauge(self, name: str, help: str = "") -> Family:
        return self._family(name, "gauge", help)

    def histogram(self, name: str, help: str = "",
                  lo_exp: int = -20, hi_exp: int = 8) -> Family:
        return self._family(name, "histogram", help,
                            lo_exp=lo_exp, hi_exp=hi_exp)

    def get(self, name: str) -> Optional[Family]:
        with self._lock:
            return self._families.get(name)

    def families(self) -> List[Family]:
        with self._lock:
            return list(self._families.values())

    def snapshot(self) -> Dict[str, dict]:
        """Consistent point-in-time cut of every family.

        Taken under the registry lock, so no concurrent writer can tear
        a histogram (bucket counts always sum to ``count``) or roll a
        counter backwards between two reads of the same snapshot.
        """
        out: Dict[str, dict] = {}
        with self._lock:
            for name, fam in sorted(self._families.items()):
                entry: dict = {"kind": fam.kind, "help": fam.help,
                               "points": []}
                for key, child in sorted(fam._children.items()):
                    labels = dict(key)
                    if fam.kind == "histogram":
                        entry["points"].append({
                            "labels": labels,
                            "count": child._count,
                            "sum": child._sum,
                            "buckets": {
                                ("+Inf" if math.isinf(b) else repr(b)): c
                                for b, c in zip(child.bounds, child.counts)
                                if c},
                        })
                    else:
                        entry["points"].append(
                            {"labels": labels, "value": child._value})
                out[name] = entry
        return out


# Process-default registry: solver/serving instruments land here unless
# a caller supplies its own (tests use private registries + fake clocks).
DEFAULT = Registry()


def default_registry() -> Registry:
    return DEFAULT
