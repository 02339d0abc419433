"""`repro_torch.obs` — the port's observability layer, a copy of
``repro/obs`` (counters, gauges and log2 histograms in a ``Registry``,
spans in a ``TraceLog``, Prometheus and JSON exporters).

The port keeps its own copy so that it imports nothing of the JAX
package; the two give the same text and snapshots for the same
operations (``tests/test_torch_obs.py``).  The solver session
(``repro_torch/euler/solver.py``) reports its cache counters and spans
here, under the reference's family and span names.

* :mod:`repro_torch.obs.metrics` — thread-safe ``Registry`` of
  ``Counter`` / ``Gauge`` / log2-bucket ``Histogram`` families with
  labels and an injectable clock.
* :mod:`repro_torch.obs.trace` — ``Span`` context managers into a
  bounded ``TraceLog`` ring (optional JSONL sink), thread-local
  parentage.
* :mod:`repro_torch.obs.export` — JSON snapshot, Prometheus text
  rendering, and ``MetricsServer``.

Stdlib only.
"""
from .export import MetricsServer, render_prometheus, snapshot
from .metrics import (Counter, Family, Gauge, Histogram, Registry,
                      default_registry)
from .trace import (NULL_SPAN, NullTraceLog, Span, TraceLog,
                    default_tracelog)

__all__ = [
    "Counter", "Family", "Gauge", "Histogram", "Registry",
    "default_registry",
    "Span", "TraceLog", "NullTraceLog", "NULL_SPAN", "default_tracelog",
    "MetricsServer", "render_prometheus", "snapshot",
]
