"""Where one solve's time goes on the card.

    python -m repro_torch.launch.profile --scale 20

Calls :meth:`repro_torch.euler.EulerSolver.solve` on ``cuda`` twice for
an Eulerian RMAT graph (average degree 5, seed 0, 8 partitions:
``chip_smoke.py``'s main path).  The first solve runs plain: its
``timings`` (each phase and each superstep read after the device
drained) and the peak device memory are printed and the circuit is
validated.  The second runs under ``torch.profiler``: its timings, the
device's busy and idle share of the whole solve and of its device phases
(everything after the host prep), the kernels by total device time, and
the rows of the port's own kernels K1/K2 by name.

No file of ``repro/launch`` matches this script: the JAX package timed
its phases with ``repro.obs`` spans, which the port does not have yet.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..euler import EulerSolver
from ..graphgen.eulerize import eulerian_rmat
from ..kernels import build

#: device-side kernel name of each of the port's kernels
OWN_KERNELS = {"pointer_double": "pointer_double_kernel",
               "pointer_double_rank": "pointer_double_rank_kernel"}


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def _is_kernel(evt) -> bool:
    """Device-side rows only: the aten op rows repeat their kernels'
    device time, so summing both would count it twice."""
    return getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA


def _say(step: str, **fields) -> None:
    print(f"[profile] {step} "
          + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def _timings(res) -> dict:
    return {k: f"{v:.4f}" for k, v in res.timings.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=20,
                    help="RMAT scale (average degree 5, seed 0, 8 "
                         "partitions: chip_smoke.py's main path)")
    args = ap.parse_args(argv)

    solver = EulerSolver(n_parts=8)                   # raises with no card
    t = time.perf_counter()
    build.build_all()                                 # set-up, not solve time
    _say("build", s=f"{time.perf_counter() - t:.4f}")
    t = time.perf_counter()
    g = eulerian_rmat(args.scale, avg_degree=5, seed=0)
    _say("graphgen", s=f"{time.perf_counter() - t:.4f}",
         vertices=g.num_vertices, edges=g.num_edges)

    torch.cuda.reset_peak_memory_stats()
    res = solver.solve(g).validate()
    _say("solve", valid=res.valid, supersteps=res.supersteps,
         peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
         **_timings(res))

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        res = solver.solve(g)
    rows = [e for e in prof.key_averages()
            if _is_kernel(e) and _device_us(e) > 0]
    busy_s = sum(_device_us(e) for e in rows) / 1e6
    tm = res.timings
    device_s = tm["total_s"] - tm["prepare_s"]
    _say("profiled solve", **_timings(res))
    _say("profiled device", busy_s=f"{busy_s:.4f}",
         idle_share_solve=f"{max(0.0, 1 - busy_s / tm['total_s']):.3f}",
         idle_share_device_phases=f"{max(0.0, 1 - busy_s / device_s):.3f}")
    rows.sort(key=_device_us, reverse=True)
    for e in rows[:25]:
        print(f"[profile] kernel {_device_us(e) / 1e3:10.3f} ms "
              f"calls={e.count:6d} {e.key[:90]}", flush=True)
    for name, sym in OWN_KERNELS.items():
        own = [e for e in rows if sym + "(" in e.key]
        total_ms = sum(_device_us(e) for e in own) / 1e3
        calls = sum(e.count for e in own)
        _say("own kernel", name=name, total_ms=f"{total_ms:.4f}",
             calls=calls,
             ms_per_call=f"{total_ms / calls:.4f}" if calls else "n/a")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
