"""Where one solve's time goes on the card.

    python -m repro_torch.launch.profile --scale 20               # sharded
    python -m repro_torch.launch.profile --scale 20 --replicated
    python -m repro_torch.launch.profile --scale 20 --fused [--replicated]

Calls :meth:`repro_torch.euler.EulerSolver.solve` on ``cuda`` twice for
an Eulerian RMAT graph (average degree 5, seed 0, 8 partitions:
``chip_smoke.py``'s main path), with the solver's default Phase 3 (the
sharded one, K3/K4) or, under ``--replicated``, the replicated one
(K1/K2).  The first solve runs plain: its ``timings`` and the peak
device memory are printed and the circuit is validated.  The second, a
repeat solve of the same graph in the same session (its prep memoized,
its state resident on the card, so no host prep and no upload), runs
under ``torch.profiler``: its timings, the device's busy and idle share,
the kernels by total device time, and the rows of the port's own kernels
K1–K4 and the splice loops' test by name.

Without ``--fused`` both solves are eager (``fused=False``): each phase
and each superstep is read after the device drained, and the idle share
is given of the whole solve and of its device phases (everything after
the host prep).  With ``--fused`` the first solve records the bucket's
graph and the profiled one replays it: the idle share is of its
``run_s`` (replay through fetch), and the K1–K4 rows count the kernels'
launches inside the graph, which the wrappers' launch counters do not
see on a replay.  The splice loops' rounds in the replay are printed
(``FusedRun.rounds_run``) beside the calls of their test kernel in the
trace; a while node runs it once more than its rounds.  Where the trace
shows fewer (it may show a while node's body once a replay, however
many rounds ran), its busy time misses those rounds and the idle shares
are printed as ``not_measured``.

No file of ``repro/launch`` matches this script: the JAX package timed
its phases with ``repro.obs`` spans (the port's solver emits the same
spans into ``repro_torch.obs``, without device time).
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
               "pointer_double_rank": "pointer_double_rank_kernel",
               "pointer_double_shard": "pointer_double_shard_kernel",
               "pointer_double_rank_shard":
                   "pointer_double_rank_shard_kernel",
               "loop_condition": "loop_condition_kernel"}


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
    ap.add_argument("--replicated", action="store_true",
                    help="profile the replicated Phase 3 (K1/K2) instead "
                         "of the default sharded one (K3/K4)")
    ap.add_argument("--fused", action="store_true",
                    help="profile a warm replay of the fused run instead "
                         "of an eager solve")
    args = ap.parse_args(argv)

    # raises with no card
    solver = EulerSolver(n_parts=8, sharded_phase3=not args.replicated,
                         fused=args.fused)
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
         sharded_phase3=solver.sharded_phase3, fused=res.fused,
         peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
         reserved_gib=f"{torch.cuda.max_memory_reserved() / 2**30:.3f}",
         captures=solver.captures, **_timings(res))

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        res = solver.solve(g)
    rows = [e for e in prof.key_averages()
            if _is_kernel(e) and _device_us(e) > 0]
    busy_s = sum(_device_us(e) for e in rows) / 1e6
    tm = res.timings
    _say("profiled solve", captures=solver.captures, **_timings(res))
    if args.fused:
        # the replay copies nothing host→device: those rows are the upload
        run_busy_s = busy_s - sum(_device_us(e) for e in rows
                                  if "HtoD" in e.key) / 1e6
        key = solver.bucket_of(g)
        ran = solver._engines[key].fused_program(key[0]).rounds_run()
        tests = sum(e.count for e in rows
                    if OWN_KERNELS["loop_condition"] + "(" in e.key)
        # a trace that shows fewer loop tests than ran misses rounds of
        # the while nodes' bodies, so its busy time is short of the truth
        whole = tests == sum(ran) + len(ran)
        _say("splice loops", rounds_run=",".join(map(str, ran)),
             loop_tests_run=sum(ran) + len(ran), loop_tests_traced=tests)
        _say("profiled device", busy_s=f"{busy_s:.4f}",
             run_busy_s=f"{run_busy_s:.4f}",
             idle_share_run=(f"{max(0.0, 1 - run_busy_s / tm['run_s']):.3f}"
                             if whole else "not_measured"),
             idle_share_solve=(f"{max(0.0, 1 - busy_s / tm['total_s']):.3f}"
                               if whole else "not_measured"))
    else:
        device_s = tm["total_s"] - tm["prepare_s"]
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
