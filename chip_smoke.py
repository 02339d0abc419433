#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                 # scale-20 RMAT graph, 8 partitions

Phases, each printed on its own line; any failure raises and the script
exits non-zero:

  1. device   — the card's name and power limit (``nvidia-smi``); fails
                when no CUDA device is present;
  2. build    — compiles every CUDA source of the port (one ``nvcc`` each,
                started together) and prints the build seconds and the
                ``ptxas`` resource report;
  3. kernels  — each kernel against its plain-torch twin at the main
                path's width (N = 2·4,194,304 stubs; K3/K4 as 8 shards of
                1,048,576): bit-equal over one round (K3/K4: one ring
                step) and over the 24 chained rounds of a solve (K3/K4:
                24 rounds of 8 ring steps with rolled tables), ending at
                the converged labels and ranks of a seeded one-cycle
                input, then its time from CUDA events beside the twin's
                and the bound;
  4. parity   — a scale-8, 2-partition solve on ``cuda`` and on ``cpu``
                in each Phase 3 mode (sharded, the default; replicated;
                ``gather_circuit=False``): every circuit and mate
                byte-identical, all validated;
  5. slice    — the main path: ``repro_torch.euler.solve`` of an Eulerian
                RMAT graph (scale 20, average degree 5, seed 0) with 8
                partitions on ``cuda``, twice: with the default sharded
                Phase 3 and with ``sharded_phase3=False``, launch
                counters reset just before each and read just after.
                Both circuits are validated, byte-identical to each other
                and to the numpy list-rank twin of the spliced mate; the
                replicated solve must launch K1/K2 once per doubling
                round and K3/K4 never, the sharded one K3/K4 once per
                ring step of each round (rounds × 8) and K1/K2 never.

The last three lines are the kernel table as JSON, the ``nvidia-smi``
line, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import phase3 as p3  # noqa: E402
from repro_torch.core.phase3 import circuit_from_mate_np  # noqa: E402
from repro_torch.euler import solve  # noqa: E402
from repro_torch.euler.bucket import strip_circuit  # noqa: E402
from repro_torch.graphgen.eulerize import eulerian_rmat  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import pointer_double as pd  # noqa: E402

#: H100 SXM device-memory rate (NVIDIA data sheet), bytes/s.
HBM_BYTES_PER_S = 3.35e12
#: The main path: Eulerian RMAT graph, average degree 5, seed 0, 8
#: partitions; at scale 20 its stub count is 2 · e_cap = 2 · 4,194,304.
AVG_DEGREE, SEED, PARTS = 5, 0, 8
N_MAIN = 2 * 4_194_304
KERNELS = {
    "pointer_double": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pointer_double.cu",
        "replaces": "src/repro/kernels/pointer_double.py:108",
    },
    "pointer_double_rank": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pointer_double.cu",
        "replaces": "src/repro/kernels/pointer_double.py:152",
    },
    "pointer_double_shard": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pointer_double.cu",
        "replaces": "src/repro/kernels/pointer_double.py:220",
    },
    "pointer_double_rank_shard": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pointer_double.cu",
        "replaces": "src/repro/kernels/pointer_double.py:275",
    },
}
#: the kernels each Phase 3 path runs, by the solver's sharded_phase3
PATH_KERNELS = {False: ("pointer_double", "pointer_double_rank"),
                True: ("pointer_double_shard", "pointer_double_rank_shard")}
MODES = {"sharded": {}, "replicated": {"sharded_phase3": False},
         "no_gather": {"gather_circuit": False}}


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of ``fn`` from CUDA events, warmed."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def chain(n: int, rng: np.random.Generator):
    """A seeded random order of all ``n`` stubs: ``succ`` closes it into
    one cycle (K1's input shape in Phase 3), ``ptr`` ends it at a halt
    node that self-loops (K2's)."""
    order = rng.permutation(n)
    succ = np.empty(n, dtype=np.int32)
    succ[order] = np.roll(order, -1)
    ptr = succ.copy()
    ptr[order[-1]] = order[-1]
    return succ, ptr, int(order[-1])


def max_abs_err(a, b) -> int:
    return max(int((x.to(torch.int64) - y.to(torch.int64)).abs().max())
               for x, y in zip(a, b))


def _timed_row(name, kernel, twin, ins, outs, kw, one, chained) -> dict:
    """Time ``kernel`` (200 launches) and ``twin`` (50 calls) on ``ins``
    from CUDA events; the bound counts each input read once and each
    output written once."""
    ms = cuda_ms(lambda: kernel(*ins, **kw, out=outs), 200)
    plain_ms = cuda_ms(lambda: twin(*ins, **kw), 50)
    nbytes = sum(x.numel() * x.element_size() for x in (*ins, *outs))
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    say("kernels", name=name, n=ins[0].numel(), bit_equal_1_step=one == 0,
        bit_equal_rounds=chained == 0, ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
        of_bound=f"{bound_ms / ms:.3f}")
    return {"max_abs_err": max(one, chained), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}


def _as_kernel(twin):
    """The twin with the kernel wrappers' signature, for the ring loop."""
    def run(*args, s_real, out):
        return twin(*args, s_real=s_real)
    return run


def check_kernels(dev, rounds: int) -> dict:
    """Phase 3: each kernel bit-equal to its twin on the card, timed."""
    rng = np.random.default_rng(0)
    succ, ptr_np, halt = chain(N_MAIN, rng)
    nxt = torch.as_tensor(succ, device=dev)
    lab = torch.arange(N_MAIN, dtype=torch.int32, device=dev)
    ptr = torch.as_tensor(ptr_np, device=dev)
    dist = torch.ones(N_MAIN, dtype=torch.int32, device=dev)
    dist[halt] = 0
    reach = torch.zeros(N_MAIN, dtype=torch.int32, device=dev)
    reach[halt] = 1
    # after the chained rounds a single cycle labels every stub 0, and a
    # chain reaches its halt from every stub with ranks 0 … N-1
    cases = {
        "pointer_double": (pd.pointer_double, ref.pointer_double_ref,
                           (nxt, lab),
                           lambda out: int(out[1].max()) == 0),
        "pointer_double_rank": (pd.pointer_double_rank,
                                ref.pointer_double_rank_ref,
                                (ptr, dist, reach),
                                lambda out: int(out[2].min()) == 1
                                and int(out[1].max()) == N_MAIN - 1),
    }
    table = {}
    for name, (kernel, twin, ins, done) in cases.items():
        one = max_abs_err(kernel(*ins), twin(*ins))
        k_cur = tuple(x.clone() for x in ins)
        spare = tuple(torch.empty_like(x) for x in ins)
        t_cur = ins
        for _ in range(rounds):
            k_cur, spare = kernel(*k_cur, out=spare), k_cur
            t_cur = twin(*t_cur)
        torch.cuda.synchronize()
        chained = max_abs_err(k_cur, t_cur)
        if one or chained or not done(k_cur):
            raise AssertionError(f"{name} differs from its twin or did not "
                                 f"converge: one round {one}, {rounds} "
                                 f"rounds {chained}")
        outs = tuple(torch.empty_like(x) for x in ins)
        table[name] = _timed_row(name, kernel, twin, ins, outs, {}, one,
                                 chained)
    table.update(check_shard_kernels(dev, rounds, nxt, ptr, halt))
    return table


def check_shard_kernels(dev, rounds: int, nxt, ptr, halt: int) -> dict:
    """K3/K4 at the main path's [8, 1,048,576] shards, on the same seeded
    one-cycle (K3) and one-chain (K4) inputs: one ring step against the
    twin, then the sharded Phase 3's whole doubling loop
    (``_doubling_sharded``: ``rounds`` × 8 ring steps, rolled tables) run
    with the kernel and with the twin, which must agree and converge."""
    n, S = PARTS, N_MAIN // PARTS
    me = torch.arange(n, dtype=torch.int32, device=dev)
    gid = torch.arange(N_MAIN, dtype=torch.int32, device=dev).view(n, S)
    nxt, ptr = nxt.view(n, S), ptr.view(n, S)
    is_halt = gid == halt
    dist0, reach0 = (~is_halt).to(torch.int32), is_halt.to(torch.int32)
    zero = torch.zeros_like(gid)

    def cc_round(kernel, state):
        q, lab = state
        a_nxt, a_lab = p3._doubling_sharded(
            kernel, q, (q, torch.full_like(q, p3.BIG)),
            torch.stack([q, lab]), me, S)
        return a_nxt, torch.minimum(lab, a_lab)

    def rank_round(kernel, state):
        q, dist, reach = state
        a_ptr, a_dist, a_reach = p3._doubling_sharded(
            kernel, q, (q, zero, zero), torch.stack([q, dist, reach]), me, S)
        return a_ptr, dist + a_dist, torch.maximum(reach, a_reach)

    cases = {
        "pointer_double_shard": (
            pd.pointer_double_shard, ref.pointer_double_shard_ref,
            (nxt, (nxt, torch.full_like(nxt, p3.BIG)), (nxt, gid)),
            cc_round, (nxt, gid), lambda st: int(st[1].max()) == 0),
        "pointer_double_rank_shard": (
            pd.pointer_double_rank_shard, ref.pointer_double_rank_shard_ref,
            (ptr, (ptr, zero, zero), (ptr, dist0, reach0)),
            rank_round, (ptr, dist0, reach0),
            lambda st: int(st[2].min()) == 1
            and int(st[1].max()) == N_MAIN - 1),
    }
    table = {}
    for name, (kernel, twin, step, round_fn, state0, done) in cases.items():
        q, carries, tables = step
        base = p3._ring_bases(me, 3, S)        # ring step k = 3: each row
        tables = tuple(torch.roll(t, 3, 0) for t in tables)   # holds row r-3
        ins = (q, *carries, base, *tables)
        one = max_abs_err(kernel(*ins, s_real=S), twin(*ins, s_real=S))
        k_st, t_st = state0, state0
        for _ in range(rounds):
            k_st = round_fn(kernel, k_st)
            t_st = round_fn(_as_kernel(twin), t_st)
        torch.cuda.synchronize()
        chained = max_abs_err(k_st, t_st)
        if one or chained or not done(k_st):
            raise AssertionError(f"{name} differs from its twin or did not "
                                 f"converge: one step {one}, {rounds} "
                                 f"rounds × {n} steps {chained}")
        outs = tuple(torch.empty_like(c) for c in carries)
        table[name] = _timed_row(name, kernel, twin, ins, outs,
                                 {"s_real": S}, one, chained)
    return table


def solve_counted(g, **opts):
    """``solve`` on ``cuda`` with every launch counter set to 0 just
    before and read just after; returns ``(result, launches, peak)``."""
    for name in KERNELS:
        getattr(pd, name).launches = 0
    torch.cuda.reset_peak_memory_stats()
    res = solve(g, n_parts=PARTS, device="cuda", **opts)
    launches = {name: getattr(pd, name).launches for name in KERNELS}
    return res, launches, torch.cuda.max_memory_allocated()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=20,
                    help="RMAT scale of the main-path graph (default 20; "
                         "cut it, never the partitions, for a quick check)")
    args = ap.parse_args(argv)

    # ---- 1. device ----
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = nvidia_smi()
    say("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), smi=f"'{smi}'",
        torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0])

    # ---- 2. build ----
    t = time.perf_counter()
    libs = build.build_all()
    say("build", seconds=f"{time.perf_counter() - t:.2f}",
        libs=",".join(p.name for p in libs.values()))
    for p in libs.values():
        for line in p.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                say("build", ptxas=f"'{line.strip()}'")

    # ---- 3. kernels against their twins at the main path's width ----
    rounds = p3.sharded_phase3_schedule(N_MAIN // 2, PARTS)["doubling_rounds"]
    table = check_kernels(dev, rounds)

    # ---- 4. small parity: cuda against cpu, every Phase 3 mode ----
    g = eulerian_rmat(8, avg_degree=AVG_DEGREE, seed=SEED)
    first = None
    for mode, opts in MODES.items():
        for device in ("cuda", "cpu"):
            r = solve(g, n_parts=2, device=device, **opts).validate()
            first = first or r
            same = (np.array_equal(first.circuit, r.circuit)
                    and np.array_equal(first.mate, r.mate))
            say("parity", scale=8, parts=2, edges=g.num_edges, mode=mode,
                device=device, byte_identical=same)
            if not same:
                raise AssertionError(f"{mode} solve on {device} differs")

    # ---- 5. the main path: sharded (the default), then replicated ----
    t = time.perf_counter()
    g = eulerian_rmat(args.scale, avg_degree=AVG_DEGREE, seed=SEED)
    gen_s = time.perf_counter() - t
    say("slice", scale=args.scale, parts=PARTS, vertices=g.num_vertices,
        edges=g.num_edges, graphgen_s=f"{gen_s:.2f}")
    launches, results = {}, {}
    for sharded in (True, False):
        res, counts, peak = solve_counted(g, sharded_phase3=sharded)
        res.validate()
        e_cap = g.num_edges + res.padded_edges
        schedule = p3.sharded_phase3_schedule(e_cap, PARTS)
        rounds = schedule["doubling_rounds"]
        want = {name: 0 for name in KERNELS}
        want.update({name: rounds * (PARTS if sharded else 1)
                     for name in PATH_KERNELS[sharded]})
        twin = strip_circuit(circuit_from_mate_np(res.mate, 0), g.num_edges)
        matches = np.array_equal(twin, res.circuit)
        say("slice", phase3="sharded" if sharded else "replicated",
            e_cap=e_cap, supersteps=res.supersteps, valid=res.valid,
            matches_numpy_twin=matches,
            launches=json.dumps(counts, separators=(",", ":")),
            peak_gib=f"{peak / 2**30:.3f}",
            **{k: f"{v:.3f}" for k, v in res.timings.items()})
        if not matches:
            raise AssertionError("circuit differs from the numpy list-rank "
                                 "twin")
        if counts != want:
            raise AssertionError(f"launches {counts}, expected {want}")
        for name in PATH_KERNELS[sharded]:
            launches[name] = counts[name]
        results[sharded] = res
    same = (np.array_equal(results[True].circuit, results[False].circuit)
            and np.array_equal(results[True].mate, results[False].mate))
    say("slice", sharded_equals_replicated=same)
    if not same:
        raise AssertionError("sharded and replicated solves differ")

    print(json.dumps({"kernels": [
        {"name": name, **KERNELS[name], "launches": launches[name],
         **table[name]}
        for name in KERNELS]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
