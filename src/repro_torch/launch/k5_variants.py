"""Time variants of K5's tile and load sizes on the card, in turns, beside
``torch.segment_reduce``: the measurement behind the constants of
``kernels/csrc/segment_reduce.cu``.  It has no counterpart in the
reference, whose Pallas K5 (``repro/kernels/segment_reduce.py``) has only
its rows per block to set.

    PYTHONPATH=src python -m repro_torch.launch.k5_variants

Each variant is the committed source with one text substitution, built by
``nvcc`` (the flags of :mod:`repro_torch.kernels.build`) into
``build/kernels/variants/`` and called through its C entry points:

  * ``committed``: the source as it is;
  * ``tile64k`` / ``tile256k``: tiles of about 64 or 256 KB of rows
    (committed: 128);
  * ``batch64`` / ``batch256``: 64 or 256 bytes loaded ahead by a thread
    (committed: 128);
  * ``blocks1``: 1 resident block an SM must fit, not 2 (the register cap
    of ``__launch_bounds__``);
  * ``load_nc`` / ``load_l2_128`` / ``load_no_l1``: the values' loads
    without the 256-byte L2 prefetch, with a 128-byte one, or also not
    kept in L1;
  * ``tile96k`` / ``tile192k`` / ``batch192``: sizes between those above;
  * ``warp_teams``: a team rounded up to whole warps, its extra lanes idle
    (no warp serves two tiles).

The shapes are ``chip_smoke.py``'s ogb_products aggregation (N =
61,859,140 rows, D = 100, S = 2,449,029): f32 on uniform ids, f32 on
skewed ids ``floor(S·u²)``, bf16 on uniform ids.  Every variant is first
held against the plain twin on the f32 uniform case (``allclose`` at
1e-5, atol 8e-5, as ``chip_smoke.py``); then each shape times every
variant and the library call three times in alternating order, and
prints the least and the most milliseconds of the three.  Needs a CUDA
device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys

import torch

from ..configs.base import gnn_shapes
from ..kernels import build, ref
from ..kernels import segment_reduce as sr

CONSTANTS = {
    "tile": "constexpr int64_t kTileBytes = 131072;",
    "batch": "constexpr int kBatchBytes = 128;",
    "blocks": "constexpr int kMinBlocks = 2;",
    "load": '#define K5_LOAD "ld.global.nc.L2::256B"',
    "team": "  lv.team = vcols < kThreads ? static_cast<int>(vcols) : kThreads;",
}


def variants(src: str) -> dict:
    """name → source text of every variant."""
    missing = [k for k, text in CONSTANTS.items() if text not in src]
    if missing:
        raise RuntimeError(f"segment_reduce.cu no longer has the text the "
                           f"variants substitute: {missing}")

    def sub(key: str, value: int) -> str:
        old = CONSTANTS[key]
        return src.replace(old, old.rsplit("=", 1)[0] + f"= {value};")

    load = CONSTANTS["load"]
    return {"committed": src, "tile64k": sub("tile", 65536),
            "tile256k": sub("tile", 262144), "batch64": sub("batch", 64),
            "batch256": sub("batch", 256), "blocks1": sub("blocks", 1),
            "load_nc": src.replace(load, '#define K5_LOAD "ld.global.nc"'),
            "load_l2_128": src.replace(
                load, '#define K5_LOAD "ld.global.nc.L2::128B"'),
            "load_no_l1": src.replace(
                load,
                '#define K5_LOAD "ld.global.nc.L1::no_allocate.L2::256B"'),
            "tile96k": sub("tile", 98304), "tile192k": sub("tile", 196608),
            "batch192": sub("batch", 192),
            "warp_teams": src.replace(CONSTANTS["team"], (
                "  lv.team = vcols < kThreads ? static_cast<int>((vcols + 31)"
                " / 32 * 32) : kThreads;"))}


def compile_all(texts: dict) -> dict:
    """name → (``sr_segment_sum_sorted``, ``sr_workspace_bytes``) of each
    variant, built by one ``nvcc`` each, all started together."""
    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        cu = out / f"k5_{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o",
             str(out / f"k5_{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name}: nvcc failed\n{log}")
        regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers",
                                                  log)})
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores",
                                                log))
        print(f"[variants] built=k5_{name} registers={regs} "
              f"spill_store_bytes={spills}", flush=True)
        lib = ctypes.CDLL(str(out / f"k5_{name}.so"))
        run, work = lib.sr_segment_sum_sorted, lib.sr_workspace_bytes
        run.argtypes, work.argtypes = list(sr._ARGS), list(sr._WORK_ARGS)
        run.restype = work.restype = ctypes.c_int
        fns[name] = (run, work)
    return fns


def ms_per_call(fn, iters: int = 5) -> float:
    for _ in range(2):
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


def caller(fns, values, ids, s: int):
    """name → a call of that variant on ``values``/``ids`` into one
    output, with its own workspace."""
    n, d = values.shape
    out = torch.empty(s, d, dtype=values.dtype, device=values.device)
    dtype = sr.DTYPES[values.dtype]
    calls = {}
    for name, (run, work) in fns.items():
        size = ctypes.c_longlong()
        if work(n, d, dtype, ctypes.byref(size)):
            raise RuntimeError(f"variant {name}: no workspace size")
        buf = torch.empty(size.value, dtype=torch.uint8,
                          device=values.device)

        def call(run=run, buf=buf):
            err = run(values.data_ptr(), ids.data_ptr(), out.data_ptr(), n, d,
                      s, dtype, buf.data_ptr() if buf.numel() else None,
                      torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed with CUDA error {err}")
            return out

        calls[name] = call
    return calls


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        print("k5_variants: no CUDA device", file=sys.stderr)
        return 2
    fns = compile_all(variants((build.CSRC / "segment_reduce.cu")
                               .read_text()))
    cell = gnn_shapes()["ogb_products"]
    n, d, s = cell.n_edges, cell.d_feat, cell.n_nodes
    gen = torch.Generator(device="cuda").manual_seed(0)
    uniform = torch.sort(torch.randint(0, s, (n,), generator=gen,
                                       device="cuda")).values.to(torch.int32)
    u = torch.rand(n, generator=gen, device="cuda", dtype=torch.float64)
    skewed = torch.sort((u * u * s).floor_().clamp_(max=s - 1)
                        .to(torch.int32)).values
    del u
    values = torch.randn(n, d, generator=gen, device="cuda")
    want = ref.segment_sum_sorted_ref(values, uniform, s)
    for name, call in caller(fns, values, uniform, s).items():
        if not torch.allclose(call(), want, rtol=1e-5, atol=8e-5):
            raise AssertionError(f"variant {name} differs from the twin")
    del want
    for label, ids in (("f32_uniform", uniform), ("f32_skewed", skewed),
                       ("bf16_uniform", uniform)):
        if label == "bf16_uniform":
            values = values.bfloat16()
            torch.cuda.empty_cache()
        calls = caller(fns, values, ids, s)
        lengths = torch.bincount(ids, minlength=s)
        times = {name: [] for name in (*calls, "segment_reduce")}
        for turn in range(3):
            names = list(calls) if turn % 2 == 0 else list(calls)[::-1]
            for name in names:
                times[name].append(ms_per_call(calls[name]))
            times["segment_reduce"].append(ms_per_call(
                lambda: torch.segment_reduce(values, "sum", lengths=lengths,
                                             axis=0)))
        print(f"[variants] shape=ogb_products_{label} "
              + " ".join(f"{k}_ms={min(t):.4f}/{max(t):.4f}"
                         for k, t in times.items()), flush=True)
        del calls
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
