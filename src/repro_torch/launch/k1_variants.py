"""Time variants of K1's round on the card, in turns, beside the two-table
kernel K1 had before its records were packed and the packed twin: the
measurement behind K1's design in ``kernels/csrc/pointer_double.cu``.  It
has no counterpart in the reference, whose Pallas K1
(``repro/kernels/pointer_double.py``) keeps the whole table in VMEM and
has only its block to set.

    PYTHONPATH=src python -m repro_torch.launch.k1_variants [--path-scale 20]

Each variant is the committed source with its K1 kernel and entry point
(two blocks of text) replaced by the variant's, built by ``nvcc`` (the
flags of :mod:`repro_torch.kernels.build`) into
``build/kernels/variants/`` and called through its C entry point
``pd_pointer_double``:

  * ``committed``: the source as it is;
  * ``plain``: one record a thread at a time, plain loads and stores;
  * ``items2`` / ``items4``: 2 or 4 records a thread, every own load
    issued, then every gather, then every store;
  * ``hints``: own records loaded evict-first in L2 and not kept in L1,
    gathers evict-last, stores evict-first (``createpolicy`` policies
    passed with ``.L2::cache_hint``); ``hints_half``: the same with the
    gathers' evict-last on half the lines; ``hints_far``: only the
    gathers evict-last; ``hints_store``: only the stores evict-first;
    ``items4_hints``: ``items4`` with ``hints``;
  * ``window``: a persisting-L2 access-policy window over the gathered
    table (the device's largest persisting share, ``hitRatio`` = that
    share over the table), set on the stream before the launch and
    cleared after, the persisting lines reset and the limit put back;
  * ``passes2`` / ``passes2_hints``: two launches, each serving the
    queries whose ``nxt`` lies in one half of the table, without and
    with ``hints``;

and ``two_table`` is the kernel on two int32 arrays (two 4-byte gathers
an element) that K1 was before its records were packed.  Two probes,
timed but not checked, split a round into its parts: ``probe_stream``
(own records in and results out, no gather: the traffic the bound
counts) and ``probe_gather`` (own records in and the gathers, no
store).  A variant that ``nvcc`` refuses is reported and left out; the
committed source must build.

Two inputs, each held bit-equal to the packed twin for every variant
before any timing:

  * ``cycle``: ``chip_smoke.py``'s seeded one-cycle permutation at
    N = 8,388,608 (records ``(succ, i)``), one round, timed repeated;
  * ``path``: K1's first input in the replicated solve of the main path
    (Eulerian RMAT, average degree 5, seed 0, 8 partitions, scale
    ``--path-scale``; captured from the solve on the card, never from a
    file), then the solve's chain of rounds from it (24 at scale 20),
    timed whole and printed per round.  ``--path-scale 0`` leaves it out;
  * ``one``: a single record, one round: the cost of a call itself.

Each input times every variant, the probes, the two-table kernel and the
twin three times in alternating order and prints the least and the most
milliseconds of the three.  Needs a CUDA device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from unittest import mock

import numpy as np
import torch

from ..core import phase3 as p3
from ..euler import solve
from ..graphgen.eulerize import eulerian_rmat
from ..kernels import build, ref

#: chip_smoke.py's K1 size: the main path's 2 · 4,194,304 stubs
N_CYCLE = 2 * 4_194_304
KERNEL = "// K1 on records rec[i] = (nxt, lab)"
KERNEL_END = "__global__ void __launch_bounds__(kThreads)\npointer_double_rank_kernel("
ENTRY = "// rec and rec_out: n records (nxt, lab)"
ENTRY_END = "// rec and rec_out: n records of 4 int32"
#: L2 eviction policies of the hint variants, by name
POLICY = {"first": "createpolicy.fractional.L2::evict_first.b64 %0, 1.0;",
          "last": "createpolicy.fractional.L2::evict_last.b64 %0, 1.0;",
          "last_half": "createpolicy.fractional.L2::evict_last.b64 %0, 0.5;"}
HELPERS = r"""__device__ __forceinline__ int2 ld_hint(const int2* p, uint64_t pol) {
  int2 v;
  asm volatile("ld.global.nc.L2::cache_hint.v2.s32 {%0, %1}, [%2], %3;"
               : "=r"(v.x), "=r"(v.y) : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ int2 ld_hint_no_l1(const int2* p, uint64_t pol) {
  int2 v;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::cache_hint.v2.s32 {%0, %1}, [%2], %3;"
      : "=r"(v.x), "=r"(v.y) : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ void st_hint(int2* p, int2 v, uint64_t pol) {
  asm volatile("st.global.L2::cache_hint.v2.s32 [%0], {%1, %2}, %3;"
               :: "l"(p), "r"(v.x), "r"(v.y), "l"(pol) : "memory");
}
"""
WINDOW = r"""static cudaError_t l2_window_on(const void* rec, long long n,
                                cudaStream_t stream) {
  int dev = 0, persist = 0, window = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(
           &persist, cudaDevAttrMaxPersistingL2CacheSize, dev)) !=
          cudaSuccess ||
      (err = cudaDeviceGetAttribute(
           &window, cudaDevAttrMaxAccessPolicyWindowSize, dev)) !=
          cudaSuccess ||
      (err = cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize,
                                static_cast<size_t>(persist))) !=
          cudaSuccess) {
    return err;
  }
  const size_t bytes = static_cast<size_t>(n) * sizeof(int2);
  const size_t span =
      bytes < static_cast<size_t>(window) ? bytes : static_cast<size_t>(window);
  cudaStreamAttrValue attr = {};
  attr.accessPolicyWindow.base_ptr = const_cast<void*>(rec);
  attr.accessPolicyWindow.num_bytes = span;
  attr.accessPolicyWindow.hitRatio =
      span > static_cast<size_t>(persist)
          ? static_cast<float>(persist) / static_cast<float>(span)
          : 1.0f;
  attr.accessPolicyWindow.hitProp = cudaAccessPropertyPersisting;
  attr.accessPolicyWindow.missProp = cudaAccessPropertyStreaming;
  return cudaStreamSetAttribute(stream, cudaStreamAttributeAccessPolicyWindow,
                                &attr);
}
static cudaError_t l2_window_off(cudaStream_t stream, size_t prior) {
  cudaStreamAttrValue attr = {};
  cudaError_t err = cudaStreamSetAttribute(
      stream, cudaStreamAttributeAccessPolicyWindow, &attr);
  const cudaError_t reset = cudaCtxResetPersistingL2Cache();
  const cudaError_t limit =
      cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, prior);
  if (err == cudaSuccess) err = reset;
  return err == cudaSuccess ? limit : err;
}
"""


def kernel_text(items: int = 1, own=None, far=None, put=None,
                probe=None) -> str:
    """The K1 kernel block of a variant: ``items`` records a thread, each
    access plain (None) or with the named L2 policy (``own`` also not
    kept in L1); it serves the queries whose nxt lies in [lo, hi).  A
    ``probe`` drops a part of the round: ``"stream"`` the gather (the
    own record stands in for the far one), ``"gather"`` the store (kept
    only under a condition no valid input meets)."""
    pols = {k: v for k, v in (("own", own), ("far", far), ("put", put)) if v}
    decl = "".join(f'  uint64_t pol_{k};\n  asm("{POLICY[v]}" : "=l"(pol_{k}));\n'
                   for k, v in pols.items())
    ld_own = "ld_hint_no_l1(rec + i, pol_own)" if own else "__ldg(rec + i)"
    ld_far = ("ld_hint(rec + own[k].x, pol_far)" if far
              else "__ldg(rec + own[k].x)")
    value = "make_int2(far[k].x, far[k].y < own[k].y ? far[k].y : own[k].y)"
    store = (f"st_hint(out + i, {value}, pol_put)" if put
             else f"out[i] = {value}")
    if probe == "stream":
        ld_far = "own[k]"
    elif probe == "gather":
        store = f"if (far[k].x < 0) {store}"
    return (KERNEL + " (variant).\n" + (HELPERS if pols else "") + f"""
__global__ void __launch_bounds__(kThreads)
pointer_double_kernel(const int2* __restrict__ rec, int2* __restrict__ out,
                      int64_t n, int32_t lo, int32_t hi) {{
{decl}  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i0 = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
       i0 < n; i0 += stride * {items}) {{
    int2 own[{items}], far[{items}];
    bool mine[{items}];
#pragma unroll
    for (int k = 0; k < {items}; ++k) {{
      const int64_t i = i0 + k * stride;
      if (i < n) own[k] = {ld_own};
    }}
#pragma unroll
    for (int k = 0; k < {items}; ++k) {{
      const int64_t i = i0 + k * stride;
      mine[k] = i < n && own[k].x >= lo && own[k].x < hi;
      if (mine[k]) far[k] = {ld_far};
    }}
#pragma unroll
    for (int k = 0; k < {items}; ++k) {{
      const int64_t i = i0 + k * stride;
      if (mine[k]) {store};
    }}
  }}
}}

""")


def entry_text(items: int = 1, passes: int = 1, window: bool = False) -> str:
    """The K1 entry block of a variant: ``passes`` launches over table
    slices, optionally inside a persisting-L2 window."""
    launch = f"""  for (int p = 0; p < {passes} && err == cudaSuccess; ++p) {{
    pointer_double_kernel<<<grid_for((n + {items} - 1) / {items}), kThreads,
                            0, s>>>(
        static_cast<const int2*>(rec), static_cast<int2*>(rec_out), n,
        static_cast<int32_t>(n * p / {passes}),
        static_cast<int32_t>(n * (p + 1) / {passes}));
    err = cudaGetLastError();
  }}
"""
    if window:
        body = f"""  size_t prior = 0;
  cudaError_t err = cudaDeviceGetLimit(&prior, cudaLimitPersistingL2CacheSize);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = l2_window_on(rec, n, s);
{launch}  const cudaError_t off = l2_window_off(s, prior);
  return static_cast<int>(err != cudaSuccess ? err : off);
"""
    else:
        body = f"""  cudaError_t err = cudaSuccess;
{launch}  return static_cast<int>(err);
"""
    return (ENTRY + " (variant).\n" + (WINDOW if window else "") + f"""extern "C" int pd_pointer_double(const void* rec, void* rec_out,
                                 long long n, void* stream) {{
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
{body}}}

""")


TWO_TABLE = r"""// K1 on two int32 tables: one thread an element, two 4-byte gathers.
#include <cuda_runtime.h>
#include <cstdint>
namespace {
__global__ void __launch_bounds__(256)
pointer_double_kernel(const int32_t* __restrict__ nxt,
                      const int32_t* __restrict__ lab,
                      int32_t* __restrict__ nxt_out,
                      int32_t* __restrict__ lab_out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int32_t j = nxt[i];
    const int32_t own = lab[i];
    const int32_t far = lab[j];
    nxt_out[i] = nxt[j];
    lab_out[i] = far < own ? far : own;
  }
}
}  // namespace
extern "C" int pd_pointer_double(const void* nxt, const void* lab,
                                 void* nxt_out, void* lab_out, long long n,
                                 void* stream) {
  if (n <= 0) return 0;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long long need = (n + 255) / 256, cap = 64LL * sms;
  pointer_double_kernel<<<static_cast<int>(need < cap ? need : cap), 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(nxt), static_cast<const int32_t*>(lab),
      static_cast<int32_t*>(nxt_out), static_cast<int32_t*>(lab_out), n);
  return static_cast<int>(cudaGetLastError());
}
"""
#: names of the probes: parts of a round, timed but not checked
PROBE = "probe_"
#: the ``hints`` set: the coalesced streams evict-first, the gathers
#: evict-last
HINTS = {"own": "first", "far": "last", "put": "first"}


def variants(src: str) -> dict:
    """name → source text of every variant (``two_table`` included)."""
    for mark in (KERNEL, KERNEL_END, ENTRY, ENTRY_END):
        if mark not in src:
            raise RuntimeError(f"pointer_double.cu no longer has the text "
                               f"the variants replace: {mark!r}")
    kernel = src[src.index(KERNEL):src.index(KERNEL_END)]
    entry = src[src.index(ENTRY):src.index(ENTRY_END)]

    def make(items=1, passes=1, window=False, **kw):
        return (src.replace(kernel, kernel_text(items, **kw))
                .replace(entry, entry_text(items, passes, window)))

    return {
        "committed": src,
        "plain": make(),
        "items2": make(2),
        "items4": make(4),
        "hints": make(**HINTS),
        "hints_half": make(**{**HINTS, "far": "last_half"}),
        "hints_far": make(far="last"),
        "hints_store": make(put="first"),
        "items4_hints": make(4, **HINTS),
        "window": make(window=True),
        "passes2": make(passes=2),
        "passes2_hints": make(passes=2, **HINTS),
        "two_table": TWO_TABLE,
        "probe_stream": make(probe="stream"),
        "probe_gather": make(probe="gather"),
    }


def compile_all(texts: dict) -> dict:
    """name → loaded ``pd_pointer_double`` of each variant that builds,
    one ``nvcc`` each, all started together."""
    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        cu = out / f"k1_{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o",
             str(out / f"k1_{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            if name == "committed":
                raise RuntimeError(f"the committed K1 does not build\n{log}")
            print(f"[variants] failed={name} nvcc_exit={proc.returncode} "
                  f"log={log.strip()[-600:]!r}", flush=True)
            continue
        regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers",
                                                  log)})
        print(f"[variants] built=k1_{name} registers={regs}", flush=True)
        fn = ctypes.CDLL(str(out / f"k1_{name}.so")).pd_pointer_double
        n_ptrs = 4 if name == "two_table" else 2
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs
                       + [ctypes.c_longlong, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def ms_per_call(fn, iters: int) -> float:
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


def cycle_input() -> torch.Tensor:
    """``chip_smoke.py``'s seeded one-cycle records ``(succ, i)``."""
    order = np.random.default_rng(0).permutation(N_CYCLE)
    succ = np.empty(N_CYCLE, dtype=np.int32)
    succ[order] = np.roll(order, -1)
    nxt = torch.as_tensor(succ, device="cuda")
    return torch.stack([nxt, torch.arange(N_CYCLE, dtype=torch.int32,
                                          device="cuda")], 1)


def path_input(scale: int) -> torch.Tensor:
    """K1's first input records in the replicated solve of the main path
    at ``scale``, captured on the way into the wrapper."""
    g = eulerian_rmat(scale, avg_degree=5, seed=0)
    seen = []
    real = p3.pointer_double

    def capture(rec, out=None):
        if not seen:
            seen.append(rec.clone())
        return real(rec, out=out)

    with mock.patch.object(p3, "pointer_double", capture):
        solve(g, n_parts=8, device="cuda", sharded_phase3=False,
              fused=False)
    return seen[0]


def chain(fn, ins, bufs, rounds: int):
    """``rounds`` rounds of ``fn`` from ``ins``, ping-ponging ``bufs``
    (tuples of tensors); returns the last round's buffers."""
    cur = ins
    for r in range(rounds):
        out = bufs[r % 2]
        fn(*cur, *out)
        cur = out
    return cur


def runners(fns, rec: torch.Tensor):
    """name → ``(ins, bufs, fn(*ins, *outs))`` for every variant and the
    twin, on ``rec``; two-table inputs are ``rec``'s columns."""
    stream = torch.cuda.current_stream().cuda_stream
    n = rec.shape[0]

    def launch(fn):
        def run(*ts):
            err = fn(*(t.data_ptr() for t in ts), n, stream)
            if err:
                raise RuntimeError(f"launch failed with CUDA error {err}")
        return run

    def twin(r, o):
        o.copy_(ref.pointer_double_packed_ref(r))

    # buffers start as zeros (a probe's as copies of the input), so a
    # round that leaves some output unwritten still hands valid indices
    # to the next
    cols = tuple(rec[:, j].contiguous() for j in range(2))
    out = {}
    for name, fn in fns.items():
        ins = cols if name == "two_table" else (rec,)
        start = torch.clone if name.startswith(PROBE) else torch.zeros_like
        bufs = tuple(tuple(start(t) for t in ins) for _ in range(2))
        out[name] = (ins, bufs, launch(fn))
    out["twin"] = ((rec,), tuple((torch.empty_like(rec),) for _ in range(2)),
                   twin)
    return out


def as_records(ts) -> torch.Tensor:
    return ts[0] if len(ts) == 1 else torch.stack(ts, 1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path-scale", type=int, default=20,
                    help="RMAT scale of the solve whose K1 input is timed "
                         "(default 20, the main path; 0 leaves it out)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_variants: no CUDA device", file=sys.stderr)
        return 2
    fns = compile_all(variants((build.CSRC / "pointer_double.cu")
                               .read_text()))
    inputs = {"cycle": (cycle_input(), 1)}
    if args.path_scale:
        rec = path_input(args.path_scale)
        n = rec.shape[0]
        iota = torch.arange(n, dtype=torch.int32, device="cuda")
        near = ((rec[:, 0].long() - iota.long()).abs() < n // 8)
        print(f"[variants] input=path scale={args.path_scale} n={n} "
              f"self_loops={float((rec[:, 0] == iota).float().mean()):.4f} "
              f"within_n/8={float(near.float().mean()):.4f}", flush=True)
        inputs["path"] = (rec, p3._doubling_rounds(n))
    inputs["one"] = (torch.zeros(1, 2, dtype=torch.int32, device="cuda"), 1)
    for label, (rec, rounds) in inputs.items():
        calls = runners(fns, rec)
        want = None
        for name in ("twin", *fns):
            if name.startswith(PROBE):
                continue
            ins, bufs, fn = calls[name]
            got = as_records(chain(fn, ins, bufs, rounds))
            torch.cuda.synchronize()
            if want is None:
                want = got.clone()
            elif not torch.equal(got, want):
                raise AssertionError(f"variant {name} differs from the twin "
                                     f"on {label}")
        times = {name: [] for name in calls}
        iters = 20 if rounds == 1 else 3
        for turn in range(3):
            names = list(calls) if turn % 2 == 0 else list(calls)[::-1]
            for name in names:
                ins, bufs, fn = calls[name]
                times[name].append(ms_per_call(
                    lambda: chain(fn, ins, bufs, rounds), iters) / rounds)
        print(f"[variants] input={label} n={rec.shape[0]} rounds={rounds} "
              "ms_per_round(least/most) "
              + " ".join(f"{k}={min(t):.4f}/{max(t):.4f}"
                         for k, t in times.items()), flush=True)
        del calls
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
