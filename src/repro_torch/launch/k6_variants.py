"""Time variants of K6's bf16 schedule on the card, in turns, beside
``scaled_dot_product_attention``: the measurement behind the pipeline
depth and the consumer loop of ``kernels/csrc/flash_attention.cu``.  It
has no counterpart in the reference, whose Pallas K6
(``repro/kernels/flash_attention.py``) has only its block sizes to set.

    PYTHONPATH=src python -m repro_torch.launch.k6_variants

Each variant is the committed source with one text substitution, built by
``nvcc`` (the flags of :mod:`repro_torch.kernels.build`) into
``build/kernels/variants/`` and called through its C entry point:

  * ``pipelined``: the source as it is;
  * ``serial``: the consumer loop waits for each product before the next
    (QK, softmax, PV, in turn), with the same helpers;
  * ``stages2`` / ``stages4``: the pipelined loop with a ring of 2 or 4
    stages at D <= 64 (D 128 keeps 2).

Every variant is first held against the plain twin (``scaled_err`` within
5e-2, as ``chip_smoke.py``); then each shape times every variant and SDPA
three times in alternating order, and prints the least and the most
milliseconds of the three.  Needs a CUDA device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import torch
import torch.nn.functional as F

from ..kernels import build, ref
from ..kernels import flash_attention as fa

STAGES = "static constexpr int kStages = D == 128 ? 2 : 3;"
PIPELINE = "    // Software pipeline:"
LOOP_END = "    // the tile past this warpgroup"
SERIAL = """    mbar_wait(q_bar, 0);
    for (int j = 0; j < my_tiles; ++j) {
      const int st = j % C::kStages;
      mbar_wait(full + 8 * st, (j / C::kStages) & 1);
      issue_qk<D>(s, q_wg, kv_s + st * C::kStageBytes);
      wgmma_wait<0>();
      fence_regs(s);
      softmax_tile(s, sh, rw, j * kBc, m, l, alpha);
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        acc[4 * c] *= alpha[0];
        acc[4 * c + 1] *= alpha[0];
        acc[4 * c + 2] *= alpha[1];
        acc[4 * c + 3] *= alpha[1];
      }
      to_fragments(s, pa);
      issue_pv<D>(acc, pa, kv_s + st * C::kStageBytes + C::kTileBytes);
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
    }
"""
#: (B, S = T, Hq, Hkv, D), causal: the serving prefill and the checks'
#: D 128 and D 32 shapes
SHAPES = ((4, 4096, 15, 5, 64), (1, 4096, 8, 2, 128), (2, 2048, 6, 2, 32))


def variants(src: str) -> dict:
    """name → source text of every variant."""
    if STAGES not in src or PIPELINE not in src or LOOP_END not in src:
        raise RuntimeError("flash_attention.cu no longer has the text the "
                           "variants substitute")
    cut = src[src.index(PIPELINE):src.index(LOOP_END)]
    return {
        "pipelined": src,
        "serial": src.replace(cut, SERIAL),
        "stages2": src.replace(STAGES, "static constexpr int kStages = 2;"),
        "stages4": src.replace(
            STAGES, "static constexpr int kStages = D == 128 ? 2 : 4;"),
    }


def compile_all(texts: dict) -> dict:
    """name → loaded ``fa_flash_attention`` of each variant, built by one
    ``nvcc`` each, all started together."""
    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        cu = out / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name}: nvcc failed\n{log}")
        notes = sorted({ln.strip() for ln in log.splitlines() if "C75" in ln})
        print(f"[variants] built={name} ptxas_notes={notes}", flush=True)
        fn = ctypes.CDLL(str(out / f"{name}.so")).fa_flash_attention
        fn.argtypes = list(fa._ARGS)
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def ms_per_call(fn, iters: int = 30) -> float:
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


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        print("k6_variants: no CUDA device", file=sys.stderr)
        return 2
    fns = compile_all(variants((build.CSRC / "flash_attention.cu")
                               .read_text()))
    for B, S, Hq, Hkv, D in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn(B, S, h, D, generator=gen, device="cuda")
                   .bfloat16() for h in (Hq, Hkv, Hkv))
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream

        def run(fn):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     B, S, S, Hq, Hkv, D, 1, fa.DTYPES[torch.bfloat16],
                     stream)
            if err:
                raise RuntimeError(f"launch failed with CUDA error {err}")

        rep = Hq // Hkv
        want = ref.flash_attention_ref(q, k.repeat_interleave(rep, 2),
                                       v.repeat_interleave(rep, 2))
        for name, fn in fns.items():
            run(fn)
            g, w = out.float(), want.float()
            rms = w.pow(2).mean(-1, keepdim=True).sqrt().clamp_min(1e-30)
            err = float(((g - w).abs() / (w.abs() + rms)).max())
            if not err <= 5e-2:
                raise AssertionError(f"variant {name} at D {D}: scaled "
                                     f"error {err}")
        del want
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        times = {name: [] for name in (*fns, "sdpa")}
        for turn in range(3):
            names = list(fns) if turn % 2 == 0 else list(fns)[::-1]
            for name in names:
                times[name].append(ms_per_call(lambda: run(fns[name])))
            times["sdpa"].append(ms_per_call(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)))
        print(f"[variants] shape=B{B}_S{S}_Hq{Hq}_Hkv{Hkv}_D{D} causal=True "
              + " ".join(f"{n}_ms={min(t):.4f}/{max(t):.4f}"
                         for n, t in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
