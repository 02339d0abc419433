"""Request-serving drivers (mirrors ``repro/launch/serve.py``).

The LM prefill + KV-cache decode driver (the reference's ``main_lm``) is
ported; its body is :func:`serve_lm`, which callers can drive with any
config, prompts and weights:

    PYTHONPATH=src python -m repro_torch.launch.serve --workload lm \\
        --arch smollm-360m --batch 4 --prompt-len 64 --gen 32 [--device cpu]

Like the reference, the CLI serves the reduced config with seeded random
weights.  It runs on ``cuda`` unless given ``--device cpu`` and raises
when there is no card.  The Euler workload (the reference's default,
``main_euler`` with its ``MicroBatcher``) is not ported yet (ROADMAP
queue 1 item 10).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Optional

import numpy as np
import torch

from ..configs.registry import get_config
from ..euler.solver import resolve_device
from ..models.transformer import (LMConfig, Params, decode_step,
                                  init_kv_cache, init_lm_params,
                                  prefill_step)


@dataclasses.dataclass
class ServeResult:
    """What :func:`serve_lm` returns.  Seconds are read after the device
    drained."""
    ids: np.ndarray                 # [B, gen] int32 greedy tokens
    prefill_s: float                # prefill + widening the cache
    decode_s: float                 # gen − 1 decode steps
    decode_tok_s: float             # B · (gen − 1) / decode_s


def _drain(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_lm(cfg: LMConfig, prompts, gen: int, device=None,
             params: Optional[Params] = None) -> ServeResult:
    """Greedy batched serving: prefill ``prompts`` [B, P] (int token ids),
    widen the KV cache to P + gen positions, then decode ``gen − 1`` more
    tokens one step at a time.  ``params`` default to
    ``init_lm_params`` from a CPU generator seeded with 0."""
    device = resolve_device(device)
    if params is None:
        params = init_lm_params(torch.Generator().manual_seed(0), cfg,
                                device)
    prompts = torch.as_tensor(prompts, device=device)
    batch, prompt_len = prompts.shape
    max_len = prompt_len + gen

    _drain(device)
    t0 = time.perf_counter()
    logits, cache = prefill_step(params, cfg, prompts)
    full = init_kv_cache(cfg, batch, max_len, device=device)
    full.k[:, :, :prompt_len] = cache.k
    full.v[:, :, :prompt_len] = cache.v
    cache = full._replace(length=cache.length)
    _drain(device)
    t_prefill = time.perf_counter() - t0

    toks = torch.argmax(logits, -1).to(torch.int32)
    out = [toks]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = decode_step(params, cfg, cache, toks)
        toks = torch.argmax(logits, -1).to(torch.int32)
        out.append(toks)
    _drain(device)
    t_decode = time.perf_counter() - t0

    ids = torch.stack(out, 1).cpu().numpy()
    return ServeResult(
        ids=ids, prefill_s=t_prefill, decode_s=t_decode,
        decode_tok_s=batch * (gen - 1) / max(t_decode, 1e-9))


def main_lm(argv=None):
    """Batched LM serving: prefill + decode with a KV cache on the
    reduced config (the reference's CLI and defaults)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the "
                         "kernels' plain twins)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=True).model
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
    res = serve_lm(cfg, prompts.astype(np.int32), args.gen, args.device)
    print(f"prefill {args.batch}×{args.prompt_len} in {res.prefill_s:.2f}s; "
          f"decode {args.gen-1} steps at {res.decode_tok_s:.1f} tok/s")
    print("generated ids (first seq):", res.ids[0][:16])
    if res.ids.shape != (args.batch, args.gen):
        raise RuntimeError(f"generated {res.ids.shape}, expected "
                           f"{(args.batch, args.gen)}")
    return res.ids


def main_euler(argv=None):
    raise NotImplementedError(
        "the Euler serving workload (MicroBatcher) is not ported yet "
        "(ROADMAP queue 1 item 10); use --workload lm")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--workload", choices=("euler", "lm"), default="euler",
                    help="request-serving workload (default: euler, not "
                         "ported yet)")
    args, rest = ap.parse_known_args(argv)
    return main_lm(rest) if args.workload == "lm" else main_euler(rest)


if __name__ == "__main__":
    main()
