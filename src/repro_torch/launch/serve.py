"""Request-serving drivers (mirrors ``repro/launch/serve.py``).

The LM prefill + KV-cache decode driver (the reference's ``main_lm``) is
ported; its body is :func:`serve_lm`, which callers can drive with any
config, prompts and weights:

    PYTHONPATH=src python -m repro_torch.launch.serve --workload lm \\
        --arch smollm-360m --batch 4 --prompt-len 64 --gen 32 [--device cpu]

Like the reference, the CLI serves the reduced config with seeded random
weights.  It runs on ``cuda`` unless given ``--device cpu`` and raises
when there is no card.

Two execution modes, as for the Euler solver.  ``fused=True`` (the
default) is the reference's: ``main_lm`` jits the prefill and the decode
step (the decode donating its cache); here each becomes one CUDA graph
(:class:`LMPrograms`), recorded once per serving shape after one eager
warm-up and replayed, in place over static buffers.  ``fused=False`` is
the eager oracle: every op launched from Python.  Both give the same
bits.  The Euler workload (the reference's default, ``main_euler`` with
its ``MicroBatcher``) is not ported yet (ROADMAP queue 1 item 6).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..configs.registry import get_config
from ..core import capture
from ..core.engine import drained_clock
from ..euler.solver import resolve_device
from ..kernels import ops
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
    logits: torch.Tensor            # [B, V] the last step's, on the device
    warmup_s: float = 0.0           # the eager warm-up before a recording
    capture_s: float = 0.0          # recording both graphs
    captures: int = 0               # recordings of the programs served


class LMPrograms:
    """One serving shape's prefill and decode step, each recorded once as
    a CUDA graph and replayed (the reference's jitted ``prefill`` and
    ``decode`` in ``main_lm``).

    A shape is the config, the weights (the graphs hold their
    addresses), the batch B, the prompt length P and ``gen``: the cache
    holds T = P + gen positions.  The static buffers are the prompts
    ``[B, P]``, the fed tokens ``[B]``, the widened cache
    (``init_kv_cache(cfg, B, T)``, written in place: the counterpart of
    the reference's donated cache) and the generated ids ``[B, gen]``,
    all int32 but the cache.  The prefill program runs ``prefill_step``,
    copies its cache into the widened one (zeroing the positions past
    P, as a fresh cache has them), sets the length and writes the first
    greedy token into the tokens and ids column 0.  The decode program
    runs ``decode_step`` on the tokens, writes the new length, and writes
    the next greedy token into the tokens and into the ids column it
    belongs to (length − P), so it replays unchanged for every step.

    :meth:`ready` builds the kernel libraries, runs both bodies once
    eagerly on a side stream (lazy loading, cuBLAS's first choice of
    kernels and the allocator's growth happen there), then records both
    through :func:`~repro_torch.core.capture.recording`: a host read in
    either raises; nothing falls back to eager.  ``captures`` counts
    recordings (one for the pair), ``recorded`` the K1–K6 launches each
    graph holds.  On the CPU the same bodies run uncaptured on the same
    buffers, and nothing is recorded."""

    def __init__(self, cfg: LMConfig, params: Params, batch: int,
                 prompt_len: int, gen: int, device=None):
        if min(batch, prompt_len, gen) < 1:
            raise ValueError(f"LMPrograms: batch {batch}, prompt length "
                             f"{prompt_len} and gen {gen} must be ≥ 1")
        self.device = resolve_device(device)
        self.cfg, self.params = cfg, params
        self.shape = (batch, prompt_len, gen)
        i32 = dict(dtype=torch.int32, device=self.device)
        self.prompts = torch.zeros((batch, prompt_len), **i32)
        self.tokens = torch.zeros((batch,), **i32)
        self.cache = init_kv_cache(cfg, batch, prompt_len + gen,
                                   device=self.device)
        self.ids = torch.zeros((batch, gen), **i32)
        self.prefill_logits: Optional[torch.Tensor] = None   # [B, V]
        self.logits: Optional[torch.Tensor] = None           # [B, V]
        self.graphs: Optional[Tuple["torch.cuda.CUDAGraph", ...]] = None
        self.captures = 0
        self.recorded: Dict[str, Dict[str, int]] = {}

    def check(self, cfg: LMConfig, params: Params, batch: int,
              prompt_len: int, gen: int, device: torch.device) -> None:
        """Raise ``ValueError`` unless a call of this shape, weights and
        device can replay these programs."""
        if (cfg != self.cfg or params is not self.params
                or (batch, prompt_len, gen) != self.shape
                or device != self.device):
            raise ValueError(
                f"these programs serve {self.cfg.name} on {self.device} at "
                f"B, P, gen = {self.shape} with the weights they were made "
                f"with; got {cfg.name} on {device} at "
                f"{(batch, prompt_len, gen)}"
                + ("" if params is self.params else " and other weights")
                + ": make LMPrograms for that shape")

    def _prefill_body(self) -> torch.Tensor:
        P = self.shape[1]
        logits, cache = prefill_step(self.params, self.cfg, self.prompts)
        for full, part in ((self.cache.k, cache.k), (self.cache.v, cache.v)):
            full[:, :, :P].copy_(part)
            full[:, :, P:].zero_()
        self.cache.length.copy_(cache.length)
        first = torch.argmax(logits, -1).to(torch.int32)
        self.tokens.copy_(first)
        self.ids[:, 0].copy_(first)
        return logits

    def _decode_body(self) -> torch.Tensor:
        logits, cache = decode_step(self.params, self.cfg, self.cache,
                                    self.tokens)
        self.cache.length.copy_(cache.length)
        nxt = torch.argmax(logits, -1).to(torch.int32)
        self.tokens.copy_(nxt)
        col = (cache.length - self.shape[1]).long()[:, None]
        self.ids.scatter_(1, col, nxt[:, None])
        return logits

    def _warm_up(self) -> None:
        """Both bodies once, eagerly, on a side stream."""
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._prefill_body()
            self._decode_body()
        torch.cuda.current_stream(dev).wait_stream(side)

    def _record(self, body):
        """Record ``body`` into a new graph; returns (graph, its static
        output, the K1–K6 launches recorded)."""
        graph = torch.cuda.CUDAGraph()
        before = ops.launch_counts()
        with capture.recording(graph):
            out = body()
        after = ops.launch_counts()
        return graph, out, {k: after[k] - before[k] for k in after}

    def ready(self) -> Tuple[float, float]:
        """Warm up and record both programs unless they are recorded (or
        on the CPU, which records nothing).  Returns (warm-up s, capture
        s), each read after the device drained; 0.0 each when nothing was
        recorded."""
        if self.graphs is not None or self.device.type != "cuda":
            return 0.0, 0.0
        from ..kernels import build

        dev = self.device
        build.build_all()
        t0 = drained_clock(dev)
        self._warm_up()
        t1 = drained_clock(dev)
        pre, self.prefill_logits, self.recorded["prefill"] = \
            self._record(self._prefill_body)
        dec, self.logits, self.recorded["decode"] = \
            self._record(self._decode_body)
        self.graphs = (pre, dec)
        self.captures += 1
        return t1 - t0, drained_clock(dev) - t1

    def load(self, prompts: torch.Tensor) -> None:
        """Copy a batch of prompts ``[B, P]`` into the static prompts."""
        if tuple(prompts.shape) != tuple(self.prompts.shape):
            raise ValueError(f"prompts {tuple(prompts.shape)}, these "
                             f"programs take {tuple(self.prompts.shape)}")
        self.prompts.copy_(prompts)

    def _replayed(self, which: int) -> bool:
        """Replay graph ``which`` (0 prefill, 1 decode) if recorded; on a
        card unrecorded programs raise rather than run eagerly."""
        if self.graphs is not None:
            self.graphs[which].replay()
            return True
        if self.device.type == "cuda":
            raise RuntimeError("these programs are not recorded yet: call "
                               "ready() first")
        return False

    def prefill(self) -> None:
        """Prefill the loaded prompts and widen the cache: a replay."""
        if not self._replayed(0):
            self.prefill_logits = self._prefill_body()

    def decode(self) -> None:
        """One decode step from the static tokens: a replay."""
        if not self._replayed(1):
            self.logits = self._decode_body()


def serve_lm(cfg: LMConfig, prompts, gen: int, device=None,
             params: Optional[Params] = None, fused: bool = True,
             programs: Optional[LMPrograms] = None) -> ServeResult:
    """Greedy batched serving: prefill ``prompts`` [B, P] (int token ids),
    widen the KV cache to P + gen positions, then decode ``gen − 1`` more
    tokens one step at a time.  ``params`` default to ``programs``' or to
    ``init_lm_params`` from a CPU generator seeded with 0.

    ``fused=True`` replays the two programs of :class:`LMPrograms`:
    ``programs`` from an earlier call of the same shape and weights
    replays without recording (another shape raises ``ValueError``);
    without it a new one is made and records first.  A decode step is
    one replay, with no host read; the ids come back once, after the
    last.  ``fused=False`` launches every op from Python (the oracle)."""
    device = resolve_device(device)
    if params is None:
        params = (programs.params if programs is not None else
                  init_lm_params(torch.Generator().manual_seed(0), cfg,
                                 device))
    prompts = torch.as_tensor(prompts, device=device)
    batch, prompt_len = prompts.shape
    if not fused:
        if programs is not None:
            raise ValueError("programs are replayed only with fused=True")
        return _serve_eager(cfg, params, prompts, gen, device)
    if programs is None:
        programs = LMPrograms(cfg, params, batch, prompt_len, gen, device)
    programs.check(cfg, params, batch, prompt_len, gen, device)
    programs.load(prompts)
    warm_s, cap_s = programs.ready()

    t0 = drained_clock(device)
    programs.prefill()
    t1 = drained_clock(device)
    for _ in range(gen - 1):
        programs.decode()
    t2 = drained_clock(device)

    last = programs.logits if gen > 1 else programs.prefill_logits
    return ServeResult(
        ids=programs.ids.cpu().numpy(), prefill_s=t1 - t0,
        decode_s=t2 - t1, decode_tok_s=batch * (gen - 1) / max(t2 - t1, 1e-9),
        logits=last.clone(), warmup_s=warm_s, capture_s=cap_s,
        captures=programs.captures)


def _serve_eager(cfg: LMConfig, params: Params, prompts: torch.Tensor,
                 gen: int, device: torch.device) -> ServeResult:
    batch, prompt_len = prompts.shape
    max_len = prompt_len + gen

    t0 = drained_clock(device)
    logits, cache = prefill_step(params, cfg, prompts)
    full = init_kv_cache(cfg, batch, max_len, device=device)
    full.k[:, :, :prompt_len] = cache.k
    full.v[:, :, :prompt_len] = cache.v
    cache = full._replace(length=cache.length)
    t_prefill = drained_clock(device) - t0

    toks = torch.argmax(logits, -1).to(torch.int32)
    out = [toks]
    t0 = drained_clock(device)
    for _ in range(gen - 1):
        logits, cache = decode_step(params, cfg, cache, toks)
        toks = torch.argmax(logits, -1).to(torch.int32)
        out.append(toks)
    t_decode = drained_clock(device) - t0

    ids = torch.stack(out, 1).cpu().numpy()
    return ServeResult(
        ids=ids, prefill_s=t_prefill, decode_s=t_decode,
        decode_tok_s=batch * (gen - 1) / max(t_decode, 1e-9), logits=logits)


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
        "(ROADMAP queue 1 item 6); use --workload lm")


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
