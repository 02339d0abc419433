"""Request-serving drivers (mirrors ``repro/launch/serve.py``).

Default workload — the paper's own architecture behind the public facade
(:func:`main_euler`): an arrival-driven loop feeding a stream of
generated graphs through ONE persistent
:class:`repro_torch.euler.EulerSolver` session, scheduled by a
micro-batcher (:class:`MicroBatcher`): requests accumulate per bucket
and flush when a bucket reaches ``--max-batch`` or its oldest request
has waited ``--deadline-ms``.  Flushes dispatch asynchronously
(``solve_batch_async``/``solve_async``) through a ``--pipeline-depth``
window, so the host's prep and batching of the next flush overlap the
card's replay of this one; a partial flush is split over the batch
widths already recorded (the solver's width ladder, recorded by
``prewarm``) instead of falling back to one graph at a time.  After
warm-up every flush replays a recorded ``(bucket, B)`` CUDA graph and,
for pooled graphs, uploads nothing.  Reports circuits/s, p50/p95
latency and the session's cache stats; ``--sync --no-prewarm`` is the
synchronous loop without the ladder.

    PYTHONPATH=src python -m repro_torch.launch.serve --scale 9 --parts 8 \\
        --same-bucket --pool 8 --requests 256 [--device cpu]

It runs on ``cuda`` unless given ``--device cpu`` and raises when there
is no card.  The width ladder is recorded on a background thread: on
the CPU (or under ``--sync-prewarm``) the loop waits for it, on the card
it serves meanwhile, though a recording holds the card alone
(``core/capture.py::CARD``), so dispatches wait for each one.
``--adaptive`` is the reference's self-tuning warm path: no cold sweep
and no static prewarm; the first flush records the B=1 program inline,
and an :class:`~repro_torch.euler.autotune.AutoTuner`, fed by the
batcher and stepped once a loop turn, orders ladder widths from the
observed flush sizes onto the session's compile thread, pins what it
serves and may move the bucket scale onto the tight cap profile:

    PYTHONPATH=src python -m repro_torch.launch.serve --scale 9 --parts 8 \\
        --same-bucket --pool 8 --requests 256 --adaptive [--device cpu]

Over a partition mesh (``--mesh``, under ``torch.distributed.run``:
gloo with ``--device cpu``, one NCCL rank a card otherwise) every rank
serves the same stream; rank 0 owns the queues, the clock and the
autotuner and broadcasts each flush and each of the tuner's orders
before it carries it out, and the other ranks follow
(:class:`MicroBatcher`):

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.launch.serve --mesh --device cpu --scale 6 \
        --parts 8 --same-bucket --pool 4 --requests 12 [--adaptive]

The LM prefill + KV-cache decode driver (the reference's ``main_lm``) is
behind ``--workload lm``; its body is :func:`serve_lm`, which callers
can drive with any config, prompts and weights:

    PYTHONPATH=src python -m repro_torch.launch.serve --workload lm \\
        --arch smollm-360m --batch 4 --prompt-len 64 --gen 32 [--device cpu]

Like the reference, that CLI serves the reduced config with seeded
random weights; ``--arch`` takes any id of
``configs.registry.ARCH_IDS``, the MoE ones (``qwen2-moe-a2.7b``,
``qwen3-moe-235b-a22b``) included.  Two execution modes, as for the Euler solver.
``fused=True`` (the default) is the reference's: ``main_lm`` jits the
prefill and the decode step (the decode donating its cache); here each
becomes one CUDA graph (:class:`LMPrograms`), recorded once per serving
shape after one eager warm-up and replayed, in place over static
buffers.  ``fused=False`` is the eager oracle: every op launched from
Python.  Both give the same bits.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import threading
import time
from collections import Counter, deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..configs.registry import get_config
from ..core import capture
from ..core.engine import drained_clock
from ..euler.autotune import AutoTuner, FlushLog
from ..euler.bucket import modal_bucket_pool
from ..euler.solver import EulerSolver, resolve_device
from ..graphgen.eulerize import eulerian_rmat
from ..kernels import ops
from ..models.transformer import (LMConfig, Params, decode_step,
                                  init_kv_cache, init_lm_params,
                                  prefill_step)


#: the kinds of order rank 0 of a mesh broadcasts: each kind's code (slot 0
#: of the message; a dispatch's is its width, at least 1) and the number
#: of arguments after it (a dispatch's: its width)
ORDERS = {"stop": (0, 0), "prewarm": (-1, 2), "retune": (-2, 3),
          "pin": (-3, 1), "unpin": (-4, 1), "drop": (-5, 1)}
_KIND_OF = {code: kind for kind, (code, _) in ORDERS.items()}


def widths_mask(widths: Sequence[int]) -> int:
    """A retune order's widths as one int64 (bit w for width w).

    >>> widths_mask([1, 2, 8]), mask_widths(widths_mask([1, 2, 8]))
    (262, [1, 2, 8])
    """
    ws = sorted({int(w) for w in widths})
    if ws and not 1 <= ws[0] <= ws[-1] <= 62:
        raise ValueError(f"a retune order carries widths 1 to 62, got {ws}")
    return sum(1 << w for w in ws)


def mask_widths(mask: int) -> List[int]:
    return [w for w in range(63) if mask >> w & 1]


class MicroBatcher:
    """Bucket-keyed micro-batching scheduler over an ``EulerSolver``.

    ``submit(seq, graph)`` queues one request; ``poll()`` flushes buckets
    whose oldest request passed ``deadline_s``; ``drain()`` flushes and
    completes everything at shutdown.  All three return completed
    ``(seq, EulerResult)`` pairs (each pair exactly once, seq-sorted
    within a call).

    Flushing is asynchronous and width-laddered (DESIGN.md §9):

    - A flush of n requests splits greedily onto the *largest* warmed
      batch widths ≤ n (``solver.warmed_widths`` ∪ {1}), so a 5-request
      deadline flush with a warmed {1, 2, 4} ladder runs as one B=4
      program + one B=1 program instead of five B=1 solves — and never
      dispatches an unwarmed width, whose warm-up and recording would
      stall every request behind it (``prewarm`` is the one path that
      adds widths; an unwarmed bucket serves entirely at B=1).
    - Each dispatch enters a ``pipeline_depth``-deep in-flight window
      (``solve_batch_async``/``solve_async``); the card replays while
      the host preps and batches the next flush.  Overflowing the window
      blocks on the *oldest* dispatch, so results complete in dispatch
      order.  ``pipeline_depth=0`` is the synchronous loop.

    Mixed buckets never share a flush — each bucket queue is
    independent — so no request is padded up to a foreign shape
    (DESIGN.md §8).

    ``autotuner=`` takes an object with the reference's
    ``observe_arrival(key, graph)`` and ``observe_flush(key, n)``, fed on
    every submit and flush: an
    :class:`~repro_torch.euler.autotune.AutoTuner` under ``main_euler
    --adaptive`` (over a mesh an ``AutoTuner``, given each arrival's
    request id as ``seq=`` too).

    Over a partition mesh (``solver.mesh``) every rank must make the same
    dispatches and recordings in the same order, and keep the same
    programs, or the collectives hang; the reference has one controller.
    So the mesh's rank 0 leads: it owns the queues, the clock (deadline
    and quota flushes) and the autotuner, and before it carries out an
    order it broadcasts it over the mesh (``PartMesh.broadcast``, counted
    under ``broadcast``), one fixed-size int64 message an order
    (:data:`ORDERS`): a dispatch (its request ids), a prewarm ``(seq,
    width)`` or a retune ``(seq, e_cap, widths)`` of the solver's
    compile service (the retune tightens the scale, purges its prep
    memos and records the widths, on every rank at once), a ``pin``,
    ``unpin`` or ``drop`` of a program (its place in
    ``EulerSolver.live_programs()``), and :meth:`drain`'s stop.  Every
    other rank follows: :meth:`follow` carries out the same orders at
    the same points until the stop and returns the same results.  A
    dispatch over a mesh is fetched before the next
    (``EulerSolver.solve_async``), so ``pipeline_depth`` overlaps
    nothing there.  No thread records over a mesh: the tuner's
    :meth:`order` announces its pins and drops when it makes them, and
    its prewarm and retune jobs wait on the solver's compile service
    until :meth:`compile_next` (one a :meth:`poll`, all of them in
    :meth:`drain`) announces and runs each on the serving thread,
    between dispatches; after a retune the requests pending at its
    scale queue again under their new buckets.  :attr:`orders` counts
    the orders by kind on every rank.
    """

    def __init__(self, solver, max_batch: int = 8,
                 deadline_s: float = 0.010, clock=time.perf_counter,
                 pipeline_depth: int = 2, autotuner=None):
        if max_batch < 1 or pipeline_depth < 0:
            raise ValueError(
                f"need max_batch >= 1 and pipeline_depth >= 0, got "
                f"{max_batch}, {pipeline_depth}")
        self.mesh = getattr(solver, "mesh", None)
        #: rank 0 of a mesh (or no mesh) decides the flushes
        self.leads = self.mesh is None or self.mesh.rank == 0
        self.solver = solver
        self.max_batch = max_batch
        self.deadline_s = deadline_s
        self.clock = clock
        self.pipeline_depth = pipeline_depth
        self.autotuner = autotuner
        if self.mesh is not None and autotuner is not None:
            autotuner.stream = self     # its actions become our orders
        #: over a mesh, the orders announced or followed, by kind (the
        #: stop not counted)
        self.orders: Counter = Counter()
        #: over a mesh, the compile jobs drain() ran after the last
        #: result, and their seconds
        self.drain_compiles = 0
        self.drain_compile_s = 0.0
        self.pending: dict = {}     # bucket key → [(seq, graph, t_arrival)]
        self.inflight: deque = deque()   # (PendingSolve, [seq], [t_arrival])
        # flush widths, request latencies and queue depth live in the
        # metrics registry as children labelled by the solver's session,
        # so one scrape separates concurrent batchers; each flush's split
        # is also traced as a "flush" span
        reg = getattr(solver, "registry", None) or obs.default_registry()
        self.trace = getattr(solver, "trace", None) or obs.default_tracelog()
        lab = {"session": getattr(solver, "session", "s?")}
        self.flushes = FlushLog(clock=clock, metric=reg.histogram(
            "euler_flush_width", "requests per dispatched program",
            lo_exp=0, hi_exp=8).labels(**lab))
        # per-request arrival→delivery seconds (bounded log2 histogram)
        self.latencies = reg.histogram(
            "euler_latency_seconds", "request arrival→delivery seconds",
            lo_exp=-14, hi_exp=8).labels(**lab)
        self._g_depth = reg.gauge(
            "euler_queue_depth", "requests queued awaiting a flush"
        ).labels(**lab)

    # -- the mesh's orders ----------------------------------------------
    @property
    def order_bytes(self) -> int:
        """Bytes of one order message: ``max(1 + max_batch, 4)`` int64s."""
        return 8 * max(1 + self.max_batch, 4)

    def _broadcast(self, msg=()) -> list:
        """One order message from rank 0 to every rank (padded with
        zeros); every rank returns rank 0's."""
        msg = list(msg) if self.leads else []
        msg += [0] * (self.order_bytes // 8 - len(msg))
        with capture.CARD.shared(self.mesh.device):
            t = torch.tensor(msg, dtype=torch.int64,
                             device=self.mesh.device)
            return self.mesh.broadcast(t).tolist()

    def _announce(self, kind: str, args=()) -> None:
        """On rank 0: broadcast one order, counted under its kind."""
        head = len(args) if kind == "dispatch" else ORDERS[kind][0]
        self._broadcast([head, *args])
        if kind != "stop":
            self.orders[kind] += 1

    def _receive(self) -> Tuple[str, list]:
        """On another rank: rank 0's next order, ``(kind, args)``."""
        msg = self._broadcast()
        if msg[0] > 0:
            kind, n = "dispatch", msg[0]
        elif msg[0] in _KIND_OF:
            kind = _KIND_OF[msg[0]]
            n = ORDERS[kind][1]
        else:
            raise RuntimeError(f"rank {self.mesh.rank} received an order of "
                               f"no known kind: {msg}")
        if kind != "stop":
            self.orders[kind] += 1
        return kind, msg[1:1 + n]

    def order(self, kind: str, key, width: int) -> bool:
        """On rank 0 of a mesh: one of the autotuner's actions on the
        session as an order (:data:`ORDERS`), a ``pin``, ``unpin`` or
        ``drop`` of the program ``(key, width)``.  It is broadcast, then
        carried out here as every other rank carries it out
        (:meth:`follow`); returns what carrying it out returned.  An
        action on a program not live is not broadcast and returns
        False."""
        self._require_lead("order")
        live = self.solver.live_programs()
        program = (key, max(1, int(width)))
        if program not in live:
            return False
        wire = (live.index(program),)
        self._announce(kind, wire)
        return self._carry_out(kind, wire, None)

    def _carry_out(self, kind: str, args, resolve):
        """Carry out one order other than a dispatch on this rank.  A
        pin, unpin or drop names a program by its place in the LRU, which
        every rank keeps alike; a follower runs a prewarm or retune at
        once (``CompileService.run_now``) on request ``args[0]``'s
        graph, the body rank 0 runs for the job it announced."""
        s = self.solver
        if kind in ("pin", "unpin", "drop"):
            live = s.live_programs()
            if args[0] >= len(live):
                raise RuntimeError(
                    f"rank {self.mesh.rank} holds {len(live)} programs, "
                    f"and rank 0's {kind} order names program {args[0]}: "
                    f"the ranks' program sets differ")
            return getattr(s, f"{kind}_program")(*live[args[0]])
        seq, *rest = args
        if kind == "retune":
            rest = [rest[0], tuple(mask_widths(rest[1]))]
        return s._ensure_compile_service().run_now(kind, resolve(seq), *rest)

    def compile_next(self) -> bool:
        """Over a mesh, on rank 0: announce the next job queued on the
        solver's compile service (the tuner's prewarms and retunes), then
        run it here, as every other rank does on receipt.  It runs
        between dispatches (each fetched before it returned), one a call,
        so a recording holds serving back by one recording at most.
        After a retune the requests pending at its scale queue again
        under the buckets their graphs have now.  False when none is
        queued, and without a mesh (the compile thread runs the jobs
        there)."""
        if self.mesh is None:
            return False
        self._require_lead("compile_next")
        svc = self.solver.compile_service
        job = None if svc is None else svc.next_job()
        if job is None:
            return False
        if job.seq is None:
            raise RuntimeError(
                "a compile job queued over a mesh without a request id "
                "(prewarm_async) runs where every rank calls the compile "
                "service's drain(), not through the serving loop")
        args = list(job.args)
        if job.kind == "retune":
            args[1] = widths_mask(args[1])
        self._announce(job.kind, (job.seq, *args))
        svc.run(job)
        if job.kind == "retune":
            self._rebucket(job.args[0])
        return True

    def _rebucket(self, e_cap: int) -> None:
        """After a retune of scale ``e_cap``: its pending requests queued
        again, in arrival order, under their graphs' buckets now (the
        retune purged their preps; a queue of the old profile could hold
        graphs that the tight one buckets apart)."""
        stale = [k for k in self.pending if int(k[0]) == int(e_cap)]
        reqs = sorted((r for k in stale for r in self.pending.pop(k)),
                      key=lambda r: (r[2], r[0]))
        for seq, graph, t in reqs:
            self.pending.setdefault(self.solver.bucket_of(graph),
                                    []).append((seq, graph, t))

    def _require_lead(self, what: str) -> None:
        if not self.leads:
            raise RuntimeError(
                f"{what}: rank {self.mesh.rank} of the mesh follows rank "
                f"0's flushes; call follow() there")

    def _dispatch(self, graphs, seqs, ts) -> list:
        """One dispatch of ``graphs`` (width their count) into the
        in-flight window; returns what the window's overflow delivered."""
        pend = (self.solver.solve_batch_async(graphs) if len(graphs) > 1
                else self.solver.solve_async(graphs[0]))
        self.inflight.append((pend, list(seqs), list(ts)))
        self.flushes.observe(len(graphs))
        out = []
        while len(self.inflight) > self.pipeline_depth:
            out.extend(self._harvest_one())
        return out

    def follow(self, resolve) -> list:
        """On a mesh rank other than 0: carry out rank 0's orders, in its
        order, until its :meth:`drain`'s stop: its dispatches, and its
        autotuner's recordings, retunes, pins and drops; ``resolve(seq)``
        gives the graph of request ``seq``, the one rank 0 was given.
        Every rank's batcher has rank 0's ``max_batch`` (it sizes the
        order messages).  Returns the completed ``(seq, EulerResult)``
        pairs, seq-sorted, the same bytes as rank 0's."""
        if self.mesh is None or self.leads:
            raise RuntimeError("follow() runs on a mesh rank other than 0")
        out = []
        while True:
            kind, args = self._receive()
            if kind == "stop":
                break
            if kind != "dispatch":
                self._carry_out(kind, args, resolve)
                continue
            with self.trace.span("flush", n=len(args)) as sp:
                out.extend(self._dispatch([resolve(q) for q in args], args,
                                          [self.clock()] * len(args)))
                sp.set(widths=[len(args)])
        out.extend(self._harvest(block=True))
        return sorted(out)

    # -- pipeline ------------------------------------------------------
    def _harvest_one(self):
        """Block on the OLDEST in-flight dispatch and deliver it."""
        pend, seqs, ts = self.inflight.popleft()
        results = pend.results()
        now = self.clock()
        for t in ts:
            self.latencies.observe(now - t)
        return list(zip(seqs, results))

    def _harvest(self, block: bool = False):
        """Deliver completed dispatches, oldest first; ``block=True``
        waits for all of them (drain), else only already-finished heads
        are taken (``ready()`` asks the card through the card gate and
        answers False while a recording holds it)."""
        out = []
        while self.inflight and (block or self.inflight[0][0].ready()):
            out.extend(self._harvest_one())
        return out

    def _widths_for(self, key, n: int):
        """Program widths a flush of ``n`` may dispatch at: every warmed
        width plus B=1 (recorded by the bucket's first solve).  An
        unwarmed width — the full quota included — is never dispatched
        from the serving loop: a new batch program's warm-up and
        recording would stall every in-flight request behind it.
        ``EulerSolver.prewarm`` is the one path that adds widths."""
        ws = {w for w in self.solver.warmed_widths(key)
              if 1 <= w <= self.max_batch}
        ws.add(1)
        return sorted(ws, reverse=True)

    def _flush(self, key):
        reqs = self.pending.pop(key, [])
        if not reqs:
            return []
        if self.autotuner is not None:
            self.autotuner.observe_flush(key, len(reqs))
        out = []
        bucket = key[0] if isinstance(key, tuple) else key
        widths = []
        with self.trace.span("flush", bucket=bucket, n=len(reqs)) as sp:
            i = 0
            while i < len(reqs):
                n = len(reqs) - i
                w = next(x for x in self._widths_for(key, n) if x <= n)
                chunk = reqs[i:i + w]
                i += w
                seqs = [s for s, _, _ in chunk]
                if self.mesh is not None:
                    self._announce("dispatch", seqs)
                out.extend(self._dispatch([g for _, g, _ in chunk], seqs,
                                          [t for _, _, t in chunk]))
                widths.append(w)
            sp.set(widths=widths)
        self._g_depth.set(sum(len(q) for q in self.pending.values()))
        return out

    # -- public interface ----------------------------------------------
    def submit(self, seq: int, graph):
        """Queue one request; returns any results completed by the
        pipeline, plus this bucket's flush if the submission filled it."""
        self._require_lead("submit")
        key = self.solver.bucket_of(graph)
        if self.autotuner is not None:
            if self.mesh is None:
                self.autotuner.observe_arrival(key, graph)
            else:
                # the tuner names the graph to the other ranks by its
                # request id
                self.autotuner.observe_arrival(key, graph, seq=seq)
        q = self.pending.setdefault(key, [])
        q.append((seq, graph, self.clock()))
        self._g_depth.set(sum(len(x) for x in self.pending.values()))
        out = self._flush(key) if len(q) >= self.max_batch else []
        out.extend(self._harvest())
        return sorted(out)

    def poll(self):
        """Flush every bucket whose oldest request passed the deadline;
        deliver whatever the pipeline has completed.  Over a mesh, then
        run one queued compile job (:meth:`compile_next`)."""
        self._require_lead("poll")
        now = self.clock()
        due = [k for k, q in self.pending.items()
               if q and now - q[0][2] >= self.deadline_s]
        out = []
        for k in due:
            out.extend(self._flush(k))
        out.extend(self._harvest())
        self.compile_next()
        return sorted(out)

    def next_deadline(self):
        """Earliest pending-request deadline (None if nothing pending) —
        the arrival loop sleeps until this instead of spinning."""
        ts = [q[0][2] for q in self.pending.values() if q]
        return min(ts) + self.deadline_s if ts else None

    def drain(self):
        """Flush all pending requests and complete the pipeline
        (shutdown); results are seq-sorted — i.e. submit order.  Over a
        mesh it then runs every queued compile job, so that every rank
        ends with the same programs (counted in :attr:`drain_compiles`
        and :attr:`drain_compile_s`), and ends with the stop order that
        ends the other ranks' :meth:`follow`."""
        self._require_lead("drain")
        out = []
        for k in list(self.pending):
            out.extend(self._flush(k))
        out.extend(self._harvest(block=True))
        if self.mesh is not None:
            t0 = time.perf_counter()
            while self.compile_next():
                self.drain_compiles += 1
            self.drain_compile_s += time.perf_counter() - t0
            self._announce("stop")
        return sorted(out)


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


def main_euler(argv=None, mesh=None):
    """The Euler-circuit serving loop, static or ``--adaptive`` (the
    module docstring).  Returns circuits served a second.

    Over a partition mesh (``mesh``, a
    :class:`~repro_torch.launch.mesh.PartMesh`, or ``--mesh`` under
    ``torch.distributed.run``, which initialises the default group from
    its environment: gloo with ``--device cpu``, NCCL on the card) every
    rank prepares the same pool and makes the same cold sweep and width
    prewarm (on the main thread: a recording's collectives cannot run
    beside the loop's); then rank 0 runs the loop and the others follow
    its orders (:meth:`MicroBatcher.follow`).  Under ``--adaptive`` the
    autotuner lives on rank 0, and its recordings, retunes, pins and
    drops reach every rank as orders of the same stream; the compile
    jobs that ``drain()`` runs after the last result are left out of
    the timed window, as the meshless compile thread's are.  ``--parts
    0`` is the mesh's partitions (one a rank under ``--mesh``, as the
    reference's ``len(jax.devices())``)."""
    ap = argparse.ArgumentParser(
        description="Euler-circuit serving loop over the solver facade")
    ap.add_argument("--scale", type=int, default=9,
                    help="RMAT scale of the request graphs")
    ap.add_argument("--avg-degree", type=int, default=5)
    ap.add_argument("--parts", type=int, default=0,
                    help="partitions (0 → one per visible card; 1 on cpu)")
    ap.add_argument("--pool", type=int, default=6,
                    help="distinct graphs cycled through the request stream")
    ap.add_argument("--same-bucket", action="store_true",
                    help="draw the pool from one modal shape bucket so "
                         "every flush can fill the batch quota (small "
                         "graphs otherwise fragment across buckets)")
    ap.add_argument("--requests", type=int, default=0,
                    help="serve exactly N requests (0 → duration-driven)")
    ap.add_argument("--duration", type=float, default=10.0,
                    help="serve for this many seconds after warmup")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="micro-batch flush quota per bucket (1 → "
                         "unbatched request loop)")
    ap.add_argument("--deadline-ms", type=float, default=10.0,
                    help="flush a bucket when its oldest request has "
                         "waited this long")
    ap.add_argument("--eager", action="store_true",
                    help="per-level eager supersteps instead of the "
                         "recorded graph (disables micro-batching)")
    ap.add_argument("--sync", action="store_true",
                    help="synchronous dispatch (pipeline depth 0); "
                         "default is the async pipeline")
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="in-flight dispatch window of the async batcher")
    ap.add_argument("--no-ladder", action="store_true",
                    help="disable cap/level/round bucket quantization "
                         "(pow2-per-field keying)")
    ap.add_argument("--widths", default="1,2,4",
                    help="comma-separated batch widths to pre-warm per "
                         "hot bucket (max-batch is always added)")
    ap.add_argument("--no-prewarm", action="store_true",
                    help="skip the background width-ladder prewarm "
                         "(partial flushes then run at B=1)")
    ap.add_argument("--adaptive", action="store_true",
                    help="self-tuning warm path: skip the cold sweep and "
                         "static prewarm, serve from the first arrival, "
                         "and let the autotuner's compile thread record "
                         "ladder widths behind live traffic from the "
                         "observed flush histograms")
    ap.add_argument("--sync-prewarm", action="store_true",
                    help="join the static prewarm thread before serving "
                         "on any device (default: join on cpu only, "
                         "detach on the card)")
    ap.add_argument("--cache-bytes", type=int, default=0,
                    help="byte budget of the recorded-program LRU, in "
                         "reserved bytes measured per recording and "
                         "predicted before one (0 → count-capped only)")
    ap.add_argument("--arrival-hz", type=float, default=0.0,
                    help="paced request arrivals per second "
                         "(0 → closed loop: submit as fast as served)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="expose the session's metrics registry over HTTP "
                         "on this port for the run: GET /metrics "
                         "(Prometheus text) and /metrics.json (snapshot); "
                         "0 picks an ephemeral port")
    ap.add_argument("--json", default=None,
                    help="append a JSON line of serving stats to this file")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; cpu runs the "
                         "kernels' plain twins)")
    ap.add_argument("--mesh", action="store_true",
                    help="serve over a partition mesh of the ranks "
                         "torch.distributed.run started (gloo with "
                         "--device cpu, NCCL on the card)")
    args = ap.parse_args(argv)
    if args.mesh and mesh is None:
        return _main_euler_mesh(args, argv)

    max_batch = 1 if args.eager else args.max_batch
    if args.adaptive and (args.eager or max_batch <= 1):
        raise SystemExit("--adaptive needs the fused path and "
                         "--max-batch > 1 (there is no width ladder to "
                         "tune otherwise)")
    device = resolve_device(args.device if mesh is None else mesh.device)
    on_card = device.type == "cuda"
    if mesh is not None:
        n_parts = args.parts or mesh.n_parts
    else:
        n_parts = args.parts or (torch.cuda.device_count() if on_card
                                 else 1)
    leads = mesh is None or mesh.rank == 0
    say = print if leads else (lambda *a, **k: None)
    ladder = not args.no_ladder
    widths = sorted({int(w) for w in args.widths.split(",") if w}
                    | {max_batch})
    solver = EulerSolver(n_parts=n_parts, device=device, mesh=mesh,
                         fused=not args.eager,
                         cap_ladder=ladder, level_ladder=ladder,
                         straggler_cap=ladder,
                         width_ladder=tuple(widths),
                         program_cache_bytes=args.cache_bytes or None)
    metrics_srv = None
    if args.metrics_port is not None:
        metrics_srv = obs.MetricsServer(solver.registry,
                                        port=args.metrics_port,
                                        trace=solver.trace)
        say(f"metrics: {metrics_srv.url}/metrics (Prometheus) and "
            f"{metrics_srv.url}/metrics.json")
    if args.same_bucket:
        pool = modal_bucket_pool(
            solver,
            (eulerian_rmat(args.scale, avg_degree=args.avg_degree,
                           seed=args.seed + i) for i in range(args.pool * 8)),
            args.pool,
        )
        if not pool:
            raise SystemExit(
                "--same-bucket found no graph that partitions into "
                f"{n_parts} non-empty parts at scale {args.scale}; use a "
                f"larger --scale or fewer --parts"
            )
    else:
        pool = [eulerian_rmat(args.scale, avg_degree=args.avg_degree,
                              seed=args.seed + i) for i in range(args.pool)]
    mode = "eager" if args.eager else "fused"
    depth = 0 if (args.sync or args.eager) else args.pipeline_depth
    say(f"serving {mode} on {n_parts} partitions ({device}"
        + ("" if mesh is None else f", a mesh of {mesh.world} rank(s)")
        + f"); request pool: {len(pool)} graphs, ~{pool[0].num_edges} "
        f"edges each; micro-batch ≤{max_batch}, deadline "
        f"{args.deadline_ms}ms, pipeline depth {depth}, widths {widths}")

    tuner = None
    rep: dict = {}
    if args.adaptive:
        # No cold sweep and no static prewarm: requests are served from
        # the first arrival, the first flush records the B=1 program
        # inline, and the autotuner's compile thread records ladder
        # widths behind live traffic from the observed flush histograms
        # (over a mesh rank 0's tuner orders them onto every rank's
        # serving thread).
        t_cold = t_warm = 0.0
        cold_thr = 0.0
        if leads:
            tuner = AutoTuner(solver, max_batch=max_batch)
        say("adaptive: serving from first arrival; ladder widths "
            "record behind live traffic as flush histograms accrue")
    else:
        # Cold pass: one sequential sweep records each bucket's B=1
        # program and measures cold (recording-inclusive) latency.  The
        # width ladder then records on a background thread; the batcher
        # only ever dispatches to widths already live, so serving can
        # start at once.
        t0 = time.perf_counter()
        with solver.trace.span("cold_sweep", pool=len(pool)):
            warm = solver.solve_many(pool)
        warm[0].validate()
        t_cold = time.perf_counter() - t0
        cold_thr = len(pool) / max(t_cold, 1e-9)
        for g, r in zip(pool, warm):
            rep.setdefault(r.cache.bucket, g)
        t0 = time.perf_counter()
        if max_batch > 1 and not args.eager and not args.no_prewarm:
            ladder_widths = [w for w in widths if w > 1]

            def prewarm():
                for g in rep.values():
                    solver.prewarm(g, ladder_widths)

            if mesh is not None:
                prewarm()   # its recordings' collectives precede the loop's
            else:
                # thread-contract: daemon (never blocks interpreter exit;
                # prewarm holds no resource of its own, and a recording
                # it leaves behind is the solver's to free).  Joined
                # before the measured loop on the CPU (or under
                # --sync-prewarm), where its solves would share the
                # serving loop's cores; on the card it detaches and the
                # ladder records behind live traffic, each recording
                # holding the card gate alone.  The batcher dispatches
                # only widths already live either way.
                pw = threading.Thread(target=prewarm, name="prewarm",
                                      daemon=True)
                pw.start()
                if args.sync_prewarm or not on_card:
                    pw.join()
        t_warm = time.perf_counter() - t0
        cs = solver.cache_stats
        say(f"cold pass {t_cold:.2f}s ({cold_thr:.2f} circuits/s); "
            f"width prewarm {t_warm:.2f}s — {len(rep)} bucket(s), "
            f"{cs.compiles} program recording(s), "
            f"{cs.prewarms} prewarmed width(s)")

    batcher = MicroBatcher(solver, max_batch=max_batch,
                           deadline_s=args.deadline_ms / 1e3,
                           pipeline_depth=depth, autotuner=tuner)
    if not leads:
        t0 = time.perf_counter()
        done = batcher.follow(lambda seq: pool[seq % len(pool)])
        elapsed = time.perf_counter() - t0
        if not done:
            raise RuntimeError("serving loop made no progress")
        done[-1][1].validate()
        kinds = ", ".join(f"{k} {n}" for k, n in sorted(
            batcher.orders.items()) if k != "dispatch")
        compiles = batcher.orders["prewarm"] + batcher.orders["retune"]
        print(f"rank {mesh.rank}/{mesh.world}: followed "
              f"{batcher.flushes.total} dispatches, {compiles} compile "
              f"orders ({kinds or 'no other orders'}), {len(done)} circuits "
              f"in {elapsed:.2f}s")
        return len(done) / max(elapsed, 1e-9)
    served = 0
    edges = 0
    submitted = 0
    last = None
    period = 1.0 / args.arrival_hz if args.arrival_hz > 0 else 0.0
    t0 = time.perf_counter()
    next_arrival = t0
    while True:
        now = time.perf_counter()
        # --requests caps *submissions*; the final drain then delivers
        # exactly N results even when flushes complete out of quota
        if args.requests and submitted >= args.requests:
            break
        if not args.requests and now - t0 >= args.duration:
            break
        done = []
        if now >= next_arrival:
            done.extend(batcher.submit(submitted,
                                       pool[submitted % len(pool)]))
            submitted += 1
            next_arrival = (next_arrival + period) if period else now
        done.extend(batcher.poll())
        if tuner is not None:
            # rate-limited inside step(): decays the histograms,
            # snapshots the session, feeds the compile thread and pins
            tuner.step()
        if period:
            # arrival-driven idle: sleep to the next arrival or the next
            # bucket deadline, whichever fires first (no spinning)
            dl = batcher.next_deadline()
            wake = min(next_arrival, dl) if dl is not None else next_arrival
            pause = wake - time.perf_counter()
            if pause > 0:
                time.sleep(min(pause, 0.05))
        for _, res in done:
            served += 1
            edges += len(res.circuit)
            last = res
    for _, res in batcher.drain():
        served += 1
        edges += len(res.circuit)
        last = res
    # over a mesh drain() runs the compile jobs still queued after the
    # last result; meshless they are left to the compile thread
    elapsed = time.perf_counter() - t0 - batcher.drain_compile_s

    tuner_stats = {}
    if tuner is not None:
        tuner_stats = tuner.stats()
        tuner.close(timeout=5.0)

    cs = solver.cache_stats
    thr = served / max(elapsed, 1e-9)
    fl = batcher.flushes
    first_wide = (fl.first_wide_t - t0 if fl.first_wide_t is not None
                  else None)
    # percentiles from the registry histogram (log2 buckets with linear
    # interpolation, DESIGN.md §13)
    p50 = batcher.latencies.percentile(0.50) * 1e3
    p95 = batcher.latencies.percentile(0.95) * 1e3
    print(f"served {served} circuits ({edges} edges) in {elapsed:.2f}s "
          f"→ {thr:.2f} circuits/s, {edges / max(elapsed, 1e-9):.0f} edges/s "
          f"({fl.total} dispatches, mean width {fl.mean_width():.1f})")
    print(f"latency p50 {p50:.1f}ms / p95 {p95:.1f}ms; cache: {cs.hits} "
          f"hits / {cs.misses} misses / {cs.compiles} recordings / "
          f"{cs.evictions} evictions; {cs.state_uploads} state uploads")
    if tuner is not None:
        fw = f"{first_wide:.2f}s" if first_wide is not None else "never"
        print(f"adaptive: first wide flush at {fw} "
              f"({fl.narrow_before_wide} narrow dispatches before it); "
              f"{tuner_stats.get('async_prewarms', 0)} async prewarm(s), "
              f"{tuner_stats.get('pinned', 0)} pinned program(s), "
              f"{tuner_stats.get('tuner_steps', 0)} tuner step(s)")
    if served == 0:
        raise RuntimeError("serving loop made no progress")
    last.validate()
    if args.json:
        width_hist = {str(w): c for w, c in sorted(fl.hist.items())}
        stats = {
            "workload": "euler-serve", "scale": args.scale,
            "parts": n_parts, "max_batch": max_batch,
            "deadline_ms": args.deadline_ms, "pipeline_depth": depth,
            "ladder": ladder, "adaptive": bool(args.adaptive),
            "served": served,
            "elapsed_s": round(elapsed, 3),
            "circuits_per_s": round(thr, 3),
            "cold_circuits_per_s": round(cold_thr, 3),
            "cold_s": round(t_cold, 3), "prewarm_s": round(t_warm, 3),
            "p50_ms": round(p50, 3), "p95_ms": round(p95, 3),
            "mean_flush": round(fl.mean_width(), 2),
            "width_hist": width_hist,
            "first_wide_flush_s": (round(first_wide, 3)
                                   if first_wide is not None else None),
            "dispatches_before_wide": fl.narrow_before_wide,
            "buckets": len(rep) or tuner_stats.get("tuner_buckets", 0),
            "compiles": cs.compiles, "hits": cs.hits, "misses": cs.misses,
            "evictions": cs.evictions, "prewarms": cs.prewarms,
            "state_uploads": cs.state_uploads,
        }
        stats.update(tuner_stats)
        if mesh is not None:
            stats["orders"] = dict(sorted(batcher.orders.items()))
            stats["drain_compiles"] = batcher.drain_compiles
            stats["drain_compile_s"] = round(batcher.drain_compile_s, 3)
        with open(args.json, "a") as f:
            f.write(json.dumps(stats) + "\n")
    if metrics_srv is not None:
        metrics_srv.close()
    return thr


def _main_euler_mesh(args, argv):
    """``main_euler --mesh``: the default group from
    ``torch.distributed.run``'s environment (NCCL's graph mixing off
    first, as ``launch/mesh.py`` asks), the mesh over it, the loop, then
    the group destroyed once the session is gone (NCCL waits for the
    CUDA graphs that hold its kernels)."""
    import gc

    import torch.distributed as dist

    from .mesh import NCCL_GRAPH_MIXING, make_part_mesh

    cpu = torch.device(args.device).type == "cpu"
    if not cpu:
        name, value = NCCL_GRAPH_MIXING
        os.environ[name] = value
    dist.init_process_group("gloo" if cpu else "nccl")
    try:
        mesh = make_part_mesh(args.parts or dist.get_world_size(),
                              device="cpu" if cpu else None)
        return main_euler(argv, mesh=mesh)
    finally:
        gc.collect()
        if not cpu:
            torch.cuda.synchronize()
        dist.destroy_process_group()


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--workload", choices=("euler", "lm"), default="euler",
                    help="request-serving workload (default: euler)")
    args, rest = ap.parse_known_args(argv)
    return main_lm(rest) if args.workload == "lm" else main_euler(rest)


if __name__ == "__main__":
    main()
