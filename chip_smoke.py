#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                 # scale-20 RMAT graph, 8 partitions,
                                          # full-width SmolLM-360M serving

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
                and the bound (K1 runs on packed (nxt, lab) records and
                K2 on packed (ptr, dist, reach, 0) records; the packed
                twins and the two- and three-array oracles are all
                timed; K2's bound counts the three tables); then the
                splice loops' test kernel inside CUDA while nodes at the
                main path's flag shapes ([8] and []) and budgets (16,
                54), each replay of a seeded countdown held to the rounds
                and bytes of its twin driving the same loop on the host,
                timed as one test a round of a node around the test
                alone;
  4. parity   — a scale-8, 2-partition eager solve (``fused=False``) on
                ``cuda`` and on ``cpu`` in each Phase 3 mode (sharded, the
                default; replicated; ``gather_circuit=False``): every
                circuit and mate byte-identical, all validated;
  5. slice    — the main path: ``repro_torch.euler.solve`` of an Eulerian
                RMAT graph (scale 20, average degree 5, seed 0) with 8
                partitions on ``cuda``, eagerly (``fused=False``, each
                level and Phase 3 step clocked), twice: with the default
                sharded Phase 3 and with ``sharded_phase3=False``, launch
                counters reset just before each and read just after, and
                the rounds each splice loop ran printed beside its
                budget.  Both circuits are validated, byte-identical to
                each other and to the numpy list-rank twin of the spliced
                mate; the replicated solve must launch K1/K2 once per
                doubling round and K3/K4 never, the sharded one K3/K4
                once per ring step of each round (rounds × 8) and K1/K2
                never;
  5b. fused   — the solver's default mode, one recorded CUDA graph per
                bucket, each splice loop in it one CUDA while node: at
                scale 8 with 2 partitions, fused on ``cuda`` and on
                ``cpu`` in each Phase 3 mode, byte-identical to each
                other and to the eager solves, each loop running the
                eager rounds; at the main path's scale, a fused sharded
                solve of seed 0 (cold: warms up and records),
                byte-identical to the eager ``[slice]`` solve, then an
                eager solve of seed 1 (2,739,077 edges, the same bucket,
                its key printed and checked) and a fused one, which must
                replay the graph (``capture_s`` 0, one capture in all,
                no kernel launched from Python), validated, equal to the
                eager bytes and held against the numpy list-rank twin;
                then a fused replicated solve of seed 0, byte-identical
                to the eager one.  The launch counters read around each
                recording must equal the eager counts (K3/K4 rounds × 8
                sharded, K1/K2 rounds replicated) and two loop tests a
                splice loop.  Each solve prints the rounds each loop ran
                in the replay beside its budget and the eager solve's
                rounds, and fails where they differ (a replay that ran
                the budget where eager stopped earlier among them), and
                ``warmup_s``, ``capture_s``, ``run_s``, ``fetch_s``, its
                peak allocated and reserved memory beside the eager
                ``supersteps_s + phase3_s``; the solvers and their graphs
                are freed before the next phase;
  5c. session — the solver as a serving session.  At the main scale, in
                5b's sharded session after seed 1's replay: seed 0 again
                with the same ``Graph`` object must be a cache hit with
                ``prepare_s`` under 0.05 s (the prep memo), no new state
                upload (the state stayed on the card) and no kernel
                launched from Python, byte-equal to 5b's cold solve; its
                ``prepare_s``, ``upload_s``, ``run_s`` and ``total_s``
                are printed beside the cold ones with ``cache_stats``,
                the run's ``reserved_bytes``, the bytes of each resident
                state and the peak allocated and reserved memory.  At
                scale 8 with 8 partitions, on ``cuda`` and on ``cpu``: 30
                seeds bucketed, ``solve_many`` of 8 graphs of the modal
                bucket (one trace, one miss, seven hits, each result
                valid and byte-equal to a one-shot solve on the card);
                then A, B, A, B over the two buckets, under the default
                cap (both programs stay alive, A replays right after B
                recorded) and under ``program_cache_max=1`` (three
                evictions, the engines and their resident states kept;
                on the card the reserved memory falls across each
                eviction and its ``empty_cache`` by at least 0.9 of the
                evicted run's ``reserved_bytes``);
  5d. async   — asynchronous solves (``solve_async`` → ``PendingSolve``).
                At the main scale, in 5b's sharded session after 5c:
                seed 0's and seed 1's graphs in new ``Graph`` objects
                (copies of their edge arrays, so the prep memo misses),
                solved in sequence with ``solve``, and pipelined:
                ``solve_async(A)``, ``solve_async(B)``, whose host prep
                runs while A replays, then ``result()`` of each; three
                times each in turns (sequence, pipeline, pipeline,
                sequence, sequence, pipeline, each in new objects, their
                memo entries and states dropped after), ``seq_s`` and
                ``pipelined_s`` the means, and the saving less the
                difference of the two ways' host prep and upload
                seconds (the overlap alone).  First, the host seconds of
                one dispatch and of its parts (the copies into the
                inputs, the graph's ``replay()`` call, the pinned
                copy-out), and a fixed host workload's seconds with the
                card idle and beside a replay.  Prints
                A's replay event time, whether A was ready when B's
                dispatch returned, each dispatch's spans, every solve's
                timings, the peak allocated and reserved memory of each
                pipeline, and the milliseconds from an idle card to the
                run's outputs on the host through pinned buffers and
                through device copies then ``.cpu()``.  Fails unless all
                twelve results validate and equal 5b's bytes of their
                seeds, the saving net of the host prep is at least 0.8
                of A's ``run_s`` and the raw saving above 0 (the host
                prep's spread between runs, seconds a graph, would make
                a raw threshold fail at random), nothing recorded and
                no kernel was launched from Python.  At
                scale 8 with 8 partitions, on ``cuda`` and on ``cpu``:
                the modal bucket's 8 graphs dispatched, then fetched in
                reverse order, each byte-equal to its one-shot solve (one
                trace, seven hits); under ``program_cache_max=1`` a
                dispatch of another bucket evicts the program of a
                replay still in flight, whose pending returns its bytes;
  5e. batch   — batched solves (``solve_batch``, one CUDA graph per
                ``(bucket, B)``, the batch axis after the partition
                axis).  At scale 8 with 8 partitions, 5c's modal bucket,
                on ``cuda`` and on ``cpu`` in each Phase 3 mode: the 8
                graphs one at a time, then ``solve_batch`` at B = 1, 3
                and 8, twice each: every member validated and byte-equal
                to its one-graph solve on the card, traces 1, 1, 2, 3 and
                a hit on each repeat, each splice loop's rounds in a
                batched run equal to the most its members ran alone, and
                on the card the launches counted around each batched
                recording equal to the one-graph recording's (K1–K4 and
                two loop tests a loop).  K1–K4 against their twins at
                the B = 8 program's shapes, one round each.  Then, warm,
                ``solve_many`` of the 8 with ``batch=None`` and
                ``batch=8`` in turns (three each), graphs a second from
                the medians, and a B = 8 replay's event time against a
                one-graph replay's.  At the main scale less one (19)
                under ``program_cache_max=1``: seed 0 and the first
                later seed of its bucket (keys printed), one at a time
                (seed 0 records, the other replays, seed 0 again), then
                ``solve_batch`` of the two twice (records B = 2 in place
                of B = 1, then replays): byte-equal to the one-graph
                solves; ``run_s``, each program's ``reserved_bytes`` and
                the peak allocated and reserved memory beside the
                ``nvidia-smi`` line;
  5f. host    — the reference's exact host BSP engine (``backend="host"``:
                numpy and scipy on the machine's CPU, the paper's Int64
                memory-state accounting) on an Eulerian RMAT graph at the
                main scale less four (16), average degree 5, seed 0, P =
                8: once with both §5 heuristics on and once with both off
                (the launch counters set to 0 before and read after: no
                kernel may launch), then the fused device solve of the same
                graph on ``cuda`` in a new session (it warms up and
                records).  All three validated, each covering every edge
                once; the heuristics' level-0 ``cumulative`` Int64 state
                at most the baseline's.  Prints each host solve's
                ``run_s`` and ``total_s``, the device solve's
                ``warmup_s``, ``capture_s`` and ``run_s``, and each
                engine's per-level ``cumulative`` beside the
                ``nvidia-smi`` line;
  5g. serve   — the Euler serving loop (``launch/serve.py::main_euler``,
                its ``MicroBatcher`` and the solver's width ladder),
                called in-process as the reference documents its
                deployment: Eulerian RMAT scale 9, P = 8, ``--same-bucket
                --pool 8 --max-batch 8 --widths 1,2,4,8 --deadline-ms 10
                --requests 256``; (a) with ``--sync-prewarm`` (the ladder
                recorded before serving), (b) with ``--sync --no-prewarm``
                (the synchronous loop without the ladder), (c) with the
                prewarm thread detached, so the ladder records behind live
                traffic while each recording holds the card gate alone
                (the thread is joined after the run), (e) with
                ``--adaptive`` (no cold sweep: the first flush records
                B = 1 inline, and the autotuner orders ladder widths from
                the observed flushes onto its compile thread; every
                compile job's ticket is kept and none may fail, and the
                ``compile-service`` thread must be stopped when
                ``main_euler`` returns; it also prints the tuner's steps,
                async prewarms, pins, tightened scales and charged
                bytes).  Each run prints
                circuits/s, p50/p95 ms, the flush-width histogram, the
                mean flush, recordings, hits, misses, evictions, prewarms
                and state uploads (and (c) the first wide flush's second
                and the dispatches before it) beside the ``nvidia-smi``
                line; every delivered result is validated, each of the 256
                requests is delivered once, and 8 of them, spread over the
                run, must be byte-equal (circuit and mate) to ``fused=False``
                solves of the same graphs in a new session.  (d) The byte
                budget: Eulerian RMAT scales 15 and 16 (the main scale
                less five and four; average degree 5, seed 0), P = 8; each
                program's ``reserved_bytes`` measured alone in a session
                of one program, then a session with
                ``program_cache_bytes`` at 1.25 times the larger solves
                them in turns six times: every solve must record (the
                other bucket's program evicted), ``cache_bytes_used()``
                stay within the budget after each true-up, and every
                recording whose cost was predicted (both buckets measured
                in the session) must keep ``max_memory_reserved()`` below
                the two programs' bytes together — the eviction came
                before the recording; prints each solve's prediction,
                charge, peak and evictions; one result a bucket is held
                byte-equal to an eager solve in a new session.  (f) The
                tight cap profile, in ``AutoTuner._apply``'s order, on
                (e)'s pool bucket (scale 9, P = 8) in a new session: B = 1
                and B = 8 recorded, their ``reserved_bytes`` and the
                bucket's caps printed, ``cap_observations`` beside the
                tight floors and the measured waste (whether ``plan``
                would tighten on its own); then ``tighten`` and a retune
                job on the compile thread (``submit_retune(g, e_cap,
                [8]``: rekey, record the tight bucket's B = 1 and B = 8;
                its ticket must hold no error), the tight caps, the
                tight programs' ``reserved_bytes`` and how many tight
                buckets the pool splits into; the pool solved again one
                at a time and as a B = 8 batch of the members of the
                retuned graph's tight bucket, every result byte-equal to
                ``fused=False`` solves in a new session;
  6. k5       — the sorted segment sum against its twin (f32 tolerance
                1e-5, half types 2e-2, atol ×8) at the GNN aggregation
                shapes full_graph_sm and ogb_products (seeded sorted ids)
                in f32, ogb_products in bf16, and ogb_products with
                skewed ids ``floor(S·u²)`` (a 39,672-row segment 0; atol
                plus 2^-22 per row of the segment, which a kernel that
                drops one row must exceed; errors against an f64 sum of
                the 16 longest segments); kernel, twin and
                ``torch.segment_reduce`` times beside the byte bound;
  7. k6       — the bf16 instantiations' pipeline stages, tile sizes
                and dynamic shared memory, then flash attention against
                its twin at the serving prefill's shape (B 4, S = T =
                4,096, 15 query and 5 KV heads, D 64, bf16, causal),
                non-causal f32 at D 128, a ragged S = T = 4,097, causal
                bf16 at D 128 (B 1, S = T = 4,096, 8/2 heads) and D 32
                (B 2, S = T = 2,048, 6/2 heads), and a causal suffix
                across tile edges (S = 1,000 queries over T = 4,097
                keys): f32 within 2e-5, bf16 elementwise within 5e-2 of
                |want| plus its row's RMS, a limit that a twin dropping
                one KV tile or mapping the heads wrongly must exceed;
                kernel, twin and ``scaled_dot_product_attention`` times
                beside the bound; then the kernel alone at prefill_32k's
                sequence (B 1, S = T = 32,768);
  8. lm-parity — the reduced SmolLM-360M config in f32 (batch 2, prompt
                64, gen 8), one set of seeded weights on ``cuda`` and on
                ``cpu``: prefill logits within 2e-5, greedy ids equal;
  9. lm-slice — the LM serving path: ``serve_lm`` on the full SmolLM-360M
                config (32 layers, d_model 960, bf16, seeded random
                weights) for 4 requests of 4,096 prompt tokens and 32
                generated each.  The main path is the default,
                ``fused=True``: one ``LMPrograms`` for the shape, whose
                first serve warms up and records the prefill and the
                decode step as two CUDA graphs (every counter set to 0
                just before and read just after, and around each
                recording: K6 once per layer in the prefill graph, none
                in the decode graph, K1–K5 never; ``warmup_s``,
                ``capture_s``, ``captures=1``).  Then three fused serves
                with the same programs (replays: no capture, no wrapper
                launched) and three eager ones (``fused=False``: K6 once
                per layer), min, median and max of ``decode_tok_s`` and
                ``prefill_s`` of each mode beside the ``nvidia-smi``
                line, the fused serves' peak allocated and reserved
                memory; the fused ids must equal the eager ids.  The
                first three decode replays' logits are held against
                three eager ``decode_step``s from the same state (their
                largest difference printed, greedy tokens equal).  The
                first decode step's logits must match a prefill of the
                4,097-token prompt: in bf16 within 0.1 when the
                prefill's attention rounds as the decode's does, and in
                an f32 copy of the weights, K6 in the prefill, within
                1e-4; a widening copy that drops the prompt's last
                position must fail both.  A profiled eager prefill and
                decode step, and a profiled prefill and decode replay,
                split the device time by kernel; an eager decode step
                launches no kernel of the port;
  10. audit   — the program audit (``repro_torch.analysis``) on the card:
                ``audit_graph`` of a scale-8, P = 8 bucket at widths 1, 2,
                4 and 8, sharded and replicated, a line a program: ``ok``,
                the census of the recording's calls at the stand-ins
                for the reference's collectives and kernels, the
                recorded graph's K1–K4 kernel nodes against the expected
                launches, its loop-test, while and host nodes and
                device→host copies, its ``reserved_bytes`` beside
                ``program_cost_bytes`` and their ratio; every program
                must pass.  Three planted faults must each fail it: a
                non-blocking copy of the mate into a pinned host tensor
                recorded into the body, one ``_ring`` call more after
                the rank, and a body that writes a static input.  Then the eviction check: a session
                records bucket A (scale 16), its byte budget is set to
                1.5 × A's ``reserved_bytes``, and bucket B (scale 17, a
                larger ``e_cap``) is solved: B's charge, its static
                model times the reserved/model ratio A measured, must
                evict A at B's ``_account``, before B records; the
                predicted and measured bytes are printed.

The last three lines are the kernel table as JSON, the ``nvidia-smi``
line, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import re
import subprocess
import sys
import math
import tempfile
import threading
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.analysis import audit_graph  # noqa: E402
from repro_torch.analysis.graph_audit import (  # noqa: E402
    LOOP_TEST, graph_kernel_nodes, program_cost_bytes)
from repro_torch.configs.base import gnn_shapes, lm_shapes  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import capture  # noqa: E402
from repro_torch.core import phase1 as p1  # noqa: E402
from repro_torch.core import phase3 as p3  # noqa: E402
from repro_torch.core.engine import Engine, FusedRun  # noqa: E402
from repro_torch.core.graph import Graph  # noqa: E402
from repro_torch.core.phase3 import circuit_from_mate_np  # noqa: E402
from repro_torch.euler import EulerSolver, solve  # noqa: E402
from repro_torch.euler.autotune import (CompileService,  # noqa: E402
                                        TunerParams)
from repro_torch.euler.bucket import (TIGHT_DIVISORS,  # noqa: E402
                                      ladder_floors, modal_bucket_pool,
                                      strip_circuit)
from repro_torch.graphgen.eulerize import eulerian_rmat  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import graph_loop  # noqa: E402
from repro_torch.kernels import pointer_double as pd  # noqa: E402
from repro_torch.kernels import segment_reduce as sr  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.serve import LMPrograms, serve_lm  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.models.layers import gqa_attention  # noqa: E402

#: H100 SXM device-memory rate (NVIDIA data sheet), bytes/s.
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM dense peaks (NVIDIA data sheet): bf16 on the tensor cores,
#: f32 on the CUDA cores (K6's f32 path is CUDA-core FMAs), FLOP/s.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
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
    "segment_sum_sorted": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segment_reduce.cu",
        "replaces": "src/repro/kernels/segment_reduce.py:49",
    },
    "flash_attention": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:69",
    },
    "loop_condition": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/graph_loop.cu",
        "replaces": "src/repro/core/phase1.py:322",
    },
}
#: each kernel's wrapper, whose ``launches`` counts its launches
WRAPPERS = {
    **{name: getattr(pd, name) for name in
       ("pointer_double", "pointer_double_rank", "pointer_double_shard",
        "pointer_double_rank_shard")},
    "segment_sum_sorted": sr.segment_sum_sorted,
    "flash_attention": fa.flash_attention,
    "loop_condition": graph_loop.while_loop,
}
#: the LM slice: 4 requests of 4,096 prompt tokens, 32 generated each
LM_BATCH, LM_PROMPT, LM_GEN = 4, 4096, 32
#: K6 in bf16 against its twin, elementwise: |got − want| at most this
#: times (|want| + the RMS of want's row over D).  The twin rounds its
#: scores to bf16, as the reference does, and K6 keeps them in f32: an
#: emulation of the two on the CPU (B 1, S = T = 2,200, D 64) reads 0.026,
#: 0.025 of it from that rounding.  A plain absolute limit would pass a
#: kernel wrong by a typical value in late causal rows, whose values are
#: near 0.03; a twin that drops one KV tile reads about 1 here.
K6_BF16_TOL = 5e-2
#: decode against prefill in an f32 copy of the full-width weights
#: (``allclose``): ten times the 7.6e-6 this comparison reads on the CPU
#: (32 layers, 256 tokens); the H100 reads 1.6e-5.  In bf16 the decode is
#: held against a prefill whose attention is the decode's own plain
#: function, by max abs error.  On the CPU the two agree bit for bit; on
#: the H100 they read 0.078 (5 bf16 steps of a logit of 2–4, logits up to
#: 4.7): cuBLAS's products for 4 rows and for 16,388 round differently and
#: 32 random-weight layers carry that to the logits.  Each check must also
#: see a planted fault, a widening copy that drops the prompt's last
#: position (0.15 in f32, 0.16 in bf16 on the H100).
DECODE_F32_TOL = 1e-4
DECODE_BF16_TOL = 0.1
#: the kernels each Phase 3 path runs, by the solver's sharded_phase3
PATH_KERNELS = {False: ("pointer_double", "pointer_double_rank"),
                True: ("pointer_double_shard", "pointer_double_rank_shard")}
MODES = {"sharded": {}, "replicated": {"sharded_phase3": False},
         "no_gather": {"gather_circuit": False}}
#: phase 10: the audited bucket's scale and widths, and the eviction
#: check's two buckets (A, then the larger B)
AUDIT_SCALE, AUDIT_WIDTHS = 8, (1, 2, 4, 8)
EVICT_SCALES = (16, 17)


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def entry_name(line: str) -> str:
    """The kernel a ``ptxas`` "Compiling entry function" line names, read
    from its mangled name (a length, the name, then any template
    argument): ``flash_bf16_kernel<64>``, ``pointer_double_kernel``."""
    m = re.search(r"(\d+)((?:flash|pointer|segment|loop)\w*)", line)
    digits, tail = m.groups() if m else ("", "")
    for i in range(len(digits)):        # the length is a suffix of digits
        n = int(digits[i:])
        if tail[:n].endswith("_kernel"):
            arg = re.match(r"I(?:Li)?(?:\d+(?=_))?(\w+?)E", tail[n:])
            return f"{tail[:n]}<{arg.group(1)}>" if arg else tail[:n]
    return line.strip()


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


def _timed_row(name, kernel, twin, ins, outs, kw, one, chained,
               nbytes=None, **extra) -> dict:
    """Time ``kernel`` (200 launches) and ``twin`` (50 calls) on ``ins``
    from CUDA events; the bound counts each input read once and each
    output written once (``nbytes`` where the tensors hold more than the
    work: K2's padding lane).  ``extra`` fields are printed too."""
    ms = cuda_ms(lambda: kernel(*ins, **kw, out=outs), 200)
    plain_ms = cuda_ms(lambda: twin(*ins, **kw), 50)
    if nbytes is None:
        nbytes = sum(x.numel() * x.element_size() for x in (*ins, *outs))
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    say("kernels", name=name, n=N_MAIN, bit_equal_1_step=one == 0,
        bit_equal_rounds=chained == 0, ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
        of_bound=f"{bound_ms / ms:.3f}", **extra)
    return {"max_abs_err": max(one, chained), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}


def _packed(fn):
    """K1's or K2's wrapper or packed twin (one record tensor in, one out)
    in the tuple form the round loop uses."""
    def run(rec, out=None):
        return (fn(rec) if out is None else fn(rec, out=out[0]),)
    return run


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
    # K1's packed records (nxt, lab) and K2's (ptr, dist, reach, 0)
    rec1 = torch.stack([nxt, lab], 1)
    rec = torch.stack([ptr, dist, reach, torch.zeros_like(ptr)], 1)
    # after the chained rounds a single cycle labels every stub 0, and a
    # chain reaches its halt from every stub with ranks 0 … N-1; K2's
    # bound counts its three tables (24 bytes an element), not the
    # record's padding lane
    cases = {
        "pointer_double": (_packed(pd.pointer_double),
                           _packed(ref.pointer_double_packed_ref), (rec1,),
                           lambda out: int(out[0][:, 1].max()) == 0, None),
        "pointer_double_rank": (_packed(pd.pointer_double_rank),
                                _packed(ref.pointer_double_rank_packed_ref),
                                (rec,),
                                lambda out: int(out[0][:, 2].min()) == 1
                                and int(out[0][:, 1].max()) == N_MAIN - 1,
                                24 * N_MAIN),
    }
    table = {}
    for name, (kernel, twin, ins, done, nbytes) in cases.items():
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
        extra = {}
        if name == "pointer_double":        # the two-array oracle, timed
            two_ms = cuda_ms(lambda: ref.pointer_double_ref(nxt, lab), 50)
            extra["plain_two_array_ms"] = f"{two_ms:.4f}"
        if name == "pointer_double_rank":   # the three-array oracle, timed
            three_ms = cuda_ms(
                lambda: ref.pointer_double_rank_ref(ptr, dist, reach), 50)
            extra["plain_three_array_ms"] = f"{three_ms:.4f}"
        table[name] = _timed_row(name, kernel, twin, ins, outs, {}, one,
                                 chained, nbytes, **extra)
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
        base = p3._ring_bases(me, 3, S, n)     # ring step k = 3: each row
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


def _countdown(x, changed):
    """One round of the loop test's check: x ← max(x − 1, 0), changed ←
    x > 0, in place."""
    def body():
        x.copy_((x - 1).clamp(min=0))
        changed.copy_(x > 0)
    return body


def _while_graph(dev, body, changed, rounds: int):
    """A CUDA graph of one while node around ``body``; returns it and its
    :class:`capture.Loops`."""
    loops = capture.Loops(dev)
    graph = torch.cuda.CUDAGraph()
    with capture.recording(graph, loops):
        capture.device_while(body, changed, rounds)
    return graph, loops


def check_loop_condition(dev, budgets) -> dict:
    """Phase 3: the splice loops' test kernel inside while nodes, at the
    main path's flag shapes ([8] partition rows in Phase 1, [] in Phase
    3) and budgets, against its twin driving the same loop on the host:
    each replay of a countdown from seeded values in [0, 2·budget) must
    run the twin's rounds and leave its bytes.  Timed as one test a
    round of a node whose body is the test alone (the node's relaunch of
    the body included), beside the twin's ops on the card."""
    rng = np.random.default_rng(0)
    err = 0
    for shape in ((PARTS,), ()):
        for rounds in budgets:
            x = torch.zeros(shape, dtype=torch.int32, device=dev)
            changed = torch.zeros(shape, dtype=torch.bool, device=dev)
            _countdown(x, changed)()                  # warm-up
            graph, loops = _while_graph(dev, _countdown(x, changed),
                                        changed, rounds)
            for _ in range(4):
                x0 = torch.as_tensor(rng.integers(0, 2 * rounds, size=shape),
                                     dtype=torch.int32)
                x.copy_(x0)
                changed.copy_(x0 > 0)
                graph.replay()
                want_x, want_changed = x0.clone(), x0 > 0
                want_ctr = torch.zeros((), dtype=torch.int32)
                graph_loop.while_loop(_countdown(want_x, want_changed),
                                      want_changed, want_ctr, rounds)
                err = max(err, abs(loops.rounds_run()[0] - int(want_ctr)),
                          max_abs_err((x.cpu(), changed.cpu().int()),
                                      (want_x, want_changed.int())))
            del graph, loops
    rounds = 1000
    always = torch.ones((PARTS,), dtype=torch.bool, device=dev)
    graph, loops = _while_graph(dev, lambda: None, always, rounds)
    graph.replay()
    ran = loops.rounds_run()[0]
    ms = cuda_ms(graph.replay, 5) / (rounds + 1)
    ctr = torch.zeros((), dtype=torch.int32, device=dev)
    plain_ms = cuda_ms(lambda: ref.loop_condition_ref(always, ctr, rounds),
                       200)
    bound_ms = (PARTS + 8) / HBM_BYTES_PER_S * 1e3
    say("kernels", name="loop_condition", shapes="'[8],[]'",
        budgets=",".join(map(str, budgets)), max_abs_err=err,
        rounds_run=f"{ran}/{rounds}", ms_a_round=f"{ms:.5f}",
        plain_ms=f"{plain_ms:.5f}", bound_ms=f"{bound_ms:.3e}")
    if err or ran != rounds:
        raise AssertionError(f"loop_condition differs from its twin: error "
                             f"{err}, {ran} of {rounds} rounds")
    del graph, loops
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}


def reset_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def counting_rounds(rounds: list):
    """A stand-in for ``capture.converge`` that appends ``(module, rounds
    run, budget)`` for every splice loop."""
    def wrap(module):
        def converge(step, carry, budget):
            ran = [0]

            def counted(*args):
                ran[0] += 1
                return step(*args)
            out = capture.converge(counted, carry, budget)
            rounds.append((module, ran[0], budget))
            return out
        return converge
    return wrap


def solve_counted(g, **opts):
    """An eager ``solve`` on ``cuda`` with every launch counter set to 0
    just before and read just after; returns ``(result, launches, peak,
    rounds)``, ``rounds`` the ``(loop, rounds run, budget)`` of every
    splice loop."""
    rounds = []
    wrap = counting_rounds(rounds)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(p1, "converge", wrap("phase1")), \
            mock.patch.object(p3, "converge", wrap("phase3")):
        res = solve(g, n_parts=PARTS, device="cuda", fused=False, **opts)
    launches = read_counts()
    return res, launches, torch.cuda.max_memory_allocated(), rounds


def recorded_counts(fn):
    """``fn()`` with the launch counters set to 0 just before each
    recording of a fused run and read just after; returns ``(fn's value,
    [the counts of each recording])``."""
    recorded = []
    record = FusedRun._record

    def counted(run):
        reset_counts()
        record(run)
        recorded.append(read_counts())
    with mock.patch.object(FusedRun, "_record", counted):
        out = fn()
    return out, recorded


def fused_counted(solver, g):
    """A fused ``solver.solve(g)`` on ``cuda``: the launch counters are
    set to 0 just before the solve and read just after, and separately
    around the graph's recording if the solve records one.  Returns
    ``(result, launches of the solve, launches while recording or None,
    peak allocated, peak reserved)``."""
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    res, recorded = recorded_counts(lambda: solver.solve(g))
    if not recorded:
        launches = read_counts()
    else:
        launches = None                 # the warm-up's and the recording's
    return (res, launches, recorded[0] if recorded else None,
            torch.cuda.max_memory_allocated(),
            torch.cuda.max_memory_reserved())


def same_bytes(a, b) -> bool:
    return (np.array_equal(a.circuit, b.circuit)
            and np.array_equal(a.mate, b.mate))


def fused_run(solver, g) -> FusedRun:
    """The session's fused run of ``g``'s bucket (its engine's program)."""
    key = solver.bucket_of(g)
    return solver._engines[key].fused_program(key[0])


def _fmt_rounds(loops, ran) -> str:
    """``phase1:2/16,…`` from the eager ``(loop, rounds, budget)`` list
    and a list of rounds run."""
    return "'" + ",".join(f"{m}:{r}/{b}" for (m, _, b), r
                          in zip(loops, ran)) + "'"


def check_fused(scale: int, g, eager: dict, eager_rounds: dict) -> int:
    """Phase 5b: the fused run (module docstring).  ``eager`` and
    ``eager_rounds`` hold the ``[slice]`` results of ``g`` and their
    splice loops' ``(loop, rounds, budget)``, by ``sharded_phase3``.
    Returns the test kernels launched while the cold sharded solve
    recorded."""
    small = eulerian_rmat(8, avg_degree=AVG_DEGREE, seed=SEED)
    for mode, opts in MODES.items():
        loops = capture.Loops(torch.device("cpu"))
        with capture.counting(loops):
            ref = solve(small, n_parts=2, device="cuda", fused=False,
                        **opts).validate()
        for device in ("cuda", "cpu"):
            solver = EulerSolver(n_parts=2, device=device, **opts)
            r = solver.solve(small).validate()
            ran = fused_run(solver, small).rounds_run()
            same = r.fused and same_bytes(ref, r)
            say("fused", scale=8, parts=2, mode=mode, device=device,
                byte_identical_to_eager=same, rounds_run=ran,
                eager_rounds=loops.rounds_run())
            if not same:
                raise AssertionError(f"fused {mode} solve on {device} "
                                     f"differs from the eager one")
            if ran != loops.rounds_run():
                raise AssertionError(f"fused {mode} solve on {device} ran "
                                     f"{ran} splice rounds, eager "
                                     f"{loops.rounds_run()}")

    def report(res, solver, seed, launches, recorded, peak, reserved,
               base, want_rounds):
        ran = fused_run(solver, res.graph).rounds_run()
        plain_s = base.timings["supersteps_s"] + base.timings["phase3_s"]
        say("fused", scale=scale,
            phase3="sharded" if solver.sharded_phase3 else "replicated",
            seed=seed, edges=res.graph.num_edges, valid=res.valid,
            captures=solver.captures,
            launches=json.dumps(launches, separators=(",", ":")),
            recorded_launches=json.dumps(recorded, separators=(",", ":")),
            peak_gib=f"{peak / 2**30:.3f}",
            reserved_gib=f"{reserved / 2**30:.3f}",
            rounds_run=_fmt_rounds(want_rounds, ran),
            eager_rounds=_fmt_rounds(want_rounds,
                                     [r for _, r, _ in want_rounds]),
            eager_supersteps_plus_phase3_s=f"{plain_s:.4f}",
            run_over_eager=f"{res.timings['run_s'] / plain_s:.3f}",
            **{k: f"{v:.4f}" for k, v in res.timings.items()})
        if ran != [r for _, r, _ in want_rounds]:
            raise AssertionError(f"seed {seed}: the replay's splice loops "
                                 f"ran {ran}, the eager ones "
                                 f"{want_rounds}")
        if not same_bytes(res, base):
            raise AssertionError(f"fused solve of seed {seed} differs from "
                                 f"the eager one")

    for sharded in (True, False):
        phase3 = "sharded" if sharded else "replicated"
        solver = EulerSolver(n_parts=PARTS, sharded_phase3=sharded)
        res, launches, recorded, peak, reserved = fused_counted(solver, g)
        res.validate()
        report(res, solver, SEED, launches, recorded, peak, reserved,
               eager[sharded], eager_rounds[sharded])
        cold = res
        rounds = p3.sharded_phase3_schedule(
            g.num_edges + res.padded_edges, PARTS)["doubling_rounds"]
        want = {name: 0 for name in KERNELS}
        want.update({name: rounds * (PARTS if sharded else 1)
                     for name in PATH_KERNELS[sharded]})
        want["loop_condition"] = 2 * len(eager_rounds[sharded])
        if recorded != want:
            raise AssertionError(f"{phase3} recording launched {recorded}, "
                                 f"the eager solve and the loops {want}")
        if solver.captures != 1 or res.timings["capture_s"] <= 0:
            raise AssertionError("the cold fused solve did not record")
        if sharded:
            loop_tests = recorded["loop_condition"]
            g1 = eulerian_rmat(scale, avg_degree=AVG_DEGREE, seed=SEED + 1)
            key0, key1 = solver.bucket_of(g), solver.bucket_of(g1)
            say("fused", seed=SEED + 1, edges=g1.num_edges,
                bucket=f"'{key1}'", same_bucket=key0 == key1)
            if key0 != key1:
                raise AssertionError(f"seed {SEED + 1} lands in another "
                                     f"bucket: {key1} against {key0}")
            # seed 1 eagerly, for its own rounds and bytes; its
            # allocations come and go between the graph's two runs
            base1, _, _, rounds1 = solve_counted(g1, sharded_phase3=True)
            torch.cuda.empty_cache()        # reserved: the graph's alone
            res, launches, recorded, peak, reserved = fused_counted(solver,
                                                                    g1)
            res.validate()
            report(res, solver, SEED + 1, launches, recorded, peak,
                   reserved, base1, rounds1)
            twin = strip_circuit(circuit_from_mate_np(res.mate, 0),
                                 g1.num_edges)
            if recorded is not None or solver.captures != 1 \
                    or res.timings["capture_s"] != 0.0 \
                    or any(launches.values()):
                raise AssertionError("the same-bucket solve did not "
                                     "replay the recorded graph")
            if not np.array_equal(twin, res.circuit):
                raise AssertionError("replayed circuit differs from the "
                                     "numpy list-rank twin")
            del base1
            session_repeat(scale, solver, g, cold)
            check_async(scale, solver, (g, g1), (cold, res))
            del g1
        del solver, res, cold
        torch.cuda.empty_cache()
    return loop_tests


def resident_bytes(eng: Engine) -> list:
    """Bytes of each graph state the engine keeps on the card."""
    return [sum(t.numel() * t.element_size()
                for t in (*ent["dev"][0], *ent["dev"][1:]))
            for ent in eng._load_cache.values() if ent["dev"] is not None]


def session_repeat(scale: int, solver, g, cold) -> None:
    """Phase 5c at the main scale, in 5b's sharded solver after seed 1's
    replay: seed 0 again with the same ``Graph`` object must be a cache
    hit that skips the host prep (memo) and the upload (resident state),
    byte-equal to 5b's cold solve of it."""
    up0 = solver.cache_stats.state_uploads
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = solver.solve(g).validate()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    key = solver.bucket_of(g)
    eng = solver._engines[key]
    run = eng.fused_program(key[0])
    t, c = res.timings, cold.timings
    say("session", scale=scale, seed=SEED, repeat=True, hit=res.cache.hit,
        same_bytes_as_cold=same_bytes(res, cold),
        **{k: f"{t[k]:.4f}" for k in ("prepare_s", "upload_s", "run_s",
                                       "total_s")},
        **{f"cold_{k}": f"{c[k]:.4f}" for k in ("prepare_s", "upload_s",
                                                 "run_s", "total_s")},
        cache_stats=json.dumps(dataclasses.asdict(solver.cache_stats),
                               separators=(",", ":")),
        reserved_bytes=run.reserved_bytes,
        resident_state_bytes=",".join(map(str, resident_bytes(eng))),
        launches=json.dumps(launches, separators=(",", ":")),
        peak_gib=f"{peak / 2**30:.3f}", reserved_gib=f"{reserved / 2**30:.3f}")
    if not res.cache.hit or t["capture_s"] != 0.0 or any(launches.values()):
        raise AssertionError("the repeat solve did not replay the cached "
                             "graph")
    if t["prepare_s"] >= 0.05:
        raise AssertionError(f"the repeat solve took {t['prepare_s']} s of "
                             f"host prep: the memo missed")
    if solver.cache_stats.state_uploads != up0:
        raise AssertionError("the repeat solve uploaded its state again")
    if not same_bytes(res, cold):
        raise AssertionError("the repeat solve differs from the cold one")


def fresh(g: Graph) -> Graph:
    """A new ``Graph`` over copies of ``g``'s edge arrays: the session's
    prep memo (keyed by the object) misses, nothing is regenerated."""
    return Graph(g.num_vertices, g.edge_u.copy(), g.edge_v.copy())


def forget(solver, g: Graph) -> None:
    """Drop ``g``'s prep memo entry and its resident state from the
    session, so the card's memory holds only what a later phase made."""
    _, (pg, _, key) = solver._prep_cache.pop(id(g))
    solver._engines[key]._load_cache.pop(id(pg))


def copyout_choices(run: FusedRun, repeats: int = 3) -> dict:
    """Milliseconds from an idle card to the run's static outputs as
    numpy on the host, two ways, in turns: pinned host buffers filled by
    ``copy_(non_blocking=True)`` then one synchronization (what
    ``FusedRun`` does), and device copies then ``.cpu()`` after the
    synchronization; medians of ``repeats``."""
    def pinned():
        host = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                for x in run.out]
        for h, x in zip(host, run.out):
            h.copy_(x, non_blocking=True)
        torch.cuda.synchronize()
        return [h.numpy() for h in host]

    def device_then_cpu():
        dev = [x.clone() for x in run.out]
        torch.cuda.synchronize()
        return [x.cpu().numpy() for x in dev]

    times = {"pinned": [], "device_then_cpu": []}
    for _ in range(repeats):
        for name, fn in (("pinned", pinned),
                         ("device_then_cpu", device_then_cpu),
                         ("device_then_cpu", device_then_cpu),
                         ("pinned", pinned)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            times[name].append(1e3 * (time.perf_counter() - t))
    return {f"copyout_{k}_ms": f"{float(np.median(v)):.3f}"
            for k, v in times.items()}


def sequential_pair(solver, graphs):
    """Seed 0's and seed 1's graphs in new objects, one ``solve`` after
    the other; returns ``(results, seconds, launches)``.  Their memo
    entries and states are dropped after."""
    seq = [fresh(g) for g in graphs]
    reset_counts()
    t = time.perf_counter()
    res = [solver.solve(h) for h in seq]
    sec = time.perf_counter() - t
    launches = read_counts()
    for h in seq:
        forget(solver, h)
    return res, sec, launches


def pipelined_pair(solver, graphs):
    """The same two graphs in new objects, pipelined: ``solve_async(A)``,
    ``solve_async(B)`` (whose host prep runs while A replays), then
    both ``result()``s.  Returns the results, the seconds, the launches,
    A's replay event time, whether A was ready when B's dispatch
    returned, the dispatches' seconds, the peak allocated and reserved
    bytes and the host seconds of each dispatch's spans."""
    a, b = (fresh(g) for g in graphs)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n_spans = len(solver.trace.spans())
    reset_counts()
    t = time.perf_counter()
    pa = solver.solve_async(a)
    pb = solver.solve_async(b)
    dispatched_s = time.perf_counter() - t
    a_ready = pa.ready()
    res = [pa.result(), pb.result()]
    sec = time.perf_counter() - t
    launches = read_counts()
    spans = ",".join(f"{x['name']}:{x['dur_s']:.4f}"
                     for x in solver.trace.spans()[n_spans:])
    out = {"results": res, "seconds": sec, "launches": launches,
           "replay_s": pa._run.replay_s, "a_ready": a_ready,
           "dispatched_s": dispatched_s,
           "peak": torch.cuda.max_memory_allocated(),
           "reserved": torch.cuda.max_memory_reserved(), "spans": spans}
    for h in (a, b):
        forget(solver, h)
    return out


def launch_breakdown(solver, g) -> dict:
    """Host seconds of the parts of one launch of ``g`` (resident, its
    program live): the whole ``solve_async``, the copies into the static
    inputs, the graph's ``replay()`` call and the pinned copy-out."""
    from repro_torch.core import engine as eng_mod

    spent = {"load": 0.0, "replay": 0.0, "pinned": 0.0}

    def timed(name, fn):
        def run(*args, **kw):
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent[name] += time.perf_counter() - t
        return run

    with mock.patch.object(FusedRun, "_load", timed("load", FusedRun._load)), \
            mock.patch.object(torch.cuda.CUDAGraph, "replay",
                              timed("replay", torch.cuda.CUDAGraph.replay)), \
            mock.patch.object(eng_mod, "_pinned_copy",
                              timed("pinned", eng_mod._pinned_copy)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        pending = solver.solve_async(g)
        dispatch_s = time.perf_counter() - t
        pending.result()
    return {"dispatch_s": f"{dispatch_s:.4f}",
            **{f"{k}_s": f"{v:.4f}" for k, v in spent.items()}}


def host_work(n: int = 4_000_000) -> float:
    """Seconds of a fixed host workload like the host prep's (a Python
    loop, then numpy sorts)."""
    t = time.perf_counter()
    acc = 0
    for i in range(n):
        acc += i & 7
    x = np.random.default_rng(0).integers(0, 1 << 30, 1 << 22)
    for _ in range(3):
        np.sort(x)
    return time.perf_counter() - t


def host_contention(solver, g) -> dict:
    """Whether a replay in flight slows the host: :func:`host_work` with
    the card idle and right after ``solve_async(g)`` returned (its
    replay running), each twice in turns; and the process's CPU seconds
    (all threads) over one replay whose host only polls ``ready()``."""
    idle, during = [], []
    for turn in ("idle", "during", "during", "idle"):
        torch.cuda.synchronize()
        if turn == "idle":
            idle.append(host_work())
            continue
        pending = solver.solve_async(g)
        during.append(host_work())
        busy = not pending.ready()
        pending.result()
        if not busy:
            raise AssertionError("the host workload outlasted the replay")
    torch.cuda.synchronize()
    c, t = time.process_time(), time.perf_counter()
    pending = solver.solve_async(g)
    launched_cpu = time.process_time() - c
    while not pending.ready():
        time.sleep(0.005)
    wall, cpu = time.perf_counter() - t, time.process_time() - c
    pending.result()
    return {"host_work_idle_s": ",".join(f"{x:.4f}" for x in idle),
            "host_work_during_replay_s": ",".join(f"{x:.4f}"
                                                  for x in during),
            "polled_replay_wall_s": f"{wall:.4f}",
            "polled_replay_cpu_s": f"{cpu:.4f}",
            "launch_cpu_s": f"{launched_cpu:.4f}"}


def check_async(scale: int, solver, graphs, colds) -> None:
    """Phase 5d at the main scale, in 5b's sharded session: seed 0's and
    seed 1's graphs (``graphs``, 5b's results ``colds``) in new ``Graph``
    objects, solved in sequence and pipelined, three times each in
    turns (sequence, pipeline, pipeline, sequence, sequence, pipeline),
    so that the host prep's drift and spread fall on both."""
    captures = solver.captures
    say("async", **launch_breakdown(solver, graphs[0]))
    say("async", **host_contention(solver, graphs[0]))
    seqs, pipes = [], []
    for turn in ("seq", "pipe", "pipe", "seq", "seq", "pipe"):
        if turn == "seq":
            seqs.append(sequential_pair(solver, graphs))
            res, sec, launches = seqs[-1]
            say("async", turn=turn, seconds=f"{sec:.4f}")
        else:
            pipes.append(pipelined_pair(solver, graphs))
            p = pipes[-1]
            res, sec, launches = p["results"], p["seconds"], p["launches"]
            say("async", turn=turn, seconds=f"{sec:.4f}",
                a_replay_event_s=f"{p['replay_s']:.4f}",
                dispatched_s=f"{p['dispatched_s']:.4f}",
                a_ready_after_b_dispatch=p["a_ready"],
                peak_gib=f"{p['peak'] / 2**30:.3f}",
                reserved_gib=f"{p['reserved'] / 2**30:.3f}",
                spans=f"'{p['spans']}'")
        for name, r in zip("ab", res):
            say("async", turn=turn, solve=name, hit=r.cache.hit,
                **{k: f"{v:.4f}" for k, v in r.timings.items()})
        same = [same_bytes(r.validate(), c) for r, c in zip(res, colds)]
        if not all(same):
            raise AssertionError(f"5d {turn}: a solve differs from 5b's "
                                 f"bytes ({same})")
        if any(r.timings["capture_s"] for r in res):
            raise AssertionError(f"5d {turn}: a solve recorded a graph")
        if any(launches.values()):
            raise AssertionError(f"5d {turn}: a kernel was launched from "
                                 f"Python: {launches}")
    seq_s = float(np.mean([sec for _, sec, _ in seqs]))
    pipelined_s = float(np.mean([p["seconds"] for p in pipes]))
    a_run_s = float(np.mean([p["results"][0].timings["run_s"]
                             for p in pipes]))
    saved = seq_s - pipelined_s

    def host_side(results):
        return sum(r.timings["prepare_s"] + r.timings["upload_s"]
                   for r in results)

    # the saving less the difference of the host prep and upload the two
    # ways measured: what the overlap saved, whatever the prep's spread
    net = saved - (float(np.mean([host_side(r) for r, _, _ in seqs]))
                   - float(np.mean([host_side(p["results"]) for p in pipes])))
    key = solver.bucket_of(graphs[0])
    say("async", scale=scale, seq_s=f"{seq_s:.4f}",
        pipelined_s=f"{pipelined_s:.4f}", saved_s=f"{saved:.4f}",
        saved_net_of_host_prep_s=f"{net:.4f}",
        a_run_s=f"{a_run_s:.4f}", saved_over_a_run=f"{saved / a_run_s:.3f}",
        a_ready_after_b_dispatch=all(p["a_ready"] for p in pipes),
        captures=solver.captures - captures, same_bytes_as_5b=True,
        **copyout_choices(solver._engines[key].fused_program(key[0])))
    if solver.captures != captures:
        raise AssertionError("the 5d solves recorded a graph")
    # the host prep of one cold graph spreads by seconds between runs
    # (8.4-12.9 s at scale 20 on the H100's host), so over three turns
    # the raw saving carries about a second of noise: the overlap is
    # held net of the two ways' host prep, the raw saving to a win
    if net < 0.8 * a_run_s:
        raise AssertionError(f"the overlap saved {net:.3f} s net of the "
                             f"host prep, under 0.8 of A's run_s "
                             f"{a_run_s:.3f} s")
    if saved <= 0:
        raise AssertionError(f"the pipeline took {-saved:.3f} s longer "
                             f"than the sequence")


def check_async_small(scale: int = 8, seeds: int = 30,
                      devices=("cuda", "cpu")) -> None:
    """Phase 5d at scale 8, P = 8, on ``cuda`` and on ``cpu``: the modal
    bucket's 8 graphs all dispatched, then fetched in reverse order, each
    byte-equal to its one-shot solve; under ``program_cache_max=1`` a
    replay of A in flight while B's dispatch evicts A's program."""
    pool = [eulerian_rmat(scale, avg_degree=AVG_DEGREE, seed=s)
            for s in range(seeds)]
    for device in devices:
        solver = EulerSolver(n_parts=PARTS, device=device)
        buckets = {}
        for g in pool:
            buckets.setdefault(solver.bucket_of(g), []).append(g)
        ranked = sorted(buckets.values(), key=len, reverse=True)
        group, b = ranked[0][:8], ranked[1][0]
        want = {id(g): solve(g, n_parts=PARTS, device=device)
                for g in (*group, b)}
        pending = [solver.solve_async(g) for g in group]
        got = [p.result() for p in reversed(pending)][::-1]
        same = all(same_bytes(r.validate(), want[id(g)])
                   for g, r in zip(group, got))
        cs = solver.cache_stats
        s1 = EulerSolver(n_parts=PARTS, device=device, program_cache_max=1)
        a = group[0]
        s1.solve(a)
        pa = s1.solve_async(a)              # a replay of A in flight
        pb = s1.solve_async(b)              # evicts A's program
        evicted = s1.cache_stats.evictions
        same_evicted = (same_bytes(pa.result().validate(), want[id(a)])
                        and same_bytes(pb.result().validate(), want[id(b)]))
        say("async", scale=scale, parts=PARTS, device=device,
            in_flight=len(pending), fetched="reverse",
            same_bytes_as_one_shot=same, traces=cs.traces, hits=cs.hits,
            evictions_in_flight=evicted,
            evicted_pending_same_bytes=same_evicted)
        if not same:
            raise AssertionError(f"in-flight pendings on {device} differ "
                                 f"from one-shot solves")
        if (cs.traces, cs.misses, cs.hits) != (1, 1, len(group) - 1):
            raise AssertionError(f"in-flight pendings on {device}: {cs}")
        if evicted != 1 or not same_evicted:
            raise AssertionError(f"eviction of an in-flight program on "
                                 f"{device}: {evicted} evictions, same "
                                 f"bytes {same_evicted}")
        del solver, s1, pending, got
        if device == "cuda":
            torch.cuda.empty_cache()


def measured_evictions(drops: list):
    """A stand-in for ``Engine.evict_program`` that appends, for each
    program it frees, ``(reserved_bytes of the run, fall of the card's
    reserved memory across the eviction and its empty_cache)``."""
    evict = Engine.evict_program

    def measured(eng, num_edges, batch):
        held = eng._fused[(num_edges, batch)].reserved_bytes
        before = torch.cuda.memory_reserved()
        n = evict(eng, num_edges, batch)
        drops.append((held, before - torch.cuda.memory_reserved()))
        return n
    return mock.patch.object(Engine, "evict_program", measured)


def check_session(scale: int = 8, seeds: int = 30,
                  devices=("cuda", "cpu")) -> None:
    """Phase 5c at scale 8, P = 8, on ``cuda`` and on ``cpu`` (module
    docstring); the one-shot solves run on the first device."""
    pool = [eulerian_rmat(scale, avg_degree=AVG_DEGREE, seed=s)
            for s in range(seeds)]
    want = {}
    for device in devices:
        solver = EulerSolver(n_parts=PARTS, device=device)
        buckets = {}
        for g in pool:
            buckets.setdefault(solver.bucket_of(g), []).append(g)
        ranked = sorted(buckets.values(), key=len, reverse=True)
        group, other = ranked[0][:8], ranked[1]
        results = solver.solve_many(group)
        cs = solver.cache_stats
        if not want:    # one-shot solves, each a fresh session
            want = {id(g): solve(g, n_parts=PARTS, device=device)
                    for g in group}
        same = all(same_bytes(r.validate(), want[id(g)])
                   for g, r in zip(group, results))
        say("session", scale=scale, parts=PARTS, device=device,
            buckets=",".join(str(len(v)) for v in ranked),
            solve_many=len(group), traces=cs.traces, misses=cs.misses,
            hits=cs.hits, same_bytes_as_one_shot=same)
        if (cs.traces, cs.misses, cs.hits) != (1, 1, len(group) - 1):
            raise AssertionError(f"solve_many on {device}: {cs}")
        if not same:
            raise AssertionError(f"solve_many on {device} differs from "
                                 f"one-shot solves")
        a, b = group[0], other[0]
        firsts = {id(a): results[0], id(b): None}
        for cap in (None, 1):
            s = solver if cap is None else EulerSolver(
                n_parts=PARTS, device=device, program_cache_max=1)
            drops = []
            patch = (measured_evictions(drops) if device == "cuda"
                     else contextlib.nullcontext())
            with patch:
                seq = [s.solve(g).validate() for g in (a, b, a, b)]
            for g, r in zip((a, b, a, b), seq):
                firsts[id(g)] = firsts[id(g)] or r
                if not same_bytes(r, firsts[id(g)]):
                    raise AssertionError(f"A/B/A/B on {device} "
                                         f"(program_cache_max={cap}): a "
                                         f"replay differs")
            live = [k for k, eng in s._engines.items() if eng._fused]
            cs = s.cache_stats
            say("session", device=device,
                program_cache_max=cap or s.program_cache_max,
                sequence="ABAB", hits=[int(r.cache.hit) for r in seq],
                live_programs=len(live), evictions=cs.evictions,
                traces=cs.traces, state_uploads=cs.state_uploads,
                reserved_bytes=[eng.reserved_bytes()
                                for eng in s._engines.values()],
                eviction_drops=";".join(f"{f}/{h}" for h, f in drops))
            if cap is None and (len(live) != 2 or cs.evictions):
                raise AssertionError(f"both programs should stay alive: "
                                     f"{live}, {cs.evictions} evictions")
            if cap == 1:
                if cs.evictions != 3 or len(live) != 1:
                    raise AssertionError(f"program_cache_max=1: "
                                         f"{cs.evictions} evictions, "
                                         f"{len(live)} live")
                if len(s._engines) != 2 or cs.state_uploads != 2:
                    raise AssertionError("the engines and their resident "
                                         "states should outlive evictions")
                if device == "cuda" and (len(drops) != 3 or any(
                        f < 0.9 * h or h <= 0 for h, f in drops)):
                    raise AssertionError(f"an eviction freed too little: "
                                         f"{drops} (freed, held)")
            del s, seq
        del solver, results
        if device == "cuda":
            torch.cuda.empty_cache()


def modal_group(solver, scale: int = 8, seeds: int = 30) -> list:
    """5c's modal bucket: the first 8 of ``seeds`` scale-``scale`` graphs
    that share the most common bucket."""
    buckets = {}
    for s in range(seeds):
        g = eulerian_rmat(scale, avg_degree=AVG_DEGREE, seed=s)
        buckets.setdefault(solver.bucket_of(g), []).append(g)
    return sorted(buckets.values(), key=len, reverse=True)[0][:8]


def check_batched_kernels(dev, e_cap: int, batch: int) -> None:
    """Phase 5e: K1–K4 against their twins at a batched program's shapes,
    one round (K3/K4: one ring step, k = 3): K1/K2 on the flat table of
    ``batch`` graphs of ``2·e_cap`` stubs, each a seeded cycle (K1) or
    chain (K2) of its own offset by b·2E; K3/K4 on ``[n·B, S]`` rows,
    (partition, graph) pairs, each with its partition's ring base."""
    rng = np.random.default_rng(1)
    n2 = 2 * e_cap
    succ, ptr = [], []
    for b in range(batch):
        su, pt, _ = chain(n2, rng)
        succ.append(su + b * n2)
        ptr.append(pt + b * n2)
    succ = torch.as_tensor(np.concatenate(succ), device=dev)
    ptr = torch.as_tensor(np.concatenate(ptr), device=dev)
    iota = torch.arange(batch * n2, dtype=torch.int32, device=dev)
    halt = (ptr == iota).to(torch.int32)
    rec1 = torch.stack([succ, iota], 1)
    rec2 = torch.stack([ptr, 1 - halt, halt, torch.zeros_like(ptr)], 1)
    errs = {
        "pointer_double": max_abs_err(
            (pd.pointer_double(rec1),),
            (ref.pointer_double_packed_ref(rec1),)),
        "pointer_double_rank": max_abs_err(
            (pd.pointer_double_rank(rec2),),
            (ref.pointer_double_rank_packed_ref(rec2),)),
    }
    S = p3.shard_width(e_cap, PARTS)
    rows = PARTS * batch
    me, _ = p3._shard_ids(rows, S, batch, dev)
    base = p3._ring_bases(me, 3, S, PARTS)

    def ints(hi):
        return torch.as_tensor(rng.integers(0, hi, size=(rows, S)),
                               dtype=torch.int32, device=dev)
    q = ints(PARTS * S)
    zero = torch.zeros_like(q)
    cases = {
        "pointer_double_shard": (
            pd.pointer_double_shard, ref.pointer_double_shard_ref,
            (q, q, torch.full_like(q, p3.BIG), base, ints(PARTS * S),
             ints(PARTS * S))),
        "pointer_double_rank_shard": (
            pd.pointer_double_rank_shard, ref.pointer_double_rank_shard_ref,
            (q, q, zero, zero, base, ints(PARTS * S), ints(n2), ints(2))),
    }
    for name, (kernel, twin, ins) in cases.items():
        errs[name] = max_abs_err(kernel(*ins, s_real=S), twin(*ins, s_real=S))
    say("batch", kernels_at_width=batch, e_cap=e_cap, flat_rows=batch * n2,
        shard_rows=rows, shard_width=S,
        **{f"{k}_max_abs_err": v for k, v in errs.items()})
    if any(errs.values()):
        raise AssertionError(f"a kernel differs from its twin at the "
                             f"batched shapes: {errs}")


BATCH_WIDTHS = (1, 3, 8)


def batch_widths(solver, group, device, want, mode) -> None:
    """Phase 5e at scale 8 in one session: the group's one-graph solves
    (each loop's rounds read after each), then ``solve_batch`` at each of
    ``BATCH_WIDTHS`` twice; each member validated and byte-equal to
    ``want`` (the card's one-graph solves); traces 1 → 1 → 2 → 3 and a
    hit on each repeat; on the card the launches counted around each
    batched recording equal the one-graph recording's, two loop tests a
    loop; a batch's loops run the most any member ran alone."""
    singles, rounds = [], []

    def one_at_a_time():
        for g in group:
            singles.append(solver.solve(g).validate())
            rounds.append(fused_run(solver, g).rounds_run())
    _, rec1 = recorded_counts(one_at_a_time)
    if not want:
        want.extend(singles)
    key = solver.bucket_of(group[0])
    traces = [solver.cache_stats.traces]
    for B in BATCH_WIDTHS:
        got, rec = recorded_counts(lambda: solver.solve_batch(group[:B]))
        again = solver.solve_batch(group[:B])
        traces.append(solver.cache_stats.traces)
        same = all(same_bytes(r.validate(), w) and same_bytes(a, w)
                   and r.cache.batch == a.cache.batch == B
                   for r, a, w in zip(got, again, want))
        run = solver._engines[key].fused_program(key[0],
                                                 None if B == 1 else B)
        ran = run.rounds_run()
        most = [max(col) for col in zip(*rounds[:B])]
        say("batch", scale=8, parts=PARTS, mode=mode, device=device,
            width=B, same_bytes_as_single=same, traces=traces[-1],
            hit_on_repeat=again[0].cache.hit,
            rounds_run=",".join(map(str, ran)),
            members_most=",".join(map(str, most)),
            recorded_launches=json.dumps(rec[0] if rec else None,
                                         separators=(",", ":")),
            one_graph_recorded=json.dumps(rec1[0] if rec1 else None,
                                          separators=(",", ":")))
        if not same:
            raise AssertionError(f"{mode} batch of {B} on {device} differs "
                                 f"from the one-graph solves")
        if not again[0].cache.hit or ran != most:
            raise AssertionError(f"{mode} batch of {B} on {device}: hit "
                                 f"{again[0].cache.hit}, rounds {ran}, "
                                 f"members' most {most}")
        if device == "cuda" and B > 1:
            if len(rec) != 1 or rec[0] != rec1[0] \
                    or rec[0]["loop_condition"] != 2 * len(ran):
                raise AssertionError(f"{mode} batch of {B}: recorded "
                                     f"{rec}, one graph {rec1}")
    if traces != [1, 1, 2, 3]:
        raise AssertionError(f"{mode} on {device}: traces {traces}")


def replay_ms(solver, group, batched: bool, turns: int = 3) -> list:
    """Replay event times in ms, ``turns`` of them, of warm programs on
    the card: the batch of the whole group in one replay (``batched``),
    or each graph's one-graph replay, all in flight (one entry a
    graph)."""
    out = []
    for _ in range(turns):
        if batched:
            pending = solver.solve_batch_async(group)
            pending.results()
            out.append(1e3 * pending._run.replay_s)
        else:
            pending = [solver.solve_async(g) for g in group]
            for p in pending:
                p.result()
            out.extend(1e3 * p._run.replay_s for p in pending)
    return out


def batch_throughput(solver, group, want, turns: int = 3) -> dict:
    """Phase 5e at scale 8 on the card, warm programs and resident
    states: ``solve_many`` of the 8 graphs with ``batch=None`` and with
    ``batch=8`` in turns (None, 8, 8, None, None, 8), graphs a second
    from each median; then a B = 8 replay's event time against eight
    one-graph replays' (:func:`replay_ms`), medians of ``turns``."""
    walls = {None: [], 8: []}
    for i in range(turns):
        for b in ((None, 8) if i % 2 == 0 else (8, None)):
            t = time.perf_counter()
            res = solver.solve_many(group, batch=b)
            walls[b].append(time.perf_counter() - t)
            if not all(same_bytes(r, w) for r, w in zip(res, want)):
                raise AssertionError(f"solve_many(batch={b}) differs")
    one = replay_ms(solver, group, False, turns)
    med = {b: float(np.median(v)) for b, v in walls.items()}
    out = {"graphs_per_s_b1": len(group) / med[None],
           "graphs_per_s_b8": len(group) / med[8],
           "replay_ms_b8": float(np.median(replay_ms(solver, group, True,
                                                     turns))),
           "replay_ms_b1": float(np.median(one))}
    out["replay_ms_8x_b1"] = len(group) * out["replay_ms_b1"]
    say("batch", scale=8, parts=PARTS, throughput="solve_many",
        wall_s_b1=",".join(f"{x:.4f}" for x in walls[None]),
        wall_s_b8=",".join(f"{x:.4f}" for x in walls[8]),
        gain=f"{out['graphs_per_s_b8'] / out['graphs_per_s_b1']:.3f}",
        replay_over_b1=f"{out['replay_ms_b8'] / out['replay_ms_b1']:.3f}",
        **{k: f"{v:.4f}" for k, v in out.items()})
    return out


def check_batch(dev, scale: int = 8, seeds: int = 30,
                devices=("cuda", "cpu")) -> None:
    """Phase 5e at scale 8, P = 8 (module docstring)."""
    for mode, opts in MODES.items():
        want = []
        for device in devices:
            solver = EulerSolver(n_parts=PARTS, device=device, **opts)
            group = modal_group(solver, scale, seeds)
            batch_widths(solver, group, device, want, mode)
            if device == "cuda" and mode == "sharded":
                key = solver.bucket_of(group[0])
                check_batched_kernels(dev, key[0], 8)
                batch_throughput(solver, group, want)
            del solver
            if device == "cuda":
                torch.cuda.empty_cache()


def check_batch_large(scale: int, smi: str, seeds: int = 8) -> None:
    """Phase 5e at ``scale`` (the main scale less one), P = 8, under
    ``program_cache_max=1``: seed 0 and the first later seed that shares
    its bucket, one at a time (seed 0 records, the other replays, seed
    0 again replays), then ``solve_batch`` of the two (records a B = 2
    program in place of the one-graph program) and again (replays); the
    batch byte-equal to the one-graph solves.  Prints the warm
    ``run_s`` of each, each program's ``reserved_bytes`` and the peak
    allocated and reserved memory of each part beside ``nvidia-smi``."""
    solver = EulerSolver(n_parts=PARTS, program_cache_max=1)
    g0 = eulerian_rmat(scale, avg_degree=AVG_DEGREE, seed=SEED)
    k0 = solver.bucket_of(g0)
    g1 = None
    for s in range(SEED + 1, SEED + 1 + seeds):
        g = eulerian_rmat(scale, avg_degree=AVG_DEGREE, seed=s)
        k = solver.bucket_of(g)
        say("batch", scale=scale, seed=s, edges=g.num_edges,
            same_bucket_as_seed0=k == k0)
        if k == k0:
            g1 = g
            break
        forget(solver, g)
    if g1 is None:
        raise AssertionError(f"no seed up to {SEED + seeds} shares seed "
                             f"{SEED}'s bucket at scale {scale}")
    torch.cuda.reset_peak_memory_stats()
    singles = [solver.solve(g).validate() for g in (g0, g1, g0)]
    eng = solver._engines[k0]
    reserved1 = eng.fused_program(k0[0]).reserved_bytes
    peak1 = (torch.cuda.max_memory_allocated(),
             torch.cuda.max_memory_reserved())
    torch.cuda.reset_peak_memory_stats()
    cold = solver.solve_batch([g0, g1])
    warm = solver.solve_batch([g0, g1])
    run = eng.fused_program(k0[0], 2)
    peak2 = (torch.cuda.max_memory_allocated(),
             torch.cuda.max_memory_reserved())
    same = all(same_bytes(r.validate(), w) for r, w in
               zip(cold + warm, singles[:2] * 2))
    singles_s = singles[1].timings["run_s"] + singles[2].timings["run_s"]
    say("batch", scale=scale, parts=PARTS, e_cap=k0[0],
        seeds=f"{SEED},{s}", same_bytes_as_single=same,
        run_s_b1=f"{singles[2].timings['run_s']:.4f},"
                 f"{singles[1].timings['run_s']:.4f}",
        run_s_b2=f"{warm[0].timings['run_s']:.4f}",
        b2_over_two_b1=f"{warm[0].timings['run_s'] / singles_s:.3f}",
        cold_run_s_b2=f"{cold[0].timings['run_s']:.4f}",
        capture_s_b2=f"{cold[0].timings['capture_s']:.4f}",
        reserved_bytes_b1=reserved1, reserved_bytes_b2=run.reserved_bytes,
        b2_over_b1_reserved=f"{run.reserved_bytes / reserved1:.3f}",
        peak_gib_b1=f"{peak1[0] / 2**30:.3f}/{peak1[1] / 2**30:.3f}",
        peak_gib_b2=f"{peak2[0] / 2**30:.3f}/{peak2[1] / 2**30:.3f}",
        evictions=solver.cache_stats.evictions, smi=f"'{smi}'")
    if not same:
        raise AssertionError(f"the scale-{scale} batch differs from its "
                             f"one-graph solves")
    if not warm[0].cache.hit or warm[0].timings["capture_s"] != 0.0:
        raise AssertionError("the repeat batch did not replay")
    del solver, eng, run, singles, cold, warm
    torch.cuda.empty_cache()


def _per_level(res) -> str:
    return "'" + ",".join(str(ls.cumulative) for ls in res.levels) + "'"


def check_host(scale: int, smi: str) -> None:
    """Phase 5f at ``scale`` (the main scale less four), P = 8 (module
    docstring)."""
    g = eulerian_rmat(scale, avg_degree=AVG_DEGREE, seed=SEED)
    edges = list(range(g.num_edges))
    hosts = {}
    for name, on in (("heuristics", True), ("baseline", False)):
        reset_counts()
        r = solve(g, backend="host", n_parts=PARTS, remote_dedup=on,
                  deferred_transfer=on).validate()
        counts = read_counts()
        covers = sorted((r.circuit >> 1).tolist()) == edges
        say("host", scale=scale, parts=PARTS, edges=g.num_edges,
            engine=f"host_{name}", remote_dedup=on, deferred_transfer=on,
            supersteps=r.supersteps, valid=r.valid, covers_every_edge=covers,
            launches=sum(counts.values()),
            run_s=f"{r.timings['run_s']:.4f}",
            total_s=f"{r.timings['total_s']:.4f}",
            cumulative=_per_level(r), smi=f"'{smi}'")
        if not covers:
            raise AssertionError(f"host_{name} circuit misses edges")
        if any(counts.values()):
            raise AssertionError(f"a host solve launched kernels: {counts}")
        hosts[name] = r
    solver = EulerSolver(n_parts=PARTS, device="cuda")
    d = solver.solve(g).validate()
    covers = sorted((d.circuit >> 1).tolist()) == edges
    level0 = (hosts["heuristics"].levels[0].cumulative,
              hosts["baseline"].levels[0].cumulative)
    say("host", scale=scale, parts=PARTS, edges=g.num_edges,
        engine="device_fused", e_cap=d.cache.bucket[0],
        supersteps=d.supersteps, valid=d.valid, covers_every_edge=covers,
        captures=solver.captures,
        warmup_s=f"{d.timings['warmup_s']:.4f}",
        capture_s=f"{d.timings['capture_s']:.4f}",
        run_s=f"{d.timings['run_s']:.4f}",
        total_s=f"{d.timings['total_s']:.4f}",
        cumulative=_per_level(d), smi=f"'{smi}'")
    say("host", level0_heuristics=level0[0], level0_baseline=level0[1],
        heuristics_at_most_baseline=level0[0] <= level0[1])
    if not covers:
        raise AssertionError("the device circuit misses edges")
    if level0[0] > level0[1]:
        raise AssertionError(f"heuristics raised the level-0 state: "
                             f"{level0[0]} > {level0[1]}")
    del solver, d
    torch.cuda.empty_cache()


#: phase 5g: the reference's documented serving deployment
#: (``src/repro/launch/serve.py``'s docstring and defaults), and its runs
SERVE_ARGS = ["--scale", "9", "--parts", str(PARTS), "--same-bucket",
              "--pool", "8", "--max-batch", "8", "--widths", "1,2,4,8",
              "--deadline-ms", "10"]
SERVE_REQUESTS = 256
SERVE_RUNS = {"a_ladder": ["--sync-prewarm"],
              "b_sync": ["--sync", "--no-prewarm"],
              "c_detached": [],
              "e_adaptive": ["--adaptive"]}
#: the autotuner's keys of an ``--adaptive`` run's JSON line, printed
TUNER_KEYS = ("tuner_steps", "async_prewarms", "pinned", "tightened_scales",
              "cache_bytes")
#: results of each run held byte-equal to eager solves
SERVE_SAMPLES = 8


def eager_twins(results, device="cuda") -> bool:
    """Whether each result's circuit and mate equal a ``fused=False``
    solve of its graph in a new session."""
    solver = EulerSolver(n_parts=PARTS, fused=False, device=device)
    same = all(same_bytes(r, solver.solve(r.graph).validate())
               for r in results)
    del solver
    return same


def serve_run(name: str, extra: list, smi: str, device="cuda") -> dict:
    """One in-process ``main_euler`` run of phase 5g (module docstring):
    every delivered result validated as it is harvested, a failure of
    the prewarm thread or of a compile job caught, the compile thread
    found stopped when ``main_euler`` returns, the detached prewarm
    thread joined after; returns the run's JSON line."""
    delivered, errors, tickets = [], [], []
    harvest = serve.MicroBatcher._harvest_one
    enqueue = CompileService._enqueue

    def validated(self):
        out = harvest(self)
        for _, r in out:
            r.validate()
        delivered.extend(out)
        return out

    def kept(self, *args):
        ticket = enqueue(self, *args)
        tickets.append(ticket)
        return ticket

    with tempfile.TemporaryDirectory() as tmp, \
            mock.patch.object(serve.MicroBatcher, "_harvest_one", validated), \
            mock.patch.object(CompileService, "_enqueue", kept), \
            mock.patch.object(threading, "excepthook", errors.append):
        path = Path(tmp) / "serve.json"
        serve.main_euler(SERVE_ARGS + extra + [
            "--requests", str(SERVE_REQUESTS), "--json", str(path),
            "--device", device])
        compiling = [t for t in threading.enumerate()
                     if t.name == "compile-service"]
        for t in threading.enumerate():
            if t.name == "prewarm":
                t.join()
        stats = json.loads(path.read_text().splitlines()[-1])
    if errors:
        raise AssertionError(f"[serve] {name}: a thread failed: "
                             f"{errors[0].exc_value!r}")
    failed = [t for t in tickets if t.error is not None]
    if failed or compiling:
        raise AssertionError(
            f"[serve] {name}: {len(failed)} of {len(tickets)} compile jobs "
            f"failed ({failed[0].error!r} first)" if failed else
            f"[serve] {name}: the compile thread outlived main_euler")
    seqs = sorted(s for s, _ in delivered)
    if seqs != list(range(SERVE_REQUESTS)) or \
            stats["served"] != SERVE_REQUESTS:
        raise AssertionError(f"[serve] {name}: delivered {len(seqs)} "
                             f"results, {stats['served']} served, of "
                             f"{SERVE_REQUESTS}")
    picks = np.linspace(0, len(delivered) - 1, SERVE_SAMPLES).astype(int)
    by_seq = dict(delivered)
    sample = [by_seq[seqs[i]] for i in picks]
    same = eager_twins(sample, device)
    keys = ("circuits_per_s", "p50_ms", "p95_ms", "mean_flush", "compiles",
            "hits", "misses", "evictions", "prewarms", "state_uploads",
            "cold_s", "prewarm_s", "first_wide_flush_s",
            "dispatches_before_wide", "pipeline_depth")
    tuner = {k: json.dumps(stats[k], separators=(",", ":"))
             for k in TUNER_KEYS if k in stats}
    if tuner:
        tuner.update(compile_jobs=len(tickets),
                     jobs=",".join(t.label for t in tickets))
    say("serve", run=name, scale=9, parts=PARTS, served=stats["served"],
        all_valid=True, sample_byte_equal_eager=same,
        width_hist=f"'{json.dumps(stats['width_hist'], separators=(',', ':'))}'",
        **{k: stats[k] for k in keys}, **tuner, smi=f"'{smi}'")
    if not same:
        raise AssertionError(f"[serve] {name}: a served result differs "
                             f"from its eager solve")
    if device == "cuda":
        torch.cuda.empty_cache()
    return stats


def check_serve_budget(scales, smi: str, device="cuda") -> None:
    """Phase 5g (d), the byte budget (module docstring)."""
    graphs = [eulerian_rmat(s, avg_degree=AVG_DEGREE, seed=SEED)
              for s in scales]
    probe = EulerSolver(n_parts=PARTS, program_cache_max=1, device=device)
    alone = []
    for s, g in zip(scales, graphs):
        key = probe.bucket_of(g)
        probe.solve(g).validate()
        alone.append(probe._engines[key].fused_program(key[0]).reserved_bytes)
        say("serve", run="d_budget", scale=s, parts=PARTS, e_cap=key[0],
            reserved_bytes_alone=alone[-1])
    del probe
    if device == "cuda":
        torch.cuda.empty_cache()
    budget = int(1.25 * max(alone))
    solver = EulerSolver(n_parts=PARTS, program_cache_bytes=budget,
                         device=device)
    keys = [solver.bucket_of(g) for g in graphs]
    kept = {}
    for turn in range(6):
        j = turn % 2
        predicted = solver._program_cost(keys[j], None)
        both_measured = all((k[0], 1) in solver._measured for k in keys)
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        r = solver.solve(graphs[j]).validate()
        peak = torch.cuda.max_memory_reserved() if device == "cuda" else 0
        used = solver.cache_bytes_used()
        measured = [solver._measured.get((k[0], 1), 0) for k in keys]
        kept.setdefault(j, r)
        say("serve", run="d_budget", turn=turn, scale=scales[j],
            hit=r.cache.hit, predicted_bytes=predicted,
            charged_bytes=solver._program_bytes.get((keys[j], None)),
            used_bytes=used, budget_bytes=budget,
            evictions=solver.cache_stats.evictions,
            peak_reserved_bytes=peak, both_measured=both_measured,
            two_programs_bytes=sum(measured), smi=f"'{smi}'")
        if r.cache.hit:
            raise AssertionError("[serve] d_budget: a solve hit; the other "
                                 "bucket's recording should have evicted it")
        if used > budget:
            raise AssertionError(f"[serve] d_budget: {used} bytes charged "
                                 f"over the budget of {budget}")
        if both_measured and device == "cuda" and peak >= sum(measured):
            raise AssertionError(
                f"[serve] d_budget: recording {turn} peaked at {peak} "
                f"reserved bytes, not below the two programs' "
                f"{sum(measured)}: the eviction did not come first")
    same = eager_twins([kept[0], kept[1]], device)
    say("serve", run="d_budget", evictions=solver.cache_stats.evictions,
        sample_byte_equal_eager=same)
    if solver.cache_stats.evictions == 0 or not same:
        raise AssertionError("[serve] d_budget: no eviction, or a result "
                             "differs from its eager solve")
    del solver, kept, r
    if device == "cuda":
        torch.cuda.empty_cache()


#: the cap fields phase 5g (f) prints, in this order
CAP_FIELDS = ("edge_cap", "new_cap", "park_cap", "ship_cap", "open_cap",
              "open_ship_cap", "touch_cap", "touch_ship_cap", "p3v_cap")


def _caps(values) -> str:
    """A bucket key's caps (or a field → value mapping) in CAP_FIELDS'
    order."""
    if isinstance(values, tuple):
        values = dataclasses.asdict(values[3])
    return "'" + ",".join(str(values.get(f, 0)) for f in CAP_FIELDS) + "'"


def _reserved(solver, key, widths) -> dict:
    eng = solver._engines[key]
    return {w: eng.fused_program(key[0], None if w == 1 else w).reserved_bytes
            for w in widths}


def check_serve_tighten(smi: str, device="cuda") -> None:
    """Phase 5g (f), the tight cap profile (module docstring)."""
    solver = EulerSolver(n_parts=PARTS, device=device)
    pool = modal_bucket_pool(
        solver, (eulerian_rmat(9, avg_degree=AVG_DEGREE, seed=SEED + i)
                 for i in range(8 * 8)), 8)
    g = pool[0]
    key = solver.bucket_of(g)
    e_cap = key[0]
    solver.prewarm(g, [1, 8])
    before = _reserved(solver, key, (1, 8))
    seen = solver.cap_observations(e_cap)
    floors = ladder_floors(e_cap, PARTS, slack=solver.slack, tight=True)
    fits = all(seen[f] <= floors[f] for f in TIGHT_DIVISORS if seen.get(f))
    waste = solver.bucket_waste[key]
    say("serve", run="f_tighten", scale=9, parts=PARTS, e_cap=e_cap,
        pool=len(pool), fields=f"'{','.join(CAP_FIELDS)}'", caps=_caps(key),
        reserved_bytes_b1=before[1], reserved_bytes_b8=before[8],
        observed=_caps(seen), tight_floors=_caps(floors),
        waste=f"{waste:.4f}", fits_tight_floors=fits,
        plan_would_tighten=fits and waste >= TunerParams().tighten_waste)
    if not solver.tighten(e_cap):
        raise AssertionError("[serve] f_tighten: the scale was tight already")
    svc = solver._ensure_compile_service()
    t0 = time.perf_counter()
    ticket = svc.submit_retune(g, e_cap, [8])
    if not ticket.wait(timeout=600) or ticket.error is not None:
        raise AssertionError(f"[serve] f_tighten: the retune job failed: "
                             f"{ticket.error!r}")
    retune_s = time.perf_counter() - t0
    tkey = solver.bucket_of(g)
    after = _reserved(solver, tkey, (1, 8))
    tight_keys = [solver.bucket_of(x) for x in pool]
    ones = [solver.solve(x).validate() for x in pool]
    members = [x for x, k in zip(pool, tight_keys) if k == tkey]
    eights = solver.solve_batch([members[i % len(members)]
                                 for i in range(8)])
    for r in eights:
        r.validate()
    svc.stop()
    stopped = not svc._thread.is_alive()
    same = eager_twins(ones + eights, device)
    say("serve", run="f_tighten", tight_caps=_caps(tkey),
        retuned_widths=",".join(map(str, ticket.widths)),
        retune_s=f"{retune_s:.3f}",
        reserved_bytes_b1=after[1], reserved_bytes_b8=after[8],
        b1_ratio=f"{after[1] / max(before[1], 1):.4f}",
        b8_ratio=f"{after[8] / max(before[8], 1):.4f}",
        tight_buckets=len(set(tight_keys)), b8_members=len(members),
        b1_hit=ones[0].cache.hit, b8_hit=eights[0].cache.hit,
        captures=solver.captures, compile_thread_stopped=stopped,
        byte_equal_eager=same, smi=f"'{smi}'")
    if tkey == key or ticket.widths != [1, 8] or not same or not stopped \
            or not (ones[0].cache.hit and eights[0].cache.hit):
        raise AssertionError("[serve] f_tighten: the retune did not record "
                             "the tight bucket's B = 1 and B = 8, or a "
                             "tight result differs from its eager solve")
    del solver, ones, eights
    if device == "cuda":
        torch.cuda.empty_cache()


def check_serve(main_scale: int, smi: str, device="cuda") -> dict:
    """Phase 5g (module docstring); returns each run's JSON line."""
    runs = {name: serve_run(name, extra, smi, device)
            for name, extra in SERVE_RUNS.items()}
    check_serve_budget((main_scale - 5, main_scale - 4), smi, device)
    check_serve_tighten(smi, device)
    return runs


def k5_ids(n: int, s: int, skewed: bool, gen, dev) -> torch.Tensor:
    """Sorted int32 segment ids of ``n`` rows over ``s`` segments: uniform
    draws, or ``floor(s · u²)`` for uniform ``u`` (skewed: segment j gets
    about n·(√(j+1) − √j)/√s rows, 39,500 for segment 0 at ogb_products
    and about 12.6 near j = s)."""
    if skewed:
        u = torch.rand(n, generator=gen, device=dev, dtype=torch.float64)
        raw = (u * u * s).floor_().clamp_(max=s - 1).to(torch.int32)
        del u
    else:
        raw = torch.randint(0, s, (n,), generator=gen, device=dev)
    return torch.sort(raw).values.to(torch.int32)


def k5_atol(tol: float, lengths=None):
    """K5's absolute tolerance: ``tol · 8`` per output element, and with
    ``lengths`` (rows per segment) 2^-22 more per row of the segment.  Two
    f32 sums of n unit-normal terms in different orders differ by about
    2^-24·n (n roundings of partial sums of up to about √n): the earlier
    warp-per-segment kernel read 2.46e-3 against its twin on the H100 at
    a 39,672-row segment, where ``tol · 8`` allows 8e-5."""
    if lengths is None:
        return tol * 8
    return tol * 8 + lengths[:, None].float() * 2.0 ** -22


def k5_close(got, want, tol: float, atol) -> bool:
    """``|got − want| ≤ atol + tol·|want|`` everywhere (``allclose``
    with a per-row ``atol``)."""
    return bool(((got - want).abs() <= atol + tol * want.abs()).all())


def k5_skew_checks(got, want, values, ids, lengths, tol, atol) -> dict:
    """On skewed ids: a kernel that dropped the first row of segment 0
    must fail :func:`k5_close`; and the kernel's and the twin's largest
    error against an f64 sum of the 16 longest segments."""
    planted = got.clone()
    planted[0] -= values[0].float()            # ids[0] == 0: sorted, skewed
    head = int(lengths[:16].sum())
    exact = torch.zeros(16, values.shape[1], dtype=torch.float64,
                        device=values.device)
    exact.index_add_(0, ids[:head].long(), values[:head].double())
    return {"longest_segment": int(lengths.max()),
            "planted_fault_seen": int(ids[0]) == 0
            and not k5_close(planted, want, tol, atol),
            "kernel_err_vs_f64_top16":
                f"{float((got[:16].double() - exact).abs().max()):.3e}",
            "twin_err_vs_f64_top16":
                f"{float((want[:16].double() - exact).abs().max()):.3e}"}


def check_k5(dev) -> dict:
    """Phase 6: K5 against its twin at two GNN aggregation shapes (f32),
    ogb_products in bf16, and ogb_products with skewed ids (f32, where
    :func:`k5_atol` grows with the segment and a planted dropped row must
    fail); times beside the byte bound and one ``torch.segment_reduce``
    call, the skewed time also as a share of the uniform one.  Returns
    ogb_products' f32 row."""
    shapes = gnn_shapes()
    cases = [("full_graph_sm", torch.float32, False),
             ("ogb_products", torch.float32, False),
             ("ogb_products", torch.bfloat16, False),
             ("ogb_products", torch.float32, True)]
    gen = torch.Generator(device=dev).manual_seed(0)
    row = None
    for name, dtype, skewed in cases:
        cell = shapes[name]
        n, d, s = cell.n_edges, cell.d_feat, cell.n_nodes
        ids = k5_ids(n, s, skewed, gen, dev)
        values = torch.randn(n, d, generator=gen, device=dev).to(dtype)
        lengths = torch.bincount(ids, minlength=s)
        got = sr.segment_sum_sorted(values, ids, s).float()
        want = ref.segment_sum_sorted_ref(values, ids, s).float()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        atol = k5_atol(tol, lengths if skewed else None)
        ok = k5_close(got, want, tol, atol)
        extra = {}
        if skewed:
            extra = k5_skew_checks(got, want, values, ids, lengths, tol,
                                   atol)
        del got, want
        iters = 20 if n < 1_000_000 else 5
        ms = cuda_ms(lambda: sr.segment_sum_sorted(values, ids, s), iters)
        plain_ms = cuda_ms(lambda: ref.segment_sum_sorted_ref(values, ids, s),
                           iters)
        library_ms = cuda_ms(lambda: torch.segment_reduce(
            values, "sum", lengths=lengths, axis=0), iters)
        es = values.element_size()
        nbytes = n * d * es + 4 * n + s * d * es
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        if skewed:
            extra["of_uniform"] = f"{ms / row['ms']:.3f}"
        say("k5", shape=name + ("_skewed" if skewed else ""), n=n, d=d,
            segments=s, dtype=str(dtype).split(".")[-1],
            max_abs_err=f"{err:.3e}", allclose=ok, ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}",
            bound_ms=f"{bound_ms:.4f}", of_bound=f"{bound_ms / ms:.3f}",
            **extra)
        if not ok:
            raise AssertionError(f"K5 differs from its twin at {name} "
                                 f"{dtype} skewed={skewed}: max abs err "
                                 f"{err}")
        if extra.get("planted_fault_seen") is False:
            raise AssertionError("the skewed K5 check cannot see a dropped "
                                 "row of segment 0")
        if name == "ogb_products" and dtype == torch.float32 and not skewed:
            row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": "bytes",
                   "library_ms": library_ms}
        del values, ids, lengths
        torch.cuda.empty_cache()
    return row


def attention_bound(B, S, T, Hq, Hkv, D, causal, dtype):
    """(ms, "bytes" or "operations"): 4·D operations per visible (query,
    key) pair and query head against q, k, v read once and o written
    once."""
    if causal:   # query i sees keys 0 … i + T − S
        pairs = sum(min(T, i + T - S + 1) for i in range(S))
    else:
        pairs = S * T
    flops = 4 * B * Hq * D * pairs
    es = torch.tensor([], dtype=dtype).element_size()
    nbytes = es * D * B * (2 * S * Hq + 2 * T * Hkv)
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def scaled_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got − want| / (|want| + the RMS of want's row over the last
    axis): the measure ``K6_BF16_TOL`` bounds."""
    g, w = got.float(), want.float()
    rms = w.pow(2).mean(-1, keepdim=True).sqrt().clamp_min(1e-30)
    return float(((g - w).abs() / (w.abs() + rms)).max())


def twin_dropping_keys(q, k, v, lo: int, hi: int) -> torch.Tensor:
    """The causal twin (heads already repeated) with keys ``lo … hi − 1``
    masked out: what a kernel that skipped one KV tile would return."""
    S, T, D = q.shape[1], k.shape[1], q.shape[3]
    scores = torch.einsum("bshd,bthd->bhst", q, k).float() / math.sqrt(D)
    t = torch.arange(T, device=q.device)
    seen = t[None, :] <= torch.arange(S, device=q.device)[:, None] + T - S
    seen &= ((t < lo) | (t >= hi))[None, :]
    probs = torch.softmax(scores.masked_fill(~seen, -1e30), -1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def k6_planted_faults(q, k, v, got) -> dict:
    """``scaled_err`` of K6's output ``got`` against the twin of two
    faulty kernels on the first sequence: one that drops the KV tile of
    keys 2,048 … 2,111, and one that maps query head h to KV head
    h mod Hkv instead of h // (Hq/Hkv)."""
    q, k, v, got = q[:1], k[:1], v[:1], got[:1]
    rep = q.shape[2] // k.shape[2]
    kr, vr = k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2)
    dropped = scaled_err(got, twin_dropping_keys(q, kr, vr, 2048, 2112))
    del kr, vr
    heads = scaled_err(got, ref.flash_attention_ref(
        q, k.repeat(1, 1, rep, 1), v.repeat(1, 1, rep, 1), causal=True))
    return {"dropped_tile": dropped, "wrong_heads": heads}


def check_k6(dev) -> dict:
    """Phase 7: K6 against its twin (f32 by ``allclose`` at 2e-5, bf16 by
    ``scaled_err`` within ``K6_BF16_TOL``, which two planted faults at the
    serving shape must exceed); times beside the bound and one
    ``scaled_dot_product_attention`` call; then the kernel alone at
    prefill_32k's sequence length.  Returns the serving shape's row."""
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [  # (label, B, S, T, Hq, Hkv, D, causal, dtype)
        ("serving_prefill", LM_BATCH, LM_PROMPT, LM_PROMPT, 15, 5, 64, True,
         torch.bfloat16),
        ("noncausal_f32_d128", 1, 2048, 2048, 8, 2, 128, False,
         torch.float32),
        ("ragged_4097", 1, LM_PROMPT + 1, LM_PROMPT + 1, 15, 5, 64, True,
         torch.bfloat16),
        ("causal_d128", 1, 4096, 4096, 8, 2, 128, True, torch.bfloat16),
        ("causal_d32", 2, 2048, 2048, 6, 2, 32, True, torch.bfloat16),
        ("suffix_1000_of_4097", 1, 1000, LM_PROMPT + 1, 15, 5, 64, True,
         torch.bfloat16),
    ]
    config = build.function("flash_attention", "fa_bf16_config",
                            (ctypes.c_int, ctypes.POINTER(ctypes.c_int)))
    for D in fa.HEAD_DIMS:
        got = (ctypes.c_int * 4)()
        if config(D, got) != 0:
            raise AssertionError(f"fa_bf16_config({D}) failed")
        say("k6", config=f"bf16_D{D}", stages=got[0], block_rows=got[1],
            block_keys=got[2], dynamic_smem_bytes=got[3])
    row = None
    for label, B, S, T, Hq, Hkv, D, causal, dtype in cases:
        q = torch.randn(B, S, Hq, D, generator=gen, device=dev).to(dtype)
        k = torch.randn(B, T, Hkv, D, generator=gen, device=dev).to(dtype)
        v = torch.randn(B, T, Hkv, D, generator=gen, device=dev).to(dtype)
        rep = Hq // Hkv
        kr, vr = k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2)
        got = fa.flash_attention(q, k, v, causal=causal)
        want = ref.flash_attention_ref(q, kr, vr, causal=causal)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        scaled = scaled_err(got, want)
        if dtype == torch.float32:
            ok = torch.allclose(got, want, rtol=2e-5, atol=2e-5)
        else:
            ok = scaled <= K6_BF16_TOL
        del want
        torch.cuda.empty_cache()
        faults = (k6_planted_faults(q, k, v, got)
                  if label == "serving_prefill" else {})
        del got
        torch.cuda.empty_cache()
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=causal), 10)
        plain_ms = cuda_ms(lambda: ref.flash_attention_ref(
            q, kr, vr, causal=causal), 3)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        # SDPA's is_causal aligns the diagonal top-left; a suffix of the
        # keys (S < T) needs the mask written out
        mask = (torch.ones(S, T, dtype=torch.bool, device=dev).tril(T - S)
                if causal and S != T else None)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True), 10)
        bound_ms, bound_by = attention_bound(B, S, T, Hq, Hkv, D, causal,
                                             dtype)
        say("k6", case=label, shape=f"B{B}_S{S}_T{T}_Hq{Hq}_Hkv{Hkv}_D{D}",
            causal=causal, dtype=str(dtype).split(".")[-1],
            max_abs_err=f"{err:.3e}", scaled_err=f"{scaled:.3e}",
            within_tol=ok, ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}",
            bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
            of_bound=f"{bound_ms / ms:.3f}",
            **{f"planted_{k}_scaled_err": f"{x:.3e}"
               for k, x in faults.items()})
        if not ok:
            raise AssertionError(f"K6 differs from its twin at {label}: "
                                 f"max abs err {err}, scaled {scaled}")
        missed = [k for k, x in faults.items() if not x > K6_BF16_TOL]
        if missed:
            raise AssertionError(f"the K6 check cannot see the planted "
                                 f"faults {missed}: {faults}")
        if label == "serving_prefill":
            row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": library_ms}
        del q, k, v, kr, vr, qt, kt, vt, mask
        torch.cuda.empty_cache()
    # the kernel alone at prefill_32k's sequence (its twin's scores would
    # be 64 GB at the cell's batch; one sequence is timed)
    S = lm_shapes(True)["prefill_32k"].seq_len
    q = torch.randn(1, S, 15, 64, generator=gen, device=dev).bfloat16()
    k = torch.randn(1, S, 5, 64, generator=gen, device=dev).bfloat16()
    v = torch.randn(1, S, 5, 64, generator=gen, device=dev).bfloat16()
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True), 5)
    bound_ms, bound_by = attention_bound(1, S, S, 15, 5, 64, True,
                                         torch.bfloat16)
    say("k6", case="prefill_32k_alone", shape=f"B1_S{S}_T{S}_Hq15_Hkv5_D64",
        causal=True, dtype="bfloat16", finite=bool(torch.isfinite(
            fa.flash_attention(q, k, v)).all()),
        ms=f"{ms:.4f}", bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
        of_bound=f"{bound_ms / ms:.3f}")
    del q, k, v
    torch.cuda.empty_cache()
    return row


def _to(params, where):
    """``params`` with every tensor moved or cast by ``.to(where)``."""
    return {k: ([{n: t.to(where) for n, t in layer.items()} for layer in v]
                if k == "layers" else v.to(where))
            for k, v in params.items()}


def check_lm_parity(dev) -> None:
    """Phase 8: the reduced config in f32, one set of seeded weights on
    ``dev`` and on the CPU: prefill logits within 2e-5, greedy ids
    equal."""
    cfg = get_config("smollm-360m", reduced=True).model
    params = tr.init_lm_params(torch.Generator().manual_seed(0), cfg)
    on_card = _to(params, dev)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 64)).astype(np.int32)
    want, _ = tr.prefill_step(params, cfg, torch.from_numpy(prompts))
    got, _ = tr.prefill_step(on_card, cfg, torch.from_numpy(prompts).to(dev))
    err = float((got.cpu() - want).abs().max())
    ok = torch.allclose(got.cpu(), want, rtol=2e-5, atol=2e-5)
    cpu = serve_lm(cfg, prompts, 8, "cpu", params=params)
    card = serve_lm(cfg, prompts, 8, dev, params=on_card)
    same = np.array_equal(cpu.ids, card.ids)
    say("lm-parity", config=cfg.name, dtype="float32", batch=2, prompt=64,
        gen=8, logits_max_abs_err=f"{err:.3e}", logits_allclose=ok,
        greedy_ids_equal=same)
    if not (ok and same):
        raise AssertionError("reduced LM differs between cuda and cpu")


def _fmt(fields: dict) -> dict:
    return {k: f"{v:.3f}" if isinstance(v, float) else v
            for k, v in fields.items()}


def _profile_split(fn, top: int = 8) -> dict:
    """One call of ``fn`` under torch.profiler: its wall milliseconds, the
    device's busy milliseconds and idle share, the kernel launches, and
    the busy time by kernel family (K6, matrix products, the rest); the
    ``top`` kernels by device time are printed.  Only device-side rows are
    summed: the aten rows repeat their kernels' time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    split = {"flash_attention_ms": 0.0, "matmul_ms": 0.0, "other_ms": 0.0}
    kernels, rows = 0, []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        kernels += ev.count
        us = getattr(ev, "self_device_time_total", None)
        us = ev.self_cuda_time_total if us is None else us
        rows.append((us, ev.count, ev.key))
        name = ev.key.lower()
        if "flash_bf16_kernel" in name or "flash_f32_kernel" in name:
            key = "flash_attention_ms"
        elif any(w in name for w in ("gemm", "xmma", "cutlass", "nvjet")):
            key = "matmul_ms"
        else:
            key = "other_ms"
        split[key] += us / 1e3
    busy_ms = sum(split.values())
    for us, count, key in sorted(rows, reverse=True)[:top]:
        print(f"[lm-profile] kernel {us / 1e3:9.3f} ms calls={count:5d} "
              f"{key[:80]}", flush=True)
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle_share": max(0.0, 1 - busy_ms / wall_ms), "kernels": kernels,
            **split}


def plain_prefill(params, cfg, tokens):
    """``tr.prefill_step`` with the decode's plain ``gqa_attention``
    (scores rounded to the model's dtype, as the decode rounds them) in
    place of K6."""
    def attention(q, k, v, causal):
        return gqa_attention(q, k, v, causal=causal)

    with mock.patch.object(tr.ops, "flash_attention_gqa", attention):
        return tr.prefill_step(params, cfg, tokens)


def first_step(params, cfg, cache, first, dev, rows=None):
    """Logits (f32) of the decode step that feeds ``first`` [B] after a
    prefill's ``cache`` of P positions, widened to P + 1 with its first
    ``rows`` positions copied (default all P; fewer plants a faulty
    widening copy)."""
    P = cache.k.shape[2]
    rows = P if rows is None else rows
    wide = tr.init_kv_cache(cfg, first.shape[0], P + 1, fill=P, device=dev)
    wide.k[:, :, :rows] = cache.k[:, :, :rows]
    wide.v[:, :, :rows] = cache.v[:, :, :rows]
    step, _ = tr.decode_step(params, cfg, wide, first)
    return step.float()


def decode_against_prefill(params, cfg, tokens, first, dev,
                           prefill=tr.prefill_step):
    """The first decode step after ``prefill`` of ``tokens`` [B, P] and
    a ``prefill`` of the P + 1 tokens (prompt and ``first``) at their
    last position, both f32 logits; and the decode step after a widening
    copy that drops the prompt's last position (a planted fault)."""
    _, cache = prefill(params, cfg, tokens)
    step = first_step(params, cfg, cache, first, dev)
    fault = first_step(params, cfg, cache, first, dev,
                       rows=tokens.shape[1] - 1)
    del cache
    full, _ = prefill(params, cfg, torch.cat([tokens, first[:, None]], 1))
    return step, full.float(), fault


def _spread(values, digits: int) -> str:
    """``min/median/max`` of three or more numbers."""
    v = sorted(values)
    return "/".join(f"{x:.{digits}f}" for x in (v[0], v[len(v) // 2], v[-1]))


def record_lm(cfg, params, prompts, dev):
    """Phase 9's main path: the first fused serve at the measured shape,
    which warms up and records the programs.  Every counter is set to 0
    just before it and read just after, and read around each recording.
    Returns (the programs, the result, launches of the serve, launches
    recorded in the prefill graph and in the decode graph)."""
    programs = LMPrograms(cfg, params, LM_BATCH, LM_PROMPT, LM_GEN, dev)
    recorded = []
    record = LMPrograms._record

    def counted_record(prog, body):
        before = read_counts()
        out = record(prog, body)
        recorded.append({k: v - before[k] for k, v in read_counts().items()})
        return out

    torch.cuda.synchronize()
    reset_counts()
    with mock.patch.object(LMPrograms, "_record", counted_record):
        res = serve_lm(cfg, prompts, LM_GEN, dev, programs=programs)
    return programs, res, read_counts(), *recorded


def serve_both_modes(cfg, params, prompts, dev, programs, smi: str):
    """Three fused serves (replays of ``programs``: each must record
    nothing and launch no wrapper) and three eager ones (K6 once per
    layer each); prints each mode's spread and the fused serves' peak
    memory.  Returns (fused results, eager results)."""
    want_eager = {name: 0 for name in KERNELS}
    want_eager["flash_attention"] = cfg.n_layers
    runs = {"fused": [], "eager": []}
    memory = {}
    for mode in runs:
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            reset_counts()
            res = serve_lm(cfg, prompts, LM_GEN, dev, params=params,
                           fused=mode == "fused",
                           programs=programs if mode == "fused" else None)
            counts = read_counts()
            if mode == "fused" and (any(counts.values()) or res.captures != 1
                                    or res.capture_s != 0.0):
                raise AssertionError(f"a fused serve recorded or launched "
                                     f"from Python: {counts}, captures "
                                     f"{res.captures}")
            if mode == "eager" and counts != want_eager:
                raise AssertionError(f"an eager serve launched {counts}, "
                                     f"expected {want_eager}")
            runs[mode].append(res)
        memory[mode] = (torch.cuda.max_memory_allocated(),
                        torch.cuda.max_memory_reserved())
    for mode, results in runs.items():
        say("lm-serve", mode=mode, calls=len(results),
            decode_tok_s=_spread([r.decode_tok_s for r in results], 1),
            prefill_s=_spread([r.prefill_s for r in results], 4),
            decode_s=_spread([r.decode_s for r in results], 4),
            peak_gib=f"{memory[mode][0] / 2**30:.3f}",
            reserved_gib=f"{memory[mode][1] / 2**30:.3f}", smi=f"'{smi}'")
    return runs["fused"], runs["eager"]


def decode_replays_vs_eager(params, cfg, programs, tokens, steps: int = 3):
    """The first ``steps`` decode replays after a prefill replay against
    as many eager ``decode_step``s from a copy of the same state: the
    largest logit difference of each step, and whether the greedy
    tokens agree."""
    programs.load(tokens)
    programs.prefill()
    cache = tr.KVCache(*(x.clone() for x in programs.cache))
    tok = programs.tokens.clone()
    diffs, same = [], True
    for _ in range(steps):
        programs.decode()
        logits, cache = tr.decode_step(params, cfg, cache, tok)
        tok = torch.argmax(logits, -1).to(torch.int32)
        diffs.append(float((programs.logits.float() - logits.float())
                           .abs().max()))
        same = same and torch.equal(programs.tokens, tok)
    del cache
    return diffs, same


def check_lm_slice(dev, smi: str) -> dict:
    """Phase 9 (module docstring).  Returns the launch counts of the main
    path: K6's is the prefill graph's recorded count."""
    cfg = get_config("smollm-360m").model
    t = time.perf_counter()
    params = tr.init_lm_params(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT)).astype(np.int32)
    torch.cuda.reset_peak_memory_stats()
    programs, res, counts, rec_prefill, rec_decode = record_lm(
        cfg, params, prompts, dev)
    peak = torch.cuda.max_memory_allocated()
    say("lm-slice", config=cfg.name, layers=cfg.n_layers,
        d_model=cfg.d_model, params=cfg.param_count(), dtype="bfloat16",
        batch=LM_BATCH, prompt=LM_PROMPT, gen=LM_GEN, fused=True,
        init_s=f"{init_s:.3f}", warmup_s=f"{res.warmup_s:.4f}",
        capture_s=f"{res.capture_s:.4f}", captures=res.captures,
        prefill_s=f"{res.prefill_s:.4f}", decode_s=f"{res.decode_s:.4f}",
        decode_tok_s=f"{res.decode_tok_s:.1f}",
        peak_gib=f"{peak / 2**30:.3f}",
        reserved_gib=f"{torch.cuda.max_memory_reserved() / 2**30:.3f}",
        ids_shape="x".join(map(str, res.ids.shape)),
        launches=json.dumps(counts, separators=(",", ":")),
        recorded_prefill=json.dumps(rec_prefill, separators=(",", ":")),
        recorded_decode=json.dumps(rec_decode, separators=(",", ":")))
    # one K6 launch per layer in the prefill graph, none in the decode
    # graph; the serve ran the warm-up's and the recording's
    want_decode = {name: 0 for name in KERNELS}
    want_prefill = dict(want_decode, flash_attention=cfg.n_layers)
    want_serve = dict(want_decode, flash_attention=2 * cfg.n_layers)
    own = {step: {k: v for k, v in want.items() if k in programs.recorded[step]}
           for step, want in (("prefill", want_prefill),
                              ("decode", want_decode))}
    if (res.ids.shape != (LM_BATCH, LM_GEN) or res.captures != 1
            or rec_prefill != want_prefill or rec_decode != want_decode
            or counts != want_serve or programs.recorded != own):
        raise AssertionError(
            f"serving ran {res.ids.shape}, {res.captures} captures, "
            f"recorded {rec_prefill} / {rec_decode} "
            f"(programs: {programs.recorded}), launches {counts}; expected "
            f"{want_prefill} / {want_decode}, {want_serve}")

    # warm-up of the eager loop at the served shape: cuBLAS's first
    # choice of kernels and the allocator's growth are set-up
    serve_lm(cfg, prompts, 2, dev, params=params, fused=False)
    fused, eager = serve_both_modes(cfg, params, prompts, dev, programs, smi)
    same_ids = all(np.array_equal(r.ids, eager[0].ids)
                   for r in (res, *fused, *eager))
    last = float((fused[0].logits.float() - eager[0].logits.float())
                 .abs().max())
    tokens = torch.from_numpy(prompts).to(dev)
    diffs, same_tokens = decode_replays_vs_eager(params, cfg, programs,
                                                 tokens)
    say("lm-slice", check="fused_vs_eager", ids_equal=same_ids,
        last_logits_max_abs_diff=f"{last:.3e}",
        decode_replays_vs_eager_decode_step_max_abs_diff=
        "/".join(f"{d:.3e}" for d in diffs),
        decode_replay_tokens_equal=same_tokens)
    if not (same_ids and same_tokens):
        raise AssertionError("the fused serve's ids differ from the eager "
                             "loop's")
    del fused, eager

    # the first decode step against a prefill of prompt + first token:
    # in bf16 with plain attention on both sides (the decode's rounding),
    # in an f32 copy of the weights with K6 in the prefill, and the bf16
    # serving path itself (K6 prefill, plain decode) for the record
    logits, _ = tr.prefill_step(params, cfg, tokens)
    first = torch.argmax(logits, -1).to(torch.int32)
    del logits
    same_first = np.array_equal(first.cpu().numpy(), res.ids[:, 0])
    step_p, full_p, fault_p = decode_against_prefill(
        params, cfg, tokens, first, dev, prefill=plain_prefill)
    torch.cuda.empty_cache()
    step_b, full_b, _ = decode_against_prefill(params, cfg, tokens, first,
                                               dev)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = _to(params, torch.float32)
    step_f, full_f, fault_f = decode_against_prefill(params32, cfg32, tokens,
                                                     first, dev)
    del params32
    torch.cuda.empty_cache()
    err_p = float((step_p - full_p).abs().max())
    err_f = float((step_f - full_f).abs().max())
    ok_p = err_p <= DECODE_BF16_TOL
    ok_f = torch.allclose(step_f, full_f, rtol=DECODE_F32_TOL,
                          atol=DECODE_F32_TOL)
    seen_p = float((fault_p - full_p).abs().max()) > DECODE_BF16_TOL
    seen_f = not torch.allclose(fault_f, full_f, rtol=DECODE_F32_TOL,
                                atol=DECODE_F32_TOL)
    say("lm-slice", check="decode_vs_prefill_4097",
        bf16_plain_max_abs_err=f"{err_p:.3e}", bf16_plain_within_tol=ok_p,
        f32_max_abs_err=f"{err_f:.3e}", f32_allclose=ok_f,
        planted_bf16_plain_max_abs_err=
        f"{float((fault_p - full_p).abs().max()):.3e}",
        planted_f32_max_abs_err=f"{float((fault_f - full_f).abs().max()):.3e}",
        planted_faults_seen=seen_p and seen_f,
        bf16_serving_path_max_abs_err=
        f"{float((step_b - full_b).abs().max()):.3e}",
        bf16_vs_f32_prefill_max_abs_err=
        f"{float((full_b - full_f).abs().max()):.3e}",
        max_abs_logit=f"{float(full_f.abs().max()):.3f}",
        first_token_matches_serve=same_first,
        logits_finite=bool(torch.isfinite(step_b).all()))
    if not (ok_p and ok_f and same_first):
        raise AssertionError("first decode step differs from the "
                             "4,097-token prefill")
    if not (seen_p and seen_f):
        raise AssertionError("the decode check cannot see a widening copy "
                             "that drops the prompt's last position")

    split = _profile_split(lambda: tr.prefill_step(params, cfg, tokens))
    say("lm-profile", step="prefill", batch=LM_BATCH, prompt=LM_PROMPT,
        **_fmt(split))
    big = tr.init_kv_cache(cfg, LM_BATCH, LM_PROMPT + LM_GEN, fill=LM_PROMPT,
                           device=dev)
    reset_counts()
    split = _profile_split(lambda: tr.decode_step(params, cfg, big, first))
    decode_counts = read_counts()
    say("lm-profile", step="decode", batch=LM_BATCH,
        cache=LM_PROMPT + LM_GEN, **_fmt(split),
        launches=json.dumps(decode_counts, separators=(",", ":")))
    if any(decode_counts.values()):
        raise AssertionError(f"a decode step launched {decode_counts}")
    del big
    programs.load(tokens)
    reset_counts()
    split = _profile_split(programs.prefill)
    say("lm-profile", step="prefill_replay", batch=LM_BATCH,
        prompt=LM_PROMPT, **_fmt(split))
    split = _profile_split(programs.decode)
    replay_counts = read_counts()
    say("lm-profile", step="decode_replay", batch=LM_BATCH,
        cache=LM_PROMPT + LM_GEN, **_fmt(split),
        launches=json.dumps(replay_counts, separators=(",", ":")))
    if any(replay_counts.values()):
        raise AssertionError(f"a replay launched {replay_counts}")
    del programs
    torch.cuda.empty_cache()
    return dict(counts, flash_attention=rec_prefill["flash_attention"])


def _compact(counts: dict) -> str:
    return "'" + json.dumps(counts, separators=(",", ":"),
                            sort_keys=True) + "'"


def audit_lines(mode: str, report: dict, smi: str) -> None:
    """Phase 10: one ``[audit]`` line a program of an ``audit_graph``
    report (module docstring)."""
    for prog in report["programs"]:
        gcen = prog["graph_census"]
        nodes = graph_kernel_nodes(gcen)
        want = {lp["kernel"]: lp["launches"]
                for lp in prog["cost"]["loops"].values()}
        reserved = prog["cost"]["reserved_bytes"]
        model = prog["cost"]["program_bytes"]
        census = {k: v for k, v in prog["census"].items()
                  if not k.startswith("kernel:")}
        say("audit", mode=mode, scale=AUDIT_SCALE, parts=PARTS,
            e_cap=prog["e_cap"], batch=prog["batch"] or 1, ok=prog["ok"],
            census=_compact(census),
            kernel_nodes="'" + ",".join(f"{k}:{nodes[k]}/{n}"
                                        for k, n in want.items()) + "'",
            loop_test_nodes=nodes[LOOP_TEST],
            while_nodes=gcen.get("conditional", 0),
            host_nodes=gcen.get("host", 0),
            memcpy_dtoh=gcen.get("memcpy_dtoh", 0),
            memcpy_unknown=gcen.get("memcpy_unknown", 0),
            graph_kernels=gcen.get("kernel", 0),
            resident_intact=prog["resident_intact"],
            reserved_bytes=reserved, program_cost_bytes=model,
            ratio=f"{reserved / model:.4f}", smi=f"'{smi}'")
        for viol in prog["violations"]:
            say("audit", mode=mode, batch=prog["batch"] or 1,
                violation=f"'{viol}'")


def check_audit_faults(g) -> None:
    """Phase 10's planted faults: each must fail the audit."""
    whole, rank = Engine.whole_run, p3._rank_sharded
    pinned = {}

    def copying(self, state, anc, sv, num_edges):
        out = whole(self, state, anc, sv, num_edges)
        host = pinned.get("mate")
        if host is None:      # the warm-up's eager run, not the recording
            host = pinned["mate"] = torch.empty(
                out.mate.shape, dtype=out.mate.dtype, pin_memory=True)
        host.copy_(out.mate, non_blocking=True)
        return out

    def one_more_ring(mate_sh, batch=1):
        dist, reach = rank(mate_sh, batch)
        p3._ring(dist, 0, batch)
        return dist, reach

    def writing(self, state, anc, sv, num_edges):
        out = whole(self, state, anc, sv, num_edges)
        state.pk_mask.zero_()
        return out

    faults = {"dtoh_copy": (mock.patch.object(Engine, "whole_run", copying),
                            "memcpy_dtoh"),
              "extra_ring": (mock.patch.object(p3, "_rank_sharded",
                                               one_more_ring), "ring_step"),
              "writes_inputs": (mock.patch.object(Engine, "whole_run",
                                                  writing),
                                "changed the static inputs")}
    for name, (patch, needle) in faults.items():
        solver = EulerSolver(n_parts=PARTS, width_ladder=(1,))
        with patch:
            report = audit_graph(solver, g)
        viol = report["programs"][0]["violations"]
        caught = not report["ok"] and any(needle in v for v in viol)
        say("audit", fault=name, caught=caught,
            violations=f"'{' | '.join(viol)}'")
        if not caught:
            raise AssertionError(f"[audit] the planted fault {name} passed "
                                 f"the audit")
        del solver
        torch.cuda.empty_cache()


def check_audit_eviction(smi: str) -> None:
    """Phase 10's eviction check (module docstring)."""
    a, b = (eulerian_rmat(s, avg_degree=AVG_DEGREE, seed=SEED)
            for s in EVICT_SCALES)
    solver = EulerSolver(n_parts=PARTS)
    ka, kb = solver.bucket_of(a), solver.bucket_of(b)
    if kb[0] <= ka[0]:
        raise AssertionError(f"[audit] bucket B's e_cap {kb[0]} is not "
                             f"above A's {ka[0]}")
    events = []
    evict, capture_run = Engine.evict_program, FusedRun._capture

    def counted_evict(self, num_edges, batch):
        events.append(("evict", num_edges))
        return evict(self, num_edges, batch)

    def counted_capture(self):
        events.append(("record", self.num_edges))
        return capture_run(self)

    with mock.patch.object(Engine, "evict_program", counted_evict), \
            mock.patch.object(FusedRun, "_capture", counted_capture):
        solver.solve(a).validate()
        reserved_a = solver._engines[ka].fused_program(ka[0]).reserved_bytes
        model_a, model_b = (program_cost_bytes(k, None, sharded=True)
                            for k in (ka, kb))
        budget = solver.program_cache_bytes = int(1.5 * reserved_a)
        predicted_b = solver._program_cost(kb, None)
        torch.cuda.reset_peak_memory_stats()
        solver.solve(b).validate()
        peak = torch.cuda.max_memory_reserved()
    reserved_b = solver._engines[kb].fused_program(kb[0]).reserved_bytes
    order = [e for e in events if e in (("evict", ka[0]),
                                        ("record", kb[0]))]
    first = order == [("evict", ka[0]), ("record", kb[0])]
    say("audit", check="eviction", scale_a=EVICT_SCALES[0],
        scale_b=EVICT_SCALES[1], parts=PARTS, e_cap_a=ka[0], e_cap_b=kb[0],
        reserved_a=reserved_a, model_a=model_a,
        ratio_a=f"{reserved_a / model_a:.4f}", budget_bytes=budget,
        model_b=model_b, predicted_b=predicted_b, reserved_b=reserved_b,
        predicted_over_measured_b=f"{predicted_b / reserved_b:.4f}",
        ratio_b=f"{reserved_b / model_b:.4f}",
        events=f"'{json.dumps(events, separators=(',', ':'))}'",
        evicted_before_record=first, peak_reserved_bytes=peak,
        evictions=solver.cache_stats.evictions, smi=f"'{smi}'")
    if not first:
        raise AssertionError(f"[audit] bucket A was not evicted before B "
                             f"recorded: {events}")
    if peak >= reserved_a + reserved_b:
        raise AssertionError(f"[audit] B's solve peaked at {peak} reserved "
                             f"bytes, not below A's and B's programs "
                             f"together ({reserved_a + reserved_b})")
    del solver
    torch.cuda.empty_cache()


def check_audit(smi: str) -> None:
    """Phase 10 (module docstring)."""
    t0 = time.perf_counter()
    g = eulerian_rmat(AUDIT_SCALE, avg_degree=AVG_DEGREE, seed=SEED)
    for mode in ("sharded", "replicated"):
        solver = EulerSolver(n_parts=PARTS, width_ladder=AUDIT_WIDTHS,
                             **MODES[mode])
        t = time.perf_counter()
        report = audit_graph(solver, g)
        say("audit", mode=mode, scale=AUDIT_SCALE, parts=PARTS,
            e_cap=report["bucket"]["e_cap"],
            n_levels=report["bucket"]["n_levels"],
            programs=len(report["programs"]), ok=report["ok"],
            seconds=f"{time.perf_counter() - t:.3f}",
            per_program_bytes=_compact(
                report["cache_budget"]["per_program_bytes"]))
        audit_lines(mode, report, smi)
        if not report["ok"]:
            raise AssertionError(f"[audit] {mode}: a program failed the "
                                 f"audit")
        del solver
        torch.cuda.empty_cache()
    check_audit_faults(g)
    check_audit_eviction(smi)
    say("audit", seconds=f"{time.perf_counter() - t0:.3f}")


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
    # f32 products in full f32 for the twins (both are PyTorch's default)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
        kernel = None
        for line in p.with_suffix(".log").read_text().splitlines():
            if "Compiling entry function" in line:
                kernel = entry_name(line)
            elif "registers" in line or "spill" in line or "C75" in line:
                say("build", kernel=kernel, ptxas=f"'{line.strip()}'")

    # ---- 3. kernels against their twins at the main path's width ----
    rounds = p3.sharded_phase3_schedule(N_MAIN // 2, PARTS)["doubling_rounds"]
    table = check_kernels(dev, rounds)
    table["loop_condition"] = check_loop_condition(dev, (16, 54))

    # ---- 4. small parity: cuda against cpu, every Phase 3 mode ----
    g = eulerian_rmat(8, avg_degree=AVG_DEGREE, seed=SEED)
    first = None
    for mode, opts in MODES.items():
        for device in ("cuda", "cpu"):
            r = solve(g, n_parts=2, device=device, fused=False,
                      **opts).validate()
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
    launches, results, loop_rounds = {}, {}, {}
    for sharded in (True, False):
        res, counts, peak, rounds_run = solve_counted(
            g, sharded_phase3=sharded)
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
            splice_rounds="'" + ",".join(f"{m}:{r}/{b}" for m, r, b
                                         in rounds_run) + "'",
            **{k: f"{v:.3f}" for k, v in res.timings.items()})
        if not matches:
            raise AssertionError("circuit differs from the numpy list-rank "
                                 "twin")
        if counts != want:
            raise AssertionError(f"launches {counts}, expected {want}")
        for name in PATH_KERNELS[sharded]:
            launches[name] = counts[name]
        results[sharded] = res
        loop_rounds[sharded] = rounds_run
    same = (np.array_equal(results[True].circuit, results[False].circuit)
            and np.array_equal(results[True].mate, results[False].mate))
    say("slice", sharded_equals_replicated=same)
    if not same:
        raise AssertionError("sharded and replicated solves differ")
    del res
    torch.cuda.empty_cache()

    # ---- 5b. the fused run: one recorded graph per bucket (5c's repeat
    # solve and 5d's pipelined pair at the main scale run in its sharded
    # session) ----
    launches["loop_condition"] = check_fused(args.scale, g, results,
                                             loop_rounds)
    del results, g
    torch.cuda.empty_cache()

    # ---- 5c. the session: solve_many, two live graphs, evictions ----
    check_session()

    # ---- 5d. asynchronous solves: in flight, out of order, evicted ----
    check_async_small()

    # ---- 5e. batched solves: one program per (bucket, B) ----
    check_batch(dev)
    check_batch_large(args.scale - 1, smi)

    # ---- 5f. the reference's host engine beside the device solve ----
    check_host(args.scale - 4, smi)

    # ---- 5g. the Euler serving loop and the program byte budget ----
    check_serve(args.scale, smi)

    # ---- 6–7. K5 and K6 against their twins, timed ----
    table["segment_sum_sorted"] = check_k5(dev)
    table["flash_attention"] = check_k6(dev)

    # ---- 8. small LM parity: cuda against cpu ----
    check_lm_parity(dev)

    # ---- 9. the LM serving path at full width ----
    counts = check_lm_slice(dev, smi)
    launches["segment_sum_sorted"] = counts["segment_sum_sorted"]
    launches["flash_attention"] = counts["flash_attention"]

    # ---- 10. the program audit, planted faults, the first-record charge
    check_audit(smi)

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
