#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                 # scale-20 RMAT graph, 8 partitions,
                                          # full-width SmolLM-360M serving
                                          # and training, full-width
                                          # Qwen1.5-MoE-A2.7B serving,
                                          # GCN/GAT/PNA training, AutoInt
                                          # training, serving, retrieval,
                                          # NequIP training, full-width
                                          # StarCoder2-7B and Granite-20B
                                          # serving, the engine over one
                                          # NCCL rank, the paper's Euler
                                          # cells and the production
                                          # mesh's dry run, SmolLM-360M
                                          # over a DeviceMesh and the
                                          # dense LMs' dry-run rows

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
                alone; then K1 and K2 at N = 8,388,608 on seeded records
                of which 4,096 point at −1, −N, N or N + 5: bit-equal to
                the twins, which read such a pointer as a jnp gather
                does (``check=gather_rule``), with no fault;
  4. parity   — a scale-8, 2-partition eager solve (``fused=False``) on
                ``cuda`` and on ``cpu`` in each Phase 3 mode (sharded, the
                default; replicated; ``gather_circuit=False``): every
                circuit and mate byte-identical, all validated;
  4b. repair  — an overflowing solve returns its flags: the scale-8,
                P = 8 modal bucket's replicated engine with its open
                table cut to 80 (``REPAIR_*``), fused, seed 12 (which
                overflows and leaves the walk's start without a
                predecessor: the halt at −1) and seed 2 (which fits),
                each alone and as a B = 2 batch with seed 12 first, on
                ``cuda`` (launch counters set to 0 before and read
                after: K1/K2 launched) and on ``cpu``: every output of
                the card byte-equal to the CPU's, each batch member
                byte-equal to its own run; flags and ``phase3_ok``
                printed.  ``python3 chip_smoke.py --overflow-cell`` runs
                only phases 1–2 and the meshless fused run of
                euler-rmat-512's full caps at P = 16 on the main path's
                graph, which overflows them (``[overflow]``);
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
                runs while A replays, then ``result()`` of each; twice
                each in turns (sequence, pipeline, pipeline, sequence,
                each in new objects, their memo entries and states
                dropped after), ``seq_s`` and
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
                one-graph replay's.  At the main scale less three (17)
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
                bf16 at D 128 (B 1, S = T = 4,096, 8/2 heads), at the MoE
                slice's prefill (B 4, S = T = 4,096, 16/16 heads, D 128)
                and D 32 (B 2, S = T = 2,048, 6/2 heads), a causal
                suffix across tile edges (S = 1,000 queries over T =
                4,097 keys), and f32 at D 16 (``flash_f32_kernel<16>``)
                at ``main_lm``'s prefill of the reduced Granite-20B (B 4,
                S = T = 64, 8/1 heads) and Qwen3-MoE (8/2) and at B 4,
                S = T = 4,096, 8/2: f32 within 2e-5, bf16 elementwise
                within 5e-2 of |want| plus its row's RMS, a limit that a
                twin dropping one KV tile or mapping the heads wrongly
                must exceed;
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
                predicted and measured bytes are printed;
  11. train   — the LM trainer (``launch/train.py``, the ``build_cell``
                train step: ``lm_loss`` under autograd with each layer and
                each attention and cross-entropy block checkpointed,
                AdamW, the warm-up/cosine schedule), every launch counter
                set to 0 before and read after: no kernel of the port may
                launch.  (a) The reduced config in f32 with ``remat`` and
                ``q_block`` 16 at seq 64, one set of seeded weights on
                ``cuda`` and on ``cpu``: loss and every gradient, then one
                train step's moments, ``allclose`` at ``TRAIN_RTOL``/
                ``TRAIN_ATOL``, and the parameters unchanged (lr 0 at step
                0); then one step from a warm AdamW state (step 1000,
                seeded moments, lr 1.5e-4): loss, step and moments at the
                same tolerance, every weight's update within
                ``UPDATE_ATOL``, and every weight tensor moved by more
                than ``TRAIN_ATOL``.  Attention without its 1/√D and an
                update without its weight decay (planted) must each fail
                it.
                (b) ``train.main`` at full width (``--full``, batch 8,
                seq 1,024, ``TRAIN_STEPS`` steps, a checkpoint every 20, a
                failure injected at step 30, a temporary checkpoint
                directory removed after): one restart, the restored state
                byte-equal to the snapshot its step saved, the replayed
                step 20's loss equal to its first run's, and the loss
                falling (the reference's assertion); prints the first,
                least and last loss, the restarts and flagged stragglers,
                the median step seconds and tokens/s, the peak memory, and
                each save's bytes, snapshot, blocking and write seconds and
                the restore's bytes and seconds.  (c) The train step at
                train_4k's sequence (4,096; the batch cut from 256 to 8):
                two warm-up steps and five timed, step ms, tokens/s, the
                reference's model FLOPs (6·N·tokens) and their share of
                989 TFLOP/s bf16, the peak memory; then one step under
                torch.profiler, its device time (each device event
                counted once; it may not exceed the step's wall) split
                into attention passes (and their matrix products), the
                other matrix products, cross-entropy, the optimizer and
                the rest.
  12. moe     — the MoE LM (``models/moe.py``, Qwen1.5-MoE-A2.7B), on a
                drained card (``memory_allocated()`` printed first, under
                1 GiB): (a) the reduced config in f32 (D 32), one set of
                seeded weights on ``cuda`` and on ``cpu``, as phase 8
                (the reduced Qwen3-MoE, D 16, runs in phase 16 (a)); (b)
                one MoE FFN at full width (d 2,048, 60 experts, top-4,
                width 1,408, 4 shared, bf16, 256 tokens, capacity factor
                8: no pair may drop) against
                the dense ``moe_ffn_reference`` by ``scaled_err`` within
                3e-2, which a combine without the gate weights and a
                slot shifted by one expert must each exceed; and the
                share of (token, k) pairs the reference's routing drops
                at the prefill's 16,384 tokens (capacity factor 1.25);
                (c) ``serve_lm`` of the full config (24 layers, seeded
                weights from a generator on the card) at phase 9's
                shape, as phase 9: counters set to 0 before the first
                fused serve and read after and around each recording (K6
                24 times in the prefill graph, none in the decode graph,
                one capture), three fused and three eager serves with the
                same ids, the first three decode replays against eager
                ``decode_step``s (phase 9's decode-against-a-longer-
                prefill check does not carry over: the prefill routes
                with C = 171 per 2,048-token group and a decode step with
                C = 1 per 4 tokens); (d) the full width cut to 2 layers in
                f32, B 2, P 128, 4 decode steps on the card and on the
                CPU: every step's logits within 1e-4, the ids equal, and
                each routing choice that differs printed with its two
                probabilities (a gap under 1e-5 is rounding, any other a
                fault); (e) one eager run and one replay each of the
                prefill and the decode program under torch.profiler, the
                device time split into routed-expert products,
                shared-expert products, dispatch and combine, the
                router, K6 and the rest.
  13. gnn     — the GNN family (``models/gnn.py``: GCN, GAT, PNA; the
                ``build_cell`` train step: ``gnn_loss`` under autograd,
                AdamW, the warm-up/cosine schedule; the
                ``NeighborSampler``) on a drained card, every launch
                counter set to 0 before and read after: no kernel of the
                port may launch.  (a) Each reduced config in f32 at the
                reference smoke's shapes (64 nodes / 256 edges, and 4
                molecules of 8 / 16, padded to 512 / 512), a seeded
                graph with padded nodes, masked edges, an isolated node
                and a duplicate edge, one set of seeded weights on
                ``cuda`` and on ``cpu``: logits, loss and every gradient
                within ``GNN_TOL``, then one step from a warm AdamW state:
                loss and moments within ``GNN_TOL``, every weight's update
                within ``GNN_UPDATE_ATOL``; a segment maximum over a zero
                buffer that takes part (planted) must exceed both in PNA.
                (b) Each full config (GCN 2 × 16, GAT 2 layers of 8 heads
                × 8, PNA 4 × 75 with 4 aggregators × 3 scalers) at Cora's
                full_graph_sm (2,708 nodes, 10,556 edges, 1,433 features,
                7 classes, padded to 3,072 / 10,752) on the example's
                planted-partition graph: ``GNN_STEPS`` steps, the first,
                least and last loss, the train accuracy (above 0.5), the
                median step ms and the peak memory.  (c) minibatch_lg:
                blocks of 1,024 seeds (fanouts 15, 10; 169,984 padded
                nodes and edges) from ``NeighborSampler`` over a seeded
                uniform random graph with Reddit's 232,965 nodes and a
                tenth of its edges (the cut printed as ``reduced=``), a
                602-wide f32 feature table on the card gathered by node
                id (pad rows zero), 41 classes; each arch at full width
                ``GNN_BLOCK_STEPS`` steps on fresh blocks: the seconds to
                sample a block, the median step ms and the peak memory.
  14. recsys  — AutoInt (``models/recsys.py``; ``build_cell``'s train,
                serve and retrieval cells; ``SyntheticCTR``) on a drained
                card, every launch counter set to 0 before and read after:
                no kernel of the port may launch.  (a) The reduced config
                at the reference smoke's batch of 16, and the full widths
                (39 fields, d 16, 3 layers of 2 × 32 heads, MLP 400-400)
                with the vocabulary cut to 4,096 at a batch of 256: one
                set of seeded weights on ``cuda`` and on ``cpu``, logits,
                loss and every gradient within ``REC_TOL``, one step from
                a warm AdamW state: loss and moments within ``REC_TOL``,
                every weight's update within ``REC_UPDATE_ATOL``; an
                ``embedding_bag`` that ignores the bag mask (planted) must
                exceed both.  The host draws every later batch from
                ``SyntheticCTR`` in ``REC_DRAW_THREADS`` threads first (each
                draw's seconds printed).  (b) train_batch at the full
                config: the 39,000,000 × 16 f32 table (2.496 GB) drawn on
                the card, ``REC_STEPS`` steps at 65,536 on batches uploaded
                before the clock, each loss finite and in the reference
                smoke's (0, 10): median step ms, examples/s, model
                TFLOP/s by ``_rec_flops`` and its share of 67 TFLOP/s f32
                (TF32 is off), the loss first/least/last, peak memory;
                one more step under torch.profiler, its device time split
                into the embedding bag, attention (its products apart),
                the MLP, the optimizer and the rest; then the first
                ``REC_LOGIT_ROWS`` examples' logits at the full table
                against the CPU.  (c) serve_p99 (512) over
                ``REC_P99_CALLS`` synchronised calls: p50, p99,
                examples/s; serve_bulk (262,144): median ms, examples/s;
                each with its peak memory and one profiled call; the bulk
                batch's first 512 logits against a 512-batch forward.  (d)
                retrieval_cand: one query against a seeded [1,000,000, 16]
                f32 candidate matrix, the best row copied into four more
                rows and the 50th into two (exact ties): the tied rows in
                ascending index order, the top 100's median ms, values
                and indices against the CPU (indices may differ only
                between candidates whose scores are within
                ``REC_TIE_ATOL``).
  15. nequip  — NequIP (``models/equivariant.py``; ``build_cell``'s
                NequIP cells) on a drained card, every launch counter set
                to 0 before and read after: no kernel of the port may
                launch.  (a) The reduced config (2 layers, 8 channels, 4
                RBF) and the full one (5 layers, 32 channels, 8 RBF) on
                a seeded batch of 4 molecules of 12 atoms with pads, one
                set of seeded weights carried across as numpy: energies,
                forces, the energy loss and the force loss with every
                gradient (second order) within ``NEQ_TOL``, the largest
                error printed; an l = 2 part that keeps its trace
                (planted) must exceed it.  (b) At full width on
                ``molecule``'s batch: under a seeded rotation and a
                translation the summed energy within 1e-4 relative and
                ``F(Rx + b)`` within rtol 2e-3, atol 2e-4 of ``R F(x)``
                (the reference property test's tolerances), each
                molecule's energy too; a term fixed in the lab frame
                (planted) must break it.  (c) ``NEQ_STEPS`` train steps
                at full width and size from seeded weights on seeded
                point clouds (jittered lattice sites; species in [0, 8);
                ``molecule`` 128 molecules of 30 atoms, each with its 64
                shortest directed pairs, 4,096 / 8,192 padded, on
                energies and forces; ``full_graph_sm`` 2,708 atoms and
                10,556 nearest-neighbour edges padded to 3,072 / 10,752;
                ``minibatch_lg`` 169,984 atoms and edges), Morse-well
                targets: ms a step, peak memory, model TFLOP/s by
                ``Cell.model_flops``, the loss first/least/last, each loss
                finite and falling on ``molecule`` and ``full_graph_sm``;
                one more step of ``molecule`` and of ``minibatch_lg``
                under torch.profiler, its device time split into
                gathers, scatters, products, the rest and the optimizer.
                (d) ``ogb_products``: its abstract cell only, and the 71.26
                GB one layer's gathered ``t_j`` would hold.
  16. code    — the code LMs StarCoder2-7B (arXiv:2402.19173: 32 layers,
                d 4,608, 36 query heads on 4 KV heads of 128, RoPE base
                10⁶) and Granite-20B (arXiv:2405.04324: 52 layers, d
                6,144, 48 on 1), the reference's architecture, on a
                drained card.  (a) The reduced StarCoder2-7B (K6 in f32
                at D 32), Granite-20B and Qwen3-MoE (f32 at D 16) as
                phase 8, then ``main_lm --arch`` of each, the
                reference's entry point, on the card and on the CPU:
                the same ids, K6 launched twice a layer on the card (the
                warm-up and the recording).  (b) Each at full width cut
                to 2 layers in f32 (seeded weights drawn on the card,
                then moved), B 1, P 128, 4 greedy decode steps on the
                card and on the CPU: every step's logits within 1e-4
                (rtol and atol), the ids equal.  (c) K6 against its twin
                (run one sequence at a time) at each full prefill shape
                (B 4, S = T = 4,096, 36/4 and 48/1 heads, D 128, bf16,
                causal): ``scaled_err`` within 5e-2 and ``allclose`` at
                3e-2; kernel, twin and SDPA times beside the bound.  (d)
                A twin dropping a KV tile, and at StarCoder2's 9:1 one
                mapping query head h to KV head h mod 4, must exceed the
                limit (at 48:1 every head reads KV head 0, so a wrong
                mapping cannot show there).  (e) Each served at full
                width and depth at phase 9's shape, as phase 12 (c)
                (seeded bf16 weights drawn on a CUDA generator: 20.23 GB
                and 56.33 GB), the card drained before each: K6 recorded
                32 and 52 times in the prefill graphs and never in the
                decode graphs, three fused and three eager serves
                (``prefill_s``, ``decode_tok_s``, peak allocated and
                reserved memory), the first three decode replays against
                eager steps; one prefill and one decode replay under
                torch.profiler (busy, idle share, the kernels by device
                time) beside the decode bound (every weight but the
                embedding and the whole cache read once at 3.35 TB/s)
                and the prefill bound (2 operations a layer weight a
                token and K6's attention at 989 TFLOP/s).
  17. mesh    — the engine across ranks (``launch/mesh.py``,
                ``EulerSolver(mesh=…)``): one NCCL rank in this process
                (a ``FileStore`` world of 1; NCCL refuses two ranks on
                one card; ``NCCL_GRAPH_MIXING_SUPPORT=0`` set first, as
                the mesh asks) holding all 8 partitions, the group
                destroyed after its solvers are gone.  On the main path's graph, reusing phase 5b's
                prepared graph: a fused sharded and a fused replicated
                solve over the mesh, each cold (the launch counters and
                the mesh's call counts set to 0 just before the
                recording and read just after: the calls must equal
                ``fused_collective_budget``'s, the K1–K4 and loop-test
                launches the meshless recording's of phase 5b), then
                replayed (nothing launched or called from Python); an
                eager sharded solve (each level's logs gathered); each
                byte-equal to phase 5's meshless solve, its times and
                peak memory printed beside phase 5b's and phase 5's
                meshless ones.  Batches over the mesh
                (``[mesh] run=batch``): seed 0's scale-16 graph and the
                first later seed of its bucket as ``[g0, g1]`` and
                ``[g0, g1, g0, g1]`` (``MESH_BATCH_*``), sharded and
                replicated, each width recorded and replayed over the
                mesh and without it: byte-equal, the recording's calls
                the one-graph budget, its K1–K4 launches the meshless
                recording's, warm ``run_s`` beside meshless.  The
                serving loop over the mesh (``[mesh] run=serve``):
                ``main_euler`` in-process with phase 5g's arguments,
                ``--widths 8 --sync-prewarm`` and 256 requests at
                pipeline depth 2 and 0, over the mesh and without it:
                every request's circuit and mate byte-equal, one flush
                broadcast a dispatch and the stop, K3/K4 launched (the
                launch counters set to 0 before each run and read
                after); circuits/s and p50/p95 beside meshless.  The
                autotuner over the mesh (``[mesh] run=serve_adaptive``):
                ``main_euler --adaptive`` in-process with phase 5g's
                arguments, 256 requests at pipeline depth 0, over the
                mesh (rank 0's tuner, its recordings run on the serving
                thread as orders of the broadcast stream) and without it
                (the compile thread): every request validated and
                byte-equal between the two, at least one prewarm order
                run and a flush wider than 1 dispatched, one broadcast an
                order and the stop, K3/K4 launched; circuits/s, p50/p95,
                ``first_wide_flush_s``, the orders and their broadcast
                bytes by kind, recordings and tuner steps beside
                meshless, and the compile jobs ``drain()`` ran after the
                last result (outside the timed window).  A retune order over the mesh (``[mesh]
                run=retune``): phase 5g (f)'s forced tighten of the
                scale-9 pool's bucket, announced through a
                ``MicroBatcher`` (``compile_next``: the tighten, the
                rekey and the tight B = 1 and 8 recordings as one order)
                beside the same retune in a meshless session, then the
                pool's tight solves one at a time and a B = 8 batch of
                the retuned bucket: byte-equal request for request, the
                tight B = 1 and 8 recorded by the order, K3/K4 launched
                in its recordings.  A ring
                planted to send to rank − 1 (at world 1 the local rows
                roll the wrong way) must change the bytes or fail the
                solve, eager and fused, at scale 8.
  18. cells   — the paper's own architecture, ``euler-rmat``
                (``configs/euler_rmat.py``, ``build_cell``'s Euler half,
                ``parallel/sharding.py``).  (a) Both cells of the full
                config (``euler-rmat-512``: every cap as the reference's,
                10 levels, ``fused_edges`` 4,194,304) built over one NCCL
                rank holding ``CELL_PARTS`` = 16 partitions (cut from
                512, one a device) on the Eulerian RMAT graph of
                ``CELL_SCALE`` 11, the largest whose partitions fit the
                caps (the scale-20 graph overflows them): each
                level's ``superstep`` cell byte-equal to the meshless
                engine's, no kernel launched, every flag holding; the
                ``fused`` cell (the stub-vertex map padded with vertex 0
                to 2 · 4,194,304 stubs, those stubs unmated) recorded
                and replayed, its circuit, mate, flags and metrics
                byte-equal to the meshless ``FusedRun`` of the same caps,
                the circuit valid and its padding −1, the recording's
                K1/K2 launches (24 each) and calls (the budget)
                counted just around it; ``warmup_s``, ``capture_s``,
                ``run_s``, peak allocated and reserved.  (b) ``python -m
                repro_torch.launch.dryrun --arch euler-rmat
                --both-meshes`` in a process of its own: rank 0 of a
                ``fake`` world of 256 and of 512 ranks, both cells of the
                full config (one partition a rank, empty tables) on the
                card, each with its arguments', outputs', peak and
                reserved bytes, the ``program_cost_bytes`` model, the
                bytes each kind of collective sends, the launches and
                the dominant H100 term; the fused cell's K1/K2 launches
                are added to the kernel table's.
  19. lm-mesh — the LM family over a ``DeviceMesh`` (``build_cell``'s LM
                half with a mesh, ``models/transformer.py``'s
                ``MeshPlan``): one NCCL rank, ``make_test_mesh(1, tp=1)``,
                SmolLM-360M at full width and depth in bf16 from seeded
                weights drawn on the card, placed with
                ``steps.place_lm_state``.  (a) ``LM_MESH_TRAIN``: 3 steps
                of the train cell at batch 8, seq 1,024 over the mesh and
                3 meshless steps from the same weights, the same batches
                and AdamW at the warm step ``LM_MESH_WARM_STEP`` (its
                learning rate moves bf16 weights; at step 0 it is 0):
                every loss ``allclose`` at ``LM_MESH_TOL``, each
                parameter's update and both moments within
                ``LM_MESH_STATE_TOL`` of the meshless ones (in norm),
                and the weights moved by more than that; each run's step
                ms, peak allocated and
                reserved memory, and the collectives of one more mesh
                step (``dryrun.CommCount``, a ``CommDebugMode``: it sees
                every op, so no timed call runs under it).  (b)
                ``LM_MESH_SERVE``: the prefill cell at B 4, prompt 4,096
                over the mesh, cold then warm (the launch counters set to
                0 just before the first and read just after: K6 once a
                layer, 32), beside a cold and a warm meshless eager
                prefill, logits ``allclose``; then 32 decode cells over
                the mesh beside meshless eager ``decode_step``s, both fed
                the meshless greedy tokens, every step's logits
                ``allclose``, and one more mesh step counted; prefill
                seconds and decode ms over the mesh and meshless, peaks
                and collectives.  The mesh prefill's K6 launches are added to
                the kernel table's.  (c) ``python -m
                repro_torch.launch.dryrun --arch granite-20b`` in a
                process of its own: Granite-20B's train_4k, prefill_32k
                and decode_32k on rank 0 of a ``fake`` world of 256 (the
                largest cells one card cannot hold), each with its
                arguments', outputs', peak and reserved bytes and the
                collectives DTensor issued, by kind, with the bytes a
                rank sends in them.

After each phase from 2 on, a ``[timing]`` line gives the seconds since
the start.  The last three lines are the kernel table as JSON, the
``nvidia-smi`` line, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import datetime
import gc
import json
import os
import re
import runpy
import shutil
import statistics
import subprocess
import sys
import math
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.analysis import audit_graph  # noqa: E402
from repro_torch.checkpoint import ckpt as ckpt_mod  # noqa: E402
from repro_torch.analysis.graph_audit import (  # noqa: E402
    LOOP_TEST, graph_kernel_nodes, program_cost_bytes)
from repro_torch.configs.base import (ShapeCell, gnn_shapes,  # noqa: E402
                                      lm_shapes)
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import capture  # noqa: E402
from repro_torch.core import phase1 as p1  # noqa: E402
from repro_torch.core import phase3 as p3  # noqa: E402
from repro_torch.core.engine import (Engine, FusedOut,  # noqa: E402
                                     FusedRun, PendingRun, drained_clock,
                                     fused_collective_budget,
                                     state_from_numpy, stub_vertex)
from repro_torch.core.graph import Graph, partition_graph  # noqa: E402
from repro_torch.core.hierholzer import validate_circuit  # noqa: E402
from repro_torch.core.phase3 import circuit_from_mate_np  # noqa: E402
from repro_torch.data.lm import SyntheticLM  # noqa: E402
from repro_torch.data.recsys import (SyntheticCTR,  # noqa: E402
                                     batch_to_device)
from repro_torch.euler import EulerSolver, solve  # noqa: E402
from repro_torch.euler.autotune import (CompileService,  # noqa: E402
                                        TunerParams)
from repro_torch.ft.straggler import StragglerMonitor  # noqa: E402
from repro_torch.euler.bucket import (TIGHT_DIVISORS,  # noqa: E402
                                      ladder_floors, modal_bucket_pool,
                                      strip_circuit)
from repro_torch.graphgen.eulerize import eulerian_rmat  # noqa: E402
from repro_torch.graphgen.partition import partition_vertices  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import graph_loop  # noqa: E402
from repro_torch.kernels import pointer_double as pd  # noqa: E402
from repro_torch.kernels import segment_reduce as sr  # noqa: E402
from repro_torch.launch import serve, steps, train  # noqa: E402
from repro_torch.launch.mesh import (NCCL_GRAPH_MIXING,  # noqa: E402
                                     PartMesh, expected_calls,
                                     make_part_mesh)
from repro_torch.launch.serve import LMPrograms, serve_lm  # noqa: E402
from repro_torch.graphgen.sampler import NeighborSampler  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import equivariant  # noqa: E402
from repro_torch.models import recsys  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.models.layers import (auto_q_block,  # noqa: E402
                                       chunked_gqa_attention, gqa_attention)
from repro_torch.optim import (AdamWState, adamw_update,  # noqa: E402
                                init_adamw)
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

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
#: phase 5d's turns at the main scale, two a way
ASYNC_TURNS = ("seq", "pipe", "pipe", "seq")
#: phase 3's repair check: records of the main path's N with an
#: out-of-range pointer
GATHER_RULE_ROWS = 4096
#: phase 4b: tests/test_torch_halt.py's overflowing solve: the scale-8,
#: P = 8 modal bucket's engine with its open table cut to REPAIR_OPEN_CAP
#: overflows on seed 12 and leaves the start's sibling unmated (the
#: reference's halt at −1); seed 2 fits
REPAIR_SCALE, REPAIR_OPEN_CAP, REPAIR_SEEDS = 8, 80, (12, 2)
#: the kernels each Phase 3 path runs, by the solver's sharded_phase3
PATH_KERNELS = {False: ("pointer_double", "pointer_double_rank"),
                True: ("pointer_double_shard", "pointer_double_rank_shard")}
MODES = {"sharded": {}, "replicated": {"sharded_phase3": False},
         "no_gather": {"gather_circuit": False}}
#: phase 10: the audited bucket's scale and widths, and the eviction
#: check's two buckets (A, then the larger B)
AUDIT_SCALE, AUDIT_WIDTHS = 8, (1, 2, 4, 8)
EVICT_SCALES = (16, 17)
#: phase 11 (b): the trainer through its entry point at full width —
#: batch, sequence, steps, checkpoint interval and the injected failure;
#: the loss must fall over the run (the reference's assertion), and the
#: schedule's warm-up gives lr = 3e-4 · step / 2000, so the run is as
#: long as that takes (PERF.md §6 says how the count was chosen)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 60
TRAIN_EVERY, TRAIN_FAIL = 20, 30
#: phase 11 (c): train_4k's sequence, its batch cut from 256 to 8, two
#: warm-up steps and five timed ones
THROUGHPUT_BATCH, THROUGHPUT_WARMUP, THROUGHPUT_STEPS = 8, 2, 5
#: phase 11 (a): one train step of the reduced config in f32 on the card
#: against the CPU, loss, gradients and moments by ``allclose``: ten
#: times ROADMAP's f32 rtol and an atol of 1e-5 (the gradients reach
#: 0.6).  The CPU tests read 1.1e-6 between XLA and torch on the same
#: step (tests/test_torch_train.py); cuBLAS orders its sums otherwise
#: again.  The planted fault, attention without its 1/√D, must fail it
TRAIN_RTOL, TRAIN_ATOL = 1e-4, 1e-5
#: phase 11 (a): the atol on one warm step's parameter updates (about
#: 1.5e-4 each at lr 1.5e-4): gradients within 1.5e-6 move an update by
#: at most ~2e-8, and the f32 rounding of a weight near 1 by 1.2e-7; a
#: dropped weight decay moves a weight near 1 by 1.5e-5
UPDATE_ATOL = 1e-6
#: kernel names of the matrix products in a profile
GEMM_WORDS = ("gemm", "xmma", "cutlass", "nvjet")
#: phase 12: the MoE arch served at full width and depth
MOE_ARCH = "qwen2-moe-a2.7b"
#: phase 12 (b): one full-width MoE layer's tokens and the capacity
#: factor at which none of them drops; ``moe_ffn`` is held to the dense
#: ``moe_ffn_reference`` by ``scaled_err`` (both in bf16, the products
#: rounded in other orders), and a combine without the gate weights and
#: a slot shifted by one expert must each exceed it
MOE_LAYER_TOKENS, MOE_LAYER_CF, MOE_BF16_TOL = 256, 8.0, 3e-2
#: phase 12 (d): full width cut to 2 layers in f32, B 2, P 128, 4 decode
#: steps, card against CPU by ``allclose``; a routing choice that differs
#: between the two is rounding when its two probabilities are closer
#: than ROUTING_GAP, and a fault otherwise
MOE_DEPTH2 = dict(layers=2, batch=2, prompt=128, steps=4)
MOE_F32_TOL, ROUTING_GAP = 1e-4, 1e-5
#: phase 12 (e): the ``models/moe.py`` functions whose kernels make up
#: each family of the MoE profile (the innermost one a kernel runs in
#: names its family; ``moe_ffn``'s own ops are its gather and scatter)
MOE_FAMILIES = {"moe_ffn": "dispatch_combine", "route": "router",
                "dispatch": "dispatch_combine", "combine": "dispatch_combine",
                "experts": "routed_expert", "shared_experts": "shared_expert"}
#: phase 13: the GNN archs, trained at full width
GNN_ARCHS = ("gcn-cora", "gat-cora", "pna")
#: phase 13 (a): card against CPU at the reference smoke's shapes
#: (tests/test_configs_smoke.py): logits, loss and every gradient by
#: ``allclose`` at GNN_TOL (rtol and atol; the card's scatters add in the
#: order of their atomics, PNA's logits reach 300), and one warm step's
#: parameter updates within GNN_UPDATE_ATOL.  At step 1000 the schedule's
#: lr is 9.8e-4 and the clipped gradients are at most ~0.1 an element, so
#: an update is ~1e-4–1e-3; a gradient off by 1e-4 of itself moves an
#: update by under 1e-7, the f32 rounding of a weight near 1 by 6e-8.  A
#: segment maximum reduced into a zero buffer that takes part (planted)
#: turns every PNA ``min`` into 0 and must exceed both
GNN_SMOKE = {
    "full_graph_sm": ShapeCell("full_graph_sm", "graph_train", n_nodes=64,
                               n_edges=256, d_feat=64, n_classes=7),
    "molecule": ShapeCell("molecule", "graph_train", n_nodes=8, n_edges=16,
                          batch=4, d_feat=64, n_classes=4),
}
GNN_TOL, GNN_UPDATE_ATOL = 1e-4, 1e-6
#: phase 13 (b): train steps at Cora's full width; the train accuracy
#: must pass 0.5 (the reference example's bar)
GNN_STEPS, GNN_MIN_ACC = 200, 0.5
#: phase 13 (c): minibatch_lg from the NeighborSampler over a seeded
#: uniform random graph with Reddit's nodes and a tenth of its edges,
#: fresh blocks of 1,024 seeds, GNN_BLOCK_STEPS steps an arch
REDDIT_NODES, REDDIT_EDGES = 232_965, 114_615_892
REDDIT_CUT = 10
GNN_BLOCK_STEPS = 5
#: phase 14: the recsys arch, AutoInt at its full config (39 fields ×
#: 1,000,000 rows × 16 f32, a 2.496 GB table) and its four cells
REC_ARCH = "autoint"
#: phase 14 (a): card against CPU at the reduced config and the reference
#: smoke's batch of 16, and at the full widths with the vocabulary cut to
#: 4,096 a field and a batch of 256: logits, loss and every gradient by
#: ``allclose`` at REC_TOL (rtol and atol; the card adds the table's
#: gradient rows by atomics), and one warm step's updates within
#: REC_UPDATE_ATOL.  At step 1000 the schedule's lr is 1e-3 and the
#: seeded √v̂ about 1e-3, so an update is about 1e-3 and a gradient error
#: ε moves it by about 0.1·ε; a ReLU pre-activation within rounding of 0
#: can land on either side on the two devices, which moves one example's
#: path by 3e-5 on the CPU test's table rows (tests/test_torch_recsys.py),
#: 7e-6 divided over a batch of 256.  An ``embedding_bag`` that ignores
#: the bag mask (planted) must exceed both
REC_PARITY = (("reduced", 16, None), ("full_width", 256, 4096))
REC_TOL, REC_UPDATE_ATOL = 1e-4, 1e-5
#: phase 14 (b): train steps at train_batch (65,536), the reference smoke
#: test's loss bounds, and the rows whose logits are held against the CPU
REC_STEPS, REC_LOSS_BOUNDS, REC_LOGIT_ROWS = 20, (0.0, 10.0), 64
#: phase 14 (b)–(d): host threads drawing the SyntheticCTR batches
REC_DRAW_THREADS = 8
#: phase 14 (c), (d): timed calls of serve_p99, serve_bulk, retrieval
REC_P99_CALLS, REC_BULK_CALLS, REC_RETRIEVAL_CALLS = 200, 5, 20
#: phase 14 (d): the top-k of the retrieval cell, and the gap within which
#: two candidates' CPU scores count as tied (the scores are about 1e-2,
#: their f32 rounding about 1e-9)
REC_TOP_K, REC_TIE_ATOL = 100, 1e-6
#: phase 15: NequIP (arXiv:2101.03164) at its full config (5 layers, 32
#: channels, l_max 2, 8 RBF, cutoff 5 Å) and its cells
NEQ_ARCH = "nequip"
#: phase 15 (a): card against CPU on a seeded batch of (molecules, atoms
#: each, edges each), energies, forces and every gradient of both losses
#: by ``allclose`` at NEQ_TOL (rtol and atol: the card adds messages by
#: atomics and takes other GEMM orders; gradients reach 0.2)
NEQ_PARITY_GRAPHS = (4, 12, 24)
NEQ_TOL = 1e-4
#: phase 15 (b): the reference property test's tolerances
#: (tests/test_models.py:98)
NEQ_ROT_E_RTOL, NEQ_ROT_F_RTOL, NEQ_ROT_F_ATOL = 1e-4, 2e-3, 2e-4
#: phase 15 (c): train steps of each cell, the cells whose loss must fall
#: over them, and the synthetic point clouds: species; jittered lattice
#: sites (spacing and jitter in Å: atoms at least 0.9 Å apart, as bonded
#: atoms are), a molecule's lattice side (30 atoms on 64 sites), the
#: share of a cloud's sites taken (0.148 atoms/Å³, a liquid's density);
#: the Morse targets' well (Å)
NEQ_STEPS = {"molecule": 30, "full_graph_sm": 30, "minibatch_lg": 8}
NEQ_MUST_FALL = ("molecule", "full_graph_sm")
NEQ_PROFILED = ("molecule", "minibatch_lg")
NEQ_SPECIES = 8
NEQ_SPACING, NEQ_JITTER = 1.5, 0.3
NEQ_MOLECULE_SIDE, NEQ_CLOUD_FILL = 4, 0.5
NEQ_MORSE_R0 = 1.5
#: main_lm's defaults, B 4 and a prompt of 64: the reduced configs'
#: prefill shape (B, S, T)
MAIN_LM_SHAPE = (4, 64, 64)
#: phase 16: the code LMs served at full width and depth; the reduced
#: configs whose K6 runs in f32 at head width 32 or 16
CODE_ARCHS = ("starcoder2-7b", "granite-20b")
REDUCED_K6_ARCHS = (*CODE_ARCHS, "qwen3-moe-235b-a22b")
#: phase 16 (b): full width cut to 2 layers in f32, B 1, P 128, 4 decode
#: steps, card against CPU by ``allclose`` at CODE_F32_TOL (cuBLAS and
#: the CPU sum d_model 4,608–6,144 products in other orders)
CODE_DEPTH2 = dict(layers=2, batch=1, prompt=128, steps=4)
CODE_F32_TOL = 1e-4
#: phase 16 (c): K6 at the code LMs' prefill shapes is also held to
#: ROADMAP's bf16 ``allclose`` tolerance
CODE_K6_BF16 = 3e-2


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
    check_gather_rule(dev)
    return table


def check_gather_rule(dev) -> None:
    """Phase 3's repair check: K1 and K2 on N_MAIN seeded records of
    which GATHER_RULE_ROWS point at −1, −N, N or N + 5 (the reference's
    halt at a wrapped −1, and past the table): bit-equal to the twins,
    which read such a pointer as a jnp gather does, with no fault."""
    rng = np.random.default_rng(1)
    bad = (-1, -N_MAIN, N_MAIN, N_MAIN + 5)
    for name, width, twin in (
            ("pointer_double", 2, ref.pointer_double_packed_ref),
            ("pointer_double_rank", 4, ref.pointer_double_rank_packed_ref)):
        rec = rng.integers(0, 1 << 20, (N_MAIN, width), dtype=np.int32)
        rec[:, 0] = rng.integers(0, N_MAIN, N_MAIN)
        rows = rng.choice(N_MAIN, GATHER_RULE_ROWS, replace=False)
        rec[rows, 0] = np.resize(bad, GATHER_RULE_ROWS)
        if width == 4:
            rec[:, 2] = rng.integers(0, 2, N_MAIN)
            rec[:, 3] = 0
        t = torch.as_tensor(rec, device=dev)
        got = getattr(pd, name)(t)
        torch.cuda.synchronize()          # a fault raises here
        err = max_abs_err((got,), (twin(t),))
        say("kernels", check="gather_rule", name=name, n=N_MAIN,
            out_of_range=GATHER_RULE_ROWS, pointers="'-1,-N,N,N+5'",
            bit_equal=err == 0)
        if err:
            raise AssertionError(f"{name} reads an out-of-range pointer "
                                 f"otherwise than its twin ({err})")


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


def repair_engine(dev: str):
    """``(engine, bucket key, [overflowing pg, sound pg])``: phase 4b's
    replicated engine of REPAIR_OPEN_CAP, new, for runs on ``dev``."""
    solver = EulerSolver(n_parts=PARTS, device="cpu")
    preps = [solver._prepare(eulerian_rmat(REPAIR_SCALE, avg_degree=5,
                                           seed=s), None)
             for s in REPAIR_SEEDS]
    key = preps[0][2]
    if preps[1][2] != key:
        raise AssertionError("phase 4b's graphs left their bucket")
    caps = dataclasses.replace(key[3], open_cap=REPAIR_OPEN_CAP,
                               open_ship_cap=REPAIR_OPEN_CAP)
    return (Engine(PARTS, caps, key[2], sharded_phase3=False), key,
            [p[0] for p in preps])


def repair_runs(dev: str):
    """Phase 4b's fused runs on ``dev``: each graph alone, then the B = 2
    batch with the overflowing graph first; ``([alone…], batch)`` as
    host ``FusedOut``s, and the seconds of the cold batch."""
    eng, key, pgs = repair_engine(dev)
    d = torch.device(dev)
    alone = [eng.fused_program(key[0]).launch(
        *eng.device_state(eng.load_cached(pg), d, False)).wait()[0]
        for pg in pgs]
    batch, timings = eng.fused_program(key[0], 2).launch(
        *eng.stage_batch(pgs, d)).wait()
    return alone, batch, timings


def check_repair(smi: str) -> None:
    """Phase 4b (module docstring): an overflowing replicated solve
    returns its flags, byte-equal to the CPU's, and leaves its batch
    partner intact."""
    t = time.perf_counter()
    reset_counts()
    alone, batch, timings = repair_runs("cuda")
    launched = read_counts()
    cpu_alone, cpu_batch, _ = repair_runs("cpu")
    fields = FusedOut._fields

    def same(a, b):
        return all(np.array_equal(getattr(a, f), getattr(b, f))
                   for f in fields)

    def member(out, b):
        return FusedOut(out.circuit[b], out.mate[b], out.flags[:, b],
                        out.metrics[:, b], out.phase3_ok[b])
    bad, good = alone
    start = int(np.argmax(bad.mate >= 0))
    failed = sorted({(int(lv), int(f)) for lv, f in
                     zip(*np.nonzero(~bad.flags.all(0)))})
    card_is_cpu = same(bad, cpu_alone[0]) and same(good, cpu_alone[1]) \
        and same(batch, cpu_batch)
    members = [same(member(batch, b), alone[b]) for b in range(2)]
    say("repair", scale=REPAIR_SCALE, parts=PARTS,
        open_cap=REPAIR_OPEN_CAP, seeds=",".join(map(str, REPAIR_SEEDS)),
        phase3="replicated", halt_unmated=bool(bad.mate[start ^ 1] == -1),
        flags_all=bool(bad.flags.all()),
        failed_level_flags=f"'{failed}'", phase3_ok=bool(bad.phase3_ok),
        sound_flags_all=bool(good.flags.all()),
        card_byte_equal_cpu=card_is_cpu,
        batch_members_equal_alone=",".join(map(str, members)),
        launches=json.dumps(launched, separators=(",", ":")),
        batch_run_s=f"{timings['run_s']:.4f}",
        seconds=f"{time.perf_counter() - t:.1f}", smi=f"'{smi}'")
    if bad.mate[start ^ 1] != -1 or bad.flags.all() or not good.flags.all():
        raise AssertionError("phase 4b's graphs no longer overflow as "
                             "chosen")
    if not (card_is_cpu and all(members)):
        raise AssertionError("the overflowing solve differs from the "
                             "CPU's, or corrupts its batch partner")
    if not all(launched[name] for name in PATH_KERNELS[False]):
        raise AssertionError(f"the replicated runs launched {launched}")
    torch.cuda.empty_cache()


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
        MESHLESS_FUSED[sharded] = (dict(res.timings), peak, reserved,
                                   recorded)
        PREPARED[id(g)] = solver._prep_cache[id(g)]
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
    objects, solved in sequence and pipelined, twice each in turns
    (sequence, pipeline, pipeline, sequence), so that the host prep's
    drift and spread fall on both."""
    captures = solver.captures
    say("async", **launch_breakdown(solver, graphs[0]))
    say("async", **host_contention(solver, graphs[0]))
    seqs, pipes = [], []
    for turn in ASYNC_TURNS:
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
    # (8.4-12.9 s at scale 20 on the H100's host), so over two turns
    # the raw saving carries a second or more of noise: the overlap is
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
    """Phase 5e at ``scale`` (the main scale less three), P = 8, under
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


def k6_planted_faults(q, k, v, got, faults) -> dict:
    """``scaled_err`` of K6's output ``got`` against the twin of faulty
    kernels on the first sequence, for each name in ``faults``:
    ``dropped_tile`` drops the KV tile of keys 2,048 … 2,111, and
    ``wrong_heads`` maps query head h to KV head h mod Hkv instead of
    h // (Hq/Hkv) (the same head when Hkv is 1)."""
    q, k, v, got = q[:1], k[:1], v[:1], got[:1]
    rep = q.shape[2] // k.shape[2]
    out = {}
    if "dropped_tile" in faults:
        kr, vr = k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2)
        out["dropped_tile"] = scaled_err(
            got, twin_dropping_keys(q, kr, vr, 2048, 2112))
        del kr, vr
    if "wrong_heads" in faults:
        out["wrong_heads"] = scaled_err(got, ref.flash_attention_ref(
            q, k.repeat(1, 1, rep, 1), v.repeat(1, 1, rep, 1), causal=True))
    return out


def k6_twin(q, kr, vr, causal: bool, by_rows: bool) -> torch.Tensor:
    """The twin on KV heads already repeated; ``by_rows`` runs it one
    sequence at a time (its f32 scores are B·Hq·S·T·4 bytes at once
    otherwise: 12.9 GB at Granite-20B's prefill)."""
    if not by_rows:
        return ref.flash_attention_ref(q, kr, vr, causal=causal)
    return torch.cat([ref.flash_attention_ref(q[b:b + 1], kr[b:b + 1],
                                              vr[b:b + 1], causal=causal)
                      for b in range(q.shape[0])])


def k6_case(gen, dev, label, B, S, T, Hq, Hkv, D, causal, dtype, faults=(),
            by_rows: bool = False, bf16_allclose=None,
            phase: str = "k6") -> dict:
    """K6 against its twin on seeded inputs of one shape: f32 by
    ``allclose`` at 2e-5, bf16 by ``scaled_err`` within ``K6_BF16_TOL``
    (and by ``allclose`` at ``bf16_allclose`` where given), which each
    planted fault in ``faults`` must exceed; then the kernel's, the
    twin's and one ``scaled_dot_product_attention`` call's times beside
    the bound.  Prints a line and returns the row of the kernel table."""
    q = torch.randn(B, S, Hq, D, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, T, Hkv, D, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, T, Hkv, D, generator=gen, device=dev).to(dtype)
    rep = Hq // Hkv
    kr, vr = k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2)
    got = fa.flash_attention(q, k, v, causal=causal)
    want = k6_twin(q, kr, vr, causal, by_rows)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    scaled = scaled_err(got, want)
    if dtype == torch.float32:
        ok = torch.allclose(got, want, rtol=2e-5, atol=2e-5)
    else:
        ok = scaled <= K6_BF16_TOL and (bf16_allclose is None or (
            torch.allclose(got.float(), want.float(), rtol=bf16_allclose,
                           atol=bf16_allclose)))
    del want
    torch.cuda.empty_cache()
    planted = k6_planted_faults(q, k, v, got, faults)
    del got
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=causal), 10)
    plain_ms = cuda_ms(lambda: k6_twin(q, kr, vr, causal, by_rows), 3)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    # SDPA's is_causal aligns the diagonal top-left; a suffix of the keys
    # (S < T) needs the mask written out
    mask = (torch.ones(S, T, dtype=torch.bool, device=dev).tril(T - S)
            if causal and S != T else None)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=True), 10)
    bound_ms, bound_by = attention_bound(B, S, T, Hq, Hkv, D, causal, dtype)
    extra = ({} if bf16_allclose is None or dtype == torch.float32
             else {"allclose_at": bf16_allclose})
    say(phase, case=label, shape=f"B{B}_S{S}_T{T}_Hq{Hq}_Hkv{Hkv}_D{D}",
        causal=causal, dtype=str(dtype).split(".")[-1],
        max_abs_err=f"{err:.3e}", scaled_err=f"{scaled:.3e}", **extra,
        within_tol=ok, ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}",
        bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
        of_bound=f"{bound_ms / ms:.3f}",
        **{f"planted_{k}_scaled_err": f"{x:.3e}"
           for k, x in planted.items()})
    if not ok:
        raise AssertionError(f"K6 differs from its twin at {label}: "
                             f"max abs err {err}, scaled {scaled}")
    missed = [k for k, x in planted.items() if not x > K6_BF16_TOL]
    if missed or len(planted) != len(faults):
        raise AssertionError(f"the K6 check cannot see the planted "
                             f"faults {missed}: {planted}")
    del q, k, v, kr, vr, qt, kt, vt, mask
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def check_k6(dev) -> dict:
    """Phase 7: K6 against its twin (``k6_case``; two planted faults at
    the serving shape); then the kernel alone at prefill_32k's sequence
    length.  Returns the serving shape's row."""
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [  # (label, B, S, T, Hq, Hkv, D, causal, dtype)
        ("serving_prefill", LM_BATCH, LM_PROMPT, LM_PROMPT, 15, 5, 64, True,
         torch.bfloat16),
        ("noncausal_f32_d128", 1, 2048, 2048, 8, 2, 128, False,
         torch.float32),
        ("ragged_4097", 1, LM_PROMPT + 1, LM_PROMPT + 1, 15, 5, 64, True,
         torch.bfloat16),
        ("causal_d128", 1, 4096, 4096, 8, 2, 128, True, torch.bfloat16),
        ("moe_prefill", LM_BATCH, LM_PROMPT, LM_PROMPT, 16, 16, 128, True,
         torch.bfloat16),
        ("causal_d32", 2, 2048, 2048, 6, 2, 32, True, torch.bfloat16),
        ("suffix_1000_of_4097", 1, 1000, LM_PROMPT + 1, 15, 5, 64, True,
         torch.bfloat16),
        # flash_f32_kernel<16>: main_lm's prefill of the reduced
        # Granite-20B (8:1) and Qwen3-MoE (8:2) configs, then a long one
        *((f"main_lm_{name}_f32_d16", *MAIN_LM_SHAPE, 8, kv, 16, True,
           torch.float32) for name, kv in (("granite", 1), ("qwen3", 2))),
        ("long_f32_d16", LM_BATCH, LM_PROMPT, LM_PROMPT, 8, 2, 16, True,
         torch.float32),
    ]
    config = build.function("flash_attention", "fa_bf16_config",
                            (ctypes.c_int, ctypes.POINTER(ctypes.c_int)))
    for D in fa.HEAD_DIMS[torch.bfloat16]:
        got = (ctypes.c_int * 4)()
        if config(D, got) != 0:
            raise AssertionError(f"fa_bf16_config({D}) failed")
        say("k6", config=f"bf16_D{D}", stages=got[0], block_rows=got[1],
            block_keys=got[2], dynamic_smem_bytes=got[3])
    row = None
    for case in cases:
        faults = (("dropped_tile", "wrong_heads")
                  if case[0] == "serving_prefill" else ())
        got = k6_case(gen, dev, *case, faults=faults)
        if case[0] == "serving_prefill":
            row = got
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
    """``params`` with every tensor moved or cast by ``.to(where)`` (a MoE
    layer's ``moe`` sub-dict included)."""
    return tree_map(lambda t: t.to(where), params)


def check_lm_parity(dev, arch: str = "smollm-360m",
                    phase: str = "lm-parity") -> None:
    """Phase 8 (and 12 (a) for the MoE arch): the reduced config in f32,
    one set of seeded weights on ``dev`` and on the CPU: prefill logits
    within 2e-5, greedy ids equal."""
    cfg = get_config(arch, reduced=True).model
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
    say(phase, config=cfg.name, dtype="float32", batch=2, prompt=64,
        gen=8, head_dim=cfg.head_dim, logits_max_abs_err=f"{err:.3e}",
        logits_allclose=ok, greedy_ids_equal=same)
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
        elif any(w in name for w in GEMM_WORDS):
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


def serve_both_modes(cfg, params, prompts, dev, programs, smi: str,
                     phase: str = "lm-serve"):
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
        say(phase, mode=mode, calls=len(results),
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

    def one_more_ring(mate_sh, batch=1, mesh=None):
        dist, reach = rank(mate_sh, batch, mesh)
        p3._ring(dist, 0, batch, mesh)
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


def _trees_close(got, want, rtol: float, atol: float):
    """(every leaf ``allclose``, the largest |got − want|) over two trees
    of tensors, compared on the CPU in f32."""
    ok, err = True, 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        a, b = a.detach().cpu().float(), b.detach().cpu().float()
        err = max(err, float((a - b).abs().max()))
        ok = ok and torch.allclose(a, b, rtol=rtol, atol=atol)
    return ok, err


def unscaled_attention(q, k, v, q_block=1024, causal=True):
    """A planted fault: ``chunked_gqa_attention`` without its 1/√D."""
    return chunked_gqa_attention(q * math.sqrt(q.shape[-1]), k, v,
                                 q_block=q_block, causal=causal)


def no_weight_decay(params, grads, state, lr, **kw):
    """A planted fault: ``adamw_update`` without its weight decay."""
    return adamw_update(params, grads, state, lr,
                        **{**kw, "weight_decay": 0.0})


def _warm_adamw(params, seed: int = 7) -> AdamWState:
    """AdamW at step 1000 with moments drawn from ``seed``, on the CPU (as
    ``seeded_state`` in tests/test_torch_train.py): the schedule's lr is
    1.5e-4 there, so one step moves every weight, and seeded moments make
    the update a smooth function of the gradient."""
    rng = np.random.default_rng(seed)
    m = tree_map(lambda p: torch.from_numpy(
        (rng.normal(size=tuple(p.shape)) * 1e-3).astype(np.float32)), params)
    v = tree_map(lambda p: torch.from_numpy(
        (rng.uniform(0.5, 1.5, size=tuple(p.shape)) * 1e-6)
        .astype(np.float32)), params)
    return AdamWState(torch.tensor(1000, dtype=torch.int32), m, v)


def _warm_step(cell, params, batch, dev):
    """One ``cell.fn`` step on ``dev`` from copies of ``params`` and of the
    warm AdamW state: (loss, the state after, each weight's update)."""
    warm = _warm_adamw(params)
    p = _to(params, dev) if dev.type != "cpu" else \
        tree_map(torch.clone, params)
    opt = AdamWState(warm.step.to(dev), _to(warm.m, dev), _to(warm.v, dev))
    p, opt, loss = cell.fn(p, opt, tree_map(lambda x: x.to(dev), batch))
    return loss, opt, [a.cpu() - b for a, b in zip(tree_leaves(p),
                                                   tree_leaves(params))]


def check_train_parity(dev) -> None:
    """Phase 11 (a): the reduced config in f32 with ``remat`` and
    ``q_block`` 16 at seq 64 (each layer checkpointed, attention in four
    checkpointed blocks), one set of seeded weights on ``dev`` and on the
    CPU: loss and every gradient, then one ``build_cell`` train step's
    moments from a fresh state (lr 0: the weights keep every bit) and one
    from a warm state (lr 1.5e-4: loss, moments, step and every weight's
    update); and the two planted faults."""
    small = get_config("smollm-360m", reduced=True)
    cfg = dataclasses.replace(small.model, remat=True, q_block=16)
    arch = dataclasses.replace(small, model=cfg, shapes={
        "train": ShapeCell("train", "train", batch=2, seq_len=64)})
    params = tr.init_lm_params(torch.Generator().manual_seed(0), cfg)
    on_card = _to(params, dev)
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticLM(cfg.vocab, 64, 2).batch_at(0).items()}
    card_batch = {k: v.to(dev) for k, v in batch.items()}
    args = (batch["tokens"], batch["labels"])
    card_args = (card_batch["tokens"], card_batch["labels"])
    want = steps.lm_value_and_grad(params, cfg, *args)
    got = steps.lm_value_and_grad(on_card, cfg, *card_args)
    ok_grad, err_grad = _trees_close(got, want, TRAIN_RTOL, TRAIN_ATOL)
    with mock.patch.object(tr, "chunked_gqa_attention", unscaled_attention):
        fault = steps.lm_value_and_grad(on_card, cfg, *card_args)
    fault_ok, fault_err = _trees_close(fault, want, TRAIN_RTOL, TRAIN_ATOL)

    cell = steps.build_cell(arch, "train")
    _, opt, loss = cell.fn(params, init_adamw(params), batch)
    _, card_opt, card_loss = cell.fn(on_card, init_adamw(on_card),
                                     card_batch)
    ok_step, err_step = _trees_close((card_loss, card_opt.m, card_opt.v),
                                     (loss, opt.m, opt.v), TRAIN_RTOL,
                                     TRAIN_ATOL)
    # the schedule's lr is 0 at step 0: the parameters keep every bit
    same_params = all(torch.equal(a.cpu(), b) for a, b in
                      zip(tree_leaves(on_card), tree_leaves(params)))

    cpu_dev = torch.device("cpu")
    w_loss, w_opt, w_upd = _warm_step(cell, params, batch, cpu_dev)
    c_loss, c_opt, c_upd = _warm_step(cell, params, batch, dev)
    want_warm = (w_loss, w_opt.step, w_opt.m, w_opt.v)
    ok_warm, err_warm = _trees_close((c_loss, c_opt.step, c_opt.m, c_opt.v),
                                     want_warm, TRAIN_RTOL, TRAIN_ATOL)
    ok_upd, err_upd = _trees_close(c_upd, w_upd, TRAIN_RTOL, UPDATE_ATOL)
    moved = min(float(u.abs().max()) for u in w_upd)
    with mock.patch.object(steps, "adamw_update", no_weight_decay):
        _, _, f_upd = _warm_step(cell, params, batch, dev)
    wd_ok, wd_err = _trees_close(f_upd, w_upd, TRAIN_RTOL, UPDATE_ATOL)
    say("train", check="parity", config=cfg.name, dtype="float32", batch=2,
        seq=64, q_block=16, remat=True, loss_cpu=f"{float(want[0]):.6f}",
        loss_cuda=f"{float(got[0]):.6f}",
        loss_and_grads_max_abs_err=f"{err_grad:.3e}",
        loss_and_grads_allclose=ok_grad,
        step_moments_max_abs_err=f"{err_step:.3e}", step_allclose=ok_step,
        params_unchanged_at_lr_0=same_params,
        warm_from_step=1000, warm_state_max_abs_err=f"{err_warm:.3e}",
        warm_state_allclose=ok_warm,
        warm_update_max_abs_err=f"{err_upd:.3e}",
        warm_update_allclose=ok_upd,
        warm_least_weight_move=f"{moved:.3e}",
        planted_unscaled_attention_max_abs_err=f"{fault_err:.3e}",
        planted_fault_seen=not fault_ok,
        planted_no_weight_decay_max_abs_err=f"{wd_err:.3e}",
        planted_no_weight_decay_seen=not wd_ok,
        rtol=TRAIN_RTOL, atol=TRAIN_ATOL, update_atol=UPDATE_ATOL)
    if not (ok_grad and ok_step and same_params and ok_warm and ok_upd):
        raise AssertionError("a train step differs between cuda and cpu")
    if moved <= TRAIN_ATOL:
        raise AssertionError(f"a warm step moved a weight tensor by at most "
                             f"{moved:.3e}, within the atol")
    if fault_ok:
        raise AssertionError("the parity check cannot see attention "
                             "without its 1/sqrt(D)")
    if wd_ok:
        raise AssertionError("the parity check cannot see an update "
                             "without its weight decay")


def _bitwise_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and np.array_equal(a[k].reshape(-1).view(np.uint8),
                           b[k].reshape(-1).view(np.uint8)) for k in a)


def train_entry(smi: str) -> None:
    """Phase 11 (b): ``launch.train.main`` at full width with one injected
    failure.  Wraps the checkpoint manager (the snapshot, the write and
    the restore timed; the restored state held byte for byte against the
    snapshot of its step), the restart loop (its restarts) and the
    straggler monitor (each step's seconds)."""
    tmp = tempfile.mkdtemp(prefix="repro-torch-train-")
    snap, saves, writes, restores, runs, seen = {}, [], [], [], [], []
    flatten = ckpt_mod._flatten_with_paths
    save, write = ckpt_mod.CheckpointManager.save, \
        ckpt_mod.CheckpointManager._write
    restore, observe = ckpt_mod.CheckpointManager.restore, \
        StragglerMonitor.observe
    run = train.run_with_restarts

    def timed_save(mgr, step, tree, blocking=False, extra=None):
        t = time.perf_counter()
        flat = flatten(tree)
        snap_s = time.perf_counter() - t
        snap.clear()
        snap.update(step=step, flat=flat)
        with mock.patch.object(ckpt_mod, "_flatten_with_paths",
                               lambda _: flat):
            out = save(mgr, step, tree, blocking, extra)
        saves.append((step, sum(a.nbytes for a in flat.values()), snap_s,
                       time.perf_counter() - t))
        return out

    def timed_write(mgr, step, flat, meta):
        t = time.perf_counter()
        write(mgr, step, flat, meta)
        writes.append((step, time.perf_counter() - t))

    def timed_restore(mgr, tree_like, step=None, device=None):
        t = time.perf_counter()
        tree, got = restore(mgr, tree_like, step, device)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        back = flatten(tree)
        restores.append((got, sum(a.nbytes for a in back.values()), secs,
                         got == snap["step"]
                         and _bitwise_equal(back, snap["flat"])))
        return tree, got

    def kept_run(*args, **kw):
        out = run(*args, **kw)
        runs.append(out)
        return out

    def seen_observe(mon, step, seconds):
        seen.append((mon, step, seconds))
        return observe(mon, step, seconds)

    argv = ["--full", "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--steps", str(TRAIN_STEPS), "--ckpt-every", str(TRAIN_EVERY),
            "--fail-at", str(TRAIN_FAIL), "--ckpt-dir", tmp,
            "--log-every", "10"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    try:
        with mock.patch.object(ckpt_mod.CheckpointManager, "save",
                               timed_save), \
                mock.patch.object(ckpt_mod.CheckpointManager, "_write",
                                  timed_write), \
                mock.patch.object(ckpt_mod.CheckpointManager, "restore",
                                  timed_restore), \
                mock.patch.object(train, "run_with_restarts", kept_run), \
                mock.patch.object(StragglerMonitor, "observe",
                                  seen_observe):
            losses = train.main(argv)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    wall_s = time.perf_counter() - t0
    counts = read_counts()
    mon = seen[-1][0]
    step_s = statistics.median(s for _, _, s in seen)
    resumed = TRAIN_FAIL // TRAIN_EVERY * TRAIN_EVERY
    replayed = losses[TRAIN_FAIL] == losses[resumed]
    restarts = runs[0][2]
    say("train", check="entry", config="smollm-360m", params=409_007_040,
        dtype="bfloat16", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        steps=TRAIN_STEPS, ckpt_every=TRAIN_EVERY, fail_at=TRAIN_FAIL,
        steps_run=len(losses), restarts=restarts,
        stragglers_flagged=mon.stats.flagged,
        straggler_steps="'" + ",".join(map(str, mon.stats.events)) + "'",
        loss_first=f"{losses[0]:.4f}", loss_min=f"{min(losses):.4f}",
        loss_last=f"{losses[-1]:.4f}",
        loss_at_resume=f"{losses[resumed]:.6f}",
        loss_replayed=f"{losses[TRAIN_FAIL]:.6f}", replay_equal=replayed,
        step_s_median=f"{step_s:.4f}",
        step_s_min_max=f"{min(s for *_, s in seen):.4f}/"
                       f"{max(s for *_, s in seen):.4f}",
        tokens_per_s=f"{TRAIN_BATCH * TRAIN_SEQ / step_s:.1f}",
        peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
        reserved_gib=f"{torch.cuda.max_memory_reserved() / 2**30:.3f}",
        wall_s=f"{wall_s:.2f}",
        launches=json.dumps(counts, separators=(",", ":")),
        smi=f"'{smi}'")
    # save_s: the snapshot, the wait for the previous write and the
    # thread's start, all of which hold the training loop
    for (step, nbytes, snap_s, save_s), (wstep, write_s) in zip(saves,
                                                               writes):
        say("train", check="save", step=step, bytes=nbytes,
            snapshot_s=f"{snap_s:.3f}", save_s=f"{save_s:.3f}",
            write_s=f"{write_s:.3f}", write_step=wstep, smi=f"'{smi}'")
    for step, nbytes, secs, same in restores:
        say("train", check="restore", step=step, bytes=nbytes,
            seconds=f"{secs:.3f}", byte_equal=same, smi=f"'{smi}'")
    losses_fell = losses[-1] < losses[0]
    if not (restarts == 1 and len(restores) == 1 and restores[0][3]
            and replayed and losses_fell and not any(counts.values())
            and len(losses) == TRAIN_STEPS + TRAIN_FAIL - resumed):
        raise AssertionError(
            f"the trainer ran {len(losses)} steps with {restarts} restarts, "
            f"restores {restores}, replayed loss {losses[TRAIN_FAIL]} vs "
            f"{losses[resumed]}, loss {losses[0]} → {losses[-1]}, "
            f"launches {counts}")


def _train_family(ev, score_numel: int, vocab: int):
    """The family of the kernels a profiled op launched, from the op and
    its callers: the optimizer (inside ``adamw_update``), attention (the
    attention block's Python frame, or an input the size of a block's
    scores), cross-entropy (``_xent_block``'s frame, or a [rows, vocab]
    input); ``None`` for the rest."""
    names, shapes = [], []
    while ev is not None:           # Python frames are callers here too
        names += [ev.name, *(ev.stack or [])]
        shapes += [s for s in (ev.input_shapes or [])
                   if s and all(isinstance(d, int) for d in s)]
        ev = ev.cpu_parent
    if "adamw_update" in names:
        return "optimizer"
    if any("layers.py" in f and f.endswith(": block") for f in names) or \
            any(len(s) >= 3 and math.prod(s) >= score_numel for s in shapes):
        return "attention"
    if any(f.endswith(": _xent_block") for f in names) or \
            any(len(s) == 2 and s[-1] == vocab for s in shapes):
        return "cross_entropy"
    return None


def _device_kernels(prof) -> tuple:
    """The device events of a profile, each once, as (name, start ns, end
    ns, the operator that launched it or ``None``); the milliseconds the
    per-op kernel lists (``FunctionEvent.kernels``) add up to; those
    that CPU records other than the launching operator list again, by
    record name; and the milliseconds of the device-side annotations.
    The lists count some device time twice: the profiler gives each CPU
    record whose correlation id matches a kernel's link that kernel, and
    an operator can share its id with a runtime or CUPTI record (such as
    ``Command Buffer Full``).  So the device events are read from the
    profiler's own records, annotations apart, each once by correlation
    id, name and time, and linked to one record of their id, an operator
    (a ``::`` name) before any other."""
    from torch.autograd import DeviceType

    launcher, listed_ms, holders = {}, 0.0, []
    for ev in prof.events():
        if ev.device_type == DeviceType.CPU and ev.kernels \
                and not ev.is_user_annotation:
            listed_ms += sum(k.duration for k in ev.kernels) / 1e3
            holders.append(ev)
            held = launcher.get(ev.id)
            if held is None or ("::" in ev.name and "::" not in held.name):
                launcher[ev.id] = ev
    relisted = {}
    for ev in holders:
        if launcher[ev.id] is not ev:
            relisted[ev.name] = relisted.get(ev.name, 0.0) + sum(
                k.duration for k in ev.kernels) / 1e3
    seen, out, annotation_ms = set(), [], 0.0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        if e.is_user_annotation():
            annotation_ms += e.duration_ns() / 1e6
            continue
        key = (e.correlation_id(), e.name(), e.start_ns(), e.end_ns())
        if key not in seen:
            seen.add(key)
            out.append((e.name(), e.start_ns(), e.end_ns(),
                        launcher.get(e.linked_correlation_id())))
    return out, listed_ms, relisted, annotation_ms


def _profiled_step(fn, **kw):
    """One call of ``fn`` under torch.profiler (CPU and CUDA, shapes
    recorded, ``kw`` passed on), ``adamw_update`` inside a range of its
    name: (the profile, the call's wall milliseconds)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    update = steps.adamw_update

    def ranged(*args, **kw):
        with record_function("adamw_update"):
            return update(*args, **kw)

    torch.cuda.synchronize()
    with mock.patch.object(steps, "adamw_update", ranged), \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                    record_shapes=True, **kw) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    return prof, wall_ms


def _train_profile(fn, score_numel: int, vocab: int, top: int = 8) -> dict:
    """One train step under torch.profiler: wall and busy milliseconds
    (each device event counted once; the busy time may not exceed the
    wall), the idle share, the kernels launched, and the busy time by
    family (attention passes and, within them, their matrix products;
    the other matrix products; cross-entropy; the optimizer; the rest)."""
    prof, wall_ms = _profiled_step(fn, with_stack=True)
    split = dict.fromkeys(("attention_ms", "attention_matmul_ms",
                           "matmul_ms", "cross_entropy_ms", "optimizer_ms",
                           "other_ms"), 0.0)
    kernels, listed_ms, relisted, annotation_ms = _device_kernels(prof)
    by_name = {}
    for name, t0, t1, op in kernels:
        family = None if op is None else _train_family(op, score_numel,
                                                       vocab)
        ms = (t1 - t0) / 1e6
        by_name[name] = by_name.get(name, 0.0) + ms
        gemm = any(w in name.lower() for w in GEMM_WORDS)
        if family is None:
            split["matmul_ms" if gemm else "other_ms"] += ms
        else:
            split[family + "_ms"] += ms
            if family == "attention" and gemm:
                split["attention_matmul_ms"] += ms
    busy_ms = sum(v for k, v in split.items() if k != "attention_matmul_ms")
    union_ns, end = 0, 0
    for t0, t1 in sorted((t0, t1) for _, t0, t1, _ in kernels):
        union_ns += max(0, t1 - max(t0, end))
        end = max(end, t1)
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"[train-profile] kernel {ms:10.3f} ms {name[:90]}", flush=True)
    for name, ms in sorted(relisted.items(), key=lambda kv: -kv[1])[:4]:
        print(f"[train-profile] relisted {ms:10.3f} ms by {name[:60]}",
              flush=True)
    out = {"wall_ms": wall_ms, "busy_ms": busy_ms,
           "idle_share": 1 - busy_ms / wall_ms, "kernels": len(kernels),
           **split, "overlap_ms": busy_ms - union_ns / 1e6,
           "per_op_lists_ms": listed_ms,
           "relisted_ms": sum(relisted.values()),
           "annotation_ms": annotation_ms,
           "unlinked_ms": sum(t1 - t0 for _, t0, t1, op in kernels
                              if op is None) / 1e6}
    if busy_ms > wall_ms:
        raise AssertionError(f"the profile counts {busy_ms:.3f} ms of device "
                             f"time in a {wall_ms:.3f} ms step: {out}")
    return out


def train_throughput(dev, smi: str) -> None:
    """Phase 11 (c): the ``build_cell`` train step at train_4k's sequence
    (4,096) with the batch cut to 8: two warm-up steps, five timed (host
    clock to a synchronised loss), then one profiled."""
    arch = get_config("smollm-360m")
    shape = dataclasses.replace(arch.shapes["train_4k"],
                                batch=THROUGHPUT_BATCH)
    arch = dataclasses.replace(arch, shapes={shape.name: shape})
    cfg = arch.model
    cell = steps.build_cell(arch, shape.name)
    params = tr.init_lm_params(torch.Generator(device=dev).manual_seed(0),
                               cfg)
    opt = init_adamw(params)
    data = SyntheticLM(cfg.vocab, shape.seq_len, shape.batch)
    n = THROUGHPUT_WARMUP + THROUGHPUT_STEPS
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in data.batch_at(i).items()} for i in range(n + 1)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, losses = [], []
    for i in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, opt, loss = cell.fn(params, opt, batches[i])
        losses.append(float(loss))
        times.append(time.perf_counter() - t)
    counts = read_counts()
    step_s = statistics.median(times[THROUGHPUT_WARMUP:])
    tokens = shape.batch * shape.seq_len
    peak = torch.cuda.max_memory_allocated()
    q_block = auto_q_block(shape.batch, cfg.n_heads, shape.seq_len,
                           cfg.q_block)
    split = _train_profile(
        lambda: cell.fn(params, opt, batches[n]),
        shape.batch * cfg.n_heads * min(q_block, shape.seq_len)
        * shape.seq_len, cfg.vocab)
    say("train", check="throughput", config=cfg.name, batch=shape.batch,
        seq=shape.seq_len, q_block=q_block, remat=cfg.remat,
        step_ms_median=f"{step_s * 1e3:.1f}",
        step_ms_timed="'" + ",".join(f"{x * 1e3:.1f}" for x in
                                     times[THROUGHPUT_WARMUP:]) + "'",
        step_ms_warmup="'" + ",".join(f"{x * 1e3:.1f}" for x in
                                      times[:THROUGHPUT_WARMUP]) + "'",
        tokens_per_s=f"{tokens / step_s:.1f}",
        model_flops=f"{cell.model_flops:.4e}",
        model_tflop_s=f"{cell.model_flops / step_s / 1e12:.2f}",
        bf16_peak_share=f"{cell.model_flops / step_s / PEAK_FLOPS[torch.bfloat16]:.4f}",
        loss_first_last=f"{losses[0]:.4f}/{losses[-1]:.4f}",
        peak_gib=f"{peak / 2**30:.3f}",
        reserved_gib=f"{torch.cuda.max_memory_reserved() / 2**30:.3f}",
        launches=json.dumps(counts, separators=(",", ":")),
        smi=f"'{smi}'")
    say("train-profile", step="train", batch=shape.batch, seq=shape.seq_len,
        **_fmt(split))
    if any(counts.values()) or not all(map(math.isfinite, losses)):
        raise AssertionError(f"training launched {counts}, losses {losses}")
    del params, opt, batches
    torch.cuda.empty_cache()


def check_train(dev, smi: str) -> None:
    """Phase 11 (module docstring)."""
    t0 = time.perf_counter()
    reset_counts()
    check_train_parity(dev)
    train_entry(smi)
    train_throughput(dev, smi)
    say("train", seconds=f"{time.perf_counter() - t0:.3f}")


# ------------------------------------------------------------ phase 12 --

def moe_drops(params, x, cfg) -> tuple:
    """(dropped (token, k) pairs, all pairs, the capacity C) of one MoE
    FFN's routing of x [T, D], as ``moe_ffn`` routes it."""
    T, D = x.shape
    G, Tg, C = moe.group_capacity(T, cfg)
    idx = moe.route(params["router"], x.reshape(G, Tg, D), cfg)[2]
    keep = moe.dispatch(idx, C, cfg.n_experts)[2]
    return int((~keep).sum()), keep.numel(), C


def check_moe_layer(dev) -> None:
    """Phase 12 (b): one MoE FFN at full width against the dense oracle,
    two planted faults, and the drop share at the prefill's routing."""
    cfg = get_config(MOE_ARCH).model
    mcfg = cfg.moe._replace(capacity_factor=MOE_LAYER_CF)
    gen = torch.Generator(device=dev).manual_seed(1)
    params = moe.init_moe_params(gen, cfg.d_model, mcfg, cfg.dtype)
    x = torch.randn(MOE_LAYER_TOKENS, cfg.d_model, generator=gen,
                    device=dev).to(cfg.dtype)
    dropped, pairs, C = moe_drops(params, x, mcfg)
    want = moe.moe_ffn_reference(params, x, mcfg)
    err = scaled_err(moe.moe_ffn(params, x, mcfg)[0], want)
    dispatch, combine = moe.dispatch, moe.combine

    def shifted_slot(expert_idx, C, E):
        order, st, keep, slot = dispatch(expert_idx, C, E)
        return order, st, keep, torch.where(keep, (slot + C) % (E * C), slot)

    def ungated_combine(y, order, keep, slot, gates, dtype):
        return combine(y, order, keep, slot, torch.ones_like(gates), dtype)

    faults = {}
    for name, fn in (("combine", ungated_combine),
                     ("dispatch", shifted_slot)):
        with mock.patch.object(moe, name, fn):
            faults[fn.__name__] = scaled_err(moe.moe_ffn(params, x, mcfg)[0],
                                             want)
    # the prefill's routing at the serving shape, the default capacity
    big = torch.randn(LM_BATCH * LM_PROMPT, cfg.d_model, generator=gen,
                      device=dev).to(cfg.dtype)
    big_dropped, big_pairs, big_C = moe_drops(params, big, cfg.moe)
    G = moe.group_capacity(big.shape[0], cfg.moe)[0]
    say("moe-slice", check="moe_layer", d_model=cfg.d_model,
        experts=mcfg.n_experts, top_k=mcfg.top_k, d_expert=mcfg.d_expert,
        shared=mcfg.n_shared, dtype="bfloat16", tokens=MOE_LAYER_TOKENS,
        capacity_factor=mcfg.capacity_factor, capacity=C,
        dropped_pairs=dropped, scaled_err=f"{err:.3e}",
        tol=MOE_BF16_TOL, within_tol=err <= MOE_BF16_TOL,
        **{f"planted_{k}_scaled_err": f"{v:.3e}" for k, v in faults.items()},
        prefill_tokens=big.shape[0], prefill_groups=G,
        prefill_capacity=big_C,
        prefill_capacity_factor=cfg.moe.capacity_factor,
        prefill_dropped_pairs=f"{big_dropped}/{big_pairs}",
        prefill_drop_share=f"{big_dropped / big_pairs:.4f}")
    if dropped or not err <= MOE_BF16_TOL:
        raise AssertionError(f"moe_ffn differs from moe_ffn_reference: "
                             f"scaled err {err}, {dropped} pairs dropped")
    missed = [k for k, v in faults.items() if not v > MOE_BF16_TOL]
    if missed:
        raise AssertionError(f"the MoE check cannot see the planted faults "
                             f"{missed}: {faults}")
    del params, x, big, want
    torch.cuda.empty_cache()


def _profiled_kernels(fn) -> tuple:
    """One call of ``fn`` under torch.profiler: its wall milliseconds and
    its device events in start order (``_device_kernels``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    return wall_ms, sorted(_device_kernels(prof)[0], key=lambda k: k[1])


@contextlib.contextmanager
def moe_ranges():
    """Each function of ``MOE_FAMILIES`` run inside a ``record_function``
    range named ``moe:<family>`` (``moe_ffn`` also where the transformer
    calls it), so that a kernel's family is the innermost such range
    around the op that launched it."""
    from torch.profiler import record_function

    def ranged(fn, family):
        def inner(*args, **kw):
            with record_function(f"moe:{family}"):
                return fn(*args, **kw)
        return inner

    with contextlib.ExitStack() as stack:
        for name, family in MOE_FAMILIES.items():
            stack.enter_context(mock.patch.object(
                moe, name, ranged(getattr(moe, name), family)))
        stack.enter_context(mock.patch.object(tr, "moe_ffn", moe.moe_ffn))
        yield


def _moe_family(name: str, op) -> str:
    """K6 by its kernel's name; else the innermost ``moe:`` range around
    the op that launched it (``moe_ranges``); else ``other``."""
    if "flash_bf16_kernel" in name or "flash_f32_kernel" in name:
        return "flash_attention"
    while op is not None:
        if op.name.startswith("moe:"):
            return op.name[4:]
        op = op.cpu_parent
    return "other"


MOE_SPLIT = ("routed_expert", "shared_expert", "dispatch_combine", "router",
             "flash_attention", "other")


def _split_line(step, mode, wall_ms, kernels, families, **fields) -> dict:
    split = {f"{f}_ms": 0.0 for f in MOE_SPLIT}
    for (_, t0, t1, _), family in zip(kernels, families):
        split[f"{family}_ms"] += (t1 - t0) / 1e6
    busy = sum(split.values())
    say("moe-profile", step=step, mode=mode, batch=LM_BATCH,
        wall_ms=f"{wall_ms:.3f}", busy_ms=f"{busy:.3f}",
        idle_share=f"{max(0.0, 1 - busy / wall_ms):.3f}",
        kernels=len(kernels), **fields,
        **{k: f"{v:.3f}" for k, v in split.items()})
    return split


def align_kernels(a: list, b: list) -> list:
    """For each kernel name of ``b``, the index of the name of ``a``
    aligned with it by a least-edit alignment (a substitution or a
    kernel in one list only costs 1), searched in a band around the
    diagonal as wide as the lengths differ plus 16; ``None`` where ``b``
    has a kernel that ``a`` lacks."""
    n, m = len(a), len(b)
    w = abs(n - m) + 16
    cost, move = {(0, 0): 0}, {}
    for i in range(n + 1):
        c = i * m // max(n, 1)
        for j in range(max(0, c - w), min(m, c + w) + 1):
            options = []
            if i and j and (i - 1, j - 1) in cost:
                options.append((cost[i - 1, j - 1] + (a[i - 1] != b[j - 1]),
                                0, 1, 1))
            if i and (i - 1, j) in cost:
                options.append((cost[i - 1, j] + 1, 1, 1, 0))
            if j and (i, j - 1) in cost:
                options.append((cost[i, j - 1] + 1, 2, 0, 1))
            if options:
                cost[i, j], _, di, dj = min(options)
                move[i, j] = (di, dj)
    out = [None] * m
    i, j = n, m
    while (i or j) and (i, j) in move:
        di, dj = move[i, j]
        if di and dj:
            out[j - 1] = i - 1
        i, j = i - di, j - dj
    return out


def moe_profile(step: str, eager_fn, replay_fn) -> None:
    """Phase 12 (e): one eager run of a program's body under the profiler
    (in ``moe_ranges``), each kernel's family from its op; then one
    replay of the program, whose kernels carry no op: each takes the
    family of the eager kernel aligned with it in start order
    (``align_kernels``: the graph holds the body's launches in their
    order, but cuBLAS may pick other products under capture and the two
    traces can differ by a few events), else the family its name has
    most in the eager run."""
    with moe_ranges():
        wall, eager = _profiled_kernels(eager_fn)
    families = [_moe_family(name, op) for name, _, _, op in eager]
    _split_line(step, "eager", wall, eager, families)
    top = {}
    for (name, t0, t1, op), family in zip(eager, families):
        key = (family, op.name if op is not None else "-", name)
        top[key] = top.get(key, 0.0) + (t1 - t0) / 1e6
    for (family, op, name), ms in sorted(top.items(),
                                         key=lambda kv: -kv[1])[:8]:
        print(f"[moe-profile] eager {ms:9.3f} ms {family:16s} {op[:24]:24s} "
              f"{name[:60]}", flush=True)
    wall, replay = _profiled_kernels(replay_fn)
    at = align_kernels([k[0] for k in eager], [k[0] for k in replay])
    by_name = {}
    for (name, t0, t1, _), family in zip(eager, families):
        ms = by_name.setdefault(name, {})
        ms[family] = ms.get(family, 0) + t1 - t0
    replay_families = [
        families[i] if i is not None else
        max(by_name[name], key=by_name[name].get) if name in by_name
        else "other" for (name, *_), i in zip(replay, at)]
    _split_line(step, "replay", wall, replay, replay_families,
                aligned=f"{sum(i is not None for i in at)}/{len(replay)}",
                same_name=sum(i is not None and eager[i][0] == name
                              for (name, *_), i in zip(replay, at)))
    top = {}
    for (name, t0, t1, _), family in zip(replay, replay_families):
        key = (family, name)
        top[key] = top.get(key, 0.0) + (t1 - t0) / 1e6
    for (family, name), ms in sorted(top.items(), key=lambda kv: -kv[1])[:6]:
        print(f"[moe-profile] replay {ms:9.3f} ms {family:16s} {name[:70]}",
              flush=True)


def serve_full_width(dev, smi: str, cfg, phase: str, serve_phase: str,
                     **fields) -> tuple:
    """Phases 12 (c) and 16 (e): ``cfg`` at full width and depth, seeded
    weights drawn on the card (each matrix in f32 from a CUDA generator,
    then cast: no f32 copy of the model is ever held), served at phase
    9's shape.  Every counter is set to 0 before the first fused serve
    and read after and around each recording (K6 once a layer in the
    prefill graph, none in the decode graph, one capture); then three
    fused and three eager serves with the same ids, and the first three
    decode replays against eager ``decode_step``s.  ``fields`` go on the
    first line.  Returns (params, programs, the prompts on the card, the
    serve's launch counts with K6's the prefill graph's)."""
    t = time.perf_counter()
    params = tr.init_lm_params(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    weights = sum(p.numel() * p.element_size() for p in tree_leaves(params))
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT)).astype(np.int32)
    torch.cuda.reset_peak_memory_stats()
    programs, res, counts, rec_prefill, rec_decode = record_lm(
        cfg, params, prompts, dev)
    peak = torch.cuda.max_memory_allocated()
    cache = sum(x.numel() * x.element_size() for x in programs.cache[:2])
    say(phase, check="serve", config=cfg.name, layers=cfg.n_layers,
        d_model=cfg.d_model, heads=f"{cfg.n_heads}/{cfg.n_kv_heads}",
        head_dim=cfg.head_dim, **fields, params=cfg.param_count(),
        weights_gib=f"{weights / 2**30:.3f}",
        kv_cache_gib=f"{cache / 2**30:.3f}", dtype="bfloat16",
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
        recorded_decode=json.dumps(rec_decode, separators=(",", ":")),
        smi=f"'{smi}'")
    want_decode = {name: 0 for name in KERNELS}
    want_prefill = dict(want_decode, flash_attention=cfg.n_layers)
    want_serve = dict(want_decode, flash_attention=2 * cfg.n_layers)
    if (res.ids.shape != (LM_BATCH, LM_GEN) or res.captures != 1
            or rec_prefill != want_prefill or rec_decode != want_decode
            or counts != want_serve):
        raise AssertionError(
            f"{cfg.name} serving ran {res.ids.shape}, {res.captures} "
            f"captures, recorded {rec_prefill} / {rec_decode}, launches "
            f"{counts}; expected {want_prefill} / {want_decode}, "
            f"{want_serve}")

    serve_lm(cfg, prompts, 2, dev, params=params, fused=False)   # warm-up
    fused, eager = serve_both_modes(cfg, params, prompts, dev, programs, smi,
                                    phase=serve_phase)
    same_ids = all(np.array_equal(r.ids, eager[0].ids)
                   for r in (res, *fused, *eager))
    last = float((fused[0].logits.float() - eager[0].logits.float())
                 .abs().max())
    tokens = torch.from_numpy(prompts).to(dev)
    diffs, same_tokens = decode_replays_vs_eager(params, cfg, programs,
                                                 tokens)
    say(phase, check="fused_vs_eager", config=cfg.name, ids_equal=same_ids,
        last_logits_max_abs_diff=f"{last:.3e}",
        decode_replays_vs_eager_decode_step_max_abs_diff=
        "/".join(f"{d:.3e}" for d in diffs),
        decode_replay_tokens_equal=same_tokens)
    if not (same_ids and same_tokens):
        raise AssertionError(f"the fused {cfg.name} serve's ids differ from "
                             f"the eager loop's")
    return (params, programs, tokens,
            dict(counts, flash_attention=rec_prefill["flash_attention"]))


def check_moe_slice(dev, smi: str) -> dict:
    """Phase 12 (c) and (e): Qwen1.5-MoE-A2.7B at full width and depth
    served at phase 9's shape, fused and eager, then profiled.  Returns
    the launch counts of its path: K6's is the prefill graph's."""
    cfg = get_config(MOE_ARCH).model
    params, programs, tokens, counts = serve_full_width(
        dev, smi, cfg, "moe-slice", "moe-serve", experts=cfg.moe.n_experts,
        top_k=cfg.moe.top_k, shared=cfg.moe.n_shared,
        active_params=cfg.active_param_count())
    programs.load(tokens)
    moe_profile("prefill", programs._prefill_body, programs.prefill)
    moe_profile("decode", programs._decode_body, programs.decode)
    del programs, params
    torch.cuda.empty_cache()
    return counts


def greedy_logits(params, cfg, tokens, steps: int):
    """Prefill ``tokens`` [B, P], widen the cache by ``steps``, then
    ``steps`` greedy decode steps from the device's own tokens: each
    step's logits (f32, on the CPU) and the ids [B, steps + 1]."""
    P = tokens.shape[1]
    logits, part = tr.prefill_step(params, cfg, tokens)
    cache = tr.init_kv_cache(cfg, tokens.shape[0], P + steps,
                             device=tokens.device)
    cache.k[:, :, :P] = part.k
    cache.v[:, :, :P] = part.v
    cache = cache._replace(length=part.length)
    out, ids = [logits.float().cpu()], []
    for _ in range(steps):
        tok = torch.argmax(logits, -1).to(torch.int32)
        ids.append(tok.cpu())
        logits, cache = tr.decode_step(params, cfg, cache, tok)
        out.append(logits.float().cpu())
    ids.append(torch.argmax(logits, -1).to(torch.int32).cpu())
    return out, torch.stack(ids, 1)


def routed_greedy(params, cfg, tokens, steps: int) -> tuple:
    """``greedy_logits`` with each ``moe.route`` call's probabilities and
    experts logged on the CPU: (logits, ids, the log, seconds)."""
    route, log = moe.route, []

    def logged(router, xg, c):
        out = route(router, xg, c)
        log.append((out[0].detach().float().cpu(), out[2].cpu()))
        return out

    t = time.perf_counter()
    with mock.patch.object(moe, "route", logged):
        logits, ids = greedy_logits(params, cfg, tokens, steps)
    return logits, ids, log, time.perf_counter() - t


def routing_flips(card: list, cpu: list) -> list:
    """Each (token, k) choice that differs between two logs of
    ``moe.route`` calls (probs, experts): (call, token, the card's
    expert, the CPU's, their CPU probabilities, the gap, whether an
    earlier call differed already)."""
    flips, differed = [], False
    for call, ((_, e_card), (probs, e_cpu)) in enumerate(zip(card, cpu)):
        a = e_card.reshape(-1, e_card.shape[-1]).sort(-1).values
        b = e_cpu.reshape(-1, e_cpu.shape[-1]).sort(-1).values
        p = probs.reshape(-1, probs.shape[-1])
        rows = (a != b).any(-1).nonzero().flatten().tolist()
        for tok in rows:
            mine = sorted(set(a[tok].tolist()) - set(b[tok].tolist()))
            theirs = sorted(set(b[tok].tolist()) - set(a[tok].tolist()))
            for x, y in zip(mine, theirs):
                px, py = float(p[tok, x]), float(p[tok, y])
                flips.append((call, tok, x, y, px, py, abs(px - py),
                              differed))
        differed = differed or bool(rows)
    return flips


def check_moe_depth2(dev) -> None:
    """Phase 12 (d): full width, depth cut to 2 layers, f32, one set of
    seeded weights on the card and on the CPU: B 2, P 128 and 4 decode
    steps, every step's logits ``allclose`` at MOE_F32_TOL, the ids
    equal, and every routing choice that differs printed."""
    d2 = MOE_DEPTH2
    cfg = dataclasses.replace(get_config(MOE_ARCH).model,
                              n_layers=d2["layers"], dtype=torch.float32)
    params = tr.init_lm_params(torch.Generator(device=dev).manual_seed(2),
                               cfg)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (d2["batch"], d2["prompt"])).astype(np.int32))
    lc, ic, rc, sc = routed_greedy(params, cfg, tokens.to(dev), d2["steps"])
    params = _to(params, "cpu")
    torch.cuda.empty_cache()
    lp, ip, rp, sp = routed_greedy(params, cfg, tokens, d2["steps"])
    errs = [float((a - b).abs().max()) for a, b in zip(lc, lp)]
    ok = all(torch.allclose(a, b, rtol=MOE_F32_TOL, atol=MOE_F32_TOL)
             for a, b in zip(lc, lp))
    same = torch.equal(ic, ip)
    flips = routing_flips(rc, rp)
    for call, tok, x, y, px, py, gap, after in flips[:8]:
        say("moe-slice", check="routing_flip", call=call, token=tok,
            card_expert=x, cpu_expert=y, p_card_expert=f"{px:.9f}",
            p_cpu_expert=f"{py:.9f}", gap=f"{gap:.3e}",
            downstream_of_an_earlier_flip=after,
            rounding=gap < ROUTING_GAP)
    faults = [f for f in flips if not f[7] and f[6] >= ROUTING_GAP]
    say("moe-slice", check="card_vs_cpu_2_layers", dtype="float32",
        layers=cfg.n_layers, batch=d2["batch"], prompt=d2["prompt"],
        decode_steps=d2["steps"], route_calls=f"{len(rc)}/{len(rp)}",
        logits_max_abs_err="/".join(f"{e:.3e}" for e in errs),
        logits_allclose=ok, ids_equal=same, routing_flips=len(flips),
        routing_faults=len(faults), card_s=f"{sc:.3f}", cpu_s=f"{sp:.3f}")
    if not (ok and same and not faults and len(rc) == len(rp)):
        raise AssertionError("the 2-layer full-width MoE differs between "
                             "the card and the CPU")


def require_drained(phase: str, number: int) -> None:
    """Empty the allocator's cache and fail unless under 1 GiB is still
    allocated on the card: phase ``number`` starts on a drained card."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    allocated = torch.cuda.memory_allocated()
    say(phase, check="start", allocated_bytes=allocated,
        allocated_gib=f"{allocated / 2**30:.3f}")
    if allocated >= 2**30:
        raise AssertionError(f"phase {number} starts with {allocated} bytes "
                             f"allocated on the card")


def check_moe(dev, smi: str) -> dict:
    """Phase 12 (module docstring).  Returns the launch counts of the MoE
    serving path."""
    t0 = time.perf_counter()
    require_drained("moe-slice", 12)
    check_lm_parity(dev, MOE_ARCH, "moe-parity")
    check_moe_layer(dev)
    counts = check_moe_slice(dev, smi)
    check_moe_depth2(dev)
    say("moe-slice", seconds=f"{time.perf_counter() - t0:.3f}",
        launches=json.dumps(counts, separators=(",", ":")))
    return counts


# ------------------------------------------------------------ phase 13 --

def gnn_smoke_graph(cell: ShapeCell, seed: int) -> gnn.GraphBatch:
    """A seeded graph at ``cell``'s padded shape on the CPU: the last
    eighth of the nodes padding (zero features, masked), a tenth of the
    edges masked (half of them at the pad row N - 1), the last real node
    isolated and edges 4 and 5 one edge twice."""
    g_abs = steps._graph_abstract(cell, cell.d_feat)
    n, e = g_abs.node_feat.shape[0], g_abs.edge_src.shape[0]
    rng = np.random.default_rng(seed)
    n_real = n - n // 8
    feat = rng.normal(size=(n, cell.d_feat)).astype(np.float32)
    feat[n_real:] = 0
    src = rng.integers(0, n_real - 1, e).astype(np.int32)
    dst = rng.integers(0, n_real - 1, e).astype(np.int32)
    src[5], dst[5] = src[4], dst[4]
    mask = np.ones(e, bool)
    masked = rng.permutation(np.arange(6, e))[: e // 10]
    mask[masked] = False
    src[masked[::2]] = dst[masked[::2]] = n - 1
    labels = rng.integers(0, cell.n_classes, n).astype(np.int32)
    return gnn.GraphBatch(*map(torch.from_numpy, (
        feat, src, dst, mask, np.arange(n) < n_real, labels)))


def self_inclusive_max(data, seg_ids, num_segments):
    """A planted fault: ``gnn._segment_max`` reduced into a zero buffer
    that takes part (``include_self=True``)."""
    idx = seg_ids.long().view((-1,) + (1,) * (data.dim() - 1))
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.scatter_reduce(0, idx.expand_as(data), data, "amax",
                              include_self=True)


def _gnn_grads(params, cfg, g):
    """(logits, loss, gradients) of one GNN on one graph."""
    loss, grads = steps.gnn_value_and_grad(params, cfg, g)
    with torch.no_grad():
        logits = gnn.FORWARDS[cfg.kind](params, cfg, g)
    return logits, loss, grads


def check_gnn_parity(dev) -> None:
    """Phase 13 (a): each reduced GNN config in f32 at the reference
    smoke's two shapes, one set of seeded weights on ``dev`` and on the
    CPU: logits, loss and every gradient, then one ``build_cell`` step
    from a warm AdamW state (step 1000, seeded moments): loss and moments
    at GNN_TOL, every weight's update within GNN_UPDATE_ATOL; and, for
    PNA, the planted self-inclusive segment maximum."""
    cpu = torch.device("cpu")
    for arch_id in GNN_ARCHS:
        arch = dataclasses.replace(get_config(arch_id, reduced=True),
                                   shapes=GNN_SMOKE)
        for shape, cell_shape in GNN_SMOKE.items():
            cfg = dataclasses.replace(
                arch.model, n_classes=max(cell_shape.n_classes, 2))
            params = gnn.INITS[cfg.kind](torch.Generator().manual_seed(0),
                                         cfg)
            g = gnn_smoke_graph(cell_shape, seed=1)
            on_card = _to(params, dev)
            card_g = tree_map(lambda x: x.to(dev), g)
            want = _gnn_grads(params, cfg, g)
            ok_grad, err_grad = _trees_close(
                _gnn_grads(on_card, cfg, card_g), want, GNN_TOL, GNN_TOL)
            cell = steps.build_cell(arch, shape)
            w_loss, w_opt, w_upd = _warm_step(cell, params, g, cpu)
            c_loss, c_opt, c_upd = _warm_step(cell, params, g, dev)
            ok_state, err_state = _trees_close(
                (c_loss, c_opt.step, c_opt.m, c_opt.v),
                (w_loss, w_opt.step, w_opt.m, w_opt.v), GNN_TOL, GNN_TOL)
            ok_upd, err_upd = _trees_close(c_upd, w_upd, 0.0,
                                           GNN_UPDATE_ATOL)
            moved = min(float(u.abs().max()) for u in w_upd)
            fault = {}
            if cfg.kind == "pna":
                with mock.patch.object(gnn, "_segment_max",
                                       self_inclusive_max):
                    f_ok, f_err = _trees_close(
                        _gnn_grads(on_card, cfg, card_g), want, GNN_TOL,
                        GNN_TOL)
                    _, _, f_upd = _warm_step(cell, params, g, dev)
                fu_ok, fu_err = _trees_close(f_upd, w_upd, 0.0,
                                             GNN_UPDATE_ATOL)
                fault = dict(
                    planted_self_max_grads_max_abs_err=f"{f_err:.3e}",
                    planted_self_max_update_max_abs_err=f"{fu_err:.3e}",
                    planted_fault_seen=not (f_ok or fu_ok))
                if f_ok or fu_ok:
                    raise AssertionError(
                        "the GNN parity check cannot see a segment maximum "
                        "over a zero buffer that takes part")
            say("gnn", check="parity", arch=arch_id, shape=shape,
                nodes=g.node_feat.shape[0], edges=g.edge_src.shape[0],
                dtype="float32", loss_cpu=f"{float(want[1]):.6f}",
                grads_max_abs_err=f"{err_grad:.3e}", grads_allclose=ok_grad,
                warm_from_step=1000, warm_state_max_abs_err=f"{err_state:.3e}",
                warm_state_allclose=ok_state,
                warm_update_max_abs_err=f"{err_upd:.3e}",
                warm_update_within=ok_upd,
                warm_least_weight_move=f"{moved:.3e}", **fault,
                tol=GNN_TOL, update_atol=GNN_UPDATE_ATOL)
            if not (ok_grad and ok_state and ok_upd):
                raise AssertionError(f"{arch_id} at {shape} differs between "
                                     f"cuda and cpu")
            if moved <= GNN_UPDATE_ATOL:
                raise AssertionError(f"a warm step moved a weight tensor by "
                                     f"at most {moved:.3e}, within the atol")


def gnn_cell(arch_id: str, shape: str):
    """(the shape cell, the model config it trains, the ``build_cell``
    cell) of a full GNN arch: the config's d_in and classes replaced by
    the cell's where its features differ, as ``build_cell`` does."""
    arch = get_config(arch_id)
    cell_shape, cfg = arch.shapes[shape], arch.model
    if cell_shape.d_feat and cfg.d_in != cell_shape.d_feat:
        cfg = dataclasses.replace(cfg, d_in=cell_shape.d_feat,
                                  n_classes=max(cell_shape.n_classes, 2))
    return cell_shape, cfg, steps.build_cell(arch, shape)


def _median_ms(seconds: list) -> str:
    return f"{statistics.median(seconds) * 1e3:.3f}"


def _timed_step(cell, params, opt, g):
    """One train step, synchronised: (params, opt, loss, seconds)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    params, opt, loss = cell.fn(params, opt, g)
    torch.cuda.synchronize()
    return params, opt, loss, time.perf_counter() - t


def check_gnn_full(dev, smi: str) -> None:
    """Phase 13 (b): each GNN arch at full width on Cora's shape, on the
    reference example's planted-partition graph at Cora's size (2,708
    nodes, 10,556 edges, 1,433 features, 7 classes) padded as
    ``build_cell`` pads it: GNN_STEPS steps, the train accuracy over the
    real nodes above GNN_MIN_ACC."""
    example = ROOT / "examples" / "torch_gnn_fullbatch.py"
    planted = runpy.run_path(str(example))["planted_partition"]
    cora = gnn_cell(GNN_ARCHS[0], "full_graph_sm")[0]
    t = time.perf_counter()
    feat, src, dst, labels = planted(np.random.default_rng(0), cora.n_nodes,
                                     cora.n_edges, cora.d_feat,
                                     cora.n_classes)
    graph_s = time.perf_counter() - t
    for arch_id in GNN_ARCHS:
        _, cfg, cell = gnn_cell(arch_id, "full_graph_sm")
        g_abs = cell.abstract_inputs[2]
        n, e = g_abs.node_feat.shape[0], g_abs.edge_src.shape[0]
        node_feat = torch.zeros(n, cora.d_feat, dtype=torch.float32)
        node_feat[:cora.n_nodes] = torch.from_numpy(feat)
        edge_src = torch.full((e,), n - 1, dtype=torch.int32)
        edge_dst = edge_src.clone()
        edge_src[:cora.n_edges] = torch.from_numpy(src)
        edge_dst[:cora.n_edges] = torch.from_numpy(dst)
        node_label = torch.zeros(n, dtype=torch.int32)
        node_label[:cora.n_nodes] = torch.from_numpy(labels)
        g = gnn.GraphBatch(node_feat, edge_src, edge_dst,
                           torch.arange(e) < cora.n_edges,
                           torch.arange(n) < cora.n_nodes, node_label)
        g = tree_map(lambda x: x.to(dev), g)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = gnn.INITS[cfg.kind](
            torch.Generator(device=dev).manual_seed(0), cfg)
        opt = init_adamw(params)
        losses, secs = [], []
        for _ in range(GNN_STEPS):
            params, opt, loss, s = _timed_step(cell, params, opt, g)
            losses.append(loss)
            secs.append(s)
        losses = [float(x) for x in losses]
        with torch.no_grad():
            pred = torch.argmax(gnn.FORWARDS[cfg.kind](params, cfg, g), -1)
        acc = float((pred == g.labels)[g.node_mask].float().mean())
        peak = torch.cuda.max_memory_allocated()
        step_s = statistics.median(secs)
        say("gnn", check="full_width", arch=arch_id, shape="full_graph_sm",
            nodes=cora.n_nodes, edges=cora.n_edges, padded_nodes=n,
            padded_edges=e, d_in=cfg.d_in, d_hidden=cfg.d_hidden,
            heads=cfg.n_heads, layers=cfg.n_layers, classes=cfg.n_classes,
            steps=GNN_STEPS, graphgen_s=f"{graph_s:.3f}",
            loss_first=f"{losses[0]:.4f}", loss_least=f"{min(losses):.4f}",
            loss_last=f"{losses[-1]:.4f}", train_acc=f"{acc:.4f}",
            step_ms_median=_median_ms(secs),
            step_ms_first=f"{secs[0] * 1e3:.3f}",
            model_flops=f"{cell.model_flops:.6e}",
            model_tflops_per_s=f"{cell.model_flops / step_s / 1e12:.4f}",
            peak_gib=f"{peak / 2**30:.3f}", smi=f"'{smi}'")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{arch_id}: a loss is not finite")
        if acc <= GNN_MIN_ACC:
            raise AssertionError(f"{arch_id}: train accuracy {acc:.4f} "
                                 f"after {GNN_STEPS} steps")
        del params, opt, g


def block_batch(block, feat_table, label_table, n: int, e: int,
                dev) -> gnn.GraphBatch:
    """One sampled block as a ``GraphBatch`` of ``n`` nodes and ``e``
    edges on ``dev`` (the cell's padded shape; minibatch_lg's blocks
    already have it): each node's features and label gathered from the
    tables on the card by its global id, pad rows (id -1) zero, added pad
    edges masked at the last row."""
    ids = np.full(n, -1, np.int64)
    ids[:len(block.node_ids)] = block.node_ids
    src, dst = np.full(e, n - 1, np.int32), np.full(e, n - 1, np.int32)
    mask = np.zeros(e, bool)
    k = len(block.edge_src)
    src[:k], dst[:k], mask[:k] = block.edge_src, block.edge_dst, \
        block.edge_mask
    ids = torch.from_numpy(ids).to(dev)
    real = ids >= 0
    rows = ids.clamp(min=0)
    return gnn.GraphBatch(
        node_feat=torch.where(real[:, None], feat_table[rows], 0.0),
        edge_src=torch.from_numpy(src).to(dev),
        edge_dst=torch.from_numpy(dst).to(dev),
        edge_mask=torch.from_numpy(mask).to(dev),
        node_mask=real,
        labels=torch.where(real, label_table[rows], 0))


def check_gnn_sampled(dev, smi: str) -> None:
    """Phase 13 (c): minibatch_lg from the port's ``NeighborSampler``
    (fanouts 15 and 10, 1,024 seeds a block) over a seeded uniform random
    graph with Reddit's nodes and a tenth of its edges, the feature table
    on the card; each arch at full width trains GNN_BLOCK_STEPS steps on
    fresh blocks."""
    shape = gnn_cell(GNN_ARCHS[0], "minibatch_lg")[0]
    edges = REDDIT_EDGES // REDDIT_CUT
    rng = np.random.default_rng(0)
    t = time.perf_counter()
    graph = Graph(num_vertices=REDDIT_NODES,
                  edge_u=rng.integers(0, REDDIT_NODES, edges),
                  edge_v=rng.integers(0, REDDIT_NODES, edges))
    graph_s = time.perf_counter() - t
    t = time.perf_counter()
    sampler = NeighborSampler(graph, shape.fanout, seed=0)
    csr_s = time.perf_counter() - t
    gen = torch.Generator(device=dev).manual_seed(0)
    feat_table = torch.randn(REDDIT_NODES, shape.d_feat, generator=gen,
                             device=dev)
    label_table = torch.randint(0, shape.n_classes, (REDDIT_NODES,),
                                generator=gen, device=dev,
                                dtype=torch.int32)
    say("gnn", check="sampled_graph", shape="minibatch_lg",
        nodes=REDDIT_NODES, edges=edges,
        reduced=f"'edges {edges} of Reddit's {REDDIT_EDGES} (1/{REDDIT_CUT}),"
                f" so that the host CSR build stays short'",
        fanouts=",".join(map(str, shape.fanout)), seeds=shape.batch_nodes,
        graphgen_s=f"{graph_s:.3f}", csr_build_s=f"{csr_s:.3f}",
        feature_table_mb=f"{feat_table.numel() * 4 / 1e6:.1f}")
    for arch_id in GNN_ARCHS:
        _, cfg, cell = gnn_cell(arch_id, "minibatch_lg")
        g_abs = cell.abstract_inputs[2]
        n_e = g_abs.node_feat.shape[0], g_abs.edge_src.shape[0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        params = gnn.INITS[cfg.kind](
            torch.Generator(device=dev).manual_seed(0), cfg)
        opt = init_adamw(params)
        losses, secs, sample_secs, real = [], [], [], []
        for _ in range(GNN_BLOCK_STEPS):
            seeds = rng.choice(REDDIT_NODES, shape.batch_nodes, replace=False)
            t = time.perf_counter()
            block = sampler.sample(seeds)
            sample_secs.append(time.perf_counter() - t)
            g = block_batch(block, feat_table, label_table, *n_e, dev)
            if bool(g.node_feat[~g.node_mask].any()):
                raise AssertionError("a pad row of the block read features")
            real.append((int(block.node_mask.sum()),
                         int(block.edge_mask.sum())))
            params, opt, loss, s = _timed_step(cell, params, opt, g)
            losses.append(float(loss))
            secs.append(s)
        say("gnn", check="sampled", arch=arch_id, shape="minibatch_lg",
            block_nodes=len(block.node_ids), padded_nodes=n_e[0],
            padded_edges=n_e[1], d_in=cfg.d_in,
            classes=cfg.n_classes, steps=GNN_BLOCK_STEPS,
            real_nodes="'" + ",".join(str(n) for n, _ in real) + "'",
            real_edges="'" + ",".join(str(e) for _, e in real) + "'",
            sample_s_median=f"{statistics.median(sample_secs):.3f}",
            step_ms_median=_median_ms(secs),
            step_ms_first=f"{secs[0] * 1e3:.3f}",
            losses="'" + ",".join(f"{x:.4f}" for x in losses) + "'",
            model_flops=f"{cell.model_flops:.6e}",
            peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
            smi=f"'{smi}'")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{arch_id}: a loss is not finite")
        del params, opt, g


def check_gnn(dev, smi: str) -> None:
    """Phase 13 (module docstring): on a drained card, every launch
    counter set to 0 before and read after; no kernel of the port may
    launch."""
    t0 = time.perf_counter()
    require_drained("gnn", 13)
    reset_counts()
    check_gnn_parity(dev)
    check_gnn_full(dev, smi)
    check_gnn_sampled(dev, smi)
    counts = read_counts()
    say("gnn", seconds=f"{time.perf_counter() - t0:.3f}",
        launches=json.dumps(counts, separators=(",", ":")))
    if any(counts.values()):
        raise AssertionError(f"the GNN phase launched kernels: {counts}")
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 14 --

def unmasked_bag(table, ids, bag_mask, field_offsets):
    """A planted fault: ``recsys.embedding_bag`` summing every slot of a
    bag, the masked ones too."""
    B, F, G = ids.shape
    rows = (ids + field_offsets[None, :, None]).reshape(-1)
    return torch.index_select(table, 0, rows).reshape(B, F, G, -1).sum(2)


def _rec_grads(params, cfg, batch):
    """(logits, loss, gradients) of AutoInt on one batch."""
    loss, grads = steps.recsys_value_and_grad(params, cfg, batch)
    with torch.no_grad():
        logits = recsys.autoint_forward(params, cfg, batch)
    return logits, loss, grads


def check_recsys_parity(dev) -> None:
    """Phase 14 (a): the reduced config at batch 16 and the full widths
    with a cut vocabulary at batch 256, one set of seeded weights and one
    SyntheticCTR batch on ``dev`` and on the CPU: logits, loss and every
    gradient, then one ``build_cell`` step from a warm AdamW state (step
    1000, seeded moments): loss and moments at REC_TOL, every weight's
    update within REC_UPDATE_ATOL; and the planted unmasked bag."""
    cpu = torch.device("cpu")
    for label, batch_size, vocab in REC_PARITY:
        arch = get_config(REC_ARCH, reduced=vocab is None)
        cfg = arch.model if vocab is None else \
            dataclasses.replace(arch.model, vocab_per_field=vocab)
        arch = dataclasses.replace(arch, model=cfg)
        params = recsys.init_autoint_params(torch.Generator().manual_seed(0),
                                            cfg)
        batch = batch_to_device(
            SyntheticCTR(cfg, batch_size, seed=1).batch_at(0), cpu)
        on_card = _to(params, dev)
        card_b = _to(batch, dev)
        want = _rec_grads(params, cfg, batch)
        ok_grad, err_grad = _trees_close(_rec_grads(on_card, cfg, card_b),
                                         want, REC_TOL, REC_TOL)
        cell = steps.build_cell(arch, "train_batch")
        w_loss, w_opt, w_upd = _warm_step(cell, params, batch, cpu)
        c_loss, c_opt, c_upd = _warm_step(cell, params, batch, dev)
        ok_state, err_state = _trees_close(
            (c_loss, c_opt.step, c_opt.m, c_opt.v),
            (w_loss, w_opt.step, w_opt.m, w_opt.v), REC_TOL, REC_TOL)
        ok_upd, err_upd = _trees_close(c_upd, w_upd, 0.0, REC_UPDATE_ATOL)
        moved = min(float(u.abs().max()) for u in w_upd)
        with mock.patch.object(recsys, "embedding_bag", unmasked_bag):
            f_ok, f_err = _trees_close(_rec_grads(on_card, cfg, card_b),
                                       want, REC_TOL, REC_TOL)
            _, _, f_upd = _warm_step(cell, params, batch, dev)
        fu_ok, fu_err = _trees_close(f_upd, w_upd, 0.0, REC_UPDATE_ATOL)
        say("recsys", check="parity", config=label, fields=cfg.n_fields,
            vocab_per_field=cfg.vocab_per_field, d=cfg.embed_dim,
            layers=cfg.n_attn_layers, heads=cfg.n_heads, d_attn=cfg.d_attn,
            mlp=",".join(map(str, cfg.mlp_dims)), batch=batch_size,
            dtype="float32", loss_cpu=f"{float(want[1]):.6f}",
            grads_max_abs_err=f"{err_grad:.3e}", grads_allclose=ok_grad,
            warm_from_step=1000, warm_state_max_abs_err=f"{err_state:.3e}",
            warm_state_allclose=ok_state,
            warm_update_max_abs_err=f"{err_upd:.3e}",
            warm_update_within=ok_upd,
            warm_least_weight_move=f"{moved:.3e}",
            planted_unmasked_bag_grads_max_abs_err=f"{f_err:.3e}",
            planted_unmasked_bag_update_max_abs_err=f"{fu_err:.3e}",
            planted_fault_seen=not (f_ok or fu_ok),
            tol=REC_TOL, update_atol=REC_UPDATE_ATOL)
        if not (ok_grad and ok_state and ok_upd):
            raise AssertionError(f"AutoInt ({label}) differs between cuda "
                                 f"and cpu")
        if moved <= REC_UPDATE_ATOL:
            raise AssertionError(f"a warm step moved a weight tensor by at "
                                 f"most {moved:.3e}, within the atol")
        if f_ok or fu_ok:
            raise AssertionError("the recsys parity check cannot see an "
                                 "embedding bag that ignores its mask")


def draw_recsys_batches(arch) -> dict:
    """The host batches of phase 14 from SyntheticCTR, drawn by
    REC_DRAW_THREADS threads (numpy's draws release the interpreter
    lock): REC_STEPS train_batch steps (seed 0), serve_p99 (seed 1),
    serve_bulk (seed 2) and the retrieval query (seed 3), each cell at
    its shape's batch.  Prints each draw's seconds and the wall."""
    cfg, shapes = arch.model, arch.shapes
    jobs = [("serve_bulk", 2, 0)] + \
        [("train_batch", 0, step) for step in range(REC_STEPS)] + \
        [("serve_p99", 1, 0), ("retrieval_cand", 3, 0)]

    def draw(job):
        name, seed, step = job
        t = time.perf_counter()
        b = SyntheticCTR(cfg, shapes[name].batch, seed=seed).batch_at(step)
        return name, b, time.perf_counter() - t

    t = time.perf_counter()
    with ThreadPoolExecutor(REC_DRAW_THREADS) as pool:
        drawn = list(pool.map(draw, jobs))
    wall = time.perf_counter() - t
    out = {name: [] for name in shapes}
    secs = {name: [] for name in shapes}
    for name, b, sec in drawn:
        out[name].append(b)
        secs[name].append(sec)
    say("recsys", check="draw", threads=REC_DRAW_THREADS, wall_s=f"{wall:.3f}",
        **{f"{name}_draw_s": f"{statistics.median(v):.3f}"
           for name, v in secs.items()},
        train_draws=len(out["train_batch"]))
    return out


def _rec_family(ev, cfg) -> str:
    """The family of the kernels a profiled op launched, from the op, its
    callers and their input shapes: the optimizer (inside
    ``adamw_update``); the embedding bag (the gather, the table
    gradient's ``index_add`` and zero fill, and the bag's masked sum on
    ``[B, F, G, d]``); attention (its ``einsum``s and softmax, the passes
    over ``[B, F, ·]``, ``[B, F, H, D]`` and ``[B, H, F, ·]``, and the
    q/k/v/wres products); the MLP (ops with an ``F·H·D``- or MLP-wide
    2-D operand); the rest (the loss)."""
    names, shapes = [], []
    while ev is not None:
        names.append(ev.name)
        shapes += [tuple(s) for s in (ev.input_shapes or [])
                   if s and all(isinstance(d, int) for d in s)]
        ev = ev.cpu_parent
    text = " ".join(names).lower()
    bag = (cfg.max_bag, cfg.embed_dim)
    wide = {cfg.n_fields * cfg.n_heads * cfg.d_attn, *cfg.mlp_dims}
    if "adamw_update" in text:
        return "optimizer"
    if "index_select" in text or "index_add" in text or \
            any(len(s) == 4 and s[2:] == bag for s in shapes):
        return "embedding_bag"
    if any(w in text for w in ("bmm", "softmax", "einsum")) or \
            any(len(s) >= 3 and cfg.n_fields in s[1:3] for s in shapes):
        return "attention"
    if any(len(s) == 2 and (s[0] in wide or s[1] in wide) for s in shapes):
        return "mlp"
    return "attention" if "mm" in text else "other"


def _rec_profile(what: str, fn, cfg, top: int = 6) -> dict:
    """One call of ``fn`` under torch.profiler: wall and busy milliseconds
    (each device event once), the idle share, the kernels, and the busy
    time by ``_rec_family``, attention's products apart."""
    prof, wall_ms = _profiled_step(fn)
    split = dict.fromkeys(("embedding_bag_ms", "attention_ms",
                           "attention_matmul_ms", "mlp_ms", "optimizer_ms",
                           "other_ms"), 0.0)
    kernels = _device_kernels(prof)[0]
    by_name = {}
    for name, t0, t1, op in kernels:
        family = "other" if op is None else _rec_family(op, cfg)
        ms = (t1 - t0) / 1e6
        by_name[name] = by_name.get(name, 0.0) + ms
        split[family + "_ms"] += ms
        if family == "attention" and any(w in name.lower()
                                         for w in GEMM_WORDS):
            split["attention_matmul_ms"] += ms
    busy_ms = sum(v for k, v in split.items() if k != "attention_matmul_ms")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"[recsys-profile] {what} kernel {ms:9.3f} ms {name[:80]}",
              flush=True)
    out = {"wall_ms": wall_ms, "busy_ms": busy_ms,
           "idle_share": max(0.0, 1 - busy_ms / wall_ms),
           "kernels": len(kernels), **split}
    say("recsys-profile", call=what, **_fmt(out))
    return out


def _percentile_ms(seconds: list, q: float) -> str:
    return f"{float(np.percentile(seconds, q)) * 1e3:.4f}"


def check_recsys_train(dev, smi: str, arch, host: list):
    """Phase 14 (b): train_batch at the full config: the 2.496 GB table
    drawn on the card, REC_STEPS ``build_cell`` steps on SyntheticCTR
    batches uploaded before the timed loop, each loss finite within
    REC_LOSS_BOUNDS; then the first REC_LOGIT_ROWS examples' logits
    against the same weights on the CPU.  Returns the trained weights on
    the card and their CPU copy."""
    cfg, shape = arch.model, arch.shapes["train_batch"]
    cell = steps.build_cell(arch, "train_batch")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = recsys.init_autoint_params(
        torch.Generator(device=dev).manual_seed(0), cfg)
    opt = init_adamw(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    held = sum(x.numel() * x.element_size()
               for x in tree_leaves((params, opt.m, opt.v)))
    t = time.perf_counter()
    batches = [batch_to_device(b, dev) for b in host]
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t
    losses, secs = [], []
    for b in batches:
        params, opt, loss, s = _timed_step(cell, params, opt, b)
        losses.append(float(loss))
        secs.append(s)
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    step_s = statistics.median(secs)
    flops_s = cell.model_flops / step_s
    say("recsys", check="train", shape="train_batch", batch=shape.batch,
        table_rows=cfg.n_fields * cfg.vocab_per_field,
        table_gb=f"{params['table'].numel() * 4 / 1e9:.3f}",
        params_and_moments_gb=f"{held / 1e9:.3f}", init_s=f"{init_s:.3f}",
        upload_s=f"{upload_s:.3f}", steps=REC_STEPS,
        step_ms_median=_median_ms(secs), step_ms_first=f"{secs[0] * 1e3:.3f}",
        step_ms_max=f"{max(secs[1:]) * 1e3:.3f}",
        examples_per_s=f"{shape.batch / step_s:.1f}",
        model_flops=f"{cell.model_flops:.6e}",
        model_tflops_per_s=f"{flops_s / 1e12:.4f}",
        share_of_peak=f"{flops_s / PEAK_FLOPS[torch.float32]:.4f}",
        peak="'67 TFLOP/s f32 on the CUDA cores (TF32 off); the count "
             "takes every layer at d = embed_dim and leaves out wres'",
        loss_first=f"{losses[0]:.6f}", loss_least=f"{min(losses):.6f}",
        loss_last=f"{losses[-1]:.6f}",
        peak_allocated_gib=f"{peak / 2**30:.3f}",
        peak_reserved_gib=f"{reserved / 2**30:.3f}", smi=f"'{smi}'")
    lo, hi = REC_LOSS_BOUNDS
    if not all(math.isfinite(x) and lo < x < hi for x in losses):
        raise AssertionError(f"a train loss is outside ({lo}, {hi}): "
                             f"{losses}")
    state = [params, opt]

    def one_step():
        state[0], state[1], _ = cell.fn(state[0], state[1], batches[-1])

    _rec_profile("train_batch", one_step, cfg)
    params = state[0]
    del opt, batches, state
    rows = tree_map(lambda a: a[:REC_LOGIT_ROWS], host[0])
    t = time.perf_counter()
    cpu_params = _to(params, torch.device("cpu"))
    copy_s = time.perf_counter() - t
    with torch.no_grad():
        got = recsys.autoint_forward(params, cfg,
                                     batch_to_device(rows, dev)).cpu()
        want = recsys.autoint_forward(cpu_params, cfg,
                                      batch_to_device(rows, "cpu"))
    ok, err = _trees_close(got, want, REC_TOL, REC_TOL)
    say("recsys", check="train_logits", rows=REC_LOGIT_ROWS,
        table_rows=cfg.n_fields * cfg.vocab_per_field,
        copy_to_cpu_s=f"{copy_s:.3f}", max_abs_err=f"{err:.3e}",
        allclose=ok, tol=REC_TOL)
    if not ok:
        raise AssertionError("AutoInt's logits at the full table differ "
                             "between cuda and cpu")
    return params, cpu_params


def _timed_calls(fn, n: int) -> list:
    """``n`` synchronised calls of ``fn`` after one warm-up: seconds each."""
    fn()
    secs = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
    return secs


@torch.no_grad()
def check_recsys_serve(dev, smi: str, arch, params, host: dict) -> None:
    """Phase 14 (c): serve_p99 (512) over REC_P99_CALLS synchronised
    calls and serve_bulk (262,144) over REC_BULK_CALLS, each batch on the
    card before the clock starts; the bulk batch's first 512 logits
    against a 512-batch forward of the same rows."""
    for name, calls in (("serve_p99", REC_P99_CALLS),
                        ("serve_bulk", REC_BULK_CALLS)):
        shape = arch.shapes[name]
        cell = steps.build_cell(arch, name)
        batch = batch_to_device(host[name][0], dev)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        secs = _timed_calls(lambda: cell.fn(params, batch), calls)
        peak = torch.cuda.max_memory_allocated()
        reserved = torch.cuda.max_memory_reserved()
        _rec_profile(name, lambda: cell.fn(params, batch), arch.model)
        extra = {}
        if name == "serve_bulk":
            first = tree_map(lambda a: a[:512], host[name][0])
            ok, err = _trees_close(
                cell.fn(params, batch)[:512],
                cell.fn(params, batch_to_device(first, dev)), REC_TOL,
                REC_TOL)
            extra = dict(first_512_vs_512_batch_max_abs_err=f"{err:.3e}",
                         first_512_allclose=ok)
            if not ok:
                raise AssertionError("the bulk batch's first 512 logits "
                                     "differ from a 512-batch forward")
        say("recsys", check="serve", shape=name, batch=shape.batch,
            calls=calls, ms_p50=_percentile_ms(secs, 50),
            ms_p99=_percentile_ms(secs, 99), ms_max=f"{max(secs) * 1e3:.4f}",
            examples_per_s=f"{shape.batch / statistics.median(secs):.1f}",
            model_flops=f"{cell.model_flops:.6e}",
            peak_allocated_gib=f"{peak / 2**30:.3f}",
            transient_gib=f"{(peak - base) / 2**30:.3f}",
            peak_reserved_gib=f"{reserved / 2**30:.3f}", **extra,
            smi=f"'{smi}'")
        del batch


@torch.no_grad()
def check_recsys_retrieval(dev, smi: str, arch, params, cpu_params,
                           host: dict) -> None:
    """Phase 14 (d): retrieval_cand: one query against a seeded
    [1,000,000, 16] f32 candidate matrix on the card, where the best
    row is copied into four others and the 50th into two (exact ties):
    the tied rows in ascending index order, the top REC_TOP_K timed and
    held against the CPU, indices differing only between candidates
    whose CPU scores are within REC_TIE_ATOL."""
    cfg, shape = arch.model, arch.shapes["retrieval_cand"]
    cell = steps.build_cell(arch, "retrieval_cand")
    n = shape.n_candidates
    cand = torch.randn(n, cfg.embed_dim, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(1))
    query = batch_to_device(host["retrieval_cand"][0], dev)
    _, idx = cell.fn(params, query, cand)
    best, mid = int(idx[0, 0]), int(idx[0, 49])
    tied_best = sorted({3, best // 2, (best + n) // 2, n - 1} - {best, mid})
    tied_mid = sorted({1, n - 2} - {best, mid} - set(tied_best))
    cand[tied_best] = cand[best].clone()
    cand[tied_mid] = cand[mid].clone()
    secs = _timed_calls(lambda: cell.fn(params, query, cand),
                        REC_RETRIEVAL_CALLS)
    vals, idx = (x.cpu() for x in cell.fn(params, query, cand))
    k = len(tied_best) + 1
    order_ok = (idx[0, :k].tolist() == sorted(tied_best + [best])
                and bool((vals[0, :k] == vals[0, 0]).all())
                and bool(vals[0, k] < vals[0, 0]))
    mid_rows = sorted(tied_mid + [mid])
    top = idx[0].tolist()
    at = top.index(mid_rows[0]) if mid_rows[0] in top else -1
    mid_ok = at >= 0 and top[at:at + len(mid_rows)] == mid_rows
    cand_cpu = cand.cpu()
    query_cpu = batch_to_device(host["retrieval_cand"][0], "cpu")
    want_v, want_i = recsys.retrieval_score(cpu_params, cfg, query_cpu,
                                            cand_cpu, top_k=REC_TOP_K)
    u = torch.mean(recsys._embed(cpu_params, cfg, query_cpu), dim=1)
    scores = (u @ cand_cpu.T)[0]
    ok_v, err_v = _trees_close(vals, want_v, REC_TOL, REC_TOL)
    differ = (idx != want_i)[0].nonzero().flatten().tolist()
    gaps = [abs(float(scores[idx[0, i]] - scores[want_i[0, i]]))
            for i in differ]
    say("recsys", check="retrieval", shape="retrieval_cand", candidates=n,
        top_k=REC_TOP_K, ms_median=_median_ms(secs),
        ms_p99=_percentile_ms(secs, 99), calls=REC_RETRIEVAL_CALLS,
        model_flops=f"{cell.model_flops:.6e}",
        tied_rows=",".join(map(str, sorted(tied_best + [best]))),
        tied_mid_rows=",".join(map(str, mid_rows)), tie_order_ok=order_ok,
        mid_tie_order_ok=mid_ok, values_max_abs_err=f"{err_v:.3e}",
        values_allclose=ok_v, index_mismatches=len(differ),
        mismatch_score_gap_max=f"{max(gaps, default=0.0):.3e}",
        tie_atol=REC_TIE_ATOL, smi=f"'{smi}'")
    if not (order_ok and mid_ok):
        raise AssertionError("exact ties in the retrieval top-k are not in "
                             "ascending index order")
    if not ok_v or any(g > REC_TIE_ATOL for g in gaps):
        raise AssertionError("the retrieval top-k differs from the CPU's")


def check_recsys(dev, smi: str) -> None:
    """Phase 14 (module docstring): on a drained card, every launch
    counter set to 0 before and read after; no kernel of the port may
    launch."""
    t0 = time.perf_counter()
    require_drained("recsys", 14)
    reset_counts()
    check_recsys_parity(dev)
    arch = get_config(REC_ARCH)
    host = draw_recsys_batches(arch)
    params, cpu_params = check_recsys_train(dev, smi, arch,
                                            host["train_batch"])
    check_recsys_serve(dev, smi, arch, params, host)
    check_recsys_retrieval(dev, smi, arch, params, cpu_params, host)
    counts = read_counts()
    say("recsys", seconds=f"{time.perf_counter() - t0:.3f}",
        launches=json.dumps(counts, separators=(",", ":")))
    if any(counts.values()):
        raise AssertionError(f"the recsys phase launched kernels: {counts}")
    del params, cpu_params
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 15 --

NEQ_TRACELESS = equivariant._traceless


def fixed_frame_traceless(t):
    """A planted fault: the l = 2 part with a term fixed in the lab frame
    (0.05 e_x e_xᵀ), which no rotation carries along."""
    ex = torch.zeros(3, 3, dtype=t.dtype, device=t.device)
    ex[0, 0] = 0.05
    return NEQ_TRACELESS(t) + ex


def untraced_traceless(t):
    """A planted fault: the l = 2 part keeping its trace."""
    return 0.5 * (t + t.transpose(-1, -2))


def morse(r: np.ndarray) -> np.ndarray:
    """The pair energy of the synthetic targets: a Morse well (depth 1,
    width 1 Å⁻¹, minimum at NEQ_MORSE_R0)."""
    x = np.exp(-(r - NEQ_MORSE_R0))
    return x * x - 2 * x


def lattice_sites(rng, groups: int, count: int, side: int) -> np.ndarray:
    """``[groups, count, 3]`` positions: in each group ``count`` distinct
    sites of a ``side``³ cubic lattice of NEQ_SPACING Å, each moved by a
    uniform jitter of up to NEQ_JITTER Å a coordinate, so no two atoms
    come closer than NEQ_SPACING − 2·NEQ_JITTER."""
    picks = np.argsort(rng.random((groups, side ** 3)), axis=1)[:, :count]
    ijk = np.stack(np.unravel_index(picks, (side,) * 3), axis=-1)
    return ijk * NEQ_SPACING + rng.uniform(-NEQ_JITTER, NEQ_JITTER,
                                           size=ijk.shape)


def molecule_cloud(rng, graphs: int, per: int, pairs: int, n: int, e: int):
    """``graphs`` molecules of ``per`` atoms (``lattice_sites`` of a
    NEQ_MOLECULE_SIDE³ lattice, each molecule in its own frame), each
    with its ``pairs`` shortest directed pairs i ≠ j as edges (src →
    dst), padded to ``n`` atoms and ``e`` edges: pad atoms masked with
    graph id -1, pad edges masked self-loops at the last row.  Targets:
    each molecule's Morse energy over its edges, standardised over the
    batch."""
    pos = lattice_sites(rng, graphs, per, NEQ_MOLECULE_SIDE)
    d = np.linalg.norm(pos[:, :, None] - pos[:, None, :], axis=-1)
    d[:, np.arange(per), np.arange(per)] = np.inf
    order = np.argsort(d.reshape(graphs, -1), axis=1, kind="stable")
    flat = order[:, :pairs]
    src = (flat // per + np.arange(graphs)[:, None] * per).reshape(-1)
    dst = (flat % per + np.arange(graphs)[:, None] * per).reshape(-1)
    r = np.take_along_axis(d.reshape(graphs, -1), flat, 1)
    energy = morse(r).sum(1)
    targets = (energy - energy.mean()) / energy.std()
    return _padded_atoms(rng, pos.reshape(-1, 3), src, dst,
                         np.repeat(np.arange(graphs), per), n, e), targets


def point_cloud(rng, atoms: int, edges: int, n: int, e: int):
    """``atoms`` ``lattice_sites`` filling NEQ_CLOUD_FILL of a cube's
    lattice, each taking its nearest neighbours in rank order (every
    atom's first, then every atom's second, …) as edges neighbour → atom
    until ``edges`` are taken (``scipy.spatial.cKDTree``), padded as
    ``molecule_cloud`` pads; one graph, whose target is 0.01 × its Morse
    energy."""
    from scipy.spatial import cKDTree

    side = math.ceil((atoms / NEQ_CLOUD_FILL) ** (1 / 3))
    pos = lattice_sites(rng, 1, atoms, side)[0]
    k = -(-edges // atoms)
    dist, nbr = cKDTree(pos).query(pos, k=k + 1)
    src = nbr[:, 1:].T.reshape(-1)[:edges]
    dst = np.tile(np.arange(atoms), k)[:edges]
    r = dist[:, 1:].T.reshape(-1)[:edges]
    targets = np.array([0.01 * morse(r).sum()])
    return _padded_atoms(rng, pos, src, dst, np.zeros(atoms, np.int64), n,
                         e), targets


def _padded_atoms(rng, pos, src, dst, graph_id, n: int,
                  e: int) -> equivariant.AtomsBatch:
    real_n, real_e = len(pos), len(src)
    if real_n > n or real_e > e:
        raise ValueError(f"{real_n} atoms / {real_e} edges over the cell's "
                         f"{n} / {e}")
    p = np.zeros((n, 3), np.float32)
    p[:real_n] = pos
    gid = np.full(n, -1, np.int32)
    gid[:real_n] = graph_id
    s = np.full(e, n - 1, np.int32)
    d = np.full(e, n - 1, np.int32)
    s[:real_e], d[:real_e] = src, dst
    species = rng.integers(0, NEQ_SPECIES, n).astype(np.int32)
    return equivariant.AtomsBatch(
        *(torch.from_numpy(a) for a in (
            species, p, s, d, np.arange(e) < real_e, np.arange(n) < real_n,
            gid)))


def _neq_all(params, cfg, batch, e_t, f_t, n_graphs: int):
    """(energies, forces, the energy loss and its gradients, the force
    loss and its second-order gradients)."""
    e, forces = equivariant.energies_and_forces(params, cfg, batch, n_graphs,
                                                create_graph=False)
    le = steps._value_and_grad(lambda p: equivariant.nequip_energy_loss(
        p, cfg, batch, e_t, n_graphs), params)
    lf = steps._value_and_grad(lambda p: equivariant.nequip_force_loss(
        p, cfg, batch, e_t, f_t, 1.0, n_graphs), params)
    return e.detach(), forces, le, lf


def check_nequip_parity(dev) -> None:
    """Phase 15 (a): the reduced and the full config, one set of seeded
    weights carried across as numpy (``params_to_numpy`` →
    ``params_from_numpy``) and one seeded batch of NEQ_PARITY_GRAPHS
    molecules on ``dev`` and on the CPU: energies, forces, the energy
    loss and the force loss with every gradient (the force loss's second
    order) within NEQ_TOL; the planted trace-keeping l = 2 part must
    exceed it."""
    cpu = torch.device("cpu")
    graphs, per, pairs = NEQ_PARITY_GRAPHS
    for label in ("reduced", "full"):
        cfg = get_config(NEQ_ARCH, reduced=label == "reduced").model
        rng = np.random.default_rng(1)
        batch, e_t = molecule_cloud(rng, graphs, per, pairs,
                                    graphs * per + 8, graphs * pairs + 16)
        e_t = torch.from_numpy(e_t.astype(np.float32))
        f_t = torch.from_numpy(
            (rng.normal(size=tuple(batch.pos.shape)) * 0.1).astype(np.float32))
        weights = equivariant.params_to_numpy(equivariant.init_nequip_params(
            torch.Generator().manual_seed(0), cfg))
        params = equivariant.params_from_numpy(weights)
        card = _to(equivariant.params_from_numpy(weights), dev)
        card_in = [_to(x, dev) for x in (batch, e_t, f_t)]
        want = _neq_all(params, cfg, batch, e_t, f_t, graphs)
        got = _neq_all(card, cfg, *card_in, graphs)
        ok, err = _trees_close(got, want, NEQ_TOL, NEQ_TOL)
        errs = {part: _trees_close(g, w, NEQ_TOL, NEQ_TOL)[1]
                for part, g, w in zip(("energies", "forces", "energy_loss",
                                       "force_loss"), got, want)}
        with mock.patch.object(equivariant, "_traceless", untraced_traceless):
            f_ok, f_err = _trees_close(_neq_all(card, cfg, *card_in, graphs),
                                       want, NEQ_TOL, NEQ_TOL)
        say("nequip", check="parity", config=cfg.name, layers=cfg.n_layers,
            channels=cfg.channels, n_rbf=cfg.n_rbf, atoms=batch.pos.shape[0],
            edges=batch.edge_src.shape[0], graphs=graphs, dtype="float32",
            max_abs_err=f"{err:.3e}",
            **{f"{k}_max_abs_err": f"{v:.3e}" for k, v in errs.items()},
            force_loss_cpu=f"{float(want[3][0]):.6f}", allclose=ok,
            planted_trace_kept_max_abs_err=f"{f_err:.3e}",
            planted_fault_seen=not f_ok, tol=NEQ_TOL)
        if not ok:
            raise AssertionError(f"NequIP ({label}) differs between cuda "
                                 f"and cpu: {errs}")
        if f_ok:
            raise AssertionError("the NequIP parity check cannot see an l=2 "
                                 "part that keeps its trace")


def symmetry_check(params, cfg, batch, n_graphs: int) -> dict:
    """Energies and forces before and after a seeded rotation R
    (``Rotation.random(random_state=1)``) and a translation, held as the
    reference property test holds them: the summed energy within
    NEQ_ROT_E_RTOL, ``F(Rx + b)`` within NEQ_ROT_F_RTOL/ATOL of ``R F(x)``.
    Each molecule's energy is held within NEQ_ROT_E_RTOL of itself plus
    that share of the median |E| (a molecule's energy can cancel to
    within 1e-3 of 0, where the f32 rounding of its 30 atoms' terms
    is the whole difference)."""
    from scipy.spatial.transform import Rotation

    R = torch.from_numpy(Rotation.random(random_state=1).as_matrix()
                         .astype(np.float32)).to(batch.pos.device)
    shift = batch.pos.new_tensor([0.7, -1.3, 2.1])
    e0, f0 = equivariant.energies_and_forces(params, cfg, batch, n_graphs,
                                             create_graph=False)
    e1, f1 = equivariant.energies_and_forces(
        params, cfg, batch._replace(pos=batch.pos @ R.T + shift), n_graphs,
        create_graph=False)
    e0, e1, f0, f1 = (x.detach().cpu() for x in (e0, e1, f0, f1))
    want_f = f0 @ R.cpu().T
    scale = NEQ_ROT_E_RTOL * float(e0.abs().median())
    out = {"energy_invariant": bool(torch.allclose(
               e1.sum(), e0.sum(), rtol=NEQ_ROT_E_RTOL, atol=0.0)),
           "energies_invariant": bool(torch.allclose(
               e1, e0, rtol=NEQ_ROT_E_RTOL, atol=scale)),
           "forces_rotate": bool(torch.allclose(
               f1, want_f, rtol=NEQ_ROT_F_RTOL, atol=NEQ_ROT_F_ATOL))}
    return {"holds": all(out.values()), **out,
            "energy_sum_rel_change": float((e1.sum() - e0.sum()).abs()
                                           / e0.sum().abs()),
            "energy_max_rel_change": float(((e1 - e0).abs() / e0.abs()).max()),
            "energy_max_abs_change": float((e1 - e0).abs().max()),
            "energy_atol": scale,
            "force_max_abs_err": float((f1 - want_f).abs().max()),
            "force_max": float(f0.abs().max())}


def check_nequip_symmetry(dev, cfg, batch, n_graphs: int) -> None:
    """Phase 15 (b): the property at full width on ``molecule``'s batch
    on the card, with the seeded weights; the planted fixed-frame term
    must break it."""
    params = equivariant.init_nequip_params(
        torch.Generator(device=dev).manual_seed(0), cfg)
    batch = _to(batch, dev)
    got = symmetry_check(params, cfg, batch, n_graphs)
    with mock.patch.object(equivariant, "_traceless", fixed_frame_traceless):
        fault = symmetry_check(params, cfg, batch, n_graphs)
    say("nequip", check="rotation", config=cfg.name, atoms=batch.pos.shape[0],
        edges=batch.edge_src.shape[0], graphs=n_graphs,
        **{k: (f"{v:.3e}" if isinstance(v, float) else v)
           for k, v in got.items()},
        planted_fixed_frame_energy_max_rel_change=
        f"{fault['energy_max_rel_change']:.3e}",
        planted_fault_seen=not fault["holds"],
        e_rtol=NEQ_ROT_E_RTOL, f_rtol=NEQ_ROT_F_RTOL, f_atol=NEQ_ROT_F_ATOL)
    if not got["holds"]:
        raise AssertionError(f"NequIP is not E(3)-equivariant on the card: "
                             f"{got}")
    if fault["holds"]:
        raise AssertionError("the rotation check cannot see a fixed-frame "
                             "term")


def nequip_batch(shape: str, cell) -> tuple:
    """(the host batch, the energy targets, graphs, real atoms, real
    edges) of a NequIP cell at its full size (module docstring)."""
    b_abs, t_abs = cell.abstract_inputs[2:]
    n, e = b_abs.pos.shape[0], b_abs.edge_src.shape[0]
    spec = gnn_shapes()[shape]
    rng = np.random.default_rng(0)
    if shape == "molecule":
        batch, targets = molecule_cloud(rng, spec.batch, spec.n_nodes,
                                        spec.n_edges, n, e)
        real = (spec.batch * spec.n_nodes, spec.batch * spec.n_edges)
    else:
        atoms = spec.n_nodes if shape == "full_graph_sm" else n
        edges = spec.n_edges if shape == "full_graph_sm" else e
        batch, targets = point_cloud(rng, atoms, edges, n, e)
        real = (atoms, edges)
    return batch, torch.from_numpy(targets.astype(np.float32)), \
        t_abs.shape[0], *real


def _neq_family(name: str, op) -> str:
    """The family of a kernel of a NequIP step: the optimizer (inside
    ``adamw_update``), the gathers (``index_select``'s
    ``vectorized_gather_kernel``), the scatters (``index_add``'s
    ``indexFunc…``), the products (GEMMs and cuBLAS's ``gemv``), the rest
    (elementwise passes and reductions)."""
    chain = []
    while op is not None:
        chain.append(op.name)
        op = op.cpu_parent
    low = name.lower()
    if any("adamw_update" in c for c in chain):
        return "optimizer"
    if "gather" in low or "indexselect" in low:
        return "gather"
    if "indexfunc" in low or "scatter" in low:
        return "scatter"
    if any(w in low for w in GEMM_WORDS + ("gemv",)):
        return "product"
    return "elementwise"


def _neq_profile(shape: str, fn, top: int = 8) -> dict:
    """One step under torch.profiler: wall and busy ms (each device event
    once), the idle share, the kernels and the busy ms by family."""
    prof, wall_ms = _profiled_step(fn)
    split = dict.fromkeys(("gather_ms", "scatter_ms", "product_ms",
                           "elementwise_ms", "optimizer_ms"), 0.0)
    kernels = _device_kernels(prof)[0]
    by_name = {}
    for name, t0, t1, op in kernels:
        ms = (t1 - t0) / 1e6
        split[_neq_family(name, op) + "_ms"] += ms
        by_name[name] = by_name.get(name, 0.0) + ms
    busy_ms = sum(split.values())
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"[nequip-profile] {shape} kernel {ms:9.3f} ms {name[:80]}",
              flush=True)
    out = {"wall_ms": wall_ms, "busy_ms": busy_ms,
           "idle_share": max(0.0, 1 - busy_ms / wall_ms),
           "kernels": len(kernels), **split}
    say("nequip-profile", step=shape, **_fmt(out))
    return out


def check_nequip_train(dev, smi: str, arch, shape: str, cell, host) -> None:
    """Phase 15 (c): NEQ_STEPS[shape] ``build_cell`` steps at full width
    and size on the card from seeded weights, on one batch uploaded before
    the clock: ms a step, peak memory, model TFLOP/s, the loss at the
    first and the last step; each loss finite, and falling where
    NEQ_MUST_FALL says so; then one more step under torch.profiler in
    the NEQ_PROFILED cells."""
    batch, targets, graphs, atoms, edges = host
    batch, targets = _to(batch, dev), targets.to(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = equivariant.init_nequip_params(
        torch.Generator(device=dev).manual_seed(0), arch.model)
    opt = init_adamw(params)
    losses, secs = [], []
    for _ in range(NEQ_STEPS[shape]):
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, opt, loss = cell.fn(params, opt, batch, targets)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        losses.append(loss)
    losses = [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated()
    step_s = statistics.median(secs)
    say("nequip", check="train", shape=shape, note=f"'{cell.note}'",
        layers=arch.model.n_layers, channels=arch.model.channels,
        atoms=atoms, edges=edges, padded_atoms=batch.pos.shape[0],
        padded_edges=batch.edge_src.shape[0], graphs=graphs,
        steps=len(secs), loss_first=f"{losses[0]:.6f}",
        loss_least=f"{min(losses):.6f}", loss_last=f"{losses[-1]:.6f}",
        step_ms_median=_median_ms(secs), step_ms_first=f"{secs[0] * 1e3:.3f}",
        step_ms_min=f"{min(secs) * 1e3:.3f}",
        model_flops=f"{cell.model_flops:.6e}",
        model_tflops_per_s=f"{cell.model_flops / step_s / 1e12:.4f}",
        peak_gib=f"{peak / 2**30:.3f}",
        reserved_gib=f"{torch.cuda.max_memory_reserved() / 2**30:.3f}",
        smi=f"'{smi}'")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"nequip {shape}: a loss is not finite")
    if shape in NEQ_MUST_FALL and not losses[-1] < losses[0]:
        raise AssertionError(f"nequip {shape}: the loss went from "
                             f"{losses[0]} to {losses[-1]}")
    if shape in NEQ_PROFILED:
        _neq_profile(shape, lambda: cell.fn(params, opt, batch, targets))
    del params, opt, batch


def check_nequip_products(arch) -> None:
    """Phase 15 (d): ogb_products's abstract cell only, and the bytes of
    one layer's gathered ``t_j`` (f32 [E, C, 3, 3]) before autograd's
    saves."""
    cell = steps.build_cell(arch, "ogb_products")
    b_abs = cell.abstract_inputs[2]
    n, e = b_abs.pos.shape[0], b_abs.edge_src.shape[0]
    t_j = e * arch.model.channels * 9 * 4
    say("nequip", check="ogb_products", run=False, padded_atoms=n,
        padded_edges=e, model_flops=f"{cell.model_flops:.6e}",
        t_j_bytes=t_j, t_j_gb=f"{t_j / 1e9:.2f}",
        waits_for="'ROADMAP item 9c (a mesh), and edge chunking, which the "
                  "reference lacks'")


def check_nequip(dev, smi: str) -> None:
    """Phase 15 (module docstring): on a drained card, every launch
    counter set to 0 before and read after; no kernel of the port may
    launch."""
    t0 = time.perf_counter()
    require_drained("nequip", 15)
    reset_counts()
    check_nequip_parity(dev)
    arch = get_config(NEQ_ARCH)
    cells, host = {}, {}
    for shape in NEQ_STEPS:
        cells[shape] = steps.build_cell(arch, shape)
        t = time.perf_counter()
        host[shape] = nequip_batch(shape, cells[shape])
        say("nequip", check="batch", shape=shape,
            host_s=f"{time.perf_counter() - t:.3f}")
    mol = host["molecule"]
    check_nequip_symmetry(dev, arch.model, mol[0], mol[2])
    for shape in NEQ_STEPS:
        check_nequip_train(dev, smi, arch, shape, cells[shape], host[shape])
    check_nequip_products(arch)
    counts = read_counts()
    say("nequip", seconds=f"{time.perf_counter() - t0:.3f}",
        launches=json.dumps(counts, separators=(",", ":")))
    if any(counts.values()):
        raise AssertionError(f"the NequIP phase launched kernels: {counts}")
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 16 --

def check_code_reduced(dev) -> None:
    """Phase 16 (a): each reduced code LM, and the reduced Qwen3-MoE, as
    phase 8 (K6 in f32 at head width 32, 16 and 16); then ``main_lm``,
    the reference's entry point, on the card and on the CPU for each:
    the same ids, and K6 launched twice a layer on the card (the
    programs' warm-up and recording)."""
    for arch in REDUCED_K6_ARCHS:
        check_lm_parity(dev, arch, "code-parity")
    for arch in REDUCED_K6_ARCHS:
        layers = get_config(arch, reduced=True).model.n_layers
        reset_counts()
        card = serve.main_lm(["--arch", arch])
        counts = read_counts()
        cpu = serve.main_lm(["--arch", arch, "--device", "cpu"])
        same = np.array_equal(card, cpu)
        say("code-parity", check="main_lm", arch=arch,
            ids_shape="x".join(map(str, card.shape)), ids_equal_cpu=same,
            launches=_compact(counts))
        if not same or counts != dict({n: 0 for n in KERNELS},
                                      flash_attention=2 * layers):
            raise AssertionError(f"main_lm --arch {arch} on the card: ids "
                                 f"equal {same}, launches {counts}")


def check_code_depth2(dev, arch: str) -> None:
    """Phase 16 (b): ``arch`` at full width cut to 2 layers in f32, one
    set of seeded weights on the card and on the CPU, B 1, P 128 and 4
    greedy decode steps: every step's logits ``allclose`` at
    CODE_F32_TOL and the ids equal; K6 launched once a layer on the
    card."""
    d2 = CODE_DEPTH2
    cfg = dataclasses.replace(get_config(arch).model, n_layers=d2["layers"],
                              dtype=torch.float32)
    params = tr.init_lm_params(torch.Generator(device=dev).manual_seed(3),
                               cfg)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (d2["batch"], d2["prompt"])).astype(np.int32))
    t = time.perf_counter()
    reset_counts()
    lc, ic = greedy_logits(params, cfg, tokens.to(dev), d2["steps"])
    counts = read_counts()
    card_s = time.perf_counter() - t
    params = _to(params, "cpu")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    lp, ip = greedy_logits(params, cfg, tokens, d2["steps"])
    cpu_s = time.perf_counter() - t
    errs = [float((a - b).abs().max()) for a, b in zip(lc, lp)]
    ok = all(torch.allclose(a, b, rtol=CODE_F32_TOL, atol=CODE_F32_TOL)
             for a, b in zip(lc, lp))
    same = torch.equal(ic, ip)
    say("code-parity", check="card_vs_cpu_2_layers", config=cfg.name,
        dtype="float32", layers=cfg.n_layers,
        heads=f"{cfg.n_heads}/{cfg.n_kv_heads}", head_dim=cfg.head_dim,
        batch=d2["batch"], prompt=d2["prompt"], decode_steps=d2["steps"],
        logits_max_abs_err="/".join(f"{e:.3e}" for e in errs),
        max_abs_logit=f"{float(lp[0].abs().max()):.3f}",
        logits_allclose=ok, ids_equal=same, launches=_compact(counts),
        card_s=f"{card_s:.3f}", cpu_s=f"{cpu_s:.3f}")
    if not (ok and same and counts["flash_attention"] == cfg.n_layers):
        raise AssertionError(f"the 2-layer full-width {arch} differs "
                             f"between the card and the CPU ({counts})")


def check_code_slice(dev, smi: str, arch: str) -> dict:
    """Phase 16 (e): ``arch`` at full width and depth served at phase 9's
    shape (``serve_full_width``), the decode and prefill bounds beside
    the measured times, one prefill and one decode replay profiled, the
    peak allocated and reserved memory; the card drained before and
    after.  Returns the serve's launch counts."""
    require_drained("code-slice", 16)
    cfg = get_config(arch).model
    params, programs, tokens, counts = serve_full_width(
        dev, smi, cfg, "code-slice", "code-serve",
        grouping=f"{cfg.n_heads // cfg.n_kv_heads}:1",
        rope_theta=cfg.rope_theta)
    programs.load(tokens)
    reset_counts()
    splits = {"prefill_replay": _profile_split(programs.prefill),
              "decode_replay": _profile_split(programs.decode)}
    replay_counts = read_counts()
    for step, split in splits.items():
        say("code-profile", config=cfg.name, step=step, batch=LM_BATCH,
            prompt=LM_PROMPT, **_fmt(split))
    if any(replay_counts.values()):
        raise AssertionError(f"a replay launched {replay_counts}")
    # least times: a decode step reads every weight but the embedding
    # (rows gathered) and the whole cache once; a prefill does 2
    # operations a layer weight a token, and K6's attention
    nbytes = [x.numel() * x.element_size()
              for x in (*tree_leaves(params), *programs.cache[:2])]
    embed = params["embed"].numel() * params["embed"].element_size()
    decode_bound_ms = (sum(nbytes) - embed) / HBM_BYTES_PER_S * 1e3
    layer_params = sum(x.numel() for x in tree_leaves(params["layers"]))
    attn_ms = cfg.n_layers * attention_bound(
        LM_BATCH, LM_PROMPT, LM_PROMPT, cfg.n_heads, cfg.n_kv_heads,
        cfg.head_dim, True, torch.bfloat16)[0]
    prefill_bound_s = (2 * layer_params * LM_BATCH * LM_PROMPT
                       / PEAK_FLOPS[torch.bfloat16] + attn_ms / 1e3)
    say("code-slice", check="bounds", config=cfg.name,
        decode_bound_ms=f"{decode_bound_ms:.3f}",
        decode_bound_tok_s=f"{LM_BATCH / decode_bound_ms * 1e3:.1f}",
        decode_replay_busy_ms=f"{splits['decode_replay']['busy_ms']:.3f}",
        prefill_bound_s=f"{prefill_bound_s:.4f}",
        prefill_replay_busy_ms=f"{splits['prefill_replay']['busy_ms']:.3f}",
        reserved_gib=f"{torch.cuda.memory_reserved() / 2**30:.3f}",
        smi=f"'{smi}'")
    del programs, params, tokens
    torch.cuda.empty_cache()
    return counts


def check_code_lms(dev, smi: str) -> dict:
    """Phase 16 (module docstring).  Returns each code LM's K6 row at its
    prefill shape and its serve's launch counts."""
    t0 = time.perf_counter()
    require_drained("code-slice", 16)
    check_code_reduced(dev)
    for arch in CODE_ARCHS:
        check_code_depth2(dev, arch)
    gen = torch.Generator(device=dev).manual_seed(16)
    rows, counts = {}, {}
    for arch in CODE_ARCHS:
        cfg = get_config(arch).model
        faults = (("dropped_tile", "wrong_heads") if cfg.n_kv_heads > 1
                  else ("dropped_tile",))
        rows[arch] = k6_case(
            gen, dev, f"{arch}_prefill", LM_BATCH, LM_PROMPT, LM_PROMPT,
            cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, True, torch.bfloat16,
            faults=faults, by_rows=True, bf16_allclose=CODE_K6_BF16,
            phase="code-k6")
    for arch in CODE_ARCHS:
        counts[arch] = check_code_slice(dev, smi, arch)
    say("code-slice", seconds=f"{time.perf_counter() - t0:.3f}",
        launches=_compact(counts))
    return {"k6": rows, "launches": counts}

#: phase 17: the engine across ranks, one NCCL rank holding all PARTS
#: partitions (NCCL refuses two ranks on one card); the planted fault's
#: graph scale
MESH_FAULT_SCALE = 8
#: phase 17's batches: the scale of the bucket pair batched over the mesh
#: and beside it, and the widths ([g0, g1] and [g0, g1, g0, g1])
MESH_BATCH_SCALE, MESH_BATCH_WIDTHS = 16, (2, 4)
#: phase 17's serving loop: requests a run, and the pipeline depths
MESH_SERVE_REQUESTS, MESH_SERVE_DEPTHS = 256, (2, 0)
#: phase 17's adaptive serve: main_euler's arguments past SERVE_ARGS
MESH_ADAPTIVE_ARGS = ["--adaptive", "--pipeline-depth", "0"]
#: phase 5b's cold fused solves at the main scale, by ``sharded_phase3``:
#: ``(timings, peak allocated, peak reserved, launches recorded)``
MESHLESS_FUSED: dict = {}
#: phase 5b's prepared main-path graph (its prep-memo entry), which phase
#: 17's solvers reuse instead of preparing the graph again
PREPARED: dict = {}


@contextlib.contextmanager
def nccl_world():
    """A world of one NCCL rank in this process (a ``FileStore`` in a
    temporary directory), destroyed on leaving; NCCL's graph mixing off
    before its first communicator, as ``launch/mesh.py`` asks."""
    name, value = NCCL_GRAPH_MIXING
    os.environ[name] = value
    tmp = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(Path(tmp) / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=300))
    try:
        yield
    finally:
        gc.collect()        # solvers in reference cycles hold NCCL graphs
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def backwards_ring(self, x, dim=0, batch=1):
    """A planted fault: a ring step along i → i−1 (the first partition's
    rows to rank − 1; at world 1 the local rows roll the wrong way)."""
    self._count("ring", "all_to_all_single")
    m = x.shape[dim]
    first = x.narrow(dim, 0, batch).contiguous().reshape(-1)
    got = torch.empty_like(first)
    sends, recvs = [0] * self.world, [0] * self.world
    sends[(self.rank - 1) % self.world] = first.numel()
    recvs[(self.rank + 1) % self.world] = first.numel()
    dist.all_to_all_single(got, first, recvs, sends, group=self.group)
    shape = list(x.shape)
    shape[dim] = batch
    return torch.cat([x.narrow(dim, batch, m - batch), got.view(shape)], dim)


def mesh_recorded(solver, g, mesh):
    """A cold fused ``solver.solve(g)`` over ``mesh`` with the launch
    counters and the mesh's call counts set to 0 just before the graph's
    recording and read just after.  Returns ``(result, launches and
    calls recorded, peak allocated, peak reserved)``."""
    recorded = []
    record = FusedRun._record

    def counted(run):
        reset_counts()
        mesh.calls.clear()
        record(run)
        recorded.append((read_counts(), dict(mesh.calls)))
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(FusedRun, "_record", counted):
        res = solver.solve(g)
    if len(recorded) != 1:
        raise AssertionError(f"the cold mesh solve recorded "
                             f"{len(recorded)} graphs")
    return (res, recorded[0], torch.cuda.max_memory_allocated(),
            torch.cuda.max_memory_reserved())


def check_mesh(scale: int, g, eager: dict, smi: str) -> None:
    """Phase 17 (module docstring).  ``eager`` holds phase 5's meshless
    eager results of ``g`` by ``sharded_phase3``."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    with nccl_world():
        mesh = make_part_mesh(PARTS)
        say("mesh", world=mesh.world, rank=mesh.rank, parts=mesh.n_parts,
            per_rank=mesh.m, device=mesh.device, backend=mesh.backend,
            nccl=".".join(map(str, torch.cuda.nccl.version())),
            allocated_gib=f"{torch.cuda.memory_allocated() / 2**30:.3f}",
            smi=f"'{smi}'")
        for sharded in (True, False):
            phase3 = "sharded" if sharded else "replicated"
            solver = EulerSolver(mesh=mesh, sharded_phase3=sharded)
            solver._prep_cache.update(PREPARED)
            key = solver.bucket_of(g)
            torch.cuda.empty_cache()
            res, (recorded, calls), peak, reserved = mesh_recorded(
                solver, g, mesh)
            budget = fused_collective_budget(
                key[2], num_edges=key[0], n_parts=PARTS,
                sharded_phase3=True) if sharded \
                else fused_collective_budget(key[2])
            want = {k: v for k, v in expected_calls(budget, PARTS).items()
                    if v}
            want["fetch"] = 2
            base_t, base_peak, base_reserved, base_rec = \
                MESHLESS_FUSED[sharded]
            same = same_bytes(res, eager[sharded])
            say("mesh", run="fused", phase3=phase3, edges=g.num_edges,
                byte_identical_to_meshless=same,
                recorded_calls=json.dumps(calls, separators=(",", ":")),
                budget_calls=json.dumps(want, separators=(",", ":")),
                recorded_launches=json.dumps(recorded, separators=(",", ":")),
                meshless_recorded_launches=json.dumps(
                    base_rec, separators=(",", ":")),
                peak_gib=f"{peak / 2**30:.3f}",
                reserved_gib=f"{reserved / 2**30:.3f}",
                meshless_peak_gib=f"{base_peak / 2**30:.3f}",
                meshless_reserved_gib=f"{base_reserved / 2**30:.3f}",
                **{k: f"{res.timings[k]:.4f}" for k in
                   ("upload_s", "warmup_s", "capture_s", "run_s")},
                **{f"meshless_{k}": f"{base_t[k]:.4f}" for k in
                   ("warmup_s", "capture_s", "run_s")})
            if not same:
                raise AssertionError(f"the fused {phase3} solve over the "
                                     f"mesh differs from the meshless one")
            if calls != want:
                raise AssertionError(f"the {phase3} recording called "
                                     f"{calls}, the budget {want}")
            if recorded != base_rec:
                raise AssertionError(f"the {phase3} recording launched "
                                     f"{recorded}, the meshless one "
                                     f"{base_rec}")
            for name in PATH_KERNELS[sharded]:
                if not recorded[name]:
                    raise AssertionError(f"{name} was not launched on the "
                                         f"mesh's {phase3} path")
            reset_counts()
            mesh.calls.clear()
            res = solver.solve(g)
            launched, called = read_counts(), dict(mesh.calls)
            same = same_bytes(res, eager[sharded])
            say("mesh", run="replay", phase3=phase3,
                byte_identical_to_meshless=same,
                python_launches=sum(launched.values()),
                python_calls=sum(called.values()),
                **{k: f"{res.timings[k]:.4f}" for k in
                   ("upload_s", "run_s", "fetch_s")},
                meshless_cold_run_s=f"{base_t['run_s']:.4f}")
            if not same or any(launched.values()) or called:
                raise AssertionError(f"the {phase3} replay over the mesh "
                                     f"differs or ran Python-side work")
            del solver, res
            torch.cuda.empty_cache()
        # the eager path: each level's logs gathered, Phase 3 sharded
        solver = EulerSolver(mesh=mesh, fused=False)
        solver._prep_cache.update(PREPARED)
        reset_counts()
        mesh.calls.clear()
        torch.cuda.reset_peak_memory_stats()
        res = solver.solve(g)
        launched, called = read_counts(), dict(mesh.calls)
        same = same_bytes(res, eager[True])
        base = eager[True].timings
        say("mesh", run="eager", phase3="sharded",
            byte_identical_to_meshless=same,
            launches=json.dumps(launched, separators=(",", ":")),
            calls=json.dumps(called, separators=(",", ":")),
            peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
            supersteps_s=f"{res.timings['supersteps_s']:.4f}",
            phase3_s=f"{res.timings['phase3_s']:.4f}",
            meshless_supersteps_s=f"{base['supersteps_s']:.4f}",
            meshless_phase3_s=f"{base['phase3_s']:.4f}")
        if not same:
            raise AssertionError("the eager solve over the mesh differs "
                                 "from the meshless one")
        for name in PATH_KERNELS[True]:
            if not launched[name]:
                raise AssertionError(f"{name} was not launched on the "
                                     f"mesh's eager path")
        del solver, res
        torch.cuda.empty_cache()
        check_mesh_batch(mesh, smi)
        check_mesh_serve(mesh, smi)
        check_mesh_serve_adaptive(mesh, smi)
        check_mesh_retune(mesh, smi)
        # a planted mis-wiring must be caught
        small = eulerian_rmat(MESH_FAULT_SCALE, avg_degree=AVG_DEGREE,
                              seed=SEED)
        plain = solve(small, n_parts=PARTS, fused=False)
        for run in ("eager", "fused"):
            outcome = "same bytes"
            with mock.patch.object(PartMesh, "ring", backwards_ring):
                try:
                    bad = EulerSolver(mesh=mesh).solve(
                        small, fused=run == "fused")
                    if not same_bytes(bad, plain):
                        outcome = "other bytes"
                except RuntimeError as e:
                    outcome = f"raised: {str(e).splitlines()[0][:120]}"
            say("mesh", fault="ring_sent_backwards", run=run,
                scale=MESH_FAULT_SCALE, caught=outcome != "same bytes",
                outcome=f"'{outcome}'")
            if outcome == "same bytes":
                raise AssertionError(f"the planted backwards ring went "
                                     f"unnoticed ({run})")
    say("mesh", seconds=f"{time.perf_counter() - t0:.1f}")


def bucket_pair(solver, scale: int, seeds: int = 8) -> list:
    """Seed 0's graph at ``scale`` and the first later seed's that shares
    its bucket under ``solver``, whose prep memo then holds both."""
    g0 = eulerian_rmat(scale, avg_degree=AVG_DEGREE, seed=SEED)
    k0 = solver.bucket_of(g0)
    for s in range(SEED + 1, SEED + 1 + seeds):
        g = eulerian_rmat(scale, avg_degree=AVG_DEGREE, seed=s)
        if solver.bucket_of(g) == k0:
            return [g0, g]
    raise AssertionError(f"no seed up to {SEED + seeds} shares seed "
                         f"{SEED}'s bucket at scale {scale}")


def check_mesh_batch(mesh, smi: str) -> None:
    """Phase 17's batches (module docstring): ``solve_batch`` of
    MESH_BATCH_SCALE's bucket pair at each of MESH_BATCH_WIDTHS over the
    mesh and without it, each program recorded (its launches and calls
    counted just around the recording) and replayed."""
    t0 = time.perf_counter()
    probe = EulerSolver(n_parts=PARTS, device="cpu")
    graphs = bucket_pair(probe, MESH_BATCH_SCALE)
    prepared = {k: v for k, v in probe._prep_cache.items()
                if v[0] in graphs}
    for sharded in (True, False):
        phase3 = "sharded" if sharded else "replicated"
        plain = EulerSolver(n_parts=PARTS, sharded_phase3=sharded)
        over = EulerSolver(mesh=mesh, sharded_phase3=sharded)
        for solver in (plain, over):       # one host prep for all four
            solver._prep_cache.update(prepared)
        key = over.bucket_of(graphs[0])
        budget = fused_collective_budget(
            key[2], num_edges=key[0], n_parts=PARTS,
            sharded_phase3=True) if sharded \
            else fused_collective_budget(key[2])
        want = {k: v for k, v in expected_calls(budget, PARTS).items() if v}
        want["fetch"] = 2
        for B in MESH_BATCH_WIDTHS:
            batch = graphs * (B // 2)
            cold_p, (rec_p, _), _ = cells_recorded(plain.solve_batch, batch)
            warm_p = plain.solve_batch(batch)
            cold, (rec, calls), _ = cells_recorded(over.solve_batch, batch,
                                                   mesh=mesh)
            warm = over.solve_batch(batch)
            same = all(same_bytes(a.validate(), b) for a, b in
                       zip(cold + warm, cold_p + warm_p))
            say("mesh", run="batch", phase3=phase3, width=B,
                scale=MESH_BATCH_SCALE, e_cap=key[0],
                byte_identical_to_meshless=same,
                recorded_calls=json.dumps(calls, separators=(",", ":")),
                budget_calls=json.dumps(want, separators=(",", ":")),
                recorded_launches=json.dumps(rec, separators=(",", ":")),
                meshless_recorded_launches=json.dumps(
                    rec_p, separators=(",", ":")),
                run_s=f"{warm[0].timings['run_s']:.4f}",
                meshless_run_s=f"{warm_p[0].timings['run_s']:.4f}",
                warmup_s=f"{cold[0].timings['warmup_s']:.4f}",
                meshless_warmup_s=f"{cold_p[0].timings['warmup_s']:.4f}",
                capture_s=f"{cold[0].timings['capture_s']:.4f}",
                meshless_capture_s=f"{cold_p[0].timings['capture_s']:.4f}",
                smi=f"'{smi}'")
            if not same:
                raise AssertionError(f"the {phase3} B = {B} batch over the "
                                     f"mesh differs from the meshless one")
            if calls != want or rec != rec_p or not all(
                    rec[name] for name in PATH_KERNELS[sharded]):
                raise AssertionError(
                    f"the {phase3} B = {B} recording over the mesh called "
                    f"{calls} (budget {want}) and launched {rec} "
                    f"(meshless {rec_p})")
        del plain, over
        torch.cuda.empty_cache()
    say("mesh", part="batch", seconds=f"{time.perf_counter() - t0:.1f}")


def mesh_serve(mesh, extra: list) -> tuple:
    """One in-process ``main_euler`` run of phase 17 (phase 5g's
    arguments, then ``extra``, MESH_SERVE_REQUESTS requests) over
    ``mesh`` (None: without one), the launch counters set to 0 just
    before and read just after: ``(stats, {seq: result}, launches)``,
    every result validated."""
    delivered = []
    harvest = serve.MicroBatcher._harvest_one

    def kept(self):
        out = harvest(self)
        for _, r in out:
            r.validate()
        delivered.extend(out)
        return out
    with tempfile.TemporaryDirectory() as tmp, \
            mock.patch.object(serve.MicroBatcher, "_harvest_one", kept):
        path = Path(tmp) / "serve.json"
        reset_counts()
        serve.main_euler(SERVE_ARGS + extra + [
            "--requests", str(MESH_SERVE_REQUESTS), "--json", str(path)],
            mesh=mesh)
        launched = read_counts()
        stats = json.loads(path.read_text().splitlines()[-1])
    gc.collect()
    torch.cuda.empty_cache()
    return stats, dict(delivered), launched


def check_mesh_serve(mesh, smi: str) -> None:
    """Phase 17's serving loop (module docstring): ``main_euler`` over the
    mesh and without it at each of MESH_SERVE_DEPTHS (``--widths 8``:
    every flush of the closed loop fills the quota of 8;
    ``--sync-prewarm``), every request's circuit and mate byte-equal
    between the two."""
    t0 = time.perf_counter()
    for depth in MESH_SERVE_DEPTHS:
        extra = ["--widths", "8", "--sync-prewarm", "--pipeline-depth",
                 str(depth)]
        plain, want, _ = mesh_serve(None, extra)
        mesh.calls.clear()
        mesh.sent_bytes.clear()
        stats, got, launched = mesh_serve(mesh, extra)
        seqs = list(range(MESH_SERVE_REQUESTS))
        same = sorted(got) == seqs == sorted(want) and all(
            same_bytes(got[q], want[q]) for q in seqs)
        keys = ("circuits_per_s", "p50_ms", "p95_ms", "mean_flush",
                "compiles", "hits", "misses")
        say("mesh", run="serve", scale=9, parts=PARTS, pipeline_depth=depth,
            requests=MESH_SERVE_REQUESTS, served=stats["served"],
            byte_identical_to_meshless=same,
            broadcasts=mesh.calls["broadcast"],
            broadcast_bytes=mesh.sent_bytes["broadcast"],
            width_hist=f"'{json.dumps(stats['width_hist'], separators=(',', ':'))}'",
            launches=json.dumps(launched, separators=(",", ":")),
            **{k: stats[k] for k in keys},
            **{f"meshless_{k}": plain[k] for k in keys}, smi=f"'{smi}'")
        dispatches = sum(stats["width_hist"].values())
        if not same or stats["served"] != MESH_SERVE_REQUESTS:
            raise AssertionError(f"the serve over the mesh at depth {depth} "
                                 f"differs from the meshless one")
        if mesh.calls["broadcast"] != dispatches + 1 or not all(
                launched[name] for name in PATH_KERNELS[True]):
            raise AssertionError(
                f"the serve over the mesh broadcast "
                f"{mesh.calls['broadcast']} orders for {dispatches} "
                f"dispatches, or launched {launched}")
    say("mesh", part="serve", seconds=f"{time.perf_counter() - t0:.1f}")


def check_mesh_serve_adaptive(mesh, smi: str) -> None:
    """Phase 17's adaptive serve (module docstring): ``main_euler
    --adaptive`` without the mesh, then over it, every request's circuit
    and mate byte-equal between the two."""
    t0 = time.perf_counter()
    plain, want, _ = mesh_serve(None, MESH_ADAPTIVE_ARGS)
    mesh.calls.clear()
    mesh.sent_bytes.clear()
    stats, got, launched = mesh_serve(mesh, MESH_ADAPTIVE_ARGS)
    seqs = list(range(MESH_SERVE_REQUESTS))
    same = sorted(got) == seqs == sorted(want) and all(
        same_bytes(got[q], want[q]) for q in seqs)
    orders = stats["orders"]
    sent = mesh.sent_bytes["broadcast"]
    per = sent // max(mesh.calls["broadcast"], 1)
    keys = ("circuits_per_s", "p50_ms", "p95_ms", "first_wide_flush_s",
            "dispatches_before_wide", "mean_flush", "compiles", "hits",
            "misses", "tuner_steps", "async_prewarms", "pinned",
            "cache_bytes")
    say("mesh", run="serve_adaptive", scale=9, parts=PARTS,
        pipeline_depth=0, requests=MESH_SERVE_REQUESTS,
        served=stats["served"], byte_identical_to_meshless=same,
        orders=json.dumps(orders, separators=(",", ":")),
        broadcast_bytes=json.dumps({k: n * per for k, n in orders.items()},
                                   separators=(",", ":")),
        broadcasts=mesh.calls["broadcast"], broadcast_bytes_total=sent,
        width_hist=f"'{json.dumps(stats['width_hist'], separators=(',', ':'))}'",
        meshless_width_hist=f"'{json.dumps(plain['width_hist'], separators=(',', ':'))}'",
        launches=json.dumps(launched, separators=(",", ":")),
        drain_compiles=stats["drain_compiles"],
        drain_compile_s=stats["drain_compile_s"],
        **{k: stats[k] for k in keys},
        **{f"meshless_{k}": plain[k] for k in keys}, smi=f"'{smi}'")
    if not same or stats["served"] != MESH_SERVE_REQUESTS:
        raise AssertionError("the adaptive serve over the mesh differs "
                             "from the meshless one")
    if orders.get("prewarm", 0) < 1 or \
            not any(int(w) > 1 for w in stats["width_hist"]):
        raise AssertionError(f"the adaptive serve over the mesh ran no "
                             f"prewarm order or no wide flush: {orders}, "
                             f"{stats['width_hist']}")
    if mesh.calls["broadcast"] != sum(orders.values()) + 1 or not all(
            launched[name] for name in PATH_KERNELS[True]):
        raise AssertionError(
            f"the adaptive serve over the mesh broadcast "
            f"{mesh.calls['broadcast']} messages for the orders {orders}, "
            f"or launched {launched}")
    say("mesh", part="serve_adaptive",
        seconds=f"{time.perf_counter() - t0:.1f}")


def mesh_retune(mesh) -> dict:
    """One session of phase 17's retune (module docstring) over ``mesh``
    (None: meshless, the compile thread): the pool's bucket recorded at
    B = 1 and 8, the retune of its scale (over the mesh an order of a
    ``MicroBatcher``'s stream), then the pool's tight solves and a B = 8
    batch of the retuned bucket; the launch counters set to 0 just
    before the retune and read just after."""
    solver = (EulerSolver(n_parts=PARTS) if mesh is None
              else EulerSolver(mesh=mesh))
    pool = modal_bucket_pool(
        solver, (eulerian_rmat(9, avg_degree=AVG_DEGREE, seed=SEED + i)
                 for i in range(8 * 8)), 8)
    g = pool[0]
    key = solver.bucket_of(g)
    e_cap = key[0]
    solver.prewarm(g, [1, 8])
    captures = solver.captures
    svc = solver._ensure_compile_service()
    mb = None
    reset_counts()
    t0 = time.perf_counter()
    if mesh is None:
        solver.tighten(e_cap)
        ticket = svc.submit_retune(g, e_cap, [8])
        if not ticket.wait(timeout=600) or ticket.error is not None:
            raise AssertionError(f"[mesh] retune: the meshless retune job "
                                 f"failed: {ticket.error!r}")
        orders = {}
    else:
        mb = serve.MicroBatcher(solver, max_batch=8)
        ticket = svc.submit_retune(g, e_cap, [8], seq=0)
        mb.compile_next()
        mb.drain()
        orders = dict(mb.orders)
    retune_s = time.perf_counter() - t0
    launched = read_counts()
    recorded = solver.captures - captures
    tkey = solver.bucket_of(g)
    tight_keys = [solver.bucket_of(x) for x in pool]
    ones = [solver.solve(x).validate() for x in pool]
    members = [x for x, k in zip(pool, tight_keys) if k == tkey]
    eights = solver.solve_batch([members[i % len(members)]
                                 for i in range(8)])
    for r in eights:
        r.validate()
    out = dict(results=ones + eights, widths=list(ticket.widths),
               retune_s=retune_s, recorded=recorded, launched=launched,
               orders=orders, tight=tkey != key and tkey[0] == e_cap,
               tight_buckets=len(set(tight_keys)), b8_members=len(members),
               b8_hit=eights[0].cache.hit, captures=solver.captures)
    svc.stop()
    del solver, svc, mb, ones, eights
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_mesh_retune(mesh, smi: str) -> None:
    """Phase 17's retune order (module docstring), meshless then over
    the mesh, every result byte-equal between the two."""
    t0 = time.perf_counter()
    plain = mesh_retune(None)
    mesh.calls.clear()
    over = mesh_retune(mesh)
    same = len(over["results"]) == len(plain["results"]) and all(
        same_bytes(a, b) for a, b in zip(over["results"], plain["results"]))
    keys = ("widths", "recorded", "tight_buckets", "b8_members", "b8_hit",
            "captures")
    say("mesh", run="retune", scale=9, parts=PARTS,
        byte_identical_to_meshless=same,
        orders=json.dumps(over["orders"], separators=(",", ":")),
        broadcasts=mesh.calls["broadcast"],
        retune_s=f"{over['retune_s']:.3f}",
        meshless_retune_s=f"{plain['retune_s']:.3f}",
        launches=json.dumps(over["launched"], separators=(",", ":")),
        meshless_launches=json.dumps(plain["launched"],
                                     separators=(",", ":")),
        **{k: ",".join(map(str, over[k])) if k == "widths" else over[k]
           for k in keys},
        **{f"meshless_{k}": ",".join(map(str, plain[k])) if k == "widths"
           else plain[k] for k in keys}, smi=f"'{smi}'")
    if not same or not over["tight"] or over["widths"] != [1, 8] \
            or plain["widths"] != [1, 8]:
        raise AssertionError("[mesh] retune: the retune order did not "
                             "record the tight B = 1 and 8, or a result "
                             "differs from the meshless session's")
    if over["orders"] != {"retune": 1} or mesh.calls["broadcast"] != 2 \
            or over["recorded"] != 2 or plain["recorded"] != 2 \
            or not all(over["launched"][n] for n in PATH_KERNELS[True]):
        raise AssertionError(
            f"[mesh] retune: orders {over['orders']}, "
            f"{mesh.calls['broadcast']} broadcasts, recordings "
            f"{over['recorded']} (meshless {plain['recorded']}), launches "
            f"{over['launched']}")
    say("mesh", part="retune", seconds=f"{time.perf_counter() - t0:.1f}")


#: phase 18: the paper's Euler cells at euler-rmat-512's caps.  The
#: partitions a rank, cut from the config's 512 (one a device) to what
#: one card holds, and the largest Eulerian RMAT scale (average degree
#: 5, seed 0) whose partitions fit every cap there: at scale 12 a lane
#: overflows at the top merge (flag 3 of level 4,
#: ``tests/test_torch_cells.py``), and the main path's scale-20 graph
#: overflows the caps too
CELL_PARTS, CELL_SCALE = 16, 11
#: phase 18 (b): the dry run's time limit
DRYRUN_TIMEOUT = 600


def _same_tensors(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def cells_recorded(fn, *args, mesh=None):
    """``fn(*args)`` with the launch counters (and ``mesh``'s call
    counts) set to 0 just before each recording of a fused run and read
    just after, and the timings of every fused run fetched.  Returns
    ``(out, (launches, calls) recorded, timings)``."""
    recorded, timings = [], []
    record, wait = FusedRun._record, PendingRun.wait

    def counted(run):
        reset_counts()
        if mesh is not None:
            mesh.calls.clear()
        record(run)
        recorded.append((read_counts(),
                         None if mesh is None else dict(mesh.calls)))

    def kept(pending):
        out = wait(pending)
        timings.append(out[1])
        return out
    with mock.patch.object(FusedRun, "_record", counted), \
            mock.patch.object(PendingRun, "wait", kept):
        out = fn(*args)
    return out, (recorded[0] if recorded else (None, None)), timings[-1]


def check_cells_full(smi: str) -> dict:
    """Phase 18 (a) (module docstring).  Returns the fused cell's K1–K4
    launches recorded."""
    arch = get_config("euler-rmat")
    cfg = arch.model
    c, E, L = cfg.caps, cfg.fused_edges, cfg.n_levels
    t = time.perf_counter()
    g = eulerian_rmat(CELL_SCALE, avg_degree=AVG_DEGREE, seed=SEED)
    pg = partition_graph(g, partition_vertices(g, CELL_PARTS, seed=0))
    meshless = Engine(CELL_PARTS, c, L)
    st, anc = meshless.load(pg)
    anc = np.concatenate([anc, np.repeat(anc[-1:], L - anc.shape[0], 0)])
    sv = np.zeros(2 * E, np.int64)
    sv[:2 * g.num_edges] = stub_vertex(pg)
    state0, anc, sv = state_from_numpy(st, anc, sv, "cuda")
    prep_s = time.perf_counter() - t
    say("cells", config=cfg.name, arch="euler-rmat", scale=CELL_SCALE,
        parts=CELL_PARTS, vertices=g.num_vertices, edges=g.num_edges,
        fused_edges=E, n_levels=L, tree_height=Engine.plan(pg)[0].height,
        prep_s=f"{prep_s:.2f}", reduced=f"'partitions 512 -> {CELL_PARTS} "
        f"on one rank; graph G50-class -> RMAT scale {CELL_SCALE}'",
        smi=f"'{smi}'")
    with nccl_world():
        pm = make_part_mesh(CELL_PARTS)
        cells = {s: steps.build_cell(arch, s, pm) for s in arch.shapes}
        shapes = [tuple(x.shape) for x in
                  cells["superstep"].abstract_inputs[2]]
        if any(sh[0] != pm.m for sh in shapes):
            raise AssertionError(f"the cell's abstract state {shapes} is "
                                 f"not this rank's {pm.m} rows")
        # superstep: every level against the meshless engine's
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        state, plain, level_s, same, flags = state0, state0, [], True, True
        for lvl in range(L):
            t = drained_clock(pm.device)
            got = cells["superstep"].fn(lvl, anc, state)
            level_s.append(drained_clock(pm.device) - t)
            want = meshless.superstep(lvl, anc, plain)
            same &= _same_tensors((*got[0], *got[1:]),
                                  (*want[0], *want[1:]))
            flags &= bool(got[4].all())
            state, plain = got[0], want[0]
        launched = read_counts()
        say("cells", cell="superstep", levels=L, byte_identical=same,
            flags_all=flags, launches=sum(launched.values()),
            level_s="'" + ",".join(f"{x:.4f}" for x in level_s) + "'",
            peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
            reserved_gib=f"{torch.cuda.max_memory_reserved() / 2**30:.3f}")
        if not (same and flags) or any(launched.values()):
            raise AssertionError("the superstep cell differs from the "
                                 "meshless engine, overflowed a cap or "
                                 "launched a kernel")
        del state, plain, got, want
        # fused: record, then replay; the meshless run of the same caps
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out, (recorded, calls), cold = cells_recorded(
            cells["fused"].fn, anc, state0, sv, mesh=pm)
        peak = torch.cuda.max_memory_allocated()
        reserved = torch.cuda.max_memory_reserved()
        again, _, warm = cells_recorded(cells["fused"].fn, anc, state0, sv)
        run = meshless.fused_program(E)
        plain, (plain_recorded, _), _ = cells_recorded(
            lambda: run.launch(state0, anc, sv).wait()[0])
        m = g.num_edges
        same = all(np.array_equal(getattr(out, f), getattr(plain, f))
                   and np.array_equal(getattr(again, f), getattr(plain, f))
                   for f in ("circuit", "mate", "flags", "metrics",
                             "phase3_ok"))
        validate_circuit(g, out.circuit[:m])     # raises when invalid
        unmated = bool((out.circuit[m:] == -1).all()
                       and (out.mate[2 * m:] == -1).all())
        budget = {k: v for k, v in expected_calls(
            fused_collective_budget(L), CELL_PARTS).items() if v}
        budget["fetch"] = 2
        say("cells", cell="fused", edges=m, fused_edges=E,
            byte_identical_to_meshless=same, valid=True,
            padding_unmated=unmated, flags_all=bool(out.flags.all()),
            phase3_ok=bool(out.phase3_ok),
            recorded_launches=json.dumps(recorded, separators=(",", ":")),
            meshless_recorded_launches=json.dumps(plain_recorded,
                                                  separators=(",", ":")),
            recorded_calls=json.dumps(calls, separators=(",", ":")),
            budget_calls=json.dumps(budget, separators=(",", ":")),
            warmup_s=f"{cold['warmup_s']:.4f}",
            capture_s=f"{cold['capture_s']:.4f}",
            run_s=f"{warm['run_s']:.4f}", cold_run_s=f"{cold['run_s']:.4f}",
            peak_gib=f"{peak / 2**30:.3f}",
            reserved_gib=f"{reserved / 2**30:.3f}")
        rounds = p3.sharded_phase3_schedule(E, CELL_PARTS)["doubling_rounds"]
        if not (same and unmated and out.flags.all() and out.phase3_ok):
            raise AssertionError("the fused cell differs from the meshless "
                                 "run, overflowed or left padding mated")
        if recorded != plain_recorded or calls != budget or any(
                recorded[name] != rounds for name in PATH_KERNELS[False]):
            raise AssertionError(f"the fused cell recorded {recorded} "
                                 f"launches and {calls} calls; expected "
                                 f"the meshless {plain_recorded}, "
                                 f"{rounds} of K1/K2, and {budget}")
        # the mesh's graph holds NCCL's kernels: free it before the group
        cells["fused"].engine.evict_program(E, None)
        run.free()
        del cells, out, again, plain, run, meshless
        torch.cuda.empty_cache()
    return recorded


def check_overflow_cell(scale: int, smi: str) -> None:
    """``--overflow-cell``: the meshless fused run of euler-rmat-512's
    full caps (CELL_PARTS partitions, replicated Phase 3, ``fused_edges``
    stubs) on the main path's graph at ``scale``, which overflows the
    caps and leaves the walk's start without a predecessor: it must
    return its flags (recorded, then replayed with the same bytes), with
    K1 and K2 launched on the records that hold the halt at −1."""
    cfg = get_config("euler-rmat").model
    c, E, L = cfg.caps, cfg.fused_edges, cfg.n_levels
    t = time.perf_counter()
    g = eulerian_rmat(scale, avg_degree=AVG_DEGREE, seed=SEED)
    pg = partition_graph(g, partition_vertices(g, CELL_PARTS, seed=0))
    eng = Engine(CELL_PARTS, c, L)
    st, anc = eng.load(pg)
    anc = np.concatenate([anc, np.repeat(anc[-1:], L - anc.shape[0], 0)])
    sv = np.zeros(2 * E, np.int64)
    sv[:2 * g.num_edges] = stub_vertex(pg)
    inputs = state_from_numpy(st, anc, sv, "cuda")
    prep_s = time.perf_counter() - t
    run = eng.fused_program(E)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    out, cold = run.launch(*inputs).wait()
    launched = read_counts()
    again, warm = run.launch(*inputs).wait()
    failed = sorted({(int(lv), int(f)) for lv, f in
                     zip(*np.nonzero(~out.flags.all(0)))})
    same = all(np.array_equal(a, b) for a, b in zip(out, again))
    say("overflow", config=cfg.name, scale=scale, parts=CELL_PARTS,
        edges=g.num_edges, fused_edges=E, phase3="replicated",
        flags_all=bool(out.flags.all()), failed_level_flags=f"'{failed}'",
        phase3_ok=bool(out.phase3_ok),
        halt_unmated=bool(out.mate[int(np.argmax(out.mate >= 0)) ^ 1] < 0),
        replay_byte_equal=same,
        launches=json.dumps(launched, separators=(",", ":")),
        prep_s=f"{prep_s:.2f}", warmup_s=f"{cold['warmup_s']:.4f}",
        capture_s=f"{cold['capture_s']:.4f}",
        cold_run_s=f"{cold['run_s']:.4f}", run_s=f"{warm['run_s']:.4f}",
        peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
        reserved_gib=f"{torch.cuda.max_memory_reserved() / 2**30:.3f}",
        smi=f"'{smi}'")
    if not same or out.flags.all() or not all(
            launched[name] for name in PATH_KERNELS[False]):
        raise AssertionError("the overflowing full-caps run did not return "
                             "its flags, differs on a replay or skipped "
                             "K1/K2")
    run.free()


def check_dryrun(smi: str) -> None:
    """Phase 18 (b): ``python -m repro_torch.launch.dryrun --arch
    euler-rmat --both-meshes`` in a process of its own; every cell must
    report its per-rank memory and collective bytes."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as tmp:
        out = Path(tmp) / "dryrun.json"
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "euler-rmat", "--both-meshes", "--json", str(out)],
            env=env, capture_output=True, text=True, timeout=DRYRUN_TIMEOUT)
        seconds = time.perf_counter() - t
        for line in p.stdout.splitlines():
            if line.strip():
                print(line, flush=True)
        if p.returncode:
            raise AssertionError(f"the dry run exited {p.returncode}: "
                                 f"{p.stderr[-3000:]}")
        recs = json.loads(out.read_text())
    for r in recs:
        mem = r["memory"]
        say("dryrun", cell=r["shape"], mesh="x".join(map(str, r["mesh"])),
            world=r["world"], per_rank=r["partitions_per_rank"],
            argument_bytes=mem["argument_bytes"],
            output_bytes=mem["output_bytes"],
            peak_bytes=mem["peak_allocated_bytes"],
            reserved_bytes=mem["peak_reserved_bytes"],
            model_bytes=mem["program_cost_bytes"],
            collective_bytes=json.dumps(r["collectives"]["sent_bytes"],
                                        separators=(",", ":")),
            calls=json.dumps(r["collectives"]["calls"],
                             separators=(",", ":")),
            launches=json.dumps(r["launches"], separators=(",", ":")),
            call_s=f"{r['call_s']:.4f}",
            replay_s=None if r["replay_s"] is None
            else f"{r['replay_s']:.4f}",
            dominant=r["dominant"], smi=f"'{smi}'")
    cells = sorted((r["shape"], r["world"]) for r in recs)
    if cells != [("fused", 256), ("fused", 512), ("superstep", 256),
                 ("superstep", 512)] or any(
            not r["memory"]["peak_allocated_bytes"]
            or not r["collectives"]["sent_bytes"] for r in recs):
        raise AssertionError(f"the dry run reported {cells}, or a cell "
                             f"without its memory or collective bytes")
    say("dryrun", seconds=f"{seconds:.1f}")


# ------------------------------------------------------------ phase 19 --

#: phase 19: the LM over a DeviceMesh (one NCCL rank, mesh (1, 1)):
#: SmolLM-360M at full width and depth, bf16, seeded; the train cell at
#: phase 11's throughput shape, the serving prefill and decode at phase
#: 9's
LM_MESH_ARCH = "smollm-360m"
LM_MESH_TRAIN = (8, 1024, 3)          # batch, seq, steps
LM_MESH_SERVE = (4, 4096, 32)         # batch, prompt, decode steps
#: mesh against meshless in bf16 (``allclose`` rtol and atol)
LM_MESH_TOL = 3e-2
#: the train cell's AdamW step before phase 19's steps: warmup_cosine's
#: learning rate there is 1.5e-4, where step 0's is 0 and steps 1–2's
#: are too small to move a bf16 weight
LM_MESH_WARM_STEP = 1000
#: mesh against meshless after the train steps, each leaf's ‖difference‖
#: over its ‖meshless value‖, for the parameters' updates and both f32
#: moments (a wrong gradient is off by its own size); the steps must
#: also move the weights by more than this
LM_MESH_STATE_TOL = 1e-3
#: the dry run's rows that phase 19 runs (the others run through the CLI)
LM_DRYRUN_ARCH = "granite-20b"


def _wide_cache(cfg, cache, batch: int, prompt: int, gen: int, dev):
    """A meshless cache of ``prompt + gen`` rows holding ``cache``."""
    wide = tr.init_kv_cache(cfg, batch, prompt + gen, fill=prompt, device=dev)
    wide.k[:, :, :prompt] = cache.k
    wide.v[:, :, :prompt] = cache.v
    return wide


def _comm_counts(fn):
    """``fn()`` under ``dryrun.CommCount``: (its result, calls, bytes
    sent by collective)."""
    from repro_torch.launch import dryrun

    counter = dryrun.CommCount()
    with counter:
        out = fn()
    calls = {getattr(k, "__name__", str(k)): v
             for k, v in counter.get_comm_counts().items()}
    return out, calls, dict(counter.sent_bytes)


def _mesh_close(a, b) -> tuple:
    """(``allclose`` at ``LM_MESH_TOL``, the largest difference)."""
    a, b = a.float(), b.float()
    return (torch.allclose(a, b, rtol=LM_MESH_TOL, atol=LM_MESH_TOL),
            (a - b).abs().max().item())


def lm_mesh_train(dev, mesh, cfg, params, smi: str) -> None:
    """Phase 19 (a): the train cell over the mesh and without it, the same
    weights, batches and warm AdamW state, each step timed alone; then
    one more mesh step under ``dryrun.CommCount`` (a dispatch mode that
    sees every op, so it is not timed) for the collectives."""
    from repro_torch.parallel import sharding as shd

    batch, seq, n = LM_MESH_TRAIN
    arch = dataclasses.replace(get_config(LM_MESH_ARCH), shapes={
        "train": ShapeCell("train", "train", batch=batch, seq_len=seq)})
    data = SyntheticLM(cfg.vocab, seq, batch)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in data.batch_at(i).items()} for i in range(n)]
    runs = {}
    for where in ("mesh", "meshless"):
        m = mesh if where == "mesh" else None
        cell = steps.build_cell(arch, "train", m)
        p = tree_map(torch.clone, params)
        opt = init_adamw(p)._replace(step=torch.tensor(
            LM_MESH_WARM_STEP, dtype=torch.int32, device=dev))
        if m is not None:
            p, opt = steps.place_lm_state(m, p, opt)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        times, losses, calls, sent = [], [], {}, {}
        for i in range(n):
            b = batches[i] if m is None else \
                shd.distribute(batches[i], cell.in_shardings[2])
            torch.cuda.synchronize()
            t = time.perf_counter()
            p, opt, loss = cell.fn(p, opt, b)
            loss = loss.full_tensor() if m is not None else loss
            losses.append(float(loss))
            times.append(time.perf_counter() - t)
        # copies: the counted step below updates the state in place
        runs[where] = (losses, *(tree_map(
            lambda t: (t.full_tensor() if m is not None else t).clone(),
            tree) for tree in (p, opt.m, opt.v)))
        if m is not None:
            _, calls, sent = _comm_counts(lambda: cell.fn(p, opt, b))
        say("lm-mesh", check="train", run=where, config=cfg.name,
            batch=batch, seq=seq, steps=n,
            step_ms="'" + ",".join(f"{x * 1e3:.1f}" for x in times) + "'",
            losses="'" + ",".join(f"{x:.5f}" for x in losses) + "'",
            peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
            reserved_gib=f"{torch.cuda.max_memory_reserved() / 2**30:.3f}",
            collectives=json.dumps(calls, separators=(",", ":")),
            sent_bytes=json.dumps(sent, separators=(",", ":")),
            smi=f"'{smi}'")
        del p, opt, cell
    (lm, *mesh_state), (ll, *meshless_state) = runs["mesh"], runs["meshless"]
    loss_ok, loss_err = _mesh_close(torch.tensor(lm), torch.tensor(ll))

    def rel(a, b):
        """‖a − b‖ / ‖b‖ over a leaf in f32 (0 where a equals b): a few
        bf16 roundings that land on the other side barely move it, a
        wrong gradient moves it by its own size."""
        d = (a.float() - b.float()).norm()
        return 0.0 if d == 0 else (d / b.float().norm()).item()

    # the params by their updates: the norms' weights (all 1) stay put
    start = tree_leaves(params)
    errs = {"params": max(rel(a.float() - p0.float(), b.float() - p0.float())
                          for a, b, p0 in zip(tree_leaves(mesh_state[0]),
                                              tree_leaves(meshless_state[0]),
                                              start))}
    errs.update({name: max(rel(a, b) for a, b in zip(tree_leaves(x),
                                                     tree_leaves(y)))
                 for name, x, y in zip(("m", "v"), mesh_state[1:],
                                       meshless_state[1:])})
    # how far the meshless steps moved the weights: ‖Δ‖ / ‖p‖, all of them
    moved = math.sqrt(
        sum(float((b.float() - p0.float()).norm() ** 2)
            for b, p0 in zip(tree_leaves(meshless_state[0]), start))
        / sum(float(p0.float().norm() ** 2) for p0 in start))
    state_ok = max(errs.values()) <= LM_MESH_STATE_TOL < moved
    say("lm-mesh", check="train_vs_meshless", loss_max_abs=f"{loss_err:.6f}",
        warm_step=LM_MESH_WARM_STEP,
        **{f"{k}_max_rel": f"{v:.3e}" for k, v in errs.items()},
        params_moved_rel=f"{moved:.3e}", ok=loss_ok and state_ok)
    if not (loss_ok and state_ok):
        raise AssertionError("the train cell over the mesh differs from "
                             "the meshless one, or its steps did not move "
                             "the weights")
    del runs, mesh_state, meshless_state, start


def lm_mesh_serve(dev, mesh, cfg, params, smi: str) -> int:
    """Phase 19 (b): the prefill and decode cells over the mesh beside
    meshless eager steps, fed the same tokens; returns the mesh
    prefill's K6 launches."""
    from repro_torch.parallel import sharding as shd

    batch, prompt, gen = LM_MESH_SERVE
    arch = dataclasses.replace(get_config(LM_MESH_ARCH), shapes={
        "prefill": ShapeCell("prefill", "prefill", batch=batch,
                             seq_len=prompt),
        "decode": ShapeCell("decode", "decode", batch=batch,
                            seq_len=prompt + gen + 1)})
    gen_t = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (batch, prompt), generator=gen_t,
                           device=dev, dtype=torch.int32)
    pre = steps.build_cell(arch, "prefill", mesh)
    dec = steps.build_cell(arch, "decode", mesh)    # room for gen + 1
    placed = steps.place_lm_state(mesh, params)
    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    with torch.no_grad():
        toks = shd.distribute(tokens, pre.in_shardings[1])
        # cold, then warm, each way; K6 counted around the first mesh call
        (want, cache), meshless_s = timed(
            lambda: tr.prefill_step(params, cfg, tokens))
        _, meshless_warm_s = timed(
            lambda: tr.prefill_step(params, cfg, tokens))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        (got, mcache), mesh_s = timed(lambda: pre.fn(placed, toks))
        k6 = read_counts()["flash_attention"]
        _, mesh_warm_s = timed(lambda: pre.fn(placed, toks))
        _, calls, sent = _comm_counts(lambda: pre.fn(placed, toks))
        pre_ok, pre_err = _mesh_close(got.full_tensor(), want)
        say("lm-mesh", check="prefill", batch=batch, prompt=prompt,
            k6_launches=k6, logits_max_abs=f"{pre_err:.6f}", ok=pre_ok,
            mesh_s_cold_warm=f"{mesh_s:.4f}/{mesh_warm_s:.4f}",
            meshless_s_cold_warm=f"{meshless_s:.4f}/{meshless_warm_s:.4f}",
            peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
            reserved_gib=f"{torch.cuda.max_memory_reserved() / 2**30:.3f}",
            collectives=json.dumps(calls, separators=(",", ":")),
            sent_bytes=json.dumps(sent, separators=(",", ":")),
            smi=f"'{smi}'")
        wide = _wide_cache(cfg, cache, batch, prompt, gen + 1, dev)
        mwide = _wide_cache(cfg, tr.KVCache(
            mcache.k.full_tensor(), mcache.v.full_tensor(),
            mcache.length.full_tensor()), batch, prompt, gen + 1, dev)
        mwide = shd.distribute(mwide, dec.in_shardings[1])
        del cache, mcache
        nxt = want.argmax(-1).to(torch.int32)
        worst, same, times = 0.0, True, {"mesh": [], "meshless": []}
        for step in range(gen):
            (lw, wide), s_ = timed(
                lambda: tr.decode_step(params, cfg, wide, nxt))
            times["meshless"].append(s_)
            tk = shd.distribute(nxt, dec.in_shardings[2])
            (lg, mwide), s_ = timed(lambda: dec.fn(placed, mwide, tk))
            times["mesh"].append(s_)
            ok, err = _mesh_close(lg.full_tensor(), lw)
            same = same and ok
            worst = max(worst, err)
            nxt = lw.argmax(-1).to(torch.int32)
        # one more step under the counter (the cache has room: gen + 1)
        tk = shd.distribute(nxt, dec.in_shardings[2])
        _, dcalls, dsent = _comm_counts(lambda: dec.fn(placed, mwide, tk))
        say("lm-mesh", check="decode", batch=batch, steps=gen,
            context=prompt + gen, logits_max_abs=f"{worst:.6f}", ok=same,
            mesh_ms_median=f"{statistics.median(times['mesh']) * 1e3:.2f}",
            meshless_ms_median=f"{statistics.median(times['meshless']) * 1e3:.2f}",
            peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
            reserved_gib=f"{torch.cuda.max_memory_reserved() / 2**30:.3f}",
            collectives=json.dumps(dcalls, separators=(",", ":")),
            sent_bytes=json.dumps(dsent, separators=(",", ":")),
            smi=f"'{smi}'")
    if not (pre_ok and same) or k6 != cfg.n_layers:
        raise AssertionError(f"prefill ok={pre_ok}, decode ok={same}, K6 "
                             f"launched {k6} times in a mesh prefill, "
                             f"expected {cfg.n_layers}")
    del placed, wide, mwide
    return k6


def check_lm_dryrun(smi: str) -> None:
    """Phase 19 (c): ``python -m repro_torch.launch.dryrun --arch
    granite-20b`` in a process of its own: the three dense-LM rows on
    rank 0 of a ``fake`` world of 256 (``long_500k`` skipped), each with
    its memory and the collectives DTensor issued."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lmdry_") as tmp:
        out = Path(tmp) / "dryrun.json"
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             LM_DRYRUN_ARCH, "--json", str(out)],
            env=env, capture_output=True, text=True, timeout=DRYRUN_TIMEOUT)
        seconds = time.perf_counter() - t
        for line in p.stdout.splitlines():
            if line.strip():
                print(line, flush=True)
        if p.returncode:
            raise AssertionError(f"the LM dry run exited {p.returncode}: "
                                 f"{p.stderr[-3000:]}")
        recs = json.loads(out.read_text())
    ran = [r for r in recs if "skip" not in r]
    for r in ran:
        mem = r["memory"]
        say("lm-dryrun", arch=r["arch"], cell=r["shape"],
            mesh="x".join(map(str, r["mesh"])), world=r["world"],
            argument_bytes=mem["argument_bytes"],
            output_bytes=mem["output_bytes"],
            peak_bytes=mem["peak_allocated_bytes"],
            reserved_bytes=mem["peak_reserved_bytes"],
            calls=json.dumps(r["collectives"]["calls"],
                             separators=(",", ":")),
            sent_bytes=json.dumps(r["collectives"]["sent_bytes"],
                                  separators=(",", ":")),
            launches=json.dumps(r["launches"], separators=(",", ":")),
            call_s=f"{r['call_s']:.4f}", dominant=r["dominant"],
            smi=f"'{smi}'")
    if sorted(r["shape"] for r in ran) != ["decode_32k", "prefill_32k",
                                           "train_4k"] or any(
            not r["memory"]["peak_allocated_bytes"]
            or not r["collectives"]["calls"] for r in ran):
        raise AssertionError(f"the LM dry run ran {[r['shape'] for r in ran]}"
                             f", or a row without its memory or "
                             f"collectives")
    say("lm-dryrun", seconds=f"{seconds:.1f}")


def check_lm_mesh(dev, smi: str) -> int:
    """Phase 19 (module docstring); returns the mesh prefill's K6
    launches."""
    from repro_torch.launch.mesh import make_test_mesh

    t0 = time.perf_counter()
    cfg = get_config(LM_MESH_ARCH).model
    with nccl_world():
        mesh = make_test_mesh(1, tp=1)
        params = tr.init_lm_params(
            torch.Generator(device=dev).manual_seed(0), cfg)
        lm_mesh_train(dev, mesh, cfg, params, smi)
        k6 = lm_mesh_serve(dev, mesh, cfg, params, smi)
        del params, mesh
        gc.collect()
    torch.cuda.empty_cache()
    check_lm_dryrun(smi)
    say("lm-mesh", seconds=f"{time.perf_counter() - t0:.1f}")
    return k6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=20,
                    help="RMAT scale of the main-path graph (default 20; "
                         "cut it, never the partitions, for a quick check)")
    ap.add_argument("--overflow-cell", action="store_true",
                    help="after the build, run only euler-rmat-512's full "
                         "caps on the main path's graph, which overflows "
                         "them (check_overflow_cell)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    def phase_done(phase: str) -> None:
        say("timing", after_phase=phase,
            elapsed_s=f"{time.perf_counter() - t_start:.1f}")

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
    phase_done("2")
    if args.overflow_cell:
        check_overflow_cell(args.scale, smi)
        phase_done("overflow")
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    # ---- 3. kernels against their twins at the main path's width ----
    rounds = p3.sharded_phase3_schedule(N_MAIN // 2, PARTS)["doubling_rounds"]
    table = check_kernels(dev, rounds)
    table["loop_condition"] = check_loop_condition(dev, (16, 54))
    phase_done("3")

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
    phase_done("4")

    # ---- 4b. repair: an overflowing solve returns its flags ----
    check_repair(smi)
    phase_done("4b")

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
    phase_done("5")

    # ---- 5b. the fused run: one recorded graph per bucket (5c's repeat
    # solve and 5d's pipelined pair at the main scale run in its sharded
    # session) ----
    launches["loop_condition"] = check_fused(args.scale, g, results,
                                             loop_rounds)
    torch.cuda.empty_cache()       # g and results stay for phase 17
    phase_done("5b")

    # ---- 5c. the session: solve_many, two live graphs, evictions ----
    check_session()
    phase_done("5c")

    # ---- 5d. asynchronous solves: in flight, out of order, evicted ----
    check_async_small()
    phase_done("5d")

    # ---- 5e. batched solves: one program per (bucket, B) ----
    check_batch(dev)
    check_batch_large(args.scale - 3, smi)
    phase_done("5e")

    # ---- 5f. the reference's host engine beside the device solve ----
    check_host(args.scale - 4, smi)
    phase_done("5f")

    # ---- 5g. the Euler serving loop and the program byte budget ----
    check_serve(args.scale, smi)
    phase_done("5g")

    # ---- 6–7. K5 and K6 against their twins, timed ----
    table["segment_sum_sorted"] = check_k5(dev)
    table["flash_attention"] = check_k6(dev)
    phase_done("6–7")

    # ---- 8. small LM parity: cuda against cpu ----
    check_lm_parity(dev)
    phase_done("8")

    # ---- 9. the LM serving path at full width ----
    counts = check_lm_slice(dev, smi)
    launches["segment_sum_sorted"] = counts["segment_sum_sorted"]
    launches["flash_attention"] = counts["flash_attention"]
    phase_done("9")

    # ---- 10. the program audit, planted faults, the first-record charge
    check_audit(smi)
    phase_done("10")

    # ---- 11. the LM trainer: parity, the entry point, throughput ----
    check_train(dev, smi)
    phase_done("11")

    # ---- 12. the MoE LM: parity, one layer, the slice, 2 layers in f32 --
    check_moe(dev, smi)
    phase_done("12")

    # ---- 13. the GNN family: parity, Cora at full width, sampled blocks --
    check_gnn(dev, smi)
    phase_done("13")

    # ---- 14. AutoInt: parity, train, serve and retrieve at full config --
    check_recsys(dev, smi)
    phase_done("14")

    # ---- 15. NequIP: parity, the symmetry, the cells at full size ----
    check_nequip(dev, smi)
    phase_done("15")

    # ---- 16. the code LMs: reduced and 2-layer parity, K6, full width --
    check_code_lms(dev, smi)
    phase_done("16")

    # ---- 17. the engine across ranks: one NCCL rank, all 8 partitions --
    check_mesh(args.scale, g, results, smi)
    del results, g
    PREPARED.clear()
    phase_done("17")

    # ---- 18. the Euler cells at the full config's caps; the dry run ----
    t = time.perf_counter()
    torch.cuda.empty_cache()
    for name, n in check_cells_full(smi).items():
        launches[name] += n
    check_dryrun(smi)
    say("cells", seconds=f"{time.perf_counter() - t:.1f}")
    phase_done("18")

    # ---- 19. the LM over a DeviceMesh: train, serve, the dry run's rows --
    launches["flash_attention"] += check_lm_mesh(dev, smi)
    phase_done("19")

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
