"""The autotuner across ranks: ``AutoTuner`` on rank 0 of
``make_part_mesh(8, device="cpu")`` over gloo worlds of 1, 2 and 4
ranks, its recordings, retunes and pins carried out on every rank as
orders of rank 0's stream (``MicroBatcher.order``, ``compile_next``,
``follow``), and ``main_euler --mesh --adaptive``.

Each world runs the adaptive scenario of tests/test_torch_autotune.py
(scale 5, P = 8, the modal bucket's first four members, ``max_batch=2``,
``min_interval=0``) with rank 0 leading: two B=1 flushes, a forced tuner
step whose decision is exactly ``[(key, 2)]``, its prewarm order, a B=2
flush, then a request whose graph no rank prepared before (pending), a
retune order (the tighten, the rekey and the tight bucket's recordings
at one point on every rank), a repeat of member 0 that fills the
pending request's tight bucket, their B=2 flush, and the four members'
tight solves, which every rank calls.  Every circuit and mate is the
JAX package's (the golden ``tests/golden/torch_autotune_reference.npz``)
or a meshless solve's, on every rank; every rank ends with the same
programs in the same LRU order, the same pins, tight scales and charged
bytes, and the same orders; no rank starts a compile thread.  A queue
that holds a repeated graph and two first-seen ones across a retune is
queued again by the graphs' tight buckets, which part two of them.  A
byte charge that differs across ranks (planted: rank r trues up (r +
1)·X) is charged as its largest on every rank, which then evicts
alike.  Each world's ranks run in processes of their own,
spawned once for the module (``python tests/test_torch_mesh_adaptive.py
--rank r --world W ...``), each with its own time limit and gloo group
timeout; the serving CLI with ``--adaptive`` runs once over two gloo
ranks under ``torch.distributed.run``."""
import argparse
import dataclasses
import datetime
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.euler import EulerSolver
from repro_torch.euler.autotune import AutoTuner, CompileService, TunerParams
from repro_torch.graphgen.eulerize import eulerian_rmat
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.serve import MicroBatcher, mask_widths, widths_mask

WORLDS = (1, 2, 4)
#: the worlds that can plant a byte charge that differs across ranks
SPLIT_WORLDS = (2, 4)
#: the adaptive scenario: tests/test_torch_autotune.py's pool
SCALE, PARTS, CANDIDATES, GROUP = 5, 8, 40, 4
QUOTA = 2
#: the orders rank 0's scenario makes: four dispatches (B=1, B=1, B=2 and
#: the tight B=2), the tuner's pin of the B=1 program and its prewarm of
#: B=2, and the retune
ORDERS = {"dispatch": 4, "pin": 1, "prewarm": 1, "retune": 1}
#: the rebucketing case: a queue of 4 at most, and its orders (the tight
#: B=2 of member 0 and a first-seen graph, the other first-seen graph's
#: B=1, the retune between them and the queue's arrivals)
REBUCKET_QUOTA = 4
REBUCKET_ORDERS = {"dispatch": 2, "retune": 1}
#: each spawned rank's time limit, about seven times the 40 s this
#: module's fixture took in the suite's parallel run on a shared 8-core
#: CPU (15 s alone)
LIVE_TIMEOUT = 300
GROUP_TIMEOUT = 60
TESTS = Path(__file__).resolve().parent
GOLDEN = TESTS / "golden" / "torch_autotune_reference.npz"
SRC = str(TESTS.parent / "src")


def modal_group(solver):
    """tests/test_torch_autotune.py's pool: ``(key, [(seed, graph)])``."""
    sys.path.insert(0, str(TESTS))
    from test_torch_autotune import _modal_group

    return _modal_group(solver)


def first_seen(key, graph0):
    """Two graphs past the candidates that no rank prepared before, both
    in member 0's bucket ``key``: ``"with"``, the first whose tight
    bucket is member 0's, and ``"apart"``, the first whose tight bucket
    is another; ``{name: (seed, graph)}``.  Meshless probe sessions, one
    on each profile, bucket them."""
    default = EulerSolver(n_parts=PARTS, device="cpu")
    tight = EulerSolver(n_parts=PARTS, device="cpu")
    tight.tighten(key[0])
    tkey = tight.bucket_of(graph0)
    found, seed = {}, CANDIDATES
    while len(found) < 2:
        g = eulerian_rmat(SCALE, avg_degree=5, seed=seed)
        seed += 1
        try:
            if default.bucket_of(g) != key:
                continue
        except ValueError:          # fewer than PARTS non-empty parts
            continue
        name = "with" if tight.bucket_of(g) == tkey else "apart"
        found.setdefault(name, (seed - 1, g))
    return found


def names(pairs) -> np.ndarray:
    """``(bucket, width)`` pairs as strings, in order (to hold the ranks'
    program sets equal)."""
    return np.array([f"{k[0]}/{k[2]}/{dataclasses.astuple(k[3])}/B{w}"
                     for k, w in pairs])


# ----------------------------------------------------------------------
# one rank (this file run as a script)
# ----------------------------------------------------------------------
def scenario(group, rec: dict) -> None:
    """The adaptive scenario on this rank (module docstring)."""
    mesh = mesh_mod.make_part_mesh(PARTS, group, device="cpu")
    solver = EulerSolver(mesh=mesh)
    key, members = modal_group(solver)
    graphs = [g for _, g in members]
    e_cap = key[0]
    seed, extra = first_seen(key, graphs[0])["with"]
    rec["scenario/extra_seed"] = np.array(seed)
    # request i is graphs[i]: the four members, the first-seen graph,
    # then member 0 again
    graphs += [extra, graphs[0]]
    resolve = graphs.__getitem__
    tuner = None
    if mesh.rank == 0:
        tuner = AutoTuner(solver, max_batch=QUOTA,
                          params=TunerParams(min_interval=0.0))
    else:
        try:
            AutoTuner(solver, max_batch=QUOTA)
            rec["scenario/follower_tuner"] = np.array("made")
        except RuntimeError as e:
            rec["scenario/follower_tuner"] = np.array(str(e))
    mb = MicroBatcher(solver, max_batch=QUOTA, deadline_s=0.0,
                      autotuner=tuner)
    mesh.calls.clear()
    mesh.sent_bytes.clear()
    if tuner is not None:
        done = {}
        for i in (0, 1):
            done.update(mb.submit(i, graphs[i]))
        done.update(mb.poll())
        rec["scenario/narrow"] = np.array(list(mb.flushes.recent))
        dec = tuner.step(force=True)
        rec["scenario/decision"] = np.array(
            [int(k == key) * w for k, w, _ in dec.prewarm])
        rec["scenario/compiled"] = np.array(mb.compile_next())
        rec["scenario/warm_after_prewarm"] = np.array(
            solver.warmed_widths(key))
        for i in (2, 3):
            done.update(mb.submit(i, graphs[i]))
        done.update(mb.poll())
        # a graph no rank prepared before waits in the default bucket
        # (memoized here at its arrival, as without a mesh) while the
        # retune order tightens, rekeys and records the scale
        done.update(mb.submit(4, graphs[4]))
        rec["scenario/extra_memoized"] = np.array(
            id(graphs[4]) in solver._prep_cache)
        tuner.service.submit_retune(graphs[0], e_cap, [QUOTA], seq=0)
        rec["scenario/retuned"] = np.array(mb.compile_next())
        rec["scenario/pending"] = names([(k, len(q))
                                         for k, q in mb.pending.items()])
        # member 0 again fills the pending request's tight bucket
        done.update(mb.submit(5, graphs[5]))
        done.update(mb.drain())
        done = sorted(done.items())
        tuner.close()
    else:
        done = mb.follow(resolve)
    rec["scenario/widths"] = np.array(list(mb.flushes.recent))
    rec["scenario/seqs"] = np.array([q for q, _ in done])
    for q, r in done:
        r.validate()
        rec[f"scenario/{q}/circuit"] = r.circuit
        rec[f"scenario/{q}/mate"] = r.mate
        rec[f"scenario/{q}/bucket"] = names([(r.cache.bucket, 1)])
    rec["scenario/orders"] = np.array(
        [f"{k}={n}" for k, n in sorted(mb.orders.items())])
    rec["scenario/broadcasts"] = np.array(mesh.calls["broadcast"])
    rec["scenario/broadcast_bytes"] = np.array(mesh.sent_bytes["broadcast"])
    rec["scenario/order_bytes"] = np.array(mb.order_bytes)
    tkey = solver.bucket_of(graphs[0])
    rec["scenario/tight_key"] = names([(tkey, 1)])
    rec["scenario/tight_key_differs"] = np.array(tkey != key)
    rec["scenario/warm_tight"] = np.array(solver.warmed_widths(tkey))
    for i in range(GROUP):                # every rank calls each
        r = solver.solve(graphs[i]).validate()
        rec[f"tight/{i}/circuit"] = r.circuit
        rec[f"tight/{i}/mate"] = r.mate
        rec[f"tight/{i}/park_cap"] = np.array(r.cache.bucket[3].park_cap)
    rec["books/live"] = names(solver.live_programs())
    rec["books/pinned"] = names(solver.pinned_programs())
    rec["books/warm_default"] = np.array(solver.warmed_widths(key))
    rec["books/tight_scales"] = np.array(solver.tightened_scales())
    rec["books/bytes"] = np.array(solver.cache_bytes_used())
    rec["books/captures"] = np.array(solver.cache_stats.traces)
    svc = solver.compile_service
    rec["threads/service_thread"] = np.array(
        svc is not None and svc._thread is not None)
    rec["threads/compile_service"] = np.array(any(
        t.name == "compile-service" for t in threading.enumerate()))
    rec["threads/jobs"] = np.array(0 if svc is None else svc.prewarms)


def rebucket(group, rec: dict) -> None:
    """One queue across a retune: member 0 (recorded before on every
    rank) and the two first-seen graphs, ``"apart"`` then ``"with"``,
    wait in the default bucket under a quota of 4; a retune order; then
    the drain.  Member 0 and ``"with"`` flush together at B=2 in the
    tight bucket the retune recorded, ``"apart"`` alone at B=1."""
    mesh = mesh_mod.make_part_mesh(PARTS, group, device="cpu")
    solver = EulerSolver(mesh=mesh)
    key, members = modal_group(solver)
    graph0 = members[0][1]
    extra = first_seen(key, graph0)
    graphs = [graph0, extra["apart"][1], extra["with"][1]]
    solver.prewarm(graph0, [1, 2])        # every rank, at the same point
    mb = MicroBatcher(solver, max_batch=REBUCKET_QUOTA, deadline_s=3600.0)
    if mesh.rank == 0:
        for i, g in enumerate(graphs):
            mb.submit(i, g)
        rec["rebucket/queued"] = np.array(sorted(
            len(q) for q in mb.pending.values()))
        solver._ensure_compile_service().submit_retune(graph0, key[0], [2],
                                                       seq=0)
        mb.compile_next()
        rec["rebucket/requeued"] = np.array(sorted(
            len(q) for q in mb.pending.values()))
        done = mb.drain()
    else:
        done = mb.follow(graphs.__getitem__)
    rec["rebucket/widths"] = np.array(list(mb.flushes.recent))
    rec["rebucket/seqs"] = np.array([q for q, _ in done])
    for q, r in done:
        r.validate()
        rec[f"rebucket/{q}/circuit"] = r.circuit
        rec[f"rebucket/{q}/mate"] = r.mate
        rec[f"rebucket/{q}/bucket"] = names([(r.cache.bucket, 1)])
    rec["rebucket/orders"] = np.array(
        [f"{k}={n}" for k, n in sorted(mb.orders.items())])
    rec["rebucket/live"] = names(solver.live_programs())


def byte_charge(group, rec: dict) -> None:
    """Rank r trues up (r + 1)·X for the same B=2 program under a budget
    between (W − 1)·X and W·X past the B=1 program's charge: each rank
    charges W·X, and every rank evicts the B=1 program."""
    mesh = mesh_mod.make_part_mesh(PARTS, group, device="cpu")
    solver = EulerSolver(mesh=mesh)
    g = eulerian_rmat(SCALE, avg_degree=5, seed=3)
    solver.solve(g)
    solver.solve_batch([g, g])
    key = solver.bucket_of(g)
    one = solver._program_bytes[(key, None)]
    x = 10 * solver.cache_bytes_used()
    solver.program_cache_bytes = one + (mesh.world - 0.5) * x
    mesh.calls.clear()
    mesh.sent_bytes.clear()
    solver._true_up(key, 2, (mesh.rank + 1) * x)
    rec["budget/x"] = np.array(x)
    rec["budget/bytes"] = np.array(solver.cache_bytes_used())
    rec["budget/live"] = names(solver.live_programs())
    rec["budget/measured"] = np.array(solver._measured[(key[0], 2)])
    rec["budget/evictions"] = np.array(solver.cache_stats.evictions)
    rec["budget/calls"] = np.array(
        [f"{k}={n}" for k, n in sorted(mesh.calls.items())])
    rec["budget/pmax_bytes"] = np.array(mesh.sent_bytes["pmax"])


def rank_main(rank: int, world: int, store: str, out: str) -> None:
    """Every case of ``world`` on this rank, written into ``out``."""
    torch.set_num_threads(1)
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=timeout)
    groups = {name: dist.new_group(timeout=timeout)
              for name in ("scenario", "rebucket", "budget")}
    rec, errors = {}, []

    def guarded(fn, *args):
        try:
            fn(*args)
        except BaseException as e:      # re-raised by the main thread
            errors.append(e)

    cases = [(scenario, groups["scenario"]),
             (rebucket, groups["rebucket"])]
    if world > 1:
        cases.append((byte_charge, groups["budget"]))
    # thread-contract: one a case, each in a group of its own, joined
    threads = [threading.Thread(target=guarded, args=(fn, grp, rec),
                                daemon=True) for fn, grp in cases]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    np.savez(out, **rec)
    if errors:
        raise errors[0]
    sys.stdout.flush()
    os._exit(0)


# ----------------------------------------------------------------------
# the module's worlds
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def worlds():
    """Spawn every world's ranks and the adaptive serving CLI over two
    gloo ranks at once.  Returns ``({world: {rank: record}}, {world:
    failures}, the CLI's (exit code, output, JSON line))``."""
    tmp = Path(tempfile.mkdtemp(prefix="torch_mesh_adaptive_"))
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    stats = tmp / "serve.json"
    cli = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve",
         "--mesh", "--adaptive", "--device", "cpu", "--scale", "6",
         "--parts", "8", "--same-bucket", "--pool", "3", "--max-batch", "4",
         "--requests", "12", "--json", str(stats)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    t_cli = time.time()
    procs = {}
    for w in WORLDS:
        for r in range(w):
            out = tmp / f"w{w}_r{r}.npz"
            procs[(w, r)] = (subprocess.Popen(
                [sys.executable, __file__, "--rank", str(r), "--world",
                 str(w), "--store", str(tmp / f"store{w}"), "--out",
                 str(out)], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), out, time.time())
    got, failed = {}, {}
    for (w, r), (proc, out, t0) in procs.items():
        try:
            log, _ = proc.communicate(
                timeout=max(1.0, LIVE_TIMEOUT - (time.time() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            failed.setdefault(w, []).append(
                f"rank {r}: over {LIVE_TIMEOUT} s\n{log}")
            continue
        if proc.returncode:
            failed.setdefault(w, []).append(
                f"rank {r}: exit {proc.returncode}\n{log}")
            continue
        with np.load(out) as z:
            got.setdefault(w, {})[r] = dict(z)
    try:
        log, _ = cli.communicate(
            timeout=max(1.0, LIVE_TIMEOUT - (time.time() - t_cli)))
        ran = (cli.returncode, log,
               stats.read_text() if stats.exists() else "")
    except subprocess.TimeoutExpired:
        cli.kill()
        ran = (None, cli.communicate()[0], "")
    shutil.rmtree(tmp, ignore_errors=True)
    return got, failed, ran


def ranks_of(worlds, world):
    got, failed = worlds[:2]
    assert world not in failed, "\n".join(failed[world])
    return got[world]


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return dict(z)


def assert_ranks_agree(ranks: dict, prefix: str) -> None:
    """Every record under ``prefix`` equal on every rank."""
    first = ranks[0]
    for r, rec in ranks.items():
        for k in (k for k in first if k.startswith(prefix)):
            np.testing.assert_array_equal(rec[k], first[k], err_msg=f"{k} "
                                          f"on rank {r}")


@pytest.fixture(scope="module")
def meshless_tight():
    """The first-seen graphs' meshless solves on the tight profile:
    ``{name: (seed, EulerResult)}``."""
    solver = EulerSolver(n_parts=PARTS, device="cpu")
    key, members = modal_group(solver)
    found = first_seen(key, members[0][1])
    solver.tighten(key[0])
    solver.rekey(key[0])
    return {name: (seed, solver.solve(g).validate())
            for name, (seed, g) in found.items()}


def assert_same(rec, prefix, circuit, mate):
    np.testing.assert_array_equal(rec[f"{prefix}/circuit"], circuit)
    np.testing.assert_array_equal(rec[f"{prefix}/mate"], mate)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_adaptive_serves_the_reference(worlds, golden, meshless_tight,
                                            world):
    """Rank 0's adaptive serve, followed on every rank: two B=1 flushes,
    the tuner's B=2 recorded on every rank by its prewarm order, a B=2
    flush, then a first-seen graph queued across the retune order and
    flushed at B=2 with member 0's repeat in the tight bucket; each
    request the JAX package's bytes (member 0's repeat: its tight
    solve's) or the meshless tight solve's, on every rank."""
    ranks = ranks_of(worlds, world)
    lead = ranks[0]
    assert lead["scenario/narrow"].tolist() == [1, 1]
    assert lead["scenario/decision"].tolist() == [QUOTA]
    assert bool(lead["scenario/compiled"])
    assert lead["scenario/warm_after_prewarm"].tolist() == [1, 2]
    assert bool(lead["scenario/retuned"])
    # the pending first-seen request queued again under the tight key
    tight = str(lead["scenario/tight_key"][0]).rsplit("/", 1)[0]
    assert [str(x) for x in lead["scenario/pending"]] == [f"{tight}/B1"]
    seed, want = meshless_tight["with"]
    assert int(lead["scenario/extra_seed"]) == seed
    for r, rec in ranks.items():
        assert rec["scenario/seqs"].tolist() == list(range(GROUP + 2))
        assert rec["scenario/widths"].tolist() == [1, 1, 2, 2], r
        for i in range(GROUP):
            assert_same(rec, f"scenario/{i}", golden[f"default_{i}/circuit"],
                        golden[f"default_{i}/mate"])
        assert_same(rec, f"scenario/{GROUP}", want.circuit, want.mate)
        assert_same(rec, f"scenario/{GROUP + 1}", golden["tight_0/circuit"],
                    golden["tight_0/mate"])
        for q in (GROUP, GROUP + 1):
            assert str(rec[f"scenario/{q}/bucket"][0]).rsplit("/", 1)[0] \
                == tight


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_adaptive_tight_solves(worlds, golden, world):
    """After the retune order every member re-buckets under the tight
    caps on every rank, whose B=1 and B=2 the retune recorded; each
    tight solve is the JAX package's bytes and park cap."""
    for rec in ranks_of(worlds, world).values():
        assert bool(rec["scenario/tight_key_differs"])
        assert rec["scenario/warm_tight"].tolist() == [1, 2]
        for i in range(GROUP):
            for f in ("circuit", "mate", "park_cap"):
                np.testing.assert_array_equal(rec[f"tight/{i}/{f}"],
                                              golden[f"tight_{i}/{f}"])


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_adaptive_ranks_keep_the_same_books(worlds, world):
    """Every rank ends with the same programs in the same LRU order, the
    same pins, tight scales, charged bytes and recordings; rank 0
    memoized the first-seen request's prep at its arrival, as without a
    mesh, and the request ran in the same (tight) bucket on every
    rank."""
    ranks = ranks_of(worlds, world)
    lead = ranks[0]
    assert bool(lead["scenario/extra_memoized"])
    assert len(lead["books/pinned"]) == 1
    assert lead["books/tight_scales"].size == 1
    assert int(lead["books/bytes"]) > 0
    assert_ranks_agree(ranks, "books/")
    assert_ranks_agree(ranks, f"scenario/{GROUP}/bucket")


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_retune_requeues_a_pending_queue(worlds, golden, meshless_tight,
                                              world):
    """A queue of member 0 (recorded before) and two first-seen graphs
    across a retune order: queued again by tight bucket, member 0 and
    the graph that shares its tight bucket flush at B=2, the other alone
    at B=1, each the JAX package's or the meshless tight solve's bytes,
    on every rank (one default queue flushed at B=2 would mix two tight
    buckets: ``solve_batch`` refuses that)."""
    ranks = ranks_of(worlds, world)
    lead = ranks[0]
    assert lead["rebucket/queued"].tolist() == [3]
    assert lead["rebucket/requeued"].tolist() == [1, 2]
    for r, rec in ranks.items():
        assert rec["rebucket/seqs"].tolist() == [0, 1, 2], r
        assert rec["rebucket/widths"].tolist() == [2, 1], r
        got = dict(x.split("=") for x in rec["rebucket/orders"])
        assert {k: int(n) for k, n in got.items()} == REBUCKET_ORDERS, r
        assert_same(rec, "rebucket/0", golden["tight_0/circuit"],
                    golden["tight_0/mate"])
        for q, name in ((1, "apart"), (2, "with")):
            res = meshless_tight[name][1]
            assert_same(rec, f"rebucket/{q}", res.circuit, res.mate)
    assert lead["rebucket/0/bucket"][0] == lead["rebucket/2/bucket"][0]
    assert lead["rebucket/0/bucket"][0] != lead["rebucket/1/bucket"][0]
    for prefix in ("live", "0/", "1/", "2/"):
        assert_ranks_agree(ranks, f"rebucket/{prefix}")


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_adaptive_order_stream(worlds, world):
    """Every rank counts the same orders by kind, and the mesh made one
    broadcast an order and the stop, each of one fixed-size message."""
    for r, rec in ranks_of(worlds, world).items():
        got = dict(x.split("=") for x in rec["scenario/orders"])
        assert {k: int(n) for k, n in got.items()} == ORDERS, r
        n = sum(ORDERS.values()) + 1
        assert int(rec["scenario/broadcasts"]) == n
        assert int(rec["scenario/order_bytes"]) == 8 * max(1 + QUOTA, 4)
        assert int(rec["scenario/broadcast_bytes"]) == \
            (n * int(rec["scenario/order_bytes"]) if r == 0 else 0)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_adaptive_starts_no_compile_thread(worlds, world):
    """Over a mesh the compile jobs run on the serving thread: no rank's
    service has a thread, and each ran the prewarm and the retune."""
    for rec in ranks_of(worlds, world).values():
        assert not bool(rec["threads/service_thread"])
        assert not bool(rec["threads/compile_service"])
        assert int(rec["threads/jobs"]) == 1 + 2      # B=2; tight B=1, B=2


@pytest.mark.parametrize("world", SPLIT_WORLDS)
def test_follower_tuner_raises(worlds, world):
    for r, rec in ranks_of(worlds, world).items():
        if r:
            assert "follow" in str(rec["scenario/follower_tuner"])


@pytest.mark.parametrize("world", SPLIT_WORLDS)
def test_byte_charge_is_the_largest_on_every_rank(worlds, world):
    """Planted per-rank measurements (r + 1)·X: one charge, W·X, on every
    rank (one ``pmax`` of 8 bytes), so every rank evicts the B=1 program,
    which rank 0's own measurement alone would have kept."""
    ranks = ranks_of(worlds, world)
    for rec in ranks.values():
        x = int(rec["budget/x"])
        assert int(rec["budget/measured"]) == world * x
        assert int(rec["budget/bytes"]) == world * x
        assert [s.rsplit("/", 1)[1] for s in rec["budget/live"]] == ["B2"]
        assert int(rec["budget/evictions"]) == 1
        assert rec["budget/calls"].tolist() == ["pmax=1"]
        assert int(rec["budget/pmax_bytes"]) == 8
    assert_ranks_agree(ranks, "budget/")


def test_adaptive_serving_cli_over_two_gloo_ranks(worlds):
    """``python -m repro_torch.launch.serve --mesh --adaptive`` under
    ``torch.distributed.run``: rank 0 serves every request with the
    tuner, rank 1 follows its dispatches and compile orders."""
    code, log, stats = worlds[2]
    assert code == 0, log
    assert "a mesh of 2 rank(s)" in log
    assert "rank 1/2: followed" in log and "12 circuits" in log
    line = json.loads(stats.splitlines()[-1])
    assert line["served"] == 12 and line["adaptive"]
    assert line["tuner_steps"] >= 1
    assert line["orders"]["dispatch"] == sum(line["width_hist"].values())
    compiles = line["orders"].get("prewarm", 0) + \
        line["orders"].get("retune", 0)
    assert f"{compiles} compile orders" in log


# ----------------------------------------------------------------------
# the thread-less service and the order codec, in process
# ----------------------------------------------------------------------
class _MeshSolver:
    """A stand-in session over a mesh: every width cold, prewarm records
    the widths it is given, ``boom`` fails."""
    mesh = object()

    def __init__(self):
        self.warm: list = []
        self.calls: list = []

    def bucket_of(self, graph):
        return ("k", 8)

    def warmed_widths(self, key):
        return sorted(self.warm)

    def prewarm(self, graph, widths):
        if graph == "boom":
            raise ValueError("boom")
        new = [w for w in widths if w not in self.warm]
        self.warm.extend(new)
        return new

    def tighten(self, e_cap):
        self.calls.append(("tighten", e_cap))

    def rekey(self, e_cap):
        self.calls.append(("rekey", e_cap))
        return 0


def test_mesh_service_runs_jobs_on_the_calling_thread():
    """Over a mesh the service has no thread: jobs queue with their
    request ids and run where called, by priority then FIFO, deduped; a
    retune tightens, rekeys and records; a job's error raises there and
    is not kept on its ticket; a follower runs a body at once without
    the queue (``run_now``)."""
    solver = _MeshSolver()
    svc = CompileService(solver)
    assert svc._thread is None
    with pytest.raises(RuntimeError, match="no compile thread"):
        svc.start()
    a = svc.submit("g", 2, priority=1.0, seq=5)
    b = svc.submit("g", 4, priority=3.0, seq=6)
    assert svc.submit("g", 4, seq=7) is b           # deduped
    c = svc.submit_retune("g", 64, [2], seq=5)
    bad = svc.submit("boom", 8)
    job = svc.next_job()
    assert (job.kind, job.seq, job.args) == ("retune", 5, (64, (1, 2)))
    assert job.ticket is c
    assert svc.run(job) is c and c.widths == [1, 2]
    assert solver.calls == [("tighten", 64), ("rekey", 64)]
    taken = svc.next_job()
    assert (taken.kind, taken.seq, taken.args) == ("prewarm", 6, (4,))
    assert taken.ticket is b
    assert svc.run_next() is a and a.widths == [] and a.done()
    with pytest.raises(ValueError, match="boom"):
        svc.drain()
    assert bad.done() and bad.error is None
    assert svc.drain() == 0 and not svc.idle()      # b is taken, not run
    assert svc.run(taken) is b and b.widths == [4] and svc.idle()
    assert svc.submit("g", 2).done()                # warm: finished
    assert svc.prewarms == 3
    now = svc.run_now("prewarm", "g", 16)
    assert now.done() and now.widths == [16] and svc.prewarms == 4
    assert svc.idle() and svc.next_job() is None    # nothing queued
    with pytest.raises(ValueError, match="boom"):
        svc.run_now("prewarm", "boom", 32)


def test_widths_mask_round_trip():
    for ws in ([1], [1, 2, 4, 8], [3, 62]):
        assert mask_widths(widths_mask(ws)) == ws
    with pytest.raises(ValueError):
        widths_mask([63])


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="one rank of a mesh world")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    rank_main(a.rank, a.world, a.store, a.out)
