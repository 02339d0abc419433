"""Batches and serving across ranks: ``solve_batch``,
``solve_batch_async``, ``solve_many(batch=B)`` and ``MicroBatcher`` over
``make_part_mesh(P, device="cpu")`` on gloo worlds of 1, 2 and 4 ranks
return the JAX package's circuits and mates byte for byte, on every rank,
in every Phase 3 mode.

The reference's bytes are the golden files of tests/test_torch_batch.py
(``tests/golden/torch_batch_reference.npz``: the scale-8 modal bucket at
P = 8 and B ∈ {3, 8}; the batch ``[ga, gb, ga, gb]`` at P ∈ {2, 4} in
each Phase 3 mode) and tests/test_torch_solve.py
(``torch_solve_reference.npz``, one graph of another bucket), all written
by the JAX package.  Each world's ranks run in processes of their own,
spawned once for the module (``python tests/test_torch_mesh_batch.py
--rank r --world W ...``), each with its own time limit and gloo group
timeout; each Phase 3 mode's cases run in a thread and group of their
own (a gloo call here waits milliseconds), and the serving loop (rank 0
leads, the others follow its broadcast flushes) and an overflowing batch
in a fourth.  The serving CLI runs once over two gloo ranks under
``torch.distributed.run``."""
import argparse
import dataclasses
import datetime
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

from repro_torch.core.engine import Engine, fused_collective_budget
from repro_torch.euler import EulerSolver
from repro_torch.graphgen.eulerize import eulerian_rmat
from repro_torch.launch import mesh as mesh_mod

WORLDS = (1, 2, 4)
MODES = {"sharded": {"sharded_phase3": True},
         "replicated": {"sharded_phase3": False},
         "nogather": {"sharded_phase3": True, "gather_circuit": False}}
MODAL_PARTS = 8
#: the modal batches' widths by mode: B = 8 in the two Phase 3s that
#: differ across ranks (``nogather`` gathers on the host after the
#: sharded path, and B = 8 costs the module 10 s a mode)
MODAL_WIDTHS = {"sharded": (3, 8), "replicated": (3, 8), "nogather": (3,)}
MODAL_CASES = [(m, B) for m, widths in MODAL_WIDTHS.items() for B in widths]
P3_PARTS = (2, 4)
#: solve_many(batch=2)'s stream: modal members by index, then the scale-7
#: graph of tests/test_torch_solve.py (a bucket of its own)
MANY = (3, 0, 5, 1, 4, 7, 2, "g7")
#: the serving loop's requests (modal members by index), its quota and
#: the widths recorded first
SERVE = (0, 1, 2, 3, 4, 5, 6, 7, 0, 1, 2, 3, 4)
SERVE_QUOTA, SERVE_WIDTHS = 4, (2, 4)
#: the overflowing batch: tests/test_torch_halt.py's graphs and open cap,
#: first and last, in both Phase 3s
BAD_SEED, GOOD_SEED, OPEN_CAP = 12, 2, 80
ORDERS = ((0, 1), (1, 0))
OVERFLOW_MODES = ("sharded", "replicated")
#: each spawned rank's time limit, about six times the 45–50 s the
#: slowest world took in this module's fixture on a shared 8-core CPU
LIVE_TIMEOUT = 300
GROUP_TIMEOUT = 60
TESTS = Path(__file__).resolve().parent
BATCH_GOLDEN = TESTS / "golden" / "torch_batch_reference.npz"
SOLVE_GOLDEN = TESTS / "golden" / "torch_solve_reference.npz"
SRC = str(TESTS.parent / "src")


def modal_graphs(seeds):
    return [eulerian_rmat(8, avg_degree=5, seed=int(s)) for s in seeds]


def p3_batch(P, gb_seed):
    sys.path.insert(0, str(TESTS))
    from test_torch_batch import random_eulerian

    ga = random_eulerian(24, 3, 8, 70)
    gb = random_eulerian(24, 3, 8, int(gb_seed))
    return [ga, gb, ga, gb]


def overflow_engine(mesh, opts):
    """tests/test_torch_halt.py's overflowing engine (the modal bucket at
    ``open_cap`` OPEN_CAP) over ``mesh`` (None: one device), in Phase 3
    mode ``opts``: ``(engine, key, [bad pg, good pg])``."""
    solver = EulerSolver(n_parts=MODAL_PARTS, device="cpu")
    preps = [solver._prepare(eulerian_rmat(8, avg_degree=5, seed=s), None)
             for s in (BAD_SEED, GOOD_SEED)]
    key = preps[0][2]
    caps = dataclasses.replace(key[3], open_cap=OPEN_CAP,
                               open_ship_cap=OPEN_CAP)
    eng = Engine(MODAL_PARTS, caps, key[2], mesh=mesh,
                 sharded_phase3=opts.get("sharded_phase3", True),
                 gather_circuit=opts.get("gather_circuit", True))
    return eng, key, [p[0] for p in preps]


# ----------------------------------------------------------------------
# one rank (this file run as a script)
# ----------------------------------------------------------------------
def rank_main(rank: int, world: int, store: str, out: str) -> None:
    """Every case of ``world`` on this rank, written into ``out``."""
    torch.set_num_threads(1)
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=timeout)
    groups = {name: dist.new_group(timeout=timeout)
              for name in (*MODES, "serve")}
    with np.load(BATCH_GOLDEN) as z:
        seeds = z["modal/seeds"].tolist()
        gb_seeds = {P: int(z[f"p3_{P}/gb_seed"]) for P in P3_PARTS}
    modal = modal_graphs(seeds)
    rec, errors = {}, []

    def keep(prefix, results):
        for i, r in enumerate(results):
            rec[f"{prefix}/{i}/circuit"] = r.circuit
            rec[f"{prefix}/{i}/mate"] = r.mate

    def run_mode(mode):
        opts = MODES[mode]
        mesh = mesh_mod.make_part_mesh(MODAL_PARTS, groups[mode],
                                       device="cpu")
        solver = EulerSolver(mesh=mesh, **opts)
        for B in MODAL_WIDTHS[mode]:
            mesh.calls.clear()
            keep(f"modal/{mode}/{B}", solver.solve_batch(modal[:B]))
            key = solver.bucket_of(modal[0])
            run = solver._engines[key].fused_program(key[0], B)
            rec[f"modal/{mode}/{B}/calls"] = np.array(
                [f"{k}={n}" for k, n in sorted(mesh.calls.items())])
            rec[f"modal/{mode}/{B}/census"] = np.array(
                [f"{k}={n}" for k, n in sorted(run.census.counts.items())])
            rec[f"modal/{mode}/{B}/key"] = np.array([key[0], key[2]])
        for P in P3_PARTS:
            if P % world:
                continue
            mesh_p = mesh_mod.make_part_mesh(P, groups[mode], device="cpu")
            pending = EulerSolver(mesh=mesh_p, **opts).solve_batch_async(
                p3_batch(P, gb_seeds[P]))
            keep(f"p3/{mode}/{P}", pending.results())
        if mode not in OVERFLOW_MODES:
            return
        eng, key, pgs = overflow_engine(mesh, opts)
        for order in ORDERS:
            got, _ = eng.fused_program(key[0], len(order)).launch(
                *eng.stage_batch([pgs[i] for i in order],
                                 torch.device("cpu"))).wait()
            for field, x in got._asdict().items():
                rec[f"overflow/{mode}/{order}/{field}"] = x

    def run_serve():
        from repro_torch.launch.serve import MicroBatcher

        mesh = mesh_mod.make_part_mesh(MODAL_PARTS, groups["serve"],
                                       device="cpu")
        solver = EulerSolver(mesh=mesh)
        graphs = modal + [eulerian_rmat(7, avg_degree=4, seed=7)]
        many = [graphs[-1] if i == "g7" else graphs[i] for i in MANY]
        keep("many", solver.solve_many(many, batch=2))
        solver.prewarm(modal[0], SERVE_WIDTHS)
        batcher = MicroBatcher(solver, max_batch=SERVE_QUOTA,
                               deadline_s=3600.0, pipeline_depth=2)
        mesh.calls.clear()
        if batcher.leads:
            done = []
            for seq, i in enumerate(SERVE):
                done.extend(batcher.submit(seq, modal[i]))
                done.extend(batcher.poll())
            done.extend(batcher.drain())
        else:
            done = batcher.follow(lambda seq: modal[SERVE[seq]])
        rec["serve/seqs"] = np.array([s for s, _ in done])
        keep("serve", [r for _, r in done])
        rec["serve/widths"] = np.array(
            [w for w, n in sorted(batcher.flushes.hist.items())
             for _ in range(n)])
        rec["serve/broadcasts"] = np.array(mesh.calls["broadcast"])
        rec["serve/broadcast_bytes"] = np.array(
            mesh.sent_bytes["broadcast"])

    def guarded(fn, *args):
        try:
            fn(*args)
        except BaseException as e:      # re-raised by the main thread
            errors.append(e)

    # thread-contract: one a mode and one for the serving loop, joined
    threads = [threading.Thread(target=guarded, args=(run_mode, mode),
                                daemon=True) for mode in MODES]
    threads.append(threading.Thread(target=guarded, args=(run_serve,),
                                    daemon=True))
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
    """Spawn every world's ranks at once and the serving CLI over two
    gloo ranks; while they run, solve the overflowing batch's members one
    at a time without a mesh here.  Returns ``({world: {rank: record}},
    {world: failures}, {(mode, member): meshless outputs}, the CLI's
    (exit code, output, JSON line))``."""
    tmp = Path(tempfile.mkdtemp(prefix="torch_mesh_batch_"))
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    stats = tmp / "serve.json"
    cli = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve",
         "--mesh", "--device", "cpu", "--scale", "6", "--parts", "8",
         "--same-bucket", "--pool", "3", "--max-batch", "4",
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
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        plain = meshless()
    finally:
        torch.set_num_threads(threads)
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
    return got, failed, plain, ran


def meshless():
    """Each overflowing-batch member's own one-graph fused outputs, one
    device, in each Phase 3 mode."""
    out = {}
    for mode in OVERFLOW_MODES:
        eng, key, pgs = overflow_engine(None, MODES[mode])
        for i, pg in enumerate(pgs):
            state = eng.device_state(eng.load_cached(pg),
                                     torch.device("cpu"), resident=False)
            out[mode, i] = eng.fused_program(key[0]).launch(*state).wait()[0]
    return out


def ranks_of(worlds, world):
    got, failed = worlds[:2]
    assert world not in failed, "\n".join(failed[world])
    return got[world]


@pytest.fixture(scope="module")
def golden():
    with np.load(BATCH_GOLDEN) as z:
        out = dict(z)
    with np.load(SOLVE_GOLDEN) as z:
        out.update((f"solve/{k}", v) for k, v in z.items())
    return out


def assert_member(rec, prefix, golden, gkey):
    np.testing.assert_array_equal(rec[f"{prefix}/circuit"],
                                  golden[f"{gkey}/circuit"])
    np.testing.assert_array_equal(rec[f"{prefix}/mate"],
                                  golden[f"{gkey}/mate"])


@pytest.mark.parametrize("world,mode,B", [(w, *c) for w in WORLDS
                                          for c in MODAL_CASES])
def test_mesh_batch_is_the_reference_on_every_rank(worlds, golden, world,
                                                   mode, B):
    """``solve_batch`` of the modal bucket's first B graphs over the
    mesh: each member the JAX package's ``solve_batch`` bytes, on every
    rank."""
    for rec in ranks_of(worlds, world).values():
        for i in range(B):
            assert_member(rec, f"modal/{mode}/{B}/{i}", golden,
                          f"modal_B{B}_{i}")


@pytest.mark.parametrize("world,mode,B", [(w, *c) for w in WORLDS
                                          for c in MODAL_CASES])
def test_mesh_batch_makes_one_graph_s_collective_budget(worlds, world,
                                                        mode, B):
    """A batched program over the mesh calls ``torch.distributed`` as
    the reference's vmapped schedule does, once a collective whatever B
    (the one-graph budget), plus the outputs' gathers."""
    for rec in ranks_of(worlds, world).values():
        e_cap, levels = rec[f"modal/{mode}/{B}/key"].tolist()
        budget = fused_collective_budget(
            levels, num_edges=e_cap, n_parts=MODAL_PARTS,
            sharded_phase3=mode != "replicated",
            gather_circuit=mode != "nogather")
        want = mesh_mod.expected_calls(budget, MODAL_PARTS)
        want["fetch"] = 3 if mode == "nogather" else 2
        calls = dict(x.split("=") for x in rec[f"modal/{mode}/{B}/calls"])
        census = dict(x.split("=") for x in rec[f"modal/{mode}/{B}/census"])
        assert {k: int(v) for k, v in calls.items()} == \
            {k: v for k, v in want.items() if v}
        assert {k: int(census.get(f"dist:{k}", 0)) for k in want} == want


@pytest.mark.parametrize("world,mode,P", [(w, m, P) for w in WORLDS
                                          for m in MODES for P in P3_PARTS
                                          if P % w == 0])
def test_mesh_batch_async_p3_batch(worlds, golden, world, mode, P):
    """``solve_batch_async`` of ``[ga, gb, ga, gb]`` at P partitions over
    the mesh: the JAX package's bytes in each Phase 3 mode."""
    for rec in ranks_of(worlds, world).values():
        for i in range(4):
            assert_member(rec, f"p3/{mode}/{P}/{i}", golden,
                          f"p3_{mode}_{P}_{i}")


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_solve_many_keeps_input_order(worlds, golden, world):
    for rec in ranks_of(worlds, world).values():
        for j, i in enumerate(MANY):
            assert_member(rec, f"many/{j}", golden,
                          "solve/8_7" if i == "g7" else f"modal_B8_{i}")


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_micro_batcher_serves_the_reference(worlds, golden, world):
    """Rank 0 leads the serving loop and the others follow its broadcast
    flushes: every rank delivers every request, in submit order, with the
    JAX package's bytes, from the same dispatches (three of width 4 at
    the quota, the drain's one), one broadcast each and a stop."""
    for r, rec in ranks_of(worlds, world).items():
        assert rec["serve/seqs"].tolist() == list(range(len(SERVE)))
        for seq, i in enumerate(SERVE):
            assert_member(rec, f"serve/{seq}", golden, f"modal_B8_{i}")
        assert rec["serve/widths"].tolist() == [1, 4, 4, 4]
        assert int(rec["serve/broadcasts"]) == 5
        assert int(rec["serve/broadcast_bytes"]) == \
            (5 * 8 * (1 + SERVE_QUOTA) if r == 0 else 0)


@pytest.mark.parametrize("world,mode,order", [(w, m, o) for w in WORLDS
                                              for m in OVERFLOW_MODES
                                              for o in ORDERS])
def test_mesh_batch_overflowing_member(worlds, world, mode, order):
    """An overflowing member first or last in a batch over the mesh: every
    member, in every field, is its own meshless one-graph run, the sound
    one sound; the overflowed one returns its flags."""
    plain = worlds[2]
    for rec in ranks_of(worlds, world).values():
        for b, i in enumerate(order):
            want = plain[mode, i]
            for field, x in want._asdict().items():
                got = rec[f"overflow/{mode}/{order}/{field}"]
                got = got[:, b] if field in ("flags", "metrics") else got[b]
                np.testing.assert_array_equal(got, x)
            assert bool(want.flags.all()) == (i == 1)


def test_serving_cli_over_two_gloo_ranks(worlds):
    """``python -m repro_torch.launch.serve --mesh`` under
    ``torch.distributed.run``: rank 0 serves every request and writes
    the stats, rank 1 follows the same dispatches."""
    import json

    code, log, stats = worlds[3]
    assert code == 0, log
    assert "a mesh of 2 rank(s)" in log
    assert "rank 1/2: followed" in log and "12 circuits" in log
    line = json.loads(stats.splitlines()[-1])
    assert line["served"] == 12 and line["parts"] == 8


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="one rank of a mesh world")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    rank_main(a.rank, a.world, a.store, a.out)
