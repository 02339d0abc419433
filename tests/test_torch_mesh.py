"""The engine across ranks: ``repro_torch.euler.solve(g, n_parts=P,
mesh=make_part_mesh(P, device="cpu"))`` over gloo worlds of 1, 2 and 4
ranks returns the JAX package's circuit and mate byte for byte, on every
rank, fused and eager, in each Phase 3 mode, for P ∈ {2, 8} (each P the
world divides) at RMAT scales 5–7, with the flags and metrics of the
meshless solve.

The reference's bytes are the golden file of tests/test_torch_solve.py
(``tests/golden/torch_solve_reference.npz``, written by the JAX package on
its 8-device mesh).  Each world's ranks run in processes of their own,
spawned once for the module (``python tests/test_torch_mesh.py --rank r
--world W ...``), each with its own time limit and a gloo group with a
timeout of its own, so that a deadlock fails the tests instead of holding
the run; each rank writes what it got into an ``.npz`` file.

A fused solve over a mesh makes the reference's collective schedule as
``torch.distributed`` calls (``fused_collective_budget``), counted in the
census of its first run, and a planted mis-wiring of the ring (steps
sent to rank − 1, so that at world 1 the local rows roll the wrong way)
or of the exchange's split (chunks sent to the transposed rank) fails
the solve or changes its bytes.  On a card (``gpu`` tests) one NCCL rank
holding all the partitions gives the meshless bytes."""
import argparse
import datetime
import gc
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

from repro_torch.core.engine import fused_collective_budget
from repro_torch.euler import EulerSolver
from repro_torch.euler import solver as solver_mod
from repro_torch.graphgen.eulerize import eulerian_rmat
from repro_torch.launch import mesh as mesh_mod

WORLDS = (1, 2, 4)
PARTS = (2, 8)
SCALES = (5, 6, 7)
MODES = {"sharded": {"sharded_phase3": True},
         "replicated": {"sharded_phase3": False},
         "no_gather": {"sharded_phase3": True, "gather_circuit": False}}
RUNS = ("fused", "eager")
#: a planted fault's case: P 8 (every world divides it), scale 5, fused
#: and sharded (the ring runs only in the sharded Phase 3)
FAULT_CASE = (8, 5)
#: each spawned rank's time limit, about four times the 50 s the slowest
#: world took in this module's fixture on a shared 8-core CPU (a gloo
#: call there costs 1–4 ms, mostly waiting)
LIVE_TIMEOUT = 200
#: the gloo groups' own timeout: a rank left waiting in a collective
#: raises after it
GROUP_TIMEOUT = 60
GOLDEN = Path(__file__).resolve().parent / "golden" / \
    "torch_solve_reference.npz"
SRC = str(Path(__file__).resolve().parents[1] / "src")
EXAMPLE = Path(SRC).parent / "examples" / "torch_euler_distributed.py"


def cases(world):
    """(P, scale, mode, run) of a world: every P it divides."""
    return [(P, s, mode, run) for P in PARTS if P % world == 0
            for s in SCALES for mode in MODES for run in RUNS]


def case_key(P, scale, mode, run) -> str:
    return f"{P}_{scale}_{mode}_{run}"


# ----------------------------------------------------------------------
# the planted faults (each rank's PartMesh methods, swapped in)
# ----------------------------------------------------------------------
def backwards_ring(self, x, dim=0, batch=1):
    """A ring step along i → i−1: the first partition's rows go to rank
    − 1."""
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


def transposed_split(self, send):
    """The exchange with chunk r sent to rank world − 1 − r."""
    return PLAIN_ALL_TO_ALL(self, send.view(self.world, -1).flip(0)
                            .reshape(send.shape))


PLAIN_ALL_TO_ALL = mesh_mod.PartMesh.all_to_all
FAULTS = {"ring": ("ring", backwards_ring),
          "split": ("all_to_all", transposed_split)}


def fault_worlds(fault):
    """The worlds where ``fault`` changes what is sent: a transposed
    split is the plain one at world 1."""
    return [w for w in WORLDS if fault == "ring" or w > 1]


# ----------------------------------------------------------------------
# one rank (this file run as a script)
# ----------------------------------------------------------------------
def rank_main(rank: int, world: int, store: str, out: str) -> None:
    """Every case of ``world`` on this rank, written into ``out`` (circuit,
    mate, flags, metrics and the fused runs' censuses), then the planted
    faults one after the other, each outcome written into ``out``'s
    ``.fault.npz`` as it comes.  A gloo call here costs milliseconds, most
    of it waiting, so each Phase 3 mode's cases run in a thread of their
    own over a group of their own.  A fault may crash a rank while its
    peers wait in a collective, so the process leaves without tearing its
    groups down: its peers' calls then fail at once."""
    torch.set_num_threads(1)
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=timeout)
    groups = {mode: dist.new_group(timeout=timeout) for mode in MODES}
    graphs = {s: eulerian_rmat(s, avg_degree=4, seed=s) for s in SCALES}
    rec, errors = {}, []
    raw = threading.local()
    plain_result = EulerSolver._result

    def keeping(self, graph, tree, key, out, *a, **kw):
        raw.out = (out.flags.copy(), out.metrics.copy())
        return plain_result(self, graph, tree, key, out, *a, **kw)

    def run_mode(mode):
        try:
            meshes = {P: mesh_mod.make_part_mesh(P, groups[mode],
                                                 device="cpu")
                      for P in PARTS if P % world == 0}
            for P, s, m, run in cases(world):
                if m != mode:
                    continue
                solver = EulerSolver(mesh=meshes[P], **MODES[mode])
                res = solver.solve(graphs[s], fused=run == "fused")
                k = case_key(P, s, mode, run)
                rec[f"{k}/circuit"], rec[f"{k}/mate"] = res.circuit, res.mate
                rec[f"{k}/flags"], rec[f"{k}/metrics"] = raw.out
                if run == "fused":
                    key = solver.bucket_of(graphs[s])
                    census = solver._engines[key].fused_program(key[0]).census
                    rec[f"{k}/census"] = np.array(
                        [f"{name}={n}" for name, n in
                         sorted(census.counts.items())])
                    rec[f"{k}/levels"] = np.array(key[2])
                    rec[f"{k}/e_cap"] = np.array(key[0])
        except BaseException as e:      # re-raised by the main thread
            errors.append(e)

    EulerSolver._result = keeping
    try:
        # thread-contract: one a mode, joined below
        threads = [threading.Thread(target=run_mode, args=(mode,),
                                    daemon=True) for mode in MODES]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        EulerSolver._result = plain_result
        np.savez(out, **rec)
    if errors:
        raise errors[0]
    meshes = {P: mesh_mod.make_part_mesh(P, device="cpu")
              for P in PARTS if P % world == 0}
    P, s = FAULT_CASE
    faults = {}
    for fault in FAULTS:        # the ring's fault first: it fails alike
        if world not in fault_worlds(fault):     # on every rank
            continue
        name, planted = FAULTS[fault]
        dist.barrier()
        plain = getattr(mesh_mod.PartMesh, name)
        setattr(mesh_mod.PartMesh, name, planted)
        try:
            res = EulerSolver(mesh=meshes[P]).solve(graphs[s])
            faults[f"{fault}/circuit"] = res.circuit
            faults[f"{fault}/mate"] = res.mate
        except Exception as e:     # a rank fed garbage may crash
            faults[f"{fault}/raised"] = np.array(repr(e))
        setattr(mesh_mod.PartMesh, name, plain)
        np.savez(out + ".fault.npz", **faults)
        if f"{fault}/raised" in faults and fault != "ring":
            break
    sys.stdout.flush()
    os._exit(0)


# ----------------------------------------------------------------------
# the module's worlds
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def worlds():
    """Spawn every world's ranks at once, each with its own time limit,
    and the example's ``--mesh`` run over two gloo ranks; while they run,
    solve each (P, scale) without a mesh here.  Returns ``({world: {rank:
    record}}, {world: failures}, meshless flags and metrics, the
    example's (exit code, output))``."""
    tmp = Path(tempfile.mkdtemp(prefix="torch_mesh_"))
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    example = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", str(EXAMPLE), "--mesh", "--device", "cpu",
         "--scale", "6"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    t_example = time.time()
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
        rec = got.setdefault(w, {})[r] = {}
        for path, prefix in ((out, ""), (Path(f"{out}.fault.npz"), "fault_")):
            if path.exists():
                with np.load(path) as z:
                    rec.update((prefix + k, v) for k, v in z.items())
    try:
        log, _ = example.communicate(
            timeout=max(1.0, LIVE_TIMEOUT - (time.time() - t_example)))
        ran = (example.returncode, log)
    except subprocess.TimeoutExpired:
        example.kill()
        ran = (None, example.communicate()[0])
    shutil.rmtree(tmp, ignore_errors=True)
    return got, failed, plain, ran


def meshless():
    """The meshless port's flags and metrics of each (P, scale): the
    levels' outputs, the same in every Phase 3 mode, fused or eager."""
    rec = {}
    plain_result = EulerSolver._result

    def keeping(self, graph, tree, key, out, *a, **kw):
        rec[key[1], graph.num_edges] = (out.flags.copy(), out.metrics.copy())
        return plain_result(self, graph, tree, key, out, *a, **kw)

    EulerSolver._result = keeping
    try:
        for P in PARTS:
            for s in SCALES:
                g = eulerian_rmat(s, avg_degree=4, seed=s)
                EulerSolver(n_parts=P, device="cpu").solve(g)
                rec[P, s] = rec.pop((P, g.num_edges))
    finally:
        EulerSolver._result = plain_result
    return rec


def ranks_of(worlds, world):
    """Each rank's record of ``world``; every rank must have run to its
    end within its time limit."""
    got, failed = worlds[:2]
    assert world not in failed, "\n".join(failed[world])
    return got[world]


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return dict(z)


@pytest.mark.parametrize("world,P,scale,mode,run",
                         [(w, *c) for w in WORLDS for c in cases(w)])
def test_mesh_solve_is_the_reference_on_every_rank(worlds, golden, world,
                                                   P, scale, mode, run):
    ranks = ranks_of(worlds, world)
    k = case_key(P, scale, mode, run)
    flags, metrics = worlds[2][P, scale]
    for r, rec in sorted(ranks.items()):
        np.testing.assert_array_equal(rec[f"{k}/circuit"],
                                      golden[f"{P}_{scale}/circuit"])
        np.testing.assert_array_equal(rec[f"{k}/mate"],
                                      golden[f"{P}_{scale}/mate"])
        np.testing.assert_array_equal(rec[f"{k}/flags"], flags)
        np.testing.assert_array_equal(rec[f"{k}/metrics"], metrics)
        for field in ("circuit", "mate", "flags", "metrics"):
            np.testing.assert_array_equal(rec[f"{k}/{field}"],
                                          ranks[0][f"{k}/{field}"])


@pytest.mark.parametrize("world,P,mode",
                         [(w, P, mode) for w in WORLDS for P in PARTS
                          if P % w == 0 for mode in MODES])
def test_fused_mesh_makes_the_collective_budget(worlds, world, P, mode):
    """The first run of each fused program over the mesh (its recording
    on a card) calls ``torch.distributed`` as often as the reference's
    schedule says: every level's all_to_all, the psums, the all_gather,
    the ring steps of the ppermute loops; and the outputs' gathers (flags,
    metrics, and the rank shards under ``gather_circuit=False``)."""
    ranks = ranks_of(worlds, world)
    for s in SCALES:
        k = case_key(P, s, mode, "fused")
        for rec in ranks.values():
            census = dict(x.split("=") for x in rec[f"{k}/census"])
            census = {name: int(n) for name, n in census.items()}
            sharded = mode != "replicated"
            levels, e_cap = int(rec[f"{k}/levels"]), int(rec[f"{k}/e_cap"])
            budget = fused_collective_budget(
                levels, num_edges=e_cap, n_parts=P, sharded_phase3=sharded,
                gather_circuit=mode != "no_gather") if sharded \
                else fused_collective_budget(levels)
            want = mesh_mod.expected_calls(budget, P)
            got = {kind: census.get(f"dist:{kind}", 0) for kind in want}
            assert got == want, (k, census)
            assert census["dist:fetch"] == (3 if mode == "no_gather" else 2)
            assert census.get("ring_step", 0) == want["ring"]
            assert census.get("ppermute", 0) == budget["ppermute"]


@pytest.mark.parametrize("world,fault",
                         [(w, f) for f in FAULTS for w in fault_worlds(f)])
def test_planted_miswiring_is_caught(worlds, golden, world, fault):
    """Every rank's solve with a planted fault raises its checks or
    returns other bytes than the reference's."""
    P, s = FAULT_CASE
    for rec in ranks_of(worlds, world).values():
        assert any(k.startswith(f"fault_{fault}/") for k in rec)
        if f"fault_{fault}/raised" in rec:
            continue
        assert not (np.array_equal(rec[f"fault_{fault}/circuit"],
                                   golden[f"{P}_{s}/circuit"])
                    and np.array_equal(rec[f"fault_{fault}/mate"],
                                       golden[f"{P}_{s}/mate"]))


def test_example_solves_over_two_gloo_ranks(worlds):
    """``examples/torch_euler_distributed.py --mesh`` under
    ``torch.distributed.run``: both ranks solve over the mesh and rank 0
    finds the meshless bytes."""
    code, log = worlds[3]
    assert code == 0, log
    assert "byte-identical to the meshless solve=True" in log
    assert "rank 1/2: partitions 4–7 on cpu" in log


# ----------------------------------------------------------------------
# the rules, in a world of one rank in this process
# ----------------------------------------------------------------------
@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_make_part_mesh_needs_a_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="never initialises"):
        mesh_mod.make_part_mesh(2, device="cpu")


def test_make_part_mesh_rules(one_rank):
    mesh = mesh_mod.make_part_mesh(4, device="cpu")
    assert (mesh.world, mesh.rank, mesh.m, mesh.first, mesh.backend) == \
        (1, 0, 4, 0, "gloo")
    assert mesh.part_ids().tolist() == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="device='cpu'"):
        mesh_mod.make_part_mesh(4)              # never the CPU unasked
    with pytest.raises(ValueError, match="do not divide"):
        mesh_mod.make_part_mesh(0, device="cpu")


def test_nccl_mesh_needs_graph_mixing_off(monkeypatch):
    """An NCCL mesh needs NCCL_GRAPH_MIXING_SUPPORT=0 (its point-to-point
    kernel records into a CUDA while node's body only so), asked before
    anything touches a card."""
    name, value = mesh_mod.NCCL_GRAPH_MIXING
    monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match=name):
        mesh_mod._local_device("nccl", None)
    monkeypatch.setenv(name, value)
    with pytest.raises(ValueError, match="on the card"):
        mesh_mod._local_device("nccl", "cpu")


def test_solver_mesh_rules(one_rank):
    """Over a mesh: the solver takes its partitions and device, refuses
    the host backend, and runs batches, ``solve_many(batch=)``, the
    serving loop and ``prewarm_async`` (a thread-less compile service)
    over the mesh, with the meshless bytes (a world of one rank in
    process; tests/test_torch_mesh_batch.py and
    tests/test_torch_mesh_adaptive.py hold them to the JAX package on
    worlds of 1, 2 and 4)."""
    from repro_torch.launch.serve import MicroBatcher

    mesh = mesh_mod.make_part_mesh(2, device="cpu")
    solver = EulerSolver(mesh=mesh)
    assert solver.mesh is mesh and solver.n_parts == 2
    assert solver.device == torch.device("cpu")
    with pytest.raises(ValueError, match="partitions"):
        EulerSolver(n_parts=4, mesh=mesh)
    with pytest.raises(ValueError, match="no mesh"):
        EulerSolver(backend="host", mesh=mesh)
    g = eulerian_rmat(5, avg_degree=4, seed=5)
    # one graph at a time holds the meshless bytes, in process too
    res = solver_mod.solve(g, n_parts=2, mesh=mesh)
    plain = solver_mod.solve(g, n_parts=2, device="cpu")
    np.testing.assert_array_equal(res.circuit, plain.circuit)
    np.testing.assert_array_equal(res.mate, plain.mate)
    for got in solver.solve_batch([g, g]):
        np.testing.assert_array_equal(got.circuit, plain.circuit)
    for got in solver.solve_many([g, g, g], batch=2):
        np.testing.assert_array_equal(got.mate, plain.mate)
    batcher = MicroBatcher(solver, max_batch=2)
    assert batcher.leads and batcher.mesh is mesh
    done = batcher.submit(0, g) + batcher.drain()
    assert [s for s, _ in done] == [0]
    np.testing.assert_array_equal(done[0][1].circuit, plain.circuit)
    # over a mesh prewarm_async queues on a service with no thread; the
    # job runs where every rank drains the service
    key = solver.bucket_of(g)
    tickets = solver.prewarm_async(g, widths=(4,))
    assert [t.done() for t in tickets] == [False]
    assert solver.warmed_widths(key) == [1, 2]
    assert solver.compile_service.drain() == 1
    assert tickets[0].done() and tickets[0].widths == [4]
    assert solver.warmed_widths(key) == [1, 2, 4]
    assert solver.compile_service._thread is None
    with pytest.raises(RuntimeError, match="no compile thread"):
        solver.compile_service.start()


@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """One NCCL rank holding all 8 partitions, for the module; its group
    is destroyed after every solver over it is gone (NCCL waits for the
    CUDA graphs that hold its kernels)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: NCCL runs only on the card")
    os.environ.setdefault(*mesh_mod.NCCL_GRAPH_MIXING)
    store = tmp_path_factory.mktemp("nccl") / "store"
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(store), 1), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
    try:
        yield mesh_mod.make_part_mesh(8)
    finally:
        gc.collect()
        torch.cuda.synchronize()
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(MODES))
def test_nccl_one_rank_matches_meshless(nccl_mesh, mode):
    """On a card: one NCCL rank holding all 8 partitions, fused (recorded,
    then replayed) and eager, gives the meshless solve's bytes."""
    g = eulerian_rmat(9, avg_degree=5, seed=1)
    plain = EulerSolver(n_parts=8, **MODES[mode]).solve(g)
    solver = EulerSolver(mesh=nccl_mesh, **MODES[mode])
    for res in (solver.solve(g), solver.solve(g),
                solver.solve(g, fused=False)):
        np.testing.assert_array_equal(res.circuit, plain.circuit)
        np.testing.assert_array_equal(res.mate, plain.mate)
    assert solver.captures == 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="one rank of a mesh world")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    rank_main(a.rank, a.world, a.store, a.out)
