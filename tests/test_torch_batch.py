"""The port's batched solving (``solve_batch``, ``solve_batch_async``,
``solve_many(batch=B)``; DESIGN.md §8) against the JAX package's.

The references' outputs are a golden file,
``tests/golden/torch_batch_reference.npz``, written by the JAX package's
own ``solve_batch`` (frozen, so it cannot drift) with ``PYTHONPATH=src
python tests/test_torch_batch.py`` (one subprocess with 8 simulated
devices): the modal bucket of 30 scale-8 graphs at P = 8 (the session
golden's ``many/seeds``) at B ∈ {3, 8}, and
``tests/test_sharded_phase3.py``'s batch ``[ga, gb, ga, gb]`` (B = 4, P ∈
{2, 4}) in the replicated, sharded and ``gather_circuit=False`` Phase 3
modes.
``test_batch_golden_is_the_jax_output`` solves one case of it again live.
The rest port ``tests/test_batched.py`` (minus the host backend, which
the port does not have yet) and hold the session's counts, the stacked
inputs' memo and the loops' rounds of a batched run.  On a card (``gpu``
tests) a batch is byte-equal to the CPU, its recording holds the
one-graph recording's kernel launches, and its eviction gives its memory
back; the card's machine has no JAX, so the JAX package is imported only
inside the CPU tests."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import run_with_devices
from repro_torch.core.engine import FusedRun
from repro_torch.core.graph import Graph
from repro_torch.euler import EulerSolver, solve, solve_batch, solve_many
from repro_torch.graphgen.eulerize import eulerian_rmat
from repro_torch.kernels import pointer_double as pd

TESTS = Path(__file__).resolve().parent
GOLDEN = TESTS / "golden" / "torch_batch_reference.npz"

#: the Phase 3 modes, as solver options
MODES = {"replicated": {"sharded_phase3": False}, "sharded": {},
         "nogather": {"gather_circuit": False}}
MODAL_WIDTHS = [3, 8]
P3_PARTS = [2, 4]
#: the time limit of the live JAX reference run in this file, about five
#: times the 30 s it took in the suite's parallel run on an 8-core CPU:
#: a stalled subprocess fails the tests that read it instead of holding
#: its worker for run_with_devices' default 900 s
LIVE_TIMEOUT = 150

_REFERENCE = '''
import sys
import numpy as np
sys.path.insert(0, {tests!r})
from test_sharded_phase3 import random_eulerian_np
from repro.euler import EulerSolver
from repro.graphgen.eulerize import eulerian_rmat
MODES = {modes!r}
rec = {{}}
if {modal}:
    solver = EulerSolver(n_parts=8)
    buckets = {{}}
    for s in range(30):
        g = eulerian_rmat(8, avg_degree=5, seed=s)
        buckets.setdefault(solver.bucket_of(g), []).append((s, g))
    group = max(buckets.values(), key=len)[:8]
    rec["modal/seeds"] = np.array([s for s, _ in group])
    for B in {widths}:
        for i, r in enumerate(solver.solve_batch([g for _, g in group[:B]])):
            rec[f"modal_B{{B}}_{{i}}/circuit"] = r.circuit
            rec[f"modal_B{{B}}_{{i}}/mate"] = r.mate
for P in {parts}:
    key = EulerSolver(n_parts=P, sharded_phase3=False).bucket_of(
        random_eulerian_np(24, 3, 8, 70))
    seed = next((s for s in range(71, 200) if EulerSolver(
        n_parts=P, sharded_phase3=False).bucket_of(
            random_eulerian_np(24, 3, 8, s)) == key), 70)
    rec[f"p3_{{P}}/gb_seed"] = np.array(seed)
    ga = random_eulerian_np(24, 3, 8, 70)
    gb = random_eulerian_np(24, 3, 8, seed)
    for mode in {p3_modes!r}:
        solver = EulerSolver(n_parts=P, **MODES[mode])
        for i, r in enumerate(solver.solve_batch([ga, gb, ga, gb])):
            rec[f"p3_{{mode}}_{{P}}_{{i}}/circuit"] = r.circuit
            rec[f"p3_{{mode}}_{{P}}_{{i}}/mate"] = r.mate
np.savez_compressed({out!r}, **rec)
'''


def jax_reference(out, modal=True, widths=MODAL_WIDTHS, parts=P3_PARTS,
                  p3_modes=tuple(MODES), devices=8, timeout=1800) -> None:
    """The JAX package's ``solve_batch`` circuits and mates of the modal
    bucket (``modal``, at each of ``widths``) and of the B = 4 batch at
    each of ``parts`` in each of ``p3_modes``, into the ``.npz`` file
    ``out``."""
    run_with_devices(_REFERENCE.format(
        tests=str(TESTS), modes=MODES, modal=modal, widths=list(widths),
        parts=list(parts), p3_modes=list(p3_modes), out=str(out)),
        n=devices, timeout=timeout)


def random_eulerian(n_vertices, n_trails, trail_len, seed) -> Graph:
    """``tests/test_sharded_phase3.py::random_eulerian_np`` as a port
    ``Graph``."""
    from test_sharded_phase3 import random_eulerian_np

    g = random_eulerian_np(n_vertices, n_trails, trail_len, seed)
    return Graph(g.num_vertices, g.edge_u, g.edge_v)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU solves here are small (scale 8 at most): one
    intra-op thread runs them fastest and keeps them from contending with
    the suite's other workers; the setting is restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def reference():
    with np.load(GOLDEN) as z:
        return dict(z)


def same_bytes(a, b) -> bool:
    return (np.array_equal(a.circuit, b.circuit)
            and np.array_equal(a.mate, b.mate))


def modal_group(solver, seeds=None):
    """The modal bucket of 30 scale-8 graphs: ``(key, [graph…])``, its
    first 8 graphs (or those of ``seeds``)."""
    buckets = {}
    for s in range(30):
        g = eulerian_rmat(8, avg_degree=5, seed=s)
        buckets.setdefault(solver.bucket_of(g), []).append((s, g))
    key, group = max(buckets.items(), key=lambda kv: len(kv[1]))
    assert len(group) >= 8, f"modal bucket holds {len(group)} < 8 graphs"
    if seeds is not None:
        assert [s for s, _ in group[:8]] == list(seeds)
    return key, [g for _, g in group[:8]]


@pytest.fixture(scope="module")
def modal(reference):
    """A P = 8 CPU session over the modal bucket: ``(solver, key, graphs,
    their sequential one-graph results)``."""
    solver = EulerSolver(n_parts=8, device="cpu")
    key, graphs = modal_group(solver, reference["modal/seeds"].tolist())
    return solver, key, graphs, [solver.solve(g) for g in graphs]


def p3_batch(P: int, reference):
    """``tests/test_sharded_phase3.py``'s B = 4 batch ``[ga, gb, ga, gb]``
    at ``P`` partitions (gb the golden's same-bucket seed)."""
    ga = random_eulerian(24, 3, 8, 70)
    gb = random_eulerian(24, 3, 8, int(reference[f"p3_{P}/gb_seed"]))
    return [ga, gb, ga, gb]


# ---------------------------------------------------------------------------
# the JAX package's bytes
# ---------------------------------------------------------------------------

def test_batch_golden_is_the_jax_output(reference, tmp_path):
    """One case of the golden file (B = 4 sharded at P = 2) solved again
    by the JAX package's ``solve_batch``."""
    out = tmp_path / "live.npz"
    jax_reference(out, modal=False, parts=[2], p3_modes=["sharded"],
                  devices=2, timeout=LIVE_TIMEOUT)
    with np.load(out) as z:
        live = dict(z)
    assert set(live) == {"p3_2/gb_seed"} | {
        f"p3_sharded_2_{i}/{k}" for i in range(4) for k in ("circuit", "mate")}
    for k, v in live.items():
        np.testing.assert_array_equal(v, reference[k])
    assert set(reference) == (
        {"modal/seeds"}
        | {f"modal_B{B}_{i}/{k}" for B in MODAL_WIDTHS for i in range(B)
           for k in ("circuit", "mate")}
        | {f"p3_{P}/gb_seed" for P in P3_PARTS}
        | {f"p3_{m}_{P}_{i}/{k}" for m in MODES for P in P3_PARTS
           for i in range(4) for k in ("circuit", "mate")})


@pytest.mark.parametrize("B", MODAL_WIDTHS)
def test_modal_bucket_batch_is_the_jax_output(reference, modal, B):
    """The modal bucket at P = 8 (the sharded Phase 3, the default): each
    member byte-equal to the JAX package's ``solve_batch`` and to its own
    sequential solve, valid, in the bucket, and stamped with the
    width."""
    solver, key, graphs, seq = modal
    got = solver.solve_batch(graphs[:B])
    assert len(got) == B
    for i, (g, r) in enumerate(zip(graphs, got)):
        r.validate()
        np.testing.assert_array_equal(r.circuit,
                                      reference[f"modal_B{B}_{i}/circuit"])
        np.testing.assert_array_equal(r.mate,
                                      reference[f"modal_B{B}_{i}/mate"])
        assert same_bytes(r, seq[i])
        assert len(r.circuit) == g.num_edges and r.graph is g
        assert r.cache.bucket == key and r.cache.batch == B
        assert r.timings["batch"] == B and r.fused


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("P", P3_PARTS)
def test_sharded_phase3_batch_is_the_jax_output(reference, mode, P):
    """``tests/test_sharded_phase3.py``'s B = 4 case in each Phase 3 mode:
    each member byte-equal to the JAX package's ``solve_batch`` and to
    the port's own one-graph solve."""
    batch = p3_batch(P, reference)
    solver = EulerSolver(n_parts=P, device="cpu", **MODES[mode])
    assert len({solver.bucket_of(g) for g in batch}) == 1
    got = solver.solve_batch(batch)
    for i, (g, r) in enumerate(zip(batch, got)):
        r.validate()
        np.testing.assert_array_equal(
            r.circuit, reference[f"p3_{mode}_{P}_{i}/circuit"])
        np.testing.assert_array_equal(r.mate,
                                      reference[f"p3_{mode}_{P}_{i}/mate"])
    for g, r in zip(batch[:2], got[:2]):
        assert same_bytes(r, solver.solve(g))


# ---------------------------------------------------------------------------
# tests/test_batched.py on the port
# ---------------------------------------------------------------------------

def test_solve_batch_one_trace_per_width(modal):
    """``tests/test_batched.py``: B = 1 goes through the one-graph
    program (no new trace); B = 3 and B = 8 each trace once, then hit;
    every member byte-equal to the sequential solves."""
    _, key, graphs, seq = modal
    solver = EulerSolver(n_parts=8, device="cpu")
    for g in graphs:
        solver.solve(g)
    assert solver.cache_stats.traces == 1
    one = solver.solve_batch(graphs[:1])
    assert len(one) == 1 and solver.cache_stats.traces == 1
    assert same_bytes(one[0], seq[0]) and one[0].cache.batch == 1
    for B, traces in ((3, 2), (8, 3)):
        first = solver.solve_batch(graphs[:B])
        assert solver.cache_stats.traces == traces, B
        assert not first[0].cache.hit and first[0].cache.batch == B
        again = solver.solve_batch(graphs[:B])
        assert solver.cache_stats.traces == traces, f"(bucket, {B}) retraced"
        assert again[0].cache.hit
        for s, a, b in zip(seq, first, again):
            assert same_bytes(s, a) and same_bytes(a, b)
            assert a.cache.bucket == key
    cs = solver.cache_stats
    assert (cs.misses, cs.hits, cs.evictions) == (3, 7 + 1 + 2, 0)
    assert set(solver._engines[key]._fused) == {
        (key[0], 3), (key[0], 8), (key[0], None)}


def test_solve_batch_rejects_mixed_buckets():
    solver = EulerSolver(n_parts=1, device="cpu")
    small = eulerian_rmat(5, avg_degree=4, seed=0)
    big = eulerian_rmat(9, avg_degree=5, seed=1)
    assert solver.bucket_of(small) != solver.bucket_of(big)
    with pytest.raises(ValueError, match="same-bucket"):
        solver.solve_batch([small, big])
    assert solver.cache_stats.misses == 0


def test_solve_batch_rejects_eager_and_takes_empty():
    g = eulerian_rmat(5, avg_degree=4, seed=0)
    with pytest.raises(ValueError, match="fused"):
        EulerSolver(n_parts=1, device="cpu", fused=False).solve_batch([g, g])
    with pytest.raises(ValueError, match="fused"):
        EulerSolver(n_parts=1, device="cpu").solve_batch([g, g], fused=False)
    assert EulerSolver(n_parts=1, device="cpu").solve_batch([]) == []
    assert solve_batch([], n_parts=1, device="cpu") == []
    with pytest.raises(ValueError, match="empty batch"):
        EulerSolver(n_parts=1, device="cpu").solve_batch_async([])


class _FakeSolver(EulerSolver):
    """Records solve calls; solves nothing (``tests/test_batched.py``'s
    stand-in)."""

    def __init__(self):
        super().__init__(n_parts=1, device="cpu")
        self.calls = []

    def bucket_of(self, graph, part_of_vertex=None):
        return graph.num_edges

    def solve(self, graph, part_of_vertex=None, fused=None):
        self.calls.append(("solve", [graph]))
        return ("res", graph)

    def solve_batch(self, graphs, fused=None):
        graphs = list(graphs)
        self.calls.append(("batch", graphs))
        return [("res", g) for g in graphs]


def _toy_graphs():
    def cycle(k):
        v = np.arange(k, dtype=np.int64)
        return Graph(k, v, np.roll(v, -1))

    return [cycle(4), cycle(8), cycle(4), cycle(8), cycle(4)]


def test_solve_many_batch_groups_and_preserves_order():
    solver = _FakeSolver()
    graphs = _toy_graphs()
    out = solver.solve_many(graphs, batch=2)
    assert [g for _, g in out] == graphs
    # bucket 4 → [g0, g2] and [g4]; bucket 8 → [g1, g3]: full chunks run
    # batched, the leftover on the one-graph program
    kinds = sorted((kind, len(gs)) for kind, gs in solver.calls)
    assert kinds == [("batch", 2), ("batch", 2), ("solve", 1)]


@pytest.mark.parametrize("batch", [None, 1])
def test_solve_many_batch_default_is_sequential(batch):
    solver = _FakeSolver()
    graphs = _toy_graphs()
    out = solver.solve_many(graphs, batch=batch)
    assert [kind for kind, _ in solver.calls] == ["solve"] * len(graphs)
    assert [g for _, g in out] == graphs


def test_solve_many_batch_real_session(modal):
    """``solve_many(batch=3)`` over the modal bucket's 8 graphs and one of
    another bucket: two full chunks batched, the bucket's 2 leftovers
    and the other graph solved alone, all in input order and byte-equal
    to sequential solves; the module-level form gives the same bytes."""
    _, key, graphs, seq = modal
    other = next(g for g in (eulerian_rmat(7, avg_degree=5, seed=s)
                             for s in range(8)))
    stream = graphs[:4] + [other] + graphs[4:]
    solver = EulerSolver(n_parts=8, device="cpu")
    got = solver.solve_many(stream, batch=3)
    want = seq[:4] + [solve(other, n_parts=8, device="cpu")] + seq[4:]
    assert [r.graph for r in got] == stream
    assert all(same_bytes(a, b) for a, b in zip(got, want))
    assert [r.cache.batch for r in got] == [3] * 4 + [1] + [3, 3, 1, 1]
    assert solver.cache_stats.traces == 3      # (key, 3), (key, None), other
    again = solve_many(graphs[:3], batch=3, n_parts=8, device="cpu")
    assert all(same_bytes(a, b) for a, b in zip(again, seq))


# ---------------------------------------------------------------------------
# solve_batch_async
# ---------------------------------------------------------------------------

def test_solve_batch_async_results_and_order(modal):
    """``results()`` equals ``solve_batch``; ``result()`` raises for
    B > 1; a batched pending and a one-graph pending fetched in reverse
    order each give their own bytes; one graph delegates to
    ``solve_async``."""
    _, _, graphs, seq = modal
    solver = EulerSolver(n_parts=8, device="cpu")
    pb = solver.solve_batch_async(graphs[:3])
    ps = solver.solve_async(graphs[5])
    assert len(pb) == 3 and pb.bucket == solver.bucket_of(graphs[0])
    with pytest.raises(ValueError, match="results"):
        pb.result()
    single = ps.result()
    got = pb.results()
    assert pb.ready() and pb.results() is got
    assert same_bytes(single, seq[5]) and single.cache.batch == 1
    assert all(same_bytes(a, b) for a, b in zip(got, seq))
    assert all(a.cache.batch == 3 for a in got)
    one = solver.solve_batch_async(graphs[:1])
    assert len(one) == 1 and same_bytes(one.result(), seq[0])


# ---------------------------------------------------------------------------
# the stacked-batch memo
# ---------------------------------------------------------------------------

def test_stacked_batch_memo_uploads_once(modal):
    """A repeat batch uploads nothing; a new composition uploads once
    (one ``state_uploads`` a stacked batch, whatever its width); the LRU
    holds 8 compositions; mixed edge counts raise."""
    _, key, graphs, seq = modal
    solver = EulerSolver(n_parts=8, device="cpu")
    ups = lambda: solver.cache_stats.state_uploads     # noqa: E731
    solver.solve_batch(graphs[:3])
    assert ups() == 1
    solver.solve_batch(graphs[:3])
    assert ups() == 1
    got = solver.solve_batch(graphs[1:4])
    assert ups() == 2
    assert all(same_bytes(a, b) for a, b in zip(got, seq[1:4]))
    eng = solver._engines[key]
    pgs = [solver._prepare(g, None)[0] for g in graphs]
    pairs = [(0, j) for j in range(1, 8)] + [(1, 2), (1, 3)]
    for i, j in pairs:                          # 9 new compositions
        eng.stage_batch([pgs[i], pgs[j]], solver.device)
    assert len(eng._batch_cache) == 8 and ups() == 2 + 9
    eng.stage_batch([pgs[0], pgs[3]], solver.device)   # still held
    assert ups() == 11
    eng.stage_batch([pgs[0], pgs[1]], solver.device)   # evicted: again
    assert ups() == 12
    small = EulerSolver(n_parts=8, device="cpu")._prepare(
        eulerian_rmat(7, avg_degree=5, seed=0), None)[0]
    with pytest.raises(ValueError, match="mixed edge counts"):
        eng.stage_batch([pgs[0], small], solver.device)


def test_batch_width_must_fit_int32():
    g = eulerian_rmat(5, avg_degree=4, seed=0)
    solver = EulerSolver(n_parts=2, device="cpu")
    key = solver.bucket_of(g)
    eng = solver._engine_for(key)
    with pytest.raises(ValueError, match="int32"):
        eng.fused_program(2**28, batch=8)
    assert eng.fused_program(key[0], batch=4).batch == 4


# ---------------------------------------------------------------------------
# a batched run's loops and shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", sorted(MODES))
def test_batched_rounds_are_the_members_most(reference, mode):
    """Each splice loop of a batched run runs until every member has
    converged: its rounds are the most any member needs alone."""
    batch = p3_batch(4, reference)[:2]
    solver = EulerSolver(n_parts=4, device="cpu", **MODES[mode])
    key = solver.bucket_of(batch[0])
    singles = []
    for g in batch:
        solver.solve(g)
        singles.append(solver._engines[key].fused_program(key[0])
                       .rounds_run())
    pending = solver.solve_batch_async(batch)
    pending.results()
    run = solver._engines[key].fused_program(key[0], 2)
    want = [max(r) for r in zip(*singles)]
    assert run.rounds_run() == pending._run.rounds_run() == want
    assert singles[0] != singles[1]


def test_batched_outputs_have_the_reference_layouts(modal):
    """``PendingRun.wait`` of a batch returns the reference's batched
    layouts: circuit ``[B, E]``, mate ``[B, 2E]``, flags and metrics
    ``[n, B, L, 4]``, ok ``[B]``."""
    solver, key, graphs, _ = modal
    e_cap, n, L = key[0], key[1], key[2]
    pending = solver.solve_batch_async(graphs[:3])
    out, timings = pending._run.wait()
    assert out.circuit.shape == (3, e_cap) and out.mate.shape == (3, 2 * e_cap)
    assert out.flags.shape == out.metrics.shape == (n, 3, L, 4)
    assert out.phase3_ok.shape == (3,) and out.phase3_ok.all()
    assert timings["run_s"] >= 0


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: CUDA graphs record only on the card")


def _recorded_launches(solver, graphs):
    """Solve ``graphs`` (one graph, or a batch) on the card; returns the
    K1–K4 launches counted while its program recorded (None: no
    recording)."""
    wrappers = (pd.pointer_double, pd.pointer_double_rank,
                pd.pointer_double_shard, pd.pointer_double_rank_shard)
    recorded = []
    record = FusedRun._record

    def counted(run):
        for w in wrappers:
            w.launches = 0
        record(run)
        recorded.append([w.launches for w in wrappers])

    from unittest import mock
    with mock.patch.object(FusedRun, "_record", counted):
        res = (solver.solve_batch(graphs) if len(graphs) > 1
               else [solver.solve(graphs[0])])
    return res, recorded[0] if recorded else None


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(MODES))
def test_cuda_batch_byte_equal_to_cpu_same_launches(mode):
    """On a card, in each Phase 3 mode: a B = 4 batch of the modal bucket
    is byte-equal to the CPU's sequential solves, and its recording
    launches each of K1–K4 as often as the one-graph recording."""
    _need_card()
    solver = EulerSolver(n_parts=8, **MODES[mode])
    _, graphs = modal_group(solver)
    single, n1 = _recorded_launches(solver, graphs[:1])
    got, nb = _recorded_launches(solver, graphs[:4])
    assert n1 is not None and nb == n1 and sum(n1) > 0
    cpu = EulerSolver(n_parts=8, device="cpu", **MODES[mode])
    for g, r in zip(graphs[:4], got):
        assert same_bytes(r.validate(), cpu.solve(g))
    assert same_bytes(single[0], got[0]) and solver.captures == 2


@pytest.mark.gpu
def test_cuda_evicting_a_batch_gives_its_pool_back():
    _need_card()
    solver = EulerSolver(n_parts=8)
    key, graphs = modal_group(solver)
    solver.solve_batch(graphs[:4])
    run = solver._engines[key].fused_program(key[0], 4)
    held = run.reserved_bytes
    assert held > 0
    before = torch.cuda.memory_reserved()
    solver._evict_entry((key, 4))
    freed = before - torch.cuda.memory_reserved()
    assert run.graph is None and freed >= 0.9 * held, (freed, held)
    assert (key[0], 4) not in solver._engines[key]._fused


if __name__ == "__main__":
    jax_reference(GOLDEN)
    sys.exit(0)
