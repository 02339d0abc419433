"""The port's asynchronous solves (``EulerSolver.solve_async`` →
``PendingSolve`` over the engine's ``PendingRun``) against the JAX
package's and against the port's own ``solve``.

The references' bytes are the golden files of the solve and session
tests (``tests/golden/torch_solve_reference.npz``, P = 2 at scale 6;
``tests/golden/torch_session_reference.npz``, two graphs of one bucket
at scale 8, P = 8), written by the JAX package, whose ``solve`` is its
``solve_async(g).result()``.  One live check runs the JAX package's
``solve_async`` in this process on one device (P = 1): two same-bucket
pendings fetched in reverse order, their bytes and their ``CacheStats``
stamped at fetch time.  On the CPU a launch runs its solve at once; the
pendings still own their outputs, so out-of-order fetches, evictions
and threads are checked here too.  The ``gpu`` tests run the same cases
on a card, where a launch only enqueues its replay."""
import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import capture
from repro_torch.euler import (EulerSolver, PendingRun, PendingSolve,
                               solve)
from repro_torch.graphgen.eulerize import eulerian_rmat
from test_torch_session import GOLDEN as SESSION_GOLDEN
from test_torch_solve import GOLDEN as SOLVE_GOLDEN
from test_torch_solve import MODES, _Undersized


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU solves here are small (scale 5–8): one intra-op
    thread runs them fastest and keeps them from contending with the
    suite's other workers; the setting is restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def golden():
    with np.load(SOLVE_GOLDEN) as a, np.load(SESSION_GOLDEN) as b:
        return {**dict(a), **dict(b)}


def same_bytes(a, b) -> bool:
    return (np.array_equal(a.circuit, b.circuit)
            and np.array_equal(a.mate, b.mate))


def counts(stats) -> dict:
    """The cumulative counters of a ``CacheStats`` of either package."""
    return {k: v for k, v in dataclasses.asdict(stats).items()
            if k not in ("bucket", "hit", "batch")}


def pair(golden):
    """Two graphs of one bucket at scale 8 (the session golden's
    ``solve_many`` seeds 0 and 3), whose splice loops run different
    rounds, with the JAX package's bytes of each."""
    seeds = golden["many/seeds"].tolist()
    return [(eulerian_rmat(8, avg_degree=5, seed=seeds[i]),
             (golden[f"many_{i}/circuit"], golden[f"many_{i}/mate"]))
            for i in (0, 3)]


def eager_rounds(solver, g):
    loops = capture.Loops(solver.device)
    with capture.counting(loops):
        solver.solve(g, fused=False)
    return loops.rounds_run()


def two_buckets():
    a = eulerian_rmat(5, avg_degree=4, seed=1)
    b = eulerian_rmat(6, avg_degree=4, seed=2)
    return a, b


# ---------------------------------------------------------------------------
# bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", sorted(MODES))
def test_async_result_is_solve_and_jax(golden, mode):
    """P = 2, scale 6, every Phase 3 mode: ``solve_async(g).result()``
    has the JAX package's bytes and ``solve(g)``'s, and is fused."""
    g = eulerian_rmat(6, avg_degree=4, seed=6)
    solver = EulerSolver(n_parts=2, device="cpu", fused=False, **MODES[mode])
    pending = solver.solve_async(g)
    assert isinstance(pending, PendingSolve)
    res = pending.result().validate()
    assert res.fused                         # whatever solver.fused says
    np.testing.assert_array_equal(res.circuit, golden["2_6/circuit"])
    np.testing.assert_array_equal(res.mate, golden["2_6/mate"])
    fused = EulerSolver(n_parts=2, device="cpu", **MODES[mode]).solve(g)
    assert same_bytes(res, fused)
    assert set(res.timings) == set(fused.timings)
    if mode == "no_gather":
        assert "host_emit_s" in res.timings


def test_live_jax_async_pair_bytes_and_stats():
    """The JAX package's ``solve_async`` on one device against the port's:
    two same-bucket pendings dispatched, then fetched in reverse order;
    the same bytes and the same ``CacheStats``, which both stamp at
    fetch time (the first dispatch, fetched last, sees the second's
    hit)."""
    from repro.euler import EulerSolver as JSolver
    from repro.graphgen.eulerize import eulerian_rmat as j_eulerian_rmat

    def run(make, gen):
        solver = make(n_parts=1)
        pa = solver.solve_async(gen(5, avg_degree=4, seed=1))
        pb = solver.solve_async(gen(5, avg_degree=4, seed=2))
        assert pa.bucket == pb.bucket
        rb = pb.result()
        ra = pa.result()
        return ra, rb

    ours = run(lambda **kw: EulerSolver(device="cpu", **kw), eulerian_rmat)
    theirs = run(JSolver, j_eulerian_rmat)
    for o, t in zip(ours, theirs):
        o.validate()
        np.testing.assert_array_equal(o.circuit, t.circuit)
        np.testing.assert_array_equal(o.mate, t.mate)
        assert (o.cache.hit, o.cache.batch) == (t.cache.hit, t.cache.batch)
        assert counts(o.cache) == counts(t.cache)
    ra, rb = ours
    assert not ra.cache.hit and rb.cache.hit
    assert ra.cache.hits == rb.cache.hits == 1     # stamped at fetch time


def test_in_flight_pendings_fetched_in_reverse_order(golden):
    """Two same-bucket pendings dispatched before either is fetched, then
    fetched in reverse order: each has its own one-shot bytes (the JAX
    package's) and its own splice rounds; the run's ``rounds_run`` is
    the last fetched one's."""
    (a, want_a), (b, want_b) = pair(golden)
    solver = EulerSolver(n_parts=8, device="cpu")
    pa, pb = solver.solve_async(a), solver.solve_async(b)
    rb, ra = pb.result().validate(), pa.result().validate()
    for res, want in ((ra, want_a), (rb, want_b)):
        np.testing.assert_array_equal(res.circuit, want[0])
        np.testing.assert_array_equal(res.mate, want[1])
    assert same_bytes(ra, solve(a, n_parts=8, device="cpu"))
    rounds_a, rounds_b = eager_rounds(solver, a), eager_rounds(solver, b)
    assert rounds_a != rounds_b
    assert pa._run.rounds_run() == rounds_a
    assert pb._run.rounds_run() == rounds_b
    key = solver.bucket_of(a)
    assert solver._engines[key].fused_program(key[0]).rounds_run() \
        == rounds_a


def test_result_twice_results_bucket_len():
    g = eulerian_rmat(5, avg_degree=4, seed=3)
    solver = EulerSolver(n_parts=2, device="cpu")
    pending = solver.solve_async(g)
    assert isinstance(pending._run, PendingRun)
    assert pending.ready()                   # the CPU ran it at launch
    assert len(pending) == 1 and pending.bucket == solver.bucket_of(g)
    res = pending.result()
    assert pending.result() is res and pending.results() == [res]
    assert pending.results()[0] is res and pending.ready()
    assert pending._run.wait() is pending._run.wait()


def test_undersized_caps_raise_at_result():
    """A failed run dispatches without a word and raises at ``result()``,
    at every call."""
    g = eulerian_rmat(6, avg_degree=4, seed=6)
    pending = _Undersized(n_parts=8, device="cpu").solve_async(g)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="flags failed"):
            pending.result()


def test_pending_outlives_its_evicted_program():
    """Under ``program_cache_max=1`` the next bucket's dispatch evicts
    the first bucket's program (its run freed) while the first is still
    pending; the pending keeps its outputs and returns its bytes."""
    a, b = two_buckets()
    solver = EulerSolver(n_parts=2, device="cpu", program_cache_max=1)
    key_a = solver.bucket_of(a)
    pa = solver.solve_async(a)
    run_a = solver._engines[key_a].fused_program(key_a[0])
    pb = solver.solve_async(b)
    assert run_a.inputs is None and run_a.out is None     # freed
    assert solver.cache_stats.evictions == 1
    ra, rb = pa.result().validate(), pb.result().validate()
    assert same_bytes(ra, solve(a, n_parts=2, device="cpu"))
    assert same_bytes(rb, solve(b, n_parts=2, device="cpu"))


def _two_threads(solver, graphs_of, want, rounds: int = 4):
    """Run ``rounds`` ``solve_async``/``result`` pairs in each of two
    threads on ``solver`` (thread ``i`` solves ``graphs_of[i]`` in turn)
    and check every result against ``want[id(graph)]``."""
    errors, done = [], []
    start = threading.Barrier(2, timeout=60)

    def work(graphs):
        try:
            start.wait()
            for i in range(rounds):
                g = graphs[i % len(graphs)]
                res = solver.solve_async(g).result().validate()
                if not same_bytes(res, want[id(g)]):
                    errors.append(f"thread result {i} differs")
            done.append(1)
        except Exception as e:          # reported by the main thread
            errors.append(repr(e))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        # thread-contract: both joined below with a timeout; the test
        # fails if either is still alive
        threads = [threading.Thread(target=work, args=(graphs,),
                                    daemon=True) for graphs in graphs_of]
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
    finally:
        sys.setswitchinterval(switch)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    assert len(done) == 2


def test_two_threads_byte_equal(golden):
    """Two threads, 4 pairs each on one solver: one bucket's two graphs
    in one thread, another bucket in the other; every result has its
    one-shot bytes."""
    (a, _), (b, _) = pair(golden)
    c = eulerian_rmat(8, avg_degree=5, seed=4)
    solver = EulerSolver(n_parts=8, device="cpu")
    assert solver.bucket_of(c) != solver.bucket_of(a)
    want = {id(g): solve(g, n_parts=8, device="cpu") for g in (a, b, c)}
    _two_threads(solver, ([a, b], [c]), want)
    cs = solver.cache_stats
    assert (cs.misses, cs.hits, cs.traces) == (2, 6, 2)


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: a launch is asynchronous only on the "
                    "card")


@pytest.mark.gpu
def test_cuda_in_flight_pendings_fetched_in_reverse_order(golden):
    _need_card()
    (a, want_a), (b, want_b) = pair(golden)
    solver = EulerSolver(n_parts=8)
    solver.solve(a)                                  # records
    pa, pb = solver.solve_async(a), solver.solve_async(b)
    rb, ra = pb.result().validate(), pa.result().validate()
    for res, want in ((ra, want_a), (rb, want_b)):
        np.testing.assert_array_equal(res.circuit, want[0])
        np.testing.assert_array_equal(res.mate, want[1])
    cpu = EulerSolver(n_parts=8, device="cpu")
    assert pa._run.rounds_run() == eager_rounds(cpu, a)
    assert pb._run.rounds_run() == eager_rounds(cpu, b)
    assert solver.captures == 1


@pytest.mark.gpu
def test_cuda_pending_outlives_its_evicted_program():
    """On a card: B's dispatch evicts A's program while A's replay may
    still run; the eviction waits for A's side stream, and A's pending
    returns its bytes."""
    _need_card()
    a, b = (eulerian_rmat(10, avg_degree=5, seed=1),
            eulerian_rmat(11, avg_degree=5, seed=1))
    solver = EulerSolver(n_parts=8, program_cache_max=1)
    solver.solve(a)
    pa = solver.solve_async(a)                       # a replay in flight
    pb = solver.solve_async(b)                       # evicts A, records B
    assert solver.cache_stats.evictions == 1
    assert same_bytes(pa.result().validate(),
                      solve(a, n_parts=8, device="cpu"))
    assert same_bytes(pb.result().validate(),
                      solve(b, n_parts=8, device="cpu"))


@pytest.mark.gpu
def test_cuda_two_threads_record_beside_replays():
    """On a card: one thread records a cold bucket (and then replays it)
    while the other replays a warm one, 4 pairs each; every result has
    its CPU bytes."""
    _need_card()
    a, b = (eulerian_rmat(9, avg_degree=5, seed=1),
            eulerian_rmat(10, avg_degree=5, seed=1))
    solver = EulerSolver(n_parts=8)
    solver.solve(a)                                  # A warm
    want = {id(g): solve(g, n_parts=8, device="cpu") for g in (a, b)}
    _two_threads(solver, ([b], [a]), want)
    assert solver.captures == 2


@pytest.mark.gpu
def test_cuda_ready_is_false_while_the_replay_runs():
    _need_card()
    g = eulerian_rmat(14, avg_degree=5, seed=0)
    solver = EulerSolver(n_parts=8)
    first = solver.solve(g)                          # records
    pending = solver.solve_async(g)
    assert not pending.ready()
    res = pending.result()
    assert pending.ready() and same_bytes(res, first)
