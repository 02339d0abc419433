"""The port's Euler serving loop (``repro_torch.launch.serve``:
``MicroBatcher``, ``main_euler``, static and ``--adaptive``), its flush
accounting
(``repro_torch.euler.autotune.FlushLog``) and the session's width ladder
and byte budget (``EulerSolver.prewarm``/``warmed_widths``,
``program_cache_bytes``, pins), all on the CPU.

The batcher's cases port ``tests/test_batched.py``'s over a stand-in
solver that subclasses the port's ``EulerSolver(device="cpu")``; the
budget's port ``tests/test_autotune.py``'s with ``_program_cost``
patched, plus the port's own rule (a miss is charged a prediction before
it records: measured bytes, else the static model scaled by the measured
reserved/model ratio; trued up to the recording's reserved bytes
after).  A
laddered flush's results are held against the JAX package's bytes for
the same graphs: the golden ``tests/golden/torch_batch_reference.npz``
(the JAX package's ``solve_batch`` of the scale-8 modal bucket at P = 8,
which that package's own tests hold equal to its ``solve``;
``tests/test_torch_batch.py::test_batch_golden_is_the_jax_output``
solves the golden again live).  The JAX package is not imported here:
``main_euler``'s JSON keys are read from the reference's source."""
import ast
import dataclasses
import doctest
import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import REPO
from repro_torch.analysis import program_cost_bytes
from repro_torch.core.engine import Engine, FusedRun
from repro_torch.core.graph import Graph
from repro_torch.euler import EulerSolver, FlushLog, modal_bucket_pool
from repro_torch.euler import autotune
from repro_torch.graphgen.eulerize import eulerian_rmat
from repro_torch.launch import serve
from repro_torch.launch.serve import MicroBatcher

GOLDEN = Path(REPO) / "tests" / "golden" / "torch_batch_reference.npz"
REFERENCE_SERVE = Path(REPO) / "src" / "repro" / "launch" / "serve.py"
REFERENCE_AUTOTUNE = Path(REPO) / "src" / "repro" / "euler" / "autotune.py"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU solves here are small (scale 8 at most): one
    intra-op thread runs them fastest and keeps them from contending with
    the suite's other workers; the setting is restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# a stand-in solver (tests/test_batched.py's)
# ---------------------------------------------------------------------------

class _FakePending:
    """Stand-in for ``PendingSolve``: completion is set from outside
    (``is_ready``) and each blocking fetch is recorded on the solver."""

    def __init__(self, solver, results):
        self._solver = solver
        self._results = results
        self.is_ready = True

    def ready(self):
        return self.is_ready

    def results(self):
        self._solver.fetches.append([g for _, g in self._results])
        return self._results


class _FakeSolver(EulerSolver):
    """Records solve and dispatch calls; solves nothing.  Its warmed
    widths are set per test (``warmed``), standing in for the real
    ``warmed_widths`` the batcher splits flushes on."""

    def __init__(self):
        super().__init__(n_parts=1, device="cpu")
        self.calls = []
        self.fetches = []       # blocking results() fetches, in order
        self.pendings = []
        self.warmed = []
        self.auto_ready = True  # False: dispatches stay "running"

    def bucket_of(self, graph, part_of_vertex=None):
        return graph.num_edges  # bucket by size, no prep needed

    def warmed_widths(self, key):
        return sorted(set(self.warmed) | {1})

    def solve(self, graph, part_of_vertex=None, fused=None):
        self.calls.append(("solve", [graph]))
        return ("res", graph)

    def solve_batch(self, graphs, fused=None):
        graphs = list(graphs)
        self.calls.append(("batch", graphs))
        return [("res", g) for g in graphs]

    def _pending(self, kind, graphs):
        self.calls.append((kind, graphs))
        pend = _FakePending(self, [("res", g) for g in graphs])
        pend.is_ready = self.auto_ready
        self.pendings.append(pend)
        return pend

    def solve_async(self, graph, part_of_vertex=None):
        return self._pending("solve", [graph])

    def solve_batch_async(self, graphs):
        return self._pending("batch", list(graphs))


def _cycle(k):
    v = np.arange(k, dtype=np.int64)
    return Graph(k, v, np.roll(v, -1))


def _toy_graphs():
    return [_cycle(4), _cycle(8), _cycle(4), _cycle(8), _cycle(4)]


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------------
# MicroBatcher (tests/test_batched.py:201-327)
# ---------------------------------------------------------------------------

def test_micro_batcher_quota_deadline_drain():
    solver = _FakeSolver()
    solver.warmed = [2]   # quota width prewarmed; the loop never records
    clock = _Clock()
    mb = MicroBatcher(solver, max_batch=2, deadline_s=0.010, clock=clock)
    graphs = _toy_graphs()  # buckets: 4, 8, 4, 8, 4

    assert mb.submit(0, graphs[0]) == []          # bucket 4: 1 pending
    assert mb.submit(1, graphs[1]) == []          # bucket 8: 1 pending
    done = mb.submit(2, graphs[2])                # bucket 4 hits quota
    assert [seq for seq, _ in done] == [0, 2]
    assert solver.calls[-1] == ("batch", [graphs[0], graphs[2]])

    assert mb.poll() == []                        # deadline not reached
    clock.t = 0.011
    done = mb.poll()                              # bucket 8 flushes partial
    assert [seq for seq, _ in done] == [1]
    # a partial flush uses the one-graph program, not a one-off
    # (bucket, 1) batched recording
    assert solver.calls[-1] == ("solve", [graphs[1]])

    assert mb.submit(4, graphs[4]) == []
    done = mb.drain()
    assert [seq for seq, _ in done] == [4]
    assert mb.pending == {}
    assert list(mb.flushes.recent) == [2, 1, 1]
    assert mb.flushes.hist == {2: 1, 1: 2} and mb.flushes.total == 3


def test_micro_batcher_width_ladder_decomposes_partial_flush():
    """A 5-deep deadline flush with a warmed {2, 4} ladder runs as one
    B=4 + one B=1 dispatch — never five B=1 solves, never an unwarmed
    width."""
    solver = _FakeSolver()
    solver.warmed = [2, 4]
    clock = _Clock()
    mb = MicroBatcher(solver, max_batch=8, deadline_s=0.010, clock=clock)
    graphs = [_cycle(4) for _ in range(5)]
    for i, g in enumerate(graphs):
        assert mb.submit(i, g) == []
    clock.t = 0.011
    done = mb.poll()
    assert [seq for seq, _ in done] == [0, 1, 2, 3, 4]
    assert list(mb.flushes.recent) == [4, 1]
    assert [(k, len(gs)) for k, gs in solver.calls] == \
        [("batch", 4), ("solve", 1)]


def test_micro_batcher_never_dispatches_unwarmed_width():
    """A quota flush on a bucket with no prewarmed widths splits into B=1
    dispatches: recording a new batch program inside the serving loop
    would stall every in-flight request behind it."""
    solver = _FakeSolver()          # warmed = [] → only B=1 available
    mb = MicroBatcher(solver, max_batch=2, deadline_s=0.010,
                      clock=_Clock())
    graphs = [_cycle(4) for _ in range(2)]
    mb.submit(0, graphs[0])
    done = mb.submit(1, graphs[1])  # quota hit, max_batch unwarmed
    assert [seq for seq, _ in done] == [0, 1]
    assert list(mb.flushes.recent) == [1, 1]
    assert [k for k, _ in solver.calls] == ["solve", "solve"]


def test_micro_batcher_deadline_fires_under_paused_producer():
    """A lone request does not wait for the quota: once its deadline
    passes, poll() flushes it though the producer stopped submitting."""
    solver = _FakeSolver()
    clock = _Clock()
    mb = MicroBatcher(solver, max_batch=4, deadline_s=0.010, clock=clock)
    graphs = _toy_graphs()

    assert mb.submit(0, graphs[0]) == []
    clock.t = 0.009
    assert mb.poll() == []
    clock.t = 0.0101
    done = mb.poll()
    assert [seq for seq, _ in done] == [0]
    assert mb.pending == {}
    assert solver.calls == [("solve", [graphs[0]])]


def test_micro_batcher_pipeline_backpressure_and_drain_order():
    """The in-flight window blocks on the OLDEST dispatch when full, so
    fetches happen in dispatch order and drain() delivers every result
    exactly once, seq-sorted (submit order)."""
    solver = _FakeSolver()
    solver.auto_ready = False           # every dispatch "still running"
    mb = MicroBatcher(solver, max_batch=1, deadline_s=9.0,
                      clock=_Clock(), pipeline_depth=1)
    graphs = _toy_graphs()

    out = []
    for i, g in enumerate(graphs):
        out.extend(mb.submit(i, g))     # max_batch=1: dispatches at once
    # depth-1 window: submit i+1 had to block-harvest dispatch i
    assert solver.fetches == [[g] for g in graphs[:-1]]
    out.extend(mb.drain())
    assert [seq for seq, _ in out] == list(range(len(graphs)))
    assert len(mb.inflight) == 0
    # one latency observation a delivered request, all 0 under the clock
    assert mb.latencies.count == len(graphs)
    assert mb.latencies.sum == 0.0


def test_micro_batcher_sync_mode_is_depth_zero():
    """pipeline_depth=0 is the synchronous loop: every dispatch is
    harvested before _flush returns."""
    solver = _FakeSolver()
    solver.auto_ready = False
    mb = MicroBatcher(solver, max_batch=2, deadline_s=9.0,
                      clock=_Clock(), pipeline_depth=0)
    graphs = _toy_graphs()
    done = mb.submit(0, graphs[0]) + mb.submit(1, graphs[2])  # bucket 4
    assert [seq for seq, _ in done] == [0, 1]
    assert len(mb.inflight) == 0


def test_micro_batcher_rejects_bad_settings():
    with pytest.raises(ValueError, match="max_batch"):
        MicroBatcher(_FakeSolver(), max_batch=0)
    with pytest.raises(ValueError, match="pipeline_depth"):
        MicroBatcher(_FakeSolver(), pipeline_depth=-1)


# ---------------------------------------------------------------------------
# FlushLog (tests/test_autotune.py:26 and the class's doctest)
# ---------------------------------------------------------------------------

def test_flush_log_is_bounded_and_tracks_first_wide():
    t = [0.0]
    log = FlushLog(recent_max=4, clock=lambda: t[0])
    for i in range(100):
        t[0] = float(i)
        log.observe(1)
    assert log.first_wide_t is None and log.narrow_before_wide == 100
    t[0] = 100.0
    log.observe(8)
    t[0] = 101.0
    log.observe(8)
    for i in range(100):
        log.observe(1)
    # histogram + rolling window stay O(#widths + recent_max) forever
    assert log.hist == {1: 200, 8: 2}
    assert list(log.recent) == [1, 1, 1, 1]
    assert log.total == len(log) == 202 and log.requests == 216
    # first-wide marker is sticky: set once, at the 8-wide dispatch
    assert log.first_wide_t == 100.0 and log.narrow_before_wide == 100
    assert log.widths() == [1, 8]
    assert log.mean_width() == pytest.approx(216 / 202)


def test_flush_log_doctest():
    res = doctest.testmod(autotune)
    assert res.attempted == 7 and res.failed == 0


# ---------------------------------------------------------------------------
# the program LRU and its byte budget (tests/test_batched.py:370,
# tests/test_autotune.py:343), and the port's predict-then-true-up rule
# ---------------------------------------------------------------------------

def test_program_cache_lru_eviction_and_warmed_widths():
    solver = EulerSolver(n_parts=1, device="cpu", program_cache_max=2)
    k1, k2, k3 = ("b1",), ("b2",), ("b3",)
    assert not solver._account(k1, None)       # miss, cached
    assert not solver._account(k2, None)       # miss, cached (full)
    assert solver._account(k1, None)           # hit — k1 becomes MRU
    assert not solver._account(k3, None)       # miss — evicts LRU k2
    cs = solver.cache_stats
    assert (cs.hits, cs.misses, cs.evictions) == (1, 3, 1)
    assert [k for k, _ in solver._programs] == [k1, k3]
    # eviction also removes the bucket's width from the warm set
    assert solver.warmed_widths(k2) == []
    assert solver.warmed_widths(k1) == [1]
    assert not solver._account(k1, 4)          # evicts (k1, None), the LRU
    assert solver.warmed_widths(k1) == [4]
    assert solver.warmed_widths(k3) == [1]


def test_program_cache_byte_budget_evicts_lru_but_not_pinned():
    solver = EulerSolver(n_parts=1, device="cpu", program_cache_max=10,
                         program_cache_bytes=25)
    solver._program_cost = lambda key, batch: 10    # 10 bytes/program
    k1, k2, k3 = ("b1",), ("b2",), ("b3",)
    solver._account(k1, None)
    assert solver.pin_program(k1, 1)                # live → pinnable
    solver._account(k2, None)
    assert solver.cache_bytes_used() == 20
    solver._account(k3, None)                       # 30 > 25: evict LRU...
    assert solver.cache_bytes_used() == 20
    # ...but the pinned k1 survives; unpinned k2 went instead
    assert solver.warmed_widths(k1) == [1]
    assert solver.warmed_widths(k2) == []
    assert solver.warmed_widths(k3) == [1]
    assert solver.pinned_programs() == [(k1, 1)]
    assert solver.cache_stats.evictions == 1
    # unpin → droppable; drop_program refuses pinned entries
    assert not solver.drop_program(k1, 1)
    assert solver.unpin_program(k1, 1)
    assert not solver.unpin_program(k1, 1)
    assert solver.drop_program(k1, 1)
    assert not solver.drop_program(k1, 1)           # absent now
    assert solver.warmed_widths(k1) == []
    # pinning a program that isn't live fails cleanly
    assert not solver.pin_program(("nope",), 1)
    assert solver._g_bytes.value == solver.cache_bytes_used() == 10


def test_evicted_program_loses_its_pin():
    """An engine dropped from the session's FIFO takes its programs with
    it, pins included (the one path that evicts a pinned program)."""
    solver = EulerSolver(n_parts=1, device="cpu")
    solver._engines_max = 1
    ka, kb = (solver.bucket_of(eulerian_rmat(s, avg_degree=4, seed=1))
              for s in (5, 6))
    solver._engine_for(ka)
    solver._account(ka, 2)
    assert solver.pin_program(ka, 2)
    assert solver.pinned_programs() == [(ka, 2)]
    solver._engine_for(kb)
    assert solver.pinned_programs() == [] and solver.warmed_widths(ka) == []
    assert solver.cache_stats.evictions == 1


def test_true_up_charges_measured_bytes_and_predicts_from_them():
    """The port's cost: a miss is charged the bytes measured this session
    for its (e_cap, B), else its e_cap's nearest width scaled by B, else
    the static model (``program_cost_bytes``, the reference's charge)
    times the largest reserved/model ratio measured (1 before any); the
    recording's reserved bytes replace the charge and predict the next;
    a true-up over the budget evicts others, never the new program."""
    solver = EulerSolver(n_parts=1, device="cpu", program_cache_bytes=100)
    k1 = solver.bucket_of(eulerian_rmat(5, avg_degree=4, seed=1))
    k2 = (*k1[:3], dataclasses.replace(k1[3], park_cap=k1[3].park_cap + 8))
    k3 = solver.bucket_of(eulerian_rmat(7, avg_degree=4, seed=1))
    assert k3[0] > k1[0]
    m1, m3 = (program_cost_bytes(k, None) for k in (k1, k3))
    assert solver._program_cost(k1, None) == m1 > 0  # nothing measured
    assert solver._program_cost(k1, 4) == program_cost_bytes(k1, 4)
    assert solver._program_cost(k3, None) == m3 > m1
    solver._account(k1, None)
    solver._true_up(k1, None, 40)
    assert solver.cache_bytes_used() == 40
    assert solver._program_cost(k2, None) == 40      # same (e_cap, 1)
    assert solver._program_cost(k2, 4) == 160        # scaled by B
    # another e_cap: its model times the measured ratio
    assert solver._program_cost(k3, None) == int(m3 * (40 / m1))
    solver._account(k1, 2)      # predicted 80: 120 > 100, k1/None goes
    assert solver.warmed_widths(k1) == [2]
    assert solver.cache_bytes_used() == 80
    solver._true_up(k1, 2, 70)
    assert solver.cache_bytes_used() == 70
    assert solver._program_cost(k2, 2) == 70
    assert solver._program_cost(k2, None) == 40
    assert solver._program_cost(k2, 4) == 140        # nearest width: 2
    assert solver._program_cost(k2, 3) == 105
    # the ratio is the largest measured (70 of the model of (k1, 2) is
    # less than 40 of k1's)
    assert solver._program_cost(k3, 2) == int(
        program_cost_bytes(k3, 2) * (40 / m1))
    # a program evicted before its true-up only leaves its measurement
    solver._account(k3, None)   # predicted about 2·40: (k1, 2) goes
    assert solver.warmed_widths(k1) == []
    assert solver.drop_program(k3, 1)
    solver._true_up(k3, None, 30)
    assert solver.cache_bytes_used() == 0
    assert solver._program_cost(k3, None) == 30
    solver._account(k1, 2)      # measured 70
    solver._account(k2, None)   # predicted 40: 110 > 100, (k1, 2) goes
    assert solver.warmed_widths(k1) == [] and solver.cache_bytes_used() == 40
    solver._true_up(k2, None, 120)   # over the budget alone: it stays
    assert solver.warmed_widths(k2) == [1]
    assert solver.cache_bytes_used() == solver._g_bytes.value == 120


def test_budget_evicts_at_account_once_a_true_up_set_the_ratio(monkeypatch):
    """Bucket A's true-up sets the reserved/model ratio; bucket B, a
    larger e_cap never measured, is then charged its model times that
    ratio at its ``_account``, which evicts A before B's first launch
    (on the card: before B records).  Before any true-up B's charge is
    its model alone, which A's model-sized charge leaves room for."""
    a, b = (eulerian_rmat(5, avg_degree=4, seed=1),
            eulerian_rmat(7, avg_degree=4, seed=1))
    solver = EulerSolver(n_parts=1, device="cpu")
    ka, kb = solver.bucket_of(a), solver.bucket_of(b)
    ma, mb = (program_cost_bytes(k, None) for k in (ka, kb))
    reserved_a = 15 * ma          # about a recorded graph's pool
    solver.program_cache_bytes = int(1.5 * reserved_a)
    assert ma + mb <= solver.program_cache_bytes < reserved_a + 15 * mb
    events = []
    evict, launch = Engine.evict_program, FusedRun.launch

    def counted_evict(self, num_edges, batch):
        events.append(("evict", num_edges))
        return evict(self, num_edges, batch)

    def counted_launch(self, *args):
        events.append(("launch", self.num_edges))
        return launch(self, *args)

    monkeypatch.setattr(Engine, "evict_program", counted_evict)
    monkeypatch.setattr(FusedRun, "launch", counted_launch)
    solver.solve(a).validate()
    assert solver.cache_bytes_used() == ma      # the CPU records nothing
    solver._true_up(ka, None, reserved_a)       # what a card measures
    assert solver.cache_bytes_used() == reserved_a
    predicted = solver._program_cost(kb, None)
    assert predicted == int(mb * (reserved_a / ma))
    solver.solve(b).validate()
    assert events == [("launch", ka[0]), ("evict", ka[0]),
                      ("launch", kb[0])]
    assert solver.warmed_widths(ka) == [] and solver.warmed_widths(kb) == [1]
    assert solver.cache_bytes_used() == predicted
    assert solver.cache_stats.evictions == 1


def test_budget_evicts_before_the_recording(monkeypatch):
    """With a patched cost, the second bucket's miss evicts the first
    bucket's program before its own program's first launch (on the card
    that launch records), and the first bucket's repeat evicts the
    second's before recording again; every result validates."""
    a, b = (eulerian_rmat(5, avg_degree=4, seed=1),
            eulerian_rmat(6, avg_degree=4, seed=2))
    solver = EulerSolver(n_parts=1, device="cpu", program_cache_bytes=15)
    solver._program_cost = lambda key, batch: 10
    ea, eb = solver.bucket_of(a)[0], solver.bucket_of(b)[0]
    assert ea != eb
    events = []
    evict, launch = Engine.evict_program, FusedRun.launch

    def counted_evict(self, num_edges, batch):
        events.append(("evict", num_edges))
        return evict(self, num_edges, batch)

    def counted_launch(self, *args):
        events.append(("launch", self.num_edges))
        return launch(self, *args)

    monkeypatch.setattr(Engine, "evict_program", counted_evict)
    monkeypatch.setattr(FusedRun, "launch", counted_launch)
    for g in (a, b, a):
        solver.solve(g).validate()
        assert solver.cache_bytes_used() == 10 <= solver.program_cache_bytes
    assert events == [("launch", ea), ("evict", ea), ("launch", eb),
                      ("evict", eb), ("launch", ea)]
    assert solver.cache_stats.evictions == 2


# ---------------------------------------------------------------------------
# the width ladder on a real session (tests/test_batched.py:394)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference():
    with np.load(GOLDEN) as z:
        return dict(z)


def test_prewarm_and_laddered_flush_are_the_jax_output(reference,
                                                       monkeypatch):
    """prewarm (1, 2) records both widths once (one prep and one table
    build for the repeated graph, one upload a width), a second call
    records nothing; a 3-request flush then runs as B = 2 + B = 1, whose
    results are the JAX package's bytes; a warm repeat solve uploads
    nothing."""
    solver = EulerSolver(n_parts=8, device="cpu")
    seeds = reference["modal/seeds"].tolist()[:3]
    group = [eulerian_rmat(8, avg_degree=5, seed=s) for s in seeds]
    calls = {"partition": 0, "load": 0}
    partition, load = EulerSolver._partition, Engine.load

    def counted_partition(self, *args):
        calls["partition"] += 1
        return partition(self, *args)

    def counted_load(self, *args):
        calls["load"] += 1
        return load(self, *args)

    monkeypatch.setattr(EulerSolver, "_partition", counted_partition)
    monkeypatch.setattr(Engine, "load", counted_load)
    key = solver.bucket_of(group[1])
    assert {solver.bucket_of(g) for g in group} == {key}
    assert solver.prewarm(group[0], widths=(1, 2)) == [1, 2]
    assert calls == {"partition": 3, "load": 1}
    assert solver.cache_stats.state_uploads == 2
    assert solver.prewarm(group[0], widths=(2, 1)) == []   # idempotent
    assert solver.warmed_widths(key) == [1, 2]
    assert solver.cache_stats.prewarms == 2

    mb = MicroBatcher(solver, max_batch=8, deadline_s=0.0)
    for i, g in enumerate(group):
        assert mb.submit(i, g) == []      # below quota, nothing due
    done = dict(mb.drain())
    assert sorted(done) == [0, 1, 2]
    assert list(mb.flushes.recent) == [2, 1], mb.flushes.hist
    assert done[0].cache.batch == 2 and done[2].cache.batch == 1
    for i, g in enumerate(group):
        done[i].validate()
        assert np.array_equal(done[i].circuit,
                              reference[f"modal_B3_{i}/circuit"]), i
        assert np.array_equal(done[i].mate,
                              reference[f"modal_B3_{i}/mate"]), i

    up0 = solver.cache_stats.state_uploads
    r = solver.solve(group[0])
    assert r.cache.hit
    assert solver.cache_stats.state_uploads == up0


def test_prewarm_defaults_to_the_session_ladder():
    solver = EulerSolver(n_parts=1, device="cpu", width_ladder=(4, 2, 2, 1))
    assert solver.width_ladder == (1, 2, 4)
    g = eulerian_rmat(5, avg_degree=4, seed=1)
    assert solver.prewarm(g) == [1, 2, 4]
    assert solver.warmed_widths(solver.bucket_of(g)) == [1, 2, 4]
    assert solver.prewarm(g, widths=(0, 1)) == []        # 0 counts as 1


def test_modal_bucket_pool():
    solver = EulerSolver(n_parts=8, device="cpu")
    graphs = [eulerian_rmat(8, avg_degree=5, seed=s) for s in range(12)]
    pool = modal_bucket_pool(solver, graphs, 4)
    assert len(pool) == 4
    assert len({solver.bucket_of(g) for g in pool}) == 1
    assert [id(g) for g in pool] == [id(g) for g in graphs
                                     if solver.bucket_of(g) ==
                                     solver.bucket_of(pool[0])][:4]
    # a graph too small for the partition count is skipped, not raised
    assert modal_bucket_pool(solver, [_cycle(4)], 4) == []


# ---------------------------------------------------------------------------
# main_euler (the reference's static path)
# ---------------------------------------------------------------------------

def reference_static_keys() -> set:
    """The keys of the ``stats`` dict that the reference's ``main_euler``
    writes to ``--json`` (its static path: before the autotuner's
    ``stats.update``), read from its source."""
    tree = ast.parse(REFERENCE_SERVE.read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "main_euler")
    stats = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
                 and any(isinstance(t, ast.Name) and t.id == "stats"
                         for t in n.targets))
    return {k.value for k in stats.keys}


def test_main_euler_serves_on_cpu(tmp_path, monkeypatch, capsys):
    delivered = []
    harvest = MicroBatcher._harvest_one

    def kept(self):
        out = harvest(self)
        delivered.extend(out)
        return out

    monkeypatch.setattr(MicroBatcher, "_harvest_one", kept)
    out = tmp_path / "serve.json"
    thr = serve.main(["--device", "cpu", "--scale", "6", "--parts", "2",
                      "--requests", "12", "--json", str(out)])
    stats = json.loads(out.read_text().splitlines()[-1])
    keys = reference_static_keys()
    assert len(keys) == 27 and set(stats) == keys
    assert stats["workload"] == "euler-serve" and not stats["adaptive"]
    assert stats["served"] == 12 and stats["parts"] == 2
    assert thr > 0 and stats["prewarms"] > 0
    assert sum(int(w) * c for w, c in stats["width_hist"].items()) == 12
    assert sorted(s for s, _ in delivered) == list(range(12))
    delivered[-1][1].validate()
    assert "circuits/s" in capsys.readouterr().out


def test_main_euler_sync_eager_and_same_bucket_on_cpu(tmp_path):
    out = tmp_path / "serve.json"
    serve.main_euler(["--device", "cpu", "--scale", "6", "--parts", "2",
                      "--requests", "5", "--eager", "--json", str(out)])
    serve.main_euler(["--device", "cpu", "--scale", "6", "--parts", "2",
                      "--requests", "6", "--same-bucket", "--pool", "3",
                      "--sync", "--no-prewarm", "--max-batch", "3",
                      "--json", str(out)])
    eager, sync = (json.loads(x) for x in out.read_text().splitlines())
    assert eager["max_batch"] == 1 and eager["pipeline_depth"] == 0
    assert eager["width_hist"] == {"1": 5} and eager["prewarms"] == 0
    assert sync["pipeline_depth"] == 0 and sync["buckets"] == 1
    assert sync["prewarms"] == 0 and set(sync["width_hist"]) == {"1"}
    assert sync["hits"] == 2 + 6 and sync["misses"] == 1


def reference_tuner_keys() -> set:
    """The keys of the reference's ``AutoTuner.stats()``, which its
    ``main_euler --adaptive`` adds to the ``--json`` line, read from its
    source."""
    tree = ast.parse(REFERENCE_AUTOTUNE.read_text())
    cls = next(n for n in tree.body if isinstance(n, ast.ClassDef)
               and n.name == "AutoTuner")
    fn = next(n for n in cls.body if isinstance(n, ast.FunctionDef)
              and n.name == "stats")
    ret = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Return))
    return {k.value for k in ret.keys}


def test_main_euler_adaptive_on_cpu(tmp_path, monkeypatch, capsys):
    """``--adaptive`` at scale 6, P = 2, one bucket's pool of 3 and a
    quota of 2: no cold sweep, all 12 requests delivered once and valid,
    the tuner stepped, and the JSON line holds the reference's static
    keys plus its ``AutoTuner.stats()`` keys; the compile thread is
    stopped when ``main_euler`` returns."""
    delivered = []
    harvest = MicroBatcher._harvest_one

    def kept(self):
        out = harvest(self)
        for _, r in out:
            r.validate()
        delivered.extend(out)
        return out

    monkeypatch.setattr(MicroBatcher, "_harvest_one", kept)
    out = tmp_path / "serve.json"
    thr = serve.main(["--device", "cpu", "--scale", "6", "--parts", "2",
                      "--same-bucket", "--pool", "3", "--max-batch", "2",
                      "--requests", "12", "--adaptive", "--json", str(out)])
    stats = json.loads(out.read_text().splitlines()[-1])
    tuner_keys = reference_tuner_keys()
    assert len(tuner_keys) == 8
    assert set(stats) == reference_static_keys() | tuner_keys
    assert stats["adaptive"] and stats["served"] == 12 and thr > 0
    assert stats["cold_s"] == 0.0 and stats["tuner_steps"] >= 1
    assert stats["buckets"] == stats["tuner_buckets"] == 1
    assert sum(int(w) * c for w, c in stats["width_hist"].items()) == 12
    assert sorted(s for s, _ in delivered) == list(range(12))
    assert not any(t.name == "compile-service" and t.is_alive()
                   for t in threading.enumerate())
    text = capsys.readouterr().out
    assert "adaptive: first wide flush at" in text
    assert "cold pass" not in text


@pytest.mark.parametrize("extra", [["--eager"], ["--max-batch", "1"]])
def test_main_euler_adaptive_needs_a_ladder(extra):
    with pytest.raises(SystemExit, match="--adaptive needs"):
        serve.main(["--device", "cpu", "--adaptive"] + extra)


def test_main_euler_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--scale", "6", "--parts", "2", "--requests", "2"])
