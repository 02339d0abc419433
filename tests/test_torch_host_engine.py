"""The port's host backend (``repro_torch.core.host_engine``, the
solver's ``backend="host"``) and its ``splice_components_np`` against the
JAX package's, live on the CPU: the host engine is numpy and scipy in
both packages, so the same graph and options must give the same bytes in
``circuit`` and ``mate``, the same supersteps and merge tree and every
``LevelStats`` field but the wall-clock ``phase1_seconds``.  Also the
ports of the reference's host-engine tests, the host solver's rules, and
both port examples run in a subprocess."""
import dataclasses
import itertools
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # optional dev dependency — fall back to the shim
    from _hypofallback import given, settings, st

from conftest import REPO
from repro.core.phase3 import splice_components_np as j_splice
from repro.euler import solve as j_solve
from repro.graphgen.eulerize import eulerian_rmat as j_eulerian_rmat
from repro_torch.core.graph import Graph, partition_graph
from repro_torch.core.hierholzer import hierholzer_circuit, validate_circuit
from repro_torch.core.memory import LevelStats
from repro_torch.core.phase3 import circuit_from_mate_np, splice_components_np
from repro_torch.euler import CacheStats, EulerResult, EulerSolver, solve
from repro_torch.euler import solver as solver_mod
from repro_torch.graphgen.eulerize import (eulerian_rmat, eulerize,
                                           largest_component)
from repro_torch.graphgen.partition import partition_vertices

#: (remote_dedup, deferred_transfer): both §5 heuristics, each alone, none
HEURISTICS = list(itertools.product((True, False), repeat=2))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The device-backend solves here are small (scale ≤ 8): one intra-op
    thread runs them fastest and keeps them from contending with the
    suite's other workers; the setting is restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_graph(g) -> Graph:
    return Graph(g.num_vertices, g.edge_u.copy(), g.edge_v.copy())


def cycles_edges(cycles):
    eu, ev = [], []
    for cyc in cycles:
        for i in range(len(cyc)):
            eu.append(cyc[i])
            ev.append(cyc[(i + 1) % len(cyc)])
    return np.array(eu, dtype=np.int64), np.array(ev, dtype=np.int64)


def graph_of_cycles(n_vertices, cycles) -> Graph:
    return Graph(n_vertices, *cycles_edges(cycles))


#: the multi-component-pivot graphs of the reference's backend-parity
#: test: edge-disjoint cycles meeting only at pivot vertices
PIVOTS = {
    "flower5": (11, [[0, 1, 2], [0, 3, 4], [0, 5, 6], [0, 7, 8],
                     [0, 9, 10]]),
    "chain5": (10, [[0, 1, 2], [1, 3, 4], [4, 5, 6], [6, 7, 8],
                    [8, 9, 0]]),
}


def as_dict(x):
    return dataclasses.asdict(x)


def assert_same_host_result(ours, theirs):
    """Byte identity of two host results, every field the engine fills
    but the wall-clock ``phase1_seconds`` (whose keys must match)."""
    for name in ("circuit", "mate"):
        a, b = getattr(ours, name), getattr(theirs, name)
        assert a.dtype == b.dtype == np.int64, name
        assert a.tobytes() == b.tobytes(), name
    assert ours.supersteps == theirs.supersteps
    assert ours.backend == theirs.backend == "host"
    assert ours.fused is theirs.fused is False
    assert ours.padded_edges == theirs.padded_edges == 0
    assert as_dict(ours.cache) == as_dict(theirs.cache)
    assert ours.phase3_converged == theirs.phase3_converged
    assert [as_dict(lv) for lv in ours.tree.levels] == \
        [as_dict(lv) for lv in theirs.tree.levels]
    assert ours.tree.root == theirs.tree.root
    assert len(ours.levels) == len(theirs.levels)
    for a, b in zip(ours.levels, theirs.levels):
        assert a.level == b.level
        assert [as_dict(s) for s in a.states] == [as_dict(s) for s in b.states]
        assert [s.longs_with_deferred for s in a.states] == \
            [s.longs_with_deferred for s in b.states]
        assert a.phase1_cost == b.phase1_cost
        assert a.comm_longs == b.comm_longs
        assert sorted(a.phase1_seconds) == sorted(b.phase1_seconds)
        assert a.cumulative == b.cumulative
        assert a.average == b.average
    assert sorted(ours.timings) == sorted(theirs.timings)


def both_host(jg, P, dedup, defer, part=None, **opts):
    theirs = j_solve(jg, part, backend="host", n_parts=P,
                     remote_dedup=dedup, deferred_transfer=defer, **opts)
    ours = solve(port_graph(jg), part, backend="host", n_parts=P,
                 remote_dedup=dedup, deferred_transfer=defer, **opts)
    return ours, theirs


# ---------------------------------------------------------------------------
# byte identity with the reference's host backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dedup,defer", HEURISTICS)
@pytest.mark.parametrize("P", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("scale", [5, 6, 7, 8, 9])
def test_host_solve_matches_reference(scale, P, dedup, defer):
    """The built-in partitioner at its default seed on both sides."""
    jg = j_eulerian_rmat(scale, avg_degree=4, seed=scale)
    ours, theirs = both_host(jg, P, dedup, defer)
    assert_same_host_result(ours, theirs)
    ours.validate()


@pytest.mark.parametrize("dedup,defer", HEURISTICS)
@pytest.mark.parametrize("P", [1, 2])
@pytest.mark.parametrize("name", sorted(PIVOTS))
def test_host_solve_matches_reference_on_pivot_graphs(name, P, dedup, defer):
    from repro.core.graph import Graph as JGraph

    n, cycles = PIVOTS[name]
    jg = JGraph(n, *cycles_edges(cycles))
    ours, theirs = both_host(jg, P, dedup, defer)
    assert_same_host_result(ours, theirs)
    assert ours.validate().valid


@pytest.mark.parametrize("dedup,defer", HEURISTICS)
@pytest.mark.parametrize("P,seed", [(3, 1), (4, 2)])
def test_host_solve_matches_reference_given_a_partition(P, seed, dedup,
                                                        defer):
    """An explicit ``part_of_vertex`` and a non-default
    ``partition_seed``, as the reference's heuristics tests pass them."""
    jg = j_eulerian_rmat(8, avg_degree=5, seed=3)
    part = partition_vertices(port_graph(jg), P, seed=seed)
    assert_same_host_result(*both_host(jg, P, dedup, defer, part=part))
    assert_same_host_result(*both_host(jg, P, dedup, defer,
                                       partition_seed=seed))


# ---------------------------------------------------------------------------
# splice_components_np against the reference's
# (tests/test_phase3_splice.py's cases)
# ---------------------------------------------------------------------------

def cycles_with_mate(n_vertices, cycles):
    """A multigraph of vertex cycles and a mate array pairing each cycle
    on its own (one component a cycle), as test_phase3_splice builds."""
    g = graph_of_cycles(n_vertices, cycles)
    mate = np.full(2 * g.num_edges, -1, dtype=np.int64)
    first = 0
    for cyc in cycles:
        k = len(cyc)
        for i in range(k):
            a, b = 2 * (first + i) + 1, 2 * (first + (i + 1) % k)
            mate[a], mate[b] = b, a
        first += k
    return g, mate


def per_vertex_pairing(seed):
    """An arbitrary per-vertex stub pairing of an Eulerian RMAT graph:
    many components crossing at many pivots."""
    g = eulerian_rmat(7, avg_degree=4, seed=seed)
    sv = stub_vertices(g)
    order = np.argsort(sv, kind="stable")
    vs = sv[order]
    idx = np.arange(len(sv))
    start = np.maximum.accumulate(
        np.where(np.r_[True, vs[1:] != vs[:-1]], idx, 0))
    first = (idx - start) % 2 == 0
    mate = np.full(len(sv), -1, dtype=np.int64)
    mate[order[first]] = order[~first]
    mate[order[~first]] = order[first]
    return g, mate


def stub_vertices(g):
    sv = np.empty(2 * g.num_edges, dtype=np.int64)
    sv[0::2] = g.edge_u
    sv[1::2] = g.edge_v
    return sv


SPLICE_CASES = {
    "three_triangles_one_pivot": lambda: cycles_with_mate(
        7, [[0, 1, 2], [0, 3, 4], [0, 5, 6]]),
    "five_cycles_one_pivot": lambda: cycles_with_mate(*PIVOTS["flower5"]),
    "cycle_chain_distinct_pivots": lambda: cycles_with_mate(
        *PIVOTS["chain5"]),
    "cycles_sharing_multiple_pivots": lambda: cycles_with_mate(
        8, [[0, 2, 1, 3], [0, 4, 1, 5], [0, 6, 1, 7]]),
    **{f"random_per_vertex_pairing_{s}": (lambda s=s: per_vertex_pairing(s))
       for s in range(3)},
}


@pytest.mark.parametrize("case", sorted(SPLICE_CASES))
def test_splice_components_np_matches_reference(case):
    g, mate = SPLICE_CASES[case]()
    sv = stub_vertices(g)
    ours = splice_components_np(mate.copy(), sv, mate >= 0)
    theirs = j_splice(mate.copy(), sv, mate >= 0)
    assert ours.dtype == theirs.dtype
    assert ours.tobytes() == theirs.tobytes()
    assert (ours[ours] == np.arange(len(ours))).all()   # still a matching
    circuit = circuit_from_mate_np(ours)
    validate_circuit(g, circuit)
    assert sorted(circuit >> 1) == sorted(hierholzer_circuit(g) >> 1)


# ---------------------------------------------------------------------------
# ports of the reference's host-engine tests
# ---------------------------------------------------------------------------

def small_graph(seed=0, scale=7, deg=4):
    return eulerian_rmat(scale, avg_degree=deg, seed=seed)


@pytest.mark.parametrize("nparts", [2, 3, 4, 8])
def test_host_engine_valid_circuit(nparts):
    """tests/test_core_euler.py::test_host_engine_valid_circuit."""
    g = small_graph(seed=nparts, scale=8, deg=5)
    res = solve(g, backend="host", n_parts=nparts, partition_seed=1,
                remote_dedup=False, deferred_transfer=False).validate()
    assert res.supersteps == res.tree.height + 1


@pytest.mark.parametrize("dedup,defer", [(True, False), (True, True),
                                         (False, True)])
def test_host_engine_heuristics(dedup, defer):
    """tests/test_core_euler.py::test_host_engine_heuristics: §5's
    heuristics never raise the level-0 state; same edge multiset."""
    g = small_graph(seed=3, scale=8, deg=5)
    part = partition_vertices(g, 4, seed=2)
    base = solve(g, part_of_vertex=part, backend="host", n_parts=4,
                 remote_dedup=False, deferred_transfer=False).validate()
    opt = solve(g, part_of_vertex=part, backend="host", n_parts=4,
                remote_dedup=dedup, deferred_transfer=defer).validate()
    assert opt.levels[0].cumulative <= base.levels[0].cumulative
    assert sorted(base.circuit >> 1) == sorted(opt.circuit >> 1)


def test_host_solve_returns_unified_result():
    """tests/test_euler_api.py::test_host_solve_returns_unified_result."""
    g = eulerian_rmat(7, avg_degree=4, seed=0)
    res = solve(g, backend="host", n_parts=4)
    assert isinstance(res, EulerResult)
    assert res.backend == "host" and res.graph is g
    assert res.valid is None
    assert res.validate() is res and res.valid is True
    assert all(isinstance(ls, LevelStats) for ls in res.levels)
    assert res.supersteps == res.tree.height + 1
    assert "total_s" in res.timings and "run_s" in res.timings
    assert res.cache == CacheStats() and res.padded_edges == 0


def test_validate_rejects_bad_circuit():
    """tests/test_euler_api.py::test_validate_rejects_bad_circuit."""
    g = eulerian_rmat(7, avg_degree=4, seed=1)
    res = solve(g, backend="host", n_parts=2)
    res.circuit = res.circuit[::-1].copy()  # break the walk order
    with pytest.raises(AssertionError):
        res.validate()
    assert res.valid is False


def test_deprecation_shims_still_warn_and_work():
    """tests/test_euler_api.py::test_old_result_import_path and
    ::test_host_engine_run_deprecated_shim, tests/test_batched.py::
    test_pr2_deprecation_shims_still_warn_and_work."""
    from repro_torch.core import host_engine
    from repro_torch.core.host_engine import EulerResult as OldResult
    from repro_torch.core.host_engine import HostEngine

    assert OldResult is EulerResult
    assert host_engine.EulerResult is EulerResult   # module __getattr__
    with pytest.raises(AttributeError):
        host_engine.NoSuchName
    g = eulerian_rmat(7, avg_degree=4, seed=3)
    pg = partition_graph(g, partition_vertices(g, 2, seed=0))
    with pytest.warns(DeprecationWarning):
        res = HostEngine(pg).run(validate=True)
    assert isinstance(res, EulerResult) and res.valid
    g = eulerian_rmat(6, avg_degree=4, seed=7)
    pg = partition_graph(g, np.zeros(g.num_vertices, dtype=np.int64))
    with pytest.warns(DeprecationWarning):
        res = HostEngine(pg).run(validate=True)
    assert isinstance(res, EulerResult) and res.valid


@pytest.mark.parametrize("fused", [False, True])
def test_backend_parity(fused):
    """tests/test_euler_api.py::test_backend_parity_property, host
    against the port's device backend on the CPU, eager and fused: each
    validates and covers every edge once, on the pivot graphs at P = 2 and
    on eulerian_rmat(7, seed ∈ {0, 1}) at P = 8."""
    cases = [(graph_of_cycles(*PIVOTS[name]), 2) for name in sorted(PIVOTS)]
    cases += [(eulerian_rmat(7, avg_degree=4, seed=s), 8) for s in (0, 1)]
    solvers = {}
    for g, nparts in cases:
        if nparts not in solvers:
            solvers[nparts] = (
                EulerSolver(n_parts=nparts, device="cpu", fused=fused),
                EulerSolver(n_parts=nparts, backend="host"))
        dev, host = solvers[nparts]
        r_d = dev.solve(g).validate()
        r_h = host.solve(g).validate()
        assert r_d.backend == "device" and r_h.backend == "host"
        assert r_d.fused is fused and r_h.fused is False
        assert sorted(r_d.circuit >> 1) == sorted(r_h.circuit >> 1) \
            == list(range(g.num_edges))
        assert r_d.supersteps >= r_h.supersteps


@st.composite
def random_graphs(draw):
    n = draw(st.integers(8, 48))
    m = draw(st.integers(n, 4 * n))
    rng = np.random.default_rng(draw(st.integers(0, 2**31 - 1)))
    u = rng.integers(0, n, m)
    v = rng.integers(0, n, m)
    keep = u != v
    return Graph(n, u[keep].astype(np.int64), v[keep].astype(np.int64))


@given(random_graphs(), st.integers(2, 5))
@settings(max_examples=15, deadline=None)
def test_host_engine_always_valid(g, nparts):
    """tests/test_property.py::test_host_engine_always_valid."""
    g = eulerize(largest_component(g), seed=0)
    if g.num_edges < 4:
        return
    nparts = min(nparts, max(2, g.num_vertices // 4))
    res = solve(g, backend="host", n_parts=nparts,
                remote_dedup=False, deferred_transfer=False).validate()
    assert sorted(np.asarray(res.circuit) >> 1) == list(range(g.num_edges))


@given(st.integers(1, 6), st.integers(0, 100))
@settings(max_examples=20, deadline=None)
def test_memory_accounting_monotone_parts(levels, seed):
    """tests/test_property.py::test_memory_accounting_monotone_parts."""
    g = eulerize(largest_component(
        Graph(24, *(np.random.default_rng(seed).integers(0, 24, (2, 80))))
    ), seed=0)
    if g.num_edges < 8:
        return
    res = solve(g, backend="host", n_parts=3,
                remote_dedup=False, deferred_transfer=False).validate()
    for ls in res.levels:
        assert ls.cumulative >= 0
        for s in ls.states:
            assert min(s.remote_copies, s.boundary, s.open_stubs,
                       s.touch, s.components) >= 0


# ---------------------------------------------------------------------------
# the host solver's rules
# ---------------------------------------------------------------------------

def test_host_backend_rejects_device_paths():
    """The first assertion of tests/test_batched.py::
    test_solve_batch_rejects_host_backend_and_eager, and the other
    device-only paths and options."""
    g = eulerian_rmat(5, avg_degree=4, seed=0)
    host = EulerSolver(n_parts=1, backend="host")
    with pytest.raises(ValueError, match="device"):
        host.solve_batch([g, g])
    with pytest.raises(ValueError, match="device"):
        host.solve_batch_async([g, g])
    with pytest.raises(ValueError, match="device"):
        host.solve_async(g)
    for fused in (True, False):
        with pytest.raises(ValueError, match="fused"):
            host.solve(g, fused=fused)
    assert host.solve_batch([]) == []
    with pytest.raises(ValueError, match="backend"):
        EulerSolver(n_parts=1, backend="tpu")
    with pytest.raises(ValueError, match="no device"):
        EulerSolver(n_parts=1, backend="host", device="cpu")


def test_host_backend_defaults_and_deferred_transfer():
    """``n_parts=None`` is 4 on the host backend and 1 on the device one,
    as in the reference (whose device default is its device count);
    ``deferred_transfer=False`` runs on the host backend and still raises
    on the device one."""
    assert EulerSolver(backend="host").n_parts == 4
    assert EulerSolver(device="cpu").n_parts == 1
    g = eulerian_rmat(6, avg_degree=4, seed=2)
    ours = EulerSolver(backend="host", deferred_transfer=False).solve(g)
    theirs = j_solve(j_eulerian_rmat(6, avg_degree=4, seed=2),
                     backend="host", n_parts=4, deferred_transfer=False)
    assert_same_host_result(ours.validate(), theirs)
    assert len(ours.levels[0].states) == 4
    with pytest.raises(ValueError, match="queue 3"):
        EulerSolver(n_parts=2, device="cpu", deferred_transfer=False)


def test_host_solve_many_ignores_batch():
    graphs = [eulerian_rmat(6, avg_degree=4, seed=s) for s in range(4)]
    solver = EulerSolver(n_parts=2, backend="host")
    batched = solver.solve_many(graphs, batch=2)
    one_by_one = [solver.solve(g) for g in graphs]
    for a, b in zip(batched, one_by_one):
        assert_same_host_result(a.validate(), b)
    assert solver.cache_stats == CacheStats()       # no programs at all


def test_host_backend_touches_no_device():
    """A host session never resolves a device nor initializes CUDA: it
    runs with every CUDA entry the solver could reach made to raise."""
    def boom(*args, **kwargs):
        raise AssertionError("the host backend reached for a device")
    with mock.patch.object(torch.cuda, "is_available", boom), \
            mock.patch.object(torch.cuda, "_lazy_init", boom), \
            mock.patch.object(torch.cuda, "synchronize", boom), \
            mock.patch.object(solver_mod, "resolve_device", boom):
        solver = EulerSolver(n_parts=4, backend="host")
        res = solver.solve(eulerian_rmat(7, avg_degree=4, seed=0))
        many = solver.solve_many([res.graph], batch=4)
    assert solver.device is None and res.device == "cpu"
    assert res.validate().valid and many[0].validate().valid
    assert solver._engines == {} and not solver._programs


# ---------------------------------------------------------------------------
# the port's examples
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("script,args", [
    ("torch_quickstart.py", []),
    ("torch_euler_distributed.py", ["--device", "cpu", "--scale", "7"])])
def test_example_runs(script, args):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", script), *args],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "valid=True" in r.stdout
    if script == "torch_quickstart.py":
        assert "4 BSP supersteps" in r.stdout
        assert r.stdout.count("  level ") == 4
    else:
        assert "cache hit=True" in r.stdout
        assert "byte-identical=True" in r.stdout
