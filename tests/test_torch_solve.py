"""The whole slice: ``repro_torch.euler.solve(g, n_parts=P,
device="cpu")`` returns the same circuit and mate as
``repro.euler.solve(g, n_parts=P)``, byte for byte, for P ∈ {1, 2, 8} at
RMAT scales 5–7, and every result validates.

The port runs its default, the sharded Phase 3 for P>1; the references
run the replicated one (``sharded_phase3=False``), which the JAX
package's own tests/test_sharded_phase3.py holds byte-identical to its
sharded default, so each P>1 case also crosses the two paths.
tests/test_torch_phase3_sharded.py holds every Phase 3 mode of the port
against the reference's default.  The references' outputs are a golden
file, ``tests/golden/torch_solve_reference.npz``, written by the JAX
package (frozen, so it cannot drift) with ``PYTHONPATH=src python
tests/test_torch_solve.py`` (one subprocess with 8 simulated devices);
``test_golden_is_the_jax_output`` solves one case of it again live.  The
port runs here.

The port's fused run (``fused=True``, its default, as the reference's)
and its eager oracle (``fused=False``) are both held to the same bytes
in every Phase 3 mode, and so is the fused run under the capture rule,
where every splice loop is a CUDA while node (on the CPU the node's
stand-in), which must run the eager loops' rounds.  On a card (``gpu``
tests) the fused run records one graph per bucket and replays it, its
while nodes running each graph's own rounds."""
import contextlib
import dataclasses
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from conftest import run_with_devices
from repro_torch.core import capture
from repro_torch.core.graph import Graph
from repro_torch.euler import EulerSolver, solve
from repro_torch.graphgen.eulerize import eulerian_rmat

PARTS = [1, 2, 8]
SCALES = [5, 6, 7]
#: the time limit of the live JAX reference run in this file, about six
#: times the 20 s it took in the suite's parallel run on an 8-core CPU:
#: a stalled subprocess fails the tests that read it instead of holding
#: its worker for run_with_devices' default 900 s
LIVE_TIMEOUT = 120
#: the three Phase 3 modes, named so that P = 1 runs them all
MODES = {"sharded": {"sharded_phase3": True},
         "replicated": {"sharded_phase3": False},
         "no_gather": {"sharded_phase3": True, "gather_circuit": False}}
EAGER_KEYS = {"prepare_s", "upload_s", "supersteps_s", "phase3_s",
              "fetch_s", "total_s"}
FUSED_KEYS = {"prepare_s", "upload_s", "warmup_s", "capture_s", "run_s",
              "fetch_s", "total_s"}

GOLDEN = Path(__file__).resolve().parent / "golden" / \
    "torch_solve_reference.npz"

_REFERENCE = '''
import numpy as np
from repro.euler import solve
from repro.graphgen.eulerize import eulerian_rmat
rec = {{}}
for P in {parts}:
    for s in {scales}:
        r = solve(eulerian_rmat(s, avg_degree=4, seed=s), n_parts=P,
                  sharded_phase3=False)
        rec[f"{{P}}_{{s}}/circuit"], rec[f"{{P}}_{{s}}/mate"] = r.circuit, r.mate
np.savez_compressed({out!r}, **rec)
'''


def jax_reference(out, parts=PARTS, scales=SCALES, devices=8,
                  timeout=900) -> None:
    """The JAX package's circuits and mates for every (P, scale), into
    the ``.npz`` file ``out``."""
    run_with_devices(_REFERENCE.format(parts=list(parts),
                                       scales=list(scales), out=str(out)),
                     n=devices, timeout=timeout)


@pytest.fixture(scope="module")
def reference():
    with np.load(GOLDEN) as z:
        return dict(z)


def test_golden_is_the_jax_output(reference, tmp_path):
    """One case of the golden file solved again by the JAX package."""
    out = tmp_path / "live.npz"
    jax_reference(out, parts=[2], scales=[5], devices=2,
                  timeout=LIVE_TIMEOUT)
    with np.load(out) as z:
        assert set(z) == {"2_5/circuit", "2_5/mate"}
        for key in z:
            np.testing.assert_array_equal(z[key], reference[key])
    assert set(reference) == {f"{P}_{s}/{k}" for P in PARTS for s in SCALES
                              for k in ("circuit", "mate")}


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("P", PARTS)
def test_solve_byte_identical_to_jax(reference, P, scale):
    g = eulerian_rmat(scale, avg_degree=4, seed=scale)
    res = solve(g, n_parts=P, device="cpu").validate()
    np.testing.assert_array_equal(res.circuit, reference[f"{P}_{scale}/circuit"])
    np.testing.assert_array_equal(res.mate, reference[f"{P}_{scale}/mate"])
    assert res.circuit.dtype == np.int64 and res.mate.dtype == np.int64
    assert res.phase3_converged and res.device == "cpu"
    assert len(res.levels) == res.supersteps


def fused_run(solver, g):
    """The session's fused run of ``g``'s bucket (its engine's program)."""
    key = solver.bucket_of(g)
    return solver._engines[key].fused_program(key[0])


def eager_rounds(solver, g, **kw):
    """An eager solve and the rounds each of its splice loops ran."""
    loops = capture.Loops(solver.device)
    with capture.counting(loops):
        res = solver.solve(g, fused=False, **kw)
    return res, loops.rounds_run()


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("P", PARTS)
def test_fused_and_eager_byte_identical_to_jax(reference, P, scale):
    """Every Phase 3 mode, fused and eager, and the fused run under the
    capture rule (every splice loop a while node's stand-in, which runs
    the eager loops' rounds): all the reference's bytes."""
    g = eulerian_rmat(scale, avg_degree=4, seed=scale)
    want = (reference[f"{P}_{scale}/circuit"], reference[f"{P}_{scale}/mate"])
    for mode, opts in MODES.items():
        solver = EulerSolver(n_parts=P, device="cpu", **opts)
        runs = {"fused": solver.solve(g)}
        runs["eager"], rounds = eager_rounds(solver, g)
        assert fused_run(solver, g).rounds_run() == rounds
        with mock.patch.object(capture, "capturing", lambda device: True):
            runs["while_node"] = solver.solve(g)
        assert fused_run(solver, g).rounds_run() == rounds
        assert len(rounds) == runs["eager"].supersteps + 1
        for name, res in runs.items():
            res.validate()
            np.testing.assert_array_equal(res.circuit, want[0],
                                          err_msg=f"{mode} {name}")
            np.testing.assert_array_equal(res.mate, want[1],
                                          err_msg=f"{mode} {name}")
            assert res.fused == (name != "eager")
            assert res.backend == "device"
        assert solver.captures == 0               # the CPU records nothing


def test_bowtie_and_timings():
    """Two triangles through one pivot vertex on one partition: the
    Phase 3 splice joins them; every phase reports its wall time, eager
    phase by phase, fused as the run's marks."""
    bowtie = Graph(5, np.array([0, 1, 2, 0, 3, 4]),
                   np.array([1, 2, 0, 3, 4, 0]))
    res = solve(bowtie, n_parts=1, device="cpu", fused=False).validate()
    assert sorted((res.circuit >> 1).tolist()) == list(range(6))
    assert res.padded_edges == 64 - 6
    levels = {f"superstep_{lvl}_s" for lvl in range(res.supersteps)}
    assert set(res.timings) == EAGER_KEYS | {"splice_s", "emit_s"} | levels
    t = res.timings
    assert min(t.values()) >= 0
    assert sum(t[k] for k in levels) <= t["supersteps_s"]
    assert t["splice_s"] + t["emit_s"] == pytest.approx(t["phase3_s"])
    fused = solve(bowtie, n_parts=1, device="cpu").validate()
    assert fused.fused and not res.fused
    np.testing.assert_array_equal(fused.circuit, res.circuit)
    t = fused.timings
    assert set(t) == FUSED_KEYS and min(t.values()) >= 0
    assert t["capture_s"] == t["warmup_s"] == 0.0
    assert t["fetch_s"] <= t["run_s"] <= t["total_s"]


def test_solver_keeps_one_fused_run_per_bucket():
    """Same-bucket solves reuse one fused run; under
    ``program_cache_max=1`` another bucket replaces it (freed), under the
    default both stay; a run refuses another bucket's tables."""
    a = eulerian_rmat(6, avg_degree=4, seed=1)
    b = eulerian_rmat(6, avg_degree=4, seed=2)
    c = eulerian_rmat(8, avg_degree=4, seed=3)
    for cap in (1, 32):
        solver = EulerSolver(n_parts=2, device="cpu", program_cache_max=cap)
        assert solver.bucket_of(b) == solver.bucket_of(a)   # one bucket
        solver.solve(a)
        run = fused_run(solver, a)
        solver.solve(b).validate()
        assert fused_run(solver, b) is run
        solver.solve(c).validate()
        assert solver.bucket_of(c) != solver.bucket_of(a)
        live = {k for k, _ in solver._programs}
        if cap == 1:
            assert live == {solver.bucket_of(c)} and run.inputs is None
        else:
            assert live == {solver.bucket_of(a), solver.bucket_of(c)}
            assert fused_run(solver, a) is run and run.inputs is not None
    run = fused_run(solver, c)
    state, anc, _ = run.inputs
    with pytest.raises(ValueError, match="not the same bucket"):
        run.launch(state, anc, torch.zeros(8, dtype=torch.int32))


class _Undersized(EulerSolver):
    """Shrinks the touch table below what the graph needs."""

    def _prepare(self, graph, part_of_vertex):
        pg, tree, key = super()._prepare(graph, part_of_vertex)
        caps = dataclasses.replace(key[3], touch_cap=2, touch_ship_cap=2)
        return pg, tree, key[:3] + (caps,)


def test_undersized_caps_raise_instead_of_a_wrong_circuit():
    g = eulerian_rmat(6, avg_degree=4, seed=6)
    with pytest.raises(RuntimeError, match="flags failed"):
        _Undersized(n_parts=8, device="cpu").solve(g)


class _FewRounds(EulerSolver):
    """Gives every splice loop one round, fewer than the graph needs,
    and returns the fetched outputs instead of raising on their flags."""

    def _prepare(self, graph, part_of_vertex):
        pg, tree, key = super()._prepare(graph, part_of_vertex)
        caps = dataclasses.replace(key[3], splice_rounds=1, phase3_rounds=1)
        return pg, tree, key[:3] + (caps,)

    def _result(self, graph, tree, key, out, timings, fused, t0, hit):
        return out


def _few_rounds_agree(device: str, rule) -> None:
    """Fused and eager report the same unconverged splice flags, Phase 3
    flag and bytes, and every loop ran its one round in both."""
    g = eulerian_rmat(6, avg_degree=4, seed=6)
    solver = _FewRounds(n_parts=2, device=device)
    eager, rounds = eager_rounds(solver, g)
    with rule:
        fused = solver.solve(g)
    assert not eager.flags[:, :, 1].all() and not eager.phase3_ok
    for name, got, want in zip(eager._fields, fused, eager):
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert rounds == fused_run(solver, g).rounds_run() == [1] * len(rounds)


def test_too_few_rounds_report_the_same_flags_fused_and_eager():
    _few_rounds_agree("cpu", mock.patch.object(capture, "capturing",
                                               lambda device: True))


def test_partition_count_checks():
    tiny = Graph(3, np.array([0, 1, 2]), np.array([1, 2, 0]))
    with pytest.raises(ValueError, match="fewer than"):
        solve(tiny, n_parts=4, device="cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("P", PARTS)
def test_cuda_solve_matches_cpu(P):
    """On a card: the CUDA path (kernels included) returns the CPU path's
    circuit and mate byte for byte."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA path runs only on the card")
    g = eulerian_rmat(9, avg_degree=5, seed=P)
    on_card = solve(g, n_parts=P).validate()
    on_cpu = solve(g, n_parts=P, device="cpu")
    np.testing.assert_array_equal(on_card.circuit, on_cpu.circuit)
    np.testing.assert_array_equal(on_card.mate, on_cpu.mate)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(MODES))
def test_cuda_fused_captures_once_and_replays(mode):
    """On a card: the first fused solve of a bucket records one graph, a
    same-bucket solve replays it (``capture_s`` 0.0, no kernel launched
    from Python), and both equal the eager solves byte for byte, each
    replay's while nodes running that graph's eager rounds (two loop
    tests recorded a loop, none on a replay); a solve of another bucket
    records anew."""
    from repro_torch.kernels import graph_loop
    from repro_torch.kernels import pointer_double as pd

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: CUDA graphs record only on the card")
    solver = EulerSolver(n_parts=8, **MODES[mode])
    graphs = [eulerian_rmat(9, avg_degree=5, seed=s) for s in (1, 2)]
    assert solver.bucket_of(graphs[0]) == solver.bucket_of(graphs[1])
    wrappers = (pd.pointer_double, pd.pointer_double_rank,
                pd.pointer_double_shard, pd.pointer_double_rank_shard,
                graph_loop.while_loop)
    for i, g in enumerate(graphs):
        before = [w.launches for w in wrappers]
        fused = solver.solve(g).validate()
        launched = [w.launches - b for w, b in zip(wrappers, before)]
        assert (graph_loop.while_loop.launches - before[-1]
                == (2 * len(fused_run(solver, g).rounds_run()) if i == 0
                    else 0))
        eager, rounds = eager_rounds(solver, g)
        eager.validate()
        assert fused_run(solver, g).rounds_run() == rounds
        np.testing.assert_array_equal(fused.circuit, eager.circuit)
        np.testing.assert_array_equal(fused.mate, eager.mate)
        assert solver.captures == 1
        assert (fused.timings["capture_s"] > 0) == (i == 0)
        assert (sum(launched) > 0) == (i == 0)    # a replay launches nothing
    solver.solve(eulerian_rmat(10, avg_degree=5, seed=1)).validate()
    assert solver.captures == 2


@pytest.mark.gpu
def test_cuda_host_read_inside_the_recording_raises():
    """On a card: a splice loop that reads its flag on the host while the
    graph records makes the solve raise; nothing carries on eagerly."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: CUDA graphs record only on the card")
    solver = EulerSolver(n_parts=2)
    g = eulerian_rmat(8, avg_degree=5, seed=0)
    with mock.patch.object(capture, "capturing", lambda device: False):
        with pytest.raises(RuntimeError):
            solver.solve(g)
    assert solver.captures == 0
    torch.cuda.empty_cache()              # the failed capture left nothing
    assert EulerSolver(n_parts=2).solve(g).validate().fused


@pytest.mark.gpu
def test_cuda_too_few_rounds_report_the_same_flags_fused_and_eager():
    """On a card: with one splice round a loop, the recorded while nodes
    leave the eager flags and bytes."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: CUDA graphs record only on the card")
    _few_rounds_agree("cuda", contextlib.nullcontext())


if __name__ == "__main__":
    jax_reference(GOLDEN)
