"""The port's program audit (``repro_torch.analysis``) against the JAX
package's ``repro.analysis.jaxpr_audit``.

The pure functions (the published collective schedule, the state and
program byte model, the kernel cost model's shared fields) equal the
reference's on a grid of real bucket keys: scales 5–9, P ∈ {1, 2, 4, 8},
B ∈ {None, 2, 4}, sharded and replicated, ``gather_circuit`` both ways.
The audit itself records the reference's golden cases
(``tests/test_analysis.py``'s scale-5, P = 2 buckets) on the CPU and
must pass them, and fail a tampered budget and planted faults.  The
reference's live ``audit_graph`` walks jaxprs through
``jax.core.ClosedJaxpr``, which jax 0.9.0 lacks, so the
report's layout and its ``cache_budget`` are held to the reference's
dataclass and pure functions instead.  On a card (``gpu`` tests) the
recorded graph's node census is checked too, and a device→host copy
recorded into the body must fail it."""
import dataclasses
import functools
import json

import pytest
import torch

import repro_torch.core.engine as engine_mod
import repro_torch.core.phase3 as phase3_mod
from repro_torch.analysis import (ENGINE_STATE_LANES, audit_graph,
                                  engine_state_bytes,
                                  expected_kernel_launches,
                                  kernel_cost_model, program_cost_bytes)
from repro_torch.analysis import audit as audit_cli
from repro_torch.analysis.graph_audit import (LOOP_TEST, ProgramAudit,
                                              graph_kernel_nodes,
                                              graph_violations)
from repro_torch.core import capture
from repro_torch.euler import EulerSolver
from repro_torch.graphgen.eulerize import eulerian_rmat

SCALES = (5, 6, 7, 8, 9)
PARTS = (1, 2, 4, 8)
WIDTHS = (None, 2, 4)


@pytest.fixture(scope="module")
def ref():
    from repro.analysis import jaxpr_audit
    from repro.core import engine

    return jaxpr_audit, engine


@functools.lru_cache(maxsize=None)
def bucket_key(scale: int, parts: int):
    g = eulerian_rmat(scale, avg_degree=5, seed=0)
    return EulerSolver(n_parts=parts, device="cpu").bucket_of(g)


def test_published_schedule_layout_is_the_reference(ref):
    _, engine = ref
    assert engine_mod._SHIP_GROUPS == engine._SHIP_GROUPS
    assert sum(engine_mod._SHIP_GROUPS.values()) == 24
    assert ENGINE_STATE_LANES == ref[0].ENGINE_STATE_LANES


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("batch", WIDTHS)
@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("scale", SCALES)
def test_pure_functions_equal_the_reference(ref, scale, parts, batch,
                                            sharded):
    jaxpr_audit, engine = ref
    key = bucket_key(scale, parts)
    e_cap, n, n_levels, caps = key
    assert engine_mod.fused_collective_budget(n_levels) == \
        engine.fused_collective_budget(n_levels)
    for gather in (True, False):
        kw = dict(num_edges=e_cap, n_parts=n, sharded_phase3=sharded,
                  gather_circuit=gather)
        assert engine_mod.fused_collective_budget(n_levels, **kw) == \
            engine.fused_collective_budget(n_levels, **kw)
    assert engine_state_bytes(caps) == jaxpr_audit.engine_state_bytes(caps)
    ours = program_cost_bytes(key, batch, sharded=sharded)
    assert ours == jaxpr_audit.program_cost_bytes(key, batch,
                                                  sharded=sharded) > 0
    p3v = caps.p3v_cap or e_cap
    mine = kernel_cost_model(e_cap, batch, n_parts=n, sharded=sharded,
                             p3v_cap=p3v)
    theirs = jaxpr_audit.pallas_cost_model(e_cap, batch, n_parts=n,
                                           sharded=sharded, p3v_cap=p3v)
    for field in ("n_stubs", "padded", "block", "sharded", "n_parts",
                  "phase3_table_width", "phase3_state_bytes"):
        assert mine[field] == theirs[field], field
    for name in ("cc", "rank"):
        for field in ("n_tables", "rounds", "gather_flops"):
            assert mine["loops"][name][field] == \
                theirs["loops"][name][field], (name, field)
    # one launch a round replicated, one a ring step (n a round) sharded;
    # the reference (interpret mode off the TPU) takes every kernel path
    assert all(lp["uses_kernel"] for lp in theirs["loops"].values())
    per_round = n if sharded else 1
    assert expected_kernel_launches(e_cap, batch, n_parts=n,
                                    sharded=sharded) == \
        theirs["expected_pallas_calls"] * per_round == \
        mine["expected_kernel_launches"]


# ----------------------------------------------------------------------
# the audit on the CPU: the reference's golden cases
# ----------------------------------------------------------------------
GRAPH = functools.partial(eulerian_rmat, 5, avg_degree=3, seed=0)
CASES = {
    "replicated": (dict(sharded_phase3=False), (1, 4)),
    "sharded": ({}, (1, 4)),
    "no_gather": (dict(gather_circuit=False), (1,)),
}


def solver_for(case: str, **extra) -> EulerSolver:
    opts, widths = CASES[case]
    return EulerSolver(n_parts=2, width_ladder=widths, device="cpu",
                       **opts, **extra)


@pytest.fixture(scope="module")
def reports():
    torch.set_num_threads(1)
    return {case: audit_graph(solver_for(case), GRAPH())
            for case in CASES}


@pytest.mark.parametrize("case", list(CASES))
def test_audit_golden_scale5(reports, case):
    report = reports[case]
    assert report["ok"], report
    sharded = case != "replicated"
    widths = CASES[case][1]
    assert [p["batch"] for p in report["programs"]] == \
        [None if w == 1 else w for w in widths]
    n_levels = report["bucket"]["n_levels"]
    assert report["bucket"]["sharded_phase3"] is sharded
    assert report["bucket"]["gather_circuit"] is (case != "no_gather")
    for prog in report["programs"]:
        assert prog["violations"] == []
        cen, budget = prog["census"], prog["budget"]
        assert cen["all_to_all"] == budget["dynamic_all_to_all"] == \
            24 * n_levels
        assert cen["pallas_call"] == \
            prog["cost"]["expected_kernel_launches"]
        assert cen["while"] == n_levels + 1
        length, body = prog["scans"][0]
        assert length == n_levels and body["all_to_all"] == 24
        assert prog["resident_intact"] is True
        assert prog["graph_census"] is None          # nothing recorded
        if sharded:
            sched = budget["phase3"]
            rounds = sched["doubling_rounds"]
            assert cen["ppermute"] == 2 * rounds + 7 == sched["ppermute"]
            assert cen["psum"] == 2
            assert cen.get("all_gather", 0) == sched["all_gather"] == \
                (1 if case == "sharded" else 0)
            assert cen["ring_step"] == sched["ppermute"] * (2 - 1) + 3
            assert cen["kernel:pointer_double_shard"] == rounds * 2
            assert len(prog["scans"]) == 1 + sched["ppermute"]
        else:
            assert cen["all_gather"] == 1
            assert cen.get("psum", 0) == cen.get("ppermute", 0) == 0
            assert cen["kernel:pointer_double"] == \
                cen["kernel:pointer_double_rank"] == \
                prog["cost"]["loops"]["cc"]["rounds"]


@pytest.mark.parametrize("case", list(CASES))
def test_report_layout_and_cache_budget_are_the_reference(ref, reports,
                                                          case):
    jaxpr_audit, _ = ref
    report = reports[case]
    assert set(report) == {"torch", "device", "device_name", "bucket",
                           "programs", "cache_budget", "ok", "metrics"}
    assert (report["device"], report["device_name"]) == ("cpu", "cpu")
    assert set(report["bucket"]) == {"e_cap", "n_parts", "n_levels", "caps",
                                     "tree_height", "sharded_phase3",
                                     "gather_circuit"}
    theirs = {f.name for f in dataclasses.fields(jaxpr_audit.ProgramAudit)}
    ours = {f.name for f in dataclasses.fields(ProgramAudit)}
    assert ours == theirs - {"donated_marker", "resident_marker"} | {
        "graph_census", "resident_intact"}
    key = EulerSolver(n_parts=2, device="cpu").bucket_of(GRAPH())
    sharded = report["bucket"]["sharded_phase3"]
    widths = CASES[case][1]
    budget = report["cache_budget"]
    assert budget["per_program_bytes"] == {
        f"B{w}": jaxpr_audit.program_cost_bytes(
            key, None if w == 1 else w, sharded=sharded) for w in widths}
    assert all(v > 0 for v in budget["per_program_bytes"].values())
    assert budget["total_bytes"] == sum(budget["per_program_bytes"].values())
    assert budget["budget_bytes"] is None and budget["within_budget"] is None
    for prog in report["programs"]:
        assert prog["cost"]["program_bytes"] == \
            budget["per_program_bytes"][f"B{prog['batch'] or 1}"]
    json.dumps(report, default=str)


def test_cache_budget_against_a_byte_budget():
    solver = solver_for("sharded", program_cache_bytes=1)
    report = audit_graph(solver, GRAPH(), widths=(1,))
    assert report["ok"]
    assert report["cache_budget"]["budget_bytes"] == 1
    assert report["cache_budget"]["within_budget"] is False
    assert solver.cache_stats.traces == 0          # the audit is apart


# ----------------------------------------------------------------------
# the gate is live: tampered budgets and planted faults fail it
# ----------------------------------------------------------------------
@pytest.mark.parametrize("case,prim", [("replicated", "all_to_all"),
                                       ("sharded", "all_to_all"),
                                       ("sharded", "ppermute")])
def test_tampered_budget_fails(monkeypatch, case, prim):
    real = engine_mod.fused_collective_budget

    def tampered(n_levels, **kw):
        b = dict(real(n_levels, **kw))
        b[prim] -= 1
        return b

    monkeypatch.setattr(engine_mod, "fused_collective_budget", tampered)
    bad = audit_graph(solver_for(case), GRAPH(), widths=(1,))
    assert not bad["ok"], "audit passed under a tampered budget"
    viol = bad["programs"][0]["violations"]
    assert any(prim in v for v in viol), viol


def test_extra_ring_step_fails(monkeypatch):
    """A ``_ring`` call outside the ring schedule (one more rotation
    after the rank) fails the sharded audit."""
    rank = phase3_mod._rank_sharded

    def one_more_ring(mate_sh, batch=1):
        dist, reach = rank(mate_sh, batch)
        phase3_mod._ring(dist, 0, batch)
        return dist, reach

    monkeypatch.setattr(phase3_mod, "_rank_sharded", one_more_ring)
    bad = audit_graph(solver_for("sharded"), GRAPH(), widths=(1,))
    assert not bad["ok"]
    viol = bad["programs"][0]["violations"]
    assert any("ring_step" in v for v in viol), viol
    assert any("outside a ring loop" in v for v in viol), viol


def test_gather_inside_a_level_fails(monkeypatch):
    """An ``all_gather`` inside the level loop fails the audit twice:
    one too many, and inside a loop."""
    superstep = engine_mod.Engine.superstep

    def gathering(self, lvl, anc, state):
        if lvl == 0:
            capture.note("all_gather")
        return superstep(self, lvl, anc, state)

    monkeypatch.setattr(engine_mod.Engine, "superstep", gathering)
    bad = audit_graph(solver_for("replicated"), GRAPH(), widths=(1,))
    viol = bad["programs"][0]["violations"]
    assert any(v.startswith("all_gather: recorded 2") for v in viol), viol
    assert any("all_gather inside a level loop" in v for v in viol), viol


def test_changed_inputs_fail(monkeypatch):
    """A body that writes the static inputs it reads (on a card its
    replay would follow a warm-up that changed them) fails the donation
    analogue."""
    whole = engine_mod.Engine.whole_run

    def writing(self, state, anc, sv, num_edges):
        out = whole(self, state, anc, sv, num_edges)
        state.pk_mask.zero_()
        return out

    monkeypatch.setattr(engine_mod.Engine, "whole_run", writing)
    bad = audit_graph(solver_for("replicated"), GRAPH(), widths=(1,))
    prog = bad["programs"][0]
    assert prog["resident_intact"] is False
    assert any("changed the static inputs" in v
               for v in prog["violations"]), prog["violations"]


# ----------------------------------------------------------------------
# the graph census's rules (the card's census itself: gpu tests below)
# ----------------------------------------------------------------------
def _graph(cost, whiles, **over):
    gcen = {"kernel": 100, "conditional": whiles, "while_body": whiles,
            "memcpy": 12, "memcpy_dtod": 12,
            f"kernel:_ZN12_GLOBAL__N_1{len(LOOP_TEST)}{LOOP_TEST}EPKhxPiiyi":
                2 * whiles,
            "kernel:void at::native::elementwise_kernel<128, 4>": 50}
    for lp in cost["loops"].values():
        sym = f"{lp['kernel']}_kernel"
        gcen[f"kernel:_ZN12_GLOBAL__N_1{len(sym)}{sym}EPKiS2_"] = \
            lp["launches"]
    gcen.update(over)
    return gcen


@pytest.mark.parametrize("fault,needle", [
    (None, None),
    ({"memcpy_dtoh": 1}, "memcpy_dtoh"),
    ({"host": 1}, "host"),
    ({"conditional": 4}, "conditional"),
    ({"while_body": 2}, "while_body"),
    ("one launch short", "pointer_double_shard kernel node"),
    ("no loop test", LOOP_TEST),
    ({"error:cuGraphKernelNodeGetParams:1": 3}, "census queries failed"),
    ({"kernel:?": 2}, "unnamed"),
])
def test_graph_census_rules(fault, needle):
    cost = kernel_cost_model(64, None, n_parts=2, sharded=True)
    whiles = 3
    gcen = _graph(cost, whiles, **(fault if isinstance(fault, dict) else {}))
    if fault == "one launch short":
        k = next(k for k in gcen if "pointer_double_shard_kernel" in k)
        gcen[k] -= 1
    elif fault == "no loop test":
        gcen = {k: v for k, v in gcen.items() if LOOP_TEST not in k}
    nodes = graph_kernel_nodes(gcen)
    if fault is None:
        assert nodes["pointer_double_shard"] == \
            cost["loops"]["cc"]["launches"]
        assert nodes["pointer_double"] == 0
        assert nodes[LOOP_TEST] == 2 * whiles
    viol = graph_violations(gcen, cost, whiles)
    if needle is None:
        assert viol == []
    else:
        assert viol and any(needle in v for v in viol), viol


# ----------------------------------------------------------------------
# the census seam
# ----------------------------------------------------------------------
def test_census_counts_a_splice_body_once():
    """Eagerly a splice loop runs its rounds, and only the first counts:
    the reference's ``while_loop`` body is traced once."""
    cen = capture.Census()

    def step(x, changed):
        capture.note("psum")
        nxt = x - 1
        return nxt, nxt > 0

    with capture.censusing(cen):
        x, _ = capture.converge(step, (torch.tensor(5),
                                       torch.tensor(True)), 64)
    assert int(x) == 0
    assert dict(cen.counts) == {"while": 1, "psum": 1}
    assert cen.inside["while"] == {"psum": 1}
    capture.note("psum")                 # no census open: nothing
    assert capture.open_census() is None and cen.counts["psum"] == 1


def test_warmed_widths_audit_on_a_session():
    """``widths="warmed"`` audits the widths with a live program, width 1
    when none is live yet."""
    solver = solver_for("sharded")
    g = GRAPH()
    assert [p["batch"] for p in audit_graph(solver, g, "warmed")[
        "programs"]] == [None]
    solver.prewarm(g, widths=(1, 2))
    rep = audit_graph(solver, g, widths="warmed")
    assert rep["ok"] and set(rep["cache_budget"]["per_program_bytes"]) == \
        {"B1", "B2"}
    with pytest.raises(ValueError):
        audit_graph(solver, g, widths="all")


# ----------------------------------------------------------------------
# the CLI
# ----------------------------------------------------------------------
@pytest.mark.parametrize("flags", [[], ["--replicated-phase3"],
                                   ["--no-gather-circuit", "--widths",
                                    "1"]])
def test_cli_passes_and_writes_the_report(tmp_path, capsys, flags):
    path = tmp_path / "AUDIT.json"
    rc = audit_cli.main(["--scale", "5", "--parts", "2", "--device", "cpu",
                         "--json", str(path), *flags])
    out = capsys.readouterr().out
    assert rc == 0, out
    report = json.loads(path.read_text())
    assert report["ok"]
    assert "repro_torch.analysis.audit: PASS" in out
    assert out.count("[ok] e_cap=") == len(report["programs"])


def test_cli_without_a_card_exits_2():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI records on it")
    assert audit_cli.main(["--scale", "5"]) == 2


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the graph census reads a recorded "
                    "CUDA graph")


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_audit_reads_the_graph_census(case):
    _need_card()
    opts, widths = CASES[case]
    solver = EulerSolver(n_parts=2, width_ladder=widths, **opts)
    report = audit_graph(solver, GRAPH())
    assert report["ok"], report
    for prog in report["programs"]:
        gcen = prog["graph_census"]
        nodes = graph_kernel_nodes(gcen)
        for lp in prog["cost"]["loops"].values():
            assert nodes[lp["kernel"]] == lp["launches"]
        assert gcen.get("host", 0) == gcen.get("memcpy_dtoh", 0) == 0
        assert prog["cost"]["reserved_bytes"] > 0


@pytest.mark.gpu
def test_cuda_copy_out_inside_the_graph_fails(monkeypatch):
    _need_card()
    whole = engine_mod.Engine.whole_run
    pinned = {}

    def copying(self, state, anc, sv, num_edges):
        out = whole(self, state, anc, sv, num_edges)
        host = pinned.get("mate")
        if host is None:      # the warm-up's eager run, not the recording
            host = pinned["mate"] = torch.empty(
                out.mate.shape, dtype=out.mate.dtype, pin_memory=True)
        host.copy_(out.mate, non_blocking=True)
        return out

    monkeypatch.setattr(engine_mod.Engine, "whole_run", copying)
    solver = EulerSolver(n_parts=2, width_ladder=(1,))
    bad = audit_graph(solver, GRAPH())
    viol = bad["programs"][0]["violations"]
    assert any("memcpy_dtoh" in v for v in viol), viol
