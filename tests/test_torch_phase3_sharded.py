"""The sharded Phase 3 of the port against the JAX reference, byte for
byte (integers, zero tolerance):

  * K3/K4 (``pointer_double_shard``/``pointer_double_rank_shard``): the
    plain twins and the CPU wrappers against ``repro.kernels.ref`` and the
    Pallas kernels in interpret mode; the wrappers' checks;
  * ``phase3_sharded`` against the JAX ``phase3_sharded`` under
    ``shard_map`` on the random cycle covers of
    tests/test_sharded_phase3.py, P ∈ {1, 2, 4, 8}, both gather modes;
  * whole solves: ``repro_torch.euler.solve(..., device="cpu")`` in the
    default (sharded), replicated and no-gather modes against
    ``repro.euler.solve(g, n_parts=P)`` at its default, P ∈ {2, 8}; and,
    port side, the solver matrix (P ∈ {2, 4}) and seeded single-partition
    fuzz of tests/test_sharded_phase3.py.

The JAX references of the last two run once, in one subprocess with 8
simulated devices.  There the four covers of each P share one stub-space
width (the widest cover's, padded with unmated stubs), so each P
compiles one program."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import run_with_devices
from repro.core import phase3 as jp3
from repro.kernels import ref as jref
from repro.kernels.pointer_double import (
    pointer_double_rank_shard as j_rank_shard,
    pointer_double_shard as j_shard)
from repro_torch.core import phase3 as tp3
from repro_torch.core.engine import stub_shards
from repro_torch.core.graph import Graph
from repro_torch.euler import EulerSolver, solve
from repro_torch.graphgen.eulerize import eulerian_rmat
from repro_torch.kernels import pointer_double as pd
from repro_torch.kernels import ref

TRIALS = range(4)
PARTS = [1, 2, 4, 8]
SOLVE_PARTS = [2, 8]
SOLVE_SCALES = [5, 6]
#: the time limit of the live JAX reference run in this file, about four
#: times the 91 s it took in the suite's parallel run on an 8-core CPU:
#: a stalled subprocess fails the tests that read it instead of holding
#: its worker for run_with_devices' default 900 s
LIVE_TIMEOUT = 360

# tests/test_sharded_phase3.py::test_phase3_sharded_function_parity's
# generator and draws (seed 0, four trials)
_COVERS = '''
import numpy as np
rng = np.random.default_rng(0)

def random_cycle_cover(n_vertices, n_trails, trail_len):
    edges, cycles, used = [], [], [0]
    for _ in range(n_trails):
        start = int(rng.choice(used))
        L = int(rng.integers(2, trail_len + 1))
        mids = rng.integers(0, n_vertices, size=L - 1).tolist()
        walk = [start] + mids + [start]
        ids = []
        for a, b in zip(walk[:-1], walk[1:]):
            ids.append(len(edges)); edges.append((a, b))
        cycles.append(ids); used.extend(mids)
    E = len(edges)
    mate = np.full(2 * E, -1, np.int32)
    sv = np.zeros(2 * E, np.int32)
    for e, (a, b) in enumerate(edges):
        sv[2 * e] = a; sv[2 * e + 1] = b
    for ids in cycles:
        for i, e in enumerate(ids):
            nxt_e = ids[(i + 1) % len(ids)]
            mate[2 * e + 1] = 2 * nxt_e
            mate[2 * nxt_e] = 2 * e + 1
    return mate, sv, E

covers = []
for trial in range(4):
    nv = int(rng.integers(2, 9))
    nt = int(rng.integers(1, 5))
    tl = int(rng.integers(2, 7))
    covers.append(random_cycle_cover(nv, nt, tl))
'''

_REFERENCE = _COVERS + '''
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core.phase3 import phase3_sharded, shard_width
from repro.euler import solve
from repro.graphgen.eulerize import eulerian_rmat
from repro.parallel.compat import make_mesh, shard_map

rec = {{}}
e_max = max(E for _, _, E in covers)
for n in {parts}:
    S = shard_width(e_max, n)
    n_stubs = 2 * e_max
    p3v = 8 + max(int(np.bincount(np.arange(sv.max() + 1) % n,
                                  weights=np.bincount(sv), minlength=n).max())
                  for _, sv, _ in covers)
    rec[f"{{n}}/p3v"] = np.int64(p3v)

    def f(m_sh, s_sh):
        return (phase3_sharded(m_sh, s_sh, "x", n, n_stubs, p3v,
                               interpret=True)
                + phase3_sharded(m_sh, s_sh, "x", n, n_stubs, p3v,
                                 gather_circuit=False, interpret=True))

    fn = jax.jit(shard_map(f, make_mesh((n,), ("x",)), (P("x"), P("x")),
                           (P(None), P(None), P(), P("x"), P("x"), P("x"),
                            P())))
    for t, (mate, sv, E) in enumerate(covers):
        pad = n * S - 2 * E
        m_p = np.concatenate([mate, np.full(pad, -1, np.int32)])
        s_p = np.concatenate([sv, np.zeros(pad, np.int32)])
        out = [np.asarray(x) for x in fn(jnp.asarray(m_p), jnp.asarray(s_p))]
        k = f"{{n}}/{{t}}/"
        rec[k + "mate_in"], rec[k + "sv_in"] = m_p, s_p
        for name, x in zip(("circuit", "mate", "ok", "mate_sh", "dist_sh",
                            "reach_sh", "ok_sh"), out):
            rec[k + name] = x
for n in {solve_parts}:
    for s in {solve_scales}:
        r = solve(eulerian_rmat(s, avg_degree=4, seed=s), n_parts=n)
        rec[f"solve/{{n}}_{{s}}/circuit"] = r.circuit
        rec[f"solve/{{n}}_{{s}}/mate"] = r.mate
np.savez({out!r}, **rec)
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sharded") / "ref.npz")
    run_with_devices(_REFERENCE.format(parts=PARTS, solve_parts=SOLVE_PARTS,
                                       solve_scales=SOLVE_SCALES, out=out),
                     n=8, timeout=LIVE_TIMEOUT)
    with np.load(out) as z:
        return dict(z)


# ----------------------------------------------------------------------
# K3/K4: twins and CPU wrappers
# ----------------------------------------------------------------------
def shard_inputs(N, n_shards, shard, n_tables, seed):
    """Seeded ring-step inputs: ``N`` queries over an ``n_shards·S`` id
    space and some beyond it on both sides, the visiting slice of
    ``shard`` at ``base = shard·S`` with ``T − S`` pad rows past
    ``s_real = S``.  Returns ``(q, carries, base, tables, s_real)``."""
    rng = np.random.default_rng(seed)
    S = 64
    T = S + 24
    q = rng.integers(-20, n_shards * S + 20, N).astype(np.int32)
    carries = tuple(rng.integers(0, 1 << 20, N).astype(np.int32)
                    for _ in range(n_tables))
    tables = tuple(rng.integers(0, 1 << 20, T).astype(np.int32)
                   for _ in range(n_tables))
    return q, carries, np.array([shard * S], np.int32), tables, S


KERNELS = {
    "K3": (pd.pointer_double_shard, ref.pointer_double_shard_ref,
           jref.pointer_double_shard_ref, j_shard, 2),
    "K4": (pd.pointer_double_rank_shard, ref.pointer_double_rank_shard_ref,
           jref.pointer_double_rank_shard_ref, j_rank_shard, 3),
}


def _t(xs):
    return tuple(torch.from_numpy(x) for x in xs)


def _same(a, b):
    return all(np.array_equal(np.asarray(x), y.numpy()) for x, y in zip(a, b))


@pytest.mark.parametrize("N", [1024, 1000])
@pytest.mark.parametrize("shard", ["first", "last"])
@pytest.mark.parametrize("name", sorted(KERNELS))
def test_shard_twin_and_wrapper_match_jax_ref_and_pallas(name, shard, N):
    kernel, twin, j_twin, j_kernel, k = KERNELS[name]
    n_shards = 4
    q, carries, base, tables, s_real = shard_inputs(
        N, n_shards, 0 if shard == "first" else n_shards - 1, k, N + k)
    args = (q, *carries, base, *tables)
    before = kernel.launches
    mine = twin(*_t(args), s_real=s_real)
    wrapped = kernel(*_t(args), s_real=s_real)
    assert kernel.launches == before                 # CPU: no launch
    assert all(torch.equal(a, b) for a, b in zip(mine, wrapped))
    own = (q >= base[0]) & (q < base[0] + s_real)
    assert 0 < own.sum() < N                         # both branches taken
    j_args = tuple(jnp.asarray(x) for x in args)
    assert _same(j_twin(*j_args, s_real=s_real), mine)
    assert _same(j_kernel(*j_args, s_real=s_real, block=256,
                          interpret=True), mine)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_all_shard_rows_match_the_single_shard_form(name):
    """The port's [n, S] form: row r is the reference's single-shard call
    with ``base[r]`` and table row r."""
    kernel, twin, j_twin, _, k = KERNELS[name]
    rng = np.random.default_rng(k)
    n, S, T = 4, 48, 56
    q = rng.integers(-5, n * S + 5, (n, S)).astype(np.int32)
    carries = tuple(rng.integers(0, 999, (n, S)).astype(np.int32)
                    for _ in range(k))
    base = (rng.permutation(n) * S).astype(np.int32)
    tables = tuple(rng.integers(0, 999, (n, T)).astype(np.int32)
                   for _ in range(k))
    got = kernel(*_t((q, *carries, base, *tables)), s_real=S)
    for r in range(n):
        want = j_twin(*(jnp.asarray(x[r]) for x in (q, *carries)),
                      jnp.asarray(base[r:r + 1]),
                      *(jnp.asarray(t[r]) for t in tables), s_real=S)
        assert all(np.array_equal(np.asarray(w), g[r].numpy())
                   for w, g in zip(want, got))
    outs = tuple(torch.empty(n, S, dtype=torch.int32) for _ in range(k))
    res = kernel(*_t((q, *carries, base, *tables)), s_real=S, out=outs)
    assert all(a is b for a, b in zip(res, outs))
    assert all(torch.equal(a, b) for a, b in zip(res, got))
    assert all(torch.equal(a, b) for a, b in zip(
        got, twin(*_t((q, *carries, base, *tables)), s_real=S)))


def test_shard_wrapper_checks_its_tensors():
    q, carries, base, tables, S = shard_inputs(256, 4, 1, 2, 0)
    (q, base), (a, b), (tn, tl) = _t((q, base)), _t(carries), _t(tables)
    k3 = pd.pointer_double_shard
    with pytest.raises(TypeError):
        k3(q.long(), a, b, base, tn, tl, s_real=S)
    with pytest.raises(ValueError):                 # carry shape
        k3(q, a[:100], b, base, tn, tl, s_real=S)
    with pytest.raises(ValueError):                 # base must be [1]
        k3(q, a, b, base.repeat(2), tn, tl, s_real=S)
    with pytest.raises(ValueError):                 # s_real beyond T
        k3(q, a, b, base, tn, tl, s_real=tn.shape[0] + 1)
    with pytest.raises(ValueError):                 # tables differ
        k3(q, a, b, base, tn, tl[:10], s_real=8)
    with pytest.raises(ValueError):                 # not contiguous
        k3(q[::2], a[::2], b[::2], base, tn, tl, s_real=S)
    with pytest.raises(ValueError):                 # output on an input
        k3(q, a, b, base, tn, tl, s_real=S, out=(a, torch.empty_like(b)))
    with pytest.raises(ValueError):                 # output on a table
        k3(tn.clone(), tn.clone(), tl.clone(), base, tn, tl, s_real=S,
           out=(torch.empty_like(tn), tl))
    with pytest.raises(ValueError):                 # rows: base must be [n]
        k3(q.view(4, 64), a.view(4, 64), b.view(4, 64), base, tn.repeat(4, 1),
           tl.repeat(4, 1), s_real=S)


# ----------------------------------------------------------------------
# phase3_sharded against the JAX phase3_sharded under shard_map
# ----------------------------------------------------------------------
@pytest.mark.parametrize("gather", [True, False])
@pytest.mark.parametrize("P", PARTS)
@pytest.mark.parametrize("trial", TRIALS)
def test_phase3_sharded_byte_identical(reference, trial, P, gather):
    k = f"{P}/{trial}/"
    S = reference[k + "mate_in"].shape[0] // P
    mate = torch.from_numpy(reference[k + "mate_in"]).view(P, S)
    sv = torch.from_numpy(reference[k + "sv_in"]).view(P, S)
    n_stubs = 2 * reference[k + "circuit"].shape[0]
    before = (pd.pointer_double_shard.launches,
              pd.pointer_double_rank_shard.launches)
    out = tp3.phase3_sharded(mate, sv, n_stubs, int(reference[f"{P}/p3v"]),
                             gather_circuit=gather)
    assert (pd.pointer_double_shard.launches,
            pd.pointer_double_rank_shard.launches) == before
    names = ("circuit", "mate", "ok") if gather else (
        "mate_sh", "dist_sh", "reach_sh", "ok_sh")
    for name, got in zip(names, out):
        want = reference[k + name]
        assert got.dtype in (torch.int32, torch.bool), name
        np.testing.assert_array_equal(got.reshape(want.shape).numpy(), want,
                                      err_msg=f"{k}{name}")
    assert bool(out[-1])


def test_sharded_equals_replicated_and_numpy_rank(reference):
    """The same covers through the port's replicated Phase 3 and the numpy
    list-rank twin: all three agree (the reference's own layering)."""
    for trial in TRIALS:
        m_in = torch.from_numpy(reference[f"8/{trial}/mate_in"])
        sv_in = torch.from_numpy(reference[f"8/{trial}/sv_in"])
        c_rep, m_rep, ok = tp3.phase3_device(m_in, sv_in)
        assert bool(ok)
        np.testing.assert_array_equal(c_rep.numpy(),
                                      reference[f"8/{trial}/circuit"])
        np.testing.assert_array_equal(m_rep.numpy(),
                                      reference[f"8/{trial}/mate"])
        live = tp3.circuit_from_mate_np(m_rep.numpy())
        np.testing.assert_array_equal(c_rep.numpy()[:len(live)], live)


def test_undersized_vertex_table_reports_not_ok():
    """A p3v_cap below the vertex records a shard owns fails ``ok``; it
    never passes a wrong mate off as converged."""
    rng = np.random.default_rng(3)
    g = eulerian_rmat(5, avg_degree=4, seed=5)
    sv = torch.empty(2 * g.num_edges, dtype=torch.int32)
    sv[0::2], sv[1::2] = torch.from_numpy(g.edge_u), torch.from_numpy(g.edge_v)
    order = torch.from_numpy(rng.permutation(2 * g.num_edges))
    mate = torch.empty_like(sv)                  # a random perfect matching
    mate[order[0::2]], mate[order[1::2]] = \
        order[1::2].to(torch.int32), order[0::2].to(torch.int32)
    _, ok = tp3.splice_components_sharded(stub_shards(mate, 2, -1),
                                          stub_shards(sv, 2, 0), p3v_cap=4)
    assert not bool(ok)


@pytest.mark.parametrize("E,n", [(128, 8), (100, 8), (3, 4), (2 ** 22, 8)])
def test_schedule_and_width_match_the_reference(E, n):
    for gather in (True, False):
        assert tp3.sharded_phase3_schedule(E, n, gather) == \
            jp3.sharded_phase3_schedule(E, n, gather)
    assert tp3.shard_width(E, n) == jp3.shard_width(E, n)


# ----------------------------------------------------------------------
# whole solves: every Phase 3 mode against the JAX default
# ----------------------------------------------------------------------
MODES = {"sharded": {}, "replicated": {"sharded_phase3": False},
         "no_gather": {"gather_circuit": False}}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("scale", SOLVE_SCALES)
@pytest.mark.parametrize("P", SOLVE_PARTS)
def test_solve_modes_byte_identical_to_jax_default(reference, P, scale, mode):
    """The port's default (fused) run and its eager oracle, whose Phase 3
    steps are clocked one by one."""
    g = eulerian_rmat(scale, avg_degree=4, seed=scale)
    for fused in (True, False):
        res = solve(g, n_parts=P, device="cpu", fused=fused,
                    **MODES[mode]).validate()
        np.testing.assert_array_equal(res.circuit,
                                      reference[f"solve/{P}_{scale}/circuit"])
        np.testing.assert_array_equal(res.mate,
                                      reference[f"solve/{P}_{scale}/mate"])
        assert res.phase3_converged and res.fused == fused
    t = res.timings
    parts = (("splice_s", "emit_s") if mode == "replicated" else
             ("cc_s", "splice_s", "rank_s", "emit_s"))
    assert sum(t[k] for k in parts) == pytest.approx(t["phase3_s"])
    assert ("host_emit_s" in t) == (mode == "no_gather")


def test_solver_defaults_follow_the_reference():
    assert EulerSolver(n_parts=8, device="cpu").sharded_phase3
    assert not EulerSolver(n_parts=1, device="cpu").sharded_phase3
    assert EulerSolver(n_parts=1, device="cpu",
                       sharded_phase3=True).sharded_phase3
    assert not EulerSolver(n_parts=8, device="cpu",
                           sharded_phase3=False).sharded_phase3
    with pytest.raises(ValueError, match="requires sharded_phase3"):
        EulerSolver(n_parts=1, device="cpu", gather_circuit=False)
    with pytest.raises(ValueError, match="requires sharded_phase3"):
        EulerSolver(n_parts=8, device="cpu", sharded_phase3=False,
                    gather_circuit=False)


# ----------------------------------------------------------------------
# tests/test_sharded_phase3.py's solver matrix and seeded fuzz, port side:
# every Phase 3 mode gives the same bytes and a valid circuit
# ----------------------------------------------------------------------
def random_eulerian(n_vertices, n_trails, trail_len, seed):
    """tests/test_sharded_phase3.py::random_eulerian_np as a port Graph."""
    from test_sharded_phase3 import random_eulerian_np

    g = random_eulerian_np(n_vertices, n_trails, trail_len, seed)
    return Graph(g.num_vertices, g.edge_u, g.edge_v)


@pytest.mark.parametrize("P", [2, 4])
def test_solver_mode_matrix(P):
    for args in [(10, 1, 12, 7), (18, 3, 8, 8), (24, 6, 5, 9)]:
        g = random_eulerian(*args)
        runs = [solve(g, n_parts=P, device="cpu", **opts).validate()
                for opts in MODES.values()]
        for r in runs[1:]:
            np.testing.assert_array_equal(runs[0].circuit, r.circuit)
            np.testing.assert_array_equal(runs[0].mate, r.mate)


@pytest.mark.parametrize("seed", range(8))
def test_sharded_fuzz_single_partition(seed):
    rng = np.random.default_rng(seed)
    nv, trails, tlen = (int(rng.integers(4, 29)), int(rng.integers(1, 7)),
                        int(rng.integers(3, 11)))
    g = random_eulerian(nv, trails, tlen, int(rng.integers(0, 2 ** 31 - 1)))
    rep = solve(g, n_parts=1, device="cpu").validate()
    sh = solve(g, n_parts=1, device="cpu", sharded_phase3=True).validate()
    np.testing.assert_array_equal(rep.circuit, sh.circuit)
    np.testing.assert_array_equal(rep.mate, sh.mate)
    assert sorted(sh.circuit >> 1) == list(range(g.num_edges))
