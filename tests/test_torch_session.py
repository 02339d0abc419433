"""The port's solver session against the JAX package's: the options and
their bucket keys, solves under non-default options byte for byte, the
counted program LRU and its ``CacheStats``, ``solve_many``, the per-graph
prep memo and the device-resident state.

The references' outputs are a golden file,
``tests/golden/torch_session_reference.npz``, written by the JAX package
(frozen, so it cannot drift) with ``PYTHONPATH=src python
tests/test_torch_session.py`` (one subprocess with 8 simulated devices):
scale-6 solves under four non-default option sets at P ∈ {2, 8}, and the
``tests/test_euler_api.py`` ``solve_many`` scenario's bucket and two of
its one-shot solves at scale 8, P = 8.  ``test_golden_is_the_jax_output``
solves one case of it again live, and with ``remote_dedup=False``, which
the reference's device engine stores and never reads.  The bucket keys
come from the reference's ``bucket_of``, host-side numpy, in this
process.  On a card (``gpu`` tests) two recorded graphs stay alive at
once, and an evicted one gives its memory back; the card's machine has
no JAX, so the JAX package is imported only inside the CPU tests."""
import dataclasses
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from conftest import run_with_devices
from repro_torch.core.engine import Engine
from repro_torch.core.graph import Graph
from repro_torch.euler import CacheStats, EulerSolver, solve, solve_many
from repro_torch.euler import solver as solver_mod
from repro_torch.graphgen.eulerize import eulerian_rmat

#: non-default option sets held byte for byte to the reference (scale 6)
OPTION_SETS = {
    "seed3": {"partition_seed": 3},
    "slack2": {"slack": 2.0},
    "no_ladders": {"cap_ladder": False, "level_ladder": False,
                   "straggler_cap": False},
    "bucket1024": {"min_bucket_edges": 1024},
}
GOLDEN_PARTS = [2, 8]
#: the CPU solve of bucket1024 at P = 8 takes about a minute (2,048-edge
#: tables a partition); it runs on the card (gpu test) instead
CARD_ONLY = [("bucket1024", 8)]
CPU_CASES = [(name, P) for name in sorted(OPTION_SETS) for P in GOLDEN_PARTS
             if (name, P) not in CARD_ONLY]

GOLDEN = Path(__file__).resolve().parent / "golden" / \
    "torch_session_reference.npz"

_REFERENCE = '''
import numpy as np
from repro.euler import EulerSolver, solve
from repro.graphgen.eulerize import eulerian_rmat
rec = {{}}
g = eulerian_rmat(6, avg_degree=4, seed=6)
for name, opts in {opts!r}.items():
    for P in {parts}:
        r = solve(g, n_parts=P, sharded_phase3=False, **opts)
        rec[f"{{name}}_{{P}}/circuit"], rec[f"{{name}}_{{P}}/mate"] = r.circuit, r.mate
        if {dedup}:
            d = solve(g, n_parts=P, sharded_phase3=False, remote_dedup=False,
                      **opts)
            rec[f"{{name}}_{{P}}/nodedup_circuit"] = d.circuit
            rec[f"{{name}}_{{P}}/nodedup_mate"] = d.mate
if {many}:
    solver = EulerSolver(n_parts=8)
    buckets = {{}}
    for s in range(30):
        g = eulerian_rmat(8, avg_degree=5, seed=s)
        buckets.setdefault(solver.bucket_of(g), []).append(s)
    seeds = max(buckets.values(), key=len)[:8]
    rec["many/seeds"] = np.array(seeds)
    for i in (0, 3):
        r = solve(eulerian_rmat(8, avg_degree=5, seed=seeds[i]), n_parts=8)
        rec[f"many_{{i}}/circuit"], rec[f"many_{{i}}/mate"] = r.circuit, r.mate
np.savez_compressed({out!r}, **rec)
'''


def jax_reference(out, opts=OPTION_SETS, parts=GOLDEN_PARTS, many=True,
                  dedup=False, devices=8) -> None:
    """The JAX package's circuits and mates under each option set (and,
    with ``many``, the ``solve_many`` scenario), into the ``.npz`` file
    ``out``.  The references run the replicated Phase 3; the port's
    default sharded one is held to them."""
    run_with_devices(_REFERENCE.format(opts=opts, parts=list(parts),
                                       many=many, dedup=dedup,
                                       out=str(out)), n=devices)


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
def reference():
    with np.load(GOLDEN) as z:
        return dict(z)


def same_bytes(a, b) -> bool:
    return (np.array_equal(a.circuit, b.circuit)
            and np.array_equal(a.mate, b.mate))


def counts(stats) -> dict:
    """The cumulative counters of a ``CacheStats`` of either package."""
    return {k: v for k, v in dataclasses.asdict(stats).items()
            if k not in ("bucket", "hit", "batch")}


# ---------------------------------------------------------------------------
# options: bucket keys equal to the reference's
# ---------------------------------------------------------------------------

KEY_OPTIONS = {
    "defaults": {},
    **OPTION_SETS,
    "no_cap_ladder": {"cap_ladder": False},
    "no_level_ladder": {"level_ladder": False},
    "fixed_rounds": {"straggler_cap": False},
    "waste_cap_1": {"ladder_waste_cap": 1.0},
}


@pytest.mark.parametrize("name", sorted(KEY_OPTIONS))
def test_bucket_of_matches_reference(name):
    """The same key (e_cap, n_parts, n_levels and every ``EngineCaps``
    field) and the same measured waste, at scales 5–7, P ∈ {2, 8}."""
    from repro.euler import EulerSolver as JSolver
    from repro.graphgen.eulerize import eulerian_rmat as j_eulerian_rmat

    opts = KEY_OPTIONS[name]
    for P in (2, 8):
        ours = EulerSolver(n_parts=P, device="cpu", **opts)
        theirs = JSolver(n_parts=P, **opts)
        for scale in (5, 6, 7):
            seed = scale + P
            k = ours.bucket_of(eulerian_rmat(scale, avg_degree=4, seed=seed))
            j = theirs.bucket_of(j_eulerian_rmat(scale, avg_degree=4,
                                                 seed=seed))
            assert k[:3] == j[:3], (P, scale)
            assert dataclasses.asdict(k[3]) == dataclasses.asdict(j[3])
        assert sorted(ours.bucket_waste.values()) == \
            sorted(theirs.bucket_waste.values())


def test_ladder_collapses_scale5_pool_buckets():
    """``tests/test_batched.py``'s pool on the port: six scale-5 graphs
    land in at most two buckets under the ladder, fewer than under the
    pow2 keying, and the measured waste stays within its cap."""
    graphs = [eulerian_rmat(5, avg_degree=4, seed=s) for s in range(6)]
    ladder = EulerSolver(n_parts=8, device="cpu")
    pow2 = EulerSolver(n_parts=8, device="cpu", cap_ladder=False,
                       level_ladder=False, straggler_cap=False)
    nb_ladder = len({ladder.bucket_of(g) for g in graphs})
    nb_pow2 = len({pow2.bucket_of(g) for g in graphs})
    assert nb_ladder <= 2 and nb_ladder < nb_pow2, (nb_ladder, nb_pow2)
    assert ladder.bucket_waste
    assert all(w <= ladder.ladder_waste_cap
               for w in ladder.bucket_waste.values())


def test_straggler_cap_off_gives_fixed_round_budgets():
    g = eulerian_rmat(5, avg_degree=4, seed=0)
    caps = EulerSolver(n_parts=8, device="cpu").bucket_of(g)[3]
    assert caps.splice_rounds <= 12 and caps.phase3_rounds < 64
    fixed = EulerSolver(n_parts=8, device="cpu",
                        straggler_cap=False).bucket_of(g)[3]
    assert (fixed.splice_rounds, fixed.phase3_rounds) == (12, 64)


# ---------------------------------------------------------------------------
# solves under non-default options: the reference's bytes
# ---------------------------------------------------------------------------

def test_golden_is_the_jax_output(reference, tmp_path):
    """One case of the golden file solved again by the JAX package, once
    with ``remote_dedup=False``: the reference's device engine stores
    that option and never reads it, so its bytes are the same."""
    out = tmp_path / "live.npz"
    jax_reference(out, opts={"seed3": OPTION_SETS["seed3"]}, parts=[2],
                  many=False, dedup=True, devices=2)
    with np.load(out) as z:
        live = dict(z)
    for k in ("circuit", "mate"):
        np.testing.assert_array_equal(live[f"seed3_2/{k}"],
                                      reference[f"seed3_2/{k}"])
        np.testing.assert_array_equal(live[f"seed3_2/nodedup_{k}"],
                                      reference[f"seed3_2/{k}"])
    assert set(reference) == (
        {f"{n}_{P}/{k}" for n in OPTION_SETS for P in GOLDEN_PARTS
         for k in ("circuit", "mate")}
        | {"many/seeds"} | {f"many_{i}/{k}" for i in (0, 3)
                            for k in ("circuit", "mate")})


@pytest.mark.parametrize("name,P", CPU_CASES)
def test_options_byte_identical_to_jax(reference, name, P):
    g = eulerian_rmat(6, avg_degree=4, seed=6)
    res = solve(g, n_parts=P, device="cpu", **OPTION_SETS[name]).validate()
    np.testing.assert_array_equal(res.circuit,
                                  reference[f"{name}_{P}/circuit"])
    np.testing.assert_array_equal(res.mate, reference[f"{name}_{P}/mate"])


def test_remote_dedup_off_changes_nothing(reference):
    """As in the reference's device engine: the same bytes."""
    g = eulerian_rmat(6, avg_degree=4, seed=6)
    res = solve(g, n_parts=2, device="cpu", remote_dedup=False,
                **OPTION_SETS["seed3"]).validate()
    np.testing.assert_array_equal(res.circuit, reference["seed3_2/circuit"])
    np.testing.assert_array_equal(res.mate, reference["seed3_2/mate"])


def test_unported_options_raise():
    g = eulerian_rmat(5, avg_degree=4, seed=0)
    with pytest.raises(ValueError, match="queue 3"):
        EulerSolver(n_parts=2, device="cpu", deferred_transfer=False)
    caps = EulerSolver(n_parts=2, device="cpu").bucket_of(g)[3]
    with pytest.raises(ValueError, match="queue 3"):
        Engine(2, caps, 2, deferred_transfer=False)
    solver = EulerSolver(n_parts=2, device="cpu")
    with pytest.raises(NotImplementedError, match="item 3"):
        solver.solve_many([g, g], batch=2)
    with pytest.raises(NotImplementedError, match="item 3"):
        solve_many([g], batch=4, n_parts=2, device="cpu")
    assert solver.cache_stats == CacheStats()      # nothing ran


# ---------------------------------------------------------------------------
# the counted program LRU
# ---------------------------------------------------------------------------

def test_program_cache_lru_matches_reference():
    """``tests/test_batched.py``'s LRU sequence on both packages: the
    same hits, misses and evictions, and the same live programs."""
    from repro.euler import EulerSolver as JSolver

    ours = EulerSolver(n_parts=1, device="cpu", program_cache_max=2)
    theirs = JSolver(n_parts=1, program_cache_max=2)
    k1, k2, k3 = ("b1",), ("b2",), ("b3",)
    for solver in (ours, theirs):
        assert not solver._account(k1, None)       # miss, cached
        assert not solver._account(k2, None)       # miss, cached (full)
        assert solver._account(k1, None)           # hit: k1 becomes MRU
        assert not solver._account(k3, None)       # miss: evicts LRU k2
        cs = solver.cache_stats
        assert (cs.hits, cs.misses, cs.evictions) == (1, 3, 1)
        assert [k for k, _ in solver._programs] == [k1, k3]
    assert counts(ours.cache_stats) == counts(theirs.cache_stats)
    snap = dataclasses.replace(ours.cache_stats, bucket=k1, hit=True)
    assert snap.evictions == 1 and snap.compiles == 0


def _two_buckets():
    a = eulerian_rmat(5, avg_degree=4, seed=1)
    b = eulerian_rmat(6, avg_degree=4, seed=2)
    return a, b


@pytest.mark.parametrize("cap", [1, 2])
def test_lru_over_two_buckets_on_cpu(cap):
    """A, B, A, B: under ``program_cache_max=1`` each solve evicts the
    other bucket's run (its inputs and outputs dropped, a new run made
    and traced again), under 2 both stay; the engines keep their
    resident states either way, and every solve has the first bytes."""
    a, b = _two_buckets()
    solver = EulerSolver(n_parts=2, device="cpu", program_cache_max=cap)
    key_a, key_b = solver.bucket_of(a), solver.bucket_of(b)
    assert key_a != key_b
    first = {}
    runs = {}
    for i, g in enumerate((a, b, a, b)):
        key = key_a if g is a else key_b
        res = solver.solve(g).validate()
        assert res.cache.bucket == key and res.cache.hit == (
            cap == 2 and i >= 2)
        if key in first:
            assert same_bytes(res, first[key])
        first.setdefault(key, res)
        run = solver._engines[key].fused_program(key[0])
        if key in runs and cap == 1:
            old = runs[key]
            assert run is not old and old.inputs is None and old.out is None
        runs[key] = run
    cs = solver.cache_stats
    want = ({"hits": 0, "misses": 4, "traces": 4, "evictions": 3}
            if cap == 1 else
            {"hits": 2, "misses": 2, "traces": 2, "evictions": 0})
    assert {k: getattr(cs, k) for k in want} == want
    assert cs.state_uploads == 2
    live = [k for k in (key_a, key_b) if solver._engines[k]._fused]
    assert live == ([key_b] if cap == 1 else [key_a, key_b])


def test_evicted_engine_takes_its_programs_along():
    """The engine FIFO (16 in the reference) evicts a bucket's programs
    with its engine."""
    a, b = _two_buckets()
    solver = EulerSolver(n_parts=2, device="cpu")
    solver._engines_max = 1
    solver.solve(a)
    solver.solve(b)
    assert list(solver._engines) == [solver.bucket_of(b)]
    assert [k for k, _ in solver._programs] == [solver.bucket_of(b)]
    assert solver.cache_stats.evictions == 1


# ---------------------------------------------------------------------------
# solve_many: tests/test_euler_api.py's scenario
# ---------------------------------------------------------------------------

def test_solve_many_single_trace_byte_identical(reference):
    """The modal bucket of 30 scale-8 graphs (the reference's bucket too):
    one trace serves all 8 solves, 1 miss and 7 hits, every result
    valid and in the bucket, byte-identical to one-shot solves and to
    the JAX package's one-shot solves."""
    solver = EulerSolver(n_parts=8, device="cpu")
    buckets = {}
    for s in range(30):
        g = eulerian_rmat(8, avg_degree=5, seed=s)
        buckets.setdefault(solver.bucket_of(g), []).append((s, g))
    key, group = max(buckets.items(), key=lambda kv: len(kv[1]))
    assert len(group) >= 8, f"modal bucket holds {len(group)} < 8 graphs"
    group = group[:8]
    assert [s for s, _ in group] == reference["many/seeds"].tolist()

    results = solver.solve_many([g for _, g in group])
    cs = solver.cache_stats
    assert cs.traces == 1, f"fused program traced {cs.traces}x"
    assert cs.misses == 1 and cs.hits == len(group) - 1
    assert cs.state_uploads == len(group) and cs.evictions == 0
    assert not results[0].cache.hit and results[-1].cache.hit
    for (_, g), r in zip(group, results):
        r.validate()
        assert len(r.circuit) == g.num_edges
        assert r.cache.bucket == key
    for i in (0, 3):
        np.testing.assert_array_equal(results[i].circuit,
                                      reference[f"many_{i}/circuit"])
        np.testing.assert_array_equal(results[i].mate,
                                      reference[f"many_{i}/mate"])
        assert same_bytes(solve(group[i][1], n_parts=8, device="cpu"),
                          results[i])


# ---------------------------------------------------------------------------
# the prep memo and the device-resident state
# ---------------------------------------------------------------------------

def _counting_partitioner():
    calls = []
    real = solver_mod.partition_vertices

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)
    return calls, mock.patch.object(solver_mod, "partition_vertices",
                                    counted)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
def test_repeat_solve_skips_prep_and_upload(fused):
    """A repeat solve of the same ``Graph`` calls no partitioner and
    uploads nothing, and gives the same bytes."""
    g = eulerian_rmat(6, avg_degree=4, seed=3)
    solver = EulerSolver(n_parts=2, device="cpu", fused=fused)
    calls, patch = _counting_partitioner()
    with patch:
        first = solver.solve(g).validate()
        again = solver.solve(g).validate()
    assert len(calls) == 1
    assert first.cache.state_uploads == again.cache.state_uploads == 1
    assert not first.cache.hit and again.cache.hit
    assert same_bytes(first, again)


def test_device_resident_off_uploads_every_solve():
    g = eulerian_rmat(6, avg_degree=4, seed=3)
    on = EulerSolver(n_parts=2, device="cpu")
    off = EulerSolver(n_parts=2, device="cpu", device_resident=False)
    runs = {s: [s.solve(g), s.solve(g), s.solve(g)] for s in (on, off)}
    assert [r.cache.state_uploads for r in runs[on]] == [1, 1, 1]
    assert [r.cache.state_uploads for r in runs[off]] == [1, 2, 3]
    eng = off._engines[off.bucket_of(g)]
    assert all(ent["dev"] is None for ent in eng._load_cache.values())
    for r in runs[on] + runs[off]:
        assert same_bytes(r, runs[on][0])


def test_new_graph_with_same_edges_gets_its_own_state():
    """The memo and the engine's load cache are keyed by identity: a new
    ``Graph`` with the same edges is prepared and uploaded anew, and a
    graph of another shape in the bucket is not served the first's
    resident state."""
    g = eulerian_rmat(6, avg_degree=4, seed=3)
    twin = Graph(g.num_vertices, g.edge_u.copy(), g.edge_v.copy())
    solver = EulerSolver(n_parts=2, device="cpu")
    calls, patch = _counting_partitioner()
    with patch:
        first = solver.solve(g)
        second = solver.solve(twin).validate()
    assert len(calls) == 2 and second.cache.state_uploads == 2
    assert second.graph is twin and same_bytes(first, second)
    others = [h for h in (eulerian_rmat(6, avg_degree=4, seed=s)
                          for s in range(4, 12))
              if solver.bucket_of(h) == solver.bucket_of(g)]
    assert others, "no other seed shares the bucket"
    other = solver.solve(others[0]).validate()
    assert other.cache.hit and other.cache.state_uploads == 3
    assert same_bytes(other, solve(others[0], n_parts=2, device="cpu"))


def test_memo_is_bounded_and_skipped_for_given_partitions():
    g = eulerian_rmat(5, avg_degree=4, seed=0)
    solver = EulerSolver(n_parts=2, device="cpu")
    solver._prep_cache_max = 2
    graphs = [Graph(g.num_vertices, g.edge_u.copy(), g.edge_v.copy())
              for _ in range(3)]
    for h in graphs:
        solver.bucket_of(h)
    assert [v[0] for v in solver._prep_cache.values()] == graphs[1:]
    part = np.arange(g.num_vertices) % 2
    pg1 = solver._prepare(g, part)[0]
    assert solver._prepare(g, part)[0] is not pg1
    assert id(g) not in solver._prep_cache


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: CUDA graphs record only on the card")


@pytest.mark.gpu
def test_cuda_two_graphs_alive_replay_a_b_a():
    """On a card: A records, B records beside it, A replays reading its
    own static tables, each byte-equal to its CPU solve; two graphs
    recorded in all."""
    _need_card()
    a, b = (eulerian_rmat(9, avg_degree=5, seed=1),
            eulerian_rmat(10, avg_degree=5, seed=1))
    solver = EulerSolver(n_parts=8)
    got = [solver.solve(g).validate() for g in (a, b, a, b)]
    assert solver.captures == 2
    assert [r.cache.hit for r in got] == [False, False, True, True]
    for g, r in zip((a, b, a, b), got):
        assert same_bytes(r, solve(g, n_parts=8, device="cpu"))
    assert solver._g_bytes.value == sum(
        e.reserved_bytes() for e in solver._engines.values()) > 0


@pytest.mark.gpu
def test_cuda_eviction_gives_the_pools_back():
    """On a card, under ``program_cache_max=1``: recording B evicts A
    first, and the card's reserved memory falls by at least 0.9 of what
    A's recording reserved; A then records again and replays right."""
    _need_card()
    a, b = (eulerian_rmat(10, avg_degree=5, seed=1),
            eulerian_rmat(11, avg_degree=5, seed=1))
    solver = EulerSolver(n_parts=8, program_cache_max=1)
    first = solver.solve(a).validate()
    key_a = solver.bucket_of(a)
    run = solver._engines[key_a].fused_program(key_a[0])
    held = run.reserved_bytes
    assert held > 0
    before = torch.cuda.memory_reserved()
    solver._evict_entry((key_a, None))
    freed = before - torch.cuda.memory_reserved()
    assert run.graph is None and freed >= 0.9 * held, (freed, held)
    solver.solve(b).validate()
    again = solver.solve(a).validate()
    assert same_bytes(first, again) and solver.captures == 3
    assert solver.cache_stats.evictions == 2


@pytest.mark.gpu
def test_cuda_card_only_options_byte_identical_to_jax(reference):
    _need_card()
    for name, P in CARD_ONLY:
        g = eulerian_rmat(6, avg_degree=4, seed=6)
        res = solve(g, n_parts=P, **OPTION_SETS[name]).validate()
        np.testing.assert_array_equal(res.circuit,
                                      reference[f"{name}_{P}/circuit"])
        np.testing.assert_array_equal(res.mate,
                                      reference[f"{name}_{P}/mate"])


if __name__ == "__main__":
    jax_reference(GOLDEN)
