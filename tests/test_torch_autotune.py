"""The port's serving autotuner (``repro_torch.euler.autotune``: the
compile thread ``CompileService``, the pure ladder policy ``plan``,
``AutoTuner``) and the session's feedback rung (``EulerSolver``'s
``cap_observations``, ``tighten``, ``tightened_scales``, ``rekey``,
``prewarm_async``; ``euler/bucket.py``'s tight profile), on the CPU.

The stand-in solver cases port ``tests/test_autotune.py``'s.  The
policy and the tight floors are held equal to the JAX package's
functions on seeded random inputs (both are pure Python, so they run in
this process).  The adaptive session (the reference's scenario at
``tests/test_autotune.py:424``) runs on the port at ``device="cpu"``
and holds every circuit and mate, the tight re-keyed solves included,
to the JAX package's ``solve`` bytes in the golden
``tests/golden/torch_autotune_reference.npz``, written by
``PYTHONPATH=src python tests/test_torch_autotune.py`` (an 8-device
subprocess); ``test_autotune_golden_is_the_jax_output`` solves one case
again live.  As in the reference's scenario, the adaptive program set
then passes the program audit (``audit_graph(widths="warmed")``).  The reference's scenario keeps only ``drain()``'s results
and so loses the quota flush that ``submit`` returned; the port's
collects both."""
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import run_with_devices
from repro_torch.analysis import audit_graph
from repro_torch.core.engine import FusedRun
from repro_torch.core.graph import Graph
from repro_torch.euler import EulerSolver
from repro_torch.euler import bucket as t_bucket
from repro_torch.euler.autotune import (AutoTuner, BucketStats,
                                        CompileService, Decision,
                                        TunerParams, TunerSnapshot,
                                        ladder_decompose, plan)
from repro_torch.graphgen.eulerize import eulerian_rmat
from repro_torch.launch.serve import MicroBatcher

TESTS = Path(__file__).resolve().parent
GOLDEN = TESTS / "golden" / "torch_autotune_reference.npz"

#: the adaptive session's pool: scale 5, P = 8, the modal bucket of
#: seeds 0–39, its first 4 members
SCALE, PARTS, CANDIDATES, GROUP = 5, 8, 40, 4

_REFERENCE = '''
import numpy as np
from repro.euler import EulerSolver
from repro.graphgen.eulerize import eulerian_rmat
rec = {{}}
solver = EulerSolver(n_parts={parts})
buckets = {{}}
for s in range({candidates}):
    g = eulerian_rmat({scale}, avg_degree=5, seed=s)
    buckets.setdefault(solver.bucket_of(g), []).append((s, g))
key, group = max(buckets.items(), key=lambda kv: len(kv[1]))
group = group[:{group}]
rec["seeds"] = np.array([s for s, _ in group])
rec["e_cap"] = np.array(key[0])
for i in {default}:
    r = solver.solve(group[i][1])
    rec[f"default_{{i}}/circuit"] = r.circuit
    rec[f"default_{{i}}/mate"] = r.mate
tight = EulerSolver(n_parts={parts})
assert tight.tighten(key[0])
for i in {tight}:
    r = tight.solve(group[i][1])
    rec[f"tight_{{i}}/circuit"] = r.circuit
    rec[f"tight_{{i}}/mate"] = r.mate
    rec[f"tight_{{i}}/park_cap"] = np.array(r.cache.bucket[3].park_cap)
np.savez_compressed({out!r}, **rec)
'''


def jax_reference(out, default=range(GROUP), tight=range(GROUP)) -> None:
    """The JAX package's ``solve`` circuits and mates of the session's
    pool (``default``: members solved under the default cap profile;
    ``tight``: members solved in a session whose bucket scale is
    tightened first), into the ``.npz`` file ``out``."""
    run_with_devices(_REFERENCE.format(
        parts=PARTS, candidates=CANDIDATES, scale=SCALE, group=GROUP,
        default=list(default), tight=list(tight), out=str(out)),
        n=PARTS, timeout=1800)



@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU solves here are small (scale 5): one intra-op
    thread runs them fastest and keeps them from contending with the
    suite's other workers; the setting is restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# CompileService: ordering, dedupe, error isolation (tests/test_autotune.py
# :62-146, a stand-in solver)
# ---------------------------------------------------------------------------

class _SvcSolver:
    """Minimal compile-service target: buckets by graph identity, records
    every prewarm/rekey in arrival order."""

    def __init__(self):
        self.warm: dict = {}
        self.log: list = []
        self._lk = threading.Lock()

    def bucket_of(self, graph):
        return graph

    def warmed_widths(self, key):
        with self._lk:
            return sorted(self.warm.get(key, set()))

    def prewarm(self, graph, widths):
        if graph == "boom":
            raise RuntimeError("compile exploded")
        out = []
        with self._lk:
            ws = self.warm.setdefault(self.bucket_of(graph), set())
            for w in widths:
                if w not in ws:
                    ws.add(w)
                    out.append(w)
            self.log.append(("prewarm", graph, tuple(widths)))
        return out

    def rekey(self, e_cap):
        with self._lk:
            self.log.append(("rekey", e_cap))
        return 1


def test_compile_service_drains_by_priority_then_fifo():
    solver = _SvcSolver()
    svc = CompileService(solver, start=False)   # deterministic: queue first
    svc.submit("a", 2, priority=1.0)
    svc.submit("b", 2, priority=5.0)
    svc.submit("c", 2, priority=1.0)            # ties drain FIFO
    svc.submit_retune("d", 128, [2])            # default 1e9: jumps the queue
    assert svc.pending_jobs() == 4 and not svc.idle()
    svc.start()
    assert svc.join(timeout=30)
    assert solver.log == [
        ("rekey", 128), ("prewarm", "d", (1,)), ("prewarm", "d", (2,)),
        ("prewarm", "b", (2,)),
        ("prewarm", "a", (2,)), ("prewarm", "c", (2,)),
    ]
    assert svc.idle() and svc.pending_jobs() == 0
    assert svc.prewarms == 5                    # d×2 + b + a + c
    svc.stop()
    assert not svc._thread.is_alive()
    with pytest.raises(RuntimeError, match="stopped"):
        svc.submit("a", 4)


def test_compile_service_dedupes_and_skips_warm_widths():
    solver = _SvcSolver()
    svc = CompileService(solver, start=False)
    t1 = svc.submit("a", 2)
    t2 = svc.submit("a", 2)                     # still queued → same ticket
    assert t1 is t2 and svc.pending_jobs() == 1
    solver.warm["b"] = {2}
    t3 = svc.submit("b", 2)                     # already warm → done now
    assert t3.done() and t3 is not t1 and svc.pending_jobs() == 1
    svc.start()
    assert t1.wait(timeout=30) and t1.error is None and t1.widths == [2]
    t4 = svc.submit("a", 2)                     # warm after drain → done now
    assert t4.done() and t4 is not t1
    svc.stop()


def test_compile_service_isolates_job_errors():
    solver = _SvcSolver()
    svc = CompileService(solver, start=False)
    bad = svc.submit("boom", 2)
    good = svc.submit("a", 2)
    svc.start()
    assert svc.join(timeout=30)
    assert bad.done() and isinstance(bad.error, RuntimeError)
    assert bad.widths == []
    # the worker survives the failed job and runs the next one
    assert good.error is None and good.widths == [2]
    assert svc.prewarms == 1
    svc.stop()


# ---------------------------------------------------------------------------
# the pure policy: histogram fixtures (tests/test_autotune.py:143-244)
# ---------------------------------------------------------------------------

K = (512, 8)        # plan() only reads key[0]=e_cap, key[1]=n_parts
K2 = (1024, 8)


def test_plan_prewarms_ladder_widths_by_flush_benefit():
    snap = TunerSnapshot(
        buckets={K: BucketStats(mass=10.0, flushes={4: 5.0, 1: 2.0}),
                 K2: BucketStats(mass=0.1, flushes={4: 9.0})},  # < min_mass
        warmed={K: [1], K2: [1]},
        pinned=[], max_batch=4,
    )
    dec = plan(snap)
    # hot bucket's quota width, priority = 5.0 flush-mass × (4-1)/4
    assert dec.prewarm == [(K, 4, pytest.approx(3.75))]
    # the only warmed program with benefit is the hot B=1 fallback
    assert dec.pin == [(K, 1)]
    assert dec.unpin == [] and dec.evict == [] and dec.tighten == []
    # cold bucket ordered nothing (mass below min_mass)
    assert all(key != K2 for key, _, _ in dec.prewarm)


def test_plan_partial_flush_decomposition_and_prewarm_cap():
    # 7-deep flushes on an 8-quota ladder decompose 7 → [4, 2, 1]:
    # both intermediate widths get prewarm orders, amortization-ranked
    snap = TunerSnapshot(
        buckets={K: BucketStats(mass=4.0, flushes={7: 4.0})},
        warmed={K: [1]}, pinned=[], max_batch=8,
    )
    assert ladder_decompose(7, 8) == [4, 2, 1]
    dec = plan(snap)
    assert [(k, w) for k, w, _ in dec.prewarm] == [(K, 4), (K, 2)]
    pri = {w: p for _, w, p in dec.prewarm}
    assert pri[4] == pytest.approx(4.0 * 3 / 4)
    assert pri[2] == pytest.approx(4.0 * 1 / 2)
    # max_prewarms caps orders per step across many hot buckets
    many = {(64 * (i + 1), 8): BucketStats(mass=2.0, flushes={4: 2.0})
            for i in range(10)}
    dec = plan(TunerSnapshot(buckets=many,
                             warmed={k: [1] for k in many},
                             pinned=[], max_batch=4),
               TunerParams(max_prewarms=3))
    assert len(dec.prewarm) == 3


def test_plan_pins_top_programs_and_unpins_stale_ones():
    snap = TunerSnapshot(
        buckets={K: BucketStats(mass=10.0, flushes={4: 6.0}),
                 K2: BucketStats(mass=0.01)},
        warmed={K: [1, 4], K2: [1]},
        pinned=[(K2, 1)],            # pinned while hot, now cold
        max_batch=4,
    )
    dec = plan(snap)
    assert set(dec.pin) == {(K, 4), (K, 1)}
    assert dec.unpin == [(K2, 1)]


def test_plan_evicts_cold_buckets_only_under_byte_pressure():
    buckets = {K: BucketStats(mass=10.0, flushes={4: 6.0}),
               K2: BucketStats(mass=0.01)}          # below evict_mass
    warmed = {K: [1, 4], K2: [1, 2]}
    cold = TunerSnapshot(buckets=dict(buckets), warmed=dict(warmed),
                         pinned=[], max_batch=4,
                         bytes_used=50, bytes_budget=100)
    assert plan(cold).evict == []                   # under hi_water: keep
    hot = TunerSnapshot(buckets=dict(buckets), warmed=dict(warmed),
                        pinned=[], max_batch=4,
                        bytes_used=95, bytes_budget=100)
    dec = plan(hot)
    assert dec.evict == [(K2, 2), (K2, 1)]          # widest first, cold only
    assert all(key != K for key, _ in dec.evict)
    nb = TunerSnapshot(buckets=dict(buckets), warmed=dict(warmed),
                       pinned=[], max_batch=4, bytes_used=10 ** 9)
    assert plan(nb).evict == []                     # no budget → no pressure


def test_plan_tightens_only_wasteful_buckets_that_fit_tight_floors():
    kt = (128, 8)
    fits = {"park_cap": 10, "touch_cap": 50}        # tight floors: 16 / 64
    base = dict(buckets={kt: BucketStats(mass=5.0, flushes={1: 3.0})},
                warmed={kt: [1]}, pinned=[], max_batch=4)
    dec = plan(TunerSnapshot(waste={kt: 2.0}, field_max={128: fits}, **base))
    assert dec.tighten == [128]
    # measured waste under threshold → caps already fine
    dec = plan(TunerSnapshot(waste={kt: 1.1}, field_max={128: fits}, **base))
    assert dec.tighten == []
    # an observed need above a tight floor → tightening would break members
    toobig = {"park_cap": 20, "touch_cap": 50}
    dec = plan(TunerSnapshot(waste={kt: 2.0}, field_max={128: toobig},
                             **base))
    assert dec.tighten == []
    # already tightened → never re-ordered
    dec = plan(TunerSnapshot(waste={kt: 2.0}, field_max={128: fits},
                             tightened={128}, **base))
    assert dec.tighten == []


# ---------------------------------------------------------------------------
# the policy and the tight profile against the JAX package's functions
# ---------------------------------------------------------------------------

FIELDS = t_bucket.LADDER_FIELDS


def _random_snapshot(rng, S, B):
    """One seeded random snapshot built with the package's classes ``S``
    (TunerSnapshot) and ``B`` (BucketStats): plain-tuple keys, several
    widths, an optional byte budget, observed field maxima and
    tightened scales."""
    scales = [int(2 ** k) for k in rng.choice(np.arange(6, 16),
                                              size=rng.integers(1, 7),
                                              replace=False)]
    keys = [(e, int(rng.choice([1, 2, 4, 8]))) for e in scales]
    buckets, warmed, waste, pinned = {}, {}, {}, []
    for key in keys:
        mass = float(rng.choice([0.01, 0.3, rng.uniform(0, 20)]))
        flushes = {int(n): float(rng.uniform(0, 10))
                   for n in rng.integers(1, 21, size=rng.integers(0, 5))}
        buckets[key] = B(mass=mass, flushes=flushes)
        ws = [1] + [w for w in (2, 4, 8) if rng.random() < 0.4]
        warmed[key] = ws if rng.random() < 0.8 else []
        pinned += [(key, w) for w in warmed[key] if rng.random() < 0.3]
        if rng.random() < 0.8:
            waste[key] = float(rng.uniform(1.0, 3.0))
    field_max = {}
    for e in scales:
        if rng.random() < 0.7:
            field_max[e] = {f: int(rng.integers(0, e + 1))
                            for f in FIELDS if rng.random() < 0.8}
    budget = None if rng.random() < 0.3 else int(rng.integers(1, 10 ** 6))
    return S(buckets=buckets, warmed=warmed, pinned=pinned,
             bytes_used=int(rng.integers(0, 10 ** 6)), bytes_budget=budget,
             max_batch=int(rng.choice([1, 2, 4, 8])), waste=waste,
             field_max=field_max,
             tightened={e for e in scales if rng.random() < 0.2},
             slack=float(rng.choice([1.3, 2.0])))


def _decision(dec):
    return (list(dec.prewarm), list(dec.pin), list(dec.unpin),
            list(dec.evict), list(dec.tighten))


@pytest.mark.parametrize("chunk", range(4))
def test_plan_equals_the_reference_on_random_snapshots(chunk):
    """60 seeded random snapshots a chunk (240 in all), each planned by
    both packages under default and random ``TunerParams``: the same
    orders, priorities to the bit."""
    from repro.euler import autotune as j_autotune

    orders = 0
    for seed in range(chunk * 60, chunk * 60 + 60):
        mine = _random_snapshot(np.random.default_rng(seed), TunerSnapshot,
                                BucketStats)
        theirs = _random_snapshot(np.random.default_rng(seed),
                                  j_autotune.TunerSnapshot,
                                  j_autotune.BucketStats)
        rng = np.random.default_rng(10_000 + seed)
        knobs = dict(pin_budget=int(rng.integers(0, 6)),
                     max_prewarms=int(rng.integers(0, 6)),
                     tighten_waste=float(rng.uniform(1.0, 2.5)),
                     min_mass=float(rng.uniform(0.0, 1.0)))
        for p, jp in ((TunerParams(), j_autotune.TunerParams()),
                      (TunerParams(**knobs), j_autotune.TunerParams(**knobs))):
            dec, ref = plan(mine, p), j_autotune.plan(theirs, jp)
            assert isinstance(dec, Decision)
            assert _decision(dec) == _decision(ref), seed
            orders += sum(len(x) for x in _decision(dec))
    assert orders > 60       # the snapshots do order things


@pytest.mark.parametrize("max_batch", [1, 2, 4, 8])
def test_ladder_decompose_equals_the_reference(max_batch):
    from repro.euler.autotune import ladder_decompose as j_decompose

    for n in range(65):
        out = ladder_decompose(n, max_batch)
        assert out == j_decompose(n, max_batch), n
        assert sum(out) == n and all(1 <= w <= max_batch for w in out)
        assert out == sorted(out, reverse=True)


@pytest.mark.parametrize("slack", [1.3, 2.0])
@pytest.mark.parametrize("n_parts", [1, 2, 8])
def test_tight_floors_and_caps_equal_the_reference(n_parts, slack):
    """``ladder_floors``/``ladder_caps`` under both profiles for every
    bucket scale 64 … 2^22, against the JAX package's, on seeded random
    raw caps around the floors."""
    import dataclasses

    from repro.core.engine import EngineCaps as JCaps
    from repro.euler import bucket as j_bucket
    from repro_torch.core.engine import EngineCaps

    assert t_bucket.TIGHT_DIVISORS == j_bucket.TIGHT_DIVISORS
    assert t_bucket.LADDER_FIELDS == j_bucket.LADDER_FIELDS
    rng = np.random.default_rng(n_parts * 10 + int(slack * 10))
    for k in range(6, 23):
        e = 2 ** k
        for tight in (False, True):
            floors = t_bucket.ladder_floors(e, n_parts, slack=slack,
                                            tight=tight)
            assert floors == j_bucket.ladder_floors(e, n_parts, slack=slack,
                                                    tight=tight)
            for _ in range(3):
                raw = {f: int(rng.integers(0, 2 * floors[f] + 2))
                       for f in FIELDS}
                mine = t_bucket.ladder_caps(EngineCaps(**raw), e, n_parts,
                                            slack=slack, tight=tight)
                ref = j_bucket.ladder_caps(JCaps(**raw), e, n_parts,
                                           slack=slack, tight=tight)
                assert dataclasses.astuple(mine) == \
                    dataclasses.astuple(ref), (e, tight, raw)
        t = t_bucket.ladder_floors(e, n_parts, slack=slack, tight=True)
        d = t_bucket.ladder_floors(e, n_parts, slack=slack)
        assert all(t[f] <= d[f] for f in d)
        assert t["edge_cap"] == d["edge_cap"]


# ---------------------------------------------------------------------------
# AutoTuner: observations → decisions → applied orders (stand-in solver;
# tests/test_autotune.py:247-340)
# ---------------------------------------------------------------------------

class _TunerSolver(_SvcSolver):
    """Adds the snapshot/apply surface AutoTuner reads and writes.  Every
    graph lands in bucket ``K`` so the tuner's histogram key, the compile
    service's job key, and the warm set all line up like the real
    solver's ``bucket_of``."""

    def __init__(self):
        super().__init__()
        self.program_cache_bytes = None
        self.bucket_waste: dict = {}
        self.slack = 1.3
        self.pins: set = set()

    def bucket_of(self, graph):
        return K

    def pinned_programs(self):
        return sorted(self.pins, key=str)

    def cache_bytes_used(self):
        return 0

    def cap_observations(self, e_cap):
        return {}

    def tightened_scales(self):
        return []

    def pin_program(self, key, w):
        self.pins.add((key, w))
        return True

    def unpin_program(self, key, w):
        self.pins.discard((key, w))
        return True

    def drop_program(self, key, w):
        self.log.append(("drop", key, w))
        return True


def test_autotuner_step_orders_prewarms_from_observations():
    solver = _TunerSolver()
    svc = CompileService(solver, start=False)
    t = [0.0]
    tuner = AutoTuner(solver, service=svc, max_batch=4,
                      clock=lambda: t[0])
    g = "g-rep"
    for i in range(8):
        tuner.observe_arrival(K, g)
    tuner.observe_flush(K, 4)
    tuner.observe_flush(K, 4)
    dec = tuner.step()
    assert dec is not None and [(k, w) for k, w, _ in dec.prewarm] == [(K, 4)]
    # the rep graph was handed to the compile service
    assert svc.pending_jobs() == 1
    # rate limit: an immediate second step is skipped, force overrides
    assert tuner.step() is None
    assert tuner.step(force=True) is not None
    assert tuner.steps == 2
    svc.start()
    assert svc.join(timeout=30)
    assert solver.warmed_widths(K) == [4]
    # with B=4 warm the policy pins it; stats reflect the session
    t[0] = 1.0
    tuner.observe_flush(K, 4)
    dec = tuner.step()
    assert (K, 4) in dec.pin and (K, 4) in solver.pins
    st = tuner.stats()
    assert st["async_prewarms"] == 1 and st["tuner_buckets"] == 1
    assert st["pinned"] == 1 and st["prewarm_queue"] == 0
    tuner.close()


def test_autotuner_decay_forgets_cold_buckets():
    solver = _TunerSolver()
    svc = CompileService(solver, start=False)
    t = [0.0]
    tuner = AutoTuner(solver, service=svc, max_batch=4,
                      params=TunerParams(decay_tau=1.0, min_interval=0.0),
                      clock=lambda: t[0])
    tuner.observe_arrival(K, "g")
    tuner.observe_flush(K, 4)
    tuner.step()
    # still hot: the policy re-orders the prewarm (the service dedupes
    # the still-queued job, not the policy)
    assert tuner.step(force=True).prewarm
    t[0] = 20.0                            # 20 time constants later
    dec = tuner.step()
    assert dec is not None and dec.prewarm == []   # mass decayed below floor
    tuner.close()


def test_autotuner_keeps_at_most_max_buckets():
    """Past ``MAX_BUCKETS`` tracked buckets the decay drops the coldest
    (and their representative graphs)."""
    solver = _TunerSolver()
    svc = CompileService(solver, start=False)
    t = [0.0]
    tuner = AutoTuner(solver, service=svc, clock=lambda: t[0],
                      params=TunerParams(min_interval=0.0))
    n = AutoTuner.MAX_BUCKETS + 6
    for i in range(n):
        for _ in range(i + 1):
            tuner.observe_arrival((64 * (i + 1), 8), f"g{i}")
    tuner.step()
    t[0] = 1.0
    tuner.step()
    assert tuner.stats()["tuner_buckets"] == AutoTuner.MAX_BUCKETS
    kept = set(tuner._buckets)
    assert (64, 8) not in kept and (64 * n, 8) in kept
    assert set(tuner._rep) == kept
    tuner.close()


# ---------------------------------------------------------------------------
# the feedback rung on the real session (tests/test_autotune.py:369)
# ---------------------------------------------------------------------------

def test_tighten_is_one_way_and_rekey_purges_scale():
    solver = EulerSolver(n_parts=1, device="cpu")
    assert solver.tightened_scales() == []
    assert solver.tighten(256)
    assert not solver.tighten(256)                  # idempotent
    assert solver.tightened_scales() == [256]
    assert solver.rekey(256) == 0                   # nothing memoized yet
    # memoized graphs of the scale are purged, others kept
    a, b = (eulerian_rmat(5, avg_degree=4, seed=1),
            eulerian_rmat(6, avg_degree=4, seed=2))
    ka, kb = solver.bucket_of(a), solver.bucket_of(b)
    assert ka[0] != kb[0]
    assert solver.rekey(ka[0]) == 1 and solver.rekey(ka[0]) == 0
    assert solver.bucket_of(b) is kb                # still memoized


def test_cap_observations_are_the_raw_maxima():
    """``_prepare`` keeps, per bucket scale, the largest raw
    (``size_caps``) need seen per ladder field; the bucket's caps cover
    each."""
    from repro_torch.core.engine import Engine

    solver = EulerSolver(n_parts=2, device="cpu")
    graphs = [eulerian_rmat(6, avg_degree=5, seed=s) for s in range(6)]
    keys = [solver.bucket_of(g) for g in graphs]
    e = keys[0][0]
    want = {}
    for g, key in zip(graphs, keys):
        if key[0] != e:
            continue
        pg = solver._prepare(g, None)[0]
        raw = Engine.size_caps(pg, slack=solver.slack)
        for f in FIELDS:
            want[f] = max(want.get(f, 0), int(getattr(raw, f)))
            assert getattr(key[3], f) >= getattr(raw, f)
    assert solver.cap_observations(e) == want
    assert solver.cap_observations(3) == {}


# ---------------------------------------------------------------------------
# MicroBatcher: mid-session width upgrade (tests/test_autotune.py:382)
# ---------------------------------------------------------------------------

def test_micro_batcher_upgrades_flush_width_when_prewarm_lands():
    from test_torch_serve import _Clock, _FakeSolver

    class _Obs:
        def __init__(self):
            self.arrivals: list = []
            self.flushes: list = []

        def observe_arrival(self, key, graph=None):
            self.arrivals.append(key)

        def observe_flush(self, key, n):
            self.flushes.append((key, n))

    solver = _FakeSolver()          # warmed = [] → only B=1 available
    obs = _Obs()
    clock = _Clock()
    mb = MicroBatcher(solver, max_batch=4, deadline_s=0.010, clock=clock,
                      autotuner=obs)
    v = np.arange(4, dtype=np.int64)
    graphs = [Graph(4, v, np.roll(v, -1)) for _ in range(8)]

    for i in range(4):
        mb.submit(i, graphs[i])     # quota flush, nothing warm → 4× B=1
    assert list(mb.flushes.recent) == [1, 1, 1, 1]
    # "async prewarm lands": the warm set grows mid-session…
    solver.warmed = [4]
    for i in range(4, 8):
        mb.submit(i, graphs[i])
    # …and the very next quota flush upgrades to one B=4 dispatch
    assert list(mb.flushes.recent) == [1, 1, 1, 1, 4]
    # the batcher fed the tuner every arrival and both flush sizes
    assert len(obs.arrivals) == 8
    assert obs.flushes == [(4, 4), (4, 4)]


# ---------------------------------------------------------------------------
# the adaptive session against the JAX package's bytes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference():
    with np.load(GOLDEN) as z:
        return dict(z)


def _modal_group(solver):
    buckets = {}
    for s in range(CANDIDATES):
        g = eulerian_rmat(SCALE, avg_degree=5, seed=s)
        buckets.setdefault(solver.bucket_of(g), []).append((s, g))
    key, group = max(buckets.items(), key=lambda kv: len(kv[1]))
    return key, group[:GROUP]


def _same(res, reference, name) -> bool:
    return (np.array_equal(res.circuit, reference[f"{name}/circuit"])
            and np.array_equal(res.mate, reference[f"{name}/mate"]))


def test_autotune_golden_is_the_jax_output(reference, tmp_path):
    """One case of the golden file (member 0 solved in a session whose
    scale was tightened first) solved again by the JAX package."""
    out = tmp_path / "live.npz"
    jax_reference(out, default=[], tight=[0])
    with np.load(out) as z:
        live = dict(z)
    assert set(live) == {"seeds", "e_cap", "tight_0/circuit",
                         "tight_0/mate", "tight_0/park_cap"}
    for k, v in live.items():
        np.testing.assert_array_equal(v, reference[k])
    assert set(reference) == {"seeds", "e_cap"} | {
        f"{p}_{i}/{k}" for p in ("default", "tight") for i in range(GROUP)
        for k in ("circuit", "mate")} | {
        f"tight_{i}/park_cap" for i in range(GROUP)}


def test_adaptive_session_upgrades_and_stays_byte_equal(reference):
    """The reference's adaptive session on the port: two B=1 flushes
    from a cold session, a tuner step that orders exactly ``(key, 2)``
    onto the compile thread, a B=2 flush once it is warm, then a retune
    job, ``tighten`` + ``rekey`` and a tight solve, each result the JAX
    package's bytes.  ``submit``'s results are collected as well as
    ``drain()``'s."""
    solver = EulerSolver(n_parts=PARTS, device="cpu")
    key, group = _modal_group(solver)
    assert [s for s, _ in group] == reference["seeds"].tolist()
    assert key[0] == int(reference["e_cap"])
    group = [g for _, g in group]

    tuner = AutoTuner(solver, max_batch=2,
                      params=TunerParams(min_interval=0.0))
    mb = MicroBatcher(solver, max_batch=2, deadline_s=0.0,
                      autotuner=tuner)
    done = {}
    for i in (0, 1):
        done.update(mb.submit(i, group[i]))
    assert sorted(done) == [0, 1]         # the quota flush, from submit
    done.update(mb.drain())
    assert list(mb.flushes.recent) == [1, 1], mb.flushes.hist
    dec = tuner.step(force=True)
    assert [(k, w) for k, w, _ in dec.prewarm] == [(key, 2)], dec
    assert tuner.service.join(timeout=600)
    assert solver.warmed_widths(key) == [1, 2]
    assert tuner.service.prewarms == 1

    for i in (2, 3):
        done.update(mb.submit(i, group[i]))
    done.update(mb.drain())
    assert list(mb.flushes.recent) == [1, 1, 2], mb.flushes.hist
    assert sorted(done) == [0, 1, 2, 3]
    assert done[2].cache.batch == 2
    for i in range(GROUP):
        assert _same(done[i].validate(), reference, f"default_{i}"), i

    # the audit accepts the adaptive program set as-is
    rep = audit_graph(solver, group[0], widths="warmed")
    assert rep["ok"], rep
    assert set(rep["cache_budget"]["per_program_bytes"]) == {"B1", "B2"}
    assert rep["cache_budget"]["total_bytes"] > 0

    e_cap = key[0]
    tk = tuner.service.submit_retune(group[0], e_cap, [2])
    assert tk.wait(timeout=600) and tk.error is None, tk.error
    assert tk.widths == []                # still the default profile: warm
    assert solver.tighten(e_cap)
    # the retune job's rekey purged every memo of the scale; its
    # prewarm prepared member 0 again
    assert solver.rekey(e_cap) == 1
    tight = solver.solve(group[0]).validate()
    tkey = tight.cache.bucket
    assert tkey != key and tkey[0] == e_cap
    assert tkey[3].park_cap <= key[3].park_cap
    assert tkey[3].park_cap == int(reference["tight_0/park_cap"])
    assert _same(tight, reference, "tight_0")
    assert _same(tight, reference, "default_0")
    tuner.close()
    assert not tuner.service._thread.is_alive()
    assert solver.compile_service is tuner.service


def test_retune_in_apply_order_records_the_tight_bucket(reference):
    """``AutoTuner._apply``'s order: ``tighten`` first, then a retune job
    records the tight bucket's B=1 and B=2 on the compile thread; the
    pool then re-buckets under tight caps (a new engine: no table of the
    old bucket is reused), and every member's tight solve, one at a time
    and the replicated pair through the recorded B=2 program, is the JAX
    package's bytes.  A dispatch staged under the old key before the
    rekey still delivers."""
    solver = EulerSolver(n_parts=PARTS, device="cpu")
    key, group = _modal_group(solver)
    group = [g for _, g in group]
    solver.prewarm(group[0], widths=(1,))
    old_engine = solver._engines[key]
    staged = solver.solve_async(group[1])
    e_cap = key[0]
    assert solver.tighten(e_cap) and solver.tightened_scales() == [e_cap]
    svc = solver._ensure_compile_service()
    tk = svc.submit_retune(group[0], e_cap, [2])
    assert tk.wait(timeout=600) and tk.error is None, tk.error
    assert tk.widths == [1, 2]
    tkey = solver.bucket_of(group[0])
    assert tkey != key and solver.warmed_widths(tkey) == [1, 2]
    assert solver._engines[tkey] is not old_engine
    assert _same(staged.result().validate(), reference, "default_1")
    for i, g in enumerate(group):
        assert _same(solver.solve(g).validate(), reference, f"tight_{i}"), i
    hits = solver.cache_stats.hits
    for r in solver.solve_batch([group[0]] * 2):
        assert _same(r.validate(), reference, "tight_0")
    assert solver.cache_stats.hits == hits + 1
    assert [solver.bucket_of(g)[3].park_cap for g in group] == \
        [int(reference[f"tight_{i}/park_cap"]) for i in range(GROUP)]
    svc.stop()
    assert solver.compile_service is svc and not svc._thread.is_alive()


def test_prewarm_async_records_on_the_compile_thread():
    """``prewarm_async`` queues one job a width on the session's compile
    service (made at first use), each recorded by that thread; a live
    width's ticket is finished at once."""
    solver = EulerSolver(n_parts=1, device="cpu")
    assert solver.compile_service is None
    g = eulerian_rmat(5, avg_degree=4, seed=1)
    key = solver.bucket_of(g)
    threads = []
    prewarm = EulerSolver.prewarm

    def seen(self, graph, widths=None):
        threads.append(threading.current_thread().name)
        return prewarm(self, graph, widths)

    solver.prewarm = seen.__get__(solver)
    tickets = solver.prewarm_async(g, widths=(2, 1))
    assert len(tickets) == 2
    for t in tickets:
        assert t.wait(timeout=120) and t.error is None
    assert sorted(w for t in tickets for w in t.widths) == [1, 2]
    assert set(threads) == {"compile-service"}
    assert solver.warmed_widths(key) == [1, 2]
    assert solver.cache_stats.prewarms == 2
    again = solver.prewarm_async(g, widths=(1, 2))
    assert all(t.done() and t.widths == [] for t in again)
    svc = solver.compile_service
    assert svc.prewarms == 2 and svc is solver._ensure_compile_service()
    svc.stop()


# ---------------------------------------------------------------------------
# dropping a program that a launch holds (the tuner's drop_program on the
# serving thread while the compile thread records)
# ---------------------------------------------------------------------------

def _fresh(g):
    return EulerSolver(n_parts=1, device="cpu").solve(g).validate()


def test_drop_while_recording_defers_the_free(monkeypatch):
    """A drop of a program whose launch (a recording on a card) holds the
    run in another thread returns at once: the run leaves the LRU and the
    engine, and the launch's fetch frees it; the result is the fresh
    solve's bytes."""
    solver = EulerSolver(n_parts=1, device="cpu")
    g = eulerian_rmat(5, avg_degree=4, seed=1)
    key = solver.bucket_of(g)
    entered, go = threading.Event(), threading.Event()
    launch_cpu = FusedRun._launch_cpu

    def held(self, *args):
        entered.set()
        assert go.wait(60)
        return launch_cpu(self, *args)

    monkeypatch.setattr(FusedRun, "_launch_cpu", held)
    box = {}
    # thread-contract: joined below
    t = threading.Thread(target=lambda: box.update(res=solver.solve(g)),
                         daemon=True)
    t.start()
    assert entered.wait(60)
    eng = solver._engines[key]
    run = eng._fused[(key[0], None)]
    dropped = {}
    # thread-contract: joined below (a drop that waited for the launch
    # would still be alive after the timeout)
    d = threading.Thread(
        target=lambda: dropped.update(ok=solver.drop_program(key, 1)),
        daemon=True)
    d.start()
    d.join(10)
    alive = d.is_alive()
    go.set()
    t.join(60)
    d.join(60)
    assert not alive and dropped["ok"]
    assert run.retired and (key[0], None) not in eng._fused
    assert solver.warmed_widths(key) == []
    res = box["res"].validate()
    assert run.inputs is None and run.out is None      # freed by the fetch
    fresh = _fresh(g)
    assert np.array_equal(res.circuit, fresh.circuit)
    assert np.array_equal(res.mate, fresh.mate)
    # the next solve makes a new program
    again = solver.solve(g).validate()
    assert not again.cache.hit and eng._fused[(key[0], None)] is not run


def test_drop_between_staging_and_launch_frees_after_fetch(monkeypatch):
    """A program dropped after a solve staged for it but before the
    launch: the launch still runs (on a card it records again), and its
    fetch frees the run the engine no longer lists."""
    solver = EulerSolver(n_parts=1, device="cpu")
    g = eulerian_rmat(5, avg_degree=4, seed=2)
    key = solver.bucket_of(g)
    launch = FusedRun.launch
    runs = []

    def dropped_first(self, *args):
        if not runs:            # the session's first launch only
            runs.append(self)
            assert solver.drop_program(key, 1) and self.retired
        return launch(self, *args)

    monkeypatch.setattr(FusedRun, "launch", dropped_first)
    res = solver.solve(g).validate()
    run = runs[0]
    assert run.inputs is None and run.out is None and run.graph is None
    assert (key[0], None) not in solver._engines[key]._fused
    fresh = _fresh(g)
    assert np.array_equal(res.circuit, fresh.circuit)
    assert np.array_equal(res.mate, fresh.mate)



@pytest.mark.gpu
def test_cuda_drop_during_a_recording_waits_for_nothing(monkeypatch):
    """On a card: a drop of the program another thread is recording (the
    recording holds the card gate alone) returns without touching the
    card; the recording's fetch frees the graph and its pools, and the
    result is the CPU's bytes."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: a recording needs the card")
    solver = EulerSolver(n_parts=8)
    g = eulerian_rmat(9, avg_degree=5, seed=0)
    key = solver.bucket_of(g)
    entered, go = threading.Event(), threading.Event()
    capture_ = FusedRun._capture

    def held(self):
        entered.set()
        assert go.wait(120)
        return capture_(self)

    monkeypatch.setattr(FusedRun, "_capture", held)
    box = {}
    # thread-contract: joined below
    t = threading.Thread(target=lambda: box.update(res=solver.solve(g)),
                         daemon=True)
    t.start()
    assert entered.wait(120)
    run = solver._engines[key]._fused[(key[0], None)]
    dropped = {}
    # thread-contract: joined below (a drop that waited for the card gate
    # would still be alive after the timeout)
    d = threading.Thread(
        target=lambda: dropped.update(ok=solver.drop_program(key, 1)),
        daemon=True)
    d.start()
    d.join(10)
    alive = d.is_alive()
    go.set()
    t.join(300)
    d.join(60)
    assert not alive and dropped["ok"] and run.retired
    res = box["res"].validate()
    assert run.graph is None and run.inputs is None
    cpu = EulerSolver(n_parts=8, device="cpu").solve(g)
    assert np.array_equal(res.circuit, cpu.circuit)
    assert np.array_equal(res.mate, cpu.mate)
    torch.cuda.synchronize()
    assert solver._engines[key].reserved_bytes() == 0


if __name__ == "__main__":
    jax_reference(GOLDEN)
