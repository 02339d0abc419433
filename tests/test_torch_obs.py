"""The port's observability layer (``repro_torch.obs``, a copy of
``repro/obs``) against the JAX package's: the same operations under a
fake clock give the same Prometheus text and the same snapshot, and the
solver sessions of both packages emit the same spans, in the same tree,
for a fused and an eager solve, and count the same ``CacheStats`` over
one sequence of solves.  ``repro.obs`` is stdlib only, so the parity
cases run in this process; the solves' reference runs on one simulated
device here."""
import json
import threading
import urllib.error
import urllib.request

import pytest
import torch

import repro.obs as j_obs
import repro_torch.obs as t_obs
from repro_torch.euler import EulerSolver
from repro_torch.graphgen.eulerize import eulerian_rmat


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU solves here are small (scale 5–8): one intra-op
    thread runs them fastest and keeps them from contending with the
    suite's other workers; the setting is restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _counters(obs):
    reg = obs.Registry(clock=lambda: 0.0)
    hits = reg.counter("euler_cache_hits", "program-cache hits")
    for s, n in (("s0", 7), ("s1", 2), ("s0", 1)):
        hits.labels(session=s).inc(n)
    reg.counter("plain").inc()
    g = reg.gauge("euler_cache_bytes", "reserved bytes")
    g.labels(session="s0").set(512)
    g.labels(session="s0").add(-12.5)
    g.set(3)
    return reg, None


def _histograms(obs):
    reg = obs.Registry(clock=lambda: 0.0)
    h = reg.histogram("euler_flush_width", "widths", lo_exp=0, hi_exp=3)
    for w in (1, 2, 2, 8, 100):
        h.labels(session="s0").observe(w)
    c = reg.histogram("euler_compile_seconds", "compiles", lo_exp=-10,
                      hi_exp=10)
    for v in (0.0, 1e-4, 0.41, 3.9, 2e3):
        c.labels(session="s1").observe(v)
    assert h.labels(session="s0").percentile(0.5) > 0
    return reg, None


def _spans(obs):
    t = [0.0]
    reg = obs.Registry(clock=lambda: t[0])
    h = reg.histogram("euler_compile_seconds", "compiles", lo_exp=-4,
                      hi_exp=4)
    log = obs.TraceLog(capacity=4, clock=lambda: t[0])
    with log.span("stage", resident=True) as sp:
        t[0] = 1.0
        with log.span("upload", edges=256):
            t[0] = 1.5
        sp.set(edges=256)
    with log.span("launch", metric=h.labels(session="s0"), bucket=256,
                  width=1, hit=False):
        log.event("retrace", program="fused", edges=256, batch=None)
        t[0] = 4.0
    with log.span("fetch", bucket=256, width=1):
        with log.span("wait", width=1):
            t[0] = 4.25
    return reg, log


def _errors(obs):
    t = [0.0]
    reg = obs.Registry(clock=lambda: t[0])
    h = reg.histogram("dur", "span durations", lo_exp=-4, hi_exp=4)
    log = obs.TraceLog(clock=lambda: t[0])
    with pytest.raises(RuntimeError):
        with log.span("compile", metric=h):
            t[0] = 2.0
            raise RuntimeError("boom")
    with obs.NullTraceLog().span("ignored", metric=h):
        pass
    with pytest.raises(ValueError):
        reg.gauge("dur")
    return reg, log


SCENARIOS = {"counters": _counters, "histograms": _histograms,
             "spans": _spans, "errors": _errors}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_same_text_and_snapshot_as_reference(name):
    ours, theirs = SCENARIOS[name](t_obs), SCENARIOS[name](j_obs)
    assert t_obs.render_prometheus(ours[0]) == \
        j_obs.render_prometheus(theirs[0])
    assert t_obs.snapshot(*ours) == j_obs.snapshot(*theirs)
    json.dumps(t_obs.snapshot(*ours), default=str)


def test_process_defaults_are_the_ports_own():
    assert t_obs.default_registry() is t_obs.default_registry()
    assert t_obs.default_tracelog() is t_obs.default_tracelog()
    assert t_obs.default_registry() is not j_obs.default_registry()
    assert t_obs.default_tracelog() is not j_obs.default_tracelog()


def test_jsonl_sink(tmp_path):
    path = tmp_path / "spans.jsonl"
    log = t_obs.TraceLog(clock=lambda: 0.0, sink=str(path))
    with log.span("a", k=1):
        log.event("b")
    log.close()
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [rec["name"] for rec in lines] == ["b", "a"]
    assert lines[0]["parent"] == lines[1]["id"]


def test_span_parentage_never_crosses_threads():
    log = t_obs.TraceLog(clock=lambda: 0.0)
    opened, done = threading.Event(), threading.Event()

    def other():
        opened.wait(5)
        with log.span("worker"):
            pass
        done.set()

    # thread-contract: joined below before the test returns
    th = threading.Thread(target=other, daemon=True)
    th.start()
    with log.span("main"):
        opened.set()
        done.wait(5)
    th.join(5)
    by = {s["name"]: s for s in log.spans()}
    assert by["worker"]["parent"] is None and by["main"]["parent"] is None


def test_metrics_server_endpoints():
    reg, log = _counters(t_obs)[0], t_obs.TraceLog(clock=lambda: 0.0)
    log.event("probe")
    srv = t_obs.MetricsServer(reg, port=0, trace=log)
    try:
        with urllib.request.urlopen(srv.url + "/metrics", timeout=10) as r:
            text = r.read().decode()
        assert 'euler_cache_hits{session="s0"} 8' in text
        with urllib.request.urlopen(srv.url + "/metrics.json",
                                    timeout=10) as r:
            snap = json.loads(r.read().decode())
        assert [s["name"] for s in snap["spans"]] == ["probe"]
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(srv.url + "/nope", timeout=10)
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# the sessions' spans and counts against the reference's
# ---------------------------------------------------------------------------

def _tree(log):
    """``(name, parent's name, sorted attribute names)`` of every span,
    in closing order."""
    spans = log.spans()
    names = {s["id"]: s["name"] for s in spans}
    return [(s["name"], names.get(s["parent"]), sorted(s.get("attrs", {})))
            for s in spans]


#: (graph, fused) in order: two buckets under program_cache_max=1, so
#: evictions, re-recordings and eager solves of evicted programs all occur
SEQUENCE = [("a", True), ("a", True), ("a", False), ("b", True),
            ("a", False), ("a", True), ("b", True)]


def _session(EulerSolver, graphs, log, reg, **opts):
    solver = EulerSolver(n_parts=1, program_cache_max=1, registry=reg,
                         trace=log, **opts)
    trees, stats = [], []
    for name, fused in SEQUENCE:
        log.clear()
        res = solver.solve(graphs[name], fused=fused).validate()
        trees.append(_tree(log))
        stats.append((res.cache.hit, res.cache.hits, res.cache.misses,
                      res.cache.traces, res.cache.evictions,
                      res.cache.state_uploads))
    return trees, stats, res


def test_session_spans_and_counts_match_reference():
    """The same sequence of fused and eager solves over two buckets on
    both packages (one partition; the reference on one device): each
    solve's span tree (``stage``/``upload``, ``launch``/``retrace``,
    ``fetch``/``wait``; ``solve_eager``) and its ``CacheStats`` are the
    same, and the port's registry renders the reference's families."""
    from repro.euler import EulerSolver as JSolver
    from repro.graphgen.eulerize import eulerian_rmat as j_eulerian_rmat

    seeds = {"a": (5, 1), "b": (6, 2)}
    ours = _session(
        lambda **kw: EulerSolver(device="cpu", **kw),
        {k: eulerian_rmat(s, avg_degree=4, seed=d)
         for k, (s, d) in seeds.items()},
        t_obs.TraceLog(), t_obs.Registry())
    jreg = j_obs.Registry()
    theirs = _session(
        JSolver, {k: j_eulerian_rmat(s, avg_degree=4, seed=d)
                  for k, (s, d) in seeds.items()},
        j_obs.TraceLog(), jreg)
    assert ours[0] == theirs[0]
    assert ours[1] == theirs[1]
    assert ours[1][-1] == (False, 3, 4, 5, 3, 2)
    assert ours[2].circuit.tolist() == theirs[2].circuit.tolist()
    fams = {f.name: f.kind for f in jreg.families()}
    reg = t_obs.Registry()
    EulerSolver(n_parts=1, device="cpu", registry=reg)
    assert {f.name: f.kind for f in reg.families()} == fams


def test_timed_probe_spans_match_reference():
    """``timed_probe=True``: one ``level`` span a level on the eager path,
    the first holding the superstep's ``retrace``, as in the reference."""
    from repro.euler import EulerSolver as JSolver
    from repro.graphgen.eulerize import eulerian_rmat as j_eulerian_rmat

    trees = []
    for make, gen, obs in (
            (lambda **kw: EulerSolver(device="cpu", **kw), eulerian_rmat,
             t_obs),
            (JSolver, j_eulerian_rmat, j_obs)):
        log = obs.TraceLog()
        solver = make(n_parts=1, fused=False, timed_probe=True, trace=log,
                      registry=obs.Registry())
        res = solver.solve(gen(5, avg_degree=4, seed=3)).validate()
        trees.append(_tree(log))
    assert trees[0] == trees[1]
    assert [t[0] for t in trees[0]].count("level") == res.supersteps


def _async_session(EulerSolver, graphs, log, reg):
    """Three dispatches (two of bucket ``a``, then ``b``, which evicts
    ``a``'s program under ``program_cache_max=1`` while both of ``a``'s
    are pending), fetched out of order; the span tree of the whole
    sequence and each result's ``CacheStats``."""
    solver = EulerSolver(n_parts=1, program_cache_max=1, registry=reg,
                         trace=log)
    log.clear()
    pending = {name: solver.solve_async(graphs[name[0]])
               for name in ("a1", "a2", "b")}
    stats = {}
    for name in ("b", "a1", "a2"):
        res = pending[name].result().validate()
        stats[name] = (res.cache.hit, res.cache.hits, res.cache.misses,
                       res.cache.traces, res.cache.evictions,
                       res.cache.state_uploads)
    return _tree(log), stats


def test_async_spans_and_counts_match_reference():
    """``solve_async`` dispatches and out-of-order ``result()``s on both
    packages (one partition; the reference on one device): the same span
    tree (``stage``/``upload``, ``launch``/``retrace``, ``fetch``/``wait``)
    and the same ``CacheStats``, stamped at fetch time."""
    from repro.euler import EulerSolver as JSolver
    from repro.graphgen.eulerize import eulerian_rmat as j_eulerian_rmat

    seeds = {"a": (5, 1), "b": (6, 2)}
    ours = _async_session(
        lambda **kw: EulerSolver(device="cpu", **kw),
        {k: eulerian_rmat(s, avg_degree=4, seed=d)
         for k, (s, d) in seeds.items()},
        t_obs.TraceLog(), t_obs.Registry())
    theirs = _async_session(
        JSolver, {k: j_eulerian_rmat(s, avg_degree=4, seed=d)
                  for k, (s, d) in seeds.items()},
        j_obs.TraceLog(), j_obs.Registry())
    assert ours == theirs
    names = [t[0] for t in ours[0]]
    assert names.count("fetch") == names.count("wait") == 3
    assert ours[1]["a1"] == (False, 1, 2, 2, 1, 2)


def _batch_session(EulerSolver, graphs, log, reg):
    """A one-graph solve of ``a``, then ``solve_batch([a, a2])`` twice (a
    miss that uploads the stacked batch and records, then a hit), then a
    batched dispatch and a one-graph dispatch fetched in reverse order:
    the span tree of each step and each result's ``CacheStats``."""
    solver = EulerSolver(n_parts=1, registry=reg, trace=log)
    a, a2 = graphs["a"], graphs["a2"]
    trees, stats = [], []

    def step(results):
        trees.append(_tree(log))
        stats.append([(r.cache.hit, r.cache.batch, r.cache.hits,
                       r.cache.misses, r.cache.traces, r.cache.evictions,
                       r.cache.state_uploads) for r in results])
        log.clear()

    log.clear()
    step([solver.solve(a).validate()])
    step([r.validate() for r in solver.solve_batch([a, a2])])
    step([r.validate() for r in solver.solve_batch([a, a2])])
    batched = solver.solve_batch_async([a2, a])
    single = solver.solve_async(a2)
    got = [single.result()] + batched.results()
    step([r.validate() for r in got])
    return trees, stats, got


def test_batch_spans_and_counts_match_reference():
    """Batched solves on both packages (one partition; the reference on
    one device): the same span trees (``upload`` of width B, ``launch``/
    ``retrace`` with the batch, ``fetch``/``wait``) and ``CacheStats``
    (``batch`` included), and the same bytes."""
    from repro.euler import EulerSolver as JSolver
    from repro.graphgen.eulerize import eulerian_rmat as j_eulerian_rmat

    seeds = {"a": 1, "a2": 1}
    ours = _batch_session(
        lambda **kw: EulerSolver(device="cpu", **kw),
        {k: eulerian_rmat(5, avg_degree=4, seed=d) for k, d in seeds.items()},
        t_obs.TraceLog(), t_obs.Registry())
    theirs = _batch_session(
        JSolver, {k: j_eulerian_rmat(5, avg_degree=4, seed=d)
                  for k, d in seeds.items()},
        j_obs.TraceLog(), j_obs.Registry())
    assert ours[0] == theirs[0]
    assert ours[1] == theirs[1]
    assert ours[1][1] == [(False, 2, 0, 2, 2, 0, 2)] * 2
    # the new composition [a2, a] uploads its stack, and a2 alone its
    # own state
    assert ours[1][-1] == [(True, 1, 3, 2, 2, 0, 4)] + \
        [(True, 2, 3, 2, 2, 0, 4)] * 2
    for mine, ref in zip(ours[2], theirs[2]):
        assert mine.circuit.tolist() == ref.circuit.tolist()
    names = [t[0] for t in ours[0][1]]
    assert names.count("upload") == 1 and names.count("retrace") == 1
