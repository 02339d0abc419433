"""The paper's Euler cells and the production mesh on the port:
``configs/euler_rmat.py``, ``parallel/sharding.py``, the Euler half of
``launch/steps.py::build_cell``, ``launch/mesh.py``'s production and test
meshes, ``launch/dryrun.py`` and ``parallel/overlap.py``, against the
JAX package.

* The cells: the reduced config (``euler-smoke``) on seeded Eulerian RMAT
  graphs whose 8 partitions fit its caps (every flag holds).  The
  reference builds its cells with ``build_cell`` on an 8-device
  ``make_part_mesh(8)`` in a subprocess of its own and runs each level's
  ``superstep`` and the ``fused`` run; the port builds them over gloo
  worlds of 1, 2 and 4 ranks (``make_part_mesh(8, device="cpu")``, each
  rank a process of its own with its own time limit), and every field of
  every rank's output must equal the reference's rows of that rank:
  states, logs, flags and metrics of each level, the circuit, mate, flags,
  metrics and Phase 3 flag of the fused run.  World 4 also builds the
  superstep cell on the ``(2, 2)`` test mesh (one partition a rank),
  held to the one-device engine.
* The specs: every spec function's tree for every registered arch,
  reduced and full, on the test mesh ``(4, 2)`` and both production
  meshes, entry for entry: the port on worlds of torch's ``fake``
  backend, the reference on forced CPU devices in a subprocess.
* ``grad_accum_scan`` against the reference's on the reduced SmolLM.
* The dry run on fake worlds of 256 and 512 ranks on the CPU: the
  reduced config's cells and one rank of the full ``superstep`` cell.
"""
import argparse
import dataclasses
import datetime
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.analysis.graph_audit import engine_state_bytes
from repro_torch.configs import registry
from repro_torch.core.engine import Engine, EngineState, state_from_numpy
from repro_torch.core.engine import stub_vertex
from repro_torch.core.graph import partition_graph
from repro_torch.graphgen.eulerize import eulerian_rmat
from repro_torch.graphgen.partition import partition_vertices
from repro_torch.launch import dryrun, mesh as mesh_mod, steps
from repro_torch.parallel import sharding as shd
from repro_torch.tree import leaves_with_paths

SRC = str(Path(__file__).resolve().parents[1] / "src")
WORLDS = (1, 2, 4)
P = 8
#: (scale, seed) of the cells' graphs: at P = 8 (and the test mesh's P =
#: 4 for the first) every euler-smoke cap holds, as the flags show
GRAPHS = ((6, 0), (6, 2))
#: each spawned process's time limit, about four times what the slowest
#: took on a shared 8-core CPU; the gloo groups' own timeout
LIVE_TIMEOUT = 200
GROUP_TIMEOUT = 60
#: the production and test meshes: name → (world, factory keywords)
MESHES = {"test": (8, {"tp": 2}), "single_pod": (256, {}),
          "multi_pod": (512, {"multi_pod": True})}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread for the in-process work (as the other port test
    files): with a thread a core, the suite's workers oversubscribe the
    cores; restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def smoke():
    return registry.get_config("euler-rmat", reduced=True)


def inputs(scale, seed, n_parts):
    """(graph, state, anc, sv) numpy: the loaded tables, the ancestor
    table padded to the cell's ``n_levels`` rows (its ladder rule: the
    last row repeated), the stub-vertex map padded to ``2 · fused_edges``
    with vertex 0 (the reference's pad; those stubs stay unmated)."""
    cfg = smoke().model
    g = eulerian_rmat(scale, avg_degree=4, seed=seed)
    pg = partition_graph(g, partition_vertices(g, n_parts, seed=0))
    state, anc = Engine(n_parts, cfg.caps, cfg.n_levels).load(pg)
    anc = np.concatenate([anc, np.repeat(anc[-1:], cfg.n_levels
                                         - anc.shape[0], 0)])
    sv = np.zeros(2 * cfg.fused_edges, np.int32)
    sv[:2 * g.num_edges] = stub_vertex(pg)
    return g, state, anc.astype(np.int32), sv


def write_inputs(path):
    arrays = {}
    for scale, seed in GRAPHS:
        g, state, anc, sv = inputs(scale, seed, P)
        key = f"{scale}_{seed}"
        arrays.update({f"{key}/{f}": getattr(state, f)
                       for f in EngineState._fields})
        arrays[f"{key}/anc"], arrays[f"{key}/sv"] = anc, sv
    np.savez(path, **arrays)


STEP_FIELDS = [f"state.{f}" for f in EngineState._fields] + \
    ["log_s1", "log_s2", "log_mask", "flags", "metrics"]
FUSED_FIELDS = ["circuit", "mate", "flags", "metrics", "phase3_ok"]

REFERENCE_CELLS = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
from repro.configs.registry import get_config
from repro.core.engine import EngineState
from repro.launch.mesh import make_part_mesh
from repro.launch.steps import build_cell

data = np.load(sys.argv[1])
arch = get_config("euler-rmat", reduced=True)
mesh = make_part_mesh({P})
fns = {{}}
for shape in ("superstep", "fused"):
    cell = build_cell(arch, shape, mesh)
    fns[shape] = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                         out_shardings=cell.out_shardings)
out = {{}}
for key in {keys}:
    state0 = EngineState(*(jnp.asarray(data[f"{{key}}/{{f}}"])
                           for f in EngineState._fields))
    anc, sv = jnp.asarray(data[f"{{key}}/anc"]), jnp.asarray(data[f"{{key}}/sv"])
    state = state0
    for lvl in range(arch.model.n_levels):
        o = fns["superstep"](jnp.int32(lvl), anc, state)
        for f in EngineState._fields:
            out[f"{{key}}/{{lvl}}/state.{{f}}"] = np.asarray(getattr(o.state, f))
        for f in ("log_s1", "log_s2", "log_mask", "flags", "metrics"):
            out[f"{{key}}/{{lvl}}/{{f}}"] = np.asarray(getattr(o, f))
        state = o.state
    o = fns["fused"](anc, state0, sv)
    for f in o._fields:
        out[f"{{key}}/fused/{{f}}"] = np.asarray(getattr(o, f))
for reduced in (False, True):
    for shape in ("superstep", "fused"):
        out[f"flops/{{reduced}}/{{shape}}"] = np.float64(build_cell(
            get_config("euler-rmat", reduced=reduced), shape,
            mesh).model_flops)
np.savez(sys.argv[2], **out)
"""

REFERENCE_SPECS = """
import json
import sys
import jax
from jax.sharding import PartitionSpec
from repro.configs.registry import ARCH_IDS, get_config
from repro.launch import steps
from repro.launch.mesh import flat_axes, make_production_mesh, make_test_mesh
from repro.models import gnn as gnn_mod
from repro.models.equivariant import init_nequip_params
from repro.models.recsys import init_autoint_params
from repro.models.transformer import abstract_lm_params
from repro.parallel import sharding as shd


def key(p):
    for a in ("key", "idx", "name"):
        if hasattr(p, a):
            return str(getattr(p, a))
    return str(p)


def flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return [["/".join(key(p) for p in path), list(spec)]
            for path, spec in leaves]


def abstract(arch):
    k = jax.random.PRNGKey(0)
    cfg = arch.model
    if arch.family == "lm":
        return abstract_lm_params(cfg)
    if arch.family == "gnn":
        return jax.eval_shape(lambda k: gnn_mod.INITS[cfg.kind](k, cfg=cfg), k)
    if arch.family == "nequip":
        return jax.eval_shape(lambda k: init_nequip_params(k, cfg=cfg), k)
    return jax.eval_shape(lambda k: init_autoint_params(k, cfg=cfg), k)


meshes = {"test": make_test_mesh(8, tp=2),
          "single_pod": make_production_mesh(),
          "multi_pod": make_production_mesh(multi_pod=True)}
out = {}
for name, mesh in meshes.items():
    for a in ARCH_IDS:
        for reduced in (False, True):
            arch = get_config(a, reduced=reduced)
            specs = {}
            if arch.family == "euler":
                specs["euler_state"] = flat(shd.euler_state_specs(
                    mesh, flat_axes(mesh)))
            else:
                params = abstract(arch)
                if arch.family == "lm":
                    specs["params"] = flat(shd.lm_param_specs(params, mesh))
                    specs["params_nofsdp"] = flat(shd.lm_param_specs(
                        params, mesh, fsdp=False))
                    specs["batch"] = flat(shd.lm_batch_spec(mesh))
                    specs["kv_cache"] = flat(shd.kv_cache_specs(mesh))
                elif arch.family == "recsys":
                    specs["params"] = flat(shd.recsys_param_specs(params, mesh))
                    specs["batch"] = flat(shd.recsys_batch_spec(mesh))
                else:
                    specs["params"] = flat(shd.gnn_param_specs(params, mesh))
                    specs["batch"] = flat(shd.gnn_batch_spec(mesh))
                    specs["batch_sharded"] = flat(shd.gnn_batch_spec(
                        mesh, replicate_feats=False))
            out[f"{name}/{a}/{reduced}"] = specs
json.dump(out, open(sys.argv[1], "w"))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    env["JAX_PLATFORMS"] = "cpu"
    return env


# ----------------------------------------------------------------------
# one rank of the port (this file run as a script)
# ----------------------------------------------------------------------
def rank_main(rank: int, world: int, store: str, data: str, out: str):
    """The port's cells over a gloo world: every graph's levels and fused
    run on this rank's rows, written into ``out``; in world 4 also the
    superstep cell on the ``(2, 2)`` test mesh."""
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
    arch = smoke()
    pm = mesh_mod.make_part_mesh(P, device="cpu")
    cells = {s: steps.build_cell(arch, s, pm) for s in arch.shapes}
    src = np.load(data)
    rec = {"abstract": np.array([tuple(t.shape) for t in
                                 cells["superstep"].abstract_inputs[2]])}
    for scale, seed in GRAPHS:
        key = f"{scale}_{seed}"
        state0 = EngineState(*(torch.from_numpy(src[f"{key}/{f}"][pm.rows])
                               for f in EngineState._fields))
        anc, sv = (torch.from_numpy(src[f"{key}/{x}"]) for x in ("anc", "sv"))
        state = state0
        for lvl in range(arch.model.n_levels):
            new, *rest = cells["superstep"].fn(lvl, anc, state)
            for f in EngineState._fields:
                rec[f"{key}/{lvl}/state.{f}"] = getattr(new, f).numpy()
            for f, x in zip(STEP_FIELDS[len(EngineState._fields):], rest):
                rec[f"{key}/{lvl}/{f}"] = x.numpy()
            state = new
        fused = cells["fused"].fn(anc, state0, sv)
        for f in FUSED_FIELDS:
            rec[f"{key}/fused/{f}"] = np.asarray(getattr(fused, f))
    rec["sent_bytes"] = np.array(sorted(pm.sent_bytes.items()), dtype=object)
    if world == 4:       # the (2, 2) test mesh: one partition a rank
        dm = mesh_mod.make_test_mesh(tp=2, device="cpu")
        cell = steps.build_cell(arch, "superstep", dm)
        _, st, anc, _ = inputs(*GRAPHS[0], 4)
        state = EngineState(*(torch.from_numpy(x[rank:rank + 1])
                              for x in st))
        anc = torch.from_numpy(anc)
        for lvl in range(arch.model.n_levels):
            out_ = cell.fn(lvl, anc, state)
            state = out_[0]
            for f, x in zip(STEP_FIELDS, (*out_[0], *out_[1:])):
                rec[f"devmesh/{lvl}/{f}"] = x.numpy()
    np.savez(out, **rec)
    os._exit(0)       # no group teardown: a peer may still be waiting


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Start every subprocess at once (the reference's cells, its specs,
    each port world's ranks) and collect them in the order asked."""
    tmp = tmp_path_factory.mktemp("cells")
    data = tmp / "inputs.npz"
    write_inputs(data)
    env = _env()
    procs = {}
    code = textwrap.dedent(REFERENCE_CELLS.format(
        P=P, keys=[f"{s}_{d}" for s, d in GRAPHS]))
    ref_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8")
    procs["ref_cells"] = [subprocess.Popen(
        [sys.executable, "-c", code, str(data), str(tmp / "ref_cells.npz")],
        env=ref_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)]
    spec_env = dict(env,
                    XLA_FLAGS="--xla_force_host_platform_device_count=512")
    procs["ref_specs"] = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE_SPECS),
         str(tmp / "ref_specs.json")], env=spec_env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]
    for world in WORLDS:
        store = tmp / f"store{world}"
        procs[world] = [subprocess.Popen(
            [sys.executable, __file__, "--rank", str(r), "--world",
             str(world), "--store", str(store), "--data", str(data),
             "--out", str(tmp / f"port{world}_{r}.npz")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(world)]
    done = {}

    def get(name):
        if name not in done:
            for p in procs[name]:
                try:
                    log, _ = p.communicate(timeout=LIVE_TIMEOUT)
                except subprocess.TimeoutExpired:
                    for q in procs[name]:
                        q.kill()
                    pytest.fail(f"{name} did not finish in {LIVE_TIMEOUT} s")
                assert p.returncode == 0, f"{name}: {log[-4000:]}"
            done[name] = True
        return tmp

    yield get
    for group in procs.values():
        for p in group:
            if p.poll() is None:
                p.kill()


# ----------------------------------------------------------------------
# the cells against the reference
# ----------------------------------------------------------------------
def test_smoke_graphs_fit_the_caps():
    """Every flag of every level holds for the cells' graphs (so their
    bytes are a circuit, not an overflow), on the one-device engine."""
    cfg = smoke().model
    for n_parts, graphs in ((P, GRAPHS), (4, GRAPHS[:1])):
        for scale, seed in graphs:
            g, st, anc, sv = inputs(scale, seed, n_parts)
            eng = Engine(n_parts, cfg.caps, cfg.n_levels)
            s, a, _ = state_from_numpy(st, anc, sv, "cpu")
            out = eng.run_levels(s, a, cfg.fused_edges, clock=False)
            assert out.flags.all(), (n_parts, scale, seed)


@pytest.mark.parametrize("scale, fits", [(11, True), (12, False)])
def test_full_config_lanes_hold_rmat_scale_11_at_16_partitions(scale, fits):
    """The scale ``chip_smoke.py`` phase 18 runs the full config at: with
    euler-rmat-512's lanes and round budgets at P = 16, every flag of an
    Eulerian RMAT graph of scale 11 (average degree 5, seed 0) holds, and
    at scale 12 a lane overflows at the top merge (flag 3 of level 4).  The tables are sized to the graph (the full config's
    hold it many times over and change no bit; they are the card's
    work)."""
    full = registry.get_config("euler-rmat").model
    g = eulerian_rmat(scale, avg_degree=5, seed=0)
    pg = partition_graph(g, partition_vertices(g, 16, seed=0))
    raw = Engine.size_caps(pg, slack=2.0)
    caps = dataclasses.replace(
        full.caps, edge_cap=raw.edge_cap, park_cap=raw.park_cap,
        new_cap=raw.new_cap, open_cap=max(raw.open_cap, 4096),
        touch_cap=max(raw.touch_cap, 8192))
    eng = Engine(16, caps, full.n_levels)
    st, anc = eng.load(pg)
    s, a, _ = state_from_numpy(st, anc, stub_vertex(pg), "cpu")
    flags = eng.run_levels(s, a, g.num_edges, clock=False).flags.numpy()
    bad = sorted({(lvl, f) for _, lvl, f in np.argwhere(~flags)})
    assert bad == ([] if fits else [(4, 3)]), bad


@pytest.mark.parametrize("world", WORLDS)
def test_superstep_cells_match_the_reference(spawned, world):
    ref = np.load(spawned("ref_cells") / "ref_cells.npz")
    tmp = spawned(world)
    m = P // world
    cfg = smoke().model
    for r in range(world):
        got = np.load(tmp / f"port{world}_{r}.npz", allow_pickle=True)
        widths = {"pk": cfg.caps.park_cap, "op": cfg.caps.open_cap,
                  "tc": cfg.caps.touch_cap, "le": cfg.caps.edge_cap}
        assert got["abstract"].tolist() == [
            [m, widths[f[:2]]] for f in EngineState._fields]
        for scale, seed in GRAPHS:
            for lvl in range(cfg.n_levels):
                for f in STEP_FIELDS:
                    k = f"{scale}_{seed}/{lvl}/{f}"
                    want = ref[k][r * m:(r + 1) * m]
                    assert got[k].dtype == want.dtype, k
                    np.testing.assert_array_equal(got[k], want, err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_fused_cells_match_the_reference(spawned, world):
    ref = np.load(spawned("ref_cells") / "ref_cells.npz")
    tmp = spawned(world)
    for r in range(world):
        got = np.load(tmp / f"port{world}_{r}.npz", allow_pickle=True)
        for scale, seed in GRAPHS:
            key = f"{scale}_{seed}/fused"
            assert bool(ref[f"{key}/flags"].all())
            for f in FUSED_FIELDS:
                np.testing.assert_array_equal(
                    got[f"{key}/{f}"], ref[f"{key}/{f}"],
                    err_msg=f"world {world} rank {r} {key}/{f}")
        # every rank sent its lanes: 21 all_to_all a level, the mate
        # route's 3 more a fused level, the replicated Phase 3's gather
        sent = dict(got["sent_bytes"].tolist())
        assert set(sent) == {"all_to_all", "all_gather", "fetch"}
        assert all(v > 0 for v in sent.values())


def test_superstep_cell_on_the_test_mesh(spawned):
    """World 4's ``(2, 2)`` test mesh: one partition a rank, its axes
    flattened; each rank's rows equal the one-device engine's."""
    tmp = spawned(4)
    cfg = smoke().model
    _, st, anc, sv = inputs(*GRAPHS[0], 4)
    eng = Engine(4, cfg.caps, cfg.n_levels)
    state, a, _ = state_from_numpy(st, anc, sv, "cpu")
    for lvl in range(cfg.n_levels):
        out = eng.superstep(lvl, a, state)
        state = out[0]
        for f, x in zip(STEP_FIELDS, (*out[0], *out[1:])):
            for r in range(4):
                got = np.load(tmp / f"port4_{r}.npz")[f"devmesh/{lvl}/{f}"]
                np.testing.assert_array_equal(got, x.numpy()[r:r + 1],
                                              err_msg=f"{lvl}/{f}/{r}")


def test_cell_model_flops_match_the_reference(spawned):
    """``model_flops`` of both cells, reduced and full, as the reference
    computes them (its cells built on an 8-device mesh: n = 8)."""
    ref = np.load(spawned("ref_cells") / "ref_cells.npz")
    fake_world(1)
    try:
        pm = mesh_mod.make_part_mesh(8, device="cpu")
        for r in (False, True):
            arch = registry.get_config("euler-rmat", reduced=r)
            for s in ("superstep", "fused"):
                cell = steps.build_cell(arch, s, pm)
                assert cell.model_flops == float(ref[f"flops/{r}/{s}"])
                assert cell.engine.mesh is pm and cell.engine.n == 8
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------------
# the config and the registry
# ----------------------------------------------------------------------
@pytest.mark.parametrize("reduced", [False, True])
def test_config_equals_the_reference(reduced):
    from repro.configs.registry import ARCH_IDS, get_config

    mine = registry.get_config("euler-rmat", reduced=reduced)
    want = get_config("euler-rmat", reduced=reduced)
    assert registry.ARCH_IDS == ARCH_IDS
    assert (mine.arch_id, mine.family, mine.source) == \
        (want.arch_id, want.family, want.source)
    assert dataclasses.asdict(mine.model) == dataclasses.asdict(want.model)
    assert {k: dataclasses.asdict(v) for k, v in mine.shapes.items()} == \
        {k: dataclasses.asdict(v) for k, v in want.shapes.items()}
    assert (mine.reduced is None) == (want.reduced is None) == reduced


# ----------------------------------------------------------------------
# the specs against the reference, entry for entry
# ----------------------------------------------------------------------
def _fake_store():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    return FakeStore()


def _entries(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _flat(tree):
    return [[path, _entries(spec)] for path, spec in leaves_with_paths(tree)]


def _port_params(arch):
    from repro_torch.models import gnn as gnn_mod
    from repro_torch.models.equivariant import abstract_nequip_params
    from repro_torch.models.recsys import abstract_autoint_params
    from repro_torch.models.transformer import abstract_lm_params

    cfg = arch.model
    if arch.family == "lm":
        return abstract_lm_params(cfg)
    if arch.family == "gnn":
        return gnn_mod.INITS[cfg.kind](torch.Generator().manual_seed(0), cfg)
    if arch.family == "nequip":
        return abstract_nequip_params(cfg)
    return abstract_autoint_params(cfg)


def _unstack_layers(flat):
    """The port's per-layer entries ``layers/<i>/<rest>`` as the
    reference's stacked ``layers/<rest>`` (a leading ``None`` for the
    layer axis); every layer must agree."""
    out = {}
    for path, spec in flat:
        parts = path.split("/")
        if parts[0] == "layers":
            path, spec = "/".join([parts[0], *parts[2:]]), [None, *spec]
            assert out.setdefault(path, spec) == spec, path
        else:
            out[path] = spec
    return sorted([k, v] for k, v in out.items())


def port_specs(mesh):
    out = {}
    for a in registry.ARCH_IDS:
        for reduced in (False, True):
            arch = registry.get_config(a, reduced=reduced)
            specs = {}
            if arch.family == "euler":
                specs["euler_state"] = _flat(shd.euler_state_specs(
                    mesh, mesh_mod.flat_axes(mesh)))
            else:
                params = _port_params(arch)
                if arch.family == "lm":
                    specs["params"] = _unstack_layers(
                        _flat(shd.lm_param_specs(params, mesh)))
                    specs["params_nofsdp"] = _unstack_layers(_flat(
                        shd.lm_param_specs(params, mesh, fsdp=False)))
                    specs["batch"] = _flat(shd.lm_batch_spec(mesh))
                    specs["kv_cache"] = _flat(shd.kv_cache_specs(mesh))
                elif arch.family == "recsys":
                    specs["params"] = _flat(shd.recsys_param_specs(params,
                                                                   mesh))
                    specs["batch"] = _flat(shd.recsys_batch_spec(mesh))
                else:
                    specs["params"] = _flat(shd.gnn_param_specs(params, mesh))
                    specs["batch"] = _flat(shd.gnn_batch_spec(mesh))
                    specs["batch_sharded"] = _flat(shd.gnn_batch_spec(
                        mesh, replicate_feats=False))
            out[f"{a}/{reduced}"] = specs
    return out


def fake_world(world):
    """A ``fake`` world of ``world`` ranks, this process rank 0."""
    dist.init_process_group("fake", store=_fake_store(), rank=0,
                            world_size=world)


@pytest.fixture(scope="module")
def specs(spawned):
    """The port's specs on each mesh, and the reference's."""
    mine = {}
    for name, (world, kw) in MESHES.items():
        fake_world(world)
        try:
            mesh = (mesh_mod.make_test_mesh(device="cpu", **kw)
                    if name == "test"
                    else mesh_mod.make_production_mesh(device="cpu", **kw))
            mine[name] = (tuple(mesh.shape), port_specs(mesh))
        finally:
            dist.destroy_process_group()
    ref = json.loads((spawned("ref_specs") / "ref_specs.json").read_text())
    return mine, ref


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_specs_equal_the_reference(specs, mesh_name, arch):
    mine, ref = specs
    shape, port = mine[mesh_name]
    assert shape == {"test": (4, 2), "single_pod": (16, 16),
                     "multi_pod": (2, 16, 16)}[mesh_name]
    for reduced in (False, True):
        want = ref[f"{mesh_name}/{arch}/{reduced}"]
        got = port[f"{arch}/{reduced}"]
        assert set(got) == set(want)
        for fn in want:
            w = want[fn]
            if fn.startswith("params") and registry.get_config(
                    arch).family == "lm":
                w = sorted(w)
            assert got[fn] == w, (mesh_name, arch, reduced, fn)


def test_local_shape_follows_the_spec():
    fake_world(512)
    try:
        mesh = mesh_mod.make_production_mesh(multi_pod=True, device="cpu")
        assert shd.local_shape((512, 64), shd.P(("pod", "data", "model"),
                                                None), mesh) == (1, 64)
        assert shd.local_shape((64, 64), shd.P("model", ("pod", "data")),
                               mesh) == (4, 2)
        assert shd.local_shape((7, 3), shd.P(None), mesh) == (7, 3)
        with pytest.raises(ValueError, match="divide"):
            shd.local_shape((24, 3), shd.P("model"), mesh)
        assert shd.P(("data",), None) == shd.P("data", None)
        assert shd.P((), "model").entries == (None, "model")
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------------
# the meshes
# ----------------------------------------------------------------------
def test_meshes_need_a_group_and_lay_one_partition_a_device():
    with pytest.raises(RuntimeError, match="initialised process group"):
        mesh_mod.make_production_mesh(device="cpu")
    fake_world(256)
    try:
        mesh = mesh_mod.make_production_mesh(device="cpu")
        assert mesh.mesh_dim_names == ("data", "model")
        assert mesh_mod.flat_axes(mesh) == ("data", "model")
        pm = mesh_mod.part_mesh_of(mesh)
        assert (pm.n_parts, pm.world, pm.m, pm.rank, pm.first) == \
            (256, 256, 1, 0, 0)
        assert pm.backend == "fake" and pm.device == torch.device("cpu")
        assert pm.mesh_dim_names == ("part",) and pm.shape == (256,)
        test = mesh_mod.make_test_mesh(16, tp=4, device="cpu")
        assert tuple(test.shape) == (4, 4)
        sub = mesh_mod.part_mesh_of(test)
        assert (sub.n_parts, sub.world, sub.rank) == (16, 16, 0)
    finally:
        dist.destroy_process_group()


def test_fake_mesh_zero_fills_what_it_receives():
    """What a fake group writes into a receive buffer (torch 2.11 leaves
    it as allocated) never reaches the engine: the mesh zero-fills it,
    and counts the bytes it sent."""
    fake_world(4)
    try:
        pm = mesh_mod.make_part_mesh(4, device="cpu")

        def garbage(out, *a, **kw):
            out.fill_(-7)

        with mock.patch.object(dist, "all_to_all_single", garbage), \
                mock.patch.object(dist, "all_gather_into_tensor", garbage):
            a = pm.all_to_all(torch.ones(4, 3, dtype=torch.bool))
            r = pm.ring(torch.arange(6, dtype=torch.int32).view(1, 6))
            g = pm.all_gather(torch.ones(1, 2, dtype=torch.int32))
        assert a.dtype == torch.bool and not a.any()
        assert r.tolist() == [[0] * 6] and g.tolist() == [[0, 0]] * 4
        assert dict(pm.sent_bytes) == {"all_to_all": 12, "ring": 24,
                                       "all_gather": 8}
        assert dict(pm.calls) == {"all_to_all": 1, "ring": 1,
                                  "all_gather": 1}
    finally:
        dist.destroy_process_group()


def test_fake_backend_runs_on_the_card_unless_asked():
    fake_world(2)
    try:
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="card"):
                mesh_mod.make_part_mesh(2)
        assert mesh_mod.make_part_mesh(2, device="cpu").device.type == "cpu"
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------------
# refusals
# ----------------------------------------------------------------------
def test_build_cell_refusals():
    arch = smoke()
    with pytest.raises(ValueError, match="mesh"):
        steps.build_cell(arch, "fused")
    fake_world(8)
    try:
        mesh = mesh_mod.make_test_mesh(tp=2, device="cpu")
        lm = registry.get_config("smollm-360m", reduced=True)
        moe = registry.get_config("qwen2-moe-a2.7b", reduced=True)
        with pytest.raises(NotImplementedError, match="item 9c"):
            steps.build_cell(moe, "train_4k", mesh)
        with pytest.raises(steps.SkippedCell):
            steps.build_cell(lm, "long_500k", mesh)
        cell = steps.build_cell(arch, "superstep", mesh)
        assert [tuple(x.shape) for x in cell.abstract_inputs[2]][0] == (1, 64)
        assert tuple(cell.abstract_inputs[1].shape) == (4, 8)
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------------
# the dry run
# ----------------------------------------------------------------------
def test_dry_run_of_the_reduced_cells():
    recs = [dryrun.run_cell("euler-rmat", shape, mp, verbose=False,
                            device="cpu", reduced=True)
            for shape in ("superstep", "fused") for mp in (False, True)]
    assert [(r["shape"], r["world"]) for r in recs] == [
        ("superstep", 256), ("superstep", 512), ("fused", 256),
        ("fused", 512)]
    caps = smoke().model.caps
    for r in recs:
        assert r["partitions_per_rank"] == 1 and r["rank"] == 0
        assert set(r["terms_s"]) == {"compute", "memory", "collective"}
        assert r["dominant"] in r["terms_s"]
        mem = r["memory"]
        assert mem["argument_bytes"] >= engine_state_bytes(caps)
        assert mem["output_bytes"] > 0 and mem["program_cost_bytes"] > 0
        assert mem["peak_allocated_bytes"] is None     # the CPU
        assert r["model_flops_per_device"] == \
            r["model_flops_total"] / r["world"]
        calls = r["collectives"]["calls"]
        want = ({"all_to_all": 21} if r["shape"] == "superstep" else
                {"all_to_all": 24 * 4, "all_gather": 1, "fetch": 2})
        assert calls == want, r["shape"]
        assert set(r["collectives"]["sent_bytes"]) == set(want)
        assert "flags not checked" in r["measured"]


def test_dry_run_of_one_rank_of_the_full_superstep():
    """The full config's superstep on one rank of the single-pod mesh, on
    the CPU: every table at its cap, no index out of range."""
    rec = dryrun.run_cell("euler-rmat", "superstep", False, verbose=False,
                          device="cpu")
    caps = registry.get_config("euler-rmat").model.caps
    mem = rec["memory"]
    # the state at its caps, the ancestor table [10, 256] and the level
    assert mem["argument_bytes"] == engine_state_bytes(caps) + \
        10 * 256 * 4 + 4
    # a level's lanes: park 8 fields, open 6, touch 7, [256, lane] each
    lanes = 256 * (8 * caps.ship_cap + 6 * caps.open_ship_cap
                   + 7 * caps.touch_ship_cap)
    sent = rec["collectives"]["sent_bytes"]["all_to_all"]
    assert sent == lanes * 4 - 256 * (caps.ship_cap + caps.open_ship_cap
                                      + caps.touch_ship_cap) * 3
    assert rec["collectives"]["calls"] == {"all_to_all": 21}
    assert rec["terms_s"]["collective"] == sent / dryrun.LINK_BW


def test_dry_run_skips_other_families_and_fails_loudly(capsys):
    rec = dryrun.run_cell("gcn-cora", "full_graph_sm", False, verbose=False)
    assert rec["skip"] == dryrun.OTHER_FAMILIES
    assert "9c" in rec["skip"]
    with mock.patch.object(steps, "build_cell",
                           side_effect=RuntimeError("planted")):
        assert dryrun.main(["--arch", "euler-rmat", "--shape",
                            "superstep", "--device", "cpu"]) == 1
    assert "FAILED: planted" in capsys.readouterr().out
    assert not dist.is_initialized()


def test_balanced_ancestor_table():
    anc = dryrun.balanced_anc(4, 8, "cpu")
    assert anc.tolist() == [[0, 0, 2, 2, 4, 4, 6, 6], [0] * 4 + [4] * 4,
                            [0] * 8, [0] * 8]


# ----------------------------------------------------------------------
# the slice stands alone
# ----------------------------------------------------------------------
@pytest.mark.parametrize("module", ["repro_torch.configs.euler_rmat",
                                    "repro_torch.parallel.sharding",
                                    "repro_torch.parallel.overlap",
                                    "repro_torch.launch.dryrun",
                                    "repro_torch.launch.mesh"])
def test_cells_slice_imports_with_jax_blocked(module):
    """Each module of the slice, imported first in a fresh process with
    JAX blocked, pulls in nothing of the reference package."""
    code = f"""
import importlib, sys
sys.modules["jax"] = None
sys.path[:0] = [{SRC!r}]
importlib.import_module({module!r})
bad = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not bad, bad
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=LIVE_TIMEOUT)
    assert r.returncode == 0, r.stdout + r.stderr


# ----------------------------------------------------------------------
# grad_accum_scan
# ----------------------------------------------------------------------
def test_grad_accum_scan_matches_the_reference():
    import jax
    from repro.configs.smollm_360m import CONFIG as JCONFIG
    from repro.models import transformer as jtr
    from repro.parallel.overlap import grad_accum_scan as jscan

    from repro_torch.configs.smollm_360m import CONFIG
    from repro_torch.models import transformer as tr
    from repro_torch.parallel.overlap import grad_accum_scan

    jcfg = dataclasses.replace(JCONFIG.reduced().model, q_block=16)
    cfg = dataclasses.replace(CONFIG.reduced().model, q_block=16)
    assert cfg.dtype == torch.float32
    params = jax.tree_util.tree_map(
        np.asarray, jtr.init_lm_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab, (4, 65)).astype(np.int32)
    batch = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    want_loss, want = jax.jit(lambda p, b: jscan(
        lambda q, mb: jtr.lm_loss(q, jcfg, mb["tokens"], mb["labels"]),
        p, b, 2))(params, batch)
    loss, grads = grad_accum_scan(
        lambda q, mb: tr.lm_loss(q, cfg, mb["tokens"], mb["labels"]),
        tr.params_from_numpy(params),
        {k: torch.from_numpy(v) for k, v in batch.items()}, 2)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5,
                               atol=2e-5)
    got = jax.tree.leaves(tr.params_to_numpy(grads))
    ref = jax.tree.leaves(want)
    assert len(got) == len(ref) and all(g.dtype == np.float32 for g in got)
    for g, w in zip(got, ref):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=2e-5)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--data", required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    rank_main(a.rank, a.world, a.store, a.data, a.out)
