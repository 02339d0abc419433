"""The GNN slice of the port against the JAX package, on the CPU:
``models/gnn.py``'s segment aggregations and GCN, GAT and PNA (forward,
``gnn_loss`` and every gradient, with the reference's weights through
``params_from_numpy``), the tie rules that decide PNA's gradient, three
``build_cell`` train steps at the reference smoke test's two shapes, the
abstract cells of all three archs at the four GNN shapes, the
``NeighborSampler``'s blocks, the three configs and the example.

The graphs are padded as the sampler pads them and hold masked edges,
padded nodes, an isolated node, duplicate edges and zero-feature nodes
(whose messages in PNA are all-zero ReLU outputs).  The reference's
outputs are built once per module (``lru_cache``); JAX is imported
inside the tests that compare with it, so the ``gpu`` test also runs on
a machine that has a card and no JAX."""
import dataclasses
import functools
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import ShapeCell
from repro_torch.core.graph import Graph
from repro_torch.graphgen.eulerize import eulerian_rmat
from repro_torch.graphgen.sampler import NeighborSampler
from repro_torch.launch import steps
from repro_torch.models import gnn
from repro_torch.optim import AdamWState
from repro_torch.tree import leaves_with_paths, tree_leaves, tree_map

ARCHS = ["gcn-cora", "gat-cora", "pna"]
#: ROADMAP's f32 tolerances for values; gradients, moments and parameters
#: after train steps at tests/test_torch_train.py's atol of 2e-6 (GCN and
#: GAT read at most 1.3e-8 here)
RTOL, ATOL = 1e-5, 2e-5
GRAD_RTOL, GRAD_ATOL = RTOL, 2e-6
#: PNA's gradients at an atol of 1e-5: its max and min aggregations send
#: a segment's gradient to one message, and where two messages of a
#: segment are within rounding of each other XLA's and torch's products
#: can pick different ones; its logits reach 300 and its w_pre gradients
#: 20.  Beyond the rtol the worst element read 6.6e-6 (three seeded
#: graphs at each smoke shape), the same with no isolated node
PNA_GRAD_ATOL = 1e-5


def grad_atol(arch):
    return PNA_GRAD_ATOL if arch == "pna" else GRAD_ATOL
#: the reference smoke test's shapes (tests/test_configs_smoke.py)
SMOKE = {
    "full_graph_sm": ShapeCell("full_graph_sm", "graph_train", n_nodes=64,
                               n_edges=256, d_feat=64, n_classes=7),
    "molecule": ShapeCell("molecule", "graph_train", n_nodes=8, n_edges=16,
                          batch=4, d_feat=64, n_classes=4),
}
SHAPES = ["full_graph_sm", "minibatch_lg", "ogb_products", "molecule"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small CPU work: one intra-op thread runs it fastest beside the
    suite's other workers; the setting is restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def graph_np(n, e, n_classes, seed, d=64):
    """A padded graph as numpy arrays: the last eighth of the nodes are
    padding (zero features, masked), a tenth of the edges are masked (half
    of them at the sampler's pad row n - 1), the last real node is
    isolated, edges 4 and 5 are one edge twice, and nodes 0 and 1 have
    zero features and an edge between them."""
    rng = np.random.default_rng(seed)
    n_real = n - n // 8
    feat = rng.normal(size=(n, d)).astype(np.float32)
    feat[n_real:] = 0
    feat[:2] = 0
    src = rng.integers(0, n_real - 1, e).astype(np.int32)
    dst = rng.integers(0, n_real - 1, e).astype(np.int32)
    src[0], dst[0] = 0, 1
    src[5], dst[5] = src[4], dst[4]
    mask = np.ones(e, bool)
    masked = rng.permutation(np.arange(6, e))[: e // 10]
    mask[masked] = False
    src[masked[::2]] = dst[masked[::2]] = n - 1
    src[masked[1::2]] = rng.integers(0, n, len(masked[1::2]))
    labels = rng.integers(0, n_classes, n).astype(np.int32)
    return dict(node_feat=feat, edge_src=src, edge_dst=dst, edge_mask=mask,
                node_mask=np.arange(n) < n_real, labels=labels)


def smoke_graph(shape, seed):
    cell = SMOKE[shape]
    g_abs = steps._graph_abstract(cell, 64)
    return graph_np(g_abs.node_feat.shape[0], g_abs.edge_src.shape[0],
                    cell.n_classes, seed)


def port_graph(arrays, device="cpu"):
    return gnn.GraphBatch(**{k: torch.from_numpy(v).to(device)
                             for k, v in arrays.items()})


def jax_graph(arrays):
    import jax.numpy as jnp
    from repro.models import gnn as jg
    return jg.GraphBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})


def port_cfg(arch, n_classes):
    return dataclasses.replace(registry.get_config(arch, reduced=True).model,
                               n_classes=n_classes)


def jax_cfg(arch, n_classes):
    from repro.configs.registry import get_config
    return dataclasses.replace(get_config(arch, reduced=True).model,
                               n_classes=n_classes)


@functools.lru_cache(maxsize=None)
def jax_params(arch, n_classes):
    """The reference's seeded weights (``PRNGKey(0)``), drawn by one
    jitted init."""
    import jax
    from repro.models import gnn as jg
    cfg = jax_cfg(arch, n_classes)
    init = jax.jit(jg.INITS[cfg.kind], static_argnums=1)
    return jax.tree_util.tree_map(np.asarray,
                                  init(jax.random.PRNGKey(0), cfg))


def leaves_np(tree):
    import jax
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def assert_trees_close(got, want, rtol, atol):
    got, want = tree_leaves(gnn.params_to_numpy(got)), leaves_np(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def trees_close(got, want, rtol, atol) -> bool:
    try:
        assert_trees_close(got, want, rtol, atol)
    except AssertionError:
        return False
    return True


# ------------------------------------------------------- aggregations --

@pytest.mark.parametrize("agg", ["sum", "mean", "max", "min", "std"])
def test_seg_matches_jax(agg):
    """One aggregation and its gradient, with two empty segments, tied
    maxima (repeated ReLU zeros) and a one-value segment (var 0)."""
    import jax
    import jax.numpy as jnp
    from repro.models import gnn as jg

    rng = np.random.default_rng(3)
    data = np.maximum(rng.normal(size=(40, 6)), 0).astype(np.float32)
    ids = rng.integers(0, 9, 40).astype(np.int32)
    ids[ids == 4] = 3                       # segments 4 and 9 are empty
    ids[0] = 10
    up = rng.normal(size=(11, 6)).astype(np.float32)

    def jloss(x):
        return jnp.sum(jg._seg(agg, x, ids, 11) * up)

    want, want_grad = jax.value_and_grad(jloss)(data)
    x = torch.from_numpy(data).requires_grad_(True)
    got = torch.sum(gnn._seg(agg, x, torch.from_numpy(ids), 11)
                    * torch.from_numpy(up))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


# ------------------------------------------------ forward and gradients --

@functools.lru_cache(maxsize=None)
def jax_reference(arch, shape, seed):
    """The reference's logits, ``gnn_loss`` and every gradient on the
    seeded smoke graph, in one jitted program (one compile a config and
    shape beats op-by-op dispatch here)."""
    import jax
    from repro.models import gnn as jg

    def fn(params, cfg, g):
        return jg.FORWARDS[cfg.kind](params, cfg, g), \
            jax.value_and_grad(jg.gnn_loss)(params, cfg, g)

    n_classes = SMOKE[shape].n_classes
    logits, (loss, grads) = jax.jit(fn, static_argnums=1)(
        jax_params(arch, n_classes), jax_cfg(arch, n_classes),
        jax_graph(smoke_graph(shape, seed)))
    return (np.asarray(logits), float(loss),
            jax.tree_util.tree_map(np.asarray, grads))


@pytest.mark.parametrize("shape", ["full_graph_sm", "molecule"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, shape):
    n_classes = SMOKE[shape].n_classes
    cfg = port_cfg(arch, n_classes)
    got = gnn.FORWARDS[cfg.kind](
        gnn.params_from_numpy(jax_params(arch, n_classes)), cfg,
        port_graph(smoke_graph(shape, 1)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), jax_reference(arch, shape, 1)[0],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", ["full_graph_sm", "molecule"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax(arch, shape):
    n_classes = SMOKE[shape].n_classes
    loss, grads = steps.gnn_value_and_grad(
        gnn.params_from_numpy(jax_params(arch, n_classes)),
        port_cfg(arch, n_classes), port_graph(smoke_graph(shape, 1)))
    _, want_loss, want_grads = jax_reference(arch, shape, 1)
    np.testing.assert_allclose(float(loss), want_loss, rtol=RTOL, atol=ATOL)
    assert_trees_close(grads, want_grads, GRAD_RTOL, grad_atol(arch))


# ------------------------------------------------------------ tie rules --

#: the tie graph's (a, b, v) triples: a and b are one-hot nodes whose
#: first-layer PNA messages into v are the w_pre rows 0.5 and
#: 0.5·(1 + 2^-12) in every channel, so v's variance rounds to exactly 0
#: (a tie with the floor) while its gradient does not vanish
TIE_TRIPLES = 10


@functools.lru_cache(maxsize=None)
def tie_case():
    """(weights, graph arrays, the reference's loss and gradients) where
    ``jnp.maximum``'s half gradient at a tie decides PNA's gradient: a
    floor that passes all of it (torch's ``clamp``) moves the w_pre
    gradient past the atol.  The reference runs op by op, each f32 op
    rounded as written: a jitted program may fuse the variance into one
    multiply-add, which leaves it a tiny positive value and no tie."""
    import jax
    from repro.models import gnn as jg

    params = tree_map(np.array, jax_params("pna", 7))
    w = params["layers"][0]["w_pre"]
    rng = np.random.default_rng(3)
    n, e = 64, 64
    feat = rng.normal(size=(n, 64)).astype(np.float32)
    src, dst = np.zeros(e, np.int32), np.zeros(e, np.int32)
    for i in range(TIE_TRIPLES):
        w[2 * i] = 0.5
        w[2 * i + 1] = 0.5 * (1 + 2.0 ** -12)
        a, b, v = 3 * i, 3 * i + 1, 3 * i + 2
        feat[a:v + 1] = 0
        feat[a, 2 * i] = feat[b, 2 * i + 1] = 1
        src[2 * i: 2 * i + 2], dst[2 * i: 2 * i + 2] = (a, b), v
    rest = np.arange(2 * TIE_TRIPLES, e)
    src[rest] = rng.integers(3 * TIE_TRIPLES, n, len(rest))
    dst[rest] = rng.integers(3 * TIE_TRIPLES, n, len(rest))
    arrays = dict(node_feat=feat, edge_src=src, edge_dst=dst,
                  edge_mask=np.ones(e, bool), node_mask=np.ones(n, bool),
                  labels=rng.integers(0, 7, n).astype(np.int32))
    loss, grads = jax.value_and_grad(jg.gnn_loss)(
        params, jax_cfg("pna", 7), jax_graph(arrays))
    return params, arrays, float(loss), \
        jax.tree_util.tree_map(np.asarray, grads)


def clamp_floor(x, value):
    """A planted fault: the floor by ``torch.clamp`` (all of the gradient
    at a tie)."""
    return torch.clamp(x, min=value)


def self_inclusive_max(data, seg_ids, num_segments):
    """A planted fault: the segment maximum reduced into a zero buffer
    that takes part (``include_self=True``)."""
    idx = seg_ids.long().view((-1,) + (1,) * (data.dim() - 1))
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.scatter_reduce(0, idx.expand_as(data), data, "amax",
                              include_self=True)


@pytest.mark.parametrize("fault", [None, "clamp", "include_self"])
def test_tie_rules_decide_the_pna_gradient(fault):
    """The tie case matches the reference; each planted tie-rule fault
    makes the same PNA gradient differ from it."""
    params, arrays, want_loss, want = tie_case()
    patch = {None: mock.patch.object(gnn, "_floor", gnn._floor),
             "clamp": mock.patch.object(gnn, "_floor", clamp_floor),
             "include_self": mock.patch.object(gnn, "_segment_max",
                                               self_inclusive_max)}[fault]
    with patch:
        loss, grads = steps.gnn_value_and_grad(
            gnn.params_from_numpy(params), port_cfg("pna", 7),
            port_graph(arrays))
    close = trees_close(grads, want, GRAD_RTOL, GRAD_ATOL)
    if fault is None:
        np.testing.assert_allclose(float(loss), want_loss, rtol=RTOL,
                                   atol=ATOL)
        assert close
    else:
        assert not close


# ---------------------------------------------------- build_cell steps --

def seeded_state(params_np, seed=7):
    """AdamW moments at step 1000 drawn from a seed, the same for both
    packages (as in tests/test_torch_train.py): with zero moments Adam's
    first update is the sign of each gradient, which rounding flips where
    a gradient is near 0."""
    rng = np.random.default_rng(seed)
    m = tree_map(lambda p: (rng.normal(size=p.shape) * 1e-3)
                 .astype(np.float32), params_np)
    v = tree_map(lambda p: (rng.uniform(0.5, 1.5, size=p.shape) * 1e-6)
                 .astype(np.float32), params_np)
    return np.int32(1000), m, v


@functools.lru_cache(maxsize=None)
def jax_three_steps(arch, shape):
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_config
    from repro.launch import steps as jsteps
    from repro.optim.adamw import AdamWState as JAdamWState

    jarch = dataclasses.replace(get_config(arch, reduced=True),
                                shapes=SMOKE)
    fn = jax.jit(jsteps.build_cell(jarch, shape, None).fn)
    params_np = jax_params(arch, max(SMOKE[shape].n_classes, 2))
    step, m, v = seeded_state(params_np)
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    opt = JAdamWState(step=jnp.asarray(step), m=m, v=v)
    losses = []
    for seed in range(3):
        params, opt, loss = fn(params, opt, jax_graph(smoke_graph(shape,
                                                                  seed)))
        losses.append(float(loss))
    return (losses, jax.tree_util.tree_map(np.asarray, params),
            jax.tree_util.tree_map(np.asarray, opt))


@pytest.mark.parametrize("shape", ["full_graph_sm", "molecule"])
@pytest.mark.parametrize("arch", ARCHS)
def test_build_cell_three_train_steps_match_jax(arch, shape):
    """The reference's jitted GNN train step against the port's eager one
    (schedule, loss and gradients, clipping, AdamW) three times, on three
    seeded graphs, from a warm AdamW state (step 1000, seeded moments:
    lr 9.8e-4)."""
    arch_cfg = dataclasses.replace(registry.get_config(arch, reduced=True),
                                   shapes=SMOKE)
    cell = steps.build_cell(arch_cfg, shape)
    params_np = jax_params(arch, max(SMOKE[shape].n_classes, 2))
    params = gnn.params_from_numpy(params_np)
    step, m, v = seeded_state(params_np)
    opt = AdamWState(step=torch.tensor(step, dtype=torch.int32),
                     m=gnn.params_from_numpy(m), v=gnn.params_from_numpy(v))
    losses = []
    for seed in range(3):
        params, opt, loss = cell.fn(params, opt,
                                    port_graph(smoke_graph(shape, seed)))
        losses.append(float(loss))
    want_losses, want_params, want_opt = jax_three_steps(arch, shape)
    np.testing.assert_allclose(losses, want_losses, rtol=RTOL, atol=ATOL)
    assert int(opt.step) == int(want_opt.step) == 1003
    for got, want in ((params, want_params), (opt.m, want_opt.m),
                      (opt.v, want_opt.v)):
        assert_trees_close(got, want, GRAD_RTOL, grad_atol(arch))
    moved = max(float(np.abs(a - b).max()) for a, b in
                zip(tree_leaves(gnn.params_to_numpy(params)),
                    leaves_np(params_np)))
    assert moved > 100 * GRAD_ATOL          # the update is visible


# ------------------------------------------------------- abstract cells --

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_cells_match_reference(arch, shape):
    """``_graph_abstract``'s shapes and dtypes, the params' and the
    moments' shapes, and ``model_flops`` equal the reference's, full
    width, at every GNN shape (``ogb_products`` included: abstract only)."""
    import jax
    from repro.configs.registry import get_config
    from repro.launch import steps as jsteps

    mine = steps.build_cell(registry.get_config(arch), shape)
    want = jsteps.build_cell(get_config(arch), shape, None)
    assert mine.model_flops == want.model_flops
    params_abs, opt_abs, g_abs = mine.abstract_inputs
    j_params, j_opt, j_g = want.abstract_inputs
    assert all(x.device.type == "meta"
               for x in tree_leaves(mine.abstract_inputs))
    assert g_abs._fields == j_g._fields
    for got, ref in zip(g_abs, j_g):
        assert tuple(got.shape) == ref.shape
        assert str(got.dtype).split(".")[-1] == \
            {"bool": "bool"}.get(ref.dtype.name, ref.dtype.name)
    for tree, ref in ((params_abs, j_params), (opt_abs.m, j_opt.m),
                      (opt_abs.v, j_opt.v)):
        got_l, ref_l = tree_leaves(tree), jax.tree.leaves(ref)
        assert [tuple(x.shape) for x in got_l] == [x.shape for x in ref_l]
        assert all(x.dtype == torch.float32 for x in got_l)


def test_build_cell_refuses_the_other_families_and_a_mesh():
    arch = registry.get_config("pna", reduced=True)
    with pytest.raises(NotImplementedError, match="item 9c"):
        steps.build_cell(arch, "molecule", mesh=object())
    for family in ("euler",):       # runs over a mesh only
        with pytest.raises(ValueError, match="mesh"):
            steps.build_cell(dataclasses.replace(arch, family=family),
                             "molecule")
    assert registry.get_config("euler-rmat").family == "euler"
    assert registry.get_config("granite-20b").family == "lm"


# -------------------------------------------------------------- sampler --

def sampler_graphs():
    rmat = eulerian_rmat(8, avg_degree=5, seed=0)
    # vertex 3 has degree 0; vertices 1 and 4 have degrees 2 and 1, under
    # the fanouts
    small = Graph(num_vertices=8,
                  edge_u=np.array([0, 0, 0, 1, 2, 5, 6, 0, 2], np.int64),
                  edge_v=np.array([1, 2, 5, 2, 5, 6, 7, 7, 4], np.int64))
    return {"rmat8": (rmat, [0, 5, 17, 40, 99, 3]),
            "small": (small, [3, 1, 4, 0])}


@pytest.mark.parametrize("name", ["rmat8", "small"])
def test_sampler_blocks_are_byte_identical(name):
    from repro.core.graph import Graph as JGraph
    from repro.graphgen.sampler import NeighborSampler as JSampler

    graph, seeds = sampler_graphs()[name]
    mine = NeighborSampler(graph, (3, 2), seed=5)
    want = JSampler(JGraph(graph.num_vertices, graph.edge_u, graph.edge_v),
                    (3, 2), seed=5)
    assert mine.nodes_per_seed == want.nodes_per_seed == 10
    assert np.array_equal(mine.offsets, want.offsets)
    assert np.array_equal(mine.nbr, want.nbr)
    for call in range(3):
        seeds_c = np.array(seeds[call:] + seeds[:call], np.int64)
        got, ref = mine.sample(seeds_c), want.sample(seeds_c)
        for field in dataclasses.fields(ref):
            a, b = getattr(got, field.name), getattr(ref, field.name)
            assert a.dtype == b.dtype and a.shape == b.shape, field.name
            assert a.tobytes() == b.tobytes(), (call, field.name)
        if name == "small":
            # the degree-0 seed samples nothing; every edge is in range
            assert (got.edge_dst[got.edge_mask] != seeds_c.tolist()
                    .index(3)).all()
        assert (got.node_ids[~got.node_mask] == -1).all()
        assert (got.edge_src[~got.edge_mask] == len(got.node_ids) - 1).all()


# ---------------------------------------------------- configs and trees --

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    from repro.configs.registry import get_config

    for reduced in (False, True):
        mine, want = registry.get_config(arch, reduced), \
            get_config(arch, reduced)
        assert (mine.arch_id, mine.family, mine.source) == \
            (want.arch_id, want.family, want.source)
        assert {k: dataclasses.asdict(v) for k, v in mine.shapes.items()} \
            == {k: dataclasses.asdict(v) for k, v in want.shapes.items()}
        fields = dataclasses.asdict(mine.model)
        ref = dataclasses.asdict(want.model)
        assert fields.pop("dtype") == torch.float32
        assert ref.pop("dtype").__name__ == "float32"
        assert fields == ref
    assert arch in registry.ARCH_IDS


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_and_init_shapes(arch):
    want = jax_params(arch, 7)
    back = gnn.params_to_numpy(gnn.params_from_numpy(want))
    assert [a.tobytes() for a in leaves_np(back)] == \
        [a.tobytes() for a in leaves_np(want)]
    cfg = port_cfg(arch, 7)
    mine = gnn.INITS[cfg.kind](torch.Generator().manual_seed(0), cfg)
    assert [tuple(x.shape) for x in tree_leaves(mine)] == \
        [a.shape for a in leaves_np(want)]
    # each large matrix is drawn at the reference's scale, 1/sqrt(fan-in)
    # (GAT's a_src/a_dst are stored transposed, [d_out, heads])
    for path, x in leaves_with_paths(mine):
        fan_in = x.shape[1] if path.endswith(("a_src", "a_dst")) else \
            x.shape[0]
        if x.numel() >= 256:
            assert 0.9 < float(x.std()) * fan_in ** 0.5 < 1.1, path


# -------------------------------------------------------------- example --

def test_example_trains_on_the_cpu():
    """``examples/torch_gnn_fullbatch.py --device cpu`` reaches the
    reference example's train accuracy bar (> 0.5)."""
    from conftest import REPO

    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples",
                                      "torch_gnn_fullbatch.py"),
         "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    acc = float(r.stdout.split("train accuracy:")[1].split("%")[0]) / 100
    assert acc > 0.5


# ------------------------------------------------------------- the card --

@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_gnn_matches_cpu(arch):
    """The reduced config in f32 at the smoke graph, one set of seeded
    weights on both devices: logits, loss and every gradient within 1e-4
    (the card's scatters add in the order of their atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the card's path runs only there")
    cfg = port_cfg(arch, 7)
    params = gnn.INITS[cfg.kind](torch.Generator().manual_seed(0), cfg)
    on_card = tree_map(lambda x: x.cuda(), params)
    arrays = smoke_graph("full_graph_sm", 1)
    want = steps.gnn_value_and_grad(params, cfg, port_graph(arrays))
    got = steps.gnn_value_and_grad(on_card, cfg, port_graph(arrays, "cuda"))
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        torch.testing.assert_close(
            gnn.FORWARDS[cfg.kind](on_card, cfg,
                                   port_graph(arrays, "cuda")).cpu(),
            gnn.FORWARDS[cfg.kind](params, cfg, port_graph(arrays)),
            rtol=1e-4, atol=1e-4)
