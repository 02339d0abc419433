"""The NequIP slice of the port against the JAX package, on the CPU:
``models/equivariant.py``'s ``bessel_rbf`` and ``_traceless``, the
forward, ``nequip_energy_loss`` and ``nequip_force_loss`` (the forces by
autograd inside the loss, so its gradient is second order) with every
gradient, the readout's dropped graph ids, the reference's own fault at
an unmasked self-loop, the rotation and translation property, the
abstract cells at the four GNN shapes, three ``build_cell`` train steps
at the reference smoke test's shapes, the config and the weights carried
across (``params_from_numpy``).

Two configs: the reduced one (2 layers, 8 channels, 4 RBF) and the full
widths (5 layers, 32 channels, 8 RBF).  The padded batch holds three
molecules, masked edges (masked self-loops at a pad row among them),
padded atoms whose ``graph_id`` lies outside ``[0, n_graphs)``, a real
atom whose id does too (its energy dropped, its forces not), an isolated
atom, a duplicate edge, an edge beyond the cutoff, and species and edge
ids that the model clips.  The reference's outputs are built once per
module (``lru_cache``); JAX is imported inside the tests that compare
with it, so the ``gpu`` test also runs on a machine with a card and no
JAX."""
import dataclasses
import functools
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import ShapeCell, gnn_shapes
from repro_torch.launch import steps
from repro_torch.models import equivariant as eq
from repro_torch.optim import AdamWState
from repro_torch.tree import leaves_with_paths, tree_leaves, tree_map

#: ROADMAP's f32 tolerances for values; gradients, moments and parameters
#: after train steps at rtol 1e-5 with atol 2e-6 (the full widths' force
#: loss gradients read at most 4e-8 here)
RTOL, ATOL = 1e-5, 2e-5
GRAD_RTOL, GRAD_ATOL = RTOL, 2e-6
#: the reference property test's tolerances (tests/test_models.py:98)
ROT_E_RTOL, ROT_F_RTOL, ROT_F_ATOL = 1e-4, 2e-3, 2e-4
#: (layers, channels, radial basis) of the two configs
WIDTHS = {"reduced": (2, 8, 4), "full_width": (5, 32, 8)}
CONFIGS = list(WIDTHS)
SHAPES = ["full_graph_sm", "minibatch_lg", "ogb_products", "molecule"]
#: the padded batch: three molecules of 6, 5 and 4 atoms, then 5 pads
N_GRAPHS, N_ATOMS, N_REAL = 3, 20, 15
ISOLATED, STRAY, FAR = 14, 13, 10
#: the reference smoke test's shapes (tests/test_configs_smoke.py:107,
#: and the GNN smoke's full_graph_sm)
SMOKE = {
    "molecule": ShapeCell("molecule", "graph_train", n_nodes=8, n_edges=16,
                          batch=4, d_feat=16, n_classes=4),
    "full_graph_sm": ShapeCell("full_graph_sm", "graph_train", n_nodes=64,
                               n_edges=256, d_feat=64, n_classes=7),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small CPU work: one intra-op thread runs it fastest beside the
    suite's other workers; the setting is restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_cfg(name, dtype=torch.float32):
    L, C, R = WIDTHS[name]
    return eq.NequIPConfig(name, n_layers=L, channels=C, n_rbf=R, dtype=dtype)


def jax_cfg(name):
    from repro.models.equivariant import NequIPConfig
    L, C, R = WIDTHS[name]
    return NequIPConfig(name, n_layers=L, channels=C, n_rbf=R)


def padded_batch():
    """The seeded padded batch (module docstring) as numpy arrays, with
    seeded energy and force targets."""
    rng = np.random.default_rng(11)
    sizes = (6, 5, 4)
    starts = np.cumsum((0,) + sizes)
    pos = np.zeros((N_ATOMS, 3), np.float32)
    graph_id = np.empty(N_ATOMS, np.int32)
    for g, (a, b) in enumerate(zip(starts[:-1], starts[1:])):
        pos[a:b] = rng.normal(size=(b - a, 3)) * 1.2 + 20.0 * g
        graph_id[a:b] = g
    pos[FAR] = pos[6] + [6.5, 0.0, 0.0]                 # beyond the cutoff
    pos[N_REAL:] = rng.normal(size=(N_ATOMS - N_REAL, 3))
    graph_id[STRAY] = N_GRAPHS                           # a real atom, dropped
    graph_id[N_REAL:] = [-1, N_GRAPHS, N_GRAPHS + 4, -1, 0]
    species = rng.integers(0, 8, N_ATOMS).astype(np.int32)
    species[3], species[N_REAL] = 11, -3                 # clipped to 7, 0
    edges = []
    for a, b in zip(starts[:-1], starts[1:]):
        for i in range(a, b):
            for j in range(a, b):
                if i != j and ISOLATED not in (i, j) and FAR not in (i, j) \
                        and rng.random() < 0.6:
                    edges.append((i, j, True))
    edges += [(1, 2, True), (1, 2, True),                # a duplicate edge
              (6, FAR, True), (FAR, 9, True),            # beyond, inside
              (0, 4, False),                             # masked, real atoms
              (19, 19, False), (19, 19, False), (18, 18, False),
              (25, -3, False)]                           # clipped, masked
    src, dst, mask = map(np.array, zip(*edges))
    arrays = eq.AtomsBatch(
        species=species, pos=pos.astype(np.float32),
        edge_src=src.astype(np.int32), edge_dst=dst.astype(np.int32),
        edge_mask=mask.astype(bool), node_mask=np.arange(N_ATOMS) < N_REAL,
        graph_id=graph_id)
    e_t = rng.normal(size=N_GRAPHS).astype(np.float32)
    f_t = (rng.normal(size=(N_ATOMS, 3)) * 0.1).astype(np.float32)
    return arrays, e_t, f_t


def port_batch(arrays, device="cpu"):
    return eq.AtomsBatch(*(torch.from_numpy(np.array(a)).to(device)
                           for a in arrays))


def jax_batch(arrays):
    import jax.numpy as jnp
    from repro.models.equivariant import AtomsBatch
    return AtomsBatch(*(jnp.asarray(a) for a in arrays))


@functools.lru_cache(maxsize=None)
def jax_params(name):
    """The reference's seeded weights (``PRNGKey(0)``)."""
    import jax
    from repro.models import equivariant as je
    init = jax.jit(je.init_nequip_params, static_argnums=1)
    return jax.tree_util.tree_map(np.asarray,
                                  init(jax.random.PRNGKey(0), jax_cfg(name)))


def leaves_np(tree):
    import jax
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def assert_trees_close(got, want, rtol, atol):
    got, want = tree_leaves(eq.params_to_numpy(got)), leaves_np(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


# ------------------------------------------------ radial basis, tensors --

def radii(case):
    """``r`` in f32: a self-loop's ``‖0 + 1e-12‖``, seeded radii inside
    the cutoff, and radii at and beyond it."""
    if case == "self_loop":
        d = np.zeros((4, 3), np.float32) + np.float32(1e-12)
        return np.sqrt(np.sum(d * d, -1)), np.zeros((4, 3), np.float32)
    rng = np.random.default_rng(2)
    r = rng.uniform(0.3, 4.9, 16) if case == "inside" else \
        np.array([5.0, 5.0001, 5.5, 7.0, 100.0])
    u = rng.normal(size=(len(r), 3))
    disp = u / np.linalg.norm(u, axis=-1, keepdims=True) * r[:, None]
    return r.astype(np.float32), disp.astype(np.float32)


@pytest.mark.parametrize("case", ["self_loop", "inside", "beyond"])
def test_bessel_rbf_and_traceless_match_jax(case):
    """The basis and its derivative by ``r``, and the l = 2 part of r̂
    (``_traceless(r̂ r̂ᵀ)``, r̂ = disp / max(r, 1e-9)) and the derivative
    of r̂ and of it by the displacement: at a self-loop r̂'s is of order
    1e9, the source of the reference's force fault."""
    import jax
    import jax.numpy as jnp
    from repro.models import equivariant as je

    r, disp = radii(case)
    rng = np.random.default_rng(3)
    up_b = rng.normal(size=(len(r), 8)).astype(np.float32)
    up_v = rng.normal(size=(len(r), 3)).astype(np.float32)
    up_t = rng.normal(size=(len(r), 3, 3)).astype(np.float32)

    def j_rr(d, rad):
        rhat = d / jnp.maximum(rad, 1e-9)[:, None]
        return je._traceless(rhat[:, :, None] * rhat[:, None, :])

    def j_up(d, rad):
        rhat = d / jnp.maximum(rad, 1e-9)[:, None]
        return jnp.sum(rhat * up_v) + jnp.sum(j_rr(d, rad) * up_t)

    def j_all(r, disp):
        return (je.bessel_rbf(r, 8, 5.0),
                jax.grad(lambda x: jnp.sum(je.bessel_rbf(x, 8, 5.0) * up_b))(r),
                j_rr(disp, r), jax.grad(j_up)(disp, r))

    want_b, want_db, want_t, want_dt = map(np.asarray, jax.jit(j_all)(
        jnp.asarray(r), jnp.asarray(disp)))

    rt = torch.from_numpy(r).requires_grad_(True)
    b = eq.bessel_rbf(rt, 8, 5.0)
    (db,) = torch.autograd.grad(torch.sum(b * torch.from_numpy(up_b)), rt)
    dt_in = torch.from_numpy(disp).requires_grad_(True)
    rad = torch.from_numpy(r)
    rhat = dt_in / torch.maximum(rad, rad.new_tensor(1e-9))[:, None]
    t = eq._traceless(rhat[:, :, None] * rhat[:, None, :])
    (dt,) = torch.autograd.grad(torch.sum(rhat * torch.from_numpy(up_v))
                                + torch.sum(t * torch.from_numpy(up_t)), dt_in)
    np.testing.assert_allclose(b.detach().numpy(), want_b, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(db.numpy(), want_db, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    np.testing.assert_allclose(t.detach().numpy(), want_t, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(dt.numpy(), want_dt, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    if case == "beyond":
        assert not b.detach()[1:].any()         # the envelope is 0 there
    if case == "self_loop":
        assert float(r[0]) == pytest.approx(1.7320508e-12)
        assert np.abs(want_dt).max() > 1e8


# ------------------------------------------------ forward and gradients --

@functools.lru_cache(maxsize=None)
def jax_reference(name):
    """The reference's energies, forces, and both losses with every
    gradient on the padded batch, in one jitted program."""
    import jax
    import jax.numpy as jnp
    from repro.models import equivariant as je

    arrays, e_t, f_t = padded_batch()
    cfg = jax_cfg(name)

    def fn(params, batch):
        def energy(pos):
            return jnp.sum(je.nequip_forward(params, cfg,
                                             batch._replace(pos=pos),
                                             N_GRAPHS))
        return (je.nequip_forward(params, cfg, batch, N_GRAPHS),
                -jax.grad(energy)(batch.pos),
                jax.value_and_grad(je.nequip_energy_loss)(
                    params, cfg, batch, e_t, N_GRAPHS),
                jax.value_and_grad(je.nequip_force_loss)(
                    params, cfg, batch, e_t, f_t, 1.0, N_GRAPHS))

    out = jax.jit(fn)(jax_params(name), jax_batch(arrays))
    return jax.tree_util.tree_map(np.asarray, out)


def port_inputs(name, device="cpu", params=None):
    arrays, e_t, f_t = padded_batch()
    params = params if params is not None else \
        eq.params_from_numpy(jax_params(name))
    return (tree_map(lambda x: x.to(device), params), port_cfg(name),
            port_batch(arrays, device), torch.from_numpy(e_t).to(device),
            torch.from_numpy(f_t).to(device))


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_and_forces_match_jax(name):
    """Energies and forces: the stray atom's energy is dropped (graph 2
    holds the isolated atom only), its force is not."""
    params, cfg, batch, _, _ = port_inputs(name)
    e, forces = eq.energies_and_forces(params, cfg, batch, N_GRAPHS,
                                       create_graph=False)
    want_e, want_f = jax_reference(name)[:2]
    assert e.dtype == torch.float32 and tuple(e.shape) == (N_GRAPHS,)
    np.testing.assert_allclose(e.detach().numpy(), want_e, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(forces.numpy(), want_f, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    with torch.no_grad():
        np.testing.assert_array_equal(
            eq.nequip_forward(params, cfg, batch, N_GRAPHS).numpy(),
            e.detach().numpy())
    f = forces.numpy()
    assert np.abs(f[STRAY]).max() > 1e-4                 # it still interacts
    assert not f[ISOLATED].any() and not f[N_REAL:].any()


@pytest.mark.parametrize("name", CONFIGS)
def test_energy_loss_and_every_gradient_match_jax(name):
    params, cfg, batch, e_t, _ = port_inputs(name)
    loss, grads = steps._value_and_grad(
        lambda p: eq.nequip_energy_loss(p, cfg, batch, e_t, N_GRAPHS), params)
    want_loss, want_grads = jax_reference(name)[2]
    np.testing.assert_allclose(float(loss), want_loss, rtol=RTOL, atol=ATOL)
    assert_trees_close(grads, want_grads, GRAD_RTOL, GRAD_ATOL)


@pytest.mark.parametrize("name", CONFIGS)
def test_force_loss_and_every_gradient_match_jax(name):
    """The second-order gradient: every parameter's, through the forces
    that autograd took inside the loss."""
    params, cfg, batch, e_t, f_t = port_inputs(name)
    loss, grads = steps._value_and_grad(
        lambda p: eq.nequip_force_loss(p, cfg, batch, e_t, f_t, 1.0,
                                       N_GRAPHS), params)
    want_loss, want_grads = jax_reference(name)[3]
    np.testing.assert_allclose(float(loss), want_loss, rtol=RTOL, atol=ATOL)
    assert_trees_close(grads, want_grads, GRAD_RTOL, GRAD_ATOL)
    _, energy_grads = jax_reference(name)[2]
    differs = [float(np.abs(a - b).max()) for a, b in
               zip(leaves_np(want_grads), leaves_np(energy_grads))]
    assert min(differs) > 100 * GRAD_ATOL    # the force term reached each


def test_readout_drops_ids_outside_the_graphs():
    """``segment_sum``'s FILL_OR_DROP: ids below 0 or at ``n_graphs`` and
    beyond are dropped (not wrapped), their energies and gradients 0;
    ``index_add`` alone would raise on such an id."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    e_atom = rng.normal(size=9).astype(np.float32)
    ids = np.array([0, -1, 1, 2, 5, 1, -7, 0, 1], np.int32)
    up = rng.normal(size=2).astype(np.float32)

    def j_sum(x):
        return jax.ops.segment_sum(x, jnp.asarray(ids), num_segments=2)

    want = np.asarray(j_sum(jnp.asarray(e_atom)))
    want_grad = np.asarray(jax.grad(lambda x: jnp.sum(j_sum(x) * up))(
        jnp.asarray(e_atom)))
    x = torch.from_numpy(e_atom).requires_grad_(True)
    got = eq._readout_sum(x, torch.from_numpy(ids), 2)
    (grad,) = torch.autograd.grad(torch.sum(got * torch.from_numpy(up)), x)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(grad.numpy(), want_grad)
    assert not grad.numpy()[[1, 3, 4, 6]].any()
    np.testing.assert_allclose(want, [e_atom[[0, 7]].sum(),
                                      e_atom[[2, 5, 8]].sum()], rtol=1e-6)
    with pytest.raises((IndexError, RuntimeError)):
        torch.zeros(2).index_add(0, torch.from_numpy(ids), x.detach())


# ------------------------------------------- the reference's own fault --

def property_graph():
    """The reference property test's graph (tests/test_models.py:98, seed
    3): 10 atoms, 36 random edges, among them the self-loops 27 (atom 8)
    and 35 (atom 6), unmasked."""
    rng = np.random.default_rng(3)
    N, E = 10, 36
    pos = rng.normal(size=(N, 3)) * 1.5
    return eq.AtomsBatch(
        species=rng.integers(0, 4, N).astype(np.int32),
        pos=pos.astype(np.float32),
        edge_src=rng.integers(0, N, E).astype(np.int32),
        edge_dst=rng.integers(0, N, E).astype(np.int32),
        edge_mask=np.ones(E, bool), node_mask=np.ones(N, bool),
        graph_id=np.zeros(N, np.int32))


def test_unmasked_self_loop_force_is_wrong_in_both_packages():
    """At an unmasked self-loop r = ‖0 + 1e-12‖ ≈ 1.7e-12, r̂'s cotangent
    is of order 1e9 and cancels between the gathers ``pos[src]`` and
    ``pos[dst]`` of one row: in f32 both packages' forces at atoms 6 and
    8 are off the f64 forces (the port's f64 and the reference's under
    x64 agree within 1e-12) by more than 1e-3 (read: 0.0832 at atom 6,
    0.0358 at atom 8; the largest force is 0.119); every other atom is
    within the gradient tolerance of JAX and within 2e-7 of f64."""
    import jax
    import jax.numpy as jnp
    from repro.models import equivariant as je

    arrays = property_graph()
    loops = sorted({int(s) for s, d in zip(arrays.edge_src, arrays.edge_dst)
                    if s == d})
    assert loops == [6, 8]
    cfg_j = je.NequIPConfig("t", n_layers=2, channels=8, n_rbf=4)
    params = jax_params("reduced")

    def j_forces(p, cfg, b):
        return -jax.grad(lambda x: jnp.sum(je.nequip_forward(
            p, cfg, b._replace(pos=x))))(b.pos)

    want32 = np.asarray(jax.jit(j_forces, static_argnums=1)(
        params, cfg_j, jax_batch(arrays)))
    with jax.enable_x64(True):
        cfg64 = dataclasses.replace(cfg_j, dtype=jnp.float64)
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     params)
        b64 = jax_batch(arrays)
        b64 = b64._replace(pos=jnp.asarray(arrays.pos, jnp.float64))
        want64 = np.asarray(jax.jit(j_forces, static_argnums=1)(
            p64, cfg64, b64))
    cfg = port_cfg("reduced")
    mine = eq.params_from_numpy(params)
    got32 = eq.energies_and_forces(mine, cfg, port_batch(arrays),
                                   create_graph=False)[1].numpy()
    b = port_batch(arrays)
    got64 = eq.energies_and_forces(
        tree_map(torch.Tensor.double, mine),
        port_cfg("reduced", torch.float64), b._replace(pos=b.pos.double()),
        create_graph=False)[1].numpy()
    np.testing.assert_allclose(got64, want64, rtol=1e-10, atol=1e-12)
    others = np.setdiff1d(np.arange(10), loops)
    for f32 in (want32, got32):
        off = np.abs(f32 - want64).max(1)
        assert (off[loops] > 1e-3).all(), off
        assert off[others].max() < 2e-7, off
    np.testing.assert_allclose(got32[others], want32[others],
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


# ------------------------------------------------ the symmetry property --

def fixed_frame_traceless(t):
    """A planted fault: the l = 2 part with a term fixed in the lab frame
    (0.05 e_x e_xᵀ), which no rotation carries along."""
    ex = torch.zeros(3, 3, dtype=t.dtype, device=t.device)
    ex[0, 0] = 0.05
    return _TRACELESS(t) + ex


_TRACELESS = eq._traceless


def symmetry_errors(params, cfg, batch, n_graphs):
    """(energy error, force error) under a seeded rotation R and
    translation b: each the largest excess over the reference test's
    tolerance of ``E(Rx + b)`` against ``E(x)`` and of ``F(Rx + b)``
    against ``R F(x)``; both ≤ 0 where the property holds."""
    from scipy.spatial.transform import Rotation

    R = torch.from_numpy(Rotation.random(random_state=1).as_matrix()
                         .astype(np.float32)).to(batch.pos.device)
    shift = batch.pos.new_tensor([0.7, -1.3, 2.1])
    e0, f0 = eq.energies_and_forces(params, cfg, batch, n_graphs,
                                    create_graph=False)
    moved = batch._replace(pos=batch.pos @ R.T + shift)
    e1, f1 = eq.energies_and_forces(params, cfg, moved, n_graphs,
                                    create_graph=False)
    e0, e1 = e0.detach(), e1.detach()
    want_f = f0 @ R.T
    e_err = float(((e1 - e0).abs() - ROT_E_RTOL * e0.abs()).max())
    f_err = float(((f1 - want_f).abs() - ROT_F_ATOL
                   - ROT_F_RTOL * want_f.abs()).max())
    return e_err, f_err


@pytest.mark.parametrize("fault", [None, "fixed_frame"])
@pytest.mark.parametrize("name", CONFIGS)
def test_rotation_and_translation_property(name, fault):
    """Energies invariant and forces rotating with the frame, to the
    reference test's tolerances, on the padded batch; the planted
    fixed-frame term breaks the energies' invariance beyond them."""
    params, cfg, batch, _, _ = port_inputs(name)
    patch = mock.patch.object(eq, "_traceless", fixed_frame_traceless) \
        if fault else mock.patch.object(eq, "_traceless", _TRACELESS)
    with patch:
        e_err, f_err = symmetry_errors(params, cfg, batch, N_GRAPHS)
    if fault is None:
        assert e_err <= 0 and f_err <= 0, (e_err, f_err)
    else:
        assert e_err > 1e-4, e_err


# ------------------------------------------------------- abstract cells --

@pytest.mark.parametrize("shape", SHAPES)
def test_abstract_cells_match_reference(shape):
    """``model_flops`` and every abstract input's shape and dtype equal
    the reference's (``jax.eval_shape``), full config; the sizes are the
    reference's padded ones."""
    import jax
    from repro.configs.registry import get_config
    from repro.launch import steps as jsteps

    mine = steps.build_cell(registry.get_config("nequip"), shape)
    want = jsteps.build_cell(get_config("nequip"), shape, None)
    assert mine.model_flops == want.model_flops
    got_l = tree_leaves(mine.abstract_inputs)
    ref_l = jax.tree.leaves(want.abstract_inputs)
    assert all(x.device.type == "meta" for x in got_l)
    assert [tuple(x.shape) for x in got_l] == [x.shape for x in ref_l]
    assert [str(x.dtype).split(".")[-1] for x in got_l] == \
        [x.dtype.name for x in ref_l]
    batch, targets = mine.abstract_inputs[2:]
    sizes = {"molecule": (4096, 8192, 128),
             "full_graph_sm": (3072, 10752, 1),
             "minibatch_lg": (169_984, 169_984, 1),
             "ogb_products": (2_449_408, 61_859_328, 1)}[shape]
    assert (batch.pos.shape[0], batch.edge_src.shape[0],
            targets.shape[0]) == sizes


# ---------------------------------------------------- build_cell steps --

def seeded_state(params_np, seed=7):
    """AdamW moments at step 1000 drawn from a seed, the same for both
    packages (as in tests/test_torch_train.py): lr 5e-3 there, and with
    zero moments Adam's first update is the sign of each gradient, which
    rounding flips where a gradient is near 0."""
    rng = np.random.default_rng(seed)
    m = tree_map(lambda p: (rng.normal(size=p.shape) * 1e-3)
                 .astype(np.float32), params_np)
    v = tree_map(lambda p: (rng.uniform(0.5, 1.5, size=p.shape) * 1e-6)
                 .astype(np.float32), params_np)
    return np.int32(1000), m, v


def smoke_batch(cell, n, e, seed):
    """Seeded molecules (or one point cloud) of the smoke shape padded to
    ``n`` atoms and ``e`` edges: real edges i ≠ j inside a molecule, pad
    atoms masked with graph ids -1 and ``n_graphs``, pad edges masked
    self-loops at the last row; energy targets seeded."""
    rng = np.random.default_rng(seed)
    per, graphs = (cell.n_nodes, cell.batch) if cell.name == "molecule" \
        else (cell.n_nodes, 1)
    real_n, real_e = per * graphs, cell.n_edges * graphs
    pos = (rng.normal(size=(n, 3)) * 1.5).astype(np.float32)
    graph_id = np.where(np.arange(n) % 2 == 0, -1, graphs).astype(np.int32)
    graph_id[:real_n] = np.arange(real_n) // per
    src = np.full(e, n - 1, np.int32)
    dst = np.full(e, n - 1, np.int32)
    for g in range(graphs):
        s = rng.integers(0, per, cell.n_edges)
        d = (s + rng.integers(1, per, cell.n_edges)) % per
        src[g * cell.n_edges:(g + 1) * cell.n_edges] = s + g * per
        dst[g * cell.n_edges:(g + 1) * cell.n_edges] = d + g * per
    arrays = eq.AtomsBatch(
        species=rng.integers(0, 4, n).astype(np.int32), pos=pos,
        edge_src=src, edge_dst=dst, edge_mask=np.arange(e) < real_e,
        node_mask=np.arange(n) < real_n, graph_id=graph_id)
    return arrays, rng.normal(size=graphs).astype(np.float32)


def smoke_arch(shape, package):
    shapes = {shape: SMOKE[shape]}
    if package == "port":
        return dataclasses.replace(registry.get_config("nequip", True),
                                   shapes=shapes)
    from repro.configs.registry import get_config
    return dataclasses.replace(get_config("nequip", True), shapes=shapes)


def smoke_batches(shape):
    cell = steps.build_cell(smoke_arch(shape, "port"), shape)
    b_abs = cell.abstract_inputs[2]
    n, e = b_abs.pos.shape[0], b_abs.edge_src.shape[0]
    return [smoke_batch(SMOKE[shape], n, e, seed) for seed in range(3)]


@functools.lru_cache(maxsize=None)
def jax_three_steps(shape):
    import jax
    import jax.numpy as jnp
    from repro.launch import steps as jsteps
    from repro.optim.adamw import AdamWState as JAdamWState

    fn = jax.jit(jsteps.build_cell(smoke_arch(shape, "jax"), shape,
                                   None).fn)
    step, m, v = seeded_state(jax_params("reduced"))
    params = jax.tree_util.tree_map(jnp.asarray, jax_params("reduced"))
    opt = JAdamWState(step=jnp.asarray(step), m=m, v=v)
    losses = []
    for arrays, targets in smoke_batches(shape):
        params, opt, loss = fn(params, opt, jax_batch(arrays),
                               jnp.asarray(targets))
        losses.append(float(loss))
    return (losses, jax.tree_util.tree_map(np.asarray, params),
            jax.tree_util.tree_map(np.asarray, opt))


@pytest.mark.parametrize("shape", list(SMOKE))
def test_build_cell_three_train_steps_match_jax(shape):
    """The reference's jitted train step against the port's eager one
    (schedule, loss and gradients — second order on ``molecule`` —,
    clipping, AdamW) three times from a warm AdamW state, reduced config
    at the reference smoke shapes (512 atoms, 512 edges padded)."""
    cell = steps.build_cell(smoke_arch(shape, "port"), shape)
    params_np = jax_params("reduced")
    params = eq.params_from_numpy(params_np)
    step, m, v = seeded_state(params_np)
    opt = AdamWState(step=torch.tensor(step, dtype=torch.int32),
                     m=eq.params_from_numpy(m), v=eq.params_from_numpy(v))
    losses = []
    for arrays, targets in smoke_batches(shape):
        params, opt, loss = cell.fn(params, opt, port_batch(arrays),
                                    torch.from_numpy(targets))
        losses.append(float(loss))
    want_losses, want_params, want_opt = jax_three_steps(shape)
    np.testing.assert_allclose(losses, want_losses, rtol=RTOL, atol=ATOL)
    assert int(opt.step) == int(want_opt.step) == 1003
    for got, want in ((params, want_params), (opt.m, want_opt.m),
                      (opt.v, want_opt.v)):
        assert_trees_close(got, want, GRAD_RTOL, GRAD_ATOL)
    moved = min(float(np.abs(a - b).max()) for a, b in
                zip(tree_leaves(eq.params_to_numpy(params)),
                    leaves_np(params_np)))
    assert moved > 100 * GRAD_ATOL          # every tensor's update shows
    assert cell.note == ("energies and forces" if shape == "molecule"
                         else "energies")


# ---------------------------------------------------- configs and trees --

def test_configs_match_reference():
    from repro.configs.registry import get_config

    for reduced in (False, True):
        mine, want = registry.get_config("nequip", reduced), \
            get_config("nequip", reduced)
        assert (mine.arch_id, mine.family, mine.source) == \
            (want.arch_id, want.family, want.source)
        assert {k: dataclasses.asdict(v) for k, v in mine.shapes.items()} \
            == {k: dataclasses.asdict(v) for k, v in want.shapes.items()}
        assert mine.shapes == gnn_shapes()
        fields = dataclasses.asdict(mine.model)
        ref = dataclasses.asdict(want.model)
        assert fields.pop("dtype") == torch.float32
        assert ref.pop("dtype").__name__ == "float32"
        assert fields == ref
    assert (registry.get_config("nequip").model.n_layers,
            registry.get_config("nequip").model.channels) == (5, 32)
    assert "nequip" in registry.ARCH_IDS


def test_params_round_trip_and_init_shapes():
    want = jax_params("full_width")
    back = eq.params_to_numpy(eq.params_from_numpy(want))
    assert [a.tobytes() for a in leaves_np(back)] == \
        [a.tobytes() for a in leaves_np(want)]
    cfg = port_cfg("full_width")
    mine = eq.init_nequip_params(torch.Generator().manual_seed(0), cfg)
    assert [tuple(x.shape) for x in tree_leaves(mine)] == \
        [a.shape for a in leaves_np(want)]
    assert [tuple(x.shape) for x in tree_leaves(mine)] == \
        [tuple(x.shape) for x in tree_leaves(eq.abstract_nequip_params(cfg))]
    assert all(x.device.type == "meta"
               for x in tree_leaves(eq.abstract_nequip_params(cfg)))
    # the embedding at the reference's 0.5, each matrix at 1/sqrt(fan-in)
    for path, x in leaves_with_paths(mine):
        scale = 0.5 if path == "embed" else x.shape[0] ** -0.5
        if x.numel() >= 256:
            assert 0.85 < float(x.std()) / scale < 1.15, path
    again = eq.init_nequip_params(torch.Generator().manual_seed(0), cfg)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(mine), tree_leaves(again)))


# ------------------------------------------------------------- the card --

@pytest.mark.gpu
@pytest.mark.parametrize("name", CONFIGS)
def test_cuda_nequip_matches_cpu(name):
    """One set of seeded weights on both devices: energies, forces and
    every gradient of both losses within 1e-4 (the card adds messages by
    atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the card's path runs only there")
    params = eq.init_nequip_params(torch.Generator().manual_seed(0),
                                   port_cfg(name))
    results = []
    for device in ("cpu", "cuda"):
        p, cfg, batch, e_t, f_t = port_inputs(name, device, params)
        e, forces = eq.energies_and_forces(p, cfg, batch, N_GRAPHS,
                                           create_graph=False)
        le = steps._value_and_grad(
            lambda q: eq.nequip_energy_loss(q, cfg, batch, e_t, N_GRAPHS), p)
        lf = steps._value_and_grad(
            lambda q: eq.nequip_force_loss(q, cfg, batch, e_t, f_t, 1.0,
                                           N_GRAPHS), p)
        results.append(tree_map(lambda x: x.detach().cpu(),
                                (e, forces, le, lf)))
    for a, b in zip(tree_leaves(results[1]), tree_leaves(results[0])):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
