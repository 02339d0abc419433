"""The recsys slice of the port against the JAX package, on the CPU:
``models/recsys.py``'s ``embedding_bag``, AutoInt's forward,
``autoint_loss`` and every gradient (the table's included, with the
reference's weights through ``params_from_numpy``), the tie rules that
decide the loss's gradient at a zero logit, ``retrieval_score``'s top-k
with exact ties, ``SyntheticCTR``'s batches, two ``build_cell`` train
steps and the serve and retrieval cells, the abstract cells at the four
recsys shapes and the config.

Two configs: the reduced one at the reference smoke test's batch of 16,
and the full widths (39 fields, d 16, 3 layers of 2 × 32 heads, MLP
400-400) with the vocabulary cut to 4,096 a field, at a batch of 64.
Each batch holds an id at ``vocab - 1``, ids clipped from above and
below, one id twice in a bag and masked slots.  The reference's outputs
are built once per module (``lru_cache``); JAX is imported inside the
tests that compare with it, so the ``gpu`` test also runs on a machine
that has a card and no JAX."""
import dataclasses
import functools
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import ShapeCell
from repro_torch.data import SyntheticCTR, batch_to_device
from repro_torch.launch import steps
from repro_torch.models import recsys
from repro_torch.optim import AdamWState
from repro_torch.tree import leaves_with_paths, tree_leaves, tree_map

#: ROADMAP's f32 tolerances for values; gradients, moments and parameters
#: after train steps at rtol 1e-5 with atol 2e-6 (ROADMAP)
RTOL, ATOL = 1e-5, 2e-5
GRAD_RTOL, GRAD_ATOL = RTOL, 2e-6
#: the full widths' train steps at an atol of 1e-5: in the first step's
#: batch (seed 0) example 59's second MLP layer has a pre-activation of
#: 1.76e-9, within rounding of 0, and XLA's and torch's products put it
#: on opposite sides of the ReLU.  That example's gradient then differs
#: by one unit's path (8.5e-6 on ``mlp/1``, 2.8e-5 on table entries, at
#: rtol 1e-5 with everything else within 2e-6), and after AdamW (lr 1e-3,
#: √v̂ ≈ 1e-3) the parameters by up to 6.4e-6 after two steps
STEP_ATOL = {"reduced": GRAD_ATOL, "full_cut": 1e-5}
#: the two configs' cut of the vocabulary and their batches
FULL_CUT_VOCAB = 4096
BATCH = {"reduced": 16, "full_cut": 64}
CONFIGS = list(BATCH)
SHAPES = ["train_batch", "serve_p99", "serve_bulk", "retrieval_cand"]
#: the retrieval tests' candidates and the rows planted as exact ties
N_CAND, TOP = 4096, 100


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small CPU work: one intra-op thread runs it fastest beside the
    suite's other workers; the setting is restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_cfg(name):
    if name == "reduced":
        return registry.get_config("autoint", reduced=True).model
    return dataclasses.replace(registry.get_config("autoint").model,
                               vocab_per_field=FULL_CUT_VOCAB)


def jax_cfg(name):
    from repro.configs.registry import get_config
    if name == "reduced":
        return get_config("autoint", reduced=True).model
    return dataclasses.replace(get_config("autoint").model,
                               vocab_per_field=FULL_CUT_VOCAB)


def batch_np(name, seed, batch=None):
    """``SyntheticCTR``'s batch with planted edge cases: example 0's
    field 0 bags ``vocab - 1``, ``vocab + 7`` (clipped to ``vocab - 1``)
    and 3; example 1's field 1 bags -4 (clipped to 0) and one id twice;
    example 2's bags hold their first id only."""
    cfg = port_cfg(name)
    b = SyntheticCTR(cfg, batch or BATCH[name], seed=seed).batch_at(seed)
    ids, mask = b.ids.copy(), b.bag_mask.copy()
    V = cfg.vocab_per_field
    ids[0, 0] = [V - 1, V + 7, 3]
    mask[0, 0] = 1
    ids[1, 1] = [-4, 5, 5]
    mask[1, 1] = 1
    mask[2, :, 1:] = 0
    return recsys.RecsysBatch(ids, mask, b.labels)


def port_batch(arrays, device="cpu"):
    return recsys.RecsysBatch(*(torch.from_numpy(np.array(a)).to(device)
                                for a in arrays))


def jax_batch(arrays):
    import jax.numpy as jnp
    from repro.models import recsys as jr
    return jr.RecsysBatch(*(jnp.asarray(a) for a in arrays))


@functools.lru_cache(maxsize=None)
def jax_params(name):
    """The reference's seeded weights (``PRNGKey(0)``), drawn by one
    jitted init."""
    import jax
    from repro.models import recsys as jr
    init = jax.jit(jr.init_autoint_params, static_argnums=1)
    return jax.tree_util.tree_map(np.asarray,
                                  init(jax.random.PRNGKey(0), jax_cfg(name)))


def leaves_np(tree):
    import jax
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def assert_trees_close(got, want, rtol, atol):
    got, want = tree_leaves(recsys.params_to_numpy(got)), leaves_np(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


# ------------------------------------------------------- embedding bag --

def test_embedding_bag_matches_reference_and_loop():
    """The bag sum and its table gradient against the reference's and
    ``tests/test_models.py``'s loop: masked slots, an id at ``V - 1`` and
    one id twice in a bag (its row's gradient counted twice)."""
    import jax
    import jax.numpy as jnp
    from repro.models import recsys as jr

    rng = np.random.default_rng(4)
    V, d, B, F, G = 50, 8, 4, 3, 3
    table = rng.normal(size=(F * V, d)).astype(np.float32)
    ids = rng.integers(0, V, (B, F, G)).astype(np.int32)
    ids[0, 0, 0] = V - 1
    ids[1, 2, 1] = ids[1, 2, 2]
    mask = (rng.random((B, F, G)) < 0.7).astype(np.float32)
    mask[1, 2, 1:] = 1
    offsets = np.arange(F, dtype=np.int32) * V
    up = rng.normal(size=(B, F, d)).astype(np.float32)

    def jloss(t):
        return jnp.sum(jr.embedding_bag(t, ids, mask, offsets) * up)

    want_out = np.asarray(jr.embedding_bag(table, ids, mask, offsets))
    want_grad = np.asarray(jax.grad(jloss)(table))
    t = torch.from_numpy(table).requires_grad_(True)
    out = recsys.embedding_bag(t, torch.from_numpy(ids),
                               torch.from_numpy(mask),
                               torch.from_numpy(offsets))
    torch.sum(out * torch.from_numpy(up)).backward()
    expected = np.zeros((B, F, d), np.float32)
    for b in range(B):
        for f in range(F):
            for g in range(G):
                expected[b, f] += mask[b, f, g] * table[ids[b, f, g] + f * V]
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(out.detach().numpy(), expected, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), want_grad, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


# ------------------------------------------------ forward and gradients --

@functools.lru_cache(maxsize=None)
def jax_reference(name, seed):
    """The reference's logits, ``autoint_loss`` and every gradient on the
    seeded batch, in one jitted program."""
    import jax
    from repro.models import recsys as jr

    def fn(params, cfg, batch):
        return jr.autoint_forward(params, cfg, batch), \
            jax.value_and_grad(jr.autoint_loss)(params, cfg, batch)

    logits, (loss, grads) = jax.jit(fn, static_argnums=1)(
        jax_params(name), jax_cfg(name), jax_batch(batch_np(name, seed)))
    return (np.asarray(logits), float(loss),
            jax.tree_util.tree_map(np.asarray, grads))


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_matches_jax(name):
    got = recsys.autoint_forward(
        recsys.params_from_numpy(jax_params(name)), port_cfg(name),
        port_batch(batch_np(name, 1)))
    assert got.dtype == torch.float32 and got.shape == (BATCH[name],)
    np.testing.assert_allclose(got.numpy(), jax_reference(name, 1)[0],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", CONFIGS)
def test_loss_and_every_gradient_match_jax(name):
    loss, grads = steps.recsys_value_and_grad(
        recsys.params_from_numpy(jax_params(name)), port_cfg(name),
        port_batch(batch_np(name, 1)))
    _, want_loss, want_grads = jax_reference(name, 1)
    np.testing.assert_allclose(float(loss), want_loss, rtol=RTOL, atol=ATOL)
    assert_trees_close(grads, want_grads, GRAD_RTOL, GRAD_ATOL)
    # the clipped and the duplicated ids reached the table's gradient
    table = grads["table"].numpy()
    assert np.abs(table[port_cfg(name).vocab_per_field - 1]).max() > 0


# ------------------------------------------------------------ tie rules --

@functools.lru_cache(maxsize=None)
def tie_case():
    """The reduced weights with ``out`` zero, so every logit is exactly
    0: the loss's gradient there is ``jnp.maximum``'s half, less ``y``,
    less ``jnp.abs``'s full derivative times one half; only ``out``'s
    gradient is not zero."""
    import jax
    from repro.models import recsys as jr

    params = tree_map(np.array, jax_params("reduced"))
    params["out"][:] = 0
    loss, grads = jax.value_and_grad(jr.autoint_loss)(
        params, jax_cfg("reduced"), jax_batch(batch_np("reduced", 2)))
    return params, float(loss), jax.tree_util.tree_map(np.asarray, grads)


@pytest.mark.parametrize("fault", [None, "clamp", "abs"])
def test_tie_rules_decide_the_loss_gradient(fault):
    """The zero-logit case matches the reference; each planted tie-rule
    fault (the maximum by ``torch.clamp``, ``torch.abs``'s zero
    derivative at 0) makes ``out``'s gradient differ from it."""
    params, want_loss, want = tie_case()
    patch = {None: mock.patch.object(recsys, "_abs", recsys._abs),
             "clamp": mock.patch.object(
                 recsys, "_max0", lambda x: torch.clamp(x, min=0.0)),
             "abs": mock.patch.object(recsys, "_abs", torch.abs)}[fault]
    with patch:
        loss, grads = steps.recsys_value_and_grad(
            recsys.params_from_numpy(params), port_cfg("reduced"),
            port_batch(batch_np("reduced", 2)))
    np.testing.assert_allclose(float(loss), want_loss, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(loss), np.log(2), rtol=1e-6)
    close = np.allclose(grads["out"].numpy(), want["out"], rtol=GRAD_RTOL,
                        atol=GRAD_ATOL)
    assert np.abs(want["out"]).max() > 1e-3
    assert close == (fault is None)
    if fault is None:
        assert_trees_close(grads, want, GRAD_RTOL, GRAD_ATOL)


# ------------------------------------------------------------ retrieval --

def tied_candidates(name, query):
    """Seeded [N_CAND, d] candidates where the reference's best row is
    copied into four other rows (two below it, two above) and its 50th
    into two more: exact ties at the top and inside the top 100."""
    from repro.models import recsys as jr

    cfg = jax_cfg(name)
    rng = np.random.default_rng(9)
    cand = rng.normal(size=(N_CAND, cfg.embed_dim)).astype(np.float32)
    _, idx = jr.retrieval_score(jax_params(name), cfg, jax_batch(query),
                                cand, top_k=TOP)
    best, mid = int(idx[0, 0]), int(idx[0, 49])
    cand[[0, best // 2, (best + N_CAND) // 2, N_CAND - 1]] = cand[best]
    cand[[1, N_CAND - 2]] = cand[mid]
    return cand


@pytest.mark.parametrize("name", CONFIGS)
def test_retrieval_score_matches_jax(name):
    """Values and int32 indices equal the reference's, ties broken
    toward the lower index as ``lax.top_k`` breaks them."""
    from repro.models import recsys as jr

    query = tuple(a[:1] for a in batch_np(name, 3))
    cand = tied_candidates(name, query)
    want_v, want_i = jr.retrieval_score(jax_params(name), jax_cfg(name),
                                        jax_batch(query), cand, top_k=TOP)
    vals, idx = recsys.retrieval_score(
        recsys.params_from_numpy(jax_params(name)), port_cfg(name),
        port_batch(query), torch.from_numpy(cand), top_k=TOP)
    assert idx.dtype == torch.int32 and tuple(idx.shape) == (1, TOP)
    np.testing.assert_allclose(vals.numpy(), np.asarray(want_v), rtol=RTOL,
                               atol=ATOL)
    assert np.array_equal(idx.numpy(), np.asarray(want_i))
    top = idx[0, :5].tolist()
    assert top == sorted(top) and vals[0, 0] == vals[0, 4] > vals[0, 5]


# ----------------------------------------------------------------- data --

@pytest.mark.parametrize("seed,step", [(0, 0), (1, 7), (5, 123)])
def test_synthetic_ctr_is_byte_equal(seed, step):
    from repro.data.recsys import SyntheticCTR as JSyntheticCTR

    got = SyntheticCTR(port_cfg("full_cut"), 32, seed=seed).batch_at(step)
    want = JSyntheticCTR(jax_cfg("full_cut"), 32, seed=seed).batch_at(step)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    on_cpu = batch_to_device(got, "cpu")
    assert [t.dtype for t in on_cpu] == [torch.int32, torch.float32,
                                         torch.float32]
    assert all(np.array_equal(t.numpy(), a) for t, a in zip(on_cpu, got))


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


def smoke_arch(name, package):
    """The config with ``train_batch`` at the test's batch."""
    shapes = {"train_batch": ShapeCell("train_batch", "train",
                                       batch=BATCH[name])}
    if package == "port":
        arch = registry.get_config("autoint", reduced=name == "reduced")
        return dataclasses.replace(arch, model=port_cfg(name), shapes=shapes)
    from repro.configs.registry import get_config
    arch = get_config("autoint", reduced=name == "reduced")
    return dataclasses.replace(arch, model=jax_cfg(name), shapes=shapes)


@functools.lru_cache(maxsize=None)
def jax_two_steps(name):
    import jax
    import jax.numpy as jnp
    from repro.launch import steps as jsteps
    from repro.optim.adamw import AdamWState as JAdamWState

    fn = jax.jit(jsteps.build_cell(smoke_arch(name, "jax"), "train_batch",
                                   None).fn)
    step, m, v = seeded_state(jax_params(name))
    params = jax.tree_util.tree_map(jnp.asarray, jax_params(name))
    opt = JAdamWState(step=jnp.asarray(step), m=m, v=v)
    losses = []
    for seed in range(2):
        params, opt, loss = fn(params, opt, jax_batch(batch_np(name, seed)))
        losses.append(float(loss))
    return (losses, jax.tree_util.tree_map(np.asarray, params),
            jax.tree_util.tree_map(np.asarray, opt))


@pytest.mark.parametrize("name", CONFIGS)
def test_build_cell_two_train_steps_match_jax(name):
    """The reference's jitted train step against the port's eager one
    (schedule, loss and gradients, clipping, AdamW over the dense table)
    twice, from a warm AdamW state (step 1000, seeded moments: lr 1e-3)."""
    cell = steps.build_cell(smoke_arch(name, "port"), "train_batch")
    params_np = jax_params(name)
    params = recsys.params_from_numpy(params_np)
    step, m, v = seeded_state(params_np)
    opt = AdamWState(step=torch.tensor(step, dtype=torch.int32),
                     m=recsys.params_from_numpy(m),
                     v=recsys.params_from_numpy(v))
    losses = []
    for seed in range(2):
        params, opt, loss = cell.fn(params, opt,
                                    port_batch(batch_np(name, seed)))
        losses.append(float(loss))
    want_losses, want_params, want_opt = jax_two_steps(name)
    np.testing.assert_allclose(losses, want_losses, rtol=RTOL, atol=ATOL)
    assert int(opt.step) == int(want_opt.step) == 1002
    for got, want in ((params, want_params), (opt.m, want_opt.m),
                      (opt.v, want_opt.v)):
        assert_trees_close(got, want, GRAD_RTOL, STEP_ATOL[name])
    moved = min(float(np.abs(a - b).max()) for a, b in
                zip(tree_leaves(recsys.params_to_numpy(params)),
                    leaves_np(params_np)))
    assert moved > 100 * GRAD_ATOL          # every tensor's update shows


@pytest.mark.parametrize("kind", ["serve_p99", "retrieval_cand"])
def test_serve_and_retrieval_cells_match_jax(kind):
    """The serve cell's logits and the retrieval cell's top 100 against
    the reference's jitted cells, reduced config."""
    import jax
    from repro.launch import steps as jsteps

    from repro.configs.registry import get_config
    name = "reduced"
    arrays = batch_np(name, 4)
    args_np = (arrays,)
    if kind == "retrieval_cand":
        query = tuple(a[:1] for a in arrays)
        args_np = (query, tied_candidates(name, query))
    want = jax.jit(jsteps.build_cell(get_config("autoint", reduced=True),
                                     kind, None).fn)(
        jax_params(name), jax_batch(args_np[0]), *args_np[1:])
    got = steps.build_cell(registry.get_config("autoint", reduced=True),
                           kind).fn(
        recsys.params_from_numpy(jax_params(name)), port_batch(args_np[0]),
        *map(torch.from_numpy, args_np[1:]))
    if kind == "serve_p99":
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=RTOL, atol=ATOL)
        assert got[1].dtype == torch.int32
        assert np.array_equal(got[1].numpy(), np.asarray(want[1]))


# ------------------------------------------------------- abstract cells --

@pytest.mark.parametrize("shape", SHAPES)
def test_abstract_cells_match_reference(shape):
    """``model_flops`` and every abstract input's shape and dtype equal
    the reference's (``jax.eval_shape``), full config: nothing is
    allocated (the table alone is 2.5 GB)."""
    import jax
    from repro.configs.registry import get_config
    from repro.launch import steps as jsteps

    mine = steps.build_cell(registry.get_config("autoint"), shape)
    want = jsteps.build_cell(get_config("autoint"), shape, None)
    assert mine.model_flops == want.model_flops
    got_l = tree_leaves(mine.abstract_inputs)
    ref_l = jax.tree.leaves(want.abstract_inputs)
    assert all(x.device.type == "meta" for x in got_l)
    assert [tuple(x.shape) for x in got_l] == [x.shape for x in ref_l]
    assert [str(x.dtype).split(".")[-1] for x in got_l] == \
        [x.dtype.name for x in ref_l]
    if shape == "train_batch":
        assert mine.model_flops == 3 * 4_203_776 * 65536


# ---------------------------------------------------- configs and trees --

def test_configs_match_reference():
    from repro.configs.registry import get_config

    for reduced in (False, True):
        mine, want = registry.get_config("autoint", reduced), \
            get_config("autoint", reduced)
        assert (mine.arch_id, mine.family, mine.source) == \
            (want.arch_id, want.family, want.source)
        assert {k: dataclasses.asdict(v) for k, v in mine.shapes.items()} \
            == {k: dataclasses.asdict(v) for k, v in want.shapes.items()}
        fields = dataclasses.asdict(mine.model)
        ref = dataclasses.asdict(want.model)
        assert fields.pop("dtype") == torch.float32
        assert ref.pop("dtype").__name__ == "float32"
        assert fields == ref
    assert "autoint" in registry.ARCH_IDS


def test_params_round_trip_and_init_shapes():
    want = jax_params("full_cut")
    back = recsys.params_to_numpy(recsys.params_from_numpy(want))
    assert [a.tobytes() for a in leaves_np(back)] == \
        [a.tobytes() for a in leaves_np(want)]
    cfg = port_cfg("full_cut")
    mine = recsys.init_autoint_params(torch.Generator().manual_seed(0), cfg)
    assert [tuple(x.shape) for x in tree_leaves(mine)] == \
        [a.shape for a in leaves_np(want)]
    assert [tuple(x.shape) for x in tree_leaves(mine)] == \
        [tuple(x.shape) for x in
         tree_leaves(recsys.abstract_autoint_params(cfg))]
    # the table at the reference's 0.01, each matrix at 1/sqrt(fan-in);
    # the reference's layers share one wres, the port's do not
    for path, x in leaves_with_paths(mine):
        scale = 0.01 if path == "table" else x.shape[0] ** -0.5
        if x.numel() >= 256:
            assert 0.9 < float(x.std()) / scale < 1.1, path
    wres = [layer["wres"] for layer in mine["attn"][1:]]
    assert not torch.equal(wres[0], wres[1])


# ------------------------------------------------------------- the card --

@pytest.mark.gpu
@pytest.mark.parametrize("name", CONFIGS)
def test_cuda_recsys_matches_cpu(name):
    """One set of seeded weights on both devices: logits, loss and every
    gradient within 1e-4 (the card adds the table's gradient rows by
    atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the card's path runs only there")
    cfg = port_cfg(name)
    params = recsys.init_autoint_params(torch.Generator().manual_seed(0), cfg)
    on_card = tree_map(lambda x: x.cuda(), params)
    arrays = batch_np(name, 1)
    want = steps.recsys_value_and_grad(params, cfg, port_batch(arrays))
    got = steps.recsys_value_and_grad(on_card, cfg,
                                      port_batch(arrays, "cuda"))
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        torch.testing.assert_close(
            recsys.autoint_forward(on_card, cfg,
                                   port_batch(arrays, "cuda")).cpu(),
            recsys.autoint_forward(params, cfg, port_batch(arrays)),
            rtol=1e-4, atol=1e-4)
