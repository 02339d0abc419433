"""The MoE slice of the port against the JAX package, on the CPU:
``models/moe.py``'s ``moe_ffn`` (group sizes, shared experts, dropping
capacity, an explicit capacity, a decode-sized batch, tied router
probabilities) and ``moe_ffn_reference``; the reduced Qwen1.5-MoE and
Qwen3-MoE configs' ``prefill_step``, ``decode_step`` and ``serve_lm``
(fused and eager), ``lm_loss`` and every gradient, ``build_cell``'s
train steps and a checkpoint round trip, with the reference's weights
(``params_from_numpy``); and both full configs' parameter counts,
abstract shapes and cells' model FLOPs.

The reference's outputs are built once per module (``lru_cache``).  JAX
is imported inside the tests that compare with it, so the ``gpu`` test
also runs on a machine that has a card and no JAX."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeCell
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve, steps, train
from repro_torch.models import moe
from repro_torch.models import transformer as tr
from repro_torch.tree import leaves_with_paths, tree_leaves, tree_map

ARCHS = ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b"]
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: tests/test_torch_train.py's tolerances: ROADMAP's f32 ones for values,
#: an atol of 2e-6 for gradients
RTOL, ATOL = 1e-5, 2e-5
GRAD_RTOL, GRAD_ATOL = RTOL, 2e-6
B, S, Q_BLOCK = 2, 64, 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small CPU work: one intra-op thread runs it fastest beside the
    suite's other workers; the setting is restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t(a):
    return torch.from_numpy(np.array(a))


def f32(x):
    return np.asarray(x, np.float32)


# ---------------------------------------------------------- moe_ffn --

#: (label, MoEConfig fields, d_model, tokens, group_tokens, capacity,
#: zero rows): tests/test_models.py's three setups, then an explicit
#: capacity, a decode-sized batch (G = 1, C = 1) and tied probabilities
CASES = [
    ("groups128", dict(n_experts=8, top_k=2, d_expert=16,
                       capacity_factor=8.0), 32, 128, 128, None, False),
    ("groups32", dict(n_experts=8, top_k=2, d_expert=16,
                      capacity_factor=8.0), 32, 128, 32, None, False),
    ("groups16", dict(n_experts=8, top_k=2, d_expert=16,
                      capacity_factor=8.0), 32, 128, 16, None, False),
    ("shared", dict(n_experts=4, top_k=2, d_expert=8, n_shared=2,
                    capacity_factor=8.0), 16, 32, 32, None, False),
    ("dropping", dict(n_experts=4, top_k=1, d_expert=8,
                      capacity_factor=0.5), 16, 64, 64, None, False),
    ("capacity3", dict(n_experts=8, top_k=2, d_expert=16), 32, 64, 2048, 3,
     False),
    ("decode4", dict(n_experts=60, top_k=4, d_expert=16, n_shared=1), 32, 4,
     2048, None, False),
    ("tied_rows", dict(n_experts=60, top_k=4, d_expert=16), 32, 64, 2048,
     None, True),
]


def numpy_moe_params(rng, d, cfg):
    """Seeded weights in ``moe.moe_shapes``' order, normal / √fan-in."""
    return {name: (rng.normal(size=shape) / np.sqrt(shape[-2]))
            .astype(np.float32)
            for name, shape in moe.moe_shapes(d, cfg).items()}


@functools.lru_cache(maxsize=None)
def jax_moe(label):
    """The reference's ``moe_ffn`` and ``moe_ffn_reference`` (each
    jitted) on seeded numpy weights and tokens, with those inputs."""
    import jax
    from repro.models import moe as jm

    i = [c[0] for c in CASES].index(label)
    _, fields, d, T, gt, cap, zeros = CASES[i]
    rng = np.random.default_rng(i)
    tree = numpy_moe_params(rng, d, moe.MoEConfig(**fields))
    x = rng.normal(size=(T, d)).astype(np.float32)
    if zeros:
        x[::2] = 0.0               # a zero row's probabilities all tie
    cfg = jm.MoEConfig(**fields)
    y, aux = jax.jit(lambda p, x: jm.moe_ffn(p, x, cfg, capacity=cap,
                                             group_tokens=gt))(tree, x)
    ref = jax.jit(lambda p, x: jm.moe_ffn_reference(p, x, cfg))(tree, x)
    return tree, x, np.asarray(y), float(aux), np.asarray(ref)


@pytest.mark.parametrize("label", [c[0] for c in CASES])
def test_moe_ffn_matches_jax(label):
    """Output within 1e-5/2e-5 and aux within 1e-6 of the reference's
    ``moe_ffn``; without drops, within 2e-4 of the port's dense
    ``moe_ffn_reference`` (the reference test's bound), and the port's
    ``moe_ffn_reference`` within 2e-5 of the reference's."""
    _, fields, d, T, gt, cap, _ = next(c for c in CASES if c[0] == label)
    tree, x, want, want_aux, want_ref = jax_moe(label)
    cfg = moe.MoEConfig(**fields)
    params = {k: t(v) for k, v in tree.items()}
    got, aux = moe.moe_ffn(params, t(x), cfg, capacity=cap, group_tokens=gt)
    assert got.shape == (T, d) and got.dtype == torch.float32
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(aux), want_aux, rtol=0, atol=1e-6)
    dense = moe.moe_ffn_reference(params, t(x), cfg)
    np.testing.assert_allclose(dense.numpy(), want_ref, rtol=RTOL, atol=ATOL)
    G, Tg, C = moe.group_capacity(T, cfg, cap, gt)
    if label not in ("dropping", "capacity3", "decode4", "tied_rows"):
        np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=2e-4,
                                   atol=2e-4)
    else:       # these drop pairs (the tied rows all pick experts 0-3):
                # the dense oracle keeps every one
        assert not np.allclose(got.numpy(), dense.numpy(), atol=1e-3)
    if label == "decode4":
        assert (G, Tg, C) == (1, 4, 1)


def test_top_k_breaks_ties_toward_the_lower_index():
    """A uniform row, as an all-zero token's router gives: the reference's
    ``lax.top_k`` picks experts 0 … K−1, and so does the port's (a plain
    ``torch.topk`` need not)."""
    import jax
    import jax.numpy as jnp

    probs = torch.full((3, 60), 1 / 60)
    vals, idx = moe.top_k(probs, 4)
    want = np.asarray(jax.lax.top_k(jnp.full((3, 60), 1 / 60), 4)[1])
    assert np.array_equal(idx.numpy(), want)
    assert np.array_equal(idx.numpy(), np.tile(np.arange(4), (3, 1)))
    assert torch.equal(vals, probs[:, :4])


@pytest.mark.parametrize("T,cf,want", [(16384, 1.25, (8, 2048, 171)),
                                       (4, 1.25, (1, 4, 1)),
                                       (256, 8.0, (1, 256, 137)),
                                       (6000, 1.25, (2, 3000, 250))])
def test_group_capacity_matches_the_reference_expression(T, cf, want):
    """G, Tg and C at the serving prefill (B 4 × 4,096), a decode step of
    B 4, phase 12's full-width layer check and a T that 2,048 does not
    divide, against the reference's expression in numpy."""
    cfg = moe.MoEConfig(n_experts=60, top_k=4, d_expert=1408,
                        capacity_factor=cf)
    G = max(1, T // 2048)
    while T % G:
        G -= 1
    C = max(1, int(np.ceil(T // G * 4 / 60 * cf)))
    assert moe.group_capacity(T, cfg) == (G, T // G, C) == want


def test_dispatch_slots_are_unique_and_ranked():
    """Every kept pair has a slot of its own, e·C + its rank among its
    expert's pairs in token order; dropped pairs go to the trash row."""
    rng = np.random.default_rng(0)
    E, C, K = 6, 3, 2
    idx = torch.from_numpy(np.stack([rng.permutation(E)[:K]
                                     for _ in range(20)]))[None]
    order, st, keep, slot = moe.dispatch(idx, C, E)
    se = idx.reshape(1, -1)[0, order[0]]
    kept = slot[0][keep[0]]
    assert len(set(kept.tolist())) == len(kept)
    assert torch.all(slot[0][~keep[0]] == E * C)
    for e in range(E):
        rows = st[0][se == e]
        assert torch.equal(rows, rows.sort().values)     # token order
        want = [e * C + r for r in range(min(C, len(rows)))]
        assert slot[0][se == e][:C].tolist() == want


def test_combine_uses_the_gates_and_the_right_slots():
    """One token routed to experts 1 and 0 with gates 0.25 and 0.75, C 1:
    its output is 0.75 · row 0 + 0.25 · row 1 of y."""
    y = torch.arange(3 * 4, dtype=torch.float32).reshape(1, 3, 4)
    idx = torch.tensor([[[1, 0]]])
    gates = torch.tensor([[[0.25, 0.75]]])
    order, _, keep, slot = moe.dispatch(idx, 1, 3)
    out = moe.combine(y, order, keep, slot, gates, torch.float32)
    assert torch.equal(out[0, 0], 0.75 * y[0, 0] + 0.25 * y[0, 1])


# ------------------------------------------------------- the LM slice --

def port_cfg(arch, dtype="float32", **kw):
    return dataclasses.replace(registry.get_config(arch, reduced=True).model,
                               dtype=TORCH_DT[dtype], **kw)


def jax_cfg(arch, dtype="float32", **kw):
    import jax.numpy as jnp
    from repro.configs.registry import get_config as j_get

    return dataclasses.replace(j_get(arch, reduced=True).model,
                               dtype=getattr(jnp, dtype), **kw)


@functools.lru_cache(maxsize=None)
def jax_params(arch, dtype="float32"):
    """The reference's seeded weights (``PRNGKey(0)``, as its ``main_lm``
    and trainer) as a numpy tree: ``layers`` stacked, with a stacked
    ``moe`` sub-dict."""
    import jax
    from repro.models.transformer import init_lm_params

    params = init_lm_params(jax.random.PRNGKey(0), jax_cfg(arch, dtype))
    return jax.tree_util.tree_map(np.asarray, params)


def prompts(batch, length, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (batch, length)).astype(np.int32)


def close(mine, want, dtype):
    np.testing.assert_allclose(f32(mine.float()), f32(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_through_numpy(arch):
    """``params_from_numpy`` unstacks the nested ``moe`` sub-dict layer by
    layer and ``params_to_numpy`` stacks it back, every bit kept."""
    import jax

    tree = jax_params(arch)
    p = tr.params_from_numpy(tree)
    assert len(p["layers"]) == port_cfg(arch).n_layers
    assert set(p["layers"][0]["moe"]) == set(tree["layers"]["moe"])
    assert np.array_equal(p["layers"][1]["moe"]["w_up"].numpy(),
                          tree["layers"]["moe"]["w_up"][1])
    back = tr.params_to_numpy(p)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_and_abstract_params_match_the_reference_shapes(arch):
    import jax
    from repro.models import transformer as jt

    cfg = port_cfg(arch)
    real = tr.init_lm_params(torch.Generator().manual_seed(0), cfg)
    meta = tr.abstract_lm_params(cfg)
    assert [(p.shape, p.dtype) for p in tree_leaves(real)] == \
        [(p.shape, p.dtype) for p in tree_leaves(meta)]
    assert real["layers"][0]["moe"]["router"].dtype == torch.float32
    want = jax.tree.leaves(jt.abstract_lm_params(jax_cfg(arch)))
    got = jax.tree.leaves(tr.params_to_numpy(real))
    assert sorted(x.shape for x in got) == sorted(x.shape for x in want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch, dtype):
    import jax
    import jax.numpy as jnp
    from repro.models.transformer import prefill_step

    cfg = port_cfg(arch, dtype)
    toks = prompts(2, 64, cfg.vocab, seed=3)
    jp = jax.tree_util.tree_map(jnp.asarray, jax_params(arch, dtype))
    want_logits, want_cache = prefill_step(jp, jax_cfg(arch, dtype),
                                           jnp.asarray(toks))
    logits, cache = tr.prefill_step(
        tr.params_from_numpy(jax_params(arch, dtype)), cfg,
        torch.from_numpy(toks))
    assert logits.dtype == cfg.dtype and logits.shape == (2, cfg.vocab)
    close(logits, want_logits, dtype)
    close(cache.k, want_cache.k, dtype)
    close(cache.v, want_cache.v, dtype)


#: the serving loop's shape: main_lm's prompts (``default_rng(0)``), B 2,
#: P 16, 6 generated: a prefill and 5 decode steps
SERVE_B, SERVE_P, SERVE_GEN = 2, 16, 6


@functools.lru_cache(maxsize=None)
def jax_serving_loop(arch):
    """The reference's greedy loop as its ``main_lm`` runs it (f32, the
    steps jitted): prefill, the cache widened to P + gen, gen − 1 decode
    steps.  Returns the prompts, each step's logits and the generated
    ids."""
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as jt

    jcfg = jax_cfg(arch)
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab, (SERVE_B, SERVE_P)).astype(np.int32)
    jp = jax.tree_util.tree_map(jnp.asarray, jax_params(arch))
    prefill = jax.jit(lambda p, t: jt.prefill_step(p, jcfg, t))
    decode = jax.jit(lambda p, c, t: jt.decode_step(p, jcfg, c, t))
    logits, cache = prefill(jp, jnp.asarray(toks))
    full = jt.init_kv_cache(jcfg, SERVE_B, SERVE_P + SERVE_GEN)
    cache = full._replace(k=full.k.at[:, :, :SERVE_P].set(cache.k),
                          v=full.v.at[:, :, :SERVE_P].set(cache.v),
                          length=cache.length)
    out, ids = [np.asarray(logits)], []
    for _ in range(SERVE_GEN - 1):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        ids.append(np.asarray(tok))
        logits, cache = decode(jp, cache, tok)
        out.append(np.asarray(logits))
    ids.append(np.asarray(jnp.argmax(logits, -1).astype(jnp.int32)))
    return toks, out, np.stack(ids, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_decode_steps_match_jax(arch):
    """Prefill, widen, three greedy decode steps (B 2: one dispatch group
    of 2 tokens, C 1, so the two tokens collide and drop as in the
    reference): the same tokens and logits within 2e-5 (f32)."""
    toks, want, _ = jax_serving_loop(arch)
    cfg = port_cfg(arch)
    params = tr.params_from_numpy(jax_params(arch))
    logits, part = tr.prefill_step(params, cfg, torch.from_numpy(toks))
    cache = tr.init_kv_cache(cfg, SERVE_B, SERVE_P + SERVE_GEN)
    cache.k[:, :, :SERVE_P] = part.k
    cache.v[:, :, :SERVE_P] = part.v
    cache = cache._replace(length=part.length)
    close(logits, want[0], "float32")
    for i in range(3):
        tok = torch.argmax(logits, -1).to(torch.int32)
        assert np.array_equal(tok.numpy(), np.argmax(want[i], -1))
        logits, cache = tr.decode_step(params, cfg, cache, tok)
        close(logits, want[i + 1], "float32")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_lm_fused_and_eager_match_jax(arch):
    """``serve_lm`` on the CPU, the default ``fused=True`` (the programs'
    bodies uncaptured) and the eager oracle: the reference loop's ids
    token for token from the same weights and prompts (f32), and the two
    modes' last logits bit for bit."""
    toks, _, want = jax_serving_loop(arch)
    cfg = port_cfg(arch)
    params = tr.params_from_numpy(jax_params(arch))
    before = fa.flash_attention.launches
    fused = serve.serve_lm(cfg, toks, SERVE_GEN, "cpu", params=params)
    eager = serve.serve_lm(cfg, toks, SERVE_GEN, "cpu", params=params,
                           fused=False)
    assert fused.ids.shape == (SERVE_B, SERVE_GEN)
    assert np.array_equal(fused.ids, want)
    assert np.array_equal(eager.ids, want)
    assert torch.equal(fused.logits, eager.logits)
    assert fa.flash_attention.launches == before     # the twin counts none


def test_main_lm_cli_serves_the_moe_arch_on_cpu(capsys):
    ids = serve.main(["--workload", "lm", "--arch", "qwen2-moe-a2.7b",
                      "--device", "cpu", "--batch", "2", "--prompt-len", "8",
                      "--gen", "3"])
    assert ids.shape == (2, 3)
    assert "generated ids" in capsys.readouterr().out


# ------------------------------------------------------------ training --

@functools.lru_cache(maxsize=None)
def jax_loss_and_grads(arch, remat):
    import jax
    from repro.models import transformer as jt

    cfg = jax_cfg(arch, remat=remat, q_block=Q_BLOCK)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    fn = jax.jit(jax.value_and_grad(
        lambda p, x, y: jt.lm_loss(p, cfg, x, y)))
    loss, grads = fn(jax_params(arch), toks[:, :-1], toks[:, 1:])
    aux = jt.lm_forward(jax_params(arch), cfg, toks[:, :-1])[1]
    return (toks, float(loss), float(aux),
            jax.tree_util.tree_map(np.asarray, grads))


@pytest.mark.parametrize("arch,remat", [("qwen2-moe-a2.7b", False),
                                        ("qwen2-moe-a2.7b", True),
                                        ("qwen3-moe-235b-a22b", False)])
def test_lm_loss_and_every_gradient_match_jax(arch, remat):
    """The reduced config at ``q_block`` 16 over 64 positions (B 2: one
    dispatch group of 128 tokens): the loss with its MoE aux, the aux
    alone and every parameter's gradient, router and experts included."""
    import jax

    # the reference's remat changes no value: one JAX run serves both
    toks, want_loss, want_aux, want_grads = jax_loss_and_grads(arch, False)
    cfg = port_cfg(arch, remat=remat, q_block=Q_BLOCK)
    params = tr.params_from_numpy(jax_params(arch))
    loss, grads = steps.lm_value_and_grad(params, cfg, t(toks[:, :-1]),
                                          t(toks[:, 1:]))
    np.testing.assert_allclose(float(loss), want_loss, rtol=RTOL, atol=ATOL)
    aux = tr.lm_forward(params, cfg, t(toks[:, :-1]))[1]
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), want_aux, rtol=0, atol=1e-6)
    paths = jax.tree_util.tree_flatten_with_path(want_grads)[0]
    mine = jax.tree.leaves(tr.params_to_numpy(grads))
    assert len(paths) == len(mine)
    for (path, want), got in zip(paths, mine):
        assert got.shape == want.shape, path
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=str(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_two_train_steps_are_finite_and_checkpoint_round_trips(arch,
                                                               tmp_path):
    """Two ``build_cell("train")`` steps of the reduced config move the
    weights and give finite losses; the MoE state (params, whose ``moe``
    leaves sit a level deeper, and AdamW's moments) saves and restores
    bit for bit."""
    arch_cfg = dataclasses.replace(
        registry.get_config(arch, reduced=True),
        shapes={"train": ShapeCell("train", "train", batch=B, seq_len=S)})
    cell = steps.build_cell(arch_cfg, "train")
    cfg = arch_cfg.model
    assert cell.model_flops == 6.0 * cfg.active_param_count() * B * S
    params = tr.init_lm_params(torch.Generator().manual_seed(0), cfg)
    start = params["layers"][0]["moe"]["w_down"].clone()
    opt = steps.init_adamw(params)
    rng = np.random.default_rng(1)
    losses = []
    for _ in range(2):
        toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
        params, opt, loss = cell.fn(params, opt, {"tokens": t(toks[:, :-1]),
                                                  "labels": t(toks[:, 1:])})
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert not torch.equal(params["layers"][0]["moe"]["w_down"], start)
    state = (params, opt)
    paths = [p for p, _ in leaves_with_paths(state)]
    assert "0/layers/1/moe/w_gate" in paths
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, state, blocking=True)
    like = (tr.init_lm_params(torch.Generator().manual_seed(9), cfg),
            steps.init_adamw(params))
    back, step = mgr.restore(like)
    assert step == 2
    for a, b in zip(tree_leaves(back), tree_leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_train_entry_point_runs_the_moe_arch_on_cpu(tmp_path):
    """``launch.train.main --arch qwen2-moe-a2.7b --reduced`` with the
    reference's example arguments (120 steps, batch 4, seq 64): the loss
    falls (its own assertion)."""
    losses = train.main(["--arch", "qwen2-moe-a2.7b", "--reduced",
                         "--device", "cpu", "--steps", "120", "--batch", "4",
                         "--seq", "64", "--ckpt-every", "40",
                         "--ckpt-dir", str(tmp_path), "--log-every", "40"])
    assert len(losses) == 120 and losses[-1] < losses[0]


# ------------------------------------------------------- full configs --

@pytest.mark.parametrize("arch,total,active", [
    ("qwen2-moe-a2.7b", 14_315_587_584, 2_688_976_896),
    ("qwen3-moe-235b-a22b", 235_093_610_496, 22_190_739_456)])
def test_full_configs_match_the_reference(arch, total, active):
    """Parameter counts, abstract shapes (meta tensors against the
    reference's ``eval_shape``) and the prefill and decode cells' model
    FLOPs of the full configs."""
    import jax
    from repro.configs.registry import get_config as j_get
    from repro.launch import steps as jsteps
    from repro.models import transformer as jt

    mine, want = registry.get_config(arch), j_get(arch)
    assert mine.model.param_count() == want.model.param_count() == total
    assert mine.model.active_param_count() == \
        want.model.active_param_count() == active
    shapes = {}
    for path, p in leaves_with_paths(tr.abstract_lm_params(mine.model)):
        assert p.device.type == "meta"
        parts = path.split("/")
        if parts[0] == "layers":          # a list of layers, stacked there
            parts = ["layers"] + parts[2:]
        key = "/".join(parts)
        shapes.setdefault(key, set()).add(tuple(p.shape))
    ref = jax.tree_util.tree_flatten_with_path(
        jt.abstract_lm_params(want.model))[0]
    L = mine.model.n_layers
    for path, leaf in ref:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        stacked = key.startswith("layers/")
        assert shapes.pop(key) == {tuple(leaf.shape[1:] if stacked
                                         else leaf.shape)}, key
        assert not stacked or leaf.shape[0] == L
    assert not shapes
    for shape in ("prefill_32k", "decode_32k"):
        assert steps.build_cell(mine, shape).model_flops == \
            jsteps.build_cell(want, shape, None).model_flops


# ------------------------------------------------------------ the card --

@pytest.mark.gpu
def test_cuda_moe_serving_matches_cpu():
    """Reduced Qwen1.5-MoE in f32, batch 2, prompt 64, gen 8, one set of
    seeded weights on both devices: prefill logits allclose and the fused
    serve's ids equal to the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    cfg = port_cfg("qwen2-moe-a2.7b")
    params = tr.init_lm_params(torch.Generator().manual_seed(0), cfg)
    on_card = tree_map(lambda x: x.cuda(), params)
    toks = prompts(2, 64, cfg.vocab)
    want, _ = tr.prefill_step(params, cfg, torch.from_numpy(toks))
    got, _ = tr.prefill_step(on_card, cfg, torch.from_numpy(toks).cuda())
    torch.testing.assert_close(got.cpu(), want, rtol=2e-5, atol=2e-5)
    cpu = serve.serve_lm(cfg, toks, 8, "cpu", params=params)
    card = serve.serve_lm(cfg, toks, 8, "cuda", params=on_card)
    assert np.array_equal(cpu.ids, card.ids)
