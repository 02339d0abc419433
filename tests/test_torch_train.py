"""The LM training slice of the port against the JAX package, on the CPU:
the training layers (``layernorm``, ``swiglu``, ``auto_q_block``,
``chunked_gqa_attention``, ``cross_entropy``, ``chunked_cross_entropy``),
``lm_loss`` and every parameter's gradient on the reduced SmolLM-360M
config with the reference's weights (``params_from_numpy``, gradients
through ``params_to_numpy``), three ``build_cell("train")`` steps against
the reference's jitted ``cell.fn``, ``SyntheticLM``, ``Prefetcher``,
``CheckpointManager``, ``run_with_restarts``, ``StragglerMonitor`` and
the ``launch.train`` entry point with one injected failure.

The reference's outputs are built once per module (``lru_cache``), in
this process, on one device."""
import dataclasses
import functools
import logging
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs.base import ShapeCell as JShapeCell
from repro.configs.smollm_360m import CONFIG as JCONFIG
from repro.data import lm as jdata
from repro.ft import failure as jfailure
from repro.ft import straggler as jstraggler
from repro.launch import steps as jsteps
from repro.models import layers as jl
from repro.models import transformer as jtr
from repro.optim.adamw import AdamWState as JAdamWState
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeCell
from repro_torch.configs.smollm_360m import CONFIG
from repro_torch.data import Prefetcher, SyntheticLM
from repro_torch.ft import (InjectedFailure, RestartPolicy, StragglerMonitor,
                            run_with_restarts)
from repro_torch.launch import steps, train
from repro_torch.models import layers
from repro_torch.models import transformer as tr
from repro_torch.optim import AdamWState
from repro_torch.tree import tree_leaves

#: ROADMAP's f32 tolerances
RTOL, ATOL = 1e-5, 2e-5
#: gradients, moments and parameters after train steps: ROADMAP's rtol,
#: and an atol cut from 2e-5 to 2e-6, since the gradients are at most
#: 0.04–0.6 a leaf and 2e-5 would pass an error of 5e-4 of such a value.
#: The largest difference read here is 1.1e-6 (``embed``'s gradient: XLA
#: and torch add its 128 tokens' rows in different orders)
GRAD_RTOL, GRAD_ATOL = RTOL, 2e-6
B, S, Q_BLOCK = 2, 64, 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU work here is small (the reduced config): one
    intra-op thread runs it fastest and keeps it from contending with the
    suite's other workers (with a thread a core, the trainer's 140 steps
    took minutes beside them); the setting is restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_cfg(**kw):
    return dataclasses.replace(CONFIG.reduced().model, **kw)


def jax_cfg(**kw):
    return dataclasses.replace(JCONFIG.reduced().model, **kw)


@functools.lru_cache(maxsize=None)
def jax_params():
    """The reference's seeded weights (``PRNGKey(0)``, as its trainer)."""
    params = jtr.init_lm_params(jax.random.PRNGKey(0), jax_cfg())
    return jax.tree_util.tree_map(np.asarray, params)


def batch(seed=0, vocab=512):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    return toks[:, :-1].copy(), toks[:, 1:].copy()


def t(a):
    return torch.from_numpy(np.array(a))


def leaves_np(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


# ------------------------------------------------------------- layers --

def test_layernorm_and_swiglu_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 48)).astype(np.float32)
    w, b = (rng.normal(size=(48,)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        layers.layernorm(t(x), t(w), t(b)).numpy(),
        np.asarray(jl.layernorm(x, w, b)), rtol=RTOL, atol=ATOL)
    xb = t(x).bfloat16()
    got = layers.layernorm(xb, t(w), t(b))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(),
        np.asarray(jl.layernorm(jnp.asarray(x, jnp.bfloat16), w, b),
                   np.float32), rtol=3e-2, atol=3e-2)
    wg, wu = (rng.normal(size=(48, 80)).astype(np.float32) / 7
              for _ in range(2))
    wd = rng.normal(size=(80, 48)).astype(np.float32) / 9
    np.testing.assert_allclose(
        layers.swiglu(t(x), t(wg), t(wu), t(wd)).numpy(),
        np.asarray(jl.swiglu(x, wg, wu, wd)), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("args", [(8, 15, 4096, 1024), (256, 15, 4096, 1024),
                                  (4, 3, 64, 16), (64, 32, 32768, 2048),
                                  (1024, 64, 65536, 4096)])
def test_auto_q_block_matches_jax(args):
    assert layers.auto_q_block(*args) == jl.auto_q_block(*args)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,q_block", [(64, 16), (48, 16), (16, 32)])
def test_chunked_gqa_attention_matches_jax(causal, S, q_block):
    """Values and ``jax.grad`` of a seeded cotangent's dot product with
    the output, over 4 and 3 query blocks and the unblocked fallback."""
    rng = np.random.default_rng(2)
    Bq, Hq, Hkv, D = 2, 6, 2, 32
    q = rng.normal(size=(Bq, S, Hq, D)).astype(np.float32)
    k = rng.normal(size=(Bq, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(Bq, S, Hkv, D)).astype(np.float32)
    ct = rng.normal(size=(Bq, S, Hq, D)).astype(np.float32)

    def ref(q, k, v):
        out = jl.chunked_gqa_attention(q, k, v, q_block=q_block,
                                       causal=causal)
        return jnp.sum(out * ct), out

    (_, want), want_g = jax.value_and_grad(ref, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
    qt, kt, vt = (t(a).requires_grad_(True) for a in (q, k, v))
    out = layers.chunked_gqa_attention(qt, kt, vt, q_block=q_block,
                                       causal=causal)
    got_g = torch.autograd.grad((out * t(ct)).sum(), (qt, kt, vt))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    for got, w in zip(got_g, want_g):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


def test_chunked_gqa_attention_rejects_ragged_blocks():
    q = torch.zeros(1, 40, 2, 8)
    k = torch.zeros(1, 40, 1, 8)
    with pytest.raises(ValueError, match="multiple"):
        layers.chunked_gqa_attention(q, k, k, q_block=16)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(4, 9, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, (4, 9)).astype(np.int32)
    np.testing.assert_allclose(
        float(layers.cross_entropy(t(logits), t(labels))),
        float(jl.cross_entropy(logits, labels)), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("N,block", [(64, 16), (48, 32), (40, 8192)])
def test_chunked_cross_entropy_matches_jax(N, block):
    """``block`` 16 over 64 rows (4 blocks); 32 over 48 rows halves to 16
    (3 blocks); the default 8192 over 40 rows halves to 8 (5 blocks).
    Values and the gradients of x and head."""
    rng = np.random.default_rng(4)
    Dm, V = 24, 70
    x = rng.normal(size=(N, Dm)).astype(np.float32)
    head = (rng.normal(size=(Dm, V)) / 5).astype(np.float32)
    labels = rng.integers(0, V, N).astype(np.int32)
    want, want_g = jax.value_and_grad(
        lambda x, h: jl.chunked_cross_entropy(x, h, labels, block=block),
        argnums=(0, 1))(x, head)
    xt, ht = t(x).requires_grad_(True), t(head).requires_grad_(True)
    got = layers.chunked_cross_entropy(xt, ht, t(labels), block=block)
    got_g = torch.autograd.grad(got, (xt, ht))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL,
                               atol=ATOL)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


# ---------------------------------------------------- the model's loss --

def test_config_restores_remat_and_q_block():
    cfg, jcfg = CONFIG.model, JCONFIG.model
    small, jsmall = CONFIG.reduced().model, JCONFIG.reduced().model
    assert (cfg.remat, cfg.q_block) == (jcfg.remat, jcfg.q_block) == \
        (True, 1024)
    assert (small.remat, small.q_block) == (jsmall.remat, jsmall.q_block) \
        == (False, 1024)
    assert cfg.active_param_count() == jcfg.active_param_count() == \
        cfg.param_count() == 409_007_040


def test_params_to_numpy_inverts_params_from_numpy():
    tree = jax_params()
    back = tr.params_to_numpy(tr.params_from_numpy(tree))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    bf = tr.params_from_numpy(tree)
    bf["embed"] = bf["embed"].bfloat16()
    assert tr.params_to_numpy(bf)["embed"].dtype == np.float32


def test_abstract_params_match_init():
    cfg = port_cfg()
    real = tr.init_lm_params(torch.Generator().manual_seed(0), cfg)
    meta = tr.abstract_lm_params(cfg)
    assert [(p.shape, p.dtype) for p in tree_leaves(real)] == \
        [(p.shape, p.dtype) for p in tree_leaves(meta)]
    assert all(p.device.type == "meta" for p in tree_leaves(meta))
    jshapes = jax.tree.leaves(jtr.abstract_lm_params(jax_cfg()))
    assert sorted(x.shape for x in jax.tree.leaves(tr.params_to_numpy(real))) \
        == sorted(x.shape for x in jshapes)


@functools.lru_cache(maxsize=None)
def jax_loss_and_grads(remat):
    cfg = jax_cfg(remat=remat, q_block=Q_BLOCK)
    tokens, labels = batch()
    fn = jax.jit(jax.value_and_grad(
        lambda p, x, y: jtr.lm_loss(p, cfg, x, y)))
    loss, grads = fn(jax_params(), tokens, labels)
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


@pytest.mark.parametrize("remat", [False, True])
def test_lm_loss_and_every_gradient_match_jax(remat):
    """The reduced config at ``q_block`` 16 over 64 positions: attention
    runs 4 checkpointed blocks, each layer checkpointed when ``remat``."""
    cfg = port_cfg(remat=remat, q_block=Q_BLOCK)
    tokens, labels = batch()
    params = tr.params_from_numpy(jax_params())
    loss, grads = steps.lm_value_and_grad(params, cfg, t(tokens), t(labels))
    want_loss, want_grads = jax_loss_and_grads(remat)
    np.testing.assert_allclose(float(loss), want_loss, rtol=RTOL, atol=ATOL)
    assert not any(p.requires_grad for p in tree_leaves(params))
    mine = tr.params_to_numpy(grads)
    paths = jax.tree_util.tree_flatten_with_path(want_grads)[0]
    assert len(paths) == len(jax.tree.leaves(mine)) == 12
    for (path, want), got in zip(paths, jax.tree.leaves(mine)):
        assert got.shape == want.shape, path
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=str(path))
    fwd = float(tr.lm_loss(params, cfg, t(tokens), t(labels)))
    assert fwd == float(loss)


def test_remat_changes_no_bit_of_the_gradients():
    tokens, labels = batch(1)
    params = tr.params_from_numpy(jax_params())
    out = [steps.lm_value_and_grad(params, port_cfg(remat=r, q_block=Q_BLOCK),
                                   t(tokens), t(labels)) for r in (False, True)]
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(tree_leaves(out[0][1]), tree_leaves(out[1][1])):
        assert torch.equal(a, b)


def test_lm_forward_matches_jax():
    cfg = port_cfg(q_block=Q_BLOCK)
    tokens, _ = batch(2)
    logits, aux = tr.lm_forward(tr.params_from_numpy(jax_params()), cfg,
                                t(tokens))
    want, want_aux = jtr.lm_forward(jax_params(), jax_cfg(q_block=Q_BLOCK),
                                    tokens)
    assert aux.dtype == torch.float32 and float(aux) == float(want_aux) == 0
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


# ------------------------------------------------ build_cell("train") --

def seeded_state(params_np, seed=7):
    """AdamW moments at step 1000 drawn from a seed, the same for both
    packages: with zero moments Adam's first update is the sign of each
    gradient, which rounding flips where a gradient is near 0; seeded
    moments make the update a smooth function of the gradient, and at
    step 1000 the schedule's lr (1.5e-4) moves the weights visibly."""
    rng = np.random.default_rng(seed)
    m = jax.tree_util.tree_map(
        lambda p: (rng.normal(size=p.shape) * 1e-3).astype(np.float32),
        params_np)
    v = jax.tree_util.tree_map(
        lambda p: (rng.uniform(0.5, 1.5, size=p.shape) * 1e-6)
        .astype(np.float32), params_np)
    return np.int32(1000), m, v


def port_state(step, m, v):
    mt = tr.params_from_numpy(m)
    vt = tr.params_from_numpy(v)
    return AdamWState(step=torch.tensor(step, dtype=torch.int32), m=mt, v=vt)


@functools.lru_cache(maxsize=None)
def jax_three_steps(warm):
    arch = dataclasses.replace(
        JCONFIG.reduced(), model=jax_cfg(q_block=Q_BLOCK),
        shapes={"train": JShapeCell("train", "train", batch=B, seq_len=S)})
    cell = jsteps.build_cell(arch, "train", None)
    fn = jax.jit(cell.fn)
    params = jax.tree_util.tree_map(jnp.asarray, jax_params())
    if warm:
        step, m, v = seeded_state(jax_params())
        opt = JAdamWState(step=jnp.asarray(step), m=m, v=v)
    else:
        opt = jsteps.init_adamw(params)
    data = jdata.SyntheticLM(vocab=512, seq_len=S, batch=B, seed=0)
    losses = []
    for i in range(3):
        params, opt, loss = fn(params, opt, jax.tree.map(jnp.asarray,
                                                         data.batch_at(i)))
        losses.append(float(loss))
    return (losses, jax.tree_util.tree_map(np.asarray, params),
            jax.tree_util.tree_map(np.asarray, opt))


@pytest.mark.parametrize("warm", [False, True])
def test_build_cell_three_train_steps_match_jax(warm):
    """The reference's jitted train step against the port's eager one:
    schedule, loss and gradients, clipping, AdamW, three times.  From a
    fresh state (the trainer's start: lr 0, then 1.5e-7 and 3e-7) and
    from a warm one (step 1000, seeded moments)."""
    arch = dataclasses.replace(
        CONFIG.reduced(), model=port_cfg(q_block=Q_BLOCK),
        shapes={"train": ShapeCell("train", "train", batch=B, seq_len=S)})
    cell = steps.build_cell(arch, "train")
    assert cell.model_flops == 6.0 * arch.model.param_count() * B * S
    params = tr.params_from_numpy(jax_params())
    opt = port_state(*seeded_state(jax_params())) if warm else \
        steps.init_adamw(params)
    data = SyntheticLM(vocab=512, seq_len=S, batch=B, seed=0)
    losses = []
    for i in range(3):
        b = {k: t(v) for k, v in data.batch_at(i).items()}
        params, opt, loss = cell.fn(params, opt, b)
        losses.append(float(loss))
    want_losses, want_params, want_opt = jax_three_steps(warm)
    np.testing.assert_allclose(losses, want_losses, rtol=RTOL, atol=ATOL)
    assert int(opt.step) == int(want_opt.step) == (1003 if warm else 3)
    for got, want in ((params, want_params), (opt.m, want_opt.m),
                      (opt.v, want_opt.v)):
        for g, w in zip(jax.tree.leaves(tr.params_to_numpy(got)),
                        leaves_np(want)):
            np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    if warm:       # the update is visible at this tolerance
        moved = np.abs(tr.params_to_numpy(params)["lm_head"]
                       - jax_params()["lm_head"])
        assert moved.max() > 100 * GRAD_ATOL


def test_build_cell_abstract_inputs_and_other_cells():
    arch = CONFIG.reduced()
    cell = steps.build_cell(arch, "train_4k")
    params_abs, opt_abs, batch_abs = cell.abstract_inputs
    assert all(x.device.type == "meta" for x in tree_leaves(cell.abstract_inputs))
    assert batch_abs["tokens"].shape == (256, 4096)
    assert batch_abs["tokens"].dtype == torch.int32
    assert opt_abs.m["embed"].dtype == torch.float32
    jcell = jsteps.build_cell(JCONFIG.reduced(), "train_4k", None)
    assert cell.model_flops == jcell.model_flops
    for shape in ("prefill_32k", "decode_32k"):
        mine = steps.build_cell(arch, shape)
        assert mine.model_flops == \
            jsteps.build_cell(JCONFIG.reduced(), shape, None).model_flops
    cache = steps.build_cell(arch, "decode_32k").abstract_inputs[1]
    assert cache.k.shape == (2, 128, 32768, 1, 32)
    with pytest.raises(steps.SkippedCell):
        steps.build_cell(arch, "long_500k")
    moe = registry.get_config("qwen2-moe-a2.7b", reduced=True)
    with pytest.raises(NotImplementedError, match="item 9c"):
        steps.build_cell(moe, "train_4k", mesh=object())
    euler = dataclasses.replace(arch, family="euler")
    with pytest.raises(ValueError, match="mesh"):
        steps.build_cell(euler, "train_4k")


def test_prefill_and_decode_cells_run_the_serving_steps():
    arch = dataclasses.replace(
        CONFIG.reduced(), shapes={
            "p": ShapeCell("p", "prefill", batch=2, seq_len=8),
            "d": ShapeCell("d", "decode", batch=2, seq_len=12)})
    cfg = arch.model
    params = tr.init_lm_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.arange(16, dtype=torch.int32).reshape(2, 8)
    logits, cache = steps.build_cell(arch, "p").fn(params, tokens)
    want, _ = tr.prefill_step(params, cfg, tokens)
    assert torch.equal(logits, want)
    wide = tr.init_kv_cache(cfg, 2, 12, fill=8)
    wide.k[:, :, :8] = cache.k
    wide.v[:, :, :8] = cache.v
    out, new = steps.build_cell(arch, "d").fn(params, wide,
                                              torch.tensor([1, 2]))
    assert out.shape == (2, cfg.vocab) and new.length.tolist() == [9, 9]


# ----------------------------------------------------------------- data --

@pytest.mark.parametrize("seed,step", [(0, 0), (0, 17), (3, 5)])
def test_synthetic_lm_batches_are_byte_equal(seed, step):
    mine = SyntheticLM(vocab=512, seq_len=33, batch=3, seed=seed)
    want = jdata.SyntheticLM(vocab=512, seq_len=33, batch=3, seed=seed)
    a, b = mine.batch_at(step), want.batch_at(step)
    for key in ("tokens", "labels"):
        assert a[key].dtype == b[key].dtype == np.int32
        assert a[key].tobytes() == b[key].tobytes()
    first = next(iter(mine))
    assert first["tokens"].tobytes() == mine.batch_at(0)["tokens"].tobytes()


def test_prefetcher_keeps_order_and_stops():
    data = SyntheticLM(vocab=64, seq_len=5, batch=2)
    pre = Prefetcher(iter(data), depth=2, device=torch.device("cpu"))
    for i in range(5):
        got = next(pre)
        assert isinstance(got["tokens"], torch.Tensor)
        assert np.array_equal(got["tokens"].numpy(),
                              data.batch_at(i)["tokens"])
    pre.stop()
    next(pre)                       # the worker's next put returns
    pre.t.join(timeout=10)
    assert not pre.t.is_alive() and pre.t.daemon
    plain = Prefetcher(iter([1, 2, 3]), depth=1)
    assert [next(plain) for _ in range(3)] == [1, 2, 3]


# ----------------------------------------------------------- checkpoint --

def test_checkpoint_round_trip_keeps_bf16_and_honours_keep(tmp_path):
    cfg = port_cfg(dtype=torch.bfloat16)
    params = tr.init_lm_params(torch.Generator().manual_seed(1), cfg)
    state = (params, steps.init_adamw(params))
    state[1].m["embed"].fill_(0.25)
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    for step in (10, 20, 30):
        mgr.save(step, state, extra={"tag": step})
        if step == 20:
            saved = [x.clone() for x in tree_leaves(state)]
            params["embed"].add_(1.0)        # the caller goes on in place,
            state[1].m["embed"].add_(1.0)    # in bf16 and in f32
    mgr.wait()
    assert mgr.all_steps() == [20, 30] and mgr.latest_step() == 30
    assert not [n for n in os.listdir(mgr.dir) if n.startswith(".tmp")]
    meta = mgr.meta(20)
    assert meta["step"] == 20 and meta["extra"] == {"tag": 20}
    assert "0/embed" in meta["keys"] and "1/step" in meta["keys"]
    back, step = mgr.restore(state, step=20)
    assert step == 20 and isinstance(back[1], AdamWState)
    got = tree_leaves(back)
    assert len(got) == len(saved)
    for a, b in zip(got, saved):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)            # byte-equal, bf16 included
    assert back[0]["embed"].dtype == torch.bfloat16
    latest, step = mgr.restore(state)
    assert step == 30 and torch.equal(latest[0]["embed"], params["embed"])


def test_checkpoint_matches_the_reference_manager_on_numpy_leaves(tmp_path):
    """The same save/keep/restore sequence through both managers."""
    tree = {"a": np.arange(6, dtype=np.int32).reshape(2, 3),
            "b": [np.float32(2.5) * np.ones(4, np.float32)]}
    out = []
    for cls, d in ((CheckpointManager, "mine"), (jckpt.CheckpointManager,
                                                 "ref")):
        mgr = cls(str(tmp_path / d), keep=1)
        mgr.save(1, tree)
        mgr.save(2, jax.tree.map(lambda x: x * 2, tree), blocking=True)
        back, step = mgr.restore(tree)
        out.append((mgr.all_steps(), step, jax.tree.leaves(back)))
    assert out[0][:2] == out[1][:2] == ([2], 2)
    for a, b in zip(out[0][2], out[1][2]):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(tree)
    with pytest.raises(ValueError, match="shape"):
        CheckpointManager(str(tmp_path / "mine")).restore(
            {"a": np.zeros((3, 2)), "b": [np.zeros(4)]})


# ------------------------------------------------------- fault tolerance --

def run_both(fail_steps, n_steps, every, max_restarts, tmp_path):
    """``run_with_restarts`` of both packages on one step function over
    numpy state; returns each one's (state, steps, restarts) or the
    exception's type, and the steps it ran."""
    out = []
    for run, mgr_cls, name in (
            (run_with_restarts, CheckpointManager, "mine"),
            (jfailure.run_with_restarts, jckpt.CheckpointManager, "ref")):
        ran = []

        def step_fn(state, i, ran=ran):
            ran.append(i)
            return state * 3 + i

        mgr = mgr_cls(str(tmp_path / name))
        policy = (RestartPolicy if run is run_with_restarts else
                  jfailure.RestartPolicy)(max_restarts=max_restarts,
                                          ckpt_every=every)
        try:
            state, steps_done, restarts = run(
                step_fn, np.array([1, 2], np.int64), n_steps, mgr,
                policy=policy, fail_at=lambda s: s in fail_steps)
            res = (state.tolist(), steps_done, restarts)
        except Exception as e:  # noqa: BLE001 — both must raise alike
            res = type(e).__name__
        mgr.wait()             # a save may still be writing after a raise
        out.append((res, ran, mgr.all_steps()))
    return out


@pytest.mark.parametrize("fail_steps,n_steps,every,max_restarts", [
    ((), 9, 4, 3), ((5,), 9, 4, 3), ((5, 6), 12, 4, 3), ((1,), 9, 4, 3),
    ((3, 4, 7), 10, 2, 2), ((3, 4, 7), 10, 2, 3), ((8,), 9, 3, 0)])
def test_run_with_restarts_matches_reference(fail_steps, n_steps, every,
                                             max_restarts, tmp_path, caplog):
    caplog.set_level(logging.ERROR)
    mine, ref = run_both(set(fail_steps), n_steps, every, max_restarts,
                         tmp_path)
    assert mine == ref
    if mine[0] == "InjectedFailure":
        assert issubclass(InjectedFailure, RuntimeError)


def test_straggler_monitor_matches_reference():
    rng = np.random.default_rng(5)
    seconds = list(rng.uniform(0.09, 0.11, 40))
    seconds[12] = seconds[30] = 0.5
    seconds[3] = 0.9                           # inside the warm-up
    seen = ([], [])
    mons = (StragglerMonitor(k_sigma=4.0,
                             on_straggler=lambda s, x: seen[0].append(s)),
            jstraggler.StragglerMonitor(
                k_sigma=4.0, on_straggler=lambda s, x: seen[1].append(s)))
    flags = [[m.observe(i, x) for i, x in enumerate(seconds)] for m in mons]
    assert flags[0] == flags[1]
    a, b = mons[0].stats, mons[1].stats
    assert (a.mean, a.var, a.n, a.flagged, a.events) == \
        (b.mean, b.var, b.n, b.flagged, b.events)
    assert a.events == seen[0] == seen[1] and a.flagged >= 1
    assert 3 not in a.events
    assert mons[0].timed(lambda: 7, 99) == 7 and mons[0].stats.n == 41


# ---------------------------------------------------------- the trainer --

def test_train_main_survives_an_injected_failure(tmp_path, capsys):
    """``launch.train.main`` on the reduced config on the CPU, with the
    reference's example arguments (120 steps, batch 4, seq 64, a
    checkpoint every 40 steps, a failure at step 60): one restart from
    step 40, the replayed steps 40–59 logged twice with the same losses,
    and the loss falls."""
    t0 = time.perf_counter()
    losses = train.main(["--reduced", "--device", "cpu", "--steps", "120",
                         "--batch", "4", "--seq", "64", "--ckpt-every", "40",
                         "--fail-at", "60", "--ckpt-dir",
                         str(tmp_path / "ck"), "--log-every", "20"])
    out = capsys.readouterr().out
    assert "done: 120 steps, 1 restarts" in out
    assert len(losses) == 120 + 20
    assert losses[60:80] == losses[40:60]      # replayed from step 40
    assert losses[-1] < losses[0]
    assert out.count("step    40 loss") == 2
    assert CheckpointManager(str(tmp_path / "ck")).all_steps() == [40, 80,
                                                                   120]
    assert time.perf_counter() - t0 < 120


def test_examples_train_and_serve_on_the_cpu(tmp_path):
    """``examples/torch_train_lm.py`` and ``examples/torch_serve_lm.py``
    with the reference examples' arguments, on the CPU, in one fresh
    process; the training example checkpoints into a temporary directory
    of its own and removes it."""
    import subprocess
    import sys

    from conftest import REPO

    code = f"""
import runpy, sys
sys.argv = ["x", "--device", "cpu"]
runpy.run_path({os.path.join(REPO, "examples", "torch_train_lm.py")!r})
runpy.run_path({os.path.join(REPO, "examples", "torch_serve_lm.py")!r})
"""
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1", TMPDIR=str(tmp))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert not any(tmp.iterdir())
    assert "after surviving an injected failure at step 60" in r.stdout
    assert "done: 120 steps, 1 restarts" in r.stdout
    assert "decode 15 steps" in r.stdout
