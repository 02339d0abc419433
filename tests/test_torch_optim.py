"""The port's optimizer and schedule (``repro_torch.optim``) against the
JAX package's ``optim/adamw.py`` and ``optim/schedule.py`` on the same
numpy inputs: ``init_adamw``, ``global_norm``, three ``adamw_update``
steps with f32 and bf16 parameters, clipping active and not, and
``warmup_cosine``/``constant`` across the schedule's pieces."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro_torch.optim import (adamw_update, constant, global_norm,
                               init_adamw, warmup_cosine)
from repro_torch.tree import tree_leaves

#: ROADMAP's f32 tolerances, for bf16 parameters too: the update is
#: computed in f32 and rounded once, as the reference rounds it (on these
#: inputs the bf16 results are bit-equal)
RTOL, ATOL = 1e-5, 2e-5


def tree_np(dtype, seed, scale=1.0):
    """A small two-level tree of normal draws, as numpy."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (7, 5), "b": {"c": (33,), "d": (4, 3, 2)}}

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        return (rng.normal(size=s) * scale).astype(np.float32).astype(dtype)

    return draw(shapes)


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def flat_f32(tree):
    return [np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                       np.float32) for x in tree_leaves(tree)]


def jax_leaves(tree):
    import jax

    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def test_init_adamw_matches_jax():
    params = tree_np(ml_dtypes.bfloat16, 0)
    mine = init_adamw(to_torch(params))
    want = jadamw.init_adamw(params)
    assert mine.step.dtype == torch.int32 and int(mine.step) == 0
    for m in tree_leaves(mine.m) + tree_leaves(mine.v):
        assert m.dtype == torch.float32 and not m.any()
    assert [m.shape for m in tree_leaves(mine.m)] == \
        [w.shape for w in jax_leaves(want.m)]
    assert mine.m["a"] is not mine.v["a"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_norm_matches_jax(dtype):
    dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    grads = tree_np(dt, 1)
    mine = float(global_norm(to_torch(grads)))
    want = float(jadamw.global_norm(grads))
    np.testing.assert_allclose(mine, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clipped", [False, True])
def test_adamw_three_steps_match_jax(dtype, clipped):
    """Three updates from zero moments.  The gradients' global norm is
    about 3.5 (92 standard normals times 0.37): with
    ``clip_norm`` 1.0 the clip is active, with 100.0 it is not."""
    dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    clip = 1.0 if clipped else 100.0
    params = tree_np(dt, 2)
    mine_p, mine_s = to_torch(params), init_adamw(to_torch(params))
    want_p, want_s = params, jadamw.init_adamw(params)
    for i in range(3):
        grads = tree_np(dt, 10 + i, scale=0.37)
        gn = float(jadamw.global_norm(grads))
        assert (gn > clip) == clipped, gn
        lr = 1e-2 * (i + 1)
        mine_p, mine_s = adamw_update(mine_p, to_torch(grads), mine_s,
                                      torch.tensor(lr), clip_norm=clip)
        want_p, want_s = jadamw.adamw_update(want_p, grads, want_s,
                                             jnp.float32(lr), clip_norm=clip)
    assert int(mine_s.step) == int(want_s.step) == 3
    assert mine_s.step.dtype == torch.int32
    assert all(p.dtype == (torch.float32 if dtype == "float32"
                           else torch.bfloat16) for p in tree_leaves(mine_p))
    for got, want in zip(flat_f32(mine_p), jax_leaves(want_p)):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for got, want in zip(flat_f32(mine_s.m) + flat_f32(mine_s.v),
                         jax_leaves(want_s.m) + jax_leaves(want_s.v)):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_adamw_updates_in_place():
    """The port writes into the caller's tensors (the reference returns
    new trees and donates the old ones)."""
    params = to_torch(tree_np(np.float32, 3))
    before = params["a"].clone()
    state = init_adamw(params)
    m = state.m["a"]
    p2, s2 = adamw_update(params, to_torch(tree_np(np.float32, 4)), state,
                          torch.tensor(1e-2))
    assert p2["a"] is params["a"] and s2.m["a"] is m
    assert not torch.equal(params["a"], before) and m.any()
    assert int(state.step) == 0 and int(s2.step) == 1


def test_adamw_zero_lr_keeps_params():
    """Step 0 of the trainer's schedule has lr 0: the parameters keep
    every bit, the moments and the step move."""
    params = to_torch(tree_np(ml_dtypes.bfloat16, 5))
    before = [p.clone() for p in tree_leaves(params)]
    state = init_adamw(params)
    lr = warmup_cosine(state.step, 3e-4, 2000, 100_000)
    _, s2 = adamw_update(params, to_torch(tree_np(ml_dtypes.bfloat16, 6)),
                         state, lr)
    assert float(lr) == 0.0
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(params)))
    assert int(s2.step) == 1 and s2.m["a"].any()


@pytest.mark.parametrize("warmup,total", [(2000, 100_000), (10, 50), (0, 1)])
def test_warmup_cosine_matches_jax(warmup, total):
    """Step 0, the last warm-up step, the first cosine step, mid-decay,
    the end of the decay and past it."""
    steps = sorted({0, max(warmup - 1, 0), warmup, (warmup + total) // 2,
                    total, total + 7, 3 * total})
    for s in steps:
        for dt in (np.int32, np.float32):
            mine = warmup_cosine(torch.tensor(s, dtype=torch.int32
                                              if dt is np.int32 else
                                              torch.float32),
                                 3e-4, warmup, total)
            want = jschedule.warmup_cosine(jnp.asarray(s, dt), 3e-4, warmup,
                                           total)
            assert mine.dtype == torch.float32
            np.testing.assert_allclose(float(mine), float(want), rtol=RTOL,
                                       atol=1e-12, err_msg=f"step {s}")
    assert float(warmup_cosine(torch.tensor(0), 3e-4, 2000, 100_000)) == 0.0
    np.testing.assert_allclose(
        float(warmup_cosine(torch.tensor(10 ** 6), 3e-4, 2000, 100_000)),
        3e-5, rtol=RTOL)


def test_constant_matches_jax():
    steps = np.array([0, 5, 100], np.int32)
    mine = constant(torch.from_numpy(steps), 1e-3)
    want = jschedule.constant(jnp.asarray(steps), 1e-3)
    assert mine.dtype == torch.float32
    np.testing.assert_array_equal(mine.numpy(), np.asarray(want))
