"""The LM serving slice: the port's layers, ``prefill_step``,
``decode_step`` and ``serve_lm`` against the JAX package's on the reduced
SmolLM-360M config with the same weights (``params_from_numpy``), the
configs and the CLI on the CPU, and — on a card — cuda against cpu.

JAX is imported inside the tests that compare with it, so the ``gpu``
tests also run on a machine that has a card and no JAX
(``pytest -m gpu tests/test_torch_lm.py``)."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.configs.smollm_360m import CONFIG
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve
from repro_torch.models import layers
from repro_torch.models import transformer as tr

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def port_cfg(dtype="float32"):
    return dataclasses.replace(CONFIG.reduced().model,
                               dtype=TORCH_DT[dtype])


def jax_cfg(dtype="float32"):
    import jax.numpy as jnp
    from repro.configs.smollm_360m import CONFIG as JCONFIG

    return dataclasses.replace(JCONFIG.reduced().model,
                               dtype=getattr(jnp, dtype))


@functools.lru_cache(maxsize=None)
def jax_params(dtype="float32"):
    """The reference's seeded weights (``PRNGKey(0)``, as its ``main_lm``)
    as a numpy tree."""
    import jax
    from repro.models.transformer import init_lm_params

    params = init_lm_params(jax.random.PRNGKey(0), jax_cfg(dtype))
    return jax.tree_util.tree_map(np.asarray, params)


def prompts(batch, length, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (batch, length)).astype(np.int32)


def f32(x):
    return np.asarray(x, np.float32)


def close(mine, want, dtype):
    np.testing.assert_allclose(f32(mine.float()), f32(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


# ------------------------------------------------------------- layers --

def test_rmsnorm_and_rope_match_jax():
    import jax.numpy as jnp
    from repro.models import layers as jl

    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, 32)).astype(np.float32)
    w = rng.normal(size=(32,)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 7)).astype(np.int32)
    np.testing.assert_allclose(
        layers.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jl.rmsnorm(jnp.asarray(x), jnp.asarray(w))),
        rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        layers.rope_frequencies(32).numpy(),
        np.asarray(jl.rope_frequencies(32)), rtol=1e-6)
    np.testing.assert_allclose(
        layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos)).numpy(),
        np.asarray(jl.apply_rope(jnp.asarray(x), jnp.asarray(pos))),
        rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal,offset,kv_len", [
    (True, False, False), (True, True, False), (False, False, True),
    (True, True, True)])
def test_gqa_attention_matches_jax(causal, offset, kv_len):
    import jax.numpy as jnp
    from repro.models import layers as jl

    rng = np.random.default_rng(2)
    B, S, T, Hq, Hkv, D = 2, 5, 12, 6, 2, 32
    q = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    off = np.array([3, 7], np.int32) if offset else None
    kvl = np.array([4, 12], np.int32) if kv_len else None
    mine = layers.gqa_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal,
        q_offset=None if off is None else torch.from_numpy(off),
        kv_len=None if kvl is None else torch.from_numpy(kvl))
    want = jl.gqa_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_offset=None if off is None else jnp.asarray(off),
        kv_len=None if kvl is None else jnp.asarray(kvl))
    np.testing.assert_allclose(mine.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_dense_init_is_seeded_and_scaled():
    a = layers.dense_init(torch.Generator().manual_seed(3), 400, 300)
    b = layers.dense_init(torch.Generator().manual_seed(3), 400, 300,
                          dtype=torch.bfloat16)
    assert a.shape == (400, 300) and b.dtype == torch.bfloat16
    assert torch.equal(a.bfloat16(), b)
    assert abs(float(a.std()) - 1 / 20) < 1e-3


# ---------------------------------------------------- params and config --

def test_params_from_numpy_unstacks_in_layer_order():
    tree = jax_params()
    p = tr.params_from_numpy(tree)
    L = tree["layers"]["wq"].shape[0]
    assert len(p["layers"]) == L == port_cfg().n_layers
    for i in range(L):
        for name, a in tree["layers"].items():
            assert np.array_equal(p["layers"][i][name].numpy(), a[i]), name
    assert set(p) == set(tree)
    assert np.array_equal(p["lm_head"].numpy(), tree["lm_head"])


def test_params_from_numpy_keeps_bf16_bits():
    tree = jax_params("bfloat16")
    p = tr.params_from_numpy(tree)
    assert p["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(p["embed"].float().numpy(),
                                  f32(tree["embed"]))


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen2-moe-a2.7b",
                                  "qwen3-moe-235b-a22b", "starcoder2-7b",
                                  "granite-20b"])
def test_configs_match_the_reference(arch):
    from repro.configs.registry import get_config as j_get

    for reduced in (False, True):
        mine = registry.get_config(arch, reduced=reduced).model
        want = j_get(arch, reduced=reduced).model
        for f in ("name", "n_layers", "d_model", "n_heads", "n_kv_heads",
                  "d_ff", "vocab", "head_dim", "rope_theta", "remat",
                  "q_block"):
            assert getattr(mine, f) == getattr(want, f), f
        assert str(mine.dtype).split(".")[-1] == want.dtype.__name__
        assert not want.tie_embeddings
        assert (mine.moe is None) == (want.moe is None)
        if want.moe is not None:
            assert mine.moe._asdict() == want.moe._asdict()
        assert mine.param_count() == want.param_count()
        assert mine.active_param_count() == want.active_param_count()
        assert registry.get_config(arch, reduced=reduced).source == \
            j_get(arch, reduced=reduced).source
    if arch == "smollm-360m":
        full = registry.get_config(arch).model
        assert (full.n_layers, full.d_model, full.head_dim) == (32, 960, 64)
        assert full.param_count() == 409_007_040
    counts = {"starcoder2-7b": 10_116_960_768, "granite-20b": 28_167_493_632}
    if arch in counts:
        assert registry.get_config(arch).model.param_count() == counts[arch]
    assert registry.get_config(arch).shapes["prefill_32k"].seq_len == 32768


def test_registry_and_config_refuse_what_is_not_ported():
    """Every architecture of the reference is ported, in its order (the
    last, ``euler-rmat``, since its cells run over a mesh); an id the
    reference lacks raises."""
    from repro.configs import registry as jregistry

    assert registry.ARCH_IDS == jregistry.ARCH_IDS
    assert registry.get_config("euler-rmat").family == "euler"
    with pytest.raises(KeyError):
        registry.get_config("no-such-arch")


# ----------------------------------------------------------- the slice --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,length", [(2, 64), (3, 37)])
def test_prefill_matches_jax(dtype, batch, length):
    import jax
    import jax.numpy as jnp
    from repro.models.transformer import prefill_step

    cfg = port_cfg(dtype)
    toks = prompts(batch, length, cfg.vocab, seed=length)
    jp = jax.tree_util.tree_map(jnp.asarray, jax_params(dtype))
    want_logits, want_cache = prefill_step(jp, jax_cfg(dtype),
                                           jnp.asarray(toks))
    logits, cache = tr.prefill_step(tr.params_from_numpy(jax_params(dtype)),
                                    cfg, torch.from_numpy(toks))
    assert logits.dtype == cfg.dtype and logits.shape == (batch, cfg.vocab)
    close(logits, want_logits, dtype)
    close(cache.k, want_cache.k, dtype)
    close(cache.v, want_cache.v, dtype)
    assert cache.length.dtype == torch.int32
    assert np.array_equal(cache.length.numpy(), np.asarray(want_cache.length))


def test_decode_matches_jax_token_for_token():
    """Prefill, widen the cache, then 4 greedy decode steps in f32: the
    same tokens as JAX and logits within 2e-5."""
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as jt

    B, P, steps = 2, 24, 4
    jcfg, cfg = jax_cfg(), port_cfg()
    toks = prompts(B, P, cfg.vocab, seed=5)
    jp = jax.tree_util.tree_map(jnp.asarray, jax_params())
    params = tr.params_from_numpy(jax_params())

    j_logits, j_cache = jt.prefill_step(jp, jcfg, jnp.asarray(toks))
    full = jt.init_kv_cache(jcfg, B, P + steps + 1)
    j_cache = full._replace(k=full.k.at[:, :, :P].set(j_cache.k),
                            v=full.v.at[:, :, :P].set(j_cache.v),
                            length=j_cache.length)
    logits, cache = tr.prefill_step(params, cfg, torch.from_numpy(toks))
    wide = tr.init_kv_cache(cfg, B, P + steps + 1)
    wide.k[:, :, :P] = cache.k
    wide.v[:, :, :P] = cache.v
    cache = wide._replace(length=cache.length)

    for _ in range(steps):
        j_tok = jnp.argmax(j_logits, -1).astype(jnp.int32)
        tok = torch.argmax(logits, -1).to(torch.int32)
        assert np.array_equal(tok.numpy(), np.asarray(j_tok))
        j_logits, j_cache = jt.decode_step(jp, jcfg, j_cache, j_tok)
        logits, cache = tr.decode_step(params, cfg, cache, tok)
        close(logits, j_logits, "float32")
    assert np.array_equal(cache.length.numpy(), np.asarray(j_cache.length))
    close(cache.k, j_cache.k, "float32")


def test_first_decode_step_matches_prefill_of_one_more_token():
    """The decode path (cache written at ``length``, RoPE at that position,
    ``kv_len`` mask) gives the logits a prefill of the prompt plus the
    fed token gives at its last position (f32, 2e-5)."""
    cfg = port_cfg()
    params = tr.init_lm_params(torch.Generator().manual_seed(4), cfg)
    toks = torch.from_numpy(prompts(3, 29, cfg.vocab, seed=6))
    nxt = torch.tensor([5, 300, 511], dtype=torch.int32)
    _, cache = tr.prefill_step(params, cfg, toks)
    wide = tr.init_kv_cache(cfg, 3, 40, fill=29)
    wide.k[:, :, :29] = cache.k
    wide.v[:, :, :29] = cache.v
    step, wide = tr.decode_step(params, cfg, wide, nxt)
    full, full_cache = tr.prefill_step(params, cfg,
                                       torch.cat([toks, nxt[:, None]], 1))
    torch.testing.assert_close(step, full, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(wide.k[:, :, :30], full_cache.k, rtol=2e-5,
                               atol=2e-5)
    assert torch.equal(wide.length, torch.full((3,), 30, dtype=torch.int32))
    assert not wide.k[:, :, 30:].any()


@functools.lru_cache(maxsize=None)
def jax_main_lm_ids(B, P, gen):
    from repro.launch.serve import main_lm as j_main_lm

    return np.asarray(j_main_lm(["--batch", str(B), "--prompt-len", str(P),
                                 "--gen", str(gen)]))


def serve_matches_jax_main_lm(fused):
    """``serve_lm`` on the CPU gives JAX ``main_lm``'s generated ids, token
    for token, from the same weights and prompts (f32)."""
    B, P, gen = 2, 16, 6
    want = jax_main_lm_ids(B, P, gen)
    cfg = port_cfg()
    rng = np.random.default_rng(0)          # main_lm's prompts
    toks = rng.integers(0, cfg.vocab, (B, P)).astype(np.int32)
    before = fa.flash_attention.launches
    res = serve.serve_lm(cfg, toks, gen, "cpu",
                         params=tr.params_from_numpy(jax_params()),
                         fused=fused)
    assert res.ids.shape == (B, gen) and res.ids.dtype == np.int32
    assert np.array_equal(res.ids, want)
    assert fa.flash_attention.launches == before    # the twin counts none
    assert res.prefill_s > 0 and res.decode_s > 0 and res.decode_tok_s > 0


def test_serve_lm_matches_jax_main_lm():
    """The default, ``fused=True`` (the reference's jitted steps; on the
    CPU its programs' bodies run uncaptured)."""
    serve_matches_jax_main_lm(fused=True)


def test_serve_lm_eager_matches_jax_main_lm():
    """The eager oracle, ``fused=False``."""
    serve_matches_jax_main_lm(fused=False)


def test_main_lm_cli_on_cpu(capsys):
    ids = serve.main(["--workload", "lm", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "8", "--gen", "3"])
    assert ids.shape == (2, 3)
    assert "generated ids" in capsys.readouterr().out


def test_euler_workload_serves_on_cpu(capsys):
    """The default workload is the Euler serving loop (``main_euler``)."""
    thr = serve.main(["--device", "cpu", "--scale", "6", "--parts", "2",
                      "--requests", "4", "--no-prewarm"])
    assert thr > 0
    assert "served 4 circuits" in capsys.readouterr().out


def test_serve_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.serve_lm(port_cfg(), prompts(1, 4, 512), 2)


# ------------------------------------------------------------- the card --

@pytest.mark.gpu
def test_cuda_serving_matches_cpu():
    """Reduced config in f32, batch 2, prompt 64, gen 8, one set of
    seeded weights on both devices: logits allclose, greedy tokens
    identical, one K6 launch per layer in prefill and none in decode
    (the eager loop, ``fused=False``: a fused serve counts the warm-up's
    launches and the recording's; ``tests/test_torch_lm_graph.py`` has
    its fused twin)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    cfg = port_cfg()
    params = tr.init_lm_params(torch.Generator().manual_seed(0), cfg)
    on_card = {k: ([{n: t.cuda() for n, t in layer.items()} for layer in v]
                   if k == "layers" else v.cuda())
               for k, v in params.items()}
    toks = prompts(2, 64, cfg.vocab)
    want, _ = tr.prefill_step(params, cfg, torch.from_numpy(toks))
    got, _ = tr.prefill_step(on_card, cfg, torch.from_numpy(toks).cuda())
    torch.testing.assert_close(got.cpu(), want, rtol=2e-5, atol=2e-5)
    cpu = serve.serve_lm(cfg, toks, 8, "cpu", params=params, fused=False)
    before = fa.flash_attention.launches
    card = serve.serve_lm(cfg, toks, 8, "cuda", params=on_card, fused=False)
    assert np.array_equal(cpu.ids, card.ids)
    # one launch per layer of the prefill, so the decode launched none
    assert fa.flash_attention.launches == before + cfg.n_layers
