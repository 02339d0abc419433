"""The code LMs of the port against the JAX package, on the CPU:
StarCoder2-7B (36 query heads on 4 KV heads, RoPE base 10⁶) and
Granite-20B (48 on 1, MQA).  Their configs, parameter counts and
``build_cell`` cells at full size; the reduced configs and one narrow
config per model with its full head layout (2 layers, d_model 256, head
width 128) through ``prefill_step``, 8 greedy decode steps and
``serve_lm`` against the reference's ``main_lm``, with the reference's
weights (``params_from_numpy``); every registered LM config's head width
against the ones K6 takes; and ``core/makki.py`` against the
reference's on seeded Eulerian RMAT graphs.

The reference's outputs are built once per module (``lru_cache``).  JAX
is imported inside the tests that compare with it, so the ``gpu`` tests
also run on a machine that has a card and no JAX."""
import dataclasses
import functools
import types
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.core import makki_tour
from repro_torch.core.graph import partition_graph
from repro_torch.core.hierholzer import validate_circuit
from repro_torch.graphgen.eulerize import eulerian_rmat
from repro_torch.graphgen.partition import partition_vertices
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.launch import serve, steps
from repro_torch.models import transformer as tr
from repro_torch.tree import leaves_with_paths, tree_leaves, tree_map

ARCHS = ["starcoder2-7b", "granite-20b"]
#: the reference's param_count of each full config
PARAMS = {"starcoder2-7b": 10_116_960_768, "granite-20b": 28_167_493_632}
#: ROADMAP's f32 tolerances
RTOL, ATOL = 1e-5, 2e-5
#: the reduced configs, and one narrow config per model: the full head
#: layout (heads, KV heads, width 128, RoPE base) at 2 layers, d_model
#: 256, d_ff 512 and vocab 512.  The reduced StarCoder2 keeps RoPE base
#: 10,000, so only its narrow config carries 10⁶.
CONFIGS = [(arch, size) for arch in ARCHS for size in ("reduced", "narrow")]
NARROW = dict(n_layers=2, d_model=256, d_ff=512, vocab=512, d_head=128,
              remat=False)
#: 8 greedy decode steps after a prompt of 24, B 2
DECODE_B, DECODE_P, DECODE_STEPS = 2, 24, 8
#: main_lm's shape: its prompts (``default_rng(0)``), B 2, P 16, 6
#: generated
SERVE_B, SERVE_P, SERVE_GEN = 2, 16, 6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small CPU work: one intra-op thread runs it fastest beside the
    suite's other workers; the setting is restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_cfg(arch, size):
    if size == "reduced":
        return registry.get_config(arch, reduced=True).model
    return dataclasses.replace(registry.get_config(arch).model,
                               name=f"{arch}-narrow", dtype=torch.float32,
                               **NARROW)


def jax_cfg(arch, size):
    import jax.numpy as jnp
    from repro.configs.registry import get_config as j_get

    if size == "reduced":
        return j_get(arch, reduced=True).model
    return dataclasses.replace(j_get(arch).model, name=f"{arch}-narrow",
                               dtype=jnp.float32, **NARROW)


@functools.lru_cache(maxsize=None)
def jax_params(arch, size):
    """The reference's seeded weights (``PRNGKey(0)``, as its ``main_lm``)
    as a numpy tree, ``layers`` stacked."""
    import jax
    from repro.models.transformer import init_lm_params

    params = init_lm_params(jax.random.PRNGKey(0), jax_cfg(arch, size))
    return jax.tree_util.tree_map(np.asarray, params)


def prompts(batch, length, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (batch, length)).astype(np.int32)


def close(mine, want):
    np.testing.assert_allclose(np.asarray(mine.float()),
                               np.asarray(want, np.float32), rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------- configs --

@pytest.mark.parametrize("arch", ARCHS)
def test_full_configs_have_the_reference_layout_and_count(arch):
    cfg = registry.get_config(arch).model
    want = {"starcoder2-7b": (32, 4608, 36, 4, 128, 18432, 1_000_000.0),
            "granite-20b": (52, 6144, 48, 1, 128, 24576, 10_000.0)}[arch]
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.rope_theta) == want
    assert cfg.param_count() == cfg.active_param_count() == PARAMS[arch]
    assert cfg.moe is None and cfg.dtype == torch.bfloat16 and cfg.remat
    assert arch in registry.ARCH_IDS


def test_every_registered_lm_config_has_a_head_width_k6_takes():
    """Every LM config, full and reduced, prefills through K6 on a card:
    its (head width, dtype) is one the kernel is instantiated for."""
    lms = []
    for arch in registry.ARCH_IDS:
        for reduced in (False, True):
            a = registry.get_config(arch, reduced=reduced)
            if a.family == "lm":
                cfg = a.model
                assert cfg.dtype in fa.HEAD_DIMS, (arch, reduced)
                assert cfg.head_dim in fa.HEAD_DIMS[cfg.dtype], \
                    (arch, reduced, cfg.head_dim, cfg.dtype)
                lms.append((arch, cfg.head_dim, cfg.dtype))
    assert len(lms) == 10
    assert ("granite-20b", 16, torch.float32) in lms
    assert ("qwen3-moe-235b-a22b", 16, torch.float32) in lms


def test_euler_rmat_waits_for_the_mesh():
    """``euler-rmat`` is registered, last; its cells need a mesh."""
    arch = registry.get_config("euler-rmat")
    assert registry.ARCH_IDS[-1] == "euler-rmat" and arch.family == "euler"
    with pytest.raises(ValueError, match="mesh"):
        steps.build_cell(arch, "superstep")


def _layer_key(path):
    """A port path with its layer index dropped (``layers`` is a list in
    the port and stacked in the reference)."""
    parts = path.split("/")
    if "layers" in parts:
        i = parts.index("layers")
        parts = parts[:i + 1] + parts[i + 2:]
    return "/".join(parts)


def _same_tree(mine, want, stacked_layers):
    """``mine`` (meta tensors, layers a list) against the reference's
    abstract tree (layers stacked [L, …]): shapes and dtypes leaf by
    leaf."""
    import jax

    shapes = {}
    for path, p in leaves_with_paths(mine):
        assert p.device.type == "meta"
        shapes.setdefault(_layer_key(path), set()).add(
            (tuple(p.shape), str(p.dtype).split(".")[-1]))
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                       for k in path)
        shape = leaf.shape
        if "layers" in key.split("/"):
            assert shape[0] == stacked_layers, key
            shape = shape[1:]
        assert shapes.pop(key) == {(tuple(shape), leaf.dtype.name)}, key
    assert not shapes, shapes


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k",
                                   "long_500k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cells_match_the_reference(arch, shape):
    """``build_cell`` at the full configs: the reference's model FLOPs and
    abstract inputs for the three cells, and ``SkippedCell`` at
    long_500k in both packages."""
    from repro.configs.registry import get_config as j_get
    from repro.launch import steps as jsteps

    mine, want = registry.get_config(arch), j_get(arch)
    if shape == "long_500k":
        with pytest.raises(steps.SkippedCell):
            steps.build_cell(mine, shape)
        with pytest.raises(jsteps.SkippedCell):
            jsteps.build_cell(want, shape, None)
        return
    cell = steps.build_cell(mine, shape)
    jcell = jsteps.build_cell(want, shape, None)
    assert cell.model_flops == jcell.model_flops
    L = mine.model.n_layers
    got, ref_in = cell.abstract_inputs, jcell.abstract_inputs
    assert len(got) == len(ref_in)
    _same_tree(got[0], ref_in[0], L)                   # params
    if shape == "train_4k":
        _same_tree({"m": got[1].m, "v": got[1].v},
                   {"m": ref_in[1].m, "v": ref_in[1].v}, L)
        _same_tree(got[2], ref_in[2], L)               # tokens, labels
        assert all(x.dtype == torch.float32 for x in tree_leaves(got[1].m))
    elif shape == "prefill_32k":
        assert tuple(got[1].shape) == ref_in[1].shape == (32, 32768)
    else:
        for name in ("k", "v", "length"):
            a, b = getattr(got[1], name), getattr(ref_in[1], name)
            assert tuple(a.shape) == b.shape, name
            assert str(a.dtype).split(".")[-1] == b.dtype.name, name
        assert tuple(got[1].k.shape) == (
            L, 128, 32768, mine.model.n_kv_heads, 128)
        assert tuple(got[2].shape) == ref_in[2].shape == (128,)


def test_params_from_numpy_handles_one_kv_head():
    """Granite's single KV head: the reference's stacked tree unstacks
    into per-layer [d, 128] key and value matrices, bit for bit, and
    back."""
    tree = jax_params("granite-20b", "narrow")
    p = tr.params_from_numpy(tree)
    assert len(p["layers"]) == 2
    for i, layer in enumerate(p["layers"]):
        assert tuple(layer["wk"].shape) == tuple(layer["wv"].shape) == \
            (256, 128)
        assert tuple(layer["wq"].shape) == (256, 48 * 128)
        for name, a in tree["layers"].items():
            assert np.array_equal(layer[name].numpy(), a[i]), name
    back = tr.params_to_numpy(p)
    for name, a in tree["layers"].items():
        assert np.array_equal(back["layers"][name], a), name
    cache = tr.init_kv_cache(port_cfg("granite-20b", "narrow"), 2, 9)
    assert tuple(cache.k.shape) == (2, 2, 9, 1, 128)


# ------------------------------------------------------------ serving --

@pytest.mark.parametrize("arch,size", CONFIGS)
def test_prefill_matches_jax(arch, size):
    import jax
    import jax.numpy as jnp
    from repro.models.transformer import prefill_step

    cfg = port_cfg(arch, size)
    toks = prompts(2, 40, cfg.vocab, seed=3)
    jp = jax.tree_util.tree_map(jnp.asarray, jax_params(arch, size))
    want_logits, want_cache = prefill_step(jp, jax_cfg(arch, size),
                                           jnp.asarray(toks))
    logits, cache = tr.prefill_step(tr.params_from_numpy(
        jax_params(arch, size)), cfg, torch.from_numpy(toks))
    assert logits.shape == (2, cfg.vocab) and logits.dtype == torch.float32
    close(logits, want_logits)
    close(cache.k, want_cache.k)
    close(cache.v, want_cache.v)
    assert tuple(cache.k.shape) == (2, 2, 40, cfg.n_kv_heads, cfg.head_dim)


@functools.lru_cache(maxsize=None)
def jax_greedy(arch, size):
    """The reference's greedy loop (f32, steps jitted): prefill, the cache
    widened, ``DECODE_STEPS`` decode steps.  Returns the prompts, each
    step's logits and the fed tokens."""
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as jt

    jcfg = jax_cfg(arch, size)
    toks = prompts(DECODE_B, DECODE_P, jcfg.vocab, seed=5)
    jp = jax.tree_util.tree_map(jnp.asarray, jax_params(arch, size))
    prefill = jax.jit(lambda p, t: jt.prefill_step(p, jcfg, t))
    decode = jax.jit(lambda p, c, t: jt.decode_step(p, jcfg, c, t))
    logits, cache = prefill(jp, jnp.asarray(toks))
    full = jt.init_kv_cache(jcfg, DECODE_B, DECODE_P + DECODE_STEPS)
    cache = full._replace(k=full.k.at[:, :, :DECODE_P].set(cache.k),
                          v=full.v.at[:, :, :DECODE_P].set(cache.v),
                          length=cache.length)
    out, fed = [np.asarray(logits)], []
    for _ in range(DECODE_STEPS):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        fed.append(np.asarray(tok))
        logits, cache = decode(jp, cache, tok)
        out.append(np.asarray(logits))
    return toks, out, fed


@pytest.mark.parametrize("arch,size", CONFIGS)
def test_eight_decode_steps_match_jax(arch, size):
    """Prefill, widen, 8 greedy decode steps: the same tokens fed at
    every step and every step's logits within 1e-5/2e-5 (f32)."""
    toks, want, fed = jax_greedy(arch, size)
    cfg = port_cfg(arch, size)
    params = tr.params_from_numpy(jax_params(arch, size))
    logits, part = tr.prefill_step(params, cfg, torch.from_numpy(toks))
    cache = tr.init_kv_cache(cfg, DECODE_B, DECODE_P + DECODE_STEPS)
    cache.k[:, :, :DECODE_P] = part.k
    cache.v[:, :, :DECODE_P] = part.v
    cache = cache._replace(length=part.length)
    close(logits, want[0])
    for i in range(DECODE_STEPS):
        tok = torch.argmax(logits, -1).to(torch.int32)
        assert np.array_equal(tok.numpy(), fed[i]), i
        logits, cache = tr.decode_step(params, cfg, cache, tok)
        close(logits, want[i + 1])
    assert cache.length.tolist() == [DECODE_P + DECODE_STEPS] * DECODE_B


@functools.lru_cache(maxsize=None)
def jax_main_lm_ids(arch, size):
    """The reference's ``main_lm --arch <arch>`` ids at B 2, P 16, gen 6;
    a narrow config is served through the same CLI with the registry's
    reduced config swapped for it."""
    from repro.configs import registry as j_registry
    from repro.launch.serve import main_lm as j_main_lm

    argv = ["--arch", arch, "--batch", str(SERVE_B), "--prompt-len",
            str(SERVE_P), "--gen", str(SERVE_GEN)]
    if size == "reduced":
        return np.asarray(j_main_lm(argv))
    narrow = types.SimpleNamespace(model=jax_cfg(arch, size))
    with mock.patch.object(j_registry, "get_config",
                           lambda arch_id, reduced=False: narrow):
        return np.asarray(j_main_lm(argv))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("arch,size", CONFIGS)
def test_serve_lm_matches_jax_main_lm(arch, size, fused):
    """``serve_lm`` on the CPU (fused: the programs' bodies uncaptured; and
    the eager oracle) gives the reference ``main_lm``'s ids token for
    token from the same weights and prompts (f32)."""
    want = jax_main_lm_ids(arch, size)
    cfg = port_cfg(arch, size)
    toks = prompts(SERVE_B, SERVE_P, cfg.vocab)     # main_lm's prompts
    before = fa.flash_attention.launches
    res = serve.serve_lm(cfg, toks, SERVE_GEN, "cpu",
                         params=tr.params_from_numpy(jax_params(arch, size)),
                         fused=fused)
    assert res.ids.shape == (SERVE_B, SERVE_GEN) and res.ids.dtype == np.int32
    assert np.array_equal(res.ids, want)
    assert fa.flash_attention.launches == before     # the twin counts none


@pytest.mark.parametrize("arch", ARCHS)
def test_main_lm_cli_serves_the_code_lm_on_cpu(arch, capsys):
    ids = serve.main(["--workload", "lm", "--arch", arch, "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    assert ids.shape == (2, 3)
    assert "generated ids" in capsys.readouterr().out


# -------------------------------------------------------------- makki --

@pytest.mark.parametrize("scale,parts", [(7, 4), (7, 8), (10, 4), (10, 8)])
def test_makki_tour_matches_the_reference(scale, parts):
    """``makki_tour`` on a seeded Eulerian RMAT graph partitioned as the
    reference's scaling benchmark partitions it: the circuit and both
    superstep counts equal the reference's, bit for bit, from each
    package's own graph and partition (which are equal too), and the
    circuit is an Euler circuit."""
    from repro.core.graph import partition_graph as j_partition_graph
    from repro.core.makki import makki_tour as j_makki_tour
    from repro.graphgen.eulerize import eulerian_rmat as j_eulerian_rmat
    from repro.graphgen.partition import partition_vertices as j_partition

    g = eulerian_rmat(scale, avg_degree=5, seed=scale)
    jg = j_eulerian_rmat(scale, avg_degree=5, seed=scale)
    assert np.array_equal(g.edge_u, jg.edge_u)
    assert np.array_equal(g.edge_v, jg.edge_v)
    part = partition_vertices(g, parts, seed=0)
    assert np.array_equal(part, j_partition(jg, parts, seed=0))
    pg = partition_graph(g, part)
    jpg = j_partition_graph(jg, part)
    for start in (None, int(g.edge_v[-1])):
        mine = makki_tour(pg, start=start)
        want = j_makki_tour(jpg, start=start)
        assert mine.circuit.dtype == want.circuit.dtype
        assert mine.circuit.tobytes() == want.circuit.tobytes()
        assert mine.supersteps_vertex_centric == \
            want.supersteps_vertex_centric == g.num_edges
        assert mine.supersteps_partition_centric == \
            want.supersteps_partition_centric
        validate_circuit(g, mine.circuit)
    assert 0 < mine.supersteps_partition_centric < g.num_edges


# ------------------------------------------------------------ the card --

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,T,Hq,Hkv,causal", [
    (4, 64, 64, 8, 1, True), (4, 64, 64, 8, 2, True),
    (1, 97, 203, 8, 1, True), (2, 300, 300, 6, 2, False)])
def test_cuda_k6_f32_at_head_width_16_matches_twin(B, S, T, Hq, Hkv, causal):
    """``flash_f32_kernel<16>``: the reduced configs' prefill shapes
    (main_lm's B 4, S 64, 8:1 and 8:2) and ragged ones, one launch each,
    within 2e-5 of the twin; bf16 at width 16 raises."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(S * T + Hq)
    q = torch.randn(B, S, Hq, 16, generator=gen, device=dev)
    k = torch.randn(B, T, Hkv, 16, generator=gen, device=dev)
    v = torch.randn(B, T, Hkv, 16, generator=gen, device=dev)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal)
    rep = Hq // Hkv
    want = ref.flash_attention_ref(q, k.repeat_interleave(rep, 2),
                                   v.repeat_interleave(rep, 2), causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="head dim 16"):
        fa.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS + ["qwen3-moe-235b-a22b"])
def test_cuda_reduced_serving_matches_cpu(arch):
    """Each reduced config in f32 (K6 at head width 32 or 16), batch 2,
    prompt 64, gen 8, one set of seeded weights on both devices: prefill
    logits within 2e-5 and the fused serve's ids equal to the CPU's."""
    dev = _cuda()
    cfg = registry.get_config(arch, reduced=True).model
    params = tr.init_lm_params(torch.Generator().manual_seed(0), cfg)
    on_card = tree_map(lambda x: x.to(dev), params)
    toks = prompts(2, 64, cfg.vocab)
    want, _ = tr.prefill_step(params, cfg, torch.from_numpy(toks))
    got, _ = tr.prefill_step(on_card, cfg, torch.from_numpy(toks).to(dev))
    torch.testing.assert_close(got.cpu(), want, rtol=2e-5, atol=2e-5)
    cpu = serve.serve_lm(cfg, toks, 8, "cpu", params=params)
    card = serve.serve_lm(cfg, toks, 8, dev, params=on_card)
    assert np.array_equal(cpu.ids, card.ids)
    assert card.captures == 1
