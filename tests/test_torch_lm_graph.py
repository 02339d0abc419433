"""The LM serving steps as recorded programs: ``serve_lm(fused=True)``
(``repro_torch.launch.serve.LMPrograms``, the reference's jitted
``prefill`` and ``decode`` of ``main_lm``) against the eager oracle
``serve_lm(fused=False)`` on the reduced SmolLM-360M config.

On the CPU the programs' bodies run uncaptured on their static buffers
(prompts, tokens, the widened cache, the ids), so these tests hold the
buffer logic: the same ids and the same logits, byte for byte, as the
eager loop, the same cache after every step, and a second serve of the
same programs that starts from a clean state.  On a card (``gpu`` tests)
the two programs are CUDA graphs, recorded once and replayed."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.smollm_360m import CONFIG
from repro_torch.core import capture
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import transformer as tr

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: the decode replay's logits against eager ``decode_step`` on a card, in
#: f32: the graph runs the eager kernels, so the bits should agree (the
#: full-width bf16 replays in chip_smoke.py read 0.0); this bound
#: (chip_smoke.py's DECODE_F32_TOL) admits cuBLAS choosing other products
#: under capture, and the greedy tokens must agree regardless
CARD_F32_TOL = 1e-4


def cfg_of(dtype="float32"):
    return dataclasses.replace(CONFIG.reduced().model,
                               dtype=TORCH_DT[dtype])


def weights(cfg, device="cpu", seed=0):
    params = tr.init_lm_params(torch.Generator().manual_seed(seed), cfg)
    return {k: ([{n: t.to(device) for n, t in layer.items()} for layer in v]
                if k == "layers" else v.to(device))
            for k, v in params.items()}


def prompts(batch, length, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (batch, length)).astype(np.int32)


def eager_steps(params, cfg, toks, gen, steps):
    """The eager loop by hand: prefill, widen to P + gen, then ``steps``
    decode steps; yields (logits, cache) after the prefill and after each
    step."""
    P = toks.shape[1]
    logits, part = tr.prefill_step(params, cfg, toks)
    cache = tr.init_kv_cache(cfg, toks.shape[0], P + gen,
                             device=toks.device)
    cache.k[:, :, :P] = part.k
    cache.v[:, :, :P] = part.v
    cache = cache._replace(length=part.length)
    yield logits, cache
    for _ in range(steps):
        tok = torch.argmax(logits, -1).to(torch.int32)
        logits, cache = tr.decode_step(params, cfg, cache, tok)
        yield logits, cache


# --------------------------------------------------------------- the CPU --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("length", [16, 37])
def test_fused_serving_equals_eager(dtype, batch, length):
    cfg = cfg_of(dtype)
    params = weights(cfg)
    toks = prompts(batch, length, cfg.vocab, seed=length)
    eager = serve.serve_lm(cfg, toks, 7, "cpu", params=params, fused=False)
    fused = serve.serve_lm(cfg, toks, 7, "cpu", params=params)
    assert fused.ids.shape == (batch, 7) and fused.ids.dtype == np.int32
    assert np.array_equal(fused.ids, eager.ids)
    assert fused.logits.dtype == cfg.dtype
    assert torch.equal(fused.logits, eager.logits)
    # the CPU records nothing
    assert (fused.captures, fused.warmup_s, fused.capture_s) == (0, 0.0, 0.0)
    assert fused.prefill_s > 0 and fused.decode_s > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_static_body_follows_the_eager_loop(dtype):
    """After the prefill and after each of 5 decode steps the static
    cache (keys, values, lengths) and the last logits equal the eager
    loop's, byte for byte; the fed token and the ids follow greedily."""
    cfg = cfg_of(dtype)
    params = weights(cfg, seed=2)
    B, P, gen, steps = 3, 21, 8, 5
    toks = torch.from_numpy(prompts(B, P, cfg.vocab, seed=3))
    prog = serve.LMPrograms(cfg, params, B, P, gen, "cpu")
    prog.load(toks)
    want = eager_steps(params, cfg, toks, gen, steps)
    greedy = []
    for step in range(steps + 1):
        if step == 0:
            prog.prefill()
            got = prog.prefill_logits
        else:
            prog.decode()
            got = prog.logits
        logits, cache = next(want)
        assert torch.equal(got, logits), step
        assert torch.equal(prog.cache.k, cache.k), step
        assert torch.equal(prog.cache.v, cache.v), step
        assert torch.equal(prog.cache.length, cache.length), step
        assert prog.cache.length.tolist() == [P + step] * B
        greedy.append(torch.argmax(logits, -1).to(torch.int32))
        assert torch.equal(prog.tokens, greedy[-1])
    assert torch.equal(prog.ids[:, :steps + 1], torch.stack(greedy, 1))


def test_second_serve_of_the_same_programs_starts_clean():
    """The same programs serve again (the CPU records nothing: captures
    stays 0, no warm-up, no capture) and give the eager ids and logits
    of the new prompts: the prefill resets every static buffer the
    earlier serve wrote, the cache past the prompt included."""
    cfg = cfg_of()
    params = weights(cfg, seed=1)
    prog = serve.LMPrograms(cfg, params, 2, 12, 6, "cpu")
    for seed in (0, 1, 0):
        toks = prompts(2, 12, cfg.vocab, seed=seed)
        want = serve.serve_lm(cfg, toks, 6, "cpu", params=params,
                              fused=False)
        got = serve.serve_lm(cfg, toks, 6, "cpu", programs=prog)
        assert np.array_equal(got.ids, want.ids)
        assert torch.equal(got.logits, want.logits)
        assert (got.captures, got.warmup_s, got.capture_s) == (0, 0.0, 0.0)
        # the positions no step reached hold zeros, as in a fresh cache
        assert not prog.cache.k[:, :, 12 + 5:].any()


def test_one_token_needs_no_decode_step():
    cfg = cfg_of()
    params = weights(cfg)
    toks = prompts(2, 9, cfg.vocab)
    want = serve.serve_lm(cfg, toks, 1, "cpu", params=params, fused=False)
    got = serve.serve_lm(cfg, toks, 1, "cpu", params=params)
    assert got.ids.shape == (2, 1) and np.array_equal(got.ids, want.ids)
    assert torch.equal(got.logits, want.logits)


def test_programs_of_another_shape_raise():
    """Programs replay only their own shape, weights and device; any
    other call raises and records nothing."""
    cfg = cfg_of()
    params = weights(cfg)
    prog = serve.LMPrograms(cfg, params, 2, 16, 6, "cpu")
    toks = prompts(2, 16, cfg.vocab)
    for bad in (dict(prompts=prompts(2, 17, cfg.vocab)),
                dict(prompts=prompts(3, 16, cfg.vocab)),
                dict(gen=7),
                dict(params=weights(cfg)),
                dict(cfg=cfg_of("bfloat16"))):
        call = dict(cfg=cfg, prompts=toks, gen=6, params=params)
        call.update(bad)
        with pytest.raises(ValueError, match="make LMPrograms"):
            serve.serve_lm(call["cfg"], call["prompts"], call["gen"], "cpu",
                           params=call["params"], programs=prog)
    with pytest.raises(ValueError, match="fused=True"):
        serve.serve_lm(cfg, toks, 6, "cpu", fused=False, programs=prog)
    with pytest.raises(ValueError, match="≥ 1"):
        serve.LMPrograms(cfg, params, 2, 16, 0, "cpu")
    assert prog.captures == 0 and prog.graphs is None


def test_params_default_to_the_programs_weights():
    cfg = cfg_of()
    params = weights(cfg, seed=5)
    toks = prompts(1, 10, cfg.vocab)
    prog = serve.LMPrograms(cfg, params, 1, 10, 4, "cpu")
    got = serve.serve_lm(cfg, toks, 4, "cpu", programs=prog)
    want = serve.serve_lm(cfg, toks, 4, "cpu", params=params, fused=False)
    assert np.array_equal(got.ids, want.ids)


def test_a_loop_recorded_without_loops_raises():
    """``capture.recording(graph)`` counts into no :class:`Loops`: a
    splice loop recorded in such a body raises instead of recording a
    while node nothing would keep (taken here through ``counting(None)``,
    which the recording enters)."""
    flag = torch.ones(2, dtype=torch.bool)
    with capture.counting(None):
        with pytest.raises(RuntimeError, match="counting"):
            capture.device_while(lambda: None, flag, 3)


def test_launch_counts_name_the_six_kernels():
    counts = ops.launch_counts()
    assert set(counts) == {"pointer_double", "pointer_double_rank",
                           "pointer_double_shard",
                           "pointer_double_rank_shard",
                           "segment_sum_sorted", "flash_attention"}
    assert counts["flash_attention"] == fa.flash_attention.launches


# -------------------------------------------------------------- the card --

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: a CUDA graph records only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_decode_replay_matches_eager_decode_step():
    """Four decode replays against four eager ``decode_step``s from the
    same state (the static cache and token copied after a prefill
    replay), f32: the same greedy tokens, logits within CARD_F32_TOL."""
    dev = _cuda()
    cfg = cfg_of()
    params = weights(cfg, dev)
    B, P, gen = 2, 64, 8
    prog = serve.LMPrograms(cfg, params, B, P, gen, dev)
    prog.load(torch.from_numpy(prompts(B, P, cfg.vocab)).to(dev))
    prog.ready()
    prog.prefill()
    cache = tr.KVCache(*(x.clone() for x in prog.cache))
    tok = prog.tokens.clone()
    for step in range(4):
        prog.decode()
        logits, cache = tr.decode_step(params, cfg, cache, tok)
        tok = torch.argmax(logits, -1).to(torch.int32)
        torch.testing.assert_close(prog.logits, logits, rtol=CARD_F32_TOL,
                                   atol=CARD_F32_TOL)
        assert torch.equal(prog.tokens, tok), step
        assert torch.equal(prog.cache.length, cache.length), step
    assert prog.captures == 1


@pytest.mark.gpu
def test_cuda_graphs_record_k6_in_the_prefill_only():
    """Unrecorded programs on a card raise instead of running eagerly;
    the prefill graph holds one K6 launch a layer, the decode graph none,
    and neither any K1–K5; a replay launches no wrapper."""
    dev = _cuda()
    cfg = cfg_of()
    params = weights(cfg, dev)
    prog = serve.LMPrograms(cfg, params, 2, 64, 4, dev)
    with pytest.raises(RuntimeError, match="ready"):
        prog.prefill()                  # no eager run on a card
    toks = prompts(2, 64, cfg.vocab)
    serve.serve_lm(cfg, toks, 4, dev, programs=prog)
    want = {name: 0 for name in ops.launch_counts()}
    assert prog.recorded["decode"] == want
    want["flash_attention"] = cfg.n_layers
    assert prog.recorded["prefill"] == want
    before = ops.launch_counts()
    res = serve.serve_lm(cfg, toks, 4, dev, programs=prog)
    assert ops.launch_counts() == before
    assert res.captures == 1 and res.capture_s == 0.0


@pytest.mark.gpu
def test_cuda_host_read_in_a_recording_raises_then_serves():
    """A host read (``.item()``) inside ``capture.recording`` raises
    before it reaches the card; the device is left usable and a fused
    serve afterwards records, replays and equals the eager ids."""
    dev = _cuda()
    cfg = cfg_of()
    params = weights(cfg, dev)
    x = torch.ones(4, device=dev)
    (x * 2).sum()
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="synchroniz"):
        with capture.recording(graph):
            (x * 2).sum().item()
    assert torch.cuda.get_sync_debug_mode() == 0
    del graph
    toks = prompts(2, 32, cfg.vocab)
    got = serve.serve_lm(cfg, toks, 6, dev, params=params)
    want = serve.serve_lm(cfg, toks, 6, dev, params=params, fused=False)
    assert got.captures == 1 and got.capture_s > 0
    assert np.array_equal(got.ids, want.ids)


@pytest.mark.gpu
def test_cuda_fused_serving_matches_cpu():
    """The fused twin of ``test_torch_lm.py::test_cuda_serving_matches_cpu``:
    reduced config in f32, batch 2, prompt 64, gen 8, the same weights on
    both devices: greedy ids equal to the CPU's; the recording holds one
    K6 launch a layer; a second serve of the same programs records
    nothing and launches no kernel from Python."""
    dev = _cuda()
    cfg = cfg_of()
    params = weights(cfg)
    on_card = weights(cfg, dev)
    toks = prompts(2, 64, cfg.vocab)
    cpu = serve.serve_lm(cfg, toks, 8, "cpu", params=params)
    prog = serve.LMPrograms(cfg, on_card, 2, 64, 8, dev)
    card = serve.serve_lm(cfg, toks, 8, dev, programs=prog)
    assert np.array_equal(cpu.ids, card.ids)
    assert card.captures == 1 and card.warmup_s > 0 and card.capture_s > 0
    assert prog.recorded["prefill"]["flash_attention"] == cfg.n_layers
    before = fa.flash_attention.launches
    again = serve.serve_lm(cfg, toks, 8, dev, programs=prog)
    assert fa.flash_attention.launches == before
    assert again.captures == 1 and again.capture_s == 0.0
    assert np.array_equal(again.ids, cpu.ids)
