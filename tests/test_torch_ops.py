"""K5 (sorted segment sum) and K6 (flash attention): the port's plain-torch
twins against the JAX oracles (and, for K5, the Pallas kernel in
interpret mode, also on skewed ids that reach the CUDA kernel's tile
edges), ``ops`` against the model's row-blocked attention, the
wrappers' device rule and checks on the CPU, and — on a card — the CUDA
kernels against the twins.

JAX is imported inside the tests that compare with it, so the ``gpu``
tests also run on a machine that has a card and no JAX
(``pytest -m gpu tests/test_torch_ops.py``)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import pointer_double as pd
from repro_torch.kernels import segment_reduce as sr

# tests/test_kernels.py's sweeps
SEG_CASES = [(256, 32, 16), (1024, 64, 37), (2048, 128, 200), (512, 16, 1)]
FLASH_CASES = [(1, 128, 1, 64, 128), (2, 256, 3, 64, 256),
               (1, 256, 2, 128, 512)]
TORCH_DT = {"float32": torch.float32, "float16": torch.float16,
            "bfloat16": torch.bfloat16}


def seg_inputs(N, D, S, dtype, pad=0, seed=None):
    """tests/test_kernels.py's seeded sorted ids (``pad`` extra ids past
    S are padding) and normal values."""
    rng = np.random.default_rng(N + S if seed is None else seed)
    seg = np.sort(rng.integers(0, S + pad, N)).astype(np.int32)
    vals = rng.normal(size=(N, D)).astype(dtype)
    return vals, seg


def skewed_seg_inputs(D, dtype, N=4096, S=300, seed=11):
    """Sorted ids that reach the CUDA kernel's edges at any tile of 128,
    256, 512 or 1,024 rows: 8 padding ids below 0 first; segment 0 over
    rows 8 … 1,535 (many tiles of 128 rows); segments 1 and 2 empty;
    segment 3 over rows 1,536 … 2,047, so a tile edge falls on each of its
    two segment edges; then skewed ids ``4 + floor((S − 12)·u²)``, which
    leave gaps and the last 8 segments empty; 6 ids ≥ S last."""
    rng = np.random.default_rng(seed)
    tail = N - 2048 - 6
    seg = np.concatenate([
        np.full(5, -3), np.full(3, -1), np.zeros(1528), np.full(512, 3),
        np.sort(4 + np.floor((S - 12) * rng.random(tail) ** 2)),
        np.full(6, S + 1)]).astype(np.int32)
    return rng.normal(size=(N, D)).astype(dtype), seg


def long_segment_atol(seg, S, atol):
    """``atol`` per output row plus 2^-22 per input row of the segment:
    two f32 sums of n unit-normal terms taken in different orders differ by
    about 2^-24·n (the rounding of n partial sums up to about √n each), so
    a segment of 1,528 rows may differ by 1e-4, more than the
    ``tol · 8`` that covers short ones."""
    ok = (seg >= 0) & (seg < S)
    counts = np.bincount(seg[ok], minlength=S).astype(np.float64)
    return (atol + counts * 2.0 ** -22)[:, None]


def as_f32(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("N,D,S", SEG_CASES)
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_k5_twin_matches_jax_ref(N, D, S, dtype):
    import jax.numpy as jnp
    from repro.kernels import ref as jref

    vals, seg = seg_inputs(N, D, S, dtype)
    mine = ref.segment_sum_sorted_ref(torch.from_numpy(vals),
                                      torch.from_numpy(seg), S)
    assert mine.dtype == torch.from_numpy(vals).dtype
    # ground truth in f32, as tests/test_kernels.py
    want = jref.segment_sum_sorted_ref(jnp.asarray(vals.astype(np.float32)),
                                       jnp.asarray(seg), S)
    tol = 1e-5 if dtype == np.float32 else 2e-2
    np.testing.assert_allclose(as_f32(mine.float()), as_f32(want),
                               rtol=tol, atol=tol * 8)


@pytest.mark.parametrize("N,D,S", SEG_CASES)
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_k5_twin_matches_pallas(N, D, S, dtype):
    import jax.numpy as jnp
    from repro.kernels.segment_reduce import segment_sum_sorted as j_seg

    vals, seg = seg_inputs(N, D, S, dtype)
    mine = ref.segment_sum_sorted_ref(torch.from_numpy(vals),
                                      torch.from_numpy(seg), S)
    want = j_seg(jnp.asarray(vals), jnp.asarray(seg), S, interpret=True)
    tol = 1e-5 if dtype == np.float32 else 2e-2
    np.testing.assert_allclose(as_f32(mine.float()), as_f32(want),
                               rtol=tol, atol=tol * 8)


def test_k5_twin_with_padding_ids():
    """tests/test_kernels.py's padding case: ids ≥ S are dropped."""
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.segment_reduce import segment_sum_sorted as j_seg

    vals, seg = seg_inputs(512, 32, 20, np.float32, pad=5, seed=0)
    mine = ref.segment_sum_sorted_ref(torch.from_numpy(vals),
                                      torch.from_numpy(seg), 20)
    for want in (jref.segment_sum_sorted_ref(jnp.asarray(vals),
                                             jnp.asarray(seg), 20),
                 j_seg(jnp.asarray(vals), jnp.asarray(seg), 20,
                       interpret=True)):
        np.testing.assert_allclose(mine.numpy(), as_f32(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("D", [16, 128])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_k5_twin_matches_jax_ref_and_pallas_on_skewed_ids(D, dtype):
    """Padding at both ends, a segment of many tiles, empty segments and
    tile edges on segment edges (:func:`skewed_seg_inputs`): the twin
    against the jnp oracle in f32 and the Pallas kernel in interpret
    mode."""
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.segment_reduce import segment_sum_sorted as j_seg

    S = 300
    vals, seg = skewed_seg_inputs(D, dtype)
    mine = ref.segment_sum_sorted_ref(torch.from_numpy(vals),
                                      torch.from_numpy(seg), S)
    assert mine.dtype == torch.from_numpy(vals).dtype
    assert not bool(mine[[1, 2, S - 1]].any())
    tol = 1e-5 if dtype == np.float32 else 2e-2
    atol = long_segment_atol(seg, S, tol * 8)
    for want in (jref.segment_sum_sorted_ref(
                     jnp.asarray(vals.astype(np.float32)), jnp.asarray(seg),
                     S),
                 j_seg(jnp.asarray(vals), jnp.asarray(seg), S,
                       interpret=True)):
        got, want = as_f32(mine.float()), as_f32(want)
        assert (np.abs(got - want) <= tol * np.abs(want) + atol).all()


def test_k5_twin_drops_negative_ids_and_zeroes_empty_segments():
    vals = torch.arange(12, dtype=torch.float32).view(6, 2)
    seg = torch.tensor([-3, -1, 0, 0, 3, 7], dtype=torch.int32)
    got = ref.segment_sum_sorted_ref(vals, seg, 4)
    want = torch.tensor([[4.0 + 6.0, 5.0 + 7.0], [0, 0], [0, 0], [8, 9]])
    assert torch.equal(got, want)


def flash_inputs(B, S, H, D, T, dtype, Hkv=None, seed=None):
    rng = np.random.default_rng(S + H if seed is None else seed)
    Hkv = H if Hkv is None else Hkv
    return (rng.normal(size=(B, S, H, D)).astype(np.float32),
            rng.normal(size=(B, T, Hkv, D)).astype(np.float32),
            rng.normal(size=(B, T, Hkv, D)).astype(np.float32))


@pytest.mark.parametrize("B,S,H,D,T", FLASH_CASES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k6_twin_matches_jax_ref(B, S, H, D, T, causal, dtype):
    import jax.numpy as jnp
    from repro.kernels import ref as jref

    arrays = flash_inputs(B, S, H, D, T, dtype)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = jref.flash_attention_ref(*(jnp.asarray(a, jdt) for a in arrays),
                                    causal=causal)
    mine = ref.flash_attention_ref(
        *(torch.from_numpy(a).to(TORCH_DT[dtype]) for a in arrays),
        causal=causal)
    assert mine.dtype == TORCH_DT[dtype] and mine.shape == (B, S, H, D)
    tol = 2e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(as_f32(mine.float()), as_f32(want),
                               rtol=tol, atol=tol)


def test_flash_gqa_matches_chunked_model_path():
    """``ops.flash_attention_gqa`` (the twin on the CPU) against the JAX
    model's row-blocked attention (tests/test_kernels.py's
    ``test_flash_vs_chunked_model_path``, whose Pallas side cannot run on
    the installed jax)."""
    import jax.numpy as jnp
    from repro.models.layers import chunked_gqa_attention

    rng = np.random.default_rng(7)
    B, S, Hq, Hkv, D = 2, 256, 4, 2, 64
    q = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    want = chunked_gqa_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), q_block=128)
    before = fa.flash_attention.launches
    mine = ops.flash_attention_gqa(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=True)
    assert fa.flash_attention.launches == before
    np.testing.assert_allclose(mine.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_ops_route_to_the_wrappers_on_cpu():
    vals, seg = seg_inputs(256, 8, 10, np.float32)
    v, s = torch.from_numpy(vals), torch.from_numpy(seg)
    before = sr.segment_sum_sorted.launches
    assert torch.equal(ops.segment_sum_sorted(v, s, 10),
                       ref.segment_sum_sorted_ref(v, s, 10))
    assert sr.segment_sum_sorted.launches == before
    # K1 keeps the reference's two-array signature: packed, one round
    # through the packed wrapper's twin, unpacked into contiguous arrays
    nxt = torch.tensor([1, 2, 0], dtype=torch.int32)
    lab = torch.tensor([2, 0, 1], dtype=torch.int32)
    before = pd.pointer_double.launches
    got = ops.pointer_double(nxt, lab)
    assert pd.pointer_double.launches == before
    assert len(got) == 2 and all(g.is_contiguous() for g in got)
    assert all(torch.equal(a, b)
               for a, b in zip(got, ref.pointer_double_ref(nxt, lab)))


def test_k5_wrapper_checks_its_tensors():
    vals, seg = (torch.from_numpy(x) for x in seg_inputs(64, 4, 8,
                                                         np.float32))
    with pytest.raises(TypeError):
        sr.segment_sum_sorted(vals.double(), seg, 8)
    with pytest.raises(TypeError):
        sr.segment_sum_sorted(vals, seg.long(), 8)
    with pytest.raises(ValueError):
        sr.segment_sum_sorted(vals, seg[:32], 8)
    with pytest.raises(ValueError):
        sr.segment_sum_sorted(vals.t(), seg[:4], 8)
    with pytest.raises(ValueError):
        sr.segment_sum_sorted(vals, seg, -1)


def test_k6_wrapper_checks_its_tensors():
    q, k, v = (torch.from_numpy(x)
               for x in flash_inputs(1, 8, 4, 32, 8, "float32", Hkv=2))
    with pytest.raises(TypeError):
        fa.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        fa.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError):                  # 4 heads over 3
        fa.flash_attention(q, k[:, :, :1].expand(1, 8, 3, 32), v[:, :, :1]
                           .expand(1, 8, 3, 32))
    with pytest.raises(ValueError):                  # causal needs T ≥ S
        fa.flash_attention(q, k[:, :4], v[:, :4], causal=True)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k[..., :16], v[..., :16])
    # non-causal with T < S is allowed
    assert fa.flash_attention(q, k[:, :4], v[:, :4], causal=False).shape \
        == q.shape


# ------------------------------------------------------------- the card --

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("N,D,S,pad", [(256, 32, 16, 0), (1024, 64, 37, 3),
                                       (2048, 128, 200, 0), (512, 16, 1, 2),
                                       (10556, 1433, 2708, 0),
                                       (100_000, 100, 5000, 7)])
def test_cuda_k5_matches_twin(dtype, N, D, S, pad):
    dev = _cuda()
    vals, seg = seg_inputs(N, D, S, np.float32, pad=pad)
    seg[: N // 50] = -1                          # negative ids are dropped
    v = torch.from_numpy(vals).to(dev, TORCH_DT[dtype])
    s = torch.from_numpy(seg).to(dev)
    before = sr.segment_sum_sorted.launches
    got = sr.segment_sum_sorted(v, s, S)
    want = ref.segment_sum_sorted_ref(v, s, S)
    torch.cuda.synchronize()
    assert sr.segment_sum_sorted.launches == before + 1
    assert got.dtype == v.dtype and got.shape == (S, D)
    tol = 1e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol * 8)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("D,offset", [
    # row pitch (f32 / half) and the vector the kernel takes
    (128, 0),    # 512 / 256 B: 16-byte loads
    (100, 0),    # 400 / 200 B: 16 / 8
    (50, 0),     # 200 / 100 B: 8 / 4
    (1433, 0),   # 5,732 / 2,866 B: 4 / 2
    (128, 1)])   # base one element past 16-byte alignment: 4 / 2
def test_cuda_k5_skewed_matches_twin(dtype, D, offset):
    """The row-tiled kernel on :func:`skewed_seg_inputs` against the
    twin, at every vector width the kernel picks."""
    dev = _cuda()
    S = 300
    vals, seg = skewed_seg_inputs(D, np.float32)
    flat = torch.empty(vals.size + offset, dtype=TORCH_DT[dtype],
                       device=dev)
    v = flat[offset:].view(vals.shape)
    v.copy_(torch.from_numpy(vals))
    s = torch.from_numpy(seg).to(dev)
    before = sr.segment_sum_sorted.launches
    got = sr.segment_sum_sorted(v, s, S)
    want = ref.segment_sum_sorted_ref(v.cpu(), s.cpu(), S)
    torch.cuda.synchronize()
    assert sr.segment_sum_sorted.launches == before + 1
    assert got.dtype == v.dtype and got.shape == (S, D)
    tol = 1e-5 if dtype == "float32" else 2e-2
    atol = torch.from_numpy(long_segment_atol(seg, S, tol * 8)).float()
    diff = (got.cpu().float() - want.float()).abs()
    assert bool((diff <= tol * want.float().abs() + atol).all())
    assert not bool(got[[1, 2, S - 1]].any())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,T", [
    (1, 128, 1, 1, 64, 128), (2, 256, 3, 3, 64, 256),
    (1, 256, 2, 2, 128, 512), (2, 64, 3, 1, 32, 64),
    (1, 97, 6, 2, 64, 203), (2, 4097, 15, 5, 64, 4097),
    (1, 1, 15, 5, 64, 1), (1, 300, 4, 4, 128, 300),
    # the wgmma kernel's edges: one row past a 128-row block, a causal
    # offset with ragged query and key tiles, GQA 4/1 at D 128, D 32
    (1, 129, 2, 1, 64, 129), (1, 191, 3, 1, 64, 383),
    (3, 1024, 4, 1, 128, 1024), (2, 200, 2, 2, 32, 200)])
def test_cuda_k6_matches_twin(dtype, causal, B, S, Hq, Hkv, D, T):
    dev = _cuda()
    q, k, v = (torch.from_numpy(x).to(dev, TORCH_DT[dtype])
               for x in flash_inputs(B, S, Hq, D, T, dtype, Hkv=Hkv,
                                     seed=S * T + Hq))
    torch.backends.cuda.matmul.allow_tf32 = False
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal)
    rep = Hq // Hkv
    want = ref.flash_attention_ref(q, k.repeat_interleave(rep, 2),
                                   v.repeat_interleave(rep, 2),
                                   causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    tol = 2e-5 if dtype == "float32" else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)
    if dtype == "bfloat16":
        # late causal rows' values are near 0.03, so 3e-2 absolute alone
        # would pass a kernel wrong by a typical value there; scaled by
        # |want| plus the row's RMS the limit (chip_smoke.K6_BF16_TOL)
        # covers the twin's bf16 score rounding, not a dropped KV tile
        g, w = got.float(), want.float()
        rms = w.pow(2).mean(-1, keepdim=True).sqrt()
        assert ((g - w).abs() <= 5e-2 * (w.abs() + rms)).all()


@pytest.mark.gpu
def test_cuda_k6_rejects_other_head_dims():
    dev = _cuda()
    q = torch.zeros(1, 8, 2, 48, device=dev)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
