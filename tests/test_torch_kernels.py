"""K1/K2 pointer-doubling: the port's plain-torch twins against the JAX
oracles and Pallas kernels (interpret mode), the wrappers' device rule on
the CPU, and — on a card — the CUDA kernels against the twins.

JAX is imported inside the tests that compare with it, so the ``gpu``
tests also run on a machine that has a card and no JAX
(``pytest -m gpu tests/test_torch_kernels.py``)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import pointer_double as pd
from repro_torch.kernels import ref

# the inputs of tests/test_kernels.py, plus lengths no block divides
CASES = [(1024, 256), (4096, 2048), (8192, 512), (1000, 256), (3000, 2048)]


def k1_inputs(N):
    rng = np.random.default_rng(N)
    return (rng.integers(0, N, N).astype(np.int32),
            rng.permutation(N).astype(np.int32))


def k2_inputs(N):
    rng = np.random.default_rng(N + 1)
    ptr = rng.integers(0, N, N).astype(np.int32)
    t = int(ptr[0])
    ptr[t] = t                                    # halt node self-loops
    dist = np.ones(N, np.int32)
    dist[t] = 0
    reach = np.zeros(N, np.int32)
    reach[t] = 1
    return ptr, dist, reach


def same(a, b):
    return all(np.array_equal(np.asarray(x), y.numpy()) for x, y in zip(a, b))


@pytest.mark.parametrize("N,block", CASES)
def test_k1_twin_matches_jax_ref_and_pallas(N, block):
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.pointer_double import pointer_double as j_pd

    ins = k1_inputs(N)
    mine = ref.pointer_double_ref(*(torch.from_numpy(x) for x in ins))
    assert same(jref.pointer_double_ref(*(jnp.asarray(x) for x in ins)), mine)
    assert same(j_pd(*(jnp.asarray(x) for x in ins), block=block,
                     interpret=True), mine)


@pytest.mark.parametrize("N,block", CASES)
def test_k2_twin_matches_jax_ref_and_pallas(N, block):
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.pointer_double import pointer_double_rank as j_pdr

    ins = k2_inputs(N)
    mine = ref.pointer_double_rank_ref(*(torch.from_numpy(x) for x in ins))
    assert same(jref.pointer_double_rank_ref(*(jnp.asarray(x) for x in ins)),
                mine)
    assert same(j_pdr(*(jnp.asarray(x) for x in ins), block=block,
                      interpret=True), mine)


@pytest.mark.parametrize("kernel,twin,make", [
    (pd.pointer_double, ref.pointer_double_ref, k1_inputs),
    (pd.pointer_double_rank, ref.pointer_double_rank_ref, k2_inputs),
])
def test_wrapper_on_cpu_runs_the_twin_and_counts_nothing(kernel, twin, make):
    ins = tuple(torch.from_numpy(x) for x in make(1000))
    before = kernel.launches
    want = twin(*ins)
    assert all(torch.equal(a, b) for a, b in zip(kernel(*ins), want))
    out = tuple(torch.empty_like(x) for x in ins)
    got = kernel(*ins, out=out)
    assert all(g is o for g, o in zip(got, out))
    assert all(torch.equal(a, b) for a, b in zip(out, want))
    assert kernel.launches == before


def test_wrapper_checks_its_tensors():
    nxt, lab = (torch.from_numpy(x) for x in k1_inputs(64))
    with pytest.raises(TypeError):
        pd.pointer_double(nxt.long(), lab.long())
    with pytest.raises(ValueError):
        pd.pointer_double(nxt, lab[:32])
    with pytest.raises(ValueError):
        pd.pointer_double(nxt[::2], lab[::2])
    with pytest.raises(ValueError):                 # in place would race
        pd.pointer_double(nxt, lab, out=(nxt, torch.empty_like(lab)))
    with pytest.raises(ValueError):
        pd.pointer_double(nxt, lab, out=(lab[:64].clone(), lab))


def test_doubling_rounds_rank_a_list():
    """Chained twin rounds compute list ranks on a chain (the reference's
    ``test_pointer_double_rank_ranks_a_list``)."""
    N = 256
    ptr = torch.clamp(torch.arange(N, dtype=torch.int32) + 1, max=N - 1)
    dist = torch.ones(N, dtype=torch.int32)
    dist[N - 1] = 0
    reach = torch.zeros(N, dtype=torch.int32)
    reach[N - 1] = 1
    cur = (ptr, dist, reach)
    for _ in range(9):
        cur = pd.pointer_double_rank(*cur)
    assert bool((cur[2] == 1).all())
    assert torch.equal(cur[1], N - 1 - torch.arange(N, dtype=torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,twin,make", [
    (pd.pointer_double, ref.pointer_double_ref, k1_inputs),
    (pd.pointer_double_rank, ref.pointer_double_rank_ref, k2_inputs),
])
@pytest.mark.parametrize("N", [1000, 8192, 1 << 20])
def test_cuda_kernel_bit_equal_to_twin(kernel, twin, make, N):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    ins = tuple(torch.from_numpy(x).cuda() for x in make(N))
    before = kernel.launches
    got = kernel(*ins)
    want = twin(*ins)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))
