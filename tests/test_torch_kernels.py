"""K1/K2 pointer-doubling: the port's plain-torch twins against the JAX
oracles and Pallas kernels (interpret mode), K2's packed-record twin
against its three-array form, the wrappers' device rule and checks on the
CPU, and — on a card — the CUDA kernels K1–K4 against the twins (the
K3/K4 CPU cases are in tests/test_torch_phase3_sharded.py).

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


def k2_packed_inputs(N):
    """:func:`k2_inputs` as K2's packed records, int32 [N, 4] =
    (ptr, dist, reach, 0)."""
    ptr, dist, reach = k2_inputs(N)
    return (np.stack([ptr, dist, reach, np.zeros_like(ptr)], 1),)


def outs(x):
    """A wrapper's or twin's result as a tuple of tensors (K2's packed
    form returns one tensor)."""
    return x if isinstance(x, tuple) else (x,)


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


@pytest.mark.parametrize("N,block", CASES)
def test_k2_packed_twin_matches_three_array_twin_jax_and_pallas(N, block):
    """K2's packed twin is the three-array twin on the record's columns,
    and so the JAX oracle and the Pallas kernel."""
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.pointer_double import pointer_double_rank as j_pdr

    ins = k2_inputs(N)
    (rec,) = k2_packed_inputs(N)
    got = ref.pointer_double_rank_packed_ref(torch.from_numpy(rec))
    assert got.dtype == torch.int32 and got.shape == (N, 4)
    assert not bool(got[:, 3].any())
    cols = tuple(got[:, j] for j in range(3))
    three = ref.pointer_double_rank_ref(*(torch.from_numpy(x) for x in ins))
    assert all(torch.equal(a, b) for a, b in zip(cols, three))
    assert same(jref.pointer_double_rank_ref(*(jnp.asarray(x) for x in ins)),
                cols)
    assert same(j_pdr(*(jnp.asarray(x) for x in ins), block=block,
                      interpret=True), cols)


@pytest.mark.parametrize("kernel,twin,make", [
    (pd.pointer_double, ref.pointer_double_ref, k1_inputs),
    (pd.pointer_double_rank, ref.pointer_double_rank_packed_ref,
     k2_packed_inputs),
])
def test_wrapper_on_cpu_runs_the_twin_and_counts_nothing(kernel, twin, make):
    ins = tuple(torch.from_numpy(x) for x in make(1000))
    before = kernel.launches
    want = outs(twin(*ins))
    assert all(torch.equal(a, b) for a, b in zip(outs(kernel(*ins)), want))
    out = tuple(torch.empty_like(x) for x in want)
    got = outs(kernel(*ins, out=out if len(out) > 1 else out[0]))
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


def test_k2_wrapper_checks_its_records():
    (rec,) = (torch.from_numpy(x) for x in k2_packed_inputs(64))
    with pytest.raises(TypeError):
        pd.pointer_double_rank(rec.long())
    with pytest.raises(ValueError):                 # not [N, 4]
        pd.pointer_double_rank(rec[:, :3].contiguous())
    with pytest.raises(ValueError):
        pd.pointer_double_rank(rec[:, 0].contiguous())
    with pytest.raises(ValueError):                 # not contiguous
        pd.pointer_double_rank(rec.t().contiguous().t())
    with pytest.raises(ValueError):
        pd.pointer_double_rank(rec, out=torch.empty(32, 4, dtype=torch.int32))
    with pytest.raises(ValueError):                 # in place would race
        pd.pointer_double_rank(rec, out=rec)
    with pytest.raises(ValueError):
        pd.pointer_double_rank(rec[:32], out=rec[16:48])


def chain_state(N):
    """The chain 0 → 1 → … → N-1 with its halt node N-1, as the three
    arrays (ptr, dist, reach)."""
    ptr = torch.clamp(torch.arange(N, dtype=torch.int32) + 1, max=N - 1)
    dist = torch.ones(N, dtype=torch.int32)
    dist[N - 1] = 0
    reach = torch.zeros(N, dtype=torch.int32)
    reach[N - 1] = 1
    return ptr, dist, reach


def test_doubling_rounds_rank_a_list():
    """Chained twin rounds compute list ranks on a chain (the reference's
    ``test_pointer_double_rank_ranks_a_list``)."""
    N = 256
    cur = chain_state(N)
    for _ in range(9):
        cur = ref.pointer_double_rank_ref(*cur)
    assert bool((cur[2] == 1).all())
    assert torch.equal(cur[1], N - 1 - torch.arange(N, dtype=torch.int32))


def test_packed_doubling_rounds_rank_a_list():
    """The same ranks through the K2 wrapper on packed records,
    ping-ponging two buffers as ``circuit_from_mate`` does."""
    N = 256
    cur = torch.zeros(N, 4, dtype=torch.int32)
    for j, col in enumerate(chain_state(N)):
        cur[:, j] = col
    spare = torch.empty_like(cur)
    for _ in range(9):
        cur, spare = pd.pointer_double_rank(cur, out=spare), cur
    assert bool((cur[:, 2] == 1).all()) and not bool(cur[:, 3].any())
    assert torch.equal(cur[:, 0], torch.full((N,), N - 1, dtype=torch.int32))
    assert torch.equal(cur[:, 1], N - 1 - torch.arange(N, dtype=torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,twin,make", [
    (pd.pointer_double, ref.pointer_double_ref, k1_inputs),
    (pd.pointer_double_rank, ref.pointer_double_rank_packed_ref,
     k2_packed_inputs),
])
@pytest.mark.parametrize("N", [1000, 8192, 1 << 20])
def test_cuda_kernel_bit_equal_to_twin(kernel, twin, make, N):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    ins = tuple(torch.from_numpy(x).cuda() for x in make(N))
    before = kernel.launches
    got = outs(kernel(*ins))
    want = outs(twin(*ins))
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
def test_cuda_packed_k2_ranks_a_seeded_chain():
    """21 chained K2 rounds on a seeded random chain of 2^20 records are
    bit-equal to the packed twin's and reach the ranks 0 … N-1."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    N = 1 << 20
    order = np.random.default_rng(5).permutation(N)
    ptr = np.empty(N, np.int32)
    ptr[order[:-1]] = order[1:]
    ptr[order[-1]] = order[-1]
    rec = np.zeros((N, 4), np.int32)
    rec[:, 0], rec[:, 1] = ptr, 1
    rec[order[-1], 1:3] = (0, 1)
    cur = torch.from_numpy(rec).cuda()
    want, spare = cur, torch.empty_like(cur)
    for _ in range(21):
        cur, spare = pd.pointer_double_rank(cur, out=spare), cur
        want = ref.pointer_double_rank_packed_ref(want)
    torch.cuda.synchronize()
    assert torch.equal(cur, want)
    rank = torch.empty(N, dtype=torch.int32)
    rank[torch.from_numpy(order)] = torch.arange(N - 1, -1, -1,
                                                 dtype=torch.int32)
    assert torch.equal(cur[:, 1].cpu(), rank)
    assert bool((cur[:, 2] == 1).all())


def shard_step_inputs(rows, S, n_tables, seed):
    """One seeded ring step in the all-shards form (``rows`` query shards
    of width ``S``, tables with 16 pad rows past ``s_real = S``), or the
    single-shard 1-D form for ``rows == 0``."""
    rng = np.random.default_rng(seed)
    r = max(rows, 1)
    shape = (rows, S) if rows else (S,)
    q = rng.integers(-8, r * S + 8, shape).astype(np.int32)
    carries = [rng.integers(0, 1 << 30, shape).astype(np.int32)
               for _ in range(n_tables)]
    base = (rng.permutation(r) * S).astype(np.int32)
    tshape = (rows, S + 16) if rows else (S + 16,)
    tables = [rng.integers(0, 1 << 30, tshape).astype(np.int32)
              for _ in range(n_tables)]
    return (q, *carries, base, *tables), S


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,twin,k", [
    (pd.pointer_double_shard, ref.pointer_double_shard_ref, 2),
    (pd.pointer_double_rank_shard, ref.pointer_double_rank_shard_ref, 3),
])
@pytest.mark.parametrize("rows,S", [(0, 1000), (8, 4096), (8, 1 << 17)])
def test_cuda_shard_kernel_bit_equal_to_twin(kernel, twin, k, rows, S):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    ins, s_real = shard_step_inputs(rows, S, k, rows * S + k)
    ins = tuple(torch.from_numpy(x).cuda() for x in ins)
    before = kernel.launches
    got = kernel(*ins, s_real=s_real)
    want = twin(*ins, s_real=s_real)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))
