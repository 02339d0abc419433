"""K1/K2 pointer-doubling: the port's plain-torch twins against the JAX
oracles and Pallas kernels (interpret mode), K1's and K2's packed-record
twins against their two- and three-array forms, the wrappers' device rule
and checks on the CPU, and — on a card — the CUDA kernels K1–K4 against the twins (the
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


def k1_packed_inputs(N):
    """:func:`k1_inputs` as K1's packed records, int32 [N, 2] =
    (nxt, lab)."""
    return (np.stack(k1_inputs(N), 1),)


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
def test_k1_packed_twin_matches_two_array_twin_jax_and_pallas(N, block):
    """K1's packed twin is the two-array twin on the record's columns,
    and so the JAX oracle and the Pallas kernel."""
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.pointer_double import pointer_double as j_pd

    ins = k1_inputs(N)
    (rec,) = k1_packed_inputs(N)
    got = ref.pointer_double_packed_ref(torch.from_numpy(rec))
    assert got.dtype == torch.int32 and got.shape == (N, 2)
    cols = (got[:, 0], got[:, 1])
    two = ref.pointer_double_ref(*(torch.from_numpy(x) for x in ins))
    assert all(torch.equal(a, b) for a, b in zip(cols, two))
    assert same(jref.pointer_double_ref(*(jnp.asarray(x) for x in ins)), cols)
    assert same(j_pd(*(jnp.asarray(x) for x in ins), block=block,
                     interpret=True), cols)


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
    (pd.pointer_double, ref.pointer_double_packed_ref, k1_packed_inputs),
    (pd.pointer_double_rank, ref.pointer_double_rank_packed_ref,
     k2_packed_inputs),
])
def test_wrapper_on_cpu_runs_the_twin_and_counts_nothing(kernel, twin, make):
    (rec,) = (torch.from_numpy(x) for x in make(1000))
    before = kernel.launches
    want = twin(rec)
    assert torch.equal(kernel(rec), want)
    out = torch.empty_like(want)
    assert kernel(rec, out=out) is out
    assert torch.equal(out, want)
    assert kernel.launches == before


def test_wrapper_checks_its_tensors():
    """K1's wrapper refuses what its kernel does not take: another dtype,
    records of other shapes, strided records, an output in place."""
    (rec,) = (torch.from_numpy(x) for x in k1_packed_inputs(64))
    with pytest.raises(TypeError):
        pd.pointer_double(rec.long())
    with pytest.raises(ValueError):
        pd.pointer_double(rec, out=torch.empty(32, 2, dtype=torch.int32))
    with pytest.raises(ValueError):
        pd.pointer_double(rec[::2])
    with pytest.raises(ValueError):                 # in place would race
        pd.pointer_double(rec, out=rec)
    with pytest.raises(ValueError):
        pd.pointer_double(rec[:32], out=rec[16:48])


def test_k1_wrapper_checks_its_records():
    """Only int32 [N, 2] records, contiguous, with an output apart."""
    (rec,) = (torch.from_numpy(x) for x in k1_packed_inputs(64))
    with pytest.raises(TypeError):
        pd.pointer_double(rec.long())
    with pytest.raises(ValueError):                 # not [N, 2]
        pd.pointer_double(torch.zeros(64, 3, dtype=torch.int32))
    with pytest.raises(ValueError):                 # K2's records
        pd.pointer_double(torch.zeros(64, 4, dtype=torch.int32))
    with pytest.raises(ValueError):
        pd.pointer_double(rec[:, 0].contiguous())
    with pytest.raises(ValueError):                 # strided
        pd.pointer_double(rec.t().contiguous().t())
    with pytest.raises(ValueError):                 # out overlaps the input
        pd.pointer_double(rec[:48], out=rec[8:56])
    with pytest.raises(TypeError):
        pd.pointer_double(rec, out=torch.empty(64, 2, dtype=torch.int64))


def one_cycle(N, seed):
    """A seeded random order of all N stubs closed into one cycle, as K1's
    packed start records (succ, i)."""
    order = np.random.default_rng(seed).permutation(N)
    rec = np.empty((N, 2), np.int32)
    rec[order, 0] = np.roll(order, -1)
    rec[:, 1] = np.arange(N)
    return rec


@pytest.mark.parametrize("N", [1000, 4096])
def test_packed_doubling_rounds_label_a_cycle(N):
    """``_doubling_rounds(N)`` packed K1 rounds through the wrapper on the
    CPU, ping-ponging two buffers as ``_cc_cycle_labels`` does, label every
    stub of a seeded one-cycle input 0, as the two-array twin does."""
    from repro_torch.core.phase3 import _doubling_rounds

    rec = torch.from_numpy(one_cycle(N, N))
    cur, spare = rec.clone(), torch.empty_like(rec)
    two = (rec[:, 0].clone(), rec[:, 1].clone())
    for _ in range(_doubling_rounds(N)):
        cur, spare = pd.pointer_double(cur, out=spare), cur
        two = ref.pointer_double_ref(*two)
    assert not bool(cur[:, 1].any())
    assert torch.equal(cur[:, 0], two[0]) and torch.equal(cur[:, 1], two[1])


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
    (pd.pointer_double, ref.pointer_double_packed_ref, k1_packed_inputs),
    (pd.pointer_double_rank, ref.pointer_double_rank_packed_ref,
     k2_packed_inputs),
])
@pytest.mark.parametrize("N", [1000, 8192, 1 << 20])
def test_cuda_kernel_bit_equal_to_twin(kernel, twin, make, N):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    (rec,) = (torch.from_numpy(x).cuda() for x in make(N))
    before = kernel.launches
    got = kernel(rec)
    want = twin(rec)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("N", [1, 1000, 3000, (1 << 20) + 7])
def test_cuda_packed_k1_bit_equal_at_ragged_n(N):
    """Packed K1 against its twin at lengths no block or thread's share
    of records divides."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    (rec,) = (torch.from_numpy(x).cuda() for x in k1_packed_inputs(N))
    got = pd.pointer_double(rec)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.pointer_double_packed_ref(rec))


@pytest.mark.gpu
def test_cuda_packed_k1_labels_a_seeded_cycle():
    """24 chained K1 rounds on a seeded one-cycle input of 2^22 records
    are bit-equal to the packed twin's and label every stub 0."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    cur = torch.from_numpy(one_cycle(1 << 22, 7)).cuda()
    want, spare = cur, torch.empty_like(cur)
    for _ in range(24):
        cur, spare = pd.pointer_double(cur, out=spare), cur
        want = ref.pointer_double_packed_ref(want)
    torch.cuda.synchronize()
    assert torch.equal(cur, want)
    assert not bool(cur[:, 1].any())


@pytest.mark.gpu
def test_cuda_k1_refuses_misaligned_records():
    """Records 4 bytes past an 8-byte boundary would split a record's load:
    the wrapper refuses them, as input and as output."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    buf = torch.zeros(2 * 64 + 1, dtype=torch.int32, device="cuda")
    odd = buf[1:].view(64, 2)
    assert odd.data_ptr() % 8 == 4
    with pytest.raises(ValueError):
        pd.pointer_double(odd)
    with pytest.raises(ValueError):
        pd.pointer_double(torch.zeros(64, 2, dtype=torch.int32,
                                      device="cuda"), out=odd)


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
