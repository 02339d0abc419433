"""The list ranking's halt where an overflowed ``mate`` leaves the walk's
start without a predecessor, against the JAX package.

The halt node is ``t = mate[start ^ 1]``.  Where the start's sibling is
unmated, t is −1 and the reference's ``nxt.at[t].set(t)`` writes −1 at
its last stub, which its gathers wrap back to that stub: a jnp gather
wraps a negative index once and clamps the rest (``x[[-1, 7, -9]]`` on 5
elements reads 4, 4, 0).  Its batched Phase 3 is a ``vmap``, so each
member's −1 wraps within the member.  Here:

  * K1's and K2's twins (and the wrappers on CPU tensors) read −1, −N, N
    and N + 5 as ``jnp.asarray(x)[idx]`` does;
  * ``circuit_from_mate`` on such a ``mate``, alone and in a batch with
    the overflowed member first, last or alone, is byte-equal to
    ``circuit_from_mate_jnp`` and to ``jax.vmap`` of it;
  * a small replicated solve that overflows its open table (RMAT scale 8,
    P = 8, ``open_cap`` 80) leaves its Phase 3 input's halt at −1; its
    Phase 3 is the JAX package's on the same ``mate``, it returns its
    flags, and in a batch it leaves its sound partner byte-equal to the
    partner's own solve.

On a card (``gpu`` tests) K1 and K2 are bit-equal to their twins on such
records, and the overflowing solve is byte-equal to the CPU's."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import phase3 as tp3
from repro_torch.core.engine import Engine
from repro_torch.euler import EulerSolver
from repro_torch.graphgen.eulerize import eulerian_rmat
from repro_torch.kernels import pointer_double as pd
from repro_torch.kernels import ref

#: the overflowing solve: a graph of the scale-8, P = 8 modal bucket whose
#: open table overflows at OPEN_CAP and leaves stub 1 (the start's
#: sibling) unmated, and a graph of the same bucket that fits
SCALE, PARTS, OPEN_CAP, BAD_SEED, GOOD_SEED = 8, 8, 80, 12, 2


def walk_mate(n_edges: int, seed: int, unmated_start: bool) -> np.ndarray:
    """The ``mate`` [2E] of one closed walk over ``n_edges`` edges in a
    seeded order (edge e's stubs 2e, 2e + 1; the walk arriving by edge e
    departs by the next); with ``unmated_start`` the start's sibling
    (stub 1) and its mate are left unmated, as an overflow leaves them."""
    order = np.random.default_rng(seed).permutation(n_edges)
    mate = np.full(2 * n_edges, -1, np.int32)
    for a, b in zip(order, np.roll(order, -1)):
        mate[2 * a + 1], mate[2 * b] = 2 * b, 2 * a + 1
    if unmated_start:
        mate[mate[1]] = -1
        mate[1] = -1
    return mate


def first_valid(mate: np.ndarray) -> int:
    return int(np.argmax(mate >= 0))


def jax_circuits(mates: np.ndarray) -> np.ndarray:
    """``jax.vmap(circuit_from_mate_jnp)`` over the rows of ``mates``."""
    import jax
    import jax.numpy as jnp
    from repro.core import phase3 as jp3

    starts = np.array([first_valid(m) for m in mates], np.int32)
    return np.asarray(jax.vmap(jp3.circuit_from_mate_jnp)(
        jnp.asarray(mates), jnp.asarray(starts)))


def port_circuits(mates: np.ndarray) -> np.ndarray:
    starts = torch.tensor([first_valid(m) for m in mates], dtype=torch.int32)
    return tp3.circuit_from_mate(torch.from_numpy(mates), starts).numpy()


# ----------------------------------------------------------------------
# the twins read a pointer as a jnp gather reads its index
# ----------------------------------------------------------------------
def out_of_range(n: int, width: int, seed: int) -> np.ndarray:
    """Seeded int32 records ``[n, width]`` whose pointers (column 0) hold
    −1, −n, n and n + 5 among in-range ones."""
    rng = np.random.default_rng(seed)
    rec = rng.integers(0, 1 << 20, (n, width)).astype(np.int32)
    rec[:, 0] = rng.integers(0, n, n)
    rec[:4, 0] = (-1, -n, n, n + 5)
    if width == 4:
        rec[:, 2] = rng.integers(0, 2, n)
        rec[:, 3] = 0
    return rec


def test_gather_index_is_the_jnp_rule():
    import jax.numpy as jnp

    idx = np.array([-1, 7, -9, 0, 4, -5, 5], np.int32)
    x = np.arange(5, dtype=np.int32) * 10
    want = np.asarray(jnp.asarray(x)[jnp.asarray(idx)])
    got = torch.from_numpy(x)[ref.gather_index(torch.from_numpy(
        np.resize(idx, 5)))]
    np.testing.assert_array_equal(want[:5], got.numpy())
    np.testing.assert_array_equal(want[:3], [40, 40, 0])


@pytest.mark.parametrize("n", [5, 97, 1024])
def test_k1_twins_read_as_a_jnp_gather(n):
    import jax.numpy as jnp
    from repro.kernels import ref as jref

    rec = out_of_range(n, 2, n)
    nxt, lab = (jnp.asarray(rec[:, j]) for j in range(2))
    want = (np.asarray(nxt[nxt]), np.asarray(jnp.minimum(lab, lab[nxt])))
    for w, j in zip(want, jref.pointer_double_ref(nxt, lab)):
        np.testing.assert_array_equal(w, np.asarray(j))
    got = ref.pointer_double_ref(*(torch.from_numpy(rec[:, j].copy())
                                   for j in range(2)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g.numpy())
    packed = np.stack(want, 1)
    np.testing.assert_array_equal(
        ref.pointer_double_packed_ref(torch.from_numpy(rec)).numpy(), packed)
    before = pd.pointer_double.launches
    np.testing.assert_array_equal(
        pd.pointer_double(torch.from_numpy(rec)).numpy(), packed)
    assert pd.pointer_double.launches == before


@pytest.mark.parametrize("n", [5, 97, 1024])
def test_k2_twins_read_as_a_jnp_gather(n):
    import jax.numpy as jnp
    from repro.kernels import ref as jref

    rec = out_of_range(n, 4, n + 1)
    ptr, dist, reach = (jnp.asarray(rec[:, j]) for j in range(3))
    want = (np.asarray(ptr[ptr]), np.asarray(dist + dist[ptr]),
            np.asarray(jnp.maximum(reach, reach[ptr])))
    for w, j in zip(want, jref.pointer_double_rank_ref(ptr, dist, reach)):
        np.testing.assert_array_equal(w, np.asarray(j))
    got = ref.pointer_double_rank_ref(*(torch.from_numpy(rec[:, j].copy())
                                        for j in range(3)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g.numpy())
    packed = np.stack([*want, np.zeros(n, np.int32)], 1)
    np.testing.assert_array_equal(
        ref.pointer_double_rank_packed_ref(torch.from_numpy(rec)).numpy(),
        packed)
    before = pd.pointer_double_rank.launches
    np.testing.assert_array_equal(
        pd.pointer_double_rank(torch.from_numpy(rec)).numpy(), packed)
    assert pd.pointer_double_rank.launches == before


# ----------------------------------------------------------------------
# circuit_from_mate: alone and batched, the reference's vmap
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n_edges", [8, 37])
def test_unmated_start_sibling_alone(n_edges):
    """One graph whose start's sibling is unmated: the port's circuit is
    the JAX package's, which walks from the wrapped halt."""
    import jax.numpy as jnp
    from repro.core import phase3 as jp3

    mate = walk_mate(n_edges, n_edges, unmated_start=True)
    assert mate[first_valid(mate) ^ 1] == -1
    want = np.asarray(jp3.circuit_from_mate_jnp(
        jnp.asarray(mate), jnp.int32(first_valid(mate))))
    got = tp3.circuit_from_mate(torch.from_numpy(mate),
                                torch.tensor(first_valid(mate),
                                             dtype=torch.int32))
    np.testing.assert_array_equal(want, got.numpy())
    np.testing.assert_array_equal(port_circuits(mate[None])[0], want)


@pytest.mark.parametrize("layout", ["bad_first", "bad_last", "bad_alone",
                                    "bad_middle", "all_bad"])
@pytest.mark.parametrize("n_edges", [8, 37])
def test_batched_halt_stays_in_its_graph(layout, n_edges):
    """A batch with an overflowed member first, last, in the middle,
    alone or everywhere: byte-equal to ``jax.vmap(circuit_from_mate_jnp)``,
    and each sound member's circuit is its own solve's."""
    bad = {"bad_first": [1, 0], "bad_last": [0, 0, 1], "bad_alone": [1],
           "bad_middle": [0, 1, 0], "all_bad": [1, 1]}[layout]
    mates = np.stack([walk_mate(n_edges, 100 + i, bool(b))
                      for i, b in enumerate(bad)])
    want = jax_circuits(mates)
    got = port_circuits(mates)
    np.testing.assert_array_equal(want, got)
    for i, b in enumerate(bad):
        np.testing.assert_array_equal(got[i], port_circuits(mates[i:i + 1])[0])
        if not b:
            walk = got[i]
            assert (walk >= 0).all() and len(set(walk.tolist())) == n_edges


def test_overflowed_first_member_of_two_closed_walks():
    """E = 8, each member one closed walk, the first with its start's
    sibling unmated: the sound second member keeps its own circuit (a
    halt wrapped over the whole flat table would land on the last
    graph's last stub)."""
    mates = np.stack([walk_mate(8, 1, True), walk_mate(8, 2, False)])
    got = port_circuits(mates)
    np.testing.assert_array_equal(got, jax_circuits(mates))
    np.testing.assert_array_equal(got[1], port_circuits(mates[1:])[0])


# ----------------------------------------------------------------------
# a small replicated solve that overflows
# ----------------------------------------------------------------------
def overflow_engine(sharded: bool = False):
    """``(engine, bucket key, [bad pg, good pg])``: the modal bucket's
    engine at ``open_cap`` OPEN_CAP, on the CPU."""
    solver = EulerSolver(n_parts=PARTS, device="cpu")
    graphs = [eulerian_rmat(SCALE, avg_degree=5, seed=s)
              for s in (BAD_SEED, GOOD_SEED)]
    preps = [solver._prepare(g, None) for g in graphs]
    key = preps[0][2]
    assert preps[1][2] == key
    caps = dataclasses.replace(key[3], open_cap=OPEN_CAP,
                               open_ship_cap=OPEN_CAP)
    return (Engine(PARTS, caps, key[2], sharded_phase3=sharded), key,
            [p[0] for p in preps])


def one_graph(eng, key, pg):
    dev = torch.device("cpu")
    state = eng.device_state(eng.load_cached(pg), dev, resident=False)
    return eng.fused_program(key[0]).launch(*state).wait()[0]


@pytest.fixture(scope="module")
def overflow():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        eng, key, pgs = overflow_engine()
        dev = torch.device("cpu")
        state, anc, sv = eng.device_state(eng.load_cached(pgs[0]), dev,
                                          resident=False)
        run = eng.run_levels(state, anc, key[0], clock=False)
        singles = [one_graph(eng, key, pg) for pg in pgs]
        batches = {order: eng.fused_program(key[0], len(order)).launch(
            *eng.stage_batch([pgs[i] for i in order], dev)).wait()[0]
            for order in ((0, 1), (1, 0), (1, 0, 1))}
        yield run.mate.numpy(), sv.numpy(), singles, batches
    finally:
        torch.set_num_threads(threads)


def test_overflowing_solve_leaves_the_halt_unmated(overflow):
    mate, _, singles, _ = overflow
    assert mate[first_valid(mate) ^ 1] == -1
    bad, good = singles
    assert not bad.flags.all() and good.flags.all()
    assert bool(good.phase3_ok)


def test_overflowing_phase3_is_the_jax_package_s(overflow):
    """The fused run's Phase 3 outputs are ``phase3_device`` of the JAX
    package on the same ``mate`` (the run returns its flags: a solver
    would raise on them, as the reference's does)."""
    import jax
    import jax.numpy as jnp
    from repro.core import phase3 as jp3

    mate, sv, (bad, _), _ = overflow
    circuit, mate2, ok = jax.jit(jp3.phase3_device,
                                 static_argnames="splice_rounds")(
        jnp.asarray(mate), jnp.asarray(sv), splice_rounds=64)
    port = tp3.phase3_device(torch.from_numpy(mate), torch.from_numpy(sv),
                             splice_rounds=64)
    for j, p in zip((circuit, mate2, ok), port):
        np.testing.assert_array_equal(np.asarray(j), p.numpy())
    np.testing.assert_array_equal(bad.circuit, np.asarray(circuit))
    np.testing.assert_array_equal(bad.mate, np.asarray(mate2))
    assert bool(bad.phase3_ok) == bool(ok)


@pytest.mark.parametrize("order", [(0, 1), (1, 0), (1, 0, 1)])
def test_overflowing_member_leaves_its_batch_intact(overflow, order):
    """Replicated batches with the overflowing graph first, last or twice:
    every member, in every field, is its own one-graph solve."""
    _, _, singles, batches = overflow
    out = batches[order]
    for b, i in enumerate(order):
        want = singles[i]
        np.testing.assert_array_equal(out.circuit[b], want.circuit)
        np.testing.assert_array_equal(out.mate[b], want.mate)
        np.testing.assert_array_equal(out.flags[:, b], want.flags)
        np.testing.assert_array_equal(out.metrics[:, b], want.metrics)
        assert out.phase3_ok[b] == want.phase3_ok


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("kernel,twin,width", [
    (pd.pointer_double, ref.pointer_double_packed_ref, 2),
    (pd.pointer_double_rank, ref.pointer_double_rank_packed_ref, 4)])
@pytest.mark.parametrize("n", [5, 1000, (1 << 20) + 3])
def test_cuda_kernel_reads_as_a_jnp_gather(kernel, twin, width, n):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    rec = torch.from_numpy(out_of_range(n, width, n)).cuda()
    before = kernel.launches
    got = kernel(rec)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert torch.equal(got, twin(rec))


@pytest.mark.gpu
def test_cuda_overflowing_solve_is_the_cpu_s():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    eng, key, pgs = overflow_engine()
    cpu = one_graph(eng, key, pgs[0])
    eng, key, pgs = overflow_engine()     # a card run's own programs
    state = eng.device_state(eng.load_cached(pgs[0]), torch.device("cuda"),
                             resident=False)
    card = eng.fused_program(key[0]).launch(*state).wait()[0]
    for a, b in zip(cpu, card):
        np.testing.assert_array_equal(a, b)
