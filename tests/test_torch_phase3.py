"""Phase 3 of the port against the JAX reference: ``phase3_device`` (pivot
splice + list-rank emission) and its pieces, byte for byte, on the
multi-pivot cases of tests/test_phase3_splice.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import phase3 as jp3
from repro.core.hierholzer import validate_circuit
from repro_torch.core import phase3 as tp3
from repro_torch.kernels import pointer_double as pd
from test_phase3_splice import graph_of_cycles, stub_vertices
from repro.graphgen.eulerize import eulerian_rmat


def per_vertex_pairing(seed):
    """tests/test_phase3_splice.py::test_random_per_vertex_pairing's input."""
    g = eulerian_rmat(7, avg_degree=4, seed=seed)
    sv = stub_vertices(g)
    n_stubs = 2 * g.num_edges
    order = np.argsort(sv, kind="stable")
    vs = sv[order]
    idx = np.arange(n_stubs)
    start = np.maximum.accumulate(
        np.where(np.r_[True, vs[1:] != vs[:-1]], idx, 0))
    first = (idx - start) % 2 == 0
    mate = np.full(n_stubs, -1, dtype=np.int64)
    mate[order[first]] = order[~first]
    mate[order[~first]] = order[first]
    return g, mate


CASES = {
    "three_triangles_one_pivot":
        lambda: graph_of_cycles(7, [[0, 1, 2], [0, 3, 4], [0, 5, 6]]),
    "five_cycles_one_pivot": lambda: graph_of_cycles(
        11, [[0, 1, 2], [0, 3, 4], [0, 5, 6], [0, 7, 8], [0, 9, 10]]),
    "cycle_chain_distinct_pivots": lambda: graph_of_cycles(
        10, [[0, 1, 2], [1, 3, 4], [4, 5, 6], [6, 7, 8], [8, 9, 0]]),
    "cycles_sharing_multiple_pivots": lambda: graph_of_cycles(
        8, [[0, 2, 1, 3], [0, 4, 1, 5], [0, 6, 1, 7]]),
    "random_pairing_0": lambda: per_vertex_pairing(0),
    "random_pairing_1": lambda: per_vertex_pairing(1),
    "random_pairing_2": lambda: per_vertex_pairing(2),
}

_jit_p3 = jax.jit(jp3.phase3_device, static_argnames="splice_rounds")


@pytest.mark.parametrize("case", sorted(CASES))
def test_phase3_device_byte_identical(case):
    """On CPU tensors the doubling rounds go through the kernel wrappers,
    which compute the plain twins and count no launch."""
    g, mate = CASES[case]()
    sv = stub_vertices(g)
    c_j, m_j, ok_j = _jit_p3(jnp.asarray(mate, jnp.int32),
                             jnp.asarray(sv, jnp.int32), splice_rounds=64)
    launches = (pd.pointer_double.launches, pd.pointer_double_rank.launches)
    c_t, m_t, ok_t = tp3.phase3_device(
        torch.as_tensor(mate, dtype=torch.int32),
        torch.as_tensor(sv, dtype=torch.int32), splice_rounds=64)
    assert (pd.pointer_double.launches,
            pd.pointer_double_rank.launches) == launches
    assert c_t.dtype == torch.int32 and m_t.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(c_j), c_t.numpy())
    np.testing.assert_array_equal(np.asarray(m_j), m_t.numpy())
    assert bool(ok_j) and bool(ok_t)
    validate_circuit(g, c_t.numpy().astype(np.int64))


@pytest.mark.parametrize("case", ["three_triangles_one_pivot",
                                  "random_pairing_1"])
def test_cc_labels_and_list_rank_match(case):
    g, mate = CASES[case]()
    m32 = mate.astype(np.int32)
    valid = m32 >= 0
    lab_j = jp3._cc_cycle_labels(jnp.asarray(m32), jnp.asarray(valid))
    lab_t = tp3._cc_cycle_labels(torch.from_numpy(m32),
                                 torch.from_numpy(valid))
    np.testing.assert_array_equal(np.asarray(lab_j), lab_t.numpy())
    # list ranking of the (not yet spliced) matching from stub 0's orbit
    c_j = jp3.circuit_from_mate_jnp(jnp.asarray(m32), jnp.int32(0))
    c_t = tp3.circuit_from_mate(torch.from_numpy(m32),
                                torch.tensor(0, dtype=torch.int32))
    np.testing.assert_array_equal(np.asarray(c_j), c_t.numpy())


def test_too_few_rounds_reports_no_convergence():
    g, mate = CASES["five_cycles_one_pivot"]()
    sv = stub_vertices(g)
    _, _, ok = tp3.phase3_device(torch.as_tensor(mate, dtype=torch.int32),
                                 torch.as_tensor(sv, dtype=torch.int32),
                                 splice_rounds=0)
    assert not bool(ok)


@pytest.mark.parametrize("case", ["five_cycles_one_pivot",
                                  "random_pairing_2"])
def test_numpy_twins_are_the_reference(case):
    g, mate = CASES[case]()
    m = jp3.splice_components_np(mate.copy(), stub_vertices(g), mate >= 0)
    np.testing.assert_array_equal(jp3.circuit_from_mate_np(m),
                                  tp3.circuit_from_mate_np(m))
    rng = np.random.default_rng(len(m))
    valid = m >= 0
    dist = rng.integers(0, len(m), len(m)).astype(np.int32)
    reach = rng.integers(0, 2, len(m)).astype(np.int32)
    np.testing.assert_array_equal(jp3.emit_circuit_np(valid, dist, reach),
                                  tp3.emit_circuit_np(valid, dist, reach))
    np.testing.assert_array_equal(
        tp3.emit_circuit_np(valid, dist, reach),
        tp3.emit_circuit(torch.from_numpy(valid), torch.from_numpy(dist),
                         torch.from_numpy(reach)).numpy())
