"""The port's host layer against the JAX package: the copied generators,
partitioner and merge tree, the engine's ``plan``/``size_caps``/``load``
and the solver's bucket key, for P ∈ {1, 2, 8}.  All of it is numpy on
both sides, so every array must be equal."""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro.core.engine import DistributedEngine
from repro.core.graph import partition_graph as j_partition_graph
from repro.euler import EulerSolver as JSolver
from repro.graphgen.eulerize import eulerian_rmat as j_eulerian_rmat
from repro.graphgen.rmat import rmat_graph as j_rmat_graph
from repro.graphgen.partition import partition_vertices as j_partition
from repro_torch.core.engine import Engine, state_from_numpy
from repro_torch.core.graph import Graph, partition_graph
from repro_torch.euler import EulerSolver, resolve_device
from repro_torch.graphgen.eulerize import eulerian_rmat
from repro_torch.graphgen.rmat import rmat_graph
from repro_torch.graphgen.partition import partition_vertices

PARTS = [1, 2, 8]


def port_graph(g):
    return Graph(g.num_vertices, g.edge_u.copy(), g.edge_v.copy())


def same_graph(a, b):
    return (a.num_vertices == b.num_vertices
            and np.array_equal(a.edge_u, b.edge_u)
            and np.array_equal(a.edge_v, b.edge_v))


@pytest.mark.parametrize("scale,seed", [(6, 0), (8, 3)])
def test_generators_match(scale, seed):
    assert same_graph(rmat_graph(scale, seed=seed),
                      j_rmat_graph(scale, seed=seed))
    assert same_graph(eulerian_rmat(scale, avg_degree=4, seed=seed),
                      j_eulerian_rmat(scale, avg_degree=4, seed=seed))


def prepared(P, scale=7, seed=1):
    jg = j_eulerian_rmat(scale, avg_degree=4, seed=seed)
    return jg, port_graph(jg)


@pytest.mark.parametrize("P", PARTS)
def test_partition_and_merge_tree_match(P):
    jg, tg = prepared(P)
    part = partition_vertices(tg, P)
    np.testing.assert_array_equal(part, j_partition(jg, P))
    tpg = partition_graph(tg, part)
    jpg = j_partition_graph(jg, part)
    np.testing.assert_array_equal(tpg.meta.weights, jpg.meta.weights)
    t_tree, t_act, t_la, t_cut, t_anc = Engine.plan(tpg)
    j_tree, j_act, j_la, j_cut, j_anc = DistributedEngine.plan(jpg)
    assert [(lv.pairs, lv.passthrough, lv.active_after)
            for lv in t_tree.levels] == \
        [(lv.pairs, lv.passthrough, lv.active_after) for lv in j_tree.levels]
    for a, b in ((t_act, j_act), (t_la, j_la), (t_cut, j_cut),
                 (t_anc, j_anc)):
        np.testing.assert_array_equal(a, b)
    assert dataclasses.asdict(Engine.size_caps(tpg)) == \
        dataclasses.asdict(DistributedEngine.size_caps(jpg))


@pytest.mark.parametrize("P,scale,seed", [(1, 7, 1), (2, 7, 1), (8, 7, 1),
                                          (8, 9, 4)])
def test_bucket_key_and_load_match(P, scale, seed):
    """Same bucket (e_cap, n_parts, n_levels, caps) and the same initial
    engine state, field for field, from both packages."""
    jg, tg = prepared(P, scale, seed)
    jpg, _, jkey = JSolver(n_parts=P)._prepare(jg, None)
    tpg, _, tkey = EulerSolver(n_parts=P, device="cpu")._prepare(tg, None)
    assert tkey[:3] == jkey[:3]
    assert dataclasses.asdict(tkey[3]) == dataclasses.asdict(jkey[3])
    e_cap, n, n_levels, _ = jkey
    mesh = types.SimpleNamespace(shape={"part": n})
    jeng = DistributedEngine(mesh, ("part",), jkey[3], n_levels)
    j_state, j_anc = jeng.load(jpg, device=False)
    teng = Engine(n, tkey[3], n_levels)
    t_state, t_anc = teng.load(tpg)
    np.testing.assert_array_equal(t_anc, j_anc)
    assert type(t_state)._fields == type(j_state)._fields
    for f in type(j_state)._fields:
        a, b = getattr(t_state, f), getattr(j_state, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    # the JAX package's numpy state uploads into the port unchanged
    sv = np.zeros(2 * e_cap, dtype=np.int64)
    up, anc, _ = state_from_numpy(j_state, j_anc, sv, "cpu")
    assert all(torch.equal(torch.from_numpy(getattr(t_state, f)),
                           getattr(up, f)) for f in type(j_state)._fields)
    assert anc.dtype == torch.int32


def test_default_device_is_cuda_or_raises():
    """No card: the entry points refuse instead of carrying on on the
    CPU.  With a card: ``None`` resolves to it."""
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        assert EulerSolver(n_parts=1).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            EulerSolver(n_parts=1)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
