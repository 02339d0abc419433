"""The whole slice: ``repro_torch.euler.solve(g, n_parts=P,
device="cpu")`` returns the same circuit and mate as
``repro.euler.solve(g, n_parts=P)``, byte for byte, for P ∈ {1, 2, 8} at
RMAT scales 5–7, and every result validates.

The port runs its default, the sharded Phase 3 for P>1; the references
run the replicated one (``sharded_phase3=False``), which the JAX
package's own tests/test_sharded_phase3.py holds byte-identical to its
sharded default, so each P>1 case also crosses the two paths.
tests/test_torch_phase3_sharded.py holds every Phase 3 mode of the port
against the reference's default.  The references run in one subprocess
with 8 simulated devices; the port runs here."""
import dataclasses

import numpy as np
import pytest

from conftest import run_with_devices
from repro_torch.core.graph import Graph
from repro_torch.euler import EulerSolver, solve
from repro_torch.graphgen.eulerize import eulerian_rmat

PARTS = [1, 2, 8]
SCALES = [5, 6, 7]

_REFERENCE = '''
import numpy as np
from repro.euler import solve
from repro.graphgen.eulerize import eulerian_rmat
rec = {{}}
for P in {parts}:
    for s in {scales}:
        r = solve(eulerian_rmat(s, avg_degree=4, seed=s), n_parts=P,
                  sharded_phase3=False)
        rec[f"{{P}}_{{s}}/circuit"], rec[f"{{P}}_{{s}}/mate"] = r.circuit, r.mate
np.savez({out!r}, **rec)
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("solve") / "ref.npz")
    run_with_devices(_REFERENCE.format(parts=PARTS, scales=SCALES, out=out),
                     n=8)
    with np.load(out) as z:
        return dict(z)


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("P", PARTS)
def test_solve_byte_identical_to_jax(reference, P, scale):
    g = eulerian_rmat(scale, avg_degree=4, seed=scale)
    res = solve(g, n_parts=P, device="cpu").validate()
    np.testing.assert_array_equal(res.circuit, reference[f"{P}_{scale}/circuit"])
    np.testing.assert_array_equal(res.mate, reference[f"{P}_{scale}/mate"])
    assert res.circuit.dtype == np.int64 and res.mate.dtype == np.int64
    assert res.phase3_converged and res.device == "cpu"
    assert len(res.levels) == res.supersteps


def test_bowtie_and_timings():
    """Two triangles through one pivot vertex on one partition: the
    Phase 3 splice joins them; every phase reports its wall time."""
    bowtie = Graph(5, np.array([0, 1, 2, 0, 3, 4]),
                   np.array([1, 2, 0, 3, 4, 0]))
    res = solve(bowtie, n_parts=1, device="cpu").validate()
    assert sorted((res.circuit >> 1).tolist()) == list(range(6))
    assert res.padded_edges == 64 - 6
    levels = {f"superstep_{lvl}_s" for lvl in range(res.supersteps)}
    assert set(res.timings) == {"prepare_s", "upload_s", "supersteps_s",
                                "phase3_s", "splice_s", "emit_s",
                                "fetch_s", "total_s"} | levels
    t = res.timings
    assert min(t.values()) >= 0
    assert sum(t[k] for k in levels) <= t["supersteps_s"]
    assert t["splice_s"] + t["emit_s"] == pytest.approx(t["phase3_s"])


class _Undersized(EulerSolver):
    """Shrinks the touch table below what the graph needs."""

    def prepare(self, graph, part_of_vertex=None):
        pg, tree, key = super().prepare(graph, part_of_vertex)
        caps = dataclasses.replace(key[3], touch_cap=2, touch_ship_cap=2)
        return pg, tree, key[:3] + (caps,)


def test_undersized_caps_raise_instead_of_a_wrong_circuit():
    g = eulerian_rmat(6, avg_degree=4, seed=6)
    with pytest.raises(RuntimeError, match="flags failed"):
        _Undersized(n_parts=8, device="cpu").solve(g)


def test_partition_count_checks():
    tiny = Graph(3, np.array([0, 1, 2]), np.array([1, 2, 0]))
    with pytest.raises(ValueError, match="fewer than"):
        solve(tiny, n_parts=4, device="cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("P", PARTS)
def test_cuda_solve_matches_cpu(P):
    """On a card: the CUDA path (kernels included) returns the CPU path's
    circuit and mate byte for byte."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA path runs only on the card")
    g = eulerian_rmat(9, avg_degree=5, seed=P)
    on_card = solve(g, n_parts=P).validate()
    on_cpu = solve(g, n_parts=P, device="cpu")
    np.testing.assert_array_equal(on_card.circuit, on_cpu.circuit)
    np.testing.assert_array_equal(on_card.mate, on_cpu.mate)
