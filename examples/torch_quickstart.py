"""Quickstart for the PyTorch port: find an Euler circuit through the
port's solver facade (mirrors ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py

Generates an Eulerian RMAT graph (the paper's §4.2 pipeline) and hands it
to ``repro_torch.euler.solve`` — partitioning, merge-tree planning and
engine choice all live behind the facade.  ``backend="host"`` runs the
exact host BSP engine (Phases 1–3 on numpy and scipy, no device) with the
paper's Int64 memory-state metric per level and both §5 heuristics on;
``.validate()`` raises if the circuit is not a valid Euler circuit.
"""
from repro_torch.euler import solve
from repro_torch.graphgen.eulerize import eulerian_rmat

graph = eulerian_rmat(scale=12, avg_degree=5, seed=0)
print(f"graph: {graph.num_vertices} vertices, {graph.num_edges} edges, "
      f"eulerian={graph.is_eulerian()}")

result = solve(graph, backend="host", n_parts=8,
               remote_dedup=True, deferred_transfer=True).validate()

print(f"Euler circuit found: {len(result.circuit)} edges, "
      f"valid={result.valid}, {result.supersteps} BSP supersteps "
      f"(⌈log₂ 8⌉+1 = 4)")
for ls in result.levels:
    print(f"  level {ls.level}: {len(ls.states)} active partitions, "
          f"state={ls.cumulative} Int64s (avg {ls.average:.0f})")
