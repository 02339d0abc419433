"""The paper's algorithm on the card, via the port's solver facade
(mirrors ``examples/euler_distributed.py``).

    PYTHONPATH=src python examples/torch_euler_distributed.py
    PYTHONPATH=src python examples/torch_euler_distributed.py --device cpu --scale 7

Eight partitions on one device, §5 heuristics structurally on.
``EulerSolver`` owns the whole pipeline (partitioning, merge-tree
planning, capacity sizing); the default solve is fused — every level,
the mate accumulation and Phase 3 recorded once as one CUDA graph and
replayed, one host synchronization — and a second solve of the same
graph replays it (a program-cache hit).  The eager per-level oracle runs
afterwards and must give the same bytes.  Runs on ``cuda`` unless
``--device cpu`` is given (there the same body runs uncaptured); with no
card and no ``--device cpu`` it fails instead of falling back.
"""
import argparse
import sys

import numpy as np

from repro_torch.euler import EulerSolver
from repro_torch.graphgen.eulerize import eulerian_rmat


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (default cuda)")
    ap.add_argument("--scale", type=int, default=10,
                    help="RMAT scale of the graph (default 10)")
    args = ap.parse_args(argv)

    graph = eulerian_rmat(scale=args.scale, avg_degree=5, seed=1)
    solver = EulerSolver(n_parts=8, device=args.device)

    res = solver.solve(graph).validate()            # fused (default)
    print(f"V={graph.num_vertices} E={graph.num_edges} "
          f"merge-tree height={res.tree.height}")
    print(f"fused circuit valid={res.valid}: {len(res.circuit)} edges on "
          f"{res.device}, {solver.captures} recorded graph(s), one host "
          f"sync ({res.timings['total_s']:.2f}s incl. warm-up and "
          f"recording; {res.padded_edges} bucket-padding edges stripped)")

    warm = solver.solve(graph).validate()           # same bucket → replay
    print(f"warm solve: {warm.timings['total_s']:.2f}s, cache hit="
          f"{warm.cache.hit} ({warm.cache.traces} trace(s) in the session: "
          f"the recording on a card, the first run on the CPU)")
    if not warm.cache.hit:
        print("the warm solve missed the program cache", file=sys.stderr)
        return 1

    res_e = solver.solve(graph, fused=False).validate()
    same = (np.array_equal(res.circuit, res_e.circuit)
            and np.array_equal(res.mate, res_e.mate))
    print(f"eager oracle: {res.supersteps} supersteps one by one "
          f"({res_e.timings['total_s']:.2f}s); byte-identical={same}")
    if not same:
        print("the fused and eager circuits differ", file=sys.stderr)
        return 1
    for ls in res.levels:
        print(f"  superstep {ls.level}: pathMap state {ls.cumulative} Int64s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
