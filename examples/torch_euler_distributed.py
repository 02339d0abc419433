"""The paper's algorithm on the card, via the port's solver facade
(mirrors ``examples/euler_distributed.py``).

    PYTHONPATH=src python examples/torch_euler_distributed.py
    PYTHONPATH=src python examples/torch_euler_distributed.py --device cpu --scale 7
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
        examples/torch_euler_distributed.py --mesh --device cpu --scale 7

Eight partitions on one device, §5 heuristics structurally on.
``EulerSolver`` owns the whole pipeline (partitioning, merge-tree
planning, capacity sizing); the default solve is fused — every level,
the mate accumulation and Phase 3 recorded once as one CUDA graph and
replayed, one host synchronization — and a second solve of the same
graph replays it (a program-cache hit).  The eager per-level oracle runs
afterwards and must give the same bytes.  Runs on ``cuda`` unless
``--device cpu`` is given (there the same body runs uncaptured); with no
card and no ``--device cpu`` it fails instead of falling back.

With ``--mesh``, under ``torch.distributed.run --nproc-per-node R``, the
eight partitions are spread over the R ranks (``make_part_mesh``; R must
divide 8): gloo with ``--device cpu``, NCCL otherwise, one card a rank.
Every rank solves fused and eagerly over the mesh; rank 0 also solves
without one and prints whether the bytes are equal (exit 1 if not), as
``examples/euler_distributed.py`` runs the reference on its mesh.
"""
import argparse
import os
import sys

import numpy as np
import torch.distributed as dist

from repro_torch.euler import EulerSolver
from repro_torch.graphgen.eulerize import eulerian_rmat
from repro_torch.launch.mesh import NCCL_GRAPH_MIXING, make_part_mesh


def main_mesh(graph, device: str) -> int:
    """The ``--mesh`` run (module docstring)."""
    if device != "cpu":     # before NCCL's first communicator (mesh.py)
        os.environ.setdefault(*NCCL_GRAPH_MIXING)
    dist.init_process_group("gloo" if device == "cpu" else "nccl")
    try:
        mesh = make_part_mesh(8, device="cpu" if device == "cpu" else None)
        res, res_e = solve_both(graph, mesh)
        print(f"rank {mesh.rank}/{mesh.world}: partitions "
              f"{mesh.first}–{mesh.first + mesh.m - 1} on {mesh.device}; "
              f"fused {res.timings['total_s']:.2f}s, eager "
              f"{res_e.timings['total_s']:.2f}s; calls {dict(mesh.calls)}")
        if mesh.rank:
            return 0
        plain = EulerSolver(n_parts=8, device=mesh.device).solve(graph)
        same = all(np.array_equal(r.circuit, plain.circuit)
                   and np.array_equal(r.mate, plain.mate)
                   for r in (res, res_e))
        print(f"mesh of {mesh.world} rank(s): fused and eager "
              f"byte-identical to the meshless solve={same}")
        return 0 if same else 1
    finally:
        dist.destroy_process_group()


def solve_both(graph, mesh):
    """The fused and the eager solve over ``mesh``, validated; the solver
    (and its recorded graph) is gone when this returns, as it must be
    before the group is destroyed: NCCL waits for the CUDA graphs that
    hold its kernels."""
    solver = EulerSolver(mesh=mesh)
    return (solver.solve(graph).validate(),
            solver.solve(graph, fused=False).validate())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (default cuda)")
    ap.add_argument("--scale", type=int, default=10,
                    help="RMAT scale of the graph (default 10)")
    ap.add_argument("--mesh", action="store_true",
                    help="solve across the ranks of torch.distributed.run")
    args = ap.parse_args(argv)

    graph = eulerian_rmat(scale=args.scale, avg_degree=5, seed=1)
    if args.mesh:
        return main_mesh(graph, args.device)
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
