"""CLI: audit the fused programs of a representative bucket (mirrors
``repro/analysis/audit.py``).

    PYTHONPATH=src python -m repro_torch.analysis.audit \\
        --scale 5 --parts 2 --widths 1,4 --device cpu --json AUDIT.json

Builds an Eulerian R-MAT graph, buckets it through a fresh
:class:`~repro_torch.euler.EulerSolver` (the serving path's ladder
quantization), records every requested batch width's fused program on
``--device`` (the card unless ``cpu`` is asked for) and audits each
against the static schedule (:mod:`repro_torch.analysis.graph_audit`);
on a card the recorded CUDA graph's node census too.  Writes the report
as JSON and exits 1 on any violation, 2 when the card is missing.  The
reference's source lint stays the JAX package's (``python -m
repro.analysis.lint`` covers ``src/``, the port included).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence


def _parse(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.audit", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scale", type=int, default=5,
                    help="R-MAT scale (2**scale vertices)")
    ap.add_argument("--parts", type=int, default=2,
                    help="partition count")
    ap.add_argument("--avg-degree", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--widths", default="1,4",
                    help="comma-separated batch widths to audit")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the programs record (default: the card)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the full report here (e.g. AUDIT.json)")
    ap.add_argument("--replicated-phase3", action="store_true",
                    help="audit the replicated Phase 3 oracle path "
                         "(default: sharded when --parts > 1)")
    ap.add_argument("--no-gather-circuit", action="store_true",
                    help="audit the gather_circuit=False variant "
                         "(sharded rank triple, host-side emission)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _parse(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("audit needs a CUDA device; pass --device cpu to record on "
              "the CPU", file=sys.stderr)
        return 2

    from repro_torch.analysis import audit_graph
    from repro_torch.euler import EulerSolver
    from repro_torch.graphgen.eulerize import eulerian_rmat

    widths = [int(w) for w in args.widths.split(",") if w]
    graph = eulerian_rmat(args.scale, avg_degree=args.avg_degree,
                          seed=args.seed)
    solver = EulerSolver(
        n_parts=args.parts, width_ladder=widths or (1,), device=args.device,
        sharded_phase3=False if args.replicated_phase3 else None,
        gather_circuit=not args.no_gather_circuit)
    report = audit_graph(solver, graph, widths=widths)

    for prog in report["programs"]:
        tag = f"e_cap={prog['e_cap']} B={prog['batch'] or 1}"
        state = "ok" if prog["ok"] else "FAIL"
        cen = prog["census"]
        print(f"  [{state}] {tag}: {cen.get('all_to_all', 0)} all_to_all / "
              f"{cen.get('all_gather', 0)} all_gather / "
              f"{cen.get('ppermute', 0)} ppermute / "
              f"{cen.get('pallas_call', 0)} pallas_call "
              f"(scan length {prog['n_levels']})")
        for viol in prog["violations"]:
            print(f"         - {viol}")

    if args.json:
        with open(args.json, "w") as fh:
            json.dump(report, fh, indent=2, default=str)
        print(f"report -> {args.json}")

    print(f"repro_torch.analysis.audit: "
          f"{'PASS' if report['ok'] else 'FAIL'} "
          f"({len(report['programs'])} program(s))")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
