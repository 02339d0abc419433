"""One rank of the production mesh: build and run each (arch × shape) cell
on it and report what one device holds, moves and computes (mirrors
``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch euler-rmat \\
        [--shape fused] [--multi-pod | --both-meshes] [--json out.json] \\
        [--device cpu]

The reference lowers and compiles every cell for its production mesh
(256 devices, or 512 multi-pod) on simulated CPU devices and reads XLA's
memory and cost analyses.  Here one process is rank 0 of a world of
torch's ``fake`` backend (``FakeStore``) of that size, made by
:func:`run_cell` and destroyed after it, never at import:

  1. the production mesh (``launch/mesh.py::make_production_mesh``) and
     the cell on it (``launch/steps.py::build_cell``), one partition a
     rank;
  2. the cell's abstract inputs materialised as empty tables: masks
     false and ids ``BIG``, as ``state_from_numpy`` pads; the stub-vertex
     map vertex 0 (the reference's pad); the ancestor table a balanced
     binary merge tree (level ℓ merges partitions ``2^ℓ`` apart into the
     lower); the superstep's level 1 (the first that receives shipped
     tables);
  3. one call on the card (the fused cell: then one replay of what the
     call recorded).

Per rank it reports the arguments' and outputs' bytes, the peak
allocated and reserved memory of the call (``torch.cuda.max_memory_*``)
beside the static ``program_cost_bytes`` model, the bytes each kind of
collective sends from this rank in one run of the cell (the
:class:`PartMesh` counts, where the reference parses its HLO), the
kernel launches of one run, ``model_flops`` per rank, and the three
terms at the H100's numbers with the dominant one.

What it cannot measure: a ``fake`` group moves no data (the mesh
zero-fills what it receives), and empty tables converge in the first
rounds of every loop, so the device times are a floor and the cells'
flags are not checked.  The memory is the real figure: every table is
padded to its cap.

The dense LMs' cells (SmolLM-360M, StarCoder2-7B, Granite-20B ×
``train_4k``, ``prefill_32k``, ``decode_32k``) run on the same rank
(:func:`run_lm_cell`): the cell's inputs are this rank's shards as
DTensors placed by its ``in_shardings`` (seeded weights, zero moments,
token 0, a zero cache whose sequences hold ``seq_len − 1`` tokens, so a
decode step attends to the whole context), and one call runs under a
``CommDebugMode`` that counts the collectives DTensor issues, by kind,
with the bytes this rank sends in each (:class:`CommCount`; the
counterpart of the reference's HLO parse), as the Euler rows count
theirs.  Those bytes are the ring algorithm's, computed from each
operand's exact size and its group's size n: an all-gather sends
(n − 1) operands, a reduce-scatter and an all-to-all (n − 1)/n of one, a
broadcast (n − 1)/n of one on average, an all-reduce 2(n − 1)/n of one.
NCCL may pick another algorithm (a tree for an all-reduce), and torch's
``fake`` backend sends nothing.  The memory is this
rank's real peak; the values are not checked (the ``fake`` group's
collectives leave what they receive as allocated).  MoE LMs print
``SKIP`` (their mesh is ROADMAP queue 1 item 9c.4), the other families'
cells too (item 9c.3), as the reference skips its own ``long_500k``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor.debug import CommDebugMode

#: NVIDIA H100 SXM, per card: dense bf16 tensor-core peak and HBM3 rate
#: (the port's bounds, PERF.md §6), and NVLink 4's 900 GB/s total, 450
#: GB/s a direction (the card's data sheet); the reference uses TPU v5e
#: constants
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9
#: the superstep cell's level: the first that ships parked edges
LEVEL = 1
#: why a cell of another family is skipped
OTHER_FAMILIES = "item 9c.3: their mesh is not ported"
#: why a MoE LM's cell is skipped
MOE_LMS = ("item 9c.4: a MoE LM over a mesh (expert parallelism) is not "
           "ported")


#: the bytes a rank sends in a ring collective over n ranks, per byte of
#: its operand
RING_SENT = {"all_gather_into_tensor": lambda n: n - 1,
             "reduce_scatter_tensor": lambda n: (n - 1) / n,
             "all_to_all_single": lambda n: (n - 1) / n,
             "broadcast": lambda n: (n - 1) / n,
             "all_reduce": lambda n: 2 * (n - 1) / n}


class CommCount(CommDebugMode):
    """``CommDebugMode``, which counts the collectives DTensor issues by
    kind, and also sums by kind the bytes this rank sends in them
    (``RING_SENT`` of each operand; a kind it does not know raises)."""

    def __init__(self):
        super().__init__()
        self.sent_bytes: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.distributed_c10d import _resolve_process_group

        before = dict(self.comm_counts)
        out = super().__torch_dispatch__(func, types, args, kwargs)
        for kind, n in self.comm_counts.items():
            if n != before.get(kind, 0):
                name = getattr(kind, "__name__", str(kind))
                t = args[0]
                # every functional collective's group is its last argument
                size = _resolve_process_group(args[-1]).size()
                self.sent_bytes[name] = self.sent_bytes.get(name, 0) + round(
                    RING_SENT[name](size) * t.numel() * t.element_size())
        return out


def _nbytes(tree) -> int:
    """Bytes of every tensor or array in a nested tuple."""
    if isinstance(tree, (tuple, list)):
        return sum(_nbytes(x) for x in tree)
    return int(tree.nbytes) if hasattr(tree, "nbytes") else \
        tree.numel() * tree.element_size()


def balanced_anc(levels: int, n: int, device) -> torch.Tensor:
    """``[levels, n]`` ancestor table of a balanced binary merge tree:
    after level ℓ partition p's active partition is p with its low ℓ + 1
    bits cleared."""
    lvl = torch.arange(levels, dtype=torch.int64, device=device)[:, None]
    p = torch.arange(n, dtype=torch.int64, device=device)[None]
    keep = ~((torch.ones_like(lvl) << (lvl + 1)) - 1)
    return (p & keep).to(torch.int32)


def empty_inputs(abstract, n_parts: int, device) -> tuple:
    """The cell's abstract inputs as empty tables on ``device`` (module
    docstring, step 2)."""
    from ..core.engine import EngineState
    from ..core.phase1 import BIG

    def one(x):
        if isinstance(x, EngineState):
            return EngineState(*(
                torch.zeros(t.shape, dtype=t.dtype, device=device)
                if t.dtype == torch.bool
                else torch.full(t.shape, BIG, dtype=t.dtype, device=device)
                for t in x))
        if x.dim() == 0:
            return torch.tensor(LEVEL, dtype=x.dtype, device=device)
        if x.dim() == 2:
            return balanced_anc(x.shape[0], n_parts, device)
        return torch.zeros(x.shape, dtype=x.dtype, device=device)

    return tuple(one(x) for x in abstract)


def _launches() -> Dict[str, int]:
    from ..kernels import pointer_double as pd

    return {name: getattr(pd, name).launches for name in
            ("pointer_double", "pointer_double_rank",
             "pointer_double_shard", "pointer_double_rank_shard")}


def _sync(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def analyse(arg_bytes: int, out_bytes: int, sent: Dict[str, int],
            model_flops: float, n_chips: int) -> Dict:
    """The reference's three terms for one rank at the H100's numbers:
    compute (model FLOPs a rank over the bf16 peak), memory (the
    arguments read once and the outputs written once over HBM) and
    collective (the bytes this rank sends over one NVLink direction)."""
    flops = model_flops / n_chips
    coll = float(sum(sent.values()))
    terms = {"compute": flops / PEAK_FLOPS,
             "memory": (arg_bytes + out_bytes) / HBM_BW,
             "collective": coll / LINK_BW}
    return {"terms_s": terms,
            "dominant": max(terms.items(), key=lambda kv: kv[1])[0],
            "model_flops_total": model_flops,
            "model_flops_per_device": flops,
            "collective_bytes": coll}


def run_cell(arch_id: str, shape: str, multi_pod: bool,
             verbose: bool = True, device=None,
             reduced: bool = False) -> Optional[Dict]:
    """Build and run one cell on rank 0 of a ``fake`` world of the
    production mesh's size (module docstring); returns its record, a
    ``skip`` record for another family's cell."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from ..analysis.graph_audit import program_cost_bytes
    from ..configs.registry import get_config
    from ..launch.mesh import make_production_mesh
    from ..launch.steps import build_cell

    world = 512 if multi_pod else 256
    mesh_shape = [2, 16, 16] if multi_pod else [16, 16]
    arch = get_config(arch_id, reduced=reduced)
    skip = arch.shapes[shape].skip if arch.family in ("euler", "lm") \
        else OTHER_FAMILIES
    if arch.family == "lm" and arch.model.moe is not None:
        skip = MOE_LMS
    if skip:
        if verbose:
            print(f"[dryrun] {arch_id} × {shape} SKIP: {skip}", flush=True)
        return {"arch": arch_id, "shape": shape, "skip": skip,
                "mesh": mesh_shape}
    if arch.family == "lm":
        return run_lm_cell(arch, shape, multi_pod, verbose, device)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        n_chips = mesh.size()
        t0 = time.perf_counter()
        cell = build_cell(arch, shape, mesh)
        eng = cell.engine
        pm = eng.mesh
        dev = pm.device
        inputs = empty_inputs(cell.abstract_inputs, eng.n, dev)
        build_s = time.perf_counter() - t0
        cuda = dev.type == "cuda"
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        pm.calls.clear()
        pm.sent_bytes.clear()
        before = _launches()
        t0 = _sync(dev)
        out = cell.fn(*inputs)
        call_s = _sync(dev) - t0
        # a fused run's first launch on a card runs its body twice (the
        # eager warm-up, then the recording); counts are of one run
        runs = 2 if cuda and shape == "fused" else 1
        launches = {k: (v - before[k]) // runs
                    for k, v in _launches().items()}
        calls = {k: v // runs for k, v in pm.calls.items()}
        sent = {k: v // runs for k, v in pm.sent_bytes.items()}
        replay_s = None
        if shape == "fused":
            t0 = _sync(dev)
            cell.fn(*inputs)
            replay_s = _sync(dev) - t0
        peak = torch.cuda.max_memory_allocated(dev) if cuda else None
        reserved = torch.cuda.max_memory_reserved(dev) if cuda else None
        c = arch.model.caps
        E = arch.model.fused_edges or eng.n * c.edge_cap
        model_bytes = program_cost_bytes((E, eng.n, arch.model.n_levels, c),
                                         None) // eng.n * pm.m
        arg_bytes, out_bytes = _nbytes(inputs), _nbytes(out)
        rec = analyse(arg_bytes, out_bytes, sent, cell.model_flops, n_chips)
        rec.update({
            "arch": arch_id, "shape": shape, "config": arch.model.name,
            "mesh": mesh_shape, "world": pm.world, "rank": pm.rank,
            "partitions_per_rank": pm.m, "device": str(dev),
            "memory": {"argument_bytes": arg_bytes,
                       "output_bytes": out_bytes,
                       "peak_allocated_bytes": peak,
                       "peak_reserved_bytes": reserved,
                       "program_cost_bytes": model_bytes},
            "collectives": {"calls": calls, "sent_bytes": sent},
            "launches": launches,
            "build_s": build_s, "call_s": call_s, "replay_s": replay_s,
            "measured": "fake group: no data moved, empty tables; device "
                        "times a floor, flags not checked",
        })
        if shape == "fused":
            eng.evict_program(E, None)
        del cell, eng, out, inputs
        if cuda:
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    if verbose:
        m, t = rec["memory"], rec["terms_s"]
        mib = (lambda b: "n/a" if b is None else f"{b / 2**20:.3f}MiB")
        print(f"[dryrun] {arch_id} × {shape} mesh={mesh_shape} OK  "
              f"rank {rec['rank']}/{rec['world']} "
              f"args={mib(m['argument_bytes'])} "
              f"out={mib(m['output_bytes'])} "
              f"peak={mib(m['peak_allocated_bytes'])} "
              f"reserved={mib(m['peak_reserved_bytes'])} "
              f"model={mib(m['program_cost_bytes'])} | "
              f"compute={t['compute'] * 1e3:.4f}ms "
              f"mem={t['memory'] * 1e3:.4f}ms "
              f"coll={t['collective'] * 1e3:.4f}ms → {rec['dominant']}",
              flush=True)
        print(f"    collectives: calls={json.dumps(rec['collectives']['calls'])} "
              f"sent_bytes={json.dumps(rec['collectives']['sent_bytes'])} "
              f"launches={json.dumps(launches)} "
              f"model_flops_per_device={rec['model_flops_per_device']:.4e} "
              f"call_s={call_s:.4f} replay_s={replay_s} "
              f"build_s={build_s:.2f} ({rec['measured']})", flush=True)
    return rec


def lm_inputs(cell, kind: str, mesh, seq_len: int, seed: int = 0) -> tuple:
    """A dense LM cell's inputs as this rank's DTensors (module
    docstring), every local shard made on the rank's device."""
    from torch.distributed.tensor import DTensor

    from ..parallel.sharding import mesh_device
    from ..tree import tree_leaves, tree_unflatten

    dev = mesh_device(mesh)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def weight(t):
        if t.dim() == 1:
            return torch.ones(t.shape, dtype=t.dtype, device=dev)
        return (torch.randn(t.shape, generator=gen, device=dev) * 0.02
                ).to(t.dtype)

    def zeros(t):
        return torch.zeros(t.shape, dtype=t.dtype, device=dev)

    def place(i, make):
        abstract, shard = cell.abstract_inputs[i], cell.in_shardings[i]
        return tree_unflatten(abstract, [
            DTensor.from_local(make(t), mesh, s.placements, run_check=False)
            for t, s in zip(tree_leaves(abstract), tree_leaves(shard))])

    params = place(0, weight)
    if kind == "train":
        return params, place(1, zeros), place(2, zeros)
    if kind == "prefill":
        return params, place(1, zeros)
    cache = place(1, zeros)
    cache.length.to_local().fill_(seq_len - 1)
    return params, cache, place(2, zeros)


def run_lm_cell(arch, shape: str, multi_pod: bool, verbose: bool = True,
                device=None, world: Optional[int] = None,
                tp: int = 2) -> Dict:
    """One dense LM cell on rank 0 of a ``fake`` world of the production
    mesh's size (or, with ``world``, of ``make_test_mesh(world, tp)``):
    the record of :func:`run_cell`, its collectives read by
    :class:`CommCount`."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from ..launch.mesh import make_production_mesh, make_test_mesh
    from ..launch.steps import build_cell
    from ..kernels import ops

    if world is None:
        world = 512 if multi_pod else 256
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device=device) \
            if world == (512 if multi_pod else 256) else \
            make_test_mesh(world, tp=tp, device=device)
        mesh_shape = list(mesh.shape)
        cell_shape = arch.shapes[shape]
        t0 = time.perf_counter()
        cell = build_cell(arch, shape, mesh)
        inputs = lm_inputs(cell, cell_shape.kind, mesh, cell_shape.seq_len)
        dev = inputs[0]["embed"].to_local().device
        build_s = time.perf_counter() - t0
        cuda = dev.type == "cuda"
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        before = ops.launch_counts()
        counter = CommCount()
        t0 = _sync(dev)
        with counter:
            out = cell.fn(*inputs)
        call_s = _sync(dev) - t0
        launches = {k: v - before[k] for k, v in ops.launch_counts().items()
                    if v != before[k]}
        peak = torch.cuda.max_memory_allocated(dev) if cuda else None
        reserved = torch.cuda.max_memory_reserved(dev) if cuda else None
        calls = {getattr(k, "__name__", str(k)): v
                 for k, v in counter.get_comm_counts().items()}
        sent = dict(counter.sent_bytes)

        def local_bytes(tree):
            from ..tree import tree_leaves
            return sum(t.to_local().numel() * t.to_local().element_size()
                       for t in tree_leaves(tree)
                       if isinstance(t, torch.Tensor))

        arg_bytes, out_bytes = local_bytes(inputs), local_bytes(out)
        rec = analyse(arg_bytes, out_bytes, sent, cell.model_flops,
                      mesh.size())
        rec.update({
            "arch": arch.arch_id, "shape": shape, "config": arch.model.name,
            "mesh": mesh_shape, "world": world, "rank": dist.get_rank(),
            "device": str(dev),
            "memory": {"argument_bytes": arg_bytes,
                       "output_bytes": out_bytes,
                       "peak_allocated_bytes": peak,
                       "peak_reserved_bytes": reserved},
            "collectives": {"calls": calls, "sent_bytes": sent},
            "launches": launches, "build_s": build_s, "call_s": call_s,
            "measured": "fake group: no data moved, values not checked; "
                        "collective bytes are a ring's",
        })
        del cell, out, inputs
        if cuda:
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    if verbose:
        m, t = rec["memory"], rec["terms_s"]
        gib = (lambda b: "n/a" if b is None else f"{b / 2**30:.3f}GiB")
        print(f"[dryrun] {arch.arch_id} × {shape} mesh={mesh_shape} OK  "
              f"rank {rec['rank']}/{world} args={gib(m['argument_bytes'])} "
              f"out={gib(m['output_bytes'])} "
              f"peak={gib(m['peak_allocated_bytes'])} "
              f"reserved={gib(m['peak_reserved_bytes'])} | "
              f"compute={t['compute'] * 1e3:.4f}ms "
              f"mem={t['memory'] * 1e3:.4f}ms "
              f"coll={t['collective'] * 1e3:.4f}ms → {rec['dominant']}",
              flush=True)
        print(f"    collectives: calls={json.dumps(calls)} "
              f"sent_bytes={json.dumps(sent)} "
              f"launches={json.dumps(launches)} "
              f"model_flops_per_device={rec['model_flops_per_device']:.4e} "
              f"call_s={call_s:.4f} build_s={build_s:.2f} "
              f"({rec['measured']})", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)

    from ..configs.registry import ARCH_IDS, get_config

    archs = [args.arch] if args.arch else ARCH_IDS
    records, failures = [], []
    for a in archs:
        cfg = get_config(a)
        shapes = [args.shape] if args.shape else list(cfg.shapes)
        for s in shapes:
            meshes = [False, True] if args.both_meshes else [args.multi_pod]
            for mp in meshes:
                try:
                    rec = run_cell(a, s, mp, device=args.device)
                    if rec:
                        records.append(rec)
                except Exception as e:  # noqa: BLE001 — reported, exit 1
                    failures.append((a, s, mp, repr(e)))
                    print(f"[dryrun] {a} × {s} multi_pod={mp} FAILED: {e}",
                          flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(records, f, indent=1)
    ran = sum("skip" not in r for r in records)
    print(f"\n[dryrun] {ran} cells OK, {len(records) - ran} skipped, "
          f"{len(failures)} failed", flush=True)
    for f in failures:
        print("  FAIL:", f)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
