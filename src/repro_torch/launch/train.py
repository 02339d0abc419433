"""End-to-end training driver (mirrors ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --steps 300 --batch 8 --seq 128 [--reduced | --full] \\
        [--ckpt-dir /tmp/ckpt] [--fail-at 120] [--device cpu]

Composes the substrate: config registry → mesh → params and AdamW state
on the device (DTensors over a mesh) → synthetic data → the
``build_cell`` train step (eager; it updates the state in place) →
straggler monitor → async checkpointing → restart-on-failure loop.  It
runs on ``cuda`` unless given ``--device cpu``.  The initial weights come
from a ``torch.Generator`` on the device seeded with 0, the same on
every rank.

A world of more than one rank (``torch.distributed.run``; the trainer
initialises the group from its environment, gloo with ``--device cpu``,
else NCCL on ``cuda:LOCAL_RANK``) trains over ``make_test_mesh(world,
tp=--tp)``, as the reference does on more than one device; every rank
checkpoints (rank 0 writes) and restarts together, and rank 0 prints::

    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 4 -m repro_torch.launch.train --device cpu --tp 2

One rank keeps no mesh, as in the reference, and ``--tp`` is unused
there.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch
import torch.distributed as dist

from ..checkpoint.ckpt import CheckpointManager
from ..configs.base import ShapeCell
from ..configs.registry import get_config
from ..data.lm import SyntheticLM
from ..ft.failure import RestartPolicy, run_with_restarts
from ..ft.straggler import StragglerMonitor
from ..models.transformer import init_lm_params
from ..optim.adamw import init_adamw
from ..parallel.sharding import distribute
from .mesh import make_test_mesh
from .steps import build_cell, place_lm_state


def _world(device: torch.device) -> int:
    """The world ``torch.distributed.run`` started, its group initialised
    here (gloo on the CPU, NCCL on the card); 1 without one."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and not dist.is_initialized():
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return world


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir", default="/tmp/repro-torch-ckpt")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="inject a failure at this step (FT demo)")
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    ap.add_argument("--json", default=None,
                    help="write the losses, steps and restarts here "
                         "(rank 0)")
    args = ap.parse_args(argv)

    arch = get_config(args.arch, reduced=args.reduced)
    if arch.family != "lm":
        raise ValueError("train.py drives LM archs; see examples/")
    cell_shape = ShapeCell("train", "train", batch=args.batch,
                           seq_len=args.seq)
    arch = dataclasses.replace(arch, shapes={"train": cell_shape})
    device = torch.device(args.device)
    world = _world(device)
    mesh = make_test_mesh(world, tp=args.tp, device=device) \
        if world > 1 else None
    cell = build_cell(arch, "train", mesh)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())

    params = init_lm_params(torch.Generator(device=device).manual_seed(0),
                            arch.model)
    opt = init_adamw(params)
    if mesh is not None:
        params, opt = place_lm_state(mesh, params, opt)
    step_fn = cell.fn
    lead = mesh is None or dist.get_rank() == 0

    data = SyntheticLM(vocab=arch.model.vocab, seq_len=args.seq,
                       batch=args.batch, seed=0)
    ckpt = CheckpointManager(args.ckpt_dir)
    mon = StragglerMonitor(k_sigma=4.0)
    losses = []

    def one_step(state, i):
        params, opt = state
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch_at(i).items()}
        if mesh is not None:
            batch = distribute(batch, cell.in_shardings[2])
        t0 = time.perf_counter()
        params, opt, loss = step_fn(params, opt, batch)
        loss = float(loss.full_tensor() if mesh is not None else loss)
        mon.observe(i, time.perf_counter() - t0)
        losses.append(loss)
        if lead and i % args.log_every == 0:
            print(f"step {i:5d} loss {loss:.4f}", flush=True)
        return params, opt

    fail_at = (lambda s: s == args.fail_at) if args.fail_at >= 0 else None
    (params, opt), steps, restarts = run_with_restarts(
        one_step, (params, opt), args.steps, ckpt,
        policy=RestartPolicy(max_restarts=2, ckpt_every=args.ckpt_every),
        fail_at=fail_at,
    )
    if lead:
        print(f"done: {steps} steps, {restarts} restarts, "
              f"loss {losses[0]:.3f} → {losses[-1]:.3f}, "
              f"stragglers flagged: {mon.stats.flagged}", flush=True)
    if lead and args.json:
        import json

        with open(args.json, "w") as f:
            json.dump({"losses": losses, "steps": steps,
                       "restarts": restarts}, f)
    assert losses[-1] < losses[0], "training should reduce loss"
    return losses


if __name__ == "__main__":
    main()
