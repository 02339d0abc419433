"""Bounded convergence loops that a CUDA graph can hold.

The reference runs its three splice loops (Phase 1's in
``repro/core/phase1.py``, the replicated and sharded Phase 3's in
``repro/core/phase3.py``) as ``lax.while_loop`` inside one jitted
program: a round repeats while its ``changed`` flag holds, at most a
fixed budget of rounds.  It has no file for this; here it is
:func:`converge`, used by all three loops:

  * eagerly (any CPU run, and a CUDA run outside a capture) it reads the
    flag on the host once per round and stops at convergence, as the
    ``while_loop`` does;
  * while the current CUDA stream is being captured into a graph no host
    read is allowed, so it runs the whole budget.  A round after
    convergence is the identity (nothing is left to rotate, so nothing
    moves and ``changed`` stays False), which keeps the bits equal.

A conditional graph node could skip the converged rounds on the device
instead, but torch 2.11 (the H100 machine's) does not expose one (torch
2.13 has ``CUDAGraph.begin_capture_to_if_node``), so the budget is paid
in full under capture; PERF.md records what that costs.

The carried values live in buffers allocated before the first round, and
every round writes its results back into them with ``copy_``: a round
body that a conditional node skips would leave its own outputs undefined,
so this layout is the one such a node needs.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch


def capturing(device: torch.device) -> bool:
    """Whether work on ``device`` is being recorded into a CUDA graph
    (then nothing may be read on the host)."""
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def converge(step: Callable[..., Sequence[torch.Tensor]],
             carry: Sequence[torch.Tensor],
             rounds: int) -> Tuple[torch.Tensor, ...]:
    """Run ``step`` over ``carry`` while the carry's last element (a bool
    ``changed`` flag of any shape) holds anywhere, at most ``rounds``
    times; under capture, exactly ``rounds`` times.

    ``step(*carry)`` returns the next carry: fresh tensors of the same
    shapes and types, none of them a view of its inputs.  The carry is
    copied once into new buffers, and each round is written back into
    them, so the returned tensors are those buffers."""
    bufs = tuple(x.clone() for x in carry)
    full = capturing(bufs[0].device)
    for _ in range(rounds):
        if not full and not bool(bufs[-1].any()):    # one host read a round
            break
        for buf, new in zip(bufs, step(*bufs)):
            buf.copy_(new)
    return bufs
