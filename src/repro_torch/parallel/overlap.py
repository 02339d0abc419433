"""Microbatched gradient accumulation (mirrors
``repro/parallel/overlap.py``).

``grad_accum_scan`` splits the global batch into M microbatches and
accumulates the loss and the gradients over them in f32, as the
reference's ``lax.scan`` does; here the scan is a Python loop of
autograd calls (``launch/steps.py::_value_and_grad``).  In the reference
the split lets XLA overlap each microbatch's data-parallel all-reduce
with the next one's compute; the port has no data-parallel mesh yet
(ROADMAP queue 1 item 9c), so only the arithmetic is carried over.

The reference's ``XLA_OVERLAP_FLAGS`` are flags of XLA's TPU scheduler
and have no counterpart here.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from ..tree import tree_map


def grad_accum_scan(
    loss_fn: Callable[..., torch.Tensor],
    params: Any,
    batch: Any,
    n_micro: int,
) -> Tuple[torch.Tensor, Any]:
    """Mean loss + grads over ``n_micro`` microbatches (f32-accumulated).

    ``batch`` leaves must have a leading dim divisible by n_micro;
    microbatch i is rows ``i·b … (i+1)·b − 1`` of every leaf.
    """
    from ..launch.steps import _value_and_grad

    def split(x):
        return x.reshape((n_micro, x.shape[0] // n_micro) + tuple(x.shape[1:]))

    micro = tree_map(split, batch)
    loss_acc = torch.zeros((), dtype=torch.float32)
    g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    for i in range(n_micro):
        mb = tree_map(lambda x: x[i], micro)
        loss, g = _value_and_grad(loss_fn, params, mb)
        g_acc = tree_map(torch.add, g_acc, g)
        loss_acc = loss_acc.to(loss.device) + loss
    inv = 1.0 / n_micro
    return loss_acc * inv, tree_map(lambda g: g * inv, g_acc)
