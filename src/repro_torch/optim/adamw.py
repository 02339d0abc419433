"""AdamW with f32 moments and global-norm clipping (mirrors
``repro/optim/adamw.py``).

The arithmetic is the reference's, op for op: the gradients are clipped
in their own dtype by ``min(1, clip_norm / max(‖g‖, 1e-9))``, the moments
are f32 whatever the parameter's dtype, the bias corrections are
``1 − b^step`` in f32, ``delta = m̂ / (√v̂ + eps) + wd · p`` in f32, and the
new parameter ``p − lr · delta`` is rounded once, to the parameter's dtype.
(``torch.optim.AdamW`` keeps its moments in the parameter's dtype and
rounds in another order.)  By design the port updates the parameters and
the moments in place, under ``no_grad``, where the reference returns new
trees and its ``jit`` donates the old ones.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 scalar: updates applied so far
    m: Any                  # f32 first moments, shaped as the params
    v: Any                  # f32 second moments


def init_adamw(params) -> AdamWState:
    """Zero moments in f32 on each parameter's device; step 0 on the
    first parameter's."""
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    device = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=zeros, v=tree_map(torch.clone, zeros))


def global_norm(tree) -> torch.Tensor:
    """√(Σ g²) over every leaf, each leaf's sum in f32, added in order."""
    total = None
    for g in tree_leaves(tree):
        sq = torch.sum(g.to(torch.float32) ** 2)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, lr: torch.Tensor,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 clip_norm: Optional[float] = 1.0):
    """One AdamW step.  Writes the new values into ``params`` and into
    ``state.m``/``state.v`` and returns ``(params, AdamWState)`` with the
    step advanced by one."""
    step = state.step + 1
    p_l, g_l = tree_leaves(params), tree_leaves(grads)
    m_l, v_l = tree_leaves(state.m), tree_leaves(state.v)
    if clip_norm is not None:
        gn = global_norm(g_l)
        scale = torch.clamp(clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
        g_l = [g * scale.to(g.dtype) for g in g_l]
    c1 = 1 - b1 ** step.to(torch.float32)
    c2 = 1 - b2 ** step.to(torch.float32)

    g32 = [g.to(torch.float32) for g in g_l]
    torch._foreach_mul_(m_l, b1)
    torch._foreach_add_(m_l, torch._foreach_mul(g32, 1 - b1))
    sq = torch._foreach_mul(g32, 1 - b2)
    torch._foreach_mul_(sq, g32)
    torch._foreach_mul_(v_l, b2)
    torch._foreach_add_(v_l, sq)
    del g32, sq
    delta = torch._foreach_div(m_l, c1)                   # m̂
    den = torch._foreach_div(v_l, c2)                     # v̂
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    torch._foreach_div_(delta, den)
    del den
    p32 = [p.to(torch.float32) for p in p_l]
    torch._foreach_add_(delta, torch._foreach_mul(p32, weight_decay))
    torch._foreach_mul_(delta, lr)
    new = torch._foreach_sub(p32, delta)
    for p, n in zip(p_l, new):
        p.copy_(n)                                        # one rounding
    return params, AdamWState(step=step, m=state.m, v=state.v)
