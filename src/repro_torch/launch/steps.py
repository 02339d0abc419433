"""Resolve (arch × shape) → step function and abstract inputs (mirrors
the LM half of ``repro/launch/steps.py``).

:func:`build_cell` is the one entry point, as in the reference: the
trainer runs its ``train`` cell, and its ``prefill`` and ``decode`` cells
are the port's serving steps.  The port runs on one device, so there is
no mesh and no sharding: abstract inputs are ``meta`` tensors, and a
``mesh`` raises (ROADMAP queue 1 item 9), as does every family but the
LM (item 8).  Steps run eagerly; the train step updates the parameters
and the optimizer state in place (the reference donates them).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from ..configs.base import ArchConfig, ShapeCell
from ..models.transformer import (LMConfig, abstract_kv_cache,
                                  abstract_lm_params, decode_step, lm_loss,
                                  prefill_step)
from ..optim.adamw import adamw_update, init_adamw
from ..optim.schedule import warmup_cosine
from ..tree import tree_leaves, tree_unflatten


class Cell(NamedTuple):
    """Everything needed to run one (arch × shape) cell."""

    fn: Callable                 # step function
    abstract_inputs: Tuple       # meta-tensor trees matching fn's args
    model_flops: float           # analytic useful FLOPs of one call
    note: str = ""


def _lm_train_flops(cfg: LMConfig, cell: ShapeCell) -> float:
    return 6.0 * cfg.active_param_count() * cell.batch * cell.seq_len


def lm_value_and_grad(params, cfg: LMConfig, tokens: torch.Tensor,
                      labels: torch.Tensor):
    """``lm_loss`` and its gradient with respect to every parameter (a
    tree shaped as ``params``), by autograd: the reference's
    ``jax.value_and_grad(lm_loss)``."""
    leaves = tree_leaves(params)
    with torch.enable_grad():
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss = lm_loss(params, cfg, tokens, labels)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
    return loss.detach(), tree_unflatten(params, grads)


def _tokens_meta(*shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device="meta")


def build_lm_cell(arch: ArchConfig, cell: ShapeCell) -> Cell:
    cfg: LMConfig = arch.model
    params_abs = abstract_lm_params(cfg)

    if cell.kind == "train":
        opt_abs = init_adamw(params_abs)
        batch_abs = {"tokens": _tokens_meta(cell.batch, cell.seq_len),
                     "labels": _tokens_meta(cell.batch, cell.seq_len)}

        def step(params, opt, batch):
            lr = warmup_cosine(opt.step, 3e-4, 2000, 100_000)
            loss, grads = lm_value_and_grad(params, cfg, batch["tokens"],
                                            batch["labels"])
            params, opt = adamw_update(params, grads, opt, lr)
            return params, opt, loss

        return Cell(step, (params_abs, opt_abs, batch_abs),
                    _lm_train_flops(cfg, cell))

    if cell.kind == "prefill":
        def step(params, tokens):
            return prefill_step(params, cfg, tokens)

        flops = 2.0 * cfg.active_param_count() * cell.batch * cell.seq_len
        return Cell(step, (params_abs, _tokens_meta(cell.batch, cell.seq_len)),
                    flops)

    if cell.kind == "decode":
        def step(params, cache, tokens):
            return decode_step(params, cfg, cache, tokens)

        cache_abs = abstract_kv_cache(cfg, cell.batch, cell.seq_len)
        flops = 2.0 * cfg.active_param_count() * cell.batch
        return Cell(step, (params_abs, cache_abs, _tokens_meta(cell.batch)),
                    flops, note="writes the cache in place")

    raise ValueError(cell.kind)


class SkippedCell(Exception):
    pass


def build_cell(arch: ArchConfig, shape_name: str, mesh=None) -> Cell:
    cell = arch.shapes[shape_name]
    if cell.skip:
        raise SkippedCell(cell.skip)
    if mesh is not None:
        raise NotImplementedError("the port runs on one device; a mesh "
                                  "waits for ROADMAP queue 1 item 9")
    if arch.family != "lm":
        raise NotImplementedError(f"{arch.family} cells are not ported yet "
                                  f"(ROADMAP queue 1 item 8)")
    return build_lm_cell(arch, cell)
