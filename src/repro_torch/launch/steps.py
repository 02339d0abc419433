"""Resolve (arch × shape) → step function and abstract inputs (mirrors
``repro/launch/steps.py``).

:func:`build_cell` is the one entry point, as in the reference: the
trainer runs its ``train`` cell, and its ``prefill`` and ``decode`` cells
are the port's serving steps; a GNN arch's cells each train on one
padded graph; NequIP's train on padded point clouds (``molecule`` on
energies and forces, by a second-order gradient); the recsys arch's
cells train, serve or retrieve.  Steps run eagerly; a train step updates
the parameters and the optimizer state in place (the reference donates
them).

A dense LM's cells also run over a ``DeviceMesh`` with ``data`` and
``model`` axes, as the reference's do: their ``in_shardings`` and
``out_shardings`` are the reference's specs as DTensor placements
(``parallel/sharding.py``), the step takes and returns DTensors so
placed (it checks its results against ``out_shardings``) (:func:`place_lm_state` puts whole weights on a mesh), and the
abstract inputs are this rank's ``meta`` tensors.  A MoE LM over a mesh
raises (ROADMAP queue 1 item 9c.4); the GNN, NequIP and recsys families
run on one device only, abstract inputs ``meta`` tensors, and a mesh
raises (item 9c.3).

The Euler family (``euler-rmat``) runs only over a mesh, as in the
reference: a ``DeviceMesh`` (``launch/mesh.py``, one partition a device,
all axes flattened) or a :class:`~repro_torch.launch.mesh.PartMesh`
(its partitions over its ranks).  Its cells' abstract inputs are this
rank's ``meta`` tensors, sized by ``parallel/sharding.py``'s specs
(:func:`~repro_torch.parallel.sharding.local_shape`), as the reference's
``in_shardings`` size them; ``superstep`` runs one level
(:meth:`Engine.superstep`), ``fused`` the bucket's whole run
(:class:`FusedRun`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig, ShapeCell
from ..core.engine import Engine, EngineState
from ..models import gnn as gnn_mod
from ..models.equivariant import (AtomsBatch, NequIPConfig,
                                  abstract_nequip_params,
                                  nequip_energy_loss, nequip_force_loss)
from ..models.gnn import GNNConfig, GraphBatch, gnn_loss
from ..models.recsys import (AutoIntConfig, RecsysBatch,
                             abstract_autoint_params, autoint_forward,
                             autoint_loss, retrieval_score)
from ..models.transformer import (KVCache, LMConfig, abstract_kv_cache,
                                  abstract_lm_params, decode_step, lm_loss,
                                  params_from_numpy, prefill_step)
from ..optim.adamw import AdamWState, adamw_update, init_adamw
from ..optim.schedule import warmup_cosine
from ..parallel import sharding as shd
from ..tree import tree_leaves, tree_map, tree_unflatten
from .mesh import PartMesh, flat_axes, part_mesh_of


class Cell(NamedTuple):
    """Everything needed to run one (arch × shape) cell."""

    fn: Callable                 # step function
    abstract_inputs: Tuple       # meta-tensor trees matching fn's args
    model_flops: float           # analytic useful FLOPs of one call
    note: str = ""
    engine: Optional[Any] = None  # an Euler cell's Engine (and its mesh)
    #: over a mesh, the args' and results' NamedSharding trees (the
    #: reference's ``in_shardings``/``out_shardings``); None without one
    in_shardings: Any = None
    out_shardings: Any = None


def _lm_train_flops(cfg: LMConfig, cell: ShapeCell) -> float:
    return 6.0 * cfg.active_param_count() * cell.batch * cell.seq_len


def _value_and_grad(loss_fn: Callable, params, *args):
    """``loss_fn(params, *args)`` and its gradient with respect to every
    parameter (a tree shaped as ``params``), by autograd: the
    reference's ``jax.value_and_grad(loss_fn)``."""
    leaves = tree_leaves(params)
    with torch.enable_grad():
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss = loss_fn(params, *args)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
    return loss.detach(), tree_unflatten(params, grads)


def lm_value_and_grad(params, cfg: LMConfig, tokens: torch.Tensor,
                      labels: torch.Tensor, dp_axes=None, tp_axis=None,
                      mesh=None):
    """``lm_loss`` and its gradient with respect to every parameter (over
    ``mesh``: DTensors placed as the parameters)."""
    return _value_and_grad(lm_loss, params, cfg, tokens, labels, dp_axes,
                           tp_axis, mesh)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _tokens_meta(*shape) -> torch.Tensor:
    return _meta(shape, torch.int32)


def _dp(mesh):
    return shd.dp_axes_of(mesh) if mesh is not None else None


def _tp(mesh) -> Optional[str]:
    return "model" if mesh is not None and "model" in \
        mesh.mesh_dim_names else None


def _lm_kv_specs(cfg: LMConfig, mesh) -> KVCache:
    """Shard KV heads over tp when divisible, else the sequence dim."""
    dp = shd.dp_axes_of(mesh)
    tp_size = shd.mesh_sizes(mesh)["model"]
    if cfg.n_kv_heads % tp_size == 0:
        kspec = shd.P(None, dp, None, "model", None)
    else:
        kspec = shd.P(None, dp, "model", None, None)
    return KVCache(k=kspec, v=kspec, length=shd.P(dp))


def _local_meta(tree, specs, mesh):
    """This rank's ``meta`` tensors of a tree under its spec tree."""
    return tree_map(lambda t, s: _meta(shd.local_shape(t.shape, s, mesh),
                                       t.dtype), tree, specs)


def lm_state_shardings(state, mesh, fsdp: bool = True):
    """The shardings of an LM's ``params`` or ``(params, AdamWState)`` on
    ``mesh``: the reference's ``lm_param_shardings``, the moments as the
    params, the step replicated (``P()``).  A rule for
    ``checkpoint.elastic.elastic_restore``."""
    if isinstance(state, dict):
        return shd.lm_param_shardings(state, mesh, fsdp)
    params, opt = state
    ps = shd.lm_param_shardings(params, mesh, fsdp)
    return ps, AdamWState(step=shd.NamedSharding(mesh, shd.P()), m=ps, v=ps)


def place_lm_state(mesh, params, opt: Optional[AdamWState] = None,
                   fsdp: bool = True):
    """An LM's params (the port's tree of tensors, or the reference's
    tree of numpy arrays, which goes through ``params_from_numpy``) and
    optionally its AdamW state (``step``, ``m``, ``v``, either form) as
    DTensors on ``mesh`` by :func:`lm_state_shardings`.  Every rank
    passes the same whole arrays and keeps its own shards: both packages
    start from the same weights this way."""
    def port(tree):
        return tree if isinstance(tree["embed"], torch.Tensor) else \
            params_from_numpy(tree)

    params = port(params)
    if opt is None:
        return shd.distribute(params, lm_state_shardings(params, mesh, fsdp))
    step, m, v = opt
    step = step.detach().cpu() if isinstance(step, torch.Tensor) else \
        torch.as_tensor(np.asarray(step))
    opt = AdamWState(step=step.to(torch.int32), m=port(m), v=port(v))
    return shd.distribute((params, opt),
                          lm_state_shardings((params, opt), mesh, fsdp))


def _placed_cell(step, abstract, flops, mesh, in_specs, out_specs,
                 note: str = "") -> Cell:
    """A mesh cell whose step raises unless each result is placed as
    ``out_specs`` says."""
    out_shardings = shd.named(mesh, out_specs)

    def checked(*args):
        out = step(*args)
        for t, s in zip(tree_leaves(out), tree_leaves(out_shardings)):
            if t.device_mesh != s.mesh or tuple(t.placements) != \
                    tuple(s.placements):
                raise AssertionError(f"a result placed {t.placements}, "
                                     f"its out_shardings {s.placements}")
        return out

    return Cell(checked, abstract, flops, note=note,
                in_shardings=shd.named(mesh, in_specs),
                out_shardings=out_shardings)


def build_lm_cell(arch: ArchConfig, cell: ShapeCell, mesh=None) -> Cell:
    """The reference's ``build_lm_cell``: train, prefill or decode.  Over
    ``mesh`` (a ``DeviceMesh`` with a ``model`` axis) the step takes and
    returns DTensors placed by ``in_shardings``/``out_shardings`` (the
    reference's specs as placements; ``models/transformer.py``'s
    :class:`~repro_torch.models.transformer.MeshPlan`), and its abstract
    inputs are this rank's ``meta`` tensors.  A MoE LM over a mesh raises
    (ROADMAP queue 1 item 9c.4)."""
    cfg: LMConfig = arch.model
    if mesh is not None and cfg.moe is not None:
        raise NotImplementedError(
            f"{arch.arch_id}: a MoE LM over a mesh (moe_ffn with ep_axis, "
            f"moe_ffn_ep) waits for ROADMAP queue 1 item 9c.4")
    dp, tp = _dp(mesh), _tp(mesh)
    params_abs = abstract_lm_params(cfg)
    pspecs = shd.lm_param_specs(params_abs, mesh) if mesh else None

    def local(tree, specs):
        return tree if mesh is None else _local_meta(tree, specs, mesh)

    if cell.kind == "train":
        opt_abs = init_adamw(params_abs)
        batch_abs = {"tokens": _tokens_meta(cell.batch, cell.seq_len),
                     "labels": _tokens_meta(cell.batch, cell.seq_len)}

        def step(params, opt, batch):
            lr = warmup_cosine(opt.step, 3e-4, 2000, 100_000)
            loss, grads = lm_value_and_grad(params, cfg, batch["tokens"],
                                            batch["labels"], dp, tp, mesh)
            params, opt = adamw_update(params, grads, opt, lr)
            return params, opt, loss

        flops = _lm_train_flops(cfg, cell)
        if mesh is None:
            return Cell(step, (params_abs, opt_abs, batch_abs), flops)
        ospecs = AdamWState(step=shd.P(), m=pspecs, v=pspecs)
        bspecs = {"tokens": shd.P(dp, None), "labels": shd.P(dp, None)}
        return _placed_cell(step, (local(params_abs, pspecs),
                                   local(opt_abs, ospecs),
                                   local(batch_abs, bspecs)), flops, mesh,
                            (pspecs, ospecs, bspecs),
                            (pspecs, ospecs, shd.P()))

    if cell.kind == "prefill":
        tokens_abs = _tokens_meta(cell.batch, cell.seq_len)

        def step(params, tokens):
            return prefill_step(params, cfg, tokens, dp, tp, mesh)

        flops = 2.0 * cfg.active_param_count() * cell.batch * cell.seq_len
        if mesh is None:
            return Cell(step, (params_abs, tokens_abs), flops)
        kv = _lm_kv_specs(cfg, mesh)
        return _placed_cell(step, (local(params_abs, pspecs),
                                   local(tokens_abs, shd.P(dp, None))),
                            flops, mesh, (pspecs, shd.P(dp, None)),
                            (shd.P(dp, None), kv))

    if cell.kind == "decode":
        def step(params, cache, tokens):
            return decode_step(params, cfg, cache, tokens, dp, tp, mesh)

        cache_abs = abstract_kv_cache(cfg, cell.batch, cell.seq_len)
        tokens_abs = _tokens_meta(cell.batch)
        flops = 2.0 * cfg.active_param_count() * cell.batch
        note = "writes the cache in place"
        if mesh is None:
            return Cell(step, (params_abs, cache_abs, tokens_abs), flops,
                        note=note)
        kv = _lm_kv_specs(cfg, mesh)
        return _placed_cell(step, (local(params_abs, pspecs),
                                   local(cache_abs, kv),
                                   local(tokens_abs, shd.P(dp))), flops,
                            mesh, (pspecs, kv, shd.P(dp)),
                            (shd.P(dp, None), kv), note=note)

    raise ValueError(cell.kind)


# ---------------------------------------------------------------------------
# GNN cells (gcn / gat / pna)
# ---------------------------------------------------------------------------

def _pad512(x: int) -> int:
    """Round up to the reference's shardable size (512 = lcm of every
    mesh-axis layout); kept so the port's cells have its shapes."""
    return (x + 511) // 512 * 512


def _graph_abstract(cell: ShapeCell, d_in: int) -> GraphBatch:
    if cell.name == "minibatch_lg":
        acc, tot = 1, 1
        for f in cell.fanout:
            acc *= f
            tot += acc
        n = cell.batch_nodes * tot
        e = n  # one in-edge per sampled node
    elif cell.name == "molecule":
        n = cell.n_nodes * cell.batch
        e = cell.n_edges * cell.batch
    else:
        n = cell.n_nodes
        e = cell.n_edges
    n, e = _pad512(n), _pad512(e)
    return GraphBatch(
        node_feat=_meta((n, d_in), torch.float32),
        edge_src=_meta((e,), torch.int32),
        edge_dst=_meta((e,), torch.int32),
        edge_mask=_meta((e,), torch.bool),
        node_mask=_meta((n,), torch.bool),
        labels=_meta((n,), torch.int32),
    )


def _gnn_flops(cfg: GNNConfig, n: int, e: int) -> float:
    # per layer: edge messages (≈2 dirs) + node transform
    d = cfg.d_hidden
    per_edge = 2 * 2 * d * len(cfg.aggregators)
    per_node = 2 * cfg.d_in * d + 2 * d * d * (cfg.n_layers - 1)
    return float(cfg.n_layers * e * per_edge + n * per_node) * 3  # fwd+bwd


def gnn_value_and_grad(params, cfg: GNNConfig, g: GraphBatch):
    """``gnn_loss`` and its gradient with respect to every parameter."""
    return _value_and_grad(gnn_loss, params, cfg, g)


def build_gnn_cell(arch: ArchConfig, cell: ShapeCell) -> Cell:
    cfg: GNNConfig = arch.model
    if cell.d_feat and cfg.d_in != cell.d_feat:
        cfg = dataclasses.replace(cfg, d_in=cell.d_feat,
                                  n_classes=max(cell.n_classes, 2))
    g_abs = _graph_abstract(cell, cfg.d_in)
    # the params' shapes from one CPU init (a few hundred kB at most; the
    # reference traces its init with ``jax.eval_shape``)
    params_abs = tree_map(
        lambda p: torch.empty_like(p, device="meta"),
        gnn_mod.INITS[cfg.kind](torch.Generator().manual_seed(0), cfg))
    opt_abs = init_adamw(params_abs)

    def step(params, opt, g):
        lr = warmup_cosine(opt.step, 1e-3, 100, 10_000)
        loss, grads = gnn_value_and_grad(params, cfg, g)
        params, opt = adamw_update(params, grads, opt, lr)
        return params, opt, loss

    n, e = g_abs.node_feat.shape[0], g_abs.edge_src.shape[0]
    return Cell(step, (params_abs, opt_abs, g_abs), _gnn_flops(cfg, n, e))


# ---------------------------------------------------------------------------
# NequIP cells
# ---------------------------------------------------------------------------

def _atoms_abstract(cell: ShapeCell) -> Tuple[AtomsBatch, torch.Tensor,
                                              int, int]:
    """(the padded batch, the energy targets, padded edges, graphs) of a
    cell, sized as the reference sizes them."""
    if cell.name == "molecule":
        n = cell.n_nodes * cell.batch
        e = cell.n_edges * cell.batch
        ng = cell.batch
    elif cell.name == "minibatch_lg":
        acc, tot = 1, 1
        for f in cell.fanout:
            acc *= f
            tot += acc
        n = cell.batch_nodes * tot
        e = n
        ng = 1
    else:
        n, e, ng = cell.n_nodes, cell.n_edges, 1
    n, e = _pad512(n), _pad512(e)
    batch = AtomsBatch(
        species=_meta((n,), torch.int32),
        pos=_meta((n, 3), torch.float32),
        edge_src=_meta((e,), torch.int32),
        edge_dst=_meta((e,), torch.int32),
        edge_mask=_meta((e,), torch.bool),
        node_mask=_meta((n,), torch.bool),
        graph_id=_meta((n,), torch.int32),
    )
    return batch, _meta((ng,), torch.float32), e, ng


def _nequip_flops(cfg: NequIPConfig, e: int, use_forces: bool) -> float:
    C = cfg.channels
    return float(cfg.n_layers * e * (8 * C * 15 + 2 * cfg.n_rbf * 32
                                     + 2 * 32 * 8 * C)) * \
        (4 if use_forces else 3)


def build_nequip_cell(arch: ArchConfig, cell: ShapeCell) -> Cell:
    cfg: NequIPConfig = arch.model
    batch_abs, e_abs, e, ng = _atoms_abstract(cell)
    params_abs = abstract_nequip_params(cfg)
    use_forces = cell.name == "molecule"

    def step(params, opt, batch, targets):
        lr = warmup_cosine(opt.step, 5e-3, 100, 10_000)
        if use_forces:
            f_t = torch.zeros_like(batch.pos)
            loss, grads = _value_and_grad(
                lambda p: nequip_force_loss(p, cfg, batch, targets, f_t,
                                            n_graphs=ng), params)
        else:
            loss, grads = _value_and_grad(
                lambda p: nequip_energy_loss(p, cfg, batch, targets,
                                             n_graphs=ng), params)
        params, opt = adamw_update(params, grads, opt, lr)
        return params, opt, loss

    return Cell(step, (params_abs, init_adamw(params_abs), batch_abs, e_abs),
                _nequip_flops(cfg, e, use_forces),
                note="energies and forces" if use_forces else "energies")


# ---------------------------------------------------------------------------
# Recsys cells (autoint)
# ---------------------------------------------------------------------------

def _rec_abstract(cfg: AutoIntConfig, batch: int) -> RecsysBatch:
    return RecsysBatch(
        ids=_meta((batch, cfg.n_fields, cfg.max_bag), torch.int32),
        bag_mask=_meta((batch, cfg.n_fields, cfg.max_bag), torch.float32),
        labels=_meta((batch,), torch.float32),
    )


def _rec_flops(cfg: AutoIntConfig, batch: int, train: bool) -> float:
    F, d, H, D = cfg.n_fields, cfg.embed_dim, cfg.n_heads, cfg.d_attn
    attn = cfg.n_attn_layers * (3 * 2 * F * d * H * D + 2 * F * F * H * D * 2)
    dims = (F * H * D,) + tuple(cfg.mlp_dims)
    mlp = sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    return float(batch * (attn + mlp)) * (3 if train else 1)


def recsys_value_and_grad(params, cfg: AutoIntConfig, batch: RecsysBatch):
    """``autoint_loss`` and its gradient with respect to every parameter,
    the table's dense, as the reference's is."""
    return _value_and_grad(autoint_loss, params, cfg, batch)


def build_recsys_cell(arch: ArchConfig, cell: ShapeCell) -> Cell:
    cfg: AutoIntConfig = arch.model
    params_abs = abstract_autoint_params(cfg)
    batch_abs = _rec_abstract(cfg, cell.batch)

    if cell.kind == "train":
        def step(params, opt, batch):
            lr = warmup_cosine(opt.step, 1e-3, 1000, 300_000)
            loss, grads = recsys_value_and_grad(params, cfg, batch)
            params, opt = adamw_update(params, grads, opt, lr)
            return params, opt, loss

        return Cell(step, (params_abs, init_adamw(params_abs), batch_abs),
                    _rec_flops(cfg, cell.batch, True))

    if cell.kind == "serve":
        def step(params, batch):
            return autoint_forward(params, cfg, batch)

        return Cell(step, (params_abs, batch_abs),
                    _rec_flops(cfg, cell.batch, False))

    if cell.kind == "retrieval":
        cand_abs = _meta((cell.n_candidates, cfg.embed_dim), torch.float32)

        def step(params, batch, cand):
            return retrieval_score(params, cfg, batch, cand, top_k=100)

        flops = float(2 * cell.n_candidates * cfg.embed_dim * cell.batch)
        return Cell(step, (params_abs, batch_abs, cand_abs), flops)

    raise ValueError(cell.kind)


# ---------------------------------------------------------------------------
# Euler cells (the paper's own architecture)
# ---------------------------------------------------------------------------

def build_euler_cell(arch: ArchConfig, cell: ShapeCell, mesh) -> Cell:
    """The reference's ``build_euler_cell`` over ``mesh``: an
    :class:`Engine` over the mesh's :class:`PartMesh` with the config's
    caps and ``n_levels`` and the reference's defaults (replicated Phase
    3, the circuit gathered)."""
    ecfg = arch.model
    pm = mesh if isinstance(mesh, PartMesh) else part_mesh_of(mesh)
    axes = flat_axes(mesh)
    eng = Engine(pm.n_parts, ecfg.caps, ecfg.n_levels, mesh=pm)
    n, c = eng.n, ecfg.caps
    width = {"pk": c.park_cap, "op": c.open_cap, "tc": c.touch_cap,
             "le": c.edge_cap}
    specs = shd.euler_state_specs(mesh, axes)
    state_abs = EngineState(*(
        _meta(shd.local_shape((n, width[f[:2]]), spec, mesh),
              torch.bool if f.endswith("_mask") else torch.int32)
        for f, spec in zip(EngineState._fields, specs)))
    anc_abs = _meta(shd.local_shape((ecfg.n_levels, n), shd.P(None, None),
                                    mesh), torch.int32)

    # estimate useful work: sort + pairing + CC over the pool
    pool = 2 * c.new_cap + c.open_cap
    flops = float(n * pool * np.log2(max(2, pool)) * 8)

    if cell.name == "fused":
        # the whole run: the levels, the mate route and Phase 3, one
        # recorded graph on a card, one synchronization
        E = ecfg.fused_edges or n * c.edge_cap
        run = eng.fused_program(E)
        sv_abs = _meta(shd.local_shape((2 * E,), shd.P(None), mesh),
                       torch.int32)

        def fused(anc, state, sv):
            return run.launch(state, anc, sv).wait()[0]

        p3 = float(2 * E * np.log2(max(2, 2 * E)) * 6)  # splice + list-rank
        return Cell(fused, (anc_abs, state_abs, sv_abs),
                    flops * ecfg.n_levels + p3,
                    note="the full fused run: all levels + mate "
                         "accumulation + device Phase 3, one host sync",
                    engine=eng)

    def superstep(lvl, anc, state):
        return eng.superstep(int(lvl), anc, state)

    return Cell(superstep, (_meta((), torch.int32), anc_abs, state_abs),
                flops, note="one BSP superstep (ship + Phase 1) on the "
                            "mesh", engine=eng)


BUILDERS = {"lm": build_lm_cell, "gnn": build_gnn_cell,
            "nequip": build_nequip_cell, "recsys": build_recsys_cell}


class SkippedCell(Exception):
    pass


def build_cell(arch: ArchConfig, shape_name: str, mesh=None) -> Cell:
    cell = arch.shapes[shape_name]
    if cell.skip:
        raise SkippedCell(cell.skip)
    if arch.family == "euler":
        if mesh is None:
            raise ValueError(
                f"the {arch.arch_id} cells run over a mesh, as the "
                f"reference's: pass mesh= (launch/mesh.py: "
                f"make_production_mesh, make_test_mesh or make_part_mesh)")
        return build_euler_cell(arch, cell, mesh)
    if arch.family == "lm":
        return build_lm_cell(arch, cell, mesh)
    if mesh is not None:
        raise NotImplementedError(f"{arch.family} cells run on one device; "
                                  f"their mesh waits for ROADMAP queue 1 "
                                  f"item 9c.3")
    return BUILDERS[arch.family](arch, cell)
