"""NequIP-style E(3)-equivariant interatomic potential, l_max = 2 (mirrors
``repro/models/equivariant.py``).

Cartesian-tensor form of the irrep tensor product: each atom carries
scalars ``s [N, C]``, vectors ``v [N, C, 3]`` and traceless symmetric
rank-2 tensors ``t [N, C, 3, 3]``.  A message combines the neighbour's
features with the edge direction's parts (1, r̂, r̂r̂ᵀ − I/3) through the
eight E(3) product paths, each gated by an MLP over the radial Bessel
basis; messages are summed into their destination by ``index_add``, as
the reference's ``jax.ops.segment_sum``.

The arithmetic is the reference's, term for term: the eight paths with
its ``einsum`` contractions in its order of accumulation, the clipped
species and edge ids, ``jnp.maximum``/``jnp.clip`` as ``torch.maximum``/
``torch.minimum`` against tensors (half the gradient at a tie, where
``torch.clamp`` passes all of it), ``x ** k`` by ``lax.integer_pow``'s
repeated squaring, divisions by a tensor (the card multiplies by the
reciprocal of a Python number), masked messages through ``torch.where``,
``s`` masked after each layer and ``v``, ``t`` not.  The energy readout
drops atoms whose ``graph_id`` lies outside ``[0, n_graphs)``, as
``segment_sum`` does (``index_add`` would raise on the CPU and assert on
the card).

``nequip_force_loss`` takes the forces as −∂E/∂pos with
``torch.autograd.grad(..., create_graph=True)`` inside the loss, so a
train step differentiates a gradient.  One forward serves the energies
and the forces (the reference runs two, with the same values).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from ..tree import tree_map
from .gnn import _segment_sum
from .layers import dense_init
from .moe import _silu

Params = Dict[str, Any]

#: message paths: s·s→s, s·v→v, v·v→s, v·v→t, v·s(r̂)→v, t·v→v, t·t→s, s·t→t
N_PATHS = 8
#: the radial MLP's hidden width
RADIAL_HIDDEN = 32


class AtomsBatch(NamedTuple):
    species: torch.Tensor    # [N] int32 atom types
    pos: torch.Tensor        # [N, 3]
    edge_src: torch.Tensor   # [E] int32
    edge_dst: torch.Tensor   # [E] int32
    edge_mask: torch.Tensor  # [E] bool
    node_mask: torch.Tensor  # [N] bool
    graph_id: torch.Tensor   # [N] int32 molecule id (batched small graphs)


@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    name: str
    n_layers: int = 5
    channels: int = 32
    l_max: int = 2           # fixed = 2 in this implementation
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 8
    dtype: Any = torch.float32


def _ipow(x: torch.Tensor, k: int) -> torch.Tensor:
    """``x ** k`` for an integer ``k > 0`` as ``lax.integer_pow`` computes
    it: by repeated squaring, the odd powers multiplied in from the
    lowest."""
    acc = None
    while k > 0:
        if k & 1:
            acc = x if acc is None else acc * x
        k >>= 1
        if k > 0:
            x = x * x
    return acc


def bessel_rbf(r: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """Radial Bessel basis with the p = 6 polynomial envelope (NequIP eq.
    6): ``[E] → [E, n_rbf]``."""
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=r.device)
    c = r.new_tensor(cutoff)
    rr = torch.maximum(r, r.new_tensor(1e-9))[:, None]
    basis = r.new_tensor(2.0 / cutoff).sqrt() * \
        torch.sin(n * math.pi * rr / c) / rr
    x = torch.minimum(torch.maximum(r / c, r.new_tensor(0.0)),
                      r.new_tensor(1.0))[:, None]
    env = 1 - 28 * _ipow(x, 6) + 48 * _ipow(x, 7) - 21 * _ipow(x, 8)
    return basis * env


def init_nequip_params(generator: torch.Generator, cfg: NequIPConfig,
                       device=None) -> Params:
    """Seeded weights: the species embedding a normal × 0.5, every matrix
    ``dense_init``'s, each drawn once from ``generator`` in the
    reference's order of keys (embed, readout, then each layer's
    radial1, radial2, self_s, mix_s), on ``device`` (default: the
    generator's)."""
    C = cfg.channels
    device = device or generator.device
    embed = (torch.randn(cfg.n_species, C, generator=generator,
                         device=generator.device, dtype=torch.float32) * 0.5
             ).to(device=device, dtype=cfg.dtype)
    readout = dense_init(generator, C, 1, cfg.dtype, device=device)
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "radial1": dense_init(generator, cfg.n_rbf, RADIAL_HIDDEN,
                                  cfg.dtype, device=device),
            "radial2": dense_init(generator, RADIAL_HIDDEN, N_PATHS * C,
                                  cfg.dtype, device=device),
            "self_s": dense_init(generator, C, C, cfg.dtype, device=device),
            "mix_s": dense_init(generator, C, C, cfg.dtype, device=device),
        })
    return {"embed": embed, "layers": layers, "readout": readout}


def abstract_nequip_params(cfg: NequIPConfig) -> Params:
    """The params' shapes and dtypes as ``meta`` tensors."""
    def meta(*shape):
        return torch.empty(shape, dtype=cfg.dtype, device="meta")

    C = cfg.channels
    return {"embed": meta(cfg.n_species, C),
            "layers": [{"radial1": meta(cfg.n_rbf, RADIAL_HIDDEN),
                        "radial2": meta(RADIAL_HIDDEN, N_PATHS * C),
                        "self_s": meta(C, C), "mix_s": meta(C, C)}
                       for _ in range(cfg.n_layers)],
            "readout": meta(C, 1)}


def _traceless(t: torch.Tensor) -> torch.Tensor:
    """The traceless symmetric part of ``[..., 3, 3]``."""
    tr = torch.diagonal(t, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    eye = torch.eye(3, dtype=t.dtype, device=t.device)
    return 0.5 * (t + t.transpose(-1, -2)) - tr / t.new_tensor(3.0) * eye


def _seg(x: torch.Tensor, msk: torch.Tensor, dst: torch.Tensor,
         num_segments: int) -> torch.Tensor:
    """The masked messages ``x [E, ...]`` summed into ``[num_segments,
    ...]`` by ``dst``."""
    x = torch.where(msk.reshape((-1,) + (1,) * (x.dim() - 1)), x, 0.0)
    return _segment_sum(x, dst, num_segments)


def _readout_sum(e_atom: torch.Tensor, graph_id: torch.Tensor,
                 n_graphs: int) -> torch.Tensor:
    """``segment_sum(e_atom, graph_id, n_graphs)``: atoms whose id lies
    outside ``[0, n_graphs)`` go to a sink row that is sliced off."""
    ids = torch.where((graph_id >= 0) & (graph_id < n_graphs), graph_id,
                      n_graphs)
    return _segment_sum(e_atom, ids, n_graphs + 1)[:n_graphs]


def nequip_forward(params: Params, cfg: NequIPConfig, batch: AtomsBatch,
                   n_graphs: int = 1) -> torch.Tensor:
    """Per-graph energies ``[n_graphs]``."""
    N = batch.species.shape[0]
    C = cfg.channels
    species = torch.clamp(batch.species, 0, cfg.n_species - 1)
    s = torch.index_select(params["embed"], 0, species)
    s = s * batch.node_mask[:, None]
    v = s.new_zeros((N, C, 3))
    t = s.new_zeros((N, C, 3, 3))

    src = torch.clamp(batch.edge_src, 0, N - 1)
    dst = torch.clamp(batch.edge_dst, 0, N - 1)
    msk = batch.edge_mask
    pos = batch.pos
    disp = torch.index_select(pos, 0, src) - torch.index_select(pos, 0, dst)
    d = disp + 1e-12
    r = torch.sqrt(torch.sum(d * d, dim=-1))
    rhat = disp / torch.maximum(r, r.new_tensor(1e-9))[:, None]
    rbf = bessel_rbf(r, cfg.n_rbf, cfg.cutoff) * msk[:, None]
    rr = _traceless(rhat[:, :, None] * rhat[:, None, :])   # l=2 part of r̂

    for lp in params["layers"]:
        w = _silu(rbf @ lp["radial1"]) @ lp["radial2"]        # [E, 8C]
        w = w.reshape(-1, N_PATHS, C)
        ss, sv_, vv_s, vv_t, svr, tv, tt, st = w.unbind(1)
        s_j = torch.index_select(s, 0, src)
        v_j = torch.index_select(v, 0, src)
        t_j = torch.index_select(t, 0, src)

        # message paths (Cartesian CG products, l ≤ 2)
        m_s = ss * s_j                                              # s⊗Y0→s
        m_s = m_s + vv_s * torch.einsum("eci,ei->ec", v_j, rhat)    # v⊗Y1→s
        m_s = m_s + tt * torch.einsum("ecij,eij->ec", t_j, rr)      # t⊗Y2→s
        m_v = sv_[:, :, None] * (s_j[:, :, None] * rhat[:, None, :])  # s⊗Y1→v
        m_v = m_v + svr[:, :, None] * v_j                           # v⊗Y0→v
        m_v = m_v + tv[:, :, None] * torch.einsum("ecij,ej->eci", t_j,
                                                  rhat)             # t⊗Y1→v
        m_t = vv_t[:, :, None, None] * _traceless(
            v_j[:, :, :, None] * rhat[:, None, None, :])            # v⊗Y1→t
        m_t = m_t + st[:, :, None, None] * (
            s_j[:, :, None, None] * rr[:, None])                    # s⊗Y2→t

        s = _silu(s @ lp["self_s"] + _seg(m_s, msk, dst, N) @ lp["mix_s"])
        v = v + _seg(m_v, msk, dst, N)
        t = t + _seg(m_t, msk, dst, N)
        s = s * batch.node_mask[:, None]

    e_atom = (s @ params["readout"])[:, 0] * batch.node_mask
    return _readout_sum(e_atom, batch.graph_id, n_graphs)


def nequip_energy_loss(params: Params, cfg: NequIPConfig, batch: AtomsBatch,
                       targets: torch.Tensor,
                       n_graphs: int = 1) -> torch.Tensor:
    e = nequip_forward(params, cfg, batch, n_graphs)
    return torch.mean((e - targets) ** 2)


def energies_and_forces(params: Params, cfg: NequIPConfig,
                        batch: AtomsBatch, n_graphs: int = 1,
                        create_graph: bool = True):
    """(per-graph energies, forces −∂ΣE/∂pos ``[N, 3]``) from one forward;
    ``create_graph`` keeps the forces differentiable (a loss on them then
    takes a second-order gradient)."""
    with torch.enable_grad():
        pos = batch.pos.detach().requires_grad_(True)
        e = nequip_forward(params, cfg, batch._replace(pos=pos), n_graphs)
        (grad,) = torch.autograd.grad(torch.sum(e), pos,
                                      create_graph=create_graph)
    return e, -grad


def nequip_force_loss(params: Params, cfg: NequIPConfig, batch: AtomsBatch,
                      e_targets: torch.Tensor, f_targets: torch.Tensor,
                      w_f: float = 1.0, n_graphs: int = 1) -> torch.Tensor:
    """Energy + force matching (forces = −∇_pos E), the NequIP objective."""
    e, forces = energies_and_forces(params, cfg, batch, n_graphs)
    le = torch.mean((e - e_targets) ** 2)
    mask = batch.node_mask
    n_dof = (torch.sum(mask) * 3).to(forces.dtype)
    lf = torch.sum(((forces - f_targets) ** 2) * mask[:, None]) / \
        torch.maximum(n_dof, n_dof.new_tensor(1.0))
    return le + w_f * lf


def params_from_numpy(tree) -> Params:
    """The reference's param tree of numpy arrays (``{"embed", "layers":
    [{"radial1", "radial2", "self_s", "mix_s"}], "readout"}``) → the same
    tree of CPU tensors."""
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def params_to_numpy(params: Params):
    """This module's params (or a tree of their gradients) → the
    reference's tree of numpy arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)
