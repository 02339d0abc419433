"""Per-architecture sharding rules: parameter/activation partition specs
(mirrors ``repro/parallel/sharding.py``; the rules are the reference's
data, entry for entry).

Conventions on the production mesh (``launch/mesh.py``):
  dp axes  = ("pod", "data") multi-pod, ("data",) single-pod   — batch/FSDP
  tp axis  = "model"                                            — TP/EP/rows

LM params: FSDP shards the d_model (first) dim over dp, TP shards the
ffn/head (second) dim over tp — the standard Megatron×ZeRO layout.  MoE
expert tensors shard experts over tp (expert parallelism).  Embedding and
lm_head shard the vocab dim over tp.  GNN/recsys/euler rules below.

A spec (:class:`PartitionSpec`) holds one entry per dimension, each
``None`` (replicated), an axis name or a tuple of axis names (sharded
over their product), as the reference's ``jax.sharding.PartitionSpec``
does; it is a leaf of the port's trees (``repro_torch.tree``).  The
functions take a ``torch.distributed.device_mesh.DeviceMesh`` and read
only its ``mesh_dim_names`` and sizes, as the reference reads
``mesh.axis_names`` and ``mesh.shape``.  :func:`local_shape` gives a
rank's share of a tensor under a spec: what the reference's
``in_shardings`` decide.

The port's LM layers are a list of per-layer dicts where the reference
stacks them on a leading axis: a layer tensor's spec here is the
reference's spec of the stacked tensor without its leading ``None``.

The counterpart of GSPMD's ``NamedSharding`` is a DTensor placement
list: :func:`placements` maps a spec onto a ``DeviceMesh``'s dimensions
(``Shard(d)`` on each mesh dimension that an entry of tensor dimension
``d`` names, ``Replicate()`` on the others), :class:`NamedSharding` holds
a mesh and its placements, :func:`named` (the reference's
``launch/steps.py::_named``) turns a spec tree into such shardings,
:func:`lm_param_shardings` is the reference's, and :func:`distribute`
places a tree of whole tensors by a tree of shardings.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..tree import leaves_with_paths, tree_map, tree_unflatten

Entry = Optional[Any]        # None | axis name | tuple of axis names


def _entry(e: Entry) -> Entry:
    """An entry as ``jax.sharding.PartitionSpec`` stores it: a sequence
    of one axis name is the name, an empty one ``None``."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else e[0] if len(e) == 1 else e
    return e


class PartitionSpec:
    """One entry per dimension: ``None``, an axis name, or a tuple of
    axis names (the reference's ``jax.sharding.PartitionSpec``)."""

    __slots__ = ("entries",)

    def __init__(self, *entries: Entry):
        self.entries: Tuple[Entry, ...] = tuple(_entry(e) for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            return self.entries == other.entries
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"P{self.entries!r}"


P = PartitionSpec


def _axes(entry: Entry) -> Tuple[str, ...]:
    return () if entry is None else \
        (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: PartitionSpec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: mesh dimension
    ``m`` gets ``Shard(d)`` where entry ``d`` names it, else
    ``Replicate()``.  An entry of several axes shards its dimension over
    them major first, as jax does, which DTensor does when their mesh
    dimensions come in the same order (the only order the specs use:
    ``dp_axes_of`` keeps the mesh's); another order raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        dims = [names.index(a) for a in _axes(entry)]
        if dims != sorted(dims):
            raise ValueError(f"{spec}: the axes {_axes(entry)} of dimension "
                             f"{d} are not in the mesh's order {names}")
        for m in dims:
            out[m] = Shard(d)
    return tuple(out)


class NamedSharding:
    """A mesh and the placements of one spec on it (the reference's
    ``jax.sharding.NamedSharding``); a leaf of the port's trees."""

    __slots__ = ("mesh", "spec", "placements")

    def __init__(self, mesh, spec: Optional[PartitionSpec],
                 placed: Optional[tuple] = None):
        self.mesh = mesh
        self.spec = spec
        self.placements = tuple(placed) if placed is not None else \
            placements(spec, mesh)

    @classmethod
    def of(cls, t) -> "NamedSharding":
        """A DTensor's own mesh and placements (no spec)."""
        return cls(t.device_mesh, None, t.placements)

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec!r}, {self.placements!r})"


def named(mesh, tree):
    """A spec tree → its tree of :class:`NamedSharding` leaves on ``mesh``
    (``None`` without a mesh), the reference's ``_named``."""
    if mesh is None:
        return None
    return tree_map(lambda s: NamedSharding(mesh, s), tree)


def mesh_device(mesh) -> torch.device:
    """This rank's device of ``mesh``: the current CUDA device on a card,
    else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def distribute(tree, shardings):
    """Each tensor of ``tree`` (the whole logical array, the same on every
    rank) as a DTensor placed by the matching :class:`NamedSharding`:
    each rank keeps a copy of its own shard (never a view of the
    caller's tensor), and nothing is sent."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(t, s):
        d = distribute_tensor(t.to(mesh_device(s.mesh)), s.mesh, s.placements,
                              src_data_rank=None)
        return DTensor.from_local(d.to_local().clone(), s.mesh, s.placements,
                                  run_check=False, shape=d.shape,
                                  stride=d.stride())

    return one(tree, shardings) if isinstance(shardings, NamedSharding) \
        else tree_map(one, tree, shardings)


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name → size (the reference's ``mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def dp_axes_of(mesh) -> Tuple[str, ...]:
    names = tuple(mesh.mesh_dim_names)
    return tuple(a for a in names if a != "model")


def local_shape(shape, spec: PartitionSpec, mesh) -> Tuple[int, ...]:
    """A rank's share of a tensor of ``shape`` under ``spec``: each
    sharded dimension divided by the product of its axes' sizes (which
    must divide it, as the reference's shardings require)."""
    sizes = mesh_sizes(mesh)
    if len(spec) > len(shape):
        raise ValueError(f"{spec} has more entries than {tuple(shape)} "
                         f"has dimensions")
    out = []
    for d, size in enumerate(shape):
        axes = _axes(spec[d] if d < len(spec) else None)
        ways = math.prod(sizes[a] for a in axes)
        if size % ways:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                             f"divide over {axes} ({ways} ways)")
        out.append(size // ways)
    return tuple(out)


# ---------------------------------------------------------------------------
# LM
# ---------------------------------------------------------------------------

def lm_param_specs(params: Any, mesh, fsdp: bool = True) -> Any:
    """PartitionSpec tree matching init_lm_params' structure."""
    dp = dp_axes_of(mesh)
    fs = dp if fsdp else None
    tp_size = mesh_sizes(mesh).get("model", 1)

    def spec_for(path: str, shape) -> PartitionSpec:
        nd = len(shape)
        if "embed" in path or "lm_head" in path:
            # [V, D] / [D, V]: shard the big (vocab) dim over tp
            big = 0 if shape[0] > shape[-1] else nd - 1
            s = [None] * nd
            s[big] = "model"
            other = 1 - big if nd == 2 else None
            if fsdp and other is not None:
                s[other] = fs
            return P(*s)
        if "router" in path:
            return P(fs, None)
        if any(k in path for k in ("w_gate", "w_up")) and nd == 3:
            # [E, D, F]: expert parallel when E divides tp, else TP on F
            if shape[0] % tp_size == 0:
                return P("model", fs, None)
            return P(None, fs, "model")
        if "w_down" in path and nd == 3:
            if shape[0] % tp_size == 0:
                return P("model", None, fs)   # [E, F, D]
            return P(None, "model", fs)
        if any(k in path for k in ("w_gate", "w_up", "wq", "wk", "wv",
                                   "shared_gate", "shared_up")):
            return P(fs, "model")             # [D, F]: TP cols
        if any(k in path for k in ("w_down", "wo", "shared_down")):
            return P("model", fs)             # [F, D]: TP rows
        if nd == 1:
            return P(None)                    # norms replicated
        return P(*([None] * nd))

    return tree_unflatten(params, [spec_for(path, tuple(leaf.shape))
                                   for path, leaf in leaves_with_paths(params)])


def lm_param_shardings(params, mesh, fsdp: bool = True):
    return named(mesh, lm_param_specs(params, mesh, fsdp))


def lm_batch_spec(mesh) -> PartitionSpec:
    return P(dp_axes_of(mesh), None)


def kv_cache_specs(mesh) -> Any:
    """KVCache [L, B, T, H, D]: batch over dp, heads over tp."""
    from ..models.transformer import KVCache

    dp = dp_axes_of(mesh)
    return KVCache(
        k=P(None, dp, None, "model", None),
        v=P(None, dp, None, "model", None),
        length=P(dp),
    )


# ---------------------------------------------------------------------------
# GNN / recsys / euler
# ---------------------------------------------------------------------------

def gnn_batch_spec(mesh, replicate_feats: bool = True):
    """Edges shard over dp; node features replicate by default.

    With dp-sharded node features, every x[src] gather from dp-sharded
    edge indices needs per-layer feature all-gathers; replicating the
    node table makes gathers local and turns the dst-aggregation into one
    all-reduce per layer.  Pass ``replicate_feats=False`` for the sharded
    baseline.
    """
    from ..models.gnn import GraphBatch

    dp = dp_axes_of(mesh)
    nspec = P(None, None) if replicate_feats else P(dp, None)
    n1 = P(None) if replicate_feats else P(dp)
    return GraphBatch(
        node_feat=nspec,
        edge_src=P(dp),
        edge_dst=P(dp),
        edge_mask=P(dp),
        node_mask=n1,
        labels=n1,
    )


def gnn_param_specs(params, mesh):
    return tree_map(lambda p: P(*([None] * p.dim())), params)


def recsys_param_specs(params, mesh):
    def one(path: str, leaf) -> PartitionSpec:
        if "table" in path:
            return P("model", None)           # rows over tp
        return P(*([None] * leaf.dim()))

    return tree_unflatten(params, [one(path, leaf) for path, leaf
                                   in leaves_with_paths(params)])


def recsys_batch_spec(mesh):
    from ..models.recsys import RecsysBatch

    dp = dp_axes_of(mesh)
    return RecsysBatch(ids=P(dp, None, None), bag_mask=P(dp, None, None),
                       labels=P(dp))


def euler_state_specs(mesh, axes):
    """Every Euler engine table shards its leading (partition) axis over
    *all* mesh axes — one partition per device."""
    from ..core.engine import EngineState

    return EngineState(*([P(axes, None)] * len(EngineState._fields)))
