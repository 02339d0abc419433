"""GNN stacks: GCN, GAT, PNA — segment-op message passing (mirrors
``repro/models/gnn.py``).

Aggregation is a scatter over an edge index (src → dst), as in the
reference's ``jax.ops.segment_sum``/``segment_max``: ``index_add`` for
sums, ``scatter_reduce("amax")`` for maxima.  Graphs are padded:
``edge_src/edge_dst [E]`` with ``edge_mask``; masked edges point at a
sink row (node N) that is sliced off after aggregation.

The tie rules are the reference's: a segment maximum is reduced into a
``-inf`` buffer with ``include_self=False``, so an empty segment reads
``-inf`` (then 0) and tied maxima share their gradient evenly, as
``segment_max``'s do (a zero buffer taken into the reduction would give
each of two tied ReLU zeros a third); floors are ``torch.maximum``
against a tensor, which passes half the gradient at a tie as
``jnp.maximum`` does (``torch.clamp`` passes all of it).  Ids are int32
and widened to int64 only for ``scatter_reduce``.  On the card the float
scatters use atomics, so results are allclose to the CPU's, not bit-equal.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..tree import tree_map
from .layers import dense_init

Params = Dict[str, Any]


class GraphBatch(NamedTuple):
    node_feat: torch.Tensor   # [N, F]
    edge_src: torch.Tensor    # [E] int32
    edge_dst: torch.Tensor    # [E] int32
    edge_mask: torch.Tensor   # [E] bool
    node_mask: torch.Tensor   # [N] bool
    labels: torch.Tensor      # [N] int32 labels (node classification)


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: str                 # gcn | gat | pna
    n_layers: int
    d_in: int
    d_hidden: int
    n_classes: int
    n_heads: int = 1
    aggregators: Tuple[str, ...] = ("mean",)
    scalers: Tuple[str, ...] = ("identity",)
    avg_degree: float = 4.0
    dtype: Any = torch.float32


def _floor(x: torch.Tensor, value: float) -> torch.Tensor:
    """``jnp.maximum(x, value)``, half the gradient at a tie."""
    return torch.maximum(x, x.new_tensor(value))


def _segment_sum(data: torch.Tensor, seg_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add(0, seg_ids, data)


def _segment_max(data: torch.Tensor, seg_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Per-segment maximum; ``-inf`` for an empty segment."""
    idx = seg_ids.long().view((-1,) + (1,) * (data.dim() - 1))
    out = data.new_full((num_segments,) + tuple(data.shape[1:]),
                        float("-inf"))
    return out.scatter_reduce(0, idx.expand_as(data), data, "amax",
                              include_self=False)


def _seg(agg: str, data, seg_ids, num_segments):
    if agg == "sum":
        return _segment_sum(data, seg_ids, num_segments)
    if agg == "mean":
        s = _segment_sum(data, seg_ids, num_segments)
        c = _segment_sum(torch.ones_like(data[:, :1]), seg_ids, num_segments)
        return s / _floor(c, 1.0)
    if agg == "max":
        m = _segment_max(data, seg_ids, num_segments)
        return torch.where(torch.isfinite(m), m, 0.0)  # empty segment → 0
    if agg == "min":
        m = -_segment_max(-data, seg_ids, num_segments)
        return torch.where(torch.isfinite(m), m, 0.0)
    if agg == "std":
        s = _segment_sum(data, seg_ids, num_segments)
        s2 = _segment_sum(data * data, seg_ids, num_segments)
        c = _floor(_segment_sum(torch.ones_like(data[:, :1]), seg_ids,
                                num_segments), 1.0)
        var = _floor(s2 / c - (s / c) ** 2, 0.0)
        return torch.sqrt(var + 1e-5)
    raise ValueError(agg)


# ---------------------------------------------------------------------------
# GCN  (Kipf & Welling) — symmetric-normalized SpMM
# ---------------------------------------------------------------------------

def init_gcn_params(generator: torch.Generator, cfg: GNNConfig) -> Params:
    dims = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    return {"w": [dense_init(generator, dims[i], dims[i + 1], cfg.dtype)
                  for i in range(cfg.n_layers)]}


def gcn_forward(params, cfg: GNNConfig, g: GraphBatch) -> torch.Tensor:
    N = g.node_feat.shape[0]
    sink = N
    src = torch.where(g.edge_mask, g.edge_src, sink)
    dst = torch.where(g.edge_mask, g.edge_dst, sink)
    # symmetric degree normalization over *both* edge directions
    ones = g.edge_mask.to(cfg.dtype)
    deg = _segment_sum(torch.cat([ones, ones]), torch.cat([dst, src]),
                       N + 1)[:N] + 1.0                    # + self loop
    dinv = torch.rsqrt(deg)
    x = g.node_feat.to(cfg.dtype)
    msg_src = torch.cat([src, dst])
    msg_dst = torch.cat([dst, src])
    s = torch.clamp(msg_src, 0, N - 1)
    real = (msg_src < N)[:, None]
    for i, w in enumerate(params["w"]):
        h = x @ w
        m = torch.where(real, h[s] * dinv[s][:, None], 0.0)
        agg = _segment_sum(m, msg_dst, N + 1)[:N]
        x = (agg + h * dinv[:, None]) * dinv[:, None]
        if i < len(params["w"]) - 1:
            x = torch.relu(x)
    return x


# ---------------------------------------------------------------------------
# GAT  (Velickovic et al.) — SDDMM edge scores → segment softmax → SpMM
# ---------------------------------------------------------------------------

def init_gat_params(generator: torch.Generator, cfg: GNNConfig) -> Params:
    H, D = cfg.n_heads, cfg.d_hidden
    layers = []
    d_in = cfg.d_in
    for i in range(cfg.n_layers):
        d_out = cfg.n_classes if i == cfg.n_layers - 1 else D
        h = 1 if i == cfg.n_layers - 1 else H
        w = dense_init(generator, d_in, h * d_out, cfg.dtype)
        a_src = dense_init(generator, h, d_out, cfg.dtype).T.contiguous()
        a_dst = dense_init(generator, h, d_out, cfg.dtype).T.contiguous()
        layers.append({"w": w, "a_src": a_src, "a_dst": a_dst})
        d_in = h * d_out
    return {"layers": layers}


def _leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    """``jax.nn.leaky_relu``: slope 1 at 0 (torch's takes ``slope``)."""
    return torch.where(x >= 0, x, slope * x)


def gat_forward(params, cfg: GNNConfig, g: GraphBatch) -> torch.Tensor:
    N = g.node_feat.shape[0]
    x = g.node_feat.to(cfg.dtype)
    # bidirectional + self loops
    loops = torch.arange(N, dtype=g.edge_src.dtype, device=x.device)
    src = torch.cat([g.edge_src, g.edge_dst, loops])
    dst = torch.cat([g.edge_dst, g.edge_src, loops])
    msk = torch.cat([g.edge_mask, g.edge_mask, g.node_mask])[:, None]
    s = torch.clamp(src, 0, N - 1)
    d = torch.clamp(dst, 0, N - 1)
    for li, lp in enumerate(params["layers"]):
        d_out = lp["a_src"].shape[0]
        xw = x @ lp["w"]
        feat = xw.reshape(N, xw.shape[-1] // d_out, d_out)  # [N, H, D]
        alpha_src = torch.einsum("nhd,dh->nh", feat, lp["a_src"])
        alpha_dst = torch.einsum("nhd,dh->nh", feat, lp["a_dst"])
        e = _leaky_relu(alpha_src[s] + alpha_dst[d], 0.2)   # [E, H]
        e = torch.where(msk, e, -1e30)
        # segment softmax over incoming edges of each dst (each has its
        # self loop, so no segment is empty)
        emax = _segment_max(e, d, N)
        ee = torch.exp(e - emax[d]) * msk
        esum = _segment_sum(ee, d, N)
        w = ee / _floor(esum[d], 1e-9)
        m = feat[s] * w[:, :, None]
        agg = _segment_sum(torch.where(msk[:, :, None], m, 0.0), d, N)
        x = agg.reshape(N, -1)
        if li < len(params["layers"]) - 1:
            x = F.elu(x)
    return x


# ---------------------------------------------------------------------------
# PNA  (Corso et al.) — multi-aggregator × degree scalers
# ---------------------------------------------------------------------------

def init_pna_params(generator: torch.Generator, cfg: GNNConfig) -> Params:
    n_agg = len(cfg.aggregators) * len(cfg.scalers)
    layers = []
    d_in = cfg.d_in
    for _ in range(cfg.n_layers):
        w_pre = dense_init(generator, 2 * d_in, cfg.d_hidden, cfg.dtype)
        w_post = dense_init(generator, n_agg * cfg.d_hidden, cfg.d_hidden,
                            cfg.dtype)
        layers.append({"w_pre": w_pre, "w_post": w_post})
        d_in = cfg.d_hidden
    return {"layers": layers,
            "readout": dense_init(generator, cfg.d_hidden, cfg.n_classes,
                                  cfg.dtype)}


def pna_forward(params, cfg: GNNConfig, g: GraphBatch) -> torch.Tensor:
    N = g.node_feat.shape[0]
    x = g.node_feat.to(cfg.dtype)
    src = torch.cat([g.edge_src, g.edge_dst])
    dst = torch.cat([g.edge_dst, g.edge_src])
    msk = torch.cat([g.edge_mask, g.edge_mask])
    s = torch.clamp(src, 0, N - 1)
    d = torch.clamp(dst, 0, N - 1)
    deg = _segment_sum(msk.to(cfg.dtype), d, N)
    log_deg = torch.log(deg + 1.0)[:, None]
    delta = torch.mean(torch.where(g.node_mask, log_deg[:, 0], 0.0)) * N / \
        torch.clamp(g.node_mask.sum(), min=1) + 1e-5
    for lp in params["layers"]:
        msg_in = torch.cat([x[s], x[d]], dim=-1)
        m = torch.relu(msg_in @ lp["w_pre"])
        m = torch.where(msk[:, None], m, 0.0)
        aggs = []
        for agg in cfg.aggregators:
            a = _seg(agg, m, d, N)
            for scaler in cfg.scalers:
                if scaler == "identity":
                    aggs.append(a)
                elif scaler == "amplification":
                    aggs.append(a * (log_deg / delta))
                elif scaler == "attenuation":
                    aggs.append(a * (delta / _floor(log_deg, 1e-5)))
        h = torch.cat(aggs, dim=-1) @ lp["w_post"]
        x = torch.relu(h) + (x if x.shape == h.shape else 0)
    return x @ params["readout"]


FORWARDS = {"gcn": gcn_forward, "gat": gat_forward, "pna": pna_forward}
INITS = {"gcn": init_gcn_params, "gat": init_gat_params,
         "pna": init_pna_params}


def gnn_loss(params, cfg: GNNConfig, g: GraphBatch) -> torch.Tensor:
    logits = FORWARDS[cfg.kind](params, cfg, g).to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(
        logits, -1,
        torch.clamp(g.labels, 0, logits.shape[-1] - 1).long()[:, None])[:, 0]
    mask = g.node_mask.to(torch.float32)
    per = (logz - gold) * mask
    return torch.sum(per) / _floor(torch.sum(mask), 1.0)


def params_from_numpy(tree) -> Params:
    """The reference's param tree of numpy arrays (GCN ``{"w": [...]}``,
    GAT ``{"layers": [{"w", "a_src", "a_dst"}]}``, PNA ``{"layers":
    [{"w_pre", "w_post"}], "readout"}``) → the same tree of CPU tensors."""
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def params_to_numpy(params: Params):
    """This module's params (or a tree of their gradients) → the
    reference's tree of numpy arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)
