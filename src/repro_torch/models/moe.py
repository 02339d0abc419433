"""Mixture-of-Experts FFN: top-k routing with sort-based capacity dispatch
(mirrors ``repro/models/moe.py``: ``MoEConfig``, ``init_moe_params``,
``moe_ffn``, ``moe_ffn_reference``).

Static shapes, as in the reference: tokens are split into G groups and
routed within each; a group's (token, k) pairs are sorted by expert,
ranked within their expert and dropped beyond the capacity C, scattered
into a ``[G, E·C + 1, D]`` buffer (row E·C is the trash row of the
dropped pairs), multiplied expert by expert and combined back with the
router's weights.  Nothing reads a value on the host, so the FFN records
into a CUDA graph.  The combine adds each token's K rows in ascending
expert order, the order in which the reference's sorted scatter-add
applies them, with no atomics: a replay gives the eager loop's bits.

The products run in the promoted type of their operands, as JAX
promotes them: the reference's ``init_moe_params`` divides bf16 expert
weights by a numpy float64 scalar, which makes them f32, and the
reference's weights handed over in a bf16 model keep that.  The port
draws its own expert weights in the model's dtype, as the configs'
sizes assume (Qwen1.5-MoE-A2.7B: 28.6 GB in bf16).

One device: the reference's ``ep_axis``/``dp_axes`` sharding
constraints and ``moe_ffn_ep`` (a ``shard_map`` over a mesh) wait for
ROADMAP queue 1 item 9c.4.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from .layers import dense_init

Params = Dict[str, torch.Tensor]


class MoEConfig(NamedTuple):
    n_experts: int
    top_k: int
    d_expert: int          # per-expert FFN hidden dim
    n_shared: int = 0      # always-on shared experts
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    use_ep: bool = True    # expert parallelism (the reference's mesh knob)


def moe_shapes(d_model: int, cfg: MoEConfig) -> Dict[str, tuple]:
    """The MoE weights' shapes, in the order ``init_moe_params`` draws
    them: the router [D, E], the experts' ``w_gate``/``w_up`` [E, D, F]
    and ``w_down`` [E, F, D], then the shared experts' three matrices,
    F·n_shared wide, when ``n_shared``."""
    E, F, D = cfg.n_experts, cfg.d_expert, d_model
    shapes = {"router": (D, E), "w_gate": (E, D, F), "w_up": (E, D, F),
              "w_down": (E, F, D)}
    if cfg.n_shared:
        Fs = F * cfg.n_shared
        shapes.update(shared_gate=(D, Fs), shared_up=(D, Fs),
                      shared_down=(Fs, D))
    return shapes


def init_moe_params(generator: torch.Generator, d_model: int, cfg: MoEConfig,
                    dtype: torch.dtype = torch.float32,
                    device: Optional[torch.device] = None) -> Params:
    """Seeded MoE weights, drawn in f32 on the generator's device in
    ``moe_shapes``' order, then cast to ``dtype`` (the router stays f32)
    and moved to ``device`` (default: the generator's).  Each expert
    matrix is normal / √fan-in, as ``dense_init``."""
    device = device or generator.device
    p = {}
    for name, shape in moe_shapes(d_model, cfg).items():
        if name == "router":
            p[name] = dense_init(generator, *shape, torch.float32,
                                 device=device)
        elif len(shape) == 2:
            p[name] = dense_init(generator, *shape, dtype, device=device)
        else:
            w = torch.randn(shape, generator=generator,
                            device=generator.device, dtype=torch.float32)
            p[name] = (w / math.sqrt(shape[1])).to(device=device,
                                                   dtype=dtype)
    return p


def abstract_moe_params(d_model: int, cfg: MoEConfig,
                        dtype: torch.dtype) -> Params:
    """The MoE weights' shapes and dtypes as ``meta`` tensors."""
    return {name: torch.empty(shape, device="meta", dtype=torch.float32
                              if name == "router" else dtype)
            for name, shape in moe_shapes(d_model, cfg).items()}


def _silu(x: torch.Tensor) -> torch.Tensor:
    # x · sigmoid(x), as the reference's jax.nn.silu: in bf16 each of the
    # two ops rounds, where F.silu would round once
    return x * torch.sigmoid(x)


def top_k(probs: torch.Tensor, k: int):
    """The ``k`` largest values along the last axis and their indices,
    ties broken toward the lower index, as ``jax.lax.top_k`` breaks them
    (``torch.topk`` does not): a stable descending sort, sliced."""
    idx = torch.argsort(probs, dim=-1, descending=True, stable=True)[..., :k]
    return torch.gather(probs, -1, idx), idx


def group_capacity(T: int, cfg: MoEConfig, capacity: Optional[int] = None,
                   group_tokens: int = 2048) -> Tuple[int, int, int]:
    """(G, Tg, C): the dispatch groups, the tokens a group and the
    capacity of an expert in a group, from Python numbers in the
    reference's order of operations (another order can move C by one)."""
    G = max(1, T // group_tokens)
    while T % G:
        G -= 1
    Tg = T // G
    C = capacity or max(1, int(math.ceil(
        Tg * cfg.top_k / cfg.n_experts * cfg.capacity_factor)))
    return G, Tg, C


def route(router: torch.Tensor, xg: torch.Tensor, cfg: MoEConfig):
    """Router over groups xg [G, Tg, D] in f32: (probs [G, Tg, E], the
    top-k gates renormalised to sum 1 [G, Tg, K], their experts
    [G, Tg, K], the Switch aux loss)."""
    E = cfg.n_experts
    probs = torch.softmax(xg.to(torch.float32) @ router, dim=-1)
    gate_vals, expert_idx = top_k(probs, cfg.top_k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    # aux load-balancing loss (Switch): E · Σ_e f_e · p_e, where f_e is
    # the share of first choices (a one-hot by comparison: F.one_hot
    # reads the indices' range on the host)
    me = probs.mean(dim=(0, 1))
    first = expert_idx[..., :1] == torch.arange(E, device=xg.device)
    ce = first.to(torch.float32).mean(dim=(0, 1))
    aux = cfg.aux_loss_coef * E * torch.sum(me * ce)
    return probs, gate_vals, expert_idx, aux


def dispatch(expert_idx: torch.Tensor, C: int, E: int):
    """Each group's (token, k) pairs [G, Tg·K], sorted by expert (stable:
    by token within an expert), each ranked among its expert's pairs:
    (the sort order, the sorted pairs' tokens, ``keep`` = rank < C, and
    their buffer slots e·C + rank, E·C when dropped)."""
    G, Tg, K = expert_idx.shape
    n = Tg * K
    flat_e = expert_idx.reshape(G, n)
    order = torch.argsort(flat_e, dim=1, stable=True)
    se = torch.gather(flat_e, 1, order)
    st = order // K                         # flat_t = repeat(arange(Tg), K)
    idx = torch.arange(n, device=expert_idx.device).expand(G, n)
    newseg = torch.ones_like(se, dtype=torch.bool)
    newseg[:, 1:] = se[:, 1:] != se[:, :-1]
    seg_start = torch.cummax(torch.where(newseg, idx, 0), dim=1).values
    pos = idx - seg_start
    keep = pos < C
    slot = torch.where(keep, se * C + pos, E * C)
    return order, st, keep, slot


def _promoted(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, w.dtype))


def experts(params: Params, buf: torch.Tensor) -> torch.Tensor:
    """The routed experts' SwiGLU over buf [G, E, C, D] → [G, E, C, D], in
    the promoted type of buf and the weights."""
    buf = _promoted(buf, params["w_gate"])
    h = _silu(torch.einsum("gecd,edf->gecf", buf, params["w_gate"])) * \
        torch.einsum("gecd,edf->gecf", buf, params["w_up"])
    return torch.einsum("gecf,efd->gecd", h, params["w_down"])


def combine(y_flat: torch.Tensor, order: torch.Tensor, keep: torch.Tensor,
            slot: torch.Tensor, gate_vals: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """Each token's K expert rows of y_flat [G, E·C, D], weighted by their
    gates cast to ``dtype`` (the tokens'; 0 where dropped), cast to
    ``dtype`` and added in ascending expert order in ``dtype`` →
    [G, Tg, D].  No scatter-add: the sort is inverted so that each
    (token, k) finds its row."""
    G, Tg, K = gate_vals.shape
    n, D = Tg * K, y_flat.shape[-1]
    idx = torch.arange(n, device=order.device).expand(G, n)
    inv = torch.empty_like(order).scatter_(1, order, idx)
    # a token's K pairs in sorted position: the order of their experts
    at = inv.reshape(G, Tg, K).sort(dim=-1).values.reshape(G, n)
    s = torch.gather(slot, 1, at).clamp(max=y_flat.shape[1] - 1)
    rows = torch.gather(y_flat, 1, s[..., None].expand(G, n, D))
    gates = torch.gather(gate_vals.reshape(G, n), 1, torch.gather(order, 1, at))
    rows = torch.where(torch.gather(keep, 1, at)[..., None], rows, 0)
    rows = (rows * gates[..., None].to(dtype)).to(dtype).reshape(G, Tg, K, D)
    out = rows[:, :, 0]
    for kk in range(1, K):
        out = out + rows[:, :, kk]
    return out


def shared_experts(params: Params, x: torch.Tensor) -> torch.Tensor:
    """The always-on shared experts' SwiGLU over x [T, D]."""
    sh = _silu(x @ params["shared_gate"]) * (x @ params["shared_up"])
    return sh @ params["shared_down"]


def moe_ffn(params: Params, x: torch.Tensor, cfg: MoEConfig,
            capacity: Optional[int] = None,
            group_tokens: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [T, D] tokens → (output [T, D], aux loss f32 scalar): routing in
    groups of ``group_tokens`` (capacity per group; ``capacity``
    overrides C), as the reference's ``moe_ffn`` on one device."""
    T, D = x.shape
    E = cfg.n_experts
    G, Tg, C = group_capacity(T, cfg, capacity, group_tokens)
    xg = x.reshape(G, Tg, D)
    _, gate_vals, expert_idx, aux = route(params["router"], xg, cfg)
    order, st, keep, slot = dispatch(expert_idx, C, E)
    n = st.shape[1]
    xs = torch.gather(xg, 1, st[..., None].expand(G, n, D))
    xs = torch.where(keep[..., None], xs, 0)
    # every kept pair has a slot of its own; the trash row E·C receives
    # only the dropped pairs' zeros
    buf = torch.zeros((G, E * C + 1, D), dtype=x.dtype, device=x.device)
    buf = buf.scatter(1, slot[..., None].expand(G, n, D), xs)
    y = experts(params, buf[:, :-1].reshape(G, E, C, D))
    out = combine(y.reshape(G, E * C, D), order, keep, slot, gate_vals,
                  x.dtype).reshape(T, D)
    if cfg.n_shared:
        out = out + shared_experts(params, x)
    return out, aux


def moe_ffn_reference(params: Params, x: torch.Tensor,
                      cfg: MoEConfig) -> torch.Tensor:
    """Dense one-hot reference (O(T·E) memory) for correctness tests:
    every token's K experts by gathering their weights, no capacity.
    As the reference's, its output is in the promoted type of x and the
    expert weights."""
    T, D = x.shape
    probs = torch.softmax(x.to(torch.float32) @ params["router"], dim=-1)
    gate_vals, expert_idx = top_k(probs, cfg.top_k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    out = torch.zeros((T, D), dtype=x.dtype, device=x.device)
    for kk in range(cfg.top_k):
        e = expert_idx[:, kk]
        xw = _promoted(x, params["w_gate"])
        h = _silu(torch.einsum("td,tdf->tf", xw, params["w_gate"][e])) * \
            torch.einsum("td,tdf->tf", xw, params["w_up"][e])
        y = torch.einsum("tf,tfd->td", h, params["w_down"][e])
        out = out + y * gate_vals[:, kk, None].to(x.dtype)
    if cfg.n_shared:
        out = out + shared_experts(params, x)
    return out
