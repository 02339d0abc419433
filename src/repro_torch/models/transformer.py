"""Decoder-only transformer LM: GQA + RoPE + SwiGLU or MoE FFN, trained
and served (mirrors ``repro/models/transformer.py``: ``LMConfig``,
``init_layer_params``, ``init_lm_params``, ``abstract_lm_params``,
``lm_backbone``, ``lm_forward``, ``lm_loss``, ``prefill_step``,
``KVCache``, ``init_kv_cache``, ``abstract_kv_cache``, ``decode_step``).

Parameters are a plain dict: ``embed`` [V, D], ``layers`` (a list of one
dict per layer, in layer order; a MoE layer holds a ``moe`` sub-dict in
place of ``w_gate``/``w_up``/``w_down``), ``ln_f`` [D] and ``lm_head``
[D, V].
Weight matrices are stored [in, out] and applied as ``x @ w``, as in the
reference; :func:`params_from_numpy` turns the reference's stacked
``[L, …]`` tree into this form and :func:`params_to_numpy` back.

Training (``lm_backbone``, ``lm_loss``) runs each layer under
``torch.utils.checkpoint`` when ``cfg.remat`` (the reference's
``jax.checkpoint`` with ``nothing_saveable``: only the layer's input is
kept) and attends through the row-blocked ``chunked_gqa_attention``, as
the reference does.  Prefill attention runs the K6 kernel through
``kernels.ops.flash_attention_gqa`` where the reference runs
``chunked_gqa_attention``; decode attention is plain torch
(``gqa_attention`` with ``kv_len``), as in the reference.  A MoE layer's
FFN is ``models.moe.moe_ffn`` on one device, which the reference's
``_layer_fwd`` takes whenever it has no mesh; the sharding constraints
and ``moe_ffn_ep`` wait for a mesh (ROADMAP queue 1 item 9c).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..kernels import ops
from .layers import (apply_rope, chunked_cross_entropy,
                     chunked_gqa_attention, dense_init, gqa_attention,
                     rmsnorm, swiglu)
from .moe import MoEConfig, abstract_moe_params, init_moe_params, moe_ffn

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The reference's LM config.  Its ``tie_embeddings`` (no config sets
    it) and ``moe_shard_map`` (expert parallelism over a mesh) are left
    out."""
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                  # 0 → d_model // n_heads
    moe: Optional[MoEConfig] = None
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    q_block: int = 1024              # row-blocked attention block size

    def __post_init__(self):
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"{self.name}: {self.n_heads} query heads are "
                             f"not a multiple of {self.n_kv_heads} KV heads")

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def _count(self, ffn: int) -> int:
        """Every layer's attention, ``ffn`` FFN parameters and norms, the
        embedding, the head and the final norm."""
        d, dh = self.d_model, self.head_dim
        attn = (d * dh * (self.n_heads + 2 * self.n_kv_heads)
                + self.n_heads * dh * d)
        return self.n_layers * (attn + ffn + 2 * d) + 2 * self.vocab * d + d

    def param_count(self) -> int:
        """Analytic parameter count, the reference's formula."""
        d, moe = self.d_model, self.moe
        if not moe:
            return self._count(3 * d * self.d_ff)
        return self._count(moe.n_experts * 3 * d * moe.d_expert
                           + d * moe.n_experts
                           + 3 * d * moe.d_expert * moe.n_shared)

    def active_param_count(self) -> int:
        """Parameters a token uses (MoE: the routed top-k and the shared
        experts, and the router), the reference's formula."""
        d, moe = self.d_model, self.moe
        if not moe:
            return self.param_count()
        return self._count((moe.top_k + moe.n_shared) * 3 * d * moe.d_expert
                           + d * moe.n_experts)


def _layer_shapes(cfg: LMConfig) -> Dict[str, tuple]:
    """A layer's weight matrices but the MoE ones, in the order
    ``init_layer_params`` draws them."""
    d, dh = cfg.d_model, cfg.head_dim
    shapes = {"wq": (d, cfg.n_heads * dh), "wk": (d, cfg.n_kv_heads * dh),
              "wv": (d, cfg.n_kv_heads * dh), "wo": (cfg.n_heads * dh, d)}
    if cfg.moe is None:
        shapes.update(w_gate=(d, cfg.d_ff), w_up=(d, cfg.d_ff),
                      w_down=(cfg.d_ff, d))
    return shapes


def init_layer_params(generator: torch.Generator, cfg: LMConfig,
                      device: Optional[torch.device] = None) -> Params:
    """One decoder block's weights, drawn from ``generator`` in a fixed
    order (wq, wk, wv, wo, then w_gate, w_up, w_down or the ``moe``
    sub-dict's weights)."""
    device = device or generator.device
    p = {name: dense_init(generator, i, o, cfg.dtype, device=device)
         for name, (i, o) in _layer_shapes(cfg).items()}
    if cfg.moe is not None:
        p["moe"] = init_moe_params(generator, cfg.d_model, cfg.moe,
                                   cfg.dtype, device)
    p["ln1"] = torch.ones(cfg.d_model, dtype=cfg.dtype, device=device)
    p["ln2"] = torch.ones(cfg.d_model, dtype=cfg.dtype, device=device)
    return p


def init_lm_params(generator: torch.Generator, cfg: LMConfig,
                   device: Optional[torch.device] = None) -> Params:
    """Seeded random weights: the numbers depend only on the generator's
    seed and device, so a CPU generator gives the same weights on any
    ``device``.  (They are not the reference's ``jax.random`` numbers:
    tests hand the reference's weights over with
    :func:`params_from_numpy`.)"""
    device = device or generator.device
    p = {"embed": dense_init(generator, cfg.vocab, cfg.d_model, cfg.dtype,
                             scale=0.02, device=device),
         "layers": [init_layer_params(generator, cfg, device)
                    for _ in range(cfg.n_layers)],
         "ln_f": torch.ones(cfg.d_model, dtype=cfg.dtype, device=device)}
    p["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab, cfg.dtype,
                              device=device)
    return p


def abstract_lm_params(cfg: LMConfig) -> Params:
    """The params' shapes and dtypes as ``meta`` tensors (no storage)."""
    def meta(*shape):
        return torch.empty(shape, dtype=cfg.dtype, device="meta")

    layer = {name: meta(*shape) for name, shape in _layer_shapes(cfg).items()}
    layer["ln1"] = layer["ln2"] = meta(cfg.d_model)
    if cfg.moe is not None:
        layer["moe"] = abstract_moe_params(cfg.d_model, cfg.moe, cfg.dtype)
    return {"embed": meta(cfg.vocab, cfg.d_model),
            "layers": [dict(layer) for _ in range(cfg.n_layers)],
            "ln_f": meta(cfg.d_model),
            "lm_head": meta(cfg.d_model, cfg.vocab)}


def _tensor(a) -> torch.Tensor:
    a = np.array(a)                        # a writable, contiguous copy
    if a.dtype.name == "bfloat16":         # ml_dtypes' bf16: no numpy kind
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _unstack(stacked: Dict[str, Any], i: int) -> Params:
    """Slice ``i`` of every array of a stacked layer tree, sub-dicts
    (``moe``) included."""
    return {name: _unstack(a, i) if isinstance(a, dict) else _tensor(a[i])
            for name, a in stacked.items()}


def params_from_numpy(tree: Dict[str, Any]) -> Params:
    """The reference's param tree as numpy arrays (``layers`` stacked
    [L, …] for ``lax.scan``, a MoE layer's ``moe`` sub-dict stacked as
    well) → this module's params on the CPU, in the arrays' dtypes,
    layer ``i`` from slice ``i``."""
    stacked = tree["layers"]
    return {"embed": _tensor(tree["embed"]),
            "layers": [_unstack(stacked, i)
                       for i in range(len(stacked["wq"]))],
            "ln_f": _tensor(tree["ln_f"]),
            "lm_head": _tensor(tree["lm_head"])}


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _stack(layers: List[Params]) -> Dict[str, Any]:
    """The layers' trees stacked [L, …] leaf by leaf, sub-dicts
    included."""
    return {n: _stack([layer[n] for layer in layers])
            if isinstance(a, dict) else
            np.stack([_array(layer[n]) for layer in layers])
            for n, a in layers[0].items()}


def params_to_numpy(params: Params) -> Dict[str, Any]:
    """This module's params (or a tree of their gradients) → the
    reference's tree of numpy arrays, ``layers`` stacked [L, …].  bf16 is
    widened to f32, which keeps every value (numpy has no bf16)."""
    return {"embed": _array(params["embed"]),
            "layers": _stack(params["layers"]),
            "ln_f": _array(params["ln_f"]),
            "lm_head": _array(params["lm_head"])}


def _qkv(cfg: LMConfig, x: torch.Tensor, layer: Params,
         positions: torch.Tensor):
    """Pre-norm projections of x [B, S, D] → rotated q [B,S,Hq,dh],
    rotated k and v [B,S,Hkv,dh]."""
    B, S, _ = x.shape
    dh = cfg.head_dim
    h = rmsnorm(x, layer["ln1"])
    q = (h @ layer["wq"]).reshape(B, S, cfg.n_heads, dh)
    k = (h @ layer["wk"]).reshape(B, S, cfg.n_kv_heads, dh)
    v = (h @ layer["wv"]).reshape(B, S, cfg.n_kv_heads, dh)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _dense_ffn(x: torch.Tensor, layer: Params) -> torch.Tensor:
    """x plus the SwiGLU feed-forward of its pre-norm."""
    return x + swiglu(rmsnorm(x, layer["ln2"]), layer["w_gate"],
                      layer["w_up"], layer["w_down"])


def _moe_ffn(cfg: LMConfig, x: torch.Tensor, layer: Params):
    """x plus the MoE feed-forward of its pre-norm, the B·S tokens routed
    as one batch, and the MoE aux loss."""
    B, S, D = x.shape
    y, aux = moe_ffn(layer["moe"], rmsnorm(x, layer["ln2"]).reshape(B * S, D),
                     cfg.moe)
    return x + y.reshape(B, S, D), aux


def _ffn(cfg: LMConfig, x: torch.Tensor, layer: Params):
    """x plus its feed-forward, dense or MoE by ``cfg``, and the aux loss
    (``None`` for a dense layer)."""
    if cfg.moe is None:
        return _dense_ffn(x, layer), None
    return _moe_ffn(cfg, x, layer)


def _layer_fwd(cfg: LMConfig, x, layer, positions):
    """One decoder block of the training path, x [B, S, D] → (x, the
    layer's aux loss: the MoE FFN's, or a zero f32 scalar when dense)."""
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, x, layer, positions)
    attn = chunked_gqa_attention(q, k, v, q_block=cfg.q_block, causal=True)
    x, aux = _ffn(cfg, x + attn.reshape(B, S, -1) @ layer["wo"], layer)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def lm_backbone(params: Params, cfg: LMConfig, tokens: torch.Tensor):
    """tokens [B, S] → final hidden states [B, S, D] and the aux loss.
    With ``cfg.remat`` each layer is checkpointed: backward recomputes
    it from its input, the only activation a layer keeps."""
    B, S = tokens.shape
    x = params["embed"][tokens.long()]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in params["layers"]:
        if cfg.remat:
            x, a = checkpoint(_layer_fwd, cfg, x, layer, positions,
                              use_reentrant=False)
        else:
            x, a = _layer_fwd(cfg, x, layer, positions)
        aux = aux + a
    return rmsnorm(x, params["ln_f"]), aux


def lm_forward(params: Params, cfg: LMConfig, tokens: torch.Tensor):
    """tokens [B, S] → logits [B, S, V] and the aux loss."""
    x, aux = lm_backbone(params, cfg, tokens)
    return x @ params["lm_head"], aux


def lm_loss(params: Params, cfg: LMConfig, tokens: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy (f32) plus the aux loss."""
    B, S = tokens.shape
    x, aux = lm_backbone(params, cfg, tokens)
    loss = chunked_cross_entropy(x.reshape(B * S, -1), params["lm_head"],
                                 labels.reshape(B * S))
    return loss + aux


class KVCache(NamedTuple):
    k: torch.Tensor        # [L, B, T, Hkv, Dh]
    v: torch.Tensor        # [L, B, T, Hkv, Dh]
    length: torch.Tensor   # [B] int32, filled prefix length


def prefill_step(params: Params, cfg: LMConfig, tokens: torch.Tensor):
    """Prefill: tokens [B, S] → (last-position logits [B, V], KVCache of
    length S).  Every layer's attention is one K6 launch on a card; a MoE
    layer's aux loss is dropped, as the reference drops it."""
    B, S = tokens.shape
    x = params["embed"][tokens.long()]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    for layer in params["layers"]:
        q, k, v = _qkv(cfg, x, layer, positions)
        attn = ops.flash_attention_gqa(q, k, v, causal=True)
        x = _ffn(cfg, x + attn.reshape(B, S, -1) @ layer["wo"], layer)[0]
        ks.append(k)
        vs.append(v)
    x = rmsnorm(x, params["ln_f"])
    logits = x[:, -1] @ params["lm_head"]
    cache = KVCache(k=torch.stack(ks), v=torch.stack(vs),
                    length=torch.full((B,), S, dtype=torch.int32,
                                      device=x.device))
    return logits, cache


def init_kv_cache(cfg: LMConfig, batch: int, max_len: int, fill: int = 0,
                  device: Optional[torch.device] = None) -> KVCache:
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=cfg.dtype, device=device),
        v=torch.zeros(shape, dtype=cfg.dtype, device=device),
        length=torch.full((batch,), fill, dtype=torch.int32, device=device))


def abstract_kv_cache(cfg: LMConfig, batch: int, max_len: int) -> KVCache:
    """A cache's shapes and dtypes as ``meta`` tensors."""
    return init_kv_cache(cfg, batch, max_len, device=torch.device("meta"))


def decode_step(params: Params, cfg: LMConfig, cache: KVCache,
                tokens: torch.Tensor):
    """One token per sequence: tokens [B] → (logits [B, V], cache with
    length + 1).  Writes the new keys and values into ``cache.k``/``v``
    in place at each sequence's position ``length`` (the reference
    returns a new cache; its serving loop donates the old one), so the
    cache must have room: ``length < T``.  A MoE layer routes the B
    tokens as one group, as the reference does."""
    B = tokens.shape[0]
    x = params["embed"][tokens.long()][:, None, :]             # [B, 1, D]
    pos = cache.length
    at = (torch.arange(B, device=x.device), pos.long())
    for i, layer in enumerate(params["layers"]):
        q, k, v = _qkv(cfg, x, layer, pos[:, None])
        cache.k[i][at] = k[:, 0]
        cache.v[i][at] = v[:, 0]
        attn = gqa_attention(q, cache.k[i], cache.v[i], causal=False,
                             kv_len=pos + 1)
        x = _ffn(cfg, x + attn.reshape(B, 1, -1) @ layer["wo"], layer)[0]
    x = rmsnorm(x, params["ln_f"])
    logits = (x @ params["lm_head"])[:, 0]
    return logits, cache._replace(length=cache.length + 1)
