"""Dense decoder-only transformer LM for serving: GQA + RoPE + SwiGLU, with
a KV-cache decode (mirrors ``repro/models/transformer.py``: ``LMConfig``,
``init_layer_params``, ``init_lm_params``, ``prefill_step``, ``KVCache``,
``init_kv_cache``, ``decode_step``).

Parameters are a plain dict: ``embed`` [V, D], ``layers`` (a list of one
dict per layer, in layer order), ``ln_f`` [D] and ``lm_head`` [D, V].
Weight matrices are stored [in, out] and applied as ``x @ w``, as in the
reference; :func:`params_from_numpy` turns the reference's stacked
``[L, …]`` tree into this form.

Prefill attention runs the K6 kernel through
``kernels.ops.flash_attention_gqa`` where the reference runs its
row-blocked ``chunked_gqa_attention``; decode attention is plain torch
(``gqa_attention`` with ``kv_len``), as in the reference.  Training
(``lm_backbone``, ``lm_loss``), MoE and the sharding constraints are not
ported yet (ROADMAP queue 1 item 8).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..kernels import ops
from .layers import apply_rope, dense_init, gqa_attention, rmsnorm

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The reference's LM config, dense only (``moe`` raises).  The
    reference's ``tie_embeddings`` (no config sets it), ``remat``,
    ``q_block`` and ``moe_shard_map`` (training and TPU knobs) are left
    out."""
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                  # 0 → d_model // n_heads
    moe: Optional[Any] = None
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.moe is not None:
            raise NotImplementedError(
                f"{self.name}: MoE layers are not ported yet (ROADMAP "
                f"queue 1 item 8)")
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"{self.name}: {self.n_heads} query heads are "
                             f"not a multiple of {self.n_kv_heads} KV heads")

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Analytic parameter count, the reference's formula (dense)."""
        d, dh = self.d_model, self.head_dim
        attn = (d * dh * (self.n_heads + 2 * self.n_kv_heads)
                + self.n_heads * dh * d)
        per_layer = attn + 3 * d * self.d_ff + 2 * d
        return self.n_layers * per_layer + 2 * self.vocab * d + d


def init_layer_params(generator: torch.Generator, cfg: LMConfig,
                      device: Optional[torch.device] = None) -> Params:
    """One decoder block's weights, drawn from ``generator`` in a fixed
    order (wq, wk, wv, wo, w_gate, w_up, w_down)."""
    d, dh = cfg.d_model, cfg.head_dim
    device = device or generator.device

    def dense(i, o):
        return dense_init(generator, i, o, cfg.dtype, device=device)

    p = {"wq": dense(d, cfg.n_heads * dh),
         "wk": dense(d, cfg.n_kv_heads * dh),
         "wv": dense(d, cfg.n_kv_heads * dh),
         "wo": dense(cfg.n_heads * dh, d)}
    p["w_gate"] = dense(d, cfg.d_ff)
    p["w_up"] = dense(d, cfg.d_ff)
    p["w_down"] = dense(cfg.d_ff, d)
    p["ln1"] = torch.ones(d, dtype=cfg.dtype, device=device)
    p["ln2"] = torch.ones(d, dtype=cfg.dtype, device=device)
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


def _tensor(a) -> torch.Tensor:
    a = np.array(a)                        # a writable, contiguous copy
    if a.dtype.name == "bfloat16":         # ml_dtypes' bf16: no numpy kind
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree: Dict[str, Any]) -> Params:
    """The reference's param tree as numpy arrays (``layers`` stacked
    [L, …] for ``lax.scan``) → this module's params on the CPU, in the
    arrays' dtypes, layer ``i`` from slice ``i``."""
    stacked = tree["layers"]
    n_layers = len(next(iter(stacked.values())))
    return {"embed": _tensor(tree["embed"]),
            "layers": [{name: _tensor(a[i]) for name, a in stacked.items()}
                       for i in range(n_layers)],
            "ln_f": _tensor(tree["ln_f"]),
            "lm_head": _tensor(tree["lm_head"])}


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


def _mlp(x: torch.Tensor, layer: Params) -> torch.Tensor:
    """x plus the SwiGLU feed-forward of its pre-norm."""
    h = rmsnorm(x, layer["ln2"])
    gate = h @ layer["w_gate"]
    # silu as the reference's jax.nn.silu, x · sigmoid(x): in bf16 each of
    # the two ops rounds, where F.silu would round once
    y = gate * torch.sigmoid(gate) * (h @ layer["w_up"])
    return x + y @ layer["w_down"]


class KVCache(NamedTuple):
    k: torch.Tensor        # [L, B, T, Hkv, Dh]
    v: torch.Tensor        # [L, B, T, Hkv, Dh]
    length: torch.Tensor   # [B] int32, filled prefix length


def prefill_step(params: Params, cfg: LMConfig, tokens: torch.Tensor):
    """Prefill: tokens [B, S] → (last-position logits [B, V], KVCache of
    length S).  Every layer's attention is one K6 launch on a card."""
    B, S = tokens.shape
    x = params["embed"][tokens.long()]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    for layer in params["layers"]:
        q, k, v = _qkv(cfg, x, layer, positions)
        attn = ops.flash_attention_gqa(q, k, v, causal=True)
        x = _mlp(x + attn.reshape(B, S, -1) @ layer["wo"], layer)
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


def decode_step(params: Params, cfg: LMConfig, cache: KVCache,
                tokens: torch.Tensor):
    """One token per sequence: tokens [B] → (logits [B, V], cache with
    length + 1).  Writes the new keys and values into ``cache.k``/``v``
    in place at each sequence's position ``length`` (the reference
    returns a new cache; its serving loop donates the old one), so the
    cache must have room: ``length < T``."""
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
        x = _mlp(x + attn.reshape(B, 1, -1) @ layer["wo"], layer)
    x = rmsnorm(x, params["ln_f"])
    logits = (x @ params["lm_head"])[:, 0]
    return logits, cache._replace(length=cache.length + 1)
