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
``_layer_fwd`` takes whenever it has no mesh.

Over a ``DeviceMesh`` (the ``mesh``, ``dp_axes`` and ``tp_axis``
arguments, the reference's) a dense LM's params, tokens and cache are
DTensors placed by the reference's specs, and each block runs on every
rank's local tensors under ``local_map``, between DTensor
redistributions (:class:`MeshPlan`): the weights gathered over dp
(FSDP), Megatron's vocab-parallel embedding (each tp rank's rows, then
one sum over tp), attention on local heads (or all heads, where tp does
not divide the KV heads), the SwiGLU FFN on tp's columns with the
reference's ``P(dp, None, tp)`` on its product, the layers' carry
sequence-sharded over tp (the reference's ``_wsc_act``, Megatron-SP),
and the loss from logits gathered whole over tp a row block at a time.
With no mesh every function is what it was.  A MoE LM over a mesh
raises (``moe_ffn`` with ``ep_axis`` and ``moe_ffn_ep``: ROADMAP queue 1
item 9c.4).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..kernels import ops
from .layers import (apply_rope, chunked_cross_entropy,
                     chunked_gqa_attention, dense_init, gqa_attention,
                     rmsnorm, row_block, swiglu_up, vocab_shard_lookup,
                     xent_sum)
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


#: a layer's attention weights, in the order the attention functions take
ATTN = ("ln1", "wq", "wk", "wv", "wo")


def _qkv(cfg: LMConfig, x: torch.Tensor, ln1, wq, wk, wv,
         positions: torch.Tensor):
    """Pre-norm projections of x [B, S, D] → rotated q [B, S, Hq, dh],
    rotated k and v [B, S, Hkv, dh], for the heads whose columns
    ``wq``/``wk``/``wv`` hold (all of them, or a rank's own)."""
    B, S, _ = x.shape
    dh = cfg.head_dim
    h = rmsnorm(x, ln1)
    q = (h @ wq).reshape(B, S, -1, dh)
    k = (h @ wk).reshape(B, S, -1, dh)
    v = (h @ wv).reshape(B, S, -1, dh)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _attend_block(cfg: LMConfig, attend, x, ln1, wq, wk, wv, wo, positions):
    """The attention half of a block: x [B, S, D] → (the attention's
    output projection, rotated k, v).  ``attend(q, k, v)`` runs on the
    heads the weights hold; over a mesh, on a rank's local tensors, where
    the projection is a term of a sum over tp if heads split."""
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, x, ln1, wq, wk, wv, positions)
    return attend(q, k, v).reshape(B, S, -1) @ wo, k, v


def _ffn_up(x, ln2, w_gate, w_up):
    """The SwiGLU FFN's product before ``w_down``, of x's pre-norm."""
    return swiglu_up(rmsnorm(x, ln2), w_gate, w_up)


def _dense_ffn(x: torch.Tensor, layer: Params) -> torch.Tensor:
    """x plus the SwiGLU feed-forward of its pre-norm."""
    return x + _ffn_up(x, layer["ln2"], layer["w_gate"],
                       layer["w_up"]) @ layer["w_down"]


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


def _layer_fwd(cfg: LMConfig, x, layer, positions, dp_axes=None,
               tp_axis=None, mesh=None):
    """One decoder block of the training path, x [B, S, D] → (x, the
    layer's aux loss: the MoE FFN's, or a zero f32 scalar when dense).
    Over ``mesh`` x is a DTensor (see :class:`MeshPlan`), and so is the
    result, placed ``P(dp, tp, None)``."""
    if mesh is not None:
        plan = _plan(cfg, mesh, dp_axes, tp_axis)
        x = _mesh_layer(cfg, plan, x, layer, positions, _train_attend(cfg))[0]
        return x, _mesh_zero(plan)
    o = _attend_block(cfg, _train_attend(cfg), x,
                      *(layer[n] for n in ATTN), positions)[0]
    x, aux = _ffn(cfg, x + o, layer)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def lm_backbone(params: Params, cfg: LMConfig, tokens: torch.Tensor,
                dp_axes=None, tp_axis=None, mesh=None):
    """tokens [B, S] → final hidden states [B, S, D] and the aux loss.
    With ``cfg.remat`` each layer is checkpointed: backward recomputes
    it from its input, the only activation a layer keeps.  Over ``mesh``
    the params and tokens are DTensors placed by the reference's specs
    (:class:`MeshPlan`); the states come back placed ``P(dp, tp,
    None)``."""
    if mesh is not None:
        plan = _plan(cfg, mesh, dp_axes, tp_axis)
        x = _mesh_backbone(params, cfg, tokens, plan, _train_attend(cfg),
                           cfg.remat)[0]
        return x, _mesh_zero(plan)
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
            labels: torch.Tensor, dp_axes=None, tp_axis=None,
            mesh=None) -> torch.Tensor:
    """Mean next-token cross-entropy (f32) plus the aux loss.  Over
    ``mesh``, a replicated DTensor scalar (a dense LM's aux loss is 0)."""
    if mesh is not None:
        return _mesh_loss(params, cfg, tokens, labels,
                          _plan(cfg, mesh, dp_axes, tp_axis))
    B, S = tokens.shape
    x, aux = lm_backbone(params, cfg, tokens)
    loss = chunked_cross_entropy(x.reshape(B * S, -1), params["lm_head"],
                                 labels.reshape(B * S))
    return loss + aux


class KVCache(NamedTuple):
    k: torch.Tensor        # [L, B, T, Hkv, Dh]
    v: torch.Tensor        # [L, B, T, Hkv, Dh]
    length: torch.Tensor   # [B] int32, filled prefix length


def prefill_step(params: Params, cfg: LMConfig, tokens: torch.Tensor,
                 dp_axes=None, tp_axis=None, mesh=None):
    """Prefill: tokens [B, S] → (last-position logits [B, V], KVCache of
    length S).  Every layer's attention is one K6 launch on a card; a MoE
    layer's aux loss is dropped, as the reference drops it.  Over
    ``mesh`` each rank launches K6 once a layer on its local heads
    (plain tensors), and the outputs are DTensors placed as the
    reference's ``build_lm_cell`` places them."""
    if mesh is not None:
        return _mesh_prefill(params, cfg, tokens,
                             _plan(cfg, mesh, dp_axes, tp_axis))
    B, S = tokens.shape
    x = params["embed"][tokens.long()]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    for layer in params["layers"]:
        o, k, v = _attend_block(cfg, _prefill_attend, x,
                                *(layer[n] for n in ATTN), positions)
        x = _ffn(cfg, x + o, layer)[0]
        ks.append(k)
        vs.append(v)
    logits = _last_logits(rmsnorm(x, params["ln_f"]), params["lm_head"])
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
                tokens: torch.Tensor, dp_axes=None, tp_axis=None,
                mesh=None):
    """One token per sequence: tokens [B] → (logits [B, V], cache with
    length + 1).  Writes the new keys and values into ``cache.k``/``v``
    in place at each sequence's position ``length`` (the reference
    returns a new cache; its serving loop donates the old one), so the
    cache must have room: ``length < T``.  A MoE layer routes the B
    tokens as one group, as the reference does.  Over ``mesh`` each rank
    writes its own shard of the cache (:func:`_mesh_decode`)."""
    if mesh is not None:
        return _mesh_decode(params, cfg, cache, tokens,
                            _plan(cfg, mesh, dp_axes, tp_axis))
    x = params["embed"][tokens.long()][:, None, :]             # [B, 1, D]
    for i, layer in enumerate(params["layers"]):
        o = _decode_attend(cfg, x, *(layer[n] for n in ATTN), cache.k[i],
                           cache.v[i], cache.length)
        x = _ffn(cfg, x + o, layer)[0]
    x = rmsnorm(x, params["ln_f"])
    logits = (x @ params["lm_head"])[:, 0]
    return logits, cache._replace(length=cache.length + 1)


# ---------------------------------------------------------------------------
# Over a mesh
# ---------------------------------------------------------------------------

class MeshPlan:
    """Where the LM's tensors live on a ``DeviceMesh``: the placements of
    the reference's specs (``parallel/sharding.py::placements``) for
    ``dp`` (the batch and FSDP axes) and ``tp`` (the tensor-parallel
    axis, ``None`` for none), and the rule for attention heads.

    Heads split over tp where tp divides ``n_kv_heads`` (each rank
    attends with its own query heads and the KV heads they read);
    otherwise every rank of a tp group attends with all heads, its
    q/k/v projections gathered whole (the reference's GSPMD pads or
    gathers such heads on its own; this is the documented choice here),
    and the KV cache shards its sequence over tp (``_lm_kv_specs``)."""

    def __init__(self, cfg: LMConfig, mesh, dp_axes=None,
                 tp_axis: Optional[str] = None):
        from torch.distributed.tensor import Partial, Replicate

        from ..parallel.sharding import P, dp_axes_of, mesh_sizes, placements

        if cfg.moe is not None:
            raise NotImplementedError(
                f"{cfg.name}: a MoE LM over a mesh (moe_ffn with ep_axis, "
                f"moe_ffn_ep) waits for ROADMAP queue 1 item 9c.4")
        names = tuple(mesh.mesh_dim_names)
        self.mesh = mesh
        self.dp = tuple(dp_axes) if dp_axes is not None else \
            dp_axes_of(mesh)
        self.tp = tp_axis
        tp_size = mesh_sizes(mesh)[tp_axis] if tp_axis else 1
        self.tp_size = tp_size
        self.tp_rank = mesh.get_local_rank(tp_axis) if tp_axis else 0
        self.heads = cfg.n_kv_heads % tp_size == 0
        self._dp_dims = {names.index(a) for a in self.dp}
        self._tp_dim = names.index(tp_axis) if tp_axis else None
        self._partial, self._replicate = Partial(), Replicate()
        dp, tp = self.dp, tp_axis

        def pl(*entries):
            return placements(P(*entries), mesh)

        self.pl = pl
        self.rep = tuple(Replicate() for _ in names)
        self.tok = pl(dp, None)              # [B, S] ids, [B, V] logits
        self.act = pl(dp, None, None)        # [B, S, D], batch over dp
        self.seq = pl(dp, tp, None)          # the layers' carry (Megatron-SP)
        self.cols = pl(dp, None, tp)         # [B, S, F], F over tp
        self.w_cols = pl(None, tp)           # [D, F] gathered over dp
        self.w_rows = pl(tp, None)           # [F, D] gathered over dp
        # the attention block's weights, output and K/V, by the head rule
        self.w_qkv = self.w_cols if self.heads else self.rep
        self.w_o = self.w_rows if self.heads else self.rep
        self.attn_out = self.partial(self.act) if self.heads else self.act
        self.kv_out = pl(dp, None, tp if self.heads else None, None)
        self.kv_cache = pl(None, dp, None, tp, None) if self.heads else \
            pl(None, dp, tp, None, None)

    def partial(self, pl) -> tuple:
        """``pl`` with a partial sum over tp: each tp rank holds a term."""
        return tuple(self._partial if m == self._tp_dim else p
                     for m, p in enumerate(pl))

    def summed(self) -> tuple:
        """A scalar summed over dp's rows: a term on each dp rank."""
        return tuple(self._partial if m in self._dp_dims else
                     self._replicate for m in range(len(self.rep)))

    def block(self, fn, out, ins, split_tp: bool):
        """``fn`` on each rank's local tensors (``local_map``): ``ins`` are
        the placements of its arguments (``None`` for a plain one), ``out``
        of its result (a tuple of them for several).  Gradients: an input
        sharded on a mesh dimension gets its gradient sharded there; one
        replicated gets a partial sum over dp (each dp rank saw other
        rows) and over tp where ``split_tp`` (each tp rank computed other
        columns), else a replicated gradient (every tp rank computed the
        same one)."""
        from torch.distributed.tensor.experimental import local_map

        def grad(pl):
            if pl is None:
                return None
            return tuple(
                p if p.is_shard() else self._partial
                if m in self._dp_dims or (split_tp and m == self._tp_dim)
                else self._replicate for m, p in enumerate(pl))

        out = tuple(list(o) for o in out) if isinstance(out[0], tuple) \
            else list(out)
        return local_map(fn, out_placements=out, in_placements=ins,
                         in_grad_placements=tuple(grad(p) for p in ins),
                         device_mesh=self.mesh)


def _lookup_out(plan: MeshPlan, pl) -> tuple:
    """The vocab-parallel lookup's placements before its sum over tp:
    each tp rank's term."""
    return plan.partial(pl)


def _mesh_embed(plan: MeshPlan, params: Params, tokens):
    """Megatron's vocab-parallel lookup: each tp rank looks its own vocab
    rows up (zeros for the others' ids), then one sum over tp; the batch
    stays over dp (the reference's ``_wsc_act`` after its gather)."""
    # [V/tp, D] a rank, gathered over dp
    table = params["embed"].redistribute(plan.mesh, plan.w_rows)
    lo = plan.tp_rank * table.to_local().shape[0]
    pl = plan.pl(plan.dp, *([None] * (tokens.dim() - 1)))
    out_pl = plan.pl(plan.dp, *([None] * tokens.dim()))
    x = plan.block(vocab_shard_lookup, _lookup_out(plan, out_pl),
                   (plan.w_rows, pl, None), split_tp=True)(table, tokens, lo)
    return x.redistribute(plan.mesh, out_pl)


def _mesh_ffn(plan: MeshPlan, x, layer: Params):
    """x plus its SwiGLU FFN over the mesh: the gate and up products on
    tp's columns, the reference's constraint ``P(dp, None, tp)`` on their
    product, the down product's terms summed back into x's layout."""
    xa = x.redistribute(plan.mesh, plan.act)
    y = plan.block(_ffn_up, plan.cols,
                   (plan.act, plan.rep, plan.w_cols, plan.w_cols),
                   split_tp=True)(
        xa, layer["ln2"].redistribute(plan.mesh, plan.rep),
        layer["w_gate"].redistribute(plan.mesh, plan.w_cols),
        layer["w_up"].redistribute(plan.mesh, plan.w_cols))
    y = y.redistribute(plan.mesh, plan.cols)
    o = plan.block(torch.matmul, plan.partial(plan.act),
                   (plan.cols, plan.w_rows), split_tp=True)(
        y, layer["w_down"].redistribute(plan.mesh, plan.w_rows))
    return x + o.redistribute(plan.mesh, x.placements)


def _mesh_layer(cfg: LMConfig, plan: MeshPlan, x, layer: Params,
                positions, attend):
    """One decoder block over the mesh, x [B, S, D] placed ``plan.seq``
    (or ``plan.act`` after the embedding) → (x placed ``plan.seq``, k, v
    of the layer placed ``plan.kv_out``).  ``attend(q, k, v)`` runs on
    local heads."""
    xa = x.redistribute(plan.mesh, plan.act)
    o, k, v = plan.block(
        partial(_attend_block, cfg, attend),
        (plan.attn_out, plan.kv_out, plan.kv_out),
        (plan.act, plan.rep, plan.w_qkv, plan.w_qkv, plan.w_qkv, plan.w_o,
         None), split_tp=plan.heads)(
        xa, layer["ln1"].redistribute(plan.mesh, plan.rep),
        *(layer[n].redistribute(plan.mesh, plan.w_qkv)
          for n in ("wq", "wk", "wv")),
        layer["wo"].redistribute(plan.mesh, plan.w_o), positions)
    x = x + o.redistribute(plan.mesh, x.placements)
    x = _mesh_ffn(plan, x, layer)
    return x.redistribute(plan.mesh, plan.seq), k, v


def _mesh_norm(plan: MeshPlan, x, weight):
    """The final RMS norm on each rank's own rows of x (any placement
    that leaves D whole)."""
    split = plan._tp_dim is not None and x.placements[plan._tp_dim].is_shard()
    return plan.block(rmsnorm, x.placements, (x.placements, plan.rep),
                      split_tp=split)(
        x, weight.redistribute(plan.mesh, plan.rep))


def _last_logits(x, head):
    return x[:, -1] @ head


def _mesh_head_last(plan: MeshPlan, params: Params, x):
    """Last-position logits [B, V] of the normed x, batch over dp."""
    xa = x.redistribute(plan.mesh, plan.act)
    logits = plan.block(_last_logits, plan.pl(plan.dp, plan.tp),
                        (plan.act, plan.w_cols),
                        split_tp=True)(
        xa, params["lm_head"].redistribute(plan.mesh, plan.w_cols))
    return logits.redistribute(plan.mesh, plan.tok)


def _mesh_zero(plan: MeshPlan):
    """A replicated f32 zero: a dense layer's aux loss over the mesh."""
    from torch.distributed.tensor import DTensor

    from ..parallel.sharding import mesh_device

    return DTensor.from_local(
        torch.zeros((), dtype=torch.float32, device=mesh_device(plan.mesh)),
        plan.mesh, plan.rep)


def _plan(cfg, mesh, dp_axes, tp_axis) -> MeshPlan:
    """The plan of ``mesh``; tp defaults to its ``model`` axis."""
    return MeshPlan(cfg, mesh, dp_axes, tp_axis or (
        "model" if "model" in mesh.mesh_dim_names else None))


def _positions(plan: MeshPlan, B: int, S: int) -> torch.Tensor:
    """Local positions [B', S] of the rows each rank holds."""
    from ..parallel.sharding import P, local_shape, mesh_device

    local_b = local_shape((B, S), P(plan.dp, None), plan.mesh)[0]
    return torch.arange(S, device=mesh_device(plan.mesh))[None].expand(
        local_b, S)


def _mesh_backbone(params: Params, cfg: LMConfig, tokens, plan: MeshPlan,
                   attend, remat: bool):
    """The backbone over the mesh → (normed x placed ``plan.seq``, each
    layer's k and v)."""
    B, S = tokens.shape
    x = _mesh_embed(plan, params, tokens)
    positions = _positions(plan, B, S)
    ks, vs = [], []
    for layer in params["layers"]:
        if remat:
            x, k, v = checkpoint(_mesh_layer, cfg, plan, x, layer, positions,
                                 attend, use_reentrant=False)
        else:
            x, k, v = _mesh_layer(cfg, plan, x, layer, positions, attend)
        ks.append(k)
        vs.append(v)
    return _mesh_norm(plan, x, params["ln_f"]), ks, vs


def _train_attend(cfg: LMConfig):
    return lambda q, k, v: chunked_gqa_attention(q, k, v, q_block=cfg.q_block,
                                                 causal=True)


def _prefill_attend(q, k, v):
    return ops.flash_attention_gqa(q, k, v, causal=True)


def _rows_logits(x, head, lo: int, hi: int):
    return x.reshape(-1, x.shape[-1])[lo:hi] @ head


def _rows_xent(logits, labels, lo: int, hi: int):
    return xent_sum(logits, labels.reshape(-1)[lo:hi])


def _mesh_xent_block(plan: MeshPlan, xa, head, labels, lo: int, hi: int):
    """Summed cross-entropy of local rows ``lo:hi`` (each dp rank's own):
    their logits on tp's vocab columns, gathered whole over tp, then the
    sum (a term on each dp rank)."""
    logits = plan.block(_rows_logits, plan.pl(plan.dp, plan.tp),
                        (plan.act, plan.w_cols, None, None),
                        split_tp=True)(xa, head, lo, hi)
    logits = logits.redistribute(plan.mesh, plan.tok)
    return plan.block(_rows_xent, plan.summed(), (plan.tok, plan.tok, None,
                                                  None),
                      split_tp=False)(logits, labels, lo, hi)


def _mesh_loss(params: Params, cfg: LMConfig, tokens, labels,
               plan: MeshPlan):
    """``lm_loss`` over the mesh: the mean token cross-entropy, replicated
    (the reference's ``P()``).  Each dp rank scores its own rows in
    blocks of at most 8,192 (the block halves until it divides them),
    each block checkpointed."""
    B, S = tokens.shape
    x, _, _ = _mesh_backbone(params, cfg, tokens, plan, _train_attend(cfg),
                             cfg.remat)
    xa = x.redistribute(plan.mesh, plan.act)
    head = params["lm_head"].redistribute(plan.mesh, plan.w_cols)
    n = xa.to_local().shape[0] * S
    block = row_block(n)
    total = None
    for lo in range(0, n, block):
        part = checkpoint(_mesh_xent_block, plan, xa, head, labels, lo,
                          lo + block, use_reentrant=False)
        total = part if total is None else total + part
    return (total / (B * S)).redistribute(plan.mesh, plan.rep)


def _mesh_prefill(params: Params, cfg: LMConfig, tokens, plan: MeshPlan):
    """``prefill_step`` over the mesh: K6 on each rank's local heads, the
    cache placed by ``_lm_kv_specs`` (heads over tp, or its sequence
    where heads do not split), logits ``P(dp, None)``."""
    from torch.distributed.tensor import DTensor

    B, S = tokens.shape
    x, ks, vs = _mesh_backbone(
        params, cfg, tokens, plan,
        _prefill_attend, remat=False)
    logits = _mesh_head_last(plan, params, x)

    def cache(ts):
        local = torch.stack([t.to_local() for t in ts])
        whole = DTensor.from_local(local, plan.mesh, plan.pl(
            None, plan.dp, None, plan.tp if plan.heads else None, None),
            run_check=False)
        return whole.redistribute(plan.mesh, plan.kv_cache)

    length = torch.full((ks[0].to_local().shape[0],), S, dtype=torch.int32,
                        device=logits.to_local().device)
    return logits, KVCache(
        k=cache(ks), v=cache(vs),
        length=DTensor.from_local(length, plan.mesh, plan.pl(plan.dp),
                                  run_check=False))


def _decode_attend(cfg: LMConfig, x, ln1, wq, wk, wv, wo, kc, vc, pos):
    """Decode attention of x [B, 1, D] with the heads the weights and the
    cache hold, the cache's whole sequence at hand: the new k, v go into
    ``kc``/``vc`` [B, T, H, dh] in place at ``pos``; → the output
    projection [B, 1, D]."""
    B = x.shape[0]
    q, k, v = _qkv(cfg, x, ln1, wq, wk, wv, pos[:, None])
    at = (torch.arange(B, device=x.device), pos.long())
    kc[at] = k[:, 0]
    vc[at] = v[:, 0]
    return _decode_attend_all(q, kc, vc, pos, wo)


def _decode_write_seq(cfg: LMConfig, x, ln1, wq, wk, wv, kc, vc, pos,
                      lo: int):
    """Decode's projections with all heads, the new k, v written in place
    into this rank's slice of the cache sequence (global positions ``lo
    …``) where ``pos`` falls in it; returns q."""
    q, k, v = _qkv(cfg, x, ln1, wq, wk, wv, pos[:, None])
    B, T = kc.shape[:2]
    local = pos.long() - lo
    hit = ((local >= 0) & (local < T))[:, None, None]
    at = (torch.arange(B, device=x.device), local.clamp(0, T - 1))
    kc[at] = torch.where(hit, k[:, 0], kc[at])
    vc[at] = torch.where(hit, v[:, 0], vc[at])
    return q


def _decode_attend_all(q, kc, vc, pos, wo):
    B = q.shape[0]
    return gqa_attention(q, kc, vc, causal=False,
                         kv_len=pos + 1).reshape(B, 1, -1) @ wo


def _mesh_decode(params: Params, cfg: LMConfig, cache: KVCache, tokens,
                 plan: MeshPlan):
    """``decode_step`` over the mesh.  Heads split over tp: each rank
    writes and reads its own heads' cache.  Otherwise the cache's
    sequence is over tp: the rank holding the position writes it, then
    the layer's K/V are gathered whole over tp and every rank attends
    with all heads (a gather, not a combination of partial softmaxes)."""
    pos = cache.length
    x = _mesh_embed(plan, params, tokens[:, None])             # [B, 1, D]
    act, pos_pl = plan.act, plan.pl(plan.dp)
    layer_kv = plan.pl(plan.dp, None if plan.heads else plan.tp, plan.tp
                       if plan.heads else None, None)
    for i, layer in enumerate(params["layers"]):
        ln1 = layer["ln1"].redistribute(plan.mesh, plan.rep)
        wq, wk, wv = (layer[n].redistribute(plan.mesh, plan.w_qkv)
                      for n in ("wq", "wk", "wv"))
        wo = layer["wo"].redistribute(plan.mesh, plan.w_o)
        kc, vc = cache.k[i], cache.v[i]
        if plan.heads:
            o = plan.block(
                partial(_decode_attend, cfg), plan.attn_out,
                (act, plan.rep, plan.w_qkv, plan.w_qkv, plan.w_qkv,
                 plan.w_o, layer_kv, layer_kv, pos_pl),
                split_tp=True)(x, ln1, wq, wk, wv, wo, kc, vc, pos)
        else:
            lo = plan.tp_rank * kc.to_local().shape[1]
            q = plan.block(
                partial(_decode_write_seq, cfg),
                plan.pl(plan.dp, None, None, None),
                (act, plan.rep, plan.rep, plan.rep, plan.rep, layer_kv,
                 layer_kv, pos_pl, None), split_tp=False)(
                x, ln1, wq, wk, wv, kc, vc, pos, lo)
            whole = plan.pl(plan.dp, None, None, None)
            o = plan.block(_decode_attend_all, act,
                           (whole, whole, whole, pos_pl, plan.rep),
                           split_tp=False)(
                q, kc.redistribute(plan.mesh, whole),
                vc.redistribute(plan.mesh, whole), pos, wo)
        x = x + o.redistribute(plan.mesh, act)
        x = _mesh_ffn(plan, x, layer)
    x = _mesh_norm(plan, x, params["ln_f"])
    logits = _mesh_head_last(plan, params, x)
    return logits, cache._replace(length=cache.length + 1)
