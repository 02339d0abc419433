"""AutoInt (arXiv:1810.11921): self-attention feature interaction over
sparse-field embeddings, with an EmbeddingBag built from a gather and a
masked sum (mirrors ``repro/models/recsys.py``).

The embedding table is the hot path: ``n_fields × vocab_per_field`` rows
in one tensor, each field's ids offset into its own block of rows (the
largest row of the full config, 38,999,999, fits int32, so ids stay
int32).  The table's gradient is dense, as ``jax.value_and_grad`` makes
it: autograd of the gather is an ``index_add`` into a zero table, which
on the card adds by atomics, so card results are allclose to the CPU's,
not bit-equal.  ``retrieval_score`` scores one query against a candidate
matrix with one product and a top-k.

The tie rules are the reference's: the loss's ``maximum(logit, 0)`` is
``torch.maximum`` against a tensor (half the gradient at a tie, as
``jnp.maximum``; ``torch.clamp`` passes all of it), its ``|logit|`` has
derivative 1 at 0 as ``jnp.abs``'s does (``torch.abs``'s is 0), and the
top-k breaks ties toward the lower index, as ``lax.top_k`` does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from ..tree import tree_map
from .layers import dense_init
from .moe import top_k as _top_k

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class AutoIntConfig:
    name: str
    n_fields: int = 39
    vocab_per_field: int = 1_000_000
    embed_dim: int = 16
    n_attn_layers: int = 3
    n_heads: int = 2
    d_attn: int = 32
    mlp_dims: tuple = (400, 400)
    max_bag: int = 3              # multi-hot ids per field (EmbeddingBag)
    dtype: Any = torch.float32


class RecsysBatch(NamedTuple):
    ids: Any        # [B, n_fields, max_bag] int32 hashed ids
    bag_mask: Any   # [B, n_fields, max_bag] f32
    labels: Any     # [B] f32 click labels


def _layer_shapes(cfg: AutoIntConfig):
    """Each attention layer's ``(d_in, H·D)``, the MLP's ``(in, out)``
    pairs and the output layer's fan-in."""
    hd = cfg.n_heads * cfg.d_attn
    attn = [(cfg.embed_dim if i == 0 else hd, hd)
            for i in range(cfg.n_attn_layers)]
    d_in = hd if cfg.n_attn_layers else cfg.embed_dim
    dims = (cfg.n_fields * d_in,) + tuple(cfg.mlp_dims)
    return attn, list(zip(dims[:-1], dims[1:])), dims[-1]


def init_autoint_params(generator: torch.Generator,
                        cfg: AutoIntConfig) -> Params:
    """Seeded weights on the generator's device: the table a normal ×
    0.01, each matrix ``dense_init``'s.  Each matrix is drawn once (the
    reference draws every layer's ``wres`` from one key, ROADMAP)."""
    table = torch.randn(cfg.n_fields * cfg.vocab_per_field, cfg.embed_dim,
                        generator=generator, device=generator.device,
                        dtype=torch.float32).mul_(0.01).to(cfg.dtype)
    attn_shapes, mlp_shapes, out_in = _layer_shapes(cfg)
    attn = [{name: dense_init(generator, d_in, hd, cfg.dtype)
             for name in ("wq", "wk", "wv", "wres")}
            for d_in, hd in attn_shapes]
    mlp = [dense_init(generator, a, b, cfg.dtype) for a, b in mlp_shapes]
    return {"table": table, "attn": attn, "mlp": mlp,
            "out": dense_init(generator, out_in, 1, cfg.dtype)}


def abstract_autoint_params(cfg: AutoIntConfig) -> Params:
    """The params' shapes and dtypes as ``meta`` tensors (no storage: the
    full table is 2.5 GB)."""
    def meta(*shape):
        return torch.empty(shape, dtype=cfg.dtype, device="meta")

    attn_shapes, mlp_shapes, out_in = _layer_shapes(cfg)
    return {"table": meta(cfg.n_fields * cfg.vocab_per_field,
                          cfg.embed_dim),
            "attn": [{name: meta(d_in, hd)
                      for name in ("wq", "wk", "wv", "wres")}
                     for d_in, hd in attn_shapes],
            "mlp": [meta(a, b) for a, b in mlp_shapes],
            "out": meta(out_in, 1)}


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  bag_mask: torch.Tensor,
                  field_offsets: torch.Tensor) -> torch.Tensor:
    """Sum-bag lookup: ids [B, F, G] → [B, F, d].  A gather of the int32
    rows ``ids + offsets`` and a masked sum over the bag."""
    B, F, G = ids.shape
    rows = ids + field_offsets[None, :, None]
    flat = torch.index_select(table, 0, rows.reshape(-1))
    flat = flat.reshape(B, F, G, -1)
    return torch.sum(flat * bag_mask[..., None], dim=2)


def _embed(params: Params, cfg: AutoIntConfig,
           batch: RecsysBatch) -> torch.Tensor:
    offsets = torch.arange(cfg.n_fields, dtype=batch.ids.dtype,
                           device=batch.ids.device) * cfg.vocab_per_field
    ids = torch.clamp(batch.ids, 0, cfg.vocab_per_field - 1)
    return embedding_bag(params["table"], ids, batch.bag_mask, offsets)


def autoint_forward(params: Params, cfg: AutoIntConfig,
                    batch: RecsysBatch) -> torch.Tensor:
    """The logits [B]."""
    B = batch.ids.shape[0]
    x = _embed(params, cfg, batch)                       # [B, F, d]
    H, D = cfg.n_heads, cfg.d_attn
    # a divisor on the tensor's device: by a Python number the card
    # multiplies by its reciprocal, which rounds otherwise
    scale = x.new_full((), math.sqrt(D))
    for lp in params["attn"]:
        q = (x @ lp["wq"]).reshape(B, -1, H, D)
        k = (x @ lp["wk"]).reshape(B, -1, H, D)
        v = (x @ lp["wv"]).reshape(B, -1, H, D)
        scores = torch.einsum("bfhd,bghd->bhfg", q, k) / scale
        probs = torch.softmax(scores.to(torch.float32), -1).to(x.dtype)
        o = torch.einsum("bhfg,bghd->bfhd", probs, v).reshape(B, -1, H * D)
        x = torch.relu(o + x @ lp["wres"])

    h = x.reshape(B, -1)
    for w in params["mlp"]:
        h = torch.relu(h @ w)
    return (h @ params["out"])[:, 0]


def _max0(x: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(x, 0)``: half the gradient at a tie."""
    return torch.maximum(x, x.new_zeros(()))


def _abs(x: torch.Tensor) -> torch.Tensor:
    """``jnp.abs``: derivative 1 at 0."""
    return torch.where(x >= 0, x, -x)


def autoint_loss(params: Params, cfg: AutoIntConfig,
                 batch: RecsysBatch) -> torch.Tensor:
    """The mean logistic loss, in the reference's form."""
    logit = autoint_forward(params, cfg, batch).to(torch.float32)
    y = batch.labels.to(torch.float32)
    return torch.mean(_max0(logit) - logit * y
                      + torch.log1p(torch.exp(-_abs(logit))))


def retrieval_score(params: Params, cfg: AutoIntConfig, query: RecsysBatch,
                    cand_emb: torch.Tensor, top_k: int = 100):
    """Score the queries against [n_cand, d] candidates: the mean of the
    fields' embeddings (the user tower), one product, then the ``top_k``
    largest (values, int32 indices), lower index first at a tie."""
    u = torch.mean(_embed(params, cfg, query), dim=1)    # [B, d]
    vals, idx = _top_k(u @ cand_emb.T, top_k)            # [B, n_cand]
    return vals, idx.to(torch.int32)


def params_from_numpy(tree) -> Params:
    """The reference's param tree of numpy arrays (``{"table", "attn":
    [{"wq", "wk", "wv", "wres"}], "mlp": [...], "out"}``) → the same tree
    of CPU tensors."""
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def params_to_numpy(params: Params):
    """This module's params (or a tree of their gradients) → the
    reference's tree of numpy arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)
