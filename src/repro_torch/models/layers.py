"""Shared neural building blocks on plain tensors (mirrors
``repro/models/layers.py``: ``dense_init``, ``rmsnorm``, ``layernorm``,
``swiglu`` (and its first half, ``swiglu_up``), ``rope_frequencies``,
``apply_rope``, ``gqa_attention``, ``auto_q_block``,
``chunked_gqa_attention``, ``cross_entropy``, ``chunked_cross_entropy``).

Layouts are the reference's: activations [B, S, H, D], weight matrices
stored [in, out] and applied as ``x @ w``.  Training attends through the
row-blocked ``chunked_gqa_attention`` and scores through
``chunked_cross_entropy``, as the reference does; each block body goes
through ``torch.utils.checkpoint`` (non-reentrant), the counterpart of the
reference's ``jax.checkpoint``, so backward recomputes one block at a time.
Serving's prefill attends through the K6 kernel instead
(``kernels.ops.flash_attention_gqa``).

Over a mesh (``models/transformer.py``) the LM runs these on each rank's
own rows and heads; :func:`vocab_shard_lookup` and :func:`xent_sum` are
the two pieces of a vocab-sharded embedding and loss that it runs there.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

#: the reference's additive mask value
MASKED = -1e30


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int,
               dtype: torch.dtype = torch.float32,
               scale: Optional[float] = None,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """A normal [in_dim, out_dim] matrix times ``scale`` (default
    1/√in_dim), drawn in f32 on the generator's device, then cast to
    ``dtype`` and moved to ``device`` (default: the generator's)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    w = torch.randn(in_dim, out_dim, generator=generator,
                    device=generator.device, dtype=torch.float32) * scale
    return w.to(device=device or generator.device, dtype=dtype)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last dim, computed in f32, cast back."""
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * weight.to(torch.float32)).to(dt)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Layer norm over the last dim, computed in f32, cast back."""
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * weight + bias).to(dt)


def swiglu_up(x: torch.Tensor, w_gate: torch.Tensor,
              w_up: torch.Tensor) -> torch.Tensor:
    """SwiGLU's product before its down projection (over a mesh, on tp's
    columns of ``w_gate`` and ``w_up``)."""
    gate = x @ w_gate
    # silu as the reference's jax.nn.silu, x · sigmoid(x): in bf16 each of
    # the two ops rounds, where F.silu would round once
    return gate * torch.sigmoid(gate) * (x @ w_up)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return swiglu_up(x, w_gate, w_up) @ w_down


def rope_frequencies(d_head: int, theta: float = 10000.0,
                     device: Optional[torch.device] = None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [..., S, H, D]; positions: [..., S].  Rotates the interleaved
    pairs (x[..., 0::2], x[..., 1::2]), as the reference does (not the
    half-split form), in f32, and casts back."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)        # [D/2]
    angles = positions[..., :, None, None].to(torch.float32) * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  q_offset: Optional[torch.Tensor] = None,
                  kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain grouped-query attention.  q [B, S, Hq, D], k/v [B, T, Hkv, D];
    ``q_offset`` [B] shifts the causal query positions, ``kv_len`` [B]
    masks keys at or past each sequence's valid length (decode)."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, Hkv, Hq // Hkv, D)
    scores = torch.einsum("bshgd,bthd->bhgst", qg, k).to(torch.float32)
    scores = scores / math.sqrt(D)
    t_idx = torch.arange(T, device=q.device)
    if causal:
        s_pos = torch.arange(S, device=q.device)[None, :].expand(B, S)
        if q_offset is not None:
            s_pos = s_pos + q_offset[:, None]
        mask = t_idx[None, None, :] <= s_pos[:, :, None]          # [B, S, T]
        scores = scores.masked_fill(~mask[:, None, None], MASKED)
    if kv_len is not None:
        valid = t_idx[None, :] < kv_len[:, None]                  # [B, T]
        scores = scores.masked_fill(~valid[:, None, None, None, :], MASKED)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v)
    return out.reshape(B, S, Hq, D)


def auto_q_block(B: int, Hq: int, T: int, q_block_max: int,
                 target_bytes: float = 8e9) -> int:
    """Largest power-of-two query block, at most ``q_block_max`` and at
    least 128, whose f32 score tensor stays under ``target_bytes``."""
    qb = q_block_max
    while qb > 128 and B * Hq * qb * T * 4 > target_bytes:
        qb //= 2
    return qb


def chunked_gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          q_block: int = 1024,
                          causal: bool = True) -> torch.Tensor:
    """Row-blocked attention: q [B, S, Hq, D], k/v [B, T, Hkv, D].  The
    score tensor exists for one block of ``auto_q_block(...)`` query rows
    at a time, and each block is checkpointed, so backward recomputes a
    block's probabilities instead of keeping every block's.  With
    ``S <= q_block`` it is ``gqa_attention``."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    q_block = auto_q_block(B, Hq, T, q_block)
    if S <= q_block:
        return gqa_attention(q, k, v, causal=causal)
    if S % q_block:
        raise ValueError(f"{S} query rows are not a multiple of the "
                         f"{q_block}-row block")
    qg = q.reshape(B, S, Hkv, Hq // Hkv, D)
    t_idx = torch.arange(T, device=q.device)
    scale = math.sqrt(D)

    def block(qi, lo):
        scores = torch.einsum("bshgd,bthd->bhgst", qi, k)
        scores = scores.to(torch.float32) / scale
        if causal:
            s_pos = lo + torch.arange(q_block, device=qi.device)
            keep = t_idx[None, :] <= s_pos[:, None]
            scores = scores.masked_fill(~keep, MASKED)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        return torch.einsum("bhgst,bthd->bshgd", probs, v)

    outs = [checkpoint(block, qg[:, lo:lo + q_block], lo,
                       use_reentrant=False)
            for lo in range(0, S, q_block)]
    return torch.cat(outs, dim=1).reshape(B, S, Hq, D)


def vocab_shard_lookup(table: torch.Tensor, ids: torch.Tensor,
                       lo: int) -> torch.Tensor:
    """The rows of ``ids`` that this shard of an embedding holds (global
    rows ``lo … lo + len(table) − 1``), zeros for the others: one term of
    Megatron's vocab-parallel lookup, whose sum over the shards is the
    lookup of the whole table (each id in exactly one term, the others
    exact zeros).  ids [...] → [..., D]."""
    rows = table.shape[0]
    local = ids.long() - lo
    hit = (local >= 0) & (local < rows)
    got = table[local.clamp(0, rows - 1)]
    return torch.where(hit[..., None], got, torch.zeros_like(got))


def xent_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Summed token cross-entropy of whole logit rows [n, V] in f32 (the
    body of :func:`_xent_block` after the head product)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None].long())[:, 0]
    return torch.sum(logz - gold)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy in f32."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)


def _xent_block(xi, head, li):
    """Summed cross-entropy of one block of rows through the LM head."""
    return xent_sum(xi @ head, li)


def row_block(n: int, block: int = 8192) -> int:
    """``block`` halved until it divides ``n`` rows: the loss's block."""
    while n % block:
        block //= 2
    return block


def chunked_cross_entropy(x: torch.Tensor, head: torch.Tensor,
                          labels: torch.Tensor,
                          block: int = 8192) -> torch.Tensor:
    """LM head and cross-entropy fused over row blocks: x [N, D] (the
    flattened tokens), head [D, V], labels [N].  Only [block, V] logits
    exist at a time, recomputed in backward (each block checkpointed);
    ``block`` halves until it divides N.  The blocks' sums add up in f32,
    in order, and the total is divided by N: the mean."""
    N = x.shape[0]
    block = row_block(N, block)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, N, block):
        total = total + checkpoint(_xent_block, x[lo:lo + block], head,
                                   labels[lo:lo + block], use_reentrant=False)
    return total / N
