"""Shared neural building blocks on plain tensors (mirrors
``repro/models/layers.py``: ``dense_init``, ``rmsnorm``,
``rope_frequencies``, ``apply_rope``, ``gqa_attention``).

Layouts are the reference's: activations [B, S, H, D], weight matrices
stored [in, out] and applied as ``x @ w``.  The row-blocked
``chunked_gqa_attention`` has no counterpart: prefill attention runs the
K6 kernel through ``kernels.ops.flash_attention_gqa``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

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
