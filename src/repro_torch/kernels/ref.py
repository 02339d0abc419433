"""Plain-torch twins of the pointer-doubling kernels (mirrors
``repro/kernels/ref.py``).

The twins are what a kernel wrapper runs on CPU tensors, and what the
CUDA kernels are held against bit for bit on the card.  Integer inputs
only: ``nxt``/``ptr`` entries must lie in ``[0, N)``.
"""
from __future__ import annotations

import torch


def pointer_double_ref(nxt: torch.Tensor, lab: torch.Tensor):
    """One pointer-doubling round: ``lab' = min(lab, lab[nxt])``;
    ``nxt' = nxt[nxt]``."""
    return nxt[nxt], torch.minimum(lab, lab[nxt])


def pointer_double_rank_ref(ptr: torch.Tensor, dist: torch.Tensor,
                            reach: torch.Tensor):
    """One list-ranking round: ``dist' = dist + dist[ptr]``;
    ``reach' = max(reach, reach[ptr])``; ``ptr' = ptr[ptr]``."""
    return ptr[ptr], dist + dist[ptr], torch.maximum(reach, reach[ptr])
