"""Plain-torch twins of the pointer-doubling kernels (mirrors
``repro/kernels/ref.py``).

The twins are what a kernel wrapper runs on CPU tensors, and what the
CUDA kernels are held against bit for bit on the card.  Integer inputs
only: ``nxt``/``ptr`` entries must lie in ``[0, N)``.

The shard twins take the reference's single-shard form (``q`` [S],
``base`` [1], tables [T]) and also the port's all-shards form (``q``
[n, S], ``base`` [n], tables [n, T]), where row r is query shard r with
its own visiting table slice and base.
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


def _shard_own(q: torch.Tensor, base: torch.Tensor, s_real: int):
    """Ownership test of the shard twins: ``own = 0 ≤ q − base < s_real``
    (int32 arithmetic, as in the reference) and the safe index, 0 where
    not owned.  ``base`` stays a device tensor: ``[1]`` for a 1-D ``q``,
    one base per row for a 2-D one."""
    idx = q - (base[:, None] if q.dim() == 2 else base)
    own = (idx >= 0) & (idx < s_real)
    return own, torch.where(own, idx, 0).to(torch.int64)


def pointer_double_shard_ref(q, a_nxt, a_lab, base, tbl_nxt, tbl_lab,
                             s_real: int):
    """One ring step of the sharded CC gather: queries owned by the
    visiting table slice (base ≤ q < base+s_real) take its values,
    others keep their current answers."""
    own, idx = _shard_own(q, base, s_real)
    return (torch.where(own, tbl_nxt.gather(-1, idx), a_nxt),
            torch.where(own, tbl_lab.gather(-1, idx), a_lab))


def pointer_double_rank_shard_ref(q, a_ptr, a_dist, a_reach, base,
                                  tbl_ptr, tbl_dist, tbl_reach,
                                  s_real: int):
    """One ring step of the sharded list-ranking gather (3-table twin of
    :func:`pointer_double_shard_ref`)."""
    own, idx = _shard_own(q, base, s_real)
    return (torch.where(own, tbl_ptr.gather(-1, idx), a_ptr),
            torch.where(own, tbl_dist.gather(-1, idx), a_dist),
            torch.where(own, tbl_reach.gather(-1, idx), a_reach))
