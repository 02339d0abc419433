"""Plain-torch twins of every kernel (mirrors ``repro/kernels/ref.py``).

The twins are what a kernel wrapper runs on CPU tensors, and what the
CUDA kernels are held against on the card: bit for bit for the integer
pointer-doubling rounds (``nxt``/``ptr`` entries must lie in ``[0, N)``),
within a float tolerance for the segment sum and attention, and by trip
count for the splice loops' test (it runs only inside a while node).
K1's and K2's kernels take packed records; ``pointer_double_ref`` and
``pointer_double_rank_ref`` stay the two- and three-array oracles that
mirror the reference, and ``pointer_double_packed_ref`` and
``pointer_double_rank_packed_ref`` are their packed forms.

The shard twins take the reference's single-shard form (``q`` [S],
``base`` [1], tables [T]) and also the port's all-shards form (``q``
[n, S], ``base`` [n], tables [n, T]), where row r is query shard r with
its own visiting table slice and base.
"""
from __future__ import annotations

import math

import torch


def segment_sum_sorted_ref(values: torch.Tensor, seg_ids: torch.Tensor,
                           num_segments: int) -> torch.Tensor:
    """values [N, D], seg_ids [N] int32 sorted ascending; ids outside
    ``[0, num_segments)`` are dropped (padding).  Sums in f32, like the
    Pallas kernel, and casts back to the values' dtype."""
    ok = (seg_ids >= 0) & (seg_ids < num_segments)
    idx = torch.where(ok, seg_ids, num_segments).to(torch.int64)
    out = torch.zeros(num_segments + 1, values.shape[1], dtype=torch.float32,
                      device=values.device)
    out.index_add_(0, idx, values.to(torch.float32))
    return out[:num_segments].to(values.dtype)


def pointer_double_ref(nxt: torch.Tensor, lab: torch.Tensor):
    """One pointer-doubling round: ``lab' = min(lab, lab[nxt])``;
    ``nxt' = nxt[nxt]``."""
    return nxt[nxt], torch.minimum(lab, lab[nxt])


def pointer_double_packed_ref(rec: torch.Tensor) -> torch.Tensor:
    """K1's twin on packed records: ``rec`` int32 [N, 2], row i =
    ``(nxt, lab)``; :func:`pointer_double_ref` on the two columns, packed
    again."""
    return torch.stack(pointer_double_ref(rec[:, 0], rec[:, 1]), 1)


def pointer_double_rank_ref(ptr: torch.Tensor, dist: torch.Tensor,
                            reach: torch.Tensor):
    """One list-ranking round: ``dist' = dist + dist[ptr]``;
    ``reach' = max(reach, reach[ptr])``; ``ptr' = ptr[ptr]``."""
    return ptr[ptr], dist + dist[ptr], torch.maximum(reach, reach[ptr])


def pointer_double_rank_packed_ref(rec: torch.Tensor) -> torch.Tensor:
    """K2's twin on packed records: ``rec`` int32 [N, 4], row i =
    ``(ptr, dist, reach, 0)``; :func:`pointer_double_rank_ref` on the
    three columns, packed again."""
    out = torch.zeros_like(rec)
    for j, col in enumerate(pointer_double_rank_ref(rec[:, 0], rec[:, 1],
                                                    rec[:, 2])):
        out[:, j] = col
    return out


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


def loop_condition_ref(changed: torch.Tensor, ctr: torch.Tensor,
                       rounds: int):
    """One test of a splice loop, the twin of ``loop_condition_kernel``
    (``csrc/graph_loop.cu``): ``ctr`` (int32, 0-d) holds the rounds run
    before this test, −1 before the first.  Returns ``(cond, ctr + 1)``,
    ``cond`` a 0-d bool: ``changed`` (bool, any shape) holds anywhere and
    fewer than ``rounds`` rounds ran.  The reference's ``cond``:
    ``changed & (rounds_left > 0)``."""
    ran = ctr + 1
    return changed.any() & (ran < rounds), ran


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q [B,S,H,D], k/v [B,T,H,D] (same head count — GQA is handled by the
    wrapper repeating kv heads).  Causal with S < T treats the queries as
    the suffix (offset T − S).  Scores in f32, masked with −1e30, softmax
    probabilities cast to v's dtype before the PV product."""
    S, D = q.shape[1], q.shape[3]
    T = k.shape[1]
    scores = torch.einsum("bshd,bthd->bhst", q, k).to(torch.float32)
    scores = scores / math.sqrt(D)
    if causal:
        mask = (torch.arange(T, device=q.device)[None, :]
                <= torch.arange(S, device=q.device)[:, None] + (T - S))
        scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)
