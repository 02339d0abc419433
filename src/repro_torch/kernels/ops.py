"""Public wrappers around the kernels (mirrors ``repro/kernels/ops.py``).

Models call these.  Each routes by the port's device rule: the CUDA
kernel runs on CUDA tensors, the plain twin of :mod:`.ref` on CPU
tensors.  The reference's ``use_kernel`` switch, its ``on_tpu`` probe and
its TPU-only routing of more than 4,096 segments to the jnp oracle (a
VMEM limit) have no counterpart: no shape sends a CUDA tensor to a twin.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import flash_attention as _flash
from . import pointer_double as _pdouble
from . import segment_reduce as _segsum


def segment_sum_sorted(values: torch.Tensor, seg_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Sorted-segment sum: values [N, D], seg_ids [N] int32 sorted
    ascending, ids outside ``[0, num_segments)`` padding → [S, D] (K5)."""
    return _segsum.segment_sum_sorted(values, seg_ids, num_segments)


def pointer_double(nxt: torch.Tensor, lab: torch.Tensor):
    """One pointer-doubling round: ``(nxt[nxt], min(lab, lab[nxt]))``
    (K1).  The kernel runs on packed ``(nxt, lab)`` records: the arrays
    are packed, and the result unpacked into two contiguous arrays."""
    rec = _pdouble.pointer_double(torch.stack([nxt, lab], 1))
    return tuple(rec.t().contiguous())


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """GQA flash attention: q [B,S,Hq,D], k/v [B,T,Hkv,D] → [B,S,Hq,D]
    (K6; the kernel reads the grouped KV heads without repeating them)."""
    return _flash.flash_attention(q, k, v, causal=causal)


def launch_counts() -> Dict[str, int]:
    """Each kernel wrapper's launches so far (K1–K6), by wrapper name: a
    recording reads them around itself to count what its graph holds."""
    return {fn.__name__: fn.launches for fn in (
        _pdouble.pointer_double, _pdouble.pointer_double_rank,
        _pdouble.pointer_double_shard, _pdouble.pointer_double_rank_shard,
        _segsum.segment_sum_sorted, _flash.flash_attention)}
