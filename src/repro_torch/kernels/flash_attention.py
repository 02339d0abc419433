"""Flash attention K6 as a CUDA kernel for Hopper (mirrors
``repro/kernels/flash_attention.py``, whose Pallas kernel it replaces).

``flash_attention(q, k, v, causal)`` takes q [B, S, Hq, D] and k/v
[B, T, Hkv, D] with Hq a multiple of Hkv (grouped-query attention: query
head h reads KV head ``h // (Hq // Hkv)``) and returns [B, S, Hq, D] in
q's dtype.  Causal with S < T treats the queries as the suffix of the
keys (offset T − S).  f32 with D ∈ {16, 32, 64, 128} or bf16 with
D ∈ {32, 64, 128} (``HEAD_DIMS``), any S and T (T ≥ S when causal).

The kernel lives in ``csrc/flash_attention.cu`` (design and bound in its
header comment), is built by :mod:`.build` at first use and called
through ``ctypes``.  The wrapper checks its tensors and then:

  * on CPU tensors, repeats the KV heads and computes the plain twin
    ``flash_attention_ref`` of :mod:`.ref`;
  * on CUDA tensors, launches the kernel on the current stream, which
    reads the grouped KV heads in place, or raises.  No fallback.

``flash_attention.launches`` counts the kernel launches (twin calls do
not count).
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import flash_attention_ref

#: the kernel's dtype codes
DTYPES = {torch.float32: 0, torch.bfloat16: 2}
#: the head dims the kernel is instantiated for, by dtype (f32 also
#: takes the reduced configurations' 16; a bf16 row of 32 bytes would
#: need a TMA swizzle of its own, and no bf16 configuration has it)
HEAD_DIMS = {torch.float32: (16, 32, 64, 128),
             torch.bfloat16: (32, 64, 128)}
_ARGS = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 8
         + (ctypes.c_void_p,))
#: the f32 grid's y (heads) and z (batch) limit (the bf16 kernel's grid
#: puts the batch in y and the query blocks in z, and rejects what is
#: over)
_MAX_GRID_YZ = 65535


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool) -> None:
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must all be f32 or all "
                        f"bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q must be [B,S,Hq,D] and k, v "
                         f"[B,T,Hkv,D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, Hq, D = q.shape
    _, T, Hkv, Dk = k.shape
    if k.shape[0] != B or Dk != D:
        raise ValueError(f"flash_attention: batch or head dim differ: "
                         f"{tuple(q.shape)} against {tuple(k.shape)}")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"flash_attention: {Hq} query heads are not a "
                         f"multiple of {Hkv} KV heads")
    if causal and T < S:
        raise ValueError(f"flash_attention: causal needs T ≥ S, got "
                         f"S={S}, T={T}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_attention: tensors on {q.device}, "
                         f"{k.device}, {v.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q [B,S,Hq,D], k/v [B,T,Hkv,D] → [B,S,Hq,D] (K6)."""
    _check(q, k, v, causal)
    if q.device.type == "cpu":
        rep = q.shape[2] // k.shape[2]
        if rep > 1:
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        return flash_attention_ref(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS[q.dtype]:
        raise ValueError(f"flash_attention: head dim {D} not in "
                         f"{HEAD_DIMS[q.dtype]} for {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             f"and 16-byte aligned")
    if max(B, Hq) > _MAX_GRID_YZ:
        raise ValueError(f"flash_attention: batch {B} or {Hq} heads over "
                         f"the grid's {_MAX_GRID_YZ}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = build.function("flash_attention", "fa_flash_attention", _ARGS)
    build.launch("flash_attention", fn, q.device, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), B, S, T, Hq, Hkv, D,
                 int(causal), DTYPES[q.dtype])
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
