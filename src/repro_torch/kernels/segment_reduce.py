"""Sorted segment sum K5 as a CUDA kernel for Hopper (mirrors
``repro/kernels/segment_reduce.py``, whose Pallas kernel it replaces).

``segment_sum_sorted(values, seg_ids, num_segments)`` sums the rows of
``values`` [N, D] (f32, f16 or bf16) by the sorted int32 ``seg_ids`` [N]
into [num_segments, D]: the sum is taken in f32 and cast back, ids outside
``[0, num_segments)`` are padding, empty segments give zeros.

The kernel lives in ``csrc/segment_reduce.cu`` (design and bound in its
header comment), is built by :mod:`.build` at first use and called
through ``ctypes``.  The wrapper checks its tensors and then:

  * on CPU tensors, computes the plain twin of :mod:`.ref`;
  * on CUDA tensors, launches the kernel on the current stream, or
    raises.  No fallback: a failed build or launch is an error.

On the card a call runs one CUDA launch per level of the row-tiled
reduce-by-key (the tiles, then their carries, until one tile is left);
the wrapper allocates the carries' workspace with ``torch.empty``.
``segment_sum_sorted.launches`` counts one per call that launched,
however many levels it ran (twin calls, and calls with no rows, do not
count).  The ids must be sorted; the wrapper does not check it (that
would cost a pass over them), and unsorted ids give wrong sums.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import segment_sum_sorted_ref

#: the kernel's dtype codes
DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
         ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)
_WORK_ARGS = (ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
              ctypes.POINTER(ctypes.c_longlong))


def _check(values: torch.Tensor, seg_ids: torch.Tensor,
           num_segments: int) -> None:
    if values.dtype not in DTYPES:
        raise TypeError(f"segment_sum_sorted: values must be f32, f16 or "
                        f"bf16, got {values.dtype}")
    if seg_ids.dtype != torch.int32:
        raise TypeError(f"segment_sum_sorted: seg_ids must be int32, got "
                        f"{seg_ids.dtype}")
    if values.dim() != 2 or seg_ids.shape != values.shape[:1]:
        raise ValueError(f"segment_sum_sorted: values must be [N, D] and "
                         f"seg_ids [N], got {tuple(values.shape)} and "
                         f"{tuple(seg_ids.shape)}")
    if seg_ids.device != values.device:
        raise ValueError(f"segment_sum_sorted: tensors on {values.device} "
                         f"and {seg_ids.device}")
    if not (values.is_contiguous() and seg_ids.is_contiguous()):
        raise ValueError("segment_sum_sorted: tensors must be contiguous")
    if num_segments < 0:
        raise ValueError(f"segment_sum_sorted: num_segments={num_segments}")


def segment_sum_sorted(values: torch.Tensor, seg_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """values [N, D] float, seg_ids [N] int32 sorted ascending; ids
    outside ``[0, num_segments)`` are padding.  Returns
    [num_segments, D] in the values' dtype (K5)."""
    num_segments = int(num_segments)
    _check(values, seg_ids, num_segments)
    if values.device.type == "cpu":
        return segment_sum_sorted_ref(values, seg_ids, num_segments)
    if values.device.type != "cuda":
        raise ValueError(f"segment_sum_sorted: unsupported device "
                         f"{values.device}")
    n, d = values.shape
    if n == 0:
        return torch.zeros(num_segments, d, dtype=values.dtype,
                           device=values.device)
    out = torch.empty(num_segments, d, dtype=values.dtype,
                      device=values.device)
    if out.numel() == 0:
        return out
    dtype = DTYPES[values.dtype]
    work_bytes = ctypes.c_longlong()
    if build.function("segment_reduce", "sr_workspace_bytes", _WORK_ARGS)(
            n, d, dtype, ctypes.byref(work_bytes)) != 0:
        raise RuntimeError(f"segment_sum_sorted: no workspace size for "
                           f"[{n}, {d}] {values.dtype}")
    work = torch.empty(work_bytes.value, dtype=torch.uint8,
                       device=values.device)
    fn = build.function("segment_reduce", "sr_segment_sum_sorted", _ARGS)
    build.launch("segment_sum_sorted", fn, values.device, values.data_ptr(),
                 seg_ids.data_ptr(), out.data_ptr(), n, d, num_segments,
                 dtype, work.data_ptr() if work.numel() else None)
    segment_sum_sorted.launches += 1
    return out


segment_sum_sorted.launches = 0
