"""Pointer-doubling rounds K1 and K2 as CUDA kernels for Hopper (mirrors
``repro/kernels/pointer_double.py``, whose Pallas ``pointer_double`` and
``pointer_double_rank`` they replace).

  ``pointer_double``       nxt' = nxt[nxt];  lab' = min(lab, lab[nxt])
                           (min-label connected components)
  ``pointer_double_rank``  ptr' = ptr[ptr];  dist' = dist + dist[ptr];
                           reach' = max(reach, reach[ptr])
                           (list ranking for circuit emission)

The kernels live in ``csrc/pointer_double.cu`` (design and bound in its
header comment), are built by :mod:`.build` at first use and called
through ``ctypes``.  Each wrapper checks its tensors (int32, 1-D, one
length, contiguous, one device, outputs apart from inputs) and then:

  * on CPU tensors, computes the plain twin of :mod:`.ref`;
  * on CUDA tensors, launches the kernel on the current stream, or
    raises.  No fallback: a failed build or launch is an error.

Outputs go to separate buffers (``out=``, else freshly allocated), so a
caller running many rounds ping-pongs two sets.  ``launches`` on each
wrapper counts the kernel launches it made (twin calls do not count).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from . import build
from .ref import pointer_double_ref, pointer_double_rank_ref

_fns: dict = {}


def _kernel_fn(symbol: str, n_ptrs: int):
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(build.load("pointer_double"), symbol)
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_longlong,
                                                    ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def _check(name: str, ins: Sequence[torch.Tensor],
           outs: Sequence[torch.Tensor]) -> None:
    n = ins[0].shape
    dev = ins[0].device
    for t in (*ins, *outs):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: tensors must be int32, got {t.dtype}")
        if t.dim() != 1 or t.shape != n:
            raise ValueError(f"{name}: tensors must all be 1-D of shape "
                             f"{tuple(n)}, got {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    nbytes = 4 * ins[0].numel()
    for o in outs:
        for t in (*ins, *(x for x in outs if x is not o)):
            a, b = o.data_ptr(), t.data_ptr()
            if nbytes and a < b + nbytes and b < a + nbytes:
                raise ValueError(
                    f"{name}: output overlaps another buffer; round k must "
                    f"read only round k-1 values, so ping-pong two sets")


def _launch(name: str, symbol: str, ins, outs) -> None:
    n = ins[0].numel()
    if n == 0:
        return
    fn = _kernel_fn(symbol, len(ins) + len(outs))
    with torch.cuda.device(ins[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in (*ins, *outs)), n, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")


def _device_rule(name: str, t: torch.Tensor) -> bool:
    """True → launch the kernel; False → the tensor is on the CPU."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")


def pointer_double(nxt: torch.Tensor, lab: torch.Tensor,
                   out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One min-label doubling round over the full table (K1).  ``nxt``,
    ``lab`` int32 [N] with ``0 ≤ nxt[i] < N``; returns ``(nxt', lab')``,
    written into ``out`` when given."""
    ins = (nxt, lab)
    if out is None:
        out = (torch.empty_like(nxt), torch.empty_like(lab))
    _check("pointer_double", ins, out)
    if not _device_rule("pointer_double", nxt):
        for o, r in zip(out, pointer_double_ref(nxt, lab)):
            o.copy_(r)
        return out
    _launch("pointer_double", "pd_pointer_double", ins, out)
    if nxt.numel():
        pointer_double.launches += 1
    return out


pointer_double.launches = 0


def pointer_double_rank(ptr: torch.Tensor, dist: torch.Tensor,
                        reach: torch.Tensor,
                        out: Optional[Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One list-ranking doubling round (K2).  ``ptr``/``dist``/``reach``
    int32 [N] (reach 0/1), ``0 ≤ ptr[i] < N``; halt nodes self-loop with
    dist 0.  Returns ``(ptr', dist', reach')``, written into ``out`` when
    given."""
    ins = (ptr, dist, reach)
    if out is None:
        out = tuple(torch.empty_like(t) for t in ins)
    _check("pointer_double_rank", ins, out)
    if not _device_rule("pointer_double_rank", ptr):
        for o, r in zip(out, pointer_double_rank_ref(ptr, dist, reach)):
            o.copy_(r)
        return out
    _launch("pointer_double_rank", "pd_pointer_double_rank", ins, out)
    if ptr.numel():
        pointer_double_rank.launches += 1
    return out


pointer_double_rank.launches = 0
