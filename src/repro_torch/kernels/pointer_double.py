"""Pointer-doubling rounds K1–K4 as CUDA kernels for Hopper (mirrors
``repro/kernels/pointer_double.py``, whose four Pallas kernels they
replace).

  ``pointer_double``       nxt' = nxt[nxt];  lab' = min(lab, lab[nxt])
                           (min-label connected components), on packed
                           records: int32 [N, 2], row i = (nxt, lab), so
                           a gather reads one sector
  ``pointer_double_rank``  ptr' = ptr[ptr];  dist' = dist + dist[ptr];
                           reach' = max(reach, reach[ptr])
                           (list ranking for circuit emission), on packed
                           records: int32 [N, 4], row i = (ptr, dist,
                           reach, 0), so a gather reads one sector
  ``pointer_double_shard``       one ring step of the sharded CC: queries
                                 owned by the visiting table slice take
                                 its (nxt, lab), the rest keep theirs
  ``pointer_double_rank_shard``  the 3-table (ptr, dist, reach) twin

The shard wrappers take the reference's single-shard form (``q`` [S],
``base`` [1], tables [T]) or all n query shards at once (``q`` [n, S],
``base`` [n], tables [n, T]): one launch serves one whole ring step.

The kernels live in ``csrc/pointer_double.cu`` (design and bound in its
header comment), are built by :mod:`.build` at first use and called
through ``ctypes``.  Each wrapper checks its tensors (int32, shapes,
contiguous, one device, outputs apart from every other buffer) and then:

  * on CPU tensors, computes the plain twin of :mod:`.ref`;
  * on CUDA tensors, launches the kernel on the current stream, or
    raises.  No fallback: a failed build or launch is an error.

Outputs go to separate buffers (``out=``, else freshly allocated), so a
caller running many rounds ping-pongs two sets.  ``launches`` on each
wrapper counts the kernel launches it made (twin calls do not count);
every call, kernel or twin, is one ``pallas_call`` in an open census
(``core/capture.py``).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from ..core import capture
from . import build
from .ref import (pointer_double_packed_ref,
                  pointer_double_rank_packed_ref,
                  pointer_double_rank_shard_ref, pointer_double_shard_ref)

#: the C entry points' trailing arguments after the tensor pointers
_ROUND_ARGS = (ctypes.c_longlong,)                      # n
_SHARD_ARGS = (ctypes.c_longlong, ctypes.c_longlong,    # rows, cols,
               ctypes.c_longlong, ctypes.c_int)         # tcols, s_real
#: gridDim.y holds the shard rows of one launch
_MAX_ROWS = 65535


def _check_tensor(name: str, t: torch.Tensor, dev: torch.device) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: tensors must be int32, got {t.dtype}")
    if t.device != dev:
        raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensors must be contiguous")


def _check_apart(name: str, ins: Sequence[torch.Tensor],
                 outs: Sequence[torch.Tensor]) -> None:
    """Every output overlaps no input and no other output."""
    for o in outs:
        for t in (*ins, *(x for x in outs if x is not o)):
            a, b = o.data_ptr(), t.data_ptr()
            na, nb = 4 * o.numel(), 4 * t.numel()
            if na and nb and a < b + nb and b < a + na:
                raise ValueError(
                    f"{name}: output overlaps another buffer; step k must "
                    f"read only step k-1 values, so ping-pong two sets")


def _check_shard(name: str, q: torch.Tensor, carries, base: torch.Tensor,
                 tables, outs, s_real: int) -> None:
    """Shapes of a shard ring step: ``q``, carries and outputs all [S] or
    all [n, S]; ``base`` [1] or [n]; tables all [T] or [n, T] with
    ``0 ≤ s_real ≤ T`` and T ≥ 1."""
    for t in (q, *carries, base, *tables, *outs):
        _check_tensor(name, t, q.device)
    if q.dim() not in (1, 2):
        raise ValueError(f"{name}: queries must be [S] or [n, S], got "
                         f"{tuple(q.shape)}")
    rows = q.shape[0] if q.dim() == 2 else 1
    for t in (*carries, *outs):
        if t.shape != q.shape:
            raise ValueError(f"{name}: carries and outputs must have the "
                             f"queries' shape {tuple(q.shape)}, got "
                             f"{tuple(t.shape)}")
    if base.shape != (rows,):
        raise ValueError(f"{name}: base must be [{rows}], got "
                         f"{tuple(base.shape)}")
    tshape = tables[0].shape
    if tables[0].dim() != q.dim() or tshape[:-1] != q.shape[:-1] \
            or tshape[-1] < 1 or any(t.shape != tshape for t in tables):
        raise ValueError(f"{name}: tables must all be [T] or [n, T] with "
                         f"T ≥ 1 and n query rows, got "
                         f"{[tuple(t.shape) for t in tables]}")
    if not 0 <= s_real <= tshape[-1]:
        raise ValueError(f"{name}: s_real={s_real} outside [0, "
                         f"{tshape[-1]}]")
    if rows > _MAX_ROWS:
        raise ValueError(f"{name}: {rows} shard rows, over {_MAX_ROWS}")
    _check_apart(name, (q, *carries, base, *tables), outs)


def _argtypes(n_ptrs: int, scalars: Tuple) -> Tuple:
    """A C entry point's argument types: ``n_ptrs`` tensor pointers, the
    trailing ``scalars``, then the stream."""
    return (ctypes.c_void_p,) * n_ptrs + scalars + (ctypes.c_void_p,)


def _device_rule(name: str, t: torch.Tensor) -> bool:
    """True → launch the kernel; False → the tensor is on the CPU."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")


def _check_records(name: str, rec: torch.Tensor, out: torch.Tensor,
                   width: int) -> None:
    """``rec`` and ``out``: int32 [N, width], contiguous, on one device,
    apart; on the card also aligned to the record (one load a record)."""
    for t in (rec, out):
        _check_tensor(name, t, rec.device)
        if t.dim() != 2 or t.shape[1] != width or t.shape != rec.shape:
            raise ValueError(f"{name}: records must both be [N, {width}], "
                             f"got {tuple(rec.shape)} and "
                             f"{tuple(out.shape)}")
        if t.device.type == "cuda" and t.data_ptr() % (4 * width):
            raise ValueError(f"{name}: records must be {4 * width}-byte "
                             f"aligned")
    _check_apart(name, (rec,), (out,))


def _round(name: str, symbol: str, twin, rec: torch.Tensor,
           out: Optional[torch.Tensor], width: int):
    """One doubling round on [N, ``width``] records through the C entry
    ``symbol`` (the twin on CPU tensors); returns ``(out, launched)``."""
    capture.note_kernel(name)
    if out is None:
        out = torch.empty_like(rec)
    _check_records(name, rec, out, width)
    if not _device_rule(name, rec):
        out.copy_(twin(rec))
        return out, False
    if rec.shape[0] == 0:
        return out, False
    fn = build.function("pointer_double", symbol, _argtypes(2, _ROUND_ARGS))
    build.launch(name, fn, rec.device, rec.data_ptr(), out.data_ptr(),
                 rec.shape[0])
    return out, True


def pointer_double(rec: torch.Tensor,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One min-label doubling round over the full table (K1) on packed
    records.  ``rec`` int32 [N, 2], row i = ``(nxt, lab)``,
    ``0 ≤ nxt < N``.  Returns the next round's records, written into
    ``out`` when given."""
    out, launched = _round("pointer_double", "pd_pointer_double",
                           pointer_double_packed_ref, rec, out, 2)
    pointer_double.launches += int(launched)
    return out


pointer_double.launches = 0


def pointer_double_rank(rec: torch.Tensor,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One list-ranking doubling round (K2) on packed records.  ``rec``
    int32 [N, 4], row i = ``(ptr, dist, reach, 0)`` (reach 0/1),
    ``0 ≤ ptr < N``; halt nodes self-loop with dist 0.  Returns the next
    round's records, written into ``out`` when given."""
    out, launched = _round("pointer_double_rank", "pd_pointer_double_rank",
                           pointer_double_rank_packed_ref, rec, out, 4)
    pointer_double_rank.launches += int(launched)
    return out


pointer_double_rank.launches = 0


def _shard_step(name: str, symbol: str, twin, q, carries, base, tables,
                s_real: int, out):
    capture.note_kernel(name)
    s_real = int(s_real)
    if out is None:
        out = tuple(torch.empty_like(a) for a in carries)
    _check_shard(name, q, carries, base, tables, out, s_real)
    if not _device_rule(name, q):
        for o, r in zip(out, twin(q, *carries, base, *tables,
                                  s_real=s_real)):
            o.copy_(r)
        return out, False
    if q.numel() == 0:
        return out, False
    rows = q.shape[0] if q.dim() == 2 else 1
    ptrs = (q, *carries, base, *tables, *out)
    fn = build.function("pointer_double", symbol,
                        _argtypes(len(ptrs), _SHARD_ARGS))
    build.launch(name, fn, q.device, *(t.data_ptr() for t in ptrs), rows,
                 q.shape[-1], tables[0].shape[-1], s_real)
    return out, True


def pointer_double_shard(q: torch.Tensor, a_nxt: torch.Tensor,
                         a_lab: torch.Tensor, base: torch.Tensor,
                         tbl_nxt: torch.Tensor, tbl_lab: torch.Tensor,
                         s_real: int,
                         out: Optional[Tuple[torch.Tensor,
                                             torch.Tensor]] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ring step of the sharded CC doubling round (K3).

    ``q``/``a_nxt``/``a_lab`` int32 queries and answers so far, [S] or
    [n, S]; ``base`` int32 [1] or [n], the visiting slice's global offset
    per query row; ``tbl_nxt``/``tbl_lab`` [T] or [n, T], the visiting
    slices (rows ≥ ``s_real`` are padding).  Queries with
    ``base ≤ q < base + s_real`` take ``tbl[q − base]``, the rest keep
    their answers.  Returns ``(a_nxt', a_lab')``, written into ``out``
    when given."""
    out, launched = _shard_step(
        "pointer_double_shard", "pd_pointer_double_shard",
        pointer_double_shard_ref, q, (a_nxt, a_lab), base,
        (tbl_nxt, tbl_lab), s_real, out)
    pointer_double_shard.launches += int(launched)
    return out


pointer_double_shard.launches = 0


def pointer_double_rank_shard(q: torch.Tensor, a_ptr: torch.Tensor,
                              a_dist: torch.Tensor, a_reach: torch.Tensor,
                              base: torch.Tensor, tbl_ptr: torch.Tensor,
                              tbl_dist: torch.Tensor,
                              tbl_reach: torch.Tensor, s_real: int,
                              out: Optional[Tuple[torch.Tensor, torch.Tensor,
                                                  torch.Tensor]] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """One ring step of the sharded list-ranking round (K4): the 3-table
    ``(ptr, dist, reach)`` twin of :func:`pointer_double_shard`.  The
    caller combines after the full rotation (``ptr = a_ptr``,
    ``dist += a_dist``, ``reach = max(reach, a_reach)``)."""
    out, launched = _shard_step(
        "pointer_double_rank_shard", "pd_pointer_double_rank_shard",
        pointer_double_rank_shard_ref, q, (a_ptr, a_dist, a_reach), base,
        (tbl_ptr, tbl_dist, tbl_reach), s_real, out)
    pointer_double_rank_shard.launches += int(launched)
    return out


pointer_double_rank_shard.launches = 0
