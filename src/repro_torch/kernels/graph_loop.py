"""The splice loops' CUDA while node, from ``csrc/graph_loop.cu``: the
reference's ``lax.while_loop`` around a splice round, whose ``cond`` is
at ``repro/core/phase1.py:322`` and ``repro/core/phase3.py:367, 701``.

``while_loop(body, changed, ctr, rounds, stream, pool)`` runs ``body``
while the bool tensor ``changed`` holds anywhere and fewer than
``rounds`` rounds ran, and leaves the rounds run in the int32 0-d
``ctr``.  ``body`` takes no argument and writes its results in place
(``changed`` among them).  The test before each round is
``loop_condition_kernel``, whose plain twin is
:func:`.ref.loop_condition_ref`; the wrapper checks its tensors and then:

  * on CUDA tensors, while the current stream is being captured into a
    CUDA graph, records one conditional node of type while: the test
    kernel for the first round, then the node, whose body is what
    ``body()`` issues on ``stream`` (its allocations routed to the
    ``torch.cuda.MemPool`` ``pool``), ended by the test kernel again.
    Nothing runs now; every replay of the graph runs the rounds its data
    needs.  Outside a capture, or if the node cannot be made, it raises;
    if ``body`` raises, its capture is closed first.
  * on CPU tensors it stands in for the node, for the tests: it loops on
    the host, the trip rule taken from the twin, and runs the rounds now.

``census(graph, bodies, device)`` counts the nodes of a recorded graph
(``gl_census``): by type, memcpys by direction, kernel nodes by function
name, the while bodies that ``while_loop`` returned included.

``stream`` (not the one being captured) and ``pool`` must be made before
the capture starts, and the pool must live as long as the graph: the
body's kernels run on its memory at every replay.  ``while_loop.launches`` counts the
test kernels launched into a recording, two a loop; the device runs the
second once a round, which the counter cannot see.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Sequence

import torch

from . import build
from .ref import loop_condition_ref

_VOID = ctypes.c_void_p
_ARGS = {
    "gl_load": (),
    "gl_while_begin": (_VOID, _VOID, ctypes.c_longlong, _VOID, ctypes.c_int,
                       ctypes.POINTER(_VOID),
                       ctypes.POINTER(ctypes.c_ulonglong)),
    "gl_body_begin": (_VOID, _VOID),
    "gl_body_end": (_VOID, ctypes.c_ulonglong, _VOID, ctypes.c_longlong,
                    _VOID, ctypes.c_int),
    "gl_census": (_VOID, ctypes.POINTER(_VOID), ctypes.c_longlong,
                  ctypes.c_char_p, ctypes.c_longlong,
                  ctypes.POINTER(ctypes.c_longlong)),
}


def _call(symbol: str, *args) -> int:
    return build.function("graph_loop", symbol, _ARGS[symbol])(*args)


def _check(symbol: str, err: int) -> None:
    if err != 0:
        describe = getattr(build.load("graph_loop"), "gl_error_string")
        describe.restype = ctypes.c_char_p
        describe.argtypes = [ctypes.c_int]
        raise RuntimeError(f"graph_loop.{symbol}: CUDA error {err} "
                           f"({describe(err).decode()})")


def load(device: torch.device) -> None:
    """Build the library and load its kernel on ``device`` (outside any
    capture: a module loaded lazily would load mid-capture)."""
    with torch.cuda.device(device):
        _check("gl_load", _call("gl_load"))


def census(graph: int, bodies: Sequence[int], device: torch.device
           ) -> Dict[str, int]:
    """Node counts of the ``cudaGraph_t`` ``graph`` (an address, as
    ``torch.cuda.CUDAGraph.raw_cuda_graph()`` gives it) and of the while
    bodies ``bodies`` recorded into it (:func:`while_loop`'s returns;
    valid while the graph is): ``kernel``,
    ``memcpy`` and ``memcpy_<dir>`` (``htod``, ``dtoh``, ``dtod``,
    ``htoh``, ``unknown``), ``memset``, ``host``, ``conditional``,
    ``while_body``, ``event_record``, ``event_wait``, ``empty``,
    ``child_graph``, ``mem_alloc``, ``mem_free``, ``other``, and
    ``kernel:<function name>`` for each kernel (mangled as the driver
    names it; ``kernel:?`` unnamed), and ``error:<call>:<code>`` for
    each query that failed.  Raises ``RuntimeError`` if the driver's
    calls cannot be found."""
    need = ctypes.c_longlong(0)
    cap = 1 << 20
    body_array = (_VOID * max(len(bodies), 1))(*bodies)
    with torch.cuda.device(device):
        while True:
            buf = ctypes.create_string_buffer(cap)
            err = _call("gl_census", graph, body_array, len(bodies), buf,
                        cap, ctypes.byref(need))
            if err != -1:
                break
            cap = int(need.value)
    _check("gl_census", err)
    out = {}
    for line in buf.value.decode().splitlines():
        key, _, count = line.rpartition("\t")
        out[key] = int(count)
    return out


def _host_while(body: Callable[[], None], changed: torch.Tensor,
                ctr: torch.Tensor, rounds: int) -> None:
    """The node's stand-in: the same tests, made by the twin on the host."""
    cond, ran = loop_condition_ref(changed, torch.tensor(-1, dtype=ctr.dtype),
                                   rounds)
    while bool(cond):
        body()
        cond, ran = loop_condition_ref(changed, ran, rounds)
    ctr.copy_(ran)


def while_loop(body: Callable[[], None], changed: torch.Tensor,
               ctr: torch.Tensor, rounds: int,
               stream: Optional["torch.cuda.Stream"] = None,
               pool: Optional["torch.cuda.MemPool"] = None) -> Optional[int]:
    """Run or record ``body`` as a bounded while loop (module docstring).
    Recording, returns the address of the node's body graph (for
    :func:`census`); on the CPU, None."""
    if changed.dtype != torch.bool or not changed.is_contiguous():
        raise TypeError("while_loop: changed must be a contiguous bool "
                        "tensor")
    if ctr.dtype != torch.int32 or ctr.dim() != 0:
        raise TypeError("while_loop: ctr must be a 0-d int32 tensor")
    if ctr.device != changed.device:
        raise ValueError(f"while_loop: tensors on {ctr.device} and "
                         f"{changed.device}")
    if changed.device.type == "cpu":
        _host_while(body, changed, ctr, int(rounds))
        return None
    dev = changed.device
    if not torch.cuda.is_current_stream_capturing():
        raise RuntimeError("while_loop records a CUDA graph node: call it "
                           "while the current stream is being captured")
    if stream is None or pool is None:
        raise ValueError("while_loop on the card needs the body's stream "
                         "and memory pool")
    if stream == torch.cuda.current_stream(dev):
        raise ValueError("while_loop: the body's stream is the one being "
                         "captured")
    args = (changed.data_ptr(), changed.numel(), ctr.data_ptr(), int(rounds))
    with torch.cuda.device(dev):
        body_graph, handle = _VOID(), ctypes.c_ulonglong()
        _check("gl_while_begin", _call(
            "gl_while_begin", torch.cuda.current_stream(dev).cuda_stream,
            *args, ctypes.byref(body_graph), ctypes.byref(handle)))
        while_loop.launches += 1
        _check("gl_body_begin",
               _call("gl_body_begin", stream.cuda_stream, body_graph))
        try:
            with torch.cuda.stream(stream), torch.cuda.use_mem_pool(pool,
                                                                     dev):
                body()
        except BaseException:
            # close the body, so that the enclosing capture stays valid;
            # the body's error is the one to see
            _call("gl_body_end", stream.cuda_stream, handle, *args)
            raise
        _check("gl_body_end", _call("gl_body_end", stream.cuda_stream,
                                    handle, *args))
        while_loop.launches += 1
    return body_graph.value


while_loop.launches = 0
