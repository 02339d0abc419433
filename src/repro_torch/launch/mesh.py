"""The partition mesh of the Euler engine over ``torch.distributed``
(counterpart of ``repro/launch/mesh.py::make_part_mesh``).

The reference lays its partitions on a 1-D device mesh, one a device, and
runs every superstep in one ``shard_map`` program whose exchanges are
``all_to_all``, ``ppermute``, ``psum`` and ``all_gather``.  Here a mesh
is a process group of ``world`` ranks, each holding ``m = n_parts //
world`` consecutive partitions as the rows of its tensors (rank r holds
global partitions ``r·m … r·m + m − 1``).  ``m = 1`` is the reference's
layout; ``m > 1`` is the one-device engine's rows carried over, so that a
world of one rank runs the same code as a world of eight.

:func:`make_part_mesh` never initialises a group: the caller does
(``torch.distributed.run``, or ``init_process_group`` with its own store),
and it never moves the engine to the CPU on its own.  Under NCCL the
device is ``cuda:LOCAL_RANK``; a gloo group runs CPU tensors, and only
when the caller asks for ``device="cpu"``.

NCCL and the fused run.  The fused run records the whole solve as one
CUDA graph whose sharded splice loop is a CUDA while node holding ring
steps (``core/capture.py``).  NCCL's point-to-point kernel records into
a while node's body only with ``NCCL_GRAPH_MIXING_SUPPORT=0`` (an H100,
NCCL 2.27: otherwise ending the capture fails with an invalid
argument), which NCCL reads when it makes its first communicator, and
under which a communicator may not have a graph launch outstanding
while another launch, captured or not, is issued.  So an NCCL mesh
needs that variable set to ``0`` before the group's first collective
(:func:`make_part_mesh` raises otherwise), and the solver waits for each
solve over a mesh before it returns (``EulerSolver.solve_async``).  The
group's first NCCL call must not be a recorded one (the fused run's eager
warm-up makes it first), and ``destroy_process_group`` waits for every
CUDA graph that holds the group's kernels: drop the mesh's solvers
before destroying the group.

:class:`PartMesh`'s collectives are the engine's exchanges (``core/
engine.py``, ``core/phase3.py``); each is one ``torch.distributed`` call,
made whatever the world's size (a world of one rank still calls them, so
the card tests the path), counted in :attr:`PartMesh.calls` and noted in
the open census (``core/capture.py``) as ``dist:<kind>``:

  * ``all_to_all`` — a tiled exchange of send lanes, source-major on the
    receiving side (``all_to_all_single``);
  * ``ring`` — one step of the partition ring i → i+1: the local rows
    roll by one and the last row goes to rank + 1
    (``all_to_all_single`` whose only nonzero split is the neighbour;
    ``send`` to one's own rank raises, and gloo's ``batch_isend_irecv``
    fails at world 1);
  * ``all_reduce`` — the reference's ``psum`` (sum, or max of flags);
  * ``pmax`` — the largest of a value over the ranks (``all_reduce``
    with ``MAX``): the byte budget's one charge after a recording
    (``EulerSolver._true_up``), which the reference's one controller
    does not need;
  * ``all_gather`` — the reference's tiled ``all_gather``
    (``all_gather_into_tensor``);
  * ``fetch`` — the gather of a sharded output that the reference's host
    fetch makes outside its program (flags, metrics, the rank shards
    under ``gather_circuit=False``), and the eager path's log gathers;
  * ``broadcast`` — rank 0's orders to the other ranks: the next
    serving dispatch, and the autotuner's recordings, pins, drops and
    tightens (``launch/serve.py::MicroBatcher``), which the reference's
    one controller does not need.

Each call also adds the bytes it sends from this rank to
:attr:`PartMesh.sent_bytes` under its kind: the whole send buffer of an
``all_to_all`` (its chunk to this rank included, as the reference's
operand is), the row a ring step sends, the tensor an ``all_reduce``
reduces (or maximizes), the shard a gather sends.  The dry run (``launch/dryrun.py``)
reports them where the reference parses the collectives of its HLO.

The production mesh (the counterpart of the reference's
``make_production_mesh`` and ``make_test_mesh``) is a
``torch.distributed.device_mesh.DeviceMesh`` over the world:
:func:`make_production_mesh` ``(16, 16)`` ``("data", "model")`` or,
multi-pod, ``(2, 16, 16)`` ``("pod", "data", "model")``;
:func:`make_test_mesh` ``(n // tp, tp)``.  Neither initialises a group.
The Euler engine lays one partition on each device of such a mesh, its
axes flattened row-major (:func:`part_mesh_of`), as the reference's
``P(axes, None)`` does.  A world of torch's ``fake`` backend (one rank
of a production world in one process, the dry run's) moves no data:
its :class:`PartMesh` zero-fills what it receives, so what a rank reads
does not depend on what the backend leaves in the receive buffers
(torch 2.11's ``fake`` leaves them as allocated, 2.13's copies the
input in), and a zero mask receives nothing.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from collections import Counter
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from ..analysis.graph_audit import RETURN_RINGS
from ..core import capture

# torch ≥ 2.13 deprecates the name in favour of ``all_gather_single``,
# which the card's torch may lack; the call is the same
warnings.filterwarnings(
    "ignore", message=r".*all_gather_into_tensor.*deprecated",
    category=FutureWarning)


def _wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a collective carries it: bool as uint8 (same bytes)."""
    x = x.contiguous()
    return x.view(torch.uint8) if x.dtype == torch.bool else x


def _unwire(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.view(torch.bool) if dtype == torch.bool else x


@dataclasses.dataclass(eq=False)
class PartMesh:
    """``n_parts`` partitions over the ``world`` ranks of ``group`` (None:
    the default group), ``m`` a rank, this rank holding rows ``first …
    first + m − 1`` of the global partition axis, its tensors on
    ``device``.  Compared by identity: a solver's programs belong to
    its mesh."""

    group: Optional[dist.ProcessGroup]
    rank: int
    world: int
    n_parts: int
    device: torch.device
    backend: str
    calls: Counter = dataclasses.field(default_factory=Counter)
    sent_bytes: Counter = dataclasses.field(default_factory=Counter)
    last_call: Optional[str] = None

    #: the mesh's one axis, as the reference names a partition mesh's
    mesh_dim_names = ("part",)

    @property
    def shape(self) -> Tuple[int]:
        """The mesh's shape, ``(world,)``: a 1-D mesh whose devices hold
        ``m`` partitions each (``parallel/sharding.py::local_shape``)."""
        return (self.world,)

    @property
    def m(self) -> int:
        """Partitions a rank."""
        return self.n_parts // self.world

    @property
    def first(self) -> int:
        """This rank's first global partition."""
        return self.rank * self.m

    @property
    def rows(self) -> slice:
        """This rank's rows of a ``[n_parts, ·]`` array."""
        return slice(self.first, self.first + self.m)

    def part_ids(self, dtype=torch.int32, batch: int = 1) -> torch.Tensor:
        """``[m]`` global partition index of each local row (the
        reference's ``axis_index``); for a batch of ``batch`` graphs, whose
        rows are (partition, graph) pairs, partition major, ``[m·B]``."""
        return torch.arange(self.first, self.first + self.m, dtype=dtype,
                            device=self.device).repeat_interleave(batch)

    def _count(self, kind: str, call: str,
               sent: Optional[torch.Tensor] = None) -> None:
        self.calls[kind] += 1
        if sent is not None:
            self.sent_bytes[kind] += sent.numel() * sent.element_size()
        self.last_call = call
        capture.note(f"dist:{kind}")

    def _received(self, out: torch.Tensor) -> torch.Tensor:
        """``out`` as a call left it; zeros under ``fake`` (module
        docstring)."""
        return out.zero_() if self.backend == "fake" else out

    # ------------------------------------------------------------------
    # the collectives
    # ------------------------------------------------------------------
    def all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        """Chunk r of ``send`` (its first axis cut in ``world`` equal
        chunks) to rank r; returns what every rank sent here, chunk r
        from rank r."""
        x = _wire(send)
        self._count("all_to_all", "all_to_all_single", x)
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group)
        return _unwire(self._received(out), send.dtype)

    def ring(self, x: torch.Tensor, dim: int = 0,
             batch: int = 1) -> torch.Tensor:
        """One ``ppermute`` step along the ring i → i+1 of ``x``'s
        partition axis ``dim`` (``m`` local rows): row i takes row i − 1,
        row 0 the last row of rank − 1.  For a batch of ``batch`` graphs
        the rows are (partition, graph) pairs, partition major, and a step
        moves the ``batch`` rows of a partition: the last partition's go
        to rank + 1."""
        rows = x.shape[dim]
        last = _wire(x.narrow(dim, rows - batch, batch)).reshape(-1)
        self._count("ring", "all_to_all_single", last)
        got = torch.empty_like(last)
        sends = [0] * self.world
        recvs = [0] * self.world
        sends[(self.rank + 1) % self.world] = last.numel()
        recvs[(self.rank - 1) % self.world] = last.numel()
        dist.all_to_all_single(got, last, recvs, sends, group=self.group)
        shape = list(x.shape)
        shape[dim] = batch
        return torch.cat([_unwire(self._received(got), x.dtype).view(shape),
                          x.narrow(dim, 0, rows - batch)], dim)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks (a new tensor)."""
        out = x.clone()
        self._count("all_reduce", "all_reduce", out)
        dist.all_reduce(out, group=self.group)
        return out

    def any(self, flags: torch.Tensor) -> torch.Tensor:
        """Whether each bool of ``flags`` holds on any rank."""
        out = flags.to(torch.int32)
        self._count("all_reduce", "all_reduce", out)
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        return out > 0

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of ``x`` over the ranks (a new
        tensor), counted under ``pmax``."""
        out = x.clone()
        self._count("pmax", "all_reduce", out)
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        return out

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        w = _wire(x)
        out = torch.empty((self.world * w.shape[0], *w.shape[1:]),
                          dtype=w.dtype, device=w.device)
        dist.all_gather_into_tensor(out, w, group=self.group)
        return _unwire(self._received(out), x.dtype)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The tiled ``all_gather`` of ``x``'s first axis: ``[m, ·]`` →
        ``[n_parts, ·]``, rank order."""
        self._count("all_gather", "all_gather_into_tensor", x)
        return self._gather(x)

    def fetch(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`all_gather` of an output, counted apart (module
        docstring)."""
        self._count("fetch", "all_gather_into_tensor", x)
        return self._gather(x)

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as the mesh's rank 0 holds it, on every rank (in place;
        the serving loop's orders, ``launch/serve.py``).  Only rank 0's
        bytes count as sent."""
        self._count("broadcast", "broadcast", x if self.rank == 0 else None)
        src = 0 if self.group is None else dist.get_global_rank(self.group, 0)
        dist.broadcast(x, src, group=self.group)
        if self.rank:
            self._received(x)
        return x


#: the NCCL setting the fused run over an NCCL mesh needs (module
#: docstring)
NCCL_GRAPH_MIXING = ("NCCL_GRAPH_MIXING_SUPPORT", "0")


def _local_device(backend: str, device) -> torch.device:
    if backend == "nccl":
        name, value = NCCL_GRAPH_MIXING
        if os.environ.get(name) != value:
            raise RuntimeError(
                f"an NCCL partition mesh records NCCL calls inside CUDA "
                f"while nodes, which needs {name}={value} set before the "
                f"group's first collective (now "
                f"{os.environ.get(name)!r})")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))) \
            if device is None else torch.device(device)
        if dev.type != "cuda":
            raise ValueError(f"an NCCL group runs on the card; got "
                             f"device={device!r}")
        if not torch.cuda.is_available():
            raise RuntimeError("an NCCL group needs a CUDA device, and none "
                               "is available")
        return dev
    if backend == "gloo":
        if device is None or torch.device(device).type != "cpu":
            raise ValueError(
                "a gloo group carries the mesh on the CPU, and only when "
                "asked: pass device='cpu' (the card's mesh runs on NCCL)")
        return torch.device("cpu")
    if backend == "fake":
        if device is not None and torch.device(device).type == "cpu":
            return torch.device("cpu")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))) \
            if device is None else torch.device(device)
        if dev.type != "cuda" or not torch.cuda.is_available():
            raise RuntimeError(
                f"a fake group's mesh runs on the card unless the caller "
                f"passes device='cpu'; got device={device!r}, CUDA "
                f"available: {torch.cuda.is_available()}")
        return dev
    raise ValueError(f"the partition mesh runs on nccl, gloo or fake, not "
                     f"{backend!r}")


def make_part_mesh(n_parts: int, group: Optional[dist.ProcessGroup] = None,
                   device=None) -> PartMesh:
    """The 1-D partition mesh of ``n_parts`` partitions over the ranks of
    ``group`` (default: the default group), which the caller has
    initialised (under NCCL with ``NCCL_GRAPH_MIXING_SUPPORT=0`` set
    first: module docstring).  ``n_parts`` must divide by the world size.
    ``device``: default ``cuda:LOCAL_RANK`` under NCCL and ``fake``;
    ``"cpu"`` with gloo, and with ``fake`` when asked."""
    _require_group("make_part_mesh")
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    n_parts = int(n_parts)
    if n_parts < 1 or n_parts % world:
        raise ValueError(f"{n_parts} partitions do not divide over "
                         f"{world} ranks")
    backend = str(dist.get_backend(group))
    return PartMesh(group=group, rank=rank, world=world, n_parts=n_parts,
                    device=_local_device(backend, device), backend=backend)


def _require_group(what: str) -> None:
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"{what} needs an initialised process group "
            f"(torch.distributed.run, or init_process_group); it never "
            f"initialises one")


def _device_type(device) -> str:
    """``cuda`` unless the caller asks for the CPU."""
    return "cpu" if device is not None and \
        torch.device(device).type == "cpu" else "cuda"


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The production mesh over the world the caller initialised:
    ``(16, 16)`` ``("data", "model")`` = 256 devices, or with
    ``multi_pod`` ``(2, 16, 16)`` ``("pod", "data", "model")`` = 512
    (the reference's).  The world must have that many ranks; the dry run
    makes one of torch's ``fake`` backend.  On the card unless
    ``device="cpu"``."""
    from torch.distributed.device_mesh import init_device_mesh

    _require_group("make_production_mesh")
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(_device_type(device), shape,
                            mesh_dim_names=axes)


def make_test_mesh(n_devices: int = 0, tp: int = 1, device=None):
    """Small ``(n // tp, tp)`` ``("data", "model")`` mesh over the first
    ``n_devices`` ranks of the world (0: all of them), for tests and
    smoke runs.  On the card unless ``device="cpu"``."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    _require_group("make_test_mesh")
    world = dist.get_world_size()
    n = n_devices or world
    if n % tp or n > world:
        raise ValueError(f"{n} devices over tp={tp} in a world of {world}")
    shape, axes = (n // tp, tp), ("data", "model")
    if n == world:
        return init_device_mesh(_device_type(device), shape,
                                mesh_dim_names=axes)
    return DeviceMesh(_device_type(device), torch.arange(n).view(shape),
                      mesh_dim_names=axes)


def flat_axes(mesh) -> Tuple[str, ...]:
    """Every axis of ``mesh``, the Euler engine's one partition axis."""
    return tuple(mesh.mesh_dim_names)


def part_mesh_of(mesh) -> PartMesh:
    """The :class:`PartMesh` of a ``DeviceMesh`` with all its axes
    flattened row-major: one partition a device, as the reference's
    ``P(axes, None)`` lays them.  A mesh holding the whole world in rank
    order runs over the default group; any other over the group of
    ``DeviceMesh._flatten()``, whose ranks must number in the mesh's
    row-major order."""
    world = dist.get_world_size()
    ranks = mesh.mesh.flatten().tolist()
    if ranks == list(range(world)):
        group = None
    elif mesh.ndim == 1:
        group = mesh.get_group()
    else:
        group = mesh._flatten().get_group()
    pm = make_part_mesh(mesh.size(), group=group,
                        device="cpu" if mesh.device_type == "cpu" else None)
    if pm.rank != ranks.index(dist.get_rank()):
        raise ValueError(f"the mesh's group numbers its ranks otherwise "
                         f"than the mesh's row-major order {ranks}")
    return pm


def ring_calls(n_parts: int, schedule: dict) -> int:
    """Ring steps of one sharded Phase 3 (the census's ``ring_step``):
    each of the schedule's ``ppermute`` loops runs ``n_parts − 1`` steps,
    and the ``RETURN_RINGS`` whose queries travel home one more."""
    loops = schedule["ppermute"]
    return loops * (n_parts - 1) + (RETURN_RINGS if loops else 0)


def expected_calls(budget: dict, n_parts: int) -> dict:
    """The ``torch.distributed`` calls a fused solve's recording makes
    over a mesh, by :class:`PartMesh` kind, from
    ``core/engine.py::fused_collective_budget``: ``all_to_all`` its
    ``dynamic_all_to_all``, ``all_gather`` and ``all_reduce`` its
    ``all_gather`` and ``psum``, ``ring`` the steps of its ``ppermute``
    loops (:func:`ring_calls`).  ``fetch`` (the outputs' gathers) is not
    in the reference's program and not here."""
    out = {"all_to_all": budget["dynamic_all_to_all"],
           "all_gather": budget["all_gather"],
           "all_reduce": budget["psum"],
           "ring": 0}
    if "phase3" in budget:
        out["ring"] = ring_calls(n_parts, budget["phase3"])
    return out


__all__: List[str] = ["NCCL_GRAPH_MIXING", "PartMesh", "make_part_mesh",
                      "make_production_mesh", "make_test_mesh", "flat_axes",
                      "part_mesh_of", "ring_calls", "expected_calls"]
