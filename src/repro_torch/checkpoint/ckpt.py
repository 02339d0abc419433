"""Checkpointing: atomic, asynchronous save and restore (mirrors
``repro/checkpoint/ckpt.py``).

A checkpoint is one directory ``step-<step>`` holding ``arrays.npz`` (every
leaf of the state, keyed by its path in the tree) and ``meta.json``.
``save`` snapshots the state to host memory before it returns, so the
caller may go on updating it in place; a daemon thread writes the files
into ``.tmp-<step>``, fsyncs ``meta.json`` and renames the directory into
place, so a crash mid-save leaves the previous checkpoints intact (the restart loop
in ``ft.failure`` depends on this).  bf16 is widened to f32 on save (numpy
has no bf16; the widening keeps every value) and cast back to the leaf's
dtype on restore.

The layout is the port's own: its params are a list of layers, where the
reference's are stacked ``[L, …]``, so neither package reads the other's
checkpoints.

Over a mesh (DTensor leaves) a checkpoint still holds the whole logical
arrays, as the reference's does: ``save`` gathers each leaf on every rank
(``full_tensor()``), rank 0 alone writes, and every rank waits at a
barrier in :meth:`CheckpointManager.wait` (which ``save`` calls before
its write) until rank 0's write is in place, so no rank reads the
directory while rank 0 is writing it.  ``restore`` puts a DTensor leaf of
``tree_like`` back on that leaf's own mesh and placements, or places each
leaf by ``shardings=`` (a tree of ``parallel.sharding.NamedSharding``):
elastic restore onto another mesh (:mod:`.elastic`) is that placement.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..tree import leaves_with_paths, tree_leaves, tree_unflatten


def _is_dtensor(leaf) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(leaf, DTensor)


def _host(leaf) -> np.ndarray:
    """A host copy of one leaf (a DTensor's whole logical array, gathered
    on every rank): the caller goes on updating its state in place, so
    nothing here may share its memory."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if _is_dtensor(t):
            t = t.full_tensor()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)        # lossless widen; npz-portable
        elif t.device.type == "cpu":
            t = t.clone()
        return t.cpu().numpy()
    return np.array(leaf)


def _flatten_with_paths(tree) -> Dict[str, np.ndarray]:
    return {path: _host(leaf) for path, leaf in leaves_with_paths(tree)}


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        #: set by the first save of DTensors: rank 0 writes, all wait
        self._across_ranks = False

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = False,
             extra: Optional[Dict] = None) -> None:
        """Snapshot to host memory synchronously, write to disk async.
        Over a mesh every rank calls it; rank 0 writes."""
        if any(_is_dtensor(x) for _, x in leaves_with_paths(tree)):
            self._across_ranks = True
        flat = _flatten_with_paths(tree)   # device→host copy happens here
        meta = {"step": int(step), "keys": sorted(flat),
                "extra": extra or {}}
        self.wait()
        if self._across_ranks and dist.get_rank() != 0:
            if blocking:
                self.wait()
            return
        # thread-contract: daemon (a half-written .tmp-<step> dir is
        # discarded on restart, so dying with the interpreter is safe);
        # joined by wait() before the next save and by callers that need
        # the checkpoint durable (blocking=True / final save).
        self._thread = threading.Thread(
            target=self._write, args=(step, flat, meta), daemon=True
        )
        self._thread.start()
        if blocking:
            self.wait()

    def _write(self, step: int, flat, meta) -> None:
        tmp = os.path.join(self.dir, f".tmp-{step}")
        final = os.path.join(self.dir, f"step-{step:010d}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def wait(self) -> None:
        """Until the last save is on disk; over a mesh, on every rank (a
        barrier after rank 0's write)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._across_ranks:
            dist.barrier()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step-{s:010d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step-"):
                out.append(int(name.split("-")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like: Any, step: Optional[int] = None,
                device: Optional[torch.device] = None,
                shardings: Any = None):
        """Restore into the structure of ``tree_like``: each tensor leaf
        comes back in that leaf's dtype, on ``device`` (default: the
        leaf's own), a DTensor leaf as a DTensor on its own mesh and
        placements; other leaves come back as numpy arrays.  With
        ``shardings`` (a tree of ``NamedSharding`` shaped as
        ``tree_like``) every leaf comes back as a DTensor placed by its
        sharding: each rank keeps its shard of the whole array it read.
        Returns ``(tree, step)``."""
        from ..parallel.sharding import NamedSharding, distribute

        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        places = None if shardings is None else tree_leaves(shardings)
        d = os.path.join(self.dir, f"step-{step:010d}")
        out = []
        with np.load(os.path.join(d, "arrays.npz")) as data:
            for i, (key, leaf) in enumerate(leaves_with_paths(tree_like)):
                arr = data[key]
                if tuple(arr.shape) != tuple(leaf.shape):
                    raise ValueError(f"{key}: checkpoint shape {arr.shape}, "
                                     f"state shape {tuple(leaf.shape)}")
                place = places[i] if places is not None else \
                    NamedSharding.of(leaf) if _is_dtensor(leaf) else None
                if place is not None:
                    dtype = leaf.dtype if isinstance(leaf, torch.Tensor) \
                        else torch.from_numpy(arr).dtype
                    arr = distribute(torch.from_numpy(arr).to(dtype), place)
                elif isinstance(leaf, torch.Tensor):
                    arr = torch.from_numpy(arr).to(
                        device=device or leaf.device, dtype=leaf.dtype)
                out.append(arr)
        return tree_unflatten(tree_like, out), step

    def meta(self, step: Optional[int] = None) -> Dict:
        step = step if step is not None else self.latest_step()
        with open(os.path.join(self.dir, f"step-{step:010d}", "meta.json")) as f:
            return json.load(f)
