"""Synthetic LM data with a background prefetch onto the device (mirrors
``repro/data/lm.py``).  ``SyntheticLM`` makes the reference's numpy draws,
so its batches are byte-equal to the reference's."""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch


class SyntheticLM:
    """Deterministic synthetic token stream (zipfian unigrams + shift task)
    so loss curves are reproducible across restarts."""

    def __init__(self, vocab: int, seq_len: int, batch: int, seed: int = 0):
        self.vocab = vocab
        self.seq = seq_len
        self.batch = batch
        self.seed = seed

    def batch_at(self, step: int):
        rng = np.random.default_rng(self.seed * 1_000_003 + step)
        z = rng.zipf(1.3, size=(self.batch, self.seq + 1))
        toks = np.minimum(z, self.vocab - 1).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def _to_device(batch, device: torch.device):
    """A dict of numpy arrays → tensors on ``device``; to a card through
    pinned host memory, without waiting for the copy."""
    out = {}
    for name, a in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[name] = t.to(device)
    return out


class Prefetcher:
    """Background-thread prefetch of host batches onto ``device`` (double
    buffered: ``depth`` batches wait in a bounded queue, so the card does
    not stall on the host pipeline).  Without ``device`` the batches pass
    through as they come."""

    def __init__(self, it: Iterator, depth: int = 2,
                 device: Optional[torch.device] = None):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.device = None if device is None else torch.device(device)
        self._stop = False

        def worker():
            for item in it:
                if self._stop:
                    return
                if self.device is not None:
                    item = _to_device(item, self.device)
                self.q.put(item)

        # thread-contract: daemon (prefetch holds no external resources;
        # an in-flight batch is safely abandoned at interpreter exit).
        # Never joined — consumers signal stop() and the bounded queue
        # unblocks the worker within one put.
        self.t = threading.Thread(target=worker, daemon=True)
        self.t.start()

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()

    def stop(self):
        self._stop = True
