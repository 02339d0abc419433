"""Synthetic recsys batches (zipfian categorical ids, multi-hot bags;
mirrors ``repro/data/recsys.py``).  ``SyntheticCTR`` makes the
reference's numpy draws, so its batches are byte-equal to the
reference's."""
from __future__ import annotations

import numpy as np
import torch

from ..models.recsys import AutoIntConfig, RecsysBatch
from .lm import _to_device


class SyntheticCTR:
    def __init__(self, cfg: AutoIntConfig, batch: int, seed: int = 0):
        self.cfg = cfg
        self.batch = batch
        self.seed = seed

    def batch_at(self, step: int) -> RecsysBatch:
        rng = np.random.default_rng(self.seed * 7_919 + step)
        c = self.cfg
        ids = np.minimum(
            rng.zipf(1.2, size=(self.batch, c.n_fields, c.max_bag)),
            c.vocab_per_field - 1,
        ).astype(np.int32)
        bag = (rng.random((self.batch, c.n_fields, c.max_bag)) < 0.6)
        bag[:, :, 0] = True   # at least one id per field
        labels = (rng.random(self.batch) < 0.25).astype(np.float32)
        return RecsysBatch(ids=ids, bag_mask=bag.astype(np.float32),
                           labels=labels)


def batch_to_device(batch: RecsysBatch, device) -> RecsysBatch:
    """A batch of numpy arrays → tensors on ``device``; to a card through
    pinned host memory, without waiting for the copy."""
    return RecsysBatch(**_to_device(batch._asdict(), torch.device(device)))
