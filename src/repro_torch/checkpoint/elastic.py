"""Elastic restore: bring a checkpoint up on a different mesh (mirrors
``repro/checkpoint/elastic.py``).

Checkpoints store *logical* arrays (``checkpoint.ckpt`` gathers the
shards on save), so elasticity is a placement decision at restore time:
build the new mesh, recompute the sharding rules for it, and place each
array with ``distribute_tensor`` — no resharding pass, no format
migration.  It works across world-size changes (a world of 4 ranks → 2
after a failure) and across mesh-shape changes ((2, 2) → (4, 1)).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

from .ckpt import CheckpointManager


def elastic_restore(ckpt: CheckpointManager, tree_like: Any, new_mesh,
                    sharding_rule: Callable[[Any, Any], Any],
                    step: Optional[int] = None):
    """Restore ``tree_like``-shaped state onto ``new_mesh`` (a
    ``DeviceMesh``).

    ``sharding_rule(tree, mesh) -> NamedSharding tree`` is the rule used
    at launch (``parallel.sharding``, ``launch.steps.lm_state_shardings``),
    evaluated against the new mesh; ``tree_like`` may hold tensors or
    DTensors of another mesh (only its shapes and dtypes are read).
    Returns ``(tree, step)``.
    """
    shardings = sharding_rule(tree_like, new_mesh)
    return ckpt.restore(tree_like, step=step, shardings=shardings)
