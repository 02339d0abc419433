"""Fault tolerance: checkpoint-restart training loop + failure injection
(the port's own copy of ``repro/ft/failure.py``).

``run_with_restarts`` wraps any step function with: periodic async
checkpoints, exception capture (a device fault or a preemption surfaces
as an exception), restore-from-last-good, and bounded retry.  Failure
injection hooks let the tests kill arbitrary steps deterministically.
The reference passes ``shardings`` to its restore; on one device the
restore puts each leaf back on the device of its ``state_like`` leaf.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Optional, Tuple

log = logging.getLogger(__name__)


class InjectedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class RestartPolicy:
    max_restarts: int = 3
    ckpt_every: int = 50
    backoff_s: float = 0.0


def run_with_restarts(
    step_fn: Callable[[Any, int], Any],       # (state, step) -> state
    init_state: Any,
    n_steps: int,
    ckpt,                                      # CheckpointManager
    policy: RestartPolicy = RestartPolicy(),
    fail_at: Optional[Callable[[int], bool]] = None,
    state_like: Optional[Any] = None,
) -> Tuple[Any, int, int]:
    """Returns (final state, steps completed, restarts used)."""
    state = init_state
    start = 0
    restarts = 0
    fired: set = set()   # injections are transient: each step fails once
    while True:
        try:
            for step in range(start, n_steps):
                if fail_at is not None and step not in fired and fail_at(step):
                    fired.add(step)
                    raise InjectedFailure(f"injected failure at step {step}")
                state = step_fn(state, step)
                if (step + 1) % policy.ckpt_every == 0 or step + 1 == n_steps:
                    ckpt.save(step + 1, state)
            ckpt.wait()
            return state, n_steps, restarts
        except Exception as e:  # noqa: BLE001 — restart on any step failure
            restarts += 1
            log.warning("step failure (%s); restart %d/%d",
                        e, restarts, policy.max_restarts)
            if restarts > policy.max_restarts:
                raise
            ckpt.wait()
            last = ckpt.latest_step()
            if last is None:
                state, start = init_state, 0
            else:
                like = state_like if state_like is not None else state
                state, start = ckpt.restore(like)
            if policy.backoff_s:
                time.sleep(policy.backoff_s)
