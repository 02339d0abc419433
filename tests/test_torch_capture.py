"""The bounded convergence loop of ``repro_torch.core.capture`` (the
splice loops' stand-in for ``lax.while_loop``).

Eagerly it stops at the first round that changes nothing; under a CUDA
graph capture it runs its whole budget.  The capture rule is taken here
by patching ``capturing`` (the CPU records no graph): a converged loop
run to its budget must leave the carried buffers as the early stop
does, and every round writes into the same buffers."""
from unittest import mock

import pytest
import torch

from repro_torch.core import capture
from repro_torch.core.capture import converge

LIMIT = 3


def counting_step(calls):
    """A loop that raises ``x`` by one a round up to LIMIT; ``changed``
    says whether the round moved it.  Records its inputs' addresses."""
    def step(x, changed):
        calls.append((x.data_ptr(), changed.data_ptr()))
        nxt = torch.clamp(x + 1, max=LIMIT)
        return nxt, (nxt != x).any(-1)
    return step


def run(x0, rounds, full: bool, changed: bool = True):
    calls = []
    carry = (x0, torch.full((x0.shape[0],), changed, dtype=torch.bool))
    if full:
        with mock.patch.object(capture, "capturing", lambda device: True):
            out = converge(counting_step(calls), carry, rounds)
    else:
        out = converge(counting_step(calls), carry, rounds)
    return out, calls


@pytest.mark.parametrize("full", [False, True])
def test_rounds_write_the_carried_buffers_in_place(full):
    x0 = torch.zeros(2, 4, dtype=torch.int32)
    (x, changed), calls = run(x0, 10, full)
    assert len({c for c in calls}) == 1          # one pair of buffers
    assert calls[0] == (x.data_ptr(), changed.data_ptr())
    assert x0.eq(0).all()                         # the input is not written
    assert x.eq(LIMIT).all() and not changed.any()


def test_eager_stops_at_the_round_that_changes_nothing():
    _, calls = run(torch.zeros(2, 4, dtype=torch.int32), 10, full=False)
    assert len(calls) == LIMIT + 1


def test_a_converged_loop_run_to_its_budget_is_unchanged():
    x0 = torch.zeros(2, 4, dtype=torch.int32)
    eager, _ = run(x0, 10, full=False)
    full, calls = run(x0, 10, full=True)
    assert len(calls) == 10
    assert all(torch.equal(a, b) for a, b in zip(eager, full))
    # a loop that starts converged: no round eagerly, identity rounds under
    # the capture rule
    done = torch.full((2, 4), LIMIT, dtype=torch.int32)
    out, calls = run(done, 5, full=False, changed=False)
    assert not calls and torch.equal(out[0], done) and not out[1].any()
    out, calls = run(done, 5, full=True, changed=False)
    assert len(calls) == 5 and torch.equal(out[0], done)
    assert not out[1].any()


@pytest.mark.parametrize("full", [False, True])
def test_the_budget_bounds_the_rounds(full):
    (x, changed), calls = run(torch.zeros(1, 3, dtype=torch.int32), 2, full)
    assert len(calls) == 2 and x.eq(2).all() and changed.all()


def test_the_cpu_never_captures():
    assert not capture.capturing(torch.device("cpu"))
