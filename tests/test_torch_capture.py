"""The bounded convergence loop of ``repro_torch.core.capture`` (the
splice loops' stand-in for ``lax.while_loop``) and its CUDA while node.

Eagerly it stops at the first round that changes nothing; under a CUDA
graph capture it records one while node, whose test before every round
a kernel makes on the device.  The capture rule is taken here by
patching ``capturing`` (the CPU records no graph): the node's stand-in
(``kernels/graph_loop.py`` on CPU tensors) then loops on the host with
the test kernel's twin ``ref.loop_condition_ref``, and must run exactly
the eager rounds, write the same buffers in place and leave the same
bytes.  On a card (``gpu`` tests) the node itself is recorded and
replayed, and the test kernel is held against its twin."""
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.core import capture
from repro_torch.core.capture import converge
from repro_torch.kernels import graph_loop
from repro_torch.kernels.ref import loop_condition_ref

LIMIT = 3


def counting_step(calls):
    """A loop that raises ``x`` by one a round up to LIMIT; ``changed``
    says whether the round moved it.  Records its inputs' addresses."""
    def step(x, changed):
        calls.append((x.data_ptr(), changed.data_ptr()))
        nxt = torch.clamp(x + 1, max=LIMIT)
        return nxt, (nxt != x).any(-1)
    return step


def run(x0, rounds, captured: bool, changed: bool = True):
    """``converge`` eagerly or under the capture rule (the while node's
    stand-in); the loop's round counter must equal the rounds run."""
    calls = []
    carry = (x0, torch.full((x0.shape[0],), changed, dtype=torch.bool))
    loops = capture.Loops(torch.device("cpu"))
    with capture.counting(loops), \
            mock.patch.object(capture, "capturing", lambda device: captured):
        out = converge(counting_step(calls), carry, rounds)
    assert loops.rounds_run() == [len(calls)]
    return out, calls


@pytest.mark.parametrize("captured", [False, True])
def test_rounds_write_the_carried_buffers_in_place(captured):
    x0 = torch.zeros(2, 4, dtype=torch.int32)
    (x, changed), calls = run(x0, 10, captured)
    assert len({c for c in calls}) == 1          # one pair of buffers
    assert calls[0] == (x.data_ptr(), changed.data_ptr())
    assert x0.eq(0).all()                         # the input is not written
    assert x.eq(LIMIT).all() and not changed.any()


def test_eager_stops_at_the_round_that_changes_nothing():
    _, calls = run(torch.zeros(2, 4, dtype=torch.int32), 10, captured=False)
    assert len(calls) == LIMIT + 1


def test_a_converged_loop_run_to_its_budget_is_unchanged():
    """The while node runs the eager rounds, LIMIT + 1 of a budget of
    10, with the same bytes; a loop that starts converged runs no round
    either way and leaves its carry as it was."""
    x0 = torch.zeros(2, 4, dtype=torch.int32)
    eager, _ = run(x0, 10, captured=False)
    node, calls = run(x0, 10, captured=True)
    assert len(calls) == LIMIT + 1
    assert all(torch.equal(a, b) for a, b in zip(eager, node))
    done = torch.full((2, 4), LIMIT, dtype=torch.int32)
    for captured in (False, True):
        out, calls = run(done, 5, captured, changed=False)
        assert not calls and torch.equal(out[0], done) and not out[1].any()


@pytest.mark.parametrize("captured", [False, True])
def test_the_budget_bounds_the_rounds(captured):
    (x, changed), calls = run(torch.zeros(1, 3, dtype=torch.int32), 2,
                              captured)
    assert len(calls) == 2 and x.eq(2).all() and changed.all()


def test_the_cpu_never_captures():
    assert not capture.capturing(torch.device("cpu"))


@pytest.mark.parametrize("shape", [(8,), ()])
def test_loop_condition_first_test(shape):
    """The test before the first round (``ctr`` −1): the flag holds
    somewhere and the budget is above 0; the counter becomes 0."""
    none = torch.zeros(shape, dtype=torch.bool)
    one = none.clone()
    one.view(-1)[-1] = True
    start = torch.tensor(-1, dtype=torch.int32)
    for changed, rounds, want in ((none, 5, False), (one, 5, True),
                                  (one, 0, False), (one, 1, True)):
        cond, ran = loop_condition_ref(changed, start, rounds)
        assert cond.shape == () and cond.dtype == torch.bool
        assert bool(cond) == want and int(ran) == 0


@pytest.mark.parametrize("shape", [(8,), ()])
def test_loop_condition_budget_cap(shape):
    """After k rounds the test counts k and holds only while k <
    rounds: with the flag always set the loop runs the whole budget."""
    changed = torch.ones(shape, dtype=torch.bool)
    for rounds in (1, 2, 16):
        cond, ran = loop_condition_ref(
            changed, torch.tensor(-1, dtype=torch.int32), rounds)
        trips = 0
        while bool(cond):
            trips += 1
            cond, ran = loop_condition_ref(changed, ran, rounds)
        assert trips == int(ran) == rounds


def test_while_loop_checks_its_tensors():
    flag = torch.ones(2, dtype=torch.bool)
    ctr = torch.zeros((), dtype=torch.int32)
    with pytest.raises(TypeError, match="bool"):
        graph_loop.while_loop(lambda: None, flag.to(torch.int32), ctr, 3)
    with pytest.raises(TypeError, match="int32"):
        graph_loop.while_loop(lambda: None, flag, ctr.to(torch.int64), 3)
    with pytest.raises(TypeError, match="int32"):
        graph_loop.while_loop(lambda: None, flag, ctr[None], 3)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: a while node runs only on the card")
    return torch.device("cuda")


def _countdown(x, changed):
    """One round: x ← max(x − 1, 0), changed ← x > 0, in place."""
    def body():
        x.copy_((x - 1).clamp(min=0))
        changed.copy_(x > 0)
    return body


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8,), ()])
def test_cuda_loop_condition_matches_its_twin(shape):
    """On a card: a while node around a countdown runs min(max(x), rounds)
    rounds at every replay, as the twin-driven loop on the host does, for
    new inputs loaded between replays (the device decides, not the
    recording)."""
    dev = _cuda()
    rng = np.random.default_rng(0)
    for rounds in (0, 1, 3, 16):
        x = torch.zeros(shape, dtype=torch.int32, device=dev)
        changed = torch.zeros(shape, dtype=torch.bool, device=dev)
        _countdown(x, changed)()                # warm-up off the capture
        loops = capture.Loops(dev)
        graph = torch.cuda.CUDAGraph()
        with capture.recording(graph, loops):
            capture.device_while(_countdown(x, changed), changed, rounds)
        for _ in range(3):
            x0 = torch.as_tensor(rng.integers(0, 6, size=shape),
                                 dtype=torch.int32)
            x.copy_(x0)
            changed.copy_(x0 > 0)
            graph.replay()
            want_x, want_changed = x0.clone(), x0 > 0
            want_ctr = torch.zeros((), dtype=torch.int32)
            graph_loop.while_loop(_countdown(want_x, want_changed),
                                  want_changed, want_ctr, rounds)
            assert loops.rounds_run() == [int(want_ctr)]
            assert int(want_ctr) == min(int(x0.max()), rounds)
            assert torch.equal(x.cpu(), want_x)
            assert torch.equal(changed.cpu(), want_changed)


@pytest.mark.gpu
def test_cuda_while_node_pool_survives_unrelated_allocations():
    """On a card: the node's body allocates its temporaries from the
    loops' pool, so two replays on different inputs with unrelated
    allocations between them both give the eager bytes, and the graph
    writes nothing into those allocations."""
    dev = _cuda()
    n = 1 << 20
    rng = np.random.default_rng(1)

    def step(nxt, lab, _changed):               # one min-label doubling
        lab2 = torch.minimum(lab, lab[nxt.long()])
        return nxt[nxt.long()], lab2, (lab2 != lab).any()

    def cycle():
        perm = torch.as_tensor(rng.permutation(n), dtype=torch.int32)
        succ = torch.empty(n, dtype=torch.int32)
        succ[perm] = torch.roll(perm, -1)
        return succ.to(dev), torch.as_tensor(rng.permutation(n),
                                             dtype=torch.int32).to(dev)

    def eager(nxt, lab):
        loops = capture.Loops(torch.device("cpu"))
        with capture.counting(loops):
            out = converge(step, (nxt, lab, torch.ones(
                (), dtype=torch.bool, device=dev)), 64)
        return out, loops.rounds_run()

    nxt_in, lab_in = (torch.empty(n, dtype=torch.int32, device=dev)
                      for _ in range(2))
    flag = torch.ones((), dtype=torch.bool, device=dev)
    first = cycle()
    nxt_in.copy_(first[0])
    lab_in.copy_(first[1])
    eager(nxt_in, lab_in)                       # warm-up off the capture
    loops = capture.Loops(dev)
    graph = torch.cuda.CUDAGraph()
    with capture.recording(graph, loops):
        out = converge(step, (nxt_in, lab_in, flag), 64)
    for inputs in (first, cycle()):
        nxt_in.copy_(inputs[0])
        lab_in.copy_(inputs[1])
        others = [torch.full((n,), 7, dtype=torch.int32, device=dev)
                  for _ in range(16)]
        graph.replay()
        torch.cuda.synchronize()
        want, rounds = eager(*inputs)
        for got, w in zip(out, want):
            assert torch.equal(got, w)
        assert loops.rounds_run() == rounds and rounds[0] > 1
        assert all(bool(o.eq(7).all()) for o in others)
        del others


@pytest.mark.gpu
def test_cuda_host_read_in_a_while_body_raises_and_leaves_nothing():
    """On a card: a body that reads its flag on the host makes the
    recording raise before the read reaches the card; the pools are
    released and a new graph records and replays."""
    dev = _cuda()
    x = torch.zeros(8, dtype=torch.int32, device=dev)
    changed = torch.zeros(8, dtype=torch.bool, device=dev)
    count = _countdown(x, changed)
    count()

    def reading():
        count()
        bool(changed.any())

    graph = torch.cuda.CUDAGraph()
    loops = capture.Loops(dev)
    with pytest.raises(RuntimeError, match="synchroniz"):
        with capture.recording(graph, loops):
            capture.device_while(reading, changed, 16)
    assert torch.cuda.get_sync_debug_mode() == 0
    del graph, loops
    torch.cuda.empty_cache()
    graph = torch.cuda.CUDAGraph()
    loops = capture.Loops(dev)
    with capture.recording(graph, loops):
        capture.device_while(count, changed, 16)
    x.fill_(4)
    changed.fill_(True)
    graph.replay()
    assert loops.rounds_run() == [4] and not changed.any()
