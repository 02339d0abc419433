"""Phase 3: unroll the pairing structure into the final Euler circuit
(mirrors the replicated half of ``repro/core/phase3.py``).

After all merge levels every stub has a mate and the (sibling ∘ mate)
permutation's orbit through any stub is the circuit.  The device path
(:func:`phase3_device`) first merges the cycles left over at pivot
vertices (:func:`splice_components`: pointer-doubling CC labels, then
vote-and-rotate rounds), then emits the walk by list ranking
(:func:`circuit_from_mate`).  The two doubling loops run the CUDA kernels
K1/K2 of :mod:`repro_torch.kernels.pointer_double`, one launch per round.

Left out against the reference: the TPU VMEM gate
(``fits_resident_vmem``), the block padding of the tables (only the
Pallas grid needed it) and the ``interpret``/``block``/``batch``
parameters.  The kernel/twin seam is the wrappers' own device rule: on
CUDA tensors the doubling rounds launch the kernels, on CPU tensors the
wrappers compute the plain twins of :mod:`repro_torch.kernels.ref`.

The splice ``while_loop`` becomes a Python loop that reads one flag per
round on the host, with the reference's stop rule.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..kernels.pointer_double import pointer_double, pointer_double_rank
from .phase1 import (BIG, I32, _seg_starts, lexsort2, segment_min,
                     segment_sum)


def circuit_from_mate_np(mate: np.ndarray, start_stub: int = -1) -> np.ndarray:
    """NumPy list-ranking: emit the circuit as arrival stubs in walk order.

    ``mate[s]`` is the stub paired with ``s`` at their shared vertex; the
    walk arriving at stub ``s`` departs via ``mate[s]`` and next arrives at
    ``mate[s] ^ 1``.  Requires a single orbit covering E stubs (one circuit).
    """
    n_stubs = mate.shape[0]
    valid = mate >= 0
    if start_stub < 0:
        start_stub = int(np.nonzero(valid)[0][0])
    nxt = np.where(valid, mate ^ 1, np.arange(n_stubs))

    # Halt node: predecessor of start — t such that nxt[t] == start.
    t = int(mate[start_stub ^ 1])
    ptr = nxt.copy()
    ptr[t] = t
    dist = np.ones(n_stubs, dtype=np.int64)
    dist[t] = 0
    reach = np.zeros(n_stubs, dtype=bool)
    reach[t] = True
    rounds = int(np.ceil(np.log2(max(2, n_stubs)))) + 1
    for _ in range(rounds):
        dist = dist + dist[ptr]
        reach = reach | reach[ptr]
        ptr = ptr[ptr]

    orbit = np.nonzero(reach & valid)[0]
    order = orbit[np.argsort(-dist[orbit], kind="stable")]
    return order.astype(np.int64)


def emit_circuit_np(valid: np.ndarray, dist: np.ndarray,
                    reach: np.ndarray) -> np.ndarray:
    """NumPy twin of :func:`emit_circuit`: same int32 keys, same stable
    sort, same tie order."""
    valid = np.asarray(valid)
    on_orbit = (np.asarray(reach) > 0) & valid
    dist = np.asarray(dist).astype(np.int32, copy=False)
    key = np.where(on_orbit, -dist,
                   np.iinfo(np.int32).max).astype(np.int32)
    order = np.argsort(key, kind="stable")
    E = valid.shape[0] // 2
    out = order[:E].astype(np.int32)
    member = on_orbit[out]
    return np.where(member, out, np.int32(-1))


def _doubling_rounds(n: int) -> int:
    return int(math.ceil(math.log2(max(2, n)))) + 1


def emit_circuit(valid: torch.Tensor, dist: torch.Tensor,
                 reach: torch.Tensor) -> torch.Tensor:
    """Rank → walk-order emission: stubs sorted by descending halt
    distance among orbit members (stable, so non-members keep index
    order), the first E slots kept, off-orbit slots blanked to -1."""
    on_orbit = (reach > 0) & valid
    key = torch.where(on_orbit, -dist, BIG)
    order = torch.argsort(key, stable=True)
    E = valid.shape[0] // 2
    out = order[:E].to(I32)
    return torch.where(on_orbit[out], out, -1)


def circuit_from_mate(mate: torch.Tensor,
                      start_stub: torch.Tensor) -> torch.Tensor:
    """Torch list-ranking twin of :func:`circuit_from_mate_np`.

    ``mate`` int32 [2E], ``start_stub`` a 0-d int tensor.  Returns arrival
    stubs in walk order, ``[E]`` int32, padded with -1 where ``mate`` is
    invalid.  The doubling rounds run the K2 kernel
    (:func:`pointer_double_rank`), ping-ponging two sets of buffers.
    """
    n_stubs = mate.shape[0]
    iota = torch.arange(n_stubs, dtype=I32, device=mate.device)
    valid = mate >= 0
    nxt = torch.where(valid, mate ^ 1, iota)

    t = mate[(start_stub ^ 1).reshape(1)]                # [1], no host sync
    ptr = nxt.index_put((t,), t)
    dist = torch.ones(n_stubs, dtype=I32, device=mate.device)
    dist = dist.index_put((t,), torch.zeros_like(t))
    reach = torch.zeros(n_stubs, dtype=I32, device=mate.device)
    reach = reach.index_put((t,), torch.ones_like(t))
    cur = (ptr, dist, reach)
    spare = tuple(torch.empty_like(x) for x in cur)
    for _ in range(_doubling_rounds(n_stubs)):
        cur, spare = pointer_double_rank(*cur, out=spare), cur
    return emit_circuit(valid, cur[1], cur[2])


def _cc_cycle_labels(mate: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """Component labels (min member stub id) of the sibling∘mate cycle
    structure, by pointer-doubling min-label propagation (K1).

    Each closed cycle splits into two pointer orbits (forward and reverse
    traversal); doubling converges each to its own min, and a final min
    with the sibling's label merges the two into the cycle id.
    """
    n = mate.shape[0]
    iota = torch.arange(n, dtype=I32, device=mate.device)
    cur = (torch.where(valid, mate ^ 1, iota), iota)
    spare = (torch.empty_like(iota), torch.empty_like(iota))
    for _ in range(_doubling_rounds(n)):
        cur, spare = pointer_double(*cur, out=spare), cur
    lab = cur[1]
    return torch.minimum(lab, lab[iota ^ 1])


def splice_components(
    mate: torch.Tensor,
    stub_vertex: torch.Tensor,
    valid: torch.Tensor,
    rounds: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge the edge-disjoint cycles that cross at shared (pivot)
    vertices by mate rotations (mirrors ``splice_components_jnp``).

    Each round every component votes its min candidate vertex, so a
    component rotates at most once per round.  Requires every valid stub
    to be mated.  Returns ``(mate', converged)`` with ``converged`` a 0-d
    bool tensor.
    """
    n = mate.shape[0]
    dev = mate.device
    iota = torch.arange(n, dtype=I32, device=dev)
    mate = mate.to(I32)
    sv = stub_vertex.to(I32)
    lab = _cc_cycle_labels(mate, valid)
    pad_m1 = torch.full((1,), -1, dtype=I32, device=dev)
    pad_0 = torch.zeros((1,), dtype=I32, device=dev)

    def round_fn(mate, lab):
        cm = valid & (mate > iota)                 # canonical stub per pair
        vkey = torch.where(cm, sv, BIG)
        ckey = torch.where(cm, lab, BIG)
        order = lexsort2(vkey, ckey)
        gv, gc = vkey[order], ckey[order]
        gs = torch.where(cm, iota, BIG)[order]
        gm = cm[order]
        # one representative pair per (vertex, component)
        dup = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                         (gv[1:] == gv[:-1]) & (gc[1:] == gc[:-1])])
        rep = gm & ~dup & (gv < BIG)
        seg = _seg_starts(gv)
        n_rep = segment_sum(rep.to(I32), seg, n, live=rep)
        cand = rep & (n_rep[seg] >= 2)             # ≥2 cycles at this pivot
        # each component votes for its min candidate vertex
        vote = segment_min(gv, gc, n + 1, live=cand)  # comp ids are < n
        voted = cand & (vote[gc.clamp(0, n)] == gv)
        n_take = segment_sum(voted.to(I32), seg, n, live=voted)
        act = voted & (n_take[seg] >= 2)
        # circular mate rotation within each pivot vertex's act group
        akey = torch.where(act, gv, BIG)
        o2 = torch.argsort(akey, stable=True)
        hv, hs, hc = akey[o2], gs[o2], gc[o2]
        hm = act[o2]
        hstart = _seg_starts(hv)
        hlast = torch.cat([hv[1:] != hv[:-1],
                           torch.ones(1, dtype=torch.bool, device=dev)])
        hnxt = torch.where(hlast, hstart, iota + 1).clamp(0, n - 1)
        b = mate[hs[hnxt].clamp(0, n - 1)]         # mate of the next rep
        # rotate: mate[a_i] ← b_{i+1}, mate[b_{i+1}] ← a_i (disjoint index
        # sets; masked rows all write -1 into the pad slot n)
        mpad = torch.cat([mate, pad_m1])
        mpad[torch.where(hm, hs, n)] = torch.where(hm, b, -1)
        mpad[torch.where(hm, b, n)] = torch.where(hm, hs, -1)
        # relabel merged components to the min label at their pivot
        minc = segment_min(hc, hstart, n, live=hm)
        lmap = torch.cat([iota, pad_0])
        lmap[torch.where(hm, hc, n)] = torch.where(hm, minc[hstart], 0)
        return mpad[:n], lmap[lab.clamp(0, n - 1)], hm.any()

    changed = torch.ones((), dtype=torch.bool, device=dev)
    left = rounds
    while left > 0 and bool(changed):              # one host read per round
        mate, lab, changed = round_fn(mate, lab)
        left -= 1
    return mate, ~changed


def first_valid(valid: torch.Tensor) -> torch.Tensor:
    """0-d int32 index of the first valid stub (the walk's start); torch's
    ``argmax`` takes no bool, so the mask goes through int32."""
    return valid.to(I32).argmax().to(I32)


def phase3_device(mate: torch.Tensor, stub_vertex: torch.Tensor,
                  splice_rounds: int = 64):
    """Full Phase 3: pivot splice, then list-rank emission.

    ``mate`` int32 [2E] (−1 = unmated padding), ``stub_vertex`` [2E].
    Returns ``(circuit [E], mate', splice_converged)``.
    """
    valid = mate >= 0
    mate2, ok = splice_components(mate, stub_vertex, valid,
                                  rounds=splice_rounds)
    circuit = circuit_from_mate(mate2, first_valid(valid))
    return circuit, mate2, ok
