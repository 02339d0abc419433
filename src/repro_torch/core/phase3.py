"""Phase 3: unroll the pairing structure into the final Euler circuit
(mirrors ``repro/core/phase3.py``, both its replicated and its sharded
half).

After all merge levels every stub has a mate and the (sibling ∘ mate)
permutation's orbit through any stub is the circuit.  Two device paths
compute the same circuit, byte for byte:

  * replicated (:func:`phase3_device`, the path for P=1): merge the
    cycles left over at pivot vertices (:func:`splice_components`:
    pointer-doubling CC labels, then vote-and-rotate rounds), then emit
    the walk by list ranking (:func:`circuit_from_mate`).  The doubling
    loops run the CUDA kernels K1/K2, one launch per round.
  * sharded (:func:`phase3_sharded`, the default for P>1): the same
    steps over the ``[n, S]`` stub shards, every remote pointer resolved
    by rotating table shards around the partition ring.  The doubling
    loops run K3/K4, one launch per ring step serving all n shards.

The host engine (``backend="host"``) runs the reference's host Phase 3
instead: :func:`splice_components_np` (scipy connected components, then
mate rotations at each pivot vertex) and :func:`circuit_from_mate_np`.

Both device paths take a batch of B same-bucket graphs (the reference's ``vmap``
of its one-graph body): the replicated path as one flat stub space of B
disjoint graphs, the sharded one as ``[n·B, S]`` rows, (partition,
graph) pairs.  Either way each doubling round stays one kernel launch
for the whole batch, at one graph's round count.

Left out against the reference: the TPU VMEM gate
(``fits_resident_vmem``), the block padding of the tables (only the
Pallas grid needed it) and the ``interpret``/``block`` parameters (its
``batch`` sized Pallas blocks).  The kernel/twin seam is the wrappers'
own device rule: on CUDA tensors the doubling rounds launch the kernels,
on CPU tensors the wrappers compute the plain twins of
:mod:`repro_torch.kernels.ref`.

The splice ``while_loop``s run through
:func:`~repro_torch.core.capture.converge`: eagerly they read one flag a
round on the host, with the reference's stop rule; inside a CUDA graph
capture each becomes one while node that tests the same rule on the
device before every round.  Nothing else here reads the
device: round counts are static and the walk's start stays a tensor, so
the fused run can record every step.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels.pointer_double import (pointer_double, pointer_double_rank,
                                      pointer_double_rank_shard,
                                      pointer_double_shard)
from . import capture
from .capture import converge
from .phase1 import (BIG, I32, _edge, _seg_starts, lexsort2, segment_min,
                     segment_sum, take)


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


def splice_components_np(
    mate: np.ndarray,
    stub_vertex: np.ndarray,
    valid: np.ndarray,
) -> np.ndarray:
    """Final pivot splice (host, the reference's): merge remaining
    edge-disjoint cycles that cross only at already-consumed vertices, by
    mate rotations — the same operation the paper's Phase 3 performs when
    it "switches to a different cycle at the pivot vertex".  Returns the
    updated mate array.  The host engine's Phase 3
    (:mod:`repro_torch.core.host_engine`); byte-identical to the
    reference's on the same inputs."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    mate = mate.copy()
    n_stubs = mate.shape[0]
    idx = np.nonzero(valid)[0]
    for _ in range(64):
        # components over sibling + mate links
        sib_u = idx
        sib_v = idx ^ 1
        mat_u = idx
        mat_v = mate[idx]
        rows = np.concatenate([sib_u, mat_u])
        cols = np.concatenate([sib_v, mat_v])
        g = coo_matrix(
            (np.ones(len(rows), np.int8), (rows, cols)), shape=(n_stubs, n_stubs)
        )
        ncomp, labels = connected_components(g, directed=False)
        live = np.unique(labels[idx])
        if len(live) <= 1:
            break
        # one representative pair per (component, vertex); rotate per vertex
        s = idx[mate[idx] > idx]  # one canonical stub per mate-pair
        v = stub_vertex[s]
        comp = labels[s]
        order = np.lexsort((comp, v))
        s, v, comp = s[order], v[order], comp[order]
        first = np.ones(len(s), dtype=bool)
        first[1:] = (v[1:] != v[:-1]) | (comp[1:] != comp[:-1])
        s, v, comp = s[first], v[first], comp[first]
        # vertices hosting >= 2 distinct comps
        vstart = np.ones(len(v), dtype=bool)
        vstart[1:] = v[1:] != v[:-1]
        vseg = np.cumsum(vstart) - 1
        seg_sizes = np.bincount(vseg)
        merged_any = False
        done = set()
        for seg in np.nonzero(seg_sizes >= 2)[0]:
            members = np.nonzero(vseg == seg)[0]
            comps = comp[members]
            if any(c in done for c in comps):
                continue  # one rotation per comp per round
            done.update(int(c) for c in comps)
            reps = s[members]
            mates = mate[reps]
            # rotate: mate[a_i] <- b_{i+1}
            for i in range(len(reps)):
                a = reps[i]
                b = mates[(i + 1) % len(reps)]
                mate[a] = b
                mate[b] = a
            merged_any = True
        if not merged_any:
            break
    return mate


def _doubling_rounds(n: int) -> int:
    return int(math.ceil(math.log2(max(2, n)))) + 1


def emit_circuit(valid: torch.Tensor, dist: torch.Tensor,
                 reach: torch.Tensor) -> torch.Tensor:
    """Rank → walk-order emission: stubs sorted by descending halt
    distance among orbit members (stable, so non-members keep index
    order), the first E slots kept, off-orbit slots blanked to -1.  On
    ``[2E]`` stubs, or on each row of ``[B, 2E]`` (a graph a row)."""
    on_orbit = (reach > 0) & valid
    key = torch.where(on_orbit, -dist, BIG)
    order = torch.argsort(key, dim=-1, stable=True)
    E = valid.shape[-1] // 2
    out = order[..., :E]
    return torch.where(on_orbit.gather(-1, out), out.to(I32), -1)


def _graph_offsets(batch: int, width: int, dev) -> torch.Tensor:
    """``[B, 1]`` int32 offsets ``b·width``: graph b's first id in a flat
    id space of B graphs of ``width`` ids each."""
    return (torch.arange(batch, dtype=I32, device=dev) * width)[:, None]


def _to_flat(mate: torch.Tensor) -> torch.Tensor:
    """``[B, 2E]`` per-graph mates → one ``[B·2E]`` mate over a flat stub
    space in which graph b's stub s is ``b·2E + s``.  The graphs stay
    disjoint: every pointer stays in its graph, and so does ``s ^ 1``
    (2E is even).  Unmated stubs stay −1."""
    off = _graph_offsets(*mate.shape, mate.device)
    return torch.where(mate >= 0, mate + off, -1).reshape(-1)


def _to_local(mate: torch.Tensor, batch: int) -> torch.Tensor:
    """Inverse of :func:`_to_flat`: ``[B·2E]`` → ``[B, 2E]``."""
    m = mate.view(batch, -1)
    return torch.where(m >= 0, m - _graph_offsets(*m.shape, m.device), -1)


def circuit_from_mate(mate: torch.Tensor,
                      start_stub: torch.Tensor) -> torch.Tensor:
    """Torch list-ranking twin of :func:`circuit_from_mate_np`.

    ``mate`` int32 [2E] and ``start_stub`` a 0-d int tensor, or a batch:
    ``mate`` [B, 2E] and ``start_stub`` [B].  Returns arrival stubs in
    walk order, ``[E]`` (``[B, E]``) int32, padded with -1 where ``mate``
    is invalid.  The doubling rounds run the K2 kernel
    (:func:`pointer_double_rank`) on packed records ``(ptr, dist, reach,
    0)``, built once and ping-ponged between two buffers.  A batch's
    graphs share one record table (:func:`_to_flat`), so a round is one
    launch for all of them, and they run one graph's round count.  The
    ``dist`` and ``reach`` columns of the last round go to
    :func:`emit_circuit`.
    """
    if mate.dim() == 1:
        return circuit_from_mate(mate[None], start_stub.reshape(1))[0]
    B, n_stubs = mate.shape
    dev = mate.device
    flat = _to_flat(mate)
    iota = torch.arange(B * n_stubs, dtype=I32, device=dev)
    start = start_stub.reshape(B, 1) + _graph_offsets(B, n_stubs, dev)
    t = flat[(start ^ 1).reshape(-1)]                    # [B], no host sync
    # halt node t: self-loop, dist 0, reach 1; the rest (nxt, 1, 0, 0)
    cur = torch.zeros(B * n_stubs, 4, dtype=I32, device=dev)
    cur[:, 0] = torch.where(flat >= 0, flat ^ 1, iota)
    cur[:, 1] = 1
    halt = torch.stack([t, torch.zeros_like(t), torch.ones_like(t),
                        torch.zeros_like(t)], 1)
    cur.index_put_((t,), halt)
    spare = torch.empty_like(cur)
    for _ in range(_doubling_rounds(n_stubs)):
        cur, spare = pointer_double_rank(cur, out=spare), cur
    return emit_circuit(mate >= 0, cur[:, 1].view(B, n_stubs),
                        cur[:, 2].view(B, n_stubs))


def _cc_cycle_labels(mate: torch.Tensor, valid: torch.Tensor,
                     rounds: Optional[int] = None) -> torch.Tensor:
    """Component labels (min member stub id) of the sibling∘mate cycle
    structure, by pointer-doubling min-label propagation (K1).

    Each closed cycle splits into two pointer orbits (forward and reverse
    traversal); doubling converges each to its own min, and a final min
    with the sibling's label merges the two into the cycle id.  The
    rounds run on packed records ``(nxt, lab)``, built once and
    ping-ponged between two buffers, as in :func:`circuit_from_mate`.
    ``rounds`` defaults to the doubling rounds of the whole table; a
    batch's flat table (:func:`_to_flat`) passes one graph's.
    """
    n = mate.shape[0]
    iota = torch.arange(n, dtype=I32, device=mate.device)
    cur = torch.stack([torch.where(valid, mate ^ 1, iota), iota], 1)
    spare = torch.empty_like(cur)
    for _ in range(_doubling_rounds(n) if rounds is None else rounds):
        cur, spare = pointer_double(cur, out=spare), cur
    lab = cur[:, 1]
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

    On a batch (``[B, 2E]`` inputs) the graphs run as one flat stub space
    (:func:`_to_flat`), with graph b's vertex keys moved past graph
    b−1's (``b·(max vertex + 1)``; the caller keeps ``B·(max vertex + 1)``
    below int32 max), so each (vertex, component) group, vote, rotation
    and relabel stays in its graph and in its order alone.  The loop
    runs while any graph changes; a converged graph's extra rounds
    rotate nothing.  ``converged`` is then ``[B]``, each graph's own.
    """
    if mate.dim() == 1:
        m, ok = splice_components(mate[None], stub_vertex[None],
                                  valid[None], rounds)
        return m[0], ok[0]
    B, n_stubs = mate.shape
    n = B * n_stubs
    dev = mate.device
    iota = torch.arange(n, dtype=I32, device=dev)
    mate = _to_flat(mate.to(I32))
    valid = valid.reshape(-1)
    sv = stub_vertex.to(I32)
    sv = (sv + _graph_offsets(B, 1, dev) * (sv.amax() + 1)).reshape(-1)
    lab = _cc_cycle_labels(mate, valid, _doubling_rounds(n_stubs))
    pad_m1 = torch.full((1,), -1, dtype=I32, device=dev)
    pad_0 = torch.zeros((1,), dtype=I32, device=dev)

    def round_fn(mate, lab, _changed):
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
        # each graph's own flag: did any of its pivots rotate?
        changed = torch.zeros(B + 1, dtype=torch.bool, device=dev)
        changed[torch.where(hm, hs // n_stubs, B)] = hm
        return mpad[:n], lmap[lab.clamp(0, n - 1)], changed[:B]

    mate, _, changed = converge(
        round_fn, (mate, lab, torch.ones(B, dtype=torch.bool, device=dev)),
        rounds)
    return _to_local(mate, B), ~changed


def first_valid(valid: torch.Tensor) -> torch.Tensor:
    """Int32 index of the first valid stub (the walk's start): 0-d for
    ``[2E]``, ``[B]`` for ``[B, 2E]``; torch's ``argmax`` takes no bool,
    so the mask goes through int32."""
    return valid.to(I32).argmax(-1).to(I32)


def phase3_device(mate: torch.Tensor, stub_vertex: torch.Tensor,
                  splice_rounds: int = 64):
    """Full Phase 3: pivot splice, then list-rank emission.

    ``mate`` int32 [2E] (−1 = unmated padding), ``stub_vertex`` [2E].
    Returns ``(circuit [E], mate', splice_converged)``; on a batch
    (``[B, 2E]`` inputs) ``([B, E], [B, 2E], [B])``, each K1/K2 round one
    launch for the whole batch.
    """
    valid = mate >= 0
    mate2, ok = splice_components(mate, stub_vertex, valid,
                                  rounds=splice_rounds)
    circuit = circuit_from_mate(mate2, first_valid(valid))
    return circuit, mate2, ok


# ---------------------------------------------------------------------------
# sharded Phase 3: CC + splice + rank over stub shards
# ---------------------------------------------------------------------------
#
# The reference runs this per mesh device on its [S] slice of the stub
# space, global ids [me·S, me·S + S), S = shard_width(E, n) ≈ 2E/n.  On one
# device every per-device array becomes a row of an [n, ...] tensor:
#
#   * ``axis_index`` → ``arange(n)`` (``me``, one per row);
#   * a ``ppermute`` along the ring i → i+1 → :func:`_ring`, a roll of the
#     row dimension, kept explicit so a multi-device engine can swap it
#     for point-to-point sends;
#   * ``psum`` → a sum over the rows; the tiled ``all_gather`` → a reshape;
#   * per-device scalars (``cnt``, ``of_t``, ``start``) → [n] tensors.
#
# A batch of B graphs (the reference's ``vmap`` over a batch axis after
# the partition axis) makes the rows (partition, graph) pairs, partition
# major: row p·B + b holds graph b's shard p, ``[n·B, S]``.  Every step is
# per row as before; a ring step rolls the partition axis (B rows), so a
# shard only ever meets its own graph's shards; the per-device scalars
# become [n·B], and the ``psum``s and the convergence flags sum over the
# partitions of each graph alone ([B]).  Ids stay each graph's own.
#
# Each ring loop processes all rows at once per step.  Masked rows of a
# scatter go to a pad slot of their row (``set``, one value) or to
# distinct spill slots (``min``), as in Phase 1, so nothing queues atomics
# on one address.  Byte-identity with the replicated path holds as in the
# reference: the doubling loops run at least as many rounds on the same
# snapshots, and each splice round re-runs the replicated path's per-
# vertex logic on the records its vertex owner holds.

def shard_width(num_edges: int, n_parts: int) -> int:
    """Per-shard stub width of the sharded Phase 3: the smallest EVEN S
    with n·S ≥ 2E, so a stub's sibling s^1 is always on its shard.

    >>> shard_width(128, 8), shard_width(100, 8), shard_width(3, 4)
    (32, 26, 2)
    """
    return max(2, 2 * math.ceil(num_edges / max(1, n_parts)))


def sharded_phase3_schedule(num_edges: int, n_parts: int,
                            gather_circuit: bool = True) -> dict:
    """The reference's static collective schedule of the sharded Phase 3,
    counted as its traced eqns (each ring loop traces one ``ppermute``
    and runs it ``n_parts`` times): one table ring per CC round, 6 rings
    and 1 ``psum`` per splice round (traced once), a ring-min and a
    ``psum`` for the halt stub, one table ring per rank round, and the
    emission's ``all_gather`` unless ``gather_circuit=False``.  On one
    device each ring step is a roll, each ``psum`` a row sum and the
    ``all_gather`` a reshape; the doubling rings are also the K3/K4
    launches, ``doubling_rounds × n_parts`` per loop (for a batch too:
    one launch serves every graph's rows)."""
    S = shard_width(num_edges, n_parts)
    total = n_parts * S
    rounds = _doubling_rounds(total)
    return {
        "shard_width": S,
        "stub_space": total,
        "doubling_rounds": rounds,
        "splice_rings": 6,
        "ppermute": 2 * rounds + 6 + 1,
        "psum": 2,
        "all_gather": 1 if gather_circuit else 0,
    }


def _ring(x: torch.Tensor, dim: int = 0, batch: int = 1) -> torch.Tensor:
    """One ``ppermute`` step along the ring i → i+1: partition i receives
    partition i−1's value.  Rows are (partition, graph) pairs, partition
    major, so the step rolls ``dim`` by ``batch`` rows.  Each ring loop
    (the reference's ``fori_loop`` around one ``ppermute``) runs inside
    ``capture.scope("ring")``; the census counts the steps."""
    capture.note("ring_step")
    return torch.roll(x, shifts=batch, dims=dim)


def _shard_ids(rows: int, S: int, batch: int, dev):
    """``(me [rows], gid [rows, S])``: each row's partition (its shard
    index within its graph) and the global ids of its stubs."""
    me = torch.arange(rows, dtype=I32, device=dev) // batch
    return me, me[:, None] * S + torch.arange(S, dtype=I32, device=dev)


def _ring_bases(me: torch.Tensor, k: int, S: int, n: int) -> torch.Tensor:
    """[rows] global offset of the table slice a row holds at ring step
    k, over a ring of ``n`` partitions."""
    return ((me - k) % n) * S


def _per_graph(x: torch.Tensor, batch: int) -> torch.Tensor:
    """``[rows]`` → ``[n, B]``: a per-row value by partition and graph."""
    return x.view(-1, batch)


def _doubling_sharded(kernel, q, carries, tables, me, S: int,
                      batch: int = 1):
    """One doubling round's table rotation: ``n`` ring steps of the shard
    kernel, each answering the queries the visiting slices own.  The
    answers ping-pong two buffer sets (a step reads step k−1 only); the
    starting ``carries`` are read, never written."""
    n = me.shape[0] // batch
    bufs = [tuple(torch.empty_like(a) for a in carries) for _ in range(2)]
    cur = carries
    with capture.scope("ring"):
        for k in range(n):
            if k:
                tables = _ring(tables, 1, batch)
            cur = kernel(q, *cur, _ring_bases(me, k, S, n), *tables,
                         s_real=S, out=bufs[k % 2])
    return cur


def _cc_labels_sharded(mate_sh: torch.Tensor, batch: int = 1
                       ) -> torch.Tensor:
    """Sharded twin of :func:`_cc_cycle_labels` over ``mate_sh`` [n, S]
    (a batch: [n·B, S]): min-label propagation by pointer doubling where
    each round resolves remote pointers with one full ring rotation of
    the (nxt, lab) table shards (K3, one launch per ring step)."""
    rows, S = mate_sh.shape
    me, gid = _shard_ids(rows, S, batch, mate_sh.device)
    nxt = torch.where(mate_sh >= 0, mate_sh ^ 1, gid)
    lab = gid
    for _ in range(_doubling_rounds(rows // batch * S)):
        a_nxt, a_lab = _doubling_sharded(
            pointer_double_shard, nxt,
            (nxt, torch.full_like(nxt, BIG)), torch.stack([nxt, lab]), me, S,
            batch)
        nxt = a_nxt
        lab = torch.minimum(lab, a_lab)
    sib = torch.arange(S, dtype=I32, device=mate_sh.device) ^ 1
    return torch.minimum(lab, lab[:, sib])


def _lexsort3_rows(k1, k2, k3) -> torch.Tensor:
    """Per-row stable order by ``k1``, then ``k2``, then ``k3`` —
    ``jnp.lexsort((k3, k2, k1))`` on each device — for non-negative int32
    keys: a stable sort by the int64 pair (k2, k3), then a stable sort of
    that order by k1."""
    order = torch.argsort((k2.to(torch.int64) << 32) | k3.to(torch.int64),
                          dim=1, stable=True)
    return order.gather(1, torch.argsort(take(k1, order), dim=1,
                                         stable=True))


def splice_components_sharded(mate_sh: torch.Tensor, sv_sh: torch.Tensor,
                              p3v_cap: int, rounds: int = 64,
                              lab: Optional[torch.Tensor] = None,
                              batch: Optional[int] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sharded twin of :func:`splice_components` over ``mate_sh`` and
    ``sv_sh`` [n, S] (a batch of B graphs: [n·B, S], rows partition
    major).

    Per round: canonical (stub, vertex, comp, mate) records ring-ship to
    their vertex owner (owner(v) = v mod n) into a [p3v_cap] table per
    row, where the replicated path's per-vertex rep/vote/rotate logic
    runs on the locally sorted records; mate rotations and component
    relabels ring back to the stub and label owners.  ``lab`` is
    :func:`_cc_labels_sharded` of ``mate_sh``, computed here when not
    given (the solver clocks the two steps apart).  Returns
    ``(mate_sh', ok)``, ``ok`` a 0-d bool (``[B]`` for a batch, each
    graph's own): convergence and no vertex-table overflow (an undersized
    ``p3v_cap`` fails the solve, never corrupts it).  A batch runs while
    any graph changes; a converged graph's extra rounds rotate nothing."""
    B = batch or 1
    rows, S = mate_sh.shape
    n = rows // B
    P = int(p3v_cap)
    dev = mate_sh.device
    me, gid = _shard_ids(rows, S, B, dev)
    mate_sh = mate_sh.to(I32)
    sv_sh = sv_sh.to(I32)
    if lab is None:
        lab = _cc_labels_sharded(mate_sh, B)
    lo = (me * S)[:, None]
    hi = lo + S
    row64 = torch.arange(rows, dtype=torch.int64, device=dev)[:, None]
    col = torch.arange(P, dtype=I32, device=dev)
    spill_v = rows * S + torch.arange(rows * P, dtype=torch.int64,
                                      device=dev).view(rows, P)

    def ring(x):
        return _ring(x, 1, B)

    def round_fn(mate, lab, of, _changed):
        cm = (mate >= 0) & (mate > gid)           # canonical stub per pair

        # ---- ring 1: ship canonical records to their vertex owner ----
        buf = torch.stack([torch.where(cm, gid, BIG),
                           torch.where(cm, sv_sh, BIG),
                           torch.where(cm, lab, BIG),
                           torch.where(cm, mate, BIG), cm.to(I32)])
        tbl = torch.full((4, rows * (P + 1)), BIG, dtype=I32, device=dev)
        cnt = torch.zeros(rows, dtype=I32, device=dev)
        of_t = torch.zeros(rows, dtype=torch.bool, device=dev)
        with capture.scope("ring"):
            for k in range(n):
                if k:
                    buf = ring(buf)
                bs, bv, bc, bm, bmk = buf
                mine = (bmk > 0) & (bv % n == me[:, None])
                pos = cnt[:, None] + torch.cumsum(mine, dim=1,
                                                  dtype=I32) - 1
                okw = mine & (pos < P)
                slot = row64 * (P + 1) + torch.where(okw, pos, P)
                tbl[:, slot.reshape(-1)] = torch.where(
                    okw, torch.stack([bv, bc, bs, bm]), BIG).reshape(4, -1)
                cnt = cnt + mine.sum(1, dtype=I32)
                of_t = of_t | (cnt > P)
        tv, tc, ts, tm = tbl.view(4, rows, P + 1)[:, :, :P]

        # ---- local per-vertex logic (the replicated path's) ----
        order = _lexsort3_rows(tv, tc, ts)
        gv, gc, gs, gm = (take(x, order) for x in (tv, tc, ts, tm))
        gmk = gv < BIG
        dup = torch.cat([_edge(gv, False),
                         (gv[:, 1:] == gv[:, :-1]) & (gc[:, 1:] == gc[:, :-1])],
                        dim=1)
        rep = gmk & ~dup
        vseg = torch.searchsorted(gv, gv, out_int32=True)
        n_rep = segment_sum(rep.to(I32), vseg, P, live=rep)
        cand = rep & (take(n_rep, vseg) >= 2)

        # ---- ring 2: scatter-min votes onto the comp-label owners ----
        vbuf = torch.stack([torch.where(cand, gc, BIG),
                            torch.where(cand, gv, BIG), cand.to(I32)])
        vote = torch.full((rows * S + rows * P,), BIG, dtype=I32, device=dev)
        with capture.scope("ring"):
            for k in range(n):
                if k:
                    vbuf = ring(vbuf)
                qc, qv, qm = vbuf
                own = (qm > 0) & (qc >= lo) & (qc < hi)
                ids = torch.where(own, row64 * S + (qc - lo), spill_v)
                vote.scatter_reduce_(0, ids.reshape(-1), qv.reshape(-1),
                                     "amin")
        vote = vote[:rows * S].view(rows, S)

        # ---- ring 3: read each record's comp vote back ----
        qc = torch.where(gmk, gc, BIG)
        va = torch.full_like(qc, BIG)
        with capture.scope("ring"):
            for _ in range(n):
                own = (qc >= lo) & (qc < hi)
                va = torch.where(own,
                                 take(vote, torch.where(own, qc - lo, 0)), va)
                qc, va = ring(torch.stack([qc, va]))

        voted = cand & (va == gv)
        n_take = segment_sum(voted.to(I32), vseg, P, live=voted)
        act = voted & (take(n_take, vseg) >= 2)

        # circular rotation pairs within each pivot vertex's act group
        akey = torch.where(act, gv, BIG)
        o2 = torch.argsort(akey, dim=1, stable=True)
        hv, hs, hc, hmate = (take(x, o2) for x in (akey, gs, gc, gm))
        hm = act.gather(1, o2)
        hstart = torch.searchsorted(hv, hv, out_int32=True)
        hlast = torch.cat([hv[:, 1:] != hv[:, :-1], _edge(hv, True)],
                          dim=1)
        hnxt = torch.where(hlast, hstart, col + 1).clamp(0, P - 1)
        b = take(hmate, hnxt)                     # mate of the next rep
        minc = segment_min(hc, hstart, P, live=hm)
        rot_c = take(minc, hstart)

        # ---- ring 4: deliver mate[a_i] ← b_{i+1}, mate[b_{i+1}] ← a_i ----
        wbuf = torch.stack([torch.where(hm, hs, BIG), torch.where(hm, b, BIG),
                            hm.to(I32)])
        mpad = torch.cat([mate, torch.full((rows, 1), -1, dtype=I32,
                                           device=dev)], dim=1).reshape(-1)
        with capture.scope("ring"):
            for k in range(n):
                if k:
                    wbuf = ring(wbuf)
                wa, wb, wm = wbuf
                own_a = (wm > 0) & (wa >= lo) & (wa < hi)
                mpad[row64 * (S + 1) + torch.where(own_a, wa - lo, S)] = \
                    torch.where(own_a, wb, -1)
                own_b = (wm > 0) & (wb >= lo) & (wb < hi)
                mpad[row64 * (S + 1) + torch.where(own_b, wb - lo, S)] = \
                    torch.where(own_b, wa, -1)
        mate_new = mpad.view(rows, S + 1)[:, :S]

        # ---- ring 5: deliver comp relabels to the label owners ----
        mbuf = torch.stack([torch.where(hm, hc, BIG),
                            torch.where(hm, rot_c, BIG), hm.to(I32)])
        lmap = torch.cat([gid, torch.zeros((rows, 1), dtype=I32, device=dev)],
                         dim=1).reshape(-1)
        with capture.scope("ring"):
            for k in range(n):
                if k:
                    mbuf = ring(mbuf)
                mo, mn, mm = mbuf
                own = (mm > 0) & (mo >= lo) & (mo < hi)
                lmap[row64 * (S + 1) + torch.where(own, mo - lo, S)] = \
                    torch.where(own, mn, 0)
        lmap = lmap.view(rows, S + 1)[:, :S]

        # ---- ring 6: every stub reads lmap[lab] from the label owner ----
        ql, lab_new = lab, lab
        with capture.scope("ring"):
            for _ in range(n):
                own = (ql >= lo) & (ql < hi)
                lab_new = torch.where(
                    own, take(lmap, torch.where(own, ql - lo, 0)), lab_new)
                ql, lab_new = ring(torch.stack([ql, lab_new]))

        # the psum of the flags: over each graph's partitions
        capture.note("psum")
        return (mate_new, lab_new, of | _per_graph(of_t, B).any(0),
                _per_graph(hm.any(1), B).any(0))

    mate_sh, _, of, changed = converge(
        round_fn, (mate_sh, lab, torch.zeros(B, dtype=torch.bool, device=dev),
                   torch.ones(B, dtype=torch.bool, device=dev)), rounds)
    ok = ~changed & ~of
    return mate_sh, (ok if batch else ok[0])


def _rank_sharded(mate_sh: torch.Tensor, batch: int = 1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sharded list ranking: the doubling loop of :func:`circuit_from_mate`
    over rotating (ptr, dist, reach) table shards (K4, one launch per ring
    step).  Returns the [n, S] (a batch: [n·B, S]) (dist, reach)
    shards."""
    rows, S = mate_sh.shape
    n = rows // batch
    me, gid = _shard_ids(rows, S, batch, mate_sh.device)
    valid = mate_sh >= 0
    nxt = torch.where(valid, mate_sh ^ 1, gid)

    # global start stub = min valid gid, by a ring-min of the row minima
    acc = rot = torch.where(valid, gid, BIG).amin(dim=1)
    with capture.scope("ring"):
        for _ in range(n):
            rot = _ring(rot, 0, batch)
            acc = torch.minimum(acc, rot)
    # halt stub t = mate[start ^ 1], fetched from its owner by one psum
    # over each graph's partitions, then broadcast to its rows
    capture.note("psum")
    q = (acc ^ 1)[:, None]
    t = _per_graph(torch.where(gid == q, mate_sh, 0).sum(dim=1),
                   batch).sum(0).to(I32).repeat(n)

    halt = gid == t[:, None]
    ptr = torch.where(halt, gid, nxt)
    dist = (~halt).to(I32)
    reach = halt.to(I32)
    zero = torch.zeros_like(ptr)
    for _ in range(_doubling_rounds(n * S)):
        a_ptr, a_dist, a_reach = _doubling_sharded(
            pointer_double_rank_shard, ptr, (ptr, zero, zero),
            torch.stack([ptr, dist, reach]), me, S, batch)
        ptr = a_ptr
        dist = dist + a_dist
        reach = torch.maximum(reach, a_reach)
    return dist, reach


def unshard(x: torch.Tensor, batch: Optional[int]) -> torch.Tensor:
    """The tiled ``all_gather``: ``[n, S, ·]`` shards read as one ``[n·S,
    ·]`` stub space (a reshape); a batch's ``[n·B, S, ·]`` rows as ``[B,
    n·S, ·]``, one stub space a graph."""
    if batch is None:
        return x.reshape(-1, *x.shape[2:])
    n = x.shape[0] // batch
    return x.view(n, batch, *x.shape[1:]).transpose(0, 1).reshape(
        batch, -1, *x.shape[2:])


def gather_circuit_sharded(mate_sh: torch.Tensor, dist_sh: torch.Tensor,
                           reach_sh: torch.Tensor, n_stubs: int,
                           batch: Optional[int] = None):
    """The reference's emission ``all_gather``: the [n, S] shards read as
    one [n·S] stub space (:func:`unshard`), cut to ``n_stubs`` and
    emitted by :func:`emit_circuit`.  Returns ``(circuit [E], mate
    [n_stubs])``, for a batch ``([B, E], [B, n_stubs])``."""
    capture.note("all_gather")
    mate, dist, reach = (unshard(x, batch)[..., :n_stubs]
                         for x in (mate_sh, dist_sh, reach_sh))
    return emit_circuit(mate >= 0, dist, reach), mate


def phase3_sharded(mate_sh: torch.Tensor, sv_sh: torch.Tensor,
                   n_stubs: int, p3v_cap: int, splice_rounds: int = 64,
                   gather_circuit: bool = True,
                   batch: Optional[int] = None):
    """Full sharded Phase 3 over the [n, S] stub shards (``mate_sh``
    padded with −1 past ``n_stubs``, ``sv_sh`` with vertex 0), or over a
    batch's [n·B, S] rows.

    With ``gather_circuit=True`` returns ``(circuit [E], mate [n_stubs],
    ok)`` exactly like :func:`phase3_device` (a batch: ``[B, E]``, ``[B,
    n_stubs]``, ``[B]``).  With ``gather_circuit=False`` nothing is
    gathered: returns the still sharded ``(mate_sh, dist_sh, reach_sh,
    ok)``, from which the caller emits host-side with
    :func:`emit_circuit_np`."""
    mate2_sh, ok = splice_components_sharded(mate_sh, sv_sh, p3v_cap,
                                             rounds=splice_rounds,
                                             batch=batch)
    dist_sh, reach_sh = _rank_sharded(mate2_sh, batch or 1)
    if not gather_circuit:
        return mate2_sh, dist_sh, reach_sh, ok
    circuit, mate2 = gather_circuit_sharded(mate2_sh, dist_sh, reach_sh,
                                            n_stubs, batch)
    return circuit, mate2, ok
