"""Phase 1 — the superstep body, every partition at once (mirrors
``repro/core/phase1.py``).

The paper's sequential Hierholzer walk (Alg. 1) in vectorized form, over
masked fixed-capacity tables:

  1. *pair* the stub pool (new local edges' stubs + inherited open path
     endpoints) per vertex — sort + parity pairing;
  2. *label* components by hook+jump connected components over the
     component-merge graph the new pairs induce;
  3. *splice* components sharing an owned vertex by mate rotations, with
     a vote that gives each component at most one rotation per round.

The reference runs this per mesh device.  Here every table arrives as
``[n, ·]``, one row per partition, and every op works row by row, so row
``p`` is the reference's device ``p``; a single partition is ``n = 1``.
Component ids are min member stub ids.  The port keeps the reference's
int32 values and its masking exactly, so every output is byte-identical.
How jnp maps onto torch here:

  * ``jnp.lexsort((k2, k1))`` → one stable argsort of the int64 key
    ``k1 << 32 | k2`` along the last dimension (:func:`lexsort2`; both
    keys are non-negative int32);
  * ``associative_scan(maximum)`` over segment starts → a search of the
    sorted keys in themselves (:func:`_seg_starts`), row by row;
  * ``x[idx]`` → ``gather`` along the last dimension (:func:`take`);
  * ``segment_min``/``segment_sum`` → ``scatter_reduce_("amin")`` into a
    BIG-filled buffer / ``index_add_`` over flat ids ``row·num + id``
    (:func:`segment_min`, :func:`segment_sum`); rows that cannot change
    a segment (masked ones) go to distinct spill slots past ``n·num`` so
    they never pile atomics onto one address;
  * every gather index is clipped exactly where the reference clips, so
    no index leaves its row;
  * the splice ``while_loop`` is :func:`~repro_torch.core.capture.converge`
    over a per-row ``changed`` flag, stopping when no row changes: a
    converged row that runs more rounds is unchanged (the round is the
    identity when nothing rotates), so each row ends as the reference's
    per-device loop does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from .capture import converge

I32 = torch.int32
BIG = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class Phase1Caps:
    open_cap: int           # max carried-forward path endpoints
    touch_cap: int          # max representative pairs at boundary vertices
    hook_rounds: int = 0    # 0 → ceil(log2(comp universe)) + 2
    splice_rounds: int = 12
    static_splice: bool = False  # run every splice round, no early stop


class OpenTable(NamedTuple):
    stub: torch.Tensor   # [n, OC] stub id
    vert: torch.Tensor   # [n, OC] vertex the stub is incident on
    la: torch.Tensor     # [n, OC] last-activation level of the vertex
    comp: torch.Tensor   # [n, OC] component id (min member stub id)
    mask: torch.Tensor   # [n, OC] bool


class TouchTable(NamedTuple):
    s1: torch.Tensor     # [n, TC]
    s2: torch.Tensor     # [n, TC] current mate of s1 (same vertex)
    vert: torch.Tensor   # [n, TC]
    la: torch.Tensor     # [n, TC]
    comp: torch.Tensor   # [n, TC]
    mask: torch.Tensor   # [n, TC] bool


class NewEdges(NamedTuple):
    eid: torch.Tensor    # [n, NE] global edge id
    u: torch.Tensor      # [n, NE]
    v: torch.Tensor      # [n, NE]
    lau: torch.Tensor    # [n, NE] last-activation level of u
    lav: torch.Tensor    # [n, NE] last-activation level of v
    mask: torch.Tensor   # [n, NE] bool


class Phase1Out(NamedTuple):
    opens: OpenTable
    touch: TouchTable
    log_s1: torch.Tensor        # [n, PC] mate-log: mate[log_s1] = log_s2
    log_s2: torch.Tensor
    log_mask: torch.Tensor
    n_components: torch.Tensor  # [n] live components touching each partition
    flags: torch.Tensor         # [n, 3] bool: cc converged, splice converged, no overflow


def pair_table_cap(pool: int, touch_cap: int) -> int:
    """Width of Phase 1's compacted pair table: at most half the stub pool
    can pair, plus the inherited touch pairs."""
    return pool // 2 + touch_cap


# ---------------------------------------------------------------------------
# jnp idioms in torch, along the last dimension (shared with phase3 and
# the engine)
# ---------------------------------------------------------------------------

def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` on every row: ``x[..., idx[..., j]]``."""
    return x.gather(-1, idx.to(torch.int64))


def lexsort2(k1: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
    """Stable order by ``k1`` then ``k2`` — ``jnp.lexsort((k2, k1))`` —
    for non-negative int32 keys, row by row."""
    key = (k1.to(torch.int64) << 32) | k2.to(torch.int64)
    return torch.argsort(key, dim=-1, stable=True)


def _spill(ids: torch.Tensor, live, num: int):
    """Flat segment ids ``row·num + id`` of ``[n, X]`` (or ``[X]``) ids,
    with the rows where ``live`` is False sent to distinct spill slots
    past ``n·num``.  Those rows must not change the result (the identity
    of the reduction, or a self-loop hook), so dropping them is exact;
    spreading them out keeps the thousands of masked rows of a padded
    table from queueing atomics on one address.  Returns (flat ids,
    buffer width, rows)."""
    rows = ids.shape[0] if ids.dim() == 2 else 1
    ids = ids.to(torch.int64)
    if ids.dim() == 2:
        ids = ids + torch.arange(rows, dtype=torch.int64,
                                 device=ids.device)[:, None] * num
    ids = ids.reshape(-1)
    width = rows * num
    if live is None:
        return ids, width, rows
    spill = torch.arange(width, width + ids.shape[0], dtype=torch.int64,
                         device=ids.device)
    return torch.where(live.reshape(-1), ids, spill), width + ids.shape[0], \
        rows


def _segments(out: torch.Tensor, rows: int, num: int, like: torch.Tensor):
    out = out[:rows * num]
    return out.view(rows, num) if like.dim() == 2 else out


def segment_sum(vals: torch.Tensor, ids: torch.Tensor, num: int,
                live: Optional[torch.Tensor] = None):
    """``jax.ops.segment_sum`` for ids in ``[0, num)``, on each row of
    ``[n, X]`` ids (``[n, num]`` out) or on ``[X]`` ids; rows where
    ``live`` is False must hold 0 and are left out."""
    flat, width, rows = _spill(ids, live, num)
    out = torch.zeros(width, dtype=vals.dtype, device=vals.device)
    out.index_add_(0, flat, vals.reshape(-1))
    return _segments(out, rows, num, ids)


def segment_min(vals: torch.Tensor, ids: torch.Tensor, num: int,
                live: Optional[torch.Tensor] = None):
    """``jax.ops.segment_min`` for ids in ``[0, num)``, per row as
    :func:`segment_sum`; empty segments hold BIG (int32 max), the
    identity of min.  Rows where ``live`` is False must not lower their
    segment's min and are left out."""
    flat, width, rows = _spill(ids, live, num)
    out = torch.full((width,), BIG, dtype=vals.dtype, device=vals.device)
    out.scatter_reduce_(0, flat, vals.reshape(-1), "amin", include_self=True)
    return _segments(out, rows, num, ids)


def _valid_first(mask: torch.Tensor) -> torch.Tensor:
    """Stable order putting the entries where ``mask`` holds first, per
    row."""
    return torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)


def _compact(arrays, mask, cap: int):
    """Move each row's valid entries to its front and truncate to
    ``cap``.  Returns (arrays, mask, per-row overflow)."""
    order = _valid_first(mask)[..., :cap]
    overflow = mask.sum(-1) > cap
    return tuple(take(a, order) for a in arrays), take(mask, order), overflow


def _seg_starts(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Index of each element's segment start, for keys sorted along the
    last dimension: the first position holding its value, which is what
    the reference's max-scan over segment-start indices computes.
    (``torch.cummax`` would match it too, but scans one long row in a
    single CUDA block.)  Int64: the result only ever indexes."""
    return torch.searchsorted(sorted_keys, sorted_keys)


def _searchsorted_clip(sorted_vals: torch.Tensor, vals: torch.Tensor):
    """``clip(searchsorted(sorted, vals), 0, K-1)`` (side left), row by
    row; int64, as it only ever indexes."""
    j = torch.searchsorted(sorted_vals, vals)
    return j.clamp(0, sorted_vals.shape[-1] - 1)


def _edge(x: torch.Tensor, value: bool) -> torch.Tensor:
    """A ``[n, 1]`` bool column, to prepend or append to ``[n, K]`` rows."""
    return torch.full((x.shape[0], 1), value, dtype=torch.bool,
                      device=x.device)


def _cc_hook_jump(ca, cb, emask, universe, rounds: int):
    """Min-label connected components over a value-keyed graph, per row.

    Nodes are the values in ``universe`` ([n, K], BIG-padded); edges are
    (ca[i], cb[i]) where ``emask[i]``.  Returns (sorted universe,
    root *value* per universe slot, per-row converged flag [n]).
    """
    n, K = universe.shape
    uniq = torch.sort(universe, dim=-1).values
    ia = _searchsorted_clip(uniq, torch.where(emask, ca, BIG))
    ib = _searchsorted_clip(uniq, torch.where(emask, cb, BIG))
    ia = torch.where(emask, ia, K - 1)
    ib = torch.where(emask, ib, K - 1)
    lab = torch.arange(K, dtype=I32, device=universe.device).repeat(n, 1)

    def hook(lab, ea, eb):
        m = torch.minimum(take(lab, ea), take(lab, eb))
        # a self-loop (every masked edge, every contracted one) offers its
        # node its own label, which the final minimum already holds
        live = ea != eb
        return torch.minimum(lab, segment_min(
            torch.cat([m, m], -1), torch.cat([ea, eb], -1), K,
            live=torch.cat([live, live], -1)))

    ea, eb = ia, ib
    for _ in range(rounds):
        lab = hook(lab, ea, eb)
        lab = take(lab, lab)
        lab = take(lab, lab)
        # Borůvka-style edge contraction: relabel endpoints to super-nodes
        ea, eb = take(lab, ea), take(lab, eb)
    converged = (hook(lab, ea, eb) == lab).all(-1)
    return uniq, take(uniq, lab), converged


def _value_lookup(uniq, root_val, values):
    """Map values through (uniq → root_val); identity for missing values."""
    j = _searchsorted_clip(uniq, values)
    return torch.where(take(uniq, j) == values, take(root_val, j), values)


def phase1_local(
    new: NewEdges,
    opens: OpenTable,
    touch: TouchTable,
    level: int,
    caps: Phase1Caps,
) -> Phase1Out:
    """Phase 1 of every partition at one level: row ``p`` of each table
    and output is partition ``p``."""
    dev = new.eid.device
    n = new.eid.shape[0]
    f1 = _edge(new.eid, False)
    t1 = _edge(new.eid, True)
    # ------------------------------------------------------------------
    # 1. stub pool = new edges' stubs + inherited open endpoints
    # ------------------------------------------------------------------
    nm, om = new.mask, opens.mask
    pool_stub = torch.cat(
        [torch.where(nm, 2 * new.eid, BIG),
         torch.where(nm, 2 * new.eid + 1, BIG),
         torch.where(om, opens.stub, BIG)], -1)
    pool_vert = torch.cat(
        [torch.where(nm, new.u, BIG), torch.where(nm, new.v, BIG),
         torch.where(om, opens.vert, BIG)], -1)
    pool_la = torch.cat(
        [torch.where(nm, new.lau, 0), torch.where(nm, new.lav, 0),
         torch.where(om, opens.la, 0)], -1)
    pool_comp = torch.cat(
        [torch.where(nm, 2 * new.eid, BIG), torch.where(nm, 2 * new.eid, BIG),
         torch.where(om, opens.comp, BIG)], -1)
    pool_mask = torch.cat([nm, nm, om], -1)
    P = pool_stub.shape[-1]

    # ------------------------------------------------------------------
    # 2. pair per vertex: sort by vertex (stable), pair consecutive
    # ------------------------------------------------------------------
    vkey = torch.where(pool_mask, pool_vert, BIG)
    order = torch.argsort(vkey, dim=-1, stable=True)
    sv, ss = take(vkey, order), take(pool_stub, order)
    sc, sl, sm = (take(pool_comp, order), take(pool_la, order),
                  take(pool_mask, order))
    pos = torch.arange(P, dtype=I32, device=dev) - _seg_starts(sv)
    nxt_same = torch.cat([sv[:, 1:] == sv[:, :-1], f1], -1)
    has_partner = (pos % 2 == 0) & sm & (sv < BIG) & nxt_same
    pr_a = torch.where(has_partner, ss, BIG)
    pr_b = torch.where(has_partner, torch.roll(ss, -1, dims=-1), BIG)
    pr_v = torch.where(has_partner, sv, BIG)
    pr_la = torch.where(has_partner, sl, 0)
    pr_ca = torch.where(has_partner, sc, BIG)
    pr_cb = torch.where(has_partner, torch.roll(sc, -1, dims=-1), BIG)
    pr_mask = has_partner
    paired = has_partner | torch.cat([f1, has_partner[:, :-1]], -1)
    left_mask = sm & ~paired & (sv < BIG)

    # ------------------------------------------------------------------
    # 3. component labels after pairing (hook + jump CC over comp values)
    # ------------------------------------------------------------------
    universe = torch.cat([torch.where(sm, sc, BIG),
                          torch.where(touch.mask, touch.comp, BIG)], -1)
    uniq, root_val, cc_ok = _cc_hook_jump(
        pr_ca, pr_cb, pr_mask, universe,
        caps.hook_rounds or int(math.ceil(math.log2(
            max(2, universe.shape[-1])))) + 2,
    )
    open_comp = _value_lookup(uniq, root_val, torch.where(left_mask, sc, BIG))
    pair_comp = _value_lookup(uniq, root_val, pr_ca)
    touch_comp = _value_lookup(uniq, root_val,
                               torch.where(touch.mask, touch.comp, BIG))

    # ------------------------------------------------------------------
    # 4. unified pair table (this level's pairs + inherited touch pairs)
    # ------------------------------------------------------------------
    q_s1 = torch.cat([pr_a, torch.where(touch.mask, touch.s1, BIG)], -1)
    q_s2 = torch.cat([pr_b, torch.where(touch.mask, touch.s2, BIG)], -1)
    q_v = torch.cat([pr_v, torch.where(touch.mask, touch.vert, BIG)], -1)
    q_la = torch.cat([pr_la, torch.where(touch.mask, touch.la, 0)], -1)
    q_c = torch.cat([pair_comp, touch_comp], -1)
    q_m = torch.cat([pr_mask, touch.mask], -1)
    # at most half the pool can pair: compact before the splice loop
    (q_s1, q_s2, q_v, q_la, q_c), q_m, _ = _compact(
        (q_s1, q_s2, q_v, q_la, q_c), q_m,
        pair_table_cap(P, touch.mask.shape[-1]),
    )
    PC = q_s1.shape[-1]
    q_c_pre = q_c          # pre-splice comps of the compacted pair table
    iota_pc = torch.arange(PC, dtype=I32, device=dev)
    K = uniq.shape[-1]

    oc = torch.sort(open_comp, dim=-1).values  # sorted open comps

    def is_path(comps, oc_sorted):
        j = _searchsorted_clip(oc_sorted, comps)
        return (take(oc_sorted, j) == comps) & (comps < BIG)

    # ------------------------------------------------------------------
    # 5. splice rounds
    # ------------------------------------------------------------------
    def splice_round(s2, cmp_, oc_sorted, _changed):
        vm = torch.where(q_m, q_v, BIG)
        order2 = lexsort2(vm, cmp_)
        gv, gc = take(vm, order2), take(cmp_, order2)
        gs2 = take(s2, order2)
        gm = take(q_m, order2)
        dup = torch.cat([f1, (gv[:, 1:] == gv[:, :-1])
                         & (gc[:, 1:] == gc[:, :-1])], -1)
        rep = gm & ~dup & (gv < BIG)
        seg = _seg_starts(gv)
        gpath = is_path(gc, oc_sorted) & rep
        n_rep = segment_sum(rep.to(I32), seg, PC, live=rep)
        cyc = rep & ~gpath
        n_cyc = segment_sum(cyc.to(I32), seg, PC, live=cyc)
        cand = rep & (take(n_rep, seg) >= 2) & (take(n_cyc, seg) >= 1)
        # each comp votes for its min candidate vertex
        ci = _searchsorted_clip(uniq, gc)
        vote = segment_min(gv, ci, K, live=cand)
        voted = cand & (take(vote, ci) == gv)
        # at most one path per vertex: cycles + the min-comp voted path
        pthmin = segment_min(gc, seg, PC, live=voted & gpath)
        take_ = voted & (~gpath | (gc == take(pthmin, seg)))
        n_take = segment_sum(take_.to(I32), seg, PC, live=take_)
        act = take_ & (take(n_take, seg) >= 2)
        # rotation among act members, circular within vertex segment
        akey = torch.where(act, gv, BIG)
        o4 = torch.argsort(akey, dim=-1, stable=True)
        hv, hs2, hc = take(akey, o4), take(gs2, o4), take(gc, o4)
        hm = take(act, o4)
        hstart = _seg_starts(hv)
        hlast = torch.cat([hv[:, 1:] != hv[:, :-1], t1], -1)
        hnxt = torch.where(hlast, hstart, iota_pc + 1).clamp(0, PC - 1)
        rot_s2 = torch.where(hm, take(hs2, hnxt), hs2)
        minc = segment_min(hc, hstart, PC, live=hm)
        rot_c = torch.where(hm, take(minc, hstart), hc)
        changed = hm.any(-1)
        # single unsort: active-space position p ↦ original index order2[o4[p]]
        orig = take(order2, o4)
        s2_new = torch.zeros_like(s2).scatter_(-1, orig, rot_s2)
        did = torch.zeros_like(q_m).scatter_(-1, orig, hm)
        s2_new = torch.where(did, s2_new, s2)
        # comp relabel map (from → min comp at its rotation vertex)
        mfrom = torch.where(hm, hc, BIG)
        mto = torch.where(hm, rot_c, BIG)
        mo = torch.argsort(mfrom, dim=-1, stable=True)
        mfrom, mto = take(mfrom, mo), take(mto, mo)

        def relabel(vals):
            j = _searchsorted_clip(mfrom, vals)
            return torch.where(take(mfrom, j) == vals, take(mto, j), vals)

        return (s2_new, relabel(cmp_),
                torch.sort(relabel(oc_sorted), dim=-1).values, changed)

    carry = (q_s2, q_c, oc, torch.ones(n, dtype=torch.bool, device=dev))
    if caps.static_splice:
        for _ in range(caps.splice_rounds):
            carry = splice_round(*carry)
        q_s2, q_c, oc, _ = carry
        splice_ok = torch.ones(n, dtype=torch.bool, device=dev)
    else:
        q_s2, q_c, oc, changed = converge(splice_round, carry,
                                          caps.splice_rounds)
        splice_ok = ~changed

    # ------------------------------------------------------------------
    # 6. rebuild tables
    # ------------------------------------------------------------------
    # splice relabels only decrease, so CC over (pre-splice comp → final
    # comp) pairs maps every original comp to its final id
    uniq3, root3, cc3_ok = _cc_hook_jump(
        q_c_pre,
        q_c,
        q_m,
        torch.cat([universe, torch.where(q_m, q_c, BIG)], -1),
        caps.hook_rounds or int(math.ceil(math.log2(
            max(2, 2 * universe.shape[-1])))) + 2,
    )
    open_comp_final = _value_lookup(uniq3, root3, open_comp)

    (o_stub, o_vert, o_la, o_comp), o_mask, open_of = _compact(
        (torch.where(left_mask, ss, BIG), torch.where(left_mask, sv, BIG),
         torch.where(left_mask, sl, 0), open_comp_final),
        left_mask, caps.open_cap,
    )
    new_opens = OpenTable(o_stub, o_vert, o_la, o_comp, o_mask)

    # touch = pairs at vertices that still activate later, dedup (v, comp)
    keep = q_m & (q_la > level)
    tv = torch.where(keep, q_v, BIG)
    tc = torch.where(keep, q_c, BIG)
    ot = lexsort2(tv, tc)
    dv, dc = take(tv, ot), take(tc, ot)
    dup2 = torch.cat([f1, (dv[:, 1:] == dv[:, :-1])
                      & (dc[:, 1:] == dc[:, :-1])], -1)
    tm = take(keep, ot) & ~dup2
    (t_s1, t_s2, t_v, t_la, t_c), t_m, touch_of = _compact(
        tuple(take(x, ot) for x in (q_s1, q_s2, q_v, q_la, q_c)), tm,
        caps.touch_cap)
    new_touch = TouchTable(t_s1, t_s2, t_v, t_la, t_c, t_m)

    live = torch.sort(torch.cat(
        [torch.where(o_mask, o_comp, BIG), torch.where(t_m, t_c, BIG)], -1),
        dim=-1).values
    n_comp = ((live < BIG)
              & torch.cat([t1, live[:, 1:] != live[:, :-1]], -1)).sum(-1)

    flags = torch.stack([cc_ok & cc3_ok, splice_ok, ~(open_of | touch_of)],
                        -1)
    return Phase1Out(
        opens=new_opens,
        touch=new_touch,
        log_s1=torch.where(q_m, q_s1, BIG),
        log_s2=torch.where(q_m, q_s2, BIG),
        log_mask=q_m,
        n_components=n_comp.to(I32),
        flags=flags,
    )
