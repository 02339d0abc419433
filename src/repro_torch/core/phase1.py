"""Phase 1 — the per-partition superstep body (mirrors
``repro/core/phase1.py``).

The paper's sequential Hierholzer walk (Alg. 1) in vectorized form, over
one partition's masked fixed-capacity tables:

  1. *pair* the stub pool (new local edges' stubs + inherited open path
     endpoints) per vertex — sort + parity pairing;
  2. *label* components by hook+jump connected components over the
     component-merge graph the new pairs induce;
  3. *splice* components sharing an owned vertex by mate rotations, with
     a vote that gives each component at most one rotation per round.

Component ids are min member stub ids.  The port keeps the reference's
int32 values and its masking exactly, so every output is byte-identical.
How jnp maps onto torch here:

  * ``jnp.lexsort((k2, k1))`` → one stable argsort of the int64 key
    ``k1 << 32 | k2`` (:func:`lexsort2`; both keys are non-negative int32);
  * ``associative_scan(maximum)`` over segment starts → a search of the
    sorted keys in themselves (:func:`_seg_starts`);
  * ``segment_min``/``segment_sum`` → ``scatter_reduce_("amin")`` into a
    BIG-filled buffer / ``index_add_`` (:func:`segment_min`,
    :func:`segment_sum`); every segment id here lies in range, and rows
    that cannot change a segment (masked ones) go to spill slots so they
    never pile atomics onto one address;
  * every gather index is clipped exactly where the reference clips, so
    no index leaves its table;
  * the splice ``while_loop`` is a Python loop reading one flag per round.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

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
    stub: torch.Tensor   # [OC] stub id
    vert: torch.Tensor   # [OC] vertex the stub is incident on
    la: torch.Tensor     # [OC] last-activation level of the vertex
    comp: torch.Tensor   # [OC] component id (min member stub id)
    mask: torch.Tensor   # [OC] bool


class TouchTable(NamedTuple):
    s1: torch.Tensor     # [TC]
    s2: torch.Tensor     # [TC] current mate of s1 (same vertex)
    vert: torch.Tensor   # [TC]
    la: torch.Tensor     # [TC]
    comp: torch.Tensor   # [TC]
    mask: torch.Tensor   # [TC] bool


class NewEdges(NamedTuple):
    eid: torch.Tensor    # [NE] global edge id
    u: torch.Tensor      # [NE]
    v: torch.Tensor      # [NE]
    lau: torch.Tensor    # [NE] last-activation level of u
    lav: torch.Tensor    # [NE] last-activation level of v
    mask: torch.Tensor   # [NE] bool


class Phase1Out(NamedTuple):
    opens: OpenTable
    touch: TouchTable
    log_s1: torch.Tensor        # [PC] mate-log: mate[log_s1] = log_s2
    log_s2: torch.Tensor
    log_mask: torch.Tensor
    n_components: torch.Tensor  # [] live components touching this partition
    flags: torch.Tensor         # [3] bool: cc converged, splice converged, no overflow


def pair_table_cap(pool: int, touch_cap: int) -> int:
    """Width of Phase 1's compacted pair table: at most half the stub pool
    can pair, plus the inherited touch pairs."""
    return pool // 2 + touch_cap


# ---------------------------------------------------------------------------
# jnp idioms in torch (shared with phase3 and the engine)
# ---------------------------------------------------------------------------

def lexsort2(k1: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
    """Stable order by ``k1`` then ``k2`` — ``jnp.lexsort((k2, k1))`` —
    for non-negative int32 keys."""
    key = (k1.to(torch.int64) << 32) | k2.to(torch.int64)
    return torch.argsort(key, stable=True)


def _spill(ids: torch.Tensor, live, num: int):
    """Segment ids with the rows where ``live`` is False sent to distinct
    spill slots past ``num``.  Those rows must not change the result (the
    identity of the reduction, or a self-loop hook), so dropping them is
    exact; spreading them out keeps the thousands of masked rows of a
    padded table from queueing atomics on one address."""
    ids = ids.to(torch.int64)
    if live is None:
        return ids, num
    n = ids.shape[0]
    spill = torch.arange(num, num + n, dtype=torch.int64, device=ids.device)
    return torch.where(live, ids, spill), num + n


def segment_sum(vals: torch.Tensor, ids: torch.Tensor, num: int,
                live: Optional[torch.Tensor] = None):
    """``jax.ops.segment_sum`` for ids in ``[0, num)``; rows where ``live``
    is False must hold 0 and are left out."""
    ids, width = _spill(ids, live, num)
    out = torch.zeros(width, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, ids, vals)[:num]


def segment_min(vals: torch.Tensor, ids: torch.Tensor, num: int,
                live: Optional[torch.Tensor] = None):
    """``jax.ops.segment_min`` for ids in ``[0, num)``; empty segments
    hold BIG (int32 max), the identity of min.  Rows where ``live`` is
    False must not lower their segment's min and are left out."""
    ids, width = _spill(ids, live, num)
    out = torch.full((width,), BIG, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, ids, vals, "amin", include_self=True)[:num]


def _valid_first(mask: torch.Tensor) -> torch.Tensor:
    """Stable order putting the rows where ``mask`` holds first."""
    return torch.argsort((~mask).to(torch.uint8), stable=True)


def _compact(arrays, mask, cap: int):
    """Move valid entries to the front and truncate to ``cap``."""
    order = _valid_first(mask)
    overflow = mask.sum() > cap
    outs = tuple(a[order][:cap] for a in arrays)
    return outs, mask[order][:cap], overflow


def _seg_starts(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Index of each element's segment start, for sorted keys: the first
    position holding its value, which is what the reference's max-scan
    over segment-start indices computes.  (``torch.cummax`` would match
    it too, but scans one long row in a single CUDA block.)"""
    return torch.searchsorted(sorted_keys, sorted_keys, out_int32=True)


def _searchsorted_clip(sorted_vals: torch.Tensor, vals: torch.Tensor):
    """``clip(searchsorted(sorted, vals), 0, K-1)`` as int32 (side left)."""
    j = torch.searchsorted(sorted_vals, vals, out_int32=True)
    return j.clamp(0, sorted_vals.shape[0] - 1)


def _cc_hook_jump(ca, cb, emask, universe, rounds: int):
    """Min-label connected components over a value-keyed graph.

    Nodes are the values in ``universe`` ([K], BIG-padded); edges are
    (ca[i], cb[i]) where ``emask[i]``.  Returns (sorted universe,
    root *value* per universe slot, converged flag).
    """
    K = universe.shape[0]
    uniq = torch.sort(universe).values
    ia = _searchsorted_clip(uniq, torch.where(emask, ca, BIG))
    ib = _searchsorted_clip(uniq, torch.where(emask, cb, BIG))
    ia = torch.where(emask, ia, K - 1)
    ib = torch.where(emask, ib, K - 1)
    lab = torch.arange(K, dtype=I32, device=universe.device)

    def hook(lab, ea, eb):
        m = torch.minimum(lab[ea], lab[eb])
        # a self-loop (every masked edge, every contracted one) offers its
        # node its own label, which the final minimum already holds
        live = ea != eb
        return torch.minimum(lab, segment_min(torch.cat([m, m]),
                                              torch.cat([ea, eb]), K,
                                              live=torch.cat([live, live])))

    ea, eb = ia, ib
    for _ in range(rounds):
        lab = hook(lab, ea, eb)
        lab = lab[lab]
        lab = lab[lab]
        # Borůvka-style edge contraction: relabel endpoints to super-nodes
        ea, eb = lab[ea], lab[eb]
    converged = (hook(lab, ea, eb) == lab).all()
    return uniq, uniq[lab], converged


def _value_lookup(uniq, root_val, values):
    """Map values through (uniq → root_val); identity for missing values."""
    j = _searchsorted_clip(uniq, values)
    return torch.where(uniq[j] == values, root_val[j], values)


def phase1_local(
    new: NewEdges,
    opens: OpenTable,
    touch: TouchTable,
    level: int,
    caps: Phase1Caps,
) -> Phase1Out:
    """One partition's Phase 1 at one level."""
    dev = new.eid.device
    f1 = torch.zeros(1, dtype=torch.bool, device=dev)
    t1 = torch.ones(1, dtype=torch.bool, device=dev)
    # ------------------------------------------------------------------
    # 1. stub pool = new edges' stubs + inherited open endpoints
    # ------------------------------------------------------------------
    nm, om = new.mask, opens.mask
    pool_stub = torch.cat(
        [torch.where(nm, 2 * new.eid, BIG),
         torch.where(nm, 2 * new.eid + 1, BIG),
         torch.where(om, opens.stub, BIG)])
    pool_vert = torch.cat(
        [torch.where(nm, new.u, BIG), torch.where(nm, new.v, BIG),
         torch.where(om, opens.vert, BIG)])
    pool_la = torch.cat(
        [torch.where(nm, new.lau, 0), torch.where(nm, new.lav, 0),
         torch.where(om, opens.la, 0)])
    pool_comp = torch.cat(
        [torch.where(nm, 2 * new.eid, BIG), torch.where(nm, 2 * new.eid, BIG),
         torch.where(om, opens.comp, BIG)])
    pool_mask = torch.cat([nm, nm, om])
    P = pool_stub.shape[0]

    # ------------------------------------------------------------------
    # 2. pair per vertex: sort by vertex (stable), pair consecutive
    # ------------------------------------------------------------------
    vkey = torch.where(pool_mask, pool_vert, BIG)
    order = torch.argsort(vkey, stable=True)
    sv, ss = vkey[order], pool_stub[order]
    sc, sl, sm = pool_comp[order], pool_la[order], pool_mask[order]
    pos = torch.arange(P, dtype=I32, device=dev) - _seg_starts(sv)
    nxt_same = torch.cat([sv[1:] == sv[:-1], f1])
    has_partner = (pos % 2 == 0) & sm & (sv < BIG) & nxt_same
    pr_a = torch.where(has_partner, ss, BIG)
    pr_b = torch.where(has_partner, torch.roll(ss, -1), BIG)
    pr_v = torch.where(has_partner, sv, BIG)
    pr_la = torch.where(has_partner, sl, 0)
    pr_ca = torch.where(has_partner, sc, BIG)
    pr_cb = torch.where(has_partner, torch.roll(sc, -1), BIG)
    pr_mask = has_partner
    paired = has_partner | torch.cat([f1, has_partner[:-1]])
    left_mask = sm & ~paired & (sv < BIG)

    # ------------------------------------------------------------------
    # 3. component labels after pairing (hook + jump CC over comp values)
    # ------------------------------------------------------------------
    universe = torch.cat([torch.where(sm, sc, BIG),
                          torch.where(touch.mask, touch.comp, BIG)])
    uniq, root_val, cc_ok = _cc_hook_jump(
        pr_ca, pr_cb, pr_mask, universe,
        caps.hook_rounds or int(math.ceil(math.log2(
            max(2, universe.shape[0])))) + 2,
    )
    open_comp = _value_lookup(uniq, root_val, torch.where(left_mask, sc, BIG))
    pair_comp = _value_lookup(uniq, root_val, pr_ca)
    touch_comp = _value_lookup(uniq, root_val,
                               torch.where(touch.mask, touch.comp, BIG))

    # ------------------------------------------------------------------
    # 4. unified pair table (this level's pairs + inherited touch pairs)
    # ------------------------------------------------------------------
    q_s1 = torch.cat([pr_a, torch.where(touch.mask, touch.s1, BIG)])
    q_s2 = torch.cat([pr_b, torch.where(touch.mask, touch.s2, BIG)])
    q_v = torch.cat([pr_v, torch.where(touch.mask, touch.vert, BIG)])
    q_la = torch.cat([pr_la, torch.where(touch.mask, touch.la, 0)])
    q_c = torch.cat([pair_comp, touch_comp])
    q_m = torch.cat([pr_mask, touch.mask])
    # at most half the pool can pair: compact before the splice loop
    (q_s1, q_s2, q_v, q_la, q_c), q_m, _ = _compact(
        (q_s1, q_s2, q_v, q_la, q_c), q_m,
        pair_table_cap(P, touch.mask.shape[0]),
    )
    PC = q_s1.shape[0]
    q_c_pre = q_c          # pre-splice comps of the compacted pair table
    iota_pc = torch.arange(PC, dtype=I32, device=dev)
    K = uniq.shape[0]

    oc = torch.sort(open_comp).values  # sorted open comps for path tests

    def is_path(comps, oc_sorted):
        j = _searchsorted_clip(oc_sorted, comps)
        return (oc_sorted[j] == comps) & (comps < BIG)

    # ------------------------------------------------------------------
    # 5. splice rounds
    # ------------------------------------------------------------------
    def splice_round(s2, cmp_, oc_sorted):
        vm = torch.where(q_m, q_v, BIG)
        order2 = lexsort2(vm, cmp_)
        gv, gc = vm[order2], cmp_[order2]
        gs2 = s2[order2]
        gm = q_m[order2]
        dup = torch.cat([f1, (gv[1:] == gv[:-1]) & (gc[1:] == gc[:-1])])
        rep = gm & ~dup & (gv < BIG)
        seg = _seg_starts(gv)
        gpath = is_path(gc, oc_sorted) & rep
        n_rep = segment_sum(rep.to(I32), seg, PC, live=rep)
        cyc = rep & ~gpath
        n_cyc = segment_sum(cyc.to(I32), seg, PC, live=cyc)
        cand = rep & (n_rep[seg] >= 2) & (n_cyc[seg] >= 1)
        # each comp votes for its min candidate vertex
        ci = _searchsorted_clip(uniq, gc)
        vote = segment_min(gv, ci, K, live=cand)
        voted = cand & (vote[ci] == gv)
        # at most one path per vertex: cycles + the min-comp voted path
        pthmin = segment_min(gc, seg, PC, live=voted & gpath)
        take = voted & (~gpath | (gc == pthmin[seg]))
        n_take = segment_sum(take.to(I32), seg, PC, live=take)
        act = take & (n_take[seg] >= 2)
        # rotation among act members, circular within vertex segment
        akey = torch.where(act, gv, BIG)
        o4 = torch.argsort(akey, stable=True)
        hv, hs2, hc = akey[o4], gs2[o4], gc[o4]
        hm = act[o4]
        hstart = _seg_starts(hv)
        hlast = torch.cat([hv[1:] != hv[:-1], t1])
        hnxt = torch.where(hlast, hstart, iota_pc + 1).clamp(0, PC - 1)
        rot_s2 = torch.where(hm, hs2[hnxt], hs2)
        minc = segment_min(hc, hstart, PC, live=hm)
        rot_c = torch.where(hm, minc[hstart], hc)
        changed = hm.any()
        # single unsort: active-space position p ↦ original index order2[o4[p]]
        orig = order2[o4]
        s2_new = torch.zeros_like(s2)
        s2_new[orig] = rot_s2
        did = torch.zeros_like(q_m)
        did[orig] = hm
        s2_new = torch.where(did, s2_new, s2)
        # comp relabel map (from → min comp at its rotation vertex)
        mfrom = torch.where(hm, hc, BIG)
        mto = torch.where(hm, rot_c, BIG)
        mo = torch.argsort(mfrom, stable=True)
        mfrom, mto = mfrom[mo], mto[mo]

        def relabel(vals):
            j = _searchsorted_clip(mfrom, vals)
            return torch.where(mfrom[j] == vals, mto[j], vals)

        return s2_new, relabel(cmp_), torch.sort(relabel(oc_sorted)).values, \
            changed

    changed = torch.ones((), dtype=torch.bool, device=dev)
    if caps.static_splice:
        for _ in range(caps.splice_rounds):
            q_s2, q_c, oc, changed = splice_round(q_s2, q_c, oc)
        splice_ok = torch.ones((), dtype=torch.bool, device=dev)
    else:
        left = caps.splice_rounds
        while left > 0 and bool(changed):          # one host read per round
            q_s2, q_c, oc, changed = splice_round(q_s2, q_c, oc)
            left -= 1
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
        torch.cat([universe, torch.where(q_m, q_c, BIG)]),
        caps.hook_rounds or int(math.ceil(math.log2(
            max(2, 2 * universe.shape[0])))) + 2,
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
    dv, dc = tv[ot], tc[ot]
    dup2 = torch.cat([f1, (dv[1:] == dv[:-1]) & (dc[1:] == dc[:-1])])
    tm = keep[ot] & ~dup2
    (t_s1, t_s2, t_v, t_la, t_c), t_m, touch_of = _compact(
        (q_s1[ot], q_s2[ot], q_v[ot], q_la[ot], q_c[ot]), tm, caps.touch_cap
    )
    new_touch = TouchTable(t_s1, t_s2, t_v, t_la, t_c, t_m)

    live = torch.sort(torch.cat(
        [torch.where(o_mask, o_comp, BIG), torch.where(t_m, t_c, BIG)]
    )).values
    n_comp = ((live < BIG) & torch.cat([t1, live[1:] != live[:-1]])).sum()

    flags = torch.stack([cc_ok & cc3_ok, splice_ok, ~(open_of | touch_of)])
    return Phase1Out(
        opens=new_opens,
        touch=new_touch,
        log_s1=torch.where(q_m, q_s1, BIG),
        log_s2=torch.where(q_m, q_s2, BIG),
        log_mask=q_m,
        n_components=n_comp.to(I32),
        flags=flags,
    )
