"""Phase 1 of the port against the JAX superstep, field by field.

One subprocess (8 simulated devices) runs the JAX package's eager
per-level superstep (``DistributedEngine.make_superstep``) on an
8-partition solve with ``phase1_local`` wrapped so that every call hands
its inputs and its ``Phase1Out`` to the host (``jax.debug.callback``).
The port's ``phase1_local`` then runs on each recorded input, one
partition at a time (``n = 1``) and all 8 partitions of a level in one
batched call, and every output field of every row must be
byte-identical.  The batched call runs three ways: the eager splice loop
(stops when no row changes), ``static_splice`` (every round, flag forced
true) and the capture rule, under which the loop is a CUDA while node
(on the CPU its stand-in, which must run the eager loop's rounds).
"""
import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from conftest import run_with_devices
from repro_torch.core import capture
from repro_torch.core.phase1 import (NewEdges, OpenTable, Phase1Caps,
                                     TouchTable, phase1_local)

SCALE, SEED, PARTS = 6, 2, 8
N_LEVELS = 4                      # the bucket's (ladder-rounded) supersteps
#: the time limit of the live JAX reference run in this file, about five
#: times the 55 s it took in the suite's parallel run on an 8-core CPU:
#: a stalled subprocess fails the tests that read it instead of holding
#: its worker for run_with_devices' default 900 s
LIVE_TIMEOUT = 300

_CAPTURE = '''
import dataclasses
import numpy as np
import jax
import repro.core.engine as E
from repro.euler import EulerSolver
from repro.graphgen.eulerize import eulerian_rmat

out_path = {out!r}
rec = {{}}
caps_seen = []
orig = E.phase1_local

def record(lvl, me, new, opens, touch, out):
    key = f"{{int(lvl)}}_{{int(me)}}"
    for prefix, tbl in (("new", new), ("open", opens), ("touch", touch),
                        ("out_open", out.opens), ("out_touch", out.touch)):
        for f in tbl._fields:
            rec[f"{{key}}/{{prefix}}.{{f}}"] = np.asarray(getattr(tbl, f))
    for f in ("log_s1", "log_s2", "log_mask", "n_components", "flags"):
        rec[f"{{key}}/out.{{f}}"] = np.asarray(getattr(out, f))

def patched(new, opens, touch, level, caps):
    out = orig(new, opens, touch, level, caps)
    caps_seen.append(dataclasses.asdict(caps))
    jax.debug.callback(record, level, jax.lax.axis_index("part"),
                       new, opens, touch, out)
    return out

E.phase1_local = patched
g = eulerian_rmat({scale}, avg_degree=4, seed={seed})
res = EulerSolver(n_parts={parts}, fused=False,
                  sharded_phase3=False).solve(g).validate()
jax.effects_barrier()
caps = caps_seen[0]
for k in ("open_cap", "touch_cap", "hook_rounds", "splice_rounds"):
    rec["caps." + k] = np.asarray(caps[k])
rec["supersteps"] = np.asarray(res.supersteps)
np.savez(out_path, **rec)
print("records", len(rec))
'''


@pytest.fixture(scope="module")
def captured(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("phase1") / "phase1.npz")
    run_with_devices(_CAPTURE.format(out=out, scale=SCALE, seed=SEED,
                                     parts=PARTS), n=PARTS,
                     timeout=LIVE_TIMEOUT)
    with np.load(out) as z:
        return dict(z)


def _table(rec, key, prefix, cls):
    """One partition's recorded table as ``[1, ·]`` rows."""
    return cls(*(torch.from_numpy(rec[f"{key}/{prefix}.{f}"])[None]
                 for f in cls._fields))


def _batched(rec, level, prefix, cls):
    """All partitions' recorded tables of ``level`` as ``[PARTS, ·]``."""
    return cls(*(torch.from_numpy(np.stack(
        [rec[f"{level}_{p}/{prefix}.{f}"] for p in range(PARTS)]))
        for f in cls._fields))


def _caps(rec) -> Phase1Caps:
    return Phase1Caps(**{k: int(rec["caps." + k]) for k in
                         ("open_cap", "touch_cap", "hook_rounds",
                          "splice_rounds")})


def _assert_row(rec, out, row: int, key: str, what: str) -> None:
    """Row ``row`` of a port ``Phase1Out`` equals the record ``key``."""
    for prefix, tbl in (("out_open", out.opens), ("out_touch", out.touch)):
        for f in tbl._fields:
            np.testing.assert_array_equal(
                getattr(tbl, f)[row].numpy(), rec[f"{key}/{prefix}.{f}"],
                err_msg=f"{what} {prefix}.{f}")
    for f in ("log_s1", "log_s2", "log_mask", "n_components", "flags"):
        np.testing.assert_array_equal(
            getattr(out, f)[row].numpy(), rec[f"{key}/out.{f}"],
            err_msg=f"{what} out.{f}")


def test_capture_covers_every_level(captured):
    assert int(captured["supersteps"]) == N_LEVELS
    keys = {k.split("/")[0] for k in captured if "/" in k}
    assert keys == {f"{lvl}_{p}" for lvl in range(N_LEVELS)
                    for p in range(PARTS)}


@pytest.mark.parametrize("level", range(N_LEVELS))
def test_phase1_out_byte_identical(captured, level):
    """One partition a call (``n = 1``), each against its record."""
    caps = _caps(captured)
    live = 0
    for p in range(PARTS):
        key = f"{level}_{p}"
        out = phase1_local(_table(captured, key, "new", NewEdges),
                           _table(captured, key, "open", OpenTable),
                           _table(captured, key, "touch", TouchTable),
                           level, caps)
        _assert_row(captured, out, 0, key, f"level {level} part {p}")
        live += int(captured[f"{key}/new.mask"].sum()
                    + captured[f"{key}/open.mask"].sum()
                    + captured[f"{key}/touch.mask"].sum())
    if level < N_LEVELS - 1:
        assert live > 0, "a real level must feed Phase 1 something"


# the capture rule's id names what a capture ran before it held a while
# node: the whole round budget
@pytest.mark.parametrize("mode", ["eager", "static_splice",
                                  pytest.param("while_node", id="full_budget")])
@pytest.mark.parametrize("level", range(N_LEVELS))
def test_phase1_batched_rows_byte_identical(captured, level, mode):
    """All 8 partitions of a level in one call: row p is partition p's
    record.  ``static_splice`` runs every splice round and reports the
    splice converged; ``while_node`` takes the capture rule, the while
    node's stand-in, which must run the eager loop's rounds.  All must
    leave each row as the reference's early-stopping loop did."""
    caps = _caps(captured)
    if mode == "static_splice":
        caps = dataclasses.replace(caps, static_splice=True)
    args = (_batched(captured, level, "new", NewEdges),
            _batched(captured, level, "open", OpenTable),
            _batched(captured, level, "touch", TouchTable), level, caps)
    if mode == "while_node":
        rounds = []
        for rule in (False, True):
            loops = capture.Loops(torch.device("cpu"))
            with capture.counting(loops), mock.patch.object(
                    capture, "capturing", lambda device: rule):
                out = phase1_local(*args)
            rounds.append(loops.rounds_run())
        assert rounds[0] == rounds[1] and len(rounds[0]) == 1
    else:
        out = phase1_local(*args)
    assert out.flags.shape == (PARTS, 3)
    for p in range(PARTS):
        key = f"{level}_{p}"
        assert captured[f"{key}/out.flags"].all()   # every loop converged
        _assert_row(captured, out, p, key, f"{mode} level {level} part {p}")
