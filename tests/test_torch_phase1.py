"""Phase 1 of the port against the JAX superstep, field by field.

One subprocess (8 simulated devices) runs the JAX package's eager
per-level superstep (``DistributedEngine.make_superstep``) on an
8-partition solve with ``phase1_local`` wrapped so that every call hands
its inputs and its ``Phase1Out`` to the host (``jax.debug.callback``).
The port's ``phase1_local`` then runs on each recorded input, and every
output field must be byte-identical.
"""
import numpy as np
import pytest
import torch

from conftest import run_with_devices
from repro_torch.core.phase1 import (NewEdges, OpenTable, Phase1Caps,
                                     TouchTable, phase1_local)

SCALE, SEED, PARTS = 6, 2, 8
N_LEVELS = 4                      # the bucket's (ladder-rounded) supersteps

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
                                     parts=PARTS), n=PARTS)
    with np.load(out) as z:
        return dict(z)


def _table(rec, key, prefix, cls):
    return cls(*(torch.from_numpy(rec[f"{key}/{prefix}.{f}"])
                 for f in cls._fields))


def test_capture_covers_every_level(captured):
    assert int(captured["supersteps"]) == N_LEVELS
    keys = {k.split("/")[0] for k in captured if "/" in k}
    assert keys == {f"{lvl}_{p}" for lvl in range(N_LEVELS)
                    for p in range(PARTS)}


@pytest.mark.parametrize("level", range(N_LEVELS))
def test_phase1_out_byte_identical(captured, level):
    caps = Phase1Caps(**{k: int(captured["caps." + k]) for k in
                         ("open_cap", "touch_cap", "hook_rounds",
                          "splice_rounds")})
    live = 0
    for p in range(PARTS):
        key = f"{level}_{p}"
        out = phase1_local(_table(captured, key, "new", NewEdges),
                           _table(captured, key, "open", OpenTable),
                           _table(captured, key, "touch", TouchTable),
                           level, caps)
        for prefix, tbl in (("out_open", out.opens),
                            ("out_touch", out.touch)):
            for f in tbl._fields:
                np.testing.assert_array_equal(
                    getattr(tbl, f).numpy(), captured[f"{key}/{prefix}.{f}"],
                    err_msg=f"level {level} part {p} {prefix}.{f}")
        for f in ("log_s1", "log_s2", "log_mask", "n_components", "flags"):
            np.testing.assert_array_equal(
                getattr(out, f).numpy(), captured[f"{key}/out.{f}"],
                err_msg=f"level {level} part {p} out.{f}")
        live += int(captured[f"{key}/new.mask"].sum()
                    + captured[f"{key}/open.mask"].sum()
                    + captured[f"{key}/touch.mask"].sum())
    if level < N_LEVELS - 1:
        assert live > 0, "a real level must feed Phase 1 something"
