"""The LM family over a ``DeviceMesh`` (``launch/steps.py::build_lm_cell``
with a mesh, ``models/transformer.py``'s mesh path, ``parallel/
sharding.py``'s placements, ``checkpoint/{ckpt,elastic}.py``, the
trainer's mesh and the dry run's LM rows) against the JAX package.

* The golden (``tests/golden/torch_lm_mesh_reference.npz``, rewritten by
  ``PYTHONPATH=src python tests/test_torch_lm_mesh.py``) is the
  reference's own sharded step, ``tests/test_distributed.py``'s
  ``test_lm_train_step_shards_on_4_devices``: reduced SmolLM on
  ``make_test_mesh(4, tp=2)`` over 4 forced CPU devices, batch 4, seq 64,
  tokens and labels from ``np.random.default_rng(0)``, params
  ``init_lm_params(PRNGKey(0))``; that step's loss (its learning rate is
  0 at AdamW step 0), then one more from step 1,000 (its loss, params
  and moments); a prefill of the first 16 tokens and 4 decode steps in a
  cache widened to 20; and each device's index slices of every parameter
  under ``lm_param_shardings`` on every mesh shape below and on a
  ``("pod", "data", "model")`` mesh (2, 2, 1).  The same for reduced
  StarCoder2 (keys under ``sc2/``), whose 2 KV heads split over tp 2
  where reduced SmolLM's single one cannot, with its slices on (1, 2)
  and (2, 2).  One test re-runs the reference live and holds the file
  to it.
* The port's ranks run in gloo worlds of 1 ((1, 1)), 2 ((1, 2), (2, 1))
  and 4 ((2, 2), (4, 1)), reduced StarCoder2 on (1, 2) and (2, 2),
  this file run as a script per rank, all
  spawned once for the module, each with its own time limit.  The
  initial params are the reference's (computed here with JAX, handed
  over as numpy).  Every result must be allclose to the golden and to
  the port's meshless cells at f32 atol 1e-5, rtol 2e-5, and each
  rank's local shards must be the reference's device slices.
* Planted faults on world 2's (1, 2) mesh: the vocab-parallel lookup
  without its sum over ``model`` changes the loss; head-split
  attention's input gradients taken as replicated over ``model``
  change StarCoder2's moments and params.
* Elastic restore: world 4 saves its (2, 2) state after the first step;
  it restores onto (4, 1), and world 2 onto (1, 2); every restored array
  is byte-equal to the saved one, and the step that follows is allclose
  to the uninterrupted one.
* The trainer on gloo world 4 (``torch.distributed.run``, tp 2) with an
  injected failure against world 1; the dry run's LM rows on a ``fake``
  world of 8; MoE and the other families' refusals.
"""
import argparse
import dataclasses
import datetime
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.checkpoint.elastic import elastic_restore
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import dryrun, mesh as mesh_mod, steps
from repro_torch.models import transformer as tr
from repro_torch.optim.adamw import init_adamw
from repro_torch.parallel import sharding as shd
from repro_torch.tree import leaves_with_paths, tree_map

SRC = str(Path(__file__).resolve().parents[1] / "src")
GOLDEN = Path(__file__).resolve().parent / "golden" / \
    "torch_lm_mesh_reference.npz"
#: world → its mesh shapes (data, model)
MESHES = {1: ((1, 1),), 2: ((1, 2), (2, 1)), 4: ((2, 2), (4, 1))}
CASES = [(w, m) for w, ms in MESHES.items() for m in ms]
#: reduced StarCoder2's 2 KV heads split over tp 2 (``MeshPlan.heads``):
#: its meshes, key prefix "sc2/" (reduced SmolLM's 1 KV head does not
#: split, so its tp 2 meshes take the all-heads rule)
SPLIT_CASES = [(4, (2, 2)), (2, (1, 2))]
#: key prefix → arch, and the meshes each arch runs on
ARCH_OF = {"": "smollm-360m", "sc2/": "starcoder2-7b"}
CASES_OF = {"": [m for _, m in CASES], "sc2/": [m for _, m in SPLIT_CASES]}
#: the multi-axis mesh whose slices the golden also holds
POD = (2, 2, 1)
BATCH, SEQ, PROMPT, WIDE, GEN = 4, 64, 16, 20, 4
#: the warm AdamW step of the second train step
WARM_STEP = 1000
ATOL, RTOL = 1e-5, 2e-5
#: each spawned process's time limit and the gloo groups' timeout
LIVE_TIMEOUT = 300
GROUP_TIMEOUT = 60
#: the trainer's run: steps, checkpoint period, injected failure
TRAIN_ARGS = ["--reduced", "--device", "cpu", "--steps", "12", "--batch",
              "4", "--seq", "64", "--ckpt-every", "4", "--fail-at", "6",
              "--log-every", "1"]


def mesh_name(shape) -> str:
    return "x".join(map(str, shape))


def arch(pre: str = ""):
    a = registry.get_config(ARCH_OF[pre], reduced=True)
    return dataclasses.replace(a, shapes={
        "train": ShapeCell("train", "train", batch=BATCH, seq_len=SEQ),
        "prefill": ShapeCell("prefill", "prefill", batch=BATCH,
                             seq_len=PROMPT),
        "decode": ShapeCell("decode", "decode", batch=BATCH,
                            seq_len=WIDE)})


# ----------------------------------------------------------------------
# the reference (JAX, 4 forced CPU devices)
# ----------------------------------------------------------------------
REFERENCE = """
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs.base import ShapeCell
from repro.configs.registry import get_config
from repro.launch.mesh import make_test_mesh
from repro.launch.steps import build_cell
from repro.models.transformer import (abstract_lm_params, init_kv_cache,
                                      init_lm_params)
from repro.optim.adamw import init_adamw
from repro.parallel import sharding as shd

B, S, PROMPT, WIDE, GEN, WARM = {B}, {S}, {PROMPT}, {WIDE}, {GEN}, {WARM}
#: key prefix → (arch, the meshes whose device slices are kept)
ARCHS = {ARCHS}


def key(path):
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def flat(prefix, tree, out):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + key(path)] = np.asarray(leaf, np.float32)


def arch_of(arch_id):
    arch = get_config(arch_id, reduced=True)
    return dataclasses.replace(arch, shapes={{
        "train": ShapeCell("train", "train", batch=B, seq_len=S),
        "prefill": ShapeCell("prefill", "prefill", batch=B, seq_len=PROMPT),
        "decode": ShapeCell("decode", "decode", batch=B, seq_len=WIDE)}})


def cells(arch, params, pre, out):
    cfg = arch.model
    opt = init_adamw(params)
    cell = build_cell(arch, "train", mesh)
    f = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                out_shardings=cell.out_shardings)
    p = jax.device_put(params, cell.in_shardings[0])
    o = jax.device_put(opt, cell.in_shardings[1])
    batch = jax.device_put({{"tokens": tokens, "labels": labels}},
                           cell.in_shardings[2])
    p1, o1, loss = f(p, o, batch)
    out[pre + "A/loss"] = np.float32(loss)
    # the learning rate at step 0 is 0: the params come back as they were
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(p1)[0],
                            jax.tree_util.tree_leaves(params)):
        assert np.array_equal(np.asarray(a), np.asarray(b)), key(path)
    o1 = jax.device_put(o1._replace(step=jnp.int32(WARM)),
                        cell.in_shardings[1])
    p2, o2, loss = f(p1, o1, batch)
    out[pre + "B/loss"] = np.float32(loss)
    flat(pre + "B/params/", p2, out)
    flat(pre + "B/m/", o2.m, out)
    flat(pre + "B/v/", o2.v, out)
    pc = build_cell(arch, "prefill", mesh)
    fp = jax.jit(pc.fn, in_shardings=pc.in_shardings,
                 out_shardings=pc.out_shardings)
    logits, cache = fp(p, tokens[:, :PROMPT])
    out[pre + "prefill/logits"] = np.asarray(logits)
    out[pre + "prefill/k"] = np.asarray(cache.k)
    out[pre + "prefill/v"] = np.asarray(cache.v)
    wide = init_kv_cache(cfg, B, WIDE, fill=PROMPT)
    wide = wide._replace(k=wide.k.at[:, :, :PROMPT].set(cache.k),
                         v=wide.v.at[:, :, :PROMPT].set(cache.v))
    dc = build_cell(arch, "decode", mesh)
    fd = jax.jit(dc.fn, in_shardings=dc.in_shardings,
                 out_shardings=dc.out_shardings)
    wide = jax.device_put(wide, dc.in_shardings[1])
    for s in range(GEN):
        logits, wide = fd(p, wide, tokens[:, PROMPT + s])
        out[pre + f"decode/{{s}}/logits"] = np.asarray(logits)
    out[pre + "decode/k"] = np.asarray(wide.k)
    out[pre + "decode/v"] = np.asarray(wide.v)
    out[pre + "decode/length"] = np.asarray(wide.length)


def slices(cfg, pre, shapes, out):
    abstract = abstract_lm_params(cfg)
    devs = np.array(jax.devices())
    for shape in shapes:
        names = ("pod", "data", "model")[-len(shape):]
        m = Mesh(devs[:int(np.prod(shape))].reshape(shape), names)
        name = "x".join(map(str, shape))
        shards = shd.lm_param_shardings(abstract, m)
        for (path, s), leaf in zip(
                jax.tree_util.tree_flatten_with_path(
                    shards,
                    is_leaf=lambda x: hasattr(x, "devices_indices_map"))[0],
                jax.tree_util.tree_leaves(abstract)):
            idx = s.devices_indices_map(leaf.shape)
            out[pre + f"slices/{{name}}/{{key(path)}}"] = np.array(
                [[[sl.start or 0,
                   leaf.shape[d] if sl.stop is None else sl.stop]
                  for d, sl in enumerate(idx[dev])]
                 for dev in m.devices.flat], np.int64)


rng = np.random.default_rng(0)
tokens = jnp.asarray(rng.integers(0, 512, (B, S)), jnp.int32)
labels = jnp.asarray(rng.integers(0, 512, (B, S)), jnp.int32)
out = {{}}
if sys.argv[1] == "inputs":
    for pre, (arch_id, _) in ARCHS.items():
        params = init_lm_params(jax.random.PRNGKey(0),
                                arch_of(arch_id).model)
        flat(pre + "params0/", params, out)
    out["tokens"], out["labels"] = np.asarray(tokens), np.asarray(labels)
    np.savez(sys.argv[2], **out)
    sys.exit(0)
mesh = make_test_mesh(4, tp=2)
for pre, (arch_id, shapes) in ARCHS.items():
    arch = arch_of(arch_id)
    with mesh:
        cells(arch, init_lm_params(jax.random.PRNGKey(0), arch.model), pre,
              out)
    slices(arch.model, pre, shapes, out)
np.savez_compressed(sys.argv[2], **out)
"""


def _env(devices=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    if devices:
        env["XLA_FLAGS"] = \
            f"--xla_force_host_platform_device_count={devices}"
    return env


def reference(what: str, path) -> subprocess.Popen:
    code = textwrap.dedent(REFERENCE.format(
        B=BATCH, S=SEQ, PROMPT=PROMPT, WIDE=WIDE, GEN=GEN, WARM=WARM_STEP,
        ARCHS=repr({pre: (arch_id, list(CASES_OF[pre]) + (
            [POD] if pre == "" else []))
            for pre, arch_id in ARCH_OF.items()})))
    return subprocess.Popen(
        [sys.executable, "-c", code, what, str(path)],
        env=_env(4 if what == "golden" else None), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


# ----------------------------------------------------------------------
# the port's side
# ----------------------------------------------------------------------
def ref_tree(data, prefix):
    """The reference's param tree (layers stacked) under ``prefix`` of an
    npz file."""
    out = {"layers": {}}
    for k in data.files:
        if k.startswith(prefix):
            name = k[len(prefix):]
            if name.startswith("layers/"):
                out["layers"][name[len("layers/"):]] = data[k]
            else:
                out[name] = data[k]
    return out


def flat_ref(tree, prefix=""):
    """{reference key: array} of a reference-layout numpy tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_ref(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.array(v)       # a copy: the state moves on
    return out


def whole(tree):
    """The reference-layout numpy arrays of a port tree of (D)Tensors."""
    full = tree_map(lambda t: t.full_tensor() if hasattr(t, "full_tensor")
                    else t, tree)
    return flat_ref(tr.params_to_numpy(full))


def ref_key(port_path: str):
    """A port param path → (reference key, layer index or None)."""
    parts = port_path.split("/")
    if parts[0] == "layers":
        return f"layers/{parts[2]}", int(parts[1])
    return port_path, None


def local_shards(params):
    """{port path: this rank's local shard} of a DTensor tree."""
    return {p: t.to_local().numpy().copy()
            for p, t in leaves_with_paths(params)}


def batch_on(tokens, labels, cell):
    return shd.distribute({"tokens": torch.from_numpy(tokens),
                           "labels": torch.from_numpy(labels)},
                          cell.in_shardings[2])


def run_mesh(a, mesh, inputs, rec, tag, lead: bool, after_a=None,
             pre: str = ""):
    """Train A and B, prefill and decode over ``mesh`` from the params
    under ``pre``; into ``rec``; ``after_a(params, opt)`` between A and
    B."""
    cfg = a.model
    tokens, labels = inputs["tokens"], inputs["labels"]
    p0 = ref_tree(inputs, pre + "params0/")
    port0 = tr.params_from_numpy(p0)
    params, opt = steps.place_lm_state(mesh, port0, init_adamw(port0))
    for p, x in local_shards(params).items():
        rec[f"{tag}/local0/{p}"] = x
    train = steps.build_cell(a, "train", mesh)
    batch = batch_on(tokens, labels, train)
    params, opt, loss = train.fn(params, opt, batch)
    rec[f"{tag}/A/loss"] = np.float32(loss.full_tensor())
    stateA = whole(params), whole(opt.m), whole(opt.v)
    if after_a is not None:
        after_a(params, opt)
    opt = opt._replace(step=shd.distribute(
        torch.tensor(WARM_STEP, dtype=torch.int32),
        shd.NamedSharding(mesh, shd.P())))
    params, opt, loss = train.fn(params, opt, batch)
    rec[f"{tag}/B/loss"] = np.float32(loss.full_tensor())
    for name, tree in (("params", params), ("m", opt.m), ("v", opt.v)):
        for k, x in whole(tree).items():
            if lead:
                rec[f"{tag}/B/{name}/{k}"] = x
    for p, x in local_shards(params).items():
        rec[f"{tag}/localB/{p}"] = x
    if lead:
        for name, t in zip(("params", "m", "v"), stateA):
            for k, x in t.items():
                rec[f"{tag}/A/{name}/{k}"] = x
    # prefill, then decode in a cache widened to WIDE
    pre = steps.build_cell(a, "prefill", mesh)
    params0 = steps.place_lm_state(mesh, port0)
    toks = shd.distribute(torch.from_numpy(tokens[:, :PROMPT]),
                          pre.in_shardings[1])
    with torch.no_grad():
        logits, cache = pre.fn(params0, toks)
    k, v = cache.k.full_tensor(), cache.v.full_tensor()
    full = logits.full_tensor().numpy()
    if lead:
        rec[f"{tag}/prefill/logits"] = full
        rec[f"{tag}/prefill/k"], rec[f"{tag}/prefill/v"] = \
            k.numpy(), v.numpy()
    dec = steps.build_cell(a, "decode", mesh)
    wide = tr.init_kv_cache(cfg, BATCH, WIDE, fill=PROMPT)
    wide.k[:, :, :PROMPT] = k
    wide.v[:, :, :PROMPT] = v
    wide = shd.distribute(wide, dec.in_shardings[1])
    with torch.no_grad():
        for s in range(GEN):
            t = shd.distribute(torch.from_numpy(tokens[:, PROMPT + s]),
                               dec.in_shardings[2])
            logits, wide = dec.fn(params0, wide, t)
            full = logits.full_tensor().numpy()
            if lead:
                rec[f"{tag}/decode/{s}/logits"] = full
    kf, vf, ln = (x.full_tensor().numpy() for x in wide)
    if lead:
        rec[f"{tag}/decode/k"], rec[f"{tag}/decode/v"] = kf, vf
        rec[f"{tag}/decode/length"] = ln


def save_state(directory, state):
    CheckpointManager(directory).save(1, state, blocking=True)


def wait_for_checkpoint(directory, timeout):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if os.path.isdir(directory) and \
                CheckpointManager(directory).latest_step() is not None:
            return CheckpointManager(directory)
        time.sleep(0.2)
    raise TimeoutError(f"no checkpoint in {directory}")


def restore_and_step(a, ckpt, like, mesh, inputs, rec, tag, lead):
    """Restore ``like`` onto ``mesh`` (elastic), record the restored
    arrays and local shards, then the warm step from them."""
    (params, opt), step = elastic_restore(ckpt, like, mesh,
                                          steps.lm_state_shardings)
    assert step == 1
    for name, tree in (("params", params), ("m", opt.m), ("v", opt.v)):
        for k, x in whole(tree).items():
            if lead:
                rec[f"{tag}/restored/{name}/{k}"] = x
    for p, x in local_shards(params).items():
        rec[f"{tag}/restored_local/{p}"] = x
    train = steps.build_cell(a, "train", mesh)
    opt = opt._replace(step=shd.distribute(
        torch.tensor(WARM_STEP, dtype=torch.int32),
        shd.NamedSharding(mesh, shd.P())))
    params, opt, loss = train.fn(params, opt, batch_on(
        inputs["tokens"], inputs["labels"], train))
    rec[f"{tag}/resumed/loss"] = np.float32(loss.full_tensor())
    for k, x in whole(params).items():
        if lead:
            rec[f"{tag}/resumed/params/{k}"] = x


def rank_main(rank, world, store, inputs_path, out, ckpt_dir):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
    from torch.distributed.device_mesh import DeviceMesh

    a = arch()
    inputs = np.load(inputs_path)
    rec = {}
    lead = rank == 0
    meshes = {}
    for shape in MESHES[world]:
        mesh = DeviceMesh("cpu", torch.arange(world).view(shape),
                          mesh_dim_names=("data", "model"))
        meshes[shape] = mesh
        run_mesh(a, mesh, inputs, rec, mesh_name(shape), lead,
                 (lambda p, o: save_state(ckpt_dir, (p, o)))
                 if shape == (2, 2) else None)
    for w, shape in SPLIT_CASES:
        if w == world:
            run_mesh(arch("sc2/"), meshes[shape], inputs, rec,
                     "sc2/" + mesh_name(shape), lead, pre="sc2/")
    if world == 4:
        # elastic: the (2, 2) checkpoint onto (4, 1); the pod mesh's shards
        port0 = tr.params_from_numpy(ref_tree(inputs, "params0/"))
        restore_and_step(a, CheckpointManager(ckpt_dir),
                         (port0, init_adamw(port0)), meshes[(4, 1)], inputs,
                         rec, "elastic4x1", lead)
        pod = DeviceMesh("cpu", torch.arange(4).view(POD),
                         mesh_dim_names=("pod", "data", "model"))
        placed = steps.place_lm_state(
            pod, tr.params_from_numpy(ref_tree(inputs, "params0/")))
        for p, x in local_shards(placed).items():
            rec[f"pod/local0/{p}"] = x
    if world == 2:
        mesh = meshes[(1, 2)]
        # the planted fault: the lookup's terms never summed over model
        real = tr._lookup_out
        tr._lookup_out = lambda plan, pl: pl
        try:
            port0 = tr.params_from_numpy(ref_tree(inputs, "params0/"))
            params, opt = steps.place_lm_state(mesh, port0, init_adamw(port0))
            train = steps.build_cell(a, "train", mesh)
            _, _, loss = train.fn(params, opt, batch_on(
                inputs["tokens"], inputs["labels"], train))
            rec["fault/loss"] = np.float32(loss.full_tensor())
        finally:
            tr._lookup_out = real
        # the planted fault: head-split attention's input gradients taken
        # as replicated over model, where each model rank holds a term
        real_block, flipped = tr.MeshPlan.block, []

        def faulty(self, fn, out, ins, split_tp):
            if getattr(fn, "func", None) is tr._attend_block and split_tp:
                flipped.append(1)
                split_tp = False
            return real_block(self, fn, out, ins, split_tp)

        tr.MeshPlan.block = faulty
        try:
            run_mesh(arch("sc2/"), mesh, inputs, rec, "fault_heads", lead,
                     pre="sc2/")
        finally:
            tr.MeshPlan.block = real_block
        rec["fault_heads/flipped"] = np.int64(len(flipped))
        # elastic: world 4's (2, 2) checkpoint onto a world of 2
        ckpt = wait_for_checkpoint(ckpt_dir, LIVE_TIMEOUT - 30)
        port0 = tr.params_from_numpy(ref_tree(inputs, "params0/"))
        like = (port0, init_adamw(port0))
        restore_and_step(a, ckpt, like, mesh, inputs, rec, "elastic1x2",
                         lead)
    np.savez(out, **rec)
    os._exit(0)       # no group teardown: a peer may still be waiting


# ----------------------------------------------------------------------
# the fixture: everything spawned at once
# ----------------------------------------------------------------------
@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_mesh")
    inputs = tmp / "inputs.npz"
    p = reference("inputs", inputs)
    log, _ = p.communicate(timeout=LIVE_TIMEOUT)
    assert p.returncode == 0, log[-4000:]
    procs = {"live": [reference("golden", tmp / "live.npz")]}
    ckpt = tmp / "ckpt"
    for world in MESHES:
        procs[world] = [subprocess.Popen(
            [sys.executable, __file__, "--rank", str(r), "--world",
             str(world), "--store", str(tmp / f"store{world}"), "--inputs",
             str(inputs), "--out", str(tmp / f"port{world}_{r}.npz"),
             "--ckpt", str(ckpt)], env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
    procs["trainer"] = [subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         "--tp", "2", "--ckpt-dir", str(tmp / "train4"), "--json",
         str(tmp / "train4.json")] + TRAIN_ARGS,
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)]
    done = {"inputs": []}

    def get(name):
        if name not in done:
            logs = []
            for q in procs[name]:
                try:
                    log, _ = q.communicate(timeout=LIVE_TIMEOUT)
                except subprocess.TimeoutExpired:
                    for x in procs[name]:
                        x.kill()
                    pytest.fail(f"{name} did not finish in {LIVE_TIMEOUT} s")
                assert q.returncode == 0, f"{name}: {log[-4000:]}"
                logs.append(log)
            done[name] = logs
        return tmp, done[name]

    yield get
    for group in procs.values():
        for q in group:
            if q.poll() is None:
                q.kill()


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def meshless_of(inputs, pre: str):
    """The port's meshless cells from the reference's initial params
    under ``pre``, under the golden's keys."""
    a = arch(pre)
    cfg = a.model
    tokens, labels = (torch.from_numpy(inputs[k]) for k in ("tokens",
                                                            "labels"))
    port0 = tr.params_from_numpy(ref_tree(inputs, pre + "params0/"))
    params = tree_map(torch.clone, port0)
    opt = init_adamw(params)
    cell = steps.build_cell(a, "train")
    batch = {"tokens": tokens, "labels": labels}
    rec = {}
    params, opt, loss = cell.fn(params, opt, batch)
    rec["A/loss"] = np.float32(loss)
    for name, tree in (("params", params), ("m", opt.m), ("v", opt.v)):
        for k, x in whole(tree).items():
            rec[f"A/{name}/{k}"] = x
    opt = opt._replace(step=torch.tensor(WARM_STEP, dtype=torch.int32))
    params, opt, loss = cell.fn(params, opt, batch)
    rec["B/loss"] = np.float32(loss)
    for name, tree in (("params", params), ("m", opt.m), ("v", opt.v)):
        for k, x in whole(tree).items():
            rec[f"B/{name}/{k}"] = x
    with torch.no_grad():
        logits, cache = tr.prefill_step(port0, cfg, tokens[:, :PROMPT])
        rec["prefill/logits"] = logits.numpy()
        rec["prefill/k"], rec["prefill/v"] = cache.k.numpy(), cache.v.numpy()
        wide = tr.init_kv_cache(cfg, BATCH, WIDE, fill=PROMPT)
        wide.k[:, :, :PROMPT] = cache.k
        wide.v[:, :, :PROMPT] = cache.v
        for s in range(GEN):
            logits, wide = tr.decode_step(port0, cfg, wide,
                                          tokens[:, PROMPT + s])
            rec[f"decode/{s}/logits"] = logits.numpy()
    rec["decode/k"], rec["decode/v"] = wide.k.numpy(), wide.v.numpy()
    rec["decode/length"] = wide.length.numpy()
    return {pre + k: x for k, x in rec.items()}


@pytest.fixture(scope="module")
def meshless(spawned):
    """The port's meshless cells of both archs, under the golden's
    keys."""
    tmp, _ = spawned("inputs")
    inputs = np.load(tmp / "inputs.npz")
    return {k: x for pre in ARCH_OF for k, x in
            meshless_of(inputs, pre).items()}


def close(got, want, what):
    """allclose at ``ATOL`` and ``RTOL``.  AdamW's second moments (``what``
    names a ``/v/`` key) are about 1e-8, far under ``ATOL``: their
    absolute tolerance is ``ATOL`` times their largest value."""
    atol = ATOL * float(np.abs(want).max()) if "/v/" in what else ATOL
    np.testing.assert_allclose(got, want, atol=atol, rtol=RTOL,
                               err_msg=what)


def differs(got, want, what) -> bool:
    """``close`` fails."""
    try:
        close(got, want, what)
    except AssertionError:
        return True
    return False


def port_rank(spawned, world, rank=0):
    tmp, _ = spawned(world)
    return np.load(tmp / f"port{world}_{rank}.npz")


def golden_keys(golden, prefix):
    return [k for k in golden.files if k.startswith(prefix)]


def the_slice(golden, mesh: str, port_path: str, index: int,
              pre: str = ""):
    """The reference's slice of a port param on device ``index`` of a
    mesh (row-major), and the whole array's key."""
    key, layer = ref_key(port_path)
    sl = golden[f"{pre}slices/{mesh}/{key}"][index]
    if layer is not None:
        sl = sl[1:]
    return key, layer, tuple(slice(a, b) for a, b in sl)


def check_train(got, golden, meshless, pre: str, tag: str):
    """Both train steps of a rank's records under ``tag`` against the
    golden's and the meshless cells' under ``pre``: the losses, the
    second step's params and moments, the first's against meshless."""
    def mine(k):
        return got[f"{tag}/{k[len(pre):]}"]

    for k in [pre + "A/loss", pre + "B/loss"] + \
            golden_keys(golden, pre + "B/"):
        close(mine(k), golden[k], f"{tag} {k}")
        close(mine(k), meshless[k], f"{tag} {k} meshless")
    for k in meshless:
        if k.startswith(pre + "A/") and k != pre + "A/loss":
            close(mine(k), meshless[k], f"{tag} {k} meshless")


def check_serve(got, golden, meshless, pre: str, tag: str):
    keys = golden_keys(golden, pre + "prefill/") + \
        golden_keys(golden, pre + "decode/")
    assert len(keys) == 3 + GEN + 3
    for k in keys:
        mine = got[f"{tag}/{k[len(pre):]}"]
        close(mine, golden[k], f"{tag} {k}")
        close(mine, meshless[k], f"{tag} {k} meshless")


def check_shards(spawned, golden, pre: str, world: int, shape):
    """Each rank's shard of every parameter, before and after the two
    steps, is the reference's device slice of the whole array."""
    name = mesh_name(shape)
    tag = pre + name
    tmp, _ = spawned("inputs")
    p0 = np.load(tmp / "inputs.npz")
    for r in range(world):
        got = port_rank(spawned, world, r)
        paths = [k[len(f"{tag}/local0/"):] for k in got.files
                 if k.startswith(f"{tag}/local0/")]
        assert len(paths) == 3 + 9 * 2
        for p in paths:
            key, layer, sl = the_slice(golden, name, p, r, pre)
            w0, wB = p0[f"{pre}params0/{key}"], golden[f"{pre}B/params/{key}"]
            if layer is not None:
                w0, wB = w0[layer], wB[layer]
            np.testing.assert_array_equal(got[f"{tag}/local0/{p}"], w0[sl],
                                          err_msg=f"{tag} rank {r} {p}")
            close(got[f"{tag}/localB/{p}"], wB[sl], f"{tag} rank {r} {p}")


# ----------------------------------------------------------------------
# the reference
# ----------------------------------------------------------------------
def test_golden_is_the_jax_output(spawned, golden):
    """The committed golden is what the JAX package computes now."""
    tmp, _ = spawned("live")
    live = np.load(tmp / "live.npz")
    assert sorted(live.files) == sorted(golden.files)
    for k in golden.files:
        np.testing.assert_allclose(live[k], golden[k], rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def check_meshless(meshless, golden, pre: str):
    close(meshless[pre + "A/loss"], golden[pre + "A/loss"], "A/loss")
    for k in golden_keys(golden, pre + "B/") + \
            golden_keys(golden, pre + "prefill/") + \
            golden_keys(golden, pre + "decode/"):
        close(meshless[k], golden[k], k)


def test_meshless_port_matches_the_sharded_reference(meshless, golden):
    check_meshless(meshless, golden, "")


def test_meshless_head_split_arch_matches_the_sharded_reference(meshless,
                                                                golden):
    check_meshless(meshless, golden, "sc2/")


# ----------------------------------------------------------------------
# the cells over each mesh
# ----------------------------------------------------------------------
@pytest.mark.parametrize("world, shape", CASES)
def test_train_steps_match_the_reference_and_meshless(
        spawned, golden, meshless, world, shape):
    check_train(port_rank(spawned, world), golden, meshless, "",
                mesh_name(shape))


@pytest.mark.parametrize("world, shape", CASES)
def test_prefill_and_decode_match_the_reference_and_meshless(
        spawned, golden, meshless, world, shape):
    check_serve(port_rank(spawned, world), golden, meshless, "",
                mesh_name(shape))


@pytest.mark.parametrize("world, shape", CASES)
def test_local_shards_are_the_reference_device_slices(
        spawned, golden, world, shape):
    check_shards(spawned, golden, "", world, shape)


@pytest.mark.parametrize("world, shape", SPLIT_CASES)
def test_head_split_train_matches_the_reference_and_meshless(
        spawned, golden, meshless, world, shape):
    """Reduced StarCoder2's 2 KV heads split over tp 2: each rank attends
    with its own heads, the attention's output a term of a sum over tp,
    QKV columns and ``wo`` rows sharded by head groups, the input
    gradients partial over tp."""
    check_train(port_rank(spawned, world), golden, meshless, "sc2/",
                "sc2/" + mesh_name(shape))


@pytest.mark.parametrize("world, shape", SPLIT_CASES)
def test_head_split_prefill_and_decode_match_the_reference_and_meshless(
        spawned, golden, meshless, world, shape):
    """The same split in serving: K6 (its CPU twin here) on each rank's
    heads in prefill, decode's in-place write into a head-sharded
    cache."""
    check_serve(port_rank(spawned, world), golden, meshless, "sc2/",
                "sc2/" + mesh_name(shape))


@pytest.mark.parametrize("world, shape", SPLIT_CASES)
def test_head_split_local_shards_are_the_reference_device_slices(
        spawned, golden, world, shape):
    check_shards(spawned, golden, "sc2/", world, shape)


def test_multi_axis_entries_shard_major_first_as_jax(spawned, golden):
    """On a ("pod", "data", "model") mesh (2, 2, 1) the FSDP entry
    ("pod", "data") shards one dimension over two mesh dimensions, pod
    major: each rank's shard is the reference's device slice."""
    tmp, _ = spawned("inputs")
    p0 = np.load(tmp / "inputs.npz")
    name = mesh_name(POD)
    for r in range(4):
        got = port_rank(spawned, 4, r)
        paths = [k[len("pod/local0/"):] for k in got.files
                 if k.startswith("pod/local0/")]
        assert paths
        for p in paths:
            key, layer, sl = the_slice(golden, name, p, r)
            w = p0[f"params0/{key}"]
            w = w[layer] if layer is not None else w
            np.testing.assert_array_equal(got[f"pod/local0/{p}"], w[sl],
                                          err_msg=f"rank {r} {p}")


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard

    fake_world(8)
    try:
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh("cpu", (2, 2, 2),
                                mesh_dim_names=("pod", "data", "model"))
        P = shd.P
        assert shd.placements(P(("pod", "data"), "model"), mesh) == \
            (Shard(0), Shard(0), Shard(1))
        assert shd.placements(P(None, "model"), mesh) == \
            (Replicate(), Replicate(), Shard(1))
        assert shd.placements(P(), mesh) == (Replicate(),) * 3
        with pytest.raises(ValueError, match="order"):
            shd.placements(P(("data", "pod")), mesh)
        s = shd.named(mesh, {"w": P("model", None)})["w"]
        assert s.placements == (Replicate(), Replicate(), Shard(0))
        assert shd.named(None, {"w": P()}) is None
    finally:
        dist.destroy_process_group()


def test_planted_fault_replicated_head_gradient_fails(spawned, golden):
    """Head-split attention whose input gradients are taken as replicated
    over ``model`` (world 2, mesh (1, 2), reduced StarCoder2): the
    forward is the reference's, the gradients are not, so the moments
    and the updated params differ from the golden's."""
    got = port_rank(spawned, 2)
    assert int(got["fault_heads/flipped"]) > 0
    close(got["fault_heads/A/loss"], golden["sc2/A/loss"], "fault A/loss")
    for k in ("B/m/embed", "B/m/layers/ln1", "B/v/layers/wq",
              "B/params/embed"):
        mine, want = got[f"fault_heads/{k}"], golden["sc2/" + k]
        assert np.all(np.isfinite(mine)), k
        assert differs(mine, want, k), k


def test_planted_fault_without_the_lookups_sum_fails(spawned, golden):
    """The vocab-parallel lookup's terms left unsummed over ``model``
    (world 2, mesh (1, 2)): the loss is no longer the reference's."""
    got = port_rank(spawned, 2)
    fault = float(got["fault/loss"])
    assert np.isfinite(fault)
    assert not np.isclose(fault, float(golden["A/loss"]), atol=ATOL,
                          rtol=RTOL), fault


# ----------------------------------------------------------------------
# elastic restore
# ----------------------------------------------------------------------
@pytest.mark.parametrize("world, tag", [(4, "elastic4x1"),
                                        (2, "elastic1x2")])
def test_elastic_restore_is_byte_equal_and_resumes(spawned, golden, world,
                                                   tag):
    """The (2, 2) state saved after the first step comes back onto (4, 1)
    in the same world and onto (1, 2) in a world of 2: every array equal
    to the saved one byte for byte, each rank's shard the reference's
    slice, and the step after it allclose to the uninterrupted one."""
    saved = port_rank(spawned, 4)
    shape = tag[len("elastic"):]
    for r in range(world):
        got = port_rank(spawned, world, r)
        if r == 0:
            keys = [k for k in got.files if k.startswith(f"{tag}/restored/")]
            assert len(keys) == 3 * 12
            for k in keys:
                want = saved["2x2/A/" + k[len(f"{tag}/restored/"):]]
                assert got[k].dtype == want.dtype
                assert got[k].tobytes() == want.tobytes(), k
            close(got[f"{tag}/resumed/loss"], golden["B/loss"], tag)
            for k in golden_keys(golden, "B/params/"):
                close(got[f"{tag}/resumed/params/" + k[len("B/params/"):]],
                      golden[k], f"{tag} {k}")
        for k in got.files:
            if k.startswith(f"{tag}/restored_local/"):
                p = k[len(f"{tag}/restored_local/"):]
                key, layer, sl = the_slice(golden, shape, p, r)
                w = saved[f"2x2/A/params/{key}"]
                w = w[layer] if layer is not None else w
                assert got[k].tobytes() == w[sl].tobytes(), (r, p)


def test_elastic_restore_changes_mesh(tmp_path):
    """The reference's ``tests/test_substrates.py`` case: a checkpoint
    saved from one mesh restores onto another (here a gloo world of 1,
    mesh (1, 1), every leaf replicated)."""
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh1 = mesh_mod.make_test_mesh(1, tp=1, device="cpu")
        tree = {"w": torch.arange(16, dtype=torch.float32).reshape(4, 4)}
        ckpt = CheckpointManager(str(tmp_path / "ck"))
        ckpt.save(1, tree, blocking=True)

        def rule(params, mesh):
            return tree_map(lambda p: shd.NamedSharding(
                mesh, shd.P(*([None] * p.dim()))), params)

        restored, step = elastic_restore(ckpt, tree, mesh1, rule)
        assert step == 1
        assert torch.equal(restored["w"].full_tensor(), tree["w"])
        # a DTensor leaf comes back on its own mesh and placements
        again, _ = ckpt.restore(restored)
        assert again["w"].placements == restored["w"].placements
        assert torch.equal(again["w"].to_local(), tree["w"])
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------------
# the trainer, the dry run, refusals
# ----------------------------------------------------------------------
def test_trainer_over_gloo_world_4_survives_its_failure(spawned, tmp_path):
    """``torch.distributed.run`` of the trainer, 4 ranks, tp 2, a failure
    injected at step 6: it restarts once from its step-4 checkpoint, and
    its losses are world 1's."""
    from repro_torch.launch import train

    tmp, logs = spawned("trainer")
    got = json_of(tmp / "train4.json")
    want_path = tmp_path / "train1.json"
    losses = train.main(TRAIN_ARGS + ["--ckpt-dir", str(tmp_path / "ck"),
                                      "--json", str(want_path)])
    want = json_of(want_path)
    assert got["restarts"] == want["restarts"] == 1
    assert got["steps"] == 12
    assert len(got["losses"]) == len(losses) == 12 + 2
    np.testing.assert_allclose(got["losses"], want["losses"], atol=ATOL,
                               rtol=RTOL)
    assert "done: 12 steps, 1 restarts" in logs[0]


def json_of(path):
    import json

    with open(path) as f:
        return json.load(f)


def fake_world(n):
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)


def test_dry_run_lm_rows_on_a_fake_world_of_8():
    shapes = {"train_4k": ShapeCell("train_4k", "train", batch=8,
                                    seq_len=32),
              "prefill_32k": ShapeCell("prefill_32k", "prefill", batch=8,
                                       seq_len=32),
              "decode_32k": ShapeCell("decode_32k", "decode", batch=8,
                                      seq_len=32)}
    for arch_id in ("smollm-360m", "starcoder2-7b", "granite-20b"):
        a = dataclasses.replace(registry.get_config(arch_id, reduced=True),
                                shapes=shapes)
        for shape in shapes:
            rec = dryrun.run_lm_cell(a, shape, False, verbose=False,
                                     device="cpu", world=8, tp=2)
            assert rec["mesh"] == [4, 2] and rec["world"] == 8
            assert rec["rank"] == 0 and rec["launches"] == {}
            mem = rec["memory"]
            assert mem["argument_bytes"] > 0 and mem["output_bytes"] > 0
            assert mem["peak_allocated_bytes"] is None     # the CPU
            calls = rec["collectives"]["calls"]
            assert calls.get("all_gather_into_tensor", 0) > 0
            assert set(rec["collectives"]["sent_bytes"]) == set(calls)
            if shape == "train_4k":
                assert calls.get("reduce_scatter_tensor", 0) > 0
            assert rec["terms_s"]["collective"] == sum(
                rec["collectives"]["sent_bytes"].values()) / \
                dryrun.LINK_BW
            assert not dist.is_initialized()
    moe = dryrun.run_cell("qwen2-moe-a2.7b", "train_4k", False,
                          verbose=False)
    assert moe["skip"] == dryrun.MOE_LMS and "9c.4" in moe["skip"]
    assert dryrun.run_cell("smollm-360m", "long_500k", False,
                           verbose=False)["skip"]


def test_comm_count_gives_the_bytes_a_ring_sends():
    """On a ``fake`` world of 8, one-dimensional mesh, a [8, 16] f32
    tensor (512 bytes): Shard(0) → Replicate all-gathers a 64-byte
    operand (7 · 64 sent), Partial → Shard(0) reduce-scatters 512
    (7/8 · 512), Partial → Replicate all-reduces 512 (2 · 7/8 · 512)."""
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)

    fake_world(8)
    try:
        mesh = mesh_mod.make_test_mesh(8, tp=1, device="cpu")["data"]
        local = torch.zeros(1, 16)
        whole = torch.zeros(8, 16)
        want = {"all_gather_into_tensor": 7 * 64,
                "reduce_scatter_tensor": 7 * 512 // 8,
                "all_reduce": 2 * 7 * 512 // 8}
        for (t, src, dst), kind in zip(
                [(local, Shard(0), Replicate()), (whole, Partial(), Shard(0)),
                 (whole, Partial(), Replicate())], want):
            counter = dryrun.CommCount()
            x = DTensor.from_local(t, mesh, [src], run_check=False)
            with counter:
                x.redistribute(mesh, [dst])
            assert counter.sent_bytes == {kind: want[kind]}
    finally:
        dist.destroy_process_group()


def test_moe_and_other_families_refuse_a_mesh():
    fake_world(8)
    try:
        mesh = mesh_mod.make_test_mesh(tp=2, device="cpu")
        moe = registry.get_config("qwen2-moe-a2.7b", reduced=True)
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            with pytest.raises(NotImplementedError, match=r"item 9c\.4"):
                steps.build_cell(moe, shape, mesh)
        with pytest.raises(NotImplementedError, match=r"item 9c\.4"):
            tr.MeshPlan(moe.model, mesh, tp_axis="model")
        for arch_id, shape in (("gcn-cora", "full_graph_sm"),
                               ("autoint", "train_batch"),
                               ("nequip", "molecule")):
            with pytest.raises(NotImplementedError, match="item 9c"):
                steps.build_cell(registry.get_config(arch_id, reduced=True),
                                 shape, mesh)
        cell = steps.build_cell(registry.get_config("smollm-360m"),
                                "train_4k", mesh)
        params, opt, batch = cell.abstract_inputs
        assert tuple(batch["tokens"].shape) == (64, 4096)
        assert tuple(params["embed"].shape) == (49152 // 2, 960 // 4)
        assert cell.out_shardings[2].spec == shd.P()
        dec = steps.build_cell(registry.get_config("smollm-360m"),
                               "decode_32k", mesh)
        # 5 KV heads over tp 2: the cache shards its sequence
        assert tuple(dec.abstract_inputs[1].k.shape) == (32, 32, 16384, 5,
                                                         64)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="one rank of a mesh world, "
                                 "or (no arguments) rewrite the golden")
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world", type=int)
    ap.add_argument("--store")
    ap.add_argument("--inputs")
    ap.add_argument("--out")
    ap.add_argument("--ckpt")
    a = ap.parse_args()
    if a.rank is None:
        p = reference("golden", GOLDEN)
        log, _ = p.communicate()
        print(log[-4000:])
        sys.exit(p.returncode)
    rank_main(a.rank, a.world, a.store, a.inputs, a.out, a.ckpt)
