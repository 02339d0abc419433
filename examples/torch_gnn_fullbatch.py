"""Full-batch GNN training on a synthetic Cora-shaped graph (GCN), on the
PyTorch port (mirrors ``examples/gnn_fullbatch.py``): the reduced GCN
config, 250 steps of ``build_cell``'s train step on a planted-partition
graph of 512 nodes and 2,048 edges, then the train accuracy, which must
pass 0.5.

    PYTHONPATH=src python examples/torch_gnn_fullbatch.py [--device cpu]

It runs on ``cuda`` unless given ``--device cpu``.
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ShapeCell
from repro_torch.configs.registry import get_config
from repro_torch.launch.steps import build_cell
from repro_torch.models import gnn as gnn_mod
from repro_torch.optim import init_adamw


def planted_partition(rng: np.random.Generator, n: int, e: int,
                      d_feat: int, n_classes: int):
    """A graph whose labels a GNN can learn, as numpy arrays ``(feat [n,
    d_feat], src [e], dst [e], labels [n])``: 70% of the edges join two
    nodes of one class, and a node's features are its class's random
    centre plus noise (the reference example's draws, in its order)."""
    labels = rng.integers(0, n_classes, n)
    src = rng.integers(0, n, e)
    same = rng.random(e) < 0.7
    dst = np.where(same,
                   np.array([rng.choice(np.nonzero(labels == labels[s])[0])
                             for s in src]),
                   rng.integers(0, n, e))
    feat = np.eye(n_classes)[labels] @ rng.normal(size=(n_classes, d_feat)) \
        + rng.normal(size=(n, d_feat)) * .5
    return feat, src, dst, labels


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    arch = get_config("gcn-cora", reduced=True)
    shape = ShapeCell("full_graph_sm", "graph_train", n_nodes=512,
                      n_edges=2048, d_feat=64, n_classes=7)
    arch = dataclasses.replace(arch, shapes={"g": shape})
    cell = build_cell(arch, "g")

    cfg = dataclasses.replace(arch.model, d_in=64, n_classes=7)
    g_abs = cell.abstract_inputs[2]
    n, e = g_abs.node_feat.shape[0], g_abs.edge_src.shape[0]
    feat, src, dst, labels = planted_partition(np.random.default_rng(0), n,
                                               e, 64, 7)
    g = gnn_mod.GraphBatch(
        node_feat=torch.tensor(feat, dtype=torch.float32, device=dev),
        edge_src=torch.tensor(src, dtype=torch.int32, device=dev),
        edge_dst=torch.tensor(dst, dtype=torch.int32, device=dev),
        edge_mask=torch.ones(e, dtype=torch.bool, device=dev),
        node_mask=torch.ones(n, dtype=torch.bool, device=dev),
        labels=torch.tensor(labels, dtype=torch.int32, device=dev))

    params = gnn_mod.INITS[cfg.kind](
        torch.Generator(device=dev).manual_seed(0), cfg)
    opt = init_adamw(params)
    for i in range(250):
        params, opt, loss = cell.fn(params, opt, g)
        if i % 50 == 0:
            print(f"step {i:3d} loss {float(loss):.4f}")
    with torch.no_grad():
        logits = gnn_mod.FORWARDS[cfg.kind](params, cfg, g)
    acc = float((torch.argmax(logits, -1) == g.labels).float().mean())
    print(f"train accuracy: {acc:.2%}")
    assert acc > 0.5
    return acc


if __name__ == "__main__":
    main()
