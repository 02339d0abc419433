"""Config system: architectures × shape cells (a copy of
``repro/configs/base.py``'s ``ShapeCell``, ``ArchConfig``, ``lm_shapes``,
``gnn_shapes`` and ``recsys_shapes``; that module imports no JAX, but the
port imports nothing of the reference package).

Each ``configs/<arch>.py`` exposes ``CONFIG: ArchConfig``.  A shape cell
names a workload (train / prefill / decode / graph / serve / retrieval)
with concrete sizes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str                 # train|prefill|decode|graph_train|serve|retrieval|superstep
    batch: int = 1
    seq_len: int = 0
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    n_classes: int = 0
    batch_nodes: int = 0
    fanout: Tuple[int, ...] = ()
    n_candidates: int = 0
    note: str = ""
    skip: Optional[str] = None  # reason, e.g. "full-attention long-context"


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str               # lm | gnn | nequip | recsys | euler
    model: Any
    shapes: Dict[str, ShapeCell]
    source: str = ""          # public-literature citation
    reduced: Optional[Callable[[], "ArchConfig"]] = None


# shared LM shape set (assignment block)
def lm_shapes(full_attention: bool) -> Dict[str, ShapeCell]:
    return {
        "train_4k": ShapeCell("train_4k", "train", batch=256, seq_len=4096),
        "prefill_32k": ShapeCell("prefill_32k", "prefill", batch=32,
                                 seq_len=32768),
        "decode_32k": ShapeCell("decode_32k", "decode", batch=128,
                                seq_len=32768),
        "long_500k": ShapeCell(
            "long_500k", "decode", batch=1, seq_len=524288,
            skip=("full-attention arch: 500k decode requires sub-quadratic "
                  "attention (DESIGN.md §6)") if full_attention else None,
        ),
    }


def gnn_shapes() -> Dict[str, ShapeCell]:
    return {
        "full_graph_sm": ShapeCell("full_graph_sm", "graph_train",
                                   n_nodes=2708, n_edges=10556, d_feat=1433,
                                   n_classes=7),
        "minibatch_lg": ShapeCell("minibatch_lg", "graph_train",
                                  n_nodes=232965, n_edges=114615892,
                                  batch_nodes=1024, fanout=(15, 10),
                                  d_feat=602, n_classes=41),
        "ogb_products": ShapeCell("ogb_products", "graph_train",
                                  n_nodes=2449029, n_edges=61859140,
                                  d_feat=100, n_classes=47),
        "molecule": ShapeCell("molecule", "graph_train", n_nodes=30,
                              n_edges=64, batch=128, d_feat=16, n_classes=4),
    }


def recsys_shapes() -> Dict[str, ShapeCell]:
    return {
        "train_batch": ShapeCell("train_batch", "train", batch=65536),
        "serve_p99": ShapeCell("serve_p99", "serve", batch=512),
        "serve_bulk": ShapeCell("serve_bulk", "serve", batch=262144),
        "retrieval_cand": ShapeCell("retrieval_cand", "retrieval", batch=1,
                                    n_candidates=1_000_000),
    }
