"""GraphSAGE-style fanout neighbor sampler (minibatch_lg shape; a numpy
copy of ``repro/graphgen/sampler.py``).

Samples L-hop neighborhoods with per-hop fanouts (e.g. 15-10) from a CSR
adjacency, producing padded ``GraphBatch``-compatible blocks: host-side
numpy, emitting static shapes.  The CSR build and the ``rng.choice``
calls are the reference's, in its order, so the same graph, fanouts and
seed give the same blocks, call after call.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from ..core.graph import Graph


@dataclasses.dataclass
class SampledBlock:
    """One minibatch: seed nodes + their sampled L-hop union subgraph."""

    node_ids: np.ndarray      # [N_pad] global ids of subgraph nodes (-1 pad)
    node_mask: np.ndarray
    edge_src: np.ndarray      # [E_pad] local indices into node_ids
    edge_dst: np.ndarray
    edge_mask: np.ndarray
    seed_local: np.ndarray    # [B] local indices of the seed nodes


class NeighborSampler:
    def __init__(self, graph: Graph, fanouts: Tuple[int, ...], seed: int = 0):
        self.graph = graph
        self.fanouts = fanouts
        self.rng = np.random.default_rng(seed)
        V, E = graph.num_vertices, graph.num_edges
        deg = graph.degrees()
        self.offsets = np.zeros(V + 1, dtype=np.int64)
        np.cumsum(deg, out=self.offsets[1:])
        stub_vert = np.empty(2 * E, dtype=np.int64)
        stub_vert[0::2] = graph.edge_u
        stub_vert[1::2] = graph.edge_v
        order = np.argsort(stub_vert, kind="stable")
        other = np.empty(2 * E, dtype=np.int64)
        other[0::2] = graph.edge_v
        other[1::2] = graph.edge_u
        self.nbr = other[order]
        # static pads: 1 + f1 + f1*f2 + ... nodes a seed
        tot = acc = 1
        for f in fanouts:
            acc *= f
            tot += acc
        self.nodes_per_seed = tot

    def sample(self, seeds: np.ndarray) -> SampledBlock:
        B = len(seeds)
        n_pad = B * self.nodes_per_seed
        e_pad = n_pad  # each sampled node contributes one in-edge
        nodes: List[int] = list(seeds)
        index = {int(s): i for i, s in enumerate(seeds)}
        src_l: List[int] = []
        dst_l: List[int] = []
        frontier = list(seeds)
        for f in self.fanouts:
            nxt: List[int] = []
            for v in frontier:
                lo, hi = self.offsets[v], self.offsets[v + 1]
                if hi == lo:
                    continue
                k = min(f, hi - lo)
                picks = self.rng.choice(hi - lo, size=k, replace=False) + lo
                for p in picks:
                    w = int(self.nbr[p])
                    if w not in index:
                        index[w] = len(nodes)
                        nodes.append(w)
                        nxt.append(w)
                    src_l.append(index[w])
                    dst_l.append(index[int(v)])
            frontier = nxt

        n = len(nodes)
        e = len(src_l)
        node_ids = np.full(n_pad, -1, dtype=np.int64)
        node_ids[:n] = nodes
        node_mask = np.zeros(n_pad, dtype=bool)
        node_mask[:n] = True
        edge_src = np.full(e_pad, n_pad - 1, dtype=np.int64)
        edge_dst = np.full(e_pad, n_pad - 1, dtype=np.int64)
        edge_mask = np.zeros(e_pad, dtype=bool)
        edge_src[:e] = src_l
        edge_dst[:e] = dst_l
        edge_mask[:e] = True
        return SampledBlock(
            node_ids=node_ids,
            node_mask=node_mask,
            edge_src=edge_src,
            edge_dst=edge_dst,
            edge_mask=edge_mask,
            seed_local=np.arange(B, dtype=np.int64),
        )
