"""GAT on Cora [arXiv:1710.10903] — 2L, 8 heads × d=8, attn aggregation
(mirrors ``repro/configs/gat_cora.py``)."""
from ..models.gnn import GNNConfig
from .base import ArchConfig, gnn_shapes


def _model(reduced=False):
    return GNNConfig("gat-cora", "gat", n_layers=2,
                     d_in=64 if reduced else 1433,
                     d_hidden=8, n_classes=7, n_heads=8)


def _reduced():
    return ArchConfig("gat-cora", "gnn", _model(True), gnn_shapes(),
                      source="arXiv:1710.10903")


CONFIG = ArchConfig("gat-cora", "gnn", _model(), gnn_shapes(),
                    source="arXiv:1710.10903", reduced=_reduced)
