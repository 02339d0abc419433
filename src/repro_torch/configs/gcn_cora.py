"""GCN on Cora [arXiv:1609.02907] — 2L, d=16, mean/sym-norm aggregation
(mirrors ``repro/configs/gcn_cora.py``)."""
from ..models.gnn import GNNConfig
from .base import ArchConfig, gnn_shapes


def _model(reduced=False):
    return GNNConfig("gcn-cora", "gcn", n_layers=2,
                     d_in=64 if reduced else 1433,
                     d_hidden=16, n_classes=7)


def _reduced():
    return ArchConfig("gcn-cora", "gnn", _model(True), gnn_shapes(),
                      source="arXiv:1609.02907")


CONFIG = ArchConfig("gcn-cora", "gnn", _model(), gnn_shapes(),
                    source="arXiv:1609.02907", reduced=_reduced)
