"""NequIP [arXiv:2101.03164] — 5L, 32ch, l_max=2, 8 RBF, cutoff 5 Å
(mirrors ``repro/configs/nequip.py``).

E(3)-equivariant interatomic potential.  Non-molecular shape cells
(full_graph_sm etc.) treat the graph as a point cloud with 3-D
coordinates — the same compute regime.
"""
from ..models.equivariant import NequIPConfig
from .base import ArchConfig, gnn_shapes


def _model(reduced=False):
    if reduced:
        return NequIPConfig("nequip-smoke", n_layers=2, channels=8, n_rbf=4)
    return NequIPConfig("nequip", n_layers=5, channels=32, n_rbf=8,
                        cutoff=5.0)


def _reduced():
    return ArchConfig("nequip", "nequip", _model(True), gnn_shapes(),
                      source="arXiv:2101.03164")


CONFIG = ArchConfig("nequip", "nequip", _model(), gnn_shapes(),
                    source="arXiv:2101.03164", reduced=_reduced)
