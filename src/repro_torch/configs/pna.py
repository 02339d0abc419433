"""PNA [arXiv:2004.05718] — 4L, d=75, mean/max/min/std × id/amp/atten
(mirrors ``repro/configs/pna.py``)."""
from ..models.gnn import GNNConfig
from .base import ArchConfig, gnn_shapes


def _model(reduced=False):
    return GNNConfig("pna", "pna", n_layers=2 if reduced else 4,
                     d_in=64 if reduced else 1433,
                     d_hidden=16 if reduced else 75, n_classes=7,
                     aggregators=("mean", "max", "min", "std"),
                     scalers=("identity", "amplification", "attenuation"))


def _reduced():
    return ArchConfig("pna", "gnn", _model(True), gnn_shapes(),
                      source="arXiv:2004.05718")


CONFIG = ArchConfig("pna", "gnn", _model(), gnn_shapes(),
                    source="arXiv:2004.05718", reduced=_reduced)
