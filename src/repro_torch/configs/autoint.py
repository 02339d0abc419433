"""AutoInt [arXiv:1810.11921] — 39 fields × 16d embeddings, 3 attn layers
(mirrors ``repro/configs/autoint.py``)."""
from ..models.recsys import AutoIntConfig
from .base import ArchConfig, recsys_shapes


def _model(reduced=False):
    if reduced:
        return AutoIntConfig("autoint-smoke", n_fields=6, vocab_per_field=256,
                             embed_dim=8, n_attn_layers=2, n_heads=2,
                             d_attn=8, mlp_dims=(32,))
    return AutoIntConfig("autoint", n_fields=39, vocab_per_field=1_000_000,
                         embed_dim=16, n_attn_layers=3, n_heads=2, d_attn=32,
                         mlp_dims=(400, 400))


def _reduced():
    return ArchConfig("autoint", "recsys", _model(True), recsys_shapes(),
                      source="arXiv:1810.11921")


CONFIG = ArchConfig("autoint", "recsys", _model(), recsys_shapes(),
                    source="arXiv:1810.11921", reduced=_reduced)
