"""Granite-20B-Code [arXiv:2405.04324; hf] — MQA (kv=1) code LM (mirrors
``repro/configs/granite_20b.py``, with torch dtypes).

The architecture is the reference's as written: the port's ``LMConfig``
block (SwiGLU FFN, RMSNorm, no biases), 48 query heads on one KV head of
width 128.  The reduced config's head width is 16, which K6 takes in
f32."""
import torch

from ..models.transformer import LMConfig
from .base import ArchConfig, lm_shapes


def _model(reduced=False):
    if reduced:
        return LMConfig("granite-20b-smoke", n_layers=2, d_model=128,
                        n_heads=8, n_kv_heads=1, d_ff=512, vocab=512,
                        dtype=torch.float32, remat=False)
    return LMConfig("granite-20b", n_layers=52, d_model=6144, n_heads=48,
                    n_kv_heads=1, d_ff=24576, vocab=49152)


def _reduced():
    return ArchConfig("granite-20b", "lm", _model(reduced=True),
                      lm_shapes(True), source="arXiv:2405.04324")


CONFIG = ArchConfig("granite-20b", "lm", _model(), lm_shapes(True),
                    source="arXiv:2405.04324", reduced=_reduced)
