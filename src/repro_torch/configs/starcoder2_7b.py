"""StarCoder2-7B [arXiv:2402.19173; hf] — dense GQA code LM (mirrors
``repro/configs/starcoder2_7b.py``, with torch dtypes).

The architecture is the reference's as written: the port's ``LMConfig``
block (SwiGLU FFN, RMSNorm, no biases, no sliding window), 36 query
heads on 4 KV heads of width 128, RoPE base 10⁶."""
import torch

from ..models.transformer import LMConfig
from .base import ArchConfig, lm_shapes


def _model(reduced=False):
    if reduced:
        return LMConfig("starcoder2-7b-smoke", n_layers=2, d_model=128,
                        n_heads=4, n_kv_heads=2, d_ff=512, vocab=512,
                        dtype=torch.float32, remat=False)
    return LMConfig("starcoder2-7b", n_layers=32, d_model=4608, n_heads=36,
                    n_kv_heads=4, d_ff=18432, vocab=49152,
                    rope_theta=1_000_000.0)


def _reduced():
    return ArchConfig("starcoder2-7b", "lm", _model(reduced=True),
                      lm_shapes(True), source="arXiv:2402.19173")


CONFIG = ArchConfig("starcoder2-7b", "lm", _model(), lm_shapes(True),
                    source="arXiv:2402.19173", reduced=_reduced)
