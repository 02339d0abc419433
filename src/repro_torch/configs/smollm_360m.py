"""SmolLM-360M [hf:HuggingFaceTB] — small llama-arch GQA LM (mirrors
``repro/configs/smollm_360m.py``, with torch dtypes)."""
import torch

from ..models.transformer import LMConfig
from .base import ArchConfig, lm_shapes


def _model(reduced=False):
    if reduced:
        return LMConfig("smollm-360m-smoke", n_layers=2, d_model=96,
                        n_heads=3, n_kv_heads=1, d_ff=256, vocab=512,
                        d_head=32, dtype=torch.float32, remat=False)
    return LMConfig("smollm-360m", n_layers=32, d_model=960, n_heads=15,
                    n_kv_heads=5, d_ff=2560, vocab=49152)


def _reduced():
    return ArchConfig("smollm-360m", "lm", _model(reduced=True),
                      lm_shapes(True), source="hf:HuggingFaceTB/SmolLM-360M")


CONFIG = ArchConfig("smollm-360m", "lm", _model(), lm_shapes(True),
                    source="hf:HuggingFaceTB/SmolLM-360M", reduced=_reduced)
