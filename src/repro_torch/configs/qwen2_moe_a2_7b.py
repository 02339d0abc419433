"""Qwen1.5/2-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B] — 4 shared + 60 routed
top-4 (mirrors ``repro/configs/qwen2_moe_a2_7b.py``, with torch dtypes)."""
import torch

from ..models.moe import MoEConfig
from ..models.transformer import LMConfig
from .base import ArchConfig, lm_shapes


def _model(reduced=False):
    if reduced:
        return LMConfig("qwen2-moe-smoke", n_layers=2, d_model=128,
                        n_heads=4, n_kv_heads=4, d_ff=0, vocab=512,
                        dtype=torch.float32, remat=False,
                        moe=MoEConfig(n_experts=8, top_k=2, d_expert=64,
                                      n_shared=1))
    return LMConfig("qwen2-moe-a2.7b", n_layers=24, d_model=2048, n_heads=16,
                    n_kv_heads=16, d_ff=0, vocab=151936,
                    moe=MoEConfig(n_experts=60, top_k=4, d_expert=1408,
                                  n_shared=4))


def _reduced():
    return ArchConfig("qwen2-moe-a2.7b", "lm", _model(reduced=True),
                      lm_shapes(True), source="hf:Qwen/Qwen1.5-MoE-A2.7B")


CONFIG = ArchConfig("qwen2-moe-a2.7b", "lm", _model(), lm_shapes(True),
                    source="hf:Qwen/Qwen1.5-MoE-A2.7B", reduced=_reduced)
