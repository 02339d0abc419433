"""Qwen3-MoE-235B-A22B [hf:Qwen/Qwen3-235B-A22B] — 128 experts top-8
(mirrors ``repro/configs/qwen3_moe_235b_a22b.py``, with torch dtypes).

The reference's ``moe_shard_map=True`` (expert parallelism over a mesh)
is left out until expert parallelism is ported (ROADMAP queue 1 item
9c.4): the full config is 470 GB in bf16 and stays abstract on one
card.  The reduced
config's head width, 16, is one K6 takes in f32 (its f32
instantiation), so it serves on the card and on the CPU."""
import torch

from ..models.moe import MoEConfig
from ..models.transformer import LMConfig
from .base import ArchConfig, lm_shapes


def _model(reduced=False):
    if reduced:
        return LMConfig("qwen3-moe-smoke", n_layers=2, d_model=128,
                        n_heads=8, n_kv_heads=2, d_ff=0, vocab=512,
                        d_head=16, dtype=torch.float32, remat=False,
                        moe=MoEConfig(n_experts=16, top_k=4, d_expert=32))
    return LMConfig("qwen3-moe-235b-a22b", n_layers=94, d_model=4096,
                    n_heads=64, n_kv_heads=4, d_ff=0, vocab=151936,
                    d_head=128,
                    moe=MoEConfig(n_experts=128, top_k=8, d_expert=1536))


def _reduced():
    return ArchConfig("qwen3-moe-235b-a22b", "lm", _model(reduced=True),
                      lm_shapes(True), source="hf:Qwen/Qwen3-235B-A22B")


CONFIG = ArchConfig("qwen3-moe-235b-a22b", "lm", _model(), lm_shapes(True),
                    source="hf:Qwen/Qwen3-235B-A22B", reduced=_reduced)
