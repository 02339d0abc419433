"""Arch registry: --arch <id> → ArchConfig (mirrors
``repro/configs/registry.py``, every architecture in its order).
``euler-rmat``'s cells run over a mesh only (``launch/steps.py``)."""
from importlib import import_module

ARCH_IDS = ["starcoder2-7b", "granite-20b", "smollm-360m",
            "qwen2-moe-a2.7b", "qwen3-moe-235b-a22b",
            "gat-cora", "pna", "gcn-cora", "nequip",
            "autoint",
            "euler-rmat"]

_MODULES = {"starcoder2-7b": "starcoder2_7b",
            "granite-20b": "granite_20b",
            "smollm-360m": "smollm_360m",
            "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
            "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
            "gat-cora": "gat_cora",
            "pna": "pna",
            "gcn-cora": "gcn_cora",
            "nequip": "nequip",
            "autoint": "autoint",
            "euler-rmat": "euler_rmat"}


def get_config(arch_id: str, reduced: bool = False):
    mod = import_module(f"{__package__}.{_MODULES[arch_id]}")
    cfg = mod.CONFIG
    return cfg.reduced() if reduced else cfg
