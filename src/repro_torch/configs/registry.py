"""Arch registry: --arch <id> → ArchConfig (mirrors
``repro/configs/registry.py``; lists only the architectures the port
has)."""
from importlib import import_module

ARCH_IDS = ["smollm-360m", "qwen2-moe-a2.7b", "qwen3-moe-235b-a22b",
            "gat-cora", "pna", "gcn-cora", "nequip", "autoint"]

_MODULES = {"smollm-360m": "smollm_360m",
            "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
            "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
            "gat-cora": "gat_cora",
            "pna": "pna",
            "gcn-cora": "gcn_cora",
            "nequip": "nequip",
            "autoint": "autoint"}


def get_config(arch_id: str, reduced: bool = False):
    if arch_id not in _MODULES:
        raise KeyError(f"{arch_id!r} is not ported yet (ROADMAP queue 1 "
                       f"item 8); the port has {ARCH_IDS}")
    mod = import_module(f"{__package__}.{_MODULES[arch_id]}")
    cfg = mod.CONFIG
    return cfg.reduced() if reduced else cfg
