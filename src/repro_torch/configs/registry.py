"""Arch registry: --arch <id> → ArchConfig (mirrors
``repro/configs/registry.py``, in its order; lists every architecture
but ``euler-rmat``, whose cells wait for the mesh)."""
from importlib import import_module

ARCH_IDS = ["starcoder2-7b", "granite-20b", "smollm-360m",
            "qwen2-moe-a2.7b", "qwen3-moe-235b-a22b",
            "gat-cora", "pna", "gcn-cora", "nequip",
            "autoint"]

_MODULES = {"starcoder2-7b": "starcoder2_7b",
            "granite-20b": "granite_20b",
            "smollm-360m": "smollm_360m",
            "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
            "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
            "gat-cora": "gat_cora",
            "pna": "pna",
            "gcn-cora": "gcn_cora",
            "nequip": "nequip",
            "autoint": "autoint"}


#: the reference's architectures the port does not have yet, and why
NOT_PORTED = {"euler-rmat": "ROADMAP queue 1 item 9: the Euler cells need "
                            "the mesh specs of parallel/sharding.py"}


def get_config(arch_id: str, reduced: bool = False):
    if arch_id in NOT_PORTED:
        raise KeyError(f"{arch_id!r} is not ported yet "
                       f"({NOT_PORTED[arch_id]}); the port has {ARCH_IDS}")
    mod = import_module(f"{__package__}.{_MODULES[arch_id]}")
    cfg = mod.CONFIG
    return cfg.reduced() if reduced else cfg
