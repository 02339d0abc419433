"""Arch registry: --arch <id> → ArchConfig (mirrors
``repro/configs/registry.py``; lists only the architectures the port
has)."""
from importlib import import_module

ARCH_IDS = ["smollm-360m"]

_MODULES = {"smollm-360m": "smollm_360m"}


def get_config(arch_id: str, reduced: bool = False):
    if arch_id not in _MODULES:
        raise KeyError(f"{arch_id!r} is not ported yet (ROADMAP queue 1 "
                       f"item 8); the port has {ARCH_IDS}")
    mod = import_module(f"{__package__}.{_MODULES[arch_id]}")
    cfg = mod.CONFIG
    return cfg.reduced() if reduced else cfg
