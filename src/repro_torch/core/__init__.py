"""Core of the port: graph structures, Phase 1/2/3 and the BSP engine
(mirrors ``repro/core``).  Only the numpy-only Makki baseline is
exported here, as the reference exports it; the engine modules are
imported by name."""
from .makki import MakkiResult, makki_tour

__all__ = ["MakkiResult", "makki_tour"]
