"""Core of the port: graph structures, Phase 1/2/3 and the BSP engine
(mirrors ``repro/core``)."""
