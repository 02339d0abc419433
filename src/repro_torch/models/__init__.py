"""Model code of the port (mirrors ``repro/models``): the dense and MoE
decoder LMs and the GNNs."""
