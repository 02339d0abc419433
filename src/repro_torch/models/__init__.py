"""Model code of the port (mirrors ``repro/models``): the dense and MoE
decoder LMs, the GNNs, the NequIP potential and the AutoInt
recommender."""
