"""Model code of the port (mirrors ``repro/models``): the dense and MoE
decoder LMs, the GNNs and the AutoInt recommender."""
