"""Graph data substrate: generators, eulerizer, partitioner, sampler (numpy
copies of ``repro/graphgen``)."""
from .rmat import rmat_graph
from .eulerize import eulerize, eulerian_rmat, largest_component
from .partition import partition_vertices

__all__ = ["rmat_graph", "eulerize", "eulerian_rmat", "largest_component",
           "partition_vertices"]
