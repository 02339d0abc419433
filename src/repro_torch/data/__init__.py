"""Data pipelines of the port (mirrors ``repro/data``): the synthetic LM
token stream and its prefetch thread."""
from .lm import Prefetcher, SyntheticLM

__all__ = ["Prefetcher", "SyntheticLM"]
