"""Data pipelines of the port (mirrors ``repro/data``): the synthetic LM
token stream and its prefetch thread, and the synthetic CTR batches."""
from .lm import Prefetcher, SyntheticLM
from .recsys import SyntheticCTR, batch_to_device

__all__ = ["Prefetcher", "SyntheticCTR", "SyntheticLM", "batch_to_device"]
