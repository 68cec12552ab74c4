"""Data pipeline of the port: the synthetic token stream of
``repro.data`` in numpy, batch for batch."""
from .pipeline import DataConfig, TokenPipeline, make_batch_specs

__all__ = ["DataConfig", "TokenPipeline", "make_batch_specs"]
