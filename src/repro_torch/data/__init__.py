"""The token pipeline: a seeded synthetic Markov stream or an ``np.memmap``
store, bit-identical to the reference's."""

from .pipeline import DataConfig, TokenPipeline

__all__ = ["DataConfig", "TokenPipeline"]
