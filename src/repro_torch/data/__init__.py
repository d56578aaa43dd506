"""Deterministic restart-safe synthetic data pipeline (numpy), after
``repro/data``."""
from .pipeline import DataConfig, Prefetcher, make_batch

__all__ = ["DataConfig", "Prefetcher", "make_batch"]
