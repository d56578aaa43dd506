"""Serving: the batched greedy engine (the reference's query service and
stream ingest are ROADMAP Queue 1 items)."""

from .engine import ServeConfig, ServeEngine

__all__ = ["ServeConfig", "ServeEngine"]
