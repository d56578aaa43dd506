from .ops import rolling_stats, rolling_stats_plain

__all__ = ["rolling_stats", "rolling_stats_plain"]
