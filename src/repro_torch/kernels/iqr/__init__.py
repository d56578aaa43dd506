from .ops import iqr_fences, iqr_fences_plain

__all__ = ["iqr_fences", "iqr_fences_plain"]
