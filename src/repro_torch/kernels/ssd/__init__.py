from .ops import ssd_fused, ssd_fused_plain

__all__ = ["ssd_fused", "ssd_fused_plain"]
