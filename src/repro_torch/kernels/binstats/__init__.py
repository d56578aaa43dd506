from .ops import (binstats, binstats_flat, binstats_flat_plain,
                  binstats_plain)

__all__ = ["binstats", "binstats_flat", "binstats_flat_plain",
           "binstats_plain"]
