from .ops import (bucketize, histbin, histbin_flat, histbin_flat_plain,
                  histbin_plain)

__all__ = ["bucketize", "histbin", "histbin_flat", "histbin_flat_plain",
           "histbin_plain"]
