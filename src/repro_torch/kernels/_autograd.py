"""The backward shared by the kernels' ``torch.autograd.Function``s.

The reference's Pallas kernels are forward only, and its training
differentiates the XLA formulations that the plain versions copy. So a
kernel's ``Function`` runs the kernel forward and, in backward, recomputes
the plain version from the saved inputs and differentiates that."""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch


def recompute_grads(outs: Sequence[torch.Tensor],
                    grads: Sequence[Optional[torch.Tensor]],
                    inputs: Sequence[torch.Tensor],
                    ) -> List[Optional[torch.Tensor]]:
    """Gradients of the recomputed ``outs`` given their incoming
    ``grads`` (None where an output was not used), for each of ``inputs``
    that requires grad, and None for the others."""
    pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
    wanted = [t for t in inputs if t.requires_grad]
    if not pairs or not wanted:
        return [None] * len(inputs)
    got = iter(torch.autograd.grad([o for o, _ in pairs], wanted,
                                   [g for _, g in pairs], allow_unused=True))
    return [next(got) if t.requires_grad else None for t in inputs]
