"""Gradient capture for debugging, a port of vec_vad_tpu/utils/gradtap.py.

The reference wires `save_grad` backward hooks into FlowNet2's forward to
inspect intermediate gradients (components/misc.py:81-86,
flownet2.py:110-147). `GradTaps.tap` gives the same: wrap any
intermediate tensor and the gradient flowing into it is stored (by name,
as numpy) during the backward pass. A torch.autograd.Function stands in
for the JAX package's custom_vjp + io_callback.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch


class _Tap(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, store: Callable[[torch.Tensor], None]):
        ctx.store = store
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.store(g)
        return g, None


class GradTaps:
    """Collects named intermediate gradients from backward passes."""

    def __init__(self) -> None:
        self.grads: Dict[str, np.ndarray] = {}

    def tap(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """Identity on the forward pass; stores the incoming gradient under
        `name` on the backward pass (bf16 gradients as float32, which numpy
        lacks)."""

        def store(g: torch.Tensor) -> None:
            g = g.detach()
            if g.dtype == torch.bfloat16:
                g = g.float()
            self.grads[name] = g.cpu().numpy()

        return _Tap.apply(x, store)
