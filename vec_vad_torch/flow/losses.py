"""Flow training losses in PyTorch (vec_vad_tpu/flow/losses.py; parity
with FlowNet2_src/losses.py).

epe: mean L2 norm of the flow error over pixels.
multiscale_loss: weighted sum over the 5-scale pyramid with avg-pooled,
div_flow-scaled targets (losses.py:46-83): weights 0.32/2^k, pooling
4*2^k (VALID: a ragged edge is dropped), div_flow 0.05.
Flows are NHWC (B, H, W, 2).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def _batch_mean(x: torch.Tensor, sample_weight) -> torch.Tensor:
    """Mean over all elements, or a weighted mean over the batch axis
    (padded duplicate rows get weight 0)."""
    if sample_weight is None:
        return torch.mean(x)
    per = torch.mean(x, dim=tuple(range(1, x.dim())))
    return torch.sum(per * sample_weight) / torch.clamp(
        torch.sum(sample_weight), min=1.0
    )


def epe(pred: torch.Tensor, target: torch.Tensor, sample_weight=None) -> torch.Tensor:
    """Endpoint error: pred/target (B, H, W, 2)."""
    return _batch_mean(
        torch.sqrt(torch.sum(torch.square(target - pred), dim=-1)), sample_weight
    )


def l1_loss(pred: torch.Tensor, target: torch.Tensor, sample_weight=None) -> torch.Tensor:
    return _batch_mean(torch.abs(pred - target), sample_weight)


def l2_loss(pred: torch.Tensor, target: torch.Tensor, sample_weight=None) -> torch.Tensor:
    return epe(pred, target, sample_weight)  # reference "L2" = per-pixel norm mean


def single_scale_loss(
    flow: torch.Tensor, target: torch.Tensor, norm: str = "L1",
    sample_weight=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, epe) pairing one fused full-res flow with the raw target —
    the reference's recipe for the FlowNet2/CS/CSS composites
    (main.py:194-197, losses.py:22-45)."""
    loss_fn = l1_loss if norm == "L1" else l2_loss
    return loss_fn(flow, target, sample_weight), epe(flow, target, sample_weight)


def _avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k average pool, stride k, VALID, on NHWC."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), k, k).permute(0, 2, 3, 1)


def multiscale_loss(
    flow_pyramid: Sequence[torch.Tensor],
    target: torch.Tensor,
    start_scale: int = 4,
    l_weight: float = 0.32,
    norm: str = "L1",
    div_flow: float = 0.05,
    sample_weight=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, epe) over the (flow2..flow6) pyramid vs a full-res target.

    sample_weight: optional (B,) per-sample weights (see _batch_mean)."""
    loss_fn = l1_loss if norm == "L1" else l2_loss
    target = div_flow * target
    loss = 0.0
    epe_v = 0.0
    for i, pred in enumerate(flow_pyramid):
        w = l_weight / (2 ** i)
        t = _avg_pool(target, start_scale * (2 ** i))
        loss = loss + w * loss_fn(pred, t, sample_weight)
        epe_v = epe_v + w * epe(pred, t, sample_weight)
    return loss, epe_v
