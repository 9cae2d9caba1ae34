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


def _batch_mean(x: torch.Tensor, sample_weight, weight_total=None) -> torch.Tensor:
    """Mean over all elements, or a weighted mean over the batch axis
    (padded duplicate rows get weight 0). weight_total: what the weighted
    sum is divided by when the rows are one mesh replica's share of a
    batch (the whole batch's weight, at least 1); default the rows' own."""
    if sample_weight is None:
        return torch.mean(x)
    per = torch.mean(x, dim=tuple(range(1, x.dim())))
    if weight_total is None:
        weight_total = torch.clamp(torch.sum(sample_weight), min=1.0)
    return torch.sum(per * sample_weight) / weight_total


def epe(pred: torch.Tensor, target: torch.Tensor, sample_weight=None,
        weight_total=None) -> torch.Tensor:
    """Endpoint error: pred/target (B, H, W, 2)."""
    return _batch_mean(
        torch.sqrt(torch.sum(torch.square(target - pred), dim=-1)), sample_weight,
        weight_total,
    )


def l1_loss(pred: torch.Tensor, target: torch.Tensor, sample_weight=None,
            weight_total=None) -> torch.Tensor:
    return _batch_mean(torch.abs(pred - target), sample_weight, weight_total)


def l2_loss(pred: torch.Tensor, target: torch.Tensor, sample_weight=None,
            weight_total=None) -> torch.Tensor:
    # reference "L2" = per-pixel norm mean
    return epe(pred, target, sample_weight, weight_total)


def single_scale_loss(
    flow: torch.Tensor, target: torch.Tensor, norm: str = "L1",
    sample_weight=None, weight_total=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, epe) pairing one fused full-res flow with the raw target —
    the reference's recipe for the FlowNet2/CS/CSS composites
    (main.py:194-197, losses.py:22-45)."""
    loss_fn = l1_loss if norm == "L1" else l2_loss
    return (loss_fn(flow, target, sample_weight, weight_total),
            epe(flow, target, sample_weight, weight_total))


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
    weight_total=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, epe) over the (flow2..flow6) pyramid vs a full-res target.

    sample_weight, weight_total: optional (B,) per-sample weights and the
    divisor of their weighted sums (see _batch_mean)."""
    loss_fn = l1_loss if norm == "L1" else l2_loss
    target = div_flow * target
    loss = 0.0
    epe_v = 0.0
    for i, pred in enumerate(flow_pyramid):
        w = l_weight / (2 ** i)
        t = _avg_pool(target, start_scale * (2 ** i))
        loss = loss + w * loss_fn(pred, t, sample_weight, weight_total)
        epe_v = epe_v + w * epe(pred, t, sample_weight, weight_total)
    return loss, epe_v
