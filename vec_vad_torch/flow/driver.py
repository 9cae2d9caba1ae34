"""The optical-flow driver's resize protocol and weight cast
(vec_vad_tpu/flow/driver.py:32-41,159-171).

Frames resize to the FlowNet2 protocol size (384x512 by default) with a
cv2-parity bilinear resample, and the flow resizes back WITHOUT magnitude
rescaling (the reference's calc_optical_flow.py quirk). The batched
calc-flow driver itself is not ported yet.
"""

from __future__ import annotations

import copy

import torch
import torch.nn as nn

from vec_vad_torch.ops.stc import _interp_matrix


def resize_bilinear(frames: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """cv2.resize-parity bilinear resize of a full (B, H, W, C) stack,
    returned as float32."""
    B, H, W, C = frames.shape
    dev = frames.device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    my = _interp_matrix(zero, zero + H, H, out_h)
    mx = _interp_matrix(zero, zero + W, W, out_w)
    rows = torch.einsum("ph,bhwc->bpwc", my, frames.float())
    return torch.einsum("bpwc,qw->bpqc", rows, mx)


def cast_flow_net(net: nn.Module, compute_dtype) -> nn.Module:
    """`net` itself for float32; otherwise a copy with its float weights
    cast to `compute_dtype` once (halves weight residency for bf16). A
    copy, so scorers sharing one net keep their own precision."""
    if compute_dtype == torch.float32:
        return net
    return copy.deepcopy(net).to(compute_dtype)
