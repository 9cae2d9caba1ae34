"""Reference torch checkpoint -> the port's FlowNet2 family
(vec_vad_tpu/models/flownet/convert.py).

The reference loads FlowNet2_checkpoint.pth.tar with a partial state-dict
merge (calc_optical_flow.py:15-21). Its key layout differs from the port's
only where a conv block wraps its convolution in an nn.Sequential:

  reference key                      port key
  <m>.<conv>.0.{weight,bias}         <m>.<conv>.conv.{weight,bias}
  <m>.deconv*.0.{weight,bias}        <m>.deconv*.conv.{weight,bias}
  <m>.<conv>.1.{weight,bias,         <m>.<conv>.bn.{weight,bias,
    running_mean,running_var}          running_mean,running_var}
  <m>.predict_flow*.{weight,bias}    the same
  <m>.upsampled_flow*.{weight,bias}  the same

The tensor layouts are torch's on both sides (OIHW convolutions, IOHW
transposed convolutions), so values copy as they are. BatchNorm entries
(<m>.<conv>.1.*) load into with_bn nets and are ignored by the
with_bn=False nets, as in vec_vad_tpu's converter. A BatchNorm's
num_batches_tracked is neither read nor written: the reference's files
predate it, and at momentum 0.1 it changes no output.
"""

from __future__ import annotations

import warnings
from typing import Dict, List

import torch
import torch.nn as nn


def reference_key(port_key: str) -> str:
    """The reference checkpoint's key for one of the port's state-dict
    keys."""
    head, _, leaf = port_key.rpartition(".")
    if head.endswith(".conv"):
        head = head[: -len(".conv")] + ".0"
    elif head.endswith(".bn"):
        head = head[: -len(".bn")] + ".1"
    return f"{head}.{leaf}"


def load_flownet_checkpoint(net: nn.Module, path: str) -> Dict[str, List[str]]:
    """Merge a reference `.pth(.tar)` (a `state_dict` entry or a bare state
    dict) into `net` in place, partially: tensors the file lacks keep
    their current values, like vec_vad_tpu's convert_params(strict=False).
    Returns {"matched": reference keys loaded, "missing": reference keys
    of weights and of convolution biases (`<m>.<conv>.0.bias`) the net
    wanted but the file lacks}; a tensor of another shape than the net's
    raises. A with_bn net whose file carries no bias for a convolution
    under a BatchNorm keeps that bias's current (random) values, as
    vec_vad_tpu's converter does, and is warned."""
    # the file comes from outside the program: unpickle tensors, containers
    # and numbers only (the released checkpoints hold nothing else)
    blob = torch.load(path, map_location="cpu", weights_only=True)
    sd = blob["state_dict"] if "state_dict" in blob else blob
    matched, missing = [], []
    with torch.no_grad():
        for key, param in net.state_dict().items():
            if key.endswith(".num_batches_tracked"):
                continue
            ref = reference_key(key)
            if ref not in sd:
                if key.endswith(".weight") or ref.endswith(".0.bias"):
                    missing.append(ref)
                continue
            value = torch.as_tensor(sd[ref])
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(
                    f"{ref}: checkpoint shape {tuple(value.shape)} != "
                    f"{key} {tuple(param.shape)}"
                )
            param.copy_(value)
            matched.append(ref)
    bn_convs = {k[: -len(".bn.weight")] for k in net.state_dict()
                if k.endswith(".bn.weight")}
    unbiased = [reference_key(f"{m}.conv.bias") for m in sorted(bn_convs)
                if reference_key(f"{m}.conv.bias") in missing]
    if unbiased:
        warnings.warn(
            f"{path}: {len(unbiased)} BatchNorm convolutions of this with_bn "
            f"net have no bias in the file (first: {unbiased[0]}); they keep "
            "the net's random initial biases", stacklevel=2)
    return {"matched": matched, "missing": missing}
