"""mmdet Cascade R-CNN checkpoint interop: R101 backbone + FPN neck
(vec_vad_tpu/fore/mmdet_import.py).

The reference's appearance detector is an mmdet CascadeRCNN with a
torchvision-pretrained ResNet-101 backbone and a 5-level FPN neck
(fore_det/inference.py:51-81 loads the checkpoint;
fore_det/obj_det_config/cascade_rcnn_r101_fpn_1x.py:1-27 defines the
graph). The modules here compute that graph in NCHW, and every parameter
and buffer is named as in an mmdet v1 checkpoint
(`backbone.layer3.22.conv2.weight`, `neck.lateral_convs.0.conv.weight`,
...), so loading a checkpoint is selecting its keys (`load_mmdet_state`).

Semantics kept (all load-bearing for numerical parity):

  * "pytorch-style" ResNet (mmdet `style='pytorch'`): the stride-2 conv in
    a bottleneck is the 3x3 `conv2`, not `conv1` (caffe style differs).
  * Inference-mode BatchNorm: mmdet freezes BN at test time, so BN is the
    affine map (x - mean) / sqrt(var + eps) * weight + bias, eps 1e-5, on
    the checkpoint's running statistics (`FrozenBatchNorm`, buffers).
  * Stem max-pool: MaxPool2d(3, stride=2, padding=1), which pads with -inf.
  * FPN (mmdet v1): 1x1 lateral convs WITH bias and no norm/act, top-down
    nearest-neighbour x2 upsample-and-add, 3x3 smoothing convs, and,
    because num_outs=5 exceeds the 4 input levels with add_extra_convs
    off, P6 = max_pool(P5, kernel 1, stride 2).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vec_vad_torch.device import resolve_device

# block counts per stage for the torchvision ResNet depths mmdet supports
RESNET_STAGES: Dict[int, Tuple[int, ...]] = {
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}
BOTTLENECK_EXPANSION = 4


class FrozenBatchNorm(nn.Module):
    """BatchNorm evaluated with stored running statistics, all four held as
    buffers under BatchNorm2d's names (mmdet freezes backbone BN)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        inv = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * inv
        return x * inv[:, None, None] + shift[:, None, None]


def _conv(cin: int, cout: int, k: int, stride: int = 1, bias: bool = False):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=bias)


class Bottleneck(nn.Module):
    """torchvision Bottleneck, pytorch style: 1x1 -> 3x3(stride) -> 1x1,
    identity (or 1x1-conv `downsample`) residual, ReLU after the add."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False):
        super().__init__()
        out_ch = planes * BOTTLENECK_EXPANSION
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = _conv(planes, out_ch, 1)
        self.bn3 = FrozenBatchNorm(out_ch)
        self.downsample = nn.Sequential(
            _conv(inplanes, out_ch, 1, stride), FrozenBatchNorm(out_ch)
        ) if has_downsample else None

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        sc = x if self.downsample is None else self.downsample(x)
        return F.relu(h + sc)


class ResNetBackbone(nn.Module):
    """torchvision-layout ResNet trunk returning C2..C5 (strides 4/8/16/32)
    — mmdet ResNet(depth, out_indices=(0,1,2,3), style='pytorch')."""

    def __init__(self, depth: int = 101):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        inplanes, planes = 64, 64
        for stage, n_blocks in enumerate(RESNET_STAGES[depth]):
            stride = 1 if stage == 0 else 2
            # the first block always re-projects: the channel count changes
            # (64 -> 256 in stage 0, 2x elsewhere) even when stride is 1
            blocks = [Bottleneck(inplanes if b == 0 else planes * BOTTLENECK_EXPANSION,
                                 planes, stride if b == 0 else 1, b == 0)
                      for b in range(n_blocks)]
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
            inplanes, planes = planes * BOTTLENECK_EXPANSION, planes * 2

    def forward(self, x) -> List[torch.Tensor]:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        outs = []
        for i in range(1, 5):
            h = getattr(self, f"layer{i}")(h)
            outs.append(h)
        return outs


class ConvModule(nn.Module):
    """mmdet's ConvModule holder: the conv is stored as `.conv`."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.conv = _conv(cin, cout, k, bias=True)

    def forward(self, x):
        return self.conv(x)


class FPNNeck(nn.Module):
    """mmdet v1 FPN: laterals -> top-down nearest add -> 3x3 smooth ->
    extra stride-2 max-pool levels up to num_outs."""

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5):
        super().__init__()
        self.num_outs = num_outs
        self.lateral_convs = nn.ModuleList(
            [ConvModule(c, out_channels, 1) for c in in_channels])
        self.fpn_convs = nn.ModuleList(
            [ConvModule(out_channels, out_channels, 3) for _ in in_channels])

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        laterals = [m(f) for m, f in zip(self.lateral_convs, feats)]
        for i in range(len(laterals) - 1, 0, -1):
            up = laterals[i].repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            laterals[i - 1] = laterals[i - 1] + up
        outs = [m(lat) for m, lat in zip(self.fpn_convs, laterals)]
        for _ in range(self.num_outs - len(outs)):
            outs.append(F.max_pool2d(outs[-1], 1, stride=2))
        return outs


class BackboneFPN(nn.Module):
    """backbone + neck of cascade_rcnn_r101_fpn_1x (config :6-17): the
    feature extractor every head (RPN + 3 cascade stages) consumes.
    x (B, 3, H, W) normalised RGB -> P2..P6 (B, 256, H/s, W/s)."""

    def __init__(self, depth: int = 101, out_channels: int = 256, num_outs: int = 5):
        super().__init__()
        self.depth = depth
        self.backbone = ResNetBackbone(depth)
        self.neck = FPNNeck(out_channels=out_channels, num_outs=num_outs)

    def forward(self, x) -> List[torch.Tensor]:
        return self.neck(self.backbone(x))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def strip_checkpoint(ckpt) -> Dict[str, np.ndarray]:
    """Accept an mmdet checkpoint in any of its shipped forms: the raw
    state_dict, {'state_dict': ...} (mmcv save_checkpoint), or keys wrapped
    with a DataParallel 'module.' prefix (fore_det/inference.py loads with
    map_location then feeds the model directly)."""
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        out[k] = v
    return out


def infer_depth(sd: Dict) -> int:
    """ResNet depth from a stripped state-dict: the stage-3 block count is
    unique per depth (6 -> 50, 23 -> 101, 36 -> 152)."""
    n3 = 1 + max(int(k.split(".")[2]) for k in sd
                 if k.startswith("backbone.layer3."))
    for depth, counts in RESNET_STAGES.items():
        if counts[2] == n3:
            return depth
    raise ValueError(f"unrecognized backbone: layer3 has {n3} blocks")


def load_mmdet_state(module: nn.Module, ckpt) -> nn.Module:
    """Fill `module` (named like an mmdet checkpoint) from `ckpt` in any
    form strip_checkpoint accepts, as float32. Strict on every key the
    module needs (a missing one is named in the error); the checkpoint's
    other keys (`num_batches_tracked`, heads the module lacks, `meta`) are
    ignored, as the JAX package's converter ignores them."""
    sd = strip_checkpoint(ckpt)
    want = module.state_dict()
    missing = [k for k in want if k not in sd]
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} key(s) the graph needs: "
                       f"{missing[:5]}")
    picked = {}
    for k, ref in want.items():
        v = sd[k]
        v = v.detach() if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
        if tuple(v.shape) != tuple(ref.shape):
            raise ValueError(f"{k}: checkpoint shape {tuple(v.shape)}, graph "
                             f"{tuple(ref.shape)}")
        picked[k] = v.to(torch.float32)
    module.load_state_dict(picked)
    return module


def load_checkpoint_file(path: str):
    """torch.load of an mmdet model-zoo file (zipfile or pickle container),
    on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=False)


def load_backbone_fpn(path: str, depth: int | None = None,
                      device="cuda") -> BackboneFPN:
    """A real mmdet checkpoint file -> BackboneFPN on `device`, in eval
    mode; depth=None reads it from the checkpoint."""
    dev = resolve_device(device)
    ckpt = load_checkpoint_file(path)
    if depth is None:
        depth = infer_depth(strip_checkpoint(ckpt))
    net = load_mmdet_state(BackboneFPN(depth), ckpt)
    return net.to(dev).eval()
