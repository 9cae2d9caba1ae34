"""Flow-network fine-tuning step in PyTorch (vec_vad_tpu/flow/trainer.py).

Capability parity with the flownet2-pytorch trainer (FlowNet2_src/main.py):
train any FlowNet2-family net on (image-pair, flow) batches with the
multi-scale loss (component nets) or the single-scale L1/L2 loss on the
fused flow (composites), Adam, and the stepped LR schedule. One device:
there is no padding to a mesh, so no sample weights. Nets without
BatchNorm only: a with_bn net is refused, since the JAX package's trainer
cannot train one either.

Where JAX threads a functional train state through a jitted step, the
trainer here holds it: the net's parameters, a torch.optim.Adam and the
count of updates taken. On the card FlowNetC's cost volume runs K1
forward and K2 backward (models/flownet/ops.py).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from vec_vad_torch.device import full_f32, resolve_device
from vec_vad_torch.flow.losses import multiscale_loss, single_scale_loss


class PairMajorAdapter(nn.Module):
    """(B, H, W, 6) dataset batches -> the composites' (B, 2, H, W, 3).

    The flow datasets emit channel-stacked pairs (img0|img1 on the last
    axis) for the component nets; the FlowNet2/CS/CSS composites take
    frame-major input and normalize internally (flownet2.py:66-72). The
    composite is the submodule `inner`, so its state-dict keys nest under
    'inner.' as vec_vad_tpu's params nest under {'inner': ...}."""

    def __init__(self, inner: nn.Module):
        super().__init__()
        self.inner = inner

    def forward(self, pairs, train: bool = False):
        x = torch.stack([pairs[..., :3], pairs[..., 3:]], dim=1)
        return self.inner(x, train)


class FlowTrainer:
    """Flow training for a pyramid-returning net (FlowNetC/S/SD or the
    FlowNet2C/S/SD wrappers, loss='multiscale') or a fused-flow composite
    (loss='single'), on one device."""

    def __init__(
        self,
        net: nn.Module,
        learning_rate: float = 1e-4,
        norm: str = "L1",
        schedule_lr_frequency: int = 0,
        schedule_lr_fraction: float = 10.0,
        loss: str = "multiscale",
        device="cuda",
    ):
        """schedule_lr_frequency/fraction: lr /= fraction every `frequency`
        updates (FlowNet2_src/main.py:47-51), as a function of the number
        of updates taken before this one, which is optax's count: the
        first update uses the base rate. 0 keeps the rate constant.

        loss: 'multiscale' supervises a pyramid-returning net (net called
        with train=True), 'single' a fused full-res flow (train=False, the
        reference's composite recipe, main.py:194-197). `norm` picks L1/L2
        in both modes. The net is moved to `device` (the card unless the
        caller asks for the CPU)."""
        if loss not in ("multiscale", "single"):
            raise ValueError(f"loss must be 'multiscale' or 'single', got {loss!r}")
        if any(isinstance(m, nn.BatchNorm2d) for m in net.modules()):
            raise NotImplementedError(
                "FlowTrainer does not train with_bn nets: vec_vad_tpu's "
                "FlowTrainer applies {'params'} alone (flow/trainer.py:92-110), "
                "so a with_bn net fails there with no batch_stats; neither "
                "package trains one (ROADMAP.md Queue 1 item 5)"
            )
        self.device = resolve_device(device)
        self.net = net.to(self.device)
        self.loss_mode = loss
        self.norm = norm
        self.learning_rate = learning_rate
        self.schedule_lr_frequency = schedule_lr_frequency
        self.schedule_lr_fraction = schedule_lr_fraction
        self.optimizer: Optional[torch.optim.Adam] = None
        self.step_count = 0

    def learning_rate_at(self, count: int) -> float:
        """The rate of the update that follows `count` earlier updates."""
        if not self.schedule_lr_frequency:
            return self.learning_rate
        return self.learning_rate * (1.0 / self.schedule_lr_fraction) ** (
            count // self.schedule_lr_frequency
        )

    def to_device(self, array: np.ndarray) -> torch.Tensor:
        """A host batch as float32 on the trainer's device."""
        return torch.from_numpy(np.asarray(array, np.float32)).to(self.device)

    def loss(self, pairs: torch.Tensor, target: torch.Tensor,
             mode: Optional[str] = None, norm: Optional[str] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loss, epe) of the net on one batch (device tensors), under the
        trainer's loss mode and norm unless given."""
        mode = mode or self.loss_mode
        norm = norm or self.norm
        if mode == "multiscale":
            return multiscale_loss(self.net(pairs, True), target, norm=norm)
        return single_scale_loss(self.net(pairs, False), target, norm=norm)

    def init_state(self, params: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """Start afresh: load `params` (a state dict of the net) when
        given, and a new Adam (beta 0.9/0.999, eps 1e-8, zero moments) at
        update count 0."""
        if params is not None:
            self.net.load_state_dict(params)
        self.optimizer = torch.optim.Adam(
            self.net.parameters(), lr=self.learning_rate_at(0),
            betas=(0.9, 0.999), eps=1e-8,
        )
        self.step_count = 0

    def step(self, pairs, target) -> Dict[str, torch.Tensor]:
        """One Adam update on a host batch: pairs (B, H, W, 6), target
        (B, H, W, 2). Returns {"loss", "epe"} as device scalars (reading
        them synchronises)."""
        if self.optimizer is None:
            self.init_state()
        lr = self.learning_rate_at(self.step_count)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.zero_grad(set_to_none=True)
        with full_f32():  # f32 batches: no TF32 in cuDNN's convolutions
            loss, epe_v = self.loss(self.to_device(pairs), self.to_device(target))
            loss.backward()
        self.optimizer.step()
        self.step_count += 1
        return {"loss": loss.detach(), "epe": epe_v.detach()}

    def state_dict(self) -> dict:
        """Weights, Adam's moments and the update count: what a resumed
        run needs to continue the exact trajectory."""
        if self.optimizer is None:
            self.init_state()
        return {"net": self.net.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "step": self.step_count}

    def load_state_dict(self, state: dict) -> None:
        self.init_state(state["net"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step_count = int(state["step"])
