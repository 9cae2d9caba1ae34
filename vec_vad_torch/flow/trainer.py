"""Flow-network fine-tuning step in PyTorch (vec_vad_tpu/flow/trainer.py).

Capability parity with the flownet2-pytorch trainer (FlowNet2_src/main.py):
train any FlowNet2-family net on (image-pair, flow) batches with the
multi-scale loss (component nets) or the single-scale L1/L2 loss on the
fused flow (composites), Adam, and the stepped LR schedule. Nets without
BatchNorm only: a with_bn net is refused, since the JAX package's trainer
cannot train one either.

Where JAX threads a functional train state through a jitted step, the
trainer here holds it: the net's parameters, a torch.optim.Adam and the
count of updates taken. On the card FlowNetC's cost volume runs K1
forward and K2 backward (models/flownet/ops.py).

On a device mesh of n > 1 entries (`mesh=`), as JAX's sharded step: the
batch is wrap-padded to a multiple of n (parallel.mesh.pad_to_multiple)
with a 0/1 mask and cut into n shares, each run by a replica of the net on
its entry's device; each replica's loss and EPE are its rows' weighted
sums over the whole batch's weight, ONE backward runs over their sum (on
the first entry), the gradients are summed onto the first replica, Adam
steps there and the parameters are copied out. K1 and K2 run in every
replica at B / n. The nets hold no BatchNorm, so the replicas' forwards
exchange nothing and run one after another.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from vec_vad_torch.device import full_f32, resolve_device
from vec_vad_torch.flow.losses import multiscale_loss, single_scale_loss
from vec_vad_torch.parallel.mesh import (
    as_mesh,
    copy_from_first,
    pad_to_multiple,
    reduce_grads_to_first,
    reduce_to_first,
    replicate,
)


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
    (loss='single'), on one device or over a device mesh."""

    def __init__(
        self,
        net: nn.Module,
        learning_rate: float = 1e-4,
        norm: str = "L1",
        schedule_lr_frequency: int = 0,
        schedule_lr_fraction: float = 10.0,
        loss: str = "multiscale",
        device="cuda",
        mesh=None,
    ):
        """schedule_lr_frequency/fraction: lr /= fraction every `frequency`
        updates (FlowNet2_src/main.py:47-51), as a function of the number
        of updates taken before this one, which is optax's count: the
        first update uses the base rate. 0 keeps the rate constant.

        loss: 'multiscale' supervises a pyramid-returning net (net called
        with train=True), 'single' a fused full-res flow (train=False, the
        reference's composite recipe, main.py:194-197). `norm` picks L1/L2
        in both modes. The net is moved to `device` (the card unless the
        caller asks for the CPU). mesh: a parallel.mesh.Mesh (or a list of
        devices, which may repeat one) to train data-parallel over (module
        docstring); the net then lives on its first entry."""
        if loss not in ("multiscale", "single"):
            raise ValueError(f"loss must be 'multiscale' or 'single', got {loss!r}")
        if any(isinstance(m, nn.BatchNorm2d) for m in net.modules()):
            raise NotImplementedError(
                "FlowTrainer does not train with_bn nets: vec_vad_tpu's "
                "FlowTrainer applies {'params'} alone (flow/trainer.py:92-110), "
                "so a with_bn net fails there with no batch_stats; neither "
                "package trains one (ROADMAP.md Queue 1 item 4, not to be "
                "ported)"
            )
        if mesh is not None:
            mesh = as_mesh(mesh)
            device = mesh.devices[0]
        self.mesh = mesh
        self.device = resolve_device(device)
        self.net = net.to(self.device)
        self._replicas = (replicate(self.net, mesh)
                          if mesh is not None and mesh.size > 1 else [self.net])
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
             mode: Optional[str] = None, norm: Optional[str] = None,
             net: Optional[nn.Module] = None, sample_weight=None,
             weight_total=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loss, epe) of the net (or of `net`, a mesh replica) on one
        batch (device tensors), under the trainer's loss mode and norm
        unless given; sample_weight and weight_total weigh a replica's
        share (flow.losses._batch_mean)."""
        mode = mode or self.loss_mode
        norm = norm or self.norm
        net = net if net is not None else self.net
        kw = dict(norm=norm, sample_weight=sample_weight, weight_total=weight_total)
        if mode == "multiscale":
            return multiscale_loss(net(pairs, True), target, **kw)
        return single_scale_loss(net(pairs, False), target, **kw)

    def init_state(self, params: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """Start afresh: load `params` (a state dict of the net) when
        given, and a new Adam (beta 0.9/0.999, eps 1e-8, zero moments) at
        update count 0."""
        if params is not None:
            self.net.load_state_dict(params)
        copy_from_first(self._replicas)
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
            if len(self._replicas) > 1:
                loss, epe_v = self._mesh_loss(pairs, target)
            else:
                loss, epe_v = self.loss(self.to_device(pairs),
                                        self.to_device(target))
            loss.backward()
        if len(self._replicas) > 1:
            reduce_grads_to_first(self._replicas, self.mesh)
        self.optimizer.step()
        copy_from_first(self._replicas)
        self.step_count += 1
        return {"loss": loss.detach(), "epe": epe_v.detach()}

    def _mesh_loss(self, pairs, target) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loss, epe) of a host batch over the mesh, on the first entry:
        the batch padded to a multiple of the mesh size, one share a
        replica, each share's weighted sums over the whole batch's weight,
        summed in mesh order."""
        mesh = self.mesh
        n = mesh.size
        (pairs, target), mask = pad_to_multiple(
            [np.asarray(pairs), np.asarray(target)], n)
        per, k = [], pairs.shape[0] // n
        total = float(max(mask.sum(), 1.0))
        for i, (net, dev) in enumerate(zip(self._replicas, mesh.devices)):
            rows = slice(i * k, (i + 1) * k)
            w = torch.from_numpy(mask[rows]).to(dev)
            per.append(self.loss(
                torch.from_numpy(np.asarray(pairs[rows], np.float32)).to(dev),
                torch.from_numpy(np.asarray(target[rows], np.float32)).to(dev),
                net=net, sample_weight=w,
                weight_total=torch.tensor(total, device=dev)))
        return (reduce_to_first([p[0] for p in per], mesh),
                reduce_to_first([p[1] for p in per], mesh))

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
