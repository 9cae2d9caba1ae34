"""Flow fine-tuning harness in PyTorch (vec_vad_tpu/flow/harness.py):
epoch and validation loop with resume and best-checkpoint tracking.

Capability parity with the reference's flownet2-pytorch trainer
(FlowNet2_src/main.py): the epoch loop with per-epoch validation
(main.py:592-634), best-EPE tracking and checkpoint + model_best saving
(main.py:629-644), `--resume` restoring weights, optimizer state, epoch
counter and best error (main.py:341-350), and the iteration-based LR
decay schedule (main.py:47-51).

A checkpoint is `torch.save` of the trainer's state (net weights, Adam's
moments, update count), so a resumed run continues the exact trajectory;
`meta.json` holds the epoch and best EPE. vec_vad_tpu's msgpack
checkpoints are not read here (they need flax).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from vec_vad_torch.device import full_f32
from vec_vad_torch.flow.trainer import FlowTrainer
from vec_vad_torch.models.flownet.ops import upsample_bilinear


@dataclass
class FitResult:
    best_epe: float
    history: List[Dict] = field(default_factory=list)


class FlowHarness:
    """Epoch loop + validation + resumable checkpoints around FlowTrainer."""

    CKPT = "checkpoint.pt"
    BEST = "model_best.pt"
    META = "meta.json"

    def __init__(self, trainer: FlowTrainer, workdir: str, norm: str = "L1",
                 loss: Optional[str] = None):
        """loss: 'multiscale' | 'single' — defaults to the trainer's mode
        so validation scores the same objective training optimizes."""
        loss = loss or trainer.loss_mode
        if loss not in ("multiscale", "single"):
            raise ValueError(f"loss must be 'multiscale' or 'single', got {loss!r}")
        self.trainer = trainer
        self.workdir = workdir  # created lazily on first checkpoint write
        self.norm = norm
        self.loss_mode = loss

    # -- checkpointing ------------------------------------------------------

    def save_checkpoint(self, epoch: int, best_epe: float, is_best: bool) -> None:
        """checkpoint.pt + meta.json each epoch; model_best.pt on
        improvement (tools.save_checkpoint semantics, main.py:636-644)."""
        os.makedirs(self.workdir, exist_ok=True)
        state = self.trainer.state_dict()
        torch.save(state, os.path.join(self.workdir, self.CKPT))
        with open(os.path.join(self.workdir, self.META), "w") as f:
            json.dump({"epoch": epoch, "best_epe": float(best_epe)}, f)
        if is_best:
            torch.save(state, os.path.join(self.workdir, self.BEST))

    def load_checkpoint(self, best: bool = False) -> Optional[tuple]:
        """Restore the trainer from the workdir: (epoch, best_epe), or
        None when no checkpoint exists."""
        path = os.path.join(self.workdir, self.BEST if best else self.CKPT)
        meta_path = os.path.join(self.workdir, self.META)
        if not (os.path.exists(path) and os.path.exists(meta_path)):
            return None
        self.trainer.load_state_dict(
            torch.load(path, map_location=self.trainer.device, weights_only=True)
        )
        with open(meta_path) as f:
            meta = json.load(f)
        return int(meta["epoch"]), float(meta["best_epe"])

    # -- validation ---------------------------------------------------------

    @torch.no_grad()
    def validate(self, dataset, batch_size: int) -> float:
        """Mean EPE of the validation objective over the set, weighted by
        batch size (main.py:394-516 is_validate branch)."""
        tr = self.trainer
        tot, n = 0.0, 0
        with full_f32():  # f32 nets: no TF32 in cuDNN's convolutions
            for pairs, target in dataset.batches(batch_size, shuffle=False):
                _, epe_v = tr.loss(tr.to_device(pairs), tr.to_device(target),
                                   mode=self.loss_mode, norm=self.norm)
                b = pairs.shape[0]
                tot += float(epe_v) * b
                n += b
        return tot / max(n, 1)

    # -- inference mode -----------------------------------------------------

    @torch.no_grad()
    def infer(self, dataset, batch_size: int, save_dir: Optional[str] = None,
              n_batches: int = -1) -> Dict:
        """Run the net full-res over a flow dataset; optionally save each
        prediction as `%06d.flo`; report mean EPE (the reference's
        --inference mode, main.py:87-100,524-589). Datasets without ground
        truth load all-zero targets, making 'EPE' the mean flow norm.

        A pyramid-returning net's full-res flow is
        upsample4(flow2 * div_flow), bilinear with align_corners (the
        reference wrappers' eval path, flownet2.py:170-172). A short final
        batch is padded with its last sample to batch_size and the
        predictions sliced back, as in vec_vad_tpu.
        Returns {'epe': float, 'n': int, 'flows': dir}."""
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            from vec_vad_torch.utils.flowviz import write_flo
        net, tr = self.trainer.net, self.trainer
        tot, n = 0.0, 0
        for bi, (pairs, target) in enumerate(
            dataset.batches(batch_size, shuffle=False)
        ):
            if n_batches >= 0 and bi >= n_batches:
                break
            b = pairs.shape[0]
            if b < batch_size:
                pairs = np.concatenate(
                    [pairs, np.repeat(pairs[-1:], batch_size - b, axis=0)]
                )
            with full_f32():  # f32 nets: no TF32 in cuDNN's convolutions
                out = net(tr.to_device(pairs), False)
            if isinstance(out, (tuple, list)):
                out = upsample_bilinear(
                    out[0] * getattr(net, "div_flow", 20.0), 4, True
                )
            flow = out[:b].float().cpu().numpy()
            per = np.sqrt(np.sum((flow - target) ** 2, axis=-1)).mean(axis=(1, 2))
            tot += float(per.sum())
            if save_dir:
                for i in range(flow.shape[0]):
                    write_flo(os.path.join(save_dir, f"{n + i:06d}.flo"), flow[i])
            n += flow.shape[0]
        return {"epe": tot / max(n, 1), "n": n, "flows": save_dir}

    # -- the epoch loop -----------------------------------------------------

    def fit(
        self,
        train_dataset,
        val_dataset,
        total_epochs: int,
        batch_size: int,
        seed: int = 0,
        resume: bool = True,
        log: bool = False,
        init_params: Optional[Dict[str, torch.Tensor]] = None,
    ) -> FitResult:
        """Train to total_epochs, validating each epoch; resumes from
        <workdir>/checkpoint.pt when present and resume=True.

        Epoch e shuffles with seed + e. Training starts from the net's
        current weights (build it with its seeded init), or from
        init_params (a state dict: fine-tuning a converted checkpoint, the
        reference's --resume-from-pretrained path) with a fresh Adam; a
        workdir checkpoint still wins when resume=True."""
        self.trainer.init_state(init_params)
        start_epoch, best_epe = 1, float("inf")
        if resume:
            loaded = self.load_checkpoint()
            if loaded is not None:
                last_epoch, best_epe = loaded
                start_epoch = last_epoch + 1
                if log:
                    print(f"resumed epoch {last_epoch} (best EPE {best_epe:.4f})")

        history: List[Dict] = []
        for epoch in range(start_epoch, total_epochs + 1):
            losses = []
            for pairs, target in train_dataset.batches(
                batch_size, shuffle=True, seed=seed + epoch
            ):
                losses.append(self.trainer.step(pairs, target)["loss"])
            losses = [float(v) for v in losses]
            val_epe = self.validate(val_dataset, batch_size)
            is_best = val_epe < best_epe
            best_epe = min(best_epe, val_epe)
            self.save_checkpoint(epoch, best_epe, is_best)
            history.append({
                "epoch": epoch,
                "train_loss": float(np.mean(losses)) if losses else None,
                "val_epe": val_epe,
                "is_best": is_best,
            })
            if log:
                print(
                    f"epoch {epoch}: loss {history[-1]['train_loss']:.5f} "
                    f"val EPE {val_epe:.5f}{' *' if is_best else ''}"
                )
        return FitResult(best_epe=best_epe, history=history)
