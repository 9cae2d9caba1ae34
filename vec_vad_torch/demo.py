"""End-to-end demo on a synthetic dataset (no real data needed), the
port's examples/synthetic_e2e.py:

    python -m vec_vad_torch demo               # on the card
    python -m vec_vad_torch demo --device cpu  # on the CPU

Writes a small synthetic tree (moving squares, anomalous ones in every
other test video) with the generator's boxes as the bbox fixtures, then
runs `run_train` and `run_test(save_masks=True)`, the runner the CLI
uses, and prints the frame-level AUROC and a StageTimer report. The tree
is in avenue's layout with .npy frames and .mat pixel GT (read through
scipy), so the demo needs no cv2: the ped layout's .bmp GT cannot be read
without it. The dataset table's avenue entry is swapped for one reading
.npy frames for the run, and put back after.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
from typing import Optional, Tuple

import numpy as np

from vec_vad_torch import config
from vec_vad_torch.config import CompletionConfig, ForegroundConfig, PipelineConfig
from vec_vad_torch.data.synthetic import make_synthetic_dataset
from vec_vad_torch.device import resolve_device
from vec_vad_torch.runtime.profiling import StageTimer

DATASET = "avenue"


def write_tree(root: str, seed: int, frames_per_video: int, n_train_videos: int,
               n_test_videos: int, frame_hw: Tuple[int, int]) -> None:
    """The generator's videos under `root` in avenue's layout
    (training/frames/NN/TTT.npy, testing/frames/NN/TTT.npy), its boxes as
    bboxes_{train,test}_obj_det_with_motion.npy and each test video's
    pixel GT (its anomalous squares) as
    ground_truth_demo/testing_label_mask/<v>_label.mat."""
    import scipy.io

    ds = make_synthetic_dataset(frames_per_video=frames_per_video,
                                n_train_videos=n_train_videos,
                                n_test_videos=n_test_videos, frame_h=frame_hw[0],
                                frame_w=frame_hw[1], seed=seed)
    n = frames_per_video
    gt = os.path.join(root, "ground_truth_demo", "testing_label_mask")
    os.makedirs(gt)
    for split, videos, frames, boxes in (
            ("training", n_train_videos, ds.train_frames, ds.train_boxes),
            ("testing", n_test_videos, ds.test_frames, ds.test_boxes)):
        for v in range(videos):
            d = os.path.join(root, split, "frames", f"{v + 1:02d}")
            os.makedirs(d)
            for t in range(n):
                np.save(os.path.join(d, f"{t:03d}.npy"), frames[v * n + t])
            if split == "testing":
                vol = np.empty((1, n), dtype=object)
                for t in range(n):
                    mask = np.zeros(frame_hw, np.uint8)
                    if ds.test_labels[v * n + t]:  # the frame's last box is anomalous
                        x0, y0, x1, y1 = np.round(boxes[v * n + t][-1]).astype(int)
                        mask[y0:y1, x0:x1] = 1
                    vol[0, t] = mask
                scipy.io.savemat(os.path.join(gt, f"{v + 1}_label.mat"),
                                 {"volLabel": vol}, do_compression=True)
        fixture = np.empty(len(boxes), dtype=object)
        fixture[:] = boxes
        np.save(os.path.join(root, f"bboxes_{split[:-3]}_obj_det_with_motion.npy"),
                fixture, allow_pickle=True)


def main(device="cuda", base: Optional[str] = None, frames_per_video: int = 36,
         n_train_videos: int = 3, n_test_videos: int = 2,
         frame_hw: Tuple[int, int] = (48, 64), patch_size: int = 16, nf: int = 8,
         epochs: int = 8, batch_size: int = 32, seed: int = 3) -> dict:
    """Run the demo on `device`; returns run_test's result dict with
    "timer" (the StageTimer). The workspace is `base`, kept, or a fresh
    temporary directory, deleted after."""
    from vec_vad_torch.runner import run_test, run_train

    dev = resolve_device(device)
    keep = base is not None
    base = base or tempfile.mkdtemp(prefix="vadws_")
    print(f"workspace: {base}")
    previous = config.DATASETS[DATASET]
    config.register_dataset(dataclasses.replace(previous, file_ext=".npy"))
    try:
        timer = StageTimer()
        with timer.stage("write"):
            write_tree(os.path.join(base, "raw_datasets", DATASET), seed,
                       frames_per_video, n_train_videos, n_test_videos, frame_hw)
        cfg = PipelineConfig(
            dataset_name=DATASET,
            fore=ForegroundConfig(patch_size=patch_size, max_boxes_per_frame=8),
            model=CompletionConfig(nf=nf, epochs=epochs, batch_size=batch_size,
                                   context_of_num=0, use_flow=False),
        )
        with timer.stage("train"):
            model, path = run_train(cfg, base, device=dev)
        print(f"trained {len(model.blocks)} block(s) -> {path}")
        with timer.stage("test"):
            res = run_test(cfg, base, model=model, save_masks=True, device=dev)
        print(f"frame-level AUROC: {res['auroc']:.4f}")
        print(timer.report())
    finally:
        config.register_dataset(previous)
        if not keep:
            shutil.rmtree(base, ignore_errors=True)
    res["timer"] = timer
    return res
