"""Disk-based pipeline orchestration (vec_vad_tpu/runner.py): the library
equivalent of the reference's `python calc_optical_flow.py`.

Layout conventions match the reference:
  <base>/raw_datasets/<name>/...                 frames + GT
  <base>/optical_flow/<name>/...                 mirrored flow .npy tree

Only calc-flow is ported. Not yet ported from vec_vad_tpu.runner:
`load_split`, `run_train`, `run_test`, `evaluate_frame_scores` and
`run_precompute_boxes` (ROADMAP.md).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from vec_vad_torch.config import PipelineConfig
from vec_vad_torch.data.readers import LazyFrameStack
from vec_vad_torch.data.video_index import VideoIndex
from vec_vad_torch.device import full_f32, resolve_device
from vec_vad_torch.models.flownet import load_flownet_checkpoint, make_flownet2

_FLOW_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dataset_root(cfg: PipelineConfig, base: str) -> str:
    return os.path.join(base, cfg.raw_dataset_dir, cfg.dataset_name)


def run_calc_flow(
    cfg: PipelineConfig,
    base: str,
    checkpoint: Optional[str] = None,
    splits: Tuple[str, ...] = ("train", "test"),
    chunk: Optional[int] = None,
    resident: bool = False,
    segment_frames: Optional[int] = None,
    memory_budget_bytes: float = 4e9,
    max_whole_split_frames: int = 512,
    flow_dtype: str = "float32",
    device="cuda",
) -> None:
    """Precompute the optical-flow tree with FlowNet2
    (calc_optical_flow.py equivalent) on `device`: the card unless the
    caller passes device="cpu". resident=True keeps each split's flow on
    the device until one download (flow.driver.compute_optical_flow).

    Splits whose frames + flow exceed `memory_budget_bytes` (avenue ~19 GB,
    ShanghaiTech ~1.2 TB), or that are longer than
    `max_whole_split_frames`, stream through the segmented path: lazy
    per-segment decode, one upload and one download per segment, each
    frame's .npy written immediately — bounded host and device memory at
    any scale, like the reference's one-frame-at-a-time loop
    (calc_optical_flow.py:25-85). `segment_frames` forces the segmented
    path with that segment size.

    flow_dtype='bfloat16' runs the FlowNet forward in bf16 (.npy output
    stays f32) with the batch default bumped to 8 (chunk=None picks 4 for
    f32, 8 for bf16, as vec_vad_tpu does). Flow values shift by bf16
    rounding; keep float32 where reference parity matters."""
    from vec_vad_torch.flow.driver import (
        compute_optical_flow,
        compute_optical_flow_segmented,
        flow_tree_writer,
        save_flow_tree,
    )

    dev = resolve_device(device)
    dtype = _FLOW_DTYPES[flow_dtype]
    chunk = chunk if chunk is not None else (
        8 if flow_dtype == "bfloat16" else 4
    )
    net = make_flownet2(0, dev)
    if checkpoint:
        report = load_flownet_checkpoint(net, checkpoint)
        print(f"loaded checkpoint: {len(report['matched'])} tensors")
    else:
        print("WARNING: no checkpoint — random-init FlowNet2")

    root = _dataset_root(cfg, base)
    of_root = os.path.join(base, cfg.optical_flow_dir, cfg.dataset_name)
    with full_f32(dtype):  # f32: no TF32 in cuDNN's convolutions
        for split in splits:
            index = VideoIndex.from_layout(
                cfg.dataset_name, root, split, cfg.dataset.file_ext
            )
            lazy = LazyFrameStack(index)
            n = index.total_frames
            # frames (uint8) + flow (2 x f32) for the whole split
            footprint = float(np.prod(lazy.shape)) * (1.0 + 8.0 / lazy.shape[-1])
            if (segment_frames or footprint > memory_budget_bytes
                    or n > max_whole_split_frames):
                seg = segment_frames or min(
                    max_whole_split_frames,
                    max(chunk, int(memory_budget_bytes // (footprint / n)) // 2),
                )
                write = flow_tree_writer(index, of_root, root)
                compute_optical_flow_segmented(
                    net, index, lazy, write, segment_frames=seg, chunk=chunk,
                    compute_dtype=dtype, device=dev,
                )
                print(
                    f"{split}: wrote {n} flow maps to {of_root} "
                    f"(segmented, {seg} frames/segment)"
                )
            else:
                frames = np.asarray(lazy)
                flow = compute_optical_flow(
                    net, index, frames, chunk=chunk, resident=resident,
                    compute_dtype=dtype, device=dev,
                )
                save_flow_tree(flow, index, of_root, root)
                print(f"{split}: wrote {flow.shape[0]} flow maps to {of_root}")
