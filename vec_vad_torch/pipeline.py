"""End-to-end VAD pipeline: foreground boxes -> cubes -> train -> score
(vec_vad_tpu/pipeline.py), on one device.

  * context windows come from the vectorized index (data.video_index);
  * STC extraction crops and resizes a chunk of frames' padded box sets
    at once on the device (ops.stc), the cubes rounded to uint8;
  * block routing / motion filtering produce a flat CubeSet (the
    static-shape analog of the reference's nested foreground_set lists,
    train.py:103-237, test.py:129-191);
  * training and scoring run block by block (train.trainer.BlockTrainer,
    the reference's sequential loop, train.py:270-296);
  * frame-level scores aggregate by segment max (score.scoring).

Also the trained-model containers serving reads (VadModel, TrainedBlock),
holding torch state dicts in place of flax trees.

Two-stream (use_flow=True) blocks train on the flow cubes beside the raw
ones and fuse w_raw * z(raw) + w_of * z(of) when scored (test.py:330-345);
a two-stream block scoring a split without a flow tree scores its flow
head against zero targets and still fuses, as the JAX package does.

Not ported (ROADMAP.md Queue 1): the parallel GridTrainer and its
multi-block auto-selection (item 2.8), extract_cube_set_resident
(item 2.9) and the device splat of pixel_score_masks (item 2.10).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from vec_vad_torch.config import DatasetSpec, PipelineConfig
from vec_vad_torch.data.video_index import VideoIndex
from vec_vad_torch.device import full_f32, resolve_device
from vec_vad_torch.ops.stc import cube_to_input, extract_stc, flow_magnitude, pad_boxes
from vec_vad_torch.score.scoring import (
    BIG_NUMBER,
    frame_scores_from_cubes,
    fuse_scores,
    splat_score_masks,
)
from vec_vad_torch.utils.blocks import calc_block_idx

BlockKey = Tuple[int, int, int]  # (scene - 1, h cell, w cell)

# (frame, box) crops per STC call: bounds the crop-resize intermediate
# (crops x T x P x W x C floats) to ~180 MB at 240x360
_STC_CROPS = 256


@dataclass
class TrainedBlock:
    """One block's completion weights + its training-score statistics."""

    state_dict: Dict[str, torch.Tensor]
    raw_scores: np.ndarray
    of_scores: Optional[np.ndarray]
    # per-step training losses of the fit that made the block (not saved)
    losses: Optional[np.ndarray] = None

    @property
    def raw_stats(self) -> Tuple[float, float]:
        return float(np.mean(self.raw_scores)), float(np.std(self.raw_scores))

    @property
    def of_stats(self) -> Optional[Tuple[float, float]]:
        if self.of_scores is None:
            return None
        return float(np.mean(self.of_scores)), float(np.std(self.of_scores))


@dataclass
class VadModel:
    """Trained model grid + score statistics (the reference's model_set +
    training_scores_set artifacts, train.py:432-436)."""

    cfg: PipelineConfig
    blocks: Dict[BlockKey, TrainedBlock] = field(default_factory=dict)


@dataclass
class CubeSet:
    """Flat, statically-shaped cube storage for one dataset split.

    One row per (cube, routed block cell) pair — a cube routed to multiple
    cells (block_mode > 1) appears once per cell, mirroring the reference's
    per-cell appends (train.py:183-191)."""

    raw: np.ndarray  # (M, P, P, T*3) uint8
    flow: Optional[np.ndarray]  # (M, P, P, T_of*2) float32
    frame_ids: np.ndarray  # (M,) int64
    boxes: np.ndarray  # (M, 4) float32
    cells: np.ndarray  # (M, 2) int64 (h_cell, w_cell)
    scenes: np.ndarray  # (M,) int64, 1-based

    @property
    def size(self) -> int:
        return self.raw.shape[0]


def extract_cubes(frames_dev: torch.Tensor, windows: torch.Tensor,
                  boxes: torch.Tensor, patch_size: int, quantize: bool):
    """(B,) frame windows of a device frame stack -> channel-stacked cubes.

    frames_dev: (N, H, W, C); windows: (B, T) indices into it (clamped,
    as jnp.take(mode='clip') does); boxes: (B, K, 4). Returns (B, K, P, P,
    T*C): uint8 when `quantize` (the reference's cube storage,
    vad_datasets.py:77-90), else float32 plus the (B, K) motion magnitude
    (train.py:167-178)."""
    windows = windows.clamp(0, frames_dev.shape[0] - 1)
    B, K = boxes.shape[:2]
    step = max(1, _STC_CROPS // max(K, 1))
    cubes, mags = [], []
    for lo in range(0, B, step):
        c = extract_stc(frames_dev[windows[lo: lo + step]], boxes[lo: lo + step],
                        patch_size, quantize=quantize)  # (b, K, T, P, P, C)
        if quantize:
            cubes.append(cube_to_input(c, scale=False).clamp(0, 255).to(torch.uint8))
        else:
            mags.append(flow_magnitude(c))
            cubes.append(cube_to_input(c, scale=False))
    if quantize:
        return torch.cat(cubes)
    return torch.cat(cubes), torch.cat(mags)


def to_device(a, dev: torch.device) -> torch.Tensor:
    """A numpy array (or array-like, e.g. a lazy frame slice) or a tensor,
    as a tensor on `dev` with its dtype kept."""
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a))).to(dev)


def extract_cube_set(
    cfg: PipelineConfig,
    spec: DatasetSpec,
    index: VideoIndex,
    frames: np.ndarray,
    boxes_list: List[np.ndarray],
    flow_frames: Optional[np.ndarray] = None,
    block_mode: Optional[int] = None,
    chunk: int = 128,
    device="cuda",
) -> CubeSet:
    """Run the foreground-extraction stage for a whole split on `device`.

    frames: (N, H, W, C) uint8 (or a lazy on-disk stack); flow_frames:
    (N, H, W, 2) float32 or None; boxes_list: ragged per-frame (K_i, 4)
    arrays (e.g. the shipped bboxes_*.npy fixtures)."""
    dev = resolve_device(device)
    fc = cfg.fore
    mc = cfg.model
    n = index.total_frames
    assert frames.shape[0] == n
    block_mode = block_mode or fc.train_block_mode

    # pad only to this split's real peak box count (rounded up) — the
    # configured capacity is an upper bound, not the working shape
    peak = max((np.asarray(b).reshape(-1, 4).shape[0] for b in boxes_list), default=1)
    k_eff = min(fc.max_boxes_per_frame, max(-(-peak // 8) * 8, 8))
    if peak > fc.max_boxes_per_frame:
        raise ValueError(
            f"a frame has {peak} boxes > max_boxes_per_frame="
            f"{fc.max_boxes_per_frame}"
        )
    boxes_pad, valid = pad_boxes(boxes_list, k_eff)
    raw_windows = index.context_indices(mc.context_frame_num, mc.border_mode)
    if raw_windows.ndim == 1:
        raw_windows = raw_windows[:, None]
    if flow_frames is not None:
        of_windows = index.context_indices(mc.context_of_num, mc.border_mode)
        if of_windows.ndim == 1:
            of_windows = of_windows[:, None]

    h_step = spec.frame_h / fc.h_block
    w_step = spec.frame_w / fc.w_block
    scene_idx = (
        index.scene_idx
        if index.scene_idx is not None
        else np.ones(n, dtype=np.int64)
    )

    raw_rows, flow_rows = [], []
    frame_ids, box_rows, cell_rows, scene_rows = [], [], [], []

    slack = 4 if mc.border_mode == "elastic" else 2
    with torch.no_grad(), full_f32():
        for lo in range(0, n, chunk):
            sel = np.arange(lo, min(lo + chunk, n))
            # Only the frame range this chunk's windows touch goes to the
            # device, so a split never has to be resident at once (`frames`
            # may be a lazy on-disk source). Elastic windows SLIDE (up to
            # 2*ctx each way), so their bound is wider than predict/hard's.
            w = raw_windows[sel]
            span = min(n, chunk + slack * mc.context_frame_num + 1)
            f_lo = max(0, min(int(w.min()), n - span))
            if int(w.max()) >= f_lo + span:  # fail loudly, never clamp silently
                raise AssertionError(
                    f"window span overflow: max index {int(w.max())} outside "
                    f"[{f_lo}, {f_lo + span})"
                )
            box_dev = to_device(boxes_pad[sel], dev)
            raw_cubes = extract_cubes(
                to_device(frames[f_lo: f_lo + span], dev), to_device(w - f_lo, dev),
                box_dev, fc.patch_size, quantize=True,
            ).cpu().numpy()
            if flow_frames is not None:
                ow = of_windows[sel]
                span_of = min(n, chunk + slack * mc.context_of_num + 1)
                o_lo = max(0, min(int(ow.min()), n - span_of))
                if int(ow.max()) >= o_lo + span_of:
                    raise AssertionError(
                        f"flow window span overflow: {int(ow.max())} outside "
                        f"[{o_lo}, {o_lo + span_of})"
                    )
                flow_cubes, mag = extract_cubes(
                    to_device(flow_frames[o_lo: o_lo + span_of], dev),
                    to_device(ow - o_lo, dev), box_dev, fc.patch_size,
                    quantize=False,
                )
                flow_cubes, mag = flow_cubes.cpu().numpy(), mag.cpu().numpy()
            else:
                # no flow modality: motion filter passes everything
                # (train.py:177-178)
                mag = np.full((sel.size, k_eff), 10000.0)

            for j, f in enumerate(sel):
                kmax = int(valid[f].sum())
                for k in range(kmax):
                    if mag[j, k] <= fc.motion_thr:
                        continue
                    b = boxes_pad[f, k]
                    cells = calc_block_idx(
                        b[0], b[2], b[1], b[3], h_step, w_step, block_mode
                    )
                    for cell in cells:
                        raw_rows.append(raw_cubes[j, k])
                        if flow_frames is not None:
                            flow_rows.append(flow_cubes[j, k])
                        frame_ids.append(f)
                        box_rows.append(b)
                        cell_rows.append(cell)
                        scene_rows.append(scene_idx[f])

    if not raw_rows:
        p, t = fc.patch_size, mc.tot_raw_num
        return CubeSet(
            raw=np.zeros((0, p, p, t * 3), np.uint8),
            flow=None if flow_frames is None else np.zeros(
                (0, p, p, mc.tot_of_num * 2), np.float32
            ),
            frame_ids=np.zeros(0, np.int64),
            boxes=np.zeros((0, 4), np.float32),
            cells=np.zeros((0, 2), np.int64),
            scenes=np.zeros(0, np.int64),
        )
    return CubeSet(
        raw=np.stack(raw_rows),  # already uint8 from the device
        flow=np.stack(flow_rows).astype(np.float32) if flow_rows else None,
        frame_ids=np.array(frame_ids, np.int64),
        boxes=np.stack(box_rows).astype(np.float32),
        cells=np.array(cell_rows, np.int64),
        scenes=np.array(scene_rows, np.int64),
    )


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def group_by_block(cubes: CubeSet) -> Dict[BlockKey, np.ndarray]:
    keys = np.stack(
        [cubes.scenes - 1, cubes.cells[:, 0], cubes.cells[:, 1]], axis=1
    )
    out: Dict[BlockKey, np.ndarray] = {}
    if keys.shape[0] == 0:
        return out
    uniq = np.unique(keys, axis=0)
    for row in uniq:
        mask = np.all(keys == row, axis=1)
        out[tuple(int(v) for v in row)] = np.nonzero(mask)[0]
    return out


def make_trainer(cfg: PipelineConfig, device="cuda"):
    from vec_vad_torch.train.trainer import BlockTrainer

    return BlockTrainer(cfg.model, cfg.fore.patch_size, device)


def _refuse_grid(parallel_blocks: Optional[bool]) -> None:
    if parallel_blocks:
        raise NotImplementedError(
            "parallel block training (GridTrainer) is not ported: "
            "ROADMAP.md Queue 1 item 2.8; the port trains blocks in "
            "sequence (parallel_blocks=None or False)"
        )


def train_model(
    cfg: PipelineConfig,
    train_cubes: CubeSet,
    trainer=None,
    seed: int = 0,
    log_every: int = 0,
    parallel_blocks: Optional[bool] = None,
    device="cuda",
) -> VadModel:
    """Train the per-(scene, h, w) block grid, block after block (the
    reference's loop, train.py:270-296) on `device`, or on `trainer`'s
    device when one is given."""
    _refuse_grid(parallel_blocks)
    groups = group_by_block(train_cubes)
    seg = cfg.fore.save_seg_num
    trainer = trainer or make_trainer(cfg, device)
    model = VadModel(cfg=cfg)
    for key, idx in groups.items():
        if idx.size <= 1:
            # the reference skips blocks with < 2 cubes (train.py:370)
            continue
        # uint8 cube storage goes straight to the trainer (scaled on device)
        if idx.size > seg:
            # ShanghaiTech-scale blocks stream in saveSegNum-cube segments
            # per epoch (train.py:138-143,292-296)
            parts = [idx[lo: lo + seg] for lo in range(seg, idx.size, seg)]
            segments = [
                (
                    train_cubes.raw[p],
                    train_cubes.flow[p] if train_cubes.flow is not None else None,
                )
                for p in parts
            ]
            model.blocks[key] = trainer.fit_block(
                train_cubes.raw[idx[:seg]],
                train_cubes.flow[idx[:seg]] if train_cubes.flow is not None else None,
                seed=seed,
                log_every=log_every,
                segments=segments,
            )
        else:
            flow = (
                train_cubes.flow[idx] if train_cubes.flow is not None else None
            )
            model.blocks[key] = trainer.fit_block(
                train_cubes.raw[idx], flow, seed=seed, log_every=log_every
            )
    return model


# ---------------------------------------------------------------------------
# Testing
# ---------------------------------------------------------------------------


def score_cubes(
    model: VadModel,
    test_cubes: CubeSet,
    trainer=None,
    big_number: float = BIG_NUMBER,
    device="cuda",
) -> np.ndarray:
    """Fused, z-normalized anomaly score per test cube (test.py:269-348),
    block after block on `device` (or `trainer`'s)."""
    cfg = model.cfg
    trainer = trainer or make_trainer(cfg, device)
    mc = cfg.model
    scores = np.zeros(test_cubes.size, dtype=np.float64)
    groups = group_by_block(test_cubes)
    for key, idx in groups.items():
        block = model.blocks.get(key)
        if block is None:
            # objects in a block never seen in training -> anomaly
            # (test.py:308-310)
            scores[idx] = big_number
            continue
        flow = test_cubes.flow[idx] if test_cubes.flow is not None else None
        raw_sc, of_sc = trainer.score_block(block, test_cubes.raw[idx], flow)
        use_of = mc.use_flow and block.of_scores is not None
        scores[idx] = fuse_scores(
            raw_sc,
            of_sc if use_of else None,
            block.raw_stats,
            block.of_stats if use_of else None,
            mc.w_raw,
            mc.w_of,
        )
    return scores


def frame_level_scores(
    cube_scores: np.ndarray,
    test_cubes: CubeSet,
    n_frames: int,
    big_number: float = BIG_NUMBER,
) -> np.ndarray:
    return frame_scores_from_cubes(
        cube_scores, test_cubes.frame_ids, n_frames, big_number,
        boxes=test_cubes.boxes,
    )


def pixel_score_masks(
    cube_scores: np.ndarray,
    test_cubes: CubeSet,
    n_frames: int,
    frame_hw: Tuple[int, int],
) -> np.ndarray:
    """Per-frame pixel score masks (test.py:350-358 splat semantics), by
    the host splat."""
    return splat_score_masks(
        cube_scores, test_cubes.boxes, test_cubes.frame_ids, n_frames, frame_hw
    )
