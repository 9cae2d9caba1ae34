"""End-to-end VAD pipeline: foreground boxes -> cubes -> train -> score
(vec_vad_tpu/pipeline.py), on one device.

  * context windows come from the vectorized index (data.video_index);
  * STC extraction crops and resizes a chunk of frames' padded box sets
    at once on the device (ops.stc), the cubes rounded to uint8;
  * block routing / motion filtering produce a flat CubeSet (the
    static-shape analog of the reference's nested foreground_set lists,
    train.py:103-237, test.py:129-191);
  * training and scoring run block by block (train.trainer.BlockTrainer,
    the reference's sequential loop, train.py:270-296), or for a uint8
    multi-block grid with every block folded into one network
    (train.grid_trainer.GridTrainer), routed as the JAX package routes;
  * frame-level scores aggregate by segment max (score.scoring).

Also the trained-model containers serving reads (VadModel, TrainedBlock),
holding torch state dicts in place of flax trees.

Two-stream (use_flow=True) blocks train on the flow cubes beside the raw
ones and fuse w_raw * z(raw) + w_of * z(of) when scored (test.py:330-345);
a two-stream block scoring a split without a flow tree scores its flow
head against zero targets and still fuses, as the JAX package does.

extract_cube_set_resident is the device-resident form of the extraction
(vec_vad_tpu/pipeline.py:254-431): the frame (and flow) stack goes to the
device once and the kept cubes stay there, as tensors in the CubeSet that
train_model and score_cubes read without a host round trip.
pixel_score_masks splats on the host: unlike the JAX package it does
not route large splits to the device splat (score.scoring.
splat_score_masks_device), which was slower than the host's on the H100
at every size measured (PERF.md section 5).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

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
    per-cell appends (train.py:183-191). raw and flow are numpy arrays,
    or tensors on the device for a device-resident set
    (extract_cube_set_resident); the metadata is numpy either way."""

    raw: Union[np.ndarray, torch.Tensor]  # (M, P, P, T*3) uint8
    flow: Optional[Union[np.ndarray, torch.Tensor]]  # (M, P, P, T_of*2) float32
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

    k_eff = _k_eff(fc, boxes_list)
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
        return _empty_cube_set(cfg, flow_frames is not None)
    return CubeSet(
        raw=np.stack(raw_rows),  # already uint8 from the device
        flow=np.stack(flow_rows).astype(np.float32) if flow_rows else None,
        frame_ids=np.array(frame_ids, np.int64),
        boxes=np.stack(box_rows).astype(np.float32),
        cells=np.array(cell_rows, np.int64),
        scenes=np.array(scene_rows, np.int64),
    )


def _k_eff(fc, boxes_list) -> int:
    """The split's padded box count: its real peak rounded up to 8, at
    most the configured capacity (an upper bound, not the working shape)."""
    peak = max((np.asarray(b).reshape(-1, 4).shape[0] for b in boxes_list), default=1)
    if peak > fc.max_boxes_per_frame:
        raise ValueError(
            f"a frame has {peak} boxes > max_boxes_per_frame="
            f"{fc.max_boxes_per_frame}"
        )
    return min(fc.max_boxes_per_frame, max(-(-peak // 8) * 8, 8))


def _whole_stack(a):
    """A frame or flow source as one array or tensor: lazy stacks are read
    whole through a slice (a LazyFlowStack has no __array__)."""
    if isinstance(a, (np.ndarray, torch.Tensor)):
        return a
    return a[0: a.shape[0]]


def extract_cube_set_resident(
    cfg: PipelineConfig,
    spec: DatasetSpec,
    index: VideoIndex,
    frames,
    boxes_list: List[np.ndarray],
    flow_frames=None,
    block_mode: Optional[int] = None,
    chunk: int = 32,
    device="cuda",
) -> CubeSet:
    """Device-resident extraction (vec_vad_tpu/pipeline.py:254-431): the
    same CubeSet as extract_cube_set, with raw (and flow) as tensors on
    `device`.

      * the frame stack (numpy, a lazy stack or a tensor already on the
        device) goes up once, and every padded (frame, box) cube is cut,
        chunk by chunk, into one uint8 buffer on the device; with flow,
        every float32 flow cube and its motion magnitude into two more;
      * the motion filter and the block routing run on host metadata only
        (the boxes and the (N, K) magnitudes);
      * one clamped gather compacts the kept rows, still on the device.

    An empty result is the numpy CubeSet extract_cube_set returns."""
    dev = resolve_device(device)
    fc = cfg.fore
    mc = cfg.model
    n = index.total_frames
    # a mismatch would otherwise surface as a clamped gather (the last
    # frame duplicated), as in the JAX package
    if frames.shape[0] != n or len(boxes_list) != n:
        raise ValueError(
            f"frames ({frames.shape[0]}) and boxes ({len(boxes_list)}) must both "
            f"hold index.total_frames ({n}) entries"
        )
    block_mode = block_mode or fc.train_block_mode
    k_eff = _k_eff(fc, boxes_list)
    boxes_pad, valid = pad_boxes(boxes_list, k_eff)
    windows = index.context_indices(mc.context_frame_num, mc.border_mode)
    P = fc.patch_size

    with torch.no_grad(), full_f32():
        frames_dev = to_device(_whole_stack(frames), dev)
        win_dev = torch.as_tensor(windows.reshape(n, -1), device=dev)
        box_dev = torch.as_tensor(boxes_pad, device=dev)
        cube_buf = torch.empty((n, k_eff, P, P, win_dev.shape[1] * frames_dev.shape[-1]),
                               dtype=torch.uint8, device=dev)
        for lo in range(0, n, chunk):
            cube_buf[lo: lo + chunk] = extract_cubes(
                frames_dev, win_dev[lo: lo + chunk], box_dev[lo: lo + chunk], P,
                quantize=True)
        del frames_dev
        cube_buf = cube_buf.reshape((n * k_eff,) + cube_buf.shape[2:])
        flow_buf = None
        if flow_frames is not None:
            of_windows = index.context_indices(mc.context_of_num, mc.border_mode)
            ow_dev = torch.as_tensor(of_windows.reshape(n, -1), device=dev)
            flow_dev = to_device(_whole_stack(flow_frames), dev)
            flow_buf = torch.empty((n, k_eff, P, P, ow_dev.shape[1] * flow_dev.shape[-1]),
                                   device=dev)
            mag = torch.empty((n, k_eff), device=dev)
            for lo in range(0, n, chunk):
                flow_buf[lo: lo + chunk], mag[lo: lo + chunk] = extract_cubes(
                    flow_dev, ow_dev[lo: lo + chunk], box_dev[lo: lo + chunk], P,
                    quantize=False)
            del flow_dev
            flow_buf = flow_buf.reshape((n * k_eff,) + flow_buf.shape[2:])
            mag_host = mag.cpu().numpy()
        else:
            # no flow modality: the motion filter passes everything
            # (train.py:177-178)
            mag_host = np.full((n, k_eff), 10000.0)

    # host: validity, motion filter and block routing on metadata only
    h_step = spec.frame_h / fc.h_block
    w_step = spec.frame_w / fc.w_block
    scene_idx = (
        index.scene_idx
        if index.scene_idx is not None
        else np.ones(n, dtype=np.int64)
    )
    flat_rows, frame_ids, box_rows, cell_rows, scene_rows = [], [], [], [], []
    for f, k in zip(*np.nonzero(valid)):
        if mag_host[f, k] <= fc.motion_thr:
            continue
        b = boxes_pad[f, k]
        for cell in calc_block_idx(b[0], b[2], b[1], b[3], h_step, w_step, block_mode):
            flat_rows.append(f * k_eff + k)
            frame_ids.append(f)
            box_rows.append(b)
            cell_rows.append(cell)
            scene_rows.append(scene_idx[f])

    if not flat_rows:
        return _empty_cube_set(cfg, flow_frames is not None)
    flat = torch.as_tensor(np.asarray(flat_rows, np.int64), device=dev)
    flat = flat.clamp(0, n * k_eff - 1)
    return CubeSet(
        raw=cube_buf.index_select(0, flat),
        flow=None if flow_buf is None else flow_buf.index_select(0, flat),
        frame_ids=np.array(frame_ids, np.int64),
        boxes=np.stack(box_rows).astype(np.float32),
        cells=np.array(cell_rows, np.int64),
        scenes=np.array(scene_rows, np.int64),
    )


def _empty_cube_set(cfg: PipelineConfig, with_flow: bool) -> CubeSet:
    p, t = cfg.fore.patch_size, cfg.model.tot_raw_num
    return CubeSet(
        raw=np.zeros((0, p, p, t * 3), np.uint8),
        flow=np.zeros((0, p, p, cfg.model.tot_of_num * 2), np.float32)
        if with_flow else None,
        frame_ids=np.zeros(0, np.int64),
        boxes=np.zeros((0, 4), np.float32),
        cells=np.zeros((0, 2), np.int64),
        scenes=np.zeros(0, np.int64),
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


def _rows(a, idx: np.ndarray):
    """Rows `idx` of cube storage: numpy indexing, or an index_select that
    keeps a device-resident tensor on its device. None stays None."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a.index_select(0, torch.as_tensor(idx, device=a.device))
    return a[idx]


def make_trainer(cfg: PipelineConfig, mesh=None, device="cuda"):
    """The BlockTrainer of `cfg` over `mesh` (a parallel.mesh.Mesh or a
    list of devices), by default every visible card for device="cuda"
    (parallel.mesh.get_mesh, as vec_vad_tpu's make_trainer takes every
    device): one card on a machine with one, the CPU only when asked."""
    from vec_vad_torch.parallel.mesh import get_mesh
    from vec_vad_torch.train.trainer import BlockTrainer

    mesh = mesh if mesh is not None else get_mesh(device=device)
    return BlockTrainer(cfg.model, cfg.fore.patch_size, mesh=mesh)


def _grid_trainer(cfg: PipelineConfig, trainer):
    """The grid trainer on `trainer`'s device and mesh."""
    from vec_vad_torch.train.grid_trainer import GridTrainer

    return GridTrainer(cfg.model, cfg.fore.patch_size, trainer.device,
                       mesh=trainer.mesh)


def _is_uint8(a) -> bool:
    if isinstance(a, torch.Tensor):
        return a.dtype == torch.uint8
    return a.dtype == np.uint8


def train_model(
    cfg: PipelineConfig,
    train_cubes: CubeSet,
    trainer=None,
    seed: int = 0,
    log_every: int = 0,
    parallel_blocks: Optional[bool] = None,
    device="cuda",
) -> VadModel:
    """Train the per-(scene, h, w) block grid on `device`, or on
    `trainer`'s device when one is given.

    parallel_blocks: train every eligible block (more than one cube)
    together, folded into one network (GridTrainer), instead of block
    after block (the reference's loop, train.py:270-296). Default: as the
    JAX package selects (vec_vad_tpu/pipeline.py:483-493), the grid
    exactly when the cubes are uint8 (float cubes would be quantised and
    shift the training-score statistics), more than one block is eligible
    and none needs segment streaming."""
    groups = group_by_block(train_cubes)
    seg = cfg.fore.save_seg_num
    eligible = {k: v for k, v in groups.items() if v.size > 1}
    if parallel_blocks is None:
        parallel_blocks = (
            _is_uint8(train_cubes.raw)
            and len(eligible) > 1
            and all(v.size <= seg for v in eligible.values())
        )
    trainer = trainer or make_trainer(cfg, device=device)
    model = VadModel(cfg=cfg)
    if parallel_blocks and eligible:
        block_data = [(key, _rows(train_cubes.raw, idx), _rows(train_cubes.flow, idx))
                      for key, idx in eligible.items()]
        model.blocks = _grid_trainer(cfg, trainer).fit_blocks(
            block_data, seed=seed, log_every=log_every)
        return model
    for key, idx in groups.items():
        if idx.size <= 1:
            # the reference skips blocks with < 2 cubes (train.py:370)
            continue
        # uint8 cube storage goes straight to the trainer (scaled on device)
        if idx.size > seg:
            # ShanghaiTech-scale blocks stream in saveSegNum-cube segments
            # per epoch (train.py:138-143,292-296)
            parts = [idx[lo: lo + seg] for lo in range(seg, idx.size, seg)]
            segments = [(_rows(train_cubes.raw, p), _rows(train_cubes.flow, p))
                        for p in parts]
            model.blocks[key] = trainer.fit_block(
                _rows(train_cubes.raw, idx[:seg]),
                _rows(train_cubes.flow, idx[:seg]),
                seed=seed,
                log_every=log_every,
                segments=segments,
            )
        else:
            model.blocks[key] = trainer.fit_block(
                _rows(train_cubes.raw, idx), _rows(train_cubes.flow, idx),
                seed=seed, log_every=log_every,
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
    """Fused, z-normalized anomaly score per test cube (test.py:269-348)
    on `device` (or `trainer`'s): block after block, or, for more than one
    trained block and uint8 cubes, every block folded into one forward per
    batch (GridTrainer.score_blocks), as the JAX package routes
    (vec_vad_tpu/pipeline.py:579-604)."""
    cfg = model.cfg
    trainer = trainer or make_trainer(cfg, device=device)
    mc = cfg.model
    scores = np.zeros(test_cubes.size, dtype=np.float64)
    groups = group_by_block(test_cubes)
    trained = {k: v for k, v in groups.items() if model.blocks.get(k) is not None}
    for key, idx in groups.items():
        if key not in trained:
            # objects in a block never seen in training -> anomaly
            # (test.py:308-310)
            scores[idx] = big_number
    if len(trained) > 1 and _is_uint8(test_cubes.raw):
        per_block = _grid_trainer(cfg, trainer).score_blocks(model.blocks, [
            (key, _rows(test_cubes.raw, idx), _rows(test_cubes.flow, idx))
            for key, idx in trained.items()])
    else:
        per_block = {key: trainer.score_block(model.blocks[key],
                                              _rows(test_cubes.raw, idx),
                                              _rows(test_cubes.flow, idx))
                     for key, idx in trained.items()}
    for key, idx in trained.items():
        block = model.blocks[key]
        raw_sc, of_sc = per_block[key]
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
    """Per-frame pixel score masks (test.py:350-358 splat semantics), on
    the host (module docstring)."""
    return splat_score_masks(
        cube_scores, test_cubes.boxes, test_cubes.frame_ids, n_frames, frame_hw
    )
