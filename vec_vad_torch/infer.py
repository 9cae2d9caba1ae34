"""Whole-split scoring (vec_vad_tpu/infer.py): the resident form the JAX
package's bench times, its segmented form for splits larger than the
device, and the memory-budget routing between them.

`infer_frame_scores_resident` (vec_vad_tpu/infer.py:81-186):

  phase A: every padded (frame, box) cube of the split is cut from the
           uploaded frame stack, chunk by chunk, into ONE device-resident
           uint8 buffer; with flow, every padded flow cube (float32,
           never quantised) and its motion magnitude into two more;
  phase B: the valid (frame, box) rows — known on the host from the
           validity mask — are gathered from them in batches of
           `cube_batch` (the last one partial: unlike XLA, torch needs no
           fixed shape, so no padded rows are scored) and run through the
           completion ensemble, with the per-cube squared errors
           z-normalised and fused on the device,
           w_raw * (raw - mu_r) / sd_r + w_of * (of - mu_o) / sd_o;
  host:    motion filter (mag > motion_thr, with flow), degenerate-splat
           filter and segment max into frame scores.

`infer_frame_scores_segmented` (:189-254) runs it over segments of the
frame axis, each uploading only the frame and flow range its windows
reference; `infer_frame_scores` (:399-475) routes by a memory budget
between one segment and several.

Every gather clamps its indices, as jnp.take(mode='clip') does.
`compute_dtype` (a torch dtype or its name) casts as the JAX package
does: the gathered cubes to the dtype before the 1/255 scale, the weights
(running statistics included) to the dtype, the errors back to f32
before their sums. These are single-block (h_block == w_block == 1)
forms. `infer_frame_scores_grid` (:257-322) scores a multi-block model on
an extracted CubeSet, every trained block folded into one forward per
batch (train.grid_trainer.GridTrainer.score_blocks).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from vec_vad_torch.config import PipelineConfig
from vec_vad_torch.device import full_f32, resolve_device, resolve_dtype
from vec_vad_torch.models.completion import SelfCompletionNet, make_completion_net
from vec_vad_torch.pipeline import extract_cubes, to_device
from vec_vad_torch.score.scoring import BIG_NUMBER, degenerate_boxes


def _forward_fn(net: SelfCompletionNet, state_dict, dtype: torch.dtype):
    """net's eval forward under `state_dict` in `dtype`: the net itself
    (weights loaded) in f32, else functional_call over the weights and
    running statistics cast to dtype."""
    if dtype == torch.float32:
        net.load_state_dict(state_dict)
        return net
    dev = next(net.parameters()).device
    cast = {k: v.to(dev, dtype) for k, v in state_dict.items()}
    return lambda x, x_of: functional_call(net, cast, (x, x_of))


def _fused_scores(out, mc, stats, use_flow: bool) -> torch.Tensor:
    """w_raw * z(raw) (+ w_of * z(of)) per cube, the errors in f32."""
    mu_r, sd_r, mu_o, sd_o = stats
    sc = (out.raw_out - out.raw_tgt).float().square().sum(dim=(0, 2, 3, 4))
    score = mc.w_raw * (sc - mu_r) / sd_r
    if use_flow and out.of_out is not None:
        osc = (out.of_out - out.of_tgt).float().square().sum(dim=(0, 2, 3, 4))
        score = score + mc.w_of * (osc - mu_o) / sd_o
    return score


def infer_frame_scores_resident(
    cfg: PipelineConfig,
    state_dict: Dict[str, torch.Tensor],
    stats: Tuple[float, float, float, float],
    frames,
    windows: np.ndarray,
    boxes_pad: np.ndarray,
    valid: np.ndarray,
    flow: Optional[np.ndarray] = None,
    of_windows: Optional[np.ndarray] = None,
    chunk: int = 128,
    cube_batch: int = 2048,
    net: Optional[SelfCompletionNet] = None,
    big_number: float = BIG_NUMBER,
    compute_dtype=torch.float32,
    device="cuda",
) -> np.ndarray:
    """Frame scores of a split from one block's weights.

    state_dict: the block's weights (TrainedBlock.state_dict); stats:
    (mu_r, sd_r, mu_o, sd_o), the training-score statistics; frames:
    (N, H, W, C) uint8, numpy or already a tensor on `device` (upload
    once, score many times); windows: (N, T) context indices;
    boxes_pad/valid: (N, K, 4) padded boxes and their (N, K) mask
    (ops.stc.pad_boxes); flow: (N, H, W, 2) float32 maps (numpy or already
    a tensor on `device`) with of_windows (N, T_of), fused only when the
    config uses flow (a two-stream model without them scores its
    raw stream alone, its flow head fed zeros). `net` reuses a built net
    (its weights are replaced by `state_dict`); compute_dtype: the
    forward's dtype (module docstring), f32 unless asked, whatever dtype
    the model was trained in. Returns (N,) float32, -big_number for a
    frame with no scoring box."""
    mc = cfg.model
    dev = resolve_device(device)
    dtype = resolve_dtype(compute_dtype)
    P = cfg.fore.patch_size
    n, K = valid.shape
    use_flow = mc.use_flow and flow is not None

    # -- host-side flat index set --------------------------------------
    fid, bid = np.nonzero(valid)
    m = fid.size
    flat = fid * K + bid

    if net is None:
        net = make_completion_net(mc, dev)
    forward = _forward_fn(net, state_dict, dtype)

    frames_dev = to_device(frames, dev)
    windows = np.asarray(windows, np.int64).reshape(n, -1)
    win_dev = torch.as_tensor(windows, device=dev)
    box_dev = torch.as_tensor(np.asarray(boxes_pad, np.float32), device=dev)
    idx_dev = torch.as_tensor(flat, device=dev).clamp(0, n * K - 1)
    stats_dev = tuple(torch.tensor(float(s), device=dev) for s in stats)

    with torch.no_grad(), full_f32(dtype):
        # -- phase A: every padded cube into one device buffer ----------
        cube_buf = torch.empty((n, K, P, P, windows.shape[1] * frames_dev.shape[-1]),
                               dtype=torch.uint8, device=dev)
        for lo in range(0, n, chunk):
            cube_buf[lo: lo + chunk] = extract_cubes(
                frames_dev, win_dev[lo: lo + chunk], box_dev[lo: lo + chunk],
                P, quantize=True)
        cube_buf = cube_buf.reshape((n * K,) + cube_buf.shape[2:])
        n_of = net.tot_of_num * net.of_channels
        if use_flow:
            flow_dev = to_device(flow, dev)
            ow_dev = torch.as_tensor(np.asarray(of_windows, np.int64).reshape(n, -1),
                                     device=dev)
            flow_buf = torch.empty((n, K, P, P, n_of), device=dev)
            mag = torch.empty((n, K), device=dev)
            for lo in range(0, n, chunk):
                flow_buf[lo: lo + chunk], mag[lo: lo + chunk] = extract_cubes(
                    flow_dev, ow_dev[lo: lo + chunk], box_dev[lo: lo + chunk],
                    P, quantize=False)
            flow_buf = flow_buf.reshape((n * K,) + flow_buf.shape[2:])
        elif net.of_unets is not None:  # a flow head without flow: zeros
            zero_of = torch.zeros((min(m, cube_batch), P, P, n_of), dtype=dtype,
                                  device=dev)

        # -- phase B: flat scoring of the valid rows --------------------
        scores = torch.empty(m, device=dev)
        for lo in range(0, m, cube_batch):
            ii = idx_dev[lo: lo + cube_batch]
            x = cube_buf.index_select(0, ii).to(dtype) / 255.0
            if use_flow:
                x_of = flow_buf.index_select(0, ii).to(dtype)
            else:
                x_of = None if net.of_unets is None else zero_of[: ii.numel()]
            scores[lo: lo + cube_batch] = _fused_scores(forward(x, x_of), mc,
                                                        stats_dev, use_flow)
        scores = scores.cpu().numpy()
        mag_flat = mag.reshape(-1).cpu().numpy() if use_flow else None

    # -- host: motion filter + degenerate-splat filter + segment max -----
    keep = (mag_flat[flat] > cfg.fore.motion_thr if use_flow
            else np.ones(m, bool))
    keep &= ~degenerate_boxes(boxes_pad[fid, bid])
    out = np.full(n, -big_number, dtype=np.float32)
    np.maximum.at(out, fid[keep], scores[keep])
    return out


def infer_frame_scores_segmented(
    cfg: PipelineConfig,
    state_dict: Dict[str, torch.Tensor],
    stats: Tuple[float, float, float, float],
    frames,
    windows: np.ndarray,
    boxes_pad: np.ndarray,
    valid: np.ndarray,
    flow=None,
    of_windows: Optional[np.ndarray] = None,
    segment_frames: int = 4096,
    chunk: int = 128,
    cube_batch: int = 2048,
    net: Optional[SelfCompletionNet] = None,
    big_number: float = BIG_NUMBER,
    compute_dtype=torch.float32,
    device="cuda",
) -> np.ndarray:
    """Resident scoring for splits whose frames and cube buffers exceed
    the device (vec_vad_tpu/infer.py:189-254; avenue's test split is ~10.6
    GB of frames and ~28 GB of flow): the frame axis in `segment_frames`
    segments, each scored by infer_frame_scores_resident.

    Each segment uploads exactly the frame range its context windows
    reference, and the flow range its of_windows reference, computed from
    the window rows themselves, so every border mode works and a segment
    boundary may fall inside a video. `frames` and `flow` may be lazy
    stacks (data.readers.LazyFrameStack / LazyFlowStack): only the
    referenced ranges are read. Equal to the resident form by
    construction; peak device memory is one segment's."""
    dev = resolve_device(device)
    n = valid.shape[0]
    windows = np.asarray(windows, np.int64).reshape(n, -1)
    if of_windows is not None:
        of_windows = np.asarray(of_windows, np.int64).reshape(n, -1)
    net = net if net is not None else make_completion_net(cfg.model, dev)
    out = np.empty(n, np.float32)
    for lo in range(0, n, segment_frames):
        hi = min(lo + segment_frames, n)
        w_seg = windows[lo:hi]
        ref_lo, ref_hi = int(w_seg.min()), int(w_seg.max()) + 1
        kwargs = {}
        if flow is not None and of_windows is not None:
            ow_seg = of_windows[lo:hi]
            oref_lo, oref_hi = int(ow_seg.min()), int(ow_seg.max()) + 1
            kwargs = dict(flow=flow[oref_lo:oref_hi], of_windows=ow_seg - oref_lo)
        out[lo:hi] = infer_frame_scores_resident(
            cfg, state_dict, stats, frames[ref_lo:ref_hi], w_seg - ref_lo,
            boxes_pad[lo:hi], valid[lo:hi], chunk=chunk, cube_batch=cube_batch,
            net=net, big_number=big_number, compute_dtype=compute_dtype,
            device=dev, **kwargs,
        )
    return out


def _nbytes(a) -> float:
    """Bytes of a frame stack (numpy, lazy or a tensor)."""
    if isinstance(a, torch.Tensor):
        return float(a.numel() * a.element_size())
    return float(np.prod(a.shape)) * np.dtype(a.dtype).itemsize


def infer_frame_scores(
    cfg: PipelineConfig,
    state_dict: Dict[str, torch.Tensor],
    stats: Tuple[float, float, float, float],
    frames,
    windows: np.ndarray,
    boxes_pad: np.ndarray,
    valid: np.ndarray,
    flow=None,
    of_windows: Optional[np.ndarray] = None,
    chunk: int = 128,
    net: Optional[SelfCompletionNet] = None,
    compute_dtype=torch.float32,
    device_memory_budget_bytes: float = 4e9,
    device="cuda",
) -> np.ndarray:
    """Score every frame of a split (vec_vad_tpu/infer.py:399-475) with the
    JAX package's memory-budget routing, through the segmented scorer.

    windows/of_windows come from VideoIndex.context_indices; boxes_pad/
    valid from ops.stc.pad_boxes. A split whose frames (+ flow, 4 bytes
    an element) fit in `device_memory_budget_bytes` is scored as one
    segment, i.e. by the resident form; a larger one in segments of
    budget / (2 x bytes a frame) frames, rounded down to a multiple of 32
    and clamped to [32, 4096]; the factor 2 leaves room for the segment's
    cube buffers and workspace beside its upload. `chunk`: frames a cube
    extraction call. The JAX package's third form for a split that fits,
    a chunk scorer over the whole uploaded stack (make_score_chunk_fn), is
    not ported: on the H100 it was slower than both the resident and the
    segmented form and held more memory than the segmented one (PERF.md
    section 5)."""
    footprint = _nbytes(frames)
    if flow is not None:
        footprint += float(np.prod(flow.shape)) * 4.0
    n = frames.shape[0]
    seg = max(n, 1)
    if footprint > device_memory_budget_bytes:
        per_frame = footprint / max(n, 1)
        seg = int(device_memory_budget_bytes / (2.0 * per_frame))
        seg = max(32, min(4096, seg // 32 * 32))
    return infer_frame_scores_segmented(
        cfg, state_dict, stats, frames, windows, boxes_pad, valid,
        flow=flow, of_windows=of_windows, segment_frames=seg, chunk=chunk, net=net,
        compute_dtype=compute_dtype, device=device,
    )


def infer_frame_scores_grid(
    model,
    test_cubes,
    n_frames: int,
    trainer=None,
    cube_batch: int = 2048,
    compute_dtype=torch.float32,
    big_number: float = BIG_NUMBER,
    device="cuda",
) -> np.ndarray:
    """Frame scores of a multi-block model (vec_vad_tpu/infer.py:257-322)
    from an extracted CubeSet (pipeline.extract_cube_set or its resident
    form): every trained block's cubes scored together in batches of
    `cube_batch` rows a block (GridTrainer.score_blocks, in compute_dtype:
    f32 unless asked), fused on the host (fuse_scores), degenerate boxes
    dropped, the max per frame. Cubes of an untrained block score
    big_number (test.py:308-310); a frame with no scoring cube,
    -big_number. Runs on `device`, or `trainer`'s when one is given."""
    from vec_vad_torch.pipeline import _grid_trainer, _rows, group_by_block, make_trainer
    from vec_vad_torch.score.scoring import fuse_scores

    cfg = model.cfg
    mc = cfg.model
    trainer = trainer or make_trainer(cfg, device=device)
    use_flow = mc.use_flow and test_cubes.flow is not None

    cube_scores = np.full(test_cubes.size, big_number, dtype=np.float32)
    trained = {k: v for k, v in group_by_block(test_cubes).items()
               if model.blocks.get(k) is not None}
    if trained:
        per_block = _grid_trainer(cfg, trainer).score_blocks(model.blocks, [
            (key, _rows(test_cubes.raw, idx),
             _rows(test_cubes.flow, idx) if use_flow else None)
            for key, idx in trained.items()], batch_size=cube_batch,
            compute_dtype=compute_dtype)
        for key, idx in trained.items():
            blk = model.blocks[key]
            raw_sc, of_sc = per_block[key]
            use_of = use_flow and blk.of_scores is not None
            cube_scores[idx] = fuse_scores(
                raw_sc, of_sc if use_of else None, blk.raw_stats,
                blk.of_stats if use_of else None, mc.w_raw, mc.w_of)

    keep = ~degenerate_boxes(test_cubes.boxes)
    out = np.full(n_frames, -big_number, dtype=np.float32)
    np.maximum.at(out, test_cubes.frame_ids[keep], cube_scores[keep])
    return out
