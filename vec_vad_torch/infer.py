"""Whole-split scoring with the cubes resident on the device
(vec_vad_tpu/infer.py:81-186 `infer_frame_scores_resident`): the scoring
form the JAX package's bench times.

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

Every gather clamps its indices, as jnp.take(mode='clip') does. A
single-block (h_block == w_block == 1) form: the general model grid goes
through pipeline.score_cubes. Not ported (ROADMAP.md Queue 1 item 2.9):
`infer_frame_scores`, `infer_frame_scores_segmented` and the grid form.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from vec_vad_torch.config import PipelineConfig
from vec_vad_torch.device import full_f32, resolve_device
from vec_vad_torch.models.completion import SelfCompletionNet, make_completion_net
from vec_vad_torch.pipeline import extract_cubes, to_device
from vec_vad_torch.score.scoring import BIG_NUMBER, degenerate_boxes
from vec_vad_torch.train.trainer import require_f32


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
    (its weights are replaced by `state_dict`). Returns (N,) float32,
    -big_number for a frame with no scoring box."""
    mc = cfg.model
    require_f32(mc)
    dev = resolve_device(device)
    P = cfg.fore.patch_size
    n, K = valid.shape
    use_flow = mc.use_flow and flow is not None

    # -- host-side flat index set --------------------------------------
    fid, bid = np.nonzero(valid)
    m = fid.size
    flat = fid * K + bid

    if net is None:
        net = make_completion_net(mc, dev)
    net.load_state_dict(state_dict)

    frames_dev = to_device(frames, dev)
    windows = np.asarray(windows, np.int64).reshape(n, -1)
    win_dev = torch.as_tensor(windows, device=dev)
    box_dev = torch.as_tensor(np.asarray(boxes_pad, np.float32), device=dev)
    idx_dev = torch.as_tensor(flat, device=dev).clamp(0, n * K - 1)
    mu_r, sd_r, mu_o, sd_o = (torch.tensor(float(s), device=dev) for s in stats)

    with torch.no_grad(), full_f32():
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
            zero_of = torch.zeros((min(m, cube_batch), P, P, n_of), device=dev)

        # -- phase B: flat scoring of the valid rows --------------------
        scores = torch.empty(m, device=dev)
        for lo in range(0, m, cube_batch):
            ii = idx_dev[lo: lo + cube_batch]
            x = cube_buf.index_select(0, ii).float() / 255.0
            if use_flow:
                x_of = flow_buf.index_select(0, ii)
            else:
                x_of = None if net.of_unets is None else zero_of[: ii.numel()]
            out = net(x, x_of)
            sc = (out.raw_out - out.raw_tgt).square().sum(dim=(0, 2, 3, 4))
            score = mc.w_raw * (sc - mu_r) / sd_r
            if use_flow and out.of_out is not None:
                osc = (out.of_out - out.of_tgt).square().sum(dim=(0, 2, 3, 4))
                score = score + mc.w_of * (osc - mu_o) / sd_o
            scores[lo: lo + cube_batch] = score
        scores = scores.cpu().numpy()
        mag_flat = mag.reshape(-1).cpu().numpy() if use_flow else None

    # -- host: motion filter + degenerate-splat filter + segment max -----
    keep = (mag_flat[flat] > cfg.fore.motion_thr if use_flow
            else np.ones(m, bool))
    keep &= ~degenerate_boxes(boxes_pad[fid, bid])
    out = np.full(n, -big_number, dtype=np.float32)
    np.maximum.at(out, fid[keep], scores[keep])
    return out
