"""Appearance-detector interface and the foreground-localization driver
(vec_vad_tpu/fore/detector.py).

The appearance source is a narrow interface:

  * PrecomputedDetector — serves the shipped final bbox fixtures
    (raw_datasets/*/bboxes_*_obj_det_with_motion.npy), the reference's
    supported way to run without mmdet;
  * any callable `img -> (boxes (N, 4), scores (N,))`, or an object with
    `detect_many(imgs) -> [(boxes, scores, labels), ...]` for batched
    calls.

`compute_foreground_bboxes` drives the four extraction modes of
train.py:62-95 / test.py:61-90 over a whole split, with the motion maps
computed on `device` and the contours on the host. The appearance
detectors themselves are fore/mmdet_detector.py (the mmdet Cascade R-CNN
behind a checkpoint, with `detect_many`), fore/cascade_detector.py and
fore/centernet_detector.py.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Protocol, Tuple

import numpy as np
import torch

from vec_vad_torch.config import DatasetSpec, PipelineConfig
from vec_vad_torch.data.video_index import VideoIndex
from vec_vad_torch.device import resolve_device
from vec_vad_torch.fore.motion import _blur_u8, _threshold_maps, motion_bboxes
from vec_vad_torch.fore.patches import full_frame_box, multi_scale_patch_boxes
from vec_vad_torch.fore.suppress import del_cover_bboxes


class AppearanceDetector(Protocol):
    def __call__(self, img: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """img (H, W, C) BGR uint8 -> (boxes (N, 4) xyxy, scores (N,))."""
        ...


class PrecomputedDetector:
    """Serves per-frame boxes from a saved object-array .npy fixture."""

    def __init__(self, path: str):
        self.all_boxes = list(np.load(path, allow_pickle=True))

    def __len__(self) -> int:
        return len(self.all_boxes)

    def boxes_for_frame(self, idx: int) -> np.ndarray:
        return np.asarray(self.all_boxes[idx]).reshape(-1, 4)


def filter_detections(
    boxes: np.ndarray,
    scores: np.ndarray,
    score_thr: float,
    min_area: float,
) -> np.ndarray:
    """Score + area filtering of raw detections
    (obj_det_with_motion.py:77-86). Areas use the inclusive convention."""
    boxes = np.asarray(boxes).reshape(-1, 4)
    scores = np.asarray(scores).reshape(-1)
    keep = scores > score_thr
    boxes = boxes[keep]
    areas = (boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
    return boxes[areas >= min_area]


def _appearance_boxes(spec: DatasetSpec, frames, n: int, detector,
                      detector_batch: int) -> List[np.ndarray]:
    """Filtered, suppressed appearance boxes of every frame. A detector
    with `detect_many` gets batches of `detector_batch` frames, the tail
    padded by repeating the last frame (its outputs discarded), so every
    call has one shape."""
    raw_results = None
    if hasattr(detector, "detect_many"):
        db = detector_batch
        raw_results = []
        for lo in range(0, n, db):
            hi = min(lo + db, n)
            block = np.asarray(frames[lo:hi])
            if hi - lo < db:
                block = np.concatenate(
                    [block, np.repeat(block[-1:], db - (hi - lo), axis=0)]
                )
            raw_results += [
                (b, s) for b, s, _ in detector.detect_many(block)[: hi - lo]
            ]
    out = []
    for i in range(n):
        raw_boxes, scores = (
            raw_results[i] if raw_results is not None else detector(frames[i])
        )
        ap = filter_detections(raw_boxes, scores, spec.ap_score_thr, spec.ap_min_area)
        out.append(del_cover_bboxes(ap, spec.cover_thr))
    return out


def compute_foreground_bboxes(
    cfg: PipelineConfig,
    spec: DatasetSpec,
    index: VideoIndex,
    frames=None,
    detector: Optional[Callable] = None,
    chunk: int = 64,
    detector_batch: int = 4,
    device="cuda",
    timings: Optional[dict] = None,
) -> List[np.ndarray]:
    """Per-frame foreground boxes for a split, by extraction mode.

    frames: (N, H, W, C) uint8 (an array or a lazy stack), required for
    the detector and motion modes. Returns a ragged list of (K_i, 4)
    arrays (the bboxes_*.npy schema): appearance boxes ahead of motion
    boxes in obj_det_with_motion mode.

    The motion stage goes `chunk` frames at a time: the chunk's frame
    range (one frame of context on each side) is uploaded once as uint8,
    each of its frames blurred once, the hard-bordered 3-frame windows
    gathered on the device, the maps thresholded there and downloaded,
    and the contours found on the host. `timings`, when given, gathers
    the stage's seconds under "read" (the chunk's frames from `frames`),
    "maps" (upload, blur and threshold, the device synchronised),
    "download" and "contours"."""
    dev = resolve_device(device)
    mode = cfg.fore.extraction_mode
    n = index.total_frames
    h, w = spec.frame_hw

    if mode == "simple_patch":
        tile = multi_scale_patch_boxes(h, w)
        return [tile.copy() for _ in range(n)]
    if mode == "frame":
        box = full_frame_box(h, w)
        return [box.copy() for _ in range(n)]

    assert frames is not None, f"mode {mode!r} needs frames"
    if isinstance(detector, PrecomputedDetector):
        return [detector.boxes_for_frame(i) for i in range(n)]
    assert detector is not None, (
        "obj_det modes need a detector (or PrecomputedDetector fixtures)"
    )
    ap_per_frame = _appearance_boxes(spec, frames, n, detector, detector_batch)
    if mode == "obj_det":
        return ap_per_frame
    assert mode == "obj_det_with_motion", mode

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    clock = {"read": 0.0, "maps": 0.0, "download": 0.0, "contours": 0.0}
    windows = index.context_indices(1, "hard")  # (N, 3)
    out: List[np.ndarray] = []
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        f_lo, f_hi = max(lo - 1, 0), min(hi + 1, n)
        t_read = time.perf_counter()
        host = np.ascontiguousarray(frames[f_lo:f_hi])
        t0 = time.perf_counter()
        block = torch.from_numpy(host).to(dev)
        win = np.clip(windows[lo:hi] - f_lo, 0, f_hi - f_lo - 1)
        win = torch.from_numpy(win).to(dev)
        # the blur is per frame: blur the range once, then gather windows
        blurred = _blur_u8(block, int(spec.mt_gauss_mask_size))
        maps_t = _threshold_maps(blurred[win], int(spec.mt_binary_thr))
        if timings is not None:
            sync()
        t1 = time.perf_counter()
        maps = maps_t.cpu().numpy()
        t2 = time.perf_counter()
        for j, f in enumerate(range(lo, hi)):
            ap = ap_per_frame[f]
            mt = motion_bboxes(maps[j], ap, spec.mt_area_thr, spec.mt_extend)
            out.append(np.concatenate([ap, mt], axis=0) if mt.shape[0] > 0 else ap)
        t3 = time.perf_counter()
        clock["read"] += t0 - t_read
        clock["maps"] += t1 - t0
        clock["download"] += t2 - t1
        clock["contours"] += t3 - t2
    if timings is not None:
        for key, s in clock.items():
            timings[key] = timings.get(key, 0.0) + s
    return out
