"""A camera fleet that finds its own foreground: the mmdet Cascade R-CNN
(fore/mmdet_detector.py) inside every tick, as the reference's obj_det
mode localises (fore_det/obj_det_with_motion.py:47-91 without the motion
half).

`DetectingFleetScorer.push_tick(frames)` takes the C cameras' uint8 BGR
frames only. It uploads them once, runs ONE batched detector forward
(`MMDetCascadeDetector.net`: the keep-ratio resize, the network and the
multiclass NMS, the computation of `detect_many`), downloads the tick's
detections in one copy, and on the host filters each frame's detections
(`fore.detector.filter_detections`: score above the dataset's
ap_score_thr, inclusive area at least ap_min_area), suppresses covered
boxes (`fore.suppress.del_cover_bboxes`, cover_thr) and keeps the first
max_boxes of what is left (del_cover_bboxes' order: smallest area
first). The frames are then scored on those boxes in the same tick by
MultiCameraScorer's staging, STC and valid-row ensemble. The kept boxes
equal detect_many's detections filtered and suppressed the same way.

Spans (runtime.profiling.annotate): `serve.detect` inside `serve.tick`
holds the upload, the forward (`detect.prep`, `detect.backbone`,
`detect.rpn`, `detect.stages`, `detect.nms`), the download (`serve.wait`)
and `detect.filter`; `frames_detected` and `boxes_kept` count the
route's work. Given boxes, push_tick is MultiCameraScorer's.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from vec_vad_torch.fore.detector import filter_detections
from vec_vad_torch.fore.mmdet_detector import per_frame_detections
from vec_vad_torch.fore.suppress import del_cover_bboxes
from vec_vad_torch.runtime.profiling import annotate
from vec_vad_torch.serve._common import _upload
from vec_vad_torch.serve.fleet import MultiCameraScorer


class DetectingFleetScorer(MultiCameraScorer):
    """Usage:
        det = MMDetCascadeDetector.from_checkpoint(path, device="cuda")
        scorer = DetectingFleetScorer.from_model(model, n_cameras=8,
                                                 detector=det)
        scorer.start_video()
        for frames in fleet_feed:             # (C, H, W, 3) uint8 BGR
            scores = scorer.push_tick(frames)  # C scores

    `last_boxes` holds the boxes the last detecting tick kept, a (n_c, 4)
    float32 array a camera."""

    def __init__(self, cfg, state_dict=None, stats=None, *, n_cameras,
                 detector, mesh=None, **kw):
        """detector: an MMDetCascadeDetector on the scorer's device; the
        configuration's dataset gives ap_score_thr, ap_min_area and
        cover_thr."""
        if mesh is not None:
            raise ValueError("the detecting fleet serves on one device (no mesh)")
        if kw.get("gray_stream"):
            raise ValueError("the detector takes BGR frames (no gray_stream)")
        super().__init__(cfg, state_dict, stats, n_cameras=n_cameras, **kw)
        if detector.device != self.device:
            raise ValueError(f"the detector is on {detector.device}, the scorer "
                             f"on {self.device}")
        self.detector = detector
        spec = cfg.dataset
        self.score_thr = float(spec.ap_score_thr)
        self.min_area = float(spec.ap_min_area)
        self.cover_thr = float(spec.cover_thr)
        self.frames_detected = 0
        self.boxes_kept = 0
        self.last_boxes: Optional[List[np.ndarray]] = None

    def keep(self, boxes: np.ndarray, scores: np.ndarray) -> np.ndarray:
        """One frame's detections -> its kept boxes: filtered, suppressed,
        the first max_boxes."""
        ap = filter_detections(boxes, scores, self.score_thr, self.min_area)
        return del_cover_bboxes(ap, self.cover_thr)[: self.K]

    def detect(self, frames: np.ndarray) -> List[np.ndarray]:
        """The kept boxes of each of the C frames (C, H, W, 3) uint8 BGR:
        one detector forward, one download, the host filter."""
        frames = np.asarray(frames, np.uint8)
        if frames.ndim != 4 or frames.shape[0] != self.C or frames.shape[-1] != 3:
            raise ValueError(f"expected ({self.C}, H, W, 3) BGR frames, got "
                             f"{frames.shape}")
        x = _upload(frames, self.device)
        b, s, l, ok = self.detector.forward_device(x)
        packed = torch.cat([b, s[..., None], l[..., None].to(b.dtype),
                            ok[..., None].to(b.dtype)], -1)
        with annotate("serve.wait"):
            host = packed.cpu().numpy()  # ONE download for the tick
        with annotate("detect.filter"):
            dets = per_frame_detections(host[..., :4], host[..., 4],
                                        host[..., 5].astype(np.int64),
                                        host[..., 6] > 0)
            kept = [self.keep(bx, sc) for bx, sc, _ in dets]
        self.frames_detected += len(kept)
        self.boxes_kept += sum(k.shape[0] for k in kept)
        self.last_boxes = kept
        return kept

    @torch.no_grad()
    def push_tick(self, frames: np.ndarray, boxes_list=None,
                  flows: Optional[np.ndarray] = None) -> Optional[List[float]]:
        """Score one frame from each of the C cameras on the boxes the
        detector finds in them this tick (MultiCameraScorer.push_tick's
        return). With `boxes_list` given, MultiCameraScorer.push_tick."""
        if boxes_list is not None:
            return super().push_tick(frames, boxes_list, flows)
        with annotate("serve.tick"):
            with annotate("serve.detect"):
                boxes_list = self.detect(frames)
            return self._score_tick(frames, boxes_list, flows)
