"""Self-contained serving: foreground boxes computed IN the serving loop
from the frame stream (vec_vad_tpu/serve/motion.py), by the reference's
motion-detector recipe (obj_det_with_motion.py:144-223), so a raw camera
feed serves with no precomputed bbox source at all.

Per push of frame u, one step on the device:

  * writes frame u into the ring (and its flow map, when streamed),
  * scores frame u-2 with the boxes derived from ITS motion map (the
    host's contour stage between pushes, fore.motion.motion_bboxes),
  * computes the binary motion map of frame u-1 (its hard-bordered
    3-frame window [u-2, u-1, u] needs frame u: the same one-push
    lookahead the offline stage has),
  * and starts one download of the result: the block scores and motion
    magnitudes as float32 bytes followed by the map, one byte a pixel,
    into pinned memory behind the step (serve._common._download_async).

The next push reads that result after its event, runs the contours of
frame u-1's map and then dispatches. Scores therefore emerge with a
3-push lag; end_video() flushes the tail with the reference's
tail-clamped windows, using map-only steps (no scoring) where needed.
Scores equal the offline pipeline's run with
fore.detector.compute_foreground_bboxes motion-mode boxes.

`push(frame, ap_boxes=...)` merges externally detected appearance boxes
exactly like the offline stage (they mask the motion map and concatenate
ahead of the motion boxes); pass boxes already filtered and suppressed
(filter_detections + del_cover_bboxes).
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from vec_vad_torch.fore.motion import motion_bboxes, motion_maps
from vec_vad_torch.runtime.profiling import annotate
from vec_vad_torch.serve._common import (
    _download_async,
    _host_result,
    _time_device_chain,
    _upload,
    _valid_rows,
)
from vec_vad_torch.serve.streaming import StreamingScorer


class MotionStreamingScorer(StreamingScorer):
    """Usage:
        scorer = MotionStreamingScorer.from_model(model, spec=cfg.dataset)
        for video in feed:
            scorer.start_video()
            for frame in video:
                s = scorer.push(frame)        # frame u-3's score, or None
            tail = scorer.end_video()         # the pending scores, in order
    """

    def __init__(self, cfg, state_dict=None, stats=None, *, spec=None, **kw):
        """spec: the DatasetSpec whose motion parameters (mt_*) the maps
        and contours use (default cfg.dataset). pipeline_depth must be 0:
        the map conveyor is itself a one-push pipeline."""
        if kw.get("pipeline_depth"):
            raise ValueError(
                "MotionStreamingScorer pipelines internally (the map "
                "harvest is a one-push conveyor); pipeline_depth must be 0"
            )
        super().__init__(cfg, state_dict, stats, **kw)
        self.spec = spec if spec is not None else cfg.dataset
        # the ring holds the scored frame's full predict window PLUS the
        # two newer frames (u-1, u) the motion lookahead keeps alive
        self._rlen = self.R + 2
        self._of_rlen = (self.R_of + 2) if self.use_flow else 1
        # flow maps come with the pushes (MotionFlowStreamingScorer: no)
        self._streams_flow = self.use_flow
        self._hw = None
        self._video_closed = True
        self._reset_video_state()

    # -- state ------------------------------------------------------------

    def _reset_video_state(self) -> None:
        self._boxq: Dict[int, np.ndarray] = {}  # pos -> combined boxes
        self._apq: Dict[int, np.ndarray] = {}  # pos -> caller ap boxes
        self._skipq: Dict[int, bool] = {}  # pos -> flow missing?
        # in flight: (handle, boxes_pad, nb, scene, skip_mag, scored, mapped)
        self._flight: deque = deque()
        self._last_push = None  # (frame_t, flow_t) for idempotent tail calls

    def start_video(self, scene: int = 1) -> None:
        if self._n_pushed > self._v0 and not self._video_closed:
            raise ValueError(
                "end_video() must flush the previous video before "
                "start_video() (tail frames' maps/scores are pending)"
            )
        super().start_video(scene)
        self._video_closed = False
        self._reset_video_state()

    def _ensure_rings(self, h: int, w: int) -> None:
        if self._ring is not None:
            return
        self._ring = torch.zeros((self._rlen, h, w, 3), dtype=torch.uint8,
                                 device=self.device)
        of_shape = (self._of_rlen, h, w, 2) if self.use_flow else (1, 1, 1, 2)
        self._flow_ring = torch.zeros(of_shape, dtype=torch.float32,
                                      device=self.device)
        self._hw = (h, w)

    # -- the device step ----------------------------------------------------

    def _result(self, out: Optional[torch.Tensor],
                mwin_t: Optional[torch.Tensor]) -> torch.Tensor:
        """One uint8 result buffer: the (B*K + K,) float32 scores' bytes
        (zeros for a map-only step), then the (H, W) motion map of the
        ring frames `mwin_t`, one byte a pixel (none when no frame is
        mapped)."""
        if out is None:
            out = torch.zeros(self.B * self.K + self.K, device=self.device)
        parts = [out.contiguous().view(torch.uint8)]
        if mwin_t is not None:
            wd = self._ring.index_select(0, mwin_t)[None]  # (1, 3, H, W, 3)
            mp = motion_maps(wd, int(self.spec.mt_gauss_mask_size),
                             int(self.spec.mt_binary_thr))[0]
            parts.append(mp.view(torch.uint8).reshape(-1))
        return torch.cat(parts)

    def _motion_args(self, frame_t, flow_t, pos, scored, mapped, tail_hint,
                     boxes_pad, nb) -> tuple:
        """The host part of a step writing `frame_t` at within-video
        position `pos`, scoring frame `scored` (its padded boxes, nb of
        them valid) and mapping frame `mapped` (< 0: none): ring slots,
        device index tensors and the scored frame's box set (boxes, row
        set, nb)."""
        v0, rlen, orlen = self._v0, self._rlen, self._of_rlen
        s = max(scored, 0)
        rows, n_valid = _valid_rows([nb], self.K)
        win_t, owin_t, mwin_t, rows_t = self._indices(
            (self._windows(s, v0, self.ctx, rlen), rlen),
            (self._windows(s, v0, self.ctx_of, orlen), orlen),
            (self._mwin(mapped, tail_hint), rlen),
            (rows, self.K),
        )
        return (frame_t, flow_t, (v0 + pos) % rlen, (v0 + pos) % orlen,
                win_t, owin_t, mwin_t,
                (_upload(boxes_pad, self.device), rows_t, n_valid),
                scored >= 0, mapped >= 0)

    def _motion_step(self, frame_t, flow_t, slot, of_slot, win_t, owin_t,
                     mwin_t, box_set, score, mapped) -> torch.Tensor:
        """One push on the device, its inputs already there: the ring
        writes (no flow on a flow-fusing model writes zero flow), the
        scored frame's scores and the mapped frame's map."""
        self._write_frame(slot, frame_t)
        if self.use_flow:
            self._flow_ring[of_slot] = 0.0 if flow_t is None else flow_t
        out = self._score_from_rings(win_t, owin_t, box_set) if score else None
        return self._result(out, mwin_t if mapped else None)

    # -- streaming API ----------------------------------------------------

    def push_many(self, *a, **kw):
        raise NotImplementedError(
            "MotionStreamingScorer scores through the map conveyor — the "
            "inherited micro-batched push_many would bypass it (no motion "
            "maps, box queue desync); push frames one at a time"
        )

    @torch.no_grad()
    def push(self, frame: np.ndarray, ap_boxes=None,
             flow: Optional[np.ndarray] = None) -> Optional[float]:
        """Feed frame u; returns the score of frame u-3 (None while the
        conveyor fills — end_video() flushes the tail). `ap_boxes`:
        optional pre-filtered appearance boxes for THIS frame; `flow` as
        in StreamingScorer.push."""
        if self._video_closed:
            raise ValueError("call start_video() first")
        with annotate("serve.tick"):
            frame = self._norm_frame(frame)
            self._ensure_rings(*frame.shape[:2])
            pos = self._n_pushed - self._v0
            self._apq[pos] = (
                np.zeros((0, 4), np.float32)
                if ap_boxes is None
                else np.asarray(ap_boxes, np.float32).reshape(-1, 4)
            )
            # harvest the previous step FIRST: its map (frame pos-1) gives
            # boxes a later push scores with, and the harvest at push pos-1
            # gave the boxes of frame pos-2, which this push scores
            ret = None
            while self._flight:
                r = self._harvest(self._flight.popleft())
                if r is not None:
                    ret = r
            flow_t = None
            if self._streams_flow:
                self._skipq[pos] = flow is None
                if flow is not None:
                    flow_t = _upload(np.asarray(flow, np.float32), self.device)
            frame_t = _upload(frame, self.device)
            self._dispatch(frame_t, flow_t, pos, scored=pos - 2, mapped=pos - 1,
                           tail_hint=None)
            self._n_pushed += 1
            self._last_push = (frame_t, flow_t)
            return ret

    @torch.no_grad()
    def end_video(self) -> List[float]:
        """Flush the current video: compute the tail frames' maps with
        their now-known tail-clamped windows ([n-2, n-1, n-1] for the
        last frame, [0, 0, 0] for a 1-frame video) and emit every
        pending score, in frame order."""
        if self._video_closed:
            return []
        self._video_closed = True
        n = self._n_pushed - self._v0
        if n == 0:
            return []
        with annotate("serve.tick"):
            emits: List[float] = []
            while self._flight:
                r = self._harvest(self._flight.popleft())
                if r is not None:
                    emits.append(r)
            frame_t, flow_t = self._last_push
            for t in range(max(n - 2, 0), n):
                if t not in self._boxq:
                    # map-only step for t with its tail-clamped window
                    self._dispatch(frame_t, flow_t, n - 1, scored=-1, mapped=t,
                                   tail_hint=n)
                    self._harvest(self._flight.popleft())
                nxt = t + 1 if (t + 1 < n and t + 1 not in self._boxq) else -1
                self._dispatch(frame_t, flow_t, n - 1, scored=t, mapped=nxt,
                               tail_hint=n)
                r = self._harvest(self._flight.popleft())
                assert r is not None
                emits.append(r)
            return emits

    def drain(self) -> List[float]:
        """The flush; prefer end_video()."""
        return self.end_video()

    def time_device_step(self, frame: np.ndarray, boxes: np.ndarray,
                         k: int = 64, repeats: int = 3) -> float:
        """Device-time twin of a push's step (ring writes, STC and the
        ensemble for the scored frame, the 3-frame motion map and the
        result buffer): best ms per step with its inputs staged once
        (serve._common._time_device_chain). `boxes` plays the scored
        frame's box list. Runs on clones of the rings and leaves the
        conveyor's queues alone, so a probe can run mid-video."""
        frame = self._norm_frame(frame)
        self._ensure_rings(*frame.shape[:2])
        boxes_pad, nb = self._pad_boxes(boxes)
        pos = max(self._n_pushed - self._v0, 3)
        flow_t = None
        if self.use_flow:
            flow_t = torch.zeros(frame.shape[:2] + (2,), device=self.device)
        args = self._motion_args(_upload(frame, self.device), flow_t, pos,
                                 pos - 2, pos - 1, None, boxes_pad, nb)
        with torch.no_grad():
            return _time_device_chain(self, lambda: self._motion_step(*args),
                                      k, repeats)

    # -- internals ---------------------------------------------------------

    def _mwin(self, mapped: int, tail_hint) -> np.ndarray:
        """Ring slots of frame `mapped`'s hard-bordered window, clamped to
        the video's end once its length `tail_hint` is known."""
        if mapped < 0:
            return np.zeros(3, np.int64)
        hi = (tail_hint - 1) if tail_hint is not None else mapped + 1
        win = np.array([max(mapped - 1, 0), mapped, min(mapped + 1, hi)])
        return (self._v0 + win) % self._rlen

    def _dispatch(self, frame_t, flow_t, pos, scored, mapped, tail_hint):
        """One step: write `frame_t` (the slot of within-video position
        `pos`; an idempotent rewrite in end_video), score frame `scored`
        and map frame `mapped` (< 0: none), and queue its result."""
        if scored >= 0:
            boxes_pad, nb = self._pad_boxes(self._boxq.pop(scored))
            skip_mag = self._skipq.pop(scored, not self.use_flow)
        else:
            boxes_pad, nb, skip_mag = np.zeros((self.K, 4), np.float32), 0, True
        out = self._motion_step(*self._motion_args(
            frame_t, flow_t, pos, scored, mapped, tail_hint, boxes_pad, nb))
        self._flight.append((_download_async(out), boxes_pad, nb, self._scene,
                             skip_mag, scored, mapped))

    def _harvest(self, entry) -> Optional[float]:
        """Read a queued result after its event: the mapped frame's
        contours give its boxes (queued for its scoring step), and the
        scored frame's score is returned (None for a map-only step)."""
        handle, boxes_pad, nb, scene, skip_mag, scored, mapped = entry
        arr = _host_result(handle)
        n_out = 4 * (self.B * self.K + self.K)
        if mapped >= 0:
            m = arr[n_out:].reshape(self._hw).astype(bool)
            ap = self._apq.pop(mapped, np.zeros((0, 4), np.float32))
            mt = motion_bboxes(
                m, ap if ap.shape[0] else None,
                self.spec.mt_area_thr, self.spec.mt_extend,
            )
            self._boxq[mapped] = (
                np.concatenate([ap, mt.astype(np.float32)], axis=0)
                if mt.shape[0] > 0
                else ap
            )
        if scored >= 0:
            scores = arr[:n_out].view(np.float32)
            return self._finish_host(scores, boxes_pad, nb, scene, skip_mag)
        return None
