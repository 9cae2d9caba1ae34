"""Live-flow serving: optical flow computed on the device inside each push
(vec_vad_tpu/serve/live_flow.py), single stream and fleet.

Scores equal the offline pipeline's because the reference's flow-pair
rule is reproduced frame for frame (flow.driver.flow_pair_indices):

  flow[0]     = net(f0, f0)      (the degenerate head pair, computed)
  flow[t]     = flow(t -> t+1)   for 0 < t < N-1
  flow[N-1]   = flow(N-2 -> N-1)

flow[t] needs frame t+1, so frame t's score emerges one push later ("flow
lag"): push(f_0) returns frame 0's score at once (its pair is (f0, f0)),
push(f_1) only writes the ring and returns None (frame 0 is out and frame
1 waits for f_2), push(f_u) returns frame u-1's score, and end_video()
flushes the last frame. Each scoring push runs: ring write, the pair's
cv2-parity resize to the 384x512 protocol, FlowNet2 (its FlowNetC cost
volume on the hand-written CUDA kernel), the flow resized back without
magnitude rescaling into a device flow ring, STC extraction and ensemble
scoring. The flow map never leaves the device.

`push_many` knows all k pairs of its batch before it scores any, so it
runs them through ONE FlowNet2 forward at batch k (k-1 in a video's first
batch, whose pair (f0, f1) is used by no frame) and then scores the
batch's frames in one ensemble forward: one cost-volume launch a batch.
`MultiCameraFlowScorer` does the same across a fleet: one FlowNet2
forward over the C cameras' pairs and one ensemble forward over their
C*K cubes a tick. On a device mesh (`mesh=`) each of the n entries runs
both for its C / n cameras, on its own replicas of FlowNet2 and of the
ensemble (serve.fleet's layout), so FlowNet2 runs at batch C / n an entry.
"""

from __future__ import annotations

import copy
from typing import List, Optional

import numpy as np
import torch

from vec_vad_torch.device import full_f32
from vec_vad_torch.flow.driver import cast_flow_net, resize_bilinear
from vec_vad_torch.serve._common import (
    _fleet_arity,
    _fleet_device,
    _fleet_replicas,
    _predict_window,
    _time_device_chain,
    _upload,
)
from vec_vad_torch.serve.fleet import MultiCameraScorer
from vec_vad_torch.serve.streaming import StreamingScorer


class FlowStreamingScorer(StreamingScorer):
    """Usage:
        scorer = FlowStreamingScorer.from_model(model, flow_net=flownet2)
        for video in feed:
            scorer.start_video()
            for frame, boxes in video:
                s = scorer.push(frame, boxes)   # score of previous frame
            tail = scorer.end_video()           # last frame's score
    """

    def __init__(self, cfg, state_dict=None, stats=None, *, flow_net,
                 flow_model_hw=(384, 512), flow_compute_dtype=torch.float32,
                 **kw):
        """flow_net: a module mapping (n, 2, mh, mw, 3) frame pairs in
        0..255 to (n, mh, mw, 2) flow (models.flownet.FlowNet2), on this
        scorer's device. flow_compute_dtype: dtype of its forward (float32
        or bfloat16; a bf16 copy of the weights is made once, and the flow
        returns to float32 before the flow ring and scoring)."""
        if not cfg.model.use_flow:
            raise ValueError(
                "FlowStreamingScorer serves two-stream models; "
                "use StreamingScorer for raw-only (use_flow=False)"
            )
        super().__init__(cfg, state_dict, stats, **kw)
        for p in flow_net.parameters():
            if p.device != self.device:
                raise ValueError(
                    f"flow_net lives on {p.device}, the scorer on {self.device}"
                )
        self.flow_net = cast_flow_net(flow_net, flow_compute_dtype).eval()
        self._flow_hw = tuple(flow_model_hw)
        self._flow_dtype = flow_compute_dtype
        self._last = None  # (frame, boxes_pad, nb) of the newest push
        self._first = None  # first frame of the current video (N=2 tail)
        self._video_closed = True
        # the step writes frame u BEFORE scoring frame u-1, whose raw
        # window still needs f_{u-R}: one extra slot keeps it alive
        self._rlen = self.R + 1

    def _live_flow(self, pairs: torch.Tensor) -> torch.Tensor:
        """(n, 2, H, W, 3) uint8 frame pairs -> (n, H, W, 2) float32 flow
        in one FlowNet2 forward, by calc-flow's protocol (flow/driver.py
        _flow_batch): cv2-parity resize to the model size, forward, resize
        back WITHOUT rescaling; an f32 route runs with TF32 off."""
        n, _, H, W, _ = pairs.shape
        mh, mw = self._flow_hw
        with full_f32(self._flow_dtype):
            pr = resize_bilinear(pairs.reshape((2 * n,) + pairs.shape[2:]), mh, mw)
            pr = pr.to(self._flow_dtype).reshape(n, 2, mh, mw, 3)
            return resize_bilinear(self.flow_net(pr).float(), H, W)

    def _flow_args(self, tpos: int, slot: int, prev_slot: int):
        """Host part of the step scoring within-video frame tpos whose flow
        pair is (prev_slot, slot): (of_slot, pair, window and flow-window
        indices on the device)."""
        pair_t, win_t, owin_t = self._indices(
            ((prev_slot, slot), self._rlen),
            (self._windows(tpos, self._v0, self.ctx, self._rlen), self._rlen),
            (self._windows(tpos, self._v0, self.ctx_of, self.R_of), self.R_of),
        )
        return (self._v0 + tpos) % self.R_of, pair_t, win_t, owin_t

    def _flow_step(self, frame_t, slot, of_slot, pair_t, win_t, owin_t,
                   boxes_t) -> torch.Tensor:
        """Write `frame_t` to ring slot `slot`, compute the flow of the
        ring pair `pair_t` into flow slot `of_slot`, and score."""
        self._write_frame(slot, frame_t)
        pair = self._ring.index_select(0, pair_t)  # (2, H, W, 3) uint8
        self._flow_ring[of_slot] = self._live_flow(pair[None])[0]
        return self._score_from_rings(win_t, owin_t, boxes_t)

    # -- streaming API ---------------------------------------------------

    def start_video(self, scene: int = 1) -> None:
        if self._n_pushed > self._v0 and not self._video_closed:
            raise ValueError(
                "end_video() must flush the previous video before "
                "start_video() (the last frame's score is still pending)"
            )
        super().start_video(scene)
        self._video_closed = False
        self._last = None

    @torch.no_grad()
    def push(self, frame: np.ndarray, boxes: np.ndarray) -> Optional[float]:
        """Score a frame's PREDECESSOR: returns frame u-1's score at push u
        (frame 0's at push 0, None at push 1 and while any pipeline_depth
        fills)."""
        if self._video_closed:
            raise ValueError("call start_video() first")
        pos = self._n_pushed - self._v0
        frame = self._norm_frame(frame)
        boxes_pad, nb = self._pad_boxes(boxes)
        self._ensure_rings(*frame.shape[:2])
        slot = self._n_pushed % self._rlen
        frame_t = _upload(frame, self.device)
        out = None
        if pos == 0:
            # frame 0's pair is (f0, f0): score it in the same push
            sb, snb = boxes_pad, nb
            self._first = frame
            out = self._flow_step(frame_t, slot, *self._flow_args(0, slot, slot),
                                  _upload(sb, self.device))
        elif pos == 1:
            # flow(0 -> 1) is used by no frame: only advance the ring
            self._write_frame(slot, frame_t)
        else:
            _, sb, snb = self._last
            prev = (self._n_pushed - 1) % self._rlen
            out = self._flow_step(frame_t, slot,
                                  *self._flow_args(pos - 1, slot, prev),
                                  _upload(sb, self.device))
        self._n_pushed += 1
        self._last = (frame, boxes_pad, nb)
        if out is None:
            return None  # nothing emitted: frame 1 waits for f_2
        return self._emit(out, sb, snb)

    @torch.no_grad()
    def push_many(self, frames, boxes_list) -> List[float]:
        """Advance k frames of the CURRENT video (no start_video between
        them), each scoring its predecessor with push()'s one-frame lag.
        Returns the scores this call emits, in frame order: k in steady
        state, k-1 in a video's first batch (frame 0 emits at once, the
        batch's last frame stays pending), fewer while pipeline_depth
        fills; end_video() still flushes the final frame. The batch's
        pairs run through one FlowNet2 forward and its frames through one
        ensemble forward (module docstring)."""
        if self._video_closed:
            raise ValueError("call start_video() first")
        frames = self._norm_frames(frames)
        k = frames.shape[0]
        if k == 0:
            return []
        self._ensure_rings(*frames.shape[1:3])
        n0, rlen, v0 = self._n_pushed, self._rlen, self._v0

        def staged(g):  # global frame -> slot of (ring, then the batch)
            return np.where(g >= n0, rlen + g - n0, g % rlen)

        live = []  # (pair's global frames, tpos, boxes_pad, nb) per scored frame
        prev = self._last
        for j in range(k):
            g, pos = n0 + j, n0 + j - v0
            bp, nb = self._pad_boxes(boxes_list[j])
            if pos == 0:
                self._first = frames[j]
                live.append(((g, g), 0, bp, nb))
            elif pos >= 2:  # pos 1's pair (f0, f1) is used by no frame
                live.append(((g - 1, g), pos - 1, prev[1], prev[2]))
            prev = (frames[j], bp, nb)
        self._last = prev

        frames_t = self._color(_upload(frames, self.device))
        glob = n0 + np.arange(k)
        outs = None
        if live:
            n = len(live)
            tpos = np.array([t for _, t, _, _ in live])
            t0 = v0 + tpos[0]  # scored frames are consecutive from t0
            win = np.stack([v0 + _predict_window(t, self.ctx) for t in tpos])
            owin = np.stack([v0 + _predict_window(t, self.ctx_of) for t in tpos])
            ostaged = np.where(owin >= t0, self.R_of + owin - t0, owin % self.R_of)
            pair_t, win_t, owin_t, okeep_t = self._indices(
                (staged(np.array([p for p, _, _, _ in live])), rlen + k),
                (staged(win), rlen + k), (ostaged, self.R_of + n),
                ((v0 + tpos[-self.R_of:]) % self.R_of, self.R_of),
            )
            src = torch.cat([self._ring, frames_t])
            flows = self._live_flow(
                src.index_select(0, pair_t).reshape((n, 2) + src.shape[1:]))
            fsrc = torch.cat([self._flow_ring, flows])
            wd = src.index_select(0, win_t).reshape((n, -1) + src.shape[1:])
            owd = fsrc.index_select(0, owin_t).reshape((n, -1) + fsrc.shape[1:])
            boxes = np.stack([bp for _, _, bp, _ in live])
            outs = self._score_windows(wd, owd, _upload(boxes, self.device))
            self._flow_ring[okeep_t] = flows[-self.R_of:]
        (keep_t,) = self._indices((glob[-rlen:] % rlen, rlen))
        self._ring[keep_t] = frames_t[-rlen:]
        self._n_pushed += k
        if outs is None:
            return []
        return self._emit_rows(outs, [(bp, nb, False) for _, _, bp, nb in live])

    def time_device_step(self, frame: np.ndarray, boxes: np.ndarray,
                         k: int = 16, repeats: int = 3) -> float:
        """Device-time twin of a scoring push(): best ms per live step
        (ring write, the pair's FlowNet2 forward, STC and the ensemble)
        with its inputs staged once (StreamingScorer.time_device_step's
        protocol). Runs on clones of the rings: serving state is
        untouched."""
        frame = self._norm_frame(frame)
        boxes_pad, _ = self._pad_boxes(boxes)
        self._ensure_rings(*frame.shape[:2])
        pos = max(self._n_pushed - self._v0, 2)
        slot = self._n_pushed % self._rlen
        args = (_upload(frame, self.device), slot,
                *self._flow_args(pos - 1, slot, (self._n_pushed - 1) % self._rlen),
                _upload(boxes_pad, self.device))
        with torch.no_grad():
            return _time_device_chain(self, lambda: self._flow_step(*args), k,
                                      repeats)

    @torch.no_grad()
    def end_video(self) -> Optional[float]:
        """Flush the current video's last frame: its pair is flow(N-2 ->
        N-1) for N >= 3 and the degenerate (f0, f0) for N = 2 (the tail
        window of a 2-frame video is still the head window [0, 0, 1]).
        Returns its score (or an earlier pending one under pipeline_depth;
        None for an empty or 1-frame video)."""
        if self._video_closed:
            return None
        self._video_closed = True
        n = self._n_pushed - self._v0
        if n < 2:
            return None  # 0 frames, or 1 frame already scored at push 0
        _, boxes_pad, nb = self._last
        g = self._n_pushed - 1
        if n == 2:
            # pair (f0, f0): re-send f0 to its own slot, idempotently
            frame = self._first
            slot = prev_slot = self._v0 % self._rlen
        else:
            # pair (N-2, N-1): re-send the last frame to its own slot
            frame = self._last[0]
            slot = g % self._rlen
            prev_slot = (g - 1) % self._rlen
        out = self._flow_step(_upload(frame, self.device), slot,
                              *self._flow_args(n - 1, slot, prev_slot),
                              _upload(boxes_pad, self.device))
        return self._emit(out, boxes_pad, nb)


class MultiCameraFlowScorer(FlowStreamingScorer):
    """Fleet serving with live flow: C tick-synchronised camera streams,
    each tick's C frame pairs through one FlowNet2 forward and the C
    frames' cubes through one ensemble forward.

    Emission follows FlowStreamingScorer's flow lag per tick: tick 0
    returns every camera's frame-0 score (degenerate (f0, f0) pairs),
    tick 1 returns None, tick u returns the frame u-1 scores, and
    end_video() flushes the last frames. Camera streams share fleet-wide
    video boundaries (start_video / end_video cut ALL cameras); for
    per-camera mid-stream cuts, serve that camera with its own
    FlowStreamingScorer. Each camera's scores equal FlowStreamingScorer's
    on that camera up to the batch's summation order.
    """

    def __init__(self, cfg, state_dict=None, stats=None, *, n_cameras,
                 mesh=None, **kw):
        """n_cameras: the fleet's C; mesh: a parallel.mesh.Mesh (or a list
        of devices) to serve the fleet over, C / n cameras an entry with
        a FlowNet2 replica each (the given flow_net, on the first entry,
        and a copy of it on every other); C must divide over it."""
        self.C, n = _fleet_arity(n_cameras, mesh)
        _fleet_device(mesh, kw)
        super().__init__(cfg, state_dict, stats, **kw)
        self._Cs = self.C // n
        flow_net = kw["flow_net"]
        self._replicas = _fleet_replicas(self, mesh, lambda d: type(self)(
            cfg, state_dict, stats, n_cameras=self._Cs,
            **{**kw, "device": d, "flow_net": copy.deepcopy(flow_net).to(d)}))
        self._cam_scene = np.ones(self.C, np.int64)
        self._tick = 0
        self._tick_v0 = 0
        self._first_frames = None
        self._last_tick = None  # (frames, boxes_pad, nbs) of the newest tick

    # -- fleet stream state ----------------------------------------------

    def start_video(self, scene=1) -> None:
        """Start a fleet-wide video on every camera; `scene` is an int or
        a per-camera sequence selecting block-grid scene rows."""
        if self._tick > self._tick_v0 and not self._video_closed:
            raise ValueError(
                "end_video() must flush the previous videos before "
                "start_video()"
            )
        self._tick_v0 = self._tick
        self._cam_scene[:] = np.asarray(scene, np.int64)
        self._video_closed = False
        self._first_frames = None

    def push(self, *a, **kw):
        raise NotImplementedError("MultiCameraFlowScorer scores per tick; "
                                  "use push_tick")

    # the inherited single-camera forms would run against the fleet's
    # (C, ...) rings and per-tick state
    push_many = push

    def time_device_step(self, *a, **kw):
        raise NotImplementedError(
            "MultiCameraFlowScorer times per tick; use time_device_tick"
        )

    def _staged_ticks(self, frames, tpos: int, slot: int, prev_slot: int,
                      boxes_pad):
        """(entry scorer, its tick_step arguments) for every mesh entry:
        its cameras' frames and boxes and the slot math, identical for
        every camera (the fleet is tick-synchronised), on its device."""
        v0 = self._tick_v0
        groups = (((prev_slot, slot), self._rlen),
                  (self._windows(tpos, v0, self.ctx, self._rlen), self._rlen),
                  (self._windows(tpos, v0, self.ctx_of, self.R_of), self.R_of))
        out = []
        for rep, cams in self._entries():
            pair_t, win_t, owin_t = rep._indices(*groups)
            out.append((rep, (_upload(frames[cams], rep.device), slot,
                              (v0 + tpos) % self.R_of, pair_t, win_t, owin_t,
                              _upload(boxes_pad[cams], rep.device))))
        return out

    def _tick_step(self, frames_t, slot, of_slot, pair_t, win_t, owin_t,
                   boxes_t) -> torch.Tensor:
        """One live tick on the device: ring writes, the C pairs' flow in
        one forward, then the C frames' scores. -> (C, B*K + K)"""
        self._ring[:, slot] = self._color(frames_t)
        self._flow_ring[:, of_slot] = self._live_flow(
            self._ring.index_select(1, pair_t))
        return self._score_windows(self._ring.index_select(1, win_t),
                                   self._flow_ring.index_select(1, owin_t),
                                   boxes_t)

    @torch.no_grad()
    def push_tick(self, frames, boxes_list) -> Optional[List[float]]:
        """Score one frame per camera; returns the PREVIOUS tick's C
        scores (this tick's at tick 0; None at tick 1 and while any
        pipeline_depth fills)."""
        if self._video_closed:
            raise ValueError("call start_video() first")
        pos = self._tick - self._tick_v0
        frames, boxes_pad, nbs = self._norm_tick(frames, boxes_list)
        self._ensure_rings(*frames.shape[1:3])
        slot = self._tick % self._rlen
        outs = None
        if pos == 0:
            sb, snb = boxes_pad, nbs
            self._first_frames = frames
            outs = self._run_ticks(self._staged_ticks(frames, 0, slot, slot, sb))
        elif pos == 1:
            for rep, cams in self._entries():
                rep._ring[:, slot] = rep._color(_upload(frames[cams], rep.device))
        else:
            _, sb, snb = self._last_tick
            prev = (self._tick - 1) % self._rlen
            outs = self._run_ticks(
                self._staged_ticks(frames, pos - 1, slot, prev, sb))
        self._tick += 1
        self._last_tick = (frames, boxes_pad, nbs)
        if outs is None:
            return None
        return self._emit_tick(outs, sb, snb)

    def time_device_tick(self, frames, boxes_list, k: int = 8,
                         repeats: int = 3) -> float:
        """Device-time twin of a live tick: best ms per tick (C ring
        writes, one FlowNet2 forward over the C pairs, one ensemble
        forward over the C*K cubes), inputs staged once
        (serve._common._time_device_chain). Runs on clones of the rings:
        the fleet's serving state is untouched."""
        frames, boxes_pad, _ = self._norm_tick(frames, boxes_list)
        self._ensure_rings(*frames.shape[1:3])
        pos = max(self._tick - self._tick_v0, 2)
        slot = self._tick % self._rlen
        staged = self._staged_ticks(frames, pos - 1, slot,
                                    (self._tick - 1) % self._rlen, boxes_pad)
        with torch.no_grad():
            return _time_device_chain(self, lambda: self._run_ticks(staged), k,
                                      repeats)

    @torch.no_grad()
    def end_video(self) -> Optional[List[float]]:
        """Flush every camera's last frame (FlowStreamingScorer.end_video's
        tail pair rule)."""
        if self._video_closed:
            return None
        self._video_closed = True
        n = self._tick - self._tick_v0
        if n < 2:
            return None
        _, boxes_pad, nbs = self._last_tick
        g = self._tick - 1
        if n == 2:
            frames = self._first_frames
            slot = prev_slot = self._tick_v0 % self._rlen
        else:
            frames = self._last_tick[0]
            slot = g % self._rlen
            prev_slot = (g - 1) % self._rlen
        outs = self._run_ticks(
            self._staged_ticks(frames, n - 1, slot, prev_slot, boxes_pad))
        return self._emit_tick(outs, boxes_pad, nbs)

    # the fleet's mesh entries, rings, tick inputs and result plumbing are
    # the precomputed-flow fleet's
    _entries = MultiCameraScorer._entries
    _run_ticks = MultiCameraScorer._run_ticks
    _ensure_rings = MultiCameraScorer._ensure_rings
    _norm_tick = MultiCameraScorer._norm_tick
    _emit_tick = MultiCameraScorer._emit_tick
    drain = MultiCameraScorer.drain
    _finish_tick = MultiCameraScorer._finish_tick
