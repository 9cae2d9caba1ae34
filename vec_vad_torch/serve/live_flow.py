"""Live-flow serving: optical flow computed on the device inside each push
(vec_vad_tpu/serve/live_flow.py:26-344, the single-stream scorer).

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

MultiCameraFlowScorer, push_many and time_device_step are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from vec_vad_torch.device import full_f32
from vec_vad_torch.flow.driver import cast_flow_net, resize_bilinear
from vec_vad_torch.serve._common import _predict_window
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
        """flow_net: a module mapping (1, 2, mh, mw, 3) frame pairs in
        0..255 to (1, mh, mw, 2) flow (models.flownet.FlowNet2), on this
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

    def _flow_step(self, frame, tpos, slot, prev_slot, boxes_pad) -> torch.Tensor:
        """Write `frame` to ring slot `slot`, compute the flow of the pair
        (prev_slot, slot) into within-video frame tpos's flow slot, and
        score frame tpos."""
        self._write_frame(slot, frame)
        of_slot = (self._v0 + tpos) % self.R_of
        win = (self._v0 + _predict_window(tpos, self.ctx)) % self._rlen
        owin = (self._v0 + _predict_window(tpos, self.ctx_of)) % self.R_of
        pair_t, win_t, owin_t = self._indices(
            ((prev_slot, slot), self._rlen), (win, self._rlen),
            (owin, self.R_of),
        )
        H, W = self._ring.shape[1], self._ring.shape[2]
        mh, mw = self._flow_hw
        pair = self._ring.index_select(0, pair_t)  # (2, H, W, 3) uint8
        # the driver's protocol (flow/driver.py run_chunk): cv2-parity
        # resize to the model size, forward, resize back WITHOUT rescaling;
        # an f32 route runs with TF32 off
        with full_f32(self._flow_dtype):
            pr = resize_bilinear(pair, mh, mw).to(self._flow_dtype)
            flow = self.flow_net(pr[None]).float()
            self._flow_ring[of_slot] = resize_bilinear(flow, H, W)[0]
            return self._score_from_rings(win_t, owin_t, boxes_pad)

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
        out = None
        if pos == 0:
            # frame 0's pair is (f0, f0): score it in the same push
            sb, snb = boxes_pad, nb
            self._first = frame
            out = self._flow_step(frame, 0, slot, slot, sb)
        elif pos == 1:
            # flow(0 -> 1) is used by no frame: only advance the ring
            self._write_frame(slot, frame)
        else:
            _, sb, snb = self._last
            out = self._flow_step(frame, pos - 1, slot,
                                  (self._n_pushed - 1) % self._rlen, sb)
        self._n_pushed += 1
        self._last = (frame, boxes_pad, nb)
        if out is None:
            return None  # nothing emitted: frame 1 waits for f_2
        return self._emit(out, sb, snb)

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
        out = self._flow_step(frame, n - 1, slot, prev_slot, boxes_pad)
        return self._emit(out, boxes_pad, nb)
