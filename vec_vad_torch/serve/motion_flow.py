"""Fully self-contained two-stream serving: raw frames in, scores out
(vec_vad_tpu/serve/motion_flow.py). Foreground boxes are computed in the
loop by the reference's motion recipe (serve.motion) and optical flow on
the device from the frame ring by calc-flow's protocol: nothing is
precomputed, no bbox source and no flow tree.

Per push of frame u, one step on the device:

  * writes frame u into the raw ring,
  * computes the flow of the SCORED frame u-2 with FlowNet2 from its
    reference pair in the ring (calc_optical_flow.py's rule: head (f0,
    f0), mid (t, t+1), tail (N-2, N-1); a 2-frame video gives (f0, f0)
    for both frames) and writes it to the flow ring,
  * scores frame u-2 with the boxes of ITS motion map and the fresh
    flow, the motion-magnitude cube filter included,
  * computes the motion map of frame u-1, as MotionStreamingScorer does.

A map-only step (the conveyor's fill and end_video's tail) runs neither
FlowNet2 nor the ensemble: a branch on the host, where the JAX package
takes a `lax.cond` inside its jitted step.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from vec_vad_torch.flow.driver import cast_flow_net
from vec_vad_torch.serve._common import _upload, _valid_rows
from vec_vad_torch.serve.live_flow import FlowStreamingScorer
from vec_vad_torch.serve.motion import MotionStreamingScorer


class MotionFlowStreamingScorer(MotionStreamingScorer):
    """`push(frame)` is the whole input: the "switch on a camera" mode for
    two-stream models. Scores emerge with MotionStreamingScorer's 3-push
    lag, and end_video() flushes the tail with the now-known tail-clamped
    motion windows and tail flow pairs. `push(frame, ap_boxes=...)` still
    merges appearance boxes; `flow=` is refused (flow is computed in the
    loop)."""

    def __init__(self, cfg, state_dict=None, stats=None, *, flow_net,
                 flow_model_hw=(384, 512), flow_compute_dtype=torch.float32,
                 **kw):
        """flow_net, flow_model_hw and flow_compute_dtype as in
        FlowStreamingScorer: a FlowNet2 on this scorer's device, the
        protocol's model size, and the forward's dtype (a bf16 copy of
        the weights is made once; the flow returns to float32)."""
        if not cfg.model.use_flow:
            raise ValueError(
                "MotionFlowStreamingScorer serves two-stream models; use "
                "MotionStreamingScorer for raw-only (use_flow=False)"
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
        self._streams_flow = False

    # FlowNet2 on frame pairs by calc-flow's resize protocol
    _live_flow = FlowStreamingScorer._live_flow

    def push(self, frame: np.ndarray, ap_boxes=None,
             flow: Optional[np.ndarray] = None) -> Optional[float]:
        if flow is not None:
            raise ValueError(
                "MotionFlowStreamingScorer computes flow in the loop; "
                "streaming flow maps is MotionStreamingScorer's job"
            )
        return super().push(frame, ap_boxes)

    def _flow_pair(self, scored: int, tail_hint) -> tuple:
        """The scored frame's within-video flow-pair positions, following
        flow.driver.flow_pair_indices on a standalone video: (0, 0) at the
        head, (t, t+1) mid-video, (N-2, N-1) at the tail, and (0, 0) for
        BOTH frames of a 2-frame video (the live-flow scorers' convention,
        FlowStreamingScorer.end_video)."""
        if scored == 0:
            return 0, 0
        if tail_hint is not None and scored == tail_hint - 1:
            if tail_hint == 2:
                return 0, 0
            return scored - 1, scored
        return scored, scored + 1

    def _motion_args(self, frame_t, flow_t, pos, scored, mapped, tail_hint,
                     boxes_pad, nb) -> tuple:
        """As MotionStreamingScorer's, with the scored frame's flow slot
        and its flow pair's ring slots (flow_t is unused)."""
        v0, rlen, orlen = self._v0, self._rlen, self._of_rlen
        s = max(scored, 0)
        rows, n_valid = _valid_rows([nb], self.K)
        win_t, owin_t, mwin_t, pair_t, rows_t = self._indices(
            (self._windows(s, v0, self.ctx, rlen), rlen),
            (self._windows(s, v0, self.ctx_of, orlen), orlen),
            (self._mwin(mapped, tail_hint), rlen),
            ((v0 + np.array(self._flow_pair(s, tail_hint))) % rlen, rlen),
            (rows, self.K),
        )
        return (frame_t, pair_t, (v0 + pos) % rlen, (v0 + s) % orlen,
                win_t, owin_t, mwin_t,
                (_upload(boxes_pad, self.device), rows_t, n_valid),
                scored >= 0, mapped >= 0)

    def _motion_step(self, frame_t, pair_t, slot, of_slot, win_t, owin_t,
                     mwin_t, box_set, score, mapped) -> torch.Tensor:
        """Write the frame; when scoring, the pair's flow into the flow
        ring and the scored frame's scores; then the mapped frame's map."""
        self._write_frame(slot, frame_t)
        out = None
        if score:
            pair = self._ring.index_select(0, pair_t)  # (2, H, W, 3) uint8
            self._flow_ring[of_slot] = self._live_flow(pair[None])[0]
            out = self._score_from_rings(win_t, owin_t, box_set)
        return self._result(out, mwin_t if mapped else None)

    def time_device_step(self, frame, boxes, k: int = 16,
                         repeats: int = 3) -> float:
        """Device-time twin of a scoring push's step (ring write, the
        pair's FlowNet2 forward, STC and the ensemble, the motion map):
        MotionStreamingScorer.time_device_step's protocol."""
        return super().time_device_step(frame, boxes, k, repeats)
