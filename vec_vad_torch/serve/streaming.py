"""Single-stream online scorer over a device-resident frame ring
(vec_vad_tpu/serve/streaming.py).

Per push: the frame goes into a ring tensor on the device, the frame's
'predict' context window is gathered from the ring, STC cubes are cut for
its padded box set, every block's completion ensemble scores them, and
one (B*K + K,) result vector (block scores, then motion magnitudes) comes
back to the host, where grid routing reduces it to the frame score
(test.py:282-357 semantics). With pipeline_depth d, push(frame_t) returns
the score of frame t-d: torch queues the device work asynchronously and
only the host reduction waits.

Left for a later slice: push_many (micro-batching), time_device_step,
the fleet scorers and a bf16 scoring dtype.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from vec_vad_torch.config import PipelineConfig
from vec_vad_torch.device import resolve_device
from vec_vad_torch.models.completion import make_completion_net
from vec_vad_torch.ops.stc import cube_to_input, extract_stc, flow_magnitude
from vec_vad_torch.score.scoring import BIG_NUMBER, degenerate_boxes
from vec_vad_torch.serve._common import _predict_window
from vec_vad_torch.utils.blocks import calc_block_idx


class StreamingScorer:
    """Usage:
        scorer = StreamingScorer.from_model(model)   # all trained blocks
        scorer.start_video()                         # per video (scene=N)
        for frame, boxes, flow in camera_feed:
            score = scorer.push(frame, boxes, flow=flow)

    `push` returns the frame-level anomaly score: the max over the frame's
    valid, non-degenerate (and motion-passing, when flow is streamed) box
    scores — each box scored by the block(s) its grid cell routes to, with
    big_number for untrained cells — or -big_number for a frame with no
    scoring boxes. Only border_mode='predict' is causal and can stream.
    """

    def __init__(
        self,
        cfg: PipelineConfig,
        state_dict=None,
        stats: Optional[Tuple[float, ...]] = None,
        *,
        blocks: Optional[Dict[tuple, tuple]] = None,
        max_boxes: Optional[int] = None,
        big_number: float = BIG_NUMBER,
        pipeline_depth: int = 0,
        gray_stream: bool = False,
        route_hw: Optional[Tuple[int, int]] = None,
        device="cuda",
    ):
        """Single-block form: (state_dict, stats) serve every box (a 1x1
        grid at block key (0, 0, 0)). Grid form: `blocks` maps
        (scene-1, h, w) -> (state_dict, (mu_r, sd_r, mu_o, sd_o[, of_on])).

        gray_stream: frames are (H, W) uint8, replicated to 3 channels on
        the device (cv2.imread's gray->BGR). route_hw: the geometry the
        model's cubes were extracted at (defaults to the dataset table's),
        which block routing must use."""
        mc = cfg.model
        if mc.border_mode != "predict":
            raise ValueError(
                "online serving requires the causal 'predict' border mode; "
                f"got {mc.border_mode!r}"
            )
        self.device = resolve_device(device)
        self.cfg = cfg
        self.big_number = float(big_number)
        self.K = int(max_boxes or cfg.fore.max_boxes_per_frame)
        self.P = int(cfg.fore.patch_size)
        self.R = int(mc.tot_raw_num)
        self.R_of = int(mc.tot_of_num)
        self.ctx = int(mc.context_frame_num)
        self.ctx_of = int(mc.context_of_num)
        self.use_flow = bool(mc.use_flow)
        self.route_hw = (
            tuple(route_hw) if route_hw is not None else cfg.dataset.frame_hw
        )

        if blocks is None:
            if state_dict is None:
                raise ValueError("pass (state_dict, stats) or blocks=")
            blocks = {(0, 0, 0): (state_dict, tuple(stats))}
        self._keys = sorted(blocks)
        self.B = len(self._keys)
        self._kidx = {k: i for i, k in enumerate(self._keys)}
        self.nets = []
        for k in self._keys:
            net = make_completion_net(mc, self.device)
            net.load_state_dict(blocks[k][0])
            self.nets.append(net)
        # stats rows (mu_r, sd_r, mu_o, sd_o, of_on); a 4-tuple means
        # of_on=1, and of_on=0 marks a block trained without a flow stream
        # (its score is raw-only, like the offline fuse_scores degradation)
        self._stats = torch.as_tensor(
            np.array(
                [tuple(blocks[k][1]) + (1.0,) * (5 - len(blocks[k][1]))
                 for k in self._keys],
                np.float32,
            ),
            device=self.device,
        )  # (B, 5)

        self._rlen = self.R  # raw ring length
        self._ring = None  # (rlen, H, W, 3) uint8, allocated on first push
        self._flow_ring = None  # (R_of, H, W, 2) float32
        self._n_pushed = 0  # global frames pushed (ring write counter)
        self._v0 = 0  # value of _n_pushed when the current video started
        self._scene = 1
        self.pipeline_depth = int(pipeline_depth)
        self.gray_stream = bool(gray_stream)
        self._pending: deque = deque()  # in flight: (out, boxes, nb, scene, skip_mag)

    # -- constructors ---------------------------------------------------

    @classmethod
    def from_model(cls, model, key=None, **kw) -> "StreamingScorer":
        """Serve a VadModel: all trained blocks of its (scene, h, w) grid
        (`key` restricts to one block)."""

        def pack(blk):
            mu_r, sd_r = blk.raw_stats
            of = blk.of_stats
            mu_o, sd_o = of if of is not None else (0.0, 1.0)
            return (
                blk.state_dict,
                (mu_r, sd_r, mu_o, sd_o, 0.0 if of is None else 1.0),
            )

        keys = [key] if key is not None else sorted(model.blocks)
        blocks = {k: pack(model.blocks[k]) for k in keys}
        return cls(model.cfg, None, None, blocks=blocks, **kw)

    # -- device-side pieces of the per-frame step -------------------------

    def _ensure_rings(self, h: int, w: int) -> None:
        if self._ring is not None:
            return
        self._ring = torch.zeros(
            (self._rlen, h, w, 3), dtype=torch.uint8, device=self.device
        )
        self._flow_ring = torch.zeros(
            (self.R_of, h, w, 2), dtype=torch.float32,
            device=self.device,
        )

    def _indices(self, *groups) -> List[torch.Tensor]:
        """Upload small index groups as ONE int64 tensor, each group clamped
        into its ring first (jnp.take(..., mode='clip') semantics); returns
        the per-group device slices. groups: (indices, ring_length)."""
        parts = [np.clip(np.asarray(ix, np.int64), 0, n - 1)
                 for ix, n in groups]
        flat = torch.as_tensor(np.concatenate(parts), device=self.device)
        return list(torch.split(flat, [p.size for p in parts]))

    def _write_frame(self, slot: int, frame: np.ndarray) -> None:
        t = torch.from_numpy(frame).to(self.device)
        if self.gray_stream:
            # cv2.imread replicates gray sources across BGR exactly
            t = t.reshape(t.shape[0], t.shape[1], 1).expand(-1, -1, 3)
        self._ring[slot] = t

    def _score_from_rings(self, win, owin, boxes_pad) -> torch.Tensor:
        """(B*K + K,) float32 on the device: block scores, then per-box
        motion magnitudes (inf when no flow stream is served)."""
        P, K = self.P, self.K
        mc = self.cfg.model
        boxes = torch.as_tensor(boxes_pad, device=self.device)
        cubes = extract_stc(self._ring.index_select(0, win), boxes, P,
                            quantize=True)
        # uint8 round trip: bit-identical to the offline uint8 cube buffer
        x = cube_to_input(cubes, scale=False).to(torch.uint8).float() / 255.0
        if self.use_flow:
            fcubes = extract_stc(self._flow_ring.index_select(0, owin), boxes,
                                 P, quantize=False)
            mag = flow_magnitude(fcubes)
            x_of = cube_to_input(fcubes, scale=False)
        else:
            mag = torch.full((K,), float("inf"), device=self.device)
            x_of = None

        scores = []
        for net, st in zip(self.nets, self._stats):
            out = net(x, x_of)
            sc = torch.sum(torch.square(out.raw_out - out.raw_tgt),
                           dim=(0, 2, 3, 4))
            score = mc.w_raw * (sc - st[0]) / st[1]
            if out.of_out is not None:
                osc = torch.sum(torch.square(out.of_out - out.of_tgt),
                                dim=(0, 2, 3, 4))
                # st[4] gates blocks trained without a flow stream
                score = score + st[4] * mc.w_of * (osc - st[2]) / st[3]
            scores.append(score)
        return torch.cat([torch.stack(scores).reshape(-1), mag])

    # -- host helpers ------------------------------------------------------

    def _norm_frame(self, frame: np.ndarray) -> np.ndarray:
        frame = np.asarray(frame, np.uint8)
        if self.gray_stream:
            if frame.ndim == 3:
                frame = frame[..., 0]
        elif frame.ndim != 3:
            raise ValueError("3-channel frame expected (or gray_stream=True)")
        return np.ascontiguousarray(frame)

    def _pad_boxes(self, boxes) -> Tuple[np.ndarray, int]:
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        nb = boxes.shape[0]
        if nb > self.K:
            raise ValueError(f"{nb} boxes > max_boxes={self.K}")
        boxes_pad = np.zeros((self.K, 4), np.float32)
        boxes_pad[:nb] = boxes
        return boxes_pad, nb

    def _emit(self, out, boxes_pad, nb, skip_mag=False) -> Optional[float]:
        self._pending.append((out, boxes_pad, nb, self._scene, skip_mag))
        if len(self._pending) <= self.pipeline_depth:
            return None  # pipeline still filling
        return self._finish(*self._pending.popleft())

    # -- streaming API ---------------------------------------------------

    def start_video(self, scene: int = 1) -> None:
        """Mark a video boundary: context windows never cross it. `scene`
        selects the scene row of the block grid (1-based)."""
        self._v0 = self._n_pushed
        self._scene = int(scene)

    @torch.no_grad()
    def push(self, frame: np.ndarray, boxes: np.ndarray,
             flow: Optional[np.ndarray] = None) -> Optional[float]:
        """Score one frame: (H, W, 3) uint8 ((H, W) when gray_stream), an
        (n, 4) xyxy box array, and for a flow-fusing model its (H, W, 2)
        flow map. flow=None on such a model degrades like the offline
        pipeline without a flow tree: zero flow cubes, motion filter
        bypassed. Returns the score of the frame pushed pipeline_depth
        calls ago (None while the pipeline fills)."""
        frame = self._norm_frame(frame)
        self._ensure_rings(*frame.shape[:2])
        pos = self._n_pushed - self._v0
        boxes_pad, nb = self._pad_boxes(boxes)
        slot = self._n_pushed % self._rlen
        win = (self._v0 + _predict_window(pos, self.ctx)) % self._rlen
        owin = (self._v0 + _predict_window(pos, self.ctx_of)) % self.R_of
        win_t, owin_t = self._indices((win, self._rlen), (owin, self.R_of))
        skip_mag = False
        self._write_frame(slot, frame)
        if self.use_flow:
            of_slot = self._n_pushed % self.R_of
            if flow is None:
                self._flow_ring[of_slot] = 0.0
                skip_mag = True
            else:
                self._flow_ring[of_slot] = torch.as_tensor(
                    np.asarray(flow, np.float32), device=self.device
                )
        out = self._score_from_rings(win_t, owin_t, boxes_pad)
        self._n_pushed += 1
        return self._emit(out, boxes_pad, nb, skip_mag)

    def drain(self) -> List[float]:
        """Materialize and return the scores still in flight (stream end)."""
        out = [self._finish(*e) for e in self._pending]
        self._pending.clear()
        return out

    def _finish(self, out, boxes_pad, nb, scene, skip_mag=False) -> float:
        return self._finish_host(
            out.cpu().numpy(), boxes_pad, nb, scene, skip_mag
        )

    def _finish_host(self, out, boxes_pad, nb, scene, skip_mag=False) -> float:
        """Score reduction on a downloaded result vector: host-side grid
        routing (test.py:282-310) by route_hw geometry, like the offline
        paths."""
        smat = out[: self.B * self.K].reshape(self.B, self.K)
        mag = out[self.B * self.K : self.B * self.K + self.K]

        keep = np.zeros(self.K, bool)
        keep[:nb] = True
        keep &= ~degenerate_boxes(boxes_pad)
        if self.use_flow and not skip_mag:
            keep &= mag > self.cfg.fore.motion_thr

        fc = self.cfg.fore
        h_step = self.route_hw[0] / fc.h_block
        w_step = self.route_hw[1] / fc.w_block
        best = None
        for k in np.nonzero(keep)[0]:
            b = boxes_pad[k]
            for (hc, wc) in calc_block_idx(
                b[0], b[2], b[1], b[3], h_step, w_step, fc.test_block_mode
            ):
                i = self._kidx.get((scene - 1, hc, wc))
                cand = self.big_number if i is None else float(smat[i, k])
                best = cand if best is None else max(best, cand)
        return -self.big_number if best is None else best
