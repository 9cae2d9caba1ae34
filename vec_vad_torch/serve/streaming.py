"""Single-stream online scorer over a device-resident frame ring
(vec_vad_tpu/serve/streaming.py).

Per push: the frame goes into a ring tensor on the device, the frame's
'predict' context window is gathered from the ring, STC cubes are cut for
its padded box set, every block's completion ensemble scores the cubes of
the frame's boxes alone (the valid rows, padded to a bucket of ROW_BUCKET
rows: serve._common._valid_rows), and one (B*K + K,) result vector (block
scores, then motion magnitudes) comes back to the host, where grid
routing reduces it to the frame score (test.py:282-357 semantics). The
JAX package scores all K padded rows, since XLA needs the fixed shape;
their scores are never read. Scoring runs in `compute_dtype` (float32
with TF32 off, or bfloat16).

`push_many` scores k frames of the current video in one ensemble forward
over the valid rows of their k*K cubes, gathering each frame's window
from a staging copy of the ring followed by the batch (writing all k
frames into the R-slot ring first would overwrite windows the batch's
earlier frames still need), and downloads the k results once. With
pipeline_depth d, push(frame_t) returns the score of frame t-d: each
step's uploads are non-blocking and its result's download starts when
the step is queued, so the host waits for step t-d's copy only.
`time_device_step` times the device step alone on clones of the rings
(serve._common._time_device_chain).
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from vec_vad_torch.config import PipelineConfig
from vec_vad_torch.device import full_f32, resolve_device, resolve_dtype
from vec_vad_torch.infer import _forward_fn
from vec_vad_torch.models.completion import make_completion_net
from vec_vad_torch.ops.stc import cube_to_input, extract_stc, flow_magnitude
from vec_vad_torch.runtime.profiling import annotate
from vec_vad_torch.score.scoring import BIG_NUMBER, degenerate_boxes
from vec_vad_torch.serve._common import (
    _download_async,
    _host_result,
    _predict_window,
    _time_device_chain,
    _upload,
    _valid_rows,
)
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
        compute_dtype=torch.float32,
        big_number: float = BIG_NUMBER,
        pipeline_depth: int = 0,
        gray_stream: bool = False,
        route_hw: Optional[Tuple[int, int]] = None,
        device="cuda",
    ):
        """Single-block form: (state_dict, stats) serve every box (a 1x1
        grid at block key (0, 0, 0)). Grid form: `blocks` maps
        (scene-1, h, w) -> (state_dict, (mu_r, sd_r, mu_o, sd_o[, of_on])).

        compute_dtype: the ensemble's dtype (a torch dtype or its name):
        float32, run with TF32 off (device.full_f32), or bfloat16, with
        the weights and running statistics cast once, the cubes cast
        after their uint8 round trip and the errors summed in float32,
        as the JAX package casts. gray_stream: frames are (H, W) uint8,
        replicated to 3 channels on the device (cv2.imread's gray->BGR).
        route_hw: the geometry the model's cubes were extracted at
        (defaults to the dataset table's), which block routing must use.
        pipeline_depth: see the module docstring; scores equal depth 0's
        bit for bit."""
        mc = cfg.model
        if mc.border_mode != "predict":
            raise ValueError(
                "online serving requires the causal 'predict' border mode; "
                f"got {mc.border_mode!r}"
            )
        self.device = resolve_device(device)
        self.cfg = cfg
        self.compute_dtype = resolve_dtype(compute_dtype)
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
        # one eval forward per block, in compute_dtype (infer._forward_fn)
        self._forwards = [
            _forward_fn(make_completion_net(mc, self.device), blocks[k][0],
                        self.compute_dtype)
            for k in self._keys
        ]
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
        # in flight: (result handle, boxes, nb, scene, skip_mag)
        self._pending: deque = deque()

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
        parts = [np.clip(np.asarray(ix, np.int64).reshape(-1), 0, n - 1)
                 for ix, n in groups]
        flat = _upload(np.concatenate(parts), self.device)
        return list(torch.split(flat, [p.size for p in parts]))

    def _color(self, t: torch.Tensor) -> torch.Tensor:
        """Frames (..., H, W, 3), or (..., H, W) of a gray stream replicated
        to 3 channels (cv2.imread's gray->BGR is an exact copy)."""
        return t[..., None].expand(t.shape + (3,)) if self.gray_stream else t

    def _write_frame(self, slot: int, frame_t: torch.Tensor) -> None:
        self._ring[slot] = self._color(frame_t)

    def _score_windows(self, wd, owd, box_set) -> torch.Tensor:
        """(k, B*K + K) float32 on the device from k gathered windows: per
        frame its block scores, then its boxes' motion magnitudes (inf
        when no flow stream is served). wd: (k, T, H, W, 3) uint8; owd:
        (k, T_of, H, W, 2) float32 (None for a raw-only model); box_set:
        (boxes, rows, n_valid), the (k, K, 4) padded boxes and their row
        set, `rows` on the device (serve._common._valid_rows: the n_valid
        flat rows j*K + b of the frames' boxes, then repeats up to the
        bucket) and its count n_valid on the host.

        Cube extraction over all k*K padded boxes is the `serve.stc` span,
        with the gather of the row set's cubes. One ensemble forward per
        block over those rows alone (eval-mode BatchNorm: no row depends
        on another) and the score arithmetic are `serve.ensemble`; the
        first n_valid scores are written to their rows, the bucket's
        repeats dropped. A block score of a padded row (b >= nbs[j]) is
        unspecified (0.0 here): callers read only a frame's first nb.
        n_valid 0 runs no forward."""
        P, K, dt = self.P, self.K, self.compute_dtype
        boxes, rows, n_valid = box_set
        k = wd.shape[0]
        mc = self.cfg.model
        with full_f32(dt):
            with annotate("serve.stc"):
                cubes = extract_stc(wd, boxes, P, quantize=True)  # (k, K, T, P, P, 3)
                # uint8 round trip: bit-identical to the offline uint8 cube buffer
                x = cube_to_input(cubes, scale=False).to(torch.uint8)
                x = x.reshape((k * K,) + x.shape[2:])
                x = x.index_select(0, rows).to(dt) / 255.0
                if self.use_flow:
                    fcubes = extract_stc(owd, boxes, P, quantize=False)
                    mag = flow_magnitude(fcubes)  # (k, K)
                    x_of = cube_to_input(fcubes, scale=False)
                    x_of = x_of.reshape((k * K,) + x_of.shape[2:])
                    x_of = x_of.index_select(0, rows).to(dt)
                else:
                    mag = torch.full((k, K), float("inf"), device=self.device)
                    x_of = None
            with annotate("serve.ensemble"):
                scores = torch.zeros((self.B, k * K), device=self.device)
                blocks = zip(self._forwards, self._stats) if n_valid else ()
                for b, (forward, st) in enumerate(blocks):
                    out = forward(x, x_of)
                    sc = (out.raw_out - out.raw_tgt).float().square().sum(
                        dim=(0, 2, 3, 4))
                    score = mc.w_raw * (sc - st[0]) / st[1]
                    if out.of_out is not None:
                        osc = (out.of_out - out.of_tgt).float().square().sum(
                            dim=(0, 2, 3, 4))
                        # st[4] gates blocks trained without a flow stream
                        score = score + st[4] * mc.w_of * (osc - st[2]) / st[3]
                    scores[b].index_copy_(0, rows[:n_valid], score[:n_valid])
                scores = scores.reshape(self.B, k, K).transpose(0, 1).reshape(k, -1)
                return torch.cat([scores, mag], 1)

    def _score_from_rings(self, win_t, owin_t, box_set) -> torch.Tensor:
        """(B*K + K,) for one frame whose window slots `win_t` / `owin_t`
        are in the rings; box_set: its (K, 4) boxes, row set and count
        (_score_windows' box_set for one frame)."""
        wd = self._ring.index_select(0, win_t)[None]
        owd = (self._flow_ring.index_select(0, owin_t)[None]
               if self.use_flow else None)
        boxes_t, rows_t, n_valid = box_set
        return self._score_windows(wd, owd, (boxes_t[None], rows_t, n_valid))[0]

    def _step(self, frame_t, flow_t, slot, of_slot, win_t, owin_t,
              box_set) -> torch.Tensor:
        """One push on the device, its inputs already there: the ring
        writes (flow_t None on a flow-fusing model writes zero flow),
        then the frame's scores."""
        self._write_frame(slot, frame_t)
        if self.use_flow:
            if flow_t is None:
                self._flow_ring[of_slot] = 0.0
            else:
                self._flow_ring[of_slot] = flow_t
        return self._score_from_rings(win_t, owin_t, box_set)

    # -- host helpers ------------------------------------------------------

    def _norm_frame(self, frame: np.ndarray) -> np.ndarray:
        frame = np.asarray(frame, np.uint8)
        if self.gray_stream:
            if frame.ndim == 3:
                frame = frame[..., 0]
        elif frame.ndim != 3:
            raise ValueError("3-channel frame expected (or gray_stream=True)")
        return np.ascontiguousarray(frame)

    def _norm_frames(self, frames) -> np.ndarray:
        """A (n, H, W, 3) stack, or (n, H, W) for a gray stream."""
        frames = np.asarray(frames, np.uint8)
        if self.gray_stream:
            if frames.ndim == 4:
                frames = frames[..., 0]
        elif frames.ndim != 4:
            raise ValueError("(n, H, W, 3) frames expected (or gray_stream=True)")
        return np.ascontiguousarray(frames)

    def _pad_boxes(self, boxes) -> Tuple[np.ndarray, int]:
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        nb = boxes.shape[0]
        if nb > self.K:
            raise ValueError(f"{nb} boxes > max_boxes={self.K}")
        boxes_pad = np.zeros((self.K, 4), np.float32)
        boxes_pad[:nb] = boxes
        return boxes_pad, nb

    def _pad_many(self, boxes_list, n: int) -> Tuple[np.ndarray, List[int]]:
        """(n, K, 4) padded boxes and the counts of n per-frame box sets."""
        if len(boxes_list) != n:
            raise ValueError(f"{len(boxes_list)} box sets for {n} frames")
        pads = [self._pad_boxes(b) for b in boxes_list]
        return np.stack([p for p, _ in pads]), [nb for _, nb in pads]

    def _windows(self, pos: int, v0: int, ctx: int, n: int) -> np.ndarray:
        """Ring slots of within-video frame `pos`'s window (ring length n)."""
        return (v0 + _predict_window(pos, ctx)) % n

    def _result_handle(self, out: torch.Tensor):
        """The host side of a step's result: at depth 0 the synchronous
        download; pipelined, a copy started now into pinned memory
        (serve._common._download_async), waited on when it is finished."""
        if self.pipeline_depth > 0:
            return _download_async(out)
        with annotate("serve.wait"):
            return out.cpu(), None

    def _emit_rows(self, outs: torch.Tensor, metas) -> List[float]:
        """Queue k results (rows of outs) with their (boxes_pad, nb,
        skip_mag); returns the scores that leave the pipeline, in order."""
        host, event = self._result_handle(outs)
        scores = []
        for j, (boxes_pad, nb, skip_mag) in enumerate(metas):
            self._pending.append(((host[j], event), boxes_pad, nb,
                                  self._scene, skip_mag))
            if len(self._pending) > self.pipeline_depth:
                scores.append(self._finish(*self._pending.popleft()))
        return scores

    def _emit(self, out, boxes_pad, nb, skip_mag=False) -> Optional[float]:
        got = self._emit_rows(out[None], [(boxes_pad, nb, skip_mag)])
        return got[0] if got else None  # None: the pipeline still fills

    # -- streaming API ---------------------------------------------------

    def start_video(self, scene: int = 1) -> None:
        """Mark a video boundary: context windows never cross it. `scene`
        selects the scene row of the block grid (1-based)."""
        self._v0 = self._n_pushed
        self._scene = int(scene)

    def _stage(self, frame, flow, boxes_pad, nb):
        """One push's host inputs on the device: (frame, flow or None,
        ring slots, window indices, box set: the boxes, the row set of
        their first nb and nb)."""
        pos = self._n_pushed - self._v0
        slot = self._n_pushed % self._rlen
        of_slot = self._n_pushed % self.R_of
        rows, n_valid = _valid_rows([nb], self.K)
        win_t, owin_t, rows_t = self._indices(
            (self._windows(pos, self._v0, self.ctx, self._rlen), self._rlen),
            (self._windows(pos, self._v0, self.ctx_of, self.R_of), self.R_of),
            (rows, self.K),
        )
        flow_t = None
        if self.use_flow and flow is not None:
            flow_t = _upload(np.asarray(flow, np.float32), self.device)
        return (_upload(frame, self.device), flow_t, slot, of_slot, win_t,
                owin_t, (_upload(boxes_pad, self.device), rows_t, n_valid))

    @torch.no_grad()
    def push(self, frame: np.ndarray, boxes: np.ndarray,
             flow: Optional[np.ndarray] = None) -> Optional[float]:
        """Score one frame: (H, W, 3) uint8 ((H, W) when gray_stream), an
        (n, 4) xyxy box array, and for a flow-fusing model its (H, W, 2)
        flow map. flow=None on such a model degrades like the offline
        pipeline without a flow tree: zero flow cubes, motion filter
        bypassed. Returns the score of the frame pushed pipeline_depth
        calls ago (None while the pipeline fills)."""
        with annotate("serve.tick"):
            with annotate("serve.stage"):
                frame = self._norm_frame(frame)
                self._ensure_rings(*frame.shape[:2])
                boxes_pad, nb = self._pad_boxes(boxes)
                args = self._stage(frame, flow, boxes_pad, nb)
            out = self._step(*args)
            self._n_pushed += 1
            return self._emit(out, boxes_pad, nb, self.use_flow and flow is None)

    @torch.no_grad()
    def push_many(self, frames: np.ndarray, boxes_list,
                  flows: Optional[np.ndarray] = None) -> List[float]:
        """Score k consecutive frames of the CURRENT video in one ensemble
        forward and one download, returning their k scores: equal to k
        push() calls. All k frames must belong to the current video (call
        start_video between batches at video boundaries); pipelined push()
        results still in flight stay queued (drain() them). flows=None on
        a flow-fusing model degrades like push(flow=None): zero flow
        cubes, motion filter bypassed."""
        with annotate("serve.tick"):
            with annotate("serve.stage"):
                frames = self._norm_frames(frames)
                k = frames.shape[0]
                if k == 0:
                    return []
                self._ensure_rings(*frames.shape[1:3])
                boxes_pad, nbs = self._pad_many(boxes_list, k)
                skip_mag = self.use_flow and flows is None
                n0, rlen = self._n_pushed, self._rlen
                glob = n0 + np.arange(k)

                def staged(g, n):  # global frame -> slot of (ring of n slots, batch)
                    return np.where(g >= n0, n + g - n0, g % n)

                win = np.stack([self._v0 + _predict_window(g - self._v0, self.ctx)
                                for g in glob])
                owin = np.stack([self._v0 + _predict_window(g - self._v0, self.ctx_of)
                                 for g in glob])
                rows, n_valid = _valid_rows(nbs, self.K)
                win_t, owin_t, keep_t, okeep_t, rows_t = self._indices(
                    (staged(win, rlen), rlen + k),
                    (staged(owin, self.R_of), self.R_of + k),
                    (glob[-rlen:] % rlen, rlen),
                    (glob[-self.R_of:] % self.R_of, self.R_of),
                    (rows, k * self.K),
                )
                frames_t = self._color(_upload(frames, self.device))
                if self.use_flow:
                    flows_t = (
                        torch.zeros(frames_t.shape[:3] + (2,), device=self.device)
                        if flows is None
                        else _upload(np.asarray(flows, np.float32), self.device)
                    )
                boxes_t = _upload(boxes_pad, self.device)
            src = torch.cat([self._ring, frames_t])
            wd = src.index_select(0, win_t).reshape((k, -1) + src.shape[1:])
            owd = None
            if self.use_flow:
                fsrc = torch.cat([self._flow_ring, flows_t])
                owd = fsrc.index_select(0, owin_t).reshape((k, -1) + fsrc.shape[1:])
            outs = self._score_windows(wd, owd, (boxes_t, rows_t, n_valid))
            # the rings keep the newest frames (and flow maps)
            self._ring[keep_t] = frames_t[-rlen:]
            if self.use_flow:
                self._flow_ring[okeep_t] = flows_t[-self.R_of:]
            self._n_pushed += k
            with annotate("serve.wait"):
                outs = outs.cpu().numpy()  # one download for all k frames
            with annotate("serve.finish"):
                return [self._finish_host(outs[j], boxes_pad[j], nbs[j], self._scene,
                                          skip_mag) for j in range(k)]

    def time_device_step(self, frame: np.ndarray, boxes: np.ndarray,
                         k: int = 64, repeats: int = 3) -> float:
        """Device-time twin of push(): best ms per step of the device step
        alone (ring writes, gathers, STC and the ensemble over the valid
        rows of `boxes`), its inputs staged on the device once and k
        steps chained per repeat (serve._common._time_device_chain).
        Excludes the host's share of a push: preparing and uploading its
        inputs, and the download. A flow-fusing model is timed with a
        zero flow map. Runs on clones of the rings: the scorer's serving
        state is untouched."""
        frame = self._norm_frame(frame)
        self._ensure_rings(*frame.shape[:2])
        boxes_pad, nb = self._pad_boxes(boxes)
        zero = np.zeros(frame.shape[:2] + (2,), np.float32)
        args = self._stage(frame, zero if self.use_flow else None, boxes_pad, nb)
        with torch.no_grad():
            return _time_device_chain(self, lambda: self._step(*args), k, repeats)

    def drain(self) -> List[float]:
        """Materialize and return the scores still in flight (stream end)."""
        with annotate("serve.tick"):
            out = [self._finish(*e) for e in self._pending]
        self._pending.clear()
        return out

    def _finish(self, handle, boxes_pad, nb, scene, skip_mag=False) -> float:
        out = _host_result(handle)
        with annotate("serve.finish"):
            return self._finish_host(out, boxes_pad, nb, scene, skip_mag)

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
