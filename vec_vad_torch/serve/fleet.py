"""Fleet serving: C concurrent camera streams, one frame from each a tick
(vec_vad_tpu/serve/fleet.py), on one device.

The JAX package scans the single-camera step over the camera axis
(`lax.scan`, its fastest form on the TPU). Here a tick writes the C
frames into the (C, R, H, W, 3) ring, gathers every camera's window and
runs ONE ensemble forward over the C*K cubes: eval-mode BatchNorm makes
each row independent of the others, so the form changes the summation
order of a batched convolution, not the result.

On a device mesh (`mesh=`, vec_vad_tpu's camera sharding) each of the n
entries serves C / n cameras, contiguous in camera order: its own rings
and its own replica of the weights on its device (the scorer itself for
the first entry, a fleet of C / n cameras for each other,
serve._common._fleet_replicas). A tick runs one forward an entry, the
entries in mesh order, and gathers their scores on the first entry in
camera order; the replicas never talk.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from vec_vad_torch.serve._common import (
    _alloc_camera_rings,
    _fleet_arity,
    _fleet_device,
    _fleet_replicas,
    _host_result,
    _time_device_chain,
    _upload,
)
from vec_vad_torch.parallel.mesh import gather
from vec_vad_torch.serve.streaming import StreamingScorer


class MultiCameraScorer(StreamingScorer):
    """Fleet serving: C concurrent camera streams scored together a tick.

    State is the single-camera design with a leading camera axis: frame
    ring (C, R, H, W, 3), flow ring (C, R_of, H, W, 2), per-camera video
    start and scene. All cameras share one frame geometry; run one scorer
    per geometry group for a mixed fleet. Every camera contributes a frame
    every tick — for a dropped frame, re-push the camera's previous frame
    with its boxes (the ring then holds the same context an offline run
    of that duplicated-frame video would).

    Each camera's scores equal StreamingScorer.push on that camera
    (the JAX package's contract, tests/test_serve.py::
    test_multicamera_matches_single), up to the batch's summation order.

    Usage:
        scorer = MultiCameraScorer.from_model(model, n_cameras=8)
        scorer.start_video()                  # all cameras, scene 1
        scorer.start_video(camera=3, scene=2) # camera 3 cuts to a new video
        for frames, boxes in fleet_feed:      # frames (C, H, W, 3)
            scores = scorer.push_tick(frames, boxes)   # C scores
    """

    def __init__(self, cfg, state_dict=None, stats=None, *, n_cameras,
                 mesh=None, **kw):
        """n_cameras: the fleet's C; mesh: a parallel.mesh.Mesh (or a list
        of devices, a device may repeat) to serve the fleet over, C / n
        cameras an entry (module docstring); C must divide over it. The
        scorer lives on the mesh's first entry."""
        self.C, n = _fleet_arity(n_cameras, mesh)
        _fleet_device(mesh, kw)
        super().__init__(cfg, state_dict, stats, **kw)
        self._Cs = self.C // n  # cameras an entry
        self._cam_v0 = np.zeros(self.C, np.int64)
        self._cam_scene = np.ones(self.C, np.int64)
        self._tick = 0
        self._cams = torch.arange(self._Cs, device=self.device)[:, None]
        self._replicas = _fleet_replicas(self, mesh, lambda d: type(self)(
            cfg, state_dict, stats, n_cameras=self._Cs, **{**kw, "device": d}))

    def _entries(self):
        """(scorer, camera slice) of each mesh entry, in mesh order."""
        return [(rep, slice(i * self._Cs, (i + 1) * self._Cs))
                for i, rep in enumerate(self._replicas)]

    def _ensure_rings(self, h: int, w: int) -> None:
        for rep in self._replicas:
            if rep._ring is None:
                rep._ring, rep._flow_ring = _alloc_camera_rings(
                    rep._Cs, rep._rlen, h, w, (rep._Cs, rep.R_of, h, w, 2),
                    rep.device)

    # -- per-camera stream state ---------------------------------------

    def start_video(self, camera: Optional[int] = None, *,
                    scene: int = 1) -> None:
        """Mark a video boundary on one camera (or every camera when
        `camera` is None): its context windows never cross the boundary.
        `scene` selects the camera's scene row of the block grid
        (1-based, as StreamingScorer.start_video)."""
        cams = slice(None) if camera is None else camera
        self._cam_v0[cams] = self._tick
        self._cam_scene[cams] = int(scene)

    def push(self, *a, **kw):
        raise NotImplementedError(
            "MultiCameraScorer scores per tick; use push_tick "
            "(or a StreamingScorer for a single stream)"
        )

    push_many = push

    def time_device_step(self, *a, **kw):
        raise NotImplementedError(
            "MultiCameraScorer times per tick; use time_device_tick "
            "(the inherited single-camera twin would run against the "
            "fleet's (C, ...) rings)"
        )

    # -- the fleet tick -------------------------------------------------

    def _stage_tick(self, frames, flows, boxes_pad, rep, cams: slice):
        """One tick's host inputs for the cameras `cams` of one mesh entry,
        on that entry's device (`rep`, its scorer): (frames, flows or
        None, slots, per-camera window indices (c, T) and (c, T_of),
        boxes)."""
        v0 = self._cam_v0[cams]
        pos = self._tick - v0
        win = np.stack([self._windows(p, v, self.ctx, self._rlen)
                        for p, v in zip(pos, v0)])
        owin = np.stack([self._windows(p, v, self.ctx_of, self.R_of)
                         for p, v in zip(pos, v0)])
        win_t, owin_t = rep._indices((win, self._rlen), (owin, self.R_of))
        flows_t = None
        if self.use_flow and flows is not None:
            flows_t = _upload(np.asarray(flows[cams], np.float32), rep.device)
        return (_upload(frames[cams], rep.device), flows_t, self._tick % self._rlen,
                self._tick % self.R_of, win_t.reshape(len(v0), -1),
                owin_t.reshape(len(v0), -1), _upload(boxes_pad[cams], rep.device))

    def _staged_ticks(self, frames, flows, boxes_pad):
        """(entry scorer, its staged tick inputs) for every mesh entry."""
        return [(rep, self._stage_tick(frames, flows, boxes_pad, rep, cams))
                for rep, cams in self._entries()]

    def _run_ticks(self, staged) -> torch.Tensor:
        """Every entry's tick step on its staged inputs, the (C, B*K + K)
        scores gathered on the first entry in camera order."""
        outs = [rep._tick_step(*args) for rep, args in staged]
        return outs[0] if len(outs) == 1 else gather(outs, self.device)

    def _tick_step(self, frames_t, flows_t, slot, of_slot, win_t, owin_t,
                   boxes_t) -> torch.Tensor:
        """One tick on the device: the C ring writes, then every camera's
        scores from one ensemble forward. -> (C, B*K + K)"""
        self._ring[:, slot] = self._color(frames_t)
        owd = None
        if self.use_flow:
            if flows_t is None:
                self._flow_ring[:, of_slot] = 0.0
            else:
                self._flow_ring[:, of_slot] = flows_t
            owd = self._flow_ring[self._cams, owin_t]
        return self._score_windows(self._ring[self._cams, win_t], owd, boxes_t)

    def _norm_tick(self, frames, boxes_list):
        frames = self._norm_frames(frames)
        if frames.shape[0] != self.C:
            raise ValueError(
                f"expected {self.C} camera frames, got {frames.shape[0]}"
            )
        boxes_pad, nbs = self._pad_many(boxes_list, self.C)
        return frames, boxes_pad, nbs

    @torch.no_grad()
    def push_tick(self, frames: np.ndarray, boxes_list,
                  flows: Optional[np.ndarray] = None) -> Optional[List[float]]:
        """Score one frame from each of the C cameras.

        frames: (C, H, W, 3) uint8 ((C, H, W) when gray_stream);
        boxes_list: per camera an (n_c, 4) float xyxy array;
        flows: optional (C, H, W, 2) per-camera flow maps — None on a
        flow-fusing model degrades per camera exactly like
        StreamingScorer.push(flow=None).

        Returns the C frame scores (ordered by camera); with
        pipeline_depth=d, returns the scores of the tick pushed d calls
        ago (None while the pipeline fills; drain() at stream end)."""
        frames, boxes_pad, nbs = self._norm_tick(frames, boxes_list)
        self._ensure_rings(*frames.shape[1:3])
        outs = self._run_ticks(self._staged_ticks(frames, flows, boxes_pad))
        self._tick += 1
        return self._emit_tick(outs, boxes_pad, nbs, self.use_flow and flows is None)

    def time_device_tick(self, frames: np.ndarray, boxes_list,
                         k: int = 32, repeats: int = 3) -> float:
        """Device-time twin of push_tick(): best ms per tick of the device
        step alone, inputs staged once and k ticks chained per repeat
        (serve._common._time_device_chain; zero flow maps on a
        flow-fusing model). Runs on clones of the rings: the fleet's
        serving state is untouched."""
        frames, boxes_pad, _ = self._norm_tick(frames, boxes_list)
        self._ensure_rings(*frames.shape[1:3])
        zero = np.zeros(frames.shape[:3] + (2,), np.float32)
        staged = self._staged_ticks(frames, zero if self.use_flow else None,
                                    boxes_pad)
        with torch.no_grad():
            return _time_device_chain(self, lambda: self._run_ticks(staged), k,
                                      repeats)

    def _emit_tick(self, outs, boxes_pad, nbs, skip_mag=False):
        """Queue a tick's (C, B*K + K) result; returns the C scores of the
        tick that leaves the pipeline (None while it fills)."""
        self._pending.append((self._result_handle(outs), boxes_pad, nbs,
                              self._cam_scene.copy(), skip_mag))
        if len(self._pending) <= self.pipeline_depth:
            return None
        return self._finish_tick(*self._pending.popleft())

    def drain(self) -> List[List[float]]:
        """Materialize the tick scores still in flight (stream end)."""
        out = [self._finish_tick(*e) for e in self._pending]
        self._pending.clear()
        return out

    def _finish_tick(self, handle, boxes_pad, nbs, scenes,
                     skip_mag) -> List[float]:
        outs = _host_result(handle)  # ONE download for the whole tick
        return [
            self._finish_host(outs[c], boxes_pad[c], nbs[c], int(scenes[c]),
                              skip_mag)
            for c in range(self.C)
        ]
