"""A camera fleet served tick by tick: `MultiCameraScorer.push_tick`
(vec_vad_torch/serve/fleet.py), C cameras a tick, closed loop (the next
tick is pushed once the last one's C scores are on the host), one
fleet-wide video through set-up and window.

Traffic parameters: cameras, pool_ticks (distinct ticks made in set-up
and cycled; frame t of camera c is pool[t % pool_ticks][c]), boxes
([min, max] boxes a camera a frame, each count in equal shares: the
configuration's `assumed` says where the range comes from), box_side
([min, max] px), max_boxes (the scorer's padded box set),
pipeline_depth, warm_ticks, check_ticks (window ticks the reference
recomputes, drawn from the seed), stats_ticks (the pool's first ticks
whose cubes the reference scores in set-up for the training-score
statistics that z-normalise the scores: their mean and standard
deviation, as a trained block's are of its own cubes).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from vadbench import traffic
from vadbench.drivers._common import model_of, completion_rows, pipeline_config, sample
from vadbench.reference import ensemble as ref_ensemble
from vadbench.reference import reference_context
from vadbench.reference import scoring as ref_scoring

BIG_NUMBER = 100000.0  # test.py's big_number


class Driver:
    def __init__(self, run):
        self.run = run
        self.tr = run.traffic
        self.config = run.config
        self.model = model_of(run.config)
        self.C = int(self.tr["cameras"])
        self.hw = tuple(run.config["frame_hw"])
        self.gray = bool(run.config.get("gray", False))
        self.out = []  # (frame index scored, its C scores) a window tick

    # -- set-up ----------------------------------------------------------

    def _make_pool(self):
        run, P = self.run, int(self.tr["pool_ticks"])
        video = traffic.frames(run.seed, P, self.C, self.hw, 1 if self.gray else 3,
                               run.device)  # (C, P, H, W, c)
        pool = video.transpose(0, 1).contiguous().cpu().numpy()
        self.pool = pool[..., 0] if self.gray else pool  # (P, C, H, W[, 3])
        del video
        rng = traffic.host_rng(run.seed, 1)
        lo, hi = self.tr["boxes"]
        counts = traffic.box_counts(P * self.C, int(lo), int(hi), rng)
        flat = traffic.boxes(counts, self.hw, self.tr["box_side"], rng)
        self.boxes = [flat[i * self.C:(i + 1) * self.C] for i in range(P)]

    def _make_scorer(self):
        from vec_vad_torch.serve import MultiCameraScorer

        return MultiCameraScorer(
            self.cfg, self.weights, self.stats, n_cameras=self.C,
            max_boxes=int(self.tr["max_boxes"]),
            pipeline_depth=int(self.tr["pipeline_depth"]), gray_stream=self.gray,
            device=self.run.device)

    def setup(self):
        run = self.run
        self.cfg = pipeline_config(self.config)
        self._make_pool()
        self.weights = traffic.weights(ref_ensemble.spec(self.model), run.seed,
                                       run.device)
        with reference_context():
            self.stats = ref_scoring.score_stats(
                self.weights, self.model,
                [it for t in range(int(self.tr["stats_ticks"])) for it in self._frame_items(t, False)],
                int(self.config["patch_size"]))
        self.scorer = self._make_scorer()
        self.scorer.start_video()
        self.tick = 0
        for _ in range(int(self.tr["warm_ticks"])):
            self._push()

    # -- the window --------------------------------------------------------

    def _scored_frame(self, u: int) -> int:
        """The frame whose scores tick u returns."""
        return u

    def _push(self):
        P = self.pool.shape[0]
        u = self.tick
        t0 = time.perf_counter()
        with torch.profiler.record_function("vadbench.push_tick"):
            scores = self.scorer.push_tick(self.pool[u % P], self.boxes[u % P])
        lat = time.perf_counter() - t0
        self.tick += 1
        return u, scores, lat

    def step(self):
        u, scores, lat = self._push()
        t = self._scored_frame(u)
        self.out.append((t, scores))
        ok = scores is not None and bool(np.all(np.isfinite(scores)))
        valid = sum(len(b) for b in self.boxes[t % self.pool.shape[0]])
        return {"ok": ok, "latency_s": lat, "frames": self.C,
                "work": self._work(valid)}

    def _work(self, valid: int) -> dict:
        return {"valid_cubes": valid}

    def end_to_end(self, steps, window_s):
        lat = np.array([s["latency_s"] for s in steps])
        return {"serve_frames_per_s": sum(s["frames"] for s in steps) / window_s,
                "serve_tick_ms_p90": float(np.percentile(lat, 90)) * 1e3}

    @contextlib.contextmanager
    def trace_hooks(self):
        records = {"cameras": self.C}
        with completion_rows(records):
            yield records

    def release(self):
        del self.scorer
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the comparison ------------------------------------------------------

    def _window_frames(self, t: int) -> torch.Tensor:
        """(C, T, H, W, 3) uint8 context windows of frame t ('predict':
        the video's first frame repeated before it starts)."""
        ctx = int(self.model["context_frame_num"])
        P = self.pool.shape[0]
        idx = [max(t - ctx + j, 0) % P for j in range(ctx + 1)]
        w = torch.from_numpy(np.stack([self.pool[i] for i in idx], 1)).to(self.run.device)
        return w[..., None].expand(w.shape + (3,)) if self.gray else w

    def _flows(self, t: int, lowp: bool):
        return None

    def _frame_items(self, t: int, lowp: bool):
        win = self._window_frames(t)
        flows = self._flows(t, lowp)
        return [{"window": win[c], "boxes": self.boxes[t % self.pool.shape[0]][c],
                 "flow": None if flows is None else flows[c]}
                for c in range(self.C)]

    def check(self, control=None):
        """control: None (the program) or "tf32" (the reference in TF32 in
        its place)."""
        rng = traffic.host_rng(self.run.seed, 7)
        picked = sample(self.out, int(self.tr["check_ticks"]), rng)
        got, want = [], []
        for t, scores in picked:
            if scores is None:
                return {"score_gap": float("inf")}
            want.append(self._reference(t, False))
            got.append(self._reference(t, True) if control
                       else np.asarray(scores, np.float64))
        return {"score_gap": ref_scoring.score_gap(np.concatenate(got), np.concatenate(want),
                                                   BIG_NUMBER)}

    def _reference(self, t: int, lowp: bool) -> np.ndarray:
        """The reference's C scores of frame t (in TF32 where lowp)."""
        return ref_scoring.frame_scores(
            self.weights, self.model, self.stats, self._frame_items(t, lowp),
            int(self.config["patch_size"]), float(self.config["motion_thr"]),
            BIG_NUMBER, lowp=lowp)
