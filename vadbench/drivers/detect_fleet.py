"""A camera fleet that finds its own foreground:
`DetectingFleetScorer.push_tick(frames)` (vec_vad_torch/serve/
detect_fleet.py), C colour cameras a tick, closed loop. Each tick runs the
Cascade R-CNN R101-FPN once over the C frames on the card, filters and
suppresses its detections (obj_det) and scores the frames on the boxes
it kept; the harness hands it frames only.

Weights: the detector's from the seed under mmdet v1's names
(reference/cascade_rcnn.spec), loaded through the program's
load_mmdet_state; the regression weights (rpn_reg, every stage's fc_reg)
and every class's fc_cls rows but the person's scaled by `weight_scale`
(random regression throws the boxes to the borders; a trained detector's
keep near their proposals), then the person bias of the three stages
shifted so that `boxes_per_frame` boxes a frame survive obj_det's filter
and suppression on average over `calibration_ticks` ticks spread evenly
over the pool (a bisection in set-up over the reference's own stage
outputs of those frames). The ensemble's as in drivers/fleet.py; the
training-score statistics from the reference's scores on the boxes the
reference keeps in the pool's first `stats_ticks` ticks. Nothing the
reference computes with comes from the program.

Traffic parameters: cameras, pool_ticks (a seeded synthetic video a
camera: a drifting texture with `objects` moving rectangles of sides
`object_side`, cycled), calibration_ticks, boxes_per_frame, weight_scale,
max_boxes, pipeline_depth, warm_ticks, stats_ticks (the pool's first
ticks, on the boxes the calibrated reference keeps in them, give the
training-score statistics), check_ticks (window ticks whose scores the
reference recomputes on the boxes the program kept).

The comparison (`check`) on one seeded window tick's C frames, rerun
through the program's detector after the window with its intermediates
kept: pyramid_gap (P2-P6 against the reference's from the frames),
stage_gap (the RPN head's outputs and each stage's logits and deltas
against the reference's from the program's own inputs to that stage),
proposal_miss (the reference's proposals, from the program's pyramid,
with no program proposal within MATCH_PX on every coordinate, and the
program's with no reference proposal so close, over the reference's
count), det_mismatch (the detections, label and box, that the
reference's get_det_bboxes of the program's stage-3 outputs keeps and the
program's multiclass NMS does not, and those the other way; and likewise
the boxes the reference's filter and suppression keep of them against
the tick's kept boxes; over the reference's count of both), and
score_gap over `check_ticks` ticks (the fleets').
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from vadbench import traffic
from vadbench.drivers import fleet
from vadbench.drivers._common import completion_rows, pipeline_config, sample
from vadbench.reference import cascade_rcnn as ref
from vadbench.reference import ensemble as ref_ensemble
from vadbench.reference import reference_context
from vadbench.reference import scoring as ref_scoring

MATCH_PX = 0.05  # two boxes are one when every coordinate is this close


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _unmatched(a: np.ndarray, b: np.ndarray, tol: float) -> int:
    """Rows of a (n, d) with no row of b (m, d) within tol on every column."""
    if a.shape[0] == 0:
        return 0
    if b.shape[0] == 0:
        return a.shape[0]
    d = np.abs(a[:, None, :] - b[None, :, :]).max(-1)
    return int((d.min(1) > tol).sum())


def _labelled(boxes, labels) -> np.ndarray:
    """(n, 5) rows (label * 1e4, box) of detections: rows within MATCH_PX
    have the same label."""
    b = np.asarray(boxes.cpu() if torch.is_tensor(boxes) else boxes, np.float64)
    lab = np.asarray(labels.cpu() if torch.is_tensor(labels) else labels, np.float64)
    return np.concatenate([lab.reshape(-1, 1) * 1e4, b.reshape(-1, 4)], 1)


def _scoring(boxes: np.ndarray) -> np.ndarray:
    """The boxes whose integer crop is not empty: the only ones that score
    (test.py). The reference's cropping cannot take an empty crop at the
    frame's right or bottom edge, where a detection clipped to the border
    lies, so the others are left out before it sees them."""
    return boxes[~ref_scoring.degenerate(boxes)] if len(boxes) else boxes


def moving_objects(seed: int, n_frames: int, cams: int, hw, objects: int, side,
                   device) -> np.ndarray:
    """(n_frames, cams, H, W, 3) uint8 BGR: traffic.frames' drifting
    texture with `objects` rectangles a camera, each of a seeded colour and
    size (width and height uniform in `side`), moving at a seeded velocity
    of 1-6 px a frame and wrapping around the frame."""
    H, W = hw
    video = traffic.frames(seed, n_frames, cams, hw, 3, device)  # (C, T, H, W, 3)
    pool = video.transpose(0, 1).contiguous().cpu().numpy()
    rng = traffic.host_rng(seed, 11)
    lo, hi = side
    for c in range(cams):
        wh = rng.uniform(lo, hi, (objects, 2)).astype(np.int64)
        xy0 = rng.uniform(0, 1, (objects, 2)) * (W, H)
        vel = rng.uniform(1, 6, (objects, 2)) * rng.choice((-1, 1), (objects, 2))
        colour = rng.integers(0, 256, (objects, 3), dtype=np.uint8)
        for t in range(n_frames):
            xy = (xy0 + vel * t) % (W, H)
            for k in range(objects):
                x0, y0 = int(xy[k, 0]), int(xy[k, 1])
                pool[t, c, y0:y0 + wh[k, 1], x0:x0 + wh[k, 0]] = colour[k]
    return pool


class Driver(fleet.Driver):
    def __init__(self, run):
        super().__init__(run)
        det = run.config["detector"]
        self.depth = int(det["depth"])
        self.img_scale = tuple(det["img_scale"])
        self.test_cfg = dict(det["test_cfg"])
        self.filt = dict(run.config["filter"])
        self.K = int(self.tr["max_boxes"])

    # -- set-up ----------------------------------------------------------------

    def _make_pool(self):
        tr = self.tr
        self.pool = moving_objects(self.run.seed, int(tr["pool_ticks"]), self.C, self.hw,
                                   int(tr["objects"]), tr["object_side"], self.run.device)

    def _kept(self, boxes, scores) -> np.ndarray:
        return ref.kept_boxes(boxes, scores, self.filt, self.K)

    def _ref_stages(self, t: int):
        """The reference's (final boxes, mean stage logits, scale) of each of
        tick t's frames, from the frames (the person shift not applied)."""
        sd, cfg = self.det_weights, {**ref.TEST_CFG, **self.test_cfg}
        out = []
        with reference_context():
            for frame in self.pool[t]:
                x, img_hw, scale = ref.prepare(frame, self.img_scale, self.run.device)
                pyr = ref.pyramid(sd, x, self.depth)
                props = ref.proposals([ref.rpn_head(sd, p) for p in pyr], img_hw, cfg)
                st = ref.cascade(sd, pyr[:4], props, img_hw)
                out.append((st["bboxes"], sum(st["logits"]) / 3.0, scale))
        return out

    def _ref_kept(self, stages, shift: float) -> list:
        """obj_det's boxes of the reference's stage outputs of some frames
        with `shift` added to the person's mean logit (each stage's bias
        moves the stages' mean logit by as much)."""
        cfg = {**ref.TEST_CFG, **self.test_cfg}
        kept = []
        with reference_context():
            for bboxes, logits, scale in stages:
                z = logits.clone()
                z[:, ref.PERSON] += shift
                b, s, _ = ref.det_bboxes(bboxes, torch.softmax(z, -1), scale, cfg)
                kept.append(self._kept(b, s))
        return kept

    def _calibrate(self, cached: dict) -> float:
        """The person-logit shift that makes obj_det keep `boxes_per_frame`
        boxes a frame on average over `calibration_ticks` ticks spread
        evenly over the pool: a bisection over the reference's stage
        outputs of the ticks' frames, cached by tick in `cached`."""
        P, n = self.pool.shape[0], int(self.tr["calibration_ticks"])
        stages = []
        for t in range(0, P, max(P // n, 1))[:n]:
            cached[t] = self._ref_stages(t)
            stages += cached[t]
        target = float(self.tr["boxes_per_frame"])
        lo, hi = -40.0, 40.0
        for _ in range(16):
            mid = 0.5 * (lo + hi)
            n_kept = np.mean([k.shape[0] for k in self._ref_kept(stages, mid)])
            lo, hi = (lo, mid) if n_kept >= target else (mid, hi)
        return hi

    def setup(self):
        # the route under test; a program without it stops here
        from vec_vad_torch.serve import DetectingFleetScorer
        from vec_vad_torch.fore.mmdet_detector import CascadeRCNN, MMDetCascadeDetector
        from vec_vad_torch.fore.mmdet_import import load_mmdet_state

        run, dev = self.run, self.run.device
        spec = pipeline_config(self.config).dataset
        for key in ("ap_score_thr", "ap_min_area", "cover_thr"):
            if float(getattr(spec, key)) != float(self.filt[key]):
                raise SystemExit(f"the program's {spec.name} {key} is {getattr(spec, key)}, "
                                 f"the configuration's {self.filt[key]}")
        self._make_pool()
        sd = traffic.weights(ref.spec(self.depth), run.seed, dev, stream=8)
        small = float(self.tr["weight_scale"])
        other = torch.arange(ref.NUM_CLASSES, device=dev) != ref.PERSON
        sd["rpn_head.rpn_reg.weight"] *= small
        for i in range(3):
            sd[f"bbox_head.{i}.fc_cls.weight"][other] *= small
            sd[f"bbox_head.{i}.fc_reg.weight"] *= small
        self.det_weights = sd
        cached = {}
        shift = self._calibrate(cached)
        for i in range(3):
            sd[f"bbox_head.{i}.fc_cls.bias"][ref.PERSON] += shift
        with torch.device(dev):
            model = CascadeRCNN(self.depth)
        self.det = MMDetCascadeDetector(load_mmdet_state(model, sd), img_scale=self.img_scale,
                                        device=dev, **self.test_cfg)
        self.boxes = {t: self._ref_kept(cached.get(t) or self._ref_stages(t), shift)
                      for t in range(int(self.tr["stats_ticks"]))}
        self.cfg = pipeline_config(self.config)
        self.weights = traffic.weights(ref_ensemble.spec(self.model), run.seed, dev)
        with reference_context():
            self.stats = ref_scoring.score_stats(
                self.weights, self.model,
                [it for t, b in self.boxes.items()
                 for it in self._items(t, [_scoring(x) for x in b],
                                       [c for c in range(self.C) if len(_scoring(b[c]))])],
                int(self.config["patch_size"]))
        self.scorer = DetectingFleetScorer(
            self.cfg, self.weights, self.stats, n_cameras=self.C, detector=self.det,
            max_boxes=self.K, pipeline_depth=int(self.tr["pipeline_depth"]), device=dev)
        self.scorer.start_video()
        self.tick = 0
        for _ in range(int(self.tr["warm_ticks"])):
            self.step()
        self.out.clear()

    # -- the window ------------------------------------------------------------

    def step(self):
        P = self.pool.shape[0]
        u = self.tick
        t0 = time.perf_counter()
        with torch.profiler.record_function("vadbench.push_tick"):
            scores = self.scorer.push_tick(self.pool[u % P])
        lat = time.perf_counter() - t0
        self.tick += 1
        boxes = self.scorer.last_boxes
        self.out.append((u, scores, boxes))
        ok = scores is not None and bool(np.all(np.isfinite(scores)))
        return {"ok": ok, "latency_s": lat, "frames": self.C,
                "work": {"valid_cubes": sum(len(b) for b in boxes), "det_frames": self.C}}

    @contextlib.contextmanager
    def trace_hooks(self):
        """detect_ms: CUDA events from forward pre- and post-hooks on the
        detector module the route calls; detect_frames and detect_boxes:
        the route's counters over the traced window."""
        records = {"cameras": self.C}
        cuda = self.run.device.type == "cuda"
        marks = []
        net = self.scorer.detector.net
        n0 = (self.scorer.frames_detected, self.scorer.boxes_kept)

        def pre(module, args):
            if cuda:
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                marks.append([e, None])

        def post(module, args, out):
            if cuda:
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                marks[-1][1] = e

        handles = [net.register_forward_pre_hook(pre), net.register_forward_hook(post)]
        try:
            with completion_rows(records):
                yield records
        finally:
            for h in handles:
                h.remove()
            records["detect_frames"] = self.scorer.frames_detected - n0[0]
            records["detect_boxes"] = self.scorer.boxes_kept - n0[1]
            if cuda:
                torch.cuda.synchronize()
                records["detect_ms"] = [a.elapsed_time(b) for a, b in marks if b is not None]

    def release(self):
        """Rerun one seeded window tick through the program's detector with
        its intermediates kept (and its RPN head on its pyramid), then free
        the program."""
        rng = traffic.host_rng(self.run.seed, 9)
        self.check_tick = self.out[int(rng.integers(len(self.out)))]
        frames = self.pool[self.check_tick[0] % self.pool.shape[0]]
        st = {}
        with reference_context():
            st["dets"], _ = self.det.run(frames, stages=st)
            st["heads"] = [self.det.model.rpn_head(p) for p in st["pyramid"]]
        self.captured = st
        del self.scorer, self.det
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the comparison ------------------------------------------------------------

    def _scores(self, t: int, boxes, lowp: bool = False) -> np.ndarray:
        """The reference's C scores of tick t on `boxes`: -big_number for a
        camera with no scoring box (test.py), the reference's scoring of
        the others' windows."""
        out = np.full(self.C, -fleet.BIG_NUMBER)
        boxes = [_scoring(b) for b in boxes]
        cams = [c for c in range(self.C) if len(boxes[c])]
        if cams:
            out[cams] = ref_scoring.frame_scores(
                self.weights, self.model, self.stats, self._items(t, boxes, cams),
                int(self.config["patch_size"]), float(self.config["motion_thr"]),
                fleet.BIG_NUMBER, lowp=lowp)
        return out

    def _items(self, t: int, boxes, cams):
        win = self._window_frames(t)
        return [{"window": win[c], "boxes": boxes[c], "flow": None} for c in cams]

    def check(self, control=None):
        """control: None (the program) or "tf32" (the reference in TF32 in
        its place)."""
        lowp = control is not None
        out = {}
        rng = traffic.host_rng(self.run.seed, 7)
        got, want = [], []
        for t, scores, boxes in sample(self.out, int(self.tr["check_ticks"]), rng):
            if scores is None:
                return {"score_gap": float("inf")}
            want.append(self._scores(t, boxes))
            got.append(self._scores(t, boxes, lowp=True) if lowp
                       else np.asarray(scores, np.float64))
        out["score_gap"] = ref_scoring.score_gap(np.concatenate(got), np.concatenate(want),
                                                 fleet.BIG_NUMBER)
        out.update(self._detector_gaps(lowp))
        return out

    def _detector_gaps(self, lowp: bool) -> dict:
        sd, st, cfg = self.det_weights, self.captured, {**ref.TEST_CFG, **self.test_cfg}
        t, _, route_boxes = self.check_tick
        frames = self.pool[t % self.pool.shape[0]]
        pyramid_gap = stage_gap = 0.0
        misses = n_props = mismatched = n_kept = 0
        for i in range(self.C):
            x, img_hw, scale = ref.prepare(frames[i], self.img_scale, self.run.device)
            want = ref.pyramid(sd, x, self.depth)
            got = (ref.pyramid(sd, x, self.depth, lowp=True) if lowp
                   else [p[i:i + 1] for p in st["pyramid"]])
            pyramid_gap = max([pyramid_gap] + [_rel(g, w) for g, w in zip(got, want)])
            levels = [p[i:i + 1] for p in st["pyramid"]]
            heads = [ref.rpn_head(sd, p) for p in levels]
            got_heads = ([ref.rpn_head(sd, p, lowp=True) for p in levels] if lowp
                         else [(c[i:i + 1], r[i:i + 1]) for c, r in st["heads"]])
            for (gc, gr), (wc, wr) in zip(got_heads, heads):
                stage_gap = max(stage_gap, _rel(gc, wc), _rel(gr, wr))
            props = ref.proposals(heads, img_hw, cfg).cpu().numpy()
            got_props = (ref.proposals(got_heads, img_hw, cfg) if lowp
                         else st["proposals"][i][st["valid"][i]]).cpu().numpy()
            misses += (_unmatched(props, got_props, MATCH_PX)
                       + _unmatched(got_props, props, MATCH_PX))
            n_props += props.shape[0]
            lows = []
            for k in range(3):
                rois = st["rois"][k][i]
                wl, wd = ref.stage_head(sd, k, levels[:4], rois)
                gl, gd = (ref.stage_head(sd, k, levels[:4], rois, lowp=True) if lowp
                          else (st["logits"][k][i], st["deltas"][k][i]))
                stage_gap = max(stage_gap, _rel(gl, wl), _rel(gd, wd))
                lows.append((gl, gd))
            valid = st["valid"][i]
            b, s, lab = ref.det_bboxes(st["bboxes"][i][valid], st["scores"][i][valid], scale,
                                       cfg)
            dets, kept = _labelled(b, lab), self._kept(b, s)
            if lowp:
                bb = ref.delta2bbox(st["rois"][2][i], lows[2][1], ref.STAGE_STDS[2], img_hw)
                sc = torch.softmax(sum(gl for gl, _ in lows) / 3.0, dim=1)
                b, s, lab = ref.det_bboxes(bb[valid], sc[valid], scale, cfg)
                other_dets, other = _labelled(b, lab), self._kept(b, s)
            else:
                pb, _, pl, pok = (x[i] for x in st["dets"])
                other_dets = _labelled(pb[pok], pl[pok])
                other = np.asarray(route_boxes[i], np.float32)
            mismatched += (_unmatched(dets, other_dets, MATCH_PX)
                           + _unmatched(other_dets, dets, MATCH_PX)
                           + _unmatched(kept, other, MATCH_PX)
                           + _unmatched(other, kept, MATCH_PX))
            n_kept += dets.shape[0] + kept.shape[0]
        return {"pyramid_gap": pyramid_gap, "stage_gap": stage_gap,
                "proposal_miss": misses / max(n_props, 1),
                "det_mismatch": mismatched / max(n_kept, 1)}
