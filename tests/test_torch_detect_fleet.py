"""DetectingFleetScorer (serve/detect_fleet.py), the camera fleet that runs
the Cascade R-CNN inside every tick, on the CPU against the benchmark's
plain reference (vadbench/reference/cascade_rcnn.py, which imports
neither the port nor JAX): seeded random R50 weights under mmdet v1's
names with the person bias raised so that a few boxes a frame survive,
64x96 frames of moving rectangles, img_scale (160, 96) (a 96x160 canvas)
and tens of proposals. Stage by stage from the port's own inputs, the
kept boxes, the fleet's scores on them, the route with boxes given, its
refusals, and `serve --cameras 2` in obj_det mode with a checkpoint."""

import dataclasses
import io
import os
import re
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from vadbench import traffic
from vadbench.drivers._common import pipeline_config
from vadbench.drivers.detect_fleet import moving_objects
from vadbench.reference import cascade_rcnn as ref
from vadbench.reference import ensemble as ref_ensemble
from vadbench.reference import reference_context
from vadbench.reference import scoring as ref_scoring
from vec_vad_torch import cli as t_cli
from vec_vad_torch import config as t_config
from vec_vad_torch import runner as t_runner
from vec_vad_torch.fore import mmdet_detector as t_det
from vec_vad_torch.fore.detector import filter_detections
from vec_vad_torch.fore.mmdet_import import load_mmdet_state
from vec_vad_torch.fore.suppress import del_cover_bboxes
from vec_vad_torch.serve import DetectingFleetScorer, MultiCameraScorer

DEPTH, HW, SCALE, C, TICKS, K = 50, (64, 96), (160, 96), 2, 4, 8
TEST_CFG = dict(nms_pre=60, nms_post=40, max_num=40, max_per_img=20)
REF_CFG = {**ref.TEST_CFG, **TEST_CFG}
MODEL = {"nf": 4, "context_frame_num": 4, "context_of_num": 0, "use_flow": False,
         "border_mode": "predict", "raw_range": 10, "padding": False, "batch_size": 16,
         "learning_rate": 0.001, "adam_eps": 1e-07, "lambda_raw": 1.0, "lambda_of": 1.0,
         "w_raw": 1.0, "w_of": 1.0, "masked_bn": True, "compute_dtype": "float32"}
CONFIG = {"dataset": "ShanghaiTech", "patch_size": 16, "max_boxes_per_frame": K,
          "motion_thr": 0.0, "epochs": 1, "model": MODEL}
FILTER = {k: float(getattr(t_config.DATASETS["ShanghaiTech"], k))
          for k in ("ap_score_thr", "ap_min_area", "cover_thr")}
# the port against the reference, both f32 on the CPU: relative to the
# largest magnitude of the tensor. oneDNN sums R50's ~50 convolutions at
# batch 2 against the reference's batch 1 in other orders (~1e-6 seen);
# the heads and stages take the port's own inputs, so only their own
# summation order differs
REL = 1e-4
PX = 1e-3  # px: the same boxes, decoded from logits within REL
BIG = 100000.0


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _rows_equal(a, b, tol) -> bool:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return False
    return a.size == 0 or bool(np.abs(np.sort(a, 0) - np.sort(b, 0)).max() <= tol)


def _state(frames):
    """R50 weights from the seed (the benchmark's rules), the regression and
    the other classes' rows scaled by 1e-2, and the person bias raised so
    that 8 RoIs a frame clear a 0.5 person score before the NMS."""
    sd = traffic.weights(ref.spec(DEPTH), 7, "cpu", stream=8)
    other = torch.arange(ref.NUM_CLASSES) != ref.PERSON
    sd["rpn_head.rpn_reg.weight"] *= 1e-2
    for i in range(3):
        sd[f"bbox_head.{i}.fc_cls.weight"][other] *= 1e-2
        sd[f"bbox_head.{i}.fc_reg.weight"] *= 1e-2
    d = t_det.MMDetCascadeDetector(load_mmdet_state(t_det.CascadeRCNN(DEPTH), sd),
                                   img_scale=SCALE, device="cpu", **TEST_CFG)
    st = {}
    d.run(frames.reshape((-1,) + frames.shape[2:]), stages=st)
    m = (sum(st["logits"]) / 3.0)[st["valid"]]
    margin = m[:, ref.PERSON] - torch.logsumexp(m[:, other], -1)
    shift = -float(torch.sort(margin, descending=True)[0][8 * frames.shape[0] * C])
    for i in range(3):
        sd[f"bbox_head.{i}.fc_cls.bias"][ref.PERSON] += shift
    return sd


@pytest.fixture(scope="module")
def world():
    frames = moving_objects(5, TICKS, C, HW, 4, (8, 24), "cpu")  # (T, C, H, W, 3)
    sd = _state(frames)
    detector = t_det.MMDetCascadeDetector(load_mmdet_state(t_det.CascadeRCNN(DEPTH), sd),
                                          img_scale=SCALE, device="cpu", **TEST_CFG)
    weights = traffic.weights(ref_ensemble.spec(MODEL), 7, "cpu")
    return {"frames": frames, "sd": sd, "detector": detector, "weights": weights,
            "stats": (150.0, 12.0), "cfg": pipeline_config(CONFIG)}


def _scorer(w, cls=DetectingFleetScorer, **kw):
    if cls is DetectingFleetScorer:
        kw["detector"] = w["detector"]
    s = cls(w["cfg"], w["weights"], w["stats"], n_cameras=C, max_boxes=K, device="cpu", **kw)
    s.start_video()
    return s


def _items(frames, t, boxes):
    """The reference's inputs of tick t: each camera's 'predict' window."""
    idx = [max(t - 4 + j, 0) for j in range(5)]
    return [{"window": torch.from_numpy(frames[idx, c]), "boxes": boxes[c], "flow": None}
            for c in range(C)]


def test_route_against_the_reference_stage_by_stage(world):
    """Each tick's detector forward (the route's module, rerun with its
    intermediates): the pyramid against the reference's from the frames,
    the RPN head and each stage's logits and deltas against the
    reference's from the port's own inputs (REL), every reference
    proposal among the port's (PX); the reference's multiclass NMS,
    filter and suppression of the port's stage-3 outputs equal to the
    route's kept boxes, which equal detect_many's filtered and
    suppressed, and the reference's whole path from the frame (PX)."""
    frames, sd, det = world["frames"], world["sd"], world["detector"]
    scorer = _scorer(world)
    kept_total = 0
    for t in range(TICKS):
        st = {}
        (b, s, l, ok), scale = det.run(frames[t], stages=st)
        scorer.push_tick(frames[t])
        route = scorer.last_boxes
        many = det.detect_many(frames[t])
        with reference_context():
            for i in range(C):
                x, img_hw, ref_scale = ref.prepare(frames[t, i], SCALE, "cpu")
                assert ref_scale == scale
                for g, w in zip(st["pyramid"], ref.pyramid(sd, x, DEPTH)):
                    assert _rel(g[i:i + 1], w) <= REL
                levels = [p[i:i + 1] for p in st["pyramid"]]
                heads = [ref.rpn_head(sd, p) for p in levels]
                for p, (wc, wr) in zip(levels, heads):
                    gc, gr = det.model.rpn_head(p)
                    assert _rel(gc, wc) <= REL and _rel(gr, wr) <= REL
                props = ref.proposals(heads, img_hw, REF_CFG)
                assert _rows_equal(st["proposals"][i][st["valid"][i]], props, PX)
                for k in range(3):
                    wl, wd = ref.stage_head(sd, k, levels[:4], st["rois"][k][i])
                    assert _rel(st["logits"][k][i], wl) <= REL
                    assert _rel(st["deltas"][k][i], wd) <= REL
                v = st["valid"][i]
                rb, rs, _ = ref.det_bboxes(st["bboxes"][i][v], st["scores"][i][v], scale,
                                           REF_CFG)
                assert _rows_equal(route[i], ref.kept_boxes(rb, rs, FILTER, K), 1e-4)
                whole = ref.detect(sd, frames[t, i], DEPTH, SCALE, REF_CFG)
                db, ds, _ = whole["detections"]
                want = ref.del_cover(ref.filter_boxes(db, ds, FILTER["ap_score_thr"],
                                                      FILTER["ap_min_area"]),
                                     FILTER["cover_thr"])[:K]
                assert _rows_equal(route[i], want, PX)
                mb, ms, _ = many[i]
                np.testing.assert_array_equal(route[i], del_cover_bboxes(filter_detections(
                    mb, ms, FILTER["ap_score_thr"], FILTER["ap_min_area"]), FILTER["cover_thr"]))
                assert route[i].dtype == np.float32
                kept_total += route[i].shape[0]
    assert kept_total >= TICKS * C  # the calibrated bias keeps boxes
    assert scorer.frames_detected == TICKS * C and scorer.boxes_kept == kept_total


def test_fleet_scores_on_detected_boxes_match_the_reference(world):
    """The route's scores of every tick against the reference's on the
    boxes the route kept: the widest gap within 1e-4 of the spread of the
    reference's frame scores (the ensemble's convolutions in oneDNN's and
    the reference's summation orders)."""
    frames = world["frames"]
    scorer = _scorer(world)
    got, want = [], []
    for t in range(TICKS):
        got.append(scorer.push_tick(frames[t]))
        with reference_context():
            want.append(ref_scoring.frame_scores(
                world["weights"], MODEL, world["stats"], _items(frames, t, scorer.last_boxes),
                16, 0.0, BIG))
    got, want = np.concatenate(got), np.concatenate(want)
    assert (want > -BIG).sum() >= TICKS  # most frames have a scoring box
    assert ref_scoring.score_gap(got, want, BIG) <= 1e-4


def test_given_boxes_the_route_is_the_plain_fleet(world):
    """push_tick(frames, boxes) of the detecting fleet equals
    MultiCameraScorer.push_tick bit for bit and runs no detection."""
    frames = world["frames"]
    rng = np.random.default_rng(3)
    boxes = [[np.sort(rng.uniform(0, 60, (n, 4)).astype(np.float32).reshape(n, 2, 2), 1)
              .reshape(n, 4) for n in rng.integers(0, K + 1, C)] for _ in range(TICKS)]
    a, b = _scorer(world), _scorer(world, MultiCameraScorer)
    for t in range(TICKS):
        assert a.push_tick(frames[t], boxes[t]) == b.push_tick(frames[t], boxes[t])
    assert a.frames_detected == 0 and a.last_boxes is None


@pytest.mark.parametrize("kw,match", [
    ({"mesh": ["cpu", "cpu"]}, "one device"),
    ({"gray_stream": True}, "BGR"),
])
def test_route_refusals(world, kw, match):
    with pytest.raises(ValueError, match=match):
        _scorer(world, **kw)


def test_serve_cli_cameras_detects_in_the_tick(world, tmp_path, monkeypatch):
    """`serve --cameras 2` in obj_det mode with an mmdet_checkpoint: the
    split's boxes are never loaded or computed, every tick's boxes come
    from the detector, and identical cameras score identically."""
    import chip_smoke
    from vec_vad_torch.pipeline import TrainedBlock, VadModel
    from vec_vad_torch.runtime.artifacts import save_vad_model

    name = "sht_detect_fleet_npy"
    if name not in t_config.DATASETS:
        t_config.register_dataset(dataclasses.replace(
            t_config.DATASETS["ShanghaiTech"], name=name, frame_h=HW[0], frame_w=HW[1],
            file_ext=".npy"))
    chip_smoke.write_train_test_tree(tmp_path / "raw_datasets" / name, 3,
                                     {"Train": (6,), "Test": (6,)}, HW)
    ckpt = tmp_path / "cascade_r50.pth"
    torch.save({"state_dict": world["sd"]}, ckpt)
    ini = tmp_path / "config.cfg"
    ini.write_text(
        f"[shared_parameters]\ndataset_name = {name}\nforeground_extraction_mode = obj_det\n"
        f"mmdet_checkpoint = {ckpt}\n[{name}]\npatch_size = 16\n"
        "[SelfComplete]\nnf = 4\nuseFlow = False\ncontext_of_num = 0\n")
    cfg = t_config.load_ini_config(str(ini))
    path = t_runner.model_path(cfg, str(tmp_path))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    save_vad_model(path, VadModel(cfg=cfg, blocks={
        (0, 0, 0): TrainedBlock(state_dict=world["weights"],
                                raw_scores=np.linspace(100, 200, 9, dtype=np.float32),
                                of_scores=None)}))
    monkeypatch.setattr(t_det.MMDetCascadeDetector.__init__, "__defaults__", (SCALE, "cuda"))
    monkeypatch.setattr(t_det.cascade_detect, "__kwdefaults__",
                        {**t_det.cascade_detect.__kwdefaults__, **TEST_CFG})
    monkeypatch.setattr(t_runner, "compute_foreground_bboxes",
                        lambda *a, **k: pytest.fail("the split's boxes were computed"))
    t_runner._mmdet_detector.cache_clear()
    buf = io.StringIO()
    try:
        with redirect_stdout(buf):
            assert t_cli.main(["serve", "--config", str(ini), "--base", str(tmp_path),
                               "--device", "cpu", "--cameras", "2", "--frames", "3"]) == 0
    finally:
        t_runner._mmdet_detector.cache_clear()
    out = buf.getvalue()
    assert "cross-camera score spread 0.00e+00" in out, out
    found = re.search(r"detected in the tick: (\d+) boxes kept over (\d+) frames", out)
    assert found and int(found[2]) == 6, out
