"""The appearance detectors in the port against vec_vad_tpu on the same
inputs from numpy and torch seeds: the mmdet backbone + FPN on random
mmdet-named checkpoints (the JAX tests' independent torch oracles, random
BN statistics included), the legacy box numerics (anchors, delta2bbox,
NMS with its tie order, RoIAlign v1, the level map and the per-level
pyramid), the whole Cascade R-CNN stage by stage, the cv2-free resize bit
for bit with cv2, the runner's wiring of a configured checkpoint, and the
trainable cascade and CenterNet-lite detectors (forward, decode, first
loss, gradients, three Adam steps) with weights carried from flax.

The whole-detector tests run R50 at 48x64 frames with img_scale (133, 80)
(a 96x128 canvas) and small nms_pre / max_per_img, so the JAX graphs
compile in seconds; one JAX detector is shared by the module."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from test_mmdet_detector import _TorchBBoxHead, _TorchRPN
from test_mmdet_import import TBackboneFPN, _randomize
from vec_vad_torch import runner as t_runner
from vec_vad_torch.fore import cascade_detector as t_cas
from vec_vad_torch.fore import centernet_detector as t_cn
from vec_vad_torch.fore import mmdet_detector as t_det
from vec_vad_torch.fore import mmdet_import as t_imp
from vec_vad_torch.models.convert import cascade_from_jax, centernet_from_jax
from vec_vad_tpu import runner as j_runner
from vec_vad_tpu.fore import cascade_detector as j_cas
from vec_vad_tpu.fore import jax_detector as j_cn
from vec_vad_tpu.fore import mmdet_detector as j_det
from vec_vad_tpu.fore import mmdet_import as j_imp

# port vs JAX, both f32: relative to the largest magnitude of the tensor
# (convolutions summed in other orders by oneDNN and XLA through ~50-100
# layers, ~1e-6 observed)
STAGE_REL = 1e-4
SMALL_CFG = dict(nms_pre=48, nms_post=24, max_num=32, max_per_img=8, score_thr=1e-4)
SMALL_SCALE = (133, 80)  # 48x64 -> 80x107, padded to 96x128


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _nhwc(t):
    return jnp.asarray(t.detach().numpy().transpose(0, 2, 3, 1))


# ---------------------------------------------------------------------------
# backbone + FPN and the checkpoint
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("depth,hw", [(50, (64, 96)), (101, (32, 32))])
def test_backbone_fpn_matches_jax(depth, hw):
    """The port's BackboneFPN on a random mmdet state dict against
    vec_vad_tpu's converted one and the torch oracle, level by level."""
    oracle = _randomize(TBackboneFPN(depth), seed=depth)
    sd = oracle.state_dict()
    net = t_imp.load_mmdet_state(t_imp.BackboneFPN(depth), sd).eval()
    x = torch.randn(2, 3, *hw, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got, ref = net(x), oracle(x)
    want = j_imp.BackboneFPN(depth=depth).apply(
        j_imp.convert_backbone_fpn(sd, depth=depth), _nhwc(x))
    assert len(got) == 5
    for g, w, r in zip(got, want, ref):
        assert _rel(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2)) <= STAGE_REL
        assert _rel(g.numpy(), r.numpy()) <= 1e-5


def test_param_count_r101_equals_jax_tree():
    sd = TBackboneFPN(101).state_dict()
    net = t_imp.load_mmdet_state(t_imp.BackboneFPN(101), sd)
    n_port = sum(v.numel() for v in net.state_dict().values())
    n_jax = sum(int(np.prod(np.shape(v))) for v in jax.tree_util.tree_leaves(
        j_imp.convert_backbone_fpn(sd, depth=101)))
    assert n_port == n_jax > 45_000_000


def test_checkpoint_forms_and_depth():
    sd = _randomize(TBackboneFPN(50), seed=3).state_dict()
    wrapped = {"state_dict": {"module." + k: v for k, v in sd.items()},
               "meta": {"epoch": 12}}
    a = t_imp.load_mmdet_state(t_imp.BackboneFPN(50), sd).state_dict()
    b = t_imp.load_mmdet_state(t_imp.BackboneFPN(50), wrapped).state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    stripped = t_imp.strip_checkpoint(wrapped)
    assert list(stripped) == list(j_imp.strip_checkpoint(wrapped))
    assert t_imp.infer_depth(stripped) == j_imp.infer_depth(stripped) == 50


def test_missing_key_refused_by_name():
    sd = dict(_randomize(TBackboneFPN(50), seed=4).state_dict())
    del sd["backbone.layer3.4.conv2.weight"]
    with pytest.raises(KeyError, match=r"backbone\.layer3\.4\.conv2\.weight"):
        t_imp.load_mmdet_state(t_imp.BackboneFPN(50), sd)
    with pytest.raises(KeyError, match="rpn_head.rpn_conv.weight"):
        t_imp.load_mmdet_state(t_det.CascadeRCNN(50), _randomize(
            TBackboneFPN(50), seed=4).state_dict())


# ---------------------------------------------------------------------------
# legacy box numerics
# ---------------------------------------------------------------------------


def test_anchors_equal_jax():
    for s in t_det.ANCHOR_STRIDES:
        np.testing.assert_array_equal(t_det.base_anchors(s), j_det.base_anchors(s))
        np.testing.assert_array_equal(t_det.grid_anchors(s, 3, 5),
                                      j_det.grid_anchors(s, 3, 5))


def test_delta2bbox_equals_jax():
    rng = np.random.default_rng(0)
    rois = rng.uniform(0, 60, (40, 4)).astype(np.float32)
    rois[:, 2:] += rois[:, :2]
    deltas = rng.normal(0, 2, (40, 4)).astype(np.float32)
    for stds in [(1, 1, 1, 1), (0.1, 0.1, 0.2, 0.2)]:
        got = t_det.delta2bbox(torch.from_numpy(rois), torch.from_numpy(deltas),
                               stds, (96, 128))
        want = j_det.delta2bbox(jnp.asarray(rois), jnp.asarray(deltas), stds, (96, 128))
        # the same f32 ops in the same order; exp may round differently
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=2e-5)


def _nms_case(kind, seed=1, n=64):
    rng = np.random.default_rng(seed)
    boxes = rng.uniform(0, 50, (n, 4)).astype(np.float32)
    boxes[:, 2:] = boxes[:, :2] + rng.uniform(2, 30, (n, 2))
    scores = rng.uniform(0, 1, n).astype(np.float32)
    if kind == "ties":  # few score levels, repeated boxes, exact zeros
        scores = np.round(scores * 3).astype(np.float32) / 3
        boxes[n // 2:] = boxes[: n - n // 2]
    scores[5] = scores[9] = -np.inf  # masked candidates are never picked
    return boxes, scores


@pytest.mark.parametrize("kind,thr,n_pick", [
    ("random", 0.5, 64), ("random", 0.7, 10), ("ties", 0.5, 64),
    ("ties", 0.3, 80),  # more picks than candidates
])
def test_nms_pick_equals_jax(kind, thr, n_pick):
    """idx and ok equal to the JAX scan's, slots past the survivors
    included (idx 0, ok False); a batch of rows equals each row alone."""
    boxes, scores = _nms_case(kind)
    idx, ok = t_det.nms_pick(torch.from_numpy(boxes), torch.from_numpy(scores),
                             thr, n_pick)
    j_idx, j_ok = j_det.nms_pick(jnp.asarray(boxes), jnp.asarray(scores), thr, n_pick)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(j_ok))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    b2, s2 = _nms_case(kind, seed=2)
    bi, bo = t_det.nms_pick(torch.from_numpy(np.stack([boxes, b2])),
                            torch.from_numpy(np.stack([scores, s2])), thr, n_pick)
    np.testing.assert_array_equal(bi[0].numpy(), idx.numpy())
    i2, o2 = t_det.nms_pick(torch.from_numpy(b2), torch.from_numpy(s2), thr, n_pick)
    np.testing.assert_array_equal(bi[1].numpy(), i2.numpy())
    np.testing.assert_array_equal(bo[1].numpy(), o2.numpy())


def test_roi_align_v1_and_levels_equal_jax():
    rng = np.random.default_rng(2)
    feat = rng.normal(size=(9, 11, 3)).astype(np.float32)
    boxes = np.array([[0, 0, 40, 36], [8, 4, 20, 30], [-4, -4, 6, 6],
                      [30, 20, 80, 70], [10, 10, 10.5, 10.5]], np.float32)
    got = t_det.roi_align_v1(torch.from_numpy(feat.transpose(2, 0, 1)),
                             torch.from_numpy(boxes), 0.25)
    want = j_det.roi_align_v1(jnp.asarray(feat), jnp.asarray(boxes), 0.25)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    lv = np.array([[0, 0, 55, 55], [0, 0, 111, 111], [0, 0, 223, 223],
                   [0, 0, 447, 447], [0, 0, 1000, 1000], [0, 0, 3, 3],
                   [5, 7, 60.2, 90.9]], np.float32)
    np.testing.assert_array_equal(t_det.roi_levels(torch.from_numpy(lv)).numpy(),
                                  np.asarray(j_det.roi_levels(jnp.asarray(lv))))


def test_roi_align_pyramid_per_level_equals_jax():
    """Each RoI aligned on its own level only (a batch of 2 images) against
    JAX's all-levels-then-select form, per image."""
    rng = np.random.default_rng(3)
    pyr = [rng.normal(size=(2, 5, 32 // 2 ** i, 48 // 2 ** i)).astype(np.float32)
           for i in range(4)]
    xy = rng.uniform(-10, 150, (2, 24, 2))
    wh = np.exp(rng.uniform(np.log(8), np.log(900), (2, 24, 2)))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    got = t_det.roi_align_pyramid([torch.from_numpy(p) for p in pyr],
                                  torch.from_numpy(boxes))
    assert len(set(t_det.roi_levels(torch.from_numpy(boxes)).reshape(-1).tolist())) == 4
    for b in range(2):
        want = j_det.roi_align_pyramid([jnp.asarray(p[b].transpose(1, 2, 0)) for p in pyr],
                                       jnp.asarray(boxes[b]))
        np.testing.assert_allclose(got[24 * b: 24 * (b + 1)].numpy().transpose(0, 2, 3, 1),
                                   np.asarray(want), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the whole detector, stage by stage
# ---------------------------------------------------------------------------


def _cascade_state_dict(seed: int, confident: int = None):
    """A random mmdet-named R50 Cascade R-CNN state dict built from the JAX
    tests' torch oracles; `confident`: a class whose fc_cls bias makes
    detections clear a 0.5 score."""
    torch.manual_seed(seed)
    sd = dict(_randomize(TBackboneFPN(50), seed=seed + 7).state_dict())
    rpn, heads = _TorchRPN(), [_TorchBBoxHead() for _ in range(3)]
    for k, v in rpn.state_dict().items():
        sd[f"rpn_head.{k}"] = v
    for i, h in enumerate(heads):
        if confident is not None:
            with torch.no_grad():
                h.fc_cls.bias[confident] += 8.0
        for k, v in h.state_dict().items():
            sd[f"bbox_head.{i}.{k}"] = v
    return sd


@pytest.fixture(scope="module")
def detectors():
    sd = _cascade_state_dict(1)
    variables = {"body": j_imp.convert_backbone_fpn(sd, depth=50),
                 **j_det.convert_cascade_heads(sd)}
    jd = j_det.MMDetCascadeDetector(jax.tree_util.tree_map(jnp.asarray, variables),
                                    depth=50, img_scale=SMALL_SCALE, **SMALL_CFG)
    model = t_imp.load_mmdet_state(t_det.CascadeRCNN(50), sd)
    td = t_det.MMDetCascadeDetector(model, img_scale=SMALL_SCALE, device="cpu",
                                    **SMALL_CFG)
    frames = np.random.default_rng(9).integers(0, 256, (3, 48, 64, 3), dtype=np.uint8)
    return jd, td, frames


def _jax_stages(jd, v, img_u8, img_hw, cfg):
    """vec_vad_tpu's cascade_detect composed from its own functions,
    keeping the intermediate tensors (v: jd's variables, an argument so
    that jit does not fold the weights into the graph)."""
    img = j_det.normalize_on_device(jnp.asarray(img_u8), img_hw)
    pyramid = [p[0] for p in jd.net.apply(v["body"], img[None])]
    ph, pw = img_u8.shape[:2]  # static under jit
    anchors = [jnp.asarray(j_det.grid_anchors(s, -(-ph // s), -(-pw // s)))
               for s in j_det.ANCHOR_STRIDES]
    per = [j_det.rpn_proposals_level(
        *jd.rpn.apply(v["rpn"], pyramid[i][None]), anchors[i], img_hw,
        cfg["nms_pre"], cfg["nms_post"], 0.7) for i in range(5)]
    boxes_all = jnp.concatenate([b.reshape(-1, 4) for b, _, _ in per])
    scores_all = jnp.concatenate([s.reshape(-1) for _, s, _ in per])
    top_s, top_i = jax.lax.top_k(scores_all, min(cfg["max_num"], scores_all.shape[0]))
    rois = boxes_all[top_i]
    out = {"pyramid": pyramid, "proposals": rois, "valid": top_s > -jnp.inf,
           "logits": [], "rois": []}
    for stage, head in enumerate(jd.heads):
        out["rois"].append(rois)
        logits, reg = head.apply(v["bbox"][stage], j_det.roi_align_pyramid(pyramid[:4], rois))
        out["logits"].append(logits)
        if stage < 2:
            rois = j_det.delta2bbox(rois, reg, j_det.STAGE_STDS[stage], img_hw)
    out["bboxes"] = j_det.delta2bbox(rois, reg, j_det.STAGE_STDS[2], img_hw)
    return out


def _jax_v1_detections(st, scale, cfg):
    """Detections (boxes, scores, labels) of one frame from _jax_stages'
    outputs in mmdet v1's get_det_bboxes order, the port's: the final
    boxes divided by the scale, then vec_vad_tpu's per-class nms_pick and
    the top max_per_img over the classes, as its cascade_detect composes
    them (which runs that NMS before the division)."""
    bboxes = jnp.asarray(np.asarray(st["bboxes"]) / np.float32(scale))
    scores = jax.nn.softmax(sum(st["logits"]) / 3.0, axis=-1)
    thr, n = cfg["score_thr"], cfg["max_per_img"]

    def per_class(cls_scores):
        s = jnp.where((cls_scores > thr) & st["valid"], cls_scores, -jnp.inf)
        idx, ok = j_det.nms_pick(bboxes, s, 0.5, n)
        return idx, jnp.where(ok, s[idx], -jnp.inf)

    idxs, kept = jax.vmap(per_class, in_axes=1)(scores[:, 1:])
    top, pick = jax.lax.top_k(kept.reshape(-1), n)
    ok = np.asarray(top > -jnp.inf)
    labels = np.asarray(pick // idxs.shape[1])
    return (np.asarray(bboxes[idxs.reshape(-1)[pick]])[ok], np.asarray(top)[ok],
            labels[ok])


def test_detect_stage_by_stage_matches_jax(detectors):
    """Pyramid, proposals, each stage's rois and logits (1e-4 relative),
    and the final detections (same count and labels, scores 1e-4, boxes
    within 1e-3 px) against vec_vad_tpu's on the same frame, so a
    threshold flip is located rather than hidden; its multiclass NMS on
    the boxes divided by the scale first, as mmdet v1 and the port run
    it."""
    jd, td, frames = detectors
    padded, img_hw, scale = j_det.preprocess(frames[0], *SMALL_SCALE)
    want = jax.jit(lambda v, im: _jax_stages(jd, v, im, img_hw, SMALL_CFG))(
        jd.variables, jnp.asarray(padded))
    got = {}
    (b, s, l, ok), t_scale = td.run(frames[:1], stages=got)
    assert t_scale == scale
    for g, w in zip(got["pyramid"], want["pyramid"]):
        assert _rel(g[0].numpy(), np.asarray(w).transpose(2, 0, 1)) <= STAGE_REL
    np.testing.assert_array_equal(got["valid"][0].numpy(), np.asarray(want["valid"]))
    assert _rel(got["proposals"][0].numpy(), want["proposals"]) <= STAGE_REL
    for stage in range(3):
        assert _rel(got["rois"][stage][0].numpy(), want["rois"][stage]) <= STAGE_REL
        assert _rel(got["logits"][stage][0].numpy(), want["logits"][stage]) <= STAGE_REL
    assert _rel(got["bboxes"][0].numpy(), want["bboxes"]) <= STAGE_REL
    jb, js, jl = _jax_v1_detections(want, scale, SMALL_CFG)
    tb, ts, tl = td.detect(frames[0])
    assert len(jl) > 0 and len(tl) == len(jl)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(ts, js, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-3)
    assert tb.dtype == jb.dtype and ts.dtype == js.dtype


def test_detect_many_matches_jax_and_detect(detectors):
    """detect_many against vec_vad_tpu's stages with mmdet v1's
    get_det_bboxes order (_jax_v1_detections) frame by frame, and against
    the port's detect of each frame alone."""
    jd, td, frames = detectors
    padded = [j_det.preprocess(f, *SMALL_SCALE) for f in frames]
    img_hw, scale = padded[0][1:]
    stages = jax.jit(lambda v, im: _jax_stages(jd, v, im, img_hw, SMALL_CFG))
    want = [_jax_v1_detections(stages(jd.variables, jnp.asarray(p)), scale, SMALL_CFG)
            for p, _, _ in padded]
    got = td.detect_many(frames)
    for i, ((b, s, l), (jb, js, jl)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(l, jl)
        np.testing.assert_allclose(s, js, rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(b, jb, rtol=0, atol=1e-3)
        b1, s1, l1 = td.detect(frames[i])
        np.testing.assert_array_equal(l1, l)
        # one frame against a batch of three: convolutions sum in another order
        np.testing.assert_allclose(s1, s, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(b1, b, rtol=1e-5, atol=1e-4)
    boxes, scores = td(frames[0])  # the AppearanceDetector protocol
    b0, s0, _ = td.detect(frames[0])
    np.testing.assert_array_equal(boxes, b0)
    np.testing.assert_array_equal(scores, s0)


# ---------------------------------------------------------------------------
# preprocessing: the cv2-free resize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(240, 360), (360, 640), (480, 856)])
def test_preprocess_bit_for_bit_with_cv2(hw):
    """The port's fixed-point resize against the JAX package's cv2 path at
    UCSDped2's, avenue's and ShanghaiTech's geometries: equal bit for bit,
    the same resized shape and scale; normalize_on_device equal with the
    pad exactly 0.0, and prepare_on_device the two composed."""
    img = np.random.default_rng(hw[0]).integers(0, 256, hw + (3,), dtype=np.uint8)
    got, g_hw, g_scale = t_det.preprocess(img)
    want, w_hw, w_scale = j_det.preprocess(img)
    assert (g_hw, g_scale) == (w_hw, w_scale)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    norm = t_det.normalize_on_device(torch.from_numpy(got), g_hw).numpy()
    np.testing.assert_allclose(norm, np.asarray(j_det.normalize_on_device(
        jnp.asarray(want), w_hw)), rtol=1e-6, atol=1e-6)
    assert np.all(norm[g_hw[0]:] == 0.0) and np.all(norm[:, g_hw[1]:] == 0.0)
    x, p_hw, p_scale = t_det.prepare_on_device(torch.from_numpy(img)[None])
    assert (p_hw, p_scale) == (g_hw, g_scale)
    np.testing.assert_array_equal(x[0].numpy().transpose(1, 2, 0), norm)


# ---------------------------------------------------------------------------
# the runner's wiring
# ---------------------------------------------------------------------------

WIRING_INI = """
[shared_parameters]
dataset_name = UCSDped2
raw_dataset_dir = raw_datasets
foreground_extraction_mode = {mode}
data_root_dir = data
modality = raw
method = SelfComplete
mmdet_checkpoint = {ckpt}
"""


def _wiring_workspace(tmp_path, mode="obj_det", seed=5):
    from vec_vad_torch.config import load_ini_config
    from vec_vad_tpu.config import load_ini_config as j_load
    from vec_vad_tpu.data.synthetic import make_synthetic_dataset

    base = str(tmp_path)
    make_synthetic_dataset(
        root=os.path.join(base, "raw_datasets", "UCSDped2"),
        frames_per_video=6, n_train_videos=1, n_test_videos=1,
        frame_h=48, frame_w=64, seed=seed, write_to_disk=True,
    )
    ckpt = os.path.join(base, "cascade_rcnn.pth")
    path = os.path.join(base, "config.cfg")
    with open(path, "w") as f:
        f.write(WIRING_INI.format(mode=mode, ckpt=ckpt))
    return base, ckpt, load_ini_config(path), j_load(path)


def test_runner_wiring_uses_configured_checkpoint(tmp_path, monkeypatch):
    """config.fore.mmdet_checkpoint routes obj_det extraction through the
    converted detector (runner.load_split, on the caller's device) instead
    of motion-only; without a card the default device raises."""
    base, ckpt, cfg, _ = _wiring_workspace(tmp_path)
    assert cfg.fore.mmdet_checkpoint == ckpt
    calls = []

    def fake_loader(path, device):
        assert path == ckpt and device == "cpu"

        def det(img):
            calls.append(img.shape)
            return (np.array([[2.0, 2.0, 30.0, 40.0]]), np.array([0.9]))
        return det

    monkeypatch.setattr(t_runner, "_mmdet_detector", fake_loader)
    data = t_runner.load_split(cfg, base, "testing", device="cpu")
    assert len(calls) == data.index.total_frames
    # the detection survived score/area filtering into the box lists
    assert all(b.shape == (1, 4) for b in data.boxes)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_runner.load_split(cfg, base, "testing")


def test_precompute_boxes_with_checkpoint_equals_jax(tmp_path, monkeypatch):
    """run_precompute_boxes and load_split with a real (random R50)
    checkpoint file: the converted detector's boxes, merged with the
    motion boxes, equal vec_vad_tpu's fixtures for the same file."""
    base, ckpt, cfg, jcfg = _wiring_workspace(tmp_path, "obj_det_with_motion", seed=6)
    torch.save({"state_dict": _cascade_state_dict(2, confident=1), "meta": {}}, ckpt)
    t_runner._mmdet_detector.cache_clear()
    small = dict(SMALL_CFG, score_thr=0.05)
    monkeypatch.setattr(t_runner, "_mmdet_detector", lambda p, d: (
        t_det.MMDetCascadeDetector.from_checkpoint(p, device=d, img_scale=SMALL_SCALE,
                                                   **small)))
    monkeypatch.setattr(j_runner, "_mmdet_detector", lambda p: (
        j_det.MMDetCascadeDetector.from_checkpoint(p, img_scale=SMALL_SCALE, **small)))
    root = os.path.join(base, "raw_datasets", "UCSDped2")
    out = t_runner.run_precompute_boxes(cfg, base, splits=("test",), device="cpu")
    got = np.load(out[0], allow_pickle=True)
    os.remove(out[0])
    data = t_runner.load_split(cfg, base, "test", device="cpu")
    j_runner.run_precompute_boxes(jcfg, base, splits=("test",))
    want = np.load(os.path.join(root, "bboxes_test_obj_det_with_motion.npy"),
                   allow_pickle=True)
    assert len(got) == len(want) == len(data.boxes)
    n_ap = 0
    for g, w, d in zip(got, want, data.boxes):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3)
        np.testing.assert_array_equal(np.asarray(d, np.float32), g)
        n_ap += g.shape[0]
    assert n_ap > 0


# ---------------------------------------------------------------------------
# trainable detectors with carried weights
# ---------------------------------------------------------------------------


def _squares(n, h, w, seed):
    """Frames with 1-2 bright squares each, and their boxes."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(40, 90, (n, h, w, 3)).astype(np.uint8)
    boxes = []
    for f in frames:
        bs = []
        for _ in range(int(rng.integers(1, 3))):
            s = int(rng.integers(6, 22))
            x0, y0 = int(rng.integers(0, w - s)), int(rng.integers(0, h - s))
            f[y0:y0 + s, x0:x0 + s] = int(rng.integers(160, 240))
            bs.append([x0, y0, x0 + s, y0 + s])
        boxes.append(np.asarray(bs, np.float32))
    return frames, boxes


def _grads_close(grads_t, grads_j):
    """Every gradient within 1e-4 of the largest gradient anywhere in the
    net: a bias gradient sums a whole map's terms, which cancel (heat's
    sums to 6e-3 from terms near 0.7, 1e-6 apart)."""
    scale = max(float(np.abs(w.numpy()).max()) for w in grads_j.values())
    assert set(grads_t) == set(grads_j)
    for k, g in grads_t.items():
        assert np.abs(g - grads_j[k].numpy()).max() <= 1e-4 * scale, k


def test_centernet_matches_jax():
    """CenterNetLite forward (at an even and an odd size: flax 'SAME' and
    the flipped ConvTranspose), the decode with its tied zeros, the first
    loss (1e-5), its gradients (1e-4) and three Adam steps of
    train_detector from the same carried initialisation, against
    vec_vad_tpu's (its loop on the test's compiled gradient)."""
    width = 8
    frames, boxes = _squares(6, 48, 64, 0)
    jnet = j_cn.CenterNetLite(width=width)
    params = jax.jit(jnet.init)(jax.random.key(0), jnp.zeros((1, 48, 64, 3)))["params"]
    sd = centernet_from_jax(params)
    tnet = t_cn.CenterNetLite(width)
    tnet.load_state_dict(sd)
    for hw in ((48, 64), (50, 66)):
        x = np.random.default_rng(1).uniform(0, 1, (2,) + hw + (3,)).astype(np.float32)
        want = jax.jit(jnet.apply)({"params": params}, jnp.asarray(x))
        with torch.no_grad():
            got = tnet(torch.from_numpy(x).permute(0, 3, 1, 2))
        for g, w in zip(got, want):
            assert _rel(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2)) <= 1e-5
    jb, js = j_cn.JaxDetector(jnet, params).detect_batch(frames[:3])
    tb, ts = t_cn.CenterNetDetector(tnet).detect_batch(frames[:3])
    assert (js == 0).any()  # ties among the exact zeros past the peaks
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tb, jb, rtol=1e-5, atol=1e-4)

    tgt = j_cn.make_targets(boxes, (48, 64))
    for a, b in zip(tgt, t_cn.make_targets(boxes, (48, 64))):
        np.testing.assert_array_equal(a, b)
    x = frames.astype(np.float32) / 255.0
    vg = jax.jit(jax.value_and_grad(lambda p, xb, tb: j_cn.detection_loss(
        jnet.apply({"params": p}, xb), tb)))
    loss_j, grads_j = vg(params, jnp.asarray(x), tgt)
    tnet.train()
    loss_t = t_cn.detection_loss(tnet(t_cn.nchw(x, "cpu")),
                                 [t_cn.nchw(t, "cpu") for t in tgt])
    loss_t.backward()
    assert abs(loss_t.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    _grads_close({k: p.grad.numpy() for k, p in tnet.named_parameters()},
                 centernet_from_jax(grads_j))

    jparams = _jax_adam_steps(vg, params, len(frames), lambda sel: (
        jnp.asarray(x[sel]), tuple(t[sel] for t in tgt)))
    tdet = t_cn.train_detector(frames, boxes, width=width, steps=3, batch_size=6, seed=0,
                               device="cpu", init_state=sd)
    want = centernet_from_jax(jparams)
    for k, v in tdet.net.state_dict().items():
        # Adam's first steps move each weight by ~lr = 1e-3 whatever its
        # gradient's size; the carried weights agree to float rounding
        assert np.abs(v.numpy() - want[k].numpy()).max() <= 1e-5, k


def _jax_adam_steps(vg, params, n, batch, steps=3, batch_size=6, seed=0):
    """vec_vad_tpu's training loop (train_detector /
    train_cascade_detector): batches drawn by default_rng(seed), optax
    Adam at lr 1e-3, here on the test's jitted value_and_grad `vg` so
    that one compilation serves the first loss and the steps."""
    import optax

    tx = optax.adam(1e-3)

    @jax.jit
    def update(g, opt, p):
        updates, opt = tx.update(g, opt, p)
        return optax.apply_updates(p, updates), opt

    opt = jax.jit(tx.init)(params)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        sel = rng.integers(0, n, batch_size)
        _, g = vg(params, *batch(sel))
        params, opt = update(g, opt, params)
    return params


def _jax_cascade_loss(net, params, xb, tb, gtb, gvb, top_k):
    """The loss inside vec_vad_tpu's train_cascade_detector step."""
    H, W = xb.shape[1:3]
    v = {"params": params}
    pyr = net.apply(v, xb, method=net.pyramid)
    level_outs = net.apply(v, pyr, method=net.propose)
    loss = 0.0
    for outs, tgt in zip(level_outs, tb):
        loss = loss + j_cas._center_loss(outs, tgt)

    def one(feats, outs, g, gv):
        boxes, _ = j_cas.decode_proposals(outs, (H, W), top_k=top_k)
        l = 0.0
        b = jax.lax.stop_gradient(boxes)
        for stage, thr in enumerate(j_cas.STAGE_IOUS):
            delta, score = net.apply(v, stage, j_cas.roi_align_pyramid(feats, b),
                                     method=net.refine)
            l = l + j_cas._stage_loss(delta, score, b, g, gv, thr)
            b = jax.lax.stop_gradient(j_cas.apply_delta(b, delta))
        return l

    return loss + jnp.mean(jax.vmap(one)(pyr, level_outs, gtb, gvb))


def test_cascade_detector_matches_jax():
    """CascadeFPNNet's pyramid and proposals, the cascade decode, the first
    loss (1e-5), its gradients (1e-4) and three Adam steps from the same
    carried initialisation, against vec_vad_tpu's; plus the geometry
    helpers on the same boxes."""
    width, top_k = 8, 16
    frames, boxes = _squares(6, 64, 96, 1)
    jnet = j_cas.CascadeFPNNet(width=width)
    variables = jax.jit(jnet.init)(jax.random.key(0), jnp.zeros((1, 64, 96, 3)))
    sd = cascade_from_jax(variables)
    tnet = t_cas.CascadeFPNNet(width)
    tnet.load_state_dict(sd)

    x = frames.astype(np.float32) / 255.0
    @jax.jit
    def jax_front(v, xb):
        pyr = jnet.apply(v, xb, method=jnet.pyramid)
        outs = jnet.apply(v, pyr, method=jnet.propose)
        return pyr, jax.vmap(lambda o: j_cas.decode_proposals(o, (64, 96), top_k=top_k))(outs)

    jpyr, (jb, js) = jax_front(variables, jnp.asarray(x))
    with torch.no_grad():
        tpyr = tnet.pyramid(t_cn.nchw(x, "cpu"))
        touts = tnet.propose(tpyr)
    for g, w in zip(tpyr, jpyr):
        assert _rel(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2)) <= 1e-5
    tb, ts = t_cas.decode_proposals(touts, (64, 96), top_k=top_k)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5, atol=1e-4)

    got = t_cas.CascadeDetector(tnet, top_k=top_k).detect_batch(frames[:3])
    want = j_cas.CascadeDetector(jnet, variables, top_k=top_k).detect_batch(frames[:3])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-3)

    b = jnp.asarray(np.array(jb).reshape(-1, 4)[:12])
    g = jnp.asarray(np.concatenate(boxes)[:5])
    np.testing.assert_allclose(t_cas.iou_matrix(torch.from_numpy(np.array(b)),
                                                torch.from_numpy(np.array(g))).numpy(),
                               np.asarray(j_cas.iou_matrix(b, g)), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(t_cas.level_of_boxes(torch.from_numpy(np.array(b))).numpy(),
                                  np.asarray(j_cas.level_of_boxes(b)))
    d = np.random.default_rng(2).normal(0, 0.3, (12, 4)).astype(np.float32)
    np.testing.assert_allclose(
        t_cas.apply_delta(torch.from_numpy(np.array(b)), torch.from_numpy(d)).numpy(),
        np.asarray(j_cas.apply_delta(b, jnp.asarray(d))), rtol=1e-6, atol=1e-4)
    feat = np.random.default_rng(3).normal(size=(6, 16, 24)).astype(np.float32)
    np.testing.assert_allclose(
        t_cas.roi_align(torch.from_numpy(feat), torch.from_numpy(np.array(b)), 4)
        .numpy().transpose(0, 2, 3, 1),
        np.asarray(j_cas.roi_align(jnp.asarray(feat.transpose(1, 2, 0)), b, 4)),
        rtol=1e-6, atol=1e-6)

    # the first loss and its gradients on one batch
    targets = j_cas.make_level_targets(boxes, (64, 96))
    for a, t in zip(targets, t_cas.make_level_targets(boxes, (64, 96))):
        for u, w in zip(a, t):
            np.testing.assert_array_equal(u, w)
    gt = np.zeros((6, 8, 4), np.float32)
    gv = np.zeros((6, 8), bool)
    for i, bs in enumerate(boxes):
        gt[i, :len(bs)], gv[i, :len(bs)] = bs, True
    vg = jax.jit(jax.value_and_grad(lambda p, xb, tb, gtb, gvb: _jax_cascade_loss(
        jnet, p, xb, tb, gtb, gvb, top_k)))
    batch = lambda sel: (jnp.asarray(x[sel]), [tuple(u[sel] for u in t) for t in targets],
                         jnp.asarray(gt[sel]), jnp.asarray(gv[sel]))
    loss_j, grads_j = vg(variables["params"], *batch(np.arange(6)))
    loss_t = t_cas.cascade_loss(
        tnet, t_cn.nchw(x, "cpu"), [[t_cn.nchw(u, "cpu") for u in t] for t in targets],
        torch.from_numpy(gt), torch.from_numpy(gv), top_k)
    loss_t.backward()
    assert abs(loss_t.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    _grads_close({k: p.grad.numpy() for k, p in tnet.named_parameters()},
                 cascade_from_jax({"params": grads_j}))

    jparams = _jax_adam_steps(vg, variables["params"], len(frames), batch)
    tdet = t_cas.train_cascade_detector(frames, boxes, width=width, steps=3,
                                        batch_size=6, top_k=top_k, seed=0,
                                        device="cpu", init_state=sd)
    want = cascade_from_jax({"params": jparams})
    for k, v in tdet.net.state_dict().items():
        assert np.abs(v.numpy() - want[k].numpy()).max() <= 1e-5, k
