"""The cells `ped2_5raw.fleet_dense` and `sht_cascade_r101_5raw.detect_fleet`
end to end at CPU sizes (the detect cell: R50 at 64 x 96 frames, img_scale
(160, 96), tens of proposals, 2 cameras), the detector's published FLOP
count and its readers."""

from __future__ import annotations

import json
import time

import pytest

from conftest import ROOT, _merge, tiny
from vadbench.run import load_cell, run_cell

SEED = 2 ** 33 + 12345
DETECT = "sht_cascade_r101_5raw.detect_fleet"
TINY_DETECT_TRAFFIC = {"cameras": 2, "pool_ticks": 6, "objects": 4, "object_side": [8, 24],
                       "calibration_ticks": 2, "boxes_per_frame": 3, "warm_ticks": 2,
                       "stats_ticks": 2, "check_ticks": 3}
TINY_DETECT_CONFIG = {"frame_hw": [64, 96], "patch_size": 16, "model": {"nf": 4},
                      "detector": {"depth": 50, "img_scale": [160, 96],
                                   "test_cfg": {"nms_pre": 60, "nms_post": 40, "max_num": 40,
                                                "max_per_img": 20}}}


def _tiny_detect():
    cell, config, e2e, per_layer = load_cell(DETECT)
    return (_merge(cell, {"traffic": TINY_DETECT_TRAFFIC}),
            _merge(config, TINY_DETECT_CONFIG), e2e, per_layer)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", ["ped2_5raw.fleet_dense", DETECT])
def test_new_cell_end_to_end(name, trace):
    cell, config, e2e, per_layer = _tiny_detect() if name == DETECT else tiny(name)
    result = run_cell(cell, config, SEED, 0.2, trace, e2e, per_layer, device="cpu",
                      t_start=time.perf_counter())
    assert result["correct"], result["compared"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    if trace == 0:
        assert set(result["metrics"]) == {m["name"] for m in e2e}
    elif name == DETECT:
        # off the card only the counters read
        assert "detect_boxes_per_frame.serve" in result["metrics"]
    want = {"score_gap"} | ({"pyramid_gap", "stage_gap", "proposal_miss", "det_mismatch"}
                            if name == DETECT else set())
    assert set(result["compared"]) == want
    json.dumps(result)


def test_detect_cell_tf32_control_reads_higher():
    """The TF32 control in the program's place reads above the program on
    the detector's gaps (vadbench.control's readings, CPU size)."""
    from vadbench.control import readings

    cell, config, _, _ = _tiny_detect()
    out = readings(cell, config, SEED, 0.2, ["tf32"], device="cpu")
    assert out["tf32"]["pyramid_gap"] > 10 * out["program"]["pyramid_gap"]
    assert out["tf32"]["stage_gap"] > 10 * out["program"]["stage_gap"]


def _first_suppresses_nothing(keep_fn):
    """greedy_keep with each row's first valid candidate suppressing
    nothing. (Skipping only its first suppression changes no keep at this
    size: another kept candidate suppresses that box too.)"""
    def faulty(over, valid, **kw):
        first = valid & (valid.cumsum(-1) == 1)
        return keep_fn(over & ~first[..., :, None], valid, **kw)
    return faulty


def _drop_first_kept(keep_fn):
    """greedy_keep with each row's first kept candidate dropped."""
    def faulty(over, valid, **kw):
        keep = keep_fn(over, valid, **kw)
        return keep & ~(keep & (keep.cumsum(-1) == 1))
    return faulty


@pytest.mark.parametrize("fault", [_first_suppresses_nothing, _drop_first_kept])
def test_detect_cell_catches_a_planted_nms_fault(monkeypatch, fault):
    """The program's greedy NMS (the RPN's and the multiclass step's) with
    one box's suppressions skipped, or one kept box dropped, a row: the
    detect cell reads not correct, on proposal_miss or det_mismatch."""
    from vec_vad_torch.fore import mmdet_detector

    monkeypatch.setattr(mmdet_detector, "greedy_keep", fault(mmdet_detector.greedy_keep))
    cell, config, e2e, per_layer = _tiny_detect()
    result = run_cell(cell, config, SEED, 0.2, 0, e2e, per_layer, device="cpu",
                      t_start=time.perf_counter())
    compared = result["compared"]
    assert not result["correct"], compared
    assert any(compared[k]["value"] > compared[k]["limit"]
               for k in ("proposal_miss", "det_mismatch")), compared


def test_detector_flops_from_published_shapes():
    from vadbench import counts_det

    assert counts_det.canvas((480, 856)) == (768, 1344)
    # ResNet-101 at 224 x 224: 7.8 G multiply-adds (He et al., 2016)
    assert abs(counts_det.resnet_flops(101, 224, 224)[0] / 2e9 - 7.8) < 0.05
    assert 0.60e12 < counts_det.frame_flops((480, 856)) < 0.65e12
    config = json.loads((ROOT / "vadbench" / "configs" / "sht_cascade_r101_5raw.json").read_text())
    work = {"det_frames": 8, "valid_cubes": 96}
    assert counts_det.work_flops(work, config) > 8 * counts_det.frame_flops((480, 856))
