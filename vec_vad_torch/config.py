"""Typed configuration for the VAD pipeline.

A copy of vec_vad_tpu/config.py (NumPy-free, stdlib only), kept here so
the port imports nothing of the JAX package. The two must stay equal:
tests/test_torch_isolation.py compares them field by field.

Mirrors every knob of the reference INI config (config.cfg)
plus the per-dataset constant tables that the reference hard-codes across
files (frame_size table at vad_datasets.py:16, detector thresholds at
fore_det/obj_det_with_motion.py:59-68,104-110,157-171).

The reference reads its config with stdlib ConfigParser (train.py:19-42,
test.py:18-41); `load_ini_config` accepts that exact file format so existing
config.cfg files keep working.
"""

from __future__ import annotations

import dataclasses
from configparser import ConfigParser
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple


# ---------------------------------------------------------------------------
# Dataset registry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DatasetSpec:
    """Static per-dataset facts.

    Merges the reference's `frame_size` table (vad_datasets.py:16) with the
    per-dataset foreground-detector thresholds that the reference hard-codes
    in fore_det/obj_det_with_motion.py:59-68 (appearance), :104-110 (overlap
    suppression) and :157-171 (motion).
    """

    name: str
    frame_h: int
    frame_w: int
    file_ext: str
    scene_num: int
    # Appearance-detector filtering (obj_det_with_motion.py:59-68).
    ap_score_thr: float
    ap_min_area: float
    # Overlap suppression (obj_det_with_motion.py:104-110).
    cover_thr: float
    # Motion detector (obj_det_with_motion.py:157-171).
    mt_area_thr: float
    mt_binary_thr: float
    mt_extend: int
    mt_gauss_mask_size: int

    @property
    def frame_hw(self) -> Tuple[int, int]:
        return (self.frame_h, self.frame_w)


DATASETS: Dict[str, DatasetSpec] = {
    "UCSDped1": DatasetSpec(
        name="UCSDped1", frame_h=158, frame_w=238, file_ext=".tif", scene_num=1,
        ap_score_thr=0.5, ap_min_area=100.0, cover_thr=0.6,
        mt_area_thr=100.0, mt_binary_thr=18.0, mt_extend=2, mt_gauss_mask_size=3,
    ),
    "UCSDped2": DatasetSpec(
        name="UCSDped2", frame_h=240, frame_w=360, file_ext=".tif", scene_num=1,
        ap_score_thr=0.5, ap_min_area=100.0, cover_thr=0.6,
        mt_area_thr=100.0, mt_binary_thr=18.0, mt_extend=2, mt_gauss_mask_size=3,
    ),
    "avenue": DatasetSpec(
        name="avenue", frame_h=360, frame_w=640, file_ext=".jpg", scene_num=1,
        ap_score_thr=0.25, ap_min_area=1600.0, cover_thr=0.6,
        mt_area_thr=1600.0, mt_binary_thr=18.0, mt_extend=2, mt_gauss_mask_size=5,
    ),
    "ShanghaiTech": DatasetSpec(
        name="ShanghaiTech", frame_h=480, frame_w=856, file_ext=".jpg", scene_num=1,
        ap_score_thr=0.5, ap_min_area=64.0, cover_thr=0.65,
        mt_area_thr=64.0, mt_binary_thr=15.0, mt_extend=2, mt_gauss_mask_size=5,
    ),
}


def register_dataset(spec: DatasetSpec) -> None:
    """Add a custom dataset to the registry (used by tests for tiny synthetic
    datasets)."""
    DATASETS[spec.name] = spec


# ---------------------------------------------------------------------------
# Stage configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ForegroundConfig:
    """Foreground localization + block routing knobs.

    Mirrors the per-dataset INI sections (config.cfg:17-52) and the shared
    `foreground_extraction_mode` knob (config.cfg:6).
    """

    # 'obj_det_with_motion' | 'obj_det' | 'simple_patch' | 'frame'
    extraction_mode: str = "obj_det_with_motion"
    patch_size: int = 32
    h_block: int = 1
    w_block: int = 1
    train_block_mode: int = 1
    test_block_mode: int = 1
    motion_thr: float = 0.0
    save_seg_num: int = 40000
    # Static capacity for padded per-frame bbox sets. The shipped reference
    # fixtures peak at ~22 boxes/frame; 64 leaves headroom for dense scenes.
    max_boxes_per_frame: int = 64
    # Path to a real mmdet cascade_rcnn_*_fpn checkpoint (the reference's
    # appearance detector, fore_det/inference.py:51-81). When set and no
    # bbox fixture exists, obj_det modes run the converted detector
    # (fore/mmdet_detector.py) instead of degrading to motion-only.
    mmdet_checkpoint: Optional[str] = None


@dataclass(frozen=True)
class CompletionConfig:
    """[SelfComplete] section (config.cfg:55-74)."""

    border_mode: str = "predict"  # 'predict' | 'elastic' | 'hard'
    epochs: int = 10
    batch_size: int = 128
    nf: int = 32  # features_root
    use_flow: bool = True
    context_frame_num: int = 4
    context_of_num: int = 4
    raw_range: int = 10  # >= tot_raw_num means "train every erased position"
    padding: bool = False
    lambda_raw: float = 1.0
    lambda_of: float = 1.0
    w_raw: float = 1.0
    w_of: float = 1.0
    # Knobs with no reference analog:
    learning_rate: float = 1e-3  # torch.optim.Adam default (train.py:290)
    adam_eps: float = 1e-7  # train.py:290
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'
    # masked_bn: BatchNorm batch statistics ignore wrap-padded rows, exactly
    # reproducing the reference's bare-partial-batch BN (train.py:383-402).
    # False = stats include the wrap-padded duplicates (cheaper, tiny drift
    # on the final batch of each epoch; quantified in tests/test_masked_bn.py)
    masked_bn: bool = True

    # -- derived quantities (train.py:246-254) --

    @property
    def tot_raw_num(self) -> int:
        if self.border_mode == "predict":
            return self.context_frame_num + 1
        return 2 * self.context_frame_num + 1

    @property
    def tot_of_num(self) -> int:
        if self.border_mode == "predict":
            return self.context_of_num + 1
        return 2 * self.context_of_num + 1

    @property
    def resolved_raw_range(self) -> Optional[int]:
        """None means "all positions" (train.py:252-254)."""
        if self.raw_range >= self.tot_raw_num:
            return None
        return self.raw_range

    @property
    def raw_center_idx(self) -> int:
        # model/unet.py:78-83
        if self.border_mode == "predict":
            return self.tot_raw_num - 1
        return (self.tot_raw_num - 1) // 2

    @property
    def of_center_idx(self) -> int:
        if self.border_mode == "predict":
            return self.tot_of_num - 1
        return (self.tot_of_num - 1) // 2

    @property
    def raw_of_offset(self) -> int:
        # model/unet.py:95
        return self.raw_center_idx - self.of_center_idx


@dataclass(frozen=True)
class PipelineConfig:
    """Top-level pipeline config (the [shared_parameters] section plus
    per-stage sub-configs)."""

    dataset_name: str = "UCSDped2"
    raw_dataset_dir: str = "raw_datasets"
    data_root_dir: str = "data"
    modality: str = "raw2flow"  # 'raw_datasets' | 'raw2flow' | 'optical_flow'
    method: str = "SelfComplete"
    optical_flow_dir: str = "optical_flow"
    results_dir: str = "results"
    fore: ForegroundConfig = field(default_factory=ForegroundConfig)
    model: CompletionConfig = field(default_factory=CompletionConfig)
    # Stage-cache flags (config.cfg:21-25).
    train_bbox_saved: bool = True
    train_foreground_saved: bool = False
    test_bbox_saved: bool = True
    test_foreground_saved: bool = False
    scores_saved: bool = False

    @property
    def dataset(self) -> DatasetSpec:
        return DATASETS[self.dataset_name]

    def replace(self, **kwargs) -> "PipelineConfig":
        return dataclasses.replace(self, **kwargs)


# ---------------------------------------------------------------------------
# INI compatibility loader
# ---------------------------------------------------------------------------


def load_ini_config(path: str) -> PipelineConfig:
    """Load a reference-format config.cfg into a PipelineConfig.

    Accepts the exact INI surface the reference reads in train.py:19-42 /
    test.py:18-41 (shared_parameters + per-dataset + [SelfComplete]).
    """
    cp = ConfigParser()
    read = cp.read(path)
    if not read:
        raise FileNotFoundError(path)

    shared = cp["shared_parameters"]
    dataset_name = shared.get("dataset_name", "UCSDped2")
    ds = cp[dataset_name] if cp.has_section(dataset_name) else {}

    def ds_get(key, conv, default):
        if key in ds:
            return conv(ds[key])
        return default

    fore = ForegroundConfig(
        extraction_mode=shared.get("foreground_extraction_mode", "obj_det_with_motion"),
        patch_size=ds_get("patch_size", int, 32),
        h_block=ds_get("h_block", int, 1),
        w_block=ds_get("w_block", int, 1),
        train_block_mode=ds_get("train_block_mode", int, 1),
        test_block_mode=ds_get("test_block_mode", int, 1),
        motion_thr=ds_get("motionthr", float, 0.0),
        save_seg_num=ds_get("savesegnum", int, 40000),
        mmdet_checkpoint=shared.get("mmdet_checkpoint", None) or None,
    )

    model = CompletionConfig()
    if cp.has_section("SelfComplete"):
        sc = cp["SelfComplete"]
        model = CompletionConfig(
            border_mode=sc.get("border_mode", "predict"),
            epochs=sc.getint("epochs", 10),
            batch_size=sc.getint("batch_size", 128),
            nf=sc.getint("nf", 32),
            use_flow=sc.getboolean("useFlow", True),
            context_frame_num=sc.getint("context_frame_num", 4),
            context_of_num=sc.getint("context_of_num", 4),
            raw_range=sc.getint("rawRange", 10),
            padding=sc.getboolean("padding", False),
            lambda_raw=sc.getfloat("lambda_raw", 1.0),
            lambda_of=sc.getfloat("lambda_of", 1.0),
            w_raw=sc.getfloat("w_raw", 1.0),
            w_of=sc.getfloat("w_of", 1.0),
            masked_bn=sc.getboolean("masked_bn", True),
        )

    def _flag(name: str, default: bool) -> bool:
        try:
            return cp.getboolean(dataset_name, name)
        except Exception:
            return default

    return PipelineConfig(
        dataset_name=dataset_name,
        raw_dataset_dir=shared.get("raw_dataset_dir", "raw_datasets"),
        data_root_dir=shared.get("data_root_dir", "data"),
        modality=shared.get("modality", "raw2flow"),
        method=shared.get("method", "SelfComplete"),
        fore=fore,
        model=model,
        train_bbox_saved=_flag("train_bbox_saved", True),
        train_foreground_saved=_flag("train_foreground_saved", False),
        test_bbox_saved=_flag("test_bbox_saved", True),
        test_foreground_saved=_flag("test_foreground_saved", False),
        scores_saved=_flag("scores_saved", False),
    )
