"""Foreground localization (vec_vad_tpu/fore): motion maps on the device
with host contours, overlap suppression, the grid-patch and whole-frame
modes, the split-level driver over the four extraction modes, and the
appearance detectors: the mmdet Cascade R-CNN behind a checkpoint
(mmdet_import, mmdet_detector) and the trainable cascade and
CenterNet-lite detectors (cascade_detector, centernet_detector)."""

from vec_vad_torch.fore.suppress import del_cover_bboxes  # noqa: F401
from vec_vad_torch.fore.patches import get_patch_boxes, full_frame_box  # noqa: F401
from vec_vad_torch.fore.motion import motion_maps, motion_bboxes  # noqa: F401
from vec_vad_torch.fore.detector import (  # noqa: F401
    AppearanceDetector,
    PrecomputedDetector,
    filter_detections,
    compute_foreground_bboxes,
)
from vec_vad_torch.fore.cascade_detector import (  # noqa: F401
    CascadeDetector,
    CascadeFPNNet,
    train_cascade_detector,
)
from vec_vad_torch.fore.mmdet_import import (  # noqa: F401
    BackboneFPN,
    load_backbone_fpn,
    load_mmdet_state,
)
