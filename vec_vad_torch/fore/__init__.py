"""Foreground localization (vec_vad_tpu/fore): motion maps on the device
with host contours, overlap suppression, the grid-patch and whole-frame
modes, and the split-level driver over the four extraction modes. The
appearance detectors (Cascade R-CNN and its mmdet import) are ROADMAP.md
Queue 1 item 4.2's."""

from vec_vad_torch.fore.suppress import del_cover_bboxes  # noqa: F401
from vec_vad_torch.fore.patches import get_patch_boxes, full_frame_box  # noqa: F401
from vec_vad_torch.fore.motion import motion_maps, motion_bboxes  # noqa: F401
from vec_vad_torch.fore.detector import (  # noqa: F401
    AppearanceDetector,
    PrecomputedDetector,
    filter_detections,
    compute_foreground_bboxes,
)
