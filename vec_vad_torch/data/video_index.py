"""Video index: flat frame addressing over multi-video datasets, plus the
temporal context-window computation.

A copy of vec_vad_tpu/data/video_index.py (NumPy only), kept here so
the port imports nothing of the JAX package; tests/test_torch_isolation.py
holds the two equal.

The reference builds a flat `all_frame_addr` list and a parallel 1-based
`frame_video_idx` per dataset class (vad_datasets.py:205-275,433-485,645-708)
and computes context windows per frame with `context_range`
(vad_datasets.py:277-354) — identical code replicated in all three dataset
classes. Here both are dataset-agnostic: the index stores only video lengths
and paths; `context_indices` computes the (N, T) window matrix for ALL frames
at once with NumPy (the reference recomputes per frame in Python).

Border-mode semantics replicated exactly, including the literal
video-boundary `offset` arithmetic and the "video too short" failure
conditions:
  * 'elastic'  — slide the window to fit inside the center frame's video
  * 'predict'  — past-only window [i-ctx, i]; out-of-video frames replaced
                 by duplicating the earliest in-video frame
  * 'hard'     — clamp at video boundaries, duplicating edge frames
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np


class VideoTooShortError(ValueError):
    """Raised where the reference prints 'The video is too short or the
    context frame number is too large!' and raises (vad_datasets.py:317-337).
    """


def context_indices(
    frame_video_idx: np.ndarray, context_num: int, border_mode: str
) -> np.ndarray:
    """Compute temporal context windows for every frame at once.

    Args:
      frame_video_idx: (N,) int array; frames of the same video share a value
        and videos are contiguous (the reference's 1-based list).
      context_num: frames of context on each side (or behind, for 'predict').
      border_mode: 'elastic' | 'predict' | 'hard'.

    Returns:
      (N, T) int64 matrix of flat frame indices, T = context_num + 1 for
      'predict' else 2 * context_num + 1. Row i lists the window for frame i,
      center/right-most entry == i (except elastic near array bounds).
    """
    v = np.asarray(frame_video_idx, dtype=np.int64)
    n = v.size
    ctx = int(context_num)
    if ctx == 0:
        return np.arange(n, dtype=np.int64)[:, None]
    i = np.arange(n, dtype=np.int64)
    # Windowed sums of v via prefix sums, for the literal `offset` arithmetic
    # (vad_datasets.py:315-316).
    cs = np.concatenate([[0], np.cumsum(v)])

    if border_mode == "elastic":
        T = 2 * ctx + 1
        if n < T:
            raise VideoTooShortError("dataset shorter than the context window")
        c = np.clip(i, ctx, n - 1 - ctx)
        win_sum = cs[c + ctx + 1] - cs[c - ctx]
        offset = win_sum - T * v[c]
        # Extreme condition (vad_datasets.py:317-319).
        bad = (v[c - ctx] != v[c]) & (v[c + ctx] != v[c])
        if np.any(bad):
            raise VideoTooShortError("window crosses video bounds on both sides")
        first = c - ctx - offset
        return first[:, None] + np.arange(T, dtype=np.int64)[None, :]

    if border_mode == "predict":
        T = ctx + 1
        start = np.maximum(i - ctx, 0)
        pad = T - (i - start + 1)
        # After duplicating the head value `pad` times, the window sum gains
        # pad * v[start].
        win_sum = cs[i + 1] - cs[start] + pad * v[start]
        offset = win_sum - T * v[i]
        if np.any((pad > 0) & (offset != 0)):
            raise VideoTooShortError("leading video shorter than the window")
        first = start - offset  # offset <= 0 here
        dup = np.maximum(np.abs(offset), pad)
        t = np.arange(T, dtype=np.int64)[None, :]
        return first[:, None] + np.maximum(t - dup[:, None], 0)

    if border_mode == "hard":
        T = 2 * ctx + 1
        start = np.maximum(i - ctx, 0)
        end = np.minimum(i + ctx, n - 1)
        pad = T - (end - start + 1)
        pad_at_head = start == 0
        pad_val = np.where(pad_at_head, v[start], v[end])
        win_sum = cs[end + 1] - cs[start] + pad * pad_val
        offset = win_sum - T * v[i]
        bad = (v[start] != v[i]) & (v[end] != v[i])
        bad |= (pad > 0) & (offset != 0)
        if np.any(bad):
            raise VideoTooShortError("video too short for hard border mode")
        t = np.arange(T, dtype=np.int64)[None, :]
        base = start[:, None] + t
        res_pos = np.minimum(base, (end - offset)[:, None])  # offset > 0
        res_neg = np.maximum(base, (start - offset)[:, None])  # offset < 0
        res_pad_head = np.maximum(t - pad[:, None], 0)  # pad > 0, start == 0
        res_pad_tail = np.minimum(base, end[:, None])  # pad > 0, start > 0
        out = base.copy()
        out = np.where((offset > 0)[:, None], res_pos, out)
        out = np.where((offset < 0)[:, None], res_neg, out)
        head = ((offset == 0) & (pad > 0) & pad_at_head)[:, None]
        tail = ((offset == 0) & (pad > 0) & ~pad_at_head)[:, None]
        out = np.where(head, res_pad_head, out)
        out = np.where(tail, res_pad_tail, out)
        return out

    raise NotImplementedError(f"border_mode={border_mode!r}")


@dataclass
class VideoIndex:
    """Flat index over the frames of an ordered list of videos."""

    video_names: List[str]
    video_lengths: np.ndarray  # (V,) int
    frame_paths: Optional[List[str]] = None  # flat, len == total frames
    scene_idx: Optional[np.ndarray] = None  # (N,) 1-based, ShanghaiTech only
    save_scene_idx: Optional[np.ndarray] = None

    frame_video_idx: np.ndarray = field(init=False)  # (N,) 1-based

    def __post_init__(self) -> None:
        self.video_lengths = np.asarray(self.video_lengths, dtype=np.int64)
        self.frame_video_idx = np.repeat(
            np.arange(1, len(self.video_lengths) + 1), self.video_lengths
        )
        if self.frame_paths is not None:
            assert len(self.frame_paths) == self.total_frames

    @property
    def total_frames(self) -> int:
        return int(self.video_lengths.sum())

    @property
    def num_videos(self) -> int:
        return len(self.video_lengths)

    def context_indices(self, context_num: int, border_mode: str) -> np.ndarray:
        return context_indices(self.frame_video_idx, context_num, border_mode)

    # -- construction from on-disk dataset layouts --------------------------

    @classmethod
    def from_video_dirs(
        cls, video_dirs: Sequence[str], file_ext: str
    ) -> "VideoIndex":
        names, lengths, paths = [], [], []
        for vdir in video_dirs:
            frames = sorted(glob.glob(os.path.join(vdir, "*" + file_ext)))
            if not frames:
                continue
            names.append(os.path.basename(vdir))
            lengths.append(len(frames))
            paths.extend(frames)
        return cls(names, np.array(lengths), paths)

    @classmethod
    def from_layout(
        cls, dataset_name: str, root: str, mode: str, file_ext: Optional[str] = None
    ) -> "VideoIndex":
        """Replicates the directory conventions of the three reference
        dataset classes (vad_datasets.py:205-260,433-478,645-697).

        Unknown dataset names fall back to the UCSD layout (Train/ + Test/),
        which the synthetic test datasets also use.
        """
        from vec_vad_torch.config import DATASETS

        if file_ext is None:
            file_ext = DATASETS[dataset_name].file_ext if dataset_name in DATASETS else ".jpg"

        def subdirs(d):
            return sorted(p for p in glob.glob(os.path.join(d, "*")) if os.path.isdir(p))

        if dataset_name == "avenue":
            sub = "training/frames" if mode == "train" else "testing/frames"
            return cls.from_video_dirs(subdirs(os.path.join(root, sub)), file_ext)

        if dataset_name == "ShanghaiTech":
            if mode == "train":
                vdirs = subdirs(os.path.join(root, "training", "videosFrame"))
            else:
                vdirs = []
                for part in (1, 2):
                    vdirs += subdirs(
                        os.path.join(root, "Testing", f"frames_part{part}")
                    )
            idx = cls.from_video_dirs(vdirs, file_ext)
            # ShanghaiTech tags each frame with the scene encoded in the
            # video-name prefix; the reference processes everything as one
            # scene (scene_idx all ones, vad_datasets.py:668-669,690-691).
            save_scene = np.concatenate(
                [
                    np.full(l, int(name[:2]), dtype=np.int64)
                    for name, l in zip(idx.video_names, idx.video_lengths)
                ]
            ) if idx.num_videos else np.zeros(0, np.int64)
            idx.save_scene_idx = save_scene
            idx.scene_idx = np.ones(idx.total_frames, dtype=np.int64)
            return idx

        # UCSD layout (and synthetic datasets): Train/Train*, Test/Test*
        # with sibling *_gt dirs (vad_datasets.py:205-260).
        sub = "Train" if mode == "train" else "Test"
        dirs = [
            d
            for d in subdirs(os.path.join(root, sub))
            if not d.endswith("_gt")
        ]
        return cls.from_video_dirs(dirs, file_ext)
