"""Frame / flow / ground-truth IO.

A copy of vec_vad_tpu/data/readers.py, kept here so the port imports
nothing of the JAX package; tests/test_torch_isolation.py holds the two
equal. cv2 and scipy are imported only by the functions that read
formats other than `.npy`.

Mirrors the reference's input conventions: frames through cv2.imread (BGR,
uint8, grayscale formats expanded to 3 channels — vad_datasets.py:18-25),
flow maps as float32 `.npy`, and the three ground-truth formats
(vad_datasets.py:262-272,480-483,699-706).
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional

import numpy as np

from vec_vad_torch.data.video_index import VideoIndex


def read_frame(path: str) -> np.ndarray:
    """Read one frame or flow map as an (H, W, C) array.

    cv2.imread semantics (vad_datasets.py:18-25): BGR channel order, uint8;
    `.npy` files load as-is (flow maps, float32 (H, W, 2)); `.mat` files load
    the 'uv' key.
    """
    ext = path.rsplit(".", 1)[-1].lower()
    if ext == "npy":
        return np.load(path)
    if ext == "mat":
        import scipy.io as sio

        return sio.loadmat(path, verify_compressed_data_integrity=False)["uv"]
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(f"cv2 could not read {path}")
    return img


def load_frames(
    index: VideoIndex, indices: Optional[np.ndarray] = None
) -> np.ndarray:
    """Load frames as one (N, H, W, C) array (uint8 for images, float32 for
    flow). All frames must share a shape.

    This is the HBM-residency entry point: the returned array is moved to
    device once and every downstream stage (STC extraction, scoring) reads
    from it on-device, replacing the reference's per-frame cv2 round-trips
    (vad_datasets.py:356-402).
    """
    assert index.frame_paths is not None, "index has no file paths"
    if indices is None:
        indices = np.arange(index.total_frames)
    frames = [read_frame(index.frame_paths[i]) for i in np.asarray(indices)]
    return np.stack(frames, axis=0)


class LazyFrameStack:
    """Array-like view over a frame tree that decodes on slice.

    Supports the subset of the ndarray interface the pipeline's streaming
    extraction uses (`shape`, `frames[lo:hi]`), so datasets larger than
    host RAM (ShanghaiTech: ~340 GB of frames) stream from disk chunk by
    chunk instead of being loaded whole — the reference achieves the same
    with per-frame cv2.imread calls in its Dataset classes
    (vad_datasets.py:356-402).
    """

    def __init__(self, index: VideoIndex):
        assert index.frame_paths is not None
        self.index = index
        probe = read_frame(index.frame_paths[0])
        self.shape = (index.total_frames,) + probe.shape
        self.dtype = probe.dtype

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, key):
        if isinstance(key, slice):
            idxs = range(*key.indices(self.shape[0]))
            return np.stack(
                [read_frame(self.index.frame_paths[i]) for i in idxs]
            )
        if np.isscalar(key) or isinstance(key, (int, np.integer)):
            return read_frame(self.index.frame_paths[int(key)])
        key = np.asarray(key)
        flat = np.stack(
            [read_frame(self.index.frame_paths[int(i)]) for i in key.ravel()]
        )
        return flat.reshape(key.shape + flat.shape[1:])

    def __array__(self, dtype=None):
        out = self[0 : self.shape[0]]
        return out.astype(dtype) if dtype is not None else out


class LazyFlowStack:
    """LazyFrameStack for a mirrored optical-flow .npy tree
    (calc_optical_flow.py:30-38 layout)."""

    def __init__(self, index: VideoIndex, of_root: str, dataset_root: str):
        import os

        assert index.frame_paths is not None
        self.paths = []
        prefix = os.path.normpath(dataset_root)
        for p in index.frame_paths:
            rel = os.path.relpath(os.path.normpath(p), prefix)
            stem = os.path.splitext(rel)[0]
            self.paths.append(os.path.join(of_root, stem + ".npy"))
        probe = np.load(self.paths[0])
        self.shape = (len(self.paths),) + probe.shape
        self.dtype = probe.dtype

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, key):
        if isinstance(key, slice):
            idxs = range(*key.indices(self.shape[0]))
            return np.stack([np.load(self.paths[i]) for i in idxs])
        if np.isscalar(key) or isinstance(key, (int, np.integer)):
            return np.load(self.paths[int(key)])
        return np.stack([np.load(self.paths[int(i)]) for i in np.asarray(key)])


def _ped_frame_labels(root: str, index: VideoIndex) -> np.ndarray:
    """UCSD ped: per-frame .bmp pixel masks in sibling `<video>_gt` dirs
    (vad_datasets.py:262-272). Frame label = any anomalous pixel."""
    import cv2

    gt_dirs = sorted(
        d
        for d in glob.glob(os.path.join(root, "Test", "*"))
        if os.path.isdir(d) and d.endswith("_gt")
    )
    addrs: List[str] = []
    for d in gt_dirs:
        addrs += sorted(glob.glob(os.path.join(d, "*.bmp")))
    labels = np.zeros(len(addrs), dtype=np.int64)
    for i, a in enumerate(addrs):
        mask = cv2.imread(a, cv2.IMREAD_GRAYSCALE)
        labels[i] = int(mask.max() > 0)
    return labels


def _avenue_frame_labels(root: str, index: VideoIndex) -> np.ndarray:
    """Avenue: per-video volLabel cell arrays in
    ground_truth_demo/testing_label_mask/<i>_label.mat
    (vad_datasets.py:480-483)."""
    import scipy.io as sio

    gt_dir = os.path.join(root, "ground_truth_demo", "testing_label_mask")
    vols = [
        sio.loadmat(os.path.join(gt_dir, f"{x + 1}_label.mat"))["volLabel"]
        for x in range(index.num_videos)
    ]
    all_gt = np.concatenate(vols, axis=1)  # (1, N) object array of masks
    labels = np.array(
        [int(np.asarray(all_gt[0, i]).max() > 0) for i in range(all_gt.shape[1])],
        dtype=np.int64,
    )
    return labels


def _shanghaitech_frame_labels(root: str, index: VideoIndex) -> np.ndarray:
    """ShanghaiTech: per-video frame-level .npy masks in
    Testing/test_frame_mask (vad_datasets.py:699-706)."""
    gt_files = sorted(glob.glob(os.path.join(root, "Testing", "test_frame_mask", "*")))
    parts = [np.load(g) for g in gt_files]
    return (np.concatenate(parts, axis=0) > 0).astype(np.int64)


def dataset_mean_std(frames) -> "tuple[np.ndarray, np.ndarray]":
    """Per-channel mean/std of a frame source in [0, 1] scale (capability
    parity with get_mean_and_std, helper/misc.py:23-37); streams in chunks
    so lazy sources work."""
    n = frames.shape[0]
    s = np.zeros(frames.shape[-1])
    s2 = np.zeros(frames.shape[-1])
    cnt = 0
    for lo in range(0, n, 64):
        x = np.asarray(frames[lo : lo + 64]).astype(np.float64) / 255.0
        s += x.sum(axis=(0, 1, 2))
        s2 += (x ** 2).sum(axis=(0, 1, 2))
        cnt += x.shape[0] * x.shape[1] * x.shape[2]
    mean = s / cnt
    return mean, np.sqrt(np.maximum(s2 / cnt - mean ** 2, 0.0))


def load_pixel_masks(
    dataset_name: str, root: str, index: VideoIndex
) -> np.ndarray:
    """Per-frame binary GT PIXEL masks (N, H, W) for the test split, for
    the pixel-level criterion (eval.metrics.pixel_level_roc).

    Available where the dataset ships pixel GT: the ped layout's `*_gt`
    .bmp mask dirs (vad_datasets.py:262-272; synthetic datasets use the
    same layout) and avenue's volLabel per-frame masks
    (vad_datasets.py:480-483). ShanghaiTech ships frame-level GT only.
    """
    if dataset_name == "ShanghaiTech":
        raise ValueError("ShanghaiTech ships frame-level GT only")
    if dataset_name == "avenue":
        import scipy.io as sio

        gt_dir = os.path.join(root, "ground_truth_demo", "testing_label_mask")
        masks: List[np.ndarray] = []
        for x in range(index.num_videos):
            vol = sio.loadmat(os.path.join(gt_dir, f"{x + 1}_label.mat"))[
                "volLabel"
            ]
            masks += [np.asarray(vol[0, i]) > 0 for i in range(vol.shape[1])]
    else:
        import cv2

        gt_dirs = sorted(
            d
            for d in glob.glob(os.path.join(root, "Test", "*"))
            if os.path.isdir(d) and d.endswith("_gt")
        )
        addrs: List[str] = []
        for d in gt_dirs:
            addrs += sorted(glob.glob(os.path.join(d, "*.bmp")))
        masks = [
            cv2.imread(a, cv2.IMREAD_GRAYSCALE) > 0 for a in addrs
        ]
    if len(masks) != index.total_frames:
        raise ValueError(
            f"GT masks ({len(masks)}) != dataset frames ({index.total_frames})"
        )
    return np.stack(masks)


def load_frame_labels(dataset_name: str, root: str, index: VideoIndex) -> np.ndarray:
    """Per-frame binary anomaly labels for the test split.

    Synthetic/unknown datasets use the ped layout (bmp masks in `*_gt` dirs).
    """
    if dataset_name == "avenue":
        labels = _avenue_frame_labels(root, index)
    elif dataset_name == "ShanghaiTech":
        labels = _shanghaitech_frame_labels(root, index)
    else:
        labels = _ped_frame_labels(root, index)
    if labels.size != index.total_frames:
        raise ValueError(
            f"GT frames ({labels.size}) != dataset frames ({index.total_frames})"
        )
    return labels
