"""Optical-flow training datasets, copied from vec_vad_tpu/flow/datasets.py
(numpy and cv2 only; the port keeps its own copy). FlyingChairs' binary
.ppm frames are read with numpy, as cv2.imread gives them (BGR), so that
tree needs no cv2; other image formats go through cv2.

Capability parity with FlowNet2_src/datasets.py (MpiSintel, FlyingChairs,
ChairsSDHom loaders for the flow fine-tuning harness): each dataset yields
(image-pair (2, H, W, 3) uint8, flow (H, W, 2) float32) samples and a
`batches()` iterator feeding flow.trainer.FlowTrainer.

Crop / render-size protocol (FlowNet2_src/datasets.py:10-32,78-107): the
FlowNet encoder-decoders downsample 6x by 2 and concat skip tensors, so
inputs must be divisible by 64. The reference handles arbitrary frame
geometries (MPI-Sintel is 436x1024) with two croppers sharing ONE offset
per sample across img1/img2/flow:
  * StaticRandomCrop to `crop_size` when training with augmentation,
  * StaticCenterCrop to `render_size` otherwise, where render_size
    defaults to the frame size floored to the nearest /64.
`PairFlowDataset(crop_size=...)` replicates the random-crop training path
and `render_size=None` the floor-to-64 center-crop default.

Layouts (the public dataset conventions the reference consumes):
  MPI-Sintel:     <root>/<dstype>/<scene>/frame_%04d.png
                  <root>/flow/<scene>/frame_%04d.flo
  FlyingChairs:   <root>/*-img_0.ppm, *-img_1.ppm, *-flow.flo
                  (also the 05d_img1/img2/flow naming variant)
  ChairsSDHom:    <root>/<train|test>/t0/*.png, t1/*.png, flow/*.flo
  FlyingThings:   <root>/<frames_cleanpass|frames_finalpass>/TRAIN/
                      <letter>/<seq>/<left|right>/*.png
                  <root>/optical_flow_flo_format/TRAIN/<letter>/<seq>/
                      into_future/<left|right>/*.flo
                  (FlowNet2_src/datasets.py:208-284: consecutive frames
                  i, i+1 of each camera paired with into_future flow i)
  ImagesFromFolder: <root>/*.<iext> — every consecutive frame pair of a
                  plain image folder, ZERO ground-truth flow (the
                  reference's --inference run-on-my-frames mode,
                  FlowNet2_src/datasets.py:398-455)

Loaders validate at construction (flow-header shape vs first image) and
per sample (pair/flow agreement), raising informative errors instead of
the mid-epoch np.stack crashes a corrupted tree would otherwise cause.
"""

from __future__ import annotations

import glob
import os
import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

from vec_vad_torch.utils.flowviz import read_flo


def _read_ppm(path: str) -> Optional[np.ndarray]:
    """A binary 8-bit PPM (P6, maxval 255) as cv2.imread returns it:
    (H, W, 3) uint8 in BGR order; None for any other PPM flavour."""
    with open(path, "rb") as f:
        data = f.read()
    fields, pos = [], 0
    while len(fields) < 4:  # magic, width, height, maxval
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":  # a comment runs to the end of its line
            pos = data.find(b"\n", pos) + 1 or len(data)
            continue
        end = pos
        while end < len(data) and not data[end:end + 1].isspace():
            end += 1
        fields.append(data[pos:end])
        pos = end
    if fields[0] != b"P6" or fields[3] != b"255":
        return None
    w, h = int(fields[1]), int(fields[2])
    pixels = np.frombuffer(data, np.uint8, h * w * 3, pos + 1)
    return np.ascontiguousarray(pixels.reshape(h, w, 3)[..., ::-1])


def _imread(path: str) -> np.ndarray:
    if path.endswith(".ppm") and os.path.exists(path):
        img = _read_ppm(path)
        if img is not None:
            return img
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return img


def _flo_shape(path: str) -> Tuple[int, int]:
    """(h, w) from a .flo header — 12 bytes, no full decode."""
    with open(path, "rb") as f:
        head = f.read(12)
    if len(head) < 12 or head[:4] != b"PIEH":
        raise ValueError(f"not a .flo file: {path}")
    w, h = struct.unpack("<ii", head[4:12])
    return h, w


class PairFlowDataset:
    """Base: parallel lists of (img0, img1, flow) file triples.

    crop_size: (h, w) StaticRandomCrop training augmentation — ONE random
    offset per sample applied to both images and the flow (the reference's
    is_cropped=True path). render_size: (h, w) StaticCenterCrop target when
    crop_size is None; None floors the probed frame size to /64 (no-op for
    already-divisible geometries like FlyingChairs' 384x512).

    A triple's flow path may be None: the sample then carries ZERO flow of
    the image geometry (the reference's ImagesFromFolder inference dataset
    returns torch.zeros, FlowNet2_src/datasets.py:447-449) — useful only
    for inference/EPE-less runs.
    """

    def __init__(
        self,
        triples: List[Tuple[str, str, str]],
        crop_size: Optional[Tuple[int, int]] = None,
        render_size: Optional[Tuple[int, int]] = None,
        aug_seed: int = 0,
    ):
        if not triples:
            raise FileNotFoundError("no samples found")
        self.triples = triples
        probe = _imread(triples[0][0])
        self.frame_size = probe.shape[:2]
        if triples[0][2] is not None:
            fh, fw = _flo_shape(triples[0][2])
            if (fh, fw) != self.frame_size:
                raise ValueError(
                    f"flow shape {(fh, fw)} != image shape "
                    f"{self.frame_size}: {triples[0][2]} vs {triples[0][0]}"
                )
        if crop_size is not None:
            th, tw = crop_size
            if th > self.frame_size[0] or tw > self.frame_size[1]:
                raise ValueError(
                    f"crop_size {crop_size} exceeds frame size "
                    f"{self.frame_size}"
                )
        self.crop_size = tuple(crop_size) if crop_size else None
        if render_size is None:
            # datasets.py:78-83: floor to /64 when not given or not
            # aligned; frames under 64px keep their size (the reference
            # would emit empty crops there — only reachable on toy data)
            render_size = (
                self.frame_size[0] // 64 * 64 or self.frame_size[0],
                self.frame_size[1] // 64 * 64 or self.frame_size[1],
            )
        if (
            render_size[0] > self.frame_size[0]
            or render_size[1] > self.frame_size[1]
        ):
            # an oversized center crop would slice with a negative start
            # and silently emit short arrays, crashing mid-epoch
            raise ValueError(
                f"render_size {tuple(render_size)} exceeds frame size "
                f"{self.frame_size}"
            )
        self.render_size = tuple(render_size)
        self._rng = np.random.default_rng(aug_seed)

    def __len__(self) -> int:
        return len(self.triples)

    @property
    def sample_size(self) -> Tuple[int, int]:
        """The (h, w) every emitted sample actually has after cropping."""
        return self.crop_size if self.crop_size else self.render_size

    def validate(self) -> None:
        """Construction-grade check of EVERY triple: files exist and the
        flow header's shape matches the dataset's frame size. Cheap (12
        bytes per flow, no image decode) — call before a long run instead
        of discovering a corrupt tree mid-epoch."""
        bad = []
        for p0, p1, pf in self.triples:
            for p in (p0, p1):
                if not os.path.exists(p):
                    bad.append(f"missing image: {p}")
            if pf is None:
                continue
            try:
                if _flo_shape(pf) != self.frame_size:
                    bad.append(
                        f"flow shape {_flo_shape(pf)} != {self.frame_size}: {pf}"
                    )
            except (OSError, ValueError) as e:
                bad.append(str(e))
        if bad:
            raise ValueError(
                f"{len(bad)} broken sample(s), first 5:\n  "
                + "\n  ".join(bad[:5])
            )

    def _crop(self, pair: np.ndarray, flow: np.ndarray):
        h, w = pair.shape[1:3]
        if self.crop_size:
            th, tw = self.crop_size
            # StaticRandomCrop: one offset per sample, shared by both
            # frames and the flow (datasets.py:10-19)
            y = int(self._rng.integers(0, h - th + 1))
            x = int(self._rng.integers(0, w - tw + 1))
        else:
            th, tw = self.render_size
            # StaticCenterCrop (datasets.py:22-31)
            y, x = (h - th) // 2, (w - tw) // 2
        return (
            pair[:, y : y + th, x : x + tw],
            flow[y : y + th, x : x + tw],
        )

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        p0, p1, pf = self.triples[i]
        im0, im1 = _imread(p0), _imread(p1)
        if im0.shape != im1.shape:
            raise ValueError(
                f"image pair shapes disagree: {im0.shape} vs {im1.shape} "
                f"({p0}, {p1})"
            )
        if pf is None:
            flow = np.zeros(im0.shape[:2] + (2,), np.float32)
        else:
            flow = read_flo(pf)
            if flow.shape[:2] != im0.shape[:2]:
                raise ValueError(
                    f"flow shape {flow.shape[:2]} != image shape "
                    f"{im0.shape[:2]} ({pf})"
                )
        pair, flow = self._crop(np.stack([im0, im1]), flow)
        return pair, flow

    def batches(
        self, batch_size: int, shuffle: bool = True, seed: int = 0,
        replicate_frames_to_channels: bool = True,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """(pairs (B, H, W, 6) float32, flows (B, H, W, 2)) minibatches —
        the channel-concat input format of FlowNetC/S/SD."""
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for lo in range(0, len(self), batch_size):
            sel = order[lo : lo + batch_size]
            pairs, flows = zip(*(self[i] for i in sel))
            pairs = np.stack(pairs).astype(np.float32)  # (B, 2, H, W, 3)
            x = np.concatenate([pairs[:, 0], pairs[:, 1]], axis=-1)
            yield x, np.stack(flows).astype(np.float32)


class MpiSintel(PairFlowDataset):
    def __init__(self, root: str, dstype: str = "clean", **kw):
        triples = []
        flow_root = os.path.join(root, "flow")
        img_root = os.path.join(root, dstype)
        for scene in sorted(os.listdir(img_root)) if os.path.isdir(img_root) else []:
            frames = sorted(
                glob.glob(os.path.join(img_root, scene, "frame_*.png"))
            )
            for a, b in zip(frames[:-1], frames[1:]):
                stem = os.path.splitext(os.path.basename(a))[0]
                fl = os.path.join(flow_root, scene, stem + ".flo")
                if os.path.exists(fl):
                    triples.append((a, b, fl))
        super().__init__(triples, **kw)


class FlyingChairs(PairFlowDataset):
    def __init__(self, root: str, **kw):
        triples = []
        for fl in sorted(glob.glob(os.path.join(root, "*flow.flo"))):
            base = fl[: -len("flow.flo")]
            for fmt in ("img_0.ppm", "img1.ppm"):
                a = base + fmt
                b = base + fmt.replace("0", "1").replace("img1", "img2")
                if os.path.exists(a) and os.path.exists(b):
                    triples.append((a, b, fl))
                    break
        super().__init__(triples, **kw)


class ChairsSDHom(PairFlowDataset):
    def __init__(self, root: str, split: str = "train", **kw):
        base = os.path.join(root, split)
        triples = []
        for t0 in sorted(glob.glob(os.path.join(base, "t0", "*"))):
            name = os.path.basename(t0)
            t1 = os.path.join(base, "t1", name)
            fl = os.path.join(
                base, "flow", os.path.splitext(name)[0] + ".flo"
            )
            if os.path.exists(t1) and os.path.exists(fl):
                triples.append((t0, t1, fl))
        super().__init__(triples, **kw)


class FlyingThings(PairFlowDataset):
    """FlyingThings3D subset trees (FlowNet2_src/datasets.py:208-284).

    Camera dirs <root>/<dstype>/TRAIN/<letter>/<seq>/{left,right} pair
    frame i with i+1; the matching into_future flow lives at
    <root>/optical_flow_flo_format/TRAIN/<letter>/<seq>/into_future/
    {left,right}/<i>.flo. The reference zips image dirs with flow dirs
    by sorted order — on a partially extracted tree with DIFFERENT dirs
    missing on each side (equal counts), that silently pairs a camera
    with another sequence's ground truth. We pair by the
    <letter>/<seq>/<camera> key instead and raise on any camera dir
    whose flow dir is absent (the reference's count assertion, made
    per-camera).
    """

    def __init__(self, root: str, dstype: str = "frames_cleanpass", **kw):
        pairs = []
        for seq in sorted(
            glob.glob(os.path.join(root, dstype, "TRAIN", "*", "*"))
        ):
            letter_seq = os.path.join(
                os.path.basename(os.path.dirname(seq)), os.path.basename(seq)
            )
            for cam in ("left", "right"):
                idir = os.path.join(seq, cam)
                if not os.path.isdir(idir):
                    continue
                fdir = os.path.join(
                    root, "optical_flow_flo_format", "TRAIN",
                    letter_seq, "into_future", cam,
                )
                if not os.path.isdir(fdir):
                    raise ValueError(
                        f"inconsistent FlyingThings tree: camera dir "
                        f"{idir} has no flow dir {fdir}"
                    )
                pairs.append((idir, fdir))
        # the mirror-image inconsistency: flow camera dirs no image dir
        # claims (e.g. the requested pass subtree is absent entirely)
        flow_dirs = {
            d
            for seq in glob.glob(
                os.path.join(root, "optical_flow_flo_format", "TRAIN",
                             "*", "*")
            )
            for d in (
                os.path.join(seq, "into_future", "left"),
                os.path.join(seq, "into_future", "right"),
            )
            if os.path.isdir(d)
        }
        orphans = flow_dirs - {f for _, f in pairs}
        if orphans:
            raise ValueError(
                f"inconsistent FlyingThings tree: {len(orphans)} flow dirs "
                f"have no {dstype} camera dir (e.g. {sorted(orphans)[0]})"
            )
        triples = []
        for idir, fdir in pairs:
            images = sorted(glob.glob(os.path.join(idir, "*.png")))
            flows = sorted(glob.glob(os.path.join(fdir, "*.flo")))
            if flows and len(images) < len(flows) + 1:
                raise ValueError(
                    f"{idir}: {len(images)} frames cannot pair with "
                    f"{len(flows)} into_future flows"
                )
            for i in range(len(flows)):
                triples.append((images[i], images[i + 1], flows[i]))
        super().__init__(triples, **kw)


class FlyingThingsClean(FlyingThings):
    def __init__(self, root: str, **kw):
        super().__init__(root, dstype="frames_cleanpass", **kw)


class FlyingThingsFinal(FlyingThings):
    def __init__(self, root: str, **kw):
        super().__init__(root, dstype="frames_finalpass", **kw)


class ImagesFromFolder(PairFlowDataset):
    """Every consecutive pair of <root>/*.<iext>, zero ground-truth flow —
    the reference's run-a-flow-net-over-my-frames inference mode
    (FlowNet2_src/datasets.py:398-455). EPE against the zero flow is
    meaningless; flow-infer skips its EPE report for this dataset."""

    def __init__(self, root: str, iext: str = "png", **kw):
        images = sorted(glob.glob(os.path.join(root, "*." + iext)))
        triples = [(a, b, None) for a, b in zip(images[:-1], images[1:])]
        super().__init__(triples, **kw)

    @property
    def has_ground_truth(self) -> bool:
        return False
