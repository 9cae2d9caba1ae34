"""Disk-based pipeline orchestration (vec_vad_tpu/runner.py): the library
equivalents of the reference's `python train.py` / `python test.py` /
`python calc_optical_flow.py` entry points (train_and_test.sh), with the
boolean stage flags replaced by the content-hash artifact cache.

Layout conventions match the reference:
  <base>/raw_datasets/<name>/...                 frames + GT
  <base>/raw_datasets/<name>/bboxes_{split}_{mode}.npy   bbox fixtures
  <base>/optical_flow/<name>/...                 mirrored flow .npy tree
  <base>/data/...                                cached artifacts
  <base>/results/<name>/...                      scores + curves

Every entry point runs on `device` (the card unless the caller passes
device="cpu"), its f32 convolutions with TF32 off (device.full_f32).
With a flow tree under optical_flow/ and a two-stream config
(useFlow = True), `run_train` trains both streams and `run_test` scores
and fuses them: calc-flow -> train -> test is the paper's pipeline.
`resident=True` extracts a split on the device
(pipeline.extract_cube_set_resident) and skips the cube cache; a config
with compute_dtype = "bfloat16" trains in bf16 (train.trainer) and is
scored in f32, as in the JAX package; `run_test(pixel_criterion=True)`
adds the pixel-level AUROC (eval.metrics.pixel_level_roc) from the
dataset's pixel GT (data.readers.load_pixel_masks: avenue's .mat files
through scipy, the ped layout's .bmp masks through cv2).
Where a split has no bbox fixture, `load_split` computes its boxes
(fore.detector.compute_foreground_bboxes: motion maps on `device`,
contours on the host, and with a configured `mmdet_checkpoint` the
converted Cascade R-CNN on `device`, fore.mmdet_detector) and
`run_precompute_boxes` writes the fixtures. `load_split`,
`run_calc_flow` and `run_precompute_boxes` read frames through
runtime.native_loader.make_frame_stack: the native decoder for
.jpg/.png/.tif trees (JAX's calc-flow keeps cv2 there; the frames are the
same), LazyFrameStack for .npy. `run_calc_flow(use_mesh=True)` runs
the flow nets over every visible card when there is more than one, as
vec_vad_tpu does.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from vec_vad_torch.config import PipelineConfig
from vec_vad_torch.data.readers import (
    LazyFlowStack,
    LazyFrameStack,
    load_frame_labels,
    load_pixel_masks,
)
from vec_vad_torch.data.video_index import VideoIndex
from vec_vad_torch.device import full_f32, resolve_device, resolve_dtype
from vec_vad_torch.eval.metrics import pixel_level_roc, save_roc_pr_curve_data
from vec_vad_torch.fore.detector import PrecomputedDetector, compute_foreground_bboxes
from vec_vad_torch.models.flownet import load_flownet_checkpoint, make_flownet2
from vec_vad_torch.parallel.mesh import get_mesh
from vec_vad_torch.pipeline import (
    CubeSet,
    VadModel,
    extract_cube_set,
    extract_cube_set_resident,
    frame_level_scores,
    make_trainer,
    pixel_score_masks,
    score_cubes,
    train_model,
)
from vec_vad_torch.runtime.artifacts import (
    ArtifactCache,
    fingerprint,
    load_vad_model,
    save_vad_model,
)
from vec_vad_torch.runtime.native_loader import NativeFrameStack, make_frame_stack


@dataclass
class SplitData:
    index: VideoIndex
    frames: LazyFrameStack | NativeFrameStack
    flow: Optional[LazyFlowStack]
    boxes: List[np.ndarray]


def _dataset_root(cfg: PipelineConfig, base: str) -> str:
    return os.path.join(base, cfg.raw_dataset_dir, cfg.dataset_name)


@functools.lru_cache(maxsize=2)
def _mmdet_detector(checkpoint_path: str, device: str):
    """The converted-checkpoint appearance detector on `device`, memoized
    on (path, device) so the train and test splits share one loaded
    model."""
    from vec_vad_torch.fore.mmdet_detector import MMDetCascadeDetector

    return MMDetCascadeDetector.from_checkpoint(checkpoint_path, device=device)


def _resolve_detector(cfg: PipelineConfig, device="cuda"):
    """Appearance detector for on-the-fly localization: a configured mmdet
    checkpoint powers the appearance stage (the reference's
    fore_det/inference.py path), on `device`; without one, obj_det modes
    degrade to motion-only (empty appearance detections), as in the JAX
    package."""
    if not cfg.fore.extraction_mode.startswith("obj_det"):
        return None
    if cfg.fore.mmdet_checkpoint:
        return _mmdet_detector(cfg.fore.mmdet_checkpoint, str(resolve_device(device)))
    return lambda img: (np.zeros((0, 4)), np.zeros(0))


def load_split(cfg: PipelineConfig, base: str, split: str,
               device="cuda") -> SplitData:
    """Assemble one split's inputs: index, lazy frames, optional flow tree,
    and foreground boxes (the bbox fixture file if present, else computed
    from the frames with the motion maps on `device`)."""
    root = _dataset_root(cfg, base)
    spec = cfg.dataset
    index = VideoIndex.from_layout(cfg.dataset_name, root, split, spec.file_ext)
    if index.total_frames == 0:
        raise FileNotFoundError(f"no frames under {root} for split {split!r}")
    frames = make_frame_stack(index)

    of_root = os.path.join(base, cfg.optical_flow_dir, cfg.dataset_name)
    flow = None
    if os.path.isdir(of_root) and cfg.modality in ("raw2flow", "optical_flow"):
        try:
            flow = LazyFlowStack(index, of_root, root)
        except FileNotFoundError:
            flow = None

    fixture = os.path.join(
        root, f"bboxes_{split}_{cfg.fore.extraction_mode}.npy"
    )
    if os.path.exists(fixture):
        det = PrecomputedDetector(fixture)
        boxes = [det.boxes_for_frame(i) for i in range(index.total_frames)]
    else:
        boxes = compute_foreground_bboxes(
            cfg, spec, index, frames=frames,
            detector=_resolve_detector(cfg, device), device=device,
        )
    return SplitData(index=index, frames=frames, flow=flow, boxes=boxes)


def _extract_cached(
    cfg: PipelineConfig, base: str, split: str, data: SplitData,
    block_mode: int, device,
) -> CubeSet:
    cache = ArtifactCache(os.path.join(base, cfg.data_root_dir, cfg.modality))
    # Box CONTENT must be part of the key: re-detected boxes with the same
    # per-frame counts would otherwise serve a stale cube cache.
    boxes_blob = (
        np.concatenate([np.asarray(b, np.float64).reshape(-1) for b in data.boxes])
        if data.boxes else np.zeros(0)
    )
    # Frame PROVENANCE too: regenerated frames with unchanged boxes would
    # otherwise serve cubes extracted from the old pixels. A stat()-level
    # signature (path, size, mtime) of the on-disk tree.
    frames_sig = [
        (p, os.path.getsize(p), os.path.getmtime(p))
        for p in data.index.frame_paths
    ]
    # and the flow tree's: a rerun of calc-flow (another checkpoint) would
    # otherwise serve flow cubes cut from the old maps (mtimes in ns: a
    # rewrite right after the first write still differs).
    flow_sig = [
        (p, st.st_size, st.st_mtime_ns)
        for p, st in ((p, os.stat(p)) for p in data.flow.paths)
    ] if data.flow is not None else None
    fp = fingerprint(
        cfg.fore, cfg.model.context_frame_num, cfg.model.context_of_num,
        cfg.model.border_mode, split, block_mode, data.index.total_frames,
        boxes_blob, data.flow is not None, frames_sig, flow_sig,
    )

    def compute():
        return extract_cube_set(
            cfg, cfg.dataset, data.index, data.frames, data.boxes,
            flow_frames=data.flow, block_mode=block_mode, device=device,
        )

    def save(path, cubes: CubeSet):
        np.savez_compressed(
            path,
            raw=cubes.raw,
            flow=(cubes.flow if cubes.flow is not None else np.zeros(0)),
            has_flow=np.array(cubes.flow is not None),
            frame_ids=cubes.frame_ids,
            boxes=cubes.boxes,
            cells=cubes.cells,
            scenes=cubes.scenes,
        )

    def load(path):
        with np.load(path) as z:
            return CubeSet(
                raw=z["raw"],
                flow=z["flow"] if bool(z["has_flow"]) else None,
                frame_ids=z["frame_ids"],
                boxes=z["boxes"],
                cells=z["cells"],
                scenes=z["scenes"],
            )

    return cache.get_or_compute(f"foreground_{split}", fp, compute, save, load)


def _extract(
    cfg: PipelineConfig, base: str, split: str, data: SplitData,
    block_mode: int, resident: bool, device,
) -> CubeSet:
    """A split's CubeSet: device-resident (no cube cache; the cubes stay
    on the device) or through the cube cache."""
    if resident:
        return extract_cube_set_resident(
            cfg, cfg.dataset, data.index, data.frames, data.boxes,
            flow_frames=data.flow, block_mode=block_mode, device=device,
        )
    return _extract_cached(cfg, base, split, data, block_mode, device)


def model_path(cfg: PipelineConfig, base: str) -> str:
    return os.path.join(
        base, cfg.data_root_dir, cfg.modality,
        f"{cfg.dataset_name}_model_{cfg.fore.extraction_mode}_{cfg.method}.npz",
    )


def run_train(
    cfg: PipelineConfig,
    base: str,
    seed: int = 0,
    log_every: int = 0,
    resident: bool = False,
    device="cuda",
) -> Tuple[VadModel, str]:
    """Full training pipeline on `device`; returns the model and its
    artifact path (the JAX package's .npz layout; the same path for
    either compute dtype). resident=True extracts the cubes on the device
    (they never leave it on the way to the trainer) and skips the cube
    cache, re-extracting on every run."""
    dev = resolve_device(device)
    with full_f32():
        data = load_split(cfg, base, "train", device=dev)
        cubes = _extract(cfg, base, "train", data, cfg.fore.train_block_mode,
                         resident, dev)
        trainer = make_trainer(cfg, device=device)
        model = train_model(cfg, cubes, trainer=trainer, seed=seed,
                            log_every=log_every)
    path = model_path(cfg, base)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    save_vad_model(path, model)
    return model, path


def run_test(
    cfg: PipelineConfig,
    base: str,
    model: Optional[VadModel] = None,
    save_masks: bool = False,
    per_video_norm: bool = False,
    pixel_criterion: bool = False,
    resident: bool = False,
    device="cuda",
) -> dict:
    """Scoring + evaluation on `device`; returns a result dict with AUROC
    etc. per_video_norm: min-max normalize frame scores within each video
    before AUROC (optional evaluation variant; the reference normalizes
    only by training statistics). pixel_criterion: also evaluate the
    pixel-level coverage criterion (needs the dataset's pixel GT masks;
    adds 'pixel_auroc'). resident: extract the test split on the device
    (the cubes stay there for scoring; no cube cache), as run_train's
    flag. A bf16-trained model is scored in f32."""
    dev = resolve_device(device)
    if model is None:
        model = load_vad_model(model_path(cfg, base))
    with full_f32():
        data = load_split(cfg, base, "test", device=dev)
        cubes = _extract(cfg, base, "test", data, cfg.fore.test_block_mode,
                         resident, dev)
        trainer = make_trainer(cfg, device=device)
        cube_scores = score_cubes(model, cubes, trainer=trainer)
    n = data.index.total_frames
    frame_scores = frame_level_scores(cube_scores, cubes, n)

    results_dir = os.path.join(base, cfg.results_dir, cfg.dataset_name)
    os.makedirs(results_dir, exist_ok=True)
    masks = None
    if save_masks or pixel_criterion:
        # actual stream geometry, not the config table's (synthetic
        # workspaces run reduced frame sizes under a real dataset name)
        frame_hw = tuple(data.frames.shape[1:3])
        masks = pixel_score_masks(cube_scores, cubes, n, frame_hw)
        if save_masks:
            np.save(os.path.join(results_dir, "score_masks.npy"), masks)

    if per_video_norm:
        from vec_vad_torch.score.scoring import normalize_scores_per_video

        frame_scores = normalize_scores_per_video(
            frame_scores, data.index.frame_video_idx
        )

    root = _dataset_root(cfg, base)
    labels = load_frame_labels(cfg.dataset_name, root, data.index)
    out = evaluate_frame_scores(
        cfg, results_dir, frame_scores, labels, data.index.scene_idx
    )
    out["frame_scores"] = frame_scores
    out["labels"] = labels
    if pixel_criterion:
        gt_masks = load_pixel_masks(cfg.dataset_name, root, data.index)
        out["pixel_auroc"] = pixel_level_roc(
            masks, gt_masks,
            file_path=os.path.join(
                results_dir,
                f"{cfg.modality}_{cfg.fore.extraction_mode}_{cfg.method}"
                "_pixel_results.npz",
            ),
        )
    return out


def evaluate_frame_scores(
    cfg: PipelineConfig,
    results_dir: str,
    frame_scores: np.ndarray,
    labels: np.ndarray,
    scene_idx: Optional[np.ndarray] = None,
) -> dict:
    """Frame-criterion evaluation with the reference's scene semantics
    (test.py:370-399): single-scene datasets get one ROC/PR artifact;
    a multi-scene partition gets one artifact per scene plus the
    unweighted mean AUROC over scenes as the headline number."""
    stem = f"{cfg.modality}_{cfg.fore.extraction_mode}_{cfg.method}_frame_results"
    scene_ids = (
        sorted(set(int(s) for s in scene_idx)) if scene_idx is not None else [1]
    )
    if len(scene_ids) > 1:
        per_scene = {}
        for si in scene_ids:
            mask = scene_idx == si
            path_si = os.path.join(results_dir, f"{stem}_scene_{si}.npz")
            per_scene[si] = save_roc_pr_curve_data(
                frame_scores[mask], labels[mask], path_si
            )
        return {
            "auroc": float(np.mean(list(per_scene.values()))),
            "auroc_per_scene": per_scene,
            "results_path": results_dir,
        }
    results_path = os.path.join(results_dir, f"{stem}.npz")
    auroc = save_roc_pr_curve_data(frame_scores, labels, results_path)
    return {"auroc": auroc, "results_path": results_path}


def run_calc_flow(
    cfg: PipelineConfig,
    base: str,
    checkpoint: Optional[str] = None,
    splits: Tuple[str, ...] = ("train", "test"),
    chunk: Optional[int] = None,
    resident: bool = False,
    segment_frames: Optional[int] = None,
    memory_budget_bytes: float = 4e9,
    max_whole_split_frames: int = 512,
    flow_dtype: str = "float32",
    device="cuda",
    use_mesh: bool = True,
) -> None:
    """Precompute the optical-flow tree with FlowNet2
    (calc_optical_flow.py equivalent) on `device`: the card unless the
    caller passes device="cpu". resident=True keeps each split's flow on
    the device until one download (flow.driver.compute_optical_flow).

    Splits whose frames + flow exceed `memory_budget_bytes` (avenue ~19 GB,
    ShanghaiTech ~1.2 TB), or that are longer than
    `max_whole_split_frames`, stream through the segmented path: lazy
    per-segment decode, one upload and one download per segment, each
    frame's .npy written immediately — bounded host and device memory at
    any scale, like the reference's one-frame-at-a-time loop
    (calc_optical_flow.py:25-85). `segment_frames` forces the segmented
    path with that segment size.

    flow_dtype='bfloat16' runs the FlowNet forward in bf16 (.npy output
    stays f32) with the batch default bumped to 8 (chunk=None picks 4 for
    f32, 8 for bf16, as vec_vad_tpu does). Flow values shift by bf16
    rounding; keep float32 where reference parity matters.

    use_mesh=True (default) runs the FlowNet forwards data-parallel over
    get_mesh(device=device) when that mesh has more than one entry: every
    visible card for a bare "cuda", while "cuda:k" and "cpu" name one
    device (flow.driver's mesh route, one replica a card, the maps equal
    the one-device run's). As in vec_vad_tpu the mesh rides the segmented
    route and the resident whole-split route; a non-resident whole-split
    run stays on the first card. use_mesh=False (`calc-flow --no-mesh`)
    runs on `device` alone."""
    from vec_vad_torch.flow.driver import (
        compute_optical_flow,
        compute_optical_flow_segmented,
        flow_tree_writer,
        save_flow_tree,
    )

    dev = resolve_device(device)
    dtype = resolve_dtype(flow_dtype)
    mesh = get_mesh(device=device) if use_mesh else None
    if mesh is not None and mesh.size > 1:
        dev = mesh.devices[0]
        print(f"calc-flow: data-parallel over {mesh.size} devices")
    else:
        mesh = None
    chunk = chunk if chunk is not None else (
        8 if flow_dtype == "bfloat16" else 4
    )
    net = make_flownet2(0, dev)
    if checkpoint:
        report = load_flownet_checkpoint(net, checkpoint)
        print(f"loaded checkpoint: {len(report['matched'])} tensors")
    else:
        print("WARNING: no checkpoint — random-init FlowNet2")

    root = _dataset_root(cfg, base)
    of_root = os.path.join(base, cfg.optical_flow_dir, cfg.dataset_name)
    with full_f32(dtype):  # f32: no TF32 in cuDNN's convolutions
        for split in splits:
            index = VideoIndex.from_layout(
                cfg.dataset_name, root, split, cfg.dataset.file_ext
            )
            lazy = make_frame_stack(index)
            n = index.total_frames
            # frames (uint8) + flow (2 x f32) for the whole split
            footprint = float(np.prod(lazy.shape)) * (1.0 + 8.0 / lazy.shape[-1])
            if (segment_frames or footprint > memory_budget_bytes
                    or n > max_whole_split_frames):
                seg = segment_frames or min(
                    max_whole_split_frames,
                    max(chunk, int(memory_budget_bytes // (footprint / n)) // 2),
                )
                write = flow_tree_writer(index, of_root, root)
                compute_optical_flow_segmented(
                    net, index, lazy, write, segment_frames=seg, chunk=chunk,
                    compute_dtype=dtype, device=dev, mesh=mesh,
                )
                print(
                    f"{split}: wrote {n} flow maps to {of_root} "
                    f"(segmented, {seg} frames/segment)"
                )
            else:
                frames = np.asarray(lazy)
                flow = compute_optical_flow(
                    net, index, frames, chunk=chunk, resident=resident,
                    compute_dtype=dtype, device=dev, mesh=mesh,
                )
                save_flow_tree(flow, index, of_root, root)
                print(f"{split}: wrote {flow.shape[0]} flow maps to {of_root}")


def run_precompute_boxes(
    cfg: PipelineConfig,
    base: str,
    splits: Tuple[str, ...] = ("train", "test"),
    overwrite: bool = False,
    device="cuda",
) -> List[str]:
    """Generate the per-split bbox fixture files the pipeline auto-detects
    (`bboxes_{split}_{mode}.npy`, object array of (N_i, 4) float32), the
    reference's fore_det precomputation products (README.md:51,
    train.py:52-100 `*_bbox_saved` flags), with the motion maps on
    `device`. obj_det modes run the converted Cascade R-CNN of a configured
    mmdet_checkpoint on `device`, or motion-only without one, like
    load_split's on-the-fly path."""
    dev = resolve_device(device)
    root = _dataset_root(cfg, base)
    spec = cfg.dataset
    written = []
    for split in splits:
        out = os.path.join(
            root, f"bboxes_{split}_{cfg.fore.extraction_mode}.npy"
        )
        if os.path.exists(out) and not overwrite:
            print(f"{out} exists; skipping (--overwrite to regenerate)")
            continue
        index = VideoIndex.from_layout(
            cfg.dataset_name, root, split, spec.file_ext
        )
        if index.total_frames == 0:
            raise FileNotFoundError(f"no frames under {root} for {split!r}")
        boxes = compute_foreground_bboxes(
            cfg, spec, index, frames=make_frame_stack(index),
            detector=_resolve_detector(cfg, dev), device=dev,
        )
        arr = np.empty(len(boxes), dtype=object)
        for i, b in enumerate(boxes):
            arr[i] = np.asarray(b, dtype=np.float32).reshape(-1, 4)
        np.save(out, arr, allow_pickle=True)
        written.append(out)
        print(f"wrote {out} ({len(boxes)} frames)")
    return written
