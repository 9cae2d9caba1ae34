"""The port's command line (vec_vad_tpu/cli.py): `train`, `test`,
`calc-flow`, `precompute-boxes`, `serve`, `flow-train`, `flow-infer`,
`demo`, `export-torch`, `import-torch`, `visualize` and `extract-frames`,
with vec_vad_tpu's flags and messages plus `--device` (the card by
default; `--device cpu` runs the plain PyTorch path).

    python -m vec_vad_torch train --config config.cfg --base .
    python -m vec_vad_torch test --config config.cfg --base .
    python -m vec_vad_torch calc-flow --config config.cfg --base .
    python -m vec_vad_torch precompute-boxes --config config.cfg --base .
    python -m vec_vad_torch serve --config config.cfg --base . [--frames N]
    python -m vec_vad_torch flow-train --data-root TREE --workdir WD \\
        --net FlowNetC --loss multiscale --norm L1
    python -m vec_vad_torch flow-infer --data-root TREE --workdir WD
    python -m vec_vad_torch demo
    python -m vec_vad_torch export-torch --config config.cfg [--out DIR]
    python -m vec_vad_torch import-torch --config config.cfg --model-dir DIR
    python -m vec_vad_torch visualize --masks score_masks.npy \\
        [--config config.cfg | --frames-root DIR] [--flow-dir TREE] --out DIR
    python -m vec_vad_torch extract-frames --video V.avi --out DIR

With `useFlow = True` in the config and the tree calc-flow wrote, train
and test run the two-stream model. `--resident` extracts a split on the
device (no cube cache) and test's `--pixel-criterion` adds the
pixel-level AUROC from the dataset's pixel GT (avenue's .mat files; the
ped layout's .bmp masks need cv2). `precompute-boxes` writes the
`bboxes_{split}_{mode}.npy` fixtures from the frames (motion maps on the
device, contours on the host, and the config's `mmdet_checkpoint`, the
converted Cascade R-CNN, on the device for the obj_det modes; without a
fixture, train and test compute the same boxes). `serve` streams the test split through the online
scorers (`--live-flow`: flow computed in the loop; `--motion`: boxes
computed in the loop, with `--live-flow` both; `--cameras C`: a fleet).
A config with h_block/w_block above 1 trains and scores its blocks folded
together (train.grid_trainer). `demo` runs train and test on a synthetic
tree (vec_vad_torch.demo); `export-torch` writes the trained grid as the
reference's model_set and training-score files, `import-torch` reads them
(e.g. its released checkpoints) into the .npz model `test` loads.
`visualize` writes score masks, overlays and flow wheels as PNGs without
cv2, pairing the masks with the dataset's test split (`--config`) or
with `--frames-root` in natural order; `extract-frames` needs cv2 (its
video decoder), which the card's machine lacks. Frames of .jpg/.png/.tif
trees are read by the native decoder (runtime/native_loader.py).
calc-flow runs its flow nets over every visible card when there is more
than one, unless `--no-mesh` keeps it on `--device`. `bench` is not
ported (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import sys

from vec_vad_torch.config import PipelineConfig, load_ini_config

_FLOW_COMPONENTS = ("FlowNetC", "FlowNetS", "FlowNetSD")
_FLOW_COMPOSITES = ("FlowNet2", "FlowNet2CS", "FlowNet2CSS")
_FLOW_DATASETS = (
    "MpiSintel", "FlyingChairs", "ChairsSDHom",
    "FlyingThingsClean", "FlyingThingsFinal", "ImagesFromFolder",
)


def _load_cfg(args) -> PipelineConfig:
    if args.config:
        # an explicitly passed path must exist — silently running with
        # built-in defaults after a typo'd --config writes artifacts for
        # the wrong dataset. (The no-flag convenience fallback is handled
        # below: args.config defaults to None.)
        if not os.path.exists(args.config):
            raise FileNotFoundError(f"--config {args.config} does not exist")
        cfg = load_ini_config(args.config)
    elif os.path.exists("config.cfg"):
        cfg = load_ini_config("config.cfg")
    else:
        cfg = PipelineConfig()
    if getattr(args, "dataset", None):
        cfg = cfg.replace(dataset_name=args.dataset)
    return cfg


def _add_common(p):
    p.add_argument(
        "--config", default=None,
        help="INI config path (default: ./config.cfg if present)",
    )
    p.add_argument("--base", default=".", help="base dir holding raw_datasets/")
    p.add_argument("--dataset", default=None, help="override dataset_name")


def cmd_train(args) -> int:
    from vec_vad_torch.runner import run_train

    cfg = _load_cfg(args)
    model, path = run_train(
        cfg, args.base, seed=args.seed, log_every=args.log_every,
        resident=args.resident, device=args.device,
    )
    print(f"trained {len(model.blocks)} block model(s) -> {path}")
    return 0


def cmd_test(args) -> int:
    from vec_vad_torch.runner import run_test

    cfg = _load_cfg(args)
    res = run_test(
        cfg, args.base, save_masks=args.save_masks,
        per_video_norm=args.per_video_norm,
        pixel_criterion=args.pixel_criterion,
        resident=args.resident, device=args.device,
    )
    if "pixel_auroc" in res:
        print(f"pixel-level AUROC (coverage 0.4): {res['pixel_auroc']:.4f}")
    if "auroc_per_scene" in res:
        for si, auc in sorted(res["auroc_per_scene"].items()):
            print(f"scene {si} frame-level AUROC: {auc:.4f}")
        print(f"average frame-level AUROC: {res['auroc']:.4f}")
    else:
        print(f"frame-level AUROC: {res['auroc']:.4f}")
    print(f"curves -> {res['results_path']}")
    return 0


def cmd_calc_flow(args) -> int:
    from vec_vad_torch.runner import run_calc_flow

    cfg = _load_cfg(args)
    splits = tuple(args.splits.split(","))
    run_calc_flow(
        cfg, args.base, checkpoint=args.checkpoint, splits=splits,
        resident=args.resident, segment_frames=args.segment_frames or None,
        chunk=args.chunk or None, flow_dtype=args.flow_dtype,
        device=args.device, use_mesh=not args.no_mesh,
    )
    return 0


def cmd_precompute_boxes(args) -> int:
    from vec_vad_torch.runner import run_precompute_boxes

    cfg = _load_cfg(args)
    run_precompute_boxes(
        cfg, args.base, splits=tuple(args.splits.split(",")),
        overwrite=args.overwrite, device=args.device,
    )
    return 0


def _build_live_flow(args, device):
    """FlowNet2 for --live-flow on `device` (a checkpoint's weights, or
    the seed-0 random init run_calc_flow uses, so a random-init live flow
    equals calc-flow's) and the scorer's --flow-dtype keyword."""
    import torch

    from vec_vad_torch.models.flownet import load_flownet_checkpoint, make_flownet2

    net = make_flownet2(0, device)
    if args.flow_checkpoint:
        report = load_flownet_checkpoint(net, args.flow_checkpoint)
        print(f"loaded flow checkpoint: {len(report['matched'])} tensors")
    else:
        print("WARNING: no --flow-checkpoint — random-init FlowNet2")
    fdt = torch.bfloat16 if args.flow_dtype == "bfloat16" else torch.float32
    return net, {"flow_compute_dtype": fdt}


def _serve_fleet(cfg, model, data, args, live: bool, device) -> int:
    """`serve --cameras C`: every camera streams the test split's first
    video in lockstep, a tick at a time. Identical per-camera inputs
    double as a cross-camera consistency check; reports per-tick latency
    and aggregate fleet fps."""
    import time

    import numpy as np

    from vec_vad_torch.serve import MultiCameraFlowScorer, MultiCameraScorer

    C = int(args.cameras)
    ln = int(data.index.video_lengths[0])
    n = ln if args.frames <= 0 else min(args.frames, ln)

    if live:
        fnet, fkw = _build_live_flow(args, device)
        scorer = MultiCameraFlowScorer.from_model(
            model, n_cameras=C, flow_net=fnet, device=device, **fkw)
    else:
        scorer = MultiCameraScorer.from_model(model, n_cameras=C, device=device)

    # scene routing: the first test video's scene row by default;
    # --camera-scenes gives each camera its own (test.py:282
    # model_set[scene_idx-1] semantics, per camera)
    scene_idx = data.index.scene_idx
    default_scene = int(scene_idx[0]) if scene_idx is not None else 1
    if args.camera_scenes:
        scenes = [int(s) for s in str(args.camera_scenes).split(",")]
        if len(scenes) == 1:
            scenes = scenes * C
        if len(scenes) != C:
            raise SystemExit(
                f"--camera-scenes needs {C} values (or one), got {len(scenes)}"
            )
    else:
        scenes = [default_scene] * C
    if live:
        scorer.start_video(scene=scenes)  # fleet-wide video boundaries
    else:
        for c, s in enumerate(scenes):
            scorer.start_video(camera=c, scene=s)
    rows, lat = [], []
    for t in range(n):
        frame = np.asarray(data.frames[t])
        frames = np.broadcast_to(frame, (C,) + frame.shape)
        boxes = [data.boxes[t]] * C
        t0 = time.perf_counter()
        if live:
            out = scorer.push_tick(frames, boxes)
        else:
            flows = None
            if scorer.use_flow and data.flow is not None:
                flow = np.asarray(data.flow[t])
                flows = np.broadcast_to(flow, (C,) + flow.shape)
            out = scorer.push_tick(frames, boxes, flows=flows)
        lat.append(time.perf_counter() - t0)
        if out is not None:
            rows.append(out)
    if live:
        out = scorer.end_video()
        if out is not None:
            rows.append(out)
    rows.extend(scorer.drain())
    lat = np.array(lat[2:]) if len(lat) > 2 else np.array(lat)
    med = float(np.median(lat)) * 1e3
    rows = np.asarray(rows, np.float32)
    spread = float(np.max(np.abs(rows - rows[:, :1]))) if rows.size else 0.0
    peak = float(np.max(np.abs(rows))) if rows.size else 0.0
    print(
        f"fleet of {C} cameras, {len(lat)} timed ticks: median "
        f"{med:.1f} ms/tick = {C * 1000.0 / max(med, 1e-9):.1f} fps "
        f"aggregate; cross-camera score spread {spread:.2e} "
        f"(max |score| {peak:.4e})"
    )
    return 0


def cmd_serve(args) -> int:
    """Online serving: stream the test split frame by frame
    through serve.StreamingScorer (or its live-flow, motion or fleet
    forms) and report steady-state latency (median and p90), plus the
    streamed AUROC when the whole split is scored (equal to offline
    `test`'s up to summation order; with --motion, to `test` on the boxes
    precompute-boxes computes)."""
    import time

    import numpy as np

    from vec_vad_torch.device import resolve_device
    from vec_vad_torch.runner import load_split, model_path
    from vec_vad_torch.runtime.artifacts import load_vad_model
    from vec_vad_torch.serve import (
        FlowStreamingScorer,
        MotionFlowStreamingScorer,
        MotionStreamingScorer,
        StreamingScorer,
    )

    cfg = _load_cfg(args)
    live, motion = bool(args.live_flow), bool(args.motion)
    if live and not cfg.model.use_flow:
        # fail BEFORE the FlowNet2 build or checkpoint load
        raise SystemExit(
            "--live-flow needs a two-stream model (useFlow=True); "
            "this config is raw-only"
        )
    if motion and int(args.cameras) > 1:
        raise SystemExit(
            "--motion composes with single-camera serving only "
            "(not --cameras)"
        )
    device = resolve_device(args.device)
    model = load_vad_model(model_path(cfg, args.base))
    data = load_split(cfg, args.base, "test", device=device)
    if int(args.cameras) > 1:
        return _serve_fleet(cfg, model, data, args, live, device)
    if live and motion:
        # fully self-contained: boxes AND flow computed in the loop
        fnet, fkw = _build_live_flow(args, device)
        scorer = MotionFlowStreamingScorer.from_model(
            model, spec=cfg.dataset, flow_net=fnet, device=device, **fkw)
    elif live:
        fnet, fkw = _build_live_flow(args, device)
        scorer = FlowStreamingScorer.from_model(model, flow_net=fnet,
                                                device=device, **fkw)
    elif motion:
        scorer = MotionStreamingScorer.from_model(model, spec=cfg.dataset,
                                                  device=device)
    else:
        scorer = StreamingScorer.from_model(model, device=device)

    n = data.index.total_frames if args.frames <= 0 else min(
        args.frames, data.index.total_frames
    )
    scores, lat = [], []
    i = 0
    scene_idx = data.index.scene_idx
    for ln in data.index.video_lengths:
        if i >= n:
            break
        # route each video through its own scene's block row, as the
        # offline path routes per frame
        scorer.start_video(
            scene=int(scene_idx[i]) if scene_idx is not None else 1
        )
        for _ in range(int(ln)):
            if i >= n:
                break
            frame = np.asarray(data.frames[i])
            t0 = time.perf_counter()
            if live and motion:
                s = scorer.push(frame)  # boxes AND flow computed in the loop
            elif live:
                s = scorer.push(frame, data.boxes[i])
            else:
                flow = (
                    np.asarray(data.flow[i])
                    if scorer.use_flow and data.flow is not None
                    else None
                )
                if motion:
                    s = scorer.push(frame, flow=flow)
                else:
                    s = scorer.push(frame, data.boxes[i], flow=flow)
            lat.append(time.perf_counter() - t0)
            if s is not None:
                scores.append(s)
            i += 1
        if motion:
            scores.extend(scorer.end_video())
        elif live:
            s = scorer.end_video()
            if s is not None:
                scores.append(s)
    scores.extend(scorer.drain())
    lat = np.array(lat[2:]) if len(lat) > 2 else np.array(lat)  # drop warm-up
    print(
        f"streamed {i} frames: median latency {np.median(lat) * 1e3:.1f} ms "
        f"({1.0 / max(np.median(lat), 1e-9):.1f} fps steady-state), p90 "
        f"{np.percentile(lat, 90) * 1e3:.1f} ms"
    )
    if args.frames <= 0 and len(scores) == data.index.total_frames:
        from vec_vad_torch.data.readers import load_frame_labels
        from vec_vad_torch.eval.metrics import evaluate_scores

        root = os.path.join(args.base, cfg.raw_dataset_dir, cfg.dataset_name)
        labels = load_frame_labels(cfg.dataset_name, root, data.index)
        print(
            "frame-level AUROC (streamed): "
            f"{evaluate_scores(np.array(scores), labels).roc_auc:.4f}"
        )
    return 0


def make_flow_net(name: str, seed: int = 0, device="cuda"):
    """A flow net for the training/inference harness with the reference's
    init from a numpy seed: component nets take the datasets' (B,H,W,6)
    batches directly; the composites get the PairMajorAdapter wrap (they
    take (B,2,H,W,3) and return one fused flow)."""
    import torch

    from vec_vad_torch.flow.trainer import PairMajorAdapter
    from vec_vad_torch.models import flownet

    if name in _FLOW_COMPOSITES:
        net = PairMajorAdapter(getattr(flownet, name)(device=device))
    elif name == "FlowNetS":
        net = flownet.FlowNetS(6, device=device)
    elif name in _FLOW_COMPONENTS:
        net = getattr(flownet, name)(device=device)
    else:
        raise SystemExit(f"unknown --net {name!r}")
    # convolution weights channels_last, like the NHWC activations
    net.to(memory_format=torch.channels_last)
    return flownet.init_flownet_(net, seed)


def _load_flow_torch_checkpoint(net, name: str, path: str):
    """Reference .pth(.tar) -> a make_flow_net net, in place (composites:
    into the wrapped composite, whose keys match the reference's)."""
    from vec_vad_torch.models.flownet import load_flownet_checkpoint

    target = net.inner if name in _FLOW_COMPOSITES else net
    return load_flownet_checkpoint(target, path)


def _flow_dataset_makers(args):
    """dataset-name -> constructor(root, **kw) (FlowNet2_src/main.py:119-134
    resolves its dataset flags against the datasets module's class names)."""
    from vec_vad_torch.flow import datasets as fds

    return {
        "MpiSintel": lambda root, **kw: fds.MpiSintel(root, dstype=args.dstype, **kw),
        "FlyingChairs": fds.FlyingChairs,
        "ChairsSDHom": fds.ChairsSDHom,
        "FlyingThingsClean": fds.FlyingThingsClean,
        "FlyingThingsFinal": fds.FlyingThingsFinal,
        "ImagesFromFolder": lambda root, **kw: fds.ImagesFromFolder(
            root, iext=args.iext, **kw
        ),
    }


def cmd_flow_train(args) -> int:
    """Fine-tune a flow net on Sintel/FlyingChairs/ChairsSDHom/
    FlyingThings trees — the reference's FlowNet2_src/main.py harness as
    a CLI (flow/harness.py, flow/datasets.py, flow/losses.py)."""
    from vec_vad_torch.device import resolve_device
    from vec_vad_torch.flow.harness import FlowHarness
    from vec_vad_torch.flow.trainer import FlowTrainer

    # component nets (FlowNetC/S/SD) return a multi-scale pyramid in train
    # mode and pair with the MultiScale loss; the FlowNet2/CS/CSS
    # composites return ONE fused flow and the reference trains them with
    # single-scale L1Loss/L2Loss on it (main.py:194-197, losses.py:22-45)
    if args.net in _FLOW_COMPONENTS:
        if args.loss != "multiscale":
            raise SystemExit(
                f"--net {args.net} returns a flow pyramid in train mode; "
                "train it with --loss multiscale (--norm picks L1/L2)."
            )
        loss_mode, norm = "multiscale", args.norm
    elif args.net in _FLOW_COMPOSITES:
        if args.loss == "multiscale":
            raise SystemExit(
                f"--net {args.net} returns one fused flow — the pyramid "
                "loss cannot supervise it. Pass --loss L1 or --loss L2 "
                "(the reference's composite recipe, main.py:194-197)."
            )
        loss_mode, norm = "single", args.loss
    else:
        raise SystemExit(f"unknown --net {args.net!r}")
    device = resolve_device(args.device)
    net = make_flow_net(args.net, args.seed, device)

    crop = (
        tuple(int(v) for v in args.crop_size.split(","))
        if args.crop_size else None
    )
    if args.dataset == "ImagesFromFolder":
        # zero ground-truth flow — training against it would teach the
        # net to predict zeros
        raise SystemExit(
            "ImagesFromFolder has no ground-truth flow; it is a "
            "flow-infer dataset only."
        )
    mk = _flow_dataset_makers(args)[args.dataset]
    train_ds = mk(args.data_root, crop_size=crop)
    # validation center-crops to the render size (no augmentation),
    # main.py's is_cropped=False eval path
    val_ds = mk(args.val_root or args.data_root)

    trainer = FlowTrainer(
        net,
        learning_rate=args.lr,
        norm=norm,
        loss=loss_mode,
        schedule_lr_frequency=args.schedule_lr_frequency,
        schedule_lr_fraction=args.schedule_lr_fraction,
        device=device,
    )
    init_params = None
    if args.checkpoint:
        report = _load_flow_torch_checkpoint(net, args.net, args.checkpoint)
        init_params = net.state_dict()
        print(f"loaded checkpoint: {len(report['matched'])} tensors")

    harness = FlowHarness(trainer, args.workdir, norm=norm)
    result = harness.fit(
        train_ds,
        val_ds,
        total_epochs=args.epochs,
        batch_size=args.batch_size,
        seed=args.seed,
        resume=not args.no_resume,
        log=True,
        init_params=init_params,
    )
    print(f"best validation EPE: {result.best_epe:.4f}")
    print(f"checkpoints in {args.workdir}")
    return 0


def cmd_flow_infer(args) -> int:
    """The reference harness's --inference mode (main.py:87-100,344-352,
    524-589): run a trained or converted flow net over a flow-dataset
    tree, optionally write each prediction as %06d.flo, and report mean
    EPE. Weights come from --checkpoint (reference .pth) or from
    --workdir (a flow-train run's model_best/checkpoint); like the
    reference, inference without weights refuses to run."""
    from vec_vad_torch.device import resolve_device
    from vec_vad_torch.flow.harness import FlowHarness
    from vec_vad_torch.flow.trainer import FlowTrainer

    device = resolve_device(args.device)
    net = make_flow_net(args.net, 0, device)
    ds = _flow_dataset_makers(args)[args.dataset](args.data_root)

    trainer = FlowTrainer(net, device=device)
    workdir = args.workdir or os.path.join(args.out or ".", "_flow_infer")
    harness = FlowHarness(trainer, workdir)

    loaded = False
    if args.checkpoint:
        report = _load_flow_torch_checkpoint(net, args.net, args.checkpoint)
        loaded = True
        print(f"loaded torch checkpoint: {len(report['matched'])} tensors")
    elif args.workdir:
        got = harness.load_checkpoint(best=True) or harness.load_checkpoint()
        if got is not None:
            loaded = True
            print(f"loaded {args.workdir} checkpoint (epoch {got[0]})")
    if not loaded:
        # main.py:352-354 quits on inference without a resumable checkpoint
        raise SystemExit(
            "flow-infer needs weights: pass --checkpoint (torch) or "
            "--workdir holding a flow-train checkpoint"
        )

    save_dir = None
    if args.save_flow:
        save_dir = args.out or os.path.join(workdir, "inference")
    res = harness.infer(ds, args.batch_size, save_dir=save_dir,
                        n_batches=args.n_batches)
    if getattr(ds, "has_ground_truth", True):
        print(f"inference EPE over {res['n']} samples: {res['epe']:.4f}")
    else:
        # zero-GT dataset: the 'EPE' is the mean predicted-flow norm,
        # exactly what the reference's inference loop reports there
        print(
            f"mean predicted-flow norm over {res['n']} samples "
            f"(no ground truth): {res['epe']:.4f}"
        )
    if save_dir:
        print(f"flows written to {save_dir}")
    return 0


def cmd_demo(args) -> int:
    from vec_vad_torch.demo import main as demo_main

    demo_main(device=args.device, base=args.base)
    return 0


def cmd_export_torch(args) -> int:
    """Export the trained model grid to the reference's torch artifact
    set (model_set + raw/of training-score grids, train.py:432-436
    naming/format) so the unmodified reference test.py can score with a
    model trained here (models.completion_export)."""
    from vec_vad_torch.models.completion_export import export_model_grid
    from vec_vad_torch.runner import model_path
    from vec_vad_torch.runtime.artifacts import load_vad_model

    cfg = _load_cfg(args)
    path = model_path(cfg, args.base)
    model = load_vad_model(path)
    out = args.out or os.path.dirname(path)
    for p in export_model_grid(model, out, mode=cfg.fore.extraction_mode,
                               method=cfg.method, device=args.device):
        print(p)
    return 0


def cmd_import_torch(args) -> int:
    """Import a released reference checkpoint set (model_set +
    raw/of training-score grids, README.md:63 e.g.
    avenue_model_5raw1of_auc0.902) into the .npz VadModel the `test`
    subcommand loads — the inverse of `export-torch`."""
    from vec_vad_torch.models.completion_convert import import_model_grid
    from vec_vad_torch.runner import model_path
    from vec_vad_torch.runtime.artifacts import save_vad_model

    cfg = _load_cfg(args)
    model = import_model_grid(cfg, args.model_dir, device=args.device)
    out = args.out or model_path(cfg, args.base)
    if os.path.dirname(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
    save_vad_model(out, model)
    print(f"imported {len(model.blocks)} block(s) -> {out}")
    return 0


def _natural_key(path: str):
    """Sort key that orders embedded numbers by value (frame 10 after 9)."""
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", path)]


def _visualize_frames(args):
    """The frames the score masks were computed on, or None: the
    dataset's test split through make_frame_stack when --config is given,
    else the images under --frames-root in natural order."""
    from vec_vad_torch.data.video_index import VideoIndex
    from vec_vad_torch.runtime.native_loader import make_frame_stack

    if args.config:
        if args.frames_root:
            raise SystemExit("pass --config or --frames-root, not both")
        cfg = _load_cfg(args)
        root = os.path.join(args.base, cfg.raw_dataset_dir, cfg.dataset_name)
        index = VideoIndex.from_layout(cfg.dataset_name, root, "test",
                                       cfg.dataset.file_ext)
        if index.total_frames == 0:
            raise FileNotFoundError(f"no test frames under {root}")
        return make_frame_stack(index)
    if not args.frames_root:
        return None
    paths = []
    for pat in ("*.jpg", "*.jpeg", "*.png", "*.bmp", "*.tif", "*.tiff", "*.npy"):
        paths += glob.glob(os.path.join(args.frames_root, "**", pat), recursive=True)
    if not paths:
        raise FileNotFoundError(f"--frames-root {args.frames_root}: no images found")
    paths.sort(key=_natural_key)
    return make_frame_stack(VideoIndex(["frames"], [len(paths)], paths))


def cmd_visualize(args) -> int:
    """Render persisted artifacts to PNGs: per-frame anomaly-score masks
    (grayscale, and a JET overlay on the frame when the frames are given)
    and optical-flow color wheels (vec_vad_tpu/cli.py:385-460).

    The artifacts are `test --save-masks`'s score_masks.npy and
    `calc-flow`'s .npy/.flo trees. Images are written by utils/png.py (no
    cv2). The frames pair with the masks in the order `test` scored them:
    the dataset's test split (--config), or --frames-root in natural
    order; a frame count other than the masks' is refused."""
    import numpy as np

    from vec_vad_torch.utils.flowviz import flow_to_image, read_flo
    from vec_vad_torch.utils.png import write_png
    from vec_vad_torch.utils.visualize import score_mask_overlay, visualize_score

    if not (args.masks or args.flow_dir):
        print("nothing to do: pass --masks and/or --flow-dir", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    wrote = 0
    if args.masks:
        masks = np.load(args.masks)
        if masks.ndim != 3:
            raise ValueError(
                f"--masks expects (N, H, W) score_masks.npy, got {masks.shape}"
            )
        frames = _visualize_frames(args)
        if frames is not None and len(frames) != masks.shape[0]:
            raise ValueError(
                f"{len(frames)} frames for {masks.shape[0]} score masks: the "
                "frames must be the ones `test` scored"
            )
        n = masks.shape[0] if args.limit is None else min(
            masks.shape[0], args.limit
        )
        for i in range(n):
            write_png(os.path.join(args.out, f"score_{i:06d}.png"),
                      visualize_score(masks[i]))
            wrote += 1
            if frames is not None:
                write_png(
                    os.path.join(args.out, f"overlay_{i:06d}.png"),
                    score_mask_overlay(frames[i], masks[i], alpha=args.alpha),
                )
                wrote += 1
    if args.flow_dir:
        paths = sorted(
            glob.glob(os.path.join(args.flow_dir, "**", "*.npy"), recursive=True)
            + glob.glob(os.path.join(args.flow_dir, "**", "*.flo"), recursive=True)
        )
        if args.limit is not None:
            paths = paths[: args.limit]
        if not paths:
            raise FileNotFoundError(f"--flow-dir {args.flow_dir}: no .npy/.flo")
        for p in paths:
            flow = read_flo(p) if p.endswith(".flo") else np.load(p)
            rel = os.path.relpath(p, args.flow_dir)
            out = os.path.join(
                args.out, "flow_" + rel.replace(os.sep, "_") + ".png"
            )
            # flow_to_image returns RGB (flowlib convention); PNGs take BGR
            write_png(out, flow_to_image(flow)[:, :, ::-1])
            wrote += 1
    print(f"wrote {wrote} image(s) -> {args.out}")
    return 0


def cmd_extract_frames(args) -> int:
    """Video file -> %06d.jpg frames (raw_datasets/ShanghaiTech/
    extract_frames.py equivalent), through cv2's video decoder and JPEG
    encoder as in the JAX package."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "extract-frames needs cv2 for its video decoder and JPEG encoder; "
            "this machine has no cv2 (the card's machine has none): extract "
            "the frames where cv2 is installed"
        ) from e

    os.makedirs(args.out, exist_ok=True)
    cap = cv2.VideoCapture(args.video)
    if not cap.isOpened():
        print(f"cannot open {args.video}", file=sys.stderr)
        return 1
    i = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        i += 1
        cv2.imwrite(os.path.join(args.out, f"{i:06d}.jpg"), frame)
    cap.release()
    print(f"extracted {i} frames to {args.out}")
    return 0


def _add_device(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="vec_vad_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    nets = list(_FLOW_COMPONENTS + _FLOW_COMPOSITES)

    p = sub.add_parser("train", help="train the completion-model grid")
    _add_common(p)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=5)
    p.add_argument(
        "--resident", action="store_true",
        help="device-resident extraction (cubes never leave the device; "
        "skips the cube cache)",
    )
    _add_device(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("test", help="score the test split + AUROC")
    _add_common(p)
    p.add_argument("--save-masks", action="store_true")
    p.add_argument("--per-video-norm", action="store_true")
    p.add_argument(
        "--pixel-criterion", action="store_true",
        help="also evaluate the pixel-level coverage criterion "
        "(needs pixel GT masks)",
    )
    p.add_argument(
        "--resident", action="store_true",
        help="device-resident test extraction (cubes stay on the device for "
        "scoring; skips the cube cache)",
    )
    _add_device(p)
    p.set_defaults(fn=cmd_test)

    p = sub.add_parser("calc-flow", help="precompute FlowNet2 optical flow")
    _add_common(p)
    p.add_argument("--checkpoint", default=None, help="FlowNet2 .pth(.tar)")
    p.add_argument("--splits", default="train,test")
    p.add_argument(
        "--resident", action="store_true",
        help="keep each split's flow on the device until one download",
    )
    p.add_argument(
        "--segment-frames", type=int, default=0,
        help="force the memory-bounded segmented path with this segment "
        "size (0 = auto-route by footprint; oversized splits stream)",
    )
    p.add_argument(
        "--flow-dtype", choices=("float32", "bfloat16"), default="float32",
        help="FlowNet forward dtype (.npy output is always f32); bfloat16 "
        "shifts flow values by bf16 rounding",
    )
    p.add_argument(
        "--chunk", type=int, default=0,
        help="frame pairs per FlowNet batch (0 = per-dtype default: "
        "4 f32, 8 bf16)",
    )
    p.add_argument(
        "--no-mesh", action="store_true",
        help="disable the automatic data-parallel pair sharding over "
        "multi-device meshes (outputs are identical either way)",
    )
    _add_device(p)
    p.set_defaults(fn=cmd_calc_flow)

    p = sub.add_parser(
        "precompute-boxes",
        help="generate bboxes_{split}_{mode}.npy fixtures from the frames "
        "(motion maps on the device, contours on the host; obj_det modes "
        "run the config's mmdet_checkpoint, the converted Cascade R-CNN, "
        "on the device, or motion-only without one)",
    )
    _add_common(p)
    p.add_argument("--splits", default="train,test")
    p.add_argument("--overwrite", action="store_true")
    _add_device(p)
    p.set_defaults(fn=cmd_precompute_boxes)

    p = sub.add_parser(
        "serve",
        help="online streaming scorer over the test split "
        "(one frame at a time)",
    )
    _add_common(p)
    p.add_argument(
        "--frames", type=int, default=0,
        help="stream only the first N frames (0 = whole split + AUROC)",
    )
    p.add_argument(
        "--live-flow", action="store_true",
        help="compute optical flow on the device inside each push "
        "(no precomputed flow tree needed; two-stream models only)",
    )
    p.add_argument(
        "--cameras", type=int, default=1,
        help="fleet mode: C cameras stream the first test video in "
        "lockstep, scored together a tick (MultiCameraScorer)",
    )
    p.add_argument(
        "--flow-checkpoint", default=None,
        help="FlowNet2 torch checkpoint for --live-flow "
        "(random-init with a warning when absent)",
    )
    p.add_argument(
        "--camera-scenes", default=None,
        help="fleet mode: comma-separated per-camera scene rows "
        "(len --cameras, or one value for all; default: the first test "
        "video's scene)",
    )
    p.add_argument(
        "--motion", action="store_true",
        help="self-contained serving: foreground boxes computed in the "
        "loop from motion maps (no bbox source; with --live-flow, no flow "
        "tree either)",
    )
    p.add_argument(
        "--flow-dtype", choices=("float32", "bfloat16"), default="float32",
        help="--live-flow FlowNet forward dtype (scores shift by bf16 "
        "rounding)",
    )
    _add_device(p)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser(
        "flow-train",
        help="fine-tune a flow net (FlowNet2_src/main.py harness: "
        "epochs, validation EPE, resume, model_best)",
    )
    p.add_argument("--data-root", required=True)
    p.add_argument("--val-root", default=None,
                   help="validation tree (default: --data-root)")
    p.add_argument(
        "--dataset", default="FlyingChairs",
        choices=[d for d in _FLOW_DATASETS if d != "ImagesFromFolder"],
    )
    p.add_argument("--dstype", default="clean",
                   help="MpiSintel pass: clean | final")
    p.add_argument("--net", default="FlowNetS", choices=nets)
    p.add_argument("--workdir", required=True,
                   help="checkpoint/model_best directory")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--norm", default="L1", choices=["L1", "L2"],
                   help="norm inside the multiscale loss")
    p.add_argument(
        "--loss", default="multiscale", choices=["multiscale", "L1", "L2"],
        help="multiscale for component nets; L1/L2 single-scale on the "
        "fused output for the FlowNet2/CS/CSS composites "
        "(the reference's main.py:194-197 recipe)",
    )
    p.add_argument("--crop-size", default=None,
                   help="h,w StaticRandomCrop augmentation")
    p.add_argument("--schedule-lr-frequency", type=int, default=0)
    p.add_argument("--schedule-lr-fraction", type=float, default=10.0)
    p.add_argument("--checkpoint", default=None,
                   help="torch checkpoint to fine-tune from")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-resume", action="store_true")
    _add_device(p)
    p.set_defaults(fn=cmd_flow_train)

    p = sub.add_parser(
        "flow-infer",
        help="run a flow net over a flow dataset, optionally saving .flo "
        "predictions, and report EPE (the reference's --inference mode)",
    )
    p.add_argument("--data-root", required=True)
    p.add_argument("--dataset", default="FlyingChairs",
                   choices=list(_FLOW_DATASETS))
    p.add_argument("--dstype", default="clean",
                   help="MpiSintel pass: clean | final")
    p.add_argument("--iext", default="png",
                   help="ImagesFromFolder frame extension (png/jpg/...)")
    p.add_argument("--net", default="FlowNet2", choices=nets)
    p.add_argument("--checkpoint", default=None,
                   help="torch .pth(.tar) weights")
    p.add_argument("--workdir", default=None,
                   help="flow-train workdir to load model_best from")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--n-batches", type=int, default=-1,
                   help="stop after N batches (-1 = whole dataset)")
    p.add_argument("--save-flow", action="store_true",
                   help="write each prediction as %%06d.flo")
    p.add_argument("--out", default=None,
                   help="directory for saved flows (default: "
                   "<workdir>/inference)")
    _add_device(p)
    p.set_defaults(fn=cmd_flow_infer)

    p = sub.add_parser("demo", help="end-to-end demo on a synthetic dataset")
    p.add_argument("--base", default=None,
                   help="workspace directory, kept (default: a temporary "
                   "one, deleted after)")
    _add_device(p)
    p.set_defaults(fn=cmd_demo)

    p = sub.add_parser(
        "export-torch",
        help="export the trained model grid to the reference's torch "
        "artifact format (model_set + training-score grids)",
    )
    _add_common(p)
    p.add_argument(
        "--out", default=None,
        help="output directory (default: alongside the .npz model)",
    )
    _add_device(p)
    p.set_defaults(fn=cmd_export_torch)

    p = sub.add_parser(
        "import-torch",
        help="import a released reference checkpoint set (model_set + "
        "training-score grids) into the .npz model `test` loads",
    )
    _add_common(p)
    p.add_argument(
        "--model-dir", required=True,
        help="directory holding <ds>_model_<mode>_<method>.npy + the "
        "raw/of training-score files (the reference's data/raw2flow)",
    )
    p.add_argument(
        "--out", default=None,
        help="output .npz path (default: the canonical model path under "
        "--base, where `test` looks)",
    )
    _add_device(p)
    p.set_defaults(fn=cmd_import_torch)

    p = sub.add_parser(
        "visualize",
        help="render score masks / flow maps to images "
        "(test --save-masks + calc-flow artifacts)",
    )
    p.add_argument(
        "--masks", default=None,
        help="score_masks.npy from `test --save-masks` -> per-frame "
        "grayscale score_%%06d.png",
    )
    p.add_argument(
        "--frames-root", default=None,
        help="image tree matched 1:1 (natural order) with --masks frames -> "
        "JET overlay_%%06d.png",
    )
    p.add_argument(
        "--config", default=None,
        help="INI config: overlay on its dataset's test split instead "
        "(read through the native decoder)",
    )
    p.add_argument("--base", default=".", help="base dir holding raw_datasets/")
    p.add_argument("--dataset", default=None, help="override dataset_name")
    p.add_argument(
        "--flow-dir", default=None,
        help="tree of .npy/.flo flow maps -> Middlebury color-wheel pngs",
    )
    p.add_argument("--out", required=True, help="output image directory")
    p.add_argument("--limit", type=int, default=None, help="cap frames/maps")
    p.add_argument(
        "--alpha", type=float, default=0.5,
        help="overlay heatmap opacity on scored pixels",
    )
    p.set_defaults(fn=cmd_visualize)

    p = sub.add_parser("extract-frames", help="video file -> frame images (cv2)")
    p.add_argument("--video", required=True)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_extract_frames)

    args = ap.parse_args(argv)
    return args.fn(args)
