"""The port's command line (vec_vad_tpu/cli.py): `flow-train` and
`flow-infer`, with vec_vad_tpu's flags and messages plus `--device`
(the card by default; `--device cpu` runs the plain PyTorch path).

    python -m vec_vad_torch flow-train --data-root TREE --workdir WD \\
        --net FlowNetC --loss multiscale --norm L1
    python -m vec_vad_torch flow-infer --data-root TREE --workdir WD

The other subcommands of vec_vad_tpu are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import os

_FLOW_COMPONENTS = ("FlowNetC", "FlowNetS", "FlowNetSD")
_FLOW_COMPOSITES = ("FlowNet2", "FlowNet2CS", "FlowNet2CSS")
_FLOW_DATASETS = (
    "MpiSintel", "FlyingChairs", "ChairsSDHom",
    "FlyingThingsClean", "FlyingThingsFinal", "ImagesFromFolder",
)


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


def _add_device(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="vec_vad_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    nets = list(_FLOW_COMPONENTS + _FLOW_COMPOSITES)

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

    args = ap.parse_args(argv)
    return args.fn(args)
