"""Per-layer timing of the completion ensemble's convolutions on the card,
a port of vec_vad_tpu/runtime/layer_profile.py on CUDA events.

Protocol: one warm call, then the best of `repeats` windows of `iters`
back-to-back calls, each window timed by a pair of CUDA events on the
stream (no host round trip inside a window). Eager PyTorch runs every
call it is given, so the JAX package's loop-carried perturbation (against
XLA hoisting the op out of its scan) and full-output reduction (against
dead-code elimination) have nothing to guard against here. A window
shorter than `min_wall_s` is re-run with proportionally more iterations,
as the JAX package does for its relay's round trip; on the card the
first-order term is the launch gap between short ops, and MIN_WALL_S is
0.05 s (the JAX package's 0.3 s covered a ~25 ms relay round trip that
the card does not have). CPU tensors are timed by the host's clock: the
tests' plain path.

`profile_unet_convs()` gives the per-shape table of the flagship UNet's
3x3 convolutions, `profile_ensemble_formulations()` the four layouts of
E members' convolutions, `profile_completion_program()` the whole
SelfCompletionNet forward or forward + backward, `timed_loop()` any
other callable.

    python -m vec_vad_torch.runtime.layer_profile [--batch 512] [--ensemble | --program fwdbwd]
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from vec_vad_torch.device import full_f32, resolve_device

#: Shortest timed window on the card (s); a shorter one is re-run with
#: more iterations (see module docstring).
MIN_WALL_S = 0.05


def _on_cuda(args) -> bool:
    return any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)


def _time_window(f: Callable, args, flops_once: float, iters: int,
                 repeats: int) -> Tuple[float, float]:
    """One warm call, then best-of-`repeats` windows of `iters` calls:
    CUDA events around each window on the card, the host's clock on the
    CPU. Returns (ms per iteration, TFLOP/s)."""
    cuda = _on_cuda(args)
    f(*args)
    if cuda:
        torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                f(*args)
            end.record()
            end.synchronize()
            secs = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                f(*args)
            secs = time.perf_counter() - t0
        best = min(best, secs)
    per = best / iters
    tps = (flops_once / per / 1e12) if flops_once > 0 else 0.0
    return per * 1e3, tps


def timed_loop(
    f: Callable,
    args: Sequence,
    flops_once: float,
    iters: int = 100,
    repeats: int = 3,
    min_wall_s: float = MIN_WALL_S,
    max_iters: int = 200_000,
) -> Tuple[float, float]:
    """Time `f(*args)`: returns (ms_per_iter, tflops_per_s).

    Auto-scales the window: if the best window of `iters` calls is shorter
    than `min_wall_s`, it is timed again with proportionally more calls
    until it is not (or `max_iters`). Pass min_wall_s=0 to disable (CPU
    unit tests)."""
    args = tuple(args)
    ms, tps = _time_window(f, args, flops_once, iters, repeats)
    wall = ms * iters / 1e3
    while wall < min_wall_s and iters < max_iters:
        # target 1.5x the floor so one rescale usually suffices
        iters = min(max_iters, max(iters + 1, int(iters * 1.5 * min_wall_s / max(wall, 1e-6))))
        ms, tps = _time_window(f, args, flops_once, iters, repeats)
        wall = ms * iters / 1e3
    return ms, tps


# (name, H==W, Cin, Cout): every distinct 3x3-conv shape in the depth-4
# completion UNet at features_root=32, patch 32 (models/layers.py UNet;
# reference model/unet.py:73-267). Cin=12 is the erased 4-frame raw input.
UNET_CONV_SHAPES: List[Tuple[str, int, int, int]] = [
    ("inc_a", 32, 12, 32),
    ("inc_b", 32, 32, 32),
    ("down1_a", 16, 32, 64),
    ("down1_b", 16, 64, 64),
    ("down2_a", 8, 64, 128),
    ("down2_b", 8, 128, 128),
    ("down3_a", 4, 128, 256),
    ("down3_b", 4, 256, 256),
    ("up1_a", 8, 256, 128),
    ("up1_b", 8, 128, 128),
    ("up2_a", 16, 128, 64),
    ("up2_b", 16, 64, 64),
    ("up3_a", 32, 64, 32),
    ("up3_b", 32, 32, 32),
]

def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def _conv(x, w, groups: int = 1):
    return F.conv2d(x, w, None, 1, 1, 1, groups)


def profile_unet_convs(
    batch: int = 512,
    dtypes: Sequence[torch.dtype] = (torch.float32, torch.bfloat16),
    iters: int = 100,
    shapes: Optional[List[Tuple[str, int, int, int]]] = None,
    seed: int = 0,
    device="cuda",
    min_wall_s: float = MIN_WALL_S,
) -> Dict[str, Dict[str, Tuple[float, float]]]:
    """Per-conv-shape timing table for the flagship UNet, in the layout
    models/layers.py gives cuDNN (NCHW, contiguous); f32 in full f32 (TF32
    off), bf16 as it is.

    batch: effective conv batch. The production ensemble folds E members
    into grouped channels at batch B (training B=128, E=4 -> pass 512 for
    the equivalent dense-batch shape; inference cube_batch=2048 -> 8192).

    Returns {shape_name: {dtype_name: (ms_per_iter, tflops_per_s)}}."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out: Dict[str, Dict[str, Tuple[float, float]]] = {}
    for name, H, cin, cout in shapes or UNET_CONV_SHAPES:
        x = rng.normal(size=(batch, cin, H, H)).astype(np.float32)
        w = (rng.normal(size=(cout, cin, 3, 3)) * 0.05).astype(np.float32)
        fl = 2.0 * batch * H * H * 9 * cin * cout
        row: Dict[str, Tuple[float, float]] = {}
        for dt in dtypes:
            args = (torch.from_numpy(x).to(dev, dt), torch.from_numpy(w).to(dev, dt))
            with full_f32(dt):
                ms, tps = timed_loop(_conv, args, fl, iters=iters,
                                     min_wall_s=min_wall_s)
            row[_dtype_name(dt)] = (round(ms, 4), round(tps, 1))
        out[name] = row
    return out


def _ensemble_layouts(x_e: torch.Tensor, w_e: torch.Tensor):
    """The four layouts of 'E convolutions with E weight sets' over
    x_e (E, B, C, H, W) and w_e (E, C, C, 3, 3): name -> (f, args, to_e),
    where to_e maps f's output back to (E, B, C, H, W)."""
    E, B, C, H, W = x_e.shape
    x_g = x_e.permute(1, 0, 2, 3, 4).reshape(B, E * C, H, W).contiguous()
    w_g = w_e.reshape(E * C, C, 3, 3).contiguous()
    w_b = torch.zeros(E * C, E * C, 3, 3, dtype=w_e.dtype, device=w_e.device)
    for i in range(E):
        w_b[i * C:(i + 1) * C, i * C:(i + 1) * C] = w_e[i]
    x_b = x_e.reshape(E * B, C, H, W)

    def folded_to_e(y):
        return y.reshape(B, E, C, H, W).permute(1, 0, 2, 3, 4)

    return {
        # E separate convolutions, one per member (JAX's vmap)
        "vmap": (lambda x, w: torch.stack([_conv(x[i], w[i]) for i in range(E)]),
                 (x_e, w_e), lambda y: y),
        # members folded into channels, groups=E: the port's production form
        "grouped": (lambda x, w: _conv(x, w, E), (x_g, w_g), folded_to_e),
        # members folded into channels, one dense conv with a block-diagonal
        # (E*C, E*C) kernel: E times the operations, one large contraction
        "blockdiag": (_conv, (x_g, w_b), folded_to_e),
        # members folded into batch with member 0's weight: not the same
        # math (a lower bound: what a weight-shared layout would cost)
        "sharedw_batch": (_conv, (x_b, w_e[0]),
                          lambda y: y.reshape(E, B, C, H, W)),
    }


def _ensemble_inputs(batch, members, H, C, seed, device, dtype):
    rng = np.random.default_rng(seed)
    x_e = rng.normal(size=(members, batch, C, H, H)).astype(np.float32)
    w_e = (rng.normal(size=(members, C, C, 3, 3)) * 0.05).astype(np.float32)
    dev = resolve_device(device)
    return (torch.from_numpy(x_e).to(dev, dtype),
            torch.from_numpy(w_e).to(dev, dtype))


def ensemble_formulation_outputs(
    batch: int = 128, members: int = 4, H: int = 32, C: int = 32,
    seed: int = 0, device="cuda", dtype: torch.dtype = torch.float32,
) -> Dict[str, torch.Tensor]:
    """Each layout's output as (E, B, C, H, W), for checking that vmap,
    grouped and blockdiag compute the same convolutions (and
    sharedw_batch the same as the others for member 0)."""
    x_e, w_e = _ensemble_inputs(batch, members, H, C, seed, device, dtype)
    with full_f32(dtype), torch.no_grad():
        return {name: to_e(f(*args))
                for name, (f, args, to_e) in _ensemble_layouts(x_e, w_e).items()}


def profile_ensemble_formulations(
    batch: int = 128,
    members: int = 4,
    H: int = 32,
    C: int = 32,
    iters: int = 100,
    seed: int = 0,
    device="cuda",
    dtype: torch.dtype = torch.float32,
    min_wall_s: float = MIN_WALL_S,
) -> Dict[str, Tuple[float, float]]:
    """Compare layouts for 'E independent convs with E weight sets' (the
    completion ensemble, reference model/models.py:13-64) at one
    representative conv shape: vmap, grouped, blockdiag, sharedw_batch
    (see _ensemble_layouts). f32 in full f32 (TF32 off).

    Returns {layout: (ms_per_iter, tflops_per_s)} with TFLOP/s computed
    against the USEFUL flops (vmap count) so layouts are comparable."""
    x_e, w_e = _ensemble_inputs(batch, members, H, C, seed, device, dtype)
    fl = 2.0 * members * batch * H * H * 9 * C * C
    out: Dict[str, Tuple[float, float]] = {}
    with full_f32(dtype), torch.no_grad():
        for name, (f, args, _) in _ensemble_layouts(x_e, w_e).items():
            out[name] = timed_loop(f, args, fl, iters=iters, min_wall_s=min_wall_s)
    return {k: (round(ms, 4), round(tps, 1)) for k, (ms, tps) in out.items()}


#: The JAX package's analytic forward FLOPs per cube for the flagship
#: completion ensemble (vec_vad_tpu/runtime/layer_profile.py:263, from
#: XLA's cost analysis), kept for comparison with `completion_fwd_flops`.
FLAGSHIP_PER_CUBE_FWD_FLOPS = 1.378e9


def completion_fwd_flops(net: nn.Module, patch: int = 32,
                         padding_taps: bool = True) -> float:
    """Forward FLOPs of one cube through `net`'s convolutions (2 per
    multiply-add; BatchNorm, ReLU and pooling left out), counted from the
    port's layers by forward hooks on one forward. padding_taps=False
    leaves out the taps that fall on the zero padding (cuDNN computes
    them; XLA's cost analysis, behind FLAGSHIP_PER_CUBE_FWD_FLOPS, does
    not)."""
    from vec_vad_torch.models.layers import Conv, ConvTranspose2x

    total = [0.0]

    def count(mod, inp, out):
        x = inp[0]
        k = mod.weight.shape[-1]
        pairs = mod.members * mod.in_ch * mod.features  # channel pairs a tap
        if padding_taps:
            taps = k * k * (x[0, 0].numel() if isinstance(mod, ConvTranspose2x)
                            else out[0, 0].numel())
        else:  # (input, output) pixel pairs that meet inside the frame
            ones = torch.ones((1, 1) + tuple(x.shape[-2:]))
            kern = torch.ones(1, 1, k, k)
            if isinstance(mod, ConvTranspose2x):
                taps = F.conv_transpose2d(ones, kern, None, 2, 1, 1).sum().item()
            else:
                taps = F.conv2d(ones, kern, None, 1, k // 2).sum().item()
        total[0] += 2.0 * x.shape[0] * taps * pairs

    hooks = [m.register_forward_hook(count) for m in net.modules()
             if isinstance(m, (Conv, ConvTranspose2x))]
    try:
        dev = next(net.parameters()).device
        cin = net.raw_channels * net.tot_raw_num
        x = torch.zeros(1, patch, patch, cin, device=dev)
        x_of = torch.zeros(1, patch, patch, net.of_channels * net.tot_of_num,
                           device=dev)
        with torch.no_grad():
            net(x, x_of, False)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def profile_completion_program(
    batches: Sequence[int] = (128, 1024),
    dtypes: Sequence[torch.dtype] = (torch.float32, torch.bfloat16),
    mode: str = "fwdbwd",
    iters: int = 20,
    per_cube_flops: Optional[float] = None,
    seed: int = 0,
    device="cuda",
    min_wall_s: float = MIN_WALL_S,
) -> Dict[str, Tuple[float, float]]:
    """Whole-program probes on the production completion ensemble
    (SelfCompletionNet at nf=32, 5raw, patch 32, eval mode as in the JAX
    package's probe): mode="fwd" is the scoring math (sum of squared
    errors over members and batch), mode="fwdbwd" the gradient of the MSE
    with respect to every parameter. Parameters and inputs are cast to
    each compute dtype as BlockTrainer's bf16 route does
    (torch.func.functional_call over cast copies); f32 runs in full f32.
    TFLOP/s counts per_cube_flops a cube forward (default: this net's
    count, `completion_fwd_flops`) and 3x that for fwdbwd.

    Returns {f"{mode}_b{B}_{dtype}": (ms_per_iter, tflops_per_s)}."""
    from torch.func import functional_call

    from vec_vad_torch.config import CompletionConfig
    from vec_vad_torch.models.completion import (
        init_completion_state,
        make_completion_net,
    )

    if mode not in ("fwd", "fwdbwd"):
        raise ValueError(f"mode must be 'fwd' or 'fwdbwd', got {mode!r}")
    dev = resolve_device(device)
    mc = CompletionConfig(nf=32, context_of_num=0, use_flow=False)
    net = make_completion_net(mc, device=dev)
    net.load_state_dict(init_completion_state(net, seed))
    if per_cube_flops is None:
        per_cube_flops = completion_fwd_flops(net)
    P = 32
    rng = np.random.default_rng(seed)
    results: Dict[str, Tuple[float, float]] = {}
    for B in batches:
        x = torch.from_numpy(
            rng.uniform(0, 1, (B, P, P, mc.tot_raw_num * 3)).astype(np.float32)
        ).to(dev)
        for dt in dtypes:
            fl = (per_cube_flops if mode == "fwd" else 3.0 * per_cube_flops) * B
            def forward(params, xd):
                cast = {k: p.to(dt) for k, p in params.items()}
                out = functional_call(net, cast, (xd, None, False))
                return out.raw_out, out.raw_tgt

            if mode == "fwd":
                params = dict(net.named_parameters())

                def run(xd):
                    with torch.no_grad():
                        out, tgt = forward(params, xd)
                        return torch.sum(torch.square((out - tgt).float()))
            else:
                params = {k: p.detach().requires_grad_(True)
                          for k, p in net.named_parameters()}

                def run(xd):
                    out, tgt = forward(params, xd)
                    loss = torch.mean(torch.square((out - tgt.detach()).float()))
                    return torch.autograd.grad(loss, list(params.values()))

            with full_f32(dt):
                ms, tps = timed_loop(run, (x.to(dt),), fl, iters=iters, repeats=3,
                                     min_wall_s=min_wall_s, max_iters=10_000)
            results[f"{mode}_b{B}_{_dtype_name(dt)}"] = (round(ms, 3), round(tps, 1))
    return results


def format_table(
    table: Dict[str, Dict[str, Tuple[float, float]]],
) -> str:
    dts = list(next(iter(table.values())).keys())
    hdr = "shape".ljust(10) + "".join(
        f"{d + ' ms':>14}{d + ' TF/s':>14}" for d in dts
    )
    lines = [hdr]
    for name, row in table.items():
        line = name.ljust(10)
        for d in dts:
            ms, tps = row[d]
            line += f"{ms:>14.4f}{tps:>14.1f}"
        lines.append(line)
    return "\n".join(lines)


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument(
        "--ensemble", action="store_true",
        help="run the ensemble-formulation comparison instead",
    )
    ap.add_argument(
        "--program", choices=("fwd", "fwdbwd"), default=None,
        help="run the whole-completion-program probe instead",
    )
    args = ap.parse_args(argv)
    if args.program:
        res = profile_completion_program(
            batches=(args.batch,), mode=args.program, iters=args.iters,
            device=args.device,
        )
        for k, (ms, tps) in res.items():
            print(f"{k:>24}: {ms:.3f} ms  {tps:.1f} TF/s")
    elif args.ensemble:
        for dt in (torch.float32, torch.bfloat16):
            for k, v in profile_ensemble_formulations(
                batch=args.batch, iters=args.iters, device=args.device, dtype=dt,
            ).items():
                print(f"{_dtype_name(dt):>9} {k:>14}: {v[0]:.4f} ms  {v[1]:.1f} TF/s")
    else:
        table = profile_unet_convs(batch=args.batch, iters=args.iters,
                                   device=args.device)
        print(format_table(table))


if __name__ == "__main__":
    main()
