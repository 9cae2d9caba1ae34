"""Smoke run of vec_vad_torch on one NVIDIA GPU: builds the hand-written
CUDA kernels, holds each against its plain PyTorch version, serves the
live-flow two-stream slice end to end at full width, and trains FlowNetC
(and takes a FlowNet2 fine-tuning step) at FlyingChairs' 384x512.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and skipped):
  1. the card (nvidia-smi name and power limit); TF32 off for cuDNN and
     matmul, so every comparison below is full f32; both kernel sources
     built at once (one nvcc each);
  2. kernels: K1 (csrc/correlation.cu) against `correlation_ref` at the
     serving shape (1, 48, 64, 256) and the training shape (8, 48, 64,
     256) in f32 and bf16 and at a ragged shape; K2
     (csrc/correlation_bwd.cu) against `correlation_bwd_ref` at the
     training shape in f32 and bf16 and at a ragged shape. CUDA-event
     times beside the card's bound for the same work;
  3. serving: FlowStreamingScorer on the card at UCSDped2's 240x360 with
     the 384x512 FlowNet2 protocol, a random-init FlowNet2 and a random
     5raw1of nf=32 two-stream model (numpy seeds), over seeded synthetic
     videos with 1-8 boxes a frame. Checks finite scores, one K1 launch
     per live push, K1 on the served conv3 features against the plain
     version, and the first video's first 4 scores against the same
     stream served on the CPU; then per-push latency, the time split
     between FlowNet2 and STC + ensemble, and a torch.profiler table of
     one more video's live pushes with the device's busy share;
  4. training: FlowHarness.fit of the full FlowNetC (the `flow-train
     --net FlowNetC --loss multiscale` recipe: batch 8, Adam lr 1e-4)
     for 2 epochs over 16 seeded synthetic 384x512 pairs (smooth textures
     shifted by a known flow, held in memory). Checks the first step's
     loss against the same batch on the CPU, finite losses, one K1 and
     one K2 launch per step (validation: K1 only), and K1 and K2 on a
     real step's (a, b, g), taken by module hooks, against the plain
     versions; then ms per step over 24 steady steps, pairs/s, peak
     device memory and a torch.profiler table of a few steps with the
     device's busy share. Then 20 single-scale L1 steps of
     PairMajorAdapter(FlowNet2) at batch 1, one K1 and one K2 launch
     each.

The second-to-last line of output is the card's nvidia-smi line, the one
before it the {"kernels": [...]} record, and the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from vec_vad_torch import kernels
from vec_vad_torch.cli import make_flow_net
from vec_vad_torch.config import CompletionConfig, ForegroundConfig, PipelineConfig
from vec_vad_torch.data.synthetic import make_synthetic_dataset
from vec_vad_torch.flow.harness import FlowHarness
from vec_vad_torch.flow.trainer import FlowTrainer
from vec_vad_torch.models.completion import init_completion_state, make_completion_net
from vec_vad_torch.models.flownet import make_flownet2
from vec_vad_torch.models.flownet import ops as fops
from vec_vad_torch.pipeline import TrainedBlock, VadModel
from vec_vad_torch.serve import FlowStreamingScorer

SEED = 0
FRAME_HW = (240, 360)  # UCSDped2
FLOW_HW = (384, 512)  # the FlowNet2 protocol
VIDEO_LENGTHS = (16, 16, 2)  # the 2-frame video exercises the tail rule
SERVE_SHAPE = (1, 48, 64, 256)  # FlowNetC conv3 features at 384x512
TRAIN_SHAPE = (8, 48, 64, 256)  # the same at the training batch of 8
RAGGED_SHAPE = (2, 13, 30, 48)
TRAIN_BATCH, TRAIN_PAIRS, TRAIN_EPOCHS = 8, 16, 2
TRAIN_STEADY = 24  # timed steps after fit (FlowNetC at batch 8)
FLOWNET2_STEPS = 20  # timed FlowNet2 fine-tuning steps at batch 1
WORKDIR = Path(__file__).resolve().parent / "build" / "chip_smoke_flow_train"
# published H100 SXM peaks (NVIDIA data sheet, dense)
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES_S = 3.35e12
# K1 vs its plain version, f32: one f32 dot of C products summed in
# another order, then scaled by 1/C -> a few ulp of the output
K1_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6),
          # bf16 out: both round one f32 sum, at most one bf16 ulp apart
          torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-6)}
# K2 vs its plain version: per output the same f32 sum of n*n products in
# the same order, fused multiply-adds against separate ones -> a few ulp;
# bf16 grads round one f32 sum -> one bf16 ulp
K2_TOL = K1_TOL
# card vs CPU training loss (both full f32): FlowNetC's ~30 convolutions
# summed in other orders by cuDNN and oneDNN
LOSS_REL_TOL = 1e-4
# card vs CPU scores (both full f32): cuDNN and oneDNN sum FlowNet2's ~40
# convolutions and the UNets in different orders, and a cube's uint8
# rounding may flip by one level, so scores agree to ~1e-4 relative; the
# bound is ten times that, relative to the largest score
CPU_REL_TOL = 1e-3


def check(ok: bool, what) -> None:
    """Fail the run (also under python -O, which drops asserts)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def phase_done(name: str, t0: float) -> float:
    """Print a phase's wall time; returns the clock for the next one."""
    now = time.perf_counter()
    print(f"phase {name}: {now - t0:.1f} s wall", flush=True)
    return now


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warm: int = 3) -> float:
    """Mean ms of fn() over `reps` back-to-back runs, by CUDA events."""
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def correlation_bound_ms(shape, dtype, max_disp=20, stride=2, backward=False):
    """Least time for the cost volume (or, with backward, both of its
    gradients) on this card: the larger of the bytes it must move (each
    input read once, each output written once: a, b -> out; a, b, g ->
    grad_a, grad_b) over the memory rate, and the multiply-adds its
    in-frame displacements need (out-of-frame ones are zero by
    definition; the backward does them once per gradient) over the peak
    rate for the inputs' type. Returns (ms, 'bytes' | 'operations')."""
    B, H, W, C = shape
    d = np.arange(-max_disp, max_disp + 1, stride)
    rows = np.clip(H - np.abs(d), 0, None).sum()  # in-frame (y, dy) pairs
    cols = np.clip(W - np.abs(d), 0, None).sum()
    flops = 2.0 * B * rows * cols * C * (2 if backward else 1)
    elem = torch.finfo(dtype).bits // 8
    nbytes = elem * B * H * W * ((4 if backward else 2) * C + len(d) ** 2)
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _cuda_normal(rng, shape, dtype):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to("cuda", dtype)


def check_fwd(a, b) -> float:
    """K1 against correlation_ref on the same inputs; max |error|."""
    got, want = fops.correlation(a, b), fops.correlation_ref(a, b)
    torch.cuda.synchronize()
    check(got.dtype == a.dtype and got.shape == want.shape,
          f"K1 out {got.dtype} {got.shape}")
    torch.testing.assert_close(got.float(), want.float(), **K1_TOL[a.dtype])
    return float((got.float() - want.float()).abs().max())


def kernel_phase(rng) -> dict:
    """K1 against correlation_ref on the card at the serving and training
    shapes; returns the serving-shape f32 record, its max_abs_err the
    largest f32 error at either shape."""
    cases = [(SERVE_SHAPE, torch.float32), (SERVE_SHAPE, torch.bfloat16),
             (TRAIN_SHAPE, torch.float32), (TRAIN_SHAPE, torch.bfloat16),
             (RAGGED_SHAPE, torch.float32), (RAGGED_SHAPE, torch.bfloat16)]
    record, f32_err = None, 0.0
    for shape, dtype in cases:
        a, b = (_cuda_normal(rng, shape, dtype) for _ in range(2))
        err = check_fwd(a, b)
        if dtype == torch.float32 and shape != RAGGED_SHAPE:
            f32_err = max(f32_err, err)
        big = shape == TRAIN_SHAPE
        ms = cuda_ms(lambda: fops.correlation(a, b), reps=100 if big else 200)
        plain_ms = cuda_ms(lambda: fops.correlation_ref(a, b), reps=3 if big else 10)
        bound_ms, bound_by = correlation_bound_ms(shape, dtype)
        print(f"kernel correlation {tuple(shape)} {str(dtype)[6:]}: "
              f"max_abs_err={err:.3e} ms={ms:.6f} plain_ms={plain_ms:.6f} "
              f"bound_ms={bound_ms:.6f} ({bound_by})", flush=True)
        if record is None:
            record = dict(ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
    record["max_abs_err"] = f32_err
    return record


def check_bwd(a, b, g, dtype) -> float:
    """K2 against correlation_bwd_ref on the same inputs; max |error|."""
    got = fops.correlation_bwd(a, b, g)
    want = fops.correlation_bwd_ref(a, b, g)
    torch.cuda.synchronize()
    err = 0.0
    for x, y in zip(got, want):
        check(x.dtype == dtype and x.shape == a.shape, f"K2 grad {x.dtype} {x.shape}")
        torch.testing.assert_close(x.float(), y.float(), **K2_TOL[dtype])
        err = max(err, float((x.float() - y.float()).abs().max()))
    return err


def kernel_bwd_phase(rng) -> dict:
    """K2 against correlation_bwd_ref on the card; returns the
    training-shape f32 record."""
    cases = [(TRAIN_SHAPE, torch.float32), (TRAIN_SHAPE, torch.bfloat16),
             (RAGGED_SHAPE, torch.float32), (RAGGED_SHAPE, torch.bfloat16)]
    record = None
    for shape, dtype in cases:
        a, b = (_cuda_normal(rng, shape, dtype) for _ in range(2))
        g = _cuda_normal(rng, shape[:3] + (441,), dtype)
        err = check_bwd(a, b, g, dtype)
        ms = cuda_ms(lambda: fops.correlation_bwd(a, b, g), reps=50)
        plain_ms = cuda_ms(lambda: fops.correlation_bwd_ref(a, b, g), reps=3)
        bound_ms, bound_by = correlation_bound_ms(shape, dtype, backward=True)
        print(f"kernel correlation_bwd {tuple(shape)} {str(dtype)[6:]}: "
              f"max_abs_err={err:.3e} ms={ms:.6f} plain_ms={plain_ms:.6f} "
              f"bound_ms={bound_ms:.6f} ({bound_by})", flush=True)
        if record is None:
            record = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
    return record


def make_model(nf: int, patch: int, seed: int) -> VadModel:
    """A two-stream 5raw1of VadModel (one block) with random weights and
    seeded training-score vectors, all from numpy seeds."""
    cfg = PipelineConfig(
        dataset_name="UCSDped2",
        fore=ForegroundConfig(patch_size=patch, max_boxes_per_frame=64),
        model=CompletionConfig(nf=nf, context_frame_num=4, context_of_num=0,
                               use_flow=True),
    )
    sd = init_completion_state(make_completion_net(cfg.model, device="cpu"), seed)
    rng = np.random.default_rng(seed)
    block = TrainedBlock(sd, rng.normal(100.0, 10.0, 256).astype(np.float32),
                         rng.normal(10.0, 1.0, 256).astype(np.float32))
    return VadModel(cfg=cfg, blocks={(0, 0, 0): block})


def make_stream(frame_hw, lengths, seed):
    """Seeded synthetic videos, each frame's boxes topped up with random
    ones to 1-8 boxes."""
    ds = make_synthetic_dataset(frames_per_video=max(lengths), n_train_videos=1,
                                n_test_videos=len(lengths), frame_h=frame_hw[0],
                                frame_w=frame_hw[1], seed=seed)
    rng = np.random.default_rng(seed + 1)
    H, W = frame_hw
    videos, off = [], 0
    for ln in lengths:
        frames, boxes = [], []
        for t in range(ln):
            bx = ds.test_boxes[off + t][: rng.integers(1, 4)]
            extra = rng.integers(0, 9 - len(bx))
            x0 = rng.uniform(0, W - 8, extra)
            y0 = rng.uniform(0, H - 8, extra)
            wh = rng.uniform(8, 64, (extra, 2))
            more = np.stack([x0, y0, np.minimum(x0 + wh[:, 0], W),
                             np.minimum(y0 + wh[:, 1], H)], 1)
            frames.append(ds.test_frames[off + t])
            boxes.append(np.concatenate([bx, more]).astype(np.float32))
        videos.append((frames, boxes))
        off += max(lengths)
    return videos


def serve(scorer, videos, sync=lambda: None):
    """Stream every video; returns (per-video score lists, live-push
    latencies in ms per video, live pushes)."""
    scores, lat, live = [], [], 0
    for frames, boxes in videos:
        scorer.start_video()
        vs, vl = [], []
        for i, (f, b) in enumerate(zip(frames, boxes)):
            t0 = time.perf_counter()
            s = scorer.push(f, b)
            sync()
            if i != 1:  # push 1 only writes the ring (no flow, no score)
                vl.append((time.perf_counter() - t0) * 1e3)
                live += 1
            if s is not None:
                vs.append(s)
        s = scorer.end_video()
        if s is not None:
            vs.append(s)
            live += 1
        scores.append(vs)
        lat.append(vl)
    return scores, lat, live


def profile_pushes(scorer, frames, boxes, warm: int = 3) -> None:
    """torch.profiler over the live pushes of one video after `warm`
    pushes: device time by operator and the device's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    scorer.start_video()
    for f, b in zip(frames[:warm], boxes[:warm]):
        scorer.push(f, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f, b in zip(frames[warm:], boxes[warm:]):
            scorer.push(f, b)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    scorer.end_video()
    ev = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in ev
                  if e.device_type == DeviceType.CUDA)
    print(ev.table(sort_by="self_device_time_total", row_limit=25))
    print(f"profile: {len(frames) - warm} live pushes, wall {wall_us / 1e3:.3f} ms, "
          f"device busy {busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f} %)")


class SyntheticPairs:
    """FlyingChairs-geometry training pairs held in memory, with the
    `batches()` contract of flow/datasets.PairFlowDataset: smooth seeded
    textures, the second frame the first shifted by a whole-pixel flow
    (u, v) in [-8, 8] per pair, so the ground truth is known exactly."""

    def __init__(self, n: int, hw, seed: int):
        rng = np.random.default_rng(seed)
        h, w = hw
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        self.pairs = np.empty((n, h, w, 6), np.float32)
        self.flows = np.empty((n, h, w, 2), np.float32)
        for i in range(n):
            f = rng.uniform(3.0, 12.0, (3, 2))
            phase = rng.uniform(0, 2 * np.pi, (3, 2))
            img = np.stack([127 + 60 * np.sin(xx / f[c, 0] + phase[c, 0])
                            + 60 * np.cos(yy / f[c, 1] + phase[c, 1])
                            for c in range(3)], -1).round()
            u, v = (int(x) for x in rng.integers(-8, 9, 2))
            self.pairs[i, ..., :3] = img
            self.pairs[i, ..., 3:] = np.roll(img, (v, u), axis=(0, 1))
            self.flows[i] = (u, v)

    def __len__(self) -> int:
        return len(self.pairs)

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0):
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for lo in range(0, len(self), batch_size):
            sel = order[lo: lo + batch_size]
            yield self.pairs[sel], self.flows[sel]


def profile_steps(trainer, batches) -> None:
    """torch.profiler over training steps: device time by operator and the
    device's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for pairs, target in batches:
            trainer.step(pairs, target)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ev = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in ev
                  if e.device_type == DeviceType.CUDA)
    print(ev.table(sort_by="self_device_time_total", row_limit=25))
    print(f"train profile: {len(batches)} steps, wall {wall_us / 1e3:.3f} ms, "
          f"device busy {busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f} %)")


def step_stats(ms) -> str:
    """Median and spread of a window of step times (ms)."""
    p10, p50, p90 = np.percentile(ms, (10, 50, 90))
    return (f"median {p50:.3f} p10 {p10:.3f} p90 {p90:.3f} min {min(ms):.3f} "
            f"max {max(ms):.3f} over {len(ms)} steps")


def capture_cost_volume(net):
    """Hooks on FlowNetC's conv3 and conv3_1 that keep one training step's
    cost-volume inputs and cotangent: a and b are conv3's two outputs, g
    the gradient at conv3_1's input, sliced to the 441 cost-volume
    channels and taken back through the LeakyReLU(0.1) that follows the
    correlation (up to the sign of an entry within an ulp of 0, which
    leaves g a fair input for K2). Returns `finish`, which removes the
    hooks after that step and returns (a, b, g)."""
    captured = {"ab": []}

    def on_conv3(mod, inp, out):
        if len(captured["ab"]) < 2:
            captured["ab"].append(out.detach().contiguous())

    def keep_g(grad):  # returns None: the gradient flows on unchanged
        captured.setdefault("g", grad[..., -441:].contiguous())

    def on_conv3_1(mod, inp):
        if "g" not in captured:
            inp[0].register_hook(keep_g)

    hooks = [net.conv3.register_forward_hook(on_conv3),
             net.conv3_1.register_forward_pre_hook(on_conv3_1)]

    def finish():
        for h in hooks:
            h.remove()
        a, b = captured["ab"]
        raw = fops.correlation_ref(a, b)
        g = captured["g"] * torch.where(raw > 0, 1.0, 0.1)
        return a, b, g

    return finish


def train_phase() -> dict:
    """FlowHarness.fit of FlowNetC on the card, then steady steps; returns
    fit's launch counts and K1's and K2's errors on a real step's inputs."""
    data = SyntheticPairs(TRAIN_PAIRS, FLOW_HW, SEED + 3)
    trainer = FlowTrainer(make_flow_net("FlowNetC", SEED, "cuda"), device="cuda")
    harness = FlowHarness(trainer, str(WORKDIR))
    shutil.rmtree(WORKDIR, ignore_errors=True)

    # the first step's loss, on the card and on the CPU: same seeded
    # weights, the batch fit takes first (epoch 1 shuffles with seed + 1)
    first = next(data.batches(TRAIN_BATCH, shuffle=True, seed=SEED + 1))
    cpu = FlowTrainer(make_flow_net("FlowNetC", SEED, "cpu"), device="cpu")
    with torch.no_grad():
        card_loss = float(trainer.loss(*(trainer.to_device(x) for x in first))[0])
        cpu_loss = float(cpu.loss(*(cpu.to_device(x) for x in first))[0])
    del cpu
    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    print(f"train: first step's loss card={card_loss:.8f} cpu={cpu_loss:.8f} "
          f"rel diff={rel:.3e} (bound {LOSS_REL_TOL})")
    check(rel <= LOSS_REL_TOL, f"card vs CPU first loss {card_loss} / {cpu_loss}")

    # the main path: fit, counts read just before and just after
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    result = harness.fit(data, data, total_epochs=TRAIN_EPOCHS,
                         batch_size=TRAIN_BATCH, seed=SEED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated()

    n_steps = TRAIN_EPOCHS * -(-TRAIN_PAIRS // TRAIN_BATCH)
    n_val = n_steps  # validation runs the same batches, forward only
    hist = [(h["train_loss"], h["val_epe"]) for h in result.history]
    print(f"train: FlowNetC 2x{FLOW_HW} batch {TRAIN_BATCH}, {n_steps} steps "
          f"in {TRAIN_EPOCHS} epochs, {wall:.2f} s wall (validation and "
          f"checkpoints included); (mean loss, val EPE) per epoch {hist}; "
          f"launches {launches}; peak device memory {peak / 2**20:.1f} MiB",
          flush=True)
    check(len(hist) == TRAIN_EPOCHS and np.isfinite(hist).all(), f"fit {hist}")
    check(launches == {"correlation": n_steps + n_val, "correlation_bwd": n_steps},
          f"fit launches {launches} for {n_steps} steps, {n_val} val batches")

    # steady steps: one launch of each kernel a step; the first step's
    # cost-volume inputs and cotangent are kept for K1 and K2
    batches = list(data.batches(TRAIN_BATCH, shuffle=True, seed=SEED + 9))
    finish = capture_cost_volume(trainer.net)
    step_ms, losses = [], []
    for i, (pairs, target) in enumerate(batches * (TRAIN_STEADY // len(batches))):
        before = kernels.launch_counts.copy()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(trainer.step(pairs, target)["loss"]))  # synchronises
        step_ms.append((time.perf_counter() - t0) * 1e3)
        step = dict(kernels.launch_counts - before)
        check(step == {"correlation": 1, "correlation_bwd": 1},
              f"step {i} launches {step}")
        if i == 0:
            a, b, g = finish()
    check(np.isfinite(losses).all(), f"steady losses {losses}")
    med = float(np.median(step_ms))
    print(f"train: ms per step (synchronised) {step_stats(step_ms)}; "
          f"{TRAIN_BATCH * 1e3 / med:.2f} pairs/s at the median", flush=True)

    check(tuple(a.shape) == TRAIN_SHAPE and tuple(g.shape) == TRAIN_SHAPE[:3] + (441,),
          f"captured cost-volume inputs {tuple(a.shape)} {tuple(g.shape)}")
    fwd_err = check_fwd(a, b)
    bwd_err = check_bwd(a, b, g, torch.float32)
    print(f"train: on a training step's (a, b, g) K1 max_abs_err={fwd_err:.3e} "
          f"K2 max_abs_err={bwd_err:.3e}")

    profile_steps(trainer, batches)
    shutil.rmtree(WORKDIR, ignore_errors=True)
    return dict(launches=launches, fwd_err=fwd_err, bwd_err=bwd_err)


def flownet2_phase() -> dict:
    """Single-scale L1 fine-tuning steps of PairMajorAdapter(FlowNet2) at
    batch 1 (the composite recipe `flow-train --net FlowNet2 --loss L1`):
    one K1 and one K2 launch a step; returns the launch counts."""
    data = SyntheticPairs(2, FLOW_HW, SEED + 4)
    trainer = FlowTrainer(make_flow_net("FlowNet2", SEED, "cuda"), loss="single",
                          norm="L1", device="cuda")
    (pairs, target), = data.batches(2, shuffle=False)
    kernels.reset_launch_counts()
    ms, losses = [], []
    for i in range(FLOWNET2_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(trainer.step(pairs[i % 2:][:1], target[i % 2:][:1])["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(kernels.launch_counts)
    print(f"train FlowNet2 (single-scale L1, batch 1, 2x{FLOW_HW}): first losses "
          f"{[round(x, 6) for x in losses[:4]]}; launches {launches}; ms per step "
          f"(synchronised, steps 2-{FLOWNET2_STEPS}) {step_stats(ms[1:])} "
          f"(first {ms[0]:.1f})")
    check(np.isfinite(losses).all(), f"FlowNet2 losses {losses}")
    check(launches == {"correlation": FLOWNET2_STEPS, "correlation_bwd": FLOWNET2_STEPS},
          f"FlowNet2 step launches {launches}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("tf32: cudnn.allow_tf32=False, cuda.matmul.allow_tf32=False "
          "(full f32 for every phase)")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    # -- build ------------------------------------------------------------
    t0 = time.perf_counter()
    logs = kernels.build_kernels(["correlation", "correlation_bwd"])
    print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name}: {line.strip()}")

    # -- kernel phase --------------------------------------------------------
    t_phase = time.perf_counter()
    rec = kernel_phase(np.random.default_rng(SEED))
    rec_bwd = kernel_bwd_phase(np.random.default_rng(SEED + 5))
    t_phase = phase_done("kernels", t_phase)

    # -- serving phase -------------------------------------------------------
    flow_net = make_flownet2(SEED, device="cuda")
    n_params = sum(p.numel() for p in flow_net.parameters())
    check(n_params == 162_518_834, f"FlowNet2 has {n_params} parameters")
    model = make_model(nf=32, patch=32, seed=SEED + 1)
    videos = make_stream(FRAME_HW, VIDEO_LENGTHS, seed=SEED + 2)
    scorer = FlowStreamingScorer.from_model(
        model, flow_net=flow_net, flow_model_hw=FLOW_HW, device="cuda")

    conv3 = []  # (a, b) conv3 features of the first two served pairs
    hook = flow_net.flownetc.conv3.register_forward_hook(
        lambda m, i, o: conv3.append(o.detach().clone()) if len(conv3) < 4 else None)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    scores, lat, live = serve(scorer, videos, torch.cuda.synchronize)
    wall = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    hook.remove()

    flat = np.concatenate([np.asarray(s, np.float64) for s in scores])
    n_frames = sum(VIDEO_LENGTHS)
    print(f"serve: {n_frames} frames in {len(VIDEO_LENGTHS)} videos, "
          f"{live} live pushes, {wall:.2f} s wall; scores "
          f"min={flat.min():.4f} max={flat.max():.4f}", flush=True)
    check(flat.shape == (n_frames,), f"{flat.shape} scores for {n_frames} frames")
    check(np.isfinite(flat).all(), f"non-finite scores {flat}")
    check(launches.get("correlation", 0) == live,
          f"K1 launches {launches} for {live} live pushes")
    steady = np.concatenate([np.asarray(v) for v in lat[1:]])
    print(f"serve: per-push latency (live pushes after the first video, "
          f"synchronised) median={np.median(steady):.3f} ms "
          f"p90={np.percentile(steady, 90):.3f} ms; first push "
          f"{lat[0][0]:.1f} ms; peak device memory {peak / 2**20:.1f} MiB")

    # K1 on the served conv3 features (pair (f0, f0), then (f1, f2))
    hook_err = 0.0
    for a, b in (conv3[0:2], conv3[2:4]):
        check(tuple(a.shape) == SERVE_SHAPE, f"conv3 features {tuple(a.shape)}")
        hook_err = max(hook_err, check_fwd(a.contiguous(), b.contiguous()))
    print(f"serve: K1 on the served conv3 features max_abs_err={hook_err:.3e}")

    x = torch.from_numpy(np.stack(videos[0][0][:2])).cuda()
    pair = torch.nn.functional.interpolate(  # any 384x512 frame pair
        x.permute(0, 3, 1, 2).float(), size=FLOW_HW, mode="bilinear"
    ).permute(0, 2, 3, 1)[None].contiguous()
    # the other half of a live push: STC + the ensemble over the padded box set
    win_t, owin_t = scorer._indices(
        (np.arange(scorer.R), scorer._rlen), (np.zeros(scorer.R_of), scorer.R_of))
    boxes_pad, _ = scorer._pad_boxes(videos[0][1][0])
    with torch.no_grad():
        flow_ms = cuda_ms(lambda: flow_net(pair), reps=10)
        score_ms = cuda_ms(
            lambda: scorer._score_from_rings(win_t, owin_t, boxes_pad), reps=10)
    print(f"serve: FlowNet2 forward (1, 2, 384, 512, 3) f32 {flow_ms:.3f} ms; "
          f"STC + 5raw1of ensemble over {scorer.K} padded boxes {score_ms:.3f} ms; "
          f"rest of the median push {np.median(steady) - flow_ms - score_ms:.3f} ms")

    # the same first 5 pushes served on the CPU: frames 0-3's scores
    cpu_net = make_flownet2(SEED, device="cpu")
    cpu = FlowStreamingScorer.from_model(
        model, flow_net=cpu_net, flow_model_hw=FLOW_HW, device="cpu")
    frames, boxes = videos[0]
    cpu.start_video()
    cpu_scores = [s for s in (cpu.push(f, b) for f, b in
                              zip(frames[:5], boxes[:5])) if s is not None]
    want = np.asarray(cpu_scores, np.float64)
    got = np.asarray(scores[0][:4], np.float64)
    rel = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
    print(f"serve: card vs CPU, frames 0-3: card={got.tolist()} "
          f"cpu={want.tolist()} max rel diff={rel:.3e} (bound {CPU_REL_TOL})")
    check(want.shape == (4,) and rel <= CPU_REL_TOL,
          f"card vs CPU scores {got} / {want}")

    profile_pushes(scorer, *videos[1])
    del scorer, cpu, cpu_net, flow_net
    t_phase = phase_done("serving", t_phase)

    # -- training phase ------------------------------------------------------
    train = train_phase()
    ft_launches = flownet2_phase()
    phase_done("training", t_phase)

    rec.update(max_abs_err=max(rec["max_abs_err"], hook_err, train["fwd_err"]))
    rec_bwd.update(max_abs_err=max(rec_bwd["max_abs_err"], train["bwd_err"]))
    k1 = (launches.get("correlation", 0) + train["launches"]["correlation"]
          + ft_launches["correlation"])
    k2 = train["launches"]["correlation_bwd"] + ft_launches["correlation_bwd"]
    print(f"launches on the main paths: K1 {k1} (serving {launches.get('correlation', 0)}, "
          f"FlowNetC training {train['launches']['correlation']}, FlowNet2 steps "
          f"{ft_launches['correlation']}); K2 {k2}")
    # no single PyTorch call computes the cost volume or its gradients
    record = {"kernels": [
        {"name": "correlation_fwd", "route": "cuda",
         "source": "vec_vad_torch/csrc/correlation.cu",
         "replaces": "vec_vad_tpu/models/flownet/ops.py:133",
         "launches": k1, **rec, "library_ms": None},
        {"name": "correlation_bwd", "route": "cuda",
         "source": "vec_vad_torch/csrc/correlation_bwd.cu",
         "replaces": "vec_vad_tpu/models/flownet/ops.py:275",
         "launches": k2, **rec_bwd, "library_ms": None},
    ]}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
