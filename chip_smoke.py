"""Smoke run of vec_vad_torch on one NVIDIA GPU: builds the hand-written
CUDA kernels, holds each against its plain PyTorch version, and serves the
live-flow two-stream slice end to end at full width.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and skipped):
  1. the card (nvidia-smi name and power limit); TF32 off for cuDNN and
     matmul, so every comparison below is full f32;
  2. kernels: K1 (csrc/correlation.cu) against `correlation_ref` at the
     serving shape (1, 48, 64, 256) in f32 and bf16 and at a ragged shape,
     with CUDA-event times and the card's bound for the same work;
  3. serving: FlowStreamingScorer on the card at UCSDped2's 240x360 with
     the 384x512 FlowNet2 protocol, a random-init FlowNet2 and a random
     5raw1of nf=32 two-stream model (numpy seeds), over seeded synthetic
     videos with 1-8 boxes a frame. Checks finite scores, one K1 launch
     per live push, K1 on the served conv3 features against the plain
     version, and the first video's first 4 scores against the same
     stream served on the CPU; then per-push latency, the time split
     between FlowNet2 and STC + ensemble, and a torch.profiler table of
     one more video's live pushes with the device's busy share.

The second-to-last line of output is the card's nvidia-smi line, the one
before it the {"kernels": [...]} record, and the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from vec_vad_torch import kernels
from vec_vad_torch.config import CompletionConfig, ForegroundConfig, PipelineConfig
from vec_vad_torch.data.synthetic import make_synthetic_dataset
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
# published H100 SXM peaks (NVIDIA data sheet, dense)
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES_S = 3.35e12
# K1 vs its plain version, f32: one f32 dot of C products summed in
# another order, then scaled by 1/C -> a few ulp of the output
K1_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6),
          # bf16 out: both round one f32 sum, at most one bf16 ulp apart
          torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-6)}
# card vs CPU scores (both full f32): cuDNN and oneDNN sum FlowNet2's ~40
# convolutions and the UNets in different orders, and a cube's uint8
# rounding may flip by one level, so scores agree to ~1e-4 relative; the
# bound is ten times that, relative to the largest score
CPU_REL_TOL = 1e-3


def check(ok: bool, what) -> None:
    """Fail the run (also under python -O, which drops asserts)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


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


def correlation_bound_ms(shape, dtype, max_disp=20, stride=2):
    """Least time for the cost volume on this card: the larger of the
    bytes it must move (a, b read once, the output written once) over the
    memory rate, and the multiply-adds its in-frame displacements need
    (out-of-frame ones are zero by definition) over the peak rate for the
    inputs' type. Returns (ms, 'bytes' | 'operations')."""
    B, H, W, C = shape
    d = np.arange(-max_disp, max_disp + 1, stride)
    rows = np.clip(H - np.abs(d), 0, None).sum()  # in-frame (y, dy) pairs
    cols = np.clip(W - np.abs(d), 0, None).sum()
    flops = 2.0 * B * rows * cols * C
    elem = torch.finfo(dtype).bits // 8
    nbytes = elem * B * H * W * (2 * C + len(d) ** 2)
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_phase(rng) -> dict:
    """K1 against correlation_ref on the card; returns the serving-shape
    f32 record."""
    cases = [(SERVE_SHAPE, torch.float32), (SERVE_SHAPE, torch.bfloat16),
             ((2, 13, 30, 48), torch.float32), ((2, 13, 30, 48), torch.bfloat16)]
    record = None
    for shape, dtype in cases:
        a, b = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                .to("cuda", dtype) for _ in range(2))
        got = fops.correlation(a, b)
        want = fops.correlation_ref(a, b)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        torch.testing.assert_close(got.float(), want.float(), **K1_TOL[dtype])
        ms = cuda_ms(lambda: fops.correlation(a, b), reps=200)
        plain_ms = cuda_ms(lambda: fops.correlation_ref(a, b), reps=10)
        bound_ms, bound_by = correlation_bound_ms(shape, dtype)
        print(f"kernel correlation {tuple(shape)} {str(dtype)[6:]}: "
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
    logs = kernels.build_kernels(["correlation"])
    print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name}: {line.strip()}")

    # -- kernel phase --------------------------------------------------------
    rng = np.random.default_rng(SEED)
    rec = kernel_phase(rng)

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
        got, want = fops.correlation(a, b), fops.correlation_ref(a, b)
        torch.testing.assert_close(got, want, **K1_TOL[torch.float32])
        hook_err = max(hook_err, float((got - want).abs().max()))
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

    rec.update(max_abs_err=max(rec["max_abs_err"], hook_err))
    record = {"kernels": [{
        "name": "correlation_fwd",
        "route": "cuda",
        "source": "vec_vad_torch/csrc/correlation.cu",
        "replaces": "vec_vad_tpu/models/flownet/ops.py:133",
        "launches": launches.get("correlation", 0),
        "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"],
        "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the cost volume
    }]}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
