"""The one generator of the benchmark's inputs and weights, driven by a
cell's traffic parameters (vadbench/workloads/<cell>.json) and `--seed`.

Everything that is large is made on the device from a `torch.Generator`
seeded with the run's seed, in a few large calls; the small host-side
parts (box sets, schedules) come from `np.random.default_rng(seed)`. The
same seed gives the same inputs and weights. Every seed gets the same
amount of work: box counts are a fixed multiset (a cell's range, in
equal shares) dealt out in a seeded order, so only where the boxes lie
and how large they are changes with the seed.

Frames: a smooth random texture a camera, larger than the frame, that
drifts by a per-camera velocity a frame, plus per-frame noise, as uint8.
Training cubes: smooth random patches whose frames drift, as uint8.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

SEED_MASK = (1 << 63) - 1


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A torch.Generator on `device` for sub-stream `stream` of `seed`."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + 7919 * stream) & SEED_MASK)
    return g


def host_rng(seed: int, stream: int = 0) -> np.random.Generator:
    return np.random.default_rng([int(seed) & SEED_MASK, stream])


def _smooth(g, shape, cells: int, device) -> torch.Tensor:
    """(n, c, h, w) smooth noise in [0, 1]: uniform values on a coarse
    grid of about `cells` cells on the long side, upsampled bilinearly."""
    n, c, h, w = shape
    gh = max(2, math.ceil(h * cells / max(h, w)) + 1)
    gw = max(2, math.ceil(w * cells / max(h, w)) + 1)
    coarse = torch.rand((n, c, gh, gw), generator=g, device=device)
    return F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=True)


def frames(seed: int, n_frames: int, cams: int, hw: Tuple[int, int],
           channels: int, device, stream: int = 1) -> torch.Tensor:
    """(cams, n_frames, H, W, channels) uint8 video on `device`."""
    H, W = hw
    g = generator(seed, device, stream)
    margin = max(H, W) // 4
    tex = _smooth(g, (cams, channels, H + margin, W + margin), 12, device)
    tex = 40.0 + 175.0 * tex
    vel = torch.rand((cams, 2), generator=g, device=device) * 3.0 + 0.5
    out = torch.empty((cams, n_frames, H, W, channels), dtype=torch.uint8,
                      device=device)
    for t in range(n_frames):
        oy = (vel[:, 0] * t).long() % margin
        ox = (vel[:, 1] * t).long() % margin
        for c in range(cams):
            y0, x0 = int(oy[c]), int(ox[c])
            img = tex[c, :, y0:y0 + H, x0:x0 + W]
            noise = torch.randn((channels, H, W), generator=g, device=device) * 4.0
            out[c, t] = (img + noise).clamp(0, 255).round().to(torch.uint8).permute(1, 2, 0)
    return out


def box_counts(n: int, lo: int, hi: int, rng: np.random.Generator) -> np.ndarray:
    """n box counts in lo..hi, each value in equal shares (the remainder
    from the low end), in a seeded order."""
    counts = np.resize(np.arange(lo, hi + 1), n)
    return rng.permutation(counts)


def boxes(counts: np.ndarray, hw: Tuple[int, int], side: Sequence[int],
          rng: np.random.Generator) -> List[np.ndarray]:
    """A (count, 4) float32 xyxy box set for each entry of `counts`, with
    width and height uniform in `side` and every box inside the frame."""
    H, W = hw
    lo, hi = side
    out = []
    for k in counts:
        wh = rng.uniform(lo, min(hi, W - 1, H - 1), (int(k), 2))
        x0 = rng.uniform(0, W - wh[:, 0])
        y0 = rng.uniform(0, H - wh[:, 1])
        out.append(np.stack([x0, y0, x0 + wh[:, 0], y0 + wh[:, 1]], 1)
                   .astype(np.float32))
    return out


def train_cubes(seed: int, n: int, patch: int, frames_per_cube: int, device,
                stream: int = 3, chunk: int = 1024) -> torch.Tensor:
    """(n, P, P, T*3) uint8 cubes, T-major channels: a smooth patch a cube
    whose T frames drift by a pixel a frame, plus noise."""
    g = generator(seed, device, stream)
    T = frames_per_cube
    out = torch.empty((n, patch, patch, T * 3), dtype=torch.uint8, device=device)
    for lo in range(0, n, chunk):
        b = min(chunk, n - lo)
        base = 30.0 + 195.0 * _smooth(g, (b, 3, patch + T, patch + T), 6, device)
        parts = []
        for t in range(T):
            img = base[:, :, t:t + patch, t:t + patch]
            img = img + torch.randn(img.shape, generator=g, device=device) * 3.0
            parts.append(img.clamp(0, 255).round().permute(0, 2, 3, 1))
        out[lo:lo + b] = torch.cat(parts, -1).to(torch.uint8)
    return out


def weights(spec: Sequence[Tuple[str, Tuple[int, ...], str]], seed: int,
            device, stream: int = 4) -> Dict[str, torch.Tensor]:
    """A state dict for `spec`'s (name, shape, init) entries, drawn in one
    uniform call on `device` and shaped leaf by leaf. Init rules:
      uniform_fan  U(+-1/sqrt(fan)), fan = product of the weight's dims
                   1.. (torch's default for conv and transposed conv; a
                   bias carries its weight's shape in its spec entry);
      xavier       U(+-sqrt(6 / (k*k*(a+b)))) for an (a, b, k, k) weight;
      unit         U(0, 1);
      one, zero    constants;
      bn_scale     U(0.5, 1.5);  bn_shift, bn_mean  U(-0.1, 0.1);
      bn_var       U(0.5, 1.5)."""
    sizes = [int(np.prod(shape)) for _, shape, _ in spec]
    flat = torch.rand(sum(sizes), generator=generator(seed, device, stream),
                      device=device)
    out, off = {}, 0
    for (name, shape, rule), n in zip(spec, sizes):
        u = flat[off:off + n]
        off += n
        if rule.startswith("uniform_fan"):
            fan = int(rule.split(":")[1])
            b = 1.0 / math.sqrt(fan)
            v = (u * 2.0 - 1.0) * b
        elif rule.startswith("xavier"):
            b = float(rule.split(":")[1])
            v = (u * 2.0 - 1.0) * b
        elif rule == "unit":
            v = u
        elif rule == "one":
            v = torch.ones_like(u)
        elif rule == "zero":
            v = torch.zeros_like(u)
        elif rule in ("bn_scale", "bn_var"):
            v = 0.5 + u
        elif rule in ("bn_shift", "bn_mean"):
            v = (u * 2.0 - 1.0) * 0.1
        else:
            raise ValueError(f"unknown init rule {rule!r}")
        out[name] = v.reshape(shape).clone()
    return out
