"""Shared serving plumbing (vec_vad_tpu/serve/_common.py): window math,
the row set of a step's valid cubes, the host side of the device
traffic, the device-time chain every probe uses, and the fleet helpers.

The JAX package's one-buffer weight packing (_pack_f32/_unflatten_f32/
_download_f32_tree) has no counterpart here: it existed to marshal a
pytree into a jitted call as one argument, while a torch module keeps its
weights resident on the device between calls. A fleet on a device mesh
(`mesh=`) keeps one replica an entry (_fleet_replicas) in place of JAX's
_shard_over_cameras.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from vec_vad_torch.device import resolve_device
from vec_vad_torch.parallel.mesh import as_mesh
from vec_vad_torch.runtime.profiling import annotate

# The ensemble forwards a step's valid cube rows padded to a multiple of
# ROW_BUCKET (capped at the step's k*K): one fixed granularity bounds the
# batch sizes, and so the cuDNN plans and allocator sizes, a stream meets.
# On an H100 a live fleet tick (8 cameras, 1-8 boxes each) took 3 % less
# at 8 than at 16 and 3 % more at 32; a raw fleet tick (13-22 boxes) the
# same at 8 and 16, 8 % more at 32; a size's first tick cost no more
# than later ones (PERF.md, PR 20).
ROW_BUCKET = 8


def _valid_rows(nbs, K: int) -> Tuple[np.ndarray, int]:
    """(rows, M) for a step over k = len(nbs) frames with K box slots
    each: the flat cube rows j*K + b, b < nbs[j], in frame-major order
    (M of them), padded to min(ceil(M / ROW_BUCKET) * ROW_BUCKET, k*K)
    rows by repeating the first; none when M is 0."""
    nbs = np.asarray(nbs, np.int64).reshape(-1)
    b = np.arange(K)
    rows = (np.arange(nbs.size)[:, None] * K + b)[b < nbs[:, None]]
    m = rows.size
    size = min(-(-m // ROW_BUCKET) * ROW_BUCKET, nbs.size * K)
    return np.concatenate([rows, np.repeat(rows[:1], size - m)]), m


def _predict_window(pos: int, ctx: int) -> np.ndarray:
    """The 'predict' border-mode context window for frame `pos` of a video,
    in within-video coordinates: [start]*pad + [start..pos]
    (vad_datasets.py:287-293; matches data.video_index.context_indices)."""
    T = ctx + 1
    start = max(pos - ctx, 0)
    pad = T - (pos - start + 1)
    t = np.arange(T, dtype=np.int64)
    return start + np.maximum(t - pad, 0)


def _upload(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device` without waiting for the device: on the
    card through a pinned staging copy and a non-blocking transfer (a
    pageable one would synchronise the stream, so a pipelined scorer
    would wait for every queued step at its next upload)."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _download_async(out: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.cuda.Event]]:
    """Start `out`'s copy to the host now, behind the step that made it:
    (host, event), `host` a pinned tensor the copy lands in and `event`
    recorded after it on the stream. On the CPU the copy is a plain one
    and there is no event."""
    if out.device.type != "cuda":
        return out.clone(), None
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _host_result(handle) -> np.ndarray:
    """The host array of a _download_async handle (a row of one is a
    (host[j], event) pair): waits on its event only, not on the steps
    queued after it."""
    host, event = handle
    if event is not None:
        with annotate("serve.wait"):
            event.synchronize()
    return host.numpy()


def _time_device_chain(scorer, step, k: int, repeats: int) -> float:
    """Best-of-`repeats` ms per execution of `step`, the protocol every
    scorer's time_device_step/tick shares. `step()` runs one serving
    step on arguments already staged on the device, reading the scorer's
    rings; a warm call runs first, then each repeat chains k steps.

    On the card the chain lies between two CUDA events on the current
    stream, so the time is the stream's from the first step's start to
    the last step's end (a step whose launches take longer on the host
    than its kernels on the device is timed at the host's pace). On the
    CPU the host clock brackets the same chain.

    The chain runs on clones of the rings, swapped in for its duration
    and swapped back in a `finally`: the scorer's serving state (rings,
    frame counters, pending results) is as it was, so a probe can run
    mid-video."""
    reps = getattr(scorer, "_replicas", [scorer])
    rings = [(r._ring, r._flow_ring) for r in reps]
    for r, (ring, flow_ring) in zip(reps, rings):
        r._ring, r._flow_ring = ring.clone(), flow_ring.clone()
    try:
        step()  # warm
        cuda = scorer._ring.device.type == "cuda"
        best = float("inf")
        for _ in range(repeats):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(k):
                    step()
                end.record()
                end.synchronize()
                ms = start.elapsed_time(end) / k
            else:
                t0 = time.perf_counter()
                for _ in range(k):
                    step()
                ms = (time.perf_counter() - t0) * 1e3 / k
            best = min(best, ms)
        return best
    finally:
        for r, (ring, flow_ring) in zip(reps, rings):
            r._ring, r._flow_ring = ring, flow_ring


def _fleet_arity(n_cameras, mesh) -> Tuple[int, int]:
    """Validated (C, n_shards) for a camera fleet over an optional mesh
    (parallel.mesh.Mesh or a list of devices)."""
    C = int(n_cameras)
    if C < 1:
        raise ValueError("n_cameras must be >= 1")
    n = as_mesh(mesh).size if mesh is not None else 1
    if n > 1 and C % n:
        raise ValueError(
            f"n_cameras={C} must divide evenly over the {n}-device mesh"
        )
    return C, n


def _fleet_device(mesh, kw: dict) -> None:
    """A fleet on a mesh lives on the mesh's first entry: `device` in the
    scorer's keywords set to it (or checked against it when given)."""
    if mesh is None:
        return
    first = as_mesh(mesh).devices[0]
    if "device" in kw and resolve_device(kw["device"]) != first:
        raise ValueError(f"device={kw['device']!r} is not the mesh's first "
                         f"entry {first}")
    kw["device"] = first


def _fleet_replicas(scorer, mesh, make) -> list:
    """The scorers of a fleet's mesh entries, in mesh order: `scorer`
    itself for the first, and for each other entry `make(device)`, a
    fleet of the entry's C / n cameras with its own rings and its own
    replica of the weights on that device (no mesh: [scorer])."""
    if mesh is None:
        return [scorer]
    return [scorer] + [make(d) for d in as_mesh(mesh).devices[1:]]


def _alloc_camera_rings(C: int, rlen: int, h: int, w: int, of_shape,
                        device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fleet rings: frames (C, rlen, h, w, 3) uint8 and flow `of_shape`
    float32, zeroed on `device`."""
    return (torch.zeros((C, rlen, h, w, 3), dtype=torch.uint8, device=device),
            torch.zeros(of_shape, dtype=torch.float32, device=device))
