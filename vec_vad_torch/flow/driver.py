"""Optical-flow precomputation driver (vec_vad_tpu/flow/driver.py).

Replicates calc_optical_flow.py:25-85, batched on the card:
  * frame pairs come from ctx=1 'hard' context windows; at a video's FIRST
    frame the boundary branch picks window positions (0, 1) of the
    duplicated window [0, 0, 1] — the pair (f0, f0), i.e. intentional ZERO
    flow; the last frame pairs (N-2, N-1); mid-video frame t pairs
    (t, t+1) (calc_optical_flow.py:43-76, an intentional reference quirk)
  * both frames resize to 512x384 (cv2 bilinear), grayscale replicates to
    3 channels, FlowNet2 runs, and the flow resizes back to the original
    (w, h) WITHOUT magnitude rescaling (the reference's quirk)

Frames go to the device as uint8 and become float32 there, in the resize.
Pairs run through the flow net in batches of `chunk`; a split's last
batch (and a segment's) runs at its own size, unpadded, since every pair's
flow is computed independently of the others in its batch.

On a mesh of more than one entry (`mesh=`, the resident and segmented
routes, as in vec_vad_tpu) the pair axis is cut into one contiguous share
an entry, JAX's (n_dev, steps, chunk) layout, and each entry runs its
share in batches of `chunk` on a FlowNet2 replica of its own
(parallel.mesh.replicate); the replicas never talk, and the maps equal
the one-device route's. JAX pads the pairs to a multiple of
chunk * entries; here the padding is not run (a share's last batch runs
at its own size).
"""

from __future__ import annotations

import copy
import os
from typing import Iterator, Tuple

import numpy as np
import torch
import torch.nn as nn

from vec_vad_torch.data.video_index import VideoIndex
from vec_vad_torch.device import resolve_device
from vec_vad_torch.ops.stc import _interp_matrix
from vec_vad_torch.parallel.mesh import as_mesh, replicate


def resize_bilinear(frames: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """cv2.resize-parity bilinear resize of a full (B, H, W, C) stack,
    returned as float32."""
    B, H, W, C = frames.shape
    dev = frames.device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    my = _interp_matrix(zero, zero + H, H, out_h)
    mx = _interp_matrix(zero, zero + W, W, out_w)
    rows = torch.einsum("ph,bhwc->bpwc", my, frames.float())
    return torch.einsum("bpwc,qw->bpqc", rows, mx)


def cast_flow_net(net: nn.Module, compute_dtype) -> nn.Module:
    """`net` itself for float32; otherwise a copy with its float weights
    cast to `compute_dtype` once (halves weight residency for bf16). A
    copy, so scorers sharing one net keep their own precision."""
    if compute_dtype == torch.float32:
        return net
    return copy.deepcopy(net).to(compute_dtype)


def flow_pair_indices(index: VideoIndex) -> Tuple[np.ndarray, np.ndarray]:
    """Per-frame (first, second) source-frame indices for the flow pair,
    following the reference's boundary rule (calc_optical_flow.py:43-76)."""
    win = index.context_indices(1, "hard")  # (N, 3)
    boundary = (win[:, 1] == win[:, 0]) | (win[:, 1] == win[:, 2])
    first = np.where(boundary, win[:, 0], win[:, 1])
    second = np.where(boundary, win[:, 1], win[:, 2])
    return first, second


def _flow_batch(net, f1, f2, model_hw, compute_dtype) -> torch.Tensor:
    """One batch of the flow program: (B, H, W, C) uint8 pairs -> (B, H,
    W, 2) float32 flow at the original size (resize to model_hw, gray ->
    3-channel replicate, the net in compute_dtype, resize back WITHOUT
    magnitude rescaling — calc_optical_flow.py:59,82). The resizes stay
    float32 for cv2 parity of the frame resample."""
    H, W, C = f1.shape[1:]
    mh, mw = model_hw
    r1, r2 = resize_bilinear(f1, mh, mw), resize_bilinear(f2, mh, mw)
    if C == 1:
        r1, r2 = r1.expand(-1, -1, -1, 3), r2.expand(-1, -1, -1, 3)
    pair = torch.stack([r1, r2], dim=1).to(compute_dtype)  # (B, 2, mh, mw, 3)
    return resize_bilinear(net(pair), H, W)


def _run_pairs(net, frames, first, second, chunk, model_hw,
               compute_dtype) -> Iterator[Tuple[int, int, torch.Tensor]]:
    """Flow of every pair (frames[first[k]], frames[second[k]]) on the
    device, `chunk` pairs a batch; yields (lo, hi, flow[lo:hi]). The
    indices are clamped into the frame stack, as the JAX driver's
    `jnp.take(mode="clip")` gathers clamp them."""
    last = frames.shape[0] - 1
    i1 = torch.from_numpy(np.asarray(first, np.int64)).to(frames.device).clamp_(0, last)
    i2 = torch.from_numpy(np.asarray(second, np.int64)).to(frames.device).clamp_(0, last)
    for lo in range(0, i1.numel(), chunk):
        hi = min(lo + chunk, i1.numel())
        yield lo, hi, _flow_batch(
            net, frames.index_select(0, i1[lo:hi]),
            frames.index_select(0, i2[lo:hi]), model_hw, compute_dtype)


def _run_pairs_mesh(nets, frames, first, second, chunk, model_hw,
                    compute_dtype) -> Iterator[Tuple[int, int, torch.Tensor]]:
    """The pairs over a mesh: nets and frames one an entry (frames on the
    entry's device), entry d's share the pairs [d * per, (d + 1) * per)
    with per = ceil(n / entries) rounded up to a multiple of chunk; step s
    runs batch s of every share, in mesh order, so distinct cards overlap.
    Yields (lo, hi, flow[lo:hi]), the flow on its entry's device."""
    n = len(first)
    per = -(-n // len(nets))
    per = -(-per // chunk) * chunk
    idx = [(torch.from_numpy(np.asarray(first, np.int64)).to(f.device)
            .clamp_(0, f.shape[0] - 1),
            torch.from_numpy(np.asarray(second, np.int64)).to(f.device)
            .clamp_(0, f.shape[0] - 1)) for f in frames]
    for s in range(0, per, chunk):
        for d, (net, fr, (i1, i2)) in enumerate(zip(nets, frames, idx)):
            lo = d * per + s
            hi = min(lo + chunk, (d + 1) * per, n)
            if lo < hi:
                yield lo, hi, _flow_batch(
                    net, fr.index_select(0, i1[lo:hi]),
                    fr.index_select(0, i2[lo:hi]), model_hw, compute_dtype)


def _mesh_replicas(net, dev, mesh):
    """One flow net an entry of `mesh` (None: no mesh), the first `net`
    itself, which must live on the first entry's device; None for a mesh
    of one entry."""
    if mesh is None:
        return None
    mesh = as_mesh(mesh)
    if mesh.devices[0] != dev:
        raise ValueError(f"the mesh starts at {mesh.devices[0]}, the flow net "
                         f"lives on {dev}")
    return replicate(net, mesh) if mesh.size > 1 else None


def _mesh_frames(frames, nets) -> list:
    """The frame stack on every entry's device (one upload a device)."""
    per_dev = {}
    for net in nets:
        dev = next(net.parameters()).device
        if dev not in per_dev:
            per_dev[dev] = _to_device(frames, dev)
    return [per_dev[next(net.parameters()).device] for net in nets]


def _prepare(net, compute_dtype, device) -> Tuple[nn.Module, torch.device]:
    """The device (the card unless asked for the CPU) and the net in
    compute_dtype, in eval mode, checked to live on that device."""
    dev = resolve_device(device)
    for p in net.parameters():
        if p.device != dev:
            raise ValueError(f"the flow net lives on {p.device}, not on {dev}")
    return cast_flow_net(net, compute_dtype).eval(), dev


def _to_device(frames, dev) -> torch.Tensor:
    """Upload a (N, H, W[, C]) frame stack as it is (uint8 frames stay
    uint8), as (N, H, W, C)."""
    x = torch.from_numpy(np.ascontiguousarray(frames)).to(dev)
    return x[..., None] if x.dim() == 3 else x


@torch.inference_mode()
def compute_optical_flow(
    net: nn.Module,
    index: VideoIndex,
    frames: np.ndarray,
    chunk: int = 4,
    model_hw: Tuple[int, int] = (384, 512),
    resident: bool = False,
    compute_dtype=torch.float32,
    device="cuda",
    mesh=None,
) -> np.ndarray:
    """Dense flow for every frame of a split: (N, H, W, 2) float32.

    `net` maps (B, 2, mh, mw, 3) frame pairs in 0..255 to (B, mh, mw, 2)
    flow (models.flownet.FlowNet2) and lives on `device`. The split's
    frames are uploaded once as they are (uint8). resident=True keeps the
    whole split's flow on the device and downloads it once; otherwise
    each batch's flow is downloaded as it is made.

    compute_dtype=torch.bfloat16 runs the net on a bf16 copy of its
    weights; the output stays float32 and shifts by bf16 rounding.

    mesh (resident route only, as in vec_vad_tpu): a parallel.mesh.Mesh
    (or a list of devices) starting at `device`; with more than one entry
    the pairs run over the entries' replicas (module docstring), the
    flow gathered on `device`."""
    net, dev = _prepare(net, compute_dtype, device)
    n, H, W = frames.shape[:3]
    first, second = flow_pair_indices(index)
    nets = _mesh_replicas(net, dev, mesh) if resident else None
    if nets is not None:
        batches = _run_pairs_mesh(nets, _mesh_frames(frames, nets), first,
                                  second, chunk, model_hw, compute_dtype)
    else:
        batches = _run_pairs(net, _to_device(frames, dev), first, second,
                             chunk, model_hw, compute_dtype)
    if resident:
        flow = torch.empty((n, H, W, 2), dtype=torch.float32, device=dev)
        for lo, hi, f in batches:
            flow[lo:hi] = f
        return flow.cpu().numpy()
    out = np.empty((n, H, W, 2), np.float32)
    for lo, hi, f in batches:
        out[lo:hi] = f.cpu().numpy()
    return out


@torch.inference_mode()
def compute_optical_flow_segmented(
    net: nn.Module,
    index: VideoIndex,
    frames,
    write,
    segment_frames: int = 512,
    chunk: int = 4,
    model_hw: Tuple[int, int] = (384, 512),
    compute_dtype=torch.float32,
    device="cuda",
    mesh=None,
) -> int:
    """Memory-bounded flow precomputation for splits beyond device or host
    memory. The reference streams one frame at a time and writes each
    .npy immediately (calc_optical_flow.py:25-85); here, per segment of
    `segment_frames` frames (rounded up to a multiple of `chunk`):

      * decode ONLY that segment (+1 neighbour frame each side for the
        pair rule) from the lazy stack,
      * one upload, the segment's batches on the device, one download,
      * `write(i, flow_i)` for each of its frames, in order.

    `frames` is any array-like supporting `.shape` and `[lo:hi]`
    (data.readers.LazyFrameStack decodes on slice). Returns the number of
    frames written.

    mesh: as compute_optical_flow's; each segment's pairs run over the
    entries' replicas, the segment rounded up to a multiple of chunk *
    entries."""
    net, dev = _prepare(net, compute_dtype, device)
    n = index.total_frames
    first, second = flow_pair_indices(index)
    nets = _mesh_replicas(net, dev, mesh)
    group = chunk * (len(nets) if nets is not None else 1)
    S = -(-segment_frames // group) * group

    for lo in range(0, n, S):
        hi = min(lo + S, n)
        # pairs for frames [lo, hi) touch source frames [lo-1, hi]
        # (first frame of a video pairs (t, t), last pairs (t-1, t))
        w0, w1 = max(lo - 1, 0), min(hi + 1, n)
        host = np.asarray(frames[w0:w1])
        if nets is not None:
            wins = _mesh_frames(host, nets)
            batches = _run_pairs_mesh(nets, wins, first[lo:hi] - w0,
                                      second[lo:hi] - w0, chunk, model_hw,
                                      compute_dtype)
        else:
            wins = [_to_device(host, dev)]
            batches = _run_pairs(net, wins[0], first[lo:hi] - w0,
                                 second[lo:hi] - w0, chunk, model_hw,
                                 compute_dtype)
        flow = torch.empty((hi - lo,) + tuple(wins[0].shape[1:3]) + (2,),
                           dtype=torch.float32, device=dev)
        for a, b, f in batches:
            flow[a:b] = f
        flow = flow.cpu().numpy()
        for k in range(hi - lo):
            write(lo + k, flow[k])
    return n


def flow_tree_writer(index: VideoIndex, of_root: str, dataset_rel: str):
    """Per-frame writer of flow .npy files mirroring the dataset tree
    (calc_optical_flow.py:30-38 layout, for interop with reference
    artifacts). Returns write(i, flow_i)."""
    assert index.frame_paths is not None
    n_root = len(os.path.normpath(dataset_rel).split(os.sep))

    def write(i: int, flow_i: np.ndarray) -> None:
        parts = os.path.normpath(index.frame_paths[i]).split(os.sep)
        rel = parts[-3:] if n_root == 0 else parts[n_root:]
        stem = os.path.splitext(rel[-1])[0]
        d = os.path.join(of_root, *rel[:-1])
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, stem + ".npy"), flow_i)

    return write


def save_flow_tree(
    flow: np.ndarray, index: VideoIndex, of_root: str, dataset_rel: str
) -> None:
    """Persist a fully-materialized flow stack via flow_tree_writer."""
    write = flow_tree_writer(index, of_root, dataset_rel)
    for i in range(flow.shape[0]):
        write(i, flow[i])
