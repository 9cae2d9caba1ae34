"""Operation and byte counts from published layer shapes, and the card's
published peaks: the yardstick that `mfu.*` and `k1_roofline_pct.*` divide
by. Nothing here reads the program's modules, so a change to how the port
computes a layer never changes what the layer is counted as.

Counting rules:
  * 2 FLOPs a multiply-add;
  * a convolution counts every tap it computes, the zero padding's too:
    2 * C_in * C_out * k * k * H_out * W_out (grouped ensembles count each
    member's own channels only);
  * a transposed convolution scatters every input pixel over its k * k
    taps: 2 * C_in * C_out * k * k * H_in * W_in;
  * BatchNorm, activations, pooling, resizes, warps and the ensemble's
    reductions are left out;
  * FlowNetC's cost volume counts the (y, dy) and (x, dx) pairs that fall
    inside the frame (out-of-frame displacements are zero by definition),
    2 * B * rows * cols * C.

Sources: VEC_VAD model/unet.py (SelfCompleteNet4, the UNet members at nf
channels 1x, 2x, 4x, 8x), FlowNet2_src/models/components (FlowNetC,
FlowNetS, FlowNetSD, FlowNetFusion; Ilg et al., CVPR 2017).
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
PEAK_BYTES_S = 3.35e12


def conv_flops(cin: int, cout: int, k: int, h_out: int, w_out: int) -> float:
    return 2.0 * cin * cout * k * k * h_out * w_out


def convt_flops(cin: int, cout: int, k: int, h_in: int, w_in: int) -> float:
    return 2.0 * cin * cout * k * k * h_in * w_in


# -- the completion ensemble ---------------------------------------------


def unet_member_flops(in_ch: int, out_ch: int, nf: int, patch: int) -> float:
    """One UNet member's forward on one cube: inconv and three down
    stages (double 3x3 convs at nf, 2nf, 4nf, 8nf channels, each stage at
    half the previous resolution), three up stages (3x3 stride-2
    transposed conv to the skip's resolution, concat, double conv), and
    a 1x1 output conv."""
    f = [nf, 2 * nf, 4 * nf, 8 * nf]
    s = [patch // (2 ** i) for i in range(4)]
    total = 0.0
    cin = in_ch
    for c, r in zip(f, s):  # down path
        total += conv_flops(cin, c, 3, r, r) + conv_flops(c, c, 3, r, r)
        cin = c
    for i in (2, 1, 0):  # up path: from f[i+1] at s[i+1] to f[i] at s[i]
        total += convt_flops(f[i + 1], f[i], 3, s[i + 1], s[i + 1])
        total += conv_flops(2 * f[i], f[i], 3, s[i], s[i])
        total += conv_flops(f[i], f[i], 3, s[i], s[i])
    total += conv_flops(nf, out_ch, 1, patch, patch)
    return total


def ensemble_members(model: dict) -> Tuple[int, int, int]:
    """(raw members, flow members, input channels of a member) of a
    SelfCompleteNet ensemble in 'predict' border mode with channel-drop
    erasure: one raw member an erased position, one flow member where the
    flow head fires (the newest position, one flow slot for
    context_of_num 0)."""
    t = int(model["context_frame_num"]) + 1
    raw = t
    flow = 1 if model["use_flow"] and int(model["context_of_num"]) == 0 else 0
    if model["use_flow"] and int(model["context_of_num"]) != 0:
        flow = int(model["context_of_num"]) + 1
    return raw, flow, 3 * (t - 1)


def cube_fwd_flops(model: dict, patch: int) -> float:
    """Forward FLOPs of one cube through the whole ensemble."""
    raw, flow, cin = ensemble_members(model)
    nf = int(model["nf"])
    return (raw * unet_member_flops(cin, 3, nf, patch)
            + flow * unet_member_flops(cin, 2, nf, patch))


# -- FlowNet2 --------------------------------------------------------------


def _pyramid_decoder(c6: int, c5: int, c4: int, c3: int, c2: int,
                     h6: int, w6: int, inter: bool) -> float:
    """FlowNetC/S/SD's decoder from conv6 (at h6 x w6) to flow2: per level
    a flow head, a 4x4 stride-2 deconv of the features and one of the
    flow, concatenated with the skip; FlowNetSD puts a 3x3 conv (to 512,
    256, 128, 64) before each head below flow6."""
    total = conv_flops(c6, 2, 3, h6, w6)  # predict_flow6
    feat_in, skips = c6, (c5, c4, c3, c2)
    outs = (512, 256, 128, 64)
    h, w = h6, w6
    for skip, out in zip(skips, outs):
        total += convt_flops(feat_in, out, 4, h, w)  # deconv
        total += convt_flops(2, 2, 4, h, w)  # upsampled flow
        h, w = 2 * h, 2 * w
        cat = skip + out + 2
        if inter:
            total += conv_flops(cat, out, 3, h, w) + conv_flops(out, 2, 3, h, w)
        else:
            total += conv_flops(cat, 2, 3, h, w)
        feat_in = cat
    return total


def _encoder(layers: Iterable[Tuple[int, int, int, int]], h: int, w: int):
    """FLOPs and output size of a chain of (cin, cout, k, stride) convs."""
    total = 0.0
    for cin, cout, k, stride in layers:
        h, w = h // stride, w // stride
        total += conv_flops(cin, cout, k, h, w)
    return total, h, w


_S_TAIL = [(256, 512, 3, 2), (512, 512, 3, 1), (512, 512, 3, 2),
           (512, 512, 3, 1), (512, 1024, 3, 2), (1024, 1024, 3, 1)]


def flownet_c_flops(h: int, w: int, max_disp: int = 20, stride: int = 2) -> float:
    """FlowNetC on one pair at h x w (both images through conv1-3)."""
    head = [(3, 64, 7, 2), (64, 128, 5, 2), (128, 256, 5, 2)]
    f_head, h3, w3 = _encoder(head, h, w)
    total = 2 * f_head
    total += conv_flops(256, 32, 1, h3, w3)  # conv_redir
    total += correlation_flops((1, h3, w3, 256), max_disp, stride)
    d = 2 * max_disp // stride + 1
    total += conv_flops(32 + d * d, 256, 3, h3, w3)  # conv3_1
    f_tail, h6, w6 = _encoder(_S_TAIL, h3, w3)
    total += f_tail
    return total + _pyramid_decoder(1024, 512, 512, 256, 128, h6, w6, False)


def flownet_s_flops(h: int, w: int, in_ch: int = 12) -> float:
    layers = [(in_ch, 64, 7, 2), (64, 128, 5, 2), (128, 256, 5, 2),
              (256, 256, 3, 1)] + _S_TAIL
    total, h6, w6 = _encoder(layers, h, w)
    return total + _pyramid_decoder(1024, 512, 512, 256, 128, h6, w6, False)


def flownet_sd_flops(h: int, w: int) -> float:
    layers = [(6, 64, 3, 1), (64, 64, 3, 2), (64, 128, 3, 1), (128, 128, 3, 2),
              (128, 128, 3, 1), (128, 256, 3, 2), (256, 256, 3, 1)] + _S_TAIL
    total, h6, w6 = _encoder(layers, h, w)
    return total + _pyramid_decoder(1024, 512, 512, 256, 128, h6, w6, True)


def flownet_fusion_flops(h: int, w: int) -> float:
    layers = [(11, 64, 3, 1), (64, 64, 3, 2), (64, 128, 3, 1), (128, 128, 3, 2),
              (128, 128, 3, 1)]
    total, h2, w2 = _encoder(layers, h, w)
    total += conv_flops(128, 2, 3, h2, w2)  # predict_flow2
    total += convt_flops(128, 32, 4, h2, w2) + convt_flops(2, 2, 4, h2, w2)
    h1, w1 = 2 * h2, 2 * w2
    total += conv_flops(128 + 32 + 2, 32, 3, h1, w1) + conv_flops(32, 2, 3, h1, w1)
    total += convt_flops(162, 16, 4, h1, w1) + convt_flops(2, 2, 4, h1, w1)
    h0, w0 = 2 * h1, 2 * w1
    total += conv_flops(64 + 16 + 2, 16, 3, h0, w0) + conv_flops(16, 2, 3, h0, w0)
    return total


def flownet2_pair_flops(h: int = 384, w: int = 512) -> float:
    """FlowNet2's forward on one frame pair at its h x w protocol:
    FlowNetC, two FlowNetS (12 input channels), FlowNetSD and the
    fusion net."""
    return (flownet_c_flops(h, w) + 2 * flownet_s_flops(h, w)
            + flownet_sd_flops(h, w) + flownet_fusion_flops(h, w))


# -- the cost volume (K1) ------------------------------------------------------


def _in_frame_pairs(n: int, max_disp: int, stride: int) -> int:
    d = np.arange(-max_disp, max_disp + 1, stride)
    return int(np.clip(n - np.abs(d), 0, None).sum())


def correlation_flops(shape, max_disp: int = 20, stride: int = 2) -> float:
    B, H, W, C = shape
    return (2.0 * B * _in_frame_pairs(H, max_disp, stride)
            * _in_frame_pairs(W, max_disp, stride) * C)


def correlation_bytes(shape, elem: int = 4, max_disp: int = 20,
                      stride: int = 2) -> float:
    """Each input read once and the cost volume written once."""
    B, H, W, C = shape
    d = 2 * max_disp // stride + 1
    return float(elem * B * H * W * (2 * C + d * d))


def correlation_bound_s(shape, dtype: str = "float32", max_disp: int = 20,
                        stride: int = 2) -> Tuple[float, str]:
    """Least time for one cost volume on this card: the larger of its
    multiply-adds over the peak rate and its bytes over the memory rate.
    Returns (seconds, 'operations' | 'bytes')."""
    elem = 2 if dtype == "bfloat16" else 4
    t_ops = correlation_flops(shape, max_disp, stride) / PEAK_FLOPS[dtype]
    t_bytes = correlation_bytes(shape, elem, max_disp, stride) / PEAK_BYTES_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def flownet_c_corr_shape(batch: int, h: int = 384, w: int = 512):
    """FlowNetC's conv3 features at h x w: (B, h/8, w/8, 256)."""
    return (batch, h // 8, w // 8, 256)


# -- work counted in a window ---------------------------------------------------


def work_flops(work: dict, model: dict, patch: int, flow_hw=(384, 512)) -> float:
    """Model FLOPs of a window's recorded work. Keys of `work`:
      valid_cubes   cubes scored by an eval forward (serving, test);
      flow_pairs    FlowNet2 forwards a pair;
      train_cubes   cubes through a training step (forward + backward,
                    counted 3x the forward), unpadded rows only;
      score_cubes   cubes through the training-score pass."""
    fwd = cube_fwd_flops(model, patch)
    total = fwd * (work.get("valid_cubes", 0) + work.get("score_cubes", 0))
    total += 3.0 * fwd * work.get("train_cubes", 0)
    if work.get("flow_pairs"):
        total += work["flow_pairs"] * flownet2_pair_flops(*flow_hw)
    return total
