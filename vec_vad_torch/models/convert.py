"""Carry weights between the JAX package's layout and the port's.

The *_from_jax converters take the JAX package's parameters as numpy
arrays (flax trees, as `vec_vad_tpu.runtime.artifacts` saves them) and
return a torch state dict for the port's module:

  * completion_from_jax — the flax `raw_unets`/`of_unets` trees (leading
    member axis E) -> SelfCompletionNet. Conv kernels (E, kh, kw, I, O)
    -> grouped (E*O, I, kh, kw); ConvTranspose2x kernels (E, kh, kw, I, O)
    -> grouped (E*I, O, kh, kw) WITHOUT a flip, because the JAX layer flips
    inside its forward (vec_vad_tpu/models/layers.py:90-97) where torch's
    conv_transpose2d does the same implicitly.
  * completion_to_jax — the inverse of completion_from_jax, for saving a
    model the port trained in the JAX package's .npz layout.
  * flownet2_from_jax — the FlowNet2 tree -> FlowNet2, the inverse of
    vec_vad_tpu/models/flownet/convert.py:31-36 (HWIO -> OIHW for convs,
    (kh, kw, I, O) -> (I, O, kh, kw) for transposed convs).
  * centernet_from_jax / cascade_from_jax — the trainable detectors'
    flax params -> fore.centernet_detector.CenterNetLite /
    fore.cascade_detector.CascadeFPNNet: HWIO -> OIHW, Dense (in, out) ->
    (out, in); CenterNetLite's ConvTranspose kernel flipped in both
    spatial axes (flax's transpose_kernel=False) to (I, O, kh, kw), and
    each RefineHead's first Dense rows from flax's (S, S, C) flatten order
    to torch's (C, S, S). The mmdet detector needs no carry function: both
    packages load the same mmdet-named checkpoint.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C"))  # own copy


def _group_conv(k) -> torch.Tensor:
    k = np.asarray(k)
    E, kh, kw, i, o = k.shape
    return _t(k.transpose(0, 4, 3, 1, 2).reshape(E * o, i, kh, kw))


def _group_conv_t(k) -> torch.Tensor:
    k = np.asarray(k)
    E, kh, kw, i, o = k.shape
    return _t(k.transpose(0, 3, 4, 1, 2).reshape(E * i, o, kh, kw))


def _flat(v) -> torch.Tensor:
    return _t(np.asarray(v).reshape(-1))


def _unet_from_jax(p: Dict[str, Any], s: Dict[str, Any], prefix: str):
    sd = {}
    # flax auto-names: DoubleConv_0..3 descend, DoubleConv_4..6 ascend
    names = [f"down.{i}" for i in range(4)] + [f"up.{i}" for i in range(3)]
    for i, name in enumerate(names):
        dp, ds = p[f"DoubleConv_{i}"], s[f"DoubleConv_{i}"]
        for j in (0, 1):
            conv, bn, st = dp[f"Conv_{j}"], dp[f"BatchNorm_{j}"], ds[f"BatchNorm_{j}"]
            m = f"{prefix}.{name}"
            sd[f"{m}.conv{j}.weight"] = _group_conv(conv["kernel"])
            sd[f"{m}.conv{j}.bias"] = _flat(conv["bias"])
            sd[f"{m}.bn{j}.weight"] = _flat(bn["scale"])
            sd[f"{m}.bn{j}.bias"] = _flat(bn["bias"])
            sd[f"{m}.bn{j}.running_mean"] = _flat(st["mean"])
            sd[f"{m}.bn{j}.running_var"] = _flat(st["var"])
    for i in range(3):
        ct = p[f"ConvTranspose2x_{i}"]
        sd[f"{prefix}.up_t.{i}.weight"] = _group_conv_t(ct["kernel"])
        sd[f"{prefix}.up_t.{i}.bias"] = _flat(ct["bias"])
    sd[f"{prefix}.out.weight"] = _group_conv(p["out_kernel"])
    sd[f"{prefix}.out.bias"] = _flat(p["out_bias"])
    return sd


def completion_from_jax(params: Dict[str, Any],
                        batch_stats: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict for models.completion.SelfCompletionNet."""
    sd = {}
    for ens in ("raw_unets", "of_unets"):
        if ens in params:
            sd.update(_unet_from_jax(params[ens], batch_stats[ens], ens))
    return sd


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32, copy=True)


def _unet_to_jax(sd: Dict[str, torch.Tensor], prefix: str):
    """The inverse of _unet_from_jax: one ensemble's (params, batch_stats)
    trees, every leaf with its leading member axis E."""
    w1 = sd[f"{prefix}.down.0.conv1.weight"]  # (E*f, f, 3, 3)
    E = w1.shape[0] // w1.shape[1]

    def conv(w):  # (E*O, I, kh, kw) -> (E, kh, kw, I, O)
        eo, i, kh, kw = w.shape
        return _np(w).reshape(E, eo // E, i, kh, kw).transpose(0, 3, 4, 2, 1)

    def conv_t(w):  # (E*I, O, kh, kw) -> (E, kh, kw, I, O)
        ei, o, kh, kw = w.shape
        return _np(w).reshape(E, ei // E, o, kh, kw).transpose(0, 3, 4, 1, 2)

    def per_member(v):  # (E*F,) -> (E, F)
        return _np(v).reshape(E, -1)

    params, stats = {}, {}
    names = [f"down.{i}" for i in range(4)] + [f"up.{i}" for i in range(3)]
    for i, name in enumerate(names):
        m = f"{prefix}.{name}"
        dp, ds = {}, {}
        for j in (0, 1):
            dp[f"Conv_{j}"] = {"kernel": conv(sd[f"{m}.conv{j}.weight"]),
                               "bias": per_member(sd[f"{m}.conv{j}.bias"])}
            dp[f"BatchNorm_{j}"] = {"scale": per_member(sd[f"{m}.bn{j}.weight"]),
                                    "bias": per_member(sd[f"{m}.bn{j}.bias"])}
            ds[f"BatchNorm_{j}"] = {"mean": per_member(sd[f"{m}.bn{j}.running_mean"]),
                                    "var": per_member(sd[f"{m}.bn{j}.running_var"])}
        params[f"DoubleConv_{i}"], stats[f"DoubleConv_{i}"] = dp, ds
    for i in range(3):
        params[f"ConvTranspose2x_{i}"] = {
            "kernel": conv_t(sd[f"{prefix}.up_t.{i}.weight"]),
            "bias": per_member(sd[f"{prefix}.up_t.{i}.bias"]),
        }
    params["out_kernel"] = conv(sd[f"{prefix}.out.weight"])
    params["out_bias"] = per_member(sd[f"{prefix}.out.bias"])
    return params, stats


def completion_to_jax(state_dict: Dict[str, torch.Tensor]):
    """(params, batch_stats) numpy trees in the JAX package's layout for a
    SelfCompletionNet state dict: the inverse of completion_from_jax, bit
    for bit (reshapes and transposes only)."""
    params, stats = {}, {}
    for ens in ("raw_unets", "of_unets"):
        if f"{ens}.out.weight" in state_dict:
            params[ens], stats[ens] = _unet_to_jax(state_dict, ens)
    return params, stats


def flownet2_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict for models.flownet.FlowNet2 (or any of its component
    nets, given that net's own variables). A with_bn net's BatchNorms take
    params/.../bn/{scale, bias} and batch_stats/.../bn/{mean, var}; their
    num_batches_tracked is 0 (the JAX package counts no batches)."""
    sd = {}

    def visit(tree, path):
        if path and path[-1] == "bn":
            name = ".".join(path)
            sd[f"{name}.weight"] = _t(tree["scale"])
            sd[f"{name}.bias"] = _t(tree["bias"])
            stats = variables["batch_stats"]
            for key in path:
                stats = stats[key]
            sd[f"{name}.running_mean"] = _t(stats["mean"])
            sd[f"{name}.running_var"] = _t(stats["var"])
            sd[f"{name}.num_batches_tracked"] = torch.tensor(0)
            return
        if "kernel" in tree:
            transposed = path[-1].startswith("upsampled_flow") or (
                path[-1] == "conv" and path[-2].startswith("deconv")
            )
            k = np.asarray(tree["kernel"])
            perm = (2, 3, 0, 1) if transposed else (3, 2, 0, 1)
            sd[".".join(path + ["weight"])] = _t(k.transpose(perm))
            if "bias" in tree:
                sd[".".join(path + ["bias"])] = _t(tree["bias"])
            return
        for key, sub in tree.items():
            visit(sub, path + [key])

    visit(variables["params"], [])
    return sd


def _conv(tree) -> Dict[str, torch.Tensor]:
    out = {"weight": _t(np.asarray(tree["kernel"]).transpose(3, 2, 0, 1))}
    if "bias" in tree:
        out["bias"] = _t(tree["bias"])
    return out


def _dense(tree, rows=None) -> Dict[str, torch.Tensor]:
    k = np.asarray(tree["kernel"])
    if rows is not None:
        k = k[rows]
    return {"weight": _t(k.T), "bias": _t(tree["bias"])}


def _put(sd, name, parts):
    for key, v in parts.items():
        sd[f"{name}.{key}"] = v


def centernet_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict for fore.centernet_detector.CenterNetLite from the flax
    CenterNetLite's params (vec_vad_tpu/fore/jax_detector.py)."""
    sd = {}
    names = ["conv1", "conv2", "conv3", "conv4", "feat", "heat", "size", "offset"]
    for i, name in enumerate(names):
        _put(sd, name, _conv(params[f"Conv_{i}"]))
    ct = params["ConvTranspose_0"]
    k = np.asarray(ct["kernel"])[::-1, ::-1]  # (kh, kw, I, O), flipped
    sd["up.weight"] = _t(k.transpose(2, 3, 0, 1))
    sd["up.bias"] = _t(ct["bias"])
    return sd


def cascade_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict for fore.cascade_detector.CascadeFPNNet from the flax
    CascadeFPNNet's variables (vec_vad_tpu/fore/cascade_detector.py)."""
    p = variables["params"]
    sd = {}
    bb = p["backbone"]
    for b in range(5):  # each block's two convs: flax Conv_{2b}, Conv_{2b+1}
        for j in (0, 1):
            _put(sd, f"backbone.blocks.{b}.{j}", _conv(bb[f"Conv_{2 * b + j}"]))
    for i in range(4):
        _put(sd, f"backbone.laterals.{i}", _conv(bb[f"Conv_{10 + i}"]))
        _put(sd, f"backbone.smooth.{i}", _conv(bb[f"Conv_{14 + i}"]))
    for i, name in enumerate(["conv", "heat", "size", "offset"]):
        _put(sd, f"head.{name}", _conv(p["head"][f"Conv_{i}"]))
    for stage in ("refine1", "refine2"):
        r = p[stage]
        c = np.asarray(p["head"]["Conv_0"]["kernel"]).shape[2]  # pyramid channels
        s = int(round((np.asarray(r["Dense_0"]["kernel"]).shape[0] // c) ** 0.5))
        rows = np.arange(s * s * c).reshape(s, s, c).transpose(2, 0, 1).reshape(-1)
        _put(sd, f"{stage}.fc1", _dense(r["Dense_0"], rows))
        _put(sd, f"{stage}.fc2", _dense(r["Dense_1"]))
        _put(sd, f"{stage}.delta", _dense(r["Dense_2"]))
        _put(sd, f"{stage}.score", _dense(r["Dense_3"]))
    return sd
