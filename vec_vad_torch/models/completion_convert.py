"""Import the reference's torch checkpoints of the completion nets
(vec_vad_tpu/models/completion_convert.py).

The reference persists `model_set`, a (scene)/h/w grid of torch state
dicts of SelfCompleteNet4/Full/1raw1of wrapped in DataParallel ('module.'
key prefix), with torch.save (train.py:331,410,436); its released
checkpoints (README.md:63, e.g. avenue_model_5raw1of_auc0.902) use the
same format. Each member of the ensemble is its own UNet there, in
torch's own layouts (conv OIHW, ConvTranspose (I, O, kh, kw)); the port's
grouped layers hold the members' tensors concatenated along dim 0
(models/layers.py), so a port tensor is the members' tensors stacked in
member order, with no transpose.

Key layout per raw position k (model/unet.py:110-158), beside the port's
names (`raw_unets.` or `of_unets.` in front):
  inc{k}.conv.conv.{0,1,3,4}      down.0.{conv0,bn0,conv1,bn1}
  down{k}j.mpconv.1.conv.*        down.j (j = 1..3)
  up{k}j.up                       up_t.{j-1} (convT k3 s2)
  up{k}j.conv.conv.*              up.{j-1}
  outc{k}.conv                    out (1x1)
Flow UNets use inc_of (Net4's one shared flow UNet) or inc_of{i} (Full's
per-slot UNets) and so on (unet.py:161-170,360-408).
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from vec_vad_torch.models.completion import SelfCompletionNet

# a DoubleConv's torch Sequential index -> the port's (layer, leaf) names
_DOUBLE_CONV = (
    (0, "conv0", ("weight", "bias")),
    (1, "bn0", ("weight", "bias", "running_mean", "running_var")),
    (3, "conv1", ("weight", "bias")),
    (4, "bn1", ("weight", "bias", "running_mean", "running_var")),
)


def _strip_module(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {
        (k[len("module.") :] if k.startswith("module.") else k): v
        for k, v in sd.items()
    }


def unet_key_map(inc: str, downs: List[str], ups: List[str],
                 outc: str) -> List[Tuple[str, str]]:
    """(port name under the ensemble, reference key) of one member's UNet,
    from its reference module names."""
    pairs = []
    seqs = ([("down.0", f"{inc}.conv.conv")]
            + [(f"down.{j}", f"{d}.mpconv.1.conv") for j, d in enumerate(downs, 1)]
            + [(f"up.{j}", f"{u}.conv.conv") for j, u in enumerate(ups)])
    for port, ref in seqs:
        for i, layer, leaves in _DOUBLE_CONV:
            pairs += [(f"{port}.{layer}.{leaf}", f"{ref}.{i}.{leaf}") for leaf in leaves]
    for j, u in enumerate(ups):
        pairs += [(f"up_t.{j}.{leaf}", f"{u}.up.{leaf}") for leaf in ("weight", "bias")]
    pairs += [(f"out.{leaf}", f"{outc}.conv.{leaf}") for leaf in ("weight", "bias")]
    return pairs


def reference_members(net: SelfCompletionNet,
                      shared: bool) -> Dict[str, List[List[Tuple[str, str]]]]:
    """Per ensemble of `net` ("raw_unets", and "of_unets" with a flow
    head), each member's key map in member order. `shared`: the flow
    members read Net4's single flow UNet, whose names are unindexed
    (unet.py:161-170); else each reads Full's UNet of its slot
    (unet.py:360-408)."""
    out = {"raw_unets": [
        unet_key_map(f"inc{k}", [f"down{k}{j}" for j in (1, 2, 3)],
                     [f"up{k}{j}" for j in (1, 2, 3)], f"outc{k}")
        for k in net.raw_positions]}
    if net.of_unets is not None:
        members = []
        for _, of_i in net.flow_positions:
            s = "" if shared else str(of_i)
            members.append(unet_key_map(
                f"inc_of{s}", [f"down_of{s}{j}" for j in (1, 2, 3)],
                [f"up_of{s}{j}" for j in (1, 2, 3)], f"outc_of{s}"))
        out["of_unets"] = members
    return out


def convert_completion_state_dict(sd, net: SelfCompletionNet) -> Dict[str, torch.Tensor]:
    """A reference state dict (tensors or numpy arrays, with or without
    'module.') -> the port's state dict for `net`, each tensor the
    members' tensors concatenated along dim 0. A state dict with Net4's
    shared flow UNet (inc_of) feeds every firing flow member from it."""
    sd = {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
          for k, v in _strip_module(sd).items()}
    members = reference_members(net, shared="inc_of.conv.conv.0.weight" in sd)
    out = {}
    for ens, maps in members.items():
        for i, (port, _) in enumerate(maps[0]):
            out[f"{ens}.{port}"] = torch.cat(
                [sd[m[i][1]].float() for m in maps]).contiguous()
    return out


def load_reference_model_grid(path: str, net: SelfCompletionNet
                              ) -> List[Tuple[Tuple[int, ...], Dict[str, torch.Tensor]]]:
    """A reference model_set file (torch.save of the nested grid,
    train.py:436) -> [(grid key, the port's state dict), ...] for its
    trained cells ([state_dict]); [] cells are untrained."""
    model_set = torch.load(path, map_location="cpu", weights_only=False)
    out = []

    def walk(node, key):
        if isinstance(node, list):
            if node and isinstance(node[0], dict):  # [state_dict]
                out.append((key, convert_completion_state_dict(node[0], net)))
            else:
                for i, child in enumerate(node):
                    walk(child, key + (i,))

    walk(model_set, ())
    return out


def import_model_grid(cfg, model_dir: str, *, mode: str = None, method: str = None,
                      device="cuda"):
    """The reference's artifact set -> a VadModel (the inverse of
    completion_export.export_model_grid): the three torch.save files
    test.py:229-267 reads, `<ds>_model_<mode>_<method>.npy` (the nested
    grid of [state_dict]) and the raw/of training-score grids that carry
    the z-normalisation statistics. Single-scene grids are [h][w], the
    multi-scene ones [scene][h][w]. Every converted state dict is loaded
    strictly into the port's net on `device` (names and shapes checked);
    the blocks keep host tensors, as trained ones do."""
    from vec_vad_torch.models.completion import make_completion_net
    from vec_vad_torch.pipeline import TrainedBlock, VadModel

    mode = mode or cfg.fore.extraction_mode
    method = method or cfg.method

    def path(tag: str) -> str:
        return os.path.join(model_dir, f"{cfg.dataset_name}_{tag}_{mode}_{method}.npy")

    net = make_completion_net(cfg.model, device)
    grid = load_reference_model_grid(path("model"), net)
    if not grid:
        raise ValueError(f"{path('model')}: no trained blocks in model_set")
    raw_set = torch.load(path("raw_training_scores"), map_location="cpu",
                         weights_only=False)
    of_set = None
    if cfg.model.use_flow and os.path.exists(path("of_training_scores")):
        of_set = torch.load(path("of_training_scores"), map_location="cpu",
                            weights_only=False)

    def leaf(node, key):
        for i in key:
            node = node[i]
        return node

    blocks = {}
    for key, sd in grid:
        net.load_state_dict(sd)
        # single-scene grids are [h][w]; SHT-style are [scene][h][w]
        k3 = key if len(key) == 3 else (0,) + tuple(key)
        of_scores = None
        if of_set is not None:
            v = leaf(of_set, key)
            if not (isinstance(v, list) and len(v) == 0):
                of_scores = np.asarray(v, np.float32)
        blocks[k3] = TrainedBlock(
            state_dict=sd,
            raw_scores=np.asarray(leaf(raw_set, key), np.float32),
            of_scores=of_scores,
        )
    return VadModel(cfg=cfg, blocks=blocks)
