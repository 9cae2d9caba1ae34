"""Export trained completion models to the reference's torch artifacts
(vec_vad_tpu/models/completion_export.py), the exact inverse of
completion_convert. A VadModel exports to the three torch.save files the
reference's test.py consumes (test.py:230-266, written by
train.py:432-436):

  <ds>_model_<mode>_<method>.npy                 nested (scene/)h/w grid,
                                                 each trained cell a
                                                 [state_dict] with the
                                                 DataParallel 'module.'
                                                 key prefix
  <ds>_raw_training_scores_<mode>_<method>.npy   nested grids of per-cube
  <ds>_of_training_scores_<mode>_<method>.npy    training-score arrays
                                                 (1-D float, [] untrained)

so a model trained by the port can be scored by the unmodified reference
code path. Each member's tensors are its run of the port's grouped tensors
along dim 0 (completion_convert's key map); `num_batches_tracked` is
emitted as 0: torch only consults it when BatchNorm's momentum is None,
and both train with the default momentum.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from vec_vad_torch.models.completion import SelfCompletionNet
from vec_vad_torch.models.completion_convert import reference_members


def export_completion_state_dict(state_dict: Dict[str, torch.Tensor],
                                 net: SelfCompletionNet) -> Dict[str, torch.Tensor]:
    """The port's state dict for `net` -> a torch state dict in the
    reference's DataParallel-wrapped layout ('module.' prefix), loadable
    with strict=True into SelfCompleteNet4/Full (model/unet.py)."""
    sd: Dict[str, torch.Tensor] = {}
    for ens, maps in reference_members(net, shared=net.tot_of_num == 1).items():
        for i, (port, _) in enumerate(maps[0]):
            parts = state_dict[f"{ens}.{port}"].detach().cpu().chunk(len(maps))
            for m, part in zip(maps, parts):
                sd[m[i][1]] = part.clone()
        for m in maps:
            for port, ref in m:
                if port.endswith("running_var"):
                    sd[ref[: -len("running_var")] + "num_batches_tracked"] = \
                        torch.tensor(0, dtype=torch.int64)
    return {f"module.{k}": v for k, v in sd.items()}


def export_model_grid(model, out_dir: str, *, mode: str = "obj_det_with_motion",
                      method: str = "SelfComplete", device="cuda") -> List[str]:
    """Write a VadModel as the reference's three torch.save artifacts
    (train.py:432-436 naming) under `out_dir`; returns the paths.

    Grid nesting follows the reference's convention: [scene][h][w] when
    the dataset is multi-scene (test.py:231 keys the extra level on
    ShanghaiTech, the only scene_num>1 dataset), else [h][w]. Untrained
    cells are [] exactly like the reference leaves them. Each block is
    first loaded strictly into the port's net on `device` (its names and
    shapes checked against the config)."""
    from vec_vad_torch.models.completion import make_completion_net

    cfg = model.cfg
    net = make_completion_net(cfg.model, device)
    hb, wb = cfg.fore.h_block, cfg.fore.w_block
    scenes = max(
        cfg.dataset.scene_num, max((k[0] for k in model.blocks), default=0) + 1
    )
    # the reference keys the extra grid level on the dataset NAME, not a
    # scene count (test.py:231 branches on 'ShanghaiTech'; its frame_size
    # table carries scene_num=1 even for SHT)
    multi_scene = cfg.dataset.scene_num > 1 or cfg.dataset_name == "ShanghaiTech"

    def grid(fill):
        g = [
            [[fill() for _ in range(wb)] for _ in range(hb)]
            for _ in range(scenes)
        ]
        return g if multi_scene else g[0]

    def cell(g, key):
        s, h, w = key
        if multi_scene:
            node = g[s]
        elif s != 0:
            raise ValueError(
                f"scene {s + 1} block in a single-scene dataset grid"
            )
        else:
            node = g
        if h >= hb or w >= wb:
            raise ValueError(f"block key {key} outside {scenes}x{hb}x{wb}")
        return node[h], w

    model_set = grid(list)
    raw_scores = grid(list)
    of_scores = grid(list)
    use_flow = bool(cfg.model.use_flow)
    for key, blk in sorted(model.blocks.items()):
        net.load_state_dict(blk.state_dict)
        sd = export_completion_state_dict(blk.state_dict, net)
        row, w = cell(model_set, key)
        row[w] = [sd]
        row, w = cell(raw_scores, key)
        row[w] = np.asarray(blk.raw_scores, np.float32)
        if use_flow and blk.of_scores is not None:
            row, w = cell(of_scores, key)
            row[w] = np.asarray(blk.of_scores, np.float32)

    os.makedirs(out_dir, exist_ok=True)
    name = cfg.dataset_name
    paths = []
    for tag, obj in (
        ("model", model_set),
        ("raw_training_scores", raw_scores),
        ("of_training_scores", of_scores),
    ):
        p = os.path.join(out_dir, f"{name}_{tag}_{mode}_{method}.npy")
        torch.save(obj, p)
        paths.append(p)
    return paths
