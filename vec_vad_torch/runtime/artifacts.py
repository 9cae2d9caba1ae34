"""Reading the JAX package's `.npz` models (vec_vad_tpu/runtime/
artifacts.py:62-68,96-129): a VadModel trained and saved by vec_vad_tpu
serves in the port. The file holds path-flattened flax trees plus a JSON
config header; `load_vad_model` converts each block's weights with
models.convert.completion_from_jax."""

from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np

from vec_vad_torch.config import CompletionConfig, ForegroundConfig, PipelineConfig
from vec_vad_torch.models.convert import completion_from_jax
from vec_vad_torch.pipeline import TrainedBlock, VadModel


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return root


def load_pytree_npz(path: str):
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    meta = None
    if "__meta__" in flat:
        meta = json.loads(bytes(flat.pop("__meta__").tobytes()).decode())
    return _unflatten(flat), meta


def load_vad_model(path: str) -> VadModel:
    tree, meta = load_pytree_npz(path)
    cfg_d = meta["cfg"]
    cfg = PipelineConfig(
        **{k: v for k, v in cfg_d.items() if k not in ("fore", "model")},
        fore=ForegroundConfig(**cfg_d["fore"]),
        model=CompletionConfig(**cfg_d["model"]),
    )
    model = VadModel(cfg=cfg)
    for kstr, blk in tree.items():
        key = tuple(int(x) for x in kstr.split("_"))
        model.blocks[key] = TrainedBlock(
            state_dict=completion_from_jax(blk["params"], blk["batch_stats"]),
            raw_scores=np.asarray(blk["raw_scores"]),
            of_scores=(
                np.asarray(blk["of_scores"]) if "of_scores" in blk else None
            ),
        )
    return model
