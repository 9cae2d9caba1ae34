"""Artifact persistence and stage caching (vec_vad_tpu/runtime/
artifacts.py), in the JAX package's file layout.

  * A VadModel (weights + score statistics per block) is one .npz of
    path-flattened flax trees plus a JSON config header (`__meta__`).
    The port writes its torch weights in that layout
    (models.convert.completion_to_jax) and reads them back with
    completion_from_jax, so a model trained by either package loads and
    scores in the other.
  * ArtifactCache replaces the reference's boolean *_saved flags with
    content-hash invalidation: a stage's artifact is keyed by a
    fingerprint of its inputs/config, so changing a knob recomputes
    exactly the stale stages.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any, Callable, Dict, Optional

import numpy as np

from vec_vad_torch.config import CompletionConfig, ForegroundConfig, PipelineConfig
from vec_vad_torch.models.convert import completion_from_jax, completion_to_jax
from vec_vad_torch.pipeline import TrainedBlock, VadModel


# ---------------------------------------------------------------------------
# Pytree <-> npz
# ---------------------------------------------------------------------------


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}/{k}" if prefix else str(k), out)
    elif tree is None:
        pass
    else:
        out[prefix] = np.asarray(tree)


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return root


def save_pytree_npz(path: str, tree: Any, meta: Optional[dict] = None) -> None:
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    if meta is not None:
        flat["__meta__"] = np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8
        )
    np.savez_compressed(path, **flat)


def load_pytree_npz(path: str):
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    meta = None
    if "__meta__" in flat:
        meta = json.loads(bytes(flat.pop("__meta__").tobytes()).decode())
    return _unflatten(flat), meta


# ---------------------------------------------------------------------------
# VadModel serialization
# ---------------------------------------------------------------------------


def save_vad_model(path: str, model: VadModel) -> None:
    """Serialize a pipeline.VadModel (the analog of the reference's
    model_set + training-scores artifacts) as the JAX package does."""
    assert isinstance(model, VadModel)
    tree: Dict[str, Any] = {}
    for key, blk in model.blocks.items():
        kstr = "_".join(str(k) for k in key)
        params, batch_stats = completion_to_jax(blk.state_dict)
        tree[kstr] = {
            "params": params,
            "batch_stats": batch_stats,
            "raw_scores": blk.raw_scores,
        }
        if blk.of_scores is not None:
            tree[kstr]["of_scores"] = blk.of_scores
    meta = {"cfg": dataclasses.asdict(model.cfg)}
    save_pytree_npz(path, tree, meta)


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


# ---------------------------------------------------------------------------
# Stage cache
# ---------------------------------------------------------------------------


def fingerprint(*parts: Any) -> str:
    """Stable content hash of configs/arrays/strings."""
    h = hashlib.sha256()
    for p in parts:
        if dataclasses.is_dataclass(p) and not isinstance(p, type):
            h.update(json.dumps(dataclasses.asdict(p), sort_keys=True).encode())
        elif isinstance(p, np.ndarray):
            h.update(str(p.shape).encode())
            h.update(str(p.dtype).encode())
            h.update(hashlib.sha256(np.ascontiguousarray(p).tobytes()).digest())
        elif isinstance(p, (list, tuple)):
            for q in p:
                h.update(fingerprint(q).encode())
        else:
            h.update(repr(p).encode())
    return h.hexdigest()[:16]


class ArtifactCache:
    """Content-addressed stage cache.

    cache.get_or_compute('foreground_train', fp, compute_fn, save_fn,
    load_fn) runs compute_fn only when no artifact for (stage, fp) exists —
    the content-hash replacement for the reference's *_saved booleans.
    """

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def path(self, stage: str, fp: str, ext: str = ".npz") -> str:
        return os.path.join(self.root, f"{stage}_{fp}{ext}")

    def get_or_compute(
        self,
        stage: str,
        fp: str,
        compute: Callable[[], Any],
        save: Callable[[str, Any], None],
        load: Callable[[str], Any],
        ext: str = ".npz",
    ) -> Any:
        p = self.path(stage, fp, ext)
        if os.path.exists(p):
            return load(p)
        value = compute()
        save(p, value)
        return value
