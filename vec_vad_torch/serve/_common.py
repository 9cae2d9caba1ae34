"""Shared serving-step window math (vec_vad_tpu/serve/_common.py).

The JAX package's one-buffer weight packing (_pack_f32/_unflatten_f32)
has no counterpart here: it existed to marshal a pytree into a jitted
call as one argument, while a torch module keeps its weights resident on
the device between calls."""

from __future__ import annotations

import numpy as np


def _predict_window(pos: int, ctx: int) -> np.ndarray:
    """The 'predict' border-mode context window for frame `pos` of a video,
    in within-video coordinates: [start]*pad + [start..pos]
    (vad_datasets.py:287-293; matches data.video_index.context_indices)."""
    T = ctx + 1
    start = max(pos - ctx, 0)
    pad = T - (pos - start + 1)
    t = np.arange(T, dtype=np.int64)
    return start + np.maximum(t - pad, 0)
