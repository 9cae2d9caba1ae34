"""The trained-model containers serving reads (vec_vad_tpu/pipeline.py:437
VadModel and vec_vad_tpu/train/trainer.py:48-66 TrainedBlock), holding
torch state dicts in place of flax trees. Training itself is a later
slice."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from vec_vad_torch.config import PipelineConfig

BlockKey = Tuple[int, int, int]  # (scene - 1, h cell, w cell)


@dataclass
class TrainedBlock:
    """One block's completion weights + its training-score statistics."""

    state_dict: Dict[str, torch.Tensor]
    raw_scores: np.ndarray
    of_scores: Optional[np.ndarray]

    @property
    def raw_stats(self) -> Tuple[float, float]:
        return float(np.mean(self.raw_scores)), float(np.std(self.raw_scores))

    @property
    def of_stats(self) -> Optional[Tuple[float, float]]:
        if self.of_scores is None:
            return None
        return float(np.mean(self.of_scores)), float(np.std(self.of_scores))


@dataclass
class VadModel:
    """Trained model grid + score statistics (the reference's model_set +
    training_scores_set artifacts, train.py:432-436)."""

    cfg: PipelineConfig
    blocks: Dict[BlockKey, TrainedBlock] = field(default_factory=dict)
