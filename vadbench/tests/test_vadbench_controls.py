"""The comparison that decides `correct` fails where it must, at each
cell's CPU size: the control (the reference in TF32 in the program's
place) fails one of the cell's numbers while the program passes them all,
and a run whose timed path is broken underneath comes out not correct,
once for each fault the cell can have (one card: no exchange between
chips to leave out)."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from conftest import CELLS, tiny
from vadbench.control import readings
from vadbench.run import run_cell

SEED = 2 ** 35 + 4321


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_a_number_the_program_meets(name):
    cell, config, _, _ = tiny(name)
    got = readings(cell, config, SEED, 0.1, ("tf32",), device="cpu")
    limits = cell["limits"]
    assert all(v <= limits[k] for k, v in got["program"].items()), got
    assert any(v > limits[k] for k, v in got["tf32"].items()), got


# -- faults planted in the timed path --------------------------------------------


def _answer_altered_serving(monkeypatch):
    from vec_vad_torch.serve.streaming import StreamingScorer

    orig = StreamingScorer._score_windows

    def altered(self, wd, owd, boxes):
        out = orig(self, wd, owd, boxes)
        n = self.B * self.K
        out[0, :n] += 1e-2 * out[:, :n].abs().max()
        return out

    monkeypatch.setattr(StreamingScorer, "_score_windows", altered)


def _state_unchanged_serving(monkeypatch):
    from vec_vad_torch.serve import MultiCameraFlowScorer, MultiCameraScorer

    for cls in (MultiCameraScorer, MultiCameraFlowScorer):
        orig = cls._tick_step

        def frozen(self, *args, _orig=orig):
            ring, flow_ring = self._ring.clone(), self._flow_ring.clone()
            out = _orig(self, *args)
            self._ring.copy_(ring)
            self._flow_ring.copy_(flow_ring)
            return out

        monkeypatch.setattr(cls, "_tick_step", frozen)


def _state_unchanged_train(monkeypatch):
    from vec_vad_torch.train.trainer import BlockTrainer

    def frozen(self, x, x_of, w, batch_weight=None):
        losses = self.loss(x, x_of, w, batch_weight)
        self.opt.zero_grad(set_to_none=True)
        losses[0].backward()
        return torch.stack(losses).detach()

    monkeypatch.setattr(BlockTrainer, "train_step", frozen)


def _half_batch_train(monkeypatch):
    from vec_vad_torch.train.trainer import BlockTrainer

    orig = BlockTrainer.loss

    def half(self, x, x_of, w, batch_weight=None, *a, **kw):
        h = x.shape[0] // 2
        return orig(self, x[:h], None if x_of is None else x_of[:h], w[:h],
                    None if batch_weight is None else batch_weight[:h], *a, **kw)

    monkeypatch.setattr(BlockTrainer, "loss", half)


def _reshuffle_lost_train(monkeypatch):
    """Every epoch after the first repeats the first one's order."""
    from vec_vad_torch.train.trainer import BlockTrainer

    orig = BlockTrainer._epoch_schedule

    def same_order(self, n, rng):
        idx, wmask = orig(self, n, rng)
        per_epoch = idx.shape[0] // self.cfg.epochs
        return np.tile(idx[:per_epoch], (self.cfg.epochs, 1)), wmask

    monkeypatch.setattr(BlockTrainer, "_epoch_schedule", same_order)


def _adam_reset_train(monkeypatch):
    """Adam's moments and step count start again after the third step."""
    from vec_vad_torch.train.trainer import BlockTrainer

    orig = BlockTrainer.train_step
    calls = {"n": 0}

    def reset(self, *a, **kw):
        calls["n"] += 1
        if calls["n"] == 4:
            self.opt.state.clear()
        return orig(self, *a, **kw)

    monkeypatch.setattr(BlockTrainer, "train_step", reset)


def _answer_altered_train(monkeypatch):
    from vec_vad_torch.train.trainer import BlockTrainer

    orig = BlockTrainer._score

    def altered(self, *a, **kw):
        raw, of = orig(self, *a, **kw)
        raw = raw.copy()
        raw[0] += 1e-2 * abs(raw).max()
        return raw, of

    monkeypatch.setattr(BlockTrainer, "_score", altered)


FAULTS = [
    ("avenue_5raw1of.live_fleet", _answer_altered_serving),
    ("avenue_5raw1of.live_fleet", _state_unchanged_serving),
    ("ped2_5raw.fleet", _answer_altered_serving),
    ("ped2_5raw.fleet", _state_unchanged_serving),
    ("ped2_5raw.train", _state_unchanged_train),
    ("ped2_5raw.train", _half_batch_train),
    ("ped2_5raw.train", _reshuffle_lost_train),
    ("ped2_5raw.train", _adam_reset_train),
    ("ped2_5raw.train", _answer_altered_train),
]


@pytest.mark.parametrize("name,plant", FAULTS,
                         ids=[f"{n}-{f.__name__.strip('_')}" for n, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(name, plant, monkeypatch):
    cell, config, e2e, per_layer = tiny(name)
    plant(monkeypatch)
    result = run_cell(cell, config, SEED, 0.1, 0, e2e, per_layer, device="cpu",
                      t_start=time.perf_counter())
    assert result["correct"] is False, result["compared"]
