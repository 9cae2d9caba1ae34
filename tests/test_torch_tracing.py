"""The port's spans (vec_vad_torch/runtime/profiling.annotate): the
serving tick's and the block fit's, under a CPU torch profiler, at tiny
sizes (frames 48 x 64, patch 16, nf 4, FlowNet2 at 64 x 64, 2 cameras).
Each span nests under the one the module docstring names; with no
profiler recording, none enters a profiler range, and no result changes
under one."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vec_vad_torch.config import CompletionConfig, ForegroundConfig, PipelineConfig
from vec_vad_torch.models.flownet.flownet2 import make_flownet2
from vec_vad_torch.runtime import profiling
from vec_vad_torch.serve import MultiCameraFlowScorer, MultiCameraScorer
from vec_vad_torch.train.trainer import BlockTrainer

HW = (48, 64)
PATCH = 16
CAMERAS = 2
TICKS = 3
PREFIX = profiling.SPAN_PREFIX

SERVE_CHILDREN = {"serve.stage", "serve.stc", "serve.ensemble", "serve.wait",
                  "serve.finish"}
TRAIN_CHILDREN = {"train.init_state", "train.schedule_host", "train.upload",
                  "train.train_scan", "train.score_pass", "train.param_download"}


def _cfg(live: bool) -> PipelineConfig:
    """ped2_5raw (raw only) or avenue_5raw1of (5 raw + 1 flow UNet) at
    the tiny size."""
    model = CompletionConfig(nf=4, batch_size=32, epochs=2, use_flow=live,
                             context_frame_num=4, context_of_num=0 if live else 4)
    fore = ForegroundConfig(patch_size=PATCH, max_boxes_per_frame=8)
    return PipelineConfig(dataset_name="avenue" if live else "UCSDped2",
                          fore=fore, model=model)


def _scorer(live: bool, pipeline_depth: int = 0):
    cfg = _cfg(live)
    weights = BlockTrainer(cfg.model, PATCH, device="cpu").init_state(0)
    kw = dict(n_cameras=CAMERAS, max_boxes=8, pipeline_depth=pipeline_depth,
              device="cpu")
    if live:
        return MultiCameraFlowScorer(cfg, weights, (1.0, 1.0, 1.0, 1.0),
                                     flow_net=make_flownet2(0, device="cpu").eval(),
                                     flow_model_hw=(64, 64), **kw)
    return MultiCameraScorer(cfg, weights, (1.0, 1.0), gray_stream=True, **kw)


def _ticks(live: bool):
    rng = np.random.default_rng(3)
    shape = (TICKS, CAMERAS) + HW + ((3,) if live else ())
    frames = rng.integers(0, 256, shape, dtype=np.uint8)
    boxes = []
    for _ in range(TICKS):
        tick = []
        for n in rng.integers(1, 5, CAMERAS):
            xy = rng.uniform(0, 30, (n, 2))
            tick.append(np.concatenate([xy, xy + rng.uniform(8, 18, (n, 2))], 1)
                        .astype(np.float32))
        boxes.append(tick)
    return frames, boxes


def _serve(live: bool, ticks=range(TICKS)):
    """A fresh fleet's push_tick over `ticks` of the tiny feed."""
    scorer = _scorer(live)
    if live:
        scorer.start_video()
    frames, boxes = _ticks(live)
    return scorer, [scorer.push_tick(frames[t], boxes[t]) for t in ticks]


def _cubes():
    return np.random.default_rng(5).integers(0, 256, (64, PATCH, PATCH, 15),
                                             dtype=np.uint8)


def _fit():
    trainer = BlockTrainer(_cfg(False).model, PATCH, device="cpu")
    return trainer.fit_block(_cubes(), None, seed=7)


def _program_spans(prof):
    """(name without the prefix, name of the nearest enclosing program
    span or None) of every program span the profiler saw, in start
    order."""
    out = []
    events = sorted((e for e in prof.events() if e.name.startswith(PREFIX)),
                    key=lambda e: e.time_range.start)
    for e in events:
        p = e.cpu_parent
        while p is not None and not p.name.startswith(PREFIX):
            p = p.cpu_parent
        out.append((e.name[len(PREFIX):],
                    None if p is None else p.name[len(PREFIX):]))
    return out


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        result = fn()
    return result, prof


@pytest.mark.parametrize("live", [False, True], ids=["fleet", "live_fleet"])
def test_push_tick_spans_nest_in_one_tick(live):
    """One push_tick of each fleet (the live one at its first tick, which
    scores the degenerate (f0, f0) pairs): one serve.tick, holding every
    serving span once, each directly under the tick."""
    scorer = _scorer(live)
    if live:
        scorer.start_video()
    frames, boxes = _ticks(live)
    _, prof = _profiled(lambda: scorer.push_tick(frames[0], boxes[0]))
    spans = _program_spans(prof)
    want = SERVE_CHILDREN | ({"serve.flow"} if live else set())
    assert [s for s in spans if s[0] == "serve.tick"] == [("serve.tick", None)]
    children = [name for name, parent in spans if name != "serve.tick"]
    assert sorted(children) == sorted(want), spans
    assert all(parent == "serve.tick" for name, parent in spans if name != "serve.tick")
    # host work first, host routing last
    assert children[0] == "serve.stage" and children[-1] == "serve.finish", children


def test_push_tick_one_tick_span_a_call():
    """Three ticks and a drain of the raw fleet at pipeline depth 1: a
    serve.tick a call, and no serving span outside one."""
    scorer = _scorer(False, pipeline_depth=1)
    frames, boxes = _ticks(False)

    def run():
        for t in range(TICKS):
            scorer.push_tick(frames[t], boxes[t])
        return scorer.drain()

    _, prof = _profiled(run)
    spans = _program_spans(prof)
    assert sum(name == "serve.tick" for name, _ in spans) == TICKS + 1
    assert all(parent == "serve.tick" for name, parent in spans if name != "serve.tick")
    assert sum(name == "serve.finish" for name, _ in spans) == TICKS


def test_fit_block_spans():
    """fit_block: train.fit holding its six phases, once each, in the
    order the fit runs them."""
    _, prof = _profiled(_fit)
    spans = _program_spans(prof)
    assert spans[0] == ("train.fit", None)
    assert [name for name, _ in spans[1:]] == [
        "train.init_state", "train.upload", "train.schedule_host", "train.train_scan",
        "train.score_pass", "train.param_download"]
    assert all(parent == "train.fit" for _, parent in spans[1:])
    assert {name for name, _ in spans[1:]} == TRAIN_CHILDREN


def test_span_names_carry_the_prefix():
    """Every span the program names starts with vec_vad_torch., and none
    is a user annotation (no device-side event of its own on the card)."""
    def run():
        _serve(True, range(1))
        _serve(False, range(1))
        _fit()

    _, prof = _profiled(run)
    names = {e.name for e in prof.events()}
    assert not {n for n in names if n.startswith(("serve.", "train."))}
    program = {n[len(PREFIX):] for n in names if n.startswith(PREFIX)}
    assert program == {"serve.tick", "serve.flow"} | SERVE_CHILDREN | {"train.fit"} \
        | TRAIN_CHILDREN
    assert not any(e.is_user_annotation for e in prof.events()
                   if e.name.startswith(PREFIX))


def test_no_range_without_a_profiler(monkeypatch):
    """With no profiler recording, annotate is one shared null context:
    the program enters no profiler range (each constructor raises here).
    Torch's optimizer opens its own record_function every step, so the
    fit runs with only the range annotate would use patched."""
    def boom(*a, **kw):
        raise AssertionError("a profiler range was entered")

    assert profiling.annotate("serve.tick") is profiling.annotate("train.fit")
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", boom)
    _fit()
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    _serve(True)
    _serve(False)


@pytest.mark.parametrize("live", [False, True], ids=["fleet", "live_fleet"])
def test_scores_identical_under_a_profiler(live):
    _, want = _serve(live)
    (_, got), _ = _profiled(lambda: _serve(live))
    assert got == want


def test_fit_identical_under_a_profiler():
    want = _fit()
    got, _ = _profiled(_fit)
    np.testing.assert_array_equal(got.losses, want.losses)
    np.testing.assert_array_equal(got.raw_scores, want.raw_scores)
    assert got.state_dict.keys() == want.state_dict.keys()
    assert all(torch.equal(got.state_dict[k], want.state_dict[k]) for k in want.state_dict)
