"""The program's spans in a trace (vadbench/spans.py), on synthetic
profiler events: host spans and device extents by the launching runtime
call (or operator), each reading against a hand count, nothing read
where the program has no spans, and the harness's summary
(vadbench/trace.py) unchanged by the program's host spans."""

from __future__ import annotations

import json
from collections import Counter
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from conftest import CELLS, tiny
from vadbench import spans as sp
from vadbench.trace import summarise

WINDOW_S = 400e-6
TRAIN_WINDOW_S = 1000e-6


def _ev(name, a, b, device=False, id=0, user=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=a, end=b),
                           device_type=DeviceType.CUDA if device else DeviceType.CPU,
                           id=id, is_user_annotation=user)


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _tick(o: float, first_id: int, program: bool = True):
    """One serving tick at offset o (us): the harness's step span, the
    program's spans (if `program`), five launches (runtime calls) and
    their device operations: an upload in stage, a ring write in the
    tick's own time, an STC kernel, two ensemble kernels."""
    ev = [_ev("vadbench.step", o - 5, o + 105)]
    if program:
        ev += [_ev("vec_vad_torch.serve.tick", o, o + 100),
               _ev("vec_vad_torch.serve.stage", o, o + 21),
               _ev("vec_vad_torch.serve.stc", o + 25, o + 40),
               _ev("vec_vad_torch.serve.ensemble", o + 40, o + 60),
               _ev("vec_vad_torch.serve.wait", o + 60, o + 90),
               _ev("vec_vad_torch.serve.finish", o + 90, o + 100)]
    launches = [(o + 10, "Memcpy HtoD", o + 12, o + 18),
                (o + 22, "ring_write_kernel", o + 22, o + 30),
                (o + 30, "stc_kernel", o + 30, o + 45),
                (o + 45, "conv_kernel", o + 45, o + 80),
                (o + 55, "conv_kernel", o + 80, o + 85)]
    for k, (t, name, a, b) in enumerate(launches):
        cid = first_id + k
        # operators number their ids apart from the runtime's: the same
        # number names the launching operator of another operation
        ev += [_ev("aten::op", t - 1, t + 2, id=cid + 1),
               _ev("cudaLaunchKernel", t, t + 1, id=cid),
               _ev(name, a, b, device=True, id=cid)]
    return ev


def _serving(program=True):
    return _tick(0, 1, program) + _tick(200, 101, program)


def _fit(program=True):
    ev = [_ev("vadbench.fit_block", 0, 1000)]
    if program:
        ev += [_ev("vec_vad_torch.train.fit", 0, 1000),
               _ev("vec_vad_torch.train.init_state", 0, 50),
               _ev("vec_vad_torch.train.upload", 50, 100),
               _ev("vec_vad_torch.train.schedule_host", 100, 120),
               _ev("vec_vad_torch.train.train_scan", 120, 900),
               _ev("vec_vad_torch.train.score_pass", 900, 980),
               _ev("vec_vad_torch.train.param_download", 980, 1000)]
    for cid, (t, a, b) in enumerate([(55, 60, 90), (125, 130, 890), (902, 905, 975),
                                     (982, 985, 995)], start=1):
        ev += [_ev("cudaLaunchKernel", t, t + 1, id=cid),
               _ev("kernel", a, b, device=True, id=cid)]
    # torch's Adam.step range: a device-side user annotation
    ev.append(_ev("Optimizer.step#Adam.step", 300, 310, device=True, user=True))
    return ev


def test_host_spans_and_device_extents():
    routes = Counter()
    got = sp.program_spans(_tick(0, 1), routes)
    host = {n: (a, b) for a, b, n, s in got if s == "host"}
    device = {n: (a, b) for a, b, n, s in got if s == "device"}
    assert host == {"serve.tick": (0, 100), "serve.stage": (0, 21), "serve.stc": (25, 40),
                    "serve.ensemble": (40, 60), "serve.wait": (60, 90),
                    "serve.finish": (90, 100)}
    # the tick's extent holds its children's; wait and finish launched nothing
    assert device == {"serve.tick": (12, 85), "serve.stage": (12, 18),
                      "serve.stc": (30, 45), "serve.ensemble": (45, 85)}
    assert routes == {"runtime": 5}


def test_device_work_without_a_runtime_call_is_left_out():
    events = [_ev("vec_vad_torch.serve.stc", 0, 10), _ev("aten::mm", 2, 8, id=7),
              _ev("gemm_kernel", 20, 30, device=True, id=7)]
    routes = Counter()
    assert sp.program_spans(events, routes) == [(0, 10, "serve.stc", "host")]
    assert routes == {"none": 1}


def test_serving_readings_by_hand():
    summary = summarise(_Prof(_serving()), WINDOW_S)
    spans = sp.program_spans(_serving())
    got = sp.readings(summary, spans)
    # a tick: 100 us on the host, 30 of them waiting
    assert got["host_ms.serve"] == pytest.approx(0.070)
    # idle [18, 22], [85, 212], [218, 222] within stage [0, 21], [200, 221]
    # and finish [90, 100], [290, 300]: 3 + 10 + 12 + 3 us of 400
    assert got["idle_host_pct.serve"] == pytest.approx(7.0)
    assert got["stc_ms.serve"] == pytest.approx(0.015)
    assert got["ensemble_ms.serve"] == pytest.approx(0.040)
    assert got["idle_host_pct.train"] is None and got["fit_overhead_pct.train"] is None
    idle = sp.idle_by_span(summary, spans, [(-5, 105, "step"), (195, 305, "step")])
    # [18, 22] and [218, 222]: 3 us in stage, 1 in the tick's own time;
    # [85, 212]: wait 5, finish 10, the harness's steps 5 + 5, none 90,
    # the next stage 12
    assert idle == pytest.approx({
        "serve.stage": 18e-6, "serve.tick": 2e-6, "serve.wait": 5e-6,
        "serve.finish": 10e-6, "harness step": 10e-6, "outside any span": 90e-6})
    dev = sp.device_s_by_span(summary, spans)
    assert dev == pytest.approx({"serve.tick": 138e-6, "serve.stage": 12e-6,
                                 "serve.stc": 30e-6, "serve.ensemble": 80e-6})


def test_training_readings_by_hand():
    summary = summarise(_Prof(_fit()), TRAIN_WINDOW_S)
    spans = sp.program_spans(_fit())
    got = sp.readings(summary, spans)
    # (1000 - 780) of the fit's 1000 us outside the step loop
    assert got["fit_overhead_pct.train"] == pytest.approx(22.0)
    # idle [90, 130] within init/upload/schedule [0, 120], [975, 985]
    # within param_download [980, 1000]: 30 + 5 us of 1000
    assert got["idle_host_pct.train"] == pytest.approx(3.5)
    assert got["host_ms.serve"] is None and got["stc_ms.serve"] is None


@pytest.mark.parametrize("events", [_serving, _fit], ids=["serve", "train"])
def test_nothing_read_without_program_spans(events):
    summary = summarise(_Prof(events(False)), WINDOW_S)
    spans = sp.program_spans(events(False))
    assert spans == []
    assert all(v is None for v in sp.readings(summary, spans).values())


@pytest.mark.parametrize("events", [_serving, _fit], ids=["serve", "train"])
def test_summary_unchanged_by_program_spans(events):
    """The program's spans are host ranges only: the harness's summary of
    a trace with them equals, field by field, that of the same trace
    without them."""
    want = summarise(_Prof(events(False)), WINDOW_S)
    got = summarise(_Prof(events(True)), WINDOW_S)
    for f in ("window_s", "busy_s", "kernels", "gaps", "intervals"):
        assert getattr(got, f) == getattr(want, f), f
    assert not any(n.startswith(sp.PROGRAM_PREFIX) for n in got.kernels)


@pytest.mark.parametrize("name", CELLS)
def test_traced_cell_on_the_cpu(name):
    """The report end to end on a tiny cell: the program's spans found and
    read (host readings only: no device operations off the card)."""
    import torch

    cell, config, _, _ = tiny(name)
    out = sp.traced(cell, config, 2 ** 33 + 7, 0.2, torch.device("cpu"))
    got = out["readings"]
    train = cell["driver"] == "train"
    assert out["spans_a_call"] == {"train": 7, "fleet": 6, "live_fleet": 7}[cell["driver"]]
    assert (got["fit_overhead_pct.train"] is not None) == train
    assert (got["host_ms.serve"] is not None) != train
    assert not out["program_names_in_kernels"]
    json.dumps(out)
