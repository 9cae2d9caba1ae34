"""The serving ensemble forwards only a step's valid cube rows
(serve._common._valid_rows, StreamingScorer._score_windows): every route's
frame scores against the same scorer running the old path, STC and every
block's forward over all k*K padded rows, rebuilt here by calling the
nets directly. Eval-mode BatchNorm keeps rows independent, so only a
convolution's round-off at another batch size may differ: 1e-6 of the
largest score.

The port alone, no JAX: random nf=4 blocks (patch 16, 48x64 frames,
K = 20 box slots, so a full frame's bucket is capped below 24 rows) and
a one-layer flow net at 24x32 for the live routes. Box counts cover a
camera with no box, a camera at K, a step with no box anywhere and a
valid-row count exactly on a bucket edge."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vec_vad_torch.config import CompletionConfig, ForegroundConfig, PipelineConfig
from vec_vad_torch.device import full_f32
from vec_vad_torch.models.completion import init_completion_state, make_completion_net
from vec_vad_torch.ops.stc import cube_to_input, extract_stc, flow_magnitude
from vec_vad_torch.pipeline import TrainedBlock, VadModel
from vec_vad_torch.score.scoring import BIG_NUMBER
from vec_vad_torch.serve import (
    FlowStreamingScorer,
    MultiCameraFlowScorer,
    MultiCameraScorer,
    StreamingScorer,
)
from vec_vad_torch.serve._common import ROW_BUCKET, _valid_rows

K = 20
HW = (48, 64)
FLOW_HW = (24, 32)
REL = 1e-6
C = 4
# per tick, the C cameras' box counts: 28 rows (bucket 32 at 8, a camera
# with none, one at K), none anywhere, 32 and 16 (bucket edges), every
# row (80, the cap), 1 (7 repeats at 8)
TICKS = ([0, 3, K, 5], [0, 0, 0, 0], [16, 0, 9, 7], [2, 7, 1, 6], [K] * C,
         [1, 0, 0, 0], [4, 11, 0, 2], [3, 3, 3, 3])
# per push (single stream), the same cases one frame at a time
PUSHES = [0, K, 16, 3, 1, 0, 7, 12, 5, 9]
# per push_many batch of 4
BATCHES = ([0, K, 3, 13], [0, 0, 0, 0], [4, 4, 4, 4], [1, 2, 3, 5])


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _model(seed, use_flow=True, keys=((0, 0, 0),), grid=(1, 1)) -> VadModel:
    """Random blocks with training-score statistics from the nets' own
    error sums on random cubes, so fused scores are O(1)-O(10)."""
    cfg = PipelineConfig(
        dataset_name="UCSDped2",
        fore=ForegroundConfig(patch_size=16, max_boxes_per_frame=K,
                              h_block=grid[0], w_block=grid[1]),
        model=CompletionConfig(nf=4, context_of_num=0, use_flow=use_flow),
    )
    net = make_completion_net(cfg.model, "cpu")
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((8, 16, 16, 15), generator=g)
    x_of = 0.3 * torch.randn((8, 16, 16, 2), generator=g) if use_flow else None
    blocks = {}
    for i, key in enumerate(keys):
        sd = init_completion_state(net, seed + i)
        net.load_state_dict(sd)
        with torch.no_grad():
            out = net(x, x_of)
        raw = (out.raw_out - out.raw_tgt).square().sum(dim=(0, 2, 3, 4)).numpy()
        of = None
        if use_flow:
            of = (out.of_out - out.of_tgt).square().sum(dim=(0, 2, 3, 4)).numpy()
        blocks[key] = TrainedBlock(sd, raw, of)
    return VadModel(cfg=cfg, blocks=blocks)


class _TinyFlow(torch.nn.Module):
    """(n, 2, h, w, 3) frame pairs in 0..255 -> (n, h, w, 2) flow."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(3)
        self.w = torch.nn.Parameter(0.2 * torch.randn((2, 6, 3, 3), generator=g))

    def forward(self, pair):
        x = torch.cat([pair[:, 0], pair[:, 1]], dim=-1).permute(0, 3, 1, 2) / 255.0
        return F.conv2d(x - 0.5, self.w, padding=1).permute(0, 2, 3, 1)


def _feed(seed, n):
    """n frames, per frame K candidate boxes (8-32 px sides inside the
    frame) and a flow map."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (n,) + HW + (3,), dtype=np.uint8)
    side = rng.uniform(8, 32, (n, K, 2))
    x0 = rng.uniform(0, HW[1] - side[..., 0])
    y0 = rng.uniform(0, HW[0] - side[..., 1])
    boxes = np.stack([x0, y0, x0 + side[..., 0], y0 + side[..., 1]], -1)
    flows = rng.normal(0, 0.3, (n,) + HW + (2,)).astype(np.float32)
    return frames, boxes.astype(np.float32), flows


def _all_rows(scorer, wd, owd, boxes) -> torch.Tensor:
    """The old path: STC over the k*K padded boxes, then every block's
    forward over all k*K rows, and the fused scores of every row."""
    P, dt, mc = scorer.P, scorer.compute_dtype, scorer.cfg.model
    k = wd.shape[0]
    with full_f32(dt):
        x = cube_to_input(extract_stc(wd, boxes, P, quantize=True), scale=False)
        x = x.to(torch.uint8).to(dt).reshape((k * K,) + x.shape[2:]) / 255.0
        x_of = None
        mag = torch.full((k, K), float("inf"))
        if scorer.use_flow:
            fcubes = extract_stc(owd, boxes, P, quantize=False)
            mag = flow_magnitude(fcubes)
            x_of = cube_to_input(fcubes, scale=False).to(dt)
            x_of = x_of.reshape((k * K,) + x_of.shape[2:])
        scores = []
        for forward, st in zip(scorer._forwards, scorer._stats):
            out = forward(x, x_of)
            sc = (out.raw_out - out.raw_tgt).float().square().sum(dim=(0, 2, 3, 4))
            score = mc.w_raw * (sc - st[0]) / st[1]
            if out.of_out is not None:
                osc = (out.of_out - out.of_tgt).float().square().sum(dim=(0, 2, 3, 4))
                score = score + st[4] * mc.w_of * (osc - st[2]) / st[3]
            scores.append(score.reshape(k, K))
        return torch.cat([torch.stack(scores, 1).reshape(k, -1), mag], 1)


def _old_path(scorer):
    """`scorer` (and every mesh replica of it) scoring by the old path."""
    for rep in getattr(scorer, "_replicas", [scorer]):
        rep._score_windows = (
            lambda wd, owd, box_set, rep=rep: _all_rows(rep, wd, owd, box_set[0]))
    return scorer


def _close(got, want):
    """Scores within REL of the largest finite |score|; the +-big_number
    of a frame with no scoring box (or an untrained cell) exactly."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    big = np.abs(want) >= BIG_NUMBER
    np.testing.assert_array_equal(got[big], want[big])
    assert (~big).sum() > 5 and np.ptp(want[~big]) > 0.1
    tol = REL * np.abs(want[~big]).max()
    assert np.abs(got[~big] - want[~big]).max() <= tol, (got, want)


def _counts_boxes(boxes, counts):
    return [boxes[i, :nb] for i, nb in enumerate(counts)]


# -- the row set ---------------------------------------------------------------


@pytest.mark.parametrize("nbs, k_slots, size", [
    ([0, 3, 20, 5], 20, 32),   # 28 rows
    ([0, 0, 0, 0], 20, 0),     # none: no forward
    ([16, 0, 9, 7], 20, 32),   # on a bucket edge
    ([21], 22, 22),            # one frame: capped at k*K below the bucket
    ([1, 0, 0, 0], 20, 8),
    ([64] * 8, 64, 512),       # every row of a full fleet
])
def test_valid_rows(nbs, k_slots, size):
    """Frame-major rows j*K + b (b < nbs[j]), padded by repeats of the
    first to the bucket, capped at k*K; M the valid count."""
    rows, m = _valid_rows(nbs, k_slots)
    want = [j * k_slots + b for j, nb in enumerate(nbs) for b in range(nb)]
    assert m == len(want) == sum(nbs)
    assert rows.dtype == np.int64 and rows.shape == (size,)
    assert rows[:m].tolist() == want
    assert (rows[m:] == want[0]).all() if m else rows.size == 0
    assert size == min(-(-m // ROW_BUCKET) * ROW_BUCKET, len(nbs) * k_slots)


@pytest.mark.parametrize("use_flow", [True, False])
def test_score_windows_valid_rows_equal_all_rows(use_flow):
    """_score_windows over a row set: each valid row's block scores equal
    the old path's within REL, and the motion magnitudes of all K boxes
    are the old path's exactly; n_valid 0 runs no forward."""
    sc = StreamingScorer.from_model(_model(31, use_flow), device="cpu")
    frames, boxes, flows = _feed(5, 5)
    wd = torch.from_numpy(frames)[None].expand((C,) + frames.shape)
    owd = torch.from_numpy(flows[:1])[None].expand(C, 1, *flows.shape[1:])
    bx = torch.from_numpy(boxes[:C])
    calls = []
    handle = sc._forwards[0].register_forward_pre_hook(
        lambda m, a: calls.append(a[0].shape[0]))
    try:
        for nbs in TICKS:
            rows, m = _valid_rows(nbs, K)
            with torch.no_grad():
                got = sc._score_windows(wd, owd, (bx, torch.from_numpy(rows), m))
                # the new path's one forward over the bucket, none for 0
                assert calls == ([rows.size] if m else [])
                want = _all_rows(sc, wd, owd, bx)
            calls.clear()
            assert got.shape == want.shape == (C, 2 * K)
            torch.testing.assert_close(got[:, K:], want[:, K:], rtol=0, atol=0)
            valid = torch.from_numpy(np.arange(K) < np.array(nbs)[:, None])
            g, w = got[:, :K][valid], want[:, :K][valid]
            assert g.numel() == m
            if m:
                assert (g - w).abs().max() <= REL * w.abs().max(), (g, w)
    finally:
        handle.remove()


# -- every route against the old path -------------------------------------------


def _fleet_run(scorer, frames, boxes, flows):
    out = []
    scorer.start_video()
    for t, counts in enumerate(TICKS):
        ix = [(3 * c + t) % len(frames) for c in range(C)]
        out.append(scorer.push_tick(frames[ix], _counts_boxes(boxes[ix], counts),
                                    flows=None if flows is None else flows[ix]))
    return [o for o in out if o is not None] + scorer.drain()


def _live_fleet_run(scorer, frames, boxes, _):
    out = []
    for lo, hi in ((0, 5), (5, len(TICKS))):
        scorer.start_video()
        for t in range(lo, hi):
            ix = [(3 * c + t) % len(frames) for c in range(C)]
            out.append(scorer.push_tick(frames[ix],
                                        _counts_boxes(boxes[ix], TICKS[t])))
        out.append(scorer.end_video())
    return [o for o in out if o is not None]


def _push_run(scorer, frames, boxes, flows):
    scorer.start_video()
    out = [scorer.push(frames[i], boxes[i, :nb],
                       **({} if flows is None else {"flow": flows[i]}))
           for i, nb in enumerate(PUSHES)]
    if isinstance(scorer, FlowStreamingScorer):
        out.append(scorer.end_video())
    return [o for o in out if o is not None] + scorer.drain()


def _push_many_run(scorer, frames, boxes, flows):
    out, i = [], 0
    scorer.start_video()
    for counts in BATCHES:
        n = len(counts)
        kw = {} if flows is None else {"flows": flows[i:i + n]}
        out += scorer.push_many(frames[i:i + n], _counts_boxes(boxes[i:i + n], counts),
                                **kw)
        i += n
    if isinstance(scorer, FlowStreamingScorer):
        out.append(scorer.end_video())
    return out + scorer.drain()


ROUTES = {
    # route: (scorer class, run, model keywords, scorer keywords)
    "fleet": (MultiCameraScorer, _fleet_run, {}, dict(n_cameras=C, pipeline_depth=1)),
    "fleet_raw_only": (MultiCameraScorer, _fleet_run, dict(use_flow=False),
                       dict(n_cameras=C)),
    "fleet_mesh": (MultiCameraScorer, _fleet_run, {},
                   dict(n_cameras=C, mesh=["cpu", "cpu"])),
    "live_fleet": (MultiCameraFlowScorer, _live_fleet_run, {}, dict(n_cameras=C)),
    "push": (StreamingScorer, _push_run, {}, {}),
    "push_many": (StreamingScorer, _push_many_run, {}, dict(pipeline_depth=2)),
    "live_push": (FlowStreamingScorer, _push_run, {}, {}),
    "live_push_many": (FlowStreamingScorer, _push_many_run, {}, {}),
    "grid_2_blocks": (MultiCameraScorer, _fleet_run,
                      dict(keys=((0, 0, 0), (0, 0, 1)), grid=(1, 2)),
                      dict(n_cameras=C, route_hw=HW)),
    "bf16": (MultiCameraScorer, _fleet_run, {},
             dict(n_cameras=C, compute_dtype="bfloat16")),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_route_matches_all_rows(route):
    """Each route's frame scores with the valid-row forward against the
    same scorer forwarding all k*K padded rows."""
    cls, run, model_kw, kw = ROUTES[route]
    model = _model(41, **model_kw)
    if issubclass(cls, FlowStreamingScorer):
        kw = dict(kw, flow_net=_TinyFlow(), flow_model_hw=FLOW_HW)
    frames, boxes, flows = _feed(9, 16)
    if not model.cfg.model.use_flow or issubclass(cls, FlowStreamingScorer):
        flows = None
    want = run(_old_path(cls.from_model(model, device="cpu", **kw)), frames, boxes,
               flows)
    got = run(cls.from_model(model, device="cpu", **kw), frames, boxes, flows)
    _close(got, want)


def test_forwards_receive_the_bucket_of_the_valid_rows():
    """The rows each ensemble forward receives (a pre-hook, the count the
    benchmark's ensemble_valid_row_pct reads) are the bucket of the
    tick's box count, and a tick with no box runs no forward: the fleet,
    its device-time probe and push_many."""
    model = _model(43)
    frames, boxes, flows = _feed(11, 16)
    fleet = MultiCameraScorer.from_model(model, n_cameras=C, device="cpu")
    many = StreamingScorer.from_model(model, device="cpu")
    seen = []
    hooks = [s._forwards[0].register_forward_pre_hook(
        lambda m, a: seen.append(a[0].shape[0])) for s in (fleet, many)]

    def bucket(counts):
        return min(-(-sum(counts) // ROW_BUCKET) * ROW_BUCKET, len(counts) * K)

    try:
        _fleet_run(fleet, frames, boxes, flows)
        assert seen == [bucket(n) for n in TICKS if sum(n)]
        seen.clear()
        fleet.time_device_tick(frames[:C], _counts_boxes(boxes[:C], TICKS[0]),
                               k=2, repeats=1)
        assert seen == [bucket(TICKS[0])] * 3  # warm + k chained
        seen.clear()
        _push_many_run(many, frames, boxes, flows)
        assert seen == [bucket(n) for n in BATCHES if sum(n)]
    finally:
        for h in hooks:
            h.remove()
