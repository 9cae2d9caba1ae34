"""vec_vad_torch.runtime.layer_profile on the CPU: the timing loop and its
rescaling of short windows, the shape table against the port's UNet, the
four ensemble layouts computing the same convolutions, the FLOP count
of one cube beside vec_vad_tpu's constant, and a smoke run of every
profile and of the module's entry point. The numbers only mean something
on the card (chip_smoke.py phase 13)."""

import pytest
import torch

from vec_vad_torch.config import CompletionConfig
from vec_vad_torch.models.completion import make_completion_net
from vec_vad_torch.models.layers import Conv
from vec_vad_torch.runtime import layer_profile as lp
from vec_vad_tpu.runtime import layer_profile as j_lp


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_timed_loop_basic():
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    ms, tps = lp.timed_loop(torch.mm, (a, b), 2.0 * 64**3, iters=5, repeats=1,
                            min_wall_s=0)
    assert ms > 0 and tps > 0


def test_timed_loop_rescales_subfloor_windows(monkeypatch):
    """A window shorter than min_wall_s is timed again with more calls
    until it is not (or max_iters); min_wall_s=0 disables the rescale.
    The spy mirrors vec_vad_tpu's test_timed_scan_rescales_subfloor_probes."""
    iters_seen = []
    orig = lp._time_window

    def spy(f, args, flops_once, iters, repeats):
        iters_seen.append(iters)
        return orig(f, args, flops_once, iters, repeats)

    monkeypatch.setattr(lp, "_time_window", spy)
    x = torch.ones(8)
    max_iters = 50_000
    ms, _ = lp.timed_loop(lambda x: x * 2.0, (x,), 0.0, iters=2, repeats=1,
                          min_wall_s=0.05, max_iters=max_iters)
    assert len(iters_seen) >= 2 and iters_seen[-1] > iters_seen[0]
    wall = ms * iters_seen[-1] / 1e3
    assert wall >= 0.04 or iters_seen[-1] == max_iters

    iters_seen.clear()
    lp.timed_loop(lambda x: x * 2.0, (x,), 0.0, iters=2, repeats=1, min_wall_s=0.0)
    assert iters_seen == [2]
    assert lp.MIN_WALL_S < j_lp.MIN_WALL_S  # no relay round trip on the card


def test_timed_window_counts_every_call():
    """Eager calls all run: `iters` calls a window plus one warm call."""
    calls = []
    lp._time_window(lambda x: calls.append(1), (torch.ones(1),), 0.0, 7, 3)
    assert len(calls) == 1 + 3 * 7


def test_unet_conv_shapes_match_the_ports_unet():
    """UNET_CONV_SHAPES is every 3x3 convolution of the port's flagship
    UNet (nf=32, patch 32, 5raw: 12 input channels a member) in the order
    it runs them, per member, and equals vec_vad_tpu's list."""
    assert lp.UNET_CONV_SHAPES == j_lp.UNET_CONV_SHAPES
    net = make_completion_net(CompletionConfig(nf=32, context_of_num=0, use_flow=False),
                              device="cpu")
    seen = []

    def hook(mod, inp, out):
        if mod.weight.shape[-1] == 3:
            seen.append((out.shape[-1], mod.in_ch, mod.features))

    hooks = [m.register_forward_hook(hook) for m in net.modules() if isinstance(m, Conv)]
    with torch.no_grad():
        net(torch.zeros(1, 32, 32, 15), None, False)
    for h in hooks:
        h.remove()
    assert seen == [s[1:] for s in lp.UNET_CONV_SHAPES]


def test_ensemble_formulations_compute_the_same_convolutions():
    """vmap, grouped and blockdiag give the same (E, B, C, H, W) output;
    sharedw_batch (member 0's weight for all) agrees on member 0."""
    out = lp.ensemble_formulation_outputs(batch=3, members=3, H=6, C=5, device="cpu")
    assert set(out) == {"vmap", "grouped", "blockdiag", "sharedw_batch"}
    ref = out["vmap"]
    assert ref.shape == (3, 3, 5, 6, 6)
    tol = 1e-5 * float(ref.abs().max())
    for name in ("grouped", "blockdiag"):
        assert float((out[name] - ref).abs().max()) <= tol, name
    assert float((out["sharedw_batch"][0] - ref[0]).abs().max()) <= tol
    assert float((out["sharedw_batch"][1:] - ref[1:]).abs().max()) > tol


def test_completion_flop_count_against_jax_constant():
    """The port counts one cube's forward at 1.546e9 FLOPs: 5 members (the
    raw-only net erases each of its 5 frames in turn; vec_vad_tpu's
    docstring says E=4), every tap including the zero padding's. Leaving
    out the padding's taps, as XLA's cost analysis does, gives 1.370e9,
    within 1% of vec_vad_tpu's FLAGSHIP_PER_CUBE_FWD_FLOPS = 1.378e9 (the
    rest is the non-convolution ops XLA also counts)."""
    assert lp.FLAGSHIP_PER_CUBE_FWD_FLOPS == j_lp.FLAGSHIP_PER_CUBE_FWD_FLOPS
    net = make_completion_net(CompletionConfig(nf=32, context_of_num=0, use_flow=False),
                              device="cpu")
    members = len(net.raw_positions)
    assert members == 5
    dense = lp.completion_fwd_flops(net)
    per_member_3x3 = sum(2 * h * h * 9 * ci * co for _, h, ci, co in lp.UNET_CONV_SHAPES)
    transposed = sum(2 * h * h * ci * (ci // 2) * 9 for h, ci in ((4, 256), (8, 128), (16, 64)))
    head = 2 * 32 * 32 * 32 * 3
    assert dense == members * (per_member_3x3 + transposed + head) == 1_546_321_920
    valid = lp.completion_fwd_flops(net, padding_taps=False)
    assert valid == 1_370_229_760
    assert abs(valid / lp.FLAGSHIP_PER_CUBE_FWD_FLOPS - 1) < 0.01
    assert abs(dense * 4 / 5 / lp.FLAGSHIP_PER_CUBE_FWD_FLOPS - 1) > 0.1  # not E=4


def test_profile_smoke_runs_and_table():
    shapes = [("tiny", 4, 3, 8)]
    table = lp.profile_unet_convs(batch=2, dtypes=(torch.float32, torch.bfloat16),
                                  iters=2, shapes=shapes, device="cpu", min_wall_s=0)
    assert set(table) == {"tiny"} and set(table["tiny"]) == {"float32", "bfloat16"}
    ms, tps = table["tiny"]["float32"]
    assert ms > 0 and tps >= 0
    txt = lp.format_table(table)
    assert "tiny" in txt and "float32 ms" in txt and "bfloat16 TF/s" in txt

    for dt in (torch.float32, torch.bfloat16):
        out = lp.profile_ensemble_formulations(batch=2, members=2, H=4, C=8, iters=2,
                                               device="cpu", dtype=dt, min_wall_s=0)
        assert set(out) == {"vmap", "grouped", "blockdiag", "sharedw_batch"}
        assert all(ms > 0 for ms, _ in out.values())

    for mode in ("fwd", "fwdbwd"):
        out = lp.profile_completion_program(batches=(2,), dtypes=(torch.float32,),
                                            mode=mode, iters=1, device="cpu",
                                            min_wall_s=0)
        assert set(out) == {f"{mode}_b2_float32"}
        assert out[f"{mode}_b2_float32"][0] > 0
    with pytest.raises(ValueError, match="mode"):
        lp.profile_completion_program(batches=(2,), mode="bwd", device="cpu")


def test_layout_kernels_are_the_benchmarks_patterns():
    """The layout kernels the CUDA test counts are the ones the
    benchmark's layout_pct reads; a CPU profile has no device kernels."""
    from torch.profiler import ProfilerActivity, profile

    from vadbench.metrics.layout_pct import PATTERNS

    assert lp.LAYOUT_KERNELS == PATTERNS
    assert lp.is_layout_kernel("void cudnn::engines_precompiled::nhwcToNchwKernel<float>")
    assert lp.is_layout_kernel("void at::native::genericTranspose<float>")
    assert not lp.is_layout_kernel("sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(4, 4).t().contiguous()
    assert lp.layout_time(prof) == {"device_ms": 0.0, "layout_ms": 0.0, "layout_pct": 0.0}


def test_entry_point_on_the_cpu(capsys):
    lp.main(["--ensemble", "--batch", "2", "--iters", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "grouped" in out and "bfloat16" in out and out.count("ms") == 8
