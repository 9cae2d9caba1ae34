"""The completion ensemble as built (its grouped chains channels_last, a
one-member chain NCHW, bf16 forwards NCHW) against a copy of the same
weights held NCHW-contiguous, on the CPU: the same outputs, loss,
gradients and updated running statistics within 1e-5 of their largest,
every convolution's and BatchNorm's input in its chain's layout (no
hidden copy drops it) and every convolution's weight in its input's,
while the copy's stay NCHW; and the state dict, the JAX-tree export and
the reference-format conversion giving the same arrays from either."""

import copy

import numpy as np
import pytest
import torch
from torch.func import functional_call

from vec_vad_torch.config import CompletionConfig
from vec_vad_torch.models.completion import init_completion_state, make_completion_net
from vec_vad_torch.models.completion_convert import convert_completion_state_dict
from vec_vad_torch.models.completion_export import export_completion_state_dict
from vec_vad_torch.models.convert import completion_from_jax, completion_to_jax
from vec_vad_torch.models import layers
from vec_vad_torch.models.layers import BatchNorm, Conv, ConvTranspose2x
from vec_vad_torch.train.grid_trainer import GridTrainer
from vec_vad_torch.train.trainer import BlockTrainer

P, K, REL = 16, 6, 1e-5
CL, NCHW = torch.channels_last, torch.contiguous_format


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cfg(use_flow=False):
    return CompletionConfig(nf=4, context_of_num=0, use_flow=use_flow)


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1e-30))


def _nets(use_flow=False, blocks=1):
    net = make_completion_net(_cfg(use_flow), "cpu", blocks)
    net.load_state_dict(init_completion_state(net, seed=3))
    return net, copy.deepcopy(net).to(memory_format=NCHW)


def _layout_hooks(unet, fmt, seen):
    """Pre-hooks recording, for every Conv, ConvTranspose2x and BatchNorm
    of a UNet, whether its input is contiguous in `fmt`."""
    def hook(mod, args):
        seen.append((type(mod).__name__, args[0].is_contiguous(memory_format=fmt)))

    return [m.register_forward_pre_hook(hook) for m in unet.modules()
            if isinstance(m, (Conv, ConvTranspose2x, BatchNorm))]


def _chains(net):
    return [u for u in (net.raw_unets, net.of_unets) if u is not None]


def _inputs(grid):
    rng = np.random.default_rng(7)
    lead = (1, K) if grid else (K,)
    x = torch.from_numpy(rng.uniform(0, 1, lead + (P, P, 15)).astype(np.float32))
    x_of = torch.from_numpy(rng.normal(0, 1, lead + (P, P, 2)).astype(np.float32))
    w = torch.tensor([1.0] * (K - 2) + [0.0, 0.0])
    return x, x_of, (w[None] if grid else w)


def _layout(t):
    return "cl" if t.is_contiguous(memory_format=CL) and not t.is_contiguous() else (
        "nchw" if t.is_contiguous() else "other")


def _record_conv_layouts(monkeypatch, calls):
    """Wrap the convolutions layers.py calls to record (input layout,
    weight layout) of each."""
    for name in ("conv2d", "conv_transpose2d"):
        fn = getattr(layers.F, name)

        def wrapped(x, w, *args, _fn=fn):
            calls.append((_layout(x), _layout(w) if w.shape[-1] > 1 else _layout(x)))
            return _fn(x, w, *args)

        monkeypatch.setattr(layers.F, name, wrapped)


def _run(net, case):
    """(outputs, loss) of one forward of `case` (and its backward, in
    train mode)."""
    grid = case == "grid"
    x, x_of, w = _inputs(grid)
    train = case != "eval"
    bw = w if case in ("train_weighted", "grid") else None
    if case == "bf16":  # BlockTrainer.loss's plain casts: channels_last bf16 weights
        params = {k: p.to(torch.bfloat16) for k, p in net.named_parameters()}
        out = functional_call(net, params, (x.bfloat16(), x_of.bfloat16(), True, bw))
    else:
        with torch.set_grad_enabled(train):
            out = net(x, x_of, train, bw)
    outs = [out.raw_out] + ([] if out.of_out is None else [out.of_out])
    tgts = [out.raw_tgt] + ([] if out.of_out is None else [out.of_tgt])
    loss = sum(((o - t.detach()).float().square().mean() for o, t in zip(outs, tgts)),
               torch.zeros(()))
    if train:
        loss.backward()
    return [o.detach().float() for o in outs], loss.detach()


@pytest.mark.parametrize("case", ["eval", "train", "train_weighted", "grid", "bf16",
                                  "flow_chain"])
def test_channels_last_matches_nchw(case, monkeypatch):
    """eval, train with and without a batch_weight, a blocks=2 grid net
    on its first block, bf16 training (plain bf16 casts of the
    channels_last parameters, as BlockTrainer.loss makes them: the layers
    still run it NCHW) and the two-stream net, whose one-member flow chain
    is built NCHW beside its channels_last raw chain: the net as built
    and its NCHW-held copy agree within 1e-5 of the largest on outputs,
    loss, gradients (the whole gradient's largest) and running
    statistics, and every convolution gets its weight in its input's
    layout."""
    net, ref = _nets(use_flow=case == "flow_chain", blocks=2 if case == "grid" else 1)
    assert net.raw_unets.memory_format(torch.float32) == CL
    assert ref.raw_unets.memory_format(torch.float32) == NCHW
    assert net.raw_unets.memory_format(torch.bfloat16) == NCHW
    for p in net.raw_unets.parameters():
        if p.dim() == 4:  # (a 1x1 kernel's weight is both)
            assert p.is_contiguous(memory_format=CL)
            assert p.shape[-1] == 1 or not p.is_contiguous()
    if case == "flow_chain":
        assert len(net.flow_positions) == 1
        assert net.of_unets.memory_format(torch.float32) == NCHW
    seen_cl, seen_nchw = [], []
    hooks = _layout_hooks(net.raw_unets, NCHW if case == "bf16" else CL, seen_cl)
    for u in _chains(net)[1:] + _chains(ref):
        hooks += _layout_hooks(u, NCHW, seen_nchw)
    calls = []
    _record_conv_layouts(monkeypatch, calls)
    try:
        outs, loss = _run(net, case)
        n = len(calls)
        want_outs, want_loss = _run(ref, case)
    finally:
        for h in hooks:
            h.remove()
    calls, ref_calls = calls[:n], calls[n:]
    want = "nchw" if case == "bf16" else "cl"
    assert calls and all(xl == wl for xl, wl in calls), calls
    assert sum(xl == want for xl, _ in calls) >= len(net.raw_unets.down) * 2
    assert ref_calls and all(c == ("nchw", "nchw") for c in ref_calls)
    assert seen_cl and all(ok for _, ok in seen_cl), [n for n, ok in seen_cl if not ok]
    assert seen_nchw and all(ok for _, ok in seen_nchw)
    assert {n for n, _ in seen_cl} == {"Conv", "ConvTranspose2x", "BatchNorm"}
    assert len(outs) == len(want_outs)
    for o, wo in zip(outs, want_outs):
        assert _rel(o, wo) <= REL
    assert _rel(loss, want_loss) <= REL
    if case == "eval":
        return
    # the gradient as one vector, against its largest entry: a DoubleConv's
    # convolution biases feed a train-mode BatchNorm, which takes the mean
    # out, so their gradient is 0 but for rounding
    top = max(float(q.grad.abs().max()) for q in ref.parameters())
    for (name, p), (_, q) in zip(net.named_parameters(), ref.named_parameters()):
        assert p.grad is not None, name
        assert float((p.grad - q.grad).abs().max()) <= REL * top, name
        for fmt in (CL, NCHW):  # the gradient in its weight's layout
            assert p.grad.is_contiguous(memory_format=fmt) == p.is_contiguous(
                memory_format=fmt), name
    for (name, b), (_, c) in zip(net.named_buffers(), ref.named_buffers()):
        assert _rel(b, c) <= REL, name


def test_state_export_and_conversion_same_arrays_from_either_layout():
    """The channels_last net's state dict holds the NCHW copy's values;
    its JAX trees (completion_to_jax), its reference-format export and the
    conversion back give the same arrays bit for bit, and load back into
    channels_last weights; BlockTrainer.state() and a grid's Adam moments
    come out in torch's default layout, the grid's parameters staying
    channels_last as views of its flat buffer."""
    net, ref = _nets(use_flow=True)
    sd, sd_ref = net.state_dict(), ref.state_dict()
    for k in sd_ref:
        assert torch.equal(sd[k], sd_ref[k]), k
    jp, js = completion_to_jax(sd)
    jp_ref, js_ref = completion_to_jax(sd_ref)
    flat = lambda tree: {k: v for k, v in _leaves(tree)}  # noqa: E731
    for a, b in ((flat(jp), flat(jp_ref)), (flat(js), flat(js_ref))):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    back = completion_from_jax(jp, js)
    for k in sd_ref:
        assert torch.equal(back[k], sd_ref[k]), k
    exp, exp_ref = export_completion_state_dict(sd, net), export_completion_state_dict(sd_ref, ref)
    assert exp.keys() == exp_ref.keys()
    for k in exp:
        assert torch.equal(exp[k], exp_ref[k]), k
    conv = convert_completion_state_dict(exp, net)
    for k in sd_ref:
        assert torch.equal(conv[k], sd_ref[k]), k
    fresh = make_completion_net(_cfg(True), "cpu")
    fresh.load_state_dict(back)
    w = fresh.raw_unets.down[0].conv0.weight
    assert w.is_contiguous(memory_format=CL) and not w.is_contiguous()

    bt = BlockTrainer(_cfg(), P, "cpu")
    bt.load_state(bt.init_state(0))
    for k, v in bt.state().items():
        assert v.is_contiguous() and torch.equal(v, bt.net.state_dict()[k]), k

    gt = GridTrainer(_cfg(), P, "cpu")
    rng = np.random.default_rng(1)
    blocks = [((0, 0, b), rng.integers(0, 256, (n, P, P, 15), dtype=np.uint8), None)
              for b, n in enumerate((9, 5))]
    fit = gt.prepare(blocks, gt.solo.init_state(0), 0)
    fit.step(0)
    for p in fit.adam.params:
        assert p.data_ptr() >= fit.adam.flat.data_ptr()
        if p.dim() == 4:
            assert p.is_contiguous(memory_format=CL)
    st = fit.adam.block_state(1)
    for n, p in fit.net.named_parameters():
        m = st["exp_avg"][n]
        assert m.is_contiguous() and m.shape == (p.shape[0] // 2,) + p.shape[1:]


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)
