"""The with_bn FlowNets held against vec_vad_tpu's: FlowNetC, FlowNetS,
FlowNetSD, FlowNetFusion and FlowNet2 built with BatchNorm, their JAX
weights and random BatchNorm statistics carried by
models.convert.flownet2_from_jax, in eval mode (running statistics) and
train mode (batch statistics, the running ones updated); a reference
checkpoint's BatchNorm keys (<m>.<conv>.1.*) loaded by both converters;
and FlowTrainer's refusal of a with_bn net, which JAX's FlowTrainer
cannot train either.

Bounds, of the largest |value| of each output (flow level, running
statistic): 1e-5 in eval mode, and in train mode for FlowNetC and
FlowNetFusion. In train mode a deep random net's batch statistics
magnify f32 rounding: the port's own f32 forward differs from its f64
forward (the same graph in float64) by up to 1.4e-5 for FlowNetSD and
6e-5 for FlowNet2, whose five nets feed each other's warps, and JAX's by
up to 6.9e-6 and 1.1e-4. There the port and JAX are each held to the f64
forward, and to each other, within 3e-5 (FlowNetS, FlowNetSD) and 3e-4
(FlowNet2)."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from vec_vad_torch.data.synthetic import make_synthetic_dataset
from vec_vad_torch.flow.trainer import FlowTrainer
from vec_vad_torch.models.convert import flownet2_from_jax
from vec_vad_torch.models.flownet import convert as t_convert
from vec_vad_torch.models.flownet import flownet2 as t_fn2
from vec_vad_torch.models.flownet import nets as t_nets
from vec_vad_tpu.flow.trainer import FlowTrainer as JFlowTrainer
from vec_vad_tpu.models.flownet import convert as j_convert
from vec_vad_tpu.models.flownet import flownet2 as j_fn2
from vec_vad_tpu.models.flownet import nets as j_nets

REL = 1e-5
# train mode, where f32 rounding through the batch statistics reaches the
# bound (module docstring)
TRAIN_REL = {"FlowNetC": REL, "FlowNetFusion": REL, "FlowNetS": 3e-5,
             "FlowNetSD": 3e-5, "FlowNet2": 3e-4}


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _fill(tree, rng, stats=False):
    """numpy values for a flax tree of ShapeDtypeStructs: xavier-uniform
    kernels, U(0, 1) biases, BatchNorm scale U(0.5, 1.5) and shift
    N(0, 0.1); statistics: mean N(0, 0.5), variance U(0.5, 2)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _fill(v, rng, stats)
        elif k == "kernel":
            kh, kw, i, o = v.shape
            bound = np.sqrt(6.0 / (kh * kw * (i + o)))
            out[k] = ((rng.random(v.shape, dtype=np.float32) * 2 - 1) * bound)
        elif stats:
            out[k] = (rng.normal(0, 0.5, v.shape) if k == "mean"
                      else rng.uniform(0.5, 2.0, v.shape)).astype(np.float32)
        elif k == "scale":
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif "scale" in tree:  # a BatchNorm's shift
            out[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
        else:
            out[k] = rng.random(v.shape, dtype=np.float32)
    return out


def _variables(jnet, x, seed):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jnet.init, jax.random.key(0), jnp.asarray(x))
    return {"params": _fill(shapes["params"], rng),
            "batch_stats": _fill(shapes["batch_stats"], rng, stats=True)}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _outputs(y):
    return [y] if isinstance(y, (torch.Tensor, jax.Array)) else list(y)


def _check_train(tnet, x, want, new_stats, rel):
    """One train-mode forward of the port's net in f32 and of its float64
    copy: the f32 outputs and updated running statistics against JAX's
    (`want`, `new_stats`), and both packages' against the f64 ones."""
    t64 = copy.deepcopy(tnet).double()
    with torch.no_grad():
        got = _outputs(tnet(torch.from_numpy(x), True))
        exact = _outputs(t64(torch.from_numpy(x).double(), True))
    want = _outputs(want)
    assert len(got) == len(want) == len(exact)
    for g, w, e in zip(got, want, exact):
        assert _rel(g.numpy(), w) <= rel
        assert _rel(g.numpy(), e.numpy()) <= rel
        assert _rel(np.asarray(w), e.numpy()) <= rel
    sd, sd64 = tnet.state_dict(), t64.state_dict()
    n = 0
    for path, w in _flat(new_stats):
        key = ".".join(path[:-1]) + (".running_mean" if path[-1] == "mean"
                                     else ".running_var")
        for got_k, want_k in ((sd[key], w), (sd[key], sd64[key]), (w, sd64[key])):
            assert _rel(np.asarray(got_k), np.asarray(want_k)) <= rel, key
        n += 1
    assert n > 0


NETS = {
    # name: (jax net, port net, input (B, H, W, C))
    "FlowNetC": (lambda: j_nets.FlowNetC(True, use_pallas_correlation=False),
                 lambda: t_nets.FlowNetC(True, device="cpu"), (2, 128, 128, 6)),
    "FlowNetS": (lambda: j_nets.FlowNetS(6, True),
                 lambda: t_nets.FlowNetS(6, True, device="cpu"), (2, 128, 128, 6)),
    "FlowNetSD": (lambda: j_nets.FlowNetSD(True),
                  lambda: t_nets.FlowNetSD(True, device="cpu"), (2, 128, 128, 6)),
    "FlowNetFusion": (lambda: j_nets.FlowNetFusion(True),
                      lambda: t_nets.FlowNetFusion(True, device="cpu"), (2, 32, 48, 11)),
}


@pytest.mark.parametrize("name", sorted(NETS))
def test_component_nets_with_bn_match_jax(name):
    """Each with_bn component net, JAX's weights and statistics carried
    over: eval mode's outputs; train mode's outputs and running
    statistics after one train-mode forward."""
    make_j, make_t, shape = NETS[name]
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    jnet = make_j()
    variables = _variables(jnet, x, seed=2)
    tnet = make_t()
    tnet.load_state_dict(flownet2_from_jax(variables), strict=True)
    assert sum(isinstance(m, torch.nn.BatchNorm2d) for m in tnet.modules()) > 0
    xt = torch.from_numpy(x)
    apply = jax.jit(jnet.apply, static_argnums=2, static_argnames="mutable")

    want = apply(variables, jnp.asarray(x), False)
    with torch.no_grad():
        got = tnet(xt, False)
    for g, w in zip(_outputs(got), _outputs(want)):
        assert _rel(g.numpy(), w) <= REL

    want, new = apply(variables, jnp.asarray(x), True, mutable=("batch_stats",))
    _check_train(tnet, x, want, new["batch_stats"], TRAIN_REL[name])


@pytest.fixture(scope="module")
def flownet2_bn():
    """FlowNet2(with_bn=True) with JAX's weights on 4 pairs of consecutive
    synthetic frames at 64x64 (smooth textures with moving squares)."""
    f = make_synthetic_dataset(n_train_videos=1, n_test_videos=1, frames_per_video=8,
                               frame_h=64, frame_w=64, seed=5).train_frames
    x = np.stack([f[i:i + 2] for i in range(4)]).astype(np.float32)
    jnet = j_fn2.FlowNet2(with_bn=True, use_pallas_correlation=False)
    variables = _variables(jnet, x[:1], seed=4)
    tnet = t_fn2.FlowNet2(with_bn=True, device="cpu").eval()
    tnet.load_state_dict(flownet2_from_jax(variables), strict=True)
    return jnet, variables, tnet, x


def test_flownet2_with_bn_matches_jax_in_eval_mode(flownet2_bn):
    jnet, variables, tnet, x = flownet2_bn
    want = jax.jit(jnet.apply)(variables, jnp.asarray(x[:1]))
    with torch.no_grad():
        got = tnet(torch.from_numpy(x[:1]))
    assert got.shape == (1, 64, 64, 2)
    assert _rel(got.numpy(), want) <= REL


def test_flownet2_with_bn_matches_jax_in_train_mode(flownet2_bn):
    """Batch 4 in train mode through all five nets: the fused flow and
    every net's updated running statistics."""
    jnet, variables, tnet, x = flownet2_bn
    want, new = jax.jit(lambda v, x: jnet.apply(v, x, True, mutable=("batch_stats",)))(
        variables, jnp.asarray(x))
    state = {k: v.clone() for k, v in tnet.state_dict().items()}
    try:
        _check_train(tnet, x, want, new["batch_stats"], TRAIN_REL["FlowNet2"])
    finally:
        tnet.load_state_dict(state)


def _reference_state(tnet) -> dict:
    """A reference-keyed state dict (<m>.<conv>.0.*, <m>.<conv>.1.*) of
    the port's net, without num_batches_tracked (the reference's files
    predate it)."""
    return {t_convert.reference_key(k): v.clone() for k, v in tnet.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def test_reference_bn_checkpoint_loads_in_both_converters(tmp_path):
    """A with_bn FlowNetS saved under the reference's keys, BatchNorm
    entries as <m>.<conv>.1.{weight, bias, running_mean, running_var}:
    the port's load_flownet_checkpoint and vec_vad_tpu's converter load
    the same values, and the two nets then agree in eval mode."""
    x = np.random.default_rng(5).normal(size=(1, 64, 64, 6)).astype(np.float32)
    jnet = j_nets.FlowNetS(6, True)
    src = t_nets.FlowNetS(6, True, device="cpu")
    src.load_state_dict(flownet2_from_jax(_variables(jnet, x, seed=6)))
    ref = _reference_state(src)
    assert "conv3.1.running_var" in ref and "conv3.0.weight" in ref
    path = str(tmp_path / "flownets_bn.pth")
    torch.save({"state_dict": ref}, path)

    dst = t_nets.FlowNetS(6, True, device="cpu")
    report = t_convert.load_flownet_checkpoint(dst, path)
    assert report["missing"] == [] and "conv6_1.1.running_mean" in report["matched"]
    for k, v in src.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(dst.state_dict()[k], v), k
    jvars, jreport = j_convert.load_flownet2_checkpoint(jnet, jnp.asarray(x), path)
    assert "conv6_1.1.weight" in jreport["matched"]
    carried = flownet2_from_jax(jvars)
    for k, v in dst.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(carried[k], v), k
    with torch.no_grad():
        got = dst(torch.from_numpy(x))
    want = jax.jit(jnet.apply)(jvars, jnp.asarray(x))
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= REL


def test_flow_trainer_refuses_with_bn_nets():
    """vec_vad_tpu's FlowTrainer applies {'params'} alone, so a with_bn
    net fails there for want of batch_stats; the port's FlowTrainer
    refuses one by name. Nets without BatchNorm still train."""
    pairs = np.random.default_rng(7).normal(size=(2, 64, 64, 6)).astype(np.float32)
    tgt = np.zeros((2, 64, 64, 2), np.float32)
    jtr = JFlowTrainer(j_nets.FlowNetS(6, with_bn=True))
    state = jtr.init_state(pairs)
    with pytest.raises(Exception, match="batch_stats"):
        jtr.step(state, pairs, tgt)
    for loss in ("multiscale", "single"):
        with pytest.raises(NotImplementedError, match="with_bn"):
            FlowTrainer(t_nets.FlowNetS(6, True, device="cpu"), loss=loss, device="cpu")
    with pytest.raises(NotImplementedError, match="with_bn"):
        FlowTrainer(t_fn2.FlowNet2CS(with_bn=True, device="cpu"), device="cpu")
    assert FlowTrainer(t_nets.FlowNetS(6, device="cpu"), device="cpu").device.type == "cpu"
