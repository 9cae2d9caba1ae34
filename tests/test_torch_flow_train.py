"""Flow training in the port held against vec_vad_tpu on the same inputs
and weights: K2's plain version against the TPU kernel itself (Pallas in
interpret mode), the autograd Function's gradients, the full-width
FlowNetC's multi-scale loss and every parameter's gradient, and five
scheduled Adam steps of FlowTrainer. K2 itself is held against its plain
version on the card in test_torch_cuda.py."""

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from flax import linen as fnn
from vec_vad_torch import kernels
from vec_vad_torch.flow.losses import multiscale_loss as t_multiscale
from vec_vad_torch.flow.trainer import FlowTrainer as TFlowTrainer
from vec_vad_torch.flow.trainer import PairMajorAdapter as TAdapter
from vec_vad_torch.models.convert import flownet2_from_jax
from vec_vad_torch.models.flownet import FlowNet2CS as TFlowNet2CS
from vec_vad_torch.models.flownet import FlowNetC as TFlowNetC
from vec_vad_torch.models.flownet import ops as tops
from vec_vad_tpu.flow.losses import multiscale_loss as j_multiscale
from vec_vad_tpu.flow.trainer import FlowTrainer as JFlowTrainer
from vec_vad_tpu.flow.trainer import PairMajorAdapter as JAdapter
from vec_vad_tpu.models.flownet import FlowNet2CS as JFlowNet2CS
from vec_vad_tpu.models.flownet import FlowNetC as JFlowNetC
from vec_vad_tpu.models.flownet import ops as jops

# the TPU kernel's own test bound (tests/test_flownet.py): f32 sums of the
# n*n displacement terms in another order
BWD_ATOL = 1e-5
# FlowNetC gradients: every parameter's gradient within 1e-4 of that
# tensor's largest |grad|. f32 convolutions (oneDNN vs XLA) summed in
# other orders through ~30 layers, forward and backward, then reduced over
# the batch and all pixels; the worst tensor here is at 5.0e-6.
GRAD_REL = 1e-4


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _fill(tree, rng):
    """numpy values for a flax param tree of ShapeDtypeStructs: xavier
    uniform kernels, U(0, 1) biases (the reference's init)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _fill(v, rng)
        elif k == "kernel":
            kh, kw, i, o = v.shape
            bound = np.sqrt(6.0 / (kh * kw * (i + o)))
            out[k] = (rng.random(v.shape, dtype=np.float32) * 2 - 1) * bound
        else:
            out[k] = rng.random(v.shape, dtype=np.float32)
    return out


def test_correlation_bwd_ref_matches_the_tpu_kernel():
    """correlation_bwd_ref against correlation_bwd_pallas itself (interpret
    mode, 4-row tiles over a ragged H of 9), and the port's autograd
    correlation on the CPU gives the same grads (no launch counted)."""
    rng = np.random.default_rng(0)
    shape, md, st = (2, 9, 10, 8), 4, 2
    n = 2 * md // st + 1
    a, b = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    g = rng.normal(size=shape[:3] + (n * n,)).astype(np.float32)
    pal_a, pal_b = jops.correlation_bwd_pallas(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(g), md, st,
        tile_h=4, interpret=True,
    )
    ga, gb = tops.correlation_bwd_ref(*(torch.from_numpy(x) for x in (a, b, g)),
                                      md, st)
    np.testing.assert_allclose(ga.numpy(), np.asarray(pal_a), atol=BWD_ATOL)
    np.testing.assert_allclose(gb.numpy(), np.asarray(pal_b), atol=BWD_ATOL)

    ta, tb = (torch.from_numpy(x).requires_grad_(True) for x in (a, b))
    kernels.reset_launch_counts()
    (tops.correlation(ta, tb, md, st) * torch.from_numpy(g)).sum().backward()
    assert sum(kernels.launch_counts.values()) == 0
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(pal_a), atol=BWD_ATOL)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(pal_b), atol=BWD_ATOL)


def test_flownetc_multiscale_loss_and_gradients_match_jax():
    """The full-width FlowNetC at 64x64, batch 2, same weights: the
    multi-scale L1 loss within 1e-5 relative, each parameter's gradient
    within GRAD_REL of its largest |grad|."""
    rng = np.random.default_rng(1)
    x = rng.uniform(-0.5, 0.5, (2, 64, 64, 6)).astype(np.float32)
    target = rng.normal(0, 4, (2, 64, 64, 2)).astype(np.float32)
    jnet = JFlowNetC(use_pallas_correlation=False)
    shapes = jax.eval_shape(jnet.init, jax.random.key(0), jnp.asarray(x), True)
    params = _fill(shapes["params"], rng)

    def jloss(p):
        return j_multiscale(jnet.apply({"params": p}, jnp.asarray(x), True),
                            jnp.asarray(target))[0]

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(params)
    want_grads = flownet2_from_jax({"params": want_grads})

    tnet = TFlowNetC(device="cpu")
    tnet.load_state_dict(flownet2_from_jax({"params": params}), strict=True)
    loss, _ = t_multiscale(tnet(torch.from_numpy(x), True), torch.from_numpy(target))
    loss.backward()
    loss = float(loss.detach())
    assert abs(loss - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    grads = dict(tnet.named_parameters())
    assert set(grads) == set(want_grads)
    for k, want in want_grads.items():
        got = grads[k].grad
        assert got is not None and got.shape == want.shape, k
        bound = GRAD_REL * float(want.abs().max())
        assert float((got - want).abs().max()) <= bound, k


class JTinyPyramidNet(fnn.Module):
    """tests/test_flow_harness.py's minimal 5-scale pyramid net."""

    @fnn.compact
    def __call__(self, pairs, train: bool):
        feats, pyramid = pairs / 255.0, []
        for k in range(6):
            feats = fnn.relu(fnn.Conv(8, (3, 3), strides=(2, 2), padding="SAME")(feats))
            if k >= 1:
                pyramid.append(fnn.Conv(2, (3, 3), padding="SAME")(feats))
        return pyramid


class TTinyPyramidNet(nn.Module):
    """The same net in torch: flax's SAME padding at stride 2 on even
    sizes pads one pixel after, none before."""

    def __init__(self):
        super().__init__()
        self.down = nn.ModuleList(nn.Conv2d(6 if k == 0 else 8, 8, 3, 2)
                                  for k in range(6))
        self.heads = nn.ModuleList(nn.Conv2d(8, 2, 3, 1, 1) for _ in range(5))

    def forward(self, pairs, train: bool = False):
        feats, pyramid = pairs.permute(0, 3, 1, 2) / 255.0, []
        for k, conv in enumerate(self.down):
            feats = F.relu(conv(F.pad(feats, (0, 1, 0, 1))))
            if k >= 1:
                pyramid.append(self.heads[k - 1](feats).permute(0, 2, 3, 1))
        return pyramid

    def load_flax(self, params):
        """flax auto-names: Conv_0 (k=0), then per k>=1 one down conv and
        its head, in creation order."""
        names = ["Conv_0"] + [f"Conv_{i}" for i in range(1, 11)]
        downs, heads = [names[0]] + names[1::2], names[2::2]
        with torch.no_grad():
            for conv, nm in zip(list(self.down) + list(self.heads), downs + heads):
                conv.weight.copy_(torch.from_numpy(
                    np.asarray(params[nm]["kernel"]).transpose(3, 2, 0, 1).copy()))
                conv.bias.copy_(torch.from_numpy(np.array(params[nm]["bias"])))

    def flat(self):
        return [p.detach().numpy().copy() for p in self.parameters()]


def test_trainer_scheduled_adam_steps_match_jax():
    """Five FlowTrainer steps with lr 2e-3 divided by 10 every 2 updates
    (optax's count: updates 0-1 at 2e-3, 2-3 at 2e-4, 4 at 2e-5): the same
    losses and weights within 1e-5."""
    rng = np.random.default_rng(2)
    batches = [(rng.uniform(0, 255, (4, 64, 64, 6)).astype(np.float32),
                rng.normal(0, 2, (4, 64, 64, 2)).astype(np.float32))
               for _ in range(5)]
    jtr = JFlowTrainer(JTinyPyramidNet(), learning_rate=2e-3,
                       schedule_lr_frequency=2, schedule_lr_fraction=10.0)
    state = jtr.init_state(batches[0][0], seed=0)
    tnet = TTinyPyramidNet()
    tnet.load_flax(state.params)
    ttr = TFlowTrainer(tnet, learning_rate=2e-3, schedule_lr_frequency=2,
                       schedule_lr_fraction=10.0, device="cpu")
    ttr.init_state()
    assert [ttr.learning_rate_at(k) for k in range(5)] == pytest.approx(
        [2e-3, 2e-3, 2e-4, 2e-4, 2e-5])
    for pairs, target in batches:
        state, jm = jtr.step(state, pairs, target)
        tm = ttr.step(pairs, target)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["epe"]), float(jm["epe"]), rtol=1e-5)
    ref = TTinyPyramidNet()
    ref.load_flax(state.params)
    for got, want in zip(tnet.flat(), ref.flat()):
        np.testing.assert_allclose(got, want, atol=1e-5)
    assert ttr.step_count == 5


def test_flownet2_from_jax_takes_the_adapter_tree():
    """A composite's params nested under the adapter's 'inner' scope load
    strictly into PairMajorAdapter(composite), and the two adapters agree."""
    rng = np.random.default_rng(3)
    pairs = rng.uniform(0, 255, (1, 64, 64, 6)).astype(np.float32)
    jnet = JAdapter(inner=JFlowNet2CS(use_pallas_correlation=False))
    shapes = jax.eval_shape(jnet.init, jax.random.key(0), jnp.asarray(pairs))
    params = _fill(shapes["params"], rng)
    sd = flownet2_from_jax({"params": params})
    assert all(k.startswith("inner.") for k in sd)
    tnet = TAdapter(TFlowNet2CS(device="cpu"))
    tnet.load_state_dict(sd, strict=True)
    want = np.asarray(jnet.apply({"params": params}, jnp.asarray(pairs)))
    with torch.no_grad():
        got = tnet(torch.from_numpy(pairs)).numpy()
    assert got.shape == want.shape == (1, 64, 64, 2)
    assert np.max(np.abs(got - want)) <= 1e-4 * np.max(np.abs(want))
