"""The FlowNet2 family's other members in the port (FlowNet2C/2S/2SD/2CS/
2CSS) held against vec_vad_tpu with the same weights on a
(1, 2, 64, 64, 3) input, and reference-checkpoint loading held against
vec_vad_tpu's load_flownet2_checkpoint on the same file."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from vec_vad_torch.models import flownet as tflow
from vec_vad_torch.models.convert import flownet2_from_jax
from vec_vad_torch.models.flownet.convert import (
    load_flownet_checkpoint,
    reference_key,
)
from vec_vad_tpu.models import flownet as jflow

# max |port - jax| / max |jax| over each output: f32 convolutions summed
# in another order (oneDNN vs XLA), the bound test_torch_flownet.py uses
REL = 1e-4


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


def _jax_net(name):
    cls = getattr(jflow, name)
    if "use_pallas_correlation" in cls.__dataclass_fields__:
        return cls(use_pallas_correlation=False)
    return cls()


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("name", ["FlowNet2C", "FlowNet2S", "FlowNet2SD",
                                  "FlowNet2CS", "FlowNet2CSS"])
def test_composite_matches_jax(name):
    """Full-res flow (train=False) and, for the single-net wrappers, the
    training pyramid (train=True)."""
    rng = np.random.default_rng(20)
    x = rng.uniform(0, 255, (1, 2, 64, 64, 3)).astype(np.float32)
    jnet = _jax_net(name)
    shapes = jax.eval_shape(jnet.init, jax.random.key(0), jnp.asarray(x))
    variables = {"params": _fill(shapes["params"], rng)}
    tnet = getattr(tflow, name)(device="cpu")
    tnet.load_state_dict(flownet2_from_jax(variables), strict=True)
    for train in (False, True):
        want = jax.jit(jnet.apply, static_argnums=2)(variables, jnp.asarray(x), train)
        with torch.no_grad():
            got = tnet(torch.from_numpy(x), train)
        if name in ("FlowNet2CS", "FlowNet2CSS") or not train:
            assert got.shape == want.shape == (1, 64, 64, 2)
            got, want = [got], [want]
        else:
            assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            g = g.numpy()
            assert g.shape == w.shape and np.isfinite(g).all()
            assert _rel(g, np.asarray(w)) <= REL, (name, train)


def test_channel_norm_grad_matches_jax_and_is_finite_at_zero():
    """channel_norm's gradient equals vec_vad_tpu's autodiff one where no
    pixel is 0 (within 1e-6 of the largest: the reference kernel's 1e-9
    in the denominator), and is 0, as in the reference kernel, at a pixel
    that is 0 in every channel, where vec_vad_tpu's is NaN."""
    from vec_vad_torch.models.flownet import ops as tops
    from vec_vad_tpu.models.flownet import ops as jops

    rng = np.random.default_rng(22)
    x = rng.normal(size=(2, 5, 6, 3)).astype(np.float32)
    w = rng.normal(size=(2, 5, 6, 1)).astype(np.float32)
    x[0, 1, 2] = 0.0
    want = np.asarray(jax.grad(lambda v: jnp.sum(jops.channel_norm(v) * w))(jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_(True)
    norm = tops.channel_norm(t)
    (norm * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(norm.detach().numpy(), np.asarray(jops.channel_norm(x)),
                               rtol=1e-6)
    got = t.grad.numpy()
    assert np.isnan(want[0, 1, 2]).all() and (got[0, 1, 2] == 0).all()
    keep = np.ones(x.shape[:3], bool)
    keep[0, 1, 2] = False
    assert np.isfinite(got).all()
    assert np.max(np.abs(got[keep] - want[keep])) <= 1e-6 * np.max(np.abs(want[keep]))


def test_warp_with_nan_flow_stays_in_bounds():
    """A NaN in the flow makes that pixel's warp NaN and leaves the rest
    equal to vec_vad_tpu's warp, with the gather in bounds (on the card
    an out-of-range index is a device-side assert)."""
    from vec_vad_torch.models.flownet import ops as tops
    from vec_vad_tpu.models.flownet import ops as jops

    rng = np.random.default_rng(23)
    img = rng.uniform(0, 255, (1, 6, 7, 3)).astype(np.float32)
    flow = rng.normal(0, 3, (1, 6, 7, 2)).astype(np.float32)
    flow[0, 2, 3, 0] = np.nan
    got = tops.warp_bilinear(torch.from_numpy(img), torch.from_numpy(flow)).numpy()
    want = np.asarray(jops.warp_bilinear(jnp.asarray(img), jnp.asarray(flow)))
    assert np.isnan(got[0, 2, 3]).all()
    keep = np.ones(img.shape[:3], bool)
    keep[0, 2, 3] = False
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6, atol=1e-4)


def test_reference_checkpoint_loads_like_jax(tmp_path):
    """A .pth.tar in the reference's key layout ('state_dict' entry,
    <m>.<conv>.0.* keys, one BatchNorm entry the nets lack, one conv
    missing): the port loads the same tensors as vec_vad_tpu, reports the
    same matched keys and the same missing weight (and the missing conv's
    bias besides), and leaves the missing conv as it was."""
    rng = np.random.default_rng(21)
    x = np.zeros((1, 2, 64, 64, 3), np.float32)
    jnet = _jax_net("FlowNet2CS")
    shapes = jax.eval_shape(jnet.init, jax.random.key(0), jnp.asarray(x))
    src = flownet2_from_jax({"params": _fill(shapes["params"], rng)})
    ref_sd = {reference_key(k): v for k, v in src.items()}
    assert "flownetc.conv1.0.weight" in ref_sd
    assert "flownetc.deconv5.0.weight" in ref_sd
    assert "flownets_1.predict_flow2.weight" in ref_sd
    dropped = ("flownets_1.conv6_1.0.weight", "flownets_1.conv6_1.0.bias")
    for k in dropped:
        del ref_sd[k]
    ref_sd["flownetc.conv1.1.running_mean"] = torch.zeros(64)
    path = tmp_path / "FlowNet2-CS_checkpoint.pth.tar"
    torch.save({"epoch": 3, "best_EPE": 1.5, "state_dict": ref_sd}, path)

    variables, jrep = jflow.load_flownet2_checkpoint(jnet, jnp.asarray(x), str(path))
    tnet = tflow.init_flownet_(tflow.FlowNet2CS(device="cpu"), 0)
    before = tnet.flownets_1.conv6_1.conv.weight.detach().clone()
    trep = load_flownet_checkpoint(tnet, str(path))
    assert sorted(trep["matched"]) == sorted(jrep["matched"])
    # vec_vad_tpu lists the absent weight only; the port lists its bias too
    assert jrep["missing"] == [dropped[0]]
    assert trep["missing"] == list(dropped)
    want = flownet2_from_jax(variables)
    for k, v in tnet.state_dict().items():
        if reference_key(k) in dropped:
            continue
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
    torch.testing.assert_close(tnet.flownets_1.conv6_1.conv.weight, before,
                               rtol=0, atol=0)
    # a bare state dict (no 'state_dict' entry) loads the same way
    torch.save(ref_sd, tmp_path / "bare.pth")
    bare = load_flownet_checkpoint(tflow.FlowNet2CS(device="cpu"),
                                   str(tmp_path / "bare.pth"))
    assert bare == trep
