"""The port's FlowNet nets held against vec_vad_tpu with the same weights:
JAX-side parameters are drawn with numpy in the flax tree's shapes and
carried across by models.convert.flownet2_from_jax; FlowNetC (the net
that holds the correlation kernel) and the whole FlowNet2 must agree on
a (1, 2, 64, 64, 3) input."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from vec_vad_torch.flow.driver import cast_flow_net
from vec_vad_torch.models.convert import flownet2_from_jax
from vec_vad_torch.models.flownet import FlowNet2 as TFlowNet2
from vec_vad_tpu.models.flownet import FlowNet2 as JFlowNet2
from vec_vad_tpu.models.flownet import FlowNetC as JFlowNetC

# max |port - jax| / max |jax| over each output: f32 convolutions summed
# in another order (oneDNN vs XLA) through ~40 layers
REL = 1e-4
REF_PARAM_COUNTS = {  # vec_vad_tpu tests/test_flownet.py, reference modules
    "flownetc": 39_175_298,
    "flownets_1": 38_695_322,
    "flownets_2": 38_695_322,
    "flownets_d": 45_371_666,
    "flownetfusion": 581_226,
}


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


@pytest.fixture(scope="module")
def flownet2():
    rng = np.random.default_rng(11)
    x = rng.uniform(0, 255, (1, 2, 64, 64, 3)).astype(np.float32)
    jnet = JFlowNet2(use_pallas_correlation=False)
    shapes = jax.eval_shape(jnet.init, jax.random.key(0), jnp.asarray(x))
    variables = {"params": _fill(shapes["params"], rng)}
    tnet = TFlowNet2(device="cpu").eval()
    tnet.load_state_dict(flownet2_from_jax(variables), strict=True)
    return jnet, variables, tnet, x


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def test_param_counts(flownet2):
    _, _, tnet, _ = flownet2
    assert sum(p.numel() for p in tnet.parameters()) == 162_518_834
    for name, n in REF_PARAM_COUNTS.items():
        assert sum(p.numel() for p in getattr(tnet, name).parameters()) == n


def test_flownetc_matches_jax(flownet2):
    """The five-level pyramid of FlowNetC, whose cost volume runs through
    `correlation` (the plain version here, the kernel on the card)."""
    _, variables, tnet, x = flownet2
    x6 = np.concatenate([x[:, 0], x[:, 1]], axis=-1) / 255.0
    want = JFlowNetC(use_pallas_correlation=False).apply(
        {"params": variables["params"]["flownetc"]}, jnp.asarray(x6)
    )
    with torch.no_grad():
        got = tnet.flownetc(torch.from_numpy(x6))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g.numpy(), np.asarray(w)) <= REL


def test_flownet2_matches_jax(flownet2):
    jnet, variables, tnet, x = flownet2
    want = np.asarray(jax.jit(jnet.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 64, 64, 2)
    assert np.isfinite(got).all()
    assert _rel(got, want) <= REL


def test_flownet2_bf16_copy(flownet2):
    """The bf16 serving recipe: a bf16 copy of the weights (the f32 net
    untouched) runs bf16 activations end to end, close to f32."""
    _, _, tnet, x = flownet2
    bnet = cast_flow_net(tnet, torch.bfloat16)
    assert next(tnet.parameters()).dtype == torch.float32
    assert next(bnet.parameters()).dtype == torch.bfloat16
    with torch.no_grad():
        yf = tnet(torch.from_numpy(x)).numpy()
        yb = bnet(torch.from_numpy(x).bfloat16())
    assert yb.dtype == torch.bfloat16
    assert _rel(yb.float().numpy(), yf) < 0.05  # bf16 quantization
