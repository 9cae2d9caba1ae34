"""FlowTrainer over the port's device mesh ["cpu", "cpu"], held to
vec_vad_tpu's FlowTrainer on a 2-device mesh and to the port's one-device
trainer, and the two repairs to flow tooling: FlowHarness.validate and
.infer run their nets with TF32 off (F1), and load_flownet_checkpoint
reports a with_bn file's missing convolution biases (F2).

The JAX comparison uses tests/test_torch_flow_train.py's tiny 5-scale
pyramid net (a FlowNet train step compiles for minutes on this CPU); the
full-width FlowNetC, whose cost volume runs K1's and K2's plain versions
here, is held to the port's one-device run."""

import warnings

import numpy as np
import pytest
import torch

import jax
from test_torch_flow_train import JTinyPyramidNet, TTinyPyramidNet
from test_torch_precision import ProbeFlow, _flags, tf32_on  # noqa: F401
from vec_vad_torch.flow.harness import FlowHarness
from vec_vad_torch.flow.trainer import FlowTrainer as TFlowTrainer
from vec_vad_torch.models.flownet import FlowNetC as TFlowNetC
from vec_vad_torch.models.flownet import init_flownet_
from vec_vad_torch.models.flownet import nets as t_nets
from vec_vad_torch.models.flownet.convert import load_flownet_checkpoint, reference_key
from vec_vad_tpu.flow.trainer import FlowTrainer as JFlowTrainer
from vec_vad_tpu.parallel.mesh import get_mesh

MESH = ["cpu", "cpu"]
# tests/test_torch_flow_train.py's bounds for the same steps on one device
LOSS_RTOL, WEIGHT_ATOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _batches(seed, b, n, hw=64):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0, 255, (b, hw, hw, 6)).astype(np.float32),
             rng.normal(0, 2, (b, hw, hw, 2)).astype(np.float32)) for _ in range(n)]


def test_flow_trainer_on_mesh_matches_jax_and_one_device():
    """Three scheduled Adam steps at batch 3 over two entries (padded to
    4, the pad row weighted 0): the losses, EPEs and weights of JAX's
    FlowTrainer on its 2-device mesh and of the port's one-device trainer;
    the replicas end each step equal."""
    batches = _batches(2, 3, 3)
    jtr = JFlowTrainer(JTinyPyramidNet(), learning_rate=2e-3, schedule_lr_frequency=2,
                       mesh=get_mesh(jax.devices()[:2]))
    state = jtr.init_state(batches[0][0], seed=0)
    nets = {}
    trainers = {}
    for name, mesh in (("mesh", MESH), ("one", None)):
        nets[name] = TTinyPyramidNet()
        nets[name].load_flax(state.params)
        trainers[name] = TFlowTrainer(nets[name], learning_rate=2e-3,
                                      schedule_lr_frequency=2, device="cpu", mesh=mesh)
        trainers[name].init_state()
    assert len(trainers["mesh"]._replicas) == 2
    for pairs, target in batches:
        state, jm = jtr.step(state, pairs, target)
        tm, om = (trainers[k].step(pairs, target) for k in ("mesh", "one"))
        for key in ("loss", "epe"):
            for want in (float(jm[key]), float(om[key])):
                np.testing.assert_allclose(float(tm[key]), want, rtol=LOSS_RTOL)
        for a, b in zip(*(r.parameters() for r in trainers["mesh"]._replicas)):
            assert torch.equal(a, b)
    ref = TTinyPyramidNet()
    ref.load_flax(state.params)
    for want in (ref.flat(), nets["one"].flat()):
        for got, w in zip(nets["mesh"].flat(), want):
            np.testing.assert_allclose(got, w, rtol=0, atol=WEIGHT_ATOL)


def test_flownetc_step_on_mesh_matches_one_device(monkeypatch):
    """The full-width FlowNetC at 64x64, batch 3 over two entries: two
    steps' losses and every weight against the one-device trainer (K1
    forward and K2 backward run their plain versions in both replicas);
    each step runs one backward."""
    batches = _batches(5, 3, 2)
    nets = [init_flownet_(TFlowNetC(device="cpu"), 3) for _ in range(2)]
    trainers = [TFlowTrainer(n, device="cpu", mesh=m) for n, m in zip(nets, (MESH, None))]
    calls = []
    real = torch.autograd.backward
    monkeypatch.setattr(torch.autograd, "backward",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for pairs, target in batches:
        got, want = (t.step(pairs, target) for t in trainers)
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=LOSS_RTOL)
    assert len(calls) == 4  # one a step, for each of the two trainers
    for (k, a), b in zip(nets[0].named_parameters(), nets[1].parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=0,
                                   atol=WEIGHT_ATOL, err_msg=k)


def test_flow_trainer_refuses_with_bn_by_its_queue_item():
    """The with_bn refusal names ROADMAP.md Queue 1 item 4 (not to be
    ported), mesh or no mesh."""
    for mesh in (None, MESH):
        with pytest.raises(NotImplementedError, match="item 4, not to be ported"):
            TFlowTrainer(t_nets.FlowNetS(6, True, device="cpu"), device="cpu", mesh=mesh)


# ---------------------------------------------------------------------------
# F1: the harness's validation and inference run with TF32 off
# ---------------------------------------------------------------------------


class _Pairs:
    """A flow dataset's `batches` over seeded arrays."""

    def __init__(self, n=5, hw=(24, 32)):
        rng = np.random.default_rng(6)
        self.pairs = rng.uniform(0, 255, (n,) + hw + (6,)).astype(np.float32)
        self.target = rng.normal(0, 1, (n,) + hw + (2,)).astype(np.float32)

    def batches(self, batch_size, shuffle=False):
        for lo in range(0, len(self.pairs), batch_size):
            yield self.pairs[lo:lo + batch_size], self.target[lo:lo + batch_size]


def test_harness_validate_and_infer_turn_tf32_off(tmp_path, tf32_on):  # noqa: F811
    """F1: with both TF32 flags left on by the caller, the net's forward
    reads them False during FlowHarness.validate and .infer (a padded
    last batch included), and the caller's flags come back."""
    net = ProbeFlow()
    harness = FlowHarness(TFlowTrainer(net, loss="single", device="cpu"),
                          str(tmp_path), loss="single")
    epe = harness.validate(_Pairs(), batch_size=2)
    assert np.isfinite(epe) and len(net.seen) == 3
    out = harness.infer(_Pairs(), batch_size=2, save_dir=str(tmp_path / "flo"))
    assert out["n"] == 5 and len(net.seen) == 6
    assert set(net.seen) == {(False, False)}
    assert _flags() == (True, True)


def test_flying_chairs_ppm_reads_without_cv2(tmp_path, monkeypatch):
    """FlyingChairs' binary .ppm frames read with numpy equal cv2.imread's
    (BGR), a header comment included, with cv2 unimportable, so
    flow-infer runs on a machine without cv2 (the card's)."""
    import sys

    import cv2

    from vec_vad_torch.flow import datasets as fds

    img = np.random.default_rng(8).integers(0, 256, (37, 53, 3), dtype=np.uint8)
    written = tmp_path / "00000-img_0.ppm"
    cv2.imwrite(str(written), img)
    commented = tmp_path / "commented.ppm"
    commented.write_bytes(b"P6\n# made by hand\n53 37\n255\n" + img[..., ::-1].tobytes())
    want = cv2.imread(str(written))
    monkeypatch.setitem(sys.modules, "cv2", None)
    for path in (written, commented):
        got = fds._imread(str(path))
        assert got.dtype == np.uint8 and got.flags.c_contiguous
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# F2: a with_bn file without convolution biases
# ---------------------------------------------------------------------------


def test_with_bn_file_without_conv_biases_is_reported(tmp_path):
    """F2: a reference-keyed with_bn FlowNetS file whose BatchNorm
    convolutions carry no bias: every absent <m>.<conv>.0.bias is listed
    in `missing` (beside an absent weight), a warning names them, those
    biases keep the net's values, and everything else loads. A complete
    file loads without a warning."""
    src = t_nets.FlowNetS(6, True, device="cpu")
    init_flownet_(src, 4)
    full = {reference_key(k): v.clone() for k, v in src.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    ref = {k: v for k, v in full.items() if not k.endswith(".0.bias")}
    dropped = sorted(set(full) - set(ref))
    assert "conv3_1.0.bias" in dropped and "deconv5.0.bias" in dropped
    del ref["conv6.0.weight"]
    path = str(tmp_path / "no_bias.pth")
    torch.save({"state_dict": ref}, path)
    dst = init_flownet_(t_nets.FlowNetS(6, True, device="cpu"), 9)
    before = {k: v.clone() for k, v in dst.state_dict().items()}
    with pytest.warns(UserWarning, match="BatchNorm convolutions .* no bias"):
        report = load_flownet_checkpoint(dst, path)
    assert sorted(report["missing"]) == sorted(dropped + ["conv6.0.weight"])
    for k, v in dst.state_dict().items():
        r = reference_key(k)
        if r in dropped or r == "conv6.0.weight":
            assert torch.equal(v, before[k]), k
        elif not k.endswith("num_batches_tracked"):
            assert torch.equal(v, full[r]), k
    torch.save({"state_dict": full}, path)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert load_flownet_checkpoint(t_nets.FlowNetS(6, True, device="cpu"),
                                       path)["missing"] == []
