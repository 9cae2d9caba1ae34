"""The port's CUDA kernels on the card, each held against its plain PyTorch
version (which the other test_torch_*.py files hold against vec_vad_tpu).

Every test here needs an NVIDIA GPU and nvcc: a CUDA kernel has no CPU
mode, so on a machine without a card they skip. This file imports torch
and vec_vad_torch only, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from vec_vad_torch import kernels
from vec_vad_torch.cli import make_flow_net
from vec_vad_torch.flow.trainer import FlowTrainer
from vec_vad_torch.models.flownet import make_flownet2
from vec_vad_torch.models.flownet import ops as tops

# f32: one dot of C products summed in another order, scaled by 1/C
F32 = dict(rtol=1e-5, atol=1e-6)
# bf16 out: both sides round one f32 sum, at most one bf16 ulp apart
BF16 = dict(rtol=2.0 ** -7, atol=1e-6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA kernels run on the card only")
    return torch.device("cuda")


@pytest.fixture
def full_f32():
    """cuDNN convolutions in full f32 (not TF32) for the test's duration."""
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def _pair(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,max_disp,stride", [
    ((1, 48, 64, 256), 20, 2),   # the serving shape
    ((8, 48, 64, 256), 20, 2),   # the training shape (FlowNetC conv3, batch 8)
    ((2, 13, 30, 48), 20, 2),    # ragged H, C != 256, W not a tile multiple
    ((3, 7, 70, 33), 4, 1),      # small displacement grid, odd C
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_correlation_kernel_matches_plain(cuda, shape, max_disp, stride, dtype):
    a, b = (torch.from_numpy(x).to(cuda, dtype) for x in _pair(7, shape))
    kernels.reset_launch_counts()
    got = tops.correlation(a, b, max_disp, stride)
    torch.cuda.synchronize()
    assert kernels.launch_counts["correlation"] == 1
    want = tops.correlation_ref(a, b, max_disp, stride)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(),
                               **(F32 if dtype == torch.float32 else BF16))


@pytest.mark.cuda
def test_correlation_kernel_refuses_what_it_cannot_run(cuda):
    a, b = (torch.from_numpy(x).to(cuda) for x in _pair(8, (1, 8, 8, 16)))
    with pytest.raises(ValueError, match="contiguous"):
        tops.correlation(a.transpose(1, 2), b.transpose(1, 2))
    with pytest.raises(TypeError):
        tops.correlation(a.half(), b.half())
    with pytest.raises(ValueError, match="CUDA device"):
        tops.correlation(a, b.cpu())
    # a correlation that needs a gradient runs its backward on the card
    x = a.clone().requires_grad_(True)
    tops.correlation(x, b).square().sum().backward()
    torch.cuda.synchronize()
    assert x.grad.shape == a.shape and torch.isfinite(x.grad).all()
    g = torch.ones((1, 8, 8, 441), device=cuda)
    with pytest.raises(TypeError):
        tops.correlation_bwd(a, b, g.bfloat16())
    with pytest.raises(ValueError, match="must be"):
        tops.correlation_bwd(a, b, g[..., :440])
    with pytest.raises(ValueError, match="CUDA device"):
        tops.correlation_bwd(a, b, g.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,max_disp,stride", [
    ((8, 48, 64, 256), 20, 2),   # the training shape (FlowNetC conv3, batch 8)
    ((2, 13, 30, 48), 20, 2),    # ragged H, C != 256, W not a tile multiple
    ((3, 7, 70, 33), 4, 1),      # small displacement grid, odd C
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_correlation_bwd_kernel_matches_plain(cuda, shape, max_disp, stride, dtype):
    """K2 against correlation_bwd_ref on the same inputs: f32 sums of
    n*n products in the same order, fused multiply-adds against separate
    ones -> a few ulp (F32); bf16 grads round one f32 sum -> one ulp."""
    a, b = (torch.from_numpy(x).to(cuda, dtype) for x in _pair(5, shape))
    n = 2 * max_disp // stride + 1
    g = torch.from_numpy(np.random.default_rng(6).normal(
        size=shape[:3] + (n * n,)).astype(np.float32)).to(cuda, dtype)
    kernels.reset_launch_counts()
    got = tops.correlation_bwd(a, b, g, max_disp, stride)
    torch.cuda.synchronize()
    assert kernels.launch_counts["correlation_bwd"] == 1
    want = tops.correlation_bwd_ref(a, b, g, max_disp, stride)
    for x, y in zip(got, want):
        assert x.dtype == dtype and x.shape == a.shape
        torch.testing.assert_close(x.float(), y.float(),
                                   **(F32 if dtype == torch.float32 else BF16))


@pytest.mark.cuda
def test_correlation_function_grads_match_cpu(cuda):
    """The autograd Function on the card (K1 forward, K2 backward, one
    launch each) gives the CPU path's cost volume and gradients."""
    a, b = _pair(7, (2, 13, 30, 48))
    g = np.random.default_rng(8).normal(size=(2, 13, 30, 441)).astype(np.float32)
    grads = []
    for dev in ("cpu", cuda):
        x, y = (torch.from_numpy(v).to(dev).requires_grad_(True) for v in (a, b))
        kernels.reset_launch_counts()
        out = tops.correlation(x, y)
        (out * torch.from_numpy(g).to(dev)).sum().backward()
        grads.append((out.detach().cpu(), x.grad.cpu(), y.grad.cpu()))
    torch.cuda.synchronize()
    assert dict(kernels.launch_counts) == {"correlation": 1, "correlation_bwd": 1}
    for got, want in zip(grads[1], grads[0]):
        torch.testing.assert_close(got, want, **F32)


@pytest.mark.cuda
def test_flownetc_training_step_matches_cpu(cuda, full_f32):
    """One FlowNetC multi-scale training step on the card (TF32 off) and
    on the CPU from the same seeded weights and batch: the loss within
    1e-4 relative, every parameter's gradient within 1e-3 of that
    tensor's largest |grad| (cuDNN and oneDNN sum ~30 f32 convolutions,
    forward and backward, in other orders; cuDNN's weight gradients use
    atomics), and K1 and K2 launched once each."""
    rng = np.random.default_rng(10)
    pairs = rng.uniform(0, 255, (2, 64, 64, 6)).astype(np.float32)
    target = rng.normal(0, 3, (2, 64, 64, 2)).astype(np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        tr = FlowTrainer(make_flow_net("FlowNetC", 3, dev), device=dev)
        kernels.reset_launch_counts()
        m = tr.step(pairs, target)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert dict(kernels.launch_counts) == {"correlation": 1,
                                                   "correlation_bwd": 1}
        out[dev] = (float(m["loss"]), {k: p.grad.cpu() for k, p in
                                       tr.net.named_parameters()})
    (loss_c, grads_c), (loss_g, grads_g) = out["cpu"], out["cuda"]
    assert np.isfinite(loss_g)
    assert abs(loss_g - loss_c) <= 1e-4 * abs(loss_c)
    for k, want in grads_c.items():
        err = float((grads_g[k] - want).abs().max())
        assert err <= 1e-3 * float(want.abs().max()), k


@pytest.mark.cuda
def test_flownet2_on_card_matches_cpu(cuda, full_f32):
    """The same seeded FlowNet2 on the card (K1 for its cost volume) and on
    the CPU (the plain version): within 1e-4 of the flow's largest
    magnitude, the bound the CPU tests hold the port to against JAX."""
    x = np.random.default_rng(9).uniform(0, 255, (1, 2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        want = make_flownet2(3, device="cpu")(torch.from_numpy(x)).numpy()
        kernels.reset_launch_counts()
        got = make_flownet2(3, device="cuda")(torch.from_numpy(x).to(cuda))
        torch.cuda.synchronize()
    assert kernels.launch_counts["correlation"] == 1
    got = got.cpu().numpy()
    assert np.isfinite(got).all()
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) <= 1e-4
