"""FlowNet2's ops in the port held against vec_vad_tpu on the same inputs:
the correlation plain versions (K1 forward, K2 backward reference), the
warp, channel norm, upsampling and the driver's cv2-parity resize. The
K1 CUDA kernel is held against its plain version in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from vec_vad_torch.flow.driver import resize_bilinear as t_resize
from vec_vad_torch.models.flownet import ops as tops
from vec_vad_tpu.flow.driver import resize_bilinear as j_resize
from vec_vad_tpu.models.flownet import ops as jops

# f32 sums in another order than XLA's: a few ulp of the 1/C-scaled output
F32 = dict(rtol=1e-5, atol=1e-6)
# bf16: both sides round the same f32 sum, which may sit on either side
# of a rounding boundary -> at most one bf16 ulp (relative 2^-8..2^-7)
BF16 = dict(rtol=2.0 ** -7, atol=1e-6)


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _pair(seed, shape=(2, 13, 30, 48)):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("max_disp,stride", [(20, 2), (4, 1)])
def test_correlation_ref_matches_jax(max_disp, stride):
    """Ragged H (13, not a multiple of the 8-row Pallas tile), C=48."""
    a, b = _pair(0)
    got = tops.correlation_ref(torch.from_numpy(a), torch.from_numpy(b),
                               max_disp, stride).numpy()
    want = np.asarray(jops.correlation_ref(a, b, max_disp, stride))
    n = 2 * max_disp // stride + 1
    assert got.shape == (2, 13, 30, n * n)
    np.testing.assert_allclose(got, want, **F32)
    # the Pallas kernel in interpret mode (cost grows with its grid: one
    # batch item, two 8-row tiles, the second one ragged)
    pal = np.asarray(jops.correlation_pallas(
        jnp.asarray(a[:1]), jnp.asarray(b[:1]), max_disp, stride,
        interpret=True,
    ))
    np.testing.assert_allclose(got[:1], pal, **F32)


def test_correlation_ref_bf16_in_bf16_out():
    a, b = _pair(1, (1, 9, 12, 32))
    at = torch.from_numpy(a).to(torch.bfloat16)
    bt = torch.from_numpy(b).to(torch.bfloat16)
    got = tops.correlation_ref(at, bt, 4, 2)
    assert got.dtype == torch.bfloat16
    want = jops.correlation_ref(jnp.asarray(a, jnp.bfloat16),
                                jnp.asarray(b, jnp.bfloat16), 4, 2)
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16)


@pytest.mark.parametrize("max_disp,stride", [(20, 2), (3, 1)])
def test_correlation_bwd_ref_matches_jax_and_autograd(max_disp, stride):
    a, b = _pair(2, (2, 11, 14, 8))
    n = 2 * max_disp // stride + 1
    g = np.random.default_rng(3).normal(size=(2, 11, 14, n * n)).astype(np.float32)
    ta, tb, tg = (torch.from_numpy(x) for x in (a, b, g))
    ga, gb = tops.correlation_bwd_ref(ta, tb, tg, max_disp, stride)
    ja, jb = jops.correlation_bwd_ref(jnp.asarray(a), jnp.asarray(b),
                                      jnp.asarray(g), max_disp, stride)
    np.testing.assert_allclose(ga.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gb.numpy(), np.asarray(jb), rtol=1e-5, atol=1e-6)
    # and both equal autograd through the plain forward
    ta.requires_grad_(True)
    tb.requires_grad_(True)
    torch.sum(tops.correlation_ref(ta, tb, max_disp, stride) * tg).backward()
    torch.testing.assert_close(ga, ta.grad, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(gb, tb.grad, rtol=1e-5, atol=1e-6)


def test_warp_bilinear_matches_jax_including_out_of_frame():
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 1, (2, 9, 11, 3)).astype(np.float32)
    flow = rng.uniform(-3, 3, (2, 9, 11, 2)).astype(np.float32)
    flow[0, :2] = 40.0  # far right/below the frame
    flow[1, -2:] = -25.0  # far left/above
    flow[1, 4, 5] = (10.5, -0.25)
    got = tops.warp_bilinear(torch.from_numpy(img), torch.from_numpy(flow))
    want = jops.warp_bilinear(jnp.asarray(img), jnp.asarray(flow))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    gb = tops.warp_bilinear(torch.from_numpy(img).bfloat16(),
                            torch.from_numpy(flow).bfloat16())
    assert gb.dtype == torch.bfloat16


def test_channel_norm_and_upsampling_match_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 6, 7, 5)).astype(np.float32)
    tx = torch.from_numpy(x)
    np.testing.assert_allclose(tops.channel_norm(tx).numpy(),
                               np.asarray(jops.channel_norm(x)),
                               rtol=1e-6, atol=1e-6)
    for ac in (False, True):
        got = tops.upsample_bilinear(tx, 4, ac).numpy()
        want = np.asarray(jops.upsample_bilinear(jnp.asarray(x), 4, ac))
        assert got.shape == (2, 24, 28, 5)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        tops.upsample_nearest(tx, 4).numpy(),
        np.asarray(jops.upsample_nearest(jnp.asarray(x), 4)),
    )


@pytest.mark.parametrize("src,dst", [((48, 64), (24, 32)), ((30, 40), (384 // 4, 512 // 4))])
def test_resize_bilinear_matches_jax_driver(src, dst):
    """The cv2-parity protocol resize, down and up."""
    rng = np.random.default_rng(6)
    frames = rng.integers(0, 256, (2,) + src + (3,), dtype=np.uint8)
    got = t_resize(torch.from_numpy(frames), *dst).numpy()
    want = np.asarray(j_resize(jnp.asarray(frames), *dst))
    assert got.dtype == np.float32 and got.shape == (2,) + dst + (3,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
