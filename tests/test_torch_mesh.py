"""The device mesh in the port (vec_vad_torch/parallel) and BlockTrainer
over it, held against vec_vad_tpu's BlockTrainer on a 2-device mesh
(get_mesh(jax.devices()[:2])) and the port's one-device run on the same
numpy-seeded cubes and weights, at nf=4, patch 16, batch 16, 2 epochs.

The port's mesh here is ["cpu", "cpu"]: two replicas on one device, so the
split, the lockstep BatchNorm exchange, the one backward, the gradient
reduction and the weight copies all run. One JAX trainer per mesh width
is reused across the file."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from test_torch_dataset_scale import BF16_CORR, BF16_LOSS_REL, BF16_MEAN_RATIO
from vec_vad_torch import config as t_config
from vec_vad_torch import pipeline as t_pipe
from vec_vad_torch import parallel as t_par
from vec_vad_torch.models.convert import completion_from_jax
from vec_vad_torch.models.layers import BatchNorm as TBatchNorm
from vec_vad_torch.train.grid_trainer import GridTrainer
from vec_vad_torch.train.trainer import BlockTrainer
from vec_vad_torch.utils import blocks as t_blocks
from vec_vad_tpu import config as j_config
from vec_vad_tpu import pipeline as j_pipe
from vec_vad_tpu.parallel import mesh as j_mesh
from vec_vad_tpu.utils import blocks as j_blocks

P, NF, BATCH, EPOCHS = 16, 4, 16, 2
N_CUBES = 40  # 3 batches an epoch, the last with 8 real rows of 16
MESH = ["cpu", "cpu"]
# losses: the same f32 sums cut over two replicas and added in another
# order; observed within 3e-8 relative of the one-device run
LOSS_REL = 1e-5
# training scores after the fit, relative: JAX's whole-pipeline bound is
# 0.12 %; tests/test_torch_main_path.py holds the port to JAX at 1e-3
SCORE_REL = 1e-3
# final weights, absolute: Adam divides each gradient by its own running
# magnitude, so a parameter whose gradient is near 0 moves by up to lr
# (1e-3) a step whichever way rounding tips it; 6 steps here. Observed
# 2.5e-3 against both references (the port's one-device run is 7.5e-4
# from JAX's)
WEIGHT_ATOL = 6e-3
# BatchNorm running statistics, relative to each tensor's largest value:
# they average batch statistics of activations that follow those weights.
# Observed 4.4e-3 against both (one device against JAX: 1.2e-3); a single
# layer's exchange is held to 1e-5 in test_batchnorm_statistics_are_global
STATS_REL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _configs(compute_dtype="float32", batch_size=BATCH):
    kw = dict(nf=NF, epochs=EPOCHS, batch_size=batch_size, context_frame_num=4,
              context_of_num=0, use_flow=False, compute_dtype=compute_dtype)
    return [c.PipelineConfig(dataset_name="UCSDped2",
                             fore=c.ForegroundConfig(patch_size=P, max_boxes_per_frame=8),
                             model=c.CompletionConfig(**kw))
            for c in (j_config, t_config)]


def _cubes(seed, n):
    return np.random.default_rng(seed).integers(0, 256, (n, P, P, 15), dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def _jax_trainer(n_dev, batch_size=BATCH):
    return j_pipe.make_trainer(_configs(batch_size=batch_size)[0],
                               j_mesh.get_mesh(jax.devices()[:n_dev]))


@functools.lru_cache(maxsize=None)
def _jax_fit(n_dev, batch_size=BATCH, n=N_CUBES):
    """JAX's fit_block from its init_state(0) on the mesh of n_dev
    devices, its per-step raw losses from the same scan and schedule, and
    the initial (params, batch_stats) as numpy trees."""
    jt = _jax_trainer(n_dev, batch_size)
    st = jt.init_state(0)
    params = jax.tree.map(np.asarray, st.params)
    stats = jax.tree.map(np.asarray, st.batch_stats)
    raw = _cubes(9, n)
    jb = jt.fit_block(raw, None, seed=0, init_state=st)
    tt = BlockTrainer(_configs(batch_size=batch_size)[1].model, P, device="cpu")
    idx, wmask = tt._epoch_schedule(n, np.random.default_rng(0))
    _, (loss_raw, _) = jt._train_scan(jt.init_state(0), jnp.asarray(raw),
                                      jnp.zeros((1, P, P, 2)), jnp.asarray(idx),
                                      jnp.asarray(wmask))
    return jb, np.asarray(loss_raw), params, stats


def _fit(mesh, compute_dtype="float32", batch_size=BATCH, n=N_CUBES):
    """The port's fit_block from JAX's init_state(0) on `mesh` (None: one
    device)."""
    _, _, params, stats = _jax_fit(2, batch_size, n)
    tt = BlockTrainer(_configs(compute_dtype, batch_size)[1].model, P, device="cpu",
                      mesh=mesh)
    tb = tt.fit_block(_cubes(9, n), None, seed=0,
                      init_state=tt.state_from_variables(params, stats))
    return tt, tb


def _rel(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))
                 / np.max(np.abs(want)))


# ---------------------------------------------------------------------------
# host helpers and the mesh itself
# ---------------------------------------------------------------------------


def test_host_helpers_equal_jax():
    """pad_to_multiple and calc_block_idx_batched: exactly JAX's, over
    ragged counts and every block mode."""
    rng = np.random.default_rng(0)
    empty = np.zeros((0, 3))
    for pad in (j_mesh.pad_to_multiple, t_par.pad_to_multiple):
        with pytest.raises(IndexError):  # an empty batch has no row to wrap
            pad([empty], 2)
    for n, m in ((1, 2), (3, 2), (4, 2), (5, 4), (7, 3), (6, 3)):
        a, b = rng.normal(size=(n, 3)), rng.integers(0, 9, (n, 2, 2))
        (ta, tb), tm = t_par.pad_to_multiple([a, b], m)
        (ja, jb), jm = j_mesh.pad_to_multiple([a, b], m)
        for got, want in ((ta, ja), (tb, jb), (tm, jm)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    x0, y0 = rng.uniform(-5, 60, (2, 50))
    boxes = np.stack([x0, y0, x0 + rng.uniform(0, 30, 50),
                      y0 + rng.uniform(0, 30, 50)], 1).astype(np.float32)
    for mode in (1, 2, 5, 9):
        for hb, wb in ((1, 1), (2, 2), (3, 4)):
            got = t_blocks.calc_block_idx_batched(boxes, 48 / hb, 64 / wb, mode, hb, wb)
            want = j_blocks.calc_block_idx_batched(boxes, 48 / hb, 64 / wb, mode, hb, wb)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_get_mesh_default_cards(monkeypatch):
    """get_mesh's default on a machine of four cards (torch.cuda's counts
    stood in for): a bare "cuda" is every card from cuda:0, a named card
    "cuda:k" its own one-entry mesh, as make_trainer and run_calc_flow
    take it; "cpu" is the CPU alone."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    cards = [torch.device("cuda", i) for i in range(4)]
    assert t_par.get_mesh().devices == tuple(cards)
    assert t_par.get_mesh(device="cuda").devices == tuple(cards)
    assert t_par.get_mesh(device="cuda:1").devices == (cards[1],)
    assert t_par.get_mesh(device=cards[2]).devices == (cards[2],)
    assert t_par.get_mesh(device="cpu").devices == (torch.device("cpu"),)


def test_mesh_split_reduce_and_replicas():
    """A mesh names devices in order, may repeat one, and gives each entry
    a replica of its own; shards cut as evenly as the rows allow, gather
    restores them, reduce_to_first sums in mesh order (differentiably),
    and run_replicas' all_reduce returns the same sum on every entry."""
    mesh = t_par.get_mesh(["cpu", "cpu", "cpu"])
    assert mesh.size == 3 and mesh.axis_name == "data"
    assert mesh == t_par.Mesh([torch.device("cpu")] * 3)
    assert t_par.get_mesh(device="cpu").devices == (torch.device("cpu"),)
    assert [hi - lo for lo, hi in t_par.shard_bounds(7, mesh)] == [3, 2, 2]
    assert [hi - lo for lo, hi in t_par.shard_bounds(2, mesh)] == [1, 1, 0]
    x = torch.arange(14.0).reshape(7, 2)
    parts = t_par.shard(x, mesh)
    assert [p.shape[0] for p in parts] == [3, 2, 2]
    torch.testing.assert_close(t_par.gather(parts, "cpu"), x, rtol=0, atol=0)
    vs = [torch.tensor([1.0, 2.0], requires_grad=True) for _ in range(3)]
    total = t_par.reduce_to_first([v * (i + 1) for i, v in enumerate(vs)], mesh)
    total.sum().backward()
    assert total.tolist() == [6.0, 12.0]
    assert [v.grad.tolist() for v in vs] == [[1.0, 1.0], [2.0, 2.0], [3.0, 3.0]]
    net = torch.nn.Linear(2, 2)
    reps = t_par.replicate(net, mesh)
    assert reps[0] is net and reps[1] is not net
    assert reps[1].weight.data_ptr() != net.weight.data_ptr()
    torch.testing.assert_close(reps[2].weight, net.weight, rtol=0, atol=0)
    got = t_par.run_replicas([lambda i=i: t_par.all_reduce(torch.tensor([float(i)]))
                              for i in range(3)], mesh)
    assert [g.item() for g in got] == [3.0, 3.0, 3.0]
    assert not t_par.in_mesh_step()

    def boom():
        raise KeyError("replica 1")

    with pytest.raises(KeyError, match="replica 1"):
        t_par.run_replicas([lambda: t_par.all_reduce(torch.ones(1)), boom,
                            lambda: t_par.all_reduce(torch.ones(1))], mesh)


def test_exchange_under_thread_switching():
    """Sixteen replica threads (more than this machine's cores) exchange
    200 times with the interpreter switching threads every microsecond:
    every exchange returns the sum of that round's values on every entry
    (a slot overwritten before the reduction read it would break that),
    and the run ends within its time limit."""
    import sys
    import threading

    n, rounds = 16, 200
    mesh = t_par.get_mesh(["cpu"] * n)

    def replica(i):
        return [t_par.all_reduce(torch.tensor([float(i + r)])).item()
                for r in range(rounds)]

    out = {}
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        runner = threading.Thread(target=lambda: out.setdefault("got", t_par.run_replicas(
            [lambda i=i: replica(i) for i in range(n)], mesh)), daemon=True)
        runner.start()
        runner.join(timeout=120)
    finally:
        sys.setswitchinterval(prev)
    assert not runner.is_alive() and "got" in out
    want = [float(n * r + n * (n - 1) // 2) for r in range(rounds)]
    assert all(got == want for got in out["got"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_batchnorm_statistics_are_global(dtype, masked):
    """Train-mode BatchNorm over two replicas' shares of a batch: the
    outputs, the gradient of a loss through them and the running
    statistics equal the one-layer forward on the whole batch."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(1.0, 2.0, (6, 4, 5, 5)).astype(np.float32)).to(dtype)
    w = torch.tensor([1.0, 1.0, 0.0, 1.0, 1.0, 0.0]) if masked else None
    g = torch.from_numpy(rng.normal(size=(6, 4, 5, 5)).astype(np.float32)).to(dtype)
    one = TBatchNorm(2, 2, device="cpu")
    with torch.no_grad():
        one.weight.copy_(torch.linspace(0.5, 1.5, 4))
        one.bias.copy_(torch.linspace(-1, 1, 4))
    mesh = t_par.get_mesh(MESH)
    reps = t_par.replicate(one, mesh)
    base = TBatchNorm(2, 2, device="cpu")
    base.load_state_dict(one.state_dict())

    xa = x.clone().requires_grad_()
    ya = base(xa, True, w)
    (ya.float() * g.float()).sum().backward()
    xb = x.clone().requires_grad_()
    xs, gs = t_par.shard(xb, mesh), t_par.shard(g, mesh)
    ws = t_par.shard(w, mesh)
    ys = t_par.run_replicas([lambda i=i: reps[i](xs[i], True, ws[i]) for i in range(2)],
                            mesh)
    t_par.reduce_to_first([(y.float() * gi.float()).sum() for y, gi in zip(ys, gs)],
                          mesh).backward()
    # bf16: the statistics round to bf16 after f32 sums accumulated in
    # another order, so they may sit one bf16 ulp (2^-7 relative) apart,
    # and the outputs and running statistics with them
    atol = 1e-5 if dtype == torch.float32 else 3e-2
    rtol = 1e-5 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(torch.cat(ys).float(), ya.float(), rtol=0, atol=atol)
    torch.testing.assert_close(xb.grad.float(), xa.grad.float(), rtol=0, atol=atol)
    for rep in reps:
        torch.testing.assert_close(rep.running_mean, base.running_mean, rtol=rtol, atol=1e-6)
        torch.testing.assert_close(rep.running_var, base.running_var, rtol=rtol, atol=1e-6)


# ---------------------------------------------------------------------------
# BlockTrainer over the mesh
# ---------------------------------------------------------------------------


def test_block_trainer_on_mesh_matches_jax_and_one_device():
    """fit_block on ["cpu", "cpu"] with a partial last batch an epoch:
    per-step losses, final weights, running statistics and training
    scores against JAX's BlockTrainer on its 2-device mesh and against the
    port's one-device fit."""
    jb, jloss, _, _ = _jax_fit(2)
    tt, tb = _fit(MESH)
    _, ob = _fit(None)
    assert len(tt._replicas) == 2 and tt._replicas[1] is not tt.net
    assert tb.losses.shape == jloss.shape == (EPOCHS * 3,)
    for want in (jloss, ob.losses):
        np.testing.assert_allclose(tb.losses, want, rtol=LOSS_REL)
    want = completion_from_jax(jb.params, jb.batch_stats)
    for ref in (want, ob.state_dict):
        for k, v in tb.state_dict.items():
            if "running" in k:
                assert _rel(v.numpy(), ref[k].numpy()) <= STATS_REL, k
            else:
                np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=0,
                                           atol=WEIGHT_ATOL, err_msg=k)
    for ref in (np.asarray(jb.raw_scores), ob.raw_scores):
        assert _rel(tb.raw_scores, ref) <= SCORE_REL
    # the replicas end every step equal to the first
    for a, b in zip(tt._replicas[0].state_dict().values(),
                    tt._replicas[1].state_dict().values()):
        assert torch.equal(a, b)


def test_batch_the_mesh_does_not_divide():
    """Batch 6 over 4 entries (shares of 2, 2, 1, 1), as JAX's sharded
    step takes a batch its mesh does not divide: the losses and training
    scores of JAX's 4-device fit and the port's one-device fit."""
    jb, jloss, _, _ = _jax_fit(4, 6, 10)
    _, tb = _fit(["cpu"] * 4, batch_size=6, n=10)
    _, ob = _fit(None, batch_size=6, n=10)
    for want in (jloss, ob.losses):
        np.testing.assert_allclose(tb.losses, want, rtol=LOSS_REL)
    for ref in (np.asarray(jb.raw_scores), ob.raw_scores):
        assert _rel(tb.raw_scores, ref) <= SCORE_REL


def test_bf16_block_trainer_on_mesh_tracks_one_device():
    """bf16 training on the mesh against the port's one-device bf16 fit:
    the first batch's loss within BF16_LOSS_REL, the training scores
    within the JAX package's bf16 bounds; the masters stay f32."""
    tt, tb = _fit(MESH, "bfloat16")
    _, ob = _fit(None, "bfloat16")
    assert abs(tb.losses[0] - ob.losses[0]) / abs(ob.losses[0]) <= BF16_LOSS_REL
    assert np.isfinite(tb.losses).all()
    a, b = ob.raw_scores, tb.raw_scores
    assert np.corrcoef(a, b)[0, 1] > BF16_CORR
    assert abs(b.mean() / a.mean() - 1.0) < BF16_MEAN_RATIO
    assert all(p.dtype == torch.float32 for r in tt._replicas for p in r.parameters())


def test_mesh_step_runs_one_backward(monkeypatch):
    """One mesh step calls torch.autograd.backward once (never once a
    replica), in the calling thread."""
    import threading

    calls = []
    real = torch.autograd.backward

    def counted(*a, **k):
        calls.append(threading.current_thread() is threading.main_thread())
        return real(*a, **k)

    monkeypatch.setattr(torch.autograd, "backward", counted)
    tt = BlockTrainer(_configs()[1].model, P, mesh=["cpu"] * 3)
    tt.start_fit(tt.init_state(0))
    x = torch.from_numpy(_cubes(1, BATCH)).float() / 255.0
    w = torch.ones(BATCH)
    losses = tt.train_step(x, None, w, None)
    assert calls == [True] and torch.isfinite(losses).all()


def test_one_entry_mesh_is_the_one_device_code():
    """make_trainer's default mesh on the CPU is the one entry of the
    CPU, and a one-entry trainer gives the one-device numbers bit for
    bit; the mesh reaches the grid trainer."""
    _, tcfg = _configs()
    tt = t_pipe.make_trainer(tcfg, device="cpu")
    assert tt.mesh == t_par.get_mesh(device="cpu") and tt._replicas == [tt.net]
    _, one = _fit(["cpu"])
    _, ob = _fit(None)
    np.testing.assert_array_equal(one.losses, ob.losses)
    np.testing.assert_array_equal(one.raw_scores, ob.raw_scores)
    mt = t_pipe.make_trainer(tcfg, mesh=MESH)
    gt = t_pipe._grid_trainer(tcfg, mt)
    assert isinstance(gt, GridTrainer) and gt.mesh == mt.mesh and len(gt._replicas) == 2


def test_score_block_on_mesh_gathers_rows_in_order():
    """score_block over three entries (an uneven last batch) equals the
    one-device scores."""
    tt, tb = _fit(["cpu"] * 3)
    raw = _cubes(4, 21)
    one = BlockTrainer(_configs()[1].model, P, device="cpu")
    got = tt.score_block(tb, raw, batch_size=8)
    want = one.score_block(tb, raw, batch_size=8)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_array_equal(got[1], want[1])
