"""Per-block training of the completion ensemble
(vec_vad_tpu/train/trainer.py:69-158, 159-651), on one device or data
parallel over a device mesh.

Reference semantics (train.py:240-437):
  * per (scene, h, w) block with >1 cubes: fresh model, Adam(lr=1e-3,
    eps=1e-7, weight_decay=0), `epochs` passes over shuffled batches of
    `batch_size`, loss = lambda_raw*MSE(raw) + lambda_of*MSE(of) with
    detached targets (train.py:307-314), MSE(raw) alone without a flow head
  * afterwards one unshuffled eval-mode forward pass collecting per-cube
    (raw, of) scores: squared error summed over (members, H, W, channels)
    (train.py:349-355), whose mean/std later z-normalize test scores
    (test.py:264-266)

The batch schedule is the JAX package's, drawn from the same
`np.random.default_rng(seed)`: every epoch's permutation in the same
order, each epoch wrap-padded to a batch multiple with `np.resize` and
zero-weight slots (`_epoch_schedule`). A block's cubes go to the device
once, as uint8, and each batch is gathered and scaled there; its flow
cubes go up once beside them as float32 (never quantised) and are gathered
with the same index. The masked loss equals torch MSELoss over the
unpadded batch, and with masked_bn the pad mask also drives BatchNorm's
statistics, so a wrap-padded final batch trains like the reference's bare
partial batch.

A two-stream block fitted without flow inputs trains and scores its flow
head against zero targets and keeps of_scores=None, as the JAX package
does (its 1-row zero dummy read through a clamped index).

compute_dtype="bfloat16" trains as the JAX package's make_loss_fn does
(vec_vad_tpu/train/trainer.py:84-117): inside the loss the f32 master
parameters (BatchNorm's scale and bias too) are cast to bf16 copies, the
cast differentiated, so the gradients and Adam's state stay f32; x and
x_of are cast to bf16, BatchNorm's batch statistics come out in bf16
(models/layers.py) while its running statistics stay f32, and the errors
are cast back to f32 before the masked mean. The casts are explicit
(torch.func.functional_call over the bf16 copies), not torch.autocast,
whose cast points differ. The training-score pass after the fit runs in
f32 whatever the compute dtype, as make_score_step does.

Many blocks train together, folded into one network, in
train/grid_trainer.py (GridTrainer), which reuses this trainer's init and
schedule. `fit_block_budget` itemises a fit_block's wall by phase.

On a device mesh of n > 1 entries (`mesh=`, vec_vad_tpu's data sharding)
each entry holds a replica of the net and each step's batch (already
wrap-padded to batch_size with its mask) is cut into n contiguous shares,
as even as the batch allows (a batch the mesh does not divide is cut
unevenly: JAX's sharded step takes it whole too). The replicas' forwards
run in lockstep threads (parallel.mesh.run_replicas) whose BatchNorms
take the whole batch's statistics; each replica's loss is its rows'
weighted sum over the GLOBAL weight, and ONE backward runs over the sum
of the replicas' losses (reduced onto the first entry in mesh order).
The gradients are summed onto the first replica, Adam steps there, and
its parameters and running statistics are copied to the others, so a
step is the one-device step on the whole batch, as JAX's SPMD step is.
Scoring cuts each batch's rows over the replicas and gathers the scores
in order. A mesh of one entry runs the one-device code.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import time

import numpy as np
import torch
import torch.nn as nn
from torch.func import functional_call

from vec_vad_torch.config import CompletionConfig
from vec_vad_torch.device import full_f32, resolve_device, resolve_dtype
from vec_vad_torch.models.completion import make_completion_net
from vec_vad_torch.models.convert import completion_from_jax
from vec_vad_torch.parallel.mesh import (
    as_mesh,
    copy_from_first,
    gather,
    reduce_grads_to_first,
    reduce_to_first,
    replicate,
    run_replicas,
    shard,
)
from vec_vad_torch.pipeline import TrainedBlock, to_device
from vec_vad_torch.runtime.profiling import annotate

State = Dict[str, torch.Tensor]
Cubes = Union[np.ndarray, torch.Tensor]


def _masked_mean_sq(err: torch.Tensor, w: torch.Tensor,
                    w_total: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean of err^2 over everything, weighting batch elements by w.

    err is (E, B, P, P, C); w is (B,). Equals torch MSELoss (mean) over the
    unpadded batch when w is the 0/1 pad mask. w_total: the weight the
    sum is divided by when the rows are one replica's share of a batch
    (the whole batch's, at least 1); default w's own."""
    per_elem = err.square().mean(dim=(0, 2, 3, 4))  # (B,)
    if w_total is None:
        w_total = torch.clamp(w.sum(), min=1.0)
    return (per_elem * w).sum() / w_total


def _cube_scores(err: torch.Tensor) -> torch.Tensor:
    """Per-cube squared error summed over (members, H, W, C) — the
    reference's channel-concatenated MSE sum (train.py:349-355)."""
    return err.square().sum(dim=(0, 2, 3, 4))


def _quantize_u8(raw):
    """[0, 1] float cubes -> the uint8 levels the schedule trains on; a
    tensor (a device-resident CubeSet's rows) stays where it is."""
    if isinstance(raw, torch.Tensor):
        if raw.dtype == torch.uint8:
            return raw
        return torch.clamp(torch.round(raw * 255.0), 0, 255).to(torch.uint8)
    if raw.dtype == np.uint8:
        return raw
    return np.clip(np.round(raw * 255.0), 0, 255).astype(np.uint8)


class BlockTrainer(nn.Module):
    """Trains and scores completion-net blocks on one device or over a
    device mesh: one net, re-initialised for every block, and a fresh
    torch Adam per fit."""

    def __init__(self, cfg: CompletionConfig, patch_size: int = 32,
                 device="cuda", mesh=None):
        """mesh: a parallel.mesh.Mesh (or a list of devices, which may
        repeat one) to train data-parallel over (module docstring); the
        trainer then lives on its first entry. None or one entry: `device`."""
        super().__init__()
        self.cfg = cfg
        self.patch_size = patch_size
        if mesh is not None:
            mesh = as_mesh(mesh)
            device = mesh.devices[0]
        self.mesh = mesh
        self.device = resolve_device(device)
        self.compute_dtype = resolve_dtype(cfg.compute_dtype)
        self.net = make_completion_net(cfg, self.device)
        self.opt: Optional[torch.optim.Adam] = None
        # one net a mesh entry, self.net first (a plain list: the replicas
        # are not submodules, so the state dict is the one net's)
        self._replicas = (replicate(self.net, mesh)
                          if mesh is not None and mesh.size > 1 else [self.net])

    # -- state --------------------------------------------------------------

    def init_state(self, seed: int) -> State:
        """torch's default initialisation drawn from a CPU torch.Generator
        seeded with `seed` (the same weights on every device): conv and
        transposed-conv weights and biases U(±1/sqrt(fan_in)), fan_in the
        product of the weight's dims 1..3 (torch's rule for both, so
        I*k*k and O*k*k); BatchNorm scale 1, bias 0, running stats (0, 1)."""
        g = torch.Generator().manual_seed(int(seed))
        out = {}
        for name, t in self.net.state_dict().items():
            layer, leaf = name.rsplit(".", 1)
            if leaf == "running_mean":
                v = torch.zeros(t.shape)
            elif leaf == "running_var":
                v = torch.ones(t.shape)
            elif layer.rsplit(".", 1)[-1].startswith("bn"):
                v = torch.ones(t.shape) if leaf == "weight" else torch.zeros(t.shape)
            else:
                fan = int(np.prod(self.net.get_parameter(f"{layer}.weight").shape[1:]))
                bound = 1.0 / np.sqrt(fan)
                v = (torch.rand(t.shape, generator=g) * 2.0 - 1.0) * bound
            out[name] = v
        return out

    def state_from_variables(self, params, batch_stats) -> State:
        """A state from the JAX package's (params, batch_stats) trees — its
        initial or trained weights, for parity runs and checkpoint import."""
        return completion_from_jax(params, batch_stats)

    def load_state(self, state: Union[State, TrainedBlock]) -> None:
        """Weights and running statistics into the net (strict)."""
        sd = state.state_dict if isinstance(state, TrainedBlock) else state
        self.net.load_state_dict(sd)
        copy_from_first(self._replicas)

    def start_fit(self, state: State) -> None:
        """Load `state` and put a fresh Adam around it (optax's adam:
        eps outside the square root, bias-corrected moments)."""
        self.load_state(state)
        self.opt = torch.optim.Adam(
            self.net.parameters(), lr=self.cfg.learning_rate,
            eps=self.cfg.adam_eps, foreach=True,
        )

    def state(self) -> State:
        """The net's weights and running statistics, copied to the host
        (contiguous: the channels_last weights' values in torch's default
        layout)."""
        return {k: v.detach().to("cpu", copy=True, memory_format=torch.contiguous_format)
                for k, v in self.net.state_dict().items()}

    # -- one step -----------------------------------------------------------

    def as_float_input(self, xb: torch.Tensor) -> torch.Tensor:
        """uint8 cube storage -> ToTensor-scaled float input, on the
        device; float cubes pass unscaled."""
        if xb.dtype == torch.uint8:
            return xb.float() / 255.0
        return xb.float()

    def loss(self, x: torch.Tensor, x_of: Optional[torch.Tensor],
             w: torch.Tensor, batch_weight: Optional[torch.Tensor] = None,
             net: Optional[nn.Module] = None,
             w_total: Optional[torch.Tensor] = None,
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(loss, loss_raw, loss_of) of one batch (train-mode forward: it
        updates the BatchNorm running statistics). x_of: the batch's flow
        cubes, read only by a flow head; without one the loss is loss_raw
        and loss_of is 0. A bf16 compute dtype runs the forward on bf16
        copies of the parameters and inputs (module docstring). net and
        w_total: a mesh replica and the whole batch's weight, for one
        replica's share of a batch (default: self.net, the batch's own)."""
        dt = self.compute_dtype
        net = net if net is not None else self.net
        if dt == torch.float32:
            out = net(x, x_of, True, batch_weight)
        else:
            params = {k: p.to(dt) for k, p in net.named_parameters()}
            out = functional_call(net, params, (
                x.to(dt), None if x_of is None else x_of.to(dt), True, batch_weight))
        loss_raw = _masked_mean_sq((out.raw_out - out.raw_tgt.detach()).float(), w,
                                   w_total)
        if out.of_out is None:
            return loss_raw, loss_raw, torch.zeros_like(loss_raw)
        loss_of = _masked_mean_sq((out.of_out - out.of_tgt.detach()).float(), w,
                                  w_total)
        cfg = self.cfg
        return cfg.lambda_raw * loss_raw + cfg.lambda_of * loss_of, loss_raw, loss_of

    def train_step(self, x: torch.Tensor, x_of: Optional[torch.Tensor],
                   w: torch.Tensor,
                   batch_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One Adam step on one batch (train.py:383-402); returns
        (loss, loss_raw, loss_of) as one (3,) device tensor (no host sync).
        On a mesh: the data-parallel step of the module docstring."""
        if len(self._replicas) > 1:
            return self._mesh_step(x, x_of, w, batch_weight)
        losses = self.loss(x, x_of, w, batch_weight)
        self.opt.zero_grad(set_to_none=True)
        losses[0].backward()
        self.opt.step()
        return torch.stack(losses).detach()

    def _mesh_step(self, x, x_of, w, batch_weight) -> torch.Tensor:
        """train_step over the mesh: the batch's rows cut over the
        replicas, their forwards in lockstep, one backward over the sum of
        their losses, the gradients reduced onto the first replica, Adam
        there, the weights copied out."""
        mesh = self.mesh
        xs, obs, ws, bws = (shard(t, mesh) for t in (x, x_of, w, batch_weight))
        w_total = torch.clamp(w.sum(), min=1.0)
        per = run_replicas([
            (lambda i=i: self.loss(xs[i], obs[i], ws[i], bws[i], self._replicas[i],
                                   w_total.to(mesh.devices[i])))
            for i in range(mesh.size)], mesh)
        losses = [reduce_to_first([p[k] for p in per], mesh) for k in range(3)]
        self.opt.zero_grad(set_to_none=True)
        losses[0].backward()
        reduce_grads_to_first(self._replicas, mesh)
        self.opt.step()
        copy_from_first(self._replicas)
        return torch.stack(losses).detach()

    # -- host-side loops ----------------------------------------------------

    def upload(self, raw) -> torch.Tensor:
        """Cubes (numpy or tensor) onto the trainer's device, dtype kept."""
        return to_device(raw, self.device)

    def upload_flow(self, of_inputs, raw_shape) -> Optional[torch.Tensor]:
        """The flow rows a batch's x_of is gathered from, on the device:
        of_inputs as float32; when a flow head fires without flow inputs,
        one zero row (the JAX package's 1-row dummy: every clamped read of
        it is zeros); None when no flow head fires."""
        if self.net.of_unets is None:
            return None
        if of_inputs is None:
            n_of = self.net.tot_of_num * self.net.of_channels
            return torch.zeros((1,) + tuple(raw_shape[1:-1]) + (n_of,),
                               device=self.device)
        return self.upload(of_inputs).float()

    @staticmethod
    def flow_rows(of_buf: Optional[torch.Tensor],
                  ii: torch.Tensor) -> Optional[torch.Tensor]:
        """Rows ii of a flow buffer, indices clamped to its last row
        (jnp.take of jnp.minimum(ii, n - 1), as the JAX package reads)."""
        if of_buf is None:
            return None
        return of_buf.index_select(0, ii.clamp(max=of_buf.shape[0] - 1))

    def _epoch_schedule(self, n: int, rng) -> Tuple[np.ndarray, np.ndarray]:
        """(idx, wmask) (steps, bsz) arrays scheduling cfg.epochs shuffled
        passes over n cubes, each epoch cyclically padded to a batch
        multiple with zero-weight slots (pad may exceed n for blocks
        smaller than a batch — np.resize wraps)."""
        cfg = self.cfg
        bsz = cfg.batch_size
        steps_per_epoch = -(-n // bsz)
        idx_rows, w_rows = [], []
        for _ in range(cfg.epochs):
            order = rng.permutation(n)
            pad = steps_per_epoch * bsz - n
            idx_rows.append(np.concatenate([order, np.resize(order, pad)]))
            w_rows.append(
                np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
            )
        idx = np.concatenate(idx_rows).reshape(-1, bsz).astype(np.int64)
        wmask = np.concatenate(w_rows).reshape(-1, bsz)
        return idx, wmask

    def _segment_schedule(self, sizes: List[int], rng):
        """The streamed form (train.py:292-296): per epoch, per segment,
        one permutation and its batches, a partial batch wrap-padded from
        its own start. Returns (segment (steps,), idx, wmask (steps, bsz))."""
        bsz = self.cfg.batch_size
        segs, idx_rows, w_rows = [], [], []
        for _ in range(self.cfg.epochs):
            for si, n in enumerate(sizes):
                order = rng.permutation(n)
                for lo in range(0, n, bsz):
                    sel = order[lo: lo + bsz]
                    pad = bsz - sel.size
                    segs.append(si)
                    idx_rows.append(np.concatenate([sel, sel[np.arange(pad) % sel.size]]))
                    w_rows.append(np.concatenate([np.ones(sel.size, np.float32),
                                                  np.zeros(pad, np.float32)]))
        return np.array(segs), np.stack(idx_rows), np.stack(w_rows)

    def _run_steps(self, bufs, of_bufs, segs, idx, wmask) -> np.ndarray:
        """Train on the scheduled steps over device cube buffers and their
        flow buffers (upload_flow). The schedule goes to the device once (a
        per-step upload from pageable memory would wait for the device
        every step), and the (steps, 3) losses (loss, loss_raw, loss_of)
        come back in one download."""
        masked = self.cfg.masked_bn
        # a full batch's masked statistics are its plain ones: only a
        # padded batch needs the masked form (decided on the host)
        padded = wmask.min(axis=1) < 1.0
        idx_dev = torch.as_tensor(idx, device=self.device)
        w_dev = torch.as_tensor(wmask, device=self.device)
        losses = []
        for s in range(idx.shape[0]):
            ii = idx_dev[s]
            xb = self.as_float_input(bufs[segs[s]].index_select(0, ii))
            ob = self.flow_rows(of_bufs[segs[s]], ii)
            bw = w_dev[s] if masked and padded[s] else None
            losses.append(self.train_step(xb, ob, w_dev[s], bw))
        if not losses:
            return np.zeros((0, 3), np.float32)
        return torch.stack(losses).cpu().numpy()

    def fit_block(
        self,
        raw_inputs: Cubes,
        of_inputs: Optional[Cubes] = None,
        seed: int = 0,
        log_every: int = 0,
        segments: Optional[List[Tuple[Cubes, Optional[Cubes]]]] = None,
        init_state: Optional[State] = None,
    ) -> TrainedBlock:
        """Train one block and collect its training scores.

        raw_inputs: (N, P, P, T*3) uint8 (scaled by 1/255 on the device) or
        float32 in [0, 1] (quantised to uint8 for training, scored as
        given); of_inputs: (N, P, P, T_of*2) float32 flow cubes, trained
        and scored unscaled, or None. `segments` streams extra (raw, of)
        chunks per epoch after the first (the ShanghaiTech saveSegNum
        pattern, train.py:292-296); streamed segments train on their
        inputs as given. of_scores is None unless the config fuses flow
        and of_inputs is given (the JAX package's "trained without a flow
        stream" marker). Every input may be a numpy array or a tensor (a
        device-resident CubeSet's rows: nothing goes back to the host).
        full_f32 keeps the f32 training-score pass (and an f32 fit) off
        TF32; bf16 convolutions do not read those flags. The call is the
        span `train.fit`, its phases the spans of fit_block_budget's names
        (runtime.profiling)."""
        cfg = self.cfg
        with annotate("train.fit"), full_f32():
            with annotate("train.init_state"):
                self.start_fit(init_state if init_state is not None
                               else self.init_state(seed))
            rng = np.random.default_rng(seed)
            if segments:
                raws = [raw_inputs] + [r for r, _ in segments]
                with annotate("train.upload"):
                    bufs = score_bufs = [self.upload(r) for r in raws]
                    of_bufs = [self.upload_flow(o, r.shape) for r, o in
                               zip(raws, [of_inputs] + [o for _, o in segments])]
                with annotate("train.schedule_host"):
                    segs, idx, wmask = self._segment_schedule(
                        [r.shape[0] for r in raws], rng)
            else:
                with annotate("train.upload"):
                    q = _quantize_u8(raw_inputs)
                    bufs = [self.upload(q)]
                    # the score pass reuses the uploaded uint8 buffer; float
                    # inputs were quantised for training and score as given
                    score_bufs = bufs if q is raw_inputs else [self.upload(raw_inputs)]
                    of_bufs = [self.upload_flow(of_inputs, raw_inputs.shape)]
                with annotate("train.schedule_host"):
                    idx, wmask = self._epoch_schedule(raw_inputs.shape[0], rng)
                    segs = np.zeros(idx.shape[0], np.int64)
            with annotate("train.train_scan"):
                losses = self._run_steps(bufs, of_bufs, segs, idx, wmask)
            if log_every:
                for s in range(0, losses.shape[0], max(1, log_every)):
                    print(f"step {s}: raw {losses[s, 1]:.5f} of {losses[s, 2]:.5f}")
            with annotate("train.score_pass"):
                scores = [self._score(b, o) for b, o in zip(score_bufs, of_bufs)]
            with annotate("train.param_download"):
                state = self.state()
            has_of = cfg.use_flow and of_inputs is not None
            return TrainedBlock(
                state_dict=state,
                raw_scores=np.concatenate([r for r, _ in scores]),
                of_scores=np.concatenate([o for _, o in scores]) if has_of else None,
                losses=losses[:, 0],
            )

    def fit_block_budget(self, raw_inputs: Cubes, of_inputs: Optional[Cubes] = None,
                         seed: int = 0) -> Dict[str, float]:
        """Itemised wall of one fit_block, in seconds
        (vec_vad_tpu/train/trainer.py:492-566), each phase ended by a
        device synchronisation on the card (none on the CPU):

          init_state_s       init_state + loading it and a fresh Adam
          schedule_host_s    the epoch permutations and idx/wmask (host)
          upload_s           uint8 quantisation (float cubes) + the cube
                             and flow uploads
          train_scan_s       the step loop (schedule upload, steps, the
                             losses' download)
          score_pass_s       the training-score pass and its download
          param_download_s   the weights to the host

        Runs twice and keeps the second (warm) run; the trajectory is
        fit_block's (same seed, same scores), and the net keeps the
        trained weights."""
        sync = ((lambda: torch.cuda.synchronize(self.device))
                if self.device.type == "cuda" else (lambda: None))
        out: Dict[str, float] = {}

        def phase(name, fn):
            t0 = time.perf_counter()
            res = fn()
            sync()
            out[name] = time.perf_counter() - t0
            return res

        with full_f32():
            for _ in range(2):
                phase("init_state_s", lambda: self.start_fit(self.init_state(seed)))
                idx, wmask = phase("schedule_host_s", lambda: self._epoch_schedule(
                    raw_inputs.shape[0], np.random.default_rng(seed)))
                buf, of_buf = phase("upload_s", lambda: (
                    self.upload(_quantize_u8(raw_inputs)),
                    self.upload_flow(of_inputs, raw_inputs.shape)))
                segs = np.zeros(idx.shape[0], np.int64)
                phase("train_scan_s", lambda: self._run_steps(
                    [buf], [of_buf], segs, idx, wmask))
                phase("score_pass_s", lambda: self._score(buf, of_buf))
                phase("param_download_s", self.state)
        out["total_s"] = sum(out.values())
        return out

    def _score(self, buf: torch.Tensor, of_buf: Optional[torch.Tensor],
               batch_size: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Eval-mode per-cube (raw, of) scores of a device cube buffer and
        its flow buffer (upload_flow) under the net's current weights, in
        input order, in one download; of is 0 without a flow head."""
        bsz = batch_size or self.cfg.batch_size
        n = buf.shape[0]
        out = torch.zeros((2, n), device=self.device)
        rows = torch.arange(n, device=self.device)
        with torch.no_grad():
            for lo in range(0, n, bsz):
                out[:, lo: lo + bsz] = self._batch_scores(
                    self.as_float_input(buf[lo: lo + bsz]),
                    self.flow_rows(of_buf, rows[lo: lo + bsz]))
        raw, of = out.cpu().numpy()
        return raw, of

    def _batch_scores(self, x: torch.Tensor,
                      x_of: Optional[torch.Tensor]) -> torch.Tensor:
        """(2, b) eval-mode (raw, of) scores of one batch on the device, its
        rows cut over the mesh's replicas and gathered in order; of is 0
        without a flow head."""
        multi = len(self._replicas) > 1
        xs = shard(x, self.mesh) if multi else [x]
        obs = shard(x_of, self.mesh) if multi else [x_of]
        parts = []
        for net, xi, oi in zip(self._replicas, xs, obs):
            o = net(xi, oi)
            raw = _cube_scores(o.raw_out - o.raw_tgt)
            of = (_cube_scores(o.of_out - o.of_tgt) if o.of_out is not None
                  else torch.zeros_like(raw))
            parts.append(torch.stack([raw, of]))
        if len(parts) == 1:
            return parts[0]
        return gather([p.t() for p in parts], self.device).t()

    def score_block(
        self,
        state_or_block: Union[State, TrainedBlock],
        raw_inputs: Cubes,
        of_inputs: Optional[Cubes] = None,
        batch_size: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Eval-mode per-cube (raw, of) scores, in input order. uint8 cubes
        are scaled on the device; float cubes and flow cubes are scored
        unscaled. of is all zeros without a flow head; a flow head with
        of_inputs=None is scored against zero targets (the JAX package's
        dummy flow)."""
        with full_f32():
            self.load_state(state_or_block)
            return self._score(self.upload(raw_inputs),
                               self.upload_flow(of_inputs, raw_inputs.shape),
                               batch_size)
