"""The (scene, h, w) model-block grid (vec_vad_tpu/train/grid_trainer.py):
many independent blocks trained and scored together, on one device or
dealt over a device mesh.

The reference trains the grid's blocks one after another
(train.py:270-296) and scores them one at a time (test.py:277-348). The
JAX package stacks the blocks' states on a leading axis and runs them one
after another on each chip (lax.map), spreading them only over a mesh.
Here the G blocks are FOLDED into the ensemble's grouped convolutions: a
grid of G blocks of E members is one network of G*E members
(models.completion, `blocks=G`), activations block-major, then
member-major, then channel, and batch row b of block g holds block g's own
cube. One step of the folded net is one step of every block, at one
step's host cost.

Each block follows the schedule BlockTrainer.fit_block would give it
alone: the same fresh init from `seed` (or `init_state`), its own
np.random.default_rng(seed) permutations with cyclic wrap padding and
zero-weight slots, its own (G, B) BatchNorm pad mask
(models.layers.BatchNorm), and a loss that is the sum over blocks of each
block's masked mean, so each block's gradient is its solo gradient.
Blocks are sorted by cube count, largest first: the blocks whose schedule
has steps left at grid step s are then always the first g, and the step
runs only their members (a prefix of every weight, models.layers). The
finished blocks' weights, Adam moments and steps (the update is masked by
block) and BatchNorm running statistics (not in the step at all) stay bit
for bit.

Adam is torch.optim.Adam's update (eps outside the square root, moments
bias-corrected by the block's own step: optax's adam to rounding) over
one flat buffer that holds every parameter, so a step is a few
elementwise launches whatever the parameter count. compute_dtype
"bfloat16" runs each step's forward and backward on a bf16 copy of that
buffer (f32 masters, gradients and Adam state), the casts of
BlockTrainer.loss; the training-score pass runs in f32.

Activations grow with G: a call folds at most `max_blocks` blocks, the
memory budget over one block's activation bytes (`block_bytes`), and runs
the rest in further calls.

On a device mesh (`mesh=`) the blocks are dealt over the entries in
contiguous shares of block_data's order (parallel.mesh.shard_bounds, as
JAX shards its G axis), and each entry folds and runs its own share's
chunks on a GridTrainer of its own (its nets on its device); the entries'
grid steps run in turn, step by step, and the replicas never talk, so
every block's state and scores are its one-device ones. JAX pads G to a
multiple of the mesh width with blocks that do nothing; here an entry
with fewer blocks runs fewer, and one with none idles. Entries that share
a device split its memory budget.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from vec_vad_torch.config import CompletionConfig
from vec_vad_torch.device import full_f32, resolve_dtype
from vec_vad_torch.infer import _forward_fn
from vec_vad_torch.models.completion import SelfCompletionNet, make_completion_net
from vec_vad_torch.parallel.mesh import as_mesh, shard_bounds
from vec_vad_torch.pipeline import TrainedBlock
from vec_vad_torch.train.trainer import BlockTrainer, Cubes, State, _quantize_u8

BlockKey = Tuple[int, int, int]
BlockData = List[Tuple[BlockKey, Cubes, Optional[Cubes]]]

# Activation elements a member keeps for one cube, in units of nf * P^2:
# a training step's forward saves ~6-9 tensors per DoubleConv at each of
# the UNet's 7 levels (level l: 2^l * nf channels at (P / 2^l)^2, so
# nf * P^2 / 2^l elements) plus the decoder's concatenations, ~30-38
# units, rounded up; an eval forward holds the skips and a few level-0
# tensors at a time.
_TRAIN_UNITS, _SCORE_UNITS = 40, 8
_CPU_BUDGET = 8 << 30  # bytes a grid call may take on the CPU


def _memory(t: torch.Tensor) -> torch.Tensor:
    """A dense tensor's elements in their memory order (a channels_last
    weight's is NHWC), as a 1-D view."""
    return t.as_strided((t.numel(),), (1,))


def _copy_rows(dst: torch.Tensor, src) -> None:
    dst.copy_(src if isinstance(src, torch.Tensor)
              else torch.from_numpy(np.ascontiguousarray(src)))


class _GridAdam:
    """torch.optim.Adam's update over a grid net's parameters, which it
    re-seats as views of one flat f32 buffer, each parameter's memory in
    its own layout (channels_last weights stay so; dim 0 of every
    parameter is block-major and outermost, so each block's share of a
    parameter is contiguous)."""

    def __init__(self, net: SelfCompletionNet, blocks: int, lr: float,
                 eps: float, betas=(0.9, 0.999)):
        named = list(net.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.sizes = [p.numel() for p in self.params]
        self.blocks, self.lr, self.eps, self.betas = blocks, lr, eps, betas
        self.flat = torch.cat([_memory(p.detach()) for p in self.params])
        for p, v in zip(self.params, self.flat.split(self.sizes)):
            p.data = v.as_strided(p.shape, p.stride())
        self.exp_avg = torch.zeros_like(self.flat)
        self.exp_avg_sq = torch.zeros_like(self.flat)
        dev = self.flat.device
        self.block_of = torch.cat([
            torch.arange(n, dtype=torch.int32, device=dev) // (n // blocks)
            for n in self.sizes])
        self.steps = np.zeros(blocks, np.int64)
        self._leaves: Optional[List[torch.Tensor]] = None

    def leaves(self, dtype: torch.dtype) -> Optional[Dict[str, torch.Tensor]]:
        """The step's differentiated parameters: None for f32 (the net's
        own, their gradients cleared), else a `dtype` copy of the flat
        buffer cut into leaves (one cast launch), in the parameters'
        layouts."""
        if dtype == torch.float32:
            self._leaves = None
            for p in self.params:
                p.grad = None
            return None
        low = self.flat.to(dtype).split(self.sizes)
        self._leaves = [v.as_strided(p.shape, p.stride()).detach().requires_grad_()
                        for v, p in zip(low, self.params)]
        return dict(zip(self.names, self._leaves))

    def step(self, g: int, t: int) -> None:
        """Adam step t of the first g blocks (every active block is at the
        same step: schedules start together); the others keep their
        parameters, moments and step bit for bit."""
        src = self.params if self._leaves is None else self._leaves
        # a leaf's gradient has its leaf's strides (autograd's layout rule)
        grads = torch.cat([_memory(v.grad) for v in src]).float()
        b1, b2 = self.betas
        step_size = -self.lr / (1 - b1 ** t)
        bc2_sqrt = (1 - b2 ** t) ** 0.5
        self.steps[:g] = t
        if g == self.blocks:
            self.exp_avg.lerp_(grads, 1 - b1)
            self.exp_avg_sq.mul_(b2).addcmul_(grads, grads, value=1 - b2)
            denom = (self.exp_avg_sq.sqrt() / bc2_sqrt).add_(self.eps)
            self.flat.addcdiv_(self.exp_avg, denom, value=step_size)
            return
        active = self.block_of < g
        m = torch.lerp(self.exp_avg, grads, 1 - b1)
        v = (self.exp_avg_sq * b2).addcmul_(grads, grads, value=1 - b2)
        p = self.flat.addcdiv(m, (v.sqrt() / bc2_sqrt).add_(self.eps),
                              value=step_size)
        for cur, new in ((self.exp_avg, m), (self.exp_avg_sq, v), (self.flat, p)):
            cur.copy_(torch.where(active, new, cur))

    def block_state(self, g: int) -> dict:
        """Block g's Adam state on the host: {"step", "exp_avg",
        "exp_avg_sq"}, the moments by parameter name."""
        out = {"step": int(self.steps[g])}
        for key, buf in (("exp_avg", self.exp_avg), ("exp_avg_sq", self.exp_avg_sq)):
            out[key] = {
                n: v.as_strided(p.shape, p.stride()).unflatten(0, (self.blocks, -1))[g]
                .to("cpu", memory_format=torch.contiguous_format)
                for n, v, p in zip(self.names, buf.split(self.sizes), self.params)
            }
        return out


class GridTrainer:
    """Trains and scores many independent blocks folded into one network
    on one device, or dealt over a device mesh (module docstring)."""

    def __init__(self, cfg: CompletionConfig, patch_size: int = 32, device="cuda",
                 mesh=None):
        """mesh: a parallel.mesh.Mesh (or a list of devices) to deal the
        blocks over (module docstring); the trainer then lives on its
        first entry. None: `device` alone."""
        if mesh is not None:
            mesh = as_mesh(mesh)
            device = mesh.devices[0]
        self.solo = BlockTrainer(cfg, patch_size, device)
        self.cfg, self.patch_size = cfg, patch_size
        self.device = self.solo.device
        self.compute_dtype = self.solo.compute_dtype
        self._nets: Dict[int, SelfCompletionNet] = {}
        self.mesh = mesh
        self._sharing = 1  # mesh entries on this trainer's device
        self._replicas = [self]
        if mesh is not None and mesh.size > 1:
            self._replicas += [GridTrainer(cfg, patch_size, d) for d in mesh.devices[1:]]
            for rep in self._replicas:
                rep._sharing = sum(d == rep.device for d in mesh.devices)

    def net(self, blocks: int) -> SelfCompletionNet:
        """The folded net of `blocks` blocks (built once per width)."""
        if blocks not in self._nets:
            self._nets[blocks] = make_completion_net(self.cfg, self.device, blocks)
        return self._nets[blocks]

    # -- memory ---------------------------------------------------------------

    def block_bytes(self, rows: int, train: bool) -> int:
        """Device bytes one block's activations take in a step of `rows`
        cubes (training) or a scoring batch of `rows`: rows x members x
        units x nf x P^2 x 4 bytes (units: _TRAIN_UNITS or _SCORE_UNITS,
        counted at 4 bytes whatever the compute dtype)."""
        net = self.solo.net
        members = len(net.raw_positions) + (
            len(net.flow_positions) if net.of_unets is not None else 0)
        units = _TRAIN_UNITS if train else _SCORE_UNITS
        return rows * members * units * self.cfg.nf * self.patch_size ** 2 * 4

    def max_blocks(self, rows: int, train: bool) -> int:
        """Blocks one call folds: the memory budget, half of what the card
        can still give at the call (its free memory and what torch's
        allocator holds unused; _CPU_BUDGET on the CPU), over block_bytes,
        at least 1."""
        if self.device.type == "cuda":
            held = (torch.cuda.memory_reserved(self.device)
                    - torch.cuda.memory_allocated(self.device))
            budget = (torch.cuda.mem_get_info(self.device)[0] + held) / 2
        else:
            budget = _CPU_BUDGET
        budget /= self._sharing
        return max(1, int(budget // self.block_bytes(rows, train)))

    # -- host-side orchestration ----------------------------------------------

    @staticmethod
    def _uniform_has_flow(block_data) -> bool:
        """Whether the blocks carry a flow stream; a MIXED list would
        either crash mid-fill (of_buf[bi] = None) or silently discard
        later blocks' flow cubes — reject it (the pipeline always passes
        a uniform stream)."""
        flows_present = [of is not None for _, _, of in block_data]
        if any(flows_present) and not all(flows_present):
            raise ValueError(
                "block_data mixes flow and flow-less blocks; pass a "
                "uniform flow stream"
            )
        return flows_present[0]

    def _chunks(self, block_data: BlockData, rows: int, train: bool):
        """block_data sorted by cube count (largest first, stable), cut into
        calls of at most max_blocks blocks."""
        order = sorted(range(len(block_data)), key=lambda i: -block_data[i][1].shape[0])
        cap = self.max_blocks(rows, train)
        return [[block_data[i] for i in order[lo: lo + cap]]
                for lo in range(0, len(order), cap)]

    def _shares(self, block_data: BlockData):
        """(entry trainer, its share of block_data) of each mesh entry with
        blocks, in mesh order (one entry: this trainer and every block)."""
        if len(self._replicas) == 1:
            return [(self, block_data)]
        bounds = shard_bounds(len(block_data), self.mesh)
        return [(rep, block_data[lo:hi]) for rep, (lo, hi)
                in zip(self._replicas, bounds) if hi > lo]

    def _buffers(self, chunk: BlockData, n_max: int, has_flow: bool):
        """The chunk's cubes in one (G * n_max, P, P, C) uint8 device buffer,
        block g's rows from g * n_max (float cubes quantised, as the JAX
        package's grid does), and the flow rows beside them as float32; a
        flow head without flow reads one zero row (BlockTrainer.upload_flow)."""
        G, dev = len(chunk), self.device
        raw0, of0 = chunk[0][1], chunk[0][2]
        raw_buf = torch.zeros((G * n_max,) + tuple(raw0.shape[1:]), dtype=torch.uint8,
                              device=dev)
        of_buf = (torch.zeros((G * n_max,) + tuple(of0.shape[1:]), device=dev)
                  if has_flow else self.solo.upload_flow(None, raw0.shape))
        for g, (_, raw, of) in enumerate(chunk):
            lo = g * n_max
            _copy_rows(raw_buf[lo: lo + raw.shape[0]], _quantize_u8(raw))
            if has_flow:
                _copy_rows(of_buf[lo: lo + of.shape[0]], of)
        return raw_buf, of_buf

    def fit_blocks(self, block_data: BlockData, seed: int = 0, log_every: int = 0,
                   init_state: Optional[State] = None) -> Dict[BlockKey, TrainedBlock]:
        """Train every block of block_data (key, raw cubes, flow cubes or
        None), folded; returns {key: TrainedBlock} in block_data's order.

        raw may be uint8 or [0, 1] float (quantised), numpy or a device
        tensor. Each block follows the schedule BlockTrainer.fit_block
        would give it alone, from init_state (one block's state dict) or
        the fresh init from `seed`. of_scores is None unless the config
        uses flow and the blocks carry flow cubes."""
        if not block_data:
            return {}
        has_flow = self.cfg.use_flow and self._uniform_has_flow(block_data)
        state = init_state if init_state is not None else self.solo.init_state(seed)
        out = {}
        with full_f32():
            calls = [(rep, rep._chunks(share, self.cfg.batch_size, train=True))
                     for rep, share in self._shares(block_data)]
            for r in range(max(len(chunks) for _, chunks in calls)):
                out.update(self._fit_chunks(
                    [rep.prepare(chunks[r], state, seed, has_flow)
                     for rep, chunks in calls if r < len(chunks)], log_every))
        return {key: out[key] for key, _, _ in block_data}

    def prepare(self, chunk: BlockData, state: State, seed: int = 0,
                has_flow: bool = False) -> "_GridFit":
        """One call's fit, set up and not yet run: the chunk (at most
        max_blocks blocks, sorted by cube count, largest first) in device
        buffers, each block's schedule, the folded net loaded with `state`
        for every block and a fresh Adam around it."""
        cfg, bsz, G = self.cfg, self.cfg.batch_size, len(chunk)
        counts = [raw.shape[0] for _, raw, _ in chunk]
        steps = [cfg.epochs * -(-n // bsz) for n in counts]
        idx = np.zeros((steps[0], G, bsz), np.int64)
        wmask = np.zeros((steps[0], G, bsz), np.float32)
        for g, n in enumerate(counts):
            i, w = self.solo._epoch_schedule(n, np.random.default_rng(seed))
            idx[: steps[g], g] = i + g * counts[0]
            wmask[: steps[g], g] = w
        raw_buf, of_buf = self._buffers(chunk, counts[0], has_flow)
        net = self.net(G)
        net.load_state_dict({k: torch.cat([v] * G) for k, v in state.items()})
        adam = _GridAdam(net, G, cfg.learning_rate, cfg.adam_eps)
        return _GridFit(self, chunk, counts, steps, net, adam, raw_buf, of_buf,
                        idx, wmask, has_flow)

    @staticmethod
    def _fit_chunks(fits: List["_GridFit"], log_every: int
                    ) -> Dict[BlockKey, TrainedBlock]:
        """Run prepared fits (one a mesh entry) to their ends, grid step s
        of every fit before step s + 1 of any, and finish them."""
        per_step: List[List[torch.Tensor]] = [[] for _ in fits]
        for s in range(max(len(f.active) for f in fits)):
            for f, ps in zip(fits, per_step):
                if s < len(f.active):
                    ps.append(f.step(s))
        out = {}
        for f, ps in zip(fits, per_step):
            losses = f.losses(ps)
            if log_every:
                for s in range(0, losses.shape[0], max(1, log_every)):
                    print(f"grid step {s}: raw {losses[s, :, 1]}")
            out.update(f.finish(losses))
        return out

    def block_losses(self, out, w: torch.Tensor) -> torch.Tensor:
        """(g, 3) (loss, loss_raw, loss_of) of each block: BlockTrainer.loss'
        masked means, block by block."""
        def masked_mean(err):  # (g, E, B, P, P, C) -> (g,)
            per_elem = err.float().square().mean(dim=(1, 3, 4, 5))
            return (per_elem * w).sum(dim=1) / torch.clamp(w.sum(dim=1), min=1.0)

        loss_raw = masked_mean(out.raw_out - out.raw_tgt.detach())
        if out.of_out is None:
            return torch.stack([loss_raw, loss_raw, torch.zeros_like(loss_raw)], dim=1)
        loss_of = masked_mean(out.of_out - out.of_tgt.detach())
        loss = self.cfg.lambda_raw * loss_raw + self.cfg.lambda_of * loss_of
        return torch.stack([loss, loss_raw, loss_of], dim=1)

    def _scores(self, forward, raw_buf, of_buf, counts, n_max: int, bsz: int,
                dtype: torch.dtype) -> np.ndarray:
        """Eval-mode (2, G, n_max) (raw, of) scores of every block's own
        rows, one folded forward per batch of `bsz` rows over the blocks
        that still have rows (rows past a block's end repeat its last
        row and are dropped); of is 0 without a flow head."""
        G, dev = len(counts), self.device
        out = torch.zeros((2, G, n_max), device=dev)
        last = torch.as_tensor(counts, device=dev)[:, None] - 1
        base = torch.arange(G, device=dev)[:, None] * n_max
        cube = tuple(raw_buf.shape[1:])
        with torch.no_grad():
            for lo in range(0, n_max, bsz):
                g = sum(n > lo for n in counts)
                hi = min(lo + bsz, n_max)
                rows = torch.arange(lo, hi, device=dev)[None, :]
                ii = (torch.minimum(rows, last[:g]) + base[:g]).reshape(-1)
                x = raw_buf.index_select(0, ii).to(dtype) / 255.0
                x_of = self.solo.flow_rows(of_buf, ii)
                if x_of is not None:
                    x_of = x_of.to(dtype).reshape((g, hi - lo) + tuple(x_of.shape[1:]))
                o = forward(x.reshape((g, hi - lo) + cube), x_of)
                out[0, :g, lo:hi] = (o.raw_out - o.raw_tgt).float().square().sum(
                    dim=(1, 3, 4, 5))
                if o.of_out is not None:
                    out[1, :g, lo:hi] = (o.of_out - o.of_tgt).float().square().sum(
                        dim=(1, 3, 4, 5))
        return out.cpu().numpy()

    @staticmethod
    def _download(net: SelfCompletionNet, G: int) -> List[State]:
        """Every block's state dict on the host, from one copy of the
        stacked weights and running statistics."""
        sd = net.state_dict()
        host = torch.cat([v.detach().reshape(-1) for v in sd.values()]).cpu()
        parts = dict(zip(sd, host.split([v.numel() for v in sd.values()])))
        return [{k: parts[k].view(G, -1)[g].reshape((v.shape[0] // G,) + v.shape[1:])
                 .clone() for k, v in sd.items()} for g in range(G)]

    def score_blocks(self, blocks: Dict[BlockKey, TrainedBlock], block_data: BlockData,
                     batch_size: Optional[int] = None,
                     compute_dtype=torch.float32) -> Dict[BlockKey, Tuple[np.ndarray,
                                                                          np.ndarray]]:
        """Eval-mode (raw, of) scores of each block's test cubes under its
        trained weights (blocks[key]), folded: one forward per batch of
        `batch_size` rows (default cfg.batch_size) for every block at
        once, in f32 with TF32 off or in compute_dtype (the casts of
        infer.infer_frame_scores_resident). Returns {key: (raw, of)} in
        cube order; of is 0 without a flow head."""
        if not block_data:
            return {}
        has_flow = self.cfg.use_flow and self._uniform_has_flow(block_data)
        dtype = resolve_dtype(compute_dtype)
        bsz = batch_size or self.cfg.batch_size
        out = {}
        with torch.no_grad(), full_f32(dtype):
            for rep, share in self._shares(block_data):
                for chunk in rep._chunks(share, bsz, train=False):
                    out.update(rep._score_chunk(blocks, chunk, bsz, dtype, has_flow))
        return {key: out[key] for key, _, _ in block_data}

    def _score_chunk(self, blocks, chunk: BlockData, bsz: int, dtype: torch.dtype,
                     has_flow: bool) -> Dict[BlockKey, Tuple[np.ndarray, np.ndarray]]:
        """score_blocks' scores of one chunk, folded on this trainer's device."""
        counts = [raw.shape[0] for _, raw, _ in chunk]
        raw_buf, of_buf = self._buffers(chunk, counts[0], has_flow)
        names = blocks[chunk[0][0]].state_dict
        stacked = {k: torch.cat([blocks[key].state_dict[k].to(self.device)
                                 for key, _, _ in chunk]) for k in names}
        forward = _forward_fn(self.net(len(chunk)), stacked, dtype)
        sc = self._scores(forward, raw_buf, of_buf, counts, counts[0], bsz, dtype)
        return {key: (sc[0, g, : counts[g]], sc[1, g, : counts[g]])
                for g, (key, _, _) in enumerate(chunk)}


class _GridFit:
    """A prepared grid fit (GridTrainer.prepare): step(s) runs grid step s,
    losses() gathers the steps' losses, finish() scores and downloads."""

    def __init__(self, trainer: GridTrainer, chunk: BlockData, counts, steps, net,
                 adam: _GridAdam, raw_buf, of_buf, idx, wmask, has_flow: bool):
        self.trainer, self.chunk, self.counts, self.steps = trainer, chunk, counts, steps
        self.net, self.adam, self.raw_buf, self.of_buf = net, adam, raw_buf, of_buf
        self.has_flow = has_flow
        dev = trainer.device
        S = idx.shape[0]
        # blocks with steps left at each grid step: a prefix (sorted chunk)
        self.active = (np.asarray(steps)[None, :] > np.arange(S)[:, None]).sum(axis=1)
        # a full batch's masked statistics are its plain ones: only a step
        # with a padded batch needs the (g, B) mask (decided on the host)
        self.padded = wmask.min(axis=2) < 1.0
        self.idx = torch.as_tensor(idx, device=dev)
        self.wmask = torch.as_tensor(wmask, device=dev)

    def batch(self, s: int):
        """Grid step s's (g, x, x_of, w, bw): the first g blocks' batches
        (g, B, P, P, C) scaled to [0, 1], their flow rows or None, loss
        weights (g, B) and the BatchNorm mask (None without a padded batch)."""
        solo, g = self.trainer.solo, int(self.active[s])
        bsz = self.idx.shape[2]
        ii = self.idx[s, :g].reshape(-1)
        x = solo.as_float_input(self.raw_buf.index_select(0, ii))
        x = x.reshape((g, bsz) + tuple(x.shape[1:]))
        x_of = solo.flow_rows(self.of_buf, ii)
        if x_of is not None:
            x_of = x_of.reshape((g, bsz) + tuple(x_of.shape[1:]))
        w = self.wmask[s, :g]
        masked = self.trainer.cfg.masked_bn and self.padded[s, :g].any()
        return g, x, x_of, w, w if masked else None

    def step(self, s: int) -> torch.Tensor:
        """Grid step s (one Adam step of each block with steps left);
        returns its (g, 3) (loss, loss_raw, loss_of) on the device."""
        g, x, x_of, w, bw = self.batch(s)
        dt = self.trainer.compute_dtype
        leaves = self.adam.leaves(dt)
        if leaves is None:
            out = self.net(x, x_of, True, bw)
        else:
            out = functional_call(self.net, leaves, (
                x.to(dt), None if x_of is None else x_of.to(dt), True, bw))
        per = self.trainer.block_losses(out, w)
        per[:, 0].sum().backward()
        self.adam.step(g, s + 1)
        return per.detach()

    def losses(self, per_step: List[torch.Tensor]) -> np.ndarray:
        """The steps' losses as (S, G, 3), 0 past a block's schedule, in
        one download."""
        S, G = len(self.active), len(self.counts)
        flat = torch.cat(per_step).cpu().numpy() if per_step else np.zeros((0, 3))
        out = np.zeros((S, G, 3), np.float32)
        lo = 0
        for s in range(S):
            out[s, : self.active[s]] = flat[lo: lo + self.active[s]]
            lo += self.active[s]
        return out

    def finish(self, losses: np.ndarray) -> Dict[BlockKey, TrainedBlock]:
        """The training-score pass (eval mode, f32) and every block's
        TrainedBlock, its weights from one download."""
        t, G = self.trainer, len(self.counts)
        sc = t._scores(self.net, self.raw_buf, self.of_buf, self.counts, self.counts[0],
                       t.cfg.batch_size, torch.float32)
        weights = t._download(self.net, G)
        out = {}
        for g, (key, _, _) in enumerate(self.chunk):
            n = self.counts[g]
            out[key] = TrainedBlock(
                state_dict=weights[g],
                raw_scores=sc[0, g, :n],
                of_scores=sc[1, g, :n] if self.has_flow else None,
                losses=losses[: self.steps[g], g, 0],
            )
        return out
