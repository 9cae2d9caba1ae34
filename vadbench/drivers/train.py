"""Block training: `BlockTrainer.fit_block` (vec_vad_torch/train/
trainer.py) called back to back over one block of uint8 cubes held on the
card. A call is the whole fit: a fresh Adam around a fresh initial state,
`epochs` shuffled passes in batches of batch_size, and the block's
training-score pass. Each call gets its own schedule seed; the initial
states come from a pool made in set-up and cycled.

Set-up makes one trainer and drives it through a first call, with an
optimizer hook that keeps the first step's Adam moment (the gradient the
optimizer got, times 1 - beta1), the weights after the third step, and
the weights and Adam state before and after the fit's last step; the
window hands calls to that same trainer. The reference follows each
call's first three steps from its initial state and schedule (losses;
for the set-up call also the first gradient and the change of the
weights after three steps, leaf by leaf); it takes the set-up call's
last step again from the program's own state before it, on the batch
that its own reading of the schedule (the last epoch's permutation)
gives (the loss and the step's change of the weights); and it scores the
block again from each call's returned state to judge its training scores.

Traffic parameters: cubes (the block's size, a multiple of the batch),
init_pool, check_calls (window calls whose losses and training scores
are compared, drawn from the seed).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from vadbench import traffic
from vadbench.drivers._common import model_of, pipeline_config, sample
from vadbench.reference import ensemble as ref_ensemble

STEPS_CHECKED = 3
TINY_GRAD = 1e-3  # leaves whose reference gradient is under this share of the median's


class Driver:
    def __init__(self, run):
        self.run = run
        self.tr = run.traffic
        self.config = run.config
        self.model = model_of(run.config)
        self.calls = []  # (schedule seed, init index, TrainedBlock) a window call

    def _seed(self, k: int) -> int:
        return (self.run.seed * 7919 + 104729 * (k + 1)) & traffic.SEED_MASK

    def setup(self):
        from vec_vad_torch.train.trainer import BlockTrainer

        run = self.run
        self.cfg = pipeline_config(self.config)
        P = int(self.config["patch_size"])
        T = int(self.model["context_frame_num"]) + 1
        self.cubes = traffic.train_cubes(run.seed, int(self.tr["cubes"]), P, T, run.device)
        spec = ref_ensemble.spec(self.model, train=True)
        self.inits = [traffic.weights(spec, run.seed, run.device, stream=100 + i)
                      for i in range(int(self.tr["init_pool"]))]
        self.trainer = BlockTrainer(self.cfg.model, P, device=run.device)
        self.k = 0
        n, bsz = self.cubes.shape[0], int(self.model["batch_size"])
        if n % bsz:
            raise ValueError(f"cubes ({n}) must be a multiple of the batch ({bsz})")
        last = int(self.model["epochs"]) * n // bsz
        names = {id(p): n for n, p in self.trainer.net.named_parameters()}
        got = {"steps": 0}

        def params(opt, key="param"):
            return {names[id(p)]: (p if key == "param" else opt.state[p][key]).detach().clone()
                    for g in opt.param_groups for p in g["params"]}

        def hook(opt, args, kwargs):
            got["steps"] += 1
            if got["steps"] == 1:
                got["moment"] = params(opt, "exp_avg")
                got["betas"] = opt.param_groups[0]["betas"]
            if got["steps"] == STEPS_CHECKED:
                got["weights"] = params(opt)
            if got["steps"] == last - 1:
                got["before_last"] = (params(opt), params(opt, "exp_avg"),
                                      params(opt, "exp_avg_sq"), last - 1)
            if got["steps"] == last:
                got["after_last"] = params(opt)

        handle = register_optimizer_step_post_hook(hook)
        try:
            self.first = (self._seed(-1), 0, self._fit(self._seed(-1), 0))
        finally:
            handle.remove()
        # a fit whose optimizer never took the steps leaves these out, and
        # the numbers that need them read inf
        self.first_grad = ({k: v / (1.0 - got["betas"][0]) for k, v in got["moment"].items()}
                           if "moment" in got else None)
        self.first_weights = got.get("weights")
        self.before_last = got.get("before_last")
        self.after_last = got.get("after_last")

    def _fit(self, seed: int, init: int):
        with torch.profiler.record_function("vadbench.fit_block"):
            return self.trainer.fit_block(self.cubes, None, seed=seed,
                                          init_state=self.inits[init])

    def step(self):
        seed, init = self._seed(self.k), self.k % len(self.inits)
        self.k += 1
        block = self._fit(seed, init)
        self.calls.append((seed, init, block))
        ok = bool(np.all(np.isfinite(block.losses)) and np.all(np.isfinite(block.raw_scores)))
        n, epochs = self.cubes.shape[0], int(self.model["epochs"])
        return {"ok": ok, "cubes": n * epochs,
                "work": {"train_cubes": n * epochs, "score_cubes": n}}

    def end_to_end(self, steps, window_s):
        return {"train_cubes_per_s": sum(s["cubes"] for s in steps) / window_s}

    @contextlib.contextmanager
    def trace_hooks(self):
        yield {}

    def release(self):
        del self.trainer
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the comparison ------------------------------------------------------

    def _batches(self, seed: int):
        """The first STEPS_CHECKED batches of a call's schedule: epoch 1's
        permutation from np.random.default_rng(seed), in batch_size rows,
        each scaled to [0, 1] (the block's size is a batch multiple)."""
        bsz = int(self.model["batch_size"])
        order = np.random.default_rng(seed).permutation(self.cubes.shape[0])
        out = []
        for s in range(STEPS_CHECKED):
            ii = torch.as_tensor(order[s * bsz:(s + 1) * bsz], device=self.run.device)
            x = self.cubes.index_select(0, ii).float() / 255.0
            out.append((x, None, torch.ones(bsz, device=self.run.device)))
        return out

    def _scores(self, state, lowp: bool):
        sd = {k: v.to(self.run.device) for k, v in state.items()}
        out = []
        for lo in range(0, self.cubes.shape[0], 1024):
            x = self.cubes[lo:lo + 1024].float() / 255.0
            raw, _ = ref_ensemble.cube_scores(sd, self.model, x, None, lowp)
            out.append(raw.double())
        return torch.cat(out).cpu().numpy()

    def _last_batch(self, seed: int):
        """The fit's last batch: the last batch_size rows of the last
        epoch's permutation, the epochs' permutations drawn one after the
        other from np.random.default_rng(seed)."""
        bsz, n = int(self.model["batch_size"]), self.cubes.shape[0]
        rng = np.random.default_rng(seed)
        for _ in range(int(self.model["epochs"])):
            order = rng.permutation(n)
        ii = torch.as_tensor(order[n - bsz:], device=self.run.device)
        return [(self.cubes.index_select(0, ii).float() / 255.0, None,
                 torch.ones(bsz, device=self.run.device))]

    @staticmethod
    def _controlled(batches, kind):
        if kind != "half":
            return batches
        half = batches[0][0].shape[0] // 2
        return [(x[:half], None, w[:half]) for x, _, w in batches]

    def _steps(self, seed, init, kind=None):
        """The reference's first steps of a call; `kind` puts a control in
        the program's place: "tf32" (the reference in TF32), "frozen" (a
        step that leaves the state unchanged) or "half" (half of each batch
        left out, the mean taken over the rest)."""
        batches = self._controlled(self._batches(seed), kind)
        with torch.enable_grad():
            return ref_ensemble.train_steps(self.inits[init], self.model, batches,
                                            lowp=kind == "tf32",
                                            update=kind != "frozen")

    def _last_step(self, kind=None):
        """The reference's last step of the set-up call, from the program's
        weights and Adam state before it; `kind` as in _steps."""
        seed, init, _ = self.first
        weights, m, v, t = self.before_last
        state = {**self.inits[init], **weights}
        batches = self._controlled(self._last_batch(seed), kind)
        with torch.enable_grad():
            return ref_ensemble.train_steps(state, self.model, batches,
                                            lowp=kind == "tf32", update=kind != "frozen",
                                            moments=(m, v, t))

    def check(self, control=None):
        """control: None (the program), or a kind of _steps; for "tf32" the
        training scores are the reference's in TF32 too, for a fault the
        float32 reference's."""
        seed0, init0, block0 = self.first
        rng = traffic.host_rng(self.run.seed, 7)
        calls = [self.first] + sample(self.calls, int(self.tr["check_calls"]), rng)
        loss_gap = score_gap = 0.0
        ref0 = None
        for seed, init, block in calls:
            ref_losses, ref_grad, ref_w = self._steps(seed, init)
            if ref0 is None:
                ref0 = (ref_grad, ref_w)
            if control:
                losses = self._steps(seed, init, control)[0]
            else:
                losses = block.losses[:STEPS_CHECKED]
            for p, r in zip(losses, ref_losses):
                loss_gap = max(loss_gap, _rel(p, r))
            ref_sc = self._scores(block.state_dict, False)
            if control:
                sc = self._scores(block.state_dict, control == "tf32")
            else:
                sc = block.raw_scores
            score_gap = max(score_gap, float(np.abs(np.asarray(sc, np.float64) - ref_sc).max()
                                             / np.abs(ref_sc).max()))
        ref_grad, ref_w = ref0
        if control:
            _, grad, w = self._steps(seed0, init0, control)
        else:
            grad, w = self.first_grad, self.first_weights
        out = {"loss_gap": loss_gap, "grad_gap": float("inf"), "change_gap": float("inf"),
               "late_loss_gap": float("inf"), "late_change_gap": float("inf"),
               "score_gap": score_gap}
        if grad is not None and w is not None:
            w0 = self.inits[init0]
            moving = _moving(ref_grad)
            out["grad_gap"] = _leaf_gap({k: grad[k] for k in ref_grad}, ref_grad, list(ref_grad))
            out["change_gap"] = _leaf_gap({k: w[k] - w0[k] for k in moving},
                                          {k: ref_w[k] - w0[k] for k in moving}, moving)
        if self.before_last is not None and self.after_last is not None:
            w0 = self.before_last[0]
            (ref_loss,), ref_grad, ref_w = self._last_step()
            if control:
                (loss,), _, w = self._last_step(control)
            else:
                loss, w = block0.losses[-1], self.after_last
            moving = _moving(ref_grad)
            out["late_loss_gap"] = _rel(loss, ref_loss)
            out["late_change_gap"] = _leaf_gap({k: w[k] - w0[k] for k in moving},
                                               {k: ref_w[k] - w0[k] for k in moving}, moving)
        return out


def _moving(grad: dict) -> list:
    """Leaves whose gradient is at least TINY_GRAD of the median leaf's
    (the others move by round-off alone under Adam)."""
    gnorm = {k: float(v.norm()) for k, v in grad.items()}
    med = float(np.median(list(gnorm.values())))
    return [k for k in gnorm if gnorm[k] >= TINY_GRAD * med]


def _rel(p, r) -> float:
    p, r = float(p), float(r)
    if not np.isfinite(p):
        return float("inf")
    return abs(p - r) / max(abs(r), 1e-30)


def _leaf_gap(prog: dict, ref: dict, keys) -> float:
    """The worst leaf's |‖prog‖ - ‖ref‖| over the larger of ‖ref‖ and the
    median leaf's ‖ref‖."""
    rn = {k: float(ref[k].double().norm()) for k in keys}
    med = float(np.median(list(rn.values())))
    worst = 0.0
    for k in keys:
        pn = float(prog[k].double().norm())
        if not np.isfinite(pn):
            return float("inf")
        worst = max(worst, abs(pn - rn[k]) / max(rn[k], med, 1e-30))
    return worst
