"""The completion ensemble of VEC_VAD model/unet.py (SelfCompleteNet4 and
its raw-only form) in plain PyTorch, one UNet member at a time.

Weights are read from a state dict in the grouped layout the benchmark
makes them in: a layer's E members stacked along the first axis (a 3x3
conv (E*F, I, 3, 3), a transposed conv (E*I, O, 3, 3), BatchNorm vectors
(E*F,)), under `raw_unets.` for the raw members and `of_unets.` for the
flow member. `spec` lists every name, shape and init rule.

A cube is (P, P, T*3) raw in [0, 1] (T-major channels) and (P, P, 2)
flow. Member k of the raw stream sees the cube with frame k's channels
dropped and predicts frame k; the flow member sees the cube without its
newest frame and predicts the flow slot (border mode 'predict',
context_of_num 0). A cube's score is the squared error summed over
members, pixels and channels.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from vadbench.reference.ops import conv, convt

EPS_BN = 1e-5


def _unet_layers(prefix: str, E: int, cin: int, nf: int, cout: int, train: bool):
    f = [nf, 2 * nf, 4 * nf, 8 * nf]
    bn = (("one", "zero", "zero", "one") if train
          else ("bn_scale", "bn_shift", "bn_mean", "bn_var"))
    out = []

    def conv_entry(name, i, o, k):
        out.append((f"{prefix}{name}.weight", (E * o, i, k, k), f"uniform_fan:{i * k * k}"))
        out.append((f"{prefix}{name}.bias", (E * o,), f"uniform_fan:{i * k * k}"))

    def bn_entry(name, c):
        for leaf, rule in zip(("weight", "bias", "running_mean", "running_var"), bn):
            out.append((f"{prefix}{name}.{leaf}", (E * c,), rule))

    def double(name, i, o):
        conv_entry(f"{name}.conv0", i, o, 3)
        bn_entry(f"{name}.bn0", o)
        conv_entry(f"{name}.conv1", o, o, 3)
        bn_entry(f"{name}.bn1", o)

    chans = [cin] + f
    for d in range(4):
        double(f"down.{d}", chans[d], chans[d + 1])
    for u, (i, o) in enumerate(((f[3], f[2]), (f[2], f[1]), (f[1], f[0]))):
        # torch's fan for a transposed conv (E*I, O, k, k) is O*k*k
        out.append((f"{prefix}up_t.{u}.weight", (E * i, o, 3, 3), f"uniform_fan:{o * 9}"))
        out.append((f"{prefix}up_t.{u}.bias", (E * o,), f"uniform_fan:{o * 9}"))
    for u, (i, o) in enumerate(((f[3], f[2]), (f[2], f[1]), (f[1], f[0]))):
        double(f"up.{u}", i, o)
    conv_entry("out", nf, cout, 1)
    return out


def members(model: dict) -> Tuple[int, int, int]:
    """(raw members, flow members, input channels of a member)."""
    T = int(model["context_frame_num"]) + 1
    flow = 1 if model["use_flow"] else 0
    if model["use_flow"] and int(model.get("context_of_num", 0)) != 0:
        raise ValueError("the reference covers context_of_num 0 only")
    return T, flow, 3 * (T - 1)


def spec(model: dict, train: bool = False) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init rule) of every leaf of the ensemble's state
    dict. train=True: BatchNorm starts at scale 1, shift 0 and running
    statistics (0, 1), as a fresh net; else seeded statistics, so that
    eval-mode BatchNorm is not the identity."""
    E, Fm, cin = members(model)
    nf = int(model["nf"])
    out = _unet_layers("raw_unets.", E, cin, nf, 3, train)
    if Fm:
        out += _unet_layers("of_unets.", Fm, cin, nf, 2, train)
    return out


def _rows(t: torch.Tensor, e: int, n: int) -> torch.Tensor:
    return t[e * n:(e + 1) * n]


class _Member:
    """Member e of a stacked UNet: its weights sliced from the state dict."""

    def __init__(self, sd: Dict[str, torch.Tensor], prefix: str, e: int, nf: int,
                 cout: int):
        self.sd, self.p, self.e, self.nf, self.cout = sd, prefix, e, nf, cout

    def conv(self, name, x, o, lowp):
        w = _rows(self.sd[f"{self.p}{name}.weight"], self.e, o)
        b = _rows(self.sd[f"{self.p}{name}.bias"], self.e, o)
        return conv(x, w, b, lowp=lowp)

    def bn(self, name, x, c, train, bw):
        g = _rows(self.sd[f"{self.p}{name}.weight"], self.e, c)
        b = _rows(self.sd[f"{self.p}{name}.bias"], self.e, c)
        if train:
            w = (torch.ones(x.shape[0], device=x.device) if bw is None else bw)
            w4 = w[:, None, None, None]
            n = w.sum() * x.shape[2] * x.shape[3]
            mean = (x * w4).sum(dim=(0, 2, 3)) / n
            var = (w4 * (x - mean[None, :, None, None]) ** 2).sum(dim=(0, 2, 3)) / n
        else:
            mean = _rows(self.sd[f"{self.p}{name}.running_mean"], self.e, c)
            var = _rows(self.sd[f"{self.p}{name}.running_var"], self.e, c)
        inv = 1.0 / torch.sqrt(var + EPS_BN)
        return (x - mean[None, :, None, None]) * (inv * g)[None, :, None, None] \
            + b[None, :, None, None]

    def double(self, name, x, o, train, bw, lowp):
        x = F.relu(self.bn(f"{name}.bn0", self.conv(f"{name}.conv0", x, o, lowp),
                           o, train, bw))
        return F.relu(self.bn(f"{name}.bn1", self.conv(f"{name}.conv1", x, o, lowp),
                              o, train, bw))

    def __call__(self, x, train=False, bw=None, lowp=False):
        f = [self.nf, 2 * self.nf, 4 * self.nf, 8 * self.nf]
        skips = []
        for d in range(4):
            if d:
                x = F.max_pool2d(x, 2)
            x = self.double(f"down.{d}", x, f[d], train, bw, lowp)
            skips.append(x)
        y = skips[3]
        for u, (i, o) in enumerate(((f[3], f[2]), (f[2], f[1]), (f[1], f[0]))):
            w = _rows(self.sd[f"{self.p}up_t.{u}.weight"], self.e, i)
            b = _rows(self.sd[f"{self.p}up_t.{u}.bias"], self.e, o)
            y = convt(y, w, b, 2, 1, 1, lowp=lowp)
            y = self.double(f"up.{u}", torch.cat([skips[2 - u], y], 1), o, train,
                            bw, lowp)
        return self.conv("out", y, self.cout, lowp)


def forward(sd, model: dict, x: torch.Tensor, x_of: Optional[torch.Tensor],
            train: bool = False, bw=None, lowp: bool = False):
    """x (N, P, P, T*3) in [0, 1], x_of (N, P, P, 2) or None ->
    [(output, target)] a member, each (N, C, P, P): the raw members in
    position order, then the flow member."""
    E, Fm, _ = members(model)
    nf = int(model["nf"])
    xc = x.permute(0, 3, 1, 2)
    pairs = []
    for k in range(E):
        keep = [c for c in range(3 * E) if not 3 * k <= c < 3 * k + 3]
        out = _Member(sd, "raw_unets.", k, nf, 3)(xc[:, keep], train, bw, lowp)
        pairs.append((out, xc[:, 3 * k:3 * k + 3]))
    if Fm:
        keep = list(range(3 * (E - 1)))  # the newest frame erased
        out = _Member(sd, "of_unets.", 0, nf, 2)(xc[:, keep], train, bw, lowp)
        tgt = (x_of.permute(0, 3, 1, 2) if x_of is not None
               else torch.zeros_like(out))
        pairs.append((out, tgt))
    return pairs


def cube_scores(sd, model: dict, x, x_of, lowp: bool = False):
    """(raw, flow) eval-mode squared-error sums a cube, (N,) each; flow is
    None without a flow member."""
    pairs = forward(sd, model, x, x_of, lowp=lowp)
    E = int(model["context_frame_num"]) + 1
    raw = sum(((o - t) ** 2).sum(dim=(1, 2, 3)) for o, t in pairs[:E])
    flow = None
    if len(pairs) > E:
        o, t = pairs[E]
        flow = ((o - t) ** 2).sum(dim=(1, 2, 3))
    return raw, flow


def fused(raw, flow, stats, model: dict):
    """w_raw * (raw - mu_r) / sd_r (+ w_of * (flow - mu_o) / sd_o)."""
    s = float(model.get("w_raw", 1.0)) * (raw - stats[0]) / stats[1]
    if flow is not None:
        s = s + float(model.get("w_of", 1.0)) * (flow - stats[2]) / stats[3]
    return s


# -- training -------------------------------------------------------------------


def loss(sd, model: dict, x, x_of, w, lowp: bool = False):
    """lambda_raw * MSE(raw) (+ lambda_of * MSE(flow)), each the mean over
    members, pixels and channels of the rows that w weights."""
    pairs = forward(sd, model, x, x_of, train=True, bw=w, lowp=lowp)
    E = int(model["context_frame_num"]) + 1

    def mse(ps):
        per_row = sum(((o - t.detach()) ** 2).mean(dim=(1, 2, 3)) for o, t in ps) / len(ps)
        return (per_row * w).sum() / w.sum().clamp(min=1.0)

    total = float(model.get("lambda_raw", 1.0)) * mse(pairs[:E])
    if len(pairs) > E:
        total = total + float(model.get("lambda_of", 1.0)) * mse(pairs[E:])
    return total


class Adam:
    """torch.optim.Adam's update (eps outside the square root, both
    moments bias-corrected), written out."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, eps: float,
                 betas=(0.9, 0.999)):
        self.lr, self.eps, self.b1, self.b2 = lr, eps, *betas
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]):
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).add_(g * g, alpha=1.0 - self.b2)
            denom = (self.v[k].sqrt() / (c2 ** 0.5)) + self.eps
            p.sub_(self.lr / c1 * self.m[k] / denom)


def train_steps(sd0: Dict[str, torch.Tensor], model: dict, batches, lowp=False,
                update: bool = True, moments=None):
    """Adam steps from state sd0 over `batches` of (x, x_of, w). Returns
    (losses, first step's gradients, parameters after the last step),
    gradients and parameters keyed by leaf name (BatchNorm's running
    statistics are not parameters and are left out). update=False leaves
    the parameters as they are (a fault the comparison must catch).
    moments, (first, second, steps taken), resumes an Adam part-way
    through a fit instead of starting a fresh one."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in sd0.items()
              if not k.endswith(("running_mean", "running_var"))}
    state = dict(sd0)
    opt = Adam(params, float(model["learning_rate"]), float(model["adam_eps"]))
    if moments is not None:
        m, v, opt.t = moments
        opt.m = {k: m[k].detach().clone() for k in params}
        opt.v = {k: v[k].detach().clone() for k in params}
    losses, first = [], None
    for x, x_of, w in batches:
        state.update(params)
        lval = loss(state, model, x, x_of, w, lowp)
        grads = torch.autograd.grad(lval, list(params.values()))
        grads = dict(zip(params.keys(), grads))
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        if update:
            opt.step(params, grads)
        losses.append(float(lval.detach()))
    return losses, first, {k: v.detach() for k, v in params.items()}
