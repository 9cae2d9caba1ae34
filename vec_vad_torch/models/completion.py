"""The video-event completion ensemble in PyTorch
(vec_vad_tpu/models/completion.py).

One configurable class covers the reference architectures (model/unet.py):
SelfCompleteNet4 ("5raw1of", tot_of_num=1), SelfCompleteNetFull
("5raw5of"), SelfCompleteNet1raw1of (raw_range). The E erased-position
members run as one grouped-convolution UNet (models/layers.py), in its
weights' layout from the member stack to the outputs.

Semantics preserved exactly:
  * erasure by channel drop when padding=False (unet.py:183) or zero-fill
    when padding=True (unet.py:180-182)
  * rawRange restriction of trained positions (unet.py:84-90)
  * the flow head fires at position k iff 0 <= k - raw_of_offset <
    tot_of_num (unet.py:247-259)

Layout at the boundary: NHWC. Cube inputs are (K, P, P, T*3) raw /
(K, P, P, T_of*2) flow, channel-stacked T-major; outputs (E, K, P, P, C).
`forward(x, x_of)` is the eval forward serving uses; `forward(x, x_of,
train=True, batch_weight=w)` the training forward (train/trainer.py).

A net made with `blocks=G` is G independent ensembles folded into one
network of G*E members, block-major (train/grid_trainer.py): it takes
(g, K, P, P, C) inputs, block b's own cubes in row b, for any g <= G (the
first g blocks run), and returns (g, E, K, P, P, C) outputs;
`batch_weight` is then (g, K).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from vec_vad_torch.config import CompletionConfig
from vec_vad_torch.device import resolve_device
from vec_vad_torch.models.layers import UNet


@dataclass(frozen=True)
class CompletionOutput:
    """raw_out/raw_tgt: (E, K, P, P, 3); of_out/of_tgt: (F, K, P, P, 2) or
    None. Sums over (E/F, P, P, C) are the reference's MSE sums."""

    raw_out: torch.Tensor
    raw_tgt: torch.Tensor
    of_out: Optional[torch.Tensor]
    of_tgt: Optional[torch.Tensor]


def _erase(x: torch.Tensor, k: int, ch: int, padding: bool) -> torch.Tensor:
    """Remove frame k from a channel-stacked input (unet.py:180-183)."""
    if padding:
        x = x.clone()
        x[..., k * ch : (k + 1) * ch] = 0.0
        return x
    return torch.cat([x[..., : k * ch], x[..., (k + 1) * ch :]], dim=-1)


def _members_in(stack: torch.Tensor,
                memory_format: torch.memory_format) -> torch.Tensor:
    """(G, E, K, P, P, C) NHWC member stack -> (K, G*E*C, P, P),
    block-major then member-major, in memory_format: one copy (into a
    physical (K, P, P, G*E*C) tensor for channels_last)."""
    G, E, K, P, Q, C = stack.shape
    out = torch.empty((K, G * E * C, P, Q), dtype=stack.dtype, device=stack.device,
                      memory_format=memory_format)
    out.unflatten(1, (G, E, C)).copy_(stack.permute(2, 0, 1, 5, 3, 4))
    return out


def _members_out(y: torch.Tensor, members: int) -> torch.Tensor:
    """(K, E*C, P, P) -> (E, K, P, P, C): a view (of a channels_last y's
    (K, P, P, E, C))."""
    K, EC, P, Q = y.shape
    return y.reshape(K, members, EC // members, P, Q).permute(1, 0, 3, 4, 2)


class SelfCompletionNet(nn.Module):
    """Erased-position completion ensemble (see module docstring)."""

    def __init__(self, features_root: int = 32, tot_raw_num: int = 5,
                 tot_of_num: int = 1, border_mode: str = "predict",
                 raw_range: Optional[int] = None, use_flow: bool = True,
                 padding: bool = False, raw_channels: int = 3,
                 of_channels: int = 2, blocks: int = 1, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.blocks = blocks
        self.tot_raw_num = tot_raw_num
        self.tot_of_num = tot_of_num
        self.border_mode = border_mode
        self.raw_range = raw_range
        self.use_flow = use_flow
        self.padding = padding
        self.raw_channels = raw_channels
        self.of_channels = of_channels
        in_ch = raw_channels * (tot_raw_num - (0 if padding else 1))
        self.raw_unets = UNet(blocks * len(self.raw_positions), in_ch,
                              features_root, raw_channels, dev)
        self.of_unets = None
        if use_flow and self.flow_positions:
            self.of_unets = UNet(blocks * len(self.flow_positions), in_ch,
                                 features_root, of_channels, dev)

    @property
    def raw_positions(self) -> List[int]:
        if self.raw_range is None:
            return list(range(self.tot_raw_num))
        r = self.raw_range
        if r < 0:
            r += self.tot_raw_num
        assert 0 <= r < self.tot_raw_num
        return [r]

    @property
    def raw_of_offset(self) -> int:
        if self.border_mode in ("predict", "elasticPredict"):
            return (self.tot_raw_num - 1) - (self.tot_of_num - 1)
        return (self.tot_raw_num - 1) // 2 - (self.tot_of_num - 1) // 2

    @property
    def flow_positions(self) -> List[Tuple[int, int]]:
        """(raw position k, flow slot of_i) pairs where the flow head fires."""
        return [
            (k, k - self.raw_of_offset)
            for k in self.raw_positions
            if 0 <= k - self.raw_of_offset < self.tot_of_num
        ]

    def forward(self, x: torch.Tensor, x_of: Optional[torch.Tensor],
                train: bool = False,
                batch_weight: Optional[torch.Tensor] = None) -> CompletionOutput:
        """train=True uses (and updates) the BatchNorm batch statistics;
        batch_weight, an optional (K,) 0/1 pad mask, restricts them to the
        weighted rows (vec_vad_tpu/models/completion.py:106-166). A
        (g, K, P, P, C) x (with (g, K, ...) x_of and a (g, K)
        batch_weight) runs the first g blocks of a grid net."""
        grid = x.dim() == 5
        if not grid:
            x = x[None]
            x_of = None if x_of is None else x_of[None]
        G = x.shape[0]
        ch = self.raw_channels
        positions = self.raw_positions
        erased = torch.stack(
            [_erase(x, k, ch, self.padding) for k in positions], dim=1
        )  # (G, E, K, P, P, C_in)
        raw_tgt = torch.stack(
            [x[..., k * ch : (k + 1) * ch] for k in positions], dim=1
        )
        E = len(positions)
        raw_out = _members_out(
            self.raw_unets(_members_in(erased, self.raw_unets.memory_format(x.dtype)),
                           train, batch_weight), G * E)

        of_out = of_tgt = None
        if self.of_unets is not None:
            # one member per firing (position, slot) pair, as in the JAX
            # package (a slot fires from at most one position)
            fpos = self.flow_positions
            och = self.of_channels
            # stacked views: a list index would be copied to the device,
            # which waits for the stream, on every forward
            flow_in = torch.stack([erased[:, positions.index(k)] for k, _ in fpos],
                                  dim=1)
            of_out = _members_out(
                self.of_unets(_members_in(flow_in, self.of_unets.memory_format(x.dtype)),
                              train, batch_weight),
                G * len(fpos))
            assert x_of is not None, "use_flow=True requires x_of"
            of_tgt = torch.stack(
                [x_of[..., i * och : (i + 1) * och] for _, i in fpos], dim=1
            )
        if grid:
            raw_out = raw_out.reshape(raw_tgt.shape[:2] + raw_out.shape[1:])
            if of_out is not None:
                of_out = of_out.reshape(of_tgt.shape[:2] + of_out.shape[1:])
        else:
            raw_tgt = raw_tgt[0]
            if of_out is not None:
                of_tgt = of_tgt[0]
        return CompletionOutput(raw_out, raw_tgt, of_out, of_tgt)


def make_completion_net(cfg: CompletionConfig, device="cuda",
                        blocks: int = 1) -> SelfCompletionNet:
    """The net the reference would select for this config
    (train.py:260-268), in eval mode; `blocks` > 1 folds that many
    independent ensembles into one grid net."""
    return SelfCompletionNet(
        features_root=cfg.nf,
        tot_raw_num=cfg.tot_raw_num,
        tot_of_num=cfg.tot_of_num,
        border_mode=cfg.border_mode,
        raw_range=cfg.resolved_raw_range,
        use_flow=cfg.use_flow,
        padding=cfg.padding,
        blocks=blocks,
        device=device,
    ).eval()


def init_completion_state(net: SelfCompletionNet, seed: int = 0) -> dict:
    """A random state dict for `net` drawn from a numpy seed: torch's
    default U(±1/sqrt(fan_in)) conv init, BN affine 1/0 and running
    statistics near (0, 1) so eval-mode BN is not the identity."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, t in net.state_dict().items():
        shape = tuple(t.shape)
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "running_mean":
            v = rng.normal(0.0, 0.1, shape)
        elif leaf == "running_var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name.endswith("bn0.weight") or name.endswith("bn1.weight"):
            v = np.ones(shape)
        elif name.endswith("bn0.bias") or name.endswith("bn1.bias"):
            v = np.zeros(shape)
        else:
            # conv fan_in = I*k*k; for a grouped transposed conv (E*I, O, k, k)
            # torch's fan is O*k*k — both are the product of dims 1..3
            fan = int(np.prod(_weight_shape(net, name)[1:]))
            bound = 1.0 / np.sqrt(fan)
            v = rng.uniform(-bound, bound, shape)
        out[name] = torch.from_numpy(np.asarray(v, np.float32))
    return out


def _weight_shape(net: nn.Module, name: str):
    """Shape of the weight beside parameter `name` (a bias' fan_in comes
    from its layer's weight)."""
    return tuple(net.get_parameter(name.rsplit(".", 1)[0] + ".weight").shape)
