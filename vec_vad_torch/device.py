"""The port's device rule: the card by default, the CPU only when asked."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """torch.device for an entry point's `device` argument.

    A CUDA device with no card present raises: there is deliberately no
    "CUDA when present, else CPU" fallback, so a run that meant to use
    the card can never measure or serve on the CPU by accident. Tests
    pass device="cpu" explicitly. A bare "cuda" resolves to the current
    card's index, so it compares equal to the device of tensors on it."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={device!r} requested but no CUDA device is available; "
                "pass device='cpu' to run the plain PyTorch path"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
