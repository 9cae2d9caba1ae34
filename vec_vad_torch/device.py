"""The port's device rule: the card by default, the CPU only when asked."""

from __future__ import annotations

import contextlib

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


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_dtype(dtype) -> torch.dtype:
    """torch.float32 or torch.bfloat16 for a compute dtype given as either
    torch dtype or its name ("float32", "bfloat16")."""
    if isinstance(dtype, torch.dtype) and dtype in _DTYPES.values():
        return dtype
    if dtype in _DTYPES:
        return _DTYPES[dtype]
    raise ValueError(f"unsupported compute dtype {dtype!r}: float32 or bfloat16")


@contextlib.contextmanager
def full_f32(dtype=torch.float32):
    """For the duration of the block, f32 convolutions and matmuls on the
    card in full f32: cuDNN's TF32 (on by torch's default) and matmul's
    TF32 off, the caller's settings restored after. TF32 keeps about three
    decimal digits, which moves FlowNet2's flow past the 1e-3 bound that
    holds the card to the f32 computation on the CPU. Any other `dtype`
    (a bf16 route) leaves both settings as they are."""
    if dtype != torch.float32:
        yield
        return
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
