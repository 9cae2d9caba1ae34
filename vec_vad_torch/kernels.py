"""Building and loading the port's hand-written CUDA kernels, and the
launch counts that show a run went through them.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by
`nvcc` for sm_90a into a shared library loaded with ctypes (seconds to
build, where a source that includes PyTorch's headers takes minutes).
Libraries land in `build/kernels/` at the repository root (listed in
.gitignore), named by a hash of their source and flags, so an edited
source is never served by a stale library. Nothing is built at import
time: the first launch builds, or `build_kernels()` builds every source
in parallel up front.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

# kernel name -> launches since the last reset_launch_counts(); a wrapper
# adds one exactly where it launches its kernel
launch_counts: Counter = Counter()

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launch_counts() -> None:
    launch_counts.clear()


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a CUDA host")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _start_build(name: str):
    """Start nvcc for csrc/<name>.cu unless its library exists; returns
    (popen or None, output path)."""
    out = _lib_path(name)
    if out.exists():
        return None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, out


def _finish_build(name: str, proc, out: Path) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)
    out.with_suffix(".log").write_text(log)
    return log


def build_kernels(names: Iterable[str]) -> Dict[str, str]:
    """Build every named source at once (one nvcc each, all started
    together); returns name -> nvcc's output ('' when already built)."""
    names = list(names)
    with _lock:
        started = [(n, *_start_build(n)) for n in names]
        return {n: _finish_build(n, p, o) for n, p, o in started}


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_kernels([name])
        lib = _libs[name] = ctypes.CDLL(str(_lib_path(name)))
    return lib


def launch(name: str, symbol: str, ptrs, ints, device) -> None:
    """Call csrc/<name>.cu's C entry point `symbol` with device pointers
    `ptrs` and int arguments `ints` on `device`'s current stream; raise if
    it returns a CUDA error. Counts one launch of `name`."""
    import torch

    fn = getattr(load_library(name), symbol)
    fn.argtypes = ([ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * len(ints)
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = fn(*ptrs, *ints, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launch_counts[name] += 1
