"""ctypes bindings for the port's native frame decoder (csrc/vadio.cpp), a
port of vec_vad_tpu/runtime/native_loader.py.

A LazyFrameStack replacement that decodes JPEG/PNG/TIFF frame chunks with
a C++ thread pool into preallocated buffers, and a background prefetcher
that pipelines the next chunk's disk and decode work under the current
chunk's device compute, in place of the reference's per-frame cv2.imread
(vad_datasets.py:18-25,356-402). The frames equal cv2.imread's (BGR
uint8, grayscale expanded to 3 channels).

The library is built at first use by g++ (libjpeg, libpng, libtiff) into
`build/kernels/`, named by a hash of its source and flags like the CUDA
kernels (`vec_vad_torch/kernels.py`), so an edited source is never served
by a stale library. A build that fails raises `NativeBuildError` with the
compiler's output: nothing falls back to cv2 for a format the decoder
reads. Other formats (`.npy`, `.bmp`) go through `LazyFrameStack`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from vec_vad_torch.kernels import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "vadio.cpp"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-shared"]
LDLIBS = ["-ljpeg", "-lpng", "-ltiff", "-lpthread"]

_LIB: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


class NativeBuildError(RuntimeError):
    """The decoder library did not build (a missing compiler or missing
    libjpeg/libpng/libtiff headers; the message holds the build log) or
    does not load (a library built where those libraries exist, loaded
    where they do not)."""


def _compiler() -> str:
    return os.environ.get("CXX", "g++")


def lib_path() -> Path:
    """build/kernels/libvadio-<hash of source and flags>.so"""
    key = SOURCE.read_bytes() + " ".join(CXX_FLAGS + LDLIBS).encode()
    return BUILD_DIR / f"libvadio-{hashlib.sha256(key).hexdigest()[:12]}.so"


def build_native() -> Path:
    """Build the library unless a library of this source exists; returns
    its path or raises NativeBuildError with the compiler's output."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_compiler(), *CXX_FLAGS, str(SOURCE), *LDLIBS, "-o", str(tmp)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:  # no compiler at all
        raise NativeBuildError(f"{' '.join(cmd)}\n{e}") from e
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"{' '.join(cmd)} failed ({r.returncode}):\n{r.stdout}{r.stderr}"
        )
    os.replace(tmp, out)
    return out


def get_lib(auto_build: bool = True) -> Optional[ctypes.CDLL]:
    """The loaded library, built first if need be. With auto_build=False,
    None when it is not built yet; a build that fails raises."""
    global _LIB
    with _lock:
        if _LIB is None:
            if not auto_build and not lib_path().exists():
                return None
            path = build_native()
            try:
                _LIB = _bind(ctypes.CDLL(str(path)))
            except OSError as e:
                raise NativeBuildError(f"{path} does not load: {e}") from e
        return _LIB


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.vadio_decode.restype = ctypes.c_int
    lib.vadio_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ]
    lib.vadio_probe.restype = ctypes.c_int
    lib.vadio_probe.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
    lib.vadio_decode_png.restype = ctypes.c_int
    lib.vadio_decode_png.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.vadio_pool_create.restype = ctypes.c_void_p
    lib.vadio_pool_create.argtypes = [ctypes.c_int]
    lib.vadio_pool_destroy.argtypes = [ctypes.c_void_p]
    lib.vadio_pool_decode_batch.restype = ctypes.c_int
    lib.vadio_pool_decode_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ]
    lib.vadio_prefetcher_create.restype = ctypes.c_void_p
    lib.vadio_prefetcher_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.vadio_prefetcher_destroy.argtypes = [ctypes.c_void_p]
    lib.vadio_prefetcher_next.restype = ctypes.c_int
    lib.vadio_prefetcher_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return lib


def _paths_array(paths: Sequence[str]):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [os.fsencode(p) for p in paths]
    return arr


_SUPPORTED = (".jpg", ".jpeg", ".png", ".tif", ".tiff")


def native_supported(path: str) -> bool:
    return os.path.splitext(path)[1].lower() in _SUPPORTED


def probe_image(path: str) -> Tuple[int, int, int, int]:
    """(height, width, channels, bit depth) from the file's header."""
    info = (ctypes.c_int * 4)()
    rc = get_lib().vadio_probe(os.fsencode(path), info)
    if rc:
        raise IOError(f"{path}: header probe failed ({rc})")
    return tuple(info)


class NativePool:
    """Thread-pool batch decoder."""

    def __init__(self, n_threads: Optional[int] = None):
        self.lib = get_lib()
        n_threads = n_threads or max(os.cpu_count() or 1, 1)
        self._pool = self.lib.vadio_pool_create(n_threads)

    def decode_batch(
        self, paths: Sequence[str], h: int, w: int,
        out: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        n = len(paths)
        if out is None:
            out = np.empty((n, h, w, 3), np.uint8)
        if out.shape != (n, h, w, 3) or out.dtype != np.uint8:
            raise ValueError(f"out must be uint8 {(n, h, w, 3)}, got "
                             f"{out.dtype} {out.shape}")
        errs = self.lib.vadio_pool_decode_batch(
            self._pool, _paths_array(paths), n,
            out.ctypes.data_as(ctypes.c_void_p), h, w,
        )
        if errs:
            raise IOError(f"{errs}/{n} frames failed native decode")
        return out

    def __del__(self):
        if getattr(self, "_pool", None) and self.lib is not None:
            self.lib.vadio_pool_destroy(self._pool)
            self._pool = None


class NativeFrameStack:
    """LazyFrameStack-compatible frame source backed by the native pool,
    for datasets whose frames the decoder reads (.jpg/.png/.tif: avenue,
    ShanghaiTech, UCSDped2); `make_frame_stack` picks it by extension.
    The frame shape comes from the first frame's header."""

    def __init__(self, index, n_threads: Optional[int] = None):
        if index.frame_paths is None:
            raise ValueError("index has no file paths")
        self.index = index
        self.pool = NativePool(n_threads)
        self._h, self._w = probe_image(index.frame_paths[0])[:2]
        self.shape = (index.total_frames, self._h, self._w, 3)
        self.dtype = np.dtype(np.uint8)

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, key):
        if isinstance(key, slice):
            idxs = list(range(*key.indices(self.shape[0])))
        elif np.isscalar(key) or isinstance(key, (int, np.integer)):
            idxs = [int(key)]
        else:
            key = np.asarray(key)
            out = self.pool.decode_batch(
                [self.index.frame_paths[int(i)] for i in key.ravel()],
                self._h, self._w,
            )
            return out.reshape(key.shape + out.shape[1:])
        out = self.pool.decode_batch(
            [self.index.frame_paths[i] for i in idxs], self._h, self._w
        )
        if np.isscalar(key) or isinstance(key, (int, np.integer)):
            return out[0]
        return out

    def __array__(self, dtype=None):
        out = self[0 : self.shape[0]]
        return out.astype(dtype) if dtype is not None else out


class NativePrefetcher:
    """Background chunk prefetcher over a file list."""

    def __init__(
        self, paths: List[str], chunk: int, h: int, w: int,
        n_threads: Optional[int] = None,
    ):
        self.lib = get_lib()
        self.chunk, self.h, self.w = chunk, h, w
        self._paths_keepalive = _paths_array(paths)
        self._pf = self.lib.vadio_prefetcher_create(
            self._paths_keepalive, len(paths), chunk, h, w,
            n_threads or max(os.cpu_count() or 1, 1),
        )

    def __iter__(self):
        while True:
            out = np.empty((self.chunk, self.h, self.w, 3), np.uint8)
            n = self.lib.vadio_prefetcher_next(
                self._pf, out.ctypes.data_as(ctypes.c_void_p)
            )
            if n == 0:
                return
            if n < 0:
                raise IOError(f"{-n} frame(s) failed native decode in chunk")
            yield out[:n]

    def __del__(self):
        if getattr(self, "_pf", None) and self.lib is not None:
            self.lib.vadio_prefetcher_destroy(self._pf)
            self._pf = None


def make_frame_stack(index, prefer_native: bool = True):
    """The frame source for this dataset: the native stack for
    .jpg/.jpeg/.png/.tif/.tiff frames (a decoder that fails to build
    raises), LazyFrameStack for other formats or with prefer_native=False."""
    from vec_vad_torch.data.readers import LazyFrameStack

    if prefer_native and index.frame_paths and native_supported(
        index.frame_paths[0]
    ):
        return NativeFrameStack(index)
    return LazyFrameStack(index)
