"""PNG files without cv2: the port's counterpart of cv2.imwrite and
cv2.imread(IMREAD_UNCHANGED) for PNGs, which the card's machine has no
cv2 for.

`encode_png` / `write_png` write 8-bit gray, 8-bit and 16-bit 3-channel
images with zlib and numpy (filter type 0 on every row); like cv2, a
3-channel array is taken as BGR. `read_png` decodes through the port's
libpng (csrc/vadio.cpp, `runtime/native_loader.py`) keeping the file's
channels and bit depth, as cv2.imread(IMREAD_UNCHANGED) does: (H, W) for
gray, (H, W, 3) BGR, (H, W, 4) BGRA, uint8 or uint16.
"""

from __future__ import annotations

import ctypes
import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """The PNG file of a uint8 (H, W) gray, uint8 (H, W, 3) BGR or uint16
    (H, W, 3) BGR image."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG pixels are uint8 or uint16, got {img.dtype}")
    if img.ndim == 2 and img.dtype == np.uint8:
        color_type, rows = 0, img
    elif img.ndim == 3 and img.shape[2] == 3:
        color_type, rows = 2, img[:, :, ::-1]  # BGR -> the file's RGB
    else:
        raise ValueError(
            f"write 8-bit (H, W) gray or (H, W, 3) BGR, got {img.dtype} {img.shape}"
        )
    h, w = img.shape[:2]
    depth = 8 * img.dtype.itemsize
    pixels = rows.astype(rows.dtype.newbyteorder(">"), copy=False)
    raw = np.empty((h, 1 + pixels[0].nbytes), np.uint8)
    raw[:, 0] = 0  # filter type 0 (None) on every row
    raw[:, 1:] = np.ascontiguousarray(pixels).view(np.uint8).reshape(h, -1)
    header = struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """cv2.imwrite(path, img) for the images `encode_png` takes."""
    with open(path, "wb") as f:
        f.write(encode_png(img))


def read_png(path: str) -> np.ndarray:
    """cv2.imread(path, IMREAD_UNCHANGED) for a PNG, through libpng."""
    from vec_vad_torch.runtime.native_loader import get_lib, probe_image

    h, w, c, depth = probe_image(path)
    out = np.empty((h, w, c), np.uint16 if depth == 16 else np.uint8)
    rc = get_lib().vadio_decode_png(
        os.fsencode(path), out.ctypes.data_as(ctypes.c_void_p), h, w, c, depth
    )
    if rc:
        raise IOError(f"{path}: PNG decode failed ({rc})")
    return out[:, :, 0] if c == 1 else out
