"""Writes this folder's fixture frames with cv2 from the synthetic
generator, and decoded.npz: cv2.imread's arrays for each file (BGR uint8).

    PYTHONPATH=. python tests/data/frames/make_frames.py

Three avenue-sized 360x640 .jpg frames (anomalous ones carry random colour
texture, so chroma is exercised) and UCSDped2-sized 240x360 .png and .tif
frames, each format once in gray and once in colour. The decoder tests
and chip_smoke.py read them.
"""

from pathlib import Path

import cv2
import numpy as np

from vec_vad_torch.data.synthetic import make_synthetic_dataset

HERE = Path(__file__).resolve().parent


def main() -> None:
    big = make_synthetic_dataset(n_train_videos=1, n_test_videos=1,
                                 frames_per_video=12, frame_h=360,
                                 frame_w=640, seed=0).test_frames
    small = make_synthetic_dataset(n_train_videos=1, n_test_videos=1,
                                   frames_per_video=12, frame_h=240,
                                   frame_w=360, seed=1).test_frames
    files = {f"avenue_{i}.jpg": big[t] for i, t in enumerate((0, 5, 11))}
    for ext in ("png", "tif"):
        files[f"ped2_gray.{ext}"] = small[2][:, :, 0]
        files[f"ped2_color.{ext}"] = small[5]
    decoded = {}
    for name, img in files.items():
        path = str(HERE / name)
        assert cv2.imwrite(path, img)
        decoded[name] = cv2.imread(path)
    np.savez_compressed(HERE / "decoded.npz", **decoded)


if __name__ == "__main__":
    main()
