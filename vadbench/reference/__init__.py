"""Plain PyTorch reference of what each cell's timed path computes: the
completion ensemble (VEC_VAD model/unet.py, one member at a time),
spatio-temporal cube extraction (vad_datasets.py's crop and cv2 resize),
the z-normalised fusion and frame maximum (test.py), a training step with
Adam (train.py), and FlowNet2 (FlowNet2_src) with its cost volume as an
einsum. NCHW throughout, float32 with TF32 off unless `tf32=True` asks for
the control's precision (operands rounded to TF32's 10-bit mantissa).

Imports neither the program nor JAX: it takes the benchmark's inputs and
weights and works out everything the program derived from them again.
"""

import contextlib

import torch


@contextlib.contextmanager
def reference_context():
    """Float32 convolutions and matrix products without TF32 on the card,
    and no autograd unless a step asks for it; the settings are restored
    after."""
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
