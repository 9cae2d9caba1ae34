"""vec_vad_torch — the PyTorch/CUDA port of vec_vad_tpu for one NVIDIA H100.

The JAX package (vec_vad_tpu) is the reference: this package mirrors its
module paths and public layouts (NHWC feature maps, (B, 2, H, W, 3) frame
pairs, (K, T, P, P, C) cubes) and is tested against it on the same inputs
and weights. It imports torch and never jax, flax, optax or vec_vad_tpu.

Device rule: every entry point takes `device="cuda"` by default and raises
where no card is present, unless the caller asks for `device="cpu"`.
On the CPU a kernel wrapper runs its plain PyTorch version; on a CUDA
tensor it launches its hand-written kernel or raises.

Ported so far:
  * live-flow two-stream serving — serve.live_flow.FlowStreamingScorer over
    FlowNet2 (models.flownet), STC extraction (ops.stc) and the completion
    ensemble (models.completion);
  * flow training — flow.trainer.FlowTrainer and flow.harness.FlowHarness
    over the FlowNet2 family with the flow datasets and losses, reference
    checkpoint loading, and the flow-train / flow-infer CLI
    (`python -m vec_vad_torch`).
The FlowNetC correlation is differentiable and runs as hand-written CUDA
kernels on the card: csrc/correlation.cu forward, csrc/correlation_bwd.cu
backward.
"""

__version__ = "0.1.0"

from vec_vad_torch.config import (  # noqa: F401
    DATASETS,
    CompletionConfig,
    DatasetSpec,
    ForegroundConfig,
    PipelineConfig,
    load_ini_config,
)
from vec_vad_torch.device import resolve_device  # noqa: F401
