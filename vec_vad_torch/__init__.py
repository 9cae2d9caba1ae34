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
    (`python -m vec_vad_torch`);
  * calc-flow — runner.run_calc_flow and the calc-flow CLI;
  * the main path, raw-only and two-stream (5raw1of over the calc-flow
    tree) — runner.run_train / run_test over pipeline.extract_cube_set,
    train.trainer.BlockTrainer and pipeline.score_cubes,
    infer.infer_frame_scores_resident, the AUROC of eval.metrics, models
    saved in the JAX package's .npz layout, and the train / test CLI;
  * foreground boxes from the frames — fore.motion (motion maps on the
    device, contours on the host without cv2), fore.detector.
    compute_foreground_bboxes, runner.run_precompute_boxes and the
    precompute-boxes CLI; load_split computes boxes where no fixture is;
  * serving at large — push_many, the camera fleets, bf16 scoring and the
    serve CLI, and the self-contained motion scorers
    (serve.MotionStreamingScorer, serve.MotionFlowStreamingScorer);
  * the model-block grid — train.grid_trainer.GridTrainer (the blocks
    folded into one network) behind train_model / score_cubes and
    infer.infer_frame_scores_grid; BlockTrainer.fit_block_budget, the demo
    (`python -m vec_vad_torch demo`, vec_vad_torch.demo), and the
    reference's model_set in and out (models.completion_convert /
    completion_export, the import-torch / export-torch CLI);
  * the tooling — the native frame decoder for .jpg/.png/.tif trees
    (runtime.native_loader over csrc/vadio.cpp, built by g++),
    utils.visualize / flowviz / png / gradtap / meters and the visualize
    and extract-frames CLI, the layer profiler (runtime.layer_profile),
    and the FlowNet family with with_bn=True;
  * the device mesh — parallel.Mesh / get_mesh (an ordered tuple of
    devices, which may repeat one) and every route that takes `mesh=`:
    BlockTrainer (data parallel, BatchNorm statistics over the whole
    batch), FlowTrainer, GridTrainer (blocks dealt over the entries),
    calc-flow (`run_calc_flow(use_mesh=)`, `calc-flow --no-mesh`) and
    both camera fleets; one replica of the model an entry, driven by one
    process.
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
