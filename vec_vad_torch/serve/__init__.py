"""Online serving (vec_vad_tpu/serve): the single-stream scorer over a
device frame ring, its live-flow two-stream variant, their camera fleets,
and the self-contained motion scorers, whose foreground boxes come from
motion maps computed in the loop (MotionStreamingScorer; with FlowNet2 in
the loop too, MotionFlowStreamingScorer), and the fleet that finds its
own foreground with the Cascade R-CNN in every tick
(DetectingFleetScorer). Each scores one frame at a time
(`push`), k frames of a stream (`push_many`, not the motion scorers) or
one frame from each of C cameras (`push_tick`), in f32 with TF32 off or
in bf16, with pipelined result downloads, and times its own device step
(`time_device_step` / `time_device_tick`).

Every scoring call is the span `vec_vad_torch.serve.tick`, holding
`serve.stage` (input checks, index math, pinned uploads), `serve.flow`
(live FlowNet2), `serve.stc` (cube extraction), `serve.ensemble` (the
completion nets), `serve.wait` (the host blocked on the download) and
`serve.finish` (score routing on the host), and on the detecting fleet
`serve.detect` (the detector's forward and its filter); ring writes and window
gathers are the tick's own. They cost one flag check each unless a torch
profiler records: run `torch.profiler.profile` around the calls to see
them beside the kernels (runtime.profiling.annotate)."""

from vec_vad_torch.serve.fleet import MultiCameraScorer  # noqa: F401
from vec_vad_torch.serve.detect_fleet import DetectingFleetScorer  # noqa: F401
from vec_vad_torch.serve.live_flow import (  # noqa: F401
    FlowStreamingScorer,
    MultiCameraFlowScorer,
)
from vec_vad_torch.serve.motion import MotionStreamingScorer  # noqa: F401
from vec_vad_torch.serve.motion_flow import MotionFlowStreamingScorer  # noqa: F401
from vec_vad_torch.serve.streaming import StreamingScorer  # noqa: F401
