"""Online serving (vec_vad_tpu/serve): the single-stream scorer over a
device frame ring and its live-flow two-stream variant."""

from vec_vad_torch.serve.live_flow import FlowStreamingScorer  # noqa: F401
from vec_vad_torch.serve.streaming import StreamingScorer  # noqa: F401
