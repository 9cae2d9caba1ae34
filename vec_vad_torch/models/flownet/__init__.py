from vec_vad_torch.models.flownet.flownet2 import FlowNet2, make_flownet2  # noqa: F401
from vec_vad_torch.models.flownet.nets import (  # noqa: F401
    FlowNetC,
    FlowNetFusion,
    FlowNetS,
    FlowNetSD,
    init_flownet_,
)
from vec_vad_torch.models.flownet.ops import (  # noqa: F401
    channel_norm,
    correlation,
    correlation_bwd_ref,
    correlation_ref,
    upsample_bilinear,
    upsample_nearest,
    warp_bilinear,
)
