from vec_vad_torch.models.flownet.convert import load_flownet_checkpoint  # noqa: F401
from vec_vad_torch.models.flownet.flownet2 import (  # noqa: F401
    FlowNet2,
    FlowNet2C,
    FlowNet2CS,
    FlowNet2CSS,
    FlowNet2S,
    FlowNet2SD,
    make_flownet2,
)
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
    correlation_bwd,
    correlation_bwd_ref,
    correlation_ref,
    upsample_bilinear,
    upsample_nearest,
    warp_bilinear,
)
