"""A camera fleet with live optical flow: `MultiCameraFlowScorer.push_tick`
(vec_vad_torch/serve/live_flow.py). Each tick writes the C frames, runs
the C frame pairs (previous frame, this one) through one FlowNet2
forward at the model size (384 x 512) with FlowNetC's cost volume on the
program's CUDA kernel, and scores the previous frame of every camera;
tick u returns frame u-1's C scores. The FlowNet2 instance is the
harness's, built by the program's class with the benchmark's weights,
and handed to the scorer (f32 serves that instance itself).

Traffic parameters: the fleet's (drivers/fleet.py).
"""

from __future__ import annotations

import contextlib

import torch

from vadbench import traffic
from vadbench.drivers import fleet
from vadbench.drivers._common import completion_rows
from vadbench.reference import flownet2 as ref_flownet2


class Driver(fleet.Driver):
    def setup(self):
        from vec_vad_torch.models.flownet.flownet2 import FlowNet2

        flow = self.config["flow"]
        self.flow_hw = tuple(flow["model_hw"])
        self.flow_weights = traffic.weights(ref_flownet2.spec(), self.run.seed,
                                            self.run.device, stream=6)
        self.flow_net = FlowNet2(device=self.run.device).eval()
        self.flow_net.load_state_dict(self.flow_weights)
        super().setup()

    def _make_scorer(self):
        from vec_vad_torch.serve import MultiCameraFlowScorer

        return MultiCameraFlowScorer(
            self.cfg, self.weights, self.stats, n_cameras=self.C,
            flow_net=self.flow_net, flow_model_hw=self.flow_hw,
            max_boxes=int(self.tr["max_boxes"]),
            pipeline_depth=int(self.tr["pipeline_depth"]), device=self.run.device)

    def _scored_frame(self, u: int) -> int:
        return u - 1

    def _work(self, valid: int) -> dict:
        return {"valid_cubes": valid, "flow_pairs": self.C}

    @contextlib.contextmanager
    def trace_hooks(self):
        records = {"cameras": self.C, "k1_batch": self.C}
        cuda = self.run.device.type == "cuda"
        marks = []

        def pre(module, args):
            if cuda:
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                marks.append([e, None])

        def post(module, args, out):
            if cuda:
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                marks[-1][1] = e

        handles = [self.flow_net.register_forward_pre_hook(pre),
                   self.flow_net.register_forward_hook(post)]
        try:
            with completion_rows(records):
                yield records
        finally:
            for h in handles:
                h.remove()
            if cuda:
                torch.cuda.synchronize()
                records["flownet2_ms"] = [a.elapsed_time(b) for a, b in marks
                                          if b is not None]

    def release(self):
        del self.flow_net
        super().release()

    def _flows(self, t: int, lowp: bool):
        """(C, 1, H, W, 2) flow of frame t: the pair (t, t+1)."""
        P = self.pool.shape[0]
        f0 = torch.from_numpy(self.pool[t % P]).to(self.run.device)
        f1 = torch.from_numpy(self.pool[(t + 1) % P]).to(self.run.device)
        flow = ref_flownet2.frame_flow(self.flow_weights, f0, f1, self.flow_hw, lowp)
        return flow[:, None]
