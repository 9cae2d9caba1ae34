"""Smoke run of vec_vad_torch on one NVIDIA GPU: builds the hand-written
CUDA kernels, holds each against its plain PyTorch version, serves the
live-flow two-stream slice end to end at full width, trains FlowNetC
(and takes a FlowNet2 fine-tuning step) at FlyingChairs' 384x512, runs
calc-flow, train and test at full width, at dataset scale too, and
drives the serving surface (push_many, probes, bf16, camera fleets with
and without live flow, the serve CLI), then computes foreground boxes
from the frames and serves with them computed in the loop, runs the
converted mmdet Cascade R-CNN behind `mmdet_checkpoint`, and trains and
scores a 2x2 model grid with its blocks folded into one network, then
takes it out to the reference's model_set files and back, and drives the
tooling: the frame decoder's refusal where its libraries are missing,
calc-flow -> train -> test -> visualize on avenue's layout through the
CLI, the layer profiler, the with_bn FlowNets and GradTaps.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and skipped):
  1. the card (nvidia-smi name and power limit); TF32 off for cuDNN and
     matmul, so every comparison below is full f32; both kernel sources
     built at once (one nvcc each), with ptxas's registers, spills and
     shared memory for each kernel instantiation;
  2. kernels: K1 (csrc/correlation.cu) against `correlation_ref` at the
     serving shape (1, 48, 64, 256) and the training shape (8, 48, 64,
     256) in f32 and bf16 and at a ragged shape; K2
     (csrc/correlation_bwd.cu) against `correlation_bwd_ref` at the
     training shape, at FlowNet2 fine-tuning's batch-1 shape (1, 48, 64,
     256) and at a ragged shape, each in f32 and bf16. CUDA-event times
     beside the card's bound for the same work; the {"kernels": [...]}
     record keeps each kernel's first case (K1 serving, K2 training, f32);
     K1 also at calc-flow's f32 batch (4, 48, 64, 256);
  3. serving: FlowStreamingScorer on the card at UCSDped2's 240x360 with
     the 384x512 FlowNet2 protocol, a random-init FlowNet2 and a random
     5raw1of nf=32 two-stream model (numpy seeds), over seeded synthetic
     videos with 1-8 boxes a frame. Checks finite scores, one K1 launch
     per live push, K1 on the served conv3 features against the plain
     version, and the first video's first 4 scores against the same
     stream served on the CPU; then per-push latency, the time split
     between FlowNet2 and STC + ensemble, and a torch.profiler table of
     one more video's live pushes with the device's busy share and K1's
     share of it;
  4. training: FlowHarness.fit of the full FlowNetC (the `flow-train
     --net FlowNetC --loss multiscale` recipe: batch 8, Adam lr 1e-4)
     for 2 epochs over 16 seeded synthetic 384x512 pairs (smooth textures
     shifted by a known flow, held in memory). Checks the first step's
     loss against the same batch on the CPU, finite losses, one K1 and
     one K2 launch per step (validation: K1 only), and K1 and K2 on a
     real step's (a, b, g), taken by module hooks, against the plain
     versions; then ms per step over 24 steady steps, pairs/s, peak
     device memory and a torch.profiler table of a few steps with the
     device's busy share and K1's and K2's shares of it. Then 20
     single-scale L1 steps of PairMajorAdapter(FlowNet2) at batch 1, one
     K1 and one K2 launch each;
  5. calc-flow: `runner.run_calc_flow` on the card over a seeded synthetic
     UCSD-layout tree of .npy uint8 frames at 240x360 (148 frames in a
     Train and a Test split, one video of 2 frames) with the random-init
     FlowNet2 at the 384x512 protocol, three times: f32 whole-split
     (chunk 4), f32 segmented (24 frames a segment, a segment boundary
     inside a video) and bf16 (chunk 8). Checks a finite (240, 360, 2)
     float32 .npy for every frame, one K1 launch per FlowNet2 batch, the
     segmented and bf16 trees against the f32 whole-split tree, the
     2-frame video's maps on the card against the CPU's, straight from
     the flow driver and, for its (f0, f0) map, through run_calc_flow
     called with both TF32 flags on (its f32 route turns them off), and
     K1 on a real batch's conv3 features; prints maps/s with the time
     split into decode, FlowNet2 batches and .npy writes, peak device
     memory and a torch.profiler table of a few calc-flow batches.

  6. train-test: the raw-only main path (`train` then the card-side steps
     of `test`) at the flagship width, 5raw nf=32, patch 32, batch 128,
     3 epochs, Adam lr 1e-3 / eps 1e-7, over a seeded synthetic
     UCSD-layout tree of uint8 .npy frames at 240x360 with UCSDped2's
     frame counts (Train 16 videos, 2,550 frames; Test 12 videos, 2,010)
     and the generator's boxes as the bbox fixtures. `runner.run_train`
     on the card, then `load_split`, extraction, `score_cubes` and
     `frame_level_scores` for the test split, `evaluate_frame_scores` on
     the generator's labels (the card's machine has no cv2 to read UCSD's
     .bmp masks) and `infer_frame_scores_resident` on the same model.
     Checks the first step's loss against the CPU's (1e-4 relative),
     finite falling losses, the trained block's scores on 512 cubes
     against the CPU's (1e-4 of the largest), resident against offline
     frame scores (2e-4), the saved .npz scoring the same after
     `load_vad_model`, a finite AUROC and no K1 or K2 launch; prints
     cube counts, extraction s, training wall, ms per step, cubes/s,
     scoring frames/s both ways, peak device memory and torch.profiler
     tables of training steps and of one resident scoring call.
  7. two-stream: the paper's pipeline, calc-flow -> `train` -> `test`,
     with the 5raw1of model (nf=32, context_of_num 0, useFlow, patch 32,
     batch 128, 10 epochs, lambda and w 1) over a seeded synthetic tree of
     uint8 .npy frames at avenue's 360x640 in avenue's layout (Train and
     Test 6 videos of 160 frames each) with the generator's boxes as the
     fixtures and avenue's .mat pixel GT of its anomalous squares.
     `runner.run_calc_flow` (f32, random-init FlowNet2), `run_train`,
     then `load_split`, extraction, `score_cubes`, `frame_level_scores`
     and `evaluate_frame_scores` with and without per-video
     normalisation, and `infer_frame_scores_resident` with the flow tree.
     Checks a finite (360, 640, 2) float32 map for every frame, one K1
     launch per FlowNet2 batch in calc-flow and none in train and test,
     finite falling losses, finite flow training scores with a nonzero
     std, the first step's loss and the trained block's raw and flow
     scores on 512 cubes against the CPU's (1e-4), resident against
     offline frame scores (2e-4), the reloaded .npz (weights and
     of_scores bit for bit, cube scores within 2e-4) and finite AUROCs;
     prints calc-flow maps/s split into decode, batches and writes, the
     cubes the motion filter dropped, run_train's wall and extraction,
     ms per step, cubes/s, frames/s both ways, peak device memory and
     torch.profiler tables of training steps, a resident call and the
     raw and flow UNet chains alone.
  8. dataset-scale: on phase 7's tree and flow tree (no calc-flow again),
     `run_train` in bf16 with `resident=True` (under a base of its own:
     the model path is the same for both dtypes), `run_test(resident=True,
     pixel_criterion=True)` on phase 7's f32 model, and the whole-split
     scorers. Checks f32 master parameters and Adam moments, finite
     falling losses, the bf16 raw training scores against phase 7's f32
     ones (correlation > 0.98, mean ratio within 0.15), the resident
     cubes on the card and equal to phase 7's cached cubes (raw bit for
     bit, flow 1e-6 of its largest, metadata), the resident test's frame
     scores against phase 7's (2e-4) and a finite pixel AUROC, the device
     splat and pixel reduction equal to the host's (timed at the split's
     960 frames and tiled 4x, past the JAX package's routing thresholds),
     the segmented (64-frame segments) scorer and infer_frame_scores on
     one segment and budget-routed against the resident one (2e-4), and
     bf16 scoring's AUROC within 0.02 of f32's;
     prints ms per bf16 step beside phase 7's f32 step, run_train's wall
     and extraction, frames/s and peak device memory of every scorer, and
     a torch.profiler table of 5 bf16 steps with the transposes' share.
  9. serving surface: on phase 3's model, FlowNet2 (rebuilt from its seed)
     and stream with seeded precomputed flow maps, then on phase 7's
     workspace (deleted after). (a) a StreamingScorer with both TF32 flags
     on scores as with them off and leaves them on (and, with its
     full_f32 taken out, how far TF32 moves the scores); (b)
     pipeline_depth 2 equal to depth 0 bit for bit, sustained frames/s of
     each, unsynchronised; (c) push_many at k=8 of both scorers against
     k pushes (2e-4 of the largest score), frames/s, one K1 launch a
     batch, K1 on a batch's conv3 features against the plain version;
     (d) time_device_step of both beside the synchronised push median,
     the probed streams' scores equal to unprobed ones; (e) bf16 scoring
     against f32 (correlation > 0.98), ms per push of each; (f)
     MultiCameraScorer at C=8, each camera on its own 24-frame video
     started a tick after the previous one, against a StreamingScorer
     per video (2e-4), ms/tick, aggregate frames/s, time_device_tick
     batched and as a per-camera loop; (g) MultiCameraFlowScorer at C=8
     with FlowNet2: one K1 launch a live tick, K1 on a tick's conv3
     features, each camera against a FlowStreamingScorer (2e-4), the
     batched flow against each pair alone (1e-3 of the largest |flow|),
     ms/tick, frames/s, time_device_tick, peak memory; (h) `serve`
     through cli.main on phase 7's workspace: the streamed AUROC over the
     test split within 1e-3 of phase 7's, `--live-flow --frames 160` and
     `--cameras 8 --live-flow --frames 32` (spread 2e-4 of the largest
     score), one K1 launch a live push or tick, and FlowStreamingScorer
     over the first test video against phase 7's offline frame scores
     (5e-4 of the largest).
 10. foreground: a seeded synthetic tree in ShanghaiTech's layout at
     480x856 (2 + 2 videos of 80 frames, .npy frames, the test videos'
     frame labels in Testing/test_frame_mask) and the 5raw1of model
     (nf=32, patch 32, batch 128, 10 epochs, 64 boxes). (a) motion maps
     of 64 windows at 480x856 (k 5, threshold 15) and at 240x360 (k 3,
     threshold 18) on the card against the CPU, bit for bit, with the
     map pass's ms per 64 frames (CUDA events) and the host contours' ms
     a frame; (b) `precompute-boxes` through cli.main (motion-only):
     frames/s with the frame reads, the map pass, the downloads and the
     contours apart, the first 32 test frames' boxes on the CPU equal to
     the card's and the fixture's, and `load_split` without the fixture
     computing the same boxes; (c) calc-flow (one K1 launch a batch of
     4), `run_train` and `run_test` on those boxes, the AUROC; (d) `serve
     --motion` and `serve --motion --live-flow` through cli.main over the
     test split: each streamed AUROC within 1e-3 of `test`'s, the frame
     scores within 5e-4 of the largest of `test`'s, push median and p90,
     each scorer's time_device_step, one K1 launch a live push and K1 on
     a live push's conv3 features; (e) MotionStreamingScorer with
     appearance boxes merged over a 24-frame and a 2-frame video against
     the offline pipeline on compute_foreground_bboxes' boxes (2e-4), a
     1-frame video against StreamingScorer's score of its appearance box
     and -big_number without one.
 11. detector: on phase 10's tree (deleted after), the converted mmdet
     Cascade R-CNN at full width (R101-FPN, 256-channel pyramid, 1,000
     proposals, three fc-1024 stages, 81 classes) on 480x856 frames
     resized on the card to 747x1333 on a 768x1344 canvas. (a) a seeded
     random checkpoint under mmdet v1's names (fore.mmdet_detector.
     random_cascade_state: 88,492,238 parameters and BN statistics), the
     regression weights and the other classes' fc_cls rows scaled by 1e-2
     (boxes near their anchors, person's logit deciding) and the person
     bias set so that 12 RoIs a frame of 4 test frames clear 0.5, saved under
     build/; (b) 2 frames on the card and on the CPU: the pyramid, and
     each stage on the CPU from the card's rois of that stage, within
     1e-4 of the largest;
     the CPU's multiclass NMS on the card's boxes equal; the independent
     runs' proposals matched as sets (0.95), their detections over
     ap_score_thr matched and reported; (c)
     `precompute-boxes --splits train` with `mmdet_checkpoint` in the
     INI through cli.main: frames/s, detect_many's share, peak device
     memory; (d) `run_train` on that fixture and `run_test` with no test
     fixture, so `load_split` runs the detector on the test split, to a
     finite AUROC; over both splits the frames with an appearance box and
     every frame's boxes leading with its filtered appearance boxes; (e) ms a frame at batch 4 (CUDA
     events) for the resize and upload, backbone + FPN, RPN with its
     NMS, the three stages, the multiclass NMS, and the rest of
     detect_many's wall, and a torch.profiler table of one batch.
 12. model grid: a seeded synthetic tree at UCSDped2's 240x360 (6 + 4
     videos of 100 frames, .npy frames) in avenue's layout with its .mat
     pixel GT (run_test reads it through scipy; the ped layout's .bmp
     needs cv2), a 2x2 grid (h_block = w_block = 2) and the raw-only
     model at the flagship width (5raw nf=32, patch 32, batch 128) cut
     to 5 epochs. (a) `run_train`, checked to take GridTrainer.fit_blocks
     (a wrapped call) with at least 3 blocks, then `train_model(
     parallel_blocks=False)` on the same cubes: per-block training scores
     within 5e-3 of the block's largest (GR_REL) and first losses within
     1e-4, the first grid step's losses against the CPU's grid (1e-4);
     a block stopped after its last step (128 cubes, 5 steps, beside one
     of 15) equal bit for bit after the grid's last step (weights,
     running statistics, Adam moments and step); `run_test` (score_cubes'
     grid branch) and the model's cubes scored block after block (2e-4
     of the largest, a block left out: its big_number rows equal), the
     AUROC within 5e-3 of the sequential model's, infer_frame_scores_grid
     against frame_level_scores(score_cubes(...)) (2e-4); (b) 5raw1of on
     seeded flow maps (frame differences; no calc-flow): raw and flow
     training scores grid against sequential (GR_REL); (c) bf16 grid
     against the f32 grid's training scores (correlation > 0.98, mean
     ratio 1 +- 0.15); (d) ms per grid step of 4 equal blocks in f32 and
     bf16 against 4 x one block's step, train_model's wall both ways
     (warm), the device's busy share, top operators and genericTranspose's
     share of 5 grid steps, peak device memory beside GridTrainer's
     estimate, score_cubes' frames/s both ways and infer_frame_scores_
     grid's; (e) fit_block_budget of the largest block, its phases; (f)
     `export-torch` then `import-torch` through cli.main: weights and
     training scores bit for bit, `run_test` on the imported model within
     1e-6 of the original's; (g) `python -m vec_vad_torch demo` in its own
     process: exit 0 and a finite AUROC. No K1 or K2 launch in the phase.
 13. tooling: (a) the native frame decoder on this machine, which has no
     libjpeg, libpng or libtiff: its build fails (or a library built
     elsewhere does not load) and make_frame_stack raises for the
     committed fixture jpgs (tests/data/frames) instead of falling back;
     (b) avenue's layout at 360x640, 2 + 2 videos of 40 .npy frames
     cycled from the fixture jpgs' cv2 decode (decoded.npz), with .mat
     GT marking the frames of the anomalous fixture, and the 5raw1of
     model (nf=32, patch 32, batch 128) for 1 epoch: `calc-flow` (one K1
     launch a batch of 4), `train` and `test --save-masks` through
     cli.main on motion-only boxes load_split computes, every frame stack
     made through runner.make_frame_stack and calc-flow's frames equal to
     the fixture's arrays, maps/s, a finite AUROC; (c) `visualize
     --masks ... --flow-dir ... --config` through cli.main: 3 x 40 PNGs,
     nine of them byte for byte the PNG encoding of visualize_score,
     score_mask_overlay and flow_to_image (this machine has no libpng to
     decode them); (d) the layer profiler: the UNet's 3x3 convolutions at
     batch 512 in f32 and bf16, the four ensemble layouts at (128, E=4,
     32, 32) in both dtypes (vmap, grouped and blockdiag within 1e-5 of
     the largest output in f32, sharedw_batch on member 0), the FLOPs of
     a cube beside the JAX package's constant, the completion net's fwd
     and fwdbwd at 128 and 1024 cubes, each as ms, TFLOP/s and share of
     the card's peak; (e) FlowNet2(with_bn=True) with seeded BatchNorm
     statistics through a reference-keyed .pth and load_flownet_checkpoint,
     (1, 2, 384, 512, 3) card against CPU (1e-3 of the largest |flow|),
     its forward ms beside with_bn=False's (CUDA events), K1 on its conv3
     features, one K1 launch a forward; a train-mode FlowNetC(with_bn=
     True) at batch 8: running statistics card against CPU (1e-5 of each
     tensor's largest); (f) a GradTaps tap on FlowNetC's conv6_1 under a
     loss on flow6, equal to autograd's gradient of the tapped tensor on
     each device, the card's against the CPU's (1e-4 of the largest
     gradient), one K1 and one K2 launch.
 14. mesh: every route that takes a device mesh, on the mesh that names
     this card twice (["cuda:0", "cuda:0"]: two replicas on one card, the
     one-card machine's only mesh), each against the same call on one
     card: (a) BlockTrainer at the flagship raw-only width (5raw nf=32,
     patch 32, batch 128 = 2 x 64) for 5 steps in f32 (losses of steps
     1-2 within 1e-5 relative, every step's 2e-4, the first step's
     gradients 1e-4 of the largest, training scores 2e-4 of the largest;
     beside them the one-card fit's drift from itself, run again and with
     each batch's rows reversed) and bf16 (phase 8's bounds on the
     training scores); (b)
     FlowTrainer on FlowNetC at 384x512, batch 7 padded to 8, 3 steps
     (losses as in (a)), two K1 and two
     K2 launches a step, K1 and K2 on a replica's (a, b, g) at B = 4
     against their plain versions; (c) calc-flow's resident driver on 40
     maps at 240x360 in batches of 4 (1e-4 of the largest |flow|); (d)
     MultiCameraScorer and MultiCameraFlowScorer at C = 8, 4 cameras a
     replica (scores 2e-4 of the largest); (e) a 2x2 grid of 4 blocks
     dealt 2 + 2 (training scores 2e-4 of the largest, then the folded
     scoring); (f) `python -m vec_vad_torch flow-infer` on a with_bn=False
     FlowNet2 in a subprocess under torch's default TF32 flags, its .flo
     maps against the CPU's (1e-4 of the largest |flow|: F1's check), and
     the same run with the harness's full_f32 taken out, which must read
     past that bound.
     Prints each route's ms per step or tick on the mesh beside one card:
     the cost of the split, the copies and the reductions on one card,
     not a two-card speed (the machine has one card).

 15. detecting fleet: DetectingFleetScorer.push_tick on the card, the
     benchmark cell's shape: 8 cameras of 480x856 BGR frames (a seeded
     noise texture with 16 moving rectangles a camera), a seeded random
     R101 Cascade R-CNN calibrated as phase 11's (12 RoIs a frame of the
     first tick over a 0.5 person score) and the raw-only ensemble (5raw
     nf=32, patch 32, 64 box slots), 6 ticks. Launch counts reset just
     before the ticks: two nms_scan launches a tick (the RPN's scan and
     the multiclass step's), no K1; finite scores, the counters, and the
     last tick's kept boxes equal to detect_many's detections through
     filter_detections and del_cover_bboxes. The (R, K, K) masks and
     valid flags the last tick handed greedy_keep (RPN (40, 1000, 1000),
     multiclass (640, 1000, 1000)) through csrc/nms_scan.cu, equal to the
     CPU's fixed point, timed (CUDA events) beside the fixed point on the
     card and the bound of the bytes it reads (the kept candidates' mask
     rows). The {"kernels": [...]} record's nms_scan entry is the RPN's.

The second-to-last line of output is the card's nvidia-smi line, the one
before it the {"kernels": [...]} record, and the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from vec_vad_torch import cli, config, infer, kernels, pipeline, runner
from vec_vad_torch.cli import make_flow_net
from vec_vad_torch.config import CompletionConfig, ForegroundConfig, PipelineConfig
from vec_vad_torch.data import readers
from vec_vad_torch.data.synthetic import make_synthetic_dataset
from vec_vad_torch.data.video_index import VideoIndex
from vec_vad_torch.device import full_f32
from vec_vad_torch.eval import metrics
from vec_vad_torch.flow import driver
from vec_vad_torch.flow.harness import FlowHarness
from vec_vad_torch.flow.trainer import FlowTrainer
from vec_vad_torch.fore import mmdet_detector as mdet
from vec_vad_torch.fore import motion as fmotion
from vec_vad_torch.fore.detector import (
    compute_foreground_bboxes,
    filter_detections,
)
from vec_vad_torch.fore.mmdet_import import load_mmdet_state
from vec_vad_torch.fore.suppress import del_cover_bboxes
from vec_vad_torch.infer import infer_frame_scores_resident
from vec_vad_torch.models.completion import init_completion_state, make_completion_net
from vec_vad_torch.models.flownet import make_flownet2
from vec_vad_torch.models.flownet import ops as fops
from vec_vad_torch.ops.stc import pad_boxes
from vec_vad_torch.pipeline import TrainedBlock, VadModel
from vec_vad_torch.runtime.artifacts import load_vad_model
from vec_vad_torch.score import scoring as score_mod
from vec_vad_torch.serve import (
    DetectingFleetScorer,
    FlowStreamingScorer,
    MotionStreamingScorer,
    MultiCameraFlowScorer,
    MultiCameraScorer,
    StreamingScorer,
)
from vec_vad_torch.serve import streaming as serve_streaming
from vec_vad_torch.serve._common import _valid_rows
from vec_vad_torch.train import grid_trainer
from vec_vad_torch.train.trainer import BlockTrainer

SEED = 0
FRAME_HW = (240, 360)  # UCSDped2
FLOW_HW = (384, 512)  # the FlowNet2 protocol
VIDEO_LENGTHS = (16, 16, 2)  # the 2-frame video exercises the tail rule
# the served model (phases 3 and 9): 5raw1of, nf=32, patch 32, 64 boxes
SERVE_MODEL = dict(nf=32, patch=32, seed=SEED + 1)
SERVE_SHAPE = (1, 48, 64, 256)  # FlowNetC conv3 features at 384x512
TRAIN_SHAPE = (8, 48, 64, 256)  # the same at the training batch of 8
CALC_SHAPE = (4, 48, 64, 256)  # the same in a calc-flow f32 batch of 4
RAGGED_SHAPE = (2, 13, 30, 48)
TRAIN_BATCH, TRAIN_PAIRS, TRAIN_EPOCHS = 8, 16, 2
TRAIN_STEADY = 24  # timed steps after fit (FlowNetC at batch 8)
FLOWNET2_STEPS = 20  # timed FlowNet2 fine-tuning steps at batch 1
WORKDIR = Path(__file__).resolve().parent / "build" / "chip_smoke_flow_train"
# calc-flow: a UCSD-layout tree of 148 frames; the 2-frame video exercises
# the first- and last-frame pair rule
CALC_BASE = Path(__file__).resolve().parent / "build" / "chip_smoke_calc_flow"
CALC_DATASET = "UCSDped2_npy"
CALC_LENGTHS = {"Train": (40, 36), "Test": (38, 32, 2)}
CALC_SEGMENT = 24  # frames a segment: Train001's 40 frames span two
# train-test: a UCSD-layout tree with UCSDped2's frame counts at 240x360
TT_BASE = Path(__file__).resolve().parent / "build" / "chip_smoke_train_test"
TT_LENGTHS = {"Train": (160,) * 15 + (150,), "Test": (168,) * 11 + (162,)}
# the flagship raw-only model: 5raw, nf=32, patch 32, batch 128, cut from
# its 10 epochs to 3 for the script's time
TT_CFG = PipelineConfig(
    dataset_name="UCSDped2_npy", fore=ForegroundConfig(patch_size=32),
    model=CompletionConfig(nf=32, context_frame_num=4, context_of_num=0, epochs=3,
                           use_flow=False, border_mode="predict"),
)
TT_STEADY = 30  # timed training steps at batch 128 after run_train
TT_SUBSET = 512  # cubes scored on the card and on the CPU
# two-stream: a tree at avenue's geometry, 6 + 6 videos of 160 frames
# (avenue: 16 + 21 videos, 15,328 + 15,324 frames; cut for the script's
# time and disk: 1,920 flow maps of 1.84 MB), the 5raw1of model at the
# flagship width
TS_BASE = Path(__file__).resolve().parent / "build" / "chip_smoke_two_stream"
TS_HW = (360, 640)
TS_LENGTHS = {"Train": (160,) * 6, "Test": (160,) * 6}
TS_CFG = PipelineConfig(
    dataset_name="avenue", fore=ForegroundConfig(patch_size=32),
    model=CompletionConfig(nf=32, context_frame_num=4, context_of_num=0,
                           use_flow=True, border_mode="predict"),
)
# dataset scale (phase 8): phase 7's workspace and flow tree; the bf16
# model under a base of its own (symlinks to phase 7's trees), since the
# model's path is the same for either dtype
DS_BASE = Path(__file__).resolve().parent / "build" / "chip_smoke_dataset_scale"
DS_SEGMENT = 64  # frames a segment: boundaries fall inside the 160-frame videos
# infer_frame_scores' budget for its routed run: phase 7's test split is
# 2.43 GB of frames and flow (2.53 MB a frame), so 5e8 B routes it to
# segments of 5e8 / (2 x 2.53 MB) = 98 frames, rounded down to 96
DS_BUDGET, DS_ROUTED_SEGMENT = 5e8, 96
# the pixel criterion's routes are also timed on the test split tiled this
# many times: 3,840 frames, past the JAX package's thresholds for its
# device routes (8,192 cubes; 2^29 pixels, here 8.8e8)
DS_PIXEL_TILE = 4
# bf16 against f32 training: the JAX package's own bf16 bounds
# (tests/test_bf16_training.py:39-41)
BF16_CORR, BF16_MEAN_RATIO = 0.98, 0.15
# bf16 scoring's AUROC against f32's
BF16_AUROC_TOL = 0.02
# resident vs offline frame scores (PARITY.md:26): the same cubes and
# weights, the ensemble run at batches of 2048 against 128
RESIDENT_TOL = 2e-4
# published H100 SXM peaks (NVIDIA data sheet, dense)
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES_S = 3.35e12
# serving surface (phase 9): push_many's frames a call, and a fleet of
# FLEET_C cameras, each on its own video of FLEET_LENGTH frames
SERVE_K, FLEET_C, FLEET_LENGTH = 8, 8, 24
# frames `serve --live-flow` and `serve --cameras FLEET_C --live-flow`
# stream from phase 7's first test video
CLI_LIVE_FRAMES, CLI_FLEET_FRAMES = 160, 32
# push_many, the fleet and the live fleet against k pushes / one scorer a
# camera, relative to the largest score: the same work in batches, so
# cuDNN sums in other orders (the JAX package's serving bound)
SERVE_REL_TOL = 2e-4
# a camera's flow in the live fleet's batch against its pair alone,
# relative to the largest |flow| (calc-flow's batch-against-single bound)
LIVE_FLOW_TOL = 1e-3
# `serve`'s streamed AUROC against phase 7's `test` AUROC
STREAM_AUROC_TOL = 1e-3
# live flow against phase 7's offline frame scores (calc-flow's tree at
# batches of 4 against the live batch of 1), relative to the largest
# score: the run_train -> run_test bound
LIVE_OFFLINE_TOL = 5e-4
# foreground and motion serving (phase 10): ShanghaiTech's 480x856 in its
# layout, 2 + 2 videos of 80 frames (ShanghaiTech: 330 + 107 videos,
# 274,515 + 40,791 frames; cut for time and disk: 0.39 GB of frames, 1.05
# GB of flow maps), the 5raw1of model at the flagship width
FG_BASE = Path(__file__).resolve().parent / "build" / "chip_smoke_foreground"
FG_HW = (480, 856)
FG_LENGTHS = {"Train": (80, 80), "Test": (80, 80)}
FG_CFG = PipelineConfig(
    dataset_name="ShanghaiTech", fore=ForegroundConfig(patch_size=32),
    model=CompletionConfig(nf=32, context_frame_num=4, context_of_num=0,
                           use_flow=True, border_mode="predict"),
)
FG_WINDOWS = 64  # windows of a motion-map pass: the offline stage's chunk
FG_SMALL_HW = (240, 360)  # UCSDped2's geometry (k = 3, threshold 18)
FG_CPU_FRAMES = 32  # test frames whose boxes the CPU computes too
FG_AP_VIDEO = 24  # frames of test video 1 served with appearance boxes
# the appearance detector (phase 11) on phase 10's tree: a seeded random
# R101 Cascade R-CNN under mmdet v1's checkpoint names, at full width (256
# pyramid channels, 1,000 proposals, three fc-1024 stages, 81 classes)
DT_DEPTH = 101
# the Cascade R-CNN's parameters and frozen BN statistics (mmdet v1 names)
DT_PARAMS = {50: 69_447_886, 101: 88_492_238}
DT_CKPT = Path(__file__).resolve().parent / "build" / "chip_smoke_cascade_rcnn_r101.pth"
DT_PERSON = 1  # COCO's person (label 0): the class whose score is calibrated
DT_OTHER_SCALE = 1e-2  # the regression weights and the other classes' fc_cls rows
DT_CAL_FRAMES = 4  # test frames the person bias is calibrated on
DT_TARGET = 12  # RoIs a frame whose person score clears 0.5 before the NMS
DT_CPU_FRAMES = 2  # frames detected on the card and on the CPU
DT_BATCH = 4  # compute_foreground_bboxes' detector_batch
DT_TIMED = 5  # timed batches
# card vs CPU, both full f32: relative to the largest magnitude of a
# stage's tensor, each stage fed the card's inputs (cuDNN and oneDNN sum
# R101's ~100 convolutions in other orders: 4e-6 on the pyramid on an
# H100; fed its own stage-1 deltas, the CPU's stage 3 drifted 2e-4).
# The two independent runs' proposals are matched as sets within DT_REL
# of the canvas (a near-tie may order them apart): 99 % on an H100. Their
# confident detections are matched likewise and reported, not held: the
# random weights' three stages carry the proposals' 1e-4 differences
# into the final boxes (75-83 % within 0.13 px on an H100)
DT_REL = 1e-4
DT_MATCHED = 0.95
# the detecting fleet (phase 15): DetectingFleetScorer at the benchmark
# cell's shape (8 ShanghaiTech cameras at 480x856, 64 box slots) with the
# raw-only ensemble at the flagship width; the first tick warms
DF_CAMERAS = 8
DF_TICKS = 6
DF_OBJECTS = 16  # moving rectangles a camera
DF_TIMED = 10  # timed scans of each captured mask (the fixed point: 2)
HBM_BYTES_S = 3.35e12  # H100 SXM's memory rate
# the model grid (phase 12): a 2x2 grid over a seeded synthetic tree at
# UCSDped2's 240x360 (6 + 4 videos of 100 frames), in avenue's layout so
# that run_test reads its pixel GT through scipy (the card's machine has
# no cv2 for the ped layout's .bmp masks), and the flagship raw-only model
# cut to 5 epochs (its width kept: 5raw nf=32, patch 32, batch 128)
GR_BASE = Path(__file__).resolve().parent / "build" / "chip_smoke_grid"
GR_HW = (240, 360)
GR_LENGTHS = {"Train": (100,) * 6, "Test": (100,) * 4}
GR_CFG = PipelineConfig(
    dataset_name="avenue", fore=ForegroundConfig(patch_size=32, h_block=2, w_block=2),
    model=CompletionConfig(nf=32, context_frame_num=4, context_of_num=0, epochs=5,
                           use_flow=False, border_mode="predict"),
)
GR_STEADY = 20  # timed grid steps (4 equal blocks, every block in every step)
# grid against sequential training scores, |diff| <= GR_ATOL + GR_REL x
# the block's largest score (block_close). The JAX package holds its grid
# to rtol 2e-3 / atol 1e-4 a score (tests/test_grid_parallel.py:70-101),
# but its grid runs each block's own program; the folded one sums in other
# orders (cuDNN's algorithms for 20 groups, not 5), 6e-8 apart in the
# first losses, and training grows that: a convolution bias before a
# BatchNorm has a gradient of 0 up to rounding, which Adam turns into
# steps of up to lr either way, and the running means that eval-mode
# scores read lag those biases. On an H100 the folded 5-epoch fit came
# 1.98e-3 (raw) and 1.36e-3 (5raw1of) of the largest score from the
# sequential one, past a per-score rtol of 2e-3 on the flow scores (which
# span 12-7,400); the bound is 2.5 times the larger
GR_REL, GR_ATOL = 5e-3, 1e-4
# grid against sequential scoring of the same model, relative to the
# largest score, and the two models' AUROCs (tests/test_grid_parallel.py)
GR_SCORE_REL, GR_AUROC_TOL = 2e-4, 5e-3
# two runs of the same f32 scoring on the card, relative to the largest
# score: they may differ in a score's last bit (1.2e-4 at scores near
# 1,900, 6.5e-8 of the largest, on an H100: cuDNN's default algorithms
# may sum in another order from one call to the next, and with
# cudnn.deterministic the runs are equal), while TF32 moved them 5.0e-5
# there; the bound is 15 times that last bit
RERUN_REL_TOL = 1e-6
# K1 vs its plain version, f32: one f32 dot of C products summed in
# another order, then scaled by 1/C -> a few ulp of the output
K1_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6),
          # bf16 out: both round one f32 sum, at most one bf16 ulp apart
          torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-6)}
# K2 vs its plain version: per output the same f32 sum of n*n products in
# the same order, fused multiply-adds against separate ones -> a few ulp;
# bf16 grads round one f32 sum -> one bf16 ulp
K2_TOL = K1_TOL
# card vs CPU training loss (both full f32): FlowNetC's ~30 convolutions
# summed in other orders by cuDNN and oneDNN
LOSS_REL_TOL = 1e-4
# card vs CPU scores (both full f32): cuDNN and oneDNN sum FlowNet2's ~40
# convolutions and the UNets in different orders, and a cube's uint8
# rounding may flip by one level, so scores agree to ~1e-4 relative; the
# bound is ten times that, relative to the largest score
CPU_REL_TOL = 1e-3
# calc-flow's segmented tree against its whole-split tree, relative to the
# largest |flow|: the same uint8 frames in the same batches of 4, yet
# 3.970e-06 apart on an H100 (not explained yet: the device work is the
# same); the bound is 25 times that
SEG_REL_TOL = 1e-4
# calc-flow in bf16 against f32, relative to the largest |flow| of the f32
# tree: bf16 weights and activations through FlowNet2's five nets, ~3
# significant digits a layer; 1.684e-02 observed on an H100, bound 3x that
BF16_REL_TOL = 0.05


# tooling (phase 13): avenue's geometry and layout, 2 + 2 videos of 40
# frames cycled from the committed fixture jpgs (tests/data/frames, their
# cv2 decode in decoded.npz) as .npy frames, since the card's machine has
# no libjpeg/libpng/libtiff for the native decoder; the two-stream model
# at the flagship width for 1 epoch. The frames cycled from avenue_1.jpg
# (the generator's anomalous random-texture square) are the test GT's
TL_BASE = Path(__file__).resolve().parent / "build" / "chip_smoke_tooling"
TL_FIXTURES = Path(__file__).resolve().parent / "tests" / "data" / "frames"
TL_JPGS = ("avenue_0.jpg", "avenue_1.jpg", "avenue_2.jpg")
TL_ANOMALOUS = 1  # index in TL_JPGS
TL_LENGTHS = {"Train": (40, 40), "Test": (40, 40)}
TL_CFG = PipelineConfig(
    dataset_name="avenue", fore=ForegroundConfig(patch_size=32),
    model=CompletionConfig(nf=32, context_frame_num=4, context_of_num=0, epochs=1,
                           use_flow=True, border_mode="predict"),
)
TL_LIMIT = 40  # score masks and flow maps `visualize` renders
# the completion program probes: the JAX package's batches, 3 calls a
# window (a fwdbwd pass at 1024 cubes takes a few hundred ms)
PROFILE_BATCHES, PROFILE_ITERS = (128, 1024), 3
# card vs CPU running statistics after one train-mode forward of a with_bn
# FlowNetC, relative to each tensor's largest value: the means and
# variances of f32 activations summed in other orders
BN_STATS_TOL = 1e-5
# card vs CPU gradient stored by a GradTaps tap, relative to its largest
# |value|: FlowNetC's forward convolutions in other orders, then one
# linear map back. A tap deeper in the backward (conv3_1 under a loss on
# flow2) came 2.3e-3 apart on an H100: wherever the two devices round a
# pre-activation to the other side of 0, LeakyReLU's slope differs 10x
TAP_REL_TOL = 1e-4
# the device mesh (phase 14): the one-card machine's only mesh names the
# card twice; every route on it is held to the same call on one card
MESH = ["cuda:0", "cuda:0"]
MS_BLOCK_CFG = CompletionConfig(nf=32, context_frame_num=4, context_of_num=0, epochs=1,
                                use_flow=False, border_mode="predict")
MS_STEPS = 5  # BlockTrainer steps at batch 128 (one epoch of 640 cubes)
MS_FLOW_BATCH, MS_FLOW_STEPS = 7, 3  # FlowNetC: 7 pairs padded to 8
MS_CALC_MAPS = 40
MS_FLEET_C, MS_FLEET_TICKS = 8, 6
MS_GRID_CUBES = 256  # cubes a block of the 2x2 grid: 2 steps an epoch
MS_INFER_BASE = Path(__file__).resolve().parent / "build" / "chip_smoke_flow_infer"
MS_INFER_PAIRS = 3  # FlyingChairs pairs flow-infer runs, at batch 2
# mesh against one card, set from H100 readings of phase 14 (a) f32:
# steps 1-2's losses (the same weights, then one Adam update apart) came
# 5.7e-7 to 2.8e-6 apart, so 1e-5. Later steps drift as one card drifts
# from itself: Adam moves every parameter by about lr on its gradient's
# sign, so a rounding difference in a near-zero gradient grows. Step 5:
# the mesh 1.5e-5 to 8.0e-5 apart in six runs, the one-card fit run
# again 1.2e-5 to 5.7e-5 and with each batch's rows reversed 2.9e-5 to
# 5.3e-5 in three, so 2e-4. The first step's gradients: mesh 1.8e-5 to
# 2.5e-5 of the largest, one card against itself 9.3e-6 to 1.6e-5, so
# 1e-4. Scores are the serving bound SERVE_REL_TOL. Flow maps: the mesh
# 4.9e-6 to 5.8e-6 of the largest |flow| (calc-flow) and flow-infer under
# torch's default flags 3.1e-6 to 3.7e-6 of the CPU's, while flow-infer
# with F1 unrepaired (TF32) read 1.5e-3 to 1.6e-3, so 1e-4
MESH_LOSS_REL, MESH_LATER_LOSS_REL = 1e-5, 2e-4
MESH_GRAD_REL = 1e-4
MESH_FLOW_REL = 1e-4


def check(ok: bool, what) -> None:
    """Fail the run (also under python -O, which drops asserts)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def phase_done(name: str, t0: float) -> float:
    """Print a phase's wall time; returns the clock for the next one."""
    now = time.perf_counter()
    print(f"phase {name}: {now - t0:.1f} s wall", flush=True)
    return now


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warm: int = 3) -> float:
    """Mean ms of fn() over `reps` back-to-back runs, by CUDA events."""
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def correlation_bound_ms(shape, dtype, max_disp=20, stride=2, backward=False):
    """Least time for the cost volume (or, with backward, both of its
    gradients) on this card: the larger of the bytes it must move (each
    input read once, each output written once: a, b -> out; a, b, g ->
    grad_a, grad_b) over the memory rate, and the multiply-adds its
    in-frame displacements need (out-of-frame ones are zero by
    definition; the backward does them once per gradient) over the peak
    rate for the inputs' type. Returns (ms, 'bytes' | 'operations')."""
    B, H, W, C = shape
    d = np.arange(-max_disp, max_disp + 1, stride)
    rows = np.clip(H - np.abs(d), 0, None).sum()  # in-frame (y, dy) pairs
    cols = np.clip(W - np.abs(d), 0, None).sum()
    flops = 2.0 * B * rows * cols * C * (2 if backward else 1)
    elem = torch.finfo(dtype).bits // 8
    nbytes = elem * B * H * W * ((4 if backward else 2) * C + len(d) ** 2)
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _cuda_normal(rng, shape, dtype):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to("cuda", dtype)


def check_fwd(a, b) -> float:
    """K1 against correlation_ref on the same inputs; max |error|."""
    got, want = fops.correlation(a, b), fops.correlation_ref(a, b)
    torch.cuda.synchronize()
    check(got.dtype == a.dtype and got.shape == want.shape,
          f"K1 out {got.dtype} {got.shape}")
    torch.testing.assert_close(got.float(), want.float(), **K1_TOL[a.dtype])
    return float((got.float() - want.float()).abs().max())


def kernel_phase(rng) -> dict:
    """K1 against correlation_ref on the card at the serving, training and
    calc-flow shapes; returns the serving-shape f32 record, its
    max_abs_err the largest f32 error at any of them."""
    cases = [(SERVE_SHAPE, torch.float32), (SERVE_SHAPE, torch.bfloat16),
             (TRAIN_SHAPE, torch.float32), (TRAIN_SHAPE, torch.bfloat16),
             (CALC_SHAPE, torch.float32), (CALC_SHAPE, torch.bfloat16),
             (RAGGED_SHAPE, torch.float32), (RAGGED_SHAPE, torch.bfloat16)]
    record, f32_err = None, 0.0
    for shape, dtype in cases:
        a, b = (_cuda_normal(rng, shape, dtype) for _ in range(2))
        err = check_fwd(a, b)
        if dtype == torch.float32 and shape != RAGGED_SHAPE:
            f32_err = max(f32_err, err)
        big = shape in (TRAIN_SHAPE, CALC_SHAPE)
        ms = cuda_ms(lambda: fops.correlation(a, b), reps=100 if big else 200)
        plain_ms = cuda_ms(lambda: fops.correlation_ref(a, b), reps=3 if big else 10)
        bound_ms, bound_by = correlation_bound_ms(shape, dtype)
        ratio = f"{ms / bound_ms:.2f}x the bound"
        if dtype != torch.float32:
            # the bf16 bound prices the tensor cores; a CUDA-core kernel is
            # read against the f32 operations bound
            f32_bound = correlation_bound_ms(shape, torch.float32)[0]
            ratio += f"; f32-operations bound {f32_bound:.6f} ms, {ms / f32_bound:.2f}x"
        print(f"kernel correlation {tuple(shape)} {str(dtype)[6:]}: "
              f"max_abs_err={err:.3e} ms={ms:.6f} plain_ms={plain_ms:.6f} "
              f"bound_ms={bound_ms:.6f} ({bound_by}), {ratio}", flush=True)
        if record is None:
            record = dict(ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
    record["max_abs_err"] = f32_err
    return record


def check_bwd(a, b, g, dtype) -> float:
    """K2 against correlation_bwd_ref on the same inputs; max |error|."""
    got = fops.correlation_bwd(a, b, g)
    want = fops.correlation_bwd_ref(a, b, g)
    torch.cuda.synchronize()
    err = 0.0
    for x, y in zip(got, want):
        check(x.dtype == dtype and x.shape == a.shape, f"K2 grad {x.dtype} {x.shape}")
        torch.testing.assert_close(x.float(), y.float(), **K2_TOL[dtype])
        err = max(err, float((x.float() - y.float()).abs().max()))
    return err


def kernel_bwd_phase(rng) -> dict:
    """K2 against correlation_bwd_ref on the card at the training shape,
    FlowNet2 fine-tuning's batch-1 shape and a ragged shape; returns the
    training-shape f32 record."""
    cases = [(TRAIN_SHAPE, torch.float32), (TRAIN_SHAPE, torch.bfloat16),
             (SERVE_SHAPE, torch.float32), (SERVE_SHAPE, torch.bfloat16),
             (RAGGED_SHAPE, torch.float32), (RAGGED_SHAPE, torch.bfloat16)]
    record = None
    for shape, dtype in cases:
        a, b = (_cuda_normal(rng, shape, dtype) for _ in range(2))
        g = _cuda_normal(rng, shape[:3] + (441,), dtype)
        err = check_bwd(a, b, g, dtype)
        ms = cuda_ms(lambda: fops.correlation_bwd(a, b, g), reps=50)
        plain_ms = cuda_ms(lambda: fops.correlation_bwd_ref(a, b, g), reps=3)
        bound_ms, bound_by = correlation_bound_ms(shape, dtype, backward=True)
        print(f"kernel correlation_bwd {tuple(shape)} {str(dtype)[6:]}: "
              f"max_abs_err={err:.3e} ms={ms:.6f} plain_ms={plain_ms:.6f} "
              f"bound_ms={bound_ms:.6f} ({bound_by}), {ms / bound_ms:.2f}x the bound",
              flush=True)
        if record is None:
            record = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
    return record


def make_model(nf: int, patch: int, seed: int, dataset_name: str = "UCSDped2",
               use_flow: bool = True) -> VadModel:
    """A two-stream 5raw1of VadModel (one block; raw-only 5raw without
    use_flow) with random weights and seeded training-score vectors, all
    from numpy seeds."""
    cfg = PipelineConfig(
        dataset_name=dataset_name,
        fore=ForegroundConfig(patch_size=patch, max_boxes_per_frame=64),
        model=CompletionConfig(nf=nf, context_frame_num=4, context_of_num=0,
                               use_flow=use_flow),
    )
    sd = init_completion_state(make_completion_net(cfg.model, device="cpu"), seed)
    rng = np.random.default_rng(seed)
    block = TrainedBlock(sd, rng.normal(100.0, 10.0, 256).astype(np.float32),
                         rng.normal(10.0, 1.0, 256).astype(np.float32))
    return VadModel(cfg=cfg, blocks={(0, 0, 0): block})


def make_stream(frame_hw, lengths, seed):
    """Seeded synthetic videos, each frame's boxes topped up with random
    ones to 1-8 boxes."""
    ds = make_synthetic_dataset(frames_per_video=max(lengths), n_train_videos=1,
                                n_test_videos=len(lengths), frame_h=frame_hw[0],
                                frame_w=frame_hw[1], seed=seed)
    rng = np.random.default_rng(seed + 1)
    H, W = frame_hw
    videos, off = [], 0
    for ln in lengths:
        frames, boxes = [], []
        for t in range(ln):
            bx = ds.test_boxes[off + t][: rng.integers(1, 4)]
            extra = rng.integers(0, 9 - len(bx))
            x0 = rng.uniform(0, W - 8, extra)
            y0 = rng.uniform(0, H - 8, extra)
            wh = rng.uniform(8, 64, (extra, 2))
            more = np.stack([x0, y0, np.minimum(x0 + wh[:, 0], W),
                             np.minimum(y0 + wh[:, 1], H)], 1)
            frames.append(ds.test_frames[off + t])
            boxes.append(np.concatenate([bx, more]).astype(np.float32))
        videos.append((frames, boxes))
        off += max(lengths)
    return videos


def serve(scorer, videos, sync=lambda: None):
    """Stream every video; returns (per-video score lists, live-push
    latencies in ms per video, live pushes)."""
    scores, lat, live = [], [], 0
    for frames, boxes in videos:
        scorer.start_video()
        vs, vl = [], []
        for i, (f, b) in enumerate(zip(frames, boxes)):
            t0 = time.perf_counter()
            s = scorer.push(f, b)
            sync()
            if i != 1:  # push 1 only writes the ring (no flow, no score)
                vl.append((time.perf_counter() - t0) * 1e3)
                live += 1
            if s is not None:
                vs.append(s)
        s = scorer.end_video()
        if s is not None:
            vs.append(s)
            live += 1
        scores.append(vs)
        lat.append(vl)
    return scores, lat, live


def kernel_shares(ev, busy_us: float) -> str:
    """K1's and K2's device time in a profile's key averages, and their
    share of the device's busy time."""
    from torch.autograd import DeviceType

    parts = []
    for name, key in (("K1", "corr_fwd_"), ("K2", "corr_bwd_kernel")):
        rows = [e for e in ev if e.device_type == DeviceType.CUDA and key in e.key]
        us = sum(e.self_device_time_total for e in rows)
        parts.append(f"{name} {us / 1e3:.3f} ms in {sum(e.count for e in rows)} "
                     f"launches ({100 * us / busy_us:.2f} %)")
    return ", ".join(parts)


def profile_pushes(scorer, frames, boxes, warm: int = 3) -> None:
    """torch.profiler over the live pushes of one video after `warm`
    pushes: device time by operator and the device's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    scorer.start_video()
    for f, b in zip(frames[:warm], boxes[:warm]):
        scorer.push(f, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f, b in zip(frames[warm:], boxes[warm:]):
            scorer.push(f, b)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    scorer.end_video()
    ev = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in ev
                  if e.device_type == DeviceType.CUDA)
    print(ev.table(sort_by="self_device_time_total", row_limit=25))
    print(f"profile: {len(frames) - warm} live pushes, wall {wall_us / 1e3:.3f} ms, "
          f"device busy {busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f} %); "
          f"{kernel_shares(ev, busy_us)}")


class SyntheticPairs:
    """FlyingChairs-geometry training pairs held in memory, with the
    `batches()` contract of flow/datasets.PairFlowDataset: smooth seeded
    textures, the second frame the first shifted by a whole-pixel flow
    (u, v) in [-8, 8] per pair, so the ground truth is known exactly."""

    def __init__(self, n: int, hw, seed: int):
        rng = np.random.default_rng(seed)
        h, w = hw
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        self.pairs = np.empty((n, h, w, 6), np.float32)
        self.flows = np.empty((n, h, w, 2), np.float32)
        for i in range(n):
            f = rng.uniform(3.0, 12.0, (3, 2))
            phase = rng.uniform(0, 2 * np.pi, (3, 2))
            img = np.stack([127 + 60 * np.sin(xx / f[c, 0] + phase[c, 0])
                            + 60 * np.cos(yy / f[c, 1] + phase[c, 1])
                            for c in range(3)], -1).round()
            u, v = (int(x) for x in rng.integers(-8, 9, 2))
            self.pairs[i, ..., :3] = img
            self.pairs[i, ..., 3:] = np.roll(img, (v, u), axis=(0, 1))
            self.flows[i] = (u, v)

    def __len__(self) -> int:
        return len(self.pairs)

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0):
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for lo in range(0, len(self), batch_size):
            sel = order[lo: lo + batch_size]
            yield self.pairs[sel], self.flows[sel]


def profile_steps(trainer, batches) -> None:
    """torch.profiler over training steps: device time by operator and the
    device's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for pairs, target in batches:
            trainer.step(pairs, target)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ev = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in ev
                  if e.device_type == DeviceType.CUDA)
    print(ev.table(sort_by="self_device_time_total", row_limit=25))
    print(f"train profile: {len(batches)} steps, wall {wall_us / 1e3:.3f} ms, "
          f"device busy {busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f} %); "
          f"{kernel_shares(ev, busy_us)}")


def step_stats(ms) -> str:
    """Median and spread of a window of step times (ms)."""
    p10, p50, p90 = np.percentile(ms, (10, 50, 90))
    return (f"median {p50:.3f} p10 {p10:.3f} p90 {p90:.3f} min {min(ms):.3f} "
            f"max {max(ms):.3f} over {len(ms)} steps")


def capture_cost_volume(net):
    """Hooks on FlowNetC's conv3 and conv3_1 that keep one training step's
    cost-volume inputs and cotangent: a and b are conv3's two outputs, g
    the gradient at conv3_1's input, sliced to the 441 cost-volume
    channels and taken back through the LeakyReLU(0.1) that follows the
    correlation (up to the sign of an entry within an ulp of 0, which
    leaves g a fair input for K2). Returns `finish`, which removes the
    hooks after that step and returns (a, b, g)."""
    captured = {"ab": []}

    def on_conv3(mod, inp, out):
        if len(captured["ab"]) < 2:
            captured["ab"].append(out.detach().contiguous())

    def keep_g(grad):  # returns None: the gradient flows on unchanged
        captured.setdefault("g", grad[..., -441:].contiguous())

    def on_conv3_1(mod, inp):
        if "g" not in captured:
            inp[0].register_hook(keep_g)

    hooks = [net.conv3.register_forward_hook(on_conv3),
             net.conv3_1.register_forward_pre_hook(on_conv3_1)]

    def finish():
        for h in hooks:
            h.remove()
        a, b = captured["ab"]
        raw = fops.correlation_ref(a, b)
        g = captured["g"] * torch.where(raw > 0, 1.0, 0.1)
        return a, b, g

    return finish


def train_phase() -> dict:
    """FlowHarness.fit of FlowNetC on the card, then steady steps; returns
    fit's launch counts and K1's and K2's errors on a real step's inputs."""
    data = SyntheticPairs(TRAIN_PAIRS, FLOW_HW, SEED + 3)
    trainer = FlowTrainer(make_flow_net("FlowNetC", SEED, "cuda"), device="cuda")
    harness = FlowHarness(trainer, str(WORKDIR))
    shutil.rmtree(WORKDIR, ignore_errors=True)

    # the first step's loss, on the card and on the CPU: same seeded
    # weights, the batch fit takes first (epoch 1 shuffles with seed + 1)
    first = next(data.batches(TRAIN_BATCH, shuffle=True, seed=SEED + 1))
    cpu = FlowTrainer(make_flow_net("FlowNetC", SEED, "cpu"), device="cpu")
    with torch.no_grad():
        card_loss = float(trainer.loss(*(trainer.to_device(x) for x in first))[0])
        cpu_loss = float(cpu.loss(*(cpu.to_device(x) for x in first))[0])
    del cpu
    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    print(f"train: first step's loss card={card_loss:.8f} cpu={cpu_loss:.8f} "
          f"rel diff={rel:.3e} (bound {LOSS_REL_TOL})")
    check(rel <= LOSS_REL_TOL, f"card vs CPU first loss {card_loss} / {cpu_loss}")

    # the main path: fit, counts read just before and just after
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    result = harness.fit(data, data, total_epochs=TRAIN_EPOCHS,
                         batch_size=TRAIN_BATCH, seed=SEED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated()

    n_steps = TRAIN_EPOCHS * -(-TRAIN_PAIRS // TRAIN_BATCH)
    n_val = n_steps  # validation runs the same batches, forward only
    hist = [(h["train_loss"], h["val_epe"]) for h in result.history]
    print(f"train: FlowNetC 2x{FLOW_HW} batch {TRAIN_BATCH}, {n_steps} steps "
          f"in {TRAIN_EPOCHS} epochs, {wall:.2f} s wall (validation and "
          f"checkpoints included); (mean loss, val EPE) per epoch {hist}; "
          f"launches {launches}; peak device memory {peak / 2**20:.1f} MiB",
          flush=True)
    check(len(hist) == TRAIN_EPOCHS and np.isfinite(hist).all(), f"fit {hist}")
    check(launches == {"correlation": n_steps + n_val, "correlation_bwd": n_steps},
          f"fit launches {launches} for {n_steps} steps, {n_val} val batches")

    # steady steps: one launch of each kernel a step; the first step's
    # cost-volume inputs and cotangent are kept for K1 and K2
    batches = list(data.batches(TRAIN_BATCH, shuffle=True, seed=SEED + 9))
    finish = capture_cost_volume(trainer.net)
    step_ms, losses = [], []
    for i, (pairs, target) in enumerate(batches * (TRAIN_STEADY // len(batches))):
        before = kernels.launch_counts.copy()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(trainer.step(pairs, target)["loss"]))  # synchronises
        step_ms.append((time.perf_counter() - t0) * 1e3)
        step = dict(kernels.launch_counts - before)
        check(step == {"correlation": 1, "correlation_bwd": 1},
              f"step {i} launches {step}")
        if i == 0:
            a, b, g = finish()
    check(np.isfinite(losses).all(), f"steady losses {losses}")
    med = float(np.median(step_ms))
    print(f"train: ms per step (synchronised) {step_stats(step_ms)}; "
          f"{TRAIN_BATCH * 1e3 / med:.2f} pairs/s at the median", flush=True)

    check(tuple(a.shape) == TRAIN_SHAPE and tuple(g.shape) == TRAIN_SHAPE[:3] + (441,),
          f"captured cost-volume inputs {tuple(a.shape)} {tuple(g.shape)}")
    fwd_err = check_fwd(a, b)
    bwd_err = check_bwd(a, b, g, torch.float32)
    print(f"train: on a training step's (a, b, g) K1 max_abs_err={fwd_err:.3e} "
          f"K2 max_abs_err={bwd_err:.3e}")

    profile_steps(trainer, batches)
    shutil.rmtree(WORKDIR, ignore_errors=True)
    return dict(launches=launches, fwd_err=fwd_err, bwd_err=bwd_err)


def flownet2_phase() -> dict:
    """Single-scale L1 fine-tuning steps of PairMajorAdapter(FlowNet2) at
    batch 1 (the composite recipe `flow-train --net FlowNet2 --loss L1`):
    one K1 and one K2 launch a step; returns the launch counts."""
    data = SyntheticPairs(2, FLOW_HW, SEED + 4)
    trainer = FlowTrainer(make_flow_net("FlowNet2", SEED, "cuda"), loss="single",
                          norm="L1", device="cuda")
    (pairs, target), = data.batches(2, shuffle=False)
    kernels.reset_launch_counts()
    ms, losses = [], []
    for i in range(FLOWNET2_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(trainer.step(pairs[i % 2:][:1], target[i % 2:][:1])["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(kernels.launch_counts)
    print(f"train FlowNet2 (single-scale L1, batch 1, 2x{FLOW_HW}): first losses "
          f"{[round(x, 6) for x in losses[:4]]}; launches {launches}; ms per step "
          f"(synchronised, steps 2-{FLOWNET2_STEPS}) {step_stats(ms[1:])} "
          f"(first {ms[0]:.1f})")
    check(np.isfinite(losses).all(), f"FlowNet2 losses {losses}")
    check(launches == {"correlation": FLOWNET2_STEPS, "correlation_bwd": FLOWNET2_STEPS},
          f"FlowNet2 step launches {launches}")
    return launches


def write_calc_tree(root: Path, seed: int) -> None:
    """CALC_LENGTHS' videos as seeded uint8 .npy frames at FRAME_HW in the
    UCSD layout (Train/TrainNNN, Test/TestNNN): smooth textures drifting
    by a whole-pixel step per frame, so the flow has something to find."""
    rng = np.random.default_rng(seed)
    H, W = FRAME_HW
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    for split, lengths in CALC_LENGTHS.items():
        for v, n in enumerate(lengths):
            d = root / split / f"{split}{v + 1:03d}"
            d.mkdir(parents=True)
            f = rng.uniform(4.0, 16.0, (3, 2))
            phase = rng.uniform(0, 2 * np.pi, (3, 2))
            u, w = (int(x) for x in rng.integers(-3, 4, 2))
            for t in range(n):
                img = np.stack([127 + 60 * np.sin((xx - u * t) / f[c, 0] + phase[c, 0])
                                + 60 * np.cos((yy - w * t) / f[c, 1] + phase[c, 1])
                                for c in range(3)], -1)
                np.save(d / f"{t:03d}.npy", img.round().astype(np.uint8))


def flow_batches(n_by_split, chunk: int, segment=None) -> int:
    """FlowNet2 batches (so K1 launches) of a calc-flow run: each split's
    frames in batches of `chunk`, or with `segment`, each segment (rounded
    up to a multiple of chunk) in its own batches."""
    total = 0
    for n in n_by_split:
        seg = -(-segment // chunk) * chunk if segment else n
        total += sum(-(-min(seg, n - lo) // chunk) for lo in range(0, n, seg))
    return total


def timed_calc_flow(cfg, base=CALC_BASE, **kw):
    """runner.run_calc_flow on the card over `base`, synchronised, with the
    host's frame decode (readers.read_frame) and .npy writes (the writers
    of driver.flow_tree_writer) timed; launch counts set to 0 just before
    and read just after. Returns (wall s, decode s, write s, launches)."""
    spent = {"decode": 0.0, "write": 0.0}
    read, make_writer = readers.read_frame, driver.flow_tree_writer

    def timed_read(path):
        t0 = time.perf_counter()
        out = read(path)
        spent["decode"] += time.perf_counter() - t0
        return out

    def timed_writer(*args):
        write = make_writer(*args)

        def timed_write(i, flow_i):
            t0 = time.perf_counter()
            write(i, flow_i)
            spent["write"] += time.perf_counter() - t0

        return timed_write

    readers.read_frame, driver.flow_tree_writer = timed_read, timed_writer
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        runner.run_calc_flow(cfg, str(base), device="cuda", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.launch_counts)
    finally:
        readers.read_frame, driver.flow_tree_writer = read, make_writer
    return wall, spent["decode"], spent["write"], launches


def read_flow_tree(cfg, paths) -> np.ndarray:
    """The mirrored .npy of every frame path, each checked to be a finite
    (H, W, 2) float32 map."""
    raw = CALC_BASE / cfg.raw_dataset_dir / cfg.dataset_name
    of_root = CALC_BASE / cfg.optical_flow_dir / cfg.dataset_name
    maps = []
    for p in paths:
        m = np.load(of_root / Path(p).relative_to(raw).with_suffix(".npy"))
        check(m.dtype == np.float32 and m.shape == FRAME_HW + (2,)
              and np.isfinite(m).all(), f"flow map of {p}: {m.dtype} {m.shape}")
        maps.append(m)
    return np.stack(maps)


def profile_calc_flow(net, frames, warm: int = 4) -> None:
    """torch.profiler over compute_optical_flow's batches of 4 (one video
    of len(frames) frames) after a warm call: device time by operator and
    the device's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    driver.compute_optical_flow(net, VideoIndex(["v"], np.array([warm])),
                                frames[:warm], device="cuda")
    index = VideoIndex(["v"], np.array([len(frames)]))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        driver.compute_optical_flow(net, index, frames, device="cuda")
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ev = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in ev
                  if e.device_type == DeviceType.CUDA)
    print(ev.table(sort_by="self_device_time_total", row_limit=20))
    print(f"calc-flow profile: {len(frames)} maps in {-(-len(frames) // 4)} batches "
          f"of 4, wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
          f"({100 * busy_us / wall_us:.1f} %); {kernel_shares(ev, busy_us)}")


def calc_flow_phase() -> dict:
    """run_calc_flow on the card over a synthetic UCSD-layout .npy tree:
    f32 whole-split, f32 segmented and bf16; returns K1's launches in the
    three runs and its error on a real batch's conv3 features."""
    shutil.rmtree(CALC_BASE, ignore_errors=True)
    config.register_dataset(dataclasses.replace(
        config.DATASETS["UCSDped2"], name=CALC_DATASET, file_ext=".npy"))
    cfg = PipelineConfig(dataset_name=CALC_DATASET)
    raw = CALC_BASE / cfg.raw_dataset_dir / CALC_DATASET
    write_calc_tree(raw, SEED + 6)
    index = {split: VideoIndex.from_layout(CALC_DATASET, str(raw), split)
             for split in ("train", "test")}
    n_by_split = [index[s].total_frames for s in ("train", "test")]
    n = sum(n_by_split)
    paths = index["train"].frame_paths + index["test"].frame_paths

    # the runner's FlowNet2, make_flownet2(0, device), built once and
    # shared by the three runs
    net = make_flownet2(0, device="cuda")
    runner.make_flownet2 = lambda seed, device: net

    # the 2-frame video on the card and on the CPU, same seeded weights
    two = index["test"].video_names[list(index["test"].video_lengths).index(2)]
    pair_idx = VideoIndex.from_video_dirs([str(raw / "Test" / two)], ".npy")
    pair = readers.load_frames(pair_idx)
    card = driver.compute_optical_flow(net, pair_idx, pair, device="cuda")
    cpu = driver.compute_optical_flow(make_flownet2(0, device="cpu"), pair_idx,
                                      pair, device="cpu")
    rel = float(np.abs(card - cpu).max() / np.abs(cpu).max())
    print(f"calc-flow: 2-frame video card vs CPU max |diff| / max |flow| = "
          f"{rel:.3e} (bound {CPU_REL_TOL}; max |flow| {np.abs(cpu).max():.4f})")
    check(card.shape == (2,) + FRAME_HW + (2,) and rel <= CPU_REL_TOL,
          f"card vs CPU calc-flow maps {card.shape}, rel {rel}")

    # the three runs with both TF32 flags on (cuDNN's is torch's default):
    # run_calc_flow's f32 route turns them off itself
    runs = [("f32 whole-split", dict(), 4, None),
            ("f32 segmented", dict(segment_frames=CALC_SEGMENT), 4, CALC_SEGMENT),
            ("bf16 whole-split", dict(flow_dtype="bfloat16"), 8, None)]
    trees, k1, conv3 = [], 0, []
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    for i, (name, kw, chunk, segment) in enumerate(runs):
        run_cfg = cfg.replace(optical_flow_dir=f"optical_flow_{i}")
        hook = None
        if i == 0:  # conv3's (a, b) of the run's first batch
            hook = net.flownetc.conv3.register_forward_hook(
                lambda m, x, out: conv3.append(out.detach().clone())
                if len(conv3) < 2 else None)
        torch.cuda.reset_peak_memory_stats()
        wall, decode, write, launches = timed_calc_flow(run_cfg, **kw)
        peak = torch.cuda.max_memory_allocated()
        if hook is not None:
            hook.remove()
        want = flow_batches(n_by_split, chunk, segment)
        print(f"calc-flow {name}: {n} maps (train {n_by_split[0]}, test "
              f"{n_by_split[1]}) in {wall:.3f} s, {n / wall:.2f} maps/s; decode "
              f"{decode:.3f} s, FlowNet2 batches (upload and download included) "
              f"{wall - decode - write:.3f} s, .npy writes {write:.3f} s; launches "
              f"{launches} for {want} batches of {chunk}; peak device memory "
              f"{peak / 2**20:.1f} MiB", flush=True)
        check(launches == {"correlation": want}, f"{name} launches {launches}, {want} batches")
        k1 += launches["correlation"]
        trees.append(read_flow_tree(run_cfg, paths))
    check(torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32,
          "run_calc_flow did not give the caller's TF32 flags back")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

    # the 2-frame video's first map, pair (f0, f0), through run_calc_flow
    # with the TF32 flags on, against the CPU's. (Alone, the video's index
    # clips both windows to the array, so both its maps are (f0, f0); in
    # the split its second map is (f0, f1).)
    at = [i for i, p in enumerate(paths) if Path(p).parent == raw / "Test" / two]
    check(len(at) == 2, f"the 2-frame video's frames in the tree: {at}")
    rel_tf32 = float(np.abs(trees[0][at[0]] - cpu[0]).max() / np.abs(cpu[0]).max())
    print(f"calc-flow: 2-frame video's map of (f0, f0) through run_calc_flow with both "
          f"TF32 flags on: max |diff| / max |flow| = {rel_tf32:.3e} against the CPU "
          f"(bound {CPU_REL_TOL})")
    check(rel_tf32 <= CPU_REL_TOL, f"run_calc_flow with TF32 flags on vs CPU {rel_tf32}")

    scale = float(np.abs(trees[0]).max())
    seg_rel = float(np.abs(trees[1] - trees[0]).max()) / scale
    bf16_rel = float(np.abs(trees[2] - trees[0]).max()) / scale
    mean_rel = float(np.abs(trees[2] - trees[0]).mean()) / scale
    print(f"calc-flow: max |flow| {scale:.4f}; segmented vs whole-split max |diff| / "
          f"max |flow| = {seg_rel:.3e} (bound {SEG_REL_TOL}); bf16 vs f32 max "
          f"{bf16_rel:.3e} (bound {BF16_REL_TOL}), mean {mean_rel:.3e}")
    check(seg_rel <= SEG_REL_TOL, f"segmented vs whole-split {seg_rel}")
    check(bf16_rel <= BF16_REL_TOL, f"bf16 vs f32 {bf16_rel}")

    a, b = conv3
    check(tuple(a.shape) == CALC_SHAPE, f"calc-flow conv3 features {tuple(a.shape)}")
    hook_err = check_fwd(a.contiguous(), b.contiguous())
    print(f"calc-flow: K1 on a batch's conv3 features max_abs_err={hook_err:.3e}")

    profile_calc_flow(net, readers.load_frames(index["train"], np.arange(16)))
    runner.make_flownet2 = make_flownet2
    shutil.rmtree(CALC_BASE, ignore_errors=True)
    return dict(launches=k1, fwd_err=hook_err)


def anomaly_masks(frame_hw, boxes, labels) -> np.ndarray:
    """(N, H, W) uint8 pixel GT of generator frames: 1 inside the anomalous
    square of each anomalous frame (the generator's last box there)."""
    masks = np.zeros((len(boxes),) + tuple(frame_hw), np.uint8)
    for t in np.nonzero(labels)[0]:
        x0, y0, x1, y1 = np.round(boxes[t][-1]).astype(int)
        masks[t, y0:y1, x0:x1] = 1
    return masks


def write_train_test_tree(root: Path, seed: int, lengths=None, frame_hw=None,
                          masks: bool = False, avenue: bool = False):
    """`lengths`' videos (default TT_LENGTHS) from the synthetic generator
    (moving squares at `frame_hw`, default FRAME_HW; anomalous squares in
    every other test video) as uint8 .npy frames, with the generator's
    boxes as the bboxes_{train,test}_obj_det_with_motion.npy fixtures. The
    UCSD layout (Train/TrainNNN, Test/TestNNN), where `masks` also writes
    the test split's full-frame .bmp label masks (needs cv2); or with
    `avenue` avenue's layout (training/frames/NN, testing/frames/NN) and
    its pixel GT, ground_truth_demo/testing_label_mask/<v>_label.mat with
    `volLabel` (scipy; the anomalous squares, anomaly_masks). Returns the
    test split's frame labels."""
    lengths = lengths or TT_LENGTHS
    tr, te = lengths["Train"], lengths["Test"]
    fpv = max(tr + te)
    frame_hw = frame_hw or FRAME_HW
    ds = make_synthetic_dataset(frames_per_video=fpv, n_train_videos=len(tr),
                                n_test_videos=len(te), frame_h=frame_hw[0],
                                frame_w=frame_hw[1], seed=seed)
    labels = []
    for split, lengths, frames, boxes in (("Train", tr, ds.train_frames, ds.train_boxes),
                                          ("Test", te, ds.test_frames, ds.test_boxes)):
        kept = []
        for v, n in enumerate(lengths):
            d = (root / f"{split.lower()}ing" / "frames" / f"{v + 1:02d}" if avenue
                 else root / split / f"{split}{v + 1:03d}")
            d.mkdir(parents=True)
            for t in range(n):
                np.save(d / f"{t:03d}.npy", frames[v * fpv + t])
                kept.append(boxes[v * fpv + t])
            if split == "Test":
                labels.append(ds.test_labels[v * fpv: v * fpv + n])
            if split == "Test" and avenue:
                import scipy.io

                gt = root / "ground_truth_demo" / "testing_label_mask"
                gt.mkdir(parents=True, exist_ok=True)
                vol = np.empty((1, n), dtype=object)
                vol[0, :] = list(anomaly_masks(frame_hw, boxes[v * fpv: v * fpv + n],
                                               labels[-1]))
                scipy.io.savemat(gt / f"{v + 1}_label.mat", {"volLabel": vol},
                                 do_compression=True)
            if split == "Test" and masks:
                import cv2

                gt = root / split / f"{split}{v + 1:03d}_gt"
                gt.mkdir()
                for t in range(n):
                    mask = np.full(frame_hw, 255 * labels[-1][t], np.uint8)
                    cv2.imwrite(str(gt / f"{t:03d}.bmp"), mask)
        fixture = np.empty(len(kept), dtype=object)
        fixture[:] = kept
        np.save(root / f"bboxes_{split.lower()}_obj_det_with_motion.npy", fixture,
                allow_pickle=True)
    return np.concatenate(labels)


def device_busy_us(prof) -> float:
    """The union of a profile's device intervals (kernels, copies), us.
    Summed self device times count cuDNN's kernels twice, under the kernel
    and under its aten op, so they can exceed the wall; the union cannot."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not e.name.startswith("aten::"))
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def profile_calls(label: str, fn, rows: int = 15):
    """torch.profiler over fn(): device time by operator and the device's
    busy share of the wall; returns the profile."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us = device_busy_us(prof)
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=rows))
    print(f"{label} profile: wall {wall_us / 1e3:.3f} ms, device busy (union of "
          f"kernel and copy intervals) {busy_us / 1e3:.3f} ms "
          f"({100 * busy_us / wall_us:.1f} %)", flush=True)
    return prof


def kernel_us(prof, pattern: str) -> float:
    """Device time of a profile's kernels whose name holds `pattern`, us."""
    from torch.autograd import DeviceType

    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and pattern in e.key)


def timed(fn):
    """(fn(), synchronised wall s)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def card_cpu_and_steps(label, cfg, base, block, test_cubes, run_step_ms):
    """What both main-path phases check and time after their run: the
    first scheduled batch's (loss, loss_raw, loss_of) from init_state(SEED)
    and the trained block's (raw, of) scores on TT_SUBSET test cubes, card
    against CPU (LOSS_REL_TOL); then TT_STEADY synchronised steps on the
    card and a profile of 5. `run_step_ms`: run_train's steps' average
    (scoring and saving included), printed beside. Returns the card's
    trainer and its step times (ms)."""
    mc, dev = cfg.model, runner.resolve_device("cuda")
    cubes = runner._extract_cached(cfg, base, "train",
                                   runner.load_split(cfg, base, "train"),
                                   cfg.fore.train_block_mode, dev)
    card_t = BlockTrainer(mc, cfg.fore.patch_size, device=dev)
    cpu_t = BlockTrainer(mc, cfg.fore.patch_size, device="cpu")
    idx, w = card_t._epoch_schedule(cubes.size, np.random.default_rng(SEED))

    losses = []
    for t in (card_t, cpu_t):  # the first scheduled batch on t's device
        ii = torch.as_tensor(idx[0], device=t.device)
        buf, of_buf = t.upload(cubes.raw), t.upload_flow(cubes.flow, cubes.raw.shape)
        t.start_fit(t.init_state(SEED))
        with torch.no_grad():
            losses.append([float(v) for v in t.loss(
                t.as_float_input(buf.index_select(0, ii)), t.flow_rows(of_buf, ii),
                torch.as_tensor(w[0], device=t.device))])
    rel = abs(losses[0][0] - losses[1][0]) / abs(losses[1][0])
    print(f"{label}: first step's loss (total, raw, flow) card={losses[0]} "
          f"cpu={losses[1]}, total rel diff={rel:.3e} (bound {LOSS_REL_TOL})")
    check(rel <= LOSS_REL_TOL, f"card vs CPU first loss {losses}")
    sub = slice(0, TT_SUBSET)
    of = None if test_cubes.flow is None else test_cubes.flow[sub]
    card_sc = card_t.score_block(block, test_cubes.raw[sub], of)
    cpu_sc = cpu_t.score_block(block, test_cubes.raw[sub], of)
    rels = [float(np.abs(c - p).max() / max(np.abs(p).max(), 1e-30))
            for c, p in zip(card_sc, cpu_sc)]
    print(f"{label}: trained block's scores on {card_sc[0].size} cubes card vs CPU "
          f"max |diff| / max |score|: raw {rels[0]:.3e}, flow {rels[1]:.3e} (bound "
          f"{LOSS_REL_TOL}; flow 0 without a flow head)")
    check(max(rels) <= LOSS_REL_TOL, f"card vs CPU block scores {rels}")
    del cpu_t

    step_ms, _ = steady_steps(label, card_t, cubes, run_step_ms)
    return card_t, step_ms


def steady_steps(label, trainer, cubes, run_step_ms):
    """TT_STEADY synchronised training steps of `trainer` from
    init_state(SEED) over `cubes`' first scheduled batches (the first
    step is left out of the statistics), then a profile of 5. Returns
    the step times (ms) and the profile."""
    idx, w = trainer._epoch_schedule(cubes.size, np.random.default_rng(SEED))
    buf = trainer.upload(cubes.raw)
    of_buf = trainer.upload_flow(cubes.flow, cubes.raw.shape)

    def batch(s):
        ii = torch.as_tensor(idx[s % idx.shape[0]], device=trainer.device)
        return (trainer.as_float_input(buf.index_select(0, ii)),
                trainer.flow_rows(of_buf, ii),
                torch.as_tensor(w[s % idx.shape[0]], device=trainer.device))

    trainer.start_fit(trainer.init_state(SEED))
    step_ms = []
    for s in range(TT_STEADY):
        args = batch(s)
        step_ms.append(timed(lambda: trainer.train_step(*args))[1] * 1e3)
    bsz = trainer.cfg.batch_size
    med = float(np.median(step_ms[1:]))
    print(f"{label}: ms per training step ({trainer.cfg.compute_dtype}, batch {bsz}, "
          f"synchronised, steps 2-{TT_STEADY}) {step_stats(step_ms[1:])}; "
          f"{bsz * 1e3 / med:.1f} cubes/s at the median; run_train's steps averaged "
          f"{run_step_ms:.3f} ms with scoring and saving", flush=True)
    args = batch(0)
    prof = profile_calls(f"{label}: 5 training steps ({trainer.cfg.compute_dtype})",
                         lambda: [trainer.train_step(*args) for _ in range(5)])
    return step_ms, prof


def train_test_phase() -> None:
    """The raw-only main path on the card: run_train, the card-side steps
    of run_test and the resident scorer, each checked (module docstring,
    phase 6)."""
    shutil.rmtree(TT_BASE, ignore_errors=True)
    cfg, mc = TT_CFG, TT_CFG.model
    config.register_dataset(dataclasses.replace(
        config.DATASETS["UCSDped2"], name=cfg.dataset_name, file_ext=".npy"))
    dev = runner.resolve_device("cuda")
    t0 = time.perf_counter()
    labels = write_train_test_tree(TT_BASE / cfg.raw_dataset_dir / cfg.dataset_name,
                                   SEED + 7)
    print(f"train-test: wrote {sum(TT_LENGTHS['Train'])} train and "
          f"{sum(TT_LENGTHS['Test'])} test frames at {FRAME_HW} in "
          f"{time.perf_counter() - t0:.1f} s (set-up)", flush=True)

    # the main path: train, counts read just before and just after
    extract_s = {}
    extract = pipeline.extract_cube_set

    def timed_extract(*a, **k):  # run_train's extraction, synchronised
        out, extract_s[len(extract_s)] = timed(lambda: extract(*a, **k))
        return out

    pipeline.extract_cube_set = runner.extract_cube_set = timed_extract
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    (model, path), wall = timed(lambda: runner.run_train(cfg, str(TT_BASE), seed=SEED,
                                                          device=dev))
    train_launches = dict(kernels.launch_counts)
    pipeline.extract_cube_set = runner.extract_cube_set = extract
    check(sorted(model.blocks) == [(0, 0, 0)], f"trained blocks {sorted(model.blocks)}")
    block = model.blocks[(0, 0, 0)]
    n_train = block.raw_scores.size
    steps = block.losses.size
    per_epoch = -(-n_train // mc.batch_size)
    first, last = block.losses[:per_epoch].mean(), block.losses[-per_epoch:].mean()
    print(f"train-test: run_train {n_train} train cubes, {steps} steps in {mc.epochs} "
          f"epochs, {wall:.2f} s wall (extraction {extract_s[0]:.2f} s, cube cache "
          f"write and model save included); mean loss epoch 1 {first:.6f}, epoch "
          f"{mc.epochs} {last:.6f}; launches {train_launches}", flush=True)
    check(steps == mc.epochs * per_epoch and np.isfinite(block.losses).all(),
          f"{steps} losses, finite {np.isfinite(block.losses).all()}")
    check(last < first, f"losses do not fall: {first} -> {last}")

    # the card-side steps of run_test
    kernels.reset_launch_counts()
    data, load_s = timed(lambda: runner.load_split(cfg, str(TT_BASE), "test"))
    test_cubes, test_extract_s = timed(lambda: runner._extract_cached(
        cfg, str(TT_BASE), "test", data, cfg.fore.test_block_mode, dev))
    n_frames = data.index.total_frames
    cube_scores, score_s = timed(lambda: pipeline.score_cubes(model, test_cubes,
                                                              device=dev))
    frame_scores = pipeline.frame_level_scores(cube_scores, test_cubes, n_frames)
    results = TT_BASE / "results"
    results.mkdir(parents=True, exist_ok=True)
    res = runner.evaluate_frame_scores(cfg, str(results), frame_scores, labels,
                                       data.index.scene_idx)
    print(f"train-test: test split {n_frames} frames, {test_cubes.size} cubes; "
          f"load_split {load_s:.2f} s, extraction {test_extract_s:.2f} s, score_cubes "
          f"{score_s:.3f} s ({n_frames / score_s:.1f} frames/s offline, "
          f"{n_frames / (test_extract_s + score_s):.1f} with extraction); "
          f"AUROC {res['auroc']:.6f}", flush=True)
    check(np.isfinite(frame_scores).all() and frame_scores.shape == (n_frames,),
          f"frame scores {frame_scores.shape}")
    check(np.isfinite(res["auroc"]), f"AUROC {res['auroc']}")

    # the resident scorer on the same model and frames
    frames_np = np.asarray(data.frames)
    windows = data.index.context_indices(mc.context_frame_num, mc.border_mode)
    peak_boxes = max(len(b) for b in data.boxes)
    boxes_pad, valid = pad_boxes(data.boxes, max(-(-peak_boxes // 8) * 8, 8))
    stats = block.raw_stats + (0.0, 1.0)
    net = make_completion_net(mc, dev)

    def resident():
        return infer_frame_scores_resident(cfg, block.state_dict, stats, frames_np,
                                           windows, boxes_pad, valid, net=net,
                                           device=dev)

    resident()  # warm
    res_scores, res_s = timed(resident)
    infer_launches = dict(kernels.launch_counts)
    diff = np.abs(res_scores.astype(np.float64) - frame_scores)
    rel = float(diff.max() / np.abs(frame_scores).max())
    print(f"train-test: resident scoring {n_frames} frames in {res_s:.3f} s "
          f"({n_frames / res_s:.1f} frames/s, frame upload and cube extraction "
          f"included); against score_cubes -> frame_level_scores max |diff| "
          f"{diff.max():.3e}, / max |score| {rel:.3e} (bound rtol=atol={RESIDENT_TOL})",
          flush=True)
    check(np.allclose(res_scores, frame_scores, rtol=RESIDENT_TOL, atol=RESIDENT_TOL),
          f"resident vs offline frame scores, max |diff| {diff.max()}")

    # the saved .npz loads back bit for bit and scores the same (up to the
    # order cuDNN sums in from one call to the next: the resident bound)
    loaded = load_vad_model(path).blocks[(0, 0, 0)]
    check(all(torch.equal(loaded.state_dict[k], v.cpu())
              for k, v in block.state_dict.items())
          and np.array_equal(loaded.raw_scores, block.raw_scores),
          "the reloaded model differs from the trained one")
    again = pipeline.score_cubes(VadModel(cfg=cfg, blocks={(0, 0, 0): loaded}),
                                 test_cubes, device=dev)
    peak = torch.cuda.max_memory_allocated()
    launches = {**train_launches, **dict(kernels.launch_counts), **infer_launches}
    print(f"train-test: reloaded {Path(path).name}: weights bit for bit, cube scores "
          f"max |diff| {np.abs(again - cube_scores).max():.3e} against the trained "
          f"model's; peak device memory {peak / 2**20:.1f} MiB; K1/K2 launches over "
          f"the phase {launches}")
    check(np.allclose(again, cube_scores, rtol=RESIDENT_TOL, atol=RESIDENT_TOL),
          "the reloaded model scores differently")
    check(not launches, f"K1/K2 launched on the main path: {launches}")

    card_cpu_and_steps("train-test", cfg, str(TT_BASE), block, test_cubes,
                       (wall - extract_s[0]) * 1e3 / steps)
    profile_calls("train-test: one resident scoring call", resident)
    shutil.rmtree(TT_BASE, ignore_errors=True)


def two_stream_phase() -> dict:
    """The two-stream main path on the card: calc-flow, run_train, the
    card-side steps of run_test with and without per-video normalisation,
    and the resident scorer with the flow tree, each checked (module
    docstring, phase 7). Leaves its workspace for phase 8 and returns
    what phase 8 reads (K1's launches in calc-flow among them)."""
    shutil.rmtree(TS_BASE, ignore_errors=True)
    cfg, mc = TS_CFG, TS_CFG.model
    # avenue's layout and .mat pixel GT, its frames stored as .npy (the
    # card's machine has no cv2 to decode .jpg)
    config.register_dataset(dataclasses.replace(config.DATASETS["avenue"],
                                                file_ext=".npy"))
    dev = runner.resolve_device("cuda")
    base = str(TS_BASE)
    raw_root = TS_BASE / cfg.raw_dataset_dir / cfg.dataset_name
    t0 = time.perf_counter()
    labels = write_train_test_tree(raw_root, SEED + 8, TS_LENGTHS, TS_HW, avenue=True)
    n_by_split = [sum(TS_LENGTHS[s]) for s in ("Train", "Test")]
    print(f"two-stream: wrote {n_by_split[0]} train and {n_by_split[1]} test frames "
          f"at {TS_HW} in {time.perf_counter() - t0:.1f} s (set-up)", flush=True)

    # 1. calc-flow over both splits with the runner's random-init FlowNet2,
    # its batches counted by a forward hook
    batches = []
    make = runner.make_flownet2

    def counted(seed, device):
        net = make(seed, device)
        net.register_forward_hook(lambda m, i, o: batches.append(i[0].shape[0]))
        return net

    runner.make_flownet2 = counted
    torch.cuda.reset_peak_memory_stats()
    try:
        wall, decode, write, calc_launches = timed_calc_flow(cfg, TS_BASE,
                                                             flow_dtype="float32")
    finally:
        runner.make_flownet2 = make
    peak = torch.cuda.max_memory_allocated()
    n = sum(n_by_split)
    want = flow_batches(n_by_split, 4)
    print(f"two-stream: calc-flow {n} maps in {wall:.3f} s, {n / wall:.2f} maps/s; "
          f"decode {decode:.3f} s, FlowNet2 batches (upload and download included) "
          f"{wall - decode - write:.3f} s, .npy writes {write:.3f} s; {len(batches)} "
          f"batches of {max(batches)}, launches {calc_launches} for {want} batches; "
          f"peak device memory {peak / 2**20:.1f} MiB", flush=True)
    check(sum(batches) == n and len(batches) == want
          and calc_launches == {"correlation": want},
          f"calc-flow launches {calc_launches}, {len(batches)} batches, {want} expected")
    of_root = TS_BASE / cfg.optical_flow_dir / cfg.dataset_name
    maps = sorted(of_root.rglob("*.npy"))
    check(len(maps) == n, f"{len(maps)} flow maps for {n} frames")
    flow_max = 0.0
    for path in maps:
        m = np.load(path)
        check(m.dtype == np.float32 and m.shape == TS_HW + (2,) and np.isfinite(m).all(),
              f"flow map {path}: {m.dtype} {m.shape}")
        flow_max = max(flow_max, float(np.abs(m).max()))
    print(f"two-stream: {n} finite {TS_HW + (2,)} float32 maps, max |flow| "
          f"{flow_max:.4f} (random-init FlowNet2: not optical flow)", flush=True)

    # 2. run_train: both streams, no K1 or K2
    extract_s = []
    extract = pipeline.extract_cube_set

    def timed_extract(*a, **k):  # run_train's extraction, synchronised
        out, dt = timed(lambda: extract(*a, **k))
        extract_s.append(dt)
        return out

    pipeline.extract_cube_set = runner.extract_cube_set = timed_extract
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    try:
        (model, path), wall = timed(lambda: runner.run_train(cfg, base, seed=SEED,
                                                              device=dev))
    finally:
        pipeline.extract_cube_set = runner.extract_cube_set = extract
    train_launches = dict(kernels.launch_counts)
    check(sorted(model.blocks) == [(0, 0, 0)], f"trained blocks {sorted(model.blocks)}")
    block = model.blocks[(0, 0, 0)]
    n_train = block.raw_scores.size
    n_boxes = sum(len(b) for b in runner.load_split(cfg, base, "train").boxes)
    steps = block.losses.size
    per_epoch = -(-n_train // mc.batch_size)
    first, last = block.losses[:per_epoch].mean(), block.losses[-per_epoch:].mean()
    check(block.of_scores is not None and block.of_scores.shape == (n_train,)
          and np.isfinite(block.of_scores).all(), "of_scores missing or not finite")
    (mu_r, sd_r), (mu_o, sd_o) = block.raw_stats, block.of_stats
    print(f"two-stream: run_train {n_train} train cubes ({n_boxes} boxes, "
          f"{n_boxes - n_train} dropped by the motion filter at motion_thr "
          f"{cfg.fore.motion_thr}), {steps} steps in {mc.epochs} epochs, {wall:.2f} s "
          f"wall (extraction {extract_s[0]:.2f} s, cube cache write and model save "
          f"included); mean total loss epoch 1 {first:.6f}, epoch {mc.epochs} "
          f"{last:.6f}; training scores raw mean {mu_r:.4f} std {sd_r:.4f}, flow "
          f"mean {mu_o:.4f} std {sd_o:.4f}; launches {train_launches}", flush=True)
    check(steps == mc.epochs * per_epoch and np.isfinite(block.losses).all(),
          f"{steps} losses, finite {np.isfinite(block.losses).all()}")
    check(last < first, f"losses do not fall: {first} -> {last}")
    check(sd_o > 0, f"the flow training scores' std is {sd_o}")

    # 3. the card-side steps of run_test, with and without per-video
    # normalisation
    kernels.reset_launch_counts()
    data, load_s = timed(lambda: runner.load_split(cfg, base, "test"))
    check(data.flow is not None, "load_split found no flow tree")
    test_cubes, test_extract_s = timed(lambda: runner._extract_cached(
        cfg, base, "test", data, cfg.fore.test_block_mode, dev))
    n_frames = data.index.total_frames
    cube_scores, score_s = timed(lambda: pipeline.score_cubes(model, test_cubes,
                                                              device=dev))
    frame_scores = pipeline.frame_level_scores(cube_scores, test_cubes, n_frames)
    aurocs = {}
    for name, fs in (("", frame_scores),
                     (" per-video", score_mod.normalize_scores_per_video(
                         frame_scores, data.index.frame_video_idx))):
        results = TS_BASE / "results" / (name.strip() or "raw")
        results.mkdir(parents=True, exist_ok=True)
        check(np.isfinite(fs).all() and fs.shape == (n_frames,), f"frame scores {fs.shape}")
        aurocs[name] = runner.evaluate_frame_scores(
            cfg, str(results), fs, labels, data.index.scene_idx)["auroc"]
        check(np.isfinite(aurocs[name]), f"AUROC{name} {aurocs[name]}")
    n_test_boxes = sum(len(b) for b in data.boxes)
    print(f"two-stream: test split {n_frames} frames, {test_cubes.size} cubes "
          f"({n_test_boxes - test_cubes.size} dropped by the motion filter); "
          f"load_split {load_s:.2f} s, extraction {test_extract_s:.2f} s, "
          f"score_cubes {score_s:.3f} s ({n_frames / score_s:.1f} frames/s offline, "
          f"{n_frames / (test_extract_s + score_s):.1f} with extraction); AUROC "
          f"{aurocs['']:.6f}, with per-video normalisation {aurocs[' per-video']:.6f}",
          flush=True)

    # 4. the resident scorer on the same model, frames and flow
    frames_np = np.asarray(data.frames)
    flow_np = data.flow[0:n_frames]
    windows = data.index.context_indices(mc.context_frame_num, mc.border_mode)
    of_windows = data.index.context_indices(mc.context_of_num,
                                            mc.border_mode).reshape(n_frames, -1)
    peak_boxes = max(len(b) for b in data.boxes)
    boxes_pad, valid = pad_boxes(data.boxes, max(-(-peak_boxes // 8) * 8, 8))
    net = make_completion_net(mc, dev)

    def resident():
        return infer_frame_scores_resident(
            cfg, block.state_dict, block.raw_stats + block.of_stats, frames_np,
            windows, boxes_pad, valid, flow=flow_np, of_windows=of_windows, net=net,
            device=dev)

    resident()  # warm
    res_scores, res_s = timed(resident)
    test_launches = dict(kernels.launch_counts)
    diff = np.abs(res_scores.astype(np.float64) - frame_scores)
    print(f"two-stream: resident scoring {n_frames} frames in {res_s:.3f} s "
          f"({n_frames / res_s:.1f} frames/s, frame and flow upload and cube "
          f"extraction included); against score_cubes -> frame_level_scores max "
          f"|diff| {diff.max():.3e}, / max |score| "
          f"{diff.max() / np.abs(frame_scores).max():.3e} (bound rtol=atol="
          f"{RESIDENT_TOL})", flush=True)
    check(np.allclose(res_scores, frame_scores, rtol=RESIDENT_TOL, atol=RESIDENT_TOL),
          f"resident vs offline frame scores, max |diff| {diff.max()}")

    # the saved .npz: weights and of_scores bit for bit, cube scores within
    # the resident bound (cuDNN's sums differ call to call)
    loaded = load_vad_model(path).blocks[(0, 0, 0)]
    check(all(torch.equal(loaded.state_dict[k], v.cpu())
              for k, v in block.state_dict.items())
          and np.array_equal(loaded.raw_scores, block.raw_scores)
          and np.array_equal(loaded.of_scores, block.of_scores),
          "the reloaded model differs from the trained one")
    again = pipeline.score_cubes(VadModel(cfg=cfg, blocks={(0, 0, 0): loaded}),
                                 test_cubes, device=dev)
    peak = torch.cuda.max_memory_allocated()
    launches = {**train_launches, **test_launches, **dict(kernels.launch_counts)}
    print(f"two-stream: reloaded {Path(path).name}: weights and of_scores bit for bit, "
          f"cube scores max |diff| {np.abs(again - cube_scores).max():.3e} against the "
          f"trained model's; peak device memory {peak / 2**20:.1f} MiB; K1/K2 launches "
          f"in train and test {launches}", flush=True)
    check(np.allclose(again, cube_scores, rtol=RESIDENT_TOL, atol=RESIDENT_TOL),
          "the reloaded model scores differently")
    check(not launches, f"K1/K2 launched in train or test: {launches}")

    card_t, step_ms = card_cpu_and_steps("two-stream", cfg, base, block, test_cubes,
                                         (wall - extract_s[0]) * 1e3 / steps)
    profile_calls("two-stream: one resident scoring call", resident)
    # the raw chain (grouped, 5 members) and the flow chain (one member,
    # ungrouped) alone: 5 train-mode forward + backward passes each
    ch = mc.context_frame_num * 3
    for name, unet, members in (("raw", card_t.net.raw_unets, 5),
                                ("flow", card_t.net.of_unets, 1)):
        xin = torch.rand((mc.batch_size, members * ch) + (cfg.fore.patch_size,) * 2,
                         device=dev)

        def passes():
            for _ in range(5):
                unet(xin, True).square().mean().backward()

        passes()  # warm
        prof = profile_calls(f"two-stream: {name} chain alone, 5 forward + backward",
                             passes, rows=8)
        print(f"two-stream: {name} chain: layout transposes (genericTranspose) "
              f"{kernel_us(prof, 'Transpose') / 5e3:.3f} ms a pass of "
              f"{device_busy_us(prof) / 5e3:.3f} ms busy", flush=True)
    return dict(calc_launches=want, block=block, frame_scores=frame_scores,
                auroc=aurocs[""], labels=labels, frames=frames_np, flow=flow_np,
                windows=windows, of_windows=of_windows, boxes_pad=boxes_pad,
                valid=valid, net=net, step_ms=step_ms, train_extract_s=extract_s[0])


def dataset_scale_phase(ts: dict) -> None:
    """The main path at dataset scale on phase 7's workspace and flow tree
    (module docstring, phase 8): bf16 resident training, the resident
    extraction against the cube cache's, the resident test with the
    pixel criterion, the segmented scorer and infer_frame_scores' routes
    against the resident one, and bf16 scoring. `ts`: what phase 7 returned."""
    cfg, dev, base = TS_CFG, runner.resolve_device("cuda"), str(TS_BASE)
    bf16_cfg = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="bfloat16"))
    f32_block = ts["block"]
    shutil.rmtree(DS_BASE, ignore_errors=True)
    DS_BASE.mkdir(parents=True)
    for d in (cfg.raw_dataset_dir, cfg.optical_flow_dir):
        (DS_BASE / d).symlink_to(TS_BASE / d, target_is_directory=True)

    # 1. bf16 resident training: the extraction timed and its cube sets
    # kept, and the trainer run_train makes kept, for the checks below
    resident_sets, trainers, read_s = [], [], []
    extract, make, whole = (runner.extract_cube_set_resident, runner.make_trainer,
                            pipeline._whole_stack)

    def timed_extract(*a, **k):
        pipeline._whole_stack = timed_read
        try:
            resident_sets.append(timed(lambda: extract(*a, **k)) + (sum(read_s),))
        finally:
            pipeline._whole_stack = whole
        read_s.clear()
        return resident_sets[-1][0]

    def timed_read(a):  # the host side: reading a whole frame or flow stack
        out, dt = timed(lambda: whole(a))
        read_s.append(dt)
        return out

    def kept_trainer(*a, **k):
        trainers.append(make(*a, **k))
        return trainers[-1]

    runner.extract_cube_set_resident, runner.make_trainer = timed_extract, kept_trainer
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    try:
        (model, path), wall = timed(lambda: runner.run_train(
            bf16_cfg, str(DS_BASE), seed=SEED, resident=True, device=dev))
    finally:
        runner.extract_cube_set_resident, runner.make_trainer = extract, make
    peak = torch.cuda.max_memory_allocated()
    launches = dict(kernels.launch_counts)
    check(sorted(model.blocks) == [(0, 0, 0)], f"trained blocks {sorted(model.blocks)}")
    block, trainer = model.blocks[(0, 0, 0)], trainers[0]
    train_cubes, train_extract_s, train_read_s = resident_sets[0]
    check(train_cubes.raw.is_cuda and train_cubes.flow.is_cuda,
          "the resident train cubes left the card")
    moments = [t for st in trainer.opt.state.values() for k, t in st.items() if k != "step"]
    check(all(p.dtype == torch.float32 for p in trainer.net.parameters())
          and len(moments) == 2 * len(list(trainer.net.parameters()))
          and all(t.dtype == torch.float32 for t in moments)
          and all(v.dtype == torch.float32 for v in block.state_dict.values()),
          "bf16 training left the master parameters or Adam's moments outside f32")
    steps = block.losses.size
    per_epoch = -(-block.raw_scores.size // bf16_cfg.model.batch_size)
    first, last = block.losses[:per_epoch].mean(), block.losses[-per_epoch:].mean()
    a, b = f32_block.raw_scores, block.raw_scores
    corr, ratio = float(np.corrcoef(a, b)[0, 1]), float(b.mean() / a.mean())
    print(f"dataset-scale: run_train bf16 --resident {b.size} train cubes, {steps} steps, "
          f"{wall:.2f} s wall (resident extraction {train_extract_s:.2f} s, of which "
          f"reading the frame and flow stacks {train_read_s:.2f} s, against phase 7's "
          f"cube-cache extraction {ts['train_extract_s']:.2f} s; model save included); mean loss "
          f"epoch 1 {first:.6f}, epoch {bf16_cfg.model.epochs} {last:.6f}; raw training "
          f"scores against phase 7's f32 model: correlation {corr:.6f} (bound > "
          f"{BF16_CORR}), mean ratio {ratio:.6f} (bound 1 +- {BF16_MEAN_RATIO}); peak "
          f"device memory {peak / 2**20:.1f} MiB; launches {launches}", flush=True)
    check(steps > 0 and np.isfinite(block.losses).all() and last < first,
          f"bf16 losses: finite {np.isfinite(block.losses).all()}, {first} -> {last}")
    check(corr > BF16_CORR and abs(ratio - 1.0) < BF16_MEAN_RATIO,
          f"bf16 against f32 training scores: corr {corr}, mean ratio {ratio}")
    check(not launches, f"K1/K2 launched in bf16 training: {launches}")
    step_ms, prof = steady_steps("dataset-scale", trainer, train_cubes,
                                 (wall - train_extract_s) * 1e3 / steps)
    busy = max(device_busy_us(prof), 1.0)
    transposes = kernel_us(prof, "Transpose")
    # cuDNN's bf16 kernels convert layouts with these instead
    conversions = kernel_us(prof, "nchwToNhwc") + kernel_us(prof, "nhwcToNchw")
    f32_med, bf16_med = float(np.median(ts["step_ms"][1:])), float(np.median(step_ms[1:]))
    print(f"dataset-scale: bf16 step median {bf16_med:.3f} ms against phase 7's f32 "
          f"{f32_med:.3f} ms ({f32_med / bf16_med:.2f}x); device busy {busy / 5e3:.3f} ms a "
          f"step; layout transposes (genericTranspose) {transposes / 5e3:.3f} ms a step "
          f"({100 * transposes / busy:.1f} % of the busy time), NCHW<->NHWC conversions "
          f"{conversions / 5e3:.3f} ms a step ({100 * conversions / busy:.1f} %)", flush=True)
    del trainer, trainers

    # 3. the resident test with the pixel criterion, on phase 7's f32 model
    f32_model = VadModel(cfg=cfg, blocks={(0, 0, 0): f32_block})
    runner.extract_cube_set_resident = timed_extract
    kernels.reset_launch_counts()
    try:
        res, wall = timed(lambda: runner.run_test(cfg, base, model=f32_model, resident=True,
                                                  pixel_criterion=True, device=dev))
    finally:
        runner.extract_cube_set_resident = extract
    test_cubes, test_extract_s, test_read_s = resident_sets[1]
    diff = np.abs(res["frame_scores"] - ts["frame_scores"])
    print(f"dataset-scale: run_test --resident --pixel-criterion {wall:.2f} s wall "
          f"(resident extraction {test_extract_s:.2f} s, of which reading the stacks "
          f"{test_read_s:.2f} s); frame scores against phase 7's "
          f"max |diff| {diff.max():.3e} (bound rtol=atol={RESIDENT_TOL}); AUROC "
          f"{res['auroc']:.6f} (phase 7: {ts['auroc']:.6f}), pixel AUROC "
          f"{res['pixel_auroc']:.6f}", flush=True)
    check(np.allclose(res["frame_scores"], ts["frame_scores"], rtol=RESIDENT_TOL,
                      atol=RESIDENT_TOL), f"resident test frame scores, max |diff| {diff.max()}")
    check(np.isfinite(res["pixel_auroc"]), f"pixel AUROC {res['pixel_auroc']}")
    check(not kernels.launch_counts, f"K1/K2 launched in test: {kernels.launch_counts}")
    # the pixel criterion's card routes against its host routes, exact, at
    # the split's size and tiled DS_PIXEL_TILE times
    data = runner.load_split(cfg, base, "test")
    n = data.index.total_frames
    cube_scores = pipeline.score_cubes(f32_model, test_cubes, device=dev)
    gt = readers.load_pixel_masks(cfg.dataset_name, str(TS_BASE / cfg.raw_dataset_dir
                                                         / cfg.dataset_name), data.index)
    for reps in (1, DS_PIXEL_TILE):
        sc, boxes = np.tile(cube_scores, reps), np.tile(test_cubes.boxes, (reps, 1))
        fids = np.concatenate([test_cubes.frame_ids + r * n for r in range(reps)])
        gt_r = np.tile(gt, (reps, 1, 1))
        host_masks, host_s = timed(lambda: score_mod.splat_score_masks(
            sc, boxes, fids, reps * n, TS_HW))
        card_masks, card_s = timed(lambda: score_mod.splat_score_masks_device(
            sc, boxes, fids, reps * n, TS_HW, device=dev))
        (host_sc, _), host_px_s = timed(lambda: metrics.pixel_level_scalars(
            host_masks, gt_r, on_device=False))
        (card_sc, _), card_px_s = timed(lambda: metrics.pixel_level_scalars(
            host_masks, gt_r, on_device=True, device=dev))
        print(f"dataset-scale: pixel criterion over {reps * n} masks of {TS_HW} "
              f"({sc.size} cubes, {host_masks.size} pixels): splat host {host_s:.3f} s, "
              f"card {card_s:.3f} s; k-th-largest reduction host {host_px_s:.3f} s, card "
              f"{card_px_s:.3f} s; {int(gt_r.any(axis=(1, 2)).sum())} anomalous frames",
              flush=True)
        check(np.array_equal(card_masks, host_masks), "device splat differs from the host's")
        check(np.array_equal(card_sc, host_sc), "device pixel scalars differ from the host's")
        del host_masks, card_masks, gt_r
    del gt

    # 2. the resident extraction against the cube cache's (phase 7 wrote it)
    for split, (cubes, _, _) in zip(("train", "test"), resident_sets):
        block_mode = getattr(cfg.fore, f"{split}_block_mode")
        cached = runner._extract_cached(cfg, base, split, runner.load_split(cfg, base, split),
                                        block_mode, dev)
        check(cubes.raw.is_cuda and cubes.flow.is_cuda, f"{split} cubes left the card")
        raw_same = np.array_equal(cubes.raw.cpu().numpy(), cached.raw)
        flow_err = float(np.abs(cubes.flow.cpu().numpy() - cached.flow).max()
                         / np.abs(cached.flow).max())
        meta_same = all(np.array_equal(getattr(cubes, k), getattr(cached, k))
                        for k in ("frame_ids", "boxes", "cells", "scenes"))
        print(f"dataset-scale: {split} resident cubes ({cubes.size}, on the card) against "
              f"the cached extraction: raw bit for bit {raw_same}, flow max |diff| / max "
              f"|flow| {flow_err:.3e} (bound 1e-6), metadata equal {meta_same}", flush=True)
        check(raw_same and flow_err <= 1e-6 and meta_same,
              f"{split} resident extraction differs from the cached one")
    del resident_sets, train_cubes, test_cubes

    # 4. the segmented scorer and infer_frame_scores' two routes against the
    # resident one
    stats = f32_block.raw_stats + f32_block.of_stats
    kw = dict(flow=ts["flow"], of_windows=ts["of_windows"], net=ts["net"], device=dev)
    args = (cfg, f32_block.state_dict, stats, ts["frames"], ts["windows"], ts["boxes_pad"],
            ts["valid"])
    routed = []
    segmented = infer.infer_frame_scores_segmented

    def counted_segmented(*a, **k):
        routed.append(k["segment_frames"])
        return segmented(*a, **k)

    forms = [
        ("resident", lambda: infer.infer_frame_scores_resident(*args, **kw)),
        (f"segmented ({DS_SEGMENT} frames a segment)",
         lambda: segmented(*args, segment_frames=DS_SEGMENT, **kw)),
        ("infer_frame_scores on one segment", lambda: infer.infer_frame_scores(*args, **kw)),
        (f"routed (budget {DS_BUDGET:.0e} B)", lambda: infer.infer_frame_scores(
            *args, device_memory_budget_bytes=DS_BUDGET, **kw)),
        ("resident bf16", lambda: infer.infer_frame_scores_resident(
            *args, compute_dtype=torch.bfloat16, **kw)),
    ]
    n_frames = ts["frames"].shape[0]
    out = {}
    infer.infer_frame_scores_segmented = counted_segmented
    try:
        for name, fn in forms:
            fn()  # warm
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out[name], sec = timed(fn)
            above = (torch.cuda.max_memory_allocated() - before) / 2**20
            ref = out["resident"]
            print(f"dataset-scale: {name} scoring {n_frames} frames in {sec:.3f} s "
                  f"({n_frames / sec:.1f} frames/s, upload and extraction included); "
                  f"peak device memory {above:.1f} MiB above the {before / 2**20:.1f} MiB "
                  f"held before the call; against resident max |diff| "
                  f"{np.abs(out[name] - ref).max():.3e}", flush=True)
    finally:
        infer.infer_frame_scores_segmented = segmented
    for name, _ in forms[1:4]:
        check(np.allclose(out[name], out["resident"], rtol=RESIDENT_TOL, atol=RESIDENT_TOL),
              f"{name} against resident frame scores")
    check(routed == [n_frames] * 2 + [DS_ROUTED_SEGMENT] * 2,
          f"infer_frame_scores did not route to one segment, then to "
          f"{DS_ROUTED_SEGMENT}-frame segments: {routed}")

    # 5. bf16 resident scoring: the AUROC against f32's
    auc = {k: metrics.roc_auc_score(out[k], ts["labels"]) for k in ("resident",
                                                                   "resident bf16")}
    print(f"dataset-scale: AUROC of resident scores f32 {auc['resident']:.6f}, bf16 "
          f"{auc['resident bf16']:.6f} (bound {BF16_AUROC_TOL})", flush=True)
    check(np.isfinite(out["resident bf16"]).all()
          and abs(auc["resident bf16"] - auc["resident"]) <= BF16_AUROC_TOL,
          f"bf16 scoring AUROC {auc}")
    shutil.rmtree(DS_BASE, ignore_errors=True)


# -- phase 9: the serving surface ------------------------------------------


def push_stream(scorer, videos, flows=None, sync=False, probe=None):
    """Every video through push(): with its flow maps (precomputed flow),
    or live, with end_video() at each video's end. Returns (scores,
    per-push ms, probe ms): `sync` synchronises after each push (push 1
    of a live video, a ring write, is not timed); `probe` = (video,
    frame) runs time_device_step there, before that frame's push."""
    live = isinstance(scorer, FlowStreamingScorer)
    scores, lat, probe_ms = [], [], None
    for i, (frames, boxes) in enumerate(videos):
        scorer.start_video()
        for t, (f, b) in enumerate(zip(frames, boxes)):
            if probe == (i, t):
                probe_ms = scorer.time_device_step(f, b)
            t0 = time.perf_counter()
            s = scorer.push(f, b) if live else scorer.push(f, b, flow=flows[i][t])
            if sync:
                torch.cuda.synchronize()
            if not (live and t == 1):
                lat.append((time.perf_counter() - t0) * 1e3)
            if s is not None:
                scores.append(s)
        if live:
            s = scorer.end_video()
            if s is not None:
                scores.append(s)
    scores += scorer.drain()
    return np.asarray(scores, np.float64), lat, probe_ms


def many_stream(scorer, videos, k, flows=None):
    """Every video through push_many in batches of k (live: end_video at
    each video's end); returns the scores."""
    live = isinstance(scorer, FlowStreamingScorer)
    out = []
    for i, (frames, boxes) in enumerate(videos):
        scorer.start_video()
        for lo in range(0, len(frames), k):
            args = (np.stack(frames[lo:lo + k]), boxes[lo:lo + k])
            out += (scorer.push_many(*args) if live
                    else scorer.push_many(*args, flows[i][lo:lo + k]))
        if live:
            s = scorer.end_video()
            if s is not None:
                out.append(s)
    return np.asarray(out + scorer.drain(), np.float64)


def rel_diff(got, want) -> float:
    """max |got - want| over the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    check(got.shape == want.shape, f"shapes {got.shape} / {want.shape}")
    return float(np.abs(got - want).max() / np.abs(want).max())


def k1_counted(fn):
    """(fn(), K1 launches during it): the counts set to 0 just before and
    read just after."""
    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, kernels.launch_counts["correlation"]


def conv3_hook(net, batch: int):
    """Capture the first (a, b) conv3 features of batch `batch` a forward
    of `net` (FlowNet2) computes; returns (list, handle)."""
    conv3 = []
    handle = net.flownetc.conv3.register_forward_hook(
        lambda m, i, o: conv3.append(o.detach().clone())
        if len(conv3) < 2 and o.shape[0] == batch else None)
    return conv3, handle


def med(lat) -> float:
    return float(np.median(lat))


def serving_surface_phase() -> dict:
    """The serving surface on the card (module docstring, phase 9, a-g):
    phase 3's model, FlowNet2 and stream, and a fleet of FLEET_C cameras.
    Returns K1's launches on these paths and its largest error on their
    conv3 features."""
    model = make_model(**SERVE_MODEL)
    videos = make_stream(FRAME_HW, VIDEO_LENGTHS, seed=SEED + 2)
    rng = np.random.default_rng(SEED + 3)
    flows = [rng.normal(0.0, 1.0, (len(f),) + FRAME_HW + (2,)).astype(np.float32)
             for f, _ in videos]
    n = sum(VIDEO_LENGTHS)
    first = VIDEO_LENGTHS[0]  # pushes of the first video: warm-up

    def scorer(**kw):
        return StreamingScorer.from_model(model, device="cuda", **kw)

    # (a) f32 scoring with TF32 off whatever the caller's flags
    base, lat32, _ = push_stream(scorer(), videos, flows, sync=True)
    check(base.shape == (n,) and np.isfinite(base).all(), f"scores {base.shape}")
    again, _, _ = push_stream(scorer(), videos, flows)  # the run-to-run floor
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        on, _, _ = push_stream(scorer(), videos, flows)
        flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        # the fault repaired: the same stream with the scorer's full_f32 taken out
        saved = serve_streaming.full_f32
        serve_streaming.full_f32 = lambda dtype=None: contextlib.nullcontext()
        try:
            tf32, _, _ = push_stream(scorer(), videos, flows)
        finally:
            serve_streaming.full_f32 = saved
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    print(f"serving-surface: (a) StreamingScorer, {n} frames with precomputed flow, "
          f"max |score| {np.abs(base).max():.4f}; TF32 flags on: scores max |diff| "
          f"{np.abs(on - base).max():.3e} from the flags-off run (a second flags-off "
          f"run {np.abs(again - base).max():.3e}), flags after {flags}; with the "
          f"scorer's full_f32 taken out (the fault) {np.abs(tf32 - base).max():.3e}, "
          f"/ max |score| {rel_diff(tf32, base):.3e} (bound {RERUN_REL_TOL})", flush=True)
    check(rel_diff(on, base) <= RERUN_REL_TOL, "TF32 flags on changed the f32 scores")
    check(flags == (True, True), f"the caller's TF32 flags were not restored: {flags}")

    # (b) pipelining: depth 2 against depth 0, sustained and unsynchronised
    fps, diffs = {0: [], 2: []}, {0: [], 2: []}
    for depth in (0, 2, 2, 0):
        sc = scorer(pipeline_depth=depth)
        push_stream(sc, videos[:1], flows[:1])  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, _, _ = push_stream(sc, videos, flows)
        fps[depth].append(n / (time.perf_counter() - t0))
        diffs[depth].append(rel_diff(got, base))
    print(f"serving-surface: (b) sustained frames/s (unsynchronised, {n} frames, "
          f"turns 0, 2, 2, 0): depth 0 {fps[0]}, depth 2 {fps[2]}; scores max |diff| "
          f"/ max |score| from (a)'s run: depth 0 {diffs[0]}, depth 2 {diffs[2]} "
          f"(bound {RERUN_REL_TOL})", flush=True)
    check(max(diffs[0] + diffs[2]) <= RERUN_REL_TOL, f"depth 2 against depth 0 {diffs}")
    # where depth 2's time goes: the device's busy share over a video's
    # pushes, and the host's waits on the device
    from torch.profiler import ProfilerActivity, profile

    sc = scorer(pipeline_depth=2)
    push_stream(sc, videos[:1], flows[:1])  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        push_stream(sc, videos[1:2], flows[1:2])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    waits = {e.key: e.count for e in prof.key_averages()
             if "Synchronize" in e.key or "Memcpy" in e.key}
    busy_us = device_busy_us(prof)
    print(f"serving-surface: (b) depth 2 profile over {VIDEO_LENGTHS[1]} pushes: wall "
          f"{wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
          f"({100 * busy_us / wall_us:.1f} %); host waits and copies {waits}", flush=True)

    # (c) push_many against k pushes, both scorers
    sc = scorer()
    many_stream(sc, videos[:1], SERVE_K, flows[:1])  # warm
    many, many_s = timed(lambda: many_stream(sc, videos, SERVE_K, flows))
    rel_many = rel_diff(many, base)
    flow_net = make_flownet2(SEED, device="cuda")

    def flow_scorer(**kw):
        return FlowStreamingScorer.from_model(model, flow_net=flow_net,
                                              flow_model_hw=FLOW_HW, device="cuda", **kw)

    (fref, flat, _), ref_launches = k1_counted(
        lambda: push_stream(flow_scorer(), videos, sync=True))
    fs = flow_scorer()
    many_stream(fs, videos[:1], SERVE_K)  # warm
    conv3, hook = conv3_hook(flow_net, SERVE_K)
    (fmany, fmany_s), many_launches = k1_counted(
        lambda: timed(lambda: many_stream(fs, videos, SERVE_K)))
    hook.remove()
    want_launches = sum(-(-ln // SERVE_K) + (ln >= 2) for ln in VIDEO_LENGTHS)
    hook_err = check_fwd(*(a.contiguous() for a in conv3))
    rel_fmany = rel_diff(fmany, fref)
    print(f"serving-surface: (c) push_many k={SERVE_K}: StreamingScorer {n / many_s:.1f} "
          f"frames/s (synchronised at the end), against k pushes max |diff| / max "
          f"|score| {rel_many:.3e}; FlowStreamingScorer {n / fmany_s:.1f} frames/s, "
          f"{rel_fmany:.3e} (bound {SERVE_REL_TOL}); K1 launches {many_launches} for "
          f"{want_launches} batches and tails (one FlowNet2 forward a batch), pushes "
          f"{ref_launches}; K1 on push_many's conv3 features {tuple(conv3[0].shape)} "
          f"max_abs_err={hook_err:.3e}", flush=True)
    check(rel_many <= SERVE_REL_TOL and rel_fmany <= SERVE_REL_TOL,
          f"push_many against k pushes: {rel_many}, {rel_fmany}")
    check(many_launches == want_launches, f"push_many K1 launches {many_launches}")
    check(ref_launches == n, f"live pushes K1 launches {ref_launches} for {n} frames")

    # (d) the probes, mid-video: the next scores as an unprobed scorer's
    probed, _, probe_ms = push_stream(scorer(), videos, flows, probe=(1, 8))
    (fprobed, _, fprobe_ms), probe_launches = k1_counted(
        lambda: push_stream(flow_scorer(), videos, probe=(1, 8)))
    # the live-flow probe again under cudnn.deterministic, against an
    # unprobed stream made likewise: FlowNet2's default cuDNN algorithms may
    # sum in another order from one live stream to the next (1.12e-6 of the
    # largest score between the probed and the unprobed stream on an H100,
    # past RERUN_REL_TOL), the deterministic ones do not
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        fdet = push_stream(flow_scorer(), videos)[0]
        fdet_probed = push_stream(flow_scorer(), videos, probe=(1, 8))[0]
    finally:
        torch.backends.cudnn.deterministic = prev
    print(f"serving-surface: (d) time_device_step: StreamingScorer {probe_ms:.3f} ms "
          f"(synchronised push median {med(lat32[first:]):.3f} ms), FlowStreamingScorer "
          f"{fprobe_ms:.3f} ms (push median {med(flat[first:]):.3f} ms); probed "
          f"streams' scores max |diff| / max |score| {rel_diff(probed, base):.3e} and "
          f"{rel_diff(fprobed, fref):.3e} from unprobed ones, the live flow's under "
          f"cudnn.deterministic {rel_diff(fdet_probed, fdet):.3e} (bound {RERUN_REL_TOL})",
          flush=True)
    check(rel_diff(probed, base) <= RERUN_REL_TOL
          and rel_diff(fdet_probed, fdet) <= RERUN_REL_TOL,
          "a probe changed the scores that follow it")

    # (e) bf16 scoring against f32
    b16, lat16, _ = push_stream(scorer(compute_dtype=torch.bfloat16), videos, flows,
                                sync=True)
    corr = float(np.corrcoef(b16, base)[0, 1])
    print(f"serving-surface: (e) bf16 scores against f32: correlation {corr:.6f} "
          f"(bound > {BF16_CORR}), max |diff| / max |score| {rel_diff(b16, base):.3e}; "
          f"ms per push (synchronised median) bf16 {med(lat16[first:]):.3f}, f32 "
          f"{med(lat32[first:]):.3f}", flush=True)
    check(np.isfinite(b16).all() and corr > BF16_CORR, f"bf16 correlation {corr}")

    # (f) the fleet: camera c starts its own video at tick c
    fleet_videos = make_stream(FRAME_HW, (FLEET_LENGTH,) * FLEET_C, seed=SEED + 9)
    fleet_flows = [rng.normal(0.0, 1.0, (FLEET_LENGTH,) + FRAME_HW + (2,))
                   .astype(np.float32) for _ in range(FLEET_C)]
    n_ticks = FLEET_C - 1 + FLEET_LENGTH

    def tick_inputs(t):
        j = [min(max(t - c, 0), FLEET_LENGTH - 1) for c in range(FLEET_C)]
        return (np.stack([fleet_videos[c][0][j[c]] for c in range(FLEET_C)]),
                [fleet_videos[c][1][j[c]] for c in range(FLEET_C)],
                np.stack([fleet_flows[c][j[c]] for c in range(FLEET_C)]))

    fleet = MultiCameraScorer.from_model(model, n_cameras=FLEET_C, device="cuda")
    fleet.start_video()
    rows, lat = [], []
    for t in range(n_ticks):
        if t < FLEET_C:
            fleet.start_video(camera=t)
        f, b, fl = tick_inputs(t)
        t0 = time.perf_counter()
        rows.append(fleet.push_tick(f, b, flows=fl))
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    rows = np.asarray(rows, np.float64)
    ref = StreamingScorer.from_model(model, device="cuda")
    fleet_rel = max(rel_diff(rows[c:c + FLEET_LENGTH, c],
                             push_stream(ref, [fleet_videos[c]], [fleet_flows[c]])[0])
                    for c in range(FLEET_C))
    f, b, _ = tick_inputs(n_ticks - 1)
    tick_ms = fleet.time_device_tick(f, b)
    # the per-camera loop form of the same tick, timed beside it
    batched = fleet._score_windows
    cam_rows = [(torch.from_numpy(r).cuda(), m) for r, m in
                (_valid_rows([len(bc)], fleet.K) for bc in b)]
    fleet._score_windows = lambda wd, owd, box_set: torch.cat(
        [batched(wd[c:c + 1], owd[c:c + 1], (box_set[0][c:c + 1], *cam_rows[c]))
         for c in range(FLEET_C)])
    loop_ms = fleet.time_device_tick(f, b)
    del fleet._score_windows
    tick_med = med(lat[2:])
    print(f"serving-surface: (f) MultiCameraScorer, {FLEET_C} cameras x {FLEET_LENGTH} "
          f"frames, starts staggered a tick apart: {tick_med:.3f} ms/tick "
          f"(synchronised median), {FLEET_C * 1e3 / tick_med:.1f} frames/s aggregate; "
          f"time_device_tick {tick_ms:.3f} ms batched (one ensemble forward over "
          f"the valid rows of {FLEET_C} x {fleet.K} cubes), {loop_ms:.3f} ms as a "
          f"per-camera loop; each camera against a StreamingScorer on its video "
          f"max |diff| / max |score| {fleet_rel:.3e} (bound {SERVE_REL_TOL})", flush=True)
    check(np.isfinite(rows).all() and fleet_rel <= SERVE_REL_TOL,
          f"fleet against single scorers: {fleet_rel}")

    # (g) the live fleet: one FlowNet2 forward over the cameras' pairs a tick
    lf = MultiCameraFlowScorer.from_model(model, n_cameras=FLEET_C, flow_net=flow_net,
                                          flow_model_hw=FLOW_HW, device="cuda")
    conv3, hook = conv3_hook(flow_net, FLEET_C)

    def live_inputs(t):  # every camera at frame t of its video
        return (np.stack([fleet_videos[c][0][t] for c in range(FLEET_C)]),
                [fleet_videos[c][1][t] for c in range(FLEET_C)])

    def live_fleet():
        rows, lat = [], []
        lf.start_video()
        for t in range(FLEET_LENGTH):
            f, b = live_inputs(t)
            t0 = time.perf_counter()
            out = lf.push_tick(f, b)
            torch.cuda.synchronize()
            if t != 1:
                lat.append((time.perf_counter() - t0) * 1e3)
            if out is not None:
                rows.append(out)
        rows.append(lf.end_video())
        return np.asarray(rows + lf.drain(), np.float64), lat

    torch.cuda.reset_peak_memory_stats()
    (lrows, llat), lf_launches = k1_counted(live_fleet)
    peak = torch.cuda.max_memory_allocated()
    hook.remove()
    lf_err = check_fwd(*(a.contiguous() for a in conv3))
    (singles, single_launches) = k1_counted(lambda: [
        push_stream(flow_scorer(), [fleet_videos[c]])[0] for c in range(FLEET_C)])
    lf_rel = max(rel_diff(lrows[:, c], singles[c]) for c in range(FLEET_C))
    # each camera's flow in the batch against its pair alone
    f0, _ = live_inputs(0)
    f1, b1 = live_inputs(1)
    pairs = torch.from_numpy(np.stack([f0, f1], 1)).cuda()
    with torch.no_grad():
        batch_flow = lf._live_flow(pairs)
        alone = torch.cat([lf._live_flow(pairs[c:c + 1]) for c in range(FLEET_C)])
    flow_rel = float((batch_flow - alone).abs().max() / alone.abs().max())
    live_tick_ms = lf.time_device_tick(f1, b1)
    live_med = med(llat[1:])
    print(f"serving-surface: (g) MultiCameraFlowScorer, {FLEET_C} cameras x "
          f"{FLEET_LENGTH} frames: {live_med:.3f} ms/tick (synchronised median of live "
          f"ticks), {FLEET_C * 1e3 / live_med:.1f} frames/s aggregate; "
          f"time_device_tick {live_tick_ms:.3f} ms; peak device memory "
          f"{peak / 2**20:.1f} MiB; K1 launches {lf_launches} for {FLEET_LENGTH} live "
          f"ticks (single-camera runs {single_launches}); K1 on a tick's conv3 features "
          f"{tuple(conv3[0].shape)} max_abs_err={lf_err:.3e}; each camera against a "
          f"FlowStreamingScorer on its video {lf_rel:.3e} (bound {SERVE_REL_TOL}); "
          f"batched flow against each pair alone {flow_rel:.3e} of the largest |flow| "
          f"(bound {LIVE_FLOW_TOL})", flush=True)
    check(lrows.shape == (FLEET_LENGTH, FLEET_C) and np.isfinite(lrows).all(),
          f"live fleet scores {lrows.shape}")
    check(lf_launches == FLEET_LENGTH, f"live fleet K1 launches {lf_launches}")
    check(single_launches == FLEET_C * FLEET_LENGTH, f"K1 launches {single_launches}")
    check(lf_rel <= SERVE_REL_TOL, f"live fleet against single scorers: {lf_rel}")
    check(flow_rel <= LIVE_FLOW_TOL, f"batched flow against single: {flow_rel}")
    return dict(launches=(ref_launches + many_launches + probe_launches + lf_launches
                          + single_launches),
                fwd_err=max(hook_err, lf_err), flow_net=flow_net)


def serve_cli(argv) -> str:
    """cli.main(argv), which must return 0; its standard output."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue()
    print(out, end="", flush=True)
    check(rc == 0, f"{argv} returned {rc}")
    return out


def serving_cli_phase(ts: dict, flow_net) -> int:
    """`serve` through cli.main on phase 7's workspace (module docstring,
    phase 9, h); returns K1's launches there. `ts`: what phase 7
    returned; flow_net: phase 3's FlowNet2 (seed 0, calc-flow's)."""
    cfg, base = TS_CFG, str(TS_BASE)
    ini = TS_BASE / "serve.cfg"
    ini.write_text(
        f"[shared_parameters]\ndataset_name = {cfg.dataset_name}\n"
        f"[{cfg.dataset_name}]\npatch_size = {cfg.fore.patch_size}\n"
        f"[SelfComplete]\nnf = {cfg.model.nf}\ncontext_frame_num = "
        f"{cfg.model.context_frame_num}\ncontext_of_num = {cfg.model.context_of_num}\n"
        f"useFlow = {cfg.model.use_flow}\n")
    common = ["serve", "--config", str(ini), "--base", base]
    out, wall = timed(lambda: serve_cli(common))
    auroc = float(re.search(r"frame-level AUROC \(streamed\): ([\d.]+)", out)[1])
    print(f"serving-cli: streamed AUROC {auroc:.4f} against phase 7's test "
          f"{ts['auroc']:.6f} (bound {STREAM_AUROC_TOL}), {wall:.1f} s", flush=True)
    check(abs(auroc - ts["auroc"]) <= STREAM_AUROC_TOL, f"streamed AUROC {auroc}")
    n0 = int(runner.load_split(cfg, base, "test").index.video_lengths[0])
    n_live, n_fleet = min(CLI_LIVE_FRAMES, n0), min(CLI_FLEET_FRAMES, n0)
    (_, wall), live_launches = k1_counted(lambda: timed(lambda: serve_cli(
        common + ["--live-flow", "--frames", str(n_live)])))
    (out, wall_f), fleet_launches = k1_counted(lambda: timed(lambda: serve_cli(
        common + ["--cameras", str(FLEET_C), "--live-flow", "--frames", str(n_fleet)])))
    spread, peak = (float(x) for x in re.search(
        r"spread ([\d.e+-]+) \(max \|score\| ([\d.e+-]+)\)", out).groups())
    print(f"serving-cli: --live-flow {n_live} frames {wall:.1f} s, K1 launches "
          f"{live_launches}; --cameras {FLEET_C} --live-flow {n_fleet} frames "
          f"{wall_f:.1f} s, K1 launches {fleet_launches}, spread / max |score| "
          f"{spread / peak:.3e} (bound {SERVE_REL_TOL})", flush=True)
    # one per live push or tick: all but the second, plus the tail
    check(live_launches == n_live and fleet_launches == n_fleet,
          f"CLI K1 launches {live_launches}, {fleet_launches}")
    check(spread <= SERVE_REL_TOL * peak, f"cross-camera spread {spread} of {peak}")

    # live flow over the first test video against phase 7's offline scores
    data = runner.load_split(cfg, base, "test")
    video = ([np.asarray(data.frames[t]) for t in range(n0)], data.boxes[:n0])
    sc = FlowStreamingScorer.from_model(load_vad_model(runner.model_path(cfg, base)),
                                        flow_net=flow_net, device="cuda")
    (live, _, _), launches = k1_counted(lambda: push_stream(sc, [video]))
    rel = rel_diff(live, ts["frame_scores"][:n0])
    print(f"serving-cli: FlowStreamingScorer over test video 1 ({n0} frames) against "
          f"phase 7's offline frame scores (calc-flow's tree) max |diff| / max |score| "
          f"{rel:.3e} (bound {LIVE_OFFLINE_TOL}); K1 launches {launches}", flush=True)
    check(rel <= LIVE_OFFLINE_TOL and launches == n0,
          f"live flow against offline: {rel}, {launches} launches")
    return live_launches + fleet_launches + launches


# -- phase 10: foreground boxes and motion serving -------------------------


def write_shanghaitech_tree(root: Path, seed: int) -> None:
    """FG_LENGTHS' videos from the synthetic generator at FG_HW (moving
    squares; anomalous squares in every other test video) as uint8 .npy
    frames in ShanghaiTech's layout: training/videosFrame/01_NNN,
    Testing/frames_part1/01_NNNN, and each test video's frame labels in
    Testing/test_frame_mask/<video>.npy. No bbox fixtures."""
    tr, te = FG_LENGTHS["Train"], FG_LENGTHS["Test"]
    fpv = max(tr + te)
    ds = make_synthetic_dataset(frames_per_video=fpv, n_train_videos=len(tr),
                                n_test_videos=len(te), frame_h=FG_HW[0],
                                frame_w=FG_HW[1], seed=seed)
    for split, lengths, frames in (("train", tr, ds.train_frames),
                                   ("test", te, ds.test_frames)):
        for v, n in enumerate(lengths):
            name = f"01_{v + 1:03d}" if split == "train" else f"01_{v + 1:04d}"
            d = root / ("training/videosFrame" if split == "train"
                        else "Testing/frames_part1") / name
            d.mkdir(parents=True)
            for t in range(n):
                np.save(d / f"{t:03d}.npy", frames[v * fpv + t])
            if split == "test":
                gt = root / "Testing" / "test_frame_mask"
                gt.mkdir(parents=True, exist_ok=True)
                np.save(gt / f"{name}.npy", ds.test_labels[v * fpv: v * fpv + n])


def scored_rel(got, want) -> float:
    """rel_diff over the frames that have a scoring box; frames without
    one (-big_number) must match exactly."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    check(got.shape == want.shape, f"shapes {got.shape} / {want.shape}")
    empty = want <= -score_mod.BIG_NUMBER
    check(np.array_equal(got[empty], want[empty]) and (~empty).any(),
          f"{empty.sum()} frames without boxes do not match")
    return rel_diff(got[~empty], want[~empty])


def recording(cls, out: list, made: list):
    """`cls` with every score its push() and end_video() emit appended to
    `out` and each instance appended to `made`."""

    class Recorded(cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

        def push(self, *a, **k):
            s = super().push(*a, **k)
            if s is not None:
                out.append(s)
            return s

        def end_video(self):
            got = super().end_video()
            out.extend(got)
            return got

    return Recorded


def foreground_phase() -> dict:
    """Foreground boxes from the frames and the motion scorers on the card
    (module docstring, phase 10, a-e). Returns K1's launches on the main
    paths here and its largest error on a live push's conv3 features."""
    shutil.rmtree(FG_BASE, ignore_errors=True)
    cfg, mc = FG_CFG, FG_CFG.model
    # ShanghaiTech's layout, its frames stored as .npy (the card's machine
    # has no cv2 to decode .jpg)
    config.register_dataset(dataclasses.replace(config.DATASETS["ShanghaiTech"],
                                                file_ext=".npy"))
    spec = cfg.dataset
    dev = runner.resolve_device("cuda")
    base = str(FG_BASE)
    raw_root = FG_BASE / cfg.raw_dataset_dir / cfg.dataset_name
    t0 = time.perf_counter()
    write_shanghaitech_tree(raw_root, SEED + 10)
    n_tr, n_te = (sum(FG_LENGTHS[s]) for s in ("Train", "Test"))
    print(f"foreground: wrote {n_tr} train and {n_te} test frames at {FG_HW} in "
          f"ShanghaiTech's layout in {time.perf_counter() - t0:.1f} s (set-up)",
          flush=True)
    te_index = VideoIndex.from_layout(cfg.dataset_name, str(raw_root), "test", ".npy")
    te_frames = readers.LazyFrameStack(te_index)

    # (a) motion maps on the card against the CPU, bit for bit
    small = make_synthetic_dataset(frames_per_video=FG_WINDOWS + 2, n_train_videos=1,
                                   n_test_videos=1, frame_h=FG_SMALL_HW[0],
                                   frame_w=FG_SMALL_HW[1], seed=SEED + 12)
    for fspec, frames in ((spec, np.asarray(te_frames[0:FG_WINDOWS + 2])),
                          (config.DATASETS["UCSDped2"], small.test_frames)):
        k, thr = int(fspec.mt_gauss_mask_size), int(fspec.mt_binary_thr)
        win = np.stack([frames[t:t + 3] for t in range(FG_WINDOWS)])
        win_t = torch.from_numpy(win).to(dev)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        card = fmotion.motion_maps(win_t, k, thr)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - held
        cpu = fmotion.motion_maps(torch.from_numpy(win), k, thr)
        check(card.dtype == torch.bool and torch.equal(card.cpu(), cpu),
              f"card maps differ from the CPU's at {frames.shape[1:3]}")
        ms = cuda_ms(lambda: fmotion.motion_maps(win_t, k, thr), reps=5)
        maps = cpu.numpy()
        fmotion.motion_bboxes(maps[0], None, fspec.mt_area_thr, fspec.mt_extend)  # warm
        t0 = time.perf_counter()
        n_boxes = sum(fmotion.motion_bboxes(m, None, fspec.mt_area_thr,
                                            fspec.mt_extend).shape[0] for m in maps)
        contour_ms = (time.perf_counter() - t0) * 1e3 / FG_WINDOWS
        print(f"foreground: (a) motion maps of {FG_WINDOWS} windows at "
              f"{frames.shape[1:3]} (k {k}, threshold {thr}): card equal to the CPU "
              f"bit for bit ({100 * maps.mean():.2f} % of pixels set); map pass "
              f"{ms:.3f} ms per {FG_WINDOWS} frames (CUDA events), peak device "
              f"memory {peak / 2**20:.1f} MiB above the windows; host contours "
              f"{contour_ms:.3f} ms a frame ({n_boxes} boxes)", flush=True)
        del win_t, card

    # (b) precompute-boxes through the CLI (motion-only: no detector)
    ini = FG_BASE / "fg.cfg"
    ini.write_text(
        f"[shared_parameters]\ndataset_name = {cfg.dataset_name}\n"
        f"[{cfg.dataset_name}]\npatch_size = {cfg.fore.patch_size}\n"
        f"[SelfComplete]\nnf = {mc.nf}\ncontext_frame_num = {mc.context_frame_num}\n"
        f"context_of_num = {mc.context_of_num}\nuseFlow = {mc.use_flow}\n")
    common = ["--config", str(ini), "--base", base]
    clock = {}
    compute = runner.compute_foreground_bboxes
    runner.compute_foreground_bboxes = lambda *a, **k: compute(*a, timings=clock, **k)
    torch.cuda.reset_peak_memory_stats()
    try:
        _, wall = timed(lambda: serve_cli(["precompute-boxes"] + common))
    finally:
        runner.compute_foreground_bboxes = compute
    peak = torch.cuda.max_memory_allocated()
    fixtures = {s: np.load(raw_root / f"bboxes_{s}_obj_det_with_motion.npy",
                           allow_pickle=True) for s in ("train", "test")}
    counts = np.array([b.shape[0] for s in fixtures for b in fixtures[s]])
    print(f"foreground: (b) precompute-boxes {n_tr + n_te} frames in {wall:.2f} s, "
          f"{(n_tr + n_te) / wall:.1f} frames/s: frame reads {clock['read']:.3f} s, "
          f"map pass (upload, blur, threshold) {clock['maps']:.3f} s, map downloads "
          f"{clock['download']:.3f} s, host contours {clock['contours']:.3f} s "
          f"({1e3 * clock['contours'] / (n_tr + n_te):.2f} ms a frame), the rest "
          f"(index, fixture writes) {wall - sum(clock.values()):.3f} s; peak device memory "
          f"{peak / 2**20:.1f} MiB; boxes a frame mean {counts.mean():.2f} max "
          f"{counts.max()}", flush=True)
    check(all(len(fixtures[s]) == n for s, n in (("train", n_tr), ("test", n_te))),
          "fixture lengths")
    check(all(b.dtype == np.float32 and b.ndim == 2 and b.shape[1] == 4
              for s in fixtures for b in fixtures[s]), "fixture dtypes")
    check(counts.max() <= cfg.fore.max_boxes_per_frame and (counts > 0).mean() > 0.5,
          f"boxes a frame {counts.min()}-{counts.max()}")
    # the first FG_CPU_FRAMES test frames (and the next, their last window's)
    # on the CPU and on the card, against the fixture
    idx = VideoIndex(["v"], np.array([FG_CPU_FRAMES + 1]))
    head = np.asarray(te_frames[0:FG_CPU_FRAMES + 1])
    on = {d: compute_foreground_bboxes(cfg, spec, idx, frames=head,
                                       detector=runner._resolve_detector(cfg),
                                       device=d) for d in ("cpu", "cuda")}
    for i in range(FG_CPU_FRAMES):
        a, b, f = on["cpu"][i], on["cuda"][i], fixtures["test"][i]
        check(a.dtype == b.dtype and np.array_equal(a, b)
              and np.array_equal(np.asarray(a, np.float32), f),
              f"test frame {i}: CPU boxes {a}, card {b}, fixture {f}")
    fixture = raw_root / "bboxes_test_obj_det_with_motion.npy"
    aside = fixture.with_suffix(".aside")
    fixture.rename(aside)
    try:
        data, load_s = timed(lambda: runner.load_split(cfg, base, "test", device=dev))
    finally:
        aside.rename(fixture)
    check(len(data.boxes) == n_te and all(
        np.array_equal(np.asarray(b, np.float32), f)
        for b, f in zip(data.boxes, fixtures["test"])), "load_split's boxes")
    print(f"foreground: (b) the first {FG_CPU_FRAMES} test frames' boxes on the CPU "
          f"equal the card's and the fixture's; load_split without the fixture "
          f"computed the same {n_te} frames' boxes in {load_s:.2f} s", flush=True)

    # (c) calc-flow -> train -> test on those boxes
    torch.cuda.reset_peak_memory_stats()
    wall, decode, write, calc_launches = timed_calc_flow(cfg, FG_BASE,
                                                         flow_dtype="float32")
    want = flow_batches([n_tr, n_te], 4)
    print(f"foreground: (c) calc-flow {n_tr + n_te} maps at {FG_HW} in {wall:.2f} s, "
          f"{(n_tr + n_te) / wall:.2f} maps/s (decode {decode:.2f} s, .npy writes "
          f"{write:.2f} s), K1 launches {calc_launches} for {want} batches", flush=True)
    check(calc_launches == {"correlation": want}, f"calc-flow launches {calc_launches}")
    kernels.reset_launch_counts()
    (model, _), train_s = timed(lambda: runner.run_train(cfg, base, seed=SEED,
                                                         device=dev))
    block = model.blocks[(0, 0, 0)]
    per_epoch = -(-block.raw_scores.size // mc.batch_size)
    first, last = block.losses[:per_epoch].mean(), block.losses[-per_epoch:].mean()
    check(np.isfinite(block.losses).all() and last < first,
          f"losses {first} -> {last}")
    res, test_s = timed(lambda: runner.run_test(cfg, base, model=model, device=dev))
    fs = res["frame_scores"]
    check(fs.shape == (n_te,) and np.isfinite(fs).all() and np.isfinite(res["auroc"]),
          f"test: {fs.shape} frame scores, AUROC {res['auroc']}")
    print(f"foreground: (c) run_train {block.raw_scores.size} cubes, "
          f"{block.losses.size} steps, {train_s:.2f} s (loss {first:.4f} -> "
          f"{last:.4f}); run_test {test_s:.2f} s, AUROC {res['auroc']:.6f}; "
          f"launches {dict(kernels.launch_counts)}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", flush=True)
    check(not kernels.launch_counts.get("correlation"), "K1 in train or test")

    # (d) serve --motion and serve --motion --live-flow over the test split
    import vec_vad_torch.serve as serve_pkg

    frame0, boxes0 = np.asarray(te_frames[FG_CPU_FRAMES]), fixtures["test"][FG_CPU_FRAMES]
    conv3, hooks = [], []
    build = cli._build_live_flow

    def hooked(args, device):  # K1 on a live push's conv3 features
        net, kw = build(args, device)
        cap, handle = conv3_hook(net, 1)
        conv3.append(cap)
        hooks.append(handle)
        return net, kw

    out = {}
    launches = {}
    for name, flag in (("MotionStreamingScorer", []),
                       ("MotionFlowStreamingScorer", ["--live-flow"])):
        scores, made = [], []
        cls = getattr(serve_pkg, name)
        setattr(serve_pkg, name, recording(cls, scores, made))
        cli._build_live_flow = hooked
        try:
            (text, wall), launches[name] = k1_counted(lambda: timed(
                lambda: serve_cli(["serve", "--motion"] + flag + common)))
        finally:
            setattr(serve_pkg, name, cls)
            cli._build_live_flow = build
            for h in hooks:
                h.remove()
        auroc = float(re.search(r"frame-level AUROC \(streamed\): ([\d.]+)", text)[1])
        med_ms, p90_ms = (float(x) for x in re.search(
            r"median latency ([\d.]+) ms .* p90 ([\d.]+) ms", text).groups())
        rel = scored_rel(scores, fs)
        probe = made[0].time_device_step(frame0, boxes0)
        print(f"foreground: (d) serve --motion {' '.join(flag)}: {n_te} frames in "
              f"{wall:.2f} s, push median {med_ms:.1f} ms p90 {p90_ms:.1f} ms, "
              f"time_device_step {probe:.3f} ms; streamed AUROC {auroc:.4f} against "
              f"test's {res['auroc']:.6f} (bound {STREAM_AUROC_TOL}); frame scores "
              f"against test's max |diff| / max |score| {rel:.3e} (bound "
              f"{LIVE_OFFLINE_TOL}); K1 launches {launches[name]}", flush=True)
        check(abs(auroc - res["auroc"]) <= STREAM_AUROC_TOL, f"streamed AUROC {auroc}")
        check(rel <= LIVE_OFFLINE_TOL, f"served against test: {rel}")
        out[name] = made[0]
    check(launches["MotionStreamingScorer"] == 0
          and launches["MotionFlowStreamingScorer"] == n_te,
          f"serve --motion K1 launches {launches}")
    a, b = conv3[-1]
    check(tuple(a.shape) == SERVE_SHAPE, f"conv3 features {tuple(a.shape)}")
    fwd_err = check_fwd(a.contiguous(), b.contiguous())
    print(f"foreground: (d) K1 on a live push's conv3 features max_abs_err "
          f"{fwd_err:.3e}", flush=True)
    del out

    # (e) appearance boxes merged, a 2-frame and a 1-frame video, against the
    # card's offline pipeline on the same boxes
    data = runner.load_split(cfg, base, "test", device=dev)
    v2 = int(data.index.video_lengths[0])
    rows = list(range(FG_AP_VIDEO)) + [v2, v2 + 1]
    frames = np.stack([np.asarray(data.frames[r]) for r in rows])
    flows = np.stack([np.asarray(data.flow[r]) for r in rows])
    lengths = (FG_AP_VIDEO, 2)
    # seeded appearance detections (0-3 a frame, 10-30 % of the frame's
    # width and height), filtered and suppressed like the offline stage
    rng = np.random.default_rng(SEED + 11)
    wh = np.array(FG_HW[::-1], np.float64)
    raw = []
    for _ in rows:
        n = int(rng.integers(0, 4))
        xy = rng.uniform(0, 0.7, (n, 2)) * wh
        raw.append((np.concatenate([xy, xy + rng.uniform(0.1, 0.3, (n, 2)) * wh], 1),
                    rng.uniform(0, 1, n)))
    ap = [del_cover_bboxes(filter_detections(b, s, spec.ap_score_thr, spec.ap_min_area),
                           spec.cover_thr) for b, s in raw]
    idx = VideoIndex(["a", "b"], np.array(lengths))
    dets = iter(raw)
    boxes = compute_foreground_bboxes(cfg, spec, idx, frames=frames,
                                      detector=lambda img: next(dets), device=dev)
    n_ap = sum(a.shape[0] for a in ap)
    check(n_ap > 0, "no appearance box passed the filters")
    boxes_pad, valid = pad_boxes(boxes, cfg.fore.max_boxes_per_frame)
    offline = infer_frame_scores_resident(
        cfg, block.state_dict, block.raw_stats + block.of_stats, frames,
        idx.context_indices(mc.context_frame_num, mc.border_mode), boxes_pad, valid,
        flow=flows, of_windows=idx.context_indices(
            mc.context_of_num, mc.border_mode).reshape(len(rows), -1), device=dev)
    sc = MotionStreamingScorer.from_model(model, spec=spec, device="cuda")
    streamed, i = [], 0
    for ln in lengths:
        sc.start_video()
        for _ in range(ln):
            s = sc.push(frames[i], ap_boxes=ap[i], flow=flows[i])
            if s is not None:
                streamed.append(s)
            i += 1
        streamed += sc.end_video()
    rel = scored_rel(streamed, offline)
    # a 1-frame video: its window [0, 0, 0] maps nothing, so it scores its
    # appearance boxes alone, as StreamingScorer does (and -big_number
    # without any)
    one_ap = (np.array([[0.12, 0.17, 0.3, 0.62]]) * np.tile(wh, 2)).astype(np.float32)
    sc.start_video()
    sc.push(frames[0], ap_boxes=one_ap, flow=flows[0])
    got1 = sc.end_video()
    plain = StreamingScorer.from_model(model, device="cuda")
    plain.start_video()
    want1 = plain.push(frames[0], one_ap, flow=flows[0])
    sc.start_video()
    sc.push(frames[0], flow=flows[0])
    empty = sc.end_video()
    rel1 = abs(got1[0] - want1) / abs(want1)
    print(f"foreground: (e) MotionStreamingScorer with {n_ap} appearance boxes over "
          f"videos of {lengths} frames against the offline pipeline on "
          f"compute_foreground_bboxes' boxes: max |diff| / max |score| {rel:.3e} "
          f"(bound {SERVE_REL_TOL}); a 1-frame video {got1} against StreamingScorer's "
          f"{want1:.6f} ({rel1:.3e}), without boxes {empty}", flush=True)
    check(rel <= SERVE_REL_TOL and rel1 <= SERVE_REL_TOL, f"(e): {rel}, {rel1}")
    check(empty == [-score_mod.BIG_NUMBER], f"a 1-frame video without boxes {empty}")
    return {"launches": calc_launches["correlation"]
            + launches["MotionFlowStreamingScorer"], "fwd_err": fwd_err}


# -- phase 11: the appearance detector -------------------------------------


def calibrated_cascade_state(frames, seed: int):
    """The seeded random R101 Cascade R-CNN (mdet.random_cascade_state)
    with the regression weights (rpn_reg, each stage's fc_reg) and the
    other classes' fc_cls rows scaled by DT_OTHER_SCALE and the person
    bias of every stage shifted so that DT_TARGET RoIs a frame of
    `frames` clear a 0.5 person score. Returns (state dict, {"params",
    "shift", "valid"})."""
    sd = mdet.random_cascade_state(DT_DEPTH, seed)
    other = torch.arange(mdet.NUM_CLASSES) != DT_PERSON
    # random regression weights throw the boxes to the image's borders,
    # degenerate there; scaled down, they keep near their anchors, as a
    # trained detector's do
    sd["rpn_head.rpn_reg.weight"] *= DT_OTHER_SCALE
    for i in range(3):
        sd[f"bbox_head.{i}.fc_cls.weight"][other] *= DT_OTHER_SCALE
        sd[f"bbox_head.{i}.fc_reg.weight"] *= DT_OTHER_SCALE
    n_params = sum(v.numel() for v in sd.values())
    det = mdet.MMDetCascadeDetector(load_mmdet_state(mdet.CascadeRCNN(DT_DEPTH), sd),
                                    device="cuda")
    st = {}
    det.run(frames, stages=st)
    m = (sum(st["logits"]) / 3.0)[st["valid"]]
    # p_person > 0.5 where its mean logit beats the log-sum-exp of the others
    margin = m[:, DT_PERSON] - torch.logsumexp(m[:, other.to(m.device)], -1)
    top = torch.sort(margin, descending=True)[0]
    shift = -float(top[DT_TARGET * len(frames)])
    for i in range(3):
        sd[f"bbox_head.{i}.fc_cls.bias"][DT_PERSON] += shift
    del det
    return sd, {"params": n_params, "shift": shift, "valid": int(m.shape[0])}


def write_detector_checkpoint(frames) -> dict:
    """calibrated_cascade_state(frames) saved as an mmcv checkpoint at
    DT_CKPT. Returns what it printed."""
    sd, made = calibrated_cascade_state(frames, SEED + 20)
    DT_CKPT.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"state_dict": sd, "meta": {"seed": SEED + 20,
                                           "person_shift": made["shift"]}}, DT_CKPT)
    return made


def match_rows(a, b, tol) -> float:
    """Share of the rows of a (n, d) found in b (m, d) within `tol` on
    every column."""
    if a.shape[0] == 0:
        return 1.0
    d = (a[:, None, :] - b[None, :, :]).abs().amax(-1)
    return float((d.amin(1) <= tol).float().mean()) if b.shape[0] else 0.0


def detector_phase() -> None:
    """The converted Cascade R-CNN on phase 10's tree (module docstring,
    phase 11, a-e)."""
    cfg, mc = FG_CFG, FG_CFG.model
    spec = cfg.dataset
    dev = runner.resolve_device("cuda")
    base = str(FG_BASE)
    raw_root = FG_BASE / cfg.raw_dataset_dir / cfg.dataset_name
    te_index = VideoIndex.from_layout(cfg.dataset_name, str(raw_root), "test", ".npy")
    te_frames = readers.LazyFrameStack(te_index)
    n_tr, n_te = (sum(FG_LENGTHS[s]) for s in ("Train", "Test"))

    # (a) the checkpoint
    t0 = time.perf_counter()
    rows = np.linspace(0, n_te - 1, DT_CAL_FRAMES).astype(int)
    made = write_detector_checkpoint(np.stack([np.asarray(te_frames[r]) for r in rows]))
    print(f"detector: (a) R{DT_DEPTH} Cascade R-CNN, {made['params']:,} parameters and "
          f"BN statistics (seed {SEED + 20}); person bias shifted by {made['shift']:.4f} so "
          f"that {DT_TARGET} RoIs a frame of {DT_CAL_FRAMES} test frames clear 0.5 "
          f"({made['valid']} valid proposals); {DT_CKPT.stat().st_size / 2**20:.1f} MiB "
          f"written in {time.perf_counter() - t0:.1f} s (set-up)", flush=True)
    check(made["params"] == DT_PARAMS[DT_DEPTH], f"{made['params']} parameters")

    # (b) the card against the CPU on DT_CPU_FRAMES frames
    card = mdet.MMDetCascadeDetector.from_checkpoint(str(DT_CKPT), device="cuda")
    cpu = mdet.MMDetCascadeDetector.from_checkpoint(str(DT_CKPT), device="cpu")
    check(card.model.depth == DT_DEPTH, f"inferred depth {card.model.depth}")
    two = np.stack([np.asarray(te_frames[r]) for r in range(DT_CPU_FRAMES)])
    st_g, st_c = {}, {}
    (gb, gs, gl, gok), scale = card.run(two, stages=st_g)
    t0 = time.perf_counter()
    (cb, cs, cl, cok), _ = cpu.run(two, stages=st_c)
    cpu_s = time.perf_counter() - t0
    rel = lambda a, b: float((a.cpu() - b).abs().max() / b.abs().max())
    pyr = max(rel(a, b) for a, b in zip(st_g["pyramid"], st_c["pyramid"]))
    img_hw = mdet.rescale_shape(*FG_HW, *card.img_scale)[:2]
    with torch.no_grad(), full_f32():
        # each stage on the CPU from the card's rois of that stage
        stage_rel = []
        for i, head in enumerate(cpu.model.bbox_head):
            logits, deltas = head(mdet.roi_align_pyramid(st_c["pyramid"][:4],
                                                         st_g["rois"][i].cpu()))
            stage_rel.append(max(rel(st_g["logits"][i], logits.reshape(st_g["logits"][i].shape)),
                                 rel(st_g["deltas"][i], deltas.reshape(st_g["deltas"][i].shape))))
        bb = mdet.delta2bbox(st_g["rois"][-1].cpu(), st_g["deltas"][-1].cpu(),
                             mdet.STAGE_STDS[-1], img_hw)
        forced = mdet.multiclass_nms(mdet.true_div(st_g["bboxes"].cpu(), scale),
                                     st_g["scores"].cpu(), st_g["valid"].cpu(), 0.05, 0.5,
                                     100)
    box_rel = rel(st_g["bboxes"], bb)
    for g, w in zip((gb, gs, gl, gok), forced):
        check(torch.equal(g.cpu(), w), "multiclass NMS on the card's boxes differs on the CPU")
    tol = DT_REL * max(img_hw)  # px
    prop, dets = [], []
    for i in range(DT_CPU_FRAMES):
        pg, pc = (s["proposals"][i][s["valid"][i]].cpu() for s in (st_g, st_c))
        prop.append(min(match_rows(pg, pc, tol), match_rows(pc, pg, tol)))
        # the detections over ap_score_thr as (label * 1e4, score *
        # max(img_hw), box): the same label, the score within DT_REL and
        # the box within tol
        row = lambda b, s, l, ok: (lambda k: torch.cat(
            [l[k, None].float() * 1e4, s[k, None] * max(img_hw), b[k]], 1).cpu())(
            ok & (s > spec.ap_score_thr))
        a, c = row(gb[i], gs[i], gl[i], gok[i]), row(cb[i], cs[i], cl[i], cok[i])
        dets.append(min(match_rows(a, c, tol), match_rows(c, a, tol)))
    n_det = [int(x) for x in (gok & (gs > spec.ap_score_thr)).sum(1)]
    print(f"detector: (b) {DT_CPU_FRAMES} frames at {FG_HW} -> {img_hw} (canvas "
          f"{tuple(st_g['pyramid'][0].shape[2:])} x 4): card against the CPU ({cpu_s:.1f} s "
          f"there): pyramid max |diff| / max {pyr:.3e}; each stage on the CPU from the "
          f"card's rois {', '.join(f'{r:.3e}' for r in stage_rel)} (logits and deltas), "
          f"the final boxes {box_rel:.3e}; the CPU's multiclass NMS on the card's boxes "
          f"equal; independent runs: proposals matched {prop}, detections over "
          f"{spec.ap_score_thr} matched {dets} of {n_det} (of {gok.sum(1).tolist()} "
          f"detections) within {tol:.3f} px (bounds {DT_REL}, {DT_MATCHED})", flush=True)
    check(pyr <= DT_REL and max(stage_rel) <= DT_REL and box_rel <= DT_REL,
          f"card vs CPU: pyramid {pyr}, stages {stage_rel}, boxes {box_rel}")
    check(min(prop) >= DT_MATCHED, f"proposals matched {prop}")
    del cpu, st_c, st_g

    # (c) precompute-boxes with the checkpoint through the CLI (the train
    # split), then (d) train, and test with no test fixture: load_split
    # runs the detector on the test split itself
    ini = FG_BASE / "det.cfg"
    ini.write_text(
        f"[shared_parameters]\ndataset_name = {cfg.dataset_name}\n"
        f"foreground_extraction_mode = obj_det_with_motion\nmmdet_checkpoint = {DT_CKPT}\n"
        f"[{cfg.dataset_name}]\npatch_size = {cfg.fore.patch_size}\n"
        f"[SelfComplete]\nnf = {mc.nf}\ncontext_frame_num = {mc.context_frame_num}\n"
        f"context_of_num = {mc.context_of_num}\nuseFlow = {mc.use_flow}\n")
    dcfg = config.load_ini_config(str(ini))
    check(dcfg.fore.mmdet_checkpoint == str(DT_CKPT), "the INI's mmdet_checkpoint")
    (raw_root / "bboxes_test_obj_det_with_motion.npy").unlink(missing_ok=True)  # phase 10's
    raw, det_s, computed, clock = [], [0.0], [], {}
    many = mdet.MMDetCascadeDetector.detect_many
    compute = runner.compute_foreground_bboxes

    def recorded(self, frames, marks=None):
        t = time.perf_counter()
        out = many(self, frames, marks)
        det_s[0] += time.perf_counter() - t
        raw.extend(out)
        return out

    def computing(*a, **k):
        out = compute(*a, timings=clock, **k)
        computed.append(out)
        return out

    runner.compute_foreground_bboxes = computing
    mdet.MMDetCascadeDetector.detect_many = recorded
    runner._mmdet_detector.cache_clear()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    try:
        _, wall = timed(lambda: serve_cli(["precompute-boxes", "--overwrite", "--splits",
                                           "train", "--config", str(ini), "--base", base]))
        pre_s, pre_clock = det_s[0], sum(clock.values())
        (model, _), train_s = timed(lambda: runner.run_train(dcfg, base, seed=SEED,
                                                             device=dev))
        res, test_s = timed(lambda: runner.run_test(dcfg, base, model=model, device=dev))
    finally:
        runner.compute_foreground_bboxes = compute
        mdet.MMDetCascadeDetector.detect_many = many
    peak = torch.cuda.max_memory_allocated()
    check(not kernels.launch_counts.get("correlation"), "K1 in the detector's phase")
    check(len(computed) == 2 and [len(c) for c in computed] == [n_tr, n_te],
          f"boxes computed for {[len(c) for c in computed]} frames")
    fixture = np.load(raw_root / "bboxes_train_obj_det_with_motion.npy", allow_pickle=True)
    check(len(fixture) == n_tr and all(np.array_equal(np.asarray(b, np.float32), f)
                                       for b, f in zip(computed[0], fixture)),
          "the train fixture differs from the boxes precompute-boxes computed")
    n = n_tr + n_te
    # the padded tail's results are dropped: raw holds ceil(n / 4) * 4 a split
    kept = raw[:n_tr] + raw[-(-n_tr // DT_BATCH) * DT_BATCH:][:n_te]
    boxes = list(computed[0]) + list(computed[1])
    check(len(kept) == n, f"{len(raw)} detector results for {n} frames")
    ap = [del_cover_bboxes(filter_detections(b, s, spec.ap_score_thr, spec.ap_min_area),
                           spec.cover_thr) for b, s, _ in kept]
    for a, b in zip(ap, boxes):
        check(np.array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32)[:a.shape[0]]),
              "a frame's boxes do not lead with its appearance boxes")
    n_ap = np.array([a.shape[0] for a in ap])
    counts = np.array([b.shape[0] for b in boxes])
    raw_n = np.array([len(s) for _, s, _ in kept])
    over = np.array([int((s > spec.ap_score_thr).sum()) for _, s, _ in kept])
    print(f"detector: (c) precompute-boxes --splits train with the checkpoint: {n_tr} "
          f"frames in {wall:.2f} s, {n_tr / wall:.1f} frames/s; detect_many {pre_s:.2f} s "
          f"({1e3 * pre_s / n_tr:.2f} ms a frame at batch {DT_BATCH}), motion stage "
          f"{pre_clock:.2f} s; peak device memory (the phase) {peak / 2**20:.1f} MiB; over "
          f"both splits: raw detections a frame mean {raw_n.mean():.1f}, over ap_score_thr "
          f"{spec.ap_score_thr} {over.mean():.2f}; appearance boxes after the filters a "
          f"frame mean {n_ap.mean():.2f} max {n_ap.max()}, frames with one or more "
          f"{(n_ap > 0).sum()} of {n}; boxes a frame with the motion boxes mean "
          f"{counts.mean():.2f}", flush=True)
    check((n_ap > 0).sum() > 0, "no frame has an appearance box")

    block = model.blocks[(0, 0, 0)]
    per_epoch = -(-block.raw_scores.size // mc.batch_size)
    first, last = block.losses[:per_epoch].mean(), block.losses[-per_epoch:].mean()
    check(np.isfinite(block.losses).all() and last < first, f"losses {first} -> {last}")
    fs = res["frame_scores"]
    check(fs.shape == (n_te,) and np.isfinite(fs).all() and np.isfinite(res["auroc"]),
          f"test: {fs.shape} frame scores, AUROC {res['auroc']}")
    print(f"detector: (d) run_train {block.raw_scores.size} cubes, {block.losses.size} "
          f"steps, {train_s:.2f} s (loss {first:.4f} -> {last:.4f}); run_test {test_s:.2f} "
          f"s with load_split detecting the {n_te} test frames ({det_s[0] - pre_s:.2f} s "
          f"of detect_many), AUROC {res['auroc']:.6f}", flush=True)

    # (e) where a frame's time goes, at the precompute batch
    det = runner._mmdet_detector(str(DT_CKPT), str(dev))
    batch = np.stack([np.asarray(te_frames[r]) for r in range(DT_BATCH)])
    det.detect_many(batch)  # warm
    sections, host = {}, []
    for _ in range(DT_TIMED):
        marks = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        det.detect_many(batch, marks=marks)
        wall_ms = (time.perf_counter() - t) * 1e3
        for (_, a), (name, e) in zip(marks, marks[1:]):
            sections[name] = sections.get(name, 0.0) + a.elapsed_time(e) / DT_BATCH / DT_TIMED
        host.append((wall_ms - marks[0][1].elapsed_time(marks[-1][1])) / DT_BATCH)
    print(f"detector: (e) ms a frame at batch {DT_BATCH} (CUDA events, mean of "
          f"{DT_TIMED} batches): " + ", ".join(f"{k} {v:.3f}" for k, v in sections.items())
          + f"; the rest of detect_many's wall (downloads, the host's part) "
          f"{np.mean(host):.3f}", flush=True)
    check(len(sections) == 5 and all(v > 0 for v in sections.values()),
          f"sections {sections}")
    profile_calls(f"detector: (e) detect_many of {DT_BATCH} frames",
                  lambda: det.detect_many(batch))
    DT_CKPT.unlink()


def moving_frames(seed: int, ticks: int, cams: int, hw, objects: int) -> np.ndarray:
    """(ticks, cams, H, W, 3) uint8 BGR: a seeded noise texture with
    `objects` rectangles a camera (sides 24-120 px) moving 1-6 px a tick."""
    rng = np.random.default_rng(seed)
    H, W = hw
    out = np.repeat(rng.integers(0, 256, (1, cams, H, W, 3), dtype=np.uint8), ticks, 0)
    for c in range(cams):
        wh = rng.integers(24, 121, (objects, 2))
        xy0 = rng.uniform(0, 1, (objects, 2)) * (W, H)
        vel = rng.uniform(1, 6, (objects, 2)) * rng.choice((-1, 1), (objects, 2))
        colour = rng.integers(0, 256, (objects, 3), dtype=np.uint8)
        for t in range(ticks):
            for k, (x, y) in enumerate(((xy0 + vel * t) % (W, H)).astype(int)):
                out[t, c, y:y + wh[k, 1], x:x + wh[k, 0]] = colour[k]
    return out


def nms_scan_bytes(valid, keep) -> int:
    """Bytes the scan reads and writes for rows of flags `valid` (R, K) and
    their result `keep`: each row's valid flags read and keep flags
    written, and for each kept candidate i of a row whose last valid
    candidate is n - 1 its mask row over[i, i+1:n]."""
    R, K = keep.shape
    pos = torch.arange(K, device=keep.device)
    n = torch.where(valid, pos + 1, 0).amax(-1)  # one past the last valid
    rows = torch.where(keep, (n[:, None] - pos - 1).clamp_min(0), 0)
    return int(2 * R * K + rows.sum())


def detect_fleet_phase() -> dict:
    """DetectingFleetScorer.push_tick on the card at the benchmark cell's
    shape, and the greedy-NMS scan (csrc/nms_scan.cu) on the masks that
    route's own tick built (module docstring, phase 15). Returns the
    {"kernels"} entry of nms_scan."""
    C, hw = DF_CAMERAS, FG_HW
    frames = moving_frames(SEED + 31, DF_TICKS, C, hw, DF_OBJECTS)
    t0 = time.perf_counter()
    sd, made = calibrated_cascade_state(frames[0], SEED + 30)
    det = mdet.MMDetCascadeDetector(load_mmdet_state(mdet.CascadeRCNN(DT_DEPTH), sd),
                                    device="cuda")
    model = make_model(SERVE_MODEL["nf"], SERVE_MODEL["patch"], SERVE_MODEL["seed"],
                       dataset_name="ShanghaiTech", use_flow=False)
    spec = model.cfg.dataset
    scorer = DetectingFleetScorer.from_model(model, n_cameras=C, detector=det,
                                             max_boxes=64, device="cuda")
    scorer.start_video()
    print(f"detect fleet: R{DT_DEPTH} Cascade R-CNN, {made['params']:,} parameters (seed "
          f"{SEED + 30}), person bias {made['shift']:.4f}; {C} cameras at {hw} with "
          f"{DF_OBJECTS} moving rectangles each; set-up {time.perf_counter() - t0:.1f} s",
          flush=True)

    # the route's run, nms_scan's launches counted from just before it; the
    # last tick's scan inputs captured as the route built them
    keep_fn, scans = mdet.greedy_keep, []
    lat, scores, kept = [], [], []

    def capturing(over, valid, **kw):
        if len(lat) == DF_TICKS - 1:
            scans.append((over.clone(), valid.clone()))
        return keep_fn(over, valid, **kw)

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    mdet.greedy_keep = capturing
    try:
        for t in range(DF_TICKS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            scores.append(scorer.push_tick(frames[t]))
            lat.append((time.perf_counter() - t1) * 1e3)
            kept.append(scorer.last_boxes)
    finally:
        mdet.greedy_keep = keep_fn
    launches = dict(kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    check(launches.get("nms_scan", 0) == 2 * DF_TICKS,
          f"nms_scan launches {launches} for {DF_TICKS} ticks (two a forward)")
    check(not launches.get("correlation"), "K1 in the detecting fleet")
    check(len(scans) == 2, f"{len(scans)} scans captured in a tick")
    flat = np.asarray(scores, np.float64)
    check(flat.shape == (DF_TICKS, C) and np.isfinite(flat).all(), f"scores {flat}")
    n_box = np.array([[len(b) for b in k] for k in kept])
    check(scorer.frames_detected == DF_TICKS * C and scorer.boxes_kept == n_box.sum(),
          f"counters {scorer.frames_detected}, {scorer.boxes_kept}")
    # the route's kept boxes: detect_many's detections filtered and suppressed
    for c, (b, sc, _) in enumerate(det.detect_many(frames[-1])):
        want = del_cover_bboxes(filter_detections(b, sc, spec.ap_score_thr,
                                                  spec.ap_min_area), spec.cover_thr)[:64]
        check(np.array_equal(kept[-1][c], want), f"camera {c}'s kept boxes")
    print(f"detect fleet: {DF_TICKS} ticks, tick ms (synchronised) first {lat[0]:.1f}, "
          f"then median {np.median(lat[1:]):.1f}; kept boxes a frame mean "
          f"{n_box.mean():.2f} (min {n_box.min()}, max {n_box.max()}); the last tick's "
          f"kept boxes equal detect_many + filter_detections + del_cover_bboxes; peak "
          f"device memory {peak / 2**30:.2f} GiB; nms_scan launches {launches['nms_scan']}",
          flush=True)

    # the scan on the route's own masks: exact against the CPU's fixed
    # point, timed against the fixed point on the card
    record = None
    for what, (over, valid) in zip(("RPN", "multiclass"), scans):
        R, K = valid.numel() // valid.shape[-1], valid.shape[-1]
        o, v = over.reshape(R, K, K), valid.reshape(R, K)
        got = mdet._nms_scan(o, v)
        t1 = time.perf_counter()
        want = mdet._fixed_point(o.cpu(), v.cpu())
        cpu_s = time.perf_counter() - t1
        check(torch.equal(got.cpu(), want), f"nms_scan on the {what} masks")
        with full_f32():
            ms = cuda_ms(lambda: mdet._nms_scan(o, v), reps=DF_TIMED)
            plain_ms = cuda_ms(lambda: mdet._fixed_point(o, v), reps=2, warm=1)
        nbytes = nms_scan_bytes(v, got)
        bound_ms = 1e3 * nbytes / HBM_BYTES_S
        print(f"kernel nms_scan {what} ({R}, {K}, {K}) from the route's tick: equal to "
              f"the CPU's fixed point ({cpu_s:.2f} s there); {int(v.sum())} valid, "
              f"{int(got.sum())} kept; ms={ms:.6f} plain_ms={plain_ms:.6f} (the fixed "
              f"point on the card) bound_ms={bound_ms:.6f} (bytes: {nbytes:,}, the kept "
              f"candidates' mask rows, flags in and out, at {HBM_BYTES_S / 1e12} TB/s; "
              f"the scan waits a barrier a kept candidate), {ms / bound_ms:.1f}x the bound",
              flush=True)
        if record is None:
            record = {"name": "nms_scan", "route": "cuda",
                      "source": "vec_vad_torch/csrc/nms_scan.cu",
                      "replaces": "vec_vad_tpu/fore/mmdet_detector.py:170",
                      "launches": launches["nms_scan"], "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": "bytes", "max_abs_err": 0.0,
                      "library_ms": None}
    del scorer, det, scans
    torch.cuda.empty_cache()
    print(json.dumps({"kernels": [record]}), flush=True)
    return record


def block_close(got, want) -> bool:
    """|got - want| <= GR_ATOL + GR_REL * max |want| everywhere."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return got.shape == want.shape and bool(
        np.abs(got - want).max() <= GR_ATOL + GR_REL * np.abs(want).max())


def sequential_scores(model, cubes, trainer) -> np.ndarray:
    """score_cubes' sequential branch on a raw-only model: each trained
    block's cubes through BlockTrainer.score_block, fused with its
    statistics; an untrained block's cubes big_number."""
    mc = model.cfg.model
    out = np.zeros(cubes.size)
    for key, idx in pipeline.group_by_block(cubes).items():
        blk = model.blocks.get(key)
        if blk is None:
            out[idx] = score_mod.BIG_NUMBER
            continue
        raw_sc, _ = trainer.score_block(blk, cubes.raw[idx])
        out[idx] = score_mod.fuse_scores(raw_sc, None, blk.raw_stats, None, mc.w_raw,
                                         mc.w_of)
    return out


@contextlib.contextmanager
def counting_grid_fits():
    """A list that gets the block count of every GridTrainer.fit_blocks
    call made inside the block (train_model's grid route)."""
    calls, fit_blocks = [], grid_trainer.GridTrainer.fit_blocks

    def counted(self, block_data, *a, **k):
        calls.append(len(block_data))
        return fit_blocks(self, block_data, *a, **k)

    grid_trainer.GridTrainer.fit_blocks = counted
    try:
        yield calls
    finally:
        grid_trainer.GridTrainer.fit_blocks = fit_blocks


def grid_steady_steps(label, gt, block_data):
    """GR_STEADY synchronised steps of a grid fit over block_data (every
    block in every step; the first step left out of the statistics), then
    a profile of 5. Returns the step times (ms) and the profile."""
    fit = gt.prepare(block_data, gt.solo.init_state(SEED), SEED)
    check(len(fit.active) >= GR_STEADY and min(fit.active) == len(block_data),
          f"{len(fit.active)} grid steps, active {fit.active}")
    ms = [timed(lambda: fit.step(s))[1] * 1e3 for s in range(GR_STEADY)]
    print(f"{label}: ms per grid step ({gt.cfg.compute_dtype}, {len(block_data)} "
          f"blocks x batch {gt.cfg.batch_size}, synchronised, steps 2-{GR_STEADY}) "
          f"{step_stats(ms[1:])}", flush=True)
    prof = profile_calls(f"{label}: 5 grid steps ({gt.cfg.compute_dtype})",
                         lambda: [fit.step(s) for s in range(5)])
    return ms, prof


def grid_phase() -> None:
    """The model grid on the card: run_train through the folded grid,
    against the sequential loop, flow and bf16, the times, fit_block_budget,
    export-torch / import-torch and the demo (module docstring, phase 12)."""
    shutil.rmtree(GR_BASE, ignore_errors=True)
    cfg, mc = GR_CFG, GR_CFG.model
    config.register_dataset(dataclasses.replace(config.DATASETS["avenue"], file_ext=".npy",
                                                frame_h=GR_HW[0], frame_w=GR_HW[1]))
    dev = runner.resolve_device("cuda")
    base = str(GR_BASE)
    t0 = time.perf_counter()
    labels = write_train_test_tree(GR_BASE / cfg.raw_dataset_dir / cfg.dataset_name,
                                   SEED + 12, GR_LENGTHS, GR_HW, avenue=True)
    print(f"grid: wrote {sum(GR_LENGTHS['Train'])} train and {sum(GR_LENGTHS['Test'])} "
          f"test frames at {GR_HW} in {time.perf_counter() - t0:.1f} s (set-up)",
          flush=True)
    kernels.reset_launch_counts()

    # (a) run_train on the 2x2 grid: the folded route, then the sequential
    # loop on the same cubes
    torch.cuda.reset_peak_memory_stats()
    with counting_grid_fits() as fits:
        (model, path), wall = timed(lambda: runner.run_train(cfg, base, seed=SEED,
                                                              device=dev))
    peak_run = torch.cuda.max_memory_allocated()
    keys = sorted(model.blocks)
    data = runner.load_split(cfg, base, "train")
    cubes = runner._extract_cached(cfg, base, "train", data, cfg.fore.train_block_mode, dev)
    rows = pipeline.group_by_block(cubes)
    counts = {k: int(v.size) for k, v in rows.items()}
    steps = {k: mc.epochs * -(-counts[k] // mc.batch_size) for k in keys}
    print(f"grid: run_train {cubes.size} train cubes in cells {counts}, {len(keys)} blocks "
          f"trained through GridTrainer.fit_blocks (calls {fits}), grid steps "
          f"{max(steps.values())} against {sum(steps.values())} sequential ones, "
          f"{wall:.2f} s wall (extraction, cube cache and model save included); peak "
          f"device memory {peak_run / 2**20:.1f} MiB", flush=True)
    check(len(keys) >= 3 and fits == [len(keys)], f"blocks {keys}, grid fits {fits}")
    # each route twice: the first sets up cuDNN for its shapes, the second
    # is timed; the pairs give the reruns' spread
    seq = pipeline.train_model(cfg, cubes, seed=SEED, parallel_blocks=False, device=dev)
    torch.cuda.reset_peak_memory_stats()
    seq2, seq_wall = timed(lambda: pipeline.train_model(cfg, cubes, seed=SEED,
                                                        parallel_blocks=False, device=dev))
    peak_seq = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with counting_grid_fits() as fits:
        grid2, grid_wall = timed(lambda: pipeline.train_model(cfg, cubes, seed=SEED,
                                                              device=dev))
    peak_grid = torch.cuda.max_memory_allocated()
    check(fits == [len(keys)], f"train_model's route: grid fits {fits}")
    rerun = [max(rel_diff(a.blocks[k].raw_scores, b.blocks[k].raw_scores) for k in keys)
             for a, b in ((model, grid2), (seq, seq2))]
    worst = {}
    for k in keys:
        a, b = model.blocks[k], seq.blocks[k]
        check(a.losses.shape == b.losses.shape == (steps[k],), f"{k} losses")
        d = np.abs(a.raw_scores.astype(np.float64) - b.raw_scores)
        worst[k] = (rel_diff(a.raw_scores, b.raw_scores),
                    float(abs(a.losses[0] - b.losses[0]) / abs(b.losses[0])))
        check(block_close(a.raw_scores, b.raw_scores),
              f"{k} grid vs sequential training scores, max |diff| {d.max()}")
        check(worst[k][1] <= LOSS_REL_TOL, f"{k} first losses {a.losses[0]} {b.losses[0]}")
    print(f"grid: train_model (warm) {grid_wall:.3f} s through the grid (peak "
          f"{peak_grid / 2**20:.1f} MiB), {seq_wall:.3f} s block after block (peak "
          f"{peak_seq / 2**20:.1f} MiB), "
          f"{seq_wall / grid_wall:.2f}x; per block (training scores max |diff| / max "
          f"|score|, first-loss relative diff) grid vs sequential {worst} (bounds "
          f"{GR_REL} + atol {GR_ATOL}, {LOSS_REL_TOL}); reruns: the grid "
          f"{rerun[0]:.3e}, the sequential loop {rerun[1]:.3e}", flush=True)

    # the first grid step's losses on the CPU from the same init and batches
    chunk = sorted([(k, cubes.raw[rows[k]], None) for k in keys],
                   key=lambda b: -b[1].shape[0])
    cpu_gt = grid_trainer.GridTrainer(mc, cfg.fore.patch_size, "cpu")
    t0 = time.perf_counter()
    fit = cpu_gt.prepare(chunk, cpu_gt.solo.init_state(SEED), SEED)
    g, x, x_of, w, bw = fit.batch(0)
    with torch.no_grad():
        cpu_first = cpu_gt.block_losses(fit.net(x, x_of, True, bw), w)[:, 0].numpy()
    cpu_s = time.perf_counter() - t0
    card_first = np.array([model.blocks[k].losses[0] for k, _, _ in chunk])
    rel = float(np.max(np.abs(card_first - cpu_first) / np.abs(cpu_first)))
    print(f"grid: first grid step's losses card {card_first.tolist()} cpu "
          f"{cpu_first.tolist()} ({cpu_s:.1f} s there), max rel diff {rel:.3e} (bound "
          f"{LOSS_REL_TOL})", flush=True)
    check(g == len(keys) and rel <= LOSS_REL_TOL, f"card vs CPU first grid losses {rel}")
    del cpu_gt, fit, x

    # a block whose schedule ends first keeps its state bit for bit
    big, small = chunk[0][0], chunk[-1][0]
    gt = grid_trainer.GridTrainer(mc, cfg.fore.patch_size, dev)
    with full_f32():
        fit = gt.prepare([chunk[0], (small, chunk[-1][1][: mc.batch_size], None)],
                         gt.solo.init_state(SEED), SEED)
        for s in range(len(fit.active)):
            fit.step(s)
            if s == fit.steps[1] - 1:
                frozen = (gt._download(fit.net, 2)[1], fit.adam.block_state(1))
        after = (gt._download(fit.net, 2)[1], fit.adam.block_state(1))
    same = (all(torch.equal(frozen[0][k], after[0][k]) for k in after[0])
            and frozen[1]["step"] == after[1]["step"] == fit.steps[1]
            and all(torch.equal(frozen[1][m][n], after[1][m][n])
                    for m in ("exp_avg", "exp_avg_sq") for n in after[1][m]))
    print(f"grid: block {small} ({mc.batch_size} cubes, {fit.steps[1]} steps) beside "
          f"{big} ({fit.steps[0]} steps): weights, running statistics, Adam moments "
          f"and step after its last step and after the grid's last bit for bit: {same}",
          flush=True)
    check(same, "a finished block's state moved")
    del fit

    # run_test (score_cubes' grid branch) against the sequential scoring
    res, test_wall = timed(lambda: runner.run_test(cfg, base, model=model, device=dev))
    test_data = runner.load_split(cfg, base, "test")
    test_cubes = runner._extract_cached(cfg, base, "test", test_data,
                                        cfg.fore.test_block_mode, dev)
    n_frames = test_data.index.total_frames
    card_t = BlockTrainer(mc, cfg.fore.patch_size, dev)
    pipeline.score_cubes(model, test_cubes, trainer=card_t)  # warm
    grid_sc, grid_s = timed(lambda: pipeline.score_cubes(model, test_cubes, trainer=card_t))
    seq_sc, seq_s = timed(lambda: sequential_scores(model, test_cubes, card_t))
    frames = pipeline.frame_level_scores(grid_sc, test_cubes, n_frames)
    rel = rel_diff(grid_sc, seq_sc)
    part = VadModel(cfg=cfg, blocks={k: v for k, v in model.blocks.items() if k != small})
    a, b = (pipeline.score_cubes(part, test_cubes, trainer=card_t),
            sequential_scores(part, test_cubes, card_t))
    untrained = b == score_mod.BIG_NUMBER
    rel_part = rel_diff(a[~untrained], b[~untrained])
    seq_frames = pipeline.frame_level_scores(
        pipeline.score_cubes(seq, test_cubes, trainer=card_t), test_cubes, n_frames)
    (GR_BASE / "results_seq").mkdir()
    seq_auroc = runner.evaluate_frame_scores(cfg, str(GR_BASE / "results_seq"), seq_frames,
                                             labels)["auroc"]
    inf, inf_s = timed(lambda: infer.infer_frame_scores_grid(model, test_cubes, n_frames,
                                                             trainer=card_t))
    rel_inf = rel_diff(inf, frames)
    print(f"grid: run_test {test_wall:.2f} s, AUROC {res['auroc']:.6f} (the sequential "
          f"model's {seq_auroc:.6f}, bound {GR_AUROC_TOL}); {test_cubes.size} test cubes, "
          f"score_cubes grid {n_frames / grid_s:.1f} frames/s against block after block "
          f"{n_frames / seq_s:.1f}, max |diff| / max |score| {rel:.3e}; without block "
          f"{small}: {int(untrained.sum())} big_number rows, {rel_part:.3e}; "
          f"infer_frame_scores_grid {n_frames / inf_s:.1f} frames/s, against "
          f"frame_level_scores(score_cubes) {rel_inf:.3e} (bound {GR_SCORE_REL})",
          flush=True)
    check(np.array_equal(res["frame_scores"], frames) or
          rel_diff(res["frame_scores"], frames) <= RERUN_REL_TOL, "run_test's frame scores")
    check(rel <= GR_SCORE_REL and rel_part <= GR_SCORE_REL and rel_inf <= GR_SCORE_REL,
          f"grid scoring {rel} {rel_part} {rel_inf}")
    check(untrained.any() and np.array_equal(a == score_mod.BIG_NUMBER, untrained),
          "untrained block's rows")
    check(abs(res["auroc"] - seq_auroc) <= GR_AUROC_TOL, f"AUROCs {res['auroc']} {seq_auroc}")

    # (b) 5raw1of on seeded flow maps: grid against sequential
    cfg_of = cfg.replace(model=dataclasses.replace(mc, use_flow=True))
    gray = np.asarray(data.frames).astype(np.float32).mean(-1)
    d = np.diff(gray, axis=0, append=gray[-1:])
    flow = np.stack([d, -d], axis=-1) / 25.0
    of_cubes = pipeline.extract_cube_set(cfg_of, cfg.dataset, data.index, data.frames,
                                         data.boxes, flow_frames=flow, device=dev)
    del gray, d, flow
    with counting_grid_fits() as fits:
        of_grid, of_wall = timed(lambda: pipeline.train_model(cfg_of, of_cubes, seed=SEED,
                                                              device=dev))
    of_seq, of_seq_wall = timed(lambda: pipeline.train_model(
        cfg_of, of_cubes, seed=SEED, parallel_blocks=False, device=dev))
    of_keys = sorted(of_grid.blocks)
    check(fits == [len(of_keys)] and of_keys == sorted(of_seq.blocks), f"flow fits {fits}")
    rels = []
    for k in of_keys:
        a, b = of_grid.blocks[k], of_seq.blocks[k]
        for got, want in ((a.raw_scores, b.raw_scores), (a.of_scores, b.of_scores)):
            check(block_close(got, want),
                  f"{k} flow grid vs sequential, max |diff| {np.abs(got - want).max()}")
            rels.append(rel_diff(got, want))
    print(f"grid: (b) 5raw1of, {of_cubes.size} cubes: train_model grid {of_wall:.3f} s, "
          f"sequential {of_seq_wall:.3f} s ({of_seq_wall / of_wall:.2f}x); raw and flow "
          f"training scores max |diff| / max |score| {max(rels):.3e} (bound {GR_REL} + "
          f"atol {GR_ATOL})", flush=True)
    del of_cubes, of_grid, of_seq

    # (c) bf16 grid against the f32 grid
    cfg_bf = cfg.replace(model=dataclasses.replace(mc, compute_dtype="bfloat16"))
    with counting_grid_fits() as fits:
        bf, bf_wall = timed(lambda: pipeline.train_model(cfg_bf, cubes, seed=SEED,
                                                         device=dev))
    stats = {}
    for k in keys:
        a, b = model.blocks[k].raw_scores, bf.blocks[k].raw_scores
        stats[k] = (float(np.corrcoef(a, b)[0, 1]), float(b.mean() / a.mean()))
        check(stats[k][0] > BF16_CORR and abs(stats[k][1] - 1.0) < BF16_MEAN_RATIO,
              f"{k} bf16 vs f32 {stats[k]}")
    print(f"grid: (c) bf16 train_model through the grid {bf_wall:.3f} s (fits {fits}); "
          f"training scores against the f32 grid's (correlation, mean ratio) {stats} "
          f"(bounds > {BF16_CORR}, 1 +- {BF16_MEAN_RATIO})", flush=True)
    check(fits == [len(keys)], f"bf16 fits {fits}")

    # (d) ms per grid step against the blocks' sequential sum, f32 and bf16
    raw4 = cubes.raw[: 4 * mc.batch_size]
    four = [((0, i // 2, i % 2), raw4, None) for i in range(4)]
    for c in (cfg, cfg_bf):
        label = f"grid: (d) {c.model.compute_dtype}"
        gt = grid_trainer.GridTrainer(c.model, cfg.fore.patch_size, dev)
        torch.cuda.reset_peak_memory_stats()
        with full_f32():
            grid_ms, prof = grid_steady_steps(label, gt, four)
        peak = torch.cuda.max_memory_allocated()
        busy = device_busy_us(prof)
        tr = kernel_us(prof, "genericTranspose")
        solo_ms, _ = steady_steps(f"{label} one block",
                                  BlockTrainer(c.model, cfg.fore.patch_size, dev),
                                  cubes, seq_wall * 1e3 / sum(steps.values()))
        g_med, s_med = float(np.median(grid_ms[1:])), float(np.median(solo_ms[1:]))
        print(f"{label}: grid step of 4 blocks {g_med:.3f} ms against 4 x one block's "
              f"{s_med:.3f} = {4 * s_med:.3f} ms: {4 * s_med / g_med:.2f}x; the 5 grid "
              f"steps' genericTranspose {tr / 1e3:.3f} ms, {100 * tr / max(busy, 1e-9):.1f} "
              f"% of device busy {busy / 1e3:.3f} ms; peak device memory {peak / 2**20:.1f} "
              f"MiB, GridTrainer.block_bytes estimate of 4 blocks "
              f"{4 * gt.block_bytes(c.model.batch_size, True) / 2**20:.1f} MiB, "
              f"max_blocks {gt.max_blocks(c.model.batch_size, True)}", flush=True)

    # (e) fit_block_budget on the largest block
    budget = card_t.fit_block_budget(chunk[0][1], None, seed=SEED)
    print(f"grid: (e) fit_block_budget of block {big} ({counts[big]} cubes, warm run): "
          + ", ".join(f"{k} {v:.4f}" for k, v in budget.items()), flush=True)
    check(abs(budget["total_s"] - sum(v for k, v in budget.items() if k != "total_s"))
          < 1e-9 and len(budget) == 7, f"budget {budget}")

    # (f) export-torch, then import-torch, through cli.main
    ini = GR_BASE / "config.cfg"
    ini.write_text(f"[shared_parameters]\ndataset_name = avenue\n[avenue]\npatch_size = "
                   f"{cfg.fore.patch_size}\nh_block = 2\nw_block = 2\n[SelfComplete]\nnf = "
                   f"{mc.nf}\nepochs = {mc.epochs}\nbatch_size = {mc.batch_size}\n"
                   "context_of_num = 0\nuseFlow = False\n")
    check(config.load_ini_config(str(ini)) == cfg, "the INI's config")
    out, dst = GR_BASE / "reference", GR_BASE / "imported"
    serve_cli(["export-torch", "--config", str(ini), "--base", base, "--out", str(out)])
    serve_cli(["import-torch", "--config", str(ini), "--base", str(dst), "--model-dir",
               str(out)])
    imported = load_vad_model(runner.model_path(cfg, str(dst)))
    same = (sorted(imported.blocks) == keys and all(
        torch.equal(imported.blocks[k].state_dict[n], v.cpu())
        for k in keys for n, v in model.blocks[k].state_dict.items())
        and all(np.array_equal(imported.blocks[k].raw_scores, model.blocks[k].raw_scores)
                and imported.blocks[k].of_scores is None for k in keys))
    res_imp = runner.run_test(cfg, base, model=imported, device=dev)
    rel = rel_diff(res_imp["frame_scores"], res["frame_scores"])
    print(f"grid: (f) export-torch -> {sorted(p.name for p in out.iterdir())}, "
          f"import-torch -> weights and training scores bit for bit: {same}; run_test on "
          f"the imported model AUROC {res_imp['auroc']:.6f}, frame scores max |diff| / "
          f"max |score| {rel:.3e} from the original's (bound {RERUN_REL_TOL})", flush=True)
    check(same and rel <= RERUN_REL_TOL, "export/import round trip")

    # (g) the demo as its own process on the card
    r, demo_s = timed(lambda: subprocess.run(
        [sys.executable, "-m", "vec_vad_torch", "demo"], cwd=Path(__file__).resolve().parent,
        capture_output=True, text=True, timeout=600))
    print(r.stdout[-1500:], end="")
    m = re.search(r"frame-level AUROC: (\S+)", r.stdout)
    print(f"grid: (g) python -m vec_vad_torch demo: exit {r.returncode} in {demo_s:.1f} s, "
          f"AUROC {m.group(1) if m else None}", flush=True)
    check(r.returncode == 0 and m is not None and np.isfinite(float(m.group(1))),
          f"demo: {r.stderr[-2000:]}")

    launches = dict(kernels.launch_counts)
    print(f"grid: K1/K2 launches over the phase {launches}")
    check(not any(launches.values()), f"K1/K2 launched in the grid phase: {launches}")
    shutil.rmtree(GR_BASE, ignore_errors=True)


def write_tooling_tree(root: Path) -> np.ndarray:
    """avenue's layout (training/frames/NN, testing/frames/NN) of .npy
    frames cycled from the committed fixture jpgs' decoded arrays
    (decoded.npz, cv2's decode), with test GT marking the frames cycled
    from the anomalous fixture (its random-texture square) as
    ground_truth_demo/testing_label_mask/<v>_label.mat. Returns every
    frame written, train then test, in the runner's order."""
    import scipy.io

    stored = np.load(TL_FIXTURES / "decoded.npz")
    cycle = [stored[k] for k in TL_JPGS]
    written = []
    for split, lengths in TL_LENGTHS.items():
        for v, n in enumerate(lengths):
            d = root / f"{split.lower()}ing" / "frames" / f"{v + 1:02d}"
            d.mkdir(parents=True)
            src = [(v + t) % len(cycle) for t in range(n)]
            for t, s in enumerate(src):
                np.save(d / f"{t:04d}.npy", cycle[s])
                written.append(cycle[s])
            if split == "Test":
                gt = root / "ground_truth_demo" / "testing_label_mask"
                gt.mkdir(parents=True, exist_ok=True)
                vol = np.empty((1, n), dtype=object)
                vol[0, :] = [np.full(TS_HW, int(s == TL_ANOMALOUS), np.uint8) for s in src]
                scipy.io.savemat(gt / f"{v + 1}_label.mat", {"volLabel": vol},
                                 do_compression=True)
    return np.stack(written)


def peak_share(tps: float, dtype: str) -> str:
    peak = PEAK_FLOPS[getattr(torch, dtype)] / 1e12
    return f"{tps:.1f} TFLOP/s ({100 * tps / peak:.1f} % of {peak:.0f})"


def random_bn_stats_(net, seed: int):
    """Seeded BatchNorm affine maps and running statistics for a with_bn
    net (the JAX package's init leaves them at 1, 0, 0, 1)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for _, m in sorted(net.named_modules(), key=lambda kv: kv[0]):
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                for t, v in ((m.weight, rng.uniform(0.5, 1.5, n)),
                             (m.bias, rng.normal(0, 0.1, n)),
                             (m.running_mean, rng.normal(0, 0.5, n)),
                             (m.running_var, rng.uniform(0.5, 2.0, n))):
                    t.copy_(torch.from_numpy(v.astype(np.float32)))
    return net


def tooling_phase() -> dict:
    """The decoder's state on this machine, a real avenue configuration
    through the CLI, `visualize`, the layer profiler, the with_bn nets and
    GradTaps (module docstring, phase 13). Returns K1's and K2's launches
    and K1's largest error against its plain version."""
    from vec_vad_torch.models.flownet import FlowNet2, load_flownet_checkpoint
    from vec_vad_torch.models.flownet.convert import reference_key
    from vec_vad_torch.models.flownet.nets import FlowNetC, init_flownet_
    from vec_vad_torch.runtime import layer_profile as lp
    from vec_vad_torch.runtime import native_loader as nl
    from vec_vad_torch.utils.flowviz import flow_to_image
    from vec_vad_torch.utils.gradtap import GradTaps
    from vec_vad_torch.utils.png import encode_png
    from vec_vad_torch.utils.visualize import score_mask_overlay, visualize_score

    shutil.rmtree(TL_BASE, ignore_errors=True)
    launches = {"correlation": 0, "correlation_bwd": 0}
    fwd_err = 0.0

    # (a) the native decoder: this machine has no libjpeg/libpng/libtiff
    # headers, so its build must fail and make_frame_stack must refuse the
    # fixture jpgs rather than fall back
    jpg_paths = [str(TL_FIXTURES / k) for k in TL_JPGS]
    try:
        nl.make_frame_stack(VideoIndex(["fixtures"], [len(jpg_paths)], jpg_paths))
    except nl.NativeBuildError as e:
        # a missing header (the build), or a missing library (a library
        # built elsewhere, which does not load here)
        missing = sorted(set(re.findall(r"(\w+\.h): No such file|(lib\w+\.so[.\d]*): "
                                        r"cannot open", str(e))))
        print(f"tooling: (a) the native decoder does not build or load here (missing "
              f"{[m for pair in missing for m in pair if m]}); make_frame_stack raised "
              "NativeBuildError for the fixture .jpg frames, no fallback. Decode "
              "frames/s: not measured on this machine", flush=True)
        check(bool(missing), f"no missing header or library in: {str(e)[-500:]}")
    else:
        check(False, "the native decoder built: phase 13 (a) expects this machine to "
                     "lack the image headers, so it must now check decoding instead")

    # (b) avenue's layout at 360x640 with .npy frames (no file_ext=.jpg
    # reader here): calc-flow, train, test --save-masks through cli.main
    config.register_dataset(dataclasses.replace(config.DATASETS["avenue"], file_ext=".npy",
                                                frame_h=TS_HW[0], frame_w=TS_HW[1]))
    root = TL_BASE / "raw_datasets" / "avenue"
    t0 = time.perf_counter()
    written = write_tooling_tree(root)
    n_tr, n_te = sum(TL_LENGTHS["Train"]), sum(TL_LENGTHS["Test"])
    print(f"tooling: (b) wrote {n_tr} + {n_te} frames at {TS_HW} cycled from "
          f"{TL_JPGS} in {time.perf_counter() - t0:.1f} s (set-up)", flush=True)
    mc = TL_CFG.model
    ini = TL_BASE / "config.cfg"
    ini.write_text(
        f"[shared_parameters]\ndataset_name = avenue\n[avenue]\npatch_size = "
        f"{TL_CFG.fore.patch_size}\n[SelfComplete]\nnf = {mc.nf}\ncontext_frame_num = "
        f"{mc.context_frame_num}\ncontext_of_num = {mc.context_of_num}\nuseFlow = "
        f"{mc.use_flow}\nepochs = {mc.epochs}\nbatch_size = {mc.batch_size}\n")
    common = ["--config", str(ini), "--base", str(TL_BASE)]
    stacks = []
    make = runner.make_frame_stack
    runner.make_frame_stack = lambda index: stacks.append(make(index)) or stacks[-1]
    try:
        kernels.reset_launch_counts()
        _, calc_wall = timed(lambda: serve_cli(["calc-flow"] + common))
        calc_k1 = kernels.launch_counts["correlation"]
        calc_stacks = list(stacks)
        _, train_wall = timed(lambda: serve_cli(["train"] + common))
        test_out, test_wall = timed(lambda: serve_cli(["test", "--save-masks"] + common))
        check(kernels.launch_counts["correlation"] == calc_k1,
              f"K1 launched in train/test: {dict(kernels.launch_counts)}")
    finally:
        runner.make_frame_stack = make
    launches["correlation"] += calc_k1
    batches = flow_batches([n_tr, n_te], 4)
    print(f"tooling: (b) calc-flow {n_tr + n_te} maps in {calc_wall:.2f} s, "
          f"{(n_tr + n_te) / calc_wall:.1f} maps/s (f32, batches of 4, FlowNet2 set-up "
          f"included), K1 launches {calc_k1} for {batches} batches; train (1 epoch) "
          f"{train_wall:.2f} s; test --save-masks {test_wall:.2f} s", flush=True)
    check(calc_k1 == batches, f"K1 launches {calc_k1} for {batches} calc-flow batches")
    check(all(isinstance(s, readers.LazyFrameStack) for s in stacks) and len(stacks) >= 4,
          f"frame stacks {[type(s).__name__ for s in stacks]}")
    got = np.concatenate([np.asarray(s) for s in calc_stacks])
    check(got.shape == written.shape and np.array_equal(got, written),
          "calc-flow's frames against the fixture's arrays")
    masks_path = TL_BASE / "results" / "avenue" / "score_masks.npy"
    masks = np.load(masks_path)
    check(masks.shape == (n_te,) + TS_HW, f"score masks {masks.shape}")
    auroc = re.search(r"frame-level AUROC: ([0-9.]+)", test_out)
    check(auroc is not None and np.isfinite(float(auroc.group(1))), "test's AUROC")
    print(f"tooling: (b) {len(stacks)} frame stacks, all LazyFrameStack over .npy, "
          f"calc-flow's frames equal to the fixture's arrays; score masks "
          f"{masks.shape}, AUROC {auroc.group(1)}", flush=True)

    # (c) visualize through cli.main: score masks and overlays on the test
    # split (--config), flow wheels of the calc-flow tree
    out_dir = TL_BASE / "visualize"
    of_root = TL_BASE / "optical_flow" / "avenue"
    _, vis_wall = timed(lambda: serve_cli(
        ["visualize", "--masks", str(masks_path), "--flow-dir", str(of_root),
         "--limit", str(TL_LIMIT), "--out", str(out_dir)] + common))
    pngs = sorted(out_dir.glob("*.png"))
    check(len(pngs) == 3 * TL_LIMIT, f"{len(pngs)} PNGs for {TL_LIMIT} masks and maps")
    test_frames = written[n_tr:]
    flows = sorted(of_root.rglob("*.npy"))
    for i in (0, TL_LIMIT // 2, TL_LIMIT - 1):
        want = {f"score_{i:06d}.png": visualize_score(masks[i]),
                f"overlay_{i:06d}.png": score_mask_overlay(test_frames[i], masks[i])}
        rel = flows[i].relative_to(of_root)
        want["flow_" + str(rel).replace("/", "_") + ".png"] = \
            flow_to_image(np.load(flows[i]))[:, :, ::-1]
        for name, img in want.items():
            check((out_dir / name).read_bytes() == encode_png(img),
                  f"{name} differs from its rendering")
    print(f"tooling: (c) visualize wrote {len(pngs)} PNGs in {vis_wall:.2f} s; 9 of them "
          "byte for byte the PNG encoding of visualize_score, score_mask_overlay and "
          "flow_to_image (no PNG decoder here: libpng is missing)", flush=True)

    # (d) the layer profiler (CUDA events, windows of >= MIN_WALL_S)
    t0 = time.perf_counter()
    table = lp.profile_unet_convs(batch=512)
    print(f"tooling: (d) UNet 3x3 convolutions at batch 512 (NCHW, f32 with TF32 off):")
    for name, row in table.items():
        print("  " + name.ljust(8) + "  ".join(
            f"{d} {ms:.4f} ms {peak_share(tps, d)}" for d, (ms, tps) in row.items()))
    for dt in (torch.float32, torch.bfloat16):
        res = lp.profile_ensemble_formulations(batch=128, members=4, H=32, C=32, dtype=dt)
        name = lp._dtype_name(dt)
        print(f"tooling: (d) ensemble layouts at (128, E=4, 32, 32) {name}: " + "; ".join(
            f"{k} {ms:.4f} ms {peak_share(tps, name)}" for k, (ms, tps) in res.items())
            + f"; grouped / vmap {res['grouped'][0] / res['vmap'][0]:.3f}")
    outs = lp.ensemble_formulation_outputs(batch=128, members=4, H=32, C=32, device="cuda")
    ref = outs["vmap"]
    errs = {k: float((v - ref).abs().max() / ref.abs().max()) for k, v in outs.items()
            if k != "sharedw_batch"}
    errs["sharedw_batch member 0"] = float((outs["sharedw_batch"][0] - ref[0]).abs().max()
                                           / ref.abs().max())
    print(f"tooling: (d) layouts against vmap, f32, max |diff| / max |out|: {errs}")
    check(max(errs.values()) <= 1e-5, f"ensemble layouts disagree: {errs}")
    del outs, ref
    net_cpu = make_completion_net(CompletionConfig(nf=32, context_of_num=0, use_flow=False),
                                  device="cpu")
    flops = lp.completion_fwd_flops(net_cpu)
    flops_valid = lp.completion_fwd_flops(net_cpu, padding_taps=False)
    print(f"tooling: (d) one cube's forward: {flops:.4e} FLOPs counted from the port's "
          f"layers (5 members, padding taps included), {flops_valid:.4e} without the "
          f"padding's taps; vec_vad_tpu's FLAGSHIP_PER_CUBE_FWD_FLOPS "
          f"{lp.FLAGSHIP_PER_CUBE_FWD_FLOPS:.4e}")
    for mode in ("fwd", "fwdbwd"):
        res = lp.profile_completion_program(batches=PROFILE_BATCHES, mode=mode,
                                            iters=PROFILE_ITERS)
        for k, (ms, tps) in res.items():
            print(f"tooling: (d) SelfCompletionNet {k}: {ms:.3f} ms "
                  f"{peak_share(tps, k.rsplit('_', 1)[1])}")
    print(f"tooling: (d) profiler {time.perf_counter() - t0:.1f} s", flush=True)

    # (e) the with_bn nets: FlowNet2 from a reference-keyed checkpoint with
    # seeded BatchNorm statistics, card against CPU; a train-mode FlowNetC
    src = random_bn_stats_(init_flownet_(FlowNet2(with_bn=True, device="cpu"), SEED), SEED + 13)
    ckpt = TL_BASE / "flownet2_bn.pth"
    torch.save({"state_dict": {reference_key(k): v for k, v in src.state_dict().items()
                               if not k.endswith("num_batches_tracked")}}, ckpt)
    del src
    nets = {}
    for dev in ("cpu", "cuda"):
        nets[dev] = FlowNet2(with_bn=True, device=dev).eval()
        report = load_flownet_checkpoint(nets[dev], str(ckpt))
        check(not report["missing"] and any(".1.running_var" in k for k in report["matched"]),
              f"BN checkpoint load: {len(report['matched'])} matched, {report['missing'][:3]}")
    rng = np.random.default_rng(SEED + 14)
    pair = rng.uniform(0, 255, (1, 2) + FLOW_HW + (3,)).astype(np.float32)
    conv3 = []
    hook = nets["cuda"].flownetc.conv3.register_forward_hook(
        lambda m, i, o: conv3.append(o.detach().clone()))
    xp = torch.from_numpy(pair).cuda()
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = nets["cuda"](xp)
        torch.cuda.synchronize()
        forwards = 1
        hook.remove()
        bn_ms = cuda_ms(lambda: nets["cuda"](xp), reps=10)
        forwards += 13
        plain = make_flownet2(SEED, device="cuda")
        plain_ms = cuda_ms(lambda: plain(xp), reps=10)
        forwards += 13
        del plain
        bn_launches = kernels.launch_counts["correlation"]
        want = nets["cpu"](torch.from_numpy(pair))
    launches["correlation"] += bn_launches
    fwd_err = max(fwd_err, check_fwd(conv3[0].contiguous(), conv3[1].contiguous()))
    rel = rel_diff(got.cpu().numpy(), want.numpy())
    print(f"tooling: (e) FlowNet2(with_bn=True) from a reference-keyed checkpoint "
          f"({len(report['matched'])} tensors), {tuple(pair.shape)} card vs CPU max |diff| "
          f"/ max |flow| {rel:.3e} (bound {LIVE_FLOW_TOL}); forward {bn_ms:.3f} ms against "
          f"with_bn=False {plain_ms:.3f} ms (CUDA events, 10 reps); K1 on its conv3 "
          f"features max_abs_err={fwd_err:.3e}", flush=True)
    check(rel <= LIVE_FLOW_TOL, f"with_bn FlowNet2 card vs CPU {rel}")
    check(bn_launches == forwards, f"K1 launches {bn_launches} for {forwards} forwards")
    del nets, got, want, xp
    x = rng.normal(size=(8,) + FLOW_HW + (6,)).astype(np.float32)
    stats = {}
    for dev in ("cpu", "cuda"):
        net = random_bn_stats_(init_flownet_(FlowNetC(True, device=dev), SEED + 15), SEED + 16)
        kernels.reset_launch_counts()
        with torch.no_grad():
            net(torch.from_numpy(x).to(dev), True)
        if dev == "cuda":
            torch.cuda.synchronize()
            check(kernels.launch_counts["correlation"] == 1, "K1 in the train-mode forward")
            launches["correlation"] += 1
        stats[dev] = {k: v.cpu() for k, v in net.state_dict().items() if "running" in k}
        del net
    worst = max(rel_diff(stats["cuda"][k], stats["cpu"][k]) for k in stats["cpu"])
    print(f"tooling: (e) FlowNetC(with_bn=True) train-mode forward at {x.shape}: "
          f"{len(stats['cpu'])} running statistics, card vs CPU worst max |diff| / max "
          f"|value| {worst:.3e} (bound {BN_STATS_TOL})", flush=True)
    check(worst <= BN_STATS_TOL, f"running statistics card vs CPU {worst}")

    # (f) GradTaps: the gradient into FlowNetC's conv6_1 output from a loss
    # on flow6 (downstream of the tap only predict_flow6, a linear map, so
    # no LeakyReLU slope flips between the card and the CPU), the backward
    # reaching the cost volume (K2); the tap against autograd's gradient of
    # the same tensor, bit for bit, and the card's tap against the CPU's
    xs = rng.uniform(-1, 1, (2,) + FLOW_HW + (6,)).astype(np.float32)
    w6 = rng.normal(size=(2, FLOW_HW[0] // 64, FLOW_HW[1] // 64, 2)).astype(np.float32)
    taps = {}
    for dev in ("cpu", "cuda"):
        net = make_flow_net("FlowNetC", SEED, dev)
        tap, tapped = GradTaps(), []
        hook = net.conv6_1.register_forward_hook(
            lambda m, i, o: tapped.append(tap.tap("conv6_1", o)) or tapped[-1])
        kernels.reset_launch_counts()
        flow6 = net(torch.from_numpy(xs).to(dev), True)[4]
        loss = (flow6 * torch.from_numpy(w6).to(dev)).sum()
        (direct,) = torch.autograd.grad(loss, tapped[0], retain_graph=True)
        loss.backward()
        hook.remove()
        if dev == "cuda":
            torch.cuda.synchronize()
            check(dict(kernels.launch_counts) == {"correlation": 1, "correlation_bwd": 1},
                  f"GradTaps launches {dict(kernels.launch_counts)}")
            launches["correlation"] += 1
            launches["correlation_bwd"] += 1
        check(np.array_equal(tap.grads["conv6_1"], direct.cpu().numpy()),
              f"{dev}: the tap's gradient against autograd's")
        taps[dev] = tap.grads["conv6_1"]
        del net, tapped, direct
    rel = rel_diff(taps["cuda"], taps["cpu"])
    print(f"tooling: (f) GradTaps on FlowNetC's conv6_1 {taps['cpu'].shape}: equal to "
          f"autograd's gradient on each device; card vs CPU max |diff| / max |grad| "
          f"{rel:.3e} (bound {TAP_REL_TOL})", flush=True)
    check(rel <= TAP_REL_TOL, f"GradTaps card vs CPU {rel}")
    shutil.rmtree(TL_BASE, ignore_errors=True)
    return {"launches": launches, "fwd_err": fwd_err}


def _mesh_pair(make):
    """(trainer or scorer on the mesh, the same on one card)."""
    return make(mesh=MESH), make(device="cuda")


def loss_rel(got, want):
    """(the first two steps', every step's) max relative loss difference."""
    rel = np.abs(np.asarray(got, np.float64) / np.asarray(want, np.float64) - 1.0)
    return float(rel[:2].max()), float(rel.max())


def check_losses(what, got, want) -> str:
    first, every = loss_rel(got, want)
    check(np.isfinite(got).all() and first <= MESH_LOSS_REL
          and every <= MESH_LATER_LOSS_REL, f"mesh {what} losses {first} / {every}")
    return f"steps 1-2 {first:.3e}, all {every:.3e}"


def mesh_drift_witness(ot, raw, init, losses) -> str:
    """How far the one-card f32 fit drifts from itself without a mesh: the
    same fit again, and the fit with each batch's rows in reverse order
    (the same cubes in the same batches, so the same sums in another
    order). Returns their max relative loss differences from `losses`
    (steps 1-2, every step): the floor the mesh's bounds are set from."""
    again = ot.fit_block(raw, seed=SEED, init_state=init).losses
    idx, _ = ot._epoch_schedule(raw.shape[0], np.random.default_rng(SEED))
    check(np.array_equal(np.sort(idx.ravel()), np.arange(raw.shape[0])),
          "one epoch without padding")
    moved = np.empty(raw.shape[0], np.int64)
    moved[idx] = idx[:, ::-1]  # row idx[s, j] now holds cube idx[s, -1 - j]
    rev = ot.fit_block(raw[moved], seed=SEED, init_state=init).losses
    out = []
    for name, l in (("again", again), ("batch rows reversed", rev)):
        first, every = loss_rel(l, losses)
        out.append(f"{name} {l.tolist()} (steps 1-2 {first:.3e}, all {every:.3e})")
    return "one card " + ", ".join(out)


def mesh_block_trainer(dtype: str) -> dict:
    """(a): fit_block of the flagship raw-only net on the mesh and on one
    card from the same init, then ms per step of each. Returns the
    mesh's step ms and its one-card twin."""
    cfg = dataclasses.replace(MS_BLOCK_CFG, compute_dtype=dtype)
    raw = np.random.default_rng(SEED + 40).integers(
        0, 256, (MS_STEPS * cfg.batch_size, 32, 32, 15), dtype=np.uint8)
    mt, ot = _mesh_pair(lambda **k: BlockTrainer(cfg, 32, **k))
    init = ot.init_state(SEED)
    got, want = (t.fit_block(raw, seed=SEED, init_state=init) for t in (mt, ot))
    check(got.losses.shape == (MS_STEPS,) and np.isfinite(got.losses).all(),
          f"mesh losses {got.losses}")
    first, every = loss_rel(got.losses, want.losses)
    score_rel = rel_diff(got.raw_scores, want.raw_scores)
    x = torch.from_numpy(raw[:cfg.batch_size]).cuda().float() / 255.0
    w = torch.ones(cfg.batch_size, device="cuda")
    witness = ""
    if dtype == "float32":
        witness = f"; {mesh_drift_witness(ot, raw, init, want.losses)}"
        # the first step's gradients, before Adam: the replicas' reduction
        # and BatchNorm's exchange, unamplified; one card's twice for its
        # own run-to-run spread
        grads = []
        with full_f32():
            for t in (mt, ot, ot):
                t.start_fit(init)
                t.train_step(x, None, w)
                grads.append([p.grad.double() for p in t.net.parameters()])
        grad_rel, grad_self = (
            float(max((a - b).abs().max() for a, b in zip(g, grads[1]))
                  / max(b.abs().max() for b in grads[1])) for g in (grads[0], grads[2]))
        witness = (f"; first step's gradients max |diff| / max |grad| {grad_rel:.3e} "
                   f"(one card against itself {grad_self:.3e})" + witness)
        check(grad_rel <= MESH_GRAD_REL, f"mesh f32 first-step gradients {grad_rel}")
    with full_f32(mt.compute_dtype):
        ms = [cuda_ms(lambda t=t: t.train_step(x, None, w), reps=5, warm=2)
              for t in (mt, ot)]
    corr = float(np.corrcoef(got.raw_scores, want.raw_scores)[0, 1])
    ratio = float(got.raw_scores.mean() / want.raw_scores.mean())
    print(f"mesh: (a) BlockTrainer {dtype}, 5raw nf={cfg.nf} batch {cfg.batch_size} = 2 x "
          f"{cfg.batch_size // 2}, {MS_STEPS} steps: losses mesh {got.losses.tolist()} "
          f"one card {want.losses.tolist()}, max rel diff steps 1-2 {first:.3e}, all "
          f"{every:.3e}{witness}; training "
          f"scores max |diff| / max |score| {score_rel:.3e}, correlation {corr:.6f}, "
          f"mean ratio {ratio:.6f}; ms per step mesh {ms[0]:.3f} one card {ms[1]:.3f} "
          f"({ms[0] / ms[1]:.3f}x)", flush=True)
    if dtype == "float32":
        check_losses("f32 BlockTrainer", got.losses, want.losses)
        check(score_rel <= SERVE_REL_TOL, f"mesh f32 training scores {score_rel}")
    else:
        check(corr > BF16_CORR and abs(ratio - 1.0) < BF16_MEAN_RATIO,
              f"mesh bf16 training scores corr {corr} ratio {ratio}")
    return {"ms": ms}


def mesh_flow_trainer() -> dict:
    """(b): FlowNetC steps on the mesh (batch 7 padded to 8, 4 pairs a
    replica) and on one card; K1 and K2 on a replica's (a, b, g)."""
    data = SyntheticPairs(MS_FLOW_BATCH * MS_FLOW_STEPS, FLOW_HW, SEED + 41)
    batches = list(data.batches(MS_FLOW_BATCH, shuffle=False))
    mt, ot = _mesh_pair(lambda **k: FlowTrainer(make_flow_net("FlowNetC", SEED, "cuda"),
                                                **k))
    finish = capture_cost_volume(mt.net)
    got, want, ms = [], [], ([], [])
    kernels.reset_launch_counts()
    for i, (pairs, target) in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got.append(float(mt.step(pairs, target)["loss"]))
        ms[0].append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            a, b, g = finish()
    launches = dict(kernels.launch_counts)
    for pairs, target in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want.append(float(ot.step(pairs, target)["loss"]))
        ms[1].append((time.perf_counter() - t0) * 1e3)
    rel = check_losses("FlowNetC", got, want)
    check(tuple(a.shape) == (4,) + TRAIN_SHAPE[1:], f"replica's conv3 {tuple(a.shape)}")
    fwd_err, bwd_err = check_fwd(a, b), check_bwd(a, b, g, torch.float32)
    print(f"mesh: (b) FlowTrainer FlowNetC 2x{FLOW_HW} batch {MS_FLOW_BATCH} padded to 8, "
          f"{MS_FLOW_STEPS} steps: losses mesh {got} one card {want}, max rel diff "
          f"{rel}; launches {launches}; K1 / K2 on a replica's (a, b, g) "
          f"{tuple(a.shape)} max_abs_err {fwd_err:.3e} / {bwd_err:.3e}; ms per step "
          f"(synchronised, steps 2-{MS_FLOW_STEPS}) mesh {med(ms[0][1:]):.3f} one card "
          f"{med(ms[1][1:]):.3f}", flush=True)
    n = 2 * MS_FLOW_STEPS
    check(launches == {"correlation": n, "correlation_bwd": n}, f"mesh launches {launches}")
    return {"launches": launches, "fwd_err": fwd_err, "bwd_err": bwd_err,
            "ms": (med(ms[0][1:]), med(ms[1][1:]))}


def mesh_calc_flow(flow_net) -> dict:
    """(c): the resident flow driver over 40 frames of one video on the
    mesh (FlowNet2 replicas, 20 pairs each in batches of 4) and on one
    card."""
    frames = np.stack(make_stream(FRAME_HW, (MS_CALC_MAPS,), SEED + 42)[0][0])
    index = VideoIndex(["v"], np.array([MS_CALC_MAPS]))
    out, secs = [], []
    for mesh in (MESH, None):
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out.append(driver.compute_optical_flow(flow_net, index, frames, chunk=4,
                                               resident=True, device="cuda", mesh=mesh))
        secs.append(time.perf_counter() - t0)
        if mesh is not None:
            launches = kernels.launch_counts["correlation"]
    rel = rel_diff(out[0], out[1])
    print(f"mesh: (c) calc-flow driver, {MS_CALC_MAPS} maps at {FRAME_HW} in batches "
          f"of 4: mesh {MS_CALC_MAPS / secs[0]:.2f} maps/s ({launches} K1 launches), one "
          f"card {MS_CALC_MAPS / secs[1]:.2f} maps/s; max |diff| / max |flow| {rel:.3e} "
          f"(bound {MESH_FLOW_REL})", flush=True)
    check(np.isfinite(out[0]).all() and rel <= MESH_FLOW_REL, f"mesh calc-flow {rel}")
    check(launches == MS_CALC_MAPS // 4, f"mesh calc-flow launches {launches}")
    return {"launches": launches}


def mesh_fleets(flow_net) -> dict:
    """(d): both fleets at C = 8 on the mesh and on one card, each camera
    on its own video; ms per tick of each (time_device_tick)."""
    model = make_model(**SERVE_MODEL)
    videos = make_stream(FRAME_HW, (MS_FLEET_TICKS,) * MS_FLEET_C, seed=SEED + 43)
    rng = np.random.default_rng(SEED + 44)
    flows = rng.normal(0.0, 1.0, (MS_FLEET_TICKS, MS_FLEET_C) + FRAME_HW + (2,)
                       ).astype(np.float32)

    def tick(t):
        return (np.stack([videos[c][0][t] for c in range(MS_FLEET_C)]),
                [videos[c][1][t] for c in range(MS_FLEET_C)])

    def precomputed(sc):
        sc.start_video()
        return np.asarray([sc.push_tick(*tick(t), flows=flows[t])
                           for t in range(MS_FLEET_TICKS)], np.float64)

    def live(sc):
        sc.start_video()
        rows = [sc.push_tick(*tick(t)) for t in range(MS_FLEET_TICKS)]
        rows.append(sc.end_video())
        return np.asarray([r for r in rows if r is not None], np.float64)

    lines, launches = [], 0
    for name, make, run in (
            ("MultiCameraScorer", lambda **k: MultiCameraScorer.from_model(
                model, n_cameras=MS_FLEET_C, **k), precomputed),
            ("MultiCameraFlowScorer", lambda **k: MultiCameraFlowScorer.from_model(
                model, n_cameras=MS_FLEET_C, flow_net=flow_net, flow_model_hw=FLOW_HW,
                **k), live)):
        ms_fleet, one = _mesh_pair(make)
        (got, k1) = k1_counted(lambda: run(ms_fleet))
        launches += k1
        want = run(one)
        rel = rel_diff(got, want)
        ms = [sc.time_device_tick(*tick(2), k=4, repeats=2) for sc in (ms_fleet, one)]
        lines.append(f"{name} {got.shape} scores max |diff| / max |score| {rel:.3e}, "
                     f"K1 launches {k1}, ms/tick mesh {ms[0]:.3f} one card {ms[1]:.3f}")
        check(got.shape == (MS_FLEET_TICKS, MS_FLEET_C) and np.isfinite(got).all(),
              f"mesh {name} scores {got.shape}")
        check(rel <= SERVE_REL_TOL, f"mesh {name} against one card: {rel}")
        del ms_fleet, one
    print(f"mesh: (d) C = {MS_FLEET_C}, 4 cameras a replica: " + "; ".join(lines),
          flush=True)
    # the live fleet: ticks 0, 2-5 and end_video are live, one K1 a replica
    check(launches == 2 * MS_FLEET_TICKS,
          f"live fleet K1 launches {launches}: one a replica a live tick")
    return {"launches": launches}


def mesh_grid() -> None:
    """(e): a 2x2 grid's 4 blocks dealt 2 + 2 over the mesh against the
    one-card grid (4 folded), training and scoring."""
    cfg = GR_CFG.model
    cfg = dataclasses.replace(cfg, epochs=1)
    rng = np.random.default_rng(SEED + 45)
    data = [((0, h, w), rng.integers(0, 256, (MS_GRID_CUBES, 32, 32, 15), dtype=np.uint8),
             None) for h in range(2) for w in range(2)]
    mg, og = _mesh_pair(lambda **k: grid_trainer.GridTrainer(cfg, 32, **k))
    init = og.solo.init_state(SEED)
    t0 = time.perf_counter()
    got = mg.fit_blocks(data, seed=SEED, init_state=init)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    want = og.fit_blocks(data, seed=SEED, init_state=init)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    train_rel = max(rel_diff(got[k].raw_scores, want[k].raw_scores) for k, _, _ in data)
    sc_got, sc_want = (g.score_blocks(want, data) for g in (mg, og))
    score_rel = max(rel_diff(sc_got[k][0], sc_want[k][0]) for k, _, _ in data)
    print(f"mesh: (e) 2x2 grid, 4 blocks of {MS_GRID_CUBES} cubes dealt 2 + 2: fit_blocks "
          f"mesh {t1 - t0:.3f} s one card {t2 - t1:.3f} s; training scores max |diff| / "
          f"max |score| {train_rel:.3e}; score_blocks {score_rel:.3e}", flush=True)
    check(train_rel <= SERVE_REL_TOL, f"mesh grid training scores {train_rel}")
    check(score_rel <= SERVE_REL_TOL, f"mesh grid scoring {score_rel}")


def write_chairs(root: Path, n: int, seed: int) -> None:
    """n FlyingChairs samples at FLOW_HW (*-img_0.ppm, *-img_1.ppm,
    *-flow.flo): SyntheticPairs' textures as binary PPM, no cv2."""
    from vec_vad_torch.utils.flowviz import write_flo

    data = SyntheticPairs(n, FLOW_HW, seed)
    root.mkdir(parents=True)
    h, w = FLOW_HW
    for i in range(n):
        for k in range(2):  # the pairs are BGR, as cv2.imread gives; PPM is RGB
            rgb = data.pairs[i, ..., 3 * k: 3 * k + 3][..., ::-1].astype(np.uint8)
            (root / f"{i:05d}-img_{k}.ppm").write_bytes(
                b"P6\n%d %d\n255\n" % (w, h) + rgb.tobytes())
        write_flo(str(root / f"{i:05d}-flow.flo"), data.flows[i])


def mesh_flow_infer() -> None:
    """(f): `flow-infer` on a with_bn=False FlowNet2 in a subprocess, so
    torch's default TF32 flags apply there (cuDNN's on), against the same
    weights on the CPU (F1's check on the card)."""
    from vec_vad_torch.flow.datasets import FlyingChairs
    from vec_vad_torch.models.flownet.convert import reference_key
    from vec_vad_torch.utils.flowviz import read_flo

    shutil.rmtree(MS_INFER_BASE, ignore_errors=True)
    write_chairs(MS_INFER_BASE / "data", MS_INFER_PAIRS, SEED + 46)
    cpu_net = make_flow_net("FlowNet2", SEED + 7, "cpu")
    ckpt = MS_INFER_BASE / "flownet2.pth"
    torch.save({"state_dict": {reference_key(k): v for k, v in
                               cpu_net.inner.state_dict().items()}}, ckpt)
    root = Path(__file__).resolve().parent
    ds = FlyingChairs(str(MS_INFER_BASE / "data"))
    with torch.no_grad():
        want = np.concatenate([cpu_net(torch.from_numpy(np.asarray(p, np.float32))).numpy()
                               for p, _ in ds.batches(2, shuffle=False)])

    def flow_infer(out: Path, prelude: str = ""):
        """`python -m vec_vad_torch flow-infer` in a subprocess, or the CLI's
        main after `prelude`; (.flo maps, wall s, its last lines)."""
        entry = (["-c", prelude + "import sys\nfrom vec_vad_torch.cli import main\n"
                  "sys.exit(main(sys.argv[1:]))"] if prelude else ["-m", "vec_vad_torch"])
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, *entry, "flow-infer", "--data-root", str(MS_INFER_BASE / "data"), "--net",
             "FlowNet2", "--checkpoint", str(ckpt), "--batch-size", "2", "--save-flow",
             "--out", str(out), "--device", "cuda"],
            cwd=str(root), capture_output=True, text=True, timeout=300,
            env={**os.environ, "PYTHONPATH": str(root)})
        check(r.returncode == 0, f"flow-infer exited {r.returncode}: {r.stderr[-2000:]}")
        got = np.stack([read_flo(str(out / f"{i:06d}.flo")) for i in range(MS_INFER_PAIRS)])
        check(got.shape == want.shape, f"flow-infer maps {got.shape}")
        return got, time.perf_counter() - t0, r.stdout.strip().splitlines()[-2:]

    got, wall, tail = flow_infer(MS_INFER_BASE / "card")
    # the control: the same run with the harness's full_f32 taken out (F1
    # unrepaired), which the bound must tell apart
    fault, _, _ = flow_infer(MS_INFER_BASE / "fault", (
        "import contextlib\nimport vec_vad_torch.flow.harness as h\n"
        "h.full_f32 = lambda dtype=None: contextlib.nullcontext()\n"))
    rel, rel_fault = rel_diff(got, want), rel_diff(fault, want)
    print(f"mesh: (f) flow-infer subprocess (torch's default TF32 flags), FlowNet2 "
          f"with_bn=False, {MS_INFER_PAIRS} FlyingChairs pairs at {FLOW_HW}, batch 2: "
          f"{wall:.1f} s wall; .flo maps against the CPU max |diff| / max |flow| "
          f"{rel:.3e} (bound {MESH_FLOW_REL}); with the harness's full_f32 taken out "
          f"(F1 unrepaired) {rel_fault:.3e}; its output: {tail}", flush=True)
    check(rel <= MESH_FLOW_REL, f"flow-infer {rel}")
    check(rel_fault > MESH_FLOW_REL, f"flow-infer without F1's repair {rel_fault} "
          f"within the bound {MESH_FLOW_REL}: the check cannot see the fault")
    shutil.rmtree(MS_INFER_BASE, ignore_errors=True)


def mesh_phase() -> dict:
    """Every route that takes a device mesh, on ["cuda:0", "cuda:0"]
    against one card (module docstring, phase 14). Returns the mesh
    routes' K1 and K2 launches and K1's and K2's errors at B = 4."""
    ab = {d: mesh_block_trainer(d) for d in ("float32", "bfloat16")}
    ft = mesh_flow_trainer()
    flow_net = make_flownet2(SEED, device="cuda")
    calc = mesh_calc_flow(flow_net)
    fleets = mesh_fleets(flow_net)
    del flow_net
    mesh_grid()
    mesh_flow_infer()
    print(f"mesh: ms a step or tick, mesh / one card on this card (the split, copies "
          f"and reductions of two replicas on one card; no two-card speed): "
          f"BlockTrainer f32 {ab['float32']['ms'][0] / ab['float32']['ms'][1]:.3f}x, "
          f"bf16 {ab['bfloat16']['ms'][0] / ab['bfloat16']['ms'][1]:.3f}x, FlowTrainer "
          f"{ft['ms'][0] / ft['ms'][1]:.3f}x", flush=True)
    return {"k1": ft["launches"]["correlation"] + calc["launches"] + fleets["launches"],
            "k2": ft["launches"]["correlation_bwd"], "fwd_err": ft["fwd_err"],
            "bwd_err": ft["bwd_err"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("tf32: cudnn.allow_tf32=False, cuda.matmul.allow_tf32=False "
          "(full f32 for every phase)")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    # -- build ------------------------------------------------------------
    t0 = time.perf_counter()
    logs = kernels.build_kernels(["correlation", "correlation_bwd"])
    print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            entry = re.search(r"Compiling entry function '\w*?(corr_\w+?_kernel)I(\w+?)EEv", line)
            if entry:  # the instantiation, by its mangled template arguments
                print(f"  {name}: {entry.group(1)}<{entry.group(2)}>")
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name}: {line.strip()}")

    # -- kernel phase --------------------------------------------------------
    t_phase = time.perf_counter()
    rec = kernel_phase(np.random.default_rng(SEED))
    rec_bwd = kernel_bwd_phase(np.random.default_rng(SEED + 5))
    t_phase = phase_done("kernels", t_phase)

    # -- serving phase -------------------------------------------------------
    flow_net = make_flownet2(SEED, device="cuda")
    n_params = sum(p.numel() for p in flow_net.parameters())
    check(n_params == 162_518_834, f"FlowNet2 has {n_params} parameters")
    model = make_model(**SERVE_MODEL)
    videos = make_stream(FRAME_HW, VIDEO_LENGTHS, seed=SEED + 2)
    scorer = FlowStreamingScorer.from_model(
        model, flow_net=flow_net, flow_model_hw=FLOW_HW, device="cuda")

    conv3 = []  # (a, b) conv3 features of the first two served pairs
    hook = flow_net.flownetc.conv3.register_forward_hook(
        lambda m, i, o: conv3.append(o.detach().clone()) if len(conv3) < 4 else None)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    scores, lat, live = serve(scorer, videos, torch.cuda.synchronize)
    wall = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    hook.remove()

    flat = np.concatenate([np.asarray(s, np.float64) for s in scores])
    n_frames = sum(VIDEO_LENGTHS)
    print(f"serve: {n_frames} frames in {len(VIDEO_LENGTHS)} videos, "
          f"{live} live pushes, {wall:.2f} s wall; scores "
          f"min={flat.min():.4f} max={flat.max():.4f}", flush=True)
    check(flat.shape == (n_frames,), f"{flat.shape} scores for {n_frames} frames")
    check(np.isfinite(flat).all(), f"non-finite scores {flat}")
    check(launches.get("correlation", 0) == live,
          f"K1 launches {launches} for {live} live pushes")
    steady = np.concatenate([np.asarray(v) for v in lat[1:]])
    print(f"serve: per-push latency (live pushes after the first video, "
          f"synchronised) median={np.median(steady):.3f} ms "
          f"p90={np.percentile(steady, 90):.3f} ms; first push "
          f"{lat[0][0]:.1f} ms; peak device memory {peak / 2**20:.1f} MiB")

    # K1 on the served conv3 features (pair (f0, f0), then (f1, f2))
    hook_err = 0.0
    for a, b in (conv3[0:2], conv3[2:4]):
        check(tuple(a.shape) == SERVE_SHAPE, f"conv3 features {tuple(a.shape)}")
        hook_err = max(hook_err, check_fwd(a.contiguous(), b.contiguous()))
    print(f"serve: K1 on the served conv3 features max_abs_err={hook_err:.3e}")

    x = torch.from_numpy(np.stack(videos[0][0][:2])).cuda()
    pair = torch.nn.functional.interpolate(  # any 384x512 frame pair
        x.permute(0, 3, 1, 2).float(), size=FLOW_HW, mode="bilinear"
    ).permute(0, 2, 3, 1)[None].contiguous()
    # the other half of a live push: STC over the padded box set + the
    # ensemble over its valid rows
    boxes_pad, nb = scorer._pad_boxes(videos[0][1][0])
    win_t, owin_t, rows_t = scorer._indices(
        (np.arange(scorer.R), scorer._rlen), (np.zeros(scorer.R_of), scorer.R_of),
        (_valid_rows([nb], scorer.K)[0], scorer.K))
    boxes_pad = torch.from_numpy(boxes_pad).cuda()
    with torch.no_grad():
        flow_ms = cuda_ms(lambda: flow_net(pair), reps=10)
        score_ms = cuda_ms(
            lambda: scorer._score_from_rings(win_t, owin_t, (boxes_pad, rows_t, nb)),
            reps=10)
    print(f"serve: FlowNet2 forward (1, 2, 384, 512, 3) f32 {flow_ms:.3f} ms; "
          f"STC over {scorer.K} padded boxes + 5raw1of ensemble over {nb} "
          f"{score_ms:.3f} ms; "
          f"rest of the median push {np.median(steady) - flow_ms - score_ms:.3f} ms")

    # the same first 5 pushes served on the CPU: frames 0-3's scores
    cpu_net = make_flownet2(SEED, device="cpu")
    cpu = FlowStreamingScorer.from_model(
        model, flow_net=cpu_net, flow_model_hw=FLOW_HW, device="cpu")
    frames, boxes = videos[0]
    cpu.start_video()
    cpu_scores = [s for s in (cpu.push(f, b) for f, b in
                              zip(frames[:5], boxes[:5])) if s is not None]
    want = np.asarray(cpu_scores, np.float64)
    got = np.asarray(scores[0][:4], np.float64)
    rel = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
    print(f"serve: card vs CPU, frames 0-3: card={got.tolist()} "
          f"cpu={want.tolist()} max rel diff={rel:.3e} (bound {CPU_REL_TOL})")
    check(want.shape == (4,) and rel <= CPU_REL_TOL,
          f"card vs CPU scores {got} / {want}")

    profile_pushes(scorer, *videos[1])
    del scorer, cpu, cpu_net, flow_net
    t_phase = phase_done("serving", t_phase)

    # -- training phase ------------------------------------------------------
    train = train_phase()
    ft_launches = flownet2_phase()
    t_phase = phase_done("training", t_phase)

    # -- calc-flow phase -----------------------------------------------------
    calc = calc_flow_phase()
    t_phase = phase_done("calc-flow", t_phase)

    # -- train-test phase: the raw-only main path ----------------------------
    train_test_phase()
    t_phase = phase_done("train-test", t_phase)

    # -- two-stream phase: calc-flow -> 5raw1of train -> test ---------------
    ts = two_stream_phase()
    ts_launches = ts["calc_launches"]
    t_phase = phase_done("two-stream", t_phase)

    # -- dataset-scale phase: bf16, resident, segmented, pixel criterion -----
    dataset_scale_phase(ts)
    t_phase = phase_done("dataset-scale", t_phase)

    # -- serving-surface phase: push_many, probes, bf16, fleets, serve CLI ---
    surf = serving_surface_phase()
    cli_launches = serving_cli_phase(ts, surf["flow_net"])
    surf_launches = surf["launches"] + cli_launches
    del ts
    shutil.rmtree(TS_BASE, ignore_errors=True)
    t_phase = phase_done("serving-surface", t_phase)

    # -- foreground phase: motion boxes, precompute-boxes, motion serving ----
    fg = foreground_phase()
    t_phase = phase_done("foreground", t_phase)

    # -- detector phase: the converted Cascade R-CNN on phase 10's tree -----
    detector_phase()
    shutil.rmtree(FG_BASE, ignore_errors=True)
    t_phase = phase_done("detector", t_phase)

    # -- grid phase: the 2x2 model grid, folded, and the interop ------------
    grid_phase()
    t_phase = phase_done("grid", t_phase)

    # -- tooling phase: the decoder, avenue through the CLI, visualize, the
    # layer profiler, the with_bn nets, GradTaps ----------------------------
    tl = tooling_phase()
    t_phase = phase_done("tooling", t_phase)

    # -- mesh phase: every route that takes a device mesh, on the card twice
    ms = mesh_phase()
    t_phase = phase_done("mesh", t_phase)

    # -- detecting-fleet phase: the Cascade R-CNN inside the serving tick ---
    nms = detect_fleet_phase()
    phase_done("detect-fleet", t_phase)

    rec.update(max_abs_err=max(rec["max_abs_err"], hook_err, train["fwd_err"],
                               calc["fwd_err"], surf["fwd_err"], fg["fwd_err"],
                               tl["fwd_err"], ms["fwd_err"]))
    rec_bwd.update(max_abs_err=max(rec_bwd["max_abs_err"], train["bwd_err"],
                                   ms["bwd_err"]))
    tl_k1, tl_k2 = tl["launches"]["correlation"], tl["launches"]["correlation_bwd"]
    k1 = (launches.get("correlation", 0) + train["launches"]["correlation"]
          + ft_launches["correlation"] + calc["launches"] + ts_launches
          + surf_launches + fg["launches"] + tl_k1 + ms["k1"])
    k2 = (train["launches"]["correlation_bwd"] + ft_launches["correlation_bwd"] + tl_k2
          + ms["k2"])
    print(f"launches on the main paths: K1 {k1} (serving {launches.get('correlation', 0)}, "
          f"FlowNetC training {train['launches']['correlation']}, FlowNet2 steps "
          f"{ft_launches['correlation']}, calc-flow {calc['launches']}, two-stream "
          f"calc-flow {ts_launches}, serving surface {surf_launches}, foreground "
          f"{fg['launches']}, detector 0, model grid 0, tooling {tl_k1}, mesh "
          f"{ms['k1']}); K2 {k2} (tooling {tl_k2}, mesh {ms['k2']})")
    # no single PyTorch call computes the cost volume or its gradients
    record = {"kernels": [
        {"name": "correlation_fwd", "route": "cuda",
         "source": "vec_vad_torch/csrc/correlation.cu",
         "replaces": "vec_vad_tpu/models/flownet/ops.py:133",
         "launches": k1, **rec, "library_ms": None},
        {"name": "correlation_bwd", "route": "cuda",
         "source": "vec_vad_torch/csrc/correlation_bwd.cu",
         "replaces": "vec_vad_tpu/models/flownet/ops.py:275",
         "launches": k2, **rec_bwd, "library_ms": None},
        nms,
    ]}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
