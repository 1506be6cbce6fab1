"""Drive the PyTorch/CUDA port (vicasplat_tpu_torch) on one NVIDIA GPU.

Phases, each printing lines with their seconds:
  device    the card's name and power limit;
  build     every kernel of the main paths by plain nvcc, one process per
            source, all started together (kernels/build.py), with ptxas's
            registers, shared memory and spills;
  k1        K1 (flash attention) against its plain version at three shapes,
            with its device time beside SDPA's (every kernel row's device
            time is `queued_ms`: the mean of 20 calls queued behind a
            sleep, so the device runs them back to back);
  flagship  the default path of bench.py: vicasplat_forward on 8 frames of
            256^2 in bf16 (ViT-L encoder, 12-block mix decoder, DPT heads,
            SH degree 4) from random weights made with a seeded
            torch.Generator, then decoder_forward of 12 target views of
            256^2; shapes, finiteness and K1's launches are checked;
  accel     the accelerator serving configuration on the same weights:
            head_tail_backend="pallas" (K3) and RasterizeConfig(backend=
            "pallas", binning="origin") (K2, K4); every kernel's launches
            per forward + render are checked exactly;
  scene     the covering scene: frame 0 of the synthetic generator's scene
            0 at the flagship's size (256^2, 524,288 Gaussians) through the
            accelerator render, whose K2 payload and K4 words are kept;
  k2/k3/k4  each kernel against its plain version on the inputs the
            accelerator path gives it, on the flagship and on the covering
            scene (and K2 also on a dense payload whose pixels saturate, K4
            also on random words), with its time, the plain version's, one
            library call's where one exists, its device time (torch.sort's
            beside K4's), and the bound of this run's inputs; K3 also with
            its device time beside cuDNN's, its share of the bound, its
            cluster size and ptxas's registers and spills;
  k1-bwd    K1's backward kernels (dQ, dK, dV) against the float32 plain
            backward at the decoder shape at batch 2, the encoder shape, a
            ragged one and the synthetic_pose training shape (8, 68, 6, 64),
            within twice SDPA's bf16 backward error plus a
            floor, with the same four times;
  tiny-f32  configs/experiment/_tiny_smoke.yaml's widths in float32 through
            K1's float32 route: a forward against the same weights on the
            CPU and one training step, with exact launch counts;
  k1-f32    K1's float32 route (3xTF32 wgmma; forward, lse, backward)
            against the float32 plain versions at head dims 12, 16 and 64,
            and at the tiny phase's shape, and bf16 at head dim 96 (upcast
            to the route) under the bf16 rules, with the same four times,
            the device time of K1 and of SDPA in the same dtype, SDPA's
            kernels by torch.profiler, and each wgmma kernel's registers,
            spills, shared memory, blocks an SM and HGMMA instructions;
  train     the flagship training step (configs/main.yaml with
            configs/experiment/re10k_8view.yaml: 2 x 8 context frames and
            12 target views of 256^2, bf16 compute over float32 parameters,
            remat "dots", mse + camera dq loss, AdamW with warm-up 1 and
            cosine to 20,000 steps, clip 0.5) from seeded random weights:
            2 warm-up and 3 timed steps with exact launch counts, finite
            loss, logs and gradients, parameters unchanged by step 0 (lr 0)
            and changed by step 1; then one gradient pass of the whole loss
            with K1, SDPA and plain attention at the same weights, K1's gap
            to plain attention in each parameter group's gradient norm
            within twice SDPA's plus a floor; one profiled step, and K1's
            backward on step 0's own inputs against the float32 plain
            backward;
  timing    both configurations in turns, medians of 5 after 2 warm-ups;
  profile   one forward and one render of each under torch.profiler;
  plain-k3  the accelerator forward against the same forward with K3's
            plain version and against the default forward (noise floor);
  render    K2 + K4 on a 1,000-splat scene on the card against the CPU;
  grads     a wiring check of K2's autograd function on the card: its
            forward (K2) against the plain forward of the same inputs, and
            the gradients to means, opacities, a pose delta and a learnable
            background (both backwards are the plain recompute);
  plain-k1  the default forward with K1 swapped for its plain version;
  eval      the port's test mode (vicasplat_tpu_torch.main.test) on the
            repository's trained checkpoint
            (outputs/synthetic_pose/ckpt_committed/weights_latest.npz, the
            synthetic_pose model: 64^2, encoder 384 x 6, decoder 384 x 4,
            linear heads) over the first of the 8 held-out scenes (cut to
            pay for demo, export, re10k and distill; its seconds are taken
            beside eval-accel's two child processes, which start with it)
            with 100 pose-alignment steps and the default render: each scene's PSNR, SSIM and ATE, the means held
            to the JAX package's of the same scenes
            (vicasplat_tpu_torch/evaluation/reference_synthetic_pose_96k.json,
            tools/jax_eval_reference.py), the Benchmarker's seconds per
            section, peak memory, the files written, K1's launches exactly;
            K1 held against its plain version on the first scene's own
            inputs (every decoder block's q, k, v of its bf16 encode), with
            its times (the `trained` row); then the port's eval_pose on all
            8 scenes, its summary (ATE, RPE, pose AUC) held to the JAX
            package's PoseEvaluator and pose_metrics.json checked;
  serve     the serving engine (vicasplat_tpu_torch/serving.py) on the
            flagship and accel models above: the first request of 8 frames
            of 256^2 and the 12-view render capture one CUDA graph each;
            each replay held to the eager call of the same program (bit for
            bit, or else within the plain-k1 rule and RENDER_TOL), the
            launches counted at capture exactly (K1 12; K1 12 + K3 1; K2 12
            + K4 12) and the same kernels in torch.profiler's records of one
            replay; medians of 5 after 2 warm-ups, eager and replayed, the
            busy share of a replayed request, throughput() and the graph
            pools; POST /reconstruct on loopback equal to a direct call, a
            jpeg_data request (the frames by the port's JPEG encoder) equal
            to a direct call on the port's decode of them, a corrupt one
            answered 400; the quantized engine (W8A8,
            center head float) against the bf16 one, and one flagship
            linear's torch._int_mm beside its bf16 matmul;
  demo      the port's demo CLI (vicasplat_tpu_torch.demo.main(argv)) at the
            flagship width with random weights: 8 PNG frames of 320x480 of
            the synthetic generator's scene 0 (written by the port's
            encode_png, so the resize and the crop run) through one bf16
            forward (K1 12 launches exactly), gaussians.ply read back
            (524,288 splats), transforms.json (8 frames), the GLB's JSON (9
            meshes) and the 57-view trajectory video (57 frames), the
            render's median and device time a view; then 12 frames through
            the streaming route (window 8, overlap 2: the engine's program
            captured once and replayed by each window); all in a temporary
            directory, deleted after;
  export    torch.export of the accelerator engine's reconstruct (1 x 8 x
            256^2, bf16) and 12-view render on the card by two processes
            that run beside demo and the phases after it up to train
            (host work, one intra-op thread each; the loading child below
            starts as soon as both are done), the artifacts
            saved and loaded in a child process that imports torch and the
            port's kernels and never its models, called with the engine's
            weights (arguments, not stored): K1 12 + K3 1 and K2 12 + K4 12
            by torch.profiler's records of one call, the outputs against
            the eager engine's (bit for bit, or within the plain-k1 floors
            and RENDER_TOL); a tiny float32 artifact exported on the CPU and
            moved to the card launches K1's float32 route; trace seconds,
            artifact and weight bytes;
  eval-accel the same run with decoder.rasterize.backend=pallas and
            binning=origin, on the first of eval's 8 scenes (each scene
            is held on its own; the cuts to 2 and then 1 paid for the
            serving phases, re10k and distill): K2
            and K4 launches exactly per scene (once a view in each of the
            101 renders), each scene's scores held to eval's. Beside eval and
            it, two child processes
            (vicasplat_tpu_torch/diagnostics/eval_split.py) run the same
            configuration with K2 and K4 swapped for their plain versions,
            the plain compositing summed in chunks of 128 rows
            (eval-origin) and of 64 (the rounding floor): eval-accel's
            per-scene gap to eval-origin (the kernels' effect) is held
            within twice the floor's plus a small floor, and eval-origin's
            gap to eval (the binning's effect) is printed; then one trained
            view (the first scene's first target, after alignment) with its
            alpha mean, saturated pixels and tiles, and K2 and K4 timed on
            its inputs; each scene's scores are also held within EVAL_TOL
            to the JAX package's own origin binning (the reference JSON's
            "origin" entry), beside eval's per-scene gap to the JAX default
            binning, and a gap more than the kernels' floor rule above it is
            printed as the origin binning's own;
  eval-flagship evaluate_scene at the flagship width, on the accelerator
            model's random weights, on one synthetic scene generated at
            256^2 (524,288 Gaussians, 8 frames as context and targets),
            with the pose-alignment steps cut to 10 (printed as reduced):
            K1, K3, K2 and K4 with exact launches, finite scores, shapes and
            the files written, seconds per section and peak memory;
  serve-trained the committed synthetic_pose checkpoint in the serving
            engine, over HTTP on loopback: /reconstruct on the context
            frames of the held-out scenes synthetic_04100 ... 04103 and
            /reconstruct_video on synthetic_04100 rendered with 10 frames
            (window 4, overlap 2: 4 windows, each a replay of the one
            captured program), in float32 held to the JAX engine's answers
            (vicasplat_tpu_torch/evaluation/reference_synthetic_pose_serve.json,
            tools/jax_serve_reference.py; SERVE_TOL) and in bf16 with its
            gaps printed;
  train-mode the port's train mode (vicasplat_tpu_torch.main, mode=train) of
            the synthetic_pose experiment at its widths (64^2, encoder 384 x
            6, decoder 384 x 4, batch 8 of 4 context frames and 2 targets,
            bf16 over float32 parameters, AdamW, clip 0.5, warm-up 200 and
            cosine) from the committed checkpoint, cut to 4 steps: the
            threaded train loader rendering its scenes on the card, a
            full-state checkpoint at steps 2 and 4, validation visuals at 4,
            the logger with wandb.mode=offline (a real offline wandb run
            where the package is installed, its transaction log read back:
            every step's train scalars, the validation image, the exit
            record of run.finish(), and wandb.teardown() leaving no service
            thread or process; else the port's offline run directory), the
            validation step's projections.png, cameras.png and
            interpolation video beside comparison.png (their bytes); K1
            exactly 4 forward and 4 backward launches a step and 4 in the
            validation, every loss finite with the NaN guard at 0, no loader
            thread left, each step's batch, loss, mse, camera loss, PSNR and
            gradient norm held to the JAX package's loop on the CPU
            (vicasplat_tpu_torch/training/reference_synthetic_pose_train.json,
            tools/jax_train_reference.py); K1's backward on the first step's
            own inputs held by the k1-bwd rule; a restore of step 2's full
            state run on the unbroken run's batches equal to it bit for bit
            (parameters, moments, step count); the train mode resumed from
            step 2 writing a weights-only snapshot; the test mode on that
            snapshot (one scene, 10 alignment steps).
  re10k     the RE10K data path: 4 scenes of the synthetic generator at
            360x640 (160 frames each, 65,536 Gaussians) written as PNG frames
            and cameras.npz, converted to .torch chunks by the port's
            convert_scripts CLI (its JPEG encoder at quality 95), the port's
            decoder held to the rendered frames in luma (RE10K_PSNR_MIN), a 2-view
            index by the index_generator CLI (its band printed, at least one
            scene indexed) extended to 8 context views by extend_index; then
            main.py's train mode of re10k_8view from those chunks at the
            flagship's widths, 1 step of batch 2 with 8 context and 12
            target views (cut from 2; K1 24 forward and 12
            backward launches, a finite loss, the loader's seconds a batch
            beside the step time), and its test mode on the first indexed
            scene with that step's checkpoint in the accelerator
            configuration, 1 alignment step (cut from 10: experiments
            scores three scenes at 10): K1 12, K3 1, K2 and K4 once a
            rendered view, finite PSNR, SSIM and ATE, the files written.
  experiments the public experiment configs re10k_2view, acid_2view and
            re10k_4view at full width (ViT-L 24 x 1024, decoder 12 x 768,
            DPT heads, SH degree 4, bf16) from re10k's chunks (acid_2view
            through the acid name), each at its own global batch (16 of 2
            context and 4 target views; 2 of 4 and 8), split into
            micro-batches only where the memory reckoning
            (experiment_reckoning: parallel/memory_proof.py's state and
            activations fitted to two measured peaks) and a measured
            out-of-memory say so: 2 train steps (host ms, the device span
            by CUDA events) with a finite loss, the NaN guard at 0 and K1's
            launches by the config's own remat setting (k1_step_launches:
            dec_depth forwards without remat, twice that with, dec_depth
            backwards, a micro-batch), the K1 shapes, step ms, peak against
            the reckoning; the second step's update (the first runs at lr
            0) moves every lr-multiplier group within AdamW's bound
            (update_record); K1 forward and backward held to their plain
            versions on the run's first backward's own inputs (FLASH_TOL,
            the k1-bwd rule); then its test mode on re10k's first indexed
            scene with that checkpoint, 10 alignment steps: re10k_2view and
            acid_2view on the 2-view index in the default configuration (K1
            12), re10k_4view on a 4-view extend_index in the accelerator
            configuration (K1 12, K3 1, K2 and K4 once a rendered view),
            finite PSNR, SSIM and ATE and the files written; then the same
            scene rendered again with its depth and written in ScanNet's
            layout (JPEG colour, 16-bit depth PNGs in millimetres, poses and
            intrinsics), indexed by index_generator and extend_index
            (--scene_dirs), and scored by eval_pose with re10k_2view's
            checkpoint and dataset=scannet_pose: K1 12, a finite ATE and
            pose AUCs (two views have no RPE).
  distill   distillation: first two float32 steps, "distill_only" then
            "distill", of the committed synthetic_pose student with a
            small DUSt3R teacher drawn from a seed (96 x 2 encoder, 64 x 4
            decoders) on a batch drawn from the same seed, each logged
            scalar held to the JAX package's on the CPU
            (vicasplat_tpu_torch/training/reference_distill.json,
            tools/jax_distill_reference.py; DISTILL_TOL), K1's float32
            route 4 + 4 a step; then main.py's train mode of the distill
            experiment at full width (ViT-L student, the full DUSt3R teacher
            with random weights, batch 24 of 2 context and 4 target frames
            of 256^2) from re10k's chunks, 2 steps in the phases
            distill_only and distill (cut from 3), the batch
            split into as few
            micro-batches as fit the card: each step's phase, losses (the
            distillation term in the first two only, finite), K1's launches
            (24 + 12 a micro-batch), milliseconds and peak memory.
  parallel  the last modules of the JAX tree, in this process on a world-1
            NCCL group: the MoE flagship (re10k_8view's widths with 8
            experts, top-2, capacity factor 1.25, seeded random weights),
            its bf16 forward of 8 x 256^2 and 12-view render in the default
            and the accelerator configuration with exact launches (K1 12;
            K1 12, K3 1, K2 12, K4 12), milliseconds and peak memory, and
            the einsum dispatch against the index dispatch within the
            plain-k1 rule; every route at world 1 against the call it
            wraps: the view-sharded render, expert parallelism, sequence,
            pipeline (one stage) and tensor parallelism (their forwards
            within the plain-k1 rule), the DDP and FSDP2 steps of
            synthetic_pose (loss equal, gradient norms within
            FLASH_BWD_FLOOR); the flagship's train step (2 x (8 + 12))
            under SP (make_mesh_sp(1, 1)) and TP (make_mesh_2d(1, 1))
            against the train phase's step 0 by the same rule, ms and
            peak; the MoE flagship's train step at batch 2 x (8 + 12) (its
            optimizer warmed up linearly, so that the first step updates;
            2 steps, K1 24 + 12 backward a step; E 4 if E 8 does not fit,
            printed with its peak) and its first step under EP
            (make_mesh_ep(1, 1)) against it; at world 2, by two child
            processes (`--route-child`) on cuda:0 over gloo, one step each
            (gradient and first update) against the world-1 step on the
            same global batch (see STEP_TOL's comment): the witness steps
            (synthetic_pose and its MoE variant in float32 under SP, TP and
            EP, every gradient norm and update held) beside this process's
            first steps, then the flagship's SP (1 x 2) and TP (1 x 2) steps
            at batch 1 x (8 + 4) (cut from 8 + 12 to pay for experiments)
            and the MoE flagship's EP (1 x 2) step at
            batch 2 x (8 + 12), 1 a rank (K1 launches exact on each rank,
            K1's backward held on the SP step's own inputs (Sq != Sk) under
            the k1-bwd rule, the loss held, ms and peak a rank); a world-2
            DDP step of synthetic_pose at batch 8 by two child processes
            both on cuda:0 over gloo, against the world-1 step in two
            micro-batches of 4 (and printed against one pass of 8), the
            replicas equal; the brute-force render oracle against
            the default and the accelerator render on the CPU test's scene
            and on the render phase's 1,000-splat scene at dup (4, 4), where
            nothing is truncated (both within the CPU test's tolerances; on
            the latter the oracle gives each splat the tiles of its 3-sigma
            rect, as the tiled render does), and on the covering scene (the
            gaps printed); the memory reckoning of
            parallel/memory_proof.py (dp8, fsdp8, pp4xdp2, and the four
            cards' dp4, fsdp4, pp4) beside the peak of
            the world-1 flagship step at batch 1 x (8 + 12).
Then a JSON line of kernels, the nvidia-smi line, and the result line.
Float32 convolutions run in full float32 (cudnn.allow_tf32 = False), since
K3's plain version is the reference.

Usage, from the repository root: python3 chip_smoke.py
It needs one CUDA card; without one it exits non-zero and prints no result.
"""
import contextlib
import dataclasses
import importlib
import io
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import threading
import time
from unittest import mock

import numpy as np
import torch

# the tolerances and the train-step records shared with the four-card run
from vicasplat_tpu_torch.diagnostics.holds import (
    EXIT_T,
    F32_TOL,
    FLASH_BWD_FLOOR,
    FLASH_TOL,
    RENDER_TOL,
    STEP_TOL,
    TAIL_TOL,
    TRAIN_LOSS_TOL,
    flash_bwd_errors,
    grad_group,
    host_copy,
    k1_bwd_held,
    rel,
    route_gaps,
    step_record,
    update_gaps,
    update_record,
)

ROOT = pathlib.Path(__file__).resolve().parent
# the repository's trained checkpoint, and the JAX package's scores of it
# (tools/jax_eval_reference.py)
EVAL_NPZ = "outputs/synthetic_pose/ckpt_committed/weights_latest.npz"
EVAL_REF = "vicasplat_tpu_torch/evaluation/reference_synthetic_pose_96k.json"
# eval's held-out scenes: the first of the split's 8 (cut to 4 to pay for
# the demo and export phases, to 2 for re10k, to 1 for distill). eval_pose
# still scores all 8
EVAL_SCENES = 1
# the port's means over eval's scenes against the JAX reference's means of
# the same scenes (its largest per-scene gap was 0.1015 dB, 0.00516 SSIM and
# 0.0032 ATE on an H100, so any subset's mean stays within these):
# bf16 encodes on two devices and 100 Adam steps of pose alignment through
# two rasterizers that round differently
EVAL_TOL = {"psnr": 0.15, "ssim": 0.01, "ate": 0.01}
# eval_pose's summary against the JAX PoseEvaluator's, on the same bf16
# encodes as EVAL_TOL's: ATE and RPE in scene units, RPE's rotation in
# degrees, the pose AUCs as fractions
POSE_TOL = {"ate": 0.01, "rpe_trans": 0.01, "rpe_rot": 0.1, "auc@5": 0.01,
            "auc@10": 0.01, "auc@20": 0.01, "auc@30": 0.01}
# eval-accel against eval, per scene: the same encode (ATE equal), then two
# differences that 100 Adam steps of pose alignment amplify: origin binning
# keeps other splats than the default binning where a tile holds more than
# max_per_tile (every tile of these scenes does), and K2 rounds otherwise
# than its plain version. On an H100 the binning alone moved a scene by up
# to 0.0112 dB and 0.00174 SSIM, K2 alone by up to 0.0128 dB and 0.00039
# SSIM (vicasplat_tpu_torch/diagnostics/eval_split.py)
ACCEL_TOL = {"psnr": 0.05, "ssim": 0.002, "ate": 0.002}
# eval-accel's held-out scenes: eval's one. It holds each scene on its own,
# so the cut loses no check; it paid for the serving phases and re10k
# (4 -> 2), then distill (2 -> 1: about 22 s of pose alignment)
ACCEL_SCENES = 1
# eval-accel against eval-origin (the same binning, K2 and K4 swapped for
# their plain versions), per scene: at most twice as far as the plain
# compositing summed in chunks of 64 rows is from the same in chunks of 128
# (the same function in another float32 order through 100 alignment
# steps), plus this floor
KERNEL_FLOOR = {"psnr": 1e-3, "ssim": 1e-4, "ate": 1e-6}
# serve-trained: the JAX InferenceEngine's answers on the committed
# checkpoint (tools/jax_serve_reference.py), and the limits the port's HTTP
# answers are held to: poses absolute, centers_mean relative to its largest
# absolute entry, window scales relative
SERVE_REF = "vicasplat_tpu_torch/evaluation/reference_synthetic_pose_serve.json"
SERVE_TOL = {"poses": 1e-2, "centers_mean": 1e-2, "window_scales": 1e-2}
# each kernel's name in the profiler's device records
KERNEL_SYMBOLS = {"flash_attn": "flash_fwd_kernel", "flash_attn_f32": "f32_fwd_kernel",
                  "dpt_tail": "dpt_tail_kernel",
                  "composite": "composite_kernel", "bitonic_topk": "bitonic_topk_kernel"}
# pose-alignment steps of eval-flagship (the config's 100, cut for time)
FLAGSHIP_ALIGN_STEPS = 10
# the JAX package's train loop on the CPU from the committed checkpoint
# (tools/jax_train_reference.py), and the steps train-mode runs
TRAIN_REF = "vicasplat_tpu_torch/training/reference_synthetic_pose_train.json"
TRAIN_MODE_STEPS = 4
# pose-alignment steps of the test mode on the train mode's snapshot
TRAIN_TEST_ALIGN_STEPS = 10
# the thread wandb keeps for the process from its first run until
# wandb.teardown() (wandb 0.26: "wandb-AsyncioManager-main"), beside its
# wandb-core service process
WANDB_SERVICE_THREAD = "wandb-"

# gradients through K2's recompute against the plain compositing: the same
# function summed in other orders, relative to the largest entry
GRAD_TOL = 1e-3
# the _tiny_smoke widths in float32 on the card against the CPU, relative to
# each output's largest entry: float32 on both sides, summed in other orders
# through 6 blocks, the DPT heads and the exp map of the means
TINY_TOL = 1e-3
H100_BF16_FLOPS = 989e12    # dense tensor-core peak, SXM, 700 W
H100_F32_FLOPS = 67e12      # float32 outside the tensor cores
# float32-accurate products on the tensor cores: three TF32 products (495
# TFLOP/s) per float32 product, as K1's float32 route takes them
H100_TF32X3_FLOPS = 165e12
H100_BYTES_PER_S = 3.35e12  # HBM3
# float32 operations of one (pixel, splat) pair in K2: offsets 2, power 8,
# alpha 4 (one exp), tests 2, weight and blend 9
COMPOSITE_OPS = 25
N_VIEWS = 12
KERNELS = ("flash_attn", "flash_attn_bwd", "flash_attn_f32", "bitonic_topk",
           "composite", "dpt_tail")
# the training step's batch, and the cuts the issue allows if it does not
# fit: targets to 4 first (the JAX package's own flagship step), then batch 1
TRAIN_SHAPES = ((2, 12), (2, 4), (1, 4))
# demo: PNG frames of the synthetic generator's scene 0 at this size (so
# the resize and the crop run), a short clip (one forward) and a long one
# (the streaming route); the flagship's decoder blocks
DEMO_FRAME_HW = (320, 480)
DEMO_SHORT, DEMO_LONG = 8, 12
# re10k: scenes of the synthetic generator at RE10K's frame size, enough
# frames for the 8-view index, written as PNG frames and cameras and
# converted to chunks by the port; square pixels (the vertical focal length
# scaled by W / H), as RE10K's cameras have. 4 scenes make 2 batches of 2,
# one a train step (the loader, as JAX's, restarts each pass over the
# chunks with the same seed, so a pass of one batch would repeat it)
RE10K_HW = (360, 640)
RE10K_SCENES = 4
RE10K_FRAMES = 160
RE10K_GAUSSIANS = 65536
# the index generator's band, fitted to the synthetic trajectories: their
# cameras turn little, so two frames 20 to 120 apart still share 0.85 to
# 1.0 of their rays (the RE10K default band 0.6-0.8 finds no pair)
RE10K_INDEX = {"min_distance": 20, "max_distance": 120, "min_overlap": 0.85,
               "max_overlap": 0.99, "num_target_views": 3, "seed": 0}
# one train step from the chunks (cut from 2 for the 600 s budget;
# its checkpoint feeds the test mode)
RE10K_TRAIN_STEPS = 1
# the test mode's alignment steps (the config's 100, cut): experiments'
# three scenes take these; re10k's own scene takes RE10K_PHASE_ALIGN_STEPS
# (cut from 10 once experiments scored three scenes at 10)
RE10K_ALIGN_STEPS = 10
RE10K_PHASE_ALIGN_STEPS = 1
# the port's decode of the converter's files (JPEG at quality 95, 4:2:0)
# against the rendered frames, in luma (JPEG's Y). Their RGB PSNR is printed:
# the generator's per-splat colour noise is finer than the 2x2 chroma
# samples, so 4:2:0 loses it (about 33 dB; PIL's files are the same bytes)
RE10K_PSNR_MIN = 40.0
# experiments: the public experiment configs that only the JAX package had
# trained and scored, each trained at full width from re10k's chunks at its
# own global batch, EXPERIMENT_STEPS steps (the first at lr 0, so the
# checkpoint the test modes score has taken one update), then its test mode
# on re10k's first indexed scene with the cut alignment steps
# (RE10K_ALIGN_STEPS). The step's device time is the span of CUDA events
# around it: tracing its kernels (tools/experiments_trace.py) held a step
# up for 21-57 s against 6-10 s untraced (H100 80GB HBM3)
EXPERIMENTS = ("re10k_2view", "acid_2view", "re10k_4view")
EXPERIMENT_STEPS = 2
# the memory reckoning's activations (GB a micro-batch's context frame and
# target view at 256^2, bf16): fitted to two peaks measured on an H100
# 80GB HBM3, the flagship step at 2 x (8 + 12) with remat "dots" (67.9 GB)
# and distill.yaml's micro-batch of 8 x (2 + 4) with whole-block remat and
# the ViT-L teacher (79.2 GB, 2.3 GB of it the teacher's weights), beside
# 10.4 GB of state and bf16 weights; a split is tried from the smallest
# whose reckoning is under EXPERIMENT_FIT_GB, a larger one after an
# out-of-memory
EXPERIMENT_ACT_GB = {"context": 2.0, "target": 1.1}
EXPERIMENT_FIT_GB = 80.0
# distill: two float32 steps (distill_only, distill) of the committed
# synthetic_pose student with a small DUSt3R teacher against the JAX
# package's on the CPU (tools/jax_distill_reference.py). The teacher's
# weights and the batch are drawn by numpy from the tool's seed, leaf by
# leaf (the tool's recipe, tests/test_torch_distill.py holds the two equal)
DISTILL_REF = "vicasplat_tpu_torch/training/reference_distill.json"
DISTILL_TEACHER = dict(img_size=64, patch_size=16, enc_embed_dim=96, enc_depth=2,
                       enc_num_heads=4, dec_embed_dim=64, dec_depth=4, dec_num_heads=4)
DISTILL_SEED = 2026
# each logged scalar against JAX's: float32 on both sides (TF32 off), the
# same batch and weights, sums in other orders through the student (K1's
# float32 route), the teacher (plain attention, cuDNN float32 convolutions)
# and the render: relative, beside 1e-6 absolute (the PSNR placeholder is 0)
DISTILL_TOL = 1e-3
# the distill experiment at full width from re10k's chunks: 2 steps, in the
# phases distill_only and distill (train.distill_only_steps=1,
# train.distill_max_steps=1; cut from 3 for the 600 s budget: the
# third, "full", is the flagship step of the train and re10k phases); its
# batch of 24 from re10k's 4 scenes, whose root is listed 6 times (the
# loader restarts each pass with the same seed, so a pass must hold 24)
DISTILL_STEPS = 2
DISTILL_ROOT_COPIES = 6
# micro-batches a step (train.accumulate_grad_batches), tried in turn until
# one fits the card: 1 and 2 ran out of memory at 83.9 GB on an H100 80GB
# HBM3, so the list starts at 3
DISTILL_ACCUMULATE = (3, 4, 6)
# random weights make the norm-free DPT heads' outputs explode: a seeded
# full-size teacher put points at 1e9 (median norm) and the student at
# 1e9 with confidences of 4e3 (float32 on a CPU), so Regr3D reached 1e28 on
# the H100 and the gradients overflowed. The teacher's checkpoint (written in the DUSt3R
# layout and read by the train mode through the converter) has its heads'
# last conv scaled by this factor, and the student takes the repository's
# random-init option encoder.dpt_stabilize=true; points of 1-50 and
# confidences of 1-5 then give a loss near 1e3
DISTILL_HEAD_SCALE = 0.1
# export: the tiny float32 model exported on the CPU (the tests' toy widths:
# head dim 12, K1's float32 route on the card)
TINY_EXPORT_NET = dict(img_size=32, patch_size=16, enc_embed_dim=64, enc_depth=2,
                       enc_num_heads=4, dec_embed_dim=48, dec_depth=4, dec_num_heads=4,
                       use_intrinsic_embedding=True, temporal_rope_theta=30.0)
# parallel: the MoE flagship (re10k_8view's widths, MoE decoder MLPs) and
# its train step's target views (the train phase's 12)
MOE_EXPERTS, MOE_TOP_K, MOE_CAPACITY = 8, 2, 1.25
MOE_TARGETS = 12
# the DDP steps: synthetic_pose at batch 8 (4 a rank at world 2), at a step
# of its 200-step warm-up where the learning rate is not 0
DDP_BATCH = 8
DDP_STEP = 100
# training under SP, TP and EP. At world 1, step 0 of the flagship (lr 0,
# gradients only) against the train phase's and the MoE flagship's first
# step under EP against the MoE train step's, by the rule above. At world 2,
# two child processes on cuda:0 over gloo, one step each (gradient and
# first update, from seed 0), against the world-1 step on the same global
# batch:
# - the flagship under SP (1 x 2) and TP (1 x 2) at batch ROUTE_BATCH x (8 +
#   ROUTE_TARGETS) and the MoE flagship under EP (1 x 2) at batch 2 x (8 +
#   EP_TARGETS), bf16, route_train_config: K1's launches exact on each
#   rank, its backward held on the SP step's own inputs (Sq != Sk), the
#   loss within FLASH_BWD_FLOOR (a TP rank rounds its part of each
#   row-parallel product to bf16 before the sum), the replicas equal. Their
#   gradient norms' gaps are printed, not held: from random init the
#   flagship's step is chaotic, even in float32 (its norm-free DPT heads put
#   half of the Gaussians behind the cameras; a change of 1e-7 of the
#   weights and images moves its gradient norms by up to 8e-3, K1's 3xTF32
#   against plain float32 attention by 1e-1: diagnostics/route_posedness.py
#   on an H100 80GB HBM3 at 700.00 W), and a route that rounds otherwise
#   lands anywhere in that range;
# - the routes' arithmetic, held: synthetic_pose (linear heads, bounded
#   depth: its step is well posed from random init) and the same model
#   with MoE decoder MLPs (E MOE_EXPERTS, top-2, capacity factor
#   MOE_CAPACITY), float32, batch DDP_BATCH at step DDP_STEP, under SP, TP
#   and EP (1 x 2): the loss within STEP_TOL, the gradient norm, every
#   group's gradient norm, every group's update mass (the sum of |p1 - p0|
#   over every rank, slices summed) and its signed update sum (relative to
#   the mass) within FLASH_BWD_FLOOR, the replicas equal
# (ROUTE_TARGETS cut from 12 to pay for the experiments phase)
ROUTE_BATCH, ROUTE_TARGETS = 1, 4
EP_TARGETS = 12
# the tiled render against the brute-force oracle on the CPU test's scene:
# its own tolerances (tests/test_torch_raster_reference.py, after JAX's
# tests/test_rasterizer.py); the covering scene's oracle in chunks of pixels
ORACLE_TOL = {"color": 2e-3, "depth": 2e-2, "alpha": 2e-3}
ORACLE_CHUNK = 512


T_START = time.perf_counter()


def phase(name, t0, msg):
    """A line of phase `name`: seconds since t0, since the script began, and msg."""
    now = time.perf_counter()
    print(f"[{name}] {now - t0:.2f} s (at {now - T_START:.1f} s)  {msg}", flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of fn over iters launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops, rate, nbytes):
    """(least ms the card could take, what bounds it)."""
    t_ops, t_bytes = flops / rate * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def nvidia_smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def row_line(name, t0, label, r, tol):
    phase(name, t0, f"{label}: max_abs_err {r['max_abs_err']:.3e} (tol {tol:.3e}) "
          f"kernel_ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms "
          + ("none" if r["library_ms"] is None else f"{r['library_ms']:.4f}")
          + f" bound_ms {r['bound_ms']:.4f} ({r['bound_by']})")


def own_rounding(held: dict) -> dict:
    """k1_bwd_held's errors, with dQ against its own rounding as `dq_own`."""
    return dict(held["errors"], dq_own=held["dq_same_rounding"])


def own_line(errs: dict) -> str:
    d = errs["dq_own"]
    return (f"; dQ against its own rounding {d['rel']:.2e} of its largest entry (tol "
            f"{d['effective_rel']:.2e}, {d['ratio']:.3f} of it)")


def flash_phase(dev, inputs=None):
    """K1 against its plain version on `inputs` ({label: [(q, k, v), ...]},
    each row timed on its first triple), by default random bf16 at the
    decoder, encoder and ragged shapes."""
    import torch.nn.functional as F

    from vicasplat_tpu_torch.kernels import attention_reference, flash_attention

    if inputs is None:
        g = torch.Generator(device=dev).manual_seed(1)
        inputs = {label: [tuple(torch.randn(b, s, h, 64, generator=g, device=dev)
                                .bfloat16() for s in (sq, sk, sk))]
                  for label, (b, sq, sk, h) in {"decoder": (1, 2056, 2064, 12),
                                                "encoder": (8, 257, 257, 16),
                                                "ragged": (2, 77, 130, 12)}.items()}
    rows = {}
    for label, triples in inputs.items():
        t0 = time.perf_counter()
        err = 0.0
        for q, k, v in triples:
            out = flash_attention(q, k, v)
            torch.cuda.synchronize()
            err = max(err, (out.float() - attention_reference(q, k, v)).abs().max().item())
        if not err < FLASH_TOL:
            raise AssertionError(f"K1 {label}: max abs err {err} >= {FLASH_TOL}")
        q, k, v = triples[0]
        (b, sq, h, d), sk = q.shape, k.shape[1]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        flops = 4.0 * b * h * sq * sk * d
        nbytes = 2.0 * d * h * b * (2 * sq + 2 * sk)  # q, k, v in, o out
        ms = cuda_ms(lambda: flash_attention(q, k, v))

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt)

        rows[label] = dict(
            shape=f"q ({b}, {sq}, {h}, {d}), k/v ({b}, {sk}, {h}, {d}) "
                  f"{str(q.dtype).removeprefix('torch.')}",
            calls_checked=len(triples), max_abs_err=err, ms=ms,
            plain_ms=cuda_ms(lambda: attention_reference(q, k, v), iters=5),
            library_ms=cuda_ms(library), tflops=flops / ms * 1e-9,
            # back to back, the wrappers' host time can set these means
            device_ms=queued_ms(lambda: flash_attention(q, k, v)),
            library_device_ms=queued_ms(library))
        rows[label]["bound_ms"], rows[label]["bound_by"] = bound(
            flops, H100_BF16_FLOPS, nbytes)
        r = rows[label]
        row_line("k1", t0, f"{label} {r['shape']}, {len(triples)} call(s) checked "
                 f"({r['tflops']:.1f} TFLOP/s; device {r['device_ms']:.4f}, SDPA "
                 f"device {r['library_device_ms']:.4f})", r, FLASH_TOL)
    return rows


def topk_phase(dev, inputs, keep):
    """K4 on each of `inputs` ({label: (rows, m) words}: the flagship view's
    candidate words and the covering scene's, or a trained view's) and on
    random full-range words of the first input's shape: exact equality with
    torch.sort. The library call is torch.sort of the same unsigned values
    held in int64; beside the means, the device time of each."""
    from vicasplat_tpu_torch.kernels import bitonic_topk, topk_reference
    from vicasplat_tpu_torch.kernels.bitonic_topk import from_u32_bits

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(4)
    rand = torch.randint(-2 ** 31, 2 ** 31, next(iter(inputs.values())).shape,
                         generator=g, device=dev, dtype=torch.int32)
    for label, w in dict(inputs, random=rand).items():
        if not torch.equal(bitonic_topk(w, keep), topk_reference(w, keep)):
            raise AssertionError(f"K4 {label}: differs from torch.sort")
    rows = {}
    for label, w in inputs.items():
        values = from_u32_bits(w)
        n, m = w.shape
        stages = int(math.log2(m)) * (int(math.log2(m)) + 1) // 2
        r = dict(shape=f"({n}, {m}) u32 words -> ({n}, {keep})",
                 max_abs_err=0.0, ms=cuda_ms(lambda: bitonic_topk(w, keep)),
                 plain_ms=cuda_ms(lambda: topk_reference(w, keep)),
                 library_ms=cuda_ms(lambda: torch.sort(values, dim=1)),
                 empty_share=(w == -1).float().mean().item(),
                 device_ms=queued_ms(lambda: bitonic_topk(w, keep)),
                 library_device_ms=queued_ms(lambda: torch.sort(values, dim=1)))
        # one compare and two selects a compare-exchange of the full network,
        # at the table's 32-bit (non-tensor) rate; 4 bytes a word in and a
        # kept word out
        r["bound_ms"], r["bound_by"] = bound(3.0 * stages * n * m / 2,
                                             H100_F32_FLOPS, 4.0 * n * (m + keep))
        r["bound_share"] = r["bound_ms"] / r["device_ms"] if r["device_ms"] else None
        row_line("k4", t0, f"{label} {r['shape']}, exact on {label} and random words, "
                 f"empty slots {r['empty_share']:.3f} (device {r['device_ms']:.4f}, "
                 f"torch.sort device {r['library_device_ms']:.4f})", r, 0.0)
        rows[label] = r
    return rows


def composite_needs(payload, image_shape, tile_px):
    """What the data needs of K2: (the (pixel, splat) pairs that a pixel
    blends, power <= 0 and alpha >= 1/255, before its transmittance falls
    under 1e-4, the payload rows met by any pixel of their tile before it
    saturates)."""
    from vicasplat_tpu_torch.ops.rasterize.tiles import _tile_pixel_centers

    pix = _tile_pixel_centers(image_shape, tile_px, payload.device)
    p = payload[:, None]  # (T, 1, K, 16) against (T, P, 1) pixels
    dx, dy = pix[..., 0:1] - p[..., 0], pix[..., 1:2] - p[..., 1]
    power = -0.5 * (p[..., 2] * dx * dx + p[..., 4] * dy * dy) - p[..., 3] * dx * dy
    a = torch.clamp(p[..., 5] * torch.exp(power.clamp(max=0.0)), max=0.99)
    a = torch.where((power > 0) | (a < 1 / 255), torch.zeros_like(a), a)
    logom = torch.log1p(-a)
    alive = torch.cumsum(logom, -1) - logom >= math.log(EXIT_T)
    return int(((a > 0) & alive).sum()), int(alive.any(1).sum())


def composite_phase(dev, inputs, image_shape, tile_px, chunk, dense=True):
    """K2 on each of `inputs` ({label: payload}: the flagship view's and the
    covering scene's, or a trained view's) and, with `dense`, on a dense
    synthetic payload of the first input's shape that saturates, with its
    device time beside the means."""
    from vicasplat_tpu_torch.ops.rasterize.pallas_composite import (
        composite_reference,
        composite_tiles_kernel,
        dense_payload,
    )

    t0 = time.perf_counter()
    bg = torch.zeros(3, device=dev)
    tw = -(-image_shape[1] // tile_px)
    shape = next(iter(inputs.values())).shape
    if dense:
        inputs = dict(inputs, dense=dense_payload(*shape[:2], tile_px, tw, seed=5,
                                                  device=dev))
    rows = {}
    for label, p in inputs.items():
        out = composite_tiles_kernel(p, image_shape, tile_px, bg, chunk)
        ref = composite_reference(p, image_shape, tile_px, bg, chunk)
        err = max((a - b).abs().max().item() for a, b in zip(out, ref))
        tol = RENDER_TOL + EXIT_T * p[..., 6:10].abs().max().item()
        if not err < tol:
            raise AssertionError(f"K2 {label}: max abs err {err} >= {tol}")
        pairs, rows_needed = composite_needs(p, image_shape, tile_px)
        r = dict(shape=f"payload {tuple(p.shape)} f32 -> {image_shape}",
                 max_abs_err=err, tol=tol, pairs=pairs, rows_needed=rows_needed,
                 alpha_mean=out[2].mean().item(),
                 ms=cuda_ms(lambda: composite_tiles_kernel(p, image_shape, tile_px,
                                                           bg, chunk)),
                 plain_ms=cuda_ms(lambda: composite_reference(p, image_shape,
                                                              tile_px, bg, chunk),
                                  iters=5),
                 library_ms=None,
                 device_ms=queued_ms(lambda: composite_tiles_kernel(
                     p, image_shape, tile_px, bg, chunk)))
        # columns 0-9 of each needed row in (10-15 are padding no arithmetic
        # reads), rgb, depth and alpha out
        r["bound_ms"], r["bound_by"] = bound(
            COMPOSITE_OPS * pairs, H100_F32_FLOPS,
            40.0 * rows_needed + 20.0 * image_shape[0] * image_shape[1])
        r["bound_share"] = r["bound_ms"] / r["device_ms"] if r["device_ms"] else None
        row_line("k2", t0, f"{label} {r['shape']}, {pairs} pixel-splat pairs and "
                 f"{rows_needed} payload rows needed, alpha mean "
                 f"{r['alpha_mean']:.4f} (device {r['device_ms']:.4f})", r, tol)
        rows[label] = r
    return rows


def covering_scene(dev):
    """Frame 0 of the synthetic generator's scene 0 (its own settings, but
    the flagship's 256^2 views and 524,288 Gaussians: a backdrop plane and
    24 clusters, SH degree 0), as the render's arguments on the card."""
    from vicasplat_tpu_torch.data import synthetic_scenes as scenes
    from vicasplat_tpu_torch.ops.rasterize.projection import cov6_from_scale_rot

    cfg = scenes.SyntheticScenesConfig(input_image_shape=(256, 256), n_gaussians=524288)
    rng = scenes.scene_rng(0, cfg)
    g = {k: torch.from_numpy(v).to(dev) for k, v in scenes.scene_gaussians(rng, cfg).items()}
    ext = torch.from_numpy(scenes.scene_trajectory(rng, cfg)[:1]).to(dev)
    K = torch.from_numpy(scenes.intrinsics_for(cfg)[None]).to(dev)
    return (g["means"], cov6_from_scale_rot(g["scales"], g["rotations"]), g["harmonics"],
            g["opacities"], ext, K, cfg.input_image_shape, torch.zeros(3, device=dev), 0)


def ptxas_report(log):
    """{kernel's mangled name: (registers, spill store bytes, spill load
    bytes)} from nvcc's -Xptxas -v output."""
    out, name, spills = {}, None, (0, 0)
    for line in log.splitlines():
        if "Function properties for " in line:
            name = line.split("Function properties for ")[1].strip()
            spills = (0, 0)
        elif "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            spills = (nums[1], nums[2])  # stack frame, stores, loads
        elif "Used " in line and "registers" in line and name is not None:
            regs = int(line.split("Used ")[1].split()[0])
            out[name] = (regs, *spills)
            name = None
    return out


def tail_phase(args, ptxas):
    """K3 on the GS head's own inputs, with and without the merger addend m.
    The library yardstick is cuDNN unfused in bf16: the add, conv2d, relu
    and conv2d (four calls; three without m). `ptxas`: the build's report
    (ptxas_report) for the registers and spills of the instantiation the
    flagship runs."""
    import torch.nn.functional as F

    from vicasplat_tpu_torch.kernels import dpt_tail_reference, fused_dpt_tail
    from vicasplat_tpu_torch.kernels.dpt_tail import (
        cluster_size,
        feature_slice,
        out_slices,
    )

    t0 = time.perf_counter()
    a, m, w1, b1, w2, b2 = args
    N, H, W, C = a.shape
    Fd, O = w1.shape[0], w2.shape[0]
    w2c = w2.reshape(O, Fd, 1, 1)

    def library(x, m):
        x = x if m is None else x + m
        h = F.relu(F.conv2d(x.permute(0, 3, 1, 2), w1, b1, padding=1))
        return F.conv2d(h, w2c, b2).permute(0, 2, 3, 1)

    rows = {}
    for label, mm in (("with m", m), ("without m", None)):
        out = fused_dpt_tail(a, mm, w1, b1, w2, b2).float()
        ref = dpt_tail_reference(a, mm, w1, b1, w2, b2).float()
        err = ((out - ref).abs().max() / ref.abs().max()).item()
        if not err < TAIL_TOL:
            raise AssertionError(f"K3 {label}: relative err {err} >= {TAIL_TOL}")
        del out, ref
        n_in = 2 if mm is not None else 1
        r = dict(shape=f"a{', m' if mm is not None else ''} {tuple(a.shape)} bf16, "
                 f"w1 {tuple(w1.shape)}, O {O}",
                 max_abs_err=err,
                 ms=cuda_ms(lambda: fused_dpt_tail(a, mm, w1, b1, w2, b2), iters=10),
                 plain_ms=cuda_ms(lambda: dpt_tail_reference(a, mm, w1, b1, w2, b2),
                                  iters=3, warmup=1),
                 library_ms=cuda_ms(lambda: library(a, mm), iters=10),
                 library=f"cuDNN bf16, {n_in + 2} calls")
        flops = 2.0 * N * H * W * (9 * C * Fd + Fd * O)
        nbytes = 2.0 * (n_in * a.numel() + N * H * W * O + w1.numel() + w2.numel())
        r["bound_ms"], r["bound_by"] = bound(flops, H100_BF16_FLOPS, nbytes)
        r["tflops"] = flops / r["ms"] * 1e-9
        # back to back, the wrapper's host time can set the means: the
        # device time of K3 and of cuDNN's four (three) calls
        r["device_ms"] = queued_ms(lambda: fused_dpt_tail(a, mm, w1, b1, w2, b2))
        r["library_device_ms"] = queued_ms(lambda: library(a, mm))
        r["bound_share"] = r["bound_ms"] / r["device_ms"] if r["device_ms"] else None
        r["cluster"] = cluster_size()
        # the instantiation this shape runs: feature slice, multi-slice, N2
        fs = feature_slice(Fd)
        inst = f"dpt_tail_kernelILi{fs}ELb{int(fs != Fd)}ELi{out_slices(O)[0]}E"
        found = [v for k, v in ptxas.items() if inst in k]
        r["registers"], r["spill_store_bytes"], r["spill_load_bytes"] = (
            found[0] if found else ("not measured",) * 3)
        row_line("k3", t0, f"{label} {r['shape']} (relative err; "
                 f"{r['tflops']:.1f} TFLOP/s; device {r['device_ms']:.4f}, library "
                 f"device {r['library_device_ms']:.4f}; bound share "
                 + ("not measured" if r["bound_share"] is None else f"{r['bound_share']:.3f}")
                 + f"; cluster {r['cluster']}; {r['registers']} registers, spills "
                 f"{r['spill_store_bytes']}/{r['spill_load_bytes']} bytes; library: "
                 f"{r['library']})", r, TAIL_TOL)
        rows[label] = r
    return rows


def flash_bwd_phase(dev):
    """K1's backward (one call launches its D pass, dK/dV and dQ kernels)
    against the float32 plain backward from the same q, k, v, dO and the
    float32 forward's o and log-sum-exp; SDPA's bf16 backward, timed by
    torch.autograd.grad on a kept graph, is the noise floor and the
    library yardstick."""
    import torch.nn.functional as F

    from vicasplat_tpu_torch.kernels.flash_attn import (
        _forward,
        attention_backward_reference,
        attention_lse_reference,
        attention_reference,
        flash_attention_backward,
    )

    rows = {}
    g = torch.Generator(device=dev).manual_seed(7)
    for label, (b, sq, sk, h) in {"decoder": (2, 2056, 2064, 12),
                                  "encoder": (16, 257, 257, 16),
                                  "ragged": (2, 200, 137, 12),
                                  # synthetic_pose training: 4 frames x 17
                                  # tokens at batch 8, a last tile of 4 rows
                                  "synthetic_pose": (8, 68, 68, 6)}.items():
        t0 = time.perf_counter()
        q, do = (torch.randn(b, sq, h, 64, generator=g, device=dev).bfloat16()
                 for _ in range(2))
        k, v = (torch.randn(b, sk, h, 64, generator=g, device=dev).bfloat16()
                for _ in range(2))
        o, lse = _forward(q, k, v, with_lse=True)
        got = flash_attention_backward(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        o_ref, lse_ref = attention_reference(q, k, v), attention_lse_reference(q, k)

        def plain():
            return attention_backward_reference(q, k, v, o_ref, lse_ref, do)

        xs = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
        out_lib = F.scaled_dot_product_attention(*xs)
        do_t = do.transpose(1, 2)

        def library():
            return torch.autograd.grad(out_lib, xs, do_t, retain_graph=True)

        errs = flash_bwd_errors(got, plain(), library(), what=f"K1 backward {label}")
        lse_err = (lse - lse_ref).abs().max().item()
        if not lse_err < 1e-3:
            raise AssertionError(f"K1 forward's lse {label}: max abs err {lse_err}")
        flops = 10.0 * b * h * sq * sk * 64
        # q, o, dO, dQ at Sq; k, v, dK, dV at Sk (bf16); lse in float32
        nbytes = 2.0 * 64 * h * b * (4 * sq + 4 * sk) + 4.0 * b * h * sq
        ms = cuda_ms(lambda: flash_attention_backward(q, k, v, o, lse, do))
        rows[label] = dict(
            shape=f"q ({b}, {sq}, {h}, 64), k/v ({b}, {sk}, {h}, 64) bf16",
            max_abs_err=max(e["abs"] for e in errs.values()), errors=errs,
            lse_max_abs_err=lse_err, ms=ms, plain_ms=cuda_ms(plain, iters=3),
            library_ms=cuda_ms(library, iters=10),
            library="SDPA bf16 backward (torch.autograd.grad, kept graph)",
            tflops=flops / ms * 1e-9)
        rows[label]["bound_ms"], rows[label]["bound_by"] = bound(
            flops, H100_BF16_FLOPS, nbytes)
        # back to back, torch.autograd.grad's host time can set SDPA's
        # time: the device time of each
        rows[label]["device_ms"] = queued_ms(
            lambda: flash_attention_backward(q, k, v, o, lse, do))
        rows[label]["library_device_ms"] = queued_ms(library)
        del out_lib, xs
        r = rows[label]
        phase("k1-bwd", t0, f"{label} {r['shape']}: relative errors " + ", ".join(
            f"{n} {e['rel']:.2e} (sdpa {e['sdpa_rel']:.2e}, tol "
            f"{2 * e['sdpa_rel'] + FLASH_BWD_FLOOR:.2e})" for n, e in errs.items())
            + f"; lse max abs err {lse_err:.1e}; kernel_ms {r['ms']:.4f} "
            f"({r['tflops']:.1f} TFLOP/s; device {r['device_ms']:.4f}) plain_ms "
            f"{r['plain_ms']:.4f} library_ms {r['library_ms']:.4f} (device "
            f"{r['library_device_ms']:.4f}) bound_ms {r['bound_ms']:.4f} "
            f"({r['bound_by']})")
    return rows


def f32_kernel_report():
    """K1's float32 route as built: for each wgmma kernel (forward, dkdv, dq)
    at each padded head dim, ptxas's registers and spill bytes, the HGMMA
    instructions in its SASS (cuobjdump -sass of the library), and its
    dynamic shared memory, ring slots and resident blocks an SM
    (vs_flash_attn_f32_plan). Raises unless every one of them holds HGMMA."""
    import ctypes
    import re

    from vicasplat_tpu_torch.kernels import build

    lib_path = build.build("flash_attn_f32")
    cuobjdump = pathlib.Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    hgmma, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            hgmma[fn] = 0
        elif fn is not None and "HGMMA" in line:
            hgmma[fn] += 1
    ptxas = ptxas_report(build.build_logs.get("flash_attn_f32", ""))
    plan = build.load("flash_attn_f32").vs_flash_attn_f32_plan
    plan.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3
    plan.restype = ctypes.c_int
    kinds = {"f32_fwd_kernel": (0, "forward"), "f32_bwd_dkdv_kernel": (1, "dkdv"),
             "f32_bwd_dq_kernel": (2, "dq")}
    report = {}
    for name, count in hgmma.items():
        m = re.search(r"(f32_fwd_kernel|f32_bwd_dkdv_kernel|f32_bwd_dq_kernel)ILi(\d+)E",
                      name)
        if m is None:
            continue
        kind, label = kinds[m.group(1)]
        dp = int(m.group(2))
        smem, slots, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        rc = plan(kind, dp, ctypes.byref(smem), ctypes.byref(slots), ctypes.byref(blocks))
        if rc != 0:
            raise RuntimeError(f"vs_flash_attn_f32_plan({kind}, {dp}): cudaError {rc}")
        regs = [v for k, v in ptxas.items() if m.group(0) in k]
        report[f"{label} DP {dp}"] = dict(
            hgmma=count, dynamic_smem=smem.value, slots=slots.value,
            blocks_per_sm=blocks.value,
            registers=regs[0][0] if regs else "not measured",
            spill_store_bytes=regs[0][1] if regs else "not measured",
            spill_load_bytes=regs[0][2] if regs else "not measured")
    if len(report) != 12 or any(r["hgmma"] == 0 for r in report.values()):
        raise AssertionError(f"K1 float32 kernels without HGMMA in their SASS: {report}")
    return report


def sdpa_kernels_child(shapes):
    """{label: {"forward": names, "backward": names}}: the kernels SDPA
    launches at each of `shapes` ({label: (b, sq, sk, h, d, dtype name)}),
    by torch.profiler, without their argument lists. Run in a fresh process
    (`--sdpa-kernels`): in the long-lived script process the profiler
    returned no kernel records for these short windows after the earlier
    phases, though it did in a fresh one and for the train step later."""
    import torch.nn.functional as F

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(8)
    out = {}
    for label, (b, sq, sk, h, d, dname) in shapes.items():
        dtype = getattr(torch, dname)
        xs = [torch.randn(b, h, s, d, generator=g, device=dev).to(dtype).requires_grad_()
              for s in (sq, sk, sk)]
        do = torch.randn(b, h, sq, d, generator=g, device=dev).to(dtype)
        o = F.scaled_dot_product_attention(*xs)
        fns = {"forward": lambda: F.scaled_dot_product_attention(*xs),
               "backward": lambda: torch.autograd.grad(o, xs, do, retain_graph=True)}
        out[label] = {}
        for way, fn in fns.items():
            fn()  # warm
            torch.cuda.synchronize()
            # a window now and then comes back without kernel records (once
            # in the bf16 d96 forward): profile up to three
            for _ in range(3):
                names = sorted({n.split("(")[0] for n in profile_window(fn)[3]})
                if names:
                    break
            out[label][way] = names
    return out


def flash_f32_phase(dev, shapes):
    """K1's float32 route (one forward launch and one backward call each)
    against the float32 plain versions, at each of `shapes` ({label: (b, sq,
    sk, h, d, dtype)}): float32 rows hold out, lse, dQ, dK and dV within
    F32_TOL of each tensor's largest entry; a bf16 row (the route upcasts
    bf16 at a head dim other than 64) holds the bf16 rule: out within
    FLASH_TOL, lse within 1e-3, each gradient within twice SDPA's bf16
    backward error plus FLASH_BWD_FLOOR. The forward and the backward timed
    beside the plain versions and SDPA in the same dtype, whose kernels
    torch.profiler names; the bound at 165 TFLOP/s (3xTF32) for float32,
    989 for bf16 (bf16 products are what the function needs)."""
    import torch.nn.functional as F

    from vicasplat_tpu_torch.kernels.flash_attn import (
        _forward,
        attention_backward_reference,
        attention_lse_reference,
        attention_reference,
        flash_attention_backward,
    )

    rows = {}
    names = {label: (*shape[:5], str(shape[5]).removeprefix("torch."))
             for label, shape in shapes.items()}
    child = subprocess.Popen([sys.executable, str(pathlib.Path(__file__).resolve()),
                              "--sdpa-kernels", json.dumps(names)],
                             stdout=subprocess.PIPE, text=True)
    try:
        g = torch.Generator(device=dev).manual_seed(8)
        for label, (b, sq, sk, h, d, dtype) in shapes.items():
            t0 = time.perf_counter()
            f32 = dtype == torch.float32
            q, do = (torch.randn(b, sq, h, d, generator=g, device=dev).to(dtype)
                     for _ in range(2))
            k, v = (torch.randn(b, sk, h, d, generator=g, device=dev).to(dtype)
                    for _ in range(2))
            o, lse = _forward(q, k, v, with_lse=True)
            got = flash_attention_backward(q, k, v, o, lse, do)
            torch.cuda.synchronize()
            o_ref, lse_ref = attention_reference(q, k, v), attention_lse_reference(q, k)

            def plain_bwd():
                return attention_backward_reference(q, k, v, o_ref, lse_ref, do)

            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            xs = [x.detach().requires_grad_() for x in (qt, kt, vt)]
            out_lib = F.scaled_dot_product_attention(*xs)
            do_t = do.transpose(1, 2)

            def lib_fwd():
                return F.scaled_dot_product_attention(qt, kt, vt)

            def lib_bwd():
                return torch.autograd.grad(out_lib, xs, do_t, retain_graph=True)

            if f32:
                errs = {"out": rel_err(o, o_ref), "lse": rel_err(lse, lse_ref)}
                errs.update({n: rel_err(a, r) for n, a, r in zip(("dq", "dk", "dv"), got,
                                                                  plain_bwd())})
                bad = [n for n, e in errs.items() if not e < F32_TOL]
                rule = f"tol {F32_TOL}"
            else:
                bwd_errs = flash_bwd_errors(got, plain_bwd(), lib_bwd(),
                                            what=f"K1 bf16 {label}")
                errs = {"out_abs": (o.float() - o_ref).abs().max().item(),
                        "lse_abs": (lse - lse_ref).abs().max().item()}
                errs.update({n: e["rel"] for n, e in bwd_errs.items()})
                bad = [n for n, lim in (("out_abs", FLASH_TOL), ("lse_abs", 1e-3))
                       if not errs[n] < lim]
                rule = (f"out < {FLASH_TOL}, lse < 1e-3, gradients within 2 x SDPA + "
                        f"{FLASH_BWD_FLOOR}")
            if bad:
                raise AssertionError(f"K1 float32 route {label}: {bad} exceed the rule "
                                     f"({rule}): {errs}")
            fwd_ms = cuda_ms(lambda: _forward(q, k, v, with_lse=False))
            bwd_ms = cuda_ms(lambda: flash_attention_backward(q, k, v, o, lse, do))
            dname = str(dtype).removeprefix("torch.")
            shape = f"q ({b}, {sq}, {h}, {d}), k/v ({b}, {sk}, {h}, {d}) {dname}"
            fwd_flops, bwd_flops = 4.0 * b * h * sq * sk * d, 10.0 * b * h * sq * sk * d
            rate = H100_TF32X3_FLOPS if f32 else H100_BF16_FLOPS
            rate_name = ("165 TFLOP/s (3xTF32)" if f32 else "989 TFLOP/s (bf16)")
            size = 4.0 if f32 else 2.0
            fwd = dict(shape=shape, max_abs_err=(o.float() - o_ref).abs().max().item(),
                       errors=errs, ms=fwd_ms,
                       plain_ms=cuda_ms(lambda: attention_reference(q, k, v), iters=5),
                       library_ms=cuda_ms(lib_fwd),
                       library=f"SDPA {dname}",
                       device_ms=queued_ms(lambda: _forward(q, k, v, False)),
                       library_device_ms=queued_ms(lib_fwd), bound_rate=rate_name,
                       tflops=fwd_flops / fwd_ms * 1e-9)
            fwd["bound_ms"], fwd["bound_by"] = bound(
                fwd_flops, rate, size * d * h * b * (2 * sq + 2 * sk))
            bwd = dict(shape=shape, max_abs_err=max((a.float() - r).abs().max().item()
                                                    for a, r in zip(got, plain_bwd())),
                       errors=errs, ms=bwd_ms, plain_ms=cuda_ms(plain_bwd, iters=5),
                       library_ms=cuda_ms(lib_bwd),
                       library=f"SDPA {dname} backward (torch.autograd.grad, kept graph)",
                       device_ms=queued_ms(
                           lambda: flash_attention_backward(q, k, v, o, lse, do)),
                       library_device_ms=queued_ms(lib_bwd), bound_rate=rate_name,
                       tflops=bwd_flops / bwd_ms * 1e-9)
            bwd["bound_ms"], bwd["bound_by"] = bound(
                bwd_flops, rate, size * d * h * b * (4 * sq + 4 * sk) + 4.0 * b * h * sq)
            rows[label] = {"forward": fwd, "backward": bwd, "errors": errs, "rule": rule,
                           "rate": rate_name, "seconds": time.perf_counter() - t0}
            del out_lib, xs
        # each row's line once the child has named SDPA's kernels
        stdout, _ = child.communicate(timeout=300)
    finally:
        if child.poll() is None:  # a failed row: stop the child
            child.kill()
            child.wait()
    if child.returncode != 0:
        raise RuntimeError(f"the SDPA kernel-name child exited {child.returncode}")
    for label, ways in json.loads(stdout.strip().splitlines()[-1]).items():
        r = rows[label]
        for way, kernels in ways.items():
            if not kernels:
                raise AssertionError(f"torch.profiler named no SDPA kernel: {label} {way}")
            r[way]["library_kernels"] = kernels
        fwd, bwd = r["forward"], r["backward"]
        phase("k1-f32", time.perf_counter() - r.pop("seconds"), f"{label} "
              f"{fwd['shape']}: errors " + ", ".join(
                  f"{n} {e:.1e}" for n, e in r.pop("errors").items())
              + f" ({r.pop('rule')}); forward kernel_ms {fwd['ms']:.4f} (device "
              f"{fwd['device_ms']:.4f}) plain_ms {fwd['plain_ms']:.4f} library_ms "
              f"{fwd['library_ms']:.4f} (SDPA {fwd['library_kernels']}, device "
              f"{fwd['library_device_ms']:.4f}) bound_ms {fwd['bound_ms']:.4f} "
              f"({fwd['bound_by']}, {r.pop('rate')}); backward kernel_ms {bwd['ms']:.4f} "
              f"(device {bwd['device_ms']:.4f}) plain_ms {bwd['plain_ms']:.4f} library_ms "
              f"{bwd['library_ms']:.4f} (SDPA {bwd['library_kernels']}, device "
              f"{bwd['library_device_ms']:.4f}) bound_ms {bwd['bound_ms']:.4f} "
              f"({bwd['bound_by']})")
    t0 = time.perf_counter()
    rows["kernels"] = f32_kernel_report()
    phase("k1-f32", t0, "wgmma kernels as built: " + "; ".join(
        f"{k}: {r['registers']} registers, spills {r['spill_store_bytes']}/"
        f"{r['spill_load_bytes']} bytes, {r['dynamic_smem']} B shared, {r['slots']} "
        f"slots, {r['blocks_per_sm']} blocks an SM, {r['hgmma']} HGMMA"
        for k, r in rows["kernels"].items()))
    return rows


def rel_err(a, ref):
    return ((a - ref).abs().max() / ref.abs().max()).item()


def tiny_phase(dev, reset_counts, counts):
    """F3 end to end: the _tiny_smoke widths in float32 on the card through
    K1's float32 route, a forward (held against the same weights on the
    CPU, where attention takes its plain version) and one training step
    from the same weights, with exact launch counts. Returns the phase's
    record and the decoder attention's inputs of the forward."""
    import copy

    from vicasplat_tpu_torch.models import vicanet, vicasplat_forward
    from vicasplat_tpu_torch.training import AdamW, make_train_step
    from vicasplat_tpu_torch.training.presets import (
        tiny_smoke_config,
        tiny_smoke_model,
        tiny_smoke_views,
    )

    t0 = time.perf_counter()
    cfg = tiny_smoke_config()
    depth = cfg.model.backbone.dec_depth
    g = torch.Generator().manual_seed(0)
    model_cpu = tiny_smoke_model(cfg, g)
    model = copy.deepcopy(model_cpu).to(dev)
    ctx_cpu, tgt_cpu = tiny_smoke_views(g, 3), tiny_smoke_views(g, 2)
    batch = {"context": {k: x.to(dev) for k, x in ctx_cpu.items()},
             "target": {k: x.to(dev) for k, x in tgt_cpu.items()}}
    zero = {name: 0 for name in counts()}
    seen = []

    def spy(q, k, v):
        seen.append((q, k, v))
        return attend(q, k, v)

    attend = vicanet.flash_attention
    with torch.no_grad():
        reset_counts()
        with mock.patch.object(vicanet, "flash_attention", spy):
            out = vicasplat_forward(model, batch["context"], dtype=torch.float32)
        torch.cuda.synchronize()
        fwd_launches = counts()
        ref = vicasplat_forward(model_cpu, ctx_cpu, dtype=torch.float32)
    if fwd_launches != dict(zero, flash_attn_f32=depth):
        raise AssertionError(f"tiny forward launches {fwd_launches}")
    errs = {name: rel_err(a.cpu(), r) for name, a, r in (
        ("means", out["gaussians"].means, ref["gaussians"].means),
        ("opacities", out["gaussians"].opacities, ref["gaussians"].opacities),
        ("poses", out["gaussian_camera_extrins"], ref["gaussian_camera_extrins"]))}
    if not all(e < TINY_TOL for e in errs.values()):
        raise AssertionError(f"tiny forward on the card vs CPU: {errs} (tol {TINY_TOL})")

    step = make_train_step(cfg, model, AdamW(model, cfg.optimizer))
    before = [p.detach().clone() for p in model.parameters()]
    reset_counts()
    logs = step(batch, 2)  # past the 2 warm-up steps: lr is not 0
    torch.cuda.synchronize()
    step_launches = counts()
    if step_launches != dict(zero, flash_attn_f32=depth, flash_attn_f32_bwd=depth):
        raise AssertionError(f"tiny train step launches {step_launches}")
    logs = {k: float(v) for k, v in logs.items()}
    changed = sum(int((p != b).sum()) for p, b in zip(model.parameters(), before))
    if int(step.nonfinite) or not all(math.isfinite(v) for v in logs.values()) \
            or not changed:
        raise AssertionError(f"tiny train step: logs {logs}, {int(step.nonfinite)} "
                             f"non-finite gradient entries, {changed} entries changed")
    q, k, v = seen[0]
    r = dict(forward_launches=fwd_launches, step_launches=step_launches,
             forward_vs_cpu=errs, logs=logs, changed=changed,
             attention_shape=[tuple(q.shape), tuple(k.shape)])
    phase("tiny-f32", t0, f"_tiny_smoke widths in float32: forward vs CPU (relative) "
          + ", ".join(f"{n} {e:.1e}" for n, e in errs.items()) + f" (tol {TINY_TOL}); "
          f"launches forward {fwd_launches}, train step {step_launches}; loss "
          f"{logs['loss']:.5f}, {changed} parameter entries changed; decoder "
          f"attention q {tuple(q.shape)} k/v {tuple(k.shape)}")
    return r, (q.detach(), k.detach(), v.detach())


def train_run(dev, cfg, B, V, want, reset_counts, counts):
    """The training phase at batch B x 8 frames and V targets; raises
    torch.cuda.OutOfMemoryError when it does not fit."""
    from vicasplat_tpu_torch.kernels import flash_attn
    from vicasplat_tpu_torch.kernels.flash_attn import (
        attention_reference,
        flash_attention_backward,
    )
    from vicasplat_tpu_torch.models import init_vicasplat, vicanet
    from vicasplat_tpu_torch.models.layers import sdpa
    from vicasplat_tpu_torch.training import AdamW, compute_loss, make_train_step
    from vicasplat_tpu_torch.training.presets import flagship_train_batch

    gen = torch.Generator(device=dev).manual_seed(0)
    model = init_vicasplat(cfg.model, gen, dev)  # float32 parameters
    params = list(model.parameters())
    step = make_train_step(cfg, model, AdamW(model, cfg.optimizer))
    batch = flagship_train_batch(dev, B, V)
    torch.cuda.reset_peak_memory_stats()

    times, steps, seen = [], [], []

    def spy(ctx, do):
        """_FlashAttention.backward, keeping the inputs of the first and the
        last call (remat lets saved_tensors be read only once)."""
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        seen[min(len(seen), 1):] = [(q, k, v, o, lse, do)]
        return flash_attention_backward(q, k, v, o, lse, do)

    for i in range(5):  # 2 warm-ups, then 3 timed
        before = [p.detach().clone() for p in params] if i < 2 else None
        reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        if i == 0:
            with mock.patch.object(flash_attn._FlashAttention, "backward",
                                   staticmethod(spy)):
                logs = step(batch, i)
        else:
            logs = step(batch, i)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        launches = counts()
        if launches != want:
            raise AssertionError(f"train step {i} launches {launches}, not {want}")
        logs = {k: float(v) for k, v in logs.items()}
        if i == 0:  # the plain reference of parallel's world-1 SP and TP steps
            step0 = step_record(model, logs)
        nonfinite = int(step.nonfinite)
        if nonfinite or not all(math.isfinite(v) for v in logs.values()):
            raise AssertionError(f"train step {i}: logs {logs}, {nonfinite} "
                                 "non-finite gradient entries")
        if before is not None:
            changed = sum(int((p != q).sum()) for p, q in zip(params, before))
            # the cosine schedule's warm-up starts at lr 0, as in optax
            if (i == 0) != (changed == 0):
                raise AssertionError(f"step {i} changed {changed} parameter entries")
            del before
        if i >= 2:
            times.append(ms)
        steps.append(dict(ms=ms, logs=logs, launches=launches, changed=changed
                          if i < 2 else None))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    def grad_pass(attend):
        """The whole loss and its gradient's norm by parameter group, and
        the gradient's non-finite entries, with `attend` as the decoder
        attention."""
        with mock.patch.object(vicanet, "flash_attention", attend):
            loss, _ = compute_loss(model, cfg, batch, 5)
            # the deepest refinenets' rcu1 takes no input: no gradient
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        norms, bad = {}, 0
        for (name, _), g in zip(model.named_parameters(), grads):
            key = grad_group(name)
            norms[key] = norms.get(key, 0.0) + (
                0.0 if g is None else float((g.float() ** 2).sum()))
            bad += 0 if g is None else int((~torch.isfinite(g)).sum())
        return dict(loss=float(loss.detach()),
                    **{k: math.sqrt(v) for k, v in norms.items()}), bad

    # K1 against plain attention in one gradient pass of the whole loss at
    # the same weights and batch, SDPA's gap to plain attention the noise
    # floor: the weights after the 5 steps above. The weights after the
    # 6th step are no place for it: there the gradient is non-finite
    # with plain attention and SDPA as much as with K1, and after 1 step
    # (from random init, Adam's first update is the sign of each entry)
    # the three norms part by 35 % (PERF.md §6; measured by
    # vicasplat_tpu_torch/diagnostics/k1_trajectory.py).
    reset_counts()
    ref, bad_ref = grad_pass(lambda q, k, v: attention_reference(q, k, v).to(q.dtype))
    alt, bad_alt = grad_pass(sdpa)
    if any(counts().values()):
        raise AssertionError(f"a swapped gradient pass launched {counts()}")
    got, bad_got = grad_pass(vicanet.flash_attention)
    if bad_ref or bad_alt or bad_got:
        raise AssertionError(f"non-finite gradient entries at the weights after 5 "
                             f"steps: plain {bad_ref}, sdpa {bad_alt}, K1 {bad_got}")
    def rel_gap(a, r):
        # a group whose plain gradient is exactly 0 must be 0 in the other too
        return abs(a - r) / abs(r) if r else (0.0 if a == r else math.inf)

    gap = {k: rel_gap(got[k], ref[k]) for k in ref}
    gap_sdpa = {k: rel_gap(alt[k], ref[k]) for k in ref}
    floor = {k: 1e-4 if k == "loss" else 1e-2 for k in ref}
    tol = {k: 2 * gap_sdpa[k] + floor[k] for k in ref}
    plain_k1 = dict(gap=gap, gap_sdpa=gap_sdpa, tol=tol, kernel=got, plain=ref,
                    sdpa=alt)

    wall, dev_ms, top, kernels = profile_window(lambda: step(batch, 5))
    k1_ms = sum(ms for name, ms in kernels.items() if "flash_" in name)

    # K1's backward on step 0's inputs of the last and the first decoder
    # block, against the float32 plain backward and SDPA's, as in k1-bwd;
    # the backward runs the blocks in reverse: its first call is block 12
    bwd_errs = {label: own_rounding(k1_bwd_held(
        *inputs, what=f"K1 backward on the train step's inputs ({label})"))
                for label, inputs in (("block 12", seen[0]), ("block 1", seen[-1]))}
    del seen
    return dict(k1_bwd_on_step_inputs=bwd_errs, batch=B, targets=V, steps=steps,
                step0=step0, step_ms=times,
                train_step_ms=statistics.median(times), peak_gb=peak_gb,
                profile_wall_ms=wall, device_ms=dev_ms, top=top, k1_device_ms=k1_ms,
                k1_share=k1_ms / dev_ms if dev_ms else None,
                plain_k1=plain_k1)


def train_phase(dev, dec_depth, reset_counts, counts):
    """The flagship training step, cut only as far as memory forces."""
    import gc

    from vicasplat_tpu_torch.training.presets import flagship_train_config

    t0 = time.perf_counter()
    cfg = flagship_train_config()
    want = dict({name: 0 for name in counts()}, flash_attn=2 * dec_depth,
                flash_attn_bwd=dec_depth)
    cuts = []
    for B, V in TRAIN_SHAPES:
        try:
            r = train_run(dev, cfg, B, V, want, reset_counts, counts)
            break
        except torch.cuda.OutOfMemoryError:
            cuts.append(f"batch {B} x {V} targets: out of memory, peak "
                        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
            phase("train", t0, "cut: " + cuts[-1])
        gc.collect()
        torch.cuda.empty_cache()
    else:
        raise AssertionError(f"the training step fits at no allowed size: {cuts}")
    r["cuts"] = cuts
    for i, st in enumerate(r["steps"]):
        phase("train", t0, f"step {i}: {st['ms']:.1f} ms, loss {st['logs']['loss']:.5f}, "
              f"logs {st['logs']}, launches {st['launches']}"
              + ("" if st["changed"] is None else
                 f", parameter entries changed {st['changed']}"))
    phase("train", t0, f"batch {r['batch']} x 8 context frames, {r['targets']} "
          f"targets of 256^2; cuts {cuts or 'none'}; train_step_ms median "
          f"{r['train_step_ms']:.1f} {r['step_ms']}; peak allocated "
          f"{r['peak_gb']:.1f} GB; profiled step: host window "
          f"{r['profile_wall_ms']:.1f} ms, device kernels {r['device_ms']:.1f} ms, "
          f"K1 kernels {r['k1_device_ms']:.2f} ms (share {r['k1_share']:.4f}); top "
          "operators by device ms: " + "; ".join(f"{n} {ms:.2f}" for n, ms in r["top"]))
    for label, errs in r["k1_bwd_on_step_inputs"].items():
        phase("train", t0, f"K1 backward on step 0's own inputs (decoder {label}), "
              "relative errors: " + ", ".join(
                  f"{n} {e['rel']:.2e} (sdpa {e['sdpa_rel']:.2e}, tol "
                  f"{2 * e['sdpa_rel'] + FLASH_BWD_FLOOR:.2e})" for n, e in errs.items()
                  if n != "dq_own") + own_line(errs))
    pk = r["plain_k1"]
    phase("train", t0, "K1 vs plain attention, one gradient pass of the whole loss "
          "at the same weights (after 5 steps) and batch: loss and gradient norms "
          "kernel / sdpa / plain, relative gaps: " + ", ".join(
              f"{k} {pk['kernel'][k]:.4e} / {pk['sdpa'][k]:.4e} / {pk['plain'][k]:.4e} "
              f"(gap {pk['gap'][k]:.2e}, sdpa {pk['gap_sdpa'][k]:.2e}, tol "
              f"{pk['tol'][k]:.2e})" for k in pk["gap"]))
    bad = [k for k in pk["gap"] if not pk["gap"][k] <= pk["tol"][k]]
    if bad:
        raise AssertionError(f"K1 training gradients and the plain ones disagree: {bad}")
    return r


def queued_ms(fn, calls=20, sleep_cycles=200_000_000):
    """The mean device time of one call of fn, every kernel row's device
    timer: the stream first sleeps (torch.cuda._sleep, at least 0.1 s) while
    the host queues `calls` calls behind it, so the events around them time
    the device's work back to back, with no host gaps. (The profiler's
    kernel records, which this script used before, came back incomplete
    after the test-mode runs: half of a dense payload's K2 time, none of a
    trained view's. Its cause was not found.)"""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    t = time.perf_counter()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    # 2e8 cycles last at least 0.1 s at the H100's highest clock (1.98 GHz)
    if host_ms > 50.0:
        raise AssertionError(f"queueing {calls} calls took {host_ms:.2f} ms: "
                             "not all behind the sleep")
    return start.elapsed_time(end) / calls


def profile_window(fn):
    """Run fn once under torch.profiler: (host window ms, device kernel ms,
    top operators by the device time of the kernels they launch, as
    (name, ms), and {kernel name: device ms}). The profiler's own host cost
    widens the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA) / 1e3
    ops = sorted(((e.key, e.self_device_time_total / 1e3) for e in events
                  if e.device_type == DeviceType.CPU and e.self_device_time_total),
                 key=lambda r: -r[1])
    kernels = {e.key: e.self_device_time_total / 1e3 for e in events
               if e.device_type == DeviceType.CUDA}
    return wall_ms, device_ms, ops[:8], kernels


def small_scene():
    """1,000 random splats (SH degree 4) and 2 views of 96 x 128."""
    from vicasplat_tpu_torch.ops.rasterize.projection import cov6_from_scale_rot

    g = torch.Generator().manual_seed(2)
    n = 1000
    means = torch.rand(n, 3, generator=g) * torch.tensor([3.0, 3.0, 4.0]) \
        + torch.tensor([-1.5, -1.5, 2.0])
    cov6 = cov6_from_scale_rot(torch.rand(n, 3, generator=g) * 0.1 + 0.01,
                               torch.randn(n, 4, generator=g))
    sh = torch.randn(n, 3, 25, generator=g) * 0.3
    opac = torch.rand(n, generator=g) * 0.8 + 0.2
    ext = torch.eye(4).repeat(2, 1, 1)
    ext[1, :3, 3] = torch.tensor([0.2, -0.1, 0.3])
    K = torch.tensor([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]]).repeat(2, 1, 1)
    return means, cov6, sh, opac, ext, K


def render_check(dev, cfg):
    """The rasterizer with `cfg` on the card against the same code on the
    CPU (where the kernels take their plain versions), on the small scene:
    (max abs err, its tolerance, alpha mean)."""
    from vicasplat_tpu_torch.ops.rasterize import render
    from vicasplat_tpu_torch.ops.rasterize.projection import project_gaussians

    means, cov6, sh, opac, ext, K = small_scene()

    def run(d):
        return render(means.to(d), cov6.to(d), sh.to(d), opac.to(d), ext.to(d),
                      K.to(d), (96, 128), torch.zeros(3, device=d), 4, cfg=cfg)

    cpu, gpu = run("cpu"), run(dev)
    err = max((a.cpu() - b).abs().max().item() for a, b in zip(gpu, cpu))
    tol = RENDER_TOL
    if cfg.backend != "xla":  # K2's exit drops <= 1e-4 of a feature
        splats = [project_gaussians(means, cov6, sh, opac, torch.linalg.inv(e), k,
                                    (96, 128), 4) for e, k in zip(ext, K)]
        feat = max(max(s.color.abs().max().item(), s.depth.abs().max().item())
                   for s in splats)
        tol += EXIT_T * feat
    return err, tol, cpu[2].mean().item()


def grads_check(dev, cfg):
    """A wiring check of K2's autograd function on the small scene, with a
    learnable background: its forward (K2) against the plain forward of the
    same call, as max abs error, and the gradients of a scalar of the render
    to means, opacities, both pose deltas and the background against the
    plain compositing, as relative max errors. Both backwards are the plain
    recompute, so they show the wiring, not K2's forward."""
    from vicasplat_tpu_torch.kernels import composite_launch
    from vicasplat_tpu_torch.ops.rasterize import render

    means, cov6, sh, opac, ext, K = (x.to(dev) for x in small_scene())
    delta = torch.full((2, 3), 0.01, device=dev)
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)

    def run(c):
        leaves = [means.clone().requires_grad_(), opac.clone().requires_grad_(),
                  delta.clone().requires_grad_(), delta.clone().requires_grad_(),
                  bg.clone().requires_grad_()]
        before = composite_launch.launches
        col, dep, alp = render(leaves[0], cov6, sh, leaves[1], ext, K, (96, 128),
                               leaves[4], 4, cam_rot_delta=leaves[2],
                               cam_trans_delta=leaves[3], cfg=c)
        ((col ** 2).sum() + 1e-2 * dep.sum() + alp.sum()).backward()
        return [col, dep, alp], [x.grad for x in leaves], \
            composite_launch.launches - before

    out, got, launches = run(cfg)
    ref_out, ref, ref_launches = run(dataclasses.replace(cfg, backend="xla"))
    if (launches, ref_launches) != (2, 0):
        raise AssertionError(f"K2 launches {launches} (2 views), plain {ref_launches}")
    fwd = max((a - b).abs().max().item() for a, b in zip(out, ref_out))
    return fwd, {name: ((a - b).abs().max() / b.abs().max()).item()
                 for name, a, b in zip(("means", "opacities", "rot", "trans",
                                        "background"), got, ref)}


def flagship_inputs(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    B, T, size = 1, 8, 256
    images = torch.rand(B, T, size, size, 3, generator=g, device=dev) * 2 - 1
    K = torch.tensor([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]],
                     device=dev).expand(B, T, 3, 3)
    tgt_ext = torch.eye(4, device=dev).repeat(B, N_VIEWS, 1, 1)
    tgt_ext[:, :, 2, 3] = torch.linspace(0.0, 0.5, N_VIEWS, device=dev)
    return {"image": images, "intrinsics": K}, tgt_ext, K[:, :1].expand(
        B, N_VIEWS, 3, 3)


def check_outputs(out, rendered):
    g = out["gaussians"]
    n_gauss = g.means.numel() // 3
    checks = {
        "gaussians": n_gauss == 1 * 8 * 256 * 256 == 524288,
        "extrinsics": tuple(out["gaussian_camera_extrins"].shape) == (1, 8, 4, 4),
        "color": tuple(rendered.color.shape) == (1, N_VIEWS, 256, 256, 3),
        "depth": tuple(rendered.depth.shape) == (1, N_VIEWS, 256, 256),
        "harmonics": tuple(g.harmonics.shape[-2:]) == (3, 25),
    }
    tensors = dict(g._asdict(), poses=out["gaussian_camera_extrins"],
                   color=rendered.color, depth=rendered.depth, alpha=rendered.alpha)
    checks.update({f"finite {k}": bool(torch.isfinite(v).all()) for k, v in
                   tensors.items()})
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"flagship outputs fail: {bad}")
    return n_gauss


def saturation(payload, image_shape, tile_px):
    """(share of pixels, share of tiles all of whose pixels) whose
    transmittance falls under EXIT_T over their tile's payload rows, as the
    plain compositing counts them."""
    from vicasplat_tpu_torch.ops.rasterize.tiles import _tile_pixel_centers

    pix = _tile_pixel_centers(image_shape, tile_px, payload.device)
    p = payload[:, None]
    dx, dy = pix[..., 0:1] - p[..., 0], pix[..., 1:2] - p[..., 1]
    power = -0.5 * (p[..., 2] * dx * dx + p[..., 4] * dy * dy) - p[..., 3] * dx * dy
    a = torch.clamp(p[..., 5] * torch.exp(power.clamp(max=0.0)), max=0.99)
    a = torch.where((power > 0) | (a < 1 / 255), torch.zeros_like(a), a)
    done = torch.log1p(-a).sum(-1) < math.log(EXIT_T)  # (tiles, pixels)
    return done.float().mean().item(), done.all(1).float().mean().item()


def eval_args(name, extra=()):
    """The synthetic_pose test mode on the committed checkpoint, with the
    JAX package's own arguments (tools/jobs/054_nvs_eval_v6_final.py),
    writing under build/chip_smoke_eval/<name>."""
    return ["+experiment=synthetic_pose", "mode=test", "dataset.synthetic.n_scenes=4096",
            f"checkpointing.load={ROOT / EVAL_NPZ}",
            f"test.output_path={ROOT / 'build/chip_smoke_eval' / name}", *extra]


def eval_run(dev, name, extra, reset_counts, counts, keep_first=False, patches=()):
    """The port's main.test on eval_args(name, extra), under `patches`, with
    each scene's kernel launches (and, with keep_first, the first scene's
    batch and result); checks the files and keys it writes."""
    from vicasplat_tpu_torch import main as tmain
    from vicasplat_tpu_torch.evaluation import nvs_eval
    from vicasplat_tpu_torch.utils.config import parse_cli

    cfg = parse_cli(eval_args(name, extra))
    per_scene, first = [], {}
    evaluate = nvs_eval.evaluate_scene

    def counted(model, model_cfg, dec_cfg, eval_cfg, batch, **kw):
        before = counts()
        r = evaluate(model, model_cfg, dec_cfg, eval_cfg, batch, **kw)
        torch.cuda.synchronize()
        after = counts()
        per_scene.append(dict(scene=r["scene"], views=batch["target"]["image"].shape[1],
                              launches={k: after[k] - before[k] for k in after}))
        if keep_first and not first:
            first.update(batch=batch, result=r)
        return r

    reset_counts()
    t = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(nvs_eval, "evaluate_scene", counted))
        for patch in patches:
            stack.enter_context(patch)
        summary, results = tmain.test(cfg, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = counts()
    out = pathlib.Path(cfg.test.output_path)
    bench = json.loads((out / "benchmark.json").read_text())
    memory = json.loads((out / "peak_memory.json").read_text())
    written = json.loads((out / "scores_all_avg.json").read_text())
    missing = [str(f) for f in
               [out / r["scene"] / n for r in results
                for n in ("transforms.json", "compare.png", "color/000.png",
                          "context/000.png")] if not f.exists()]
    if missing or written != json.loads(json.dumps(summary)) \
            or sorted(bench) != ["decoder", "encoder", "pose_align"] \
            or "peak_bytes_in_use" not in memory.get("device_0", {}):
        raise AssertionError(f"test mode outputs: missing {missing[:4]}, benchmark "
                             f"keys {sorted(bench)}, memory {memory}")
    bad = [(r["scene"], k) for r in results for k in ("psnr", "ssim", "ate")
           if not math.isfinite(r.get(k, math.nan))]
    if len(results) != cfg.dataset["synthetic"]["n_test_scenes"] or bad:
        raise AssertionError(f"{len(results)} scenes scored, non-finite {bad}")
    return dict(summary=summary, scenes=results, per_scene=per_scene, launches=launches,
                wall_s=wall, sections={k: v["mean_warm_s"] for k, v in bench.items()},
                section_totals={k: v["total_s"] for k, v in bench.items()},
                peak_gb=memory["device_0"]["peak_bytes_in_use"] / 1e9, first=first,
                cfg=cfg)


def eval_line(name, t0, smi, r):
    scenes = "; ".join(f"{x['scene']} psnr {x['psnr']:.4f} ssim {x['ssim']:.4f} "
                       f"ate {x['ate']:.4f}" for x in r["scenes"])
    m = r["summary"]
    phase(name, t0, f"{scenes}; means psnr {m['psnr']:.4f} ssim {m['ssim']:.4f} ate "
          f"{m['ate']:.4f} rpe_trans {m['rpe_trans']:.4f} rpe_rot {m['rpe_rot']:.4f}; "
          f"launches {r['launches']}")
    phase(name, t0, f"[{smi}] test mode {r['wall_s']:.2f} s; seconds a scene (mean "
          "after the first): " + ", ".join(f"{k} {v:.4f}" for k, v in r["sections"].items())
          + "; totals " + ", ".join(f"{k} {v:.2f}" for k, v in r["section_totals"].items())
          + f"; peak allocated {r['peak_gb']:.3f} GB")


def eval_phases(dev, smi, reset_counts, counts, zero, model_acc, flagship_cfg):
    """Phases eval, eval-accel and eval-flagship (see the module's
    docstring). eval-origin and its rounding floor run in two child
    processes beside eval and eval-accel, and are stopped whatever happens."""
    split_dir = ROOT / "build/chip_smoke_eval/split"
    split_dir.mkdir(parents=True, exist_ok=True)
    children = {name: subprocess.Popen(
        [sys.executable, "-m", "vicasplat_tpu_torch.diagnostics.eval_split", "--run",
         name, "--dir", str(split_dir), "--scenes", str(ACCEL_SCENES)], cwd=ROOT,
        stdout=subprocess.DEVNULL) for name in ("origin", "origin64")}
    try:
        return _eval_phases(dev, smi, reset_counts, counts, zero, model_acc, flagship_cfg,
                            children, split_dir)
    finally:
        for p in children.values():
            if p.poll() is None:
                p.kill()
                p.wait()


def _eval_phases(dev, smi, reset_counts, counts, zero, model_acc, flagship_cfg,
                 children, split_dir):
    from vicasplat_tpu_torch import eval_pose
    from vicasplat_tpu_torch.data.data_module import collate, to_device
    from vicasplat_tpu_torch.data.synthetic_scenes import (
        DatasetSyntheticScenes,
        SyntheticScenesConfig,
    )
    from vicasplat_tpu_torch.data.view_samplers import make_view_sampler
    from vicasplat_tpu_torch.decoder.splatting import (
        DecoderSplattingConfig,
        decoder_forward,
    )
    from vicasplat_tpu_torch.evaluation.nvs_eval import (
        EvalConfig,
        evaluate_scene,
        make_pose_align_step,
        save_scene_outputs,
    )
    from vicasplat_tpu_torch.kernels import bitonic_topk, flash_attention
    from vicasplat_tpu_torch.models import vicanet
    from vicasplat_tpu_torch.ops.rasterize import RasterizeConfig, tiles
    from vicasplat_tpu_torch.ops.rasterize.pallas_composite import composite_tiles_kernel
    from vicasplat_tpu_torch.utils.benchmarker import Benchmarker
    from vicasplat_tpu_torch.utils.config import parse_cli

    render_mod = importlib.import_module("vicasplat_tpu_torch.ops.rasterize.render")
    ref = json.loads((ROOT / EVAL_REF).read_text())
    rec = {}

    # ---- eval: the default render, held to the JAX package's scores ----
    t0 = time.perf_counter()
    dec_depth = parse_cli(eval_args("default")).encoder.backbone.dec_depth
    k1_seen = []

    def k1_spy(q, k, v):
        if len(k1_seen) < dec_depth:  # every block of the first encode
            k1_seen.append((q, k, v))
        return flash_attention(q, k, v)

    r = eval_run(dev, "default", [f"dataset.synthetic.n_test_scenes={EVAL_SCENES}"],
                 reset_counts, counts,
                 patches=[mock.patch.object(vicanet, "flash_attention", k1_spy)])
    steps = r["cfg"].test.pose_align_steps
    want = dict(zero, flash_attn=dec_depth * EVAL_SCENES)
    if r["launches"] != want:
        raise AssertionError(f"eval launches {r['launches']}, not {want}")
    scored = {x["scene"] for x in r["scenes"]}
    ref_mean = {k: statistics.fmean(x[k] for x in ref["scenes"] if x["scene"] in scored)
                for k in EVAL_TOL}
    gaps = {k: abs(r["summary"][k] - ref_mean[k]) for k in EVAL_TOL}
    eval_line("eval", t0, smi, r)
    phase("eval", t0, f"means of {len(scored)} scenes against the JAX reference's of the "
          "same scenes (" + EVAL_REF + "): " + ", ".join(
              f"{k} {r['summary'][k]:.4f} vs {ref_mean[k]:.4f} (gap {gaps[k]:.4f}, tol "
              f"{EVAL_TOL[k]})" for k in EVAL_TOL))
    bad = [k for k in EVAL_TOL if not gaps[k] <= EVAL_TOL[k]]
    if bad:
        raise AssertionError(f"the port's test mode and the JAX reference disagree: {bad}")
    # K1 on the trained encode's own inputs (the first scene's, every block)
    with torch.inference_mode():
        k1t = dict(flash_phase(dev, {"trained": k1_seen})["trained"],
                   launches=r["launches"]["flash_attn"])
    del k1_seen
    # eval_pose on the same arguments, held to the JAX PoseEvaluator
    reset_counts()
    tp = time.perf_counter()
    evaluator = eval_pose.main(eval_args("default"), device=dev)
    torch.cuda.synchronize()
    pose_s, pose_launches = time.perf_counter() - tp, counts()
    pose = evaluator.summary()
    pose_ref = ref["pose_eval"]["summary"]
    pose_file = ROOT / "build/chip_smoke_eval/default_pose/pose_metrics.json"
    written = json.loads(pose_file.read_text()) if pose_file.exists() else None
    pose_gaps = {k: abs(pose[k] - pose_ref[k]) for k in POSE_TOL}
    phase("eval", t0, f"[{smi}] eval_pose {pose_s:.2f} s, launches {pose_launches}; "
          "summary against the JAX PoseEvaluator's: " + ", ".join(
              f"{k} {pose[k]:.4f} vs {pose_ref[k]:.4f} (gap {pose_gaps[k]:.4f}, tol "
              f"{POSE_TOL[k]})" for k in POSE_TOL))
    if written != json.loads(json.dumps(pose)):
        raise AssertionError(f"eval_pose wrote {written}, not its summary {pose}")
    n_pose = parse_cli(eval_args("default")).dataset["synthetic"]["n_test_scenes"]
    if pose_launches != dict(zero, flash_attn=dec_depth * n_pose):
        raise AssertionError(f"eval_pose launches {pose_launches}, not K1 "
                             f"{dec_depth * n_pose}")
    bad = [k for k in POSE_TOL if not pose_gaps[k] <= POSE_TOL[k]]
    if bad:
        raise AssertionError(f"the port's eval_pose and the JAX reference disagree: {bad}")
    rec["eval"] = dict(r, first=None, cfg=None, reference=ref_mean, gaps=gaps,
                       pose_eval=dict(summary=pose, reference=pose_ref, gaps=pose_gaps,
                                      seconds=pose_s, launches=pose_launches))

    # ---- eval-accel: K2 and K4 in every render, held to eval per scene;
    # eval-origin and its rounding floor from the two child processes ----
    t0 = time.perf_counter()
    ra = eval_run(dev, "accel", ["decoder.rasterize.backend=pallas",
                                 "decoder.rasterize.binning=origin",
                                 f"dataset.synthetic.n_test_scenes={ACCEL_SCENES}"],
                  reset_counts, counts, keep_first=True)
    codes = {name: p.wait(timeout=900) for name, p in children.items()}
    if any(codes.values()):
        raise AssertionError(f"eval-origin's child processes exited with {codes}")
    split = {name: json.loads((split_dir / f"{name}.json").read_text())
             for name in children}
    for sc in ra["per_scene"]:
        n = (steps + 1) * sc["views"]
        if sc["launches"] != dict(zero, flash_attn=dec_depth, composite=n,
                                  bitonic_topk=n):
            raise AssertionError(f"eval-accel {sc['scene']} launches {sc['launches']}, "
                                 f"not K1 {dec_depth}, K2 and K4 {n}")

    def gap(a, b):  # the largest per-scene gap of each score
        return {k: max(abs(x[k] - y[k]) for x, y in zip(a, b)) for k in ACCEL_TOL}

    diffs = gap(ra["scenes"], r["scenes"])
    eval_line("eval-accel", t0, smi, ra)
    phase("eval-accel", t0, f"per-scene launches {ra['per_scene'][0]['launches']} "
          "(each scene alike; its seconds were taken beside eval-origin's two child "
          "processes); largest per-scene gap to eval: " + ", ".join(
              f"{k} {diffs[k]:.5f} (tol {ACCEL_TOL[k]})" for k in ACCEL_TOL))
    bad = [k for k in ACCEL_TOL if not diffs[k] <= ACCEL_TOL[k]]
    if bad:
        raise AssertionError(f"eval-accel and eval disagree per scene: {bad}")
    for name, rs in split.items():
        if rs["launches"] != {"flash_attn": dec_depth * ACCEL_SCENES, "composite": 0,
                              "bitonic_topk": 0}:
            raise AssertionError(f"eval-origin ({name}) launches {rs['launches']}")
    origin = split["origin"]["scenes"]
    split_gaps = {"binning": gap(origin, r["scenes"]), "kernels": gap(ra["scenes"], origin),
                  "floor": gap(split["origin64"]["scenes"], origin)}
    kernel_tol = {k: 2 * split_gaps["floor"][k] + KERNEL_FLOOR[k] for k in KERNEL_FLOOR}
    phase("eval-accel", t0, "eval-origin (K2 and K4 swapped for their plain versions, "
          "child processes): means " + ", ".join(
              f"{k} {split['origin']['mean'][k]:.4f}" for k in ACCEL_TOL)
          + "; largest per-scene gaps: " + "; ".join(
              f"{label} " + ", ".join(f"{k} {v:.6f}" for k, v in g.items())
              for label, g in split_gaps.items())
          + "; kernels' limit " + ", ".join(f"{k} {v:.6f}" for k, v in kernel_tol.items()))
    bad = [k for k in kernel_tol if not split_gaps["kernels"][k] <= kernel_tol[k]]
    if bad:
        raise AssertionError(f"eval-accel and eval-origin disagree per scene beyond "
                             f"the rounding floor: {bad}")
    # check C2: eval-accel against the JAX package's own origin binning,
    # scene by scene (tools/jax_eval_reference.py --binning origin), within
    # EVAL_TOL; its gap beside eval's to the JAX default binning (the
    # encoders' share): more than the kernels' floor rule above that would
    # be the port's origin binning's own
    def jax_gap(ours, theirs):
        by_scene = {x["scene"]: x for x in theirs}
        return {k: max(abs(x[k] - by_scene[x["scene"]][k]) for x in ours)
                for k in ACCEL_TOL}

    c2 = jax_gap(ra["scenes"], ref["origin"]["scenes"])
    c2_default = jax_gap(r["scenes"], ref["scenes"])
    above_floor = [k for k in c2 if c2[k] > c2_default[k] + kernel_tol[k]]
    phase("eval-accel", t0, "against the JAX package's origin binning (" + EVAL_REF
          + " 'origin'), largest per-scene gaps: " + ", ".join(
              f"{k} {c2[k]:.6f} (tol {EVAL_TOL[k]}; eval to the JAX default binning "
              f"{c2_default[k]:.6f}, floor rule {kernel_tol[k]:.6f})" for k in c2)
          + f"; origin binning's own gap above the floor rule: {above_floor or 'none'}")
    bad = [k for k in c2 if not c2[k] <= EVAL_TOL[k]]
    if bad:
        raise AssertionError(f"eval-accel and the JAX origin binning disagree per "
                             f"scene: {bad}")
    # one trained view: the first scene's first target after alignment
    cfg = ra["cfg"]
    batch, res = ra["first"]["batch"], ra["first"]["result"]
    tgt = batch["target"]
    seen = {}

    def spy(name, fn):
        def wrapped(*args):
            seen.setdefault(name, args)
            return fn(*args)
        return wrapped

    with torch.inference_mode(), \
            mock.patch.object(tiles, "bitonic_topk", spy("k4", bitonic_topk)), \
            mock.patch.object(render_mod, "composite_tiles_kernel",
                              spy("k2", composite_tiles_kernel)):
        rot, trans = (torch.from_numpy(res["_deltas"][k]).to(dev)[:, :1]
                      for k in ("rot", "trans"))
        view = decoder_forward(cfg.decoder, res["_outputs"]["gaussians"],
                               tgt["extrinsics"][:, :1], tgt["intrinsics"][:, :1],
                               tgt["near"][:, :1], tgt["far"][:, :1], (64, 64),
                               cam_rot_delta=rot, cam_trans_delta=trans)
        rc = cfg.decoder.rasterize
        payload, words = seen["k2"][0], seen["k4"][0]
        pix_sat, tile_sat = saturation(payload, (64, 64), rc.tile_px)
        k2t = composite_phase(dev, {"trained": payload}, (64, 64), rc.tile_px,
                              min(rc.pallas_chunk, rc.max_per_tile), dense=False)["trained"]
        k4t = topk_phase(dev, {"trained": words}, seen["k4"][1])["trained"]
    alpha = view.alpha.float().mean().item()
    phase("eval-accel", t0, f"[{smi}] one trained view ({res['scene']}, target 0, 64^2): "
          f"alpha mean {alpha:.4f}, saturated pixels {pix_sat:.4f}, saturated tiles "
          f"{tile_sat:.4f}; K2 device {k2t['device_ms']:.4f} ms (bound {k2t['bound_ms']:.4f}), "
          f"K4 device {k4t['device_ms']:.4f} ms, torch.sort device "
          f"{k4t['library_device_ms']:.4f} ms")
    rec["eval_accel"] = dict(ra, first=None, cfg=None, gaps_to_eval=diffs,
                             split=dict(gaps=split_gaps, kernel_tol=kernel_tol,
                                        origin_mean=split["origin"]["mean"]),
                             jax_origin=dict(gaps=c2, default_gaps=c2_default,
                                             above_floor_rule=above_floor,
                                             mean=ref["origin"]["mean"]),
                             trained_view=dict(
                                 scene=res["scene"], alpha_mean=alpha,
                                 saturated_pixels=pix_sat, saturated_tiles=tile_sat,
                                 flash_attn=k1t, composite=k2t, bitonic_topk=k4t))
    del ra, batch, res, seen, payload, words

    # ---- eval-flagship: the flagship width on one synthetic 256^2 scene ----
    t0 = time.perf_counter()
    scfg = SyntheticScenesConfig(n_scenes=0, n_val_scenes=0, n_test_scenes=1,
                                 input_image_shape=(256, 256), n_gaussians=524288)
    sampler = make_view_sampler({"name": "sequential", "num_context_views": 8,
                                 "min_distance_between_context_views": 1,
                                 "max_distance_between_context_views": 1}, "test")
    example = next(iter(DatasetSyntheticScenes(scfg, "test", sampler, device=dev)))
    batch = to_device(collate([example]), dev)
    views = batch["target"]["image"].shape[1]
    dec = DecoderSplattingConfig(rasterize=RasterizeConfig(backend="pallas",
                                                           binning="origin"))
    out_dir = ROOT / "build/chip_smoke_eval/flagship"
    ecfg = EvalConfig(output_path=str(out_dir), pose_align_steps=FLAGSHIP_ALIGN_STEPS)
    bench = Benchmarker()
    torch.cuda.reset_peak_memory_stats()
    align = make_pose_align_step(flagship_cfg, dec, ecfg, (256, 256))
    reset_counts()
    rf = evaluate_scene(model_acc, flagship_cfg, dec, ecfg, batch, align_fn=align,
                        benchmarker=bench)
    torch.cuda.synchronize()
    launches = counts()
    save_scene_outputs(rf, batch, ecfg, flagship_cfg)
    n = (FLAGSHIP_ALIGN_STEPS + 1) * views
    want = dict(zero, flash_attn=flagship_cfg.backbone.dec_depth, dpt_tail=1,
                composite=n, bitonic_topk=n)
    if launches != want:
        raise AssertionError(f"eval-flagship launches {launches}, not {want}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    scores = {k: rf[k] for k in ("psnr", "ssim", "ate", "rpe_trans", "rpe_rot",
                                 "coverage_truncated_frac", "coverage_tile_overflow_frac")
              if k in rf}
    files = [out_dir / rf["scene"] / f for f in ("transforms.json", "compare.png",
                                                   "color/000.png", "context/007.png")]
    checks = {
        "finite scores": all(math.isfinite(scores.get(k, math.nan))
                             for k in ("psnr", "ssim", "ate")),
        "gaussians": rf["_outputs"]["gaussians"].means.numel() // 3 == 8 * 256 * 256,
        "rendered": rf["_rendered"].shape == (views, 256, 256, 3),
        "finite render": bool(np.isfinite(rf["_rendered"]).all()),
        "files": all(f.exists() for f in files),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"eval-flagship fails {bad}: scores {scores}")
    secs = {k: v["mean_s"] for k, v in bench.summarize().items()}
    reduced = (f"pose_align_steps {FLAGSHIP_ALIGN_STEPS} of the test config's 100; "
               "one scene")
    phase("eval-flagship", t0, f"[{smi}] {rf['scene']} at 256^2 (524288 Gaussians in the "
          f"scene, 8 context frames, {views} targets) through K1, K3, K2, K4: launches "
          f"{launches}; scores {scores}; seconds " + ", ".join(
              f"{k} {v:.4f}" for k, v in secs.items())
          + f"; peak allocated {peak_gb:.3f} GB; reduced: {reduced}")
    rec["eval_flagship"] = dict(scene=rf["scene"], views=views, launches=launches,
                                scores=scores, seconds=secs, peak_gb=peak_gb,
                                reduced=reduced)
    return rec


def post_npz(port, path, **arrays):
    """POST an npz of `arrays` to the loopback server: (status, JSON answer)."""
    import urllib.error
    import urllib.request

    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=buf.getvalue(),
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def profile_kernel_counts(fn):
    """{kernel: device records} of the repo's kernels in one call of fn
    under torch.profiler (KERNEL_SYMBOLS)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    found = {name: sum(e.count for e in events if sym in e.key)
             for name, sym in KERNEL_SYMBOLS.items()}
    return {k: v for k, v in found.items() if v}


def median_ms(fns, rounds=7, warmup=2):
    """{name: (median ms, all timed ms)} of each fn by CUDA events, the fns
    taken in turns, `warmup` rounds untimed."""
    times = {k: [] for k in fns}
    for i in range(rounds):
        for k, fn in fns.items():
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            if i >= warmup:
                times[k].append(e0.elapsed_time(e1))
    return {k: (statistics.median(v), v) for k, v in times.items()}


def replay_vs_eager(eng, scene, out, images01, K, tgt_ext, tgt_K, plain_tol):
    """The replayed reconstruct against the eager call of the same program,
    and the replayed render against the eager render of the replay's own
    Gaussians: (bit for bit?, distances). Bit for bit is expected; if cuBLAS
    picked other algorithms under capture, the reconstruct is held within
    the plain-k1 rule and the render within RENDER_TOL."""
    B, V = tgt_ext.shape[:2]
    with torch.no_grad():
        g, poses, _ = eng._reconstruct_raw()(images01, K)
        ref = eng._render_raw((256, 256))(
            scene.gaussians, tgt_ext, tgt_K, torch.full((B, V), 0.05, device=K.device),
            torch.full((B, V), 100.0, device=K.device))
    torch.cuda.synchronize()
    exact = (torch.equal(scene.poses, poses)
             and all(torch.equal(a, b) for a, b in zip(scene.gaussians, g))
             and all(torch.equal(a, b) for a, b in zip(out, ref)))
    dist = {"means_rel": ((scene.gaussians.means - g.means).abs().max()
                          / g.means.abs().max()).item(),
            "opacities_abs": (scene.gaussians.opacities - g.opacities).abs().max().item(),
            "poses_abs": (scene.poses - poses).abs().max().item(),
            "color_abs": (out.color - ref.color).abs().max().item()}
    if not exact:
        bad = [m for m in plain_tol if not dist[m] <= plain_tol[m]]
        if bad or not dist["color_abs"] < RENDER_TOL:
            raise AssertionError(f"replay and eager disagree beyond the plain-k1 rule "
                                 f"(reconstruct) and {RENDER_TOL} (render): {dist}")
    return exact, dist


def serve_phase(dev, smi, configs, plain_tol, reset_counts, counts):
    """Phase serve (see the module's docstring): the flagship
    InferenceEngine in both configurations on the script's models."""
    from vicasplat_tpu_torch import serving
    from vicasplat_tpu_torch.ops import quant

    context, tgt_ext, tgt_K = flagship_inputs(dev)
    images01 = ((context["image"] + 1) / 2).contiguous()  # the engine takes [0, 1]
    K = context["intrinsics"].contiguous()
    V = tgt_ext.shape[1]
    rec, engines = {}, {}
    for which, (model, dec) in configs.items():
        t0 = time.perf_counter()
        eng = engines[which] = serving.InferenceEngine(model.cfg, model=model, decoder=dec,
                                                       device=dev)
        dec_depth = model.cfg.backbone.dec_depth
        reset_counts()  # the first request captures both programs
        scene = eng.reconstruct(images01, K)
        out = eng.render(scene, tgt_ext, tgt_K, (256, 256))
        torch.cuda.synchronize()
        seen = counts()
        capture_s = time.perf_counter() - t0
        prog = eng._reconstruct_fn(images01.shape, tuple(K.shape))
        rprog = next(iter(eng._render.items.values()))
        want_r, want_v = {"flash_attn": dec_depth}, {}
        if which == "accel":
            want_r["dpt_tail"] = 1
            want_v = {"composite": V, "bitonic_topk": V}
        if prog.launches != want_r or rprog.launches != want_v:
            raise AssertionError(f"serve {which}: launches at capture {prog.launches} + "
                                 f"{rprog.launches}, not {want_r} + {want_v}")
        idle = [k for k in {**want_r, **want_v} if not seen[k]]
        if idle:
            raise AssertionError(f"serve {which}: kernels {idle} never launched")
        exact, dist = replay_vs_eager(eng, scene, out, images01, K, tgt_ext, tgt_K,
                                      plain_tol)
        prof_r = profile_kernel_counts(lambda: eng.reconstruct(images01, K))
        prof_v = profile_kernel_counts(lambda: eng.render(scene, tgt_ext, tgt_K, (256, 256)))
        if prof_r != want_r or prof_v != want_v:
            raise AssertionError(f"serve {which}: the profiled replays show {prof_r} + "
                                 f"{prof_v}, not {want_r} + {want_v}")
        eager_r, eager_v = eng._reconstruct_raw(), eng._render_raw((256, 256))
        near = torch.full((1, V), 0.05, device=dev)
        far = torch.full((1, V), 100.0, device=dev)

        @torch.no_grad()
        def eager_request():
            g, p, i = eager_r(images01, K)
            return serving.SceneBatch(gaussians=g, poses=p, intrinsics=i)

        med = median_ms({
            "reconstruct_eager": eager_request,
            "reconstruct_replay": lambda: eng.reconstruct(images01, K),
            "render_eager": lambda: torch.no_grad()(eager_v)(
                scene.gaussians, tgt_ext, tgt_K, near, far),
            "render_replay": lambda: eng.render(scene, tgt_ext, tgt_K, (256, 256))})
        busy = {}
        for stage, fn in (("reconstruct", lambda: eng.reconstruct(images01, K)),
                          ("render", lambda: eng.render(scene, tgt_ext, tgt_K, (256, 256)))):
            wall, dev_ms, _, _ = profile_window(fn)
            busy[stage] = {"device_ms": dev_ms, "profiled_wall_ms": wall,
                           "busy_of_median": (dev_ms / med[f"{stage}_replay"][0]
                                              if dev_ms else None)}
        tp = eng.throughput(images01, K)
        pools = {"reconstruct": prog.pool_bytes, "render": rprog.pool_bytes}
        phase("serve", t0, f"[{smi}] {which}: first request (warm-up, capture, replay) "
              f"{capture_s:.2f} s; launches at capture {prog.launches} + {rprog.launches}; "
              f"profiled replays {prof_r} + {prof_v}; replay vs eager: "
              + ("bit for bit" if exact else "within the plain-k1 rule") + f" {dist}")
        phase("serve", t0, f"[{smi}] {which}: medians of 5 (ms): " + ", ".join(
            f"{k} {v[0]:.3f}" for k, v in med.items()) + "; busy share of a replayed "
            "request: " + ", ".join(
                f"{k} " + ("not measured" if v["busy_of_median"] is None else
                           f"{v['device_ms']:.3f} ms device, {v['busy_of_median']:.3f} "
                           "of the median") for k, v in busy.items())
            + f"; throughput {tp}; graph pools (bytes) {pools}")
        rec[which] = {"launches_at_capture": {"reconstruct": prog.launches,
                                              "render": rprog.launches},
                      "profiled_replay": {"reconstruct": prof_r, "render": prof_v},
                      "bit_for_bit": exact, "distances": dist,
                      "medians_ms": {k: v[0] for k, v in med.items()},
                      "times_ms": {k: v[1] for k, v in med.items()}, "busy": busy,
                      "throughput": tp, "pool_bytes": pools, "first_request_s": capture_s}

    # ---- the HTTP endpoint on loopback ----
    t0 = time.perf_counter()
    eng = engines["default"]
    srv = serving.serve(eng, port=0, block=False)
    try:
        port = srv.server_address[1]
        status, body = post_npz(port, "/reconstruct", images=images01.cpu().numpy(),
                                intrinsics=K.cpu().numpy())
        direct = eng.reconstruct(images01, K)
        means = direct.gaussians.means.float().cpu().numpy()
        # the same frames as JPEGs (the port's encoder, quality 95): answered
        # as a direct call on the port's decode of them
        from vicasplat_tpu_torch.utils.host_image import decode_jpegs_u8, encode_jpegs

        u8 = (images01[0].float().cpu().numpy() * 255).round().astype(np.uint8)
        bufs = [np.frombuffer(b, np.uint8) for b in encode_jpegs(u8, quality=95)]
        jstatus, jbody = post_npz(port, "/reconstruct", jpeg_data=np.concatenate(bufs),
                                  jpeg_sizes=np.array([len(b) for b in bufs]),
                                  batch_shape=np.array([1, len(bufs)]),
                                  intrinsics=K.cpu().numpy())
        decoded = torch.from_numpy(decode_jpegs_u8(bufs)[None].astype(np.float32) / 255.0)
        jdirect = eng.reconstruct(decoded.to(dev), K)
        jmeans = jdirect.gaussians.means.float().cpu().numpy()
        bad_jpeg = post_npz(port, "/reconstruct", jpeg_data=np.zeros(16, np.uint8),
                            jpeg_sizes=np.array([16]), batch_shape=np.array([1, 1]))
    finally:
        srv.shutdown()
        srv.server_close()
    checks = {"status 200": status == 200,
              "poses": body.get("poses") == direct.poses.cpu().numpy().tolist(),
              "centers_mean": body.get("centers_mean")
              == np.mean(means, axis=(1, 2, 3)).tolist(),
              "num_gaussians": body.get("num_gaussians") == 8 * 256 * 256,
              "jpeg 200": jstatus == 200,
              "jpeg poses": jbody.get("poses") == jdirect.poses.cpu().numpy().tolist(),
              "jpeg centers_mean": jbody.get("centers_mean")
              == np.mean(jmeans, axis=(1, 2, 3)).tolist(),
              "bad jpeg 400": bad_jpeg[0] == 400}
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"serve HTTP fails {bad}: {status} {jstatus} {bad_jpeg}")
    phase("serve", t0, f"HTTP /reconstruct on loopback: poses and centers_mean equal "
          f"the direct call's, latency_s {body['latency_s']:.4f}; jpeg_data ({len(bufs)} "
          f"frames, {sum(len(b) for b in bufs)} bytes) equal to a direct call on the "
          f"port's decode, latency_s {jbody['latency_s']:.4f}; a corrupt stream answers "
          f"{bad_jpeg[0]}")
    rec["http"] = {"latency_s": body["latency_s"], "jpeg_latency_s": jbody["latency_s"],
                   "bad_jpeg_status": bad_jpeg[0]}

    # ---- W8A8: the quantized engine against the bf16 one ----
    t0 = time.perf_counter()
    model = configs["default"][0]
    qeng = serving.InferenceEngine(model.cfg, model=model, quantize=True, device=dev)
    q = qeng.reconstruct(images01, K)
    b = eng.reconstruct(images01, K)
    torch.cuda.synchronize()
    qdist = {"means_rel": ((q.gaussians.means - b.gaussians.means).abs().max()
                           / b.gaussians.means.abs().max()).item(),
             "means_rel_l2": ((q.gaussians.means - b.gaussians.means).norm()
                              / b.gaussians.means.norm()).item(),
             "poses_abs": (q.poses - b.poses).abs().max().item()}
    if not all(torch.isfinite(x).all() for x in (*q.gaussians, q.poses)):
        raise AssertionError("the quantized reconstruct is not finite")
    qprog = qeng._reconstruct_fn(images01.shape, tuple(K.shape))
    if qprog.launches != {"flash_attn": model.cfg.backbone.dec_depth}:
        raise AssertionError(f"quantized capture launches {qprog.launches}")
    qmed = median_ms({"bf16": lambda: eng.reconstruct(images01, K),
                      "w8a8": lambda: qeng.reconstruct(images01, K)})
    fc1 = model.backbone.enc_blocks[0].mlp.fc1  # the largest flagship linear
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(8 * 257, fc1.in_features, generator=g, device=dev).to(torch.bfloat16)
    ql = quant.quantize_linear(fc1)
    xq = torch.randint(-127, 128, tuple(x.shape), generator=g, device=dev, dtype=torch.int8)
    mm = {"int_mm_ms": cuda_ms(lambda: quant._int8_matmul(xq, ql.w_q)),
          "bf16_matmul_ms": cuda_ms(lambda: torch.matmul(x, fc1.weight.t())),
          "w8a8_linear_ms": cuda_ms(lambda: quant.linear_w8a8(ql, x, torch.bfloat16)),
          "shape": [x.shape[0], fc1.in_features, fc1.out_features]}
    phase("serve", t0, f"[{smi}] quantize=True: {qeng.n_quantized} families int8 (the "
          f"center head kept float), from the bf16 weights; distance to the bf16 engine "
          f"{qdist}; replayed reconstruct medians (ms) bf16 {qmed['bf16'][0]:.3f}, w8a8 "
          f"{qmed['w8a8'][0]:.3f}; one linear {mm}")
    rec["quantize"] = {"n_quantized": qeng.n_quantized, "distance": qdist,
                       "medians_ms": {k: v[0] for k, v in qmed.items()}, "linear": mm}
    for e in (*engines.values(), qeng):
        e.release()
    del engines, qeng, eng, q, b
    torch.cuda.empty_cache()
    return rec


def serve_trained_phase(dev, smi, reset_counts, counts):
    """Phase serve-trained (see the module's docstring)."""
    from vicasplat_tpu_torch import serving
    from vicasplat_tpu_torch.data.data_module import DataModule
    from vicasplat_tpu_torch.data.synthetic_scenes import (
        SyntheticScenesConfig,
        generate_scene,
    )
    from vicasplat_tpu_torch.main import build_model
    from vicasplat_tpu_torch.utils.config import parse_cli

    t0 = time.perf_counter()
    ref = json.loads((ROOT / SERVE_REF).read_text())
    cfg = parse_cli(eval_args("serve"))
    n_req = len(ref["inputs"]["scenes"])
    requests = []
    for batch in DataModule(cfg.dataset, cfg.data_loader, None, device=dev).test_dataloader():
        ctx = batch["context"]
        for i in range(ctx["image"].shape[0]):
            requests.append((batch["scene"][i], ctx["image"][i:i + 1].cpu().numpy(),
                             ctx["intrinsics"][i:i + 1].cpu().numpy()))
        if len(requests) >= n_req:
            break
    requests = requests[:n_req]
    v = ref["inputs"]["video"]
    ds = cfg.dataset["synthetic"]
    fields = {f.name for f in dataclasses.fields(SyntheticScenesConfig)}
    vcfg = SyntheticScenesConfig(**dict(
        {k: (tuple(x) if isinstance(x, list) else x) for k, x in ds.items() if k in fields},
        n_frames=v["n_frames"]))
    video = generate_scene(ds["n_scenes"] + ds["n_val_scenes"] + v["scene_offset"], vcfg,
                           device=dev)
    frames = video["images"].astype(np.float32)
    vK = np.broadcast_to(video["intrinsics"], (frames.shape[0], 3, 3)).astype(np.float32)
    inputs_gap = {"scenes": [s == r["scene"] for (s, _, _), r in
                             zip(requests, ref["inputs"]["scenes"])],
                  "images_sum_rel": max(
                      abs(float(x.astype(np.float64).sum()) / r["images_sum"] - 1)
                      for (_, x, _), r in zip(requests, ref["inputs"]["scenes"])),
                  "video_sum_rel": abs(float(frames.astype(np.float64).sum())
                                       / v["images_sum"] - 1)}
    if not all(inputs_gap["scenes"]) or video["scene"] != v["scene"]:
        raise AssertionError(f"serve-trained inputs are not the reference's: {inputs_gap}")
    rec = {"inputs": inputs_gap}
    # float32 is held to the reference: the JAX engine's own bf16 answers are
    # up to 0.014 from its float32 ones (poses) and 2.5 % (window scales),
    # above the limits, so bf16 gaps are printed, not held
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        t1 = time.perf_counter()
        answers = ref["answers"][dtype_name]
        eng = serving.InferenceEngine(cfg.encoder, model=build_model(cfg, dev), dtype=dtype,
                                      decoder=cfg.decoder, device=dev)
        srv = serving.serve(eng, port=0, block=False)
        reset_counts()
        try:
            port = srv.server_address[1]
            got = [post_npz(port, "/reconstruct", images=x, intrinsics=k)
                   for _, x, k in requests]
            prog = eng._reconstruct_fn((1,) + requests[0][1].shape[1:],
                                       (1,) + requests[0][2].shape[1:])
            calls = prog.calls
            vid = post_npz(port, "/reconstruct_video", images=frames, intrinsics=vK,
                           window=np.int64(v["window"]), overlap=np.int64(v["overlap"]))
        finally:
            srv.shutdown()
            srv.server_close()
        torch.cuda.synchronize()
        seen = counts()
        bad = [s for s, _ in got + [vid] if s != 200]
        if bad:
            raise AssertionError(f"serve-trained {dtype_name}: HTTP status {bad}")
        gaps = {"poses": max(np.abs(np.asarray(b["poses"]) - np.asarray(r["poses"])).max()
                             for (_, b), r in zip(got, answers["reconstruct"])),
                "centers_mean": max(
                    np.abs(np.asarray(b["centers_mean"]) - np.asarray(r["centers_mean"])).max()
                    / np.abs(np.asarray(r["centers_mean"])).max()
                    for (_, b), r in zip(got, answers["reconstruct"])),
                "video_poses": float(np.abs(np.asarray(vid[1]["poses"])
                                            - np.asarray(answers["reconstruct_video"]["poses"])
                                            ).max()),
                "window_scales": float(np.abs(
                    np.asarray(vid[1]["window_scales"])
                    / np.asarray(answers["reconstruct_video"]["window_scales"]) - 1).max())}
        counts_ok = (all(b["num_gaussians"] == r["num_gaussians"] for (_, b), r in
                         zip(got, answers["reconstruct"]))
                     and vid[1]["num_gaussians"]
                     == answers["reconstruct_video"]["num_gaussians"])
        windows = prog.calls - calls
        one_program = len(eng._recon.items) == 1 and windows == len(
            vid[1]["window_scales"]) == 4
        k1 = "flash_attn_f32" if dtype == torch.float32 else "flash_attn"
        k1_ok = (prog.launches == {k1: cfg.encoder.backbone.dec_depth}
                 and seen[k1] == 2 * cfg.encoder.backbone.dec_depth)  # warm-up + capture
        limits = {"poses": SERVE_TOL["poses"], "centers_mean": SERVE_TOL["centers_mean"],
                  "video_poses": SERVE_TOL["poses"],
                  "window_scales": SERVE_TOL["window_scales"]}
        held = dtype == torch.float32
        phase("serve-trained", t1, f"[{smi}] {dtype_name} engine over HTTP: "
              f"{len(got)} held-out scenes and a {frames.shape[0]}-frame video "
              f"({windows} windows, one program: {one_program}); launches at capture "
              f"{prog.launches}, in the run {seen[k1]} ({k1}); gaps to the JAX engine "
              + ("(held)" if held else "(printed, not held)") + ": " + ", ".join(
                  f"{k} {gaps[k]:.3e} (limit {limits[k]})" for k in gaps)
              + f"; num_gaussians equal: {counts_ok}")
        if not (one_program and counts_ok and k1_ok):
            raise AssertionError(f"serve-trained {dtype_name}: one program {one_program}, "
                                 f"counts {counts_ok}, K1 {prog.launches} / {seen[k1]}")
        if held:
            over = [k for k in gaps if not gaps[k] <= limits[k]]
            if over:
                raise AssertionError(f"serve-trained: the port's answers and the JAX "
                                     f"engine's disagree: {over} {gaps}")
        rec[dtype_name] = {"gaps": gaps, "held": held, "windows": windows,
                           "launches_at_capture": prog.launches,
                           "latency_s": [b["latency_s"] for _, b in got],
                           "video_latency_s": vid[1]["latency_s"]}
        eng.release()
    phase("serve-trained", t0, f"inputs against the reference's: {inputs_gap}")
    return rec


def train_mode_args(name, steps, extra=()):
    """The synthetic_pose train mode on the committed checkpoint at the
    experiment's widths, with tools/jax_train_reference.py's cuts (steps,
    checkpoint and validation intervals) and a log line every step, writing
    under build/chip_smoke_train/<name> with the offline logger."""
    out = ROOT / "build/chip_smoke_train" / name
    return ["+experiment=synthetic_pose", "mode=train", f"trainer.max_steps={steps}",
            f"checkpointing.every_n_train_steps={steps}", "trainer.val_check_interval=0",
            "train.print_log_every_n_steps=1", f"output_dir={out}",
            f"checkpointing.output_dir={out}/ckpts", f"checkpointing.load={ROOT / EVAL_NPZ}",
            "wandb.mode=offline", *extra]


def wandb_records(run_dir):
    """{step: the names logged at it} from a wandb run's transaction log
    (run-<id>.wandb, read by wandb's own reader), and whether it holds the
    exit record that run.finish() writes."""
    from wandb.proto import wandb_internal_pb2
    from wandb.sdk.internal import datastore

    log, = run_dir.glob("run-*.wandb")
    ds = datastore.DataStore()
    ds.open_for_scan(str(log))
    steps, finished = {}, False
    while (data := ds.scan_data()) is not None:
        rec = wandb_internal_pb2.Record()
        rec.ParseFromString(data)
        kind = rec.WhichOneof("record_type")
        finished |= kind == "exit"
        if kind == "history":
            steps.setdefault(rec.history.step.num, set()).update(
                it.key or it.nested_key[0] for it in rec.history.item)
    return steps, finished


def wandb_core_children():
    """This process's child processes that run wandb's service."""
    kids = []
    for proc in pathlib.Path("/proc").iterdir():
        try:
            if proc.name.isdigit() and int((proc / "stat").read_text().rsplit(
                    ")", 1)[1].split()[1]) == os.getpid() and b"wandb-core" in (
                    proc / "cmdline").read_bytes():
                kids.append(int(proc.name))
        except (OSError, IndexError, ValueError):
            continue  # a process that ended meanwhile
    return kids


def train_mode_run(dev, argv, reset_counts, counts, keep_batches=()):
    """vicasplat_tpu_torch.main.main(argv) in train mode, with each step's
    kernel launches, seconds (synchronized), NaN-guard count and scene ids,
    and the batches of the steps in `keep_batches` (cloned on the card);
    checks that the loader's threads are gone afterwards."""
    import threading

    from vicasplat_tpu_torch import main as tmain
    from vicasplat_tpu_torch import training
    from vicasplat_tpu_torch.data.data_module import DataModule

    steps, scenes, kept = [], [], {}
    make_step, loader = training.make_train_step, DataModule.train_dataloader

    peak = [0]

    def spying_make(cfg, model, optimizer, lpips_fn=None, teacher_fn=None):
        step = make_step(cfg, model, optimizer, lpips_fn, teacher_fn)

        def counted(batch, global_step, phase="full"):
            if global_step in keep_batches:
                kept[global_step] = {k: {n: x.clone() for n, x in v.items()}
                                     for k, v in batch.items()}
            before = counts()
            torch.cuda.synchronize()
            peak[0] = max(peak[0], torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            logs = step(batch, global_step, phase)
            torch.cuda.synchronize()
            after = counts()
            steps.append(dict(step=global_step, phase=phase,
                              ms=(time.perf_counter() - t) * 1e3,
                              peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                              nonfinite=int(step.nonfinite),
                              launches={k: after[k] - before[k] for k in after},
                              **{k: float(v) for k, v in logs.items()}))
            return logs
        return counted

    def recording_loader(self):
        it = loader(self)
        transfer = it.transfer
        it.transfer = lambda b: (scenes.append(list(b["scene"])), transfer(b))[1]
        return it

    threads = set(threading.enumerate())
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with mock.patch.object(training, "make_train_step", spying_make), \
            mock.patch.object(DataModule, "train_dataloader", recording_loader):
        result = tmain.main(argv, device=dev)
    torch.cuda.synchronize()
    # wandb's service thread is the process's until wandb.teardown()
    left = [th.name for th in set(threading.enumerate()) - threads
            if th.is_alive() and not th.name.startswith(WANDB_SERVICE_THREAD)]
    if left:
        raise AssertionError(f"the train mode left threads running: {left}")
    wandb = sys.modules.get("wandb")
    if wandb is not None and wandb.run is not None:
        raise AssertionError("the train mode did not finish its wandb run")
    for st, sc in zip(steps, scenes):
        st["scenes"] = sc
    # every phase logs these; "distill_only" renders nothing (no mse)
    bad = [st["step"] for st in steps if st["nonfinite"] or not all(
        math.isfinite(st[k]) for k in ("loss", "camera", "psnr", "grad_norm")
        + (("mse",) if st["phase"] != "distill_only" else ()))]
    if bad:
        raise AssertionError(f"non-finite losses or gradient entries at steps {bad}")
    return dict(result=result, steps=steps, kept=kept, launches=counts(),
                wall_s=time.perf_counter() - t,
                peak_gb=max(peak[0], torch.cuda.max_memory_allocated()) / 1e9)


def val_visual_sizes(val: pathlib.Path) -> dict:
    """Bytes of the validation step's projections, camera figure and
    interpolation video (an mp4, or a directory of PNG frames without
    OpenCV); 0 where one is missing."""
    video = val / "interpolation.mp4"
    frames = video.with_suffix("")
    return {"projections.png": (val / "projections.png").stat().st_size
            if (val / "projections.png").exists() else 0,
            "cameras.png": (val / "cameras.png").stat().st_size
            if (val / "cameras.png").exists() else 0,
            "interpolation": video.stat().st_size if video.exists() else
            sum(f.stat().st_size for f in frames.glob("*.png")) if frames.is_dir() else 0}


def train_mode_phase(dev, smi, reset_counts, counts, zero):
    """Phase train-mode (see the module's docstring)."""
    import shutil
    import threading

    from vicasplat_tpu_torch import main as tmain
    from vicasplat_tpu_torch.kernels import flash_attn
    from vicasplat_tpu_torch.kernels.flash_attn import flash_attention_backward
    from vicasplat_tpu_torch.training import make_train_step
    from vicasplat_tpu_torch.utils.checkpointing import is_full_state, restore_train_state
    from vicasplat_tpu_torch.utils.config import parse_cli

    t0 = time.perf_counter()
    n = TRAIN_MODE_STEPS
    ref = json.loads((ROOT / TRAIN_REF).read_text())
    # the reference ran the same experiment, checkpoint and cuts
    differ = [o for o in ref["overrides"] if o not in train_mode_args("unbroken", n)]
    if differ or ref["checkpoint"] != EVAL_NPZ or len(ref["steps"]) != n:
        raise AssertionError(f"{TRAIN_REF} ran other arguments: {differ}")
    shutil.rmtree(ROOT / "build/chip_smoke_train", ignore_errors=True)
    # wandb's per-user cache, config and data directories, in the checkout
    for var in ("WANDB_CACHE_DIR", "WANDB_CONFIG_DIR", "WANDB_DATA_DIR"):
        os.environ[var] = str(ROOT / "build/chip_smoke_train/wandb_home")
    # ---- the unbroken run: full state at n/2 and n, validation at n ----
    argv = train_mode_args("unbroken", n, [f"checkpointing.every_n_train_steps={n // 2}",
                                           "checkpointing.save_weights_only=false",
                                           f"trainer.val_check_interval={n}"])
    cfg = parse_cli(argv)
    dec_depth = cfg.encoder.backbone.dec_depth
    seen = []

    def spy(ctx, do):  # K1's backward on the first step's own inputs
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        if len(seen) < dec_depth:
            seen.append(tuple(x.detach().clone() for x in (q, k, v, o, lse, do)))
        return flash_attention_backward(q, k, v, o, lse, do)

    with mock.patch.object(flash_attn._FlashAttention, "backward", staticmethod(spy)):
        ra = train_mode_run(dev, argv, reset_counts, counts, keep_batches=range(n // 2, n))
    want_step = dict(zero, flash_attn=dec_depth, flash_attn_bwd=dec_depth)
    bad = [st["step"] for st in ra["steps"] if st["launches"] != want_step]
    want = dict(zero, flash_attn=dec_depth * (n + 1), flash_attn_bwd=dec_depth * n)
    if bad or ra["launches"] != want or len(ra["steps"]) != n:
        raise AssertionError(f"train mode launches {ra['launches']} (steps {bad} off "
                             f"{want_step}), not {want}")
    out = ROOT / "build/chip_smoke_train/unbroken"
    ckpts = sorted(p.name for p in (out / "ckpts").glob("step_*.npz"))
    wandb = sys.modules.get("wandb")  # imported by the logger where installed
    if wandb is not None:  # a real offline wandb run under output_dir/wandb
        runs = list((out / "wandb").glob("offline-run-*"))
        history, finished = wandb_records(runs[0]) if len(runs) == 1 else ({}, False)
        media = runs[0] / "files/media/images/val" if runs else out
        logger_ok = finished and any(media.glob("comparison_*.png"))
    else:  # the port's offline run directory
        runs = list((out / "wandb_offline").glob("run-*"))
        history = {}
        for x in ((runs[0] / "history.jsonl").read_text().splitlines()
                  if len(runs) == 1 else []):
            h = json.loads(x)
            history.setdefault(h.pop("_step"), set()).update(h)
        logger_ok = len(runs) == 1 and (runs[0] / "summary.json").exists() and any(
            (runs[0] / "media/val_comparison").glob("*.png"))
    logged = sorted(st for st, names in history.items()
                    if {"train/loss", "train/grad_norm", "train/lr"} <= names)
    logger_kind = "wandb " + wandb.__version__ if wandb is not None else "offline"
    val = out / f"val/step_{n:07d}"
    visuals = val_visual_sizes(val)
    files = {"ckpts": ckpts == [f"step_{s:08d}.npz" for s in (n // 2, n)]
             and all(is_full_state(out / "ckpts" / c) for c in ckpts),
             "comparison.png": (val / "comparison.png").exists(),
             **{name: size > 0 for name, size in visuals.items()},
             "logger": logger_ok and logged == list(range(1, n + 1))
             and "val/comparison" in history.get(n, ())}
    if not all(files.values()):
        raise AssertionError(f"train mode outputs: {files}, checkpoints {ckpts}, "
                             f"{logger_kind} logger's steps {sorted(history)}, with "
                             f"every train scalar {logged}")
    # each step's logged scalars against the JAX package's loop
    gaps = []
    for st, rs in zip(ra["steps"], ref["steps"]):
        if st["scenes"] != rs["scenes"]:
            raise AssertionError(f"step {st['step']} batch {st['scenes']}, the JAX "
                                 f"reference's {rs['scenes']}")
        gaps.append({"step": rs["step"], "psnr": abs(st["psnr"] - rs["psnr"]),
                     **{k: abs(st[k] - rs[k]) / abs(rs[k])
                        for k in TRAIN_LOSS_TOL if k != "psnr"},
                     "port": {k: st[k] for k in TRAIN_LOSS_TOL},
                     "jax": {k: rs[k] for k in TRAIN_LOSS_TOL}})
    worst = {k: max(g[k] for g in gaps) for k in TRAIN_LOSS_TOL}
    ms = [st["ms"] for st in ra["steps"]]
    phase("train-mode", t0, f"[{smi}] {n} steps of batch 8 (4 context frames, 2 targets, "
          f"64^2) from the committed checkpoint: launches {ra['launches']}; per step, "
          "port (JAX): " + "; ".join(
              f"{g['step']}: " + ", ".join(f"{k} {g['port'][k]:.6f} ({g['jax'][k]:.6f})"
                                          for k in TRAIN_LOSS_TOL) for g in gaps)
          + "; largest gaps " + ", ".join(
              f"{k} {worst[k]:.2e} (tol {TRAIN_LOSS_TOL[k]})" for k in TRAIN_LOSS_TOL)
          + f" (psnr in dB, the others relative); step ms {ms}; wall {ra['wall_s']:.2f} s; "
          f"peak allocated {ra['peak_gb']:.3f} GB; logger {logger_kind}; files {files}; "
          f"validation visuals (bytes) {visuals}")
    bad = [k for k in TRAIN_LOSS_TOL if not worst[k] <= TRAIN_LOSS_TOL[k]]
    if bad or len(gaps) != n:
        raise AssertionError(f"the train mode and the JAX reference disagree: {bad}")
    # K1's backward on the first step's inputs (blocks 4 to 1), the k1-bwd rule
    bwd = {}
    for j, inputs in enumerate(seen):
        bwd[f"block {dec_depth - j}"] = own_rounding(k1_bwd_held(
            *inputs,
            what=f"K1 backward on the train mode's inputs (block {dec_depth - j})"))
    shape = tuple(seen[0][0].shape)
    del seen
    phase("train-mode", t0, f"K1 backward on step 1's own inputs, q {shape} bf16, "
          "relative errors: " + "; ".join(
              f"{label} " + ", ".join(f"{nm} {e['rel']:.2e} (tol "
                                      f"{2 * e['sdpa_rel'] + FLASH_BWD_FLOOR:.2e})"
                                      for nm, e in errs.items() if nm != "dq_own")
              + own_line(errs) for label, errs in bwd.items()))
    # ---- the resume, bit for bit: the state saved at n/2, then the
    # unbroken run's own batches of the steps after it ----
    train_cfg, model, optimizer = tmain.build_all(cfg, dev)
    start = restore_train_state(out / "ckpts" / f"step_{n // 2:08d}.npz", model, optimizer)
    step = make_train_step(train_cfg, model, optimizer)
    reset_counts()
    for s in range(start, n):
        step(ra["kept"][s], s)
    torch.cuda.synchronize()
    if counts() != dict(zero, flash_attn=dec_depth * (n - start),
                        flash_attn_bwd=dec_depth * (n - start)):
        raise AssertionError(f"resumed steps launched {counts()}")
    ua, ub = ra["result"]["optimizer"], optimizer
    same = {"start": start == n // 2, "count": ub.count == ua.count == n}
    for name, a, b in (("params", dict(ra["result"]["model"].named_parameters()),
                        dict(model.named_parameters())),
                       ("mu", ua.mu, ub.mu), ("nu", ua.nu, ub.nu)):
        same[name] = all(torch.equal(a[k], b[k]) for k in a)
    phase("train-mode", t0, f"resume from step {start}'s full state, steps {start}..{n - 1} "
          f"on the unbroken run's batches: equal bit for bit {same}")
    if not all(same.values()):
        raise AssertionError(f"the resumed run and the unbroken one differ: {same}")
    # the resumed run's device time: one more step under the profiler
    wall, dev_ms, top, _ = profile_window(lambda: step(ra["kept"][n - 1], n))
    del model, optimizer, step
    # ---- the resume through the train mode: a weights-only snapshot ----
    res_dir = ROOT / "build/chip_smoke_train/resumed"
    (res_dir / "ckpts").mkdir(parents=True)
    shutil.copy(out / "ckpts" / f"step_{n // 2:08d}.npz", res_dir / "ckpts")
    rb = train_mode_run(dev, train_mode_args("resumed", n, ["checkpointing.resume=true"]),
                        reset_counts, counts)
    snap = res_dir / "ckpts" / f"step_{n:08d}.npz"
    want = dict(zero, flash_attn=dec_depth * (n - n // 2),
                flash_attn_bwd=dec_depth * (n - n // 2))
    if rb["launches"] != want or [st["step"] for st in rb["steps"]] != list(
            range(n // 2, n)) or not snap.exists() or is_full_state(snap):
        raise AssertionError(f"resumed train mode: launches {rb['launches']}, steps "
                             f"{[st['step'] for st in rb['steps']]}, snapshot {snap}")
    if wandb is not None:  # stop the service the train mode's wandb runs started
        wandb.teardown()
        left = [th.name for th in threading.enumerate()
                if th.name.startswith(WANDB_SERVICE_THREAD)]
        if left or wandb_core_children():
            raise AssertionError(f"wandb.teardown() left threads {left}, processes "
                                 f"{wandb_core_children()}")
    # ---- the test mode on the snapshot the train mode wrote ----
    reset_counts()
    summary, results = tmain.main(
        ["+experiment=synthetic_pose", "mode=test", "dataset.synthetic.n_scenes=4096",
         "dataset.synthetic.n_test_scenes=1", f"checkpointing.load={snap}",
         f"test.pose_align_steps={TRAIN_TEST_ALIGN_STEPS}",
         f"test.output_path={ROOT / 'build/chip_smoke_train/test'}"], device=dev)
    torch.cuda.synchronize()
    test_launches = counts()
    if test_launches != dict(zero, flash_attn=dec_depth) or len(results) != 1 or not all(
            math.isfinite(summary.get(k, math.nan)) for k in ("psnr", "ssim", "ate")):
        raise AssertionError(f"test mode on the snapshot: launches {test_launches}, "
                             f"summary {summary}")
    phase("train-mode", t0, f"[{smi}] resumed train mode (steps {n // 2}..{n - 1}, "
          f"loader restarted) launches {rb['launches']}, losses "
          f"{[round(st['loss'], 6) for st in rb['steps']]}, weights-only snapshot "
          f"{snap.name}; test mode on it ({results[0]['scene']}, "
          f"{TRAIN_TEST_ALIGN_STEPS} alignment steps): psnr {summary['psnr']:.4f} ssim "
          f"{summary['ssim']:.4f} ate {summary['ate']:.4f}, launches {test_launches}; "
          f"one step profiled: host window {wall:.2f} ms, device kernels {dev_ms:.2f} ms "
          f"(busy share {dev_ms / wall:.3f}); top operators by device ms: "
          + "; ".join(f"{nm} {t:.3f}" for nm, t in top))
    return dict(steps=[{k: v for k, v in st.items() if k != "launches"}
                       for st in ra["steps"]], gaps=gaps, worst=worst,
                launches=ra["launches"], step_ms=ms,
                step_ms_median=statistics.median(ms), peak_gb=ra["peak_gb"],
                wall_s=ra["wall_s"], files=files, visuals=visuals,
                k1_bwd_on_step_inputs=bwd,
                resume_equal=same, profiled_step=dict(host_ms=wall, device_ms=dev_ms,
                                                      busy_share=dev_ms / wall, top=top),
                resumed=dict(launches=rb["launches"],
                             losses=[st["loss"] for st in rb["steps"]]),
                test=dict(summary=summary, launches=test_launches,
                          align_steps=TRAIN_TEST_ALIGN_STEPS),
                reduced=f"trainer.max_steps {n}, checkpoints every {n // 2} steps, "
                        f"validation every {n} steps; the test mode on 1 scene with "
                        f"{TRAIN_TEST_ALIGN_STEPS} alignment steps")


def video_frames(path: pathlib.Path) -> int:
    """Frames of a video `save_video` wrote: an mp4 read back by OpenCV, or
    its directory of PNG frames where OpenCV is absent."""
    if path.exists():
        import cv2

        cap = cv2.VideoCapture(str(path))
        n = 0
        while cap.read()[0]:
            n += 1
        cap.release()
        return n
    return len(list(path.with_suffix("").glob("*.png")))


def demo_outputs(out_dir: pathlib.Path, n_frames: int, n_kept: int) -> dict:
    """The demo's four outputs read back: the PLY's splats, transforms.json's
    frames, the GLB's meshes (centres + one a camera) and the video's
    frames."""
    from vicasplat_tpu_torch.utils.ply import read_ply
    from vicasplat_tpu_torch.visualization.glb import read_glb_json

    ply = read_ply(out_dir / "gaussians.ply")
    got = {"ply_splats": int(ply["means"].shape[0]),
           "ply_finite": bool(all(np.isfinite(v).all() for v in ply.values())),
           "transforms_frames": len(json.loads(
               (out_dir / "transforms.json").read_text())["frames"]),
           "glb_meshes": len(read_glb_json(out_dir / "xyz_and_camera.glb")["meshes"]),
           "video_frames": video_frames(out_dir / "render.mp4"),
           "ply_bytes": (out_dir / "gaussians.ply").stat().st_size}
    want = {"ply_splats": n_kept, "ply_finite": True, "transforms_frames": n_frames,
            "glb_meshes": 1 + n_frames}
    bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
    if bad:
        raise AssertionError(f"demo outputs in {out_dir}: (got, want) {bad}")
    return got


def demo_phase(dev, smi, reset_counts, counts, zero):
    """Phase demo (see the module's docstring): the port's demo CLI on PNG
    frames of the synthetic generator's scene 0, a short clip through one
    forward and a long one through the streaming route."""
    import tempfile

    from vicasplat_tpu_torch import demo
    from vicasplat_tpu_torch.data import synthetic_scenes as scenes
    from vicasplat_tpu_torch.decoder.splatting import DecoderSplattingConfig, decoder_forward
    from vicasplat_tpu_torch.models import VicaNetConfig
    from vicasplat_tpu_torch.utils.image_io import encode_png, to_uint8

    t0 = time.perf_counter()
    dec_depth = VicaNetConfig().dec_depth  # the demo CLI's flagship
    scfg = scenes.SyntheticScenesConfig(input_image_shape=DEMO_FRAME_HW,
                                        n_frames=DEMO_LONG, n_gaussians=16384)
    frames = to_uint8(scenes.generate_scene(0, scfg, device=dev)["images"])
    res = {"frame_hw": list(DEMO_FRAME_HW)}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = pathlib.Path(tmp)
        for clip, n in (("short", DEMO_SHORT), ("long", DEMO_LONG)):
            (tmp / clip).mkdir()
            for i in range(n):
                (tmp / clip / f"{i:03d}.png").write_bytes(encode_png(frames[i]))
        # ---- the short clip: one bf16 forward, the 57-view trajectory ----
        reset_counts()
        t1 = time.perf_counter()
        r = demo.main(["--image_dir", str(tmp / "short"), "--output_dir",
                       str(tmp / "out_short")], device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = counts()
        g, traj = r["gaussians"], r["trajectory"]
        V = traj.shape[0]
        want = dict(zero, flash_attn=dec_depth)
        if launches != want or V != (DEMO_SHORT - 1) * 8 + 1:
            raise AssertionError(f"demo: launches {launches} (want {want}), {V} views")
        files = demo_outputs(tmp / "out_short", DEMO_SHORT, r["n_kept"])
        if files["video_frames"] != V or not np.isfinite(r["frames"]).all():
            raise AssertionError(f"demo video: {files['video_frames']} frames of {V}")
        # the trajectory render again, timed and profiled (no kernel of the
        # port: the default DecoderSplattingConfig)
        K = torch.from_numpy(demo.intrinsics_from_fov(60.0)).to(dev).expand(1, V, 3, 3)
        near = torch.full((1, V), 0.05, device=dev)
        far = torch.full((1, V), 100.0, device=dev)

        @torch.no_grad()
        def render():
            return decoder_forward(DecoderSplattingConfig(), g, traj[None], K, near, far,
                                   (256, 256))

        render_ms = median_ms({"render": render}, rounds=3, warmup=1)["render"]
        pw, pdev, top, _ = profile_window(render)
        res["short"] = dict(
            wall_s=wall, seconds=r["seconds"], launches=launches, views=V,
            gaussians=int(g.opacities.numel()), files=files, coverage=r["coverage"],
            render_ms=render_ms[0], render_device_ms=pdev,
            render_device_ms_per_view=pdev / V, render_busy=pdev / render_ms[0])
        phase("demo", t0, f"[{smi}] {DEMO_SHORT} PNG frames of {DEMO_FRAME_HW[0]}x"
              f"{DEMO_FRAME_HW[1]} -> 256^2, main(argv) {wall:.2f} s "
              f"(reconstruct {r['seconds']['reconstruct']:.2f}, export "
              f"{r['seconds']['export']:.2f}, render {r['seconds']['render']:.2f}); "
              f"launches {launches}; {res['short']['gaussians']} Gaussians, "
              f"{r['n_kept']} in the PLY ({files['ply_bytes']} bytes); transforms "
              f"{files['transforms_frames']} frames; GLB {files['glb_meshes']} meshes; "
              f"video {files['video_frames']} frames; the {V}-view render median "
              f"{render_ms[0]:.2f} ms {render_ms[1]}, device {pdev:.2f} ms "
              f"({pdev / V:.3f} a view, busy {pdev / render_ms[0]:.3f}); coverage "
              + ", ".join(f"{k} {v:.4f}" for k, v in r["coverage"].items()))
        del r, g, traj
        # ---- the long clip: windows through the serving engine ----
        reset_counts()
        t1 = time.perf_counter()
        r = demo.main(["--image_dir", str(tmp / "long"), "--output_dir",
                       str(tmp / "out_long"), "--window", "8", "--overlap", "2"],
                      device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = counts()
        # the engine's one program: its eager warm-up and its capture launch
        # K1 once a block each; every window replays it
        want = dict(zero, flash_attn=2 * dec_depth)
        V = r["trajectory"].shape[0]
        files = demo_outputs(tmp / "out_long", DEMO_LONG, r["n_kept"])
        if launches != want or r["windows"]["count"] < 2 or files["video_frames"] != V:
            raise AssertionError(f"demo streaming: launches {launches} (want {want}), "
                                 f"windows {r['windows']}, video {files['video_frames']}")
        res["long"] = dict(wall_s=wall, seconds=r["seconds"], launches=launches,
                           windows=r["windows"], views=V, files=files)
        phase("demo", t0, f"[{smi}] {DEMO_LONG} frames, window 8, overlap 2: "
              f"{r['windows']['count']} windows (scales "
              f"{[round(x, 4) for x in r['windows']['scales']]}), main(argv) "
              f"{wall:.2f} s; launches {launches} (the program's warm-up and capture; "
              f"the windows replay it); PLY {r['n_kept']} splats, transforms "
              f"{files['transforms_frames']} frames, video {files['video_frames']} frames")
        del r
    torch.cuda.empty_cache()
    return res


# imports torch and the port's kernels only (as `export.load_exported` does):
# loads the artifacts, calls them with the engine's weights, counts the
# kernels under torch.profiler and by the launch counters
EXPORT_CHILD = """
import json, pathlib, sys, time
import torch
t_import = time.perf_counter()
import vicasplat_tpu_torch.kernels as kernels  # registers torch.ops.vicasplat.*
from torch.autograd import DeviceType
from torch.export.passes import move_to_device_pass
from torch.profiler import ProfilerActivity, profile

d = pathlib.Path(sys.argv[1])
symbols = json.loads(sys.argv[2])
dev = torch.device("cuda", 0)
torch.backends.cudnn.allow_tf32 = False  # as the parent: float32 convs in full float32
res = {}

def on_dev(x):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: on_dev(v) for k, v in x.items()}
    return type(x)(on_dev(v) for v in x)

def profiled(fn):
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    found = {n: sum(e.count for e in ev if s in e.key) for n, s in symbols.items()}
    return out, {k: v for k, v in found.items() if v}

weights = on_dev(torch.load(d / "weights.pt", weights_only=True))
for name in ("reconstruct", "render"):
    t = time.perf_counter()
    ep = torch.export.load(str(d / f"{name}.pt2"))
    load_s = time.perf_counter() - t
    prog = ep.module()
    args = on_dev(torch.load(d / f"{name}_args.pt", weights_only=True))
    if name == "reconstruct":
        args = (weights, *args)
    with torch.no_grad():
        prog(*args)  # first call
        torch.cuda.synchronize()
        for fn, attr in kernels.COUNTERS.values():
            setattr(fn, attr, 0)
        out, prof = profiled(lambda: prog(*args))
    res[name] = {"load_s": load_s, "profiled": prof, "counted": kernels.launch_counts()}
    torch.save(out, d / f"{name}_out.pt")
    del ep, prog, out
# the tiny float32 artifact exported on the CPU, moved to the card
ep = move_to_device_pass(torch.export.load(str(d / "tiny.pt2")), dev)
tw = on_dev(torch.load(d / "tiny_weights.pt", weights_only=True))
targs = on_dev(torch.load(d / "tiny_args.pt", weights_only=True))
with torch.no_grad():
    for fn, attr in kernels.COUNTERS.values():
        setattr(fn, attr, 0)
    out, prof = profiled(lambda: ep.module()(tw, *targs))
res["tiny"] = {"profiled": prof, "counted": kernels.launch_counts()}
torch.save(out, d / "tiny_out.pt")
res["modules"] = sorted(m for m in sys.modules if m.startswith("vicasplat_tpu")
                        and not m.startswith("vicasplat_tpu_torch.kernels"))
res["models_imported"] = "vicasplat_tpu_torch.models" in sys.modules
print(json.dumps(res))
"""


def max_gap(a, b) -> float:
    """Largest absolute difference over matching tensors of two trees."""
    if isinstance(a, dict):
        return max(max_gap(a[k], b[k]) for k in a)
    return (a.float() - b.float()).abs().max().item()


# a fresh process that exports one of the engine's programs: on an H100
# the render's trace and save took 101-107 s inside this script's process
# after its earlier phases, against 21-43 s in a fresh one, for the same
# graph and bytes. argv: directory, "reconstruct" or "render" (the render's
# process also exports the tiny float32 model on the CPU)
EXPORT_TRACE_CHILD = """
import json, pathlib, sys, time
import torch
from vicasplat_tpu_torch import export, serving
from vicasplat_tpu_torch.models import GaussianAdapterConfig, VicaNetConfig, VicaSplatConfig

d, which = pathlib.Path(sys.argv[1]), sys.argv[2]
spec = torch.load(d / "spec.pt", weights_only=False)
dev = torch.device("cuda", 0)
torch.backends.cudnn.allow_tf32 = False
res = {}
if which == "reconstruct":
    eng = serving.InferenceEngine(spec["cfg"], device=dev)
    eng.model.load_state_dict(torch.load(d / "weights.pt", weights_only=True))
    t = time.perf_counter()
    blob = export.export_reconstruct(eng, *spec["images_shape"][:4], with_intrinsics=True)
    res["trace_s"] = time.perf_counter() - t
else:  # the render reads no weight: the engine's random ones serve
    eng = serving.InferenceEngine(spec["cfg"], decoder=spec["dec"], device=dev)
    t = time.perf_counter()
    blob = export.export_render(eng, spec["scene_dims"], spec["views"], (256, 256))
    res["trace_s"] = time.perf_counter() - t
    tcfg = VicaSplatConfig(backbone=VicaNetConfig(**spec["tiny_net"]),
                           gaussian_adapter=GaussianAdapterConfig(sh_degree=1))
    teng = serving.InferenceEngine(tcfg, dtype=torch.float32, device="cpu")
    t = time.perf_counter()
    export.save_exported(d / "tiny.pt2", export.export_reconstruct(
        teng, 1, 3, 32, 32, with_intrinsics=True))
    res["trace_s_tiny_cpu"] = time.perf_counter() - t
    torch.save(export.weights(teng), d / "tiny_weights.pt")
    t_im = torch.rand(1, 3, 32, 32, 3, generator=torch.Generator().manual_seed(3))
    t_K = torch.tensor([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]]).expand(
        1, 3, 3, 3).contiguous()
    torch.save((t_im, t_K), d / "tiny_args.pt")
    with torch.no_grad():
        g, poses, _ = teng._reconstruct_raw()(t_im, t_K)
    torch.save({"gaussians": dict(g._asdict()), "poses": poses}, d / "tiny_ref.pt")
    res["tiny_dec_depth"] = tcfg.backbone.dec_depth
export.save_exported(d / f"{which}.pt2", blob)
res["bytes"] = len(blob)
print(json.dumps(res))
"""


def export_start(dev, model_acc, dec_acc) -> dict:
    """Phase export, first half (see the module's docstring): the eager
    engine's outputs to compare with, the weights and inputs saved, and two
    fresh processes started that export the reconstruct and the 12-view
    render (and a tiny float32 model on the CPU); they run beside the demo
    phase and the next ones up to train."""
    import tempfile

    from vicasplat_tpu_torch import export, serving

    t0 = time.perf_counter()
    context, tgt_ext, tgt_K = flagship_inputs(dev)
    images01 = ((context["image"] + 1) / 2).contiguous()
    K = context["intrinsics"].contiguous()
    B, V = tgt_ext.shape[:2]
    near = torch.full((B, V), 0.05, device=dev)
    far = torch.full((B, V), 100.0, device=dev)
    eng = serving.InferenceEngine(model_acc.cfg, model=model_acc, decoder=dec_acc,
                                  device=dev)
    d = pathlib.Path(tempfile.mkdtemp(dir=ROOT / "build"))
    st = {"t0": t0, "dir": d, "procs": {}, "V": V,
          "dec_depth": model_acc.cfg.backbone.dec_depth}
    with torch.no_grad():
        g, poses, _ = eng._reconstruct_raw()(images01, K)
        gd = dict(g._asdict())
        rendered = eng._render_raw((256, 256))(g, tgt_ext, tgt_K, near, far)
    torch.cuda.synchronize()
    st["eager"] = {"poses": poses.cpu(), "gaussians": {k: v.cpu() for k, v in gd.items()},
                   "render": {k: getattr(rendered, k).cpu()
                              for k in ("color", "depth", "alpha")}}
    w = export.weights(eng)
    st["weights_bytes"] = sum(t.numel() * t.element_size() for t in w.values())
    torch.save(w, d / "weights.pt")
    torch.save({"cfg": model_acc.cfg, "dec": dec_acc, "images_shape": tuple(images01.shape),
                "scene_dims": tuple(g.means.shape[:-1]), "views": V,
                "tiny_net": TINY_EXPORT_NET}, d / "spec.pt")
    torch.save((images01, K), d / "reconstruct_args.pt")
    torch.save((gd, tgt_ext, tgt_K, near, far), d / "render_args.pt")
    del w, g, gd, rendered, eng
    torch.cuda.empty_cache()
    # one intra-op thread each: the children's tracing and loading is host
    # work beside the phases that follow
    st["env"] = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    for which in ("reconstruct", "render"):
        st["procs"][which] = start_child(d, which, [EXPORT_TRACE_CHILD, str(d), which],
                                         st["env"])
    st["children_t0"] = time.perf_counter()

    def chain():
        """Start the loading child as soon as both exporters are done."""
        try:
            st["traced"] = {w: wait_child(st, w) for w in ("reconstruct", "render")}
            st["exporters_s"] = time.perf_counter() - st["children_t0"]
            st["load_t0"] = time.perf_counter()
            st["procs"]["load"] = start_child(d, "load", [EXPORT_CHILD, str(d),
                                                          json.dumps(KERNEL_SYMBOLS)],
                                              st["env"])
        except Exception as e:  # raised again by export_finish
            st["chain_error"] = e

    st["chain"] = threading.Thread(target=chain, daemon=True)
    st["chain"].start()
    return st


def start_child(d: pathlib.Path, name: str, args: list, env: dict):
    """`python -c args...` in `d`, its output in d/<name>.out and .err."""
    with open(d / f"{name}.out", "w") as out, open(d / f"{name}.err", "w") as err:
        return subprocess.Popen([sys.executable, "-c", *args], cwd=d, env=env,
                                stdout=out, stderr=err)


def wait_child(st: dict, name: str, timeout: float = 600) -> dict:
    """Wait for a child of the export phase: its last stdout line as JSON."""
    d = st["dir"]
    code = st["procs"][name].wait(timeout=timeout)
    if code != 0:
        raise AssertionError(f"export child {name} exited {code}:\n"
                             f"{(d / f'{name}.err').read_text()[-4000:]}")
    return json.loads((d / f"{name}.out").read_text().strip().splitlines()[-1])


def export_stop(st: dict):
    """Stop the export child if it still runs, and delete its directory."""
    import shutil

    for proc in st["procs"].values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    shutil.rmtree(st["dir"], ignore_errors=True)


def export_finish(st: dict, smi) -> dict:
    """Phase export, second half: wait for the child that loaded and called
    the artifacts (started by export_start's thread once both exporters were
    done) and that never imports the model code; hold its kernels and
    outputs against the eager engine's."""
    d, V = st["dir"], st["V"]
    st["chain"].join()
    if "chain_error" in st:
        raise st["chain_error"]
    traced = st["traced"]
    res = {"trace_s_reconstruct": traced["reconstruct"]["trace_s"],
           "trace_s_render": traced["render"]["trace_s"],
           "trace_s_tiny_cpu": traced["render"]["trace_s_tiny_cpu"],
           "exporters_s": st["exporters_s"],
           "artifact_bytes": {k: traced[k]["bytes"] for k in traced},
           "weights_bytes": st["weights_bytes"]}
    child = wait_child(st, "load")
    res["child_s"] = time.perf_counter() - st["load_t0"]
    out_r, out_v, out_t = (torch.load(d / f"{n}_out.pt", weights_only=True,
                                      map_location="cpu")
                           for n in ("reconstruct", "render", "tiny"))
    eager = st["eager"]
    tiny_ref = torch.load(d / "tiny_ref.pt", weights_only=True)
    want_r = {"flash_attn": st["dec_depth"], "dpt_tail": 1}
    want_v = {"composite": V, "bitonic_topk": V}
    gaps = {"reconstruct": {"poses": max_gap(out_r["poses"], eager["poses"]),
                            **{k: max_gap(out_r["gaussians"][k], v)
                               for k, v in eager["gaussians"].items()}},
            "render": {k: max_gap(out_v[k], v) for k, v in eager["render"].items()}}
    exact = all(v == 0.0 for x in gaps.values() for v in x.values())
    tiny_gap = {k: (max_gap(out_t["gaussians"][k], v) / max(v.abs().max().item(), 1e-30))
                for k, v in tiny_ref["gaussians"].items()}
    tiny_gap["poses"] = max_gap(out_t["poses"], tiny_ref["poses"])
    res.update(child=child, gaps=gaps, exact=exact, tiny_rel_gap=tiny_gap)
    n_tiny = traced["render"]["tiny_dec_depth"]
    checks = {
        "models not imported": not child["models_imported"],
        "reconstruct kernels": child["reconstruct"]["profiled"] == want_r,
        "render kernels": child["render"]["profiled"] == want_v,
        "tiny K1 f32": child["tiny"]["counted"]["flash_attn_f32"] == n_tiny
        and child["tiny"]["counted"]["flash_attn"] == 0
        and child["tiny"]["profiled"] == {"flash_attn_f32": n_tiny},
        # bit for bit expected (the same aten operators and kernels); else
        # within the plain-k1 rule's floors and the render's limit
        "reconstruct gap": gaps["reconstruct"]["poses"] <= 1e-4
        and gaps["reconstruct"]["opacities"] <= 1e-3,
        "render gap": gaps["render"]["color"] < RENDER_TOL,
        "tiny gap": max(tiny_gap.values()) < TINY_TOL}
    phase("export", st["t0"], f"[{smi}] accelerator engine, 1 x 8 x 256^2 bf16: trace "
          f"and save {res['trace_s_reconstruct']:.1f} s reconstruct, "
          f"{res['trace_s_render']:.1f} s render ({V} views), each in a fresh process "
          f"beside the demo to train phases ({res['exporters_s']:.1f} s from their start to "
          f"the last one's end); artifacts {res['artifact_bytes']} bytes, weights "
          f"{res['weights_bytes']} bytes (arguments, not stored); loading child "
          f"(torch + the kernels, modules {child['modules']}) {res['child_s']:.1f} s, loads "
          f"{child['reconstruct']['load_s']:.1f} + {child['render']['load_s']:.1f} s; "
          f"kernels in one call by torch.profiler: reconstruct "
          f"{child['reconstruct']['profiled']}, render {child['render']['profiled']} "
          f"(counters {child['reconstruct']['counted']}, {child['render']['counted']}); "
          f"against the eager engine: bit for bit {exact}, largest gaps {gaps}; tiny "
          f"float32 artifact exported on the CPU in {res['trace_s_tiny_cpu']:.1f} s, "
          f"moved to cuda: kernels {child['tiny']['profiled']}, counters "
          f"{child['tiny']['counted']}, relative gap to the CPU engine "
          + ", ".join(f"{k} {v:.2e}" for k, v in tiny_gap.items())
          + f" (tol {TINY_TOL}); checks {checks}")
    if not all(checks.values()):
        raise AssertionError(f"export: {checks}")
    return res

def expect_launches(what, got, want):
    if got != want:
        raise AssertionError(f"{what} launches {got}, not {want}")


def psnr_u8(a, b) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return 10 * math.log10(255.0 ** 2 / max(mse, 1e-12))


def luma(rgb):
    """JPEG's Y of uint8 RGB, in float64."""
    return rgb.astype(np.float64) @ np.array([0.299, 0.587, 0.114])


def re10k_scenes(dev, out: pathlib.Path) -> dict:
    """The synthetic generator's scenes 0.. at RE10K_HW (re10k_scene_views),
    written as <out>/<scene>/images/<i>.png (threads: zlib releases the
    GIL) and cameras.npz (normalized K, c2w). Returns the frames (uint8) by
    scene."""
    from concurrent.futures import ThreadPoolExecutor

    from vicasplat_tpu_torch.utils.image_io import encode_png

    frames = {}
    with ThreadPoolExecutor(max_workers=8) as pool:
        for s in range(RE10K_SCENES):
            v = re10k_scene_views(dev, s)
            d = out / f"scene_{s:02d}"
            (d / "images").mkdir(parents=True)
            np.savez(d / "cameras.npz", intrinsics=np.tile(v["K"], (RE10K_FRAMES, 1, 1)),
                     extrinsics_c2w=v["c2w"])
            imgs = v["frames"]
            list(pool.map(lambda i, d=d, imgs=imgs: (d / "images" / f"{i:04d}.png")
                          .write_bytes(encode_png(imgs[i])), range(RE10K_FRAMES)))
            frames[d.name] = imgs
    return frames


def re10k_phase(dev, smi, reset_counts, counts, zero):
    """Phase re10k (see the module's docstring)."""
    import shutil

    from vicasplat_tpu_torch import main as tmain
    from vicasplat_tpu_torch.data import dataset_re10k
    from vicasplat_tpu_torch.data import convert_scripts
    from vicasplat_tpu_torch.data.data_module import PrefetchIterator
    from vicasplat_tpu_torch.evaluation import extend_index, index_generator, nvs_eval
    from vicasplat_tpu_torch.models import VicaNetConfig
    from vicasplat_tpu_torch.utils.config import parse_cli
    from vicasplat_tpu_torch.utils.host_image import decode_jpegs_u8

    t0 = time.perf_counter()
    work = ROOT / "build/chip_smoke_re10k"
    shutil.rmtree(work, ignore_errors=True)
    rec = {}
    # ---- scenes, conversion, the decoder against the rendered frames ----
    frames = re10k_scenes(dev, work / "scenes")
    t_render = time.perf_counter() - t0
    t1 = time.perf_counter()
    for stage in ("train", "test"):
        convert_scripts.main(["--input_dir", str(work / "scenes"), "--output_dir",
                              str(work / "re10k"), "--stage", stage])
    t_convert = time.perf_counter() - t1
    chunk = torch.load(work / "re10k/test/000000.torch", weights_only=True)
    luma_db, rgb_db = [], []
    for ex in chunk:
        dec = decode_jpegs_u8(ex["images"])
        ref = frames[ex["key"]]
        rgb_db.append(psnr_u8(dec, ref))
        luma_db.append(psnr_u8(luma(dec), luma(ref)))
    jpeg_bytes = sum(len(x) for ex in chunk for x in ex["images"])
    if min(luma_db) < RE10K_PSNR_MIN:
        raise AssertionError(f"JPEG round trip: luma {luma_db} dB, under {RE10K_PSNR_MIN}")
    phase("re10k", t0, f"[{smi}] {RE10K_SCENES} scenes x {RE10K_FRAMES} frames of "
          f"{RE10K_HW[0]}x{RE10K_HW[1]} rendered and written as PNG in {t_render:.1f} s, "
          f"converted (train and test) in {t_convert:.1f} s, {jpeg_bytes} JPEG bytes a "
          f"stage; the port's decode against the rendered frames: 4:2:0 q95 luma PSNR "
          + ", ".join(f"{x:.2f}" for x in luma_db) + f" dB (min {RE10K_PSNR_MIN}), RGB "
          + ", ".join(f"{x:.2f}" for x in rgb_db) + " dB")
    rec["jpeg"] = dict(luma_db=luma_db, rgb_db=rgb_db, bytes=jpeg_bytes,
                       render_s=t_render, convert_s=t_convert)
    del frames, chunk

    # ---- the 2-view index and its 8-view extension ----
    t1 = time.perf_counter()
    idx2 = index_generator.main(["--data_root", str(work / "re10k/test"), "--output_path",
                                 str(work / "index"), *[f"--{k}={v}" for k, v in
                                                        RE10K_INDEX.items()]])
    index2 = json.loads(pathlib.Path(idx2).read_text())
    index8 = extend_index.main(["--index_2v", str(idx2), "--data_root",
                                str(work / "re10k/test"), "--n_context", "8", "--n_target",
                                "3", "--output", str(work / "index/index_8v.json")])
    if not any(v is not None for v in index2.values()) or not index8:
        raise AssertionError(f"no scene indexed: {index2}, {index8}")
    scene = sorted(index8)[0]
    one = work / "index/index_8v_one.json"
    one.write_text(json.dumps({scene: index8[scene]}))
    phase("re10k", t0, f"index band {RE10K_INDEX}: 2-view {index2}; 8-view {index8} "
          f"({time.perf_counter() - t1:.1f} s)")
    rec["index"] = dict(band=RE10K_INDEX, two_view=index2, eight_view=index8)

    # ---- train mode from the chunks: the flagship step ----
    dec_depth = VicaNetConfig().dec_depth
    example_s, waits = [], []
    process, nxt = dataset_re10k.DatasetRE10k._process, PrefetchIterator.__next__

    def timed_process(self, raw, rng=None):
        t = time.perf_counter()
        ex = process(self, raw, rng)
        example_s.append(time.perf_counter() - t)
        return ex

    def timed_next(self):
        t = time.perf_counter()
        item = nxt(self)
        waits.append(time.perf_counter() - t)
        return item

    out = work / "train"
    argv = ["+experiment=re10k_8view", "mode=train", f"dataset.re10k.roots=[{work / 're10k'}]",
            f"trainer.max_steps={RE10K_TRAIN_STEPS}", "train.print_log_every_n_steps=1",
            f"output_dir={out}", f"checkpointing.output_dir={out}/ckpts", "wandb.mode=disabled"]
    torch.cuda.empty_cache()
    with mock.patch.object(dataset_re10k.DatasetRE10k, "_process", timed_process), \
            mock.patch.object(PrefetchIterator, "__next__", timed_next):
        tr = train_mode_run(dev, argv, reset_counts, counts)
    for st in tr["steps"]:
        expect_launches(f"re10k train step {st['step']}", st["launches"],
                        k1_step_launches(parse_cli(argv), zero))
    batch = parse_cli(argv).data_loader["train"]["batch_size"]
    loader_s = batch * statistics.mean(example_s)
    snap = out / "ckpts" / f"step_{RE10K_TRAIN_STEPS:08d}.npz"
    if not snap.exists():
        raise AssertionError(f"no checkpoint {snap}")
    shapes = tr["steps"][0]["scenes"]
    phase("re10k", t0, f"[{smi}] train mode, re10k_8view from chunks: {len(tr['steps'])} "
          f"steps of batch {batch} (scenes {shapes}), ms "
          + ", ".join(f"{st['ms']:.1f}" for st in tr["steps"]) + "; losses "
          + ", ".join(f"{st['loss']:.5f}" for st in tr["steps"])
          + f"; launches a step {tr['steps'][-1]['launches']}; loader "
          f"{loader_s:.3f} s a batch ({len(example_s)} examples, "
          f"{statistics.mean(example_s):.3f} s each, decode and resize on its thread), "
          "the step waited " + ", ".join(f"{w:.3f}" for w in waits) + " s for its batch; "
          f"peak {tr['peak_gb']:.1f} GB; run {tr['wall_s']:.1f} s; checkpoint "
          f"{snap.stat().st_size} bytes")
    rec["train"] = dict(steps=[{k: v for k, v in st.items() if k != "scenes"}
                               for st in tr["steps"]],
                        batch=batch, loader_s_per_batch=loader_s, example_s=example_s,
                        waits_s=waits, peak_gb=tr["peak_gb"], wall_s=tr["wall_s"],
                        checkpoint_bytes=snap.stat().st_size)
    del tr
    torch.cuda.empty_cache()

    # ---- test mode on one indexed scene, accelerator configuration ----
    t1 = time.perf_counter()
    tout = work / "test"
    argv = ["+experiment=re10k_8view", "mode=test", f"dataset.re10k.roots=[{work / 're10k'}]",
            "dataset.re10k.view_sampler={name: evaluation, index_path: " f"{one}, "
            "num_context_views: 8}", f"test.pose_align_steps={RE10K_PHASE_ALIGN_STEPS}",
            f"test.output_path={tout}", f"checkpointing.load={snap}",
            "encoder.head_tail_backend=pallas", "decoder.rasterize.backend=pallas",
            "decoder.rasterize.binning=origin"]
    views = []
    evaluate = nvs_eval.evaluate_scene

    def counted(*a, **kw):
        r = evaluate(*a, **kw)
        views.append(a[4]["target"]["image"].shape[1])
        return r

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(nvs_eval, "evaluate_scene", counted):
        summary, results = tmain.main(argv, device=dev)
    torch.cuda.synchronize()
    launches = counts()
    n = (RE10K_PHASE_ALIGN_STEPS + 1) * sum(views)
    expect_launches("re10k test mode", launches, dict(
        zero, flash_attn=dec_depth, dpt_tail=1, composite=n, bitonic_topk=n))
    files = [tout / name for name in ("scores_all_avg.json", "benchmark.json",
                                       "peak_memory.json")] + [
        tout / scene / name for name in ("transforms.json", "compare.png",
                                         "color/000.png", "context/007.png")]
    r = results[0] if results else {}
    bad = [k for k in ("psnr", "ssim", "ate") if not math.isfinite(r.get(k, math.nan))]
    missing = [str(f) for f in files if not f.exists()]
    if len(results) != 1 or bad or missing:
        raise AssertionError(f"re10k test mode: {len(results)} scenes, non-finite {bad}, "
                             f"missing {missing}")
    bench = json.loads((tout / "benchmark.json").read_text())
    secs = {k: v["mean_warm_s"] for k, v in bench.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    phase("re10k", t0, f"[{smi}] test mode, re10k_8view accelerator configuration on "
          f"{scene} (8 context views, {views[0]} targets, the {RE10K_TRAIN_STEPS}-step checkpoint, "
          f"{RE10K_PHASE_ALIGN_STEPS} alignment steps, cut from {RE10K_ALIGN_STEPS}): "
          f"launches {launches}; psnr "
          f"{r['psnr']:.4f} ssim {r['ssim']:.4f} ate {r['ate']:.4f}; seconds "
          + ", ".join(f"{k} {v:.4f}" for k, v in secs.items())
          + f"; peak {peak_gb:.1f} GB; {time.perf_counter() - t1:.1f} s")
    rec["test"] = dict(scene=scene, views=views[0], launches=launches,
                       scores={k: r[k] for k in ("psnr", "ssim", "ate")}, seconds=secs,
                       peak_gb=peak_gb, summary=summary)
    rec["wall_s"] = time.perf_counter() - t0
    shutil.rmtree(work / "train" / "ckpts", ignore_errors=True)
    return rec


def experiment_reckoning(cfg, micro: int) -> dict:
    """The card memory (GB, 1e9 bytes) a train step of the parsed root
    config `cfg` in `micro` micro-batches is reckoned to take: the state of
    parallel/memory_proof.py's reckoning on one device (parameters,
    gradients, AdamW's moments), the bf16 copies of the weights, and the
    activations of one micro-batch at EXPERIMENT_ACT_GB a context frame and
    a target view."""
    from vicasplat_tpu_torch.parallel import memory_proof
    from vicasplat_tpu_torch.training import TrainConfig

    state = memory_proof.reckon(TrainConfig(model=cfg.encoder, optimizer=cfg.optimizer),
                                ("dp8",))["configs"]["dp8"]
    sampler = next(iter(cfg.dataset.values()))["view_sampler"]
    batch = cfg.data_loader["train"]["batch_size"] // micro
    ctx, tgt = batch * sampler["num_context_views"], batch * sampler["num_target_views"]
    act = ctx * EXPERIMENT_ACT_GB["context"] + tgt * EXPERIMENT_ACT_GB["target"]
    r = dict(state_gb=state["state_bytes"] / 1e9, bf16_weights_gb=state["param_bytes"] / 2e9,
             activations_gb=act, micro_batch=batch, context=ctx, targets=tgt)
    r["total_gb"] = r["state_gb"] + r["bf16_weights_gb"] + act
    return r


def experiment_splits(cfg) -> list:
    """The micro-batch counts (dividing the config's batch) to try in turn:
    from the smallest whose reckoning is under EXPERIMENT_FIT_GB."""
    batch = cfg.data_loader["train"]["batch_size"]
    splits = [m for m in (1, 2, 4, 8, 16) if batch % m == 0]
    fits = [m for m in splits if experiment_reckoning(cfg, m)["total_gb"] <= EXPERIMENT_FIT_GB]
    return [m for m in splits if m >= (fits[0] if fits else splits[-1])]


def re10k_scene_views(dev, s: int) -> dict:
    """The synthetic generator's scene s at RE10K_HW, rendered on the card in
    chunks of 16 frames (data/synthetic_scenes.render_scene_views), with
    square pixels (the vertical focal length scaled by W / H, as RE10K's
    cameras have): uint8 frames, the expected depth (metres, 0 where the
    alpha is under 0.5), c2w and the normalized K."""
    from vicasplat_tpu_torch.data import synthetic_scenes as scenes
    from vicasplat_tpu_torch.utils.image_io import to_uint8

    cfg = scenes.SyntheticScenesConfig(input_image_shape=RE10K_HW, n_frames=RE10K_FRAMES,
                                       n_gaussians=RE10K_GAUSSIANS)
    K = scenes.intrinsics_for(cfg)
    K[1, 1] *= RE10K_HW[1] / RE10K_HW[0]
    rng = scenes.scene_rng(s, cfg)
    gauss = scenes.scene_gaussians(rng, cfg)
    poses = scenes.scene_trajectory(rng, cfg)
    frames, depths = [], []
    for i in range(0, RE10K_FRAMES, 16):
        color, depth = scenes.render_scene_views(gauss, poses[i:i + 16], K, RE10K_HW, dev)
        frames.append(to_uint8(color))
        depths.append(depth)
    return dict(frames=np.concatenate(frames), depth=np.concatenate(depths), c2w=poses, K=K)


def k1_bwd_keeper(seen: list):
    """K1's autograd backward (_FlashAttention.backward) that also keeps
    its first call's own inputs (q, k, v, o, lse, dO) in `seen`, unpacking
    the saved tensors once, as a checkpointed block's backward allows."""
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        if not seen:
            seen.append(tuple(x.detach().clone() for x in (q, k, v, o, lse, do)))
        return torch.ops.vicasplat.flash_attn_bwd(q, k, v, o, lse, do)
    return staticmethod(backward)


def split_train_run(dev, what, t0, splits, prepare, batch, reset_counts, counts):
    """train_mode_run(prepare(m)) for each micro-batch count m of `splits`
    in turn until a step of batch `batch` in m micro-batches fits on the
    card: (m, its run, [{micro, peak_gb}] of the counts that ran out of
    memory). `prepare` clears what a try left and returns its argv."""
    import gc

    tried = []
    for m in splits:
        argv = prepare(m)
        gc.collect()
        torch.cuda.empty_cache()
        try:
            return m, train_mode_run(dev, argv, reset_counts, counts), tried
        except torch.cuda.OutOfMemoryError:
            tried.append(dict(micro=m, peak_gb=torch.cuda.max_memory_allocated() / 1e9))
            phase(what, t0, f"split: {m} micro-batches of {batch // m}: out of memory, peak "
                  f"{tried[-1]['peak_gb']:.1f} GB")
    raise AssertionError(f"{what}: the step fits in no split: {tried}")


def watched_train_step(make_step, watch: dict, last: int):
    """training.make_train_step's signature around `make_step`: each step's
    device span (CUDA events around it, ms) is appended to
    watch["span_ms"], and global step `last`'s update goes to
    watch["update"] (update_record)."""
    def make(cfg, model, optimizer, lpips_fn=None, teacher_fn=None):
        step = make_step(cfg, model, optimizer, lpips_fn, teacher_fn)

        def run(batch, global_step, phase="full"):
            before = None
            if global_step == last:
                lr = optimizer.schedule(optimizer.count)
                before = {n: p.detach().to("cpu", copy=True)
                          for n, p in optimizer.params.items()}
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            logs = step(batch, global_step, phase)
            e1.record()
            run.nonfinite = step.nonfinite
            torch.cuda.synchronize()
            watch["span_ms"].append(e0.elapsed_time(e1))
            if before is not None:
                watch["update"] = update_record(optimizer, before, lr)
                bad = update_gaps([watch["update"]])
                if bad:
                    raise AssertionError(f"the update at lr {lr}: groups {bad}")
            return logs
        return run
    return make


def experiments_phase(dev, smi, reset_counts, counts, zero):
    """Phase experiments (see the module's docstring)."""
    import gc
    import shutil

    from vicasplat_tpu_torch import eval_pose, training
    from vicasplat_tpu_torch import main as tmain
    from vicasplat_tpu_torch.evaluation import extend_index, index_generator, nvs_eval
    from vicasplat_tpu_torch.kernels import flash_attn
    from vicasplat_tpu_torch.models import vicanet
    from vicasplat_tpu_torch.utils.config import parse_cli

    t0 = time.perf_counter()
    src = ROOT / "build/chip_smoke_re10k"
    work = ROOT / "build/chip_smoke_experiments"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    index2 = src / "index/evaluation_index.json"
    scene = sorted(k for k, v in json.loads(index2.read_text()).items() if v is not None)[0]
    one2 = work / "index_2v_one.json"
    one2.write_text(json.dumps({scene: json.loads(index2.read_text())[scene]}))
    index4 = extend_index.main(["--index_2v", str(one2), "--data_root", str(src / "re10k/test"),
                                "--n_context", "4", "--n_target", "3",
                                "--output", str(work / "index_4v.json")])
    if scene not in index4:
        raise AssertionError(f"the 4-view extension lost {scene}: {index4}")
    shapes, seen = [], []
    attend = vicanet.flash_attention

    def spy_k1(q, k, v, *a, **kw):  # K1's shapes, once each
        shape = (tuple(q.shape), tuple(k.shape))
        if shape not in shapes:
            shapes.append(shape)
        return attend(q, k, v, *a, **kw)

    rec = {"scene": scene, "index_4v": index4[scene]}
    ckpts = {}
    for name in EXPERIMENTS:
        t1 = time.perf_counter()
        ds = "acid" if name.startswith("acid") else "re10k"
        base = parse_cli([f"+experiment={name}"])
        batch = base.data_loader["train"]["batch_size"]
        # the loader restarts each pass over the chunks with the same seed,
        # so a pass must hold a whole batch
        roots = "[" + ",".join([str(src / "re10k")] * max(1, batch // RE10K_SCENES)) + "]"
        out = work / name
        splits = experiment_splits(base)
        watch = {}

        def train_argv(micro):
            return [f"+experiment={name}", "mode=train", f"dataset.{ds}.roots={roots}",
                    f"trainer.max_steps={EXPERIMENT_STEPS}",
                    f"train.accumulate_grad_batches={micro}",
                    "train.print_log_every_n_steps=1", "trainer.val_check_interval=0",
                    f"output_dir={out}", f"checkpointing.output_dir={out}/ckpts",
                    "wandb.mode=disabled"]

        def prepare(micro):
            shutil.rmtree(out, ignore_errors=True)
            shapes.clear()
            seen.clear()
            watch.update(span_ms=[], update=None)
            return train_argv(micro)

        with mock.patch.object(vicanet, "flash_attention", spy_k1), \
                mock.patch.object(flash_attn._FlashAttention, "backward",
                                  k1_bwd_keeper(seen)), \
                mock.patch.object(training, "make_train_step", watched_train_step(
                    training.make_train_step, watch, EXPERIMENT_STEPS - 1)):
            micro, tr, tried = split_train_run(dev, "experiments", t0, splits, prepare, batch,
                                               reset_counts, counts)
        cfg = parse_cli(train_argv(micro))
        reckoned = experiment_reckoning(cfg, micro)
        want = k1_step_launches(cfg, zero)
        for st in tr["steps"]:
            expect_launches(f"{name} train step {st['step']}", st["launches"], want)
        upd = watch["update"]
        if upd is None or len(watch["span_ms"]) != len(tr["steps"]):
            raise AssertionError(f"{name}: {len(watch['span_ms'])} device spans for "
                                 f"{len(tr['steps'])} steps, update {upd}")
        ckpt = out / "ckpts" / f"step_{EXPERIMENT_STEPS:08d}.npz"
        if not ckpt.exists():
            raise AssertionError(f"no checkpoint {ckpt}")
        ckpts[name] = ckpt
        views = base.dataset[ds]["view_sampler"]
        last = tr["steps"][-1]
        phase("experiments", t0, f"[{smi}] {name} train mode at full width from re10k's chunks "
              f"({ds} name): batch {batch} of "
              f"{views['num_context_views']} context and {views['num_target_views']} target "
              f"views as {micro} micro-batches of {batch // micro} (reckoned "
              + ", ".join(f"{m}: {experiment_reckoning(cfg, m)['total_gb']:.1f} GB"
                          for m in splits[:splits.index(micro) + 1])
              + f"; out of memory: {[t['micro'] for t in tried] or 'none'}); remat "
              f"{cfg.train.gradient_checkpointing} policy {cfg.train.remat_policy!r}, "
              f"temporal_rope_theta {cfg.encoder.backbone.temporal_rope_theta}; losses "
              + ", ".join(f"{st['loss']:.5f}" for st in tr["steps"])
              + f"; nan guard {[st['nonfinite'] for st in tr['steps']]}; step ms (host) "
              + ", ".join(f"{st['ms']:.1f}" for st in tr["steps"])
              + "; device span (CUDA events) " + ", ".join(f"{x:.1f}" for x in watch["span_ms"])
              + f"; step {EXPERIMENT_STEPS - 1}'s update at lr {upd['lr']:.3e}, by lr "
              "multiplier: " + "; ".join(
                  f"{m}: {g['moved']} of {g['tensors']} tensors moved, largest |update| / "
                  f"(lr * mult) {g['ratio']:.4f} (bound {g['bound']:.4f})"
                  for m, g in sorted(upd["groups"].items()))
              + f"; launches a step {last['launches']} (want {want}); K1 shapes (q, k) "
              f"{shapes}; peak "
              f"{tr['peak_gb']:.2f} GB against reckoned {reckoned['total_gb']:.2f} GB "
              f"(state {reckoned['state_gb']:.2f}, bf16 weights "
              f"{reckoned['bf16_weights_gb']:.2f}, activations {reckoned['activations_gb']:.2f}); "
              f"{time.perf_counter() - t1:.1f} s")
        r = dict(batch=batch, micro=micro, out_of_memory=tried, reckoned=reckoned,
                 peak_gb=tr["peak_gb"], wall_s=tr["wall_s"], k1_shapes=list(shapes),
                 want=want, update=upd, device_span_ms=watch["span_ms"],
                 steps=[{k: v for k, v in st.items() if k != "scenes"}
                        for st in tr["steps"]])
        del tr
        # K1 at this config's own shape (its last q and k tiles partly
        # filled), forward and backward, on the run's first backward's inputs
        q, k, v, o, lse, do = seen.pop()
        r["k1"] = flash_phase(dev, {name: [(q, k, v)]})[name]
        r["k1_bwd"] = own_rounding(k1_bwd_held(q, k, v, o, lse, do,
                                               what=f"K1 backward on {name}'s step inputs"))
        phase("experiments", t0, f"{name}: K1 on the step's own inputs, {r['k1']['shape']}: "
              f"forward max abs err {r['k1']['max_abs_err']:.3e} (tol {FLASH_TOL}); backward "
              "relative errors " + ", ".join(
                  f"{nm} {e['rel']:.2e} (tol {2 * e['sdpa_rel'] + FLASH_BWD_FLOOR:.2e})"
                  for nm, e in r["k1_bwd"].items() if nm != "dq_own") + own_line(r["k1_bwd"]))
        del q, k, v, o, lse, do
        gc.collect()
        torch.cuda.empty_cache()

        # ---- the test mode on the indexed scene with that checkpoint ----
        t1 = time.perf_counter()
        accel = name == "re10k_4view"
        n_ctx = views["num_context_views"]
        index = one2 if n_ctx == 2 else work / "index_4v.json"
        tout = out / "test"
        argv = [f"+experiment={name}", "mode=test", f"dataset.{ds}.roots=[{src / 're10k'}]",
                f"dataset.{ds}.view_sampler={{name: evaluation, index_path: {index}, "
                f"num_context_views: {n_ctx}}}", f"test.pose_align_steps={RE10K_ALIGN_STEPS}",
                f"test.output_path={tout}", f"checkpointing.load={ckpt}"]
        if accel:
            argv += ["encoder.head_tail_backend=pallas", "decoder.rasterize.backend=pallas",
                     "decoder.rasterize.binning=origin"]
        seen = []
        evaluate = nvs_eval.evaluate_scene

        def counted(*a, **kw):
            res = evaluate(*a, **kw)
            seen.append(a[4]["target"]["image"].shape[1])
            return res

        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        with mock.patch.object(nvs_eval, "evaluate_scene", counted):
            _, results = tmain.main(argv, device=dev)
        torch.cuda.synchronize()
        launches = counts()
        dec_depth = cfg.encoder.backbone.dec_depth
        n = (RE10K_ALIGN_STEPS + 1) * sum(seen)
        want = (dict(zero, flash_attn=dec_depth, dpt_tail=1, composite=n, bitonic_topk=n)
                if accel else dict(zero, flash_attn=dec_depth))
        expect_launches(f"{name} test mode", launches, want)
        files = [tout / f for f in ("scores_all_avg.json", "benchmark.json",
                                    "peak_memory.json")] + [
            tout / scene / f for f in ("transforms.json", "compare.png", "color/000.png",
                                       f"context/{n_ctx - 1:03d}.png")]
        res = results[0] if results else {}
        bad = [k for k in ("psnr", "ssim", "ate") if not math.isfinite(res.get(k, math.nan))]
        missing = [str(f) for f in files if not f.exists()]
        if len(results) != 1 or bad or missing:
            raise AssertionError(f"{name} test mode: {len(results)} scenes, non-finite {bad}, "
                                 f"missing {missing}")
        secs = {k: v["mean_warm_s"] for k, v in json.loads(
            (tout / "benchmark.json").read_text()).items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        phase("experiments", t0, f"[{smi}] {name} test mode on {scene} "
              f"({'accelerator' if accel else 'default'} configuration, {n_ctx} context "
              f"views, {seen[0]} targets, {RE10K_ALIGN_STEPS} alignment steps, the "
              f"{EXPERIMENT_STEPS}-step checkpoint): launches {launches}; psnr "
              f"{res['psnr']:.4f} ssim {res['ssim']:.4f} ate {res['ate']:.4f}; seconds "
              + ", ".join(f"{k} {v:.4f}" for k, v in secs.items())
              + f"; peak {peak_gb:.1f} GB; {time.perf_counter() - t1:.1f} s")
        r["test"] = dict(views=seen[0], launches=launches, seconds=secs, peak_gb=peak_gb,
                         scores={k: res[k] for k in ("psnr", "ssim", "ate")})
        rec[name] = r
        if name != "re10k_2view":  # its checkpoint scores ScanNet below
            shutil.rmtree(out / "ckpts", ignore_errors=True)

    # ---- ScanNet: the indexed scene again in ScanNet's layout, posed ----
    t1 = time.perf_counter()
    sv = re10k_scene_views(dev, int(scene.rsplit("_", 1)[1]))
    root = work / "scannet"
    name = "scene0000_00"
    write_scannet_scene(root / "test" / name, sv["frames"], sv["depth"], sv["c2w"], sv["K"])
    (root / "test_idx.txt").write_text(name + "\n")
    gen = index_generator.EvaluationIndexGenerator(index_generator.IndexGeneratorConfig(
        **RE10K_INDEX, output_path=str(work / "scannet_index")))
    entry = gen.process_scene(name, sv["c2w"], np.tile(sv["K"], (RE10K_FRAMES, 1, 1)))
    idx2 = gen.save()
    idx = work / "scannet_index/index_2v_ext.json"
    ext = extend_index.main(["--scene_dirs", "--index_2v", str(idx2), "--data_root",
                             str(root / "test"), "--n_context", "2", "--n_target", "3",
                             "--output", str(idx)])
    if entry is None or name not in ext:
        raise AssertionError(f"ScanNet index: {entry}, {ext}")
    depth_px = float((sv["depth"] > 0).mean())
    del sv
    reset_counts()
    pose_out = work / "scannet_eval"
    ev = eval_pose.main(["+experiment=re10k_2view", f"checkpointing.load={ckpts['re10k_2view']}",
                         f"dataset={{scannet_pose: {{name: scannet_pose, roots: [{root}], "
                         f"view_sampler: {{name: evaluation, index_path: {idx}, "
                         "num_context_views: 2}}}", f"test.output_path={pose_out}"], device=dev)
    torch.cuda.synchronize()
    launches = counts()
    expect_launches("scannet_pose eval_pose", launches,
                    dict(zero, flash_attn=base.encoder.backbone.dec_depth))
    summary = ev.summary()
    # two views: ATE and the pose AUCs (RPE needs 3, as the JAX package's
    # camera_eval_metrics)
    keys = ("ate", "auc@5", "auc@10", "auc@20", "auc@30")
    bad = [k for k in keys if not math.isfinite(summary.get(k, math.nan))]
    written = pathlib.Path(f"{pose_out}_pose/pose_metrics.json")
    if bad or not written.exists():
        raise AssertionError(f"scannet_pose eval_pose: non-finite {bad}, {written} "
                             f"{'written' if written.exists() else 'missing'}")
    phase("experiments", t0, f"[{smi}] ScanNet 2-view pose evaluation: {scene}'s "
          f"{RE10K_FRAMES} frames written in ScanNet's layout (JPEG q95, 16-bit depth PNGs "
          f"in mm, {depth_px:.3f} of the pixels with depth), indexed {entry} and extended "
          f"{ext[name]}; eval_pose of re10k_2view's checkpoint with dataset=scannet_pose: "
          f"summary {summary}; launches {launches}; {time.perf_counter() - t1:.1f} s")
    rec["scannet_pose"] = dict(index=ext[name], summary=summary, launches=launches,
                               depth_share=depth_px)
    shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    rec["wall_s"] = time.perf_counter() - t0
    return rec


def k1_step_launches(cfg, zero: dict) -> dict:
    """K1's launches in one train step of the parsed root config `cfg`, by
    its own remat setting: a micro-batch runs each decoder block's joint
    attention forward once, once more in the backward under remat (either
    policy recomputes the attention), and K1's backward once a block."""
    dec = cfg.encoder.backbone.dec_depth
    micro = max(1, cfg.train.accumulate_grad_batches)
    forward = (2 if cfg.train.gradient_checkpointing else 1) * dec
    return dict(zero, flash_attn=forward * micro, flash_attn_bwd=dec * micro)


def write_scannet_scene(d: pathlib.Path, frames: np.ndarray, depth_m: np.ndarray,
                        c2w: np.ndarray, K: np.ndarray):
    """One scene in ScanNet's layout, as data/dataset_scannet.py reads it:
    color/<i>.jpg (the port's JPEG encoder at quality 95), depth/<i>.png
    (16-bit, millimetres, 0 where there is none), extrinsics.npy (c2w) and
    intrinsic/intrinsic_color.txt (4 x 4, in pixels). frames (V, H, W, 3)
    uint8, depth_m (V, H, W) metres, c2w (V, 4, 4), K (3, 3) normalized."""
    from vicasplat_tpu_torch.utils.host_image import encode_jpegs
    from vicasplat_tpu_torch.utils.image_io import encode_png

    for sub in ("color", "depth", "intrinsic"):
        (d / sub).mkdir(parents=True, exist_ok=True)
    for i, jpg in enumerate(encode_jpegs(frames, quality=95)):
        (d / "color" / f"{i}.jpg").write_bytes(jpg)
    from concurrent.futures import ThreadPoolExecutor

    mm = np.clip(np.round(np.nan_to_num(depth_m) * 1000.0), 0, 65535).astype(np.uint16)
    with ThreadPoolExecutor(max_workers=8) as pool:  # zlib releases the GIL
        list(pool.map(lambda i: (d / "depth" / f"{i}.png").write_bytes(encode_png(mm[i])),
                      range(len(mm))))
    np.save(d / "extrinsics.npy", np.asarray(c2w, np.float32))
    h, w = frames.shape[1:3]
    K4 = np.eye(4)
    K4[:3, :3] = K
    K4[0, :3] *= w
    K4[1, :3] *= h
    np.savetxt(d / "intrinsic" / "intrinsic_color.txt", K4)


def distill_teacher_leaf(path: str, shape: tuple, seed: int = DISTILL_SEED) -> np.ndarray:
    """One teacher leaf in the JAX layout by its tree path 'a/b/w'
    (tools/jax_distill_reference.teacher_leaf's recipe)."""
    import zlib

    rng = np.random.default_rng([seed, zlib.crc32(path.encode())])
    name = path.rsplit("/", 1)[-1]
    if name == "w":
        window = int(np.prod(shape[:-2])) if len(shape) == 4 else 1
        std = np.sqrt(2.0 / (window * (shape[-2] + shape[-1])))
        return rng.normal(0, std, shape).astype(np.float32)
    if name == "scale":
        return (1.0 + rng.normal(0, 0.05, shape)).astype(np.float32)
    return rng.normal(0, 0.02, shape).astype(np.float32)


def distill_reference_batch(seed: int = DISTILL_SEED, B: int = 2, T: int = 2, V: int = 2,
                            hw: int = 64) -> dict:
    """The reference's batch as float32 numpy
    (tools/jax_distill_reference.reference_batch's recipe)."""
    rng = np.random.default_rng(seed)
    K = np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]], np.float32)

    def views(n, first_identity):
        ext = np.tile(np.eye(4, dtype=np.float32), (B, n, 1, 1))
        th = rng.uniform(-0.2, 0.2, (B, n))
        ext[..., 0, 0], ext[..., 0, 2] = np.cos(th), np.sin(th)
        ext[..., 2, 0], ext[..., 2, 2] = -np.sin(th), np.cos(th)
        ext[..., :3, 3] = rng.normal(0, 0.2, (B, n, 3))
        if first_identity:
            ext[:, 0] = np.eye(4, dtype=np.float32)
        return {"image": rng.uniform(0, 1, (B, n, hw, hw, 3)).astype(np.float32),
                "intrinsics": np.tile(K, (B, n, 1, 1)), "extrinsics": ext,
                "near": np.full((B, n), 0.5, np.float32),
                "far": np.full((B, n), 100.0, np.float32)}

    return {"context": views(T, True), "target": views(V, False)}


def distill_teacher(dev, seed: int = DISTILL_SEED):
    """The reference's small teacher on the card, its leaves drawn by
    `distill_teacher_leaf` through the port's JAX leaf specs."""
    from vicasplat_tpu_torch.models.dust3r import Dust3R, Dust3RConfig
    from vicasplat_tpu_torch.utils.checkpointing import from_jax_leaves, jax_leaf_specs

    with torch.device(dev):
        model = Dust3R(Dust3RConfig(**DISTILL_TEACHER))
    leaves = [distill_teacher_leaf("/".join(path), shape, seed)
              for path, shape in jax_leaf_specs(model)]
    model.load_state_dict(from_jax_leaves(model, leaves, dict(model.named_parameters())))
    return model


def distill_reference_steps(dev, reset_counts=lambda: None, counts=dict) -> list:
    """Two float32 steps of the reference's student (the committed
    synthetic_pose weights) and teacher on `dev`: [(JAX's logs, phase,
    the port's logs, launches)] a step."""
    from vicasplat_tpu_torch import main as tmain
    from vicasplat_tpu_torch.models.dust3r import make_teacher_fn
    from vicasplat_tpu_torch.training import make_train_step
    from vicasplat_tpu_torch.training.step import pick_phase
    from vicasplat_tpu_torch.utils.config import parse_cli

    dev = torch.device(dev)
    ref = json.loads((ROOT / DISTILL_REF).read_text())
    if ref["teacher"] != DISTILL_TEACHER or ref["seed"] != DISTILL_SEED:
        raise AssertionError(f"{DISTILL_REF} was made for another teacher or seed")
    cfg = parse_cli(["+experiment=synthetic_pose", *ref["overrides"],
                     f"checkpointing.load={ROOT / EVAL_NPZ}"])
    train_cfg, model, opt = tmain.build_all(cfg, dev)
    step = make_train_step(train_cfg, model, opt,
                           teacher_fn=make_teacher_fn(distill_teacher(dev), torch.float32))
    batch = {k: {n: torch.from_numpy(x).to(dev) for n, x in v.items()}
             for k, v in distill_reference_batch().items()}
    out = []
    for want in ref["steps"]:
        ph = pick_phase(train_cfg, want["step"], True)
        reset_counts()
        logs = step(batch, want["step"], ph)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out.append((want, ph, {k: float(v) for k, v in logs.items()}, counts()))
    return out


def distill_gaps(want: dict, ph: str, got: dict):
    """(relative gaps, the scalars off by more than DISTILL_TOL) of one
    step's logs against JAX's; a phase or a set of logs that differs is
    off as a whole."""
    keys = [k for k in want if k not in ("step", "phase")]
    if ph != want["phase"] or sorted(got) != sorted(keys):
        return {}, [f"phase {ph}, logs {sorted(got)}; JAX's {want['phase']}, {keys}"]
    gaps = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-30) for k in keys}
    return gaps, [k for k in keys
                  if not abs(got[k] - want[k]) <= DISTILL_TOL * abs(want[k]) + 1e-6]


def distill_reference_run(dev, reset_counts, counts, zero) -> dict:
    """The float32 reference on the card, each logged scalar held to the JAX
    package's (DISTILL_TOL); K1's float32 route 4 + 4 a step (the student's
    4 decoder blocks, no remat)."""
    out = []
    for want, ph, got, launches in distill_reference_steps(dev, reset_counts, counts):
        i = want["step"]
        expect_launches(f"distill reference step {i}", launches,
                        dict(zero, flash_attn_f32=4, flash_attn_f32_bwd=4))
        gaps, bad = distill_gaps(want, ph, got)
        if bad:
            raise AssertionError(f"distill reference step {i} ({ph}): {bad} off, port {got}, "
                                 f"JAX {want}")
        out.append(dict(step=i, phase=ph, port=got, jax={k: want[k] for k in gaps},
                        rel_gaps=gaps, launches=launches))
    torch.cuda.empty_cache()
    return {"steps": out}


def distill_phase(dev, smi, reset_counts, counts, zero):
    """Phase distill (see the module's docstring)."""
    import gc
    import shutil

    from vicasplat_tpu_torch.kernels import flash_attn
    from vicasplat_tpu_torch.models import VicaNetConfig, dust3r
    from vicasplat_tpu_torch.models.dust3r import Dust3RConfig, init_dust3r, make_teacher_fn
    from vicasplat_tpu_torch.utils.ckpt_convert import export_dust3r_state_dict

    t0 = time.perf_counter()
    rec = {"reference": distill_reference_run(dev, reset_counts, counts, zero)}
    for st in rec["reference"]["steps"]:
        phase("distill", t0, f"[{smi}] float32 reference, step {st['step']} ({st['phase']}), "
              "port (JAX): " + ", ".join(f"{k} {st['port'][k]:.6f} ({st['jax'][k]:.6f})"
                                         for k in sorted(st["jax"]))
              + "; largest relative gap " + f"{max(st['rel_gaps'].values()):.2e} "
              f"(tol {DISTILL_TOL}); launches {st['launches']}")

    dec_depth = VicaNetConfig().dec_depth
    chunks = ROOT / "build/chip_smoke_re10k/re10k"
    out = ROOT / "build/chip_smoke_distill"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    # the teacher's checkpoint: the full-size DUSt3R from a seeded generator,
    # its heads' last conv scaled, in the DUSt3R layout (bf16 to halve the
    # write); the train mode reads it through $DISTILLER_CKPT
    t1 = time.perf_counter()
    teacher = init_dust3r(Dust3RConfig(img_size=256), torch.Generator(dev).manual_seed(1), dev)
    with torch.no_grad():
        for head in (teacher.head1, teacher.head2):
            head.head["conv3"].weight.mul_(DISTILL_HEAD_SCALE)
    state = {k: v.to(torch.bfloat16) for k, v in teacher.state_dict().items()}
    ckpt = out / "mast3r.ckpt"
    torch.save({"model": export_dust3r_state_dict(state)}, ckpt)
    n_teacher = sum(v.numel() for v in state.values())
    probe = {k: state[k].float().cpu() for k in ("head1.head.conv3.weight",
                                                 "dec_blocks2.11.cross_attn.projv.weight")}
    del teacher, state
    phase("distill", t0, f"teacher checkpoint: {n_teacher} parameters, "
          f"{ckpt.stat().st_size} bytes, written in {time.perf_counter() - t1:.1f} s")
    loaded = []

    def keep_teacher(model, dtype):
        loaded.append({k: model.state_dict()[k].float().cpu() for k in probe})
        return make_teacher_fn(model, dtype)

    seen = []  # K1's backward on the first call's own inputs
    roots = "[" + ",".join([str(chunks)] * DISTILL_ROOT_COPIES) + "]"

    def prepare(A):
        shutil.rmtree(out / "run", ignore_errors=True)
        seen.clear()
        return ["+experiment=distill", "mode=train", f"dataset.re10k.roots={roots}",
                f"trainer.max_steps={DISTILL_STEPS}", "train.distill_only_steps=1",
                "train.distill_max_steps=1", f"train.accumulate_grad_batches={A}",
                "encoder.dpt_stabilize=true",
                "train.print_log_every_n_steps=1", "trainer.val_check_interval=0",
                f"output_dir={out}/run", f"checkpointing.output_dir={out}/run/ckpts",
                "wandb.mode=disabled"]

    with mock.patch.dict(os.environ, {"DISTILLER_CKPT": str(ckpt)}), \
            mock.patch.object(dust3r, "make_teacher_fn", keep_teacher), \
            mock.patch.object(flash_attn._FlashAttention, "backward", k1_bwd_keeper(seen)):
        A, tr, cuts = split_train_run(dev, "distill", t0, DISTILL_ACCUMULATE, prepare, 24,
                                      reset_counts, counts)
    if not loaded or any(not torch.equal(loaded[-1][k], probe[k]) for k in probe):
        raise AssertionError("the train mode's teacher is not the checkpoint's")
    steps = tr["steps"]
    phases = [st["phase"] for st in steps]
    if phases != ["distill_only", "distill"]:
        raise AssertionError(f"distill train mode phases {phases}")
    terms = [("distillation" in st, "mse" in st) for st in steps]
    if terms != [(True, False), (True, True)]:
        raise AssertionError(f"distill train mode (distillation, mse) logged {terms}")
    for st in steps:
        expect_launches(f"distill train step {st['step']}", st["launches"],
                        dict(zero, flash_attn=2 * dec_depth * A, flash_attn_bwd=dec_depth * A))
    for st in steps:
        phase("distill", t0, f"[{smi}] distill experiment, step {st['step']} ({st['phase']}): "
              f"{st['ms']:.1f} ms, peak {st['peak_gb']:.1f} GB, losses "
              + ", ".join(f"{k} {st[k]:.5f}" for k in ("loss", "camera", "distillation", "mse",
                                                       "psnr", "grad_norm") if k in st)
              + f", launches {st['launches']}")
    phase("distill", t0, f"[{smi}] distill experiment at full width from re10k's chunks, "
          f"the teacher from {ckpt.name} through the converter: batch 24 (2 context, 4 "
          f"targets, 256^2) as {A} micro-batches of {24 // A}; splits that ran out of "
          f"memory {[c['micro'] for c in cuts] or 'none'}; scenes {steps[0]['scenes']}; run "
          f"{tr['wall_s']:.1f} s, peak {tr['peak_gb']:.1f} GB")
    rec["train"] = dict(accumulate=A, splits=cuts, wall_s=tr["wall_s"], peak_gb=tr["peak_gb"],
                        teacher_parameters=n_teacher,
                        steps=[{k: v for k, v in st.items() if k != "scenes"} for st in steps])
    del tr
    # K1 at this path's own shape (q 2 x 257 rows a micro-batch example, a
    # last q tile of 2 rows), forward and backward, on the first call's inputs
    q, k, v, o, lse, do = seen.pop()
    rec["k1"] = flash_phase(dev, {"distill": [(q, k, v)]})["distill"]
    rec["k1_bwd"] = own_rounding(k1_bwd_held(q, k, v, o, lse, do,
                                             what="K1 backward on the distill step's inputs"))
    phase("distill", t0, f"K1 on the first step's own inputs, {rec['k1']['shape']}: forward "
          f"max abs err {rec['k1']['max_abs_err']:.3e} (tol {FLASH_TOL}); backward relative "
          "errors " + ", ".join(
              f"{nm} {e['rel']:.2e} (tol {2 * e['sdpa_rel'] + FLASH_BWD_FLOOR:.2e})"
              for nm, e in rec["k1_bwd"].items() if nm != "dq_own") + own_line(rec["k1_bwd"]))
    del q, k, v, o, lse, do
    shutil.rmtree(out, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    rec["wall_s"] = time.perf_counter() - t0
    return rec



# ---------------------------------------------------------------------------
# parallel: the MoE flagship, every parallel route at world 1, a world-2 DDP
# step on the one card, the brute-force render oracle, the memory reckoning
# ---------------------------------------------------------------------------

def moe_flagship_config(E: int, **kw):
    """configs/experiment/re10k_8view.yaml's widths with MoE decoder MLPs."""
    from vicasplat_tpu_torch.models import (
        GaussianAdapterConfig,
        VicaNetConfig,
        VicaSplatConfig,
    )

    return VicaSplatConfig(
        backbone=VicaNetConfig(moe_experts=E, moe_top_k=MOE_TOP_K,
                               moe_capacity_factor=MOE_CAPACITY),
        gaussian_adapter=GaussianAdapterConfig(sh_degree=4), **kw)


def route_train_config(model=None):
    """The flagship's train config (or its MoE flagship's, `model`) for the
    training routes' steps, with a linear warm-up in place of the cosine
    schedule's: its first optimizer call has lr 4e-5, not 0, so one step
    from the init weights both takes the gradient and updates."""
    from vicasplat_tpu_torch.training.presets import flagship_train_config

    base = flagship_train_config()
    return dataclasses.replace(
        base, model=model or base.model,
        optimizer=dataclasses.replace(base.optimizer, cosine_annealing=False))


def forward_gaps(a, ref):
    """plain-k1's distances between two forwards' outputs."""
    ga, gr = a["gaussians"], ref["gaussians"]
    return {"means_rel": ((ga.means - gr.means).abs().max()
                          / gr.means.abs().max()).item(),
            "opacities_abs": (ga.opacities - gr.opacities).abs().max().item(),
            "poses_abs": (a["gaussian_camera_extrins"]
                          - ref["gaussian_camera_extrins"]).abs().max().item()}


def within(gaps, tol):
    return all(gaps[m] <= tol[m] for m in tol)


def synthetic_pose_setup(dev):
    """configs/experiment/synthetic_pose.yaml's TrainConfig and model from
    the seed, and a batch of DDP_BATCH (4 context frames, 2 targets of
    64^2) from a seed."""
    from vicasplat_tpu_torch.main import build_all
    from vicasplat_tpu_torch.training.presets import flagship_train_batch
    from vicasplat_tpu_torch.utils.config import load_config

    cfg = load_config(ROOT / "configs" / "main.yaml", "synthetic_pose")
    train_cfg, model, opt = build_all(cfg, dev)
    batch = flagship_train_batch(dev, DDP_BATCH, 2, size=64, T=4)
    return train_cfg, model, opt, batch


def step_gaps(got, ref):
    """Relative gaps of the loss, the gradient norm and each group's
    gradient norm; the largest parameter-sum gap, absolute."""
    gaps = {"loss": rel(got["loss"], ref["loss"]),
            "grad_norm": rel(got["grad_norm"], ref["grad_norm"]),
            "group_norms": max(rel(got["group_norms"][k], v)
                               for k, v in ref["group_norms"].items())}
    gaps["param_sums"] = max(abs(got["param_sums"][k] - v)
                             for k, v in ref["param_sums"].items())
    return gaps


def ddp_child(rank: int, root: str):
    """One rank of the world-2 DDP step: both ranks on cuda:0 over gloo,
    each with its half of the synthetic_pose batch. Writes its record to
    root/rank<r>.json."""
    import datetime

    import torch.distributed as dist

    from vicasplat_tpu_torch.kernels import COUNTERS, launch_counts
    from vicasplat_tpu_torch.training import make_train_step

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(root, "store"), 2),
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=300))
    try:
        train_cfg, model, opt, batch = synthetic_pose_setup(dev)
        n = DDP_BATCH // 2
        mine = {v: {k: x[rank * n:(rank + 1) * n] for k, x in views.items()}
                for v, views in batch.items()}
        step = make_train_step(train_cfg, model, opt, ddp_group=dist.group.WORLD)
        for fn, attr in COUNTERS.values():
            setattr(fn, attr, 0)
        torch.cuda.synchronize()
        t = time.perf_counter()
        logs = step(mine, DDP_STEP)
        torch.cuda.synchronize()
        rec = step_record(model, logs, step_fn=step)
        rec.update(ms=(time.perf_counter() - t) * 1e3, launches=launch_counts(),
                   backend=str(dist.get_backend()))
    finally:
        dist.destroy_process_group()
    pathlib.Path(root, f"rank{rank}.json").write_text(json.dumps(rec))


def start_children(root: pathlib.Path, flag: str):
    """A world-2 group's two processes (`chip_smoke.py <flag> RANK root`:
    --ddp-child or --route-child), their output in root/rank<r>.log; one
    intra-op thread each, beside the parent's work."""
    root.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    procs = []
    for r in range(2):
        with open(root / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), flag, str(r), str(root)],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs


def finish_children(procs, root: pathlib.Path, timeout: float = 400) -> list:
    for r, p in enumerate(procs):
        if p.wait(timeout=timeout) != 0:
            raise AssertionError(f"{root.name} rank {r} exited {p.returncode}:\n"
                                 + (root / f"rank{r}.log").read_text()[-4000:])
    return [json.loads((root / f"rank{r}.json").read_text()) for r in range(2)]


def oracle_scene():
    """tests/test_torch_raster_reference.py's scene: 64 splats in front of
    an identity camera, 32^2, SH degree 0, drawn by numpy from seed 0."""
    from vicasplat_tpu_torch.ops.rasterize.projection import cov6_from_scale_rot

    rng = np.random.default_rng(0)
    n = 64
    means = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    means[:, 2] += 3.0
    scales = rng.uniform(0.02, 0.1, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    t = torch.from_numpy
    return (t(means), cov6_from_scale_rot(t(scales), t(quats)),
            t((rng.normal(size=(n, 3, 1)) * 0.3).astype(np.float32)),
            t(rng.uniform(0.3, 0.9, n).astype(np.float32)), torch.eye(4)[None],
            torch.tensor([[[1.2, 0.0, 0.5], [0.0, 1.2, 0.5], [0.0, 0.0, 1.0]]]))


def oracle_gaps(dev, smi):
    """The brute-force oracle (ops/rasterize/reference.py) beside the tiled
    renders, the default and the accelerator configuration, all on the card:
    on the CPU test's scene held within its tolerances; on the render
    phase's 1,000-splat scene held within them too, at the caps where
    nothing is cut, against the oracle with the tiles' 3-sigma support; on
    the covering scene (524,288 Gaussians, 256^2) the gaps printed."""
    from vicasplat_tpu_torch.ops.rasterize import RasterizeConfig
    from vicasplat_tpu_torch.ops.rasterize import reference as oracle
    from vicasplat_tpu_torch.ops.rasterize.render import coverage_stats, render

    def gaps(got, ref):
        return {f: (a[0] - r.to(a.device)).abs().max().item()
                for f, a, r in zip(("color", "depth", "alpha"), got, ref)}

    def accel(**kw):
        return RasterizeConfig(backend="pallas", binning="origin", **kw)

    t0 = time.perf_counter()
    rec = {}
    small = dict(tile_px=8, dup_hw=(4, 4), max_per_tile=64, chunk=32, tile_group=16,
                 pallas_chunk=32)
    means, cov6, sh, opac, ext, K = (x.to(dev) for x in oracle_scene())
    bg = torch.zeros(3, device=dev)
    ref = oracle.render_view_bruteforce(means, cov6, sh, opac, ext[0], K[0], (32, 32),
                                        bg, 0)
    for name, rc in (("default", RasterizeConfig(**small)), ("accel", accel(**small))):
        g = gaps(render(means, cov6, sh, opac, ext, K, (32, 32), bg, 0, cfg=rc), ref)
        rec[f"test_scene_{name}"] = g
        if not all(g[f] <= ORACLE_TOL[f] for f in ORACLE_TOL):
            raise AssertionError(f"{name} render of the test scene vs the oracle: {g} "
                                 f"(tol {ORACLE_TOL})")
    # the render phase's scene at dup (4, 4), where coverage_stats reports no
    # splat truncated and no tile full, against the oracle with the tiles'
    # 3-sigma support (the plain oracle's gap printed beside it)
    means, cov6, sh, opac, ext, K = (x.to(dev) for x in small_scene())
    for v in range(ext.shape[0]):
        view = torch.linalg.inv(ext[v])
        args = (means, cov6, sh, opac, view, K[v], (96, 128), bg, 4)
        plain = oracle.render_view_bruteforce(*args)
        ref = oracle.render_view_bruteforce(*args, support_tile_px=16)
        for name, rc in (("default", RasterizeConfig(dup_hw=(4, 4))),
                         ("accel", accel(dup_hw=(4, 4)))):
            cov = coverage_stats(*args[:7], 4, cfg=rc)
            if float(cov["truncated_frac"]) or float(cov["tile_overflow_frac"]):
                raise AssertionError(f"1,000-splat scene, view {v}: caps cut {cov}")
            got = render(means, cov6, sh, opac, ext[v:v + 1], K[v:v + 1], (96, 128), bg,
                         4, cfg=rc)
            g = gaps(got, ref)
            rec.setdefault(f"render_scene_{name}", []).append(
                {"support": g, "plain": gaps(got, plain)})
            if not all(g[f] <= ORACLE_TOL[f] for f in ORACLE_TOL):
                raise AssertionError(f"{name} render of the 1,000-splat scene, view {v}, "
                                     f"vs the oracle: {g} (tol {ORACLE_TOL})")
    phase("parallel", t0, "oracle: the CPU test's scene (64 splats, 32^2) default "
          f"{rec['test_scene_default']}, accel {rec['test_scene_accel']} (tol "
          f"{ORACLE_TOL}); the render phase's 1,000-splat scene (2 views of 96 x 128, "
          "dup (4, 4), nothing truncated), gaps to the oracle with the tiles' support | "
          "to the plain oracle: "
          + "; ".join(f"{n} view {v}: " + ", ".join(
              f"{f} {r['support'][f]:.2e} | {r['plain'][f]:.2e}" for f in r["support"])
              for n in ("default", "accel")
              for v, r in enumerate(rec[f"render_scene_{n}"])))

    t0 = time.perf_counter()
    args = covering_scene(dev)
    means, cov6, sh, opac, ext, K, shape, bg, deg = args
    view = torch.linalg.inv(ext[0])
    torch.cuda.synchronize()
    o0 = time.perf_counter()
    ref = oracle.render_view_bruteforce_chunked(means, cov6, sh, opac, view, K[0],
                                                shape, bg, deg, px_chunk=ORACLE_CHUNK)
    torch.cuda.synchronize()
    scene = {"oracle_s": time.perf_counter() - o0}
    for name, rc in (("default", RasterizeConfig()), ("accel", accel())):
        got = render(*args, cfg=rc)
        err = {f: (a[0] - r).abs() for f, a, r in zip(("color", "depth", "alpha"), got, ref)}
        scene[name] = {f: {"max": e.max().item(), "mean": e.mean().item()}
                       for f, e in err.items()}
        cov = coverage_stats(means, cov6, sh, opac, view, K[0], shape, deg, cfg=rc)
        scene[name]["coverage"] = {k: float(x) for k, x in cov.items()}
    rec["covering"] = scene
    phase("parallel", t0, f"[{smi}] oracle on the covering scene (524288 Gaussians, "
          f"256^2, chunks of {ORACLE_CHUNK} pixels): {scene['oracle_s']:.2f} s; gaps "
          "to it "
          + "; ".join(f"{n}: color max {scene[n]['color']['max']:.4f} mean "
                      f"{scene[n]['color']['mean']:.2e}, alpha max "
                      f"{scene[n]['alpha']['max']:.4f} mean {scene[n]['alpha']['mean']:.2e}"
                      f" (truncated {scene[n]['coverage']['truncated_frac']:.4f}, tiles "
                      f"full {scene[n]['coverage']['tile_overflow_frac']:.4f})"
                      for n in ("default", "accel")))
    del ref, args
    return rec


def route_steps(dev, cfg, batch, model, step_fn, reset_counts, counts, want,
                spy_k1=False, label="", steps=(0,), updates=False):
    """Train steps at the global step indices `steps` on `batch`: each one's step_record (with its update when `updates`), host
    ms and launches, held exactly to `want`; with spy_k1, the first K1
    backward call's inputs. Returns the records, the peak allocated GB and
    those inputs."""
    from vicasplat_tpu_torch.kernels import flash_attn
    from vicasplat_tpu_torch.kernels.flash_attn import flash_attention_backward

    seen = []

    def spy(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        if not seen:
            seen.append((q, k, v, o, lse, do))
        return flash_attention_backward(q, k, v, o, lse, do)

    recs = []
    torch.cuda.reset_peak_memory_stats()
    for i in steps:
        before = host_copy(model) if updates else None
        reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        if spy_k1 and not recs:
            with mock.patch.object(flash_attn._FlashAttention, "backward",
                                   staticmethod(spy)):
                logs = step_fn(batch, i)
        else:
            logs = step_fn(batch, i)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        launches = counts()
        if launches != want:
            raise AssertionError(f"{label} step {i} launches {launches}, not {want}")
        rec = step_record(model, logs, before=before, step_fn=step_fn)
        if rec["nonfinite"] or not all(math.isfinite(v) for v in (rec["loss"],
                                                                  rec["grad_norm"])):
            raise AssertionError(f"{label} step {i}: {rec}")
        rec.update(ms=ms, launches=launches, step=i)
        recs.append(rec)
        del before
    peak = torch.cuda.max_memory_allocated() / 1e9
    return recs, peak, seen


# the world-2 training routes' jobs: the witness (light, at once, beside
# this process's steps), then the flagship's once this process's steps that
# need most of the card are done (root/go; EP's once this process's work
# beside SP and TP is done: root/go_ep); "ref" names the world-1 step each
# is held against
WITNESS_JOBS = ({"name": "sp witness", "model": "pose", "route": "sp", "ref": "pose"},
                {"name": "tp witness", "model": "pose", "route": "tp", "ref": "pose"},
                {"name": "ep witness", "model": "pose_moe", "route": "ep",
                 "ref": "pose_moe"})


def flagship_jobs(E: int) -> list:
    return [{"name": "sp", "model": "flagship", "route": "sp", "ref": "flagship",
             "B": ROUTE_BATCH, "V": ROUTE_TARGETS},
            {"name": "tp", "model": "flagship", "route": "tp", "ref": "flagship",
             "B": ROUTE_BATCH, "V": ROUTE_TARGETS},
            {"name": "ep", "model": "moe", "route": "ep", "ref": "moe", "B": 2,
             "V": EP_TARGETS, "E": E, "after": "go_ep"}]


def route_setup(job: dict, dev, world2: bool):
    """A training route's job: (train config, model from seed 0, batch, the
    step's keyword arguments, K1 launches a step), for step 0 of
    route_train_config: "flagship" and "moe" (with job["E"] experts) at
    batch job["B"] x (8 + job["V"]) in bf16; "pose" and "pose_moe"
    (synthetic_pose's TrainConfig and batch of DDP_BATCH, its decoder MLPs
    MoE) in float32, with the same linear warm-up. At world 2 the model is
    sliced for the job's route on its (1 x 2) mesh and the batch is this
    rank's slice."""
    from vicasplat_tpu_torch import parallel as par
    from vicasplat_tpu_torch.models import init_vicasplat
    from vicasplat_tpu_torch.training.presets import flagship_train_batch

    if job["model"] in ("flagship", "moe"):
        base = route_train_config()
        cfg = base if job["model"] == "flagship" else route_train_config(
            moe_flagship_config(job["E"], pts3d_bounds=base.model.pts3d_bounds))
        batch = flagship_train_batch(dev, job["B"], job["V"])
    else:
        cfg, _, _, batch = synthetic_pose_setup(dev)
        cfg = dataclasses.replace(cfg, dtype="float32", optimizer=dataclasses.replace(
            cfg.optimizer, cosine_annealing=False, warm_up_steps=1))
        if job["model"] == "pose_moe":
            cfg = dataclasses.replace(cfg, model=dataclasses.replace(
                cfg.model, backbone=dataclasses.replace(
                    cfg.model.backbone, moe_experts=MOE_EXPERTS, moe_top_k=MOE_TOP_K,
                    moe_capacity_factor=MOE_CAPACITY)))
    model = init_vicasplat(cfg.model, torch.Generator(device=dev).manual_seed(0), dev)
    kw = {}
    if world2:
        if job["route"] == "sp":
            mesh = kw["sp_mesh"] = par.make_mesh_sp(1, 2)
        elif job["route"] == "tp":
            mesh = par.make_mesh_2d(1, 2)
            par.shard_params_tp(mesh, model)
        else:
            mesh = par.make_mesh_ep(1, 2)
            par.shard_params_ep(mesh, model)
        batch = par.shard_batch(mesh, batch, ("data", "expert") if job["route"] == "ep"
                                else "data")
    d = cfg.model.backbone.dec_depth  # remat replays each forward
    k1 = ("flash_attn", "flash_attn_bwd") if cfg.dtype == "bfloat16" else (
        "flash_attn_f32", "flash_attn_f32_bwd")
    return cfg, model, batch, kw, {k1[0]: (1 + cfg.remat) * d, k1[1]: d}


def route_run(job: dict, dev, reset_counts, counts, zero, world2: bool) -> dict:
    """One step of a job (route_setup) with its update: route_steps' record,
    peak GB, wall s and the parameters a rank; K1's backward held on the
    world-2 SP flagship step's own inputs."""
    from vicasplat_tpu_torch.training import AdamW, make_train_step

    t0 = time.perf_counter()
    cfg, model, batch, kw, k1 = route_setup(job, dev, world2)
    opt = AdamW(model, cfg.optimizer)
    step = make_train_step(cfg, model, opt, **kw)
    spy = world2 and job["name"] == "sp"
    steps, peak, seen = route_steps(dev, cfg, batch, model, step, reset_counts, counts,
                                    dict(zero, **k1), spy_k1=spy, label=job["name"],
                                    updates=True)
    r = {"step": steps[0], "peak_gb": peak, "wall_s": time.perf_counter() - t0,
         "params_local": sum(p.numel() for p in model.parameters())}
    if spy:
        if not seen:
            raise AssertionError("the SP step's K1 backward was never called")
        r["k1_bwd"] = k1_bwd_held(*seen[0], what="K1 backward on the SP step's inputs")
    return r


def route_child(rank: int, root: str):
    """One rank of the world-2 training routes, both on cuda:0 over gloo
    (route_run of each job): WITNESS_JOBS, then the jobs of root/go
    (written once the parent's steps that need most of the card are done),
    waiting before a job with "after" for that file. Writes
    root/rank<r>.json after each job, with the card's free memory before
    each."""
    import datetime
    import gc

    import torch.distributed as dist

    from vicasplat_tpu_torch.kernels import COUNTERS, build, launch_counts

    torch.backends.cudnn.allow_tf32 = False  # float32 convs in float32, as main()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(root, "store"), 2),
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=300))
    for name in KERNELS:
        build.load(name)

    def reset_counts():
        for fn, attr in COUNTERS.values():
            setattr(fn, attr, 0)

    zero = {name: 0 for name in COUNTERS}
    out = {"backend": str(dist.get_backend()), "free_gb": {}}

    def wait_for(name):
        path, t_wait = pathlib.Path(root, name), time.perf_counter()
        while not path.exists():
            if time.perf_counter() - t_wait > 400:
                raise TimeoutError(f"no {name} from the parent")
            time.sleep(0.2)
        return path.read_text()

    def run(job):
        if "after" in job:
            wait_for(job["after"])
        out["free_gb"][job["name"]] = torch.cuda.mem_get_info()[0] / 1e9
        out[job["name"]] = route_run(job, dev, reset_counts, launch_counts, zero, True)
        gc.collect()
        torch.cuda.empty_cache()
        pathlib.Path(root, f"rank{rank}.json").write_text(json.dumps(out))

    try:
        for job in WITNESS_JOBS:
            run(job)
        for job in json.loads(wait_for("go")):
            run(job)
    finally:
        dist.destroy_process_group()


def world2_held(ranks, refs, jobs):
    """The world-2 jobs' records (one per rank) against their world-1 steps
    (refs[job["ref"]]): each job's route_gaps, held for the witness jobs
    (STEP_TOL, FLASH_BWD_FLOOR) and for the flagship's loss alone
    (FLASH_BWD_FLOOR); the replicated leaves' sums equal on both ranks.
    Returns a row per job."""
    out = {"backend": ranks[0]["backend"]}
    for job in jobs:
        name, rs = job["name"], [r[job["name"]] for r in ranks]
        got = [r["step"] for r in rs]
        gaps = route_gaps(got[0], refs[job["ref"]])
        held = gaps if job["model"].startswith("pose") else {"loss": gaps["loss"]}
        tol = {k: STEP_TOL if k == "loss" and job["model"].startswith("pose")
               else FLASH_BWD_FLOOR for k in held}
        bad = {k: (v, tol[k]) for k, v in held.items() if not v <= tol[k]}
        if bad:
            raise AssertionError(f"world-2 {name} against world 1: {bad}")
        replicas = max(abs(got[0]["replica_sums"][k] - v)
                       for k, v in got[1]["replica_sums"].items())
        if replicas != 0.0:
            raise AssertionError(f"world-2 {name}: replicas apart by {replicas}")
        worst = max(held, key=lambda k: held[k] / tol[k])
        out[name] = {"ms": [g["ms"] for g in got], "peak_gb": [r["peak_gb"] for r in rs],
                     "launches": got[0]["launches"],
                     "params_local": [r["params_local"] for r in rs],
                     "wall_s": [r["wall_s"] for r in rs],
                     "free_gb_before": [r["free_gb"][name] for r in ranks],
                     "gaps": gaps, "worst_held": (worst, held[worst], tol[worst]),
                     "k1_bwd": [r["k1_bwd"] for r in rs] if "k1_bwd" in rs[0] else None}
    return out


def world1_sp_tp(dev, batch, reset_counts, counts, zero):
    """Step 0 of the flagship on `batch` under SP (make_mesh_sp(1, 1)), then
    under TP (shard_params_tp on make_mesh_2d(1, 1)), on one model from
    seed 0 (step 0's lr is 0, so TP starts from the same weights), in this
    process's world-1 group: {route: (step_record, peak GB)}."""
    from vicasplat_tpu_torch import parallel as par
    from vicasplat_tpu_torch.models import init_vicasplat
    from vicasplat_tpu_torch.training import AdamW, make_train_step
    from vicasplat_tpu_torch.training.presets import flagship_train_config

    cfg = flagship_train_config()
    want = dict(zero, flash_attn=2 * cfg.model.backbone.dec_depth,
                flash_attn_bwd=cfg.model.backbone.dec_depth)
    model = init_vicasplat(cfg.model, torch.Generator(device=dev).manual_seed(0), dev)
    out = {}
    for route in ("sp", "tp"):
        kw = {}
        if route == "sp":
            kw["sp_mesh"] = par.make_mesh_sp(1, 1)
        else:
            par.shard_params_tp(par.make_mesh_2d(1, 1), model)
        step = make_train_step(cfg, model, AdamW(model, cfg.optimizer), **kw)
        steps, peak, _ = route_steps(dev, cfg, batch, model, step, reset_counts, counts,
                                     want, label=f"world-1 {route}", steps=(0,))
        out[route] = (steps[0], peak)
        del step
    return out


def moe_train(dev, E, reset_counts, counts, zero):
    """The MoE flagship's training step (route_train_config) at batch 2 with
    MOE_TARGETS target views from seed 0: steps 0 (gradient and first
    update: the world-1 reference of the EP steps) and 1 (warm), exact
    launch counts, finite logs (route_steps); raises
    torch.cuda.OutOfMemoryError when it does not fit."""
    from vicasplat_tpu_torch.models import init_vicasplat
    from vicasplat_tpu_torch.training import AdamW, make_train_step
    from vicasplat_tpu_torch.training.presets import (
        flagship_train_batch,
        flagship_train_config,
    )

    base = flagship_train_config()
    cfg = route_train_config(moe_flagship_config(
        E, **{k: getattr(base.model, k) for k in ("pts3d_bounds",)}))
    dec_depth = cfg.model.backbone.dec_depth
    model = init_vicasplat(cfg.model, torch.Generator(device=dev).manual_seed(0), dev)
    n_params = sum(p.numel() for p in model.parameters())
    step = make_train_step(cfg, model, AdamW(model, cfg.optimizer))
    batch = flagship_train_batch(dev, 2, MOE_TARGETS)
    want = dict(zero, flash_attn=2 * dec_depth, flash_attn_bwd=dec_depth)
    steps, _, _ = route_steps(dev, cfg, batch, model, step, reset_counts, counts, want,
                              label="MoE train", steps=(0, 1), updates=True)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del model, step
    return dict(E=E, params=n_params, steps=steps, step_ms=[s["ms"] for s in steps[1:]],
                peak_gb=peak)


def parallel_phase(dev, smi, plain_tol, reset_counts, counts, zero, train):
    """See the module docstring's `parallel`; `train` is the train phase's
    record (its step 0 is the plain reference of the world-1 SP and TP
    steps). The world-2 processes are stopped whatever happens."""
    procs = []
    try:
        return _parallel_phase(dev, smi, plain_tol, reset_counts, counts, zero, train,
                               procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _parallel_phase(dev, smi, plain_tol, reset_counts, counts, zero, train, procs):
    import copy
    import gc
    import shutil

    import torch.distributed as dist

    from vicasplat_tpu_torch import parallel as par
    from vicasplat_tpu_torch.decoder.splatting import DecoderSplattingConfig, decoder_forward
    from vicasplat_tpu_torch.models import init_vicasplat, vicasplat_forward
    from vicasplat_tpu_torch.models import moe as moe_lib
    from vicasplat_tpu_torch.models import vicanet as vicanet_lib
    from vicasplat_tpu_torch.models.layers import fill_normal_
    from vicasplat_tpu_torch.models.vicasplat import VicaSplat
    from vicasplat_tpu_torch.ops.rasterize import RasterizeConfig
    from vicasplat_tpu_torch.parallel import memory_proof
    from vicasplat_tpu_torch.parallel.mesh import shard_params_fsdp
    from vicasplat_tpu_torch.training import AdamW, make_train_step
    from vicasplat_tpu_torch.training.presets import (
        flagship_train_batch,
        flagship_train_config,
    )

    rec = {}
    ddp_root = ROOT / "build" / "chip_smoke_ddp"
    route_root = ROOT / "build" / "chip_smoke_routes"
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    # the world-2 processes start first: their start-up, the DDP step and
    # the training routes' witness steps run beside this process's light
    # work; the routes' flagship steps wait for root/go
    shutil.rmtree(ddp_root, ignore_errors=True)
    procs.extend(start_children(ddp_root, "--ddp-child"))
    shutil.rmtree(route_root, ignore_errors=True)
    procs.extend(start_children(route_root, "--route-child"))
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=dev)
    try:
        mesh = par.make_mesh()
        # ---- the MoE flagship's forward in both configurations ----
        cfg = moe_flagship_config(MOE_EXPERTS)
        gen = torch.Generator(device=dev).manual_seed(0)
        model = init_vicasplat(cfg, gen, dev)
        fill_normal_(model.camera_extrinsic_head.proj.weight, 0.02, gen)
        n_params = sum(p.numel() for p in model.parameters())
        model = model.to(torch.bfloat16).eval()
        with torch.device(dev):
            model_acc = VicaSplat(dataclasses.replace(cfg, head_tail_backend="pallas"))
        model_acc = model_acc.to(torch.bfloat16).eval()
        model_acc.load_state_dict(model.state_dict())
        context, tgt_ext, tgt_K = flagship_inputs(dev)
        near = torch.ones(tgt_ext.shape[:2], device=dev)
        far = torch.full(tgt_ext.shape[:2], 100.0, device=dev)
        dec_cfgs = {"default": DecoderSplattingConfig(),
                    "accel": DecoderSplattingConfig(rasterize=RasterizeConfig(
                        backend="pallas", binning="origin"))}
        models = {"default": model, "accel": model_acc}
        dec_depth = cfg.backbone.dec_depth
        wants = {"default": dict(zero, flash_attn=dec_depth),
                 "accel": dict(zero, flash_attn=dec_depth, dpt_tail=1,
                               composite=N_VIEWS, bitonic_topk=N_VIEWS)}
        moe = {"params": n_params}

        def fwd(which, **kw):
            with torch.inference_mode():
                return vicasplat_forward(models[which], context, dtype=torch.bfloat16,
                                         **kw)

        def rnd(out, which):
            with torch.inference_mode():
                return decoder_forward(dec_cfgs[which], out["gaussians"], tgt_ext,
                                       tgt_K, near, far, (256, 256))

        outs = {}
        for which in ("default", "accel"):
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            out = fwd(which)
            r = rnd(out, which)
            torch.cuda.synchronize()
            launches = counts()
            if launches != wants[which]:
                raise AssertionError(f"MoE {which} launches {launches}, not {wants[which]}")
            check_outputs(out, r)
            fwd_ms = statistics.median(cuda_ms(lambda: fwd(which), iters=1, warmup=1)
                                       for _ in range(3))
            rnd_ms = statistics.median(cuda_ms(lambda: rnd(out, which), iters=1, warmup=0)
                                       for _ in range(3))
            moe[which] = dict(launches=launches, forward_ms=fwd_ms, render_ms=rnd_ms,
                              peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                              alpha_mean=r.alpha.float().mean().item())
            outs[which] = (out, r)
            phase("parallel", t0, f"[{smi}] MoE flagship (E {MOE_EXPERTS}, top-"
                  f"{MOE_TOP_K}, capacity factor {MOE_CAPACITY}, {n_params} parameters) "
                  f"{which}: forward of 1 x 8 x 256^2 bf16 + {N_VIEWS}-view render, "
                  f"launches {launches}; forward_ms {fwd_ms:.2f}, render_ms "
                  f"{rnd_ms:.2f}, peak allocated {moe[which]['peak_gb']:.2f} GB")
        reset_counts()
        with mock.patch.object(vicanet_lib, "moe_mlp", moe_lib.moe_mlp_einsum):
            ein = fwd("default")
        if counts() != wants["default"]:
            raise AssertionError(f"einsum forward launches {counts()}")
        gaps = forward_gaps(ein, outs["default"][0])
        moe["einsum_vs_index"] = gaps
        phase("parallel", t0, "MoE dispatch, einsum form against the index form: "
              + ", ".join(f"{m} {gaps[m]:.3e} (tol {plain_tol[m]:.3e})" for m in plain_tol))
        if not within(gaps, plain_tol):
            raise AssertionError(f"einsum and index dispatch disagree: {gaps}")
        del ein

        # ---- every route at world 1 against the call it wraps ----
        routes = {}
        t1 = time.perf_counter()
        out_acc, r_acc = outs["accel"]
        reset_counts()
        with torch.inference_mode():
            vs = par.decoder_forward_view_sharded(dec_cfgs["accel"], out_acc["gaussians"],
                                                  tgt_ext, tgt_K, near, far, (256, 256),
                                                  mesh)
        torch.cuda.synchronize()
        want = dict(zero, composite=N_VIEWS, bitonic_topk=N_VIEWS)
        routes["view_sharded"] = {"max_abs": max((a - b).abs().max().item()
                                                 for a, b in zip(vs, r_acc)),
                                  "launches": counts()}
        if routes["view_sharded"]["launches"] != want:
            raise AssertionError(f"view-sharded render launches "
                                 f"{routes['view_sharded']['launches']}, not {want}")
        if routes["view_sharded"]["max_abs"] > RENDER_TOL:
            raise AssertionError(f"view-sharded render: {routes['view_sharded']}")
        ep_model = copy.deepcopy(model)
        par.shard_params_ep(par.make_mesh_ep(1, 1), ep_model)
        models["ep"] = ep_model
        reset_counts()
        ep_out = fwd("ep", parallel={"ep_group": ep_model.backbone.dec_blocks[0].mlp.ep_group})
        torch.cuda.synchronize()
        ep_launches = counts()
        if ep_launches != wants["default"]:
            raise AssertionError(f"EP forward launches {ep_launches}, not "
                                 f"{wants['default']}")
        routes["ep"] = dict(forward_gaps(ep_out, outs["default"][0]), launches=ep_launches)
        del models["ep"], ep_model, ep_out
        del model, model_acc, models, outs, out_acc, r_acc, vs
        gc.collect()
        torch.cuda.empty_cache()

        # dense flagship for SP, PP and TP (PP refuses MoE, as in JAX)
        dense_cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
            cfg.backbone, moe_experts=0))
        gen = torch.Generator(device=dev).manual_seed(0)
        dense = init_vicasplat(dense_cfg, gen, dev)
        fill_normal_(dense.camera_extrinsic_head.proj.weight, 0.02, gen)
        dense = dense.to(torch.bfloat16).eval()
        models = {"dense": dense}
        ref = fwd("dense")

        def routed(name, **parallel):
            reset_counts()
            out = fwd("dense", parallel=parallel)
            torch.cuda.synchronize()
            launches = counts()
            if launches != wants["default"]:
                raise AssertionError(f"{name} forward launches {launches}, not "
                                     f"{wants['default']}")
            routes[name] = dict(forward_gaps(out, ref), launches=launches)

        routed("sp", sp_mesh=par.make_mesh_sp(1, 1))
        routed("pp", pipeline_group=par.make_mesh_pipe(1))
        par.shard_params_tp(par.make_mesh_2d(1, 1), dense)
        routed("tp")
        del models, dense, ref
        gc.collect()
        torch.cuda.empty_cache()
        for name in ("ep", "sp", "pp", "tp"):
            if not within(routes[name], plain_tol):
                raise AssertionError(f"{name} forward at world 1: {routes[name]} "
                                     f"(tol {plain_tol})")

        # DDP and FSDP2 steps of synthetic_pose against the plain step, each
        # from the same seeded weights
        train_cfg, m, opt, batch = synthetic_pose_setup(dev)
        step = make_train_step(train_cfg, m, opt)
        plain = step_record(m, step(batch, DDP_STEP), step_fn=step)
        for name in ("ddp", "fsdp"):
            del m, opt, step
            gc.collect()
            train_cfg, m, opt, batch = synthetic_pose_setup(dev)
            if name == "fsdp":
                shard_params_fsdp(mesh, m)
                step = make_train_step(train_cfg, m, AdamW(m, train_cfg.optimizer))
            else:
                step = make_train_step(train_cfg, m, opt, ddp_group=mesh.get_group())
            routes[name] = step_gaps(step_record(m, step(batch, DDP_STEP), step_fn=step), plain)
        del m, opt, step
        gc.collect()
        torch.cuda.empty_cache()
        for name in ("ddp", "fsdp"):
            if not (routes[name]["loss"] <= STEP_TOL
                    and routes[name]["grad_norm"] <= FLASH_BWD_FLOOR
                    and routes[name]["group_norms"] <= FLASH_BWD_FLOOR):
                raise AssertionError(f"{name} step at world 1: {routes[name]}")
        phase("parallel", t1, "every route at world 1 (NCCL), against the call it wraps: "
              + "; ".join(f"{k} {v}" for k, v in routes.items())
              + f" (forwards: plain-k1 tol {plain_tol}; steps: loss {STEP_TOL}, "
              f"gradient norms {FLASH_BWD_FLOOR})")
        rec["routes"] = routes

        # ---- the SP and TP steps of the flagship at world 1, against the
        # train phase's step 0 on the same batch and weights ----
        t1 = time.perf_counter()
        B, V = train["batch"], train["targets"]
        w1 = world1_sp_tp(dev, flagship_train_batch(dev, B, V), reset_counts, counts, zero)
        train_w1 = {}
        for name, (got, peak) in w1.items():
            gaps = route_gaps(got, train["step0"])
            train_w1[name] = dict(gaps=gaps, ms=got["ms"], peak_gb=peak,
                                  launches=got["launches"])
        phase("parallel", t1, f"[{smi}] flagship train step at world 1 ({B} x (8 + {V}), "
              "remat dots, step 0) under SP (make_mesh_sp(1, 1)) and then TP "
              "(shard_params_tp on make_mesh_2d(1, 1)), one model from seed 0, against "
              "the train phase's step 0: " + "; ".join(
                  f"{n} {r['ms']:.1f} ms, peak {r['peak_gb']:.2f} GB, launches "
                  f"{r['launches']}, gaps loss {r['gaps']['loss']:.2e}, grad_norm "
                  f"{r['gaps']['grad_norm']:.2e}, worst group "
                  f"{max(v for k, v in r['gaps'].items() if k.startswith('norm')):.2e}"
                  for n, r in train_w1.items())
              + f" (loss {STEP_TOL}, norms {FLASH_BWD_FLOOR})")
        for name, r in train_w1.items():
            if not (r["gaps"]["loss"] <= STEP_TOL and max(
                    v for k, v in r["gaps"].items() if k != "loss") <= FLASH_BWD_FLOOR):
                raise AssertionError(f"{name} step at world 1 against the plain step: "
                                     f"{r['gaps']}")
        del w1
        gc.collect()
        torch.cuda.empty_cache()

        # ---- the MoE flagship's train step ----
        t1 = time.perf_counter()
        cuts = []
        for E in (MOE_EXPERTS, 4):
            try:
                tr = moe_train(dev, E, reset_counts, counts, zero)
                break
            except torch.cuda.OutOfMemoryError:
                cuts.append(f"E {E}: out of memory, peak "
                            f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
                phase("parallel", t1, "cut: " + cuts[-1])
                gc.collect()
                torch.cuda.empty_cache()
        else:
            raise AssertionError(f"the MoE train step fits at no E: {cuts}")
        tr["cuts"] = cuts
        moe["train"] = tr
        phase("parallel", t1, f"[{smi}] MoE flagship train step (E {tr['E']}, "
              f"{tr['params']} parameters), batch 2 x 8 context frames, {MOE_TARGETS} "
              f"targets of 256^2, remat dots, linear warm-up: step ms "
              f"{[round(s['ms'], 1) for s in tr['steps']]} (the first cold), launches "
              f"{tr['steps'][-1]['launches']}, losses "
              f"{[round(s['loss'], 5) for s in tr['steps']]}, peak allocated "
              f"{tr['peak_gb']:.2f} GB; cuts {cuts or 'none'}")
        gc.collect()
        torch.cuda.empty_cache()

        # ---- the EP step of the MoE flagship at world 1 ----
        t1 = time.perf_counter()
        base = flagship_train_config()
        mcfg = route_train_config(moe_flagship_config(
            tr["E"], pts3d_bounds=base.model.pts3d_bounds))
        m = init_vicasplat(mcfg.model, torch.Generator(device=dev).manual_seed(0), dev)
        par.shard_params_ep(par.make_mesh_ep(1, 1), m)
        step = make_train_step(mcfg, m, AdamW(m, mcfg.optimizer))
        want = dict(zero, flash_attn=2 * mcfg.model.backbone.dec_depth,
                    flash_attn_bwd=mcfg.model.backbone.dec_depth)
        ep_steps, ep_peak, _ = route_steps(dev, mcfg, flagship_train_batch(dev, 2, MOE_TARGETS),
                                           m, step, reset_counts, counts, want,
                                           label="world-1 EP", updates=True)
        del m, step
        gc.collect()
        torch.cuda.empty_cache()
        gaps = route_gaps(ep_steps[0], tr["steps"][0])
        train_w1["ep"] = dict(gaps=gaps, ms=ep_steps[0]["ms"], peak_gb=ep_peak,
                              launches=ep_steps[0]["launches"])
        phase("parallel", t1, f"[{smi}] MoE flagship train step at world 1 under EP "
              f"(shard_params_ep on make_mesh_ep(1, 1), its first step) against the "
              f"MoE train step's: {ep_steps[0]['ms']:.1f} ms, peak {ep_peak:.2f} GB, launches "
              f"{ep_steps[0]['launches']}; gaps " + ", ".join(
                  f"{k} {v:.2e}" for k, v in gaps.items())
              + f" (loss {STEP_TOL}, norms and updates {FLASH_BWD_FLOOR})")
        if not (gaps["loss"] <= STEP_TOL and max(
                v for k, v in gaps.items() if k != "loss") <= FLASH_BWD_FLOOR):
            raise AssertionError(f"EP step at world 1 against the plain step: {gaps}")
        rec["train_routes_world1"] = train_w1
    finally:
        dist.destroy_process_group()

    # ---- the world-1 references of the flagship's world-2 steps ----
    t1 = time.perf_counter()
    jobs = flagship_jobs(tr["E"])
    w1_flagship = route_run(dict(jobs[0], name="world-1 flagship"), dev, reset_counts,
                            counts, zero, False)
    refs = {"flagship": w1_flagship["step"],
            "moe": (tr["steps"][0] if EP_TARGETS == MOE_TARGETS else
                    route_run(dict(jobs[2], name="world-1 moe"), dev, reset_counts,
                              counts, zero, False)["step"])}
    gc.collect()
    torch.cuda.empty_cache()
    free_go = torch.cuda.mem_get_info()[0] / 1e9
    (route_root / "go").write_text(json.dumps(jobs))
    t_go = time.perf_counter()

    # ---- beside the world-2 SP and TP steps: the world-1 references of the
    # witness and of the world-2 DDP step, and the render oracle ----
    refs.update((name, route_run({"model": name, "name": f"world-1 {name}"}, dev,
                                 reset_counts, counts, zero, False)["step"])
                for name in ("pose", "pose_moe"))
    ddp_refs = {}
    for A in (2, 1):  # each rank's half as one micro-batch; the whole batch
        train_cfg, m, opt, batch = synthetic_pose_setup(dev)
        step = make_train_step(dataclasses.replace(train_cfg, accumulate_steps=A),
                               m, opt)
        ddp_refs[A] = step_record(m, step(batch, DDP_STEP), step_fn=step)
        del m, opt, step
        gc.collect()
    rec["oracle"] = oracle_gaps(dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    (route_root / "go_ep").write_text("")

    # ---- the memory reckoning beside the measured peak: the reference's
    # step (batch ROUTE_BATCH, 8 + ROUTE_TARGETS) ----
    peak = w1_flagship["peak_gb"] * 1e9
    measured = {"batch": ROUTE_BATCH, "ctx": 8, "tgt": ROUTE_TARGETS, "image": 256,
                "peak_bytes": peak, "peak_gib": peak / 1024**3,
                "step_ms": [w1_flagship["step"]["ms"]]}
    report = memory_proof.flagship_memory_proof(measured=measured)
    rows = report["configs"]
    phase("parallel", t1, f"[{smi}] memory: state a rank reckoned (parameters, gradients, "
          "AdamW) " + ", ".join(f"{k} {v['state_gib']:.2f} GiB" for k, v in rows.items())
          + f"; measured world-1 flagship step (batch {ROUTE_BATCH}, 8 + {ROUTE_TARGETS} "
          f"views, the first) peak {measured['peak_gib']:.2f} GiB, step ms "
          f"{[round(x, 1) for x in measured['step_ms']]}; card "
          f"{report['device_bytes'] / 1024**3:.2f} GiB, {free_go:.2f} GB free before the "
          "world-2 flagship steps")

    # ---- the world-2 DDP step ----
    t1 = time.perf_counter()
    ranks = finish_children(procs[:2], ddp_root)
    want = dict(zero, flash_attn=train_cfg.model.backbone.dec_depth,
                flash_attn_bwd=train_cfg.model.backbone.dec_depth)
    ddp2 = {"ranks": [{k: r[k] for k in ("loss", "grad_norm", "ms", "launches",
                                          "backend", "nonfinite")} for r in ranks],
            "vs_world1_micro": step_gaps(ranks[0], ddp_refs[2]),
            "vs_world1_whole": step_gaps(ranks[0], ddp_refs[1]),
            "replicas": max(abs(ranks[0]["param_sums"][k] - v)
                            for k, v in ranks[1]["param_sums"].items())}
    g = ddp2["vs_world1_micro"]
    phase("parallel", t1, f"[{smi}] world-2 DDP step on cuda:0 over gloo, synthetic_pose "
          f"batch {DDP_BATCH} ({DDP_BATCH // 2} a rank): rank ms "
          f"{[round(r['ms'], 1) for r in ranks]}, launches {ranks[0]['launches']}; against "
          f"world 1 in two micro-batches {g}, against world 1 whole "
          f"{ddp2['vs_world1_whole']}; replicas' parameter sums apart {ddp2['replicas']:.3e}")
    if any(r["launches"] != want for r in ranks):
        raise AssertionError(f"DDP ranks launched {[r['launches'] for r in ranks]}")
    if not (g["loss"] <= STEP_TOL and g["grad_norm"] <= FLASH_BWD_FLOOR
            and g["group_norms"] <= FLASH_BWD_FLOOR and ddp2["replicas"] == 0.0):
        raise AssertionError(f"world-2 DDP step against world 1: {ddp2}")
    rec["ddp2"] = ddp2
    shutil.rmtree(ddp_root, ignore_errors=True)

    # ---- the world-2 training routes against world 1 ----
    t1 = time.perf_counter()
    ranks = finish_children(procs[2:4], route_root)
    w2 = world2_held(ranks, refs, list(WITNESS_JOBS) + jobs)
    rec["train_routes_world2"] = dict(w2, references=refs)

    def row(n):
        r = w2[n]
        return (f"{n}: rank ms {[round(x, 1) for x in r['ms']]}, peak "
                f"{[round(x, 2) for x in r['peak_gb']]} GB, launches {r['launches']}, "
                f"parameters a rank {r['params_local']}, gaps " + ", ".join(
                    f"{k} {v:.2e}" for k, v in r["gaps"].items())
                + f" (worst held against its tolerance {r['worst_held'][0]} "
                f"{r['worst_held'][1]:.2e} / {r['worst_held'][2]:.0e}), replicas equal")

    phase("parallel", t1, f"[{smi}] world-2 witness steps (synthetic_pose and its MoE "
          f"variant, E {MOE_EXPERTS}, float32, batch {DDP_BATCH}, 1 x 2 meshes) on cuda:0 "
          f"over {w2['backend']} against world 1 (loss {STEP_TOL}; norms, update masses "
          f"and signed sums {FLASH_BWD_FLOOR}): "
          + "; ".join(row(j["name"]) for j in WITNESS_JOBS))
    k1b = w2["sp"]["k1_bwd"]
    phase("parallel", t1, f"[{smi}] world-2 SP, TP (flagship, batch {ROUTE_BATCH} x (8 + "
          f"{ROUTE_TARGETS})) and EP (MoE flagship E {tr['E']}, batch 2 x (8 + "
          f"{EP_TARGETS}), 1 a rank) steps, bf16 (gradient and first update, from seed "
          f"0), on cuda:0 over {w2['backend']} (host ms, first calls; gloo moves CUDA "
          f"tensors through the host), {time.perf_counter() - t_go:.1f} s from their "
          f"go, against world 1 (loss {FLASH_BWD_FLOOR}; the norms printed: the "
          "flagship's step from random init is chaotic, see STEP_TOL's comment): "
          + "; ".join(row(j["name"]) for j in jobs)
          + f"; world-1 flagship (batch {ROUTE_BATCH}) ms {refs['flagship']['ms']:.1f}, "
          f"peak {w1_flagship['peak_gb']:.2f} GB; K1 backward on the SP step's own inputs, "
          f"{k1b[0]['shape']}: " + "; ".join(
              f"rank {r} " + ", ".join(f"{nm} {e['rel']:.2e} (tol "
                                       f"{2 * e['sdpa_rel'] + FLASH_BWD_FLOOR:.2e})"
                                       for nm, e in k["errors"].items())
              + f", dQ {k['dq_same_rounding']['ratio']:.3f} of its own rounding's bound"
              for r, k in enumerate(k1b)))
    shutil.rmtree(route_root, ignore_errors=True)
    rec["memory"] = report
    rec["moe"] = moe
    phase("parallel", t0, "done")
    return rec


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs only on a CUDA card", file=sys.stderr)
        sys.exit(1)
    t_start = time.perf_counter()
    from vicasplat_tpu_torch.decoder.splatting import (
        DecoderSplattingConfig,
        decoder_forward,
    )
    from vicasplat_tpu_torch.kernels import (
        COUNTERS,
        attention_reference,
        bitonic_topk,
        build,
        dpt_tail_reference,
        flash_attention,
        fused_dpt_tail,
        launch_counts,
    )
    from vicasplat_tpu_torch.models import (
        GaussianAdapterConfig,
        VicaNetConfig,
        VicaSplatConfig,
        init_vicasplat,
        vicasplat_forward,
    )
    from vicasplat_tpu_torch.models import heads, vicanet
    from vicasplat_tpu_torch.models.layers import fill_normal_, sdpa
    from vicasplat_tpu_torch.models.vicasplat import VicaSplat
    from vicasplat_tpu_torch.ops.rasterize import RasterizeConfig, tiles
    from vicasplat_tpu_torch.ops.rasterize.pallas_composite import composite_tiles_kernel

    # the package exports the function `render` under the module's name
    render_mod = importlib.import_module("vicasplat_tpu_torch.ops.rasterize.render")

    torch.backends.cudnn.allow_tf32 = False  # float32 convs in full float32

    def reset_counts():
        for fn, attr in COUNTERS.values():
            setattr(fn, attr, 0)

    counts = launch_counts
    zero = {name: 0 for name in COUNTERS}

    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    phase("device", t_start, f"{kind} x{torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi: {smi}")

    t0 = time.perf_counter()
    build.build_all(KERNELS)
    for name in KERNELS:
        build.load(name)
        ptxas = [ln.strip() for ln in build.build_logs.get(name, "").splitlines()
                 if "registers" in ln or "spill" in ln or "setmaxnreg" in ln]
        secs = build.build_seconds.get(name)
        phase("build", t0, f"{name} by nvcc in "
              + ("(built before)" if secs is None else f"{secs:.1f} s") + "; "
              + " | ".join(ptxas))

    k1 = flash_phase(dev)

    # ---- the default path (K1 only) ----
    t0 = time.perf_counter()
    cfg = VicaSplatConfig(backbone=VicaNetConfig(),
                          gaussian_adapter=GaussianAdapterConfig(sh_degree=4))
    gen = torch.Generator(device=dev).manual_seed(0)
    model = init_vicasplat(cfg, gen, dev)
    # the camera head starts at zero (identity poses); small random weights
    # make the poses depend on the backbone, so plain-k1 can compare them
    fill_normal_(model.camera_extrinsic_head.proj.weight, 0.02, gen)
    model = model.to(torch.bfloat16).eval()
    context, tgt_ext, tgt_K = flagship_inputs(dev)
    tgt_near = torch.ones(tgt_ext.shape[:2], device=dev)
    tgt_far = torch.full(tgt_ext.shape[:2], 100.0, device=dev)
    dec_depth = cfg.backbone.dec_depth
    # the accelerator serving configuration, on the same weights
    with torch.device(dev):
        model_acc = VicaSplat(dataclasses.replace(cfg, head_tail_backend="pallas"))
    model_acc = model_acc.to(torch.bfloat16).eval()
    model_acc.load_state_dict(model.state_dict())
    configs = {
        "default": (model, DecoderSplattingConfig()),
        "accel": (model_acc, DecoderSplattingConfig(
            rasterize=RasterizeConfig(backend="pallas", binning="origin"))),
    }

    @torch.inference_mode()
    def forward(which="default"):
        return vicasplat_forward(configs[which][0], context, dtype=torch.bfloat16)

    @torch.inference_mode()
    def render(out, which="default", views=N_VIEWS):
        return decoder_forward(configs[which][1], out["gaussians"],
                               tgt_ext[:, :views], tgt_K[:, :views],
                               tgt_near[:, :views], tgt_far[:, :views], (256, 256))

    reset_counts()
    out = forward()
    rendered = render(out)
    torch.cuda.synchronize()
    launches = counts()
    want = dict(zero, flash_attn=dec_depth)
    if launches != want:
        raise AssertionError(f"default path launches {launches}, not {want}")
    n_gauss = check_outputs(out, rendered)
    render_err, render_tol, render_cover = render_check(dev, RasterizeConfig())
    if not render_err < render_tol:
        raise AssertionError(f"render on the card vs CPU: {render_err}")
    phase("flagship", t0, f"default: render check vs CPU: max abs err "
          f"{render_err:.2e} (tol {render_tol}, alpha mean {render_cover:.3f}); "
          f"{n_gauss} Gaussians, poses {tuple(out['gaussian_camera_extrins'].shape)}, "
          f"color {tuple(rendered.color.shape)}, all finite; launches {launches}; "
          f"alpha mean {rendered.alpha.float().mean().item():.4f}")

    # ---- the accelerator path (K1, K3, K2, K4) ----
    t0 = time.perf_counter()
    reset_counts()
    out_acc = forward("accel")
    rendered_acc = render(out_acc, "accel")
    torch.cuda.synchronize()
    launches_acc = counts()
    want = dict(zero, flash_attn=dec_depth, dpt_tail=1, composite=N_VIEWS,
                bitonic_topk=N_VIEWS)
    if launches_acc != want:
        raise AssertionError(f"accelerator path launches {launches_acc}, not {want}")
    check_outputs(out_acc, rendered_acc)
    phase("accel", t0, f"forward + {N_VIEWS}-view render: launches {launches_acc}; "
          f"color {tuple(rendered_acc.color.shape)}, all finite; alpha mean "
          f"{rendered_acc.alpha.float().mean().item():.4f}")

    # ---- each kernel on the inputs the accelerator path gives it ----
    seen = {}

    def spy(name, fn):
        def wrapped(*args):
            seen.setdefault(name, args)
            return fn(*args)
        return wrapped

    with mock.patch.object(heads, "fused_dpt_tail", spy("k3", fused_dpt_tail)), \
            mock.patch.object(tiles, "bitonic_topk", spy("k4", bitonic_topk)), \
            mock.patch.object(render_mod, "composite_tiles_kernel",
                              spy("k2", composite_tiles_kernel)):
        render(forward("accel"), "accel", views=1)
    rcfg = configs["accel"][1].rasterize
    # the covering scene, seen through the same render path
    t0 = time.perf_counter()
    flagship_seen, seen = seen, {}
    with torch.inference_mode(), \
            mock.patch.object(tiles, "bitonic_topk", spy("k4", bitonic_topk)), \
            mock.patch.object(render_mod, "composite_tiles_kernel",
                              spy("k2", composite_tiles_kernel)):
        scene_out = render_mod.render(*covering_scene(dev), cfg=rcfg)
        torch.cuda.synchronize()
    scene_seen, seen = seen, flagship_seen
    phase("scene", t0, f"covering scene (synthetic scene 0, frame 0, 524288 Gaussians, "
          f"256^2) through the accelerator render: alpha mean "
          f"{scene_out[2].mean().item():.4f}, min {scene_out[2].min().item():.4f}")
    with torch.inference_mode():  # the captured inputs are inference tensors
        k4 = topk_phase(dev, {"flagship": seen["k4"][0], "scene": scene_seen["k4"][0]},
                        seen["k4"][1])
        k2 = composite_phase(dev, {"flagship": seen["k2"][0], "scene": scene_seen["k2"][0]},
                             (256, 256), rcfg.tile_px,
                             min(rcfg.pallas_chunk, rcfg.max_per_tile))
        k3 = tail_phase(seen.pop("k3"), ptxas_report(build.build_logs.get("dpt_tail", "")))
    seen.clear()
    del scene_seen, scene_out

    # ---- the engine's programs exported, their child process beside the
    # demo CLI ----
    # the exporting processes run beside demo, K1's backward, its float32
    # route, the tiny float32 configuration through that route and the
    # flagship training step (their tracing is host work)
    pending = export_start(dev, model_acc, configs["accel"][1])
    try:
        demo = demo_phase(dev, smi, reset_counts, counts, zero)
        k1_bwd = flash_bwd_phase(dev)
        tiny, (tq, tk, tv) = tiny_phase(dev, reset_counts, counts)
        b, sq, h, d = tq.shape
        f32 = torch.float32
        k1_f32 = flash_f32_phase(dev, {
            "tiny decoder": (b, sq, tk.shape[1], h, d, f32),  # the tiny phase's shape
            "d12 ragged": (2, 200, 137, 12, 12, f32),
            "d16 ragged": (2, 77, 130, 4, 16, f32),
            "d64 decoder": (1, 2056, 2064, 12, 64, f32),
            # bf16 at a head dim other than 64, upcast to the float32 route
            "bf16 d96": (1, 2056, 2064, 12, 96, torch.bfloat16)})
        del tq, tk, tv
        train = train_phase(dev, dec_depth, reset_counts, counts)
        exported = export_finish(pending, smi)
    finally:
        export_stop(pending)

    # ---- both configurations in turns ----
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()  # the inference peak, not train's
    times = {w: {"forward": [], "render": []} for w in configs}
    for i in range(7):  # 2 warm-ups, then 5 timed
        for which in configs:
            e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
            e0.record()
            o = forward(which)
            e1.record()
            render(o, which)
            e2.record()
            torch.cuda.synchronize()
            if i >= 2:
                times[which]["forward"].append(e0.elapsed_time(e1))
                times[which]["render"].append(e1.elapsed_time(e2))
            del o
    med = {w: {k: statistics.median(v) for k, v in t.items()} for w, t in times.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for which in configs:
        phase("timing", t0, f"{which}: forward_ms median {med[which]['forward']:.2f} "
              f"{times[which]['forward']}; render_{N_VIEWS}view_ms median "
              f"{med[which]['render']:.2f} {times[which]['render']}")
    phase("timing", t0, f"peak allocated {peak_gb:.1f} GB")

    t0 = time.perf_counter()
    prof = {}
    for which in configs:
        o = forward(which)
        prof[which] = {"forward": profile_window(lambda: forward(which)),
                       "render": profile_window(lambda: render(o, which))}
        for stage, (wall, dev_ms, top, _) in prof[which].items():
            busy = ("not measured" if not dev_ms else
                    f"{dev_ms / wall:.3f} of the profiled window, "
                    f"{dev_ms / med[which][stage]:.3f} of the timed median")
            phase("profile", t0, f"{which} {stage}: host window {wall:.2f} ms, "
                  f"device kernels {dev_ms:.2f} ms, busy share {busy}; top "
                  "operators by device ms: "
                  + "; ".join(f"{n} {ms:.3f}" for n, ms in top))
        del o

    # ---- K3 in the forward: against its plain version, noise floor ----
    # K3 and cuDNN's unfused bf16 convs round differently; the accelerator
    # forward is held against the same forward with K3's float32 plain
    # version: at most twice as far as the default forward, plus a floor
    t0 = time.perf_counter()
    with mock.patch.object(heads, "fused_dpt_tail", dpt_tail_reference):
        ref_tail = forward("accel")

    def gs_dist(a):
        ga, gr = a["raw_gaussians"][..., 3:], ref_tail["raw_gaussians"][..., 3:]
        return {"gs_raw_rel": ((ga - gr).abs().max() / gr.abs().max()).item(),
                "opacities_abs": (a["gaussians"].opacities
                                  - ref_tail["gaussians"].opacities).abs().max().item()}

    d_k3, d_def = gs_dist(out_acc), gs_dist(out)
    floor3 = {"gs_raw_rel": 1e-3, "opacities_abs": 1e-3}
    tol3 = {m: 2 * d_def[m] + floor3[m] for m in floor3}
    phase("plain-k3", t0, ", ".join(
        f"{m} {d_k3[m]:.3e} (default path {d_def[m]:.3e}, tol {tol3[m]:.3e})"
        for m in floor3))
    bad = [m for m in floor3 if not d_k3[m] <= tol3[m]]
    if bad:
        raise AssertionError(f"K3 forward and its plain version disagree: {bad}")
    del ref_tail

    # ---- K2 + K4 against the CPU, and gradients through K2 ----
    t0 = time.perf_counter()
    acc_raster = configs["accel"][1].rasterize
    err, tol, cover = render_check(dev, acc_raster)
    if not err < tol:
        raise AssertionError(f"accelerator render on the card vs CPU: {err} >= {tol}")
    phase("render", t0, f"accelerator rasterizer (K2 + K4) vs CPU: max abs err "
          f"{err:.2e} (tol {tol:.2e}, alpha mean {cover:.3f})")
    t0 = time.perf_counter()
    fwd_err, g_err = grads_check(dev, acc_raster)
    phase("grads", t0, f"wiring of K2's autograd function, learnable background: "
          f"forward vs plain max abs err {fwd_err:.2e} (tol {tol:.2e}); gradients "
          "vs plain compositing, relative: "
          + ", ".join(f"{k} {v:.2e}" for k, v in g_err.items())
          + f" (tol {GRAD_TOL})")
    if not fwd_err < tol:
        raise AssertionError(f"K2's forward in the grads check disagrees: {fwd_err}")
    if not max(g_err.values()) < GRAD_TOL:
        raise AssertionError(f"gradients through K2 disagree: {g_err}")

    # ---- the default forward with K1 swapped for its plain version ----
    # Random bf16 weights make the network chaotic: a rounding difference in
    # one attention output grows through 11 more blocks, the DPT heads and
    # the exp map of the means. So the kernel's forward is held against the
    # float32 plain forward relative to the same distance for the JAX
    # package's own non-flash attention (layers.sdpa, bf16 logits): the
    # kernel may be at most twice as far, plus a small floor.
    t0 = time.perf_counter()

    def plain(q, k, v):
        return attention_reference(q, k, v).to(q.dtype)

    def swapped(attend):
        with mock.patch.object(vicanet, "flash_attention", attend):
            result = forward()
            torch.cuda.synchronize()
            ms = statistics.median(cuda_ms(forward, iters=1, warmup=0)
                                   for _ in range(3))
        return result, ms

    before = flash_attention.launches
    ref, plain_fwd_ms = swapped(plain)
    alt, _ = swapped(sdpa)
    if flash_attention.launches != before:
        raise AssertionError("a swapped forward launched K1")

    def dist(a):
        ga, gr = a["gaussians"], ref["gaussians"]
        return {
            "means_rel": ((ga.means - gr.means).abs().max()
                          / gr.means.abs().max()).item(),
            "opacities_abs": (ga.opacities - gr.opacities).abs().max().item(),
            "poses_abs": (a["gaussian_camera_extrins"]
                          - ref["gaussian_camera_extrins"]).abs().max().item(),
        }

    d_k1, d_sdpa = dist(out), dist(alt)
    floor = {"means_rel": 1e-3, "opacities_abs": 1e-3, "poses_abs": 1e-4}
    tol = {m: 2 * d_sdpa[m] + floor[m] for m in floor}
    phase("plain-k1", t0, f"forward_ms with plain attention {plain_fwd_ms:.2f}; "
          + ", ".join(f"{m} {d_k1[m]:.3e} (sdpa path {d_sdpa[m]:.3e}, tol "
                      f"{tol[m]:.3e})" for m in floor))
    bad = [m for m in floor if not d_k1[m] <= tol[m]]
    if bad:
        raise AssertionError(f"kernel and plain forward disagree: {bad}")
    plain_tol = dict(tol)

    # ---- the serving engine on the same models ----
    del ref, alt
    serve = serve_phase(dev, smi, configs, dict(tol), reset_counts, counts)


    # ---- the trained checkpoint's test mode, and the flagship's eval ----
    evals = eval_phases(dev, smi, reset_counts, counts, zero, model_acc,
                        dataclasses.replace(cfg, head_tail_backend="pallas"))
    del model, model_acc, configs, out, out_acc, rendered, rendered_acc
    torch.cuda.empty_cache()
    serve_trained = serve_trained_phase(dev, smi, reset_counts, counts)
    train_mode = train_mode_phase(dev, smi, reset_counts, counts, zero)
    re10k = re10k_phase(dev, smi, reset_counts, counts, zero)
    experiments = experiments_phase(dev, smi, reset_counts, counts, zero)
    distill = distill_phase(dev, smi, reset_counts, counts, zero)
    parallel = parallel_phase(dev, smi, plain_tol, reset_counts, counts, zero, train)

    def entry(name, replaces, r, launches=None, source=None):
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "shape")
        return dict({"name": name, "route": "cuda",
                     "source": f"vicasplat_tpu_torch/csrc/{source or name}.cu",
                     "replaces": replaces,
                     "launches": launches_acc[name] if launches is None else launches},
                    **{k: r[k] for k in keys}, **{k: r[k] for k in r if k not in keys})

    print(json.dumps({"kernels": [
        entry("flash_attn", "vicasplat_tpu/models/vicanet.py:242", k1["decoder"]),
        # launches per train step: each call runs its D pass, dK/dV and dQ
        # kernels once
        entry("flash_attn_bwd", "vicasplat_tpu/models/vicanet.py:242 (backward: "
              "_flash_attention_bwd_dkv, _flash_attention_bwd_dq)",
              k1_bwd["decoder"], train["steps"][-1]["launches"]["flash_attn_bwd"]),
        # the float32 route, at the tiny configuration's decoder shape;
        # launches in its forward and per training step
        entry("flash_attn_f32", "vicasplat_tpu/models/vicanet.py:242 (float32)",
              k1_f32["tiny decoder"]["forward"],
              tiny["forward_launches"]["flash_attn_f32"]),
        entry("flash_attn_f32_bwd", "vicasplat_tpu/models/vicanet.py:242 (float32 "
              "backward: _flash_attention_bwd_dkv, _flash_attention_bwd_dq)",
              k1_f32["tiny decoder"]["backward"],
              tiny["step_launches"]["flash_attn_f32_bwd"], source="flash_attn_f32"),
        entry("composite", "vicasplat_tpu/ops/rasterize/pallas_composite.py:59",
              k2["flagship"]),
        entry("dpt_tail", "vicasplat_tpu/ops/dpt_tail.py:43", k3["with m"]),
        entry("bitonic_topk", "vicasplat_tpu/ops/rasterize/pallas_bitonic.py:31",
              k4["flagship"]),
    ], "extra": {"composite_dense": k2["dense"], "composite_scene": k2["scene"],
                 "bitonic_topk_scene": k4["scene"], "dpt_tail_without_m": k3["without m"],
                 "flash_attn_encoder": k1["encoder"], "flash_attn_ragged": k1["ragged"],
                 "flash_attn_f32_shapes": k1_f32, "tiny_f32": tiny,
                 "flash_attn_bwd_encoder": k1_bwd["encoder"],
                 "flash_attn_bwd_ragged": k1_bwd["ragged"],
                 # the synthetic_pose step's shape (random inputs), and
                 # the launches per step of the train mode
                 "flash_attn_bwd_synthetic_pose": dict(
                     k1_bwd["synthetic_pose"],
                     launches_per_train_mode_step=train_mode["launches"]["flash_attn_bwd"]
                     // TRAIN_MODE_STEPS),
                 "flash_attn_train_launches_per_step":
                     train["steps"][-1]["launches"]["flash_attn"],
                 # K1 on a trained encode, K2 and K4 on a trained view, and
                 # the launches in the trained checkpoint's test mode and
                 # the flagship's eval
                 "flash_attn_trained": evals["eval_accel"]["trained_view"]["flash_attn"],
                 "composite_trained": evals["eval_accel"]["trained_view"]["composite"],
                 "bitonic_topk_trained": evals["eval_accel"]["trained_view"]["bitonic_topk"],
                 "eval_launches": {k: evals[k]["launches"] for k in
                                   ("eval", "eval_accel", "eval_flagship")},
                 # the demo's forward and streaming engine, and one call of
                 # each exported program (torch.profiler's records)
                 "demo_launches": {k: demo[k]["launches"] for k in ("short", "long")},
                 # the re10k_8view train step from chunks, and its test mode
                 "re10k_launches": {"train_step": re10k["train"]["steps"][-1]["launches"],
                                    "test": re10k["test"]["launches"]},
                 # the three experiment configs' train steps and test modes, and
                 # ScanNet's 2-view eval_pose
                 "experiments_launches": dict(
                     {name: {"train_step": experiments[name]["steps"][-1]["launches"],
                             "test": experiments[name]["test"]["launches"]}
                      for name in EXPERIMENTS},
                     scannet_pose=experiments["scannet_pose"]["launches"]),
                 # the distill experiment's two steps, distill_only and distill
                 "distill_launches": [st["launches"] for st in distill["train"]["steps"]],
                 # K1 at the distill step's shape, on its own inputs
                 "flash_attn_distill": distill["k1"],
                 "flash_attn_bwd_distill": distill["k1_bwd"],
                 "export_launches": {k: exported["child"][k]["profiled"]
                                     for k in ("reconstruct", "render", "tiny")}},
        "train": {k: train[k] for k in ("batch", "targets", "cuts", "train_step_ms",
                                        "step_ms", "peak_gb", "device_ms",
                                        "k1_device_ms", "k1_share", "top",
                                        "k1_bwd_on_step_inputs", "plain_k1")},
        "flagship": {
            which: {"forward_ms": med[which]["forward"],
                    "render_ms": med[which]["render"],
                    "forward_device_kernel_ms": prof[which]["forward"][1],
                    "render_device_kernel_ms": prof[which]["render"][1]}
            for which in med},
        "forward_plain_attention_ms": plain_fwd_ms,
        "eval": evals,
        "serve": serve,
        "demo": demo,
        "export": exported,
        "serve_trained": serve_trained,
        "train_mode": train_mode,
        "re10k": re10k,
        "experiments": experiments,
        "distill": distill,
        "parallel": parallel,
        "wall_s": time.perf_counter() - t_start}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--ddp-child":
        ddp_child(int(sys.argv[2]), sys.argv[3])  # a rank of parallel's world 2
    elif len(sys.argv) == 4 and sys.argv[1] == "--route-child":
        route_child(int(sys.argv[2]), sys.argv[3])  # SP, TP, EP at world 2
    elif len(sys.argv) == 3 and sys.argv[1] == "--sdpa-kernels":  # k1-f32's
        print(json.dumps(sdpa_kernels_child(json.loads(sys.argv[2]))), flush=True)
    else:
        main()
