#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pytorch3dunet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of the repository

Phases, each fatal on failure:
  1. device: a CUDA device is present; its name and power limit;
  2. build: the hand-written kernels are compiled from csrc/ with nvcc, one
     nvcc per source, all at once;
  3. kernels vs plain: `conv3d_fwd` (K2, the default forward: a tensor-core
     kernel with the output pixels on wgmma's M and the features on N) against
     `conv3d_fwd_reference` at every 3x3x3 conv shape of the UNet3D forward and
     train step below, and the packed-weight kernel (K3) at every
     input-gradient shape of the training step, in float32 and bfloat16, and
     both at edge shapes;
  4. predict path: sliding-window prediction with the UNet3D of
     resources/3DUnet_confocal_boundary/test_config.yml at full width (seeded
     random weights, synthetic volume, 4 patches of 112x234x234 with halo);
     checks the launch count, the output, and one patch against the same
     forward with the plain conv;
  5. predict times, with CUDA events: each conv shape (K2 beside its 3xTF32
     bound, its useful TFLOP/s and the MMAs it issues over the useful ones,
     plain and cuDNN with TF32 off and on, K2 and cuDNN in bf16), one patch forward and
     its device time by kernel (torch.profiler), the whole prediction;
  6. conv backward: `Conv3dFunction`'s dx, dw, db against autograd through
     `F.conv3d` at one conv shape of each of levels 0-2 of the training patch;
  7. train path: `UNetTrainer` built from the model, loss, optimizer,
     lr_scheduler and eval_metric of
     resources/3DUnet_confocal_boundary/train_config.yml at full width (seeded
     random weights), 6 Adam steps on one synthetic 80x170x170 batch and 2
     validations; checks the launch counts of both kernels, the falling loss,
     the checkpoint, and one step's gradients against a float64 step with the
     plain conv (and, capped, against the plain f32 step);
  8. train times: K3 per input-gradient shape against one `F.conv3d` on dy
     and the flipped weights (the same function as K3) and cuDNN's
     `conv3d_input` (TF32 off and on), K3 and that `F.conv3d` in bf16 beside
     K3's bf16 bound, cuDNN's weight gradient per conv shape
     (TF32 off and on), one train step with the kernels against the plain conv
     (TF32 off and on), voxels/s and peak memory;
  9. profile: one train step's device time by kernel (torch.profiler).
Phases 1-9 run with P3DUNET_TAPFOLD unset: every conv forward is K2. Phases
11-14 set P3DUNET_TAPFOLD=1, under which every conv with F >= 64 runs its
forward on the im2col kernel (K1), and unset it after:
 10. kernels vs plain at the ResidualUNet3D's shapes: `conv3d_fwd(variant="im2col")`
     (K1) against `conv3d_fwd_reference` at every K1 shape of the prediction
     and training patches and at the edge shapes, K2 at the model's other conv
     shapes of both patches, and `conv3d_input_grad` (K3) against its plain
     version at all 18 input-gradient shapes of its train step, in float32 and
     bfloat16;
 11. ResidualUNet3D predict path: the model of
     resources/3DUnet_lightsheet_boundary/test_config.yml at full width (seeded
     random weights) on the same synthetic volume and patches as phase 4;
     checks 14 K1 + 4 K2 launches per forward, the output, and one patch
     against the plain conv;
 12. ResidualUNetSE3D: one full-width f32 forward of one patch under
     P3DUNET_TAPFOLD=1, checked as phase 11's (K1, K2 and GroupNorm launches,
     the plain-conv forward); then the benchmark's lightsheet_resunetse3d
     configuration (the light-sheet recipe with the model's name swapped) in
     bfloat16 through `DeviceSlidingWindowPredictor` at full width,
     P3DUNET_TAPFOLD unset: one seeded 200x425x425 volume, 27 patches of
     112x234x234, against the benchmark's plain float32 reference one patch
     at a time, within the cell's `max_abs_gap` limit; checks the K2 and
     GroupNorm launches and the scSE gates' calls against their plans
     (`se_plan`);
 13. ResidualUNet3D train path: the loss, optimizer, eval_metric and
     lr_scheduler of resources/3DUnet_lightsheet_boundary/train_config.yml, 4
     Adam steps on the synthetic 80x170x170 batch and 1 validation; checks 18
     K3 launches per step and 14 K1 + 4 K2 per forward, the falling loss, and
     one step's gradients against a float64 step with the plain conv, beside
     the plain conv's own float32 step, and against that f32 step (the fit
     and the check on cuDNN's deterministic algorithms);
 14. times: K1 per shape against K2 at the same shape and cuDNN (TF32 off and
     on; K1 and cuDNN in bf16), the patch forward, predict_array, a train step with peak memory, and
     one forward's device time by kernel (torch.profiler).
Phases 15-17 drive the device sweep (`DeviceSlidingWindowPredictor.predict_array`:
one upload, the patch loop, normalization and stitching on the card, one
download) on phase 4's volume:
 15. UNet3D, f32: (a) the geometry of
     resources/3DUnet_confocal_boundary_tpu/test_config.yml (gaussian blend,
     stride 40x85x85: 9 patches, 144 K2 launches) against the same sweep with
     the plain conv; (b) assign on phase 4's grid against phase 4's host
     predict_array; (c) (a) streamed in z-slabs against (a); (d) `patch_mode:
     slab` (2 slabs of 145 planes); (e) one forward of a slab whose decoder
     concat passes 2^31 elements, against the plain conv in depth chunks; wall
     times and Mvoxel/s beside phase 5's host predict_array, peak memory, and
     the device time by kernel of a sweep of (a) (torch.profiler);
 16. the sweep of 15(a) with `model.dtype: bfloat16` (144 bf16 K2 launches)
     against the same bf16 sweep with the plain conv and against 15(a);
 17. ResidualUNet3D in bfloat16 under P3DUNET_TAPFOLD=1, the geometry of
     resources/3DUnet_lightsheet_boundary_tpu/test_config.yml (assign, phase 4's
     grid; 14 K1 + 4 K2 bf16 launches per forward), against the same bf16 sweep
     with the plain conv and against its f32 sweep, which is held to phase 11's
     host output.
Phases 18-20 drive the device augmentation and bf16 training of the `_tpu`
train configs (the spec that `split_device_transforms` gives for their train
transformer: flip, rot90, rotate, elastic paired; blur and two noises on the
raw; StandardLabelToBoundary on the device):
 18. the `DeviceAugmenter` on phase 7's 80x170x170 batch (standardized raw and
     its instance label), every transform at probability 1, on the card
     against the CPU with the same draws (raw relative error, count of label
     voxels that differ); each transform's time, the whole augmenter at the
     config's probabilities (median of 5) and its peak memory;
 19. UNet3D in bf16, the confocal `_tpu` train config at full width: (a) one
     bf16 step's grads (16 bf16 K2, 16 bf16 K3) against the same step with
     the plain conv, and their distance from a float64 step; (b) 6 Adam steps
     on the batch: the loss falls, parameters and moments stay float32; (c)
     `create_trainer(config, loaders=...)` with the device augmentation, 6
     steps and 1 validation: 16 bf16 K2 a forward, 16 bf16 K3 a step, no f32
     K2 or K3, finite losses, a checkpoint that loads into an f32 model; the
     bf16 step against phase 8's f32 step, the augmented step and the
     augmenter's share, the profile and cuDNN's bf16 weight gradient;
 20. ResidualUNet3D in bf16 under P3DUNET_TAPFOLD=1, the lightsheet-boundary
     `_tpu` train config: 2 augmented steps (14 bf16 K1 and 4 bf16 K2 a
     forward, 18 bf16 K3 a step), one step's grads as in 19(a), the step time.
Phases 21-23 drive the multiclass and denoising recipes (configs mirrored as
dicts: MULTICLASS_TPU, DENOISING_TPU):
 21. resources/3DUnet_multiclass_tpu/train_config.yaml at full width (UNet3D
     f_maps 32 over 4 levels, 3 classes, bf16) on a standardized raw and an
     int64 class map of 3 classes from phase 7's Voronoi cells, through the
     config's device augmentation (flips, rot90, rotate, elastic order 3/0):
     (a) one bf16 step's grads against the plain conv's (16 bf16 K2, 16 bf16
     K3), CrossEntropyLoss against float64 on the same logits; (b)
     `create_trainer` with 4 augmented steps and 1 validation: launches, the
     MeanIoU device twin against the host MeanIoU on the validation's
     probabilities, a checkpoint that loads into an f32 model; the step, the
     augmented step and one validation batch with the twin and with the host
     metric;
 22. resources/3DUnet_denoising_tpu/train_config_regression.yaml (UNet3D
     f_maps 16 over 5 levels, bf16, 128^3): K2 against its plain version at
     its 22 forward shapes and K3 at its 22 input-gradient shapes in f32 and
     bf16 (F = 8, dy with 8 channels and 256 channels at 8^3 are new), then
     one bf16 step's grads against the plain conv's and 4 augmented steps
     (flips and rot90; its RandomRotate stays on the host) and 1 validation
     with the PSNR twin through `create_trainer` (22 bf16 K2 a forward, 22
     bf16 K3 a step); the step time, peak memory and profile;
 23. resources/3DUnet_multiclass/test_config.yaml in f32 with phase 21's
     weights: the device sweep on phase 4's volume and grid (each patch
     standardized), its segmentation against the argmax of its
     probabilities, `predictor.evaluate` (mean IoU) against a numpy mean IoU
     computed here on a class map of the volume, 64 f32 K2, the evaluation's
     time beside the sweep's.
Phases 24-27 drive the 2D families and the remaining model options (configs
mirrored as dicts: MODEL_2D, DSB_MODEL, DSB_SECTIONS, OPTIONS_3D); no 2D path
runs a hand kernel (the JAX package computes every 2D conv outside Pallas), so
phases 24-26 assert 0 launches of K1, K2 and K3:
 24. resources/2DUnet_confocal_boundary/train_config.yml at its width and batch
     (UNet2D f_maps 32 over 4 levels, gcr, 32 patches of 1x515x512 cut from
     Voronoi cells): `create_trainer` with 4 steps and 1 validation (ARand on
     the host on (N, C, 1, H, W)); one step's grads on 4 of the patches against
     a float64 step (cuDNN deterministic, GroupNorm affines random), each
     tensor within 1e-3 of the step's max|g| and 1e-2 of its own; the step at
     batch 32, its peak memory and profile;
 25. its test_config.yml on a 64x1024x1024 stack, patch 1x512x512, halo
     0x32x32: the device sweep (16 tiles a forward) against the host loop on
     the first 16 planes; `patch_mode: slab` (24 whole planes a forward),
     plane 0 against its own forward and the grid's cores; one ResidualUNet2D
     forward (5 levels, deconv, sum joins) of 16 tiles; Mvoxel/s, peak memory
     and the device time by kernel;
 26. resources/2DUnet_dsb2018 (UNet2D bcr, f_maps [32, 64, 128]): 4 steps and 1
     validation (BlobsAveragePrecision) at batch 32 of 256x256, every
     BatchNorm's running statistics moved; `DSB2018Predictor.predict_image` on
     8 images of the DSB2018 sizes with pad_to_multiple 64 against the unpadded
     forward beyond 64 pixels of the pad, the segmentation against scipy's
     8-connected components of probs > 0.5;
 27. the 3D options on the confocal UNet3D on phase 7's batch: upsample
     trilinear, deconv (DoubleConv, concat) and conv_upscale 1, each forward on
     the kernels (14 K2; 16 for conv_upscale 1, whose decoders 0 and 2 fuse)
     against the plain conv; conv_kernel_size [1, 3, 3] with conv_padding
     [0, 1, 1] 0 K2 (cuDNN); one f32 trilinear step, 14 K2 + 14 K3, held as
     phase 13's to a float64 step (the plain f32 step itself is 4.6e-3 of
     max|g| off it at a level-2 conv);
 28. the trainer's breadth on the confocal UNet3D and phase 7's batches:
     (a) `model.remat`: one f32 step's grads against the step without it (32
     K2: each forward and its recompute, 16 K3), step time and peak memory with
     and without, f32 and bf16; (b) `grad_accum_steps: 2` over two batch-1
     batches against one batch-2 step (32 K2 and 32 K3 an update): the mean
     grads and the updated parameters; (c) the confocal `_tpu` train config with
     its commented lines on (`ema_decay: 0.999`, `grad_accum_steps: 2`,
     `resume: auto`), bf16 with its device augmentation: 4 updates and a
     validation, then a new trainer resumes for 2, against 6 uninterrupted
     updates; the checkpoint's EMA and RNG states; the EMA against a float64
     recurrence; one update's time and the EMA's share; (d) how long the save
     blocks the loop with `async_checkpoint` on and off, and the written file
     against the state at the save;
 29. conversion, export and serving of the confocal UNet3D at full width
     (seeded random weights): (a) `torch.library.opcheck` of the conv's custom
     op `pytorch3dunet_tpu_torch::conv3d_fwd` on CUDA for each variant and
     dtype, one eager forward through it (17 K2) against the plain conv; (b)
     the serving forward with `standardize` inside exported on the card
     (`export.py`, f32 and bf16, patch 112x240x240, symbolic batch), called at
     batch 1 and 2: 17 K2 a forward inside the artifact, within 1e-6 of the
     eager model; the export's seconds, the artifact's MB, its forward
     against the eager forward; (c) the weights written as a JAX npz, read
     back, converted to torch and back (`convert.py`), bitwise; (d)
     `ServingSession` and `make_server` on 127.0.0.1 from that npz with the
     confocal test config (patch 80x170x170, halo 16x32x32, Standardize with
     global_normalization) on phase 4's volume: POST /predict bitwise
     `predict_array`, ?output=segmentation its `_to_segmentation`; request
     latency against predict_array, 4 concurrent clients, the warm-up with a
     cold and a warm kernel build cache; (e) the UNet2D of the 2D confocal
     test config under --batch-planes 24: 6 concurrent requests of 4 planes
     of 1024x1024 and 16 of one 512x512 plane, at least one batched dispatch
     in each, each within 3e-5 of its direct prediction; each mix's wall time
     with the micro-batcher on and off.
Phase 30 drives the port's parallelism (parallel/, the trainer's and the
sweeps' sharded paths) on the one card:
 30. Every step is an update of `create_trainer`'s trainer on in-memory
     batches (its batch preparation, mesh choice and step builders). (a) world
     size 1 over NCCL through `initialize_from_env` and a local coordinator:
     the D-sharded confocal step (`trainer.spatial_sharding`; every 3x3x3 conv
     on a halo'd slab of D + 2 planes, zero halos), f32 and bf16, 14 K2 + 14 K3
     a step, against a float64 plain step (phase 13's gate) and the bf16
     plain-conv step (phase 19's); (b) two ranks as two processes sharing the
     card over gloo, which takes CUDA tensors for all_reduce and broadcast
     (NCCL refuses two ranks on one device): the D-sharded f32 step at local
     D 40 (14 K2 + 14 K3 a rank) and one data-parallel step of 2 x 1 patches
     against the batch-2 step (16 K2 + 16 K3 a rank), each held by (a)'s gate,
     the ranks' updated parameters identical; (c) phase 4's grid sweep split
     over the 2 ranks (2 patches, 32 K2 a rank) against one rank's, within
     1e-5, and two slabs
     of 80 planes z-sharded over them against one rank's slab, within 1e-4 and
     either within 2e-5 or no further from a float64 forward than twice one
     rank's distance plus 2e-5; (d) the sharded step's time at world size 1
     against the unsharded one (the halo path and its 2 extra planes), each
     rank's step, its all-reduces, the sweeps. Two ranks sharing one card say
     nothing of scaling.
Phase 31 drives the JAX package's default decoder paths at full width against
the generic ones, each switch set for the call and restored after:
 31. (a) the confocal UNet3D forward at 112x234x234 with the fused decoder
     (P3DUNET_FUSED_DECODER=1: decoders 0 and 2 fuse, decoder 1 stays generic,
     117 != 2 x 58) against P3DUNET_FUSED_DECODER=0, f32 and bf16: both
     within 1e-3 (bf16: phase 16's ceilings) of the generic forward on the
     plain conv, 16 against 14 K2, times in turns, a profile of each; (b) the
     f32 step at 80x170x170 on each path, timed in turns; then from the
     weights those steps left, GroupNorm affines drawn anew, one step's grads
     on the fused path (16 K2 + 16 K3) held by phase 13's gate to a float64
     plain step, beside the generic path's; (c) the same for the light-sheet
     ResidualUNet3D under P3DUNET_TAPFOLD=1 with the phase deconv
     (P3DUNET_DECONV=phase: each deconv one K2 conv, F = 8 Co, pinned to K2;
     14 K1 + 8 K2 a forward, 22 K3 a step) against cuDNN's transposed conv
     (P3DUNET_DECONV=xla); (d) K2 and K3 against their plain versions, f32 and
     bf16, at the 16 conv shapes those paths add (C = F = 128 and 32 skip
     branches, wide up-branches with F = 1024 and 256, deconvs with F = 2048
     and 512; their input gradients with 1024 and 2048 channels in), each
     timed beside its 3xTF32 bound and one cuDNN call of the same function
     (F.conv3d of the embedded kernel; F.conv_transpose3d for a deconv, which
     K2 + its depth-to-space is also held to); (e) the DSB2018 UNet2D (bcr,
     fused at every level) train-mode forward at batch 32 of 256x256, fused
     against generic within 1e-4, running statistics included, no hand
     kernel; then the rule of each default: the new path is the port's
     default if no reading of it is slower than the generic one's by more
     than 2%.
 32. the GroupNorm kernel (csrc/group_norm.cu through ops/group_norm.py
     `group_norm_op`, which every GroupNorm forward without a gradient takes
     on the card) at every GroupNorm input of one 112x234x234 forward of the
     confocal UNet3D (f32) and the light-sheet ResidualUNet3D (bf16), the
     inputs as the forward hands them on (channels-last after K2, NC after
     cuDNN or a concat): against its plain version and float64, with torch's
     own F.group_norm gap to float64 as the tolerance (printed); a repeat
     bitwise equal; y's strides x's; its time beside its bound (two reads
     and one write of x at 3.35 TB/s), the plain version and one
     F.group_norm call; its launch pairs a forward.
Every launch gate of phases 4-31 is derived, not written down: `plan_launches`
counts the kernel convs of `kernel_conv_plan` (models/unet.py) for the model,
its input shape and the switches as they are set (the fused decoders' two
convs, a phase deconv's one, P3DUNET_TAPFOLD's K1, the generic decoders under
a space mesh); the counts above are the defaults' (fused decoder on, the
phase deconv off).
TF32 is off for every comparison and every "plain" time unless a line says
"TF32". The line before the last is a JSON object describing the kernels (time,
launches, error, and the bound `bound_ms`: the larger of bytes at the H100's
3.35 TB/s and FLOPs at the peak rate of the arithmetic the kernel issues,
3xTF32 MMAs at 495 TFLOP/s (three products a MAC) for the three tensor-core
kernels K1, K2 and K3, which also carry the f32 FFMA figure at 67 TFLOP/s as
`bound_ffma_ms` and their ptxas registers, spills and shared memory; for all
three also the bf16 time beside the bf16 bound at 989 TFLOP/s and one cuDNN
call in bf16, for K2 the MMAs issued over the useful ones; for the GroupNorm
kernel its memory bound, plain and F.group_norm times per model); the last line is
{"ok": true, "device": {...}}.

Needs torch, numpy and scipy; not jax, h5py or yaml, and nothing of the JAX package.
"""

import collections
import copy
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
# the model section of resources/3DUnet_confocal_boundary/test_config.yml and train_config.yml
MODEL = {"name": "UNet3D", "in_channels": 1, "out_channels": 1, "layer_order": "gcr", "f_maps": 32,
         "num_groups": 8, "final_sigmoid": True}
PATCH, STRIDE, HALO = (80, 170, 170), (80, 170, 170), (16, 32, 32)
TRANSFORMER = {"raw": [{"name": "Standardize"}, {"name": "ToTensor", "expand_dims": True}]}
VOLUME = (160, 170, 340)  # 2 x 1 x 2 patches
# the loss, optimizer, eval_metric and lr_scheduler sections of
# resources/3DUnet_confocal_boundary/train_config.yml
TRAIN_SECTIONS = {
    "loss": {"name": "BCEDiceLoss", "ignore_index": None, "skip_last_target": True},
    "optimizer": {"learning_rate": 0.0002, "weight_decay": 1.0e-05},
    "eval_metric": {"name": "BoundaryAdaptedRandError", "threshold": 0.4, "use_last_target": True,
                    "use_first_input": True},
    "lr_scheduler": {"name": "ReduceLROnPlateau", "mode": "min", "factor": 0.5, "patience": 30},
}
TRAIN_PATCH = (80, 170, 170)
# the trainer stops after iteration max_num_iterations + 1 (iterations count from 1)
TRAIN_STEPS, VALIDATE_AFTER = 6, 3
# max |kernel - plain| <= tol * max |plain|: f32 sums of up to 27 * 384 products
# in another order; bf16 one rounding of the output
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
FORWARD_TOL = 1e-3  # probabilities of one patch, kernel forward vs plain forward
BACKWARD_TOL = 1e-4  # dx, dw, db of one conv, relative to max |autograd's|
# UNet3D step grads, each against a float64 plain step on the card, per tensor
# relative to its max |g|. Not against the plain f32 step: that step is itself
# 1.4e-3 from float64 at a level-2 conv weight, where the kernels' step is
# within 5.7e-4 of it (phase 7 on an H100; K2's forward sums each 72-product
# chunk apart, closer to float64 than cuDNN's f32 forward)
GRAD_TOL = 1e-3
# ResidualUNet3D step grads, each against a float64 plain step on the card, per
# tensor relative to its max |g|: the kernels' error may exceed twice the plain
# f32 step's own error by RES_GRAD_TOL. The per-tensor bound above does not
# hold there: its deep-level tensors (max |g| down to 1e-6 of the step's) carry
# f32 errors of 2e-3 to 3e-3 in both paths, and the plain step differs from
# itself by 1e-3 between two runs (cuDNN's weight gradient)
RES_GRAD_TOL = 1e-3
# both models: the kernels' step against the plain f32 step per tensor, a cap,
# so that neither a noisy plain step nor a float64 reference hides a fault
VS_PLAIN_CAP = 1e-2
# (N, D, H, W, C, F, bias): C = 1, F = 3, D = 1 and 2, odd H and W, N = 2, F
# above one feature block, C above one channel chunk, no bias
EDGE_CASES = [(1, 5, 7, 9, 1, 16, True), (1, 2, 11, 13, 3, 3, True), (2, 4, 9, 31, 32, 64, True),
              (1, 3, 5, 37, 20, 40, False), (1, 1, 1, 1, 8, 8, True), (2, 3, 17, 33, 130, 70, False)]
RUNS = 5
# the model section of resources/3DUnet_lightsheet_boundary/test_config.yml and
# train_config.yml (its patch, halo, loss, optimizer and eval_metric are the
# confocal recipe's), and its lr_scheduler
RES_MODEL = {"name": "ResidualUNet3D", "in_channels": 1, "out_channels": 1, "layer_order": "gcr", "f_maps": 32,
             "num_groups": 8, "final_sigmoid": True}
RES_LR_SCHEDULER = {"name": "ReduceLROnPlateau", "mode": "min", "factor": 0.2, "patience": 20}
RES_TRAIN_STEPS, RES_VALIDATE_AFTER = 4, 4
# resources/3DUnet_confocal_boundary_tpu/test_config.yml: an overlapping grid, gaussian blend
TPU_STRIDE, TPU_BLEND = (40, 85, 85), "gaussian"
SWEEP_RUNS = 3
# the device sweep against the host loop on the same grid (both f32, the same
# kernels; they differ in the order of the normalization's arithmetic), and
# streamed against one-shot (the same cores, summed in another order)
SWEEP_VS_HOST_TOL, STREAMED_TOL = 1e-4, 1e-5
# a padded slab of 24.9 M voxels, past max_patch_voxels' default 2**24: the
# 96 channels of its level-0 decoder concat hold 2.39e9 elements, past 2**31
LARGE_SLAB = (176, 376, 376)
# its GroupNorm's f32 statistics over 3e8 elements a group against float64,
# relative to the output's max: an index past 2^31 that wrapped would be off by O(1)
LARGE_GN_TOL = 1e-3
# bf16 probabilities against the same bf16 sweep with the plain conv, and
# against the f32 sweep: ceilings, the measured values are printed
BF16_VS_PLAIN_TOL, BF16_VS_F32_TOL = 2e-2, 5e-2
# the loaders section of resources/3DUnet_confocal_boundary_tpu/train_config.yml
# that split_device_transforms reads (its lightsheet_boundary sibling has the
# same train transformer): device_augment and the train transformer
TPU_LOADERS = {"device_augment": True, "train": {"transformer": {
    "raw": [{"name": "Standardize"}, {"name": "RandomFlip"}, {"name": "RandomRotate90"},
            {"name": "RandomRotate", "axes": [[2, 1]], "angle_spectrum": 45, "mode": "reflect"},
            {"name": "ElasticDeformation", "spline_order": 3},
            {"name": "GaussianBlur3D", "execution_probability": 0.5},
            {"name": "AdditiveGaussianNoise", "execution_probability": 0.2},
            {"name": "AdditivePoissonNoise", "execution_probability": 0.2},
            {"name": "ToTensor", "expand_dims": True}],
    "label": [{"name": "RandomFlip"}, {"name": "RandomRotate90"},
              {"name": "RandomRotate", "axes": [[2, 1]], "angle_spectrum": 45, "mode": "reflect"},
              {"name": "ElasticDeformation", "spline_order": 0},
              {"name": "StandardLabelToBoundary", "append_label": True},
              {"name": "ToTensor", "expand_dims": False}]}}}
# the device augmenter on the card against the same draws on the CPU: raw
# relative to max |raw| (a ceiling: f32 sums in another order, the measured
# value is printed), labels as the share of voxels that differ (order-0
# resampling at coordinates that differ by f32 roundoff)
AUG_RAW_TOL, AUG_LABEL_SHARE = 1e-4, 1e-5
# a bf16 step's parameter grads with the kernels against the same bf16 step
# with the plain conv, max |d| over all tensors relative to the step's max |g|:
# a ceiling (both are bf16-noisy; at the CPU tests' width the bf16 step sits
# 0.065 from the f32 step by this measure)
BF16_STEP_VS_PLAIN_TOL = 0.1
# resources/3DUnet_multiclass_tpu/train_config.yaml: the model (f_maps
# [32, 64, 128, 256] is f_maps 32 over 4 levels), loss, optimizer, metric,
# scheduler and the loaders section that split_device_transforms reads
MULTICLASS_MODEL = {"name": "UNet3D", "in_channels": 1, "out_channels": 3, "layer_order": "gcr",
                    "f_maps": [32, 64, 128, 256], "num_groups": 8, "final_sigmoid": False, "is_segmentation": True}
MULTICLASS_ROTATE = {"name": "RandomRotate", "axes": [[2, 1]], "angle_spectrum": 30, "mode": "reflect"}
MULTICLASS_TPU = {
    "model": {**MULTICLASS_MODEL, "dtype": "bfloat16"}, "loss": {"name": "CrossEntropyLoss"},
    "optimizer": {"learning_rate": 0.0002, "weight_decay": 1.0e-05}, "eval_metric": {"name": "MeanIoU"},
    "lr_scheduler": {"name": "ReduceLROnPlateau", "mode": "max", "factor": 0.2, "patience": 8},
    "trainer": {"eval_score_higher_is_better": True},
    "loaders": {"device_augment": True, "train": {"transformer": {
        "raw": [{"name": "Standardize"}, {"name": "RandomFlip"}, {"name": "RandomRotate90"}, MULTICLASS_ROTATE,
                {"name": "ElasticDeformation", "spline_order": 3}, {"name": "ToTensor", "expand_dims": True}],
        "label": [{"name": "RandomFlip"}, {"name": "RandomRotate90"}, MULTICLASS_ROTATE,
                  {"name": "ElasticDeformation", "spline_order": 0},
                  {"name": "ToTensor", "expand_dims": False, "dtype": "int64"}]}}}}
# resources/3DUnet_denoising_tpu/train_config_regression.yaml, the same sections
# (f_maps [16, 32, 64, 128, 256]: f_maps 16 over 5 levels, no final activation)
DENOISING_MODEL = {"name": "UNet3D", "in_channels": 1, "out_channels": 1, "layer_order": "gcr",
                   "f_maps": [16, 32, 64, 128, 256], "num_groups": 8, "is_segmentation": False}
DENOISING_TPU = {
    "model": {**DENOISING_MODEL, "dtype": "bfloat16"}, "loss": {"name": "SmoothL1Loss", "ignore_index": None},
    "optimizer": {"learning_rate": 0.0002, "weight_decay": 1.0e-05},
    "eval_metric": {"name": "PSNR", "ignore_index": None},
    "lr_scheduler": {"name": "ReduceLROnPlateau", "mode": "max", "factor": 0.1, "patience": 10},
    "trainer": {"eval_score_higher_is_better": True},
    "loaders": {"device_augment": True, "train": {"transformer": {
        "raw": [{"name": "Normalize"}, {"name": "RandomFlip"}, {"name": "RandomRotate90"}, MULTICLASS_ROTATE,
                {"name": "ToTensor", "expand_dims": True}],
        "label": [{"name": "Normalize"}, {"name": "RandomFlip"}, {"name": "RandomRotate90"}, MULTICLASS_ROTATE,
                  {"name": "ToTensor", "expand_dims": True}]}}}}
DENOISING_PATCH = (128, 128, 128)
# phases 21-22 take fewer steps than phase 19 to keep the run short; their widths stay full
RECIPE_STEPS = 4
# a CE value in f32 against float64 on the same logits, relative
CE_TOL = 1e-5
# the MeanIoU twin against the host MeanIoU on the same probabilities and target
TWIN_TOL = 1e-6
# resources/2DUnet_confocal_boundary: the model of train_config.yml and
# test_config.yml (its loss, optimizer, eval_metric and lr_scheduler are
# TRAIN_SECTIONS), the train batch of 32 patches of 1 x 515 x 512, and the test
# patch and halo on a synthetic 64-plane stack of 1024 x 1024 planes
MODEL_2D = {"name": "UNet2D", "in_channels": 1, "out_channels": 1, "layer_order": "gcr", "f_maps": 32,
            "num_groups": 8, "final_sigmoid": True}
BATCH_2D, PATCH_2D = 32, (1, 515, 512)
VOLUME_2D, PATCH_2D_TEST, HALO_2D = (64, 1024, 1024), (1, 512, 512), (0, 32, 32)
# the float64 gradient check of the 2D step takes this many of the 32 patches
GRAD64_PATCHES_2D = 4
# 24 padded 1088 x 1088 planes a forward: past max_patch_voxels' default 2**24
SLAB_BUDGET_2D = 2**25
# the 2D device sweep against the host loop on the same planes (both cuDNN f32,
# other batch sizes: another summation order), and one slab plane against its
# own forward
SWEEP_2D_TOL = 1e-4
# resources/2DUnet_dsb2018: the model, loss, optimizer, eval_metric, lr_scheduler,
# the batch of 32 crops of 256 x 256, and the predictor's pad_to_multiple
DSB_MODEL = {"name": "UNet2D", "in_channels": 1, "out_channels": 1, "layer_order": "bcr", "num_groups": 8,
             "f_maps": [32, 64, 128], "final_sigmoid": True, "is_segmentation": True}
DSB_SECTIONS = {
    "loss": {"name": "BCEDiceLoss", "skip_last_target": True},
    "optimizer": {"learning_rate": 0.0002, "weight_decay": 1.0e-05},
    "eval_metric": {"name": "BlobsAveragePrecision", "use_last_target": True, "metric": "ap"},
    "lr_scheduler": {"name": "ReduceLROnPlateau", "mode": "max", "factor": 0.2, "patience": 30},
}
DSB_BATCH, DSB_CROP, DSB_PAD = 32, (256, 256), 64
# the DSB2018 stage-1 image sizes, two images of each
DSB_SIZES = [(256, 256), (256, 320), (520, 696), (1024, 1024)] * 2
# the padded forward against the unpadded one, beyond DSB_MARGIN pixels of the
# padded edges (the model's receptive field reaches 44 pixels): f32 cuDNN on
# two shapes, another summation order
DSB_PAD_TOL, DSB_MARGIN = 1e-4, 64
# phase 27: the 3D options on the confocal UNet3D whose convs stay 3x3x3 pad 1,
# and the anisotropic conv that leaves the kernels
OPTIONS_3D = {"trilinear": {"upsample": "trilinear"}, "deconv": {"upsample": "deconv"},
              "upscale1": {"conv_upscale": 1}}
ANISOTROPIC_3D = {"conv_kernel_size": [1, 3, 3], "conv_padding": [0, 1, 1]}
# phase 28: the trainer's breadth. remat gradients against the plain step's,
# relative to each tensor's max |g| (the same kernels and cuDNN's deterministic
# algorithms); accumulated against batch-2 gradients relative to the step's
# max |g| (another summation order over the batch); the
# f32 EMA against a float64 recurrence, relative to the parameters' max |p|;
# a resumed run's losses against the uninterrupted run's, absolute
REMAT_TOL, ACCUM_TOL, EMA_TOL, RESUME_TOL = 1e-5, 1e-4, 1e-6, 1e-4
# the three commented lines of resources/3DUnet_confocal_boundary_tpu/train_config.yml
BREADTH_TRAINER = {"ema_decay": 0.999, "grad_accum_steps": 2, "resume": "auto"}
# phase 29: the custom op's opcheck shape; the exported patch, the halo'd
# 112 x 234 x 234 patch rounded up to the pool factor 8, and the artifact
# against the eager model (the same kernels in the same order: expect 0);
# requests timed, concurrent clients, and the 2D micro-batching of
# resources/2DUnet_confocal_boundary/test_config.yml under --batch-planes 24
# for requests of 4 planes of 1024x1024 and of one 512x512 plane, each result
# against its direct prediction (JAX tests/test_serve.py:294)
OPCHECK_SHAPE, OPCHECK_F = (1, 4, 9, 10, 16), 64
EXPORT_PATCH, EXPORT_TOL = (112, 240, 240), 1e-6
SERVE_RUNS, SERVE_CLIENTS = 3, 4
SERVE_BATCH_PLANES, SERVE_2D_CLIENTS, SERVE_2D_PLANES, SERVE_2D_TOL = 24, 6, 4, 3e-5
SERVE_1P_CLIENTS = 16
# H100 SXM peaks (NVIDIA's data sheet, dense): f32 on the CUDA cores, HBM
# bandwidth, TF32 and bf16 on the tensor cores
F32_FLOPS, HBM_BYTES_PER_S = 67e12, 3.35e12
TF32_FLOPS, BF16_FLOPS = 495e12, 989e12
# f32 on the tensor-core kernels is 3xTF32: three TF32 products per MAC
TC_F32_PASSES = 3


def log(msg):
    print(msg, flush=True)


def check(condition, message):
    if not condition:
        raise RuntimeError(f"chip_smoke failed: {message}")


def timed_ms(fn, runs=RUNS):
    """Median of `runs` CUDA-event timings of fn() after one warm-up call."""
    fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def with_tf32(fn):
    """fn() with cuDNN's TF32 on, then off again."""
    torch.backends.cudnn.allow_tf32 = True
    try:
        return fn()
    finally:
        torch.backends.cudnn.allow_tf32 = False


def reset_launches():
    from pytorch3dunet_tpu_torch.ops import conv3d, group_norm

    conv3d.reset_launches()
    group_norm.reset_launches()


def launches_by_dtype():
    """The launches of each hand kernel since the last reset, by dtype: the
    conv kernels' and the GroupNorm kernel's launch pairs."""
    from pytorch3dunet_tpu_torch.ops import conv3d, group_norm

    return {**{name: dict(counts) for name, counts in conv3d.launches_by_dtype.items()},
            group_norm.KERNEL: dict(group_norm.launches_by_dtype)}


def count_launches(launches, path, fn):
    """fn() with the launch counts set to 0 just before it; its launches by
    kernel and dtype go to launches[path]."""
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    launches[path] = launches_by_dtype()
    return out


def expect_launches(launches, path, k2=(0, 0), k3=(0, 0), k1=(0, 0), gn=(0, 0)):
    """Fails unless `path` launched K2, K3, K1 and GroupNorm pairs (f32,
    bf16) times as given."""
    want = {"conv3d_fwd": dict(zip(("f32", "bf16"), k2)), "conv3d_packw": dict(zip(("f32", "bf16"), k3)),
            "conv3d_im2col": dict(zip(("f32", "bf16"), k1)), "group_norm": dict(zip(("f32", "bf16"), gn))}
    check(launches[path] == want, f"{path} launched {launches[path]}, expected {want}")


def conv_inputs(shape, c_out, dtype, bias, gen, device):
    c_in = shape[-1]
    x = torch.randn(shape, generator=gen, device=device).to(dtype)
    w = ((torch.rand(3, 3, 3, c_in, c_out, generator=gen, device=device) * 2 - 1) / (27 * c_in) ** 0.5).to(dtype)
    b = (torch.rand(c_out, generator=gen, device=device) - 0.5).to(dtype) if bias else None
    return x, w, b


def path_conv_shapes(model, patch_in):
    """(name, NDHWC input shape, F) of every conv that one forward of `model`
    on a patch of spatial shape `patch_in` runs on the kernels, as the
    switches are set now (`kernel_conv_plan`: the fused decoders' two
    branches, the phase deconvs' wide convs)."""
    from pytorch3dunet_tpu_torch.models.unet import kernel_conv_plan

    return [(name, shape, f) for name, shape, f, _, _ in kernel_conv_plan(model, patch_in)]


def dgrad_shapes(model, patch):
    """(name, NDHWC dy shape, C) of every input gradient that one train step
    on `patch` computes: every kernel conv but one that reads the raw patch
    itself. With layer_order 'gcr' there is none such: the first conv reads the
    output of a GroupNorm whose affine parameters need its input gradient."""
    from pytorch3dunet_tpu_torch.models.unet import kernel_conv_plan

    return [(name, (*shape[:4], f), shape[4]) for name, shape, f, _, grad in kernel_conv_plan(model, patch) if grad]


# the K2 and K1 launches of one forward, the K3 launches of one train step's
# backward, and the GroupNorm launch pairs of one forward without a gradient
# (a forward that needs one, and every forward under a space mesh, launches none)
Launches = collections.namedtuple("Launches", "k2 k3 k1 gn")


def plan_launches(model, patch_in, space_mesh=False):
    """`Launches` of `model` (or a model config) on a patch of spatial shape
    `patch_in`, derived from `kernel_conv_plan` and `group_norm_plan` under
    the switches as they are set now (the Decoder's fused choice,
    P3DUNET_DECONV, P3DUNET_TAPFOLD), the generic decoders under a space mesh.
    Every launch gate of phases 4-31 reads it, so a change of default changes
    the gates with it."""
    from pytorch3dunet_tpu_torch.models.unet import get_model, group_norm_plan, kernel_conv_plan

    if isinstance(model, dict):
        model = get_model(dict(model))
    plan = kernel_conv_plan(model, patch_in, space_mesh)
    return Launches(sum(v == "roll" for *_, v, _ in plan), sum(grad for *_, grad in plan),
                    sum(v == "im2col" for *_, v, _ in plan), 0 if space_mesh else len(group_norm_plan(model, patch_in)))


def randomize_group_norms(model, gen):
    """GroupNorm affines drawn from `gen`: weights in [0.5, 1.5), biases in [-0.2, 0.2)."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, torch.nn.GroupNorm):
                module.weight.copy_(torch.rand(module.weight.shape, generator=gen) + 0.5)
                module.bias.copy_(torch.rand(module.bias.shape, generator=gen) * 0.4 - 0.2)


def conv_bound(shape, c_out, bias=True, itemsize=4, flops_per_s=F32_FLOPS, passes=1):
    """(ms, bound_by) of the least time the card could take for one 3x3x3
    conv: FLOPs (times `passes`) at `flops_per_s`, by default the f32 FFMA
    peak, or bytes (x, w, b read once, y written once) at the HBM rate,
    whichever is larger."""
    voxels, c_in = int(np.prod(shape[:4])), shape[4]
    ops_ms = passes * 2 * 27 * voxels * c_in * c_out / flops_per_s * 1e3
    bytes_ms = itemsize * (voxels * (c_in + c_out) + 27 * c_in * c_out + (c_out if bias else 0)) / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def tc_bound(shape, c_out, bias=True, dtype=torch.float32):
    """`conv_bound` of a conv on the tensor-core kernels: in f32 3xTF32 MMAs
    at the TF32 peak, in bf16 one MMA at the bf16 peak."""
    if dtype == torch.bfloat16:
        return conv_bound(shape, c_out, bias, itemsize=2, flops_per_s=BF16_FLOPS)
    return conv_bound(shape, c_out, bias, flops_per_s=TF32_FLOPS, passes=TC_F32_PASSES)


def summed_bound(rows, bound=conv_bound):
    """Sum of `bound` over (shape, c_out, bias) rows, and what bounds most of it."""
    bounds = [bound(*row) for row in rows]
    by_ops = sum(ms for ms, by in bounds if by == "operations")
    total = sum(ms for ms, _ in bounds)
    return total, "operations" if by_ops >= total / 2 else "bytes"


def ptxas_report(log):
    """{"f32": {...}, "bf16": {...}}: the most registers and spill bytes over
    each dtype's kernel instantiations, read from nvcc's `-Xptxas -v` output."""
    report, dtype = {}, None
    for line in log.splitlines():
        words = line.replace(",", "").split()
        if "Compiling entry function" in line:
            dtype = "bf16" if "bfloat16" in line else "f32"
            report.setdefault(dtype, {"registers": 0, "spill_bytes": 0})
        elif dtype and "spill stores" in line:
            spill = int(words[words.index("spill") - 2]) + int(words[words.index("loads") - 3])
            report[dtype]["spill_bytes"] = max(report[dtype]["spill_bytes"], spill)
        elif dtype and "Used" in words and "registers" in words:
            report[dtype]["registers"] = max(report[dtype]["registers"], int(words[words.index("registers") - 1]))
    return report


def library_conv(x, w, b):
    """One cuDNN call for the same function: F.conv3d on the NCDHW views."""
    import torch.nn.functional as F

    return F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2), b, padding=1)


def check_kernel(tag, fn, ref, cases, gen, device, phase=3):
    """fn against ref on every (name, shape, c_out, bias) case, in f32 and bf16;
    returns the largest error of the non-edge cases per dtype and the failures."""
    errors = {torch.float32: 0.0, torch.bfloat16: 0.0}
    failed = []
    with torch.inference_mode():
        for name, shape, f, bias in cases:
            for dtype in (torch.float32, torch.bfloat16):
                x, w, b = conv_inputs(shape, f, dtype, bias, gen, device)
                got = fn(x, w, b)
                torch.cuda.synchronize()
                want = ref(x, w, b)
                err = (got.float() - want.float()).abs().max().item()
                tol = TOL[dtype] * want.float().abs().max().item()
                if not name.startswith("edge"):
                    errors[dtype] = max(errors[dtype], err)
                ok = got.shape == want.shape and got.dtype == dtype and err <= tol
                if not ok:
                    failed.append((name, shape, f, dtype))
                log(f"[{phase} {tag}] {name:42s} x{shape} F={f:<3d} {str(dtype)[6:]:8s} bias={bias!s:5s} "
                    f"max|d|={err:.3e} tol={tol:.3e} {'ok' if ok else 'FAIL'}")
                del x, w, b, got, want
    return errors, failed


def profile_step(step, top=12, tag="9 profile", what="one train step"):
    """Device time of one call of `step` under torch.profiler, summed by
    kernel name: the hand-written kernels, then the largest others. The sum
    counts overlapping kernels twice, so it is no busy share (the benchmark's
    `idle_share.*` read that from the union of device intervals)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    by_name = {}
    for event in prof.events():
        if event.device_type == DeviceType.CUDA:
            by_name[event.name] = by_name.get(event.name, 0.0) + event.time_range.elapsed_us() / 1e3
    kernel_ms = sum(by_name.values())
    if not kernel_ms:
        log(f"[{tag}] the profiler recorded no device time")
        return
    log(f"[{tag}] {what}: {kernel_ms:.2f} ms of kernel time summed over {len(by_name)} kernel names")
    ours = [name for name in by_name if any(k in name for k in ("conv3d_fwd_kernel", "conv3d_packw_kernel",
                                                                  "conv3d_im2col_kernel"))]
    others = sorted((name for name in by_name if name not in ours), key=by_name.get, reverse=True)
    for name in ours + others[:top]:
        log(f"[{tag}] {by_name[name]:9.2f} ms {100 * by_name[name] / kernel_ms:5.1f}%  {name[:110]}")
    wgrad_ms = sum(ms for name, ms in by_name.items() if "wgrad" in name.lower())
    if wgrad_ms:
        log(f"[{tag}] cuDNN's weight-gradient kernels (names with 'wgrad'): {wgrad_ms:.2f} ms "
            f"({100 * wgrad_ms / kernel_ms:.1f}% of the summed kernel time)")


# phase 12: the benchmark's ResidualUNetSE3D cell, its configuration, seeded
# weights and volume, and its limit (benchmark/workloads/<SE_CELL>.json)
SE_CELL, SE_SEED = "lightsheet_resunetse3d.sweep_grid_bf16", 2**31 + 1201


def se_sweep_phase(device, launches):
    """Phase 12: ResidualUNetSE3D's bf16 device sweep of one volume against
    the plain float32 reference. Adds the sweep's launches to `launches`."""
    from benchmark import harness, seeded
    from benchmark.reference import sweep as ref_sweep
    from benchmark.traffic.sweep import recipe_model
    from pytorch3dunet_tpu_torch.datasets.utils import calculate_stats
    from pytorch3dunet_tpu_torch.inference_device import detect_device_path
    from pytorch3dunet_tpu_torch.models.unet import get_model, se_plan
    from pytorch3dunet_tpu_torch.predict import get_predictor

    cell = harness.load_cell(SE_CELL)
    config = harness.load_config(cell["config"])
    recipe = config[cell["recipe"]]
    patch, stride, halo = recipe["patch_shape"], recipe["stride_shape"], recipe["halo_shape"]
    model_cfg = recipe_model(config, recipe)
    params = seeded.weights(config["model"], SE_SEED, device)
    model = get_model(model_cfg)
    model.load_state_dict(params, strict=True)
    model = model.to(device).eval()
    predictor = get_predictor(model, {"model": model_cfg, "device": device, "predictor": dict(recipe["predictor"]),
                                      "loaders": {}})
    volume = seeded.volumes(tuple(cell["volume"]), 1, SE_SEED, device, int(cell["cells"]))[0]
    patch_in = tuple(p + 2 * h for p, h in zip(patch, halo))
    patches = len(ref_sweep.grid(volume.shape, patch, stride))
    n = plan_launches(model, patch_in)
    gates, calls = se_plan(model), []
    hooks = [model.get_submodule(name).register_forward_hook(lambda _m, _i, _o, name=name: calls.append(name))
             for name in gates]
    normalize, stats = detect_device_path(recipe["transformer"], calculate_stats(volume))
    start = time.perf_counter()
    out = count_launches(launches, "resunet_se_sweep_bf16", lambda: predictor.predict_array(
        volume, patch, stride, halo, normalize=normalize, stats=stats))
    first_s = time.perf_counter() - start
    for hook in hooks:
        hook.remove()
    start = time.perf_counter()
    predictor.predict_array(volume, patch, stride, halo, normalize=normalize, stats=stats)
    second_s = time.perf_counter() - start
    log(f"[12 resunet-se sweep bf16] {tuple(volume.shape)}: {patches} patches of {patch_in} in {first_s:.2f} s "
        f"(first call), {second_s:.2f} s (second); launches {launches['resunet_se_sweep_bf16']} (a forward: "
        f"{n.k2} K2, {n.gn} GroupNorm); scSE gate calls {len(calls)} ({len(gates)} a forward, se_plan)")
    expect_launches(launches, "resunet_se_sweep_bf16", k2=(0, n.k2 * patches), gn=(0, n.gn * patches))
    check(calls == gates * patches, f"the scSE gates were called {len(calls)} times, expected {len(gates)} x "
                                    f"{patches} in se_plan's order")
    del predictor, model
    torch.cuda.empty_cache()
    start = time.perf_counter()
    ref = ref_sweep.predict(volume, params, dict(model_cfg, dtype=None), patch, stride, halo,
                            recipe["predictor"].get("blend", "assign"), device)
    gap, limit = ref_sweep.max_gap(out, ref), cell["limits"]["max_abs_gap"]
    log(f"[12 resunet-se sweep bf16] against the plain float32 reference ({time.perf_counter() - start:.1f} s, one "
        f"patch at a time): max|d| = {gap:.3e} (the cell's limit {limit}); probs in [{out.min():.4f}, "
        f"{out.max():.4f}], mean {out.mean():.4f}")
    check(np.isfinite(out).all() and gap <= limit, f"ResidualUNetSE3D bf16 sweep: max|d| {gap} (limit {limit})")


def residual_unet_phases(device, gen, volume, batches):
    """Phases 10-14: K1 against its plain version, then ResidualUNet3D predict
    and train at full width with P3DUNET_TAPFOLD=1 (between them phase 12,
    one ResidualUNetSE3D forward with it, then its bf16 device sweep
    without it), and their times.
    Returns what the kernels line needs."""
    from pytorch3dunet_tpu_torch.models.unet import get_model
    from pytorch3dunet_tpu_torch.ops.conv3d import (conv3d_fwd, conv3d_fwd_reference, conv3d_input_grad,
                                                    conv3d_input_grad_reference, plain_conv)
    from pytorch3dunet_tpu_torch.predictor import StandardPredictor
    from pytorch3dunet_tpu_torch.trainer import create_trainer

    from pytorch3dunet_tpu_torch.models.unet import kernel_conv_plan

    patch_in = tuple(p + 2 * h for p, h in zip(PATCH, HALO))
    torch.manual_seed(SEED)
    model = get_model(RES_MODEL)
    # the K1 and K2 convs of phases 11-14, under P3DUNET_TAPFOLD=1 (the phase
    # deconvs' wide convs stay on K2)
    os.environ["P3DUNET_TAPFOLD"] = "1"
    try:
        plans = {patch: kernel_conv_plan(model, patch) for patch in (patch_in, TRAIN_PATCH)}
        per_patch = plan_launches(model, patch_in)
        per_step = plan_launches(model, TRAIN_PATCH)
    finally:
        os.environ.pop("P3DUNET_TAPFOLD", None)
    k1_shapes, k2_shapes = ([(name, shape, f) for name, shape, f, v, _ in plans[patch_in] if v == variant]
                            for variant in ("im2col", "roll"))
    train_k1, train_k2 = ([(name, shape, f) for name, shape, f, v, _ in plans[TRAIN_PATCH] if v == variant]
                          for variant in ("im2col", "roll"))
    dgrads = dgrad_shapes(model, TRAIN_PATCH)
    log(f"[10 resunet] under P3DUNET_TAPFOLD=1 a {patch_in} forward runs {per_patch.k1} K1 + {per_patch.k2} K2, "
        f"a {TRAIN_PATCH} step {per_step.k1} K1 + {per_step.k2} K2 + {per_step.k3} K3 (kernel_conv_plan)")

    # 10. the kernels against their plain versions at this model's shapes
    edges = [(f"edge{i}", case[:5], case[5], case[6]) for i, case in enumerate(EDGE_CASES)]
    cases = [(f"predict {name}", shape, f, True) for name, shape, f in k1_shapes]
    cases += [(f"train {name}", shape, f, True) for name, shape, f in train_k1]
    errors, failed = check_kernel("K1", lambda x, w, b: conv3d_fwd(x, w, b, variant="im2col"), conv3d_fwd_reference,
                                  cases + edges, gen, device, phase=10)
    check(not failed, f"K1 disagrees with the plain version: {failed}")
    cases = [(f"predict {name}", shape, f, True) for name, shape, f in k2_shapes]
    cases += [(f"train {name}", shape, f, True) for name, shape, f in train_k2]
    errors_k2, failed = check_kernel("K2", lambda x, w, b: conv3d_fwd(x, w, b, variant="roll"),
                                     conv3d_fwd_reference, cases, gen, device, phase=10)
    check(not failed, f"K2 disagrees with the plain version: {failed}")
    # the wrapper the train step calls: dy (N, D, H, W, F) and the forward's w
    # (3, 3, 3, C, F); conv_inputs draws w as (3, 3, 3, F, C)
    errors_k3, failed = check_kernel("K3", lambda dy, w, _: conv3d_input_grad(dy, w.transpose(3, 4)),
                                     lambda dy, w, _: conv3d_input_grad_reference(dy, w.transpose(3, 4)),
                                     [(f"dgrad {name}", shape, c, False) for name, shape, c in dgrads], gen, device,
                                     phase=10)
    check(not failed, f"conv3d_input_grad (K3) disagrees with its plain version: {failed}")

    os.environ["P3DUNET_TAPFOLD"] = "1"
    try:
        # 11. ResidualUNet3D predict path at full width
        randomize_group_norms(model, torch.Generator().manual_seed(SEED))
        model = model.to(device).eval()
        predictor = StandardPredictor(model, None, RES_MODEL["out_channels"], device)
        patches = list(predictor.patches(volume, PATCH, STRIDE, HALO, TRANSFORMER))
        launches = {}
        start = time.perf_counter()
        out = count_launches(launches, "resunet_predict", lambda: predictor.predict_array(volume, PATCH, STRIDE, HALO,
                                                                                          TRANSFORMER))
        first_s = time.perf_counter() - start
        log(f"[11 resunet predict] predict_array {VOLUME} -> {out.shape} in {first_s:.2f} s (first call); "
            f"{len(patches)} patches of {patch_in}, launches {launches['resunet_predict']} (a forward: "
            f"{per_patch.k1} K1, {per_patch.k2} K2, {per_patch.gn} GroupNorm)")
        expect_launches(launches, "resunet_predict", k2=(per_patch.k2 * len(patches), 0),
                        k1=(per_patch.k1 * len(patches), 0), gn=(per_patch.gn * len(patches), 0))
        check(out.shape == (RES_MODEL["out_channels"], *VOLUME), f"output shape {out.shape}")
        check(np.isfinite(out).all() and out.min() >= 0 and out.max() <= 1, f"output in [{out.min()}, {out.max()}]")
        x0 = torch.from_numpy(patches[0][0][None]).to(device)
        with torch.inference_mode():
            probs = model(x0)[0]
            with plain_conv():
                probs_plain = model(x0)[0]
        err = (probs - probs_plain).abs().max().item()
        log(f"[11 resunet predict] patch 0: kernel vs plain forward max|d| = {err:.3e} (tol {FORWARD_TOL}); "
            f"probs in [{out.min():.4f}, {out.max():.4f}], mean {out.mean():.4f}")
        check(err <= FORWARD_TOL, f"ResidualUNet3D forward differs from the plain forward by {err}")
        del probs, probs_plain

        # 12. ResidualUNetSE3D: one full-width f32 forward on K1 and K2 against the plain forward, then the
        # device sweep in bf16 as the benchmark runs it (P3DUNET_TAPFOLD unset)
        torch.manual_seed(SEED)
        se_model = get_model({**RES_MODEL, "name": "ResidualUNetSE3D"})
        randomize_group_norms(se_model, torch.Generator().manual_seed(SEED))
        se_model = se_model.to(device).eval()
        with torch.inference_mode():
            se_probs = count_launches(launches, "resunet_se_forward", lambda: se_model(x0)[0])
            with plain_conv():
                se_plain = se_model(x0)[0]
        err = (se_probs - se_plain).abs().max().item()
        finite = bool(torch.isfinite(se_probs).all()) and 0 <= se_probs.min().item() <= se_probs.max().item() <= 1
        se_n = plan_launches(se_model, patch_in)
        log(f"[12 resunet-se] one {patch_in} f32 forward: launches {launches['resunet_se_forward']}; "
            f"kernel vs plain max|d| = {err:.3e} (tol {FORWARD_TOL}); finite in [0, 1]: {finite}")
        expect_launches(launches, "resunet_se_forward", k2=(se_n.k2, 0), k1=(se_n.k1, 0), gn=(se_n.gn, 0))
        check(finite and err <= FORWARD_TOL, f"ResidualUNetSE3D forward: finite {finite}, max|d| {err}")
        del se_model, se_probs, se_plain
        os.environ.pop("P3DUNET_TAPFOLD")
        se_sweep_phase(device, launches)
        os.environ["P3DUNET_TAPFOLD"] = "1"

        # 13. ResidualUNet3D train path at full width. cuDNN's default
        # algorithms for this model's f32 backward are not deterministic (the
        # plain step differed from itself by up to 1.3e-3 of a tensor's max|g|
        # between two calls, and the per-tensor margin below moved with it from
        # run to run, once below 0): the fit and the gradient check run on
        # deterministic algorithms, so that the margin measures the kernels, not
        # one draw of the order of cuDNN's reductions
        torch.backends.cudnn.deterministic = True
        train_batch, val_batch = batches
        losses = []
        with tempfile.TemporaryDirectory() as checkpoint_dir:
            config = {"manual_seed": SEED, "device": "cuda", "model": dict(RES_MODEL), **TRAIN_SECTIONS,
                      "lr_scheduler": dict(RES_LR_SCHEDULER),
                      "trainer": {"eval_score_higher_is_better": False, "checkpoint_dir": checkpoint_dir,
                                  "validate_after_iters": RES_VALIDATE_AFTER, "log_after_iters": 10**9,
                                  "max_num_epochs": 10**9, "max_num_iterations": RES_TRAIN_STEPS - 1}}
            trainer = create_trainer(config, loaders={"train": [train_batch], "val": [val_batch]})
            criterion = trainer.loss_criterion

            def recording_criterion(logits, target):
                loss = criterion(logits, target)
                if torch.is_grad_enabled():
                    losses.append(loss.item())
                return loss

            trainer.loss_criterion = recording_criterion
            start = time.perf_counter()
            count_launches(launches, "resunet_train", trainer.fit)
            fit_s = time.perf_counter() - start
            trainer.loss_criterion = criterion
        n_val = RES_TRAIN_STEPS // RES_VALIDATE_AFTER
        log(f"[13 resunet train] fit: {RES_TRAIN_STEPS} steps of {TRAIN_PATCH} + {n_val} validation in {fit_s:.2f} s; "
            f"launches {launches['resunet_train']} (GroupNorm only in the validation); losses "
            f"{', '.join(f'{v:.5f}' for v in losses)}; best val ARand {trainer.best_eval_score:.5f}")
        expect_launches(launches, "resunet_train", k2=(per_step.k2 * (RES_TRAIN_STEPS + n_val), 0),
                        k1=(per_step.k1 * (RES_TRAIN_STEPS + n_val), 0), k3=(per_step.k3 * RES_TRAIN_STEPS, 0),
                        gn=(per_step.gn * n_val, 0))
        check(len(losses) == RES_TRAIN_STEPS and all(math.isfinite(v) for v in losses), f"losses {losses}")
        check(losses[-1] < losses[0], f"ResidualUNet3D loss did not fall: {losses}")

        train_model, optimizer = trainer.model, trainer.optimizer
        inp = torch.from_numpy(train_batch[0]).to(device)
        target = torch.from_numpy(train_batch[1]).to(device)
        randomize_group_norms(train_model, torch.Generator().manual_seed(SEED + 1))

        def step_grads(m, dtype):
            m.zero_grad(set_to_none=True)
            criterion(m(inp.to(dtype))[1], target.to(dtype)).backward()
            return {name: p.grad.detach().double() for name, p in m.named_parameters()}

        grads = step_grads(train_model, torch.float32)
        with plain_conv():
            grads_plain = step_grads(train_model, torch.float32)
            grads_plain_again = step_grads(train_model, torch.float32)
            grads64 = step_grads(copy.deepcopy(train_model).double(), torch.float64)
        torch.backends.cudnn.deterministic = False

        def rel(a, b):
            return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)

        err_k = {k: rel(g, grads64[k]) for k, g in grads.items()}
        err_p = {k: rel(g, grads64[k]) for k, g in grads_plain.items()}
        vs_plain = max((rel(g, grads_plain[k]), k) for k, g in grads.items())
        plain_repeat = max((rel(g, grads_plain[k]), k) for k, g in grads_plain_again.items())
        margin = min((2 * err_p[k] + RES_GRAD_TOL - err_k[k], k) for k in grads)
        log(f"[13 resunet train] one step's parameter grads against a float64 plain step: kernels worst "
            f"{max(err_k.values()):.3e} ({max(err_k, key=err_k.get)}), plain f32 worst {max(err_p.values()):.3e} "
            f"({max(err_p, key=err_p.get)}); kernels vs plain f32 worst {vs_plain[0]:.3e} ({vs_plain[1]}, "
            f"cap {VS_PLAIN_CAP}); plain f32 vs itself worst {plain_repeat[0]:.3e} ({plain_repeat[1]}); "
            f"least margin to 2 x plain + {RES_GRAD_TOL}: {margin[0]:.3e} ({margin[1]}) over {len(grads)} tensors")
        check(all(math.isfinite(v) for v in err_k.values()), "ResidualUNet3D train-step grads are not finite")
        check(margin[0] >= 0, f"ResidualUNet3D train-step grads: kernels {err_k[margin[1]]} vs plain f32 "
                              f"{err_p[margin[1]]} from float64 at {margin[1]}")
        check(vs_plain[0] <= VS_PLAIN_CAP, f"ResidualUNet3D train-step grads differ from the plain f32 step by "
                                           f"{vs_plain[0]} (cap {VS_PLAIN_CAP}) at {vs_plain[1]}")
        del grads, grads_plain, grads_plain_again, grads64

        # 14. times: K1 per shape, the patch forward, predict_array
        k1_times = []
        with torch.inference_mode():
            for name, shape, f in k1_shapes:
                x, w, b = conv_inputs(shape, f, torch.float32, True, gen, device)
                row = {"conv": name, "x": shape, "F": f,
                       "k1_ms": timed_ms(lambda: conv3d_fwd(x, w, b, variant="im2col")),
                       "k2_ms": timed_ms(lambda: conv3d_fwd(x, w, b, variant="roll")),
                       "plain_ms": timed_ms(lambda: conv3d_fwd_reference(x, w, b)),
                       "plain_tf32_ms": with_tf32(lambda: timed_ms(lambda: conv3d_fwd_reference(x, w, b))),
                       "library_ms": timed_ms(lambda: library_conv(x, w, b)),
                       "library_tf32_ms": with_tf32(lambda: timed_ms(lambda: library_conv(x, w, b)))}
                xb, wb, bb = x.bfloat16(), w.bfloat16(), b.bfloat16()
                row["k1_bf16_ms"] = timed_ms(lambda: conv3d_fwd(xb, wb, bb, variant="im2col"))
                row["library_bf16_ms"] = timed_ms(lambda: library_conv(xb, wb, bb))
                row["bound_ms"] = tc_bound(shape, f)[0]
                row["bound_ffma_ms"] = conv_bound(shape, f)[0]
                row["bound_tc_bf16_ms"] = tc_bound(shape, f, dtype=torch.bfloat16)[0]
                row["k1_tflops"] = 2 * 27 * np.prod(shape) * f / row["k1_ms"] / 1e9
                k1_times.append(row)
                log(f"[14 K1] {name:42s} x{shape} F={f:<3d} K1 {row['k1_ms']:.3f} ms ({row['k1_tflops']:.1f} "
                    f"TFLOP/s, 3xTF32 bound {row['bound_ms']:.3f}, FFMA {row['bound_ffma_ms']:.3f}) | K2 "
                    f"{row['k2_ms']:.3f} | cuDNN F.conv3d {row['library_ms']:.3f}, TF32 {row['library_tf32_ms']:.3f} | "
                    f"plain {row['plain_ms']:.3f}, TF32 {row['plain_tf32_ms']:.3f} | K1 bf16 {row['k1_bf16_ms']:.3f} "
                    f"ms (bf16 bound {row['bound_tc_bf16_ms']:.3f}, cuDNN bf16 {row['library_bf16_ms']:.3f})")
                del x, w, b, xb, wb, bb
            sums = {key: sum(r[key] for r in k1_times) for key in k1_times[0] if key.endswith("_ms")}
            tflop = sum(2 * 27 * np.prod(s) * f for _, s, f in k1_shapes) / 1e12
            log(f"[14 K1] all {len(k1_times)} K1 convs of one forward ({tflop:.3f} TFLOP): K1 {sums['k1_ms']:.2f} ms | "
                f"3xTF32 bound {sums['bound_ms']:.2f}, FFMA {sums['bound_ffma_ms']:.2f} | K2 {sums['k2_ms']:.2f} | cuDNN "
                f"{sums['library_ms']:.2f}, TF32 {sums['library_tf32_ms']:.2f} | plain {sums['plain_ms']:.2f}, TF32 "
                f"{sums['plain_tf32_ms']:.2f} | K1 bf16 {sums['k1_bf16_ms']:.2f} ms (bf16 bound "
                f"{sums['bound_tc_bf16_ms']:.2f}, cuDNN bf16 {sums['library_bf16_ms']:.2f})")

            torch.cuda.reset_peak_memory_stats()
            fwd_ms = timed_ms(lambda: model(x0))
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            with plain_conv():
                fwd_plain_ms = timed_ms(lambda: model(x0))
                fwd_plain_tf32_ms = with_tf32(lambda: timed_ms(lambda: model(x0)))
        log(f"[14 resunet forward] one {patch_in} patch: kernels {fwd_ms:.2f} ms | plain conv {fwd_plain_ms:.2f} ms | "
            f"plain conv TF32 {fwd_plain_tf32_ms:.2f} ms | peak memory {peak_gib:.2f} GiB")
        walls = []
        for _ in range(RUNS):
            start = time.perf_counter()
            predictor.predict_array(volume, PATCH, STRIDE, HALO, TRANSFORMER)
            walls.append(time.perf_counter() - start)
        wall = statistics.median(walls)
        log(f"[14 resunet predict] predict_array {VOLUME}: median {wall:.3f} s of {RUNS} -> "
            f"{np.prod(VOLUME) / wall / 1e6:.3f} Mvoxel/s (runs: {', '.join(f'{t:.3f}' for t in walls)})")

        def forward():
            with torch.inference_mode():
                model(x0)

        profile_step(forward, tag="14 resunet profile", what="one ResidualUNet3D patch forward")
        del model, predictor, x0
        torch.cuda.empty_cache()

        def train_step():
            optimizer.zero_grad(set_to_none=True)
            criterion(train_model(inp)[1], target).backward()
            optimizer.step()

        torch.cuda.reset_peak_memory_stats()
        step_ms = timed_ms(train_step)
        step_peak_gib = torch.cuda.max_memory_allocated() / 2**30
        with plain_conv():
            step_plain_ms = timed_ms(train_step)
            step_plain_tf32_ms = with_tf32(lambda: timed_ms(train_step))
        voxels = np.prod(TRAIN_PATCH)
        log(f"[14 resunet train step] {TRAIN_PATCH} batch 1, forward + backward + Adam: kernels {step_ms:.2f} ms "
            f"({voxels / step_ms / 1e3:.3f} Mvoxel/s) | plain conv {step_plain_ms:.2f} ms | plain conv TF32 "
            f"{step_plain_tf32_ms:.2f} ms | peak memory {step_peak_gib:.2f} GiB")
        profile_step(train_step, tag="14 resunet profile", what="one ResidualUNet3D train step")
        del train_model, optimizer, trainer, inp, target
        torch.cuda.empty_cache()
    finally:
        os.environ.pop("P3DUNET_TAPFOLD", None)
        torch.backends.cudnn.deterministic = False

    return {"errors": errors, "errors_k2": errors_k2, "errors_k3": errors_k3, "launches": launches, "predict_out": out,
            "k1_ms": sums["k1_ms"], "k1_plain_ms": sums["plain_ms"], "k1_plain_tf32_ms": sums["plain_tf32_ms"],
            "k1_library_ms": sums["library_ms"], "k2_same_ms": sums["k2_ms"], "k1_count": len(k1_times),
            "k1_bound": summed_bound([(shape, f, True) for _, shape, f in k1_shapes], tc_bound),
            "k1_bound_ffma": summed_bound([(shape, f, True) for _, shape, f in k1_shapes]),
            "k1_bf16_ms": sums["k1_bf16_ms"], "k1_bound_tc_bf16_ms": sums["bound_tc_bf16_ms"],
            "k1_library_bf16_ms": sums["library_bf16_ms"]}


def device_sweep_phases(device, volume, host, res_host_out):
    """Phases 15-17: the device sweep of `DeviceSlidingWindowPredictor` on the
    synthetic volume, UNet3D in f32 and bf16 and ResidualUNet3D in bf16, each
    path driven with the launch counts set to 0 just before it. `host` is phase
    5's host predict_array ("out", "wall_s"), `res_host_out` phase 11's. Returns
    the launches of each path by kernel and dtype."""
    from pytorch3dunet_tpu_torch.datasets.utils import SliceBuilder, calculate_stats
    from pytorch3dunet_tpu_torch.inference_device import detect_device_path
    from pytorch3dunet_tpu_torch.models.unet import get_model
    from pytorch3dunet_tpu_torch.ops import conv3d
    from pytorch3dunet_tpu_torch.ops.conv3d import plain_conv
    from pytorch3dunet_tpu_torch.predictor import DeviceSlidingWindowPredictor, _plan_slab_grid

    normalize, stats = detect_device_path(TRANSFORMER["raw"], calculate_stats(volume))
    check(normalize == "standardize", f"the confocal transformer maps to {normalize!r} on the device")
    mvoxels = np.prod(VOLUME) / 1e6
    padded_plane = (VOLUME[1] + 2 * HALO[1]) * (VOLUME[2] + 2 * HALO[2])
    patch_in = tuple(p + 2 * h for p, h in zip(PATCH, HALO))
    launches = {}

    def seeded(config):
        # phase 4's and phase 11's weights: the seed before the model, then the GroupNorm affines
        torch.manual_seed(SEED)
        model = get_model(config)
        randomize_group_norms(model, torch.Generator().manual_seed(SEED))
        return model.to(device).eval()

    def in_bf16(model, config):
        bf16 = get_model({**config, "dtype": "bfloat16"})
        bf16.load_state_dict(model.state_dict())
        return bf16.to(device).eval()

    def sweep(model, stride, blend, **options):
        predictor = DeviceSlidingWindowPredictor(model, None, model.out_channels, device, blend=blend, **options)
        return lambda: predictor.predict_array(volume, PATCH, stride, HALO, normalize=normalize, stats=stats)

    def counted(path, fn):
        return count_launches(launches, path, fn)

    def expect(path, k2=(0, 0), k1=(0, 0), gn=(0, 0)):
        expect_launches(launches, path, k2=k2, k1=k1, gn=gn)

    def probs_ok(tag, out):
        ok = out.shape == (1, *VOLUME) and np.isfinite(out).all() and out.min() >= 0 and out.max() <= 1
        check(ok, f"{tag}: output {out.shape} in [{out.min()}, {out.max()}]")

    def timed(fn):
        """(median ms of SWEEP_RUNS CUDA-event timings after a warm-up, peak GiB of one call)."""
        ms = timed_ms(fn, runs=SWEEP_RUNS)
        torch.cuda.reset_peak_memory_stats()
        fn()
        return ms, torch.cuda.max_memory_allocated() / 2**30

    def grid(stride):
        return len(SliceBuilder._build_slices(np.broadcast_to(np.float32(0), VOLUME), PATCH, stride))

    # 15. UNet3D in f32
    model = seeded(MODEL)
    n = plan_launches(model, patch_in)
    n_conv = n.k2
    n_a, n_b = grid(TPU_STRIDE), grid(STRIDE)
    check((n_a, n_b) == (9, 4), f"{n_a} and {n_b} patches")
    sweep_a = sweep(model, TPU_STRIDE, TPU_BLEND)
    out_a = counted("device_sweep", sweep_a)
    expect("device_sweep", k2=(n_conv * n_a, 0), gn=(n.gn * n_a, 0))
    probs_ok("15(a)", out_a)
    with plain_conv():
        out_a_plain = sweep_a()
    err_a = np.abs(out_a - out_a_plain).max()
    log(f"[15 sweep] (a) {TPU_BLEND}, stride {TPU_STRIDE}: {n_a} patches of {patch_in}, launches "
        f"{launches['device_sweep']}; kernels vs plain conv max|d| = {err_a:.3e} (tol {FORWARD_TOL}); probs in "
        f"[{out_a.min():.4f}, {out_a.max():.4f}], mean {out_a.mean():.4f}")
    check(err_a <= FORWARD_TOL, f"device sweep (a) differs from its plain-conv sweep by {err_a}")
    del out_a_plain

    sweep_b = sweep(model, STRIDE, "assign")
    out_b = counted("device_sweep_assign", sweep_b)
    expect("device_sweep_assign", k2=(n_conv * n_b, 0), gn=(n.gn * n_b, 0))
    err_b = np.abs(out_b - host["out"]).max()
    log(f"[15 sweep] (b) assign, stride {STRIDE}: {n_b} patches, launches {launches['device_sweep_assign']}; "
        f"vs phase 4's host predict_array max|d| = {err_b:.3e} (tol {SWEEP_VS_HOST_TOL})")
    probs_ok("15(b)", out_b)
    check(err_b <= SWEEP_VS_HOST_TOL, f"device sweep (b) differs from the host loop by {err_b}")

    # 160 padded planes: the 192 of the volume do not fit, the 3 z-levels stream in slabs
    budget = 160 * padded_plane
    sweep_c = sweep(model, TPU_STRIDE, TPU_BLEND, max_device_voxels=budget)
    out_c = counted("device_sweep_streamed", sweep_c)
    expect("device_sweep_streamed", k2=(n_conv * n_a, 0), gn=(n.gn * n_a, 0))
    err_c = np.abs(out_c - out_a).max()
    log(f"[15 sweep] (c) (a) streamed, max_device_voxels {budget} ({budget // padded_plane} padded planes of "
        f"{VOLUME[0] + 2 * HALO[0]}): vs (a) max|d| = {err_c:.3e} (tol {STREAMED_TOL})")
    check(err_c <= STREAMED_TOL, f"streamed sweep differs from the one-shot sweep by {err_c}")
    del out_b, out_c

    slab_patch, slab_starts = _plan_slab_grid(VOLUME, PATCH, HALO, 1, 2**24)
    slab_in = tuple(p + 2 * h for p, h in zip(slab_patch, HALO))
    check((slab_patch, len(slab_starts)) == ((145, 170, 340), 2), f"slab plan {slab_patch} x {len(slab_starts)}")
    sweep_d = sweep(model, TPU_STRIDE, TPU_BLEND, patch_mode="slab")
    out_d = counted("device_sweep_slab", sweep_d)
    n_slab = plan_launches(model, slab_in)
    expect("device_sweep_slab", k2=(n_slab.k2 * len(slab_starts), 0), gn=(n_slab.gn * len(slab_starts), 0))
    probs_ok("15(d)", out_d)
    del out_d

    # (e) a slab past the default budget: the level-0 decoder concat (96
    # channels) passes 2^31 elements. Its GroupNorm against float64 statistics,
    # and the forward against the same forward with the plain conv computed in
    # depth chunks (no cuDNN call over 2^31 elements)
    big = (1, 1, *LARGE_SLAB)
    norm = model.decoders[-1].basic_module.SingleConv1.groupnorm  # GroupNorm(8, 96) of the concat
    per_group = norm.num_channels // norm.num_groups
    concat = norm.num_channels * int(np.prod(LARGE_SLAB))
    check(concat > 2**31 and norm.num_channels == 96, f"the large slab's decoder concat holds {concat} elements")
    gen = torch.Generator(device=device).manual_seed(SEED)
    with torch.inference_mode():
        x96 = torch.randn((1, norm.num_channels, *LARGE_SLAB), generator=gen, device=device)
        normed = norm(x96)
        group = x96[0, -per_group:].double()  # the last group: the highest offsets
        affine = [t[-per_group:].double()[:, None, None, None] for t in (norm.weight, norm.bias)]
        want = (group - group.mean()) / torch.sqrt(group.var(unbiased=False) + 1e-5) * affine[0] + affine[1]
        gn_err = (normed[0, -per_group:].double() - want).abs().max().item() / want.abs().max().item()
        del x96, normed, group, want
        x_big = torch.randn(big, generator=gen, device=device)
        torch.cuda.reset_peak_memory_stats()
        probs_big = model(x_big)[0]
        peak_big = torch.cuda.max_memory_allocated() / 2**30
        plain = conv3d.conv3d_fwd_reference

        def chunked(x, w, b=None):
            parts = []
            for z0 in range(0, x.shape[1], 32):
                lo, hi = max(z0 - 1, 0), min(z0 + 33, x.shape[1])
                parts.append(plain(x[:, lo:hi], w, b)[:, z0 - lo : z0 - lo + min(32, x.shape[1] - z0)])
            return torch.cat(parts, dim=1)

        conv3d.conv3d_fwd_reference = chunked
        try:
            with plain_conv():
                probs_big_plain = model(x_big)[0]
        finally:
            conv3d.conv3d_fwd_reference = plain
        err_e = (probs_big - probs_big_plain).abs().max().item()
        finite_e = bool(torch.isfinite(probs_big).all()) and 0 <= probs_big.min().item() <= probs_big.max().item() <= 1
        del x_big, probs_big, probs_big_plain
    torch.cuda.empty_cache()
    log(f"[15 sweep] (e) one forward of a {LARGE_SLAB} slab (decoder concat {concat} = "
        f"{concat / 2**31:.2f} x 2^31 elements): its 96-channel GroupNorm vs float64 max|d| / max|GN| = "
        f"{gn_err:.3e} (tol {LARGE_GN_TOL}); kernels vs the plain conv in depth chunks max|d| = {err_e:.3e} (tol "
        f"{FORWARD_TOL}); finite in [0, 1]: {finite_e}; peak {peak_big:.2f} GiB")
    check(gn_err <= LARGE_GN_TOL and err_e <= FORWARD_TOL and finite_e,
          f"the slab past 2^31 elements: GroupNorm {gn_err}, forward {err_e}, finite in [0, 1] {finite_e}")

    times = {}
    for tag, fn in (("(a)", sweep_a), ("(b)", sweep_b), ("(c)", sweep_c), ("(d)", sweep_d)):
        times[tag] = timed(fn)
    profile_step(sweep_a, top=8, tag="15 profile", what="one device sweep (a)")
    # the streamed sweep uploads each slab from its loader thread
    profile_step(sweep_c, top=8, tag="15 profile", what="one streamed device sweep (c)")
    profile_step(sweep_d, top=8, tag="15 profile", what="one slab sweep (d)")
    host_ms = 1e3 * host["wall_s"]
    log(f"[15 sweep] times, median of {SWEEP_RUNS} (CUDA events around the call, upload to download): "
        + " | ".join(f"{tag} {ms:.2f} ms, {mvoxels / ms * 1e3:.3f} Mvoxel/s, peak {gib:.2f} GiB"
                     for tag, (ms, gib) in times.items())
        + f" | phase 5 host predict_array (the grid of (b)) {host_ms:.2f} ms, {mvoxels / host_ms * 1e3:.3f} "
          f"Mvoxel/s | (d) {len(slab_starts)} slabs of {slab_in} = {np.prod(slab_in) / 1e6:.2f} M padded voxels")

    # 16. UNet3D in bf16
    model16 = in_bf16(model, MODEL)
    sweep_16 = sweep(model16, TPU_STRIDE, TPU_BLEND)
    out_16 = counted("device_sweep_bf16", sweep_16)
    expect("device_sweep_bf16", k2=(0, n_conv * n_a), gn=(0, n.gn * n_a))
    probs_ok("16", out_16)
    with plain_conv():
        out_16_plain = sweep_16()
    err_plain, err_f32 = np.abs(out_16 - out_16_plain).max(), np.abs(out_16 - out_a).max()
    ms_16, gib_16 = timed(sweep_16)
    log(f"[16 sweep bf16] (a) in bf16: launches {launches['device_sweep_bf16']}; vs the same bf16 sweep with the "
        f"plain conv max|d| = {err_plain:.3e} (ceiling {BF16_VS_PLAIN_TOL}); vs the f32 sweep (a) max|d| = "
        f"{err_f32:.3e} (ceiling {BF16_VS_F32_TOL}); {ms_16:.2f} ms, {mvoxels / ms_16 * 1e3:.3f} Mvoxel/s (f32 "
        f"{times['(a)'][0]:.2f} ms), peak {gib_16:.2f} GiB (f32 {times['(a)'][1]:.2f})")
    check(err_plain <= BF16_VS_PLAIN_TOL, f"bf16 sweep differs from its plain-conv sweep by {err_plain}")
    check(err_f32 <= BF16_VS_F32_TOL, f"bf16 sweep differs from the f32 sweep by {err_f32}")
    profile_step(sweep_16, top=8, tag="16 profile", what="one bf16 device sweep (a)")
    del model, model16, out_a, out_16, out_16_plain
    torch.cuda.empty_cache()

    # 17. ResidualUNet3D in bf16 under P3DUNET_TAPFOLD=1
    os.environ["P3DUNET_TAPFOLD"] = "1"
    try:
        res32 = seeded(RES_MODEL)
        n_res = plan_launches(res32, patch_in)
        out32 = counted("resunet_device_sweep", sweep(res32, STRIDE, "assign"))
        expect("resunet_device_sweep", k2=(n_res.k2 * n_b, 0), k1=(n_res.k1 * n_b, 0), gn=(n_res.gn * n_b, 0))
        err_host = np.abs(out32 - res_host_out).max()
        check(err_host <= SWEEP_VS_HOST_TOL, f"ResidualUNet3D sweep differs from phase 11's host loop by {err_host}")
        res16 = in_bf16(res32, RES_MODEL)
        sweep_17 = sweep(res16, STRIDE, "assign")
        out_17 = counted("resunet_device_sweep_bf16", sweep_17)
        expect("resunet_device_sweep_bf16", k2=(0, n_res.k2 * n_b), k1=(0, n_res.k1 * n_b), gn=(0, n_res.gn * n_b))
        probs_ok("17", out_17)
        with plain_conv():
            out_17_plain = sweep_17()
        err_plain, err_f32 = np.abs(out_17 - out_17_plain).max(), np.abs(out_17 - out32).max()
        ms_17, gib_17 = timed(sweep_17)
        ms_17_f32, gib_17_f32 = timed(sweep(res32, STRIDE, "assign"))
        log(f"[17 resunet sweep bf16] assign, stride {STRIDE}: f32 sweep vs phase 11's host loop max|d| = "
            f"{err_host:.3e} (tol {SWEEP_VS_HOST_TOL}); bf16 launches {launches['resunet_device_sweep_bf16']}; vs "
            f"the same bf16 sweep with the plain conv max|d| = {err_plain:.3e} (ceiling {BF16_VS_PLAIN_TOL}); vs the "
            f"f32 sweep max|d| = {err_f32:.3e} (ceiling {BF16_VS_F32_TOL}); bf16 {ms_17:.2f} ms, "
            f"{mvoxels / ms_17 * 1e3:.3f} Mvoxel/s, peak {gib_17:.2f} GiB | f32 {ms_17_f32:.2f} ms, "
            f"{mvoxels / ms_17_f32 * 1e3:.3f} Mvoxel/s, peak {gib_17_f32:.2f} GiB")
        check(err_plain <= BF16_VS_PLAIN_TOL, f"ResidualUNet3D bf16 sweep differs from its plain-conv sweep by "
                                              f"{err_plain}")
        check(err_f32 <= BF16_VS_F32_TOL, f"ResidualUNet3D bf16 sweep differs from its f32 sweep by {err_f32}")
        del res32, res16
        torch.cuda.empty_cache()
    finally:
        os.environ.pop("P3DUNET_TAPFOLD", None)
    return {"launches": launches}


def augment_phase(device, batch):
    """Phase 18: the device augmenter of the confocal `_tpu` train config on
    one full-size batch, on the card against the CPU with the same draws, and
    its times. `batch` is (raw, instance label), NCDHW numpy."""
    from pytorch3dunet_tpu_torch.ops import augment

    spec = augment.split_device_transforms(copy.deepcopy(TPU_LOADERS))
    names = ([e["raw"]["name"] for e in spec["paired"]], [c["name"] for c in spec["raw_only"]],
             spec["label_post"]["name"])
    want = (["RandomFlip", "RandomRotate90", "RandomRotate", "ElasticDeformation"],
            ["GaussianBlur3D", "AdditiveGaussianNoise", "AdditivePoissonNoise"], "StandardLabelToBoundary")
    check(names == want, f"the confocal _tpu spec is {names}")
    check(spec["paired"][3]["raw"]["spline_order"] == 3 and spec["paired"][3]["label"]["spline_order"] == 0,
          "elastic orders")
    raw, label = (torch.from_numpy(a).to(device) for a in batch)
    every = augment.DeviceAugmenter(augment.execution_probability_one(spec))

    def generators(seed):
        return torch.Generator().manual_seed(seed), torch.Generator(device=device).manual_seed(seed + 1)

    # every transform runs; the same draws, made once on the card, on the CPU
    draws = every.draw(raw.shape, generators(SEED))

    def on_cpu(value):
        if torch.is_tensor(value):
            return value.cpu()
        if isinstance(value, dict):
            return {k: on_cpu(v) for k, v in value.items()}
        return [on_cpu(v) for v in value] if isinstance(value, list) else value

    draws_cpu = on_cpu(draws)
    out_raw, out_label = every.apply(raw, label, draws)
    torch.cuda.synchronize()
    cpu_raw, cpu_label = every.apply(raw.cpu(), label.cpu(), draws_cpu)
    raw_err = (out_raw.cpu() - cpu_raw).abs().max().item() / cpu_raw.abs().max().item()
    differ = int((out_label.cpu() != cpu_label).sum())
    share = differ / cpu_label.numel()
    moved = (out_label[:, 1:] != label).float().mean().item()
    log(f"[18 augment] confocal _tpu spec on {tuple(raw.shape)}: paired {names[0]}, raw only {names[1]}, label "
        f"post {names[2]}; every transform at probability 1: card vs CPU, same draws: raw max|d| / max|raw| = "
        f"{raw_err:.3e} (ceiling {AUG_RAW_TOL}); labels {differ} of {cpu_label.numel()} voxels differ ({share:.2e}, "
        f"at most {AUG_LABEL_SHARE}); target {tuple(out_label.shape)}; the geometry moved {100 * moved:.1f}% of "
        f"the label voxels")
    check(out_raw.shape == raw.shape and out_label.shape == (1, 2, *TRAIN_PATCH), f"{out_raw.shape} {out_label.shape}")
    check(bool(torch.isfinite(out_raw).all()), "augmented raw is not finite")
    check(raw_err <= AUG_RAW_TOL, f"the augmenter on the card differs from the CPU by {raw_err} of max|raw|")
    check(share <= AUG_LABEL_SHARE, f"{differ} label voxels differ between the card and the CPU")
    del cpu_raw, cpu_label, draws_cpu

    # each transform alone, every probability at 1, with the draws above
    d = draws[0]
    r, lab = raw[0], label[0]
    (flip, rot90, rotate, elastic), (blur, noise, poisson) = d["paired"], d["raw_only"]
    rot_axes = augment._rotate_axes(spec["paired"][2]["raw"])
    ops = {
        "RandomFlip (raw + label)": lambda: (augment.random_flip(r, [1, 1, 1]), augment.random_flip(lab, [1, 1, 1])),
        "RandomRotate90 (raw + label)": lambda: (augment.random_rotate90(r, 1), augment.random_rotate90(lab, 1)),
        "RandomRotate order 0 (raw + label)": lambda: (
            augment.random_rotate(r, rotate["plane"], rotate["angle"], rot_axes, 0),
            augment.random_rotate(lab, rotate["plane"], rotate["angle"], rot_axes, 0)),
        "ElasticDeformation raw order 3": lambda: augment.elastic_deformation(r, 0.0, elastic["fields"], 3,
                                                                              execution_probability=1.0),
        "ElasticDeformation label order 0": lambda: augment.elastic_deformation(lab, 0.0, elastic["fields"], 0,
                                                                                execution_probability=1.0),
        "GaussianBlur3D": lambda: augment.gaussian_blur(r, 0.0, blur["sigma"], 1.0),
        "AdditiveGaussianNoise (draw + add)": lambda: augment.additive_gaussian_noise(
            r, 0.0, noise["std"], torch.randn(r.shape, device=device), 1.0),
        "AdditivePoissonNoise (draw + add)": lambda: augment.additive_poisson_noise(
            r, 0.0, torch.poisson(torch.full(r.shape, poisson["rate"], device=device)), 1.0),
        "StandardLabelToBoundary": lambda: augment.standard_label_to_boundary(lab[0], append_label=True),
    }
    for name, fn in ops.items():
        log(f"[18 augment] {name:36s} {timed_ms(fn):8.3f} ms")
    every_ms = timed_ms(lambda: every(raw, label, generators(SEED + 2)))
    augmenter = augment.DeviceAugmenter(spec)
    gens = generators(SEED + 4)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    config_runs = []
    for _ in range(RUNS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        augmenter(raw, label, gens)
        end.record()
        torch.cuda.synchronize()
        config_runs.append(start.elapsed_time(end))
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    config_ms = statistics.median(config_runs)
    log(f"[18 augment] the whole augmenter, draws included: every transform {every_ms:.2f} ms | the config's "
        f"probabilities median {config_ms:.2f} ms of {RUNS} ({', '.join(f'{t:.2f}' for t in config_runs)}), "
        f"peak memory above its inputs {peak_gib:.2f} GiB")


def bf16_grads_vs_plain(config, inp, tgt, tag, phase, launches):
    """One bf16 step's grads with the kernels (its launches counted as
    f"{tag}_step") against the same step with the plain conv (a ceiling) and
    against a float64 plain step (printed). Returns the model, the loss and
    the step's loss value."""
    from pytorch3dunet_tpu_torch.losses import get_loss_criterion
    from pytorch3dunet_tpu_torch.models.unet import get_model
    from pytorch3dunet_tpu_torch.ops.conv3d import plain_conv

    torch.manual_seed(SEED)
    model = get_model(config["model"])
    randomize_group_norms(model, torch.Generator().manual_seed(SEED + 1))
    model = model.to(inp.device).train()
    criterion = get_loss_criterion(config)

    def step_grads(m, x):
        m.zero_grad(set_to_none=True)
        # a class map stays integral; a float target takes the input's dtype
        loss = criterion(m(x)[1], tgt.to(x.dtype) if tgt.is_floating_point() else tgt)
        loss.backward()
        return {name: p.grad.detach().double() for name, p in m.named_parameters()}, loss

    grads, loss = count_launches(launches, f"{tag}_step", lambda: step_grads(model, inp))
    check(loss.dtype == torch.float32 and all(p.grad.dtype == torch.float32 for p in model.parameters()),
          f"{tag}: the bf16 step's loss or grads are not float32")
    with plain_conv():
        grads_plain, _ = step_grads(model, inp)
        m64 = get_model({**config["model"], "dtype": None})
        m64.load_state_dict(model.state_dict())
        grads64, _ = step_grads(m64.to(inp.device).double().train(), inp.double())
    g_max = max(g.abs().max().item() for g in grads_plain.values())
    vs_plain = max(((g - grads_plain[k]).abs().max().item() / g_max, k) for k, g in grads.items())
    g64_max = max(g.abs().max().item() for g in grads64.values())
    vs64 = max(((g - grads64[k]).abs().max().item() / g64_max, k) for k, g in grads.items())
    plain64 = max(((g - grads64[k]).abs().max().item() / g64_max, k) for k, g in grads_plain.items())
    per_tensor = max(((g - grads_plain[k]).abs().max().item() / max(grads_plain[k].abs().max().item(), 1e-30), k)
                     for k, g in grads.items())
    log(f"[{phase}] one bf16 step, {len(grads)} tensors: kernels vs plain conv (bf16) worst max|d| / max|g| "
        f"{vs_plain[0]:.3e} ({vs_plain[1]}, ceiling {BF16_STEP_VS_PLAIN_TOL}); per tensor / its own max|g| "
        f"worst {per_tensor[0]:.3e} ({per_tensor[1]}); from a float64 plain step: kernels {vs64[0]:.3e} "
        f"({vs64[1]}), plain bf16 {plain64[0]:.3e} ({plain64[1]}); loss {loss.item():.5f}")
    check(all(math.isfinite(g.abs().max().item()) for g in grads.values()), f"{tag}: bf16 grads not finite")
    check(vs_plain[0] <= BF16_STEP_VS_PLAIN_TOL, f"{tag}: bf16 step grads differ from the plain conv's by "
                                                 f"{vs_plain[0]} at {vs_plain[1]}")
    del grads, grads_plain, grads64, m64
    return model, criterion


def fit_with_augmentation(config, host_batch, val_batch, n_steps, validate_after, tag, phase, launches,
                          prepare=None):
    """The trainer's own fit with the device augmentation on: `n_steps`
    steps from the host batch, a validation every `validate_after`, its
    launches counted as `tag`; `prepare(trainer)` runs before the fit.
    Returns the trainer."""
    from pytorch3dunet_tpu_torch.models.unet import get_model
    from pytorch3dunet_tpu_torch.ops.augment import DeviceAugmenter
    from pytorch3dunet_tpu_torch.trainer import create_trainer
    from pytorch3dunet_tpu_torch.utils.checkpoint import load_checkpoint

    losses = []
    with tempfile.TemporaryDirectory() as checkpoint_dir:
        config = copy.deepcopy(config)
        higher_is_better = config.get("trainer", {}).get("eval_score_higher_is_better", False)
        config["trainer"] = {"eval_score_higher_is_better": higher_is_better, "checkpoint_dir": checkpoint_dir,
                             "validate_after_iters": validate_after, "log_after_iters": 10**9, "max_num_epochs": 10**9,
                             "max_num_iterations": n_steps - 1}
        trainer = create_trainer(config, loaders={"train": [host_batch], "val": [val_batch]})
        check(isinstance(trainer.device_augmenter, DeviceAugmenter), f"{tag}: no device augmenter")
        criterion = trainer.loss_criterion

        def recording_criterion(logits, target):
            loss = criterion(logits, target)
            if torch.is_grad_enabled():
                losses.append(loss.item())
            return loss

        trainer.loss_criterion = recording_criterion
        if prepare is not None:
            prepare(trainer)
        start = time.perf_counter()
        count_launches(launches, tag, trainer.fit)
        fit_s = time.perf_counter() - start
        trainer.loss_criterion = criterion
        ckpt = None
        if n_steps >= validate_after:
            ckpt_path = Path(checkpoint_dir) / "last_checkpoint.pytorch"
            state = load_checkpoint(ckpt_path)
            check(all(v.dtype == torch.float32 for v in state["model_state_dict"].values()
                      if v.is_floating_point()), f"{tag}: the checkpoint is not float32")
            get_model({**config["model"], "dtype": None}).load_state_dict(state["model_state_dict"], strict=True)
            ckpt = f"{ckpt_path.name} loads strictly into an f32 model"
    log(f"[{phase}] fit with device augmentation: {n_steps} steps of {tuple(host_batch[0].shape[2:])} in "
        f"{fit_s:.2f} s; launches {launches[tag]}; losses {', '.join(f'{v:.5f}' for v in losses)}"
        + (f"; {ckpt}" if ckpt else ""))
    check(len(losses) == n_steps and all(math.isfinite(v) for v in losses), f"{tag}: losses {losses}")
    return trainer


def bf16_train_phases(device, batches, f32_step_ms):
    """Phases 19-20: bf16 training of the confocal (UNet3D) and
    lightsheet-boundary (ResidualUNet3D, P3DUNET_TAPFOLD=1) `_tpu` train
    configs with their device augmentation. `batches` is phase 7's
    (train, val) pair, `f32_step_ms` phase 8's f32 step. Returns the launches
    of each path by kernel and dtype."""
    from pytorch3dunet_tpu_torch.utils.optim import create_optimizer

    (raw, target), val_batch = batches
    inp = torch.from_numpy(raw).to(device)
    tgt = torch.from_numpy(target).to(device)
    # what the stripped host pipeline yields: standardized raw, instance label with a channel axis
    host_batch = (raw, np.ascontiguousarray(target[:, 1:]))
    launches = {}

    def expect(path, k2=(0, 0), k3=(0, 0), k1=(0, 0), gn=(0, 0)):
        expect_launches(launches, path, k2, k3, k1, gn)

    # 19. UNet3D, the confocal _tpu train config
    config = {"manual_seed": SEED, "device": "cuda", "model": {**MODEL, "dtype": "bfloat16"}, **TRAIN_SECTIONS,
              "loaders": copy.deepcopy(TPU_LOADERS)}
    n = plan_launches(config["model"], TRAIN_PATCH)
    # (a) one bf16 step on the fixed batch, no augmentation
    model, criterion = bf16_grads_vs_plain(config, inp, tgt, "train_bf16", "19 bf16 train", launches)
    expect("train_bf16_step", k2=(0, n.k2), k3=(0, n.k3))
    optimizer = create_optimizer(config["optimizer"], model)

    def train_step():
        optimizer.zero_grad(set_to_none=True)
        loss = criterion(model(inp)[1], tgt)
        loss.backward()
        optimizer.step()
        return loss

    # (b) 6 Adam steps on that batch
    losses = [train_step().item() for _ in range(TRAIN_STEPS)]
    moments = [t for state in optimizer.state.values() for t in (state["exp_avg"], state["exp_avg_sq"])]
    f32_state = all(p.dtype == torch.float32 for p in model.parameters()) and all(
        t.dtype == torch.float32 for t in moments) and len(moments) == 2 * len(list(model.parameters()))
    log(f"[19 bf16 train] {TRAIN_STEPS} Adam steps on the batch: losses {', '.join(f'{v:.5f}' for v in losses)}; "
        f"parameters and Adam moments float32: {f32_state}")
    check(losses[-1] < losses[0] and all(math.isfinite(v) for v in losses), f"bf16 loss did not fall: {losses}")
    check(f32_state, "bf16 training left a parameter or a moment outside float32")
    # (c) the trainer's own fit with augmentation: 6 steps and 1 validation
    trainer = fit_with_augmentation(config, host_batch, val_batch, TRAIN_STEPS, TRAIN_STEPS, "train_bf16_augmented",
                                    "19 bf16 train", launches)
    expect("train_bf16_augmented", k2=(0, n.k2 * (TRAIN_STEPS + 1)), k3=(0, n.k3 * TRAIN_STEPS), gn=(0, n.gn))
    # times: the bf16 step, the augmented step and the augmenter's share
    augmenter, gens = trainer.device_augmenter, trainer.augment_generators
    label = torch.from_numpy(host_batch[1]).to(device)

    def augmented_step():
        x, y = augmenter(inp, label, gens)
        optimizer.zero_grad(set_to_none=True)
        criterion(model(x)[1], y).backward()
        optimizer.step()

    torch.cuda.reset_peak_memory_stats()
    step_ms = timed_ms(train_step)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    augmented_ms = timed_ms(augmented_step)
    augmenter_ms = timed_ms(lambda: augmenter(inp, label, gens))
    voxels = np.prod(TRAIN_PATCH)
    log(f"[19 bf16 train step] {TRAIN_PATCH} batch 1, forward + backward + Adam: bf16 {step_ms:.2f} ms "
        f"({voxels / step_ms / 1e3:.3f} Mvoxel/s) against phase 8's f32 {f32_step_ms:.2f} ms "
        f"({f32_step_ms / step_ms:.2f}x) | with the device augmentation at the config's probabilities "
        f"{augmented_ms:.2f} ms, the augmenter alone {augmenter_ms:.2f} ms ({100 * augmenter_ms / augmented_ms:.1f}% "
        f"of the augmented step) | peak memory {peak_gib:.2f} GiB")
    profile_step(train_step, top=10, tag="19 profile", what="one bf16 UNet3D train step")
    del model, optimizer, trainer, augmenter
    torch.cuda.empty_cache()

    # 20. ResidualUNet3D, the lightsheet-boundary _tpu train config, under the switch
    os.environ["P3DUNET_TAPFOLD"] = "1"
    try:
        config = {"manual_seed": SEED, "device": "cuda", "model": {**RES_MODEL, "dtype": "bfloat16"},
                  **TRAIN_SECTIONS, "lr_scheduler": dict(RES_LR_SCHEDULER), "loaders": copy.deepcopy(TPU_LOADERS)}
        trainer = fit_with_augmentation(config, host_batch, val_batch, 2, 10**9, "resunet_train_bf16_augmented",
                                        "20 resunet bf16 train", launches)
        n = plan_launches(config["model"], TRAIN_PATCH)
        expect("resunet_train_bf16_augmented", k2=(0, n.k2 * 2), k1=(0, n.k1 * 2), k3=(0, n.k3 * 2))
        del trainer
        model, criterion = bf16_grads_vs_plain(config, inp, tgt, "resunet_train_bf16", "20 resunet bf16 train",
                                               launches)
        expect("resunet_train_bf16_step", k2=(0, n.k2), k1=(0, n.k1), k3=(0, n.k3))
        optimizer = create_optimizer(config["optimizer"], model)
        step_ms = timed_ms(train_step)
        log(f"[20 resunet bf16 train step] {TRAIN_PATCH} batch 1: bf16 {step_ms:.2f} ms "
            f"({voxels / step_ms / 1e3:.3f} Mvoxel/s)")
        del model, optimizer
        torch.cuda.empty_cache()
    finally:
        os.environ.pop("P3DUNET_TAPFOLD", None)
    return launches


def recipe_phases(device, volume, batches):
    """Phases 21-23: the multiclass and denoising `_tpu` train configs in bf16
    with their device augmentation, then the multiclass prediction with its
    mean IoU. `volume` is phase 4's, `batches` phase 7's (train, val) pair.
    Returns the launches of each path by kernel and dtype."""
    from pytorch3dunet_tpu_torch.datasets.utils import SliceBuilder
    from pytorch3dunet_tpu_torch.metrics import PSNR, MeanIoU
    from pytorch3dunet_tpu_torch.models.unet import get_model
    from pytorch3dunet_tpu_torch.ops import augment
    from pytorch3dunet_tpu_torch.ops.conv3d import conv3d_fwd, conv3d_fwd_reference, conv3d_input_grad
    from pytorch3dunet_tpu_torch.ops.conv3d import conv3d_input_grad_reference
    from pytorch3dunet_tpu_torch.predictor import DeviceSlidingWindowPredictor, evaluate
    from pytorch3dunet_tpu_torch.utils.optim import create_optimizer

    launches = {}
    voxels = np.prod(TRAIN_PATCH)

    def timed_step(model, criterion, optimizer, x, y):
        def step():
            optimizer.zero_grad(set_to_none=True)
            criterion(model(x)[1], y).backward()
            optimizer.step()

        torch.cuda.reset_peak_memory_stats()
        ms = timed_ms(step)
        return ms, torch.cuda.max_memory_allocated() / 2**30, step

    # 21. multiclass_tpu: a class map of 3 classes from phase 7's Voronoi cells
    # and a standardized raw that shows it, through the config's device augmentation
    def multiclass_batch(batch, seed):
        classes = (batch[1][:, 1] % 3).astype(np.int64)
        raw = classes + 0.8 * np.random.RandomState(seed).randn(*classes.shape)
        return ((raw - raw.mean()) / raw.std())[:, None].astype(np.float32), classes

    (raw, classes), val_batch = (multiclass_batch(b, SEED + i) for i, b in enumerate(batches))
    spec = augment.split_device_transforms(copy.deepcopy(MULTICLASS_TPU["loaders"]))
    names = [e["raw"]["name"] for e in spec["paired"]]
    check(names == ["RandomFlip", "RandomRotate90", "RandomRotate", "ElasticDeformation"] and not spec["raw_only"]
          and spec["label_post"] is None and spec["paired"][3]["label"]["spline_order"] == 0,
          f"the multiclass _tpu spec is {spec}")
    config = {"manual_seed": SEED, "device": "cuda", **copy.deepcopy(MULTICLASS_TPU)}
    inp, tgt = torch.from_numpy(raw).to(device), torch.from_numpy(classes).to(device)
    n = plan_launches(config["model"], TRAIN_PATCH)
    # (a) one bf16 step on the fixed batch, no augmentation
    model, criterion = bf16_grads_vs_plain(config, inp, tgt, "multiclass_train_bf16", "21 multiclass train",
                                           launches)
    expect_launches(launches, "multiclass_train_bf16_step", k2=(0, n.k2), k3=(0, n.k3))
    with torch.no_grad():
        logits = model(inp)[1]
        ce, ce64 = criterion(logits, tgt).item(), criterion(logits.double(), tgt).item()
    ce_err = abs(ce - ce64) / abs(ce64)
    log(f"[21 multiclass train] the spec: paired {names}; CrossEntropyLoss on the bf16 step's f32 logits "
        f"{ce:.7f} against float64 {ce64:.7f}: relative {ce_err:.2e} (tol {CE_TOL})")
    check(logits.dtype == torch.float32 and ce_err <= CE_TOL, f"CE {ce} against float64 {ce64}")
    del logits
    # (b) the trainer's own fit: RECIPE_STEPS augmented steps and 1 validation
    twin_calls = []

    def record_twin(trainer):
        twin = trainer.device_metric
        check(type(trainer.eval_criterion) is MeanIoU and twin is not None, "the multiclass validation has no twin")
        trainer.device_metric = lambda probs, target: twin_calls.append((probs, target, twin(probs, target))) or \
            twin_calls[-1][2]
        trainer.mean_iou_twin = twin

    trainer = fit_with_augmentation(config, (raw, classes), val_batch, RECIPE_STEPS, RECIPE_STEPS,
                                    "multiclass_train_bf16_augmented", "21 multiclass train", launches,
                                    prepare=record_twin)
    expect_launches(launches, "multiclass_train_bf16_augmented", k2=(0, n.k2 * (RECIPE_STEPS + 1)),
                    k3=(0, n.k3 * RECIPE_STEPS), gn=(0, n.gn))
    check(len(twin_calls) == 1, f"the validation called the MeanIoU twin {len(twin_calls)} times")
    probs_v, target_v, twin_score = twin_calls[0]
    host_score = MeanIoU()(probs_v.cpu().numpy(), target_v.cpu().numpy())
    twin_err = abs(twin_score.item() - host_score)
    log(f"[21 multiclass train] validation: the MeanIoU twin {twin_score.item():.7f}, the host MeanIoU on the same "
        f"probabilities {host_score:.7f}: |d| {twin_err:.2e} (tol {TWIN_TOL}); best {trainer.best_eval_score:.5f}")
    check(twin_err <= TWIN_TOL, f"the MeanIoU twin differs from the host metric by {twin_err}")
    multiclass_state = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    # times: the step, the augmented step, one validation batch with the twin and with the host metric
    optimizer = create_optimizer(config["optimizer"], model)
    step_ms, peak_gib, step = timed_step(model, criterion, optimizer, inp, tgt)
    augmenter, gens = trainer.device_augmenter, trainer.augment_generators

    def augmented_step():
        x, y = augmenter(inp, tgt[:, None], gens)
        optimizer.zero_grad(set_to_none=True)
        criterion(model(x)[1], y[:, 0]).backward()
        optimizer.step()

    augmented_ms = timed_ms(augmented_step)
    eval_model, twin = trainer.model, trainer.mean_iou_twin
    x_val, y_val = (torch.from_numpy(a).to(device) for a in val_batch)

    def validation_batch(with_twin):
        def run():
            with torch.no_grad():
                probs, logits = eval_model(x_val)
                criterion(logits, y_val)
                return twin(probs, y_val) if with_twin else MeanIoU()(probs.cpu().numpy(), val_batch[1])

        return run

    eval_model.eval()
    twin_ms, host_ms = timed_ms(validation_batch(True)), timed_ms(validation_batch(False))
    eval_model.train()
    log(f"[21 multiclass train step] {TRAIN_PATCH} batch 1, CE, bf16: {step_ms:.2f} ms ({voxels / step_ms / 1e3:.3f} "
        f"Mvoxel/s), peak {peak_gib:.2f} GiB | with the device augmentation {augmented_ms:.2f} ms | one validation "
        f"batch: the MeanIoU twin {twin_ms:.2f} ms, the host MeanIoU (downloads 3 x {TRAIN_PATCH} f32) "
        f"{host_ms:.2f} ms")
    del step, model, optimizer, trainer, augmenter, eval_model, probs_v, target_v, twin_calls, inp, tgt, x_val, y_val
    torch.cuda.empty_cache()

    # 22. denoising_tpu: first its kernels at its forward and input-gradient shapes (22 and 22: at 128^3 its 4
    # decoders fuse)
    torch.manual_seed(SEED)
    shapes = path_conv_shapes(get_model(DENOISING_MODEL), DENOISING_PATCH)
    dgrads = dgrad_shapes(get_model(DENOISING_MODEL), DENOISING_PATCH)
    log(f"[22 denoising kernels] {len(shapes)} forward and {len(dgrads)} input-gradient shapes (kernel_conv_plan)")
    deepest = tuple(d // 2 ** (len(DENOISING_MODEL["f_maps"]) - 1) for d in DENOISING_PATCH)
    new = {"F = 8": [name for name, _, f in shapes if f == 8],
           f"256 channels at {deepest}": [name for name, shape, f in shapes if shape[1:4] == deepest and f == 256]
           + [f"dgrad {name}" for name, shape, _ in dgrads if shape[1:] == (*deepest, 256)],
           "dy with 8 channels": [f"dgrad {name}" for name, shape, _ in dgrads if shape[4] == 8]}
    log(f"[22 denoising kernels] the shapes no earlier phase ran: {new}")
    check(all(new.values()), f"the new shapes {new}")
    gen = torch.Generator(device=device).manual_seed(SEED + 22)
    errors_k2, failed = check_kernel("K2", conv3d_fwd, conv3d_fwd_reference,
                                     [(name, shape, f, True) for name, shape, f in shapes], gen, device, phase=22)
    check(not failed, f"K2 disagrees with the plain version at the denoising shapes: {failed}")
    errors_k3, failed = check_kernel("K3", lambda dy, w, _: conv3d_input_grad(dy, w.transpose(3, 4)),
                                     lambda dy, w, _: conv3d_input_grad_reference(dy, w.transpose(3, 4)),
                                     [(f"dgrad {name}", shape, c, False) for name, shape, c in dgrads], gen, device,
                                     phase=22)
    check(not failed, f"K3 disagrees with the plain version at the denoising dgrad shapes: {failed}")

    # then the step: a float target (the clean image) and its noisy raw, each
    # scaled to [-1, 1] as the config's Normalize does
    rs = np.random.RandomState(SEED + 22)
    zz, yy, xx = np.meshgrid(*(np.linspace(0, 4 * np.pi, s, dtype=np.float32) for s in DENOISING_PATCH), indexing="ij")
    clean = np.sin(zz) * np.cos(yy) + 0.5 * np.sin(xx + zz)

    def normalize(a):
        return (2 * (a - a.min()) / (a.max() - a.min()) - 1)[None, None].astype(np.float32)

    d_batch, d_val = ((normalize(clean + 0.3 * rs.randn(*clean.shape)), normalize(clean)) for _ in range(2))
    spec = augment.split_device_transforms(copy.deepcopy(DENOISING_TPU["loaders"]))
    names = [e["raw"]["name"] for e in spec["paired"]]
    # the label's Normalize is host engineering, so RandomRotate stays on the host (as in the JAX split)
    check(names == ["RandomFlip", "RandomRotate90"] and not spec["raw_only"] and spec["label_post"] is None,
          f"the denoising _tpu spec is {spec}")
    config = {"manual_seed": SEED, "device": "cuda", **copy.deepcopy(DENOISING_TPU)}
    inp, tgt = torch.from_numpy(d_batch[0]).to(device), torch.from_numpy(d_batch[1]).to(device)
    n = plan_launches(config["model"], DENOISING_PATCH)
    model, criterion = bf16_grads_vs_plain(config, inp, tgt, "denoising_train_bf16", "22 denoising train", launches)
    expect_launches(launches, "denoising_train_bf16_step", k2=(0, n.k2), k3=(0, n.k3))
    used = []

    def record_twin(trainer):
        twin = trainer.device_metric
        check(type(trainer.eval_criterion) is PSNR and twin is not None, "the denoising validation has no twin")
        trainer.device_metric = lambda probs, target: used.append(twin(probs, target)) or used[-1]

    trainer = fit_with_augmentation(config, d_batch, d_val, RECIPE_STEPS, RECIPE_STEPS,
                                    "denoising_train_bf16_augmented", "22 denoising train", launches,
                                    prepare=record_twin)
    expect_launches(launches, "denoising_train_bf16_augmented", k2=(0, n.k2 * (RECIPE_STEPS + 1)),
                    k3=(0, n.k3 * RECIPE_STEPS), gn=(0, n.gn))
    check(len(used) == 1 and math.isfinite(used[0].item()), f"the PSNR twin gave {used}")
    log(f"[22 denoising train] spec: paired {names} (RandomRotate stays on the host); validation PSNR twin "
        f"{used[0].item():.4f} dB")
    optimizer = create_optimizer(config["optimizer"], model)
    step_ms, peak_gib, step = timed_step(model, criterion, optimizer, inp, tgt)
    d_voxels = np.prod(DENOISING_PATCH)
    log(f"[22 denoising train step] {DENOISING_PATCH} batch 1, SmoothL1, bf16: {step_ms:.2f} ms "
        f"({d_voxels / step_ms / 1e3:.3f} Mvoxel/s), peak {peak_gib:.2f} GiB")
    profile_step(step, top=10, tag="22 profile", what="one bf16 denoising train step")
    del step, model, optimizer, trainer, inp, tgt
    torch.cuda.empty_cache()

    # 23. 3DUnet_multiclass/test_config.yaml in f32 with phase 21's weights: the
    # device sweep on phase 4's grid (global_normalization false: each patch
    # standardized), save_segmentation, mean IoU against a class map of the volume
    model = get_model(MULTICLASS_MODEL)
    model.load_state_dict(multiclass_state)
    model = model.to(device).eval()
    predictor = DeviceSlidingWindowPredictor(model, None, 3, device, save_segmentation=True,
                                             performance_metric="mean_iou", gt_internal_path="label")
    zz, yy, xx = np.meshgrid(*(np.linspace(0, 6 * np.pi, s, dtype=np.float32) for s in VOLUME), indexing="ij")
    gt = np.digitize(np.sin(zz) * np.cos(yy) * np.sin(xx), [-1 / 3, 1 / 3]).astype(np.uint16)
    del zz, yy, xx

    def sweep():
        return predictor.predict_array(volume, PATCH, STRIDE, HALO, normalize="standardize_patch", stats={})

    probs = count_launches(launches, "multiclass_device_sweep", sweep)
    n_patches = len(SliceBuilder._build_slices(np.broadcast_to(np.float32(0), VOLUME), PATCH, STRIDE))
    patch_in = tuple(p + 2 * h for p, h in zip(PATCH, HALO))
    n = plan_launches(model, patch_in)
    expect_launches(launches, "multiclass_device_sweep", k2=(n.k2 * n_patches, 0), gn=(n.gn * n_patches, 0))
    seg = predictor._to_segmentation(probs)
    check(probs.shape == (3, *VOLUME) and np.isfinite(probs).all(), f"multiclass probabilities {probs.shape}")
    check(np.array_equal(seg, torch.from_numpy(probs).argmax(0).numpy()), "segmentation != argmax of the sweep")
    start = time.perf_counter()
    ious = evaluate(seg, gt, predictor.performance_metric, predictor.out_channels)
    eval_s = time.perf_counter() - start
    want = [np.count_nonzero((seg == c) & (gt == c)) / np.count_nonzero((seg == c) | (gt == c)) for c in (1, 2)]
    sweep_ms = timed_ms(sweep, runs=SWEEP_RUNS)
    log(f"[23 multiclass predict] f32 sweep of {VOLUME}, {n_patches} patches: launches "
        f"{launches['multiclass_device_sweep']}; classes {np.bincount(seg.ravel(), minlength=3).tolist()}; "
        f"mean_iou per class {[float(v) for v in ious]} (numpy in this script {want}); the sweep {sweep_ms:.2f} ms, "
        f"the evaluation {1e3 * eval_s:.2f} ms")
    check(np.allclose(ious, want, rtol=0, atol=0), f"mean_iou {ious} against {want}")
    del model, predictor, probs, seg
    torch.cuda.empty_cache()
    return launches


def grads_of_step(model, criterion, inp, target, dtype=torch.float32):
    """Parameter gradients of one loss step of `model` on (inp, target), float64."""
    model.zero_grad(set_to_none=True)
    criterion(model(inp.to(dtype))[1], target.to(dtype)).backward()
    return {name: p.grad.detach().double() for name, p in model.named_parameters()}


def worst_rel(grads, reference):
    """(max |g - ref| / max |ref|, tensor name) over the tensors."""
    return max(((g - reference[k]).abs().max().item() / max(reference[k].abs().max().item(), 1e-30), k)
               for k, g in grads.items())


def voronoi_planes(rs, planes, hw, cells=60):
    """(raw (N, 1, 1, H, W), target (N, 2, 1, H, W)) of `planes` depth-1
    patches as the 2D confocal recipe feeds them: each plane a slice of
    3D Voronoi cells (~`cells` a plane), its boundary where the 3x3
    neighbourhood in the plane holds another label, the label appended, and a
    standardized raw of the boundary plus noise."""
    from scipy import ndimage
    from scipy.spatial import cKDTree

    shape = (planes, *hw)
    seeds = rs.rand(cells * planes, 3) * np.array([planes, *hw], dtype=np.float64)
    grid = np.stack(np.meshgrid(*(np.arange(s, dtype=np.float32) for s in shape), indexing="ij"), -1)
    label = cKDTree(seeds).query(grid.reshape(-1, 3), workers=-1)[1].reshape(shape).astype(np.float32) + 1
    del grid
    footprint = np.ones((1, 3, 3), dtype=bool)
    boundary = (ndimage.maximum_filter(label, footprint=footprint, mode="nearest")
                != ndimage.minimum_filter(label, footprint=footprint, mode="nearest")).astype(np.float32)
    raw = boundary + 0.5 * rs.randn(*shape).astype(np.float32)
    raw = (raw - raw.mean()) / raw.std()
    return raw[:, None, None].astype(np.float32), np.stack([boundary, label], axis=1)[:, :, None]


def blob_images(rs, n, hw, blobs=25):
    """(raw (n, 1, 1, H, W), label (n, H, W)) of DSB2018-like images: discs of
    radius 4-12 with ids 1..blobs on noise, the raw standardized per image."""
    yy, xx = np.mgrid[: hw[0], : hw[1]]
    labels = np.zeros((n, *hw), dtype=np.int64)
    for i in range(n):
        for j in range(1, blobs + 1):
            cy, cx, r = rs.randint(0, hw[0]), rs.randint(0, hw[1]), rs.randint(4, 13)
            labels[i][(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = j
    raw = (labels > 0) + 0.6 * rs.randn(n, *hw)
    raw = (raw - raw.mean((1, 2), keepdims=True)) / raw.std((1, 2), keepdims=True)
    return raw[:, None, None].astype(np.float32), labels


def two_d_phases(device, smi):
    """Phases 24-26: the 2D confocal configs (train at batch 32 of 1 x 515 x
    512, predict a 64 x 1024 x 1024 stack) and the DSB2018 configs (train,
    per-image prediction) at full width. No 2D path runs a hand kernel: the
    JAX package computes 2D convs outside Pallas, so here they are cuDNN's.
    Returns the launches of each path by kernel and dtype."""
    from scipy import ndimage

    from pytorch3dunet_tpu_torch.augment.transforms import BlobsToMask, Relabel
    from pytorch3dunet_tpu_torch.datasets.utils import calculate_stats, mirror_pad
    from pytorch3dunet_tpu_torch.models.unet import get_model, is_model_2d
    from pytorch3dunet_tpu_torch.predictor import (DeviceSlidingWindowPredictor, DSB2018Predictor,
                                                   StandardPredictor, pmaps_to_segmentation)
    from pytorch3dunet_tpu_torch.trainer import create_trainer

    launches = {}
    gen_cpu = torch.Generator().manual_seed(SEED + 24)

    def fit(config, train, val, path, tag):
        """create_trainer on in-memory batches: 4 steps and 1 validation; the
        losses, the fit's time, its peak memory, 0 launches of every kernel."""
        with tempfile.TemporaryDirectory() as checkpoint_dir:
            config = {**config, "trainer": {**config["trainer"], "checkpoint_dir": checkpoint_dir}}
            trainer = create_trainer(config, loaders={"train": [train], "val": [val]})
            criterion, losses = trainer.loss_criterion, []

            def recording(logits, target):
                loss = criterion(logits, target)
                if torch.is_grad_enabled():
                    losses.append(loss.item())
                return loss

            trainer.loss_criterion = recording
            torch.cuda.reset_peak_memory_stats()
            start = time.perf_counter()
            count_launches(launches, path, trainer.fit)
            fit_s = time.perf_counter() - start
            trainer.loss_criterion = criterion
            check(Path(checkpoint_dir, "last_checkpoint.pytorch").exists(), f"{path}: no checkpoint written")
        # the steps need gradients; the validation's forward takes the GroupNorm kernel (none in bcr)
        expect_launches(launches, path, gn=(plan_launches(config["model"], val[0].shape[-2:]).gn, 0))
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[{tag}] create_trainer fit: 4 steps of {train[0].shape} + 1 validation in {fit_s:.2f} s, peak "
            f"{peak:.2f} GiB; losses {', '.join(f'{v:.5f}' for v in losses)}; best {trainer.best_eval_score:.5f}; "
            f"launches {launches[path]} (no conv kernel on a 2D path)")
        check(len(losses) == 4 and all(math.isfinite(v) for v in losses), f"{path}: losses {losses}")
        return trainer, criterion

    def trainer_config(model, sections, higher_is_better):
        return {"manual_seed": SEED, "device": str(device), "model": dict(model), **copy.deepcopy(sections),
                "trainer": {"eval_score_higher_is_better": higher_is_better, "validate_after_iters": 4,
                            "log_after_iters": 10**9, "max_num_epochs": 10**9, "max_num_iterations": 3}}

    # 24. the 2D confocal train config: batch 32 of 1 x 515 x 512
    rs = np.random.RandomState(SEED + 24)
    start = time.perf_counter()
    train, val = (voronoi_planes(rs, BATCH_2D, PATCH_2D[1:]) for _ in range(2))
    log(f"[24 train 2D] two synthetic batches (raw {train[0].shape}, target {train[1].shape}) in "
        f"{time.perf_counter() - start:.1f} s; the reckoned peak: ~0.75 GB of saved activations an image, "
        f"24-35 GiB at batch {BATCH_2D}")
    trainer, criterion = fit(trainer_config(MODEL_2D, TRAIN_SECTIONS, False), train, val, "unet2d_train",
                             "24 train 2D")
    model = trainer.model
    check(is_model_2d(model), "the 2D config built a 3D model")
    inp, tgt = trainer._prepare_batch(*train)
    check(inp.shape == (BATCH_2D, 1, *PATCH_2D[1:]) and tgt.shape == (BATCH_2D, 2, *PATCH_2D[1:]),
          f"the 2D batch on the card is {tuple(inp.shape)}, {tuple(tgt.shape)}")
    # the gradient gate: cuDNN's f32 step against float64 on 4 of the patches,
    # deterministic algorithms, random GroupNorm affines (as phase 7)
    randomize_group_norms(model, gen_cpu)
    torch.backends.cudnn.deterministic = True
    try:
        x4, y4 = inp[:GRAD64_PATCHES_2D], tgt[:GRAD64_PATCHES_2D]
        grads = grads_of_step(model, criterion, x4, y4)
        grads64 = grads_of_step(copy.deepcopy(model).double(), criterion, x4, y4, torch.float64)
    finally:
        torch.backends.cudnn.deterministic = False
    # no hand kernel runs here: the f32 step is cuDNN's own, which sat 7.8e-4
    # and 1.1e-3 of a deep conv's own max|g| from float64 in two processes on
    # the card, so each tensor is held to GRAD_TOL of the step's largest
    # gradient and to VS_PLAIN_CAP of its own
    g_max = max(g.abs().max().item() for g in grads64.values())
    worst = max(((g - grads64[k]).abs().max().item() / g_max, k) for k, g in grads.items())
    worst_own = worst_rel(grads, grads64)
    log(f"[24 train 2D] one step's parameter grads on {GRAD64_PATCHES_2D} patches against a float64 step, worst over "
        f"{len(grads)} tensors: max|d| / the step's max|g| {worst[0]:.3e} ({worst[1]}, tol {GRAD_TOL}); max|d| / "
        f"the tensor's own max|g| {worst_own[0]:.3e} ({worst_own[1]}, cap {VS_PLAIN_CAP})")
    check(worst[0] <= GRAD_TOL and worst_own[0] <= VS_PLAIN_CAP,
          f"the 2D step's grads differ from float64: {worst}, {worst_own}")
    del grads, grads64
    optimizer = trainer.optimizer

    def step():
        optimizer.zero_grad(set_to_none=True)
        criterion(model(inp)[1], tgt).backward()
        optimizer.step()

    torch.cuda.reset_peak_memory_stats()
    step_ms = count_launches(launches, "unet2d_train_step", lambda: timed_ms(step))
    expect_launches(launches, "unet2d_train_step")
    peak = torch.cuda.max_memory_allocated() / 2**30
    pixels = BATCH_2D * np.prod(PATCH_2D)
    log(f"[24 train 2D step] batch {BATCH_2D} x {PATCH_2D}, BCEDice, Adam, f32 (TF32 off): {step_ms:.2f} ms "
        f"({pixels / step_ms / 1e3:.3f} Mpixel/s), peak {peak:.2f} GiB ({smi})")
    profile_step(step, top=10, tag="24 profile", what="one 2D confocal train step")
    state_2d = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del trainer, model, optimizer, inp, tgt, train, val, step
    torch.cuda.empty_cache()

    # 25. the 2D confocal test config on a 64 x 1024 x 1024 stack
    model = get_model(MODEL_2D)
    model.load_state_dict(state_2d)
    model = model.to(device).eval()
    zz, yy, xx = (np.linspace(0, 6 * np.pi, s, dtype=np.float32) for s in VOLUME_2D)
    volume = (np.sin(zz)[:, None, None] * np.cos(yy)[None, :, None] * np.sin(xx)[None, None, :]
              + 0.5 * rs.rand(*VOLUME_2D).astype(np.float32)).astype(np.float32)
    stats = {"mean": float(volume.mean()), "std": float(volume.std())}
    grid = DeviceSlidingWindowPredictor(model, None, 1, device)
    patch, halo = PATCH_2D_TEST, HALO_2D

    def grid_sweep():
        return grid.predict_array(volume, patch, patch, halo, normalize="standardize", stats=stats)

    out = count_launches(launches, "unet2d_device_sweep", grid_sweep)
    # 16 tiles a forward, each halo'd
    tile = tuple(p + 2 * h for p, h in zip(patch[1:], halo[1:]))
    n_tiles = VOLUME_2D[0] * math.prod(v // p for v, p in zip(VOLUME_2D[1:], patch[1:]))
    expect_launches(launches, "unet2d_device_sweep", gn=(plan_launches(model, tile).gn * n_tiles // 16, 0))
    (sweep_obj,) = grid._sweeps.values()
    check(sweep_obj.patch_batch == 16 and out.shape == (1, *VOLUME_2D) and np.isfinite(out).all(),
          f"2D sweep: patch_batch {sweep_obj.patch_batch}, output {out.shape}")
    head = volume[:16]
    head_stats = calculate_stats(head)
    host = StandardPredictor(model, None, 1, device).predict_array(head, patch, patch, halo, TRANSFORMER)
    dev = grid.predict_array(head, patch, patch, halo, normalize="standardize", stats=head_stats)
    err_host = np.abs(dev - host).max()
    log(f"[25 predict 2D] the grid sweep of {VOLUME_2D} ({VOLUME_2D[0] * 4} patches of {patch}, halo {halo}, 16 a "
        f"forward): launches {launches['unet2d_device_sweep']}; on the first 16 planes against the host loop "
        f"max|d| {err_host:.3e} (tol {SWEEP_2D_TOL})")
    check(err_host <= SWEEP_2D_TOL, f"the 2D device sweep differs from the host loop by {err_host}")
    slab = DeviceSlidingWindowPredictor(model, None, 1, device, patch_mode="slab", max_patch_voxels=SLAB_BUDGET_2D)

    def slab_sweep():
        return slab.predict_array(volume, patch, patch, halo, normalize="standardize", stats=stats)

    out_slab = count_launches(launches, "unet2d_device_sweep_slab", slab_sweep)
    # whole halo'd planes, _planned_patch_batch a forward
    plane_in = tuple(v + 2 * h for v, h in zip(VOLUME_2D[1:], halo[1:]))
    slab_forwards = -(-VOLUME_2D[0] // slab._planned_patch_batch)
    expect_launches(launches, "unet2d_device_sweep_slab", gn=(plan_launches(model, plane_in).gn * slab_forwards, 0))
    check(slab._planned_patch_batch == min(24, VOLUME_2D[0]) and np.isfinite(out_slab).all(),
          f"the 2D slab plan took {slab._planned_patch_batch} planes a forward")
    plane = mirror_pad(((volume[:1] - stats["mean"]) / stats["std"]).astype(np.float32), halo)
    with torch.inference_mode():
        direct = model(torch.from_numpy(plane[None]).to(device))[0][0, 0, halo[1]:-halo[1], halo[2]:-halo[2]]
    err_slab = np.abs(out_slab[0, 0] - direct.cpu().numpy()).max()
    seams = np.abs(out_slab - out)
    log(f"[25 predict 2D] slab: whole {VOLUME_2D[1]}x{VOLUME_2D[2]} planes, {slab._planned_patch_batch} a forward; "
        f"plane 0 against its own "
        f"forward max|d| {err_slab:.3e} (tol {SWEEP_2D_TOL}); against the grid's cores (tile borders and GroupNorm "
        f"over the whole plane instead of a tile) max|d| {seams.max():.3e}, mean {seams.mean():.3e}")
    check(err_slab <= SWEEP_2D_TOL, f"a slab plane differs from its own forward by {err_slab}")
    torch.cuda.reset_peak_memory_stats()
    grid_ms = timed_ms(grid_sweep, runs=SWEEP_RUNS)
    grid_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    slab_ms = timed_ms(slab_sweep, runs=SWEEP_RUNS)
    slab_peak = torch.cuda.max_memory_allocated() / 2**30
    host_ms = timed_ms(lambda: StandardPredictor(model, None, 1, device).predict_array(head, patch, patch, halo,
                                                                                          TRANSFORMER), runs=1)
    voxels = np.prod(VOLUME_2D)
    log(f"[25 predict 2D] {VOLUME_2D} f32: grid sweep {grid_ms:.2f} ms ({voxels / grid_ms / 1e3:.2f} Mvoxel/s, peak "
        f"{grid_peak:.2f} GiB) | slab sweep {slab_ms:.2f} ms ({voxels / slab_ms / 1e3:.2f} Mvoxel/s, peak "
        f"{slab_peak:.2f} GiB) | the host loop on 16 planes {host_ms:.2f} ms "
        f"({np.prod(head.shape) / host_ms / 1e3:.2f} Mvoxel/s) ({smi})")
    profile_step(grid_sweep, top=8, tag="25 profile", what="one 2D grid sweep")
    del grid, slab, out, out_slab, host, dev, sweep_obj, direct
    torch.cuda.empty_cache()
    res_model = get_model({**MODEL_2D, "name": "ResidualUNet2D"})
    check(len(res_model.encoders) == 5 and not res_model.decoders[0].concat
          and res_model.decoders[0].upsampling is not None, "ResidualUNet2D: 5 levels, deconv and sum joins")
    randomize_group_norms(res_model, gen_cpu)
    res_model = res_model.to(device).eval()
    tiles = torch.randn(16, 1, *(p + 2 * h for p, h in zip(patch[1:], halo[1:])), generator=gen_cpu).to(device)

    def res_forward():
        with torch.inference_mode():
            return res_model(tiles)[0]

    probs = count_launches(launches, "resunet2d_forward", res_forward)
    expect_launches(launches, "resunet2d_forward", gn=(plan_launches(res_model, tiles.shape[2:]).gn, 0))
    check(probs.shape == (16, 1, *tiles.shape[2:]) and torch.isfinite(probs).all().item(),
          f"ResidualUNet2D output {tuple(probs.shape)}")
    res_ms = timed_ms(res_forward)
    log(f"[25 predict 2D] ResidualUNet2D (5 levels, deconv, sum joins) forward of 16 tiles of {tuple(tiles.shape[2:])}: "
        f"{res_ms:.2f} ms ({tiles.numel() / res_ms / 1e3:.2f} Mpixel/s), probs in [{probs.min().item():.4f}, "
        f"{probs.max().item():.4f}] ({smi})")
    del res_model, tiles, probs, model, volume
    torch.cuda.empty_cache()

    # 26. DSB2018: train at batch 32 of 256 x 256 crops, then predict 8 images
    rs = np.random.RandomState(SEED + 26)

    def dsb_batch():
        raw, labels = blob_images(rs, DSB_BATCH, DSB_CROP)
        relabel, to_mask = Relabel(), BlobsToMask(append_label=True)
        target = np.stack([to_mask(relabel(label[None])) for label in labels]).astype(np.float32)
        return raw, target

    train, val = dsb_batch(), dsb_batch()
    config = trainer_config(DSB_MODEL, DSB_SECTIONS, True)
    torch.manual_seed(SEED)
    initial = {k: v.clone() for k, v in get_model(DSB_MODEL).state_dict().items()}
    trainer, criterion = fit(config, train, val, "dsb_train", "26 DSB train")
    model = trainer.model
    # each BatchNorm's running statistics move (the mean of the first, over the
    # per-image standardized raw, may stay 0)
    state = model.state_dict()
    norms = [k[: -len(".running_var")] for k in initial if k.endswith("running_var")]
    moved = [n for n in norms if any(not torch.equal(state[f"{n}.{s}"].cpu(), initial[f"{n}.{s}"])
                                     for s in ("running_mean", "running_var"))]
    check(len(norms) == 10 and moved == norms, f"BatchNorm statistics moved in {len(moved)} of {len(norms)}")
    inp, tgt = trainer._prepare_batch(*train)
    optimizer = trainer.optimizer

    def dsb_step():
        optimizer.zero_grad(set_to_none=True)
        criterion(model(inp)[1], tgt).backward()
        optimizer.step()

    torch.cuda.reset_peak_memory_stats()
    dsb_ms = timed_ms(dsb_step)
    log(f"[26 DSB train] the running statistics of all {len(norms)} BatchNorms moved; step at batch "
        f"{DSB_BATCH} x {DSB_CROP}, bcr, f32: {dsb_ms:.2f} ms ({DSB_BATCH * np.prod(DSB_CROP) / dsb_ms / 1e3:.3f} "
        f"Mpixel/s), peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi})")
    model.eval()
    padded, plain = DSB2018Predictor(model, None, 1, device, pad_to_multiple=DSB_PAD), DSB2018Predictor(
        model, None, 1, device)
    images = [blob_images(rs, 1, size)[0] for size in DSB_SIZES]
    results = count_launches(launches, "dsb_predict", lambda: [padded.predict_image(img) for img in images])
    # bcr: BatchNorm, no GroupNorm
    expect_launches(launches, "dsb_predict")
    worst_pad, rows = 0.0, []
    for img, probs in zip(images, results):
        h, w = img.shape[-2:]
        check(probs.shape == (1, 1, 1, h, w) and np.isfinite(probs).all(), f"DSB probabilities {probs.shape}")
        inner = (slice(None), slice(None), slice(None), slice(0, h - DSB_MARGIN if h % DSB_PAD else h),
                 slice(0, w - DSB_MARGIN if w % DSB_PAD else w))
        err = np.abs(probs - plain.predict_image(img))[inner].max()
        worst_pad = max(worst_pad, err)
        seg = pmaps_to_segmentation(probs[0, 0, 0])
        ref, n_ref = ndimage.label(probs[0, 0, 0] > 0.5, structure=np.ones((3, 3)))
        same = (int(seg.max()) == n_ref and np.array_equal(seg > 0, ref > 0)
                and len(np.unique(np.stack([seg[ref > 0], ref[ref > 0]]), axis=1).T) == n_ref)
        check(same, f"the segmentation of a {h}x{w} image is not the components of its thresholded probabilities")
        ms = timed_ms(lambda: padded.predict_image(img), runs=2)
        rows.append(f"{h}x{w}: {ms:.2f} ms, {n_ref} components")
    log(f"[26 DSB predict] {len(images)} images, pad_to_multiple {DSB_PAD}: padded against unpadded forward beyond "
        f"{DSB_MARGIN} px of the padded edges max|d| {worst_pad:.3e} (tol {DSB_PAD_TOL}); segmentations = scipy's "
        f"8-connected components of probs > 0.5; launches {launches['dsb_predict']}; per image "
        f"{' | '.join(rows[:len(DSB_SIZES) // 2])} ({smi})")
    check(worst_pad <= DSB_PAD_TOL, f"the padded DSB forward differs from the unpadded one by {worst_pad}")
    del trainer, model, optimizer, inp, tgt, padded, plain, results
    torch.cuda.empty_cache()
    return launches


def options_phase(device, batch, smi):
    """Phase 27: the 3D model options at the confocal width on phase 7's
    80 x 170 x 170 batch: upsample trilinear and deconv (DoubleConv, concat
    joins) and conv_upscale 1 keep every conv 3x3x3 pad 1, so each forward
    runs 14 K2 and is held to the plain conv; conv_kernel_size [1, 3, 3] runs
    no hand kernel; one f32 step with trilinear upsampling runs 14 K2 and 14
    K3 and is held to a float64 step as phase 7's. Returns the launches of
    each path by kernel and dtype."""
    from pytorch3dunet_tpu_torch.losses import get_loss_criterion
    from pytorch3dunet_tpu_torch.models.unet import get_model
    from pytorch3dunet_tpu_torch.ops.conv3d import plain_conv

    launches = {}
    gen_cpu = torch.Generator().manual_seed(SEED + 27)
    inp = torch.from_numpy(batch[0]).to(device)
    target = torch.from_numpy(batch[1]).to(device)
    rows = []
    for key, options in {**OPTIONS_3D, "anisotropic": ANISOTROPIC_3D}.items():
        torch.manual_seed(SEED)
        model = get_model({**MODEL, **options})
        randomize_group_norms(model, gen_cpu)
        model = model.to(device).eval()
        on_kernels = sum(m.on_kernels for m in model.modules() if hasattr(m, "on_kernels"))

        def forward():
            with torch.inference_mode():
                return model(inp)[0]

        path = f"options_{key}_forward"
        probs = count_launches(launches, path, forward)
        n = plan_launches(model, TRAIN_PATCH)
        expect_launches(launches, path, k2=(n.k2, 0), gn=(n.gn, 0))
        check(on_kernels == (14 if key != "anisotropic" else 0) and torch.isfinite(probs).all().item(),
              f"{key}: {on_kernels} conv layers on the kernels")
        with plain_conv():
            plain = forward()
            plain_ms = timed_ms(forward)
        err = (probs - plain).abs().max().item()
        ms = timed_ms(forward)
        rows.append(f"{key} {ms:.2f} ms (plain {plain_ms:.2f}, max|d| {err:.2e})")
        check(err <= FORWARD_TOL, f"{key}: the kernels' forward differs from the plain conv's by {err}")
        del model, probs, plain
    log(f"[27 options] forwards of {TRAIN_PATCH}, f_maps {MODEL['f_maps']}, 4 levels: {' | '.join(rows)} "
        f"(tol {FORWARD_TOL}); "
        f"launches {', '.join(f'{k}: {v}' for k, v in launches.items())} ({smi})")

    torch.manual_seed(SEED)
    model = get_model({**MODEL, **OPTIONS_3D["trilinear"]})
    randomize_group_norms(model, gen_cpu)
    model = model.to(device).train()
    criterion = get_loss_criterion({"loss": dict(TRAIN_SECTIONS["loss"])})
    # phase 13's gate: on this model's level-2 convs the plain f32 step itself
    # sits 4.6e-3 of max|g| from float64 (first run on the card), past phase
    # 7's 1e-3, so each tensor's kernel error is held to twice the plain
    # step's own + RES_GRAD_TOL, on cuDNN's deterministic algorithms
    torch.backends.cudnn.deterministic = True
    try:
        grads = count_launches(launches, "options_trilinear_step", lambda: grads_of_step(model, criterion, inp,
                                                                                         target))
        with plain_conv():
            grads_plain = grads_of_step(model, criterion, inp, target)
            grads64 = grads_of_step(copy.deepcopy(model).double(), criterion, inp, target, torch.float64)
    finally:
        torch.backends.cudnn.deterministic = False
    n = plan_launches(model, TRAIN_PATCH)
    expect_launches(launches, "options_trilinear_step", k2=(n.k2, 0), k3=(n.k3, 0))
    err_k, err_p = ({k: worst_rel({k: g[k]}, grads64)[0] for k in g} for g in (grads, grads_plain))
    vs_plain = worst_rel(grads, grads_plain)
    margin = min((2 * err_p[k] + RES_GRAD_TOL - err_k[k], k) for k in grads)
    log(f"[27 options] trilinear: one f32 step, launches {launches['options_trilinear_step']}; grads against a "
        f"float64 plain step, worst over {len(grads)} tensors: kernels {max(err_k.values()):.3e} "
        f"({max(err_k, key=err_k.get)}), plain f32 {max(err_p.values()):.3e} ({max(err_p, key=err_p.get)}); least "
        f"margin to 2 x plain + {RES_GRAD_TOL}: {margin[0]:.3e} ({margin[1]}); kernels vs plain f32 "
        f"{vs_plain[0]:.3e} (cap {VS_PLAIN_CAP})")
    check(margin[0] >= 0, f"the trilinear step's grads: kernels {err_k[margin[1]]} vs plain f32 {err_p[margin[1]]} "
                          f"from float64 at {margin[1]}")
    check(vs_plain[0] <= VS_PLAIN_CAP, f"the trilinear step's grads differ from the plain f32 step: {vs_plain}")
    del model, grads, grads_plain, grads64, inp, target
    torch.cuda.empty_cache()
    return launches


def breadth_phase(device, batches, smi):
    """Phase 28: the trainer's breadth on the confocal UNet3D at full width on
    phase 7's 80 x 170 x 170 batches: (a) remat against the plain step, f32
    and bf16; (b) a 2-microbatch accumulated update against the batch-2 step;
    (c) the confocal `_tpu` train config with `ema_decay`, `grad_accum_steps`
    and `resume: auto` on, stopped after 4 updates and resumed for 2, against
    an uninterrupted run of 6; (d) the async checkpoint. Returns the launches
    of each path by kernel and dtype."""
    from pytorch3dunet_tpu_torch.losses import get_loss_criterion
    from pytorch3dunet_tpu_torch.models.unet import get_model
    from pytorch3dunet_tpu_torch.trainer import create_trainer
    from pytorch3dunet_tpu_torch.utils.checkpoint import load_checkpoint
    from pytorch3dunet_tpu_torch.utils.misc import RunningAverage
    from pytorch3dunet_tpu_torch.utils.optim import create_optimizer

    launches = {}
    n = plan_launches(MODEL, TRAIN_PATCH)
    (raw, target), val_batch = batches
    inp, tgt = torch.from_numpy(raw).to(device), torch.from_numpy(target).to(device)

    # (a) remat: one f32 step's grads with and without it, on cuDNN's
    # deterministic algorithms; then each variant's step time and peak
    # memory, f32 and bf16
    torch.manual_seed(SEED)
    base = get_model(dict(MODEL))
    randomize_group_norms(base, torch.Generator().manual_seed(SEED + 28))
    criterion = get_loss_criterion({"loss": dict(TRAIN_SECTIONS["loss"])})
    models = {}
    for remat in (False, True):
        models[remat] = get_model({**MODEL, "remat": remat})
        models[remat].load_state_dict(base.state_dict())
        models[remat] = models[remat].to(device).train()
    torch.backends.cudnn.deterministic = True
    try:
        grads = {remat: count_launches(launches, f"breadth_remat_{remat}_step",
                                       lambda: grads_of_step(models[remat], criterion, inp, tgt))
                 for remat in (False, True)}
    finally:
        torch.backends.cudnn.deterministic = False
    expect_launches(launches, "breadth_remat_False_step", k2=(n.k2, 0), k3=(n.k3, 0))
    # remat recomputes every level in backward: each conv's forward runs twice
    expect_launches(launches, "breadth_remat_True_step", k2=(2 * n.k2, 0), k3=(n.k3, 0))
    gap = worst_rel(grads[True], grads[False])
    log(f"[28 remat] one f32 step of {TRAIN_PATCH}: launches {launches['breadth_remat_True_step']} with remat, "
        f"{launches['breadth_remat_False_step']} without; grads with remat against without, worst over "
        f"{len(grads[True])} tensors {gap[0]:.3e} ({gap[1]}; tol {REMAT_TOL})")
    check(gap[0] <= REMAT_TOL, f"remat changes the step's grads: {gap}")
    del grads
    rows = []
    for dtype in (None, torch.bfloat16):
        for remat in (False, True):
            model = models[remat]
            model.compute_dtype = dtype
            optimizer = create_optimizer(TRAIN_SECTIONS["optimizer"], model)

            def step():
                optimizer.zero_grad(set_to_none=True)
                criterion(model(inp)[1], tgt).backward()
                optimizer.step()

            if dtype is not None:
                path = f"breadth_remat_{remat}_bf16_step"
                count_launches(launches, path, step)
                expect_launches(launches, path, k2=(0, (1 + remat) * n.k2), k3=(0, n.k3))
            torch.cuda.reset_peak_memory_stats()
            ms = timed_ms(step)
            peak = torch.cuda.max_memory_allocated() / 2**30
            rows.append(f"{'bf16' if dtype else 'f32'} remat {remat}: {ms:.2f} ms, peak {peak:.2f} GiB")
            del optimizer
    log(f"[28 remat] train step (forward + backward + Adam) of {TRAIN_PATCH}, batch 1: {' | '.join(rows)} ({smi})")
    del models, base
    torch.cuda.empty_cache()

    # (b) accumulation: 2 batch-1 microbatches against their batch-2 stack,
    # with BCEWithLogitsLoss (a per-voxel mean: the batch-2 loss is the mean of
    # the two; BCEDiceLoss pools the batch), SGD
    second = synthetic_batch(np.random.RandomState(SEED + 28))
    stacked = tuple(np.concatenate(pair) for pair in zip((raw, target), second))
    results = {}
    with tempfile.TemporaryDirectory() as checkpoint_dir:
        for name, train in (("accum", [(raw, target), second]), ("batch2", [stacked])):
            config = {"manual_seed": SEED, "device": "cuda", "model": dict(MODEL), **TRAIN_SECTIONS,
                      "loss": {"name": "BCEWithLogitsLoss", "skip_last_target": True},
                      "optimizer": {"name": "SGD", "learning_rate": 0.05},
                      "trainer": {"checkpoint_dir": checkpoint_dir, "grad_accum_steps": len(train),
                                  "eval_score_higher_is_better": False, "validate_after_iters": 10**9,
                                  "log_after_iters": 10**9, "max_num_epochs": 1, "max_num_iterations": 10}}
            trainer = create_trainer(config, loaders={"train": train, "val": []})
            torch.backends.cudnn.deterministic = True
            try:
                count_launches(launches, f"breadth_{name}_update",
                               lambda: trainer._update(tuple(train), RunningAverage()))
            finally:
                torch.backends.cudnn.deterministic = False
            results[name] = ({n: p.grad.detach().double() for n, p in trainer.model.named_parameters()},
                             {n: p.detach().double() for n, p in trainer.model.named_parameters()})
            del trainer
    expect_launches(launches, "breadth_accum_update", k2=(2 * n.k2, 0), k3=(2 * n.k3, 0))
    expect_launches(launches, "breadth_batch2_update", k2=(n.k2, 0), k3=(n.k3, 0))
    (accum_grads, accum_params), (batch2_grads, batch2_params) = results["accum"], results["batch2"]
    # relative to the step's max |g|: the first GroupNorm's weight gradient is
    # ~1e-3 of it (ROADMAP Queue 3, small gradients), where another summation
    # order shows as a large share of that tensor's own max
    g_max = max(g.abs().max().item() for g in batch2_grads.values())
    grad_gap = max(((accum_grads[k] - g).abs().max().item() / g_max, k) for k, g in batch2_grads.items())
    per_tensor = worst_rel(accum_grads, batch2_grads)
    param_gap = max((accum_params[k] - v).abs().max().item() for k, v in batch2_params.items())
    param_tol = ACCUM_TOL * 0.05 * g_max
    log(f"[28 accumulation] grad_accum_steps 2 over two batch-1 batches against one batch-2 step: launches "
        f"{launches['breadth_accum_update']} against {launches['breadth_batch2_update']}; mean grads worst "
        f"{grad_gap[0]:.3e} of the step's max|g| ({grad_gap[1]}; tol {ACCUM_TOL}), of the tensor's own "
        f"{per_tensor[0]:.3e} ({per_tensor[1]}); parameters after the SGD update max|d| {param_gap:.3e} "
        f"(tol {param_tol:.3e}: lr x {ACCUM_TOL} x max|g|)")
    check(grad_gap[0] <= ACCUM_TOL, f"the accumulated update's grads differ from the batch-2 step's: {grad_gap}")
    check(param_gap <= param_tol, f"the accumulated update's parameters differ from the batch-2 step's: {param_gap}")
    del results, accum_grads, accum_params, batch2_grads, batch2_params

    # (c) the confocal _tpu train config with its commented lines on, bf16
    # with device augmentation: 4 updates and a validation, then a new trainer
    # on the same config resumes (auto) for 2, against 6 uninterrupted updates;
    # each epoch is one update of the 2 host batches
    host = [(raw, np.ascontiguousarray(target[:, 1:])), (second[0], np.ascontiguousarray(second[1][:, 1:]))]

    def run(checkpoint_dir, last_iteration, path, spy=None):
        config = {"manual_seed": SEED, "device": "cuda", "model": {**MODEL, "dtype": "bfloat16"}, **TRAIN_SECTIONS,
                  "loaders": copy.deepcopy(TPU_LOADERS),
                  "trainer": {**BREADTH_TRAINER, "checkpoint_dir": checkpoint_dir,
                              "eval_score_higher_is_better": False, "validate_after_iters": 4,
                              "log_after_iters": 10**9, "max_num_epochs": 10**9,
                              "max_num_iterations": last_iteration - 1}}
        trainer = create_trainer(config, loaders={"train": host, "val": [val_batch]})
        losses, criterion = [], trainer.loss_criterion

        def recording(logits, target):
            loss = criterion(logits, target)
            if torch.is_grad_enabled():
                losses.append(loss.item())
            return loss

        trainer.loss_criterion = recording
        if spy is not None:
            spy(trainer)
        start = time.perf_counter()
        count_launches(launches, path, trainer.fit)
        trainer.loss_criterion = criterion
        return trainer, losses, time.perf_counter() - start

    params_seen = []

    def record_params(trainer):
        """The parameters at the start and before each EMA update, in float64."""
        params = list(trainer.model.parameters())
        params_seen.append([p.detach().double().clone() for p in params])
        ema_step = trainer._ema_step

        def spy():
            params_seen.append([p.detach().double().clone() for p in params])
            ema_step()

        trainer._ema_step = spy

    with tempfile.TemporaryDirectory() as full_dir, tempfile.TemporaryDirectory() as resume_dir:
        torch.backends.cudnn.deterministic = True
        try:
            full, full_losses, full_s = run(full_dir, 6, "breadth_tpu_full_fit", record_params)
            stopped, first_losses, first_s = run(resume_dir, 4, "breadth_tpu_stopped_fit")
            resumed, rest_losses, rest_s = run(resume_dir, 6, "breadth_tpu_resumed_fit")
        finally:
            torch.backends.cudnn.deterministic = False
        # 2 microbatches an update, n.k2 bf16 K2 and n.k3 bf16 K3 each; a validation n.k2 K2 and n.gn GroupNorm
        expect_launches(launches, "breadth_tpu_full_fit", k2=(0, 12 * n.k2 + n.k2), k3=(0, 12 * n.k3), gn=(0, n.gn))
        expect_launches(launches, "breadth_tpu_stopped_fit", k2=(0, 8 * n.k2 + n.k2), k3=(0, 8 * n.k3),
                        gn=(0, n.gn))
        expect_launches(launches, "breadth_tpu_resumed_fit", k2=(0, 4 * n.k2), k3=(0, 4 * n.k3))
        state = load_checkpoint(Path(resume_dir) / "last_checkpoint.pytorch")
        names = [n for n, _ in stopped.model.named_parameters()]
        check(resumed.num_iterations == 6 and len(first_losses) == 8 and len(rest_losses) == 4
              and len(full_losses) == 12, f"the resumed run: iteration {resumed.num_iterations}, "
              f"{len(first_losses)} + {len(rest_losses)} losses against {len(full_losses)}")
        check(sorted(state.get("ema_state_dict", {})) == sorted(names)
              and set(state.get("torch_rng_state", {})) == {"cpu", "cuda", "augment"},
              f"the checkpoint lacks the EMA or the RNG states: {sorted(state)}")
        resume_gap = max(abs(a - b) for a, b in zip(first_losses + rest_losses, full_losses))
        why = "equal" if resume_gap == 0 else "not bitwise: a summation order that the deterministic flag does not fix"
        log(f"[28 _tpu config] ema_decay 0.999, grad_accum_steps 2, resume: auto, bf16, device augmentation: "
            f"6 updates in {full_s:.2f} s (launches {launches['breadth_tpu_full_fit']}); 4 updates + 1 validation in "
            f"{first_s:.2f} s, then a new trainer resumed for 2 in {rest_s:.2f} s (launches "
            f"{launches['breadth_tpu_resumed_fit']}); microbatch losses stopped + resumed against uninterrupted: "
            f"max|d| {resume_gap:.3e} (tol {RESUME_TOL}; {why}); losses {', '.join(f'{v:.5f}' for v in full_losses)}; "
            f"the checkpoint carries ema_state_dict ({len(names)} tensors) and torch_rng_state "
            f"{sorted(state['torch_rng_state'])}")
        check(resume_gap <= RESUME_TOL, f"the resumed run's losses differ from the uninterrupted run's by {resume_gap}")
        del stopped, resumed, state

        # the EMA against a float64 recurrence over the parameters after each update
        decay = BREADTH_TRAINER["ema_decay"]
        check(len(params_seen) == 7, f"{len(params_seen) - 1} EMA updates in 6 optimizer updates")
        want = params_seen[0]
        for params in params_seen[1:]:
            want = [decay * e + (1 - decay) * p for e, p in zip(want, params)]
        p_max = max(p.abs().max().item() for p in params_seen[-1])
        ema_err = max((e.double() - w).abs().max().item() for e, w in zip(full.ema, want)) / p_max
        params_seen.clear()
        del want

        # one update (2 augmented bf16 microbatches) and the EMA's share of it
        group = tuple(host)
        update_ms = timed_ms(lambda: full._update(group, RunningAverage()))
        ema_ms = timed_ms(full._ema_step)
        log(f"[28 EMA] f32 EMA against a float64 recurrence over 6 updates: max|d| / max|p| {ema_err:.3e} "
            f"(tol {EMA_TOL}); one update {update_ms:.2f} ms, the EMA {ema_ms:.3f} ms "
            f"({100 * ema_ms / update_ms:.2f}% of it) ({smi})")
        check(ema_err <= EMA_TOL, f"the EMA differs from its float64 recurrence by {ema_err}")

        # (d) async checkpointing: how long the save blocks the loop, and the
        # file against the state at the save although the next update ran
        blocked, drained = {}, {}
        for mode in (True, False):
            full.async_checkpoint = mode
            torch.cuda.synchronize()
            start = time.perf_counter()
            full._save_checkpoint(is_best=False)
            blocked[mode] = (time.perf_counter() - start) * 1e3
            at_save = {k: {n: t.detach().cpu().clone() for n, t in full._checkpoint_state()[k].items()}
                       for k in ("model_state_dict", "ema_state_dict")}
            full._update(group, RunningAverage())
            full._ema_step()
            start = time.perf_counter()
            full._wait_checkpoint()
            drained[mode] = (time.perf_counter() - start) * 1e3
            written = load_checkpoint(Path(full_dir) / "last_checkpoint.pytorch")
            same = all(torch.equal(written[k][n], t) for k, tensors in at_save.items() for n, t in tensors.items())
            check(same, f"async_checkpoint={mode}: the written file is not the state at the save")
        log(f"[28 async checkpoint] _save_checkpoint blocks the loop {blocked[True]:.2f} ms with async_checkpoint, "
            f"{blocked[False]:.2f} ms without; after the next update the background write still took "
            f"{drained[True]:.2f} ms to join; the file equals the state at the save in both modes ({smi})")
        del full
    torch.cuda.empty_cache()
    return launches


def post_npy(base, volume, query="", timeout=600):
    """POSTs `volume` as .npy bytes to the server's /predict; returns the
    .npy answer."""
    import io
    import urllib.request

    buf = io.BytesIO()
    np.save(buf, volume)
    request = urllib.request.Request(f"{base}/predict{query}", data=buf.getvalue(), method="POST",
                                     headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(request, timeout=timeout) as response:
        return np.load(io.BytesIO(response.read()), allow_pickle=False)


def serving_phase(device, volume, smi):
    """Phase 29: checkpoint conversion, export and serving of the confocal
    UNet3D at full width (seeded random weights): (a) the conv's custom op
    checked by `torch.library.opcheck` and one eager forward through it; (b)
    the serving forward exported on the card in f32 and bf16 with a symbolic
    batch, called at batch 1 and 2 against the eager model; (c) the weights
    through the npz writer and `convert` both ways; (d) the HTTP server on
    phase 4's volume against `predict_array`; (e) the 2D confocal UNet2D's
    micro-batching. Returns the launches of each path by kernel and dtype."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from pytorch3dunet_tpu_torch.convert import convert_checkpoint
    from pytorch3dunet_tpu_torch.export import export_model, load_exported
    from pytorch3dunet_tpu_torch.models.unet import get_model
    from pytorch3dunet_tpu_torch.ops import build, conv3d, group_norm
    from pytorch3dunet_tpu_torch.ops.conv3d import plain_conv
    from pytorch3dunet_tpu_torch.serve import ServingSession, make_server
    from pytorch3dunet_tpu_torch.utils.weights import jax_checkpoint_bytes, load_jax_checkpoint

    launches = {}
    torch.manual_seed(SEED + 29)
    model = get_model(dict(MODEL))
    randomize_group_norms(model, torch.Generator().manual_seed(SEED + 29))
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    model = model.to(device).eval()

    # (a) the op: opcheck per variant and dtype, then one eager forward through it
    gen = torch.Generator(device=device).manual_seed(SEED + 29)
    for variant in conv3d.KERNELS:
        for dtype in (torch.float32, torch.bfloat16):
            x, w, b = conv_inputs(OPCHECK_SHAPE, OPCHECK_F, dtype, True, gen, device)
            torch.library.opcheck(conv3d.conv3d_op, (x, w, b, variant))
            # the same values in NCDHW storage: the op reads its contiguous copy
            strided = x.permute(0, 4, 1, 2, 3).contiguous().permute(0, 2, 3, 4, 1)
            check(not strided.is_contiguous() and torch.equal(conv3d.conv3d_op(strided, w, b, variant),
                                                              conv3d.conv3d_op(x, w, b, variant)),
                  f"{variant} {dtype}: the op on a strided x differs from the op on its contiguous copy")
    log(f"[29 op] torch.library.opcheck of {conv3d.OP_NAME} on CUDA passes for {sorted(conv3d.KERNELS)} x "
        f"(f32, bf16) at x{OPCHECK_SHAPE} F={OPCHECK_F}; a strided x gives its contiguous copy's output bitwise")
    mean, std = float(volume.mean()), float(volume.std())
    rs = np.random.RandomState(SEED + 29)
    raw = {n: torch.from_numpy((rs.randn(n, *EXPORT_PATCH, 1) * std + mean).astype(np.float32)).to(device)
           for n in (1, 2)}

    def eager(x, dtype=None):
        model.compute_dtype = dtype
        with torch.inference_mode():
            return model(((x - mean) / max(std, 1e-10)).movedim(-1, 1))[0].movedim(1, -1)

    probs = count_launches(launches, "export_eager", lambda: eager(raw[1]))
    n_export = plan_launches(model, EXPORT_PATCH)
    n_conv = n_export.k2
    expect_launches(launches, "export_eager", k2=(n_conv, 0), gn=(n_export.gn, 0))
    with plain_conv():
        err = (probs - eager(raw[1])).abs().max().item()
    log(f"[29 op] one eager UNet3D forward of x{tuple(raw[1].shape)} through the op: launches "
        f"{launches['export_eager']}; probabilities against the plain conv max|d| = {err:.3e} (tol {FORWARD_TOL})")
    check(err <= FORWARD_TOL, f"the forward through the op differs from the plain conv by {err}")

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        torch_ckpt = tmp / "weights.pytorch"
        torch.save({"model_state_dict": weights}, torch_ckpt)

        # (b) export: f32 and bf16, symbolic batch, called at batch 1 and 2
        for dtype_name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
            artifact = tmp / f"confocal_{dtype_name}.u3dx"
            config = {"device": "cuda", "model": {**MODEL, **({"dtype": "bfloat16"} if dtype else {})}}
            start = time.perf_counter()
            meta = export_model(config, str(torch_ckpt), str(artifact), patch_shape=EXPORT_PATCH, batch="poly",
                                normalize="standardize", stats={"mean": mean, "std": std})
            export_s = time.perf_counter() - start
            exported = load_exported(artifact)
            check(meta["custom_ops"] == [conv3d.OP_NAME, group_norm.OP_NAME]
                  and exported.meta["dtype"] == ("bfloat16" if dtype else "float32"), f"artifact meta {exported.meta}")
            # every GroupNorm module call of the traced forward is a call of the op, which launches the kernel
            # at run time
            gn_calls = sum(str(node.target) == "pytorch3dunet_tpu_torch.group_norm_fwd.default"
                           for node in exported.program.graph.nodes)
            check(gn_calls == n_export.gn > 0, f"{dtype_name} artifact: {gn_calls} GroupNorm op calls in its graph, "
                                               f"{n_export.gn} GroupNorm module calls a forward")
            errs = {}
            path = "export" if dtype is None else "export_bf16"
            for n, x in raw.items():
                with torch.no_grad():
                    got = count_launches(launches, f"{path}_batch{n}", lambda: exported.module(x))
                want = eager(x, dtype)
                expect_launches(launches, f"{path}_batch{n}", k2=(0, n_conv) if dtype else (n_conv, 0),
                                gn=(0, gn_calls) if dtype else (gn_calls, 0))
                check(got.shape == want.shape == (n, *EXPORT_PATCH, 1), f"artifact output {tuple(got.shape)}")
                errs[n] = (got - want).abs().max().item()
                check(errs[n] <= EXPORT_TOL, f"{dtype_name} artifact at batch {n} differs from the eager model by "
                                             f"{errs[n]} (tol {EXPORT_TOL})")
            launches[path] = launches.pop(f"{path}_batch1")
            with torch.no_grad():
                artifact_ms = timed_ms(lambda: exported.module(raw[1]))
            eager_ms = timed_ms(lambda: eager(raw[1], dtype))
            log(f"[29 export] {dtype_name} UNet3D, standardize inside, patch {EXPORT_PATCH}, symbolic batch: export "
                f"{export_s:.2f} s, artifact {artifact.stat().st_size / 1e6:.1f} MB; {n_conv} K2 and {gn_calls} "
                f"GroupNorm launch pairs a forward inside it "
                f"(batch 1 {launches[path]['conv3d_fwd']}, batch 2 {launches[path + '_batch2']['conv3d_fwd']}); "
                f"against the eager model max|d| batch 1 {errs[1]:.3e}, batch 2 {errs[2]:.3e} (tol {EXPORT_TOL}); "
                f"forward at batch 1 {artifact_ms:.2f} ms against eager {eager_ms:.2f} ms (median of {RUNS}) "
                f"({smi})")
            del exported
        model.compute_dtype = None
        del probs
        torch.cuda.empty_cache()

        # (c) convert: the npz writer, its reader, and convert both ways, bitwise
        npz = tmp / "weights.npz"
        npz.write_bytes(jax_checkpoint_bytes({"model_state_dict": weights, "num_epochs": 0, "num_iterations": 1,
                                              "best_eval_score": None}))
        read_back = get_model(dict(MODEL))
        load_jax_checkpoint(read_back, npz)
        start = time.perf_counter()
        to_torch = convert_checkpoint({"model": dict(MODEL)}, npz, tmp / "converted.pytorch")
        back = convert_checkpoint({"model": dict(MODEL)}, tmp / "converted.pytorch", tmp / "back.npz")
        convert_s = time.perf_counter() - start
        round_trip = get_model(dict(MODEL))
        load_jax_checkpoint(round_trip, tmp / "back.npz")
        converted = torch.load(tmp / "converted.pytorch", weights_only=True)["model_state_dict"]
        for what, state in (("npz read back", read_back.state_dict()), ("--to torch", converted),
                            ("torch -> npz", round_trip.state_dict())):
            same = state.keys() == weights.keys() and all(torch.equal(state[k], v) for k, v in weights.items())
            check(same, f"{what}: the weights are not bitwise the model's")
        log(f"[29 convert] {len(weights)} tensors: npz {npz.stat().st_size / 1e6:.1f} MB read back bitwise; "
            f"convert -> {to_torch} -> {back} bitwise in {convert_s:.2f} s ({smi})")

        # (d) serve the confocal test config built from the npz
        config = {"device": "cuda", "model_path": str(npz), "model": dict(MODEL),
                  "predictor": {"name": "DeviceSlidingWindowPredictor"},
                  "loaders": {"global_normalization": True, "test": {
                      "slice_builder": {"name": "SliceBuilder", "patch_shape": list(PATCH),
                                        "stride_shape": list(STRIDE), "halo_shape": list(HALO)},
                      "transformer": copy.deepcopy(TRANSFORMER)}}}
        session = ServingSession(config)
        warmup_s = {}
        default_build_dir = build.BUILD_DIR
        try:
            # a cold kernel build cache (nvcc), then a warm one (the libraries on disk)
            build.BUILD_DIR = tmp / "torch_kernels"
            for cache in ("cold", "warm"):
                build._libs.clear()
                start = time.perf_counter()
                session.warmup()
                torch.cuda.synchronize()
                warmup_s[cache] = time.perf_counter() - start
        finally:
            build.BUILD_DIR = default_build_dir
        check(session.normalize == "standardize", f"the confocal test config serves {session.normalize!r}")
        server = make_server(session, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            base = f"http://127.0.0.1:{server.server_address[1]}"
            served = count_launches(launches, "serve", lambda: post_npy(base, volume))
            n_patches = math.prod(-(-v // s) for v, s in zip(VOLUME, STRIDE))
            patch_in = tuple(p + 2 * h for p, h in zip(PATCH, HALO))
            n_serve = plan_launches(model, patch_in)
            expect_launches(launches, "serve", k2=(n_serve.k2 * n_patches, 0), gn=(n_serve.gn * n_patches, 0))

            def direct():
                return session.predictor.predict_array(volume, PATCH, STRIDE, HALO, normalize=session.normalize,
                                                       stats=session._resolve_stats(volume))

            want = direct()
            check(np.array_equal(served, want), f"served differs from predict_array by "
                                                f"{np.abs(served - want).max()}")
            segmentation = post_npy(base, volume, "?output=segmentation")
            check(segmentation.dtype == np.uint16
                  and np.array_equal(segmentation, session.predictor._to_segmentation(want)),
                  "?output=segmentation differs from _to_segmentation of predict_array")
            request_s, direct_s = [], []
            for _ in range(SERVE_RUNS):
                start = time.perf_counter()
                post_npy(base, volume)
                request_s.append(time.perf_counter() - start)
                start = time.perf_counter()
                direct()
                direct_s.append(time.perf_counter() - start)
            request_med, direct_med = statistics.median(request_s), statistics.median(direct_s)
            start = time.perf_counter()
            with ThreadPoolExecutor(SERVE_CLIENTS) as pool:
                answers = list(pool.map(lambda _: post_npy(base, volume), range(SERVE_CLIENTS)))
            concurrent_s = time.perf_counter() - start
            check(all(np.array_equal(a, want) for a in answers), "a concurrent client got another answer")
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)
        log(f"[29 serve] POST /predict of {VOLUME} ({volume.nbytes / 1e6:.1f} MB .npy) on the confocal test "
            f"config: launches {launches['serve']}; bitwise predict_array; ?output=segmentation equals its "
            f"_to_segmentation; request {1e3 * request_med:.1f} ms against predict_array {1e3 * direct_med:.1f} ms "
            f"(median of {SERVE_RUNS}): HTTP and .npy {100 * (request_med - direct_med) / request_med:.1f}%; "
            f"{SERVE_CLIENTS} concurrent clients answered alike in {concurrent_s:.2f} s; warm-up with a cold "
            f"kernel build cache {warmup_s['cold']:.2f} s, warm {warmup_s['warm']:.2f} s ({smi})")
        del session, server

    # (e) 2D micro-batching: the 2D confocal test config under --batch-planes 24
    torch.manual_seed(SEED + 29)
    config = {"device": "cuda", "model": dict(MODEL_2D), "predictor": {"name": "DeviceSlidingWindowPredictor"},
              "loaders": {"global_normalization": True, "test": {
                  "slice_builder": {"name": "SliceBuilder", "patch_shape": list(PATCH_2D_TEST),
                                    "stride_shape": list(PATCH_2D_TEST), "halo_shape": list(HALO_2D)},
                  "transformer": copy.deepcopy(TRANSFORMER)}}}
    session = ServingSession(config, batch_planes=SERVE_BATCH_PLANES)
    randomize_group_norms(session.model, torch.Generator().manual_seed(SEED + 29))
    session.warmup()
    rs = np.random.RandomState(SEED + 29)
    # two mixes: requests of 4 planes of 1024x1024 (16 tiles each, one full
    # forward of the 2D sweep's patch_batch), and requests of one plane of one
    # tile, 512x512
    mixes = {"4x1024^2": [(rs.rand(SERVE_2D_PLANES, *VOLUME_2D[1:]) * 2 + 1).astype(np.float32)
                          for _ in range(SERVE_2D_CLIENTS)],
             "1x512^2": [(rs.rand(1, *PATCH_2D_TEST[1:]) * 2 + 1).astype(np.float32)
                         for _ in range(SERVE_1P_CLIENTS)]}
    planes = mixes["4x1024^2"]
    start = time.perf_counter()
    expected = {name: [session._predict_direct(p, session._resolve_stats(p)) for p in vols]
                for name, vols in mixes.items()}
    sequential_s = time.perf_counter() - start
    server = make_server(session, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    walls = {}
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        with ThreadPoolExecutor(max(SERVE_2D_CLIENTS, SERVE_1P_CLIENTS)) as pool:
            batcher = session._batcher
            submit = batcher.submit

            def held(vols):
                """The answers to `vols` sent at once with the device lock held
                until every request has reached the micro-batcher, so that
                they coalesce into at most two dispatches; and the batched
                dispatches that took them."""
                dispatches, arrived = batcher.batched_dispatches, []

                def counted_submit(*args):
                    arrived.append(None)
                    return submit(*args)

                batcher.submit = counted_submit
                try:
                    with session._lock:
                        futures = [pool.submit(post_npy, base, p) for p in vols]
                        deadline = time.perf_counter() + 60
                        while len(arrived) < len(vols) and time.perf_counter() < deadline:
                            time.sleep(0.01)
                    return [f.result() for f in futures], batcher.batched_dispatches - dispatches
                finally:
                    batcher.submit = submit

            # how the requests coalesce decides the forwards: count them
            forwards = []
            hook = session.model.register_forward_hook(lambda *_: forwards.append(None))
            reset_launches()
            try:
                results, n_batched = held(planes)
                torch.cuda.synchronize()
            finally:
                hook.remove()
            launches["serve_2d"] = launches_by_dtype()
            batching = dict(session.info()["batching"])
            single, single_batched = held(mixes["1x512^2"])
            # wall times of each mix sent by all its clients at once, with the
            # micro-batcher on and off (median of SERVE_RUNS, alternating)
            for name, vols in mixes.items():
                for on in (True, False):
                    walls[name, on] = []
                for _ in range(SERVE_RUNS):
                    for on in (True, False):
                        session._batcher = batcher if on else None
                        start = time.perf_counter()
                        list(pool.map(lambda p: post_npy(base, p), vols))
                        walls[name, on].append(time.perf_counter() - start)
            session._batcher = batcher
            start = time.perf_counter()
            for p in planes:
                post_npy(base, p)
            sequential_http_s = time.perf_counter() - start
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    tile = tuple(p + 2 * h for p, h in zip(PATCH_2D_TEST[1:], HALO_2D[1:]))
    expect_launches(launches, "serve_2d", gn=(plan_launches(session.model, tile).gn * len(forwards), 0))
    check(forwards, "the 2D requests ran no forward")
    err = max(np.abs(got - want).max() for got, want in zip(results + single,
                                                              expected["4x1024^2"] + expected["1x512^2"]))
    wall = {key: statistics.median(times) for key, times in walls.items()}
    log(f"[29 serve 2D] {SERVE_2D_CLIENTS} concurrent requests of {SERVE_2D_PLANES}x{VOLUME_2D[1]}x{VOLUME_2D[2]} "
        f"under --batch-planes {SERVE_BATCH_PLANES}, held until all queued: {n_batched} batched dispatch(es) of "
        f"{batching['batched_requests']} requests; {SERVE_1P_CLIENTS} of 1x{PATCH_2D_TEST[1]}x{PATCH_2D_TEST[2]} "
        f"held alike: {single_batched} batched dispatch(es); each against its "
        f"direct prediction max|d| = {err:.3e} (tol {SERVE_2D_TOL}); wall time of each mix from all its clients at "
        f"once, micro-batcher on against off (median of {SERVE_RUNS}): "
        + "; ".join(f"{name} {wall[name, True]:.3f} s against {wall[name, False]:.3f} s" for name in mixes)
        + f"; the six 4x1024^2 requests one after another {sequential_http_s:.3f} s, their direct predictions "
        f"{sequential_s:.3f} s with the single planes' ({smi})")
    check(n_batched >= 1 and single_batched >= 1,
          f"no batched dispatch: {batching}, single planes {single_batched}")
    check(err <= SERVE_2D_TOL, f"micro-batched 2D results differ from direct by {err}")
    del session, server
    torch.cuda.empty_cache()
    return launches


# phase 30: the port's parallelism on one card. World size 1 over NCCL (the
# exchanged halos are zeros), then two ranks as two processes sharing the card
# over gloo, which takes CUDA tensors for all_reduce and broadcast (NCCL refuses
# two ranks on one device). The f32 steps take phase 13's gate against a
# float64 plain step on the same batch and weights; the bf16 step phase 19's
PARALLEL_RANKS = 2
PARALLEL_TIMEOUT_S = 600
# the cooperative slab: the first 80 planes of phase 4's volume as one slab,
# padded depth 112 shards 2 ways through the 4 levels; then, as a second
# input, its last 80 planes reversed with noise of another seed added
COOP_DEPTH = 80
COOP_MAX_PATCH_VOXELS = (COOP_DEPTH + 2 * HALO[0]) * (VOLUME[1] + 2 * HALO[1]) * (VOLUME[2] + 2 * HALO[2])
# the grid sweep against one rank's: the same cores, summed by one all-reduce.
# The cooperative slab against one rank's slab within COOP_TOL, or no further
# from a float64 forward of the slab than twice one rank's own distance plus
# COOP_TOL (phase 13's form): its GroupNorm sums its moments in another order,
# which moved the probabilities by 3.3e-5 on an H100 while one rank's slab sat
# 3.4e-5 from float64 and the z-sharded one 2.4e-6. Either way within COOP_CAP
# of one rank's slab, so that a drift between the two paths cannot hide behind
# a noisy reference
SWEEP_TOL, COOP_TOL, COOP_CAP = 1e-5, 2e-5, 1e-4


def coop_inputs(volume):
    """The cooperative slab's two inputs, each with its (normalize, stats):
    phase 4's first COOP_DEPTH planes under the volume's statistics, then its
    last COOP_DEPTH planes reversed plus noise of another seed, under its own."""
    from pytorch3dunet_tpu_torch.datasets.utils import calculate_stats
    from pytorch3dunet_tpu_torch.inference_device import detect_device_path

    noise = 0.5 * np.random.RandomState(SEED + 30).rand(COOP_DEPTH, *VOLUME[1:]).astype(np.float32)
    second = np.ascontiguousarray(volume[-COOP_DEPTH:][::-1] + noise)
    first = np.ascontiguousarray(volume[:COOP_DEPTH])
    return [(first, *detect_device_path(TRANSFORMER["raw"], calculate_stats(volume))),
            (second, *detect_device_path(TRANSFORMER["raw"], calculate_stats(second)))]


def phase30_trainer(checkpoint_dir, batch, spatial, dtype=None):
    """`create_trainer` on one in-memory batch: the confocal model and recipe,
    `trainer.spatial_sharding` on, or off (data parallel over 2 ranks)."""
    from pytorch3dunet_tpu_torch.trainer import create_trainer

    model = dict(MODEL) if dtype is None else {**MODEL, "dtype": dtype}
    config = {"manual_seed": SEED, "device": "cuda", "model": model, **TRAIN_SECTIONS,
              "trainer": {"checkpoint_dir": checkpoint_dir, "spatial_sharding": spatial,
                          "eval_score_higher_is_better": False, "validate_after_iters": 10**9,
                          "log_after_iters": 10**9, "max_num_epochs": 1, "max_num_iterations": 10}}
    return create_trainer(config, loaders={"train": [batch], "val": []})


def trainer_update(trainer, state, batch):
    """`state` into the trainer's model, then one `_update` on `batch` (the
    trainer's batch preparation, mesh and step); its gradients, float64 on
    the host."""
    from pytorch3dunet_tpu_torch.utils.misc import RunningAverage

    trainer.model.load_state_dict(state)
    trainer._update((batch,), RunningAverage())
    return {name: p.grad.detach().double().cpu() for name, p in trainer.model.named_parameters()}


def _parallel_rank(rank, port, tmpdir):
    """One of the two ranks of phase 30(b)-(c): gloo on CUDA tensors, on the card
    both share. Saves its grads, launches, outputs and times to tmpdir."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch.distributed as dist

    from pytorch3dunet_tpu_torch.config import use_float32_math
    from pytorch3dunet_tpu_torch.models.unet import get_model
    from pytorch3dunet_tpu_torch.parallel import distributed
    from pytorch3dunet_tpu_torch.predictor import DeviceSlidingWindowPredictor

    use_float32_math()
    # the library takes NCCL for CUDA; NCCL refuses two ranks on one device,
    # so this drill makes the gloo group itself
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=PARALLEL_RANKS, rank=rank)
    distributed.build_host_groups()
    device = torch.device("cuda", 0)
    inputs = torch.load(os.path.join(tmpdir, "inputs.pt"), weights_only=False)
    state, batches = inputs["state"], inputs["batches"]
    checkpoint_dir = os.path.join(tmpdir, "checkpoints")
    out = {}

    # (b) the D-sharded f32 step through the trainer: local D 40
    trainer = phase30_trainer(checkpoint_dir, batches[0], spatial=True)
    torch.backends.cudnn.deterministic = True
    reset_launches()
    out["sharded_grads"] = trainer_update(trainer, state, batches[0])
    torch.cuda.synchronize()
    out["sharded_launches"] = launches_by_dtype()
    torch.backends.cudnn.deterministic = False
    out["sharded_params"] = {name: p.detach().cpu() for name, p in trainer.model.named_parameters()}
    slabs = trainer._prepare_batch(*batches[0])
    out["space_ranks"], out["local_d"] = trainer.mesh.size, slabs[0].shape[2]
    out["sharded_step_ms"] = timed_ms(lambda: trainer._train_fns(*slabs), runs=3)

    # the collectives' share of one step: every all_reduce timed, the card synchronized around each
    collective = {"ms": 0.0, "calls": 0, "bytes": 0}
    all_reduce = dist.all_reduce

    def timed_all_reduce(tensor, *args, **kwargs):
        torch.cuda.synchronize()
        start = time.perf_counter()
        result = all_reduce(tensor, *args, **kwargs)
        torch.cuda.synchronize()
        collective["ms"] += (time.perf_counter() - start) * 1e3
        collective["calls"] += 1
        collective["bytes"] += tensor.numel() * tensor.element_size()
        return result

    dist.all_reduce = timed_all_reduce
    try:
        torch.cuda.synchronize()
        start = time.perf_counter()
        trainer._train_fns(*slabs)
        torch.cuda.synchronize()
        out["sharded_step_synced_ms"] = (time.perf_counter() - start) * 1e3
    finally:
        dist.all_reduce = all_reduce
    out["collectives"] = collective
    del trainer, slabs

    # (b) one data-parallel step of 2 x 1 patches through the trainer: each rank its own patch
    trainer = phase30_trainer(checkpoint_dir, batches[rank], spatial=False)
    torch.backends.cudnn.deterministic = True
    reset_launches()
    out["dp_grads"] = trainer_update(trainer, state, batches[rank])
    torch.cuda.synchronize()
    out["dp_launches"] = launches_by_dtype()
    torch.backends.cudnn.deterministic = False
    out["dp_ranks"] = trainer.mesh.size
    mine = trainer._prepare_batch(*batches[rank])
    out["dp_step_ms"] = timed_ms(lambda: trainer._train_fns(*mine), runs=3)
    del trainer, mine

    # (c) the grid sweep split over the host's 2 ranks, then the cooperative slabs
    model = get_model(MODEL)
    model.load_state_dict(state)
    model = model.to(device).eval()
    volume, normalize, stats = inputs["volume"], inputs["normalize"], inputs["stats"]
    grid = DeviceSlidingWindowPredictor(model, None, model.out_channels, device, blend="assign")
    reset_launches()
    torch.cuda.synchronize()
    start = time.perf_counter()
    out["sweep"] = grid.predict_array(volume, PATCH, STRIDE, HALO, normalize=normalize, stats=stats)
    torch.cuda.synchronize()
    out["sweep_ms"] = (time.perf_counter() - start) * 1e3
    out["sweep_launches"] = launches_by_dtype()
    out["sweep_sharded"] = [key[-2] for key in grid._sweeps]
    coop = DeviceSlidingWindowPredictor(model, None, model.out_channels, device, blend="gaussian", patch_mode="slab",
                                        max_patch_voxels=COOP_MAX_PATCH_VOXELS)
    slabs = coop_inputs(volume)
    slab, normalize, stats = slabs[0]
    coop.predict_array(slab, PATCH, STRIDE, HALO, normalize=normalize, stats=stats)  # warm-up
    reset_launches()
    torch.cuda.synchronize()
    start = time.perf_counter()
    out["coop"] = [coop.predict_array(slab, PATCH, STRIDE, HALO, normalize=normalize, stats=stats)]
    torch.cuda.synchronize()
    out["coop_ms"] = (time.perf_counter() - start) * 1e3
    out["coop_launches"] = launches_by_dtype()
    out["coop"] += [coop.predict_array(s, PATCH, STRIDE, HALO, normalize=n, stats=st) for s, n, st in slabs[1:]]
    out["coop_spatial_n"] = [key[-1] for key in coop._sweeps]
    if rank != 0:
        del out["sweep"], out["coop"]
    torch.save(out, os.path.join(tmpdir, f"rank{rank}.pt"))
    distributed.shutdown()


def parallel_phase(device, batches, volume, step_ms, smi):
    """Phase 30, every step through `create_trainer`'s trainer: (a) the
    D-sharded confocal step at world size 1 over NCCL, f32 and bf16, against
    phase 7's unsharded step; (b) two ranks sharing the card over gloo: the
    D-sharded step (local D 40) and one data-parallel step of 2 x 1 patches;
    (c) the grid sweep split over the 2 ranks and the cooperative slab at two
    inputs; (d) times. Returns the launches of its paths by kernel and dtype."""
    import torch.multiprocessing as mp

    from pytorch3dunet_tpu_torch.datasets.utils import mirror_pad
    from pytorch3dunet_tpu_torch.losses import get_loss_criterion
    from pytorch3dunet_tpu_torch.models.unet import get_model
    from pytorch3dunet_tpu_torch.ops.conv3d import plain_conv
    from pytorch3dunet_tpu_torch.parallel import distributed
    from pytorch3dunet_tpu_torch.predictor import DeviceSlidingWindowPredictor

    phase_start = time.perf_counter()
    launches = {}
    torch.manual_seed(SEED)
    model = get_model(MODEL)
    randomize_group_norms(model, torch.Generator().manual_seed(SEED + 1))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    model = model.to(device).train()
    criterion = get_loss_criterion({"loss": dict(TRAIN_SECTIONS["loss"])})
    inp, target = (torch.from_numpy(a).to(device) for a in batches[0])

    def gate(grads, grads_plain, grads64, tag):
        """Phase 13's gate: each tensor's error from float64 within twice the
        plain f32 step's own plus RES_GRAD_TOL."""
        err_k, err_p = ({k: worst_rel({k: g[k]}, grads64)[0] for k in g} for g in (grads, grads_plain))
        margin = min((2 * err_p[k] + RES_GRAD_TOL - err_k[k], k) for k in grads)
        log(f"[30 parallel] {tag}: grads against a float64 plain step, worst over {len(grads)} tensors: sharded "
            f"{max(err_k.values()):.3e} ({max(err_k, key=err_k.get)}), plain f32 {max(err_p.values()):.3e}; least "
            f"margin to 2 x plain + {RES_GRAD_TOL}: {margin[0]:.3e} ({margin[1]})")
        check(all(math.isfinite(v) for v in err_k.values()), f"{tag}: grads not finite")
        check(margin[0] >= 0, f"{tag}: sharded {err_k[margin[1]]} vs plain f32 {err_p[margin[1]]} from float64 at "
                              f"{margin[1]}")

    # (a) world size 1 over NCCL, through initialize_from_env and a local coordinator
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    os.environ.update(P3DUNET_COORDINATOR=f"127.0.0.1:{port}", P3DUNET_NUM_PROCESSES="1", P3DUNET_PROCESS_ID="0")
    try:
        check(distributed.initialize_from_env(device), "initialize_from_env did not set up a process group")
        import torch.distributed as dist

        check(dist.get_backend() == "nccl" and distributed.world_size() == 1, f"backend {dist.get_backend()}")
        with tempfile.TemporaryDirectory() as checkpoint_dir:
            sharded = phase30_trainer(checkpoint_dir, batches[0], spatial=True)
            torch.backends.cudnn.deterministic = True
            try:
                grads = count_launches(launches, "sharded_train_ws1",
                                       lambda: trainer_update(sharded, state, batches[0]))
                with plain_conv():
                    grads_plain = grads_of_step(model, criterion, inp, target)
                    grads64 = grads_of_step(copy.deepcopy(model).double(), criterion, inp, target, torch.float64)
            finally:
                torch.backends.cudnn.deterministic = False
            check(sharded.mesh is not None and sharded.mesh.size == 1, f"the trainer's space mesh {sharded.mesh}")
            sharded_n = plan_launches(MODEL, TRAIN_PATCH, space_mesh=True)
            expect_launches(launches, "sharded_train_ws1", k2=(sharded_n.k2, 0), k3=(sharded_n.k3, 0))
            grads_plain, grads64 = ({k: g.cpu() for k, g in d.items()} for d in (grads_plain, grads64))
            gate(grads, grads_plain, grads64, "(a) the trainer's D-sharded step at world size 1, NCCL")

            # bf16: phase 19's gate against the unsharded bf16 step with the plain conv
            sharded16 = phase30_trainer(checkpoint_dir, batches[0], spatial=True, dtype="bfloat16")
            grads16 = count_launches(launches, "sharded_train_bf16_ws1",
                                     lambda: trainer_update(sharded16, state, batches[0]))
            expect_launches(launches, "sharded_train_bf16_ws1", k2=(0, sharded_n.k2), k3=(0, sharded_n.k3))
            sharded16.model.load_state_dict(state)
            with plain_conv():
                grads16_plain = {k: g.cpu() for k, g in grads_of_step(sharded16.model, criterion, inp, target).items()}
            g_max = max(g.abs().max().item() for g in grads16_plain.values())
            vs_plain = max(((g - grads16_plain[k]).abs().max().item() / g_max, k) for k, g in grads16.items())
            log(f"[30 parallel] (a) the trainer's bf16 D-sharded step at world size 1: vs the unsharded bf16 step "
                f"with the plain conv worst max|d| / max|g| {vs_plain[0]:.3e} ({vs_plain[1]}, ceiling "
                f"{BF16_STEP_VS_PLAIN_TOL})")
            check(vs_plain[0] <= BF16_STEP_VS_PLAIN_TOL,
                  f"bf16 D-sharded step differs from the plain conv's: {vs_plain}")
            del sharded16, grads16, grads16_plain

            # (d) the halo path's cost: the trainer's sharded step against its unsharded one, in turns
            unsharded = phase30_trainer(checkpoint_dir, batches[0], spatial=False)
            trainer_update(unsharded, state, batches[0])
            check(unsharded.mesh is None, f"one rank without spatial_sharding took the mesh {unsharded.mesh}")
            whole, slabs = unsharded._prepare_batch(*batches[0]), sharded._prepare_batch(*batches[0])
            plain_ms = [timed_ms(lambda: unsharded._train_fns(*whole), runs=3)]
            sharded_ms = timed_ms(lambda: sharded._train_fns(*slabs), runs=3)
            plain_ms.append(timed_ms(lambda: unsharded._train_fns(*whole), runs=3))
            profile_step(lambda: sharded._train_fns(*slabs), tag="30 profile",
                         what="one D-sharded f32 step at world size 1")
            log(f"[30 parallel] (d) {smi}: one f32 train step (Adam) of {TRAIN_PATCH}, the trainer's: D-sharded at "
                f"world size 1 (NCCL, zero halos, every conv on D + 2 planes) {sharded_ms:.2f} ms | unsharded "
                f"{plain_ms[0]:.2f}, {plain_ms[1]:.2f} ms (phase 8: {step_ms:.2f} ms) | halo path cost "
                f"{sharded_ms / statistics.mean(plain_ms) - 1:+.1%}")
            del sharded, unsharded, whole, slabs
    finally:
        distributed.shutdown()
        for key in ("P3DUNET_COORDINATOR", "P3DUNET_NUM_PROCESSES", "P3DUNET_PROCESS_ID"):
            os.environ.pop(key, None)

    # the references of (b) and (c), before the ranks take the card
    stacked = [torch.from_numpy(np.concatenate([b[i] for b in batches])).to(device) for i in range(2)]
    torch.backends.cudnn.deterministic = True
    try:
        with plain_conv():
            dp_plain = {k: g.cpu() for k, g in grads_of_step(model, criterion, *stacked).items()}
            dp64 = {k: g.cpu() for k, g in grads_of_step(copy.deepcopy(model).double(), criterion, *stacked,
                                                          torch.float64).items()}
    finally:
        torch.backends.cudnn.deterministic = False
    del stacked, inp, target
    model.eval()
    coop_slabs = coop_inputs(volume)
    _, normalize, stats = coop_slabs[0]
    one = DeviceSlidingWindowPredictor(model, None, model.out_channels, device, blend="assign")
    one.predict_array(volume, PATCH, STRIDE, HALO, normalize=normalize, stats=stats)
    start = time.perf_counter()
    sweep_ref = one.predict_array(volume, PATCH, STRIDE, HALO, normalize=normalize, stats=stats)
    sweep_ref_ms = (time.perf_counter() - start) * 1e3
    slab = DeviceSlidingWindowPredictor(model, None, model.out_channels, device, blend="gaussian", patch_mode="slab",
                                        max_patch_voxels=COOP_MAX_PATCH_VOXELS)
    slab_refs, slab64s = [], []
    for i, (slab_volume, slab_normalize, slab_stats) in enumerate(coop_slabs):
        if i == 0:
            slab.predict_array(slab_volume, PATCH, STRIDE, HALO, normalize=slab_normalize, stats=slab_stats)
        torch.cuda.synchronize()
        start = time.perf_counter()
        slab_refs.append(slab.predict_array(slab_volume, PATCH, STRIDE, HALO, normalize=slab_normalize,
                                            stats=slab_stats))
        torch.cuda.synchronize()
        if i == 0:
            slab_ref_ms = (time.perf_counter() - start) * 1e3
        # the slab plan is one patch: its float64 forward with the plain conv
        padded = (mirror_pad(slab_volume, HALO) - slab_stats["mean"]) / slab_stats["std"]
        with torch.inference_mode(), plain_conv():
            probs64 = copy.deepcopy(model).double()(torch.from_numpy(padded).to(device).double()[None, None])[0]
        slab64s.append(probs64[0, :, HALO[0]:-HALO[0], HALO[1]:-HALO[1], HALO[2]:-HALO[2]].cpu().numpy())
        del probs64
    del model, one, slab
    torch.cuda.empty_cache()

    # (b)-(c) two ranks on the one card
    with tempfile.TemporaryDirectory() as tmpdir:
        torch.save({"state": state, "batches": batches, "volume": volume, "normalize": normalize, "stats": stats},
                   os.path.join(tmpdir, "inputs.pt"))
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_parallel_rank, args=(rank, port, tmpdir)) for rank in range(PARALLEL_RANKS)]
        start = time.perf_counter()
        for proc in procs:
            proc.start()
        try:
            for proc in procs:
                proc.join(max(PARALLEL_TIMEOUT_S - (time.perf_counter() - start), 1))
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.kill()
                    proc.join()
        check(all(proc.exitcode == 0 for proc in procs), f"phase 30 ranks exited {[p.exitcode for p in procs]}")
        ranks = [torch.load(os.path.join(tmpdir, f"rank{r}.pt"), weights_only=False) for r in range(PARALLEL_RANKS)]
        ranks_s = time.perf_counter() - start

    for rank, res in enumerate(ranks):
        check(res["space_ranks"] == PARALLEL_RANKS and res["local_d"] == TRAIN_PATCH[0] // PARALLEL_RANKS,
              f"rank {rank}: space mesh {res['space_ranks']}, local D {res['local_d']}")
        check(res["dp_ranks"] == PARALLEL_RANKS, f"rank {rank}: data mesh of {res['dp_ranks']} ranks")
        # the D-sharded step and slab take the generic decoders; the data-parallel step and the grid sweep not
        sharded_n, dp_n = plan_launches(MODEL, TRAIN_PATCH, space_mesh=True), plan_launches(MODEL, TRAIN_PATCH)
        patch_in = tuple(p + 2 * h for p, h in zip(PATCH, HALO))
        # 2 patches a rank in the grid sweep; a space mesh takes the all-reduced GroupNorm, never the kernel
        sweep_n = plan_launches(MODEL, patch_in)
        for path, k2, k3, gn in (("sharded", sharded_n.k2, sharded_n.k3, 0), ("dp", dp_n.k2, dp_n.k3, 0),
                                 ("sweep", 2 * sweep_n.k2, 0, 2 * sweep_n.gn), ("coop", sharded_n.k2, 0, 0)):
            launches[f"{path}_rank{rank}"] = res[f"{path}_launches"]
            expect_launches(launches, f"{path}_rank{rank}", k2=(k2, 0), k3=(k3, 0), gn=(gn, 0))
        gate(res["sharded_grads"], grads_plain, grads64,
             f"(b) rank {rank} of the trainer's D-sharded step over gloo, local D 40")
        gate(res["dp_grads"], dp_plain, dp64, f"(b) rank {rank} of the trainer's data-parallel step of 2 x 1 patches")
    for name, value in ranks[0]["sharded_params"].items():
        check(torch.equal(value, ranks[1]["sharded_params"][name]), f"the ranks' updated {name} differ")
    check(ranks[0]["sweep_sharded"] == [True], f"the grid sweep did not shard: {ranks[0]['sweep_sharded']}")
    check(ranks[0]["coop_spatial_n"] == [PARALLEL_RANKS], f"the slab was not z-sharded: {ranks[0]['coop_spatial_n']}")
    sweep_err = float(np.abs(ranks[0]["sweep"] - sweep_ref).max())
    log(f"[30 parallel] (c) the grid sweep of {VOLUME} over 2 ranks (2 patches, 28 K2 a rank) vs one rank: max|d| "
        f"{sweep_err:.3e} (tol {SWEEP_TOL})")
    check(sweep_err <= SWEEP_TOL, f"the sharded sweep differs from the one-rank sweep by {sweep_err}")
    for i, (coop, slab_ref, slab64) in enumerate(zip(ranks[0]["coop"], slab_refs, slab64s)):
        coop_err = float(np.abs(coop - slab_ref).max())
        coop64, one64 = (float(np.abs(a[0] - slab64).max()) for a in (coop, slab_ref))
        log(f"[30 parallel] (c) slab {i} of {COOP_DEPTH} planes z-sharded over 2 ranks vs one rank's slab: max|d| "
            f"{coop_err:.3e} (tol {COOP_TOL}, cap {COOP_CAP}); from a float64 forward of the slab: z-sharded "
            f"{coop64:.3e}, one rank {one64:.3e} (tol 2 x one rank + {COOP_TOL})")
        check(coop_err <= COOP_CAP, f"cooperative slab {i} differs from the slab sweep by {coop_err}")
        check(coop_err <= COOP_TOL or coop64 <= 2 * one64 + COOP_TOL,
              f"cooperative slab {i} differs from the slab sweep by {coop_err} and from float64 by {coop64}")
    for rank, res in enumerate(ranks):
        col = res["collectives"]
        log(f"[30 parallel] (d) {smi}: rank {rank} of 2 sharing the card (gloo on CUDA tensors), the trainer's steps "
            f"(Adam): D-sharded f32 {res['sharded_step_ms']:.2f} ms (one step synchronized around each collective: "
            f"{res['sharded_step_synced_ms']:.2f} ms, of which {col['calls']} all-reduces {col['ms']:.2f} ms, "
            f"{col['bytes'] / 2**20:.1f} MiB) | data-parallel {res['dp_step_ms']:.2f} ms | grid sweep "
            f"{res['sweep_ms']:.1f} ms | cooperative slab {res['coop_ms']:.1f} ms")
    log(f"[30 parallel] (d) one rank: grid sweep {sweep_ref_ms:.1f} ms, slab {slab_ref_ms:.1f} ms; the two ranks ran "
        f"{ranks_s:.1f} s with their start; phase 30 took {time.perf_counter() - phase_start:.1f} s. Two ranks "
        "sharing one card say nothing of scaling")
    return launches


# phase 31: the JAX package's default decoder paths against the generic ones,
# each switch read at call time. (a)-(c) hold each path as phases 4, 13 and 16
# hold theirs; (e) holds the fused 2D BatchNorm decoder to the generic one
# within DECODER_2D_TOL of the logits' max, and its running statistics within
# DECODER_2D_TOL of theirs (f32 cuDNN on both: the split conv and the one-pass
# statistics sum in another order). The port's default of each switch is the
# path that is no slower than the other beyond DEFAULT_SPREAD on the forwards
# and steps below (each timed in turns: generic, new, new, generic)
DECODER_SWITCHES = {"fused": ("P3DUNET_FUSED_DECODER", "1", "0"), "deconv": ("P3DUNET_DECONV", "phase", "xla")}
DECODER_2D_TOL, DEFAULT_SPREAD = 1e-4, 0.02
CHECK_STEPS = 8  # Adam steps before (b)'s and (c)'s gradient check


def switched(name, value, fn):
    """fn() with the environment variable `name` set to `value`, restored after."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        return fn()
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def in_turns(fns):
    """({path: mean of its two readings}, {path: [readings]}): each fn() (a
    median of CUDA-event timings) called in the order a, b, b, a."""
    order = list(fns) + list(reversed(fns))
    times = {path: [] for path in fns}
    for path in order:
        times[path].append(fns[path]())
    return {path: sum(v) / len(v) for path, v in times.items()}, times


def decoder_phase(device, batch, smi):
    """Phase 31: the fused decoder (UNet3D, UNet2D bcr) and the phase deconv
    (ResidualUNet3D) against the generic decoder and cuDNN's transposed conv:
    values, launches, times, profiles, the kernels at the shapes these paths
    give them, and the rule's reading for each default. `batch` is phase 7's
    train batch. Returns the launches of each path by kernel and dtype, and
    for the kernels line the per-shape rows and K2's and K3's largest errors
    by dtype at those shapes."""
    import torch.nn.functional as F

    from pytorch3dunet_tpu_torch.losses import get_loss_criterion
    from pytorch3dunet_tpu_torch.models.unet import get_model, kernel_conv_plan
    from pytorch3dunet_tpu_torch.ops.conv3d import (conv3d_fwd, conv3d_fwd_reference, conv3d_input_grad,
                                                    conv3d_input_grad_reference, flip_weight, plain_conv)
    from pytorch3dunet_tpu_torch.ops.upconv import (DECONV_DEFAULT, FUSED_DECODER_DEFAULT, _phase_embed,
                                                    collapse_deconv_kernels)

    launches = {}
    readings = {}
    patch_in = tuple(p + 2 * h for p, h in zip(PATCH, HALO))
    gen = torch.Generator(device=device).manual_seed(SEED + 31)
    inp, target = (torch.from_numpy(t).to(device) for t in batch)
    criterion = get_loss_criterion({"loss": dict(TRAIN_SECTIONS["loss"])})

    def seeded(config, dtype=None):
        torch.manual_seed(SEED)
        model = get_model({**config, **({"dtype": dtype} if dtype else {})})
        randomize_group_norms(model, torch.Generator().manual_seed(SEED + 31))
        return model.to(device)

    def forwards(tag, switch, config, tapfold=False):
        """(a) / (c): the patch forward on each path, f32 and bf16."""
        name, new, old = DECODER_SWITCHES[switch]
        x = torch.randn((1, 1, *patch_in), generator=gen, device=device)
        model = seeded(config).eval()
        with torch.inference_mode(), plain_conv():
            ref = switched(name, old, lambda: model(x)[0])
        f32_out = None
        for dtype in (None, "bfloat16"):
            m = model if dtype is None else seeded(config, dtype).eval()
            suffix = "" if dtype is None else "_bf16"

            def fwd():
                with torch.inference_mode():
                    return m(x)[0]

            outs, ms = {}, {}
            for path, value in (("new", new), ("generic", old)):
                key = f"{tag}_{path}_forward{suffix}"
                outs[path] = switched(name, value, lambda: count_launches(launches, key, fwd))
                n = switched(name, value, lambda: plan_launches(m, patch_in))
                want = (n.k2, 0) if dtype is None else (0, n.k2)
                want1 = (n.k1, 0) if dtype is None else (0, n.k1)
                expect_launches(launches, key, k2=want, k1=want1, gn=(n.gn, 0) if dtype is None else (0, n.gn))
            if dtype is None:
                errs = {p: (o - ref).abs().max().item() for p, o in outs.items()}
                check(max(errs.values()) <= FORWARD_TOL,
                      f"31 {tag} f32 forwards against the generic plain one: {errs}")
                f32_out = outs["new"]
            else:
                with plain_conv():
                    ref16 = switched(name, old, fwd)
                errs = {p: (o.float() - ref16.float()).abs().max().item() for p, o in outs.items()}
                errs_f32 = {p: (o.float() - f32_out).abs().max().item() for p, o in outs.items()}
                check(max(errs.values()) <= BF16_VS_PLAIN_TOL and max(errs_f32.values()) <= BF16_VS_F32_TOL,
                      f"31 {tag} bf16 forwards: vs the generic bf16 plain one {errs}, vs the f32 one {errs_f32}")
                errs = {**errs, **{f"{p} vs f32": e for p, e in errs_f32.items()}}
            means, runs = in_turns({p: (lambda v=v: switched(name, v, lambda: timed_ms(fwd, runs=3)))
                                    for p, v in (("generic", old), ("new", new))})
            readings[f"{tag} forward{suffix}"] = means
            log(f"[31 {tag}] one {patch_in} forward{' bf16' if dtype else ''}: {name}={new} {means['new']:.2f} ms, "
                f"{name}={old} {means['generic']:.2f} ms (medians in turns {runs}); launches "
                f"{launches[f'{tag}_new_forward{suffix}']} vs {launches[f'{tag}_generic_forward{suffix}']}; max|d| "
                f"{', '.join(f'{p} {e:.3e}' for p, e in errs.items())} ({smi})")
            for value in (new, old) if tag == "unet3d" else ():
                switched(name, value, lambda: profile_step(fwd, top=8, tag=f"31 {tag} profile",
                                                           what=f"one {tag} forward{suffix}, {name}={value}"))
            del m
        del model, ref, f32_out
        torch.cuda.empty_cache()

    def step(tag, switch, config):
        """(b) / (c): from CHECK_STEPS Adam steps on the new path and GroupNorm
        affines drawn anew (phase 7's state: trained weights, random affines),
        one step's grads on the new path held to a float64 plain step by phase
        13's gate, beside the generic path's distance from it; then the f32
        step (forward + backward + Adam at the recipe's rate) on phase 7's
        batch, timed on each path in turns. The steps that reach the checked
        state run on cuDNN's deterministic algorithms (K1-K3 are), so that
        state is the same in every run. After steps on cuDNN's default
        algorithms it differs from run to run, and the ResidualUNet3D's two
        deepest deconv weights (max|g| ~1e-5, the mean |g| ~1e-7) are so
        ill-conditioned there that the plain f32 step sat 4.6e-3 of max|g|
        from float64 in one state while the kernels sat 5e-5, and the kernels
        5.7e-3 from the plain step in another."""
        name, new, old = DECODER_SWITCHES[switch]
        model = seeded(config).train()
        optimizer = torch.optim.Adam(model.parameters(), lr=TRAIN_SECTIONS["optimizer"]["learning_rate"])

        def train_step():
            optimizer.zero_grad(set_to_none=True)
            criterion(model(inp)[1], target).backward()
            optimizer.step()

        torch.backends.cudnn.deterministic = True
        try:
            for _ in range(CHECK_STEPS):
                switched(name, new, train_step)
            randomize_group_norms(model, torch.Generator().manual_seed(SEED + 32))
            grads = switched(name, new, lambda: count_launches(launches, f"{tag}_new_step",
                                                               lambda: grads_of_step(model, criterion, inp, target)))
            grads_old = switched(name, old, lambda: grads_of_step(model, criterion, inp, target))
            with plain_conv():
                grads_plain = switched(name, new, lambda: grads_of_step(model, criterion, inp, target))
                grads64 = switched(name, new, lambda: grads_of_step(copy.deepcopy(model).double(), criterion, inp,
                                                                    target, torch.float64))
        finally:
            torch.backends.cudnn.deterministic = False
        n = switched(name, new, lambda: plan_launches(model, TRAIN_PATCH))
        expect_launches(launches, f"{tag}_new_step", k2=(n.k2, 0), k3=(n.k3, 0), k1=(n.k1, 0))
        err_k, err_old, err_p = ({k: worst_rel({k: g[k]}, grads64)[0] for k in g}
                                 for g in (grads, grads_old, grads_plain))
        margin = min((2 * err_p[k] + RES_GRAD_TOL - err_k[k], k) for k in grads)
        vs_plain = worst_rel(grads, grads_plain)
        vs_plain_each = {k: worst_rel({k: grads[k]}, grads_plain)[0] for k in grads}
        max_g = {k: g.abs().max().item() for k, g in grads64.items()}
        del grads, grads_old, grads_plain, grads64
        means, runs = in_turns({p: (lambda v=v: switched(name, v, lambda: timed_ms(train_step, runs=3)))
                                for p, v in (("generic", old), ("new", new))})
        readings[f"{tag} step"] = means
        log(f"[31 {tag}] one f32 step of {TRAIN_PATCH} (forward + backward + Adam): {name}={new} "
            f"{means['new']:.2f} ms, {name}={old} {means['generic']:.2f} ms (medians in turns {runs}); launches "
            f"{launches[f'{tag}_new_step']}; grads after {CHECK_STEPS} deterministic steps against a float64 plain "
            f"step: kernels worst {max(err_k.values()):.3e} ({max(err_k, key=err_k.get)}; {name}={old}: "
            f"{max(err_old.values()):.3e}), plain f32 worst {max(err_p.values()):.3e}, least margin to 2 x plain + "
            f"{RES_GRAD_TOL}: {margin[0]:.3e} ({margin[1]}); vs the plain f32 step {vs_plain[0]:.3e} ({vs_plain[1]}) "
            f"({smi})")
        if margin[0] < 0 or vs_plain[0] > VS_PLAIN_CAP:
            for k in sorted(err_k, key=lambda k: 2 * err_p[k] - err_k[k])[:8]:
                log(f"[31 {tag}] {k}: kernels {err_k[k]:.3e}, {name}={old} {err_old[k]:.3e}, plain f32 "
                    f"{err_p[k]:.3e} from float64, kernels vs plain {vs_plain_each[k]:.3e}, max|g| {max_g[k]:.3e}")
        check(margin[0] >= 0 and vs_plain[0] <= VS_PLAIN_CAP,
              f"31 {tag} step grads: margin {margin}, vs the plain f32 step {vs_plain}")
        del model, optimizer
        torch.cuda.empty_cache()

    # (a) the confocal UNet3D forward with the fused decoder
    forwards("unet3d", "fused", MODEL)
    # (d) K2 and K3 at the shapes these paths give them
    cases, seen = [], set()
    for config, (name, new, _) in ((MODEL, DECODER_SWITCHES["fused"]), (RES_MODEL, DECODER_SWITCHES["deconv"])):
        model = get_model(config)
        for patch in (patch_in, TRAIN_PATCH):
            for conv, shape, f, _, _ in switched(name, new, lambda: kernel_conv_plan(model, patch)):
                key = (shape, f, "upsampling" in conv)  # a deconv is also timed against F.conv_transpose3d
                if ("[" in conv or "upsampling" in conv) and key not in seen:
                    seen.add(key)
                    cases.append((f"{config['name']} {conv}", shape, f))
    log(f"[31 K2/K3] {len(cases)} conv shapes of the fused decoders' two branches and the phase deconvs")
    errors, failed = check_kernel("K2", lambda x, w, b: conv3d_fwd(x, w, b, variant="roll"), conv3d_fwd_reference,
                                  [(n, s, f, False) for n, s, f in cases], gen, device, phase=31)
    check(not failed, f"K2 disagrees with the plain version at the decoder shapes: {failed}")
    dgrads = [(f"dgrad {n}", (*s[:4], f), s[4]) for n, s, f in cases]
    errors_k3, failed = check_kernel("K3", lambda dy, w, _: conv3d_input_grad(dy, w.transpose(3, 4)),
                                     lambda dy, w, _: conv3d_input_grad_reference(dy, w.transpose(3, 4)),
                                     [(n, s, c, False) for n, s, c in dgrads], gen, device, phase=31)
    check(not failed, f"K3 disagrees with its plain version at the decoder shapes: {failed}")
    rows = []

    def quick(fn):
        return timed_ms(fn, runs=3)

    with torch.inference_mode():
        for (name, shape, f), (_, dy_shape, c) in zip(cases, dgrads):
            deconv = "upsampling" in name
            x, w, _ = conv_inputs(shape, f, torch.float32, False, gen, device)
            row = {"conv": name, "x": shape, "F": f, "k2_ms": quick(lambda: conv3d_fwd(x, w, None, "roll")),
                   "plain_ms": quick(lambda: conv3d_fwd_reference(x, w)),
                   "k2_bf16_ms": quick(lambda: conv3d_fwd(x.bfloat16(), w.bfloat16(), None, "roll")),
                   "bound_ms": tc_bound(shape, f, False)[0],
                   "bound_bf16_ms": tc_bound(shape, f, False, torch.bfloat16)[0]}
            if deconv:
                # the same function as one cuDNN call: the transposed conv of x with a torch weight
                weight = torch.randn((shape[4], f // 8, 3, 3, 3), generator=gen, device=device)
                weight = weight / (27 * shape[4]) ** 0.5
                kernel = weight.flip(2, 3, 4).permute(2, 3, 4, 0, 1)
                embedded = _phase_embed(collapse_deconv_kernels(kernel))
                x_ncdhw = x.permute(0, 4, 1, 2, 3)
                want = F.conv_transpose3d(x_ncdhw, weight, stride=2, padding=1)
                got = conv3d_fwd(x, embedded, None, "roll")
                got = got.reshape(*shape[:4], 2, 2, 2, f // 8).permute(0, 7, 1, 4, 2, 5, 3, 6).reshape(
                    1, f // 8, *(2 * s for s in shape[1:4]))[:, :, :-1, :-1, :-1]
                err = (got - want).abs().max().item() / want.abs().max().item()
                check(err <= TOL[torch.float32], f"31 {name}: K2 + depth-to-space vs F.conv_transpose3d {err}")
                row["library_ms"] = quick(lambda: F.conv_transpose3d(x_ncdhw, weight, stride=2, padding=1))
                row["library_call"] = f"F.conv_transpose3d (max|d| / max {err:.2e})"
            else:
                row["library_ms"] = quick(lambda: library_conv(x, w, None))
                row["library_call"] = "F.conv3d of the embedded kernel"
            dy, wt, _ = conv_inputs(dy_shape, c, torch.float32, False, gen, device)
            w_fwd = wt.transpose(3, 4).contiguous()
            w_flip = flip_weight(w_fwd).permute(4, 3, 0, 1, 2)
            row.update({"dy": dy_shape, "C": c, "k3_ms": quick(lambda: conv3d_input_grad(dy, w_fwd)),
                        "k3_plain_ms": quick(lambda: conv3d_input_grad_reference(dy, w_fwd)),
                        "k3_library_ms": quick(lambda: F.conv3d(dy.permute(0, 4, 1, 2, 3), w_flip, padding=1)),
                        "k3_bf16_ms": quick(lambda: conv3d_input_grad(dy.bfloat16(), w_fwd.bfloat16())),
                        "k3_bound_ms": tc_bound(dy_shape, c, False)[0]})
            rows.append(row)
            log(f"[31 K2/K3] {name:58s} x{shape} F={f:<4d} K2 {row['k2_ms']:.3f} ms (3xTF32 bound "
                f"{row['bound_ms']:.3f}, bf16 {row['k2_bf16_ms']:.3f} vs bound {row['bound_bf16_ms']:.3f}) | plain "
                f"{row['plain_ms']:.3f} | {row['library_call']} {row['library_ms']:.3f} || K3 dy{dy_shape} -> "
                f"C={c}: "
                f"{row['k3_ms']:.3f} ms (bound {row['k3_bound_ms']:.3f}, bf16 {row['k3_bf16_ms']:.3f}) | plain "
                f"{row['k3_plain_ms']:.3f} | F.conv3d flipped {row['k3_library_ms']:.3f} ({smi})")
            del x, w, dy, wt, w_fwd, w_flip
    torch.cuda.empty_cache()

    # (b) its step
    step("unet3d", "fused", MODEL)
    # (c) the light-sheet ResidualUNet3D with the phase deconv, under P3DUNET_TAPFOLD=1 as phases 11-14
    os.environ["P3DUNET_TAPFOLD"] = "1"
    try:
        forwards("resunet", "deconv", RES_MODEL)
        step("resunet", "deconv", RES_MODEL)
    finally:
        os.environ.pop("P3DUNET_TAPFOLD", None)

    # (e) the DSB2018 UNet2D (bcr): one train-mode forward at its batch on each path
    x2 = torch.randn((DSB_BATCH, 1, *DSB_CROP), generator=gen, device=device)
    name, new, old = DECODER_SWITCHES["fused"]
    torch.manual_seed(SEED)
    base = get_model(dict(DSB_MODEL)).to(device)
    results, models = {}, {}
    for path, value in (("new", new), ("generic", old)):
        models[path] = copy.deepcopy(base).train()
        key = f"dsb_{path}_train_forward"
        logits = switched(name, value, lambda: count_launches(launches, key, lambda: models[path](x2)[1].detach()))
        expect_launches(launches, key)
        results[path] = (logits, {k: v.clone() for k, v in models[path].named_buffers()})
    (new_logits, new_buf), (old_logits, old_buf) = results["new"], results["generic"]
    err = (new_logits - old_logits).abs().max().item() / old_logits.abs().max().item()
    buf_err = max(((new_buf[k].double() - v.double()).abs().max() / v.double().abs().max().clamp_min(1e-30)).item()
                  for k, v in old_buf.items())
    check(err <= DECODER_2D_TOL and buf_err <= DECODER_2D_TOL and all(
        int(v) == 1 for k, v in new_buf.items() if k.endswith("num_batches_tracked")),
        f"31 dsb: fused vs generic logits {err}, running statistics {buf_err}")
    means, runs = in_turns({p: (lambda v=v, p=p: switched(name, v, lambda: timed_ms(lambda: models[p](x2))))
                            for p, v in (("generic", old), ("new", new))})
    readings["dsb train forward"] = means
    log(f"[31 dsb] UNet2D bcr train-mode forward of {DSB_BATCH} x {DSB_CROP}: fused {means['new']:.2f} ms, generic "
        f"{means['generic']:.2f} ms (medians in turns {runs}); logits max|d| / max {err:.2e}, running statistics "
        f"{buf_err:.2e} (tol {DECODER_2D_TOL}); 0 K1/K2/K3 ({smi})")
    del base, models, results, x2
    torch.cuda.empty_cache()

    # the rule for the port's defaults
    for switch, keys in (("fused", ("unet3d forward", "unet3d forward_bf16", "unet3d step")),
                         ("deconv", ("resunet forward", "resunet step"))):
        name, new, old = DECODER_SWITCHES[switch]
        ratios = {k: readings[k]["new"] / readings[k]["generic"] for k in keys}
        verdict = new if all(r <= 1 + DEFAULT_SPREAD for r in ratios.values()) else old
        default = FUSED_DECODER_DEFAULT if switch == "fused" else DECONV_DEFAULT
        log(f"[31 rule] {name}: new / generic {', '.join(f'{k} {r:.4f}' for k, r in ratios.items())} -> the rule "
            f"picks {name}={verdict}; the port's default is {default} ({smi})")
    return launches, {"rows": rows, "errors_k2": errors, "errors_k3": errors_k3}


# phase 32: every GroupNorm input of one 112x234x234 forward of each model, the
# kernel against its plain version and float64. Its tolerance is torch's own
# GroupNorm gap to float64 on the same inputs, as the port called it before
# (F.group_norm in float32; a bf16 input through a float32 copy, rounded once),
# the largest over the phase's inputs of each dtype: the kernel is held no
# looser than torch. bf16 outputs are compared with the float64 result rounded
# once to bf16
GN_MODELS = (("UNet3D f32", MODEL, None), ("ResidualUNet3D bf16", RES_MODEL, "bfloat16"))


def group_norm_inputs(model, x):
    """(module, copy of its input) of every GroupNorm module call of one
    forward of `model` on x, in order, and the forward's GroupNorm launch pairs."""
    from pytorch3dunet_tpu_torch.models.blocks import GroupNorm
    from pytorch3dunet_tpu_torch.ops import group_norm

    calls = []

    def record(module, args):
        calls.append((module, args[0].clone(memory_format=torch.preserve_format)))

    hooks = [m.register_forward_pre_hook(record) for m in model.modules() if isinstance(m, GroupNorm)]
    try:
        before = group_norm.launches
        with torch.inference_mode():
            model(x)
        torch.cuda.synchronize()
        launches = group_norm.launches - before
    finally:
        for hook in hooks:
            hook.remove()
    return calls, launches


def group_norm_phase(device, smi):
    """Phase 32: the GroupNorm kernel (csrc/group_norm.cu through
    `group_norm_op`) at every GroupNorm input of one forward of the confocal
    UNet3D (f32) and the light-sheet ResidualUNet3D (bf16) on a halo'd
    112x234x234 patch: against its plain version and float64, torch's own gap
    beside it as the tolerance, a repeat bitwise equal, y's strides x's; its
    time beside its bound (two reads and one write of x at the HBM rate), the
    plain version and one F.group_norm call (the yardstick, as the port called
    it before); the launch pairs a forward. Returns the kernels line's entry."""
    import torch.nn.functional as F

    from pytorch3dunet_tpu_torch.models.unet import get_model
    from pytorch3dunet_tpu_torch.ops import build, group_norm

    patch_in = tuple(p + 2 * h for p, h in zip(PATCH, HALO))
    gen_cpu = torch.Generator().manual_seed(SEED + 32)
    rows, per_model = [], {}
    for tag, config, dtype_name in GN_MODELS:
        torch.manual_seed(SEED + 32)
        model = get_model({**config, **({"dtype": dtype_name} if dtype_name else {})})
        randomize_group_norms(model, gen_cpu)
        model = model.to(device).eval()
        x0 = torch.randn((1, 1, *patch_in), generator=torch.Generator(device=device).manual_seed(SEED + 32),
                         device=device)
        calls, launches = group_norm_inputs(model, x0)
        planned = plan_launches(model, patch_in).gn
        check(launches == len(calls) == planned > 0, f"{tag}: {launches} GroupNorm launch pairs for {len(calls)} "
                                                     f"module calls, {planned} planned")
        per_model[tag] = {"launches_per_forward": launches, "module_calls": len(calls)}
        with torch.inference_mode():
            for i, (norm, x) in enumerate(calls):
                G, w, b, eps = norm.num_groups, norm.weight, norm.bias, norm.eps
                layout = group_norm.launch_layout(x)
                y = group_norm.group_norm_op(x, w, b, G, eps)
                repeat = group_norm.group_norm_op(x, w, b, G, eps)
                plain = group_norm.group_norm_reference(x, w, b, G, eps)
                want = F.group_norm(x.double(), G, w.double(), b.double(), eps)
                torch_y = F.group_norm(x.float(), G, w, b, eps).to(x.dtype)
                if x.dtype == torch.bfloat16:
                    want_cmp = want.to(torch.bfloat16).double()
                else:
                    want_cmp = want
                scale = want.abs().max().item()
                row = {"model": tag, "call": i, "x": tuple(x.shape), "dtype": str(x.dtype)[6:], "groups": G,
                       "layout": {None: "other", (0, True): "nc", (0, False): "nc scalar",
                                  (1, True): "channels_last", (1, False): "channels_last scalar"}[layout],
                       "err": (y.double() - want_cmp).abs().max().item() / scale,
                       "torch_err": (torch_y.double() - want_cmp).abs().max().item() / scale,
                       "plain_err": (plain.double() - want_cmp).abs().max().item() / scale,
                       "vs_plain": (y.double() - plain.double()).abs().max().item() / scale,
                       "bitwise_repeat": torch.equal(y, repeat), "strides_kept": y.stride() == x.stride()}
                row["kernel_ms"] = timed_ms(lambda: group_norm.group_norm_op(x, w, b, G, eps))
                row["plain_ms"] = timed_ms(lambda: group_norm.group_norm_reference(x, w, b, G, eps))
                row["library_ms"] = timed_ms(lambda: F.group_norm(x.float(), G, w, b, eps).to(x.dtype))
                row["bound_ms"] = 3 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
                rows.append(row)
                del y, repeat, plain, want, want_cmp, torch_y
        del calls, model, x0
        torch.cuda.empty_cache()
    tol = {dtype: max(r["torch_err"] for r in rows if r["dtype"] == dtype) for dtype in {r["dtype"] for r in rows}}
    for r in rows:
        r["ok"] = (r["err"] <= tol[r["dtype"]] and r["vs_plain"] <= 2 * tol[r["dtype"]] and r["bitwise_repeat"]
                   and r["strides_kept"] and r["layout"] != "other")
        log(f"[32 group_norm] {r['model']:20s} #{r['call']:<2d} x{r['x']} {r['dtype']:8s} G={r['groups']} "
            f"{r['layout']:13s} vs float64 {r['err']:.3e} (torch's F.group_norm {r['torch_err']:.3e}, plain "
            f"{r['plain_err']:.3e}; tol {tol[r['dtype']]:.3e}) vs plain {r['vs_plain']:.3e} repeat "
            f"{'bitwise' if r['bitwise_repeat'] else 'DIFFERS'} strides {'kept' if r['strides_kept'] else 'CHANGED'} | "
            f"kernel {r['kernel_ms']:.3f} ms (bound {r['bound_ms']:.3f}) plain {r['plain_ms']:.3f} F.group_norm "
            f"{r['library_ms']:.3f} {'ok' if r['ok'] else 'FAIL'}")
    failed = [(r["model"], r["call"]) for r in rows if not r["ok"]]
    check(not failed, f"the GroupNorm kernel fails at {failed}")
    sums = {}
    for tag in per_model:
        mine = [r for r in rows if r["model"] == tag]
        sums[tag] = {key: sum(r[key] for r in mine) for key in ("kernel_ms", "bound_ms", "plain_ms", "library_ms")}
        sums[tag].update(per_model[tag], bytes_read_twice_written_once=sum(
            3 * int(np.prod(r["x"])) * (2 if r["dtype"] == "bfloat16" else 4) for r in mine))
        log(f"[32 group_norm] {tag}: {per_model[tag]['launches_per_forward']} launch pairs a forward "
            f"({per_model[tag]['module_calls']} GroupNorm module calls); kernel {sums[tag]['kernel_ms']:.3f} ms | "
            f"bound {sums[tag]['bound_ms']:.3f} ms | plain {sums[tag]['plain_ms']:.3f} ms | F.group_norm "
            f"{sums[tag]['library_ms']:.3f} ms ({smi})")
    log(f"[32 group_norm] tolerance = torch's own gap to float64, the largest of each dtype: {tol}")
    first = GN_MODELS[0][0]
    return {"name": group_norm.KERNEL, "route": "cuda", "source": "pytorch3dunet_tpu_torch/csrc/group_norm.cu",
            "replaces": None, "ms": sums[first]["kernel_ms"], "plain_ms": sums[first]["plain_ms"],
            "bound_ms": sums[first]["bound_ms"], "bound_by": "bytes", "library_ms": sums[first]["library_ms"],
            "library_call": "F.group_norm(x.float(), G, w, b).to(x.dtype)", "by_model": sums,
            "max_err_vs_float64": {d: max(r["err"] for r in rows if r["dtype"] == d) for d in tol},
            "torch_err_vs_float64": tol, "ptxas": ptxas_report(build.build_logs.get(group_norm.KERNEL, "")),
            "work": f"the {per_model[first]['module_calls']} GroupNorm forwards of one UNet3D "
                    f"{'x'.join(map(str, patch_in))} patch, f32"}


def synthetic_batch(rs):
    """One (raw, target) batch of the confocal recipe's shape: an instance
    label of ~60 Voronoi cells, its (boundary, label) target as the recipe's
    StandardLabelToBoundary(append_label=True) makes it (a voxel is boundary
    where its 18-neighbourhood holds another label: the thick boundary at
    connectivity 2), and a standardized raw whose signal is the boundary plus
    noise."""
    from scipy import ndimage
    from scipy.spatial import cKDTree

    grid = np.stack(np.meshgrid(*(np.arange(s, dtype=np.float32) for s in TRAIN_PATCH), indexing="ij"), -1)
    seeds = rs.rand(60, 3) * np.array(TRAIN_PATCH)
    label = cKDTree(seeds).query(grid.reshape(-1, 3))[1].reshape(TRAIN_PATCH) + 1
    footprint = ndimage.generate_binary_structure(3, 2)
    boundary = (ndimage.maximum_filter(label, footprint=footprint, mode="nearest")
                != ndimage.minimum_filter(label, footprint=footprint, mode="nearest"))
    target = np.stack([boundary, label]).astype(np.float32)
    raw = target[0] + 0.5 * rs.randn(*TRAIN_PATCH).astype(np.float32)
    raw = (raw - raw.mean()) / raw.std()
    return raw[None, None].astype(np.float32), target[None]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from pytorch3dunet_tpu_torch.models.unet import get_model
    from pytorch3dunet_tpu_torch.ops import build
    from pytorch3dunet_tpu_torch.ops.conv3d import (Conv3d, Conv3dFunction, conv3d_fwd, conv3d_fwd_reference,
                                                    conv3d_input_grad, conv3d_input_grad_reference, flip_weight,
                                                    plain_conv)
    from pytorch3dunet_tpu_torch.predictor import StandardPredictor
    from pytorch3dunet_tpu_torch.trainer import create_trainer
    from pytorch3dunet_tpu_torch.utils.checkpoint import load_checkpoint

    device = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # phases 1-9 run the default forward (K2); phases 11-14 set the switch
    os.environ.pop("P3DUNET_TAPFOLD", None)

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[1 device] {torch.cuda.get_device_name(0)} | torch {torch.__version__} | CUDA {torch.version.cuda} | "
        f"nvidia-smi: {smi}")

    # 2. build
    start = time.perf_counter()
    libs = build.load_all()
    log(f"[2 build] {', '.join(build.SIGNATURES)} built and loaded in {time.perf_counter() - start:.1f} s")
    ptxas = {name: ptxas_report(build.build_logs.get(name, "")) for name in libs}
    for name, lib in libs.items():
        arrives = 0
        for line in build.build_logs.get(name, "").splitlines():
            if "(C7519)" in line:  # a warpgroup.arrive ptxas adds before a wgmma: counted, not printed
                arrives += 1
            elif "registers" in line or "spill" in line or "smem" in line:
                log(f"[2 build]   {name}: {line.strip()}")
        if arrives:
            log(f"[2 build]   {name}: ptxas injected {arrives} warpgroup.arrive (C7519)")
        if f"{name}_smem_bytes" in build.SIGNATURES[name]:
            ptxas[name]["smem_bytes"] = getattr(lib, f"{name}_smem_bytes")()
            log(f"[2 build]   {name}: {ptxas[name]['smem_bytes']} bytes of dynamic shared memory per block (f32)")
        log(f"[2 build]   {name}: ptxas per instantiation {ptxas[name]}")

    # 3. kernels vs plain
    torch.manual_seed(SEED)
    model = get_model(MODEL)
    patch_in = tuple(p + 2 * h for p, h in zip(PATCH, HALO))
    shapes = path_conv_shapes(model, patch_in)
    train_dgrads = dgrad_shapes(model, TRAIN_PATCH)
    gen = torch.Generator(device=device).manual_seed(SEED)
    edges = [(f"edge{i}", case[:5], case[5], case[6]) for i, case in enumerate(EDGE_CASES)]
    k2_cases = [(name, shape, f, True) for name, shape, f in shapes]
    k2_cases += [(f"train {name}", shape, f, True) for name, shape, f in path_conv_shapes(model, TRAIN_PATCH)]
    errors, failed = check_kernel("K2", conv3d_fwd, conv3d_fwd_reference, k2_cases + edges, gen, device)
    check(not failed, f"K2 disagrees with the plain version: {failed}")
    dgrad_cases = [(f"dgrad {name}", shape, c, False) for name, shape, c in train_dgrads]
    errors_k3, failed = check_kernel("K3", lambda x, w, b: conv3d_fwd(x, w, b, variant="packw"),
                                     conv3d_fwd_reference, dgrad_cases + edges, gen, device)
    check(not failed, f"K3 disagrees with the plain version: {failed}")

    # 4. predict path at full width
    gen_cpu = torch.Generator().manual_seed(SEED)
    randomize_group_norms(model, gen_cpu)
    model = model.to(device).eval()
    predictor = StandardPredictor(model, None, MODEL["out_channels"], device)
    rs = np.random.RandomState(SEED)
    zz, yy, xx = np.meshgrid(*(np.linspace(0, 6 * np.pi, s, dtype=np.float32) for s in VOLUME), indexing="ij")
    volume = (np.sin(zz) * np.cos(yy) * np.sin(xx) + 0.5 * rs.rand(*VOLUME)).astype(np.float32)
    patches = list(predictor.patches(volume, PATCH, STRIDE, HALO, TRANSFORMER))
    n = plan_launches(model, patch_in)
    n_conv = n.k2

    launches = {}
    start = time.perf_counter()
    out = count_launches(launches, "predict", lambda: predictor.predict_array(volume, PATCH, STRIDE, HALO,
                                                                              TRANSFORMER))
    first_s = time.perf_counter() - start
    log(f"[4 predict] predict_array {VOLUME} -> {out.shape} in {first_s:.2f} s (first call); "
        f"{len(patches)} patches of {patch_in}, launches {launches['predict']} (expected f32 conv3d_fwd "
        f"{n_conv} x {len(patches)}, group_norm {n.gn} x {len(patches)}, no other)")
    expect_launches(launches, "predict", k2=(n_conv * len(patches), 0), gn=(n.gn * len(patches), 0))
    check(out.shape == (MODEL["out_channels"], *VOLUME), f"output shape {out.shape}")
    check(np.isfinite(out).all() and out.min() >= 0 and out.max() <= 1, f"output in [{out.min()}, {out.max()}]")

    x0 = torch.from_numpy(patches[0][0][None]).to(device)
    with torch.inference_mode():
        Conv3d.input_copies = 0
        probs = model(x0)[0]
        copies = Conv3d.input_copies
        with plain_conv():
            probs_plain = model(x0)[0]
    err = (probs - probs_plain).abs().max().item()
    core = probs[0, 0, HALO[0]:-HALO[0], HALO[1]:-HALO[1], HALO[2]:-HALO[2]].cpu().numpy()
    stitched = out[(0, *patches[0][1])]
    log(f"[4 predict] patch 0: kernel vs plain forward max|d| = {err:.3e} (tol {FORWARD_TOL}); "
        f"stitched == patch core: {np.array_equal(core, stitched)}; layout copies per forward: {copies}; "
        f"probs in [{out.min():.4f}, {out.max():.4f}], mean {out.mean():.4f}")
    check(err <= FORWARD_TOL, f"kernel forward differs from the plain forward by {err}")
    check(np.array_equal(core, stitched), "stitched prediction differs from the patch forward")

    # 5. predict times
    times = []
    with torch.inference_mode():
        for name, shape, f in shapes:
            row = {"conv": name, "x": shape, "F": f}
            x, w, b = conv_inputs(shape, f, torch.float32, True, gen, device)
            row["kernel_ms"] = timed_ms(lambda: conv3d_fwd(x, w, b))
            row["plain_ms"] = timed_ms(lambda: conv3d_fwd_reference(x, w, b))
            row["plain_tf32_ms"] = with_tf32(lambda: timed_ms(lambda: conv3d_fwd_reference(x, w, b)))
            row["library_ms"] = timed_ms(lambda: library_conv(x, w, b))
            row["library_tf32_ms"] = with_tf32(lambda: timed_ms(lambda: library_conv(x, w, b)))
            xb, wb, bb = x.bfloat16(), w.bfloat16(), b.bfloat16()
            row["kernel_bf16_ms"] = timed_ms(lambda: conv3d_fwd(xb, wb, bb))
            row["library_bf16_ms"] = timed_ms(lambda: library_conv(xb, wb, bb))
            row["bound_ms"] = tc_bound(shape, f)[0]
            row["bound_ffma_ms"] = conv_bound(shape, f)[0]
            row["bound_tc_bf16_ms"] = tc_bound(shape, f, dtype=torch.bfloat16)[0]
            row["useful_macs"] = 27 * int(np.prod(shape)) * f
            row["issued_macs"] = libs["conv3d_fwd"].conv3d_fwd_issued_macs(*shape, f, 0)
            row["kernel_tflops"] = 2 * row["useful_macs"] / row["kernel_ms"] / 1e9
            times.append(row)
            log(f"[5 conv] {name:42s} x{shape} F={f:<3d} K2 {row['kernel_ms']:.3f} ms "
                f"({row['kernel_tflops']:.1f} TFLOP/s useful, 3xTF32 bound {row['bound_ms']:.3f}, FFMA "
                f"{row['bound_ffma_ms']:.3f}, MMAs issued / useful {row['issued_macs'] / row['useful_macs']:.3f}) | "
                f"cuDNN F.conv3d {row['library_ms']:.3f}, TF32 {row['library_tf32_ms']:.3f} | plain "
                f"{row['plain_ms']:.3f}, TF32 {row['plain_tf32_ms']:.3f} | K2 bf16 {row['kernel_bf16_ms']:.3f} ms "
                f"(bf16 bound {row['bound_tc_bf16_ms']:.3f}, cuDNN bf16 {row['library_bf16_ms']:.3f})")
            del x, w, b, xb, wb, bb
        k2_sums = {key: sum(r[key] for r in times) for key in times[0] if key.endswith(("_ms", "_macs"))}
        conv_ms, plain_ms, plain_tf32_ms = k2_sums["kernel_ms"], k2_sums["plain_ms"], k2_sums["plain_tf32_ms"]
        mma_ratio = k2_sums["issued_macs"] / k2_sums["useful_macs"]
        tflop = 2 * k2_sums["useful_macs"] / 1e12
        log(f"[5 conv] all {n_conv} convs of one forward ({tflop:.3f} TFLOP): K2 {conv_ms:.2f} ms | 3xTF32 bound "
            f"{k2_sums['bound_ms']:.2f}, FFMA {k2_sums['bound_ffma_ms']:.2f} | MMAs issued / useful {mma_ratio:.4f} | "
            f"cuDNN {k2_sums['library_ms']:.2f}, TF32 {k2_sums['library_tf32_ms']:.2f} | plain {plain_ms:.2f}, TF32 "
            f"{plain_tf32_ms:.2f} | K2 bf16 {k2_sums['kernel_bf16_ms']:.2f} ms (bf16 bound "
            f"{k2_sums['bound_tc_bf16_ms']:.2f}, cuDNN bf16 {k2_sums['library_bf16_ms']:.2f})")

        torch.cuda.reset_peak_memory_stats()
        fwd_ms = timed_ms(lambda: model(x0))
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        with plain_conv():
            fwd_plain_ms = timed_ms(lambda: model(x0))
            fwd_plain_tf32_ms = with_tf32(lambda: timed_ms(lambda: model(x0)))
    log(f"[5 forward] one {patch_in} patch: kernel {fwd_ms:.2f} ms | plain conv {fwd_plain_ms:.2f} ms | "
        f"plain conv TF32 {fwd_plain_tf32_ms:.2f} ms | peak memory {peak_gib:.2f} GiB")

    def forward():
        with torch.inference_mode():
            model(x0)

    profile_step(forward, tag="5 profile", what="one UNet3D patch forward")

    walls = []
    for _ in range(RUNS):
        start = time.perf_counter()
        predictor.predict_array(volume, PATCH, STRIDE, HALO, TRANSFORMER)
        walls.append(time.perf_counter() - start)
    wall = statistics.median(walls)
    log(f"[5 predict] predict_array {VOLUME}: median {wall:.3f} s of {RUNS} -> "
        f"{np.prod(VOLUME) / wall / 1e6:.3f} Mvoxel/s (runs: {', '.join(f'{t:.3f}' for t in walls)})")
    host = {"out": out, "wall_s": wall}
    del model, predictor, probs, probs_plain, x0
    torch.cuda.empty_cache()

    # 6. conv backward against autograd through F.conv3d
    levels_seen = set()
    for name, shape, f in path_conv_shapes(get_model(MODEL), TRAIN_PATCH):
        level = int(np.log2(TRAIN_PATCH[1] // shape[2]))
        if level > 2 or level in levels_seen:
            continue
        levels_seen.add(level)
        x, w, b = (t.requires_grad_() for t in conv_inputs(shape, f, torch.float32, True, gen, device))
        y = Conv3dFunction.apply(x, w, b)
        dy = torch.randn(y.shape, generator=gen, device=device)
        got = torch.autograd.grad(y, (x, w, b), dy)
        want = torch.autograd.grad(conv3d_fwd_reference(x, w, b), (x, w, b), dy)
        for grad_name, g, r in zip(("dx", "dw", "db"), got, want):
            err, tol = (g - r).abs().max().item(), BACKWARD_TOL * r.abs().max().item()
            log(f"[6 backward] {name:42s} x{shape} F={f:<3d} {grad_name}: max|d|={err:.3e} tol={tol:.3e} "
                f"{'ok' if err <= tol else 'FAIL'}")
            check(err <= tol, f"Conv3dFunction {grad_name} of {name} differs from autograd by {err}")
        del x, w, b, y, dy, got, want
    check(levels_seen == {0, 1, 2}, f"conv backward checked at levels {sorted(levels_seen)}")

    # 7. train path at full width
    rs = np.random.RandomState(SEED)
    train_batch, val_batch = synthetic_batch(rs), synthetic_batch(rs)
    losses = []
    with tempfile.TemporaryDirectory() as checkpoint_dir:
        config = {"manual_seed": SEED, "device": "cuda", "model": dict(MODEL), **TRAIN_SECTIONS,
                  "trainer": {"eval_score_higher_is_better": False, "checkpoint_dir": checkpoint_dir,
                              "validate_after_iters": VALIDATE_AFTER, "log_after_iters": 10**9,
                              "max_num_epochs": 10**9, "max_num_iterations": TRAIN_STEPS - 1}}
        trainer = create_trainer(config, loaders={"train": [train_batch], "val": [val_batch]})
        criterion = trainer.loss_criterion

        def recording_criterion(logits, target):
            loss = criterion(logits, target)
            if torch.is_grad_enabled():
                losses.append(loss.item())
            return loss

        trainer.loss_criterion = recording_criterion
        Conv3dFunction.grad_copies = 0
        start = time.perf_counter()
        count_launches(launches, "train", trainer.fit)
        fit_s = time.perf_counter() - start
        grad_copies = Conv3dFunction.grad_copies
        trainer.loss_criterion = criterion
        n_val = TRAIN_STEPS // VALIDATE_AFTER
        n_train = plan_launches(MODEL, TRAIN_PATCH)
        log(f"[7 train] fit: {TRAIN_STEPS} steps of {TRAIN_PATCH} + {n_val} validations in {fit_s:.2f} s; "
            f"launches {launches['train']} (GroupNorm only in the validations); dy layout copies per step "
            f"{grad_copies / TRAIN_STEPS:.1f}; losses {', '.join(f'{v:.5f}' for v in losses)}; "
            f"best val ARand {trainer.best_eval_score:.5f}")
        # the steps need gradients: their GroupNorms stay torch's, the validations' take the kernel
        expect_launches(launches, "train", k2=(n_train.k2 * (TRAIN_STEPS + n_val), 0),
                        k3=(n_train.k3 * TRAIN_STEPS, 0), gn=(n_train.gn * n_val, 0))
        check(len(losses) == TRAIN_STEPS and all(math.isfinite(v) for v in losses), f"losses {losses}")
        check(losses[-1] < losses[0], f"loss did not fall: {losses}")
        ckpt_path = Path(checkpoint_dir) / "last_checkpoint.pytorch"
        check(ckpt_path.exists(), "no last_checkpoint.pytorch written")
        state = load_checkpoint(ckpt_path)
        get_model(MODEL).load_state_dict(state["model_state_dict"], strict=True)
        log(f"[7 train] {ckpt_path.name}: {ckpt_path.stat().st_size / 2**20:.1f} MiB, num_iterations "
            f"{state['num_iterations']}, loads with strict=True")

    model, optimizer = trainer.model, trainer.optimizer
    inp = torch.from_numpy(train_batch[0]).to(device)
    target = torch.from_numpy(train_batch[1]).to(device)
    # the gradient check runs from seeded random GroupNorm affines: near the
    # default ones (weight 1, bias 0) the first GroupNorm's weight gradient is
    # zero by symmetry (the next GroupNorm cancels its scale through the
    # bias-free conv and the ReLU), so f32 roundoff is all there is of it
    randomize_group_norms(model, gen_cpu)

    def step_grads(m, dtype=torch.float32):
        m.zero_grad(set_to_none=True)
        criterion(m(inp.to(dtype))[1], target.to(dtype)).backward()
        return {name: p.grad.detach().double() for name, p in m.named_parameters()}

    def rel(a, b):
        return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)

    grads = step_grads(model)
    with plain_conv():
        grads_plain = step_grads(model)
        grads64 = step_grads(copy.deepcopy(model).double(), torch.float64)
    worst = max((rel(g, grads64[k]), k) for k, g in grads.items())
    worst_plain = max((rel(g, grads64[k]), k) for k, g in grads_plain.items())
    vs_plain = max((rel(g, grads_plain[k]), k) for k, g in grads.items())
    log(f"[7 train] one step's parameter grads against a float64 plain step, worst max|d| / max|g| over "
        f"{len(grads)} tensors: kernels {worst[0]:.3e} ({worst[1]}, tol {GRAD_TOL}); plain f32 {worst_plain[0]:.3e} "
        f"({worst_plain[1]}); kernels vs plain f32 {vs_plain[0]:.3e} ({vs_plain[1]}, cap {VS_PLAIN_CAP})")
    check(worst[0] <= GRAD_TOL, f"train-step grads differ from a float64 plain step: {worst}")
    check(vs_plain[0] <= VS_PLAIN_CAP, f"train-step grads differ from the plain f32 step: {vs_plain}")
    del grads, grads_plain, grads64

    # 8. train times
    dgrad_times = []
    with torch.inference_mode():
        for name, shape, c in train_dgrads:
            dy, w, _ = conv_inputs(shape, c, torch.float32, False, gen, device)
            w = w.transpose(3, 4).contiguous()  # (3, 3, 3, C, F) of the forward conv
            w_torch, dy_ncdhw = w.permute(4, 3, 0, 1, 2), dy.permute(0, 4, 1, 2, 3)
            # K3's own function: the forward conv of dy with the flipped weights
            w_flip = flip_weight(w).permute(4, 3, 0, 1, 2)
            x_size = (shape[0], c, *shape[1:4])
            row = {"conv": name, "dy": shape, "C": c,
                   "kernel_ms": timed_ms(lambda: conv3d_input_grad(dy, w)),
                   "reference_ms": timed_ms(lambda: conv3d_input_grad_reference(dy, w)),
                   "library_ms": timed_ms(lambda: torch.nn.functional.conv3d(dy_ncdhw, w_flip, padding=1)),
                   "conv3d_input_ms": timed_ms(
                       lambda: torch.nn.grad.conv3d_input(x_size, w_torch, dy_ncdhw, padding=1)),
                   "conv3d_input_tf32_ms": with_tf32(lambda: timed_ms(
                       lambda: torch.nn.grad.conv3d_input(x_size, w_torch, dy_ncdhw, padding=1)))}
            want = conv3d_input_grad_reference(dy, w)
            err = (conv3d_input_grad(dy, w) - want).abs().max().item()
            tol = TOL[torch.float32] * want.abs().max().item()
            check(err <= tol, f"conv3d_input_grad of {name} differs from its plain version by {err} (tol {tol})")
            row["kernel_tflops"] = 2 * 27 * np.prod(shape) * c / row["kernel_ms"] / 1e9
            row["bound_ms"] = tc_bound(shape, c, False)[0]
            dy16, w16, w_flip16 = dy.bfloat16(), w.bfloat16(), w_flip.bfloat16()
            dy16_ncdhw = dy16.permute(0, 4, 1, 2, 3)
            row["kernel_bf16_ms"] = timed_ms(lambda: conv3d_input_grad(dy16, w16))
            row["library_bf16_ms"] = timed_ms(lambda: torch.nn.functional.conv3d(dy16_ncdhw, w_flip16, padding=1))
            row["bound_tc_bf16_ms"] = tc_bound(shape, c, False, dtype=torch.bfloat16)[0]
            dgrad_times.append(row)
            log(f"[8 dgrad] {name:42s} dy{shape} -> C={c:<3d} K3 {row['kernel_ms']:.3f} ms "
                f"({row['kernel_tflops']:.1f} TFLOP/s, 3xTF32 bound {row['bound_ms']:.3f}) | F.conv3d on the "
                f"flipped weights {row['library_ms']:.3f} ms | plain {row['reference_ms']:.3f} ms | cuDNN "
                f"conv3d_input {row['conv3d_input_ms']:.3f} ms, TF32 {row['conv3d_input_tf32_ms']:.3f} ms | "
                f"max|d| vs plain {err:.2e} (tol {tol:.2e}) | K3 bf16 {row['kernel_bf16_ms']:.3f} ms (bf16 bound "
                f"{row['bound_tc_bf16_ms']:.3f}, cuDNN bf16 on the flipped weights {row['library_bf16_ms']:.3f})")
            del dy, w, w_torch, dy_ncdhw, w_flip, want, dy16, w16, w_flip16, dy16_ncdhw
    k3_sums = {key: sum(r[key] for r in dgrad_times) for key in dgrad_times[0] if key.endswith("_ms")}
    dgrad_tflop = sum(2 * 27 * np.prod(s) * c for _, s, c in train_dgrads) / 1e12
    log(f"[8 dgrad] all {len(train_dgrads)} input grads of one step ({dgrad_tflop:.3f} TFLOP): K3 "
        f"{k3_sums['kernel_ms']:.2f} ms | 3xTF32 bound {k3_sums['bound_ms']:.2f} | F.conv3d flipped "
        f"{k3_sums['library_ms']:.2f} ms | plain {k3_sums['reference_ms']:.2f} ms | cuDNN conv3d_input "
        f"{k3_sums['conv3d_input_ms']:.2f} ms, TF32 {k3_sums['conv3d_input_tf32_ms']:.2f} ms | K3 bf16 "
        f"{k3_sums['kernel_bf16_ms']:.2f} ms (bf16 bound {k3_sums['bound_tc_bf16_ms']:.2f}, cuDNN bf16 on the flipped "
        f"weights {k3_sums['library_bf16_ms']:.2f})")

    wgrad_times = []
    with torch.inference_mode():
        for name, shape, f in path_conv_shapes(model, TRAIN_PATCH):
            x, _, _ = conv_inputs(shape, f, torch.float32, False, gen, device)
            dy = torch.randn((*shape[:4], f), generator=gen, device=device)
            # the NCDHW views of NDHWC tensors that Conv3dFunction hands to cuDNN
            args = (x.permute(0, 4, 1, 2, 3), (f, shape[4], 3, 3, 3), dy.permute(0, 4, 1, 2, 3))
            row = {"conv": name, "x": shape, "F": f,
                   "plain_ms": timed_ms(lambda: torch.nn.grad.conv3d_weight(*args, padding=1)),
                   "plain_tf32_ms": with_tf32(lambda: timed_ms(
                       lambda: torch.nn.grad.conv3d_weight(*args, padding=1)))}
            wgrad_times.append(row)
            log(f"[8 wgrad] {name:42s} x{shape} F={f:<3d} cuDNN conv3d_weight {row['plain_ms']:.3f} ms | "
                f"TF32 {row['plain_tf32_ms']:.3f} ms")
            del x, dy, args
    log(f"[8 wgrad] all {len(wgrad_times)} weight grads of one step: cuDNN {sum(r['plain_ms'] for r in wgrad_times):.2f} "
        f"ms | cuDNN TF32 {sum(r['plain_tf32_ms'] for r in wgrad_times):.2f} ms")

    def train_step():
        optimizer.zero_grad(set_to_none=True)
        criterion(model(inp)[1], target).backward()
        optimizer.step()

    torch.cuda.reset_peak_memory_stats()
    step_ms = timed_ms(train_step)
    step_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    with plain_conv():
        step_plain_ms = timed_ms(train_step)
        step_plain_tf32_ms = with_tf32(lambda: timed_ms(train_step))
    voxels = np.prod(TRAIN_PATCH)
    log(f"[8 train step] {TRAIN_PATCH} batch 1, forward + backward + Adam: kernels {step_ms:.2f} ms "
        f"({voxels / step_ms / 1e3:.3f} Mvoxel/s) | plain conv {step_plain_ms:.2f} ms "
        f"({voxels / step_plain_ms / 1e3:.3f} Mvoxel/s) | plain conv TF32 {step_plain_tf32_ms:.2f} ms "
        f"({voxels / step_plain_tf32_ms / 1e3:.3f} Mvoxel/s) | peak memory {step_peak_gib:.2f} GiB")

    # 9. where the time of one train step goes, by device kernel
    profile_step(train_step)
    del model, optimizer, trainer, inp, target
    torch.cuda.empty_cache()

    # 10-14. ResidualUNet3D with K1 under P3DUNET_TAPFOLD=1
    res = residual_unet_phases(device, gen, volume, (train_batch, val_batch))

    # 15-17. the device sweep, f32 and bf16
    sweep = device_sweep_phases(device, volume, host, res["predict_out"])

    # 18. device augmentation at full size
    augment_phase(device, (train_batch[0], np.ascontiguousarray(train_batch[1][:, 1:])))

    # 19-20. bf16 training with device augmentation
    bf16 = bf16_train_phases(device, (train_batch, val_batch), step_ms)

    # 21-23. the multiclass and denoising recipes
    recipes = recipe_phases(device, volume, (train_batch, val_batch))

    # 24-26. the 2D families: the 2D confocal and DSB2018 configs
    two_d = two_d_phases(device, smi)

    # 27. the 3D model options at the confocal width
    options = options_phase(device, train_batch, smi)

    # 28. the trainer's breadth: remat, accumulation, EMA, resume, async checkpoints
    breadth = breadth_phase(device, (train_batch, val_batch), smi)

    # 29. checkpoint conversion, the exported forward and the HTTP server
    serving = serving_phase(device, volume, smi)

    # 30. parallelism: the D-sharded step at world size 1 (NCCL), two ranks sharing the card (gloo)
    parallel = parallel_phase(device, (train_batch, val_batch), volume, step_ms, smi)

    # 31. the JAX package's default decoder paths: the fused decoder and the phase deconv
    decoder, decoder_kernels = decoder_phase(device, train_batch, smi)
    decoder_rows = decoder_kernels["rows"]

    # 32. the GroupNorm kernel at every GroupNorm input of a UNet3D (f32) and a ResidualUNet3D (bf16) forward
    group_norm_kernel = group_norm_phase(device, smi)

    by_path_dtype = {**launches, **res["launches"], **sweep["launches"], **bf16, **recipes, **two_d, **options,
                     **breadth, **serving, **parallel, **decoder}
    paths = {path: {name: sum(counts.values()) for name, counts in by_dtype.items()}
             for path, by_dtype in by_path_dtype.items()}
    group_norm_kernel["launches"] = paths["predict"]["group_norm"]
    group_norm_kernel["launches_by_path"] = {path: counts["group_norm"] for path, counts in paths.items()}
    group_norm_kernel["launches_by_path_dtype"] = {path: counts["group_norm"]
                                                   for path, counts in by_path_dtype.items()}
    k2_bound = summed_bound([(shape, f, True) for _, shape, f in shapes], tc_bound)
    k2_bound_ffma = summed_bound([(shape, f, True) for _, shape, f in shapes])
    k3_bound = summed_bound([(shape, c, False) for _, shape, c in train_dgrads], tc_bound)
    k3_bound_ffma = summed_bound([(shape, c, False) for _, shape, c in train_dgrads])
    kernels = [
        {"name": "conv3d_fwd", "route": "cuda", "source": "pytorch3dunet_tpu_torch/csrc/conv3d_fwd.cu",
         "replaces": "pytorch3dunet_tpu/ops/conv_pallas.py:135", "launches": paths["train"]["conv3d_fwd"],
         "launches_by_path": {path: counts["conv3d_fwd"] for path, counts in paths.items()},
         "launches_by_path_dtype": {path: counts["conv3d_fwd"] for path, counts in by_path_dtype.items()},
         "max_abs_err": max(e[torch.float32] for e in (errors, res["errors_k2"], decoder_kernels["errors_k2"])),
         "max_abs_err_bf16": max(e[torch.bfloat16] for e in (errors, res["errors_k2"], decoder_kernels["errors_k2"])),
         "ms": conv_ms,
         "plain_ms": plain_ms, "plain_tf32_ms": plain_tf32_ms, "bound_ms": k2_bound[0], "bound_by": k2_bound[1],
         "bound_ffma_ms": k2_bound_ffma[0], "bound_ffma_by": k2_bound_ffma[1], "library_ms": k2_sums["library_ms"],
         "library_tf32_ms": k2_sums["library_tf32_ms"], "library_call": "F.conv3d(x, w), NCDHW views",
         "bf16_ms": k2_sums["kernel_bf16_ms"], "bound_tc_bf16_ms": k2_sums["bound_tc_bf16_ms"],
         "library_bf16_ms": k2_sums["library_bf16_ms"], "mma_issued_over_useful": mma_ratio,
         "ptxas": ptxas["conv3d_fwd"], "shapes": len(shapes),
         "work": f"the {len(shapes)} conv forwards of one UNet3D 112x234x234 patch, f32",
         "decoder_shapes": [{k: row[k] for k in ("conv", "x", "F", "k2_ms", "k2_bf16_ms", "plain_ms", "library_ms",
                                                 "library_call", "bound_ms", "bound_bf16_ms")}
                            for row in decoder_rows]},
        {"name": "conv3d_packw", "route": "cuda", "source": "pytorch3dunet_tpu_torch/csrc/conv3d_packw.cu",
         "replaces": "pytorch3dunet_tpu/ops/conv_pallas.py:218", "launches": paths["train"]["conv3d_packw"],
         "launches_by_path": {path: counts["conv3d_packw"] for path, counts in paths.items()},
         "launches_by_path_dtype": {path: counts["conv3d_packw"] for path, counts in by_path_dtype.items()},
         "max_abs_err": max(e[torch.float32] for e in (errors_k3, res["errors_k3"], decoder_kernels["errors_k3"])),
         "max_abs_err_bf16": max(e[torch.bfloat16]
                                 for e in (errors_k3, res["errors_k3"], decoder_kernels["errors_k3"])),
         "ms": k3_sums["kernel_ms"], "plain_ms": k3_sums["reference_ms"], "bound_ms": k3_bound[0],
         "bound_by": k3_bound[1], "bound_ffma_ms": k3_bound_ffma[0], "bound_ffma_by": k3_bound_ffma[1],
         "library_ms": k3_sums["library_ms"], "library_call": "F.conv3d(dy, flipped w), NCDHW views",
         "conv3d_input_ms": k3_sums["conv3d_input_ms"], "conv3d_input_tf32_ms": k3_sums["conv3d_input_tf32_ms"],
         "bf16_ms": k3_sums["kernel_bf16_ms"], "bound_tc_bf16_ms": k3_sums["bound_tc_bf16_ms"],
         "library_bf16_ms": k3_sums["library_bf16_ms"], "ptxas": ptxas["conv3d_packw"], "shapes": len(train_dgrads),
         "work": f"the {len(train_dgrads)} input gradients of one UNet3D 80x170x170 train step, f32",
         "decoder_shapes": [{k: row[k] for k in ("conv", "dy", "C", "k3_ms", "k3_bf16_ms", "k3_plain_ms",
                                                 "k3_library_ms", "k3_bound_ms")} for row in decoder_rows]},
        {"name": "conv3d_im2col", "route": "cuda", "source": "pytorch3dunet_tpu_torch/csrc/conv3d_im2col.cu",
         "replaces": "pytorch3dunet_tpu/ops/conv_pallas.py:53", "launches": paths["resunet_train"]["conv3d_im2col"],
         "launches_by_path": {path: counts["conv3d_im2col"] for path, counts in paths.items()},
         "launches_by_path_dtype": {path: counts["conv3d_im2col"] for path, counts in by_path_dtype.items()},
         "max_abs_err": res["errors"][torch.float32], "max_abs_err_bf16": res["errors"][torch.bfloat16],
         "ms": res["k1_ms"], "plain_ms": res["k1_plain_ms"], "plain_tf32_ms": res["k1_plain_tf32_ms"],
         "bound_ms": res["k1_bound"][0], "bound_by": res["k1_bound"][1], "bound_ffma_ms": res["k1_bound_ffma"][0],
         "bound_ffma_by": res["k1_bound_ffma"][1], "library_ms": res["k1_library_ms"],
         "library_call": "F.conv3d(x, w), NCDHW views", "bf16_ms": res["k1_bf16_ms"],
         "bound_tc_bf16_ms": res["k1_bound_tc_bf16_ms"], "library_bf16_ms": res["k1_library_bf16_ms"],
         "ptxas": ptxas["conv3d_im2col"],
         "k2_same_shapes_ms": res["k2_same_ms"], "shapes": res["k1_count"],
         "work": f"the {res['k1_count']} K1 conv forwards of one ResidualUNet3D 112x234x234 patch, f32"},
        group_norm_kernel,
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
