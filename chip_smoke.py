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
     plain and cuDNN with TF32 off and on, K2 in bf16), one patch forward and
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
     `conv3d_input` (TF32 off and on), cuDNN's weight gradient per conv shape
     (TF32 off and on), one train step with the kernels against the plain conv
     (TF32 off and on), voxels/s and peak memory;
  9. profile: one train step's device time by kernel (torch.profiler) and the
     device's busy share.
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
 12. ResidualUNetSE3D: one full-width forward of one patch, checked the same way;
 13. ResidualUNet3D train path: the loss, optimizer, eval_metric and
     lr_scheduler of resources/3DUnet_lightsheet_boundary/train_config.yml, 4
     Adam steps on the synthetic 80x170x170 batch and 1 validation; checks 18
     K3 launches per step and 14 K1 + 4 K2 per forward, the falling loss, and
     one step's gradients against a float64 step with the plain conv, beside
     the plain conv's own float32 step, and against that f32 step;
 14. times: K1 per shape against K2 at the same shape and cuDNN (TF32 off and
     on), the patch forward, predict_array, a train step with peak memory, and
     one forward's device time by kernel (torch.profiler).
TF32 is off for every comparison and every "plain" time unless a line says
"TF32". The line before the last is a JSON object describing the kernels (time,
launches, error, and the bound `bound_ms`: the larger of bytes at the H100's
3.35 TB/s and FLOPs at the peak rate of the arithmetic the kernel issues,
3xTF32 MMAs at 495 TFLOP/s (three products a MAC) for the three tensor-core
kernels K1, K2 and K3, which also carry the f32 FFMA figure at 67 TFLOP/s as
`bound_ffma_ms` and their ptxas registers, spills and shared memory; for K1
and K2 also the bf16 time beside the bf16 bound at 989 TFLOP/s, for K2 the
MMAs issued over the useful ones); the last line is
{"ok": true, "device": {...}}.

Needs torch, numpy and scipy; not jax, h5py or yaml, and nothing of the JAX package.
"""

import copy
import json
import math
import os
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
    from pytorch3dunet_tpu_torch.ops import conv3d

    for name in conv3d.launches:
        conv3d.launches[name] = 0


def conv_inputs(shape, c_out, dtype, bias, gen, device):
    c_in = shape[-1]
    x = torch.randn(shape, generator=gen, device=device).to(dtype)
    w = ((torch.rand(3, 3, 3, c_in, c_out, generator=gen, device=device) * 2 - 1) / (27 * c_in) ** 0.5).to(dtype)
    b = (torch.rand(c_out, generator=gen, device=device) - 0.5).to(dtype) if bias else None
    return x, w, b


def path_conv_shapes(model, patch_in):
    """(module name, NDHWC input shape, F) of every 3x3x3 conv of one forward
    of `model` on a patch of spatial shape `patch_in`."""
    from pytorch3dunet_tpu_torch.ops.conv3d import Conv3d

    levels = len(model.encoders)
    shapes = []
    for name, module in model.named_modules():
        if isinstance(module, Conv3d) and module.kernel_size == (3, 3, 3):
            part, index = name.split(".")[:2]
            level = int(index) if part == "encoders" else levels - 2 - int(index)
            spatial = tuple(s // 2**level for s in patch_in)
            shapes.append((name, (1, *spatial, module.in_channels), module.out_channels))
    return shapes


def dgrad_shapes(model, patch, layer_order=MODEL["layer_order"]):
    """(module name, NDHWC dy shape, C) of every input gradient that one train
    step on `patch` computes: every 3x3x3 conv but one that reads the raw patch
    itself. With layer_order 'gcr' there is none such: the first conv reads the
    output of a GroupNorm whose affine parameters need its input gradient."""
    first_reads_raw = layer_order[0] == "c"
    return [(name, (*shape[:4], f), shape[4]) for i, (name, shape, f) in enumerate(path_conv_shapes(model, patch))
            if not (i == 0 and first_reads_raw)]


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


def profile_step(step, step_ms, top=12, tag="9 profile", what="one train step"):
    """Device time of one call of `step` under torch.profiler, summed by
    kernel name: the hand-written kernels, then the largest others, and the
    device's busy share of `step_ms` (the step's CUDA-event time)."""
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
    busy_ms = sum(by_name.values())
    if not busy_ms:
        log(f"[{tag}] the profiler recorded no device time")
        return
    log(f"[{tag}] {what}: device busy {busy_ms:.2f} ms of {step_ms:.2f} ms "
        f"({100 * busy_ms / step_ms:.1f}% busy) in {len(by_name)} kernel names")
    ours = [name for name in by_name if any(k in name for k in ("conv3d_fwd_kernel", "conv3d_packw_kernel",
                                                                  "conv3d_im2col_kernel"))]
    others = sorted((name for name in by_name if name not in ours), key=by_name.get, reverse=True)
    for name in ours + others[:top]:
        log(f"[{tag}] {by_name[name]:9.2f} ms {100 * by_name[name] / busy_ms:5.1f}%  {name[:110]}")


def residual_unet_phases(device, gen, volume, batches):
    """Phases 10-14: K1 against its plain version, then ResidualUNet3D predict
    and train (and one ResidualUNetSE3D forward) at full width with
    P3DUNET_TAPFOLD=1, and their times. Returns what the kernels line needs."""
    from pytorch3dunet_tpu_torch.models.unet import get_model
    from pytorch3dunet_tpu_torch.ops import conv3d
    from pytorch3dunet_tpu_torch.ops.conv3d import (conv3d_fwd, conv3d_fwd_reference, conv3d_input_grad,
                                                    conv3d_input_grad_reference, plain_conv)
    from pytorch3dunet_tpu_torch.predictor import StandardPredictor
    from pytorch3dunet_tpu_torch.trainer import create_trainer

    patch_in = tuple(p + 2 * h for p, h in zip(PATCH, HALO))
    torch.manual_seed(SEED)
    model = get_model(RES_MODEL)
    shapes = path_conv_shapes(model, patch_in)
    k1_shapes = [(name, shape, f) for name, shape, f in shapes if f >= 64]
    k2_shapes = [(name, shape, f) for name, shape, f in shapes if f < 64]
    train_shapes = path_conv_shapes(model, TRAIN_PATCH)
    train_k1 = [(name, shape, f) for name, shape, f in train_shapes if f >= 64]
    train_k2 = [(name, shape, f) for name, shape, f in train_shapes if f < 64]
    dgrads = dgrad_shapes(model, TRAIN_PATCH, RES_MODEL["layer_order"])
    check((len(shapes), len(k1_shapes), len(dgrads)) == (18, 14, 18),
          f"ResidualUNet3D has {len(shapes)} convs, {len(k1_shapes)} K1, {len(dgrads)} input gradients")

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
        per_forward = {"conv3d_fwd": len(k2_shapes), "conv3d_packw": 0, "conv3d_im2col": len(k1_shapes)}
        reset_launches()
        start = time.perf_counter()
        out = predictor.predict_array(volume, PATCH, STRIDE, HALO, TRANSFORMER)
        first_s = time.perf_counter() - start
        predict_launches = dict(conv3d.launches)
        expected = {k: v * len(patches) for k, v in per_forward.items()}
        log(f"[11 resunet predict] predict_array {VOLUME} -> {out.shape} in {first_s:.2f} s (first call); "
            f"{len(patches)} patches of {patch_in}, launches {predict_launches} (expected {expected})")
        check(predict_launches == expected, f"ResidualUNet3D predict launched {predict_launches}, expected {expected}")
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

        # 12. ResidualUNetSE3D, one full-width forward
        torch.manual_seed(SEED)
        se_model = get_model({**RES_MODEL, "name": "ResidualUNetSE3D"})
        randomize_group_norms(se_model, torch.Generator().manual_seed(SEED))
        se_model = se_model.to(device).eval()
        reset_launches()
        with torch.inference_mode():
            se_probs = se_model(x0)[0]
            se_launches = dict(conv3d.launches)
            with plain_conv():
                se_plain = se_model(x0)[0]
        err = (se_probs - se_plain).abs().max().item()
        finite = bool(torch.isfinite(se_probs).all()) and 0 <= se_probs.min().item() <= se_probs.max().item() <= 1
        log(f"[12 resunet-se] one {patch_in} forward: launches {se_launches} (expected {per_forward}); "
            f"kernel vs plain max|d| = {err:.3e} (tol {FORWARD_TOL}); finite in [0, 1]: {finite}")
        check(se_launches == per_forward, f"ResidualUNetSE3D launched {se_launches}, expected {per_forward}")
        check(finite and err <= FORWARD_TOL, f"ResidualUNetSE3D forward: finite {finite}, max|d| {err}")
        del se_model, se_probs, se_plain

        # 13. ResidualUNet3D train path at full width
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
            reset_launches()
            start = time.perf_counter()
            trainer.fit()
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - start
            train_launches = dict(conv3d.launches)
            trainer.loss_criterion = criterion
        n_val = RES_TRAIN_STEPS // RES_VALIDATE_AFTER
        expected = {"conv3d_fwd": len(k2_shapes) * (RES_TRAIN_STEPS + n_val),
                    "conv3d_im2col": len(k1_shapes) * (RES_TRAIN_STEPS + n_val),
                    "conv3d_packw": len(shapes) * RES_TRAIN_STEPS}
        log(f"[13 resunet train] fit: {RES_TRAIN_STEPS} steps of {TRAIN_PATCH} + {n_val} validation in {fit_s:.2f} s; "
            f"launches {train_launches} (expected {expected}); losses {', '.join(f'{v:.5f}' for v in losses)}; "
            f"best val ARand {trainer.best_eval_score:.5f}")
        check(train_launches == expected, f"ResidualUNet3D train launched {train_launches}, expected {expected}")
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
                row["bound_ms"] = tc_bound(shape, f)[0]
                row["bound_ffma_ms"] = conv_bound(shape, f)[0]
                row["bound_tc_bf16_ms"] = tc_bound(shape, f, dtype=torch.bfloat16)[0]
                row["k1_tflops"] = 2 * 27 * np.prod(shape) * f / row["k1_ms"] / 1e9
                k1_times.append(row)
                log(f"[14 K1] {name:42s} x{shape} F={f:<3d} K1 {row['k1_ms']:.3f} ms ({row['k1_tflops']:.1f} "
                    f"TFLOP/s, 3xTF32 bound {row['bound_ms']:.3f}, FFMA {row['bound_ffma_ms']:.3f}) | K2 "
                    f"{row['k2_ms']:.3f} | cuDNN F.conv3d {row['library_ms']:.3f}, TF32 {row['library_tf32_ms']:.3f} | "
                    f"plain {row['plain_ms']:.3f}, TF32 {row['plain_tf32_ms']:.3f} | K1 bf16 {row['k1_bf16_ms']:.3f} "
                    f"ms (bf16 bound {row['bound_tc_bf16_ms']:.3f})")
                del x, w, b, xb, wb, bb
            sums = {key: sum(r[key] for r in k1_times) for key in k1_times[0] if key.endswith("_ms")}
            tflop = sum(2 * 27 * np.prod(s) * f for _, s, f in k1_shapes) / 1e12
            log(f"[14 K1] all {len(k1_times)} K1 convs of one forward ({tflop:.3f} TFLOP): K1 {sums['k1_ms']:.2f} ms | "
                f"3xTF32 bound {sums['bound_ms']:.2f}, FFMA {sums['bound_ffma_ms']:.2f} | K2 {sums['k2_ms']:.2f} | cuDNN "
                f"{sums['library_ms']:.2f}, TF32 {sums['library_tf32_ms']:.2f} | plain {sums['plain_ms']:.2f}, TF32 "
                f"{sums['plain_tf32_ms']:.2f} | K1 bf16 {sums['k1_bf16_ms']:.2f} ms (bf16 bound "
                f"{sums['bound_tc_bf16_ms']:.2f})")

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

        profile_step(forward, fwd_ms, tag="14 resunet profile", what="one ResidualUNet3D patch forward")
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
        profile_step(train_step, step_ms, tag="14 resunet profile", what="one ResidualUNet3D train step")
        del train_model, optimizer, trainer, inp, target
        torch.cuda.empty_cache()
    finally:
        os.environ.pop("P3DUNET_TAPFOLD", None)

    return {"errors": errors, "errors_k2": errors_k2, "errors_k3": errors_k3, "predict_launches": predict_launches, "train_launches": train_launches,
            "k1_ms": sums["k1_ms"], "k1_plain_ms": sums["plain_ms"], "k1_plain_tf32_ms": sums["plain_tf32_ms"],
            "k1_library_ms": sums["library_ms"], "k2_same_ms": sums["k2_ms"], "k1_count": len(k1_times),
            "k1_bound": summed_bound([(shape, f, True) for _, shape, f in k1_shapes], tc_bound),
            "k1_bound_ffma": summed_bound([(shape, f, True) for _, shape, f in k1_shapes]),
            "k1_bf16_ms": sums["k1_bf16_ms"], "k1_bound_tc_bf16_ms": sums["bound_tc_bf16_ms"]}


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
    from pytorch3dunet_tpu_torch.ops import build, conv3d
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
    n_conv = len(shapes)

    reset_launches()
    start = time.perf_counter()
    out = predictor.predict_array(volume, PATCH, STRIDE, HALO, TRANSFORMER)
    first_s = time.perf_counter() - start
    predict_launches = dict(conv3d.launches)
    log(f"[4 predict] predict_array {VOLUME} -> {out.shape} in {first_s:.2f} s (first call); "
        f"{len(patches)} patches of {patch_in}, launches {predict_launches} (expected conv3d_fwd "
        f"{n_conv} x {len(patches)}, conv3d_packw 0, conv3d_im2col 0)")
    check(predict_launches == {"conv3d_fwd": n_conv * len(patches), "conv3d_packw": 0, "conv3d_im2col": 0},
          f"predict launched {predict_launches}")
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
                f"(bf16 bound {row['bound_tc_bf16_ms']:.3f})")
            del x, w, b, xb, wb, bb
        k2_sums = {key: sum(r[key] for r in times) for key in times[0] if key.endswith(("_ms", "_macs"))}
        conv_ms, plain_ms, plain_tf32_ms = k2_sums["kernel_ms"], k2_sums["plain_ms"], k2_sums["plain_tf32_ms"]
        mma_ratio = k2_sums["issued_macs"] / k2_sums["useful_macs"]
        tflop = 2 * k2_sums["useful_macs"] / 1e12
        log(f"[5 conv] all {n_conv} convs of one forward ({tflop:.3f} TFLOP): K2 {conv_ms:.2f} ms | 3xTF32 bound "
            f"{k2_sums['bound_ms']:.2f}, FFMA {k2_sums['bound_ffma_ms']:.2f} | MMAs issued / useful {mma_ratio:.4f} | "
            f"cuDNN {k2_sums['library_ms']:.2f}, TF32 {k2_sums['library_tf32_ms']:.2f} | plain {plain_ms:.2f}, TF32 "
            f"{plain_tf32_ms:.2f} | K2 bf16 {k2_sums['kernel_bf16_ms']:.2f} ms (bf16 bound "
            f"{k2_sums['bound_tc_bf16_ms']:.2f})")

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

    profile_step(forward, fwd_ms, tag="5 profile", what="one UNet3D patch forward")

    walls = []
    for _ in range(RUNS):
        start = time.perf_counter()
        predictor.predict_array(volume, PATCH, STRIDE, HALO, TRANSFORMER)
        walls.append(time.perf_counter() - start)
    wall = statistics.median(walls)
    log(f"[5 predict] predict_array {VOLUME}: median {wall:.3f} s of {RUNS} -> "
        f"{np.prod(VOLUME) / wall / 1e6:.3f} Mvoxel/s (runs: {', '.join(f'{t:.3f}' for t in walls)})")
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
        reset_launches()
        Conv3dFunction.grad_copies = 0
        start = time.perf_counter()
        trainer.fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - start
        train_launches = dict(conv3d.launches)
        grad_copies = Conv3dFunction.grad_copies
        trainer.loss_criterion = criterion
        n_val = TRAIN_STEPS // VALIDATE_AFTER
        n_dgrad = len(train_dgrads)
        expected = {"conv3d_fwd": n_conv * (TRAIN_STEPS + n_val), "conv3d_packw": n_dgrad * TRAIN_STEPS,
                    "conv3d_im2col": 0}
        log(f"[7 train] fit: {TRAIN_STEPS} steps of {TRAIN_PATCH} + {n_val} validations in {fit_s:.2f} s; "
            f"launches {train_launches} (expected {expected}); dy layout copies per step "
            f"{grad_copies / TRAIN_STEPS:.1f}; losses {', '.join(f'{v:.5f}' for v in losses)}; "
            f"best val ARand {trainer.best_eval_score:.5f}")
        check(train_launches == expected, f"train launched {train_launches}, expected {expected}")
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
            dgrad_times.append(row)
            log(f"[8 dgrad] {name:42s} dy{shape} -> C={c:<3d} K3 {row['kernel_ms']:.3f} ms "
                f"({row['kernel_tflops']:.1f} TFLOP/s, 3xTF32 bound {row['bound_ms']:.3f}) | F.conv3d on the "
                f"flipped weights {row['library_ms']:.3f} ms | plain {row['reference_ms']:.3f} ms | cuDNN "
                f"conv3d_input {row['conv3d_input_ms']:.3f} ms, TF32 {row['conv3d_input_tf32_ms']:.3f} ms | "
                f"max|d| vs plain {err:.2e} (tol {tol:.2e})")
            del dy, w, w_torch, dy_ncdhw, w_flip, want
    k3_sums = {key: sum(r[key] for r in dgrad_times) for key in dgrad_times[0] if key.endswith("_ms")}
    dgrad_tflop = sum(2 * 27 * np.prod(s) * c for _, s, c in train_dgrads) / 1e12
    log(f"[8 dgrad] all {len(train_dgrads)} input grads of one step ({dgrad_tflop:.3f} TFLOP): K3 "
        f"{k3_sums['kernel_ms']:.2f} ms | 3xTF32 bound {k3_sums['bound_ms']:.2f} | F.conv3d flipped "
        f"{k3_sums['library_ms']:.2f} ms | plain {k3_sums['reference_ms']:.2f} ms | cuDNN conv3d_input "
        f"{k3_sums['conv3d_input_ms']:.2f} ms, TF32 {k3_sums['conv3d_input_tf32_ms']:.2f} ms")

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
    profile_step(train_step, step_ms)
    del model, optimizer, trainer, inp, target
    torch.cuda.empty_cache()

    # 10-14. ResidualUNet3D with K1 under P3DUNET_TAPFOLD=1
    res = residual_unet_phases(device, gen, volume, (train_batch, val_batch))

    unet_paths = {"predict": predict_launches, "train": train_launches}
    paths = {**unet_paths, "resunet_predict": res["predict_launches"], "resunet_train": res["train_launches"]}
    k2_bound = summed_bound([(shape, f, True) for _, shape, f in shapes], tc_bound)
    k2_bound_ffma = summed_bound([(shape, f, True) for _, shape, f in shapes])
    k3_bound = summed_bound([(shape, c, False) for _, shape, c in train_dgrads], tc_bound)
    k3_bound_ffma = summed_bound([(shape, c, False) for _, shape, c in train_dgrads])
    kernels = [
        {"name": "conv3d_fwd", "route": "cuda", "source": "pytorch3dunet_tpu_torch/csrc/conv3d_fwd.cu",
         "replaces": "pytorch3dunet_tpu/ops/conv_pallas.py:135", "launches": train_launches["conv3d_fwd"],
         "launches_by_path": {path: counts["conv3d_fwd"] for path, counts in paths.items()},
         "max_abs_err": max(errors[torch.float32], res["errors_k2"][torch.float32]),
         "max_abs_err_bf16": max(errors[torch.bfloat16], res["errors_k2"][torch.bfloat16]), "ms": conv_ms,
         "plain_ms": plain_ms, "plain_tf32_ms": plain_tf32_ms, "bound_ms": k2_bound[0], "bound_by": k2_bound[1],
         "bound_ffma_ms": k2_bound_ffma[0], "bound_ffma_by": k2_bound_ffma[1], "library_ms": k2_sums["library_ms"],
         "library_tf32_ms": k2_sums["library_tf32_ms"], "library_call": "F.conv3d(x, w), NCDHW views",
         "bf16_ms": k2_sums["kernel_bf16_ms"], "bound_tc_bf16_ms": k2_sums["bound_tc_bf16_ms"],
         "mma_issued_over_useful": mma_ratio, "ptxas": ptxas["conv3d_fwd"], "shapes": n_conv,
         "work": "the 14 conv forwards of one UNet3D 112x234x234 patch, f32"},
        {"name": "conv3d_packw", "route": "cuda", "source": "pytorch3dunet_tpu_torch/csrc/conv3d_packw.cu",
         "replaces": "pytorch3dunet_tpu/ops/conv_pallas.py:218", "launches": train_launches["conv3d_packw"],
         "launches_by_path": {path: counts["conv3d_packw"] for path, counts in paths.items()},
         "max_abs_err": max(errors_k3[torch.float32], res["errors_k3"][torch.float32]),
         "max_abs_err_bf16": max(errors_k3[torch.bfloat16], res["errors_k3"][torch.bfloat16]),
         "ms": k3_sums["kernel_ms"], "plain_ms": k3_sums["reference_ms"], "bound_ms": k3_bound[0],
         "bound_by": k3_bound[1], "bound_ffma_ms": k3_bound_ffma[0], "bound_ffma_by": k3_bound_ffma[1],
         "library_ms": k3_sums["library_ms"], "library_call": "F.conv3d(dy, flipped w), NCDHW views",
         "conv3d_input_ms": k3_sums["conv3d_input_ms"], "conv3d_input_tf32_ms": k3_sums["conv3d_input_tf32_ms"],
         "ptxas": ptxas["conv3d_packw"], "shapes": len(train_dgrads),
         "work": "the 14 input gradients of one UNet3D 80x170x170 train step, f32"},
        {"name": "conv3d_im2col", "route": "cuda", "source": "pytorch3dunet_tpu_torch/csrc/conv3d_im2col.cu",
         "replaces": "pytorch3dunet_tpu/ops/conv_pallas.py:53", "launches": res["train_launches"]["conv3d_im2col"],
         "launches_by_path": {path: counts["conv3d_im2col"] for path, counts in paths.items()},
         "max_abs_err": res["errors"][torch.float32], "max_abs_err_bf16": res["errors"][torch.bfloat16],
         "ms": res["k1_ms"], "plain_ms": res["k1_plain_ms"], "plain_tf32_ms": res["k1_plain_tf32_ms"],
         "bound_ms": res["k1_bound"][0], "bound_by": res["k1_bound"][1], "bound_ffma_ms": res["k1_bound_ffma"][0],
         "bound_ffma_by": res["k1_bound_ffma"][1], "library_ms": res["k1_library_ms"],
         "library_call": "F.conv3d(x, w), NCDHW views", "bf16_ms": res["k1_bf16_ms"],
         "bound_tc_bf16_ms": res["k1_bound_tc_bf16_ms"], "ptxas": ptxas["conv3d_im2col"],
         "k2_same_shapes_ms": res["k2_same_ms"], "shapes": res["k1_count"],
         "work": "the 14 K1 conv forwards of one ResidualUNet3D 112x234x234 patch, f32"},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
