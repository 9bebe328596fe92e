#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pytorch3dunet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of the repository

Phases, each fatal on failure:
  1. device: a CUDA device is present; its name and power limit;
  2. build: the hand-written kernels are compiled from csrc/ with nvcc;
  3. kernel vs plain: `conv3d_fwd` against `conv3d_fwd_reference` at every 3x3x3
     conv shape of the UNet3D forward below, in float32 and bfloat16, and at
     edge shapes;
  4. main path: sliding-window prediction with the UNet3D of
     resources/3DUnet_confocal_boundary/test_config.yml at full width (seeded
     random weights, synthetic volume, 4 patches of 112x234x234 with halo);
     checks the launch count, the output, and one patch against the same
     forward with the plain conv;
  5. times, with CUDA events: each conv shape (kernel vs plain with TF32 off
     and on), one patch forward, the whole prediction.
The line before the last is a JSON object describing the kernels; the last
line is {"ok": true, "device": {...}}.

Needs torch and numpy, scipy (the reused host tier); not jax, h5py or yaml.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
# the model section of resources/3DUnet_confocal_boundary/test_config.yml
MODEL = {"name": "UNet3D", "in_channels": 1, "out_channels": 1, "layer_order": "gcr", "f_maps": 32,
         "num_groups": 8, "final_sigmoid": True}
PATCH, STRIDE, HALO = (80, 170, 170), (80, 170, 170), (16, 32, 32)
TRANSFORMER = {"raw": [{"name": "Standardize"}, {"name": "ToTensor", "expand_dims": True}]}
VOLUME = (160, 170, 340)  # 2 x 1 x 2 patches
# max |kernel - plain| <= tol * max |plain|: f32 sums of up to 27 * 384 products
# in another order; bf16 one rounding of the output
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
FORWARD_TOL = 1e-3  # probabilities of one patch, kernel forward vs plain forward
# (N, D, H, W, C, F, bias): C = 1, F = 3, D = 1 and 2, odd H and W, N = 2, F
# above one feature block, C above one channel chunk, no bias
EDGE_CASES = [(1, 5, 7, 9, 1, 16, True), (1, 2, 11, 13, 3, 3, True), (2, 4, 9, 31, 32, 64, True),
              (1, 3, 5, 37, 20, 40, False), (1, 1, 1, 1, 8, 8, True), (2, 3, 17, 33, 130, 70, False)]
RUNS = 5


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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from pytorch3dunet_tpu_torch.models.unet import get_model
    from pytorch3dunet_tpu_torch.ops import build
    from pytorch3dunet_tpu_torch.ops.conv3d import Conv3d, conv3d_fwd, conv3d_fwd_reference, plain_conv
    from pytorch3dunet_tpu_torch.predictor import StandardPredictor

    device = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[1 device] {torch.cuda.get_device_name(0)} | torch {torch.__version__} | CUDA {torch.version.cuda} | "
        f"nvidia-smi: {smi}")

    # 2. build
    start = time.perf_counter()
    build.load("conv3d_fwd")
    log(f"[2 build] conv3d_fwd built and loaded in {time.perf_counter() - start:.1f} s")
    for line in build.build_logs.get("conv3d_fwd", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"[2 build]   {line.strip()}")

    # 3. kernel vs plain
    torch.manual_seed(SEED)
    model = get_model(MODEL)
    patch_in = tuple(p + 2 * h for p, h in zip(PATCH, HALO))
    shapes = path_conv_shapes(model, patch_in)
    gen = torch.Generator(device=device).manual_seed(SEED)
    cases = [(name, shape, f, True) for name, shape, f in shapes]
    cases += [(f"edge{i}", case[:5], case[5], case[6]) for i, case in enumerate(EDGE_CASES)]
    errors = {torch.float32: 0.0, torch.bfloat16: 0.0}
    failed = []
    with torch.inference_mode():
        for name, shape, f, bias in cases:
            for dtype in (torch.float32, torch.bfloat16):
                x, w, b = conv_inputs(shape, f, dtype, bias, gen, device)
                got = conv3d_fwd(x, w, b)
                torch.cuda.synchronize()
                want = conv3d_fwd_reference(x, w, b)
                err = (got.float() - want.float()).abs().max().item()
                tol = TOL[dtype] * want.float().abs().max().item()
                if not name.startswith("edge"):
                    errors[dtype] = max(errors[dtype], err)
                ok = got.shape == want.shape and got.dtype == dtype and err <= tol
                if not ok:
                    failed.append((name, shape, f, dtype))
                log(f"[3 check] {name:42s} x{shape} F={f:<3d} {str(dtype)[6:]:8s} bias={bias!s:5s} "
                    f"max|d|={err:.3e} tol={tol:.3e} {'ok' if ok else 'FAIL'}")
                del x, w, b, got, want
    check(not failed, f"kernel disagrees with the plain version: {failed}")

    # 4. main path at full width
    gen_cpu = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, torch.nn.GroupNorm):
                module.weight.copy_(torch.rand(module.weight.shape, generator=gen_cpu) + 0.5)
                module.bias.copy_(torch.rand(module.bias.shape, generator=gen_cpu) * 0.4 - 0.2)
    model = model.to(device).eval()
    predictor = StandardPredictor(model, None, MODEL["out_channels"], device)
    rs = np.random.RandomState(SEED)
    zz, yy, xx = np.meshgrid(*(np.linspace(0, 6 * np.pi, s, dtype=np.float32) for s in VOLUME), indexing="ij")
    volume = (np.sin(zz) * np.cos(yy) * np.sin(xx) + 0.5 * rs.rand(*VOLUME)).astype(np.float32)
    patches = list(predictor.patches(volume, PATCH, STRIDE, HALO, TRANSFORMER))
    n_conv = len(shapes)

    conv3d_fwd.launches = 0
    start = time.perf_counter()
    out = predictor.predict_array(volume, PATCH, STRIDE, HALO, TRANSFORMER)
    first_s = time.perf_counter() - start
    launches = conv3d_fwd.launches
    log(f"[4 main] predict_array {VOLUME} -> {out.shape} in {first_s:.2f} s (first call); "
        f"{len(patches)} patches of {patch_in}, conv launches {launches} (expected {n_conv} x {len(patches)})")
    check(launches == n_conv * len(patches), f"conv kernel launched {launches} times")
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
    log(f"[4 main] patch 0: kernel vs plain forward max|d| = {err:.3e} (tol {FORWARD_TOL}); "
        f"stitched == patch core: {np.array_equal(core, stitched)}; layout copies per forward: {copies}; "
        f"probs in [{out.min():.4f}, {out.max():.4f}], mean {out.mean():.4f}")
    check(err <= FORWARD_TOL, f"kernel forward differs from the plain forward by {err}")
    check(np.array_equal(core, stitched), "stitched prediction differs from the patch forward")

    # 5. times
    times = []
    with torch.inference_mode():
        for name, shape, f in shapes:
            row = {"conv": name, "x": shape, "F": f}
            x, w, b = conv_inputs(shape, f, torch.float32, True, gen, device)
            row["kernel_ms"] = timed_ms(lambda: conv3d_fwd(x, w, b))
            row["plain_ms"] = timed_ms(lambda: conv3d_fwd_reference(x, w, b))
            torch.backends.cudnn.allow_tf32 = True
            row["plain_tf32_ms"] = timed_ms(lambda: conv3d_fwd_reference(x, w, b))
            torch.backends.cudnn.allow_tf32 = False
            xb, wb, bb = x.bfloat16(), w.bfloat16(), b.bfloat16()
            row["kernel_bf16_ms"] = timed_ms(lambda: conv3d_fwd(xb, wb, bb))
            flop = 2 * 27 * np.prod(shape) * f
            row["kernel_tflops"] = flop / row["kernel_ms"] / 1e9
            times.append(row)
            log(f"[5 conv] {name:42s} x{shape} F={f:<3d} kernel {row['kernel_ms']:.3f} ms "
                f"({row['kernel_tflops']:.1f} TFLOP/s) | plain {row['plain_ms']:.3f} ms | "
                f"plain TF32 {row['plain_tf32_ms']:.3f} ms | kernel bf16 {row['kernel_bf16_ms']:.3f} ms")
            del x, w, b, xb, wb, bb
        conv_ms = sum(r["kernel_ms"] for r in times)
        plain_ms = sum(r["plain_ms"] for r in times)
        plain_tf32_ms = sum(r["plain_tf32_ms"] for r in times)
        tflop = sum(2 * 27 * np.prod(s) * f for _, s, f in shapes) / 1e12
        log(f"[5 conv] all {n_conv} convs of one forward: kernel {conv_ms:.2f} ms | plain {plain_ms:.2f} ms | "
            f"plain TF32 {plain_tf32_ms:.2f} ms | {tflop:.3f} TFLOP")

        torch.cuda.reset_peak_memory_stats()
        fwd_ms = timed_ms(lambda: model(x0))
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        with plain_conv():
            fwd_plain_ms = timed_ms(lambda: model(x0))
            torch.backends.cudnn.allow_tf32 = True
            fwd_plain_tf32_ms = timed_ms(lambda: model(x0))
            torch.backends.cudnn.allow_tf32 = False
    log(f"[5 forward] one {patch_in} patch: kernel {fwd_ms:.2f} ms | plain conv {fwd_plain_ms:.2f} ms | "
        f"plain conv TF32 {fwd_plain_tf32_ms:.2f} ms | peak memory {peak_gib:.2f} GiB")

    walls = []
    for _ in range(RUNS):
        start = time.perf_counter()
        predictor.predict_array(volume, PATCH, STRIDE, HALO, TRANSFORMER)
        walls.append(time.perf_counter() - start)
    wall = statistics.median(walls)
    log(f"[5 predict] predict_array {VOLUME}: median {wall:.3f} s of {RUNS} -> "
        f"{np.prod(VOLUME) / wall / 1e6:.3f} Mvoxel/s (runs: {', '.join(f'{t:.3f}' for t in walls)})")

    kernels = [{"name": "conv3d_fwd", "route": "cuda", "source": "pytorch3dunet_tpu_torch/csrc/conv3d_fwd.cu",
                "replaces": "pytorch3dunet_tpu/ops/conv_pallas.py:135", "launches": launches,
                "max_abs_err": errors[torch.float32], "max_abs_err_bf16": errors[torch.bfloat16],
                "ms": conv_ms, "plain_ms": plain_ms, "plain_tf32_ms": plain_tf32_ms, "shapes": n_conv}]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
