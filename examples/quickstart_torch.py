"""End-to-end quickstart of the PyTorch port: synthetic data ->
`python -m pytorch3dunet_tpu_torch.train` -> `python -m pytorch3dunet_tpu_torch.predict` -> Dice.

The port's copy of examples/quickstart.py. It generates a small synthetic
segmentation problem (smoothed noise thresholded into blobs), trains a UNet3D
with the BCEDice loss through the port's train CLI, predicts the held-out
volume with the device-side sliding-window sweep through its predict CLI, and
reports the Dice score against the ground truth.

    python examples/quickstart_torch.py --workdir quickstart_torch_run --iterations 200

It runs on the GPU (bf16 compute, the 3x3x3 convs on the hand kernels), as
every entry point of the port does; --device cpu runs the plain versions on
the CPU instead and finishes in a few minutes.
The CLIs read and write H5 and YAML, so the machine needs h5py and yaml.
"""

import argparse
import os
import subprocess
import sys

import h5py
import numpy as np
import yaml


def make_volume(rs, shape, sigma=3.0):
    """Smoothed noise; thresholding its upper quartile yields blob labels."""
    raw = rs.rand(*shape).astype(np.float32)
    # separable box-blur passes approximate a Gaussian without scipy
    for _ in range(3):
        for axis in range(3):
            raw = (raw + np.roll(raw, 1, axis) + np.roll(raw, -1, axis)) / 3.0
    raw = (raw - raw.min()) / (raw.max() - raw.min() + 1e-8)
    label = (raw > np.percentile(raw, 75)).astype(np.float32)
    return raw, label


def write_h5(path, raw, label=None):
    with h5py.File(path, "w") as f:
        f.create_dataset("raw", data=raw)
        if label is not None:
            f.create_dataset("label", data=label)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default="quickstart_torch_run")
    ap.add_argument("--iterations", type=int, default=200)
    ap.add_argument("--shape", type=int, nargs=3, default=(32, 96, 96))
    ap.add_argument("--patch", type=int, nargs=3, default=(16, 48, 48))
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    args = ap.parse_args()

    wd = os.path.abspath(args.workdir)
    os.makedirs(os.path.join(wd, "ckpt"), exist_ok=True)
    os.makedirs(os.path.join(wd, "out"), exist_ok=True)

    rs = np.random.RandomState(0)
    for name in ("train.h5", "val.h5"):
        raw, label = make_volume(rs, tuple(args.shape))
        write_h5(os.path.join(wd, name), raw, label)
    test_raw, test_label = make_volume(rs, tuple(args.shape))
    write_h5(os.path.join(wd, "test.h5"), test_raw, test_label)

    patch = list(args.patch)
    transformer = {
        "raw": [{"name": "Standardize"}, {"name": "RandomFlip"}, {"name": "ToTensor", "expand_dims": True}],
        "label": [{"name": "RandomFlip"}, {"name": "ToTensor", "expand_dims": True}],
    }
    eval_transformer = {
        "raw": [{"name": "Standardize"}, {"name": "ToTensor", "expand_dims": True}],
        "label": [{"name": "ToTensor", "expand_dims": True}],
    }
    train_config = {
        "device": args.device,
        "manual_seed": 0,
        "model": {"name": "UNet3D", "in_channels": 1, "out_channels": 1, "layer_order": "gcr",
                  "f_maps": 16, "num_groups": 4, "num_levels": 3, "final_sigmoid": True,
                  **({"dtype": "bfloat16"} if args.device == "cuda" else {})},
        "loss": {"name": "BCEDiceLoss"},
        "eval_metric": {"name": "DiceCoefficient"},
        "optimizer": {"learning_rate": 2e-3},
        "lr_scheduler": {"name": "MultiStepLR", "milestones": [10**6], "gamma": 0.5},
        "trainer": {"checkpoint_dir": os.path.join(wd, "ckpt"), "resume": None,
                    "validate_after_iters": max(args.iterations // 2, 1),
                    "log_after_iters": max(args.iterations // 10, 1),
                    "max_num_epochs": 10**6, "max_num_iterations": args.iterations,
                    "eval_score_higher_is_better": True},
        "loaders": {
            "dataset": "StandardHDF5Dataset", "batch_size": 1, "num_workers": 2,
            "raw_internal_path": "raw", "label_internal_path": "label",
            "train": {"file_paths": [os.path.join(wd, "train.h5")],
                      "slice_builder": {"name": "SliceBuilder", "patch_shape": patch,
                                        "stride_shape": [max(p // 2, 1) for p in patch],
                                        "skip_shape_check": True},
                      "transformer": transformer},
            "val": {"file_paths": [os.path.join(wd, "val.h5")],
                    "slice_builder": {"name": "SliceBuilder", "patch_shape": patch,
                                      "stride_shape": patch, "skip_shape_check": True},
                    "transformer": eval_transformer},
        },
    }
    test_config = {
        "device": args.device,
        "model_path": os.path.join(wd, "ckpt", "last_checkpoint.pytorch"),
        "model": dict(train_config["model"]),
        "predictor": {"name": "DeviceSlidingWindowPredictor", "blend": "gaussian"},
        "loaders": {
            "dataset": "StandardHDF5Dataset", "output_dir": os.path.join(wd, "out"),
            "batch_size": 1, "num_workers": 1, "raw_internal_path": "raw",
            "test": {"file_paths": [os.path.join(wd, "test.h5")],
                     "slice_builder": {"name": "SliceBuilder", "patch_shape": patch,
                                       "stride_shape": [max(p // 2, 1) for p in patch],
                                       "halo_shape": [max(p // 4, 1) for p in patch],
                                       "skip_shape_check": True},
                     "transformer": {"raw": eval_transformer["raw"]}},
        },
    }
    with open(os.path.join(wd, "train_config.yml"), "w") as f:
        yaml.safe_dump(train_config, f)
    with open(os.path.join(wd, "test_config.yml"), "w") as f:
        yaml.safe_dump(test_config, f)

    env = dict(os.environ)
    for step, cfg in (("train", "train_config.yml"), ("predict", "test_config.yml")):
        print(f"=== python -m pytorch3dunet_tpu_torch.{step} --config {cfg}", flush=True)
        subprocess.run([sys.executable, "-m", f"pytorch3dunet_tpu_torch.{step}",
                        "--config", os.path.join(wd, cfg)], check=True, env=env)

    with h5py.File(os.path.join(wd, "out", "test_predictions.h5")) as f:
        probs = f["predictions"][:]  # (1, D, H, W)
    pred = (probs[0] > 0.5).astype(np.float32)
    inter = float((pred * test_label).sum())
    dice = 2 * inter / float(pred.sum() + test_label.sum() + 1e-8)
    print(f"Quickstart finished: Dice vs ground truth = {dice:.3f} "
          f"(predictions in {os.path.join(wd, 'out')})")
    return dice


if __name__ == "__main__":
    main()
