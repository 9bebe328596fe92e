"""Export CLI of the port: the serving forward as a self-contained `torch.export` artifact.

    python -m pytorch3dunet_tpu_torch.export --config test_config.yml -o model.u3dx
    python -m pytorch3dunet_tpu_torch.export --config train_config.yml -i best.pytorch -o model.u3dx \\
        --patch-shape 112 240 240 --batch poly --normalize standardize --mean 0 --std 1

The counterpart of the JAX package's `export3dunet` (pytorch3dunet_tpu/export.py),
which packages the forward with `jax.export`. Here the forward is a
`torch.export` program, weights inside, and the artifact keeps the JAX
artifact's contract: a raw patch (B, [D,] H, W, Cin) float32 in,
probabilities (B, [D,] H, W, Cout) float32 out, with the normalization
(`--normalize`, applied per sample), the network and its final activation
inside, so a caller feeds either artifact the same array. The permutes to
and from the model's NCDHW sit inside the program.

Artifact (a zip, conventionally `.u3dx`):

    forward.pt2   `torch.export.save` of the exported program; B symbolic
                  (`torch.export.Dim`) unless --batch fixes it
    meta.json     the JAX artifact's keys, with `torch_version`, the `device`
                  it was traced on and runs on, the compute `dtype`, and the
                  `custom_ops` its graph may call

The model's 3x3x3 convs are calls of the custom op
`pytorch3dunet_tpu_torch::conv3d_fwd` (ops/conv3d.py), and a CUDA artifact's
GroupNorms calls of `pytorch3dunet_tpu_torch::group_norm_fwd`
(ops/group_norm.py): a CUDA artifact runs the hand kernels, a CPU one their
plain version (and torch's GroupNorm). So loading an artifact needs the ops
registered, that is `pytorch3dunet_tpu_torch.ops.conv3d` and `.group_norm`
imported, which `load_exported` does:

    from pytorch3dunet_tpu_torch.export import load_exported
    model = load_exported("model.u3dx")
    probs = model(patch)   # numpy (B, D, H, W, Cin) or one unbatched patch

The trace runs on the device of the config (the port's rule: CUDA unless the
config says `device: cpu`), under `torch.no_grad()` with the parameters
frozen, so every 3x3x3 conv takes `conv3d_fwd`, every GroupNorm on CUDA
`group_norm_fwd`, and the ops' fake implementations give the trace its
shapes. A checkpoint's EMA weights are baked in when it carries them
(`utils/weights.py` `load_weights`).
"""

import argparse
import io
import json
import zipfile

import numpy as np
import torch
import torch.nn as nn

from pytorch3dunet_tpu_torch.__version__ import __version__
from pytorch3dunet_tpu_torch.config import resolve_device
from pytorch3dunet_tpu_torch.inference_device import normalize
from pytorch3dunet_tpu_torch.models.unet import get_model, is_model_2d
from pytorch3dunet_tpu_torch.ops import conv3d, group_norm
from pytorch3dunet_tpu_torch.utils.misc import get_logger
from pytorch3dunet_tpu_torch.utils.weights import load_weights

logger = get_logger("ExportModel")

FORMAT = "pytorch3dunet_tpu_torch.export/1"
META_NAME = "meta.json"
FORWARD_NAME = "forward.pt2"
# what the JAX package's artifact holds in place of forward.pt2
JAX_FORWARD_NAME = "forward.jaxexport"
# the port's custom ops, which an exported graph may call and `load_exported` registers
CUSTOM_OPS = [conv3d.OP_NAME, group_norm.OP_NAME]
NORMALIZE_MODES = ("standardize", "standardize_patch", "normalize", "percentile")


class ServingForward(nn.Module):
    """The exported function: normalize each sample, move the channels to
    axis 1, run the model, move them back; (B, *patch, Cin) float32 in,
    (B, *patch, Cout) float32 probabilities out.

    The normalizations are JAX export.py `_normalize_fn`'s, per sample:
    'standardize' with fixed `stats` mean and std, 'standardize_patch' with
    the sample's mean and population std, 'normalize' to [-1, 1] by the
    sample's min and max, 'percentile' by the sample's `pmin` and `pmax`
    percentiles: `inference_device.normalize`, the sweep's own."""

    def __init__(self, model: nn.Module, normalize=None, stats=None):
        super().__init__()
        if normalize is not None and normalize not in NORMALIZE_MODES:
            raise ValueError(f"Unsupported normalization mode for export: {normalize!r}")
        stats = stats or {}
        self.model = model
        self.normalize = normalize
        self.stats = {"pmin": float(stats.get("pmin", 1.0)), "pmax": float(stats.get("pmax", 99.6))}
        if normalize == "standardize":
            self.stats.update(mean=float(stats["mean"]), std=float(stats["std"]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = normalize(x, self.normalize, self.stats, per_sample=True)
        probs = self.model(x.movedim(-1, 1))[0]
        return probs.movedim(1, -1)


def export_model(config: dict, checkpoint_path=None, output_path=None, patch_shape=None, batch="poly",
                 normalize=None, stats=None) -> dict:
    """Builds the model, restores its weights and exports the serving
    forward; writes the artifact to `output_path` and returns its metadata.

    Args:
        config: a config dict; its `model` section is required, its `device`
            is where the program is traced and runs.
        checkpoint_path: checkpoint to bake in (torch or JAX npz; its EMA
            weights when it carries them); defaults to the config's
            `model_path`; with neither, the fresh initialization (for tests).
        patch_shape: the spatial patch shape the artifact serves; default the
            smallest pool-divisible shape (twice the pool factor per axis).
        batch: 'poly' (a symbolic batch dimension) or a fixed int.
        normalize, stats: the normalization baked in front of the network
            (`ServingForward`) and its mean/std (pmin/pmax).
    """
    if "model" not in config:
        raise ValueError("The config must contain a 'model' section")
    device = resolve_device(config.get("device"))
    model = get_model(config["model"])
    checkpoint_path = checkpoint_path or config.get("model_path")
    if checkpoint_path:
        if load_weights(model, checkpoint_path):
            logger.info("Checkpoint carries EMA weights: exporting them")
    else:
        logger.warning("No checkpoint given (and no model_path in the config): exporting the fresh initialization")
    model = model.to(device).eval().requires_grad_(False)

    rank = 2 if is_model_2d(model) else 3
    # every patch dim divisible by the pool kernel to the power of the poolings (JAX export.py:136-142)
    pool = config["model"].get("pool_kernel_size", 2)
    factor = (pool if isinstance(pool, int) else max(pool)) ** (len(model.encoders) - 1)
    patch_shape = (2 * factor,) * rank if patch_shape is None else tuple(int(s) for s in patch_shape)
    if len(patch_shape) != rank:
        raise ValueError(f"patch_shape must have {rank} spatial dims for {type(model).__name__}, got {patch_shape}")
    if any(s % factor for s in patch_shape):
        raise ValueError(f"every patch dim must be divisible by {factor} (pool factor over {len(model.encoders)} "
                         f"levels), got {patch_shape}")
    in_channels = int(config["model"]["in_channels"])

    forward = ServingForward(model, normalize, stats).eval()
    # a symbolic batch is traced at 2: torch specializes a dimension whose example size is 0 or 1
    example = torch.zeros((2 if batch == "poly" else int(batch), *patch_shape, in_channels), device=device)
    dynamic_shapes = ({0: torch.export.Dim("batch", min=1)},) if batch == "poly" else None
    with torch.no_grad():
        program = torch.export.export(forward, (example,), dynamic_shapes=dynamic_shapes)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    blob = buf.getvalue()

    meta = {
        "format": FORMAT,
        "framework_version": __version__,
        "torch_version": torch.__version__,
        "model": dict(config["model"]),
        "is_2d": is_model_2d(model),
        "in_channels": in_channels,
        "out_channels": model.out_channels,
        "patch_shape": list(patch_shape),
        "batch": "poly" if batch == "poly" else int(batch),
        "pool_divisibility": factor,
        "device": str(device),
        "dtype": str(model.compute_dtype or torch.float32).removeprefix("torch."),
        "normalize": normalize,
        "stats": {k: float(v) for k, v in (stats or {}).items()},
        "checkpoint": None if checkpoint_path is None else str(checkpoint_path),
        "n_params": int(sum(p.numel() for p in model.parameters())),
        "custom_ops": CUSTOM_OPS,
    }
    if output_path is not None:
        with zipfile.ZipFile(output_path, "w", compression=zipfile.ZIP_DEFLATED) as z:
            z.writestr(META_NAME, json.dumps(meta, indent=2))
            z.writestr(FORWARD_NAME, blob)
    logger.info(f"Exported {meta['n_params']:,} params -> {output_path} ({len(blob) / 1e6:.1f} MB torch.export "
                f"program, device {device}, patch {patch_shape}, batch {meta['batch']})")
    return meta


class ExportedModel:
    """A loaded artifact: its `meta` dict, the exported `program`, and its
    callable `module` (tensors on the artifact's device in and out).
    Calling the object takes a numpy patch batch (or one unbatched patch) and
    returns numpy probabilities."""

    def __init__(self, program, meta: dict):
        self.program = program
        self.meta = meta
        self.device = torch.device(meta["device"])
        self.module = program.module()

    def __call__(self, x) -> np.ndarray:
        # a copy with the canonical strides: the CPU convolutions choose their
        # algorithm (and summation order) by the strides, and a numpy x[None]
        # carries a 0 stride on its new axis
        x = torch.from_numpy(np.array(x, dtype=np.float32))
        squeeze = x.ndim == len(self.meta["patch_shape"]) + 1  # an unbatched patch
        if squeeze:
            x = x[None]
        with torch.no_grad():
            out = self.module(x.to(self.device)).cpu().numpy()
        return out[0] if squeeze else out


def load_exported(path) -> ExportedModel:
    """Loads an artifact written by `export_model`. The custom ops its graph
    calls are registered by ops/conv3d.py and ops/group_norm.py, imported with
    this module."""
    with zipfile.ZipFile(path) as z:
        names = set(z.namelist())
        if FORWARD_NAME not in names:
            if JAX_FORWARD_NAME in names:
                raise ValueError(f"{path} is an artifact of the JAX package's export3dunet ({JAX_FORWARD_NAME}, a "
                                 f"jax.export program), which the PyTorch port cannot load: load it with JAX, or "
                                 f"export the checkpoint with the port")
            raise ValueError(f"{path} holds no {FORWARD_NAME}: not an artifact of the port's exporter")
        meta = json.loads(z.read(META_NAME))
        blob = z.read(FORWARD_NAME)
    return ExportedModel(torch.export.load(io.BytesIO(blob)), meta)


def _parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Export a trained model as a torch.export serving artifact")
    parser.add_argument("--config", required=True,
                        help="YAML config with the model section (model_path used unless --checkpoint); its "
                             "device is where the artifact runs")
    parser.add_argument("--checkpoint", "-i", default=None, help="checkpoint to bake in (torch or JAX npz)")
    parser.add_argument("--output", "-o", required=True, help="artifact path (conventionally .u3dx)")
    parser.add_argument("--patch-shape", type=int, nargs="+", default=None,
                        help="spatial patch shape served (default: the minimal pool-divisible shape)")
    parser.add_argument("--batch", default="poly", help="'poly' (symbolic batch, default) or a fixed batch size")
    parser.add_argument("--normalize", default=None, choices=NORMALIZE_MODES,
                        help="bake this normalization in front of the network")
    parser.add_argument("--mean", type=float, default=None)
    parser.add_argument("--std", type=float, default=None)
    parser.add_argument("--pmin", type=float, default=None)
    parser.add_argument("--pmax", type=float, default=None)
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    import yaml

    args = _parse_args(argv)
    with open(args.config) as f:
        config = yaml.safe_load(f)
    stats = {k: v for k, v in (("mean", args.mean), ("std", args.std), ("pmin", args.pmin), ("pmax", args.pmax))
             if v is not None}
    batch = args.batch if args.batch == "poly" else int(args.batch)
    return export_model(config, args.checkpoint, args.output, patch_shape=args.patch_shape, batch=batch,
                        normalize=args.normalize, stats=stats)


if __name__ == "__main__":
    main()
