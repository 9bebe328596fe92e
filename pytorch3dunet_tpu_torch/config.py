"""Config loading for the port: YAML, the dotted CLI overrides of
pytorch3dunet_tpu/config.py, and the torch device.

`device: cuda | cpu`. The port runs on the card unless the config says
`device: cpu`: without the key, and for the legacy values `tpu` and `mps`, it
takes `cuda` when a CUDA device is present and raises, naming `device: cpu`,
when none is. An explicit `cuda` without a CUDA device raises too.

On CUDA the port computes in float32: `resolve_device` turns cuDNN's and
cuBLAS's TF32 off (`use_float32_math`), so the convolutions and matrix products
that run outside the hand-written kernels (the 1x1 final conv, the weight
gradient, the deconv, the SE layers) give the numbers the JAX package and
chip_smoke.py check, not TF32's.
"""

import argparse
import os
import shutil

import torch

from pytorch3dunet_tpu_torch.utils.misc import get_logger

logger = get_logger("ConfigLoader")

_LEGACY_DEVICES = ("tpu", "mps")

# override flags of both CLIs: (dotted config path, element type, nargs), the
# set of pytorch3dunet_tpu/config.py:38-44
_CLI_OVERRIDES = (
    ("model_path", str, None),
    ("loaders.output_dir", str, None),
    ("loaders.test.file_paths", str, "+"),
    ("loaders.test.slice_builder.patch_shape", int, "+"),
    ("loaders.test.slice_builder.stride_shape", int, "+"),
)


def use_float32_math():
    """Full float32 in cuDNN convolutions and cuBLAS matrix products (PyTorch
    lets cuDNN use TF32 by default)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _default_cuda(reason: str) -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{reason} and no CUDA device is available: the port runs on the GPU unless the "
                           f"config says 'device: cpu'")
    return torch.device("cuda")


def resolve_device(config_device) -> torch.device:
    """The torch device of a config's `device` value (see the module
    docstring); never the CPU unless asked for."""
    if isinstance(config_device, torch.device):
        device = config_device
    elif config_device == "cpu":
        return torch.device("cpu")
    elif config_device is None:
        device = _default_cuda("Config has no 'device' key")
        logger.info(f"Config has no 'device' key -- using {device}")
    elif config_device in _LEGACY_DEVICES:
        device = _default_cuda(f"Config asks for the legacy device '{config_device}'")
        logger.warning(f"Legacy device '{config_device}' in config; using '{device}' instead")
    elif isinstance(config_device, str) and config_device.split(":")[0] == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"Config asks for device '{config_device}' but no CUDA device is available")
        device = torch.device(config_device)
    else:
        raise ValueError(f"Config key device: {config_device} not understood -- supported values: cuda, cpu")
    if device.type == "cuda":
        use_float32_math()
    return device


def override_config(args, config):
    """Writes non-None CLI values into the config dict; dotted keys descend
    into nested dicts, unknown keys raise (pytorch3dunet_tpu/config.py:77-93)."""
    overrides = {k: v for k, v in vars(args).items() if k != "config" and v is not None}
    for dotted, value in overrides.items():
        node = config
        for part in dotted.split("."):
            if part not in node:
                raise ValueError(f"Invalid config key: {dotted}")
            if isinstance(node[part], dict):
                node = node[part]
            else:
                node[part] = value


def load_config(argv=None) -> tuple[dict, str]:
    import yaml

    parser = argparse.ArgumentParser(description="UNet3D (PyTorch)")
    parser.add_argument("--config", type=str, help="Path to the YAML config file", required=True)
    for dotted, typ, nargs in _CLI_OVERRIDES:
        parser.add_argument(f"--{dotted}", type=typ, nargs=nargs, required=False)

    args = parser.parse_args(argv)
    with open(args.config) as f:
        config = yaml.safe_load(f)
    override_config(args, config)

    config["device"] = resolve_device(config.get("device", None))
    if config["device"].type == "cpu":
        logger.warning("Running on CPU (device: cpu): expect slow training/prediction")
    return config, args.config


def copy_config(config: dict, config_path: str):
    """Copies the config file into the newest run directory under
    checkpoint_dir/logs (pytorch3dunet_tpu/config.py `copy_config`)."""
    logs_root = os.path.join(config["trainer"].pop("checkpoint_dir"), "logs")
    if not os.path.isdir(logs_root):
        return
    run_dirs = [entry.path for entry in os.scandir(logs_root) if entry.is_dir()]
    if run_dirs:
        shutil.copy2(config_path, os.path.join(max(run_dirs), os.path.basename(config_path)))
