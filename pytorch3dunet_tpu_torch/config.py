"""Config loading for the port: YAML, the dotted CLI overrides of
pytorch3dunet_tpu/config.py, and the torch device.

`device: cuda | cpu`. Without the key the device is autodetected and logged.
An explicit `cuda` without a CUDA device raises: the port never runs on the CPU
in its place. The legacy values `tpu` and `mps` are mapped to the autodetected
device with a warning, as the JAX package maps `cuda`.
"""

import argparse
import os
import shutil

import torch

from pytorch3dunet_tpu.utils.misc import get_logger

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


def default_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def resolve_device(config_device) -> torch.device:
    if config_device is None:
        device = default_device()
        logger.info(f"Config has no 'device' key -- autodetected {device}")
        return device
    if isinstance(config_device, torch.device):
        return config_device
    if config_device in _LEGACY_DEVICES:
        device = default_device()
        logger.warning(f"Legacy device '{config_device}' in config; using '{device}' instead")
        return device
    if config_device == "cpu":
        return torch.device("cpu")
    if isinstance(config_device, str) and config_device.split(":")[0] == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"Config asks for device '{config_device}' but no CUDA device is available")
        return torch.device(config_device)
    raise ValueError(f"Config key device: {config_device} not understood -- supported values: cuda, cpu")


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
        logger.warning("Running on CPU: expect slow training/prediction")
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
