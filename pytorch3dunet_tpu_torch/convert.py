"""Checkpoint conversion CLI of the port, both ways between the reference's
torch format and the JAX package's npz format:

    # a torch checkpoint (the reference's, or the port's own) -> a JAX npz checkpoint
    python -m pytorch3dunet_tpu_torch.convert --config train_config.yml -i best_checkpoint.pytorch -o native.ckpt

    # a JAX npz checkpoint -> a torch checkpoint the reference and the port load
    python -m pytorch3dunet_tpu_torch.convert --config train_config.yml -i native.ckpt -o for_torch.pytorch

The counterpart of the JAX package's `convert3dunet` (pytorch3dunet_tpu/convert.py),
with numpy alone: the npz is read and written by `utils/weights.py`. `--to
auto` writes the opposite format of the input's. `--to torch` writes
`{"model_state_dict": ...}` under the reference's key names; `--to native` from
a torch input writes a fresh-start checkpoint (`num_epochs: 0`,
`num_iterations: 1`, `best_eval_score: None`), and from an npz input keeps its
other entries as they are. Like the JAX tool it converts the raw
`model_state_dict`, never a checkpoint's EMA weights.

The config's model section is required: the npz holds its leaves by position
against the model's own tree, and the conversion checks that the checkpoint
has the configured architecture (a leaf of another shape raises a
`ValueError` that names the shape).
"""

import argparse

import torch

from pytorch3dunet_tpu_torch.models.unet import get_model
from pytorch3dunet_tpu_torch.utils.misc import get_logger
from pytorch3dunet_tpu_torch.utils.weights import (is_jax_checkpoint, jax_checkpoint_bytes, load_weights,
                                                   read_jax_checkpoint)

logger = get_logger("ConvertCheckpoint")


def convert_checkpoint(config: dict, input_path, output_path, to: str = "auto") -> str:
    """Converts `input_path` into the `to` format ('auto', 'torch' or
    'native') at `output_path`; returns the format written."""
    if "model" not in config:
        raise ValueError("The config must contain a 'model' section")
    if to not in ("auto", "torch", "native"):
        raise ValueError(f"unknown target format {to!r}: expected 'auto', 'torch' or 'native'")
    model = get_model(config["model"])
    input_is_torch = not is_jax_checkpoint(input_path)
    if to == "auto":
        to = "native" if input_is_torch else "torch"
    try:
        load_weights(model, input_path, ema=False)
    except RuntimeError as e:  # torch's load_state_dict: a key or a shape the model does not have
        raise ValueError(f"{input_path} does not fit the configured model (was the checkpoint trained with a "
                         f"different model configuration?): {e}") from e
    # torch checkpoints carry no counters or optimizer state the JAX trainer
    # can use: a fresh-start checkpoint (weights only)
    state = ({"num_epochs": 0, "num_iterations": 1, "best_eval_score": None} if input_is_torch
             else read_jax_checkpoint(input_path))
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}

    if to == "torch":
        torch.save({"model_state_dict": weights}, output_path)
    else:
        with open(output_path, "wb") as f:
            f.write(jax_checkpoint_bytes({**state, "model_state_dict": weights}))
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"Converted {input_path} ({'torch' if input_is_torch else 'native'}) -> {output_path} ({to}); "
                f"{n_params:,} parameters")
    return to


def _parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Convert checkpoints between the torch and the JAX npz format")
    parser.add_argument("--config", required=True,
                        help="YAML config with the model section the checkpoint was trained with")
    parser.add_argument("--input", "-i", required=True, help="checkpoint to convert (torch or JAX npz)")
    parser.add_argument("--output", "-o", required=True, help="output checkpoint path")
    parser.add_argument("--to", choices=["auto", "torch", "native"], default="auto",
                        help="target format (default: the opposite of the input's)")
    return parser.parse_args(argv)


def main(argv=None) -> str:
    import yaml

    args = _parse_args(argv)
    with open(args.config) as f:
        config = yaml.safe_load(f)
    return convert_checkpoint(config, args.input, args.output, to=args.to)


if __name__ == "__main__":
    main()
