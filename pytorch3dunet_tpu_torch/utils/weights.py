"""Weights for the port's models: from the JAX package's variables, or from a
torch-format `.pytorch` checkpoint.

Both use the reference state-dict layout that the JAX package's torch interop
writes (`convert3dunet --to torch`, `save_torch_checkpoint`), so such a
checkpoint loads with `strict=True`. The JAX variables cross through the port's
own copy of that export (`utils/interop.py`): conv and ResNet keys, the deconv's
tap flip, and the SE layers' keys.
"""

import zipfile

import numpy as np
import torch

from pytorch3dunet_tpu_torch.utils.interop import batch_stats_to_torch_entries, params_to_torch_state_dict


def state_dict_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    """The JAX package's variables ({'params'[, 'batch_stats']}) as the
    port's state dict."""
    entries = params_to_torch_state_dict(variables["params"])
    if variables.get("batch_stats"):
        entries.update(batch_stats_to_torch_entries(variables["batch_stats"]))
    # np.array copies: JAX arrays export read-only buffers
    return {k: torch.from_numpy(np.array(v)) for k, v in entries.items()}


def _jax_checkpoint_names(path) -> list[str] | None:
    """The entry names of a JAX-format checkpoint, None for any other file.
    The JAX package's npz checkpoints are zips holding `__meta__.npy`
    (pytorch3dunet_tpu/utils/checkpoint.py `_is_torch_checkpoint`)."""
    try:
        with zipfile.ZipFile(path) as z:
            names = z.namelist()
    except zipfile.BadZipFile:
        return None
    return names if "__meta__.npy" in names else None


# the leaves of a checkpoint's `ema_state_dict` (written by `trainer.ema_decay`)
_EMA_PREFIX = "__tree__/ema_state_dict/"


def refuse_jax_checkpoint(path) -> None:
    """Raises, with the convert hint, when `path` is a JAX-format checkpoint.
    When it carries EMA weights, the message says that the converted file
    holds the raw weights, which the JAX predictor does not use."""
    names = _jax_checkpoint_names(path)
    if names is None:
        return
    message = (f"{path} is a JAX-format checkpoint; convert it first with "
               f"`convert3dunet --config <config.yml> -i {path} -o <out>.pytorch --to torch`")
    if any(name.startswith(_EMA_PREFIX) for name in names):
        message += (". It carries EMA weights (`ema_state_dict`), which predict3dunet predicts with; the "
                    "converted file carries the raw weights (`model_state_dict`), not the EMA weights")
    raise ValueError(message)


def load_weights(model: torch.nn.Module, path) -> None:
    """Loads a torch-format checkpoint (a bare state dict or one under
    'model_state_dict') into `model` with strict key matching."""
    refuse_jax_checkpoint(path)
    state = torch.load(path, map_location="cpu", weights_only=True)
    if "model_state_dict" in state:
        state = state["model_state_dict"]
    model.load_state_dict(state, strict=True)
