"""Weights for the port's models: from the JAX package's variables, from a JAX
npz checkpoint, or from a torch-format `.pytorch` checkpoint.

All three cross into the reference state-dict layout that the JAX package's
torch interop writes (`convert3dunet --to torch`, `save_torch_checkpoint`), so
the model loads them with `strict=True`. The JAX variables cross through the
port's own copy of that export (`utils/interop.py`): conv and ResNet keys, the
deconv's tap flip, and the SE layers' keys.

A JAX npz checkpoint (pytorch3dunet_tpu/utils/checkpoint.py `state_to_bytes`)
holds each pytree as its leaves in `jax.tree_util` order, under
`__tree__/<key>/<index>`. `jax_checkpoint_bytes` writes one and
`load_jax_checkpoint` reads it, both with numpy alone: the
flax tree of the port model's own state dict (`utils/interop.py`) names and
orders the leaves, and the EMA weights (`ema_state_dict`, the params leaves of
a run with `trainer.ema_decay`) replace the params when present, as
`predict3dunet` predicts with them (JAX `predict.py` `load_model_variables`).
A port checkpoint of such a run carries its EMA weights as `ema_state_dict`,
which `load_weights` prefers the same way. The trainer's `pre_trained` asks
for the raw weights instead (`ema=False`), as JAX `train3dunet` fine-tunes
from a checkpoint's `model_state_dict`.
"""

import io
import json
import zipfile

import numpy as np
import torch

from pytorch3dunet_tpu_torch.utils.interop import (batch_stats_to_torch_entries, params_to_torch_state_dict,
                                                   torch_state_dict_to_batch_stats, torch_state_dict_to_params,
                                                   tree_from_paths, tree_leaves_with_paths)
from pytorch3dunet_tpu_torch.utils.misc import get_logger

logger = get_logger("Weights")


def state_dict_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    """The JAX package's variables ({'params'[, 'batch_stats']}) as the
    port's state dict."""
    entries = params_to_torch_state_dict(variables["params"])
    if variables.get("batch_stats"):
        entries.update(batch_stats_to_torch_entries(variables["batch_stats"]))
    # np.array copies: JAX arrays export read-only buffers
    return {k: torch.from_numpy(np.array(v)) for k, v in entries.items()}


def is_jax_checkpoint(path) -> bool:
    """Whether `path` is a JAX-format npz checkpoint: a zip holding
    `__meta__.npy` (pytorch3dunet_tpu/utils/checkpoint.py `_is_torch_checkpoint`)."""
    try:
        with zipfile.ZipFile(path) as z:
            return "__meta__.npy" in z.namelist()
    except (zipfile.BadZipFile, IsADirectoryError):
        return False


def read_jax_checkpoint(path) -> dict:
    """The metadata and pytree leaf lists of a JAX npz checkpoint:
    {key: value} for the scalars, {key: [leaf, ...]} for each pytree."""
    with open(path, "rb") as f, np.load(io.BytesIO(f.read()), allow_pickle=False) as data:
        meta = json.loads(bytes(data["__meta__"].tobytes()).decode())
        trees: dict[str, dict[int, np.ndarray]] = {}
        for name in data.files:
            if name.startswith("__tree__/"):
                _, key, index = name.split("/")
                trees.setdefault(key, {})[int(index)] = data[name]
    state = {k: v for k, v in meta.items() if not k.startswith("__tree_len__/")}
    # a pytree of no leaves stores no arrays: its key comes back as []
    state.update({k.split("/", 1)[1]: [] for k, v in meta.items() if k.startswith("__tree_len__/") and v == 0})
    for key, leaves in trees.items():
        state[key] = [leaves[i] for i in sorted(leaves)]
    return state


def _restore(template: list[tuple[str, np.ndarray]], leaves: list[np.ndarray], what: str) -> list:
    """(path, leaf) pairs of `leaves` restored against the template's paths,
    each checked against the template's shape."""
    if len(leaves) != len(template):
        raise ValueError(f"{what} has {len(leaves)} leaves but the model has {len(template)} "
                         f"(was the checkpoint trained with a different model configuration?)")
    restored = []
    for (path, want), leaf in zip(template, leaves):
        if leaf.shape != want.shape:
            raise ValueError(f"{what} leaf {path} has shape {leaf.shape} but the model expects {want.shape} "
                             f"(was the checkpoint trained with a different model configuration?)")
        restored.append((path, leaf.astype(np.float32)))
    return restored


def _jax_leaves_with_paths(state_dict: dict) -> tuple[list, list]:
    """The ('batch_stats/...' and 'params/...' path, leaf) pairs of the JAX
    variables of a port state dict, in `jax.tree_util` order, and the params
    pairs alone (paths without the collection)."""
    own = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    params = tree_leaves_with_paths(torch_state_dict_to_params(own))
    batch_stats = tree_leaves_with_paths(torch_state_dict_to_batch_stats(own))
    # jax.tree_util orders the collections of {'batch_stats', 'params'} by key too
    return [(f"batch_stats/{p}", v) for p, v in batch_stats] + [(f"params/{p}", v) for p, v in params], params


def load_jax_checkpoint(model: torch.nn.Module, path, ema: bool = True) -> bool:
    """Loads a JAX npz checkpoint into `model`: its EMA weights when it
    carries them and `ema`, else `model_state_dict`. Returns whether the EMA
    weights were used."""
    state = read_jax_checkpoint(path)
    template, params = _jax_leaves_with_paths(model.state_dict())
    variables = tree_from_paths(_restore(template, state["model_state_dict"], f"{path}: model_state_dict"))
    used_ema = ema and bool(state.get("ema_state_dict"))
    if used_ema:
        variables["params"] = tree_from_paths(_restore(params, state["ema_state_dict"], f"{path}: ema_state_dict"))
        logger.info("Checkpoint carries EMA weights (trainer.ema_decay): predicting with them")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return used_ema


def jax_checkpoint_bytes(state: dict) -> bytes:
    """A JAX npz checkpoint of `state`, in the layout of the JAX package's
    `state_to_bytes` (pytorch3dunet_tpu/utils/checkpoint.py): JSON scalars and
    None go to `__meta__`; `model_state_dict`, a port state dict, goes as the
    leaves of its JAX variables in `jax.tree_util` order (the inverse of
    `load_jax_checkpoint`); any other value is a list of leaves, written as
    it is (what `read_jax_checkpoint` returns for a pytree)."""
    arrays, meta = {}, {}
    for key, value in state.items():
        if isinstance(value, (int, float, str, bool)) or value is None:
            meta[key] = value
            continue
        if key == "model_state_dict":
            value = [leaf for _, leaf in _jax_leaves_with_paths(value)[0]]
        for i, leaf in enumerate(value):
            arrays[f"__tree__/{key}/{i:05d}"] = np.asarray(leaf)
        meta[f"__tree_len__/{key}"] = len(value)
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def load_weights(model: torch.nn.Module, path, ema: bool = True) -> bool:
    """Loads a JAX npz checkpoint (`load_jax_checkpoint`) or a torch-format
    checkpoint (a bare state dict or one under 'model_state_dict') into
    `model` with strict key matching. With `ema`, a checkpoint's EMA weights
    replace the parameters when it carries them. Returns whether they did."""
    if is_jax_checkpoint(path):
        return load_jax_checkpoint(model, path, ema=ema)
    state = torch.load(path, map_location="cpu", weights_only=True)
    weights = state.get("model_state_dict", state)
    used_ema = ema and bool(state.get("ema_state_dict"))
    if used_ema:
        weights = {**weights, **state["ema_state_dict"]}
        logger.info("Checkpoint carries EMA weights (trainer.ema_decay): predicting with them")
    model.load_state_dict(weights, strict=True)
    return used_ema
