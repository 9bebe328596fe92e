"""Training checkpoints of the port: `torch.save` dicts in the reference
pytorch-3dunet format.

A checkpoint holds `model_state_dict` (the reference's keys, so the JAX
package's `load_checkpoint` and both predict CLIs read it), `optimizer_state_dict`,
`num_epochs`, `num_iterations` and `best_eval_score`. `last_checkpoint.pytorch`
is written at every validation and copied to `best_checkpoint.pytorch` when the
score improves (pytorch3dunet_tpu/utils/checkpoint.py `save_checkpoint`).
"""

import os
import shutil

import torch

from pytorch3dunet_tpu_torch.utils.weights import is_jax_checkpoint

LAST_CHECKPOINT = "last_checkpoint.pytorch"
BEST_CHECKPOINT = "best_checkpoint.pytorch"


def save_checkpoint(state: dict, is_best: bool, checkpoint_dir: str):
    """Writes last_checkpoint.pytorch atomically; copies it to
    best_checkpoint.pytorch when `is_best`."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    last_file_path = os.path.join(checkpoint_dir, LAST_CHECKPOINT)
    # write then rename: a crash mid-write never truncates the only resume point
    tmp_path = last_file_path + ".tmp"
    try:
        torch.save(state, tmp_path)
        os.replace(tmp_path, last_file_path)
    finally:
        if os.path.exists(tmp_path):
            os.unlink(tmp_path)
    if is_best:
        shutil.copyfile(last_file_path, os.path.join(checkpoint_dir, BEST_CHECKPOINT))


def load_checkpoint(path) -> dict:
    """Reads a torch-format checkpoint onto the CPU, for `resume` and
    `pre_trained`. A JAX npz checkpoint raises: its optimizer state is
    optax's; the predict CLI reads its weights (`utils/weights.py`)."""
    if not os.path.exists(path):
        raise OSError(f"Checkpoint '{path}' does not exist")
    if is_jax_checkpoint(path):
        raise ValueError(f"{path} is a JAX-format checkpoint, which the port's trainer does not resume from (its "
                         f"optimizer state is optax's); convert its weights first with `convert3dunet --config "
                         f"<config.yml> -i {path} -o <out>.pytorch --to torch`")
    return torch.load(path, map_location="cpu", weights_only=True)
