"""The port's refusal of the JAX package's npz checkpoints
(pytorch3dunet_tpu_torch/utils/weights.py `refuse_jax_checkpoint`), on
checkpoints written by the JAX package's own `state_to_bytes`.

A checkpoint trained with `trainer.ema_decay` carries `ema_state_dict`, which
predict3dunet predicts with; `convert3dunet --to torch` exports only
`model_state_dict`. The refusal says so for such a checkpoint, and keeps its
message as it was for any other.
"""

import numpy as np
import pytest

from pytorch3dunet_tpu.utils.checkpoint import state_to_bytes
from pytorch3dunet_tpu_torch.utils.weights import refuse_jax_checkpoint

EMA_SENTENCE = "not the EMA weights"


def _write(path, ema):
    rs = np.random.RandomState(0)
    params = {"conv": {"kernel": rs.rand(3, 3, 3, 2, 4).astype(np.float32), "bias": np.zeros(4, np.float32)}}
    state = {"num_epochs": 1, "num_iterations": 5, "model_state_dict": {"params": params}, "best_eval_score": 0.5,
             "optimizer_state_dict": None}
    if ema:
        state["ema_state_dict"] = {k: {n: 0.9 * a for n, a in v.items()} for k, v in params.items()}
    path.write_bytes(state_to_bytes(state))
    return path


def test_refusal_names_the_dropped_ema_weights(tmp_path):
    path = _write(tmp_path / "ema.pytorch", ema=True)
    with pytest.raises(ValueError) as raised:
        refuse_jax_checkpoint(path)
    message = str(raised.value)
    assert "convert3dunet --config <config.yml> -i" in message and "--to torch" in message
    assert "ema_state_dict" in message and EMA_SENTENCE in message


def test_refusal_without_ema_keeps_its_message(tmp_path):
    path = _write(tmp_path / "plain.pytorch", ema=False)
    with pytest.raises(ValueError) as raised:
        refuse_jax_checkpoint(path)
    assert str(raised.value) == (f"{path} is a JAX-format checkpoint; convert it first with "
                                 f"`convert3dunet --config <config.yml> -i {path} -o <out>.pytorch --to torch`")
    assert "EMA" not in str(raised.value)


def test_other_files_pass(tmp_path):
    text = tmp_path / "notes.txt"
    text.write_text("not a zip")
    refuse_jax_checkpoint(text)
