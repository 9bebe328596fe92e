"""The port's train CLI on two ranks (pytorch3dunet_tpu_torch/train.py joined
through P3DUNET_COORDINATOR, parallel/distributed.py), the drills of JAX
tests/test_multihost.py on the CPU over gloo: `train` at 2 ranks of one host
trains data-parallel on halves of each host batch; only rank 0 writes
checkpoints and rank 1 logs under `<run>_proc1`; the weights equal a
one-process run at the doubled batch; a `resume` from rank 0's checkpoint
continues on both ranks; no rank imports jax or a module of the JAX package.
The predict CLI on 2 ranks runs in tests/test_torch_port_parallel.py (files
sharded across 2 hosts) and test_torch_port_spatial.py (a volume's patch grid
split across a host's ranks).
"""

import os

import numpy as np
import pytest
import torch
import yaml

from pytorch3dunet_tpu_torch import train
from pytorch3dunet_tpu_torch.utils.checkpoint import load_checkpoint
from tests.test_torch_port_spatial import _free_port, collect, spawn_ranks
from tests.test_torch_port_train import CLI_PATCH, _cli_config, _write_volume

# each rank: the train CLI, then (on a second coordinator port) the train CLI
# resuming from a copy of rank 0's checkpoint; each run joins and leaves its
# own process group
_RANK = r'''
import os, runpy, shutil, sys
out, train_config, resume_config, checkpoint, resume, port = sys.argv[1:7]

def cli(config):
    sys.argv = ["train", "--config", config]
    runpy.run_module("pytorch3dunet_tpu_torch.train", run_name="__main__")

cli(train_config)
print("train done", flush=True)
if os.environ["P3DUNET_PROCESS_ID"] == "0":
    os.makedirs(os.path.dirname(resume))
    shutil.copy(checkpoint, resume)
# the second run's rendezvous waits for rank 0, which copied the checkpoint first
os.environ["P3DUNET_COORDINATOR"] = "127.0.0.1:" + port
cli(resume_config)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "pytorch3dunet_tpu"))
assert not bad, f"the port imported {bad}"
print("rank done")
'''


def _train_config(tmp, name, batch_size, **trainer):
    config = _cli_config(tmp, **trainer)
    config["optimizer"] = {"name": "SGD", "learning_rate": 0.05}
    config["loaders"]["batch_size"] = batch_size
    config["trainer"]["checkpoint_dir"] = os.path.join(tmp, name)
    return config


def _write_config(tmp, name, config):
    path = os.path.join(tmp, f"{name}.yml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2-rank train and resume runs and the one-process twin of the first."""
    tmp = str(tmp_path_factory.mktemp("multihost"))
    _write_volume(os.path.join(tmp, "train.h5"), 0, shape=(32, *CLI_PATCH[1:]))
    _write_volume(os.path.join(tmp, "val.h5"), 1)
    two = _train_config(tmp, "two", 1)
    resume = os.path.join(tmp, "resumed", "last_checkpoint.pytorch")
    resumed = _train_config(tmp, "resumed_logs", 1, resume=resume, max_num_iterations=4)
    run_dir = os.path.join(tmp, "ranks")
    os.makedirs(run_dir)
    args = (_write_config(tmp, "two", two), _write_config(tmp, "resume", resumed),
            os.path.join(two["trainer"]["checkpoint_dir"], "last_checkpoint.pytorch"), resume, str(_free_port()))
    procs = spawn_ranks(_RANK, 2, run_dir, args=args)
    # the data-parallel run's twin: one process at the doubled batch
    one = _train_config(tmp, "one", 2)
    train.main(["--config", _write_config(tmp, "one", one)])
    logs = collect(procs, run_dir, results=False)
    return {"two": two, "one": one, "resume": resume, "logs": [log.split("train done") for log in logs]}


def test_only_rank_0_writes_checkpoints(runs):
    ckpt = runs["two"]["trainer"]["checkpoint_dir"]
    assert {"last_checkpoint.pytorch", "best_checkpoint.pytorch"} <= set(os.listdir(ckpt))
    (rank0, _), (rank1, _) = runs["logs"]
    assert "Saving checkpoint" in rank0 and "Saving checkpoint" not in rank1
    assert "Data-parallel mesh: 2 ranks" in rank0 and "Data-parallel mesh: 2 ranks" in rank1
    run_dirs = os.listdir(os.path.join(ckpt, "logs"))
    assert len(run_dirs) == 2 and sum(d.endswith("_proc1") for d in run_dirs) == 1


def test_two_ranks_train_as_one_process_on_the_doubled_batch(runs):
    """The host batch of 2 split over the ranks, the loss on the gathered
    batch and the summed gradients: the one-process run at batch 2."""
    two = load_checkpoint(os.path.join(runs["two"]["trainer"]["checkpoint_dir"], "last_checkpoint.pytorch"))
    one = load_checkpoint(os.path.join(runs["one"]["trainer"]["checkpoint_dir"], "last_checkpoint.pytorch"))
    assert two["num_iterations"] == one["num_iterations"] == 3
    for name, value in one["model_state_dict"].items():
        np.testing.assert_allclose(two["model_state_dict"][name].numpy(), value.numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)


def test_resume_continues_on_both_ranks(runs):
    (_, resumed0), (_, resumed1) = runs["logs"]
    for log in (resumed0, resumed1):
        assert "rank done" in log
        assert "Iteration: 3" in log and "Random streams restored from the checkpoint" in log
    assert "Saving checkpoint" in resumed0 and "Saving checkpoint" not in resumed1
    state = load_checkpoint(runs["resume"])
    assert state["num_iterations"] == 5 and state["optimizer_state_dict"]["param_groups"][0]["lr"] == 0.05


def test_no_coordinator_means_one_process():
    from pytorch3dunet_tpu_torch.parallel import distributed

    assert "P3DUNET_COORDINATOR" not in os.environ
    assert not distributed.initialize_from_env("cpu") and distributed.world_size() == 1
    assert (distributed.process_index(), distributed.process_count(), distributed.host_ranks()) == (0, 1, (0,))
    assert distributed.device_for_rank(torch.device("cpu")) == torch.device("cpu")
