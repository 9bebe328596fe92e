"""The port's data parallelism and multi-host loaders
(pytorch3dunet_tpu_torch/parallel/mesh.py, distributed.py, the trainer's
data-parallel step, datasets/utils.py) and the grid-sharded device sweep,
against the JAX package, on the CPU over gloo.

Two ranks are spawned once for the whole file, each posing as its own host
(`_hostname` patched), and run every scenario of `_WORKER`; this process
computes the references meanwhile. The JAX side runs on one device and on a
2-device mesh of conftest.py's 8 virtual CPU devices. Gradients: each tensor
within 1e-4 of its own max|g|, the loss within 1e-5; sweeps within 2e-5.
"""

import os

import h5py
import jax
import numpy as np
import pytest
import torch
import yaml

from pytorch3dunet_tpu import inference_device as jax_inference_device
from pytorch3dunet_tpu.datasets.utils import _scaled_batch_size as jax_scaled_batch_size
from pytorch3dunet_tpu.losses import get_loss_criterion as jax_get_loss_criterion
from pytorch3dunet_tpu.parallel import choose_data_mesh as jax_choose_data_mesh
from pytorch3dunet_tpu.parallel import data_mesh as jax_data_mesh
from pytorch3dunet_tpu.parallel import replicate as jax_replicate
from pytorch3dunet_tpu.parallel import shard_batch as jax_shard_batch
from pytorch3dunet_tpu.parallel.distributed import shard_file_paths as jax_shard_file_paths
from pytorch3dunet_tpu_torch.datasets.utils import _scaled_batch_size
from pytorch3dunet_tpu_torch.inference_device import DeviceSlidingWindow
from pytorch3dunet_tpu_torch.losses import get_loss_criterion
from pytorch3dunet_tpu_torch.models.unet import get_model
from pytorch3dunet_tpu_torch.ops.conv3d import plain_conv
from pytorch3dunet_tpu_torch.parallel import choose_data_mesh, shard_batch, shard_file_paths
from pytorch3dunet_tpu_torch.parallel.mesh import Mesh
from pytorch3dunet_tpu_torch.predict import run as predict_run
from pytorch3dunet_tpu_torch.utils.checkpoint import save_checkpoint
from pytorch3dunet_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_torch_port_2d import _batch as _batch_2d
from tests.test_torch_port_2d import _jax
from tests.test_torch_port_spatial import collect, spawn_ranks

WORLD = 2
LR = 0.05
LOSS = {"name": "BCEDiceLoss"}
CFG_3D = {"name": "UNet3D", "in_channels": 1, "out_channels": 1, "f_maps": 8, "num_groups": 4, "num_levels": 2,
          "layer_order": "gcr", "final_sigmoid": True}
SHAPE_3D = (16, 32, 32)
CFG_2D = {"name": "UNet2D", "in_channels": 1, "out_channels": 1, "f_maps": 8, "num_groups": 4, "num_levels": 3,
          "layer_order": "bcr", "final_sigmoid": True}
# the loaders scenario: train volumes of 2, 4 and 1 patches of 8 x 64 x 64
TRAIN_DEPTHS = {"a.h5": 16, "b.h5": 32, "c.h5": 8}
SWEEP = dict(patch=(8, 16, 16), halo=(2, 4, 4))
# the first GroupNorm's weight gradient cancels to f32 roundoff (ROADMAP
# "Small gradients"): the JAX step's sits 2e-4 of its max|g| from float64,
# the port's 7e-5; against JAX it is held to 1e-3, against float64 to 1e-4
FIRST_GN = "encoders.0.basic_module.SingleConv1.groupnorm.weight"
# the predict CLI's volumes, sharded over the 2 hosts: p0 and p2 to host 0
PREDICT_DEPTHS = {"p0": 16, "p1": 24, "p2": 8}
SWEEP_STARTS = np.array([(0, 0, 0), (0, 0, 16), (0, 16, 8), (4, 16, 20), (4, 24, 0)], np.int32)

# Runs in each rank (a fresh interpreter: no JAX). argv: the directory of inputs.pt and of the results.
_WORKER = r'''
import os, sys
import numpy as np
import torch

torch.set_num_threads(1)
from pytorch3dunet_tpu_torch.datasets.utils import get_train_loaders
from pytorch3dunet_tpu_torch.inference_device import DeviceSlidingWindow
from pytorch3dunet_tpu_torch.losses import get_loss_criterion
from pytorch3dunet_tpu_torch.models.unet import get_model
from pytorch3dunet_tpu_torch.ops.conv3d import plain_conv
from pytorch3dunet_tpu_torch.parallel import distributed
from pytorch3dunet_tpu_torch.parallel.mesh import data_mesh
from pytorch3dunet_tpu_torch.trainer import create_trainer
from pytorch3dunet_tpu_torch.utils.misc import RunningAverage

out = sys.argv[1]
# each rank poses as a host of its own
distributed._hostname = lambda: "host" + os.environ["P3DUNET_PROCESS_ID"]
distributed.initialize_from_env("cpu")
rank = distributed.rank()
inp = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
res = {"hosts": (distributed.process_index(), distributed.process_count(), distributed.host_ranks())}

def data_parallel_update(name, config, state, x, y):
    """One update of the trainer on this rank's sample of the global batch."""
    trainer = create_trainer(config, loaders={"train": [], "val": []})
    trainer.model.load_state_dict(state)
    losses = RunningAverage()
    trainer._update(((x[rank:rank + 1], y[rank:rank + 1]),), losses)
    res[name] = {"loss": losses.avg, "mesh": trainer.mesh.size,
                 "grads": {n: p.grad.numpy().copy() for n, p in trainer.model.named_parameters()},
                 "state": {k: v.detach().numpy().copy() for k, v in trainer.model.state_dict().items()}}

data_parallel_update("unet3d", inp["config_3d"], inp["state_3d"], inp["x_3d"], inp["y_3d"])
data_parallel_update("unet2d_bcr", inp["config_2d"], inp["state_2d"], inp["x_2d"], inp["y_2d"])

loaders = get_train_loaders(inp["loaders_config"], seed=0)
train = loaders["train"]
res["loaders"] = {"files": sorted(os.path.basename(d.file_path) for d in train.dataset.datasets),
                  "len": len(train), "drop_last": train.drop_last, "n_batches": sum(1 for _ in train)}

model = get_model(dict(inp["config_3d"]["model"])).eval()
model.load_state_dict(inp["state_3d"])
for blend in ("gaussian", "assign"):
    sweep = DeviceSlidingWindow(model, inp["sweep"]["patch"], inp["sweep"]["halo"], normalize="standardize",
                                stats=inp["stats"], blend=blend, mesh=data_mesh())
    res["sweep_" + blend] = {"sharded": sweep.mesh is not None,
                             "out": sweep(inp["sweep_volume"], inp["sweep_starts"])}

# the predict CLI: each host predicts its share of the files (the runtime is up: main joins it)
from pytorch3dunet_tpu_torch import predict
predict.main(["--config", inp["predict_config"]])
res["imported"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "pytorch3dunet_tpu"))

torch.save(res, os.path.join(out, f"rank{rank}.pt"))
distributed.shutdown()
'''


def _config(tmp, model):
    return {"device": "cpu", "manual_seed": 0, "model": dict(model), "loss": dict(LOSS),
            "eval_metric": {"name": "DiceCoefficient"}, "optimizer": {"name": "SGD", "learning_rate": LR},
            "trainer": {"checkpoint_dir": str(tmp / "ckpt"), "eval_score_higher_is_better": True,
                        "validate_after_iters": 10**6, "log_after_iters": 10**6, "max_num_epochs": 1,
                        "max_num_iterations": 10}}


def _write_h5(path, depth, seed):
    rs = np.random.RandomState(seed)
    with h5py.File(path, "w") as f:
        f.create_dataset("raw", data=rs.rand(depth, 64, 64).astype(np.float32))
        f.create_dataset("label", data=(rs.rand(depth, 64, 64) > 0.5).astype(np.float32))


def _loaders_config(tmp):
    phase = {"slice_builder": {"name": "SliceBuilder", "patch_shape": [8, 64, 64], "stride_shape": [8, 64, 64]},
             "transformer": {"raw": [{"name": "ToTensor", "expand_dims": True}],
                             "label": [{"name": "ToTensor", "expand_dims": True}]}}
    for seed, (name, depth) in enumerate({**TRAIN_DEPTHS, "val.h5": 8}.items()):
        _write_h5(str(tmp / name), depth, seed)
    # listed unsorted: every host sorts before sharding
    train_files = [str(tmp / name) for name in reversed(list(TRAIN_DEPTHS))]
    return {"device": "cpu", "trainer": {},
            "loaders": {"dataset": "StandardHDF5Dataset", "num_workers": 1, "batch_size": 1,
                        "raw_internal_path": "raw", "label_internal_path": "label",
                        "train": {"file_paths": train_files, **phase},
                        "val": {"file_paths": [str(tmp / "val.h5")], **phase}}}


def predict_config(tmp, name, model_path, predictor, depths):
    """A predict config over small H5 volumes of the given depths (written once)."""
    files = []
    for seed, (stem, depth) in enumerate(depths.items()):
        path = str(tmp / f"{stem}.h5")
        if not os.path.exists(path):
            with h5py.File(path, "w") as f:
                f.create_dataset("raw", data=np.random.RandomState(seed).rand(depth, 40, 36).astype(np.float32))
        files.append(path)
    out = tmp / name
    out.mkdir(exist_ok=True)
    transformer = {"raw": [{"name": "Standardize"}, {"name": "ToTensor", "expand_dims": True}]}
    return {"device": "cpu", "model_path": model_path, "model": dict(CFG_3D), "predictor": predictor,
            "loaders": {"dataset": "StandardHDF5Dataset", "output_dir": str(out), "batch_size": 1, "num_workers": 1,
                        "raw_internal_path": "raw",
                        "test": {"file_paths": files, "transformer": transformer,
                                 "slice_builder": {"name": "SliceBuilder", "patch_shape": [8, 16, 16],
                                                   "stride_shape": [6, 12, 12], "skip_shape_check": True,
                                                   "halo_shape": [2, 4, 4]}}}}


def predictions(config, stems):
    out = {}
    for stem in stems:
        with h5py.File(os.path.join(config["loaders"]["output_dir"], f"{stem}_predictions.h5"), "r") as f:
            out[stem] = f["predictions"][:]
    return out


def predict_twin(config):
    """The one-process run of a predict config, into its own directory."""
    twin = dict(config, loaders=dict(config["loaders"], output_dir=config["loaders"]["output_dir"] + "_one"))
    os.makedirs(twin["loaders"]["output_dir"])
    predict_run(twin)
    return twin


def _jax_grads(jax_model, variables, x, y, mesh=None):
    """(loss, port-named grads, updated batch_stats) of the JAX step on the
    global batch; over `mesh` the batch is sharded and the parameters replicated."""
    criterion = jax_get_loss_criterion({"loss": dict(LOSS)})
    mutable = [k for k in variables if k != "params"]

    def loss_fn(params, x, y):
        if mutable:
            (_, logits), updated = jax_model.module.apply({**variables, "params": params}, x, train=True,
                                                          mutable=mutable)
        else:
            _, logits = jax_model.module.apply({"params": params}, x, train=True)
            updated = {}
        return criterion(logits, y), updated

    x, y = np.moveaxis(x, 1, -1), np.moveaxis(y, 1, -1)
    params = variables["params"]
    if mesh is not None:
        params, (x, y) = jax_replicate(mesh, params), jax_shard_batch(mesh, (x, y))
    (loss, updated), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, x, y)
    return float(loss), state_dict_from_jax({"params": jax.device_get(grads)}), jax.device_get(updated)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_ranks")
    jax_3d, vars_3d = _jax(CFG_3D, seed=3)
    rs = np.random.RandomState(3)
    x_3d = rs.rand(2, 1, *SHAPE_3D).astype(np.float32)
    y_3d = (rs.rand(2, 1, *SHAPE_3D) > 0.5).astype(np.float32)
    jax_2d, vars_2d = _jax(CFG_2D, seed=4)
    raw_2d, target_2d = _batch_2d(4)
    # the trainer's 2D batches: (N, C, 1, H, W)
    x_2d, y_2d = raw_2d[:, :, None], target_2d[:, :1, None]
    volume = np.random.RandomState(6).rand(12, 40, 36).astype(np.float32) * 3 + 1
    stats = {"mean": float(volume.mean()), "std": float(volume.std())}
    padded = np.pad(volume, [(h, h) for h in SWEEP["halo"]], mode="reflect")
    save_checkpoint({"model_state_dict": state_dict_from_jax(vars_3d)}, False, checkpoint_dir=str(tmp))
    files = predict_config(tmp, "files", str(tmp / "last_checkpoint.pytorch"), {"name": "StandardPredictor"},
                           PREDICT_DEPTHS)
    with open(tmp / "files.yml", "w") as f:
        yaml.safe_dump(files, f)
    torch.save({"predict_config": str(tmp / "files.yml"), "config_3d": _config(tmp, CFG_3D), "state_3d": state_dict_from_jax(vars_3d), "x_3d": x_3d,
                "y_3d": y_3d, "config_2d": _config(tmp, CFG_2D), "state_2d": state_dict_from_jax(vars_2d),
                "x_2d": x_2d, "y_2d": y_2d, "loaders_config": _loaders_config(tmp), "sweep": SWEEP,
                "stats": stats, "sweep_volume": padded, "sweep_starts": SWEEP_STARTS}, tmp / "inputs.pt")
    procs = spawn_ranks(_WORKER, WORLD, tmp)

    mesh = jax_choose_data_mesh(2, devices=jax.devices()[:2])
    assert mesh.devices.size == 2
    refs = {"unet3d": _jax_grads(jax_3d, vars_3d, x_3d, y_3d), "unet3d_float64": _float64_grads(vars_3d, x_3d, y_3d),
            "unet3d_mesh": _jax_grads(jax_3d, vars_3d, x_3d, y_3d, mesh),
            "unet2d_bcr": _jax_grads(jax_2d, vars_2d, raw_2d, target_2d[:, :1]),
            "vars_2d": vars_2d}
    # the values each BatchNorm reduces per channel over the global batch
    model_2d = get_model(dict(CFG_2D)).train()
    counts = {}
    for key, bn in ((k, m) for k, m in model_2d.named_modules() if isinstance(m, torch.nn.BatchNorm2d)):
        bn.register_forward_pre_hook(lambda m, args, key=key: counts.__setitem__(key, args[0].numel()
                                                                                 // args[0].shape[1]))
    with torch.no_grad():
        model_2d(torch.from_numpy(raw_2d))
    refs["bn_counts"] = counts
    model = get_model(dict(CFG_3D)).eval()
    model.load_state_dict(state_dict_from_jax(vars_3d))
    one = DeviceSlidingWindow(model, SWEEP["patch"], SWEEP["halo"], normalize="standardize", stats=stats,
                              blend="gaussian")
    refs["sweep_gaussian"] = one(padded, SWEEP_STARTS)
    for blend in ("gaussian", "assign"):
        want = jax_inference_device.DeviceSlidingWindow(jax_3d, SWEEP["patch"], SWEEP["halo"], normalize="standardize",
                                                        stats=stats, blend=blend, mesh=jax_data_mesh(jax.devices()[:2]))
        refs["jax_sweep_" + blend] = np.moveaxis(want(vars_3d, padded[..., None], SWEEP_STARTS), -1, 0)
    refs["files_one"] = predictions(predict_twin(files), PREDICT_DEPTHS)
    results = collect(procs, tmp)
    refs["files"] = predictions(files, PREDICT_DEPTHS)
    for rank, res in enumerate(results):
        with open(tmp / f"rank{rank}.log") as f:
            res["log"] = f.read()
    return results, refs


def _float64_grads(variables, x, y):
    """(loss, grads) of the port's one-process step on the global batch in float64."""
    model = get_model(dict(CFG_3D)).train().double()
    model.load_state_dict(state_dict_from_jax(variables))
    with plain_conv():
        loss = get_loss_criterion({"loss": dict(LOSS)})(model(torch.from_numpy(x).double())[1],
                                                        torch.from_numpy(y).double())
        loss.backward()
    return float(loss), {n: p.grad for n, p in model.named_parameters()}


def _assert_grads(got, want, loose=()):
    assert set(got) == set(want)
    for name, expected in want.items():
        expected = expected.numpy()
        tol = 1e-3 if name in loose else 1e-4
        np.testing.assert_allclose(got[name], expected, rtol=0, atol=tol * np.abs(expected).max(), err_msg=name)


@pytest.mark.parametrize("ref", ["unet3d", "unet3d_mesh", "unet3d_float64"])
def test_data_parallel_step_matches_the_jax_global_batch(ranks, ref):
    """2 ranks x 1 sample: the loss on the gathered global batch and the
    gradients summed over the ranks equal the JAX step on the batch of 2, on
    one device and on a 2-device `choose_data_mesh`, and the port's own
    float64 step on that batch."""
    results, refs = ranks
    loss, grads = refs[ref][:2]
    for res in results:
        got = res["unet3d"]
        assert got["mesh"] == WORLD
        np.testing.assert_allclose(got["loss"], loss, rtol=0, atol=1e-5)
        _assert_grads(got["grads"], grads, loose=() if ref == "unet3d_float64" else (FIRST_GN,))
    for name, value in results[0]["unet3d"]["state"].items():
        np.testing.assert_array_equal(results[1]["unet3d"]["state"][name], value, err_msg=name)


def test_data_parallel_batchnorm_syncs_the_batch_moments(ranks):
    """UNet2D with BatchNorm at 2 ranks: the gradients of the global-batch BN
    step, and running statistics moved by the global batch's moments (the
    variance's update n / (n - 1) times flax's, ROADMAP F2), alike on both ranks."""
    results, refs = ranks
    loss, grads, updated = refs["unet2d_bcr"]
    before = state_dict_from_jax(refs["vars_2d"])
    after = state_dict_from_jax({**refs["vars_2d"], "batch_stats": updated["batch_stats"]})
    for res in results:
        got = res["unet2d_bcr"]
        np.testing.assert_allclose(got["loss"], loss, rtol=0, atol=1e-5)
        _assert_grads(got["grads"], grads)
        for key, n in refs["bn_counts"].items():
            state = got["state"]
            np.testing.assert_allclose(state[f"{key}.running_mean"], after[f"{key}.running_mean"].numpy(), rtol=0,
                                       atol=1e-5)
            old = 0.9 * before[f"{key}.running_var"].numpy()
            np.testing.assert_allclose(state[f"{key}.running_var"] - old,
                                       (after[f"{key}.running_var"].numpy() - old) * n / (n - 1), rtol=1e-4,
                                       atol=1e-6)
            assert state[f"{key}.num_batches_tracked"] == 1


def test_train_files_shard_across_hosts_and_epochs_cap(ranks):
    """Each host trains on its round-robin share of the sorted files (JAX
    `shard_file_paths`), drops a ragged batch, and caps its epoch at the global
    minimum: 3 patches on host 0 (a, c), 4 on host 1 (b) -> 3 batches each."""
    results, _ = ranks
    files = sorted(TRAIN_DEPTHS)
    for rank, res in enumerate(results):
        assert res["hosts"] == (rank, WORLD, (rank,))
        assert res["loaders"]["files"] == jax_shard_file_paths(files, process_id=rank, num_processes=WORLD)
        assert res["loaders"]["drop_last"]
        assert res["loaders"]["len"] == res["loaders"]["n_batches"] == 3


@pytest.mark.parametrize("blend", ["gaussian", "assign"])
def test_sharded_sweep_matches_one_rank_and_jax(ranks, blend):
    """The grid split over 2 ranks (3 + 2 patches), summed by one all-reduce,
    against the JAX sweep over a 2-device mesh and, for gaussian, the one-rank
    sweep (a sharded assign sweep averages overlaps, as the JAX mesh sweep
    does, where one rank's write-wins)."""
    results, refs = ranks
    for res in results:
        got = res["sweep_" + blend]
        assert got["sharded"]
        np.testing.assert_allclose(got["out"], refs["jax_sweep_" + blend], rtol=0, atol=2e-5)
        if blend == "gaussian":
            np.testing.assert_allclose(got["out"], refs["sweep_gaussian"], rtol=0, atol=2e-5)


@pytest.mark.parametrize("files,process_id,num_processes,allow_empty", [
    ([f"f{i}.h5" for i in range(5)], 0, 2, False), ([f"f{i}.h5" for i in range(5)], 1, 2, False),
    ([f"f{i}.h5" for i in range(5)], 0, 1, False), (["a.h5"], 3, 4, False),
    (["a.h5", "b.h5", "c.h5"], 3, 4, False), (["a.h5", "b.h5", "c.h5"], 3, 4, True),
])
def test_shard_file_paths_matches_jax(files, process_id, num_processes, allow_empty):
    assert shard_file_paths(files, process_id, num_processes, allow_empty) == \
        jax_shard_file_paths(files, process_id, num_processes, allow_empty)


def test_choose_data_mesh_and_shard_batch():
    # JAX takes the largest device count dividing the batch; a rank cannot sit out
    assert choose_data_mesh(1, world=1).size == 1
    with pytest.raises(ValueError, match="launch 1 rank"):
        choose_data_mesh(3, world=2)
    mesh = Mesh((0, 1))
    x = np.arange(8).reshape(4, 2)
    np.testing.assert_array_equal(shard_batch(mesh, x), x[:2])
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(mesh, x[:3])
    np.testing.assert_array_equal(shard_batch(mesh, x[:3], ragged_replicated_ok=True), x[:3])


def test_scaled_batch_size_on_one_rank():
    # one rank per host: the per-rank batch, as JAX on one device
    loaders = {"batch_size": 3}
    assert _scaled_batch_size(loaders, {"device": "cpu"}) == 3 == jax_scaled_batch_size(loaders, {"device": "cpu"})


def test_train_batches_split_across_a_host_s_ranks(tmp_path):
    """Two ranks of one host draw one batch order and take their halves of
    each host batch: together the batches of one loader of twice the size."""
    from pytorch3dunet_tpu_torch.datasets.loader import DataLoader

    data = list(range(12))
    whole = [list(b) for b in DataLoader(data, batch_size=4, shuffle=True, seed=5, drop_last=True,
                                         collate_fn=list)]
    parts = [[list(b) for b in DataLoader(data, batch_size=4, shuffle=True, seed=5, drop_last=True,
                                          collate_fn=list, shard=(i, 2))] for i in range(2)]
    assert [a + b for a, b in zip(*parts)] == whole
    with pytest.raises(ValueError, match="equal parts"):
        DataLoader(data, batch_size=3, shard=(0, 2))


def test_predict_cli_shards_files_across_hosts(ranks):
    """`predict.main` on 2 hosts: each predicts its round-robin share of the
    sorted files (JAX datasets/utils.py:365-386), the outputs those of one
    process, and no rank imported jax or the JAX package."""
    results, refs = ranks
    assert "Multi-host: process 0 predicts 2/3 files" in results[0]["log"]
    assert "Multi-host: process 1 predicts 1/3 files" in results[1]["log"] and "p1.h5" in results[1]["log"]
    for res in results:
        assert res["imported"] == []
    for stem in PREDICT_DEPTHS:
        # one thread a rank: another summation order in the CPU conv
        np.testing.assert_allclose(refs["files"][stem], refs["files_one"][stem], rtol=0, atol=2e-5)
