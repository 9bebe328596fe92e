"""The port's spatial (D-axis) sharding (pytorch3dunet_tpu_torch/parallel/spatial.py
and its hooks in the conv, GroupNorm, SE and deconv decoder) against the
unsharded step and the JAX package's sharded steps, on the CPU over gloo.

Four ranks are spawned once for the whole file (`ranks`): each runs every
scenario of `_WORKER` and saves its results, the n = 2 scenarios on the rank
pairs (0, 1) and (2, 3) at once. Meanwhile this process computes the
references: the JAX steps on its 8 virtual CPU devices (conftest.py) and the
port's unsharded steps. Weights start as the JAX package's (randomized
affines) and cross with `state_dict_from_jax`. Tolerances are those of JAX
tests/test_spatial.py and test_spatial_inference.py: loss 1e-5, probabilities
and parameters 1e-4, sweeps 2e-5.
"""

import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from pytorch3dunet_tpu.losses import BCEDiceLoss as JaxBCEDiceLoss
from pytorch3dunet_tpu.models import get_model as jax_get_model
from pytorch3dunet_tpu.parallel import spatial as jax_spatial
from pytorch3dunet_tpu_torch.inference_device import DeviceSlidingWindow
from pytorch3dunet_tpu_torch.losses import get_loss_criterion
from pytorch3dunet_tpu_torch.models.unet import get_model
from pytorch3dunet_tpu_torch.parallel import spatial
from pytorch3dunet_tpu_torch.parallel.mesh import Mesh
from pytorch3dunet_tpu_torch.predictor import DeviceSlidingWindowPredictor
from pytorch3dunet_tpu_torch.utils.checkpoint import save_checkpoint
from pytorch3dunet_tpu_torch.utils.weights import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
CFG = {"name": "UNet3D", "in_channels": 1, "out_channels": 1, "f_maps": 8, "num_groups": 4, "num_levels": 2,
       "layer_order": "gcr", "final_sigmoid": True}
PATCH = (64, 16, 16)
RES_PATCH = (32, 12, 12)
BCE_DICE = {"name": "BCEDiceLoss"}
LR = 1e-2
# the cooperative sweep: patch (24, 16, 16) + halo (4, 2, 2) pads to depth 32
SWEEP_CFG = {"name": "UNet3D", "in_channels": 1, "out_channels": 2, "layer_order": "gcr", "f_maps": 8,
             "num_groups": 4, "num_levels": 2, "final_sigmoid": False}
SWEEP_PATCH, SWEEP_HALO = (24, 16, 16), (4, 2, 2)
SWEEPS = {"none": dict(normalize=None), "standardize_patch": dict(normalize="standardize_patch"),
          "normalize": dict(normalize="normalize"), "gaussian_tta": dict(blend="gaussian", tta_axes=(1, 2))}
# the predictor's cooperative slab (JAX test_spatial_inference.py:72-115)
SLAB_VOLUME, SLAB_PATCH, SLAB_HALO = (80, 24, 24), (8, 24, 24), (4, 8, 8)
# the predict CLI's volumes
PREDICT_DEPTHS = {"g0": 16, "g1": 24}
SLAB_KWARGS = {"patch_mode": "slab", "blend": "gaussian", "max_patch_voxels": (24 + 16) * (24 + 16) * 80}

# Runs in each rank (a fresh interpreter: no JAX). argv: the directory of inputs.pt and of the results.
_WORKER = r'''
import os, sys
import numpy as np
import torch

torch.set_num_threads(1)
from pytorch3dunet_tpu_torch.losses import get_loss_criterion
from pytorch3dunet_tpu_torch.models.unet import get_model
from pytorch3dunet_tpu_torch.inference_device import DeviceSlidingWindow
from pytorch3dunet_tpu_torch.parallel import distributed, spatial
from pytorch3dunet_tpu_torch.parallel.mesh import gather
from pytorch3dunet_tpu_torch.predictor import DeviceSlidingWindowPredictor
from pytorch3dunet_tpu_torch.trainer import create_trainer
from pytorch3dunet_tpu_torch.utils.misc import RunningAverage

out = sys.argv[1]
distributed.initialize_from_env("cpu")
rank = distributed.rank()
inp = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
everyone = spatial.space_mesh()
pairs = [spatial.space_mesh(ranks=(0, 1)), spatial.space_mesh(ranks=(2, 3))]
pair = pairs[rank // 2]
res = {}

def params(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}

def model_of(cfg, state):
    model = get_model(dict(cfg)).train()
    model.load_state_dict(state)
    return model

def step(mesh, cfg, state, x, y):
    model = model_of(cfg, state)
    spatial.replicate_spatial(mesh, model)
    opt = torch.optim.SGD(model.parameters(), lr=inp["lr"])
    train_step = spatial.build_spatial_train_step(model, get_loss_criterion({"loss": {"name": "BCEDiceLoss"}}),
                                                  opt, mesh)
    xi, yi = spatial.shard_spatial_batch(mesh, (torch.from_numpy(x), torch.from_numpy(y)))
    loss, probs = train_step(xi, yi)
    return {"loss": float(loss), "probs": gather(probs, mesh, 2).numpy(), "params": params(model)}

# the eval step first, on the starting weights
model = model_of(inp["cfg"], inp["state"]).eval()
probs, loss = spatial.build_spatial_eval_step(model, get_loss_criterion({"loss": {"name": "BCEDiceLoss"}}), everyone)(
    *spatial.shard_spatial_batch(everyone, (torch.from_numpy(inp["x"]), torch.from_numpy(inp["y"]))))
res["eval_n4"] = {"loss": float(loss), "probs": gather(probs, everyone, 2).numpy()}
res["unet_n4"] = step(everyone, inp["cfg"], inp["state"], inp["x"], inp["y"])
res["unet_n2"] = step(pair, inp["cfg"], inp["state"], inp["x"], inp["y"])
res["resunet_n2"] = step(pair, inp["res_cfg"], inp["res_state"], inp["res_x"], inp["res_y"])
os.environ["P3DUNET_TAPFOLD"] = "1"
res["se_n2"] = step(pair, inp["se_cfg"], inp["se_state"], inp["res_x"], inp["res_y"])
os.environ.pop("P3DUNET_TAPFOLD")

# accumulation of two microbatches over the pair
model = model_of(inp["cfg"], inp["state"])
opt = torch.optim.SGD(model.parameters(), lr=inp["lr"])
grads_step, apply_step, zeros = spatial.build_spatial_accum_fns(
    model, get_loss_criterion({"loss": {"name": "BCEWithLogitsLoss"}}), opt, pair, 2)
zeros()
for i in range(2):
    grads_step(*spatial.shard_spatial_batch(pair, (torch.from_numpy(inp["x2"][i:i + 1]),
                                                   torch.from_numpy(inp["y2"][i:i + 1]))))
apply_step()
res["accum_n2"] = {"params": params(model)}

# data x space on the 2 x 2 grid
grid = spatial.dp_sp_mesh(2, 2)
model = model_of(inp["cfg"], inp["state"])
opt = torch.optim.SGD(model.parameters(), lr=inp["lr"])
dp_sp_step = spatial.build_dp_sp_train_step(model, get_loss_criterion({"loss": {"name": "BCEDiceLoss"}}), opt, grid)
loss, _ = dp_sp_step(*spatial.shard_dp_sp_batch(grid, (torch.from_numpy(inp["x2"]), torch.from_numpy(inp["y2"]))))
res["dp_sp"] = {"loss": float(loss), "params": params(model)}

# the halo exchange, forward and backward
for name, mesh, pad in (("halo_n4_p1", everyone, 1), ("halo_n2_p1", pair, 1), ("halo_n2_p2", pair, 2)):
    x, r = torch.from_numpy(inp["halo_x"]), torch.from_numpy(inp["halo_r"][name])
    d = x.shape[2] // mesh.size
    slab = x[:, :, mesh.index * d:(mesh.index + 1) * d].clone().requires_grad_()
    y = spatial.halo_exchange_d(slab, mesh, pad)
    (y * r[mesh.index]).sum().backward()
    res[name] = {"y": y.detach().numpy(), "dx": slab.grad.numpy()}

# the cooperative sweep over every rank
sweep_model = get_model(dict(inp["sweep_cfg"])).eval()
sweep_model.load_state_dict(inp["sweep_state"])
for name, kwargs in inp["sweeps"].items():
    coop = DeviceSlidingWindow(sweep_model, inp["sweep_patch"], inp["sweep_halo"], spatial_mesh=everyone, **kwargs)
    res["sweep_" + name] = coop(inp["sweep_volume"], inp["sweep_starts"])

# the predictor's slab plan, every slab z-sharded over the host's 4 ranks
predictor = DeviceSlidingWindowPredictor(sweep_model, None, 2, "cpu", **inp["slab_kwargs"])
res["slab"] = predictor.predict_array(inp["slab_volume"], inp["slab_patch"], inp["slab_patch"], inp["slab_halo"],
                                      normalize="standardize", stats=inp["slab_stats"])
res["slab_spatial_n"] = sorted(key[-1] for key in predictor._sweeps)

# the trainer with spatial_sharding (space mesh over every rank), remat and an EMA
trainer = create_trainer(inp["trainer_config"], loaders={"train": [], "val": [(inp["x"], inp["y"])]})
trainer.model.load_state_dict(inp["state"])
p0 = [p.detach().clone() for p in trainer.model.parameters()]
trainer.ema = [p.clone() for p in p0]
trainer._update(((inp["x"], inp["y"]),), RunningAverage())
trainer._ema_step()
res["trainer"] = {"params": params(trainer.model), "mesh": trainer.mesh.size, "val": trainer.validate(),
                  "ema": [e.numpy() for e in trainer.ema], "p0": [p.numpy() for p in p0]}
# fit with a log, a validation and a checkpoint at every iteration
config = dict(inp["trainer_config"], trainer=dict(inp["trainer_config"]["trainer"], max_num_iterations=1,
                                                  log_after_iters=1, validate_after_iters=1))
fit = create_trainer(config, loaders={"train": [(inp["x"], inp["y"])] * 2, "val": [(inp["x"], inp["y"])]})
fit.fit()
res["fit"] = {"iterations": fit.num_iterations, "best": fit.best_eval_score,
              "checkpoint": os.path.exists(os.path.join(config["trainer"]["checkpoint_dir"], "last_checkpoint.pytorch"))}

# the predict CLI: each volume's patch grid split over the host's 4 ranks, rank 0 writing
from pytorch3dunet_tpu_torch import predict
predict.main(["--config", inp["predict_config"]])
res["imported"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "pytorch3dunet_tpu"))

torch.save(res, os.path.join(out, f"rank{rank}.pt"))
distributed.shutdown()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(code, world, out_dir, env=None, args=()):
    """Starts `world` ranks of `code` (argv: `out_dir`, then `args`) joined
    through P3DUNET_COORDINATOR on 127.0.0.1, each logging to
    `out_dir/rank<r>.log`; returns the processes (see `collect`)."""
    port = _free_port()
    procs = []
    for rank in range(world):
        rank_env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1", "P3DUNET_COORDINATOR":
                    f"127.0.0.1:{port}", "P3DUNET_NUM_PROCESSES": str(world), "P3DUNET_PROCESS_ID": str(rank),
                    **(env or {})}
        log = open(os.path.join(out_dir, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen([sys.executable, "-c", code, str(out_dir), *args], env=rank_env, stdout=log,
                                       stderr=subprocess.STDOUT, cwd=REPO), log))
    return procs


def collect(procs, out_dir, timeout=240, results=True):
    """Waits for the ranks (killing them at the timeout) and loads each one's
    results (`rank<r>.pt`); with `results=False` returns each one's log."""
    deadline = time.monotonic() + timeout
    try:
        for proc, _ in procs:
            proc.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    for rank, (proc, _) in enumerate(procs):
        if proc.returncode != 0:
            with open(os.path.join(out_dir, f"rank{rank}.log")) as f:
                raise AssertionError(f"rank {rank} exited {proc.returncode}:\n{f.read()[-6000:]}")
    if not results:
        logs = []
        for r in range(len(procs)):
            with open(os.path.join(out_dir, f"rank{r}.log")) as f:
                logs.append(f.read())
        return logs
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(len(procs))]


def _jax_variables(cfg, patch, seed):
    """JAX init with randomized GroupNorm affines, as numpy."""
    model = jax_get_model(dict(cfg))
    variables = jax.jit(lambda key: model.init(key, patch_shape=patch))(jax.random.PRNGKey(seed))
    rs = np.random.RandomState(seed)
    variables = jax.tree_util.tree_map_with_path(
        lambda path, v: (rs.rand(*v.shape).astype(np.float32) + 0.5) if path[-1].key == "scale"
        else (rs.rand(*v.shape).astype(np.float32) * 0.4 - 0.2) if path[-1].key == "bias" else np.asarray(v),
        variables)
    return model, variables


def _batch(rs, n, patch):
    return rs.rand(n, 1, *patch).astype(np.float32), (rs.rand(n, 1, *patch) > 0.5).astype(np.float32)


def _port_step(cfg, state, x, y, loss=BCE_DICE):
    """The port's unsharded SGD step: (loss, probs, params)."""
    model = get_model(dict(cfg)).train()
    model.load_state_dict(state)
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    probs, logits = model(torch.from_numpy(x))
    value = get_loss_criterion({"loss": dict(loss)})(logits, torch.from_numpy(y))
    value.backward()
    opt.step()
    return float(value), probs.detach().numpy(), {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _port_eval(state, x, y):
    """The port's unsharded eval forward and loss: (loss, probs)."""
    model = get_model(dict(CFG)).eval()
    model.load_state_dict(state)
    with torch.no_grad():
        probs, logits = model(torch.from_numpy(x))
        return float(get_loss_criterion({"loss": dict(BCE_DICE)})(logits, torch.from_numpy(y))), probs.numpy()


def _jax_copy(variables):
    return jax.tree_util.tree_map(jnp.array, variables)


def _jax_spatial_step(model, variables, x, y, n):
    """JAX `build_spatial_train_step` on n of the virtual devices: (loss, probs NCDHW, port-named params)."""
    tx = optax.sgd(LR)
    mesh = jax_spatial.space_mesh(n)
    step = jax_spatial.build_spatial_train_step(model, JaxBCEDiceLoss(), tx, mesh)
    vs = jax_spatial.replicate_spatial(mesh, _jax_copy(variables))
    opt_state = jax_spatial.replicate_spatial(mesh, tx.init(vs["params"]))
    xi, yi = jax_spatial.shard_spatial_batch(mesh, (np.moveaxis(x, 1, -1), np.moveaxis(y, 1, -1)))
    new_vs, _, loss, probs = step(vs, opt_state, jax.random.PRNGKey(1), xi, yi)
    return float(loss), np.moveaxis(np.asarray(probs), -1, 1), state_dict_from_jax(jax.device_get(new_vs))


def _jax_dp_sp_step(model, variables, x, y):
    tx = optax.sgd(LR)
    mesh = jax_spatial.dp_sp_mesh(2, 2)
    step = jax_spatial.build_dp_sp_train_step(model, JaxBCEDiceLoss(), tx, mesh)
    vs = jax_spatial.replicate_spatial(mesh, _jax_copy(variables))
    opt_state = jax_spatial.replicate_spatial(mesh, tx.init(vs["params"]))
    xi, yi = jax_spatial.shard_dp_sp_batch(mesh, (np.moveaxis(x, 1, -1), np.moveaxis(y, 1, -1)))
    new_vs, _, loss, _ = step(vs, opt_state, jax.random.PRNGKey(1), xi, yi)
    return float(loss), state_dict_from_jax(jax.device_get(new_vs))


def _halo_reference(x, pad, n, r):
    """Single-process halo exchange: each slab's zero-padded neighbourhood, and
    dx of sum(y * r) over all slabs."""
    d = x.shape[2] // n
    padded = np.pad(x, [(0, 0), (0, 0), (pad, pad), (0, 0), (0, 0)])
    ys = [padded[:, :, i * d:i * d + d + 2 * pad] for i in range(n)]
    dpad = np.zeros_like(padded)
    for i in range(n):
        dpad[:, :, i * d:i * d + d + 2 * pad] += r[i]
    dx = dpad[:, :, pad:pad + x.shape[2]]
    return ys, [dx[:, :, i * d:(i + 1) * d] for i in range(n)]


def _sweep_setup():
    model = get_model(dict(SWEEP_CFG)).eval()
    _, variables = _jax_variables(SWEEP_CFG, (32, 16, 16), seed=0)
    model.load_state_dict(state_dict_from_jax(variables))
    vol = np.random.RandomState(1).rand(48, 32, 32).astype(np.float32)
    padded = np.pad(vol, [(h, h) for h in SWEEP_HALO], mode="reflect")
    starts = np.asarray([(z, y, x) for z in (0, 24) for y in (0, 16) for x in (0, 16)], np.int32)
    return model, padded, starts


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results and this process's references."""
    out = tmp_path_factory.mktemp("spatial_ranks")
    rs = np.random.RandomState(7)
    jax_model, variables = _jax_variables(CFG, PATCH, seed=0)
    state = state_dict_from_jax(variables)
    x, y = _batch(rs, 1, PATCH)
    x2, y2 = _batch(np.random.RandomState(3), 2, PATCH)
    res_cfg = {**CFG, "name": "ResidualUNet3D", "layer_order": "cge"}
    se_cfg = {**CFG, "name": "ResidualUNetSE3D", "layer_order": "cge"}
    res_state = state_dict_from_jax(_jax_variables(res_cfg, RES_PATCH, seed=1)[1])
    se_state = state_dict_from_jax(_jax_variables(se_cfg, RES_PATCH, seed=2)[1])
    res_x, res_y = _batch(np.random.RandomState(3), 1, RES_PATCH)
    halo_x = np.random.RandomState(4).randn(1, 3, 8, 4, 5).astype(np.float32)
    halo_r = {name: np.random.RandomState(5).randn(n, 1, 3, 8 // n + 2 * pad, 4, 5).astype(np.float32)
              for name, n, pad in (("halo_n4_p1", 4, 1), ("halo_n2_p1", 2, 1), ("halo_n2_p2", 2, 2))}
    sweep_model, sweep_volume, sweep_starts = _sweep_setup()
    slab_volume = np.random.RandomState(2).rand(*SLAB_VOLUME).astype(np.float32)
    slab_stats = {"mean": float(slab_volume.mean()), "std": float(slab_volume.std())}
    trainer_config = {"device": "cpu", "manual_seed": 0, "model": {**CFG, "remat": True}, "loss": BCE_DICE,
                      "eval_metric": {"name": "DiceCoefficient"}, "optimizer": {"name": "SGD", "learning_rate": LR},
                      "trainer": {"checkpoint_dir": str(out / "ckpt"), "spatial_sharding": True, "ema_decay": 0.999,
                                  "eval_score_higher_is_better": True, "validate_after_iters": 10**6,
                                  "log_after_iters": 10**6, "max_num_epochs": 1, "max_num_iterations": 10}}
    from tests.test_torch_port_parallel import predict_config

    save_checkpoint({"model_state_dict": sweep_model.state_dict()}, False, checkpoint_dir=str(out))
    grid = predict_config(out, "grid", str(out / "last_checkpoint.pytorch"),
                          {"name": "DeviceSlidingWindowPredictor", "blend": "gaussian"}, PREDICT_DEPTHS)
    grid["model"] = dict(SWEEP_CFG)
    with open(out / "grid.yml", "w") as f:
        yaml.safe_dump(grid, f)
    torch.save({"predict_config": str(out / "grid.yml"), "lr": LR, "cfg": CFG, "state": state, "x": x, "y": y, "x2": x2, "y2": y2, "res_cfg": res_cfg,
                "se_cfg": se_cfg, "res_state": res_state, "se_state": se_state, "res_x": res_x, "res_y": res_y,
                "halo_x": halo_x, "halo_r": halo_r, "sweep_cfg": SWEEP_CFG, "sweep_state": sweep_model.state_dict(),
                "sweeps": SWEEPS, "sweep_patch": SWEEP_PATCH, "sweep_halo": SWEEP_HALO, "sweep_volume": sweep_volume,
                "sweep_starts": sweep_starts, "slab_kwargs": SLAB_KWARGS, "slab_volume": slab_volume,
                "slab_patch": SLAB_PATCH, "slab_halo": SLAB_HALO, "slab_stats": slab_stats,
                "trainer_config": trainer_config}, out / "inputs.pt")
    procs = spawn_ranks(_WORKER, WORLD, out)

    # the references, while the ranks run
    refs = {"eval": _port_eval(state, x, y), "unet": _port_step(CFG, state, x, y), "resunet": _port_step(res_cfg, res_state, res_x, res_y),
            "se": _port_step(se_cfg, se_state, res_x, res_y),
            "batch2_bce": _port_step(CFG, state, x2, y2, {"name": "BCEWithLogitsLoss"}),
            "batch2": _port_step(CFG, state, x2, y2)}
    for n in (2, 4):
        refs[f"jax_n{n}"] = _jax_spatial_step(jax_model, variables, x, y, n)
    refs["jax_dp_sp"] = _jax_dp_sp_step(jax_model, variables, x2, y2)
    refs["sweeps"] = {name: DeviceSlidingWindow(sweep_model, SWEEP_PATCH, SWEEP_HALO, **kwargs)(sweep_volume,
                                                                                                 sweep_starts)
                      for name, kwargs in SWEEPS.items()}
    single = DeviceSlidingWindowPredictor(sweep_model, None, 2, "cpu", shard=False, **SLAB_KWARGS)
    refs["slab"] = single.predict_array(slab_volume, SLAB_PATCH, SLAB_PATCH, SLAB_HALO, normalize="standardize",
                                        stats=slab_stats)
    refs["halo"] = {name: _halo_reference(halo_x, pad, n, halo_r[name])
                    for name, n, pad in (("halo_n4_p1", 4, 1), ("halo_n2_p1", 2, 1), ("halo_n2_p2", 2, 2))}
    from tests.test_torch_port_parallel import predict_twin, predictions

    refs["grid_one"] = predictions(predict_twin(grid), PREDICT_DEPTHS)
    results = collect(procs, out)
    refs["grid"] = predictions(grid, PREDICT_DEPTHS)
    for rank, res in enumerate(results):
        with open(out / f"rank{rank}.log") as f:
            res["log"] = f.read()
    return results, refs


def _assert_params(got, want, atol=1e-4):
    assert set(got) >= set(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name], np.asarray(value), rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("n", [2, 4])
def test_spatial_step_matches_unsharded_and_jax(ranks, n):
    results, refs = ranks
    ref_loss, ref_probs, ref_params = refs["unet"]
    jax_loss, jax_probs, jax_params = refs[f"jax_n{n}"]
    for rank, res in enumerate(results):
        got = res[f"unet_n{n}"]
        assert np.isfinite(got["loss"])
        np.testing.assert_allclose(got["loss"], ref_loss, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["loss"], jax_loss, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["probs"], ref_probs, rtol=0, atol=1e-4)
        np.testing.assert_allclose(got["probs"], jax_probs, rtol=0, atol=1e-4)
        _assert_params(got["params"], ref_params)
        _assert_params(got["params"], jax_params)
        # every rank made the same update
        _assert_params(got["params"], results[0][f"unet_n{n}"]["params"], atol=0)


def test_spatial_eval_step_matches_unsharded(ranks):
    results, refs = ranks
    loss, probs = refs["eval"]
    for res in results:
        np.testing.assert_allclose(res["eval_n4"]["loss"], loss, rtol=0, atol=1e-5)
        np.testing.assert_allclose(res["eval_n4"]["probs"], probs, rtol=0, atol=1e-4)


@pytest.mark.parametrize("family", ["resunet", "se"])
def test_spatial_step_resnet_families(ranks, family):
    """ResidualUNet3D (the deconv's 2-plane halo and fix-up gather) and
    ResidualUNetSE3D (the all-reduced squeeze, under P3DUNET_TAPFOLD=1) at n = 2."""
    results, refs = ranks
    ref_loss, ref_probs, ref_params = refs[family]
    for res in results:
        got = res[f"{family}_n2"]
        np.testing.assert_allclose(got["loss"], ref_loss, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["probs"], ref_probs, rtol=0, atol=1e-4)
        _assert_params(got["params"], ref_params)


def test_spatial_accumulation_matches_the_batch_stacked_step(ranks):
    results, refs = ranks
    for res in results:
        _assert_params(res["accum_n2"]["params"], refs["batch2_bce"][2])


def test_dp_sp_step_matches_jax_and_the_global_batch(ranks):
    """The 2 x 2 rank grid against JAX `build_dp_sp_train_step` on a 2 x 2
    device mesh (the same function: per-data-shard losses averaged) and, as
    JAX test_spatial.py:101-133 holds it, the one-device batch-2 step."""
    results, refs = ranks
    jax_loss, jax_params = refs["jax_dp_sp"]
    ref_loss, _, ref_params = refs["batch2"]
    for res in results:
        got = res["dp_sp"]
        np.testing.assert_allclose(got["loss"], jax_loss, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["loss"], ref_loss, rtol=0, atol=1e-5)
        _assert_params(got["params"], jax_params)
        _assert_params(got["params"], ref_params)


@pytest.mark.parametrize("name", ["halo_n4_p1", "halo_n2_p1", "halo_n2_p2"])
def test_halo_exchange_forward_and_backward(ranks, name):
    results, refs = ranks
    ys, dxs = refs["halo"][name]
    n = len(ys)
    for rank, res in enumerate(results):
        index = rank % n
        np.testing.assert_array_equal(res[name]["y"], ys[index])
        np.testing.assert_allclose(res[name]["dx"], dxs[index], rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", list(SWEEPS))
def test_spatial_sweep_matches_unsharded(ranks, name):
    results, refs = ranks
    for res in results:
        np.testing.assert_allclose(res["sweep_" + name], refs["sweeps"][name], rtol=0, atol=2e-5)


def test_predictor_slab_coop_matches_unsharded(ranks):
    """`patch_mode: slab` plans 2 slabs of depth 72 for 4 ranks: each slab is
    z-sharded over all of them, against the one-rank run of the same geometry."""
    results, refs = ranks
    for res in results:
        assert res["slab_spatial_n"] == [4]
        np.testing.assert_allclose(res["slab"], refs["slab"], rtol=0, atol=2e-5)


def test_trainer_spatial_sharding_with_remat_and_ema(ranks):
    """The trainer's spatial update (space mesh over the 4 ranks, `model.remat`:
    the recomputed levels exchange halos again in backward) equals the
    unsharded step; its EMA is d * p0 + (1 - d) * p1 on every rank; validation
    scores the gathered probabilities alike on every rank."""
    results, refs = ranks
    for res in results:
        got = res["trainer"]
        assert got["mesh"] == WORLD
        _assert_params(got["params"], refs["unet"][2])
        assert got["val"] == results[0]["trainer"]["val"] and np.isfinite(got["val"])
        p1 = [got["params"][name] for name in get_model(dict(CFG)).state_dict()
              if not name.endswith("num_batches_tracked")]
        for e, p0, p in zip(got["ema"], got["p0"], p1):
            np.testing.assert_allclose(e, p0 + (p - p0) * (1 - 0.999), rtol=0, atol=1e-6)


def test_trainer_fit_under_spatial_sharding(ranks):
    """`fit` with a log, a validation and a save each iteration: the ranks
    stop together with one best score; rank 0 wrote the checkpoint."""
    results, _ = ranks
    assert [res["fit"]["iterations"] for res in results] == [2] * WORLD
    assert len({res["fit"]["best"] for res in results}) == 1 and np.isfinite(results[0]["fit"]["best"])
    assert results[0]["fit"]["checkpoint"]


def test_spatial_shardable_matches_jax():
    cases = [(64, 4, 8, 2, 1), (80, 4, 2, 2, 1), (80, 4, 8, 2, 1), (10, 1, 1, 2, 1), (36, 4, 3, 2, 1),
             (64, 4, 8, 2, 2), (64, 4, 4, 2, 2), (40, 5, 8, 1, 1), (40, 5, 8, 2, 1), (80, 4, 2, 2, 2)]
    for d, levels, n, pool, min_local in cases:
        assert spatial.spatial_shardable(d, levels, n, pool=pool, min_local=min_local) == \
            jax_spatial.spatial_shardable(d, levels, n, pool=pool, min_local=min_local), (d, levels, n, pool)
    assert spatial.spatial_shardable(80, 4, 2) and not spatial.spatial_shardable(80, 4, 8)


def test_spatial_sweep_rejects_z_tta_and_bad_depth():
    model = get_model(dict(SWEEP_CFG)).eval()
    four = Mesh(range(4), "space")
    with pytest.raises(ValueError, match="z-mirror TTA"):
        DeviceSlidingWindow(model, SWEEP_PATCH, SWEEP_HALO, tta_axes=(0,), spatial_mesh=four)
    with pytest.raises(ValueError, match="not exactly shardable"):
        # padded depth 30 does not divide across 4 shards
        DeviceSlidingWindow(model, (26, 16, 16), (2, 2, 2), spatial_mesh=four)
    with pytest.raises(ValueError, match="percentile"):
        DeviceSlidingWindow(model, SWEEP_PATCH, SWEEP_HALO, normalize="percentile", spatial_mesh=four)


def test_predict_cli_splits_the_grid_across_a_host_s_ranks(ranks):
    """`predict.main` at 4 ranks of one host: the device sweep splits each
    volume's patch grid over them and rank 0 alone writes, the outputs within
    2e-5 of one process; no rank imported jax or the JAX package."""
    results, refs = ranks
    for rank, res in enumerate(results):
        assert res["imported"] == []
        assert "Sharding the patch grid over 4 ranks" in res["log"]
        assert ("Saving predictions" in res["log"]) == (rank == 0)
    for stem in PREDICT_DEPTHS:
        np.testing.assert_allclose(refs["grid"][stem], refs["grid_one"][stem], rtol=0, atol=2e-5)
