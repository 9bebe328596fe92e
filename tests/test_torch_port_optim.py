"""The port's optimizers and lr schedulers (pytorch3dunet_tpu_torch/utils/optim.py)
against the JAX package's `create_optimizer` (optax) and scheduler classes.

Each optimizer takes 3 updates on the same seeded numpy gradients from the
same parameters in both packages, with and without weight decay; the
parameters after each update must agree within 2e-6 (f32 rounding of
updates of about lr = 1e-2 on parameters of about 1: the packages round eps,
bias corrections and reductions in different orders). The schedulers' lr
sequences must agree within 1e-12 (both compute in Python floats).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch3dunet_tpu.utils import optim as jax_optim
from pytorch3dunet_tpu_torch.utils import optim as port_optim
from pytorch3dunet_tpu_torch.utils.optim import create_lr_scheduler, create_optimizer

OPTIMIZERS = ["Adam", "Adadelta", "Adagrad", "AdamW", "SparseAdam", "Adamax", "LBFGS", "NAdam", "RAdam",
              "RMSprop", "Rprop", "SGD"]
SHAPES = {"b": (5,), "w": (4, 5)}
TOL = 2e-6


def _params(seed=0):
    rs = np.random.RandomState(seed)
    return {name: (1 + 0.5 * rs.randn(*shape)).astype(np.float32) for name, shape in SHAPES.items()}


def _grads(n, seed=1):
    # gradients of both signs and of different sizes, a sign flip among them for Rprop
    rs = np.random.RandomState(seed)
    return [{name: (rs.randn(*shape) * 10.0 ** rs.uniform(-2, 0, shape)).astype(np.float32)
             for name, shape in SHAPES.items()} for _ in range(n)]


class _Module(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        self.values = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                                              for k, v in params.items()})


def _port_trajectory(config, params, grads):
    module = _Module(params)
    optimizer = create_optimizer(config, module)
    out = []
    for g in grads:
        for name, p in module.values.items():
            p.grad = torch.from_numpy(g[name].copy())
        optimizer.step()
        out.append({k: p.detach().numpy().copy() for k, p in module.values.items()})
    return out, optimizer


def _jax_trajectory(config, params, grads):
    tx = jax_optim.create_optimizer(config)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(p)
    out = []
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, p)
        p = optax.apply_updates(p, updates)
        out.append({k: np.asarray(v) for k, v in p.items()})
    return out, state


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_matches_optax(name, weight_decay):
    config = {"name": name, "learning_rate": 1e-2, "weight_decay": weight_decay}
    params, grads = _params(), _grads(3)
    port, optimizer = _port_trajectory(config, params, grads)
    want, _ = _jax_trajectory(config, params, grads)
    moved = False
    for step, (got_p, want_p) in enumerate(zip(port, want)):
        for key in SHAPES:
            np.testing.assert_allclose(got_p[key], want_p[key], rtol=0, atol=TOL, err_msg=f"{name} step {step} {key}")
            moved |= not np.array_equal(got_p[key], params[key])
    assert moved
    # the lr stays where the schedulers and should_stop read it
    assert all(group["lr"] == 1e-2 for group in optimizer.param_groups)


def test_adam_mu_dtype_bfloat16_matches_optax():
    config = {"name": "Adam", "learning_rate": 1e-2, "weight_decay": 1e-3, "mu_dtype": "bfloat16"}
    params, grads = _params(), _grads(3)
    port, optimizer = _port_trajectory(config, params, grads)
    want, state = _jax_trajectory(config, params, grads)
    for got_p, want_p in zip(port, want):
        for key in SHAPES:
            np.testing.assert_allclose(got_p[key], want_p[key], rtol=0, atol=TOL, err_msg=key)
    # the first moment stored in bfloat16 as optax stores it, the second in float32
    adam_state = state.inner_state[1][0]
    assert {str(leaf.dtype) for leaf in adam_state.mu.values()} == {"bfloat16"}
    # a ParameterDict keeps the insertion order of SHAPES
    for key, p in zip(SHAPES, optimizer.param_groups[0]["params"]):
        mu, nu = optimizer.state[p]["mu"], optimizer.state[p]["nu"]
        assert mu.dtype == torch.bfloat16 and nu.dtype == torch.float32
        np.testing.assert_array_equal(mu.float().numpy(), np.asarray(adam_state.mu[key], dtype=np.float32))


def test_optimizer_state_survives_a_state_dict_round_trip():
    # LBFGS keeps its whole history under its first parameter
    config = {"name": "LBFGS", "learning_rate": 1e-2, "history_size": 4}
    params, grads = _params(), _grads(5)
    full, _ = _port_trajectory(config, params, grads)
    first, optimizer = _port_trajectory(config, params, grads[:2])
    module = _Module(first[-1])
    resumed = create_optimizer(config, module)
    resumed.load_state_dict(optimizer.state_dict())
    for g in grads[2:]:
        for name, p in module.values.items():
            p.grad = torch.from_numpy(g[name].copy())
        resumed.step()
    for key in SHAPES:
        np.testing.assert_array_equal(module.values[key].detach().numpy(), full[-1][key])


def test_unknown_optimizer_and_mu_dtype_raise():
    module = _Module(_params())
    with pytest.raises(RuntimeError, match="Unsupported optimizer"):
        create_optimizer({"name": "Lion"}, module)
    with pytest.raises(ValueError, match="mu_dtype"):
        create_optimizer({"name": "Adam", "mu_dtype": "int8"}, module)


SCHEDULERS = [
    {"name": "MultiStepLR", "milestones": [2, 5], "gamma": 0.5},
    {"name": "StepLR", "step_size": 3, "gamma": 0.3},
    {"name": "ExponentialLR", "gamma": 0.9},
    {"name": "CosineAnnealingLR", "T_max": 6, "eta_min": 1e-5},
    {"name": "CosineAnnealingWarmRestarts", "T_0": 3, "T_mult": 2, "eta_min": 1e-5},
    {"name": "CosineAnnealingWarmRestarts", "T_0": 4},
    {"name": "ConstantLR", "factor": 0.25, "total_iters": 3},
    {"name": "LinearLR", "start_factor": 0.1, "end_factor": 1.0, "total_iters": 4},
    {"name": "PolynomialLR", "total_iters": 6, "power": 2.0},
    {"name": "OneCycleLR", "max_lr": 0.1, "total_steps": 10},
    {"name": "OneCycleLR", "max_lr": 0.1, "total_steps": 10, "anneal_strategy": "linear", "pct_start": 0.5},
    {"name": "LambdaLR", "lr_lambda": "0.95 ** epoch"},
    {"name": "LambdaLR", "lr_lambda": "max(0.1, 1 - epoch / 8) * math.cos(epoch / 10)"},
    {"name": "ReduceLROnPlateau", "mode": "min", "factor": 0.5, "patience": 1},
]


@pytest.mark.parametrize("config", SCHEDULERS, ids=lambda c: c["name"])
def test_scheduler_lr_sequence_matches_jax(config):
    optimizer = torch.optim.SGD([torch.nn.Parameter(torch.zeros(1)), torch.nn.Parameter(torch.zeros(2))], lr=1e-2)
    optimizer.param_groups.append({**optimizer.param_groups[0], "params": [torch.nn.Parameter(torch.zeros(1))]})
    port = create_lr_scheduler(config, optimizer)
    handle = jax_optim.OptimizerHandle(1e-2)
    jax_sched = jax_optim.create_lr_scheduler(config, handle)
    # the epoch-0 lr applies at once, in every param group
    port_lrs, jax_lrs = [[g["lr"] for g in optimizer.param_groups]], [handle.lr]
    scores = [1.0, 0.9, 0.95, 0.95, 0.95, 0.89, 0.9, 0.9, 0.9, 0.9, 0.91, 0.5]
    for score in scores:
        if config["name"] == "ReduceLROnPlateau":
            port.step(score)
            jax_sched.step(score)
        else:
            port.step()
            jax_sched.step()
        port_lrs.append([g["lr"] for g in optimizer.param_groups])
        jax_lrs.append(handle.lr)
    assert all(len(set(lrs)) == 1 for lrs in port_lrs)
    np.testing.assert_allclose([lrs[0] for lrs in port_lrs], jax_lrs, rtol=1e-12, atol=0)
    assert len(set(jax_lrs)) > 1


@pytest.mark.parametrize("expr", ["__import__('os').system('true')", "epoch.__class__", "open('x')",
                                  "math.__dict__", "[epoch]"])
def test_lambda_lr_refuses_non_arithmetic(expr):
    optimizer = torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=1e-2)
    with pytest.raises(ValueError, match="unsupported element"):
        create_lr_scheduler({"name": "LambdaLR", "lr_lambda": expr}, optimizer)
    with pytest.raises(ValueError, match="unsupported element"):
        jax_optim.create_lr_scheduler({"name": "LambdaLR", "lr_lambda": expr}, jax_optim.OptimizerHandle(1e-2))


def test_scheduler_refusals_match_jax():
    optimizer = torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=1e-2)
    with pytest.raises(ValueError, match="three_phase"):
        create_lr_scheduler({"name": "OneCycleLR", "max_lr": 0.1, "total_steps": 10, "three_phase": True}, optimizer)
    with pytest.raises(RuntimeError) as port_err:
        create_lr_scheduler({"name": "CyclicLR"}, optimizer)
    with pytest.raises(RuntimeError) as jax_err:
        jax_optim.create_lr_scheduler({"name": "CyclicLR"}, jax_optim.OptimizerHandle(1e-2))
    assert str(port_err.value) == str(jax_err.value)
    assert port_optim.is_plateau(create_lr_scheduler({"name": "ReduceLROnPlateau"}, optimizer))
