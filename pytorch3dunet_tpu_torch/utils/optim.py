"""Optimizer and lr-scheduler factories of the port, built from the JAX
package's config schema (pytorch3dunet_tpu/utils/optim.py).

The 12 optimizer names of the JAX factory, each computing what its optax
transform computes for the same gradients, with optax's defaults:
- torch natives where one computes the same update: `Adam` (the default),
  `SparseAdam` (dense Adam without weight decay, as in JAX), `AdamW` (decoupled
  weight decay scaled by the lr), `Adamax`, `Adadelta` and `SGD`;
- small `torch.optim.Optimizer` subclasses below where torch's differs:
  `Adagrad` (optax starts the accumulator at 0.1, eps 1e-7 inside the square
  root), `RMSprop` (eps inside the square root), `NAdam` (optax's is Adam with
  Nesterov momentum, no momentum-decay schedule), `RAdam` (eps added after the
  bias correction, rectified from rho >= 5), `Rprop` (optax's update lags one
  step behind its sign history), `LBFGS` (`scale_by_lbfgs` then -lr: one update
  per step, no closure, no line search), and `Adam` with `mu_dtype` (the first
  moment stored in that dtype).
Weight decay, where the JAX factory applies it (`_with_l2`), adds wd * p to the
gradient first. The lr stays in `param_groups[*]['lr']`, where the schedulers
and the trainer's stopping rule read it.

The schedulers are the JAX package's classes on the torch optimizer's param
groups: nine lr-only schedules, `OneCycleLR` without momentum cycling, a
`LambdaLR` that takes a YAML arithmetic string, and torch's own
`ReduceLROnPlateau` with the JAX class's arguments and defaults.
"""

import ast
import math

import torch

from pytorch3dunet_tpu_torch.utils.misc import get_logger

logger = get_logger("Optim")


class _OptaxOptimizer(torch.optim.Optimizer):
    """An optimizer applying an optax-style per-parameter update: `_update`
    adds `weight_decay * p` to each gradient (the JAX `_with_l2`), asks
    `_direction` for the update direction u and applies p - lr * u."""

    def __init__(self, params, lr, weight_decay=0.0, **defaults):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay, **defaults))

    def _direction(self, grad, state, group):
        raise NotImplementedError

    def _update(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                grad = p.grad
                if group["weight_decay"]:
                    grad = grad.add(p, alpha=group["weight_decay"])
                p.sub_(self._direction(grad, self.state[p], group).mul_(group["lr"]))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self._update()
        return loss


class Adagrad(_OptaxOptimizer):
    """optax.adagrad: the sum of squares starts at `initial_accumulator_value`
    and u = g / sqrt(sum + eps)."""

    def __init__(self, params, lr, weight_decay=0.0, initial_accumulator_value=0.1, eps=1e-7):
        super().__init__(params, lr, weight_decay, initial_accumulator_value=initial_accumulator_value, eps=eps)

    def _direction(self, grad, state, group):
        if not state:
            state["sum"] = torch.full_like(grad, group["initial_accumulator_value"])
        total = state["sum"].add_(grad * grad)
        return torch.where(total > 0, torch.rsqrt(total + group["eps"]), 0.0) * grad


class RMSprop(_OptaxOptimizer):
    """optax.rmsprop (not centered, no momentum): nu = a * nu + (1 - a) * g^2
    from 0, u = g / sqrt(nu + eps)."""

    def __init__(self, params, lr, weight_decay=0.0, alpha=0.99, eps=1e-8):
        super().__init__(params, lr, weight_decay, alpha=alpha, eps=eps)

    def _direction(self, grad, state, group):
        if not state:
            state["nu"] = torch.zeros_like(grad)
        decay = group["alpha"]
        nu = state["nu"]
        nu.copy_((1 - decay) * grad**2 + decay * nu)
        return torch.rsqrt(nu + group["eps"]) * grad


class Adam(_OptaxOptimizer):
    """optax.scale_by_adam: Adam with the first moment stored in `mu_dtype`
    (the update uses it before the cast, as optax does) and, with `nesterov`,
    optax's Nesterov form (`NAdam`)."""

    def __init__(self, params, lr, betas=(0.9, 0.999), weight_decay=0.0, eps=1e-8, mu_dtype=None, nesterov=False):
        super().__init__(params, lr, weight_decay, betas=tuple(betas), eps=eps, mu_dtype=mu_dtype,
                         nesterov=nesterov)

    def _moments(self, grad, state, group):
        """(mu in float32, nu, step count) after this gradient; stores mu in its dtype."""
        if not state:
            state["step"] = 0
            state["mu"] = torch.zeros_like(grad, dtype=group["mu_dtype"] or grad.dtype)
            state["nu"] = torch.zeros_like(grad)
        b1, b2 = group["betas"]
        # b1 rounded to mu's dtype first, as JAX multiplies a bfloat16 array by a Python float
        mu = (1 - b1) * grad + torch.tensor(b1, dtype=state["mu"].dtype) * state["mu"]
        state["nu"].copy_((1 - b2) * grad**2 + b2 * state["nu"])
        state["step"] += 1
        state["mu"].copy_(mu)
        return mu, state["nu"], state["step"]

    def _direction(self, grad, state, group):
        mu, nu, t = self._moments(grad, state, group)
        b1, b2 = group["betas"]
        if group["nesterov"]:
            mu_hat = b1 * (mu / (1 - b1 ** (t + 1))) + (1 - b1) * (grad / (1 - b1**t))
        else:
            mu_hat = mu / (1 - b1**t)
        return mu_hat / (torch.sqrt(nu / (1 - b2**t)) + group["eps"])


class NAdam(Adam):
    """optax.nadam: Adam with Nesterov momentum (no momentum-decay schedule)."""

    def __init__(self, params, lr, betas=(0.9, 0.999), weight_decay=0.0, eps=1e-8):
        super().__init__(params, lr, betas, weight_decay, eps, nesterov=True)


class RAdam(Adam):
    """optax.radam: rectified Adam from rho_t >= `threshold`, the bias-corrected
    first moment alone before."""

    def __init__(self, params, lr, betas=(0.9, 0.999), weight_decay=0.0, eps=1e-8, threshold=5.0):
        _OptaxOptimizer.__init__(self, params, lr, weight_decay, betas=tuple(betas), eps=eps, mu_dtype=None,
                                 nesterov=False, threshold=threshold)

    def _direction(self, grad, state, group):
        mu, nu, t = self._moments(grad, state, group)
        b1, b2 = group["betas"]
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = b2**t
        ro = ro_inf - 2 * t * b2t / (1 - b2t)
        mu_hat = mu / (1 - b1**t)
        if ro < group["threshold"]:
            return mu_hat
        r = math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
        return r * mu_hat / (torch.sqrt(nu / (1 - b2t)) + group["eps"])


class Rprop(_OptaxOptimizer):
    """optax.rprop: per-element step sizes from `lr`, grown by eta_plus on a
    kept sign and shrunk by eta_minus on a flip within `step_sizes`; the update
    applied is the previous step's signed step (0 on a flip), so the first
    update is zero. The lr is read only to start the step sizes, and weight
    decay does not apply (as in the JAX factory)."""

    def __init__(self, params, lr, etas=(0.5, 1.2), step_sizes=(1e-6, 50.0)):
        super().__init__(params, lr, 0.0, etas=tuple(etas), step_sizes=tuple(step_sizes))

    def _update(self):
        for group in self.param_groups:
            eta_minus, eta_plus = group["etas"]
            low, high = group["step_sizes"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                grad, state = p.grad, self.state[p]
                if not state:
                    state["step_size"] = torch.full_like(grad, group["lr"])
                    state["prev"] = torch.zeros_like(grad)
                sign = grad * state["prev"]
                grown = (state["step_size"] * torch.where(sign > 0, eta_plus, eta_minus)).clamp(low, high)
                step_size = torch.where(sign == 0, state["step_size"], grown)
                update = torch.where(sign < 0, 0.0, state["prev"])
                state["prev"] = torch.where(sign < 0, 0.0, step_size * torch.sign(grad))
                state["step_size"] = step_size
                p.sub_(update)


class LBFGS(_OptaxOptimizer):
    """optax.scale_by_lbfgs followed by -lr, as the JAX factory chains them:
    one update per step from the gradient alone (no closure, no line search),
    the two-loop product over the last `history_size` differences of the
    parameters and gradients, all parameters taken as one vector. The first
    step scales the gradient by min(1, 1 / |g|). The state lives under the
    first parameter, so the optimizer's state dict carries it."""

    def __init__(self, params, lr, history_size=100):
        if history_size < 1:
            raise ValueError("history_size must be >= 1")
        super().__init__(params, lr, 0.0, history_size=history_size)

    def _update(self):
        params = [p for group in self.param_groups for p in group["params"] if p.grad is not None]
        if not params:
            return
        m = self.param_groups[0]["history_size"]
        w = torch.cat([p.reshape(-1) for p in params])
        u = torch.cat([p.grad.reshape(-1) for p in params])
        state = self.state[params[0]]
        if not state:
            state.update(count=0, params=torch.zeros_like(w), updates=torch.zeros_like(w),
                         dw=w.new_zeros((m, w.numel())), du=w.new_zeros((m, w.numel())), rho=w.new_zeros(m))
        count = state["count"]
        idx, prev = count % m, (count - 1) % m
        if count > 0:
            dw, du = w - state["params"], u - state["updates"]
            dot = torch.dot(du, dw)
            state["dw"][prev], state["du"][prev] = dw, du
            state["rho"][prev] = torch.where(dot == 0, 0.0, 1.0 / dot)
            norm2 = torch.dot(du, du)
            scale = torch.where(norm2 > 0, dot / norm2, 1.0)
        else:
            state["dw"][prev], state["du"][prev], state["rho"][prev] = 0.0, 0.0, 0.0
            scale = torch.clamp(1.0 / torch.linalg.vector_norm(u), max=1.0)
        # slots written since the first step, oldest first (the others hold zeros)
        order = [(idx + i) % m for i in range(m)][m - min(count, m):]
        vec, alphas = u, {}
        for i in reversed(order):
            alphas[i] = state["rho"][i] * torch.dot(state["dw"][i], vec)
            vec = vec - alphas[i] * state["du"][i]
        vec = scale * vec
        for i in order:
            beta = state["rho"][i] * torch.dot(state["du"][i], vec)
            vec = vec + (alphas[i] - beta) * state["dw"][i]
        state.update(count=count + 1, params=w, updates=u)
        lr = self.param_groups[0]["lr"]
        offset = 0
        for p in params:
            n = p.numel()
            p.sub_(vec[offset:offset + n].view_as(p) * lr)
            offset += n


_MU_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16, "float16": torch.float16,
              "float32": torch.float32}


def create_optimizer(optimizer_config: dict, model: torch.nn.Module) -> torch.optim.Optimizer:
    """Builds the optimizer of `model`'s parameters from config['optimizer']
    (JAX utils/optim.py `create_optimizer`)."""
    name = optimizer_config.get("name", "Adam")
    lr = optimizer_config.get("learning_rate", 1e-3)
    wd = optimizer_config.get("weight_decay", 0)
    betas = tuple(optimizer_config.get("betas", (0.9, 0.999)))
    params = model.parameters()
    if name == "Adadelta":
        return torch.optim.Adadelta(params, lr=lr, rho=optimizer_config.get("rho", 0.9), eps=1e-6,
                                    weight_decay=wd)
    if name == "Adagrad":
        return Adagrad(params, lr, weight_decay=wd)
    if name == "AdamW":
        return torch.optim.AdamW(params, lr=lr, betas=betas, weight_decay=wd)
    if name == "SparseAdam":
        return torch.optim.Adam(params, lr=lr, betas=betas)
    if name == "Adamax":
        return torch.optim.Adamax(params, lr=lr, betas=betas, eps=1e-8, weight_decay=wd)
    if name == "LBFGS":
        return LBFGS(params, lr, history_size=optimizer_config.get("history_size", 100))
    if name == "NAdam":
        return NAdam(params, lr, betas=betas, weight_decay=wd)
    if name == "RAdam":
        return RAdam(params, lr, betas=betas, weight_decay=wd)
    if name == "RMSprop":
        return RMSprop(params, lr, weight_decay=wd, alpha=optimizer_config.get("alpha", 0.99))
    if name == "Rprop":
        return Rprop(params, lr, etas=optimizer_config.get("etas", (0.5, 1.2)),
                     step_sizes=optimizer_config.get("step_sizes", (1e-6, 50)))
    if name == "SGD":
        return torch.optim.SGD(params, lr=lr, momentum=optimizer_config.get("momentum", 0) or 0,
                               nesterov=optimizer_config.get("nesterov", False), weight_decay=wd)
    if name != "Adam":
        raise RuntimeError(f"Unsupported optimizer: '{name}'")
    mu_dtype = optimizer_config.get("mu_dtype")
    if mu_dtype is not None:
        if mu_dtype not in _MU_DTYPES:
            raise ValueError(f"optimizer.mu_dtype {mu_dtype!r} not understood -- supported: {sorted(_MU_DTYPES)}")
        return Adam(params, lr, betas=betas, weight_decay=wd, mu_dtype=_MU_DTYPES[mu_dtype])
    return torch.optim.Adam(params, lr=lr, betas=betas, weight_decay=wd)


# --- lr schedulers (the JAX package's classes on torch param groups) -----------------------------------------------


class _Scheduler:
    """An lr schedule of the epoch count: `step()` advances it and writes the
    new lr into every param group."""

    def __init__(self, optimizer: torch.optim.Optimizer):
        self.optimizer = optimizer
        self.base_lr = optimizer.param_groups[0]["lr"]
        self.last_epoch = 0

    def _set_lr(self, lr: float):
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    def step(self, metric=None):
        self.last_epoch += 1
        self._set_lr(self.get_lr())

    def get_lr(self) -> float:
        raise NotImplementedError


class MultiStepLR(_Scheduler):
    def __init__(self, optimizer, milestones, gamma=0.1, **kwargs):
        super().__init__(optimizer)
        self.milestones = sorted(milestones)
        self.gamma = gamma

    def get_lr(self):
        passed = sum(1 for m in self.milestones if m <= self.last_epoch)
        return self.base_lr * (self.gamma**passed)


class StepLR(_Scheduler):
    def __init__(self, optimizer, step_size, gamma=0.1, **kwargs):
        super().__init__(optimizer)
        self.step_size = step_size
        self.gamma = gamma

    def get_lr(self):
        return self.base_lr * (self.gamma ** (self.last_epoch // self.step_size))


class ExponentialLR(_Scheduler):
    def __init__(self, optimizer, gamma, **kwargs):
        super().__init__(optimizer)
        self.gamma = gamma

    def get_lr(self):
        return self.base_lr * (self.gamma**self.last_epoch)


class CosineAnnealingLR(_Scheduler):
    def __init__(self, optimizer, T_max, eta_min=0.0, **kwargs):
        super().__init__(optimizer)
        self.T_max = T_max
        self.eta_min = eta_min

    def get_lr(self):
        return self.eta_min + (self.base_lr - self.eta_min) * (1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2


class ConstantLR(_Scheduler):
    def __init__(self, optimizer, factor=1.0 / 3, total_iters=5, **kwargs):
        super().__init__(optimizer)
        self.factor = factor
        self.total_iters = total_iters

    def get_lr(self):
        return self.base_lr * (self.factor if self.last_epoch < self.total_iters else 1.0)


def _compile_lr_expression(expr: str):
    """Compiles a YAML `lr_lambda` expression (e.g. "0.95 ** epoch") after
    checking its AST against an arithmetic-only allowlist: `epoch`, `math.*`
    and min/max/abs/round, never arbitrary code."""
    tree = ast.parse(expr, mode="eval")
    for node in ast.walk(tree):
        if isinstance(node, (ast.Expression, ast.Constant, ast.Load, ast.Call, ast.BinOp, ast.UnaryOp, ast.IfExp,
                             ast.Compare, ast.operator, ast.unaryop, ast.cmpop)):
            continue
        if isinstance(node, ast.Name) and node.id in ("epoch", "math", "min", "max", "abs", "round"):
            continue
        if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) and node.value.id == "math"
                and not node.attr.startswith("_")):
            continue
        raise ValueError(f"unsupported element in lr_lambda expression {expr!r}: {ast.dump(node)[:60]}")
    code = compile(tree, "<lr_lambda>", "eval")
    env = {"__builtins__": {}, "math": math, "min": min, "max": max, "abs": abs, "round": round}
    return lambda epoch: eval(code, env, {"epoch": epoch})  # noqa: S307 -- AST-checked above


class LambdaLR(_Scheduler):
    """`lr_lambda` is a callable or, in YAML, an arithmetic string in `epoch`
    (`_compile_lr_expression`)."""

    def __init__(self, optimizer, lr_lambda, **kwargs):
        super().__init__(optimizer)
        if isinstance(lr_lambda, str):
            lr_lambda = _compile_lr_expression(lr_lambda)
        self.lr_lambda = lr_lambda

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)


class LinearLR(_Scheduler):
    """The lr factor moves linearly from start_factor to end_factor over
    total_iters epochs."""

    def __init__(self, optimizer, start_factor=1.0 / 3, end_factor=1.0, total_iters=5, **kwargs):
        super().__init__(optimizer)
        self.start_factor = start_factor
        self.end_factor = end_factor
        self.total_iters = total_iters

    def get_lr(self):
        progress = min(self.last_epoch, self.total_iters) / self.total_iters
        return self.base_lr * (self.start_factor + (self.end_factor - self.start_factor) * progress)


class PolynomialLR(_Scheduler):
    """Polynomial decay to zero over total_iters epochs."""

    def __init__(self, optimizer, total_iters=5, power=1.0, **kwargs):
        super().__init__(optimizer)
        self.total_iters = total_iters
        self.power = power

    def get_lr(self):
        progress = min(self.last_epoch, self.total_iters) / self.total_iters
        return self.base_lr * (1.0 - progress) ** self.power


class CosineAnnealingWarmRestarts(_Scheduler):
    """Cosine annealing restarted every T_0 * T_mult^k epochs."""

    def __init__(self, optimizer, T_0, T_mult=1, eta_min=0.0, **kwargs):
        super().__init__(optimizer)
        assert T_0 > 0 and T_mult >= 1
        self.T_0 = T_0
        self.T_mult = T_mult
        self.eta_min = eta_min

    def get_lr(self):
        epoch = self.last_epoch
        if self.T_mult == 1:
            t_i, t_cur = self.T_0, epoch % self.T_0
        else:
            n = int(math.log(epoch / self.T_0 * (self.T_mult - 1) + 1, self.T_mult)) if epoch >= self.T_0 else 0
            t_i = self.T_0 * self.T_mult**n
            t_cur = epoch - self.T_0 * (self.T_mult**n - 1) // (self.T_mult - 1)
        return self.eta_min + (self.base_lr - self.eta_min) * (1 + math.cos(math.pi * t_cur / t_i)) / 2


class OneCycleLR(_Scheduler):
    """max_lr / div_factor up to max_lr over the first pct_start of
    total_steps, then down to max_lr / (div_factor * final_div_factor); the
    lr alone, Adam's betas are not cycled. `three_phase` is refused."""

    def __init__(self, optimizer, max_lr, total_steps, pct_start=0.3, anneal_strategy="cos", div_factor=25.0,
                 final_div_factor=1e4, **kwargs):
        super().__init__(optimizer)
        assert anneal_strategy in ("cos", "linear")
        if kwargs.get("three_phase"):
            raise ValueError("OneCycleLR three_phase=True is not implemented; use the default two-phase schedule")
        self.max_lr = max_lr
        self.total_steps = total_steps
        self.pct_start = pct_start
        self.anneal_strategy = anneal_strategy
        self.initial_lr = max_lr / div_factor
        self.min_lr = self.initial_lr / final_div_factor

    def _anneal(self, start, end, pct):
        if self.anneal_strategy == "cos":
            return end + (start - end) * (1 + math.cos(math.pi * pct)) / 2
        return start + (end - start) * pct

    def get_lr(self):
        # two phases over a (total_steps - 1) step grid, the peak at
        # pct_start * total_steps - 1
        step = min(self.last_epoch, self.total_steps - 1)
        peak = self.pct_start * self.total_steps - 1
        if step <= peak:
            return self._anneal(self.initial_lr, self.max_lr, step / max(peak, 1e-12))
        pct = (step - peak) / max(self.total_steps - 1 - peak, 1e-12)
        return self._anneal(self.max_lr, self.min_lr, pct)


def _plateau(optimizer, **config):
    """torch's ReduceLROnPlateau with the JAX class's arguments and defaults
    (torch's are the same); the JAX class swallows other keys too."""
    defaults = {"mode": "min", "factor": 0.1, "patience": 10, "threshold": 1e-4, "threshold_mode": "rel",
                "cooldown": 0, "min_lr": 0.0, "eps": 1e-8}
    ignored = sorted(set(config) - set(defaults))
    if ignored:
        logger.warning(f"ReduceLROnPlateau ignores the config keys {ignored}")
    return torch.optim.lr_scheduler.ReduceLROnPlateau(
        optimizer, **{key: config.get(key, value) for key, value in defaults.items()})


_SCHEDULERS = {
    "ReduceLROnPlateau": _plateau,
    "MultiStepLR": MultiStepLR,
    "StepLR": StepLR,
    "ExponentialLR": ExponentialLR,
    "CosineAnnealingLR": CosineAnnealingLR,
    "CosineAnnealingWarmRestarts": CosineAnnealingWarmRestarts,
    "ConstantLR": ConstantLR,
    "LinearLR": LinearLR,
    "PolynomialLR": PolynomialLR,
    "OneCycleLR": OneCycleLR,
    "LambdaLR": LambdaLR,
}


def create_lr_scheduler(lr_config: dict | None, optimizer: torch.optim.Optimizer):
    """Builds the scheduler named by config['lr_scheduler'], or None. A
    schedule of the epoch count writes its epoch-0 lr at once, as torch's
    constructors do (e.g. ConstantLR scales the whole first epoch)."""
    if lr_config is None:
        return None
    lr_config = dict(lr_config)
    name = lr_config.pop("name")
    factory = _SCHEDULERS.get(name)
    if factory is None:
        raise RuntimeError(f"Unsupported lr scheduler: '{name}'. Supported names: {sorted(_SCHEDULERS)}")
    scheduler = factory(optimizer, **lr_config)
    if isinstance(scheduler, _Scheduler):
        scheduler._set_lr(scheduler.get_lr())
    return scheduler


def is_plateau(scheduler) -> bool:
    """Whether `scheduler` steps on the validation score (ReduceLROnPlateau)."""
    return isinstance(scheduler, torch.optim.lr_scheduler.ReduceLROnPlateau)
