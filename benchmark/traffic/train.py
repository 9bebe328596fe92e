"""Traffic `train`: the trainer's own loop, `create_trainer(config,
loaders=...)` and `UNetTrainer.fit`, on a pool of distinct batches made from
the seed and cycled: each update uploads its batch (`_prepare_batch`), runs
the train step and steps the optimizer, as a training run does between its
validations.

Cell parameters: `recipe` (the configuration's section: model dtype, loss,
optimizer, scheduler, metric, trainer keys, patch, batch), `pool` (batches),
`cells` (Voronoi cells a batch), `checked_steps` (the first updates the check
follows, 3).

Set-up builds the trainer, loads the seeded weights and runs the first
`checked_steps` updates through `fit` on batches 0, 1, 2 (they build the step
and warm every shape up). The window runs `fit` again on the same trainer,
with the same feed, until `--seconds` have passed; it ends when the last
update has been read. Its rate is the patch voxels of its updates over all of
its time.

The check follows those first updates with the plain step (reference/: the
model in float32, the recipe's loss and optimizer, each found by its name)
from the same weights on the same batches, and compares: the first step's
logits (`logit_gap`, the widest gap over the reference's largest logit) and
loss (`first_loss_gap`, the gap over the reference's loss; the later steps'
are printed, and not compared); the norm of each parameter's first gradient
as the optimizer took it, read back from Adam's first moment after one
update (`grad_gap`, the worst parameter; the median one is printed); and the
norm of each parameter's change over the updates (`change_gap`, the worst
parameter). Each of the last two is the distance between the program's norm
and the reference's, over the larger of the reference's norm and its median
over the parameters. A parameter whose reference gradient is under a
thousandth of the median's is left out of `change_gap`: Adam moves it by its
rounding alone.
"""

import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from benchmark import roofline, seeded
from benchmark.harness import Window
from benchmark.reference import losses, models, optimizers
from benchmark.traffic.sweep import recipe_model


class Feed:
    """The train loader: the pool's batches in turn, for as long as `more(i)`
    allows the i-th; `more` also takes the snapshots between updates."""

    def __init__(self, batches, more):
        self.batches, self.more = batches, more
        self.yielded = 0

    def __iter__(self):
        while self.more(self.yielded):
            batch = self.batches[self.yielded % len(self.batches)]
            self.yielded += 1
            yield batch


@dataclass
class State:
    recipe: dict
    model_cfg: dict
    params: dict
    batches: list
    trainer: object
    device: object
    steps: int
    checkpoint_dir: str
    losses: list = field(default_factory=list)
    first_logits: torch.Tensor = None
    first_moment: dict = field(default_factory=dict)
    after: dict = field(default_factory=dict)


def _epoch(trainer, feed):
    """One `fit` over the feed: one epoch, ended when the feed stops."""
    trainer.loaders["train"] = feed
    trainer.max_num_epochs = trainer.num_epochs + 1
    trainer.fit()


def setup(cell, config, seed, device, tracer) -> State:
    from pytorch3dunet_tpu_torch.config import resolve_device
    from pytorch3dunet_tpu_torch.trainer import create_trainer

    recipe = config[cell["recipe"]]
    tracer.note("imported")
    device = resolve_device(str(device))
    params = seeded.weights(config["model"], seed, device)
    patch = tuple(recipe["patch_shape"])
    batches = seeded.batches(patch, int(cell["pool"]), seed, device, int(cell.get("cells", 60)))
    tracer.note("weights and batches")
    if recipe.get("batch_size", 1) != 1:
        raise ValueError("the train traffic feeds batches of one patch")
    model_cfg = recipe_model(config, recipe)
    checkpoint_dir = tempfile.mkdtemp()
    run_config = {"model": model_cfg, "device": device.type,
                  "trainer": {**recipe["trainer"], "checkpoint_dir": checkpoint_dir}}
    for key in ("loss", "optimizer", "eval_metric", "lr_scheduler"):
        run_config[key] = recipe[key]
    run_config["loaders"] = {"device_augment": bool(recipe.get("device_augment", False))}
    trainer = create_trainer(run_config, loaders={"train": [], "val": batches[:1]})
    trainer.model.load_state_dict(params, strict=True)
    tracer.note("trainer")
    state = State(recipe, model_cfg, params, batches, trainer, device, int(cell.get("checked_steps", 3)),
                  checkpoint_dir)

    criterion = trainer.loss_criterion

    def recording(logits, target):
        loss = criterion(logits, target)
        if len(state.losses) < state.steps and torch.is_grad_enabled():
            if not state.losses:
                state.first_logits = logits.detach().float().clone()
            state.losses.append(loss.detach())
        return loss

    trainer.loss_criterion = recording
    names = [name for name, _ in trainer.model.named_parameters()]

    def more(i):
        if i == 1:
            # after the first update: Adam's first moment holds (1 - beta1) * its gradient (none: no update)
            opt = trainer.optimizer
            state.first_moment = {n: opt.state[p]["exp_avg"].detach().clone() if "exp_avg" in opt.state[p]
                                  else torch.zeros_like(p) for n, p in zip(names, trainer.model.parameters())}
        return i < state.steps

    _epoch(trainer, Feed(batches, more))
    state.after = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    tracer.note("first updates")
    return state


def window(state: State, seconds: float, tracer, sync) -> Window:
    trainer = state.trainer
    prepare = trainer._prepare_batch

    def prepare_traced(*args, **kwargs):
        with tracer.range("train.prepare_batch"):
            return prepare(*args, **kwargs)

    trainer._prepare_batch = prepare_traced
    tracer.hook_model(trainer.model)
    deadline = None

    def more(i):
        return i == 0 or time.perf_counter() < deadline

    feed = Feed(state.batches[state.steps:] + state.batches[:state.steps], more)
    tracer.start()
    deadline = time.perf_counter() + seconds
    with tracer.range("train.fit"):
        _epoch(trainer, feed)
    elapsed = tracer.stop(sync)
    trainer._prepare_batch = prepare
    patch = tuple(state.recipe["patch_shape"])
    updates = feed.yielded
    work = roofline.conv_work(state.model_cfg, patch, state.recipe.get("dtype"), train=True)
    vox = updates * int(np.prod(patch))
    return Window("train", updates, 0, {"train_vox_s": (vox / elapsed / 1e6, "Mvox/s")}, work=work)


@dataclass
class Steps:
    """What the check reads of the first updates: each step's loss, the first
    step's logits, the first gradients as Adam took them, and the parameters
    after the updates."""
    losses: list
    logits: torch.Tensor
    first_grad: dict
    after: dict


def _norms(tensors: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def norm_gaps(program: dict, reference: dict, keys) -> dict:
    """| |program| - |reference| | / max(|reference|, median |reference|) of each of `keys`."""
    p, r = _norms(program), _norms(reference)
    median = float(np.median([r[k] for k in reference]))
    return {k: abs(p[k] - r[k]) / max(r[k], median) for k in keys}


def worst(gaps: dict, what: str, top: int = 3) -> tuple[float, float]:
    """The largest gap and the median one; the `top` largest and the median on standard error."""
    for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]:
        print(f"check: {what} {v:.4e} {k}", file=sys.stderr)
    median = float(np.median(list(gaps.values())))
    print(f"check: {what} median leaf {median:.4e}", file=sys.stderr)
    return max(gaps.values()), median


def reference_steps(state: State, quantize=None, fault: str | None = None) -> Steps:
    """The plain float32 updates from the seeded weights on the same batches
    (`quantize`: the control's rounding of the conv operands; `fault`: one of
    the faults a run can have, planted in the reference put in the
    program's place: 'half_batch' takes the loss over the first half of each
    batch's depth, the forward whole; 'altered_update' triples one
    parameter's gradient)."""
    recipe, device = state.recipe, state.device
    model_cfg = dict(state.model_cfg, dtype=None)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in state.params.items()}
    opt = optimizers.optimizer(params, recipe["optimizer"])
    criterion = losses.criterion(recipe["loss"])
    step_losses, first, first_logits = [], None, None
    for raw, target in state.batches[:state.steps]:
        x = torch.from_numpy(raw).to(device)
        t = torch.from_numpy(target).to(device)
        _, logits = models.forward(params, x, model_cfg, quantize)
        if fault == "half_batch":
            half = logits.shape[2] // 2
            loss = criterion(logits[:, :, :half], t[:, :, :half])
        else:
            loss = criterion(logits, t)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        if fault == "altered_update":
            last = list(grads)[-1]
            grads[last] = 3.0 * grads[last]
        taken = opt.step(grads)
        step_losses.append(float(loss.detach()))
        if first is None:
            first = {k: v.detach().clone() for k, v in taken.items()}
            first_logits = logits.detach().clone()
    return Steps(step_losses, first_logits, first, {k: v.detach() for k, v in params.items()})


def compare(state: State, got: Steps, ref: Steps) -> dict:
    """The numbers of the check, the program's (or the control's) readings against the reference's:
    `logit_gap` (the first step's widest logit gap over the reference's largest logit), `first_loss_gap`
    (the first step's loss gap over the reference's loss), `grad_gap`, `change_gap`. The later steps'
    loss gaps and the median parameter's gradient gap are printed, not compared: no control or fault
    reads ten times what a sound bf16 run does there (PERF.md)."""
    if len(got.losses) == len(ref.losses):
        loss_gaps = [abs(a - b) / abs(b) for a, b in zip(got.losses, ref.losses)]
    else:
        loss_gaps = [float("inf")]
    for step, gap in enumerate(loss_gaps[1:], 2):
        print(f"check: loss_gap step {step} {gap:.4e} (not compared)", file=sys.stderr)
    if got.logits is None or got.logits.shape != ref.logits.shape:
        logit_gap = float("inf")
    else:
        logit_gap = float((got.logits.float() - ref.logits).abs().max() / ref.logits.abs().max())
    grad_gap, grad_median_gap = worst(norm_gaps(got.first_grad, ref.first_grad, ref.first_grad), "grad_gap")
    print(f"check: grad_median_gap {grad_median_gap:.4e} (not compared)", file=sys.stderr)
    ref_g = _norms(ref.first_grad)
    median_g = float(np.median(list(ref_g.values())))
    moved = [k for k in ref.first_grad if ref_g[k] >= 1e-3 * median_g]
    change = {k: got.after[k] - state.params[k] for k in moved}
    ref_change = {k: ref.after[k] - state.params[k] for k in ref.after}
    change_gap, _ = worst(norm_gaps(change, ref_change, moved), "change_gap")
    return {"logit_gap": logit_gap, "first_loss_gap": loss_gaps[0], "grad_gap": grad_gap, "change_gap": change_gap}


def check(state: State, window: Window, limits: dict) -> dict:
    beta1 = tuple(state.recipe["optimizer"].get("betas", (0.9, 0.999)))[0]
    got = Steps([float(v) for v in state.losses], state.first_logits,
                {k: v / (1 - beta1) for k, v in state.first_moment.items()}, state.after)
    state.trainer = None
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    numbers = compare(state, got, reference_steps(state))
    shutil.rmtree(state.checkpoint_dir, ignore_errors=True)
    return {name: (value, float(limits.get(name, 0.0))) for name, value in numbers.items()}
