"""Iteration-driven trainer of the port (pytorch3dunet_tpu/trainer.py without jax).

The workflow of the JAX trainer and of the reference pytorch-3dunet
UNetTrainer: epochs counted in iterations, a step of forward, loss on the
logits, `zero_grad` / `backward` / `step`; validation every
`validate_after_iters` under `torch.no_grad()`, scored by the metric's device
twin where it has one (Dice, MeanIoU, MSE, PSNR) and by the host numpy metric
of `metrics.py` otherwise; ReduceLROnPlateau stepped on the eval score; last/best checkpoints;
stop at `max_num_iterations` or when the lr falls below 1e-6; `resume` and
`pre_trained`.

On CUDA every 3x3x3 conv of the step runs on the hand-written kernels
(ops/conv3d.py): the forward on K2 (on K1 for F >= 64 under
P3DUNET_TAPFOLD=1), the input gradient on K3.

With `loaders.device_augment: true` the movable transforms of the train
pipeline and its label engineering leave the host loaders
(`ops.augment.split_device_transforms`) and run on each uploaded train batch
before the forward (`ops.augment.DeviceAugmenter`), drawn from two generators
seeded from `manual_seed`: scalars from a CPU one, fields from one on the
device. A resumed run starts them afresh. With `model.dtype: bfloat16` the
model computes in bf16 (models/unet.py) while the parameters, their gradients,
Adam's moments and the checkpoints stay float32; validation runs the same
bf16 model.

A 2D model (UNet2D, ResidualUNet2D) trains on the (N, C, 1, H, W) batches of
depth-1 patches: each batch loses its singleton z after the device
augmentation and before the forward, and the host metric gets it back
(JAX trainer.py:454-465, metrics.py `to_metric_layout`).

Not ported yet, and refused when a config asks for them: gradient
accumulation, EMA weights, `resume: auto`, profiler traces and parameter
histograms (ROADMAP Queue 1, "Trainer breadth") and spatial sharding
("Parallelism"). TensorBoard is "Trainer breadth" too: scalars go to the log.
Checkpoints are written synchronously, so `async_checkpoint` and `async_steps`
change nothing but timing and are only logged.
"""

import copy
import os
from datetime import datetime

import numpy as np
import torch

from pytorch3dunet_tpu_torch.metrics import device_metric_fn, get_evaluation_metric
from pytorch3dunet_tpu_torch.utils.misc import (ITEM_PARALLELISM, ITEM_TRAINER, RunningAverage, get_logger,
                                                not_ported, roadmap)
from pytorch3dunet_tpu_torch.config import resolve_device
from pytorch3dunet_tpu_torch.datasets.utils import get_train_loaders
from pytorch3dunet_tpu_torch.losses import get_loss_criterion
from pytorch3dunet_tpu_torch.models.unet import get_model, is_model_2d
from pytorch3dunet_tpu_torch.ops.augment import DeviceAugmenter, split_device_transforms
from pytorch3dunet_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from pytorch3dunet_tpu_torch.utils.optim import create_lr_scheduler, create_optimizer

logger = get_logger("UNetTrainer")


def create_trainer(config: dict, loaders: dict | None = None) -> "UNetTrainer":
    """Builds a UNetTrainer from a full config dict. `loaders` ({'train': ...,
    'val': ...}, each an iterable of (raw, target) NCDHW numpy batches) replaces
    the HDF5 loaders of config['loaders']; with `device_augment` the train
    batches must then be what the stripped host pipeline yields.

    With `manual_seed`, torch's global RNG is seeded before the model is built
    (its weight init) and an explicit generator seeded from it draws the
    train loader's shuffle seed, then the device augmentation's seed."""
    seed = config.get("manual_seed", None)
    generator = torch.Generator()
    if seed is not None:
        torch.manual_seed(seed)
        generator.manual_seed(seed)
    else:
        generator.seed()

    device = resolve_device(config.get("device", None))
    logger.info(f"Using device: {device}")
    model = get_model(config["model"]).to(device)

    loss_criterion = get_loss_criterion(config)
    eval_criterion = get_evaluation_metric(config)
    # the spec comes from the config (a copy: the caller's dict stays whole),
    # before the loaders are built from what it leaves on the host
    if "loaders" in config:
        config = dict(config, loaders=copy.deepcopy(config["loaders"]))
    spec = split_device_transforms(config.get("loaders", {}))
    if loaders is None:
        loaders = get_train_loaders(config, seed=int(torch.randint(0, 2**31 - 1, (), generator=generator)))
    augment = {}
    if spec is not None:
        post = spec["label_post"]
        logger.info(f"Device augmentation: {len(spec['paired'])} paired + {len(spec['raw_only'])} raw-only "
                    "transforms moved on-device" + (f" + label engineering ({post['name']})" if post else ""))
        augment = {"device_augmenter": DeviceAugmenter(spec),
                   "augment_seed": int(torch.randint(0, 2**31 - 2, (), generator=generator))}
    optimizer = create_optimizer(config["optimizer"], model)
    lr_scheduler = create_lr_scheduler(config.get("lr_scheduler", None), optimizer)

    trainer_config = dict(config["trainer"])
    if trainer_config.pop("tensorboard_formatter", None) is not None:
        logger.info(f"trainer.tensorboard_formatter: TensorBoard is not ported yet ({roadmap(ITEM_TRAINER)}); "
                    "scalars go to the log")
    return UNetTrainer(model=model, optimizer=optimizer, lr_scheduler=lr_scheduler, loss_criterion=loss_criterion,
                       eval_criterion=eval_criterion, loaders=loaders, device=device, **augment, **trainer_config)


def _refuse_unported(grad_accum_steps, ema_decay, resume, profile_dir, log_params, spatial_sharding):
    """Raises for the trainer options whose results or files the port does not produce yet."""
    refused = {
        "grad_accum_steps": (int(grad_accum_steps) > 1, ITEM_TRAINER),
        "ema_decay": (ema_decay is not None, ITEM_TRAINER),
        "resume": (resume == "auto", ITEM_TRAINER),
        "profile_dir": (bool(profile_dir), ITEM_TRAINER),
        "log_params": (bool(log_params), ITEM_TRAINER),
        "spatial_sharding": (bool(spatial_sharding), ITEM_PARALLELISM),
    }
    for key, (is_set, item) in refused.items():
        if is_set:
            raise not_ported(f"trainer.{key}", item)


class UNetTrainer:
    """Trains a UNet3D (see the module docstring). Arguments follow the JAX
    UNetTrainer, with the torch optimizer and scheduler in place of their
    configs."""

    def __init__(self, model, optimizer, lr_scheduler, loss_criterion, eval_criterion, loaders, checkpoint_dir,
                 max_num_epochs, max_num_iterations, validate_after_iters=200, log_after_iters=100,
                 validate_iters=None, num_iterations=1, num_epoch=0, eval_score_higher_is_better=True,
                 skip_train_validation=False, resume=None, pre_trained=None, max_val_images=100, device=None,
                 profile_dir=None, log_params=False, spatial_sharding=False, async_steps=8, grad_accum_steps=1,
                 ema_decay=None, async_checkpoint=True, device_augmenter=None, augment_seed=None):
        _refuse_unported(grad_accum_steps, ema_decay, resume, profile_dir, log_params, spatial_sharding)
        logger.info(f"trainer.async_checkpoint={async_checkpoint}, async_steps={async_steps}: timing only; "
                    f"the port saves synchronously and reads every step's loss; "
                    f"max_val_images={max_val_images} applies to TensorBoard images, not ported yet")
        self.model = model
        self.optimizer = optimizer
        self.scheduler = lr_scheduler
        self.loss_criterion = loss_criterion
        self.eval_criterion = eval_criterion
        self.loaders = loaders
        self.checkpoint_dir = checkpoint_dir
        self.max_num_epochs = max_num_epochs
        self.max_num_iterations = max_num_iterations
        self.validate_after_iters = validate_after_iters
        self.log_after_iters = log_after_iters
        self.validate_iters = validate_iters
        self.eval_score_higher_is_better = eval_score_higher_is_better
        self.skip_train_validation = skip_train_validation
        self.device = resolve_device(device)
        self.num_iterations = num_iterations
        self.num_epochs = num_epoch
        self.device_augmenter = device_augmenter
        self.device_metric = device_metric_fn(eval_criterion)
        where = "on the device (2 scalars per batch read after the loop)" if self.device_metric else \
            "on the host (each batch's probabilities are downloaded)"
        logger.info(f"Validation metric {type(eval_criterion).__name__} runs {where}")
        if device_augmenter is not None:
            # (host generator of the scalar draws, device generator of the fields)
            self.augment_generators = (torch.Generator(), torch.Generator(device=self.device))
            for i, gen in enumerate(self.augment_generators):
                if augment_seed is None:
                    gen.seed()
                else:
                    gen.manual_seed(augment_seed + i)

        logger.info(f"eval_score_higher_is_better: {eval_score_higher_is_better}")
        self.best_eval_score = float("-inf") if eval_score_higher_is_better else float("+inf")

        if resume is not None:
            logger.info(f"Loading checkpoint '{resume}'...")
            state = load_checkpoint(resume)
            self.model.load_state_dict(state["model_state_dict"], strict=True)
            if state.get("optimizer_state_dict") is not None:
                self.optimizer.load_state_dict(state["optimizer_state_dict"])
            else:
                logger.warning("Checkpoint has no optimizer state; the optimizer starts fresh")
            if state.get("best_eval_score") is not None:
                self.best_eval_score = state["best_eval_score"]
            self.num_iterations = state["num_iterations"]
            self.num_epochs = state["num_epochs"]
            self.checkpoint_dir = os.path.split(resume)[0]
            logger.info(f"Checkpoint loaded from '{resume}'. Epoch: {self.num_epochs}. "
                        f"Iteration: {self.num_iterations}. Best val score: {self.best_eval_score}.")
        elif pre_trained is not None:
            logger.info(f"Loading pre-trained model from '{pre_trained}'...")
            state = load_checkpoint(pre_trained)
            self.model.load_state_dict(state.get("model_state_dict", state), strict=True)
            if not self.checkpoint_dir:
                self.checkpoint_dir = os.path.split(pre_trained)[0]

        # the run directory that copy_config writes the config into (the JAX
        # trainer's TensorBoard run directory)
        os.makedirs(os.path.join(self.checkpoint_dir, "logs", datetime.now().strftime("%Y-%m-%d_%H-%M-%S")),
                    exist_ok=True)
        n_params = sum(p.numel() for p in self.model.parameters() if p.requires_grad)
        logger.info(f"Number of learnable params {n_params}")

    def fit(self):
        try:
            for _ in range(self.num_epochs, self.max_num_epochs):
                if self.train():
                    logger.info("Stopping criterion is satisfied. Finishing training")
                    return
                self.num_epochs += 1
            logger.info(f"Reached maximum number of epochs: {self.max_num_epochs}. Finishing training...")
        except KeyboardInterrupt:
            # persist progress so that the run can resume
            logger.info("Interrupted: saving checkpoint before exiting")
            self._save_checkpoint(is_best=False)
            raise

    def _prepare_batch(self, raw, target, augment: bool = False):
        """An NCDHW loader batch on the device. A train batch (`augment`) goes
        through the device augmenter, a target without a channel axis with one
        added for it and taken away after; then a 2D model's batch loses its
        singleton z (JAX trainer.py:440-465)."""
        inp = torch.as_tensor(np.asarray(raw)).to(self.device)
        target = torch.as_tensor(np.asarray(target)).to(self.device)
        has_channel = target.ndim == inp.ndim
        if augment and self.device_augmenter is not None:
            inp, target = self.device_augmenter(inp, target if has_channel else target[:, None],
                                                self.augment_generators)
            target = target if has_channel else target[:, 0]
        if is_model_2d(self.model):
            if inp.shape[2] != 1:
                raise ValueError(f"a 2D model trains on patches of depth 1, got a batch of shape {tuple(inp.shape)}")
            inp, target = inp[:, :, 0], target[:, :, 0] if has_channel else target[:, 0]
        return inp, target

    def _metric_layout(self, probs, target):
        """(probabilities, target) as the host metrics take them: NCDHW numpy,
        a 2D model's with their singleton z back (JAX metrics.py
        `to_metric_layout`)."""
        probs, target = probs.detach().cpu().numpy(), target.cpu().numpy()
        if is_model_2d(self.model):
            target = target[:, :, None] if target.ndim == probs.ndim else target[:, None]
            probs = probs[:, :, None]
        return probs, target

    def train(self):
        """Trains for one epoch; returns True when training should stop now."""
        train_losses = RunningAverage()
        train_eval_scores = RunningAverage()
        self.model.train()
        train_loader = self.loaders["train"]
        if hasattr(train_loader, "set_epoch"):
            # epoch-keyed shuffle: a resumed run replays this epoch's batch order
            train_loader.set_epoch(self.num_epochs)

        for raw, target in train_loader:
            logger.info(f"Training iteration [{self.num_iterations}/{self.max_num_iterations}]. "
                        f"Epoch [{self.num_epochs}/{self.max_num_epochs - 1}]")
            inp, target = self._prepare_batch(raw, target, augment=True)
            probs, logits = self.model(inp)
            loss = self.loss_criterion(logits, target)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            self.optimizer.step()
            batch_size = inp.shape[0]
            train_losses.update(loss.item(), batch_size)

            if self.num_iterations % self.validate_after_iters == 0:
                eval_score = self.validate()
                if self.scheduler is not None:
                    self.scheduler.step(eval_score)
                logger.info(f"learning_rate={self.optimizer.param_groups[0]['lr']} at {self.num_iterations}")
                self._save_checkpoint(self._is_best_eval_score(eval_score))

            if self.num_iterations % self.log_after_iters == 0:
                if not self.skip_train_validation:
                    # the target the network saw: after device augmentation
                    # the host batch is the one before it
                    score = self.eval_criterion(*self._metric_layout(probs, target))
                    train_eval_scores.update(float(score), batch_size)
                logger.info(f"Training stats. Loss: {train_losses.avg}. Evaluation score: {train_eval_scores.avg}")
                self._log_stats("train", train_losses.avg, train_eval_scores.avg)

            if self.should_stop():
                return True
            self.num_iterations += 1
        return False

    def should_stop(self) -> bool:
        """Stop when max iterations are exceeded or the lr decayed below 1e-6."""
        if self.max_num_iterations < self.num_iterations:
            logger.info(f"Maximum number of iterations {self.max_num_iterations} exceeded.")
            return True
        min_lr = 1e-6
        if self.optimizer.param_groups[0]["lr"] < min_lr:
            logger.info(f"Learning rate below the minimum {min_lr}.")
            return True
        return False

    def validate(self) -> float:
        """Loss and eval score averaged over the validation batches. With a
        device twin of the eval metric (`metrics.device_metric_fn`) both stay
        0-d device tensors until the loop has ended, so the loop makes no host
        sync (JAX trainer.py `validate`); otherwise each batch's probabilities
        go to the host metric."""
        logger.info("Validating...")
        pending = []
        self.model.eval()
        try:
            with torch.no_grad():
                for i, (raw, target) in enumerate(self.loaders["val"]):
                    inp, target = self._prepare_batch(raw, target)
                    probs, logits = self.model(inp)
                    loss = self.loss_criterion(logits, target)
                    if self.device_metric is not None:
                        score = self.device_metric(probs, target)
                    else:
                        score = float(self.eval_criterion(*self._metric_layout(probs, target)))
                    pending.append((loss, score, inp.shape[0]))
                    if self.validate_iters is not None and self.validate_iters <= i:
                        break
        finally:
            self.model.train()
        val_losses, val_scores = self._averages(pending)
        logger.info(f"Validation finished. Loss: {val_losses.avg}. Evaluation score: {val_scores.avg}")
        self._log_stats("val", val_losses.avg, val_scores.avg)
        return val_scores.avg

    @staticmethod
    def _averages(pending):
        """RunningAverages of the (loss, score, batch size) triples, read on the host."""
        losses, scores = RunningAverage(), RunningAverage()
        for loss, score, batch_size in pending:
            losses.update(float(loss), batch_size)
            scores.update(float(score), batch_size)
        return losses, scores

    def _is_best_eval_score(self, eval_score: float) -> bool:
        if self.eval_score_higher_is_better:
            is_best = eval_score > self.best_eval_score
        else:
            is_best = eval_score < self.best_eval_score
        if is_best:
            logger.info(f"Saving new best evaluation metric: {eval_score}")
            self.best_eval_score = eval_score
        return is_best

    def _save_checkpoint(self, is_best: bool):
        path = os.path.join(self.checkpoint_dir, "last_checkpoint.pytorch")
        logger.info(f"Saving checkpoint to '{path}'")
        save_checkpoint({
            "num_epochs": self.num_epochs + 1,
            # the save runs after this iteration's update, so the next
            # iteration is the resume point (as in the JAX trainer)
            "num_iterations": self.num_iterations + 1,
            "model_state_dict": {k: v.detach().cpu() for k, v in self.model.state_dict().items()},
            "optimizer_state_dict": self.optimizer.state_dict(),
            "best_eval_score": float(self.best_eval_score),
        }, is_best, checkpoint_dir=self.checkpoint_dir)

    def _log_stats(self, phase: str, loss_avg: float, eval_score_avg: float):
        logger.info(f"{phase}_loss_avg={loss_avg} {phase}_eval_score_avg={eval_score_avg} "
                    f"at iteration {self.num_iterations}")
