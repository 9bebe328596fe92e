"""Iteration-driven trainer of the port (pytorch3dunet_tpu/trainer.py without jax).

The workflow of the JAX trainer and of the reference pytorch-3dunet
UNetTrainer: epochs counted in iterations, an update of forward, loss on the
logits, `zero_grad` / `backward` / `step`; validation every
`validate_after_iters` under `torch.no_grad()`, scored by the metric's device
twin where it has one (Dice, MeanIoU, MSE, PSNR) and by the host numpy metric
of `metrics.py` otherwise; the lr scheduler stepped at each validation (the
plateau one on the eval score); last/best checkpoints; stop at
`max_num_iterations` or when the lr falls below 1e-6; `resume` (a path, or
`auto`: `<checkpoint_dir>/last_checkpoint.pytorch` when it exists) and
`pre_trained` (a port or reference torch checkpoint, or a JAX npz, whose raw
`model_state_dict` it takes).

On CUDA every 3x3x3 conv of the step runs on the hand-written kernels
(ops/conv3d.py): the forward on K2 (on K1 for F >= 64 under
P3DUNET_TAPFOLD=1), the input gradient on K3.

With `loaders.device_augment: true` the movable transforms of the train
pipeline and its label engineering leave the host loaders
(`ops.augment.split_device_transforms`) and run on each uploaded train batch
before the forward (`ops.augment.DeviceAugmenter`), drawn from two generators
seeded from `manual_seed`: scalars from a CPU one, fields from one on the
device. With `model.dtype: bfloat16` the model computes in bf16
(models/unet.py) while the parameters, their gradients, the optimizer's
moments and the checkpoints stay float32; validation runs the same bf16 model.

The JAX trainer's other options (JAX trainer.py:99-105):
- `grad_accum_steps: k`: k loader batches make one update from the mean of
  their gradients; a trailing group shorter than k is dropped. Losses and
  voxels count per microbatch, logging reads the last one, BatchNorm's running
  statistics move per microbatch; the EMA and the scheduler follow updates.
- `ema_decay: d`: a float32 copy of the parameters, e = d * e + (1 - d) * p
  after each update. Validation, the best checkpoint and the checkpoints'
  `ema_state_dict` use it (BatchNorm buffers stay the live model's); a resume
  restores it.
- TensorBoard (tensorboardX, when installed): the JAX trainer's scalars, images
  and histograms under its tags at its iterations, the images formatted by
  `trainer.tensorboard_formatter` (utils/tb.py).
- Checkpoints carry `torch_rng_state`: torch's CPU RNG, the device's CUDA RNG
  and the augmentation generators. A resume restores them, so its dropout and
  augmentation draws continue the interrupted run's (JAX `rng_state`).
- `async_checkpoint: true` copies the state on the device and writes it on one
  background thread; a save first waits for the one before, and `fit` drains
  the writer.
- `profile_dir`: a `torch.profiler` trace from the first `train()` to the end
  of `fit`. `log_params`: a histogram of each parameter and of its gradient at
  each log iteration.
`async_steps` changes nothing but timing in JAX; the port reads every loss.

A 2D model (UNet2D, ResidualUNet2D) trains on the (N, C, 1, H, W) batches of
depth-1 patches: each batch loses its singleton z after the device
augmentation and before the forward, and the host metric gets it back
(JAX trainer.py:454-465, metrics.py `to_metric_layout`).

With more than one rank (parallel/__init__.py; `train.py` initializes them
from the P3DUNET_* variables):
- data parallel (JAX `choose_data_mesh`): every rank trains on its own part of
  its host's batch; the loss is computed on the logits and targets gathered
  over the ranks (the global batch, as the JAX step over one global array
  sees it), BatchNorm all-reduces its batch moments, and the gradients are
  summed over the ranks (parallel/mesh.py);
- `spatial_sharding: true` (JAX parallel/spatial.py): every rank reads the
  same batch and trains on its D-slab of it, with halo-exchanged convs,
  all-reduced GroupNorm and SE statistics and the loss on the gathered
  logits; the space mesh spans every rank, and a world size the patch depth
  cannot be sharded over raises (ROADMAP F11). Validation runs the same way.
The parameters, buffers and optimizer state are broadcast from rank 0 at the
start and after a resume (from rank 0's file), dropout draws differ per rank,
only rank 0 writes checkpoints, and the other ranks suffix their TensorBoard
run name with `_proc<rank>`. Under `model.remat` the recomputed levels enter
the collectives again in backward, in the same order on every rank.
"""

import contextlib
import copy
import itertools
import os
import time
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime

import numpy as np
import torch

from pytorch3dunet_tpu_torch.metrics import device_metric_fn, get_evaluation_metric
from pytorch3dunet_tpu_torch.utils.misc import RunningAverage, get_logger, span
from pytorch3dunet_tpu_torch.config import resolve_device
from pytorch3dunet_tpu_torch.datasets.utils import get_train_loaders
from pytorch3dunet_tpu_torch.losses import get_loss_criterion
from pytorch3dunet_tpu_torch.models.unet import get_model, is_model_2d
from pytorch3dunet_tpu_torch.ops.augment import DeviceAugmenter, split_device_transforms
from pytorch3dunet_tpu_torch.parallel import distributed
from pytorch3dunet_tpu_torch.parallel.mesh import (choose_data_mesh, data_axis, data_mesh, data_parallel_loss,
                                                   gather, optimizer_state_tensors, replicate, step_fns, train_step)
from pytorch3dunet_tpu_torch.parallel.spatial import (build_spatial_accum_fns, build_spatial_eval_step,
                                                      build_spatial_train_step, choose_space_mesh,
                                                      shard_spatial_batch, spatial_min_local, spatial_pool_d,
                                                      validate_spatial_model)
from pytorch3dunet_tpu_torch.utils.checkpoint import LAST_CHECKPOINT, load_checkpoint, save_checkpoint
from pytorch3dunet_tpu_torch.utils.optim import create_lr_scheduler, create_optimizer, is_plateau
from pytorch3dunet_tpu_torch.utils.tb import TensorboardFormatter, open_writer
from pytorch3dunet_tpu_torch.utils.weights import load_weights

logger = get_logger("UNetTrainer")


def create_trainer(config: dict, loaders: dict | None = None) -> "UNetTrainer":
    """Builds a UNetTrainer from a full config dict. `loaders` ({'train': ...,
    'val': ...}, each an iterable of (raw, target) NCDHW numpy batches) replaces
    the HDF5 loaders of config['loaders']; with `device_augment` the train
    batches must then be what the stripped host pipeline yields.

    With `manual_seed`, torch's global RNG is seeded before the model is built
    (its weight init) and an explicit generator seeded from it draws the
    train loader's shuffle seed, then the device augmentation's seed. With
    more than one rank, rank 0's draw seeds every rank's generator, so the
    ranks of a host shuffle alike and take their parts of one batch order."""
    seed = config.get("manual_seed", None)
    generator = torch.Generator()
    if seed is not None:
        torch.manual_seed(seed)
        generator.manual_seed(seed)
    else:
        generator.manual_seed(distributed.broadcast_object(int(generator.seed())))

    device = distributed.device_for_rank(resolve_device(config.get("device", None)))
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
    formatter = TensorboardFormatter(**(trainer_config.pop("tensorboard_formatter", None) or {}))
    return UNetTrainer(model=model, optimizer=optimizer, lr_scheduler=lr_scheduler, loss_criterion=loss_criterion,
                       eval_criterion=eval_criterion, loaders=loaders, device=device, tensorboard_formatter=formatter,
                       **augment, **trainer_config)




def _map_tensors(obj, fn):
    """`obj` (nested dicts, lists and tuples) with `fn` applied to every tensor."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(v, fn) for v in obj)
    return obj


class UNetTrainer:
    """Trains a UNet3D (see the module docstring). Arguments follow the JAX
    UNetTrainer, with the torch optimizer and scheduler in place of their
    configs."""

    def __init__(self, model, optimizer, lr_scheduler, loss_criterion, eval_criterion, loaders, checkpoint_dir,
                 max_num_epochs, max_num_iterations, validate_after_iters=200, log_after_iters=100,
                 validate_iters=None, num_iterations=1, num_epoch=0, eval_score_higher_is_better=True,
                 tensorboard_formatter=None, skip_train_validation=False, resume=None, pre_trained=None,
                 max_val_images=100, device=None, profile_dir=None, log_params=False, spatial_sharding=False,
                 async_steps=8, grad_accum_steps=1, ema_decay=None, async_checkpoint=True, device_augmenter=None,
                 augment_seed=None):
        if ema_decay is not None and not 0.0 < float(ema_decay) < 1.0:
            raise ValueError(f"trainer.ema_decay must be in (0, 1); got {ema_decay}")
        logger.info(f"trainer.async_steps={async_steps}: timing only; the port reads every step's loss")
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
        self.max_val_images = max_val_images
        self.tensorboard_formatter = tensorboard_formatter or TensorboardFormatter()
        self.device = resolve_device(device)
        self.num_iterations = num_iterations
        self.num_epochs = num_epoch
        self.grad_accum_steps = max(1, int(grad_accum_steps))
        self.ema_decay = None if ema_decay is None else float(ema_decay)
        self.async_checkpoint = bool(async_checkpoint)
        self.profile_dir = profile_dir
        self.log_params = bool(log_params)
        self.device_augmenter = device_augmenter
        self.rank, self.world = distributed.rank(), distributed.world_size()
        self.spatial_sharding = bool(spatial_sharding)
        # the data mesh, or (under spatial_sharding) the space mesh, chosen
        # from the first batch; None on one rank without sharding
        self.mesh = None
        if self.spatial_sharding:
            if is_model_2d(model):
                raise ValueError("spatial_sharding requires a 3D model")
            validate_spatial_model(model)
        # the step functions, built once the mesh is known (JAX
        # `_build_train_step`, `_build_accum_fns`, `_build_eval_step`)
        self._train_fns = None
        self._eval_step = None
        self.device_metric = device_metric_fn(eval_criterion)
        where = "on the device (2 scalars per batch read after the loop)" if self.device_metric else \
            "on the host (each batch's probabilities are downloaded)"
        logger.info(f"Validation metric {type(eval_criterion).__name__} runs {where}")
        if device_augmenter is not None:
            # (host generator of the scalar draws, device generator of the fields)
            self.augment_generators = (torch.Generator(), torch.Generator(device=self.device))
            # data-parallel ranks augment their own samples with their own
            # draws; spatial ranks augment one batch alike
            offset = 0 if self.spatial_sharding else 2 * self.rank
            for i, gen in enumerate(self.augment_generators):
                if augment_seed is None:
                    gen.seed()
                else:
                    gen.manual_seed(augment_seed + offset + i)
        self._profiler = None
        self._ckpt_executor = None
        self._ckpt_future = None
        # the voxels of the updates since the last log, and the time of that log (before the first: of the first
        # update's start): the logged throughput is their quotient
        self._log_voxels, self._log_clock = 0, None

        logger.info(f"eval_score_higher_is_better: {eval_score_higher_is_better}")
        self.best_eval_score = float("-inf") if eval_score_higher_is_better else float("+inf")

        # the TensorBoard run directory, which copy_config writes the config into
        run_name = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        if self.rank != 0:
            # each rank its own run directory; only rank 0 writes checkpoints
            run_name = f"{run_name}_proc{self.rank}"
        run_dir = os.path.join(checkpoint_dir, "logs", run_name)
        os.makedirs(run_dir, exist_ok=True)
        self.writer = open_writer(run_dir)

        if resume == "auto":
            # the same config restarts a killed run without editing the path in and out
            auto_path = os.path.join(checkpoint_dir, LAST_CHECKPOINT)
            resume = auto_path if os.path.exists(auto_path) else None
            logger.info(f"resume: auto -> {'found ' + auto_path if resume else 'no checkpoint, starting fresh'}")
        state = {}
        if resume is not None:
            state = self._load_resume(resume)
        elif pre_trained is not None:
            logger.info(f"Loading pre-trained model from '{pre_trained}'...")
            # the raw weights, as the JAX trainer fine-tunes from model_state_dict
            load_weights(self.model, pre_trained, ema=False)
            if not self.checkpoint_dir:
                self.checkpoint_dir = os.path.split(pre_trained)[0]

        self.ema = None
        if self.ema_decay is not None:
            logger.info(f"EMA of the weights enabled (decay={self.ema_decay}): validation and checkpoints use "
                        "the averaged weights")
            self.ema = [p.detach().float().clone() for p in self.model.parameters()]
            if state.get("ema_state_dict"):
                logger.info("Restoring EMA weights from the checkpoint")
                for (name, _), e in zip(self.model.named_parameters(), self.ema):
                    e.copy_(state["ema_state_dict"][name])
        if state.get("torch_rng_state") is not None:
            self._restore_rng(state["torch_rng_state"])
        if self.world > 1:
            self._replicate_state()

        n_params = sum(p.numel() for p in self.model.parameters() if p.requires_grad)
        logger.info(f"Number of learnable params {n_params}")

    def _replicate_state(self):
        """Rank 0's parameters, buffers, optimizer state and EMA on every rank
        (JAX `replicate`), and dropout draws that differ per rank: every rank
        seeds from the same draw plus its rank (JAX folds the shard index into
        the step's key)."""
        everyone = data_mesh()
        replicate(everyone, self.model)
        replicate(everyone, optimizer_state_tensors(self.optimizer) + (self.ema or []))
        torch.manual_seed(int(torch.randint(0, 2**62, ())) + 7919 * self.rank)

    def _load_resume(self, path) -> dict:
        """Restores the model, the optimizer and the counters of a port
        checkpoint; returns its state for the EMA and the RNG states."""
        logger.info(f"Loading checkpoint '{path}'...")
        state = load_checkpoint(path)
        self.model.load_state_dict(state["model_state_dict"], strict=True)
        if state.get("optimizer_state_dict") is not None:
            self.optimizer.load_state_dict(state["optimizer_state_dict"])
        else:
            logger.warning("Checkpoint has no optimizer state; the optimizer starts fresh")
        if state.get("best_eval_score") is not None:
            self.best_eval_score = state["best_eval_score"]
        self.num_iterations = state["num_iterations"]
        self.num_epochs = state["num_epochs"]
        self.checkpoint_dir = os.path.split(path)[0]
        logger.info(f"Checkpoint loaded from '{path}'. Epoch: {self.num_epochs}. "
                    f"Iteration: {self.num_iterations}. Best val score: {self.best_eval_score}.")
        return state

    def _rng_state(self) -> dict:
        """torch's CPU RNG, the device's CUDA RNG and the augmentation
        generators: what dropout and the device augmentation draw from."""
        state = {"cpu": torch.get_rng_state()}
        if self.device.type == "cuda":
            state["cuda"] = torch.cuda.get_rng_state(self.device)
        if self.device_augmenter is not None:
            state["augment"] = [gen.get_state() for gen in self.augment_generators]
        return state

    def _restore_rng(self, state: dict):
        torch.set_rng_state(state["cpu"])
        if self.device.type == "cuda" and "cuda" in state:
            torch.cuda.set_rng_state(state["cuda"], self.device)
        if self.device_augmenter is not None and "augment" in state:
            for gen, gen_state in zip(self.augment_generators, state["augment"]):
                gen.set_state(gen_state)
        logger.info("Random streams restored from the checkpoint")

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
        finally:
            # drain the background save (and raise its error), end the trace
            self._wait_checkpoint()
            if self._profiler is not None:
                self._profiler.stop()
                self._profiler = None
                logger.info(f"Profiler trace written to {self.profile_dir}")
            if self.writer is not None:
                # drains tensorboardX's queue (flush does not); a later write reopens it
                self.writer.close()

    def _prepare_batch(self, raw, target, augment: bool = False):
        """An NCDHW loader batch on the device. A train batch (`augment`) goes
        through the device augmenter, a target without a channel axis with one
        added for it and taken away after; then a 2D model's batch loses its
        singleton z (JAX trainer.py:440-465)."""
        with span("p3d.trainer.prepare_batch"):
            inp = torch.as_tensor(np.asarray(raw)).to(self.device)
            target = torch.as_tensor(np.asarray(target)).to(self.device)
            has_channel = target.ndim == inp.ndim
            if augment and self.device_augmenter is not None:
                inp, target = self.device_augmenter(inp, target if has_channel else target[:, None],
                                                    self.augment_generators)
                target = target if has_channel else target[:, 0]
            if is_model_2d(self.model):
                if inp.shape[2] != 1:
                    raise ValueError(f"a 2D model trains on patches of depth 1, got a batch of shape "
                                     f"{tuple(inp.shape)}")
                inp, target = inp[:, :, 0], target[:, :, 0] if has_channel else target[:, 0]
            if self.spatial_sharding:
                # this rank's D-slab of the batch every rank read alike
                if self.mesh is None:
                    self.mesh = choose_space_mesh(inp.shape[2], len(self.model.encoders),
                                                  min_local=spatial_min_local(self.model),
                                                  pool=spatial_pool_d(self.model))
                    logger.info(f"Spatial mesh: patch D axis sharded over {self.mesh.size} rank(s)")
                inp, target = shard_spatial_batch(self.mesh, (inp, target))
            elif self.mesh is None and self.world > 1:
                # each rank holds an equal part of the global batch (the loaders' shard)
                self.mesh = choose_data_mesh(self.world * inp.shape[0])
                logger.info(f"Data-parallel mesh: {self.mesh.size} ranks")
            return inp, target

    def _build_accum_fns(self):
        """(grads_step, apply_step, zeros) of an update of `grad_accum_steps`
        microbatches (parallel/mesh.py `step_fns`): the D-sharded ones of
        parallel/spatial.py, or the loss on the logits, over a data mesh on
        the logits and targets gathered over it with the gradients summed."""
        model, criterion, k = self.model, self.loss_criterion, self.grad_accum_steps
        if self.spatial_sharding:
            return build_spatial_accum_fns(model, criterion, self.optimizer, self.mesh, k)
        if self.mesh is None:
            def loss_fn(inp, target):
                probs, logits = model(inp)
                return criterion(logits, target), probs

            return step_fns(model.parameters(), self.optimizer, loss_fn, contextlib.nullcontext, (), k)
        mesh = self.mesh
        return step_fns(model.parameters(), self.optimizer,
                        lambda inp, target: data_parallel_loss(model, criterion, mesh, inp, target),
                        lambda: data_axis(mesh), ((mesh, False),), k)

    def _build_train_step(self):
        """`step(inp, target) -> (loss, probs)`: one update from one batch."""
        if self.spatial_sharding:
            return build_spatial_train_step(self.model, self.loss_criterion, self.optimizer, self.mesh)
        return train_step(*self._build_accum_fns())

    def _build_eval_step(self):
        """`step(inp, target) -> (probs, loss)` of validation: the D-sharded
        one, or the model and the loss on this rank's batch (validation
        batches are whole on every data-parallel rank, so they gather nothing)."""
        if self.spatial_sharding:
            return build_spatial_eval_step(self.model, self.loss_criterion, self.mesh)

        def step(inp, target):
            probs, logits = self.model(inp)
            return probs, self.loss_criterion(logits, target)

        return step

    def _full(self, t):
        """A D-slab gathered whole over the space mesh (logging and host
        metrics read whole volumes); any other tensor as it is."""
        if not self.spatial_sharding:
            return t
        with torch.no_grad():
            return gather(t, self.mesh, t.ndim - 3)

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
        if self.profile_dir and self._profiler is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(
                activities=activities, on_trace_ready=torch.profiler.tensorboard_trace_handler(self.profile_dir))
            self._profiler.start()

        for group in self._train_groups():
            logger.info(f"Training iteration [{self.num_iterations}/{self.max_num_iterations}]. "
                        f"Epoch [{self.num_epochs}/{self.max_num_epochs - 1}]")
            if self._log_clock is None:
                self._log_clock = time.perf_counter()
            raw, target_host, inp, target, probs = self._update(group, train_losses)
            # N * D * H * W of the loader batches
            self._log_voxels += sum(int(np.prod(np.shape(r))) // np.shape(r)[1] for r, _ in group)
            if self.ema is not None:
                self._ema_step()
            batch_size = inp.shape[0]

            if self.num_iterations % self.validate_after_iters == 0:
                eval_score = self.validate()
                if self.scheduler is not None:
                    if is_plateau(self.scheduler):
                        self.scheduler.step(eval_score)
                    else:
                        self.scheduler.step()
                self._log_lr()
                self._save_checkpoint(self._is_best_eval_score(eval_score))

            if self.num_iterations % self.log_after_iters == 0:
                self._log_train(train_losses, train_eval_scores, batch_size, raw, target_host, inp, target, probs)

            if self.should_stop():
                return True
            self.num_iterations += 1
        return False

    def _train_groups(self):
        """Tuples of `grad_accum_steps` loader batches, one per update; a
        trailing group short of k is dropped (JAX trainer.py `_train_groups`)."""
        train_loader = self.loaders["train"]
        if hasattr(train_loader, "set_epoch"):
            # epoch-keyed shuffle: a resumed run replays this epoch's batch order
            train_loader.set_epoch(self.num_epochs)
        it, k = iter(train_loader), self.grad_accum_steps
        while True:
            group = tuple(itertools.islice(it, k))
            if len(group) < k:
                if group:
                    logger.info(f"Dropping trailing {len(group)} microbatch(es) short of grad_accum_steps={k} "
                                f"at epoch end")
                return
            yield group

    def _update(self, group, train_losses):
        """One optimizer update from the group's microbatches: the train step
        for one, else their gradients summed by backward, divided by k (JAX
        `_accumulation_round`), then the optimizer's step. Returns the last
        microbatch's (raw, target) as the loader gave them and (input, target,
        probabilities) on the device (this rank's D-slabs under spatial
        sharding)."""
        single = self.grad_accum_steps == 1
        for i, (raw, target_host) in enumerate(group):
            inp, target = self._prepare_batch(raw, target_host, augment=True)
            if self._train_fns is None:
                # the first batch chose the mesh
                self._train_fns = self._build_train_step() if single else self._build_accum_fns()
            if single:
                with span("p3d.trainer.step"):
                    loss, probs = self._train_fns(inp, target)
            else:
                grads_step, apply_step, zeros = self._train_fns
                if i == 0:
                    zeros()
                with span("p3d.trainer.step"):
                    loss, probs = grads_step(inp, target)
            train_losses.update(loss.item(), inp.shape[0])
        if not single:
            with span("p3d.trainer.step"):
                apply_step()
        return raw, target_host, inp, target, probs

    @torch.no_grad()
    def _ema_step(self):
        """e = d * e + (1 - d) * p over every parameter, in one pass."""
        torch._foreach_lerp_(self.ema, [p.detach() for p in self.model.parameters()], 1.0 - self.ema_decay)

    @contextlib.contextmanager
    def _eval_weights(self):
        """The EMA weights in the model while validating, the live ones back
        after, also when validation raises. BatchNorm buffers stay the live
        model's (JAX `_eval_variables`)."""
        if self.ema is None:
            yield
            return
        params = list(self.model.parameters())
        live = [p.data for p in params]
        for p, e in zip(params, self.ema):
            p.data = e
        try:
            yield
        finally:
            for p, data in zip(params, live):
                p.data = data

    def _log_train(self, train_losses, train_eval_scores, batch_size, raw, target_host, inp, target, probs):
        """The log iteration's stats, scalars, images and histograms, from the
        last microbatch (gathered whole from the D-slabs under spatial sharding)."""
        inp, target, probs = self._full(inp), self._full(target), self._full(probs)
        out_np = None
        if not self.skip_train_validation or self.writer is not None:
            out_np, tar_np = self._metric_layout(probs, target)
        if not self.skip_train_validation:
            # the target the network saw: after device augmentation the host
            # batch is the one before it
            train_eval_scores.update(float(self.eval_criterion(out_np, tar_np)), batch_size)
        now = time.perf_counter()
        voxels_per_sec = self._log_voxels / (now - self._log_clock)
        self._log_voxels, self._log_clock = 0, now
        logger.info(f"Training stats. Loss: {train_losses.avg}. Evaluation score: {train_eval_scores.avg}. "
                    f"Throughput: {voxels_per_sec / 1e6:.2f} Mvoxels/s")
        self._log_stats("train", train_losses.avg, train_eval_scores.avg)
        if self.writer is None:
            return
        self.writer.add_scalar("train_voxels_per_sec", voxels_per_sec, self.num_iterations)
        if self.device_augmenter is not None:
            # the batch the network saw, not the host one before augmentation
            raw_log, target_log = inp.cpu().numpy(), target.cpu().numpy()
        else:
            raw_log, target_log = np.asarray(raw), np.asarray(target_host)
        self._log_images(raw_log, target_log, out_np, "train_")
        if self.log_params:
            for name, p in self.model.named_parameters():
                self.writer.add_histogram(name, p.detach().cpu().numpy(), self.num_iterations)
                if p.grad is not None:
                    self.writer.add_histogram(name + "/grad", p.grad.cpu().numpy(), self.num_iterations)

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

    def _val_image_indices(self) -> set:
        """The validation batches whose images are logged: all of them up to
        `max_val_images`, else a subset fixed by RandomState(42) (JAX
        trainer.py:734-739); none without a writer."""
        if self.writer is None:
            return set()
        n_val = len(self.loaders["val"])
        if n_val <= self.max_val_images:
            return set(range(n_val))
        return set(np.random.RandomState(42).choice(n_val, size=self.max_val_images, replace=False).tolist())

    def validate(self) -> float:
        """Loss and eval score averaged over the validation batches, with the
        EMA weights when they are on. With a device twin of the eval metric
        (`metrics.device_metric_fn`) both stay 0-d device tensors until the
        loop has ended, so the loop makes no host sync (JAX trainer.py
        `validate`); a batch whose images are logged, and every batch without
        a twin, goes to the host metric."""
        logger.info("Validating...")
        indices = self._val_image_indices()
        pending = []
        self.model.eval()
        try:
            with torch.no_grad(), self._eval_weights():
                for i, (raw, target_host) in enumerate(self.loaders["val"]):
                    inp, target = self._prepare_batch(raw, target_host)
                    if self._eval_step is None:
                        self._eval_step = self._build_eval_step()
                    probs, loss = self._eval_step(inp, target)
                    inp, target, probs = self._full(inp), self._full(target), self._full(probs)
                    if self.device_metric is not None and i not in indices:
                        score = self.device_metric(probs, target)
                    else:
                        out_np, tar_np = self._metric_layout(probs, target)
                        score = float(self.eval_criterion(out_np, tar_np))
                        if i in indices:
                            self._log_images(np.asarray(raw), np.asarray(target_host), out_np, f"val_{i}_")
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

    def _checkpoint_state(self) -> dict:
        """The checkpoint's content, its tensors the live ones."""
        state = {
            "num_epochs": self.num_epochs + 1,
            # the save runs after this iteration's update, so the next
            # iteration is the resume point (as in the JAX trainer)
            "num_iterations": self.num_iterations + 1,
            "model_state_dict": self.model.state_dict(),
            "optimizer_state_dict": self.optimizer.state_dict(),
            "best_eval_score": float(self.best_eval_score),
            "torch_rng_state": self._rng_state(),
        }
        if self.ema is not None:
            # the reference's names; the port's predict CLI prefers these weights
            state["ema_state_dict"] = {name: e for (name, _), e in zip(self.model.named_parameters(), self.ema)}
        return state

    def _wait_checkpoint(self):
        """Joins the background save in flight, raising its error."""
        if self._ckpt_future is not None:
            future, self._ckpt_future = self._ckpt_future, None
            future.result()

    def _save_checkpoint(self, is_best: bool):
        if self.rank != 0:
            # the replicas are identical: one writer (and no two writes of one file)
            return
        # one save at a time: a new one first waits for the last (which also
        # orders the last/best file writes)
        self._wait_checkpoint()
        logger.info(f"Saving checkpoint to '{os.path.join(self.checkpoint_dir, LAST_CHECKPOINT)}'")
        state, checkpoint_dir = self._checkpoint_state(), self.checkpoint_dir
        if not self.async_checkpoint:
            save_checkpoint(_map_tensors(state, lambda t: t.detach().cpu()), is_best, checkpoint_dir=checkpoint_dir)
            return
        # the next update changes the parameters and the optimizer's moments in
        # place: the thread writes copies taken now, on the device
        snapshot = _map_tensors(state, lambda t: t.detach().clone())
        if self._ckpt_executor is None:
            self._ckpt_executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="checkpoint")
        self._ckpt_future = self._ckpt_executor.submit(
            lambda: save_checkpoint(_map_tensors(snapshot, lambda t: t.cpu()), is_best, checkpoint_dir=checkpoint_dir))

    def _log_lr(self):
        lr = self.optimizer.param_groups[0]["lr"]
        logger.info(f"learning_rate={lr} at {self.num_iterations}")
        if self.writer is not None:
            self.writer.add_scalar("learning_rate", lr, self.num_iterations)

    def _log_stats(self, phase: str, loss_avg: float, eval_score_avg: float):
        logger.info(f"{phase}_loss_avg={loss_avg} {phase}_eval_score_avg={eval_score_avg} "
                    f"at iteration {self.num_iterations}")
        if self.writer is not None:
            self.writer.add_scalar(f"{phase}_loss_avg", loss_avg, self.num_iterations)
            self.writer.add_scalar(f"{phase}_eval_score_avg", eval_score_avg, self.num_iterations)

    def _log_images(self, inputs, targets, predictions, prefix: str):
        """Middle-slice images of NC(D)HW numpy batches, under the JAX tags; a
        2D model's batches get their singleton z back first (JAX
        trainer.py:899-936)."""
        batches = {"inputs": inputs, "targets": targets, "predictions": predictions}
        if is_model_2d(self.model):
            # (N, C, H, W) -> (N, C, 1, H, W); an (N, H, W) class map -> (N, 1, H, W)
            batches = {name: b[:, :, None] if b.ndim == 4 else b[:, None] if b.ndim == 3 else b
                       for name, b in batches.items()}
        for name, batch in batches.items():
            for tag, image in self.tensorboard_formatter(name, batch):
                self.writer.add_image(prefix + tag, image, self.num_iterations)
