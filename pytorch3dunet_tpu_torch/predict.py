"""Prediction CLI of the port: `python -m pytorch3dunet_tpu_torch.predict --config test_config.yml`.

Same YAML schema and overrides as `predict3dunet`. The weights come from
`model_path`: a torch-format checkpoint, or a JAX npz checkpoint, whose EMA
weights are preferred when it carries them (as `predict3dunet` does).

On CUDA the default `StandardPredictor` becomes `DeviceSlidingWindowPredictor`
(the sweep on the device), as the JAX CLI does on its accelerator;
`predictor.force_host: true` keeps the host loop. On `device: cpu` the host
loop stays the default. `LazyPredictor` is always the host loop.
`DSB2018Predictor` predicts the PNG folders of `DSB2018Dataset` image by image.

With `predictor.performance_metric` each volume is scored against its ground
truth; the per-class average and the average over the volumes are logged.

On N ranks (P3DUNET_COORDINATOR, P3DUNET_NUM_PROCESSES, P3DUNET_PROCESS_ID;
parallel/distributed.py) the files shard across hosts, and the ranks of a host
share each volume's device sweep (`predictor.shard`); the host's first rank
writes the outputs and runs any other predictor alone.
"""

import os
import sys

import numpy as np
import torch

from pytorch3dunet_tpu_torch.config import load_config, resolve_device
from pytorch3dunet_tpu_torch.datasets.utils import get_test_loaders
from pytorch3dunet_tpu_torch.models.unet import get_model
from pytorch3dunet_tpu_torch.parallel import distributed
from pytorch3dunet_tpu_torch.predictor import (DeviceSlidingWindowPredictor, DSB2018Predictor, LazyPredictor,
                                                StandardPredictor)
from pytorch3dunet_tpu_torch.utils.misc import get_logger
from pytorch3dunet_tpu_torch.utils.weights import load_weights

logger = get_logger("UNet3DPredict")

_PREDICTORS = {cls.__name__: cls for cls in (StandardPredictor, LazyPredictor, DeviceSlidingWindowPredictor,
                                             DSB2018Predictor)}


def get_predictor(model, config: dict):
    """Resolves the predictor class by `config['predictor']['name']`; on a
    CUDA device the default host loop becomes the device sweep unless
    `force_host` (JAX predict.py `get_predictor`)."""
    output_dir = config["loaders"].get("output_dir", None)
    if output_dir is not None:
        os.makedirs(output_dir, exist_ok=True)
    predictor_config = dict(config.get("predictor", {}))
    class_name = predictor_config.pop("name", "StandardPredictor")
    force_host = predictor_config.pop("force_host", False)
    if class_name == "StandardPredictor" and torch.device(config["device"]).type == "cuda" and not force_host:
        logger.info("CUDA device: using DeviceSlidingWindowPredictor (set predictor.force_host to opt out)")
        class_name = "DeviceSlidingWindowPredictor"
    if class_name not in _PREDICTORS:
        raise ValueError(f"Unknown predictor {class_name!r}")
    out_channels = config["model"].get("out_channels")
    return _PREDICTORS[class_name](model, output_dir, out_channels, device=config["device"], **predictor_config)


def run(config: dict) -> list:
    """Builds the model, loads its weights and predicts every test file;
    returns the per-volume `performance_metric` scores (empty without one)."""
    device = config["device"] = distributed.device_for_rank(resolve_device(config.get("device")))
    logger.info(f"Using device: {device}")
    model = get_model(config["model"])
    logger.info(f"Loading model from {config['model_path']}...")
    load_weights(model, config["model_path"])
    model = model.to(device).eval()
    predictor = get_predictor(model, config)
    if distributed.local_rank() != 0 and not isinstance(predictor, DeviceSlidingWindowPredictor):
        logger.info(f"{type(predictor).__name__} runs on the host's first rank; rank {distributed.rank()} idles")
        return []
    metrics = []
    try:
        for test_loader in get_test_loaders(config):
            metric = predictor(test_loader)
            if metric is not None:
                metrics.append(metric)
    finally:
        # join the write-behind output write of the last volume. When the loop
        # is already unwinding with its own exception, a write failure here
        # must not replace it: log it and let the first one propagate
        if sys.exc_info()[0] is None:
            predictor.finalize()
        else:
            try:
                predictor.finalize()
            except Exception:  # noqa: BLE001
                logger.exception("write-behind save ALSO failed while handling the error above")
    if metrics:
        scores = np.asarray(metrics, dtype=np.float64)
        # each host predicted its own files: these average over that share
        prefix = f"[process {distributed.process_index()}] " if distributed.process_count() > 1 else ""
        logger.info(f"{prefix}Per-class average metric: {scores.mean(axis=0)}")
        logger.info(f"{prefix}Average metric: {scores.mean()}")
    return metrics


def main(argv=None) -> list:
    """Loads the config, joins the other ranks when P3DUNET_COORDINATOR is
    set, and predicts (`run`)."""
    config, _ = load_config(argv)
    started = not distributed.is_initialized() and distributed.initialize_from_env(config["device"])
    try:
        return run(config)
    finally:
        if started:
            distributed.shutdown()


if __name__ == "__main__":
    main()
