"""Training CLI of the port: `python -m pytorch3dunet_tpu_torch.train --config train_config.yml`.

Same YAML schema and overrides as `train3dunet`; checkpoints are torch-format
`.pytorch` files that both packages' predict CLIs read.

On N ranks every process runs the same command with P3DUNET_COORDINATOR=host:port,
P3DUNET_NUM_PROCESSES=N and its P3DUNET_PROCESS_ID (parallel/distributed.py):
NCCL on GPUs, gloo with `device: cpu`.
"""

import random

import numpy as np
import torch

from pytorch3dunet_tpu_torch.utils.misc import get_logger
from pytorch3dunet_tpu_torch.config import copy_config, load_config
from pytorch3dunet_tpu_torch.parallel import distributed
from pytorch3dunet_tpu_torch.trainer import create_trainer

logger = get_logger("TrainingSetup")


def main(argv=None):
    """Loads the config, joins the other ranks when P3DUNET_COORDINATOR is
    set, seeds the RNGs, builds the trainer and runs fit()."""
    config, config_path = load_config(argv)
    started = not distributed.is_initialized() and distributed.initialize_from_env(config["device"])
    try:
        _train(config, config_path)
    finally:
        if started:
            distributed.shutdown()


def _train(config: dict, config_path: str):
    logger.info(config)

    manual_seed = config.get("manual_seed", None)
    if manual_seed is not None:
        logger.info(f"Seed the RNGs with {manual_seed}")
        random.seed(manual_seed)
        np.random.seed(manual_seed)
        torch.manual_seed(manual_seed)

    trainer = create_trainer(config)
    if distributed.rank() == 0:
        copy_config(config, config_path)
    trainer.fit()


if __name__ == "__main__":
    main()
