"""Prediction CLI of the port: `python -m pytorch3dunet_tpu_torch.predict --config test_config.yml`.

Same YAML schema and overrides as `predict3dunet`; the weights come from a
torch-format checkpoint (`model_path`).
"""

import os

from pytorch3dunet_tpu_torch.utils.misc import get_logger
from pytorch3dunet_tpu_torch.config import load_config, resolve_device
from pytorch3dunet_tpu_torch.datasets.utils import get_test_loaders
from pytorch3dunet_tpu_torch.models.unet import get_model
from pytorch3dunet_tpu_torch.predictor import StandardPredictor
from pytorch3dunet_tpu_torch.utils.weights import load_weights

logger = get_logger("UNet3DPredict")

# predictors of the JAX package that the port does not have yet, with their ROADMAP item
_NOT_PORTED = {
    "LazyPredictor": "Queue 1 item 10",
    "DSB2018Predictor": "Queue 1 item 10",
    "DeviceSlidingWindowPredictor": "Queue 1 item 5",
}


def get_predictor(model, config: dict):
    """Resolves the predictor class by `config['predictor']['name']`."""
    output_dir = config["loaders"].get("output_dir", None)
    if output_dir is not None:
        os.makedirs(output_dir, exist_ok=True)
    predictor_config = dict(config.get("predictor", {}))
    class_name = predictor_config.pop("name", "StandardPredictor")
    if class_name in _NOT_PORTED:
        raise NotImplementedError(f"{class_name} is not ported to PyTorch yet (ROADMAP {_NOT_PORTED[class_name]})")
    if class_name != "StandardPredictor":
        raise ValueError(f"Unknown predictor {class_name!r}")
    out_channels = config["model"].get("out_channels")
    return StandardPredictor(model, output_dir, out_channels, device=config["device"], **predictor_config)


def run(config: dict):
    """Builds the model, loads its weights and predicts every test file."""
    device = config["device"] = resolve_device(config.get("device"))
    logger.info(f"Using device: {device}")
    model = get_model(config["model"])
    logger.info(f"Loading model from {config['model_path']}...")
    load_weights(model, config["model_path"])
    model = model.to(device).eval()
    predictor = get_predictor(model, config)
    for test_loader in get_test_loaders(config):
        predictor(test_loader)


def main(argv=None):
    config, _ = load_config(argv)
    run(config)


if __name__ == "__main__":
    main()
