"""Every YAML under resources/ against the port's checks, on the CPU.

A train config goes through `create_trainer` (model, loss, metric, the
device-augmentation split, optimizer, scheduler, trainer options) with empty
in-memory loaders, a test config through `get_model` and `get_predictor`, and
both through the dataset class their loaders name. Every config passes them
all: a config the port did not run would be refused with a NotImplementedError
that names the ROADMAP Queue 1 item that ports what it needs.
"""

import glob
import os

import pytest
import yaml

from pytorch3dunet_tpu_torch.datasets.utils import _dataset_class
from pytorch3dunet_tpu_torch.models.unet import get_model
from pytorch3dunet_tpu_torch.predict import get_predictor
from pytorch3dunet_tpu_torch.trainer import create_trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, os.path.join(REPO, "resources"))
                 for p in glob.glob(os.path.join(REPO, "resources", "*", "*.y*ml")))


def _check(config: dict, tmp):
    config = dict(config, device="cpu")
    if "trainer" in config:
        config["trainer"] = dict(config["trainer"], checkpoint_dir=str(tmp))
        create_trainer(config, loaders={"train": [], "val": []})
    else:
        config["loaders"] = dict(config["loaders"], output_dir=str(tmp))
        get_predictor(get_model(config["model"]), config)
    _dataset_class(config["loaders"])


def test_the_port_runs_all_25_configs():
    assert len(CONFIGS) == 25
    assert {"2DUnet_confocal_boundary/train_config.yml", "2DUnet_dsb2018/test_config.yml"} <= set(CONFIGS)


@pytest.mark.parametrize("name", CONFIGS)
def test_resource_config_passes_or_names_its_roadmap_item(name, tmp_path):
    with open(os.path.join(REPO, "resources", name)) as f:
        config = yaml.safe_load(f)
    _check(config, tmp_path)
