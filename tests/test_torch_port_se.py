"""The port's scSE gates on the CPU at a tiny size: one `p3d.se` profiler span
per gate that `models/unet.py` `se_plan` names, the plan of each family, and
the device sweep of a ResidualUNetSE3D against the host loop.

The benchmark's `se_ms.grid` and `se_roofline.grid` read the `p3d.se` spans;
`chip_smoke.py` phase 12 holds the gates' calls to `se_plan` on the card.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pytorch3dunet_tpu_torch.datasets.utils import calculate_stats
from pytorch3dunet_tpu_torch.inference_device import detect_device_path
from pytorch3dunet_tpu_torch.models.unet import get_model, se_plan
from pytorch3dunet_tpu_torch.predictor import DeviceSlidingWindowPredictor, StandardPredictor

SE_MODEL = {"name": "ResidualUNetSE3D", "in_channels": 1, "out_channels": 1, "layer_order": "gcr", "f_maps": 4,
            "num_groups": 2, "num_levels": 3, "final_sigmoid": True}
FAMILIES = {"ResidualUNetSE3D": 9, "UNet3D": 0, "ResidualUNet3D": 0, "UNet2D": 0, "ResidualUNet2D": 0}


def _se_model():
    torch.manual_seed(0)
    return get_model(dict(SE_MODEL)).eval()


@pytest.fixture
def one_thread():
    """One intra-op thread for a test of tiny tensors, restored after: with every core busy in the other test
    workers, the thread pool's barriers would take most of the test's time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _span_count(model, x) -> int:
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        model(x)
    return sum(e.name == "p3d.se" for e in prof.events())


def test_forward_opens_one_span_per_planned_gate(one_thread):
    model = _se_model()
    assert se_plan(model) == [f"{part}.{i}.basic_module.se_module" for part, n in (("encoders", 3), ("decoders", 2))
                              for i in range(n)]
    assert _span_count(model, torch.rand(1, 1, 8, 24, 24)) == len(se_plan(model)) == 5
    plain = get_model({**SE_MODEL, "name": "ResidualUNet3D"}).eval()
    assert _span_count(plain, torch.rand(1, 1, 8, 24, 24)) == 0


@pytest.mark.parametrize("name", FAMILIES)
def test_se_plan_of_each_family(name):
    """A 5-level ResidualUNetSE3D calls 9 gates a forward (5 encoders, 4 decoders); no other family calls one."""
    model = get_model({"name": name, "in_channels": 1, "out_channels": 1, "f_maps": 4, "num_groups": 2,
                       "num_levels": 5})
    assert len(se_plan(model)) == FAMILIES[name]


def test_device_sweep_agrees_with_the_host_loop(one_thread):
    """Assign on a 2 x 2 x 2 grid whose last patch of each axis is flush with the volume's end."""
    model = _se_model()
    volume = (np.random.RandomState(0).rand(10, 20, 20) * 3 + 1).astype(np.float32)
    patch, halo = (8, 16, 16), (2, 4, 4)
    raw = [{"name": "Standardize"}, {"name": "ToTensor", "expand_dims": True}]
    host = StandardPredictor(model, None, 1, "cpu").predict_array(volume, patch, patch, halo, {"raw": raw})
    normalize, stats = detect_device_path(raw, calculate_stats(volume))
    device = DeviceSlidingWindowPredictor(model, None, 1, "cpu").predict_array(
        volume, patch, patch, halo, normalize=normalize, stats=stats)
    assert np.abs(device - host).max() <= 1e-5
