"""The plain reference (benchmark/reference/) agrees with the port on the CPU
at a tiny size, on the same seeded weights: both models' forwards, the loss
and one Adam step, each found by its name; and a model family and a loss
that the benchmark does not have, written as new files where the reference
looks, are found and agree too. The test may import both; the reference
imports nothing of the port. On the CPU the port's 3x3x3 conv is its plain
PyTorch version, so the two differ by float32 summation order alone."""

import numpy as np
import pytest
import torch

from benchmark import seeded
from benchmark.reference import losses, models, optimizers
from benchmark.reference import sweep as ref_sweep

SEED = 2**31 + 77
CPU = torch.device("cpu")
MODELS = {
    "UNet3D": {"name": "UNet3D", "in_channels": 1, "out_channels": 1, "layer_order": "gcr", "f_maps": 4,
               "num_levels": 3, "num_groups": 2, "final_sigmoid": True},
    "ResidualUNet3D": {"name": "ResidualUNet3D", "in_channels": 1, "out_channels": 1, "layer_order": "gcr",
                       "f_maps": 4, "num_levels": 3, "num_groups": 2, "final_sigmoid": True},
}
# f32 sums in another order: the probabilities and logits of a tiny model
TOL = 1e-5


def port_model(cfg, params):
    from pytorch3dunet_tpu_torch.models.unet import get_model

    model = get_model(cfg)
    model.load_state_dict(params, strict=True)
    return model


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("shape", [(8, 24, 24), (12, 30, 34)])
def test_forward(name, shape):
    cfg = MODELS[name]
    params = seeded.weights(cfg, SEED, CPU)
    x = torch.randn((1, 1, *shape), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want_p, want_l = port_model(cfg, params).eval()(x)
        got_p, got_l = models.forward(params, x, cfg)
    assert got_l.shape == want_l.shape
    assert (got_l - want_l).abs().max() <= TOL * want_l.abs().max()
    assert (got_p - want_p).abs().max() <= TOL


def test_param_specs_are_the_state_dict():
    for cfg in MODELS.values():
        want = {k: tuple(v.shape) for k, v in port_model(cfg, seeded.weights(cfg, SEED, CPU)).state_dict().items()}
        assert dict(models.param_specs(cfg)) == want


def test_loss():
    from pytorch3dunet_tpu_torch.losses import get_loss_criterion

    gen = torch.Generator().manual_seed(2)
    logits = torch.randn(1, 1, 6, 10, 10, generator=gen)
    target = torch.stack([(torch.rand(6, 10, 10, generator=gen) > 0.7).float(),
                          torch.randint(0, 5, (6, 10, 10), generator=gen).float()])[None]
    port = get_loss_criterion({"loss": {"name": "BCEDiceLoss", "ignore_index": None, "skip_last_target": True}})
    ref = losses.criterion({"name": "BCEDiceLoss", "ignore_index": None, "skip_last_target": True})
    assert abs(float(ref(logits, target)) - float(port(logits, target))) <= 1e-6


def test_adam_step():
    from pytorch3dunet_tpu_torch.utils.optim import create_optimizer

    cfg = MODELS["UNet3D"]
    params = seeded.weights(cfg, SEED, CPU)
    model = port_model(cfg, params)
    opt = create_optimizer({"learning_rate": 2e-4, "weight_decay": 1e-5}, model)
    gen = torch.Generator().manual_seed(3)
    grads = {k: torch.randn(v.shape, generator=gen) for k, v in params.items()}
    for _ in range(2):
        for name, p in model.named_parameters():
            p.grad = grads[name].clone()
        opt.step()
    ref = optimizers.optimizer({k: v.clone() for k, v in params.items()}, {"learning_rate": 2e-4, "weight_decay": 1e-5})
    for _ in range(2):
        ref.step(grads)
    for name, p in model.named_parameters():
        assert torch.allclose(ref.params[name], p.detach(), rtol=0, atol=1e-7), name


@pytest.mark.parametrize("blend", ["assign", "gaussian"])
def test_sweep(blend):
    from pytorch3dunet_tpu_torch.datasets.utils import calculate_stats
    from pytorch3dunet_tpu_torch.inference_device import detect_device_path
    from pytorch3dunet_tpu_torch.predictor import DeviceSlidingWindowPredictor

    cfg = MODELS["UNet3D"]
    params = seeded.weights(cfg, SEED, CPU)
    model = port_model(cfg, params).eval()
    volume = seeded.volumes((16, 24, 40), 1, SEED, CPU, cells=5)[0]
    patch, stride, halo = (8, 16, 16), (4, 8, 12), (2, 4, 4)
    normalize, stats = detect_device_path([{"name": "Standardize"}], calculate_stats(volume))
    got = DeviceSlidingWindowPredictor(model, None, 1, CPU, blend=blend).predict_array(
        volume, patch, stride, halo, normalize=normalize, stats=stats)
    want = ref_sweep.predict(volume, params, cfg, patch, stride, halo, blend, CPU)
    assert ref_sweep.max_gap(got, want) <= TOL
    assert len(ref_sweep.grid(volume.shape, patch, stride)) == 3 * 2 * 3
    assert np.isfinite(want).all()


# A model family and a loss the benchmark does not have, as a later change would add them: new files only.
UNET2D = '''"""Plain UNet2D: UNet3D's equations on (N, C, 1, H, W) planes, 3x3 convs."""
import torch
import torch.nn.functional as F

from benchmark.reference import blocks
from benchmark.reference.models import UNet3D

features = UNet3D.features


def param_specs(model_cfg):
    return [(n, s[:2] + s[3:] if n.endswith("conv.weight") else s[:-1] if n == "final_conv.weight" else s)
            for n, s in UNet3D.param_specs(model_cfg)]


def _unit(params, prefix, x, groups):
    x = F.group_norm(x, 1 if x.shape[1] < groups else groups, params[prefix + ".groupnorm.weight"],
                     params[prefix + ".groupnorm.bias"], blocks.EPS)
    return F.relu(F.conv2d(x, params[prefix + ".conv.weight"], padding=1))


def forward(params, x, model_cfg, quantize=None):
    x, groups, skips = x[:, :, 0], model_cfg.get("num_groups", 8), []
    for i in range(len(features(model_cfg))):
        x = F.max_pool2d(x, 2) if i else x
        p = "encoders.%d.basic_module" % i
        x = _unit(params, p + ".SingleConv2", _unit(params, p + ".SingleConv1", x, groups), groups)
        skips.append(x)
    for i, skip in enumerate(reversed(skips[:-1])):
        p = "decoders.%d.basic_module" % i
        x = torch.cat([skip, F.interpolate(x, size=skip.shape[2:], mode="nearest")], dim=1)
        x = _unit(params, p + ".SingleConv2", _unit(params, p + ".SingleConv1", x, groups), groups)
    logits = F.conv2d(x, params["final_conv.weight"], params["final_conv.bias"])[:, :, None]
    return logits.sigmoid(), logits
'''
DICE = '''"""Plain DiceLoss: 1 - the mean over channels of the Dice coefficient of the sigmoid."""


def make():
    def loss(logits, target):
        p = logits.sigmoid().transpose(0, 1).reshape(logits.shape[1], -1)
        t = target.to(logits.dtype).transpose(0, 1).reshape(target.shape[1], -1)
        return 1 - (2 * (p * t).sum(-1) / ((p * p).sum(-1) + (t * t).sum(-1)).clamp(min=1e-6)).mean()

    return loss
'''


def test_a_family_and_a_loss_the_benchmark_does_not_have(tmp_path, monkeypatch):
    from pytorch3dunet_tpu_torch.losses import get_loss_criterion

    for package, name, source in ((models, "UNet2D", UNET2D), (losses, "DiceLoss", DICE)):
        (tmp_path / package.__name__).mkdir(parents=True)
        (tmp_path / package.__name__ / f"{name}.py").write_text(source)
        monkeypatch.setattr(package, "__path__", [*package.__path__, str(tmp_path / package.__name__)])
    cfg = dict(MODELS["UNet3D"], name="UNet2D")
    params = seeded.weights(cfg, SEED, CPU)
    x = torch.randn((1, 1, 24, 40), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want_p, want_l = port_model(cfg, params).eval()(x)
        got_p, got_l = models.forward(params, x[:, :, None], cfg)
    assert got_l[:, :, 0].shape == want_l.shape
    assert (got_l[:, :, 0] - want_l).abs().max() <= TOL * want_l.abs().max()
    target = (torch.rand(want_l.shape, generator=torch.Generator().manual_seed(5)) > 0.5).float()
    port = get_loss_criterion({"loss": {"name": "DiceLoss"}})
    assert abs(float(losses.criterion({"name": "DiceLoss"})(got_l[:, :, 0], target)) - float(port(want_l, target))) \
        <= 1e-6
