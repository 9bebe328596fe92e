"""The GroupNorm forward op (pytorch3dunet_tpu_torch/ops/group_norm.py) on the
CPU: its plain version against `nn.GroupNorm` in float64, its layout rule (y
keeps x's strides), the plan by which the CUDA kernel reads x, the dispatch
rule of `models/blocks.py` `GroupNorm.forward`, the layout a conv chain keeps
through it, `torch.export` and `opcheck`.

The kernel itself runs only on the card (tests/test_torch_port_cuda.py and
chip_smoke.py). Here the op takes the device rule's CPU stand-in: tests that
need the module to take the op add "cpu" to `KERNEL_DEVICES`, and a spy on
the plain version shows that the op ran.

Tolerances: float32 against float64 within 2e-6 of max |y| (float32 sums
over at most a few thousand values, two passes); bfloat16 within half a
bfloat16 ulp of the float64 result plus that float32 error (the contract: one
rounding of the float32 result); the exported program against the eager
model exactly (the same plain version on the same values).
"""

import numpy as np
import pytest
import torch
import torch.nn as nn

from pytorch3dunet_tpu_torch.export import ServingForward, export_model, load_exported
from pytorch3dunet_tpu_torch.models.blocks import GroupNorm, SingleConv
from pytorch3dunet_tpu_torch.models.unet import get_model, group_norm_plan
from pytorch3dunet_tpu_torch.ops import group_norm
from pytorch3dunet_tpu_torch.ops.conv3d import Conv3d
from pytorch3dunet_tpu_torch.parallel.mesh import Mesh
from pytorch3dunet_tpu_torch.parallel.spatial import spatial_axis

F32_TOL = 2e-6
MODEL_3D = {"name": "UNet3D", "in_channels": 1, "out_channels": 2, "f_maps": 8, "layer_order": "gcr",
            "num_groups": 4, "num_levels": 2, "final_sigmoid": True}


def _inputs(shape, dtype, channels_last, seed):
    rs = np.random.RandomState(seed)
    # a mean away from 0 and unequal scales per channel: the statistics matter
    x = torch.from_numpy((rs.randn(*shape) * rs.uniform(0.5, 3, (1, shape[1]) + (1,) * (len(shape) - 2))
                          + 2.5).astype(np.float32)).to(dtype)
    if channels_last:
        x = x.movedim(1, -1).contiguous().movedim(-1, 1)
    weight = torch.from_numpy(rs.uniform(0.5, 1.5, shape[1]).astype(np.float32))
    bias = torch.from_numpy(rs.uniform(-0.2, 0.2, shape[1]).astype(np.float32))
    return x, weight, bias


def _float64_group_norm(x, weight, bias, groups):
    norm = nn.GroupNorm(groups, x.shape[1], eps=1e-5).double()
    with torch.no_grad():
        norm.weight.copy_(weight.double())
        norm.bias.copy_(bias.double())
        return norm(x.double())


def _bf16_half_ulp(v):
    """Half the spacing of bfloat16 numbers at |v| (8 significant bits)."""
    exponent = torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126)))
    return 2.0 ** (exponent - 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("groups", [1, 8])
@pytest.mark.parametrize("layout", ["ncdhw", "ndhwc", "nchw", "nhwc"])
def test_plain_version_against_float64(layout, groups, n, dtype):
    shape = (n, 16, 3, 5, 6) if layout in ("ncdhw", "ndhwc") else (n, 16, 7, 9)
    x, weight, bias = _inputs(shape, dtype, layout in ("ndhwc", "nhwc"), 1 + groups + n)
    y = group_norm.group_norm_op(x, weight, bias, groups, 1e-5)
    want = _float64_group_norm(x, weight, bias, groups)
    assert y.dtype == dtype and y.shape == x.shape and y.stride() == x.stride()
    scale = want.abs().max().item()
    err = (y.double() - want).abs()
    if dtype == torch.float32:
        assert err.max().item() <= F32_TOL * scale
    else:
        assert bool((err <= _bf16_half_ulp(want) + F32_TOL * scale).all())
        # one rounding of the float32 result: the nearest bfloat16 almost everywhere
        assert (y == want.to(torch.bfloat16)).double().mean().item() > 0.99


def test_plain_version_runs_float64_without_weights():
    x, _, _ = _inputs((2, 6, 4, 5, 3), torch.float64, False, 3)
    want = nn.functional.group_norm(x, 3, eps=1e-5)
    torch.testing.assert_close(group_norm.group_norm_reference(x, None, None, 3, 1e-5), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("memory_format", [torch.contiguous_format, torch.channels_last_3d],
                         ids=["contiguous", "channels_last"])
def test_output_keeps_the_input_strides(memory_format, dtype):
    x, weight, bias = _inputs((2, 8, 4, 6, 5), dtype, False, 4)
    x = x.contiguous(memory_format=memory_format)
    y = group_norm.group_norm_op(x, weight, bias, 4, 1e-5)
    assert y.stride() == x.stride() and y.is_contiguous(memory_format=memory_format)


@pytest.mark.parametrize("case, want", [
    ("ncdhw f32", (group_norm.NC, True)),
    ("ncdhw f32 odd spatial", (group_norm.NC, False)),
    ("ncdhw bf16 spatial 4", (group_norm.NC, False)),
    ("ncdhw one channel", (group_norm.NC, True)),
    ("ndhwc f32", (group_norm.CHANNELS_LAST, True)),
    ("ndhwc bf16", (group_norm.CHANNELS_LAST, True)),
    ("ndhwc f32 6 channels", (group_norm.CHANNELS_LAST, False)),
    ("ndhwc f32 misaligned", (group_norm.CHANNELS_LAST, False)),
    ("ndhwc f32 1024 channels", (group_norm.CHANNELS_LAST, True)),
    # more channels than a channels-last block holds: the kernel's own
    # answer (group_norm_workspace_floats) sends these to the contiguous copy
    ("ndhwc f32 2048 channels", (group_norm.CHANNELS_LAST, True)),
    ("ndhwc f32 302 channels", (group_norm.CHANNELS_LAST, False)),
    ("transposed", None),
])
def test_launch_layout(case, want):
    dtype = torch.bfloat16 if "bf16" in case else torch.float32
    channels = {"one channel": 1, "6 channels": 6, "1024 channels": 1024, "2048 channels": 2048,
                "302 channels": 302}
    c = next((v for k, v in channels.items() if k in case), 16)
    spatial = (3, 5, 7) if "odd" in case else (1, 2, 2) if "spatial 4" in case else (2, 4, 4)
    x = torch.zeros((2, c, *spatial), dtype=dtype)
    if case.startswith("ndhwc"):
        x = x.contiguous(memory_format=torch.channels_last_3d)
    if "misaligned" in case:
        # one element into a channels-last buffer: 4-byte aligned, not 16
        base = torch.zeros(x.numel() + 1, dtype=dtype)
        x = base[1:].view(2, *spatial, c).movedim(-1, 1)
    if case == "transposed":
        x = x.transpose(3, 4)
    assert group_norm.launch_layout(x) == want


@pytest.fixture
def spy(monkeypatch):
    """The op's CPU runs, counted: the plain version wrapped."""
    calls = []
    reference = group_norm.group_norm_reference

    def counted(*args):
        calls.append(args[0].shape)
        return reference(*args)

    monkeypatch.setattr(group_norm, "group_norm_reference", counted)
    return calls


@pytest.fixture
def cpu_kernel(monkeypatch):
    """The CPU as a device of the dispatch rule: the module takes the op there."""
    monkeypatch.setattr(group_norm, "KERNEL_DEVICES", ("cuda", "cpu"))


@pytest.mark.parametrize("mode, takes_op", [
    ("no_grad", True),
    ("inference_mode", True),
    ("grad, parameters frozen", True),
    ("grad, parameters trained", False),
    ("grad, input requires grad", False),
    ("space mesh", False),
])
def test_module_dispatch(mode, takes_op, spy, cpu_kernel):
    x, weight, bias = _inputs((1, 16, 4, 6, 6), torch.float32, True, 5)
    norm = GroupNorm(8, 16, eps=1e-5)
    with torch.no_grad():
        norm.weight.copy_(weight)
        norm.bias.copy_(bias)
    if mode == "grad, parameters frozen":
        norm.requires_grad_(False)
    if mode == "grad, input requires grad":
        norm.requires_grad_(False)
        x.requires_grad_(True)
    if mode == "no_grad":
        with torch.no_grad():
            y = norm(x)
    elif mode == "inference_mode":
        with torch.inference_mode():
            y = norm(x)
    elif mode == "space mesh":
        with torch.no_grad(), spatial_axis(Mesh((0,), "space")):
            y = norm(x)
    else:
        y = norm(x)
    assert len(spy) == int(takes_op)
    assert y.requires_grad == (mode in ("grad, parameters trained", "grad, input requires grad"))
    want = _float64_group_norm(x.detach(), weight, bias, 8)
    assert (y.detach().double() - want).abs().max().item() <= F32_TOL * want.abs().max().item()
    if takes_op:
        assert y.stride() == x.stride()


def test_module_keeps_torch_group_norm_off_the_kernel_devices(spy):
    # the rule's device: the CPU is no kernel device, so a CPU forward keeps torch's GroupNorm
    x, _, _ = _inputs((1, 16, 4, 6, 6), torch.float32, True, 6)
    with torch.no_grad():
        GroupNorm(8, 16)(x)
    assert spy == []
    assert not group_norm.takes_kernel(x) and not group_norm.takes_kernel(x.double())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_single_conv_chain_makes_no_input_copy_after_a_group_norm(dtype, spy, cpu_kernel):
    torch.manual_seed(7)
    chain = nn.Sequential(SingleConv(4, 16, "cgr", num_groups=8), SingleConv(16, 16, "gcr", num_groups=8),
                          SingleConv(16, 8, "gcr", num_groups=8)).eval()
    # channels-last, as K2 hands its output on
    x = torch.randn(1, 4, 6, 8, 8).to(dtype).contiguous(memory_format=torch.channels_last_3d)
    Conv3d.input_copies = 0
    with torch.no_grad():
        y = chain(x)
    assert len(spy) == 3 and Conv3d.input_copies == 0
    assert y.is_contiguous(memory_format=torch.channels_last_3d)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_export_keeps_the_op(tmp_path, dtype, spy, cpu_kernel):
    model_config = {**MODEL_3D, **({"dtype": dtype} if dtype else {})}
    torch.manual_seed(8)
    meta = export_model({"device": "cpu", "model": model_config}, None, str(tmp_path / "m.u3dx"),
                        patch_shape=(8, 8, 8), batch=2)
    assert group_norm.OP_NAME in meta["custom_ops"]
    port = load_exported(tmp_path / "m.u3dx")
    targets = [str(node.target) for node in port.program.graph.nodes]
    torch.manual_seed(8)
    eager = ServingForward(get_model(model_config).eval())
    x = np.random.RandomState(9).rand(2, 8, 8, 8, 1).astype(np.float32)
    spy.clear()
    with torch.no_grad():
        want = eager(torch.from_numpy(x)).numpy()
    # every GroupNorm module call of the eager forward is a call of the op in the graph, and no other GroupNorm
    assert len(spy) >= 4 and targets.count("pytorch3dunet_tpu_torch.group_norm_fwd.default") == len(spy)
    assert not any("group_norm" in t and "pytorch3dunet" not in t for t in targets)
    np.testing.assert_array_equal(port(x), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("storage", ["ncdhw", "ndhwc", "transposed"])
def test_op_passes_opcheck(storage, dtype):
    x, weight, bias = _inputs((2, 8, 3, 4, 5), dtype, storage == "ndhwc", 10)
    if storage == "transposed":
        # dense, in neither layout: the fake and the real output share x's strides
        x = x.transpose(3, 4)
        assert group_norm.launch_layout(x) is None
    torch.library.opcheck(group_norm.group_norm_op, (x, weight, bias, 4, 1e-5))
    torch.library.opcheck(group_norm.group_norm_op, (x, None, None, 2, 1e-5))


@pytest.mark.parametrize("case", ["float16", "groups", "weight shape", "rank"])
def test_bad_inputs_raise(case):
    x, weight, bias = _inputs((1, 6, 2, 3, 4), torch.float32, False, 11)
    groups = 4 if case == "groups" else 3
    if case == "float16":
        x = x.half()
    if case == "weight shape":
        weight = weight[:4]
    if case == "rank":
        x = x[:, :, 0, 0, 0]
    with pytest.raises((TypeError, ValueError)):
        group_norm.group_norm_op(x, weight, bias, groups, 1e-5)


# (model, spatial, switches): fused decoders at exact halvings, generic ones
# where a size is odd, the mixed decoder, the switch off, GroupNorm after the
# conv, the ResNet families, 2D (read from the last two axes), BatchNorm
PLAN_CASES = [
    ("UNet3D", {}, (8, 16, 16), {}),
    ("UNet3D", {}, (9, 17, 16), {}),
    ("UNet3D", {}, (8, 18, 17), {"P3DUNET_FUSED_DECODER_MIXED": "1"}),
    ("UNet3D", {}, (8, 16, 16), {"P3DUNET_FUSED_DECODER": "0"}),
    ("UNet3D", {"layer_order": "cgr"}, (8, 16, 16), {}),
    ("UNet3D", {"layer_order": "bcr"}, (8, 16, 16), {}),
    ("ResidualUNet3D", {}, (8, 16, 16), {}),
    ("ResidualUNetSE3D", {}, (8, 16, 16), {}),
    ("UNet2D", {}, (1, 32, 32), {}),
    ("UNet2D", {}, (1, 34, 31), {}),
    ("ResidualUNet2D", {}, (1, 32, 32), {}),
]


@pytest.mark.parametrize("name, options, spatial, switches", PLAN_CASES)
def test_group_norm_plan_names_the_module_calls_of_a_forward(name, options, spatial, switches, monkeypatch):
    for key, value in switches.items():
        monkeypatch.setenv(key, value)
    torch.manual_seed(12)
    model = get_model({**MODEL_3D, "name": name, "num_levels": 3, **options}).eval()
    calls = []
    for module_name, module in model.named_modules():
        if isinstance(module, nn.GroupNorm):
            module.register_forward_pre_hook(lambda m, args, module_name=module_name: calls.append(module_name))
    x = torch.randn(1, 1, *(spatial if model.is3d else spatial[1:]))
    with torch.no_grad():
        model(x)
    assert group_norm_plan(model, spatial) == calls
    assert (calls == []) == (options.get("layer_order") == "bcr")
