"""Tests of the port that need an NVIDIA GPU: each skips without one. They
import neither JAX nor the JAX package, so they run on a machine without
either. On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

(`--noconftest`: tests/conftest.py imports JAX.) Tolerances: a strided
input against its contiguous copy through the same kernel, exactly; the
GroupNorm kernel against its plain version on the card within 1e-5 of max |y|
in float32 (f32 sums in another order), and in bfloat16 within one bfloat16
ulp of each value plus that float32 tolerance (the f32 results differ in their
last bits, and may round to neighbouring bfloat16 values; near 0 the f32
difference itself can pass an ulp).
"""

import numpy as np
import pytest
import torch

from pytorch3dunet_tpu_torch.export import export_model, load_exported
from pytorch3dunet_tpu_torch.models.blocks import GroupNorm
from pytorch3dunet_tpu_torch.ops import conv3d, group_norm

pytestmark = pytest.mark.cuda

MODEL_3D = {"name": "UNet3D", "in_channels": 1, "out_channels": 1, "f_maps": 16, "layer_order": "cgr",
            "num_groups": 4, "num_levels": 2, "final_sigmoid": True}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", sorted(conv3d.KERNELS))
def test_conv_op_reads_a_strided_input_as_its_contiguous_copy(device, variant, dtype):
    rs = np.random.RandomState(16)
    # channels-first storage seen through the NDHWC permute: not contiguous
    x = torch.from_numpy(rs.randn(1, 16, 4, 9, 10).astype(np.float32)).to(device, dtype).permute(0, 2, 3, 4, 1)
    w = torch.from_numpy((rs.rand(3, 3, 3, 16, 64).astype(np.float32) - 0.5) / 12).to(device, dtype)
    b = torch.from_numpy(rs.rand(64).astype(np.float32)).to(device, dtype)
    assert not x.is_contiguous()
    before = conv3d.launches[conv3d.KERNELS[variant]]
    got = conv3d.conv3d_op(x, w, b, variant)
    want = conv3d.conv3d_op(x.contiguous(), w, b, variant)
    assert conv3d.launches[conv3d.KERNELS[variant]] == before + 2
    assert torch.equal(got, want)


def test_artifact_module_reads_a_strided_input_on_the_kernels(device, tmp_path):
    # no normalization baked in and the conv first: the strided input reaches
    # the first conv as it is
    torch.manual_seed(17)
    export_model({"device": "cuda", "model": MODEL_3D}, None, str(tmp_path / "m.u3dx"), patch_shape=(8, 16, 16),
                 batch=2)
    port = load_exported(tmp_path / "m.u3dx")
    wide = torch.from_numpy(np.random.RandomState(18).rand(2, 8, 16, 32, 1).astype(np.float32)).to(device)
    strided = wide[:, :, :, ::2]
    assert not strided.is_contiguous()
    before = conv3d.launches["conv3d_fwd"]
    with torch.no_grad():
        got = port.module(strided)
        want = port.module(strided.contiguous())
    assert conv3d.launches["conv3d_fwd"] > before
    assert torch.equal(got, want)


# (shape, groups, storage): K2's channels-last output at a UNet's widths, NC
# storage as cuDNN and a concat leave it, the 2D families' NCHW, and the
# one-value-a-load paths (a channel count or spatial size no vector divides)
GN_CASES = [((1, 16, 6, 20, 22), 8, "channels_last"), ((2, 32, 5, 9, 11), 8, "channels_last"),
            ((1, 6, 4, 5, 7), 3, "channels_last"), ((1, 512, 3, 4, 4), 8, "channels_last"),
            ((1, 1, 8, 20, 20), 1, "nc"), ((2, 24, 5, 9, 11), 8, "nc"), ((2, 16, 33, 64), 8, "nc"),
            ((1, 192, 2, 3, 5), 8, "transposed"), ((1, 1028, 2, 3, 3), 4, "channels_last")]


def _gn_input(shape, storage, dtype, device, seed=19):
    rs = np.random.RandomState(seed)
    x = torch.from_numpy((rs.randn(*shape) * 2 + 1.5).astype(np.float32)).to(device, dtype)
    if storage == "channels_last":
        x = x.movedim(1, -1).contiguous().movedim(-1, 1)
    if storage == "transposed":
        x = x.transpose(3, 4)
    weight = torch.from_numpy(rs.uniform(0.5, 1.5, shape[1]).astype(np.float32)).to(device)
    bias = torch.from_numpy(rs.uniform(-0.2, 0.2, shape[1]).astype(np.float32)).to(device)
    return x, weight, bias


def _bf16_ulp(v):
    """The spacing of bfloat16 numbers at |v| (8 significant bits)."""
    return 2.0 ** (torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126))) - 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape, groups, storage", GN_CASES)
def test_group_norm_kernel_matches_its_plain_version(device, shape, groups, storage, dtype):
    x, weight, bias = _gn_input(shape, storage, dtype, device)
    group_norm.reset_launches()
    y = group_norm.group_norm_op(x, weight, bias, groups, 1e-5)
    again = group_norm.group_norm_op(x, weight, bias, groups, 1e-5)
    torch.cuda.synchronize()
    suffix = "f32" if dtype == torch.float32 else "bf16"
    assert group_norm.launches == 2 and group_norm.launches_by_dtype == {**dict.fromkeys(("f32", "bf16"), 0),
                                                                        suffix: 2}
    want = group_norm.group_norm_reference(x, weight, bias, groups, 1e-5).float()
    err = (y.float() - want).abs()
    tol = 1e-5 * want.abs().max().item()
    if dtype == torch.float32:
        assert err.max().item() <= tol
    else:
        assert bool((err <= _bf16_ulp(want) + tol).all())
    assert torch.equal(y, again)
    assert y.stride() == x.stride()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("storage", ["nc", "channels_last", "transposed"])
def test_group_norm_op_passes_opcheck_on_cuda(device, storage, dtype):
    x, weight, bias = _gn_input((2, 16, 3, 4, 8), storage, dtype, device, seed=20)
    torch.library.opcheck(group_norm.group_norm_op, (x, weight, bias, 4, 1e-5))
    torch.library.opcheck(group_norm.group_norm_op, (x, None, None, 2, 1e-5))


def test_group_norm_kernel_on_two_streams(device):
    # each stream keeps its own ticket: launches interleaved on two streams
    # give what one stream gives
    x, weight, bias = _gn_input((1, 32, 12, 40, 40), "channels_last", torch.float32, device, seed=21)
    want = group_norm.group_norm_op(x, weight, bias, 8, 1e-5)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = []
    for i in range(6):
        with torch.cuda.stream(streams[i % 2]):
            outs.append(group_norm.group_norm_op(x, weight, bias, 8, 1e-5))
    torch.cuda.synchronize()
    assert all(torch.equal(y, want) for y in outs)


def test_group_norm_module_takes_the_kernel_without_grad(device):
    norm = GroupNorm(8, 32).to(device)
    x = torch.randn(1, 64, 6, 10, 12, device=device)[:, :32]
    before = group_norm.launches
    with torch.no_grad():
        kernel = norm(x)
    assert group_norm.launches == before + 1
    trained = norm(x)
    assert group_norm.launches == before + 1 and trained.requires_grad
    torch.testing.assert_close(kernel, trained.detach(), rtol=0, atol=1e-5)
