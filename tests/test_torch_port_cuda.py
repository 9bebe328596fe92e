"""Tests of the port that need an NVIDIA GPU: each skips without one. They
import neither JAX nor the JAX package, so they run on a machine without
either. On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

(`--noconftest`: tests/conftest.py imports JAX.) Tolerances: a strided
input against its contiguous copy through the same kernel, exactly.
"""

import numpy as np
import pytest
import torch

from pytorch3dunet_tpu_torch.export import export_model, load_exported
from pytorch3dunet_tpu_torch.ops import conv3d

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
