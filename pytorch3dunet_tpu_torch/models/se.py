"""Squeeze-and-Excitation blocks as torch modules (NCDHW).

Counterparts of pytorch3dunet_tpu/models/se.py and of the reference
(pytorch3dunet/unet3d/se.py): channel SE (Hu et al., arXiv:1709.01507), spatial
SE and concurrent scSE (Roy et al., arXiv:1803.02579). Module names are the
reference's (`cSE.fc1`, `sSE.conv`), the keys the JAX package's torch interop
reads and writes. Under a space mesh (parallel/spatial.py) the channel squeeze
is the mean over the whole volume: an all-reduced sum over the global voxel count. The JAX layers' optimization barrier (`_guard`) works around
a TPU compiler fault and has no counterpart here. The layers compute in their
input's dtype, with the float32 parameters cast to it.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from pytorch3dunet_tpu_torch.ops.conv3d import cast_to
from pytorch3dunet_tpu_torch.parallel.mesh import all_reduce_sum
from pytorch3dunet_tpu_torch.parallel.spatial import active_spatial_axis
from pytorch3dunet_tpu_torch.utils.misc import span


class ChannelSELayer3D(nn.Module):
    """Channel squeeze & excitation: global-average squeeze, then a two-layer
    MLP gate (fc1, ReLU, fc2, sigmoid) that scales each channel."""

    def __init__(self, num_channels: int, reduction_ratio: int = 2):
        super().__init__()
        reduced = num_channels // reduction_ratio
        self.fc1 = nn.Linear(num_channels, reduced, bias=True)
        self.fc2 = nn.Linear(reduced, num_channels, bias=True)

    def forward(self, x):
        mesh = active_spatial_axis()
        if mesh is None:
            squeezed = x.mean(dim=(2, 3, 4))
        else:
            # a D-slab: the squeeze is the mean over the whole volume, an
            # all-reduced sum over the global voxel count (JAX se.py:59-66)
            total = all_reduce_sum(x.sum(dim=(2, 3, 4), dtype=torch.float32), mesh)
            squeezed = (total / (x[0, 0].numel() * mesh.size)).to(x.dtype)
        hidden = torch.relu(F.linear(squeezed, cast_to(self.fc1.weight, x), cast_to(self.fc1.bias, x)))
        gate = torch.sigmoid(F.linear(hidden, cast_to(self.fc2.weight, x), cast_to(self.fc2.bias, x)))
        return x * gate[:, :, None, None, None]


class SpatialSELayer3D(nn.Module):
    """Spatial squeeze & excitation: a 1x1x1 conv to one channel, sigmoid, and
    the product with every channel."""

    def __init__(self, num_channels: int):
        super().__init__()
        self.conv = nn.Conv3d(num_channels, 1, 1)

    def forward(self, x):
        return x * torch.sigmoid(F.conv3d(x, cast_to(self.conv.weight, x), cast_to(self.conv.bias, x)))


class ChannelSpatialSELayer3D(nn.Module):
    """Concurrent channel and spatial SE, combined by an element-wise max, in
    the span `p3d.se` (the scSE gate's kernels in a profiler's trace)."""

    def __init__(self, num_channels: int, reduction_ratio: int = 2):
        super().__init__()
        self.cSE = ChannelSELayer3D(num_channels, reduction_ratio)
        self.sSE = SpatialSELayer3D(num_channels)

    def forward(self, x):
        with span("p3d.se"):
            return torch.maximum(self.cSE(x), self.sSE(x))
