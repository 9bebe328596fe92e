"""U-Net building blocks as torch modules (NCDHW).

Counterparts of pytorch3dunet_tpu/models/blocks.py: SingleConv, DoubleConv,
ResNetBlock, ResNetBlockSE, Encoder, Decoder (nearest or deconv upsampling,
concat or sum joins). Module names follow the reference pytorch-3dunet, so
state-dict keys are the reference's (`SingleConv1.groupnorm.weight`,
`conv2.conv.weight`, `upsampling.upsample.conv_transposed.weight`, ...), the
keys that the JAX package's torch interop reads and writes.

The `layer_order` string composes each conv unit: 'c' conv, 'g' GroupNorm,
'b' BatchNorm, 'r' ReLU, 'l' LeakyReLU, 'e' ELU, 'd' dropout, 'D' channel
dropout. The blocks train and predict: in `train()` BatchNorm uses batch
statistics and dropout draws masks, in `eval()` running statistics and the
identity. Every backward but the conv's (ops/conv3d.py `Conv3dFunction`) is
torch's own.

Each layer computes in its input's dtype with its float32 parameters cast to
it, except the norms, which compute in float32 on a float32 copy of a bfloat16
input and cast back (JAX blocks.py:126-128, 226-236).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from pytorch3dunet_tpu_torch.models.se import ChannelSpatialSELayer3D
from pytorch3dunet_tpu_torch.ops.conv3d import Conv3d, cast_to
from pytorch3dunet_tpu_torch.utils.misc import ITEM_2D, not_ported


class _Float32Norm:
    """Mixin of the norm layers: a bfloat16 input is normalized in float32
    (statistics and affine) and the result cast back to bfloat16."""

    def forward(self, x):
        if x.dtype == torch.bfloat16:
            return super().forward(x.float()).to(x.dtype)
        return super().forward(x)


class GroupNorm(_Float32Norm, nn.GroupNorm):
    pass


class BatchNorm3d(_Float32Norm, nn.BatchNorm3d):
    pass


class SingleConv(nn.Sequential):
    """One conv unit built from `order` (JAX blocks.py:168-259): the conv has
    a bias only when no norm is present; a norm before the conv normalizes
    `in_channels`, after it `out_channels`; GroupNorm falls back to one group
    when there are fewer channels than groups."""

    def __init__(self, in_channels: int, out_channels: int, order: str = "gcr", num_groups: int = 8,
                 dropout_prob: float = 0.1):
        super().__init__()
        assert "c" in order, "Conv layer MUST be present"
        assert order[0] not in "rle", "Non-linearity cannot be the first operation in the layer"
        conv_index = order.index("c")
        use_bias = not ("g" in order or "b" in order)
        for i, char in enumerate(order):
            channels = in_channels if i < conv_index else out_channels
            if char == "r":
                self.add_module("ReLU", nn.ReLU(inplace=True))
            elif char == "l":
                self.add_module("LeakyReLU", nn.LeakyReLU(negative_slope=0.01, inplace=True))
            elif char == "e":
                self.add_module("ELU", nn.ELU(inplace=True))
            elif char == "c":
                self.add_module("conv", Conv3d(in_channels, out_channels, 3, padding=1, bias=use_bias))
            elif char == "g":
                groups = 1 if channels < num_groups else num_groups
                assert channels % groups == 0, (
                    f"Expected number of channels in input to be divisible by num_groups. "
                    f"num_channels={channels}, num_groups={groups}"
                )
                self.add_module("groupnorm", GroupNorm(groups, channels, eps=1e-5))
            elif char == "b":
                self.add_module("batchnorm", BatchNorm3d(channels, eps=1e-5))
            elif char == "d":
                self.add_module("dropout", nn.Dropout(p=dropout_prob))
            elif char == "D":
                self.add_module("dropout3d", nn.Dropout3d(p=dropout_prob))
            else:
                raise ValueError(
                    f"Unsupported layer type '{char}'. MUST be one of ['b', 'g', 'r', 'l', 'e', 'c', 'd', 'D']"
                )


class DoubleConv(nn.Module):
    """Two conv units with the reference channel schedule (JAX blocks.py:262-305):
    in an encoder conv1 goes to out_channels // 2 (floored at in_channels),
    in a decoder to out_channels."""

    def __init__(self, in_channels: int, out_channels: int, encoder: bool, order: str = "gcr",
                 num_groups: int = 8, dropout_prob: float | tuple = 0.1):
        super().__init__()
        conv1_out = max(out_channels // 2, in_channels) if encoder else out_channels
        dropout1, dropout2 = dropout_prob if isinstance(dropout_prob, (list, tuple)) else (dropout_prob,) * 2
        self.SingleConv1 = SingleConv(in_channels, conv1_out, order, num_groups, dropout1)
        self.SingleConv2 = SingleConv(conv1_out, out_channels, order, num_groups, dropout2)

    def forward(self, x):
        return self.SingleConv2(self.SingleConv1(x))


class ResNetBlock(nn.Module):
    """Residual block (JAX blocks.py:308-368, reference buildingblocks.py:230-288,
    arXiv:1706.00120): a 1x1 projection `conv1` with bias when the channel
    count changes, `conv2` a conv unit of `order`, `conv3` one of `order`
    without its non-linearity, the residual sum, then ReLU, ELU or LeakyReLU
    with slope 0.1, as `order` names."""

    def __init__(self, in_channels: int, out_channels: int, order: str = "cge", num_groups: int = 8):
        super().__init__()
        self.conv1 = (Conv3d(in_channels, out_channels, kernel_size=1, padding=0) if in_channels != out_channels
                      else nn.Identity())
        self.conv2 = SingleConv(out_channels, out_channels, order, num_groups)
        self.conv3 = SingleConv(out_channels, out_channels, "".join(c for c in order if c not in "rel"), num_groups)
        if "l" in order:
            self.non_linearity = nn.LeakyReLU(negative_slope=0.1, inplace=True)
        elif "e" in order:
            self.non_linearity = nn.ELU(inplace=True)
        else:
            self.non_linearity = nn.ReLU(inplace=True)

    def forward(self, x):
        residual = self.conv1(x)
        return self.non_linearity(self.conv3(self.conv2(residual)) + residual)


class ResNetBlockSE(ResNetBlock):
    """ResNetBlock followed by a concurrent spatial and channel SE module with
    reduction ratio 1 (JAX blocks.py:371-403, whose 'scse' default is the only
    value any model sets)."""

    def __init__(self, in_channels: int, out_channels: int, order: str = "cge", num_groups: int = 8):
        super().__init__(in_channels, out_channels, order, num_groups)
        self.se_module = ChannelSpatialSELayer3D(out_channels, reduction_ratio=1)

    def forward(self, x):
        return self.se_module(super().forward(x))


def make_basic_module(basic_module: str, in_channels: int, out_channels: int, encoder: bool, order: str,
                      num_groups: int, dropout_prob):
    """The basic module named by a model family (JAX blocks.py:584-609): the
    ResNet blocks take no encoder schedule and no dropout probability."""
    if basic_module == "DoubleConv":
        return DoubleConv(in_channels, out_channels, encoder, order, num_groups, dropout_prob)
    if basic_module == "ResNetBlock":
        return ResNetBlock(in_channels, out_channels, order, num_groups)
    if basic_module == "ResNetBlockSE":
        return ResNetBlockSE(in_channels, out_channels, order, num_groups)
    raise ValueError(f"Unknown basic module {basic_module!r}")


class Encoder(nn.Module):
    """Optional 2x2x2 max-pool (floor semantics, as JAX ops/pool.py) then a
    basic module; level 0 does not pool."""

    def __init__(self, in_channels: int, out_channels: int, apply_pooling: bool, pool_kernel_size=2,
                 order: str = "gcr", num_groups: int = 8, dropout_prob=0.1, basic_module: str = "DoubleConv"):
        super().__init__()
        self.pool_kernel_size = pool_kernel_size if apply_pooling else None
        self.basic_module = make_basic_module(basic_module, in_channels, out_channels, True, order, num_groups,
                                              dropout_prob)

    def forward(self, x):
        if self.pool_kernel_size is not None:
            x = F.max_pool3d(x, self.pool_kernel_size, stride=self.pool_kernel_size)
        return self.basic_module(x)


class TransposeConvUpsampling(nn.Module):
    """`upsample.conv_transposed`, a ConvTranspose3d with kernel 3, stride 2,
    padding 1 and no bias (2n-1 voxels from n), then a nearest resize to the
    skip's size: the reference's module and keys, and the function of JAX
    blocks.py:786-797 (`phase_conv_transpose` + `resize_spatial`). The JAX
    package computes this transposed conv outside any Pallas kernel; here it is
    cuDNN's."""

    class Upsample(nn.Module):
        def __init__(self, in_channels: int, out_channels: int):
            super().__init__()
            self.conv_transposed = nn.ConvTranspose3d(in_channels, out_channels, kernel_size=3, stride=2, padding=1,
                                                      bias=False)

        def forward(self, x, size):
            conv = self.conv_transposed
            y = F.conv_transpose3d(x, cast_to(conv.weight, x), None, stride=conv.stride, padding=conv.padding)
            return F.interpolate(y, size=size, mode="nearest")

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.upsample = self.Upsample(in_channels, out_channels)

    def forward(self, x, size):
        return self.upsample(x, size)


class Decoder(nn.Module):
    """Upsample to the skip's size, join, basic module: the generic decoder of
    JAX blocks.py:811-843. `in_channels` are x's (the level below),
    `out_channels` the skip's and the block's.

    `upsample_mode` 'nearest' resizes x (F.interpolate's nearest index rule
    floor(i * in / out) is the one JAX ops/interp.py `_nearest_resize` copies;
    the JAX package's fused decoder computes the same function); 'deconv' runs
    `TransposeConvUpsampling` from `in_channels` to `out_channels`. `concat`
    joins by `cat([skip, x])`, otherwise by the sum `skip + x`."""

    def __init__(self, in_channels: int, out_channels: int, order: str = "gcr", num_groups: int = 8,
                 dropout_prob=0.1, basic_module: str = "DoubleConv", upsample_mode: str = "nearest",
                 concat: bool = True):
        super().__init__()
        if upsample_mode not in ("nearest", "deconv"):
            raise not_ported(f"upsample mode {upsample_mode!r}", ITEM_2D)
        self.upsampling = TransposeConvUpsampling(in_channels, out_channels) if upsample_mode == "deconv" else None
        upsampled = out_channels if upsample_mode == "deconv" else in_channels
        self.concat = concat
        self.basic_module = make_basic_module(basic_module, out_channels + upsampled if concat else upsampled,
                                              out_channels, False, order, num_groups, dropout_prob)

    def forward(self, encoder_features, x):
        size = encoder_features.shape[2:]
        if self.upsampling is not None:
            x = self.upsampling(x, size)
        else:
            x = F.interpolate(x, size=size, mode="nearest")
        x = torch.cat([encoder_features, x], dim=1) if self.concat else encoder_features + x
        return self.basic_module(x)
