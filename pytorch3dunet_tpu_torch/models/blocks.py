"""U-Net building blocks as torch modules (NCDHW).

Counterparts of pytorch3dunet_tpu/models/blocks.py. Module names follow the
reference pytorch-3dunet, so state-dict keys are the reference's
(`SingleConv1.groupnorm.weight`, `SingleConv1.conv.weight`, ...), the keys that
pytorch3dunet_tpu/utils/torch_interop.py reads and writes.

The `layer_order` string composes each conv unit: 'c' conv, 'g' GroupNorm,
'b' BatchNorm, 'r' ReLU, 'l' LeakyReLU, 'e' ELU, 'd' dropout, 'D' channel
dropout. The blocks train and predict: in `train()` BatchNorm uses batch
statistics and dropout draws masks, in `eval()` running statistics and the
identity. Every backward but the conv's (ops/conv3d.py `Conv3dFunction`) is
torch's own.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from pytorch3dunet_tpu_torch.ops.conv3d import Conv3d


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
                self.add_module("groupnorm", nn.GroupNorm(groups, channels, eps=1e-5))
            elif char == "b":
                self.add_module("batchnorm", nn.BatchNorm3d(channels, eps=1e-5))
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


class Encoder(nn.Module):
    """Optional 2x2x2 max-pool (floor semantics, as JAX ops/pool.py) then a
    DoubleConv; level 0 does not pool."""

    def __init__(self, in_channels: int, out_channels: int, apply_pooling: bool, pool_kernel_size=2,
                 order: str = "gcr", num_groups: int = 8, dropout_prob=0.1):
        super().__init__()
        self.pool_kernel_size = pool_kernel_size if apply_pooling else None
        self.basic_module = DoubleConv(in_channels, out_channels, True, order, num_groups, dropout_prob)

    def forward(self, x):
        if self.pool_kernel_size is not None:
            x = F.max_pool3d(x, self.pool_kernel_size, stride=self.pool_kernel_size)
        return self.basic_module(x)


class Decoder(nn.Module):
    """Nearest resize to the skip's size, `cat([skip, x])`, DoubleConv: the
    generic decoder of JAX blocks.py:811-843. F.interpolate's nearest index
    rule floor(i * in / out) is the one JAX ops/interp.py `_nearest_resize`
    copies; the JAX package's fused decoder computes the same function."""

    def __init__(self, in_channels: int, out_channels: int, order: str = "gcr", num_groups: int = 8,
                 dropout_prob=0.1):
        super().__init__()
        self.basic_module = DoubleConv(in_channels, out_channels, False, order, num_groups, dropout_prob)

    def forward(self, encoder_features, x):
        x = F.interpolate(x, size=encoder_features.shape[2:], mode="nearest")
        return self.basic_module(torch.cat([encoder_features, x], dim=1))
