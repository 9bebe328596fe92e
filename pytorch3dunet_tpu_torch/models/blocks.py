"""U-Net building blocks as torch modules (NCDHW, or NCHW in 2D).

Counterparts of pytorch3dunet_tpu/models/blocks.py: SingleConv, DoubleConv,
ResNetBlock, ResNetBlockSE, Encoder, Decoder (nearest, linear, area or deconv
upsampling, or none; concat or sum joins). Module names follow the reference
pytorch-3dunet, so state-dict keys are the reference's
(`SingleConv1.groupnorm.weight`, `conv2.conv.weight`,
`upsampling.upsample.conv_transposed.weight`, ...), the keys that the JAX
package's torch interop reads and writes.

The blocks are rank-generic, as the JAX blocks are through `spatial_rank`:
`is3d=False` builds the 2D families' Conv2d, BatchNorm2d, Dropout2d, 2D
max-pool and ConvTranspose2d. The conv kernel size and padding are ints or
per-axis tuples.

The `layer_order` string composes each conv unit: 'c' conv, 'g' GroupNorm,
'b' BatchNorm, 'r' ReLU, 'l' LeakyReLU, 'e' ELU, 'd' dropout, 'D' channel
dropout. The blocks train and predict: in `train()` BatchNorm uses batch
statistics and dropout draws masks, in `eval()` running statistics and the
identity. Every backward but the 3x3x3 conv's (ops/conv3d.py
`Conv3dFunction`) is torch's own.

A decoder has two formulations of one function, as in JAX. The generic one
resizes x, concatenates and runs the basic module. The fused one
(`Decoder.fused_mode`, `DoubleConv.fused_forward`, ops/upconv.py), which JAX
takes by default wherever it applies, writes no upsampled or concatenated
tensor: the norm before the first conv takes per-branch statistics, the conv
is split by channels, and its up-branch is one K2 conv of the half-res x. A
3D deconv decoder's kernel-3 / stride-2 transposed conv is likewise one K2
conv and a depth-to-space (`phase_conv_transpose`) under P3DUNET_DECONV=phase,
JAX's default; the port's default is cuDNN's transposed conv (ROADMAP F12).
Both run on the generic path's parameters: the state dict is the same.

Each layer computes in its input's dtype with its float32 parameters cast to
it, except the norms, which compute in float32 on a float32 copy of a bfloat16
input and cast back (JAX blocks.py:126-128, 226-236).

Under a space mesh (parallel/spatial.py `spatial_axis`) a block sees a D-slab:
GroupNorm all-reduces its moments, and a deconv decoder takes a 2-plane halo
and gathers its nearest fix-up. Under a data mesh (parallel/mesh.py
`data_axis`) train-mode BatchNorm all-reduces its batch moments (sync BN).
"""

import contextlib
import threading

import torch
import torch.nn as nn
import torch.nn.functional as F

from pytorch3dunet_tpu_torch.models.se import ChannelSpatialSELayer3D
from pytorch3dunet_tpu_torch.ops.conv3d import Conv2d, Conv3d, cast_to
from pytorch3dunet_tpu_torch.ops.upconv import (concat_batch_stats, deconv_mode, fused_decoder_mixed,
                                               fused_decoder_on, fused_up_concat_conv, fused_up_concat_conv_2d,
                                               phase_conv_transpose)
from pytorch3dunet_tpu_torch.parallel.mesh import active_data_axis, all_reduce_sum
from pytorch3dunet_tpu_torch.parallel.spatial import active_spatial_axis, conv_transpose_sharded
from pytorch3dunet_tpu_torch.utils.misc import span

# the upsample modes of a Decoder (JAX unet.py `_resolve_upsample`); None: no resize
UPSAMPLE_MODES = ("nearest", "linear", "bilinear", "trilinear", "area", "deconv", None)


class _Float32Norm:
    """Mixin of the norm layers: a bfloat16 input is normalized in float32
    (statistics and affine) and the result cast back to bfloat16."""

    def forward(self, x):
        if x.dtype == torch.bfloat16:
            return super().forward(x.float()).to(x.dtype)
        return super().forward(x)


def _moments(x, dims, count, mesh):
    """(mean, biased variance) over `dims` of x, each summed locally and
    all-reduced over `mesh`: the mean first, then the squared deviations from
    it (two passes, as exact as the unsharded statistics)."""
    shape = [s if i not in dims else 1 for i, s in enumerate(x.shape)]
    mean = all_reduce_sum(x.sum(dims), mesh) / count
    centered = x - mean.view(shape)
    var = all_reduce_sum((centered * centered).sum(dims), mesh) / count
    return mean, var, centered, shape


class GroupNorm(_Float32Norm, nn.GroupNorm):
    """`nn.GroupNorm` in float32; under a space mesh (parallel/spatial.py)
    the per-(sample, group) moments are all-reduced over the D-slabs and every
    rank normalizes with the global ones (JAX blocks.py:104-118)."""

    def forward(self, x):
        with span("p3d.norm.group"):
            mesh = active_spatial_axis()
            if mesh is None:
                return super().forward(x)
            x32 = x.float() if x.dtype == torch.bfloat16 else x
            n, c = x32.shape[:2]
            groups = x32.unflatten(1, (self.num_groups, c // self.num_groups))
            dims = tuple(range(2, groups.ndim))
            count = groups[0, 0].numel() * mesh.size
            _, var, centered, shape = _moments(groups, dims, count, mesh)
            y = (centered * torch.rsqrt(var + self.eps).view(shape)).flatten(1, 2)
            affine = (1, c) + (1,) * (x32.ndim - 2)
            return (y * self.weight.view(affine) + self.bias.view(affine)).to(x.dtype)


# set while `model.remat` recomputes a level in backward (`recomputing`)
_recompute = threading.local()


@contextlib.contextmanager
def recomputing():
    """While a checkpointed level runs again in backward: BatchNorm normalizes
    with the batch statistics as in the forward, but its running statistics
    and batch count stay as the forward left them, so they move once a step."""
    _recompute.active = True
    try:
        yield
    finally:
        _recompute.active = False


class _BatchNorm(_Float32Norm):
    def forward(self, x):
        mesh = active_data_axis()
        if self.training and mesh is not None:
            x32 = x.float() if x.dtype == torch.bfloat16 else x
            return self._synced(x32, mesh).to(x.dtype)
        if self.training and getattr(_recompute, "active", False):
            # throwaway copies of the running statistics: the same call as
            # the forward's, so autograd saves the same tensors
            x32 = x.float() if x.dtype == torch.bfloat16 else x
            return F.batch_norm(x32, self.running_mean.clone(), self.running_var.clone(), self.weight, self.bias,
                                True, 0.0, self.eps).to(x.dtype)
        return super().forward(x)

    def _synced(self, x, mesh):
        """BatchNorm in train mode with the batch moments all-reduced over the
        data mesh (sync BN): the statistics of the global batch, as the JAX
        step over one global array computes them. The running statistics move
        as torch's do (the unbiased variance, ROADMAP F2), once a step: not
        while a level is recomputed (`recomputing`)."""
        dims = (0, *range(2, x.ndim))
        count = (x.numel() // x.shape[1]) * mesh.size
        mean, var, centered, shape = _moments(x, dims, count, mesh)
        y = centered * torch.rsqrt(var + self.eps).view(shape)
        if self.affine:
            y = y * self.weight.view(shape) + self.bias.view(shape)
        if self.track_running_stats and not getattr(_recompute, "active", False):
            with torch.no_grad():
                self.num_batches_tracked += 1
                factor = (1.0 / float(self.num_batches_tracked) if self.momentum is None else self.momentum)
                self.running_mean.lerp_(mean.detach(), factor)
                self.running_var.lerp_(var.detach() * (count / max(count - 1, 1)), factor)
        return y


class BatchNorm3d(_BatchNorm, nn.BatchNorm3d):
    pass


class BatchNorm2d(_BatchNorm, nn.BatchNorm2d):
    pass


def _per_axis(value, rank: int) -> tuple:
    """An int or a per-axis sequence as a `rank`-tuple (JAX blocks.py `_to_tuple`)."""
    if isinstance(value, (list, tuple)):
        if len(value) != rank:
            raise ValueError(f"Expected an int or a length-{rank} sequence, got {tuple(value)}")
        return tuple(int(v) for v in value)
    return (int(value),) * rank


def conv_layer(in_channels: int, out_channels: int, kernel_size, padding, bias: bool = True, is3d: bool = True):
    """The conv of a 3D (`Conv3d`: the kernels for 3x3x3 pad 1) or 2D
    (`Conv2d`) block."""
    return (Conv3d if is3d else Conv2d)(in_channels, out_channels, kernel_size, padding=padding, bias=bias)


class SingleConv(nn.Sequential):
    """One conv unit built from `order` (JAX blocks.py:168-259): the conv has
    a bias only when no norm is present; a norm before the conv normalizes
    `in_channels`, after it `out_channels`; GroupNorm falls back to one group
    when there are fewer channels than groups."""

    def __init__(self, in_channels: int, out_channels: int, order: str = "gcr", num_groups: int = 8,
                 dropout_prob: float = 0.1, kernel_size=3, padding=1, is3d: bool = True):
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
                self.add_module("conv", conv_layer(in_channels, out_channels, kernel_size, padding, use_bias, is3d))
            elif char == "g":
                groups = 1 if channels < num_groups else num_groups
                assert channels % groups == 0, (
                    f"Expected number of channels in input to be divisible by num_groups. "
                    f"num_channels={channels}, num_groups={groups}"
                )
                self.add_module("groupnorm", GroupNorm(groups, channels, eps=1e-5))
            elif char == "b":
                self.add_module("batchnorm", (BatchNorm3d if is3d else BatchNorm2d)(channels, eps=1e-5))
            elif char == "d":
                self.add_module("dropout", nn.Dropout(p=dropout_prob))
            elif char == "D":
                if is3d:
                    self.add_module("dropout3d", nn.Dropout3d(p=dropout_prob))
                else:
                    self.add_module("dropout2d", nn.Dropout2d(p=dropout_prob))
            else:
                raise ValueError(
                    f"Unsupported layer type '{char}'. MUST be one of ['b', 'g', 'r', 'l', 'e', 'c', 'd', 'D']"
                )


class DoubleConv(nn.Module):
    """Two conv units with the reference channel schedule (JAX blocks.py:262-305):
    in an encoder conv1 goes to out_channels // 2 (to out_channels when
    `upscale` is 1), floored at in_channels; in a decoder to out_channels."""

    def __init__(self, in_channels: int, out_channels: int, encoder: bool, order: str = "gcr",
                 num_groups: int = 8, dropout_prob: float | tuple = 0.1, kernel_size=3, padding=1,
                 upscale: int = 2, is3d: bool = True):
        super().__init__()
        if encoder:
            conv1_out = max(out_channels if upscale == 1 else out_channels // 2, in_channels)
        else:
            conv1_out = out_channels
        dropout1, dropout2 = dropout_prob if isinstance(dropout_prob, (list, tuple)) else (dropout_prob,) * 2
        common = dict(order=order, num_groups=num_groups, kernel_size=kernel_size, padding=padding, is3d=is3d)
        self.SingleConv1 = SingleConv(in_channels, conv1_out, dropout_prob=dropout1, **common)
        self.SingleConv2 = SingleConv(conv1_out, out_channels, dropout_prob=dropout2, **common)

    def forward(self, x):
        return self.SingleConv2(self.SingleConv1(x))

    def fused_forward(self, skip, x):
        """The decoder's DoubleConv over cat([skip, up2x(x)]) with its first
        conv unit fused (`fused_single_conv`): JAX blocks.py:586-610
        `FusedDecoderDoubleConv`, on this module's own parameters."""
        return self.SingleConv2(fused_single_conv(self.SingleConv1, skip, x))


def _batch_norm_fold(bn, skip, xs):
    """(a_c, b_c) of BatchNorm `bn` over concat([skip, up(xs)]) (channels
    last): in training the per-branch batch statistics (`concat_batch_stats`),
    the running statistics moved as torch moves them (the unbiased variance of
    the concat's N * |skip| values a channel, ROADMAP F2), once a step (not
    while `recomputing`); in eval the running statistics."""
    if bn.training:
        mean, var = concat_batch_stats(skip, xs)
        if bn.track_running_stats and not getattr(_recompute, "active", False):
            count = skip[..., 0].numel()
            with torch.no_grad():
                bn.num_batches_tracked += 1
                factor = 1.0 / float(bn.num_batches_tracked) if bn.momentum is None else bn.momentum
                bn.running_mean.lerp_(mean.detach(), factor)
                bn.running_var.lerp_(var.detach() * (count / max(count - 1, 1)), factor)
    else:
        mean, var = bn.running_mean, bn.running_var
    a_c = torch.rsqrt(var + bn.eps) * bn.weight
    return a_c, bn.bias - mean * a_c


def fused_single_conv(single, skip, x):
    """SingleConv `single` over cat([skip, up2x(x)]) (NCDHW or NCHW) computed
    fused (ops/upconv.py `fused_up_concat_conv`): the norm before the conv
    (GroupNorm, BatchNorm or none) folded into per-branch statistics, the conv
    split by channels, the up-branch as phase convs of the half-res x; then the
    modules after the conv as they are. JAX blocks.py:452-535
    `FusedUpConcatConv1`, on the generic module's parameters (the same state
    dict keys)."""
    names = list(single._modules)
    ci = names.index("conv")
    conv = single.conv
    rank = skip.ndim - 2
    skip_cl, x_cl = skip.movedim(1, -1), x.movedim(1, -1)
    norm = {}
    if ci:
        pre = single[ci - 1]
        if isinstance(pre, nn.GroupNorm):
            norm = dict(num_groups=pre.num_groups, gn_scale=pre.weight, gn_bias=pre.bias, eps=pre.eps)
        else:
            norm = dict(affine=_batch_norm_fold(pre, skip_cl, x_cl))
    fused = fused_up_concat_conv if rank == 3 else fused_up_concat_conv_2d
    kernel = cast_to(conv.weight, skip).permute(*range(2, 2 + rank), 1, 0)
    y = fused(skip_cl, x_cl, kernel, conv_bias=cast_to(conv.bias, skip), dtype=skip.dtype, **norm).movedim(-1, 1)
    for module in list(single)[ci + 1:]:
        y = module(y)
    return y


class ResNetBlock(nn.Module):
    """Residual block (JAX blocks.py:308-368, reference buildingblocks.py:230-288,
    arXiv:1706.00120): a 1x1 projection `conv1` with bias when the channel
    count changes, `conv2` a conv unit of `order`, `conv3` one of `order`
    without its non-linearity, the residual sum, then ReLU, ELU or LeakyReLU
    with slope 0.1, as `order` names. Each axis is padded by (k - 1) // 2 of
    its kernel size, whatever the model's `conv_padding` (as in JAX)."""

    def __init__(self, in_channels: int, out_channels: int, order: str = "cge", num_groups: int = 8,
                 kernel_size=3, is3d: bool = True):
        super().__init__()
        self.conv1 = (conv_layer(in_channels, out_channels, 1, 0, is3d=is3d) if in_channels != out_channels
                      else nn.Identity())
        padding = tuple((k - 1) // 2 for k in _per_axis(kernel_size, 3 if is3d else 2))
        common = dict(num_groups=num_groups, kernel_size=kernel_size, padding=padding, is3d=is3d)
        self.conv2 = SingleConv(out_channels, out_channels, order, **common)
        self.conv3 = SingleConv(out_channels, out_channels, "".join(c for c in order if c not in "rel"), **common)
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
    value any model sets). 3D only, as the only family that uses it."""

    def __init__(self, in_channels: int, out_channels: int, order: str = "cge", num_groups: int = 8,
                 kernel_size=3, is3d: bool = True):
        assert is3d, "ResNetBlockSE is a 3D block"
        super().__init__(in_channels, out_channels, order, num_groups, kernel_size)
        self.se_module = ChannelSpatialSELayer3D(out_channels, reduction_ratio=1)

    def forward(self, x):
        return self.se_module(super().forward(x))


def make_basic_module(basic_module: str, in_channels: int, out_channels: int, encoder: bool, order: str,
                      num_groups: int, dropout_prob, kernel_size=3, padding=1, upscale: int = 2, is3d: bool = True):
    """The basic module named by a model family (JAX blocks.py:584-609): the
    ResNet blocks take no encoder schedule, padding, upscale or dropout
    probability."""
    if basic_module == "DoubleConv":
        return DoubleConv(in_channels, out_channels, encoder, order, num_groups, dropout_prob, kernel_size, padding,
                          upscale, is3d)
    if basic_module == "ResNetBlock":
        return ResNetBlock(in_channels, out_channels, order, num_groups, kernel_size, is3d)
    if basic_module == "ResNetBlockSE":
        return ResNetBlockSE(in_channels, out_channels, order, num_groups, kernel_size, is3d)
    raise ValueError(f"Unknown basic module {basic_module!r}")


class Encoder(nn.Module):
    """Optional max-pool with stride = window (`pool_kernel_size`, an int or
    per-axis tuple; floor semantics, as JAX ops/pool.py) then a basic module;
    level 0 does not pool."""

    def __init__(self, in_channels: int, out_channels: int, apply_pooling: bool, pool_kernel_size=2,
                 order: str = "gcr", num_groups: int = 8, dropout_prob=0.1, basic_module: str = "DoubleConv",
                 conv_kernel_size=3, padding=1, upscale: int = 2, is3d: bool = True):
        super().__init__()
        self.pool_kernel_size = _per_axis(pool_kernel_size, 3 if is3d else 2) if apply_pooling else None
        self.basic_module = make_basic_module(basic_module, in_channels, out_channels, True, order, num_groups,
                                              dropout_prob, conv_kernel_size, padding, upscale, is3d)

    def forward(self, x):
        if self.pool_kernel_size is not None:
            pool = F.max_pool3d if x.ndim == 5 else F.max_pool2d
            x = pool(x, self.pool_kernel_size, stride=self.pool_kernel_size)
        return self.basic_module(x)


class TransposeConvUpsampling(nn.Module):
    """`upsample.conv_transposed`, a ConvTranspose3d (ConvTranspose2d in 2D)
    with kernel `kernel_size`, stride `scale_factor` and no bias, then a
    nearest resize to the skip's size: the reference's module and keys, and
    the function of JAX blocks.py:736-810 (flax `ConvTranspose` with padding
    (1, 1) on every axis; 2n - 1 voxels from n at kernel 3 / stride 2): the
    library's transposed conv, or in 3D at kernel 3 / stride 2 under
    P3DUNET_DECONV=phase (JAX's default; the port's is "xla", ROADMAP F12)
    `phase_conv_transpose` (ops/upconv.py: one K2 conv with the 8 phase
    kernels embedded, F = 8 Co, and a depth-to-space; `phase_path`). Under a
    space mesh it is the sharded deconv (parallel/spatial.py), as in JAX."""

    class Upsample(nn.Module):
        def __init__(self, in_channels: int, out_channels: int, kernel_size=3, scale_factor=2, is3d: bool = True):
            super().__init__()
            deconv = nn.ConvTranspose3d if is3d else nn.ConvTranspose2d
            self.conv_transposed = deconv(in_channels, out_channels, kernel_size=kernel_size, stride=scale_factor,
                                          padding=1, bias=False)

        def phase_path(self) -> bool:
            """Whether an unsharded forward takes `phase_conv_transpose` (JAX blocks.py:773-796)."""
            conv = self.conv_transposed
            return conv.kernel_size == (3, 3, 3) and conv.stride == (2, 2, 2) and deconv_mode() == "phase"

        def forward(self, x, size):
            conv = self.conv_transposed
            mesh = active_spatial_axis()
            if mesh is not None and x.ndim == 5:
                # a D-slab: 2-plane halo, depth-uncropped deconv, fix-up gather
                return conv_transpose_sharded(x, cast_to(conv.weight, x), mesh, size)
            if self.phase_path():
                # flax's kernel (3, 3, 3, Ci, Co) is torch's weight flipped
                kernel = cast_to(conv.weight, x).flip(2, 3, 4).permute(2, 3, 4, 0, 1)
                return resize(phase_conv_transpose(x.movedim(1, -1), kernel).movedim(-1, 1), size, "nearest")
            # flax pads the stride-dilated input by (1, 1) on each axis: torch's
            # padding k - 2 for k >= 2; at k = 1 the output gains a zero on each side
            padding = tuple(max(k - 2, 0) for k in conv.kernel_size)
            transposed = F.conv_transpose3d if x.ndim == 5 else F.conv_transpose2d
            y = transposed(x, cast_to(conv.weight, x), None, stride=conv.stride, padding=padding)
            zeros = [p for k in reversed(conv.kernel_size) for p in (int(k == 1),) * 2]
            if any(zeros):
                y = F.pad(y, zeros)
            return F.interpolate(y, size=size, mode="nearest")

    def __init__(self, in_channels: int, out_channels: int, kernel_size=3, scale_factor=2, is3d: bool = True):
        super().__init__()
        self.upsample = self.Upsample(in_channels, out_channels, kernel_size, scale_factor, is3d)

    def forward(self, x, size):
        return self.upsample(x, size)


def resize(x, size, mode: str):
    """x resized to the spatial `size` (JAX ops/interp.py `resize_spatial`):
    unchanged when it has that size already. 'nearest' is F.interpolate's
    index rule floor(i * in / out), which JAX `_nearest_resize` copies.
    'linear', 'bilinear' and 'trilinear' all mean linear interpolation with
    half-pixel centres (align_corners=False), bilinear or trilinear by x's
    rank, as JAX maps all three to `jax.image.resize(..., 'linear')`. 'area'
    is torch's adaptive average pooling, as the reference computes it; JAX
    resizes linearly there (ROADMAP F3)."""
    if tuple(x.shape[2:]) == tuple(size):
        return x
    if mode in ("linear", "bilinear", "trilinear"):
        return F.interpolate(x, size=size, mode="trilinear" if x.ndim == 5 else "bilinear", align_corners=False)
    return F.interpolate(x, size=size, mode=mode)


class Decoder(nn.Module):
    """Upsample to the skip's size, join, basic module (JAX blocks.py:811-843).
    `in_channels` are x's (the level below), `out_channels` the skip's and the
    block's.

    `upsample_mode` is one of `UPSAMPLE_MODES`: an interpolation (`resize`),
    'deconv' (`TransposeConvUpsampling` from `in_channels` to `out_channels`
    with kernel `conv_kernel_size` and stride `scale_factor`), or None, which
    joins x as it is (it must have the skip's size already, as under
    `pool_kernel_size: 1`). `concat` joins by `cat([skip, x])`, otherwise by
    the sum `skip + x`.

    Where `fused_mode` says so, the decoder is the JAX package's fused one
    (`DoubleConv.fused_forward`): no upsampled tensor, no concat, the norm's
    statistics per branch, the up-branch as phase convs of x; the same
    parameters and the same function as the generic path, up to fp32
    reassociation."""

    def __init__(self, in_channels: int, out_channels: int, order: str = "gcr", num_groups: int = 8,
                 dropout_prob=0.1, basic_module: str = "DoubleConv", upsample_mode: str | None = "nearest",
                 concat: bool = True, conv_kernel_size=3, padding=1, scale_factor=2, is3d: bool = True):
        super().__init__()
        if upsample_mode not in UPSAMPLE_MODES:
            raise ValueError(f"Unknown upsample mode {upsample_mode!r}; expected one of {UPSAMPLE_MODES}")
        self.upsample_mode = upsample_mode
        self.upsampling = (TransposeConvUpsampling(in_channels, out_channels, conv_kernel_size, scale_factor, is3d)
                           if upsample_mode == "deconv" else None)
        upsampled = out_channels if upsample_mode == "deconv" else in_channels
        self.concat = concat
        self.basic_module = make_basic_module(basic_module, out_channels + upsampled if concat else upsampled,
                                              out_channels, False, order, num_groups, dropout_prob,
                                              conv_kernel_size, padding, 2, is3d)
        self.in_channels, self.out_channels = in_channels, out_channels
        rank = 3 if is3d else 2
        pre = order[:order.index("c")] if "c" in order else None
        # the conditions of JAX `_fused_path_ok` that the construction fixes
        self._fusable = (concat and upsample_mode == "nearest" and basic_module == "DoubleConv"
                         and _per_axis(conv_kernel_size, rank) == (3,) * rank
                         and _per_axis(padding, rank) == (1,) * rank
                         and pre in ("", "g", "b") and all(ch in "gbcrle" for ch in order))
        self._pre_batch_norm = pre == "b"

    def fused_mode(self, skip_shape, x_shape) -> str | None:
        """'full', 'mixed' or None (the generic path) for a skip and an x of
        these NC... shapes: JAX blocks.py:681-715 `_fused_path_ok`. Fused when
        P3DUNET_FUSED_DECODER=1 (the default), the decoder is nearest + concat
        + DoubleConv, its order's part before the conv is '', 'g' or 'b' and
        holds only 'gbcrle', kernel 3 and padding 1 on every axis, the leading
        axis is an exact 2x, and the others are too ('full'), or are not and
        P3DUNET_FUSED_DECODER_MIXED=1 in 3D ('mixed': x resized in H and W,
        only the depth phase-folds). Never under a space mesh. Under a data
        mesh a train-mode BatchNorm before the conv takes the generic path,
        whose BatchNorm all-reduces its moments (sync BN)."""
        if not (self._fusable and fused_decoder_on()):
            return None
        if skip_shape[2] != 2 * x_shape[2]:
            return None
        hw_exact = tuple(skip_shape[3:]) == tuple(2 * s for s in x_shape[3:])
        if not hw_exact and (len(skip_shape) == 4 or not fused_decoder_mixed()):
            return None
        if active_spatial_axis() is not None:
            return None
        if self._pre_batch_norm and self.training and active_data_axis() is not None:
            return None
        return "full" if hw_exact else "mixed"

    def forward(self, encoder_features, x):
        size = encoder_features.shape[2:]
        mode = self.fused_mode(encoder_features.shape, x.shape)
        if mode is not None:
            if mode == "mixed":
                x = resize(x, (x.shape[2], *size[1:]), "nearest")
            return self.basic_module.fused_forward(encoder_features, x)
        if self.upsampling is not None:
            x = self.upsampling(x, size)
        elif self.upsample_mode is not None:
            x = resize(x, size, self.upsample_mode)
        x = torch.cat([encoder_features, x], dim=1) if self.concat else encoder_features + x
        return self.basic_module(x)
