"""The U-Net families as torch modules, the counterparts of
pytorch3dunet_tpu/models/unet.py: UNet3D, ResidualUNet3D, ResidualUNetSE3D on
NCDHW tensors, UNet2D and ResidualUNet2D on NCHW tensors (`is3d`,
`is_model_2d`; the trainer and the predictors strip the singleton z of their
(N, C, 1, H, W) batches for a 2D model).

`forward` returns `(probs, logits)` like the JAX `UNetModel.apply`: sigmoid or
softmax over the channel axis for segmentation, the logits twice otherwise.

`model.dtype: bfloat16` (or `bf16`) runs the forward in bfloat16, with the JAX
package's semantics (pytorch3dunet_tpu/models/unet.py `UNetModule`): the input
is cast to bf16, the parameters stay float32 and each layer casts them to its
input's dtype where it uses them (so state dicts and checkpoints are the f32
ones), GroupNorm and BatchNorm compute in float32 on a float32 copy and cast
back, and the logits come back in float32.

`model.remat: true` checkpoints each encoder and decoder level in training
(JAX unet.py:76-79 `nn.remat`): the level keeps only its inputs and runs again
in backward, its 3x3x3 convs on the kernels too. Dropout draws the same masks
on the recompute (`preserve_rng_state`), and BatchNorm's running statistics
move in the forward alone (`blocks.recomputing`).
"""

import contextlib

import torch
import torch.nn as nn
import torch.utils.checkpoint

from pytorch3dunet_tpu_torch.models.blocks import Decoder, Encoder, conv_layer, recomputing
from pytorch3dunet_tpu_torch.ops.conv3d import Conv3d, forward_variant
from pytorch3dunet_tpu_torch.ops.upconv import skipconv_mode, upconv_mode
from pytorch3dunet_tpu_torch.utils.misc import number_of_features_per_level

# `model.dtype` values of the JAX get_model -> the compute dtype (None: float32)
_DTYPES = {None: None, "float32": None, "fp32": None, "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def compute_dtype(value) -> torch.dtype | None:
    """The compute dtype of a config's `model.dtype`: bfloat16, or None for
    float32 (the parameters' own dtype)."""
    if value not in _DTYPES:
        raise ValueError(f"model.dtype {value!r} not understood -- supported values: {sorted(map(str, _DTYPES))}")
    return _DTYPES[value]


def _resolve_upsample(upsample, basic_module: str) -> tuple[str | None, bool]:
    """('default' | mode | None | 'none') -> (mode, concat), as JAX
    unet.py:37-47: 'default' is nearest with concat joins for DoubleConv,
    deconv with sum joins for the ResNet blocks; a named mode joins by concat;
    None and 'none' do not resize and join by concat."""
    if upsample is None or upsample == "none":
        return None, True
    if upsample == "default":
        return ("nearest", True) if basic_module == "DoubleConv" else ("deconv", False)
    return upsample, True


class UNet3D(nn.Module):
    """3D U-Net (Cicek et al., arXiv:1606.06650): DoubleConv blocks, max-pool
    down, nearest up, concat joins, a 1x1 final conv. The subclasses change the
    basic module, the rank and the default depth. `conv_kernel_size` and
    `conv_padding` (ints or per-axis tuples) and `conv_upscale` reach every
    block as in JAX unet.py `UNetModule`."""

    basic_module = "DoubleConv"
    is3d = True
    default_num_levels = 4

    def __init__(self, in_channels: int, out_channels: int, final_sigmoid: bool = True, f_maps=64,
                 layer_order: str = "gcr", num_groups: int = 8, num_levels: int | None = None,
                 is_segmentation: bool = True, conv_kernel_size=3, pool_kernel_size=2, conv_padding=1,
                 conv_upscale: int = 2, dropout_prob=0.1, upsample="default", dtype=None, remat: bool = False):
        super().__init__()
        self.remat = bool(remat)
        if isinstance(f_maps, int):
            f_maps = number_of_features_per_level(f_maps, num_levels=num_levels or self.default_num_levels)
        assert isinstance(f_maps, (list, tuple)) and len(f_maps) > 1, "Required at least 2 levels in the U-Net"
        self.final_sigmoid = final_sigmoid
        self.is_segmentation = is_segmentation
        self.out_channels = out_channels
        # bfloat16 or None (float32); the parameters stay float32 either way
        self.compute_dtype = compute_dtype(dtype)

        common = dict(order=layer_order, num_groups=num_groups, dropout_prob=dropout_prob,
                      basic_module=self.basic_module, conv_kernel_size=conv_kernel_size, padding=conv_padding,
                      is3d=self.is3d)
        self.encoders = nn.ModuleList()
        for i, out_feature_num in enumerate(f_maps):
            in_feature_num = in_channels if i == 0 else f_maps[i - 1]
            self.encoders.append(Encoder(in_feature_num, out_feature_num, apply_pooling=i > 0,
                                         pool_kernel_size=pool_kernel_size, upscale=conv_upscale, **common))
        mode, concat = _resolve_upsample(upsample, self.basic_module)
        reversed_f_maps = list(reversed(f_maps))
        self.decoders = nn.ModuleList()
        for i in range(len(reversed_f_maps) - 1):
            self.decoders.append(Decoder(reversed_f_maps[i], reversed_f_maps[i + 1], upsample_mode=mode,
                                         concat=concat, scale_factor=pool_kernel_size, **common))
        self.final_conv = conv_layer(f_maps[0], out_channels, 1, 0, is3d=self.is3d)

    def forward(self, x):
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        level = _remat_level if self.remat and self.training and torch.is_grad_enabled() else _run_level
        encoders_features = []
        for encoder in self.encoders:
            x = level(encoder, x)
            encoders_features.insert(0, x)
        # the bottleneck output is the decoder input, not a skip
        for decoder, encoder_features in zip(self.decoders, encoders_features[1:]):
            x = level(decoder, encoder_features, x)
        logits = self.final_conv(x).float()
        if not self.is_segmentation:
            return logits, logits
        probs = torch.sigmoid(logits) if self.final_sigmoid else torch.softmax(logits, dim=1)
        return probs, logits


def _run_level(module, *inputs):
    return module(*inputs)


def _remat_level(module, *inputs):
    """The level kept as its inputs and run again in backward."""
    return torch.utils.checkpoint.checkpoint(module, *inputs, use_reentrant=False,
                                             context_fn=lambda: (contextlib.nullcontext(), recomputing()))


class ResidualUNet3D(UNet3D):
    """Residual 3D U-Net (arXiv:1706.00120): ResNet blocks, deconv upsampling,
    summation joins, 5 levels by default."""

    basic_module = "ResNetBlock"
    default_num_levels = 5


class ResidualUNetSE3D(UNet3D):
    """Residual 3D U-Net with scSE squeeze-and-excitation after every ResNet
    block, 5 levels by default."""

    basic_module = "ResNetBlockSE"
    default_num_levels = 5


class UNet2D(UNet3D):
    """2D U-Net (Ronneberger et al., arXiv:1505.04597) on (N, C, H, W):
    DoubleConv blocks, 4 levels by default."""

    is3d = False


class ResidualUNet2D(UNet3D):
    """Residual 2D U-Net on (N, C, H, W): ResNet blocks, deconv upsampling,
    summation joins, 5 levels by default."""

    basic_module = "ResNetBlock"
    is3d = False
    default_num_levels = 5


def _kernel_convs(block, prefix):
    """(name, module) of the 3x3x3 pad-1 `Conv3d`s of `block` in the order
    they run."""
    return [(f"{prefix}.{name}", m) for name, m in block.named_modules() if isinstance(m, Conv3d) and m.on_kernels]


def _reads_raw_input(block) -> bool:
    """Whether the first conv of encoder 0's `block` reads the model's input
    as it is (no 1x1 projection and no norm before it), so that a train step
    computes no input gradient for it."""
    if isinstance(getattr(block, "conv1", None), nn.Module) and not isinstance(block.conv1, nn.Identity):
        return False
    unit = block.SingleConv1 if hasattr(block, "SingleConv1") else block.conv2
    names = list(unit._modules)
    return not any(next(unit[i].parameters(), None) is not None for i in range(names.index("conv")))


def kernel_conv_plan(model, spatial, space_mesh: bool = False) -> list[tuple[str, tuple, int, str, bool]]:
    """(name, NDHWC input shape at batch 1, F, forward variant, input gradient)
    of every 3x3x3 pad-1 conv that one forward of `model` on an input of
    spatial shape `spatial` runs on the kernels, in order, as the switches are
    set now: each decoder's `fused_mode` (a fused decoder's first conv is two
    K2 convs, the skip branch's at the skip's size and the up-branch's wide
    one at x's, F = 8 Co, or 2 Co depth-only; P3DUNET_UPCONV=phase and
    P3DUNET_SKIPCONV=strided move one of them to the library), the phase
    deconv (one K2 conv, F = 8 Co), and `forward_variant` (P3DUNET_TAPFOLD)
    for the other convs; the pinned ones are "roll" (K2). The last entry says
    whether a train step computes the conv's input gradient (K3): every conv
    but one that reads the raw input. `space_mesh`: under a space mesh, where
    every decoder is the generic one and the deconv the sharded one (the
    count of launches; the shapes are then those of the unsharded input).
    2D models run no kernel: []."""
    if not model.is3d:
        return []
    plan = []
    sizes = []
    size = tuple(spatial)
    for i, encoder in enumerate(model.encoders):
        if encoder.pool_kernel_size is not None:
            size = tuple(s // k for s, k in zip(size, encoder.pool_kernel_size))
        sizes.append(size)
        for j, (name, conv) in enumerate(_kernel_convs(encoder.basic_module, f"encoders.{i}.basic_module")):
            grad = not (i == 0 and j == 0 and _reads_raw_input(encoder.basic_module))
            plan.append((name, (1, *size, conv.in_channels), conv.out_channels, forward_variant(conv.out_channels),
                         grad))
    levels = len(sizes)
    for i, decoder in enumerate(model.decoders):
        skip, x = sizes[levels - 2 - i], sizes[levels - 1 - i]
        prefix = f"decoders.{i}"
        if decoder.upsampling is not None and decoder.upsampling.upsample.phase_path() and not space_mesh:
            plan.append((f"{prefix}.upsampling.upsample.conv_transposed", (1, *x, decoder.in_channels),
                         8 * decoder.out_channels, "roll", True))
        mode = None if space_mesh else decoder.fused_mode((1, decoder.out_channels, *skip),
                                                           (1, decoder.in_channels, *x))
        convs = _kernel_convs(decoder.basic_module, f"{prefix}.basic_module")
        if mode is not None:
            (name, conv), convs = convs[0], convs[1:]
            fo = conv.out_channels
            if not (mode == "full" and upconv_mode() == "wide" and skipconv_mode() == "strided"):
                plan.append((f"{name}[skip]", (1, *skip, decoder.out_channels), fo, "roll", True))
            if mode == "mixed":
                plan.append((f"{name}[up]", (1, x[0], *skip[1:], decoder.in_channels), 2 * fo, "roll", True))
            elif upconv_mode() == "wide":
                plan.append((f"{name}[up]", (1, *x, decoder.in_channels), 8 * fo, "roll", True))
        for name, conv in convs:
            plan.append((name, (1, *skip, conv.in_channels), conv.out_channels, forward_variant(conv.out_channels),
                         True))
    return plan


_MODELS = {cls.__name__: cls for cls in (UNet3D, ResidualUNet3D, ResidualUNetSE3D, UNet2D, ResidualUNet2D)}


def get_model(model_config: dict) -> UNet3D:
    """Builds the model named by `model_config['name']` from the JAX
    package's model schema (pytorch3dunet_tpu/models/unet.py `get_model`)."""
    config = dict(model_config)
    name = config.pop("name")
    if name not in _MODELS:
        raise ValueError(f"Unknown model {name!r}")
    return _MODELS[name](**config)


def is_model_2d(model) -> bool:
    """Whether `model` is one of the 2D families (JAX unet.py `is_model_2d`)."""
    return not model.is3d
