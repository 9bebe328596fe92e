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
