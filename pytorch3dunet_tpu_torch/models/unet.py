"""The 3D U-Net families as torch modules (NCDHW), the counterparts of
pytorch3dunet_tpu/models/unet.py: UNet3D, ResidualUNet3D, ResidualUNetSE3D.

`forward` returns `(probs, logits)` like the JAX `UNetModel.apply`: sigmoid or
softmax over the channel axis for segmentation, the logits twice otherwise.

`model.dtype: bfloat16` (or `bf16`) runs the forward in bfloat16, with the JAX
package's semantics (pytorch3dunet_tpu/models/unet.py `UNetModule`): the input
is cast to bf16, the parameters stay float32 and each layer casts them to its
input's dtype where it uses them (so state dicts and checkpoints are the f32
ones), GroupNorm and BatchNorm compute in float32 on a float32 copy and cast
back, and the logits come back in float32.
"""

import torch
import torch.nn as nn

from pytorch3dunet_tpu_torch.models.blocks import Decoder, Encoder
from pytorch3dunet_tpu_torch.ops.conv3d import Conv3d
from pytorch3dunet_tpu_torch.utils.misc import ITEM_2D, ITEM_TRAINER, not_ported, number_of_features_per_level

# model families of the JAX package that the port does not have yet, with
# the ROADMAP item that ports them
_NOT_PORTED = {"UNet2D": ITEM_2D, "ResidualUNet2D": ITEM_2D}

# `model.dtype` values of the JAX get_model -> the compute dtype (None: float32)
_DTYPES = {None: None, "float32": None, "fp32": None, "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def compute_dtype(value) -> torch.dtype | None:
    """The compute dtype of a config's `model.dtype`: bfloat16, or None for
    float32 (the parameters' own dtype)."""
    if value not in _DTYPES:
        raise ValueError(f"model.dtype {value!r} not understood -- supported values: {sorted(map(str, _DTYPES))}")
    return _DTYPES[value]


def _resolve_upsample(upsample: str, basic_module: str) -> tuple[str, bool]:
    """('default' | mode) -> (mode, concat), as JAX unet.py:37-47: 'default' is
    nearest with concat joins for DoubleConv, deconv with sum joins for the
    ResNet blocks; a named mode joins by concat."""
    if upsample == "default":
        return ("nearest", True) if basic_module == "DoubleConv" else ("deconv", False)
    return upsample, True


class UNet3D(nn.Module):
    """3D U-Net (Cicek et al., arXiv:1606.06650): DoubleConv blocks, max-pool
    down, nearest up, concat joins, a 1x1 final conv. The subclasses change the
    basic module and the default depth."""

    basic_module = "DoubleConv"
    default_num_levels = 4

    def __init__(self, in_channels: int, out_channels: int, final_sigmoid: bool = True, f_maps=64,
                 layer_order: str = "gcr", num_groups: int = 8, num_levels: int | None = None,
                 is_segmentation: bool = True, pool_kernel_size=2, dropout_prob=0.1, upsample: str = "default",
                 dtype=None):
        super().__init__()
        if isinstance(f_maps, int):
            f_maps = number_of_features_per_level(f_maps, num_levels=num_levels or self.default_num_levels)
        assert isinstance(f_maps, (list, tuple)) and len(f_maps) > 1, "Required at least 2 levels in the U-Net"
        self.final_sigmoid = final_sigmoid
        self.is_segmentation = is_segmentation
        self.out_channels = out_channels
        # bfloat16 or None (float32); the parameters stay float32 either way
        self.compute_dtype = compute_dtype(dtype)

        self.encoders = nn.ModuleList()
        for i, out_feature_num in enumerate(f_maps):
            in_feature_num = in_channels if i == 0 else f_maps[i - 1]
            self.encoders.append(Encoder(in_feature_num, out_feature_num, apply_pooling=i > 0,
                                         pool_kernel_size=pool_kernel_size, order=layer_order,
                                         num_groups=num_groups, dropout_prob=dropout_prob,
                                         basic_module=self.basic_module))
        mode, concat = _resolve_upsample(upsample, self.basic_module)
        reversed_f_maps = list(reversed(f_maps))
        self.decoders = nn.ModuleList()
        for i in range(len(reversed_f_maps) - 1):
            self.decoders.append(Decoder(reversed_f_maps[i], reversed_f_maps[i + 1], order=layer_order,
                                         num_groups=num_groups, dropout_prob=dropout_prob,
                                         basic_module=self.basic_module, upsample_mode=mode, concat=concat))
        self.final_conv = Conv3d(f_maps[0], out_channels, kernel_size=1, padding=0)

    def forward(self, x):
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        encoders_features = []
        for encoder in self.encoders:
            x = encoder(x)
            encoders_features.insert(0, x)
        # the bottleneck output is the decoder input, not a skip
        for decoder, encoder_features in zip(self.decoders, encoders_features[1:]):
            x = decoder(encoder_features, x)
        logits = self.final_conv(x).float()
        if not self.is_segmentation:
            return logits, logits
        probs = torch.sigmoid(logits) if self.final_sigmoid else torch.softmax(logits, dim=1)
        return probs, logits


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


_MODELS = {cls.__name__: cls for cls in (UNet3D, ResidualUNet3D, ResidualUNetSE3D)}

# constructor keys of the JAX UNetModel whose non-default values the port does
# not run yet: key -> (accepted values, ROADMAP item)
_UNPORTED_OPTIONS = {
    "conv_kernel_size": ((3,), ITEM_2D),
    "conv_padding": ((1,), ITEM_2D),
    "conv_upscale": ((2,), ITEM_2D),
    "remat": ((False,), ITEM_TRAINER),
}
# the upsampling that the port runs for each basic module; other modes raise
_PORTED_UPSAMPLE = {"DoubleConv": ("default", "nearest"), "ResNetBlock": ("default", "deconv"),
                    "ResNetBlockSE": ("default", "deconv")}


def get_model(model_config: dict) -> UNet3D:
    """Builds the model named by `model_config['name']` from the JAX
    package's model schema (pytorch3dunet_tpu/models/unet.py `get_model`)."""
    config = dict(model_config)
    name = config.pop("name")
    if name in _NOT_PORTED:
        raise not_ported(name, _NOT_PORTED[name])
    if name not in _MODELS:
        raise ValueError(f"Unknown model {name!r}")
    model_class = _MODELS[name]
    options = dict(_UNPORTED_OPTIONS, upsample=(_PORTED_UPSAMPLE[model_class.basic_module], ITEM_2D))
    for key, (accepted, item) in options.items():
        if key in config and config[key] not in accepted:
            raise not_ported(f"model.{key}={model_config[key]!r}", item)
        if key != "upsample":
            config.pop(key, None)
    return model_class(**config)
