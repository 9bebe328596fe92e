"""UNet3D as a torch module (NCDHW), the counterpart of pytorch3dunet_tpu/models/unet.py.

`forward` returns `(probs, logits)` like the JAX `UNetModel.apply`: sigmoid or
softmax over the channel axis for segmentation, the logits twice otherwise.
"""

import torch
import torch.nn as nn

from pytorch3dunet_tpu.utils.misc import number_of_features_per_level
from pytorch3dunet_tpu_torch.models.blocks import Decoder, Encoder
from pytorch3dunet_tpu_torch.ops.conv3d import Conv3d

# model families of the JAX package that the port does not have yet, with
# the ROADMAP item that ports them
_NOT_PORTED = {
    "ResidualUNet3D": "Queue 1 item 7",
    "ResidualUNetSE3D": "Queue 1 item 7",
    "UNet2D": "Queue 1 item 7",
    "ResidualUNet2D": "Queue 1 item 7",
}


class UNet3D(nn.Module):
    """3D U-Net (Cicek et al., arXiv:1606.06650): DoubleConv blocks, max-pool
    down, nearest up, concat joins, a 1x1 final conv."""

    def __init__(self, in_channels: int, out_channels: int, final_sigmoid: bool = True, f_maps=64,
                 layer_order: str = "gcr", num_groups: int = 8, num_levels: int = 4,
                 is_segmentation: bool = True, pool_kernel_size=2, dropout_prob=0.1):
        super().__init__()
        if isinstance(f_maps, int):
            f_maps = number_of_features_per_level(f_maps, num_levels=num_levels)
        assert isinstance(f_maps, (list, tuple)) and len(f_maps) > 1, "Required at least 2 levels in the U-Net"
        self.final_sigmoid = final_sigmoid
        self.is_segmentation = is_segmentation
        self.out_channels = out_channels

        self.encoders = nn.ModuleList()
        for i, out_feature_num in enumerate(f_maps):
            in_feature_num = in_channels if i == 0 else f_maps[i - 1]
            self.encoders.append(Encoder(in_feature_num, out_feature_num, apply_pooling=i > 0,
                                         pool_kernel_size=pool_kernel_size, order=layer_order,
                                         num_groups=num_groups, dropout_prob=dropout_prob))
        reversed_f_maps = list(reversed(f_maps))
        self.decoders = nn.ModuleList()
        for i in range(len(reversed_f_maps) - 1):
            self.decoders.append(Decoder(reversed_f_maps[i] + reversed_f_maps[i + 1], reversed_f_maps[i + 1],
                                         order=layer_order, num_groups=num_groups, dropout_prob=dropout_prob))
        self.final_conv = Conv3d(f_maps[0], out_channels, kernel_size=1, padding=0)

    def forward(self, x):
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


# constructor keys of the JAX UNetModel whose non-default values the port does
# not run yet: key -> (accepted values, ROADMAP item)
_UNPORTED_OPTIONS = {
    "conv_kernel_size": ((3,), "Queue 1 item 7"),
    "conv_padding": ((1,), "Queue 1 item 7"),
    "conv_upscale": ((2,), "Queue 1 item 7"),
    "upsample": (("default", "nearest"), "Queue 1 item 7"),
    "dtype": ((None, "float32", "fp32"), "Queue 1 item 9"),
    "remat": ((False,), "Queue 1 item 9"),
}


def get_model(model_config: dict) -> UNet3D:
    """Builds the model named by `model_config['name']` from the JAX
    package's model schema (pytorch3dunet_tpu/models/unet.py `get_model`)."""
    config = dict(model_config)
    name = config.pop("name")
    if name in _NOT_PORTED:
        raise NotImplementedError(f"{name} is not ported to PyTorch yet (ROADMAP {_NOT_PORTED[name]})")
    if name != "UNet3D":
        raise ValueError(f"Unknown model {name!r}")
    for key, (accepted, item) in _UNPORTED_OPTIONS.items():
        if key in config and config.pop(key) not in accepted:
            raise NotImplementedError(f"model.{key}={model_config[key]!r} is not ported to PyTorch yet "
                                      f"(ROADMAP {item})")
    return UNet3D(**config)
