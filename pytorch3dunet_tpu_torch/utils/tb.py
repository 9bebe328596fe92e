"""TensorBoard for the port's trainer: the image formatter and the writer.

`TensorboardFormatter` is the port's copy of pytorch3dunet_tpu/utils/tb.py
(the reference pytorch3dunet/unet3d/utils.py:115-225): the middle z-slice of
each sample of an (N, C, D, H, W) or (N, D, H, W) numpy batch as `(tag, CHW
image)` pairs, grayscale per channel for raw inputs whose C is not 1 or 3,
argmax painted by `label2rgb` for multi-channel predictions and targets.

`open_writer` imports tensorboardX only when a trainer asks for a writer, so
that importing the port needs none; where tensorboardX is missing it logs one
warning and returns None, and the trainer keeps its scalars in the log.
"""

import numpy as np

from pytorch3dunet_tpu_torch.utils.misc import get_logger
from pytorch3dunet_tpu_torch.utils.ndimage import label2rgb

logger = get_logger("TensorBoard")


def open_writer(log_dir: str):
    """A tensorboardX SummaryWriter on `log_dir`, or None without tensorboardX."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        logger.warning("tensorboardX is not installed: no TensorBoard events are written; "
                       "the scalars stay in the log")
        return None
    return SummaryWriter(log_dir=log_dir)


def _rescale_unit(img: np.ndarray) -> np.ndarray:
    """Min-max rescale to [0, 1]; a constant image becomes zeros (not NaN)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.nan_to_num((img - np.min(img)) / np.ptp(img))


def _as_chw(tag: str, img: np.ndarray) -> tuple:
    """Checks a slice and lifts it to CHW for the SummaryWriter."""
    assert img.ndim == 2 or img.ndim == 3, "Only 2D (HW) and 3D (CHW) images are accepted for display"
    if img.ndim == 2:
        return tag, img[None]
    assert img.shape[0] in (1, 3), "Only (1, H, W) or (3, H, W) images are supported"
    return tag, img


def _label_rgb_chw(label_img: np.ndarray) -> np.ndarray:
    """An integer label plane as a (3, H, W) RGB image."""
    return np.moveaxis(label2rgb(label_img), -1, 0)


class TensorboardFormatter:
    """Turns a batch into (tag, image) pairs for TensorBoard.

    Args:
        skip_last_target: drop the last channel of a target batch.
        log_channelwise: one image per channel of a multi-channel prediction
            instead of its argmax label image.
    """

    def __init__(self, skip_last_target=False, log_channelwise=False, **kwargs):
        self.skip_last_target = skip_last_target
        self.log_channelwise = log_channelwise

    def __call__(self, name: str, batch: np.ndarray) -> list:
        if name == "targets" and self.skip_last_target:
            batch = batch[:, :-1]
        return [_as_chw(tag, img) for tag, img in self._tagged_slices(name, batch)]

    def _tagged_slices(self, name, batch):
        """(tag, image) pairs of every sample's middle z-plane."""
        if batch.ndim == 5:  # (N, C, D, H, W)
            z = batch.shape[2] // 2
            for b, sample in enumerate(batch):
                yield from self._emit_sample(name, b, z, sample[:, z])
        else:  # (N, D, H, W): a label volume without a channel axis
            z = batch.shape[1] // 2
            for b, sample in enumerate(batch):
                yield f"{name}/batch_{b}/slice_{z}", _label_rgb_chw(sample[z])

    def _emit_sample(self, name, b, z, chw):
        """The images of one sample's (C, H, W) middle slice."""
        tag = f"{name}/batch_{b}/slice_{z}"
        if name in ("predictions", "targets"):
            if self.log_channelwise and name == "predictions":
                yield from self._per_channel(name, b, z, chw)
            elif chw.shape[0] == 1:
                yield tag, _rescale_unit(chw)
            else:
                # class probabilities collapse to a label image
                yield tag, _label_rgb_chw(chw.argmax(axis=0))
        elif chw.shape[0] in (1, 3):
            yield tag, _rescale_unit(chw)
        else:
            yield from self._per_channel(name, b, z, chw)

    @staticmethod
    def _per_channel(name, b, z, chw):
        for c, plane in enumerate(chw):
            yield f"{name}/batch_{b}/channel_{c}/slice_{z}", _rescale_unit(plane)
