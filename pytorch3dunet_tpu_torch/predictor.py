"""Sliding-window prediction: patch forward, halo crop, stitch.

The counterpart of pytorch3dunet_tpu/predictor.py `StandardPredictor` (host
patch loop). Patches arrive halo-padded; the predicted halo is cropped and the
core is assigned at the patch's index, so at stride == patch stitching is pure
assignment. `__call__` runs an HDF5 test loader and writes a gzip H5 file;
`predict_array` runs the same loop on an in-memory volume.
"""

import time
from pathlib import Path

import numpy as np
import torch

from pytorch3dunet_tpu_torch.augment.transforms import Transformer
from pytorch3dunet_tpu_torch.datasets.utils import SliceBuilder, calculate_stats, mirror_pad, remove_padding
from pytorch3dunet_tpu_torch.utils.misc import get_logger

logger = get_logger("UNetPredictor")


def _get_output_file(dataset, suffix: str = "_predictions", output_dir=None) -> Path:
    file_path = Path(dataset.file_path)
    output_dir = file_path.parent if output_dir is None else Path(output_dir)
    return output_dir / (file_path.stem + suffix + ".h5")


class StandardPredictor:
    """Keeps the stitched prediction in RAM and saves it as gzip H5.

    Args:
        model: one of the port's models, already on `device` and in eval mode.
        output_dir: directory for the prediction H5 files (None: beside the input).
        out_channels: output channels of the model.
        device: torch device the forward runs on.
        output_dataset: name of the H5 dataset for the predictions.
        save_segmentation: save a binarized / argmax segmentation instead of probabilities.
        prediction_channel: save only this channel of the output.
    """

    def __init__(self, model, output_dir, out_channels, device, output_dataset="predictions",
                 save_segmentation=False, prediction_channel=None, **kwargs):
        assert out_channels > 0, f"Invalid number of output channels: {out_channels}"
        for key in ("performance_metric", "tta"):
            if kwargs.get(key):
                raise NotImplementedError(f"predictor.{key} is not ported to PyTorch yet (ROADMAP Queue 1 item 10)")
        self.model = model
        self.output_dir = output_dir
        self.out_channels = out_channels
        self.device = torch.device(device)
        self.output_dataset = output_dataset
        self.save_segmentation = save_segmentation
        self.prediction_channel = prediction_channel

    def _forward(self, batch_ncdhw: np.ndarray) -> np.ndarray:
        """Probabilities of an (N, C, D, H, W) numpy batch, as float32 numpy."""
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(batch_ncdhw, dtype=np.float32)).to(self.device)
            probs, _ = self.model(x)
            return probs.float().cpu().numpy()

    def _stitch(self, batches, prediction_array, halo_shape, probabilities=False):
        """Runs (batch, indices) pairs through the model and writes each
        prediction core into `prediction_array` at its index: as it is saved,
        or all probability channels when `probabilities`."""
        for batch, indices in batches:
            prediction = self._forward(batch)
            if sum(halo_shape) > 0:
                prediction = remove_padding(prediction, halo_shape)
            for pred, index in zip(prediction, indices):
                if probabilities:
                    index = (slice(None),) + tuple(index)
                elif self.save_segmentation:
                    pred = (pred[0] > 0.5) if pred.shape[0] == 1 else np.argmax(pred, axis=0)
                    pred = pred.astype("uint16")
                    index = tuple(index)
                elif self.prediction_channel is None:
                    index = (slice(0, self.out_channels),) + tuple(index)
                else:
                    pred = pred[self.prediction_channel][None]
                    index = (slice(0, 1),) + tuple(index)
                prediction_array[index] = pred

    def _prediction_shape(self, volume_shape) -> tuple:
        if self.save_segmentation:
            return tuple(volume_shape)
        channels = 1 if self.prediction_channel is not None else self.out_channels
        return (channels, *volume_shape)

    def __call__(self, test_loader):
        import h5py

        dataset = test_loader.dataset
        logger.info(f"Processing '{dataset.file_path}'...")
        start = time.perf_counter()
        dtype = "uint16" if self.save_segmentation else "float32"
        prediction_array = np.zeros(self._prediction_shape(dataset.volume_shape), dtype=dtype)
        logger.info(f"Using halo: {dataset.halo_shape}; running inference on {len(test_loader)} batches")
        self._stitch(test_loader, prediction_array, dataset.halo_shape)
        logger.info(f"Finished inference in {time.perf_counter() - start:.2f} seconds")

        output_file = _get_output_file(dataset, output_dir=self.output_dir)
        logger.info(f"Saving predictions to: {output_file}")
        with h5py.File(output_file, "w") as f:
            f.create_dataset(self.output_dataset, data=prediction_array, compression="gzip")

    def patches(self, volume, patch_shape, stride_shape, halo_shape, transformer_config):
        """(patch, index) pairs of an in-memory (D, H, W) volume, as the HDF5
        test dataset makes them with `global_normalization: true`: the
        halo'd patch of the mirror-padded volume, through the raw transforms
        built with the whole volume's statistics."""
        volume = np.asarray(volume)
        raw_transform = Transformer(transformer_config, calculate_stats(volume)).raw_transform()
        padded = mirror_pad(volume, tuple(halo_shape))
        for index in SliceBuilder._build_slices(volume, tuple(patch_shape), tuple(stride_shape)):
            # the same patch inside the padded volume: its origin moves by the
            # halo, so the start stays and the stop grows by twice the halo
            padded_index = tuple(slice(s.start, s.stop + 2 * h) for s, h in zip(index, halo_shape))
            yield raw_transform(padded[padded_index]), index

    def predict_array(self, volume, patch_shape, stride_shape, halo_shape, transformer_config) -> np.ndarray:
        """In-memory sliding-window prediction: (D, H, W) in, (Cout, D, H, W)
        float32 probabilities out (the contract of the JAX `predict_array`)."""
        volume = np.asarray(volume)
        assert volume.ndim == 3, f"expected a (D, H, W) volume, got shape {volume.shape}"
        out = np.zeros((self.out_channels, *volume.shape), dtype=np.float32)
        patches = self.patches(volume, patch_shape, stride_shape, halo_shape, transformer_config)
        self._stitch(((patch[None], [index]) for patch, index in patches), out, tuple(halo_shape),
                     probabilities=True)
        return out
