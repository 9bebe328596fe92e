"""Kaggle DSB2018-style 2D image/mask folder dataset.

The port's own copy of pytorch3dunet_tpu/datasets/dsb.py (reference:
pytorch3dunet/datasets/dsb.py): PNG images under ``<root>/images`` (plus
``<root>/masks`` for train/val), the transformer pipelines applied per sample,
and test-time batches collated as (stacked images, list of source paths).
Images pair with masks by file name, else by sorted order. `imageio` is
imported where a PNG is read, so importing this module needs none.
"""

from pathlib import Path

import numpy as np

from pytorch3dunet_tpu_torch.augment import transforms
from pytorch3dunet_tpu_torch.datasets.utils import ConfigDataset, calculate_stats
from pytorch3dunet_tpu_torch.utils.misc import get_logger

logger = get_logger("DSB2018Dataset")


def _read_image(path: Path, expand_dims: bool) -> np.ndarray:
    """One PNG in the 2D singleton-z convention: grayscale H x W becomes
    (1, H, W); RGB H x W x 3 becomes (3, 1, H, W)."""
    import imageio.v2 as imageio

    img = np.asarray(imageio.imread(path))
    if not expand_dims:
        return img
    if img.ndim == 3:
        return np.moveaxis(img, -1, 0)[:, None, ...]
    return img[None, ...]


def _scan_images(directory: Path) -> list[Path]:
    if not directory.is_dir():
        raise FileNotFoundError(f"{directory} is not a directory")
    files = sorted(p for p in directory.iterdir() if p.is_file())
    if not files:
        raise FileNotFoundError(f"no image files found under {directory}")
    return files


def _pair_masks(image_paths: list[Path], mask_dir: Path) -> list[Path]:
    """Each image's mask: the file of the same name when every image has one,
    otherwise the masks in sorted order (the reference's pairing)."""
    by_name = [mask_dir / p.name for p in image_paths]
    if all(m.exists() for m in by_name):
        return by_name
    by_order = _scan_images(mask_dir)
    if len(by_order) != len(image_paths):
        raise FileNotFoundError(f"cannot pair {len(image_paths)} images with {len(by_order)} masks in {mask_dir}")
    return by_order


def dsb_prediction_collate(batch):
    """Test-time collate: a batch of (image, path) samples becomes
    [stacked images, list of paths]; a batch of bare arrays is stacked."""
    if isinstance(batch[0], np.ndarray):
        return np.stack(batch)
    if isinstance(batch[0], str):
        return list(batch)
    return [dsb_prediction_collate(list(column)) for column in zip(*batch)]


class DSB2018Dataset(ConfigDataset):
    """Folder-of-PNGs dataset: (raw, mask) samples in train and val, (raw,
    path) in test."""

    def __init__(self, root_dir, phase, transformer_config, expand_dims=True):
        if phase not in ("train", "val", "test"):
            raise ValueError(f"phase must be train/val/test, got {phase!r}")
        root = Path(root_dir)
        if not root.is_dir():
            raise FileNotFoundError(f"{root} is not a directory")
        self.phase = phase

        image_paths = _scan_images(root / "images")
        self.file_path = str(root / "images")
        self.paths = [str(p) for p in image_paths]
        self.images = [_read_image(p, expand_dims) for p in image_paths]
        logger.info(f"Loaded {len(self.images)} images from {self.file_path}")

        transformer = transforms.Transformer(transformer_config, calculate_stats(self.images, True))
        self.raw_transform = transformer.raw_transform()

        if phase == "test":
            self.masks = None
            self.masks_transform = None
        else:
            mask_paths = _pair_masks(image_paths, root / "masks")
            self.masks = [_read_image(p, expand_dims) for p in mask_paths]
            self.masks_transform = transformer.label_transform()

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        if not 0 <= idx < len(self.images):
            raise IndexError(idx)
        raw = self.raw_transform(self.images[idx])
        if self.masks is not None:
            return raw, self.masks_transform(self.masks[idx])
        return raw, self.paths[idx]

    @classmethod
    def prediction_collate(cls, batch):
        return dsb_prediction_collate(batch)

    @classmethod
    def create_datasets(cls, dataset_config, phase):
        phase_config = dataset_config[phase]
        return [cls(root_dir=phase_config["file_paths"][0], phase=phase,
                    transformer_config=phase_config["transformer"],
                    expand_dims=dataset_config.get("expand_dims", True))]
