"""HDF5 patch datasets (in-memory and lazy variants).

The port's own copy of pytorch3dunet_tpu/datasets/hdf5.py. h5py is imported
only where a file is opened, so the module imports without it.

Behavior parity with the reference (pytorch3dunet/datasets/hdf5.py): patch
iteration over raw/label volumes via a SliceBuilder grid, halo-padded indices
in the test phase (hdf5.py:16-20,154-190), global-normalization stats
(:78-84), directory traversal for H5 files (:23-36), in-RAM lazy-on-first-use
caching (StandardHDF5Dataset, :256-281) vs per-access file opens
(LazyHDF5Dataset, :315-332).
"""

from abc import abstractmethod
from pathlib import Path

import numpy as np

from pytorch3dunet_tpu_torch.augment import transforms
from pytorch3dunet_tpu_torch.datasets.utils import (
    ConfigDataset,
    RandomScaler,
    calculate_stats,
    get_slice_builder,
    mirror_pad,
)
from pytorch3dunet_tpu_torch.utils.misc import get_logger

logger = get_logger("HDF5Dataset")

# suffixes recognized when a config entry points at a directory of volumes
H5_SUFFIXES = (".h5", ".hdf", ".hdf5", ".hd5")


def _grow_by_halo(spatial_idx: tuple, halo_shape: tuple):
    """Widens each spatial slice by 2*halo at the stop end — the same patch
    addressed inside the mirror-padded volume (whose origin is shifted by
    halo, so start stays put and stop grows by twice the halo)."""
    if not any(halo_shape):
        return spatial_idx
    return tuple(slice(sl.start, sl.stop + 2 * h) for sl, h in zip(spatial_idx, halo_shape))


def traverse_h5_paths(file_paths: list[str]) -> list[str]:
    """Expands directories into the H5 files they contain (non-recursive)."""
    assert isinstance(file_paths, list)
    expanded = []
    for entry in file_paths:
        p = Path(entry)
        if p.is_dir():
            expanded.extend(str(child) for suffix in H5_SUFFIXES for child in p.glob(f"*{suffix}"))
        else:
            expanded.append(str(p))
    return expanded


# config keys forwarded from the loader config into every dataset instance,
# with their defaults (create_datasets + the subclass constructors share this
# single source of truth instead of repeating a 9-parameter signature)
_DATASET_DEFAULTS = {
    "raw_internal_path": "raw",
    "label_internal_path": "label",
    "global_normalization": False,
    "random_scale": None,
    "random_scale_probability": 0.5,
}


class AbstractHDF5Dataset(ConfigDataset):
    """Patch dataset over one H5 file.

    Args:
        file_path: path to the H5 file with raw data and (optional) labels
        phase: 'train' | 'val' | 'test'
        slice_builder_config: SliceBuilder configuration
        transformer_config: augmentation configuration
        raw_internal_path / label_internal_path: H5 dataset paths
        global_normalization: compute mean/std over the whole raw volume
        random_scale: optional multi-scale patch jitter (see RandomScaler)
        random_scale_probability: NOTE — reference parity preserves the
            reference's inverted gate (its datasets/utils.py:43-46): a draw
            BELOW this value SKIPS the scaling, i.e. the scale actually runs
            with probability 1 - random_scale_probability
    """

    def __init__(self, file_path, phase, slice_builder_config, transformer_config,
                 raw_internal_path="raw", label_internal_path="label",
                 global_normalization=False, random_scale=None, random_scale_probability=0.5):
        assert phase in ("train", "val", "test"), f"unknown phase {phase!r}"
        logger.info(f"{self.__class__.__name__}({phase}) <- {file_path}")
        self.phase = phase
        self.file_path = file_path
        self.raw_internal_path = raw_internal_path
        self.label_internal_path = label_internal_path
        self.halo_shape = tuple(slice_builder_config.get("halo_shape", [0, 0, 0]))

        stats = self._normalization_stats(global_normalization)
        self.transformer = transforms.Transformer(transformer_config, stats)
        self.raw_transform = self.transformer.raw_transform()
        if phase == "test":
            self.label = None
            if not any(self.halo_shape):
                logger.warning(
                    "slice_builder.halo_shape is all-zero: patch seams may show as "
                    "checkerboard artifacts in the stitched prediction (set e.g. "
                    "'halo_shape: [8, 8, 8]')."
                )
        else:
            self.label_transform = self.transformer.label_transform()

        self._build_patch_grid(slice_builder_config)
        self.random_scaler = self._make_random_scaler(
            random_scale, random_scale_probability, slice_builder_config
        )
        self.patch_count = len(self.raw_slices)

    def _open(self, mode="r"):
        import h5py

        return h5py.File(self.file_path, mode)

    def _normalization_stats(self, global_normalization: bool):
        if not global_normalization:
            return calculate_stats(None, True)
        logger.info("Computing global mean/std over the raw volume...")
        with self._open() as f:
            volume = f[self.raw_internal_path][:]
        # offer the loaded volume to the subclass so an in-memory dataset
        # doesn't re-read multi-GB data from disk on first access
        self._consume_stats_volume(volume)
        return calculate_stats(volume)

    def _build_patch_grid(self, slice_builder_config: dict) -> None:
        with self._open() as f:
            raw = f[self.raw_internal_path]
            self.volume_shape = raw.shape[-3:] if raw.ndim == 4 else raw.shape
            label = None
            if self.phase != "test":
                label = f[self.label_internal_path]
                label_spatial = label.shape[-3:] if label.ndim == 4 else label.shape
                assert label_spatial == self.volume_shape, (
                    f"label volume {label_spatial} does not match raw volume {self.volume_shape}"
                )
            logger.info(f"Volume {self.volume_shape}: building the patch grid")
            sb_config = dict(slice_builder_config, lazy_loader=self.is_lazy())
            grid = get_slice_builder(raw, label, sb_config)
            self.raw_slices = grid.raw_slices
            self.label_slices = grid.label_slices

    def _make_random_scaler(self, random_scale, probability, slice_builder_config):
        if random_scale is None:
            return None
        assert isinstance(random_scale, int), "random_scale must be an integer"
        strides = slice_builder_config.get("stride_shape")
        assert all(random_scale < s for s in strides), (
            f"random_scale {random_scale} must stay below every stride in {strides}"
        )
        logger.info(f"RandomScaler active, offset range {random_scale}")
        return RandomScaler(
            random_scale, slice_builder_config.get("patch_shape"), self.volume_shape, probability
        )

    def _consume_stats_volume(self, raw_volume: np.ndarray) -> None:
        """Hook: offered the raw volume loaded for normalization stats.
        Default drops it (lazy datasets must not retain volumes in memory)."""

    @abstractmethod
    def get_raw_patch(self, idx) -> np.ndarray:
        ...

    @abstractmethod
    def get_label_patch(self, idx) -> np.ndarray:
        ...

    @abstractmethod
    def get_raw_padded_patch(self, idx) -> np.ndarray:
        ...

    @abstractmethod
    def is_lazy(self) -> bool:
        ...

    def __getitem__(self, idx: int):
        if idx >= len(self):
            raise StopIteration

        raw_idx = self.raw_slices[idx]
        if self.phase == "test":
            return self._test_item(raw_idx)

        label_idx = self.label_slices[idx]
        if self.random_scaler is None:
            raw = self.raw_transform(self.get_raw_patch(raw_idx))
            return raw, self.label_transform(self.get_label_patch(label_idx))
        raw_idx, label_idx = self.random_scaler.randomize_indices(raw_idx, label_idx)
        raw = self.raw_transform(self.get_raw_patch(raw_idx))
        label = self.label_transform(self.get_label_patch(label_idx))
        return self.random_scaler.rescale_patches(raw, label)

    def _test_item(self, raw_idx):
        if len(raw_idx) == 4:
            # predictor wants only spatial dims; keep the channel slice for the fetch
            raw_idx = raw_idx[1:]
            padded_idx = (slice(None),) + _grow_by_halo(raw_idx, self.halo_shape)
        else:
            padded_idx = _grow_by_halo(raw_idx, self.halo_shape)
        # the predictor strips the halo and places the prediction at raw_idx
        return self.raw_transform(self.get_raw_padded_patch(padded_idx)), raw_idx

    def __len__(self) -> int:
        return self.patch_count

    @classmethod
    def create_datasets(cls, dataset_config: dict, phase: str):
        phase_config = dataset_config[phase]
        forwarded = {k: dataset_config.get(k, default) for k, default in _DATASET_DEFAULTS.items()}
        for file_path in traverse_h5_paths(phase_config["file_paths"]):
            yield cls(
                file_path,
                phase,
                phase_config["slice_builder"],
                phase_config["transformer"],
                **forwarded,
            )


class StandardHDF5Dataset(AbstractHDF5Dataset):
    """Loads the volumes into memory lazily on first access — fast, memory-hungry."""

    def __init__(self, file_path, phase, slice_builder_config, transformer_config, **kwargs):
        # caches must exist BEFORE super().__init__: _consume_stats_volume fires inside it
        self._raw = None
        self._raw_padded = None
        self._label = None
        super().__init__(file_path, phase, slice_builder_config, transformer_config, **kwargs)

    def _consume_stats_volume(self, raw_volume: np.ndarray) -> None:
        # in-memory dataset: the volume read for stats IS the training data
        if self.phase in ("train", "val"):
            self._raw = raw_volume

    def _read_volume(self, internal_path):
        with self._open() as f:
            assert internal_path in f, f"{self.file_path} has no dataset {internal_path!r}"
            return f[internal_path][:]

    def preload(self):
        """Loads the volumes into memory NOW. The process-mode DataLoader
        calls this in the parent before forking its workers, so every worker
        shares the arrays via copy-on-write pages instead of each reading its
        own full copy of the volume (num_workers x volume RAM otherwise).
        Test phase: the halo-padded volume is what workers read, so pad it
        here too (each worker padding its own copy would cost
        num_workers x padded-volume RAM and redundant full-volume reads)."""
        if self.phase in ("train", "val"):
            if self._raw is None:
                self._raw = self._read_volume(self.raw_internal_path)
            if self._label is None and self.label_internal_path is not None:
                with self._open() as f:
                    present = self.label_internal_path in f
                if present:
                    self._label = self._read_volume(self.label_internal_path)
        elif self._raw_padded is None:
            self._raw_padded = mirror_pad(self._read_volume(self.raw_internal_path), self.halo_shape)

    def get_raw_patch(self, idx):
        if self._raw is None:
            self._raw = self._read_volume(self.raw_internal_path)
        return self._raw[idx]

    def get_label_patch(self, idx):
        if self._label is None:
            self._label = self._read_volume(self.label_internal_path)
        return self._label[idx]

    def get_raw_padded_patch(self, idx):
        if self._raw_padded is None:
            self._raw_padded = mirror_pad(self._read_volume(self.raw_internal_path), self.halo_shape)
        return self._raw_padded[idx]

    def is_lazy(self) -> bool:
        return False


class LazyHDF5Dataset(AbstractHDF5Dataset):
    """Reads every patch straight from the file — slow, low memory footprint."""

    def __init__(self, file_path, phase, slice_builder_config, transformer_config, **kwargs):
        super().__init__(file_path, phase, slice_builder_config, transformer_config, **kwargs)
        logger.info("Lazy mode: patches are read from disk on every access")

    def get_raw_patch(self, idx):
        with self._open() as f:
            return f[self.raw_internal_path][idx]

    def get_label_patch(self, idx):
        with self._open() as f:
            return f[self.label_internal_path][idx]

    def preload(self):
        """Lazy datasets stay on disk; the parent only ensures the cached
        'raw_padded' dataset exists BEFORE workers fork — concurrent
        first-access creation would race on the single HDF5 write handle.
        If the file is read-only the padded copy is built in the parent's
        memory instead, so forked workers share it via copy-on-write pages
        rather than each building num_workers x padded-volume copies."""
        if self.phase == "test" and not self._ensure_raw_padded():
            if getattr(self, "_raw_padded_mem", None) is None:
                with self._open() as f:
                    self._raw_padded_mem = mirror_pad(f[self.raw_internal_path][:], self.halo_shape)

    def _expected_padded_shape(self, raw_shape) -> tuple:
        return tuple(s + 2 * h for s, h in zip(raw_shape[-3:], self.halo_shape))

    def _ensure_raw_padded(self) -> bool:
        """Creates the 'raw_padded' cache dataset (reference hdf5.py:315-332);
        returns False when the file is not writable (read-only mount). A stale
        cache from a run with a DIFFERENT halo shape is detected by its shape
        and rebuilt — reusing it would misalign every border patch."""
        try:
            with self._open("a") as f:
                expected = self._expected_padded_shape(f[self.raw_internal_path].shape)
                if "raw_padded" in f and tuple(f["raw_padded"].shape[-3:]) != expected:
                    logger.warning(
                        f"stale 'raw_padded' cache in {self.file_path}: shape "
                        f"{f['raw_padded'].shape} but halo {self.halo_shape} needs {expected} — rebuilding"
                    )
                    del f["raw_padded"]
                if "raw_padded" not in f:
                    logger.info(f"Caching the mirror-padded volume as 'raw_padded' in {self.file_path}")
                    padded = mirror_pad(f[self.raw_internal_path][:], self.halo_shape)
                    f.create_dataset("raw_padded", data=padded, compression="gzip")
            return True
        except OSError:
            return False

    def get_raw_padded_patch(self, idx):
        # the in-memory fallback (built by preload() for read-only files)
        # takes priority: re-probing the file for writability would cost one
        # failed write-open + exception per patch in the hot path
        if getattr(self, "_raw_padded_mem", None) is not None:
            return self._raw_padded_mem[idx]
        with self._open() as f:
            cache = f.get("raw_padded")
            if cache is not None and tuple(cache.shape[-3:]) == \
                    self._expected_padded_shape(f[self.raw_internal_path].shape):
                return cache[idx]
        if self._ensure_raw_padded():
            with self._open() as f:
                return f["raw_padded"][idx]
        # read-only file and no preload: build the in-memory padded copy now
        with self._open() as f:
            self._raw_padded_mem = mirror_pad(f[self.raw_internal_path][:], self.halo_shape)
        return self._raw_padded_mem[idx]

    def is_lazy(self) -> bool:
        return True
