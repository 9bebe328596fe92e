"""Dataset utilities and loaders of the port: patch-grid slice builders,
random scaling, stats, padding, and `get_train_loaders` / `get_test_loaders`,
with the multi-process branches of the JAX loaders (parallel/__init__.py has
the device mapping).

The port's own copy of pytorch3dunet_tpu/datasets/utils.py, with parity to the
reference (pytorch3dunet/datasets/utils.py): `SliceBuilder` grid generation
including the tail patch (datasets/utils.py:276-282) and the H/W >= 64 check
(:284-287), `FilterSliceBuilder` label-content filtering with slack acceptance
(:290-350), `RandomScaler` grow/shrink random multi-scale cropping (:16-151),
`calculate_stats` (:499-515), `mirror_pad` / `remove_padding` (:518-565).
Patches are numpy arrays; rescaling uses scipy. The HDF5 datasets need h5py,
which `datasets/hdf5.py` imports only where it reads a file.
"""

from collections.abc import Mapping
from typing import Any

import numpy as np
import torch
from scipy.ndimage import zoom

from pytorch3dunet_tpu_torch.datasets.loader import ConcatDataset, DataLoader
from pytorch3dunet_tpu_torch.parallel import distributed
from pytorch3dunet_tpu_torch.utils.misc import get_class, get_logger, span

logger = get_logger("Dataset")


class ConfigDataset:
    """Abstract dataset configured via a dictionary (reference ConfigDataset,
    datasets/utils.py:154-189)."""

    def __getitem__(self, index):
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    @classmethod
    def create_datasets(cls, dataset_config: dict, phase: str) -> list:
        """Factory: builds one dataset per input file for the given phase."""
        raise NotImplementedError

    @classmethod
    def prediction_collate(cls, batch: list) -> Any:
        return default_prediction_collate(batch)


class SliceBuilder:
    """Builds patch positions over a volume for a given patch/stride shape.

    The grid covers every voxel: after the regular strided positions, a tail
    patch flush with the end of each axis is added when needed.
    """

    def __init__(self, raw_dataset, label_dataset, patch_shape, stride_shape, **kwargs):
        patch_shape = tuple(patch_shape)
        stride_shape = tuple(stride_shape)
        if not kwargs.get("skip_shape_check", False):
            self._check_patch_shape(patch_shape)

        self._raw_slices = self._build_slices(raw_dataset, patch_shape, stride_shape)
        if label_dataset is None:
            self._label_slices = None
        elif raw_dataset.ndim != label_dataset.ndim:
            self._label_slices = self._build_slices(label_dataset, patch_shape, stride_shape)
            assert len(self._raw_slices) == len(self._label_slices)
        else:
            # same ndim implies same shape, so the slices are shared
            self._label_slices = self._raw_slices

    @property
    def raw_slices(self):
        return self._raw_slices

    @property
    def label_slices(self):
        return self._label_slices

    @staticmethod
    def _build_slices(dataset, patch_shape, stride_shape) -> list[tuple[slice, ...]]:
        if dataset.ndim == 4:
            in_channels = dataset.shape[0]
            spatial = dataset.shape[1:]
        else:
            spatial = dataset.shape

        slices = []
        for z in SliceBuilder._gen_indices(spatial[0], patch_shape[0], stride_shape[0]):
            for y in SliceBuilder._gen_indices(spatial[1], patch_shape[1], stride_shape[1]):
                for x in SliceBuilder._gen_indices(spatial[2], patch_shape[2], stride_shape[2]):
                    idx = (
                        slice(z, z + patch_shape[0]),
                        slice(y, y + patch_shape[1]),
                        slice(x, x + patch_shape[2]),
                    )
                    if dataset.ndim == 4:
                        idx = (slice(0, in_channels),) + idx
                    slices.append(idx)
        return slices

    @staticmethod
    def _gen_indices(i, k, s):
        assert i >= k, "Sample size has to be bigger than the patch size"
        j = 0
        for j in range(0, i - k + 1, s):
            yield j
        if j + k < i:
            # tail patch flush with the end of the axis
            yield i - k

    @staticmethod
    def _check_patch_shape(patch_shape):
        assert len(patch_shape) == 3, "patch_shape must be a 3D tuple"
        assert patch_shape[1] >= 64 and patch_shape[2] >= 64, "Height and Width must be greater or equal 64"


class FilterSliceBuilder(SliceBuilder):
    """Rejects patches whose label content is below `threshold`, keeping a
    random `slack_acceptance` fraction anyway."""

    def __init__(self, raw_dataset, label_dataset, patch_shape, stride_shape, ignore_index=None, threshold=0.6,
                 slack_acceptance=0.01, lazy_loader=False, **kwargs):
        super().__init__(raw_dataset, label_dataset, patch_shape, stride_shape, **kwargs)
        if label_dataset is None:
            return
        assert 0 <= threshold <= 1, "Threshold must be in the range [0, 1]"
        assert 0 <= slack_acceptance <= 1, "Slack acceptance must be in the range [0, 1]"

        if not lazy_loader:
            # pull the labels into memory for fast filtering
            label_dataset = label_dataset[()]

        rand_state = np.random.RandomState(47)

        def _keep(raw_label_idx) -> bool:
            patch = label_dataset[raw_label_idx[1]]
            if ignore_index is not None:
                patch = np.copy(patch)
                patch[patch == ignore_index] = 0
            non_ignore_fraction = np.count_nonzero(patch != 0) / patch.size
            return non_ignore_fraction > threshold or rand_state.rand() < slack_acceptance

        filtered = [pair for pair in zip(self.raw_slices, self.label_slices) if _keep(pair)]
        logger.info(
            f"FilterSliceBuilder: Loading {len(filtered)} out of {len(self.raw_slices)} patches: "
            f"{int(100 * len(filtered) / len(self.raw_slices))}%"
        )
        self._raw_slices = [pair[0] for pair in filtered]
        self._label_slices = [pair[1] for pair in filtered]


def get_slice_builder(raw, label, config: dict) -> SliceBuilder:
    assert "name" in config
    logger.info(f"Slice builder config: {config}")
    slice_builder_cls = get_class(config["name"], modules=["pytorch3dunet_tpu_torch.datasets.utils"])
    return slice_builder_cls(raw, label, **config)


class RandomScaler:
    """Randomly grows/shrinks patch coordinates and rescales the patches back
    to `patch_shape` — multi-scale augmentation (datasets/utils.py:16-151).

    Raw patches are rescaled with linear interpolation, label patches with
    nearest-neighbor.
    """

    def __init__(self, scale_range: int, patch_shape: tuple, volume_shape: tuple,
                 execution_probability: float = 0.5, seed: int = 47):
        self.scale_range = scale_range
        self.patch_shape = tuple(patch_shape)
        self.volume_shape = tuple(volume_shape)
        self.execution_probability = execution_probability
        self.rs = np.random.RandomState(seed)

    def randomize_indices(self, raw_idx: tuple, label_idx: tuple) -> tuple[tuple, tuple]:
        if self.rs.uniform() < self.execution_probability:
            return raw_idx, label_idx

        offsets = [self.rs.randint(self.scale_range) for _ in range(3)]
        if self.rs.rand() > 0.5:
            offsets = [-o for o in offsets]
        is_start = self.rs.rand() > 0.5
        raw_idx = self._apply_offsets(raw_idx, offsets, is_start)
        label_idx = self._apply_offsets(label_idx, offsets, is_start)

        raw_spatial = raw_idx[1:] if len(raw_idx) == 4 else raw_idx
        label_spatial = label_idx[1:] if len(label_idx) == 4 else label_idx
        assert raw_spatial == label_spatial, (
            f"Raw and label indices are different: {raw_spatial} != {label_spatial}"
        )
        return raw_idx, label_idx

    def _apply_offsets(self, idx: tuple, offsets: list, is_start: bool) -> tuple:
        spatial_idx = idx[1:] if len(idx) == 4 else idx
        new_idx = []
        for i, o, s in zip(spatial_idx, offsets, self.volume_shape):
            if is_start:
                # grow/shrink from the start, clamped at 0
                new_idx.append(slice(max(0, i.start + o), i.stop))
            else:
                # grow/shrink from the stop, clamped at the volume bound
                new_idx.append(slice(i.start, min(s, i.stop + o)))
        if len(idx) == 4:
            return (idx[0],) + tuple(new_idx)
        return tuple(new_idx)

    def rescale_patches(self, raw_patch: np.ndarray, label_patch: np.ndarray):
        raw_spatial = raw_patch.shape[1:] if raw_patch.ndim == 4 else raw_patch.shape
        if tuple(raw_spatial) == self.patch_shape:
            return raw_patch, label_patch
        raw_patch = self._rescale(raw_patch, order=1)
        label_patch = self._rescale(label_patch, order=0)
        return raw_patch, label_patch

    def _rescale(self, patch: np.ndarray, order: int) -> np.ndarray:
        spatial = patch.shape[1:] if patch.ndim == 4 else patch.shape
        factors = [t / s for t, s in zip(self.patch_shape, spatial)]
        dtype = patch.dtype
        is_int = np.issubdtype(dtype, np.integer)
        work = patch.astype(np.float32) if is_int else patch

        if work.ndim == 4:
            channels = [zoom(c, factors, order=order, grid_mode=True, mode="grid-constant") for c in work]
            out = np.stack(channels, axis=0)
        else:
            out = zoom(work, factors, order=order, grid_mode=True, mode="grid-constant")

        # zoom can be off by one; enforce the exact target shape
        out = _crop_or_pad_to(out, self.patch_shape)
        if is_int:
            out = np.rint(out).astype(dtype)
        return out


def _crop_or_pad_to(arr: np.ndarray, target_spatial: tuple) -> np.ndarray:
    lead = arr.ndim - len(target_spatial)
    slices = tuple([slice(None)] * lead + [slice(0, t) for t in target_spatial])
    arr = arr[slices]
    pads = [(0, 0)] * lead + [(0, t - s) for t, s in zip(target_spatial, arr.shape[lead:])]
    if any(p[1] > 0 for p in pads):
        arr = np.pad(arr, pads, mode="edge")
    return arr


def _dataset_class(loaders_config: dict):
    dataset_cls_str = loaders_config.get("dataset", None)
    if dataset_cls_str is None:
        dataset_cls_str = "StandardHDF5Dataset"
        logger.warning(f"Cannot find dataset class in the config. Using default '{dataset_cls_str}'.")
    return get_class(dataset_cls_str, modules=["pytorch3dunet_tpu_torch.datasets.hdf5",
                                                "pytorch3dunet_tpu_torch.datasets.dsb",
                                                "pytorch3dunet_tpu_torch.datasets.utils"])


def _data_parallel(config: dict) -> bool:
    """Whether training runs data-parallel over the ranks: more than one
    rank and no `trainer.spatial_sharding`, under which every rank reads the
    same batches and takes its own D-slab."""
    return distributed.world_size() > 1 and not config.get("trainer", {}).get("spatial_sharding", False)


def _scaled_batch_size(loaders_config: dict, config: dict) -> int:
    """The batch a host loads: the config's `batch_size` is each rank's, and
    under data parallelism a host loads it for each of its ranks (JAX
    `_scaled_batch_size`: the per-chip batch times the local devices)."""
    batch_size = loaders_config.get("batch_size", 1)
    n = len(distributed.host_ranks())
    if _data_parallel(config) and n > 1:
        logger.info(f"{n} ranks on this host. Using batch_size = {n} * {batch_size}")
        batch_size *= n
    return batch_size


def _sorted_paths(dataset_cls_str: str, file_paths: list) -> list:
    """The file list every host expands and orders alike (directories first:
    sharding a directory entry would hand all its volumes to one host)."""
    if "HDF5" in dataset_cls_str:
        from pytorch3dunet_tpu_torch.datasets.hdf5 import traverse_h5_paths

        return sorted(traverse_h5_paths(file_paths))
    return sorted(file_paths)


def get_train_loaders(config: dict, seed: int | None = None) -> dict:
    """Builds {'train': loader, 'val': loader} from config['loaders']
    (reference: datasets/utils.py:268-347): the train loader shuffles (from
    `seed`, or numpy's global RNG when None), the val loader does not.

    With more than one rank (JAX datasets/utils.py:287-339): under data
    parallelism the train files shard across hosts (`shard_file_paths`), each
    host's batch is the rank batch times its ranks and each rank takes its
    part; every rank caps its epoch at the global minimum batch count (a rank
    with more batches would wait forever in a collective) and drops a ragged
    train batch. Validation files stay whole on every rank, so the scheduler's
    decisions agree. Under `trainer.spatial_sharding` every rank builds the same
    loaders from the same seed and takes its D-slab of each batch."""
    assert "loaders" in config, "Could not find data loaders configuration"
    loaders_config = config["loaders"]
    assert set(loaders_config["train"]["file_paths"]).isdisjoint(loaders_config["val"]["file_paths"]), (
        "Train and validation 'file_paths' overlap. One cannot use validation data for training!"
    )

    logger.info("Creating training and validation set loaders...")
    dataset_cls_str = loaders_config.get("dataset", None) or "StandardHDF5Dataset"
    dataset_class = _dataset_class(loaders_config)
    data_parallel = _data_parallel(config)
    if data_parallel and distributed.process_count() > 1:
        mine = distributed.shard_file_paths(_sorted_paths(dataset_cls_str, loaders_config["train"]["file_paths"]))
        logger.info(f"Multi-host: process {distributed.process_index()} trains on {mine}")
        loaders_config = dict(loaders_config, train=dict(loaders_config["train"], file_paths=mine))
    train_datasets = dataset_class.create_datasets(loaders_config, phase="train")
    val_datasets = dataset_class.create_datasets(loaders_config, phase="val")

    num_workers = loaders_config.get("num_workers", 1)
    batch_size = _scaled_batch_size(loaders_config, config)
    logger.info(f"Number of workers for train/val dataloader: {num_workers}, batch size: {batch_size}")
    # threads by default: forking a process that runs torch's thread pools is unsafe
    worker_mode = loaders_config.get("worker_mode", "thread")
    world = distributed.world_size()
    shard = (distributed.local_rank(), len(distributed.host_ranks())) if data_parallel else None
    train_loader = DataLoader(ConcatDataset(train_datasets), batch_size=batch_size, shuffle=True,
                              num_workers=num_workers, drop_last=world > 1 or loaders_config.get("drop_last", False),
                              seed=seed, worker_mode=worker_mode, shard=shard)
    if world > 1:
        global_min = distributed.all_reduce_int(len(train_loader), op=torch.distributed.ReduceOp.MIN)
        if global_min != len(train_loader):
            logger.info(f"Multi-process: capping train batches/epoch {len(train_loader)} -> {global_min} "
                        "(global minimum across ranks)")
        train_loader.max_batches = global_min
    return {
        "train": train_loader,
        "val": DataLoader(ConcatDataset(val_datasets), batch_size=batch_size, shuffle=False,
                          num_workers=num_workers, worker_mode=worker_mode),
    }


def get_test_loaders(config: dict):
    """Yields one loader per test file (reference: datasets/utils.py:426-475).
    With more than one host each predicts its own share of the files (JAX
    datasets/utils.py:365-386); a host with none yields nothing."""
    assert "loaders" in config, "Could not find data loaders configuration"
    loaders_config = config["loaders"]

    logger.info("Creating test set loaders...")
    if distributed.process_count() > 1:
        dataset_cls_str = loaders_config.get("dataset", None) or "StandardHDF5Dataset"
        paths = _sorted_paths(dataset_cls_str, loaders_config["test"]["file_paths"])
        mine = distributed.shard_file_paths(paths, allow_empty=True)
        logger.info(f"Multi-host: process {distributed.process_index()} predicts {len(mine)}/{len(paths)} files: "
                    f"{mine}")
        loaders_config = dict(loaders_config, test=dict(loaders_config["test"], file_paths=mine))
        if not mine:
            return
    test_datasets = _dataset_class(loaders_config).create_datasets(loaders_config, phase="test")

    num_workers = loaders_config.get("num_workers", 1)
    batch_size = loaders_config.get("batch_size", 1)
    logger.info(f"Number of workers for the dataloader: {num_workers}, batch size: {batch_size}")
    # threads by default: forking a process that runs torch's thread pools is unsafe
    worker_mode = loaders_config.get("worker_mode", "thread")
    for test_dataset in test_datasets:
        collate_fn = getattr(test_dataset, "prediction_collate", default_prediction_collate)
        yield DataLoader(test_dataset, batch_size=batch_size, num_workers=num_workers, collate_fn=collate_fn,
                         worker_mode=worker_mode)


def default_prediction_collate(batch: list) -> Any:
    """Collates (patch, slice-tuple) samples: arrays are stacked, slice tuples
    are kept as a list (datasets/utils.py:478-496)."""
    error_msg = "batch must contain arrays or slice; found {}"
    if isinstance(batch[0], np.ndarray):
        return np.stack(batch, 0)
    elif isinstance(batch[0], tuple) and isinstance(batch[0][0], slice):
        return batch
    elif isinstance(batch[0], (list, tuple)):
        transposed = zip(*batch)
        return [default_prediction_collate(samples) for samples in transposed]
    raise TypeError(error_msg.format(type(batch[0])))


class VolumeStats(Mapping):
    """The read-only statistics `calculate_stats` returns: `mean` and `std`
    computed at once, the percentiles `pmin` (1) and `pmax` (99.6) at the
    first read of either, by the same two `np.percentile` calls (one call
    with both ranks gives other float64 bits), after which the volume is
    released; the caller does not write to the volume before then. A
    `Standardize` pipeline reads only the mean and std, so it never pays for
    the two sorts; every other read form (`{**stats}`, `dict(stats)`, `==`,
    copy, pickle) goes through `__getitem__` and sees the values the eager
    calls give. Two first reads that race both compute the same values."""

    def __init__(self, img, mean, std):
        self._img = img
        self._values = {"pmin": None, "pmax": None, "mean": mean, "std": std}

    def __getitem__(self, key):
        img = self._img
        if key in ("pmin", "pmax") and img is not None:
            with span("p3d.stats"), span("p3d.stats.percentiles"):
                self._values["pmin"] = np.percentile(img, 1)
                self._values["pmax"] = np.percentile(img, 99.6)
            self._img = None
        return self._values[key]

    def __contains__(self, key):
        return key in self._values

    def __iter__(self):
        return iter(self._values)

    def __len__(self):
        return len(self._values)

    def __reduce__(self):
        return dict, (dict(self),)


def calculate_stats(img, skip: bool = False) -> Mapping[str, Any]:
    """Percentile/mean/std statistics over the whole volume (datasets/utils.py:499-515),
    the percentiles deferred to their first read (`VolumeStats`)."""
    if skip:
        return {"pmin": None, "pmax": None, "mean": None, "std": None}
    with span("p3d.stats"):
        return VolumeStats(img, np.mean(img), np.std(img))


def mirror_pad(image: np.ndarray, padding_shape: tuple[int, int, int]) -> np.ndarray:
    """Reflect-pads the volume before patch extraction (datasets/utils.py:518-546)."""
    assert len(padding_shape) == 3, "Padding shape must be specified for each dimension: ZYX"
    if any(p < 0 for p in padding_shape):
        raise ValueError("padding_shape must be non-negative")
    if all(p == 0 for p in padding_shape):
        return image
    pad_width = [(p, p) for p in padding_shape]
    if image.ndim == 4:
        pad_width = [(0, 0)] + pad_width
    return np.pad(image, pad_width, mode="reflect")


def remove_padding(m: np.ndarray, padding_shape) -> np.ndarray:
    """Crops the halo margins off a prediction (datasets/utils.py:549-565)."""
    if padding_shape is None:
        return m
    return m[(..., *(slice(p, -p or None) for p in padding_shape))]
