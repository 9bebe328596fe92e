"""Sliding-window prediction: patch forward, halo crop, stitch.

The counterparts of pytorch3dunet_tpu/predictor.py `StandardPredictor` (host
patch loop), `LazyPredictor` (the host loop writing into a chunked H5
dataset) and `DeviceSlidingWindowPredictor` (the sweep on the device).

`StandardPredictor`: patches arrive halo-padded from the test loader; the
predicted halo is cropped and the core is assigned at the patch's index, so at
stride == patch stitching is pure assignment. `__call__` runs an HDF5 test
loader and writes a gzip H5 file; `predict_array` runs the same loop on an
in-memory volume. With `performance_metric` ('dice' or 'mean_iou') `__call__`
returns the saved prediction's score against `gt_internal_path` of the input
file (`evaluate` compares two arrays, without h5py).

`DeviceSlidingWindowPredictor`: the volume goes to the device once and the
patch loop, the normalization and the stitching run there
(inference_device.py); volumes over a budget stream through in z-slabs, and the
H5 write of one volume overlaps the next volume's sweep. It is the predict
CLI's default on CUDA.

A 2D model (UNet2D, ResidualUNet2D) predicts the same (z, y, x) patch grid
from depth-1 patches: each batch loses its singleton z before the forward and
gets it back after, and the device sweep feeds the planes of a batch as the
model's batch.

`DSB2018Predictor`: per-image 2D prediction of a folder of PNGs
(datasets/dsb.py), each image's probabilities and their connected components
written to an H5 file (`dsb_save_batch`).
"""

import collections
import os
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from pytorch3dunet_tpu_torch.augment.transforms import Transformer
from pytorch3dunet_tpu_torch.datasets.utils import SliceBuilder, calculate_stats, mirror_pad, remove_padding
from pytorch3dunet_tpu_torch.models.unet import is_model_2d
from pytorch3dunet_tpu_torch.ops.tta import flip_combos, patch_axes_to_array_axes, resolve_tta_axes, tta_average
from pytorch3dunet_tpu_torch.parallel import distributed
from pytorch3dunet_tpu_torch.parallel.mesh import host_mesh
from pytorch3dunet_tpu_torch.parallel.spatial import (spatial_min_local, spatial_pool_d, spatial_shardable,
                                                      validate_spatial_model)
from pytorch3dunet_tpu_torch.utils.misc import get_logger
from pytorch3dunet_tpu_torch.utils.ndimage import label as cc_label

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
        performance_metric: 'dice' or 'mean_iou': score the saved prediction
            against the ground truth; `__call__` returns the score.
        gt_internal_path: H5 path of the ground truth in the input file.
        tta: mirror-flip test-time augmentation: average the probabilities over
            every flip combination of the spatial axes (8 forwards).
        tta_axes: restrict mirroring to these axes (0=z, 1=y, 2=x).
    """

    def __init__(self, model, output_dir, out_channels, device, output_dataset="predictions",
                 save_segmentation=False, prediction_channel=None, performance_metric=None, gt_internal_path=None,
                 tta=False, tta_axes=None, **kwargs):
        assert out_channels > 0, f"Invalid number of output channels: {out_channels}"
        self.model = model
        self.output_dir = output_dir
        self.out_channels = out_channels
        self.device = torch.device(device)
        self.output_dataset = output_dataset
        self.save_segmentation = save_segmentation
        self.prediction_channel = prediction_channel
        self.performance_metric = performance_metric
        self.gt_internal_path = gt_internal_path
        self.tta = tta
        self.tta_axes = tta_axes
        if tta:
            logger.info(f"Test-time mirror augmentation on (axes: {self._tta_patch_axes()})")

    def _tta_patch_axes(self) -> tuple[int, ...]:
        """Patch-space (z, y, x) axes the TTA ensemble mirrors; () when off."""
        return resolve_tta_axes(self.tta, self.tta_axes, is_model_2d(self.model))

    def _tta_wrap(self, run):
        """Wraps a model-ready batch forward `run` with the mirror ensemble."""
        axes = self._tta_patch_axes()
        if not axes:
            return run
        combos = flip_combos(patch_axes_to_array_axes(axes, is_model_2d(self.model)))
        return lambda x: tta_average(run, x, combos)

    def _forward(self, batch_ncdhw: np.ndarray) -> np.ndarray:
        """Probabilities of an (N, C, D, H, W) numpy batch, as float32 numpy;
        a 2D model sees the batch without its singleton z (JAX
        predictor.py:113-135)."""
        two_d = is_model_2d(self.model)
        if two_d and batch_ncdhw.shape[2] != 1:
            raise ValueError(f"a 2D model predicts patches of depth 1, got a batch of shape {batch_ncdhw.shape}")
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(batch_ncdhw, dtype=np.float32)).to(self.device)
            probs = self._tta_wrap(lambda xi: self.model(xi)[0])(x[:, :, 0] if two_d else x)
            return (probs[:, :, None] if two_d else probs).float().cpu().numpy()

    @staticmethod
    def _to_segmentation(probs: np.ndarray, channel_axis: int = 0) -> np.ndarray:
        """Binarize (> 0.5, one channel) or argmax over `channel_axis`, uint16."""
        if probs.shape[channel_axis] == 1:
            return (np.take(probs, 0, axis=channel_axis) > 0.5).astype("uint16")
        return np.argmax(probs, axis=channel_axis).astype("uint16")

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
                    pred = self._to_segmentation(pred)
                    index = tuple(index)
                elif self.prediction_channel is None:
                    index = (slice(0, self.out_channels),) + tuple(index)
                else:
                    pred = pred[self.prediction_channel][None]
                    index = (slice(0, 1),) + tuple(index)
                prediction_array[index] = pred

    def finalize(self):
        """Drains deferred output work. The host loop saves inline, so this is
        a no-op; the predict CLI calls it after the last volume."""

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
        output_file = _get_output_file(dataset, output_dir=self.output_dir)
        logger.info(f"Saving predictions to: {output_file}")
        with h5py.File(output_file, "w") as f:
            prediction_array = self._allocate_prediction_array(self._prediction_shape(dataset.volume_shape), f)
            logger.info(f"Using halo: {dataset.halo_shape}; running inference on {len(test_loader)} batches")
            self._stitch(test_loader, prediction_array, dataset.halo_shape)
            logger.info(f"Finished inference in {time.perf_counter() - start:.2f} seconds")
            self._create_prediction_dataset(f, prediction_array)
            if self.performance_metric is not None:
                return self._evaluate(prediction_array[...], dataset)
        return None

    def _output_dtype(self) -> str:
        return "uint16" if self.save_segmentation else "float32"

    def _allocate_prediction_array(self, output_shape, output_file):
        return np.zeros(output_shape, dtype=self._output_dtype())

    def _create_prediction_dataset(self, output_file, prediction_array):
        output_file.create_dataset(self.output_dataset, data=prediction_array, compression="gzip")

    def _evaluate(self, prediction_array, dataset):
        """The saved prediction's `performance_metric` against the input
        file's `gt_internal_path`."""
        assert self.gt_internal_path is not None
        return evaluate(prediction_array, _load_dataset(dataset, self.gt_internal_path), self.performance_metric,
                        self.out_channels)

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


class LazyPredictor(StandardPredictor):
    """Writes the predicted patches straight into a chunked gzip H5 dataset,
    for volumes that do not fit in host memory."""

    def _allocate_prediction_array(self, output_shape, output_file):
        return output_file.create_dataset(self.output_dataset, shape=output_shape, dtype=self._output_dtype(),
                                          chunks=True, compression="gzip")

    def _create_prediction_dataset(self, output_file, prediction_array):
        """The patches are already in the file."""


def _load_dataset(dataset, internal_path: str) -> np.ndarray:
    import h5py

    with h5py.File(dataset.file_path, "r") as f:
        return f[internal_path][...]


def evaluate(prediction: np.ndarray, gt: np.ndarray, performance_metric: str, n_classes: int):
    """A saved prediction's score against its ground truth: per-channel
    `dice_score` or per-class `mean_iou` (a list, not averaged)."""
    assert performance_metric in ["dice", "mean_iou"], (
        f"Unsupported performance metric: {performance_metric}, only dice and mean_iou are supported")
    if performance_metric == "dice":
        return dice_score(prediction, gt)
    return mean_iou(prediction, gt, n_classes=n_classes)


def mean_iou(pred: np.ndarray, gt: np.ndarray, n_classes: int, avg: bool = False):
    """Per-class IoU of a segmentation against ground truth, background
    skipped; a class absent from both gives NaN (0 / 0)."""
    pred = pred.astype("uint16")
    gt = gt.astype("uint16")
    assert pred.shape == gt.shape, f"Predictions and ground truth have different shapes: {pred.shape} != {gt.shape}"
    per_class_iou = []
    for c in range(1, n_classes):
        intersection = np.logical_and(gt == c, pred == c).sum()
        union = np.logical_or(gt == c, pred == c).sum()
        per_class_iou.append(intersection / union)
    return np.mean(per_class_iou) if avg else per_class_iou


def dice_score(pred: np.ndarray, gt: np.ndarray, avg: bool = False):
    """Dice of each (C, ...) channel of a prediction against ground truth,
    both cast to uint16."""
    pred = pred.astype("uint16")
    gt = gt.astype("uint16")
    assert pred.shape == gt.shape, f"Predictions and ground truth have different shapes: {pred.shape} != {gt.shape}"
    per_class_dice = []
    for c_pred, c_gt in zip(pred, gt):
        intersection = np.logical_and(c_gt, c_pred).sum()
        union = c_gt.sum() + c_pred.sum()
        per_class_dice.append(2 * intersection / union)
    return np.mean(per_class_dice) if avg else per_class_dice


def _read_padded_slab(raw, halo_shape, z_lo: int, z_hi: int) -> np.ndarray:
    """Returns `mirror_pad(volume, halo_shape)[z_lo:z_hi]` as a channels-last
    float32 slab WITHOUT materializing the padded volume.

    `raw` is an h5py dataset or ndarray, (D, H, W) or channels-first
    (C, D, H, W). The z planes are fetched with one contiguous read (reflected
    indices gathered host-side), then H/W are reflect-padded per slab — this
    is how bigger-than-RAM volumes reach the device sweep.
    """
    channels_first = raw.ndim == 4
    depth = int(raw.shape[1] if channels_first else raw.shape[0])
    hz, hy, hx = halo_shape
    if hz >= depth and hz > 0:
        # same condition under which np.pad(mode='reflect') raises in
        # mirror_pad: a single reflection cannot cover the halo
        raise ValueError(f"halo depth {hz} must be smaller than the volume depth {depth}")
    idx = np.arange(z_lo, z_hi) - hz
    idx = np.abs(idx)  # reflect at the top edge
    idx = np.where(idx >= depth, 2 * depth - 2 - idx, idx)  # reflect at the bottom
    lo, hi = int(idx.min()), int(idx.max())
    block = raw[:, lo : hi + 1] if channels_first else raw[lo : hi + 1]
    block = np.asarray(block, dtype=np.float32)
    slab = block[:, idx - lo] if channels_first else block[idx - lo]
    if channels_first:
        slab = np.moveaxis(slab, 0, -1)  # (dz, H, W, C)
    pad = [(0, 0), (hy, hy), (hx, hx)] + ([(0, 0)] if channels_first else [])
    if hy or hx:
        slab = np.pad(slab, pad, mode="reflect")
    return slab


def _plan_slab_grid(spatial, patch_shape, halo_shape, cin, budget, min_slab_z=64):
    """Plans the `patch_mode: slab` geometry: full-xy z-slabs replacing the
    configured (z, y, x) patch grid.

    Each slab covers the whole padded plane, so interior xy seams (and their
    halo'd redundant compute) vanish; the configured halo still mirror-pads
    every patch on all sides, preserving the reference's volume-edge context.
    Slab depth is the largest core z such that the padded slab fits `budget`
    voxels, covered SliceBuilder-style (stride == slab, tail slab shifted flush
    to the end).

    Returns (slab_patch_shape, starts) or None when no slab of at least
    `min_slab_z` (or the configured patch depth, if larger) fits: small
    budgets keep the user's grid rather than degrade it to thin slabs.
    """
    d, h, w = (int(s) for s in spatial)
    hz, hy, hx = halo_shape
    plane = (h + 2 * hy) * (w + 2 * hx) * cin
    slab_z = min(d, int(budget) // plane - 2 * hz)
    if slab_z < d and slab_z < max(min_slab_z, patch_shape[0]):
        return None
    return (slab_z, h, w), _slab_starts(d, slab_z)


def _slab_starts(d, slab_z):
    """SliceBuilder-style z coverage: stride == slab, tail shifted flush."""
    zs = list(range(0, d - slab_z + 1, slab_z))
    if zs[-1] + slab_z < d:
        zs.append(d - slab_z)
    return np.asarray([(z, 0, 0) for z in zs], dtype=np.int32)


def _axis_starts(extent, size):
    """Flush-tail tiling of one axis (the 1-D _slab_starts)."""
    ss = list(range(0, extent - size + 1, size))
    if ss[-1] + size < extent:
        ss.append(extent - size)
    return ss


def _plan_strip_grid(spatial, patch_shape, halo_shape, cin, budget, min_strip=64):
    """Intermediate 'strip' geometry between slab and grid: when the xy plane
    alone exceeds the budget (no full-plane slab can form), plan full-x (or
    full-y) strips — one spatial axis spans the whole volume, so interior seams
    (and their halo'd redundant compute) survive only on the two SHORT axes.

    Both orientations are scored by total padded compute (number of strips x
    padded strip voxels, flush-tail coverage) and the cheaper one wins. Strips
    thinner than `min_strip` (or the configured patch size) on either short
    axis are refused, like thin slabs.

    Returns ((sz, sy, sx), starts) or None.
    """
    d, h, w = (int(s) for s in spatial)
    hz, hy, hx = halo_shape
    floor_z = max(min_strip, patch_shape[0])

    def plan(full_axis):
        # full_axis: 2 -> full-x strips (tile z, y); 1 -> full-y (tile z, x)
        full_len, full_halo = (w, hx) if full_axis == 2 else (h, hy)
        short_len, short_halo = (h, hy) if full_axis == 2 else (w, hx)
        floor_s = max(min_strip, patch_shape[full_axis ^ 3])  # 2^3=1, 1^3=2
        cells = int(budget) // ((full_len + 2 * full_halo) * cin)
        best = None
        for sz in range(min(d, floor_z), min(d, max(floor_z, cells)) + 1):
            ss = cells // (sz + 2 * hz) - 2 * short_halo
            ss = min(ss, short_len)
            if ss < min(short_len, floor_s):
                continue
            n = len(_axis_starts(d, sz)) * len(_axis_starts(short_len, ss))
            padded = n * (sz + 2 * hz) * (ss + 2 * short_halo) * (full_len + 2 * full_halo)
            if best is None or padded < best[0]:
                best = (padded, sz, ss)
        if best is None:
            return None
        _, sz, ss = best
        if full_axis == 2:
            shape = (sz, ss, w)
            starts = [(z, y, 0) for z in _axis_starts(d, sz) for y in _axis_starts(h, ss)]
        else:
            shape = (sz, h, ss)
            starts = [(z, 0, x) for z in _axis_starts(d, sz) for x in _axis_starts(w, ss)]
        return best[0], shape, np.asarray(starts, dtype=np.int32)

    plans = [p for p in (plan(2), plan(1)) if p is not None]
    if not plans:
        return None
    _, shape, starts = min(plans, key=lambda p: p[0])
    return shape, starts


def _plan_plane_grid(spatial, halo_shape, cin, budget, patch_batch):
    """2D arm of `patch_mode: slab`: full-plane depth-1 patches replace the xy
    tile grid, so there are no tile borders and no redundant halo compute, and
    GroupNorm sees the whole plane. `patch_batch` planes go through one
    forward, so the budget bounds patch_batch x the padded plane. Returns
    ((1, H, W), starts) or None."""
    d, h, w = (int(s) for s in spatial)
    _, hy, hx = halo_shape
    if (h + 2 * hy) * (w + 2 * hx) * cin * max(1, patch_batch) > int(budget):
        return None
    return (1, h, w), np.asarray([(z, 0, 0) for z in range(d)], dtype=np.int32)


class DeviceSlidingWindowPredictor(StandardPredictor):
    """Sliding-window prediction with the patch sweep running on the device.

    The mirror-padded volume is uploaded once; the patch loop (slice ->
    normalize -> forward -> halo crop -> stitch) runs on the device and the
    stitched volume comes back once (inference_device.py). Falls back to the
    host loop (`StandardPredictor`, on the same device) for transformer
    pipelines that `detect_device_path` does not map.

    Large volumes: when the padded volume exceeds `max_device_voxels`
    elements, the grid is processed in z-slabs, uploading one sub-volume at a
    time (the device-side counterpart of the LazyPredictor).

    Extra config keys:
        blend: 'assign' (default, reference parity) or 'gaussian'
            (Gaussian-weighted patch blending for overlapping grids).
        shard: split each volume across the ranks of this host (default
            true; one rank: nothing to split). The patch grid splits across
            them, or, when `patch_mode: slab` plans fewer slabs than ranks,
            each slab's depth (the cooperative sweep). A sharded sweep is
            always weighted, so `blend: assign` averages overlapping patches
            there (a warning says so). Only the host's first rank writes the
            output; with `shard: false` it alone predicts.
        max_device_voxels: slab the sweep when the padded volume is larger
            than this many elements (default 1e9).
        patch_batch: patches per forward (default 1 for a 3D model, 16 for a
            2D one, whose depth-1 patches would underfill the card one at a
            time; 24 for a 2D model's full-plane slab plan).
        patch_mode: 'grid' (default) sweeps the configured patch grid
            unchanged (reference-exact patch independence). 'slab' coalesces
            the grid into full-xy z-slabs as deep as `max_patch_voxels`
            allows, so interior patch seams disappear and the halo's redundant
            compute is paid only along z; when no full-plane slab fits, strips
            spanning one full axis; when neither fits, the configured grid
            with a warning. Outputs differ from 'grid' near former interior
            seams. For a 2D model 'slab' predicts whole planes, 24 (else 16,
            at most the stack depth) per forward, when `max_patch_voxels`
            holds them.
        write_behind: run the gzip H5 output write on a background thread so
            the next volume's sweep overlaps it (default true). The previous
            volume's prediction stays in host memory meanwhile; false saves
            inline, and so does a `performance_metric`, which scores the
            saved array.
        max_patch_voxels: padded-voxel budget for one slab forward in 'slab'
            mode (default 2**24).
    """

    def __init__(self, *args, blend="assign", shard=True, max_device_voxels=int(1e9), patch_batch=None,
                 patch_mode="grid", max_patch_voxels=2**24, write_behind=True, **kwargs):
        super().__init__(*args, **kwargs)
        self.blend = blend
        self.write_behind = bool(write_behind)
        self.shard = bool(shard)
        self.max_device_voxels = max_device_voxels
        self.patch_batch = patch_batch
        if patch_mode not in ("grid", "slab"):
            raise ValueError(f"unknown patch_mode {patch_mode!r}: expected 'grid' or 'slab'")
        self.patch_mode = patch_mode
        self.max_patch_voxels = int(max_patch_voxels)
        # the patch_batch of a 2D full-plane slab plan (`_plan_geometry`), which
        # wins over `patch_batch`: the plan clamped it to the stack depth
        self._planned_patch_batch = None
        self._sweeps = {}
        # write-behind output state (_submit_write / finalize)
        self._writer = None
        self._write_future = None

    def _mesh_active(self) -> bool:
        """Whether volumes split across this host's ranks (JAX
        `_mesh_active`: the local devices; each host predicts its own files)."""
        return self.shard and len(distributed.host_ranks()) > 1

    def _participates(self) -> bool:
        """Whether this rank sweeps: every rank of a sharded host, else only
        the host's first rank, which also writes the outputs."""
        return distributed.local_rank() == 0 or self._mesh_active()

    def _get_sweep(self, patch_shape, halo_shape, normalize, stats, spatial_n=0):
        from pytorch3dunet_tpu_torch.inference_device import DeviceSlidingWindow

        host = host_mesh() if self._mesh_active() else None
        spatial_mesh = host if spatial_n > 1 else None
        mesh = host if spatial_mesh is None else None
        patch_batch = self._planned_patch_batch or self.patch_batch or (16 if is_model_2d(self.model) else 1)
        if spatial_mesh is not None:
            patch_batch = 1
        # the key is structural: per-volume stats are passed per call
        key = (tuple(patch_shape), tuple(halo_shape), normalize, patch_batch, mesh is not None, spatial_n)
        if key not in self._sweeps:
            if mesh is not None:
                logger.info(f"Sharding the patch grid over {mesh.size} ranks")
            if spatial_mesh is not None:
                logger.info(f"Sharding each patch's z-axis over {spatial_n} ranks (cooperative)")
            self._sweeps[key] = DeviceSlidingWindow(
                self.model, patch_shape, halo_shape, normalize=normalize, stats=stats, blend=self.blend,
                mesh=mesh, patch_batch=patch_batch, tta_axes=self._tta_patch_axes(), spatial_mesh=spatial_mesh)
        return self._sweeps[key]

    def _plan_spatial_slab(self, spatial, max_slab_z, grid_patch_shape, halo_shape, normalize, min_slab_z=64):
        """The cooperative arm of `patch_mode: slab` for a host with more
        ranks than slabs (JAX predictor.py:495-530): every slab's depth shards
        across all the host's ranks. Searches down from `max_slab_z` for the
        deepest slab whose padded depth shards exactly that many ways through
        the model's pooling. Returns (n_ranks, (slab_patch_shape, starts)), or
        (0, None) when no depth from the thin-slab floor up does, or the model
        or pipeline cannot shard (BatchNorm, anisotropic deconv, percentile
        normalization, z-mirror TTA)."""
        if normalize == "percentile" or 0 in self._tta_patch_axes():
            return 0, None
        try:
            validate_spatial_model(self.model)
        except ValueError as e:
            logger.info(f"slab z-sharding unavailable for this model: {e}")
            return 0, None
        n = len(distributed.host_ranks())
        d, h, w = (int(v) for v in spatial)
        hz = halo_shape[0]
        pool, min_local, levels = spatial_pool_d(self.model), spatial_min_local(self.model), len(self.model.encoders)
        floor = max(min_slab_z, grid_patch_shape[0])
        for slab_z in range(min(max_slab_z, d), floor - 1, -1):
            if spatial_shardable(slab_z + 2 * hz, levels, n, pool=pool, min_local=min_local):
                return n, ((slab_z, h, w), _slab_starts(d, slab_z))
        return 0, None

    def _plan_geometry(self, spatial, patch_shape, starts, halo_shape, cin, normalize=None):
        """Applies `patch_mode` to the configured (patch_shape, starts) grid:
        'grid' returns them unchanged; 'slab' plans full-plane z-slabs, else
        strips, else keeps the grid; for a 2D model, whole planes (JAX
        predictor.py:538-637). Returns (patch_shape, starts, spatial_n):
        spatial_n > 1 shards each slab's depth over that many ranks."""
        self._planned_patch_batch = None
        if self.patch_mode != "slab":
            return patch_shape, starts, 0
        n_grid = len(starts)
        if is_model_2d(self.model):
            d = int(spatial[0])
            candidates = ((min(self.patch_batch, d),) if self.patch_batch is not None
                          else tuple(dict.fromkeys((min(24, d), min(16, d)))))
            for patch_batch in candidates:
                plan = _plan_plane_grid(spatial, halo_shape, cin, self.max_patch_voxels, patch_batch)
                if plan is not None:
                    self._planned_patch_batch = patch_batch
                    logger.info(f"patch_mode 'slab': {len(plan[1])} full-plane 2D patches replace the "
                                f"{n_grid}-tile grid (patch_batch={patch_batch})")
                    return (*plan, 0)
            logger.warning(f"patch_mode 'slab': {spatial[1]}x{spatial[2]} planes x patch_batch={patch_batch} "
                           f"exceed max_patch_voxels={self.max_patch_voxels}; keeping the configured grid")
            return patch_shape, starts, 0
        plan = _plan_slab_grid(spatial, patch_shape, halo_shape, cin, self.max_patch_voxels)
        n_dev = len(distributed.host_ranks()) if self._mesh_active() else 1
        if plan is None:
            # slab refused (plane too large / slabs too thin): try the strip
            # geometry before surrendering to the grid
            strip = _plan_strip_grid(spatial, patch_shape, halo_shape, cin, self.max_patch_voxels)
            if strip is not None and (len(strip[1]) >= n_dev or n_dev > n_grid):
                shape = strip[0]
                logger.info(f"patch_mode 'slab': no full-plane slab fits; {len(strip[1])} {shape[0]}x{shape[1]}x"
                            f"{shape[2]} strips replace the {n_grid}-patch grid (halo only on the short axes)")
                return (*strip, 0)
            if strip is not None:
                logger.info(f"patch_mode 'slab': {len(strip[1])} strips would idle {n_dev - len(strip[1])} of "
                            f"{n_dev} ranks; keeping the {n_grid}-patch grid")
            else:
                logger.warning(f"patch_mode 'slab': neither a full-plane slab nor a strip fits max_patch_voxels="
                               f"{self.max_patch_voxels} for the {spatial[1]}x{spatial[2]} plane; keeping the "
                               "configured patch grid")
            return patch_shape, starts, 0
        if len(plan[1]) >= n_dev:
            logger.info(f"patch_mode 'slab': {len(plan[1])} full-plane z-slab(s) of depth {plan[0][0]} replace "
                        f"the {n_grid}-patch grid")
            return (*plan, 0)
        # fewer slabs than ranks: first try sharding every slab's depth over them
        spatial_n, sp_plan = self._plan_spatial_slab(spatial, plan[0][0], patch_shape, halo_shape, normalize)
        if spatial_n == n_dev:
            logger.info(f"patch_mode 'slab': {len(sp_plan[1])} z-slab(s) of depth {sp_plan[0][0]}, each z-sharded "
                        f"over all {spatial_n} ranks cooperatively")
            return (*sp_plan, spatial_n)
        if n_dev <= n_grid:
            # a partly idle host loses to the grid split across all its ranks
            logger.info(f"patch_mode 'slab': {len(plan[1])} slabs would idle {n_dev - len(plan[1])} of {n_dev} "
                        f"ranks and no slab depth is z-shardable {n_dev} ways; keeping the {n_grid}-patch grid "
                        "(set 'shard: false' to prefer slabs)")
            return patch_shape, starts, 0
        logger.info(f"patch_mode 'slab': {len(plan[1])} z-slab(s) of depth {plan[0][0]} (grid and slabs both "
                    f"underfill the {n_dev} ranks; z-sharding unavailable)")
        return (*plan, 0)

    def _warn_overlap(self, starts, patch_shape):
        """`blend: assign` with an overlapping grid averages on a sharded host
        (JAX predictor.py:692-699)."""
        overlapping = any(len(u := np.unique(starts[:, k])) > 1 and np.min(np.diff(u)) < patch_shape[k]
                          for k in range(3))
        if overlapping and self.blend == "assign" and self._mesh_active():
            logger.warning("blend 'assign' with an overlapping grid on a sharded host AVERAGES overlapping patches "
                           "(one rank write-wins). Use 'blend: gaussian' for well-defined overlap blending, or "
                           "'shard: false' for exact reference write-wins stitching.")

    def __call__(self, test_loader):
        import h5py

        from pytorch3dunet_tpu_torch.inference_device import detect_device_path

        dataset = test_loader.dataset
        if not self._participates():
            return None
        leader = distributed.local_rank() == 0
        if is_model_2d(self.model):
            patch_z = dataset.raw_slices[0][-3].stop - dataset.raw_slices[0][-3].start
            if patch_z != 1 or dataset.halo_shape[0] != 0:
                logger.warning("2D model with patches deeper than 1 or a z halo: falling back to the host loop. "
                               "Set patch_shape [1, H, W] and halo_shape [0, hy, hx] to keep the device sweep.")
                return super().__call__(test_loader) if leader else None
        device_path = detect_device_path(dataset.transformer.phase_config["raw"], dataset.transformer.config_base)
        if device_path is None:
            logger.warning("Transformer pipeline unsupported by the device sweep: falling back to the host loop. "
                           "Supported test pipelines: Standardize / Normalize / PercentileNormalizer "
                           "(non-channelwise) + ToTensor.")
            return super().__call__(test_loader) if leader else None
        normalize, stats = device_path

        logger.info(f"Processing '{dataset.file_path}' with the device-side sweep...")
        start = time.perf_counter()
        # core start positions from the slice grid (spatial part only)
        starts = np.array([[s.start for s in idx[-3:]] for idx in dataset.raw_slices], dtype=np.int32)
        patch_shape = tuple(idx.stop - idx.start for idx in dataset.raw_slices[0][-3:])

        with h5py.File(dataset.file_path, "r") as f:
            raw_dset = f[dataset.raw_internal_path]
            channels_first = raw_dset.ndim == 4
            spatial = raw_dset.shape[1:] if channels_first else raw_dset.shape
            cin = raw_dset.shape[0] if channels_first else 1
            patch_shape, starts, spatial_n = self._plan_geometry(spatial, patch_shape, starts, dataset.halo_shape,
                                                                 cin, normalize)
            self._warn_overlap(starts, patch_shape)
            n_voxels = int(np.prod([s + 2 * h for s, h in zip(spatial, dataset.halo_shape)])) * cin
            if self.max_device_voxels and n_voxels > self.max_device_voxels:
                # bigger-than-budget volume: stream z-slabs straight from the
                # file and the finalized planes straight into the output H5 —
                # host memory stays O(slab), never O(volume)
                return self._streamed_predict(dataset, raw_dset, spatial, starts, patch_shape, normalize, stats,
                                              start, spatial_n)
            raw = raw_dset[:]

        padded = mirror_pad(np.asarray(raw, dtype=np.float32), dataset.halo_shape)
        sweep = self._get_sweep(patch_shape, dataset.halo_shape, normalize, stats, spatial_n)
        prediction_array = sweep(padded, starts, stats=stats)  # (Cout, D, H, W)
        logger.info(f"Finished device inference in {time.perf_counter() - start:.2f} seconds")
        if not leader:
            return None

        if self.performance_metric is not None or not self.write_behind:
            # the metric scores the saved (segmented) array: save inline
            prediction_array = self._save_output(prediction_array, dataset)
            if self.performance_metric is not None:
                return self._evaluate(prediction_array, dataset)
            return None
        # write-behind: the gzip H5 write runs on a background thread so the
        # next volume's sweep overlaps it; finalize() joins the tail write
        self._submit_write(prediction_array, dataset)
        return None

    def _save_output(self, prediction_array, dataset):
        """Applies the output transform (segmentation / channel select) and
        writes the gzip H5; returns the transformed array."""
        import h5py

        if self.save_segmentation:
            prediction_array = self._to_segmentation(prediction_array)
        elif self.prediction_channel is not None:
            prediction_array = prediction_array[self.prediction_channel : self.prediction_channel + 1]

        output_file = _get_output_file(dataset, output_dir=self.output_dir)
        logger.info(f"Saving predictions to: {output_file}")
        with h5py.File(output_file, "w") as h5_output_file:
            h5_output_file.create_dataset(self.output_dataset, data=prediction_array, compression="gzip")
        return prediction_array

    def _submit_write(self, prediction_array, dataset):
        # depth-1 queue: at most one volume-sized write buffer is pending, and
        # the previous write's exceptions surface on the very next volume
        # (finalize also retires an idle writer, so create ours after it)
        self.finalize()
        if self._writer is None:
            self._writer = ThreadPoolExecutor(max_workers=1, thread_name_prefix="h5-write-behind")
        future = self._writer.submit(self._save_output, prediction_array, dataset)
        # safety net for callers that never finalize(): the data still lands
        # (non-daemon worker joins at interpreter exit) but the error would be
        # silently swallowed — log it as soon as the write settles
        future.add_done_callback(
            lambda f: logger.error(f"write-behind save failed: {f.exception()}") if f.exception() else None)
        self._write_future = future

    def finalize(self):
        """Drains the write-behind output write, re-raising its exception if
        the write failed, and retires the idle writer thread. Call after the
        last volume (the predict CLI does)."""
        future, self._write_future = self._write_future, None
        try:
            if future is not None:
                future.result()
        finally:
            # nothing pending anymore: release the worker thread
            if self._write_future is None and self._writer is not None:
                self._writer.shutdown(wait=True)
                self._writer = None

    def predict_array(self, volume: np.ndarray, patch_shape, stride_shape, halo_shape,
                      normalize=None, stats=None) -> np.ndarray:
        """In-memory sliding-window prediction: (D, H, W) or channels-first
        (C, D, H, W) numpy in, (Cout, D, H, W) float32 probabilities out.
        Shares the file path's geometry planning (`patch_mode`), device
        normalization (`normalize`, `stats`: see `detect_device_path`),
        blending, z-slab streaming and TTA. No H5 round-trip, no dataset."""
        volume = np.asarray(volume, dtype=np.float32)
        assert volume.ndim in (3, 4), f"expected (D, H, W) or (C, D, H, W), got shape {volume.shape}"
        spatial = volume.shape[-3:]
        cin = volume.shape[0] if volume.ndim == 4 else 1
        halo_shape = tuple(int(h) for h in halo_shape)
        slices = SliceBuilder._build_slices(np.broadcast_to(np.float32(0), spatial), tuple(patch_shape),
                                            tuple(stride_shape))
        starts = np.array([[s.start for s in idx[-3:]] for idx in slices], dtype=np.int32)
        patch_shape = tuple(idx.stop - idx.start for idx in slices[0][-3:])
        patch_shape, starts, spatial_n = self._plan_geometry(spatial, patch_shape, starts, halo_shape, cin,
                                                             normalize)
        self._warn_overlap(starts, patch_shape)

        padded_voxels = int(np.prod([s + 2 * h for s, h in zip(spatial, halo_shape)])) * cin
        if self.max_device_voxels and padded_voxels > self.max_device_voxels:
            # over-budget volume: the same pipelined z-slab sweep the file
            # path streams through, landing in an in-memory array
            out = np.zeros((self.out_channels, *spatial), dtype=np.float32)

            def consume(z, planes):
                out[:, z : z + planes.shape[1]] = planes

            self._chunked_sweep(volume, starts, patch_shape, halo_shape, normalize, stats, consume, spatial_n)
            return out

        sweep = self._get_sweep(patch_shape, halo_shape, normalize, stats, spatial_n)
        return sweep(mirror_pad(volume, halo_shape), starts, stats=stats)

    def _streamed_predict(self, dataset, raw_dset, spatial, starts, patch_shape, normalize, stats, t_start,
                          spatial_n=0):
        """Z-slab streaming path for volumes over the device budget: input
        slabs are read from the open H5 dataset (never the whole volume), and
        finalized output planes are written straight into a chunked gzip H5
        dataset. Peak host allocation is O(slab), not O(volume). The other
        ranks of a sharded host sweep along and write nothing."""
        import h5py

        if distributed.local_rank() != 0:
            self._chunked_sweep(raw_dset, starts, patch_shape, dataset.halo_shape, normalize, stats,
                                lambda z, planes: None, spatial_n)
            return None

        output_file = _get_output_file(dataset, output_dir=self.output_dir)
        logger.info(f"Saving predictions to: {output_file} (streamed)")
        with h5py.File(output_file, "w") as out_f:
            if self.save_segmentation:
                dset = out_f.create_dataset(self.output_dataset, shape=spatial, dtype="uint16", chunks=True,
                                            compression="gzip")

                def consume(z, planes):
                    dset[z : z + planes.shape[1]] = self._to_segmentation(planes)
            else:
                n_out = 1 if self.prediction_channel is not None else self.out_channels
                dset = out_f.create_dataset(self.output_dataset, shape=(n_out, *spatial), dtype="float32",
                                            chunks=True, compression="gzip")

                def consume(z, planes):
                    if self.prediction_channel is not None:
                        planes = planes[self.prediction_channel : self.prediction_channel + 1]
                    dset[:, z : z + planes.shape[1]] = planes

            self._chunked_sweep(raw_dset, starts, patch_shape, dataset.halo_shape, normalize, stats, consume,
                                spatial_n)
            logger.info(f"Finished device inference in {time.perf_counter() - t_start:.2f} seconds")
            if self.performance_metric is not None:
                return self._evaluate(dset[...], dataset)
        return None

    def _chunked_sweep(self, raw, starts, patch_shape, halo_shape, normalize, stats, consume, spatial_n=0):
        """Sweeps the grid in z-slabs so only O(slab) data lives on the device
        (and on the host) at a time — the device-side LazyPredictor analog.

        `raw` is an open h5py dataset (or array), (D, H, W) or (C, D, H, W);
        each slab is read with `_read_padded_slab` (one contiguous H5 read).
        Finalized output planes are emitted in ascending-z order through
        `consume(z_start, planes)` with planes shaped (Cout, dz, H, W).

        The slab loop is a 3-stage pipeline: a loader thread reads and uploads
        slab i+1 while the device sweeps slab i, and a writer thread runs
        `consume` (typically a gzip'd H5 write) behind both. The upload runs on
        the loader thread's current stream, the default stream, so on the
        device it queues behind the sweep rather than overlapping it. Two input
        slabs are device-resident at the steady state, so when the plan has
        more than one slab the per-slab input budget is halved (the configured
        `max_device_voxels` keeps bounding the TOTAL device input footprint).

        Stitching semantics match the unchunked sweep: `blend: gaussian`
        accumulates (out, weights) partials in a rolling buffer across slab
        boundaries; `blend: assign` stitches write-wins inside each slab and
        lets later slabs overwrite their full z-extent — identical to the
        reference's write-wins order because the patch grid is z-major
        ascending.
        """
        sweep = self._get_sweep(patch_shape, halo_shape, normalize, stats, spatial_n)
        weighted = sweep.weighted
        channels_first = raw.ndim == 4
        depth = int(raw.shape[1] if channels_first else raw.shape[0])
        hz = halo_shape[0]
        cz = patch_shape[0]
        pz = cz + 2 * hz
        plane_voxels = int(np.prod([s + 2 * h for s, h in zip(raw.shape[-2:], halo_shape[1:])]))
        plane_voxels *= raw.shape[0] if channels_first else 1
        z_capacity = max(int(self.max_device_voxels // max(plane_voxels, 1)), pz)

        # group ascending z-levels into slabs bounded by the device budget
        z_levels = [int(z) for z in np.unique(starts[:, 0])]

        def _group(cap):
            groups: list[list[int]] = [[]]
            for z in z_levels:
                if groups[-1] and (z - groups[-1][0] + pz) > cap:
                    groups.append([])
                groups[-1].append(z)
            return groups

        slabs = _group(z_capacity)
        if len(slabs) > 1:
            # the pipeline keeps the NEXT slab's input device-resident while
            # the current one computes; halve the per-slab budget so the two
            # together still respect max_device_voxels
            z_capacity = max(z_capacity // 2, pz)
            slabs = _group(z_capacity)
        logger.info(f"Streamed sweep: {len(z_levels)} z-levels in {len(slabs)} slabs of <= {z_capacity} z-planes")

        # rolling emit buffer over output z-planes [ptr, ptr + buf_out.shape[1])
        hw = tuple(raw.shape[-2:])
        cout = self.out_channels
        buf_out = np.zeros((cout, 0, *hw), dtype=np.float32)
        buf_w = np.zeros((0, *hw), dtype=np.float32) if weighted else None
        ptr = 0

        def _load(slab_i):
            """Loader-thread stage: contiguous H5 slab read + host->device
            upload; runs for slab i+1 while the device sweeps slab i."""
            levels = slabs[slab_i]
            sub = _read_padded_slab(raw, halo_shape, levels[0], levels[-1] + pz)
            if sub.ndim == 4:
                sub = np.moveaxis(sub, -1, 0)  # channels-first for the sweep
            return sweep.upload(sub)

        writes: collections.deque = collections.deque()
        with ThreadPoolExecutor(max_workers=1) as loader, ThreadPoolExecutor(max_workers=1) as writer:
            next_slab = loader.submit(_load, 0)
            for slab_i, slab_levels in enumerate(slabs):
                z0, z1 = slab_levels[0], slab_levels[-1]
                sub = next_slab.result()
                if slab_i + 1 < len(slabs):
                    next_slab = loader.submit(_load, slab_i + 1)
                members = np.isin(starts[:, 0], slab_levels)
                local = starts[members].copy()
                local[:, 0] -= z0
                part_out, part_w = sweep.sweep_raw(sub, local, stats=stats)
                del sub
                zo = z1 - z0 + cz  # output extent of the slab

                grow = (z0 + zo) - (ptr + buf_out.shape[1])
                if grow > 0:
                    buf_out = np.concatenate([buf_out, np.zeros((cout, grow, *hw), np.float32)], axis=1)
                    if weighted:
                        buf_w = np.concatenate([buf_w, np.zeros((grow, *hw), np.float32)])
                lo = z0 - ptr
                if weighted:
                    buf_out[:, lo : lo + zo] += part_out
                    buf_w[lo : lo + zo] += part_w
                else:
                    # assign sweeps return unweighted partials; overwrite
                    # preserves the z-major write-wins order
                    assert part_w is None
                    buf_out[:, lo : lo + zo] = part_out

                emit_end = slabs[slab_i + 1][0] if slab_i + 1 < len(slabs) else depth
                n_emit = emit_end - ptr
                if n_emit > 0:
                    planes = buf_out[:, :n_emit]
                    if weighted:
                        planes = planes / np.maximum(buf_w[:n_emit], 1e-10)[None]
                    # writer-thread stage: consume() overlaps the next slab's
                    # sweep. In assign mode `planes` views the emitted prefix
                    # of buf_out's base; later slabs only touch base planes
                    # >= n_emit (or a fresh base after concatenate), so the
                    # pending write is never mutated under the writer. At
                    # most one write in flight keeps host RSS O(slab).
                    while writes:
                        writes.popleft().result()
                    writes.append(writer.submit(consume, ptr, planes))
                    buf_out = buf_out[:, n_emit:]
                    if weighted:
                        buf_w = buf_w[n_emit:]
                    ptr = emit_end
            while writes:
                writes.popleft().result()


class DSB2018Predictor(StandardPredictor):
    """Per-image 2D prediction of a DSB2018 folder (JAX predictor.py:1009-1098,
    reference predictor.py:277-330): each test batch (images, paths) goes
    through `predict_image`, and `dsb_save_batch` writes each image's
    probabilities, and with `save_segmentation` their connected components
    above `pmaps_thershold` (the reference's spelling of the key), to
    `<output_dir>/<image name>_predictions.h5`. The writes run on a small
    thread pool behind the next image's forward.

    `pad_to_multiple`: reflect-pad each image's H and W up to the next
    multiple before the forward (edge-pad where the image is too small to
    reflect) and crop the probabilities back. Off by default: the padding
    shifts the image-wide normalization statistics slightly."""

    # writer threads: h5py runs one call at a time, so more threads would
    # only queue behind each other; two keep the labeling beside a write
    write_threads = 2

    def __init__(self, model, output_dir, out_channels, device, save_segmentation=True, pmaps_thershold=0.5,
                 pad_to_multiple=None, **kwargs):
        super().__init__(model, output_dir, out_channels, device, save_segmentation=save_segmentation, **kwargs)
        self.pmaps_threshold = pmaps_thershold
        self.pad_to_multiple = pad_to_multiple

    def __call__(self, test_loader):
        with ThreadPoolExecutor(max_workers=self.write_threads, thread_name_prefix="dsb-write") as writer:
            futures = [writer.submit(dsb_save_batch, self.output_dir, paths, self.predict_image(img),
                                     self.save_segmentation, self.pmaps_threshold)
                       for img, paths in test_loader]
            for future in futures:
                future.result()

    def predict_image(self, img) -> np.ndarray:
        """Probabilities of an (N, C, 1, H, W) or (N, C, H, W) image batch, as
        float32 numpy of the same layout; the padding runs on the device."""
        img = np.asarray(img, dtype=np.float32)
        had_depth = img.ndim == 5
        if had_depth:
            img = np.squeeze(img, axis=2)
        h, w = img.shape[-2:]
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(img)).to(self.device)
            if self.pad_to_multiple:
                m = int(self.pad_to_multiple)
                for size, pad in ((h, (0, 0, 0, -h % m)), (w, (0, -w % m, 0, 0))):
                    if any(pad):
                        x = torch.nn.functional.pad(x, pad, mode="reflect" if max(pad) < size else "replicate")
            probs = self._tta_wrap(lambda xi: self.model(xi)[0])(x)[:, :, :h, :w].float().cpu().numpy()
        return probs[:, :, None] if had_depth else probs


def pmaps_to_segmentation(pmap: np.ndarray, threshold: float = 0.5) -> np.ndarray:
    """The connected components (full connectivity) of `pmap > threshold`, uint16."""
    return cc_label((pmap > threshold).astype(np.uint8)).astype("uint16")


def dsb_save_batch(output_dir, paths, pred, save_segmentation=True, pmaps_thershold=0.5):
    """Writes each image's probabilities (`predictions`, singleton axes
    squeezed) and their `segmentation` to `<image stem>_predictions.h5`, in
    `output_dir` or beside the image."""
    import h5py

    for single_pred, single_path in zip(pred, paths):
        logger.info(f"Processing {single_path}")
        single_pred = single_pred.squeeze()
        out_file = os.path.splitext(single_path)[0] + "_predictions.h5"
        if output_dir is not None:
            out_file = os.path.join(output_dir, os.path.split(out_file)[1])
        with h5py.File(out_file, "w") as f:
            f.create_dataset("predictions", data=single_pred, compression="gzip")
            if save_segmentation:
                f.create_dataset("segmentation", data=pmaps_to_segmentation(single_pred, pmaps_thershold),
                                 compression="gzip")
