"""Config-driven augmentation pipeline (host-side numpy).

Capability parity with the reference (pytorch3dunet/augment/transforms.py):
the same transform names, config keys and RNG-pairing semantics — the
`Transformer` factory seeds every transform in a phase with one shared seed so
the geometric transforms applied to the raw and label patches line up
(transforms.py:905-934). Label-engineering transforms (boundaries/affinities)
use the scipy/numpy ops of `utils/ndimage.py` instead of
scikit-image.

The arrays here are ZYX (3D) or CZYX (4D) numpy patches, exactly as produced
by the HDF5 datasets; `ToTensor`/`LabelToTensor` emit numpy arrays in the
requested dtype (the device transfer happens later, in the trainer).

Behavioral contract: the ORDER and COUNT of RandomState draws per transform is
pinned draw-for-draw against the reference (tests/test_transform_oracle.py
asserts equality against a live reference install), because the paired-seed
trick only works when both pipelines consume the identical draw sequence.
Everything else — names, structure, messages — is this module's own.

The port's own copy of pytorch3dunet_tpu/augment/transforms.py; the
on-device augmentation is ops/augment.py.
"""

import importlib
import inspect
import random
from collections.abc import Callable

import numpy as np
from scipy.ndimage import convolve, gaussian_filter, map_coordinates, rotate

from pytorch3dunet_tpu_torch.utils import ndimage

# Fixed module-level random state: reproducible pipelines by default, matching
# the reference convention (transforms.py:13).
GLOBAL_RANDOM_STATE = np.random.RandomState(47)


def _recover_ignore_index(channels, source_label, ignore_index):
    """Restores the ignore_index marker wherever the source label carried it
    (engineering ops would otherwise overwrite those voxels)."""
    if ignore_index is None:
        return channels
    channels[source_label == ignore_index] = ignore_index
    return channels


class Compose:
    """Applies a list of transforms in sequence."""

    def __init__(self, transforms: list[Callable[[np.ndarray], np.ndarray]]):
        self.transforms = list(transforms)

    def __call__(self, patch):
        for transform in self.transforms:
            patch = transform(patch)
        return patch

    def reseed(self, seed: int):
        """Reseeds every transform's RandomState to `seed`. Forked DataLoader
        workers call this (same seed for the raw AND label pipeline, so
        paired geometric draws stay in lockstep) — without it every worker
        inherits identical fork-copied RandomStates and produces the same
        augmentation sequence."""
        for transform in self.transforms:
            state = getattr(transform, "random_state", None)
            if state is not None and hasattr(state, "seed"):
                state.seed(seed)


# ---------------------------------------------------------------------------
# geometric transforms (shared RNG draws keep raw/label patches aligned)
# ---------------------------------------------------------------------------


class RandomFlip:
    """Randomly flips a 3D (DxHxW) or 4D (CxDxHxW) patch across each spatial axis.

    Each spatial axis is flipped independently with probability 1 - axis_prob
    (the reference flips when uniform() > axis_prob, transforms.py:50).
    """

    def __init__(self, random_state: np.random.RandomState, axis_prob: float = 0.5, **kwargs):
        assert random_state is not None, "a seeded RandomState is required (the Transformer supplies it)"
        self.random_state, self.axis_prob = random_state, axis_prob
        self.axes = tuple(range(3))

    def __call__(self, patch: np.ndarray) -> np.ndarray:
        assert patch.ndim in (3, 4), "expected a ZYX or CZYX patch"
        lead = patch.ndim - 3
        for axis in self.axes:
            if self.axis_prob < self.random_state.uniform():
                patch = np.flip(patch, lead + axis)
        return patch


class RandomRotate90:
    """Rotates the patch by a random multiple of 90 degrees in the HW plane.

    Assumes DHW axis order (rotation across the last two axes); the z-axis is
    preserved, matching the reference (transforms.py:60-90).
    """

    def __init__(self, random_state: np.random.RandomState, **kwargs):
        self.random_state = random_state

    def __call__(self, patch: np.ndarray) -> np.ndarray:
        assert patch.ndim in (3, 4), "expected a ZYX or CZYX patch"
        quarter_turns = self.random_state.randint(0, 4)
        lead = patch.ndim - 3
        return np.rot90(patch, quarter_turns, axes=(lead + 1, lead + 2))


class RandomRotate:
    """Rotates by a random angle from (-angle_spectrum, angle_spectrum) around a
    randomly chosen axis pair (transforms.py:93-139)."""

    def __init__(self, random_state, angle_spectrum: int = 30, axes: list = None,
                 mode: str = "reflect", order: int = 0, **kwargs):
        if axes is None:
            axes = [(1, 0), (2, 1), (2, 0)]
        else:
            assert isinstance(axes, list) and axes, "axes must be a non-empty list of axis pairs"
        self.random_state, self.angle_spectrum = random_state, angle_spectrum
        self.axes, self.mode, self.order = axes, mode, order

    def __call__(self, patch: np.ndarray) -> np.ndarray:
        plane = self.axes[self.random_state.randint(len(self.axes))]
        angle = self.random_state.randint(-self.angle_spectrum, self.angle_spectrum)

        def rot(vol):
            return rotate(vol, angle, axes=plane, reshape=False, order=self.order, mode=self.mode, cval=-1)

        if patch.ndim == 3:
            return rot(patch)
        return np.stack([rot(channel) for channel in patch], axis=0)  # same rotation per channel


class ElasticDeformation:
    """Per-voxel elastic deformation from Gaussian-smoothed random displacement
    fields (transforms.py:206-269). Use spline_order=0 for label patches.

    ~1 s/patch on CPU for 64x200x200; the data loader overlaps this with
    device compute (or `device_augment: true` moves it on-chip entirely).
    """

    def __init__(self, random_state, spline_order: int, alpha: int = 2000, sigma: int = 50,
                 execution_probability: float = 0.1, apply_3d: bool = True, **kwargs):
        self.random_state, self.spline_order = random_state, spline_order
        self.alpha, self.sigma = alpha, sigma
        self.execution_probability, self.apply_3d = execution_probability, apply_3d

    def __call__(self, patch: np.ndarray) -> np.ndarray:
        # gate draw first, THEN (dz), dy, dx field draws — the pinned sequence
        if self.random_state.uniform() >= self.execution_probability:
            return patch
        assert patch.ndim in (3, 4), "expected a ZYX or CZYX patch"
        shape3 = patch.shape if patch.ndim == 3 else patch.shape[1:]

        def smoothed_field():
            noise = self.random_state.randn(*shape3)
            return gaussian_filter(noise, self.sigma, mode="reflect") * self.alpha

        dz = smoothed_field() if self.apply_3d else np.zeros(shape3)
        dy = smoothed_field()
        dx = smoothed_field()

        zs, ys, xs = np.meshgrid(*(np.arange(n) for n in shape3), indexing="ij")
        warped = (zs + dz, ys + dy, xs + dx)

        def resample(vol):
            return map_coordinates(vol, warped, order=self.spline_order, mode="reflect")

        if patch.ndim == 3:
            return resample(patch)
        return np.stack([resample(channel) for channel in patch], axis=0)


class CropToFixed:
    """Crops (or reflect-pads) the HW plane to a fixed size; random or centered
    corner (transforms.py:272-335)."""

    def __init__(self, random_state, size: tuple = (256, 256), centered: bool = False, **kwargs):
        self.random_state, self.centered = random_state, centered
        self.crop_y, self.crop_x = size

    def __call__(self, patch: np.ndarray) -> np.ndarray:
        def split_pad(total):
            return total // 2, total - total // 2

        def random_window(want, have):
            # (randint upper bound, (pad_before, pad_after))
            return (have - want, (0, 0)) if want < have else (1, split_pad(want - have))

        def centered_window(want, have):
            return ((have - want) // 2, (0, 0)) if want < have else (0, split_pad(want - have))

        assert patch.ndim in (3, 4), "expected a ZYX or CZYX patch"
        have_y, have_x = patch.shape[-2:]

        if self.centered:
            y0, y_pad = centered_window(self.crop_y, have_y)
            x0, x_pad = centered_window(self.crop_x, have_x)
        else:
            y_bound, y_pad = random_window(self.crop_y, have_y)
            x_bound, x_pad = random_window(self.crop_x, have_x)
            y0 = self.random_state.randint(y_bound)
            x0 = self.random_state.randint(x_bound)

        window = patch[..., :, y0 : y0 + self.crop_y, x0 : x0 + self.crop_x]
        lead_pad = [(0, 0)] * (patch.ndim - 2)
        return np.pad(window, pad_width=[*lead_pad, y_pad, x_pad], mode="reflect")


# ---------------------------------------------------------------------------
# intensity transforms
# ---------------------------------------------------------------------------


class RandomContrast:
    """Scales voxels to mean + alpha * (v - mean), clipped to [-1, 1]
    (transforms.py:142-172)."""

    def __init__(self, random_state, alpha=(0.5, 1.5), mean: float = 0.0,
                 execution_probability: float = 0.1, **kwargs):
        assert len(alpha) == 2, "alpha must be a (low, high) range"
        self.random_state, self.alpha = random_state, alpha
        self.mean, self.execution_probability = mean, execution_probability

    def __call__(self, patch: np.ndarray) -> np.ndarray:
        if self.random_state.uniform() < self.execution_probability:
            factor = self.random_state.uniform(*self.alpha)
            return np.clip(self.mean + factor * (patch - self.mean), -1, 1)
        return patch


class RandomGammaCorrection:
    """Rescales to [0, 1] then applies v ** gamma (transforms.py:175-203)."""

    def __init__(self, random_state, gamma=(0.5, 1.5), execution_probability: float = 0.1, **kwargs):
        assert len(gamma) == 2, "gamma must be a (low, high) range"
        self.random_state, self.gamma = random_state, gamma
        self.execution_probability = execution_probability

    def __call__(self, patch: np.ndarray) -> np.ndarray:
        if self.random_state.uniform() < self.execution_probability:
            patch = ndimage.rescale_intensity(patch, out_range=(0, 1))
            exponent = self.random_state.uniform(*self.gamma)
            return ndimage.adjust_gamma(patch, exponent)
        return patch


class Standardize:
    """Z-score normalization, optionally channel-wise or with precomputed
    stats (transforms.py:653-688)."""

    def __init__(self, eps: float = 1e-10, mean: float = None, std: float = None,
                 channelwise: bool = False, **kwargs):
        if mean is not None or std is not None:
            assert mean is not None and std is not None, "mean and std must be given together"
        self.mean, self.std = mean, std
        self.eps, self.channelwise = eps, channelwise

    def __call__(self, patch: np.ndarray) -> np.ndarray:
        if self.mean is not None:
            mean, std = self.mean, self.std
        elif self.channelwise:
            spatial = tuple(range(1, patch.ndim))
            mean = np.mean(patch, axis=spatial, keepdims=True)
            std = np.std(patch, axis=spatial, keepdims=True)
        else:
            mean, std = np.mean(patch), np.std(patch)
        return (patch - mean) / np.clip(std, a_min=self.eps, a_max=None)


class PercentileNormalizer:
    """Normalizes by the [pmin, pmax] percentile window (transforms.py:691-711)."""

    def __init__(self, pmin: float = 1.0, pmax: float = 99.6, channelwise: bool = False,
                 eps: float = 1e-10, **kwargs):
        self.eps, self.channelwise = eps, channelwise
        # base-config stats may inject pmin/pmax as None (stats skipped):
        # fall back to the reference defaults
        self.pmin = 1.0 if pmin is None else pmin
        self.pmax = 99.6 if pmax is None else pmax

    def __call__(self, patch: np.ndarray) -> np.ndarray:
        if self.channelwise:
            spatial = tuple(range(1, patch.ndim))
            lo = np.percentile(patch, self.pmin, axis=spatial, keepdims=True)
            hi = np.percentile(patch, self.pmax, axis=spatial, keepdims=True)
        else:
            lo, hi = np.percentile(patch, self.pmin), np.percentile(patch, self.pmax)
        return (patch - lo) / (hi - lo + self.eps)


class Normalize:
    """Min-max scaling to [-1, 1], or [0, 1] when norm01 is set
    (transforms.py:714-754)."""

    def __init__(self, min_value: float = None, max_value: float = None, norm01: bool = False,
                 eps: float = 1e-10, **kwargs):
        if min_value is not None and max_value is not None:
            assert max_value > min_value, "max_value must exceed min_value"
        self.min_value, self.max_value = min_value, max_value
        self.norm01, self.eps = norm01, eps

    def __call__(self, patch: np.ndarray) -> np.ndarray:
        lo = np.min(patch) if self.min_value is None else self.min_value
        hi = np.max(patch) if self.max_value is None else self.max_value
        unit = (patch - lo) / (hi - lo + self.eps)
        return np.clip(unit, 0, 1) if self.norm01 else np.clip(2 * unit - 1, -1, 1)


class AdditiveGaussianNoise:
    """Adds Gaussian noise with a randomly drawn std (transforms.py:757-776)."""

    def __init__(self, random_state, scale=(0.0, 1.0), execution_probability: float = 0.1, **kwargs):
        self.random_state, self.scale = random_state, scale
        self.execution_probability = execution_probability

    def __call__(self, patch: np.ndarray) -> np.ndarray:
        if self.random_state.uniform() < self.execution_probability:
            std = self.random_state.uniform(*self.scale)
            return patch + self.random_state.normal(0, std, size=patch.shape)
        return patch


class AdditivePoissonNoise:
    """Adds Poisson noise with a randomly drawn rate (transforms.py:779-798)."""

    def __init__(self, random_state, lam=(0.0, 1.0), execution_probability: float = 0.1, **kwargs):
        self.random_state, self.lam = random_state, lam
        self.execution_probability = execution_probability

    def __call__(self, patch: np.ndarray) -> np.ndarray:
        if self.random_state.uniform() < self.execution_probability:
            rate = self.random_state.uniform(*self.lam)
            return patch + self.random_state.poisson(rate, size=patch.shape)
        return patch


class GaussianBlur3D:
    """Gaussian blur with a randomly drawn sigma; uses the stdlib `random`
    module (not the paired RandomState), as in the reference
    (transforms.py:890-902)."""

    def __init__(self, sigma=(0.1, 2.0), execution_probability: float = 0.5, **kwargs):
        self.sigma, self.execution_probability = sigma, execution_probability

    def __call__(self, patch: np.ndarray) -> np.ndarray:
        if random.random() < self.execution_probability:
            width = random.uniform(*self.sigma)
            return ndimage.gaussian(patch, sigma=width)
        return patch


# ---------------------------------------------------------------------------
# label-engineering transforms
# ---------------------------------------------------------------------------


class StandardLabelToBoundary:
    """Label volume -> binary boundary mask (+ optional foreground / original
    label channels) (transforms.py:338-379)."""

    def __init__(self, ignore_index: int = None, append_label: bool = False, mode: str = "thick",
                 foreground: bool = False, **kwargs):
        self.ignore_index, self.append_label = ignore_index, append_label
        self.mode, self.foreground = mode, foreground

    def __call__(self, label: np.ndarray) -> np.ndarray:
        assert label.ndim == 3, "expected a ZYX label volume"
        edges = ndimage.find_boundaries(label, connectivity=2, mode=self.mode).astype("int32")

        channels = []
        if self.foreground:
            fg = (label > 0).astype("uint8")
            channels.append(_recover_ignore_index(fg, label, self.ignore_index))
        channels.append(_recover_ignore_index(edges, label, self.ignore_index))
        if self.append_label:
            channels.append(label)
        return np.stack(channels, axis=0)


class BlobsToMask:
    """Label volume -> binary foreground mask (+ optional boundary / label
    channels) (transforms.py:382-417)."""

    def __init__(self, append_label: bool = False, boundary: bool = False, cross_entropy: bool = False, **kwargs):
        self.append_label, self.boundary = append_label, boundary
        self.cross_entropy = cross_entropy

    def __call__(self, label):
        assert label.ndim == 3, "expected a ZYX label volume"
        fg_mask = (label > 0).astype("uint8")
        channels = [fg_mask]

        if self.boundary:
            edges = ndimage.find_boundaries(label, connectivity=2, mode="outer")
            if self.cross_entropy:
                # boundary becomes class 2 in a single channel
                fg_mask[edges > 0] = 2
                channels = [fg_mask]
            else:
                channels.append(edges)

        if self.append_label:
            channels.append(label)
        return np.stack(channels, axis=0)


class AbstractLabelToBoundary:
    """Base for affinity-style boundary transforms: boundaries are computed by
    convolving the label volume with +1/-1 offset kernels per axis
    (transforms.py:420-487)."""

    AXES_TRANSPOSE = [
        (0, 1, 2),  # X
        (0, 2, 1),  # Y
        (2, 0, 1),  # Z
    ]

    def __init__(self, ignore_index: int = None, aggregate_affinities: bool = False,
                 append_label: bool = False, **kwargs):
        self.ignore_index, self.append_label = ignore_index, append_label
        self.aggregate_affinities = aggregate_affinities

    def __call__(self, label: np.ndarray) -> np.ndarray:
        assert label.ndim == 3, "expected a ZYX label volume"
        offset_kernels = self.get_kernels()
        raw_affinities = np.stack(
            [np.where(np.abs(convolve(label, kern)) > 0, 1, 0) for kern in offset_kernels])
        if self.aggregate_affinities:
            assert len(offset_kernels) % 3 == 0, \
                "aggregation requires one kernel per axis (Z, Y, X) for every offset"
            # OR-merge the three per-axis channels of each offset
            channels = [
                _recover_ignore_index(
                    np.logical_or.reduce(raw_affinities[i : i + 3]).astype(np.int32),
                    label, self.ignore_index)
                for i in range(0, len(offset_kernels), 3)
            ]
        else:
            channels = [_recover_ignore_index(aff, label, self.ignore_index) for aff in raw_affinities]

        if self.append_label:
            channels.append(label)
        return np.stack(channels, axis=0)

    @staticmethod
    def create_kernel(axis, offset: int) -> np.ndarray:
        kern = np.zeros((1, 1, offset + 1), dtype=np.int32)
        kern[0, 0, 0], kern[0, 0, offset] = 1, -1
        return np.transpose(kern, axis)

    def get_kernels(self):
        raise NotImplementedError


class RandomLabelToAffinities(AbstractLabelToBoundary):
    """Single random-offset affinity channel per call — a boundary-thickness
    denoising scheme (transforms.py:490-521)."""

    def __init__(self, random_state, max_offset=10, ignore_index=None, append_label=False,
                 z_offset_scale=2, **kwargs):
        super().__init__(ignore_index=ignore_index, append_label=append_label, aggregate_affinities=False)
        self.random_state, self.z_offset_scale = random_state, z_offset_scale
        self.offsets = tuple(range(1, max_offset + 1))

    def get_kernels(self):
        # draw order: offset choice, then axis — both from the paired state
        drawn_offset = self.random_state.choice(self.offsets)
        axis_ind = self.random_state.randint(3)
        if axis_ind == 2:
            # z offsets shrink by z_offset_scale (anisotropic voxels)
            drawn_offset = max(1, drawn_offset // self.z_offset_scale)
        return [self.create_kernel(self.AXES_TRANSPOSE[axis_ind], drawn_offset)]


class LabelToAffinities(AbstractLabelToBoundary):
    """Affinity-graph boundaries for a fixed list of offsets, optionally with
    separate z offsets (transforms.py:524-566)."""

    def __init__(self, offsets, ignore_index=None, append_label=False, aggregate_affinities=False,
                 z_offsets=None, **kwargs):
        super().__init__(ignore_index=ignore_index, append_label=append_label,
                         aggregate_affinities=aggregate_affinities)
        assert isinstance(offsets, (list, tuple)), "offsets must be a sequence"
        assert all(o > 0 for o in offsets), "offsets must be strictly positive"
        assert len(set(offsets)) == len(offsets), "duplicate offsets are not allowed"
        if z_offsets is None:
            z_offsets = list(offsets)
        else:
            assert len(z_offsets) == len(offsets), "need exactly one z offset per xy offset"
        self.z_offsets = z_offsets

        self.kernels = []
        for xy_offset, z_offset in zip(offsets, z_offsets):
            for axis_ind, axis in enumerate(self.AXES_TRANSPOSE):
                self.kernels.append(
                    self.create_kernel(axis, z_offset if axis_ind == 2 else xy_offset))

    def get_kernels(self):
        return self.kernels


class LabelToZAffinities(AbstractLabelToBoundary):
    """Z-axis-only affinities (transforms.py:569-595)."""

    def __init__(self, offsets, ignore_index=None, append_label=False, **kwargs):
        super().__init__(ignore_index=ignore_index, append_label=append_label)
        assert isinstance(offsets, (list, tuple)), "offsets must be a sequence"
        assert all(o > 0 for o in offsets), "offsets must be strictly positive"
        assert len(set(offsets)) == len(offsets), "duplicate offsets are not allowed"

        z_axis = self.AXES_TRANSPOSE[2]
        self.kernels = [self.create_kernel(z_axis, z_offset) for z_offset in offsets]

    def get_kernels(self):
        return self.kernels


class LabelToBoundaryAndAffinities:
    """Boundary channel(s) + affinity channels in one target
    (transforms.py:598-631)."""

    def __init__(self, xy_offsets, z_offsets, append_label=False, ignore_index=None, mode="thick",
                 foreground=False, **kwargs):
        self.l2b = StandardLabelToBoundary(ignore_index=ignore_index, mode=mode, foreground=foreground)
        self.l2a = LabelToAffinities(offsets=xy_offsets, z_offsets=z_offsets, append_label=append_label,
                                     ignore_index=ignore_index)

    def __call__(self, label: np.ndarray) -> np.ndarray:
        return np.concatenate((self.l2b(label), self.l2a(label)), axis=0)


class LabelToMaskAndAffinities:
    """Foreground mask channel + affinity channels (transforms.py:634-650)."""

    def __init__(self, xy_offsets, z_offsets, append_label=False, background=0, ignore_index=None, **kwargs):
        self.background = background
        self.l2a = LabelToAffinities(offsets=xy_offsets, z_offsets=z_offsets, append_label=append_label,
                                     ignore_index=ignore_index)

    def __call__(self, label: np.ndarray) -> np.ndarray:
        fg_mask = np.expand_dims((label > self.background).astype(np.uint8), axis=0)
        return np.concatenate((fg_mask, self.l2a(label)), axis=0)


class Relabel:
    """Relabels to consecutive ids, optionally after connected components
    (transforms.py:829-861)."""

    def __init__(self, append_original: bool = False, run_cc: bool = True, ignore_label: int = None, **kwargs):
        self.append_original, self.run_cc = append_original, run_cc
        self.ignore_label = ignore_label
        if ignore_label is not None:
            assert append_original, \
                "append_original is required with ignore_label (the ignore region must stay locatable)"

    def __call__(self, label: np.ndarray) -> np.ndarray:
        source = label
        if self.run_cc:
            label = ndimage.label(label, background=self.ignore_label)
        consecutive = ndimage.relabel_consecutive(label)
        return np.stack([consecutive, source]) if self.append_original else consecutive


class RgbToLabel:
    """RGB image -> single-channel integer label (transforms.py:872-879)."""

    def __call__(self, img: np.ndarray) -> np.ndarray:
        # int64 upfront: numpy 2 (NEP 50) no longer upcasts uint8 * 65536
        img = np.asarray(img).astype(np.int64)
        assert img.ndim == 3 and img.shape[2] == 3, "expected an HxWx3 RGB image"
        return img[..., 0] * 65536 + img[..., 1] * 256 + img[..., 2]


class Identity:
    def __init__(self, **kwargs):
        pass

    def __call__(self, patch: np.ndarray) -> np.ndarray:
        return patch


# ---------------------------------------------------------------------------
# array conversion (the torch ToTensor analog emits typed numpy arrays; the
# host->device transfer happens batched in the loader, not per-patch)
# ---------------------------------------------------------------------------


class ToTensor:
    """Finalizes a patch: optional channel dim, dtype cast, optional 0-1
    normalization. Emits a numpy array (transforms.py:801-826 analog)."""

    def __init__(self, expand_dims: bool, dtype=np.float32, normalize: bool = False, **kwargs):
        self.expand_dims, self.dtype = expand_dims, dtype
        self.normalize = normalize

    def __call__(self, patch: np.ndarray) -> np.ndarray:
        assert patch.ndim in (3, 4), "expected a ZYX or CZYX patch"
        if self.expand_dims and patch.ndim == 3:
            patch = np.expand_dims(patch, axis=0)
        if self.normalize:
            patch = (patch - np.min(patch)) / (np.max(patch) - np.min(patch) + 1e-10)
        return np.ascontiguousarray(patch, dtype=self.dtype)


class LabelToTensor:
    """Finalizes a label patch as int64 (transforms.py:882-887 analog)."""

    def __call__(self, patch: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(np.array(patch), dtype="int64")


# ---------------------------------------------------------------------------
# factory
# ---------------------------------------------------------------------------


class Transformer:
    """Builds raw/label transform pipelines from a phase config.

    Every transform in a phase is constructed with a fresh RandomState seeded
    with one shared per-Transformer seed, so geometric transforms consume
    identical random draws for the raw and label pipelines
    (transforms.py:905-934).
    """

    def __init__(self, phase_config: dict, base_config: dict):
        self.phase_config = phase_config
        # only the base keys that some transform of the pipelines names: a
        # Standardize pipeline takes the mean and std, so the percentiles that
        # `calculate_stats` defers stay uncomputed, and the statistics, with the
        # volume they hold until then, are not kept here
        named = {key for entries in phase_config.values() for entry in entries or ()
                 for key in self._named_arguments(entry["name"])}
        self.config_base = {key: base_config[key] for key in base_config if key in named}
        self.seed = GLOBAL_RANDOM_STATE.randint(10_000_000)

    def raw_transform(self):
        return self._create_transform("raw")

    def label_transform(self):
        return self._create_transform("label")

    @staticmethod
    def _transformer_class(class_name):
        module = importlib.import_module("pytorch3dunet_tpu_torch.augment.transforms")
        return getattr(module, class_name)

    @classmethod
    def _named_arguments(cls, class_name) -> set[str]:
        """The keyword arguments a transform names, not those its `**kwargs`
        swallows; none for a name that is no transform (its pipeline fails
        when it is built)."""
        try:
            transform = cls._transformer_class(class_name)
        except AttributeError:
            return set()
        parameters = inspect.signature(transform).parameters.values()
        return {p.name for p in parameters if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)}

    def _create_transform(self, phase_name):
        assert phase_name in self.phase_config, f"phase config has no '{phase_name}' pipeline"
        return Compose([self._create_augmentation(entry) for entry in self.phase_config[phase_name]])

    def _create_augmentation(self, entry):
        kwargs = {**self.config_base, **entry, "random_state": np.random.RandomState(self.seed)}
        return self._transformer_class(kwargs["name"])(**kwargs)
