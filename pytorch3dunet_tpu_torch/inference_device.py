"""Device-side sliding-window inference: the whole patch sweep on the GPU.

The port's counterpart of pytorch3dunet_tpu/inference_device.py
`DeviceSlidingWindow`, for one device. The host loop (`StandardPredictor`)
normalizes each patch on the host and moves every patch up and its prediction
down. Here the mirror-padded volume is uploaded once; a Python loop over the
host-known patch starts issues only device work (slice -> normalize -> forward
-> halo crop -> stitch into accumulators on the device), with no host sync
inside it; the stitched prediction comes back in one download.

Stitching: `blend: assign` writes each core in grid order (write-wins, the
reference's semantics); `blend: gaussian` accumulates cores weighted by a
separable Gaussian window and divides by the summed weights at the end, so
overlapping patches blend instead of overwriting (`sweep_raw` returns the sums
undivided, which the predictor's z-slab streaming merges).

Layout: the port is channels-first. The padded volume is (Dp, Hp, Wp) or
channels-first (C, Dp, Hp, Wp); the output is (Cout, D, H, W), where the JAX
sweep returns channels-last (D, H, W, Cout).

A 2D model sweeps the same (z, y, x) grid with depth-1 patches and no z halo:
the patches of a batch, without their z, are the model's batch, and its
probabilities get their z back before the crop (JAX inference_device.py:95-101,
:218-245).

Normalization: the common test-transformer pipelines run on the device --
`Standardize` with volume statistics (global_normalization) or per-patch
statistics, min-max `Normalize`, and per-patch `PercentileNormalizer`
(`detect_device_path`); other pipelines stay on the host loop.

The sharded sweeps (JAX inference_device.py:310-390), over the ranks of one
host (parallel/__init__.py):
- `mesh`: the patch grid splits across the ranks; each stitches its patches
  into full-volume `out` and `weights` buffers (always weighted: `blend:
  assign` weighs each patch 1, so overlaps average) and one all-reduce sums
  them;
- `spatial_mesh`: every patch's depth splits across the ranks, the model runs
  with halo-exchanged convs and all-reduced statistics (parallel/spatial.py),
  per-patch normalization statistics are all-reduced, and every rank stitches
  the gathered probabilities, so its buffers hold the whole result.
"""

import numpy as np
import torch
import torch.distributed as dist

from pytorch3dunet_tpu_torch.models.unet import is_model_2d
from pytorch3dunet_tpu_torch.ops.tta import flip_combos, patch_axes_to_array_axes, tta_average
from pytorch3dunet_tpu_torch.parallel.mesh import all_reduce_, gather
from pytorch3dunet_tpu_torch.parallel.spatial import (spatial_axis, spatial_min_local, spatial_pool_d,
                                                      spatial_shardable, validate_spatial_model)
from pytorch3dunet_tpu_torch.utils.misc import get_logger

logger = get_logger("DeviceSlidingWindow")


def _gaussian_window(shape, sigma_scale=0.125):
    """Separable Gaussian weight window over a patch core (peak 1 at center), float32."""
    ws = []
    for s in shape:
        x = np.arange(s) - (s - 1) / 2.0
        sigma = max(s * sigma_scale, 1.0)
        ws.append(np.exp(-0.5 * (x / sigma) ** 2))
    w = ws[0][:, None, None] * ws[1][None, :, None] * ws[2][None, None, :]
    return np.maximum(w, 1e-3).astype(np.float32)


def _percentile(flat_sorted: torch.Tensor, q) -> torch.Tensor:
    """`jnp.percentile(x, q)` (q in percent, linear interpolation) of the
    values `flat_sorted` (ascending along the last axis; one percentile per
    row of a 2-D tensor). The two ranks and their weights are computed on the
    host from the static length, so nothing syncs; `torch.quantile` would
    refuse a slab-sized patch."""
    n = flat_sorted.shape[-1]
    position = float(q) / 100.0 * (n - 1)
    low = int(np.floor(position))
    high = min(low + 1, n - 1)
    weight = position - low
    return flat_sorted[..., low] * (1.0 - weight) + flat_sorted[..., high] * weight


def normalize(x: torch.Tensor, mode, stats, per_sample: bool = False) -> torch.Tensor:
    """The device normalizations of the sweep's patches and of the exported
    forward (JAX inference_device.py and export.py `_normalize_fn`), over the
    whole of `x` or, with `per_sample`, over each x[i]. `mode`:
    'standardize' by `stats` mean and std (floats or scalar tensors),
    'standardize_patch' by the mean and population std (as jnp.std),
    'normalize' to [-1, 1] by the min and max, 'percentile' by the `stats`
    pmin and pmax percentiles (a sort and static ranks, `_percentile`); any
    other mode ('none', None) returns x."""
    dims = tuple(range(1 if per_sample else 0, x.ndim))
    if mode == "standardize":
        std = stats["std"]
        std = torch.clamp(std, min=1e-10) if torch.is_tensor(std) else max(std, 1e-10)
        return (x - stats["mean"]) / std
    if mode == "standardize_patch":
        std, mean = torch.std_mean(x, dim=dims, correction=0, keepdim=True)
        return (x - mean) / torch.clamp(std, min=1e-10)
    if mode == "normalize":
        lo, hi = torch.amin(x, dim=dims, keepdim=True), torch.amax(x, dim=dims, keepdim=True)
        return torch.clamp(2 * (x - lo) / (hi - lo + 1e-10) - 1, -1, 1)
    if mode == "percentile":
        rows = torch.sort(x.reshape(x.shape[0] if per_sample else 1, -1), dim=1).values
        shape = (-1,) + (1,) * (x.ndim - 1) if per_sample else (1,) * x.ndim
        lo = _percentile(rows, stats["pmin"]).reshape(shape)
        hi = _percentile(rows, stats["pmax"]).reshape(shape)
        return (x - lo) / (hi - lo + 1e-10)
    return x


class DeviceSlidingWindow:
    """Sliding-window sweep for one (model, patch grid) setup on the model's device.

    Args:
        model: one of the port's models, in eval mode, on its device.
        patch_shape: core patch shape (D, H, W) from the slice builder.
        halo_shape: halo on each side; the network sees patch + 2*halo.
        normalize: 'standardize' | 'standardize_patch' | 'normalize' |
            'percentile' | None.
        stats: dict with 'mean'/'std' ('pmin'/'pmax' for percentile).
        blend: 'assign' (reference parity) or 'gaussian' (weighted blending).
        mesh: a `parallel.mesh.Mesh` of this host's ranks; the patch grid
            splits across them (a mesh of one rank: the unsharded sweep).
        patch_batch: patches forwarded together; the last batch may be smaller
            (the JAX sweep pads it with masked sentinel starts to keep its
            shapes static: the same result).
        tta_axes: patch-space (z, y, x) axes for mirror-flip test-time
            augmentation; every flip combination is forwarded and the
            probabilities averaged. Empty = off. A 2D model cannot mirror z.
        spatial_mesh: a `Mesh` of this host's ranks over which every patch's
            depth is sharded (cooperative sweep): a 3D model the sharding
            supports, patch_batch 1, no percentile normalization, no z-mirror
            TTA, and a padded patch depth that shards exactly.
    """

    def __init__(self, model, patch_shape, halo_shape, normalize=None, stats=None, blend="assign", mesh=None,
                 patch_batch=1, tta_axes=(), spatial_mesh=None):
        if blend not in ("assign", "gaussian"):
            raise ValueError(f"unknown blend {blend!r}: expected 'assign' or 'gaussian'")
        self.model = model
        self.patch_shape = tuple(int(p) for p in patch_shape)
        self.halo_shape = tuple(int(h) for h in halo_shape)
        self.patch_batch = max(1, int(patch_batch))
        self.is_2d = is_model_2d(model)
        if self.is_2d and (self.patch_shape[0] != 1 or self.halo_shape[0] != 0):
            raise ValueError(f"a 2D model sweeps patches of depth 1 with no z halo, got patch {self.patch_shape} "
                             f"and halo {self.halo_shape}")
        if self.is_2d and 0 in tta_axes:
            raise ValueError("a 2D model cannot mirror the z axis")
        self.normalize = normalize
        self.stats = stats or {}
        self.blend = blend
        self.tta_combos = flip_combos(patch_axes_to_array_axes(tta_axes, self.is_2d)) if tta_axes else []
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.spatial_mesh = spatial_mesh if spatial_mesh is not None and spatial_mesh.size > 1 else None
        # (out, weights) summed and divided at the end: gaussian blending, and
        # every sharded sweep (an assign one weighs each patch 1)
        self.weighted = blend == "gaussian" or self.mesh is not None or self.spatial_mesh is not None
        if self.spatial_mesh is not None:
            self._check_spatial(tta_axes)

    def _check_spatial(self, tta_axes):
        """The cooperative sweep's refusals (JAX inference_device.py:130-148)."""
        if self.mesh is not None:
            raise ValueError("spatial_mesh and (grid) mesh are mutually exclusive")
        if self.is_2d:
            raise ValueError("spatial slab sharding is for 3D models")
        if self.patch_batch != 1:
            raise ValueError("spatial sharding sweeps one (large) patch per step: patch_batch must be 1")
        if self.normalize == "percentile":
            raise ValueError("percentile normalization has no cross-shard reduction; use the grid sweep")
        if 0 in tta_axes:
            raise ValueError("z-mirror TTA cannot flip across spatial shards; restrict tta_axes to (1, 2)")
        validate_spatial_model(self.model)
        pz = self.patch_shape[0] + 2 * self.halo_shape[0]
        n, levels = self.spatial_mesh.size, len(self.model.encoders)
        if not spatial_shardable(pz, levels, n, pool=spatial_pool_d(self.model),
                                 min_local=spatial_min_local(self.model)):
            raise ValueError(f"padded patch depth {pz} is not exactly shardable {n} ways through {levels} pooling "
                             "levels")

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _stats_tensors(self, stats=None):
        """The statistics as float32 scalars on the device (the JAX sweep's
        traced float32 scalars)."""
        stats = self.stats if stats is None else stats
        if self.normalize == "standardize":
            keys = {"mean": stats["mean"], "std": stats["std"]}
        elif self.normalize == "percentile":
            return {"pmin": float(stats.get("pmin", 1.0)), "pmax": float(stats.get("pmax", 99.6))}
        else:
            return {}
        return {k: torch.tensor(np.float32(v), device=self.device) for k, v in keys.items()}

    def _apply_model(self, x):
        """Model-ready (N, C, D, H, W) batch, or (N, C, H, W) for a 2D model,
        -> float32 probabilities; mirror-TTA-averaged when on."""

        def run(xi):
            return self.model(xi)[0]

        if not self.tta_combos:
            return run(x)
        return tta_average(run, x, self.tta_combos)

    def _forward_cores(self, padded_volume, starts_b, stats):
        """The patches at `starts_b` (host ints) in one forward: slice ->
        normalize -> model -> halo crop; (B, Cout, *patch_shape) float32."""
        hz, hy, hx = self.halo_shape
        cz, cy, cx = self.patch_shape
        pz, py, px = cz + 2 * hz, cy + 2 * hy, cx + 2 * hx
        patches = [normalize(padded_volume[:, z : z + pz, y : y + py, x : x + px], self.normalize, stats)
                   for z, y, x in starts_b]
        batch = torch.stack(patches)
        if self.is_2d:
            probs = self._apply_model(batch[:, :, 0])[:, :, None]
        else:
            probs = self._apply_model(batch)
        return probs[:, :, hz : hz + cz, hy : hy + cy, hx : hx + cx].float()

    def _accumulate(self, padded_volume, starts, stats):
        """Sweeps `starts`, accumulating (out, weights) on the device: the
        window-weighted sums of the cores and of the window under `blend:
        gaussian`; each core written over (the reference's write-wins) and no
        weights under `blend: assign`."""
        cout = self.model.out_channels
        out_spatial = tuple(s - 2 * h for s, h in zip(padded_volume.shape[1:], self.halo_shape))
        out = torch.zeros((cout, *out_spatial), dtype=torch.float32, device=padded_volume.device)
        weights = window = None
        if self.weighted:
            weights = torch.zeros(out_spatial, dtype=torch.float32, device=padded_volume.device)
            window = self._window(padded_volume.device)
        cz, cy, cx = self.patch_shape
        starts = [tuple(int(v) for v in s) for s in starts]  # host ints: slicing issues no sync
        for i in range(0, len(starts), self.patch_batch):
            batch = starts[i : i + self.patch_batch]
            cores = self._forward_cores(padded_volume, batch, stats)
            for (z, y, x), core in zip(batch, cores):
                region = (slice(z, z + cz), slice(y, y + cy), slice(x, x + cx))
                if weights is None:
                    out[(slice(None), *region)] = core
                else:
                    out[(slice(None), *region)] += core * window
                    weights[region] += window
        return out, weights

    def _window(self, device):
        """The weight of each core voxel: the Gaussian window under `blend:
        gaussian`, ones otherwise (a weighted assign sweep averages overlaps)."""
        if self.blend == "gaussian":
            return torch.from_numpy(_gaussian_window(self.patch_shape)).to(device)
        return torch.ones(self.patch_shape, dtype=torch.float32, device=device)

    def _sweep_sharded(self, padded_volume, starts, stats):
        """The patch grid split across the mesh in contiguous shares (JAX
        `_sweep_sharded`): each rank accumulates its share into full-volume
        buffers and one all-reduce of each sums the partials."""
        share = -(-len(starts) // self.mesh.size)
        mine = starts[self.mesh.index * share:(self.mesh.index + 1) * share]
        out, weights = self._accumulate(padded_volume, mine, stats)
        return all_reduce_(out, self.mesh), all_reduce_(weights, self.mesh)

    def _normalize_chunk(self, chunk, stats, patch_elems):
        """Per-patch normalization of a depth shard of the patch, with the
        statistics reduced over the whole patch (JAX `_normalize_chunk_psum`)."""
        if self.normalize == "standardize_patch":
            sums = all_reduce_(torch.stack([chunk.sum(), (chunk * chunk).sum()]), self.spatial_mesh)
            mean = sums[0] / patch_elems
            std = torch.sqrt(torch.clamp(sums[1] / patch_elems - mean * mean, min=0.0))
            return (chunk - mean) / torch.clamp(std, min=1e-10)
        if self.normalize == "normalize":
            # one MAX all-reduce of (-min, max)
            ends = all_reduce_(torch.stack([-chunk.min(), chunk.max()]), self.spatial_mesh, dist.ReduceOp.MAX)
            lo, hi = -ends[0], ends[1]
            return torch.clamp(2 * (chunk - lo) / (hi - lo + 1e-10) - 1, -1, 1)
        return normalize(chunk, self.normalize, stats)

    def _sweep_spatial(self, padded_volume, starts, stats):
        """Every patch's depth split across the space mesh (JAX
        `_sweep_spatial`): each rank slices its depth shard of the halo'd
        patch from the whole volume, normalizes it with all-reduced
        statistics, runs the model under `spatial_axis`, and stitches the
        gathered probabilities; every rank's buffers hold the whole result."""
        mesh = self.spatial_mesh
        hz, hy, hx = self.halo_shape
        cz, cy, cx = self.patch_shape
        pz, py, px = cz + 2 * hz, cy + 2 * hy, cx + 2 * hx
        dz = pz // mesh.size
        cout = self.model.out_channels
        out_spatial = tuple(s - 2 * h for s, h in zip(padded_volume.shape[1:], self.halo_shape))
        out = torch.zeros((cout, *out_spatial), dtype=torch.float32, device=padded_volume.device)
        weights = torch.zeros(out_spatial, dtype=torch.float32, device=padded_volume.device)
        window = self._window(padded_volume.device)
        patch_elems = pz * py * px * padded_volume.shape[0]
        for z, y, x in (tuple(int(v) for v in s) for s in starts):
            z0 = z + mesh.index * dz
            chunk = self._normalize_chunk(padded_volume[:, z0:z0 + dz, y:y + py, x:x + px], stats, patch_elems)
            with spatial_axis(mesh):
                probs = self._apply_model(chunk[None])
            full = gather(probs, mesh, 2)[0]
            core = full[:, hz:hz + cz, hy:hy + cy, hx:hx + cx].float()
            region = (slice(z, z + cz), slice(y, y + cy), slice(x, x + cx))
            out[(slice(None), *region)] += core * window
            weights[region] += window
        return out, weights

    def upload(self, padded_volume) -> torch.Tensor:
        """The padded volume as a float32 (C, Dp, Hp, Wp) tensor on the device:
        a numpy (Dp, Hp, Wp) or channels-first (C, Dp, Hp, Wp) volume is
        uploaded once; a tensor already there is used as it is."""
        if isinstance(padded_volume, torch.Tensor):
            t = padded_volume
        else:
            t = torch.from_numpy(np.ascontiguousarray(padded_volume, dtype=np.float32))
        if t.ndim == 3:
            t = t[None]
        return t.to(self.device, torch.float32)

    def _sweep(self, padded_volume, starts, stats=None):
        """(out, weights|None) as tensors on the device, undivided."""
        with torch.inference_mode():
            volume, stats = self.upload(padded_volume), self._stats_tensors(stats)
            if self.mesh is not None:
                return self._sweep_sharded(volume, starts, stats)
            if self.spatial_mesh is not None:
                return self._sweep_spatial(volume, starts, stats)
            return self._accumulate(volume, starts, stats)

    def sweep_raw(self, padded_volume, starts: np.ndarray, stats=None):
        """One sweep over `starts`; returns numpy (out (Cout, D, H, W),
        weights (D, H, W) | None) UNDIVIDED, so callers can accumulate partial
        sweeps (volume chunking). `stats` default to the constructor's."""
        out, weights = self._sweep(padded_volume, starts, stats)
        return out.cpu().numpy(), (None if weights is None else weights.cpu().numpy())

    def __call__(self, padded_volume, starts: np.ndarray, stats=None) -> np.ndarray:
        """Runs the sweep; returns the stitched (Cout, D, H, W) volume."""
        out, weights = self._sweep(padded_volume, starts, stats)
        if weights is not None:
            out = out / torch.clamp(weights, min=1e-10)[None]
        return out.cpu().numpy()


def detect_device_path(transformer_config, global_stats) -> tuple[str | None, dict] | None:
    """Maps a test raw-transformer config onto the on-device normalization ops.

    Returns (normalize_mode, stats) when the pipeline is supported, else None.
    """
    names = [t["name"] for t in transformer_config]
    tail = [n for n in names if n != "ToTensor"]
    # channelwise normalization computes per-channel statistics on host; the
    # device ops reduce jointly — fall back rather than silently diverge
    if any(t.get("channelwise") for t in transformer_config):
        return None
    if tail == ["Standardize"]:
        cfg = next(t for t in transformer_config if t["name"] == "Standardize")
        if "mean" in cfg or (global_stats and global_stats.get("mean") is not None):
            stats = {"mean": cfg.get("mean", (global_stats or {}).get("mean")),
                     "std": cfg.get("std", (global_stats or {}).get("std"))}
            return "standardize", stats
        return "standardize_patch", {}
    if tail == ["Normalize"]:
        cfg = next(t for t in transformer_config if t["name"] == "Normalize")
        # the device op implements the DEFAULT semantics only (patch-local
        # min/max scaled to [-1, 1]); norm01 / fixed min_value/max_value
        # configs fall back to the host loop rather than silently diverge
        if cfg.get("norm01") or cfg.get("min_value") is not None or cfg.get("max_value") is not None:
            return None
        return "normalize", {}
    if tail == ["PercentileNormalizer"]:
        # merge base stats exactly like Transformer._create_augmentation does
        cfg = {**(global_stats or {}), **next(t for t in transformer_config if t["name"] == "PercentileNormalizer")}
        pmin = cfg.get("pmin")
        pmax = cfg.get("pmax")
        return "percentile", {"pmin": 1.0 if pmin is None else pmin, "pmax": 99.6 if pmax is None else pmax}
    if tail == []:
        return None, {}
    return None
