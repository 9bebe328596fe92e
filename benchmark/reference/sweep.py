"""The sliding-window prediction of a whole volume, written out plainly.

The grid is pytorch-3dunet's SliceBuilder: starts every `stride` along an
axis, plus one flush with the axis' end when the last patch stops short. The
volume is mirror-padded (numpy's 'reflect') by the halo, every patch with its
halo goes through the network, the halo is cropped, and the cores are
stitched: `assign` writes each core in grid order (the last write wins);
`gaussian` sums each core times a separable Gaussian window (sigma an eighth
of the core's extent, at least 1; the window floored at 1e-3) and divides by
the summed window. `Standardize` with the volume's own statistics
(`global_normalization`) maps the raw to (x - mean) / max(std, 1e-10), its
mean and population std taken in float64.
"""

import numpy as np
import torch

from benchmark.reference import models


def axis_starts(size: int, patch: int, stride: int) -> list[int]:
    if size < patch:
        raise ValueError(f"an axis of {size} is shorter than the patch's {patch}")
    starts = list(range(0, size - patch + 1, stride))
    if starts[-1] + patch < size:
        starts.append(size - patch)
    return starts


def grid(shape, patch, stride) -> list[tuple[int, int, int]]:
    axes = [axis_starts(s, p, st) for s, p, st in zip(shape, patch, stride)]
    return [(z, y, x) for z in axes[0] for y in axes[1] for x in axes[2]]


def gaussian_window(patch) -> torch.Tensor:
    ws = []
    for s in patch:
        x = torch.arange(s, dtype=torch.float64) - (s - 1) / 2.0
        sigma = max(s * 0.125, 1.0)
        ws.append(torch.exp(-0.5 * (x / sigma) ** 2))
    w = ws[0][:, None, None] * ws[1][None, :, None] * ws[2][None, None, :]
    return w.clamp(min=1e-3).float()


def standardize(volume: np.ndarray) -> np.ndarray:
    v = volume.astype(np.float64)
    return ((v - v.mean()) / max(v.std(), 1e-10)).astype(np.float32)


@torch.no_grad()
def predict(volume: np.ndarray, params: dict, model_cfg: dict, patch, stride, halo, blend: str,
            device, quantize=None) -> np.ndarray:
    """(Cout, D, H, W) float32 probabilities of a (D, H, W) volume, one patch at a time."""
    x = standardize(volume)
    padded = torch.from_numpy(np.pad(x, [(h, h) for h in halo], mode="reflect")).to(device)
    cout = params["final_conv.bias"].shape[0]
    out = torch.zeros((cout, *volume.shape), dtype=torch.float32, device=device)
    weights = torch.zeros(volume.shape, dtype=torch.float32, device=device)
    window = gaussian_window(patch).to(device) if blend == "gaussian" else None
    for z, y, xs in grid(volume.shape, patch, stride):
        block = padded[z:z + patch[0] + 2 * halo[0], y:y + patch[1] + 2 * halo[1], xs:xs + patch[2] + 2 * halo[2]]
        probs, _ = models.forward(params, block[None, None], model_cfg, quantize)
        core = probs[0, :, halo[0]:halo[0] + patch[0], halo[1]:halo[1] + patch[1], halo[2]:halo[2] + patch[2]]
        region = (slice(z, z + patch[0]), slice(y, y + patch[1]), slice(xs, xs + patch[2]))
        if window is None:
            out[(slice(None), *region)] = core
        else:
            out[(slice(None), *region)] += core * window
            weights[region] += window
    if window is not None:
        out /= weights.clamp(min=1e-10)
    return out.cpu().numpy()


def max_gap(a: np.ndarray, b: np.ndarray) -> float:
    """The widest absolute gap between two arrays of one shape (inf on a shape mismatch)."""
    if a.shape != b.shape:
        return float("inf")
    return float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max())

