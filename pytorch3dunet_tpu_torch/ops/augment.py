"""Device augmentation of the port: the movable transforms of the train
pipeline and its label engineering, run on the card.

The port's counterpart of pytorch3dunet_tpu/ops/augment.py. The host
pipeline (augment/transforms.py) defines the semantics; with
`loaders.device_augment: true` the trainer strips the movable transforms from
it (`split_device_transforms`) and runs them here, on each uploaded train
batch, after the host transforms that stay.

Every random op has two layers:
- a draw function (`draw_*`) takes the generators and returns the op's random
  values: scalars from a CPU `torch.Generator` (host floats and ints, so the
  op can branch in Python without a device sync and does no work when it is
  skipped), fields from a generator on the device (left on the device);
- an apply function, deterministic in those values.
The CPU tests feed the apply layer the JAX package's own draws, replayed from
the same key; the trainer draws from its generators.

Tensors are NCDHW as everywhere in the port; the single-sample ops take
(C, D, H, W) and the label engineering (D, H, W) -> (C, D, H, W). Spatial axes
are numbered 0, 1, 2 for D, H, W, as the JAX package numbers them in its
channels-last (D, H, W, C) samples. Resampling is written as explicit index
gathers: order 0 rounds half away from zero (`lax.round`, not torch's half
to even) and every order reflects out-of-range indices as scipy's 'reflect'
does. The spline prefilter and the resize of the elastic field are f32
matmuls: on CUDA they need TF32 off, which `config.resolve_device` ensures.

Integer labels are cast to float32 for rotate, elastic and the label
engineering and back after, as the JAX package does, so instance ids at or
above 2**24 merge in both.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F

from pytorch3dunet_tpu_torch.utils.misc import get_logger

logger = get_logger("DeviceAugment")


# --------------------------------------------------------------------- draws

def _uniform(host, low=0.0, high=1.0, n=1) -> list[float]:
    """n host floats uniform in [low, high) from the CPU generator `host`."""
    return [low + (high - low) * u for u in torch.rand(n, generator=host, dtype=torch.float64).tolist()]


def _randint(host, low, high) -> int:
    return int(torch.randint(low, high, (1,), generator=host).tolist()[0])


def draw_flip(host) -> dict:
    """`random_flip`'s three uniforms (one per spatial axis)."""
    return {"u": _uniform(host, n=3)}


def draw_rotate90(host) -> dict:
    """`random_rotate90`'s multiple of 90 degrees, 0..3."""
    return {"k": _randint(host, 0, 4)}


def draw_rotate(host, n_planes: int, angle_spectrum: float) -> dict:
    """`random_rotate`'s plane index and angle in degrees."""
    return {"plane": _randint(host, 0, n_planes), "angle": _uniform(host, -angle_spectrum, angle_spectrum)[0]}


def draw_contrast(host, alpha=(0.5, 1.5)) -> dict:
    u, a = _uniform(host)[0], _uniform(host, *alpha)[0]
    return {"u": u, "alpha": a}


def draw_gaussian_noise(host, device_gen, shape, scale=(0.0, 1.0), execution_probability=0.1) -> dict:
    """The uniform, the std and, when the transform runs, a standard normal field of `shape`."""
    u, std = _uniform(host)[0], _uniform(host, *scale)[0]
    noise = (torch.randn(shape, generator=device_gen, device=device_gen.device)
             if u < execution_probability else None)
    return {"u": u, "std": std, "noise": noise}


def draw_poisson_noise(host, device_gen, shape, lam=(0.0, 1.0), execution_probability=0.1) -> dict:
    """The uniform, the rate and, when the transform runs, a Poisson field of `shape` at that rate."""
    u, rate = _uniform(host)[0], _uniform(host, *lam)[0]
    noise = None
    if u < execution_probability:
        noise = torch.poisson(torch.full(shape, rate, device=device_gen.device), generator=device_gen)
    return {"u": u, "rate": rate, "noise": noise}


def draw_blur(host, sigma=(0.1, 2.0)) -> dict:
    u, s = _uniform(host)[0], _uniform(host, *sigma)[0]
    return {"u": u, "sigma": s}


def _coarse_shape(spatial, grid_downsample: int) -> tuple:
    return tuple(max(2, s // grid_downsample) for s in spatial)


def draw_elastic(host, device_gen, spatial, execution_probability=0.1, apply_3d=True, grid_downsample=8) -> dict:
    """The uniform and, when the transform runs, the three standard normal
    coarse fields (z, y, x; z is None without `apply_3d`)."""
    u = _uniform(host)[0]
    fields = None
    if u < execution_probability:
        coarse = _coarse_shape(spatial, grid_downsample)
        fields = [torch.randn(coarse, generator=device_gen, device=device_gen.device) if apply_3d or axis else None
                  for axis in range(3)]
    return {"u": u, "fields": fields}


def draw_label_to_affinities(host, max_offset: int = 10) -> dict:
    """`random_label_to_affinities`' offset (before the z scaling) and axis (X, Y, Z order)."""
    return {"offset": _randint(host, 1, max_offset + 1), "axis": _randint(host, 0, 3)}


# ------------------------------------------------------------ intensity ops

def random_flip(x, u, axis_prob: float = 0.5):
    """Flips spatial axis a of a (C, D, H, W) sample where u[a] > axis_prob
    (RandomFlip, JAX augment.py:23)."""
    for axis in range(3):
        if u[axis] > axis_prob:
            x = x.flip(axis + 1)
    return x


def random_rotate90(x, k: int):
    """Rotates a (C, D, H, W) sample by k * 90 degrees in the HW plane (square HW)."""
    assert x.shape[2] == x.shape[3], "device rot90 requires square HW patches"
    return torch.rot90(x, k, dims=(2, 3)) if k % 4 else x


def random_contrast(x, u, alpha, mean: float = 0.0, execution_probability: float = 0.1):
    if u >= execution_probability:
        return x
    return torch.clamp(mean + alpha * (x - mean), -1, 1)


def additive_gaussian_noise(x, u, std, noise, execution_probability: float = 0.1):
    if u >= execution_probability:
        return x
    return x + std * noise.to(x.dtype)


def additive_poisson_noise(x, u, noise, execution_probability: float = 0.1):
    if u >= execution_probability:
        return x
    return x + noise.to(x.dtype)


def _separable_gaussian_1d(sigma, radius: int, device=None):
    t = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    w = torch.exp(-0.5 * (t / sigma) ** 2)
    return w / w.sum()


def _conv_axis(f, w, axis: int, padding: int):
    """f (C, 1, D, H, W) convolved along spatial `axis` with the 1D kernel w,
    zero padding `padding` on that axis."""
    shape = [1, 1, 1, 1, 1]
    shape[axis + 2] = w.numel()
    pad = [0, 0, 0]
    pad[axis] = padding
    return F.conv3d(f, w.reshape(shape), padding=tuple(pad))


def gaussian_blur(x, u, sigma, execution_probability: float = 0.5, radius: int = 8):
    """Separable Gaussian blur of a (C, D, H, W) sample at `sigma`, truncated at
    `radius`, edge-replicated borders (GaussianBlur3D, JAX augment.py:77)."""
    if u >= execution_probability:
        return x
    w = _separable_gaussian_1d(sigma, radius, x.device)
    blurred = x.float()[:, None]
    for axis in range(3):
        pad = [0] * 6
        pad[4 - 2 * axis: 6 - 2 * axis] = [radius, radius]  # F.pad lists W first
        blurred = _conv_axis(F.pad(blurred, pad, mode="replicate"), w, axis, 0)
    return blurred[:, 0].to(x.dtype)


# ----------------------------------------------------------------- geometry

def _reflect_index(i, n: int):
    """scipy 'reflect' index extension (d c b a | a b c d | d c b a); Python's
    modulo, so negative indices reflect too."""
    i = torch.remainder(i, 2 * n)
    return torch.where(i >= n, 2 * n - 1 - i, i)


def _round_half_away(t):
    """`lax.round`: half away from zero (torch.round rounds half to even)."""
    whole = torch.trunc(t)
    return whole + torch.where((t - whole).abs() >= 0.5, torch.sign(t), torch.zeros_like(t))


def _flat_index(idx, shape):
    """Flat index of per-axis (broadcastable) indices into a C-ordered volume of `shape`."""
    return (idx[0] * shape[1] + idx[1]) * shape[2] + idx[2]


def map_coordinates(data, coords, order: int):
    """scipy/JAX `map_coordinates(data, coords, order, mode='reflect')` of a
    (D, H, W) volume, orders 0 and 1 (jax.scipy.ndimage.map_coordinates, which
    JAX augment.py:234 and :266 call). `coords` are three float tensors
    broadcastable to the output shape."""
    assert order in (0, 1), "map_coordinates supports orders 0 and 1; order 3 is map_coordinates_cubic"
    flat = data.reshape(-1)
    shape = data.shape
    if order == 0:
        idx = [_reflect_index(_round_half_away(c).long(), n) for c, n in zip(coords, shape)]
        out_shape = torch.broadcast_shapes(*(c.shape for c in coords))
        return flat[_flat_index(idx, shape)].expand(out_shape)
    nodes = []
    for c, n in zip(coords, shape):
        lower = torch.floor(c)
        upper_w = c - lower
        index = lower.long()
        nodes.append([(_reflect_index(index, n), 1 - upper_w), (_reflect_index(index + 1, n), upper_w)])
    out = None
    # the JAX order: itertools.product over the axes' (lower, upper) nodes
    for nz in nodes[0]:
        for ny in nodes[1]:
            for nx in nodes[2]:
                term = nz[1] * ny[1] * nx[1] * flat[_flat_index((nz[0], ny[0], nx[0]), shape)]
                out = term if out is None else out + term
    return out


@functools.lru_cache(maxsize=32)
def _bspline3_inverse_matrix(n: int) -> np.ndarray:
    """Inverse of the cubic-B-spline interpolation matrix of an n-sample
    signal with scipy's 'reflect' boundary, built in float64 and cast to
    float32 (JAX augment.py:101)."""
    m = np.zeros((n, n), dtype=np.float64)
    for i in range(n):
        m[i, i] = 4.0 / 6.0
        for j in (i - 1, i + 1):
            r = j if 0 <= j < n else (0 if j < 0 else n - 1)  # reflect
            m[i, r] += 1.0 / 6.0
    return np.linalg.inv(m).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _bspline3_inverse_on(n: int, device):
    """`_bspline3_inverse_matrix(n)` on `device`, uploaded once."""
    return torch.from_numpy(_bspline3_inverse_matrix(n)).to(device)


def _bspline3_prefilter(data):
    """Per-axis exact cubic-B-spline prefilter of a (D, H, W) float32 volume:
    one dense f32 matmul per axis."""
    for axis in range(3):
        inv = _bspline3_inverse_on(data.shape[axis], data.device)
        data = torch.movedim(torch.tensordot(inv, torch.movedim(data, axis, 0), dims=1), 0, axis)
    return data


def _bspline3_weights(t):
    t2, t3 = t * t, t * t * t
    return ((1 - 3 * t + 3 * t2 - t3) / 6.0,  # tap at floor - 1
            (4 - 6 * t2 + 3 * t3) / 6.0,  # floor
            (1 + 3 * t + 3 * t2 - 3 * t3) / 6.0,  # floor + 1
            t3 / 6.0)  # floor + 2


def map_coordinates_cubic(data, coords):
    """Cubic B-spline `map_coordinates` with 'reflect' boundary of a (D, H, W)
    volume (JAX augment.py:135, scipy's order 3): the exact spline
    coefficients, then the 64-tap separable kernel."""
    c = _bspline3_prefilter(data.float())
    shape = c.shape
    base = [torch.floor(g) for g in coords]
    w = [_bspline3_weights(g - b) for g, b in zip(coords, base)]
    idx = [[_reflect_index(b.long() + o - 1, n) for o in range(4)] for b, n in zip(base, shape)]
    flat = c.reshape(-1)
    out = torch.zeros(torch.broadcast_shapes(*(g.shape for g in coords)), dtype=torch.float32, device=data.device)
    for a in range(4):
        za = idx[0][a] * shape[1]
        for b in range(4):
            yb = (za + idx[1][b]) * shape[2]
            wab = w[0][a] * w[1][b]
            for d in range(4):
                out = out + wab * w[2][d] * flat[yb + idx[2][d]]
    return out


def _resample(x, coords, spline_order: int):
    """Each channel of a (C, D, H, W) sample at `coords`, in float32."""
    x = x.float()
    if spline_order == 3:
        return torch.stack([map_coordinates_cubic(ch, coords) for ch in x])
    return torch.stack([map_coordinates(ch, coords, spline_order) for ch in x])


def _grid(spatial, device):
    """The three float32 index grids of `spatial`, each shaped to broadcast."""
    grids = []
    for axis, n in enumerate(spatial):
        shape = [1, 1, 1]
        shape[axis] = n
        grids.append(torch.arange(n, dtype=torch.float32, device=device).reshape(shape))
    return grids


def _linear_resize_matrix(n_in: int, n_out: int, device):
    """(n_in, n_out) weights of `jax.image.resize(..., "linear")` along one
    axis: the triangle kernel at half-pixel centres, widened when
    downsampling (antialias), normalized per output, and zero for outputs
    whose centre lies outside the input (jax._src.image.scale
    `compute_weight_mat`)."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    t = (sample_f[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None]).abs() / kernel_scale
    weights = torch.clamp(1 - t, min=0)
    total = weights.sum(0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def _linear_resize(f, shape):
    """`jax.image.resize(f, shape, "linear")` of a (D, H, W) field: one f32
    contraction per axis whose size changes."""
    for axis, n_out in enumerate(shape):
        if f.shape[axis] != n_out:
            m = _linear_resize_matrix(f.shape[axis], n_out, f.device)
            f = torch.movedim(torch.tensordot(torch.movedim(f, axis, -1), m, dims=1), -1, axis)
    return f


def elastic_deformation(x, u, fields, spline_order: int, alpha: float = 2000.0, sigma: float = 50.0,
                        execution_probability: float = 0.1, apply_3d: bool = True, grid_downsample: int = 8):
    """Elastic deformation of a (C, D, H, W) sample by Gaussian-smoothed
    displacement fields (ElasticDeformation, JAX augment.py:178): each coarse
    field (`grid_downsample` coarser) is smoothed at sigma / grid_downsample
    with zero padding, resized linearly to the sample and scaled by
    alpha * grid_downsample**-1.5; the sample is resampled at the displaced
    grid with `spline_order` 0, 1 or 3. The same draw gives raw and label the
    same displacement."""
    assert spline_order in (0, 1, 3), "device elastic deformation supports spline orders 0, 1 and 3"
    if u >= execution_probability:
        return x
    spatial = tuple(x.shape[1:])
    sig = sigma / grid_downsample
    radius = max(2, int(2 * sig))
    w = _separable_gaussian_1d(sig, radius, x.device)

    def smooth_field(f):
        f = f.to(device=x.device, dtype=torch.float32)[None, None]
        for axis in range(3):
            f = _conv_axis(f, w, axis, radius)
        return _linear_resize(f[0, 0], spatial) * (alpha * grid_downsample**-1.5)

    # fields[0] is None without apply_3d: z stays on the grid
    coords = [g if f is None or not (apply_3d or axis) else g + smooth_field(f)
              for axis, (g, f) in enumerate(zip(_grid(spatial, x.device), fields))]
    return _resample(x, coords, spline_order).to(x.dtype)


def random_rotate(x, plane: int, angle: float, axes=((2, 1),), spline_order: int = 1):
    """Rotation of a (C, D, H, W) sample by `angle` degrees in the spatial
    plane axes[plane] about its centre, sampled inversely with 'reflect'
    borders (RandomRotate, JAX augment.py:241; scipy.ndimage.rotate with
    reshape=False). Orders 0, 1 and 3."""
    assert spline_order in (0, 1, 3)
    radians = np.float32(angle) * np.float32(np.pi) / np.float32(180.0)
    cos, sin = float(np.cos(radians)), float(np.sin(radians))
    spatial = tuple(x.shape[1:])
    a0, a1 = axes[plane]
    c0, c1 = (spatial[a0] - 1) / 2.0, (spatial[a1] - 1) / 2.0
    grids = _grid(spatial, x.device)
    g0, g1 = grids[a0] - c0, grids[a1] - c1
    coords = list(grids)
    coords[a0] = g0 * cos - g1 * sin + c0
    coords[a1] = g0 * sin + g1 * cos + c1
    return _resample(x, coords, spline_order).to(x.dtype)


# -------------------------------------------------------- label engineering

def _edge_pad(label):
    for dim in range(3):
        label = torch.cat([label.narrow(dim, 0, 1), label, label.narrow(dim, label.shape[dim] - 1, 1)], dim)
    return label


def thick_boundary(label, connectivity: int = 2):
    """`find_boundaries(mode='thick')` of a (D, H, W) label: a voxel is
    boundary where the max and the min label over its footprint (offsets in
    {-1, 0, 1}^3 with 1..connectivity nonzero coordinates) differ, with edge
    replication (JAX augment.py:275)."""
    padded = _edge_pad(label)
    d, h, w = label.shape
    mx = mn = label
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                order = (dz != 0) + (dy != 0) + (dx != 0)
                if order == 0 or order > connectivity:
                    continue
                sl = padded[1 + dz: 1 + dz + d, 1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]
                mx = torch.maximum(mx, sl)
                mn = torch.minimum(mn, sl)
    return mx != mn


def _recover_ignore(result, label, ignore_index):
    if ignore_index is None:
        return result
    return torch.where(label == ignore_index, torch.full_like(result, float(ignore_index)), result)


def standard_label_to_boundary(label, ignore_index=None, append_label=False, foreground=False):
    """StandardLabelToBoundary, mode 'thick', connectivity 2 (JAX
    augment.py:305): (D, H, W) label -> (C, D, H, W) float32."""
    b = _recover_ignore(thick_boundary(label).float(), label, ignore_index)
    channels = []
    if foreground:
        channels.append(_recover_ignore((label > 0).float(), label, ignore_index))
    channels.append(b)
    if append_label:
        channels.append(label.float())
    return torch.stack(channels)


def blobs_to_mask(label, append_label=False):
    """BlobsToMask without the boundary option (JAX augment.py:318): the
    foreground mask (+ the label) channels."""
    channels = [(label > 0).float()]
    if append_label:
        channels.append(label.float())
    return torch.stack(channels)


def _axis_affinity(label, volume_axis: int, offset: int):
    """One affinity channel: 1 where the label at i + ceil(offset / 2) differs
    from the label at i - floor(offset / 2) along `volume_axis`, indices
    reflected (JAX augment.py:327)."""
    n = label.shape[volume_axis]
    i = torch.arange(n, device=label.device)
    hi = _reflect_index(i + (offset + 1) // 2, n)
    lo = _reflect_index(i - offset // 2, n)
    return (label.index_select(volume_axis, hi) != label.index_select(volume_axis, lo)).float()


# reference kernel emission order is X, Y, Z = volume axes 2, 1, 0
_AFFINITY_VOLUME_AXES = (2, 1, 0)


def label_to_affinities(label, offsets, z_offsets=None, aggregate_affinities=False, append_label=False,
                        ignore_index=None):
    """LabelToAffinities (JAX augment.py:348): one channel per (offset, axis)
    pair in X, Y, Z order, optionally OR-aggregated over the three axes."""
    z_offsets = list(offsets) if z_offsets is None else list(z_offsets)
    assert len(z_offsets) == len(offsets)
    channels = []
    for xy, z in zip(offsets, z_offsets):
        triple = [_axis_affinity(label, axis, z if axis == 0 else xy) for axis in _AFFINITY_VOLUME_AXES]
        if aggregate_affinities:
            channels.append(_recover_ignore(torch.maximum(torch.maximum(triple[0], triple[1]), triple[2]), label,
                                            ignore_index))
        else:
            channels.extend(_recover_ignore(c, label, ignore_index) for c in triple)
    if append_label:
        channels.append(label.float())
    return torch.stack(channels)


def label_to_z_affinities(label, offsets, append_label=False, ignore_index=None):
    """LabelToZAffinities (JAX augment.py:371): affinities along z only."""
    channels = [_recover_ignore(_axis_affinity(label, 0, o), label, ignore_index) for o in offsets]
    if append_label:
        channels.append(label.float())
    return torch.stack(channels)


def random_label_to_affinities(label, offset: int, axis: int, z_offset_scale: int = 2, append_label=False,
                               ignore_index=None):
    """RandomLabelToAffinities (JAX augment.py:380): one affinity channel at
    the drawn offset along the drawn axis (X, Y, Z order); a z offset is
    divided by `z_offset_scale`, at least 1."""
    if axis == 2:
        offset = max(1, offset // z_offset_scale)
    channels = [_recover_ignore(_axis_affinity(label, _AFFINITY_VOLUME_AXES[axis], offset), label, ignore_index)]
    if append_label:
        channels.append(label.float())
    return torch.stack(channels)


def label_to_boundary_and_affinities(label, xy_offsets, z_offsets, append_label=False, ignore_index=None,
                                     foreground=False):
    """LabelToBoundaryAndAffinities, mode 'thick' (JAX augment.py:399)."""
    b = standard_label_to_boundary(label, ignore_index=ignore_index, foreground=foreground)
    a = label_to_affinities(label, xy_offsets, z_offsets, append_label=append_label, ignore_index=ignore_index)
    return torch.cat([b, a])


def label_to_mask_and_affinities(label, xy_offsets, z_offsets, append_label=False, background=0,
                                 ignore_index=None):
    """LabelToMaskAndAffinities (JAX augment.py:410)."""
    mask = (label > background).float()[None]
    a = label_to_affinities(label, xy_offsets, z_offsets, append_label=append_label, ignore_index=ignore_index)
    return torch.cat([mask, a])


def paired_geometric(raw, label, flip: dict, rot90: dict | None = None, axis_prob: float = 0.5):
    """Flip (and rot90 with its draw) applied alike to a raw and a label
    sample (JAX augment.py:420)."""
    raw, label = random_flip(raw, flip["u"], axis_prob), random_flip(label, flip["u"], axis_prob)
    if rot90 is not None:
        raw, label = random_rotate90(raw, rot90["k"]), random_rotate90(label, rot90["k"])
    return raw, label


# ------------------------------------------------------------------- config

# transforms that can move from the host pipeline onto the device
DEVICE_MOVABLE = {
    "RandomFlip", "RandomRotate90", "RandomRotate", "ElasticDeformation",
    "AdditiveGaussianNoise", "AdditivePoissonNoise", "GaussianBlur3D", "RandomContrast",
}
_PAIRED = {"RandomFlip", "RandomRotate90", "RandomRotate", "ElasticDeformation"}
# geometric transforms that do not commute with label engineering: when the
# engineering stays on the host they must not run after it on the device
_ORDER_SENSITIVE = {"RandomRotate", "ElasticDeformation"}


def _rotate_axes(cfg) -> tuple:
    axes = cfg.get("axes") or [(1, 0), (2, 1), (2, 0)]
    return tuple(tuple(a) for a in axes)


def _label_post_movable(cfg: dict) -> bool:
    """True when a label-engineering transform has an exact device op."""
    name = cfg.get("name")
    if name == "StandardLabelToBoundary":
        return cfg.get("mode", "thick") == "thick"
    if name == "BlobsToMask":
        return not cfg.get("boundary", False)
    if name in ("LabelToAffinities", "LabelToZAffinities", "RandomLabelToAffinities", "LabelToMaskAndAffinities"):
        return True
    if name == "LabelToBoundaryAndAffinities":
        return cfg.get("mode", "thick") == "thick"
    return False


def _plain_to_tensor(cfg) -> bool:
    # a normalize/dtype-carrying ToTensor would run before the moved
    # engineering (on the raw label): only a plain float cast is safe
    return (cfg.get("name") == "ToTensor" and not cfg.get("normalize", False)
            and cfg.get("dtype", "float32") in ("float32", np.float32, float))


def split_device_transforms(loaders_config: dict):
    """Strips the device-movable transforms from the train transformer of
    `loaders_config` (in place) and returns the device spec
    {"paired", "raw_only", "label_post"}, or None without `device_augment`
    (JAX augment.py:468).

    Geometric transforms present for both raw and label become "paired"
    (one draw for both); the others move as "raw_only". The device runs
    after the host transforms that stay. A label pipeline left as exactly
    [movable engineering, plain ToTensor] moves its engineering to the device
    ("label_post", after the geometry, as on the host) and its ToTensor gains
    `expand_dims`. When engineering without a device op stays on the host,
    RandomRotate and ElasticDeformation stay there too, with a warning, so
    that it still sees the deformed label."""
    if not loaders_config.get("device_augment", False):
        return None
    train_tf = loaders_config["train"]["transformer"]
    spec = {"paired": [], "raw_only": []}
    label_tfs = train_tf.get("label", [])
    label_names = {t["name"] for t in label_tfs}
    raw_names = {t["name"] for t in train_tf.get("raw", [])}

    # whether the label engineering can move is decided on the residue after
    # stripping the paired geometric transforms
    residual = [t for t in label_tfs if not (t["name"] in _PAIRED and t["name"] in raw_names)]
    post_cfg = None
    if len(residual) == 2 and _plain_to_tensor(residual[1]) and _label_post_movable(residual[0]):
        post_cfg = residual[0]
    host_engineering = post_cfg is None and any(t.get("name") != "ToTensor" for t in residual)

    movable = set(DEVICE_MOVABLE)
    if host_engineering and (_ORDER_SENSITIVE & raw_names):
        movable -= _ORDER_SENSITIVE
        blockers = [t["name"] for t in residual if t.get("name") != "ToTensor"]
        logger.warning(
            f"label engineering {blockers} has no device kernel; keeping "
            f"{sorted(_ORDER_SENSITIVE & raw_names)} on the host pipeline so the "
            "engineering still sees the deformed label (reference ordering). "
            "Flips/rot90 still run on device."
        )

    kept_raw = []
    for t in train_tf.get("raw", []):
        if t["name"] in movable:
            if t["name"] in _PAIRED and t["name"] in label_names:
                label_cfg = next(lt for lt in train_tf["label"] if lt["name"] == t["name"])
                spec["paired"].append({"raw": dict(t), "label": dict(label_cfg)})
            else:
                spec["raw_only"].append(dict(t))
        else:
            kept_raw.append(t)
    train_tf["raw"] = kept_raw
    # strip only the label transforms that moved with a raw counterpart: a
    # label-only geometric transform stays on the host
    moved_paired = {p["label"]["name"] for p in spec["paired"]}
    train_tf["label"] = [t for t in train_tf.get("label", []) if t["name"] not in moved_paired]

    spec["label_post"] = None
    if post_cfg is not None:
        remaining = train_tf["label"]
        assert len(remaining) == 2 and remaining[0] == post_cfg, remaining
        spec["label_post"] = dict(post_cfg)
        # the raw label leaves the host 3D; the device stacks the channels
        train_tf["label"] = [dict(remaining[1], expand_dims=True)]
    return spec


def _raw_order(cfg, key: str, default: int) -> int:
    # order 2 has no device op and rounds up to cubic, as in the JAX package
    order = cfg.get(key, default)
    return 3 if order >= 2 else order


def _elastic_kwargs(cfg) -> dict:
    return {"alpha": cfg.get("alpha", 2000), "sigma": cfg.get("sigma", 50),
            "execution_probability": cfg.get("execution_probability", 0.1), "apply_3d": cfg.get("apply_3d", True)}


class DeviceAugmenter:
    """Applies a `split_device_transforms` spec to an NCDHW (raw, label)
    batch on its device (JAX augment.py:559).

    `draw(raw_shape, generators)` makes every random value of a batch, one set
    per sample as the JAX package splits one key per sample; `apply(raw,
    label, draws)` is deterministic in them and makes no host sync;
    `__call__(raw, label, generators)` does both. `generators` is a pair
    (host CPU `torch.Generator`, generator on the batch's device). The label
    carries a channel axis (the trainer adds one to a class map). On a batch
    whose H != W, RandomRotate90 is skipped, with a warning."""

    def __init__(self, spec: dict):
        self.spec = spec
        self._warned = False
        self._has_rot90 = any(e["raw"]["name"] == "RandomRotate90" for e in spec["paired"]) or any(
            c["name"] == "RandomRotate90" for c in spec["raw_only"])

    # ------------------------------------------------------------- draws

    @staticmethod
    def _draw_op(cfg, host, device_gen, shape) -> dict | None:
        """The draw of one transform for a (C, D, H, W) sample of `shape`."""
        name = cfg["name"]
        if name == "RandomFlip":
            return draw_flip(host)
        if name == "RandomRotate90":
            return draw_rotate90(host)
        if name == "RandomRotate":
            return draw_rotate(host, len(_rotate_axes(cfg)), cfg.get("angle_spectrum", 30))
        if name == "ElasticDeformation":
            kwargs = _elastic_kwargs(cfg)
            return draw_elastic(host, device_gen, shape[1:], kwargs["execution_probability"], kwargs["apply_3d"])
        if name == "AdditiveGaussianNoise":
            return draw_gaussian_noise(host, device_gen, shape, tuple(cfg.get("scale", (0.0, 1.0))),
                                       cfg.get("execution_probability", 0.1))
        if name == "AdditivePoissonNoise":
            return draw_poisson_noise(host, device_gen, shape, tuple(cfg.get("lam", (0.0, 1.0))),
                                      cfg.get("execution_probability", 0.1))
        if name == "GaussianBlur3D":
            return draw_blur(host, tuple(cfg.get("sigma", (0.1, 2.0))))
        if name == "RandomContrast":
            return draw_contrast(host, tuple(cfg.get("alpha", (0.5, 1.5))))
        return None

    def draw(self, raw_shape, generators) -> list[dict]:
        """Per-sample draws for a raw batch of `raw_shape` (N, C, D, H, W)."""
        host, device_gen = generators
        shape = tuple(raw_shape[1:])
        post = self.spec.get("label_post")
        draws = []
        for _ in range(raw_shape[0]):
            draws.append({
                "paired": [self._draw_op(e["raw"], host, device_gen, shape) for e in self.spec["paired"]],
                "raw_only": [self._draw_op(c, host, device_gen, shape) for c in self.spec["raw_only"]],
                "label_post": (draw_label_to_affinities(host, post.get("max_offset", 10))
                               if post is not None and post["name"] == "RandomLabelToAffinities" else None),
            })
        return draws

    # ------------------------------------------------------------- apply

    def _paired(self, entry, d, raw, label, square_hw: bool, label_is_int: bool):
        cfg = entry["raw"]
        name = cfg["name"]
        if name == "RandomFlip":
            prob = cfg.get("axis_prob", 0.5)
            return random_flip(raw, d["u"], prob), random_flip(label, d["u"], prob)
        if name == "RandomRotate90":
            if square_hw:
                return random_rotate90(raw, d["k"]), random_rotate90(label, d["k"])
            return raw, label
        if name == "RandomRotate":
            axes, spectrum = _rotate_axes(cfg), cfg.get("angle_spectrum", 30)
            raw = random_rotate(raw, d["plane"], d["angle"], axes, _raw_order(cfg, "order", 0))
            lab_f = random_rotate(label.float(), d["plane"], d["angle"], axes,
                                  _raw_order(entry["label"], "order", 0))
        elif name == "ElasticDeformation":
            kwargs = _elastic_kwargs(cfg)
            raw = elastic_deformation(raw, d["u"], d["fields"], _raw_order(cfg, "spline_order", 3), **kwargs)
            lab_f = elastic_deformation(label.float(), d["u"], d["fields"], 0, **kwargs)
        else:
            return raw, label
        return raw, (lab_f.to(label.dtype) if label_is_int else lab_f)

    @staticmethod
    def _raw_only(cfg, d, raw, square_hw: bool):
        name = cfg["name"]
        if name == "AdditiveGaussianNoise":
            return additive_gaussian_noise(raw, d["u"], d["std"], d["noise"], cfg.get("execution_probability", 0.1))
        if name == "AdditivePoissonNoise":
            return additive_poisson_noise(raw, d["u"], d["noise"], cfg.get("execution_probability", 0.1))
        if name == "GaussianBlur3D":
            return gaussian_blur(raw, d["u"], d["sigma"], cfg.get("execution_probability", 0.5))
        if name == "RandomContrast":
            return random_contrast(raw, d["u"], d["alpha"], cfg.get("mean", 0.0),
                                   cfg.get("execution_probability", 0.1))
        if name == "RandomFlip":
            return random_flip(raw, d["u"], cfg.get("axis_prob", 0.5))
        if name == "RandomRotate90":
            return random_rotate90(raw, d["k"]) if square_hw else raw
        if name == "RandomRotate":
            return random_rotate(raw, d["plane"], d["angle"], _rotate_axes(cfg), _raw_order(cfg, "order", 0))
        if name == "ElasticDeformation":
            return elastic_deformation(raw, d["u"], d["fields"], _raw_order(cfg, "spline_order", 3),
                                       **_elastic_kwargs(cfg))
        return raw

    @staticmethod
    def _label_post(post, d, label):
        lab3 = label[0].float()  # the single-channel raw label
        name = post["name"]
        ignore_index, append_label = post.get("ignore_index"), post.get("append_label", False)
        if name == "StandardLabelToBoundary":
            return standard_label_to_boundary(lab3, ignore_index=ignore_index, append_label=append_label,
                                              foreground=post.get("foreground", False))
        if name == "BlobsToMask":
            return blobs_to_mask(lab3, append_label=append_label)
        if name == "LabelToAffinities":
            return label_to_affinities(lab3, post["offsets"], z_offsets=post.get("z_offsets"),
                                       aggregate_affinities=post.get("aggregate_affinities", False),
                                       append_label=append_label, ignore_index=ignore_index)
        if name == "LabelToZAffinities":
            return label_to_z_affinities(lab3, post["offsets"], append_label=append_label, ignore_index=ignore_index)
        if name == "RandomLabelToAffinities":
            return random_label_to_affinities(lab3, d["offset"], d["axis"],
                                              z_offset_scale=post.get("z_offset_scale", 2),
                                              append_label=append_label, ignore_index=ignore_index)
        if name == "LabelToBoundaryAndAffinities":
            return label_to_boundary_and_affinities(lab3, post["xy_offsets"], post["z_offsets"],
                                                    append_label=append_label, ignore_index=ignore_index,
                                                    foreground=post.get("foreground", False))
        if name == "LabelToMaskAndAffinities":
            return label_to_mask_and_affinities(lab3, post["xy_offsets"], post["z_offsets"],
                                                append_label=append_label, background=post.get("background", 0),
                                                ignore_index=ignore_index)
        raise ValueError(f"no device op for label engineering '{name}'")  # _label_post_movable gates the names

    def apply(self, raw, label, draws):
        """(raw, label) NCDHW batches augmented with `draws` (from `draw`)."""
        square_hw = raw.shape[3] == raw.shape[4]
        if not square_hw and self._has_rot90 and not self._warned:
            logger.warning(f"RandomRotate90 needs square H/W patches on device (got {raw.shape[3]}x{raw.shape[4]}); "
                           "the transform is SKIPPED -- use square patches or device_augment: false to keep it")
            self._warned = True
        label_is_int = not label.is_floating_point()
        post = self.spec.get("label_post")
        raws, labels = [], []
        for r, lab, d in zip(raw, label, draws):
            for entry, dp in zip(self.spec["paired"], d["paired"]):
                r, lab = self._paired(entry, dp, r, lab, square_hw, label_is_int)
            for cfg, dr in zip(self.spec["raw_only"], d["raw_only"]):
                r = self._raw_only(cfg, dr, r, square_hw)
            if post is not None:
                lab = self._label_post(post, d["label_post"], lab)
            raws.append(r)
            labels.append(lab)
        return torch.stack(raws), torch.stack(labels)

    def __call__(self, raw, label, generators):
        return self.apply(raw, label, self.draw(raw.shape, generators))


def execution_probability_one(spec: dict) -> dict:
    """A copy of `spec` with every transform's execution probability at 1
    (flips keep their axis_prob): every transform runs, for checks and times."""
    spec = {"paired": [{"raw": dict(e["raw"]), "label": dict(e["label"])} for e in spec["paired"]],
            "raw_only": [dict(c) for c in spec["raw_only"]], "label_post": spec.get("label_post")}
    for cfg in [e["raw"] for e in spec["paired"]] + spec["raw_only"]:
        if cfg["name"] in ("ElasticDeformation", "AdditiveGaussianNoise", "AdditivePoissonNoise", "GaussianBlur3D",
                           "RandomContrast"):
            cfg["execution_probability"] = 1.0
    return spec
