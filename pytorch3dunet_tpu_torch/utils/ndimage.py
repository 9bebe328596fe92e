"""Host-side image/label ops (connected components, boundaries, rand error...).

The port's own copy of pytorch3dunet_tpu/utils/ndimage.py.

scikit-image is not a dependency of this framework; these are independent
numpy/scipy implementations of the handful of behaviors the reference relies
on (pytorch3dunet: unet3d/metrics.py:6, unet3d/seg_metrics.py:2,
augment/transforms.py:8-10, unet3d/utils.py:10). They run at validation /
prediction cadence on the host, exactly as in the reference.
"""

import numpy as np
import scipy.ndimage as ndi
import scipy.sparse as sparse

__all__ = [
    "adapted_rand_error",
    "adjust_gamma",
    "contingency_table",
    "find_boundaries",
    "gaussian",
    "label",
    "label2rgb",
    "mean_squared_error",
    "peak_signal_noise_ratio",
    "rescale_intensity",
]


def label(label_image: np.ndarray, background=None, return_num: bool = False, connectivity: int | None = None):
    """Connected-component labeling of an integer image.

    Pixels sharing the same value and connected within `connectivity` get the
    same output label; different input values are never merged. `background`
    valued pixels (default 0) get label 0. Matches skimage.measure.label
    semantics used by the reference metrics (unet3d/metrics.py:231,268) and
    transforms (augment/transforms.py:855).
    """
    m = np.asarray(label_image)
    if connectivity is None:
        connectivity = m.ndim
    if background is None:
        background = 0

    # fast path: native union-find labeler (one pass over the volume)
    from pytorch3dunet_tpu_torch.utils.native import native_label

    native = native_label(m, background=background, connectivity=connectivity) if m.ndim in (2, 3) else None
    if native is not None:
        out, next_label = native
        if return_num:
            return out, next_label
        return out

    # fallback: per-value scipy labeling (never merges different input values)
    structure = ndi.generate_binary_structure(m.ndim, connectivity)
    out = np.zeros(m.shape, dtype=np.int64)
    next_label = 0
    for v in np.unique(m):
        if v == background:
            continue
        mask = m == v
        lbl, n = ndi.label(mask, structure=structure)
        if n:
            out[mask] = lbl[mask] + next_label
            next_label += n
    if return_num:
        return out, next_label
    return out


def relabel_consecutive(m: np.ndarray) -> np.ndarray:
    """Relabels an integer array to consecutive ids starting at 0 (value-ordered)."""
    _, inverse = np.unique(m, return_inverse=True)
    return inverse.reshape(m.shape)


def find_boundaries(label_img: np.ndarray, connectivity: int = 1, mode: str = "thick", background: int = 0):
    """Boundary mask between labeled regions.

    Modes follow skimage.segmentation.find_boundaries semantics ('thick',
    'inner', 'outer'), implemented with grayscale dilation/erosion
    (maximum/minimum filters).
    """
    m = np.asarray(label_img)
    footprint = ndi.generate_binary_structure(m.ndim, connectivity)
    dilated = ndi.maximum_filter(m, footprint=footprint, mode="nearest")
    eroded = ndi.minimum_filter(m, footprint=footprint, mode="nearest")
    boundaries = dilated != eroded
    if mode == "thick":
        return boundaries
    if mode == "inner":
        return boundaries & (m != background)
    if mode == "outer":
        # background pixels adjacent to a region, plus pixels where two
        # different foreground labels touch directly
        background_image = m == background
        full_footprint = ndi.generate_binary_structure(m.ndim, m.ndim)
        inverted_background = m.copy()
        # make background the "largest" label so erosion sees neighbors' values
        max_label = np.iinfo(m.dtype).max if np.issubdtype(m.dtype, np.integer) else np.inf
        inverted_background[background_image] = max_label
        adjacent_objects = (
            ndi.maximum_filter(m, footprint=full_footprint, mode="nearest")
            != ndi.minimum_filter(inverted_background, footprint=full_footprint, mode="nearest")
        ) & ~background_image
        return boundaries & (background_image | adjacent_objects)
    raise ValueError(f"Unsupported find_boundaries mode: {mode}")


def contingency_table(im_true: np.ndarray, im_test: np.ndarray, ignore_labels=None, normalize: bool = False):
    """Sparse joint label-count matrix of shape (max_true+1, max_test+1).

    Matches skimage.metrics.contingency_table as used by the instance
    segmentation metrics (unet3d/seg_metrics.py:66-86).
    """
    im_true_r = np.asarray(im_true).ravel()
    im_test_r = np.asarray(im_test).ravel()
    if ignore_labels:
        keep = ~np.isin(im_true_r, list(ignore_labels))
        im_true_r = im_true_r[keep]
        im_test_r = im_test_r[keep]
    data = np.ones(im_true_r.size, dtype=np.float64)
    if normalize:
        data /= max(im_true_r.size, 1)
    shape = (int(im_true_r.max(initial=0)) + 1, int(im_test_r.max(initial=0)) + 1)
    return sparse.coo_matrix((data, (im_true_r, im_test_r)), shape=shape).tocsr()


def adapted_rand_error(image_true: np.ndarray, image_test: np.ndarray, ignore_labels=(0,), alpha: float = 0.5):
    """Adapted Rand error (SNEMI3D definition), as skimage.metrics.adapted_rand_error.

    Returns (are, precision, recall). Reference usage: unet3d/metrics.py:158.
    """
    p_ij = contingency_table(image_true, image_test, ignore_labels=ignore_labels, normalize=False)
    data = p_ij.data
    # x^2 - x converts counts to (ordered) pair counts
    sum_p_ij2 = float(data @ data - data.sum())
    a_i = np.asarray(p_ij.sum(axis=1)).ravel()
    b_i = np.asarray(p_ij.sum(axis=0)).ravel()
    sum_a2 = float(a_i @ a_i - a_i.sum())
    sum_b2 = float(b_i @ b_i - b_i.sum())
    precision = sum_p_ij2 / sum_b2 if sum_b2 else 0.0
    recall = sum_p_ij2 / sum_a2 if sum_a2 else 0.0
    denom = alpha * sum_a2 + (1.0 - alpha) * sum_b2
    fscore = sum_p_ij2 / denom if denom else 0.0
    return 1.0 - fscore, precision, recall


def mean_squared_error(image0: np.ndarray, image1: np.ndarray) -> float:
    image0 = np.asarray(image0, dtype=np.float64)
    image1 = np.asarray(image1, dtype=np.float64)
    return float(np.mean((image0 - image1) ** 2))


def peak_signal_noise_ratio(image_true: np.ndarray, image_test: np.ndarray, data_range=None) -> float:
    image_true = np.asarray(image_true)
    image_test = np.asarray(image_test)
    if data_range is None:
        if np.issubdtype(image_true.dtype, np.integer):
            info = np.iinfo(image_true.dtype)
            data_range = info.max - info.min
        else:
            # float images are assumed in [0, 1] (or [-1, 1] if negatives present)
            data_range = 1.0 if image_true.min() >= 0 else 2.0
    err = mean_squared_error(image_true, image_test)
    if err == 0:
        return float("inf")  # skimage semantics: identical images -> inf dB
    return float(10.0 * np.log10((data_range**2) / err))


# default color cycle used when painting label images for TensorBoard
_LABEL_COLORS = np.array(
    [
        (1.0, 0.0, 0.0),  # red
        (0.0, 0.0, 1.0),  # blue
        (1.0, 1.0, 0.0),  # yellow
        (1.0, 0.0, 1.0),  # magenta
        (0.0, 0.5, 0.0),  # green
        (0.29, 0.0, 0.51),  # indigo
        (1.0, 0.55, 0.0),  # darkorange
        (0.0, 1.0, 1.0),  # cyan
        (1.0, 0.75, 0.8),  # pink
        (0.6, 0.8, 0.2),  # yellowgreen
    ]
)


def label2rgb(label_img: np.ndarray, bg_label: int = 0) -> np.ndarray:
    """Paints an integer label image to float RGB (reference use: unet3d/utils.py:196,216)."""
    m = np.asarray(label_img)
    out = np.zeros(m.shape + (3,), dtype=np.float64)
    labels = [v for v in np.unique(m) if v != bg_label]
    for i, v in enumerate(labels):
        out[m == v] = _LABEL_COLORS[i % len(_LABEL_COLORS)]
    return out


def rescale_intensity(image: np.ndarray, out_range=(0.0, 1.0)) -> np.ndarray:
    """Min-max rescale to `out_range` (augment/transforms.py:199 parity)."""
    image = np.asarray(image, dtype=np.float64)
    imin, imax = image.min(), image.max()
    omin, omax = out_range
    if imax == imin:
        return np.full_like(image, omin)
    scaled = (image - imin) / (imax - imin)
    return scaled * (omax - omin) + omin


def adjust_gamma(image: np.ndarray, gamma: float = 1.0, gain: float = 1.0) -> np.ndarray:
    """Gamma correction for non-negative images (augment/transforms.py:201 parity)."""
    image = np.asarray(image)
    if np.any(image < 0):
        raise ValueError("Image must contain non-negative values for gamma adjustment")
    return ((image / 1.0) ** gamma) * gain


def gaussian(image: np.ndarray, sigma: float = 1.0) -> np.ndarray:
    """Gaussian blur with skimage.filters.gaussian defaults (nearest mode, truncate=4)."""
    image = np.asarray(image, dtype=np.float64)
    return ndi.gaussian_filter(image, sigma=sigma, mode="nearest", truncate=4.0)
