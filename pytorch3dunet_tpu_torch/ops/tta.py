"""Test-time augmentation: mirror-flip ensembling for prediction.

The port's copy of pytorch3dunet_tpu/ops/tta.py. Each forward is replaced by
the average of the model's probabilities over every combination of mirror flips
of the selected spatial axes (8 forwards for a 3D model). The ensemble wraps the
model forward, inside the device sweep as in the host loop, so it adds compute
and no transfers.

Flips commute with the halo crop (a flip of the haloed patch maps halo onto
halo), so the stitching is untouched.
"""

from itertools import chain, combinations

import torch


def flip_combos(axes) -> list[tuple[int, ...]]:
    """All subsets of `axes` (including the empty identity combo).

    `axes` are array axes of the model-ready batch; the result drives
    `tta_average` (len == 2**len(axes) forwards).
    """
    axes = tuple(dict.fromkeys(int(a) for a in axes))  # dedupe, keep order
    return [tuple(c) for c in chain.from_iterable(combinations(axes, r) for r in range(len(axes) + 1))]


def tta_average(apply_fn, x, combos):
    """Mean of `apply_fn` over mirror flips of `x`.

    apply_fn must map x -> output with the SAME spatial layout as x (true for
    the segmentation forward: (N, C, D, H, W) in, (N, Cout, D, H, W)
    probabilities out). Each output is flipped back (flips are involutions)
    before averaging. `combos` is a list of tuples of array axes, typically
    from `flip_combos`.
    """
    assert combos, "tta_average needs at least one flip combo (use [()] for identity)"
    acc = None
    for axes in combos:
        xf = torch.flip(x, axes) if axes else x
        p = apply_fn(xf)
        p = torch.flip(p, axes) if axes else p
        acc = p if acc is None else acc + p
    return acc / len(combos)


def resolve_tta_axes(tta, tta_axes, is_2d: bool) -> tuple[int, ...]:
    """Normalizes the (tta, tta_axes) config pair to patch-space flip axes.

    `tta_axes` uses the reference's spatial order (0=z, 1=y, 2=x); default is
    every flippable axis. 2D models sweep singleton-z patches, so z is never
    flippable and is dropped (with a ValueError only if the user asked for z
    explicitly AND nothing else remains).
    """
    if not tta:
        return ()
    if tta_axes is None:
        axes = (1, 2) if is_2d else (0, 1, 2)
    else:
        axes = tuple(int(a) for a in tta_axes)
    if any(a not in (0, 1, 2) for a in axes):
        raise ValueError(f"tta_axes must be within (0, 1, 2) [z, y, x]; got {tta_axes}")
    if is_2d:
        axes = tuple(a for a in axes if a != 0)
        if not axes:
            raise ValueError("tta_axes for a 2D model must include a spatial axis (1=y, 2=x)")
    return axes


def patch_axes_to_array_axes(axes, is_2d: bool = False) -> tuple[int, ...]:
    """Patch-space (z, y, x) axes -> axes of the port's model-ready batch:
    patch axis k is array axis k + 2 of an (N, C, D, H, W) batch, and k + 1 of
    a 2D model's (N, C, H, W) batch, whose z is gone (the JAX package's
    channels-last batches have them at k + 1 and k)."""
    return tuple(a + (1 if is_2d else 2) for a in axes)
