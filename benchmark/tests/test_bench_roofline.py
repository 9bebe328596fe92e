"""roofline.py's counts for the confocal UNet3D against a count written out
by hand from its layer shapes, at the sweep's halo'd patch and the train
patch, and the bounds it derives from them."""

import numpy as np
import pytest

from benchmark import roofline

CONFOCAL = {"name": "UNet3D", "in_channels": 1, "out_channels": 1, "layer_order": "gcr", "f_maps": 32,
            "num_groups": 8, "final_sigmoid": True}
# (cin, cout, level) of every 3x3x3 conv: the encoders' two per level (the
# first to max(out // 2, in)), the decoders' two at their skip's level (the
# first over the concat of the skip and the level below)
CONVS = [(1, 16, 0), (16, 32, 0), (32, 32, 1), (32, 64, 1), (64, 64, 2), (64, 128, 2), (128, 128, 3),
         (128, 256, 3), (128 + 256, 128, 2), (128, 128, 2), (64 + 128, 64, 1), (64, 64, 1), (32 + 64, 32, 0),
         (32, 32, 0)]


def by_hand(spatial, itemsize):
    sizes = [tuple(spatial)]
    for _ in range(3):
        sizes.append(tuple(s // 2 for s in sizes[-1]))
    vox = [int(np.prod(s)) for s in sizes]
    flops = sum(2 * 27 * cin * cout * vox[lvl] for cin, cout, lvl in CONVS) + 2 * 32 * 1 * vox[0]
    nbytes = sum(itemsize * (cin * vox[lvl] + cout * vox[lvl] + 27 * cin * cout) for cin, cout, lvl in CONVS)
    nbytes += itemsize * (32 * vox[0] + vox[0] + 32)
    return flops, nbytes


@pytest.mark.parametrize("spatial", [(112, 234, 234), (80, 170, 170)])
@pytest.mark.parametrize("dtype,itemsize", [(None, 4), ("bfloat16", 2)])
def test_confocal_counts(spatial, dtype, itemsize):
    flops, nbytes = by_hand(spatial, itemsize)
    work = roofline.conv_work(CONFOCAL, spatial, dtype)
    assert work["flops"] == flops
    assert work["bytes"] == nbytes
    train = roofline.conv_work(CONFOCAL, spatial, dtype, train=True, count=2)
    assert train["flops"] == 6 * flops and train["bytes"] == 6 * nbytes


def test_sweep_patch_total():
    # the 2.764 TFLOP of one 112x234x234 forward (PERF.md's kernel table counts the same convs)
    assert roofline.conv_work(CONFOCAL, (112, 234, 234))["flops"] == 2764179855360


def test_least_time_is_the_larger_bound():
    work = roofline.conv_work(CONFOCAL, (80, 170, 170), "bfloat16")
    assert work["least_s"] >= work["flops"] / 989e12
    assert work["least_s"] >= work["bytes"] / 3.35e12
    assert roofline.PEAK_FLOPS["float32"] == 165e12


def test_transposed_conv_counts_input_voxels():
    model = {"name": "ResidualUNet3D", "in_channels": 1, "out_channels": 1, "f_maps": 4, "num_levels": 2}
    layers = roofline.conv_layers(model, (8, 8, 8))
    deconv = [entry for entry in layers if entry[-1]]
    assert deconv == [("decoders.0.deconv", 3, 8, 4, (4, 4, 4), (7, 7, 7), True)]
