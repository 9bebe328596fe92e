"""The DSB2018 path of the port against the JAX package on the CPU: PNG
folders read by `DSB2018Dataset` (grayscale and RGB, paired by name or by
order), the predict CLI on `DSB2018Predictor` against `predict3dunet` with and
without `pad_to_multiple`, and the 2DUnet_dsb2018 train config shrunk through
the train CLI.
"""

import os
import sys

import h5py
import imageio.v2 as imageio
import numpy as np
import pytest
import torch
import yaml

from pytorch3dunet_tpu import predict as jax_predict
from pytorch3dunet_tpu.datasets.dsb import DSB2018Dataset as JaxDSB2018Dataset
from pytorch3dunet_tpu.utils.torch_interop import save_torch_checkpoint
from pytorch3dunet_tpu_torch import predict as port_predict
from pytorch3dunet_tpu_torch import train as port_train
from pytorch3dunet_tpu_torch.datasets.dsb import DSB2018Dataset, dsb_prediction_collate
from pytorch3dunet_tpu_torch.datasets.utils import get_test_loaders, get_train_loaders
from pytorch3dunet_tpu_torch.models.unet import get_model
from pytorch3dunet_tpu_torch.predictor import DSB2018Predictor, pmaps_to_segmentation
from pytorch3dunet_tpu_torch.utils.checkpoint import load_checkpoint
from tests.test_torch_port_2d import TOL, _jax, _port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DSB = os.path.join(REPO, "resources", "2DUnet_dsb2018")
# the DSB2018 test images' sizes, shrunk; none a multiple of 64 but the first
SIZES = [(64, 64), (64, 80), (70, 90)]


def _blobs(rs, shape, n=6):
    """An instance mask of `n` discs of ids 1..n."""
    yy, xx = np.mgrid[: shape[0], : shape[1]]
    mask = np.zeros(shape, np.uint8)
    for i in range(1, n + 1):
        cy, cx, r = rs.randint(0, shape[0]), rs.randint(0, shape[1]), rs.randint(4, 10)
        mask[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = i
    return mask


def _folder(root, sizes=SIZES, rgb=False, masks=True, mask_names=None, seed=0):
    """<root>/images/img{i}.png (+ <root>/masks/...): uint8 images with blobs
    brighter than the noise around them."""
    rs = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "images"))
    if masks:
        os.makedirs(os.path.join(root, "masks"))
    for i, shape in enumerate(sizes):
        mask = _blobs(rs, shape)
        img = ((mask > 0) * 120 + rs.rand(*shape) * 100).astype(np.uint8)
        if rgb:
            img = np.stack([img, img // 2, 255 - img], axis=-1)
        imageio.imwrite(os.path.join(root, "images", f"img{i}.png"), img)
        if masks:
            name = mask_names[i] if mask_names else f"img{i}.png"
            imageio.imwrite(os.path.join(root, "masks", name), mask)
    return root


def _config(name):
    with open(os.path.join(DSB, name)) as f:
        config = yaml.safe_load(f)
    config["device"] = "cpu"
    config["model"].update(f_maps=[8, 16])
    config["loaders"].update(num_workers=1)
    return config


# --- the dataset ----------------------------------------------------------------------------------------------


@pytest.mark.parametrize("rgb,mask_names", [(False, None), (True, None), (False, ["a.png", "b.png", "c.png"])])
def test_dataset_yields_the_jax_samples(tmp_path, rgb, mask_names):
    """The val pipeline of the DSB train config (centered 64 x 64 crop,
    Standardize; Relabel, BlobsToMask), and the test phase's (image, path)."""
    root = _folder(str(tmp_path / "data"), rgb=rgb, mask_names=mask_names)
    val = _config("train_config.yml")["loaders"]["val"]["transformer"]
    for step in val["raw"] + val["label"]:
        if step["name"] == "CropToFixed":
            step["size"] = [64, 64]
    for phase, transformer in (("val", val), ("test", {"raw": val["raw"]})):
        got, want = DSB2018Dataset(root, phase, transformer), JaxDSB2018Dataset(root, phase, transformer)
        assert len(got) == len(want) == 3 and got.paths == want.paths
        for i in range(3):
            for a, b in zip(got[i], want[i]):
                if isinstance(b, str):
                    assert a == b
                else:
                    assert a.dtype == b.dtype and a.shape == b.shape
                    np.testing.assert_array_equal(a, b)
        if phase == "val":
            raw, mask = got[0]
            assert raw.shape == ((3 if rgb else 1), 1, 64, 64) and mask.shape == (2, 1, 64, 64)
    batch = dsb_prediction_collate([got[0], got[1]])
    assert batch[0].shape[0] == 2 and batch[1] == got.paths[:2]


def test_dataset_refuses_unpaired_masks(tmp_path):
    root = _folder(str(tmp_path / "data"), sizes=SIZES[:2], mask_names=["a.png", "b.png"])
    os.remove(os.path.join(root, "masks", "b.png"))
    with pytest.raises(FileNotFoundError, match="cannot pair"):
        DSB2018Dataset(root, "train", {"raw": [{"name": "ToTensor", "expand_dims": True}], "label": []})


# --- prediction -----------------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dsb(tmp_path_factory):
    """A test folder, and a torch-format checkpoint of the shrunk DSB model
    (BatchNorm statistics randomized) written by the JAX package."""
    tmp = str(tmp_path_factory.mktemp("dsb"))
    _folder(os.path.join(tmp, "test"), masks=False)
    _, variables = _jax(_config("test_config.yml")["model"], seed=2)
    save_torch_checkpoint(variables, os.path.join(tmp, "weights.pytorch"))
    return tmp, variables


def _outputs(out_dir):
    out = {}
    for i in range(len(SIZES)):
        with h5py.File(os.path.join(out_dir, f"img{i}_predictions.h5"), "r") as f:
            out[i] = (f["predictions"][:], f["segmentation"][:])
    return out


@pytest.mark.parametrize("pad_to_multiple", [64, None])
def test_predict_cli_matches_predict3dunet(dsb, tmp_path, pad_to_multiple):
    """Each image's probabilities within 2e-4 of predict3dunet's, its
    segmentation equal wherever the probability is more than 1e-3 from the
    threshold (where a rounding could flip a pixel). The random weights give
    probabilities within a few hundredths of their median: the threshold is
    the first image's median, so that the segmentation has components."""
    tmp, variables = dsb
    config = _config("test_config.yml")
    first = DSB2018Dataset(os.path.join(tmp, "test"), "test", config["loaders"]["test"]["transformer"])[0][0]
    model = _port(config["model"], variables).eval()
    threshold = float(np.median(DSB2018Predictor(model, None, 1, "cpu").predict_image(first[None])))
    outputs = {}
    for side in ("jax", "port"):
        config = _config("test_config.yml")
        config["model_path"] = os.path.join(tmp, "weights.pytorch")
        config["predictor"].update(pad_to_multiple=pad_to_multiple, pmaps_thershold=threshold)
        config["loaders"]["output_dir"] = str(tmp_path / side)
        config["loaders"]["test"]["file_paths"] = [os.path.join(tmp, "test")]
        if side == "jax":
            path = str(tmp_path / "jax.yml")
            with open(path, "w") as f:
                yaml.safe_dump(config, f)
            argv, sys.argv = sys.argv, ["predict3dunet", "--config", path]
            try:
                jax_predict.main()
            finally:
                sys.argv = argv
        else:
            port_predict.run(config)
        outputs[side] = _outputs(str(tmp_path / side))
    for i, shape in enumerate(SIZES):
        (probs, seg), (want_probs, want_seg) = outputs["port"][i], outputs["jax"][i]
        assert probs.shape == seg.shape == shape and seg.dtype == np.uint16
        np.testing.assert_allclose(probs, want_probs, rtol=0, atol=TOL)
        away = np.abs(want_probs - threshold) > 1e-3
        np.testing.assert_array_equal(seg[away], want_seg[away], err_msg=f"image {i}")
        assert np.array_equal(seg, pmaps_to_segmentation(probs, threshold))
        assert seg.max() > 1 and away.mean() > 0.5


def test_padded_forward_equals_the_unpadded_one_on_a_multiple(dsb):
    """A 64 x 64 image needs no padding: `pad_to_multiple` leaves its forward
    as it is; a 70 x 90 one is padded to 128 x 128 and cropped back."""
    tmp, variables = dsb
    model = _port(_config("test_config.yml")["model"], variables).eval()
    img = np.random.RandomState(1).randn(1, 1, 1, 64, 64).astype(np.float32)
    plain = DSB2018Predictor(model, None, 1, "cpu")
    padded = DSB2018Predictor(model, None, 1, "cpu", pad_to_multiple=64)
    np.testing.assert_array_equal(padded.predict_image(img), plain.predict_image(img))
    odd = np.random.RandomState(2).randn(1, 1, 70, 90).astype(np.float32)
    assert padded.predict_image(odd).shape == plain.predict_image(odd).shape == (1, 1, 70, 90)


# --- training -------------------------------------------------------------------------------------------------


def test_train_config_trains_through_the_cli(tmp_path):
    """The 2DUnet_dsb2018 train config (its random host transforms, crops of
    64 x 64, BlobsAveragePrecision) with f_maps [8, 16]: 2 iterations and a
    validation; the loss is finite and the BatchNorm statistics move."""
    train_dir, val_dir = _folder(str(tmp_path / "train"), seed=1), _folder(str(tmp_path / "val"), seed=2)
    config = _config("train_config.yml")
    config["manual_seed"] = 0
    config["loaders"].update(batch_size=2)
    for phase, root in (("train", train_dir), ("val", val_dir)):
        config["loaders"][phase]["file_paths"] = [root]
        for step in config["loaders"][phase]["transformer"]["raw"] + config["loaders"][phase]["transformer"]["label"]:
            if step["name"] == "CropToFixed":
                step["size"] = [64, 64]
    config["trainer"].update(checkpoint_dir=str(tmp_path / "ckpt"), validate_after_iters=2, log_after_iters=2,
                             max_num_iterations=2)
    raw, target = next(iter(get_train_loaders(config, seed=0)["train"]))
    assert raw.shape == (2, 1, 1, 64, 64) and target.shape == (2, 2, 1, 64, 64)
    path = str(tmp_path / "train.yml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    port_train.main(["--config", path])
    state = load_checkpoint(tmp_path / "ckpt" / "last_checkpoint.pytorch")
    assert state["num_iterations"] == 3 and np.isfinite(state["best_eval_score"])
    start = get_model(config["model"]).state_dict()
    moved = [k for k in state["model_state_dict"] if k.endswith("running_var")
             and not torch.equal(state["model_state_dict"][k], start[k])]
    assert len(moved) == 6


def test_test_loader_collates_images_and_paths(dsb):
    tmp, _ = dsb
    config = _config("test_config.yml")
    config["loaders"]["test"]["file_paths"] = [os.path.join(tmp, "test")]
    (loader,) = list(get_test_loaders(config))
    images, paths = next(iter(loader))
    assert images.shape == (1, 1, 1, 64, 64) and paths == [os.path.join(tmp, "test", "images", "img0.png")]
