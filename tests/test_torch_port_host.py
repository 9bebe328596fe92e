"""The port's own host tier against the JAX package's, on the CPU: slice
builders, padding and stats, the transforms of the confocal and lightsheet
recipes, the numpy metrics, the HDF5 datasets and loaders, the native labeler,
the weights export; the guard that the port imports nothing of the JAX package;
and the device rules (no CPU fallback, float32 on CUDA).

Each copy is held to the original's result on the same seeded input, exactly.
"""

import ast
import copy
import os
import pickle
import random
import re
import subprocess
import sys
import weakref
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch
import yaml

import pytorch3dunet_tpu.augment.transforms as jax_transforms
import pytorch3dunet_tpu.datasets.hdf5 as jax_hdf5
import pytorch3dunet_tpu.datasets.utils as jax_dutils
import pytorch3dunet_tpu.metrics as jax_metrics
import pytorch3dunet_tpu.utils.ndimage as jax_ndimage
import pytorch3dunet_tpu.utils.torch_interop as jax_interop
import pytorch3dunet_tpu_torch.augment.transforms as port_transforms
import pytorch3dunet_tpu_torch.datasets.hdf5 as port_hdf5
import pytorch3dunet_tpu_torch.datasets.utils as port_dutils
import pytorch3dunet_tpu_torch.metrics as port_metrics
import pytorch3dunet_tpu_torch.utils.ndimage as port_ndimage
from pytorch3dunet_tpu_torch import config as port_config
from pytorch3dunet_tpu_torch.inference_device import detect_device_path
from pytorch3dunet_tpu_torch.models.unet import get_model
from pytorch3dunet_tpu_torch.utils import interop as port_interop
from pytorch3dunet_tpu_torch.utils import native as port_native
from pytorch3dunet_tpu_torch.utils.misc import RunningAverage, get_class, number_of_features_per_level

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "pytorch3dunet_tpu_torch"
LIGHTSHEET = REPO / "resources" / "3DUnet_lightsheet_boundary" / "train_config.yml"
CONFOCAL = REPO / "resources" / "3DUnet_confocal_boundary" / "train_config.yml"


def _assert_same(a, b):
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)


def _label(rs, shape, cell=(2, 8, 8), ids=12):
    cells = rs.randint(0, ids, tuple(s // c for s, c in zip(shape, cell)))
    return np.kron(cells, np.ones(cell, dtype=cells.dtype))


# --- slice builders, padding, stats ---------------------------------------------------------------------------


@pytest.mark.parametrize("raw_shape,patch,stride", [
    ((16, 64, 64), (8, 64, 64), (8, 64, 64)),
    ((19, 70, 67), (8, 64, 64), (5, 3, 64)),
    ((2, 12, 66, 80), (6, 64, 64), (4, 64, 9)),
])
def test_slice_builder_matches_jax(raw_shape, patch, stride):
    raw = np.zeros(raw_shape, np.float32)
    label = np.zeros(raw_shape[-3:], np.int64)
    got = port_dutils.SliceBuilder(raw, label, patch, stride)
    want = jax_dutils.SliceBuilder(raw, label, patch, stride)
    assert got.raw_slices == want.raw_slices and got.label_slices == want.label_slices
    assert port_dutils.SliceBuilder._build_slices(raw, patch, stride) == want.raw_slices


@pytest.mark.parametrize("threshold,slack,ignore_index", [(0.6, 0.01, None), (0.3, 0.2, 3), (0.9, 0.5, None)])
def test_filter_slice_builder_matches_jax(threshold, slack, ignore_index):
    # labels 1-4 in the left half, background in the right: patches at
    # x = 0, 32, 64 hold 100%, 50% and 0% of foreground
    rs = np.random.RandomState(1)
    label = _label(rs, (24, 64, 128), cell=(4, 16, 16), ids=4) + 1
    label[..., 64:] = 0
    raw = rs.rand(*label.shape)
    config = {"name": "FilterSliceBuilder", "patch_shape": (8, 64, 64), "stride_shape": (4, 32, 32),
              "threshold": threshold, "slack_acceptance": slack, "ignore_index": ignore_index}
    got = port_dutils.get_slice_builder(raw, label, config)
    want = jax_dutils.get_slice_builder(raw, label, config)
    assert type(got) is port_dutils.FilterSliceBuilder
    assert got.raw_slices == want.raw_slices and got.label_slices == want.label_slices
    assert 0 < len(got.raw_slices) < len(port_dutils.SliceBuilder._build_slices(raw, (8, 64, 64), (4, 32, 32)))


@pytest.mark.parametrize("halo", [(0, 0, 0), (2, 4, 4), (1, 0, 3)])
def test_mirror_pad_remove_padding_and_stats_match_jax(halo):
    rs = np.random.RandomState(2)
    volume = rs.rand(6, 10, 12).astype(np.float32)
    _assert_same(port_dutils.mirror_pad(volume, halo), jax_dutils.mirror_pad(volume, halo))
    four = rs.rand(2, 6, 10, 12)
    _assert_same(port_dutils.mirror_pad(four, halo), jax_dutils.mirror_pad(four, halo))
    padded = jax_dutils.mirror_pad(volume, halo)
    _assert_same(port_dutils.remove_padding(padded[None], halo), jax_dutils.remove_padding(padded[None], halo))
    assert port_dutils.calculate_stats(volume) == jax_dutils.calculate_stats(volume)
    assert port_dutils.calculate_stats(volume, skip=True) == jax_dutils.calculate_stats(volume, skip=True)


def _raw_transform_stats(stats, want):
    config = {"raw": [{"name": "Standardize"}, {"name": "PercentileNormalizer"}]}
    standardize, percentile = port_transforms.Transformer(config, stats).raw_transform().transforms
    return {"pmin": percentile.pmin, "pmax": percentile.pmax, "mean": standardize.mean, "std": standardize.std}


def _standardize_transform_stats(stats, want):
    config = {"raw": [{"name": "Standardize"}, {"name": "ToTensor", "expand_dims": True}], "label": None}
    standardize, _ = port_transforms.Transformer(config, stats).raw_transform().transforms
    return {"mean": standardize.mean, "std": standardize.std}


STATS_KEYS, PERCENTILES, MOMENTS = ("pmin", "pmax", "mean", "std"), ("pmin", "pmax"), ("mean", "std")
# each way of reading `calculate_stats`, and the keys of what it gives
STATS_READS = {
    "item": (lambda stats, want: {key: stats[key] for key in want}, STATS_KEYS),
    "get": (lambda stats, want: {key: stats.get(key) for key in want}, STATS_KEYS),
    "unpack": (lambda stats, want: {**stats}, STATS_KEYS),
    "dict": (lambda stats, want: dict(stats), STATS_KEYS),
    "keys": (lambda stats, want: {key: stats[key] for key in stats.keys()}, STATS_KEYS),
    "items": (lambda stats, want: dict(stats.items()), STATS_KEYS),
    "eq_jax": (lambda stats, want: want if stats == want and want == stats else {}, STATS_KEYS),
    "copy": (lambda stats, want: copy.copy(stats), STATS_KEYS),
    "deepcopy": (lambda stats, want: copy.deepcopy(stats), STATS_KEYS),
    "pickle": (lambda stats, want: pickle.loads(pickle.dumps(stats)), STATS_KEYS),
    "percentile_normalizer": (lambda stats, want: detect_device_path([{"name": "PercentileNormalizer"}], stats)[1],
                              PERCENTILES),
    "transformer": (_raw_transform_stats, STATS_KEYS),
    "transformer_standardize": (_standardize_transform_stats, MOMENTS),
    "standardize": (lambda stats, want: detect_device_path([{"name": "Standardize"}, {"name": "ToTensor"}], stats)[1],
                    MOMENTS),
    "membership": (lambda stats, want: {key: stats[key] for key in MOMENTS if key in stats and "pmin" in stats},
                   MOMENTS),
}


@pytest.mark.parametrize("form", list(STATS_READS))
def test_calculate_stats_reads_the_eager_values_and_defers_the_percentiles(form, monkeypatch):
    """Every read form gives the JAX package's eager values bit for bit; the two
    `np.percentile` calls run once, at the first read of `pmin` / `pmax`, and
    never for a reader of the mean and std alone; the volume is released once
    they ran, or once the statistics are dropped."""
    volume = np.random.RandomState(4).rand(6, 10, 12).astype(np.float32)
    want = jax_dutils.calculate_stats(volume)
    ranks, percentile = [], np.percentile
    monkeypatch.setattr(np, "percentile", lambda a, q, **kwargs: ranks.append(q) or percentile(a, q, **kwargs))
    stats = port_dutils.calculate_stats(volume)
    assert ranks == []
    read, keys = STATS_READS[form]
    got = read(stats, want)
    reads_percentiles = "pmin" in keys
    assert ranks == ([1, 99.6] if reads_percentiles else [])
    assert tuple(got) == keys
    for key, value in got.items():
        assert type(value) is type(want[key]) and value == want[key]
    released = weakref.ref(volume)
    del volume
    assert (released() is None) == reads_percentiles
    del stats
    assert released() is None


def test_random_scaler_matches_jax():
    rs = np.random.RandomState(3)
    raw, label = rs.rand(8, 32, 32).astype(np.float32), _label(rs, (8, 32, 32), cell=(2, 4, 4))
    scalers = [m.RandomScaler(4, (8, 32, 32), (16, 64, 64), execution_probability=0.3, seed=5)
               for m in (port_dutils, jax_dutils)]
    idx = (slice(2, 10), slice(8, 40), slice(16, 48))
    for _ in range(6):
        got, want = (s.randomize_indices(idx, idx) for s in scalers)
        assert got == want
        sub = tuple(slice(0, sl.stop - sl.start) for sl in got[0])
        _assert_same(scalers[0].rescale_patches(raw[sub], label[sub]), scalers[1].rescale_patches(raw[sub], label[sub]))


def test_default_prediction_collate_matches_jax():
    batch = [(np.ones((1, 2, 3)), (slice(0, 2), slice(1, 3))), (np.zeros((1, 2, 3)), (slice(2, 4), slice(1, 3)))]
    _assert_same(port_dutils.default_prediction_collate(batch)[0], jax_dutils.default_prediction_collate(batch)[0])
    assert port_dutils.default_prediction_collate(batch)[1] == jax_dutils.default_prediction_collate(batch)[1]


# --- transforms -----------------------------------------------------------------------------------------------


def _recipe_transforms():
    """(phase, entry) of every transform the confocal and lightsheet train
    configs name, with the random ones forced to run."""
    entries = []
    for path in (CONFOCAL, LIGHTSHEET):
        loaders = yaml.safe_load(path.read_text())["loaders"]
        for phase in ("train", "val"):
            for kind, pipeline in loaders[phase]["transformer"].items():
                for entry in pipeline:
                    entry = dict(entry)
                    if "execution_probability" in entry or entry["name"] == "ElasticDeformation":
                        entry["execution_probability"] = 1.0
                    if (kind, entry) not in entries:
                        entries.append((kind, entry))
    return entries


RECIPE_TRANSFORMS = _recipe_transforms()


@pytest.mark.parametrize("kind,entry", RECIPE_TRANSFORMS,
                         ids=[f"{k}-{e['name']}-{i}" for i, (k, e) in enumerate(RECIPE_TRANSFORMS)])
def test_recipe_transform_matches_jax(kind, entry):
    rs = np.random.RandomState(4)
    shape = (6, 20, 20)
    patch = rs.rand(*shape).astype(np.float32) if kind == "raw" else _label(rs, shape, cell=(2, 4, 4), ids=7)
    if entry["name"] in ("RandomContrast", "RandomGammaCorrection"):
        patch = np.clip(patch, 0, 1)
    outputs = []
    for module in (port_transforms, jax_transforms):
        random.seed(11)  # GaussianBlur3D draws from the stdlib module
        kwargs = {**entry, "random_state": np.random.RandomState(8)}
        transform = getattr(module, entry["name"])(**kwargs)
        outputs.append([transform(patch.copy()) for _ in range(3)])
    _assert_same(outputs[0], outputs[1])


@pytest.mark.parametrize("path", [CONFOCAL, LIGHTSHEET], ids=["confocal", "lightsheet"])
def test_transformer_pipelines_match_jax(path, monkeypatch):
    loaders = yaml.safe_load(path.read_text())["loaders"]
    rs = np.random.RandomState(6)
    raw = rs.rand(6, 20, 20).astype(np.float32)
    label = _label(rs, (6, 20, 20), cell=(2, 4, 4), ids=7)
    stats = jax_dutils.calculate_stats(raw)
    outputs = []
    for module in (port_transforms, jax_transforms):
        monkeypatch.setattr(module, "GLOBAL_RANDOM_STATE", np.random.RandomState(13))
        transformer = module.Transformer(loaders["train"]["transformer"], stats)
        random.seed(12)
        raw_t, label_t = transformer.raw_transform(), transformer.label_transform()
        assert all(type(t).__module__ == module.__name__ for t in raw_t.transforms + label_t.transforms)
        outputs.append([(raw_t(raw), label_t(label)) for _ in range(2)])
    _assert_same(outputs[0], outputs[1])


# --- metrics --------------------------------------------------------------------------------------------------


def _metric_inputs(seed):
    rs = np.random.RandomState(seed)
    label = _label(rs, (6, 16, 16), cell=(2, 4, 4), ids=6)
    boundary = jax_ndimage.find_boundaries(label, connectivity=2).astype(np.float32)
    probs = np.clip(boundary + 0.3 * rs.randn(*label.shape), 0, 1).astype(np.float32)
    return probs[None, None], np.stack([boundary, label])[None].astype(np.float32), label


@pytest.mark.parametrize("name,kwargs", [
    ("BoundaryAdaptedRandError", {"threshold": 0.4, "use_last_target": True, "use_first_input": True}),
    ("BoundaryAdaptedRandError", {"thresholds": [0.2, 0.5], "use_last_target": True, "ignore_index": 2}),
    ("AdaptedRandError", {"use_last_target": True}),
    ("DiceCoefficient", {}),
    ("MeanIoU", {}),
])
def test_metric_matches_jax(name, kwargs):
    probs, target, label = _metric_inputs(7)
    got_metric = port_metrics.get_evaluation_metric({"eval_metric": {"name": name, **kwargs}})
    want_metric = jax_metrics.get_evaluation_metric({"eval_metric": {"name": name, **kwargs}})
    assert type(got_metric).__module__ == port_metrics.__name__
    if name == "AdaptedRandError":
        pred = label[None, None] * (np.random.RandomState(8).rand(1, 1, *label.shape) > 0.1)
    elif name in ("DiceCoefficient", "MeanIoU"):
        pred, target = np.concatenate([probs, 1 - probs], 1), np.concatenate([target[:, :1], 1 - target[:, :1]], 1)
    else:
        pred = probs
    assert got_metric(pred, target) == want_metric(pred, target)


def test_mean_iou_with_class_targets_matches_jax():
    rs = np.random.RandomState(9)
    probs = rs.rand(2, 3, 4, 8, 8)
    classes = rs.randint(0, 3, (2, 4, 8, 8))
    for skip in (True, False):
        assert port_metrics.MeanIoU(skip)(probs, classes) == jax_metrics.MeanIoU(skip)(probs, classes)


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "scipy"])
def test_label_matches_jax(use_native, monkeypatch):
    if not use_native:
        monkeypatch.setattr(port_native, "_lib", None)
        monkeypatch.setattr(port_native, "_load_attempted", True)
    rs = np.random.RandomState(10)
    volume = _label(rs, (6, 12, 12), cell=(1, 2, 2), ids=4)
    for connectivity in (1, 3):
        got = port_ndimage.label(volume, connectivity=connectivity, return_num=True)
        want = jax_ndimage.label(volume, connectivity=connectivity, return_num=True)
        assert got[1] == want[1]
        # the two paths may number components in another order: compare the partitions
        pairs = set(zip(got[0].ravel().tolist(), want[0].ravel().tolist()))
        assert len(pairs) == len(np.unique(got[0])) == len(np.unique(want[0]))
    if use_native:
        assert port_native.get_native_lib() is not None
        assert Path(port_native.get_native_lib()._name).parent == port_native.BUILD_DIR


# --- HDF5 datasets and loaders --------------------------------------------------------------------------------


def _write_h5(path, seed, shape=(12, 64, 80)):
    rs = np.random.RandomState(seed)
    with h5py.File(path, "w") as f:
        f.create_dataset("raw", data=rs.rand(*shape).astype(np.float32))
        f.create_dataset("label", data=_label(rs, shape, cell=(2, 8, 8), ids=9))


def _loaders_config(tmp, dataset="StandardHDF5Dataset"):
    phase = {"slice_builder": {"name": "SliceBuilder", "patch_shape": [6, 64, 64], "stride_shape": [3, 64, 16],
                               "halo_shape": [2, 4, 4]},
             "transformer": {"raw": [{"name": "Standardize"}, {"name": "ToTensor", "expand_dims": True}],
                             "label": [{"name": "StandardLabelToBoundary", "append_label": True},
                                       {"name": "ToTensor", "expand_dims": False}]}}
    return {"dataset": dataset, "batch_size": 2, "num_workers": 1, "raw_internal_path": "raw",
            "label_internal_path": "label", "global_normalization": True,
            "train": {"file_paths": [str(tmp / "train.h5")], **phase},
            "val": {"file_paths": [str(tmp / "val.h5")], **phase},
            "test": {"file_paths": [str(tmp)], **phase}}


@pytest.mark.parametrize("dataset", ["StandardHDF5Dataset", "LazyHDF5Dataset"])
@pytest.mark.parametrize("phase", ["val", "test"])
def test_h5_datasets_match_jax(tmp_path, dataset, phase):
    _write_h5(tmp_path / "train.h5", 0)
    _write_h5(tmp_path / "val.h5", 1)
    config = _loaders_config(tmp_path, dataset)
    got = list(getattr(port_hdf5, dataset).create_datasets(config, phase=phase))
    want = list(getattr(jax_hdf5, dataset).create_datasets(config, phase=phase))
    assert [d.file_path for d in got] == [d.file_path for d in want] and got
    for g, w in zip(got, want):
        assert len(g) == len(w) > 1
        for i in range(len(g)):
            _assert_same(g[i], w[i])


@pytest.mark.parametrize("dataset", ["StandardHDF5Dataset", "LazyHDF5Dataset"])
@pytest.mark.parametrize("raw,ranks", [(["Standardize"], []), (["PercentileNormalizer"], [1, 99.6]), ([], [])],
                         ids=["standardize", "percentile", "none"])
def test_h5_test_dataset_computes_and_keeps_only_the_statistics_its_pipeline_takes(tmp_path, monkeypatch, dataset,
                                                                                   raw, ranks):
    """The predict CLIs' datasets with `global_normalization`: a Standardize
    pipeline runs no `np.percentile`, a PercentileNormalizer the two eager
    calls; no dataset keeps the volume its statistics were computed on; and
    the device sweep reads from its transformer the JAX package's values."""
    _write_h5(tmp_path / "test.h5", 2)
    with h5py.File(tmp_path / "test.h5") as f:
        want = jax_dutils.calculate_stats(f["raw"][:])
    called, percentile = [], np.percentile
    monkeypatch.setattr(np, "percentile", lambda a, q, **kwargs: called.append(q) or percentile(a, q, **kwargs))
    volumes, calculate_stats = [], port_hdf5.calculate_stats
    monkeypatch.setattr(port_hdf5, "calculate_stats",
                        lambda img, skip=False: volumes.append(weakref.ref(img)) or calculate_stats(img, skip))
    pipeline = [{"name": name} for name in raw] + [{"name": "ToTensor", "expand_dims": True}]
    slice_builder = {"name": "SliceBuilder", "patch_shape": [6, 64, 64], "stride_shape": [6, 64, 64]}
    data = getattr(port_hdf5, dataset)(str(tmp_path / "test.h5"), "test", slice_builder, {"raw": pipeline},
                                       global_normalization=True)
    assert called == ranks
    assert len(volumes) == 1 and volumes[0]() is None
    assert detect_device_path(pipeline, data.transformer.config_base) == detect_device_path(pipeline, want)
    assert called == ranks


def test_port_loaders_read_the_h5_files(tmp_path):
    _write_h5(tmp_path / "train.h5", 0)
    _write_h5(tmp_path / "val.h5", 1)
    config = {"loaders": _loaders_config(tmp_path)}
    loaders = port_dutils.get_train_loaders(config, seed=0)
    val = list(jax_hdf5.StandardHDF5Dataset.create_datasets(config["loaders"], phase="val"))[0]
    batches = list(loaders["val"])
    assert len(batches) == len(loaders["val"]) == -(-len(val) // 2)
    _assert_same(batches[0], [np.stack([val[0][k], val[1][k]]) for k in range(2)])
    assert sum(len(raw) for raw, _ in loaders["train"]) == len(loaders["train"].dataset)
    test_loaders = list(port_dutils.get_test_loaders(config))
    assert [type(loader.dataset) for loader in test_loaders] == [port_hdf5.StandardHDF5Dataset] * 2
    patches, indices = next(iter(test_loaders[0]))
    assert patches.shape == (2, 1, 10, 72, 72) and len(indices) == 2


# --- weights export, misc -------------------------------------------------------------------------------------


@pytest.mark.parametrize("name,order", [("ResidualUNetSE3D", "gcr"), ("UNet3D", "bcr"), ("UNet2D", "bcr"),
                                        ("ResidualUNet2D", "gcr")])
def test_weights_export_matches_jax(name, order):
    torch.manual_seed(0)
    model = get_model({"name": name, "in_channels": 1, "out_channels": 2, "f_maps": 8, "num_groups": 4,
                       "num_levels": 3, "layer_order": order})
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    params = jax_interop.torch_state_dict_to_params(state)
    got, want = port_interop.params_to_torch_state_dict(params), jax_interop.params_to_torch_state_dict(params)
    assert got.keys() == want.keys()
    for key in want:
        _assert_same(got[key], want[key])
    stats = jax_interop.torch_state_dict_to_batch_stats(state)
    assert port_interop.batch_stats_to_torch_entries(stats).keys() == jax_interop.batch_stats_to_torch_entries(
        stats).keys()


def test_misc_helpers():
    assert number_of_features_per_level(32, 5) == [32, 64, 128, 256, 512]
    avg = RunningAverage()
    avg.update(2.0, 3)
    avg.update(4.0)
    assert avg.avg == 2.5 and avg.count == 4
    assert get_class("SliceBuilder", ["pytorch3dunet_tpu_torch.datasets.utils"]) is port_dutils.SliceBuilder
    with pytest.raises(RuntimeError, match="Unsupported class"):
        get_class("Nope", ["pytorch3dunet_tpu_torch.datasets.utils"])


# --- the port imports nothing of the JAX package --------------------------------------------------------------


_JAX_MODULE = re.compile(r"pytorch3dunet_tpu(\.\w+)*")


def _jax_package_names(path: Path) -> list[str]:
    """Imports of `pytorch3dunet_tpu` or its modules in one source file, and
    string constants that name such a module (what importlib or get_class
    would look up)."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            names = [node.value]
        else:
            continue
        found += [f"{path.name}:{node.lineno}: {name}" for name in names if _JAX_MODULE.fullmatch(name)]
    return found


def test_port_sources_name_no_module_of_the_jax_package():
    sources = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(sources) > 20 and PORT / "ops" / "augment.py" in sources
    assert [hit for path in sources for hit in _jax_package_names(path)] == []


def test_refusals_name_live_roadmap_items():
    # every ROADMAP item a refusal names is the title of a live Queue 1 item,
    # and no port source names an item by its number
    from pytorch3dunet_tpu_torch.utils import misc

    roadmap = (REPO / "ROADMAP.md").read_text()
    queue1 = roadmap[roadmap.index("### Queue 1"):roadmap.index("### Queue 2")]
    titles = set(re.findall(r"^\d+\. \*\*(.+?)\*\*", queue1, flags=re.M))
    named = {value for key, value in vars(misc).items() if key.startswith("ITEM_")}
    # "Parallelism" was the last refusal: none is left
    assert len(named) == 0 and named <= titles, named - titles
    numbered = [f"{path.name}:{n}" for path in sorted(PORT.rglob("*.py"))
                for n, line in enumerate(path.read_text().splitlines(), 1) if re.search(r"\bitem \d", line)]
    assert numbered == []


def test_guard_finds_imports_and_module_strings(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import pytorch3dunet_tpu\nfrom pytorch3dunet_tpu.utils import misc\n"
                   "x = get_class('A', modules=['pytorch3dunet_tpu.datasets.hdf5'])\n"
                   "doc = 'see pytorch3dunet_tpu/ops/conv_pallas.py'\nimport pytorch3dunet_tpu_torch\n")
    assert len(_jax_package_names(bad)) == 3


def test_port_and_chip_smoke_imports_load_nothing_of_the_jax_package():
    smoke = ast.parse((REPO / "chip_smoke.py").read_text())
    smoke_imports = sorted({node.module for node in ast.walk(smoke)
                            if isinstance(node, ast.ImportFrom) and (node.module or "").startswith("pytorch3dunet")})
    assert {"pytorch3dunet_tpu_torch.ops.conv3d", "pytorch3dunet_tpu_torch.ops.augment"} <= set(smoke_imports)
    script = ("import importlib, pkgutil, sys\n"
              f"for name in {smoke_imports!r}:\n"
              "    importlib.import_module(name)\n"
              "import pytorch3dunet_tpu_torch as port\n"
              "for module in pkgutil.walk_packages(port.__path__, 'pytorch3dunet_tpu_torch.'):\n"
              "    importlib.import_module(module.name)\n"
              "print(sorted(m for m in sys.modules if m.split('.')[0] == 'pytorch3dunet_tpu'))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


# --- device: no CPU fallback, float32 on CUDA -----------------------------------------------------------------


@pytest.fixture
def tf32_on(monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)


@pytest.mark.parametrize("value", [None, "tpu", "mps", "cuda", "cuda:0"])
def test_device_resolves_to_cuda_in_float32(value, monkeypatch, tf32_on):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    device = port_config.resolve_device(value)
    assert device.type == "cuda"
    assert torch.backends.cudnn.allow_tf32 is False and torch.backends.cuda.matmul.allow_tf32 is False


@pytest.mark.parametrize("value", [None, "tpu", "mps"])
def test_device_without_a_card_raises_naming_device_cpu(value, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device: cpu"):
        port_config.resolve_device(value)


def test_explicit_cpu_leaves_tf32_alone(monkeypatch, tf32_on):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert port_config.resolve_device("cpu") == torch.device("cpu")
    assert port_config.resolve_device(torch.device("cpu")) == torch.device("cpu")
    assert torch.backends.cudnn.allow_tf32 is True


def test_trainer_without_a_device_does_not_pick_the_cpu(monkeypatch, tmp_path):
    from pytorch3dunet_tpu_torch.trainer import UNetTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = torch.nn.Linear(1, 1)
    with pytest.raises(RuntimeError, match="device: cpu"):
        UNetTrainer(model, torch.optim.SGD(model.parameters(), lr=1.0), None, None, None, {}, str(tmp_path), 1, 1)
