"""The port's HTTP server (pytorch3dunet_tpu_torch/serve.py) on the contracts of the
JAX package's tests/test_serve.py, on the CPU (`device: cpu`): served equals the
port's batch prediction exactly; the errors, the token, the size cap, bucketed
padding, streaming and the 2D micro-batching. Weights come from one JAX npz
checkpoint drawn from a numpy seed, so the JAX `ServingSession` serves the same
model: the two are held within the port's sweep tolerance, 2e-4
(tests/test_torch_port_device_predict.py). The other tolerances are the JAX
tests': 2e-5 where a statistic is computed in another order (global
normalization, the z-slab stream), 3e-5 for micro-batched against direct.
"""

import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import h5py
import jax
import numpy as np
import pytest

from pytorch3dunet_tpu.models import get_model as jax_get_model
from pytorch3dunet_tpu.serve import ServingSession as JaxServingSession
from pytorch3dunet_tpu.utils.checkpoint import state_to_bytes
from pytorch3dunet_tpu_torch.datasets.utils import get_test_loaders
from pytorch3dunet_tpu_torch.models.unet import get_model
from pytorch3dunet_tpu_torch.predict import get_predictor
from pytorch3dunet_tpu_torch.predictor import StandardPredictor
from pytorch3dunet_tpu_torch.serve import ServingSession, main, make_server
from pytorch3dunet_tpu_torch.utils.weights import load_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOL, STAT_TOL, BATCH_TOL = 2e-4, 2e-5, 3e-5
MODEL = {"name": "UNet3D", "in_channels": 1, "out_channels": 2, "layer_order": "gcr", "f_maps": 8, "num_groups": 4,
         "num_levels": 2, "final_sigmoid": False}
MODEL_2D = {"name": "UNet2D", "in_channels": 1, "out_channels": 1, "layer_order": "gcr", "f_maps": 8,
            "num_groups": 4, "num_levels": 2, "final_sigmoid": True}
SLICE_BUILDER = {"name": "SliceBuilder", "patch_shape": [8, 24, 24], "stride_shape": [8, 24, 24],
                 "halo_shape": [4, 8, 8], "skip_shape_check": True}
SLICE_BUILDER_2D = {"name": "SliceBuilder", "patch_shape": [1, 24, 24], "stride_shape": [1, 24, 24],
                    "halo_shape": [0, 4, 4], "skip_shape_check": True}
TRANSFORMER = {"raw": [{"name": "Standardize"}, {"name": "ToTensor", "expand_dims": True}]}


def _checkpoint(path, model_config, seed):
    """A JAX npz checkpoint of `model_config`, every leaf drawn from a numpy
    seed (GroupNorm scales near 1)."""
    variables = jax.jit(jax_get_model(dict(model_config)).init)(jax.random.PRNGKey(0))
    rs = np.random.RandomState(seed)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, v: (rs.rand(*v.shape) + 0.5 if p[-1].key == "scale" else rs.rand(*v.shape) * 0.4 - 0.2)
        .astype(np.float32), variables)
    path.write_bytes(state_to_bytes({"model_state_dict": variables, "num_epochs": 1, "num_iterations": 1,
                                     "best_eval_score": None}))
    return str(path)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_weights")
    return {"3d": _checkpoint(tmp / "m3d.ckpt", MODEL, 1), "2d": _checkpoint(tmp / "m2d.ckpt", MODEL_2D, 2)}


def _serve_config(model_path, two_d=False, global_norm=False):
    config = {
        "device": "cpu",
        "model_path": model_path,
        "model": dict(MODEL_2D if two_d else MODEL),
        "predictor": {"name": "DeviceSlidingWindowPredictor", "shard": False},
        "loaders": {"test": {"slice_builder": dict(SLICE_BUILDER_2D if two_d else SLICE_BUILDER),
                             "transformer": {"raw": [dict(t) for t in TRANSFORMER["raw"]]}}},
    }
    if global_norm:
        config["loaders"]["global_normalization"] = True
    return config


def _start_server(session):
    srv = make_server(session, host="127.0.0.1", port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return srv, thread, f"http://127.0.0.1:{srv.server_address[1]}"


def _stop(srv, thread):
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


@pytest.fixture(scope="module")
def server(weights):
    session = ServingSession(_serve_config(weights["3d"]))
    srv, thread, base = _start_server(session)
    yield base, session
    _stop(srv, thread)


def _npy(volume) -> bytes:
    buf = io.BytesIO()
    np.save(buf, volume)
    return buf.getvalue()


def _post_volume(base, vol, query="", headers=None):
    req = urllib.request.Request(f"{base}/predict{query}", data=_npy(vol), method="POST",
                                 headers={"Content-Type": "application/octet-stream", **(headers or {})})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return np.load(io.BytesIO(resp.read()), allow_pickle=False)


def _batch_prediction(tmp_path, config, vol):
    """The port's batch path: DeviceSlidingWindowPredictor over an H5 file."""
    path = os.path.join(str(tmp_path), "vol.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("raw", data=vol)
    config["loaders"].update({"output_dir": str(tmp_path), "batch_size": 1, "raw_internal_path": "raw",
                              "num_workers": 1})
    config["loaders"]["test"]["file_paths"] = [path]
    model = get_model(dict(config["model"]))
    load_weights(model, config["model_path"])
    predictor = get_predictor(model.eval(), config)
    for loader in get_test_loaders(config):
        predictor(loader)
        predictor.finalize()
    with h5py.File(os.path.join(str(tmp_path), "vol_predictions.h5"), "r") as f:
        return f["predictions"][:]


def test_serve_matches_batch_predict_exactly(tmp_path, server, weights):
    base, _ = server
    vol = np.random.RandomState(3).rand(16, 48, 48).astype(np.float32)
    batch_pred = _batch_prediction(tmp_path, _serve_config(weights["3d"]), vol)
    served = _post_volume(base, vol)
    assert served.shape == batch_pred.shape == (2, 16, 48, 48)
    np.testing.assert_array_equal(served, batch_pred)
    seg = _post_volume(base, vol, query="?output=segmentation")
    assert seg.dtype == np.uint16
    np.testing.assert_array_equal(seg, np.argmax(batch_pred, axis=0).astype(np.uint16))


def test_serve_matches_the_jax_server(server, weights):
    _, session = server
    vol = np.random.RandomState(4).rand(16, 48, 48).astype(np.float32) * 2 + 1
    want = JaxServingSession(_serve_config(weights["3d"])).predict(vol)
    np.testing.assert_allclose(session.predict(vol), want, atol=JAX_TOL)


def test_serve_healthz_info_and_errors(server):
    base, _ = server
    with urllib.request.urlopen(f"{base}/healthz", timeout=30) as resp:
        assert json.loads(resp.read()) == {"status": "ok"}
    with urllib.request.urlopen(f"{base}/info", timeout=30) as resp:
        info = json.loads(resp.read())
    assert info["patch_shape"] == SLICE_BUILDER["patch_shape"]
    assert info["normalize"] == "standardize_patch"
    assert info["predictor"]["patch_mode"] == "grid"
    assert info["devices"] == ["cpu"] and info["auth"] is False and info["batching"] is None

    for body in (b"not numpy", _npy(np.zeros((4, 4), np.float32))):  # malformed, wrong rank
        req = urllib.request.Request(f"{base}/predict", data=body, method="POST")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=30)
        assert err.value.code == 400
        assert "error" in json.loads(err.value.read())
    req = urllib.request.Request(f"{base}/predict?output=labels", data=_npy(np.zeros((8, 24, 24), np.float32)),
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(req, timeout=30)
    assert err.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(f"{base}/nope", timeout=30)
    assert err.value.code == 404


def test_serve_pad_to_multiple(weights):
    session = ServingSession(_serve_config(weights["3d"]), pad_to_multiple=(8, 24, 24))
    vol = np.random.RandomState(5).rand(11, 30, 40).astype(np.float32)
    pred = session.predict(vol)
    assert pred.shape == (2, 11, 30, 40)
    assert np.isfinite(pred).all()
    # the prediction of the reflect-padded volume, cropped
    padded = np.pad(vol, [(0, 5), (0, 18), (0, 8)], mode="reflect")
    np.testing.assert_array_equal(pred, session.predict(padded)[:, :11, :30, :40])


def test_serve_rejects_host_only_transformer(weights):
    config = _serve_config(weights["3d"])
    config["loaders"]["test"]["transformer"]["raw"] = [
        {"name": "Standardize", "channelwise": True}, {"name": "ToTensor", "expand_dims": True}]
    with pytest.raises(ValueError, match="not supported by the device sweep"):
        ServingSession(config)


def test_serving_never_takes_the_host_loop(server, monkeypatch):
    def host_loop(*args, **kwargs):
        raise AssertionError("the host loop ran")

    monkeypatch.setattr(StandardPredictor, "_forward", host_loop)
    _, session = server
    assert session.predict(np.random.RandomState(6).rand(8, 24, 24).astype(np.float32)).shape == (2, 8, 24, 24)


def test_serve_global_normalization_matches_batch(tmp_path, weights):
    vol = np.random.RandomState(7).rand(16, 48, 48).astype(np.float32) * 3 + 5
    batch_pred = _batch_prediction(tmp_path, _serve_config(weights["3d"], global_norm=True), vol)
    session = ServingSession(_serve_config(weights["3d"], global_norm=True))
    assert session.normalize == "standardize"
    np.testing.assert_allclose(session.predict(vol), batch_pred, atol=STAT_TOL)


def test_predict_array_streams_over_budget_volumes(weights):
    vol = np.random.RandomState(9).rand(32, 48, 48).astype(np.float32)
    config = _serve_config(weights["3d"])
    full = ServingSession(config).predict(vol)
    config["predictor"]["max_device_voxels"] = 16 * 64 * 64
    streamed = ServingSession(config).predict(vol)
    np.testing.assert_allclose(streamed, full, atol=STAT_TOL)


def test_serve_request_size_limit(weights):
    session = ServingSession(_serve_config(weights["3d"]), max_request_bytes=1024)
    srv, thread, base = _start_server(session)
    try:
        req = urllib.request.Request(f"{base}/predict", data=_npy(np.zeros((8, 24, 24), np.float32)), method="POST")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=30)
        assert err.value.code == 413
        assert "exceeds" in json.loads(err.value.read())["error"]
        assert session.info()["requests_served"] == 0
    finally:
        _stop(srv, thread)


def test_serve_bearer_token_auth(weights):
    session = ServingSession(_serve_config(weights["3d"]), token="s3cret")
    srv, thread, base = _start_server(session)
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as resp:
            assert json.loads(resp.read()) == {"status": "ok"}
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"{base}/info", timeout=30)
        assert err.value.code == 401
        assert err.value.headers.get("WWW-Authenticate", "").startswith("Bearer")
        vol = np.zeros((8, 24, 24), np.float32)
        with pytest.raises(urllib.error.HTTPError) as err:
            _post_volume(base, vol, headers={"Authorization": "Bearer wrong"})
        assert err.value.code == 401
        hdr = {"Authorization": "Bearer s3cret"}
        with urllib.request.urlopen(urllib.request.Request(f"{base}/info", headers=hdr), timeout=30) as resp:
            assert json.loads(resp.read())["auth"] is True
        assert _post_volume(base, vol, headers=hdr).shape == (2, 8, 24, 24)
    finally:
        _stop(srv, thread)


def test_main_refuses_an_open_non_loopback_host(monkeypatch):
    monkeypatch.delenv("P3DUNET_SERVE_TOKEN", raising=False)
    with pytest.raises(SystemExit):
        main(["--config", "unused.yml", "--host", "0.0.0.0"])


@pytest.mark.parametrize("global_norm", [False, True])
def test_serve_2d_microbatching_matches_direct(weights, global_norm):
    session = ServingSession(_serve_config(weights["2d"], two_d=True, global_norm=global_norm), batch_planes=8)
    assert session._batcher is not None
    rng = np.random.RandomState(11)
    vols = [rng.rand(d, 24, 24).astype(np.float32) * 2 + 1 for d in (2, 3, 2)]
    expected = [session._predict_direct(v, session._resolve_stats(v)) for v in vols]
    # hold the device lock: the worker blocks on its first item while the
    # rest queue, so the follow-up batch is deterministic
    with session._lock:
        futures = [session._batcher.submit(v, session._resolve_stats(v)) for v in vols]
        time.sleep(0.3)
    results = [f.result(timeout=600) for f in futures]
    assert session._batcher.batched_dispatches >= 1
    assert session._batcher.batched_requests >= 2
    for got, want in zip(results, expected):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=BATCH_TOL)


def test_serve_2d_oversize_request_skips_batcher(weights):
    session = ServingSession(_serve_config(weights["2d"], two_d=True), batch_planes=4)
    vol = np.random.RandomState(13).rand(6, 24, 24).astype(np.float32)
    pred = session.predict(vol)
    assert pred.shape == (1, 6, 24, 24)
    assert session._batcher.batched_dispatches == 0
    np.testing.assert_allclose(pred, session._predict_direct(vol, session._resolve_stats(vol)), atol=BATCH_TOL)


def test_quickstart_example_runs(tmp_path):
    # examples/quickstart_torch.py at its smallest: synthetic blobs, the port's
    # train CLI for 2 iterations, its predict CLI, Dice; on the CPU, which
    # the caller asks for (the script runs on the GPU by default)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, os.path.join(REPO, "examples", "quickstart_torch.py"), "--workdir",
                           str(tmp_path), "--iterations", "2", "--shape", "16", "48", "48", "--patch", "8", "24",
                           "24", "--device", "cpu"], cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "Quickstart finished: Dice vs ground truth" in proc.stdout
    with h5py.File(tmp_path / "out" / "test_predictions.h5", "r") as f:
        assert f["predictions"].shape == (1, 16, 48, 48)
