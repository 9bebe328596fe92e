"""HTTP inference server of the port around the device sweep:
`python -m pytorch3dunet_tpu_torch.serve --config predict_config.yml --port 8000`.

The counterpart of the JAX package's `serve3dunet` (pytorch3dunet_tpu/serve.py):
a resident process holding the model on its device answers prediction
requests with no per-request start-up, checkpoint load or kernel build. It
serves `DeviceSlidingWindowPredictor.predict_array` (the sweep on the device,
predictor.py) over a stdlib HTTP server:

    GET  /healthz            -> {"status": "ok"}, the liveness probe (no token needed)
    GET  /info               -> model, geometry and device metadata, and the request counters (JSON)
    POST /predict            -> body: a .npy volume, (D, H, W) or (C, D, H, W)
                                response: .npy (Cout, D, H, W) float32 probabilities
    POST /predict?output=segmentation
                             -> .npy (D, H, W) uint16 argmax / binarized labels

The config is the predict CLI's YAML (model, model_path, device,
loaders.test.slice_builder and transformer); `loaders.test.file_paths` is not
needed. Volumes travel as `numpy.save` bytes, loaded with `allow_pickle=False`.
The weights come through `utils/weights.py` `load_weights` (torch or JAX npz,
the EMA weights preferred).

- The server has no host fallback: a test transformer that the device sweep
  does not map (`detect_device_path`) is refused at start-up, as by the JAX
  server, and the predictor's own host loop is never taken.
- One sweep runs at a time: every request's device work runs under the
  session's lock, on the thread that holds it (the `ThreadingHTTPServer` keeps
  accepting meanwhile). The kernels launch on that thread's current stream.
- `warmup` builds the hand kernels (nvcc at first use, ops/build.py) and runs
  one patch at start-up, so the first request pays neither.
- `--pad-to-multiple Z Y X` reflect-pads each volume up to the multiples and
  crops the prediction back.
- 2D models, with `--batch-planes N`: concurrent requests of compatible
  planes coalesce into one sweep of up to N planes (`_MicroBatcher`). Off by
  default (the JAX server's default is 24): on an H100 it answered neither
  requests of one 512x512 tile nor of 4 planes of 1024x1024 sooner than
  the direct path (PERF.md, Findings).
- `GET /info` counts the requests served (`requests_served`), the
  micro-batcher's dispatches (`batching`), and under `stages` the cumulative
  `seconds` and `count` of each stage of a request: `lock_wait` (the wait for
  the session's lock), `predict` (`predict_array` under the lock; a
  micro-batched sweep counts once), `decode` (the handler's `.npy` load of the
  body) and `encode` (its `.npy` save of the reply). A stage that raised is
  not counted.
- `--token` (or `P3DUNET_SERVE_TOKEN`) requires `Authorization: Bearer
  <token>` on every endpoint but /healthz; a non-loopback `--host` needs it or
  `--insecure`. A body over `--max-request-mb` gets 413 before it is read.
"""

import argparse
import contextlib
import hmac
import io
import json
import os
import queue
import sys
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from pytorch3dunet_tpu_torch.config import resolve_device
from pytorch3dunet_tpu_torch.inference_device import detect_device_path
from pytorch3dunet_tpu_torch.models.unet import get_model, is_model_2d
from pytorch3dunet_tpu_torch.ops import build
from pytorch3dunet_tpu_torch.predict import get_predictor
from pytorch3dunet_tpu_torch.predictor import DeviceSlidingWindowPredictor
from pytorch3dunet_tpu_torch.utils.misc import get_logger
from pytorch3dunet_tpu_torch.utils.weights import load_weights

logger = get_logger("UNet3DServe")

_LOOPBACK_HOSTS = ("127.0.0.1", "localhost", "::1", "")
# the stages of a request that GET /info times (the module docstring)
STAGES = ("lock_wait", "predict", "decode", "encode")


class _MicroBatcher:
    """Cross-request micro-batching for 2D models.

    Concurrent /predict requests whose planes are compatible (same H, W and
    channels) coalesce into one sweep: a 2D model treats z as its batch, so
    stacking the request volumes along z, up to `bucket_planes` planes, turns
    N round-trips into one dispatch. A request
    that arrives alone takes the direct path with its own shape.
    """

    def __init__(self, session, bucket_planes: int):
        self.session = session
        self.bucket_planes = int(bucket_planes)
        self._q: queue.Queue = queue.Queue()
        self.batched_dispatches = 0
        self.batched_requests = 0
        self._thread = threading.Thread(target=self._run, daemon=True, name="serve-microbatch")
        self._thread.start()

    @staticmethod
    def _key(volume: np.ndarray):
        # (channels, H, W): z is the batch axis, everything else must match
        return (volume.shape[0] if volume.ndim == 4 else None,) + tuple(volume.shape[-2:])

    def submit(self, volume: np.ndarray, stats: dict) -> Future:
        f: Future = Future()
        self._q.put((volume, stats, f))
        return f

    def _run(self):
        pending = None
        while True:
            first = pending if pending is not None else self._q.get()
            pending = None
            batch = [first]
            planes = first[0].shape[-3]
            while planes < self.bucket_planes:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if self._key(nxt[0]) == self._key(first[0]) and planes + nxt[0].shape[-3] <= self.bucket_planes:
                    batch.append(nxt)
                    planes += nxt[0].shape[-3]
                else:
                    # incompatible or over the bucket: it leads the next batch
                    pending = nxt
                    break
            try:
                if len(batch) == 1:
                    vol, stats, fut = batch[0]
                    fut.set_result(self.session._predict_direct(vol, stats))
                else:
                    self.batched_dispatches += 1
                    self.batched_requests += len(batch)
                    results = self.session._predict_batched([(v, s) for v, s, _ in batch])
                    for (_, _, fut), r in zip(batch, results):
                        fut.set_result(r)
            except Exception as e:  # noqa: BLE001 - each request gets the error
                for *_, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)


class ServingSession:
    """A resident model and its device sweep behind a lock."""

    def __init__(self, config: dict, pad_to_multiple=None, token: str | None = None,
                 max_request_bytes: int = 2 << 30, batch_planes: int = 0):
        self.config = config
        self.device = config["device"] = resolve_device(config.get("device"))
        self.model = get_model(config["model"])
        model_path = config.get("model_path")
        if model_path:
            load_weights(self.model, model_path)
        else:
            logger.warning("No model_path in the config: serving RANDOM weights (smoke-test mode)")
        self.model = self.model.to(self.device).eval()

        sb = config["loaders"]["test"]["slice_builder"]
        self.patch_shape = tuple(sb["patch_shape"])
        self.stride_shape = tuple(sb.get("stride_shape", sb["patch_shape"]))
        self.halo_shape = tuple(sb.get("halo_shape", (0, 0, 0)))
        transformer = config["loaders"]["test"]["transformer"]["raw"]
        path = detect_device_path(transformer, config["loaders"].get("stats"))
        if path is None:
            raise ValueError("The test transformer pipeline is not supported by the device sweep (supported: "
                             "Standardize / Normalize / PercentileNormalizer + ToTensor); the server has no host "
                             "fallback loop")
        self.normalize, self.stats = path
        if self.normalize == "standardize_patch" and config["loaders"].get("global_normalization"):
            # global_normalization: the batch path standardizes with the
            # whole volume's mean and std; the server computes them per
            # request volume (`_resolve_stats`)
            self.normalize, self.stats = "standardize", {"mean": None, "std": None}
        self.is_2d = is_model_2d(self.model)

        config.setdefault("predictor", {}).setdefault("name", "DeviceSlidingWindowPredictor")
        self.predictor = get_predictor(self.model, config)
        if not isinstance(self.predictor, DeviceSlidingWindowPredictor):
            raise ValueError(f"the server serves the device sweep; got predictor {type(self.predictor).__name__} "
                             f"(set predictor.name: DeviceSlidingWindowPredictor)")

        self.pad_to_multiple = None if pad_to_multiple is None else tuple(int(m) for m in pad_to_multiple)
        self.token = token
        self.max_request_bytes = int(max_request_bytes)
        self._lock = threading.Lock()
        self._n_served = 0
        # cumulative [seconds, count] of each stage of a request (`stage`), under their own lock: the handler
        # threads decode and encode concurrently
        self._stages = {name: [0.0, 0] for name in STAGES}
        self._stages_lock = threading.Lock()
        # cross-request micro-batching: 2D models only (z is a batch axis
        # there); percentile normalization has no exact host/none split
        self._batcher = None
        if self.is_2d and batch_planes and self.normalize != "percentile":
            self._batcher = _MicroBatcher(self, batch_planes)

    # ------------------------------------------------------------- inference

    def _resolve_stats(self, volume: np.ndarray) -> dict:
        """'standardize' without a fixed mean and std is the per-volume
        global_normalization: the statistics of the request body."""
        stats = dict(self.stats)
        if self.normalize == "standardize" and stats.get("mean") is None:
            stats["mean"] = float(volume.mean())
            stats["std"] = float(volume.std())
        return stats

    def predict(self, volume: np.ndarray, segmentation: bool = False) -> np.ndarray:
        volume = np.asarray(volume, dtype=np.float32)
        # per-volume statistics come from the request volume, before any
        # pad_to_multiple reflection planes dilute them
        stats = self._resolve_stats(volume)
        if self._batcher is not None and volume.shape[-3] <= self._batcher.bucket_planes:
            probs = self._batcher.submit(volume, stats).result()
        else:
            probs = self._predict_direct(volume, stats)
        if segmentation:
            return self.predictor._to_segmentation(probs)
        return probs

    def _pad_to_multiple(self, volume: np.ndarray, axes=(0, 1, 2)):
        """Reflect-pads the selected spatial axes up to the configured
        multiples; returns (padded, crop), the crop covering every spatial axis."""
        spatial = volume.shape[1:] if volume.ndim == 4 else volume.shape
        crop = None
        if self.pad_to_multiple is not None:
            pads = [((-s) % m if i in axes else 0) for i, (s, m) in enumerate(zip(spatial, self.pad_to_multiple))]
            if any(pads):
                width = [(0, p) for p in pads]
                if volume.ndim == 4:
                    width = [(0, 0)] + width
                volume = np.pad(volume, width, mode="reflect")
                crop = tuple(slice(0, s) for s in spatial)
        return volume, crop

    @contextlib.contextmanager
    def stage(self, name: str):
        """Adds the seconds of the block to the stage `name` of GET /info and counts it, once it has ended
        without raising."""
        start = time.perf_counter()
        yield
        self._count_stage(name, time.perf_counter() - start)

    def _count_stage(self, name: str, seconds: float):
        with self._stages_lock:
            self._stages[name][0] += seconds
            self._stages[name][1] += 1

    def _predict_locked(self, volume: np.ndarray, normalize, stats: dict, requests: int) -> np.ndarray:
        """`predict_array` of `volume` under the session's lock, for `requests` requests; times the wait for
        the lock and the call."""
        start = time.perf_counter()
        with self._lock:
            locked = time.perf_counter()
            probs = self.predictor.predict_array(volume, self.patch_shape, self.stride_shape, self.halo_shape,
                                                 normalize=normalize, stats=stats)
            self._n_served += requests
            self._count_stage("lock_wait", locked - start)
            self._count_stage("predict", time.perf_counter() - locked)
        return probs

    def _predict_direct(self, volume: np.ndarray, stats: dict) -> np.ndarray:
        volume, crop = self._pad_to_multiple(volume)
        probs = self._predict_locked(volume, self.normalize, stats, 1)
        if crop is not None:
            probs = probs[(slice(None),) + crop]
        return probs

    def _predict_batched(self, items) -> list:
        """One sweep for several compatible 2D requests.

        Volume-level normalizations are applied per request on the host (the
        arithmetic of the device's, a few MB of planes) and the sweep runs
        with normalize='none'; 'standardize_patch' is per patch either way and
        batches as it is. The stack keeps its own depth: eager PyTorch has no
        per-shape compile for a fixed bucket depth to spare (the JAX server
        edge-pads to `bucket_planes`)."""
        mode = self.normalize
        arrs = []
        for vol, stats in items:
            if mode == "standardize":
                vol = (vol - np.float32(stats["mean"])) / max(np.float32(stats["std"]), np.float32(1e-10))
            elif mode == "normalize":
                lo, hi = vol.min(), vol.max()
                vol = np.clip(2 * (vol - lo) / (hi - lo + 1e-10) - 1, -1, 1).astype(np.float32)
            arrs.append(vol)
        dev_mode = mode if mode == "standardize_patch" else "none"
        zaxis = arrs[0].ndim - 3
        depths = [a.shape[zaxis] for a in arrs]
        stacked = np.concatenate(arrs, axis=zaxis)
        stacked, crop = self._pad_to_multiple(stacked, axes=(1, 2))
        probs = self._predict_locked(stacked, dev_mode, {}, len(items))
        if crop is not None:
            probs = probs[(slice(None), slice(None)) + crop[1:]]
        out, z = [], 0
        for d in depths:
            out.append(probs[:, z : z + d])
            z += d
        return out

    def warmup(self, shape=None):
        """Builds the kernels (on CUDA) and predicts one volume of `shape`
        (default: one patch with its halo) at start-up."""
        if shape is None:
            shape = tuple(max(p, 2 * h + p) for p, h in zip(self.patch_shape, self.halo_shape))
        if self.device.type == "cuda":
            logger.info("Warmup: building the CUDA kernels...")
            build.load_all()
        logger.info(f"Warmup: predicting a volume of shape {tuple(shape)}...")
        self.predict(np.zeros(tuple(shape), dtype=np.float32))
        logger.info("Warmup done")

    def info(self) -> dict:
        with self._stages_lock:
            stages = {name: {"seconds": seconds, "count": count} for name, (seconds, count) in self._stages.items()}
        devices = [str(self.device)]
        if self.device.type == "cuda":
            devices = [f"{self.device} ({torch.cuda.get_device_name(self.device)})"]
        return {
            "model": self.config["model"],
            "patch_shape": list(self.patch_shape),
            "stride_shape": list(self.stride_shape),
            "halo_shape": list(self.halo_shape),
            "normalize": self.normalize,
            "pad_to_multiple": list(self.pad_to_multiple) if self.pad_to_multiple else None,
            "devices": devices,
            "requests_served": self._n_served,
            "stages": stages,
            "max_request_bytes": self.max_request_bytes,
            "auth": self.token is not None,
            "batching": None if self._batcher is None else {
                "bucket_planes": self._batcher.bucket_planes,
                "batched_dispatches": self._batcher.batched_dispatches,
                "batched_requests": self._batcher.batched_requests,
            },
            "predictor": {
                "patch_mode": self.predictor.patch_mode,
                "blend": self.predictor.blend,
                "tta": bool(self.predictor.tta),
            },
        }


class _Handler(BaseHTTPRequestHandler):
    session: ServingSession = None  # bound by make_server
    protocol_version = "HTTP/1.1"

    # the stdlib request log through the logger
    def log_message(self, fmt, *args):
        logger.info("%s %s" % (self.address_string(), fmt % args))

    def _reply(self, code: int, body: bytes, content_type: str, headers=()):
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for name, value in headers:
            self.send_header(name, value)
        if code >= 400:
            # an error may leave an unread request body on the socket: closing
            # keeps a keep-alive client from reading it as its next request
            self.send_header("Connection", "close")
            self.close_connection = True
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, code: int, obj: dict, headers=()):
        self._reply(code, json.dumps(obj).encode(), "application/json", headers)

    def _authorized(self) -> bool:
        """The bearer token, compared in constant time."""
        token = self.session.token
        if token is None:
            return True
        return hmac.compare_digest(self.headers.get("Authorization", ""), f"Bearer {token}")

    def _reply_401(self):
        self._reply_json(401, {"error": "missing or invalid bearer token"},
                         headers=[("WWW-Authenticate", 'Bearer realm="serve3dunet"')])

    def do_GET(self):
        path = urlparse(self.path).path
        if path == "/healthz":
            self._reply_json(200, {"status": "ok"})
        elif not self._authorized():
            self._reply_401()
        elif path == "/info":
            self._reply_json(200, self.session.info())
        else:
            self._reply_json(404, {"error": f"unknown path {path!r}"})

    def do_POST(self):
        url = urlparse(self.path)
        if not self._authorized():
            self._reply_401()
            return
        if url.path != "/predict":
            self._reply_json(404, {"error": f"unknown path {url.path!r}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            if length <= 0:
                raise ValueError("empty request body (send numpy.save bytes)")
        except ValueError as e:
            self._reply_json(400, {"error": str(e)})
            return
        if length > self.session.max_request_bytes:
            # refused before reading: an oversize body is never buffered
            self._reply_json(413, {"error": f"request body {length} bytes exceeds the "
                                            f"{self.session.max_request_bytes}-byte limit"})
            return
        try:
            body = self.rfile.read(length)
            with self.session.stage("decode"):
                volume = np.load(io.BytesIO(body), allow_pickle=False)
                if volume.ndim not in (3, 4):
                    raise ValueError(f"expected a (D, H, W) or (C, D, H, W) volume, got shape {volume.shape}")
                volume = np.asarray(volume, dtype=np.float32)
        except Exception as e:  # noqa: BLE001 - malformed input -> 400
            self._reply_json(400, {"error": str(e)})
            return
        output = parse_qs(url.query).get("output", ["probabilities"])[0]
        if output not in ("probabilities", "segmentation"):
            self._reply_json(400, {"error": f"output must be 'probabilities' or 'segmentation', got {output!r}"})
            return
        try:
            pred = self.session.predict(volume, segmentation=(output == "segmentation"))
        except Exception as e:  # noqa: BLE001 - inference errors -> 500
            logger.exception("prediction failed")
            self._reply_json(500, {"error": str(e)})
            return
        with self.session.stage("encode"):
            buf = io.BytesIO()
            np.save(buf, pred)
            body = buf.getvalue()
        self._reply(200, body, "application/octet-stream")


def make_server(session: ServingSession, host: str = "127.0.0.1", port: int = 8000) -> ThreadingHTTPServer:
    """The HTTP server bound to `session`, not started."""
    handler = type("BoundHandler", (_Handler,), {"session": session})
    return ThreadingHTTPServer((host, port), handler)


def main(argv=None):
    import yaml

    parser = argparse.ArgumentParser(description="Serve a trained U-Net over HTTP (PyTorch port)")
    parser.add_argument("--config", required=True, help="the predict CLI's YAML config")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--no-warmup", action="store_true",
                        help="skip the start-up kernel build and patch (the first request pays them)")
    parser.add_argument("--warmup-shape", type=int, nargs=3, default=None,
                        help="volume shape predicted at start-up (default: one patch)")
    parser.add_argument("--pad-to-multiple", type=int, nargs=3, default=None,
                        help="reflect-pad request volumes up to these (Z, Y, X) multiples")
    parser.add_argument("--token", default=os.environ.get("P3DUNET_SERVE_TOKEN"),
                        help="bearer token required on every endpoint except /healthz "
                             "(default: $P3DUNET_SERVE_TOKEN; required for a non-loopback --host)")
    parser.add_argument("--insecure", action="store_true",
                        help="allow binding a non-loopback --host without --token")
    parser.add_argument("--max-request-mb", type=int, default=2048,
                        help="reject request bodies larger than this with 413 (default 2048)")
    parser.add_argument("--batch-planes", type=int, default=0,
                        help="2D models: coalesce concurrent requests into one sweep of up to this many planes "
                             "(default 0: off; the JAX server's default is 24)")
    args = parser.parse_args(argv)

    if args.host not in _LOOPBACK_HOSTS and not args.token and not args.insecure:
        parser.error(f"--host {args.host} is reachable off-machine: pass --token (or set P3DUNET_SERVE_TOKEN) to "
                     "require authentication, or --insecure to serve open")

    with open(args.config) as f:
        config = yaml.safe_load(f)
    session = ServingSession(config, pad_to_multiple=args.pad_to_multiple, token=args.token,
                             max_request_bytes=args.max_request_mb << 20, batch_planes=args.batch_planes)
    if not args.no_warmup:
        session.warmup(args.warmup_shape)

    server = make_server(session, args.host, args.port)
    logger.info(f"Serving on http://{args.host}:{server.server_address[1]} (POST /predict, GET /healthz, GET /info)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        logger.info("Shutting down")
        server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
