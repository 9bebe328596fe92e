"""Traffic `serve`: the HTTP server (`ServingSession` behind `make_server` on
127.0.0.1, on a port the OS picks) answering closed-loop clients, each of
which sends its next `POST /predict` when its last reply has arrived.

Cell parameters: `recipe` (the configuration's section: the predict config
the server is started with), `request` (the (D, H, W) of a request volume),
`pool` (distinct request volumes made from the seed, cycled), `clients`,
`checked` (requests whose replies the check compares, drawn from the seed
among the first `checked_from`, and the window's last).

Set-up writes the seeded weights to a checkpoint under the temporary
directory, starts the session from the predict config with its weights,
warms it up at the request shape (`warmup(shape)`), and starts the clients in
a process of their own (traffic/serve_client.py), which reads the request
volumes from a file the set-up wrote, sends one request per client and waits.
The window opens the clients for `--seconds`; each request's latency is from
its send to its whole reply body received, on the client's side. The check
decodes the sampled replies and holds them against the plain sliding window
of their volumes.
"""

import json
import random
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from benchmark import seeded
from benchmark.harness import CHECKOUT, Window
from benchmark.reference import sweep as ref_sweep
from benchmark.traffic.sweep import recipe_model


@dataclass
class State:
    recipe: dict
    model_cfg: dict
    params: dict
    volumes: list
    session: object
    server: object
    thread: object
    client: object
    workdir: Path
    device: object
    calls: list = field(default_factory=list)
    records: list = field(default_factory=list)


def setup(cell, config, seed, device, tracer) -> State:
    from pytorch3dunet_tpu_torch.config import resolve_device
    from pytorch3dunet_tpu_torch.serve import ServingSession, make_server

    recipe = config[cell["recipe"]]
    tracer.note("imported")
    device = resolve_device(str(device))
    workdir = Path(tempfile.mkdtemp())
    params = seeded.weights(config["model"], seed, device)
    torch.save({"model_state_dict": {k: v.cpu() for k, v in params.items()}}, workdir / "model.pytorch")
    model_cfg = recipe_model(config, recipe)
    serve_config = {
        "model": model_cfg, "model_path": str(workdir / "model.pytorch"), "device": device.type,
        "predictor": dict(recipe["predictor"]),
        "loaders": {"global_normalization": recipe.get("global_normalization", False),
                    "test": {"slice_builder": {k: recipe[k] for k in ("patch_shape", "stride_shape", "halo_shape")},
                             "transformer": {"raw": recipe["transformer"]}}},
    }
    session = ServingSession(serve_config)
    tracer.note("session")
    shape = tuple(cell["request"])
    session.warmup(shape)
    tracer.note("warm-up")
    volumes = seeded.volumes(shape, int(cell["pool"]), seed, device, int(cell.get("cells", 60)))
    np.save(workdir / "requests.npy", np.stack(volumes))
    tracer.note("requests")

    server = make_server(session, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, name="bench-serve", daemon=True)
    thread.start()
    keep = sorted(random.Random(seed).sample(range(int(cell["checked_from"])), int(cell["checked"])))
    client = subprocess.Popen(
        [sys.executable, "-m", "benchmark.traffic.serve_client", "--port", str(server.server_address[1]),
         "--requests", str(workdir / "requests.npy"), "--clients", str(cell["clients"]),
         "--keep", ",".join(map(str, keep)), "--out", str(workdir)],
        cwd=CHECKOUT, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    ready = client.stdout.readline().strip()
    if ready != "ready":
        client.kill()
        client.wait()
        server.shutdown()
        raise RuntimeError(f"the serve client did not start: {ready!r}")
    tracer.note("clients")
    state = State(recipe, model_cfg, params, volumes, session, server, thread, client, workdir, device)

    predict_array = session.predictor.predict_array

    def timed(*args, **kwargs):
        with tracer.range("serve.predict_array"):
            start = time.perf_counter()
            out = predict_array(*args, **kwargs)
            state.calls.append((start, time.perf_counter()))
            return out

    session.predictor.predict_array = timed
    return state


def _stop(state: State):
    if state.server is not None:
        state.server.shutdown()
        state.server.server_close()
        state.thread.join(timeout=60)
        state.server = None
    if state.client is not None and state.client.poll() is None:
        state.client.kill()
        state.client.wait()


def window(state: State, seconds: float, tracer, sync) -> Window:
    state.calls.clear()
    tracer.start()
    try:
        out, _ = state.client.communicate(f"go {seconds}\n", timeout=seconds + 600)
    finally:
        tracer.stop(sync)
        _stop(state)
    if state.client.returncode != 0:
        raise RuntimeError(f"the serve client exited with {state.client.returncode}")
    state.records = json.loads(out.strip().splitlines()[-1])["requests"]
    ok = [r for r in state.records if r["status"] == 200]
    latencies = [1e3 * (r["recv"] - r["send"]) for r in state.records]
    p90 = float(np.percentile(latencies, 90)) if latencies else float("inf")
    return Window("serve", len(state.records), len(state.records) - len(ok),
                  {"serve_p90_ms": (p90, "ms")}, spans={"requests": state.records, "calls": list(state.calls)})


def host_ms(records: list, calls: list) -> float | None:
    """The median over requests of the latency less the request's own
    `predict_array` call: the latest unclaimed call that ran inside it (the
    calls are serialized, and a reply follows its own call)."""
    free = sorted(calls, key=lambda c: c[1])
    own = []
    for r in sorted(records, key=lambda r: r["recv"]):
        inside = [c for c in free if c[0] >= r["send"] and c[1] <= r["recv"]]
        if inside:
            call = inside[-1]
            free.remove(call)
            own.append(1e3 * ((r["recv"] - r["send"]) - (call[1] - call[0])))
    return statistics.median(own) if own else None


def check(state: State, window: Window, limits: dict) -> dict:
    """{'max_abs_gap': (the widest gap of a sampled reply's probability to the reference, its limit)}."""
    recipe = state.recipe
    state.session = None
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model_cfg = dict(state.model_cfg, dtype=None)
    checked = [r for r in state.records if r.get("kept")]
    gap = 0.0 if checked else float("inf")
    for r in checked:
        reply = np.load(state.workdir / r["kept"], allow_pickle=False)
        ref = ref_sweep.predict(state.volumes[r["volume"]], state.params, model_cfg, recipe["patch_shape"],
                                recipe["stride_shape"], recipe["halo_shape"], "assign", state.device)
        gap = max(gap, ref_sweep.max_gap(reply, ref))
    shutil.rmtree(state.workdir, ignore_errors=True)
    return {"max_abs_gap": (gap, float(limits.get("max_abs_gap", 0.0)))}
