"""host_ms.serve: the median over the window's requests of the client-side
latency less the request's own `predict_array` call, in ms: the HTTP and
.npy path and the wait for the session's lock (traffic/serve.py `host_ms`)."""

from benchmark.traffic.serve import host_ms


def read(window):
    if window.kind != "serve":
        return None
    return host_ms(window.spans.get("requests", []), window.spans.get("calls", []))
