"""The closed-loop clients of the `serve` traffic, in a process of their own
so that they do not share the server's interpreter; they use the CPU only.

    python -m benchmark.traffic.serve_client --port P --requests FILE --clients N --keep 3,17 --out DIR

Reads the request volumes (one .npy stack), serializes each once, sends one
request per client, prints `ready` and waits for `go <seconds>` on standard
input. Then each client sends `POST /predict` with the next volume of the
pool (request i carries volume i mod pool) as soon as its last reply has
arrived, until the seconds have passed, and waits for its last reply. The
replies of the requests named by `--keep`, and the last reply, are written to
DIR. The last line of standard output is {"requests": [...]}: per request its
index, volume, status, send and receive times (perf_counter: the host's
monotonic clock, which the server's process shares) and, for a kept one, the
file of its reply.
"""

import argparse
import http.client
import io
import json
import sys
import threading
import time

import numpy as np


def post(conn: http.client.HTTPConnection, body: bytes) -> tuple[int, bytes]:
    conn.request("POST", "/predict", body=body, headers={"Content-Type": "application/octet-stream"})
    response = conn.getresponse()
    return response.status, response.read()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, required=True)
    parser.add_argument("--requests", required=True)
    parser.add_argument("--clients", type=int, required=True)
    parser.add_argument("--keep", default="")
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)

    bodies = []
    for volume in np.load(args.requests):
        buf = io.BytesIO()
        np.save(buf, volume)
        bodies.append(buf.getvalue())
    keep = {int(k) for k in args.keep.split(",") if k}
    conns = [http.client.HTTPConnection("127.0.0.1", args.port, timeout=600) for _ in range(args.clients)]
    for conn in conns:
        status, _ = post(conn, bodies[0])
        if status != 200:
            print(f"warm-up request answered {status}", flush=True)
            return 1
    print("ready", flush=True)
    command = sys.stdin.readline().split()
    seconds = float(command[1])

    records, last, lock = [], {"index": -1, "reply": None}, threading.Lock()
    counter = iter(range(10**9))
    deadline = time.perf_counter() + seconds

    def client(conn):
        while time.perf_counter() < deadline:
            with lock:
                i = next(counter)
            volume = i % len(bodies)
            send = time.perf_counter()
            try:
                status, reply = post(conn, bodies[volume])
            except (OSError, http.client.HTTPException):
                status, reply = 0, b""
            record = {"index": i, "volume": volume, "status": status, "send": send, "recv": time.perf_counter()}
            with lock:
                records.append(record)
                if i > last["index"]:
                    last.update(index=i, reply=reply)
                if i in keep:
                    record["keep_reply"] = reply

    threads = [threading.Thread(target=client, args=(conn,)) for conn in conns]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for conn in conns:
        conn.close()

    for r in records:
        reply = r.pop("keep_reply", None)
        if r["index"] == last["index"]:
            reply = last["reply"]
        if reply is not None and r["status"] == 200:
            name = f"reply_{r['index']}.npy"
            with open(f"{args.out}/{name}", "wb") as f:
                f.write(reply)
            r["kept"] = name
    print(json.dumps({"requests": sorted(records, key=lambda r: r["index"])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
