"""Closed-loop HTTP clients, run in a child process of the serving cell.

Each client holds one keep-alive connection and sends its next POST
/predict_waveform only after the previous reply has been read whole.
Latency is timed here, from the send to the last byte of the response.
Every response is checked for its status and its fields' shapes; the
responses that `keep` picks are sent back whole for the reference to
judge. The payloads are made before the window, so the window times the
server and not the generator.

Protocol over the pipe: the child sends "ready" once its payloads are
made, receives ("go", port, seconds), runs, sends "done" as the last
reply is in, then its records.
"""

from __future__ import annotations

import http.client
import io
import threading
import time

import numpy as np


def _expect(shape, spec) -> tuple:
    """(channels, windows per channel) of a payload's answer."""
    s = spec["stft"]
    t, c = shape[-1], (1 if len(shape) == 1 else shape[0])
    frames = (t - s["nperseg"]) // s["hop"] + 1
    return c, frames // s["window_rows"]


def _check(body: bytes, shape, spec) -> dict:
    """The answer's arrays, or ValueError if a field is missing or
    misshapen or not finite."""
    c, per = _expect(shape, spec)
    n, k = c * per, spec["n_clusters"]
    with np.load(io.BytesIO(body)) as z:
        out = {key: z[key] for key in z.files}
    want = {"q": (n, k), "labels": (n,), "z": (n, 9),
            "windows_per_channel": (c,)}
    for key, shp in want.items():
        if key not in out or out[key].shape != shp:
            raise ValueError(f"field {key} missing or misshapen")
    if not (np.isfinite(out["q"]).all() and np.isfinite(out["z"]).all()):
        raise ValueError("q or z not finite")
    return out


def _client(c, spec, port, payloads, go, t_end, records, kept, lock):
    from portbench.traffic.requests import schedule

    mix = spec["mix"]
    keep_rng = np.random.default_rng([spec["seed"], c, 1])
    seen_class = set()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    go.wait()
    i = 0
    for cls, j in schedule(spec["seed"], c, mix):
        if time.perf_counter() >= t_end[0]:
            break
        body = payloads[cls, j]
        t0 = time.perf_counter()
        status, data = None, b""
        try:
            conn.request("POST", "/predict_waveform", body=body,
                         headers={"Content-Type": "application/octet-stream"})
            resp = conn.getresponse()
            status, data = resp.status, resp.read()
        except (OSError, http.client.HTTPException):
            conn.close()
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        t1 = time.perf_counter()
        ok, out = status == 200, None
        if ok:
            try:
                out = _check(data, mix[cls]["shape"], spec)
            except (ValueError, OSError, KeyError):
                ok = False
        pick = keep_rng.random() < spec["keep_share"]
        with lock:
            records.append((c, i, cls, j, t0, t1, ok, status))
            if ok and (cls not in seen_class or pick):
                kept.append((c, i, cls, j, out))
        seen_class.add(cls)
        i += 1
    conn.close()


def main(spec: dict, pipe) -> None:
    """The child's entry: make the payloads, run the clients, report."""
    import torch

    from portbench.traffic.requests import payload

    torch.set_num_threads(2)
    payloads = {}
    for cls, m in enumerate(spec["mix"]):
        for j in range(m["pool"]):
            buf = io.BytesIO()
            np.save(buf, payload(spec["seed"], cls, j, spec["mix"],
                                 spec["amplitude"]))
            payloads[cls, j] = buf.getvalue()
    pipe.send("ready")
    msg = pipe.recv()
    if msg[0] != "go":
        return
    _, port, seconds = msg
    records, kept, lock = [], [], threading.Lock()
    go, t_end = threading.Event(), [0.0]
    threads = [threading.Thread(target=_client, args=(
        c, spec, port, payloads, go, t_end, records, kept, lock))
        for c in range(spec["clients"])]
    for t in threads:
        t.start()
    t_go = time.perf_counter()
    t_end[0] = t_go + seconds
    go.set()
    for t in threads:
        t.join()
    last = max((r[5] for r in records), default=t_go)
    pipe.send("done")  # before the records, whose pickling takes a while
    pipe.send({"records": [(c, i, cls, j, t0 - t_go, t1 - t_go, ok, st)
                           for c, i, cls, j, t0, t1, ok, st in records],
               "kept": kept, "window_s": last - t_go})
