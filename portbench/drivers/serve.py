"""Serving cells: the port's DEC behind its HTTP server, as `scc-serve-torch
--waveform` builds it (`serve.DECPredictor` with buckets, the fused
`serve.WaveformFrontend`, `serve_http.make_server`), in this process, and
closed-loop clients in a child process (`traffic/http_clients.py`).

Set-up starts the child (which makes its payloads meanwhile), draws the
weights, builds and warms the predictor and frontend on each request
shape of the mix, and starts the server. The window opens when the
clients are told to go and closes when the last of them has its last
reply. In a traced run the frontend handed to the server is a wrapper
that times each call, and the profiler covers the whole window.

After the window the reference works out every kept answer again from
its payload: a float64 STFT, the windows and their normalisation, the
network in float64.
"""

from __future__ import annotations

import gc
import math
import multiprocessing
import threading
import time

import numpy as np
import torch

from portbench import compare, harness, roofline, trace
from portbench.reference import network
from portbench.reference import stft as ref_stft
from portbench.reference.train import matmul_precision
from portbench.traffic import http_clients
from portbench.traffic.requests import payload

#: seconds past the window's close that the clients may take to finish
GRACE_S = 120.0


class TimedFrontend:
    """The frontend with a clock around each call: (request shape,
    seconds) in `calls`."""

    def __init__(self, inner):
        self._inner = inner
        self.calls = []
        self._lock = threading.Lock()

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __call__(self, wave):
        t0 = time.perf_counter()
        try:
            return self._inner(wave)
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.calls.append((tuple(np.shape(wave)), dt))


def _samples(shape) -> int:
    return int(np.prod(shape))


def request_flops(shape, cfg) -> float:
    """Useful operations of one request: K1's FFT count and the encoder
    with the Student-t over its windows."""
    s = cfg["stft"]
    c, t = (1, shape[-1]) if len(shape) == 1 else shape
    per = roofline.stft_frames(t, s["nperseg"], s["hop"]) // s["window_rows"]
    return (roofline.k1_flops(c, t, s["nperseg"], s["hop"])
            + c * per * roofline.encoder_flops(cfg["input_hw"],
                                               cfg["n_clusters"]))


def nearest_rank(values, q: float) -> float:
    v = sorted(values)
    return v[max(math.ceil(q * len(v)) - 1, 0)] if v else math.inf


def run(ctx) -> dict:
    from spectrogram_cube_clustering_tpu_torch import serve, serve_http

    cfg, prm, dev = ctx.config, ctx.params, ctx.device
    hw, k = tuple(cfg["input_hw"]), cfg["n_clusters"]
    spec = {"seed": ctx.seed, "mix": prm["mix"], "clients": prm["clients"],
            "amplitude": prm["amplitude"], "keep_share": prm["keep_share"],
            "stft": cfg["stft"], "n_clusters": k}
    mp = multiprocessing.get_context("spawn")
    pipe, child_pipe = mp.Pipe()
    child = mp.Process(target=http_clients.main, args=(spec, child_pipe))
    child.start()
    server = thread = None
    try:
        ctx.note("imports and the card's first use")
        gen = torch.Generator(device=dev).manual_seed(ctx.seed)
        w0 = harness.seeded_weights(network.param_shapes(hw, k), gen, dev)
        s = cfg["stft"]
        predictor = serve.DECPredictor(
            w0, n_clusters=k, max_batch=prm["max_batch"],
            transform=cfg["transform"], buckets=True, input_hw=hw,
            attention_faithful=cfg["attention_faithful"], device=dev)
        frontend = serve.WaveformFrontend(
            predictor, nperseg=s["nperseg"], hop=s["hop"],
            window_rows=s["window_rows"])
        frontend.warmup()
        ctx.note("predictor and frontend warm-up")
        for m in prm["mix"]:
            frontend(np.zeros(m["shape"], np.float32))
        front = TimedFrontend(frontend) if ctx.trace else frontend
        server = serve_http.make_server(
            predictor, port=0, waveform_frontend=front,
            max_request_mb=prm["max_request_mb"])
        thread = threading.Thread(target=server.serve_forever,
                                  kwargs={"poll_interval": 0.05})
        thread.start()
        if not pipe.poll(300) or pipe.recv() != "ready":
            raise RuntimeError("the clients did not get ready")
        harness.sync(dev)
        ctx.note("warm-up on the mix's shapes, server up, clients ready")

        # ------------------------------------------------- the window
        harness.reset_peak(dev)
        with trace.Slice(dev if ctx.trace else torch.device("cpu")) as sl:
            t0 = ctx.clock.now()
            ctx.window_started(t0)
            pipe.send(("go", server.server_address[1], ctx.seconds))
            if not pipe.poll(ctx.seconds + GRACE_S) or pipe.recv() != "done":
                raise RuntimeError("the clients did not finish")
        harness.sync(dev)
        if not pipe.poll(GRACE_S):
            raise RuntimeError("the clients sent no records")
        result = pipe.recv()
        peak = harness.peak_bytes(dev)
        frontend_calls = front.calls if ctx.trace else []
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        if thread is not None:
            thread.join(60)
        child.join(60)
        if child.is_alive():
            child.terminate()
            child.join(10)
    del predictor, frontend, front, server
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    records, window_s = result["records"], result["window_s"]
    shapes = [tuple(prm["mix"][r[2]]["shape"]) for r in records]
    lat = [(r[5] - r[4]) if r[6] else math.inf for r in records]
    ok = [r[6] for r in records]
    served = sum(_samples(sh) for sh, good in zip(shapes, ok) if good)
    compared = _reference(ctx, result["kept"], w0)
    compared.append(("failed_requests", float(len(ok) - sum(ok)),
                     ctx.limits.get("failed_requests")))
    return {
        "end_to_end": {
            "request_p95_ms": nearest_rank(lat, 0.95) * 1e3,
            "served_samples_per_s": served / window_s,
            "peak_device_mib": peak / 2 ** 20,
        },
        "data": {
            "window_s": window_s,
            "latencies_s": [x for x in lat if math.isfinite(x)],
            "frontend_calls": frontend_calls,
            "flops": sum(request_flops(sh, cfg)
                         for sh, good in zip(shapes, ok) if good),
            "slice": ({"summary": sl.summary} if ctx.trace else None),
            "stft": cfg["stft"],
        },
        "compared": compared,
        "attempted": len(ok),
        "failed": len(ok) - sum(ok),
        "peak_bytes": peak,
    }


def _outputs(wave: np.ndarray, w: dict, cfg, dtype, device) -> tuple:
    """(q, labels, z, windows per channel) of one payload by the
    reference in `dtype`."""
    s = cfg["stft"]
    x = torch.from_numpy(np.atleast_2d(wave)).to(device)
    spec = ref_stft.log_power(x, s["nperseg"], s["hop"], dtype)
    win = ref_stft.NORMALIZERS[cfg["transform"]](
        ref_stft.windows(spec, s["window_rows"]))
    q, z = network.dec_outputs({n: v.to(dtype) for n, v in w.items()}, win)
    per = spec.shape[1] // s["window_rows"]
    return q, torch.argmax(q, dim=1), z, per


def _reference(ctx, kept, w0) -> list:
    """The kept answers against the reference's; in control mode the
    reference one precision below (float32 STFT, TF32) in their place."""
    cfg, prm = ctx.config, ctx.params
    dev = ctx.device
    gaps = {"q_gap": 0.0, "z_gap": 0.0, "labels_not_argmax": 0.0,
            "windows_mismatch": 0.0}
    refs = {}
    for c, i, cls, j, out in kept:
        if (cls, j) not in refs:
            wave = payload(ctx.seed, cls, j, prm["mix"], prm["amplitude"])
            refs[cls, j] = _outputs(wave, w0, cfg, torch.float64, dev)
            if ctx.mode == "control":
                with matmul_precision(True):
                    got = _outputs(wave, w0, cfg, torch.float32, dev)
                refs[cls, j] += (got,)
        ref = refs[cls, j]
        if ctx.mode == "control":
            q, labels, z, per = ref[4]
            out = {"q": q, "labels": labels, "z": z,
                   "windows_per_channel": np.full(1, per)}
        q_ref, _, z_ref, per = ref[:4]
        zscale = float(z_ref.abs().max()) or 1.0
        gaps["q_gap"] = max(gaps["q_gap"], compare.max_abs_gap(
            torch.as_tensor(out["q"]), q_ref))
        gaps["z_gap"] = max(gaps["z_gap"], compare.max_abs_gap(
            torch.as_tensor(out["z"]), z_ref) / zscale)
        # a label is the argmax of its own q, which q_gap holds to the
        # reference's; labels alone flip only at near-ties of q
        gaps["labels_not_argmax"] += float(compare.share_differing(
            torch.as_tensor(out["labels"]),
            torch.argmax(torch.as_tensor(out["q"]), dim=1)) * len(out["q"]))
        gaps["windows_mismatch"] += float(
            (np.asarray(out["windows_per_channel"]) != per).sum())
    if not kept:
        gaps = {n: math.inf for n in gaps}
    return [(n, v, ctx.limits.get(n)) for n, v in gaps.items()]
