"""HTTP serving front end with dynamic micro-batching, for the torch port.

This module is a copy of the JAX package's `serve_http.py` with its entry
point changed and two mesh additions (`/healthz` gives a mesh
predictor's world as "mesh"; `server_close` closes the predictor, which
stops a mesh's worker ranks): the HTTP layer is numpy-only, but any
import from `spectrogram_cube_clustering_tpu` loads jax through that
package's `__init__`, and the JAX package is not edited to import
lazily. So the copy stays (ROADMAP.md Queue 1 item 0), pinned to the
original by `tests/test_torch_serve.py`.

- `MicroBatcher`: coalesces concurrent requests into single device passes;
  requests wait at most `max_wait_ms` for co-travelers, results are split
  back per request.
- `ServingServer` / `make_server`: a stdlib `ThreadingHTTPServer` speaking
  numpy wire formats:

      POST /predict           body = .npy bytes, shape (n, H, W[, 1])
                              -> .npz bytes {q, labels, z} (?fields=labels)
      POST /predict_waveform  body = .npy (T,) or (C, T) raw samples
                              -> .npz {q, labels, z, windows_per_channel}
      GET  /healthz           -> JSON model metadata
      GET  /stats             -> JSON counters (occupancy, latency quantiles)

- `main`: the `scc-serve-torch` console entry point. With `--mesh`, one
  process per GPU under torchrun serves data-parallel: rank 0 binds the
  port and serves, the other ranks run `serve.serve_worker`, and a rank
  that fails makes the run exit non-zero:

      torchrun --nproc_per_node=4 -m spectrogram_cube_clustering_tpu_torch.serve_http CKPT --mesh --n-clusters 5
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np


class _Pending:
    __slots__ = ("x", "event", "result", "error")

    def __init__(self, x: np.ndarray):
        self.x = x
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None

    def wait(self):
        self.event.wait()
        if self.error is not None:
            raise self.error
        return self.result


_STOP = object()


def _as_output_dict(out) -> Dict[str, np.ndarray]:
    """Normalize predictor outputs: DECPredictor returns a dict,
    AECEncoder a bare latent array."""
    return out if isinstance(out, dict) else {"z": out}


class MicroBatcher:
    """Coalesce concurrent predict requests into single device passes.

    A worker thread drains a queue: the first request opens a batch,
    which closes when either `max_wait_ms` elapses or the coalesced row
    count reaches the predictor's `max_batch` (one device chunk). The
    batch runs as ONE predictor call and the outputs are split back to
    the waiting callers by row range. Thread-safe; exceptions propagate
    to every caller in the failed batch.

    `max_wait_ms=0` disables coalescing (pure pass-through) without
    changing the calling convention.
    """

    def __init__(self, predictor, max_wait_ms: float = 2.0,
                 max_rows: Optional[int] = None):
        self._pred = predictor
        self._max_wait = max(0.0, float(max_wait_ms)) / 1e3
        self._max_rows = int(max_rows or getattr(predictor, "max_batch", 1024))
        self._queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self._lock = threading.Lock()
        self._stats = {
            "requests": 0, "windows": 0, "device_batches": 0,
            "coalesced_windows": 0, "max_coalesced": 0,
        }
        self._closed = False
        self._thread = threading.Thread(
            target=self._loop, name="scc-microbatcher", daemon=True
        )
        self._thread.start()

    # -- public API --------------------------------------------------

    def __call__(self, windows: np.ndarray) -> Dict[str, np.ndarray]:
        return self.submit(windows).wait()

    def submit(self, windows: np.ndarray) -> _Pending:
        x = np.asarray(windows)
        item = _Pending(x)
        with self._lock:
            self._stats["requests"] += 1
            self._stats["windows"] += len(x)
        if len(x) == 0:
            # nothing to coalesce; predictor calls are thread-safe
            try:
                item.result = _as_output_dict(self._pred(x))
            except BaseException as e:  # noqa: BLE001 — relay to caller
                item.error = e
            item.event.set()
            return item
        # The closed-check and enqueue must be atomic against close():
        # otherwise an item enqueued after _STOP is never drained and its
        # caller blocks forever in wait().
        with self._lock:
            if self._closed:
                item.error = RuntimeError("MicroBatcher is closed")
                item.event.set()
                return item
            self._queue.put(item)
        return item

    def stats(self) -> Dict[str, float]:
        with self._lock:
            s = dict(self._stats)
        b = s["device_batches"]
        s["mean_coalesced"] = round(s["coalesced_windows"] / b, 2) if b else 0.0
        return s

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(_STOP)
        self._thread.join(timeout=10)

    # -- worker ------------------------------------------------------

    def _loop(self) -> None:
        while True:
            first = self._queue.get()
            if first is _STOP:
                return
            batch = [first]
            rows = len(first.x)
            deadline = time.monotonic() + self._max_wait
            stop = False
            while rows < self._max_rows:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is _STOP:
                    stop = True
                    break
                batch.append(nxt)
                rows += len(nxt.x)
            self._run(batch)
            if stop:
                return

    def _run(self, batch) -> None:
        try:
            if len(batch) == 1:
                x = batch[0].x
            else:
                # Promote to the common numpy type (e.g. f16+f32 -> f32)
                # so no co-traveler is narrowed by whoever happened to
                # arrive first; the predictor casts to its own compute/
                # wire dtype afterwards either way.
                dtype = np.result_type(*[it.x.dtype for it in batch])
                x = np.concatenate(
                    [np.asarray(it.x, dtype) for it in batch]
                )
            out = _as_output_dict(self._pred(x))
            with self._lock:
                self._stats["device_batches"] += 1
                self._stats["coalesced_windows"] += len(x)
                self._stats["max_coalesced"] = max(
                    self._stats["max_coalesced"], len(x)
                )
            off = 0
            for it in batch:
                n = len(it.x)
                it.result = {k: v[off : off + n] for k, v in out.items()}
                it.event.set()
                off += n
        except BaseException as e:  # noqa: BLE001 — relay to every caller
            for it in batch:
                it.error = e
                it.event.set()


class _LatencyRing:
    """Last-N request latencies -> p50/p95 on demand (lock-protected)."""

    def __init__(self, n: int = 2048):
        self._buf = np.zeros(n, np.float64)
        self._i = 0
        self._count = 0
        self._lock = threading.Lock()

    def add(self, seconds: float) -> None:
        with self._lock:
            self._buf[self._i] = seconds
            self._i = (self._i + 1) % len(self._buf)
            self._count += 1

    def quantiles(self) -> Dict[str, Optional[float]]:
        with self._lock:
            n = min(self._count, len(self._buf))
            vals = np.sort(self._buf[:n]) if n else None
        if vals is None:
            return {"p50_ms": None, "p95_ms": None}
        return {
            "p50_ms": round(1e3 * float(vals[int(0.50 * (n - 1))]), 3),
            "p95_ms": round(1e3 * float(vals[int(0.95 * (n - 1))]), 3),
        }


class ServingServer(ThreadingHTTPServer):
    """ThreadingHTTPServer wired to a predictor through a MicroBatcher."""

    daemon_threads = True

    def __init__(self, address, predictor, max_wait_ms: float = 2.0,
                 max_request_mb: float = 256.0, waveform_frontend=None):
        self.predictor = predictor
        # serve.WaveformFrontend (or None): enables POST /predict_waveform
        # with raw (T,)/(C, T) sample payloads windowed on device. A
        # frontend built with fuse=False routes the model pass through
        # the shared MicroBatcher (waveform and window clients coalesce
        # into the same device batches); a fused frontend serves waveform
        # requests through its single-program STFT+model path instead
        # (lower latency, no cross-client coalescing)
        self.waveform_frontend = waveform_frontend
        # fused waveform requests bypass the MicroBatcher, so its
        # counters never see them; count them here for /stats
        self.fused_waveform_requests = 0
        self._fused_count_lock = threading.Lock()
        self.latency = _LatencyRing()
        self.max_request_bytes = int(max_request_mb * (1 << 20))
        self.started = time.time()
        # bind the socket BEFORE spawning the batcher worker: a bind
        # failure (port in use) must not leak a live thread pinning the
        # predictor's device memory
        super().__init__(address, _Handler)
        try:
            self.batcher = MicroBatcher(predictor, max_wait_ms=max_wait_ms)
        except Exception:
            self.server_close()
            raise

    def metadata(self) -> Dict:
        p = self.predictor
        meta = {
            "status": "ok",
            "model": type(p).__name__,
            "input_hw": list(getattr(p, "input_hw", ())),
            "max_batch": getattr(p, "max_batch", None),
            "buckets": list(getattr(p, "sizes", ())),
            "outputs": ["q", "labels", "z"]
            if hasattr(p, "model") and hasattr(p.model, "n_clusters")
            else ["z"],
        }
        n_clusters = getattr(getattr(p, "model", None), "n_clusters", None)
        if n_clusters is not None:
            meta["n_clusters"] = int(n_clusters)
        mesh = getattr(p, "mesh", None)
        if mesh is not None:
            meta["mesh"] = mesh.world  # ranks serving each request
        wf = self.waveform_frontend
        if wf is not None:
            meta["waveform"] = {
                "nperseg": wf.nperseg, "hop": wf.hop,
                "window_rows": wf.window_rows,
                # which route serves /predict_waveform: fused STFT+model
                # (--fuse-waveform) or two-pass through the MicroBatcher
                "fused": wf.fused,
            }
        return meta

    def server_close(self) -> None:
        # getattr: reachable from __init__'s except path BEFORE
        # self.batcher exists — an AttributeError here would mask the
        # original failure and leak the bound socket
        batcher = getattr(self, "batcher", None)
        if batcher is not None:
            batcher.close()
        super().server_close()
        # a mesh predictor's close stops the other ranks' worker loops
        close = getattr(self.predictor, "close", None)
        if close is not None:
            close()


class _Handler(BaseHTTPRequestHandler):
    server_version = "scc-serve-torch/0.1"
    protocol_version = "HTTP/1.1"

    # quiet by default: per-request stderr lines are not useful at
    # serving rates, and /stats carries the aggregate picture
    def log_message(self, fmt, *args):  # noqa: D102
        pass

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj) -> None:
        self._send(code, json.dumps(obj).encode(), "application/json")

    def do_GET(self) -> None:  # noqa: N802 — http.server API
        path = urlparse(self.path).path
        if path == "/healthz":
            self._send_json(200, self.server.metadata())
        elif path == "/stats":
            stats = self.server.batcher.stats()
            stats.update(self.server.latency.quantiles())
            stats["uptime_s"] = round(time.time() - self.server.started, 1)
            if self.server.waveform_frontend is not None:
                # batcher counters exclude fused-route traffic
                stats["fused_waveform_requests"] = (
                    self.server.fused_waveform_requests
                )
            self._send_json(200, stats)
        else:
            self._send_json(404, {"error": f"unknown path {path!r}"})

    def do_POST(self) -> None:  # noqa: N802 — http.server API
        url = urlparse(self.path)
        if url.path not in ("/predict", "/predict_waveform"):
            self.close_connection = True  # body left unread
            self._send_json(404, {"error": f"unknown path {url.path!r}"})
            return
        is_waveform = url.path == "/predict_waveform"
        if is_waveform and self.server.waveform_frontend is None:
            self.close_connection = True  # body left unread
            self._send_json(404, {
                "error": "waveform serving is not enabled; start the "
                "server with a WaveformFrontend (scc-serve-torch --waveform)",
            })
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            length = -1
        if length <= 0:
            # body length unknown/unread: the keep-alive connection would
            # misparse the leftover bytes as the next request line
            self.close_connection = True
            self._send_json(400, {"error": "missing/invalid Content-Length"})
            return
        if length > self.server.max_request_bytes:
            # replying without draining `length` bytes corrupts the
            # persistent connection — close it instead of reading them
            self.close_connection = True
            self._send_json(413, {
                "error": f"request of {length} bytes exceeds the "
                f"{self.server.max_request_bytes}-byte limit; chunk the "
                "payload client-side",
            })
            return
        body = self.rfile.read(length)
        try:
            x = np.load(io.BytesIO(body), allow_pickle=False)
        except Exception as e:  # noqa: BLE001 — malformed wire data
            self._send_json(400, {"error": f"body is not .npy bytes: {e}"})
            return
        if not isinstance(x, np.ndarray):
            # e.g. a .npz body (the RESPONSE format) loads as NpzFile
            self._send_json(400, {
                "error": "body must be a single .npy array "
                f"(got {type(x).__name__}; note the response is .npz, "
                "the request is .npy)",
            })
            return
        if is_waveform:
            err = self._waveform_shape_error(x)
        else:
            err = self._shape_error(x)
        if err:
            self._send_json(400, {"error": err})
            return
        if not is_waveform and x.ndim == 3:
            x = x[..., None]

        fields = None
        q = parse_qs(url.query).get("fields")
        if q:
            fields = [f for part in q for f in part.split(",") if f]
            # reject typo'd field names BEFORE paying the device pass —
            # the valid set is statically known from the predictor
            available = self.server.metadata()["outputs"]
            unknown = [f for f in fields if f not in available]
            if unknown:
                self._send_json(400, {
                    "error": f"unknown fields {unknown}; "
                    f"available: {sorted(available)}",
                })
                return

        t0 = time.monotonic()
        extra = {}
        if is_waveform and self.server.waveform_frontend.fused:
            # fused route (the default): STFT + normalize + model run on
            # the device, so raw samples cross host->device once and the
            # windows never come back. The trade: it bypasses the
            # MicroBatcher, so the model pass cannot coalesce with other
            # clients' windows.
            try:
                out = self.server.waveform_frontend(x)
            except ValueError as e:  # too-short waveform etc.
                self._send_json(400, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001 — 500, keep serving
                self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            with self.server._fused_count_lock:
                self.server.fused_waveform_requests += 1
            extra["windows_per_channel"] = out.pop("windows_per_channel")
        else:
            if is_waveform:
                wf = self.server.waveform_frontend
                try:
                    # device STFT in the handler thread; the MODEL pass
                    # below still coalesces with window clients in the
                    # MicroBatcher
                    windows = wf.windows(x)
                except ValueError as e:  # too-short waveform etc.
                    self._send_json(400, {"error": str(e)})
                    return
                except Exception as e:  # noqa: BLE001 — 500, keep serving
                    self._send_json(
                        500, {"error": f"{type(e).__name__}: {e}"}
                    )
                    return
                channels = 1 if x.ndim == 1 else x.shape[0]
                extra["windows_per_channel"] = np.full(
                    channels, wf.n_windows(x.shape[-1]), np.int64
                )
                x = windows
            try:
                out = self.server.batcher(x)
            except Exception as e:  # noqa: BLE001 — 500, keep serving
                self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
                return
        self.server.latency.add(time.monotonic() - t0)

        if fields:
            out = {k: out[k] for k in fields if k in out}
        out.update(extra)
        buf = io.BytesIO()
        np.savez(buf, **out)
        self._send(200, buf.getvalue(), "application/octet-stream")

    def _waveform_shape_error(self, x: np.ndarray) -> Optional[str]:
        if not np.issubdtype(x.dtype, np.number) or np.issubdtype(
                x.dtype, np.complexfloating):
            return f"waveform must be real-numeric; got dtype {x.dtype}"
        if x.ndim not in (1, 2):
            return (
                f"waveform must have shape (T,) or (channels, T); "
                f"got {x.shape}"
            )
        # validate length HERE so the 400 class is fully decided before
        # the frontend call — the fused route runs the STFT and the
        # whole model pass, whose internal ValueErrors must surface as
        # 500s, not masquerade as client errors
        wf = self.server.waveform_frontend
        min_t = (wf.window_rows - 1) * wf.hop + wf.nperseg
        if x.shape[-1] < min_t:
            return (
                f"waveform length {x.shape[-1]} yields no complete "
                f"({wf.window_rows}, nfreq) window (needs >= {min_t} "
                f"samples)"
            )
        return None

    def _shape_error(self, x: np.ndarray) -> Optional[str]:
        hw = tuple(getattr(self.server.predictor, "input_hw", ()))
        if not np.issubdtype(x.dtype, np.number) or np.issubdtype(
                x.dtype, np.complexfloating):
            return f"windows must be real-numeric; got dtype {x.dtype}"
        if x.ndim not in (3, 4) or (x.ndim == 4 and x.shape[-1] != 1):
            return (
                f"windows must have shape (n, H, W) or (n, H, W, 1); "
                f"got {x.shape}"
            )
        if hw and tuple(x.shape[1:3]) != hw:
            return (
                f"window geometry {tuple(x.shape[1:3])} does not match the "
                f"served model's input_hw {hw}"
            )
        return None


def make_server(
    predictor,
    host: str = "127.0.0.1",
    port: int = 0,
    max_wait_ms: float = 2.0,
    max_request_mb: float = 256.0,
    waveform_frontend=None,
) -> ServingServer:
    """A ready-to-run ServingServer (port 0 = ephemeral; the bound port is
    `server.server_address[1]`). Call `serve_forever()` (blocking) or run
    it on a thread; `server_close()` tears down the batcher too. Passing
    a `serve.WaveformFrontend` enables POST /predict_waveform (raw
    (T,)/(channels, T) sample payloads, windowed on device)."""
    return ServingServer(
        (host, port), predictor, max_wait_ms=max_wait_ms,
        max_request_mb=max_request_mb, waveform_frontend=waveform_frontend,
    )


def main(argv=None) -> int:
    """`scc-serve-torch`: serve a trained `.pt` checkpoint over HTTP."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="scc-serve-torch",
        description="HTTP serving for trained AEC/DEC checkpoints on a "
        "CUDA device (PyTorch port; cross-request micro-batching)",
    )
    ap.add_argument("checkpoint", help="a .pt state_dict in the reference "
                    "layout (reference checkpoints, or the JAX package's "
                    "export-torch-checkpoint output)")
    ap.add_argument("--model", choices=["DEC", "AEC"], default="DEC",
                    help="DEC: q/labels/z; AEC: encoder latents only")
    ap.add_argument("--n-clusters", type=int, default=None,
                    help="required for --model DEC")
    ap.add_argument("--attention-faithful",
                    action=argparse.BooleanOptionalAction, default=True,
                    help="must match the checkpoint's training config "
                    "(it changes the encoder head width)")
    ap.add_argument("--input-hw", type=int, nargs=2, default=(4, 101),
                    metavar=("H", "W"))
    ap.add_argument("--transform", default="sample_norm_cent")
    ap.add_argument("--max-batch", type=int, default=1024)
    ap.add_argument("--buckets",
                    action=argparse.BooleanOptionalAction, default=True,
                    help="pad each chunk to the smallest power-of-two size "
                    "that fits instead of to --max-batch")
    ap.add_argument("--transfer-dtype", default=None,
                    choices=["bfloat16", "float16", "int8"],
                    help="host->device wire encoding: half-width floats "
                         "or per-sample symmetric int8 (quarter bytes; "
                         "core.precision.quantize_wire)")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="micro-batching window (0 disables coalescing)")
    ap.add_argument("--max-request-mb", type=float, default=256.0,
                    help="reject request bodies above this size (413); "
                    "clients should chunk windows instead")
    ap.add_argument("--mesh", action="store_true",
                    help="serve data-parallel over every rank of a "
                    "torch.distributed group, one process per GPU under "
                    "torchrun (the model on each rank, each request batch "
                    "split over them); rank 0 serves HTTP")
    ap.add_argument("--waveform", action="store_true",
                    help="also accept raw-sample payloads on "
                    "/predict_waveform (windowed on the device; geometry "
                    "from --nperseg/--hop and --input-hw's window_rows)")
    ap.add_argument("--fuse-waveform",
                    action=argparse.BooleanOptionalAction, default=None,
                    help="serve /predict_waveform with STFT and model on "
                    "the device in one pass (the default without --mesh; "
                    "with --mesh, each rank its time shard); "
                    "--no-fuse-waveform takes the two-pass route, whose "
                    "model pass coalesces with window clients in the "
                    "MicroBatcher (the default with --mesh)")
    ap.add_argument("--nperseg", type=int, default=200,
                    help="waveform-mode STFT segment length")
    ap.add_argument("--hop", type=int, default=100,
                    help="waveform-mode STFT hop")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda when present)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8477)
    args = ap.parse_args(argv)

    from spectrogram_cube_clustering_tpu_torch import serve as _serve
    from spectrogram_cube_clustering_tpu_torch.core.device import fp32_policy

    mesh = None
    if args.mesh:
        from spectrogram_cube_clustering_tpu_torch.core.mesh import (
            initialize_distributed,
            make_data_mesh,
            pad_to_multiple,
        )

        initialize_distributed(device=args.device)
        mesh = make_data_mesh()
        rounded = pad_to_multiple(args.max_batch, mesh.world)
        if rounded != args.max_batch:
            # batch sizes must divide over the mesh; round up rather than
            # refuse at predictor construction
            if mesh.rank == 0:
                print(f"scc-serve-torch: --max-batch {args.max_batch} "
                      f"rounded up to {rounded} ({mesh.world} mesh devices)")
            args.max_batch = rounded
    fp32_policy()
    common = dict(
        max_batch=args.max_batch, transform=args.transform,
        buckets=args.buckets or None, input_hw=tuple(args.input_hw),
        attention_faithful=args.attention_faithful,
        device=args.device if mesh is None else None, mesh=mesh,
        transfer_dtype=args.transfer_dtype,
    )
    if args.model == "DEC":
        if args.n_clusters is None:
            ap.error("--model DEC requires --n-clusters")
        predictor = _serve.DECPredictor.from_checkpoint(
            args.checkpoint, n_clusters=args.n_clusters, **common
        )
    else:
        predictor = _serve.AECEncoder.from_checkpoint(args.checkpoint, **common)
    frontend = None
    if args.waveform:
        frontend = _serve.WaveformFrontend(
            predictor, nperseg=args.nperseg, hop=args.hop,
            window_rows=int(args.input_hw[0]), fuse=args.fuse_waveform,
        )
        if mesh is not None and mesh.rank == 0 and args.fuse_waveform is None:
            print("scc-serve-torch: mesh predictors serve waveforms through "
                  "the two-pass route by default (the mesh-fused route, K1 "
                  "on each rank's time shard, is --fuse-waveform or "
                  "serve.WaveformFrontend(pred, fuse=True))")
    if mesh is not None and mesh.rank != 0:
        # this rank's part of every call rank 0 makes, warm-up included,
        # until rank 0's server_close stops it; an error ends the process
        _serve.serve_worker(predictor, frontend)
        _leave()
        return 0
    if frontend is not None:
        frontend.warmup()  # builds the STFT kernel; covers the buckets too
    else:
        predictor.warmup()

    server = make_server(
        predictor, host=args.host, port=args.port,
        max_wait_ms=args.max_wait_ms, max_request_mb=args.max_request_mb,
        waveform_frontend=frontend,
    )
    if mesh is not None:
        # a failed collective (a rank gone) stops the server, and the run
        # exits non-zero below
        predictor.channel.on_failure = lambda e: threading.Thread(
            target=server.shutdown, daemon=True).start()
    host, port = server.server_address[:2]
    mesh_note = f", mesh x{mesh.world}" if mesh is not None else ""
    print(f"scc-serve-torch: {args.model} on http://{host}:{port} "
          f"({predictor.device}, max_batch={args.max_batch}, "
          f"wait={args.max_wait_ms}ms{mesh_note})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    if mesh is not None:
        if predictor.channel.error is not None:
            raise RuntimeError(
                "a rank of the serving mesh failed; the server stopped"
            ) from predictor.channel.error
        _leave()
    return 0


def _leave() -> None:
    """Leave the mesh's process group (every rank, after serving)."""
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    import sys

    sys.exit(main())
