"""Serving: online inference over trained models, in PyTorch.

Counterpart of the JAX package's `serve.py`. A predictor holds one model on
one device; requests of any size run in chunks of at most `max_batch`
windows, each zero-padded to the smallest bucket that fits (`buckets=True`
gives a power-of-two ladder), so device memory stays bounded and the model
sees a few fixed shapes. Soft assignments, labels and latents come from
one device pass per chunk; the decoder is not run.

    predictor = serve.DECPredictor.from_checkpoint("DEC.pt", n_clusters=5)
    out = predictor(windows)            # dict with q, labels, z (numpy)
    frontend = serve.WaveformFrontend(predictor)
    out = frontend(waveform)            # raw (T,) or (C, T) samples

`transfer_dtype` ('bfloat16' | 'float16' | 'int8', `core.precision`) sets
the wire a request crosses to the device in: the windows (or, on the fused
waveform route, each chunk's raw samples, one int8 scale per channel) are
encoded on the host and restored to float32 on the device before the
normalizer, so the only effect is input quantization.

`arch` is "AEC" (the parity model) or "packed" (models/packed.py, the
(4, 101) geometry only), for both predictors, their `from_checkpoint` and
so for the waveform frontend.

Mesh serving (`mesh=`, a `core.mesh.DataMesh`): every rank of the group
holds the model, and rank 0 serves. Each chunk's bucket size is a
multiple of the world; rank 0 broadcasts the wire-encoded chunk after a
request header (`core.mesh.RequestChannel`), each rank runs the model on
its `DataMesh.block` of it, and the outputs are gathered. The other ranks
run `serve_worker(predictor, frontend)`, which does their part of every
call rank 0 makes until rank 0's `close()` (which `serve_http`'s
`server_close` calls) stops it:

    mesh = core.make_data_mesh()       # after core.initialize_distributed()
    predictor = serve.DECPredictor.from_checkpoint(path, 5, mesh=mesh)
    frontend = serve.WaveformFrontend(predictor, fuse=True)
    if mesh.rank == 0:
        out = frontend(waveform)       # ... and predictor(windows)
        predictor.close()
    else:
        serve.serve_worker(predictor, frontend)
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from spectrogram_cube_clustering_tpu_torch.core.device import (
    fp32_policy,
    resolve_device,
)
from spectrogram_cube_clustering_tpu_torch.core.mesh import (
    Header,
    RequestChannel,
    pad_to_multiple,
)
from spectrogram_cube_clustering_tpu_torch.core.precision import (
    dequant_wire,
    quantize_wire,
    wire_dtype,
    wire_to,
)
from spectrogram_cube_clustering_tpu_torch.models.build import build_model
from spectrogram_cube_clustering_tpu_torch.ops.normalize import make_normalizer
from spectrogram_cube_clustering_tpu_torch.signal.stft import (
    spectrogram_windows,
)
from spectrogram_cube_clustering_tpu_torch.train.checkpoint import (
    check_restored_shapes,
)
from spectrogram_cube_clustering_tpu_torch.utils.weights import (
    load_state_dict_file,
)


#: the request header's ops on a serving mesh (after the channel's own
#: BEAT and STOP) and kinds
OP_WINDOWS, OP_WAVEFORM = 2, 3
KIND_DEC, KIND_AEC = 1, 2
#: the header's wire codes: float32, then the `core.precision` wires
_WIRES = (None, torch.bfloat16, torch.float16, torch.int8)


def _build_model(kind: str, arch: str, input_hw, attention_faithful: bool,
                 n_clusters: Optional[int] = None):
    """The served model of `kind` ('DEC' or 'AEC') and `arch` ('AEC' or
    'packed'), float32 on the CPU, from `models.build_model`."""
    if arch not in ("AEC", "packed"):
        raise ValueError(f"unknown arch {arch!r} ('AEC' or 'packed')")
    return build_model(kind, arch, input_hw, attention_faithful, n_clusters)


def _loaded(model, state_dict, what: str):
    """`model` with `state_dict` loaded; a checkpoint of another arch or
    geometry raises ValueError naming what differs."""
    check_restored_shapes(state_dict, model.state_dict(), what)
    model.load_state_dict(state_dict)
    return model


def _pad_to(x: torch.Tensor, batch: int) -> torch.Tensor:
    n = len(x)
    if n > batch:
        raise ValueError(f"request of {n} windows exceeds max_batch {batch}")
    if n < batch:
        x = torch.cat([x, x.new_zeros((batch - n, *x.shape[1:]))])
    return x


def _bucket_ladder(max_batch: int, buckets, multiple: int = 1) -> tuple:
    """Sorted chunk sizes. `buckets=True` -> powers of two up to max_batch;
    a sequence -> those sizes plus max_batch; None -> (max_batch,). With
    `multiple` > 1 (a mesh's world) every size is rounded up to a multiple
    of it, so each chunk splits evenly over the ranks."""
    if max_batch % multiple:
        raise ValueError(
            f"max_batch {max_batch} must be a multiple of the mesh "
            f"device count {multiple}"
        )
    if buckets is True:
        sizes, b = [], multiple
        while b < max_batch:
            sizes.append(b)
            b *= 2
        sizes.append(max_batch)
        return tuple(sizes)
    if buckets:
        sizes = sorted(set(pad_to_multiple(int(b), multiple)
                           for b in buckets) | {max_batch})
        if sizes[-1] > max_batch:
            raise ValueError(
                f"bucket {sizes[-1]} exceeds max_batch {max_batch}"
            )
        return tuple(sizes)
    return (max_batch,)


def _bcast_wire(mesh, enc, header: Header):
    """The wire-encoded payload of `header` on every rank's device: rank 0
    passes its host encoding `enc` (a tensor, or the int8 wire's
    {"q", "scale"}), the others None. One broadcast of the payload's bytes
    (the int8 codes and their per-sample scales in one buffer)."""
    wire = _WIRES[header.wire]
    shape = header.shape
    dtype = torch.float32 if wire is None else wire
    n = int(np.prod(shape)) * dtype.itemsize
    scale_shape = (shape[0],) + (1,) * (len(shape) - 1)
    total = n + (4 * shape[0] if wire == torch.int8 else 0)
    if enc is None:
        buf = torch.empty(total, dtype=torch.uint8, device=mesh.device)
    else:
        parts = ([enc["q"], enc["scale"]] if isinstance(enc, dict)
                 else [enc])
        buf = torch.cat([p.contiguous().reshape(-1).view(torch.uint8)
                         for p in parts]).to(mesh.device)
    mesh.broadcast_(buf)
    data = buf[:n].view(dtype).reshape(shape)
    if wire != torch.int8:
        return data
    return {"q": data,
            "scale": buf[n:].view(torch.float32).reshape(scale_shape)}


def _wire_code(wire) -> int:
    return _WIRES.index(wire)


def _run_chunked(fn, x: torch.Tensor, sizes: tuple) -> tuple:
    """Run `fn` (a batch -> tuple of per-row outputs) over a request of ANY
    length: chunks of the largest size, each padded to the smallest size
    that fits; returns the outputs concatenated, padding rows dropped."""
    if len(x) == 0:
        # one all-pad pass so callers still get correctly shaped outputs
        return tuple(o[:0] for o in fn(_pad_to(x, sizes[0])))
    parts = []
    for i in range(0, len(x), sizes[-1]):
        chunk = x[i : i + sizes[-1]]
        size = next(s for s in sizes if s >= len(chunk))
        outs = fn(_pad_to(chunk, size))
        parts.append(tuple(o[: len(chunk)] for o in outs))
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat(p) for p in zip(*parts))


class _Predictor:
    """Shared plumbing: device, bucket ladder, host <-> device, and on a
    mesh the request channel. On a CUDA device it turns TF32 off
    process-wide (`core.fp32_policy`), as the float32 reference
    requires."""

    def __init__(self, model, max_batch, transform, buckets, device,
                 transfer_dtype=None, mesh=None, kind=KIND_DEC):
        # "float32" is the full-width wire, as None
        self._wire_dtype = wire_dtype(
            None if transfer_dtype == "float32" else transfer_dtype)
        self.max_batch = int(max_batch)
        self.sizes = _bucket_ladder(self.max_batch, buckets,
                                    1 if mesh is None else mesh.world)
        if mesh is not None:
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(
                    f"device {device} is not the mesh's device {mesh.device}")
            device = mesh.device
        self.mesh = mesh
        self.channel = None if mesh is None else RequestChannel(mesh)
        self._kind = kind
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            fp32_policy()
        self.model = model.to(self.device).eval()
        self.input_hw = model.input_hw
        self._normalize = make_normalizer(transform)

    def predict_tensor(self, x: torch.Tensor) -> tuple:
        """Windows (n, H, W, 1) on the device -> this predictor's outputs
        on the device, in `sizes` chunks (on a mesh: this rank's alone,
        in chunks of a rank's share of each size)."""
        sizes = self.sizes if self.mesh is None else tuple(
            s // self.mesh.world for s in self.sizes)
        with torch.inference_mode():
            return _run_chunked(self._fn, x, sizes)

    def _host_call(self, windows: np.ndarray) -> tuple:
        """Host windows -> host outputs, across the wire (encoded on the
        host, restored to float32 on the device)."""
        x = np.asarray(windows, np.float32)
        if self.mesh is not None:
            outs = _run_chunked(self._mesh_call, torch.from_numpy(x),
                                self.sizes)
            return tuple(o.numpy() for o in outs)
        enc = quantize_wire(x, self._wire_dtype)
        x = dequant_wire(wire_to(enc, self.device))
        return tuple(o.cpu().numpy() for o in self.predict_tensor(x))

    def _mesh_call(self, xb: torch.Tensor) -> tuple:
        """Rank 0: one padded chunk (a CPU tensor) over the mesh -> the
        outputs as CPU tensors."""
        enc = quantize_wire(xb.numpy(), self._wire_dtype)
        header = Header(OP_WINDOWS, self._kind,
                        _wire_code(self._wire_dtype), tuple(xb.shape))
        with self.channel.call(header):
            return tuple(o.cpu() for o in self._mesh_part(header, enc))

    def _mesh_part(self, header: Header, enc=None) -> tuple:
        """Every rank's part of a window call: the payload (rank 0's `enc`)
        broadcast, the model on this rank's block of it, the outputs
        gathered whole on every rank."""
        x = _bcast_wire(self.mesh, enc, header)
        lo, hi = self.mesh.block(header.shape[0])
        if isinstance(x, dict):
            x = {k: v[lo:hi] for k, v in x.items()}
        else:
            x = x[lo:hi]
        with torch.inference_mode():
            outs = self._fn(dequant_wire(x))
            return tuple(self.mesh.gather(o).reshape(-1, *o.shape[1:])
                         for o in outs)

    def warmup(self) -> None:
        """Run every bucket once (cuDNN and allocator set-up) before
        traffic; on a mesh, through the mesh from rank 0."""
        for size in self.sizes:
            if self.mesh is not None:
                self._host_call(np.zeros((size, *self.input_hw, 1),
                                         np.float32))
                continue
            self.predict_tensor(
                torch.zeros((size, *self.input_hw, 1), device=self.device)
            )

    def close(self) -> None:
        """On a mesh, stop the other ranks' `serve_worker` (rank 0; the
        predictor takes no call after it). Nothing without a mesh."""
        if self.channel is not None:
            self.channel.close()


class DECPredictor(_Predictor):
    """DEC inference: windows (n, H, W, 1) -> q (n, K), labels (n,) int32,
    z (n, 9). `transform` normalizes each window on the device."""

    def __init__(
        self,
        state_dict,
        n_clusters: int,
        max_batch: int = 1024,
        transform: Optional[str] = "sample_norm_cent",
        buckets=None,
        arch: str = "AEC",
        input_hw=(4, 101),
        transfer_dtype: Optional[str] = None,
        mesh=None,
        attention_faithful: bool = True,
        device=None,
    ):
        model = _loaded(_build_model("DEC", arch, input_hw,
                                     attention_faithful, n_clusters),
                        state_dict, f"{arch} DEC")
        super().__init__(model, max_batch, transform, buckets, device,
                         transfer_dtype, mesh, KIND_DEC)

    @classmethod
    def from_checkpoint(cls, path: str, n_clusters: int, **kw) -> "DECPredictor":
        """A `.pt` state_dict (reference layout) -> predictor; keyword
        arguments as for the constructor."""
        return cls(load_state_dict_file(path), n_clusters, **kw)

    def _fn(self, x: torch.Tensor) -> tuple:
        z = self.model.encode(self._normalize(x))
        q = self.model.soft_assign(z)
        return q, torch.argmax(q, dim=1).to(torch.int32), z

    def __call__(self, windows: np.ndarray) -> Dict[str, np.ndarray]:
        q, labels, z = self._host_call(windows)
        return {"q": q, "labels": labels, "z": z}


class AECEncoder(_Predictor):
    """Encoder inference: windows (n, H, W, 1) -> latents (n, 9), of an
    AEC or packed AEC checkpoint (or a DEC's, whose centroids it drops)."""

    def __init__(
        self,
        state_dict,
        max_batch: int = 1024,
        transform: Optional[str] = "sample_norm_cent",
        buckets=None,
        input_hw=(4, 101),
        transfer_dtype: Optional[str] = None,
        mesh=None,
        arch: str = "AEC",
        attention_faithful: bool = True,
        device=None,
    ):
        # a DEC checkpoint serves its encoder too: the centroids are unused
        model = _loaded(
            _build_model("AEC", arch, input_hw, attention_faithful),
            {k: v for k, v in state_dict.items() if k != "clustering.weights"},
            f"{arch} AEC")
        super().__init__(model, max_batch, transform, buckets, device,
                         transfer_dtype, mesh, KIND_AEC)

    @classmethod
    def from_checkpoint(cls, path: str, **kw) -> "AECEncoder":
        return cls(load_state_dict_file(path), **kw)

    def _fn(self, x: torch.Tensor) -> tuple:
        return (self.model.encode(self._normalize(x)),)

    def __call__(self, windows: np.ndarray) -> np.ndarray:
        return self._host_call(windows)[0]


class WaveformFrontend:
    """Raw waveform -> windows front stage for a serving predictor.

    Requests are `(T,)` or `(channels, T)` samples. Each kernel launch
    covers every channel over one time chunk of `chunk_samples` (rounded up
    to whole windows) plus the `nperseg - hop` halo, so no frame straddles
    two chunks and window i of channel c holds the same frames as in the
    JAX frontend; only the last chunk is shorter. Device memory per launch
    is bounded by channels x chunk_samples.

    With `fuse=None` (auto) a bare single-device predictor takes the
    FUSED route: STFT, normalization and model run on the device and the
    windows never leave it; the raw samples cross in the predictor's
    `transfer_dtype`, each chunk's segment encoded on the host (int8: one
    scale per channel and segment, as the JAX frontend's rank-1
    segments). A predictor without `predict_tensor` (a `MicroBatcher`),
    a mesh predictor, or `fuse=False`, takes the two-pass route:
    `windows()` brings the windows to the host (on a mesh: K1 on rank
    0's card) and the predictor (or batcher) takes them from there.

    `fuse=True` on a mesh predictor builds the mesh-fused route: rank 0
    broadcasts each chunk's wire-encoded samples after a request header,
    every rank restores float32, zero-pads the time axis to world x
    `per` windows plus the `nperseg - hop` halo (`per` = the chunk's
    windows over the world, rounded up), and runs K1 and the model on its
    time shard of `per` whole windows of every channel (its samples plus
    the halo, cut from the broadcast segment, so no halo exchange runs).
    Only the outputs are gathered; the windows never leave the ranks.
    """

    def __init__(
        self,
        predictor,
        nperseg: int = 200,
        hop: int = 100,
        window_rows: int = 4,
        chunk_samples: int = 1 << 20,
        input_hw=None,
        fuse: Optional[bool] = None,
        device=None,
    ):
        if nperseg % hop or nperseg < hop:
            raise ValueError(
                f"waveform serving requires nperseg % hop == 0 "
                f"(got {nperseg}/{hop})"
            )
        self.predictor = predictor
        self.nperseg, self.hop = int(nperseg), int(hop)
        self.window_rows = int(window_rows)
        self._span = self.window_rows * self.hop
        self.chunk = max(-(-int(chunk_samples) // self._span), 1) * self._span
        self._win_per_chunk = self.chunk // self._span
        nfreq = self.nperseg // 2 + 1
        hw = tuple(input_hw) if input_hw is not None else tuple(
            getattr(predictor, "input_hw", (self.window_rows, nfreq))
        )
        if hw != (self.window_rows, nfreq):
            raise ValueError(
                f"STFT geometry produces ({self.window_rows}, {nfreq}) "
                f"windows but the served model expects input_hw {hw}"
            )
        self.device = resolve_device(
            device if device is not None else getattr(predictor, "device", None)
        )
        self.mesh = getattr(predictor, "mesh", None)
        if fuse is None:
            fuse = hasattr(predictor, "predict_tensor") and self.mesh is None
        if fuse and not hasattr(predictor, "predict_tensor"):
            raise ValueError(
                f"fuse=True needs a predictor with predict_tensor, got "
                f"{type(predictor).__name__}"
            )
        self.fused = bool(fuse)
        self._fused_wire = getattr(predictor, "_wire_dtype", None)

    def n_windows(self, t: int) -> int:
        """Windows one channel of length-t samples yields."""
        n_frames = (t - self.nperseg) // self.hop + 1
        return max(n_frames, 0) // self.window_rows

    def _as_channels(self, wave) -> np.ndarray:
        w = np.asarray(wave, np.float32)
        if w.ndim not in (1, 2):
            raise ValueError(
                f"waveform must be (T,) or (channels, T); got {w.shape}"
            )
        w = w[None] if w.ndim == 1 else w
        if self.n_windows(w.shape[1]) < 1:
            raise ValueError(
                f"waveform length {w.shape[1]} yields no complete "
                f"({self.window_rows}, nfreq) window (needs >= "
                f"{(self.window_rows - 1) * self.hop + self.nperseg} samples)"
            )
        return w

    def _per_chunk(self, w: np.ndarray, fn, wire=None) -> tuple:
        """fn(channel-major windows of one time chunk) -> per-window outputs,
        reassembled channel-major over the whole request. With a `wire`
        dtype each chunk's samples cross encoded and are restored to
        float32 on the device; without, the request crosses once."""
        channels, n_win = w.shape[0], self.n_windows(w.shape[1])
        if wire is None:
            x = torch.from_numpy(np.ascontiguousarray(w)).to(self.device)
        seg_len = self.chunk + self.nperseg - self.hop
        parts = []
        for c in range(-(-n_win // self._win_per_chunk)):
            span = slice(c * self.chunk, c * self.chunk + seg_len)
            seg = x[:, span] if wire is None else dequant_wire(wire_to(
                quantize_wire(w[:, span], wire), self.device))
            windows = spectrogram_windows(
                seg, nperseg=self.nperseg, hop=self.hop,
                window_rows=self.window_rows, transform=None,
            )
            parts.append(
                tuple(o.reshape(channels, -1, *o.shape[1:]) for o in fn(windows))
            )
        return tuple(
            torch.cat(p, dim=1).reshape(channels * n_win, *p[0].shape[2:])
            for p in zip(*parts)
        )

    def _mesh_fused(self, w: np.ndarray) -> tuple:
        """Rank 0's mesh-fused route: each time chunk's (C, L) segment over
        the mesh -> the host outputs, channel-major over the request."""
        channels, n_win = w.shape[0], self.n_windows(w.shape[1])
        seg_len = self.chunk + self.nperseg - self.hop
        code = _wire_code(self._fused_wire)
        parts = []
        for c in range(-(-n_win // self._win_per_chunk)):
            seg = np.ascontiguousarray(
                w[:, c * self.chunk : c * self.chunk + seg_len])
            enc = quantize_wire(seg, self._fused_wire)
            header = Header(OP_WAVEFORM, self.predictor._kind, code,
                            seg.shape)
            with self.predictor.channel.call(header):
                outs = self._mesh_part(header, enc)
                parts.append(tuple(o.cpu().numpy() for o in outs))
        return tuple(
            np.concatenate(p, axis=1).reshape(channels * n_win,
                                              *p[0].shape[2:])
            for p in zip(*parts)
        )

    def _mesh_part(self, header: Header, enc=None) -> tuple:
        """Every rank's part of a mesh-fused chunk: the segment (rank 0's
        `enc`) broadcast and restored to float32, then zero-padded; K1 and
        the model on this rank's `per` windows of every channel; the
        outputs gathered whole, as (C, chunk windows, ...)."""
        mesh = self.mesh
        seg = dequant_wire(_bcast_wire(mesh, enc, header))
        channels, length = header.shape
        n_win = self.n_windows(length)
        per = -(-n_win // mesh.world)
        halo = self.nperseg - self.hop
        seg = torch.nn.functional.pad(
            seg, (0, mesh.world * per * self._span + halo - length))
        lo = mesh.rank * per * self._span
        with torch.inference_mode():
            windows = spectrogram_windows(
                seg[:, lo : lo + per * self._span + halo],
                nperseg=self.nperseg, hop=self.hop,
                window_rows=self.window_rows, transform=None,
            )
            outs = self.predictor.predict_tensor(windows)
            return tuple(
                mesh.gather(o.reshape(channels, per, *o.shape[1:]))
                .transpose(0, 1).reshape(channels, mesh.world * per,
                                         *o.shape[1:])[:, :n_win]
                for o in outs
            )

    def windows(self, wave) -> np.ndarray:
        """(T,) | (C, T) -> (total_windows, window_rows, nfreq, 1) float32
        on the host, channel-major like `spectrogram_windows`."""
        with torch.inference_mode():
            (out,) = self._per_chunk(self._as_channels(wave), lambda w: (w,))
        return out.cpu().numpy()

    def warmup(self) -> None:
        """Build the STFT kernel and run one window through the whole path
        (and the predictor's buckets) before traffic."""
        self(np.zeros(self.nperseg + (self.window_rows - 1) * self.hop,
                      np.float32))
        if hasattr(self.predictor, "warmup"):
            self.predictor.warmup()

    def __call__(self, wave) -> Dict[str, np.ndarray]:
        """Predictor outputs over the waveform's windows, plus
        `windows_per_channel` (window i of channel c starts at sample
        i * window_rows * hop)."""
        w = self._as_channels(wave)
        if self.fused:
            outs = self._mesh_fused(w) if self.mesh is not None else [
                o.cpu().numpy()
                for o in self._per_chunk(w, self.predictor.predict_tensor,
                                         self._fused_wire)]
            keys = ("q", "labels", "z") if len(outs) == 3 else ("z",)
            out = dict(zip(keys, outs))
        else:
            out = self.predictor(self.windows(w))
            if not isinstance(out, dict):
                out = {"z": out}  # AECEncoder returns the latent array
        out["windows_per_channel"] = np.full(
            len(w), self.n_windows(w.shape[1]), np.int64
        )
        return out


def serve_worker(predictor, frontend: Optional[WaveformFrontend] = None
                 ) -> None:
    """Ranks >= 1 of a serving mesh: run this rank's part of every call
    rank 0 makes on `predictor` (window requests) and on `frontend`'s
    mesh-fused route, until rank 0 closes the predictor. Build both as
    rank 0 does; heartbeats are skipped. Raises for a request this rank
    cannot run (another model kind, a fused waveform without a fused
    `frontend`), which ends the process and so fails the mesh."""
    channel = predictor.channel
    if channel is None or predictor.mesh.rank == 0:
        raise ValueError("serve_worker runs on ranks >= 1 of a mesh "
                         "predictor")
    while True:
        header = channel.recv()
        if header.op == RequestChannel.STOP:
            return
        if header.kind != predictor._kind:
            raise RuntimeError(
                f"rank {predictor.mesh.rank}: a request for model kind "
                f"{header.kind}, this rank serves {predictor._kind}")
        if header.op == OP_WINDOWS:
            predictor._mesh_part(header)
        elif (header.op == OP_WAVEFORM and frontend is not None
              and frontend.fused):
            frontend._mesh_part(header)
        else:
            raise RuntimeError(
                f"rank {predictor.mesh.rank}: no handler for request op "
                f"{header.op}")
