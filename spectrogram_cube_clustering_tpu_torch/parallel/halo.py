"""Halo exchange and the time-sharded STFT (counterpart of the JAX
package's `parallel/halo.py`).

The time axis of a raw waveform is split across the ranks of a mesh: each
rank holds a shard of `T / world` samples, appends the first
`nperseg - hop` samples of its right neighbour's shard (the halo), and
computes the frames that start in its shard. Frame starts are
hop-aligned, so the ranks' frames, concatenated, are the spectrogram of
the whole waveform.

Each rank's frames come from K1, the hand-written STFT kernel
(`ops.cuda_stft.spectrogram`, `csrc/stft.cu`) on a card, or its plain
version on the CPU. The halo travels through the mesh's gather
(`core.mesh.DataMesh.gather`), not a send/recv ring, which gloo cannot
do on CUDA tensors.
"""

from __future__ import annotations

import torch

from spectrogram_cube_clustering_tpu_torch.core.mesh import DataMesh
from spectrogram_cube_clustering_tpu_torch.ops.cuda_stft import spectrogram
from spectrogram_cube_clustering_tpu_torch.train.layout import fetch_global


def halo_exchange_1d(x: torch.Tensor, halo: int, mesh: DataMesh,
                     axis: int = 0) -> torch.Tensor:
    """`x` with the first `halo` entries of the right neighbour's shard
    appended along `axis`; the last rank appends zeros (its frames that
    reach past the end are dropped by the caller, as the single-device
    STFT drops a trailing partial frame). Every rank's shard must have
    the same shape."""
    head = x.narrow(axis, 0, halo).contiguous()
    heads = mesh.gather(head)
    recv = (heads[mesh.rank + 1] if mesh.rank + 1 < mesh.world
            else torch.zeros_like(head))
    return torch.cat([x, recv], dim=axis)


def sharded_spectrogram(
    x: torch.Tensor,
    mesh: DataMesh,
    nperseg: int = 200,
    hop: int = 100,
    log: bool = True,
    eps: float = 1e-12,
) -> torch.Tensor:
    """Log-power spectrogram of a waveform split in time over the mesh.

    `x` (..., T / world) is this rank's shard of a (..., T) waveform, the
    shards in rank order and of equal length; any leading dims are
    channels. Each rank computes the frames that start in its shard, and
    every rank returns all (..., (T - nperseg) // hop + 1, nperseg//2 + 1)
    float32 frames, the spectrogram of the whole waveform (the JAX
    function's global output). T must be a multiple of world * hop, a
    shard at least the halo `nperseg - hop` long, and nperseg a multiple
    of hop (the JAX package's checks)."""
    local_t = x.shape[-1]
    t = local_t * mesh.world
    if local_t % hop:
        raise ValueError(
            f"time length {t} must be a multiple of mesh*hop = "
            f"{mesh.world * hop}")
    halo = nperseg - hop
    if halo > local_t:
        raise ValueError(
            f"halo nperseg - hop = {halo} exceeds the per-device shard "
            f"length {local_t}; use fewer devices or a longer signal "
            f"(need T >= mesh * (nperseg - hop))")
    if nperseg % hop:
        raise ValueError(
            f"the STFT kernel's sharded route needs nperseg % hop == 0, "
            f"got nperseg={nperseg}, hop={hop}")
    xs = halo_exchange_1d(x.to(mesh.device, torch.float32), halo, mesh,
                          axis=x.dim() - 1)
    out = spectrogram(xs, nperseg=nperseg, hop=hop, log=log, eps=eps)
    # the last rank's frames past the end run over the zero halo
    n_frames = (t - nperseg) // hop + 1
    return fetch_global(out, mesh, axis=out.dim() - 2)[..., :n_frames, :]
