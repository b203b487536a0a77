"""The synthetic RIS event catalog of `chip_smoke.py`'s `build_h5_catalog`.

Each event is a raw (88, 101) spectrogram row of the reference's HDF5
catalog: N(0, 0.1) noise, one of five planted frequency bands (rows 4 + 16k
to 18 + 16k) of amplitude 3 + N(0, 0.2), the time vector in row 87 and the
frequency vector in column 0, which the catalog's crop drops. What
`convert_h5_to_np` writes from them, the cropped (87, 100) window
normalised by `vec_norm`, is the catalog cells' input (`catalog_dump`).

`chip_smoke.py` draws the noise with numpy and writes the dump to disk;
here the draws come from a `torch.Generator` on the card, block by block,
and nothing is written. `planted_events` keeps the construction apart
from the draws, so a test can feed it numpy's draws and hold it bit-equal
to the original.
"""

from __future__ import annotations

import torch

CLASSES = 5
RAW = (88, 101)
BLOCK = 4096


def band_rows(dtype=torch.float64, device=None) -> torch.Tensor:
    """(CLASSES, 88, 1): class k's band, ones on rows 4 + 16k .. 17 + 16k."""
    bands = torch.zeros((CLASSES, RAW[0], 1), dtype=dtype, device=device)
    for k in range(CLASSES):
        bands[k, 4 + 16 * k:18 + 16 * k] = 1.0
    return bands


def planted_events(noise: torch.Tensor, amp: torch.Tensor,
                   truth: torch.Tensor) -> torch.Tensor:
    """Raw events (n, 88, 101) float64 from their draws: `noise` (n, 88,
    101) of N(0, 0.1), `amp` (n, 1, 1) of 3 + N(0, 0.2), `truth` (n,) the
    classes."""
    raw = noise.clone()
    raw[:, :, 1:] += band_rows(raw.dtype, raw.device)[truth] * amp
    raw[:, 87, 1:] = torch.arange(100, dtype=raw.dtype, device=raw.device)
    # numpy's linspace(0, 10, 87): i * (10 / 86), the last element exact
    times = torch.arange(87, dtype=raw.dtype, device=raw.device) * (10 / 86)
    times[-1] = 10.0
    raw[:, 0:87, 0] = times
    return raw


def crop_vec_norm(raw: torch.Tensor) -> torch.Tensor:
    """The catalog conversion: float32, the crop X[:-1, 1:], then vec_norm
    over each window (utils.py:213-236)."""
    x = raw.to(torch.float32)[..., :-1, 1:]
    return x / (torch.sqrt((x * x).sum(dim=(-2, -1), keepdim=True)) + 1e-8)


def catalog_dump(n: int, gen: torch.Generator, device) -> tuple:
    """(windows (n, 87, 100, 1) float32, classes (n,)) of `n` events drawn
    from `gen` on `device`, BLOCK events at a time; class i % 5."""
    truth = torch.arange(n, device=device) % CLASSES
    out = torch.empty((n, RAW[0] - 1, RAW[1] - 1, 1), dtype=torch.float32,
                      device=device)
    for lo in range(0, n, BLOCK):
        hi = min(lo + BLOCK, n)
        noise = 0.1 * torch.randn((hi - lo, *RAW), generator=gen,
                                  device=device, dtype=torch.float64)
        amp = 3.0 + 0.2 * torch.randn((hi - lo, 1, 1), generator=gen,
                                      device=device, dtype=torch.float64)
        out[lo:hi, ..., 0] = crop_vec_norm(
            planted_events(noise, amp, truth[lo:hi]))
    return out, truth
