"""Synthetic DAS waveforms: a copy of `chip_smoke.py`'s `synthetic_waveform`.

Five kinds of 400-sample stretches (one (4, 101) window each at nperseg
200, hop 100): a tone at a kind-specific frequency over unit noise. Made
with a `torch.Generator` on the generator's device, so the training cells
make their (16, 2^20) waveform on the card and the serving clients make
theirs on the host.
"""

from __future__ import annotations

import numpy as np
import torch


def synthetic_waveform(shape, gen, device, kinds=None,
                       amplitude=None) -> torch.Tensor:
    """Five kinds of 400-sample stretches (one DEC window each): a tone
    at a kind-specific frequency over unit noise, of amplitude
    10^(kind/2) or, when given, `amplitude` for every kind. `kinds`
    (channels, stretches) picks them; random by default."""
    c, t = shape
    if kinds is None:
        kinds = torch.randint(0, 5, (c, -(-t // 400)), generator=gen,
                              device=device)
    kind = kinds.repeat_interleave(400, dim=1)[:, :t]
    n = torch.arange(t, device=device, dtype=torch.float32)
    freq = 0.03 + 0.09 * kind.to(torch.float32)
    amp = (10.0 ** (kind.to(torch.float32) / 2.0) if amplitude is None
           else amplitude)
    noise = torch.randn((c, t), generator=gen, device=device)
    return amp * torch.sin(2 * np.pi * freq * n) + noise


def training_waveform(shape, gen, device, amplitude=10.0) -> torch.Tensor:
    """The training cells' waveform, drawn as `chip_smoke.py` phase 4b
    draws it: the kinds first, then the samples, one amplitude for every
    kind (a window's last frame reaches into the next stretch, and a
    louder neighbour would decide the window once it is normalised)."""
    c, t = shape
    kinds = torch.randint(0, 5, (c, -(-t // 400)), generator=gen,
                          device=device)
    return synthetic_waveform(shape, gen, device, kinds=kinds,
                              amplitude=amplitude)
