"""The serving cells' request mix: which waveform each client sends next.

A mix is a list of classes, each {"shape": [T] or [C, T], "per_cycle": n,
"pool": p}. Every client sends cycles of sum(per_cycle) requests holding
exactly `per_cycle` of each class, in an order drawn anew each cycle from
(seed, client), so every seed offers the same work in another order. A
class's requests go round its pool of `p` payloads, each a
`synthetic_waveform` drawn from (seed, class, payload); the clients and
the reference make the same payload from the same three numbers.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np
import torch

from portbench.traffic.waveform import synthetic_waveform


def schedule(seed: int, client: int, mix: List[dict]
             ) -> Iterator[Tuple[int, int]]:
    """(class, payload) of the client's requests, in order, endlessly."""
    cycle = [c for c, m in enumerate(mix) for _ in range(m["per_cycle"])]
    rng = np.random.default_rng([seed, client])
    sent = [0] * len(mix)
    while True:
        for c in rng.permutation(cycle):
            c = int(c)
            yield c, (sent[c] + client) % mix[c]["pool"]
            sent[c] += 1


def payload_seed(seed: int, cls: int, j: int) -> int:
    return int(np.random.SeedSequence([seed, cls, j])
               .generate_state(1, np.uint64)[0] >> 1)


def payload(seed: int, cls: int, j: int, mix: List[dict],
            amplitude=None) -> np.ndarray:
    """The float32 samples of payload j of class `cls`, made on the host."""
    shape = list(mix[cls]["shape"])
    gen = torch.Generator().manual_seed(payload_seed(seed, cls, j))
    wave = synthetic_waveform((1 if len(shape) == 1 else shape[0],
                               shape[-1]), gen, "cpu", amplitude=amplitude)
    return wave.reshape(shape).numpy()
