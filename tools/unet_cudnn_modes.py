"""Which cuDNN setting puts one UNet epoch on the card far from the CPU.

`chip_smoke.py` phase 4h holds one UNet epoch (batch 64, lr 1e-3, from
seeded weights) on the card against the same epoch on the CPU. With the
card's default cuDNN algorithms the training loss lands in two groups
from the CPU's, and a gate between them flakes. This script runs the
epoch on the CPU once and on the card under each setting several times
in one process, each card run with a fresh model from the same weights:

- `default`: `cudnn.benchmark = False`, `cudnn.deterministic = False`;
- `benchmark`: `cudnn.benchmark = True` (cuDNN times its algorithms);
- `deterministic`: `cudnn.deterministic = True`.

For each run it prints the [train, validation] losses' relative gaps to
the CPU and the set of CUDA kernels the first training step launched
(torch.profiler), and groups the runs by that set, so a group of losses
can be matched to the kernels that produced it.

    python3 tools/unet_cudnn_modes.py [--windows 2048] [--runs 6]

Runs on an NVIDIA GPU only; prints the card's name and power limit
first and one JSON object last.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def first_step_kernels(model, x: torch.Tensor) -> list:
    """Sorted names of the CUDA kernels one forward and backward of the
    UNet's MSE on x launch (torch.profiler's device events)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        x_rec, _ = model(x)
        torch.mean((x_rec - x) ** 2).backward()
        torch.cuda.synchronize()
    model.zero_grad(set_to_none=True)
    return sorted({e.key for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def epoch(sd: dict, x: torch.Tensor, dev) -> list:
    """[train, validation] losses of one UNet epoch from `sd` on `dev`,
    windows x split 3:1 (the 4h gate's run)."""
    from spectrogram_cube_clustering_tpu_torch import models, train

    split = len(x) * 3 // 4
    model = models.UNet(device=dev)
    model.load_state_dict(sd)
    val = train.make_batched_data(x[split:].to(dev), 64)
    out = train.train_aec(
        model, train.create_train_state(model, 1e-3),
        train.make_batched_data(x[:split].to(dev), 64), val,
        train.AECConfig(n_epochs=1))
    return out["history"]["train"] + out["history"]["validation"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=2048)
    ap.add_argument("--runs", type=int, default=6,
                    help="card runs per setting")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="unet_cudnn_modes.json",
                    help="where the whole result, kernel names included, "
                    "is written")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("unet_cudnn_modes: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from spectrogram_cube_clustering_tpu_torch import core, models
    from spectrogram_cube_clustering_tpu_torch.signal.stft import (
        spectrogram_windows,
    )

    card = chip_smoke.card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, cuDNN {torch.backends.cudnn.version()}",
          flush=True)
    core.fp32_policy()
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    wave = chip_smoke.synthetic_waveform(
        (1, args.windows * 400 + 100), gen, device, amplitude=10.0)
    x = spectrogram_windows(wave.cpu())
    sd = models.UNet(generator=torch.Generator().manual_seed(3)).state_dict()
    cpu = epoch(sd, x, "cpu")
    print(f"cpu [train, val] {cpu}", flush=True)
    settings = {"default": (False, False), "benchmark": (True, False),
                "deterministic": (False, True)}
    runs, kernel_sets = [], {}
    for name, (bench, det) in settings.items():
        torch.backends.cudnn.benchmark = bench
        torch.backends.cudnn.deterministic = det
        try:
            for i in range(args.runs):
                probe = models.UNet(device=device)
                probe.load_state_dict(sd)
                names = first_step_kernels(probe, x[:64].to(device))
                key = hashlib.sha1("\n".join(names).encode()).hexdigest()[:8]
                kernel_sets[key] = names
                hist = epoch(sd, x, device)
                gaps = [abs(u - w) / w for u, w in zip(hist, cpu)]
                runs.append({"setting": name, "run": i, "kernels": key,
                             "losses": hist, "gaps": gaps})
                print(f"{name} run {i} on {card}: kernels {key}; [train, "
                      f"val] {hist}; gaps to cpu "
                      f"{[f'{g:.3e}' for g in gaps]}", flush=True)
        finally:
            torch.backends.cudnn.benchmark = False
            torch.backends.cudnn.deterministic = False
    common = set.intersection(*(set(v) for v in kernel_sets.values()))
    for key, names in kernel_sets.items():
        own = [n for n in names if n not in common]
        print(f"kernel set {key}: {len(names)} kernels, not in every set: "
              f"{[n.split('(')[0][:160] for n in own]}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "cpu": cpu, "runs": runs,
                   "kernel_sets": kernel_sets}, f)
    print(card, flush=True)
    print(json.dumps({"card": card, "runs": [
        {k: r[k] for k in ("setting", "run", "kernels", "gaps")}
        for r in runs]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
