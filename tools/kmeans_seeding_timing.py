"""Time the port's k-means (100 restarts) and its k-means++ seeding on the
card, for one or more checkouts of the repo in one call, so two versions
of `cluster/kmeans.py` compare on the same card.

    python3 tools/kmeans_seeding_timing.py OLD_ROOT . . OLD_ROOT

Each ROOT runs in its own process with ROOT first on `sys.path`: a
(41,936, 9) float32 set of five Gaussian blobs (chip_smoke.py phase 4b's
latent count) from numpy's `default_rng(0)`, then `cluster.kmeans(z, 5,
n_init=100, max_iter=1000, seed=2009)` and `plus_plus_init` of the same
100 restarts (seven chunks of 16, as `kmeans` seeds them), each once to
warm up and then `--reps` times; the median seconds, the inertia and
the card's name and power limit are printed as one JSON line per ROOT.
`--device cpu` runs the same on the CPU (to try the script).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import importlib, json, sys, time
sys.path.insert(0, ROOT)
import numpy as np, torch
from spectrogram_cube_clustering_tpu_torch import cluster
km = importlib.import_module("spectrogram_cube_clustering_tpu_torch.cluster.kmeans")

rng = np.random.default_rng(0)
centres = rng.normal(scale=4.0, size=(5, 9))
z = centres[rng.integers(0, 5, 41_936)] + rng.normal(size=(41_936, 9))
z = torch.from_numpy(z.astype(np.float32)).to(DEVICE)


def seed_all():
    gen = (torch.Generator(device=z.device) if on_data
           else torch.Generator()).manual_seed(2009)
    for start in range(0, 100, 16):
        km.plus_plus_init(z, 5, min(16, 100 - start), gen)


src = open(km.__file__).read()
on_data = "Generator(device=z.device)" in src  # the tree's seeding generator


def sync():
    if z.is_cuda:
        torch.cuda.synchronize()


def timed(fn):
    fn()
    out = []
    for _ in range(REPS):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        out.append(time.perf_counter() - t0)
    return float(np.median(out)), out


_, _, inertia = cluster.kmeans(z, 5, n_init=100, max_iter=1000, seed=2009,
                               return_inertia=True)
km_s, km_all = timed(lambda: cluster.kmeans(z, 5, n_init=100, max_iter=1000,
                                            seed=2009))
seed_s, seed_all_s = timed(seed_all)
print(json.dumps({"root": ROOT, "generator": "data's device" if on_data else "cpu",
                  "kmeans_s": km_s, "kmeans_all_s": km_all,
                  "seeding_s": seed_s, "seeding_all_s": seed_all_s,
                  "inertia": float(inertia), "card": CARD}))
"""


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "not measured"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+", help="checkouts to time, in order")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="the data's device (cpu to try the script)")
    args = ap.parse_args(argv)
    card = card_line()
    rc = 0
    for root in args.roots:
        code = (f"ROOT = {os.path.abspath(root)!r}; REPS = {args.reps}; "
                f"CARD = {card!r}; DEVICE = {args.device!r}\n" + CHILD)
        r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True)
        sys.stdout.write(r.stdout)
        if r.returncode:
            sys.stderr.write(r.stderr[-4000:])
            rc = r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
