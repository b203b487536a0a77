"""Drive the torch port's serving, training, CLI workflow and STFT
experiment paths once on one NVIDIA GPU, and check them.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout. Phases, in order; any failure raises and
the script exits non-zero:

1. device: refuse to run without CUDA; print the card's name and power
   limit (nvidia-smi) and the TF32 flags after the float32 policy;
2. build: compile csrc/*.cu with nvcc (ops/_build.py), print the seconds;
3. kernel: the CUDA STFT against its plain version on the same CUDA
   tensors at the geometries below, atol 2e-3 on log10;
4. slice: a DEC(n_clusters=5, input_hw=(4, 101)) with seeded random
   weights behind the HTTP server (`serve_http.make_server`, micro-batched
   `DECPredictor`, fused `WaveformFrontend`), sent /healthz, /predict and
   /predict_waveform requests up to a (16, 2^20) waveform; every answer is
   checked against the same predictor fed windows from the plain STFT on
   the same card, and the STFT kernel must have launched during the
   waveform requests;
4b. training: a (16, 2^20) waveform .npy with known kinds (one per
   window) through the port's `workflow.load_data` (the STFT kernel must
   launch; windows within atol 2e-3 of the plain STFT on the card) ->
   normalize -> AEC(), 3 epochs, batch 64, lr 1e-3 -> k-means (100
   restarts) and GMM init on all 41,936 latents -> DEC(5), 2 epochs,
   batch 64, lr 5e-4, gamma 1e-3, tol 3e-3; the DEC labels must reach NMI
   >= 0.90 against the kinds. The same DEC runs again with tol 0, so both
   epochs and all three refreshes run: the refresh iterations must be the
   schedule's, and its labels too must reach NMI >= 0.90; refreshes and
   steps are timed apart. One AEC epoch and one DEC segment with a
   refresh on 2,048 windows must give the same losses on the CPU and the
   card within rtol 1e-3. Two more AEC epochs, one plain and one under
   torch.profiler, give the device's busy time against each wall;
4c. workflow: the five stages (AEC train, AEC predict, GMM fit, DEC train
   with init=load, DEC predict) through the port's `cli.run_dc`, card by
   default, figures and tb off, AEC 3 epochs batch 64 lr 1e-3 with early
   stopping, GMM K=5 with 100 k-means restarts, DEC batch 64 lr 5e-4
   gamma 1e-3 tol 3e-3 2 epochs. Source A: the port's `build_cube` (the
   STFT kernel must launch) of a (16, 3,167,400) waveform of the same tone
   kinds, whose cube as written must lie within atol 2e-3 of the plain
   STFT of that waveform, read with chunk_size 5758 from channel 0 stride
   1: 23,024 windows. Source B: `datafiletype = waveform` on a (16, 2^20) `.npy`,
   41,936 windows (the kernel must launch in >= 4 stages). Each stage's
   artifact names must be the JAX layout's (`.pt` files for its orbax
   directories, no figures); the DEC-predict labels must reach NMI >= 0.90
   against the kinds, q's rows sum to 1 within the rounding of its K
   values to 5 decimals, and cluster_performance.csv hold K rows. Stage
   walls, build_cube seconds and load_data read seconds are printed;
4d. variants: the STFT precision and interior kernels
   (`csrc/stft_variants.cu`) through their entry points: K1's
   `precision="default"` (TF32), the folded STFT at HIGHEST, DEFAULT and
   bf16x3 (`experiments.stft_precision`), K4's passthrough, DEFAULT and
   HIGHEST pipelines (`experiments.stft_isolate`) and K5's c-only,
   power and full modes (`experiments.stft_decompose`). Each is held
   against its plain version on the same CUDA tensors at nperseg 200 /
   hop 100 on 200,000 and 4,000,000 samples, a (16, 2^20) batch and
   ragged lengths (K1's also at 256/64 and 128/16): p99.9 of the gap
   within 1e-4 and the largest error against a float64 oracle within
   max(2e-3, 1.5 x the plain version's), the passthrough bit-equal
   (log10 values; power through log10; c over its frame's sum |x w|).
   `spectrogram_windows(precision="default")` of a (16, 2^20) waveform
   must launch the TF32 kernel and not K1's, and each entry point, run
   at (16, 2^20) (K4: 4,000,000 samples) with the counts at 0, must
   launch its kernel. Prints the accuracy table at 200,000 samples
   against the oracle and K1, and each kernel's time, its plain
   version's, its library call's (`torch.stft` in float32, then |.|^2
   and log10; a shifted add for the passthrough) and its bound;
4e. layouts: the STFT layout kernels (`csrc/stft_layout.cu`) through
   their entry points at the scripts' default blocks: K6 raw-read
   (`experiments.stft_rawread.rawread`, every frame), K7 narrow-out
   (`experiments.stft_outslice.spectrogram_narrow`) and K8 fused-basis
   (`experiments.stft_fusedbasis.fused`, its frames_main frames). Each is
   held against its plain version on the same CUDA tensors at 200,000
   and 4,000,000 samples and three ragged lengths (K8's frames_main just
   above one block, K6's old tail longer than a block): p99.9 of the gap
   within 1e-4, the largest error against the float64 oracle within
   max(2e-3, 1.5 x the plain version's), K8's shape its frames_main.
   Each entry point, run at 4,000,000 samples with the counts at 0, must
   launch its own kernel once, and neither K1 nor a variant kernel.
   Prints each kernel's time, its plain version's, its library call's
   (`torch.stft` in float32, then |.|^2 and log10), the FP32 variant
   kernel's (`stft_f32_kernel`) on the same input, and its bound;
4f. loose precision: `experiments.stft_loose_precision.main` on the card
   at the script's sizes (K1 `highest` against `precision="default"`:
   throughput at 4,000,000 samples, their gap at 400,000, and AEC ->
   k-means NMI of a planted-class waveform's windows from each); K1 and
   the TF32 kernel must launch and its JSON hold every key. The NMIs are
   printed, not gated;
5. times: kernel, plain STFT and the library call (`torch.stft` in
   float64, |.|^2, log10) at (16, 2^20) with CUDA events, the kernel's
   bound (an FFT's FP64 operations and the HBM bytes at the H100 SXM
   data sheet's peaks), and the p50 latency of each waveform request.

The last two lines are a JSON object describing each kernel and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import csv
import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

STFT_ATOL = 2e-3  # log10 units: the kernel contract (tests/test_signal.py:47)
Q_ATOL = 1e-5
LABEL_GAP = 1e-4
BIG = (16, 1 << 20)
# 31,673 frames, whose usable 2/11 (the reference reader's, data/cube.py)
# are exactly one 5,758-row chunk per channel: 16 items x 1,439 windows.
# (16, 2^22) would give 41,942 frames and a usable 7,624 rows, which the
# reader refuses as not a whole number of chunks.
CUBE_WAVE = (16, 3_167_400)
# H100 SXM data sheet: FP64 tensor-core peak (the SIMT FP64 peak is half)
# and HBM3 bandwidth, at the 700 W limit
FP64_PEAK = 67e12
HBM_BYTES_PER_S = 3.35e12
# ... and the pipes of the variants: FP32 outside the tensor cores, dense
# TF32 and BF16 tensor cores
PIPE_PEAK = {"f32": 67e12, "tf32": 495e12, "bf16x3": 989e12}
VARIANT_P999 = 1e-4  # kernel against plain, benchmarks/stft_outslice_tpu.py:150
VARIANT_MAIN = BIG         # the variants' main-path input ...
VARIANT_1D = 4_000_000     # ... and K4's, a 1-D waveform
VARIANT_ACCURACY = 200_000
#: (name, TPU kernel replaced, format, epilogue, padded layout); format
#: None is K4's passthrough
VARIANTS = [
    ("stft_tf32", "spectrogram_cube_clustering_tpu/ops/pallas_stft.py:86",
     "tf32", "log", False),
    ("folded_highest", "benchmarks/stft_precision_tpu.py:77", "f32", "log",
     False),
    ("folded_default", "benchmarks/stft_precision_tpu.py:77", "tf32", "log",
     False),
    ("folded_bf16x3", "benchmarks/stft_precision_tpu.py:87", "bf16x3", "log",
     False),
    ("isolate_passthrough", "benchmarks/stft_isolate_tpu.py:40", None, None,
     True),
    ("isolate_default", "benchmarks/stft_isolate_tpu.py:40", "tf32", "log",
     True),
    ("isolate_highest", "benchmarks/stft_isolate_tpu.py:40", "f32", "log",
     True),
    ("decompose_nopow", "benchmarks/stft_decompose_tpu.py:62", "f32", "c",
     False),
    ("decompose_nolog", "benchmarks/stft_decompose_tpu.py:62", "f32", "power",
     False),
    ("decompose_full", "benchmarks/stft_decompose_tpu.py:62", "f32", "log",
     False),
]
#: (name, TPU kernel replaced) of the layout kernels, phase 4e
LAYOUTS = [
    ("rawread", "benchmarks/stft_rawread_tpu.py:50"),
    ("outslice", "benchmarks/stft_outslice_tpu.py:34"),
    ("fusedbasis", "benchmarks/stft_fusedbasis_tpu.py:45"),
]
LAYOUT_MAIN = 4_000_000  # the scripts' timed input, a 1-D waveform
# the scripts' accuracy size, the timed size and three ragged lengths:
# K8's frames_main just above one block of 512, K6's old tail (frames
# past frames_main) of 518 frames, longer than a block, and a long one
LAYOUT_LENGTHS = [200_000, LAYOUT_MAIN, 52_050, 103_150, 1_234_567]
LOOSE_KEYS = {
    "throughput_highest_gsamples", "throughput_default_gsamples", "speedup",
    "err_random_max", "err_random_p999", "err_planted_max",
    "err_planted_p999", "cluster_highest_nmi", "cluster_highest_loss",
    "cluster_default_nmi", "cluster_default_loss",
    "cluster_label_agreement_nmi", "device",
}
GEOMETRIES = [  # (nperseg, hop, waveform shape)
    (200, 100, (1, 200)), (200, 100, (1, 950)), (200, 100, (1, 1_100)),
    (200, 100, (1, 60_000)), (200, 100, (1, 1 << 20)),
    (256, 64, (1, 10_000)), (128, 16, (1, 20_000)), (100, 100, (1, 5_003)),
    (120, 40, (1, 7_919)), (192, 32, (1, 6_144)), (160, 80, (1, 9_760)),
    (250, 100, (1, 10_000)),
    (200, 100, BIG),
]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of fn() by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


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


def phase_kernel(device, gen, cuda_stft, spectrogram_plain) -> float:
    worst = 0.0
    before = cuda_stft.LAUNCHES
    for nperseg, hop, shape in GEOMETRIES:
        x = torch.randn(shape, generator=gen, device=device)
        got = cuda_stft.spectrogram_cuda(x, nperseg=nperseg, hop=hop)
        torch.cuda.synchronize()
        want = spectrogram_plain(x, nperseg=nperseg, hop=hop)
        check(got.shape == want.shape, f"shape {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), "finite STFT")
        err = (got - want).abs().cpu().numpy().ravel()
        mx, p999 = float(err.max()), float(np.quantile(err, 0.999))
        print(f"stft {nperseg}/{hop} {shape}: max_abs_err {mx:.3e} "
              f"p99.9 {p999:.3e}", flush=True)
        check(mx <= STFT_ATOL, f"stft {nperseg}/{hop} {shape} err {mx}")
        worst = max(worst, mx)
    x = torch.randn(BIG, generator=gen, device=device)
    got = cuda_stft.spectrogram_cuda(x, log=False)
    want = spectrogram_plain(x, log=False)
    err = float((torch.log10(got + 1e-12) - torch.log10(want + 1e-12))
                .abs().max())
    rel = float(((got - want).abs() / want.clamp_min(1e-30)).max())
    print(f"stft log=False {BIG}: max log10 gap {err:.3e}, max rel {rel:.3e}",
          flush=True)
    check(err <= STFT_ATOL, f"log=False gap {err}")
    check(cuda_stft.LAUNCHES > before, "kernel launches counted")
    return worst


def post(url: str, arr: np.ndarray):
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as resp:
        status, body = resp.status, resp.read()
    return status, dict(np.load(io.BytesIO(body))), time.perf_counter() - t0


def reference(predictor, wave: np.ndarray, spectrogram_plain) -> dict:
    """The same predictor fed windows from the plain STFT, whole request
    at once (no chunking), on the same device."""
    x = torch.from_numpy(wave.reshape(-1, wave.shape[-1])).to(predictor.device)
    spec = spectrogram_plain(x)
    per = spec.shape[1] // 4
    windows = spec[:, : per * 4].reshape(-1, 4, spec.shape[2], 1)
    q, labels, z = predictor.predict_tensor(windows)
    return {"q": q.cpu().numpy(), "labels": labels.cpu().numpy(),
            "z": z.cpu().numpy()}


def check_answer(name: str, got: dict, want: dict, n: int) -> None:
    check(got["q"].shape == (n, 5) and got["z"].shape == (n, 9),
          f"{name} shapes {got['q'].shape} {got['z'].shape}")
    check(got["labels"].dtype == np.int32, f"{name} labels int32")
    check(all(np.isfinite(got[k]).all() for k in ("q", "z")),
          f"{name} finite")
    q_err = float(np.abs(got["q"] - want["q"]).max())
    top2 = np.sort(want["q"], axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > LABEL_GAP
    agree = bool((got["labels"][clear] == want["labels"][clear]).all())
    print(f"{name}: {n} windows, q max_abs_err {q_err:.3e}, labels equal "
          f"on {int(clear.sum())}/{n} clear windows: {agree}, "
          f"max q {float(want['q'].max(axis=1).mean()):.3f} mean",
          flush=True)
    check(q_err <= Q_ATOL, f"{name} q err {q_err}")
    check(agree, f"{name} labels")


def cpu_against_card(sd_aec, sd_dec, x, labels, centroids) -> float:
    """One AEC epoch and one DEC epoch with a refresh half-way from the
    same weights on the CPU and on the card; returns the largest relative
    gap of their losses."""
    from spectrogram_cube_clustering_tpu_torch import models, train

    hist, deltas = {}, {}
    split = len(x) * 3 // 4
    for dev in ("cpu", "cuda"):
        xd = x.to(dev)
        aec = models.AEC(device=dev)
        aec.load_state_dict(sd_aec)
        out = train.train_aec(
            aec, train.create_train_state(aec, 1e-3),
            train.make_batched_data(xd[:split], 64),
            train.make_batched_data(xd[split:], 64),
            train.AECConfig(n_epochs=1))
        dec = models.DEC(5, device=dev)
        dec.load_state_dict(sd_dec)
        data = train.make_batched_data(xd, 64)
        seg = train.train_dec(
            dec, train.create_train_state(dec, 5e-4), data,
            train.DECConfig(n_clusters=5, n_epochs=1, init="load", tol=0.0,
                            update_interval=data.n_batches // 2),
            initial=(labels, centroids))
        hist[dev] = (out["history"]["train"] + out["history"]["validation"]
                     + seg["history"]["total"])
        deltas[dev] = seg["deltas"]["delta"]
    want, got = np.asarray(hist["cpu"]), np.asarray(hist["cuda"])
    gaps = np.abs(got - want) / np.abs(want)
    print(f"cpu vs card: AEC epoch train/val {hist['cpu'][:2]} vs "
          f"{hist['cuda'][:2]}; DEC refresh delta {deltas['cpu']} vs "
          f"{deltas['cuda']}, last running loss {hist['cpu'][-1]:.6e} vs "
          f"{hist['cuda'][-1]:.6e}; max rel gap {float(gaps.max()):.3e} "
          f"over {len(gaps)} losses", flush=True)
    check(len(deltas["cpu"]) == len(deltas["cuda"]) >= 1,
          "the same DEC refreshes on each side")
    # one label flipped by a rounding of q (ROADMAP Queue 3) is 1/M
    check(all(abs(a - b) <= 1.0 / len(x) + 1e-9
              for a, b in zip(deltas["cpu"], deltas["cuda"])),
          f"DEC deltas {deltas}")
    return float(gaps.max())


def phase_training(device, gen, card, cuda_stft, spectrogram_plain,
                   seed: int) -> int:
    """The training slice at the model's full width from a (16, 2^20)
    waveform .npy: load_data (STFT kernel) -> normalize -> AEC pretrain ->
    k-means/GMM init -> DEC refine, then the CPU against the card. Returns
    the STFT launches of the training path."""
    import tempfile
    import types

    from spectrogram_cube_clustering_tpu_torch import cluster, models, train
    from spectrogram_cube_clustering_tpu_torch.cluster import nmi
    from spectrogram_cube_clustering_tpu_torch.data import train_val_split
    from spectrogram_cube_clustering_tpu_torch.workflow import (
        load_data,
        make_model,
    )
    from spectrogram_cube_clustering_tpu_torch.workflow.train import (
        _normalize,
    )

    c, t = BIG
    # one amplitude for every kind: a window's last frame reaches 100
    # samples into the next stretch, and a neighbour 100x louder would
    # decide the window once it is normalized
    kinds = torch.randint(0, 5, (c, -(-t // 400)), generator=gen,
                          device=device)
    wave = synthetic_waveform(BIG, gen, device, kinds=kinds, amplitude=10.0)
    per_channel = ((t - 200) // 100 + 1) // 4
    truth = kinds[:, :per_channel].reshape(-1).cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/wave.npy"
        np.save(path, wave.cpu().numpy())

        def config(model):
            return types.SimpleNamespace(
                model=model, mode="train", datafiletype="waveform",
                fname_dataset=path, transform="sample_norm_cent",
                device=device, n_clusters=5)

        # 1. windows through the kernel
        cuda_stft.LAUNCHES = 0  # the training path's run starts here
        cfg = config("AEC")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tra, val = load_data(cfg)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        check(cuda_stft.LAUNCHES >= 1, "STFT kernel on the training path")
        check(tra.is_cuda and val.is_cuda, "windows on the card")
        spec = spectrogram_plain(wave)
        plain = spec[:, : per_channel * 4].reshape(-1, 4, spec.shape[-1], 1)
        idx_tra, idx_val = (torch.from_numpy(i).to(device)
                            for i in train_val_split(len(plain)))
        win_err = max(float((tra - plain[idx_tra]).abs().max()),
                      float((val - plain[idx_val]).abs().max()))
        print(f"training windows: {len(tra)} train + {len(val)} val = "
              f"{len(plain)}, load_data {load_s:.3f} s on {card}, "
              f"max_abs_err vs plain STFT {win_err:.3e}", flush=True)
        check(len(tra) + len(val) == 41_936, "41,936 windows")
        check(win_err <= STFT_ATOL, f"training windows err {win_err}")
        tra, val = _normalize(cfg, tra), _normalize(cfg, val)

        # 2. AEC pretrain
        aec = make_model(cfg, generator=torch.Generator().manual_seed(seed))
        sd_aec0 = train.params_copy(aec)
        tra_b = train.make_batched_data(tra, 64)
        val_b = train.make_batched_data(val, 64)
        marks = [time.perf_counter()]

        def mark(tag, value, epoch):
            if tag == "Validation MSE":
                torch.cuda.synchronize()
                marks.append(time.perf_counter())

        out = train.train_aec(aec, train.create_train_state(aec, 1e-3),
                              tra_b, val_b, train.AECConfig(n_epochs=3),
                              log_scalar=mark)
        hist = out["history"]
        aec_rates = [len(tra) / (b - a) for a, b in zip(marks, marks[1:])]
        for e, tr, va, r in zip(hist["epoch"], hist["train"],
                                hist["validation"], aec_rates):
            print(f"AEC epoch {e}: train {tr:.6e} val {va:.6e}, "
                  f"{r:.1f} train samples/s (epoch wall incl. validation) "
                  f"on {card}", flush=True)
        check(all(np.isfinite(hist["train"] + hist["validation"])),
              "AEC losses finite")
        check(hist["train"][-1] < hist["train"][0], "AEC train loss falls")
        aec.load_state_dict(out["final_params"])

        # 3. cluster init on the latents of every window
        cfg = config("DEC")
        x, _ = load_data(cfg)
        x = _normalize(cfg, x)
        launches = cuda_stft.LAUNCHES  # ... and the STFT's part ends here
        dec = make_model(cfg, generator=torch.Generator().manual_seed(seed))
        models.load_encoder_decoder_from_aec(dec, aec)
        data = train.make_batched_data(x, 64)
        init_cfg = train.DECConfig(n_clusters=5, init="gmm",
                                   kmeans_n_init=100, kmeans_max_iter=1000,
                                   seed=2009)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        labels0, centroids0 = train.initialize_clusters(dec, data, init_cfg)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        _, _, z = train.full_eval(dec, data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        km_labels, km_centers = cluster.kmeans(z, 5, n_init=100,
                                               max_iter=1000, seed=2009)
        torch.cuda.synchronize()
        km_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        weights = torch.bincount(km_labels.long(), minlength=5) / len(z)
        gmm_labels, gmm_state = cluster.gmm_em(z, weights, km_centers)
        torch.cuda.synchronize()
        gmm_s = time.perf_counter() - t0
        print(f"cluster init at {tuple(z.shape)} on {card}: "
              f"initialize_clusters(gmm) {init_s:.3f} s; alone, k-means "
              f"(100 restarts) {km_s:.3f} s, GMM-EM {gmm_s:.3f} s "
              f"({gmm_state.n_iter} iterations); k-means NMI vs kinds "
              f"{nmi(truth, km_labels.cpu().numpy()):.4f}, GMM "
              f"{nmi(truth, labels0.cpu().numpy()):.4f}, GMM alone vs "
              f"initialize_clusters "
              f"{nmi(gmm_labels.cpu().numpy(), labels0.cpu().numpy()):.4f}",
              flush=True)

        # 4. DEC refine
        sd_dec0 = train.params_copy(models.replace_centroids(dec, centroids0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dec_out = train.train_dec(
            dec, train.create_train_state(dec, 5e-4), data,
            train.DECConfig(n_clusters=5, n_epochs=2, gamma=1e-3, tol=3e-3,
                            init="load"),
            initial=(labels0, centroids0))
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        rows = len(dec_out["history"]["iteration"])
        trained = ((rows // data.n_batches) * len(x)
                   + (rows % data.n_batches) * 64)
        score = nmi(truth, dec_out["labels"])
        print(f"DEC: deltas {dec_out['deltas']}, {rows} steps, "
              f"{trained / dec_s:.1f} samples/s (train_dec wall {dec_s:.3f} s "
              f"incl. refreshes) on {card}; stopped by tol "
              f"{dec_out['stopped_early']}; labels NMI vs kinds {score:.4f}",
              flush=True)
        check(all(np.isfinite(dec_out["history"]["total"])), "DEC finite")
        check(score >= 0.90, f"DEC labels NMI {score}")

        # 4b. the same DEC with tol 0: both epochs and every refresh run
        dec_full = models.DEC(5, device=device)
        dec_full.load_state_dict(sd_dec0)
        nb, bsz = data.n_batches, data.batch_size
        interval = -(-len(x) // (2 * bsz))
        want_iters = [e * nb + b + 1 for e in range(2) for b in range(nb)
                      if b % interval == 0 and (e, b) != (0, 0)]
        dec_marks = []

        def dec_mark(tag, value, it):
            # "Loss" ends a segment of steps, "delta" ends a refresh
            if tag in ("Loss", "delta"):
                torch.cuda.synchronize()
                dec_marks.append((tag, it, time.perf_counter()))

        torch.cuda.synchronize()
        dec_marks.append(("start", 0, time.perf_counter()))
        full = train.train_dec(
            dec_full, train.create_train_state(dec_full, 5e-4), data,
            train.DECConfig(n_clusters=5, n_epochs=2, gamma=1e-3, tol=0.0,
                            init="load"),
            initial=(labels0, centroids0), log_scalar=dec_mark)
        refresh_ms = [(b[2] - a[2]) * 1e3
                      for a, b in zip(dec_marks, dec_marks[1:])
                      if b[0] == "delta"]
        # segments that start right after a refresh hold steps only
        seg_rows, seg_s = 0, 0.0
        for a, b in zip(dec_marks, dec_marks[1:]):
            if a[0] == "delta" and b[0] == "Loss":
                seg_rows += sum(min(bsz, len(x) - (g % nb) * bsz)
                                for g in range(a[1] - 1, b[1]))
                seg_s += b[2] - a[2]
        full_score = nmi(truth, full["labels"])
        clust = full["history"]["clustering"]
        print(f"DEC tol 0: deltas {full['deltas']}, "
              f"{len(full['history']['iteration'])} steps, refreshes "
              f"{[round(r, 3) for r in refresh_ms]} ms, steps after a "
              f"refresh {seg_rows / seg_s:.1f} samples/s on {card}; epoch "
              f"mean KLD {clust[nb - 1]:.6e} then {clust[-1]:.6e}; labels "
              f"NMI vs kinds {full_score:.4f}", flush=True)
        check(full["deltas"]["iteration"] == want_iters,
              f"DEC refresh iterations {full['deltas']['iteration']} vs "
              f"{want_iters}")
        check(all(0.0 <= d <= 1.0 for d in full["deltas"]["delta"]),
              "DEC deltas in [0, 1]")
        check(not full["stopped_early"] and full["last_epoch"] == 2
              and len(full["history"]["iteration"]) == 2 * nb,
              "DEC tol 0 ran both epochs")
        check(all(np.isfinite(full["history"]["total"])), "DEC tol 0 finite")
        check(full_score >= 0.90, f"DEC tol 0 labels NMI {full_score}")

        # 5. the CPU against the card
        gap = cpu_against_card(
            sd_aec0, sd_dec0, x[:2048].cpu(),
            labels0[:2048].cpu().numpy(), centroids0.cpu().numpy())
        check(gap <= 1e-3, f"CPU vs card losses rtol {gap}")

        # 6. the device's busy time in one AEC epoch, against the wall of a
        # plain epoch and of the profiled one (the profiler slows the host)
        prof_aec = models.AEC(device=device)
        prof_aec.load_state_dict(out["final_params"])
        state = train.create_train_state(prof_aec, 1e-3)

        def epoch_ms():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train.train_aec(prof_aec, state, tra_b, val_b,
                            train.AECConfig(n_epochs=1))
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        plain_wall_ms = epoch_ms()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            wall_ms = epoch_ms()
        # device time as the profiler's own "Self CUDA time total" counts
        # it: device events only, without the GPU spans of annotations
        # (Optimizer.step), which would count their kernels twice
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation]
        device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        print(f"AEC epoch on {card}: device busy {device_ms:.1f} ms (Self "
              f"CUDA total, profiled epoch); plain epoch wall "
              f"{plain_wall_ms:.1f} ms, share {device_ms / plain_wall_ms:.3f};"
              f" profiled epoch wall {wall_ms:.1f} ms, share "
              f"{device_ms / wall_ms:.3f}", flush=True)
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
            print(f"  {e.key[:60]}: {e.self_device_time_total / 1e3:.2f} ms "
                  f"over {e.count} calls", flush=True)
    return launches


#: artifact names of each stage in the JAX package's tree, its orbax
#: directories as `.pt` files and without figures
STAGE_FILES = {
    "aec_train": {"AEC_Params_Final.pt", "AEC_history.csv", "tmp"},
    "aec_tmp": {"AEC_Best_Weights.pt", "SNAPSHOT"},
    "aec_predict": {"Loss_AEC.npy", "MSE.txt", "Xr_AEC.npy", "Z_AEC.npy"},
    "gmm_fit": {"Labels.csv", "Z_AEC.path", "centroids.npy", "labels.npy"},
    "dec_train": {"DEC_Params_Initial.pt", "DEC_Params_Final.pt",
                  "DEC_history.csv", "Delta_history.csv", "GMM", "tmp"},
    "dec_predict": {"Labels.csv", "X_MAE.npy", "X_MAE_avg.npy", "X_MSE.npy",
                    "X_MSE_avg.npy", "X_ip.npy", "Xr_DEC.npy", "Z_DEC.npy",
                    "centroids_DEC.npy", "cluster_performance.csv",
                    "labels_DEC.npy", "q_DEC.npy", "silh_scores_X.npy",
                    "silh_scores_Z.npy"},
}


def _files(path: str) -> set:
    return {f for f in os.listdir(path) if not f.startswith("ExpConfig")}


def run_five_stages(root: str, universal: dict, card: str, name: str):
    """AEC train, AEC predict, GMM fit, DEC train (init=load) and DEC
    predict, each through the port's `cli.run_dc` with the card as the
    default device; checks every stage's artifact names. Returns the DEC
    predict directory, the stage walls and the `load_data` read seconds."""
    from spectrogram_cube_clustering_tpu_torch import cli
    from spectrogram_cube_clustering_tpu_torch.utils import config_training

    walls, reads = {}, {}

    def run(stage, params, hp=None):
        ini = config_training(
            {"savepath": f"{root}/Outputs", "configpath": f"{root}/Config",
             "transform": "sample_norm_cent", **universal},
            {"tb": "False", "show": "False", "figures": "False", **params},
            hp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cfg = cli.run_dc(init_path=ini)
        torch.cuda.synchronize()
        walls[stage] = time.perf_counter() - t0
        check(cfg.device.type == "cuda", f"{name} {stage} ran on {cfg.device}")
        if hasattr(cfg, "load_seconds"):
            reads[stage] = cfg.load_seconds
        return cfg

    def run_dir(cfg):
        [d] = [d for d in os.listdir(cfg.savepath_exp) if d.startswith("Run_")]
        return os.path.join(cfg.savepath_exp, d)

    aec = run_dir(run("aec_train", {"model": "AEC", "mode": "train",
                                    "n_epochs": 3, "early_stopping": "True"},
                      {"batch_size": "64", "lr": "0.001"}))
    weights = os.path.join(aec, "AEC_Params_Final.pt")
    run("aec_predict", {"model": "AEC", "mode": "predict",
                        "saved_weights": weights})
    run("gmm_fit", {"model": "GMM", "mode": "fit", "saved_weights": weights,
                    "km_n_init": 100, "km_max_iter": 1000},
        {"n_clusters": "5"})
    dec = run_dir(run("dec_train", {"model": "DEC", "mode": "train",
                                    "n_epochs": 2, "saved_weights": weights,
                                    "init": "load"},
                      {"batch_size": "64", "lr": "0.0005", "n_clusters": "5",
                       "gamma": "0.001", "tol": "0.003"}))
    run("dec_predict", {"model": "DEC", "mode": "predict",
                        "saved_weights": os.path.join(dec,
                                                      "DEC_Params_Final.pt")})
    trees = {"aec_train": aec, "aec_tmp": os.path.join(aec, "tmp"),
             "aec_predict": os.path.join(aec, "Prediction"),
             "gmm_fit": os.path.join(aec, "GMM", "n_clusters=5"),
             "dec_train": dec, "dec_predict": os.path.join(dec, "Prediction")}
    for stage, path in trees.items():
        # later stages write into the run dirs of earlier ones
        later = {"GMM", "Prediction"} if stage == "aec_train" else {
            "Prediction"}
        got = _files(path) - later
        check(got == STAGE_FILES[stage],
              f"{name} {stage} artifacts {sorted(got)}")
    walls_s = {k: round(v, 3) for k, v in walls.items()}
    reads_s = {k: round(v, 4) for k, v in reads.items()}
    print(f"workflow {name} on {card}: stage walls {walls_s} s; load_data "
          f"read (source read + copy to the card) {reads_s} s", flush=True)
    return trees["dec_predict"], walls, reads


def check_dec_predict(pred: str, truth: np.ndarray, name: str) -> float:
    """NMI of the DEC-predict labels against the planted kinds (gate
    0.90), q's rows summing to 1, one metrics row per cluster."""
    from spectrogram_cube_clustering_tpu_torch.cluster import nmi

    labels = np.load(os.path.join(pred, "labels_DEC.npy"))
    q = np.load(os.path.join(pred, "q_DEC.npy"))
    check(labels.shape == truth.shape, f"{name} labels {labels.shape}")
    # each of the K values is rounded to 5 decimals: the row sum may miss
    # 1 by K half-steps
    sum_err = float(np.abs(q.astype(np.float64).sum(1) - 1.0).max())
    with open(os.path.join(pred, "cluster_performance.csv")) as f:
        rows = [r for r in csv.reader(f)][1:]
    score = nmi(truth, labels)
    print(f"workflow {name}: DEC predict labels NMI vs kinds {score:.4f} "
          f"over {len(labels)} windows; q row sums within {sum_err:.2e} of "
          f"1; cluster_performance.csv {len(rows) - 1} class rows + mean",
          flush=True)
    check(sum_err <= q.shape[1] * 0.5e-5 + 1e-6, f"{name} q row sums")
    check(len(rows) - 1 == 5 and rows[-1][0] == "mean",
          f"{name} metrics rows")
    check(score >= 0.90, f"{name} DEC predict NMI {score}")
    return score


def phase_workflow(device, gen, card, cuda_stft,
                   spectrogram_plain) -> tuple:
    """The 5-stage CLI workflow through the port's `run_dc`, from a Zarr
    cube written by the port's `build_cube` (source A) and from the raw
    waveform (source B). Returns the STFT launches of both and the largest
    gap of the written cube from the plain STFT of its waveform."""
    import tempfile

    from spectrogram_cube_clustering_tpu_torch import cli
    from spectrogram_cube_clustering_tpu_torch.data import zarrlite

    launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        # source A: the cube of a CUBE_WAVE waveform
        c, t = CUBE_WAVE
        kinds = torch.randint(0, 5, (c, -(-t // 400)), generator=gen,
                              device=device)
        wave = synthetic_waveform(CUBE_WAVE, gen, device, kinds=kinds,
                                  amplitude=10.0)
        np.save(f"{tmp}/cube_wave.npy", wave.cpu().numpy())
        cuda_stft.LAUNCHES = 0  # build_cube's run starts here
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cube = cli.build_cube([f"{tmp}/cube_wave.npy", f"{tmp}/cube.zarr"])
        build_s = time.perf_counter() - t0
        build_launches = cuda_stft.LAUNCHES  # ... and ends here
        print(f"workflow zarr: build_cube {build_s:.3f} s on {card} "
              f"(STFT kernel launches {build_launches})", flush=True)
        check(build_launches >= 1, "STFT kernel in build_cube")
        launches += build_launches
        # the cube as written, every tile and frame of this shape, against
        # the plain STFT of the same waveform in (frames, channels, freq)
        written = torch.from_numpy(zarrlite.open_group(cube)["cube"][:])
        want = spectrogram_plain(wave).transpose(0, 1).cpu()
        check(written.shape == want.shape, f"cube {tuple(written.shape)}")
        check(bool(torch.isfinite(written).all()), "finite cube")
        cube_err = float((written - want).abs().max())
        print(f"workflow zarr: cube {tuple(written.shape)} vs plain STFT "
              f"max_abs_err {cube_err:.3e}", flush=True)
        check(cube_err <= STFT_ATOL, f"build_cube cube err {cube_err}")
        del wave, written, want
        pred, _, _ = run_five_stages(
            f"{tmp}/A", {"fname_dataset": cube, "chunk_size": 5758,
                         "channel_start": 0, "channel_stride": 1,
                         "window_rows": 4}, card, "zarr")
        # item i is channel i, rows 0..5755: window w holds kind [i, w]
        check_dec_predict(pred, kinds[:, :1439].reshape(-1).cpu().numpy(),
                          "zarr")

        # source B: the raw (16, 2^20) waveform
        c, t = BIG
        kinds = torch.randint(0, 5, (c, -(-t // 400)), generator=gen,
                              device=device)
        wave = synthetic_waveform(BIG, gen, device, kinds=kinds,
                                  amplitude=10.0)
        np.save(f"{tmp}/wave.npy", wave.cpu().numpy())
        del wave
        per_channel = ((t - 200) // 100 + 1) // 4
        cuda_stft.LAUNCHES = 0  # the waveform stages' run starts here
        pred, _, _ = run_five_stages(
            f"{tmp}/B", {"fname_dataset": f"{tmp}/wave.npy",
                         "datafiletype": "waveform"}, card, "waveform")
        wave_launches = cuda_stft.LAUNCHES  # ... and ends here
        print(f"workflow waveform: STFT kernel launches {wave_launches}",
              flush=True)
        check(wave_launches >= 4, "STFT kernel in the waveform stages")
        launches += wave_launches
        check_dec_predict(pred, kinds[:, :per_channel].reshape(-1).cpu()
                          .numpy(), "waveform")
    return launches, cube_err


def p999(err: torch.Tensor) -> float:
    """The 99.9th percentile of err: the least of its largest 0.1%
    (torch.quantile takes at most 2^24 values)."""
    flat = err.flatten()
    return float(flat.topk(max(1, -(-flat.numel() // 1000))).values.min())


def variant_oracle(x, nperseg, hop, epilogue, rows=None, lanes=None):
    """The float64 value each variant is compared in, for (B, T) x over
    `rows` frames of the zero-padded waveform and `lanes` bins (default:
    the frames and bins of the narrow output): log10(c^2 + s^2 + 1e-12)
    for log and power, c over its frame's sum |x w| for c; and that frame
    scale (1e-30 for a frame of zeros)."""
    from spectrogram_cube_clustering_tpu_torch.signal.stft import (
        np_hann,
        windowed_dft_bases,
    )

    nfreq = nperseg // 2 + 1
    rows = (x.shape[-1] - nperseg) // hop + 1 if rows is None else rows
    need = (rows - 1) * hop + nperseg
    xp = torch.nn.functional.pad(x.double(), (0, max(0, need - x.shape[-1])))
    frames = xp[:, :need].unfold(-1, nperseg, hop)
    cos_b, sin_b = (torch.from_numpy(v).to(x.device)
                    for v in windowed_dft_bases(nperseg))
    win = torch.from_numpy(np_hann(nperseg)).to(x.device)
    scale = (frames.abs() @ win)[..., None].clamp_min(1e-30)
    c = frames @ cos_b
    pad = (0, (lanes or nfreq) - nfreq)
    if epilogue == "c":
        return torch.nn.functional.pad(c, pad) / scale, scale
    s = frames @ sin_b
    want = torch.log10(c * c + s * s + 1e-12)
    return torch.nn.functional.pad(want, pad, value=-12.0), scale


def variant_values(got, epilogue, scale):
    """A variant's float32 output in the oracle's terms (float64)."""
    if epilogue == "c":
        return got.double() / scale
    return torch.log10(got.double()) if epilogue == "power" else got.double()


def phase_variants(device, gen, card, cuda_stft, spectrogram_windows):
    """Phase 4d: the STFT precision and interior kernels against their
    plain versions, the path through their entry points, the accuracy
    table and the times. Returns the kernels line's entries."""
    from spectrogram_cube_clustering_tpu_torch.experiments import (
        stft_decompose,
        stft_isolate,
        stft_precision,
    )
    from spectrogram_cube_clustering_tpu_torch.ops import (
        cuda_stft_variants as stv,
    )

    lanes = stft_isolate.LANE

    def spec(name, fmt, epilogue, padded, t, nperseg=200, hop=100):
        """Keywords of the wrapper and plain version of a variant for a
        waveform of t samples."""
        kw = dict(fmt=fmt, epilogue=epilogue)
        if padded:
            kw.update(rows=stft_isolate.rows_padded(t, 256), lanes=lanes)
        chunks = nperseg // hop if name.startswith(("isolate", "decompose")) \
            else 1
        return kw, chunks

    def kernel(name, fmt, epilogue, padded, x, nperseg=200, hop=100):
        """(kernel output, plain output) of a variant on the same x."""
        t = x.shape[-1]
        if fmt is None:
            rows = stft_isolate.rows_padded(t, 256)
            return (stv.passthrough_cuda(x, hop, nperseg // hop, rows, lanes),
                    stv.passthrough_plain(x, hop, nperseg // hop, rows, lanes))
        kw, chunks = spec(name, fmt, epilogue, padded, t, nperseg, hop)
        if name == "stft_tf32":  # through K1's entry point
            got = cuda_stft.spectrogram(x, nperseg, hop, precision="default")
        else:
            got = stv.stft_variant_cuda(x, nperseg, hop, **kw)
        return got, stv.stft_variant_plain(x, nperseg, hop, chunks=chunks,
                                           **kw)

    # kernel against plain at each geometry
    shapes = [(1, VARIANT_ACCURACY), (1, VARIANT_1D), VARIANT_MAIN,
              (1, 30_099), (3, 4_567), (2, 12_345)]
    worst = {}
    for name, _, fmt, epilogue, padded in VARIANTS:
        geoms = [(200, 100, s) for s in shapes]
        if name == "stft_tf32":
            geoms += [(256, 64, (2, 100_000)), (128, 16, (1, 50_000))]
        worst[name] = 0.0
        for nperseg, hop, shape in geoms:
            x = torch.randn(shape, generator=gen, device=device)
            got, want = kernel(name, fmt, epilogue, padded, x, nperseg, hop)
            torch.cuda.synchronize()
            check(got.shape == want.shape,
                  f"{name} shape {tuple(got.shape)} vs {tuple(want.shape)}")
            check(bool(torch.isfinite(got).all()), f"{name} finite")
            if fmt is None:
                print(f"variant {name} {shape}: bit-equal "
                      f"{torch.equal(got, want)}", flush=True)
                check(torch.equal(got, want), f"{name} {shape} bit-equal")
                continue
            kw = spec(name, fmt, epilogue, padded, shape[-1])[0]
            ref, scale = variant_oracle(x, nperseg, hop, epilogue,
                                        kw.get("rows"), kw.get("lanes"))
            g = variant_values(got, epilogue, scale)
            w = variant_values(want, epilogue, scale)
            diff = (g - w).abs()
            gap, q = float(diff.max()), p999(diff)
            k_err = float((g - ref).abs().max())
            p_err = float((w - ref).abs().max())
            limit = max(STFT_ATOL, 1.5 * p_err)
            print(f"variant {name} {nperseg}/{hop} {shape}: vs plain max "
                  f"{gap:.3e} p99.9 {q:.3e}; vs float64 kernel {k_err:.3e} "
                  f"plain {p_err:.3e} (limit {limit:.3e})", flush=True)
            check(q <= VARIANT_P999, f"{name} {shape} p99.9 {q}")
            check(k_err <= limit, f"{name} {shape} vs float64 {k_err}")
            worst[name] = max(worst[name], gap)
            del got, want, ref, scale, g, w, diff

    # the path: each entry point with the counts at 0 just before it
    xb = torch.randn(VARIANT_MAIN, generator=gen, device=device)
    x1 = torch.randn(VARIANT_1D, generator=gen, device=device)
    paths = {
        "stft_tf32": lambda: spectrogram_windows(xb, precision="default"),
        "folded_highest": lambda: stft_precision.spectrogram_folded(xb),
        "folded_default": lambda: stft_precision.spectrogram_folded(
            xb, precision="default"),
        "folded_bf16x3": lambda: stft_precision.spectrogram_folded_b3(xb),
        "isolate_passthrough": lambda: stft_isolate.pipeline(
            x1, "passthrough"),
        "isolate_default": lambda: stft_isolate.pipeline(x1, "default"),
        "isolate_highest": lambda: stft_isolate.pipeline(x1, "highest"),
        "decompose_nopow": lambda: stft_decompose.variant(xb, "nopow"),
        "decompose_nolog": lambda: stft_decompose.variant(xb, "nolog"),
        "decompose_full": lambda: stft_decompose.variant(xb, "full"),
    }
    launches = {}
    for name, _, fmt, epilogue, padded in VARIANTS:
        key = stv.PASSTHROUGH if fmt is None else stv.variant_key(
            fmt, epilogue, padded)
        stv.LAUNCHES.clear()  # this entry point's run starts here
        cuda_stft.LAUNCHES = 0
        out = paths[name]()
        torch.cuda.synchronize()
        counts, k1 = dict(stv.LAUNCHES), cuda_stft.LAUNCHES  # ... ends here
        launches[name] = counts.get(key, 0)
        print(f"variant path {name}: out {tuple(out.shape)}, launches "
              f"{counts}, K1 {k1}", flush=True)
        check(launches[name] >= 1 and set(counts) == {key} and k1 == 0,
              f"{name} path launches {counts}, K1 {k1}")
        check(bool(torch.isfinite(out).all()), f"{name} path finite")
    del out

    # the accuracy table at VARIANT_ACCURACY samples, as the script prints
    # it: against the float64 oracle and against K1
    xa = torch.randn((1, VARIANT_ACCURACY), generator=gen, device=device)
    k1 = cuda_stft.spectrogram_cuda(xa).double()
    n_frames = k1.shape[1]
    for name, _, fmt, epilogue, padded in VARIANTS:
        if fmt is None:
            continue
        got = kernel(name, fmt, epilogue, padded, xa)[0][:, :n_frames, :101]
        ref, scale = variant_oracle(xa, 200, 100, epilogue)
        g = variant_values(got, epilogue, scale)
        e64 = (g - ref).abs()
        row = f"max {float(e64.max()):.3e} p99.9 {p999(e64):.3e}"
        if epilogue != "c":
            ek1 = (g - k1).abs()
            row += (f"; vs K1 max {float(ek1.max()):.3e} "
                    f"p99.9 {p999(ek1):.3e}")
        print(f"accuracy {name} ({VARIANT_ACCURACY} samples) vs float64 "
              f"{row}", flush=True)

    # times at the main path's inputs, beside the plain version, the
    # library call and the bound
    win32 = torch.hann_window(200, periodic=True, device=device)

    def library(x, epilogue):
        s = torch.stft(x, n_fft=200, hop_length=100, window=win32,
                       center=False, return_complex=True)
        if epilogue == "c":
            return s.real
        power = s.real.square() + s.imag.square() + 1e-12
        return torch.log10(power) if epilogue == "log" else power

    entries = []
    for name, replaces, fmt, epilogue, padded in VARIANTS:
        x = x1[None] if name.startswith("isolate") else xb
        b, t = x.shape
        frames = (t - 200) // 100 + 1
        if fmt is None:
            rows = stft_isolate.rows_padded(t, 256)
            xp = torch.nn.functional.pad(
                torch.nn.functional.pad(x, (0, (rows + 1) * 100 - t))
                .reshape(b, rows + 1, 100), (0, lanes - 100))
            ms = cuda_ms(lambda: stv.passthrough_cuda(x, 100, 2, rows, lanes))
            plain_ms = cuda_ms(
                lambda: stv.passthrough_plain(x, 100, 2, rows, lanes))
            library_ms = cuda_ms(lambda: xp[:, :-1] + xp[:, 1:])
            flop, out_elems = b * rows * 100, b * rows * lanes
        else:
            kw, chunks = spec(name, fmt, epilogue, padded, t)
            ms = cuda_ms(lambda: stv.stft_variant_cuda(x, **kw))
            plain_ms = cuda_ms(
                lambda: stv.stft_variant_plain(x, chunks=chunks, **kw))
            library_ms = cuda_ms(lambda: library(x, epilogue))
            out_frames = kw.get("rows", frames)
            out_elems = b * out_frames * kw.get("lanes", 101)
            # an FFT's operations per frame, as for K1 (phase 5), with the
            # epilogue's per bin: |.|^2 + eps (3) and log10 (1)
            per_bin = {"log": 4, "power": 3, "c": 0}[epilogue]
            flop = b * out_frames * (200 + 2.5 * 200 * np.log2(200)
                                     + per_bin * 101)
        nbytes = 4 * (b * t + out_elems)
        peak = PIPE_PEAK[fmt or "f32"]
        ops_ms, bytes_ms = flop / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
        print(f"variant {name} {tuple(x.shape)} on {card}: kernel {ms:.4f} ms "
              f"({x.numel() / ms / 1e6:.3f} G samples/s), plain "
              f"{plain_ms:.4f} ms, library {library_ms:.4f} ms; bound "
              f"{bound_ms:.4f} ms by {bound_by} ({flop:.4e} FLOP at "
              f"{peak:.3g}/s = {ops_ms:.4f} ms; {nbytes} bytes = "
              f"{bytes_ms:.4f} ms), kernel at {bound_ms / ms:.1%} of it",
              flush=True)
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "spectrogram_cube_clustering_tpu_torch/csrc/"
                      "stft_variants.cu",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": worst[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": library_ms,
        })
    return entries


def phase_layouts(device, gen, card, cuda_stft):
    """Phase 4e: the STFT layout kernels (K6-K8) against their plain
    versions and a float64 oracle, the path through their entry points,
    and the times. Returns the kernels line's entries."""
    from spectrogram_cube_clustering_tpu_torch.experiments import (
        stft_fusedbasis,
        stft_outslice,
        stft_rawread,
    )
    from spectrogram_cube_clustering_tpu_torch.ops import (
        cuda_stft_layout as stl,
    )
    from spectrogram_cube_clustering_tpu_torch.ops import (
        cuda_stft_variants as stv,
    )

    entries = {  # the scripts' entry points at their default blocks
        "rawread": stft_rawread.rawread,
        "outslice": stft_outslice.spectrogram_narrow,
        "fusedbasis": stft_fusedbasis.fused,
    }

    def n_out(name, t):
        """The frames of an entry point's output for t samples."""
        if name == "fusedbasis":
            return stl.frames_main(t, 100, 512, stl.fused_halo(200, 100))
        return (t - 200) // 100 + 1

    # kernel against plain and the float64 oracle at each length
    worst = {}
    for name, _ in LAYOUTS:
        worst[name] = 0.0
        for t in LAYOUT_LENGTHS:
            x = torch.randn((t,), generator=gen, device=device)
            got = entries[name](x)
            torch.cuda.synchronize()
            want = stl.stft_layout_plain(x, n_out=got.shape[0], layout=name)
            check(got.shape == (n_out(name, t), 101) == want.shape,
                  f"{name} {t} shape {tuple(got.shape)}")
            check(bool(torch.isfinite(got).all()), f"{name} {t} finite")
            ref = variant_oracle(x[None], 200, 100, "log")[0][0, :len(got)]
            diff = (got - want).abs()
            gap, q = float(diff.max()), p999(diff)
            k_err = float((got.double() - ref).abs().max())
            p_err = float((want.double() - ref).abs().max())
            limit = max(STFT_ATOL, 1.5 * p_err)
            tail = ""
            if name == "rawread":
                old = len(got) - stl.frames_main(t, 100, 512, stl.HALO)
                tail = f", K6's old tail {old} frames"
            print(f"layout {name} ({t},) -> {tuple(got.shape)}{tail}: vs "
                  f"plain max {gap:.3e} p99.9 {q:.3e}; vs float64 kernel "
                  f"{k_err:.3e} plain {p_err:.3e} (limit {limit:.3e})",
                  flush=True)
            check(q <= VARIANT_P999, f"{name} {t} p99.9 {q}")
            check(k_err <= limit, f"{name} {t} vs float64 {k_err}")
            worst[name] = max(worst[name], gap)
            del x, got, want, ref, diff

    # the path: each entry point at LAYOUT_MAIN samples with the counts at
    # 0 just before it
    x = torch.randn((LAYOUT_MAIN,), generator=gen, device=device)
    launches = {}
    for name, _ in LAYOUTS:
        stl.LAUNCHES.clear()  # this entry point's run starts here
        stv.LAUNCHES.clear()
        cuda_stft.LAUNCHES = 0
        out = entries[name](x)
        torch.cuda.synchronize()
        counts, others = dict(stl.LAUNCHES), dict(stv.LAUNCHES)
        k1 = cuda_stft.LAUNCHES  # ... and ends here
        launches[name] = counts.get(name, 0)
        print(f"layout path {name}: out {tuple(out.shape)}, launches "
              f"{counts}, variants {others}, K1 {k1}", flush=True)
        check(counts == {name: 1} and not others and k1 == 0,
              f"{name} path launches {counts}, variants {others}, K1 {k1}")
        check(out.shape == (n_out(name, LAYOUT_MAIN), 101)
              and bool(torch.isfinite(out).all()), f"{name} path output")
    del out

    # times at the path's input, beside the plain version, the library
    # call, the FP32 variant kernel (stft_f32_kernel) and the bound
    win32 = torch.hann_window(200, periodic=True, device=device)

    def library(v):
        s = torch.stft(v, n_fft=200, hop_length=100, window=win32,
                       center=False, return_complex=True)
        return torch.log10(s.real.square() + s.imag.square() + 1e-12)

    result = []
    for name, replaces in LAYOUTS:
        frames = n_out(name, LAYOUT_MAIN)
        # the samples those frames read: K8 covers only frames_main
        v = x[:(frames - 1) * 100 + 200]
        ms = cuda_ms(lambda: stl.stft_layout_cuda(x, n_out=frames,
                                                  layout=name))
        plain_ms = cuda_ms(lambda: stl.stft_layout_plain(x, n_out=frames,
                                                         layout=name))
        library_ms = cuda_ms(lambda: library(v))
        f32_ms = cuda_ms(lambda: stv.stft_variant_cuda(v[None], fmt="f32",
                                                       epilogue="log"))
        ms2 = cuda_ms(lambda: stl.stft_layout_cuda(x, n_out=frames,
                                                   layout=name))
        # each input byte read once (the whole waveform is the input), each
        # output byte written once; an FFT's FP32 operations per frame, as
        # phase 4d counts them
        flop = frames * (200 + 2.5 * 200 * np.log2(200) + 4 * 101)
        nbytes = 4 * (LAYOUT_MAIN + frames * 101)
        ops_ms = flop / PIPE_PEAK["f32"] * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
        print(f"layout {name} ({LAYOUT_MAIN},) -> ({frames}, 101) on {card}: "
              f"kernel {ms:.4f} / {ms2:.4f} ms "
              f"({LAYOUT_MAIN / ms / 1e6:.3f} G samples/s), plain "
              f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, FP32 variant "
              f"kernel {f32_ms:.4f} ms; bound {bound_ms:.4f} ms by {bound_by} "
              f"({flop:.4e} FLOP = {ops_ms:.4f} ms; {nbytes} bytes = "
              f"{bytes_ms:.4f} ms), kernel at {bound_ms / ms:.1%} of it",
              flush=True)
        result.append({
            "name": name,
            "route": "cuda",
            "source": "spectrogram_cube_clustering_tpu_torch/csrc/"
                      "stft_layout.cu",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": worst[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": library_ms,
            "f32_variant_ms": f32_ms,
        })
    return result


def phase_loose_precision(cuda_stft) -> dict:
    """Phase 4f: the loose-precision A/B through its entry point on the
    card at the script's sizes; K1 and the TF32 kernel must launch and
    the JSON hold every key. Its NMIs are printed, not gated."""
    import contextlib

    from spectrogram_cube_clustering_tpu_torch.experiments import (
        stft_loose_precision,
    )
    from spectrogram_cube_clustering_tpu_torch.ops import (
        cuda_stft_variants as stv,
    )

    stv.LAUNCHES.clear()  # the A/B's run starts here
    cuda_stft.LAUNCHES = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = stft_loose_precision.main([])
    wall = time.perf_counter() - t0
    k1, tf32 = cuda_stft.LAUNCHES, stv.LAUNCHES.get("tf32/log/narrow", 0)
    lines = buf.getvalue().strip().splitlines()  # ... and ends here
    for line in lines:
        print(f"  loose precision: {line}", flush=True)
    out = json.loads(lines[-1])
    print(f"loose precision A/B: {wall:.1f} s, K1 launches {k1}, TF32 kernel "
          f"launches {tf32}; NMI vs planted highest "
          f"{out['cluster_highest_nmi']:.4f}, default "
          f"{out['cluster_default_nmi']:.4f}, between the label sets "
          f"{out['cluster_label_agreement_nmi']:.4f} (TPU's, one seed: "
          f"0.9193)", flush=True)
    check(rc == 0, f"loose precision rc {rc}")
    check(k1 >= 1 and tf32 >= 1, f"loose precision launches K1 {k1}, "
          f"TF32 {tf32}")
    check(set(out) == LOOSE_KEYS, f"loose precision keys {sorted(out)}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    from spectrogram_cube_clustering_tpu_torch import models, serve, serve_http
    from spectrogram_cube_clustering_tpu_torch.core.device import (
        fp32_policy,
        resolve_device,
        tf32_flags,
    )
    from spectrogram_cube_clustering_tpu_torch.ops import _build, cuda_stft
    from spectrogram_cube_clustering_tpu_torch.signal.stft import (
        spectrogram_plain,
        spectrogram_windows,
    )

    device = resolve_device("cuda")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    fp32_policy()
    flags = tf32_flags()
    print(f"tf32 flags: {flags}", flush=True)
    check(not any(flags.values()), "TF32 off")

    # 2. build
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({_build.library_path().name})", flush=True)
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    # 3. kernel against plain
    gen = torch.Generator(device=device).manual_seed(args.seed)
    max_err = phase_kernel(device, gen, cuda_stft, spectrogram_plain)

    # 4. slice through the HTTP server
    model = models.DEC(
        n_clusters=5, input_hw=(4, 101),
        generator=torch.Generator().manual_seed(args.seed), device=device,
    )
    waves = {
        # the 8k request cycles through the five kinds, window by window
        "wave_8k": synthetic_waveform(
            (1, 8_000), gen, device,
            kinds=torch.arange(20, device=device)[None] % 5,
        ),
        "wave_400k": synthetic_waveform((1, 400_000), gen, device),
        "wave_16x1M": synthetic_waveform(BIG, gen, device),
    }
    # Untrained weights put latents ~1e-2 apart, where the Student-t
    # kernel (alpha = 1) is flat and q uniform. Scaling the encoder's last
    # Linear by 100 scales z exactly (ReLU is positively homogeneous);
    # centroids = latents of the 8k request's first five windows, one of
    # each kind, then make q far from uniform.
    with torch.no_grad():
        head = model.encoder.encoder[8]
        head.weight.mul_(100.0)
        head.bias.mul_(100.0)
        seed_windows = spectrogram_windows(waves["wave_8k"])[:5]
        models.replace_centroids(model, model.encode(seed_windows))
    predictor = serve.DECPredictor(
        model.state_dict(), 5, max_batch=1024, buckets=True, device=device,
    )
    frontend = serve.WaveformFrontend(predictor, nperseg=200, hop=100)
    check(frontend.fused, "fused waveform route")
    frontend.warmup()
    windows_np = spectrogram_windows(
        waves["wave_16x1M"][:2], transform=None
    ).cpu().numpy()
    waves_np = {k: v.cpu().numpy() for k, v in waves.items()}
    waves_np["wave_8k"] = waves_np["wave_8k"][0]  # a (T,) request
    waves_np["wave_400k"] = waves_np["wave_400k"][0]
    window_reqs = {f"windows_{n}": windows_np[:n] for n in (1, 19, 1024, 5000)}

    server = serve_http.make_server(predictor, host="127.0.0.1", port=0,
                                    waveform_frontend=frontend)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address[:2]
    base = f"http://{host}:{port}"
    answers, latency = {}, {}
    try:
        cuda_stft.LAUNCHES = 0  # the main path's run starts here
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as resp:
            check(resp.status == 200, "healthz")
            meta = json.loads(resp.read())
        for name, arr in window_reqs.items():
            status, answers[name], _ = post(f"{base}/predict", arr)
            check(status == 200, f"{name} status {status}")
        for name, arr in waves_np.items():
            status, answers[name], _ = post(f"{base}/predict_waveform", arr)
            check(status == 200, f"{name} status {status}")
        launches = cuda_stft.LAUNCHES  # ... and ends here
        print(f"healthz: {meta}", flush=True)
        print(f"main path: STFT kernel launches {launches}", flush=True)
        check(launches >= len(waves_np), "STFT kernel on the waveform path")

        # 5b. waveform request latency (after the counted run)
        for name, arr in waves_np.items():
            times = [post(f"{base}/predict_waveform", arr)[2]
                     for _ in range(7)]
            latency[name] = float(np.median(times)) * 1e3
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    check(not thread.is_alive(), "server thread stopped")

    for name, arr in window_reqs.items():
        check_answer(name, answers[name], predictor(arr), len(arr))
    for name, arr in waves_np.items():
        want = reference(predictor, arr, spectrogram_plain)
        check_answer(name, answers[name], want, len(want["q"]))
        channels = 1 if arr.ndim == 1 else arr.shape[0]
        check(answers[name]["windows_per_channel"].tolist()
              == [len(want["q"]) // channels] * channels,
              f"{name} windows_per_channel")

    # 4b. the training slice
    train_launches = phase_training(device, gen, card, cuda_stft,
                                    spectrogram_plain, args.seed)
    # 4c. the 5-stage CLI workflow, from a Zarr cube and a raw waveform
    wf_launches, cube_err = phase_workflow(device, gen, card, cuda_stft,
                                           spectrogram_plain)
    max_err = max(max_err, cube_err)
    print(f"STFT kernel launches: serving path {launches}, training path "
          f"{train_launches}, workflow {wf_launches}", flush=True)
    check(train_launches >= 1, "STFT kernel on the training path")
    # 4d. the STFT precision and interior variants
    variant_entries = phase_variants(device, gen, card, cuda_stft,
                                     spectrogram_windows)
    # 4e. the STFT layout kernels
    layout_entries = phase_layouts(device, gen, card, cuda_stft)
    # 4f. the loose-precision A/B
    phase_loose_precision(cuda_stft)

    # 5. times: kernel, plain version and the library call (cuFFT through
    # torch.stft in float64, then |.|^2 and log10) on the same input
    x = torch.randn(BIG, generator=gen, device=device)
    win = torch.hann_window(200, periodic=True, dtype=torch.float64,
                            device=device)

    def library():
        s = torch.stft(x.double(), n_fft=200, hop_length=100, window=win,
                       center=False, return_complex=True)
        return torch.log10(s.abs() ** 2 + 1e-12)

    lib_err = float((library().transpose(-1, -2).float()
                     - cuda_stft.spectrogram_cuda(x)).abs().max())
    check(lib_err <= STFT_ATOL, f"torch.stft vs kernel {lib_err}")
    plain = [cuda_ms(lambda: spectrogram_plain(x))]
    kern = [cuda_ms(lambda: cuda_stft.spectrogram_cuda(x)) for _ in range(2)]
    plain.append(cuda_ms(lambda: spectrogram_plain(x)))
    library_ms = cuda_ms(library)
    kernel_ms, plain_ms = float(np.median(kern)), float(np.median(plain))
    n = x.numel()
    # the bound: the waveform read once and the spectrogram written once
    # (the Hann window and the DFT's twiddles are constants of nperseg);
    # the function's operations as an FFT computes them, per frame: the
    # window (N multiplies), a real FFT of N points (2.5 N log2 N FLOP,
    # half the 5 N log2 N of a complex one), then |.|^2 (3) and log10 (1)
    # per bin
    b, t = BIG
    n_fft, frames, nfreq = 200, (t - 200) // 100 + 1, 101
    flop = b * frames * (n_fft + 2.5 * n_fft * np.log2(n_fft) + 4 * nfreq)
    nbytes = b * t * 4 + b * frames * nfreq * 4
    ops_ms, bytes_ms = flop / FP64_PEAK * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    print(f"stft {BIG} on {card}: kernel {kernel_ms:.4f} ms "
          f"({n / kernel_ms / 1e6:.3f} G samples/s; runs {kern}), plain "
          f"{plain_ms:.4f} ms ({n / plain_ms / 1e6:.3f} G samples/s; runs "
          f"{plain}), torch.stft float64 + |.|^2 + log10 {library_ms:.4f} ms "
          f"(max_abs_err vs kernel {lib_err:.3e}); bound {bound_ms:.4f} ms "
          f"by {bound_by} ({flop:.4e} FP64 FLOP at {FP64_PEAK:.3g}/s = "
          f"{ops_ms:.4f} ms; {nbytes} bytes at {HBM_BYTES_PER_S:.3g} B/s = "
          f"{bytes_ms:.4f} ms), kernel at {bound_ms / kernel_ms:.1%} of it",
          flush=True)
    for name, ms in latency.items():
        print(f"p50 latency {name} on {card}: {ms:.2f} ms", flush=True)

    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "stft",
        "route": "cuda",
        "source": "spectrogram_cube_clustering_tpu_torch/csrc/stft.cu",
        "replaces": "spectrogram_cube_clustering_tpu/ops/pallas_stft.py:86",
        "launches": launches + train_launches + wf_launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }] + variant_entries + layout_entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
