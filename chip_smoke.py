"""Drive the torch port's serving, training, CLI workflow and STFT
experiment paths once on one NVIDIA GPU, and check them.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout. Phases, in order; any failure raises and
the script exits non-zero:

1. device: refuse to run without CUDA; print the card's name and power
   limit (nvidia-smi) and the TF32 flags after the float32 policy;
2. build: compile csrc/*.cu with nvcc (ops/_build.py), print the seconds,
   and count in `cuobjdump -sass` of the library the DMMA (FP64
   tensor-core) instructions of each instantiation of the FP64
   tensor-core kernels, K1's stft_f64_kernel, stft_f32_kernel and
   stft_layout_kernel (none may be 0), and the HMMA (TF32 / bf16
   tensor-core) instructions of each of stft_hmma_kernel's (none may be 0,
   and none may hold a DMMA); the old wmma kernel must be gone;
3. kernel: the CUDA STFT (K1) against its plain version on the same CUDA
   tensors at the geometries below, atol 2e-3 on log10 (the kernel
   contract) and, since both finish in float64 and round once, within
   1e-6 (a float32 ulp of the output);
3b. convt: the decoder's transposed-convolution kernel (D1,
   `csrc/convt.cu` through `ops.cuda_convt`) on each of `Decoder`'s four
   ConvTranspose2d -> ReLU layers at (87, 100) with 512 and 4,096 rows and
   at (4, 101) with 64, from seeded weights and inputs: against the plain
   version (cuDNN's `conv_transpose2d`, TF32 off, then relu) on the same
   card inputs within rtol 1e-5 and 1e-6 of the largest output, and
   against its float64 sum within 1e-6 of the largest output; then the
   device time (CUDA-graph replay) of each layer and of the four in a
   chain through the kernel, the plain version and the library call alone
   beside the HBM-bytes bound, and the host microseconds of a 64-row
   (4, 101) decoder forward and backward through the kernel against the
   modules (the DAS steps, where the host sets the pace);
3c. conv: the encoder's convolution kernel (E1, `csrc/conv_enc.cu`
   through `ops.cuda_conv`) on `Encoder`'s three Conv2d -> ReLU pairs at
   (87, 100) with 2,048 and 4,096 rows and at (4, 101) with 64, from
   seeded weights and inputs, both routes (a1, a2 and a3 written for
   autograd, a3 alone without): each output against the plain chain
   (cuDNN's `conv2d`, TF32 off, then relu) on the same card inputs and
   against the float64 chain within rtol 1e-5 and 1e-5 of its largest
   value, and the two routes' a3 bit-equal, and the elements that differ
   from cuDNN's counted (none where cuDNN sums in the kernel's order, as
   PERF.md's E1 found); then the device time
   (CUDA-graph replay) of each route, of the plain chain and of the three
   library calls alone, beside each route's bound (bytes or FLOPs); and
   the backward's kernels (cuDNN's dgrad and wgrad) in the `train.step`
   span of 2,048-row (87, 100) AEC steps, through the kernel and through
   the modules as the encoder ran before;
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
   steps are timed apart; every decoder forward of the phase must
   launch the transposed-convolution kernel four times (3b's
   launch count). One AEC epoch and one DEC segment with a
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
   walls, build_cube seconds, load_data read seconds and each stage's
   peak device memory are printed;
4g. stream: the same five stages with `loadmode = stream` (4 loader
   workers) from 4c's cube and waveform, which are not built again; the
   same artifact names and NMI gate. Then one AEC stream epoch on the cube
   with `stream_transfer_dtype` bfloat16 and one with int8, each within
   the JAX tests' rtol (0.02, 0.03) of the float32 wire's losses from the
   same weights; and one /predict_waveform request of 400,000 samples of
   the waveform source per wire (float32, bfloat16, float16, int8), each
   through a server of that wire with the stream run's trained DEC, held
   within 1e-3 in q (labels equal where clear) to the same trained DEC on
   the CPU over the same wire (the CPU route is held to the JAX frontend
   at a sharp q by tests/test_torch_wire.py); and the same request in
   process to a DEC with seeded random weights, the model of the JAX
   serve tests, every reduced wire against its float32 answer within
   those tests' bounds.
   Prints stage walls, the loader's windows/s to the card per wire, and
   each stage's peak device memory;
4h. architectures: from 4c's (16, 2^20) waveform (`datafiletype =
   waveform`, K1 at the head of every stage, not built again), at each
   model's full width: `arch = packed` through the five stages (NMI >=
   0.90 against the kinds) and a /predict_waveform of 400,000 samples
   over HTTP to the trained packed DEC, q within 1e-5 of the same
   predictor fed the plain STFT's windows on the card; `arch = UNet`
   through AEC train and predict (finite decreasing losses, 16-d
   latents; on a 2,048-window slice from the same seeded weights, the
   first batch's gradients and the validation loss on the card within
   rtol 1e-5 of the CPU's; one epoch twice under cuDNN's deterministic
   algorithms, equal, and its [train, validation] losses within rtol
   1.5e-3 / 6.5e-3 of the CPU's; twice under the default ones, whose
   atomics-ordered weight gradients put each run's losses elsewhere,
   printed beside them); the
   five stages with `precision = bf16` (NMI >= 0.90; the AEC stage's
   first epoch, its training windows from its seeded weights, in bf16 on
   the card within rtol 5e-3 of the same on the CPU, and its gap to
   float32 within 1e-2 of the JAX package's gap on the same epoch,
   `JAX_BF16_GAP`, which `tools/bf16_reference_gap.py` computes from
   what `--save-bf16-inputs PATH` writes). K1 must launch in the phase's
   run. Prints each run's stage walls and peak device memory, the bf16
   run's AEC losses beside 4c's float32 ones, and the train samples/s of
   one AEC epoch of the parity AEC, the packed AEC, the UNet and the
   parity AEC under bf16 on the same 41,936 windows;
4i. t-SNE and figures (`cluster/tsne_torch.py`, no kernel of its own:
   torch matmuls and reductions, TF32 off): (a) the exact path at
   tsne_torch's cap, 30,000 points of five seeded Gaussian classes in 9
   dimensions (the AEC latent width), 2,000 iterations: P build and loop
   times by CUDA events after a warm-up, the wall, the peak device memory
   of the build (<= 3x P's bytes) and of the loop (<= P + 8 chunk M 4 B,
   7.86e9 B), k-means NMI against the classes >= 0.95; (b) the landmark
   path, 200,000 points with 8,000 landmarks: wall, NMI >= 0.95; (c) the
   card against the CPU on 1,000 points from the same y0: P's largest
   relative error against a float64 oracle at most 1.5x the CPU's (the
   float32 P of these classes is known only to ~1e-3: the CPU alone,
   summing in another order, moves entries that far; the gap at rtol
   1e-5 is printed), from the CPU's P after 5 iterations y within rtol
   1e-3 / atol 1e-6 and the KL within rtol 1e-3 (the JAX package's
   chunked-against-dense tolerances), after 500 iterations NMI between
   the two embeddings' k-means >= 0.99; (d) `workflow.fit._tsne` with
   `tsne_backend = jax` on the DEC latents of 4c's waveform run (41,936
   windows, K1 at its head; the landmark path with 30,000 landmarks):
   the share of each point's 10 nearest embedding neighbours that carry
   its DEC label >= 0.90; the k-means NMI against the DEC labels is
   printed, not gated, since t-SNE splits each of these classes into
   islands, as the JAX package's t-SNE and sklearn's do on the same
   latents (`tools/tsne_reference_nmi.py` on what `--save-tsne-inputs
   PATH` writes); (e) where matplotlib imports, run-dc's DEC predict
   with `figures = True` and `tsne_backend = jax` on 4c's DEC run must
   write every figure file of the JAX tree; where it does not (the
   card's machine), run-dc with figures must raise ImportError naming
   matplotlib and leave the run dir as it was;
4j. multi-GPU (`core.mesh`, `parallel`; no kernel of its own: K1 runs in
   every rank): 4c's five waveform stages (41,936 windows, K1 at the
   head of every stage) through `cli.run_dc(mesh=)` in child processes,
   (a) as a one-rank NCCL group and (b) as two ranks on the one card over
   gloo with CUDA tensors (NCCL refuses two ranks on one device; gloo
   on CUDA has only all-reduce and broadcast, which is all the mesh
   uses). Each is held to the same stages run on the card without a
   mesh in a child of its own, every run with deterministic cuDNN
   algorithms (the card's default ones move the AEC losses ~1.5e-4 run
   to run: the reference's gap to 4c's run is printed): the AEC losses
   within rtol 1e-4 (a) and 1e-3 (b: see MESH_RUNS), the DEC labels at
   NMI >= 0.99 and the artifact tree equal name for name (serials
   aside), and K1 must launch in every rank's stages. (b) also holds one
   AEC epoch of 100 windows whose padded last batch is uneven over the
   ranks to the same epoch on one device: loss and gradients within
   1e-5. (b) also runs `parallel.sharded_spectrogram`
   over 4c's (16, 2^20) waveform cut to a multiple of 2 x hop
   (16, 1,048,400), its time axis split across the ranks, held to K1 on
   the whole within 1e-6 (log10; the same per-frame arithmetic), and
   `parallel.sharded_gmm` on 4c's DEC latents against the dense `gmm`
   at NMI >= 0.99. Prints each stage's wall, each rank's peak device
   memory and K1 launches per rank. The kernels are built before any
   rank starts, and a rank that fails fails the phase;
4k. mesh serving (`serve.py` on a `DataMesh`, `scc-serve-torch --mesh`;
   K1 in every rank of the fused route): phase 4's seeded DEC(5), saved
   as a .pt, behind `serve_http.main([... "--mesh", "--waveform"])` in
   child processes (`serve_child`), (a) one NCCL rank and (b) two gloo
   ranks on the one card, each group with a 10 s collective timeout,
   each once with the two-pass waveform route (the mesh default) and
   once with `--fuse-waveform` (each rank K1 and the model on its time
   shard); this process is the HTTP client. /predict with 1, 5, 1,000
   and 4,096 windows and /predict_waveform with 8,000, 400,000 and
   (16, 2^20) samples, every answer against phase 4's single-device
   predictor and fused frontend: z and q within rtol 1e-5 / atol 1e-7,
   labels equal where q's top-two gap exceeds 1e-4. On the fused route
   every rank must launch K1 on every request's chunk; on (b)'s fused
   route one idle pause of 12 s (longer than the timeout) precedes a
   request that must be answered; SIGINT to rank 0 must end every rank
   with 0. Prints each server's start, the p50 of each waveform request
   per route and world, K1 launches per rank and each rank's peak
   device memory;
4l. cluster-count diagnostics: the GMM stage through `cli.run_dc` with
   `km_metrics = True` and figures off, n_clusters 3, 4, 5, 6 (100
   k-means restarts), on a copy of 4c's waveform run's Z_AEC (41,936 x
   9), on the card: cluster_stats.csv must hold the 4 K with the JAX
   package's columns and finite values, its data inertias within rtol
   1e-3 of `cluster.gap_statistic` of the same 20,000-row subsample on
   the CPU. Prints the inertias, silhouettes and gaps, the stage's wall
   and the CPU sweep's;
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
   max(2e-3, 1.5 x the plain version's) (log10 values; power through
   log10; c over its frame's sum |x w|); the passthrough bit-equal at
   every `PASSTHROUGH_GEOMETRIES` entry (ragged and unaligned rows, ratio
   1 to 3, lanes == hop and scalar stores).
   `spectrogram_windows(precision="default")` of a (16, 2^20) waveform
   must launch the TF32 kernel and not K1's, and each entry point, run
   at (16, 2^20) (K4: 4,000,000 samples) with the counts at 0, must
   launch its kernel. Prints the accuracy table at 200,000 samples
   against the oracle and K1, and each kernel's time, its plain
   version's, its library call's (`torch.stft` in float32, then |.|^2
   and log10; a shifted add for the passthrough) and its bound; for the
   tensor-core kernels also the design floor, the direct DFT's FLOP at
   the peak of its pipe (FP64 tensor cores; TF32; bf16 with its three
   passes), and the kernel's share of it; for the passthrough and the
   shifted add also their device time alone (CUDA events around a CUDA
   graph of 20 calls), without the host path an event window holds,
   L2-warm and cold (a 128 MB fill before each call, the fills' own time
   subtracted) and their share of the bytes bound;
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
   Prints at how many of the 15 (layout, length) inputs the kernel is
   closer to float64 than the plain version (not gated), and each
   kernel's time, its plain version's, its library call's (`torch.stft`
   in float32, then |.|^2 and log10), the HIGHEST variant kernel's
   (`stft_f32_kernel`) on the same input, its bound, and its design
   floor (the direct DFT's FLOP at the FP64 tensor-core peak);
4f. loose precision: `experiments.stft_loose_precision.main` on the card
   at the script's sizes (K1 `highest` against `precision="default"`:
   throughput at 4,000,000 samples, their gap at 400,000, and AEC ->
   k-means NMI of a planted-class waveform's windows from each); K1 and
   the TF32 kernel must launch and its JSON hold every key. The NMIs are
   printed, not gated;
4m. the RIS event catalog (`data/h5.py`, `datafiletype = h5`; no kernel:
   the catalog holds spectrograms, so K1 must launch 0 times in the
   phase): (a) a synthetic catalog of 32,768 events in 5 planted
   frequency bands (benchmarks/h5_workflow_tpu.py's planting), raw 88 x
   101 rows cropped and vec_norm-normalized with the port's
   `crop_specgram` / `normalize_specgram` into the (32,768, 1, 87, 100)
   float32 dump `convert-h5-to-np-torch` writes (1.14 GB), with a TraVal
   index pickle (80/20); the five stages through `cli.run_dc` with
   `h5_ftype = np` and `indexpath`, figures off, in the JAX chip
   protocol (AEC 12 epochs, batch 512, lr 1e-3, no early stopping; GMM
   K = 5, 100 restarts; DEC init = load, 12 epochs, batch 512, lr 5e-4,
   gamma 0.01, tol 1e-3): input_hw (87, 100), Z_AEC (M, 9), Xr_AEC (M,
   1, 87, 100), the JAX layout's artifact names, DEC-predict NMI >= 0.90
   against the planted classes; one AEC epoch and one DEC segment with a
   refresh on 2,048 of these windows within rtol 1e-3 on the CPU and the
   card (deterministic cuDNN); (b) where h5py imports, the five stages
   from a `.h5` of the catalog and with `loadmode = stream`, same gate;
   where it does not (the card's machine), run-dc from the `.h5`, the
   stream route and each of the four H5 tools must raise ImportError
   naming h5py and leave the tree as it was; (c) where tensorboard
   imports, a 2-epoch AEC and a 1-epoch DEC train with `tb = True` must
   write the JAX tags, a step per epoch (AEC) and the refreshes' steps
   (delta); where not, run-dc with `tb = True` must raise ImportError
   naming tensorboard before writing anything and start no process; (d)
   `export-torch-checkpoint-torch` of (a)'s DEC gives the reference's
   keys and shapes at (87, 100) in float64, `convert-torch-checkpoint-
   torch` takes it back, and DEC predict from that gives q and z
   bit-equal to (a)'s; (e) `utils.profiling.trace` around one AEC epoch
   of (a)'s training windows writes a chrome trace holding CUDA kernel
   events and the `annotate` span, and a `StepTimer` over its steps gives
   items_per_sec, printed beside a plain epoch's samples/s. Prints the
   stage walls, peaks and samples/s;
4n. native host code (`native/`: the C++ Zarr chunk decoder and int8
   quantizer, built by g++ from the checkout in phase 2, no fallback;
   no kernel, K1 is not launched) and the host analysis layer: (a) the
   build's seconds, the host's CPU model and os.cpu_count(); (b) 4c's
   cube rewritten in 60-row chunks (the reference's
   Cube_chunked_60.zarr), read whole through the native batch path
   bit-equal to the per-chunk Python path (decode_chunks must run; both
   paths' seconds and decoded MB/s printed), `ZarrCubeDataset
   .load_all_windows` on it bit-equal to 4c's windows, the decoder's
   seconds with its default thread count and with one thread, and one
   stream epoch of 4g's loader over it on the int8 wire, which must call
   the native decoder and must not call the native quantizer (the wire
   encodes with the torch expression), and the loader's windows/s on
   float32 and int8 with the native decoder and with the per-chunk path,
   in turns; 4g's int8 loader over 4c's cube with the torch expression
   and with the native quantizer routed in as the JAX package routes it,
   in turns;
   (c) the repo's blosc fixture (blosc-lz4, shuffle) through
   `decode_chunks` and frame by frame through the from-scratch parser,
   both equal to its expected array;
   (d) `native.quantize_int8` on (b)'s normalized windows in batches of
   64, bit-equal to the torch expression; (e) a `sacio` SAC and miniSEED
   round trip and `seismic.remove_response_native` on a RESP the phase
   writes, each equal to the CPU's stored values (SHA-256 of the bytes;
   the removal within rtol 1e-10), with no jax or obspy imported; where
   pandas does not import, `LabelCatalogue` and `measure_label_change`,
   and where matplotlib does not, each new figure, must raise
   ImportError naming it and leave the tree as it was;
5. times: kernel, plain STFT and the library call (`torch.stft` in
   float64, |.|^2, log10) at (16, 2^20) with CUDA events, the kernel's
   bound (an FFT's FP64 operations and the HBM bytes at the H100 SXM
   data sheet's peaks), its design floor (the direct DFT at the FP64
   tensor-core peak) and the p50 latency of each waveform request.

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
import tempfile
import threading
import time
import urllib.request
from typing import Optional

import numpy as np
import torch

STFT_ATOL = 2e-3  # log10 units: the kernel contract (tests/test_signal.py:47)
K1_GAP = 1e-6  # K1 against its float64 plain version: one float32 rounding
Q_ATOL = 1e-5
LABEL_GAP = 1e-4
BIG = (16, 1 << 20)
# 31,673 frames, whose usable 2/11 (the reference reader's, data/cube.py)
# are exactly one 5,758-row chunk per channel: 16 items x 1,439 windows.
# (16, 2^22) would give 41,942 frames and a usable 7,624 rows, which the
# reader refuses as not a whole number of chunks.
CUBE_WAVE = (16, 3_167_400)
#: 3b: (input_hw, rows) of the decoder at which the transposed-convolution
#: kernel is held and timed: the RIS catalog's 512-row steps and 4,096-row
#: refresh chunks, and the DAS windows' 64-row steps
CONVT_GEOMETRIES = [((87, 100), 512), ((87, 100), 4096), ((4, 101), 64)]
#: the kernel against cuDNN (TF32 off) on the same inputs: both sum at most
#: 72 float32 products, in other orders; and against the float64 sum
CONVT_RTOL, CONVT_ATOL, CONVT_F64 = 1e-5, 1e-6, 1e-6
#: 3c: (input_hw, rows) of the encoder at which its convolution kernel is
#: held and timed: the RIS catalog's 2,048-row steps and 4,096-row eval
#: chunks, and the DAS windows' 64-row steps
CONV_GEOMETRIES = [((87, 100), 2048), ((87, 100), 4096), ((4, 101), 64)]
#: the kernel against cuDNN (TF32 off) and the float64 chain: each output
#: sums at most 64 float32 products in another order, and a layer's
#: rounding carries into the next
CONV_RTOL, CONV_ATOL = 1e-5, 1e-5
# H100 SXM data sheet: FP64 tensor-core peak (the SIMT FP64 peak is half)
# and HBM3 bandwidth, at the 700 W limit
FP64_PEAK = 67e12
#: the kernels that multiply on the FP64 tensor cores, and on the TF32 /
#: bf16 ones (phase 2)
DMMA_KERNELS = ("stft_f64_kernel", "stft_f32_kernel", "stft_layout_kernel")
HMMA_KERNELS = ("stft_hmma_kernel",)
HBM_BYTES_PER_S = 3.35e12
# ... and the pipes of the variants: FP32 outside the tensor cores, dense
# TF32 and BF16 tensor cores
PIPE_PEAK = {"f32": 67e12, "tf32": 495e12, "bf16x3": 989e12}
#: the pipe each format's tensor-core kernel multiplies on, and its passes
FLOOR_PEAK = {"f32": (FP64_PEAK, 1), "tf32": (495e12, 1),
              "bf16x3": (989e12, 3)}
VARIANT_P999 = 1e-4  # kernel against plain, benchmarks/stft_outslice_tpu.py:150
VARIANT_MAIN = BIG         # the variants' main-path input ...
VARIANT_1D = 4_000_000     # ... and K4's, a 1-D waveform
VARIANT_ACCURACY = 200_000
#: K4 passthrough geometries held bit-equal to the plain version (4d):
#: (B, T, hop, ratio, lanes, rows); the kernel's tiles are 64 rows
PASSTHROUGH_GEOMETRIES = [
    (1, 4_000_000, 100, 2, 128, 40_192),  # the path: rows_padded(4M, 256)
    (1, 30_099, 100, 2, 128, 512),        # ragged T
    (3, 12_345, 100, 2, 128, 125),        # T % 4 = 1: rows 1, 2 unaligned
    (2, 50_002, 100, 1, 128, 500),        # ratio 1, T % 4 = 2
    (1, 60_000, 100, 3, 128, 599),        # ratio 3
    (2, 9_999, 100, 2, 100, 101),         # lanes == hop
    (3, 20_001, 30, 3, 33, 700),          # scalar stores: lanes % 4 = 1
]
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
        check(mx <= K1_GAP, f"stft {nperseg}/{hop} {shape} gap {mx} over "
              f"one float32 rounding")
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


def decoder_host_us(dec, z, reps: int = 300) -> dict:
    """Host microseconds of one decoder forward and backward, through the
    kernel (`Decoder.forward`) and through the modules as the decoder ran
    before (its `nn.Sequential`, cuDNN): `reps` of them back to back, then
    one synchronize, over `reps`; three rounds, interleaved, medians. At
    64 rows the card's share is a few tens of microseconds, so the host
    sets the pace."""
    routes = {"kernel": dec,
              "modules": lambda v: dec.decoder(v).permute(0, 2, 3, 1)}
    times = {name: [] for name in routes}
    for _ in range(3):
        for name, forward in routes.items():
            for _ in range(20):
                forward(z).sum().backward()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                forward(z).sum().backward()
            torch.cuda.synchronize()
            times[name].append(1e6 * (time.perf_counter() - t0) / reps)
    return {name: float(np.median(t)) for name, t in times.items()}


def phase_convt(device, card, cuda_convt) -> dict:
    """Phase 3b: the decoder's transposed-convolution kernel against its
    plain version and its float64 sum on the same card inputs, layer by
    layer at CONVT_GEOMETRIES, then the times. Returns the kernels line's
    entry (its launches are the training phases', filled in later)."""
    from torch import nn
    import torch.nn.functional as F

    from spectrogram_cube_clustering_tpu_torch import models

    before, worst, entry = cuda_convt.LAUNCHES, 0.0, None
    for hw, rows in CONVT_GEOMETRIES:
        gen = torch.Generator().manual_seed(rows + hw[0])
        dec = models.AEC(input_hw=hw, generator=gen).decoder.to(device)
        z = torch.rand((rows, 9), generator=gen).to(device)
        noise = torch.Generator(device=device).manual_seed(rows)
        layers = [(m.weight.detach(),
                   None if m.bias is None else m.bias.detach(), m.stride,
                   m.padding, m.output_padding)
                  for m in dec.decoder if isinstance(m, nn.ConvTranspose2d)]
        chain = {"kernel": 0.0, "plain": 0.0, "library": 0.0, "bytes": 0,
                 "macs": 0}
        with torch.no_grad():
            h0 = dec.decoder[:3](z).contiguous()
            h = h0
            for i, args in enumerate(layers):
                # the layer's input plus noise, so the ReLU cuts some
                # outputs and not others
                x = h + 0.1 * torch.randn(h.shape, generator=noise,
                                          device=device)
                got = cuda_convt.convt_relu_cuda(x, *args)
                want = cuda_convt.convt_relu_plain(x, *args)
                exact = cuda_convt.convt_relu_plain(
                    x.double(), args[0].double(),
                    None if args[1] is None else args[1].double(), *args[2:])
                scale = float(want.abs().max())
                gap = float((got - want).abs().max()) / scale
                gap64 = float((got.double() - exact).abs().max()) / scale
                what = f"convt {hw} x {rows} layer {i}"
                check(scale > 0 and bool(torch.isfinite(got).all()), what)
                check(got.shape == want.shape, f"{what} shape {got.shape}")
                check(bool(torch.allclose(got, want, rtol=CONVT_RTOL,
                                          atol=CONVT_ATOL * scale)),
                      f"{what} against cuDNN: {gap:.3e} of the largest")
                check(gap64 <= CONVT_F64,
                      f"{what} against float64: {gap64:.3e} of the largest")
                worst = max(worst, gap)
                nbytes = 4 * (x.numel() + got.numel())
                cout, kh, kw = args[0].shape[1:]
                macs = x.numel() * cout * kh * kw
                ms = {
                    "kernel": graph_ms(
                        lambda: cuda_convt.convt_relu_cuda(x, *args)),
                    "plain": graph_ms(
                        lambda: cuda_convt.convt_relu_plain(x, *args)),
                    "library": graph_ms(
                        lambda: F.conv_transpose2d(x, *args)),
                }
                bound = 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                  2 * macs / PIPE_PEAK["f32"])
                print(f"{what} {tuple(x.shape)} -> {tuple(got.shape)}: gap "
                      f"{gap:.3e} (float64 {gap64:.3e}); kernel "
                      f"{ms['kernel']:.4f} ms, plain {ms['plain']:.4f}, "
                      f"library {ms['library']:.4f}; bound {bound:.4f} ms "
                      f"({bound / ms['kernel']:.1%})", flush=True)
                chain["bytes"] += nbytes
                chain["macs"] += macs
                h = want

            def through(fn):
                def run():
                    v = h0
                    for args in layers:
                        v = fn(v, *args)
                    return v
                return run

            for name, fn in (("kernel", cuda_convt.convt_relu_cuda),
                             ("plain", cuda_convt.convt_relu_plain),
                             ("library", F.conv_transpose2d)):
                chain[name] = graph_ms(through(fn))
        bound = 1e3 * max(chain["bytes"] / HBM_BYTES_PER_S,
                          2 * chain["macs"] / PIPE_PEAK["f32"])
        print(f"convt {hw} x {rows} on {card}: the four layers in a chain, "
              f"kernel {chain['kernel']:.4f} ms, plain (cuDNN + relu) "
              f"{chain['plain']:.4f} ms, library call (cuDNN) "
              f"{chain['library']:.4f} ms; bound {bound:.4f} ms "
              f"({chain['bytes']} bytes at {HBM_BYTES_PER_S:.3g} B/s), "
              f"kernel at {bound / chain['kernel']:.1%} of it", flush=True)
        if entry is None:  # the first geometry: a 512-row RIS step
            entry = {
                "name": "convt_relu",
                "route": "cuda",
                "source": "spectrogram_cube_clustering_tpu_torch/csrc/"
                          "convt.cu",
                "replaces": None,
                "shape": f"Decoder {hw}, {rows} rows, four layers",
                "ms": chain["kernel"],
                "plain_ms": chain["plain"],
                "library_ms": chain["library"],
                "bound_ms": bound,
                "bound_by": "bytes",
            }
        if rows <= 64:
            host = decoder_host_us(dec, z.requires_grad_(True))
            print(f"convt {hw} x {rows} on {card}: host us a decoder forward "
                  f"and backward, kernel {host['kernel']:.1f}, modules "
                  f"{host['modules']:.1f}", flush=True)
            entry["host_us_das"] = host
    check(cuda_convt.LAUNCHES > before, "convt kernel launches counted")
    entry["max_rel_err"] = worst
    return entry


def encoder_bound_ms(hw, rows: int, save: bool) -> tuple:
    """(bound ms, bytes, FLOPs) of the encoder's three layers over `rows`
    float32 rows: x read once and the outputs written once (a3 alone
    without `save`), or the multiply-adds at the float32 peak, the
    larger."""
    from spectrogram_cube_clustering_tpu_torch.models.aec import (
        encoder_conv_shapes,
    )

    shapes = encoder_conv_shapes(hw)
    outs = [8 * h * w for h, w in shapes[1:]]
    macs = sum(n * (1 if i == 0 else 8) * 8 for i, n in enumerate(outs))
    nbytes = 4 * rows * (hw[0] * hw[1] + (sum(outs) if save else outs[-1]))
    flop = 2 * rows * macs
    return (1e3 * max(nbytes / HBM_BYTES_PER_S, flop / PIPE_PEAK["f32"]),
            nbytes, flop)


def backward_kernels_ms(device, steps: int = 5, rows: int = 2048) -> dict:
    """The `train.step` span's backward kernels (cuDNN's dgrad and wgrad,
    by name, ms a step) over `steps` `rows`-row (87, 100) AEC steps under
    torch.profiler, through the kernel and through the modules as the
    encoder ran before (its `nn.Sequential`, cuDNN), interleaved."""
    from torch.profiler import ProfilerActivity, profile

    from spectrogram_cube_clustering_tpu_torch import models, train
    from spectrogram_cube_clustering_tpu_torch.core.precision import DEFAULT
    from spectrogram_cube_clustering_tpu_torch.train import aec as train_aec

    gen = torch.Generator().manual_seed(25)
    model = models.AEC(input_hw=(87, 100), generator=gen).to(device)
    x = torch.randn((rows, 87, 100, 1), generator=gen).to(device)
    mask = torch.ones(rows, device=device)
    count = torch.tensor(float(rows), device=device)
    sums = torch.zeros((), device=device)
    state = train.create_train_state(model, 1e-3)
    kernel = models.aec.Encoder.forward
    routes = {"kernel": kernel,
              "modules": lambda self, v: self.encoder(v.permute(0, 3, 1, 2))}
    out = {name: {} for name in routes}
    try:
        for name in ("modules", "kernel", "kernel", "modules"):
            models.aec.Encoder.forward = routes[name]
            for _ in range(3):
                train_aec._train_step(state, x, mask, count, DEFAULT, sums)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(steps):
                    train_aec._train_step(state, x, mask, count, DEFAULT,
                                          sums)
                torch.cuda.synchronize()
            for e in prof.key_averages():
                us = getattr(e, "device_time_total", 0)
                if us and ("dgrad" in e.key or "wgrad" in e.key):
                    out[name].setdefault(e.key, []).append(us / 1e3 / steps)
    finally:
        models.aec.Encoder.forward = kernel
    return {name: {k: float(np.median(v)) for k, v in kernels.items()}
            for name, kernels in out.items()}


def phase_conv(device, card, cuda_conv) -> dict:
    """Phase 3c: the encoder's convolution kernel against its plain version
    and the float64 chain on the same card inputs at CONV_GEOMETRIES, both
    routes, then the times, then the backward's kernels by route. Returns
    the kernels line's entry (its launches are the training phases',
    filled in later)."""
    import torch.nn.functional as F

    from spectrogram_cube_clustering_tpu_torch import models

    before, worst, entry = cuda_conv.LAUNCHES, 0.0, None
    for hw, rows in CONV_GEOMETRIES:
        gen = torch.Generator().manual_seed(rows + hw[0])
        enc = models.AEC(input_hw=hw, generator=gen).encoder.to(device)
        # NHWC windows seen as NCHW, as `Encoder.forward` sees them: cuDNN
        # then runs its channels-last convolution, as in the modules
        x = torch.randn((rows, *hw, 1), generator=gen).to(device).permute(
            0, 3, 1, 2)
        layers = [(m.weight.detach(), m.bias.detach(), m.stride, m.padding)
                  for m in enc.encoder[0:6:2]]
        what = f"conv {hw} x {rows}"
        with torch.no_grad():
            saved = cuda_conv.conv_relu_chain_cuda(x, layers, save=True)
            (alone,) = cuda_conv.conv_relu_chain_cuda(x, layers)
            want = cuda_conv.conv_relu_chain_plain(x, layers, save=True)
            exact = cuda_conv.conv_relu_chain_plain(x.double(), [
                (w.double(), b.double(), s, p) for w, b, s, p in layers],
                save=True)
        check(torch.equal(alone, saved[-1]), f"{what}: the routes' a3 equal")
        unequal = [int((a != b).sum()) for a, b in zip(saved, want)]
        gaps = []
        for i, (got, plain, f64) in enumerate(zip(saved, want, exact)):
            scale = float(f64.abs().max())
            gap = float((got - plain).abs().max()) / scale
            gap64 = float((got.double() - f64).abs().max()) / scale
            check(scale > 0 and bool(torch.isfinite(got).all()), what)
            check(got.shape == plain.shape, f"{what} a{i + 1} {got.shape}")
            check(bool(torch.allclose(got, plain, rtol=CONV_RTOL,
                                      atol=CONV_ATOL * scale)),
                  f"{what} a{i + 1} against cuDNN: {gap:.3e} of the largest")
            check(bool(torch.allclose(got.double(), f64, rtol=CONV_RTOL,
                                      atol=CONV_ATOL * scale)),
                  f"{what} a{i + 1} against float64: {gap64:.3e}")
            gaps.append((gap, gap64))
            worst = max(worst, gap)

        def library():
            v = x
            for w, b, st, pd in layers:
                v = F.conv2d(v, w, b, st, pd)
            return v

        with torch.no_grad():
            ms = {
                "save": graph_ms(lambda: cuda_conv.conv_relu_chain_cuda(
                    x, layers, save=True)),
                "no_grad": graph_ms(
                    lambda: cuda_conv.conv_relu_chain_cuda(x, layers)),
                "plain": graph_ms(lambda: cuda_conv.conv_relu_chain_plain(
                    x, layers, save=True)),
                "library": graph_ms(library),
            }
        bound = {route: encoder_bound_ms(hw, rows, route == "save")
                 for route in ("save", "no_grad")}
        print(f"{what} on {card}: elements unequal to cuDNN's by output "
              f"{unequal}; gaps to cuDNN / float64 by output "
              + ", ".join(f"{a:.3e} / {b:.3e}" for a, b in gaps)
              + f"; kernel with a1, a2 saved {ms['save']:.4f} ms (bound "
              f"{bound['save'][0]:.4f}, {bound['save'][0] / ms['save']:.1%}"
              f"), a3 alone {ms['no_grad']:.4f} ms (bound "
              f"{bound['no_grad'][0]:.4f}, "
              f"{bound['no_grad'][0] / ms['no_grad']:.1%}); plain (cuDNN + "
              f"relu) {ms['plain']:.4f} ms, library call (cuDNN) "
              f"{ms['library']:.4f} ms; {bound['save'][1]} / "
              f"{bound['no_grad'][1]} bytes, {bound['save'][2]:.4g} FLOP",
              flush=True)
        if entry is None:  # the first geometry: a 2,048-row RIS step
            entry = {
                "name": "conv_relu3",
                "route": "cuda",
                "source": "spectrogram_cube_clustering_tpu_torch/csrc/"
                          "conv_enc.cu",
                "replaces": None,
                "shape": f"Encoder {hw}, {rows} rows, three layers, a1 "
                         f"and a2 saved",
                "ms": ms["save"],
                "no_grad_ms": ms["no_grad"],
                "plain_ms": ms["plain"],
                "library_ms": ms["library"],
                "bound_ms": bound["save"][0],
                "no_grad_bound_ms": bound["no_grad"][0],
                "bound_by": "bytes",
                "unequal_to_library": unequal,
            }
    check(cuda_conv.LAUNCHES > before, "conv kernel launches counted")
    back = backward_kernels_ms(device)
    for name, kernels in back.items():
        print(f"conv on {card}: train.step backward through the {name}, "
              f"{sum(kernels.values()):.4f} ms a step: "
              + "; ".join(f"{k[:60]} {v:.4f}" for k, v in
                          sorted(kernels.items(), key=lambda kv: -kv[1])),
              flush=True)
    entry["backward_ms"] = {k: sum(v.values()) for k, v in back.items()}
    entry["max_rel_err"] = worst
    return entry


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


def cpu_against_card(sd_aec, sd_dec, x, labels, centroids,
                     input_hw=(4, 101)) -> float:
    """One AEC epoch and one DEC epoch with a refresh half-way from the
    same weights on the CPU and on the card, the models at `input_hw`;
    returns the largest relative gap of their losses."""
    from spectrogram_cube_clustering_tpu_torch import models, train

    hist, deltas = {}, {}
    split = len(x) * 3 // 4
    for dev in ("cpu", "cuda"):
        xd = x.to(dev)
        aec = models.AEC(input_hw=input_hw, device=dev)
        aec.load_state_dict(sd_aec)
        out = train.train_aec(
            aec, train.create_train_state(aec, 1e-3),
            train.make_batched_data(xd[:split], 64),
            train.make_batched_data(xd[split:], 64),
            train.AECConfig(n_epochs=1))
        dec = models.DEC(5, input_hw=input_hw, device=dev)
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


#: 4c's protocol, the default of `run_five_stages`: (PARAMETERS,
#: HYPERPARAMETERS) of the AEC and DEC train stages
PROTOCOL = {
    "aec": ({"n_epochs": 3, "early_stopping": "True"},
            {"batch_size": "64", "lr": "0.001"}),
    "dec": ({"n_epochs": 2},
            {"batch_size": "64", "lr": "0.0005", "n_clusters": "5",
             "gamma": "0.001", "tol": "0.003"}),
}


def run_five_stages(root: str, universal: dict, card: str, name: str,
                    extra=None, dec: bool = True, mesh=None,
                    protocol=None, configs=None):
    """AEC train, AEC predict, GMM fit, DEC train (init=load) and DEC
    predict (with `dec=False` the two AEC stages only), each through the
    port's `cli.run_dc` with the card as the default device, the
    `protocol`'s train keys (default `PROTOCOL`) and the `extra` ini keys
    (under a `mesh`, over it, each rank writing its inis to its own
    directory); checks every stage's artifact names. Returns each stage's
    directory, the stage walls, the `load_data` read seconds and each
    stage's peak device memory above what was allocated when it started;
    each stage's Configuration goes into `configs` where given."""
    from spectrogram_cube_clustering_tpu_torch import cli
    from spectrogram_cube_clustering_tpu_torch.utils import config_training

    walls, reads, peaks = {}, {}, {}

    config = "Config" if mesh is None else f"Config_rank{mesh.rank}"

    def run(stage, params, hp=None):
        ini = config_training(
            {"savepath": f"{root}/Outputs", "configpath": f"{root}/{config}",
             "transform": "sample_norm_cent", **universal},
            {"tb": "False", "show": "False", "figures": "False", **params,
             **(extra or {})},
            hp)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()  # earlier phases' tensors
        t0 = time.perf_counter()
        cfg = cli.run_dc(init_path=ini, mesh=mesh)
        torch.cuda.synchronize()
        walls[stage] = time.perf_counter() - t0
        peaks[stage] = torch.cuda.max_memory_allocated() - base
        check(cfg.device.type == "cuda", f"{name} {stage} ran on {cfg.device}")
        if hasattr(cfg, "load_seconds"):
            reads[stage] = cfg.load_seconds
        if configs is not None:
            configs[stage] = cfg
        return cfg

    def run_dir(cfg):
        [d] = [d for d in os.listdir(cfg.savepath_exp) if d.startswith("Run_")]
        return os.path.join(cfg.savepath_exp, d)

    protocol = protocol or PROTOCOL
    aec_keys, aec_hp = protocol["aec"]
    aec = run_dir(run("aec_train", {"model": "AEC", "mode": "train",
                                    **aec_keys}, aec_hp))
    weights = os.path.join(aec, "AEC_Params_Final.pt")
    run("aec_predict", {"model": "AEC", "mode": "predict",
                        "saved_weights": weights})
    trees = {"aec_train": aec, "aec_tmp": os.path.join(aec, "tmp"),
             "aec_predict": os.path.join(aec, "Prediction")}
    if dec:
        trees.update(_dec_stages(run, run_dir, aec, weights,
                                 protocol["dec"]))
    want = dict(STAGE_FILES)
    if (extra or {}).get("loadmode") == "stream":
        want["aec_tmp"] = {"SNAPSHOT"}  # the stream loop keeps no best epoch
    elif aec_keys.get("early_stopping") == "False":  # every epoch's params
        want["aec_tmp"] = {"SNAPSHOT"} | {
            f"AEC_Params_{e:03d}.pt" for e in range(1, aec_keys["n_epochs"]
                                                    + 1)}
    for stage, path in trees.items():
        # later stages write into the run dirs of earlier ones
        later = {"GMM", "Prediction"} if stage == "aec_train" else {
            "Prediction"}
        got = _files(path) - later
        check(got == want[stage], f"{name} {stage} artifacts {sorted(got)}")
    walls_s = {k: round(v, 3) for k, v in walls.items()}
    reads_s = {k: round(v, 4) for k, v in reads.items()}
    print(f"workflow {name} on {card}: stage walls {walls_s} s; load_data "
          f"read (source read + copy to the card) {reads_s} s; peak device "
          f"memory above the stage's start (torch.cuda."
          f"max_memory_allocated) {peaks} bytes",
          flush=True)
    return trees, walls, reads, peaks


def _dec_stages(run, run_dir, aec: str, weights: str, dec_protocol) -> dict:
    """GMM fit, DEC train (`dec_protocol`'s keys) and DEC predict of
    `run_five_stages`; returns their directories."""
    run("gmm_fit", {"model": "GMM", "mode": "fit", "saved_weights": weights,
                    "km_n_init": 100, "km_max_iter": 1000},
        {"n_clusters": "5"})
    dec_keys, dec_hp = dec_protocol
    dec = run_dir(run("dec_train", {"model": "DEC", "mode": "train",
                                    "saved_weights": weights, "init": "load",
                                    **dec_keys}, dec_hp))
    run("dec_predict", {"model": "DEC", "mode": "predict",
                        "saved_weights": os.path.join(dec,
                                                      "DEC_Params_Final.pt")})
    return {"gmm_fit": os.path.join(aec, "GMM", "n_clusters=5"),
            "dec_train": dec, "dec_predict": os.path.join(dec, "Prediction")}


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


def phase_workflow(device, gen, card, cuda_stft, spectrogram_plain,
                   tmp: str) -> tuple:
    """The 5-stage CLI workflow through the port's `run_dc`, from a Zarr
    cube written by the port's `build_cube` (source A) and from the raw
    waveform (source B), both left in `tmp` for the stream phase. Returns
    the STFT launches of both, the largest gap of the written cube from the
    plain STFT of its waveform, each source's ini keys and planted kinds,
    and the STFT launches of the waveform stages."""
    from spectrogram_cube_clustering_tpu_torch import cli
    from spectrogram_cube_clustering_tpu_torch.data import zarrlite

    launches = 0
    sources = {}
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
    sources["zarr"] = (
        {"fname_dataset": cube, "chunk_size": 5758, "channel_start": 0,
         "channel_stride": 1, "window_rows": 4},
        # item i is channel i, rows 0..5755: window w holds kind [i, w]
        kinds[:, :1439].reshape(-1).cpu().numpy())
    pred = run_five_stages(f"{tmp}/A", sources["zarr"][0], card,
                           "zarr")[0]["dec_predict"]
    check_dec_predict(pred, sources["zarr"][1], "zarr")

    # source B: the raw (16, 2^20) waveform
    c, t = BIG
    kinds = torch.randint(0, 5, (c, -(-t // 400)), generator=gen,
                          device=device)
    wave = synthetic_waveform(BIG, gen, device, kinds=kinds,
                              amplitude=10.0)
    np.save(f"{tmp}/wave.npy", wave.cpu().numpy())
    del wave
    per_channel = ((t - 200) // 100 + 1) // 4
    sources["waveform"] = (
        {"fname_dataset": f"{tmp}/wave.npy", "datafiletype": "waveform"},
        kinds[:, :per_channel].reshape(-1).cpu().numpy())
    cuda_stft.LAUNCHES = 0  # the waveform stages' run starts here
    pred = run_five_stages(f"{tmp}/B", sources["waveform"][0], card,
                           "waveform")[0]["dec_predict"]
    wave_launches = cuda_stft.LAUNCHES  # ... and ends here
    print(f"workflow waveform: STFT kernel launches {wave_launches}",
          flush=True)
    check(wave_launches >= 4, "STFT kernel in the waveform stages")
    launches += wave_launches
    check_dec_predict(pred, sources["waveform"][1], "waveform")
    return launches, cube_err, sources, wave_launches


#: 4g: the stream stages' ini keys
STREAM_KEYS = {"loadmode": "stream", "workers": 4}
#: 4g: each wire's bounds, the JAX tests': a stream AEC epoch's losses
#: against the float32 wire's (tests/test_prefetch.py:266-366); a fused
#: /predict_waveform answer's q (atol) and labels against the float32
#: request's (tests/test_serve.py:185-236, 526-573), for the model those
#: tests serve, a DEC with seeded random weights: labels equal for the
#: half-width floats (where the float32 q's top-two gap exceeds twice the
#: q bound, so that q within its bound cannot swap them), agreeing on 95%
#: of the windows for int8
STREAM_WIRES = {"bfloat16": 0.02, "int8": 0.03}
SERVE_WIRES = {"bfloat16": (5e-3, None), "float16": (5e-3, None),
               "int8": (3e-2, 0.95)}
#: 4g: the trained DEC's served q on the card against the same model on
#: the CPU over the same wire: both restore the same encoded samples, so
#: they differ by K1's and the model's float rounding (the wire itself
#: moves this model's q by up to 6.4e-2)
TRAINED_Q_ATOL = 1e-3


def wire_gate(got: dict, want: dict, q_atol: float, agree) -> tuple:
    """(q's largest gap, its 99.9th percentile, the share of labels
    agreeing, whether the labels pass): half-width floats (`agree` None)
    must give float32's label wherever float32's top-two gap of q exceeds
    2 * q_atol (and such windows must exist); int8 at least `agree` of all
    labels."""
    err = np.abs(got["q"] - want["q"])
    top2 = np.sort(want["q"], axis=1)[:, -2:]
    if agree is None:
        clear = top2[:, 1] - top2[:, 0] > 2 * q_atol
        same = float(np.mean(got["labels"][clear] == want["labels"][clear])
                     ) if clear.any() else 0.0
        ok = same == 1.0
    else:
        same = float(np.mean(got["labels"] == want["labels"]))
        ok = same >= agree
    return float(err.max()), float(np.quantile(err, 0.999)), same, ok


def loader_rate(device, universal: dict, wire=None) -> float:
    """Windows per second one pass of the stream loader delivers to the
    card: the source's normalized items in batches of 64, 4 workers."""
    from types import SimpleNamespace

    from spectrogram_cube_clustering_tpu_torch.workflow.train import (
        _stream_dataset,
        _stream_loader_factory,
    )

    cfg = SimpleNamespace(transform="sample_norm_cent", device=device,
                          stream_transfer_dtype=wire, **STREAM_KEYS,
                          **universal)
    make_loader = _stream_loader_factory(cfg, _stream_dataset(cfg), 64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = sum(n_valid for _, n_valid in make_loader())
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0)


def stream_epoch(root: str, universal: dict, wire) -> list:
    """One AEC stream epoch through `cli.run_dc` with `wire` as
    `stream_transfer_dtype`, from the ini's seeded weights; returns
    [train, validation] loss."""
    from spectrogram_cube_clustering_tpu_torch import cli
    from spectrogram_cube_clustering_tpu_torch.utils import config_training

    params = {"model": "AEC", "mode": "train", "n_epochs": 1,
              "early_stopping": "False", "tb": "False", "show": "False",
              "figures": "False", **STREAM_KEYS}
    if wire is not None:
        params["stream_transfer_dtype"] = wire
    cfg = cli.run_dc(init_path=config_training(
        {"savepath": f"{root}/Outputs", "configpath": f"{root}/Config",
         "transform": "sample_norm_cent", **universal},
        params, {"batch_size": "64", "lr": "0.001"}))
    [run] = [d for d in os.listdir(cfg.savepath_exp) if d.startswith("Run_")]
    with open(os.path.join(cfg.savepath_exp, run, "AEC_history.csv")) as f:
        [row] = list(csv.DictReader(f))
    return [float(row["Training MSE"]), float(row["Validation MSE"])]


def phase_stream(device, card, cuda_stft, tmp: str, sources: dict) -> None:
    """4g: the five stages with `loadmode = stream` from 4c's sources (its
    build_cube cube and its waveform, not built again), one AEC stream
    epoch per wire against the float32 wire, and one /predict_waveform
    request per wire against the float32 one, served by the stream run's
    trained DEC of the waveform source."""
    from spectrogram_cube_clustering_tpu_torch import models, serve, serve_http

    preds = {}
    cuda_stft.LAUNCHES = 0  # the stream stages' run starts here
    for name, (universal, truth) in sources.items():
        rate = loader_rate(device, universal)
        trees, walls, _, peaks = run_five_stages(
            f"{tmp}/stream_{name}", universal, card, f"stream {name}",
            STREAM_KEYS)
        preds[name] = trees["dec_predict"]
        check_dec_predict(preds[name], truth, f"stream {name}")
        print(f"stream {name} on {card}: stage walls "
              f"{ {k: round(v, 3) for k, v in walls.items()} } s; loader "
              f"{rate:.1f} windows/s to the card; peak device memory "
              f"{ {k: round(v / 2**20, 1) for k, v in peaks.items()} } MiB",
              flush=True)
    launches = cuda_stft.LAUNCHES  # ... and ends here
    print(f"stream stages: STFT kernel launches {launches} (their Zarr "
          f"cube is 4c's, written by the kernel; the waveform items are "
          f"host STFTs, as the JAX package's)", flush=True)

    universal = sources["zarr"][0]
    base = stream_epoch(f"{tmp}/wire_float32", universal, None)
    print(f"stream wire float32 on {card}: AEC epoch [train, val] {base}; "
          f"loader {loader_rate(device, universal):.1f} windows/s",
          flush=True)
    for wire, rtol in STREAM_WIRES.items():
        got = stream_epoch(f"{tmp}/wire_{wire}", universal, wire)
        rel = max(abs(g - b) / b for g, b in zip(got, base))
        print(f"stream wire {wire} on {card}: AEC epoch [train, val] {got}, "
              f"largest relative gap to float32 {rel:.3e} (bound {rtol}); "
              f"loader {loader_rate(device, universal, wire):.1f} "
              f"windows/s", flush=True)
        check(rel <= rtol, f"stream wire {wire} loss gap {rel}")

    # one request per wire to a server of the stream run's trained DEC of
    # the waveform source, 400,000 samples of that waveform, and the same
    # request to that DEC on the CPU over the same wire; and in process to
    # a DEC with seeded random weights, the model the JAX serve tests hold
    # to their bounds
    weights = os.path.join(os.path.dirname(preds["waveform"]),
                           "DEC_Params_Final.pt")
    seeded = models.DEC(5, generator=torch.Generator().manual_seed(0))
    wave = np.load(sources["waveform"][0]["fname_dataset"],
                   mmap_mode="r")[0, :400_000].copy()
    answers, cpu_answers, seeded_answers = {}, {}, {}
    for wire in (None, *SERVE_WIRES):
        predictor = serve.DECPredictor.from_checkpoint(
            weights, 5, max_batch=1024, buckets=True, device=device,
            transfer_dtype=wire)
        frontend = serve.WaveformFrontend(predictor)
        frontend.warmup()
        server = serve_http.make_server(predictor, host="127.0.0.1", port=0,
                                        waveform_frontend=frontend)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        host, port = server.server_address[:2]
        try:
            status, answers[wire], secs = post(
                f"http://{host}:{port}/predict_waveform", wave)
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        check(not thread.is_alive(), f"{wire} server thread stopped")
        check(status == 200, f"{wire} /predict_waveform status {status}")
        print(f"serve wire {wire or 'float32'} on {card}: /predict_waveform "
              f"{len(wave)} samples in {secs * 1e3:.2f} ms", flush=True)
        cpu_answers[wire] = serve.WaveformFrontend(
            serve.DECPredictor.from_checkpoint(
                weights, 5, max_batch=1024, buckets=True, device="cpu",
                transfer_dtype=wire))(wave)
        q_max, q_999, same, ok = wire_gate(answers[wire], cpu_answers[wire],
                                           TRAINED_Q_ATOL, None)
        print(f"serve wire {wire or 'float32'} on {card}, trained DEC over "
              f"HTTP against the CPU over the same wire: q max_abs_err "
              f"{q_max:.3e} (bound {TRAINED_Q_ATOL}), p99.9 {q_999:.3e}; "
              f"labels equal where clear {same:.4f}", flush=True)
        check(q_max <= TRAINED_Q_ATOL and ok,
              f"{wire} trained DEC served on the card vs the CPU")
        seeded_answers[wire] = serve.WaveformFrontend(serve.DECPredictor(
            seeded.state_dict(), 5, max_batch=1024, buckets=True,
            device=device, transfer_dtype=wire))(wave)
    for wire, (q_atol, agree) in SERVE_WIRES.items():
        q_max, q_999, same, ok = wire_gate(
            seeded_answers[wire], seeded_answers[None], q_atol, agree)
        print(f"serve wire {wire} on {card}, seeded DEC: q max_abs_err "
              f"{q_max:.3e} (bound {q_atol}), p99.9 {q_999:.3e}; labels "
              f"agreeing {same:.4f}", flush=True)
        check(q_max <= q_atol and ok, f"{wire} seeded DEC serve answer")
        q_max, q_999, same, ok = wire_gate(answers[wire], answers[None],
                                           q_atol, agree)
        cpu_gap = float(np.abs(cpu_answers[wire]["q"]
                               - cpu_answers[None]["q"]).max())
        z_err = float(np.abs(answers[wire]["z"] - answers[None]["z"]).max())
        print(f"serve wire {wire} on {card}, trained DEC over HTTP against "
              f"its float32 answer: q max_abs_err {q_max:.3e} (the CPU's: "
              f"{cpu_gap:.3e}), p99.9 {q_999:.3e}; z max_abs_err "
              f"{z_err:.3e}; labels agreeing {same:.4f} over "
              f"{len(answers[None]['q'])} windows", flush=True)
        check(ok, f"{wire} trained DEC serve labels")


#: 4h: a bf16 AEC epoch's loss on the card against the same epoch on the
#: CPU: read 1.97e-3 in every run, while a card that ran float32 instead
#: would read 3.6e-2 (PERF.md, phase 4h's findings)
BF16_CARD_RTOL = 5e-3
#: 4h: the JAX package's own gap, bf16 against float32, of the same epoch
#: (the same windows in order and the same seeded weights, on the CPU):
#: `tools/bf16_reference_gap.py` on what `--save-bf16-inputs` writes
JAX_BF16_GAP = -0.031328320557993394
#: 4h: how far the card's bf16-vs-float32 gap may lie from JAX's, absolute.
#: Each package's float32 epoch moves ~1e-3 with its arithmetic order (459
#: Adam steps): the card's gap read 3.9e-3-5.0e-3 from JAX's, the CPU's
#: 3.0e-3, while a card that ran float32 instead would read 3.1e-2
BF16_GAP_ATOL = 1e-2
#: 4h: the UNet's validation loss of its seeded weights, the card's
#: against the CPU's (the forward alone, float32, TF32 off), and the
#: relative norm of the gap between the first batch's gradients
UNET_FORWARD_RTOL = 1e-5
UNET_GRAD_RTOL = 1e-5
#: 4h: one UNet epoch, the card's [train, validation] losses against the
#: CPU's, the card's run with cuDNN's deterministic algorithms. With the
#: default ones the weight gradients come from `wgrad_alg0_engine`, which
#: adds with atomics in an order that changes run to run; Adam turns that
#: ~1e-7 gradient noise into steps of order lr, and the epoch lands in
#: one of two groups (train 6.2e-5-2.4e-4 or 1.15e-3-1.20e-3 from the
#: CPU on these windows: `tools/unet_cudnn_modes.py`, PERF.md 4h). The
#: deterministic algorithms (`wgrad_alg1_engine`) give the same losses
#: bit for bit in every run, 1.196e-3 / 5.1e-3 from the CPU; the bounds
#: hold that gap with a quarter to spare. The default runs are printed,
#: not gated
UNET_EPOCH_RTOL = (1.5e-3, 6.5e-3)


def aec_history(run_dir: str) -> list:
    """The training losses of an AEC run directory's history."""
    with open(os.path.join(run_dir, "AEC_history.csv")) as f:
        return [float(r["Training MSE"]) for r in csv.DictReader(f)]


def epoch_rates(device, x: torch.Tensor) -> dict:
    """Train samples/s of one AEC epoch (batch 64, after one untimed
    epoch) of the parity AEC, the packed AEC and the UNet in float32, and
    of the parity AEC under bf16, from seeded weights on the card's
    windows x: host clock around the epoch, synced."""
    from spectrogram_cube_clustering_tpu_torch import core, models, train
    from spectrogram_cube_clustering_tpu_torch.train.aec import train_epoch

    data = train.make_batched_data(x, 64)
    rates = {}
    for name, cls, policy in (("AEC", models.AEC, core.DEFAULT),
                              ("packed", models.PackedAEC, core.DEFAULT),
                              ("UNet", models.UNet, core.DEFAULT),
                              ("AEC bf16", models.AEC, core.BF16)):
        model = cls(generator=torch.Generator().manual_seed(0), device=device)
        state = train.create_train_state(model, 1e-3)
        train_epoch(state, data, policy)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_epoch(state, data, policy)
        torch.cuda.synchronize()
        rates[name] = len(x) / (time.perf_counter() - t0)
    return rates


def save_bf16_inputs(path: str, x: torch.Tensor) -> None:
    """Write the bf16 epoch's windows and the seeded AEC's weights (seed
    0, the port's layout) to the .npz `path`, for
    `tools/bf16_reference_gap.py`."""
    from spectrogram_cube_clustering_tpu_torch import models

    sd = models.AEC(generator=torch.Generator().manual_seed(0)).state_dict()
    np.savez(path, windows=x.cpu().numpy(),
             **{k: v.numpy() for k, v in sd.items()})
    print(f"bf16 inputs: {tuple(x.shape)} windows and the seeded AEC's "
          f"weights written to {path}", flush=True)


def unet_cpu_vs_card(device, x: torch.Tensor, card: str) -> None:
    """The UNet from seeded weights on windows x, split 3:1, on the CPU
    and the card: the first batch's gradients and the validation loss
    (the forward alone), then one epoch (batch 64) on the CPU once and on
    the card twice with its default cuDNN algorithms and twice with
    deterministic ones. Gates the gradients and the forward within
    UNET_GRAD_RTOL and UNET_FORWARD_RTOL, the two deterministic runs
    equal, and their [train, validation] losses within UNET_EPOCH_RTOL of
    the CPU's; prints each run's gaps to the CPU and the card's own
    run-to-run spread."""
    from spectrogram_cube_clustering_tpu_torch import models, train
    from spectrogram_cube_clustering_tpu_torch.train.aec import eval_epoch

    split = len(x) * 3 // 4
    sd = models.UNet(generator=torch.Generator().manual_seed(3)).state_dict()
    grads = {}
    for name, dev in (("cpu", "cpu"), ("card", device)):
        model = models.UNet(device=dev)
        model.load_state_dict(sd)
        xb = x[:64].to(dev)
        x_rec, _ = model(xb)
        torch.mean((x_rec - xb) ** 2).backward()
        grads[name] = torch.cat([p.grad.flatten().cpu()
                                 for p in model.parameters()])
    grad_gap = float((grads["card"] - grads["cpu"]).norm()
                     / grads["cpu"].norm())
    forward, hist = {}, {}
    runs = [("cpu", "cpu", False), ("card 1", device, False),
            ("card 2", device, False), ("card det 1", device, True),
            ("card det 2", device, True)]
    for name, dev, det in runs:
        torch.backends.cudnn.deterministic = det
        try:
            model = models.UNet(device=dev)
            model.load_state_dict(sd)
            val = train.make_batched_data(x[split:].to(dev), 64)
            with torch.no_grad():
                forward[name] = eval_epoch(model, val)
            out = train.train_aec(
                model, train.create_train_state(model, 1e-3),
                train.make_batched_data(x[:split].to(dev), 64), val,
                train.AECConfig(n_epochs=1))
        finally:
            torch.backends.cudnn.deterministic = False
        hist[name] = out["history"]["train"] + out["history"]["validation"]

    def gap(a, b):
        return [abs(u - w) / w for u, w in zip(hist[a], hist[b])]

    fwd = abs(forward["card 1"] - forward["cpu"]) / forward["cpu"]
    print(f"UNet cpu vs card on {card}, {len(x)} windows: seeded weights' "
          f"validation loss {forward['cpu']:.9e} vs {forward['card 1']:.9e}"
          f", gap {fwd:.3e} (bound {UNET_FORWARD_RTOL}); first batch's "
          f"gradients, relative gap {grad_gap:.3e} (bound {UNET_GRAD_RTOL})"
          "; one epoch [train, val] "
          + "; ".join(f"{k} {v}" for k, v in hist.items()), flush=True)
    print("UNet relative gaps [train, val]: " + "; ".join(
        f"{k} vs cpu {[f'{g:.3e}' for g in gap(k, 'cpu')]}"
        for k in hist if k != "cpu")
        + f"; card 2 vs card 1 {[f'{g:.3e}' for g in gap('card 2', 'card 1')]}"
        + f"; card det 2 vs card det 1 "
        f"{[f'{g:.3e}' for g in gap('card det 2', 'card det 1')]}",
        flush=True)
    check(fwd <= UNET_FORWARD_RTOL, f"UNet cpu vs card forward gap {fwd}")
    check(grad_gap <= UNET_GRAD_RTOL, f"UNet cpu vs card gradients {grad_gap}")
    check(hist["card det 2"] == hist["card det 1"],
          f"UNet deterministic card runs differ: {hist['card det 1']} vs "
          f"{hist['card det 2']}")
    check(all(g <= b for g, b in zip(gap("card det 1", "cpu"),
                                     UNET_EPOCH_RTOL)),
          f"UNet cpu vs deterministic card first-epoch loss gaps "
          f"{gap('card det 1', 'cpu')} (bounds {UNET_EPOCH_RTOL})")


def bf16_epochs(device, x: torch.Tensor, card: str) -> dict:
    """The loss of one epoch of Adam steps (batch 64) of the workflow's
    seeded AEC (seed 0) on windows x in float32 and in bf16, each on the
    card and on the CPU. Returns {name: loss}."""
    from spectrogram_cube_clustering_tpu_torch import core, models, train
    from spectrogram_cube_clustering_tpu_torch.train.aec import train_epoch

    losses = {}
    for where, dev in (("card", device), ("cpu", "cpu")):
        data = train.make_batched_data(x.to(dev), 64)
        for name, policy in (("float32", core.DEFAULT), ("bf16", core.BF16)):
            model = models.AEC(generator=torch.Generator().manual_seed(0),
                               device=dev)
            losses[f"{where} {name}"] = train_epoch(
                train.create_train_state(model, 1e-3), data, policy)
    print(f"bf16 epochs on {card}, {len(x)} windows: "
          + "; ".join(f"{k} {v:.6e}" for k, v in losses.items())
          + "; bf16 against float32: card "
          f"{losses['card bf16'] / losses['card float32'] - 1:+.4e}, cpu "
          f"{losses['cpu bf16'] / losses['cpu float32'] - 1:+.4e}",
          flush=True)
    return losses


def phase_architectures(device, card, cuda_stft, spectrogram_plain,
                        tmp: str, sources: dict,
                        save_bf16: Optional[str] = None) -> int:
    """4h: the packed and UNet architectures and the bf16 policy at full
    width from 4c's (16, 2^20) waveform source (K1 at the head of every
    stage): packed through the five stages and a /predict_waveform of
    400,000 samples to the trained packed DEC over HTTP; UNet through AEC
    train and predict; the five stages with precision = bf16. Writes the
    bf16 epoch's inputs to `save_bf16` when given. Returns the STFT
    launches of the phase's run."""
    from spectrogram_cube_clustering_tpu_torch import serve, serve_http
    from spectrogram_cube_clustering_tpu_torch.signal.stft import (
        spectrogram_windows,
    )

    universal, truth = sources["waveform"]
    wave = np.load(universal["fname_dataset"], mmap_mode="r")[0, :400_000]
    wave = np.ascontiguousarray(wave)
    runs = {}
    cuda_stft.LAUNCHES = 0  # 4h's run starts here
    runs["packed"] = run_five_stages(f"{tmp}/packed", universal, card,
                                     "packed", {"arch": "packed"})
    weights = os.path.join(runs["packed"][0]["dec_train"],
                           "DEC_Params_Final.pt")
    predictor = serve.DECPredictor.from_checkpoint(
        weights, 5, max_batch=1024, buckets=True, device=device,
        arch="packed")
    frontend = serve.WaveformFrontend(predictor)
    frontend.warmup()
    server = serve_http.make_server(predictor, host="127.0.0.1", port=0,
                                    waveform_frontend=frontend)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address[:2]
    try:
        status, answer, secs = post(
            f"http://{host}:{port}/predict_waveform", wave)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    check(not thread.is_alive(), "packed server thread stopped")
    check(status == 200, f"packed /predict_waveform status {status}")
    runs["UNet"] = run_five_stages(f"{tmp}/unet", universal, card, "UNet",
                                   {"arch": "UNet"}, dec=False)
    runs["bf16"] = run_five_stages(f"{tmp}/bf16", universal, card, "bf16",
                                   {"precision": "bf16"})
    launches = cuda_stft.LAUNCHES  # ... and ends here
    print(f"architectures: STFT kernel launches {launches}", flush=True)
    check(launches >= 11, "STFT kernel in the waveform stages of 4h")

    # packed: the clustering, and the served answer against the same
    # predictor fed the plain STFT's windows on the card
    check_dec_predict(runs["packed"][0]["dec_predict"], truth, "packed")
    want = reference(predictor, wave, spectrogram_plain)
    check_answer("packed /predict_waveform", answer, want, len(want["q"]))
    print(f"packed /predict_waveform {len(wave)} samples on {card}: "
          f"{secs * 1e3:.2f} ms", flush=True)

    # UNet: finite decreasing losses, 16-d latents, and one epoch on the
    # CPU and the card from the same weights on a 2,048-window slice
    unet_loss = aec_history(runs["UNet"][0]["aec_train"])
    z = np.load(os.path.join(runs["UNet"][0]["aec_predict"], "Z_AEC.npy"))
    print(f"UNet on {card}: AEC losses {unet_loss}; Z_AEC {z.shape}",
          flush=True)
    check(np.isfinite(unet_loss).all() and unet_loss[-1] < unet_loss[0],
          f"UNet losses {unet_loss}")
    check(z.shape == (len(truth), 16) and np.isfinite(z).all(),
          f"UNet latents {z.shape}")
    unet_cpu_vs_card(device, spectrogram_windows(torch.from_numpy(np.load(
        universal["fname_dataset"], mmap_mode="r")[0, :2_048 * 400 + 100])),
        card)

    # bf16: the clustering, and its AEC stage's losses beside 4c's float32
    # run of the same source and seeded weights (not gated: three epochs
    # with early stopping, see the gate below)
    check_dec_predict(runs["bf16"][0]["dec_predict"], truth, "bf16")
    [f32_dir] = _dirs_holding(f"{tmp}/B", "AEC_history.csv")
    f32_loss = aec_history(f32_dir)
    bf16_loss = aec_history(runs["bf16"][0]["aec_train"])
    print(f"bf16 workflow on {card}: AEC losses {bf16_loss} vs float32 "
          f"{f32_loss}; relative gaps "
          f"{[round((b - f) / f, 6) for b, f in zip(bf16_loss, f32_loss)]}",
          flush=True)

    # each run's walls, samples/s and peak memory, and the architectures'
    # train rates on one set of windows
    for name, (_, walls, _, peaks) in runs.items():
        walls_s = {k: round(v, 3) for k, v in walls.items()}
        peaks_mib = {k: round(v / 2**20, 1) for k, v in peaks.items()}
        print(f"architectures {name} on {card}: stage walls {walls_s} s; "
              f"peak device memory above each stage's start {peaks_mib} MiB",
              flush=True)
    full = np.load(universal["fname_dataset"])
    x = spectrogram_windows(torch.from_numpy(full).to(device))
    del full
    # the AEC stage's first epoch (its training windows in their order,
    # its seeded weights) in bf16 on the card against the same on the
    # CPU; and the card's bf16-vs-float32 gap against the JAX package's on
    # the same epoch. bf16 lands ~3.5% below float32 here in both
    # packages (PERF.md, 4h), so a bound of rtol 0.02 between the two
    # cannot hold and the reference's own gap is the gate
    from spectrogram_cube_clustering_tpu_torch.data import train_val_split

    idx_tra = torch.from_numpy(train_val_split(len(x))[0]).to(device)
    if save_bf16:
        save_bf16_inputs(save_bf16, x[idx_tra])
    losses = bf16_epochs(device, x[idx_tra], card)
    rel = abs(losses["card bf16"] - losses["cpu bf16"]) / losses["cpu bf16"]
    card_gap = losses["card bf16"] / losses["card float32"] - 1
    print(f"bf16 on {card}: one AEC epoch's loss on the card {rel:.3e} "
          f"from the CPU's (bound {BF16_CARD_RTOL}); its gap to float32 "
          f"{card_gap:+.4e}, the JAX package's {JAX_BF16_GAP} (bound "
          f"{BF16_GAP_ATOL})", flush=True)
    check(rel <= BF16_CARD_RTOL, f"bf16 AEC epoch, card vs cpu, gap {rel}")
    check(JAX_BF16_GAP is not None
          and abs(card_gap - JAX_BF16_GAP) <= BF16_GAP_ATOL,
          f"bf16 AEC epoch's gap to float32 {card_gap}, JAX {JAX_BF16_GAP}")
    rates = epoch_rates(device, x)
    print(f"architectures train samples/s on {card}, one AEC epoch of "
          f"{len(x)} windows, batch 64: "
          f"{ {k: round(v, 1) for k, v in rates.items()} }; packed / "
          f"parity AEC {rates['packed'] / rates['AEC']:.3f}", flush=True)
    return launches


def _dirs_holding(root: str, name: str) -> list:
    """The directories under `root` that hold a file called `name`."""
    return [d for d, _, files in os.walk(root) if name in files]


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


def direct_dft_ms(frames, epilogue, nperseg=200, fmt="f32"):
    """The direct DFT's time at the peak of the format's tensor-core pipe
    (FP64 for f32, TF32, bf16 for its three passes): 2 FLOP for each
    sample of each frame and each of the nfreq cos (and, but for c only,
    nfreq sin) columns, a pass."""
    cols = (nperseg // 2 + 1) * (1 if epilogue == "c" else 2)
    peak, passes = FLOOR_PEAK[fmt]
    return 2 * frames * nperseg * cols * passes / peak * 1e3


def graph_ms(fn, reps: int = 20, flush=None) -> float:
    """Device time alone of one fn() call: CUDA events around the replay of
    a CUDA graph of `reps` calls, so no host launch gap sits between the
    kernels (median of 5 replays, after a warm-up). With `flush`, a
    (>= 100 MB) tensor is filled before every call, so fn() finds its
    inputs out of L2 (cold), and a graph of the fills alone is subtracted.
    """

    def graph(body):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                body()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                body()
        return g

    def replay_ms(g) -> float:
        g.replay()
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            g.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    if flush is None:
        return replay_ms(graph(fn)) / reps

    def flushed():
        flush.fill_(1.0)
        fn()

    return (replay_ms(graph(flushed))
            - replay_ms(graph(lambda: flush.fill_(1.0)))) / reps


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
        worst[name] = 0.0
        if fmt is None:
            for b, t, hop, ratio, lanes_g, rows in PASSTHROUGH_GEOMETRIES:
                x = torch.randn((b, t), generator=gen, device=device)
                got = stv.passthrough_cuda(x, hop, ratio, rows, lanes_g)
                torch.cuda.synchronize()
                want = stv.passthrough_plain(x, hop, ratio, rows, lanes_g)
                same = torch.equal(got, want)
                print(f"variant {name} B={b} T={t} hop={hop} ratio={ratio} "
                      f"lanes={lanes_g} rows={rows}: bit-equal {same}",
                      flush=True)
                check(same, f"{name} {(b, t, hop, ratio, lanes_g, rows)} "
                      f"bit-equal")
            continue
        geoms = [(200, 100, s) for s in shapes]
        if name == "stft_tf32":
            geoms += [(256, 64, (2, 100_000)), (128, 16, (1, 50_000))]
        for nperseg, hop, shape in geoms:
            x = torch.randn(shape, generator=gen, device=device)
            got, want = kernel(name, fmt, epilogue, padded, x, nperseg, hop)
            torch.cuda.synchronize()
            check(got.shape == want.shape,
                  f"{name} shape {tuple(got.shape)} vs {tuple(want.shape)}")
            check(bool(torch.isfinite(got).all()), f"{name} finite")
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
            # the event windows hold the ctypes wrapper's host path: the
            # device time alone of each kernel (graph_ms), L2-warm (20
            # calls over the same 36 MB) and cold (a 128 MB fill before
            # every call), in turns kernel, add, add, kernel
            l2 = torch.empty(32 << 20, device=device)
            dev = {("kernel", "warm"): [], ("add", "warm"): [],
                   ("kernel", "cold"): [], ("add", "cold"): []}
            fns = {"kernel": lambda: stv.passthrough_cuda(x, 100, 2, rows,
                                                          lanes),
                   "add": lambda: xp[:, :-1] + xp[:, 1:]}
            for who in ("kernel", "add", "add", "kernel"):
                for temp, flush in (("warm", None), ("cold", l2)):
                    ms_ = graph_ms(fns[who], flush=flush)
                    dev[who, temp].append(ms_)
                    check(ms_ > 0, f"{name} {who} {temp} device time {ms_}")
            del l2
            pass_dev = float(np.median(dev["kernel", "warm"]))
            add_dev = float(np.median(dev["add", "warm"]))
            pass_cold = float(np.median(dev["kernel", "cold"]))
            add_cold = float(np.median(dev["add", "cold"]))
            pass_bytes_ms = 4 * (b * t + b * rows * lanes) / HBM_BYTES_PER_S \
                * 1e3
            print(f"variant {name} device time alone (CUDA graph of 20 "
                  f"calls) on {card}: kernel warm {dev['kernel', 'warm']} "
                  f"cold {dev['kernel', 'cold']} ms; shifted add warm "
                  f"{dev['add', 'warm']} cold {dev['add', 'cold']} ms; "
                  f"kernel at {pass_bytes_ms / pass_dev:.1%} (warm) / "
                  f"{pass_bytes_ms / pass_cold:.1%} (cold) of the "
                  f"{pass_bytes_ms:.4f} ms bytes bound, add at "
                  f"{pass_bytes_ms / add_dev:.1%} / "
                  f"{pass_bytes_ms / add_cold:.1%}", flush=True)
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
        floor = ""
        if fmt is not None:  # the tensor-core kernel's own floor
            floor_ms = direct_dft_ms(b * kw.get("rows", frames), epilogue,
                                     fmt=fmt)
            peak, passes = FLOOR_PEAK[fmt]
            floor = (f"; design floor {floor_ms:.4f} ms (direct DFT x "
                     f"{passes} at {peak:.3g} FLOP/s), kernel at "
                     f"{floor_ms / ms:.1%} of it")
        print(f"variant {name} {tuple(x.shape)} on {card}: kernel {ms:.4f} ms "
              f"({x.numel() / ms / 1e6:.3f} G samples/s), plain "
              f"{plain_ms:.4f} ms, library {library_ms:.4f} ms; bound "
              f"{bound_ms:.4f} ms by {bound_by} ({flop:.4e} FLOP at "
              f"{peak:.3g}/s = {ops_ms:.4f} ms; {nbytes} bytes = "
              f"{bytes_ms:.4f} ms), kernel at {bound_ms / ms:.1%} of it"
              f"{floor}", flush=True)
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
        if fmt is None:
            entries[-1].update(device_ms=pass_dev, library_device_ms=add_dev,
                               device_ms_cold=pass_cold,
                               library_device_ms_cold=add_cold)
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
    worst, closer, inputs = {}, 0, 0
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
            closer += k_err < p_err
            inputs += 1
            del x, got, want, ref, diff
    print(f"layout kernels closer to float64 than their plain versions at "
          f"{closer} of {inputs} inputs", flush=True)

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
    # call, the HIGHEST variant kernel (stft_f32_kernel), the bound and the
    # design floor
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
        floor_ms = direct_dft_ms(frames, "log")
        print(f"layout {name} ({LAYOUT_MAIN},) -> ({frames}, 101) on {card}: "
              f"kernel {ms:.4f} / {ms2:.4f} ms "
              f"({LAYOUT_MAIN / ms / 1e6:.3f} G samples/s), plain "
              f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, HIGHEST "
              f"variant kernel {f32_ms:.4f} ms; bound {bound_ms:.4f} ms by "
              f"{bound_by} ({flop:.4e} FLOP = {ops_ms:.4f} ms; {nbytes} bytes "
              f"= {bytes_ms:.4f} ms), kernel at {bound_ms / ms:.1%} of it; "
              f"design floor {floor_ms:.4f} ms (direct DFT at "
              f"{FP64_PEAK:.3g} FLOP/s), kernel at {floor_ms / ms:.1%} of "
              f"it", flush=True)
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


#: 4i: the exact path at tsne_torch's cap, d = 9 (the AEC latent width);
#: the landmark path's M and landmarks; the CPU comparison's M
TSNE_CAP = 30_000
TSNE_LANDMARK = (200_000, 8_000)
TSNE_CPU_M = 1_000
TSNE_CLASSES = 5
TSNE_FIGURES = ("silh_score_Z.png", "silh_score_X.png", "T-SNE/t-SNE.png",
                "Gallery/gallery.png", "LatentSpace/latent.png",
                "CDF/cdf.png", "PDF/pdf.png")


def planted_classes(m: int, seed: int, d: int = 9, k: int = TSNE_CLASSES):
    """m points in d dimensions from k seeded Gaussian classes (unit
    variance, centres drawn with scale 8, as tests/test_cluster.py's
    blobs): float32 points and their classes."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * 8
    y = rng.integers(0, k, m)
    return (centers[y] + rng.normal(size=(m, d))).astype(np.float32), y


def embedding_nmi(emb, truth, device) -> float:
    """NMI between the port's k-means (10 restarts) of a 2-D embedding and
    `truth`, with as many clusters as truth has labels."""
    from spectrogram_cube_clustering_tpu_torch import cluster

    k = len(np.unique(truth))
    labels, _ = cluster.kmeans(np.asarray(emb, np.float32), k, n_init=10,
                               device=device)
    return cluster.nmi(truth, labels.cpu().numpy())


def neighbour_purity(emb, labels, device, k: int = 10,
                     rows: int = 4096) -> float:
    """The share of each point's k nearest neighbours in an embedding
    that carry its label, over every point (exact k-NN on the card in
    blocks of `rows` queries)."""
    e = torch.from_numpy(np.asarray(emb, np.float32)).to(device)
    lab = torch.from_numpy(np.asarray(labels)).to(device)
    same = 0
    for lo in range(0, len(e), rows):
        d2 = torch.cdist(e[lo:lo + rows], e)
        d2.diagonal(offset=lo).fill_(float("inf"))  # not its own neighbour
        nn = torch.topk(d2, k, dim=1, largest=False).indices
        same += int((lab[nn] == lab[lo:lo + rows, None]).sum())
    return same / (len(e) * k)


def _tree(path: str) -> dict:
    """Every file under path with its size and modification time."""
    out = {}
    for d, _, files in os.walk(path):
        for f in files:
            st = os.stat(os.path.join(d, f))
            out[os.path.relpath(os.path.join(d, f), path)] = (
                st.st_size, st.st_mtime_ns)
    return out


def phase_tsne(device, card, tmp: str, sources: dict, seed: int,
               wave_launches: int, save_inputs: Optional[str] = None
               ) -> None:
    """4i: the on-device t-SNE (`cluster/tsne_torch.py`) and the figures.
    (a) the exact path at M = TSNE_CAP planted points, 2,000 iterations:
    P build and loop times (CUDA events after a warm-up), the wall, peak
    device memory of the build (<= 3 P) and of the loop (<= P + 8 chunk M
    4 B), NMI of its k-means against the classes >= 0.95; (b) the
    landmark path at TSNE_LANDMARK: wall, NMI >= 0.95; (c) the card
    against the CPU at M = TSNE_CPU_M from the same y0: P against a
    float64 oracle (the card's error at most 1.5x the CPU's), from one P
    after 5 iterations y within rtol 1e-3 / atol 1e-6 and the KL within
    rtol 1e-3, after 500 iterations NMI between the two embeddings'
    k-means >= 0.99; (d) `workflow.fit._tsne` with tsne_backend = jax on
    the DEC latents of 4c's waveform run (K1 at its head): the share of
    each point's 10 nearest embedding neighbours with its DEC label >=
    0.90, the k-means NMI against the DEC labels printed (t-SNE splits
    each of these classes into islands, as the JAX package's t-SNE and
    sklearn's do: `tools/tsne_reference_nmi.py` on what `save_inputs`
    receives); (e) where matplotlib imports, run-dc's DEC predict with
    figures on 4c's DEC run writes every figure of the JAX tree; where it
    does not, run-dc with figures raises ImportError naming it and writes
    nothing."""
    import importlib
    import importlib.util
    import types

    from spectrogram_cube_clustering_tpu_torch import cli, cluster
    from spectrogram_cube_clustering_tpu_torch.utils import config_training
    from spectrogram_cube_clustering_tpu_torch.workflow.fit import _tsne

    T = importlib.import_module(
        "spectrogram_cube_clustering_tpu_torch.cluster.tsne_torch")
    cpu = torch.device("cpu")

    # warm-up: cuBLAS, the allocator and every kernel of the loop
    warm, _ = planted_classes(2_000, seed)
    T.tsne_torch(warm, n_iter=300, device=device)
    torch.cuda.synchronize()

    # (a) the exact path at the cap
    x, truth = planted_classes(TSNE_CAP, seed + 1)
    m = len(x)
    perplexity, lr = T.default_hyperparameters(m)
    chunk = T.chunk_rows(m)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()  # earlier phases' tensors
    t0 = time.perf_counter()
    marks[0].record()
    p = T._joint_p(torch.from_numpy(x).to(device), perplexity, chunk=chunk)
    marks[1].record()
    torch.cuda.synchronize()
    build_peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    marks[2].record()
    y0 = T.initial_embedding(m, seed, device)
    (y, _, _), _ = T._optimize(
        p, (y0, torch.zeros_like(y0), torch.ones_like(y0)), 0, lr, 20.0,
        2000, chunk=chunk)
    marks[3].record()
    emb = y.cpu().numpy()
    wall = time.perf_counter() - t0
    loop_peak = torch.cuda.max_memory_allocated() - base
    p_bytes = p.numel() * p.element_size()
    del p, y, y0
    build_ms = marks[0].elapsed_time(marks[1])
    loop_ms = marks[2].elapsed_time(marks[3])
    loop_cap = p_bytes + 8 * chunk * m * 4
    score = embedding_nmi(emb, truth, device)
    print(f"tsne exact on {card}: M {m}, d {x.shape[1]}, chunk {chunk}, "
          f"perplexity {perplexity}, 2000 iterations: P build "
          f"{build_ms:.1f} ms, loop {loop_ms:.1f} ms "
          f"({loop_ms / 2000:.3f} ms per iteration), wall {wall:.3f} s; "
          f"P {p_bytes} B; peak device memory (torch.cuda."
          f"max_memory_allocated above the phase's start) build "
          f"{build_peak} B (gate 3 P = {3 * p_bytes}), loop {loop_peak} B "
          f"(gate P + 8 chunk M 4 B = {loop_cap}); k-means NMI vs the "
          f"classes {score:.4f}", flush=True)
    check(np.isfinite(emb).all() and emb.shape == (m, 2), "tsne exact emb")
    check(build_peak <= 3 * p_bytes, f"tsne build peak {build_peak}")
    check(loop_peak <= loop_cap, f"tsne loop peak {loop_peak}")
    check(score >= 0.95, f"tsne exact NMI {score}")

    # (b) the landmark path
    m_big, landmarks = TSNE_LANDMARK
    x, truth = planted_classes(m_big, seed + 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    marks[0].record()
    emb = T.tsne_torch(x, max_samples=landmarks, device=device)
    marks[1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    score = embedding_nmi(emb, truth, device)
    print(f"tsne landmark on {card}: M {m_big}, {landmarks} landmarks, "
          f"2000 iterations, k = 10: wall {wall:.3f} s (CUDA events "
          f"{marks[0].elapsed_time(marks[1]):.1f} ms); k-means NMI vs the "
          f"classes {score:.4f}", flush=True)
    check(np.isfinite(emb).all() and emb.shape == (m_big, 2),
          "tsne landmark emb")
    check(score >= 0.95, f"tsne landmark NMI {score}")

    # (c) the card against the CPU, from the same y0. P in float32 is
    # known only to the rounding of its sums: its squared distances come
    # from the |x|^2 - 2 x.y + |y|^2 expansion and its bisection from
    # row sums, so the CPU alone, summing the same points in another
    # order, moves entries by up to ~1e-3 on these classes. P is held to
    # a float64 oracle instead: the card's largest relative error at
    # most 1.5x the CPU's. The optimiser is held from one P (the CPU's).
    x, truth = planted_classes(TSNE_CPU_M, seed + 3)
    m = len(x)
    perplexity, lr = T.default_hyperparameters(m)
    chunk = T.chunk_rows(m)
    p_c = T._joint_p(torch.from_numpy(x), perplexity, chunk=chunk)
    p_g = T._joint_p(torch.from_numpy(x).to(device), perplexity,
                     chunk=chunk).cpu()
    p_64 = T._joint_p(torch.from_numpy(x).double(), perplexity, chunk=chunk)
    real = p_64 > 1e-10  # above the 1e-12 floor's neighbourhood

    def worst(p):
        return float(((p - p_64).abs() / p_64)[real].max())

    err_c, err_g = worst(p_c), worst(p_g)
    p_gap = float(((p_g - p_c).abs() / p_c)[real].max())
    n_out = int(((p_g - p_c).abs() > 1e-12 + 1e-5 * p_c.abs()).sum())
    side = {}
    for name, dev in (("cpu", cpu), ("card", device)):
        y0 = T.initial_embedding(m, seed, dev)
        (y, _, _), kl = T._optimize(
            p_c.to(dev), (y0, torch.zeros_like(y0), torch.ones_like(y0)), 0,
            lr, 20.0, 5, chunk=chunk, with_kl=True)
        side[name] = (y.cpu(), kl.cpu())
    (y_c, kl_c), (y_g, kl_g) = side["cpu"], side["card"]
    y_ok = bool(torch.allclose(y_g, y_c, rtol=1e-3, atol=1e-6))
    kl_err = float(((kl_g - kl_c).abs() / kl_c.abs()).max())
    emb_c = T.tsne_torch(x, n_iter=500, seed=seed, device=cpu)
    emb_g = T.tsne_torch(x, n_iter=500, seed=seed, device=device)
    lab_c, _ = cluster.kmeans(emb_c, TSNE_CLASSES, n_init=10, device=device)
    score = embedding_nmi(emb_g, lab_c.cpu().numpy(), device)
    print(f"tsne card vs CPU on {card}: M {m}: P largest relative error vs "
          f"float64 card {err_g:.3e}, CPU {err_c:.3e}; card vs CPU largest "
          f"relative gap {p_gap:.3e}, {n_out} of {m * m} entries outside "
          f"rtol 1e-5 / atol 1e-12; from the CPU's P, after 5 iterations y "
          f"max abs gap {float((y_g - y_c).abs().max()):.3e} (|y| max "
          f"{float(y_c.abs().max()):.3e}), KL largest relative gap "
          f"{kl_err:.3e}; after 500 iterations NMI between the embeddings' "
          f"k-means {score:.4f}", flush=True)
    check(err_g <= 1.5 * err_c, f"tsne P card error {err_g} vs CPU {err_c}")
    check(y_ok, "tsne y card vs CPU after 5 iterations")
    check(kl_err <= 1e-3, f"tsne KL card vs CPU {kl_err}")
    check(score >= 0.99, f"tsne card vs CPU NMI {score}")

    # (d) on the main path: the DEC latents of 4c's waveform run
    check(wave_launches >= 1, "K1 in 4c's waveform run")
    [dec_run] = _dirs_holding(f"{tmp}/B", "DEC_Params_Final.pt")
    z = np.load(os.path.join(dec_run, "Prediction", "Z_DEC.npy"))
    labels = np.load(os.path.join(dec_run, "Prediction", "labels_DEC.npy"))
    config = types.SimpleNamespace(tsne_backend="jax", device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    marks[0].record()
    emb = _tsne(config, z)
    marks[1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    score = embedding_nmi(emb, labels, device)
    purity = neighbour_purity(emb, labels, device)
    print(f"tsne main path on {card}: workflow.fit._tsne (tsne_backend = "
          f"jax) of 4c's waveform DEC latents {z.shape}: wall {wall:.3f} s "
          f"(CUDA events {marks[0].elapsed_time(marks[1]):.1f} ms); "
          f"10-NN label purity {purity:.4f} (latents "
          f"{neighbour_purity(z, labels, device):.4f}); k-means NMI vs the "
          f"DEC labels {score:.4f} (not gated: the classes split into "
          f"islands)", flush=True)
    if save_inputs:
        os.makedirs(os.path.dirname(os.path.abspath(save_inputs)),
                    exist_ok=True)
        np.savez_compressed(save_inputs, z=z, labels=labels, emb=emb)
        print(f"tsne main path inputs written to {save_inputs}", flush=True)
    check(np.isfinite(emb).all() and emb.shape == (len(z), 2),
          "tsne main path emb")
    check(purity >= 0.90, f"tsne main path 10-NN purity {purity}")

    # (e) the figures: drawn where matplotlib imports, refused where not
    universal = sources["waveform"][0]
    ini = config_training(
        {"savepath": f"{tmp}/B/Outputs", "configpath": f"{tmp}/figures",
         "transform": "sample_norm_cent", **universal},
        {"tb": "False", "show": "False", "figures": "True",
         "tsne_backend": "jax", "model": "DEC", "mode": "predict",
         "saved_weights": os.path.join(dec_run, "DEC_Params_Final.pt")})
    pred = os.path.join(dec_run, "Prediction")
    if importlib.util.find_spec("matplotlib") is not None:
        t0 = time.perf_counter()
        cli.run_dc(init_path=ini)
        missing = [f for f in TSNE_FIGURES
                   if not os.path.exists(os.path.join(pred, f))]
        print(f"tsne figures on {card}: run-dc DEC predict with figures "
              f"{time.perf_counter() - t0:.3f} s; missing {missing}",
              flush=True)
        check(not missing, f"predict figures missing {missing}")
    else:
        before = _tree(dec_run)
        try:
            cli.run_dc(init_path=ini)
        except ImportError as exc:
            said = str(exc)
        else:
            said = None
        unchanged = _tree(dec_run) == before
        print(f"tsne figures on {card}: no matplotlib; run-dc with figures "
              f"raised ImportError {said!r}; the run dir unchanged "
              f"{unchanged}", flush=True)
        check(said is not None and "matplotlib" in said,
              f"run-dc figures without matplotlib: {said}")
        check(unchanged, "run-dc figures wrote into the run dir")


#: 4j: each mesh run's time limit for its rank processes (s)
MESH_TIMEOUT = 600
#: 4j: (name, ranks, backend on a card, the AEC losses' rtol against the
#: single-device run); the reference runs on one device without a group.
#: One rank sums nothing, so its losses are the reference's (0.0
#: measured). Two ranks add two partial gradient sums, and Adam
#: amplifies that reordering over the 1,377 steps to 1.6e-4, as far as
#: the card's own run-to-run spread (1.5e-4 to 2.1e-4, 4c's default cuDNN
#: algorithms against the deterministic ones; PERF.md §6): a 1e-4 gate
#: failed there, so (b) takes 4b's trajectory rule, 1e-3, and the
#: arithmetic is gated on one epoch's gradients instead (MESH_GRAD_RTOL)
MESH_RUNS = (("single", 1, None, 0.0), ("a", 1, "nccl", 1e-4),
             ("b", 2, "gloo", 1e-3))
#: 4j(b): an epoch of 100 windows in batches of 64 (the padded last batch
#: holds 32 real rows in rank 0's block and 4 in rank 1's) from seeded
#: weights: its loss and each step's gradient summed over the ranks
#: against one device's, relative to the gradient's norm (float32 sums
#: in another order)
MESH_GRAD_RTOL = 1e-5


class _GradRecorder:
    """An optimizer stand-in for `train.TrainState`: keeps each step's
    gradients (summed over the ranks by the state) and leaves the params
    as they are."""

    def __init__(self, params):
        self.params = list(params)
        self.grads = []

    def step(self):
        self.grads.append(torch.cat([p.grad.reshape(-1)
                                     for p in self.params]))

    def zero_grad(self, set_to_none=True):
        for p in self.params:
            p.grad = None


def uneven_epoch(mesh, windows: torch.Tensor) -> tuple:
    """(loss, gradients) of one AEC epoch over `windows` in batches of 64
    from seeded weights, the state summing the gradients over `mesh` (one
    device with None)."""
    from spectrogram_cube_clustering_tpu_torch import models, train
    from spectrogram_cube_clustering_tpu_torch.train.aec import train_epoch

    model = models.AEC(generator=torch.Generator().manual_seed(0),
                       device=windows.device)
    rec = _GradRecorder(model.parameters())
    loss = train_epoch(train.TrainState(model=model, optimizer=rec,
                                        mesh=mesh),
                       train.make_batched_data(windows, 64, mesh))
    return loss, torch.stack(rec.grads)


def _outputs_tree(root: str) -> set:
    """Every path under root/Outputs, serials blanked and figures left
    out (4i(e) may add figures to 4c's run where matplotlib imports)."""
    import re

    out = set()
    for d, dirs, files in os.walk(os.path.join(root, "Outputs")):
        for f in dirs + files:
            if not f.endswith(".png"):
                rel = os.path.relpath(os.path.join(d, f), root)
                out.add(re.sub(r"\d{8}T\d{12}", "SERIAL", rel))
    return out


def mesh_child(rank: int, world: int, port: int, backend: Optional[str],
               root: str, args_path: str, out_path: str) -> int:
    """One rank of phase 4j, in its own process: join the group on the
    args' device (with `backend` None, run on the device alone), run 4c's
    five waveform stages over the mesh with deterministic cuDNN
    algorithms, and with two ranks the sharded STFT and GMM; write the
    results to out_path."""
    import torch.distributed as dist

    from spectrogram_cube_clustering_tpu_torch import core, parallel
    from spectrogram_cube_clustering_tpu_torch.cluster import nmi
    from spectrogram_cube_clustering_tpu_torch.ops import cuda_stft

    with open(args_path) as f:
        args = json.load(f)
    # the card's default algorithms differ run to run (4c's run lies
    # ~1e-4 from a deterministic one): every run of 4j takes the
    # deterministic ones, so a gap is the mesh's
    torch.backends.cudnn.deterministic = True
    if backend is None:
        device, mesh = core.resolve_device(args["device"]), None
        if device.type == "cuda":
            torch.cuda.set_device(device)
    else:
        device = core.initialize_distributed(
            f"127.0.0.1:{port}", world, rank, device=args["device"],
            backend=backend)
        mesh = core.make_data_mesh()
    core.fp32_policy()
    card = card_line()
    cuda_stft.LAUNCHES = 0  # the stages' run starts here
    _, walls, _, peaks = run_five_stages(
        root, args["universal"], card, f"mesh {world} x {backend} rank "
        f"{rank}", mesh=mesh)
    out = {"rank": rank, "walls": walls, "peaks": peaks,
           "stage_launches": cuda_stft.LAUNCHES}  # ... and ends here
    if world > 1:
        # 4c's waveform cut to a multiple of world x hop, the JAX
        # package's alignment: (16, 2^20) -> (16, 1,048,400)
        wave = np.load(args["wave"], mmap_mode="r")
        t = wave.shape[1] - wave.shape[1] % (world * 100)
        wave = torch.from_numpy(np.ascontiguousarray(wave[:, :t]))
        wave = wave.to(device)
        lo, hi = mesh.block(t)
        shard = wave[:, lo:hi].contiguous()
        before = cuda_stft.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = parallel.sharded_spectrogram(shard, mesh)
        torch.cuda.synchronize()
        out["spec_s"] = time.perf_counter() - t0
        out["spec_launches"] = cuda_stft.LAUNCHES - before
        want = cuda_stft.spectrogram(wave)  # K1 on the whole waveform
        out["spec_shape"] = list(got.shape)
        out["spec_err"] = float((got - want).abs().max())
        t0 = time.perf_counter()
        labels = parallel.sharded_gmm(np.load(args["z"]), 5, mesh,
                                      n_init=100, kmeans_n_iter=1000)[0]
        out["gmm_s"] = time.perf_counter() - t0
        out["gmm_nmi"] = nmi(np.load(args["dense"]), labels.cpu().numpy())
        # the sum itself: an epoch with an uneven padded batch, summed
        # over the ranks against one device (100 windows of channel 0)
        from spectrogram_cube_clustering_tpu_torch.signal.stft import (
            spectrogram_windows,
        )

        windows = spectrogram_windows(wave[0, :40_100])
        (l1, g1), (lm, gm) = (uneven_epoch(m, windows) for m in (None, mesh))
        out["uneven"] = (len(windows), abs(lm - l1) / l1,
                         float((gm - g1).norm() / g1.norm()))
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    with open(out_path, "w") as f:
        json.dump(out, f)
    if mesh is not None:
        dist.destroy_process_group()
    return 0


def run_mesh_ranks(world: int, backend: Optional[str], root: str,
                   args_path: str, tmp: str) -> list:
    """Start `world` processes of `mesh_child` on a free local port, wait
    for them (the first failure, or MESH_TIMEOUT, kills the rest), and
    return each rank's results; a failed rank's log tail goes to stderr
    and fails the phase. No process outlives this call."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", NCCL_SOCKET_IFNAME="lo")
    procs, logs, outs = [], [], []
    try:
        for rank in range(world):
            outs.append(f"{root}.rank{rank}.json")
            logs.append(f"{root}.rank{rank}.log")
            code = (f"import sys; sys.path.insert(0, {here!r}); "
                    f"import chip_smoke; sys.exit(chip_smoke.mesh_child("
                    f"{rank}, {world}, {port}, {backend!r}, {root!r}, "
                    f"{args_path!r}, {outs[-1]!r}))")
            with open(logs[-1], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", code], stdout=log,
                    stderr=subprocess.STDOUT, cwd=here, env=env))
        deadline = time.monotonic() + MESH_TIMEOUT
        while (any(p.poll() is None for p in procs)
               and not any(p.returncode for p in procs)
               and time.monotonic() < deadline):
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            with open(log) as f:
                tail = f.read()[-6000:]
            print(f"mesh {world} x {backend} rank {rank} ended with "
                  f"{p.returncode}:\n{tail}", file=sys.stderr, flush=True)
    check(all(p.returncode == 0 for p in procs),
          f"mesh {world} x {backend}: ranks {[p.returncode for p in procs]}")
    results = []
    for path in outs:
        with open(path) as f:
            results.append(json.load(f))
    return results


def phase_multigpu(device, card, tmp: str, sources: dict) -> int:
    """4j: 4c's waveform stages on one device, over a one-rank NCCL group
    and over two ranks on one card over gloo, each in child processes
    with deterministic cuDNN algorithms; the mesh runs held to the
    single-device one, and the sharded STFT and GMM on two ranks. Returns
    K1's launches in the ranks' main paths (the stages and the sharded
    STFT)."""
    from spectrogram_cube_clustering_tpu_torch import cluster

    [dec_run] = _dirs_holding(f"{tmp}/B", "DEC_Params_Final.pt")
    [aec_run] = _dirs_holding(f"{tmp}/B", "AEC_history.csv")
    default_aec = aec_history(aec_run)  # 4c's, default cuDNN algorithms
    z_path = os.path.join(dec_run, "Prediction", "Z_DEC.npy")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dense = cluster.gmm(np.load(z_path), 5, n_init=100, kmeans_max_iter=1000,
                        device=device)[0]
    dense_s = time.perf_counter() - t0
    np.save(f"{tmp}/mesh_dense.npy", dense.cpu().numpy())
    args_path = f"{tmp}/mesh_args.json"
    with open(args_path, "w") as f:
        json.dump({"universal": sources["waveform"][0],
                   "wave": sources["waveform"][0]["fname_dataset"],
                   "z": z_path, "dense": f"{tmp}/mesh_dense.npy",
                   "device": str(device)}, f)
    def gap(a, b):
        return (float(np.max(np.abs(np.asarray(a) - b) / np.abs(b)))
                if len(a) == len(b) else float("inf"))

    launches = 0
    single = None
    for name, world, backend, rtol in MESH_RUNS:
        if device.type != "cuda" and backend is not None:
            backend = "gloo"  # a rehearsal on the CPU
        root = f"{tmp}/mesh_{name}"
        t0 = time.perf_counter()
        ranks = run_mesh_ranks(world, backend, root, args_path, tmp)
        wall = time.perf_counter() - t0
        [run] = _dirs_holding(root, "AEC_history.csv")
        hist = aec_history(run)
        [pred] = _dirs_holding(root, "labels_DEC.npy")
        labels = np.load(os.path.join(pred, "labels_DEC.npy"))
        tree = _outputs_tree(root)
        if single is None:
            single = {"aec": hist, "labels": labels, "tree": tree}
            print(f"multi-GPU 4j({name}) on {card}: the five waveform "
                  f"stages on one device in {wall:.3f} s (process "
                  f"included), the reference of 4j; AEC losses {hist}, "
                  f"4c's run with the default cuDNN algorithms "
                  f"{default_aec} (largest relative gap "
                  f"{gap(hist, default_aec):.3e}, the card's own spread); "
                  f"artifact tree equal to 4c's "
                  f"{tree == _outputs_tree(f'{tmp}/B')}", flush=True)
        gap_aec = gap(hist, single["aec"])
        score = cluster.nmi(single["labels"], labels)
        if name != "single":
            print(f"multi-GPU 4j({name}) on {card}: {world} rank(s) over "
                  f"{backend}, the five waveform stages in {wall:.3f} s "
                  f"(processes included); AEC losses {hist} against the "
                  f"single-device run's {single['aec']} (largest relative "
                  f"gap {gap_aec:.3e}); DEC labels NMI vs the "
                  f"single-device run {score:.4f}; artifact tree equal to "
                  f"the single-device run's {tree == single['tree']} "
                  f"({len(tree)} paths)", flush=True)
        for r in ranks:
            walls = {k: round(v, 3) for k, v in r["walls"].items()}
            print(f"multi-GPU 4j({name}) rank {r['rank']} on {card}: stage "
                  f"walls {walls} s; peak device memory above each stage's "
                  f"start {r['peaks']} bytes, the process's peak "
                  f"{r['peak_bytes']} bytes; K1 launches in the stages "
                  f"{r['stage_launches']}", flush=True)
            check(r["stage_launches"] >= 4,
                  f"4j({name}) rank {r['rank']} K1 launches")
            if name != "single":
                launches += r["stage_launches"]
        check(gap_aec <= rtol,
              f"4j({name}) AEC losses {hist} vs {single['aec']}")
        check(score >= 0.99, f"4j({name}) DEC labels NMI {score}")
        check(tree == single["tree"],
              f"4j({name}) tree differs: {sorted(tree ^ single['tree'])}")
        if world > 1:
            for r in ranks:
                print(f"multi-GPU 4j({name}) rank {r['rank']} on {card}: "
                      f"sharded_spectrogram {tuple(r['spec_shape'])} over "
                      f"{world} ranks {r['spec_s']:.4f} s (K1 launches "
                      f"{r['spec_launches']}), max_abs_err vs K1 on the "
                      f"whole waveform {r['spec_err']:.3e}; sharded_gmm of "
                      f"4c's DEC latents {r['gmm_s']:.3f} s, NMI vs the "
                      f"dense gmm ({dense_s:.3f} s) {r['gmm_nmi']:.4f}",
                      flush=True)
                check(r["spec_launches"] >= 1,
                      f"4j rank {r['rank']} sharded STFT launches")
                check(r["spec_err"] <= K1_GAP,
                      f"4j rank {r['rank']} sharded STFT {r['spec_err']}")
                check(r["gmm_nmi"] >= 0.99,
                      f"4j rank {r['rank']} sharded GMM NMI {r['gmm_nmi']}")
                launches += r["spec_launches"]
                n, loss_gap, grad_gap = r["uneven"]
                print(f"multi-GPU 4j({name}) rank {r['rank']} on {card}: an "
                      f"AEC epoch of {n} windows in batches of 64 (the "
                      f"padded last batch 32 + 4 real rows over the ranks) "
                      f"summed over {world} ranks against one device: loss "
                      f"relative gap {loss_gap:.3e}, gradients {grad_gap:.3e} "
                      f"of their norm", flush=True)
                check(n == 100 and loss_gap <= MESH_GRAD_RTOL
                      and grad_gap <= MESH_GRAD_RTOL,
                      f"4j rank {r['rank']} uneven epoch {r['uneven']}")
    return launches


#: 4k: each mesh server's rank processes: collective timeout (s, the
#: shortened one the idle pause outlasts) and time limit (s)
SERVE_GROUP_TIMEOUT = 10.0
SERVE_TIMEOUT = 300
#: 4k: (name, ranks, backend on a card)
SERVE_MESHES = (("a", 1, "nccl"), ("b", 2, "gloo"))
#: 4k: z and q of every mesh answer against phase 4's single-device
#: predictor (the JAX package's mesh-vs-single-device tolerance)
SERVE_MESH_TOL = dict(rtol=1e-5, atol=1e-7)
SERVE_REPS = 5  # timed repeats of each waveform request, for the p50


def serve_child(rank: int, world: int, port: int, backend: str, argv: list,
                out_path: str) -> int:
    """One rank of a 4k mesh server, in its own process: join the group
    on the card with the shortened timeout, run `scc-serve-torch --mesh`
    (`serve_http.main(argv)`; rank 0 serves HTTP until SIGINT, the
    others run the worker loop until rank 0 stops them), then write this
    rank's K1 launches and peak device memory to out_path."""
    from spectrogram_cube_clustering_tpu_torch import core, serve_http
    from spectrogram_cube_clustering_tpu_torch.ops import cuda_stft

    core.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                device=argv[argv.index("--device") + 1],
                                backend=backend, timeout=SERVE_GROUP_TIMEOUT)
    torch.cuda.reset_peak_memory_stats()
    cuda_stft.LAUNCHES = 0  # the server's life starts here
    rc = serve_http.main(argv)
    with open(out_path, "w") as f:
        json.dump({"rank": rank, "launches": cuda_stft.LAUNCHES,
                   "peak_bytes": torch.cuda.max_memory_allocated()}, f)
    return rc


def start_mesh_server(world: int, backend: str, argv: list, root: str
                      ) -> tuple:
    """Start `world` processes of `serve_child` on a free local port and
    wait for rank 0's address. Returns (processes, logs, outs, url); a
    rank that ends first, or SERVE_TIMEOUT, kills them all and fails."""
    import re
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", NCCL_SOCKET_IFNAME="lo")
    procs, logs, outs = [], [], []
    for rank in range(world):
        outs.append(f"{root}.rank{rank}.json")
        logs.append(f"{root}.rank{rank}.log")
        code = (f"import sys; sys.path.insert(0, {here!r}); "
                f"import chip_smoke; sys.exit(chip_smoke.serve_child("
                f"{rank}, {world}, {port}, {backend!r}, {argv!r}, "
                f"{outs[-1]!r}))")
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-u", "-c", code], stdout=log,
                stderr=subprocess.STDOUT, cwd=here, env=env))
    deadline = time.monotonic() + SERVE_TIMEOUT
    while time.monotonic() < deadline:
        with open(logs[0]) as f:
            m = re.search(r"on (http://[\d.]+:\d+)", f.read())
        if m:
            return procs, logs, outs, m.group(1)
        if any(p.poll() is not None for p in procs):
            break
        time.sleep(0.2)
    stop_mesh_server(procs, logs, kill=True)
    raise RuntimeError(f"check failed: 4k mesh server {root} did not start")


def stop_mesh_server(procs: list, logs: list, kill: bool = False) -> list:
    """SIGINT to rank 0 (its server_close stops the other ranks), then
    wait for every rank; kill what is left after SERVE_TIMEOUT. Prints a
    failed rank's log tail; returns the exit codes."""
    import signal

    if not kill and procs[0].poll() is None:
        procs[0].send_signal(signal.SIGINT)
    deadline = time.monotonic() + (0 if kill else SERVE_TIMEOUT)
    while (any(p.poll() is None for p in procs)
           and time.monotonic() < deadline):
        time.sleep(0.1)
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            with open(log) as f:
                tail = f.read()[-6000:]
            print(f"4k rank {rank} ended with {p.returncode}:\n{tail}",
                  file=sys.stderr, flush=True)
    return [p.returncode for p in procs]


def check_mesh_answer(name: str, got: dict, want: dict) -> None:
    """A mesh answer against the single-device one: z and q within
    SERVE_MESH_TOL, labels equal where q's top-two gap exceeds 1e-4,
    windows_per_channel equal."""
    ok = all(np.allclose(got[k], want[k], **SERVE_MESH_TOL)
             for k in ("q", "z"))
    top2 = np.sort(want["q"], axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > LABEL_GAP
    agree = bool((got["labels"][clear] == want["labels"][clear]).all())
    err = {k: float(np.abs(got[k] - want[k]).max()) if len(want[k]) else 0.0
           for k in ("q", "z")}
    check(ok and agree and got["q"].shape == want["q"].shape,
          f"4k {name}: q/z max_abs_err {err}, labels equal where clear "
          f"{agree}")
    if "windows_per_channel" in want:
        check(got["windows_per_channel"].tolist()
              == want["windows_per_channel"].tolist(),
              f"4k {name} windows_per_channel")


def phase_serve_mesh(device, card: str, sd: dict, predictor, frontend,
                     windows_np: np.ndarray, waves_np: dict, tmp: str) -> int:
    """4k: phase 4's seeded DEC(5) as a .pt behind `scc-serve-torch
    --mesh --waveform` in child processes, (a) one NCCL rank and (b) two
    gloo ranks on the one card, each with the two-pass and the fused
    waveform route; this process is the HTTP client. Every answer is held
    to phase 4's single-device predictor and frontend; on (b)'s fused
    route one idle pause outlasts the group's timeout. Returns K1's
    launches on the requests (each rank's count less its warm-up's
    one)."""
    ckpt = f"{tmp}/serve_mesh_dec.pt"
    torch.save(sd, ckpt)
    window_reqs = {f"windows_{n}": windows_np[:n] for n in (1, 5, 1000, 4096)}
    want = {name: predictor(arr) for name, arr in window_reqs.items()}
    want.update({name: frontend(arr) for name, arr in waves_np.items()})
    launches = 0
    for name, world, backend in SERVE_MESHES:
        if device.type != "cuda":
            backend = "gloo"  # a rehearsal on the CPU
        for route in ("two-pass", "fused"):
            root = f"{tmp}/serve_mesh_{name}_{route}"
            argv = [ckpt, "--mesh", "--n-clusters", "5", "--max-batch",
                    "1024", "--host", "127.0.0.1", "--port", "0",
                    "--waveform", "--device", str(device)]
            if route == "fused":
                argv.append("--fuse-waveform")
            t0 = time.perf_counter()
            procs, logs, outs, url = start_mesh_server(world, backend, argv,
                                                       root)
            start_s = time.perf_counter() - t0
            p50, idle = {}, None
            try:
                with urllib.request.urlopen(f"{url}/healthz",
                                            timeout=60) as resp:
                    meta = json.loads(resp.read())
                check(meta.get("mesh") == world
                      and meta["waveform"]["fused"] == (route == "fused"),
                      f"4k({name}) {route} healthz {meta}")
                for req, arr in window_reqs.items():
                    status, got, _ = post(f"{url}/predict", arr)
                    check(status == 200, f"4k {req} status {status}")
                    check_mesh_answer(f"({name}) {route} {req}", got,
                                      want[req])
                for req, arr in waves_np.items():
                    times = []
                    for _ in range(1 + SERVE_REPS):
                        status, got, secs = post(f"{url}/predict_waveform",
                                                 arr)
                        check(status == 200, f"4k {req} status {status}")
                        times.append(secs)
                    check_mesh_answer(f"({name}) {route} {req}", got,
                                      want[req])
                    p50[req] = float(np.median(times[1:])) * 1e3
                if name == "b" and route == "fused":
                    time.sleep(1.2 * SERVE_GROUP_TIMEOUT)
                    status, got, _ = post(f"{url}/predict",
                                          window_reqs["windows_5"])
                    check(status == 200, f"4k after the idle pause {status}")
                    check_mesh_answer(f"({name}) {route} after an idle "
                                      f"{1.2 * SERVE_GROUP_TIMEOUT:.0f} s",
                                      got, want["windows_5"])
                    idle = 1.2 * SERVE_GROUP_TIMEOUT
            finally:
                codes = stop_mesh_server(procs, logs)
            check(codes == [0] * world,
                  f"4k({name}) {route} ranks ended with {codes}")
            ranks = []
            for path in outs:
                with open(path) as f:
                    ranks.append(json.load(f))
            # the fused route's warm-up launches K1 once on every rank,
            # the two-pass route's once on rank 0
            fused_chunks = (1 + SERVE_REPS) * len(waves_np)
            for r in ranks:
                warm = 1 if (route == "fused" or r["rank"] == 0) else 0
                served = r["launches"] - warm
                if route == "fused":
                    check(served >= fused_chunks,
                          f"4k({name}) fused rank {r['rank']} K1 launches "
                          f"{served} < {fused_chunks}")
                launches += served
            print(f"mesh serving 4k({name}) on {card}: {world} rank(s) over "
                  f"{backend}, {route} route; server start "
                  f"{start_s:.3f} s (processes, warm-up); p50 "
                  + "; ".join(f"{k} {v:.2f} ms" for k, v in p50.items())
                  + f"; K1 launches per rank on the requests "
                  f"{[r['launches'] - (1 if route == 'fused' or r['rank'] == 0 else 0) for r in ranks]}"
                  f"; peak device memory per rank "
                  f"{[r['peak_bytes'] for r in ranks]} bytes"
                  + (f"; answered after an idle {idle:.0f} s > the group's "
                     f"{SERVE_GROUP_TIMEOUT:.0f} s timeout" if idle else ""),
                  flush=True)
    return launches


#: 4l: the swept K of the cluster-count diagnostics
KM_METRICS_K = "3, 4, 5, 6"
KM_METRICS_COLUMNS = ["n_clusters", "inertia", "silhouette", "gap_gaussian",
                      "gap_uniform"]
#: 4l: the card's data inertias against the port's same sweep on the CPU:
#: the latents are well clustered, so both find the same minimum at every K
KM_METRICS_RTOL = 1e-3


def phase_km_metrics(device, card: str, tmp: str) -> None:
    """4l: the GMM stage with km_metrics = True (figures off) over K = 3-6
    on 4c's waveform run's Z_AEC (41,936 x 9), on the card through
    `cli.run_dc`: cluster_stats.csv must hold the 4 K with the JAX
    columns and finite values, its data inertias within KM_METRICS_RTOL
    of `cluster.gap_statistic` of the same subsample on the CPU. Prints
    the gaps, the silhouettes and the seconds of the stage and the CPU
    sweep."""
    import shutil

    from spectrogram_cube_clustering_tpu_torch import cli, cluster
    from spectrogram_cube_clustering_tpu_torch.utils import config_training

    [aec_run] = _dirs_holding(f"{tmp}/B", "AEC_history.csv")
    run = f"{tmp}/km/{os.path.basename(aec_run)}"
    os.makedirs(f"{run}/Prediction")
    for rel in ("AEC_Params_Final.pt", "Prediction/Z_AEC.npy"):
        shutil.copy(os.path.join(aec_run, rel), os.path.join(run, rel))
    ini = config_training(
        {"savepath": f"{tmp}/km/Outputs", "configpath": f"{tmp}/km/Config",
         "transform": "sample_norm_cent",
         "fname_dataset": f"{tmp}/wave.npy", "datafiletype": "waveform"},
        {"tb": "False", "show": "False", "figures": "False",
         "model": "GMM", "mode": "fit",
         "saved_weights": f"{run}/AEC_Params_Final.pt",
         "km_n_init": 100, "km_max_iter": 1000, "km_metrics": "True"},
        {"n_clusters": KM_METRICS_K})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cfg = cli.run_dc(init_path=ini)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    check(cfg.device.type == device.type, f"4l ran on {cfg.device}")
    with open(os.path.join(cfg.savepath_exp, "cluster_stats.csv")) as f:
        rows = list(csv.reader(f))
    table = np.asarray(rows[1:], dtype=np.float64)
    k_list = [int(k) for k in KM_METRICS_K.split(",")]
    check(rows[0] == KM_METRICS_COLUMNS and table.shape == (4, 5)
          and table[:, 0].tolist() == k_list and np.isfinite(table).all(),
          f"4l cluster_stats.csv {rows}")
    z = np.load(f"{run}/Prediction/Z_AEC.npy")
    # the diagnostics' subsample: silh_max_samples (20,000) rows drawn with
    # the config's seed (2009), both defaults
    sel = (np.sort(np.random.default_rng(2009).choice(len(z), 20000,
                                                      replace=False))
           if len(z) > 20000 else np.arange(len(z)))
    t0 = time.perf_counter()
    cpu = cluster.gap_statistic(z[sel], k_list, seed=2009, device="cpu")
    cpu_s = time.perf_counter() - t0
    rel = np.abs(table[:, 1] - cpu["inertia"]) / cpu["inertia"]
    print(f"km_metrics 4l on {card}: GMM stage over K {k_list} on "
          f"{len(z)} x {z.shape[1]} latents (diagnostics on {len(sel)}) in "
          f"{stage_s:.3f} s; inertia {table[:, 1].tolist()}; silhouette "
          f"{table[:, 2].tolist()}; gap gaussian {table[:, 3].tolist()}; gap "
          f"uniform {table[:, 4].tolist()}; the CPU's gap_statistic sweep "
          f"{cpu_s:.3f} s, inertia {cpu['inertia'].tolist()}, relative gap "
          f"{rel.max():.3e} (bound {KM_METRICS_RTOL})", flush=True)
    check(rel.max() <= KM_METRICS_RTOL,
          f"4l card vs CPU inertias {table[:, 1]} vs {cpu['inertia']}")


#: 4m: the RIS event catalog, planted as benchmarks/h5_workflow_tpu.py
#: plants it: raw rows (88, 101) holding the time row and frequency
#: column the crop drops, one of H5_CLASSES frequency bands per event
H5_EVENTS = 32_768
H5_CLASSES = 5
H5_RAW = (88, 101)
H5_HW = (87, 100)
H5_BLOCK = 4096  # events generated (and written) at a time
#: 4m: the JAX chip protocol (h5_workflow_tpu.py:98-131): AEC 12 epochs,
#: batch 512, no early stopping; GMM K = 5 with 100 restarts; DEC with
#: init = load, 12 epochs, batch 512
H5_PROTOCOL = {
    "aec": ({"n_epochs": 12, "early_stopping": "False"},
            {"batch_size": "512", "lr": "0.001"}),
    "dec": ({"n_epochs": 12},
            {"batch_size": "512", "lr": "0.0005", "n_clusters": "5",
             "gamma": "0.01", "tol": "0.001"}),
}
#: 4m: windows of the CPU-against-card epoch
H5_CPU_M = 2048
#: 4m(c): AEC and DEC epochs of the TensorBoard run
H5_TB_EPOCHS = (2, 1)
#: 4m(e): the span `annotate` puts around the traced epoch
H5_SPAN = "scc_aec_epoch"


def build_h5_catalog(root: str, seed: int) -> tuple:
    """The synthetic RIS catalog of 4m: H5_EVENTS raw (88, 101) rows with
    planted bands, cropped and `vec_norm`-normalized with the port's
    `crop_specgram` / `normalize_specgram` (the default pipeline of
    `SeismicDataset` that `convert_h5_to_np` runs) into the (M, 1, 87,
    100) float32 dump `convert_h5_to_np` writes, block by block; where
    h5py imports, the raw rows also as a `.h5` catalog (Spectrogram,
    Trace, Catalogue). And the TraVal index pickle `save_traval_index`
    writes for M = H5_EVENTS at `seed` (every row but 0, 80/20). Returns
    (dump, index pickle, .h5 or None, planted classes)."""
    import importlib.util
    import pickle

    from spectrogram_cube_clustering_tpu_torch.data.h5 import (
        crop_specgram,
        normalize_specgram,
    )

    m = H5_EVENTS
    rng = np.random.default_rng(seed + 11)
    truth = np.arange(m) % H5_CLASSES
    bands = np.zeros((H5_CLASSES, H5_RAW[0], 1))
    for k in range(H5_CLASSES):
        bands[k, 4 + 16 * k:18 + 16 * k] = 1.0
    dump_path = f"{root}/catalog.npy"
    dump = np.lib.format.open_memmap(dump_path, mode="w+", dtype=np.float32,
                                     shape=(m, 1, *H5_HW))
    h5_path, f = None, None
    if importlib.util.find_spec("h5py") is not None:
        import h5py

        h5_path = f"{root}/catalog.h5"
        f = h5py.File(h5_path, "w")
        g = f.require_group("/4.0")
        spec_ds = g.create_dataset("Spectrogram", (m, *H5_RAW), np.float64)
        trace_ds = g.create_dataset("Trace", (m, 200), np.float64)
        g.create_dataset("Catalogue", data=np.array(
            [json.dumps({"Station": "DR01",
                         "StartTime": "2015-01-01 00:00:00.0"})] * m,
            dtype=h5py.string_dtype()))
    try:
        for lo in range(0, m, H5_BLOCK):
            hi = min(lo + H5_BLOCK, m)
            raw = rng.normal(scale=0.1, size=(hi - lo, *H5_RAW))
            amp = 3.0 + rng.normal(scale=0.2, size=(hi - lo, 1, 1))
            raw[:, :, 1:] += bands[truth[lo:hi]] * amp
            raw[:, 87, 1:] = np.arange(100)
            raw[:, 0:87, 0] = np.linspace(0, 10, 87)
            dump[lo:hi, 0] = normalize_specgram(
                crop_specgram(raw.astype(np.float32)), "vec_norm")
            if f is not None:
                spec_ds[lo:hi] = raw
                trace_ds[lo:hi] = rng.normal(size=(hi - lo, 200))
    finally:
        if f is not None:
            f.close()
    dump.flush()
    del dump
    index = np.random.default_rng(seed).choice(np.arange(1, m), size=m - 1,
                                               replace=False)
    split = int(0.8 * len(index))
    index_path = f"{root}/TraValIndex_M={m}.pkl"
    with open(index_path, "wb") as fh:
        pickle.dump({"index_tra": index[:split], "index_val": index[split:]},
                    fh)
    return dump_path, index_path, h5_path, truth


def _tree_with_dirs(path: str) -> dict:
    """`_tree`, and every directory under path."""
    out = _tree(path)
    out.update({os.path.relpath(d, path) + "/": None
                for d, _, _ in os.walk(path)})
    return out


def _child_pids() -> set:
    """The live child processes of this one."""
    me, kids = os.getpid(), set()
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as fh:
                stat = fh.read()
        except OSError:
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) == me:
            kids.add(int(pid))
    return kids


def _refused(what: str, package: str, fn, tree_root: str,
             phase: str = "h5 4m") -> str:
    """Call fn, which must raise ImportError naming `package` and leave
    `tree_root` as it was; returns the message."""
    before = _tree_with_dirs(tree_root)
    try:
        fn()
    except ImportError as exc:
        said = str(exc)
    else:
        said = None
    unchanged = _tree_with_dirs(tree_root) == before
    print(f"{phase}: without {package}, {what} raised ImportError {said!r}; "
          f"the tree unchanged {unchanged}", flush=True)
    check(said is not None and package in said,
          f"{what} without {package}: {said}")
    check(unchanged, f"{what} wrote into {tree_root} before refusing")
    return said


def tb_scalars(run_dir: str) -> dict:
    """tag -> steps of every scalar in the event files under run_dir
    (tensorboard's EventAccumulator)."""
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    out = {}
    for d, _, files in os.walk(run_dir):
        if any(f.startswith("events.out.tfevents") for f in files):
            acc = EventAccumulator(d)
            acc.Reload()
            for tag in acc.Tags()["scalars"]:
                out[tag] = [e.step for e in acc.Scalars(tag)]
    return out


def phase_h5_catalog(device, card: str, cuda_stft, tmp: str,
                     seed: int) -> None:
    """4m: the RIS event catalog at its (87, 100) geometry on the card:
    (a) the five stages from the `convert_h5_to_np` dump with the TraVal
    split, the CPU against the card on 2,048 windows; (b) the `.h5` and
    stream routes where h5py imports, else their refusals and the four H5
    tools'; (c) TensorBoard where it imports, else its refusal; (d) the
    checkpoint tools; (e) `utils.profiling` around one AEC epoch. K1 must
    not launch: the catalog holds spectrograms."""
    import importlib.util

    from spectrogram_cube_clustering_tpu_torch import cli, models, train
    from spectrogram_cube_clustering_tpu_torch import workflow
    from spectrogram_cube_clustering_tpu_torch.ops.normalize import (
        make_normalizer,
    )
    from spectrogram_cube_clustering_tpu_torch.train.checkpoint import (
        restore,
    )
    from spectrogram_cube_clustering_tpu_torch.utils import (
        config_training,
        load_config,
        profiling,
    )

    cuda_stft.LAUNCHES = 0  # the phase's run starts here
    phase_t0 = time.perf_counter()
    root = f"{tmp}/h5"
    os.makedirs(root)
    t0 = time.perf_counter()
    dump, index, h5_path, truth = build_h5_catalog(root, seed)
    print(f"h5 4m: catalog of {H5_EVENTS} events, {H5_CLASSES} planted "
          f"classes, raw {H5_RAW} -> dump {os.path.getsize(dump)} bytes "
          f"(M, 1, {H5_HW[0]}, {H5_HW[1]}) float32 and the TraVal pickle in "
          f"{time.perf_counter() - t0:.3f} s (.h5 also: "
          f"{h5_path is not None})", flush=True)
    np_source = {"fname_dataset": dump, "datafiletype": "h5",
                 "h5_ftype": "np", "indexpath": index}
    inis = f"{tmp}/h5_inis"

    def ini(universal, params, hp=None, savepath=f"{root}/np/Outputs"):
        return config_training(
            {"savepath": savepath, "configpath": inis,
             "transform": "sample_norm_cent", **universal},
            {"tb": "False", "show": "False", "figures": "False", **params},
            hp)

    # (a) the five stages from the dump
    configs = {}
    trees, walls, reads, peaks = run_five_stages(
        f"{root}/np", np_source, card, "h5 np", protocol=H5_PROTOCOL,
        configs=configs)
    hw = tuple(configs["aec_train"].input_hw)
    z = np.load(os.path.join(trees["aec_predict"], "Z_AEC.npy"))
    xr = np.load(os.path.join(trees["aec_predict"], "Xr_AEC.npy"),
                 mmap_mode="r")
    n_tra = len(configs["aec_train"].index_tra)
    aec_rate = n_tra * H5_PROTOCOL["aec"][0]["n_epochs"] / walls["aec_train"]
    print(f"h5 4m on {card}: input_hw {hw}; Z_AEC {z.shape}, Xr_AEC "
          f"{xr.shape}; {n_tra} training windows from the TraVal pickle; "
          f"AEC train stage {aec_rate:.1f} samples/s (windows x epochs over "
          f"the stage wall, its load included)", flush=True)
    check(hw == H5_HW, f"h5 input_hw {hw}")
    check(z.shape == (H5_EVENTS, 9) and np.isfinite(z).all(),
          f"h5 Z_AEC {z.shape}")
    check(xr.shape == (H5_EVENTS, 1, *H5_HW)
          and bool(np.isfinite(xr[:4096]).all()), f"h5 Xr_AEC {xr.shape}")
    check_dec_predict(trees["dec_predict"], truth, "h5 np")
    aec_run, dec_run = trees["aec_train"], trees["dec_train"]

    # the CPU against the card on the dump's first windows, normalized as
    # the workflow does, under cuDNN's deterministic algorithms
    x_cpu = torch.from_numpy(np.load(dump, mmap_mode="r")[:H5_CPU_M].reshape(
        H5_CPU_M, *H5_HW, 1).copy())
    x_cpu = make_normalizer("sample_norm_cent")(x_cpu)
    gmm = trees["gmm_fit"]
    torch.backends.cudnn.deterministic = True
    try:
        gap = cpu_against_card(
            restore(os.path.join(aec_run, "AEC_Params_Final.pt")),
            restore(os.path.join(dec_run, "DEC_Params_Initial.pt")), x_cpu,
            np.load(os.path.join(gmm, "labels.npy"))[:H5_CPU_M],
            np.load(os.path.join(gmm, "centroids.npy")), input_hw=H5_HW)
    finally:
        torch.backends.cudnn.deterministic = False
    check(gap <= 1e-3, f"h5 CPU vs card losses rtol {gap}")

    # (b) the .h5 and stream routes, or their refusals
    if h5_path is not None:
        h5_source = {"fname_dataset": h5_path, "datafiletype": "h5",
                     "indexpath": index}
        pred = run_five_stages(f"{root}/h5file", h5_source, card, "h5 .h5",
                               protocol=H5_PROTOCOL)[0]["dec_predict"]
        check_dec_predict(pred, truth, "h5 .h5")
        pred = run_five_stages(
            f"{root}/stream", h5_source, card, "h5 stream",
            extra={**STREAM_KEYS, "h5_stream_block": 256},
            protocol=H5_PROTOCOL)[0]["dec_predict"]
        check_dec_predict(pred, truth, "h5 stream")
    else:
        aec_keys, aec_hp = H5_PROTOCOL["aec"]
        train_keys = {"model": "AEC", "mode": "train", **aec_keys}
        h5_file = f"{root}/catalog.h5"  # what convert-h5-to-np-torch reads
        _refused("run-dc from the .h5 (h5_ftype = h5)", "h5py",
                 lambda: cli.run_dc(init_path=ini(
                     {"fname_dataset": h5_file, "datafiletype": "h5"},
                     train_keys, aec_hp)), root)
        _refused("run-dc with loadmode = stream", "h5py",
                 lambda: cli.run_dc(init_path=ini(
                     np_source, {**train_keys, **STREAM_KEYS}, aec_hp)),
                 root)
        for name, argv in (
                ("query-h5size-torch", [h5_file]),
                ("extract-h5dataset-torch",
                 [h5_file, f"{root}/subset.h5", "--include", '["DR01"]']),
                ("generate-sample-index-torch", ["100", h5_file, root]),
                ("convert-h5-to-np-torch",
                 [h5_file, "--dest", f"{root}/converted.npy"])):
            tool = getattr(cli, name[:-len("-torch")].replace("-", "_"))
            _refused(name, "h5py", lambda: tool(argv), root)

    # (c) TensorBoard, or its refusal
    aec_w = os.path.join(aec_run, "AEC_Params_Final.pt")
    if importlib.util.find_spec("tensorboard") is not None:
        n_aec, n_dec = H5_TB_EPOCHS
        runs = {}
        for model, keys, hp in (
                ("AEC", {"n_epochs": n_aec, "early_stopping": "False"},
                 H5_PROTOCOL["aec"][1]),
                ("DEC", {"n_epochs": n_dec, "saved_weights": aec_w,
                         "init": "load"}, H5_PROTOCOL["dec"][1])):
            cfg = load_config(ini(np_source, {"model": model, "mode": "train",
                                              "tb": "True", **keys}, hp,
                                  savepath=f"{root}/tb/Outputs"))
            cfg.set_device(None)
            cfg.init_exp_env()
            [runs[model]] = workflow.train(cfg)
        aec_tags = tb_scalars(runs["AEC"]["savepath_run"])
        dec_tags = tb_scalars(runs["DEC"]["savepath_run"])
        deltas = runs["DEC"]["deltas"]["iteration"]
        print(f"h5 4m: TensorBoard AEC scalars {aec_tags}; DEC scalar tags "
              f"{sorted(dec_tags)}, delta steps {dec_tags.get('delta')}",
              flush=True)
        epochs = list(range(1, n_aec + 1))
        check(aec_tags.get("Training MSE") == epochs
              and aec_tags.get("Validation MSE") == epochs,
              f"AEC event steps {aec_tags}")
        check({"Loss", "MSE", "KLD", "delta"} <= set(dec_tags)
              and dec_tags["delta"] == deltas
              and dec_tags["Loss"] == sorted(set(dec_tags["Loss"])),
              f"DEC event steps {dec_tags}")
    else:
        kids = _child_pids()
        _refused("run-dc with tb = True", "tensorboard",
                 lambda: cli.run_dc(init_path=ini(
                     np_source, {"model": "AEC", "mode": "train",
                                 "tb": "True", "tbport": 6999,
                                 **H5_PROTOCOL["aec"][0]},
                     H5_PROTOCOL["aec"][1])), root)
        check(_child_pids() == kids, "tb = True left a child process")

    # (d) the checkpoint tools: export (a)'s DEC, convert it back, predict
    ref_pt = f"{root}/reference/DEC_Params_Final.pt"
    os.makedirs(os.path.dirname(ref_pt))
    cli.export_torch_checkpoint(
        [os.path.join(dec_run, "DEC_Params_Final.pt"), ref_pt])
    sd = torch.load(ref_pt, map_location="cpu", weights_only=True)
    want = models.DEC(H5_CLASSES, input_hw=H5_HW).state_dict()
    check(list(sd) == list(want)
          and all(v.dtype == torch.float64 and v.shape == want[k].shape
                  for k, v in sd.items()),
          "exported keys/shapes/dtypes "
          f"{[(k, v.dtype) for k, v in sd.items()]}")
    back = f"{root}/converted/{os.path.basename(dec_run)}"
    os.makedirs(back)
    cli.convert_torch_checkpoint([ref_pt, f"{back}/DEC_Params_Final.pt"])
    cfg = cli.run_dc(init_path=ini(np_source, {
        "model": "DEC", "mode": "predict",
        "saved_weights": f"{back}/DEC_Params_Final.pt"}))
    equal = {name: np.array_equal(
        np.load(os.path.join(cfg.savepath_exp, name)),
        np.load(os.path.join(trees["dec_predict"], name)))
        for name in ("q_DEC.npy", "Z_DEC.npy")}
    print(f"h5 4m: exported {len(sd)} float64 tensors at {H5_HW}; DEC "
          f"predict from the converted file bit-equal to (a)'s: {equal}",
          flush=True)
    check(all(equal.values()), f"converted DEC predict {equal}")

    # (e) profiling: a plain AEC epoch, then one traced, each step timed
    x = torch.from_numpy(np.load(dump)).reshape(H5_EVENTS, *H5_HW, 1)
    idx = configs["aec_train"].index_tra
    x = make_normalizer("sample_norm_cent")(
        x[torch.from_numpy(idx)].to(device))
    batch = int(H5_PROTOCOL["aec"][1]["batch_size"])
    data = train.make_batched_data(x, batch)
    counts = data.counts.tolist()
    aec = models.AEC(input_hw=H5_HW, device=device)
    aec.load_state_dict(restore(aec_w))
    state = train.create_train_state(aec, 1e-3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train.train_aec(aec, state, data, None, train.AECConfig(n_epochs=1))
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    train_step, _ = train.make_step_fns(aec)
    timer = profiling.StepTimer(warmup=1, device=device)
    logdir = f"{root}/trace"
    with profiling.trace(logdir, device):
        with profiling.annotate(H5_SPAN):
            for xb, n in zip(data.x, counts):
                with timer:
                    train_step(state, xb, int(n))
    with open(os.path.join(logdir, profiling.TRACE_FILE)) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    spans = sum(1 for e in events if e.get("name") == H5_SPAN)
    stats = timer.stats(items_per_step=batch)
    print(f"h5 4m on {card}: AEC epoch at {H5_HW} {len(x) / epoch_s:.1f} "
          f"samples/s ({len(x)} windows, batch {batch}, {epoch_s:.3f} s); "
          f"traced epoch, StepTimer over {int(stats['steps'])} steps "
          f"items_per_sec {stats['items_per_sec']:.1f} (p50 "
          f"{stats['p50_s'] * 1e3:.3f} ms, p95 {stats['p95_s'] * 1e3:.3f} "
          f"ms, synced each step, under the profiler); chrome trace "
          f"{os.path.getsize(os.path.join(logdir, profiling.TRACE_FILE))} "
          f"bytes, {kernels} CUDA kernel events, {spans} '{H5_SPAN}' spans",
          flush=True)
    check(kernels > 0, "no CUDA kernel events in the chrome trace")
    check(spans >= 1, "no annotate span in the chrome trace")

    launches = cuda_stft.LAUNCHES  # ... and ends here
    print(f"h5 4m on {card}: stage walls {walls} s, load_data reads {reads} "
          f"s, peaks {peaks} bytes; K1 launches in the phase {launches}; "
          f"phase wall {time.perf_counter() - phase_t0:.1f} s", flush=True)
    check(launches == 0, f"K1 launched {launches} times on the H5 route")


#: 4n: the reference's second cube layout, `Cube_chunked_60.zarr`
#: (SURVEY.md:247, ZarrDataLoader.py:97): 60-row chunks, so each 5,758-row
#: item of a channel spans ~96 chunk files
CHUNK60 = 60
#: 4n (e): a RESP of one pole-zero stage and one FIR stage (the layout
#: of tests/test_seismic.py's RESP_PAZ_FIR_TEXT), written by the phase
NATIVE_RESP = """\
B050F03     Station:     KPDR
B050F16     Network:     KP
B052F03     Location:    ??
B052F04     Channel:     HDH
B052F22     Start date:  2014,001,00:00:00
B052F23     End date:    2016,366,23:59:59
B057F04     Input sample rate (hz):        200.0
B057F05     Decimation factor:      1
B058F04     Sensitivity:    5.24814E+08
B058F05     Frequency of sensitivity:  0.02 HZ
B053F03     Transfer function type:                A
B053F04     Stage sequence number:                 1
B053F05     Response in units lookup:              M/S - Velocity in Meters Per Second
B053F06     Response out units lookup:             V - Volts
B053F07     A0 normalization factor:               2.0
B053F08     Normalization frequency:               0.02
B053F09     Number of zeroes:                      2
B053F14     Number of poles:                       2
B053F10-13     0  +0.00000E+00  +0.00000E+00  +0.00000E+00  +0.00000E+00
B053F10-13     1  +0.00000E+00  +0.00000E+00  +0.00000E+00  +0.00000E+00
B053F15-18     0  -2.00000E+00  +2.00000E+00  +0.00000E+00  +0.00000E+00
B053F15-18     1  -2.00000E+00  -2.00000E+00  +0.00000E+00  +0.00000E+00
B054F03     Transfer function type:                D
B054F04     Stage sequence number:                 2
B054F05     Response in units lookup:              V - Volts
B054F06     Response out units lookup:             COUNTS - Digital Counts
B054F07     Number of numerators:                  3
B054F10     Number of denominators:                0
B054F08-09     0  +2.50000E-01  +0.00000E+00
B054F08-09     1  +5.00000E-01  +0.00000E+00
B054F08-09     2  +2.50000E-01  +0.00000E+00
B057F03     Stage sequence number:                 2
B057F04     Input sample rate (HZ):                200.0
B057F05     Decimation factor:                     1
B057F06     Decimation offset:                     0
B057F07     Estimated delay (seconds):             +5.00000E-03
B057F08     Correction applied (seconds):          +5.00000E-03
"""
#: 4n (e): what `native_analysis_values` gives on a CPU (numpy 2.0.2,
#: scipy 1.17.0): the SHA-256 of the SAC and miniSEED bytes
#: of its trace, and the response removal's samples at NATIVE_PICKS and
#: its L2 norm, held within NATIVE_RESP_RTOL of the largest pick and of
#: the norm (tests/test_seismic.py's removal tolerance; the FFTs of
#: another numpy may round otherwise)
NATIVE_SAC_SHA256 = (
    "8fc3cfcbcfac3a95078c82b140a0cac2183cada3adc098f1852da23f361f218c")
NATIVE_MSEED_SHA256 = (
    "dfefcd1182de8c01254e4a87852b454f715a8087c9d9a4e04e281058fb44a8f5")
NATIVE_PICKS = (0, 1000, 2048, 3071, 4095)
NATIVE_REMOVED = (-6.3533164313580855e-06, 2.5085724607648394e-05,
                  6.845954424185163e-06, 1.7276298028569002e-05,
                  1.0928709572100778e-05)
NATIVE_REMOVED_NORM = 0.0018100289449772915
NATIVE_RESP_RTOL = 1e-10


def native_analysis_values(root: str) -> dict:
    """4n (e): a trace of exact samples (integers over 7: no generator and
    no libm, so every numpy writes the same bytes) written as SAC and as
    miniSEED by the port's `analysis.sacio` and read back, and its
    samples as counts through `seismic.remove_response_native` of
    NATIVE_RESP (displacement, a pre-filter). Returns the bytes' SHA-256,
    whether each read back equal, and the removal's picks and norm."""
    import hashlib
    from datetime import datetime

    from spectrogram_cube_clustering_tpu_torch.analysis import sacio, seismic

    n = 4096
    data = ((np.arange(n) * 7919) % 2003 - 1001).astype(np.float64) / 7.0
    stats = dict(network="KP", station="KPDR", location="", channel="HDH",
                 starttime=datetime(2015, 6, 1, 0, 0, 0, 250000),
                 sampling_rate=20.0, npts=n)
    out = {}
    for fmt, write, read in (("sac", sacio.write_sac, sacio.read_sac),
                             ("mseed", sacio.write_mseed, sacio.read_mseed)):
        path = os.path.join(root, f"trace.{fmt}")
        write(path, sacio.Trace(data.copy(), sacio.Stats(**stats)))
        with open(path, "rb") as fh:
            out[f"{fmt}_sha256"] = hashlib.sha256(fh.read()).hexdigest()
        back = read(path)
        out[f"{fmt}_read_back"] = bool(
            np.array_equal(back.data, data.astype(np.float32))
            and back.stats.starttime == stats["starttime"]
            and back.stats.npts == n)
    resp = os.path.join(root, "RESP.KP.KPDR..HDH")
    with open(resp, "w") as fh:
        fh.write(NATIVE_RESP)
    removed = seismic.remove_response_native(
        data * 1e3, 20.0, resp, units="DISP",
        pre_filt=(0.005, 0.01, 4.0, 8.0))
    out["removed"] = [float(removed[i]) for i in NATIVE_PICKS]
    out["removed_norm"] = float(np.linalg.norm(removed))
    return out


def read_per_chunk(arr) -> np.ndarray:
    """A Zarr array whole through its plain Python path: `_decode_chunk`
    of every chunk, one at a time."""
    out = np.empty(arr.shape, arr.dtype)
    grid = [-(-s // c) for s, c in zip(arr.shape, arr.chunks)]
    for cid in np.ndindex(*grid):
        sel = tuple(slice(i * c, min((i + 1) * c, s))
                    for i, c, s in zip(cid, arr.chunks, arr.shape))
        out[sel] = arr._decode_chunk(cid)[
            tuple(slice(0, s.stop - s.start) for s in sel)]
    return out


def phase_native(device, card: str, tmp: str, sources: dict,
                 build_s: float) -> None:
    """4n: the native chunk decoder and int8 quantizer (`native/`, built by
    g++ from the checkout's source in phase 2) and the host analysis layer:
    (a) the build and the host; (b) 4c's cube rewritten in 60-row chunks,
    read whole through the native batch path against the per-chunk Python
    path, its windows against 4c's, one stream epoch over it; (c) the
    blosc fixture; (d) the int8 wire on 4g's batches; (e) `sacio` and
    `seismic` against the CPU's values, and the catalogues,
    `measure_label_change` and the new figures without pandas and
    matplotlib."""
    import contextlib
    import importlib.util
    import platform
    import types
    import unittest.mock

    from spectrogram_cube_clustering_tpu_torch import native
    from spectrogram_cube_clustering_tpu_torch.analysis import (
        catalogue,
        plotting,
    )
    from spectrogram_cube_clustering_tpu_torch.core.precision import (
        quantize_tensor,
        quantize_wire,
    )
    from spectrogram_cube_clustering_tpu_torch.data import (
        ZarrCubeDataset,
        prefetch,
        zarrlite,
    )
    from spectrogram_cube_clustering_tpu_torch.utils import (
        measure_label_change,
    )
    from spectrogram_cube_clustering_tpu_torch.workflow.data import (
        _cube_spec,
    )
    from spectrogram_cube_clustering_tpu_torch.workflow.train import (
        _np_normalizer,
    )

    phase_t0 = time.perf_counter()
    # (a) the library phase 2 built, and the host that runs it
    try:
        with open("/proc/cpuinfo") as fh:
            cpuinfo = fh.read()
    except OSError:
        cpuinfo = ""
    model = next((line.split(":", 1)[1].strip()
                  for line in cpuinfo.splitlines()
                  if line.startswith("model name")),
                 platform.processor() or "unknown")
    avx2 = " avx2" in cpuinfo
    lib = native.library_path()
    print(f"native 4n: {lib.name} built by g++ from "
          f"{os.path.relpath(native.SOURCE)} in {build_s:.2f} s; host CPU "
          f"{model!r}, os.cpu_count() {os.cpu_count()}, avx2 {avx2}; "
          f"decode threads a call {min(os.cpu_count() or 1, 16)}, quantize "
          f"threads {min(os.cpu_count() or 1, 8)}", flush=True)
    check(lib.exists(), f"native library {lib} missing")

    # (b) 4c's cube in 60-row chunks
    universal = dict(sources["zarr"][0])
    src = zarrlite.open_group(universal["fname_dataset"])["cube"]
    cube = src[:]
    root60 = f"{tmp}/cube_60.zarr"
    t0 = time.perf_counter()
    zarrlite.write_group(root60, {"cube": cube},
                         chunks=(CHUNK60, 1, cube.shape[2]),
                         compressor="zlib")
    write_s = time.perf_counter() - t0
    arr60 = zarrlite.open_group(root60)["cube"]
    n_chunks = int(np.prod([-(-s // c) for s, c in zip(arr60.shape,
                                                       arr60.chunks)]))
    decoded_mb = n_chunks * int(np.prod(arr60.chunks)) * 4 / 1e6
    calls = native.CALLS["decode_chunks"]
    t0 = time.perf_counter()
    fast = zarrlite.open_group(root60)["cube"][:]
    native_s = time.perf_counter() - t0
    native_calls = native.CALLS["decode_chunks"] - calls
    t0 = time.perf_counter()
    plain = read_per_chunk(arr60)
    plain_s = time.perf_counter() - t0
    same = fast.tobytes() == plain.tobytes()
    print(f"native 4n (b): 4c's cube {cube.shape} rewritten in "
          f"{arr60.chunks} chunks ({n_chunks} files, zlib) in {write_s:.3f} "
          f"s; read whole: native batch path {native_s:.3f} s "
          f"({decoded_mb / native_s:.1f} MB/s decoded, {native_calls} "
          f"decode_chunks calls), per-chunk Python path {plain_s:.3f} s "
          f"({decoded_mb / plain_s:.1f} MB/s); bit-equal {same}, equal to "
          f"the cube {np.array_equal(fast, cube)}", flush=True)
    check(same and np.array_equal(fast, cube),
          "60-row cube: native read != per-chunk read")
    check(native_calls >= 1, "60-row cube read without the native decoder")
    # the decoder's thread count (JAX's: one a core up to 16) against one
    paths = [arr60._chunk_path(list(i)) for i in np.ndindex(
        *[-(-s // c) for s, c in zip(arr60.shape, arr60.chunks)])]
    thread_s, first = {}, None
    for n_threads in (None, 1, None, 1):
        t0 = time.perf_counter()
        pooled = native.decode_chunks(paths, arr60.chunks, arr60.dtype,
                                      "zlib", n_threads=n_threads)
        thread_s.setdefault(n_threads or "default", []).append(
            round(time.perf_counter() - t0, 3))
        first = pooled.tobytes() if first is None else first
        check(pooled.tobytes() == first,
              f"decode_chunks with n_threads={n_threads}")
    print(f"native 4n (b): decode_chunks of the {len(paths)} files, s, "
          f"default ({min(os.cpu_count() or 1, 16)} threads) against 1 "
          f"thread, in turns: {thread_s}", flush=True)
    del cube, fast, plain, pooled, first

    spec = _cube_spec(types.SimpleNamespace(**universal))
    want = ZarrCubeDataset(universal["fname_dataset"], spec=spec
                           ).load_all_windows()
    calls = native.CALLS["decode_chunks"]
    t0 = time.perf_counter()
    got = ZarrCubeDataset(root60, spec=spec).load_all_windows()
    windows_s = time.perf_counter() - t0
    windows_calls = native.CALLS["decode_chunks"] - calls
    print(f"native 4n (b): load_all_windows on the 60-row cube {got.shape} "
          f"in {windows_s:.3f} s ({windows_calls} decode_chunks calls), "
          f"bit-equal to 4c's {got.tobytes() == want.tobytes()}", flush=True)
    check(got.tobytes() == want.tobytes(), "60-row cube windows != 4c's")
    check(windows_calls >= 1, "60-row windows without the native decoder")

    universal60 = dict(universal, fname_dataset=root60)
    before = dict(native.CALLS)
    rate = loader_rate(device, universal60, "int8")
    epoch_calls = {k: native.CALLS[k] - before[k] for k in before}
    print(f"native 4n (b): one stream epoch ({STREAM_KEYS['workers']} loader "
          f"workers, int8 wire) over the 60-row cube at {rate:.1f} windows/s "
          f"to the card; native calls {epoch_calls}", flush=True)
    check(epoch_calls["decode_chunks"] >= 1,
          "the stream epoch read without the native decoder")
    check(epoch_calls["quantize_int8"] == 0,
          "the int8 stream epoch encoded with the native quantizer")
    # the loader's rate with and without the native decoder, in turns:
    # with `decode_chunks` declining, zarrlite decodes chunk by chunk (the
    # port before 4n)
    rates = {}
    for turn in ("native", "plain", "plain", "native"):
        for wire in (None, "int8"):
            with contextlib.ExitStack() as stack:
                if turn == "plain":
                    stack.enter_context(unittest.mock.patch.object(
                        native, "decode_chunks", lambda *a, **k: None))
                rates.setdefault((turn, wire or "float32"), []).append(
                    round(loader_rate(device, universal60, wire), 1))
    print(f"native 4n (b): stream loader over the 60-row cube, windows/s "
          f"to the card, in turns native, plain, plain, native: "
          f"{ {f'{t} {w}': r for (t, w), r in rates.items()} }", flush=True)

    # 4g's int8 loader over 4c's cube (5,758-row items) with the wire's
    # torch expression and with the native quantizer routed in as the JAX
    # package routes a float32 batch, in turns (ROADMAP item 24)
    def jax_route(batch, wire):
        if wire == torch.int8 and isinstance(batch, np.ndarray) \
                and batch.dtype == np.float32:
            got = native.quantize_int8(np.ascontiguousarray(batch))
            if got is not None:
                return {"q": torch.from_numpy(got[0]),
                        "scale": torch.from_numpy(got[1])}
        return quantize_wire(batch, wire)

    int8_rates = {}
    for turn in ("torch", "native", "native", "torch"):
        before = native.CALLS["quantize_int8"]
        with contextlib.ExitStack() as stack:
            if turn == "native":
                stack.enter_context(unittest.mock.patch.object(
                    prefetch, "quantize_wire", jax_route))
            int8_rates.setdefault(turn, []).append(
                round(loader_rate(device, universal, "int8"), 1))
        routed = native.CALLS["quantize_int8"] - before
        check((routed > 0) == (turn == "native"),
              f"4g's int8 loader, {turn} turn: {routed} quantize_int8 calls")
    print(f"native 4n (b): 4g's int8 loader over 4c's cube, windows/s to "
          f"the card, the torch expression against the native quantizer "
          f"(up to {min(os.cpu_count() or 1, 8)} threads a call), in turns "
          f"torch, native, native, torch: {int8_rates}", flush=True)

    # (c) the blosc fixture (blosc-lz4, shuffle 1): the thread pool and the
    # from-scratch parser frame by frame
    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "fixtures")
    fixture = zarrlite.open_group(
        os.path.join(fixtures, "blosc_store"))["cube"]
    expected = np.load(os.path.join(fixtures, "blosc_store_expected.npy"))
    ids = [list(i) for i in np.ndindex(*[-(-s // c) for s, c in zip(
        fixture.shape, fixture.chunks)])]
    pooled = native.decode_chunks([fixture._chunk_path(i) for i in ids],
                                  fixture.chunks, fixture.dtype, "blosc")
    nbytes = int(np.prod(fixture.chunks)) * fixture.dtype.itemsize
    frames = []
    for i in ids:
        with open(fixture._chunk_path(i), "rb") as fh:
            frames.append(native.blosc_decompress(fh.read(), nbytes,
                                                  force_own=True))
    own = np.frombuffer(b"".join(frames), fixture.dtype).reshape(
        expected.shape)
    pooled = pooled.reshape(expected.shape)
    print(f"native 4n (c): blosc fixture {expected.shape} in "
          f"{fixture.chunks} chunks: decode_chunks equal "
          f"{np.array_equal(pooled, expected)}, blosc_decompress(force_own) "
          f"equal {np.array_equal(own, expected)}", flush=True)
    check(np.array_equal(pooled, expected), "blosc fixture via decode_chunks")
    check(np.array_equal(own, expected), "blosc fixture via the own parser")

    # (d) the int8 wire on 4g's batches: the 60-row cube's normalized
    # windows in the loader's batches of 64
    normalize = _np_normalizer(types.SimpleNamespace(
        transform="sample_norm_cent"))
    windows = normalize(got)
    batches = [np.ascontiguousarray(windows[i:i + 64])
               for i in range(0, len(windows), 64)]
    check(all(np.isfinite(b).all() for b in batches), "non-finite batches")
    t0 = time.perf_counter()
    fast = [native.quantize_int8(b) for b in batches]
    quant_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = [quantize_tensor(torch.from_numpy(b), torch.int8)
             for b in batches]
    torch_s = time.perf_counter() - t0
    same = all(np.array_equal(f[0], p["q"].numpy())
               and np.array_equal(f[1], p["scale"].numpy())
               for f, p in zip(fast, plain))
    print(f"native 4n (d): int8 wire over {len(batches)} batches "
          f"{batches[0].shape}: quantize_int8 {quant_s:.3f} s, the torch "
          f"expression on the host {torch_s:.3f} s; codes and scales "
          f"bit-equal {same}", flush=True)
    check(same, "native int8 quantizer != the torch expression")

    # (e) host analysis: no jax, pandas, obspy or matplotlib
    root = f"{tmp}/native_4n"
    os.makedirs(root, exist_ok=True)
    values = native_analysis_values(root)
    removed_err = max(
        max(abs(g - w) for g, w in zip(values["removed"], NATIVE_REMOVED))
        / max(abs(w) for w in NATIVE_REMOVED),
        abs(values["removed_norm"] - NATIVE_REMOVED_NORM)
        / NATIVE_REMOVED_NORM)
    print(f"native 4n (e): sacio SAC sha256 {values['sac_sha256']} (the "
          f"CPU's: {values['sac_sha256'] == NATIVE_SAC_SHA256}), read back "
          f"{values['sac_read_back']}; miniSEED sha256 "
          f"{values['mseed_sha256']} (the CPU's: "
          f"{values['mseed_sha256'] == NATIVE_MSEED_SHA256}), read back "
          f"{values['mseed_read_back']}; remove_response_native picks "
          f"{values['removed']}, norm {values['removed_norm']!r}, largest "
          f"relative gap to the CPU's {removed_err:.3e} (bound "
          f"{NATIVE_RESP_RTOL})", flush=True)
    check(values["sac_sha256"] == NATIVE_SAC_SHA256
          and values["sac_read_back"], "sacio SAC round trip")
    check(values["mseed_sha256"] == NATIVE_MSEED_SHA256
          and values["mseed_read_back"], "sacio miniSEED round trip")
    check(removed_err <= NATIVE_RESP_RTOL,
          f"remove_response_native {removed_err} from the CPU's")
    for name in ("jax", "obspy"):
        check(name not in sys.modules, f"{name} imported on the host path")

    det, lab = f"{root}/det.csv", f"{root}/lab.csv"
    with open(det, "w") as fh:
        fh.write("network,station,dt_peak,peak,unit,idx\n")
        for i in range(12):
            fh.write(f"XH,DR0{i % 2 + 1},2015-0{i % 9 + 1}-02 00:00:00,"
                     f"{1 + i / 10},m/s,{i}\n")
    with open(lab, "w") as fh:
        fh.write("label\n" + "".join(f"{i % 3}\n" for i in range(12)))
    pandas_calls = {
        "LabelCatalogue": lambda: catalogue.LabelCatalogue([det, lab]).df,
        "EnvironmentCatalogue": lambda: catalogue.EnvironmentCatalogue(
            "DR02", "AWS01", root).df,
        "measure_label_change": lambda: measure_label_change(
            np.arange(12) % 3, np.arange(12) % 4),
    }
    x = windows[:5, :, :, :1]
    z = np.random.default_rng(0).normal(size=(30, 9))
    labels, cents = np.arange(30) % 3, z[:3]
    figures = {
        "view_history_aec": lambda: plotting.view_history_aec(
            {"epoch": [1, 2], "train": [1.0, 0.5], "validation": [1, 0.6]}),
        "view_history_dec": lambda: plotting.view_history_dec(
            {"iteration": [0, 1], "total": [2, 1], "reconstruction": [1, 1],
             "clustering": [1, 0]}),
        "view_centroid_output": lambda: plotting.view_centroid_output(x),
        "view_class_pdf_single": lambda: plotting.view_class_pdf_single(
            z, labels, cents),
        "view_class_pdf": lambda: plotting.view_class_pdf(z, labels, cents),
        "view_dec_output": lambda: plotting.view_dec_output(
            x[0], 1, x[1], z[0]),
        "compare_silhscore": lambda: plotting.compare_silhscore(
            z[:, 0] / 4, z[:, 1] / 4, labels, 3),
        "centroid_dashboard": lambda: plotting.centroid_dashboard(
            z, labels, cents),
        "view_specgram": lambda: plotting.view_specgram(x[0]),
        "view_detections": lambda: plotting.view_detections(
            f"{root}/none.h5", [0]),
        "view_series": lambda: plotting.view_series(
            "DR02", "AWS01", root, det, lab),
        "compare_images": lambda: plotting.compare_images(x, x[::-1]),
        "centroid_distances": lambda: plotting.centroid_distances(
            z, labels, cents),
    }
    for package, calls in (("pandas", pandas_calls),
                           ("matplotlib", figures)):
        if importlib.util.find_spec(package) is None:
            for what, fn in calls.items():
                _refused(what, package, fn, root, "native 4n (e)")
        else:
            version = getattr(importlib.import_module(package),
                              "__version__", "?")
            print(f"native 4n (e): {package} {version} imports here; its "
                  f"calls run: {sorted(calls)}", flush=True)
            for what, fn in calls.items():
                if what not in ("EnvironmentCatalogue", "view_detections",
                                "view_series"):  # no such files here
                    check(fn() is not None, f"{what} with {package}")
    print(f"native 4n on {card}: native calls {native.CALLS}; phase wall "
          f"{time.perf_counter() - phase_t0:.1f} s", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save-tsne-inputs", metavar="PATH.npz",
                    help="write 4i(d)'s DEC latents, labels and embedding "
                    "for tools/tsne_reference_nmi.py")
    ap.add_argument("--save-bf16-inputs", metavar="PATH.npz",
                    help="write 4h's bf16 epoch windows and seeded AEC "
                    "weights for tools/bf16_reference_gap.py")
    args = ap.parse_args()
    script_t0 = time.perf_counter()

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
    from spectrogram_cube_clustering_tpu_torch.ops import (
        _build,
        cuda_conv,
        cuda_convt,
        cuda_stft,
    )
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
    sass = _build.sass()
    dmma = _build.opcode_counts(sass, "DMMA")
    hmma = _build.opcode_counts(sass, "HMMA")
    for kernel in DMMA_KERNELS:
        found = {k: v for k, v in dmma.items() if kernel in k}
        print(f"  sass: {kernel}: DMMA per instantiation "
              f"{sorted(found.values())}", flush=True)
        check(bool(found) and all(found.values()), f"{kernel} DMMA {found}")
    for kernel in HMMA_KERNELS:
        found = {k: (v, dmma[k]) for k, v in hmma.items() if kernel in k}
        print(f"  sass: {kernel}: (HMMA, DMMA) per instantiation "
              f"{sorted(found.values())}", flush=True)
        check(len(found) == 6 and all(h and not d for h, d in found.values()),
              f"{kernel} HMMA {found}")
    check(not any("stft_mma_kernel" in k for k in dmma), "wmma kernel gone")
    # the native chunk decoder and int8 quantizer (host C++, g++): built
    # here from the checkout's source, before the phases that read Zarr
    from spectrogram_cube_clustering_tpu_torch import native

    t0 = time.perf_counter()
    native.load()
    native_build_s = time.perf_counter() - t0
    print(f"build: native {native_build_s:.2f} s "
          f"({native.library_path().name})", flush=True)

    # 3. kernel against plain
    gen = torch.Generator(device=device).manual_seed(args.seed)
    max_err = phase_kernel(device, gen, cuda_stft, spectrogram_plain)
    # 3b. the decoder's transposed-convolution kernel against its plain
    # version
    convt_entry = phase_convt(device, card, cuda_convt)
    # 3c. the encoder's convolution kernel against its plain version
    conv_entry = phase_conv(device, card, cuda_conv)

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
    cuda_convt.LAUNCHES = 0  # the training phases' run starts here
    cuda_conv.LAUNCHES = 0
    train_launches = phase_training(device, gen, card, cuda_stft,
                                    spectrogram_plain, args.seed)
    convt_launches = cuda_convt.LAUNCHES  # ... and ends here
    conv_launches = cuda_conv.LAUNCHES
    print(f"training path: transposed-convolution kernel launches "
          f"{convt_launches}, encoder convolution kernel launches "
          f"{conv_launches}", flush=True)
    check(convt_launches > 0 and convt_launches % 4 == 0,
          f"four convt launches a decoder forward, got {convt_launches}")
    check(conv_launches > 0, "the encoder's convolution kernel on the "
          "training path")
    convt_entry["launches"] = convt_launches
    conv_entry["launches"] = conv_launches
    with tempfile.TemporaryDirectory() as tmp:
        # 4c. the 5-stage CLI workflow, from a Zarr cube and a raw waveform
        wf_launches, cube_err, sources, wave_launches = phase_workflow(
            device, gen, card, cuda_stft, spectrogram_plain, tmp)
        # 4g. the same stages with loadmode = stream from 4c's sources, and
        # the wire dtypes
        phase_stream(device, card, cuda_stft, tmp, sources)
        # 4h. the packed and UNet architectures and the bf16 policy from
        # 4c's waveform
        arch_launches = phase_architectures(device, card, cuda_stft,
                                            spectrogram_plain, tmp, sources,
                                            args.save_bf16_inputs)
        # 4i. the on-device t-SNE, and the figures, on 4c's DEC run
        phase_tsne(device, card, tmp, sources, args.seed, wave_launches,
                   args.save_tsne_inputs)
        # 4j. the mesh: 4c's waveform stages over one NCCL rank and over
        # two gloo ranks on the card; the sharded STFT and GMM
        mesh_launches = phase_multigpu(device, card, tmp, sources)
        # 4k. mesh serving: phase 4's DEC behind scc-serve-torch --mesh
        serve_mesh_launches = phase_serve_mesh(
            device, card, model.state_dict(), predictor, frontend, windows_np,
            waves_np, tmp)
        # 4l. the cluster-count diagnostics on 4c's latents
        phase_km_metrics(device, card, tmp)
        # 4m. the RIS event catalog at (87, 100), TensorBoard, the
        # checkpoint tools and profiling
        phase_h5_catalog(device, card, cuda_stft, tmp, args.seed)
        # 4n. the native Zarr decoder and int8 quantizer on 4c's cube in
        # 60-row chunks, and the host analysis layer
        phase_native(device, card, tmp, sources, native_build_s)
    max_err = max(max_err, cube_err)
    print(f"STFT kernel launches: serving path {launches}, training path "
          f"{train_launches}, workflow {wf_launches}, architectures "
          f"{arch_launches}, multi-GPU ranks {mesh_launches}, mesh "
          f"serving ranks {serve_mesh_launches}", flush=True)
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
    floor_ms = direct_dft_ms(b * frames, "log")
    print(f"stft {BIG} on {card}: kernel {kernel_ms:.4f} ms "
          f"({n / kernel_ms / 1e6:.3f} G samples/s; runs {kern}), plain "
          f"{plain_ms:.4f} ms ({n / plain_ms / 1e6:.3f} G samples/s; runs "
          f"{plain}), torch.stft float64 + |.|^2 + log10 {library_ms:.4f} ms "
          f"(max_abs_err vs kernel {lib_err:.3e}); bound {bound_ms:.4f} ms "
          f"by {bound_by} ({flop:.4e} FP64 FLOP at {FP64_PEAK:.3g}/s = "
          f"{ops_ms:.4f} ms; {nbytes} bytes at {HBM_BYTES_PER_S:.3g} B/s = "
          f"{bytes_ms:.4f} ms), kernel at {bound_ms / kernel_ms:.1%} of it; "
          f"design floor {floor_ms:.4f} ms (direct DFT at {FP64_PEAK:.3g} "
          f"FLOP/s), kernel at {floor_ms / kernel_ms:.1%} of it", flush=True)
    for name, ms in latency.items():
        print(f"p50 latency {name} on {card}: {ms:.2f} ms", flush=True)
    print(f"chip_smoke wall on {card}: "
          f"{time.perf_counter() - script_t0:.1f} s (the kernels' build "
          "included)", flush=True)

    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "stft",
        "route": "cuda",
        "source": "spectrogram_cube_clustering_tpu_torch/csrc/stft.cu",
        "replaces": "spectrogram_cube_clustering_tpu/ops/pallas_stft.py:86",
        "launches": (launches + train_launches + wf_launches + arch_launches
                     + mesh_launches + serve_mesh_launches),
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }] + variant_entries + layout_entries + [convt_entry, conv_entry]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
