"""The port's STFT layout experiments (K6 raw-read, K7 narrow-out, K8
fused-basis) and the loose-precision A/B against the JAX experiment
scripts, on the CPU.

The scripts under `benchmarks/` are loaded by path and their Pallas
kernels run in forced interpret mode; the same numpy waveforms go through
them and through the port's counterparts, which on the CPU run their plain
version (`ops.cuda_stft_layout.stft_layout_plain`: float32 sums, one dot
per hop-long basis slice, added in the TPU kernels' order). Tolerances, on
log10 values:

- frames a Pallas kernel computed (K6 below its `frames_main`, every frame
  of K7, K8): atol 1e-5, float32 sums in another order inside each dot;
- K6's frames past `frames_main`, which the script takes through XLA's
  float32 rfft: atol 2e-3, the STFT contract (tests/test_signal.py:47).

The kernels themselves run only on a card (tests/test_torch_cuda.py).
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from spectrogram_cube_clustering_tpu import signal as jsignal
from spectrogram_cube_clustering_tpu_torch.experiments import (
    stft_fusedbasis,
    stft_loose_precision,
    stft_outslice,
    stft_rawread,
)
from spectrogram_cube_clustering_tpu_torch.ops import cuda_stft_layout as stl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAVES_1D = [30_000, 12_345, 30_099]
KERNEL_ATOL = 1e-5
TAIL_ATOL = 2e-3


def _script(name):
    """A `benchmarks/` script as a module, without keeping the path it
    adds to sys.path or the JAX settings it changes at import."""
    path = os.path.join(REPO, "benchmarks", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_bench_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    saved = list(sys.path)
    cache = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
        jax.config.update("jax_compilation_cache_dir", cache[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          cache[1])
    return mod


@pytest.fixture(scope="module")
def scripts():
    return {n: _script(f"stft_{n}_tpu")
            for n in ("rawread", "outslice", "fusedbasis", "loose_precision")}


@pytest.fixture(scope="module", autouse=True)
def interpret_mode():
    """Pallas in interpret mode; one torch thread (the suite's parallel
    workers contend for the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pltpu.force_tpu_interpret_mode():
        yield
    torch.set_num_threads(n)


def _wave(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n,)).astype(np.float32)


# ------------------------------------------------ K6 raw-read

@pytest.mark.parametrize("n", WAVES_1D)
@pytest.mark.parametrize("fpb", [64, 512])
def test_k6_rawread_matches_script(scripts, n, fpb):
    """Every frame, in one piece: the script's Pallas frames within 1e-5,
    its rfft tail within the STFT contract."""
    x = _wave(n)
    got = stft_rawread.build(fpb=fpb)(torch.from_numpy(x), n).numpy()
    want = np.asarray(scripts["rawread"].build(fpb=fpb, interpret=True)(
        jnp.asarray(x), n))
    main = stl.frames_main(n, 100, fpb, stl.HALO)
    assert got.shape == want.shape == ((n - 200) // 100 + 1, 101)
    np.testing.assert_allclose(got[:main], want[:main], rtol=0,
                               atol=KERNEL_ATOL)
    np.testing.assert_allclose(got[main:], want[main:], rtol=0,
                               atol=TAIL_ATOL)


def test_k6_tail_longer_than_a_block(scripts):
    """30,099 samples at fpb 64: 256 frames from the grid, a 43-frame
    tail (the card's one launch covers both)."""
    assert stl.frames_main(30_099, 100, 64, stl.HALO) == 256
    x = _wave(30_099, seed=1)
    got = stft_rawread.rawread(torch.from_numpy(x), fpb=64).numpy()
    want = np.asarray(jsignal.spectrogram(jnp.asarray(x)))
    assert got.shape == want.shape == (299, 101)
    np.testing.assert_allclose(got, want, rtol=0, atol=TAIL_ATOL)


# ------------------------------------------------ K7 narrow-out

@pytest.mark.parametrize("n", WAVES_1D)
@pytest.mark.parametrize("fpb", [64, 256])
def test_k7_outslice_matches_script(scripts, n, fpb):
    x = _wave(n)
    got = stft_outslice.spectrogram_narrow(torch.from_numpy(x), fpb).numpy()
    want = np.asarray(scripts["outslice"].spectrogram_narrow(
        jnp.asarray(x), fpb=fpb))
    assert got.shape == want.shape == ((n - 200) // 100 + 1, 101)
    np.testing.assert_allclose(got, want, rtol=0, atol=KERNEL_ATOL)


# ------------------------------------------------ K8 fused-basis

@pytest.mark.parametrize("n", WAVES_1D)
def test_k8_fusedbasis_matches_script(scripts, n):
    """The script's frames_main frames only, fewer than the waveform's."""
    x = _wave(n)
    got = stft_fusedbasis.build_fused(fpb=64)(torch.from_numpy(x), n).numpy()
    want = np.asarray(scripts["fusedbasis"].build_fused(
        fpb=64, interpret=True)(jnp.asarray(x), n))
    assert got.shape == want.shape == (stl.frames_main(n, 100, 64, 8), 101)
    assert got.shape[0] < (n - 200) // 100 + 1
    np.testing.assert_allclose(got, want, rtol=0, atol=KERNEL_ATOL)


def test_k8_just_above_one_block():
    """frames_main = fpb exactly: 8 halo rows plus one block of 64."""
    n = (64 + 8) * 100 + 99
    x = torch.from_numpy(_wave(n, seed=2))
    got = stft_fusedbasis.fused(x, fpb=64)
    assert got.shape == (64, 101)
    torch.testing.assert_close(got, stl.stft_layout_plain(x)[:64], rtol=0,
                               atol=0)
    with pytest.raises(ValueError, match="fills no block"):
        stft_fusedbasis.fused(x[:n - 100], fpb=64)


# ------------------------------------------------ geometry guards

@pytest.mark.parametrize("call", [
    lambda x: stft_rawread.rawread(x, 250, 100, fpb=64),
    lambda x: stft_rawread.build(250, 100, fpb=64),
    lambda x: stft_fusedbasis.fused(x, 250, 100, fpb=64),
    lambda x: stft_fusedbasis.build_fused(250, 100, fpb=64),
    lambda x: stft_rawread.rawread(x, 512, 256, fpb=64),
    lambda x: stft_fusedbasis.fused(x, 512, 256, fpb=64),
    lambda x: stft_fusedbasis.fused(x[:5_000], fpb=64),
    lambda x: stft_fusedbasis.fused(x, fpb=512),
    lambda x: stft_rawread.rawread(x, fpb=60),
    lambda x: stft_rawread.rawread(x, 1_800, 100, fpb=64),
    lambda x: stft_outslice.spectrogram_narrow(x, fpb=0),
    lambda x: stl.stft_layout(x, 256, 64, layout="outslice"),
    lambda x: stl.stft_layout(x, layout="tiled"),
    lambda x: stl.stft_layout(x[None]),
    lambda x: stl.stft_layout(x, n_out=10_000),
], ids=["k6-250-100", "k6-build-250-100", "k8-250-100", "k8-build-250-100",
        "k6-hop256", "k8-hop256", "k8-no-block", "k8-fpb512-short",
        "k6-fpb60", "k6-ratio18", "k7-fpb0", "k7-geometry", "layout",
        "2-d", "n_out"])
def test_bad_geometry_raises(call):
    with pytest.raises(ValueError):
        call(torch.from_numpy(_wave(30_000)))


def test_script_faults_the_port_refuses(scripts):
    """Faults of the TPU scripts: at nperseg 250 / hop 100 K6 drops the
    last 50 samples of every frame (far off the STFT), where the port
    raises; K8 returns fewer frames than the waveform has, as the port
    does."""
    x = _wave(30_000, seed=3)
    bad = np.asarray(scripts["rawread"].build(250, 100, fpb=64,
                                              interpret=True)(
        jnp.asarray(x), 30_000))
    ref = np.asarray(jsignal.spectrogram(jnp.asarray(x), 250, 100))
    assert float(np.abs(bad[:256] - ref[:256]).max()) > 0.5
    fused = scripts["fusedbasis"].build_fused(fpb=64, interpret=True)(
        jnp.asarray(x), 30_000)
    assert fused.shape[0] == 256 < 299


def test_wrapper_refuses_a_cpu_tensor_and_dispatches_it_to_plain():
    x = torch.from_numpy(_wave(5_000))
    with pytest.raises(ValueError, match="CUDA tensor"):
        stl.stft_layout_cuda(x)
    before = dict(stl.LAUNCHES)
    for layout in stl.LAYOUTS:
        torch.testing.assert_close(stl.stft_layout(x, layout=layout),
                                   stl.stft_layout_plain(x), rtol=0, atol=0)
    assert stl.LAUNCHES == before


# ------------------------------------------------ loose-precision A/B

def test_planted_waveform_is_the_scripts(scripts):
    wave, labels = stft_loose_precision.planted_waveform()
    j_wave, j_labels = scripts["loose_precision"].planted_waveform()
    assert wave.dtype == j_wave.dtype == np.float32
    np.testing.assert_array_equal(wave, j_wave)
    np.testing.assert_array_equal(labels, j_labels)


def test_window_labels_are_the_scripts(scripts, monkeypatch):
    """The script computes its window labels inside main(); run main with
    its measurements stubbed out and take them from cluster_score."""
    mod = scripts["loose_precision"]
    seen = {}

    def cluster_score(x, win_labels, tag):
        seen[tag] = np.asarray(win_labels)
        return np.arange(len(win_labels)) % 5, 0.5, 0.1

    def spectrogram_pallas(x, precision="highest"):
        return jnp.zeros(((x.shape[-1] - 200) // 100 + 1, 101), jnp.float32)

    monkeypatch.setattr(mod, "measure_throughput", lambda name: (1e9, 0.0))
    monkeypatch.setattr(mod, "spectrogram_pallas", spectrogram_pallas)
    monkeypatch.setattr(mod, "windows_for", lambda wave, name: None)
    monkeypatch.setattr(mod, "cluster_score", cluster_score)
    mod.main()
    wave, seg_labels = stft_loose_precision.planted_waveform()
    got = stft_loose_precision.window_labels(len(wave), seg_labels)
    assert set(seen) == {"cluster_highest", "cluster_default"}
    for want in seen.values():
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_loose_precision_clustering_runs_on_the_cpu():
    """A short run of the A/B's clustering: five segments, one epoch."""
    wave, seg_labels = stft_loose_precision.planted_waveform(n_segs=5)
    labels = stft_loose_precision.window_labels(len(wave), seg_labels)
    x = stft_loose_precision.windows_for(torch.from_numpy(wave), "default")
    assert x.shape == (len(labels), 4, 101, 1)
    lab, score, loss = stft_loose_precision.cluster_score(x, labels, "cpu",
                                                          epochs=1)
    assert lab.shape == labels.shape and 0.0 <= score <= 1.0
    assert np.isfinite(loss)


# ---- the FP64 tensor-core kernels' arithmetic, modelled on the CPU ---------


def _dmma_model(x, nperseg, hop, epilogue, eps=1e-12):
    """What csrc/stft_dmma.cuh computes: the float32 samples and bases
    widened to float64, float64 products and sums, c and s rounded to
    float32 once, then the float32 epilogue op by op."""
    from spectrogram_cube_clustering_tpu_torch.signal.stft import (
        windowed_dft_bases,
    )

    cos, sin = (torch.from_numpy(v.astype(np.float32)).double()
                for v in windowed_dft_bases(nperseg))
    frames = x.double().unfold(-1, nperseg, hop)
    c = (frames @ cos).float()
    if epilogue == "c":
        return c
    s = (frames @ sin).float()
    power = c * c + s * s + eps
    return torch.log10(power) if epilogue == "log" else power


def _f64_values(x, nperseg, hop, epilogue):
    """The float64 oracle (log10(c^2 + s^2 + 1e-12) for log and power, c
    over its frame's sum |x w| for c) and that frame scale."""
    from spectrogram_cube_clustering_tpu_torch.signal.stft import (
        np_hann,
        windowed_dft_bases,
    )

    frames = x.double().unfold(-1, nperseg, hop)
    cos, sin = (torch.from_numpy(v) for v in windowed_dft_bases(nperseg))
    scale = (frames.abs() @ torch.from_numpy(np_hann(nperseg)))[..., None]
    c = frames @ cos
    if epilogue == "c":
        return c / scale, scale
    s = frames @ sin
    return torch.log10(c * c + s * s + 1e-12), scale


@pytest.mark.parametrize("kind,epilogue,chunks", [
    ("variant", "log", 1), ("variant", "log", 2), ("variant", "power", 2),
    ("variant", "c", 2), ("layout", "log", 2),
])
@pytest.mark.parametrize("shape", [(1, 52_050), (1, 200_000), (2, 30_099)])
def test_dmma_arithmetic_clears_the_card_gates(kind, epilogue, chunks, shape):
    """The kernels' arithmetic (float64 sums of exact products, one float32
    rounding of c and s) against the plain versions at phases 4d/4e's
    gates: within p99.9 1e-4 of the plain version (power through log10, c
    over its frame's sum |x w|), and against the float64 oracle no worse
    than the plain version, nor than max(2e-3, 1.5 x the plain version's
    error)."""
    from spectrogram_cube_clustering_tpu_torch.ops.cuda_stft_variants import (
        stft_variant_plain,
    )

    x = torch.from_numpy(np.random.default_rng(shape[-1]).standard_normal(
        shape).astype(np.float32))
    if kind == "layout":
        plain = torch.stack([stl.stft_layout_plain(row) for row in x])
    else:
        plain = stft_variant_plain(x, fmt="f32", epilogue=epilogue,
                                   chunks=chunks)
    model = _dmma_model(x, 200, 100, epilogue)
    ref, scale = _f64_values(x, 200, 100, epilogue)

    def values(v):
        if epilogue == "c":
            return v.double() / scale
        return torch.log10(v.double()) if epilogue == "power" else v.double()

    m, p = values(model), values(plain)
    gap = (m - p).abs().flatten()
    assert float(gap.kthvalue(int(0.999 * gap.numel())).values) <= 1e-4
    m_err, p_err = float((m - ref).abs().max()), float((p - ref).abs().max())
    assert m_err <= p_err
    assert m_err <= max(2e-3, 1.5 * p_err)
