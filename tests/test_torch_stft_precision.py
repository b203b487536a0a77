"""The port's STFT precision and interior variants against the JAX
experiment scripts and the JAX package, on the CPU.

The scripts under `benchmarks/` are loaded by path and their Pallas
kernels run in forced interpret mode; the same numpy waveforms go through
them and through the port's counterparts, which on the CPU run their plain
versions (`ops.cuda_stft_variants`). Tolerances, on log10 values unless
said otherwise:

- float32 variants (K2 and K4 at HIGHEST, K5 in every mode): atol 1e-5;
  float32 sums in another order differ most at near-zero bins, and the
  plain versions keep the TPU kernels' structure (one folded dot, or one
  dot per hop plane) so that only the order inside a dot differs. K5's c
  and power get rtol 1e-5 with an atol of 1e-6 times each frame's
  sum |x * w| (c) or its square (power);
- K3 (bf16x3): atol 1e-4;
- K4's passthrough: bit-equal;
- every ``default`` variant (K1 through `spectrogram_windows`, K2, K4):
  three roundings meet here. On a TPU DEFAULT is one bf16 pass; JAX in
  interpret mode on the CPU computes float32 dots; on the H100 the port
  rounds both operands to TF32 (10 fraction bits), as its plain version
  here does. The gap is the TF32 rounding, which reaches O(1) where the
  DFT cancels, so only bins whose float64 log-power lies within 4 decades
  of their frame's peak are held to max 5e-2, and all bins to p99.9 2e-2.

The kernels themselves run only on a card (tests/test_torch_cuda.py).
"""

import importlib.util
import json
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
    stft_decompose,
    stft_isolate,
    stft_precision,
)
from spectrogram_cube_clustering_tpu_torch.ops import cuda_stft
from spectrogram_cube_clustering_tpu_torch.ops import cuda_stft_variants as v
from spectrogram_cube_clustering_tpu_torch.signal import stft

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = jax.lax.Precision

#: (2, T) batches, 1-D inputs of 30,000 samples and ragged lengths
SHAPES = [(2, 30_000), (30_000,), (12_345,), (3, 4_567)]
WAVES_1D = [30_000, 12_345, 30_099]


def _script(name):
    """A `benchmarks/` script as a module, without keeping the path it
    adds to sys.path."""
    path = os.path.join(REPO, "benchmarks", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_bench_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    saved = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


@pytest.fixture(scope="module")
def scripts():
    return {n: _script(f"stft_{n}_tpu")
            for n in ("precision", "isolate", "decompose")}


@pytest.fixture(scope="module", autouse=True)
def interpret_mode():
    """Pallas in interpret mode; one torch thread (the suite's parallel
    workers contend for the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pltpu.force_tpu_interpret_mode():
        yield
    torch.set_num_threads(n)


def _wave(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _f64_rows(x, rows, lanes, nperseg=200, hop=100):
    """float64 log-power of the zero-padded waveform over `rows` frames,
    `lanes` bins (those past nfreq at zero power)."""
    need = (rows - 1) * hop + nperseg
    x = np.pad(x.astype(np.float64), (0, max(0, need - x.shape[-1])))
    return np.pad(stft_precision.f64_oracle(x[:need]).numpy(),
                  ((0, 0), (0, lanes - nperseg // 2 - 1)),
                  constant_values=-12.0)


def _assert_default_close(got, want, ref64):
    """The ``default`` contract of the module docstring."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ref64 = np.asarray(ref64, np.float64)
    assert got.shape == want.shape == ref64.shape
    err = np.abs(got - want)
    loud = ref64 >= ref64.max(axis=-1, keepdims=True) - 4.0
    assert float(err[loud].max()) <= 5e-2
    assert float(np.quantile(err, 0.999)) <= 2e-2


# ------------------------------------------------ rounding helpers (bit-exact)

def _special_bits(drop):
    """float32 bit patterns around the rounding point of `drop` dropped
    bits: ties on both parities, carries into the exponent and to inf,
    zeros, subnormals, inf and NaN, each with both signs."""
    half = 1 << (drop - 1)
    base = [0x3F800000, 0x3F810000, 0x40490FDB, 0x00000000, 0x00000001,
            0x007FFFFF, 0x00400000, 0x3FFFFFFF, 0x7F7FFFFF, 0x7F800000,
            0x7FC00000, 0x1E3CE508]
    bits = []
    for b in base:
        b &= ~((1 << drop) - 1)
        for low in (0, 1, half - 1, half, half + 1, (1 << drop) - 1):
            bits.append(b | low)
            bits.append(b | (1 << drop) | low)  # odd kept bit
    bits = np.array(bits, np.uint32)
    return np.concatenate([bits, bits | np.uint32(0x80000000)]).view(
        np.float32)


def _np_round(a, frac_bits, ties_even):
    """Independent reference in float64: the nearest float32 value with
    `frac_bits` fraction bits (a fixed quantum of 2^(-126 - frac_bits)
    among subnormals), ties away from zero or to even; inf and NaN kept."""
    a = np.asarray(a, np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        x = np.abs(a.astype(np.float64))
        e = np.frexp(np.where(np.isfinite(x), x, 1.0))[1] - 1.0  # floor(log2)
        q = np.exp2(np.maximum(e, -126.0) - frac_bits)
        y = x / q
        r = np.rint(y) if ties_even else np.floor(y + 0.5)
        out = np.copysign(r * q, a.astype(np.float64)).astype(np.float32)
    return np.where(np.isfinite(a), out, a)


@pytest.mark.parametrize("which", ["specials", "random"])
def test_round_tf32_is_bit_exact(which):
    if which == "specials":
        a = _special_bits(13)
    else:
        rng = np.random.default_rng(3)
        a = (rng.normal(size=20_000)
             * np.exp2(rng.integers(-140, 120, 20_000))).astype(np.float32)
    got = v.round_tf32(torch.from_numpy(a)).numpy()
    want = _np_round(a, 10, ties_even=False)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("which", ["specials", "random"])
def test_split_bf16_is_bit_exact(which):
    if which == "specials":
        a = _special_bits(16)
    else:
        rng = np.random.default_rng(4)
        a = (rng.normal(size=20_000)
             * np.exp2(rng.integers(-140, 120, 20_000))).astype(np.float32)
    hi, lo = (t.numpy() for t in v.split_bf16(torch.from_numpy(a)))
    want_hi = _np_round(a, 7, ties_even=True)
    with np.errstate(invalid="ignore"):
        want_lo = _np_round(a - want_hi, 7, ties_even=True)
    np.testing.assert_array_equal(hi.view(np.uint32), want_hi.view(np.uint32))
    finite = np.isfinite(a)
    np.testing.assert_array_equal(lo[finite].view(np.uint32),
                                  want_lo[finite].view(np.uint32))
    # hi + lo holds a normal value to 16 significant bits
    ok = finite & np.isfinite(hi) & (np.abs(a) >= 2.0 ** -100)
    assert np.all(np.abs(hi[ok].astype(np.float64) + lo[ok] - a[ok])
                  <= np.abs(a[ok]) * 2.0 ** -16)


def test_split_bf16_matches_jax_astype():
    a = _wave((5_000,), seed=5) * np.float32(3.7)
    hi, lo = v.split_bf16(torch.from_numpy(a))
    j_hi = jnp.asarray(a).astype(jnp.bfloat16)
    j_lo = (jnp.asarray(a) - j_hi.astype(jnp.float32)).astype(jnp.bfloat16)
    np.testing.assert_array_equal(hi.numpy(), np.asarray(j_hi, np.float32))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(j_lo, np.float32))


# ------------------------------------------------ eligibility and routing

GEOMETRIES = [(200, 100), (256, 64), (128, 16), (250, 100), (512, 256),
              (512, 8), (1024, 128), (100, 100), (2048, 64), (2048, 128),
              (4096, 128), (64, 1), (120, 40), (129, 43)]


@pytest.mark.parametrize("nperseg,hop", GEOMETRIES)
def test_eligibility_copy_matches_jax(nperseg, hop):
    assert stft.pallas_eligible(nperseg, hop) == jsignal.stft.pallas_eligible(
        nperseg, hop, platform="tpu")


def test_bad_precision_raises():
    x = torch.from_numpy(_wave((2_000,)))
    with pytest.raises(ValueError, match="precision"):
        stft.spectrogram_windows(x, precision="loose")
    with pytest.raises(ValueError, match="precision"):
        cuda_stft.spectrogram(x, precision="high")
    with pytest.raises(ValueError, match="precision"):
        stft_precision.spectrogram_folded(x, precision="high")


@pytest.mark.parametrize("nperseg,hop", [(250, 100), (512, 256)])
def test_default_is_exact_where_ineligible(nperseg, hop):
    x = torch.from_numpy(_wave((2, 6_000)))
    got = cuda_stft.spectrogram(x, nperseg, hop, precision="default")
    assert torch.equal(got, cuda_stft.spectrogram(x, nperseg, hop))
    w = stft.spectrogram_windows(x, nperseg, hop, precision="default")
    assert torch.equal(w, stft.spectrogram_windows(x, nperseg, hop))


@pytest.mark.parametrize("nperseg,hop", [(200, 100), (256, 64), (128, 16)])
@pytest.mark.parametrize("log", [True, False])
def test_default_takes_tf32_where_eligible(nperseg, hop, log):
    x = torch.from_numpy(_wave((2, 6_000)))
    got = cuda_stft.spectrogram(x, nperseg, hop, log=log, precision="default")
    want = v.stft_variant_plain(x, nperseg, hop, fmt="tf32",
                                epilogue="log" if log else "power",
                                eps=1e-12 if log else 0.0)
    assert torch.equal(got, want)
    assert not torch.equal(got, cuda_stft.spectrogram(x, nperseg, hop,
                                                      log=log))


# ------------------------------------------------ K1 default, K2, K3

@pytest.mark.parametrize("shape", SHAPES)
def test_k1_default_windows_match_jax(shape):
    x = _wave(shape)
    got = stft.spectrogram_windows(torch.from_numpy(x), transform=None,
                                   precision="default")
    want = jsignal.spectrogram_windows(jnp.asarray(x), transform=None,
                                       use_pallas=True, interpret=True,
                                       precision="default")
    ref = stft_precision.f64_oracle(x.astype(np.float64)).numpy()
    ref = ref.reshape(-1, *ref.shape[-2:])
    per = ref.shape[1] // 4
    ref = ref[:, :per * 4].reshape(-1, 4, ref.shape[-1])
    _assert_default_close(got.numpy()[..., 0], np.asarray(want)[..., 0], ref)


@pytest.mark.parametrize("shape", SHAPES)
def test_k2_highest_matches_script(scripts, shape):
    x = _wave(shape)
    got = stft_precision.spectrogram_folded(torch.from_numpy(x))
    want = np.asarray(scripts["precision"].spectrogram_folded(
        jnp.asarray(x), prec=P.HIGHEST))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_k2_default_matches_script(scripts, shape):
    x = _wave(shape)
    got = stft_precision.spectrogram_folded(torch.from_numpy(x),
                                            precision="default")
    want = scripts["precision"].spectrogram_folded(jnp.asarray(x),
                                                   prec=P.DEFAULT)
    _assert_default_close(
        got.numpy(), want,
        stft_precision.f64_oracle(x.astype(np.float64)).numpy())


@pytest.mark.parametrize("shape", SHAPES)
def test_k3_bf16x3_matches_script(scripts, shape):
    x = _wave(shape)
    got = stft_precision.spectrogram_folded_b3(torch.from_numpy(x))
    want = np.asarray(scripts["precision"].spectrogram_folded_b3(
        jnp.asarray(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("n", WAVES_1D)
def test_f64_oracle_matches_script(scripts, n):
    x = _wave((n,))
    np.testing.assert_allclose(stft_precision.f64_oracle(x).numpy(),
                               scripts["precision"]._f64_oracle(x),
                               rtol=1e-12, atol=1e-12)


# ------------------------------------------------ K4

@pytest.mark.parametrize("n", WAVES_1D)
@pytest.mark.parametrize("fpb", [256, 1024])
def test_k4_passthrough_is_bit_equal(scripts, n, fpb):
    x = _wave((n,))
    got = stft_isolate.pipeline(torch.from_numpy(x), "passthrough", fpb)
    want = np.asarray(scripts["isolate"].pipeline(
        jnp.asarray(x), mode="passthrough", fpb=fpb))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", WAVES_1D)
@pytest.mark.parametrize("fpb", [256, 1024])
def test_k4_highest_matches_script(scripts, n, fpb):
    """Padded rows (frames of the zero-padded tail) and lanes included."""
    x = _wave((n,))
    got = stft_isolate.pipeline(torch.from_numpy(x), "highest", fpb)
    want = np.asarray(scripts["isolate"].pipeline(jnp.asarray(x),
                                                  mode="highest", fpb=fpb))
    assert got.shape == want.shape == (stft_isolate.rows_padded(n, fpb), 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy()[:, 101:], -12.0, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", WAVES_1D)
@pytest.mark.parametrize("fpb", [256, 1024])
def test_k4_default_matches_script(scripts, n, fpb):
    x = _wave((n,))
    got = stft_isolate.pipeline(torch.from_numpy(x), "default", fpb)
    want = scripts["isolate"].pipeline(jnp.asarray(x), mode="default",
                                       fpb=fpb)
    _assert_default_close(got.numpy(), want, _f64_rows(x, *got.shape))


# ------------------------------------------------ K5

def _frame_scale(x):
    """Per frame sum |x * w|, (B, F, 1)."""
    xt = torch.from_numpy(x.reshape(-1, x.shape[-1]).astype(np.float64))
    win = torch.from_numpy(stft.np_hann(200))
    return (stft.frame(xt, 200, 100).abs() * win).sum(-1, keepdim=True).numpy()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", ["full", "nolog", "nopow"])
def test_k5_modes_match_script(scripts, shape, mode):
    x = _wave(shape)
    got = stft_decompose.variant(torch.from_numpy(x), mode).numpy()
    want = np.asarray(scripts["decompose"].variant(jnp.asarray(x), mode=mode))
    assert got.shape == want.shape
    if mode == "full":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        scale = _frame_scale(x) ** (2 if mode == "nolog" else 1)
        assert np.all(np.abs(got - want) <= 1e-5 * np.abs(want) + 1e-6 * scale)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("fpb", [256, 1024])
def test_k5_stage_matches_script(scripts, shape, fpb):
    x = _wave(shape)
    planes, n_blocks, n_frames = stft_decompose.stage(torch.from_numpy(x),
                                                      fpb=fpb)
    j_planes, j_blocks, j_frames = scripts["decompose"]._stage(
        jnp.asarray(x), fpb=fpb)
    assert (n_blocks, n_frames) == (j_blocks, j_frames)
    np.testing.assert_array_equal(planes.numpy(), np.asarray(j_planes))
    got = stft_decompose.variant(torch.from_numpy(x), "stage_only", fpb)
    want = np.asarray(scripts["decompose"].variant(
        jnp.asarray(x), mode="stage_only", fpb=fpb))
    total = np.abs(planes.numpy()).sum(axis=(1, 2, 3))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=float(total.max()) * 1e-6)


# ------------------------------------------------ the experiments' main()

@pytest.mark.parametrize("module,keys", [
    (stft_precision, {"accuracy", "throughput_Msps", "device"}),
    (stft_isolate, {"throughput_Msps", "interior_us_per_4M", "device"}),
    (stft_decompose, {"throughput_Msps", "device"}),
])
def test_main_prints_the_script_json(module, keys, capsys):
    argv = ["--device", "cpu", "--samples", "3000", "--reps", "1"]
    if module is stft_precision:
        argv += ["--accuracy-samples", "5000"]
    assert module.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == keys and out["device"] == "cpu"
    names = {
        stft_precision: {"shipped_HIGHEST", "folded_HIGHEST", "folded_bf16x3"},
        stft_isolate: {"passthrough", "default", "highest",
                       "passthrough_fpb1024"},
        stft_decompose: {"stage_only", "kernel_nopow", "kernel_nolog",
                         "full"},
    }[module]
    assert set(out["throughput_Msps"]) == names
    assert all(r > 0 for r in out["throughput_Msps"].values())
    if module is stft_precision:
        assert set(out["accuracy"]) == names | {"folded_DEFAULT"}
        acc = out["accuracy"]
        assert acc["shipped_HIGHEST"]["max_abs_vs_oracle"] <= 1e-5
        assert acc["folded_HIGHEST"]["max_abs_vs_f64"] <= 2e-3
