"""The arithmetic of the tensor-core STFT kernels (`csrc/stft_mma.cuh`),
modelled in torch on the CPU, against the port's plain versions, a float64
oracle and the JAX package.

- K1 (`stft_f64_kernel`, FP64 tensor cores): float64 products of the
  float32 samples and the float64 bases, summed in k-steps of 8 (one DMMA
  each) in order, then c^2 + s^2 (+ eps, log10) in float64 and one
  rounding to float32. Held to `spectrogram_plain` (float64 rfft) within
  1e-6 on log10, a float32 ulp of the output, and to the JAX Pallas
  kernel in interpret mode at the kernel contract, atol 2e-3
  (tests/test_signal.py:47), at <= 60k samples.
- The TF32 and bf16x3 kernel (`stft_hmma_kernel`): the operands rounded to
  TF32 or split into bf16 hi/lo; each k-step's MMAs (8 samples; 16 for
  bf16, hi*lo + lo*hi + hi*hi, K zero-padded to a multiple of 16) summed
  from a zero fragment, modelled as exact products summed in float64 and
  rounded to float32 an MMA, and added to the running float32 sums in
  order with round-to-nearest; then the float32 epilogue op by op. Held
  to chip_smoke.py phase 4d's gates (p99.9 1e-4 against the plain version,
  no further than max(2e-3, 1.5 x the plain version's error) from float64)
  and to the JAX scripts K2 DEFAULT, K3 and K4 DEFAULT at the tolerances
  of tests/test_torch_stft_precision.py.

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
from spectrogram_cube_clustering_tpu.ops import pallas_stft
from spectrogram_cube_clustering_tpu_torch.experiments import (
    stft_isolate,
    stft_precision,
)
from spectrogram_cube_clustering_tpu_torch.ops import cuda_stft_variants as stv
from spectrogram_cube_clustering_tpu_torch.signal import stft

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def interpret_mode():
    """Pallas in interpret mode; one torch thread (the suite's parallel
    workers contend for the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pltpu.force_tpu_interpret_mode():
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scripts():
    """The JAX STFT precision and isolate scripts, loaded by path without
    keeping the path they add to sys.path."""
    out = {}
    for name in ("precision", "isolate"):
        path = os.path.join(REPO, "benchmarks", f"stft_{name}_tpu.py")
        spec = importlib.util.spec_from_file_location(f"_mma_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        saved = list(sys.path)
        try:
            spec.loader.exec_module(mod)
        finally:
            sys.path[:] = saved
        out[name] = mod
    return out


def _wave(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _frames(x, nperseg, hop, rows, k):
    """(B, rows, k) frames of the zero-padded float32 x, zero past
    nperseg."""
    need = (rows - 1) * hop + nperseg
    xp = torch.nn.functional.pad(x, (0, max(0, need - x.shape[-1])))
    fr = xp[:, :need].unfold(-1, nperseg, hop)
    return torch.nn.functional.pad(fr, (0, k - nperseg))


def k1_model(x, nperseg=200, hop=100, log=True, eps=1e-12):
    """K1's kernel arithmetic: (B, T) float32 -> (B, frames, nfreq)."""
    frames = (x.shape[-1] - nperseg) // hop + 1
    ks = -(-nperseg // 8)
    fr = _frames(x, nperseg, hop, frames, 8 * ks).double()
    sides = []
    for v in stft.windowed_dft_bases(nperseg):
        v = torch.nn.functional.pad(torch.from_numpy(v),
                                    (0, 0, 0, 8 * ks - nperseg))
        acc = torch.zeros(x.shape[0], frames, v.shape[1], dtype=torch.float64)
        for k in range(ks):
            acc = acc + fr[..., 8 * k:8 * k + 8] @ v[8 * k:8 * k + 8]
        sides.append(acc)
    c, s = sides
    p = c * c + s * s
    return (torch.log10(p + eps) if log else p).float()


def hmma_model(x, nperseg=200, hop=100, *, fmt, epilogue="log", rows=None,
               lanes=None, eps=1e-12):
    """The TF32 / bf16x3 kernel's arithmetic: (B, T) float32 ->
    (B, rows, lanes) float32, as `stv.stft_variant_plain` lays it out."""
    nfreq = nperseg // 2 + 1
    rows = rows or (x.shape[-1] - nperseg) // hop + 1
    lanes = lanes or nfreq
    kk = 16 if fmt == "bf16x3" else 8
    ks = -(-nperseg // kk)
    fr = _frames(x, nperseg, hop, rows, kk * ks)
    out = []
    for v in stft.windowed_dft_bases(nperseg)[:1 if epilogue == "c" else 2]:
        v = torch.nn.functional.pad(torch.from_numpy(v.astype(np.float32)),
                                    (0, lanes - nfreq, 0, kk * ks - nperseg))
        if fmt == "tf32":
            parts = [(stv.round_tf32(fr), stv.round_tf32(v))]
        else:
            (a_hi, a_lo), (b_hi, b_lo) = stv.split_bf16(fr), stv.split_bf16(v)
            parts = [(a_hi, b_lo), (a_lo, b_hi), (a_hi, b_hi)]
        acc = torch.zeros(x.shape[0], rows, lanes, dtype=torch.float32)
        for k in range(ks):
            step = slice(kk * k, kk * (k + 1))
            d = torch.zeros_like(acc)
            for a, b in parts:  # one MMA each, from the step's zero fragment
                d = (d.double() + a[..., step].double() @ b[step].double()
                     ).float()
            acc = acc + d  # round to nearest, in order
        out.append(acc)
    if epilogue == "c":
        return out[0]
    power = out[0] * out[0] + out[1] * out[1] + eps
    return torch.log10(power) if epilogue == "log" else power


# ------------------------------------------------------------------- K1

#: one frame, 200 / 100 at the JAX contract's size, nperseg % hop != 0
K1_CASES = [(200, 100, (1, 200)), (200, 100, (2, 60_000)),
            (250, 100, (2, 10_000))]


@pytest.mark.parametrize("nperseg,hop,shape", K1_CASES)
def test_k1_model_matches_plain_within_a_float32_ulp(nperseg, hop, shape):
    x = torch.from_numpy(_wave(shape, seed=nperseg))
    for log in (True, False):
        got = k1_model(x, nperseg, hop, log=log)
        want = stft.spectrogram_plain(x, nperseg, hop, log=log)
        assert got.shape == want.shape
        if log:
            assert float((got - want).abs().max()) <= 1e-6
        else:
            torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("nperseg,hop,shape", K1_CASES)
def test_k1_model_matches_jax(nperseg, hop, shape):
    """The JAX Pallas kernel in interpret mode at the kernel contract; at
    250 / 100, which the Pallas kernel refuses (nperseg % hop != 0), the
    JAX rfft spectrogram at its atol 2e-4 (tests/test_signal.py:26)."""
    x = _wave(shape, seed=nperseg)
    got = k1_model(torch.from_numpy(x), nperseg, hop).numpy()
    if nperseg % hop:
        with pytest.raises(ValueError, match="nperseg % hop"):
            pallas_stft.spectrogram_pallas(jnp.asarray(x), nperseg=nperseg,
                                           hop=hop, interpret=True)
        want = np.asarray(jsignal.spectrogram(jnp.asarray(x), nperseg, hop))
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
        return
    want = np.asarray(pallas_stft.spectrogram_pallas(
        jnp.asarray(x), nperseg=nperseg, hop=hop, interpret=True))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


# ------------------------------------------------------- TF32 and bf16x3

def _oracle(x, epilogue, rows, lanes):
    """float64 log10(c^2 + s^2 + 1e-12) (log, power) or c over its frame's
    sum |x w| (c) over `rows` frames and `lanes` bins, and that scale."""
    nfreq = 101
    fr = _frames(x.double(), 200, 100, rows, 200)
    cos, sin = (torch.from_numpy(v) for v in stft.windowed_dft_bases(200))
    scale = (fr.abs() @ torch.from_numpy(stft.np_hann(200)))[..., None]
    pad = (0, lanes - nfreq)
    c = fr @ cos
    if epilogue == "c":
        return torch.nn.functional.pad(c, pad) / scale.clamp_min(1e-30), scale
    want = torch.log10(c * c + (fr @ sin) ** 2 + 1e-12)
    return torch.nn.functional.pad(want, pad, value=-12.0), scale


@pytest.mark.parametrize("layout", ["narrow", "padded"])
@pytest.mark.parametrize("epilogue", stv.EPILOGUES)
@pytest.mark.parametrize("fmt", ["tf32", "bf16x3"])
def test_hmma_model_clears_the_card_gates(fmt, epilogue, layout):
    """Phase 4d's gates, on two rows of 30,099 samples (a ragged last
    tile) and, padded, K4's (rows, 128) layout over the zero-padded tail:
    p99.9 of the gap to the plain version within 1e-4 (power through
    log10, c over its frame's sum |x w|), the largest error against
    float64 within max(2e-3, 1.5 x the plain version's), and the pad
    lanes exactly the plain version's zero power."""
    x = torch.from_numpy(_wave((2, 30_099), seed=7))
    kw = dict(fmt=fmt, epilogue=epilogue)
    if layout == "padded":
        kw.update(rows=stft_isolate.rows_padded(30_099, 256), lanes=128)
    got = hmma_model(x, **kw)
    plain = stv.stft_variant_plain(x, **kw)
    assert got.shape == plain.shape
    rows, lanes = got.shape[1:]
    ref, scale = _oracle(x, epilogue, rows, lanes)
    if layout == "padded":
        assert torch.equal(got[..., 101:], plain[..., 101:])

    def values(v):
        if epilogue == "c":
            return v.double() / scale.clamp_min(1e-30)
        return torch.log10(v.double()) if epilogue == "power" else v.double()

    m, p = values(got), values(plain)
    gap = (m - p).abs().flatten()
    assert float(gap.kthvalue(int(0.999 * gap.numel())).values) <= 1e-4
    m_err, p_err = float((m - ref).abs().max()), float((p - ref).abs().max())
    assert m_err <= max(2e-3, 1.5 * p_err)


def _assert_default_close(got, want, ref64):
    """tests/test_torch_stft_precision.py's `default` contract: bins within
    4 decades of their frame's float64 peak within 5e-2, all bins at p99.9
    within 2e-2."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    loud = ref64 >= ref64.max(axis=-1, keepdims=True) - 4.0
    assert float(err[loud].max()) <= 5e-2
    assert float(np.quantile(err, 0.999)) <= 2e-2


@pytest.mark.parametrize("shape", [(2, 30_000), (12_345,)])
def test_tf32_model_matches_jax_k2_default(scripts, shape):
    x = _wave(shape)
    xt = torch.from_numpy(x.reshape(-1, shape[-1]))
    got = hmma_model(xt, fmt="tf32").reshape(*shape[:-1], -1, 101)
    want = scripts["precision"].spectrogram_folded(
        jnp.asarray(x), prec=jax.lax.Precision.DEFAULT)
    ref = stft_precision.f64_oracle(x.astype(np.float64)).numpy()
    assert got.shape == np.shape(want) == ref.shape
    _assert_default_close(got.numpy(), want, ref)


@pytest.mark.parametrize("shape", [(2, 30_000), (12_345,)])
def test_bf16x3_model_matches_jax_k3(scripts, shape):
    """K3's atol 1e-4 on every bin within 4 decades of its frame's float64
    peak and at p99.9 over all bins. At near-zero DC bins (log10 ~ -5) the
    kernel's per-step sums and the script's folded dots, both ~5e-3 off
    float64 there, differ by up to ~1.3e-4 (ROADMAP Queue 3): there the
    model is held to float64 within max(2e-3, 1.5 x the script's error),
    phase 4d's gate."""
    x = _wave(shape)
    xt = torch.from_numpy(x.reshape(-1, shape[-1]))
    got = hmma_model(xt, fmt="bf16x3").reshape(*shape[:-1], -1, 101).numpy()
    want = np.asarray(scripts["precision"].spectrogram_folded_b3(
        jnp.asarray(x)))
    ref = stft_precision.f64_oracle(x.astype(np.float64)).numpy()
    assert got.shape == want.shape == ref.shape
    err = np.abs(got - want)
    loud = ref >= ref.max(axis=-1, keepdims=True) - 4.0
    assert float(err[loud].max()) <= 1e-4
    assert float(np.quantile(err, 0.999)) <= 1e-4
    m_err = float(np.abs(got - ref).max())
    assert m_err <= max(2e-3, 1.5 * float(np.abs(want - ref).max()))


@pytest.mark.parametrize("n", [30_000, 30_099])
def test_tf32_model_matches_jax_k4_default(scripts, n):
    """K4's padded (rows, 128) output, frames of the zero-padded tail and
    pad lanes included."""
    x = _wave((n,))
    rows = stft_isolate.rows_padded(n, 256)
    got = hmma_model(torch.from_numpy(x)[None], fmt="tf32", rows=rows,
                     lanes=128)[0]
    want = scripts["isolate"].pipeline(jnp.asarray(x), mode="default",
                                       fpb=256)
    need = (rows - 1) * 100 + 200
    xp = np.pad(x.astype(np.float64), (0, max(0, need - n)))
    ref = np.pad(stft_precision.f64_oracle(xp[:need]).numpy(),
                 ((0, 0), (0, 27)), constant_values=-12.0)
    assert got.shape == np.shape(want) == ref.shape
    _assert_default_close(got.numpy(), want, ref)
