"""The torch port's STFT against the JAX package's.

The same numpy waveforms go through the JAX functions and the port's. The
port's plain version (the only one the CPU runs) is held to the JAX rfft
spectrogram at atol 2e-4 on log10 (tests/test_signal.py:26, rfft against
rfft) and to the JAX Pallas kernel in interpret mode at atol 2e-3
(tests/test_signal.py:47, matmul DFT against rfft). The CUDA kernel itself
runs only on a card: its tests are in tests/test_torch_cuda.py.
"""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectrogram_cube_clustering_tpu import signal as jsignal
from spectrogram_cube_clustering_tpu.ops import pallas_stft
from spectrogram_cube_clustering_tpu_torch.ops import _build, cuda_stft
from spectrogram_cube_clustering_tpu_torch.signal import stft

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("nperseg", [16, 100, 128, 200, 250, 256])
def test_numpy_helpers_equal_jax_originals(nperseg):
    np.testing.assert_array_equal(stft.np_hann(nperseg), jsignal.stft.np_hann(nperseg))
    for got, want in zip(stft.np_dft_angles(nperseg),
                         jsignal.stft.np_dft_angles(nperseg)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nperseg,hop", [(200, 100), (256, 64), (128, 16), (120, 40)])
def test_windowed_bases_equal_pallas_bases(nperseg, hop):
    """The kernel's float64 bases, cast to float32, are bit-equal to the
    Pallas kernel's hop-chunked bases reassembled into (nperseg, nfreq)."""
    nfreq = nperseg // 2 + 1
    jc, js = pallas_stft._windowed_dft_bases(nperseg, hop, 256)
    ratio = nperseg // hop
    want_c = np.concatenate([np.asarray(jc)[j, :hop, :nfreq] for j in range(ratio)])
    want_s = np.concatenate([np.asarray(js)[j, :hop, :nfreq] for j in range(ratio)])
    cos, sin = stft.windowed_dft_bases(nperseg)
    assert cos.dtype == sin.dtype == np.float64
    np.testing.assert_array_equal(cos.astype(np.float32), want_c)
    np.testing.assert_array_equal(sin.astype(np.float32), want_s)


def test_frame(rng):
    x = rng.normal(size=(1_000,)).astype(np.float32)
    f = stft.frame(torch.from_numpy(x), 200, 100).numpy()
    np.testing.assert_array_equal(f, np.asarray(jsignal.frame(jnp.asarray(x), 200, 100)))
    with pytest.raises(ValueError, match="< nperseg"):
        stft.frame(torch.zeros(199), 200, 100)


@pytest.mark.parametrize(
    "shape,nperseg,hop",
    [
        ((4_000,), 200, 100),
        ((3, 2_000), 200, 100),
        ((2, 3, 1_500), 200, 100),
        ((10_000,), 256, 64),
        ((5_003,), 100, 100),
        ((5_000,), 250, 100),
    ],
)
def test_plain_matches_jax_spectrogram(rng, shape, nperseg, hop):
    """rfft against rfft: atol 2e-4 on log10 (tests/test_signal.py:26)."""
    x = rng.normal(size=shape).astype(np.float32)
    want = np.asarray(jsignal.spectrogram(jnp.asarray(x), nperseg=nperseg, hop=hop))
    got = stft.spectrogram(torch.from_numpy(x), nperseg=nperseg, hop=hop)
    assert got.dtype == torch.float32
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)


@pytest.mark.parametrize(
    "nperseg,hop,shape,fpb",
    [
        (200, 100, (60_000,), 512),   # test_signal.py:41
        (256, 64, (10_000,), 64),     # :49
        (200, 100, (950,), 8),        # leftover samples, :60
        (100, 100, (5_003,), 32),     # geometry fuzz, :76-84
        (120, 40, (7_919,), 32),
        (192, 32, (6_144,), 32),
        (200, 100, (200,), 32),
        (160, 80, (9_760,), 32),
        (128, 16, (20_000,), 256),    # high ratio, :102
        (200, 100, (1_100,), 512),    # all tail, :118
        (200, 100, (3, 4_000), 32),   # batch
    ],
)
def test_plain_matches_pallas_interpret(rng, nperseg, hop, shape, fpb):
    """Matmul DFT against rfft: atol 2e-3 on log10 (tests/test_signal.py:47)."""
    x = rng.normal(size=shape).astype(np.float32)
    want = np.asarray(pallas_stft.spectrogram_pallas(
        jnp.asarray(x), nperseg=nperseg, hop=hop, interpret=True,
        frames_per_block=fpb,
    ))
    got = stft.spectrogram(torch.from_numpy(x), nperseg=nperseg, hop=hop).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_power_without_log(rng):
    x = rng.normal(size=(3_000,)).astype(np.float32)
    want = np.asarray(jsignal.spectrogram(jnp.asarray(x), log=False))
    got = stft.spectrogram(torch.from_numpy(x), log=False).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(10_000,), (3, 5_000)])
@pytest.mark.parametrize("transform", ["sample_norm_cent", "vec_norm", None])
def test_spectrogram_windows_match_jax(rng, shape, transform):
    """Channel-major windows, each channel's trailing partial window
    dropped, normalizer applied: shapes and values equal the JAX rfft
    path's at the rfft tolerance."""
    x = rng.normal(size=shape).astype(np.float32)
    want = np.asarray(jsignal.spectrogram_windows(
        jnp.asarray(x), transform=transform, use_pallas=False
    ))
    got = stft.spectrogram_windows(torch.from_numpy(x), transform=transform)
    per_channel = ((shape[-1] - 200) // 100 + 1) // 4
    channels = shape[0] if len(shape) == 2 else 1
    assert got.shape == want.shape == (channels * per_channel, 4, 101, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)


def test_spectrogram_windows_precision_surface():
    """precision="default" is the TF32 opt-in (its values are held to JAX
    in tests/test_torch_stft_precision.py); other values raise."""
    x = torch.zeros(1_000)
    got = stft.spectrogram_windows(x, precision="default", transform=None)
    want = stft.spectrogram_windows(x, transform=None)
    assert got.shape == want.shape == (2, 4, 101, 1)
    with pytest.raises(ValueError, match="precision"):
        stft.spectrogram_windows(x, precision="fast")
    with pytest.raises(ValueError, match="unknown transform"):
        stft.spectrogram_windows(x, transform="nope")


def test_cpu_tensor_takes_plain_version_and_launches_nothing(rng):
    x = torch.from_numpy(rng.normal(size=(2, 3_000)).astype(np.float32))
    before = cuda_stft.LAUNCHES
    got = cuda_stft.spectrogram(x, nperseg=128, hop=64)
    torch.testing.assert_close(got, stft.spectrogram_plain(x, 128, 64), rtol=0, atol=0)
    assert cuda_stft.LAUNCHES == before


def test_kernel_wrapper_refuses_a_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_stft.spectrogram_cuda(torch.zeros(1, 400))


def test_build_is_keyed_by_sources(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "a.cu").write_text("// one\n")
    first = _build.library_path()
    assert first.parent == tmp_path / "build"
    assert first == _build.library_path()
    (tmp_path / "a.cu").write_text("// two\n")
    assert _build.library_path() != first


def test_build_is_keyed_by_headers(tmp_path, monkeypatch):
    """A change to a shared header (csrc/*.cuh) builds anew."""
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "a.cu").write_text('#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// one\n")
    first = _build.library_path()
    (tmp_path / "b.cuh").write_text("// two\n")
    assert _build.library_path() != first


#: a `cuobjdump -sass` listing of three kernels: DMMA, HMMA, neither
SASS_LISTING = textwrap.dedent("""
    Fatbin elf code:
    ================
    arch = sm_90a
        code for sm_90a
            Function : _ZN12_GLOBAL__N_115stft_f32_kernelILi0EEEvN7scc_mma4ArgsIfEE
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
            /*0a50*/                   DMMA.16x8x8 R24, R20, R16, R24 ;
            /*0a60*/                   DMMA.16x8x8 R28, R20, R18, R28 ;
            /*0a70*/                   FFMA R1, R2, R3, R4 ;
            Function : _ZN12_GLOBAL__N_116stft_hmma_kernelILi1ELi0EEEvN7scc_mma4ArgsIfEE
            /*0b10*/                   HMMA.16816.F32.BF16 R8, R4, R12, R8 ;
            /*0b20*/                   HMMA.16816.F32.BF16 R8, R16, R2, R8 ;
            /*0b30*/                   HMMA.1688.F32.TF32 R8, R16, R2, R8 ;
            /*0b40*/                   FADD R8, R8, R9 ;
            Function : _ZN12_GLOBAL__N_118passthrough_kernelILb1EEEvPKfPfiiiiii
            /*0010*/                   FADD R1, R2, R3 ;
    """)


def test_dmma_counts_reads_a_sass_listing():
    """DMMA instructions are counted under the function they belong to,
    and a function without any counts 0."""
    assert _build.opcode_counts(SASS_LISTING, "DMMA") == {
        "_ZN12_GLOBAL__N_115stft_f32_kernelILi0EEEvN7scc_mma4ArgsIfEE": 2,
        "_ZN12_GLOBAL__N_116stft_hmma_kernelILi1ELi0EEEvN7scc_mma4ArgsIfEE": 0,
        "_ZN12_GLOBAL__N_118passthrough_kernelILb1EEEvPKfPfiiiiii": 0,
    }


def test_opcode_counts_take_every_variant_of_an_opcode():
    """HMMA counts both its TF32 and bf16 shapes, and no FADD or DMMA;
    a name that is only part of an opcode counts nothing."""
    hmma = _build.opcode_counts(SASS_LISTING, "HMMA")
    assert list(hmma.values()) == [0, 3, 0]
    assert list(_build.opcode_counts(SASS_LISTING, "FADD").values()) == \
        [0, 1, 1]
    assert not any(_build.opcode_counts(SASS_LISTING, "MMA").values())


def test_build_fails_loudly_without_nvcc(tmp_path, monkeypatch):
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_import_runs_no_nvcc_and_no_triton(tmp_path):
    """Importing the kernel module (and the whole package) compiles
    nothing: a fake nvcc first on PATH would leave a marker if run."""
    marker = tmp_path / "nvcc_ran"
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text(f"#!/bin/sh\ntouch {marker}\nexit 1\n")
    fake.chmod(0o755)
    code = textwrap.dedent("""
        import sys
        import spectrogram_cube_clustering_tpu_torch
        from spectrogram_cube_clustering_tpu_torch.ops import cuda_stft
        assert "triton" not in sys.modules
    """)
    env = dict(os.environ, PATH=f"{fake.parent}{os.pathsep}{os.environ['PATH']}")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True,
                   timeout=120)
    assert not marker.exists()
