"""The torch port on the card: the CUDA STFT kernel and its precision,
interior and layout variants, and the decoder's transposed-convolution
kernel, against their plain versions, and the serving and
training slices and the CLI (`build-cube`, `run-dc`) on CUDA against the
same on the CPU.

Every test here needs an NVIDIA GPU (the kernel has no CPU mode) and skips
itself without one. The file imports neither jax nor the JAX package, and
uses no fixture of tests/conftest.py (which imports jax), so on a machine
with a card and without jax it runs as

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import types

import numpy as np
import pytest
import torch

from spectrogram_cube_clustering_tpu_torch import (
    cluster,
    models,
    serve,
    train,
    workflow,
)
from spectrogram_cube_clustering_tpu_torch.core.device import tf32_flags
from spectrogram_cube_clustering_tpu_torch.experiments import (
    stft_decompose,
    stft_fusedbasis,
    stft_isolate,
    stft_outslice,
    stft_precision,
    stft_rawread,
)
from spectrogram_cube_clustering_tpu_torch.ops import cuda_convt, cuda_stft
from spectrogram_cube_clustering_tpu_torch.ops import cuda_stft_layout as stl
from spectrogram_cube_clustering_tpu_torch.ops import cuda_stft_variants as stv
from spectrogram_cube_clustering_tpu_torch.signal import stft

pytestmark = pytest.mark.cuda

#: kernel against plain, log10 units: the kernel contract
#: (tests/test_signal.py:47). Both sum in float64, so the observed gap is
#: float32 rounding.
STFT_ATOL = 2e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA STFT kernel has no CPU mode")
    return torch.device("cuda")


def _randn(shape, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, device=device, generator=g)


@pytest.mark.parametrize(
    "nperseg,hop,shape",
    [
        (200, 100, (1, 200)),       # exactly one frame
        (200, 100, (3, 1_100)),     # batch, one partial frame tile
        (200, 100, (1, 60_000)),
        (256, 64, (1, 10_000)),     # nfreq 129: a partial bin tile
        (128, 16, (1, 20_000)),     # ratio 8
        (120, 40, (2, 7_919)),      # ragged last frame tile
        (250, 100, (2, 10_000)),    # nperseg % hop != 0
        (100, 100, (1, 5_003)),     # ratio 1, leftover samples
    ],
)
def test_kernel_matches_plain(cuda_device, nperseg, hop, shape):
    x = _randn(shape, cuda_device)
    before = cuda_stft.LAUNCHES
    got = cuda_stft.spectrogram_cuda(x, nperseg=nperseg, hop=hop)
    torch.cuda.synchronize()
    assert cuda_stft.LAUNCHES == before + 1
    want = stft.spectrogram_plain(x, nperseg=nperseg, hop=hop)
    torch.testing.assert_close(got, want, rtol=0, atol=STFT_ATOL)


#: chip_smoke.py's phase-3 geometries: one frame, ragged tails, nperseg %
#: hop != 0 (250 / 100), a 64-frame tile over 71 hop rows (128 / 16),
#: float64 bases in several groups of blocks (256 / 64, 200 / 100) and the
#: (16, 2^20) batch
K1_GEOMETRIES = [
    (200, 100, (1, 200)), (200, 100, (1, 950)), (200, 100, (1, 1_100)),
    (200, 100, (1, 60_000)), (200, 100, (1, 1 << 20)),
    (256, 64, (1, 10_000)), (128, 16, (1, 20_000)), (100, 100, (1, 5_003)),
    (120, 40, (1, 7_919)), (192, 32, (1, 6_144)), (160, 80, (1, 9_760)),
    (250, 100, (1, 10_000)), (200, 100, (16, 1 << 20)),
]


@pytest.mark.parametrize("nperseg,hop,shape", K1_GEOMETRIES)
def test_k1_on_the_fp64_tensor_cores_at_every_smoke_geometry(
        cuda_device, nperseg, hop, shape):
    """Float64 products and sums of float64 bases and a float64 epilogue,
    rounded once: within 1e-6 of the float64 rfft on log10 (a float32 ulp
    of the output), and the bare power within rtol 1e-6."""
    x = _randn(shape, cuda_device, seed=nperseg + hop + shape[-1])
    got = cuda_stft.spectrogram_cuda(x, nperseg=nperseg, hop=hop)
    want = stft.spectrogram_plain(x, nperseg=nperseg, hop=hop)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-6
    got = cuda_stft.spectrogram_cuda(x, nperseg=nperseg, hop=hop, log=False)
    want = stft.spectrogram_plain(x, nperseg=nperseg, hop=hop, log=False)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


def test_kernel_power_without_log(cuda_device):
    x = _randn((2, 30_000), cuda_device)
    got = cuda_stft.spectrogram_cuda(x, log=False)
    want = stft.spectrogram_plain(x, log=False)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


def test_entry_point_launches_for_any_leading_shape(cuda_device):
    x = _randn((2, 3, 4_000), cuda_device)
    before = cuda_stft.LAUNCHES
    got = stft.spectrogram(x)
    assert cuda_stft.LAUNCHES == before + 1
    assert got.shape == (2, 3, 39, 101)
    torch.testing.assert_close(got, stft.spectrogram_plain(x), rtol=0,
                               atol=STFT_ATOL)


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    x = _randn((2, 4_000), cuda_device)
    with pytest.raises(TypeError, match="float32"):
        cuda_stft.spectrogram_cuda(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        cuda_stft.spectrogram_cuda(x[:, ::2])
    with pytest.raises(ValueError, match=r"\(B, T\)"):
        cuda_stft.spectrogram_cuda(x[None])
    with pytest.raises(ValueError, match="< nperseg"):
        cuda_stft.spectrogram_cuda(x[:, :150].contiguous())


def _dec(seed=0):
    return models.DEC(5, generator=torch.Generator().manual_seed(seed))


def test_predictor_on_card_matches_cpu(cuda_device):
    """Same weights, same windows: convolutions in float32 on both sides
    (TF32 off), so rtol 1e-4 / atol 1e-5 as in the models' parity tests."""
    sd = _dec().state_dict()
    x = _randn((300, 4, 101, 1), torch.device("cpu")).numpy()
    on_card = serve.DECPredictor(sd, 5, max_batch=128, buckets=True,
                                 device=cuda_device)
    assert not any(tf32_flags().values())
    on_cpu = serve.DECPredictor(sd, 5, max_batch=128, buckets=True,
                                device="cpu")
    got, want = on_card(x), on_cpu(x)
    np.testing.assert_allclose(got["z"], want["z"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["q"], want["q"], rtol=1e-4, atol=1e-5)
    top2 = np.sort(want["q"], axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-4
    np.testing.assert_array_equal(got["labels"][clear], want["labels"][clear])


def test_fused_frontend_on_card_matches_cpu(cuda_device):
    """The fused route on the card launches the kernel once per time chunk
    and gives the CPU route's answers."""
    sd = _dec(1).state_dict()
    wave = _randn((3, 20_000), torch.device("cpu"), seed=2).numpy()
    wf_card = serve.WaveformFrontend(
        serve.DECPredictor(sd, 5, device=cuda_device), chunk_samples=8_000
    )
    wf_cpu = serve.WaveformFrontend(
        serve.DECPredictor(sd, 5, device="cpu"), chunk_samples=8_000
    )
    assert wf_card.fused and wf_card.device.type == "cuda"
    before = cuda_stft.LAUNCHES
    got = wf_card(wave)
    assert cuda_stft.LAUNCHES == before + 3  # 49 windows, 20 per chunk
    want = wf_cpu(wave)
    np.testing.assert_array_equal(got["windows_per_channel"], [49, 49, 49])
    np.testing.assert_allclose(got["q"], want["q"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["z"], want["z"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(wf_card.windows(wave), wf_cpu.windows(wave),
                               rtol=0, atol=STFT_ATOL)


@pytest.mark.parametrize("name", ["PackedAEC", "PackedDEC", "UNet"])
def test_arch_forward_on_card_matches_cpu(cuda_device, name):
    """The packed and UNet models from the same weights on the card (cuDNN
    convolutions, transposed convolutions and max-pools, cuBLAS dense
    layers, float32 with TF32 off) and on the CPU: rtol 1e-4 / atol 1e-5,
    the models' parity tolerance; under BF16 the card's outputs are
    bfloat16 and within 0.05 of float32 (the JAX bf16 bound)."""
    from spectrogram_cube_clustering_tpu_torch.core import BF16, fp32_policy

    fp32_policy()
    gen = torch.Generator().manual_seed(6)
    cls = getattr(models, name)
    cpu = cls(3, generator=gen) if name == "PackedDEC" else cls(generator=gen)
    card = cls(3) if name == "PackedDEC" else cls()
    card.load_state_dict(cpu.state_dict())
    card.to(cuda_device)
    x = _randn((300, 4, 101, 1), torch.device("cpu"), seed=3)
    with torch.no_grad():
        want = cpu(x)
        got = card(x.to(cuda_device))
        with BF16.autocast(cuda_device):
            half = card(x.to(cuda_device))
    assert not any(tf32_flags().values())
    for g, w, h in zip(got, want, half):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(h.float().cpu().numpy(), w.numpy(),
                                   rtol=0, atol=0.05)
    assert half[-1].dtype == torch.bfloat16


def _tone_windows(n_windows, seed=0):
    """Normalized windows of a waveform of five tones, one per 400-sample
    stretch (computed on the CPU)."""
    rng = np.random.default_rng(seed)
    t = n_windows * 400 + 100
    kind = np.repeat(rng.integers(0, 5, -(-t // 400)), 400)[:t]
    wave = 10.0 * np.sin(2 * np.pi * (0.03 + 0.09 * kind) * np.arange(t))
    wave = torch.from_numpy((wave + rng.normal(size=t)).astype(np.float32))
    return stft.spectrogram_windows(wave)


def test_train_aec_epoch_on_card_matches_cpu(cuda_device):
    """One epoch from the same weights: losses within rtol 1e-3 (cuDNN
    against CPU convs, both float32 with TF32 off)."""
    x = _tone_windows(384)
    sd = models.AEC(generator=torch.Generator().manual_seed(4)).state_dict()
    hist = []
    for dev in ("cpu", cuda_device):
        model = models.AEC(device=dev)
        model.load_state_dict(sd)
        out = train.train_aec(
            model, train.create_train_state(model, 1e-3),
            train.make_batched_data(x[:256].to(dev), 64),
            train.make_batched_data(x[256:].to(dev), 64),
            train.AECConfig(n_epochs=1))
        assert not any(tf32_flags().values())
        hist.append(out["history"]["train"] + out["history"]["validation"])
    np.testing.assert_allclose(hist[1], hist[0], rtol=1e-3)


def test_gmm_em_on_card_matches_cpu(cuda_device):
    """From the same initial weights and means: equal n_iter and labels,
    means within 1e-4."""
    rng = np.random.default_rng(1)
    centers = rng.normal(scale=6.0, size=(5, 9))
    z = (centers[rng.integers(0, 5, 4000)]
         + rng.normal(size=(4000, 9))).astype(np.float32)
    means0 = z[rng.choice(4000, 5, replace=False)]
    weights0 = np.full(5, 0.2, np.float32)
    want_labels, want = cluster.gmm_em(z, weights0, means0, device="cpu")
    got_labels, got = cluster.gmm_em(z, weights0, means0, device=cuda_device)
    assert got.means.is_cuda and got.n_iter == want.n_iter
    assert torch.equal(got_labels.cpu(), want_labels)
    torch.testing.assert_close(got.means.cpu(), want.means, rtol=0,
                               atol=1e-4)


def test_train_dec_segment_on_card_matches_cpu(cuda_device):
    """One refresh segment from the same weights, labels and centroids:
    per-batch running losses within rtol 1e-3, a refresh's delta within
    one label."""
    x = _tone_windows(256, seed=2)
    dec = models.DEC(5, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        dec.encoder.encoder[8].weight.mul_(30.0)
        dec.encoder.encoder[8].bias.mul_(30.0)
        z = dec.encode(x)
    centroids = z[:5].numpy()
    labels = torch.cdist(z, z[:5]).argmin(1).numpy()
    sd = dec.state_dict()
    out = []
    for dev in ("cpu", cuda_device):
        model = models.DEC(5, device=dev)
        model.load_state_dict(sd)
        data = train.make_batched_data(x.to(dev), 32)
        out.append(train.train_dec(
            model, train.create_train_state(model, 1e-3), data,
            train.DECConfig(n_clusters=5, n_epochs=1, gamma=0.1, tol=0.0,
                            init="load", update_interval=4),
            initial=(labels, centroids)))
    want, got = out
    assert got["deltas"]["iteration"] == want["deltas"]["iteration"] == [5]
    np.testing.assert_allclose(got["deltas"]["delta"], want["deltas"]["delta"],
                               rtol=0, atol=1.0 / len(x) + 1e-7)
    np.testing.assert_allclose(got["history"]["total"],
                               want["history"]["total"], rtol=1e-3)


def test_load_windows_on_card_launches_the_kernel(cuda_device, tmp_path):
    """The workflow's waveform source runs the STFT kernel once and gives
    the CPU route's windows within the kernel contract."""
    wave = np.random.default_rng(3).normal(size=(2, 30_000))
    np.save(tmp_path / "wave.npy", wave.astype(np.float32))

    def config(device):
        return types.SimpleNamespace(
            model="AEC", mode="train", datafiletype="waveform",
            fname_dataset=str(tmp_path / "wave.npy"), device=device)

    before = cuda_stft.LAUNCHES
    got, _ = workflow.load_windows(config(cuda_device), split=False)
    assert cuda_stft.LAUNCHES == before + 1
    assert got.is_cuda and got.shape == (2 * 74, 4, 101, 1)
    want, _ = workflow.load_windows(config("cpu"), split=False)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=STFT_ATOL)


def test_build_cube_on_card_matches_cpu(cuda_device, tmp_path):
    """build-cube on the card (the default device) launches the kernel
    once and writes the cube `--device cpu` writes, within the kernel
    contract."""
    from spectrogram_cube_clustering_tpu_torch import cli
    from spectrogram_cube_clustering_tpu_torch.data import zarrlite

    wave = np.random.default_rng(4).normal(size=(3, 8_900))
    np.save(tmp_path / "wave.npy", wave.astype(np.float32))
    before = cuda_stft.LAUNCHES
    got = cli.build_cube([str(tmp_path / "wave.npy"),
                          str(tmp_path / "card.zarr"), "--chunk-rows", "44"])
    assert cuda_stft.LAUNCHES == before + 1
    want = cli.build_cube([str(tmp_path / "wave.npy"),
                           str(tmp_path / "cpu.zarr"), "--chunk-rows", "44",
                           "--device", "cpu"])
    got, want = (zarrlite.open_group(p)["cube"] for p in (got, want))
    assert got.shape == want.shape == (88, 3, 101)
    np.testing.assert_allclose(got[:], want[:], rtol=0, atol=STFT_ATOL)


def test_run_dc_on_card_matches_cpu(cuda_device, tmp_path):
    """run-dc AEC train and predict from a waveform: on the card by
    default, `device = cpu` on the CPU; the same history within rtol 1e-3
    and latents within 1e-3 (float32 convolutions in other orders)."""
    import os

    from spectrogram_cube_clustering_tpu_torch import cli
    from spectrogram_cube_clustering_tpu_torch.utils import config_training

    wave = np.random.default_rng(5).normal(size=(2, 40_000))
    np.save(tmp_path / "wave.npy", wave.astype(np.float32))
    out = {}
    for dev in ("card", "cpu"):
        root = tmp_path / dev
        extra = {"device": "cpu"} if dev == "cpu" else {}

        def run(params, hp=None):
            ini = config_training(
                {"fname_dataset": str(tmp_path / "wave.npy"),
                 "datafiletype": "waveform", "savepath": str(root / "Out"),
                 "configpath": str(root / "Config"),
                 "transform": "sample_norm_cent", **extra},
                {"tb": "False", "figures": "False", **params}, hp)
            return cli.run_dc(init_path=ini)

        cfg = run({"model": "AEC", "mode": "train", "n_epochs": 2},
                  {"batch_size": "32", "lr": "0.001"})
        assert cfg.device.type == ("cuda" if dev == "card" else "cpu")
        [run_dir] = [os.path.join(cfg.savepath_exp, d)
                     for d in os.listdir(cfg.savepath_exp)
                     if d.startswith("Run_")]
        run({"model": "AEC", "mode": "predict",
             "saved_weights": os.path.join(run_dir, "AEC_Params_Final.pt")})
        out[dev] = (np.loadtxt(os.path.join(run_dir, "AEC_history.csv"),
                               delimiter=",", skiprows=1),
                    np.load(os.path.join(run_dir, "Prediction", "Z_AEC.npy")))
    np.testing.assert_allclose(out["card"][0], out["cpu"][0], rtol=1e-3)
    np.testing.assert_allclose(out["card"][1], out["cpu"][1], rtol=0,
                               atol=1e-3)


def _frame_scale(x, rows):
    """sum |x * w| of each of `rows` frames of the zero-padded x, (B, rows,
    1): the size of c's float32 rounding (a frame of zeros: 1e-30)."""
    need = (rows - 1) * 100 + 200
    xp = torch.nn.functional.pad(x.double(), (0, max(0, need - x.shape[-1])))
    win = torch.from_numpy(stft.np_hann(200)).to(x.device)
    return (stft.frame(xp[:, :need], 200, 100).abs() * win).sum(
        -1, True).clamp_min(1e-30)


@pytest.mark.parametrize("layout", ["narrow", "padded"])
@pytest.mark.parametrize("epilogue", stv.EPILOGUES)
@pytest.mark.parametrize("fmt", stv.FORMATS)
def test_variant_kernel_matches_plain(cuda_device, fmt, epilogue, layout):
    """Same rounded operands, summed in another order (TF32, bf16x3) or
    in float64 (f32): p99.9 of the log10 gap within 1e-4 (log, and power
    through log10); c within 1e-5 of its frame's sum |x * w|."""
    x = _randn((2, 30_099), cuda_device)
    kw = dict(rows=512, lanes=128) if layout == "padded" else {}
    key = stv.variant_key(fmt, epilogue, layout == "padded")
    before = stv.LAUNCHES.get(key, 0)
    got = stv.stft_variant_cuda(x, fmt=fmt, epilogue=epilogue, **kw)
    torch.cuda.synchronize()
    assert stv.LAUNCHES[key] == before + 1
    want = stv.stft_variant_plain(x, fmt=fmt, epilogue=epilogue, **kw)
    assert got.shape == want.shape == ((2, 512, 128) if kw else (2, 299, 101))
    assert bool(torch.isfinite(got).all())
    if epilogue == "c":
        gap = (got - want).abs().double() / _frame_scale(x, got.shape[1])
        assert float(gap.max()) <= 1e-5
    else:
        if epilogue == "power":
            got, want = torch.log10(got), torch.log10(want)
        gap = (got - want).abs().flatten().double()
        assert float(torch.quantile(gap, 0.999)) <= 1e-4


def _f64_log_power(x, nperseg, hop, rows):
    """log10(c^2 + s^2 + 1e-12) in float64 over `rows` frames of the
    zero-padded (B, T) x: the oracle of the HIGHEST kernels."""
    need = (rows - 1) * hop + nperseg
    xp = torch.nn.functional.pad(x.double(), (0, max(0, need - x.shape[-1])))
    cos_b, sin_b = (torch.from_numpy(v).to(x.device)
                    for v in stft.windowed_dft_bases(nperseg))
    frames = stft.frame(xp[:, :need], nperseg, hop)
    c, s = frames @ cos_b, frames @ sin_b
    return torch.log10(c * c + s * s + 1e-12)


#: (nperseg, hop, shape, padded rows): frame counts that are no multiple of
#: the kernel's 64-frame tile, a last tile reading past T, bins split among
#: groups of blocks (256 / 64: 17 bin tiles), hop > 8 not a multiple of 8,
#: a hop larger than a shared-memory tile of hop rows holds, K in chunks
F32_EDGES = [
    (200, 100, (2, 30_099), None),
    (200, 100, (1, 6_499), None),
    (200, 100, (2, 30_099), 512),
    (256, 64, (2, 20_000), None),
    (120, 40, (1, 7_919), None),
    (2048, 512, (1, 40_000), None),
]


def _check_variant_edge(device, fmt, nperseg, hop, shape, rows, epilogue):
    """A variant kernel at one edge: p99.9 of the gap to the plain version
    within 1e-4 (c: 1e-5 of its frame's sum |x * w|), log within max(2e-3,
    1.5 x the plain version's error) of float64, and K4's padded lanes
    exactly the plain version's zero power."""
    x = _randn(shape, device, seed=nperseg + hop)
    kw = dict(fmt=fmt, epilogue=epilogue)
    if rows:
        kw.update(rows=rows, lanes=128)
    got = stv.stft_variant_cuda(x, nperseg, hop, **kw)
    torch.cuda.synchronize()
    want = stv.stft_variant_plain(x, nperseg, hop, **kw)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    nfreq = nperseg // 2 + 1
    if rows:
        pad = {"log": torch.log10(torch.tensor(1e-12, device=device)),
               "power": torch.tensor(1e-12, device=device),
               "c": torch.tensor(0.0, device=device)}[epilogue]
        assert torch.equal(got[..., nfreq:], want[..., nfreq:])
        assert bool((got[..., nfreq:] == pad).all())
    if epilogue == "c":
        win = torch.from_numpy(stft.np_hann(nperseg)).to(device)
        need = (got.shape[1] - 1) * hop + nperseg
        xp = torch.nn.functional.pad(x.double(),
                                     (0, max(0, need - shape[-1])))
        scale = (stft.frame(xp[:, :need], nperseg, hop).abs() * win).sum(
            -1, True).clamp_min(1e-30)
        gap = (got - want)[..., :nfreq].abs().double() / scale
        assert float(gap.max()) <= 1e-5
        return
    g, w = (v[..., :nfreq].double() for v in (got, want))
    if epilogue == "power":
        g, w = torch.log10(g), torch.log10(w)
    gap = (g - w).abs().flatten()
    assert float(gap.kthvalue(max(1, int(0.999 * gap.numel()))).values) \
        <= 1e-4
    ref = _f64_log_power(x, nperseg, hop, got.shape[1])
    k_err, p_err = float((g - ref).abs().max()), float((w - ref).abs().max())
    assert k_err <= max(2e-3, 1.5 * p_err)


@pytest.mark.parametrize("epilogue", stv.EPILOGUES)
@pytest.mark.parametrize("nperseg,hop,shape,rows", F32_EDGES)
def test_f32_variant_kernel_edges(cuda_device, nperseg, hop, shape, rows,
                                  epilogue):
    """The FP64 tensor-core kernel at its edges (`_check_variant_edge`)."""
    _check_variant_edge(cuda_device, "f32", nperseg, hop, shape, rows,
                        epilogue)


#: the TF32 / bf16x3 kernel's edges: ragged frame tiles, K4's padded
#: layout, bins split among two groups of blocks (256 / 64: 17 bin tiles
#: over a cap of 14), a 64-frame tile over 71 hop rows (128 / 16), a K
#: that is no multiple of bf16's k-step of 16 (200, 120)
HMMA_EDGES = [
    (200, 100, (2, 30_099), None),
    (200, 100, (1, 6_499), None),
    (200, 100, (2, 30_099), 512),
    (256, 64, (2, 20_000), None),
    (128, 16, (1, 20_000), None),
    (120, 40, (1, 7_919), None),
]


@pytest.mark.parametrize("epilogue", stv.EPILOGUES)
@pytest.mark.parametrize("nperseg,hop,shape,rows", HMMA_EDGES)
@pytest.mark.parametrize("fmt", ["tf32", "bf16x3"])
def test_hmma_variant_kernel_edges(cuda_device, fmt, nperseg, hop, shape,
                                   rows, epilogue):
    """The TF32 and bf16x3 tensor-core kernel at its edges
    (`_check_variant_edge`)."""
    _check_variant_edge(cuda_device, fmt, nperseg, hop, shape, rows,
                        epilogue)


def test_sass_has_dmma_in_both_redesigned_kernels(cuda_device):
    """Every instantiation of K1's stft_f64_kernel (log, power), of
    stft_f32_kernel (3 epilogues) and of stft_layout_kernel (3 layouts)
    multiplies on the FP64 tensor cores, and every one of stft_hmma_kernel
    (TF32 and bf16x3, 3 epilogues) on the TF32/bf16 tensor cores without a
    DMMA; the old SIMT and wmma kernels are gone."""
    from spectrogram_cube_clustering_tpu_torch.ops import _build

    text = _build.sass()
    dmma = _build.opcode_counts(text, "DMMA")
    hmma = _build.opcode_counts(text, "HMMA")
    for kernel, n in (("stft_f64_kernel", 2), ("stft_f32_kernel", 3),
                      ("stft_layout_kernel", 3)):
        found = {k: v for k, v in dmma.items() if kernel in k}
        assert len(found) == n, (kernel, found)
        assert all(v > 0 for v in found.values()), found
    found = {k: (v, dmma[k]) for k, v in hmma.items()
             if "stft_hmma_kernel" in k}
    assert len(found) == 6, found
    assert all(h > 0 and d == 0 for h, d in found.values()), found
    assert not any("stft_mma_kernel" in k or "11stft_kernel" in k
                   for k in dmma)
    assert not any(v for k, v in dmma.items() if "passthrough" in k)


@pytest.mark.parametrize("fpb", [256, 1024])
def test_passthrough_kernel_is_bit_equal(cuda_device, fpb):
    x = _randn((1, 30_099), cuda_device)
    rows = stft_isolate.rows_padded(30_099, fpb)
    before = stv.LAUNCHES.get(stv.PASSTHROUGH, 0)
    got = stv.passthrough_cuda(x, 100, 2, rows, 128)
    torch.cuda.synchronize()
    assert stv.LAUNCHES[stv.PASSTHROUGH] == before + 1
    assert torch.equal(got, stv.passthrough_plain(x, 100, 2, rows, 128))


def test_default_precision_launches_the_tf32_kernel(cuda_device):
    x = _randn((3, 40_000), cuda_device)
    key = stv.variant_key("tf32", "log")
    before, k1 = stv.LAUNCHES.get(key, 0), cuda_stft.LAUNCHES
    got = stft.spectrogram_windows(x, precision="default", transform=None)
    assert stv.LAUNCHES[key] == before + 1 and cuda_stft.LAUNCHES == k1
    want = stft.spectrogram_windows(x.cpu(), precision="default",
                                    transform=None)
    gap = (got.cpu() - want).abs().flatten().double()
    assert float(torch.quantile(gap, 0.999)) <= 1e-4


@pytest.mark.parametrize("name,fn,key", [
    ("folded_HIGHEST", lambda x: stft_precision.spectrogram_folded(x),
     "f32/log/narrow"),
    ("folded_DEFAULT", lambda x: stft_precision.spectrogram_folded(
        x, precision="default"), "tf32/log/narrow"),
    ("folded_bf16x3", lambda x: stft_precision.spectrogram_folded_b3(x),
     "bf16x3/log/narrow"),
    ("isolate_default", lambda x: stft_isolate.pipeline(x[0], "default"),
     "tf32/log/padded"),
    ("isolate_passthrough", lambda x: stft_isolate.pipeline(
        x[0], "passthrough"), "passthrough"),
    ("decompose_nopow", lambda x: stft_decompose.variant(x, "nopow"),
     "f32/c/narrow"),
])
def test_experiments_launch_their_kernels(cuda_device, name, fn, key):
    x = _randn((1, 20_000), cuda_device)
    before = stv.LAUNCHES.get(key, 0)
    got = fn(x)
    assert got.is_cuda and stv.LAUNCHES[key] == before + 1, name
    want = fn(x.cpu())
    assert got.shape == want.shape


def test_kmeans_and_gmm_of_numpy_latents_run_on_the_card(cuda_device):
    """Numpy latents go to the default device, the card, as the JAX
    functions run on the default device."""
    rng = np.random.default_rng(2)
    centers = rng.normal(scale=6.0, size=(5, 9))
    z = (centers[rng.integers(0, 5, 2000)]
         + rng.normal(size=(2000, 9))).astype(np.float32)
    labels, cents = cluster.kmeans(z, 5, n_init=4, max_iter=100)
    assert labels.is_cuda and cents.is_cuda
    labels, means = cluster.gmm(z, 5, n_init=4)
    assert labels.is_cuda and means.is_cuda


#: the layout kernels through their entry points, at the scripts' geometry
LAYOUT_ENTRIES = {
    "rawread": lambda x: stft_rawread.rawread(x),
    "outslice": lambda x: stft_outslice.spectrogram_narrow(x),
    "fusedbasis": lambda x: stft_fusedbasis.fused(x, fpb=64),
}


@pytest.mark.parametrize("n", [30_099, 205_003])
@pytest.mark.parametrize("layout", stl.LAYOUTS)
def test_layout_kernel_matches_plain(cuda_device, layout, n):
    """The same float32 operands, the kernel's sums in float64 and the
    plain version's in float32: p99.9 of the log10 gap within 1e-4, and
    against float64 within max(2e-3, 1.5 x the plain version's error)."""
    x = _randn((n,), cuda_device)
    before = stl.LAUNCHES.get(layout, 0)
    got = LAYOUT_ENTRIES[layout](x)
    torch.cuda.synchronize()
    assert stl.LAUNCHES[layout] == before + 1
    want = stl.stft_layout_plain(x, n_out=got.shape[0], layout=layout)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    gap = (got - want).abs().flatten().double()
    assert float(torch.quantile(gap, 0.999)) <= 1e-4
    ref = stft_precision.f64_oracle(x)[:got.shape[0]]
    k_err = float((got.double() - ref).abs().max())
    p_err = float((want.double() - ref).abs().max())
    assert k_err <= max(2e-3, 1.5 * p_err)


#: (layout, nperseg, hop, n, n_out): frames no multiple of the 64-frame
#: tile with the last tile's rows past T, bins split among groups of
#: blocks (512 / 128, ratio 4: 33 bin tiles), ratio 8 for K8, and K in
#: chunks (ratio 64, hop 128: one bin tile's float64 bases over all 64
#: slices exceed shared memory)
LAYOUT_EDGES = [
    ("rawread", 200, 100, 6_499, None),
    ("outslice", 200, 100, 6_499, None),
    ("fusedbasis", 200, 100, 30_099, 256),
    ("rawread", 512, 128, 60_000, None),
    ("fusedbasis", 512, 128, 60_000, 400),
    ("fusedbasis", 1024, 128, 60_000, 300),
    ("rawread", 8192, 128, 30_000, None),
]


@pytest.mark.parametrize("layout,nperseg,hop,n,n_out", LAYOUT_EDGES)
def test_layout_kernel_edges(cuda_device, layout, nperseg, hop, n, n_out):
    """The layout kernels at their edges, held as in
    test_layout_kernel_matches_plain."""
    x = _randn((n,), cuda_device, seed=nperseg + n)
    got = stl.stft_layout_cuda(x, nperseg, hop, n_out=n_out, layout=layout)
    torch.cuda.synchronize()
    want = stl.stft_layout_plain(x, nperseg, hop, n_out=got.shape[0],
                                 layout=layout)
    frames = (n - nperseg) // hop + 1
    assert got.shape == want.shape == (n_out or frames, nperseg // 2 + 1)
    assert bool(torch.isfinite(got).all())
    gap = (got - want).abs().flatten().double()
    assert float(gap.kthvalue(max(1, int(0.999 * gap.numel()))).values) \
        <= 1e-4
    ref = _f64_log_power(x[None], nperseg, hop, got.shape[0])[0]
    k_err = float((got.double() - ref).abs().max())
    p_err = float((want.double() - ref).abs().max())
    assert k_err <= max(2e-3, 1.5 * p_err)


@pytest.mark.parametrize("n,fpb,frames", [
    (30_099, 64, 256), (12_345, 64, 64), (7_299, 64, 64),
    (4_000_000, 512, 39_936), (4_000_000, 1024, 39_936),
])
def test_fusedbasis_returns_frames_main(cuda_device, n, fpb, frames):
    got = stft_fusedbasis.fused(_randn((n,), cuda_device), fpb=fpb)
    assert got.is_cuda and got.shape == (frames, 101)


def test_layout_entry_points_launch_only_their_kernel(cuda_device):
    """One launch of the entry point's own kernel: neither K1 nor the
    variants' kernels, and no other layout."""
    x = _randn((400_000,), cuda_device)
    for layout, fn in LAYOUT_ENTRIES.items():
        stl.LAUNCHES.clear()
        k1, variants = cuda_stft.LAUNCHES, dict(stv.LAUNCHES)
        out = fn(x)
        assert out.is_cuda and stl.LAUNCHES == {layout: 1}, layout
        assert cuda_stft.LAUNCHES == k1 and stv.LAUNCHES == variants


@pytest.mark.parametrize("call", [
    lambda x: stft_rawread.rawread(x, 250, 100),
    lambda x: stft_rawread.rawread(x, 512, 256),
    lambda x: stft_fusedbasis.fused(x, 250, 100, fpb=64),
    lambda x: stft_fusedbasis.fused(x[:5_000], fpb=64),
    lambda x: stft_rawread.rawread(x, fpb=60),
    lambda x: stl.stft_layout_cuda(x, 256, 64, layout="outslice"),
    lambda x: stl.stft_layout_cuda(x, n_out=1_000),
], ids=["k6-250-100", "k6-hop256", "k8-250-100", "k8-no-block", "k6-fpb60",
        "k7-geometry", "n_out"])
def test_layout_bad_geometry_raises_before_launch(cuda_device, call):
    x = _randn((30_000,), cuda_device)
    before = dict(stl.LAUNCHES)
    with pytest.raises(ValueError):
        call(x)
    assert stl.LAUNCHES == before


def test_layout_cuda_input_never_takes_the_plain_version(cuda_device,
                                                         monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(stl, "stft_layout_plain", refuse)
    monkeypatch.setattr(stv, "stft_variant_plain", refuse)
    x = _randn((30_000,), cuda_device)
    for layout, fn in LAYOUT_ENTRIES.items():
        assert fn(x).is_cuda, layout
    with pytest.raises(TypeError, match="float32"):
        stl.stft_layout_cuda(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        stl.stft_layout_cuda(x[::2])


# ---- K4's passthrough, redesigned: tiles staged in shared memory ------------


@pytest.mark.parametrize("b,t,hop,ratio,lanes,rows", [
    (1, 30_099, 100, 2, 128, 512),   # ragged T
    (3, 12_345, 100, 2, 128, 125),   # T % 4 = 1: later rows unaligned
    (2, 50_002, 100, 1, 128, 500),   # ratio 1
    (1, 60_000, 100, 3, 128, 599),   # ratio 3
    (2, 9_999, 100, 2, 100, 101),    # lanes == hop
    (3, 20_001, 30, 3, 33, 700),     # scalar stores
])
def test_passthrough_tiles_are_bit_equal(cuda_device, b, t, hop, ratio,
                                         lanes, rows):
    x = _randn((b, t), cuda_device, seed=t)
    got = stv.passthrough_cuda(x, hop, ratio, rows, lanes)
    assert torch.equal(got, stv.passthrough_plain(x, hop, ratio, rows, lanes))


def test_passthrough_of_no_samples_is_zeros(cuda_device):
    """T = 0 is refused before any launch (the launcher refuses it too);
    one sample stages that sample and zeros past it, as the plain version
    pads."""
    before = stv.LAUNCHES.get(stv.PASSTHROUGH, 0)
    with pytest.raises(ValueError, match="empty"):
        stv.passthrough_cuda(torch.empty((2, 0), device=cuda_device),
                             100, 2, 3, 128)
    assert stv.LAUNCHES.get(stv.PASSTHROUGH, 0) == before
    x = torch.ones((2, 1), device=cuda_device)
    got = stv.passthrough_cuda(x, 100, 2, 3, 128)
    assert torch.equal(got, stv.passthrough_plain(x, 100, 2, 3, 128))
    assert float(got.sum()) == 2.0


def test_passthrough_out_of_range_raises_before_launch(cuda_device):
    x = _randn((1, 1_000), cuda_device)
    before = stv.LAUNCHES.get(stv.PASSTHROUGH, 0)
    for kw in (dict(rows=2**24), dict(hop=1_000, lanes=1_024, rows=2)):
        with pytest.raises(ValueError):
            stv.passthrough_cuda(x, **kw)
    assert stv.LAUNCHES.get(stv.PASSTHROUGH, 0) == before


# ---- the streaming tier on the card ------------------------------------------


def _tagged(i):
    return np.full((3, 2, 4, 1), float(i) + 0.3, np.float32)


@pytest.mark.parametrize("wire", [None, "bfloat16", "int8"])
def test_prefetch_loader_on_card_matches_cpu(cuda_device, wire):
    """Pinned buffers and the side-stream copy give the CPU loader's
    batches, on the card, in order, the last one padded."""
    from spectrogram_cube_clustering_tpu_torch import data
    from spectrogram_cube_clustering_tpu_torch.core import dequant_wire

    got, want = ([(dequant_wire(b), n) for b, n in data.PrefetchLoader(
        _tagged, 7, 4, num_workers=3, transfer_dtype=wire, device=dev)]
        for dev in (cuda_device, "cpu"))
    assert [n for _, n in got] == [n for _, n in want] == [4] * 5 + [1]
    for (g, _), (w, _) in zip(got, want):
        assert g.device.type == torch.device(cuda_device).type
        assert torch.equal(g.cpu(), w)


def test_stream_aec_and_dec_on_card_match_cpu(cuda_device):
    """A stream AEC epoch and a stream DEC epoch with a refresh from the
    same weights: losses within rtol 1e-3 (cuDNN against CPU convs, both
    float32 with TF32 off), DEC labels equal where the top-two gap
    exceeds 1e-4."""
    from spectrogram_cube_clustering_tpu_torch import data

    x = _tone_windows(384).numpy()

    def loader(dev):
        return lambda: data.PrefetchLoader(
            lambda i: x[i * 32:(i + 1) * 32], 12, 64, num_workers=2,
            device=dev)

    sd = _dec(2).state_dict()
    hist, labels = [], []
    for dev in ("cpu", cuda_device):
        aec = models.AEC(device=dev)
        aec.load_state_dict({k: v for k, v in sd.items()
                             if k != "clustering.weights"})
        a = train.train_aec_stream(
            aec, train.create_train_state(aec, 1e-3), loader(dev),
            train.AECConfig(n_epochs=1))
        dec = models.DEC(5, device=dev)
        dec.load_state_dict(sd)
        d = train.train_dec_stream(
            dec, train.create_train_state(dec, 1e-3), loader(dev), len(x),
            train.DECConfig(n_clusters=5, n_epochs=1, tol=0.0, init="rand"))
        hist.append(a["history"]["train"] + d["history"]["total"])
        labels.append(d["labels"])
    assert not any(tf32_flags().values())
    np.testing.assert_allclose(hist[1], hist[0], rtol=1e-3)
    _, teval = train.make_stream_fns(dec.cpu(), 0.001)
    q = train.full_eval_stream(teval, loader("cpu"), len(x))[0]
    top2 = np.sort(q, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-4
    np.testing.assert_array_equal(labels[1][clear], labels[0][clear])


@pytest.mark.parametrize("wire", ["bfloat16", "int8"])
def test_predictor_over_a_wire_on_card_matches_cpu(cuda_device, wire):
    """The same wire on both sides restores the same float32 windows: the
    card's answers within the predictor test's rtol 1e-4 / atol 1e-5, for
    windows and for the fused waveform route."""
    sd = _dec(3).state_dict()
    x = _randn((300, 4, 101, 1), torch.device("cpu"), seed=4).numpy()
    wave = _randn((2, 20_000), torch.device("cpu"), seed=5).numpy()
    got, want = (serve.DECPredictor(sd, 5, max_batch=128, buckets=True,
                                    transfer_dtype=wire, device=dev)
                 for dev in (cuda_device, "cpu"))
    a, b = got(x), want(x)
    np.testing.assert_allclose(a["q"], b["q"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(a["z"], b["z"], rtol=1e-4, atol=1e-5)
    a = serve.WaveformFrontend(got, chunk_samples=8_000)(wave)
    b = serve.WaveformFrontend(want, chunk_samples=8_000)(wave)
    np.testing.assert_allclose(a["q"], b["q"], rtol=1e-4, atol=1e-5)


def test_tsne_optimiser_on_card_matches_cpu(cuda_device):
    """The on-device t-SNE's gradient loop from one P and y0, across the
    switch at iteration 250, in blocks of 128 rows: y on the card within
    rtol 1e-3 / atol 1e-6 of the CPU's and the KL within rtol 1e-3 (the
    JAX package's chunked-against-dense tolerances)."""
    import importlib

    tsne = importlib.import_module(
        "spectrogram_cube_clustering_tpu_torch.cluster.tsne_torch")
    x = np.random.default_rng(0).normal(size=(500, 9)).astype(np.float32)
    perplexity, lr = tsne.default_hyperparameters(len(x))
    p = tsne._joint_p(torch.from_numpy(x), perplexity, chunk=128)
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        y0 = tsne.initial_embedding(len(x), 1, dev)
        (y, _, _), kl = tsne._optimize(
            p.to(dev), (y0, torch.zeros_like(y0), torch.ones_like(y0)), 245,
            lr, 20.0, 10, chunk=128, with_kl=True)
        out[dev.type] = (y.cpu(), kl.cpu())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-3,
                               atol=1e-6)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-3,
                               atol=0)


@pytest.fixture(params=["gloo", "nccl"])
def card_mesh(request, cuda_device):
    """A one-rank group on the card, over gloo with CUDA tensors (the
    backend of several ranks on one card) or NCCL; destroyed after the
    test."""
    import socket

    import torch.distributed as dist

    from spectrogram_cube_clustering_tpu_torch import core

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    core.initialize_distributed(f"127.0.0.1:{port}", 1, 0,
                                device=cuda_device, backend=request.param)
    try:
        yield core.make_data_mesh()
    finally:
        dist.destroy_process_group()


def test_mesh_collectives_on_card(card_mesh):
    """Sum, broadcast and gather keep CUDA tensors on the card."""
    x = torch.arange(6, dtype=torch.float32, device=card_mesh.device)
    assert card_mesh.device.type == "cuda"
    for got in (card_mesh.sum_(x.clone()), card_mesh.broadcast_(x.clone()),
                card_mesh.gather(x)[0]):
        assert got.device == x.device
        assert torch.equal(got, x)
    card_mesh.barrier()


def test_sharded_spectrogram_on_card_launches_k1(card_mesh):
    """The time-sharded STFT on the card is K1 over the shard plus its
    halo: one launch, within 1e-6 of K1 on the whole waveform."""
    from spectrogram_cube_clustering_tpu_torch import parallel

    x = _randn((3, 20_000), card_mesh.device, seed=6)
    before = cuda_stft.LAUNCHES
    got = parallel.sharded_spectrogram(x, card_mesh)
    torch.cuda.synchronize()
    assert cuda_stft.LAUNCHES == before + 1
    want = cuda_stft.spectrogram_cuda(x)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-6


def test_sharded_aec_epoch_on_card_matches_one_device(card_mesh):
    """An AEC epoch through the mesh's layout, loss and gradient sum
    against the same epoch without a mesh on the card: losses within
    rtol 1e-4 (two card runs' cuDNN backward may sum in other orders)."""
    x = _tone_windows(300).to(card_mesh.device)
    sd = _dec(2).state_dict()
    sd = {k: v for k, v in sd.items() if k != "clustering.weights"}
    losses = []
    for mesh in (None, card_mesh):
        model = models.AEC(device=card_mesh.device)
        model.load_state_dict(sd)
        out = train.train_aec(
            model, train.create_train_state(model, 1e-3, mesh),
            train.make_batched_data(x, 64, mesh), None,
            train.AECConfig(n_epochs=2, early_stopping=False))
        losses.append(out["history"]["train"])
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)


def test_sharded_gmm_on_card_matches_dense(card_mesh):
    """`parallel.sharded_gmm` on the card against the dense `gmm`: NMI
    >= 0.99 on planted blobs."""
    from spectrogram_cube_clustering_tpu_torch import parallel

    rng = np.random.default_rng(0)
    centres = rng.normal(size=(4, 9)) * 5
    z = (centres[rng.integers(0, 4, 2_000)]
         + rng.normal(size=(2_000, 9))).astype(np.float32)
    got = parallel.sharded_gmm(z, 4, card_mesh, n_init=10)[0]
    want = cluster.gmm(z, 4, n_init=10, device=card_mesh.device)[0]
    assert got.device.type == "cuda"
    assert cluster.nmi(want.cpu().numpy(), got.cpu().numpy()) >= 0.99


def test_mesh_serving_on_card_matches_one_device(card_mesh, cuda_device):
    """A one-rank mesh predictor and its mesh-fused frontend on the card
    against the same model without a mesh: q and z within rtol 1e-5 /
    atol 1e-7, labels equal, K1 launched once a chunk."""
    sd = _dec(4).state_dict()
    mesh_pred = serve.DECPredictor(sd, 5, max_batch=64, buckets=True,
                                   mesh=card_mesh)
    one = serve.DECPredictor(sd, 5, max_batch=64, buckets=True,
                             device=cuda_device)
    wave = _randn((2, 30_000), "cpu", seed=8).numpy()
    fused = serve.WaveformFrontend(mesh_pred, chunk_samples=8_000, fuse=True)
    before = cuda_stft.LAUNCHES
    got = fused(wave)
    assert cuda_stft.LAUNCHES - before == 4  # 74 windows, 20 a chunk
    want = serve.WaveformFrontend(one)(wave)
    windows = fused.windows(wave)
    for a, b in ((got, want), (mesh_pred(windows), one(windows))):
        for k in ("q", "z"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-7)
        np.testing.assert_array_equal(a["labels"], b["labels"])
    mesh_pred.close()


def test_gap_statistic_on_card_matches_cpu(cuda_device):
    """`cluster.gap_statistic` on the card against the CPU on planted
    blobs: k-means++ draws from the CPU's generator on both, so the fits
    start alike and the data inertias agree within rtol 1e-4 at every K,
    past the planted 4 too."""
    rng = np.random.default_rng(0)
    centres = rng.normal(size=(4, 9)) * 5
    z = (centres[rng.integers(0, 4, 2_000)]
         + rng.normal(size=(2_000, 9))).astype(np.float32)
    got = cluster.gap_statistic(z, [2, 3, 4, 5, 6], device=cuda_device)
    want = cluster.gap_statistic(z, [2, 3, 4, 5, 6], device="cpu")
    np.testing.assert_allclose(got["inertia"], want["inertia"], rtol=1e-4)
    assert np.isfinite(got["gap_g"]).all() and np.isfinite(got["gap_u"]).all()


# ---------------------------------------------- transposed convolutions


def _decoder_layer(hw, i, rows, device):
    """(the i-th ConvTranspose2d of a seeded decoder at `hw` on `device`,
    a (rows, C_in, H, W) input for it: the layers before it over seeded
    latents, plus noise, so ReLU cuts some outputs and not others)."""
    dec = models.AEC(input_hw=hw,
                     generator=torch.Generator().manual_seed(i)).decoder
    dec.to(device)
    convs = [m for m in dec.decoder if isinstance(m, torch.nn.ConvTranspose2d)]
    with torch.no_grad():
        h = dec.decoder[:3](_randn((rows, 9), device, seed=i).abs())
        for m in convs[:i]:
            h = torch.relu(m(h))
        h = h + 0.1 * _randn(h.shape, device, seed=i + 1)
    return convs[i], h.contiguous()


@pytest.mark.parametrize("dtype", ["float32", "bf16_autocast"])
@pytest.mark.parametrize("rows", [1, 7, 512, 4096])
@pytest.mark.parametrize("hw,i", [(hw, i) for hw in [(4, 101), (87, 100)]
                                  for i in range(4)])
def test_convt_kernel_matches_plain(cuda_device, hw, i, rows, dtype):
    """Each decoder layer through the kernel against the plain version
    (cuDNN's transposed convolution, its bias add, then relu) on the same
    inputs. float32 (TF32 off): both sum at most 72 float32 products in
    other orders, so within rtol 1e-5 and 1e-6 of the largest output.
    Under bfloat16 autocast both round the float32 sum to bfloat16 before
    the bias and again after. The kernel equals the float64 bias-free sum
    of the same casts rounded so, bit for bit, wherever a float32 sum of
    at most 72 products (error under 80 * 2^-24 of the sum of their
    magnitudes) cannot reach the midpoint its first rounding turns on;
    at the rest its first rounding may fall the other way: within that
    error, one step of the sum and one of the output. And it lies within
    one step (rtol 2^-7) and half a step of the largest bias-free sum of
    the plain version, whose first rounding may fall the other way."""
    from spectrogram_cube_clustering_tpu_torch.core import fp32_policy

    fp32_policy()
    m, x = _decoder_layer(hw, i, rows, cuda_device)
    args = (m.weight, m.bias, m.stride, m.padding, m.output_padding)
    geo = args[2:]
    bf16 = dtype != "float32"
    before = cuda_convt.LAUNCHES
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16,
                                         enabled=bf16):
        got = cuda_convt.conv_transpose_relu(x, *args)
        want = torch.relu(torch.nn.functional.conv_transpose2d(
            x, *args[:2], *geo))
    assert cuda_convt.LAUNCHES == before + 1
    assert got.dtype == want.dtype == (
        torch.bfloat16 if bf16 else torch.float32)
    assert got.shape == want.shape
    scale = float(want.float().abs().max())
    assert scale > 0
    if not bf16:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * scale)
        return
    cast = [None if t is None else t.bfloat16().double() for t in args[:2]]
    with torch.no_grad():
        unbiased = torch.nn.functional.conv_transpose2d(
            x.bfloat16().double(), cast[0], None, *geo)
        slack = 80 * 2.0**-24 * torch.nn.functional.conv_transpose2d(
            x.bfloat16().double().abs(), cast[0].abs(), None, *geo)
        first = unbiased.bfloat16().double()
        step = torch.ldexp(torch.ones_like(first),
                           torch.frexp(unbiased)[1] - 8)
        near = 0.5 * step - (unbiased - first).abs() <= slack
        exact = (first if cast[1] is None else (
            first + cast[1][:, None, None]).bfloat16().double()).relu()
    assert float(near.double().mean()) < 0.1
    assert torch.equal(got.double()[~near], exact[~near])
    tol = slack + step + 2.0**-7 * torch.maximum(got.double().abs(),
                                                 exact.abs())
    assert bool(((got.double() - exact).abs() <= tol).all())
    torch.testing.assert_close(got.float(), want.float(), rtol=2**-7,
                               atol=2**-8 * float(unbiased.abs().max()))


def test_convt_kernel_is_deterministic(cuda_device):
    m, x = _decoder_layer((87, 100), 2, 512, cuda_device)
    args = (m.weight.detach(), m.bias.detach(), m.stride, m.padding,
            m.output_padding)
    first = cuda_convt.convt_relu_cuda(x, *args)
    assert all(torch.equal(cuda_convt.convt_relu_cuda(x, *args), first)
               for _ in range(5))


@pytest.mark.parametrize("name", ["AEC", "DEC"])
def test_decoder_forward_launches_four_kernels(cuda_device, name):
    model = (models.AEC(input_hw=(87, 100)) if name == "AEC"
             else models.DEC(5, input_hw=(87, 100))).to(cuda_device)
    x = _randn((16, 87, 100, 1), cuda_device)
    before = cuda_convt.LAUNCHES
    model(x)
    with torch.no_grad():
        model(x)
    model.decoder(_randn((3, 9), cuda_device).abs())
    assert cuda_convt.LAUNCHES == before + 12


@pytest.mark.parametrize("name", ["AEC", "DEC"])
@pytest.mark.parametrize("hw", [(4, 101), (87, 100)])
def test_train_step_gradients_on_card_match_cpu(cuda_device, name, hw):
    """One step's loss and gradients from the same weights and windows:
    the card (kernel forward, cuDNN backward, float32 with TF32 off)
    against the CPU, leaf by leaf within rtol 1e-4 and 1e-5 of the leaf's
    largest gradient (sums in other orders)."""
    from spectrogram_cube_clustering_tpu_torch.core import fp32_policy

    fp32_policy()
    gen = torch.Generator().manual_seed(11)
    make = (lambda: models.AEC(input_hw=hw)) if name == "AEC" else (
        lambda: models.DEC(5, input_hw=hw))
    sd = (models.AEC(input_hw=hw, generator=gen) if name == "AEC"
          else models.DEC(5, input_hw=hw, generator=gen)).state_dict()
    x = _randn((64, *hw, 1), torch.device("cpu"), seed=12)
    out = []
    for dev in ("cpu", cuda_device):
        model = make().to(dev)
        model.load_state_dict(sd)
        before = cuda_convt.LAUNCHES
        if name == "AEC":
            x_rec, _ = model(x.to(dev))
            loss = torch.mean((x_rec - x.to(dev)) ** 2)
        else:
            q, x_rec, _ = model(x.to(dev))
            loss = torch.mean((x_rec - x.to(dev)) ** 2) + q.max(1).values.mean()
        loss.backward()
        assert cuda_convt.LAUNCHES - before == (0 if dev == "cpu" else 4)
        out.append((loss.item(), {n: p.grad.cpu() for n, p in
                                  model.named_parameters()}))
    (want_loss, want), (got_loss, got) = out
    assert got_loss == pytest.approx(want_loss, rel=1e-5)
    for n, g in want.items():
        torch.testing.assert_close(got[n], g, rtol=1e-4,
                                   atol=1e-5 * float(g.abs().max()),
                                   msg=n)


@pytest.mark.parametrize("name", ["AEC", "DEC"])
def test_train_step_peak_on_card_no_higher_than_the_modules(cuda_device,
                                                            name):
    """`max_memory_allocated` over one 512-row step at (87, 100): the
    kernel's route, whose autograd nodes save and free what the modules'
    did, against the decoder's old module-by-module forward."""
    from spectrogram_cube_clustering_tpu_torch.core import fp32_policy

    fp32_policy()
    model = (models.AEC(input_hw=(87, 100)) if name == "AEC"
             else models.DEC(5, input_hw=(87, 100))).to(cuda_device)
    x = _randn((512, 87, 100, 1), cuda_device)

    def step():
        out = model(x)
        x_rec = out[0] if name == "AEC" else out[1]
        loss = torch.mean((x_rec - x) ** 2)
        if name == "DEC":
            loss = loss + out[0].max(1).values.mean()
        loss.backward()
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated()

    peaks = {}
    for route in ("kernel", "modules", "kernel"):
        forward = (models.Decoder.forward if route == "kernel"
                   else lambda self, z: self.decoder(z).permute(0, 2, 3, 1))
        model.decoder.forward = forward.__get__(model.decoder)
        step()
        torch.cuda.reset_peak_memory_stats()
        peaks[route] = step()
    assert peaks["kernel"] <= peaks["modules"], peaks


def test_decoder_eval_on_card_holds_one_layer_at_a_time(cuda_device):
    """Under no_grad the chain frees each layer's input once its output
    exists: a 4,096-row (87, 100) decoder forward holds at most the
    Linear's two outputs and one layer's input and output (plus 1% and
    4 MiB for the allocator's rounding), where keeping every layer's
    output would hold 30% more."""
    dec = models.AEC(input_hw=(87, 100)).decoder.to(cuda_device)
    z = _randn((4096, 9), cuda_device)
    with torch.no_grad():
        sizes = [dec.decoder[:3](z).numel()]
        h = dec.decoder[:3](z)
        for m in dec.decoder[3::2]:
            h = torch.relu(m(h))
            sizes.append(h.numel())
        del h
        dec(z)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = dec(z)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
    assert out.shape == (4096, 87, 100, 1)
    pair = max(a + b for a, b in zip(sizes, sizes[1:]))
    bound = 4 * (pair + 2 * sizes[0]) * 1.01 + 4 * 2**20
    assert peak <= bound, (peak, bound)
    assert 4 * sum(sizes) > 1.3 * 4 * pair


def test_convt_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    m, x = _decoder_layer((4, 101), 1, 8, cuda_device)
    w, b = m.weight.detach(), m.bias.detach()
    geo = (m.stride, m.padding, m.output_padding)
    strided = x.transpose(2, 3).contiguous().transpose(2, 3)
    assert not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        cuda_convt.convt_relu_cuda(strided, w, b, *geo)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_convt.convt_relu_cuda(x, w.transpose(2, 3).contiguous()
                                   .transpose(2, 3), b, *geo)
    for bad in (torch.float64, torch.float16):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            cuda_convt.convt_relu_cuda(x.to(bad), w.to(bad), b.to(bad), *geo)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cuda_convt.convt_relu_cuda(x.bfloat16(), w, b, *geo)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_convt.convt_relu_cuda(x, w.cpu(), b, *geo)
    with pytest.raises(ValueError, match="built for"):
        cuda_convt.convt_relu_cuda(x, w[:, :4].contiguous(), b[:4], *geo)
