"""The torch port on the card: the CUDA STFT kernel and its precision,
interior and layout variants against their plain versions, and the serving and
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
from spectrogram_cube_clustering_tpu_torch.ops import cuda_stft
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
    """Same rounded operands, float32 sums in another order: p99.9 of the
    log10 gap within 1e-4 (log, and power through log10); c within 1e-5
    of its frame's sum |x * w|."""
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
    """The same float32 operands and order of partials, float32 sums in
    another order inside each: p99.9 of the log10 gap within 1e-4, and
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
