"""The port's wire dtypes (`core.precision`), its copy of the streaming
normalizer (`data.h5.normalize_specgram`) and the predictors'
`transfer_dtype`, against the JAX package's on the CPU.

Tolerances, each stated at its test: the normalizer, the int8 codes and
scales, and the bfloat16 / float16 bits equal (bit for bit; bfloat16
against `ml_dtypes`, which only this test imports); the int8 round trip
within half a step of each sample's absmax / 127; predictions over a wire
at the serving tests' rtol 2e-4 / atol 1e-6 with labels equal, since both
sides restore the same float32 inputs from the same encoding (the
two-pass waveform route from the port's windows on both sides); at a
sharp q, the fused route's q and its gap to float32 within atol 1e-5 of
the JAX frontend's.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import spectrogram_cube_clustering_tpu as scc
from spectrogram_cube_clustering_tpu import serve as jserve
from spectrogram_cube_clustering_tpu.core import precision as jprecision
from spectrogram_cube_clustering_tpu.data import h5 as jh5
from spectrogram_cube_clustering_tpu_torch import core, serve
from spectrogram_cube_clustering_tpu_torch.core import precision
from spectrogram_cube_clustering_tpu_torch.data import h5
from spectrogram_cube_clustering_tpu_torch.utils import weights

TOL = dict(rtol=2e-4, atol=1e-6)
MAX_BATCH = 16
WIRES = ["bfloat16", "float16", "int8"]


def _batch(shape=(8, 4, 101, 1), seed=0):
    """Windows whose samples differ in amplitude by up to 10^6, so a
    per-batch int8 scale would crush the small ones."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    return x * (10.0 ** rng.integers(-3, 4, size=(shape[0],)
                                     + (1,) * (len(shape) - 1))
                ).astype(np.float32)


# ---- the normalizer copy ---------------------------------------------------


@pytest.mark.parametrize("transform", [None, "sample_normalization",
                                       "sample_norm_cent", "vec_norm"])
def test_normalize_specgram_equals_jax(transform):
    """Bit-equal to the JAX copy for every transform, on (n, 1, H, W)."""
    x = np.moveaxis(_batch(seed=3), -1, 1)
    got = h5.normalize_specgram(x, transform)
    want = jh5.normalize_specgram(x, transform)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unknown transform"):
        h5.normalize_specgram(x, "zscore")


# ---- the encodings -----------------------------------------------------------


def test_wire_dtype_names():
    assert core.wire_dtype(None) is None
    assert core.wire_dtype("bfloat16") == torch.bfloat16
    assert core.wire_dtype("float16") == torch.float16
    assert core.wire_dtype("int8") == torch.int8
    with pytest.raises(ValueError, match="transfer_dtype"):
        core.wire_dtype("int4")


@pytest.mark.parametrize("shape", [(8, 4, 101, 1), (3, 7), (1_700,)])
def test_int8_codes_and_scales_equal_jax(shape):
    """Per-sample scales (axis 0), one scale for a rank-1 segment: codes
    and scales bit-equal to the JAX encoder's."""
    x = _batch(shape, seed=len(shape))
    got = core.quantize_wire(x, core.wire_dtype("int8"))
    want = jprecision.quantize_wire(x, jprecision.wire_dtype("int8"))
    assert got["q"].dtype == torch.int8
    np.testing.assert_array_equal(got["q"].numpy(), want["q"])
    np.testing.assert_array_equal(got["scale"].numpy(), want["scale"])
    assert got["scale"].shape == ((shape[0],) + (1,) * (len(shape) - 1)
                                  if len(shape) > 1 else (1,))


@pytest.mark.parametrize("name", ["bfloat16", "float16"])
def test_float_wire_bits_equal_numpy(name):
    """torch's round-to-nearest-even casts give the bits of ml_dtypes' /
    numpy's, so the JAX and port wires carry the same values; the
    specials (inf, subnormals, ties) included, and NaN stays NaN."""
    x = np.concatenate([
        _batch((64, 9), seed=5).ravel(),
        np.float32([np.inf, -np.inf, np.nan, 0.0, -0.0, 1e-40, 3e38]),
        np.float32(1.0) + np.arange(-8, 8, dtype=np.float32) * 2.0 ** -8,
    ])
    got = core.quantize_wire(x, core.wire_dtype(name))
    with np.errstate(over="ignore"):  # 3e38 overflows float16 to inf
        want = x.astype(jprecision.wire_dtype(name))
    # a NaN stays a NaN; its payload bits are the cast's own
    nan = np.isnan(x)
    assert torch.isnan(got.float()).numpy().tolist() == nan.tolist()
    bits = np.uint16
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy().view(bits)[~nan], want.view(bits)[~nan])
    assert want.dtype == (np.dtype(ml_dtypes.bfloat16) if name == "bfloat16"
                          else np.float16)


def test_int8_round_trip_bound_and_full_width_passthrough():
    """dequant(quantize(x)) within half a step of each sample's own absmax
    / 127; the full-width wire passes x through unchanged; the stream
    predict's on-device encoder (`quantize_tensor`) gives the host
    encoder's codes and scales."""
    x = _batch()
    enc = core.quantize_wire(x, torch.int8)
    back = core.dequant_wire(enc).numpy()
    absmax = np.max(np.abs(x), axis=(1, 2, 3), keepdims=True)
    bound = np.broadcast_to(0.5 * absmax / 127.0 + 1e-12, x.shape)
    np.testing.assert_array_less(np.abs(back - x), bound)
    np.testing.assert_array_equal(
        core.dequant_wire(core.quantize_wire(x, None)).numpy(), x)
    assert core.wire_array(enc) is enc["q"]
    on_device = precision.quantize_tensor(torch.from_numpy(x), torch.int8)
    assert torch.equal(on_device["q"], enc["q"])
    assert torch.equal(on_device["scale"], enc["scale"])
    half = precision.quantize_tensor(torch.from_numpy(x), torch.bfloat16)
    assert torch.equal(half, core.quantize_wire(x, torch.bfloat16))


# ---- the predictors' transfer_dtype -----------------------------------------


@pytest.fixture(scope="module")
def trained():
    """A JAX DEC whose centroids sit at real latents, as a port
    state_dict too, and windows (the serving tests' fixture)."""
    x, _ = scc.data.synthetic_windows(64, n_classes=3, seed=1)
    xn = scc.ops.sample_norm_cent(jnp.asarray(x))
    model = scc.models.DEC(n_clusters=3)
    params = model.init(jax.random.key(0), xn[:2])["params"]
    z = model.apply({"params": params}, xn, method="encode")
    params = scc.models.replace_centroids(params, np.asarray(z)[[0, 21, 42]])
    return params, weights.state_dict_from_jax_params(params), x


def _assert_same(got, want):
    for k in ("q", "z"):
        if k in want:
            np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
    if "labels" in want:
        np.testing.assert_array_equal(got["labels"], want["labels"])


@pytest.mark.parametrize("wire", WIRES)
def test_predictors_over_a_wire_match_jax(trained, wire):
    """DECPredictor and AECEncoder with each transfer_dtype against the
    JAX predictors with the same one, over two chunks and a padded one;
    the wire moves q away from the float32 request's (the inputs are
    quantized), so the check is not vacuous."""
    params, sd, x = trained
    batch = np.concatenate([x, x])[:2 * MAX_BATCH + 5]
    jp = jserve.DECPredictor(params, 3, max_batch=MAX_BATCH, buckets=True,
                             transfer_dtype=wire)
    tp = serve.DECPredictor(sd, 3, max_batch=MAX_BATCH, buckets=True,
                            transfer_dtype=wire, device="cpu")
    got = tp(batch)
    _assert_same(got, jp(batch))
    full = serve.DECPredictor(sd, 3, max_batch=MAX_BATCH, device="cpu")
    assert not np.array_equal(got["q"], full(batch)["q"])
    aec = {"encoder": params["encoder"], "decoder": params["decoder"]}
    want = jserve.AECEncoder(aec, max_batch=MAX_BATCH,
                             transfer_dtype=wire)(batch)
    enc = serve.AECEncoder(sd, max_batch=MAX_BATCH, transfer_dtype=wire,
                           device="cpu")
    np.testing.assert_allclose(enc(batch), want, **TOL)


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("fuse", [None, False])
def test_waveform_frontend_over_a_wire_matches_jax(trained, wire, fuse):
    """The fused route carries each chunk's raw samples over the wire (one
    int8 scale per channel and segment, as the JAX frontend's rank-1
    segments) and is held to the JAX frontend; the two-pass route carries
    the windows and is held to the JAX predictor on the same windows;
    three channels over several chunks with a ragged last one."""
    params, sd, _ = trained
    rng = np.random.default_rng(3)
    wave = (rng.normal(size=(3, 5_000)) * rng.lognormal(size=(3, 1))
            ).astype(np.float32)
    jp = jserve.DECPredictor(params, 3, max_batch=MAX_BATCH, buckets=True,
                             transfer_dtype=wire)
    tp = serve.DECPredictor(sd, 3, max_batch=MAX_BATCH, buckets=True,
                            transfer_dtype=wire, device="cpu")
    jf = jserve.WaveformFrontend(jp, chunk_samples=1_600, fuse=fuse)
    tf = serve.WaveformFrontend(tp, chunk_samples=1_600, fuse=fuse)
    assert tf.fused == jf.fused == (fuse is None)
    got, want = tf(wave), jf(wave)
    np.testing.assert_array_equal(got["windows_per_channel"],
                                  want["windows_per_channel"])
    if not tf.fused:
        # the two-pass wire encodes windows, and the two STFTs' windows
        # differ by up to 2e-4 (test_torch_serve): enough to round a
        # window to the next bfloat16 step. The JAX predictor is held to
        # the port's own windows instead, over the same wire.
        want = jp(tf.windows(wave))
    _assert_same(got, want)


@pytest.mark.parametrize("wire", WIRES)
def test_sharp_q_moves_with_the_wire_as_in_jax(trained, wire):
    """At a sharp q, as a trained DEC's, the wire alone moves q past the
    JAX serve tests' bound (5e-3 bfloat16, 3e-2 int8), and it moves the
    JAX frontend's q the same way: the fused route's q over the wire and
    its gap to the float32 request's agree with the JAX frontend's within
    atol 1e-5 (measured ~1.7e-6), so the gap is the encoding's and not
    the port's. The model is sharpened by scaling the latent layer and
    the centroids by 100 (distances x100)."""
    params, _, _ = trained
    enc = dict(params["encoder"])
    enc["Dense_0"] = {k: v * 100.0 for k, v in enc["Dense_0"].items()}
    sharp = dict(params, encoder=enc, centroids=params["centroids"] * 100.0)
    sd = weights.state_dict_from_jax_params(sharp)
    rng = np.random.default_rng(3)
    wave = (rng.normal(size=(3, 5_000)) * rng.lognormal(size=(3, 1))
            ).astype(np.float32)
    got, want = {}, {}
    for w in (None, wire):
        jp = jserve.DECPredictor(sharp, 3, max_batch=MAX_BATCH, buckets=True,
                                 transfer_dtype=w)
        tp = serve.DECPredictor(sd, 3, max_batch=MAX_BATCH, buckets=True,
                                transfer_dtype=w, device="cpu")
        got[w] = serve.WaveformFrontend(tp, chunk_samples=1_600)(wave)["q"]
        want[w] = jserve.WaveformFrontend(jp, chunk_samples=1_600)(wave)["q"]
    gap = np.abs(got[wire] - got[None]).max()
    if wire != "float16":
        assert gap > {"bfloat16": 5e-3, "int8": 3e-2}[wire]
    np.testing.assert_allclose(got[wire], want[wire], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[wire] - got[None], want[wire] - want[None],
                               rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def trained_dec():
    """A port DEC trained on five tone kinds (AEC 10 epochs, k-means init,
    DEC 30 epochs with gamma 1 at batch 8: enough steps on 198 windows to
    sharpen q, median top value ~0.75 against 0.2 uniform), its JAX
    params (`utils.torch_port.dec_params_from_torch`), and a two-channel
    waveform of those kinds."""
    from spectrogram_cube_clustering_tpu.utils import torch_port
    from spectrogram_cube_clustering_tpu_torch import models, signal, train
    from torch_train_common import _waveform

    # one intra-op thread: under the suite's parallel workers more only
    # contend for the cores (torch_train_common.one_torch_thread)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    wave, _ = _waveform(2, 40_000, seed=0)
    x = signal.spectrogram_windows(torch.from_numpy(wave))
    data = train.make_batched_data(x, 8)
    gen = torch.Generator().manual_seed(1)
    aec = models.AEC(generator=gen)
    train.train_aec(aec, train.create_train_state(aec, 1e-3), data, None,
                    train.AECConfig(n_epochs=10, early_stopping=False))
    dec = models.load_encoder_decoder_from_aec(
        models.DEC(5, generator=gen), aec)
    train.train_dec(dec, train.create_train_state(dec, 2e-3), data,
                    train.DECConfig(n_clusters=5, n_epochs=30, gamma=1.0,
                                    init="kmeans", kmeans_n_init=10,
                                    tol=0.0))
    torch.set_num_threads(threads)
    sd = {k: v.detach().clone() for k, v in dec.state_dict().items()}
    return torch_port.dec_params_from_torch(sd), sd, wave[:, :20_000]


@pytest.mark.parametrize("wire", WIRES)
def test_trained_q_moves_with_the_wire_as_in_jax(trained_dec, wire):
    """At a trained DEC's sharp q, the fused route's gap to the float32
    request over each wire is the JAX frontend's own gap within atol 1e-5
    (both restore the same encoded samples; the rest is float32
    rounding), and q itself agrees within 1e-5: the gap that phase 4g
    reads on the card belongs to the encoding, not to the port."""
    params, sd, wave = trained_dec
    got, want = {}, {}
    for w in (None, wire):
        jp = jserve.DECPredictor(params, 5, max_batch=64, transfer_dtype=w)
        tp = serve.DECPredictor(sd, 5, max_batch=64, transfer_dtype=w,
                                device="cpu")
        got[w] = serve.WaveformFrontend(tp, chunk_samples=8_000)(wave)["q"]
        want[w] = jserve.WaveformFrontend(jp, chunk_samples=8_000)(wave)["q"]
    assert np.median(got[None].max(axis=1)) > 0.7  # a sharp q
    gap, jgap = got[wire] - got[None], want[wire] - want[None]
    print(f"trained DEC, {wire}: port gap {np.abs(gap).max():.4e}, "
          f"JAX gap {np.abs(jgap).max():.4e}, their difference "
          f"{np.abs(gap - jgap).max():.3e}")
    np.testing.assert_allclose(got[wire], want[wire], rtol=0, atol=1e-5)
    np.testing.assert_allclose(gap, jgap, rtol=0, atol=1e-5)


def test_serve_cli_passes_the_wire(trained, tmp_path, monkeypatch):
    """`scc-serve-torch --transfer-dtype int8` serves a predictor whose
    requests cross the int8 wire."""
    from spectrogram_cube_clustering_tpu_torch import serve_http

    _, sd, _ = trained
    path = str(tmp_path / "DEC.pt")
    torch.save(sd, path)
    served = {}

    class Served(Exception):
        pass

    def make_server(predictor, **kw):
        served["predictor"] = predictor
        raise Served

    monkeypatch.setattr(serve_http, "make_server", make_server)
    with pytest.raises(Served):
        serve_http.main([path, "--n-clusters", "3", "--max-batch", "16",
                         "--transfer-dtype", "int8", "--device", "cpu"])
    assert served["predictor"]._wire_dtype == torch.int8
    with pytest.raises(SystemExit):
        serve_http.main([path, "--n-clusters", "3", "--transfer-dtype",
                         "int4", "--device", "cpu"])
