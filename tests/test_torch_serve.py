"""The torch port's serving slice against the JAX package's: predictors,
the raw-waveform frontend and the HTTP server, with the same weights
(carried by `utils.weights.state_dict_from_jax_params`) and the same
numpy requests.

q and z agree at rtol 2e-4 / atol 1e-6, the JAX package's own
predictor-against-model tolerance (tests/test_serve.py:39), and labels
are equal. Both sides run on the CPU, where the port's STFT is its plain
rfft version and the JAX frontend takes its rfft path.
"""

import io
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spectrogram_cube_clustering_tpu as scc
from spectrogram_cube_clustering_tpu import serve as jserve
from spectrogram_cube_clustering_tpu import serve_http as jserve_http
from spectrogram_cube_clustering_tpu.utils import torch_port
from spectrogram_cube_clustering_tpu_torch import serve, serve_http
from spectrogram_cube_clustering_tpu_torch.utils import weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-4, atol=1e-6)
MAX_BATCH = 16


@pytest.fixture(scope="module")
def trained():
    """JAX DEC params whose centroids sit near real latents (so q is far
    from uniform), the same weights as a port state_dict, and windows."""
    x, _ = scc.data.synthetic_windows(64, n_classes=3, seed=1)
    xn = scc.ops.sample_norm_cent(jnp.asarray(x))
    model = scc.models.DEC(n_clusters=3)
    params = model.init(jax.random.key(0), xn[:2])["params"]
    z = model.apply({"params": params}, xn, method="encode")
    params = scc.models.replace_centroids(params, np.asarray(z)[[0, 21, 42]])
    return params, weights.state_dict_from_jax_params(params), x


@pytest.fixture(scope="module")
def predictors(trained):
    params, sd, x = trained
    jp = jserve.DECPredictor(params, 3, max_batch=MAX_BATCH, buckets=True)
    tp = serve.DECPredictor(sd, 3, max_batch=MAX_BATCH, buckets=True,
                            device="cpu")
    return jp, tp, x


def _waves(shape, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * rng.lognormal(size=shape[:-1] + (1,))
            ).astype(np.float32)


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in ("q", "z"):
        if k in want:
            assert got[k].dtype == want[k].dtype == np.float32
            np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
    if "labels" in want:
        assert got["labels"].dtype == want["labels"].dtype == np.int32
        np.testing.assert_array_equal(got["labels"], want["labels"])
    if "windows_per_channel" in want:
        np.testing.assert_array_equal(
            got["windows_per_channel"], want["windows_per_channel"]
        )


@pytest.mark.parametrize(
    "max_batch,buckets",
    [(16, True), (1024, True), (1, True), (64, [3, 17]), (16, None)],
)
def test_bucket_ladder_matches_jax(max_batch, buckets):
    assert serve._bucket_ladder(max_batch, buckets) == jserve._bucket_ladder(
        max_batch, buckets
    )


@pytest.mark.parametrize("n", [0, 1, 19, 2 * MAX_BATCH + 5])
def test_dec_predictor_matches_jax(predictors, n):
    jp, tp, x = predictors
    batch = x[:n] if n <= len(x) else np.concatenate([x, x])[:n]
    got, want = tp(batch), jp(batch)
    assert got["q"].shape == (n, 3) and got["z"].shape == (n, 9)
    _assert_same(got, want)


def test_aec_encoder_matches_jax(trained):
    params, sd, x = trained
    aec = {"encoder": params["encoder"], "decoder": params["decoder"]}
    want = jserve.AECEncoder(aec, max_batch=MAX_BATCH)(x[:19])
    got = serve.AECEncoder(sd, max_batch=MAX_BATCH, device="cpu")(x[:19])
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("fuse", [None, False])
@pytest.mark.parametrize("shape", [(9_000,), (3, 5_000)])
def test_waveform_frontend_matches_jax(predictors, fuse, shape):
    """Fused and two-pass routes, one channel and three, over several
    chunks (chunk_samples = 4 windows) and a ragged last chunk."""
    jp, tp, _ = predictors
    wave = _waves(shape)
    jf = jserve.WaveformFrontend(jp, chunk_samples=1_600, fuse=fuse)
    tf = serve.WaveformFrontend(tp, chunk_samples=1_600, fuse=fuse)
    assert tf.fused == jf.fused == (fuse is None)
    _assert_same(tf(wave), jf(wave))
    np.testing.assert_allclose(tf.windows(wave), jf.windows(wave), atol=2e-4)


def test_frontend_through_microbatcher_takes_two_pass(predictors):
    _, tp, _ = predictors
    batcher = serve_http.MicroBatcher(tp, max_wait_ms=0)
    try:
        wf = serve.WaveformFrontend(batcher, device="cpu")
        assert not wf.fused
        with pytest.raises(ValueError, match="fuse=True"):
            serve.WaveformFrontend(batcher, device="cpu", fuse=True)
        wave = _waves((4_000,))
        _assert_same(wf(wave), serve.WaveformFrontend(tp)(wave))
    finally:
        batcher.close()


def test_frontend_refuses_what_jax_refuses(predictors):
    jp, tp, _ = predictors
    for kw in ({"nperseg": 128, "hop": 64}, {"nperseg": 250, "hop": 100}):
        with pytest.raises(ValueError):
            jserve.WaveformFrontend(jp, **kw)
        with pytest.raises(ValueError):
            serve.WaveformFrontend(tp, **kw)
    wf = serve.WaveformFrontend(tp)
    with pytest.raises(ValueError, match="no complete"):
        wf(np.zeros(499, np.float32))
    with pytest.raises(ValueError, match=r"\(T,\) or \(channels, T\)"):
        wf(np.zeros((2, 2, 600), np.float32))
    assert wf.n_windows(499) == 0 and wf.n_windows(500) == 1


def test_options_not_ported_raise(trained):
    _, sd, _ = trained
    # mesh= is ported (tests/test_torch_serve_mesh.py); arch='packed' is ported (tests/test_torch_arch_workflow.py); a parity
    # checkpoint served as packed is refused as by the JAX predictors
    with pytest.raises(ValueError, match="missing"):
        serve.DECPredictor(sd, 3, device="cpu", arch="packed")
    with pytest.raises(ValueError, match="missing"):
        serve.AECEncoder(sd, device="cpu", arch="packed")
    # the wire dtypes are ported (tests/test_torch_wire.py); an unknown
    # one is refused as by the JAX predictors
    with pytest.raises(ValueError, match="transfer_dtype"):
        serve.DECPredictor(sd, 3, device="cpu", transfer_dtype="int4")
    with pytest.raises(ValueError, match="unknown arch"):
        serve.DECPredictor(sd, 3, arch="UNet", device="cpu")
    with pytest.raises(ValueError, match="exceeds max_batch"):
        serve.DECPredictor(sd, 3, max_batch=16, buckets=[64], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.DECPredictor(sd, 3, device="cuda")


def test_from_checkpoint_reads_the_jax_export(tmp_path, predictors, trained):
    params, _, x = trained
    jp, _, _ = predictors
    path = tmp_path / "DEC_Params_Final.pt"
    torch.save({k: torch.from_numpy(v) for k, v in
                torch_port.torch_state_dict_from_params(params).items()}, path)
    tp = serve.DECPredictor.from_checkpoint(
        str(path), n_clusters=3, max_batch=MAX_BATCH, buckets=True,
        device="cpu",
    )
    tp.warmup()
    _assert_same(tp(x[:19]), jp(x[:19]))
    enc = serve.AECEncoder.from_checkpoint(str(path), device="cpu")
    np.testing.assert_allclose(enc(x[:19]), jp(x[:19])["z"], **TOL)


# -- HTTP --------------------------------------------------------------------


def _start(srv):
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, t


@pytest.fixture(scope="module")
def servers(predictors):
    """The JAX server and the port's, each with a fused waveform frontend
    and a 50 kB request cap (a larger refused body can overflow the
    socket buffers before the 413 is read)."""
    jp, tp, _ = predictors
    pairs = [
        _start(mod.make_server(p, max_wait_ms=1.0, max_request_mb=0.05,
                               waveform_frontend=mod_serve.WaveformFrontend(p)))
        for mod, mod_serve, p in ((jserve_http, jserve, jp),
                                  (serve_http, serve, tp))
    ]
    yield [srv for srv, _ in pairs]
    for srv, t in pairs:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)
        assert not t.is_alive()


def _request(srv, path, body=None):
    """(status, body bytes) for a GET (body None) or a POST."""
    host, port = srv.server_address[:2]
    req = urllib.request.Request(f"http://{host}:{port}{path}", data=body,
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _npy(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def test_http_healthz_matches_jax(servers):
    (jcode, jbody), (tcode, tbody) = (_request(s, "/healthz") for s in servers)
    assert jcode == tcode == 200
    assert json.loads(tbody) == json.loads(jbody)


@pytest.mark.parametrize(
    "path,payload",
    [
        ("/predict", ("windows", 19)),
        ("/predict?fields=labels,q", ("windows", 5)),
        ("/predict", ("windows3d", 4)),
        ("/predict_waveform", ("wave", (7_000,))),
        ("/predict_waveform", ("wave", (2, 3_000))),
    ],
)
def test_http_results_match_jax(servers, predictors, path, payload):
    _, _, x = predictors
    kind, size = payload
    arr = _waves(size) if kind == "wave" else x[:size]
    if kind == "windows3d":
        arr = arr[..., 0]
    (jcode, jbody), (tcode, tbody) = (
        _request(s, path, _npy(arr)) for s in servers
    )
    assert jcode == tcode == 200
    want, got = np.load(io.BytesIO(jbody)), np.load(io.BytesIO(tbody))
    _assert_same(dict(got), dict(want))


BAD_REQUESTS = {
    "post_unknown_path": ("/nope", _npy(np.zeros(3, np.float32))),
    "not_npy": ("/predict", b"not npy"),
    "wrong_geometry": ("/predict", _npy(np.zeros((2, 5, 101), np.float32))),
    "two_channels": ("/predict", _npy(np.zeros((2, 4, 101, 2), np.float32))),
    "strings": ("/predict", _npy(np.array(["a", "b"]))),
    "unknown_field": ("/predict?fields=nope",
                      _npy(np.zeros((2, 4, 101), np.float32))),
    "over_cap": ("/predict", _npy(np.zeros((40, 4, 101), np.float32))),
    "short_wave": ("/predict_waveform", _npy(np.zeros(499, np.float32))),
    "wave_3d": ("/predict_waveform", _npy(np.zeros((2, 2, 600), np.float32))),
    "complex_wave": ("/predict_waveform", _npy(np.zeros(600, np.complex64))),
    "get_unknown_path": (None, None),
}


@pytest.mark.parametrize("case", sorted(BAD_REQUESTS))
def test_http_errors_match_jax(servers, case):
    path, body = BAD_REQUESTS[case]
    if path is None:
        codes = [_request(s, "/nope")[0] for s in servers]
    else:
        codes = [_request(s, path, body)[0] for s in servers]
    assert codes[0] == codes[1] and codes[0] in (400, 404, 413)


def test_http_waveform_404_without_frontend(predictors):
    _, tp, _ = predictors
    srv, t = _start(serve_http.make_server(tp, max_wait_ms=1.0))
    try:
        code, body = _request(srv, "/predict_waveform",
                              _npy(np.zeros(600, np.float32)))
        assert code == 404 and b"scc-serve-torch --waveform" in body
        stats = json.loads(_request(srv, "/stats")[1])
        assert stats["requests"] == 0
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)


def test_main_requires_n_clusters_for_dec(tmp_path):
    with pytest.raises(SystemExit):
        serve_http.main([str(tmp_path / "x.pt"), "--model", "DEC"])


def test_package_imports_no_jax():
    """Every module of the port, the training slice's subpackages
    included, imports without jax, flax or optax."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import spectrogram_cube_clustering_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) >= 15, names\n"
        "for sub in ('train', 'cluster', 'data', 'workflow'):\n"
        "    assert pkg.__name__ + '.' + sub in names, sub\n"
        "bad = [m for m in ('jax', 'flax', 'optax', 'orbax', "
        "'spectrogram_cube_clustering_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_a_card(tmp_path, alone):
    """Without CUDA the smoke script exits non-zero and prints no result,
    from the checkout and from a directory holding only the script."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        script = str(tmp_path / "chip_smoke.py")
        with open(os.path.join(REPO, "chip_smoke.py")) as src:
            (tmp_path / "chip_smoke.py").write_text(src.read())
    proc = subprocess.run([sys.executable, script], cwd=os.path.dirname(script),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
