"""Mesh serving of the port against the JAX package's, on the CPU (the
counterpart of tests/test_serve.py's `TestMeshServing` and
tests/test_serve_http.py's mesh predictor over HTTP): the predictors and
the waveform frontend on a `DataMesh`, the bucket ladders, the worker
loop, `scc-serve-torch --mesh`, the idle heartbeat and the shutdown.

The port runs as 2 and 4 gloo processes started once for the module
(`_rank_main`, `torch_train_common.start_ranks`): rank 0 makes the
calls, the other ranks run `serve.serve_worker`. The JAX side runs in the
test process on the 8 forced CPU devices (tests/conftest.py), from the
same weights (carried by `utils.weights.state_dict_from_jax_params`) and
the same numpy requests. Tolerances, JAX's own (tests/test_serve.py),
each stated at its test: window requests z rtol 1e-5 / atol 1e-7 and
labels equal wherever q's top-two gap exceeds 1e-4 (ROADMAP Queue 3's
rounding rule); the fused route q rtol 1e-4 / atol 1e-6, z rtol 1e-4 /
atol 1e-5, labels equal; the int8 wire's labels agree on >= 95% and its
q within atol 3e-2 of the float32 wire's.

The process group's timeout is shortened to `GROUP_TIMEOUT` seconds in
every rank, so an idle pause longer than it shows the heartbeat at work.

This file imports no jax at its top: the rank processes import it for
`_rank_main`, and a jax import would add seconds to each.
"""

import io
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

from spectrogram_cube_clustering_tpu_torch import core, serve
from spectrogram_cube_clustering_tpu_torch.core.mesh import DataMesh

WORLDS = (2, 4)
RANK_TIMEOUT = 240  # seconds for the rank processes
GROUP_TIMEOUT = 2.0  # seconds: each rank's shortened collective timeout
IDLE_PAUSE = 2.5 * GROUP_TIMEOUT  # rank 0's wait before the encoder's call
MAX_BATCH = 128  # tests/test_serve.py's mesh predictor
WINDOW_REQUESTS = (64, 8, 5, 1, 0)
WAVE_SHAPE = (2, 2_345)  # tests/test_serve.py::test_mesh_fused_matches_two_pass
TOL_Z = dict(rtol=1e-5, atol=1e-7)
TOL_FUSED_Q = dict(rtol=1e-4, atol=1e-6)
TOL_FUSED_Z = dict(rtol=1e-4, atol=1e-5)
LABEL_GAP = 1e-4


def _rank_main(rank: int, world: int, port: int, out_dir: str) -> None:
    """One rank of a `world`-rank mesh: three serving sessions (a DEC with
    a fused frontend, an AEC encoder whose first request comes after an
    idle pause, a DEC over the int8 wire with a fused frontend), each
    ended by rank 0's `close`. Rank 0 saves its
    answers as `world<world>.pt`; every rank writes `done<world>_<rank>`
    after its last session (a worker's holding the refusal of a call
    made on it)."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    core.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                device="cpu", timeout=GROUP_TIMEOUT)
    mesh = core.make_data_mesh()
    sds = torch.load(os.path.join(out_dir, "sds.pt"))
    x = np.load(os.path.join(out_dir, "x.npy"))
    wave = np.load(os.path.join(out_dir, "wave.npy"))
    out, refused = {}, ""

    pred = serve.DECPredictor(sds["dec"], 3, max_batch=MAX_BATCH, mesh=mesh)
    fused = serve.WaveformFrontend(pred, chunk_samples=1, fuse=True)
    if rank == 0:
        pred.warmup()
        out["sizes"] = pred.sizes
        out["windows"] = {n: pred(x[:n]) for n in WINDOW_REQUESTS}
        out["fused"] = fused(wave)
        two_pass = serve.WaveformFrontend(pred, chunk_samples=1)
        out["two_pass_fused"] = two_pass.fused
        out["two_pass"] = two_pass(wave)
        pred.close()
        out["closed"] = _refusal(lambda: pred(x[:3]))
    else:
        refused = _refusal(lambda: pred(x[:3]))
        serve.serve_worker(pred, fused)

    enc = serve.AECEncoder(sds["aec"], max_batch=64, mesh=mesh)
    if rank == 0:
        # the library's usage with no warm-up: the first request comes
        # after an idle pause past the group's timeout
        t0 = time.monotonic()
        time.sleep(IDLE_PAUSE)
        out["aec_idle_s"] = time.monotonic() - t0
        out["aec"] = enc(x[:10])
        out["aec_empty"] = enc(np.zeros((0, 4, 101, 1), np.float32))
        enc.close()
    else:
        serve.serve_worker(enc)

    i8 = serve.DECPredictor(sds["dec"], 3, max_batch=16, mesh=mesh,
                            transfer_dtype="int8")
    fused_i8 = serve.WaveformFrontend(i8, chunk_samples=1, fuse=True)
    if rank == 0:
        out["fused_i8"] = fused_i8(wave)
        i8.close()
        torch.save(out, os.path.join(out_dir, f"world{world}.pt"))
    else:
        serve.serve_worker(i8, fused_i8)
    with open(os.path.join(out_dir, f"done{world}_{rank}"), "w") as f:
        f.write(refused)
    dist.destroy_process_group()


def _refusal(fn) -> str:
    try:
        fn()
    except RuntimeError as e:
        return str(e)
    return ""


def _trained():
    """JAX DEC params whose centroids sit near real latents (so q is far
    from uniform), as in tests/test_torch_serve.py, and raw windows."""
    import jax
    import jax.numpy as jnp

    import spectrogram_cube_clustering_tpu as scc

    x, _ = scc.data.synthetic_windows(64, n_classes=3, seed=1)
    xn = scc.ops.sample_norm_cent(jnp.asarray(x))
    model = scc.models.DEC(n_clusters=3)
    params = model.init(jax.random.key(0), xn[:2])["params"]
    z = model.apply({"params": params}, xn, method="encode")
    params = scc.models.replace_centroids(params, np.asarray(z)[[0, 21, 42]])
    return jax.device_get(params), np.asarray(x)


def _jax_side(params, x, wave) -> dict:
    """JAX's mesh predictors and fused frontend on the 8-device mesh
    (tests/test_serve.py's `TestMeshServing`), from the same params."""
    from spectrogram_cube_clustering_tpu import core as jcore
    from spectrogram_cube_clustering_tpu import serve as jserve

    mesh = jcore.make_data_mesh()
    assert mesh.size == 8
    pred = jserve.DECPredictor(params, 3, max_batch=MAX_BATCH, mesh=mesh)
    aec = {"encoder": params["encoder"], "decoder": params["decoder"]}
    enc = jserve.AECEncoder(aec, max_batch=64, mesh=mesh)
    small = jserve.DECPredictor(params, 3, max_batch=16, mesh=mesh)
    i8 = jserve.DECPredictor(params, 3, max_batch=16, mesh=mesh,
                             transfer_dtype="int8")
    return {
        "windows": {n: pred(x[:n]) for n in WINDOW_REQUESTS},
        "aec": enc(x[:10]),
        "fused": jserve.WaveformFrontend(small, chunk_samples=1,
                                         fuse=True)(wave),
        "fused_i8": jserve.WaveformFrontend(i8, chunk_samples=1,
                                            fuse=True)(wave),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank 0's answers per world, JAX's answers, the port's single
    process (predictor, frontend), the windows, the waveform, the out
    directory)."""
    import jax

    from spectrogram_cube_clustering_tpu_torch.utils.weights import (
        state_dict_from_jax_params,
    )
    from torch_train_common import start_ranks, wait_ranks

    out_dir = str(tmp_path_factory.mktemp("serve_mesh"))
    params, x = _trained()
    wave = np.random.default_rng(6).normal(size=WAVE_SHAPE).astype(
        np.float32)
    sd = state_dict_from_jax_params(params)
    aec_sd = {k: v for k, v in sd.items() if k != "clustering.weights"}
    torch.save({"dec": sd, "aec": aec_sd}, os.path.join(out_dir, "sds.pt"))
    np.save(os.path.join(out_dir, "x.npy"), x)
    np.save(os.path.join(out_dir, "wave.npy"), wave)
    procs = {w: start_ranks("test_torch_serve_mesh", w, out_dir)
             for w in WORLDS}
    try:
        with jax.default_matmul_precision("float32"):
            ref = _jax_side(params, x, wave)
        single = serve.DECPredictor(sd, 3, max_batch=MAX_BATCH, device="cpu")
    finally:
        for w in WORLDS:
            wait_ranks(procs[w], RANK_TIMEOUT)
    got = {w: torch.load(os.path.join(out_dir, f"world{w}.pt"),
                         weights_only=False) for w in WORLDS}
    return got, ref, single, x, wave, out_dir


def _top_two_gap(q: np.ndarray) -> np.ndarray:
    s = np.sort(q, axis=1)
    return s[:, -1] - s[:, -2]


def _labels_equal_where_clear(got: dict, want: dict) -> None:
    clear = _top_two_gap(want["q"]) > LABEL_GAP
    np.testing.assert_array_equal(got["labels"][clear],
                                  want["labels"][clear])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("n", WINDOW_REQUESTS)
def test_window_requests_match_jax_mesh(runs, world, n):
    """64, 8, 5, 1 and 0 windows (sizes that pad across the mesh) through
    the port's mesh predictor against JAX's on 8 devices: z rtol 1e-5 /
    atol 1e-7, labels equal where q's top-two gap exceeds 1e-4, the
    shapes and dtypes JAX's."""
    got, ref, _, _, _, _ = runs
    a, b = got[world]["windows"][n], ref["windows"][n]
    assert a["q"].shape == (n, 3) and a["z"].shape == (n, 9)
    assert a["labels"].dtype == np.int32 and a["q"].dtype == np.float32
    np.testing.assert_allclose(a["z"], np.asarray(b["z"]), **TOL_Z)
    _labels_equal_where_clear(a, {k: np.asarray(v) for k, v in b.items()})


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_predictor_matches_single_process(runs, world):
    """The mesh's answers against the port's one process, the JAX test's
    mesh-vs-single-device check: z rtol 1e-5 / atol 1e-7, labels equal
    where clear; and every bucket divides over the ranks."""
    got, _, single, x, _, _ = runs
    for n in WINDOW_REQUESTS:
        a, b = got[world]["windows"][n], single(x[:n])
        np.testing.assert_allclose(a["z"], b["z"], **TOL_Z)
        np.testing.assert_allclose(a["q"], b["q"], **TOL_Z)
        _labels_equal_where_clear(a, b)
    assert got[world]["sizes"] == (MAX_BATCH,)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_encoder_and_empty_request(runs, world):
    """The AEC encoder on the mesh against JAX's mesh encoder (z rtol
    1e-5 / atol 1e-7), and an empty request's (0, 9) answer."""
    got, ref, _, _, _, _ = runs
    np.testing.assert_allclose(got[world]["aec"], np.asarray(ref["aec"]),
                               **TOL_Z)
    assert got[world]["aec_empty"].shape == (0, 9)


@pytest.mark.parametrize("world", WORLDS)
def test_idle_before_first_request(runs, world):
    """A predictor built and left idle past the group's timeout, with no
    warm-up, still answers its first request (the heartbeat starts with
    rank 0's channel, not at its first call): the encoder's answer after
    the pause equals the port's one process (z rtol 1e-5 / atol 1e-7)."""
    got, _, single, x, _, _ = runs
    assert got[world]["aec_idle_s"] >= IDLE_PAUSE > GROUP_TIMEOUT
    enc = serve.AECEncoder(single.model.state_dict(), max_batch=64,
                           device="cpu")
    np.testing.assert_allclose(got[world]["aec"], enc(x[:10]), **TOL_Z)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_fused_matches_jax_and_two_pass(runs, world):
    """The mesh-fused route (K1's plain version on each rank's time shard
    plus the halo, the model on the rank's windows) on JAX's (2, 2345)
    wave with chunk_samples=1, against JAX's fused mesh frontend and the
    port's own two-pass route: labels equal, q rtol 1e-4 / atol 1e-6, z
    rtol 1e-4 / atol 1e-5, windows_per_channel equal. A mesh predictor
    without fuse=True takes the two-pass route."""
    got, ref, _, _, _, _ = runs
    g = got[world]
    assert not g["two_pass_fused"]
    for other in (ref["fused"], g["two_pass"]):
        other = {k: np.asarray(v) for k, v in other.items()}
        np.testing.assert_array_equal(g["fused"]["labels"], other["labels"])
        np.testing.assert_allclose(g["fused"]["q"], other["q"], **TOL_FUSED_Q)
        np.testing.assert_allclose(g["fused"]["z"], other["z"], **TOL_FUSED_Z)
        np.testing.assert_array_equal(g["fused"]["windows_per_channel"],
                                      other["windows_per_channel"])
    assert g["fused"]["windows_per_channel"].tolist() == [5, 5]


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_fused_int8_wire(runs, world):
    """int8 on the mesh-fused wire (restored before the padding): labels
    agree with the float32 wire on >= 95% and q within atol 3e-2
    (JAX's bounds), and with JAX's int8 mesh-fused answer as closely,
    since both encode each channel's 500-sample segment with one
    scale."""
    got, ref, _, _, _, _ = runs
    i8 = got[world]["fused_i8"]
    for want in (got[world]["fused"], ref["fused_i8"]):
        assert (i8["labels"] == np.asarray(want["labels"])).mean() >= 0.95
        np.testing.assert_allclose(i8["q"], np.asarray(want["q"]), atol=3e-2)
    np.testing.assert_array_equal(i8["windows_per_channel"],
                                  got[world]["fused"]["windows_per_channel"])


@pytest.mark.parametrize("world", WORLDS)
def test_worker_loop_and_close(runs, world):
    """Every rank left its worker loop at rank 0's close (the rank
    processes all exited 0, checked by the fixture); a call on a worker
    rank and a call after close raise."""
    got, _, _, _, _, out_dir = runs
    for rank in range(world):
        with open(os.path.join(out_dir, f"done{world}_{rank}")) as f:
            refused = f.read()
        assert ("worker loop" in refused) == (rank > 0), refused
    assert "closed" in got[world]["closed"]


@pytest.mark.parametrize("max_batch,buckets,want", [
    (64, True, (8, 16, 32, 64)),
    (64, [3, 20], (8, 24, 64)),
    (64, None, (64,)),
])
def test_mesh_bucket_ladder_matches_jax(max_batch, buckets, want):
    """JAX's ladders for 8 devices, as the function and as a mesh
    predictor's sizes (a `DataMesh` of 8 ranks with no process group
    behind it, whose channel starts no heartbeat)."""
    from spectrogram_cube_clustering_tpu import serve as jserve

    assert serve._bucket_ladder(max_batch, buckets, multiple=8) == want
    assert jserve._bucket_ladder(max_batch, buckets, multiple=8) == want
    mesh = DataMesh(rank=0, world=8, device=torch.device("cpu"))
    sd = _dec_sd()
    assert serve.DECPredictor(sd, 3, max_batch=max_batch, buckets=buckets,
                              mesh=mesh).sizes == want


def test_mesh_refuses_what_jax_refuses():
    """max_batch that does not divide over the mesh raises JAX's "multiple
    of the mesh" ValueError, in the ladder and in both predictors; a
    device other than the mesh's raises; serve_worker refuses rank 0 and
    a predictor without a mesh."""
    from spectrogram_cube_clustering_tpu import serve as jserve

    mesh = DataMesh(rank=0, world=8, device=torch.device("cpu"))
    sd = _dec_sd()
    for fn in (lambda: jserve._bucket_ladder(12, None, multiple=8),
               lambda: serve._bucket_ladder(12, None, multiple=8),
               lambda: serve.DECPredictor(sd, 3, max_batch=12, mesh=mesh),
               lambda: serve.AECEncoder(sd, max_batch=12, mesh=mesh)):
        with pytest.raises(ValueError, match="multiple of the mesh"):
            fn()
    with pytest.raises(ValueError, match="mesh's device"):
        serve.DECPredictor(sd, 3, max_batch=16, mesh=mesh, device="meta")
    with pytest.raises(ValueError, match="ranks >= 1"):
        serve.serve_worker(serve.DECPredictor(sd, 3, max_batch=16,
                                              mesh=mesh))
    with pytest.raises(ValueError, match="ranks >= 1"):
        serve.serve_worker(serve.DECPredictor(sd, 3, device="cpu"))


def test_header_round_trip():
    """A header survives its fixed-size tensor, and one with too many
    dims is refused."""
    from spectrogram_cube_clustering_tpu_torch.core.mesh import (
        HEADER_DIMS,
        Header,
    )

    h = Header(3, 1, 2, (16, 1_048_800))
    t = h.tensor("cpu")
    assert t.shape == (4 + HEADER_DIMS,) and t.dtype == torch.int64
    assert Header.from_tensor(t) == h
    with pytest.raises(ValueError, match="at most"):
        Header(2, shape=(1,) * (HEADER_DIMS + 1)).tensor("cpu")


def _dec_sd() -> dict:
    from spectrogram_cube_clustering_tpu_torch import models

    return models.DEC(n_clusters=3, generator=torch.Generator().manual_seed(0),
                      device="cpu").state_dict()


# -- scc-serve-torch --mesh ---------------------------------------------------


def _start_server(out_dir: str, tag: str, world: int, extra: list) -> list:
    """`world` processes of `serve_http.main([ckpt, "--mesh", ...])`, each
    joined first to a gloo group with the shortened timeout (main's own
    `initialize_distributed` then finds it), one torch thread each."""
    from torch_train_common import REPO, TESTS, _free_port

    port = _free_port()
    argv = [os.path.join(out_dir, "dec.pt"), "--mesh", "--device", "cpu",
            "--n-clusters", "3", "--max-batch", "15", "--host", "127.0.0.1",
            "--port", "0", "--waveform", *extra]
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["OMP_NUM_THREADS"] = "1"
    procs = []
    for rank in range(world):
        code = (f"import sys; sys.path[:0] = [{TESTS!r}, {REPO!r}]; "
                "import torch; torch.set_num_threads(1); "
                "from spectrogram_cube_clustering_tpu_torch import core, "
                "serve_http; "
                f"core.initialize_distributed('127.0.0.1:{port}', {world}, "
                f"{rank}, device='cpu', timeout={GROUP_TIMEOUT}); "
                f"sys.exit(serve_http.main({argv!r}))")
        log = open(os.path.join(out_dir, f"{tag}{rank}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, "-u", "-c", code], stdout=log,
            stderr=subprocess.STDOUT, cwd=REPO, env=env))
        log.close()
    return procs


def _url(out_dir: str, tag: str, procs: list, timeout: float = 120) -> str:
    """The address rank 0 prints once it serves; fails if a rank ends
    first or the time runs out."""
    import re

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with open(os.path.join(out_dir, f"{tag}0.log")) as f:
            m = re.search(r"on (http://[\d.]+:\d+)", f.read())
        if m:
            return m.group(1)
        if any(p.poll() is not None for p in procs):
            break
        time.sleep(0.1)
    _kill(procs)
    pytest.fail(f"the mesh server did not start: {_logs(out_dir, tag, procs)}")


def _kill(procs: list) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _logs(out_dir: str, tag: str, procs: list) -> str:
    text = []
    for rank in range(len(procs)):
        with open(os.path.join(out_dir, f"{tag}{rank}.log")) as f:
            text.append(f"rank {rank} ({procs[rank].poll()}):\n"
                        f"{f.read()[-3000:]}")
    return "\n".join(text)


def _wait(procs: list, timeout: float) -> list:
    """Each process's exit code, killing any still running after
    `timeout` seconds (its code then None)."""
    deadline = time.monotonic() + timeout
    while (any(p.poll() is None for p in procs)
           and time.monotonic() < deadline):
        time.sleep(0.05)
    codes = [p.poll() for p in procs]
    _kill(procs)
    return codes


def _post(url: str, path: str, arr) -> dict:
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(url + path, data=buf.getvalue(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return dict(np.load(io.BytesIO(resp.read())))


def _assert_answer(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in ("q", "z"):
        np.testing.assert_allclose(got[k], want[k], **TOL_FUSED_Q, err_msg=k)
    _labels_equal_where_clear(got, want)
    if "windows_per_channel" in want:
        np.testing.assert_array_equal(got["windows_per_channel"],
                                      want["windows_per_channel"])


@pytest.fixture(scope="module")
def http_ckpt(tmp_path_factory):
    """A DEC checkpoint, the port's single-process predictor of it, and
    the windows and waveform the HTTP tests send."""
    out_dir = str(tmp_path_factory.mktemp("serve_mesh_http"))
    params, x = _trained()
    from spectrogram_cube_clustering_tpu_torch.utils.weights import (
        state_dict_from_jax_params,
    )

    sd = state_dict_from_jax_params(params)
    torch.save(sd, os.path.join(out_dir, "dec.pt"))
    single = serve.DECPredictor(sd, 3, max_batch=16, buckets=True,
                                device="cpu")
    wave = np.random.default_rng(3).normal(size=(2, 3_000)).astype(
        np.float32)
    return out_dir, single, x, wave


def test_http_mesh_fused_idle_and_shutdown(http_ckpt):
    """`scc-serve-torch --mesh --fuse-waveform` on 2 gloo ranks: /healthz
    gives the mesh size and the rounded max_batch, /predict and
    /predict_waveform answer as the port's single process (q, z rtol
    1e-4 / atol 1e-6, labels equal where clear); after an idle pause of
    2.5x the group's timeout it still answers; SIGINT to rank 0 ends
    every rank with 0."""
    out_dir, single, x, wave = http_ckpt
    procs = _start_server(out_dir, "fused", 2, ["--fuse-waveform"])
    try:
        url = _url(out_dir, "fused", procs)
        with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
            meta = json.loads(resp.read())
        assert meta["mesh"] == 2 and meta["max_batch"] == 16
        assert meta["waveform"]["fused"] is True
        _assert_answer(_post(url, "/predict", x[:19]), single(x[:19]))
        want = serve.WaveformFrontend(single)(wave)
        _assert_answer(_post(url, "/predict_waveform", wave), want)
        time.sleep(2.5 * GROUP_TIMEOUT)
        _assert_answer(_post(url, "/predict_waveform", wave), want)
        procs[0].send_signal(signal.SIGINT)
        codes = _wait(procs, 60)
    finally:
        _kill(procs)
    assert codes == [0, 0], _logs(out_dir, "fused", procs)
    with open(os.path.join(out_dir, "fused0.log")) as f:
        assert "rounded up to 16 (2 mesh devices)" in f.read()


def test_http_mesh_two_pass_and_a_failed_rank(http_ckpt):
    """`scc-serve-torch --mesh --waveform` takes the two-pass route and
    prints JAX's note; its /predict_waveform answers as the single
    process; then rank 1 is killed, and rank 0 stops and exits non-zero
    (its heartbeat finds the rank gone) instead of serving on."""
    out_dir, single, _, wave = http_ckpt
    procs = _start_server(out_dir, "two", 2, [])
    try:
        url = _url(out_dir, "two", procs)
        with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
            assert json.loads(resp.read())["waveform"]["fused"] is False
        _assert_answer(_post(url, "/predict_waveform", wave),
                       serve.WaveformFrontend(single)(wave))
        procs[1].kill()
        procs[1].wait()
        codes = _wait(procs[:1], 30)
    finally:
        _kill(procs)
    log = _logs(out_dir, "two", procs)
    assert codes[0] not in (0, None), log
    assert "two-pass route by default" in log
    assert "serving mesh failed" in log
