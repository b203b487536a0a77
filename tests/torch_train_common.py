"""Shared inputs and checks of the training-slice parity tests
(`test_torch_train.py`, `test_torch_dec.py`, `test_torch_slice.py`): a
synthetic waveform of five tone kinds, its windows, a JAX DEC's initial
params, and the comparison of a port state_dict with JAX params.
Tolerances, each stated at its test: float32 losses within 1e-6; Adam
steps within 1e-7; layouts and seeded splits exactly equal; training
histories within rtol 1e-4 and trained params within 1e-4 (float32 convs
summed in different orders, compounded over the steps); DEC deltas within
one label in M (one rounding flip of `target_distribution`, ROADMAP
Queue 3); labels equal where the top-two gap of q exceeds 1e-4. JAX dots
run at float32 precision.
"""

import concurrent.futures as cf
import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectrogram_cube_clustering_tpu import models as jmodels
from spectrogram_cube_clustering_tpu_torch import signal
from spectrogram_cube_clustering_tpu_torch.utils.weights import (
    state_dict_from_jax_params,
)

BATCH = 32
SLICE_BATCH = 4
AEC_LR = 1e-3  # examples/quickstart.py:63-64
HIST = dict(rtol=1e-4, atol=0)
PARAMS = dict(rtol=0, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while a module runs: these shapes gain nothing
    from more, and under the suite's parallel workers the extra threads
    contend for the cores (the split training files took 115 s instead of
    61 s on three workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def one_openmp_thread():
    """One OpenMP and BLAS thread while a module runs: sklearn's t-SNE
    and k-means otherwise start a thread per core in every parallel
    worker, and the oversubscribed cores made a driver chain with two
    sklearn t-SNEs take 299 s instead of 8."""
    from threadpoolctl import threadpool_limits

    with threadpool_limits(limits=1):
        yield


def _f32():
    return jax.default_matmul_precision("float32")


def _waveform(channels, samples, seed, gap=False):
    """Five kinds of 400-sample stretches, each a tone at its own frequency
    (equal amplitudes) over unit noise; returns the waveform and the kind
    of each window. A window starts every 400 samples and spans 500; with
    `gap` each tone stays silent in its stretch's first 100 samples, so
    no window reaches the next stretch's tone."""
    rng = np.random.default_rng(seed)
    kinds = rng.integers(0, 5, (channels, -(-samples // 400)))
    kind = np.repeat(kinds, 400, axis=1)[:, :samples]
    n = np.arange(samples)
    wave = 10.0 * np.sin(2 * np.pi * (0.03 + 0.09 * kind) * n)
    if gap:
        wave = wave * (n % 400 >= 100)
    wave = (wave + rng.normal(size=(channels, samples))).astype(np.float32)
    per_channel = ((samples - 200) // 100 + 1) // 4
    return wave, kinds[:, :per_channel].reshape(-1)


@pytest.fixture(scope="module")
def jax_dec(windows):
    """A JAX DEC(5) and its initial params (numpy)."""
    jm = jmodels.DEC(n_clusters=5)
    init = jax.jit(jm.init)(jax.random.key(2), jnp.asarray(windows[0][:1]))
    return jm, jax.device_get(init["params"])


@pytest.fixture(scope="module")
def windows():
    """198 normalized (4, 101) windows and their kinds."""
    wave, kinds = _waveform(2, 40_000, seed=0)
    x = signal.spectrogram_windows(torch.from_numpy(wave)).numpy()
    return x, kinds


def _sd(params):
    return state_dict_from_jax_params(jax.device_get(params))


def _assert_params_close(got: dict, want_params, **tol):
    want = _sd(want_params)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **tol,
                                   err_msg=k)


TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(module: str, world: int, out_dir: str, *args) -> list:
    """Start `world` processes, rank r running `module._rank_main(r, world,
    port, out_dir, *args)`, to join one gloo group on a free local port.
    `module` is a test file of this directory that imports no jax (each
    process imports torch and the port only), and each process
    runs torch on one thread."""
    code = (f"import sys; sys.path[:0] = [{TESTS!r}, {REPO!r}]; "
            f"import {module} as m; m._rank_main(int(sys.argv[1]), {world}, "
            f"{_free_port()}, {out_dir!r}, *{args!r})")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["OMP_NUM_THREADS"] = "1"
    return [subprocess.Popen([sys.executable, "-c", code, str(rank)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True, cwd=REPO, env=env)
            for rank in range(world)]


def wait_ranks(procs: list, timeout: float) -> None:
    """Wait for `start_ranks`' processes, draining their pipes on threads
    (a rank blocked on a full pipe would hold the others at their next
    collective). The first rank to fail, or `timeout` seconds, ends the
    wait and kills the rest, and fails the caller with the ranks'
    stderr; no process outlives this call."""
    deadline = time.monotonic() + timeout
    with cf.ThreadPoolExecutor(2 * len(procs)) as pool:
        for p in procs:
            pool.submit(p.stdout.read)
        errs = [pool.submit(p.stderr.read) for p in procs]
        try:
            while (any(p.poll() is None for p in procs)
                   and not any(p.returncode for p in procs)
                   and time.monotonic() < deadline):
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        errs = [f.result() for f in errs]
    for rank, (p, err) in enumerate(zip(procs, errs)):
        assert p.returncode == 0, (
            f"rank {rank} ended with {p.returncode}:\n{err[-4000:]}")
